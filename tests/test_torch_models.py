"""The six example applications of ``windflow_tpu_torch/models`` against
their JAX twins in ``windflow_tpu/models``, on the inputs of
tests/test_models.py, through each app's own ``build()``/``run()`` (the
port on ``Config(device="cpu")``), plus each JAX test's own oracle.

Tolerances: exact wherever the data is integer-valued (wordcount's
counts, ad_analytics' counts, telemetry_frames' integer readings, and
ffat_analytics / market_ticker on integer-valued values); the host
windows of spike_detection are the same Python float arithmetic in both
packages, so exact too.  On random floats ffat_analytics compares at
rtol 1e-5: XLA on the CPU contracts the transform's ``v * 1.5 + 1.0``
into one fused multiply-add where torch rounds twice (ROADMAP's parity
notes), and market_ticker's max/min of random floats equal the JAX
package's rounded to float32, exactly (the port folds float32 prices,
the fold kernel's type; the JAX package float64 ones).
"""

import random

import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.models import (ad_analytics as j_ad,
                                 ffat_analytics as j_ffat,
                                 market_ticker as j_ticker,
                                 spike_detection as j_spike,
                                 telemetry_frames as j_tele,
                                 wordcount as j_wc)
from windflow_tpu_torch.models import (ad_analytics as t_ad,
                                       ffat_analytics as t_ffat,
                                       market_ticker as t_ticker,
                                       spike_detection as t_spike,
                                       telemetry_frames as t_tele,
                                       wordcount as t_wc)

torch.set_num_threads(1)

TEXT = """the quick brown fox jumps over the lazy dog
the dog barks and the fox runs
pack my box with five dozen liquor jugs
the five boxing wizards jump quickly""".splitlines()


def cpu():
    return wt.Config(device="cpu")


def test_every_app_but_mesh_is_ported():
    import windflow_tpu.models as jm
    import windflow_tpu_torch.models as tm
    jax_apps = {n for n in dir(jm) if not n.startswith("_")
                and hasattr(getattr(jm, n), "build")}
    port_apps = {n for n in dir(tm) if not n.startswith("_")
                 and hasattr(getattr(tm, n), "build")}
    # mesh_analytics came with the multi-GPU slice: every app is ported
    assert port_apps == jax_apps


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default config runs there")
    with pytest.raises(wt.WindFlowError, match="CUDA"):
        t_wc.run(TEXT)


# ---------------------------------------------------------------------------
# wordcount (tests/test_models.py:19)
# ---------------------------------------------------------------------------

def test_wordcount_matches_jax_and_oracle():
    got = t_wc.run(TEXT * 10, counter_parallelism=3, config=cpu())
    oracle = {}
    for line in TEXT * 10:
        for w in line.split():
            oracle[w.lower()] = oracle.get(w.lower(), 0) + 1
    assert got == oracle
    assert got == j_wc.run(TEXT * 10, counter_parallelism=3)


@pytest.mark.parametrize("par", [(1, 1, 2), (2, 2, 1), (1, 3, 4)])
def test_wordcount_metamorphic(par):
    """Under any parallelism the counts equal the JAX package's; each
    source replica replays the lines, so two replicas count twice."""
    kw = dict(source_parallelism=par[0], splitter_parallelism=par[1],
              counter_parallelism=par[2], batch=3)
    got = t_wc.run(TEXT * 5, config=cpu(), **kw)
    assert got == j_wc.run(TEXT * 5, **kw)
    once = j_wc.run(TEXT * 5)
    assert got == {w: n * par[0] for w, n in once.items()}


def test_wordcount_updates_in_the_same_order():
    """One counter replica: the stream of (word, count) updates is the
    JAX package's, update for update."""
    a, b = [], []
    j_wc.build(TEXT * 3, on_count=lambda w, n: a.append((w, n)),
               counter_parallelism=1).run()
    t_wc.build(TEXT * 3, on_count=lambda w, n: b.append((w, n)),
               counter_parallelism=1, config=cpu()).run()
    assert a == b and len(a) == sum(len(s.split()) for s in TEXT * 3)


# ---------------------------------------------------------------------------
# spike_detection (tests/test_models.py:50)
# ---------------------------------------------------------------------------

def make_readings(mod, n, devices=4, spike_every=50):
    rnd = random.Random(9)
    out = []
    for i in range(n):
        base = 10.0 + rnd.random()
        if (i // devices) % spike_every == spike_every - 1:
            base *= 3.0
        out.append(mod.Reading(device=i % devices, value=base))
    return out


def _spikes(spikes):
    return sorted((s.device, s.window_id, s.average) for s in spikes)


@pytest.mark.parametrize("win_par", [1, 2, 3])
def test_spike_detection_matches_jax(win_par):
    jr = make_readings(j_spike, 800)
    tr = make_readings(t_spike, 800)
    want = j_spike.run(jr, win_len=16, slide=1, threshold=1.5,
                       window_parallelism=win_par)
    got = t_spike.run(tr, win_len=16, slide=1, threshold=1.5,
                      window_parallelism=win_par, config=cpu())
    assert _spikes(got) == _spikes(want)
    # the JAX test's own oracle
    assert got and all(s.average < 25.0 for s in got)
    assert {s.device for s in got} == {0, 1, 2, 3}


def test_spike_detection_pure_python_oracle():
    """Every (device, wid) the detector flags, from a loop over the
    readings: windows of 16 readings sliding by 1, EOS partials
    included, flagged when the last reading exceeds 1.5 × the mean."""
    tr = make_readings(t_spike, 400)
    per_dev = {}
    for r in tr:
        per_dev.setdefault(r.device, []).append(r.value)
    exp = []
    for d, vals in per_dev.items():
        for w in range(len(vals)):
            seg = vals[w:w + 16]
            s = 0.0
            for v in seg:
                s += v
            if abs(seg[-1]) > 1.5 * abs(s / len(seg)):
                exp.append((d, w, s / len(seg)))
    got = t_spike.run(tr, win_len=16, slide=1, threshold=1.5,
                      config=cpu())
    assert _spikes(got) == sorted(exp)


# ---------------------------------------------------------------------------
# ffat_analytics (tests/test_models.py:63)
# ---------------------------------------------------------------------------

def _ffat_records(integer):
    n, keys = 6000, 8
    rnd = random.Random(11)
    if integer:
        return [{"k": i % keys, "v": float(rnd.randint(-50, 50))}
                for i in range(n)]
    return [{"k": i % keys, "v": rnd.random()} for i in range(n)]


@pytest.mark.parametrize("integer", [True, False])
def test_ffat_analytics_matches_jax(integer):
    records = _ffat_records(integer)
    kw = dict(win_len=64, slide=16, max_keys=8, batch=512)
    want = {(r["key"], r["wid"]): r["value"]
            for r in j_ffat.run(records, **kw)}
    got_rows = t_ffat.run(records, config=cpu(), **kw)
    got = {(r["key"], r["wid"]): r["value"] for r in got_rows}
    assert len(got) == len(got_rows) and set(got) == set(want)
    if integer:
        assert got == want
    else:
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-5), k
    # the JAX test's oracle over the full windows
    per_key = {k: [] for k in range(8)}
    for r in records:
        if (r["k"] & 7) != 7:
            per_key[r["k"]].append(r["v"] * 1.5 + 1.0)
    for k, vals in per_key.items():
        w = 0
        while w * 16 + 64 <= len(vals):
            exp = sum(vals[w * 16: w * 16 + 64])
            assert abs(got[(k, w)] - exp) < 1e-3 * max(1, abs(exp))
            w += 1


# ---------------------------------------------------------------------------
# telemetry_frames (tests/test_models.py:89)
# ---------------------------------------------------------------------------

def test_telemetry_frames_matches_jax():
    n, n_keys = 2000, 4
    rec = np.empty(n, dtype=[("k", "<i8"), ("t", "<i8"), ("v", "<f8")])
    rec["k"] = np.arange(n) % n_keys
    rec["t"] = np.arange(n) * 10_000
    rec["v"] = np.arange(n, dtype=np.float64)
    blob = rec.tobytes()

    def chunks():
        return iter([blob[i:i + 7777] for i in range(0, len(blob), 7777)])

    def collect(pkg_build, **extra):
        got = {}

        def on_windows(cols):
            for k, w, v in zip(cols.cols["key"], cols.cols["wid"],
                               cols.cols["value"]):
                assert (int(k), int(w)) not in got
                got[(int(k), int(w))] = float(v)
        pkg_build(chunks, on_windows, win_usec=1_000_000,
                  slide_usec=250_000, max_keys=n_keys, batch=256,
                  lateness_usec=0, **extra).run()
        return got

    want = collect(j_tele.build)
    got = collect(t_tele.build, config=cpu())
    assert got == want
    # the JAX test's oracle
    from conftest import tb_window_sums
    pts = {}
    for i in range(n):
        pts.setdefault(i % n_keys, []).append((i * 10_000, float(i)))
    assert got == tb_window_sums(pts, 1_000_000, 250_000)


# ---------------------------------------------------------------------------
# ad_analytics (tests/test_models.py:135)
# ---------------------------------------------------------------------------

def test_ad_analytics_matches_jax():
    rnd = random.Random(17)
    n_ads, n_campaigns, n = 40, 10, 5000
    ad_to_campaign = [rnd.randrange(n_campaigns) for _ in range(n_ads)]
    events = [{"ad_id": rnd.randrange(n_ads), "etype": rnd.randrange(3),
               "ts": i * 2_500} for i in range(n)]
    kw = dict(win_usec=1_000_000, slide_usec=1_000_000, batch=256,
              view_type=1)
    got = t_ad.run(events, ad_to_campaign, config=cpu(), **kw)
    assert got == j_ad.run(events, ad_to_campaign, **kw)
    exp = {}
    for e in events:
        if e["etype"] == 1:
            key = (ad_to_campaign[e["ad_id"]], e["ts"] // 1_000_000)
            exp[key] = exp.get(key, 0) + 1
    assert got == exp


# ---------------------------------------------------------------------------
# market_ticker (tests/test_models.py:189)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("integer", [True, False])
def test_market_ticker_matches_jax(integer):
    n, syms, win, slide = 5000, 6, 32, 8
    rnd = random.Random(21)
    if integer:
        ticks = [{"sym": i % syms, "price": float(rnd.randint(10, 100))}
                 for i in range(n)]
    else:
        ticks = [{"sym": i % syms, "price": 10.0 + rnd.random() * 90.0}
                 for i in range(n)]
    kw = dict(win_len=win, slide=slide, max_symbols=syms, batch=512)
    want = j_ticker.run(ticks, **kw)
    got = t_ticker.run(ticks, config=cpu(), **kw)
    key = lambda r: (r["sym"], r["wid"])    # noqa: E731

    def f32(x):
        return float(np.float32(x))
    # the port folds float32 prices, the JAX package float64 ones: max and
    # min commute with the monotonic rounding, so the port's high and low
    # are the JAX package's rounded to float32, exactly
    assert sorted(got, key=key) == sorted(
        ({**r, "high": f32(r["high"]), "low": f32(r["low"])} for r in want),
        key=key)
    if integer:
        assert sorted(got, key=key) == sorted(want, key=key)
    # the JAX test's oracle over the full windows, exact in float32
    per_sym = {s: [] for s in range(syms)}
    for t in ticks:
        per_sym[t["sym"]].append(t["price"])
    rows = {key(r): (r["high"], r["low"]) for r in got}
    for s, ps in per_sym.items():
        w = 0
        while w * slide + win <= len(ps):
            seg = ps[w * slide: w * slide + win]
            assert rows[(s, w)] == (f32(max(seg)), f32(min(seg))), (s, w)
            w += 1


@pytest.mark.parametrize("app", ["ffat_analytics", "market_ticker",
                                 "ad_analytics", "telemetry_frames"])
def test_device_apps_declare_their_records(app):
    """Each device app's source declares its fixed record layout, so with
    wire compression on (the card's default) preflight finds nothing: no
    WF606 raw downgrade, and the device functions evaluate on the
    declared records."""
    cfg = wt.Config(device="cpu", wire_compression="1")
    g = {"ffat_analytics": lambda: t_ffat.build([], config=cfg),
         "market_ticker": lambda: t_ticker.build([], config=cfg),
         "ad_analytics": lambda: t_ad.build([], [0, 1, 2], config=cfg),
         "telemetry_frames": lambda: t_tele.build(lambda: iter([]),
                                                  config=cfg)}[app]()
    assert [str(d) for d in g.check()] == []


def test_the_apps_import_neither_jax_nor_the_jax_package():
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, windflow_tpu_torch.models, "
            "windflow_tpu_torch.persistent, windflow_tpu_torch.windows\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'windflow_tpu' or "
            "m.startswith('windflow_tpu.')]\n"
            "assert not bad, bad\nprint('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


@pytest.mark.parametrize("batch", [1, 7, 64])
def test_wordcount_updates_in_the_same_order_batched(batch):
    """``batch`` batches the source and the splitter, as in the JAX app:
    with one counter replica the stream of (word, count) updates is the
    JAX package's, update for update, at any output batch size."""
    a, b = [], []
    j_wc.build(TEXT * 3, on_count=lambda w, n: a.append((w, n)),
               counter_parallelism=1, batch=batch).run()
    t_wc.build(TEXT * 3, on_count=lambda w, n: b.append((w, n)),
               counter_parallelism=1, batch=batch, config=cpu()).run()
    assert a == b and len(a) == sum(len(s.split()) for s in TEXT * 3)
