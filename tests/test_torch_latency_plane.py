"""The port's latency plane (``windflow_tpu_torch/monitoring/
latency_ledger.py``, ``analysis/latency.py``) against the JAX package's
(``tests/test_latency_plane.py``), on the CPU with ``Config(device="cpu")``.

* The same span events fed to both ledgers give equal sections, SLO
  verdicts included: the decomposition itself is exact.
* The same seeded frames stream (map → filter → CB window, integer-valued
  values) through both packages gives equal counts: traces decomposed,
  dropped, open, events lost, and each operator's per-segment trace
  counts and freshness count.  Times differ between two runs of any
  pipeline, so they are held to the plane's own contract instead: the
  five segments telescope to the staged→sunk sum at K = 1, 4 and 8,
  fused and unfused, wire off and on.
* Under the megastep at K > 1 the port waits on a group only at the
  recorder's sampled cadence, where JAX drains every group: there the
  ``dispatched_to_device_done`` count, ``shared_k_traces`` and the
  freshness count are the waited subset (equal to JAX's with every
  traced batch waited on).
* The SLO state machine, its verdict on the dominant operator only, the
  advisor's plan (equal to JAX's on the same section), ``tools/wf_slo.py``
  on the port's ``dump_stats``, and the off path, checked structurally.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.analysis import latency as jadv
from windflow_tpu.io.frames import FrameSource as JFrameSource
from windflow_tpu.monitoring import latency_ledger as jll
from windflow_tpu.monitoring import recorder as jrec
from windflow_tpu_torch.analysis import latency as tadv
from windflow_tpu_torch.monitoring import latency_ledger as tll
from windflow_tpu_torch.monitoring import recorder as trec

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CAP, KEYS = 4096, 256, 8


def _blob(n=N, seed=11):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, KEYS, n)
    rec["ts"] = np.arange(n, dtype=np.int64) * 500
    rec["v"] = rng.integers(0, 100, n)
    return rec.tobytes()


def _graph(pkg, fused=True, name="lat_app", **kw):
    """Frames → map → filter (chained or added) → CB window → sink."""
    blob = _blob()
    step = CAP * 24

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    kw = dict(dict(flight_recorder=True, trace_sample_every=2,
                   latency_ledger=True, key_compaction=False,
                   punctuation_interval_usec=10 ** 12), **kw)
    if pkg is wt:
        cfg, G, src = wt.Config(device="cpu", **kw), "GPU", wt.FrameSource
    else:
        cfg = dataclasses.replace(wf.default_config, **kw)
        G, src = "TPU", JFrameSource
    m = (getattr(pkg, f"Map{G}_Builder")(
        lambda t: {"key": t["key"], "v": t["v"] * 2.0}).withName("m").build())
    f = (getattr(pkg, f"Filter{G}_Builder")(lambda t: (t["key"] & 7) != 7)
         .withName("f").build())
    w = (getattr(pkg, f"Ffat_Windows{G}_Builder")(lambda t: t["v"],
                                                  lambda a, b: a + b)
         .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
         .withMaxKeys(KEYS).withName("win").build())
    fired = []
    snk = (pkg.Sink_Builder(lambda r: fired.append(r) if r is not None
                            else None).withName("snk").build())
    g = pkg.PipeGraph(name, config=cfg, time_policy=pkg.TimePolicy.EVENT)
    pipe = g.add_source(src(chunks, nv=1, fields=["v"],
                            output_batch_size=CAP))
    pipe.add(m)
    if fused:
        pipe.chain(f)
    else:
        pipe.add(f)
    pipe.add(w).add_sink(snk)
    return g, fired


def _run(pkg, **kw):
    g, fired = _graph(pkg, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    return g, fired


def _counts(lp, skip=()):
    """The section's counts: traces, events, and each operator's trace
    count per segment and freshness count."""
    per_op = {}
    for op, e in lp["per_op"].items():
        row = {seg: q["count"] for seg, q in e["segments_usec"].items()
               if seg not in skip}
        row["freshness"] = (e.get("freshness_usec") or {}).get("count")
        row["megastep_k"] = e.get("megastep_k")
        row["freshness_floor_usec"] = e.get("freshness_floor_usec")
        if "shared_k_traces" not in skip:
            row["shared_k_traces"] = e["shared_k_traces"]
        per_op[op] = row
    return {k: lp[k] for k in ("traces_decomposed", "traces_dropped",
                               "traces_open", "events_lost", "enabled",
                               "slo_ms")} | {"per_op": per_op}


# ---------------------------------------------------------------------------
# the decomposition on the same events: port == JAX exactly
# ---------------------------------------------------------------------------

def _feed_rings(mod, events, ring_size=512):
    rec = mod.FlightRecorder(sample_every=1, ring_events=4096)
    rings = {}
    for op, trace, stage, t, shared in events:
        ring = rings.get(op)
        if ring is None:
            ring = rings[op] = mod.ReplicaRing(op, 0, ring_size)
            rec.rings.append(ring)
        ring.record(trace, stage, t, shared)
    return rec


def _events(seed, n_traces=40, shared=0):
    rng = np.random.default_rng(seed)
    ev = []
    for tr in range(1, n_traces + 1):
        t = 1_000_000 + tr * 5_000
        # staged/emitted at the source, then the window, then the sink
        stamps = [("src", trec.STAGED), ("src", trec.EMITTED),
                  ("win", trec.COLLECTED), ("win", trec.DISPATCHED)]
        if tr % 3 == 0:
            stamps.append(("win", trec.DEVICE_DONE))
        stamps += [("snk", trec.COLLECTED), ("snk", trec.SUNK)]
        for op, st in stamps:
            t += int(rng.integers(0, 4_000))
            ev.append((op, tr, st, t,
                       shared if st in (trec.DISPATCHED,
                                        trec.DEVICE_DONE) else 0))
    return ev


@pytest.mark.parametrize("shared", [0, 4])
@pytest.mark.parametrize("slo_ms", [0.0, 1.0, 1e6])
def test_same_events_give_the_jax_section(shared, slo_ms):
    ev = _events(3, shared=shared)
    t = tll.LatencyLedger(_feed_rings(trec, ev), slo_ms=slo_ms)
    j = jll.LatencyLedger(_feed_rings(jrec, ev), slo_ms=slo_ms)
    for _ in range(2):
        t.tick()
        j.tick()
    assert t.section() == j.section()
    assert t.section()["traces_decomposed"] == 40
    if slo_ms == 1.0:
        assert t.slo_active and t.verdict == j.verdict


def test_wrapped_ring_counts_lost_events_as_jax():
    ev = _events(5, n_traces=60)
    t = tll.LatencyLedger(_feed_rings(trec, ev, ring_size=16))
    j = jll.LatencyLedger(_feed_rings(jrec, ev, ring_size=16))
    t.harvest()
    j.harvest()
    assert t.section() == j.section()
    assert t.events_lost > 0


def test_segments_and_arrows_equal_jax():
    assert tll.SEGMENTS == jll.SEGMENTS
    assert tll.SEGMENT_ARROWS == jll.SEGMENT_ARROWS
    assert tll._SEG_STAGE == jll._SEG_STAGE


# ---------------------------------------------------------------------------
# a graph: counts equal JAX's, segments telescope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", [False, True], ids=["wire_off", "wire_on"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_segment_sum_honesty(k, fused, wire):
    g, fired = _run(wt, megastep_sweeps=k, wire_compression=wire,
                    fused=fused)
    assert fired
    lp = g.stats()["Latency_plane"]
    assert lp["enabled"] and lp["traces_decomposed"] > 0
    assert lp["traces_dropped"] == 0 and lp["events_lost"] == 0
    seg_sum = sum(lp["segments_total_usec"].values())
    assert seg_sum == pytest.approx(lp["e2e_usec"]["sum"], rel=1e-9,
                                    abs=0.5)
    assert set(lp["segments_total_usec"]) == set(tll.SEGMENTS)
    per_op_sum = sum(e["total_usec"] for e in lp["per_op"].values())
    assert per_op_sum == pytest.approx(seg_sum, rel=1e-6, abs=0.5)
    shares = [e["budget_share"] for e in lp["per_op"].values()]
    assert all(0.0 <= s <= 1.0 for s in shares)
    assert sum(shares) == pytest.approx(1.0, abs=0.01)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_counts_equal_jax_at_k1(fused):
    kw = dict(megastep_sweeps=1, fused=fused, trace_sample_every=1,
              trace_device_sync_every=3)
    (tg, tf), (jg, jf) = _run(wt, **kw), _run(wf, **kw)
    assert len(tf) == len(jf) > 0
    tlp, jlp = tg.stats()["Latency_plane"], jg.stats()["Latency_plane"]
    assert _counts(tlp) == _counts(jlp)
    assert tlp["per_op"]["win"]["freshness_usec"]["count"] > 0


def test_counts_equal_jax_at_k4_on_the_shared_stamps():
    """K = 4, every batch traced, the default wait cadence: every count
    but the device_done ones equals JAX's, and the megastep edge's K and
    freshness floor are JAX's."""
    kw = dict(megastep_sweeps=4, trace_sample_every=1)
    (tg, _), (jg, _) = _run(wt, **kw), _run(wf, **kw)
    tlp, jlp = tg.stats()["Latency_plane"], jg.stats()["Latency_plane"]
    skip = ("dispatched_to_device_done", "shared_k_traces")
    tc, jc = _counts(tlp, skip), _counts(jlp, skip)
    tw, jw = tc["per_op"].pop("win"), jc["per_op"].pop("win")
    assert tc == jc
    assert tw.pop("freshness") <= jw.pop("freshness")
    assert tw == jw and tw["megastep_k"] == 4
    assert tw["freshness_floor_usec"] is not None


def test_megastep_shared_k_equals_jax_when_every_group_is_waited():
    """At ``trace_device_sync_every=1`` the port waits on every traced
    group, as JAX's drain does: shared_k traces, device-busy credit and
    freshness counts equal JAX's."""
    kw = dict(megastep_sweeps=4, trace_sample_every=1,
              trace_device_sync_every=1)
    (tg, _), (jg, _) = _run(wt, **kw), _run(wf, **kw)
    tst = tg.stats()
    assert tst["Megastep"]["edges"][0]["megasteps"] > 0
    tw = tst["Latency_plane"]["per_op"]["win"]
    jw = jg.stats()["Latency_plane"]["per_op"]["win"]
    assert tw["shared_k_traces"] > 0
    for key in ("shared_k_traces", "megastep_k", "freshness_floor_usec"):
        assert tw[key] == jw[key], key
    dev = tw["segments_usec"]["dispatched_to_device_done"]
    assert dev["count"] == \
        jw["segments_usec"]["dispatched_to_device_done"]["count"]
    assert tw["device_busy_usec"] <= dev["sum"] + 0.5
    assert tw["freshness_usec"]["count"] == jw["freshness_usec"]["count"]


# ---------------------------------------------------------------------------
# the SLO state machine and its verdict
# ---------------------------------------------------------------------------

class _NoRings:
    rings = ()


def _feed(led, e2e_usec, n, op="win", seg="emitted_to_dispatched"):
    for _ in range(n):
        led._recent.append((float(e2e_usec), [(op, seg, float(e2e_usec))]))


def test_slo_enter_latch_clear_as_jax():
    t = tll.LatencyLedger(_NoRings(), slo_ms=1.0, window=64,
                          clear_after=3, min_samples=8)
    j = jll.LatencyLedger(_NoRings(), slo_ms=1.0, window=64,
                          clear_after=3, min_samples=8)
    script = [("feed", 5000.0, 4, "emitted_to_dispatched"), ("tick",),
              ("feed", 5000.0, 4, "emitted_to_dispatched"), ("tick",),
              ("tick",), ("clear",),
              ("feed", 100.0, 16, "collected_to_sunk"), ("tick",),
              ("tick",), ("tick",), ("clear",),
              ("feed", 9000.0, 8, "emitted_to_dispatched"), ("tick",)]
    states = []
    for step in script:
        for led in (t, j):
            if step[0] == "feed":
                _feed(led, step[1], step[2], seg=step[3])
            elif step[0] == "tick":
                led.tick()
            else:
                led._recent.clear()
        assert (t.slo_active, t.slo_entered, t.slo_cleared, t.verdict) == \
            (j.slo_active, j.slo_entered, j.slo_cleared, j.verdict)
        states.append(t.slo_active)
    assert states == [False, False, False, True, True, True, True, True,
                      True, False, False, False, True]
    assert t.last_verdict["dominant_segment"] == "emitted_to_dispatched"
    assert "emitted→dispatched" in t.last_verdict["message"]


def test_slo_verdict_surfaces_in_health():
    g, _ = _graph(wt, trace_sample_every=1, latency_slo_ms=0.001,
                  name="lat_slo_app")
    g.start()
    while not g.is_done():
        if not g.step():
            break
        g.health_tick()
    g.wait_end()
    g.health_tick()
    st = g.stats()
    slo = st["Latency_plane"]["slo"]
    assert slo["active"] and slo["entered"] >= 1
    v = slo["verdict"]
    assert v["state"] == "SLO_VIOLATED"
    assert v["dominant_segment"] in tll.SEGMENTS
    h = st["Health"]
    assert h["graph_state"] == "SLO_VIOLATED"
    for name, hv in h["verdicts"].items():
        if name == v["dominant_op"]:
            assert hv["state"] == "SLO_VIOLATED"
            assert hv["slo"]["message"] == v["message"]
        else:
            assert hv["state"] != "SLO_VIOLATED" and "slo" not in hv


def test_generous_slo_keeps_health_ok():
    g, _ = _run(wt, trace_sample_every=1, latency_slo_ms=1e6,
                name="lat_ok_app")
    g.health_tick()
    st = g.stats()
    assert not st["Latency_plane"]["slo"]["active"]
    assert st["Health"]["graph_state"] == "OK"


# ---------------------------------------------------------------------------
# the advisor and tools/wf_slo.py
# ---------------------------------------------------------------------------

def _synthetic_section(p99_usec, budget_ms, k=8,
                       dom="emitted_to_dispatched"):
    q = {"count": 10, "p50": p99_usec / 2, "p99": p99_usec, "sum": 1.0,
         "buckets": []}
    return {
        "enabled": True, "slo_ms": budget_ms, "traces_decomposed": 10,
        "e2e_usec": {"p99": p99_usec},
        "per_op": {
            "win": {"segments_usec": {dom: q}, "budget_share": 0.8,
                    "total_usec": 8.0, "dominant_segment": dom,
                    "device_busy_usec": 1.0, "megastep_k": k,
                    "freshness_floor_usec": 12.5},
            "src": {"segments_usec": {"staged_to_emitted": q},
                    "budget_share": 0.2, "total_usec": 2.0,
                    "dominant_segment": "staged_to_emitted",
                    "device_busy_usec": 0.0},
        },
        "slo": {"active": True, "budget_ms": budget_ms,
                "verdict": {"message": "m"}},
    }


@pytest.mark.parametrize("p99_usec,budget_ms,dom", [
    (130_000, 50, "emitted_to_dispatched"),
    (130_000, 50, "staged_to_emitted"),
    (10_000, 50, "emitted_to_dispatched"),
    (10_000, 0, "emitted_to_dispatched"),
])
def test_advisor_plan_equals_jax(p99_usec, budget_ms, dom):
    sec = _synthetic_section(p99_usec, budget_ms, dom=dom)
    assert tadv.plan(sec, graph_name="g") == jadv.plan(sec, graph_name="g")
    assert tadv.rank(sec) == jadv.rank(sec)
    p = tadv.plan(sec)
    if budget_ms and p99_usec > budget_ms * 1000 \
            and dom == "emitted_to_dispatched":
        acts = p["ops"][0]["actions"]
        assert acts[0]["kind"] == "set_megastep_sweeps"
        assert acts[0]["recommended_k"] < 8


def test_wf_slo_reads_the_port_dump(tmp_path):
    g, _ = _run(wt, trace_sample_every=1, latency_slo_ms=0.001,
                megastep_sweeps=4, log_dir=str(tmp_path), name="lat_cli_app")
    g.health_tick()
    path = g.dump_stats()
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "wf_slo.py"),
                        "--json", "--stats", path],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode in (0, 1), r.stderr
    p = json.loads(r.stdout)
    assert p["advisor"] == "latency/1" and p["over_budget"]
    assert p == jadv.plan(json.load(open(path))["Latency_plane"])
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "wf_slo.py"),
                        "--check", "--stats", path],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 1 and "SLO VIOLATED" in r.stdout


# ---------------------------------------------------------------------------
# the off path: nothing built, nothing called
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_kw", [{"latency_ledger": False},
                                    {"flight_recorder": False}],
                         ids=["ledger_off", "recorder_off"])
def test_off_path_never_builds(cfg_kw):
    g, fired = _run(wt, name="lat_off_app", **cfg_kw)
    assert fired
    assert g._latency is None
    assert all(rep.latency is None for rep in g._all_replicas)
    assert g._health is None or g._health.latency is None
    assert g.stats()["Latency_plane"] == {"enabled": False}


def test_freshness_read_only_on_waited_batches(monkeypatch):
    """The freshness gauge reads a batch's fired lanes only where the
    recorder already waited on it: as many reads as device_done stamps
    on the window."""
    calls = []
    real = tll.LatencyLedger.note_window_fire

    def counted(self, *a, **k):
        calls.append(a[0])
        return real(self, *a, **k)
    monkeypatch.setattr(tll.LatencyLedger, "note_window_fire", counted)
    for k in (1, 4):
        calls.clear()
        g, _ = _run(wt, megastep_sweeps=k, trace_sample_every=1,
                    trace_device_sync_every=2, name=f"lat_fr_{k}")
        done = [e for e in g._recorder.events()
                if e["stage"] == "device_done" and e["op"] == "win"]
        assert calls and set(calls) == {"win"}
        assert len(calls) == len(done)
