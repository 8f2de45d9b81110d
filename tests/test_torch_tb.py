"""Time-based FFAT windows in the port against the JAX package, on the CPU
(windflow_tpu_torch/windows/ffat_kernels.py ``make_ffat_tb_step`` and
windows/ffat_gpu.py against their JAX originals).

Step level: the same numpy batches (fixed seeds) and watermarks go
through both packages' ``make_ffat_tb_step``, both starting from the JAX
state handed across by ``interop.ffat_tb_state_from_numpy``.  After every
step the fired mask, the fired lanes (key, wid, value, ts), ``n_advanced``
and every state field must be equal.  The streams are out of order, keys
run out of range, the watermark is unresolved for two batches, then
stalls and jumps.  Where JAX groups through ``order_hist`` it runs the
Pallas interpreter (``PallasMode(True)``) when the port runs its kernel
wrappers, and the lax path (the kill switch) when the port does not.

Graph level: the TB cells of tests/test_windows.py and
tests/test_monoid_combiner.py, and small ad_analytics / telemetry
shapes, through both packages' ``PipeGraph.run()`` in EVENT time:
records, the three TB stats counters and the ring size NP must be equal.
Cells the JAX suite runs at soak depth are cut in depth here.  The two
merged-source cells (test_windows.py:749, :792) drive the window
operator through each package's own watermark collector with two
channels interleaved batch by batch: the port has no merge yet (ROADMAP
A3).  test_windows.py:836, the multi-host span-regrow skip, is held in
full below (the process count is ``torch.distributed``'s world size).

Tolerances: integer-valued data equal record for record; random floats
bit-identical on the generic combiner (the same scan and fold combine
trees), rtol 1e-5 on the declared sum (a scatter-add whose order
differs, JAX's psum tolerance).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
from windflow_tpu import kernels as pk
from windflow_tpu.windows import ffat_kernels as jfk
import windflow_tpu_torch as wt
from conftest import tb_window_sums
from windflow_tpu_torch.interop import ffat_tb_state_from_numpy
from windflow_tpu_torch.windows import ffat_kernels as tfk

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

_JC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": jnp.maximum, "min": jnp.minimum}
_TC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": torch.maximum, "min": torch.minimum}
_STATS = ("Late_tuples_dropped", "Pane_cells_evicted",
          "Windows_dropped_on_overflow")


# ---------------------------------------------------------------------------
# step level
# ---------------------------------------------------------------------------

def _tb_batches(seed, n, K, P, cap, floats=False):
    """``n`` batches of (keys, values, ts, valid, wm_pane): keys in
    [-1, K], timestamps ~P/4 apart jittered back by up to 2 panes, a
    40-pane idle gap before batch 3; the watermark is unresolved for two
    batches, stalls at batch 4 and then jumps with the data."""
    rng = np.random.default_rng(seed)
    out, t0, wm = [], 0, -(1 << 60)
    for b in range(n):
        k = rng.integers(-1, K + 1, cap).astype(np.int32)
        if floats:
            v = rng.standard_normal(cap).astype(np.float32)
        else:
            v = rng.integers(-50, 50, cap).astype(np.float32)
        ts = t0 + np.arange(cap) * (P // 4) - rng.integers(0, 2 * P, cap)
        ts = np.maximum(ts, 0).astype(np.int64)
        t0 += cap * (P // 4) + (40 * P if b == 2 else 0)
        valid = rng.random(cap) < 0.9
        if b >= 2 and b != 4:
            wm = int(ts.max()) // P - 3
        out.append((k, v, ts, valid, wm))
    return out


def _steps(K, P, R, D, NP, cap, monoid, drop, kernels):
    js = jax.jit(jfk.make_ffat_tb_step(
        cap, K, P, R, D, NP, lambda t: t["v"], _JC[monoid], lambda t: t["k"],
        drop_tainted=drop, monoid=monoid,
        pallas=pk.PallasMode(True) if kernels else None))
    ts_ = tfk.make_ffat_tb_step(
        cap, K, P, R, D, NP, lambda t: t["v"], _TC[monoid], lambda t: t["k"],
        drop_tainted=drop, monoid=monoid, kernels=kernels)
    return js, ts_


def _run_steps(K, P, R, D, NP, cap, monoid, drop, kernels, floats=False,
               n=6, seed=0):
    """Both steps over the same batches; returns the number of fired
    windows and the JAX counters.  Exact unless ``floats`` with a
    declared sum."""
    exact = not (floats and monoid == "sum")
    js, ts_ = _steps(K, P, R, D, NP, cap, monoid, drop, kernels)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.float32), K, NP)
    tst = ffat_tb_state_from_numpy(jax.tree.map(np.asarray, jst))
    n_fired = 0
    for k, v, ts, valid, wm in _tb_batches(seed, n, K, P, cap, floats):
        jst, jo, jf, jt, jn = js(
            jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(ts),
            jnp.asarray(valid), jnp.int64(wm))
        tst, to, tf, tt, tn = ts_(
            tst, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
            torch.from_numpy(ts), torch.from_numpy(valid), wm)
        m = np.asarray(jf)
        np.testing.assert_array_equal(tf.numpy(), m)
        n_fired += int(m.sum())
        for f in ("key", "wid", "value"):
            a, b = np.asarray(jo[f])[m], to[f].numpy()[m]
            assert a.dtype == b.dtype, f
            if f == "value" and not exact:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(tt.numpy()[m], np.asarray(jt)[m])
        assert int(tn) == int(jn)
        for key in jst:
            a, b = np.asarray(jst[key]), tst[key].numpy()
            assert a.dtype == b.dtype, key
            if key == "cells" and not exact:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(b, a, err_msg=key)
    return n_fired, {k: int(np.asarray(jst[k]))
                     for k in ("n_late", "n_evicted", "n_win_dropped")}


# (K, P, R, D, NP, cap, monoid, drop_tainted, kernels, floats): K*NP + 1
# ids under the kernel gate (<= 4096), in the radix range (<= 65,536:
# 4,161) and beyond it (67,201: the stable sort); kernels False is the
# kill switch on both sides
STEP_CASES = {
    "generic-floats-kernel-drop": (4, 1000, 4, 1, 16, 64, None, True, True,
                                   True),
    "sum-floats-hopping-gap-lax": (4, 1000, 2, 3, 16, 64, "sum", False,
                                   False, True),
    "max-slide-2-drop": (6, 1000, 4, 2, 12, 64, "max", True, True, False),
    "min-count": (4, 1000, 4, 1, 16, 64, "min", False, True, False),
    "generic-hopping-gap-lax": (4, 1000, 2, 3, 16, 64, None, False, False,
                                False),
    "generic-radix": (260, 1000, 4, 1, 16, 64, None, True, True, False),
    "generic-sort": (4200, 1000, 4, 1, 16, 64, None, False, True, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tb_step_matches_jax(case):
    *args, floats = STEP_CASES[case]
    n_fired, counters = _run_steps(*args, floats=floats)
    assert n_fired > 0
    # the stream overflows the ring and has late tuples: the policy and
    # counter paths all run
    assert counters["n_late"] > 0 and counters["n_evicted"] > 0
    assert (counters["n_win_dropped"] > 0) == args[7]


def test_tb_step_no_fire_passes_match_the_cond_branch():
    """JAX folds under lax.cond only when a pass fires; the port's plain
    route folds and selects JAX's no_fold zeros where a pass fired
    nothing.  On an ordered stream under a resolved watermark the
    pre-place passes fire nothing: every output lane, unfired lanes
    included, and the counters are the same."""
    K, P, R, D, NP, cap = 4, 1000, 4, 1, 32, 64
    js, ts_ = _steps(K, P, R, D, NP, cap, None, True, True)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.float32), K, NP)
    tst = ffat_tb_state_from_numpy(jax.tree.map(np.asarray, jst))
    rng = np.random.default_rng(3)
    MW = NP // D + 2
    for b in range(5):
        k = rng.integers(0, K, cap).astype(np.int32)
        v = rng.integers(-9, 9, cap).astype(np.float32)
        # 6.4 panes a batch: consecutive batches share a pane, so pass
        # B of one step already fired up to the next step's frontier A
        ts = (b * cap + np.arange(cap)) * (P // 10)
        wm = int(ts.max()) // P
        jst, jo, jf, _, jn = js(
            jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(ts),
            jnp.ones(cap, bool), jnp.int64(wm))
        tst, to, tf, _, tn = ts_(
            tst, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
            torch.from_numpy(ts), torch.ones(cap, dtype=torch.bool), wm)
        m = np.asarray(jf).reshape(K, 3, MW)
        assert not m[:, :2].any()          # passes A fired nothing
        np.testing.assert_array_equal(tf.numpy(), m.reshape(-1))
        for f in ("key", "wid", "value"):
            np.testing.assert_array_equal(to[f].numpy(), np.asarray(jo[f]))
        assert not to["value"].numpy().reshape(K, 3, MW)[:, :2].any()
        assert int(tn) == int(jn)
        for key in ("n_late", "n_evicted", "n_win_dropped", "win_next"):
            assert int(tst[key]) == int(jst[key])
    assert int(jst["win_next"]) > 0


def test_tb_step_stalled_then_jumping_watermark():
    """tests/test_windows.py:478 in both packages: the watermark stalls
    while data fills the ring to its edge, then jumps past everything;
    the two pre-place passes fire every in-ring window before the
    capacity roll could evict them."""
    K, P, R, D, NP, cap = 1, 1000, 4, 1, 16, 8
    js = jax.jit(jfk.make_ffat_tb_step(cap, K, P, R, D, NP, lambda t: t["v"],
                                       lambda a, b: a + b, None))
    ts_ = tfk.make_ffat_tb_step(cap, K, P, R, D, NP, lambda t: t["v"],
                                lambda a, b: a + b, None)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.int64), K, NP)
    tst = ffat_tb_state_from_numpy(jax.tree.map(np.asarray, jst))
    fired = {}
    for tss, wm in (([i * 1000 for i in range(8)], 0),
                    ([i * 1000 for i in range(8, 16)], 0),
                    ([1_000_000 + i * 1000 for i in range(8)], 2000)):
        ts = np.asarray(tss, np.int64)
        jst, jo, jf, _, _ = js(jst, {"v": jnp.asarray(ts)}, jnp.asarray(ts),
                               jnp.ones(cap, bool), jnp.int64(wm))
        tst, to, tf, _, _ = ts_(tst, {"v": torch.from_numpy(ts)},
                                torch.from_numpy(ts),
                                torch.ones(cap, dtype=torch.bool), wm)
        m = np.asarray(jf)
        np.testing.assert_array_equal(tf.numpy(), m)
        for w, val in zip(to["wid"].numpy()[m], to["value"].numpy()[m]):
            assert int(w) not in fired
            fired[int(w)] = int(val)
        np.testing.assert_array_equal(to["value"].numpy()[m],
                                      np.asarray(jo["value"])[m])
    assert int(tst["n_evicted"]) == 0 and int(tst["n_late"]) == 0
    for w in range(13):
        assert fired.get(w) == sum(p * 1000 for p in range(w, w + 4))


def test_ts_extrema_ride_through_mask_only_stages():
    """Staging attaches the data timestamp extrema of the real lanes
    (as the JAX package's staging does); map, filter, a chain and the
    watermark collector's rewrite carry them; the window output, a
    device-born batch, has none."""
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    from windflow_tpu_torch.ops.chained import fuse
    from windflow_tpu_torch.parallel.collectors import WatermarkCollector
    items = [{"k": np.int32(i % 3), "v": np.float32(i)} for i in range(5)]
    tss = [40, 10, 70, 20, 30]
    b = host_to_device(HostBatch(items, tss, watermark=10), 8,
                       torch.device("cpu"), frontier=70)
    jb = wf.batch.host_to_device(wf.batch.HostBatch(items, tss, 10), 8,
                                 frontier=70)
    assert (b.ts_min, b.ts_max) == (jb.ts_min, jb.ts_max) == (10, 70)
    m = wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] * 2}).build()
    f = wt.FilterGPU_Builder(lambda t: t["v"] > 2).build()
    coll = WatermarkCollector(2)
    coll.on_message(1, b)              # a second channel holds the fold
    for out in [m._step(b), f._step(b), fuse(m, f)._step(b),
                *coll.on_message(0, b)]:
        assert (out.ts_min, out.ts_max) == (10, 70)
    win = wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, c: a + c) \
        .withTBWindows(20, 10).withKeyBy(lambda t: t["k"]).withMaxKeys(3) \
        .build()
    win.config = _port_cfg()
    out = win._step(b)
    assert out.ts_max is None and out.ts_min is None


def test_tb_state_layout_and_handoff_checks():
    spec = torch.zeros((), dtype=torch.float32)
    st = tfk.make_ffat_tb_state(spec, 4, 16)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.float32), 4, 16)
    assert set(st) == set(jst)
    for key in st:
        assert st[key].numpy().dtype == np.asarray(jst[key]).dtype, key
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
    with pytest.raises(wt.WindFlowError, match="TB"):
        ffat_tb_state_from_numpy({"carry": np.zeros(3)})


# ---------------------------------------------------------------------------
# graph level
# ---------------------------------------------------------------------------

N_KEYS, LENGTH = 4, 400
TWIN, TSLIDE = 16_000, 4_000


def _jax_cfg():
    # punctuation off the clock, so batch boundaries and watermarks are
    # the same in both packages; the lax grouping (the kernel's
    # interpreter is held against the port at step level above)
    return dataclasses.replace(wf.default_config,
                               punctuation_interval_usec=10 ** 12,
                               pallas_kernels="0")


def _port_cfg():
    return wt.Config(device="cpu", punctuation_interval_usec=10 ** 12)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _window(pkg, win, slide, *, keyed=True, max_keys=N_KEYS, lateness=0,
            pane_cap=None, policy=None, monoid=None, comb="add"):
    WB = wt.Ffat_WindowsGPU_Builder if pkg is wt \
        else wf.Ffat_WindowsTPU_Builder
    fn = {"add": lambda a, b: a + b,
          "max": torch.maximum if pkg is wt else jnp.maximum}[comb]
    b = WB(lambda t: t["value"], fn).withTBWindows(win, slide) \
        .withMaxKeys(max_keys)
    if keyed:
        b = b.withKeyBy(lambda t: t["key"])
    if lateness:
        b = b.withLateness(lateness)
    if pane_cap is not None:
        b = b.withPaneCapacity(pane_cap)
    if policy is not None:
        b = b.withOverflowPolicy(policy)
    if monoid is not None:
        b = b.withMonoidCombiner(monoid)
    return b.build()


def _graph_run(pkg, items, batch, **window):
    """items → EVENT-time Source → TB window → Sink; returns the sorted
    (key, wid, value) records and the window operator."""
    got = []
    op = _window(pkg, **window)
    src = (pkg.Source_Builder(lambda: iter(items))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(batch).build())
    snk = pkg.Sink_Builder(
        lambda r: got.append((int(r["key"]), int(r["wid"]), r["value"]))
        if r is not None else None).build()
    g = pkg.PipeGraph("tb", pkg.ExecutionMode.DEFAULT, pkg.TimePolicy.EVENT,
                      config=_port_cfg() if pkg is wt else _jax_cfg())
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return sorted(got), op


def _same(a, b):
    """Records, the three TB counters and the ring size of both runs."""
    (ra, opa), (rb, opb) = a, b
    assert ra == rb
    sa, sb = opa.dump_stats(), opb.dump_stats()
    assert [sa[k] for k in _STATS] == [sb[k] for k in _STATS]
    assert opa.NP == opb.NP
    return ra, sa


def _mixed():
    """test_windows.py:316, :417, :430 and :525 in one stream: disorder
    inside the lateness (jitter of 2 ms under 2.5 ms), every 40th tuple a
    straggler 60 ms late (dropped and counted), and an idle gap of 1 s
    (250 panes, far wider than the ring) on a batch boundary."""
    rnd = random.Random(21)
    out = []
    for i in range(LENGTH):
        ts = i * 1000 + rnd.randint(-2000, 2000) + (10 ** 6 if i >= 195
                                                      else 0)
        if i % 40 == 39:
            ts -= 60_000
        out.append({"key": i % N_KEYS, "value": i, "ts": max(0, ts)})
    return out


def _points(items):
    per_key = {}
    for t in items:
        per_key.setdefault(t.get("key", 0), []).append((t["ts"], t["value"]))
    return per_key


# cell -> (items, batch, window kwargs)
GRAPH_CELLS = {
    # batches of 13 straddle pane boundaries; the gap is at 15 batches
    "disorder-late-jump": (_mixed, 13, {"lateness": 2500}),
    # test_windows.py:342, a tight user-sized ring with lateness
    "small-ring-lateness": (
        lambda: [{"key": i % N_KEYS, "value": i, "ts": i * 1000}
                 for i in range(LENGTH)], 32,
        {"pane_cap": 16, "lateness": 2_000}),
}


@pytest.mark.parametrize("cell", list(GRAPH_CELLS))
def test_tb_graph_matches_jax(cell):
    make, batch, kw = GRAPH_CELLS[cell]
    items = make()
    kw = {"win": TWIN, "slide": TSLIDE, **kw}
    recs, st = _same(_graph_run(wf, items, batch, **kw),
                     _graph_run(wt, items, batch, **kw))
    on_time = [t for t in items if t["value"] % 40 != 39] \
        if cell == "disorder-late-jump" else items
    want = tb_window_sums(_points(on_time), TWIN, TSLIDE)
    got = {(k, w): v for k, w, v in recs}
    if cell == "disorder-late-jump":
        # stragglers are dropped, counted, and spoil only their windows
        assert 0 < st["Late_tuples_dropped"] <= LENGTH // 40
        assert sum(got.get(kw_) == v for kw_, v in want.items()) \
            > 0.8 * len(want)
        assert [st[k] for k in _STATS[1:]] == [0, 0]
    else:
        assert got == want
        assert [st[k] for k in _STATS] == [0, 0, 0]


def test_tb_graph_overflow_policies_match_jax():
    """test_windows.py:547: one batch spans far more panes than the ring
    and lateness pins windows open; 'drop' suppresses and counts, 'count'
    fires wrong windows, 'error' raises in both packages."""
    items = [{"key": 0, "value": i, "ts": i * 4_000} for i in range(40)]
    kw = dict(win=TWIN, slide=TSLIDE, max_keys=1, pane_cap=8,
              lateness=240_000)
    want = tb_window_sums(_points(items), TWIN, TSLIDE)
    recs, st = _same(_graph_run(wf, items, 8, policy="drop", **kw),
                     _graph_run(wt, items, 8, policy="drop", **kw))
    assert st["Pane_cells_evicted"] > 0
    assert st["Windows_dropped_on_overflow"] > 0
    assert all(want[(k, w)] == v for k, w, v in recs)
    assert len(recs) < len(want)
    recs, st = _same(_graph_run(wf, items, 8, policy="count", **kw),
                     _graph_run(wt, items, 8, policy="count", **kw))
    assert st["Windows_dropped_on_overflow"] == 0
    assert any(want.get((k, w)) != v for k, w, v in recs)
    for pkg in (wf, wt):
        with pytest.raises(pkg.WindFlowError, match="overflow"):
            _graph_run(pkg, items, 8, policy="error", **kw)


def test_tb_graph_ring_regrows_like_jax():
    """test_windows.py:627 and :671 (and :593's non-keyed window at
    parallelism 1), cut in depth: a first batch inside one pane sizes the
    ring small, then one tuple a pane; the span regrow grows the ring
    ahead of the capacity roll (to the same NP in both packages), nothing
    is evicted, and the error policy does not fire."""
    batch = 256
    items = [{"key": 0, "value": 1, "ts": i} for i in range(batch)]
    items += [{"key": 0, "value": 1, "ts": (j + 1) * 4_000}
              for j in range(3 * batch)]
    kw = dict(win=16_000, slide=4_000, keyed=False, max_keys=1,
              policy="error")
    recs, st = _same(_graph_run(wf, items, batch, **kw),
                     _graph_run(wt, items, batch, **kw))
    assert st["Pane_cells_evicted"] == 0
    assert recs and all(v == 4 for _, w, v in recs if 4 <= w < 3 * batch - 4)


def test_tb_graph_declared_max_with_lateness_and_disorder():
    """test_monoid_combiner.py:153 and :266: a declared max on strictly
    negative values (the identity trap), with disorder beyond the
    lateness: the same records and the same counted late tuples as the
    JAX run."""
    rnd = random.Random(40)
    items = [{"key": i % 3, "value": -1.0 - ((i * 53) % 89) / 9.0,
              "ts": i * 1000} for i in range(300)]
    for i in range(0, 300 - 30, 30):
        seg = items[i:i + 30]
        rnd.shuffle(seg)
        items[i:i + 30] = seg
    kw = dict(win=20_000, slide=5_000, max_keys=3, comb="max", monoid="max",
              lateness=2_000)
    recs, st = _same(_graph_run(wf, items, 23, **kw),
                     _graph_run(wt, items, 23, **kw))
    assert recs and st["Late_tuples_dropped"] > 0
    assert all(v < 0 for _, _, v in recs)


def test_tb_forward_parallelism_rejected_in_both():
    for pkg in (wf, wt):
        with pytest.raises(pkg.WindFlowError, match="parallelism == 1"):
            WB = wt.Ffat_WindowsGPU_Builder if pkg is wt \
                else wf.Ffat_WindowsTPU_Builder
            (WB(lambda t: t["value"], lambda a, b: a + b)
             .withTBWindows(8_000, 8_000).withMaxKeys(1)
             .withParallelism(2).build())
        with pytest.raises(pkg.WindFlowError, match="pane_capacity"):
            _window(pkg, 16_000, 4_000, pane_cap=7)
        with pytest.raises(pkg.WindFlowError, match="overflow policy"):
            _window(pkg, 16_000, 4_000, policy="spill")


def _merged_run(pkg, a, b, batch, **window):
    """Two sources merged into one TB window operator: each package's
    staging (``host_to_device``) and watermark collector feed the
    operator, the channels interleaved batch by batch as the scheduler
    sweeps them; then both channels end and the operator flushes."""
    if pkg is wt:
        from windflow_tpu_torch.batch import HostBatch, host_to_device
        from windflow_tpu_torch.parallel.collectors import WatermarkCollector

        def stage(hb, fr):
            return host_to_device(hb, batch, torch.device("cpu"), frontier=fr)
    else:
        from windflow_tpu.batch import HostBatch, host_to_device
        from windflow_tpu.parallel.collectors import WatermarkCollector

        def stage(hb, fr):
            return host_to_device(hb, batch, frontier=fr)
    op = _window(pkg, **window)
    op.config = _port_cfg() if pkg is wt else _jax_cfg()
    coll = WatermarkCollector(2)
    got = []

    def take(out):
        m = _np(out.valid)
        for k, w, v in zip(_np(out.payload["key"])[m],
                           _np(out.payload["wid"])[m],
                           _np(out.payload["value"])[m]):
            got.append((int(k), int(w), v.item()))
    for lo in range(0, len(a), batch):
        for ch, src in enumerate((a, b)):
            chunk = src[lo:lo + batch]
            tss = [t["ts"] for t in chunk]
            # a source's watermark is the running max of its stamps; a
            # batch carries the one at its first tuple, its frontier the
            # one at its last
            seen = max(t["ts"] for t in src[:lo + 1])
            hb = HostBatch(chunk, tss, watermark=seen)
            for msg in coll.on_message(ch, stage(hb, max(tss + [seen]))):
                take(op._step(msg))
    for ch in (0, 1):
        coll.on_channel_eos(ch)
    for out in op._flush_tb(0):
        take(out)
    return sorted(got), op


@pytest.mark.parametrize("lead", [200_000, 0])
def test_tb_merged_channels_match_jax(lead):
    """test_windows.py:749 (one channel 200 panes ahead: the ring grows
    to cover the lag, nothing evicted) and :792 (no lag: the ring stays
    sized to the observed spread), cut in depth."""
    n = 160
    a = [{"key": 0, "value": i, "ts": i * 1000 + lead} for i in range(n)]
    b = [{"key": 1, "value": i, "ts": i * 1000} for i in range(n)]
    kw = dict(win=4_000, slide=1_000, max_keys=2)
    recs, st = _same(_merged_run(wf, a, b, 16, **kw),
                     _merged_run(wt, a, b, 16, **kw))
    assert [st[k] for k in _STATS] == [0, 0, 0]
    assert {(k, w): v for k, w, v in recs} == \
        tb_window_sums(_points(a + b), 4_000, 1_000)


def _ad_graph(pkg, events, table_np, n_campaigns, batch, sum_combiner):
    """The shape of windflow_tpu/models/ad_analytics.py (YSB): view
    filter | ad→campaign join (a gather from a table on the device) →
    per-campaign 10 s tumbling TB counts."""
    got = []
    if pkg is wt:
        table = torch.from_numpy(table_np)
        FB, MB, WB = (wt.FilterGPU_Builder, wt.MapGPU_Builder,
                      wt.Ffat_WindowsGPU_Builder)
    else:
        table = jnp.asarray(table_np)
        FB, MB, WB = (wf.FilterTPU_Builder, wf.MapTPU_Builder,
                      wf.Ffat_WindowsTPU_Builder)
    win = (WB(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(10_000_000, 10_000_000)
           .withKeyBy(lambda e: e["campaign"]).withMaxKeys(n_campaigns))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = pkg.PipeGraph("ad_analytics", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT,
                      config=_port_cfg() if pkg is wt else _jax_cfg())
    pipe = g.add_source(pkg.Source_Builder(lambda: iter(events))
                        .withTimestampExtractor(lambda e: e["ts"])
                        .withOutputBatchSize(batch).build())
    pipe.add(FB(lambda e: e["etype"] == 1).build())
    pipe.chain(MB(lambda e: {"campaign": table[e["ad_id"]], "one": 1})
               .build())
    pipe.add(win).add_sink(pkg.Sink_Builder(
        lambda r: got.append((int(r["key"]), int(r["wid"]), int(r["value"])))
        if r is not None else None).build())
    g.run()
    return sorted(got), win


@pytest.mark.parametrize("sum_combiner", [False, True])
def test_tb_ad_analytics_shape_matches_jax(sum_combiner):
    """50 ads onto 10 campaigns, etype uniform over {0, 1, 2}, 3,000
    events 20 ms apart (six windows a campaign): the generic combiner as
    ad_analytics.py builds it, and withSumCombiner as bench.py's YSB leg
    does — the scatter placement of a declared sum that
    test_windows.py:716 holds against the grouped one."""
    rng = np.random.default_rng(3)
    table_np = rng.integers(0, 10, 50).astype(np.int32)
    events = [{"ad_id": int(a), "etype": int(e), "ts": i * 20_000}
              for i, (a, e) in enumerate(zip(rng.integers(0, 50, 3000),
                                             rng.integers(0, 3, 3000)))]
    recs, st = _same(_ad_graph(wf, events, table_np, 10, 512, sum_combiner),
                     _ad_graph(wt, events, table_np, 10, 512, sum_combiner))
    want = {}
    for e in events:
        if e["etype"] == 1:
            kw_ = (int(table_np[e["ad_id"]]), e["ts"] // 10_000_000)
            want[kw_] = want.get(kw_, 0) + 1
    assert {(k, w): v for k, w, v in recs} == want
    assert [st[k] for k in _STATS] == [0, 0, 0]


def test_tb_telemetry_shape_matches_jax():
    """The shape of windflow_tpu/models/telemetry_frames.py: normalize |
    drop-NaN → per-sensor 60 s windows sliding by 5 s, lateness 1 s,
    overflow policy drop; 16 sensors, 2,400 readings 100 ms apart, each
    jittered back by up to 0.5 s (inside the lateness: nothing is late),
    integer-valued float32 values with some NaNs.  A per-record source
    stands in for the app's FrameSource in both packages."""
    rng = np.random.default_rng(8)
    n = 2400
    vals = rng.integers(-100, 101, n).astype(np.float32)
    vals[rng.random(n) < 0.02] = np.nan
    items = [{"key": int(k), "v0": v, "ts": max(0, int(i * 100_000 - j))}
             for i, (k, v, j) in enumerate(zip(rng.integers(0, 16, n), vals,
                                               rng.integers(0, 500_000, n)))]
    out = {}
    for pkg in (wf, wt):
        got = []
        MB = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
        FB = wt.FilterGPU_Builder if pkg is wt else wf.FilterTPU_Builder
        WB = wt.Ffat_WindowsGPU_Builder if pkg is wt \
            else wf.Ffat_WindowsTPU_Builder
        win = (WB(lambda t: t["v0"], lambda a, b: a + b)
               .withTBWindows(60_000_000, 5_000_000)
               .withKeyBy(lambda t: t["key"]).withMaxKeys(16)
               .withLateness(1_000_000).withOverflowPolicy("drop").build())
        g = pkg.PipeGraph("telemetry", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT,
                          config=_port_cfg() if pkg is wt else _jax_cfg())
        pipe = g.add_source(pkg.Source_Builder(lambda: iter(items))
                            .withTimestampExtractor(lambda t: t["ts"])
                            .withOutputBatchSize(256).build())
        pipe.add(MB(lambda t: {"key": t["key"], "v0": t["v0"]}).build())
        pipe.chain(FB(lambda t: t["v0"] == t["v0"]).build())
        pipe.add(win).add_sink(pkg.Sink_Builder(
            lambda r: got.append((int(r["key"]), int(r["wid"]),
                                  float(r["value"])))
            if r is not None else None).build())
        g.run()
        out[pkg] = (sorted(got), win)
    recs, st = _same(out[wf], out[wt])
    want = tb_window_sums(
        _points([{"key": t["key"], "ts": t["ts"], "value": float(t["v0"])}
                 for t in items if t["v0"] == t["v0"]]), 60_000_000,
        5_000_000)
    assert {(k, w): v for k, w, v in recs} == want
    assert [st[k] for k in _STATS] == [0, 0, 0]


def test_ffat_gpu_tb_span_regrow_skipped_multi_host(monkeypatch):
    """test_windows.py:836: the span regrow reads host batch extrema,
    which across processes are each process's own; with a world size
    > 1 it is a no-op (the eviction-cadence regrow stays the growth
    path), and the same batch grows the ring in one process."""
    import types

    from windflow_tpu_torch.parallel import multihost
    items = [{"key": 0, "value": 1, "ts": i * 1000} for i in range(64)]
    src = (wt.Source_Builder(lambda: iter(items))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(16).build())
    op = (wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                     lambda a, b: a + b)
          .withTBWindows(8_000, 2_000).withMaxKeys(1).build())
    g = wt.PipeGraph("mh_skip", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=wt.Config(device="cpu"))
    g.add_source(src).add(op).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    g.run()
    np0 = op.NP
    assert op._auto_np and np0 < op._np_ceil
    wide = types.SimpleNamespace(
        frontier=64_000, ts_min=64_000,
        ts_max=64_000 + op.P * (np0 + 512))
    monkeypatch.setattr(multihost, "process_count", lambda: 2)
    op._regrow_for_span(wide)
    assert op.NP == np0
    monkeypatch.setattr(multihost, "process_count", lambda: 1)
    op._regrow_for_span(wide)
    assert op.NP > np0
