"""Twins of six JAX-package test files that had none in the port, run
against windflow_tpu_torch on the CPU (``Config(device="cpu")``, the
device operators' torch twins of the TPU ones), their non-slow cases
only:

* ``tests/test_multicast_cow.py`` — an in-place host map on one branch of
  a split, or on one replica of a broadcast, does not corrupt what its
  siblings see;
* ``tests/test_backpressure.py`` — host inboxes and in-flight device
  batches stay bounded under a slow consumer, and the stats report it;
* ``tests/test_punctuation.py`` — a TB window fires on an idle stream,
  and the count cadence flushes an open batch;
* ``tests/test_ordering_perf.py`` — the ordering and K-slack collectors:
  the k-way merge releases in order, K-slack ships release runs as
  batches and splits them on the shared flag.  The JAX file bounds the
  100,000-tuple merge by the wall clock; this twin checks the same run
  structurally (every tuple released once, in order), with no
  wall-clock bound;
* ``tests/test_metamorphic_mixed.py`` — the mixed host + device DAG
  swept over parallelism and batch sizes against a Python oracle;
* ``tests/test_ffat_spec_sweep.py`` — the coprime (9, 5) window spec on
  the device FFAT operator (CB, TB, declared max) and the four host
  window families over four spec classes, TB and CB.

Every oracle is the JAX file's own (pure Python), so the port is held to
exactly what the JAX package is held to.  Exact everywhere.
"""

import dataclasses
import math
import random
import time

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.batch import HostBatch
from windflow_tpu_torch.graph.pipegraph import PipeGraph
from windflow_tpu_torch.ops.gpu import MapGPU
from windflow_tpu_torch.ops.map_op import Map
from windflow_tpu_torch.ops.sink import Sink
from windflow_tpu_torch.ops.source import Source
from windflow_tpu_torch.parallel.collectors import (KSlackCollector,
                                                    OrderingCollector)

# one intra-op thread: toy sizes beside other test workers
torch.set_num_threads(1)


def _cfg(**kw):
    return wt.Config(device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_multicast_cow.py
# ---------------------------------------------------------------------------

def test_split_multicast_inplace_isolation():
    n = 200
    mutated, pristine = [], []

    def inplace_bump(t):
        t["v"] += 1000   # in-place variant: returns None
        return None

    g = wt.PipeGraph("cow_split", config=_cfg())
    src = wt.Source_Builder(
        lambda: iter({"i": i, "v": i} for i in range(n))).build()
    mp = g.add_source(src).add(wt.Map(lambda t: dict(t), "prep"))
    mp.split(lambda t: (0, 1), 2)   # every tuple goes to BOTH branches
    mp.select(0).add(wt.Map(inplace_bump, "bump")) \
        .add_sink(wt.Sink_Builder(
            lambda t: mutated.append(t) if t is not None else None).build())
    mp.select(1).add_sink(wt.Sink_Builder(
        lambda t: pristine.append(t) if t is not None else None).build())
    g.run()
    assert sorted(t["v"] for t in mutated) == [i + 1000 for i in range(n)]
    # the sibling branch must see unmutated values
    assert sorted(t["v"] for t in pristine) == list(range(n))


def test_broadcast_inplace_isolation():
    n = 100
    got = []

    def make_bump(delta):
        def bump(t):
            t["v"] += delta
            return None
        return bump

    # BROADCAST into an in-place Map with parallelism 2: both replicas see
    # every tuple; each must mutate a private copy
    g = wt.PipeGraph("cow_bcast", config=_cfg())
    src = wt.Source_Builder(
        lambda: iter({"i": i, "v": i} for i in range(n))) \
        .withOutputBatchSize(16).build()
    bump = wt.Map(make_bump(1000), "bump", parallelism=2,
                  routing=wt.RoutingMode.BROADCAST)
    g.add_source(src).add(bump).add_sink(
        wt.Sink_Builder(
            lambda t: got.append(t) if t is not None else None).build())
    g.run()
    assert len(got) == 2 * n
    assert sorted(t["v"] for t in got) == sorted(
        [i + 1000 for i in range(n)] * 2)


# ---------------------------------------------------------------------------
# tests/test_backpressure.py
# ---------------------------------------------------------------------------

def _run_bounded(cfg, ops, n_items):
    g = PipeGraph("bp", config=cfg)
    src = Source(lambda: iter(range(n_items)))  # tick chunk 256, batches of 1
    mp = g.add_source(src)
    for op in ops:
        mp.add(op)
    got = []
    mp.add_sink(Sink(lambda x: got.append(x) if x is not None else None))
    g.run()
    return g, got


def test_host_inbox_bounded():
    cfg = _cfg(max_inbox_messages=32, sweep_drain_limit=8)
    g, got = _run_bounded(cfg, [Map(lambda x: x + 1)], 5000)
    assert sorted(got) == list(range(1, 5001))
    # one source tick (256 emits) can overshoot the cap before the next
    # sweep's throttle check; the bound is cap + one tick
    assert g._max_inbox_seen <= 32 + 256
    assert g._throttle_events > 0


def test_device_inflight_bounded():
    # the source stages 4 device batches per tick (chunk 256 / capacity
    # 64), the consumer drains at most 1 per sweep: without throttling
    # the in-flight device batches would grow to n/64 = 64
    cfg = _cfg(max_inflight_batches=2, sweep_drain_limit=1,
               source_tick_chunk=256)
    g = PipeGraph("bp_dev", config=cfg)
    n = 4096
    src = Source(lambda: iter(range(n)), output_batch_size=64)
    got = []
    g.add_source(src) \
        .add(MapGPU(lambda x: x * 2)) \
        .add_sink(Sink(lambda x: got.append(x) if x is not None else None))
    g.run()
    assert sorted(got) == [2 * i for i in range(n)]
    # cap + one tick's overshoot (4 staged batches)
    assert g._max_inflight_device_seen <= 2 + 4
    assert g._throttle_events > 0


def test_stats_report_backpressure_reality():
    cfg = _cfg(max_inbox_messages=16, sweep_drain_limit=4)
    g, _ = _run_bounded(cfg, [Map(lambda x: x)], 2000)
    s = g.stats()
    assert "max_inbox_messages=16" in s["Backpressure"]
    assert s["Backpressure_throttle_events"] == g._throttle_events > 0
    assert s["Max_inbox_depth_seen"] == g._max_inbox_seen


# ---------------------------------------------------------------------------
# tests/test_punctuation.py
# ---------------------------------------------------------------------------

def test_tb_window_fires_while_source_idle():
    cfg = _cfg(punctuation_interval_usec=5_000)
    results = []
    state = {"fired_during_idle": False}

    def gen():
        for _ in range(10):
            yield {"key": 0, "value": 1}
        # idle for ~150 ms, several window lengths, yielding None so the
        # scheduler keeps sweeping while no data arrives
        t_end = time.time() + 0.15
        while time.time() < t_end:
            time.sleep(0.005)
            yield None
        # the window holding the first 10 tuples must have fired by now,
        # strictly before EOS flushing could be responsible
        state["fired_during_idle"] = len(results) > 0
        for _ in range(5):
            yield {"key": 0, "value": 1}

    win_op = (wt.Keyed_Windows_Builder(
                lambda items: sum(t["value"] for t in items))
              .withTBWindows(20_000, 20_000)   # 20 ms tumbling
              .withKeyBy(lambda t: t["key"])
              .build())
    src = wt.Source_Builder(gen).build()
    snk = wt.Sink_Builder(
        lambda r: results.append(r) if r is not None else None).build()
    g = wt.PipeGraph("idle_fire", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS, config=cfg)
    g.add_source(src).add(win_op).add_sink(snk)
    g.run()
    assert state["fired_during_idle"], \
        "TB window did not fire during the idle period"
    assert sum(r.value for r in results) == 15


def test_punctuation_amount_triggers_flush():
    # with punctuation_amount=8 and a huge batch size, batches are
    # flushed by the count-cadence punctuation rather than sitting open
    # until EOS
    cfg = _cfg(punctuation_amount=8, punctuation_interval_usec=10**9)
    seen = []

    def gen():
        for i in range(32):
            yield i
        # idle long enough for several sweeps
        for _ in range(3):
            yield None

    src = wt.Source_Builder(gen).withOutputBatchSize(10_000).build()
    snk = wt.Sink_Builder(
        lambda x: seen.append(x) if x is not None else None).build()
    g = wt.PipeGraph("amount", config=cfg)
    g.add_source(src).add(wt.Map(lambda x: x)).add_sink(snk)
    g.start()
    # a few sweeps without letting the stream end: data must already be
    # moving because the count punctuation flushed the open batch
    for _ in range(6):
        g.step()
    assert len(seen) >= 8, "count-cadence punctuation did not flush batches"
    while not g.is_done():
        g.step()
    g._finalize()
    assert sorted(seen) == list(range(32))


# ---------------------------------------------------------------------------
# tests/test_ordering_perf.py (non-slow cases)
# ---------------------------------------------------------------------------

def test_collector_merge_100k_in_order():
    """The JAX file's 100,000-tuple k-way merge over 4 interleaved
    channels, fed 64 at a time: every tuple released once and in
    timestamp order (the JAX test's wall-clock bound is not twinned)."""
    C, N = 4, 100_000
    rnd = random.Random(7)
    streams = [[] for _ in range(C)]
    for ts in range(N):
        streams[rnd.randrange(C)].append(ts)
    col = OrderingCollector(C)
    out = []
    pos = [0] * C
    while any(pos[c] < len(streams[c]) for c in range(C)):
        for c in range(C):
            lo, hi = pos[c], min(pos[c] + 64, len(streams[c]))
            if lo < hi:
                chunk = streams[c][lo:hi]
                out.extend(col.on_message(
                    c, HostBatch(list(chunk), list(chunk), chunk[-1])))
                pos[c] = hi
    for c in range(C):
        out.extend(col.on_channel_eos(c))
    released = [ts for b in out for ts in b.tss]
    assert released == list(range(N))


def test_kslack_release_batches_runs():
    """KSlackCollector ships each release run as ONE HostBatch (not
    per-tuple singletons), preserving release order and the drop count."""
    rnd = random.Random(3)
    col = KSlackCollector(1)
    out = []
    N = 10_000
    # mildly out-of-order stream: ts jittered by up to 8
    stream = [max(0, i + rnd.randint(-8, 8)) for i in range(N)]
    for lo in range(0, N, 64):
        chunk = stream[lo:lo + 64]
        out.extend(col.on_message(
            0, HostBatch(list(chunk), list(chunk), max(chunk))))
    out.extend(col.on_channel_eos(0))
    released = [ts for b in out for ts in b.tss]
    assert released == sorted(released)      # K-slack order
    assert len(released) + col.num_dropped == N
    # batching actually happened: far fewer batches than tuples
    assert len(out) < len(released) / 4, (len(out), len(released))


def test_kslack_release_splits_on_shared_boundary():
    """A release run holding both multicast (shared) and private tuples
    splits on the flag boundary."""
    col = KSlackCollector(1)
    # out-of-order warm-up grows K so tuples buffer across both messages
    out = list(col.on_message(
        0, HostBatch([100, 90], [100, 90], 100)))
    out += col.on_message(0, HostBatch(list(range(0, 8)),
                                       [110 + t for t in range(0, 8)], 117))
    out += col.on_message(0, HostBatch(list(range(8, 12)),
                                       [118 + t - 8 for t in range(8, 12)],
                                       121, shared=True))
    out += col.on_channel_eos(0)
    released = [(b.shared, list(b.items)) for b in out]
    flat = [it for _, its in released for it in its]
    assert flat == [90, 100] + list(range(12))
    for sh, its in released:
        assert all((isinstance(it, int) and 8 <= it < 12) == sh
                   for it in its)


# ---------------------------------------------------------------------------
# tests/test_metamorphic_mixed.py
# ---------------------------------------------------------------------------

MM_KEYS, MM_LENGTH = 4, 600
MM_WIN, MM_SLIDE = 16_000, 8_000  # µs


def _mm_stream():
    return [{"key": i % MM_KEYS, "value": i, "ts": i * 1000}
            for i in range(MM_LENGTH)]


def _mm_oracle():
    per_key = {}
    for t in _mm_stream():
        v = t["value"] * 3
        if v % 5 != 0:
            per_key.setdefault(t["key"], []).append((t["ts"], v))
    count = total = 0
    for items in per_key.values():
        max_ts = max(ts for ts, _ in items)
        w = 0
        while w * MM_SLIDE <= max_ts:
            in_win = [v for ts, v in items
                      if w * MM_SLIDE <= ts < w * MM_SLIDE + MM_WIN]
            if in_win:
                count += 1
                total += sum(in_win)
            w += 1
    return count, total


def _mm_run(rnd):
    acc = {"count": 0, "total": 0}

    def on_result(r):
        if r is not None:
            acc["count"] += 1
            acc["total"] += int(r.value if hasattr(r, "value") else r)

    batch = rnd.choice([16, 32, 64])
    g = wt.PipeGraph("meta_mixed", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=_cfg())
    src = (wt.Source_Builder(lambda: iter(_mm_stream()))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(batch).build())
    prep = (wt.Map_Builder(lambda t: dict(t))
            .withParallelism(rnd.randint(1, 3))
            .withOutputBatchSize(batch).build())
    mp = g.add_source(src).add(prep)
    mp.split(lambda t: t["value"] % 2, 2)
    # branch 0 (even values): device map + filter
    b0 = mp.select(0) \
        .add(wt.MapGPU_Builder(
            lambda t: {"key": t["key"], "value": t["value"] * 3,
                       "ts": t["ts"]})
             .withParallelism(rnd.randint(1, 2)).build()) \
        .add(wt.FilterGPU_Builder(lambda t: (t["value"] % 5) != 0)
             .withParallelism(rnd.randint(1, 2)).build())
    # branch 1 (odd values): the same logic on the host
    b1 = mp.select(1) \
        .add(wt.Map_Builder(
            lambda t: {"key": t["key"], "value": t["value"] * 3,
                       "ts": t["ts"]})
             .withParallelism(rnd.randint(1, 3)).build()) \
        .add(wt.Filter_Builder(lambda t: (t["value"] % 5) != 0)
             .withParallelism(rnd.randint(1, 3)).build())
    merged = b0.merge(b1)
    win = (wt.Keyed_Windows_Builder(
            lambda items: sum(t["value"] for t in items))
           .withTBWindows(MM_WIN, MM_SLIDE)
           .withKeyBy(lambda t: t["key"])
           .withParallelism(rnd.randint(1, 3)).build())
    merged.add(win).add_sink(wt.Sink_Builder(on_result).build())
    g.run()
    return acc["count"], acc["total"]


def test_mixed_dag_metamorphic_sweep():
    rnd = random.Random(42)
    expected = _mm_oracle()
    results = [_mm_run(rnd) for _ in range(5)]
    assert results[0] == expected, (results[0], expected)
    for i, r in enumerate(results[1:], 1):
        assert r == results[0], f"config {i}: {r} != {results[0]}"


# ---------------------------------------------------------------------------
# tests/test_ffat_spec_sweep.py (non-slow cases)
# ---------------------------------------------------------------------------

SW_KEYS, SW_LENGTH = 3, 300


def _sw_stream():
    return [{"key": i % SW_KEYS, "value": i, "ts": i * 1000}
            for i in range(SW_LENGTH)]


def _oracle_cb(win, slide):
    per_key = {}
    for t in _sw_stream():
        per_key.setdefault(t["key"], []).append(t["value"])
    exp = {}
    for k, vals in per_key.items():
        w = 0
        while w * slide < len(vals):
            seg = vals[w * slide: w * slide + win]
            if seg:
                exp[(k, w)] = sum(seg)
            w += 1
    return exp


def _oracle_tb(win_us, slide_us):
    from conftest import tb_window_sums
    per_key = {}
    for t in _sw_stream():
        per_key.setdefault(t["key"], []).append((t["ts"], t["value"]))
    return tb_window_sums(per_key, win_us, slide_us)


def _run_ffat_gpu(win_type, win, slide, batch, comb=None, monoid=None):
    got = {}
    src = (wt.Source_Builder(lambda: iter(_sw_stream()))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(batch).build())
    b = (wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                    comb or (lambda a, b: a + b))
         .withKeyBy(lambda t: t["key"]).withMaxKeys(SW_KEYS))
    if monoid is not None:
        b = b.withMonoidCombiner(monoid)
    if win_type == "cb":
        b = b.withCBWindows(win, slide)
    else:
        b = b.withTBWindows(win * 1000, slide * 1000)
    snk = wt.Sink_Builder(
        lambda r: got.__setitem__((int(r["key"]), int(r["wid"])),
                                  int(r["value"]))
        if r is not None else None).build()
    g = wt.PipeGraph("spec_sweep", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=_cfg())
    g.add_source(src).add(b.build()).add_sink(snk)
    g.run()
    return got


#: the JAX file's tier-1 spec: coprime, P = 1, R = 9, D = 5
SW_SPEC = (9, 5)


def test_cb_spec():
    win, slide = SW_SPEC
    exp = _oracle_cb(win, slide)
    rnd = random.Random(win * 100 + slide)
    for _ in range(2):
        batch = rnd.randint(1, 96)
        got = _run_ffat_gpu("cb", win, slide, batch)
        assert got == exp, (win, slide, batch, len(got), len(exp))


def test_tb_spec():
    win, slide = SW_SPEC
    exp = _oracle_tb(win * 1000, slide * 1000)
    rnd = random.Random(win * 100 + slide + 1)
    for _ in range(2):
        batch = rnd.randint(1, 96)
        got = _run_ffat_gpu("tb", win, slide, batch)
        assert got == exp, (win, slide, batch, len(got), len(exp))


@pytest.mark.parametrize("win_type", ["cb", "tb"])
def test_monoid_max_spec(win_type):
    """Declared max equals the undeclared combiner exactly on the
    coprime pane decomposition."""
    win, slide = SW_SPEC
    rnd = random.Random(win * 10 + slide)
    batch = rnd.randint(1, 96)
    got = _run_ffat_gpu(win_type, win, slide, batch, comb=torch.maximum,
                        monoid="max")
    want = _run_ffat_gpu(win_type, win, slide, batch, comb=torch.maximum)
    assert got == want and len(got) > 0, (win_type, win, slide, batch)


def _host_builder(family, nonin):
    if family == "keyed":
        return wt.Keyed_Windows_Builder(nonin)
    if family == "paned":
        return wt.Paned_Windows_Builder(nonin, lambda panes: sum(panes))
    if family == "mapreduce":
        return wt.MapReduce_Windows_Builder(nonin,
                                            lambda partials: sum(partials))
    if family == "ffat_host":
        return wt.Ffat_Windows_Builder(lambda t: t["value"],
                                       lambda a, b: a + b)
    raise AssertionError(family)


def _host_family_run(family, kind, win, slide):
    nonin = lambda items: sum(t["value"] for t in items)  # noqa: E731
    got = {}
    src = (wt.Source_Builder(lambda: iter(_sw_stream()))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(13).build())
    b = _host_builder(family, nonin)
    b = b.withTBWindows(win * 1000, slide * 1000) if kind == "tb" \
        else b.withCBWindows(win, slide)
    op = b.withKeyBy(lambda t: t["key"]).build()
    snk = wt.Sink_Builder(
        lambda r: got.__setitem__((r.key, r.wid), int(r.value))
        if r is not None else None).build()
    g = wt.PipeGraph(f"host_spec_{kind}", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=_cfg())
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return got


HOST_FAMILIES = ["keyed", "paned", "mapreduce", "ffat_host"]
HOST_SPECS = [(16, 4), (12, 12), (6, 10), (7, 3)]


@pytest.mark.parametrize("family", HOST_FAMILIES)
@pytest.mark.parametrize("win,slide", HOST_SPECS)
def test_host_families_tb_spec(family, win, slide):
    exp = _oracle_tb(win * 1000, slide * 1000)
    got = _host_family_run(family, "tb", win, slide)
    assert got == exp, (family, win, slide, len(got), len(exp))


@pytest.mark.parametrize("family", HOST_FAMILIES)
@pytest.mark.parametrize("win,slide", HOST_SPECS)
def test_host_families_cb_spec(family, win, slide):
    exp = _oracle_cb(win, slide)
    got = _host_family_run(family, "cb", win, slide)
    assert got == exp, (family, win, slide, len(got), len(exp))
