"""Keyed routing, broadcast, split/merge and the host operators of the port
against the JAX package, on the CPU.

* Placement: the port's three splitmix64 versions (Python int, numpy
  column, torch int64 lane) and the JAX package's ``_splitmix64_dev``
  give the same ``hash mod n`` at the int32 extremes, at -1 and 0 and on
  random keys, for n in {2, 3, 4, 7}.
* The families of tests/test_graph_basic.py, tests/test_merge_split.py
  and tests/test_device_split.py run through both packages'
  ``PipeGraph.run()`` on the same records (the port's graphs with
  ``Config(device="cpu")``); each result equals the other package's and
  the oracle.  Sizes are cut to a few hundred tuples.
* Keyed ReduceGPU and CB/TB ``Ffat_WindowsGPU`` at parallelism 2-4, the
  two merged-source TB cells of tests/test_windows.py (:749, :792, the
  first cut in depth) and the shared-buffer hazard of the mask-only
  fan-outs.

Tolerance: every family is integer-valued, so records are equal.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from conftest import tb_window_sums
from windflow_tpu.parallel.emitters import _splitmix64_dev
from windflow_tpu_torch.parallel import emitters as te

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

PKGS = [wf, wt]


def _graph(pkg, name, mode="DEFAULT", tp="INGRESS", **cfg):
    """A PipeGraph of either package; the port's runs on the CPU."""
    if pkg is wt:
        config = wt.Config(device="cpu", **cfg)
    else:
        config = dataclasses.replace(wf.basic.default_config, **cfg)
    return pkg.PipeGraph(name, getattr(pkg.ExecutionMode, mode),
                         getattr(pkg.TimePolicy, tp), config=config)


def _dev(pkg, kind):
    """The device builder of either package: ``MapTPU_Builder`` /
    ``MapGPU_Builder`` and so on."""
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _placement_keys():
    rng = np.random.default_rng(7)
    edges = np.array([-2 ** 31, -2 ** 31 + 1, -2, -1, 0, 1, 2,
                      2 ** 31 - 2, 2 ** 31 - 1], np.int64)
    rand = rng.integers(-2 ** 31, 2 ** 31, 4000)
    return np.concatenate([edges, rand]).astype(np.int32)


@pytest.mark.parametrize("n", [2, 3, 4, 7])
def test_splitmix64_placement_agrees_across_host_numpy_torch_and_jax(n):
    keys = _placement_keys()
    host = np.array([te.splitmix64_int(int(k)) % n for k in keys])
    col = (te.splitmix64_np(keys) % np.uint64(n)).astype(np.int64)
    dev = te.place_torch(torch.from_numpy(keys), n).numpy()
    jx = np.asarray(_splitmix64_dev(jnp.asarray(keys)) % jnp.uint64(n))
    assert np.array_equal(host, col)
    assert np.array_equal(host, dev)
    assert np.array_equal(host, jx.astype(np.int64))
    # the hash itself, bit for bit
    assert np.array_equal(
        te.splitmix64_torch(torch.from_numpy(keys)).numpy().view(np.uint64),
        te.splitmix64_np(keys))


def test_int32_key_and_stable_hash_match_the_jax_package():
    for k in (0, -1, 2 ** 31, 2 ** 31 - 1, -2 ** 31 - 1, 2 ** 40 + 5, 7):
        assert wt.basic.int32_key(k) == wf.basic.int32_key(k)
    for k in (3, -9, "abc", b"xyz", (1, 2)):
        assert wt.stable_hash(k) == wf.basic.stable_hash(k)


# ---------------------------------------------------------------------------
# tests/test_graph_basic.py
# ---------------------------------------------------------------------------

def make_stream(n_keys, length):
    return [{"key": i % n_keys, "value": i} for i in range(length)]


class Acc:
    def __init__(self):
        self.total = 0
        self.count = 0
        self.eos = 0

    def __call__(self, item, ctx=None):
        if item is None:
            self.eos += 1
        else:
            self.total += int(item["value"])
            self.count += 1

    @property
    def pair(self):
        return (self.total, self.count)


def run_linear(pkg, mode, length, n_keys, par, batch):
    acc = Acc()
    src = (pkg.Source_Builder(lambda: iter(make_stream(n_keys, length)))
           .withName("src").withOutputBatchSize(batch).build())
    mp = (pkg.Map_Builder(lambda t: {"key": t["key"],
                                     "value": t["value"] * 2})
          .withName("map").withParallelism(par[0])
          .withOutputBatchSize(batch).build())
    flt = (pkg.Filter_Builder(lambda t: t["value"] % 4 == 0)
           .withName("filter").withParallelism(par[1])
           .withOutputBatchSize(batch).build())
    snk = pkg.Sink_Builder(acc).withName("sink") \
        .withParallelism(par[2]).build()
    g = _graph(pkg, "linear", mode)
    g.add_source(src).add(mp).add(flt).add_sink(snk)
    g.run()
    return acc


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_linear_metamorphic(mode):
    rnd = random.Random(42)
    length, n_keys = 400, 7
    expected = sum(v * 2 for v in range(length) if (v * 2) % 4 == 0)
    for run in range(4):
        par = [rnd.randint(1, 5) for _ in range(3)]
        batch = rnd.randint(1, 10)
        got = []
        for pkg in PKGS:
            acc = run_linear(pkg, mode, length, n_keys, par, batch)
            assert acc.eos == par[2]    # one EOS callback a sink replica
            got.append(acc.pair)
        assert got[0] == got[1] == (expected, length // 2), (run, par)


def test_flatmap_keyby_reduce():
    """Source → FlatMap → keyed Reduce → Sink over parallelism 1-4."""
    length, n_keys = 300, 5
    expected = {}
    for t in make_stream(n_keys, length):
        expected[t["key"]] = expected.get(t["key"], 0) + 2 * t["value"]
    rnd = random.Random(7)
    for run in range(3):
        par = rnd.randint(1, 4)
        batch = rnd.randint(1, 8)
        for pkg in PKGS:
            last = {}
            src = (pkg.Source_Builder(
                lambda: iter(make_stream(n_keys, length)))
                .withOutputBatchSize(batch).build())
            fm = (pkg.FlatMap_Builder(
                lambda t, shipper: [shipper.push(t), shipper.push(t)][0])
                .withParallelism(par).withOutputBatchSize(batch).build())
            red = (pkg.Reduce_Builder(
                lambda t, s: {"key": t["key"],
                              "value": s["value"] + t["value"]},
                {"key": -1, "value": 0})
                .withKeyBy(lambda t: t["key"])
                .withParallelism(par).withOutputBatchSize(batch).build())
            snk = pkg.Sink_Builder(
                lambda r, _l=last: _l.__setitem__(r["key"], r["value"])
                if r is not None else None).build()
            g = _graph(pkg, "fm_red")
            g.add_source(src).add(fm).add(red).add_sink(snk)
            g.run()
            assert last == expected, (pkg.__name__, run, par)


def test_keyed_host_reduce_sees_each_key_on_one_replica():
    seen = {}

    def spy(t, s, ctx):
        seen.setdefault(t["key"], set()).add(ctx.replica_index)
        return {"key": t["key"], "value": s["value"] + t["value"]}

    src = (wt.Source_Builder(lambda: iter(make_stream(11, 220)))
           .withOutputBatchSize(4).build())
    red = (wt.Reduce_Builder(spy, {"key": -1, "value": 0})
           .withKeyBy(lambda t: t["key"]).withParallelism(3).build())
    g = _graph(wt, "one_replica")
    g.add_source(src).add(red).add_sink(wt.Sink_Builder(lambda r: None)
                                        .build())
    g.run()
    assert all(len(r) == 1 for r in seen.values())
    # the host KEYBY placement is stable_hash(key) % n
    assert all(r == {k % 3} for k, r in seen.items())


def test_probabilistic_drops_counted():
    """Out-of-order EVENT-time stream through K-slack: survivors and
    drops add up to the input, with the same split in both packages."""
    length = 300
    rnd = random.Random(3)
    items = [{"key": 0, "value": i,
              "ts": (i + rnd.randint(-40, 40)) * 1000}
             for i in range(length)]
    res = []
    for pkg in PKGS:
        got = []
        src = (pkg.Source_Builder(lambda: iter(items))
               .withTimestampExtractor(lambda t: max(0, t["ts"]))
               .withOutputBatchSize(4).build())
        mp = (pkg.Map_Builder(lambda t: t).withParallelism(2)
              .withOutputBatchSize(4).build())
        snk = pkg.Sink_Builder(
            lambda t: got.append(t["value"]) if t is not None else None) \
            .build()
        g = _graph(pkg, "kslack", "PROBABILISTIC", "EVENT")
        g.add_source(src).add(mp).add_sink(snk)
        g.run()
        assert len(got) + g.getNumDroppedTuples() == length
        assert len(got) > 0
        res.append(sorted(got))
    assert res[0] == res[1]


def test_rebalancing_after_keyby():
    length = 200
    for pkg in PKGS:
        seen = set()

        def spy(t, ctx, _s=seen):
            _s.add(ctx.replica_index)
            return t

        src = (pkg.Source_Builder(
            lambda: iter({"key": 0, "value": i} for i in range(length)))
            .withName("src").build())
        red = (pkg.Reduce_Builder(
            lambda t, s: {**t, "n": s.get("n", 0) + 1}, dict)
            .withKeyBy(lambda t: t["key"]).withParallelism(3).build())
        reb = (pkg.Map_Builder(spy).withName("rebalanced")
               .withParallelism(4).withRebalancing().build())
        acc = Acc()
        g = _graph(pkg, "rebalance")
        g.add_source(src).add(red).add(reb).add_sink(
            pkg.Sink_Builder(acc).build())
        g.run()
        assert acc.count == length
        assert seen == {0, 1, 2, 3}


def test_routing_clauses_conflict():
    with pytest.raises(wt.WindFlowError):
        (wt.Map_Builder(lambda t: t).withKeyBy(lambda t: t)
         .withRebalancing()._routing())
    with pytest.raises(wt.WindFlowError):
        (wt.Map_Builder(lambda t: t).withKeyBy(lambda t: 0)
         .withBroadcast()._routing())
    with pytest.raises(wt.WindFlowError):
        (wt.Filter_Builder(lambda t: t).withRebalancing()
         .withBroadcast()._routing())
    with pytest.raises(wt.WindFlowError):
        wt.Reduce_Builder(lambda t, s: s, 0).withRebalancing()
    with pytest.raises(wt.WindFlowError, match="non-keyed"):
        wt.Reduce_Builder(lambda t, s: s, 0).withParallelism(2).build()


def test_broadcast_routing():
    length = 60
    for pkg in PKGS:
        per_replica = {}

        def spy(t, ctx, _p=per_replica):
            _p.setdefault(ctx.replica_index, []).append(t["value"])
            return t

        acc = Acc()
        src = (pkg.Source_Builder(
            lambda: iter({"value": i} for i in range(length)))
            .withOutputBatchSize(8).build())
        bmap = pkg.Map_Builder(spy).withParallelism(3).withBroadcast() \
            .build()
        g = _graph(pkg, "bcast")
        g.add_source(src).add(bmap).add_sink(pkg.Sink_Builder(acc).build())
        g.run()
        assert set(per_replica) == {0, 1, 2}
        for vals in per_replica.values():
            assert sorted(vals) == list(range(length))
        assert acc.count == 3 * length


def test_broadcast_copies_before_an_in_place_map():
    """A broadcast batch is shared by the replicas: an in-place map
    mutates a private copy (copy on write), so every replica adds its
    bump to the ORIGINAL value once."""
    got = []

    def bump(t):
        t["value"] += 100
        return None

    src = (wt.Source_Builder(lambda: iter({"value": i} for i in range(20)))
           .withOutputBatchSize(4).build())
    g = _graph(wt, "bcast_cow")
    g.add_source(src).add(wt.Map_Builder(bump).withParallelism(2)
                          .withBroadcast().build()) \
        .add_sink(wt.Sink_Builder(lambda t: got.append(t["value"])
                                  if t is not None else None).build())
    g.run()
    assert sorted(got) == sorted([i + 100 for i in range(20)] * 2)


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_closing_function_runs_once_per_replica(pkg):
    closed = []
    acc = Acc()
    src = (pkg.Source_Builder(lambda: iter({"value": i} for i in range(50)))
           .withOutputBatchSize(8).build())
    m = (pkg.Map_Builder(lambda t: t).withParallelism(3)
         .withClosingFunction(lambda ctx: closed.append(
             (ctx.operator_name, ctx.replica_index))).build())
    snk = (pkg.Sink_Builder(acc)
           .withClosingFunction(lambda: closed.append(("sink", 0))).build())
    g = _graph(pkg, "closing")
    g.add_source(src).add(m).add_sink(snk)
    g.run()
    assert sorted(c for c in closed if c[0] != "sink") == \
        [("map", 0), ("map", 1), ("map", 2)]
    assert ("sink", 0) in closed
    assert acc.count == 50


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_closing_function_on_chained_host_stages(pkg):
    closed = []
    acc = Acc()
    src = (pkg.Source_Builder(lambda: iter({"value": i} for i in range(20)))
           .withOutputBatchSize(4).build())
    m1 = (pkg.Map_Builder(lambda t: {"value": t["value"] + 1})
          .withClosingFunction(lambda: closed.append("m1")).build())
    m2 = (pkg.Map_Builder(lambda t: {"value": t["value"] * 2})
          .withClosingFunction(lambda: closed.append("m2")).build())
    g = _graph(pkg, "closing_chain")
    mp = g.add_source(src)
    mp.add(m1)
    mp.chain(m2)
    mp.add_sink(pkg.Sink_Builder(acc).build())
    g.run()
    assert closed == ["m1", "m2"]
    assert acc.total == sum((i + 1) * 2 for i in range(20))
    assert [type(op).__name__ for op in mp.operators] == \
        ["Source", "ChainedHost", "Sink"]


def test_start_wait_end_idiom():
    acc = Acc()
    src = (wt.Source_Builder(lambda: iter({"value": i} for i in range(40)))
           .withOutputBatchSize(8).build())
    g = _graph(wt, "startwait")
    g.add_source(src).add_sink(wt.Sink_Builder(acc).build())
    g.start()
    g.wait_end()
    assert acc.count == 40
    assert g.getNumDroppedTuples() == 0
    with pytest.raises(wt.WindFlowError):
        _graph(wt, "nostart").wait_end()


def _capmix_graph(pkg, op, caps=(31, 4), event=False):
    """Two merged sources of unequal batch sizes relayed through a
    capacity-preserving device map into ``op``."""
    def src(k, cap):
        b = pkg.Source_Builder(lambda: iter({"k": k, "v": float(i),
                                             "ts": i * 1000}
                                            for i in range(64)))
        if event:
            b = b.withTimestampExtractor(lambda t: t["ts"])
        return b.withOutputBatchSize(cap).build()
    g = _graph(pkg, "capmix", tp="EVENT" if event else "INGRESS")
    merged = g.add_source(src(0, caps[0])).merge(g.add_source(src(1,
                                                                  caps[1])))
    merged.add(_dev(pkg, "Map")(lambda t: dict(t)).build())
    merged.add(op)
    merged.add_sink(pkg.Sink_Builder(lambda r: None).build())
    return g


def test_merge_capacity_mismatch_into_ffat_raises_at_build():
    op = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
          .withTBWindows(16_000, 4_000).withKeyBy(lambda t: t["k"])
          .withMaxKeys(2).build())
    with pytest.raises(wt.WindFlowError,
                       match=r"FfatWindowsGPU.*fixed batch capacity"
                             r".*\[4, 31\]"):
        _capmix_graph(wt, op, event=True).run()


def test_merge_capacity_mismatch_into_dense_reduce_raises():
    op = (wt.ReduceGPU_Builder(lambda a, b: {"k": a["k"],
                                             "v": a["v"] + b["v"]})
          .withKeyBy(lambda t: t["k"]).withMaxKeys(2).build())
    with pytest.raises(wt.WindFlowError,
                       match=r"ReduceGPU\[withMaxKeys\].*\[4, 31\]"):
        _capmix_graph(wt, op).run()


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_merge_equal_capacity_into_dense_reduce_ok(pkg):
    got = []
    op = (_dev(pkg, "Reduce")(lambda a, b: {"k": a["k"],
                                            "v": a["v"] + b["v"]})
          .withKeyBy(lambda t: t["k"]).withMaxKeys(2).build())
    g = _graph(pkg, "capok")

    def src(k):
        return (pkg.Source_Builder(lambda: iter({"k": k, "v": float(i)}
                                                for i in range(64)))
                .withOutputBatchSize(16).build())
    merged = g.add_source(src(0)).merge(g.add_source(src(1)))
    merged.add(op)
    merged.add_sink(pkg.Sink_Builder(
        lambda r: got.append((int(r["k"]), float(r["v"])))
        if r is not None else None).build())
    g.run()
    per_key = {}
    for k, v in got:
        per_key[k] = per_key.get(k, 0.0) + v
    assert per_key == {0: float(sum(range(64))), 1: float(sum(range(64)))}


# ---------------------------------------------------------------------------
# tests/test_merge_split.py
# ---------------------------------------------------------------------------

def run_split(pkg, mode, length, n_keys, par, batch):
    a0, a1 = Acc(), Acc()
    src = (pkg.Source_Builder(lambda: iter(make_stream(n_keys, length)))
           .withOutputBatchSize(batch).build())
    pre = (pkg.Map_Builder(lambda t: dict(t))
           .withParallelism(par[0]).withOutputBatchSize(batch).build())
    g = _graph(pkg, "split", mode)
    mp = g.add_source(src).add(pre)
    mp.split(lambda t: t["key"] % 2, 2)
    (mp.select(0)
       .add(pkg.Filter_Builder(lambda t: t["value"] % 3 == 0)
            .withParallelism(par[1]).withOutputBatchSize(batch).build())
       .add_sink(pkg.Sink_Builder(a0).withParallelism(par[2]).build()))
    (mp.select(1)
       .add(pkg.Map_Builder(lambda t: {"key": t["key"],
                                       "value": t["value"] + 100})
            .withParallelism(par[3]).withOutputBatchSize(batch).build())
       .add_sink(pkg.Sink_Builder(a1).withParallelism(par[4]).build()))
    g.run()
    return a0.pair, a1.pair


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_split_metamorphic(mode):
    rnd = random.Random(11)
    length, n_keys = 360, 6
    ev = [t for t in make_stream(n_keys, length) if t["key"] % 2 == 0]
    od = [t for t in make_stream(n_keys, length) if t["key"] % 2 == 1]
    exp0 = sum(t["value"] for t in ev if t["value"] % 3 == 0)
    exp1 = sum(t["value"] + 100 for t in od)
    for run in range(3):
        par = [rnd.randint(1, 4) for _ in range(5)]
        batch = rnd.randint(1, 9)
        got = [run_split(pkg, mode, length, n_keys, par, batch)
               for pkg in PKGS]
        assert got[0] == got[1], (run, par)
        assert got[1][0][0] == exp0 and got[1][1][0] == exp1


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_split_multicast(pkg):
    length = 150
    a0, a1 = Acc(), Acc()
    src = (pkg.Source_Builder(lambda: iter(make_stream(3, length)))
           .withOutputBatchSize(5).build())
    pre = pkg.Map_Builder(lambda t: dict(t)).withOutputBatchSize(5).build()
    g = _graph(pkg, "split_mc")
    mp = g.add_source(src).add(pre)
    mp.split(lambda t: (0, 1) if t["key"] == 0 else (t["key"] % 2,), 2)
    mp.select(0).add_sink(pkg.Sink_Builder(a0).build())
    mp.select(1).add_sink(pkg.Sink_Builder(a1).build())
    g.run()
    st = make_stream(3, length)
    assert a0.total == sum(t["value"] for t in st if t["key"] in (0, 2))
    assert a1.total == sum(t["value"] for t in st if t["key"] in (0, 1))


def run_merge(pkg, mode, length, par, batch):
    acc = Acc()
    g = _graph(pkg, "merge", mode)
    s1 = (pkg.Source_Builder(lambda: iter(make_stream(4, length)))
          .withOutputBatchSize(batch).build())
    s2 = (pkg.Source_Builder(
        lambda: iter([{"key": 9, "value": 1000 + i}
                      for i in range(length // 2)]))
        .withOutputBatchSize(batch).build())
    p1 = g.add_source(s1).add(
        pkg.Map_Builder(lambda t: {"key": t["key"], "value": t["value"] * 2})
        .withParallelism(par[0]).withOutputBatchSize(batch).build())
    p2 = g.add_source(s2).add(
        pkg.Filter_Builder(lambda t: t["value"] % 2 == 0)
        .withParallelism(par[1]).withOutputBatchSize(batch).build())
    merged = p1.merge(p2)
    merged.add(
        pkg.Map_Builder(lambda t: {"key": t["key"], "value": t["value"] + 1})
        .withParallelism(par[2]).withOutputBatchSize(batch).build())
    merged.add_sink(pkg.Sink_Builder(acc).withParallelism(par[3]).build())
    g.run()
    return acc.pair


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_merge_metamorphic(mode):
    rnd = random.Random(5)
    length = 300
    exp = sum(2 * t["value"] + 1 for t in make_stream(4, length))
    exp += sum(v + 1 for v in range(1000, 1000 + length // 2) if v % 2 == 0)
    for run in range(3):
        par = [rnd.randint(1, 4) for _ in range(4)]
        batch = rnd.randint(1, 8)
        got = [run_merge(pkg, mode, length, par, batch) for pkg in PKGS]
        assert got[0] == got[1], (run, par)
        assert got[1][0] == exp


def test_deterministic_merge_releases_in_timestamp_order():
    """DETERMINISTIC mode: the merged stream reaches the sink in
    (timestamp, origin id) order, as in the JAX package."""
    res = []
    for pkg in PKGS:
        seen = []
        g = _graph(pkg, "det_order", "DETERMINISTIC", "EVENT")
        s1 = (pkg.Source_Builder(lambda: iter({"value": i, "ts": 2 * i}
                                              for i in range(60)))
              .withTimestampExtractor(lambda t: t["ts"])
              .withOutputBatchSize(3).build())
        s2 = (pkg.Source_Builder(lambda: iter({"value": 1000 + i,
                                               "ts": 3 * i}
                                              for i in range(40)))
              .withTimestampExtractor(lambda t: t["ts"])
              .withOutputBatchSize(5).build())
        merged = g.add_source(s1).merge(g.add_source(s2))
        merged.add(pkg.Map_Builder(lambda t: t).withParallelism(2)
                   .withOutputBatchSize(4).build())
        merged.add_sink(pkg.Sink_Builder(
            lambda t, ctx: seen.append((ctx.get_current_timestamp(),
                                        t["value"]))
            if t is not None else None).build())
        g.run()
        assert [s[0] for s in seen] == sorted(s[0] for s in seen)
        res.append(seen)
    assert res[0] == res[1]


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_split_with_gpu_branch(pkg):
    length = 200
    a0, a1 = Acc(), Acc()
    src = (pkg.Source_Builder(lambda: iter(make_stream(4, length)))
           .withOutputBatchSize(16).build())
    pre = pkg.Map_Builder(lambda t: dict(t)).withOutputBatchSize(16).build()
    g = _graph(pkg, "split_gpu")
    mp = g.add_source(src).add(pre)
    mp.split(lambda t: 0 if t["key"] < 2 else 1, 2)
    (mp.select(0)
       .add(_dev(pkg, "Map")(
            lambda t: {"key": t["key"], "value": t["value"] * 3}).build())
       .add_sink(pkg.Sink_Builder(a0).build()))
    (mp.select(1)
       .add(pkg.Map_Builder(lambda t: {"key": t["key"],
                                       "value": t["value"] * 5})
            .withOutputBatchSize(8).build())
       .add_sink(pkg.Sink_Builder(a1).build()))
    g.run()
    st = make_stream(4, length)
    assert a0.total == sum(3 * t["value"] for t in st if t["key"] < 2)
    assert a1.total == sum(5 * t["value"] for t in st if t["key"] >= 2)


@pytest.mark.parametrize("par", [1, 4])
def test_merge_into_gpu_keyed_reduce(par):
    """Merged pipes into a keyed device reduce (merge_tests_gpu's shape):
    per-key sums equal the host oracle and the JAX package's."""
    length = 240
    exp = {}
    for t in make_stream(4, length) * 2:
        exp[t["key"]] = exp.get(t["key"], 0) + t["value"]
    for pkg in PKGS:
        sums = {}

        def sink_fn(t, _s=sums):
            if t is not None:
                _s[int(t["key"])] = _s.get(int(t["key"]), 0) \
                    + int(t["value"])

        g = _graph(pkg, "merge_gpu")
        ps = []
        for _ in range(2):
            ps.append(g.add_source(
                pkg.Source_Builder(lambda: iter(make_stream(4, length)))
                .withOutputBatchSize(16).build()).add(
                pkg.Map_Builder(lambda t: dict(t))
                .withOutputBatchSize(16).build()))
        merged = ps[0].merge(ps[1])
        merged.add(_dev(pkg, "Reduce")(
            lambda a, b: {"key": a["key"], "value": a["value"] + b["value"]})
            .withKeyBy(lambda t: t["key"]).withParallelism(par).build())
        merged.add_sink(pkg.Sink_Builder(sink_fn).build())
        g.run()
        assert sums == exp, pkg.__name__


# ---------------------------------------------------------------------------
# tests/test_device_split.py
# ---------------------------------------------------------------------------

N_SPLIT = 256


def _split_graph(pkg, split_fn):
    evens, odds = [], []
    g = _graph(pkg, "dev_split")
    src = (pkg.Source_Builder(lambda: iter({"v": i} for i in range(N_SPLIT)))
           .withOutputBatchSize(64).build())
    mp = g.add_source(src).add(
        _dev(pkg, "Map")(lambda t: {"v": t["v"] * 2}).build())
    mp.split(split_fn, 2)
    mp.select(0).add_sink(pkg.Sink_Builder(
        lambda t: evens.append(int(t["v"])) if t is not None else None)
        .build())
    mp.select(1).add_sink(pkg.Sink_Builder(
        lambda t: odds.append(int(t["v"])) if t is not None else None)
        .build())
    g.run()
    split_em = [rep.emitter for op in g._operators for rep in op.replicas
                if type(rep.emitter).__name__ == "SplittingEmitter"]
    return sorted(evens), sorted(odds), split_em[0]


def test_device_native_split():
    res = [_split_graph(pkg, lambda t: (t["v"] // 2) % 2)[:2]
           for pkg in PKGS]
    evens, odds, em = _split_graph(wt, lambda t: (t["v"] // 2) % 2)
    assert res[0] == res[1] == (evens, odds)
    assert evens == [2 * i for i in range(N_SPLIT) if i % 2 == 0]
    assert odds == [2 * i for i in range(N_SPLIT) if i % 2 == 1]
    # the mask split ran, not the host route
    assert list(em._device_split.values()) == [True]


def test_python_split_falls_back_to_host():
    def split(t):   # data-dependent Python control flow
        if t["v"] % 4 == 0:
            return 0
        return 1

    evens, odds, em = _split_graph(wt, split)
    assert (evens, odds) == _split_graph(wf, split)[:2]
    assert evens == [2 * i for i in range(N_SPLIT) if (2 * i) % 4 == 0]
    assert odds == [2 * i for i in range(N_SPLIT) if (2 * i) % 4 != 0]
    assert list(em._device_split.values()) == [False]


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_multicast_split_falls_back_and_isolates(pkg):
    seen0, seen1 = [], []
    g = _graph(pkg, "dev_split_multi")
    src = (pkg.Source_Builder(lambda: iter({"v": i} for i in range(128)))
           .withOutputBatchSize(32).build())
    mp = g.add_source(src).add(_dev(pkg, "Map")(lambda t: {"v": t["v"]})
                               .build())
    mp.split(lambda t: (0, 1), 2)

    def bump(t):
        t["v"] += 1000
        return None

    mp.select(0).add(pkg.Map(bump)).add_sink(pkg.Sink_Builder(
        lambda t: seen0.append(int(t["v"])) if t is not None else None)
        .build())
    mp.select(1).add_sink(pkg.Sink_Builder(
        lambda t: seen1.append(int(t["v"])) if t is not None else None)
        .build())
    g.run()
    assert sorted(seen0) == [i + 1000 for i in range(128)]
    assert sorted(seen1) == list(range(128))


def _lazy_guard_graph(pkg, split):
    seen = []
    g = _graph(pkg, "lazy_split_guard")
    src = (pkg.Source_Builder(lambda: iter({"v": i} for i in range(128)))
           .withOutputBatchSize(32).build())
    mp = g.add_source(src).add(_dev(pkg, "Map")(lambda t: {"v": t["v"]})
                               .build())
    mp.split(split, 2)
    mp.select(0).add_sink(pkg.Sink_Builder(
        lambda t: seen.append(int(t["v"])) if t is not None else None)
        .build())
    mp.select(1).add(_dev(pkg, "Map")(lambda t: {"v": t["v"] * 2})
                     .build()) \
        .add_sink(pkg.Sink_Builder(lambda t: None).build())
    return g, seen


@pytest.mark.parametrize("pkg", PKGS, ids=["jax", "torch"])
def test_python_split_to_host_branches_ok_with_gpu_branch_elsewhere(pkg):
    def split(t):   # Python control flow; always branch 0
        if t["v"] >= 0:
            return 0
        return 1

    g, seen = _lazy_guard_graph(pkg, split)
    g.run()
    assert sorted(seen) == list(range(128))


def test_python_split_routing_to_gpu_branch_raises():
    def split(t):
        if t["v"] % 2 == 0:
            return 0
        return 1

    g, _ = _lazy_guard_graph(wt, split)
    with pytest.raises(wt.WindFlowError, match="split function must"):
        g.run()


# ---------------------------------------------------------------------------
# keyed device operators at parallelism > 1
# ---------------------------------------------------------------------------

CAP, NK = 64, 11


def _keyed_records(n, seed=3):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, NK, n).astype(np.int32)
    vals = rng.integers(-50, 51, n).astype(np.float32)
    return [{"key": k, "v": v, "ts": np.int64(i * 250)}
            for i, (k, v) in enumerate(zip(keys, vals))]


def _keyed_device_run(pkg, kind, par, items, fuse=True):
    out = []
    event = kind == "tb"
    src = pkg.Source_Builder(lambda: iter(items)).withOutputBatchSize(CAP)
    if event:
        src = src.withTimestampExtractor(lambda t: t["ts"])
    g = _graph(pkg, f"keyed_{kind}", tp="EVENT" if event else "INGRESS",
               whole_chain_fusion=fuse)
    p = g.add_source(src.build())
    p.add(_dev(pkg, "Map")(lambda t: {"key": t["key"], "v": t["v"] + 1.0})
          .build())
    if kind == "reduce":
        p.add(_dev(pkg, "Reduce")(
            lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
            .withKeyBy(lambda t: t["key"]).withParallelism(par).build())

        def rec(r):
            return (int(r["key"]), float(r["v"]))
    elif kind == "reduce_compacted":
        p.add(_dev(pkg, "Reduce")(
            lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
            .withKeyBy(lambda t: t["key"]).withMaxKeys(8)
            .withMonoidCombiner("sum").withParallelism(par).build())

        def rec(r):
            return (0, float(r["v"]))
    else:
        wb = (_dev(pkg, "Ffat_Windows")(lambda t: t["v"], lambda a, b: a + b)
              .withKeyBy(lambda t: t["key"]).withMaxKeys(NK)
              .withParallelism(par))
        wb = wb.withCBWindows(8, 4) if kind == "cb" \
            else wb.withTBWindows(4_000, 1_000)
        p.add(wb.build())

        def rec(r):
            return (int(r["key"]), int(r["wid"]), float(r["value"]))
    p.add_sink(pkg.Sink_Builder(
        lambda r: out.append(rec(r)) if r is not None else None).build())
    g.run()
    return sorted(out), g


@pytest.mark.parametrize("kind,par", [("reduce", 2), ("reduce", 4),
                                      ("cb", 2), ("cb", 3), ("tb", 2),
                                      ("tb", 4)])
def test_keyed_gpu_operators_at_parallelism_match_the_jax_package(kind,
                                                                  par):
    items = _keyed_records(CAP * 5)
    got, g = _keyed_device_run(wt, kind, par, items)
    want, _ = _keyed_device_run(wf, kind, par, items)
    assert got == want and len(got) > 0
    op = g._operators[-2]
    # every replica received batches (one mask a replica a batch)
    assert all(r.stats.device_programs_launched > 0 for r in op.replicas)
    if kind != "cb":
        # keyed results equal the single-replica run's
        assert got == _keyed_device_run(wt, kind, 1, items)[0]


def test_bounded_compacted_reduce_counters_sum_over_replicas():
    """The compacted route's counters are per operator: at parallelism 2
    they count every replica's steps, as the JAX package's do."""
    items = _keyed_records(CAP * 4, seed=9)
    got, g = _keyed_device_run(wt, "reduce_compacted", 2, items)
    want, gj = _keyed_device_run(wf, "reduce_compacted", 2, items)
    assert sorted(v for _, v in got) == sorted(v for _, v in want)
    kc = [o for o in g.stats()["Operators"] if "Key_compaction" in o][0]
    kj = [o for o in gj.stats()["Operators"] if "Key_compaction" in o][0]
    kc, kj = kc["Key_compaction"], kj["Key_compaction"]
    for k in ("batches", "overflow_tuples", "big_fallbacks"):
        assert kc[k] == kj[k], k
    assert kc["hits"] == kj["tuples"] - kj["overflow_tuples"]
    assert kc["batches"] == 8 and kc["overflow_tuples"] > 0


def test_device_keyby_emitter_masks_partition_the_valid_lanes():
    keys = torch.tensor([5, -7, 2 ** 31 - 1, 0, 9, 3], dtype=torch.int32)
    valid = torch.tensor([True, True, True, False, True, True])
    from windflow_tpu_torch.batch import DeviceBatch
    b = DeviceBatch({"key": keys}, torch.zeros(6, dtype=torch.int64), valid,
                    size=None)
    em = te.DeviceKeyByEmitter([(None, 0)] * 3, lambda t: t["key"])
    ks, masks = em.split(b)
    total = torch.stack(masks).to(torch.int32).sum(0)
    assert torch.equal(total, valid.to(torch.int32))
    for d, m in enumerate(masks):
        for i in torch.nonzero(m).flatten().tolist():
            assert te.splitmix64_int(int(keys[i])) % 3 == d


def test_keyed_staging_emit_columns_partitions_by_the_numpy_hash():
    """Host→device KEYBY, columnar: each destination's staged batches hold
    exactly its keys, the packed route stages them, and the records of a
    FrameSource → keyed ReduceGPU graph equal the per-record path's."""
    from windflow_tpu_torch.batch import device_to_columns
    rng = np.random.default_rng(4)
    n = 300
    cols = {"key": rng.integers(-1000, 1000, n).astype(np.int32),
            "v": rng.integers(0, 9, n).astype(np.float32)}
    tss = np.arange(n, dtype=np.int64)

    class Rec:
        def __init__(self):
            self.got = []

        def receive(self, ch, msg):
            self.got.append(msg)

    dests = [(Rec(), 0) for _ in range(3)]
    em = te.KeyedDeviceStageEmitter(dests, 128, lambda t: t["key"],
                                    torch.device("cpu"))
    em.emit_columns(cols, tss, int(tss[-1]), row_wms=tss)
    em.flush(int(tss[-1]))
    assert em.packed_batches >= 3 and em.record_batches == 0
    seen = 0
    for d, (r, _) in enumerate(dests):
        for msg in r.got:
            if not hasattr(msg, "payload"):
                continue
            c, _ = device_to_columns(msg)
            seen += len(c["key"])
            assert all(te.splitmix64_int(int(k)) % 3 == d for k in c["key"])
    assert seen == n


# ---------------------------------------------------------------------------
# the merged-source TB cells (tests/test_windows.py:749, :792)
# ---------------------------------------------------------------------------

def _merged_tb(pkg, a, b):
    got = {}
    g = _graph(pkg, "merged_tb", tp="EVENT")
    mps = [g.add_source(pkg.Source_Builder(lambda _x=x: iter(_x))
                        .withTimestampExtractor(lambda t: t["ts"])
                        .withOutputBatchSize(16).build()) for x in (a, b)]
    mp = mps[0].merge(mps[1])
    op = (_dev(pkg, "Ffat_Windows")(lambda t: t["value"],
                                    lambda a_, b_: a_ + b_)
          .withTBWindows(4_000, 1_000).withKeyBy(lambda t: t["key"])
          .withMaxKeys(2).build())
    mp.add(op).add_sink(pkg.Sink_Builder(
        lambda r: got.__setitem__((int(r["key"]), int(r["wid"])),
                                  float(r["value"]))
        if r is not None else None).build())
    g.run()
    return got, op


def test_merged_tb_ring_grows_under_channel_lag():
    """test_windows.py:749, cut in depth (300 tuples a source): one
    source ~200 panes ahead of the other; the ring grows ahead of the lag,
    nothing is evicted, and both packages give the oracle's windows."""
    n, lead = 300, 200_000
    a = [{"key": 0, "value": i, "ts": i * 1000 + lead} for i in range(n)]
    b = [{"key": 1, "value": i, "ts": i * 1000} for i in range(n)]
    exp = tb_window_sums({0: [(t["ts"], t["value"]) for t in a],
                          1: [(t["ts"], t["value"]) for t in b]},
                         4_000, 1_000)
    for pkg in PKGS:
        got, op = _merged_tb(pkg, a, b)
        st = op.dump_stats()
        assert st["Pane_cells_evicted"] == 0, st
        assert st["Windows_dropped_on_overflow"] == 0, st
        assert st["Late_tuples_dropped"] == 0, st
        assert op.NP > 200, op.NP
        assert got == exp


def test_merged_tb_ring_defers_ceiling_until_fold_resolves():
    """test_windows.py:792: a small-span merged stream ends with a small
    ring, exact results and nothing evicted."""
    n = 300
    a = [{"key": 0, "value": i, "ts": i * 1000} for i in range(n)]
    b = [{"key": 1, "value": i, "ts": i * 1000} for i in range(n)]
    exp = tb_window_sums({0: [(t["ts"], t["value"]) for t in a],
                          1: [(t["ts"], t["value"]) for t in b]},
                         4_000, 1_000)
    nps = []
    for pkg in PKGS:
        got, op = _merged_tb(pkg, a, b)
        st = op.dump_stats()
        assert st["Pane_cells_evicted"] == 0, st
        assert st["Late_tuples_dropped"] == 0, st
        assert op._np_ceil >= 4096
        assert op.NP <= op._np_ceil // 4
        assert got == exp
        nps.append(op.NP)
    assert nps[0] == nps[1]


# ---------------------------------------------------------------------------
# the mask-only fan-outs share buffers (hazard of DeviceKeyByEmitter and
# the device split)
# ---------------------------------------------------------------------------

def _mutating_map():
    def fn(t):
        # assigns into its record dict: must not reach a sibling branch
        t["v"] = t["v"] * 10.0
        t["key"] = t["key"] + 0
        return t
    return wt.MapGPU_Builder(fn)


def test_shared_buffers_survive_mutating_branches():
    """A device split and a device keyby each hand their destinations the
    same payload tensors.  Branches whose maps assign into their records,
    a filter, a keyed reduce and a keyed CB window, each still match
    their own oracle."""
    items = _keyed_records(CAP * 4, seed=21)
    keys = np.array([t["key"] for t in items])
    vals = np.array([t["v"] for t in items], np.float64)
    out = {0: [], 1: []}
    g = _graph(wt, "shared")
    p = g.add_source(wt.Source_Builder(lambda: iter(items))
                     .withOutputBatchSize(CAP).build())
    p.add(wt.MapGPU_Builder(lambda t: {"key": t["key"], "v": t["v"]})
          .build())
    p.split(lambda t: t["key"] & 1, 2)
    b0 = p.select(0)
    b0.add(_mutating_map().build())
    b0.add(wt.ReduceGPU_Builder(
        lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["key"]).withParallelism(2).build())
    b0.add_sink(wt.Sink_Builder(
        lambda r: out[0].append((int(r["key"]), float(r["v"])))
        if r is not None else None).build())
    b1 = p.select(1)
    b1.add(wt.FilterGPU_Builder(lambda t: t["v"] >= 0).build())
    b1.add(_mutating_map().build())
    b1.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
           .withCBWindows(4, 4).withKeyBy(lambda t: t["key"])
           .withMaxKeys(NK).withParallelism(2).build())
    b1.add_sink(wt.Sink_Builder(
        lambda r: out[1].append((int(r["key"]), int(r["wid"]),
                                 float(r["value"])))
        if r is not None else None).build())
    g.run()
    # branch 0: per-batch keyed sums of 10 * v over the even keys
    exp0 = []
    for lo in range(0, len(items), CAP):
        k, v = keys[lo:lo + CAP], vals[lo:lo + CAP]
        for kk in sorted(set(k[k % 2 == 0].tolist())):
            exp0.append((kk, float((10 * v[k == kk]).sum())))
    assert sorted(out[0]) == sorted(exp0)
    # branch 1: tumbling count windows of 4 over 10 * v >= 0, odd keys
    exp1 = []
    for kk in range(1, NK, 2):
        sel = 10 * vals[(keys == kk) & (vals >= 0)]
        for w, lo in enumerate(range(0, len(sel), 4)):
            exp1.append((kk, w, float(sel[lo:lo + 4].sum())))
    assert sorted(out[1]) == sorted(exp1)
