"""Keyed stateful device operators of the port
(windflow_tpu_torch/ops/gpu_stateful.py) against the JAX package
(windflow_tpu/ops/tpu_stateful.py), on the CPU.

* Step level: ``_wavefront_body`` and ``_assoc_body`` of both packages on
  the same seeded numpy inputs (int32 and f32 state, a state pytree, a
  hot key holding half the batch, a map whose output adds a field,
  filters): every state leaf and every output lane.  Valid lanes carry
  slots inside the table, as every operator route hands the body.
* Graph level, through both ``PipeGraph.run()``s: every family of
  tests/test_tpu_stateful.py (running sums at parallelism 1-3, the
  metamorphic totals over parallelism and batch size, the first-n
  filter, the keyby requirement, slot overflow, a constant key on the
  columnar path, int32 key collisions, two extractors in one chain,
  stateful into stateless, negative and wide keys), the four fast tests
  of tests/test_tpu_stateful_skew.py, the builder refusals,
  ``models/fraud_detection.py`` against tests/test_models.py:221's
  oracle, and a stream handed over mid-run from the JAX operator to the
  port's (the JAX ``snapshot_state()`` blob into ``restore_state``).

Tolerance: exact everywhere.  The state updates are additions, counts
and table lookups in the same order in both packages (the associative
body keeps ``lax.associative_scan``'s combine tree), and no user
function here has a multiply-add.
"""

import dataclasses
import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.ops import tpu_stateful as jst
from windflow_tpu_torch.ops import gpu_stateful as gst

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)


def _graph(pkg, name, tp="INGRESS", **cfg):
    if pkg is wt:
        config = wt.Config(device="cpu", **cfg)
    else:
        config = dataclasses.replace(wf.basic.default_config, **cfg)
    return pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                         getattr(pkg.TimePolicy, tp), config=config)


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else jnp.asarray(tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), (a, b)


# ---------------------------------------------------------------------------
# step level
# ---------------------------------------------------------------------------

CAP, S = 64, 16


def _step_inputs(seed, dtype, hot):
    rng = np.random.default_rng(seed)
    valid = rng.random(CAP) < 0.8
    slots = rng.integers(0, S, CAP).astype(np.int32)
    if hot:
        slots[rng.random(CAP) < 0.5] = 5        # one key holds ~half
    # invalid lanes may carry any slot, in range or not
    slots = np.where(valid, slots, rng.integers(0, S + 3, CAP)) \
        .astype(np.int32)
    if dtype == "int32":
        v = rng.integers(-50, 50, CAP).astype(np.int32)
        state = rng.integers(-5, 5, S).astype(np.int32)
    else:
        v = rng.standard_normal(CAP).astype(np.float32)
        state = rng.standard_normal(S).astype(np.float32)
    payload = {"key": slots.copy(), "v": v}
    return state, payload, valid, slots


def _both(body_j, body_t, state, payload, valid, slots):
    out_j = body_j(_j(state), _j(payload), jnp.asarray(valid),
                   jnp.asarray(slots))
    out_t = body_t(_t(state), _t(payload), torch.from_numpy(valid),
                   torch.from_numpy(slots))
    for a, b in zip(out_j, out_t):
        _same(a, b)
    return out_t


def _map_fn(t, s):
    # the output record adds a field
    return {"key": t["key"], "v": t["v"] + s, "prev": s}, s + t["v"]


def _filter_fn(t, s):
    return s < 3, s + 1


#: (payload dtype, hot key, filter): maps over int32 and f32, filters
#: (int32 state) once with and once without a hot key
BODY_CASES = [("int32", False, False), ("int32", True, False),
              ("float32", False, False), ("float32", True, False),
              ("float32", False, True), ("int32", True, True)]


@pytest.mark.parametrize("dtype,hot,is_filter", BODY_CASES)
def test_wavefront_body_matches_jax(dtype, hot, is_filter):
    state, payload, valid, slots = _step_inputs(7, dtype, hot)
    if is_filter:
        state = np.zeros(S, np.int32)
    fn = _filter_fn if is_filter else _map_fn
    body_t = gst._wavefront_body(fn, CAP, S, is_filter)
    _both(jst._wavefront_body(fn, CAP, S, is_filter), body_t,
          state, payload, valid, slots)
    live = valid & (slots < S)
    depth = max(np.bincount(slots[live], minlength=S).max(), 0)
    assert body_t.last_depth == depth


def test_wavefront_body_state_pytree_matches_jax():
    """A two-leaf state (f32 running sum, int32 count) and a map whose
    output holds both."""
    _, payload, valid, slots = _step_inputs(3, "float32", True)
    state = {"s": np.zeros(S, np.float32), "c": np.zeros(S, np.int32)}

    def fn(t, st):
        new = {"s": st["s"] + t["v"], "c": st["c"] + 1}
        return {"key": t["key"], "sum": new["s"], "n": new["c"]}, new
    _both(jst._wavefront_body(fn, CAP, S, False),
          gst._wavefront_body(fn, CAP, S, False),
          state, payload, valid, slots)


def test_wavefront_body_all_invalid_batch():
    """No live lane: no application, the state unchanged, the output
    carry zeros of the function's structure (taken from one lane)."""
    state, payload, valid, slots = _step_inputs(5, "float32", False)
    valid[:] = False
    out = _both(jst._wavefront_body(_map_fn, CAP, S, False),
                gst._wavefront_body(_map_fn, CAP, S, False),
                state, payload, valid, slots)
    assert torch.equal(out[0], _t(state))


# ---------------------------------------------------------------------------
# the kernel route's device loop (kernels/loop_cuda.py), its class bodies
# driven on the CPU by the plain twin of wavefront_advance
# ---------------------------------------------------------------------------

def _three_routes(fn, cap, slots_n, is_filter, state, payload, valid,
                  slots):
    """JAX's while_loop body, the port's class-window loop and its host
    loop on the same inputs: every output equal, exactly.  Returns the
    loop route's body."""
    loop_t = gst._wavefront_body(fn, cap, slots_n, is_filter, loop=True)
    host_t = gst._wavefront_body(fn, cap, slots_n, is_filter, loop=False)
    out_j = _both(jst._wavefront_body(fn, cap, slots_n, is_filter), loop_t,
                  state, payload, valid, slots)
    out_h = host_t(_t(state), _t(payload), torch.from_numpy(valid),
                   torch.from_numpy(slots))
    for a, b in zip(out_j, out_h):
        _same(a, b)
    assert loop_t.last_depth == host_t.last_depth
    return loop_t


@pytest.mark.parametrize("dtype,hot,is_filter", BODY_CASES)
def test_class_loop_body_matches_jax_and_host_loop(dtype, hot, is_filter):
    state, payload, valid, slots = _step_inputs(7, dtype, hot)
    if is_filter:
        state = np.zeros(S, np.int32)
    fn = _filter_fn if is_filter else _map_fn
    body = _three_routes(fn, CAP, S, is_filter, state, payload, valid, slots)
    live = valid & (slots < S)
    assert body.last_depth == np.bincount(slots[live], minlength=S).max()


def _int_stream(seed, cap, slots_n, hot_lanes):
    """Integer-valued lanes: uniform keys, or one key holding exactly
    ``hot_lanes`` valid lanes (the rest invalid)."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, slots_n, cap).astype(np.int32)
    valid = rng.random(cap) < 0.9
    if hot_lanes:
        valid[:] = False
        valid[rng.choice(cap, hot_lanes, replace=False)] = True
        slots[valid] = 3
    v = rng.integers(-50, 50, cap).astype(np.int32)
    state = rng.integers(-5, 5, slots_n).astype(np.int32)
    return state, {"key": slots.copy(), "v": v}, valid, slots


@pytest.mark.parametrize("hot_lanes,is_filter",
                         [(0, False), (0, True), (1, False), (1024, False),
                          (1025, False), (1025, True)])
def test_class_loop_depth_extremes_match_jax(hot_lanes, is_filter):
    """Uniform keys and one key holding 1, 1,024 and 1,025 lanes (depth
    across the host route's RANK_READ boundary) at 2,048 lanes and 64
    slots: JAX, the class-window loop and the host loop agree exactly,
    and the depth is the hot key's lane count."""
    cap, slots_n = 2048, 64
    state, payload, valid, slots = _int_stream(hot_lanes + 1, cap, slots_n,
                                               hot_lanes)
    if is_filter:
        state = np.zeros(slots_n, np.int32)
    fn = _filter_fn if is_filter else _map_fn
    body = _three_routes(fn, cap, slots_n, is_filter, state, payload, valid,
                         slots)
    if hot_lanes:
        assert body.last_depth == hot_lanes
    # every pass ran one class window: the depth is the pass count
    assert body.loop.depth == body.last_depth


def test_class_loop_state_pytree_matches_jax():
    """A two-leaf state through the class windows (the dump row is one
    more row of every leaf)."""
    _, payload, valid, slots = _step_inputs(3, "int32", True)
    state = {"s": np.zeros(S, np.float32), "c": np.zeros(S, np.int32)}

    def fn(t, st):
        new = {"s": st["s"] + t["v"], "c": st["c"] + 1}
        return {"key": t["key"], "sum": new["s"], "n": new["c"]}, new
    _three_routes(fn, CAP, S, False, state, payload, valid, slots)


def test_width_classes_and_advance_plain():
    """The classes run from the power of two that holds a rank's most
    lanes down to 32; the steering twin publishes each rank's slice and
    the smallest class that holds it, and stops at the first empty
    rank."""
    from windflow_tpu_torch.kernels import loop_cuda as L
    assert L.width_classes(16384, 262144) == [
        16384, 8192, 4096, 2048, 1024, 512, 256, 128, 64, 32]
    assert L.width_classes(1000, 4096) == [1024, 512, 256, 128, 64, 32]
    assert L.width_classes(8, 64) == [8]
    widths = L.width_classes(100, 200)
    counts = [100, 64, 33, 32, 1, 0, 7]
    cnt = torch.tensor(counts, dtype=torch.int32)
    cur = torch.zeros(L.CUR_WORDS, dtype=torch.int64)
    seen = []
    passes = L.run_loop_plain(cnt, cur, widths,
                              lambda w: seen.append((w, cur.tolist())))
    assert passes == 5
    assert [w for w, _ in seen] == [128, 64, 64, 32, 32]
    assert [c[2:4] for _, c in seen] == [[0, 100], [100, 64], [164, 33],
                                         [197, 32], [229, 1]]
    assert cur.tolist()[:2] == [5, 230] and cur.tolist()[4] == 0
    L.advance_plain(torch.zeros(4, dtype=torch.int32), cur, widths, True)
    assert cur.tolist() == [0, 0, 0, 0, 0, -1]


@pytest.mark.parametrize("dtype,hot,is_filter", BODY_CASES)
def test_assoc_body_matches_jax(dtype, hot, is_filter):
    state, payload, valid, slots = _step_inputs(11, dtype, hot)

    def lift(t):
        return t["v"]

    def comb(a, b):
        return a + b

    if is_filter:
        def project(t, s):
            return s > 0
    else:
        def project(t, s):
            return {"key": t["key"], "v": s, "own": s - t["v"]}
    _both(jst._assoc_body(lift, comb, project, CAP, S, is_filter),
          gst._assoc_body(lift, comb, project, CAP, S, is_filter),
          state, payload, valid, slots)


# ---------------------------------------------------------------------------
# graph level: tests/test_tpu_stateful.py
# ---------------------------------------------------------------------------

def stream(n_keys, length):
    return [{"key": i % n_keys, "value": float(i % 13 + 1)}
            for i in range(length)]


def _running_sum_graph(pkg, items, par, batch, slots=None, **cfg):
    got = []
    src = pkg.Source_Builder(lambda: iter(items)) \
        .withOutputBatchSize(batch).build()
    b = (_dev(pkg, "Map")(
            lambda t, s: ({"key": t["key"], "value": s + t["value"]},
                          s + t["value"]))
         .withKeyBy(lambda t: t["key"]).withInitialState(0.0)
         .withParallelism(par))
    if slots is not None:
        b = b.withNumKeySlots(slots)
    m = b.build()
    snk = pkg.Sink_Builder(
        lambda t: got.append((int(t["key"]), float(t["value"])))
        if t else None).build()
    g = _graph(pkg, "stateful_map", **cfg)
    g.add_source(src).add(m).add_sink(snk)
    g.run()
    return got, m


def _running_sums(items):
    run, out = {}, []
    for t in items:
        run[t["key"]] = run.get(t["key"], 0.0) + t["value"]
        out.append((t["key"], run[t["key"]]))
    return out


@pytest.mark.parametrize("par", [1, 2, 3])
def test_stateful_map_running_sum_exact(par):
    items = stream(6, 520)
    got, op = _running_sum_graph(wt, items, par, 64, slots=64)
    want, _ = _running_sum_graph(wf, items, par, 64, slots=64)
    assert sorted(got) == sorted(want) == sorted(_running_sums(items))
    seen = {}
    for k, v in got:            # in order within each key
        assert v > seen.get(k, 0.0)
        seen[k] = v
    assert all(r.stats.device_programs_launched > 0 for r in op.replicas)


@pytest.mark.parametrize("par,batch", [(2, 16), (3, 128)])
def test_stateful_map_metamorphic_totals(par, batch):
    """Each (parallelism, batch size) reproduces the per-key totals (the
    running sums' maxima) and the JAX package's records."""
    items = stream(5, 600)
    got, _ = _running_sum_graph(wt, items, par, batch)
    want, _ = _running_sum_graph(wf, items, par, batch)
    assert sorted(got) == sorted(want)
    maxes = {}
    for k, v in got:
        maxes[k] = max(maxes.get(k, 0.0), v)
    totals = {}
    for t in items:
        totals[t["key"]] = totals.get(t["key"], 0.0) + t["value"]
    assert maxes == totals


@pytest.mark.parametrize("par", [1, 2, 3])
def test_stateful_filter_first_n_per_key(par):
    def run(pkg):
        got = []
        src = pkg.Source_Builder(lambda: iter(stream(9, 400))) \
            .withOutputBatchSize(50).build()
        f = (_dev(pkg, "Filter")(lambda t, s: (s < 3, s + 1))
             .withKeyBy(lambda t: t["key"]).withInitialState(0)
             .withParallelism(par).build())
        snk = pkg.Sink_Builder(
            lambda t: got.append((int(t["key"]), float(t["value"])))
            if t else None).build()
        g = _graph(pkg, "stateful_filter")
        g.add_source(src).add(f).add_sink(snk)
        g.run()
        return sorted(got)
    counts, expected = {}, []
    for t in stream(9, 400):
        c = counts.get(t["key"], 0)
        if c < 3:
            expected.append((t["key"], t["value"]))
        counts[t["key"]] = c + 1
    assert run(wt) == run(wf) == sorted(expected)


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_stateful_requires_keyby(pkg):
    with pytest.raises(pkg.WindFlowError):
        _dev(pkg, "Map")(lambda t, s: (t, s)).withInitialState(0.0).build()


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_stateful_builder_refusals(pkg):
    """The JAX package's refusals (builders.py:362-405): a batch
    function, and rebalancing."""
    with pytest.raises(pkg.WindFlowError, match="batch_fn"):
        (_dev(pkg, "Map")(lambda t, s: (t, s), batch_fn=True)
         .withKeyBy(lambda t: t["key"]).withInitialState(0.0).build())
    for kind in ("Map", "Filter"):
        with pytest.raises(pkg.WindFlowError, match="REBALANCING"):
            (_dev(pkg, kind)(lambda t, s: (t, s)).withRebalancing()
             .withInitialState(0.0).build())


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
@pytest.mark.parametrize("compact", [True, False])
def test_stateful_key_slot_overflow(pkg, compact):
    """More distinct keys than slots: the interner's num_key_slots error,
    on the interning route and through the compactor's fallback."""
    src = pkg.Source_Builder(lambda: iter(stream(100, 200))) \
        .withOutputBatchSize(32).build()
    m = (_dev(pkg, "Map")(lambda t, s: (t, s))
         .withKeyBy(lambda t: t["key"]).withInitialState(0.0)
         .withNumKeySlots(8).build())
    g = _graph(pkg, "overflow", key_compaction=compact)
    g.add_source(src).add(m).add_sink(pkg.Sink_Builder(lambda t: None)
                                      .build())
    with pytest.raises(pkg.WindFlowError, match="num_key_slots"):
        g.run()


def test_stateful_columnar_constant_key_parallel():
    """A scalar-returning key extractor on the columnar staging path at
    parallelism 2 drops no row (the per-row fallback)."""
    n = 300
    recs = [(i % 5, 1_000 + i, float(i % 9 + 1)) for i in range(n)]
    blob = b"".join(struct.pack("<qqd", *r) for r in recs)

    def chunks():
        for lo in range(0, len(blob), 997):
            yield blob[lo:lo + 997]

    def run(pkg, FS):
        got = []
        src = FS(chunks, nv=1, fmt="frames", output_batch_size=64)
        m = (_dev(pkg, "Map")(
                lambda t, s: ({"key": t["key"], "v0": s + t["v0"]},
                              s + t["v0"]))
             .withKeyBy(lambda t: 0).withInitialState(0.0)
             .withParallelism(2).build())
        snk = pkg.Sink_Builder(
            lambda t: got.append(float(t["v0"])) if t is not None else None) \
            .build()
        g = _graph(pkg, "const_key", tp="EVENT")
        g.add_source(src).add(m).add_sink(snk)
        g.run()
        return sorted(got)
    from windflow_tpu.io import FrameSource as JFrameSource
    run_sum, expected = 0.0, []
    for _, _, v in recs:
        run_sum += v
        expected.append(run_sum)
    assert run(wt, wt.FrameSource) == run(wf, JFrameSource) == expected


def test_stateful_int32_key_collision_routes_together():
    """Keys equal mod 2^32 are one key on the device: the keyed staging
    sends them to one replica and one slot."""
    items = [{"key": (5 if i % 2 == 0 else 2**32 + 5), "value": 1.0}
             for i in range(120)]

    def run(pkg):
        got = []
        src = pkg.Source_Builder(lambda: iter(items)) \
            .withOutputBatchSize(16).build()
        m = (_dev(pkg, "Map")(
                lambda t, s: ({"key": t["key"], "value": s + t["value"]},
                              s + t["value"]))
             .withKeyBy(lambda t: t["key"]).withInitialState(0.0)
             .withParallelism(3).build())
        snk = pkg.Sink_Builder(
            lambda t: got.append(float(t["value"])) if t is not None
            else None).build()
        g = _graph(pkg, "collide")
        g.add_source(src).add(m).add_sink(snk)
        g.run()
        return sorted(got)
    assert run(wt) == run(wf) == [float(i) for i in range(1, 121)]


def test_chained_keyed_ops_with_different_extractors():
    """A key lane extracted for one operator does not leak into a
    downstream operator keyed on another field (the keyed device split
    at parallelism 2)."""
    items = [{"a": i % 3, "b": (i + 1) % 5, "value": 1.0}
             for i in range(200)]

    def run(pkg):
        got = []
        src = pkg.Source_Builder(lambda: iter(items)) \
            .withOutputBatchSize(32).build()
        m1 = (_dev(pkg, "Map")(
                lambda t, s: ({"a": t["a"], "b": t["b"], "value": s + 1.0},
                              s + 1.0))
              .withKeyBy(lambda t: t["a"]).withInitialState(0.0)
              .withName("by_a").build())
        m2 = (_dev(pkg, "Map")(
                lambda t, s: ({"a": t["a"], "b": t["b"],
                               "value": t["value"], "bcount": s + 1.0},
                              s + 1.0))
              .withKeyBy(lambda t: t["b"]).withInitialState(0.0)
              .withParallelism(2).withName("by_b").build())
        snk = pkg.Sink_Builder(
            lambda t: got.append((int(t["a"]), int(t["b"]),
                                  float(t["value"]), float(t["bcount"])))
            if t is not None else None).build()
        g = _graph(pkg, "two_keys")
        g.add_source(src).add(m1).add(m2).add_sink(snk)
        g.run()
        return sorted(got)
    a_counts, b_counts, expected = {}, {}, []
    for t in items:
        a_counts[t["a"]] = a_counts.get(t["a"], 0.0) + 1.0
        b_counts[t["b"]] = b_counts.get(t["b"], 0.0) + 1.0
        expected.append((t["a"], t["b"], a_counts[t["a"]], b_counts[t["b"]]))
    assert run(wt) == run(wf) == sorted(expected)


def test_stateful_then_stateless_device_edge():
    def run(pkg):
        got = []
        src = pkg.Source_Builder(lambda: iter(stream(4, 256))) \
            .withOutputBatchSize(64).build()
        m = (_dev(pkg, "Map")(
                lambda t, s: ({"key": t["key"], "value": s + t["value"]},
                              s + t["value"]))
             .withKeyBy(lambda t: t["key"]).withInitialState(0.0).build())
        f = _dev(pkg, "Filter")(lambda t: t["value"] > 100.0).build()
        snk = pkg.Sink_Builder(
            lambda t: got.append(float(t["value"])) if t else None).build()
        g = _graph(pkg, "stateful_edge")
        g.add_source(src).add(m).add(f).add_sink(snk)
        g.run()
        return sorted(got)
    expected = sorted(v for _, v in _running_sums(stream(4, 256))
                      if v > 100.0)
    assert run(wt) == run(wf) == expected


def test_keyed_routing_negative_and_wide_keys():
    """Negative and >2^31 keys through the keyed staging and the state at
    parallelism 3: K and K + 2^32 share a replica and a slot."""
    raw = [-5, -1, 3, (1 << 32) + 3, (1 << 31) + 7, 7 - (1 << 31)]
    items = [{"key": raw[i % len(raw)], "value": 1} for i in range(240)]

    def run(pkg, init):
        acc = {}
        src = pkg.Source_Builder(lambda: iter(items)) \
            .withOutputBatchSize(24).build()
        op = (_dev(pkg, "Map")(
                lambda t, s: ({"key": t["key"], "count": s + 1}, s + 1))
              .withInitialState(init)
              .withKeyBy(lambda t: t["key"]).withParallelism(3).build())
        snk = pkg.Sink_Builder(
            lambda r: acc.__setitem__(
                int(r["key"]) & 0xFFFFFFFF,
                max(acc.get(int(r["key"]) & 0xFFFFFFFF, 0),
                    int(r["count"])))
            if r is not None else None).build()
        g = _graph(pkg, "widekeys")
        g.add_source(src).add(op).add_sink(snk)
        g.run()
        return acc
    exp = {}
    for t in items:
        k32 = t["key"] & 0xFFFFFFFF
        exp[k32] = exp.get(k32, 0) + 1
    assert run(wt, torch.zeros((), dtype=torch.int32)) \
        == run(wf, jnp.zeros((), jnp.int32)) == exp


# ---------------------------------------------------------------------------
# tests/test_tpu_stateful_skew.py (its four fast tests)
# ---------------------------------------------------------------------------

def _skew_run(pkg, records, batch, *, dense=False, assoc=False,
              num_slots=64):
    got = []
    src = pkg.Source_Builder(lambda: iter(records)) \
        .withOutputBatchSize(batch).build()
    b = (_dev(pkg, "Map")(
            lambda t, s: ({"key": t["key"], "value": s + t["value"]},
                          s + t["value"]))
         .withKeyBy(lambda t: t["key"]).withInitialState(0.0)
         .withNumKeySlots(num_slots))
    if dense:
        b = b.withDenseKeys()
    if assoc:
        b = b.withAssociativeUpdate(
            lift=lambda t: t["value"], comb=lambda a, b: a + b,
            project=lambda t, s: {"key": t["key"], "value": s})
    m = b.build()
    snk = pkg.Sink_Builder(
        lambda t: got.append((int(t["key"]), float(t["value"])))
        if t else None).build()
    g = _graph(pkg, "skew")
    g.add_source(src).add(m).add_sink(snk)
    g.run()
    return sorted(got), m


def _recs(n, n_keys):
    return [{"key": i % n_keys, "value": float(i % 7 + 1)} for i in range(n)]


def test_dense_keys_skips_interning():
    records = _recs(512, 8)
    got, op = _skew_run(wt, records, 64, dense=True)
    want, _ = _skew_run(wf, records, 64, dense=True)
    assert got == want == sorted(_running_sums(records))
    assert len(op._interner) == 0 and op._compactor is None


def test_dense_keys_out_of_range_masked():
    records = _recs(128, 8) + [{"key": 99, "value": 1.0}] * 16
    got, _ = _skew_run(wt, records, 16, dense=True)
    want, _ = _skew_run(wf, records, 16, dense=True)
    assert got == want == sorted(_running_sums(_recs(128, 8)))


@pytest.mark.parametrize("dense", [False, True])
def test_assoc_running_sum_matches_wavefront(dense):
    records = _recs(600, 6)
    got, op = _skew_run(wt, records, 64, dense=dense, assoc=True)
    want, _ = _skew_run(wf, records, 64, dense=dense, assoc=True)
    wave, _ = _skew_run(wt, records, 64, dense=dense)
    assert got == want == wave == sorted(_running_sums(records))
    assert op.last_depth == 0           # no wavefront ran


def test_assoc_stateful_filter():
    """Keep the first 3 tuples of each key (state = count including
    self)."""
    from collections import Counter
    records = _recs(240, 5)

    def run(pkg):
        kept = []
        src = pkg.Source_Builder(lambda: iter(records)) \
            .withOutputBatchSize(32).build()
        f = (_dev(pkg, "Filter")(lambda t, s: (True, s))
             .withKeyBy(lambda t: t["key"]).withInitialState(0)
             .withNumKeySlots(16).withDenseKeys()
             .withAssociativeUpdate(lift=lambda t: 1,
                                    comb=lambda a, b: a + b,
                                    project=lambda t, s: s <= 3)
             .build())
        snk = pkg.Sink_Builder(
            lambda t: kept.append(int(t["key"])) if t else None).build()
        g = _graph(pkg, "assoc_filter")
        g.add_source(src).add(f).add_sink(snk)
        g.run()
        return Counter(kept)
    assert run(wt) == run(wf) == Counter({k: 3 for k in range(5)})


# ---------------------------------------------------------------------------
# the stateful app and the handover
# ---------------------------------------------------------------------------

def test_fraud_detection_matches_oracle_and_jax():
    """tests/test_models.py:221: the flagged alerts equal a sequential
    oracle (any state carried wrongly across batches changes which
    transitions are flagged) and the JAX package's app."""
    from windflow_tpu.models import fraud_detection as jfd
    from windflow_tpu_torch.models import fraud_detection as tfd
    n, cards, types = 4000, 12, 4
    rnd = random.Random(31)
    trans = [[0.45 if j in (i, (i + 1) % types) else 0.05
              for j in range(types)] for i in range(types)]
    txs = [{"card": i % cards, "etype": rnd.randrange(types)}
           for i in range(n)]
    got = tfd.run(txs, trans, max_cards=cards, threshold=0.1, batch=256,
                  config=wt.Config(device="cpu"))
    want = jfd.run(txs, trans, max_cards=cards, threshold=0.1, batch=256)
    prev, exp = {}, []
    for t in txs:
        c, e = t["card"], t["etype"]
        score = 1.0 if c not in prev else trans[prev[c]][e]
        if score < 0.1:
            exp.append((c, e))
        prev[c] = e
    assert [(a["card"], a["etype"]) for a in got] == exp
    assert got == want and len(exp) > 100


@pytest.mark.parametrize("jax_compaction", [True, False])
def test_mid_stream_handover_through_interop(jax_compaction):
    """The first half of a stream runs through the JAX operator, its
    ``snapshot_state()`` is installed on the port's operator, and the
    second half runs through the port: the records equal the JAX
    package's whole run (the key -> slot map crosses as the interner, or
    as the compactor's remap)."""
    items = [{"key": (i * 7) % 11 - 3, "value": float(i % 13 + 1)}
             for i in range(512)]
    half = 256

    def op_of(pkg):
        return (_dev(pkg, "Map")(
                    lambda t, s: ({"key": t["key"], "value": s + t["value"]},
                                  s + t["value"]))
                .withKeyBy(lambda t: t["key"]).withInitialState(0.0)
                .withNumKeySlots(32).build())

    def run(pkg, op, recs, blob=None, **cfg):
        got = []
        g = _graph(pkg, "handover", **cfg)
        g.add_source(pkg.Source_Builder(lambda: iter(recs))
                     .withOutputBatchSize(64).build()).add(op).add_sink(
            pkg.Sink_Builder(lambda t: got.append(
                (int(t["key"]), float(t["value"]))) if t else None).build())
        g.start()
        if blob is not None:
            op.restore_state(blob)      # after the build, before a batch
        g.wait_end()
        return sorted(got)

    whole = run(wf, op_of(wf), items, key_compaction=jax_compaction)
    jop = op_of(wf)
    first = run(wf, jop, items[:half], key_compaction=jax_compaction)
    blob = jop.snapshot_state()
    assert (blob["compactor"] is not None) == jax_compaction
    top = op_of(wt)
    second = run(wt, top, items[half:], blob=blob)
    assert sorted(first + second) == whole
    # a remap restores into the port's compactor; an interner's map owns
    # the rows, so the port's compactor stands down
    assert (top._compactor is not None) == jax_compaction
    assert top._state.dtype == torch.float64
