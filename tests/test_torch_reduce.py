"""The keyed device reduce of the port against the JAX package:
``windflow_tpu_torch/ops/reduce.py`` (ReduceGPU, ``_segmented_reduce``)
and ``windflow_tpu_torch/parallel/compaction.py`` against
``windflow_tpu/ops/tpu.py`` (ReduceTPU) and
``windflow_tpu/parallel/compaction.py``.

Inputs come from numpy with a fixed seed and go to both packages as
``np.int32`` / ``np.float32`` record values (the JAX package turns x64
on, so Python floats would stage as f64 there).  The JAX side runs with
``pallas_kernels="auto"``: the Pallas kernels run under the interpreter
on the CPU.  Tolerances, with their reasons:

* the sorted route, max/min and integer folds: exact (the port's
  ``associative_scan`` keeps JAX's combine tree; the packed int64
  carrier compares integers);
* declared float sums: exact on integer-valued data; on random floats
  rtol 1e-5 — the Pallas table kernel sums a 256-lane tile as a tree and
  the port's scatter-add sums in lane order, the declared-"sum"
  reassociation tolerance of ``pallas_ffat.py:40-46``.
"""

import dataclasses
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
from windflow_tpu import kernels as pk
from windflow_tpu.ops import tpu as jtpu
from windflow_tpu.parallel import compaction as jc
import windflow_tpu_torch as wt
from windflow_tpu_torch.interop import cstats_from_numpy
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.ops import reduce as tr
from windflow_tpu_torch.parallel import compaction as tc

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I64MIN = int(np.iinfo(np.int64).min)
I32MIN, I32MAX = int(np.iinfo(np.int32).min), int(np.iinfo(np.int32).max)

_TOPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}
_JOPS = {"sum": jnp.add, "max": jnp.maximum, "min": jnp.minimum}


def _pallas():
    return pk.resolve_pallas(dataclasses.replace(wf.default_config,
                                                 pallas_kernels="auto"))


def _comb(monoid, pkg):
    """Leafwise combiner of the declared monoid over every record field
    (a generic sum where monoid is None)."""
    op = (_TOPS if pkg == "torch" else _JOPS)[monoid or "sum"]

    def comb(a, b):
        return {k: op(a[k], b[k]) for k in a}
    return comb


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _eq(a, b):
    """Equal trees of arrays, bit for bit (dtypes included)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _eq(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(f"i{a.itemsize}"),
                                      b.view(f"i{b.itemsize}"))
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# _segmented_reduce and the int64 carriers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keyset", ["small", "extremes"])
def test_segmented_reduce_bit_identical_on_random_floats(keyset):
    """Same stable order and the same combine tree: float sums are
    bit-identical, keys of INT32_MAX/INT32_MIN are real keys."""
    rng = np.random.default_rng(3 + len(keyset))
    cap = 100
    if keyset == "small":
        keys = rng.integers(0, 7, cap).astype(np.int32)
    else:
        keys = rng.choice(np.array([I32MIN, -1, 0, 5, I32MAX], np.int32),
                          cap)
    payload = {"key": keys, "v": rng.standard_normal(cap).astype(np.float32),
               "w": rng.integers(-9, 9, (cap, 2)).astype(np.int64)}
    ts = rng.integers(0, 10 ** 9, cap).astype(np.int64)
    valid = rng.random(cap) < 0.8
    got = tr._segmented_reduce(torch.from_numpy(keys), _t(payload),
                               torch.from_numpy(ts), torch.from_numpy(valid),
                               _comb("sum", "torch"), cap)
    want = jtpu._segmented_reduce(jnp.asarray(keys), jax.tree.map(
        jnp.asarray, payload), jnp.asarray(ts), jnp.asarray(valid),
        _comb("sum", "jax"), cap)
    for g, w in zip(got, want):
        _eq(_np_tree(g) if isinstance(g, dict) else g.numpy(), _np_tree(w))


def test_enc64_dec64_match_jax_at_the_extremes():
    f32 = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1.5, -1.5,
                    np.finfo(np.float32).max, -np.finfo(np.float32).max,
                    np.finfo(np.float32).tiny], np.float32)
    f64 = np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, -5e-324,
                    np.finfo(np.float64).max, -np.finfo(np.float64).max],
                   np.float64)
    cols = [f32, f64,
            np.array([I32MIN, -1, 0, 1, I32MAX], np.int32),
            np.array([I64MIN, -1, 0, 1, 2 ** 63 - 1], np.int64),
            np.array([True, False]), np.array([0, 7, 255], np.uint8)]
    for x in cols:
        enc = tc._enc64(torch.from_numpy(x))
        jenc = np.asarray(jc._enc64(jnp.asarray(x)))
        _eq(enc.numpy(), jenc)
        _eq(tc._dec64(enc, torch.from_numpy(x).dtype).numpy(),
            np.asarray(jc._dec64(jnp.asarray(jenc), x.dtype)))
        # order-preserving: the encoding sorts like the values
        if x.dtype.kind == "f":
            srt = np.sort(x)
            e = tc._enc64(torch.from_numpy(srt)).numpy()
            assert (np.diff(e) >= 0).all()
    assert all(tc._pack_ok(d) == jc._pack_ok(nd) for d, nd in [
        (torch.float32, np.float32), (torch.float64, np.float64),
        (torch.int32, np.int32), (torch.int64, np.int64),
        (torch.bool, np.bool_), (torch.uint8, np.uint8),
        (torch.float16, np.float16)])


def test_lookup_slots_matches_jax():
    rng = np.random.default_rng(9)
    tk, tsl = _tables(rng)
    keys = rng.integers(990, 1030, 200).astype(np.int32)
    keys[:3] = tc.KEY_SENTINEL
    valid = rng.random(200) < 0.9
    s, h = tc.lookup_slots(torch.from_numpy(tk), torch.from_numpy(tsl),
                           torch.from_numpy(keys), torch.from_numpy(valid))
    js, jh = jc.lookup_slots(jnp.asarray(tk), jnp.asarray(tsl),
                             jnp.asarray(keys), jnp.asarray(valid))
    _eq(s.numpy(), np.asarray(js))
    _eq(h.numpy(), np.asarray(jh))


# ---------------------------------------------------------------------------
# make_compacted_reduce, bounded and unbounded, with cstats
# ---------------------------------------------------------------------------

CAP, T = 64, 16          # overflow lane: overflow_cap(64) == 32


def _tables(rng, T_=T):
    """A hand-made remap table: 10 admitted keys in [995, 1025) at
    scattered stable slots, sentinel-padded."""
    keys = np.sort(rng.choice(np.arange(995, 1025), 10, replace=False))
    slots = rng.permutation(T_)[:10]
    tk = np.full(T_, tc.KEY_SENTINEL, np.int32)
    tsl = np.full(T_, T_, np.int32)
    tk[:10], tsl[:10] = keys, slots
    return tk, tsl


def _batch(rng, n_miss, bounded, monoid, floats, tk=None):
    """One batch with about ``n_miss`` valid miss lanes."""
    if bounded:
        keys = rng.integers(0, T, CAP)
        miss_keys = rng.choice(np.array([-3, T, T + 5, 1000]), CAP)
    else:
        keys = rng.choice(tk[:10], CAP)
        miss_keys = rng.choice(np.setdiff1d(np.arange(990, 1030), tk), CAP)
    lanes = rng.permutation(CAP)[:n_miss]
    keys[lanes] = miss_keys[lanes]
    keys = keys.astype(np.int32)
    valid = np.ones(CAP, bool)
    valid[rng.permutation(CAP)[:4]] = False
    valid[lanes] = True
    if floats:
        v = rng.standard_normal(CAP).astype(np.float32)
    else:
        v = rng.integers(-50, 50, CAP).astype(np.float32)
    payload = {"key": keys, "v": v}
    if monoid != "sum":
        payload["w"] = rng.integers(-9, 9, (CAP, 2)).astype(np.int32)
    ts = rng.integers(0, 10 ** 6, CAP).astype(np.int64)
    ts[0] = I64MIN                  # the reserved ts value, clamped
    ts[1] = I64MIN + 1
    return keys, payload, ts, valid


_JBODIES = {}


def _jax_body(monoid, bounded):
    """The JAX compacted step, compiled once per (monoid, bounded)."""
    key = (monoid, bounded)
    if key not in _JBODIES:
        _JBODIES[key] = jax.jit(jc.make_compacted_reduce(
            CAP, T, monoid, _comb(monoid, "jax"), lambda t: t["key"], None,
            bounded, pallas=_pallas()))
    return _JBODIES[key]


def _run_both(batches, monoid, bounded, tables=None, kernels=True,
              switch_at=None):
    """Drive the JAX and the port's compacted step over ``batches``; at
    ``switch_at`` the port's cstats restart from the JAX ones."""
    jbody = _jax_body(monoid, bounded)
    tbody = tc.make_compacted_reduce(CAP, T, monoid, _comb(monoid, "torch"),
                                     lambda t: t["key"], bounded,
                                     kernels=kernels)
    jst, tst = jc.cstats_init(), tc.cstats_init()
    extra_j = () if bounded else tuple(jnp.asarray(t) for t in tables)
    extra_t = () if bounded else tuple(torch.from_numpy(t) for t in tables)
    outs = []
    for i, (keys, payload, ts, valid) in enumerate(batches):
        if i == switch_at:
            tst = cstats_from_numpy(_np_tree(jst))
        jo = jbody(None, jax.tree.map(jnp.asarray, payload),
                   jnp.asarray(ts), jnp.asarray(valid), *extra_j, jst)
        to = tbody(None, _t(payload), torch.from_numpy(ts),
                   torch.from_numpy(valid), *extra_t, tst)
        jst, tst = jo[3], to[3]
        outs.append((jo, to))
    return outs


def _check(outs, tol=None):
    for jo, to in outs:
        jp, jts, jv, jst = (_np_tree(x) for x in jo)
        tp, tts, tv, tst = to
        _eq(tv.numpy(), jv)
        _eq(tts.numpy(), jts)
        _eq({k: v.numpy() for k, v in tst.items()}, jst)
        for k in jp:
            if tol is not None and k == "v":
                np.testing.assert_allclose(tp[k].numpy(), jp[k], rtol=tol)
            else:
                _eq(tp[k].numpy(), jp[k])


@pytest.mark.parametrize("branch,n_miss", [("no_miss", 0), ("small", 9),
                                           ("big", 40)])
@pytest.mark.parametrize("monoid", ["max", "min", "sum"])
@pytest.mark.parametrize("bounded", [True, False])
def test_compacted_step_matches_jax(bounded, monoid, branch, n_miss):
    """Every branch of the step (all-hit dense; misses on the overflow
    lane; misses beyond it on the full-width sorted lane), the packed
    carrier (max/min, a [B, 2] leaf included) and the per-leaf tables
    (sum): outputs and cstats equal JAX's."""
    rng = np.random.default_rng(len(monoid) * 7 + n_miss + bounded)
    tables = None if bounded else _tables(rng)
    batches = [_batch(rng, n_miss, bounded, monoid, floats=False,
                      tk=None if bounded else tables[0]) for _ in range(2)]
    outs = _run_both(batches, monoid, bounded, tables)
    _check(outs)
    assert int(outs[-1][1][3]["big"]) == (2 if branch == "big" else 0)
    assert int(outs[-1][1][3]["misses"]) == sum(
        int((b[3] & ~((b[0] >= 0) & (b[0] < T))).sum()) if bounded else
        int((b[3] & ~np.isin(b[0], tables[0][:10])).sum())
        for b in batches)


def test_compacted_float_sum_within_the_declared_tolerance():
    rng = np.random.default_rng(21)
    batches = [_batch(rng, 9, True, "sum", floats=True) for _ in range(2)]
    _check(_run_both(batches, "sum", True), tol=1e-5)


@pytest.mark.parametrize("kernels", [True, False])
def test_cstats_carry_over_from_jax_and_both_continue(kernels):
    """The port's step picks up the JAX step's cstats after three batches
    (cstats_from_numpy) and both go on identically, the miss ring's
    rotating offset included."""
    rng = np.random.default_rng(33)
    batches = [_batch(rng, n, True, "max", floats=True)
               for n in (3, 0, 12, 40, 5, 9)]
    outs = _run_both(batches, "max", True, kernels=kernels, switch_at=3)
    _check(outs)
    assert int(outs[-1][1][3]["batches"]) == 6


# ---------------------------------------------------------------------------
# graphs through PipeGraph.run(), both packages
# ---------------------------------------------------------------------------

def _cfg(pkg, **kw):
    if pkg is wt:
        return wt.Config(device="cpu", punctuation_interval_usec=10 ** 12,
                         **kw)
    return dataclasses.replace(wf.default_config, pallas_kernels="auto",
                               punctuation_interval_usec=10 ** 12, **kw)


def _reduce_graph(pkg, stream, monoid="max", max_keys=None, keyed=True,
                  cap=64, chain=False, declare=True, **cfg_kw):
    """Source [→ Map | Filter] → Reduce → Sink over ``stream``, the
    combiner leafwise ``monoid`` (declared unless ``declare`` is False);
    returns (records as sorted tuples in sink order, the reduce
    operator)."""
    got = []
    gpu = pkg is wt
    RB = wt.ReduceGPU_Builder if gpu else wf.ReduceTPU_Builder
    b = RB(_comb(monoid, "torch" if gpu else "jax"))
    if keyed:
        b = b.withKeyBy(lambda t: t["key"])
    if declare:
        b = b.withMonoidCombiner(monoid)
    if max_keys is not None:
        b = b.withMaxKeys(max_keys)
    op = b.build()
    g = pkg.PipeGraph("reduce", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, **cfg_kw))
    pipe = g.add_source(pkg.Source_Builder(lambda: iter(stream))
                        .withOutputBatchSize(cap).build())
    if chain:
        MB = wt.MapGPU_Builder if gpu else wf.MapTPU_Builder
        FB = wt.FilterGPU_Builder if gpu else wf.FilterTPU_Builder
        pipe.add(MB(lambda t: {"key": t["key"],
                               "v": t["v"] * 1.5 + 1.0}).build())
        pipe.chain(FB(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(op).add_sink(pkg.Sink_Builder(
        lambda r: got.append(tuple(sorted((k, float(v))
                                          for k, v in r.items())))
        if r is not None else None).build())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        g.run()
    return got, op


def _stream(n, key_of, v_of):
    return [{"key": np.int32(key_of(i)), "v": np.float32(v_of(i))}
            for i in range(n)]


def test_keyed_sorted_reduce_matches_jax_on_random_floats():
    """Undeclared keyed reduce (tests/test_tpu_ops.py:88): the sorted
    route, bit-identical on random floats; the non-keyed reduce folds
    each batch into one record."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal(640).astype(np.float32)
    stream = _stream(640, lambda i: i % 5, lambda i: vals[i])
    for keyed in (True, False):
        a, _ = _reduce_graph(wf, stream, "sum", keyed=keyed, declare=False)
        b, op = _reduce_graph(wt, stream, "sum", keyed=keyed, declare=False)
        assert a == b and len(b) == (50 if keyed else 10)
        assert not op.bounded_compaction


@pytest.mark.parametrize("monoid", ["max", "min", "sum"])
def test_dense_route_matches_jax_and_drops_out_of_range(monoid):
    """key_compaction off (tests/test_monoid_combiner.py:347-375): the
    dense tables emit the sorted route's in-range records, out-of-range
    keys are dropped and counted; port == JAX, record for record."""
    stream = _stream(320, lambda i: i % 10, lambda i: -1.0 - float(i % 13))
    a, op_a = _reduce_graph(wf, stream, monoid, max_keys=6,
                            key_compaction=False)
    b, op_b = _reduce_graph(wt, stream, monoid, max_keys=6,
                            key_compaction=False)
    assert a == b and len(b) > 0
    n_oor = sum(1 for t in stream if t["key"] >= 6)
    assert op_b.dump_stats()["Out_of_range_keys_dropped"] == n_oor
    assert op_b.num_dropped_tuples() == op_a.num_dropped_tuples() == n_oor
    assert not op_b.bounded_compaction
    srt, _ = _reduce_graph(wt, stream, monoid, declare=False)
    key_of = (lambda r: dict(r)["key"]) if monoid != "sum" else None
    if key_of is not None:   # a summed key field is key * count
        assert b == [r for r in srt if key_of(r) < 6]


def test_dense_route_non_keyed_is_one_record_a_batch():
    """Non-keyed declared reduce (tests/test_monoid_combiner.py:378): one
    record per batch (K = 1), even with withMaxKeys(4096)."""
    stream = [{"v": np.float32(-3.0 - float(i % 11))} for i in range(256)]
    a, _ = _reduce_graph(wf, stream, "max", max_keys=4096, keyed=False)
    b, _ = _reduce_graph(wt, stream, "max", max_keys=4096, keyed=False)
    assert a == b == [(("v", max(t["v"] for t in stream[lo:lo + 64])),)
                      for lo in range(0, 256, 64)]


def test_dense_route_warns_once_and_notes_stats():
    stream = _stream(256, lambda i: 17 if i % 5 == 0 else i % 4,
                     lambda i: -1.0 - i)
    got = []
    op = (wt.ReduceGPU_Builder(_comb("max", "torch"))
          .withKeyBy(lambda t: t["key"]).withMaxKeys(4)
          .withMonoidCombiner("max").build())
    g = wt.PipeGraph("warn", config=_cfg(wt, key_compaction=False))
    g.add_source(wt.Source_Builder(lambda: iter(stream))
                 .withOutputBatchSize(64).build()).add(op).add_sink(
        wt.Sink_Builder(lambda r: got.append(r)).build())
    g.run()
    with pytest.warns(RuntimeWarning, match="dense-table contract") as rec:
        st = op.dump_stats()
    assert sum("dense-table" in str(w.message) for w in rec) == 1
    assert st["Out_of_range_keys_dropped"] == sum(
        1 for t in stream if t["key"] >= 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert "dense-table contract" in op.dump_stats()[
            "Out_of_range_keys_note"]


@pytest.mark.parametrize("monoid", ["max", "sum"])
def test_bounded_route_reroutes_out_of_range_keys(monoid):
    """The default graph (tests/test_key_compaction.py:428): withMaxKeys
    + monoid takes the bounded compacted step; out-of-range keys ride the
    overflow lane and are kept and counted; port == JAX == the sorted
    route."""
    stream = _stream(320, lambda i: i % 10,
                     lambda i: -2.0 - ((i * 29) % 83) // 7)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        a, op_a = _reduce_graph(wf, stream, monoid, max_keys=6)
        b, op_b = _reduce_graph(wt, stream, monoid, max_keys=6)
    srt, _ = _reduce_graph(wt, stream, monoid, declare=False)
    assert a == b == srt        # out-of-range keys KEPT
    st = op_b.dump_stats()
    assert op_b.bounded_compaction
    n_oor = sum(1 for t in stream if t["key"] >= 6)
    assert st["Out_of_range_keys_rerouted"] == n_oor
    assert st["Key_compaction"]["overflow_tuples"] == n_oor
    assert st["Key_compaction"]["batches"] == 5
    assert "Out_of_range_keys_dropped" not in st
    assert op_a.dump_stats()["Out_of_range_keys_rerouted"] == n_oor


def test_bounded_route_with_fewer_lanes_than_keys():
    """A batch narrower than the key space (capacity 64 < max_keys 100):
    the all-hit branch cuts the dense table to the batch, the miss
    branches merge into it; port == JAX == the sorted route."""
    for span in (100, 140):      # all hits; misses in every batch
        stream = _stream(400, lambda i: (i * 37) % span,
                         lambda i: float((i * 13) % 29))
        a, _ = _reduce_graph(wf, stream, "max", max_keys=100)
        b, op = _reduce_graph(wt, stream, "max", max_keys=100)
        srt, _ = _reduce_graph(wt, stream, "max", declare=False)
        assert op.bounded_compaction and a == b == srt
        n_oor = sum(1 for t in stream if t["key"] >= 100)
        assert op.dump_stats().get("Out_of_range_keys_rerouted", 0) == n_oor


def test_declared_reduce_without_max_keys_keeps_records():
    """A declared monoid without withMaxKeys takes the sorted route in
    the port and the compacted one in JAX (tests/test_key_compaction.py
    :73): the records are the same; an undeclared reduce never compacts
    (:93)."""
    stream = _stream(512, lambda i: (i * 7) % 23 + 1000,
                     lambda i: -2.0 - ((i * 29) % 83) / 7.0)
    a, op_a = _reduce_graph(wf, stream, "max")
    b, op_b = _reduce_graph(wt, stream, "max")
    assert a == b and len(b) > 0
    assert op_a._compactor is not None and not op_b.bounded_compaction
    c, op_c = _reduce_graph(wt, stream, "max", max_keys=2000, declare=False)
    assert not op_c.bounded_compaction and c == b


@pytest.mark.parametrize("route", ["bounded", "dense"])
def test_table_kernel_switch_record_identical(route):
    """tests/test_pallas_kernels.py:282-339: the dense tables through the
    kernel wrapper ("auto") and through the torch scatters ("0") give
    the same records, and JAX's."""
    stream = [{"key": np.int32(i % 23), "v": np.int64(i * 3)}
              for i in range(600)]
    kw = dict(max_keys=23, cap=128,
              key_compaction=(route == "bounded"))
    on, _ = _reduce_graph(wt, stream, "sum", cuda_kernels="auto", **kw)
    off, _ = _reduce_graph(wt, stream, "sum", cuda_kernels="0", **kw)
    jax_, _ = _reduce_graph(wf, stream, "sum", **kw)
    assert on and on == off == jax_


@pytest.mark.parametrize("route", ["bounded", "dense", "sorted"])
def test_map_filter_reduce_slice_matches_jax(route):
    """The slice's main path at a small size: Source → MapGPU | FilterGPU
    → ReduceGPU → Sink on every single-chip route, port == JAX record
    for record (integer-valued values, so the map's fused multiply-add
    in XLA rounds as torch does)."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 70, 900)       # some beyond max_keys = 64
    vals = rng.integers(-100, 101, 900)
    stream = _stream(900, lambda i: keys[i], lambda i: vals[i])
    kw = {"bounded": dict(monoid="max", max_keys=64),
          "dense": dict(monoid="max", max_keys=64, key_compaction=False),
          "sorted": dict(monoid="max", declare=False)}[route]
    a, _ = _reduce_graph(wf, stream, chain=True, cap=128, **kw)
    b, _ = _reduce_graph(wt, stream, chain=True, cap=128, **kw)
    assert a == b and len(b) > 0


def test_kill_switch_enters_no_kernel_wrapper():
    stream = _stream(300, lambda i: i % 9, lambda i: float(i % 7))
    before = fc.kernel_build_count()
    off = [_reduce_graph(wt, stream, "max", max_keys=8, cuda_kernels="0",
                         key_compaction=kc)[0] for kc in (True, False)]
    assert fc.kernel_build_count() == before
    on = [_reduce_graph(wt, stream, "max", max_keys=8,
                        key_compaction=kc)[0] for kc in (True, False)]
    assert fc.kernel_build_count() > before
    assert on == off
    assert fc.launch_counts()["dense_monoid_table"] == 0   # CPU: plain


def test_combiner_contract_errors():
    """A combiner that drops a field, or changes a leaf's shape, raises
    the clear contract error (tests/test_tpu_ops.py:132,150)."""
    def run(comb, stream):
        g = wt.PipeGraph("contract", config=_cfg(wt))
        g.add_source(wt.Source_Builder(lambda: iter(stream))
                     .withOutputBatchSize(32).build()).add(
            wt.ReduceGPU_Builder(comb).withKeyBy(lambda t: t["key"])
            .build()).add_sink(wt.Sink_Builder(lambda r: None).build())
        g.run()
    s1 = [{"key": np.int32(i % 4), "value": np.float32(i),
           "extra": np.float32(1.0)} for i in range(64)]
    with pytest.raises(wt.WindFlowError, match="same record structure"):
        run(lambda a, b: {"key": a["key"],
                          "value": a["value"] + b["value"]}, s1)
    s2 = [{"key": np.int32(i % 4), "value": np.float32(i)}
          for i in range(64)]
    with pytest.raises(wt.WindFlowError, match="shape"):
        run(lambda a, b: {"key": a["key"],
                          "value": torch.stack([a["value"], b["value"]])},
            s2)
    with pytest.raises(wt.WindFlowError, match="monoid"):
        wt.ReduceGPU_Builder(lambda a, b: a).withMonoidCombiner("avg") \
            .build()
    with pytest.raises(wt.WindFlowError, match="REBALANCING"):
        wt.ReduceGPU_Builder(lambda a, b: a).withRebalancing()


def test_import_of_the_reduce_slice_loads_no_jax():
    code = ("import sys, windflow_tpu_torch, windflow_tpu_torch.ops.reduce, "
            "windflow_tpu_torch.parallel.compaction, "
            "windflow_tpu_torch.kernels.reduce_cuda\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'windflow_tpu' or "
            "m.startswith('windflow_tpu.')]\n"
            "assert not bad, bad\nprint('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout
