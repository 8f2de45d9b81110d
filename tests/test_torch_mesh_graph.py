"""Mesh execution through ``PipeGraph.run()`` in both packages
(``tests/test_mesh_graph.py``'s twelve): with ``Config.mesh`` set, the
staging emitters divide batches over the mesh and FfatWindowsGPU /
ReduceGPU / the stateful Map and Filter run their sharded steps.  Each
graph runs through the JAX package on the conftest's 8 virtual CPU
devices and through the port on an 8-position CPU mesh; the records are
held to each other and to the JAX test's host oracle."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import Config as JConfig
from windflow_tpu.parallel.mesh import make_mesh as jmake_mesh
from windflow_tpu_torch.parallel import mesh as M

N_KEYS = 4
LENGTH = 384
WIN, SLIDE = 16, 4


def stream():
    return [{"key": i % N_KEYS, "value": i, "ts": i * 1000}
            for i in range(LENGTH)]


def _cfg(pkg, data=2, **kw):
    if pkg is wt:
        return wt.Config(device="cpu",
                         mesh=M.make_mesh(8, data=data, devices=["cpu"] * 8),
                         **kw)
    return dataclasses.replace(JConfig(), mesh=jmake_mesh(8, data=data), **kw)


def _b(pkg, name):
    """The package's builder: JAX's ``...TPU_Builder`` names the port's
    ``...GPU_Builder``."""
    return getattr(pkg, name if pkg is wf else name.replace("TPU", "GPU"))


def _np(pkg):
    return jnp if pkg is wf else torch


def oracle_cb():
    per_key = {}
    for t in stream():
        per_key.setdefault(t["key"], []).append(t["value"])
    count, total = 0, 0
    for vals in per_key.values():
        w = 0
        while w * SLIDE < len(vals):
            count += 1
            total += sum(vals[w * SLIDE: w * SLIDE + WIN])
            w += 1
    return count, total


def _cb_run(pkg, n=LENGTH):
    acc = {"count": 0, "total": 0}

    def on_result(r):
        if r is not None:
            acc["count"] += 1
            acc["total"] += int(r["value"])

    src = (pkg.Source_Builder(
        lambda: iter({"key": i % N_KEYS, "value": i, "ts": i * 1000}
                     for i in range(n)))
        .withOutputBatchSize(64).build())
    op = (_b(pkg, "Ffat_WindowsTPU_Builder")(lambda t: t["value"],
                                             lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(N_KEYS).build())
    g = pkg.PipeGraph("ffat_mesh", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg))
    g.add_source(src).add(_b(pkg, "MapTPU_Builder")(lambda t: t).build()) \
        .add(op).add_sink(pkg.Sink_Builder(on_result).build())
    g.run()
    return (acc["count"], acc["total"]), op


def test_ffat_gpu_cb_on_mesh():
    got, op = _cb_run(wt)
    assert got == oracle_cb() == _cb_run(wf)[0]
    # the window state lives key-sharded on the mesh, equal along data
    st = op._states[0]
    assert isinstance(st, M.Sharded) and st.spec == "key"
    assert st.equal_across_data()
    assert len(st.blocks) == 8
    assert op.dump_stats()["Mesh"]["shape"] == {"data": 2, "key": 4}


def _tb_run(pkg):
    TWIN, TSLIDE = 16_000, 4_000
    got = {}
    src = (pkg.Source_Builder(lambda: iter(stream()))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(64).build())
    op = (_b(pkg, "Ffat_WindowsTPU_Builder")(lambda t: t["value"],
                                             lambda a, b: a + b)
          .withTBWindows(TWIN, TSLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(N_KEYS).build())
    snk = pkg.Sink_Builder(
        lambda r: got.__setitem__((int(r["key"]), int(r["wid"])),
                                  int(r["value"]))
        if r is not None else None).build()
    g = pkg.PipeGraph("ffat_mesh_tb", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT, config=_cfg(pkg))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return got, op


def test_ffat_gpu_tb_on_mesh():
    TWIN, TSLIDE = 16_000, 4_000
    per_key = {}
    for t in stream():
        per_key.setdefault(t["key"], []).append((t["ts"], t["value"]))
    exp = {}
    for k, pts in per_key.items():
        wids = set()
        for ts, _ in pts:
            last = ts // TSLIDE
            first = max(0, -(-(ts - TWIN + 1) // TSLIDE))
            wids.update(range(first, last + 1))
        for w in wids:
            vals = [v for ts, v in pts
                    if w * TSLIDE <= ts < w * TSLIDE + TWIN]
            if vals:
                exp[(k, w)] = sum(vals)
    got, op = _tb_run(wt)
    assert got == exp == _tb_run(wf)[0]
    st = op._states[0]
    assert st.spec == "key" and st.equal_across_data()
    # one ring clock a key shard: the assembled lane is [key shards]
    assert tuple(st.full()["base"].shape) == (4,)
    assert op.dump_stats()["Late_tuples_dropped"] == 0


def _reduce_fold(pkg):
    acc = {}
    src = (pkg.Source_Builder(lambda: iter(stream()))
           .withOutputBatchSize(64).build())
    op = (_b(pkg, "ReduceTPU_Builder")(
            lambda a, b: {"key": b["key"], "value": a["value"] + b["value"],
                          "ts": b["ts"]})
          .withKeyBy(lambda t: t["key"]).withMaxKeys(N_KEYS).build())
    snk = pkg.Sink_Builder(
        lambda r: acc.__setitem__(int(r["key"]), acc.get(int(r["key"]), 0)
                                  + int(r["value"]))
        if r is not None else None).build()
    g = pkg.PipeGraph("red_mesh", config=_cfg(pkg))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return acc


def test_keyed_reduce_gpu_on_mesh_fold():
    per_key = {}
    for t in stream():
        per_key[t["key"]] = per_key.get(t["key"], 0) + t["value"]
    assert _reduce_fold(wt) == per_key == _reduce_fold(wf)


def _reduce_pmax(pkg):
    got = {}
    xp = _np(pkg)
    src = (pkg.Source_Builder(
            lambda: iter({"key": i % N_KEYS, "value": -1.0 - (i % 97)}
                         for i in range(LENGTH)))
           .withOutputBatchSize(64).build())
    op = (_b(pkg, "ReduceTPU_Builder")(
            lambda a, b: {"key": xp.maximum(a["key"], b["key"]),
                          "value": xp.maximum(a["value"], b["value"])})
          .withKeyBy(lambda t: t["key"]).withMaxKeys(N_KEYS)
          .withMonoidCombiner("max").build())
    snk = pkg.Sink_Builder(
        lambda r: got.__setitem__(
            int(r["key"]), max(got.get(int(r["key"]), -1e30),
                               float(r["value"])))
        if r is not None else None).build()
    g = pkg.PipeGraph("red_mesh_pmax", config=_cfg(pkg))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return got


def test_keyed_reduce_gpu_on_mesh_pmax():
    per_key = {}
    for i in range(LENGTH):
        k, v = i % N_KEYS, -1.0 - (i % 97)
        per_key[k] = max(per_key.get(k, -1e30), v)
    assert _reduce_pmax(wt) == per_key == _reduce_pmax(wf)


def _reduce_psum(pkg):
    got = []
    src = (pkg.Source_Builder(lambda: iter({"value": i}
                                           for i in range(LENGTH)))
           .withOutputBatchSize(64).build())
    op = (_b(pkg, "ReduceTPU_Builder")(
            lambda a, b: {"value": a["value"] + b["value"]})
          .withKeyBy(lambda t: t["value"] % N_KEYS)
          .withMaxKeys(N_KEYS).withSumCombiner().build())
    snk = pkg.Sink_Builder(
        lambda r: got.append(int(r["value"])) if r is not None else None) \
        .build()
    g = pkg.PipeGraph("red_mesh_psum",
                      config=_cfg(pkg, key_aligned_ingest=False))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return got, op


def test_keyed_reduce_gpu_on_mesh_psum():
    """Data-sharded ingest pinned (key_aligned_ingest=False): each
    64-tuple batch yields its 4 keys in dense key order."""
    got, op = _reduce_psum(wt)
    assert got == _reduce_psum(wf)[0]
    assert len(got) == (LENGTH // 64) * N_KEYS
    per_key = {k: 0 for k in range(N_KEYS)}
    for j, v in enumerate(got):
        per_key[j % N_KEYS] += v
    assert per_key == {k: sum(i for i in range(LENGTH) if i % N_KEYS == k)
                       for k in range(N_KEYS)}
    assert getattr(op, "_ingest_mode", None) is None


def _global_reduce(pkg):
    got = []
    src = (pkg.Source_Builder(lambda: iter({"v": float(i)}
                                           for i in range(256)))
           .withOutputBatchSize(64).build())
    op = _b(pkg, "ReduceTPU_Builder")(
        lambda a, b: {"v": a["v"] + b["v"]}).build()
    snk = pkg.Sink_Builder(
        lambda r: got.append(float(r["v"])) if r is not None else None) \
        .build()
    g = pkg.PipeGraph("gred_mesh", config=_cfg(pkg, data=4))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return got


def test_global_reduce_gpu_on_mesh():
    got = _global_reduce(wt)
    assert sum(got) == sum(range(256))
    assert len(got) == 4   # one combined record a staged batch
    assert got == _global_reduce(wf)


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_mesh_requires_divisible_batch(pkg):
    src = (pkg.Source_Builder(lambda: iter(stream()))
           .withOutputBatchSize(60).build())      # 60 % 8 devices != 0
    g = pkg.PipeGraph("bad", config=_cfg(pkg))
    g.add_source(src) \
        .add(_b(pkg, "MapTPU_Builder")(lambda t: t).build()) \
        .add_sink(pkg.Sink_Builder(lambda r: None).build())
    with pytest.raises(pkg.WindFlowError, match="not divisible"):
        g.run()


def _arbitrary(pkg, items):
    acc = {}
    src = (pkg.Source_Builder(lambda: iter(items))
           .withOutputBatchSize(64).build())
    op = (_b(pkg, "ReduceTPU_Builder")(
            lambda a, b: {"key": b["key"], "value": a["value"] + b["value"]})
          .withKeyBy(lambda t: t["key"]).build())     # no withMaxKeys
    snk = pkg.Sink_Builder(
        lambda r: acc.__setitem__(int(r["key"]),
                                  acc.get(int(r["key"]), 0)
                                  + int(r["value"]))
        if r is not None else None).build()
    g = pkg.PipeGraph("red_mesh_arb", config=_cfg(pkg))
    g.add_source(src).add(op).add_sink(snk)
    g.run()
    return acc, op


def test_keyed_reduce_gpu_on_mesh_arbitrary_keys():
    rnd = np.random.default_rng(9)
    raw_keys = rnd.integers(-2**31, 2**31, 37).astype(np.int64)
    items = [{"key": int(raw_keys[i % len(raw_keys)]), "value": i}
             for i in range(LENGTH)]
    acc, op = _arbitrary(wt, items)
    exp = {}
    for t in items:
        exp[t["key"]] = exp.get(t["key"], 0) + t["value"]
    assert acc == exp == _arbitrary(wf, items)[0]
    assert op.num_dropped_tuples() == 0


def test_mesh_arbitrary_keys_int32_max_not_dropped():
    items = [{"key": 2**31 - 1, "value": i} for i in range(64)]
    acc, op = _arbitrary(wt, items)
    assert acc == {2**31 - 1: sum(range(64))} == _arbitrary(wf, items)[0]
    assert op.num_dropped_tuples() == 0


def test_mesh_long_stream_soak():
    n = 12_800                      # 200 staged batches of 64
    per_key = {}
    for i in range(n):
        per_key.setdefault(i % N_KEYS, []).append(i)
    count = total = 0
    for vals in per_key.values():
        w = 0
        while w * SLIDE < len(vals):
            count += 1
            total += sum(vals[w * SLIDE: w * SLIDE + WIN])
            w += 1
    got, op = _cb_run(wt, n)
    assert got == (count, total)
    assert op._states[0].equal_across_data()


def _stateful(pkg):
    zero = jnp.zeros((), jnp.float32) if pkg is wf \
        else torch.zeros((), dtype=torch.float32)
    n = 1024
    acc = {}
    src = (pkg.Source_Builder(lambda: iter({"key": i % 8, "value": float(i)}
                                           for i in range(n)))
           .withOutputBatchSize(64).build())
    sm = (_b(pkg, "MapTPU_Builder")(
            lambda t, s: ({"key": t["key"], "run": s + t["value"]},
                          s + t["value"]))
          .withInitialState(zero)
          .withKeyBy(lambda t: t["key"]).withNumKeySlots(8)
          .withDenseKeys().build())
    snk = pkg.Sink_Builder(
        lambda r: acc.__setitem__(int(r["key"]), float(r["run"]))
        if r is not None else None).build()
    g = pkg.PipeGraph("mesh_stateful", config=_cfg(pkg))
    g.add_source(src).add(sm).add_sink(snk)
    g.run()
    kept = []
    izero = jnp.zeros((), jnp.int32) if pkg is wf \
        else torch.zeros((), dtype=torch.int32)
    src2 = (pkg.Source_Builder(lambda: iter({"key": 100 + (i % 4),
                                             "value": i}
                                            for i in range(256)))
            .withOutputBatchSize(64).build())
    sf = (_b(pkg, "FilterTPU_Builder")(
            lambda t, s: ((s + 1) % 2 == 1, s + 1))
          .withInitialState(izero)
          .withKeyBy(lambda t: t["key"]).withNumKeySlots(8).build())
    snk2 = pkg.Sink_Builder(
        lambda r: kept.append(int(r["value"])) if r is not None else None) \
        .build()
    g2 = pkg.PipeGraph("mesh_stateful_f", config=_cfg(pkg))
    g2.add_source(src2).add(sf).add_sink(snk2)
    g2.run()
    return acc, sorted(kept), sm


def test_stateful_map_gpu_on_mesh_sharded_state():
    acc, kept, sm = _stateful(wt)
    assert acc == {k: sum(float(i) for i in range(1024) if i % 8 == k)
                   for k in range(8)}
    assert kept == sorted(i for i in range(256) if (i // 4) % 2 == 0)
    jacc, jkept, _ = _stateful(wf)
    assert (acc, kept) == (jacc, jkept)
    assert isinstance(sm._state, M.Sharded) and sm._state.spec == "key"


def _oor(pkg):
    zero = jnp.zeros((), jnp.float32) if pkg is wf \
        else torch.zeros((), dtype=torch.float32)
    got = []
    src = (pkg.Source_Builder(
            lambda: iter({"key": (99 if i % 3 == 0 else i % 8),
                          "value": float(i)} for i in range(192)))
           .withOutputBatchSize(64).build())
    sm = (_b(pkg, "MapTPU_Builder")(
            lambda t, s: ({"key": t["key"], "run": s + t["value"]},
                          s + t["value"]))
          .withInitialState(zero)
          .withKeyBy(lambda t: t["key"]).withNumKeySlots(8)
          .withDenseKeys().build())
    snk = pkg.Sink_Builder(
        lambda r: got.append((int(r["key"]), float(r["run"])))
        if r is not None else None).build()
    g = pkg.PipeGraph("mesh_oor", config=_cfg(pkg))
    g.add_source(src).add(sm).add_sink(snk)
    g.run()
    return got


def test_mesh_stateful_out_of_range_keys_dropped():
    got = _oor(wt)
    assert len(got) == sum(1 for i in range(192) if i % 3 != 0)
    assert all(0 <= k < 8 for k, _ in got)
    assert sorted(got) == sorted(_oor(wf))
