"""The mesh cells of the JAX package's other test files, held against the
port on an 8-position CPU mesh (the JAX side on the conftest's 8 virtual
devices):

* key-aligned mesh ingest (``tests/test_wire.py:432-536``): records
  identical on and off, the modeled inter-position bytes drop, the
  aligned emitter refuses executor moves, caps a shipped batch's
  watermark at its retained rows and ships one packed copy a batch;
* the aligned reduce and stateful identities
  (``tests/test_pallas_kernels.py:473-577``) and WF607 on a forced-on
  mesh (``:397``);
* WF401 and WF402 (``tests/test_analysis.py:167-190``);
* the shard plane's per-key-shard load and the inter-position model
  (``tests/test_shard_plane.py:271-372``) and its calibration provenance
  (``tests/test_calibration.py:287-336``);
* mesh rescale-on-restore (``tests/test_durability.py:143``, ``:187``)
  and the two cross-package mesh checkpoints;
* the multi-process staging metadata (``tests/test_staging.py:278``);
* ``mesh_analytics`` against the JAX app (``tests/test_models.py:160``).
"""

import copy
import dataclasses
import pathlib
import shutil
import warnings
from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.parallel import mesh as JM
from windflow_tpu_torch.parallel import mesh as M

CPU8 = ["cpu"] * 8


def _cfgs(aligned=True, data=2, **kw):
    """``(jax_config, port_config, key_extent)`` for an 8-way mesh."""
    jmesh = JM.make_mesh(8, data=data)
    mesh = M.make_mesh(8, data=data, devices=CPU8)
    return (dataclasses.replace(wf.default_config, mesh=jmesh,
                                key_aligned_ingest=aligned, **kw),
            wt.Config(device="cpu", mesh=mesh, key_aligned_ingest=aligned,
                      **kw),
            mesh.shape["key"])


def _run(g):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    return g


# ---------------------------------------------------------------------------
# key-aligned ingest (tests/test_wire.py)
# ---------------------------------------------------------------------------

def _mesh_window_run(pkg, aligned):
    jcfg, tcfg, kk = _cfgs(aligned)
    cap, K = 16 * 8, 4 * kk
    rng = np.random.default_rng(2)
    n = 8 * cap
    records = [{"k": int(k), "v": np.float32(v)}
               for k, v in zip(rng.integers(0, K, n),
                               rng.integers(0, 100, n))]
    fired = []
    b = wt.Ffat_WindowsGPU_Builder if pkg is wt else wf.Ffat_WindowsTPU_Builder
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(cap).build())
    win = (b(lambda t: t["v"], lambda a, b: a + b)
           .withCBWindows(8, 4).withKeyBy(lambda t: t["k"])
           .withMaxKeys(K).build())
    g = pkg.PipeGraph(f"wire_mesh_{aligned}",
                      config=tcfg if pkg is wt else jcfg)
    g.add_source(src).add(win).add_sink(
        pkg.Sink_Builder(lambda r: fired.append(r)
                         if r is not None else None).build())
    _run(g)
    sec = (g.stats().get("Shard") or {}).get("per_op") or {}
    ici = ((sec.get(win.name) or {}).get("ici") or {}) \
        .get("ici_bytes_per_tuple")
    wins = sorted((int(r["key"]), int(r["wid"]),
                   round(float(r["value"]), 4)) for r in fired)
    return wins, ici, getattr(win, "_ingest_mode", None), win


def test_key_aligned_mesh_ingest_record_identical_and_ici_drops():
    wins_a, ici_a, mode_a, win = _mesh_window_run(wt, True)
    wins_g, ici_g, mode_g, _ = _mesh_window_run(wt, False)
    assert mode_a == "aligned" and mode_g is None
    assert wins_a and wins_a == wins_g
    assert ici_a is not None and ici_g is not None and ici_a < ici_g
    assert wins_a == _mesh_window_run(wf, True)[0]
    assert win._states[0].equal_across_data()


class _Dest:
    def __init__(self):
        self.batches = []

    def add_channel(self):
        return 0

    def receive(self, ch, msg):
        self.batches.append(msg)


def test_key_aligned_refuses_executor_overrides():
    from windflow_tpu_torch.parallel import emitters
    from windflow_tpu_torch.parallel.emitters import AlignedMeshStageEmitter
    WindFlowError = emitters.WindFlowError   # the raising module's class
    mesh = M.make_mesh(8, data=1, devices=CPU8)
    kk = mesh.shape[M.KEY_AXIS]
    em = AlignedMeshStageEmitter([(_Dest(), 0)], 8 * kk,
                                 lambda t: t["k"], mesh, 8 * kk)
    with pytest.raises(WindFlowError, match="rescale-on-restore"):
        em.set_override({5: kk - 1})
    em.set_override(None)       # clearing is a no-op, never a raise
    em.set_override({})


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_key_aligned_skew_retention_caps_watermark(pkg):
    """A hot column that fills while the others buffer: the shipped
    batch's watermark caps at the retained rows' oldest timestamp."""
    if pkg == "port":
        from windflow_tpu_torch.parallel.emitters import \
            AlignedMeshStageEmitter
        mesh = M.make_mesh(8, data=1, devices=CPU8)
    else:
        from windflow_tpu.parallel.emitters import AlignedMeshStageEmitter
        mesh = JM.make_mesh(8, data=1)
    kk = mesh.shape["key"]
    obs = 8 * kk
    col_cap = obs // kk
    dest = _Dest()
    em = AlignedMeshStageEmitter([(dest, 0)], obs, lambda t: t["k"],
                                 mesh, kk)      # K_local = 1: key == column
    m = col_cap + 3
    em.emit_columns({"k": np.zeros(m, np.int64),
                     "v": np.arange(m, dtype=np.float32)},
                    np.arange(100, 100 + m, dtype=np.int64), wm=10**6)
    assert dest.batches, "a hot column must force a ship"
    db = dest.batches[0]
    retained_min_ts = 100 + col_cap
    assert db.watermark <= retained_min_ts
    assert db.frontier <= retained_min_ts
    em.flush(10**6)
    total = sum(int(np.asarray(b.valid).sum()) for b in dest.batches)
    assert total == m                           # nothing lost
    assert dest.batches[-1].watermark == 10**6


@pytest.mark.parametrize("data", [1, 2])
def test_key_aligned_emitter_ships_one_packed_copy_a_batch(monkeypatch,
                                                           data):
    """The aligned emitter stages through the packed copy: one buffer a
    batch, its per-block validity riding it, every row in a block of
    its owner's column, nothing lost."""
    from windflow_tpu_torch import batch as B
    from windflow_tpu_torch.parallel.emitters import AlignedMeshStageEmitter
    mesh = M.make_mesh(8, data=data, devices=CPU8)
    kk, dd = mesh.shape["key"], mesh.shape["data"]
    obs = 4 * kk * dd
    blk = obs // (kk * dd)
    packed = []
    real = B.stage_packed
    monkeypatch.setattr(B, "stage_packed",
                        lambda *a, **k: packed.append(1) or real(*a, **k))
    dest = _Dest()
    em = AlignedMeshStageEmitter([(dest, 0)], obs, lambda t: t["k"], mesh,
                                 2 * kk)        # K_local = 2
    rng = np.random.default_rng(7)
    m = 3 * obs
    k = rng.integers(0, 2 * kk, m)
    v = rng.integers(0, 100, m).astype(np.float32)
    em.emit_columns({"k": k, "v": v}, np.arange(m, dtype=np.int64), wm=0)
    em.flush(10**6)
    shipped = [b for b in dest.batches if isinstance(b, B.DeviceBatch)]
    assert shipped and len(packed) == len(shipped)
    col = (np.arange(obs) // blk) % kk
    got = []
    for db in shipped:
        on = db.valid.numpy()
        assert db.valid.dtype == torch.bool and db.size == int(on.sum())
        keys = db.payload["k"].numpy()
        assert (keys[on] // 2 == col[on]).all()
        ts = db.ts.numpy()[on]
        assert (db.ts_min, db.ts_max) == (int(ts.min()), int(ts.max()))
        got += zip(keys[on].tolist(), db.payload["v"].numpy()[on].tolist(),
                   ts.tolist())
    assert sorted(got) == sorted(zip(k.tolist(), v.tolist(), range(m)))
    assert not all(b.valid.all() for b in shipped)    # holes in a layout


@pytest.mark.parametrize("lane", ["float32", "int16"])
def test_columns_to_device_with_a_host_mask(lane):
    """Columns laid out with holes stage under their host mask, on the
    packed copy (4-byte lanes) and lane by lane (an int16 lane): the
    valid lanes, their count and their timestamp extrema."""
    from windflow_tpu_torch.batch import columns_to_device
    cap = 16
    rng = np.random.default_rng(11)
    mask = rng.random(cap) < 0.5
    vals = rng.integers(0, 100, cap).astype(lane)
    tss = rng.integers(0, 1000, cap).astype(np.int64)
    db = columns_to_device({"v": vals}, tss, cap, torch.device("cpu"),
                           mask=mask)
    assert torch.equal(db.valid, torch.from_numpy(mask))
    assert db.size == int(mask.sum())
    assert np.array_equal(db.payload["v"].numpy()[mask], vals[mask])
    assert np.array_equal(db.ts.numpy(), tss)
    assert (db.ts_min, db.ts_max) == (int(tss[mask].min()),
                                      int(tss[mask].max()))


# ---------------------------------------------------------------------------
# aligned reduce / stateful identities, WF607 (tests/test_pallas_kernels.py)
# ---------------------------------------------------------------------------

def _mesh_reduce_max(pkg, aligned, keys=None):
    jcfg, tcfg, kk = _cfgs(aligned)
    cap, K = 16 * 8, 4 * kk
    rng = np.random.default_rng(5 if keys is None else 9)
    if keys is None:
        keys = rng.integers(0, K, 6 * cap)
        vals = -1.0 - rng.integers(0, 97, 6 * cap).astype(float)
    else:
        keys = rng.integers(-3, K + 3, 4 * cap)
        vals = -1.0 - (np.arange(len(keys)) % 7).astype(float)
    records = [{"key": int(k), "value": float(v)}
               for k, v in zip(keys, vals)]
    mx = torch.maximum if pkg is wt else jnp.maximum
    b = wt.ReduceGPU_Builder if pkg is wt else wf.ReduceTPU_Builder
    outs = []
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(cap).build())
    red = (b(lambda a, b: {"key": mx(a["key"], b["key"]),
                           "value": mx(a["value"], b["value"])})
           .withKeyBy(lambda t: t["key"]).withMaxKeys(K)
           .withMonoidCombiner("max").build())
    g = pkg.PipeGraph(f"amr_{aligned}", config=tcfg if pkg is wt else jcfg)
    g.add_source(src).add(red).add_sink(
        pkg.Sink_Builder(lambda t: outs.append(
            (int(t["key"]), float(t["value"])))
            if t is not None else None).build())
    _run(g)
    agg = {}
    for k, v in outs:
        agg[k] = max(agg.get(k, -1e30), v)
    ici = (((g.stats().get("Shard") or {}).get("per_op") or {})
           .get(red.name) or {}).get("ici") or {}
    return agg, getattr(red, "_ingest_mode", None), ici, red, outs


def test_aligned_mesh_dense_reduce_identical_and_collective_drops():
    a, mode_a, ici_a, _, _ = _mesh_reduce_max(wt, True)
    b, mode_b, ici_b, _, _ = _mesh_reduce_max(wt, False)
    assert mode_a == "aligned" and mode_b is None
    assert a and a == b == _mesh_reduce_max(wf, True)[0]
    assert "key-aligned" in ici_a.get("collective", "")
    assert "psum" in ici_b.get("collective", "")
    assert ici_a["ici_bytes_per_tuple"] < ici_b["ici_bytes_per_tuple"]


def _generic_reduce(pkg, aligned):
    jcfg, tcfg, kk = _cfgs(aligned)
    cap, K = 16 * 8, 4 * kk
    rng = np.random.default_rng(6)
    records = [{"key": int(k), "value": int(v)}
               for k, v in zip(rng.integers(0, K, 6 * cap),
                               rng.integers(0, 97, 6 * cap))]
    outs = []
    b = wt.ReduceGPU_Builder if pkg is wt else wf.ReduceTPU_Builder
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(cap).build())
    red = (b(lambda a, b: {"key": a["key"], "value": a["value"] + b["value"]})
           .withKeyBy(lambda t: t["key"]).withMaxKeys(K).build())
    g = pkg.PipeGraph(f"agr_{aligned}", config=tcfg if pkg is wt else jcfg)
    g.add_source(src).add(red).add_sink(
        pkg.Sink_Builder(lambda t: outs.append(
            (int(t["key"]), int(t["value"])))
            if t is not None else None).build())
    _run(g)
    agg = defaultdict(int)
    for k, v in outs:
        agg[k] += v
    return dict(agg), getattr(red, "_ingest_mode", None)


def test_aligned_mesh_generic_reduce_identical():
    a, ma = _generic_reduce(wt, True)
    b, mb = _generic_reduce(wt, False)
    assert ma == "aligned" and mb is None
    assert a and a == b == _generic_reduce(wf, True)[0]


def _stateful(pkg, aligned, is_filter):
    jcfg, tcfg, kk = _cfgs(aligned)
    cap, S = 16 * 8, 4 * kk
    rng = np.random.default_rng(7 + is_filter)
    records = [{"k": int(k), "v": int(v)}
               for k, v in zip(rng.integers(0, S, 5 * cap),
                               rng.integers(0, 100, 5 * cap))]
    outs = []
    init = torch.zeros((), dtype=torch.int64) if pkg is wt \
        else jnp.int64(0)
    mb = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
    fb = wt.FilterGPU_Builder if pkg is wt else wf.FilterTPU_Builder
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(cap).build())
    if is_filter:
        op = (fb(lambda t, s: ((s + t["v"]) % 3 != 0, s + t["v"]))
              .withInitialState(init).withKeyBy(lambda t: t["k"])
              .withNumKeySlots(S).withDenseKeys().build())
    else:
        op = (mb(lambda t, s: ({"k": t["k"], "v": s + t["v"]}, s + t["v"]))
              .withInitialState(init).withKeyBy(lambda t: t["k"])
              .withNumKeySlots(S).withDenseKeys().build())
    g = pkg.PipeGraph(f"ams_{aligned}_{is_filter}",
                      config=tcfg if pkg is wt else jcfg)
    g.add_source(src).add(op).add_sink(
        pkg.Sink_Builder(lambda t: outs.append((int(t["k"]), int(t["v"])))
                         if t is not None else None).build())
    _run(g)
    per_key = defaultdict(list)
    for k, v in outs:
        per_key[k].append(v)
    return dict(per_key), getattr(op, "_ingest_mode", None)


@pytest.mark.parametrize("is_filter", [False, True])
def test_aligned_mesh_dense_stateful_identical(is_filter):
    a, ma = _stateful(wt, True, is_filter)
    b, mb = _stateful(wt, False, is_filter)
    assert ma == "aligned" and mb is None
    assert a and a == b == _stateful(wf, True, is_filter)[0]


def test_aligned_mesh_reduce_drops_out_of_range_keys():
    """Out-of-range keys clip onto an edge column on the host and mask
    out on the device: dropped and counted as the dense-table contract
    says, in both packages."""
    _, mode, _, red, outs = _mesh_reduce_max(wt, True, keys="oor")
    _, _, _, jred, jouts = _mesh_reduce_max(wf, True, keys="oor")
    assert mode == "aligned"
    K = 4 * 4
    assert all(0 <= k < K for k, _ in outs)
    assert sorted(outs) == sorted(jouts)
    assert red.num_dropped_tuples() == jred.num_dropped_tuples() > 0


def test_wf607_forced_on_mesh():
    """JAX's mesh steps keep the lax bodies, so forcing the Pallas
    kernels on a mesh is named (WF607 "mesh").  The port's sharded steps
    launch the grouping and fold kernels per key shard, so the port names
    no mesh downgrade; on the CPU it names only that no kernel builds."""
    jcfg, tcfg, kk = _cfgs(True)
    found = {}
    for pkg, cfg in ((wf, dataclasses.replace(jcfg, pallas_kernels="1")),
                     (wt, dataclasses.replace(tcfg, cuda_kernels="1"))):
        b = (wt.Ffat_WindowsGPU_Builder if pkg is wt
             else wf.Ffat_WindowsTPU_Builder)
        src = (pkg.Source_Builder(lambda: iter(()))
               .withOutputBatchSize(16 * 8).build())
        w = (b(lambda t: t["v"], lambda a, b: a + b)
             .withCBWindows(8, 4).withKeyBy(lambda t: t["k"])
             .withMaxKeys(4 * kk).withSumCombiner().build())
        g = pkg.PipeGraph("wf607m", config=cfg)
        g.add_source(src).add(w).add_sink(
            pkg.Sink_Builder(lambda r: None).build())
        found[pkg] = [d for d in g.check() if d.code == "WF607"]
    assert found[wf] and "mesh" in found[wf][0].message
    assert found[wt] and not any("mesh" in d.message for d in found[wt])
    assert "CPU" in found[wt][0].message


# ---------------------------------------------------------------------------
# WF401 / WF402 (tests/test_analysis.py)
# ---------------------------------------------------------------------------

def _rec_src(pkg, cap):
    return (pkg.Source_Builder(lambda: iter(()))
            .withOutputBatchSize(cap)
            .withRecordSpec({"k": np.int32(0), "v": np.float32(0.0)})
            .build())


def test_mesh_indivisible_batch_wf401():
    jcfg, tcfg, _ = _cfgs()
    for pkg, cfg in ((wt, tcfg), (wf, jcfg)):
        mb = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
        g = pkg.PipeGraph("mesh_bad", config=cfg)
        g.add_source(_rec_src(pkg, 60)).add(
            mb(lambda t: dict(t)).build()).add_sink(
            pkg.Sink_Builder(lambda r: None).build())
        ds = [d for d in g.check() if d.code == "WF401"]
        assert ds and "not divisible" in ds[0].message


def test_mesh_indivisible_keyspace_wf402():
    jcfg, tcfg, _ = _cfgs()
    for pkg, cfg in ((wt, tcfg), (wf, jcfg)):
        b = (wt.Ffat_WindowsGPU_Builder if pkg is wt
             else wf.Ffat_WindowsTPU_Builder)
        op = (b(lambda t: t["v"], lambda a, b: a + b)
              .withCBWindows(4, 2).withKeyBy(lambda t: t["k"])
              .withMaxKeys(3).build())      # the key axis is 4
        g = pkg.PipeGraph("mesh_keys", config=cfg)
        g.add_source(_rec_src(pkg, 64)).add(op).add_sink(
            pkg.Sink_Builder(lambda r: None).build())
        assert "WF402" in {d.code for d in g.check()}


def test_keyed_state_without_rebucketing_rule_wf604(tmp_path):
    """On a mesh with durability on, a keyed operator that checkpoints
    state of an unknown kind is WF604 in both packages."""
    jcfg, tcfg, _ = _cfgs(durability=str(tmp_path / "ck"))
    for pkg, cfg in ((wt, tcfg), (wf, jcfg)):
        red = (pkg.Reduce_Builder(lambda t, acc: acc, 0)
               .withKeyBy(lambda t: t["k"]).build())

        class _Custom(type(red)):
            def snapshot_state(self):
                return {"kind": "custom"}
        red.__class__ = _Custom
        g = pkg.PipeGraph("wf604", config=cfg)
        g.add_source(_rec_src(pkg, 64)).add(red).add_sink(
            pkg.Sink_Builder(lambda r: None).build())
        assert "WF604" in {d.code for d in g.check()}, pkg


# ---------------------------------------------------------------------------
# shard plane and calibration (tests/test_shard_plane.py,
# tests/test_calibration.py)
# ---------------------------------------------------------------------------

def _zipf_keys(n, n_keys, hot, share, seed=5):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, n_keys, n)
    ks[rng.random(n) < share] = hot
    return ks


def _mesh_shard_graph(aligned=True):
    _, cfg, _ = _cfgs(aligned)
    ks = _zipf_keys(8 * 128, 16, 3, 0.5)
    src = (wt.Source_Builder(lambda: iter(
        {"key": int(k), "v": float(i)} for i, k in enumerate(ks)))
        .withOutputBatchSize(128).build())
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
           .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
           .withMaxKeys(16).withName("mwin").build())
    g = wt.PipeGraph("mesh_shard", wt.ExecutionMode.DEFAULT, config=cfg)
    g.add_source(src).add(win).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    return g, ks


def test_mesh_key_shard_attribution_and_ici_model():
    g, ks = _mesh_shard_graph()
    _run(g)
    entry = g.stats()["Shard"]["per_op"]["mwin"]
    load = entry["load"]
    assert load["placement"] == "dense_range"
    assert load["basis"] == "exact"
    expected = np.bincount(ks, minlength=16).reshape(4, 4).sum(axis=1)
    assert load["tuples"] == [int(c) for c in expected]
    assert load["hot_shard"] == 0
    assert load["hot_keys"][0]["key"] == 3
    assert load["hot_keys"][0]["shard"] == 0
    ici = entry["ici"]
    assert ici["collective"] == "all_gather(data|key-aligned)"
    assert ici["mesh"] == {"data": 2, "key": 4}
    assert ici["ici_bytes_per_tuple"] > 0
    assert g.stats()["Shard"]["totals"]["ici_bytes_per_tuple"] > 0
    g2, _ = _mesh_shard_graph(aligned=False)
    _run(g2)
    ici2 = g2.stats()["Shard"]["per_op"]["mwin"]["ici"]
    assert ici2["collective"] == "all_gather(data)"
    assert ici2["ici_bytes_per_tuple"] > ici["ici_bytes_per_tuple"]


def test_mesh_arbitrary_keys_mod_placement():
    _, cfg, _ = _cfgs()
    ks = _zipf_keys(8 * 128, 1 << 20, 9, 0.5, seed=3)
    src = (wt.Source_Builder(lambda: iter(
        {"key": int(k), "v": 1.0} for k in ks))
        .withOutputBatchSize(128).build())
    red = (wt.ReduceGPU_Builder(
        lambda a, b: {"key": b["key"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["key"]).withName("arb").build())
    g = wt.PipeGraph("mesh_arb", wt.ExecutionMode.DEFAULT, config=cfg)
    g.add_source(src).add(red).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    _run(g)
    load = g.stats()["Shard"]["per_op"]["arb"]["load"]
    assert load["placement"] == "mod" and load["n_shards"] == 8
    expected = np.bincount((ks.astype(np.int64) & 0xFFFFFFFF) % 8,
                           minlength=8)
    assert load["tuples"] == [int(c) for c in expected]
    assert load["hot_shard"] == int(expected.argmax())
    assert load["hot_keys"][0]["key"] == 9
    assert load["hot_keys"][0]["shard"] == 9 % 8


def test_shard_ici_model_provenance_flips_calibrated():
    import time

    from windflow_tpu_torch.monitoring import calibration as cal
    cal.set_default_store(None)
    try:
        g, _ = _mesh_shard_graph()
        _run(g)
        sec = g.stats()["Shard"]
        ici = sec["per_op"]["mwin"]["ici"]
        assert ici["provenance"] == "modeled"
        assert ici["ici_bandwidth_provenance"] == "modeled"
        assert ici["ici_bandwidth_assumed_bps"] == \
            cal.MODELED_DEFAULTS["ici_bytes_per_sec"]
        assert sec["totals"]["ici_time_provenance"] == "modeled"
        usec_modeled = ici["ici_usec_per_dispatch"]
        cal.set_default_store(cal.CalibrationStore({
            "schema": cal.SCHEMA, "recorded_at": time.time(),
            "device_kind": "cpu", "backend": "cpu",
            "jax_version": "torch test", "torch_version": torch.__version__,
            "constants": {"ici_bytes_per_sec": 42e9,
                          "h2d_tunnel_bytes_per_sec": 1e9,
                          "hbm_bytes_per_sec": 5e9,
                          "dispatch_overhead_usec": 8.0,
                          "sampled_sync_usec": 30.0,
                          "kernel_step_usec": 10.0}}, path="<test>"))
        sec = g.stats()["Shard"]
        ici = sec["per_op"]["mwin"]["ici"]
        assert cal.is_calibrated(ici["ici_bandwidth_provenance"])
        assert ici["ici_bandwidth_assumed_bps"] == 42e9
        assert ici["provenance"] == "modeled"
        assert cal.is_calibrated(sec["totals"]["ici_time_provenance"])
        assert ici["ici_usec_per_dispatch"] > usec_modeled
    finally:
        cal.set_default_store(None)


# ---------------------------------------------------------------------------
# mesh rescale-on-restore (tests/test_durability.py) and the cross-package
# mesh checkpoints
# ---------------------------------------------------------------------------

def test_rescale_restore_mesh_cb_fewer_chips(tmp_path):
    """CB windows key-sharded over 4 positions, killed mid-epoch and
    restored on 2: every fired window equals the uninterrupted run's, in
    both packages."""
    from windflow_tpu.durability import chaos as jchaos
    from windflow_tpu_torch.durability import chaos
    v = chaos.run_rescale_ab(
        "window_cb", "mid_epoch", str(tmp_path / "port"), shards_kill=1,
        shards_restore=1, mesh_kill=M.make_mesh(4, devices=CPU8[:4]),
        mesh_restore=M.make_mesh(2, devices=CPU8[:2]), n=4096,
        device="cpu")
    assert v["diff"] is None, v["diff"]
    assert v["mesh"] == "1x4->1x2"
    jv = jchaos.run_rescale_ab(
        "window_cb", "mid_epoch", str(tmp_path / "jax"), shards_kill=1,
        shards_restore=1, mesh_kill=JM.make_mesh(4),
        mesh_restore=JM.make_mesh(2), n=4096)
    assert jv["diff"] is None and jv["records"] == v["records"]


@pytest.mark.parametrize("family,kk_kill,kk_restore", [
    ("window_cb", 2, 4),
    ("window_tb", 4, 2),
    ("window_tb", 2, 4),
])
def test_rescale_matrix_mesh(tmp_path, family, kk_kill, kk_restore):
    """CB and TB windows killed on one mesh and restored on another, TB
    through the per-shard clock lanes' re-shaping."""
    from windflow_tpu_torch.durability import chaos
    n = 4096 if family != "window_tb" else 6558
    v = chaos.run_rescale_ab(
        family, "mid_epoch", str(tmp_path), shards_kill=1, shards_restore=1,
        mesh_kill=M.make_mesh(kk_kill, devices=CPU8[:kk_kill]),
        mesh_restore=M.make_mesh(kk_restore, devices=CPU8[:kk_restore]),
        n=n, device="cpu")
    assert v["diff"] is None, v["diff"]
    assert v["mesh"] == f"1x{kk_kill}->1x{kk_restore}"


def _partial(make, d, mesh, steps, **kw):
    cell = make("window_cb", str(d / "ck"), out_dir=str(d / "out"),
                n=4096, mesh=mesh, **kw)
    g = cell["factory"]()
    g.start()
    for _ in range(steps):
        g.step()
    return g


def _suffix(make, pending, d, mesh, **kw):
    shutil.rmtree(d, ignore_errors=True)
    cell = make("window_cb", str(d / "ck"), out_dir=str(d / "out"),
                n=4096, mesh=mesh, **kw)
    g = cell["factory"]()
    g._pending_restore = dict(copy.deepcopy(pending), rescaled=True)
    g.start()
    g.wait_end()
    return cell["read"]()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_mesh_checkpoint_restores_on_fewer_shards(
        tmp_path, writer):
    """A mesh checkpoint (4 key shards) written by one package restores
    in both on a 2-shard mesh: the manifests pin the same shape, and the
    two restored suffixes are record-for-record equal."""
    from windflow_tpu.durability import chaos as jchaos
    from windflow_tpu.durability.checkpoint import load_checkpoint as jload
    from windflow_tpu_torch.durability import chaos
    from windflow_tpu_torch.durability.checkpoint import \
        load_checkpoint as tload
    tmp = pathlib.Path(tmp_path)
    if writer == "jax":
        _partial(jchaos.make_cell, tmp / "w", JM.make_mesh(4), 8)
        pending = jload(str(tmp / "w" / "ck"))
    else:
        _partial(chaos.make_cell, tmp / "w",
                 M.make_mesh(4, devices=CPU8[:4]), 8, device="cpu")
        pending = tload(str(tmp / "w" / "ck"))
    assert pending["manifest"]["mesh"] == {"devices": 4, "data": 1,
                                           "key": 4}
    assert pending["epoch"] >= 1
    jout = _suffix(jchaos.make_cell, pending, tmp / "j", JM.make_mesh(2))
    tout = _suffix(chaos.make_cell, pending, tmp / "t",
                   M.make_mesh(2, devices=CPU8[:2]), device="cpu")
    assert chaos.diff_records(jout, tout) is None
    assert sum(len(p) for p in tout) > 0


# ---------------------------------------------------------------------------
# multi-process staging metadata (tests/test_staging.py:278), the app
# ---------------------------------------------------------------------------

def test_multihost_stage_attaches_no_ts_extrema(monkeypatch):
    """Across processes each one sees only its own lanes' timestamp
    extrema: the TB ring's span regrow must not act on them (its growth
    would desynchronize the shards' ring shapes), while one process
    grows from the same batch."""
    import types

    from windflow_tpu_torch.parallel import multihost
    items = [{"key": 0, "value": 1, "ts": i * 1000} for i in range(64)]
    src = (wt.Source_Builder(lambda: iter(items))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(16).build())
    op = (wt.Ffat_WindowsGPU_Builder(lambda t: t["value"],
                                     lambda a, b: a + b)
          .withTBWindows(8_000, 2_000).withKeyBy(lambda t: t["key"])
          .withMaxKeys(8).build())
    g = wt.PipeGraph("mh_skip", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT,
                     config=wt.Config(device="cpu",
                                      mesh=M.make_mesh(8, devices=CPU8)))
    g.add_source(src).add(op).add_sink(wt.Sink_Builder(lambda r: None)
                                       .build())
    _run(g)
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
    assert op._states[0].equal_across_data()


def test_mesh_analytics_matches_jax_app():
    import random

    from windflow_tpu.models import mesh_analytics as japp
    from windflow_tpu_torch.models import mesh_analytics as tapp
    n, keys = 4096, 16
    rnd = random.Random(23)
    records = [{"k": i % keys, "v": float(rnd.randint(-40, 100))}
               for i in range(n)]
    kw = dict(n_devices=8, data_axis=2, win_len=16, slide=8, max_keys=keys,
              batch=512)
    got = tapp.run(records, config=wt.Config(device="cpu"), devices=CPU8,
                   **kw)
    exp = japp.run(records, **kw)
    assert got and sorted(got) == sorted(exp)
