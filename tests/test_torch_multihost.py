"""The port's multi-process mesh layer (``windflow_tpu_torch/parallel/
multihost.py``) held against the JAX package's
(``tests/test_multihost.py``'s seven): emulated host groups place host
boundaries along the key axis, the sharded keyed steps run unchanged on
such meshes and equal JAX's on the conftest's 8 virtual devices, and a
real two-process job (gloo over localhost TCP, the CPU stand-in for
the inter-host network) runs the keyed reduce, the key-sharded window
step and a whole ``PipeGraph.run()`` across the process boundary.

Run this file as a script (``python tests/test_torch_multihost.py
<rank> <world> <port> [all|wire]``) to be one worker of that job; the
worker imports neither jax nor the JAX package."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


def test_initialize_single_process_noop():
    from windflow_tpu_torch.parallel.multihost import (initialize,
                                                       process_count)
    initialize()   # must not raise or try to contact a coordinator
    assert process_count() == 1
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_mesh_host_boundaries_on_key_axis():
    import jax
    from windflow_tpu.parallel.multihost import make_multihost_mesh as jmm
    from windflow_tpu_torch.parallel.multihost import make_multihost_mesh
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = make_multihost_mesh(local_data=2, devices=devs, emulate_hosts=2)
    jmesh = jmm(local_data=2, emulate_hosts=2)
    assert mesh.shape == jmesh.shape == {"data": 2, "key": 4}
    # host 0's devices own key columns [0, 2), host 1's [2, 4), as JAX
    jdev = {d: i for i, d in enumerate(jax.devices())}
    assert [[devs.index(d) for d in row] for row in mesh.devices] == \
        [[jdev[d] for d in row] for row in jmesh.devices]
    assert set(mesh.devices[:, :2].ravel()) == set(devs[:4])


def test_mesh_uneven_groups_rejected():
    # the error class of the raising module (a test elsewhere reloads
    # windflow_tpu_torch.basic)
    from windflow_tpu_torch.parallel import multihost
    with pytest.raises(multihost.WindFlowError, match="not divisible"):
        multihost.make_multihost_mesh(local_data=3, devices=CPU8,
                                      emulate_hosts=2)


def _reduce_batch():
    K, CAP = 16, 256
    rng = np.random.default_rng(5)
    keys = rng.integers(0, K, CAP)
    vals = rng.random(CAP)
    return K, CAP, keys, vals


def test_keyed_reduce_on_multihost_mesh():
    from windflow_tpu.batch import HostBatch as JHB
    from windflow_tpu.parallel import mesh as JM
    from windflow_tpu.parallel.multihost import make_multihost_mesh as jmm
    from windflow_tpu.parallel.multihost import stage_local as jstage
    from windflow_tpu_torch.batch import HostBatch
    from windflow_tpu_torch.parallel import mesh as M
    from windflow_tpu_torch.parallel.multihost import (make_multihost_mesh,
                                                       stage_local)
    K, CAP, keys, vals = _reduce_batch()
    recs = [{"k": int(k), "v": float(v)} for k, v in zip(keys, vals)]
    mesh = make_multihost_mesh(local_data=2, devices=CPU8, emulate_hosts=2)
    db = stage_local(HostBatch(recs, list(range(CAP)), 0), CAP, mesh)
    fn = M.make_sharded_keyed_reduce(
        mesh, CAP, K, lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]},
        key_fn=lambda t: t["k"], use_psum=False)
    table, has = fn(db.payload, db.valid)
    expected = np.zeros(K)
    for k, v in zip(keys, vals):
        expected[k] += v
    np.testing.assert_allclose(table["v"].numpy(), expected, rtol=1e-6)
    assert bool(has.all())
    jmesh = jmm(local_data=2, emulate_hosts=2)
    jdb = jstage(JHB(recs, list(range(CAP)), 0), CAP, jmesh)
    jt, _ = JM.make_sharded_keyed_reduce(
        jmesh, CAP, K, lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]},
        key_fn=lambda t: t["k"], use_psum=False)(jdb.payload, jdb.valid)
    assert table["v"].dtype == torch.float64
    np.testing.assert_array_equal(table["v"].numpy(), np.asarray(jt["v"]))


def _windows(out, fired, dst):
    f = np.asarray(fired)
    cols = {k: np.asarray(v) for k, v in out.items()}
    for i in np.nonzero(f)[0]:
        dst[(int(cols["key"][i]), int(cols["wid"][i]))] = \
            float(cols["value"][i])


@pytest.mark.parametrize("ingest", ["data", "flat"])
def test_ffat_on_multihost_mesh(ingest):
    """Key-sharded FFAT across emulated hosts equals the single-device
    step, under the data-sharded and the flat (multi-process staging)
    layouts: the flat layout's key-then-data gather rebuilds the logical
    lane order exactly (JAX's ``test_ffat_on_multihost_mesh`` and
    ``test_ffat_flat_ingest_layout``)."""
    from windflow_tpu_torch.parallel import mesh as M
    from windflow_tpu_torch.parallel.multihost import make_multihost_mesh
    from windflow_tpu_torch.windows.ffat_kernels import (make_ffat_state,
                                                         make_ffat_step)
    mesh = make_multihost_mesh(local_data=2, devices=CPU8, emulate_hosts=2)
    K, CAP, P_, R, D = 8, 64, 4, 4, 1
    lift = lambda t: t["v"]  # noqa: E731
    comb = lambda a, b: a + b  # noqa: E731
    step = M.make_sharded_ffat_step(mesh, CAP, K, P_, R, D, lift, comb,
                                    lambda t: t["k"], ingest=ingest)
    ref = make_ffat_step(CAP, K, P_, R, D, lift, comb, lambda t: t["k"])
    state = M.make_sharded_ffat_state(torch.zeros(()), K, R, mesh)
    ref_state = make_ffat_state(torch.zeros(()), K, R)
    rng = np.random.default_rng(11)
    got, exp = {}, {}
    for _ in range(6):
        payload = {"k": torch.as_tensor(rng.integers(0, K, CAP),
                                         dtype=torch.int32),
                   "v": torch.as_tensor(rng.integers(0, 100, CAP)
                                        .astype(np.float32))}
        ts = torch.arange(CAP, dtype=torch.int64)
        valid = torch.ones(CAP, dtype=torch.bool)
        state, out, fired, _ = step(state, payload, ts, valid)
        ref_state, rout, rfired, _ = ref(ref_state, payload, ts, valid)
        _windows(out, fired, got)
        _windows(rout, rfired, exp)
    assert len(exp) > 0 and got == exp


def test_world_size_one_group_carries_the_psum():
    """With a process group up at world size 1 (the card host's NCCL
    case; gloo here) the mesh's collectives exchange through
    ``torch.distributed``, and the keyed psum equals the in-process
    one."""
    import torch.distributed as dist

    from windflow_tpu_torch.parallel import mesh as M
    from windflow_tpu_torch.parallel.multihost import make_multihost_mesh
    K, CAP, keys, vals = _reduce_batch()
    payload = {"k": torch.as_tensor(keys, dtype=torch.int32),
               "v": torch.as_tensor(vals)}
    valid = torch.ones(CAP, dtype=torch.bool)
    comb = lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]}  # noqa: E731
    local = make_multihost_mesh(devices=CPU8[:4])
    assert local.group is None
    want = M.make_sharded_keyed_reduce(local, CAP, K, comb,
                                       lambda t: t["k"],
                                       use_psum=True)(payload, valid)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_multihost_mesh(devices=CPU8[:4])
        assert mesh.group is not None
        with M.recording() as rec:
            got = M.make_sharded_keyed_reduce(mesh, CAP, K, comb,
                                              lambda t: t["k"],
                                              use_psum=True)(payload, valid)
    finally:
        dist.destroy_process_group()
    assert "psum" in {r["op"] for r in rec}
    for a, b in zip(want, got):
        for n in a if isinstance(a, dict) else [None]:
            x = a[n] if n else a
            y = b[n] if n else b
            assert torch.equal(x, y)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_pair(mode: str):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(i), "2", str(port),
         mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            try:
                outs.append(p.communicate(timeout=10)[0] or "")
            except Exception:  # lint: broad-except-ok (harvest on a hang)
                outs.append("<no output harvested>")
        raise AssertionError("two-process run hung:\n" + "\n".join(outs))
    return procs, outs


def test_two_process_gloo_per_process_wire_attribution():
    """``tests/test_wire.py:536``: each process stages only its own
    lanes, and its sweep ledger's wire section says so (this process's
    share of the bytes, its index and the process count); the graph leg
    of the worker alone."""
    procs, outs = _spawn_pair("wire")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "wire ledger OK" in out, \
            f"worker {i} failed (rc={p.returncode}):\n{out[-3000:]}"


def test_two_process_gloo_reduce_ffat_and_graph():
    """Two OS processes join one gloo process group over localhost TCP,
    build the multi-process mesh, and run the keyed reduce (each staging
    only its own lanes), the key-sharded window step across the process
    boundary, and a whole ``PipeGraph.run()``; every worker checks its
    results against a local oracle and its wire ledger's share."""
    procs, outs = _spawn_pair("all")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "GLOO_WORKER_OK" in out, \
            f"worker {i} failed (rc={p.returncode}):\n{out[-3000:]}"


# ---------------------------------------------------------------------------
# the worker (one process of the two-process job)
# ---------------------------------------------------------------------------

def _worker(proc_id: int, nproc: int, port: str, mode: str) -> None:
    from windflow_tpu_torch.parallel.multihost import (initialize,
                                                       make_multihost_mesh,
                                                       process_count)
    initialize(coordinator_address=f"127.0.0.1:{port}",
               num_processes=nproc, process_id=proc_id, backend="gloo")
    assert process_count() == nproc
    mesh = make_multihost_mesh(local_data=2, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "key": 2 * nproc}, mesh.shape
    for col in range(mesh.devices.shape[1]):
        assert len(set(mesh.owners[:, col].tolist())) == 1

    if mode == "all":
        _reduce_and_window_legs(proc_id, nproc, mesh)
    _graph_leg(proc_id, nproc, mesh)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    print(f"proc {proc_id}: GLOO_WORKER_OK", flush=True)


def _reduce_and_window_legs(proc_id: int, nproc: int, mesh) -> None:
    from windflow_tpu_torch.batch import HostBatch
    from windflow_tpu_torch.parallel import mesh as M
    from windflow_tpu_torch.parallel.multihost import stage_local
    from windflow_tpu_torch.windows.ffat_kernels import (make_ffat_state,
                                                         make_ffat_step)
    # keyed reduce: each process stages only the lanes it ingested
    K, CAP = 16, 256
    rng = np.random.default_rng(5)
    keys = rng.integers(0, K, CAP)
    vals = rng.integers(0, 1000, CAP).astype(np.float64)
    lo, hi = proc_id * CAP // nproc, (proc_id + 1) * CAP // nproc
    hb = HostBatch([{"k": int(k), "v": float(v)}
                    for k, v in zip(keys[lo:hi], vals[lo:hi])],
                   list(range(lo, hi)), 0)
    db = stage_local(hb, CAP, mesh)
    fn = M.make_sharded_keyed_reduce(
        mesh, CAP, K, lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]},
        key_fn=lambda t: t["k"], use_psum=False)
    table, has = fn(db.payload, db.valid)
    expected = np.zeros(K)
    for k, v in zip(keys, vals):
        expected[k] += v
    np.testing.assert_allclose(table["v"].numpy(), expected, rtol=1e-6)
    assert bool(has.all())
    print(f"proc {proc_id}: keyed reduce across {nproc} processes OK",
          flush=True)

    # key-sharded CB windows across the process boundary: each process
    # reads its own key shards' windows
    Kf, CAPf, Pn, R, D = 8, 64, 4, 4, 1
    lift = lambda t: t["v"]  # noqa: E731
    comb = lambda a, b: a + b  # noqa: E731
    step = M.make_sharded_ffat_step(mesh, CAPf, Kf, Pn, R, D, lift, comb,
                                    lambda t: t["k"])
    state = M.make_sharded_ffat_state(torch.zeros((), dtype=torch.float32),
                                      Kf, R, mesh)
    ref = make_ffat_step(CAPf, Kf, Pn, R, D, lift, comb, lambda t: t["k"])
    ref_state = make_ffat_state(torch.zeros((), dtype=torch.float32), Kf, R)
    klo, khi = proc_id * Kf // nproc, (proc_id + 1) * Kf // nproc
    rng2 = np.random.default_rng(7)
    got_w, exp_w = {}, {}
    for _ in range(6):
        payload = {"k": torch.as_tensor(rng2.integers(0, Kf, CAPf)
                                        .astype(np.int32)),
                   "v": torch.as_tensor(rng2.integers(0, 100, CAPf)
                                        .astype(np.float32))}
        ts = torch.arange(CAPf, dtype=torch.int64)
        ok = torch.ones(CAPf, dtype=torch.bool)
        state, out, fired, _ = step(state, payload, ts, ok)
        ref_state, rout, rfired, _ = ref(ref_state, payload, ts, ok)
        _windows(out, fired, got_w)
        _windows(rout, rfired, exp_w)
    exp_w = {kw: v for kw, v in exp_w.items() if klo <= kw[0] < khi}
    assert exp_w and got_w == exp_w, (len(got_w), len(exp_w))
    print(f"proc {proc_id}: windows across {nproc} processes OK",
          flush=True)


def _graph_leg(proc_id: int, nproc: int, mesh) -> None:
    import windflow_tpu_torch as wt

    # a whole PipeGraph.run() spanning the process boundary: each
    # process's source yields its own tuples, each sink receives its own
    # key shards' windows; the oracle is the same graph on one device
    # over the logical lane order, restricted to this process's keys
    KG, OBS, NBATCH = 8, 128, 4
    local_cap = OBS // nproc
    n_local = NBATCH * local_cap

    def gen():
        for j in range(n_local):
            g = j * nproc + proc_id
            yield {"k": g % KG, "v": float(g), "ts": g * 1000}

    def graph(name, source, cfg):
        got = {}
        src = (wt.Source_Builder(source)
               .withTimestampExtractor(lambda t: t["ts"])
               .withOutputBatchSize(OBS).build())
        win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                          lambda a, b: a + b)
               .withKeyBy(lambda t: t["k"]).withMaxKeys(KG)
               .withCBWindows(16, 8).build())
        snk = wt.Sink_Builder(
            lambda r: got.__setitem__((int(r["key"]), int(r["wid"])),
                                      float(r["value"]))
            if r is not None else None).build()
        g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT, config=cfg)
        g.add_source(src).add(win).add_sink(snk)
        g.run()
        return got, g

    got, g = graph("gloo_graph", gen,
                   wt.Config(device="cpu", mesh=mesh,
                             punctuation_interval_usec=1 << 50))
    dd, kk = mesh.shape["data"], mesh.shape["key"]
    n_blk, bsz = dd * kk, OBS // (dd * kk)
    lk = kk // nproc
    blocks_of = {p: [i for i in range(n_blk) if (i % kk) // lk == p]
                 for p in range(nproc)}

    def gen_logical():
        for b in range(NBATCH):
            for blk in range(n_blk):
                p = (blk % kk) // lk
                bi = blocks_of[p].index(blk)
                for r_ in range(bsz):
                    j = b * local_cap + bi * bsz + r_
                    gidx = j * nproc + p
                    yield {"k": gidx % KG, "v": float(gidx),
                           "ts": gidx * 1000}

    ref_got, _ = graph("gloo_graph_oracle", gen_logical,
                       wt.Config(device="cpu"))
    exp_g = {kw: v for kw, v in ref_got.items()
             if proc_id * KG // nproc <= kw[0] < (proc_id + 1) * KG // nproc}
    assert got == exp_g, (proc_id, len(got), len(exp_g))
    print(f"proc {proc_id}: PipeGraph.run() across {nproc} processes OK "
          f"({len(got)} windows on local key shards)", flush=True)

    # per-process wire attribution: this process staged its own share
    # (k, v, ts payload int64 + float64 + int64, the ts lane, the mask:
    # 33 bytes a lane)
    wsec = g.stats()["Sweep"]["wire"]
    assert wsec["process_index"] == proc_id, wsec
    assert wsec["process_count"] == nproc, wsec
    assert wsec["wire_bytes"] == 33 * OBS * NBATCH // nproc, wsec
    assert wsec["logical_bytes"] == wsec["wire_bytes"], wsec
    print(f"proc {proc_id}: wire ledger OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
            sys.argv[4] if len(sys.argv) > 4 else "all")
