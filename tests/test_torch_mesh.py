"""The port's mesh layer (``windflow_tpu_torch/parallel/mesh.py``) held
against the JAX package's (``tests/test_mesh.py``): the same numpy-seeded
batches go through JAX's sharded steps on the conftest's 8 virtual CPU
devices and through the port's on an 8-position CPU mesh
(``make_mesh(8, devices=["cpu"] * 8)``), and the records, their dtypes
and the host oracles are compared.

Not applicable to the port, by the JAX test they twin:

* ``test_scaling_harness_loop_body`` and
  ``test_scaling_harness_refuses_virtual_mesh``: they drive JAX's
  ``bench.py`` scaling harness; the port's benchmark (``bench_cuda.py``)
  does not exist yet.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.parallel import mesh as JM
from windflow_tpu_torch.parallel import mesh as M

NOT_APPLICABLE = {
    "test_scaling_harness_loop_body": "JAX's bench.py scaling harness",
    "test_scaling_harness_refuses_virtual_mesh":
        "JAX's bench.py scaling harness",
}

CPU8 = ["cpu"] * 8


def _mesh(data):
    return M.make_mesh(8, data=data, devices=CPU8)


def _rand_batch(cap, K, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, cap)
    vals = rng.integers(0, 100, cap).astype(np.float32)
    return keys, vals


def _jput(mesh, payload, valid, spec):
    sh = jax.sharding.NamedSharding(mesh, spec)
    return (jax.tree.map(lambda a: jax.device_put(a, sh), payload),
            jax.device_put(valid, sh))


def _jax_reduce(data, keys, vals, K, comb, **kw):
    mesh = JM.make_mesh(8, data=data)
    payload = {"k": jnp.asarray(keys, jnp.int32), "v": jnp.asarray(vals)}
    payload, valid = _jput(mesh, payload, jnp.ones(len(keys), bool),
                           jax.sharding.PartitionSpec(("data", "key")))
    red = JM.make_sharded_keyed_reduce(mesh, len(keys), K, comb,
                                       lambda x: x["k"], **kw)
    table, has = red(payload, valid)
    return ({n: np.asarray(a) for n, a in table.items()}, np.asarray(has))


def _port_reduce(data, keys, vals, K, comb, **kw):
    mesh = _mesh(data)
    payload = {"k": torch.as_tensor(keys, dtype=torch.int32),
               "v": torch.as_tensor(vals)}
    red = M.make_sharded_keyed_reduce(mesh, len(keys), K, comb,
                                      lambda x: x["k"], **kw)
    table, has = red(payload, torch.ones(len(keys), dtype=torch.bool))
    return ({n: a.numpy() for n, a in table.items()}, has.numpy())


def _same_tables(jt, jh, pt, ph):
    np.testing.assert_array_equal(ph, jh)
    for n in jt:
        assert pt[n].dtype == jt[n].dtype, n
        np.testing.assert_array_equal(pt[n][ph], jt[n][jh])


def test_make_mesh_surface_and_refusals():
    mesh = _mesh(2)
    assert mesh.shape == {"data": 2, "key": 4}
    assert mesh.axis_names == ("data", "key")
    assert mesh.devices.shape == (2, 4) and mesh.devices.dtype == object
    with pytest.raises(M.WindFlowError, match="requested 9 devices"):
        M.make_mesh(9, devices=CPU8)
    with pytest.raises(M.WindFlowError, match="not divisible by data=3"):
        M.make_mesh(8, data=3, devices=CPU8)
    jm = JM.make_mesh(8, data=2)
    assert jm.shape == mesh.shape


@pytest.mark.parametrize("data", [1, 2])
def test_sharded_keyed_reduce_psum(data):
    cap, K = 64, 16
    keys, vals = _rand_batch(cap, K)
    jcomb = lambda a, b: {"k": b["k"], "v": a["v"] + b["v"]}  # noqa: E731
    jt, jh = _jax_reduce(data, keys, vals, K, jcomb, use_psum=True)
    pt, ph = _port_reduce(data, keys, vals, K, jcomb, use_psum=True)
    expect = np.zeros(K)
    for k, v in zip(keys, vals):
        expect[k] += v
    np.testing.assert_allclose(pt["v"][ph], expect[ph], rtol=1e-6)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pt["v"][ph], jt["v"][jh])


@pytest.mark.parametrize("monoid", ["max", "min"])
def test_sharded_keyed_reduce_monoid_collective(monoid):
    """pmax/pmin on strictly negative values (a zero identity would win)
    with the key leaf surviving the collective intact."""
    cap, K = 64, 16
    keys, vals = _rand_batch(cap, K)
    vals = -1.0 - vals
    jop = jnp.maximum if monoid == "max" else jnp.minimum
    top = torch.maximum if monoid == "max" else torch.minimum
    jt, jh = _jax_reduce(2, keys, vals, K,
                         lambda a, b: {"k": b["k"], "v": jop(a["v"], b["v"])},
                         monoid=monoid)
    pt, ph = _port_reduce(2, keys, vals, K,
                          lambda a, b: {"k": b["k"], "v": top(a["v"], b["v"])},
                          monoid=monoid)
    _same_tables(jt, jh, pt, ph)
    np.testing.assert_array_equal(pt["k"][ph], np.arange(K)[ph])
    seen = np.zeros(K, bool)
    seen[keys] = True
    np.testing.assert_array_equal(ph, seen)


def test_sharded_keyed_reduce_generic_fold():
    cap, K = 64, 16
    keys, vals = _rand_batch(cap, K)
    jt, jh = _jax_reduce(
        2, keys, vals, K,
        lambda a, b: {"k": b["k"], "v": jnp.maximum(a["v"], b["v"])})
    pt, ph = _port_reduce(
        2, keys, vals, K,
        lambda a, b: {"k": b["k"], "v": torch.maximum(a["v"], b["v"])})
    _same_tables(jt, jh, pt, ph)


def _fired(out, fired):
    f = np.asarray(fired)
    return sorted(zip(np.asarray(out["key"])[f].tolist(),
                      np.asarray(out["wid"])[f].tolist(),
                      np.asarray(out["value"])[f].tolist()))


@pytest.mark.parametrize("data,win,slide", [(1, 8, 4), (2, 8, 4), (2, 6, 2)])
def test_sharded_ffat_matches_host_oracle_and_jax(data, win, slide):
    cap, K = 64, 16
    keys, vals = _rand_batch(cap, K, seed=3)
    Pn = math.gcd(win, slide)
    R, D = win // Pn, slide // Pn
    jmesh = JM.make_mesh(8, data=data)
    jp, jv = _jput(jmesh, {"k": jnp.asarray(keys, jnp.int32),
                           "v": jnp.asarray(vals)},
                   jnp.ones(cap, bool), jax.sharding.PartitionSpec("data"))
    jstate = JM.make_sharded_ffat_state(jnp.zeros((), jnp.float32), K, R,
                                        jmesh)
    jstep = JM.make_sharded_ffat_step(jmesh, cap, K, Pn, R, D,
                                      lambda x: x["v"], lambda a, b: a + b,
                                      lambda x: x["k"])
    jts = jax.device_put(jnp.arange(cap, dtype=jnp.int64),
                         JM.batch_sharding(jmesh))
    mesh = _mesh(data)
    pp, pts, pv = M.stage_batch(
        {"k": torch.as_tensor(keys, dtype=torch.int32),
         "v": torch.as_tensor(vals)},
        torch.arange(cap, dtype=torch.int64),
        torch.ones(cap, dtype=torch.bool), mesh)
    pstate = M.make_sharded_ffat_state(torch.zeros((), dtype=torch.float32),
                                       K, R, mesh)
    pstep = M.make_sharded_ffat_step(mesh, cap, K, Pn, R, D,
                                     lambda x: x["v"], lambda a, b: a + b,
                                     lambda x: x["k"])
    got, jgot = [], []
    for _ in range(2):
        jstate, jout, jf, _ = jstep(jstate, jp, jts, jv)
        pstate, pout, pf, _ = pstep(pstate, pp, pts, pv)
        jgot += _fired(jout, jf)
        got += _fired(pout, pf)
        assert pout["value"].dtype == torch.float32
    assert pstate.equal_across_data()
    per_key = {}
    for _ in range(2):
        for k, v in zip(keys, vals):
            per_key.setdefault(int(k), []).append(float(v))
    exp = []
    for k, vs in per_key.items():
        for end in range(win, len(vs) + 1, slide):
            exp.append((k, (end - win) // slide, sum(vs[end - win:end])))
    assert sorted(got) == sorted(exp) == sorted(jgot)


def test_sharded_ffat_matches_single_chip():
    """The sharded step and the single-device step agree bit for bit on
    fired windows (resharding must not change results)."""
    from windflow_tpu_torch.windows.ffat_kernels import (make_ffat_state,
                                                         make_ffat_step)
    cap, K, win, slide = 32, 8, 4, 2
    keys, vals = _rand_batch(cap, K, seed=7)
    Pn = math.gcd(win, slide)
    R, D = win // Pn, slide // Pn
    payload = {"k": torch.as_tensor(keys, dtype=torch.int32),
               "v": torch.as_tensor(vals)}
    valid = torch.ones(cap, dtype=torch.bool)
    ts = torch.arange(cap, dtype=torch.int64)
    ref = make_ffat_step(cap, K, Pn, R, D, lambda x: x["v"],
                         lambda a, b: a + b, lambda x: x["k"])
    _, rout, rfired, _ = ref(make_ffat_state(torch.zeros(()), K, R),
                             payload, ts, valid)
    mesh = _mesh(2)
    sstep = M.make_sharded_ffat_step(mesh, cap, K, Pn, R, D,
                                     lambda x: x["v"], lambda a, b: a + b,
                                     lambda x: x["k"])
    _, sout, sfired, _ = sstep(
        M.make_sharded_ffat_state(torch.zeros(()), K, R, mesh),
        payload, ts, valid)
    assert _fired(rout, rfired) == _fired(sout, sfired)


def _drive_pair(pkg, comb, values, step_kwargs):
    cap, K, Pn, R, D = 64, 8, 4, 4, 1
    outs = []
    for kwargs in ({}, step_kwargs):
        got = []
        if pkg == "jax":
            mesh = JM.make_mesh(8, data=2)
            sh = JM.batch_sharding(mesh)
            step = JM.make_sharded_ffat_step(
                mesh, cap, K, Pn, R, D, lambda x: x["v"], comb[0],
                lambda x: x["k"], **kwargs)
            st = JM.make_sharded_ffat_state(jnp.zeros((), jnp.int64), K, R,
                                            mesh)
            put = lambda a: jax.device_put(jnp.asarray(a), sh)  # noqa: E731
        else:
            mesh = _mesh(2)
            step = M.make_sharded_ffat_step(
                mesh, cap, K, Pn, R, D, lambda x: x["v"], comb[1],
                lambda x: x["k"], **kwargs)
            st = M.make_sharded_ffat_state(torch.zeros((), dtype=torch.int64),
                                           K, R, mesh)
            put = torch.as_tensor
        for it in range(5):
            p5 = {"k": put(np.arange(cap, dtype=np.int32) % K),
                  "v": put(values - it)}
            st, out, fired, _ = step(st, p5, put(np.arange(cap,
                                                           dtype=np.int64)),
                                     put(np.ones(cap, bool)))
            got.extend(_fired(out, fired))
        outs.append(sorted(got))
    return outs


@pytest.mark.parametrize("name,comb,values,step_kwargs", [
    ("sum", (lambda a, b: a + b, lambda a, b: a + b),
     (np.arange(64, dtype=np.int64) * 3) % 101, dict(sum_like=True)),
    ("max", (jnp.maximum, torch.maximum),
     -1 - ((np.arange(64, dtype=np.int64) * 7) % 89), dict(monoid="max")),
])
def test_sharded_ffat_declared_path_matches_default(name, comb, values,
                                                    step_kwargs):
    default, declared = _drive_pair("port", comb, values, step_kwargs)
    assert default == declared and default, name
    assert default == _drive_pair("jax", comb, values, step_kwargs)[0]


def test_sharded_ffat_tb_matches_single_device_and_jax():
    """The TB step: key-sharded rings with per-shard clocks, the
    watermark passed to every position; records equal the single-device
    step's and JAX's sharded step's."""
    from windflow_tpu_torch.windows import ffat_kernels as tk
    cap, K, P_us, R, D, NP = 64, 8, 1000, 4, 2, 32
    rng = np.random.default_rng(11)
    jmesh, mesh = JM.make_mesh(8, data=2), _mesh(2)
    jstep = JM.make_sharded_ffat_tb_step(jmesh, cap, K, P_us, R, D, NP,
                                         lambda x: x["v"], lambda a, b: a + b,
                                         lambda x: x["k"])
    jst = JM.make_sharded_ffat_tb_state(jnp.zeros((), jnp.float32), K, NP,
                                        jmesh)
    pstep = M.make_sharded_ffat_tb_step(mesh, cap, K, P_us, R, D, NP,
                                        lambda x: x["v"], lambda a, b: a + b,
                                        lambda x: x["k"])
    pst = M.make_sharded_ffat_tb_state(torch.zeros((), dtype=torch.float32),
                                       K, NP, mesh)
    ref = tk.make_ffat_tb_step(cap, K, P_us, R, D, NP, lambda x: x["v"],
                               lambda a, b: a + b, lambda x: x["k"])
    rst = tk.make_ffat_tb_state(torch.zeros((), dtype=torch.float32), K, NP)
    sh = JM.batch_sharding(jmesh)
    got, jgot, rgot = [], [], []
    for b in range(6):
        keys = rng.integers(0, K, cap).astype(np.int32)
        vals = rng.integers(0, 50, cap).astype(np.float32)
        ts = np.sort(rng.integers(b * 4000, b * 4000 + 6000, cap)) \
            .astype(np.int64)
        wm = b * 4000 // P_us - 2
        jst, jo, jf, _, _ = jstep(
            jst, {"k": jax.device_put(jnp.asarray(keys), sh),
                  "v": jax.device_put(jnp.asarray(vals), sh)},
            jax.device_put(jnp.asarray(ts), sh),
            jax.device_put(jnp.ones(cap, bool), sh), wm)
        tp = {"k": torch.as_tensor(keys), "v": torch.as_tensor(vals)}
        pst, po, pf, _, pn = pstep(pst, tp, torch.as_tensor(ts),
                                   torch.ones(cap, dtype=torch.bool), wm)
        rst, ro, rf, _, rn = ref(rst, tp, torch.as_tensor(ts),
                                 torch.ones(cap, dtype=torch.bool), wm)
        jgot += _fired(jo, jf)
        got += _fired(po, pf)
        rgot += _fired(ro, rf)
    assert got and sorted(got) == sorted(rgot) == sorted(jgot)
    assert pst.equal_across_data()


def test_collectives_record_their_kind_axes_and_size():
    mesh = _mesh(2)
    grid = {p: torch.arange(4) + p[1] for p in mesh.local_positions}
    with M.recording() as rec:
        g = M.all_gather(grid, mesh, M.DATA_AXIS)
        s = M.psum(grid, mesh, M.KEY_AXIS)
        a = M.all_to_all({p: torch.arange(8).reshape(8, 1) * 10 + p[1]
                          for p in mesh.local_positions}, mesh, M.AXES)
    assert [r["op"] for r in rec] == ["all_gather", "psum", "all_to_all"]
    assert [r["crosses_key"] for r in rec] == [False, True, True]
    assert rec[0]["numel"] == 4
    assert g[(0, 1)].tolist() == [1, 2, 3, 4, 1, 2, 3, 4]
    assert s[(1, 0)].tolist() == [6, 10, 14, 18]
    # row i of every position lands on the group's i-th position
    assert a[(0, 1)].reshape(-1).tolist() == [10 * 1 + k for k in
                                              (0, 1, 2, 3, 0, 1, 2, 3)]


def test_not_applicable_tests_name_real_jax_tests():
    import os
    src = open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "test_mesh.py")).read()
    for name in NOT_APPLICABLE:
        assert f"def {name}(" in src, name
