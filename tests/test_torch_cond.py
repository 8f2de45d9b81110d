"""The port's ``lax.cond``s against the JAX package's, on the CPU
(windflow_tpu_torch/kernels/cond_cuda.py, the TB step's fold in
windows/ffat_kernels.py and the compacted reduce's branches in
parallel/compaction.py).

The JAX package has two device-side ``lax.cond``s: the TB window step
folds only on a fire pass that fires (``no_fold`` zeros otherwise), and
the compacted reduce picks ``no_miss``, ``ovf_small`` or ``ovf_big``.
On the card the port runs both as CUDA graph SWITCH nodes steered by the
``cond_select`` kernel; here the same regions run with the branch picked
by the kernel's plain twin (``cond=True`` for the TB step, the kernels
on for the compacted reduce), and the plain routes run as they do under
``Config(cuda_kernels="0")``: the TB step folds and selects the no_fold
zeros on the device, the compacted reduce reads its branch index on the
host.

Step level, the same seeded numpy batches through both packages:

* the TB step on every output lane, unfired lanes included, for
  tests/test_torch_tb.py's ``STEP_CASES`` and an ordered stream whose
  pre-place passes fire nothing (the body counters show the fold
  skipped on exactly those passes);
* the compacted step forced into each branch (all hit, misses within
  the overflow lane, more), bounded and unbounded, declared max and sum:
  outputs and cstats equal, the full-width fallback count ``big``
  included, and the body counter names the branch.

Tolerances: exact, except the declared f32 sum of the TB cases on
random floats (rtol 1e-5: JAX's psum reassociation tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu import kernels as pk
from windflow_tpu.parallel import compaction as jc
from windflow_tpu.windows import ffat_kernels as jfk
from windflow_tpu_torch.analysis import ir_audit
from windflow_tpu_torch.interop import ffat_tb_state_from_numpy
from windflow_tpu_torch.kernels import cond_cuda as cc
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.parallel import compaction as tc
from windflow_tpu_torch.windows import ffat_kernels as tfk
from test_torch_tb import STEP_CASES, _tb_batches

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

_JC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": jnp.maximum, "min": jnp.minimum}
_TC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": torch.maximum, "min": torch.minimum}
CPU = torch.device("cpu")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


# ---------------------------------------------------------------------------
# the steering kernel's plain twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbodies", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cond_select_plain_picks_and_counts(nbodies, dtype):
    """Every index of an n-body switch runs that body once and counts it;
    an index out of range runs none and counts in the last column."""
    site = f"test plain {nbodies} {dtype}"
    cc.reset_body_counts(CPU)
    ran = []
    bodies = [lambda j=j: ran.append(j) for j in range(nbodies)]
    before = fc.kernel_build_count()
    for i in list(range(nbodies)) + [nbodies, -1, 7]:
        cc.switch(torch.tensor(i, dtype=dtype), bodies, site)
    assert ran == list(range(nbodies))
    assert cc.body_counts(CPU, site, nbodies) == [1] * nbodies + [3]
    # one wrapper entry a switch; the plain route enters none
    assert fc.kernel_build_count() == before + nbodies + 3
    assert cc.cond_select_plain(torch.tensor(nbodies - 1), nbodies) \
        == nbodies - 1
    cc.switch_plain(torch.tensor(0, dtype=dtype), bodies)
    assert ran[-1] == 0 and fc.kernel_build_count() == before + nbodies + 3


def test_region_graph_runs_host_tensors_as_they_are():
    """On host tensors a RegionGraph is the region itself: no graph is
    built or cached."""
    r = cc.RegionGraph("test region", lambda x, y: {"s": x + y})
    out = r(torch.ones(3), torch.arange(3.0))
    assert out["s"].tolist() == [1.0, 2.0, 3.0] and r.cached == {}


def test_sanctioned_reads_no_longer_hold_the_compacted_body():
    """The compacted reduce picks its branch on the device: its body left
    the capture audit's sanctioned host reads, and no entry is a branch
    pick."""
    assert ("parallel/compaction.py",
            "make_compacted_reduce.<locals>.body") \
        not in ir_audit.SANCTIONED_HOST_READS
    assert not any("miss count" in r
                   for r in ir_audit.SANCTIONED_HOST_READS.values())


# ---------------------------------------------------------------------------
# the TB step's fold
# ---------------------------------------------------------------------------

def _tb_pair(K, P, R, D, NP, cap, monoid, drop, kernels, cond):
    js = jax.jit(jfk.make_ffat_tb_step(
        cap, K, P, R, D, NP, lambda t: t["v"], _JC[monoid], lambda t: t["k"],
        drop_tainted=drop, monoid=monoid,
        pallas=pk.PallasMode(True) if kernels else None))
    ts_ = tfk.make_ffat_tb_step(
        cap, K, P, R, D, NP, lambda t: t["v"], _TC[monoid], lambda t: t["k"],
        drop_tainted=drop, monoid=monoid, kernels=kernels, cond=cond)
    return js, ts_


def _every_lane(jout, tout, exact):
    """Every output of one step equal, unfired lanes included."""
    jo, jf, jt, jn = jout
    to, tf, tt, tn = tout
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for f in ("key", "wid", "value"):
        a, b = np.asarray(jo[f]), to[f].numpy()
        assert a.dtype == b.dtype, f
        if f == "value" and not exact:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(tn) == int(jn)


def _passes_fired(wid, n_adv, K, MW):
    """The windows each of the step's three passes fired, from the
    output window ids (a pass's first id is the previous pass's first
    plus what that pass fired)."""
    w = np.asarray(wid).reshape(K, 3, MW)[0, :, 0]
    a1, a2 = int(w[1] - w[0]), int(w[2] - w[1])
    return [a1, a2, int(n_adv) - a1 - a2]


@pytest.mark.parametrize("cond", [None, True], ids=["plain", "switch"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tb_step_every_lane_matches_jax(case, cond):
    """The cases of test_torch_tb.py's step test, every output lane held:
    JAX's no_fold zeros on the passes that fire nothing, its fold values
    on the unfired lanes of a pass that fires.  The switch route (the
    node's bodies, picked by the steering kernel's plain twin) counts one
    pick a pass: the fold exactly on the passes that fired."""
    K, P, R, D, NP, cap, monoid, drop, kernels, floats = STEP_CASES[case]
    exact = not (floats and monoid == "sum")
    js, ts_ = _tb_pair(K, P, R, D, NP, cap, monoid, drop, kernels, cond)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.float32), K, NP)
    tst = ffat_tb_state_from_numpy(jax.tree.map(np.asarray, jst))
    MW = NP // D + 2
    cc.reset_body_counts(CPU)
    fired = []
    for k, v, ts, valid, wm in _tb_batches(0, 6, K, P, cap, floats):
        jst, *jout = js(
            jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(ts),
            jnp.asarray(valid), jnp.int64(wm))
        tst, *tout = ts_(
            tst, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
            torch.from_numpy(ts), torch.from_numpy(valid), wm)
        _every_lane(jout, tout, exact)
        fired += _passes_fired(jout[0]["wid"], jout[3], K, MW)
        for key in jst:
            a, b = np.asarray(jst[key]), tst[key].numpy()
            if key == "cells" and not exact:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(b, a, err_msg=key)
    assert any(fired) and not all(fired)
    counts = cc.body_counts(CPU, tfk.FOLD_SITE, 2)
    if cond:
        assert counts == [sum(n == 0 for n in fired),
                          sum(n > 0 for n in fired), 0]
    else:
        assert counts == [0, 0, 0]


@pytest.mark.parametrize("cond", [None, True], ids=["plain", "switch"])
def test_tb_ordered_stream_skips_the_fold_on_passes_a(cond):
    """An ordered stream under a resolved watermark: the two pre-place
    passes fire nothing every step, so JAX takes no_fold there and its
    zeros fill their lanes; the port's lanes equal them, and on the
    switch route the fold ran once a step (pass B), twice skipped."""
    K, P, R, D, NP, cap = 4, 1000, 4, 1, 32, 64
    js, ts_ = _tb_pair(K, P, R, D, NP, cap, None, True, True, cond)
    jst = jfk.make_ffat_tb_state(jnp.zeros((), jnp.float32), K, NP)
    tst = ffat_tb_state_from_numpy(jax.tree.map(np.asarray, jst))
    rng = np.random.default_rng(3)
    MW = NP // D + 2
    cc.reset_body_counts(CPU)
    steps, fired_b = 5, []
    for b in range(steps):
        k = rng.integers(0, K, cap).astype(np.int32)
        v = rng.standard_normal(cap).astype(np.float32)
        ts = (b * cap + np.arange(cap)) * (P // 10)
        wm = int(ts.max()) // P
        jst, *jout = js(
            jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(ts),
            jnp.ones(cap, bool), jnp.int64(wm))
        tst, *tout = ts_(
            tst, {"k": torch.from_numpy(k), "v": torch.from_numpy(v)},
            torch.from_numpy(ts), torch.ones(cap, dtype=torch.bool), wm)
        _every_lane(jout, tout, True)
        vals = np.asarray(jout[0]["value"]).reshape(K, 3, MW)
        assert not vals[:, :2].any()          # no_fold's zeros
        fired = _passes_fired(jout[0]["wid"], jout[3], K, MW)
        assert fired[:2] == [0, 0]
        fired_b.append(fired[2])
    assert int(jst["win_next"]) > 0 and all(fired_b)
    counts = cc.body_counts(CPU, tfk.FOLD_SITE, 2)
    if cond:
        assert counts == [2 * steps, steps, 0]
    else:
        assert counts == [0, 0, 0]


def test_mesh_tb_steps_stay_on_the_plain_route(monkeypatch):
    """The mesh's per-shard TB steps ask for the plain fold route (no
    conditional node), whatever the kernels resolve to."""
    from windflow_tpu_torch.parallel import mesh as M
    seen = []
    orig = tfk.make_ffat_tb_step

    def spy(*a, **kw):
        seen.append(kw.get("cond"))
        return orig(*a, **kw)
    monkeypatch.setattr(tfk, "make_ffat_tb_step", spy)
    mesh = M.make_mesh(2, data=1, devices=["cpu"] * 2)
    M.make_sharded_ffat_tb_step(mesh, 64, 4, 1000, 4, 1, 16,
                                lambda t: t["v"], lambda a, b: a + b,
                                lambda t: t["k"], kernels=True)
    assert seen and all(c is False for c in seen)


# ---------------------------------------------------------------------------
# the compacted reduce's branches
# ---------------------------------------------------------------------------

CAP, T = 64, 16          # overflow lane: overflow_cap(64) == 32
BRANCHES = {"no_miss": 0, "ovf_small": 9, "ovf_big": 40}


def _tables(rng):
    keys = np.sort(rng.choice(np.arange(995, 1025), 10, replace=False))
    slots = rng.permutation(T)[:10]
    tk = np.full(T, tc.KEY_SENTINEL, np.int32)
    tsl = np.full(T, T, np.int32)
    tk[:10], tsl[:10] = keys, slots
    return tk, tsl


def _batch(rng, n_miss, bounded, tk=None):
    """One batch with exactly ``n_miss`` valid miss lanes."""
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
    rest = np.setdiff1d(np.arange(CAP), lanes)
    valid[rng.permutation(rest)[:4]] = False
    payload = {"key": keys,
               "v": rng.integers(-50, 50, CAP).astype(np.float32)}
    ts = rng.integers(0, 10 ** 6, CAP).astype(np.int64)
    return keys, payload, ts, valid


def _comb(monoid, ops):
    op = ops[monoid]
    return lambda a, b: {k: op(a[k], b[k]) for k in a}


_JBODIES = {}


def _jax_body(monoid, bounded):
    key = (monoid, bounded)
    if key not in _JBODIES:
        _JBODIES[key] = jax.jit(jc.make_compacted_reduce(
            CAP, T, monoid, _comb(monoid, _JC), lambda t: t["key"], None,
            bounded))
    return _JBODIES[key]


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("monoid", ["max", "sum"])
@pytest.mark.parametrize("bounded", [True, False],
                         ids=["bounded", "unbounded"])
def test_compacted_body_branch_matches_jax(bounded, monoid, branch):
    """Each branch of the compacted step, forced by the batch's misses:
    the port's outputs and cstats (``big`` included) equal JAX's batch by
    batch, and the body counter names the branch the step took."""
    n_miss = BRANCHES[branch]
    rng = np.random.default_rng(n_miss * 3 + bounded + len(monoid))
    tables = None if bounded else _tables(rng)
    jbody = _jax_body(monoid, bounded)
    tbody = tc.make_compacted_reduce(CAP, T, monoid, _comb(monoid, _TC),
                                     lambda t: t["key"], bounded,
                                     kernels=True)
    extra_j = () if bounded else tuple(jnp.asarray(t) for t in tables)
    extra_t = () if bounded else tuple(torch.from_numpy(t) for t in tables)
    jst, tst = jc.cstats_init(), tc.cstats_init()
    cc.reset_body_counts(CPU)
    nb = 2
    for _ in range(nb):
        keys, payload, ts, valid = _batch(
            rng, n_miss, bounded, None if bounded else tables[0])
        jo = jbody(None, jax.tree.map(jnp.asarray, payload),
                   jnp.asarray(ts), jnp.asarray(valid), *extra_j, jst)
        to = tbody(None, _t(payload), torch.from_numpy(ts),
                   torch.from_numpy(valid), *extra_t, tst)
        jp, jts, jv, jst_np = (_np_tree(x) for x in jo)
        tp, tts, tv, tst = to
        np.testing.assert_array_equal(tv.numpy(), jv)
        np.testing.assert_array_equal(tts.numpy(), jts)
        for k in jp:
            np.testing.assert_array_equal(tp[k].numpy(), jp[k], err_msg=k)
        for k in jst_np:
            np.testing.assert_array_equal(tst[k].numpy(), jst_np[k],
                                          err_msg=k)
        jst = jo[3]
    pick = list(BRANCHES).index(branch)
    assert int(tst["big"]) == (nb if branch == "ovf_big" else 0)
    want = [0, 0, 0, 0]
    want[pick] = nb
    assert cc.body_counts(CPU, tc.BRANCH_SITE, 3) == want


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_compacted_plain_route_matches_the_switch_route(branch):
    """The kernels-off route picks the same branch by a host read of the
    index (no wrapper entered, no pick counted): the same outputs and
    cstats as the switch route."""
    n_miss = BRANCHES[branch]
    rng = np.random.default_rng(70 + n_miss)
    keys, payload, ts, valid = _batch(rng, n_miss, True)
    outs = []
    for kernels in (True, False):
        cc.reset_body_counts(CPU)
        body = tc.make_compacted_reduce(
            CAP, T, "max", _comb("max", _TC), lambda t: t["key"], True,
            kernels=kernels)
        before = fc.kernel_build_count()
        outs.append(body(None, _t(payload), torch.from_numpy(ts),
                         torch.from_numpy(valid), tc.cstats_init()))
        counts = cc.body_counts(CPU, tc.BRANCH_SITE, 3)
        if kernels:
            assert sum(counts) == 1 and counts[list(BRANCHES).index(
                branch)] == 1
        else:
            assert counts == [0, 0, 0, 0]
            assert fc.kernel_build_count() == before
    (ap, ats, av, ast), (bp, bts, bv, bst) = outs
    assert torch.equal(av, bv) and torch.equal(ats, bts)
    assert all(torch.equal(ap[k], bp[k]) for k in ap)
    assert all(torch.equal(ast[k], bst[k]) for k in ast)
