"""The port's FFAT count-window step and flush against the JAX package
(windflow_tpu_torch/windows/ffat_kernels.py vs windflow_tpu/windows/
ffat_kernels.py), and the JAX-to-port state handoff (interop.py).

The same numpy batches (fixed seed) go through ``make_ffat_step`` of
both packages for 6 consecutive batches plus the EOS flush.  Tolerances:

* integer-valued data: record-identical, every combiner, kernels on or
  off (sums of integers below 2**24 are exact in any order);
* random floats, generic combiner: bit-identical — the port evaluates
  JAX's associative_scan and doubling-fold combine trees;
* random floats, declared "sum": rtol 1e-5 — the pane cells are a
  scatter-add whose order differs between XLA, torch and (on the card)
  atomics, and JAX's Pallas fold contracts on the MXU
  (pallas_ffat.py:40-46).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu  # noqa: F401  (the JAX package's process setup)
from windflow_tpu import kernels as pk
from windflow_tpu.windows import ffat_kernels as jfk
from windflow_tpu_torch.interop import ffat_state_from_numpy
from windflow_tpu_torch.windows import ffat_kernels as tfk

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

CAP, K, P, R, D = 256, 8, 4, 4, 2
_JC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": jnp.maximum, "min": jnp.minimum}
_TC = {None: lambda a, b: a + b, "sum": lambda a, b: a + b,
       "max": torch.maximum, "min": torch.minimum}


def _batches(seed, n, monoid, floats=False, cap=CAP, keys=K):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        # keys below 0 and at/above K: out of range, masked into the
        # dump row (JAX drops such scatters; torch would raise)
        k = rng.integers(-2, keys + 2, cap).astype(np.int32)
        if floats:
            v = rng.standard_normal(cap).astype(np.float32)
        else:
            v = rng.integers(-50, 50, cap).astype(np.float32)
        if monoid in ("max", "min"):
            v = v - 1000.0        # strictly negative: the identity trap
        valid = rng.random(cap) < 0.8
        ts = np.arange(cap, dtype=np.int64) + b * cap
        out.append((k, v, ts, valid))
    return out


def _jax_step(monoid, kernels, cap=CAP, keys=K, p=P, r=R, d=D):
    return jax.jit(jfk.make_ffat_step(
        cap, keys, p, r, d, lambda t: t["v"], _JC[monoid], lambda t: t["k"],
        monoid=monoid, pallas=pk.PallasMode(True) if kernels else None))


def _torch_step(monoid, kernels, cap=CAP, keys=K, p=P, r=R, d=D):
    return tfk.make_ffat_step(
        cap, keys, p, r, d, lambda t: t["v"], _TC[monoid], lambda t: t["k"],
        monoid=monoid, kernels=kernels)


def _fired(out, valid):
    valid = np.asarray(valid)
    return {f: np.asarray(out[f])[valid] for f in ("key", "wid", "value")}


def _assert_records(a, b, exact=True):
    for f in ("key", "wid"):
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f])
    assert a["value"].dtype == b["value"].dtype
    if exact:
        np.testing.assert_array_equal(a["value"], b["value"])
    else:
        np.testing.assert_allclose(a["value"], b["value"], rtol=1e-5,
                                   atol=1e-5)


def _run_both(monoid, kernels, batches, exact=True):
    js, ts_ = _jax_step(monoid, kernels), _torch_step(monoid, kernels)
    jst = jfk.make_ffat_state(jnp.zeros((), jnp.float32), K, R)
    tst = tfk.make_ffat_state(torch.zeros((), dtype=torch.float32), K, R)
    for k, v, ts, valid in batches:
        jst, jo, jv, jt = js(jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                             jnp.asarray(ts), jnp.asarray(valid))
        tst, to, tv, tt = ts_(tst, {"k": torch.from_numpy(k),
                                    "v": torch.from_numpy(v)},
                              torch.from_numpy(ts), torch.from_numpy(valid))
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(jt)[np.asarray(jv)],
                                      tt.numpy()[tv.numpy()])
        _assert_records(_fired(jo, jv), _fired(to, tv), exact)
    jf = jax.jit(jfk.make_ffat_flush(K, P, R, D, _JC[monoid]))(jst)
    tf = tfk.make_ffat_flush(K, P, R, D, _TC[monoid])(tst)
    np.testing.assert_array_equal(np.asarray(jf[1]), tf[1].numpy())
    assert np.asarray(jf[1]).any()
    _assert_records(_fired(jf[0], jf[1]), _fired(tf[0], tf[1]), exact)
    return jst, tst


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("monoid", [None, "sum", "max", "min"])
def test_step_and_flush_record_identical(monoid, kernels):
    jst, tst = _run_both(monoid, kernels, _batches(3, 6, monoid))
    for key in jst:                 # the carried state too, dtype and all
        got = tst[key].numpy()
        want = np.asarray(jst[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want)


def test_generic_combiner_random_floats_bit_identical():
    """Same combine tree (associative_scan + doubling fold) as JAX."""
    _run_both(None, True, _batches(5, 6, None, floats=True), exact=True)


@pytest.mark.parametrize("kernels", [False, True])
def test_declared_sum_random_floats_within_tolerance(kernels):
    _run_both("sum", kernels, _batches(6, 6, "sum", floats=True),
              exact=False)


@pytest.mark.parametrize("kernels", [False, True])
def test_pytree_aggregate_record_identical(kernels):
    """A two-leaf aggregate (sum, count) through the generic combiner."""
    def lift(t):
        return {"s": t["v"], "n": torch.ones_like(t["k"])}

    def jlift(t):
        return {"s": t["v"], "n": jnp.ones((), jnp.int32)}

    def comb(a, b):
        return {"s": a["s"] + b["s"], "n": a["n"] + b["n"]}
    js = jax.jit(jfk.make_ffat_step(
        CAP, K, P, R, D, jlift, comb, lambda t: t["k"],
        pallas=pk.PallasMode(True) if kernels else None))
    ts_ = tfk.make_ffat_step(CAP, K, P, R, D, lift, comb, lambda t: t["k"],
                             kernels=kernels)
    spec_j = {"s": jnp.zeros((), jnp.float32), "n": jnp.zeros((), jnp.int32)}
    spec_t = {"s": torch.zeros((), dtype=torch.float32),
              "n": torch.zeros((), dtype=torch.int32)}
    jst = jfk.make_ffat_state(spec_j, K, R)
    tst = tfk.make_ffat_state(spec_t, K, R)
    for k, v, ts, valid in _batches(9, 4, None):
        jst, jo, jv, _ = js(jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            jnp.asarray(ts), jnp.asarray(valid))
        tst, to, tv, _ = ts_(tst, {"k": torch.from_numpy(k),
                                   "v": torch.from_numpy(v)},
                             torch.from_numpy(ts), torch.from_numpy(valid))
        m = np.asarray(jv)
        np.testing.assert_array_equal(m, tv.numpy())
        for leaf in ("s", "n"):
            np.testing.assert_array_equal(np.asarray(jo["value"][leaf])[m],
                                          to["value"][leaf].numpy()[m])


def test_agg_spec_and_state_layout_match_jax():
    payload = {"k": torch.zeros(4, dtype=torch.int32),
               "v": torch.zeros(4, dtype=torch.float32)}
    spec = tfk.agg_spec_for(lambda t: t["v"] * 2, payload)
    st = tfk.make_ffat_state(spec, K, R)
    jst = jfk.make_ffat_state(jnp.zeros((), jnp.float32), K, R)
    assert set(st) == set(jst)
    for key in st:
        assert st[key].numpy().dtype == np.asarray(jst[key]).dtype, key
        assert tuple(st[key].shape) == tuple(jst[key].shape), key


@pytest.mark.parametrize("monoid", [None, "sum"])
def test_state_handoff_from_jax_gives_identical_windows(monoid):
    """n batches through the JAX step, the state handed across, the rest
    through the port: the same windows as a run that stayed in JAX."""
    batches = _batches(21, 6, monoid)
    js, ts_ = _jax_step(monoid, False), _torch_step(monoid, True)
    jst = jfk.make_ffat_state(jnp.zeros((), jnp.float32), K, R)
    stay, mixed = [], []
    for k, v, ts, valid in batches[:3]:
        jst, jo, jv, _ = js(jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            jnp.asarray(ts), jnp.asarray(valid))
    tst = ffat_state_from_numpy(jax.tree.map(np.asarray, jst))
    for key in jst:
        assert tst[key].numpy().dtype == np.asarray(jst[key]).dtype
    for k, v, ts, valid in batches[3:]:
        jst, jo, jv, _ = js(jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            jnp.asarray(ts), jnp.asarray(valid))
        stay.append(_fired(jo, jv))
        tst, to, tv, _ = ts_(tst, {"k": torch.from_numpy(k),
                                   "v": torch.from_numpy(v)},
                             torch.from_numpy(ts), torch.from_numpy(valid))
        mixed.append(_fired(to, tv))
    jf = jax.jit(jfk.make_ffat_flush(K, P, R, D, _JC[monoid]))(jst)
    tf = tfk.make_ffat_flush(K, P, R, D, _TC[monoid])(tst)
    stay.append(_fired(jf[0], jf[1]))
    mixed.append(_fired(tf[0], tf[1]))
    for a, b in zip(stay, mixed):
        _assert_records(a, b)


def test_handoff_rejects_a_non_ffat_state():
    from windflow_tpu_torch import WindFlowError
    with pytest.raises(WindFlowError):
        ffat_state_from_numpy({"cells": np.zeros(3)})


def test_associative_scan_matches_jax_tree():
    """The ported odd/even recursion reproduces lax.associative_scan bit
    for bit on a non-associative-in-floats combine, every length."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 64, 101):
        x = rng.standard_normal((n, 3)).astype(np.float32)
        want = np.asarray(jax.lax.associative_scan(
            lambda a, b: a * 0.5 + b, jnp.asarray(x), axis=0))
        got = tfk.associative_scan(lambda a, b: a * 0.5 + b,
                                   torch.from_numpy(x), axis=0).numpy()
        np.testing.assert_array_equal(got, want)
        want1 = np.asarray(jax.lax.associative_scan(
            lambda a, b: a * 0.5 + b, jnp.asarray(x), axis=1))
        got1 = tfk.associative_scan(lambda a, b: a * 0.5 + b,
                                    torch.from_numpy(x), axis=1).numpy()
        np.testing.assert_array_equal(got1, want1)


@pytest.mark.parametrize("win,slide", [(12, 4), (8, 8), (4, 12), (5, 3)])
def test_window_shapes_record_identical(win, slide):
    """Tumbling, hopping-with-gaps and coprime window shapes."""
    import math
    p = math.gcd(win, slide)
    r, d = win // p, slide // p
    batches = _batches(win * 10 + slide, 4, None)
    js = _jax_step(None, False, p=p, r=r, d=d)
    ts_ = _torch_step(None, True, p=p, r=r, d=d)
    jst = jfk.make_ffat_state(jnp.zeros((), jnp.float32), K, r)
    tst = tfk.make_ffat_state(torch.zeros((), dtype=torch.float32), K, r)
    for k, v, ts, valid in batches:
        jst, jo, jv, _ = js(jst, {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                            jnp.asarray(ts), jnp.asarray(valid))
        tst, to, tv, _ = ts_(tst, {"k": torch.from_numpy(k),
                                   "v": torch.from_numpy(v)},
                             torch.from_numpy(ts), torch.from_numpy(valid))
        _assert_records(_fired(jo, jv), _fired(to, tv))
    jf = jax.jit(jfk.make_ffat_flush(K, p, r, d, _JC[None]))(jst)
    tf = tfk.make_ffat_flush(K, p, r, d, _TC[None])(tst)
    _assert_records(_fired(jf[0], jf[1]), _fired(tf[0], tf[1]))
