"""The port's kernel modules against the JAX package
(windflow_tpu_torch/kernels/ffat_cuda.py and reduce_cuda.py vs
windflow_tpu/kernels/pallas_ffat.py and the lax compositions the Pallas
kernels replace).

On the CPU each kernel wrapper takes its plain torch version, so these
tests hold the plain versions against the Pallas kernels run as the JAX
package's own tests run them (``interpret=True``) and against the lax
compositions.  Inputs come from numpy with a fixed seed and are fed to
both packages.  Tolerances:

* grouping: exact (integer arithmetic);
* sliding fold vs the lax fold: exact — same combine tree;
* sliding fold vs the Pallas kernel: exact for max/min, int32, and f32
  sums of integer-valued data; rtol 1e-6 for random f32 sums, whose MXU
  banded matmul contracts in another order (pallas_ffat.py:40-46);
* dense slot tables vs the Pallas kernel: exact for max/min, integers,
  bool, and f32 sums of integer-valued data; rtol 1e-5 for random f32
  sums (the Pallas kernel sums a 256-lane tile as a tree, the plain
  scatter-add in lane order: the same declared-sum tolerance, as
  tests/test_pallas_kernels.py states it for the fold).

tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu  # noqa: F401  (the JAX package's process setup)
from windflow_tpu import kernels as pk
from windflow_tpu.windows import ffat_kernels as jfk
from windflow_tpu.windows import grouping as jgrouping
from windflow_tpu_torch import Config, WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels import reduce_cuda as rc
from windflow_tpu_torch.windows import grouping as tgrouping

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

_JOPS = {"sum": lambda a, b: a + b, "max": jnp.maximum, "min": jnp.minimum}


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("NB", [2, 129, 1025, 4096])
@pytest.mark.parametrize("B", [1, 255, 256, 257, 1000])
def test_grouping_plain_matches_pallas_and_lax(B, NB):
    rng = np.random.default_rng(B * 7919 + NB)
    ids = rng.integers(0, NB, B).astype(np.int32)
    dest, rank, hist = (t.numpy() for t in
                        fc.grouping_rank_hist(torch.from_numpy(ids), NB))
    jd, jr, jh = (np.asarray(a) for a in
                  pk.grouping_rank_hist(jnp.asarray(ids), NB,
                                        interpret=True))
    np.testing.assert_array_equal(dest, jd)
    np.testing.assert_array_equal(rank, jr)
    np.testing.assert_array_equal(hist, jh)
    # and the lax compositions the kernel replaces
    lr, lc, _, _ = jgrouping.dense_rank(jnp.asarray(ids), NB)
    np.testing.assert_array_equal(rank, np.asarray(lr)[:B])
    np.testing.assert_array_equal(hist, np.asarray(lc))
    jorder, jhist = jgrouping.order_and_hist(jnp.asarray(ids), NB)
    torder, thist = tgrouping.order_and_hist(torch.from_numpy(ids), NB)
    np.testing.assert_array_equal(torder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    korder, khist = fc.order_hist(torch.from_numpy(ids), NB)
    np.testing.assert_array_equal(korder.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(korder.numpy(),
                                  np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(khist.numpy(), jh)


@pytest.mark.parametrize("NB", [2, 300, 70000])
def test_counting_order_matches_jax_and_stable_argsort(NB):
    """The radix and argsort branches of auto_order (NB beyond one digit
    and beyond two) give the stable permutation, as in JAX."""
    rng = np.random.default_rng(NB)
    ids = rng.integers(0, NB, 777).astype(np.int32)
    got = tgrouping.auto_order(torch.from_numpy(ids), NB).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jgrouping.auto_order(jnp.asarray(ids), NB)))
    np.testing.assert_array_equal(got, np.argsort(ids, kind="stable"))


@pytest.mark.parametrize("B,NB,one", [(257, 2, 1), (1000, 4096, 4095),
                                      (300, 129, 0)])
def test_grouping_plain_one_id_matches_pallas(B, NB, one):
    """Every lane with one id (the kernel's widest match-any group): the
    plain version equals the Pallas kernel and the stable argsort."""
    ids = np.full(B, one, np.int32)
    dest, rank, hist = (t.numpy() for t in
                        fc.grouping_rank_hist(torch.from_numpy(ids), NB))
    jd, jr, jh = (np.asarray(a) for a in
                  pk.grouping_rank_hist(jnp.asarray(ids), NB,
                                        interpret=True))
    np.testing.assert_array_equal(dest, jd)
    np.testing.assert_array_equal(rank, jr)
    np.testing.assert_array_equal(hist, jh)
    np.testing.assert_array_equal(rank, np.arange(B))
    korder, _ = fc.order_hist(torch.from_numpy(ids), NB)
    np.testing.assert_array_equal(korder.numpy(),
                                  np.argsort(ids, kind="stable"))


def test_grouping_gate_matches_pallas():
    for n, nb in [(0, 2), (1, 1), (1, 2), (1 << 22, 4096), ((1 << 22) + 1, 2),
                  (5, 4097)]:
        assert fc.grouping_supported(n, nb) == pk.grouping_supported(n, nb)


# ---------------------------------------------------------------------------
# sliding fold
# ---------------------------------------------------------------------------

def _fold_inputs(rng, K, N, dtype, integer_valued=False):
    if dtype == "int32":
        x = rng.integers(-1000, 1000, (K, N)).astype(np.int32)
    elif integer_valued:
        x = rng.integers(-1000, 1000, (K, N)).astype(np.float32)
    else:
        x = rng.standard_normal((K, N)).astype(np.float32)
    return x, rng.random((K, N)) < 0.75


@pytest.mark.parametrize("R", [1, 3, 8, 13])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_fold_plain_matches_lax_fold(monoid, dtype, R):
    """Plain fold == ffat_kernels._sliding_reduce_plain, bit for bit, on
    ragged K and pane counts (same combine tree)."""
    rng = np.random.default_rng(R * 31 + len(monoid))
    for K, N in [(5, 37), (1, 1), (3, 130)]:
        x, v = _fold_inputs(rng, K, N, dtype)
        got = fc.sliding_fold(torch.from_numpy(x), torch.from_numpy(v), R,
                              monoid).numpy()
        want = np.asarray(jfk._sliding_reduce_plain(
            _JOPS[monoid], jnp.asarray(v), jnp.asarray(x), R, axis=1,
            monoid=monoid))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("R", [8, 13])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_fold_plain_matches_pallas_kernel(monoid, dtype, R):
    rng = np.random.default_rng(R + 7 * len(monoid))
    x, v = _fold_inputs(rng, 6, 70, dtype, integer_valued=True)
    got = fc.fold_leaf_plain(torch.from_numpy(x), torch.from_numpy(v), R,
                             monoid).numpy()
    want = np.asarray(pk.sliding_fold(jnp.asarray(x), jnp.asarray(v), R,
                                      monoid, interpret=True))
    np.testing.assert_array_equal(got, want)
    if dtype == "float32":
        # random floats: exact for max/min; the MXU sum reassociates
        x = rng.uniform(0.5, 1.5, (6, 70)).astype(np.float32)
        got = fc.fold_leaf_plain(torch.from_numpy(x), torch.from_numpy(v),
                                 R, monoid).numpy()
        want = np.asarray(pk.sliding_fold(jnp.asarray(x), jnp.asarray(v),
                                          R, monoid, interpret=True))
        if monoid == "sum":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("R", [1, 8, 13])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_fold_pytree_matches_pallas_kernel(monoid, R):
    """A mixed f32/i32 dict of integer-valued leaves (one launch on the
    card) against the Pallas kernel's pytree fold: exact."""
    rng = np.random.default_rng(R * 3 + len(monoid))
    K, N = 6, 70
    tree = {"a": rng.integers(-1000, 1000, (K, N)).astype(np.float32),
            "b": rng.integers(-1000, 1000, (K, N)).astype(np.int32),
            "c": rng.integers(-9, 9, (K, N)).astype(np.float32)}
    v = rng.random((K, N)) < 0.6
    got = fc.sliding_fold({k: torch.from_numpy(a) for k, a in tree.items()},
                          torch.from_numpy(v), R, monoid)
    want = pk.sliding_fold({k: jnp.asarray(a) for k, a in tree.items()},
                           jnp.asarray(v), R, monoid, interpret=True)
    assert set(got) == set(tree)
    for k in tree:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype
        np.testing.assert_array_equal(got[k].numpy(), w)


@pytest.mark.parametrize("R", [1, 2, 7, 8, 17])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_fold_plain_edges_match_lax_fold(monoid, dtype, R):
    """The kernel's edges against ffat_kernels._sliding_reduce_plain, bit
    for bit: -0.0 at column 0 (0.0 + -0.0 at a row's start rounds to
    0.0), all-dead spans (rows with no valid pane, and dead columns
    after the carried panes, as the FFAT step's mask has them) and
    all-valid rows."""
    rng = np.random.default_rng(R * 7 + len(monoid) + len(dtype))
    K, N = 9, 40
    x, _ = _fold_inputs(rng, K, N, dtype)
    x[:, 0] = -0.0
    live = (R - 1) + rng.integers(1, 4, K)
    v = np.arange(N)[None, :] < live[:, None]
    v[(np.arange(K) & 7) == 7] = False
    v[1] = True
    v[2] = False
    got = fc.sliding_fold(torch.from_numpy(x), torch.from_numpy(v), R,
                          monoid).numpy()
    want = np.asarray(jfk._sliding_reduce_plain(
        _JOPS[monoid], jnp.asarray(v), jnp.asarray(x), R, axis=1,
        monoid=monoid))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    ident = np.asarray(fc.monoid_identity(monoid, torch.from_numpy(x).dtype),
                       dtype=x.dtype)
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  np.full(N, ident).view(np.uint32))


def test_fold_gate():
    x = torch.zeros((4, 100), dtype=torch.float32)
    assert fc.fold_supported(x, 8, "sum")
    assert fc.fold_supported({"a": x, "b": x.int()}, 512, "max")
    assert not fc.fold_supported(x, 8, None)            # generic combiner
    assert not fc.fold_supported(x, 513, "sum")         # R ceiling
    assert not fc.fold_supported(x.double(), 8, "sum")  # dtype gate
    assert not fc.fold_supported(x[:, :, None], 8, "sum")
    # past the Pallas kernel's 4,096-pane VMEM block: market_ticker's
    # step at 262,144 ticks a batch (16,389 pane columns)
    assert fc.fold_supported(torch.zeros((4, 16389)), 4, "max")
    assert not fc.fold_supported(torch.zeros((1, fc.MAX_FOLD_PANES - 6)),
                                 8, "sum")


# ---------------------------------------------------------------------------
# the switch, the counters, the no-fallback rule
# ---------------------------------------------------------------------------

def test_resolve_kernels_modes():
    assert fc.resolve_kernels(Config()) is True       # default "auto"
    assert fc.resolve_kernels(Config(cuda_kernels="1")) is True
    assert fc.resolve_kernels(Config(cuda_kernels=True)) is True
    assert fc.resolve_kernels(Config(cuda_kernels="0")) is False
    assert fc.resolve_kernels(Config(cuda_kernels=False)) is False
    with pytest.raises(WindFlowError):
        fc.resolve_kernels(Config(cuda_kernels="sometimes"))


def test_cpu_wrappers_take_the_plain_version_and_launch_nothing():
    fc.reset_launch_counts()
    before = fc.kernel_build_count()
    ids = torch.tensor([3, 1, 3, 0], dtype=torch.int32)
    dest, rank, hist = fc.grouping_rank_hist(ids, 4)
    assert dest.tolist() == [2, 1, 3, 0] and rank.tolist() == [0, 0, 1, 0]
    assert hist.tolist() == [1, 1, 0, 2]
    fc.sliding_fold(torch.ones((2, 5)), torch.ones((2, 5), dtype=torch.bool),
                    2, "sum")
    rc.dense_monoid_table(ids, [torch.ones(4)], ["sum"], [0.0], 4)
    from windflow_tpu_torch.kernels import loop_cuda
    cur = torch.zeros(loop_cuda.CUR_WORDS, dtype=torch.int64)
    loop_cuda.wavefront_advance(ids, cur, [32], True)
    assert cur.tolist() == [0, 0, 0, 0, 1, -1]
    assert fc.kernel_build_count() == before + 4
    assert fc.launch_counts() == {"grouping_rank_hist": 0, "sliding_fold": 0,
                                  "dense_monoid_table": 0,
                                  "wavefront_loop": 0,
                                  "cond_select": 0}


def test_kernel_entry_needs_nvcc_and_raises_without(monkeypatch):
    """No fallback: where a kernel must be built and nvcc is missing, the
    build raises."""
    from windflow_tpu_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(WindFlowError, match="nvcc not found"):
        build.nvcc_path()


# ---------------------------------------------------------------------------
# dense slot tables
# ---------------------------------------------------------------------------

def _table_leaves(rng, B):
    """One leaf of each dtype the kernel takes, packed [B, W] columns
    included (integer-valued, so every fold is exact)."""
    return [rng.integers(-100, 100, B).astype(np.int64),
            rng.integers(0, 50, (B, 3)).astype(np.float32),
            rng.integers(-1000, 1000, B).astype(np.int32),
            rng.random(B) < 0.4,
            rng.integers(-9, 9, (B, 8)).astype(np.int32)]


@pytest.mark.parametrize("B,S", [(64, 8), (300, 17), (100, 4096), (5, 1),
                                 (700, 300)])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_dense_table_plain_matches_pallas_kernel(monoid, B, S):
    """The cases of tests/test_pallas_kernels.py:175-202, rows outside
    [0, S) on both sides, every dtype, a ts max column with its own op
    and init, and the count column: exact."""
    rng = np.random.default_rng(5 + B + S)
    row = rng.integers(-3, S + 3, B).astype(np.int32)
    leaves = _table_leaves(rng, B)
    ts = rng.integers(0, 10 ** 9, B).astype(np.int64)
    vals = leaves + [ts, np.ones(B, np.int32)]
    ops = [monoid] * len(leaves) + ["max", "sum"]
    inits = [pk.monoid_identity_py(monoid, l.dtype) for l in leaves] \
        + [-1, 0]
    got = rc.dense_monoid_table(torch.from_numpy(row),
                                [torch.from_numpy(v) for v in vals], ops,
                                inits, S)
    want = pk.dense_monoid_table(jnp.asarray(row),
                                 [jnp.asarray(v) for v in vals], ops, inits,
                                 S, True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("S", [1, 4096])
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_dense_table_plain_one_slot_matches_pallas(monoid, S):
    """Every lane in the last slot (the kernel's widest match-any group
    and longest f32 chain), every dtype: exact."""
    rng = np.random.default_rng(11 + S)
    B = 300
    row = np.full(B, S - 1, np.int32)
    leaves = _table_leaves(rng, B)
    inits = [pk.monoid_identity_py(monoid, l.dtype) for l in leaves]
    got = rc.dense_monoid_table(torch.from_numpy(row),
                                [torch.from_numpy(v) for v in leaves],
                                [monoid] * len(leaves), inits, S)
    want = pk.dense_monoid_table(jnp.asarray(row),
                                 [jnp.asarray(v) for v in leaves],
                                 [monoid] * len(leaves), inits, S, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dense_table_integer_f32_sum_into_one_slot():
    """An integer-valued f32 sum of every lane into one slot at S = 4096
    is exact in both packages (partial sums stay below 2^24)."""
    rng = np.random.default_rng(29)
    B, S = 3000, 4096
    row = np.full(B, 7, np.int32)
    x = rng.integers(-1000, 1000, B).astype(np.float32)
    got = rc.dense_monoid_table(torch.from_numpy(row), [torch.from_numpy(x)],
                                ["sum"], [0.0], S)[0].numpy()
    want = np.asarray(pk.dense_monoid_table(jnp.asarray(row), [jnp.asarray(x)],
                                            ["sum"], [0.0], S, True)[0])
    np.testing.assert_array_equal(got, want)
    assert got[7] == x.astype(np.float64).sum()
    assert not got[:7].any() and not got[8:].any()


@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
def test_dense_table_random_floats(monoid):
    rng = np.random.default_rng(17)
    B, S = 2000, 37
    row = rng.integers(0, S + 1, B).astype(np.int32)
    x = rng.uniform(0.5, 1.5, (B, 2)).astype(np.float32)
    init = pk.monoid_identity_py(monoid, np.float32)
    got = rc.dense_monoid_table(torch.from_numpy(row), [torch.from_numpy(x)],
                                [monoid], [init], S)[0].numpy()
    want = np.asarray(pk.dense_monoid_table(jnp.asarray(row),
                                            [jnp.asarray(x)], [monoid],
                                            [init], S, True)[0])
    if monoid == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


def test_routed_monoid_tables_matches_pallas_front_door():
    """Per-leaf routing: leaves outside the gates (f64 in the port, a
    [B, 9] leaf) keep the torch scatter; values equal the Pallas front
    door's, with the ts column and the count."""
    rng = np.random.default_rng(23)
    B, S = 200, 31
    row = rng.integers(0, S + 2, B).astype(np.int32)
    payload = {"a": rng.integers(-50, 50, B).astype(np.int32),
               "b": rng.integers(-50, 50, B).astype(np.float64),
               "c": rng.integers(-5, 5, (B, 9)).astype(np.float32)}
    ts = rng.integers(0, 10 ** 6, B).astype(np.int64)
    for monoid in ("sum", "max"):
        def tleaf(leaf, m=monoid):
            return rc.table_leaf_plain(torch.from_numpy(row), leaf, m,
                                       fc.monoid_identity(m, leaf.dtype), S)

        def jleaf(leaf, m=monoid):
            buf = jnp.full((S + 1,) + leaf.shape[1:],
                           jfk._monoid_identity(m, leaf.dtype), leaf.dtype)
            return jfk._monoid_scatter(buf.at[jnp.asarray(row)], m)(leaf)[:S]
        tab, ts_t, cnt = rc.routed_monoid_tables(
            torch.from_numpy(row), {k: torch.from_numpy(v)
                                    for k, v in payload.items()},
            monoid, S, lax_leaf=tleaf, ts=torch.from_numpy(ts), ts_init=-1,
            want_count=True)
        jtab, jts, jcnt = pk.routed_monoid_tables(
            jnp.asarray(row), {k: jnp.asarray(v) for k, v in payload.items()},
            monoid, S, True, lax_leaf=jleaf, ts=jnp.asarray(ts), ts_init=-1,
            want_count=True)
        for k in payload:
            np.testing.assert_array_equal(tab[k].numpy(), np.asarray(jtab[k]))
        np.testing.assert_array_equal(ts_t.numpy(), np.asarray(jts))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    # nothing routable: the caller keeps its scatters
    assert rc.routed_monoid_tables(
        torch.from_numpy(row), {"b": torch.zeros(B, dtype=torch.float64)},
        "sum", S, lax_leaf=None) is None
    assert rc.routed_monoid_tables(torch.from_numpy(row),
                                   {"a": torch.zeros(B)}, "sum", 5000,
                                   lax_leaf=None) is None


def test_table_gates():
    for n, s in [(0, 1), (1, 0), (1, 1), (1 << 22, 4096), ((1 << 22) + 1, 8),
                 (8, 4097)]:
        assert rc.table_supported(n, s) == pk.table_supported(n, s)
    for shape, dt, ok in [((8,), torch.float32, True), ((8, 8), torch.int64,
                                                         True),
                          ((8, 9), torch.int32, False),
                          ((8, 2, 2), torch.int32, False),
                          ((8,), torch.bool, True),
                          ((8,), torch.float64, False),
                          ((8,), torch.int16, False)]:
        assert rc.table_leaf_ok(shape, dt) is ok
