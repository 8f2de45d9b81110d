"""The port's kernel modules against the JAX package
(windflow_tpu_torch/kernels/ffat_cuda.py vs windflow_tpu/kernels/
pallas_ffat.py and the lax compositions the Pallas kernels replace).

On the CPU each kernel wrapper takes its plain torch version, so these
tests hold the plain versions against the Pallas kernels run as the JAX
package's own tests run them (``interpret=True``) and against the lax
compositions.  Inputs come from numpy with a fixed seed and are fed to
both packages.  Tolerances:

* grouping: exact (integer arithmetic);
* sliding fold vs the lax fold: exact — same combine tree;
* sliding fold vs the Pallas kernel: exact for max/min, int32, and f32
  sums of integer-valued data; rtol 1e-6 for random f32 sums, whose MXU
  banded matmul contracts in another order (pallas_ffat.py:40-46).

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


def test_fold_gate():
    x = torch.zeros((4, 100), dtype=torch.float32)
    assert fc.fold_supported(x, 8, "sum")
    assert fc.fold_supported({"a": x, "b": x.int()}, 512, "max")
    assert not fc.fold_supported(x, 8, None)            # generic combiner
    assert not fc.fold_supported(x, 513, "sum")         # R ceiling
    assert not fc.fold_supported(x.double(), 8, "sum")  # dtype gate
    assert not fc.fold_supported(x[:, :, None], 8, "sum")
    assert not fc.fold_supported(torch.zeros((4, 4090)), 8, "sum")


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
    assert fc.kernel_build_count() == before + 2
    assert fc.launch_counts() == {"grouping_rank_hist": 0, "sliding_fold": 0}


def test_kernel_entry_needs_nvcc_and_raises_without(monkeypatch):
    """No fallback: where a kernel must be built and nvcc is missing, the
    build raises."""
    from windflow_tpu_torch.kernels import build
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(WindFlowError, match="nvcc not found"):
        build.nvcc_path()
