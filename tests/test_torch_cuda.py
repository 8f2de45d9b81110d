"""The port's CUDA kernels against their plain torch versions, on the
card (windflow_tpu_torch/kernels/ffat_cuda.py and reduce_cuda.py).
Every test is marked
``cuda`` and skips without an NVIDIA GPU.  This file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The grouping and fold kernels are exact, so those comparisons are bit
for bit.  The dense-table kernel is bit for bit too on max, min,
integers, bool and integer-valued f32 sums; a random f32 sum is held to
identical bits from call to call and to rtol 1e-5 against the plain
scatter-add (the declared-sum reassociation tolerance).
"""

import numpy as np
import pytest
import torch

from windflow_tpu_torch import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels import reduce_cuda as rc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB", [(262144, 1025), (1000, 2), (262221, 4096),
                                  (1, 2)])
def test_cuda_grouping_kernel_matches_plain(cuda_device, B, NB):
    rng = np.random.default_rng(B + NB)
    ids = torch.from_numpy(rng.integers(0, NB, B).astype(np.int32)) \
        .to(cuda_device)
    fc.reset_launch_counts()
    got = fc.grouping_rank_hist(ids, NB)
    assert fc.launch_counts()["grouping_rank_hist"] == 1
    for g, w in zip(got, fc.grouping_rank_hist_plain(ids, NB)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,NB,one", [(262144, 1025, 7), (4097, 2, 1),
                                      (4096, 4096, 4095),
                                      (1 << 22, 1025, None),
                                      (1 << 22, 4096, None),
                                      (4095, 4096, None),
                                      (262221, 1025, None)])
def test_cuda_grouping_kernel_edges(cuda_device, B, NB, one):
    """The redesign's edges: one id for every lane (the widest match-any
    group), NB = 4096 (the warps' counts above 48 KB of shared memory),
    the gate's 2^22 lanes, B not a multiple of the 2,048-lane tile."""
    rng = np.random.default_rng(B + NB)
    ids = rng.integers(0, NB, B) if one is None else np.full(B, one)
    ids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    fc.reset_launch_counts()
    got = fc.grouping_rank_hist(ids, NB)
    assert fc.launch_counts()["grouping_rank_hist"] == 1
    for g, w in zip(got, fc.grouping_rank_hist_plain(ids, NB)):
        assert torch.equal(g, w)
    order, _ = fc.order_hist(ids, NB)
    assert torch.equal(order.long(), torch.sort(ids, stable=True).indices)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("K,N,R", [(1024, 2057, 8), (5, 257, 13),
                                   (3, 300, 1), (2, 3585, 512)])
def test_cuda_fold_kernel_matches_plain(cuda_device, monoid, dtype, K, N, R):
    rng = np.random.default_rng(K + N + R)
    x = torch.from_numpy(rng.standard_normal((K, N)) * 1000).to(dtype) \
        .to(cuda_device)
    v = torch.from_numpy(rng.random((K, N)) < 0.8).to(cuda_device)
    assert torch.equal(fc.sliding_fold(x, v, R, monoid),
                       fc.fold_leaf_plain(x, v, R, monoid))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    with pytest.raises(WindFlowError):
        fc.grouping_rank_hist(torch.zeros(8, dtype=torch.int64,
                                          device=cuda_device), 4)
    with pytest.raises(WindFlowError):
        fc.sliding_fold(torch.zeros((4, 8), dtype=torch.float64,
                                    device=cuda_device),
                        torch.ones((4, 8), dtype=torch.bool,
                                   device=cuda_device), 2, "sum")


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("B,S", [(262144, 1024), (64, 8), (300, 17),
                                 (100, 4096), (5, 1), (262221, 4096)])
def test_cuda_dense_table_kernel_matches_plain(cuda_device, monoid, B, S):
    rng = np.random.default_rng(B + S + len(monoid))
    row = torch.from_numpy(rng.integers(-2, S + 2, B).astype(np.int32)) \
        .to(cuda_device)
    leaves = [rng.integers(-2**40, 2**40, (B, 3)).astype(np.int64),
              rng.integers(-100, 100, B).astype(np.float32),
              rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
              rng.random(B) < 0.3]
    leaves = [torch.from_numpy(l).to(cuda_device) for l in leaves]
    inits = [fc.monoid_identity(monoid, l.dtype) for l in leaves]
    fc.reset_launch_counts()
    got = rc.dense_monoid_table(row, leaves, [monoid] * 4, inits, S)
    assert fc.launch_counts()["dense_monoid_table"] == 1
    want = rc.dense_monoid_table_plain(row, leaves, [monoid] * 4, inits, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("monoid", ["sum", "max", "min"])
@pytest.mark.parametrize("B,S,one", [(262144, 1024, 5), (4097, 4096, 4095),
                                     (1 << 22, 1024, None),
                                     (4095, 33, None), (2049, 4096, None)])
def test_cuda_dense_table_kernel_edges(cuda_device, monoid, B, S, one):
    """The redesign's edges: every lane in one slot (the widest match-any
    group and f32 chain), S = 4096 (tables above 48 KB of shared
    memory), the gate's 2^22 lanes, B not a multiple of the 2,048-lane
    tile; one launch a call, bit for bit."""
    rng = np.random.default_rng(B + S + len(monoid))
    row = rng.integers(-2, S + 2, B) if one is None else np.full(B, one)
    row = torch.from_numpy(row.astype(np.int32)).to(cuda_device)
    leaves = [rng.integers(-2**40, 2**40, (B, 3)).astype(np.int64),
              rng.integers(-100, 100, B).astype(np.float32),
              rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
              rng.random(B) < 0.3]
    leaves = [torch.from_numpy(l).to(cuda_device) for l in leaves]
    inits = [fc.monoid_identity(monoid, l.dtype) for l in leaves]
    fc.reset_launch_counts()
    got = rc.dense_monoid_table(row, leaves, [monoid] * 4, inits, S)
    assert fc.launch_counts()["dense_monoid_table"] == 1
    want = rc.dense_monoid_table_plain(row, leaves, [monoid] * 4, inits, S)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,one", [(262221, None), (4097, 4095),
                                   (262144, 0)])
def test_cuda_dense_table_float_sum_at_4096_slots(cuda_device, B, one):
    """One f32-sum column at S = 4096, the shared-memory path above 48 KB:
    identical bits on two calls, within rtol 1e-5 of the exact sum."""
    rng = np.random.default_rng(B)
    S = 4096
    row = rng.integers(0, S + 1, B) if one is None else np.full(B, one)
    row = torch.from_numpy(row.astype(np.int32)).to(cuda_device)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
        .to(cuda_device)
    a = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    b = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    exact = rc.dense_monoid_table_plain(row, [x.double()], ["sum"], [0.0],
                                        S)[0]
    torch.testing.assert_close(a.double(), exact, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(262144, 1024), (300, 17)])
def test_cuda_dense_table_float_sum_is_deterministic(cuda_device, B, S):
    rng = np.random.default_rng(B)
    row = torch.from_numpy(rng.integers(0, S + 1, B).astype(np.int32)) \
        .to(cuda_device)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
        .to(cuda_device)
    a = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    b = rc.dense_monoid_table(row, [x], ["sum"], [0.0], S)[0]
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = rc.dense_monoid_table_plain(row, [x], ["sum"], [0.0], S)[0]
    torch.testing.assert_close(a, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_cuda_dense_table_rejects_what_the_kernel_does_not_take(cuda_device):
    row = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row, [torch.zeros(8, dtype=torch.float64,
                                                device=cuda_device)],
                              ["sum"], [0.0], 4)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row, [torch.zeros(8, device=cuda_device)],
                              ["sum"], [0.0], 4097)
    with pytest.raises(WindFlowError):
        rc.dense_monoid_table(row.long(), [torch.zeros(8,
                                                       device=cuda_device)],
                              ["sum"], [0.0], 4)
