"""The port's CUDA kernels against their plain torch versions, on the
card (windflow_tpu_torch/kernels/ffat_cuda.py).  Every test is marked
``cuda`` and skips without an NVIDIA GPU.  This file imports no JAX, so
it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Both kernels are exact, so every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

from windflow_tpu_torch import WindFlowError
from windflow_tpu_torch.kernels import ffat_cuda as fc


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
