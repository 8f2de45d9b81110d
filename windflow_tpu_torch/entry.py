"""The flagship per-batch step as one port function (the counterpart of
``__graft_entry__.entry()``).

``entry()`` returns ``(step, example_args)``: the fused Map → Filter →
FFAT sliding-window sum step of the north-star pipeline, over 2,048
tuples a batch, 128 keys, count windows of 128 sliding by 32.  The
Map|Filter prelude is built by the fusion executor
(``fusion/executor.build_prelude``) from the same operators a graph
fuses, and the window step is ``make_ffat_step``: what a fused
``PipeGraph`` runs for every batch of that pipeline.  The example
arguments are the JAX entry's, made from the same seed with numpy.

The step runs on the card unless the caller asks for the CPU
(``entry(device="cpu")``); without CUDA the default raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from windflow_tpu_torch.basic import Config, resolve_device
from windflow_tpu_torch.fusion.executor import build_prelude
from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
from windflow_tpu_torch.windows.ffat_kernels import (make_ffat_state,
                                                     make_ffat_step)

#: batch capacity, keys, window length and slide of the flagship step
CAP, K, WIN, SLIDE = 2048, 128, 128, 32


def flagship_fns():
    """The pipeline's user functions: ``(map_fn, filter_fn, lift, comb,
    key_fn)``, per-record torch expressions."""
    def map_fn(x):
        return {"k": x["k"], "v": x["v"] * 1.5 + 1.0}

    def filter_fn(x):
        return (x["k"] & 7) != 7          # drops 1/8 of the tuples

    return (map_fn, filter_fn, lambda x: x["v"], lambda a, b: a + b,
            lambda x: x["k"])


def example_batch(cap: int, keys: int, device, seed: int = 0):
    """``(payload, ts, valid)`` of one full batch: the JAX entry's inputs
    (``numpy.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    payload = {
        "k": torch.from_numpy(rng.integers(0, keys, cap).astype(np.int32)),
        "v": torch.from_numpy(rng.random(cap, dtype=np.float32)),
    }
    payload = {n: a.to(device) for n, a in payload.items()}
    ts = torch.arange(cap, dtype=torch.int64, device=device)
    valid = torch.ones(cap, dtype=torch.bool, device=device)
    return payload, ts, valid


def entry(device=None, config=None):
    """``(step, (state, payload, ts, valid))``: the fused flagship step and
    its example arguments on ``device`` (the card by default)."""
    config = config or Config()
    dev = resolve_device(Config(device=str(device)) if device is not None
                         else config)
    map_fn, filter_fn, lift, comb, key_fn = flagship_fns()
    pn = math.gcd(WIN, SLIDE)
    prelude, _ = build_prelude([MapGPU(map_fn, name="map"),
                                FilterGPU(filter_fn, name="filter")])
    ffat = make_ffat_step(CAP, K, pn, WIN // pn, SLIDE // pn, lift, comb,
                          key_fn, kernels=resolve_kernels(config))

    def step(state, payload, ts, valid):
        payload, valid = prelude(payload, valid)
        return ffat(state, payload, ts, valid)

    state = make_ffat_state(torch.zeros((), dtype=torch.float32), K,
                            WIN // pn, device=dev)
    payload, ts, valid = example_batch(CAP, K, dev)
    return step, (state, payload, ts, valid)
