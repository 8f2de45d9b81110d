"""Basic definitions: enums, the runtime :class:`Config`, small helpers.

The port's copy of ``windflow_tpu/basic.py`` (which imports no JAX but is
not imported across: the port stands alone).  ``Config`` keeps only the
fields the ported slices read, plus the two the port adds:
``device`` (the card unless the caller asks for the CPU) and
``cuda_kernels`` (the kernel switch, counterpart of
``Config.pallas_kernels``).
"""

from __future__ import annotations

import dataclasses
import enum
import time


class ExecutionMode(enum.Enum):
    """How replicas treat out-of-order inputs (reference ``basic.hpp:78``).

    * DEFAULT        – out-of-order processing gated by watermarks.
    * DETERMINISTIC  – inputs re-ordered by id/timestamp before processing.
    * PROBABILISTIC  – approximate ordering with an adaptive K-slack buffer.
    """

    DEFAULT = "default"
    DETERMINISTIC = "deterministic"
    PROBABILISTIC = "probabilistic"


class TimePolicy(enum.Enum):
    """Timestamping policy (reference ``basic.hpp:84``)."""

    INGRESS = "ingress"
    EVENT = "event"


class WinType(enum.Enum):
    """Window domain (reference ``basic.hpp:80``): count- or time-based."""

    CB = "count"
    TB = "time"


class RoutingMode(enum.Enum):
    """How an emitter distributes outputs (reference ``basic.hpp:87``)."""

    NONE = "none"
    FORWARD = "forward"
    KEYBY = "keyby"
    BROADCAST = "broadcast"
    REBALANCING = "rebalancing"


@dataclasses.dataclass
class Config:
    """Runtime configuration (the reference's compile-time macro set as
    per-graph values)."""

    # Punctuation (watermark flush) cadence for idle emitters, microseconds
    # (reference default 100 ms, basic.hpp:195).
    punctuation_interval_usec: int = 100_000
    # Punctuation cadence in number of inputs; 0 disables the count trigger
    # (a punctuation flushes open staging batches).
    punctuation_amount: int = 0
    # Outstanding device batches per replica inbox before the scheduler
    # throttles source ticks (reference in-transit counter,
    # recycling_gpu.hpp:88-126).
    max_inflight_batches: int = 8
    # Queued messages per replica inbox before source throttling.
    max_inbox_messages: int = 8192
    # Tuples pulled from each live source per sweep; 0 = one staged batch.
    source_tick_chunk: int = 0
    # Messages one replica may process per sweep.
    sweep_drain_limit: int = 16
    # Extra source-tick passes per sweep after the drain phase, so batch
    # N+1 is packed on the host while the card runs batch N.
    stage_prefetch_depth: int = 1
    # Hand-written CUDA kernels on the FFAT and reduce paths
    # (windflow_tpu_torch/kernels): "auto" launches them for CUDA tensors and runs their plain
    # PyTorch versions for CPU tensors; "1" forces them on (the same
    # routing); "0" is the kill switch — the torch composition runs and
    # nothing is built.
    cuda_kernels: object = "auto"
    # Device-side key compaction: a keyed ReduceGPU with withMaxKeys and
    # a declared monoid takes the bounded compacted step (out-of-range
    # keys ride the sorted overflow lane and are kept); off, it takes the
    # dense step (out-of-range keys dropped and counted).
    key_compaction: bool = True
    # Device the graph runs on.  The card is the default; without CUDA a
    # graph raises unless the caller asked for "cpu".
    device: str = "cuda"


#: Process-wide default configuration; graphs copy it at construction.
default_config = Config()


class WindFlowError(RuntimeError):
    """Raised for user/API misuse."""


def resolve_device(config) -> "object":
    """The ``torch.device`` a graph runs on.  Never falls back: a CUDA
    device without CUDA present raises."""
    import torch
    dev = torch.device(getattr(config, "device", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise WindFlowError(
            "Config.device is 'cuda' but CUDA is not available; pass "
            "Config(device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise WindFlowError(f"unsupported device {dev}")
    return dev


def current_time_usecs() -> int:
    """Wall clock in microseconds (reference ``current_time_usecs``)."""
    return time.time_ns() // 1_000
