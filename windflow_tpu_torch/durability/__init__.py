"""Durable state (the port of ``windflow_tpu/durability``):
watermark-aligned checkpoint/restore and exactly-once sinks.

* :mod:`windflow_tpu_torch.durability.checkpoint` — the
  :class:`DurabilityPlane` (epoch barriers, LogKV-backed snapshot store,
  manifest commit protocol) and ``restore_graph`` behind
  ``PipeGraph.restore()``.
* :mod:`windflow_tpu_torch.durability.sinks` — :class:`EpochFileSink`,
  the stage-then-atomic-rename exactly-once file sink.
* :mod:`windflow_tpu_torch.durability.rebucket` — restore onto another
  keyed parallelism: re-bucket keyed state blobs through the placement
  the keys route by.
* :mod:`windflow_tpu_torch.durability.chaos` — the failure-injection
  harness (seeded kills, restore, record-for-record A/B diff).

Operator blobs hold numpy only (never a ``torch.Tensor``) and keep the
JAX package's layout, so a blob written by either package restores into
the other's operator.
"""

from windflow_tpu_torch.durability.checkpoint import (CHECKPOINT_SCHEMA,
                                                      DurabilityPlane,
                                                      quiesce, restore_graph)
from windflow_tpu_torch.durability.rebucket import RescaleError, rebucket_blob
from windflow_tpu_torch.durability.sinks import EpochFileSink

__all__ = ["CHECKPOINT_SCHEMA", "DurabilityPlane", "restore_graph",
           "quiesce", "RescaleError", "rebucket_blob", "EpochFileSink"]
