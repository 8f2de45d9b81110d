"""Device operators: the port of ``MapTPU``/``FilterTPU``
(``windflow_tpu/ops/tpu.py:113-183``) under the reference's own names,
``MapGPU`` and ``FilterGPU`` (reference ``map_gpu.hpp``,
``filter_gpu.hpp``).

* ``MapGPU`` applies the per-record function to the batch's column dict
  (``utils.tree.per_record``), one elementwise pass over every lane.
* ``FilterGPU`` intersects the validity mask with the predicate and never
  compacts: downstream operators and the device→host boundary are
  mask-aware.

Both run in DEFAULT mode only and need an upstream output batch size > 0,
as in the reference.
"""

from __future__ import annotations

from typing import Callable

from windflow_tpu_torch.basic import RoutingMode
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.utils.tree import per_record, tree_map


class _GPUReplica(Replica):
    """Shared device-batch plumbing for device operator replicas."""

    def _op_step(self, batch: DeviceBatch):
        fx = self.op._fusion_exec
        if fx is not None:
            # the last member of an all-stateless fused segment runs the
            # whole chain (fusion/executor.py)
            return fx.step(batch)
        return self.op._step(batch)

    def process_device_batch(self, batch: DeviceBatch) -> None:
        out = self._op_step(batch)
        self.stats.device_programs_launched += 1
        if out is not None:
            self.stats.outputs_sent += out.known_size or 0
            self.emitter.emit_device_batch(out)


class MapGPU(Operator):
    """Stateless elementwise transform on the device.  ``fn`` maps one
    record to one record; with ``batch_fn=True`` it receives the whole
    column dict and the validity mask instead."""

    replica_class = _GPUReplica

    def __init__(self, fn: Callable, name: str = "map_gpu",
                 parallelism: int = 1, batch_fn: bool = False,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.fn = fn
        self.batch_fn = batch_fn

    def apply(self, payload, valid):
        """The record transform over one batch: ``(payload, valid)``."""
        if self.batch_fn:
            # its own containers: the payload may be shared by a fan-out
            return self.fn(tree_map(lambda a: a, payload), valid), valid
        return per_record(self.fn, payload, valid.shape[0]), valid

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        out_payload, _ = self.apply(batch.payload, batch.valid)
        return DeviceBatch(out_payload, batch.ts, batch.valid,
                           watermark=batch.watermark, size=batch._size,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)


class FilterGPU(Operator):
    """Device predicate filter: survivors are a validity-mask
    intersection, never a compaction."""

    replica_class = _GPUReplica

    def __init__(self, fn: Callable, name: str = "filter_gpu",
                 parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.fn = fn

    def apply(self, payload, valid):
        keep = per_record(self.fn, payload, valid.shape[0])
        return payload, valid & keep.to(valid.dtype)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        _, new_valid = self.apply(batch.payload, batch.valid)
        # survivor count unknown until read; the ts extrema stay outer
        # bounds of the surviving lanes
        return DeviceBatch(batch.payload, batch.ts, new_valid,
                           watermark=batch.watermark, frontier=batch.frontier,
                           size=None, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)
