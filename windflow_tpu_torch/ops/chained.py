"""Operator chaining (the port of ``windflow_tpu/ops/chained.py``).

``pipe.chain(op)`` fuses same-parallelism FORWARD device operators
(reference ``multipipe.hpp:553-569``) into one :class:`ChainedGPU`: the
stages run back to back on the same batch inside one replica, with no
queue hop and no intermediate ``DeviceBatch`` between them.
"""

from __future__ import annotations

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU, _GPUReplica


def _stages(op):
    if isinstance(op, ChainedGPU):
        return op.stages
    if isinstance(op, (MapGPU, FilterGPU)):
        return [op]
    raise WindFlowError(f"cannot chain operator type {type(op).__name__}")


class ChainedGPU(Operator):
    replica_class = _GPUReplica

    def __init__(self, stages, name, parallelism, routing, key_extractor):
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.stages = stages

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        payload, valid = batch.payload, batch.valid
        filtered = False
        for st in self.stages:
            payload, valid = st.apply(payload, valid)
            filtered |= isinstance(st, FilterGPU)
        return DeviceBatch(payload, batch.ts, valid,
                           watermark=batch.watermark,
                           size=None if filtered else batch._size,
                           frontier=batch.frontier, ts_max=batch.ts_max,
                           ts_min=batch.ts_min)


def chainable(op: Operator) -> bool:
    return isinstance(op, (MapGPU, FilterGPU, ChainedGPU))


def fuse(a: Operator, b: Operator) -> Operator:
    """Fuse two chainable device operators into one stage."""
    fused = ChainedGPU(_stages(a) + _stages(b), f"{a.name}|{b.name}",
                       a.parallelism, a.routing, a.key_extractor)
    closers = [f for f in (a.closing_func, b.closing_func) if f is not None]
    if closers:
        from windflow_tpu_torch.meta import adapt
        adapted = [adapt(f, 0) for f in closers]

        def closing(ctx):
            for f in adapted:
                f(ctx)
        fused.closing_func = closing
    return fused
