"""Operator chaining (the port of ``windflow_tpu/ops/chained.py``).

``pipe.chain(op)`` fuses same-parallelism FORWARD operators (reference
``multipipe.hpp:553-569``):

* host Map/Filter/FlatMap stages compose into one :class:`ChainedHost`
  replica, a closure pipeline with no intermediate batching;
* device Map/Filter stages compose into one :class:`ChainedGPU`, whose
  stages run back to back on the same batch inside one replica.  Its
  step IS the fusion executor's chain step
  (``fusion/executor.FusedStatelessExec``): a ChainedGPU is the one-op
  fused segment, so pairwise chaining and whole-chain fusion share one
  stage loop and one downstream key extraction.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.ops.filter_op import Filter
from windflow_tpu_torch.ops.flatmap_op import FlatMap
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU, _GPUReplica
from windflow_tpu_torch.ops.map_op import Map


# ---------------------------------------------------------------------------
# host chaining
# ---------------------------------------------------------------------------

def _host_specs(op) -> List[Tuple[str, Callable]]:
    if isinstance(op, ChainedHost):
        return op.specs
    if isinstance(op, Map):
        return [("map", adapt(op.fn, 1))]
    if isinstance(op, Filter):
        return [("filter", adapt(op.fn, 1))]
    if isinstance(op, FlatMap):
        return [("flatmap", adapt(op.fn, 2))]
    raise WindFlowError(f"cannot chain operator type {type(op).__name__}")


class _ChainShipper:
    __slots__ = ("call", "ts", "wm", "ctx")

    def __init__(self):
        self.call = None
        self.ts = 0
        self.wm = 0
        self.ctx = None

    def push(self, item):
        self.call(item, self.ts, self.wm, self.ctx)


class ChainedHostReplica(Replica):
    copy_on_shared = True  # fused map/filter stages may mutate in place

    def __init__(self, op: "ChainedHost", index: int) -> None:
        super().__init__(op, index)
        self._exp = 0

        def tail(item, ts, wm, ctx):
            self.stats.outputs_sent += 1
            # a fused flatmap emits several outputs an input: each gets
            # its own origin id (the flatmap Shipper's contract)
            tid = self.cur_tid
            if tid is not None:
                tid = tid + (self._exp,)
                self._exp += 1
            self.emitter.emit(item, ts, wm, tid=tid)

        call = tail
        for kind, fn in reversed(op.specs):
            call = self._make_stage(kind, fn, call)
        self._head = call

    @staticmethod
    def _make_stage(kind, fn, nxt):
        if kind == "map":
            def stage(item, ts, wm, ctx):
                out = fn(item, ctx)
                nxt(out if out is not None else item, ts, wm, ctx)
        elif kind == "filter":
            def stage(item, ts, wm, ctx):
                if fn(item, ctx):
                    nxt(item, ts, wm, ctx)
        else:  # flatmap
            shipper = _ChainShipper()
            shipper.call = nxt

            def stage(item, ts, wm, ctx):
                shipper.ts = ts
                shipper.wm = wm
                shipper.ctx = ctx
                fn(item, shipper, ctx)
        return stage

    def process_single(self, item, ts, wm):
        self._exp = 0
        self._head(item, ts, wm, self.context)


class ChainedHost(Operator):
    replica_class = ChainedHostReplica

    def __init__(self, specs, name, parallelism, routing, output_batch_size,
                 key_extractor):
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.specs = specs


# ---------------------------------------------------------------------------
# device chaining
# ---------------------------------------------------------------------------

def gpu_stages(op):
    """The Map/Filter stages a chainable device operator applies, in
    order."""
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
        from windflow_tpu_torch.fusion.executor import FusedStatelessExec
        self._chain = FusedStatelessExec(name, [self])

    def set_downstream_key_extractor(self, key_fn) -> None:
        """Forward the keys lane: the downstream KEYBY consumer's extractor
        runs on this chain's OUTPUT records and rides the output batch, so
        neither the keyby emitter nor the consumer extracts again."""
        self._chain.set_downstream_key_extractor(key_fn)

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        return self._chain.step(batch)


def chainable(op: Operator) -> bool:
    """True for the device operators :func:`fuse` folds into one
    :class:`ChainedGPU` stage."""
    return isinstance(op, (MapGPU, FilterGPU, ChainedGPU))


def host_chainable(op: Operator) -> bool:
    return isinstance(op, (Map, Filter, FlatMap, ChainedHost))


def chain_closers(closers):
    """One closing function running every constituent's closer in order
    (a fused replica terminates once), or None."""
    closers = [f for f in closers if f is not None]
    if not closers:
        return None
    adapted = [adapt(f, 0) for f in closers]

    def closing(ctx):
        for f in adapted:
            f(ctx)
    return closing


def fuse(a: Operator, b: Operator) -> Operator:
    """Fuse two chainable operators (both host or both device) into one
    stage."""
    name = f"{a.name}|{b.name}"
    if a.is_gpu:
        fused = ChainedGPU(gpu_stages(a) + gpu_stages(b), name,
                           a.parallelism, a.routing, a.key_extractor)
    else:
        fused = ChainedHost(_host_specs(a) + _host_specs(b), name,
                            a.parallelism, a.routing, b.output_batch_size,
                            a.key_extractor)
    fused.closing_func = chain_closers([a.closing_func, b.closing_func])
    return fused
