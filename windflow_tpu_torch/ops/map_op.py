"""Host Map operator (the port of ``windflow_tpu/ops/map_op.py``;
reference ``map.hpp:57-215``): transforming (``fn(t) -> out``) or in
place (``fn`` returns ``None`` after mutating its argument), each
optionally "riched" with a trailing RuntimeContext."""

from __future__ import annotations

from typing import Any, Callable

from windflow_tpu_torch.basic import RoutingMode
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


class MapReplica(Replica):
    copy_on_shared = True  # the in-place variant mutates its input

    def __init__(self, op: "Map", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, 1)

    def process_single(self, item, ts, wm):
        out = self._fn(item, self.context)
        if out is None:  # in-place variant: the (mutated) input moves on
            out = item
        self.stats.outputs_sent += 1
        self.emitter.emit(out, ts, wm, tid=self.cur_tid)


class Map(Operator):
    replica_class = MapReplica

    def __init__(self, fn: Callable[[Any], Any], name: str = "map",
                 parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 output_batch_size: int = 0, key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
