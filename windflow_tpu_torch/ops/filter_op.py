"""Host Filter operator (the port of ``windflow_tpu/ops/filter_op.py``;
reference ``filter.hpp:57,245``): drops tuples failing the predicate."""

from __future__ import annotations

from typing import Any, Callable

from windflow_tpu_torch.basic import RoutingMode
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


class FilterReplica(Replica):
    copy_on_shared = True  # user predicates may mutate the record

    def __init__(self, op: "Filter", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, 1)

    def process_single(self, item, ts, wm):
        if self._fn(item, self.context):
            self.stats.outputs_sent += 1
            self.emitter.emit(item, ts, wm, tid=self.cur_tid)


class Filter(Operator):
    replica_class = FilterReplica

    def __init__(self, fn: Callable[[Any], bool], name: str = "filter",
                 parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 output_batch_size: int = 0, key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
