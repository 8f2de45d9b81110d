"""Host FlatMap operator (the port of ``windflow_tpu/ops/flatmap_op.py``;
reference ``flatmap.hpp:58,215``): the user function emits 0..N outputs
per input through a :class:`Shipper` (reference ``shipper.hpp:58``).
Outputs inherit the input's timestamp."""

from __future__ import annotations

from typing import Any, Callable

from windflow_tpu_torch.basic import RoutingMode
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


class Shipper:
    """Hands the user function a push interface (reference ``Shipper``)."""

    __slots__ = ("_replica", "_ts", "_wm", "pushed", "_exp")

    def __init__(self, replica: "FlatMapReplica") -> None:
        self._replica = replica
        self._ts = 0
        self._wm = 0
        self.pushed = 0
        self._exp = 0   # expansion index within the current input

    def push(self, item: Any) -> None:
        self.pushed += 1
        self._replica.stats.outputs_sent += 1
        # origin id = input id + expansion index: the k-th output of one
        # input orders after the (k-1)-th under any configuration
        tid = self._replica.cur_tid
        if tid is not None:
            tid = tid + (self._exp,)
            self._exp += 1
        self._replica.emitter.emit(item, self._ts, self._wm, tid=tid)


class FlatMapReplica(Replica):
    copy_on_shared = True  # user fn may mutate the record before shipping

    def __init__(self, op: "FlatMap", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, 2)
        self._shipper = Shipper(self)

    def process_single(self, item, ts, wm):
        self._shipper._ts = ts
        self._shipper._wm = wm
        self._shipper._exp = 0
        self._fn(item, self._shipper, self.context)


class FlatMap(Operator):
    replica_class = FlatMapReplica

    def __init__(self, fn: Callable[[Any, Shipper], None],
                 name: str = "flatmap", parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 output_batch_size: int = 0, key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
