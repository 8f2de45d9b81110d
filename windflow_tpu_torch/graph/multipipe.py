"""MultiPipe: a linear composition of operators (the port of
``windflow_tpu/graph/multipipe.py``; reference ``multipipe.hpp``).  A
MultiPipe records the operator sequence; the PipeGraph wires replica
inboxes and emitters at ``run()``.  Split and merge are not ported yet."""

from __future__ import annotations

from typing import List

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.sink import Sink
from windflow_tpu_torch.ops.source import Source


class MultiPipe:
    def __init__(self, graph, source: Source) -> None:
        self.graph = graph
        self.operators: List[Operator] = [source]
        self.has_sink = False

    def _check_open(self):
        if self.has_sink:
            raise WindFlowError("cannot extend a MultiPipe after its sink")

    def add(self, op: Operator) -> "MultiPipe":
        """Append an operator with a shuffle/forward connection (reference
        ``MultiPipe::add``, ``multipipe.hpp:936-1027``)."""
        self._check_open()
        if isinstance(op, Source):
            raise WindFlowError("a Source can only start a MultiPipe")
        prev = self.operators[-1]
        if op.is_gpu and prev.output_batch_size <= 0 and not prev.is_gpu:
            raise WindFlowError(
                f"GPU operator '{op.name}' must be preceded by an operator "
                "with output batch size > 0 (reference "
                "multipipe.hpp:441-444)")
        self.operators.append(op)
        return self

    def chain(self, op: Operator) -> "MultiPipe":
        """Fuse ``op`` with the previous stage when both are chainable
        device operators of the same parallelism and ``op`` is routed
        FORWARD (reference ``multipipe.hpp:553``); else ``add``."""
        from windflow_tpu_torch.ops.chained import chainable, fuse
        prev = self.operators[-1]
        if op.routing == RoutingMode.FORWARD \
                and op.parallelism == prev.parallelism \
                and chainable(prev) and chainable(op):
            self._check_open()
            self.operators[-1] = fuse(prev, op)
            return self
        return self.add(op)

    def add_sink(self, sink: Sink) -> "MultiPipe":
        self.add(sink)
        self.has_sink = True
        return self

    def chain_sink(self, sink: Sink) -> "MultiPipe":
        return self.add_sink(sink)
