"""MultiPipe: a linear, then split and merged, composition of operators
(the port of ``windflow_tpu/graph/multipipe.py``; reference
``multipipe.hpp``).  A MultiPipe records the operator sequence and its
split children or merge parents; the PipeGraph wires replica inboxes and
emitters at ``run()`` from that DAG."""

from __future__ import annotations

from typing import List, Optional

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.sink import Sink
from windflow_tpu_torch.ops.source import Source


def _is_composite(op) -> bool:
    """A composite window operator: not an Operator itself, but the
    ``stages()`` the graph runs (``windows/ops.py``)."""
    return not isinstance(op, Operator) and callable(
        getattr(op, "stages", None))


class MultiPipe:
    def __init__(self, graph, source: Source) -> None:
        self.graph = graph
        self.operators: List[Operator] = [source]
        self.has_sink = False
        self.has_source = True
        self.merged_into: Optional["MultiPipe"] = None
        self.split_children: List["MultiPipe"] = []
        self.split_fn = None
        self.split_parent: Optional["MultiPipe"] = None
        self.merge_parents: List["MultiPipe"] = []

    @classmethod
    def _empty(cls, graph) -> "MultiPipe":
        """A source-less pipe: a split branch or a merge result."""
        mp = cls.__new__(cls)
        mp.graph = graph
        mp.operators = []
        mp.has_sink = False
        mp.has_source = False
        mp.merged_into = None
        mp.split_children = []
        mp.split_fn = None
        mp.split_parent = None
        mp.merge_parents = []
        return mp

    # -- composition ---------------------------------------------------------
    def _check_open(self):
        if self.has_sink:
            raise WindFlowError("cannot extend a MultiPipe after its sink")
        if self.split_children:
            raise WindFlowError("cannot extend a split MultiPipe directly; "
                                "extend its branches")
        if self.merged_into is not None:
            raise WindFlowError("cannot extend a merged MultiPipe")

    def add(self, op: Operator) -> "MultiPipe":
        """Append an operator with a shuffle/forward connection (reference
        ``MultiPipe::add``, ``multipipe.hpp:936-1027``).  A composite
        window operator (Paned/MapReduce windows) expands into its
        pipeline stages, as the reference adds PLQ+WLQ / MAP+REDUCE as two
        operators (``multipipe.hpp:965-999``); its closing function is
        handed down to each stage."""
        if _is_composite(op):
            cf = getattr(op, "closing_func", None)
            for stage in op.stages():
                if cf is not None and stage.closing_func is None:
                    stage.closing_func = cf
                self.add(stage)
            return self
        self._check_open()
        if isinstance(op, Source):
            raise WindFlowError("a Source can only start a MultiPipe")
        for prev in self._upstream_ops():
            if op.is_gpu and prev.output_batch_size <= 0 \
                    and not prev.is_gpu:
                raise WindFlowError(
                    f"GPU operator '{op.name}' must be preceded by an "
                    "operator with output batch size > 0 (reference "
                    "multipipe.hpp:441-444)")
        self.operators.append(op)
        return self

    def _upstream_ops(self) -> List[Operator]:
        """Operators feeding the next appended operator: this pipe's tail,
        or, for a fresh split branch or merged pipe, the parents' tails."""
        if self.operators:
            return [self.operators[-1]]
        if self.split_parent is not None:
            return self.split_parent._upstream_ops()
        if self.merge_parents:
            return [p.operators[-1] for p in self.merge_parents
                    if p.operators]
        return []

    def chain(self, op: Operator) -> "MultiPipe":
        """Fuse ``op`` with the previous stage when both are chainable (host
        Map/Filter/FlatMap, or device Map/Filter), of the same parallelism,
        and ``op`` is routed FORWARD (reference ``multipipe.hpp:553``);
        else ``add``."""
        from windflow_tpu_torch.ops.chained import (chainable, fuse,
                                                    host_chainable)
        from windflow_tpu_torch.ops.reduce_op import Reduce
        if _is_composite(op) or isinstance(op, Reduce) \
                or not self.operators:
            # composites and Reduce cannot be chained
            # (multipipe.hpp:1042-1045); a fresh split branch or merged
            # pipe has nothing to fuse with
            return self.add(op)
        prev = self.operators[-1]
        if op.routing == RoutingMode.FORWARD \
                and op.parallelism == prev.parallelism \
                and ((chainable(prev) and chainable(op))
                     or (host_chainable(prev) and host_chainable(op))):
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

    # -- DAG composition (reference multipipe.hpp:1158-1303) -----------------
    def split(self, split_fn, n_branches: int) -> "MultiPipe":
        """Split this MultiPipe into ``n_branches`` children;
        ``split_fn(item)`` returns a branch index or an iterable of them.
        After a device stage, a split function written in torch ops over
        the record's columns splits on the device by masks."""
        self._check_open()
        if not self.operators:
            raise WindFlowError(
                "cannot split an empty MultiPipe — add an operator to this "
                "branch first")
        self.split_fn = split_fn
        for _ in range(n_branches):
            child = MultiPipe._empty(self.graph)
            child.split_parent = self
            self.split_children.append(child)
        return self

    def select(self, index: int) -> "MultiPipe":
        if not self.split_children:
            raise WindFlowError("select() on a MultiPipe that was not split")
        return self.split_children[index]

    def merge(self, *others: "MultiPipe") -> "MultiPipe":
        """Merge this MultiPipe with others into a new one (reference
        ``MultiPipe::merge``)."""
        pipes = [self, *others]
        for p in pipes:
            p._check_open()
        merged = MultiPipe._empty(self.graph)
        merged.merge_parents = pipes
        for p in pipes:
            p.merged_into = merged
        self.graph._register_merge(merged)
        return merged
