"""Host Reduce operator (the port of ``windflow_tpu/ops/reduce_op.py``;
reference ``reduce.hpp:58-176``): per-key rolling state, emitting the
updated state for every input.  State for an unseen key starts from
``initial_state`` (a value, shallow-copied, or a zero-argument factory).
A non-keyed Reduce folds everything into one state under ``EMPTY_KEY``."""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import EMPTY_KEY, RoutingMode, WindFlowError
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


class ReduceReplica(Replica):
    def __init__(self, op: "Reduce", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, 2)
        self._states = {}

    def _new_state(self):
        init = self.op.initial_state
        return init() if callable(init) else copy.copy(init)

    def process_single(self, item, ts, wm):
        key = (self.op.key_extractor(item)
               if self.op.key_extractor is not None else EMPTY_KEY)
        state = self._states.get(key)
        if state is None:
            state = self._new_state()
        out = self._fn(item, state, self.context)
        if out is None:  # in-place mutation variant
            out = state
        self._states[key] = out
        self.stats.outputs_sent += 1
        self.emitter.emit(copy.copy(out), ts, wm, tid=self.cur_tid)


class Reduce(Operator):
    replica_class = ReduceReplica

    # -- durable state (windflow_tpu_torch/durability) -----------------------
    def snapshot_state(self):
        """Per-replica rolling per-key state dicts (user state objects —
        must be picklable), the JAX package's blob."""
        if not self.replicas:
            return None
        return {"kind": "reduce_host",
                "replicas": [dict(r._states) for r in self.replicas]}

    def restore_state(self, blob):
        for rep, st in zip(self.replicas, blob["replicas"]):
            rep._states = dict(st)

    def __init__(self, fn: Callable[[Any, Any], Any], initial_state: Any,
                 name: str = "reduce", parallelism: int = 1,
                 key_extractor: Optional[Callable] = None,
                 output_batch_size: int = 0) -> None:
        routing = RoutingMode.KEYBY if key_extractor is not None \
            else RoutingMode.FORWARD
        if key_extractor is None and parallelism > 1:
            raise WindFlowError(
                "non-keyed Reduce requires parallelism == 1 (reference: "
                "keyless operators with state cannot be replicated)")
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
        self.initial_state = initial_state
