"""Persistent basic operators: keyed state lives in the embedded KV store
(the port of ``windflow_tpu/persistent/ops.py``; host operators).

Re-design of the reference's RocksDB operator family (``persistent/
p_filter.hpp:292``, ``p_map.hpp:272``, ``p_flatmap.hpp:256``,
``p_reduce.hpp:197``, ``p_sink.hpp:244``): every input triggers a
read-modify-write of its key's state (``p_map.hpp:178-211`` — get, apply the
user function with the state as an extra argument, put back).  User function
shapes mirror the in-memory operators with one extra ``state`` parameter:

* ``P_Map``:     ``fn(item, state[, ctx]) -> out | None`` (None = in-place)
* ``P_Filter``:  ``fn(item, state[, ctx]) -> bool``
* ``P_FlatMap``: ``fn(item, state, shipper[, ctx])``
* ``P_Reduce``:  ``fn(item, state[, ctx]) -> new_state | None`` (None =
  mutated in place); the updated state is emitted per input, as the
  in-memory Reduce does
* ``P_Sink``:    ``fn(item | None, state[, ctx])`` — ``None`` once at EOS
  with a fresh meaningless state (reference ``p_sink.hpp`` svc_end)

State durability follows the reference: the DB path outlives the run when
``keep_db=True`` (otherwise the store is deleted at operator termination,
``db_handle.hpp:108-112``); ``shared_db`` points every replica of the
operator at one store — safe because KEYBY routing partitions keys
disjointly across replicas.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import EMPTY_KEY, RoutingMode, WindFlowError
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.ops.flatmap_op import Shipper
from windflow_tpu_torch.persistent.db_handle import DBHandle


class _PersistentReplica(Replica):
    """Shared plumbing: DB handle per replica + key extraction."""

    _fn_arity = 2  # (item, state)

    def __init__(self, op: "_PersistentOperator", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, self._fn_arity)
        self.db = DBHandle(op.db_path,
                           serialize=op.serialize,
                           deserialize=op.deserialize,
                           initial_state=op.initial_state,
                           shared=op.shared_db,
                           whoami=index,
                           delete_db=not op.keep_db)

    def _key_of(self, item: Any) -> Any:
        return (self.op.key_extractor(item)
                if self.op.key_extractor is not None else EMPTY_KEY)

    def on_eos(self) -> None:
        self.db.close()


class _PersistentOperator(Operator):
    # persistent ops already own their LogKV durability, but epoch
    # alignment with the graph checkpoint is not implemented (WF603)
    checkpoint_opaque = True

    def __init__(self, fn: Callable, name: str, parallelism: int,
                 key_extractor: Optional[Callable],
                 db_path: str,
                 initial_state: Any = None,
                 serialize: Callable[[Any], bytes] = None,
                 deserialize: Callable[[bytes], Any] = None,
                 shared_db: bool = False,
                 keep_db: bool = False,
                 output_batch_size: int = 0,
                 terminal: bool = False) -> None:
        routing = RoutingMode.KEYBY if key_extractor is not None \
            else RoutingMode.FORWARD
        if key_extractor is None and parallelism > 1:
            raise WindFlowError(
                f"persistent operator '{name}' without a key extractor "
                "requires parallelism == 1 (keyed state cannot be "
                "replicated without KEYBY routing)")
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=0 if terminal
                         else output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
        self.db_path = db_path
        self.initial_state = initial_state
        self.serialize = serialize
        self.deserialize = deserialize
        self.shared_db = shared_db
        # a shared DB handle serializes its replicas on the driver thread
        # (the host worker pool must not interleave writers in one LogKV)
        self.host_pool_safe = not shared_db
        self.keep_db = keep_db


class PMapReplica(_PersistentReplica):
    def process_single(self, item, ts, wm):
        key = self._key_of(item)
        state = self.db.get(key)
        out = self._fn(item, state, self.context)
        self.db.put(key, state)
        if out is None:  # in-place variant
            out = item
        self.stats.outputs_sent += 1
        self.emitter.emit(out, ts, wm, tid=self.cur_tid)


class PMap(_PersistentOperator):
    replica_class = PMapReplica


class PFilterReplica(_PersistentReplica):
    def process_single(self, item, ts, wm):
        key = self._key_of(item)
        state = self.db.get(key)
        keep = self._fn(item, state, self.context)
        self.db.put(key, state)
        if keep:
            self.stats.outputs_sent += 1
            self.emitter.emit(item, ts, wm, tid=self.cur_tid)


class PFilter(_PersistentOperator):
    replica_class = PFilterReplica


class PFlatMapReplica(_PersistentReplica):
    _fn_arity = 3  # (item, state, shipper)

    def __init__(self, op, index):
        super().__init__(op, index)
        self._shipper = Shipper(self)

    def process_single(self, item, ts, wm):
        key = self._key_of(item)
        state = self.db.get(key)
        self._shipper._ts = ts
        self._shipper._wm = wm
        self._fn(item, state, self._shipper, self.context)
        self.db.put(key, state)


class PFlatMap(_PersistentOperator):
    replica_class = PFlatMapReplica


class PReduceReplica(_PersistentReplica):
    def process_single(self, item, ts, wm):
        key = self._key_of(item)
        state = self.db.get(key)
        out = self._fn(item, state, self.context)
        if out is None:  # in-place mutation variant
            out = state
        self.db.put(key, out)
        self.stats.outputs_sent += 1
        self.emitter.emit(copy.copy(out), ts, wm,
                          tid=self.cur_tid)


class PReduce(_PersistentOperator):
    replica_class = PReduceReplica


class PSinkReplica(_PersistentReplica):
    def process_single(self, item, ts, wm):
        key = self._key_of(item)
        state = self.db.get(key)
        self._fn(item, state, self.context)
        self.db.put(key, state)

    def on_eos(self):
        # EOS call with empty item + fresh meaningless state (reference
        # p_sink.hpp svc_end).
        self._fn(None, self.db.new_state(), self.context)
        super().on_eos()


class PSink(_PersistentOperator):
    replica_class = PSinkReplica
    is_terminal = True

    def __init__(self, *args, **kwargs):
        kwargs["terminal"] = True
        super().__init__(*args, **kwargs)
