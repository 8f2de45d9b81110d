"""Host window operators: Keyed_Windows, Parallel_Windows, Paned_Windows,
MapReduce_Windows (the port of ``windflow_tpu/windows/ops.py``; reference
``keyed_windows.hpp``, ``parallel_windows.hpp``, ``paned_windows.hpp``,
``mapreduce_windows.hpp``).

All are thin operator shells around :class:`~windflow_tpu_torch.windows.
engine.WindowEngine`, exactly as the reference builds every window operator
around ``Window_Replica``.  The compound operators are *composites*: like the
reference, which appends PLQ+WLQ / MAP+REDUCE as two pipeline stages
(``multipipe.hpp:965-999``), ``MultiPipe.add`` expands their ``stages()``.

Window results flow downstream as :class:`WindowResult` records carrying the
key, the global window id and the user value (the reference stamps key/gwid
onto the user's result type via ``setResultParameters``).  The operators
run on the host whatever the graph's device: behind a device stage their
records come back through ``batch.device_to_host`` as Python scalars, so
keys hash and place as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import (EMPTY_KEY, RoutingMode, WindFlowError,
                                      WindowRole, WinType, stable_hash)
from windflow_tpu_torch.batch import WM_NONE
from windflow_tpu_torch.ops.base import Operator, Replica
from windflow_tpu_torch.windows.engine import WindowEngine, WindowSpec


@dataclasses.dataclass
class WindowResult:
    key: Any
    wid: int
    value: Any


class _WindowReplicaBase(Replica):
    """Shared replica plumbing: feed the engine, forward watermarks, flush at
    EOS."""

    def __init__(self, op, index):
        super().__init__(op, index)
        self.engine: Optional[WindowEngine] = None  # built lazily (needs mode)

    def _ensure_engine(self):
        if self.engine is None:
            self.engine = self.op._make_engine(self)
        return self.engine

    def _emit_result(self, key, gwid, ts, value):
        self.stats.outputs_sent += 1
        # Output watermark is held back to the result timestamp: the operator
        # may still emit results for windows ending at/after this one, so the
        # input watermark would over-promise (see WindowEngine.on_watermark).
        wm = ts if self.current_wm == WM_NONE else min(self.current_wm, ts)
        self.emitter.emit(WindowResult(key, gwid, value), ts, wm)

    def process_single(self, item, ts, wm):
        eng = self._ensure_engine()
        key = self.op.key_of(item)
        eng.on_tuple(key, item, ts, wm)

    def on_watermark(self, wm):
        if self.engine is not None:
            self.engine.on_watermark(wm)

    def on_eos(self):
        self._ensure_engine().on_eos()


class _WindowOpBase(Operator):
    replica_class = _WindowReplicaBase
    # host window engines hold open-window state the durability plane
    # cannot snapshot yet (WF603 surfaces the gap at preflight)
    checkpoint_opaque = True

    def __init__(self, fn: Callable, spec: WindowSpec, *, name: str,
                 parallelism: int, routing: RoutingMode,
                 key_extractor: Optional[Callable],
                 incremental: bool, role: WindowRole,
                 output_batch_size: int = 0) -> None:
        super().__init__(name, parallelism, routing=routing,
                         output_batch_size=output_batch_size,
                         key_extractor=key_extractor)
        self.fn = fn
        self.spec = spec
        self.incremental = incremental
        self.role = role

    def key_of(self, item):
        if self.key_extractor is None:
            return EMPTY_KEY
        return self.key_extractor(item)

    def _engine_kwargs(self, replica):
        return {}

    def _make_engine(self, replica) -> WindowEngine:
        return WindowEngine(
            self.spec, self.fn, self.incremental, self.role,
            self.parallelism, replica.index, replica.mode,
            emit=replica._emit_result, stats=replica.stats,
            **self._engine_kwargs(replica))


class KeyedWindows(_WindowOpBase):
    """Keyed windows: KEYBY routing, each replica owns whole keys (reference
    ``keyed_windows.hpp:65,198``)."""

    def __init__(self, fn, spec, *, name="keyed_windows", parallelism=1,
                 key_extractor=None, incremental=False,
                 output_batch_size=0):
        routing = (RoutingMode.KEYBY if key_extractor is not None
                   else RoutingMode.FORWARD)
        if key_extractor is None and parallelism > 1:
            raise WindFlowError(
                "Keyed_Windows with parallelism > 1 requires a key extractor")
        super().__init__(fn, spec, name=name, parallelism=parallelism,
                         routing=routing, key_extractor=key_extractor,
                         incremental=incremental, role=WindowRole.SEQ,
                         output_batch_size=output_batch_size)


class ParallelWindows(_WindowOpBase):
    """Parallel windows: BROADCAST routing; replicas own windows round-robin
    by gwid (reference ``parallel_windows.hpp:66,194``)."""

    def __init__(self, fn, spec, *, name="parallel_windows", parallelism=1,
                 key_extractor=None, incremental=False, role=WindowRole.PLQ,
                 output_batch_size=0):
        super().__init__(fn, spec, name=name, parallelism=parallelism,
                         routing=RoutingMode.BROADCAST,
                         key_extractor=key_extractor,
                         incremental=incremental, role=role,
                         output_batch_size=output_batch_size)


class _WLQWindows(_WindowOpBase):
    """Second stage of Paned_Windows: windows of panes, in the pane-id
    domain (reference WLQ role, ``paned_windows.hpp:67``)."""

    def __init__(self, fn, spec, *, pane_len: int, parent_win_type: WinType,
                 name, parallelism, key_extractor, incremental,
                 output_batch_size=0):
        super().__init__(fn, spec, name=name, parallelism=parallelism,
                         routing=RoutingMode.BROADCAST,
                         key_extractor=key_extractor,
                         incremental=incremental, role=WindowRole.WLQ,
                         output_batch_size=output_batch_size)
        self.pane_len = pane_len
        self.parent_win_type = parent_win_type

    def key_of(self, item: WindowResult):
        return item.key

    def _engine_kwargs(self, replica):
        kw = {"domain_fn": lambda r: r.wid}
        if self.parent_win_type == WinType.TB:
            kw["wm_to_domain"] = lambda wm: wm // self.pane_len
        else:
            kw["count_complete"] = True
        return kw


class PanedWindows:
    """Composite: PLQ (tumbling panes of gcd(win, slide)) + WLQ (windows of
    panes) — reference ``paned_windows.hpp``, two ``Parallel_Windows`` stages.
    The user supplies a pane-level function and a window-level function, as in
    the reference builder."""

    def __init__(self, plq_fn, wlq_fn, spec: WindowSpec, *, name="paned_windows",
                 plq_parallelism=1, wlq_parallelism=1, key_extractor=None,
                 plq_incremental=False, wlq_incremental=False,
                 output_batch_size=0):
        pane_len = math.gcd(spec.win_len, spec.slide)
        if pane_len == 0:
            raise WindFlowError("window length and slide must be > 0")
        self.name = name
        pane_spec = WindowSpec(spec.win_type, pane_len, pane_len)
        self.plq = ParallelWindows(
            plq_fn, pane_spec, name=f"{name}_plq",
            parallelism=plq_parallelism, key_extractor=key_extractor,
            incremental=plq_incremental, role=WindowRole.PLQ)
        # WLQ windows live in the pane-id domain: R panes per window, sliding
        # by D panes.
        wlq_spec = WindowSpec(spec.win_type, spec.win_len // pane_len,
                              spec.slide // pane_len)
        wrapped = _wrap_result_fn(wlq_fn, wlq_incremental)
        self.wlq = _WLQWindows(
            wrapped, wlq_spec, pane_len=pane_len,
            parent_win_type=spec.win_type, name=f"{name}_wlq",
            parallelism=wlq_parallelism, key_extractor=None,
            incremental=wlq_incremental,
            output_batch_size=output_batch_size)

    def stages(self):
        return [self.plq, self.wlq]


class _WindowMergeReplica(Replica):
    """REDUCE stage of MapReduce_Windows: combine the ``p`` per-replica
    partials of each (key, gwid) window (reference REDUCE role +
    id-ordering, ``mapreduce_windows.hpp:130-141``)."""

    def __init__(self, op, index):
        super().__init__(op, index)
        self._pending = {}

    def process_single(self, item: WindowResult, ts, wm):
        k = (item.key, item.wid)
        bucket = self._pending.setdefault(k, [])
        bucket.append((item, ts))
        if len(bucket) == self.op.num_partials:
            self._flush_window(k)

    def _flush_window(self, k):
        bucket = self._pending.pop(k)
        items = [it for it, _ in bucket]
        ts = max(t for _, t in bucket)
        if self.op.incremental:
            acc = None
            for it in items:
                if it.value is not None:
                    acc = self.op.fn(it.value, acc)
            value = acc
        else:
            value = self.op.fn([it.value for it in items
                                if it.value is not None])
        self.stats.outputs_sent += 1
        wm = ts if self.current_wm == WM_NONE else min(self.current_wm, ts)
        self.emitter.emit(WindowResult(k[0], k[1], value), ts, wm)

    def on_eos(self):
        for k in sorted(self._pending, key=lambda kk: (stable_hash(kk[0]),
                                                       kk[1])):
            self._flush_window(k)


class _WindowMerge(Operator):
    replica_class = _WindowMergeReplica

    def __init__(self, fn, num_partials, *, name, parallelism, incremental,
                 output_batch_size=0):
        super().__init__(
            name, parallelism, routing=RoutingMode.KEYBY,
            output_batch_size=output_batch_size,
            key_extractor=lambda r: (stable_hash(r.key), r.wid))
        self.fn = fn
        self.num_partials = num_partials
        self.incremental = incremental


class MapReduceWindows:
    """Composite: MAP (each replica folds its share of every window's tuples)
    + REDUCE (merge the partials per window) — reference
    ``mapreduce_windows.hpp:67,130-141``."""

    def __init__(self, map_fn, reduce_fn, spec: WindowSpec, *,
                 name="mapreduce_windows", map_parallelism=1,
                 reduce_parallelism=1, key_extractor=None,
                 map_incremental=False, reduce_incremental=False,
                 output_batch_size=0):
        self.name = name
        self.map = ParallelWindows(
            map_fn, spec, name=f"{name}_map", parallelism=map_parallelism,
            key_extractor=key_extractor, incremental=map_incremental,
            role=WindowRole.MAP)
        self.reduce = _WindowMerge(
            reduce_fn, map_parallelism, name=f"{name}_reduce",
            parallelism=reduce_parallelism, incremental=reduce_incremental,
            output_batch_size=output_batch_size)

    def stages(self):
        return [self.map, self.reduce]


def _wrap_result_fn(fn, incremental):
    """WLQ user functions see pane *values*, not WindowResult wrappers."""
    if incremental:
        return lambda r, acc: fn(r.value, acc)
    return lambda results: fn([r.value for r in results])
