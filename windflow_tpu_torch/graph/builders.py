"""Fluent operator builders (the port of ``windflow_tpu/graph/builders.py``;
reference ``builders.hpp`` and ``builders_gpu.hpp``).  Host builders:
``Map_Builder``, ``Filter_Builder``, ``FlatMap_Builder`` (each with
``withBroadcast``), ``Reduce_Builder``, and the host windows
``Keyed_Windows_Builder``, ``Parallel_Windows_Builder``,
``Paned_Windows_Builder``, ``MapReduce_Windows_Builder`` and
``Ffat_Windows_Builder``; device builders take the reference's GPU names:
``MapGPU_Builder``, ``FilterGPU_Builder`` (both stateful with
``withInitialState``), ``ReduceGPU_Builder`` and
``Ffat_WindowsGPU_Builder``."""

from __future__ import annotations

from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import RoutingMode, WindFlowError, WinType
from windflow_tpu_torch.meta import _positional_arity
from windflow_tpu_torch.ops.filter_op import Filter
from windflow_tpu_torch.ops.flatmap_op import FlatMap
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
from windflow_tpu_torch.ops.gpu_stateful import (StatefulFilterGPU,
                                                 StatefulMapGPU)
from windflow_tpu_torch.ops.map_op import Map
from windflow_tpu_torch.ops.reduce_op import Reduce
from windflow_tpu_torch.ops.reduce import ReduceGPU
from windflow_tpu_torch.ops.sink import Sink
from windflow_tpu_torch.ops.source import Source
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
from windflow_tpu_torch.windows.ffat_op import FfatWindows
from windflow_tpu_torch.windows.ops import (KeyedWindows, MapReduceWindows,
                                            PanedWindows, ParallelWindows)


class _BuilderBase:
    _default_name = "op"
    _closing_func: Optional[Callable] = None

    def __init__(self) -> None:
        self._name = self._default_name
        self._parallelism = 1
        self._output_batch_size = 0
        self._key_extractor: Optional[Callable] = None

    def __init_subclass__(cls, **kwargs):
        # every build() applies the closing function the base owns
        super().__init_subclass__(**kwargs)
        orig = cls.__dict__.get("build")
        if orig is not None:
            def build(self, _orig=orig):
                op = _orig(self)
                if self._closing_func is not None:
                    op.closing_func = self._closing_func
                return op
            build.__doc__ = orig.__doc__
            cls.build = build

    def withName(self, name: str):
        self._name = name
        return self

    def withClosingFunction(self, fn: Callable):
        """Per-replica shutdown callback, ``fn(ctx)`` or ``fn()``."""
        self._closing_func = fn
        return self

    def withParallelism(self, parallelism: int):
        self._parallelism = parallelism
        return self

    def withOutputBatchSize(self, size: int):
        self._output_batch_size = size
        return self

    def withKeyBy(self, key_extractor: Callable[[Any], Any]):
        self._key_extractor = key_extractor
        return self

    def withRebalancing(self):
        """Round-robin input distribution, even after an upstream KEYBY
        (reference REBALANCING routing, ``basic.hpp:87``).  Mutually
        exclusive with withKeyBy."""
        self._rebalancing = True
        return self

    def _routing(self) -> RoutingMode:
        if getattr(self, "_broadcast", False):
            if self._key_extractor is not None \
                    or getattr(self, "_rebalancing", False):
                raise WindFlowError(
                    "withBroadcast is mutually exclusive with withKeyBy "
                    "and withRebalancing")
            return RoutingMode.BROADCAST
        if getattr(self, "_rebalancing", False):
            if self._key_extractor is not None:
                raise WindFlowError(
                    "withRebalancing and withKeyBy are mutually exclusive")
            return RoutingMode.REBALANCING
        return (RoutingMode.KEYBY if self._key_extractor is not None
                else RoutingMode.FORWARD)


class _BroadcastMixin:
    """withBroadcast for the operators the reference offers it on
    (Map/Filter/FlatMap/Sink, ``builders.hpp:252-1471``): every replica of
    the built operator receives every input tuple."""

    def withBroadcast(self):
        self._broadcast = True
        return self


class Source_Builder(_BuilderBase):
    _default_name = "source"

    def __init__(self, gen_fn: Callable) -> None:
        super().__init__()
        self._gen_fn = gen_fn
        self._ts_extractor = None
        self._record_spec = None

    def withTimestampExtractor(self, fn: Callable[[Any], int]):
        """EVENT-time sources: the event timestamp (µs) of each item."""
        self._ts_extractor = fn
        return self

    def withRecordSpec(self, example: Any):
        """Declare the records this source emits with an example record
        (static metadata, never fed to the generator)."""
        self._record_spec = example
        return self

    def withKeyBy(self, *_):
        raise WindFlowError("a Source has no input to key by")

    def withRebalancing(self):
        raise WindFlowError("a Source has no input to rebalance")

    def build(self) -> Source:
        return Source(self._gen_fn, name=self._name,
                      parallelism=self._parallelism,
                      output_batch_size=self._output_batch_size,
                      ts_extractor=self._ts_extractor,
                      record_spec=self._record_spec)


class DeviceSource_Builder(_BuilderBase):
    """Source whose batches are generated on the card
    (``io/device_source.py``): ``batch_fn(i)`` maps the Python int batch
    index to a payload pytree of ``[capacity]`` tensors on the graph's
    device."""

    _default_name = "device_source"

    def __init__(self, batch_fn: Callable) -> None:
        super().__init__()
        self._batch_fn = batch_fn
        self._capacity = 0
        self._n_batches = 0
        self._ts_fn = None
        self._wm_fn = None
        self._ts_bounds_fn = None

    def withCapacity(self, n: int):
        """Lanes per generated batch."""
        self._capacity = n
        return self

    def withNumBatches(self, n: int):
        """Total batches across all replicas (replicas stride the
        index)."""
        self._n_batches = n
        return self

    def withTimestampFn(self, ts_fn: Callable, wm_fn: Callable[[int], int]):
        """EVENT time: ``ts_fn(i)`` an int64 ``[capacity]`` lane on the
        card, ``wm_fn(i) -> int`` the batch's frontier on the host."""
        self._ts_fn = ts_fn
        self._wm_fn = wm_fn
        return self

    def withTimestampBounds(self, ts_bounds_fn: Callable):
        """Host fn ``i -> (ts_min, ts_max)`` bounding batch ``i``'s event
        timestamps (``DeviceBatch.ts_min``/``ts_max``; EVENT time)."""
        self._ts_bounds_fn = ts_bounds_fn
        return self

    def withKeyBy(self, *_):
        raise WindFlowError("a Source has no input to key by")

    def withRebalancing(self):
        raise WindFlowError("a Source has no input to rebalance")

    def withOutputBatchSize(self, n: int):
        raise WindFlowError(
            "DeviceSource batch size IS its capacity (withCapacity)")

    def build(self):
        from windflow_tpu_torch.io.device_source import DeviceSource
        return DeviceSource(self._batch_fn, self._capacity, self._n_batches,
                            name=self._name, parallelism=self._parallelism,
                            ts_fn=self._ts_fn, wm_fn=self._wm_fn,
                            ts_bounds_fn=self._ts_bounds_fn)


class Map_Builder(_BroadcastMixin, _BuilderBase):
    _default_name = "map"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn

    def build(self) -> Map:
        return Map(self._fn, name=self._name, parallelism=self._parallelism,
                   routing=self._routing(),
                   output_batch_size=self._output_batch_size,
                   key_extractor=self._key_extractor)


class Filter_Builder(_BroadcastMixin, _BuilderBase):
    _default_name = "filter"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn

    def build(self) -> Filter:
        return Filter(self._fn, name=self._name,
                      parallelism=self._parallelism,
                      routing=self._routing(),
                      output_batch_size=self._output_batch_size,
                      key_extractor=self._key_extractor)


class FlatMap_Builder(_BroadcastMixin, _BuilderBase):
    _default_name = "flatmap"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn

    def build(self) -> FlatMap:
        return FlatMap(self._fn, name=self._name,
                       parallelism=self._parallelism,
                       routing=self._routing(),
                       output_batch_size=self._output_batch_size,
                       key_extractor=self._key_extractor)


class Reduce_Builder(_BuilderBase):
    """Host per-key rolling reduce: ``fn(tuple, state) -> state`` (or
    ``None`` after mutating ``state``), from ``initial_state``."""

    _default_name = "reduce"

    def __init__(self, fn: Callable, initial_state: Any) -> None:
        super().__init__()
        self._fn = fn
        self._initial_state = initial_state

    def withRebalancing(self):
        raise WindFlowError(
            "Reduce routes by key (or runs non-replicated); REBALANCING "
            "does not apply")

    def build(self) -> Reduce:
        return Reduce(self._fn, self._initial_state, name=self._name,
                      parallelism=self._parallelism,
                      key_extractor=self._key_extractor,
                      output_batch_size=self._output_batch_size)


class Sink_Builder(_BroadcastMixin, _BuilderBase):
    _default_name = "sink"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn
        self._columnar = False
        self._columnar_defer = 2

    def withColumnarSink(self, defer: int = 2):
        """Deliver device→Sink batches as SoA numpy columns
        (``SinkColumns``) instead of per-record dicts."""
        self._columnar = True
        self._columnar_defer = defer
        return self

    def build(self) -> Sink:
        return Sink(self._fn, name=self._name, parallelism=self._parallelism,
                    routing=self._routing(),
                    key_extractor=self._key_extractor,
                    columnar=self._columnar,
                    columnar_defer=self._columnar_defer)


class _StatefulGPUMixin:
    """The stateful clauses of ``MapGPU_Builder`` / ``FilterGPU_Builder``
    (the JAX package's ``_StatefulTPUMixin``; the reference selects its
    stateful variants by the functor's (tuple, state) signature,
    ``builders_gpu.hpp:54-673``; here the per-key initial state is
    explicit)."""

    _initial_state = None
    _num_key_slots = 4096
    _dense_keys = False
    _assoc = None

    def withInitialState(self, state):
        """Per-key initial state prototype: switches the operator to the
        stateful keyed path (needs ``withKeyBy``).

        Skew warning: the default body applies each key's tuples in order
        by a rank wavefront, one application a rank, so a batch whose
        hottest key holds r tuples costs r sequential device steps (and
        one host read of the per-rank counts).  For an ASSOCIATIVE update,
        ``withAssociativeUpdate`` switches to a segmented scan that no
        skew slows (``ops/gpu_stateful.py``)."""
        self._initial_state = state
        return self

    def withNumKeySlots(self, n: int):
        """Capacity of the dense state table (most distinct keys)."""
        self._num_key_slots = n
        return self

    def withDenseKeys(self):
        """The key extractor already returns slots in [0, num_key_slots):
        no host interning, so a batch is device work with no host read
        but the wavefront's rank counts.  Out-of-range keys are masked
        invalid, as in the windows."""
        self._dense_keys = True
        return self

    def withAssociativeUpdate(self, lift, comb, project):
        """Declare the update associative: ``state' = comb(state,
        lift(record))``, the output ``project(record, state including
        this record)`` (a filter's project returns the keep bool).  A
        segmented scan then replaces the wavefront, so a hot key costs
        what uniform keys cost.  The function given to the builder is
        not called."""
        self._assoc = (lift, comb, project)
        return self

    def _stateful(self, cls, batch_fn: bool = False):
        if batch_fn:
            raise WindFlowError(
                "batch_fn is not supported for stateful MapGPU: the "
                "stateful function operates per record as "
                "fn(record, state) -> (record, state)")
        if getattr(self, "_rebalancing", False):
            raise WindFlowError(
                "stateful GPU operators route by key; REBALANCING does not "
                "apply")
        return cls(self._fn, self._initial_state, name=self._name,
                   parallelism=self._parallelism,
                   key_extractor=self._key_extractor,
                   num_key_slots=self._num_key_slots,
                   dense_keys=self._dense_keys, assoc=self._assoc)


class MapGPU_Builder(_StatefulGPUMixin, _BuilderBase):
    _default_name = "map_gpu"

    def __init__(self, fn: Callable, batch_fn: bool = False) -> None:
        super().__init__()
        self._fn = fn
        self._batch_fn = batch_fn

    def build(self):
        if self._initial_state is not None:
            return self._stateful(StatefulMapGPU, self._batch_fn)
        return MapGPU(self._fn, name=self._name,
                      parallelism=self._parallelism,
                      batch_fn=self._batch_fn, routing=self._routing(),
                      key_extractor=self._key_extractor)


class FilterGPU_Builder(_StatefulGPUMixin, _BuilderBase):
    _default_name = "filter_gpu"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn

    def build(self):
        if self._initial_state is not None:
            return self._stateful(StatefulFilterGPU)
        return FilterGPU(self._fn, name=self._name,
                         parallelism=self._parallelism,
                         routing=self._routing(),
                         key_extractor=self._key_extractor)


class ReduceGPU_Builder(_BuilderBase):
    """Reference ``ReduceGPU_Builder`` (``builders_gpu.hpp``): a per-batch
    keyed (``withKeyBy``) or global reduce on the device.  Routes, on
    one GPU:

    * no declared monoid: sorted segmented reduce over arbitrary int32
      keys;
    * ``withMaxKeys`` + ``withMonoidCombiner``: dense tables over
      ``[0, max_keys)``; with ``Config.key_compaction`` on (the default)
      out-of-range keys ride the sorted overflow lane and are kept
      (``Out_of_range_keys_rerouted``), with it off they are dropped and
      counted (``Out_of_range_keys_dropped``);
    * a declared monoid WITHOUT ``withMaxKeys``: with
      ``Config.key_compaction`` on, the unbounded compacted route (a
      ``KeyCompactor`` of ``Config.key_compaction_slots`` remaps hot keys
      to dense slots, the cold tail rides the overflow lane); off, the
      sorted route.  The records are the same either way."""

    _default_name = "reduce_gpu"

    def __init__(self, comb: Callable) -> None:
        super().__init__()
        self._comb = comb
        self._max_keys = None
        self._monoid = None

    def withRebalancing(self):
        raise WindFlowError(
            "ReduceGPU routes by key (or reduces globally); REBALANCING "
            "does not apply")

    def withMaxKeys(self, n: int):
        """Bound of the dense key space [0, n).  Ignored by undeclared
        reduces (they sort arbitrary int32 keys); with
        ``withMonoidCombiner`` it routes the reduce onto the sort-free
        dense scatter-combine tables."""
        self._max_keys = int(n)
        return self

    def withSumCombiner(self):
        """Shorthand for ``withMonoidCombiner("sum")`` (strictly additive:
        ``comb(a, b) == a + b`` on every leaf)."""
        self._monoid = "sum"
        return self

    def withMonoidCombiner(self, kind: str):
        """Declare the combiner a leafwise commutative monoid — ``"sum"``
        (``a + b``), ``"max"`` (``maximum``) or ``"min"`` (``minimum``)
        on every leaf.  With ``withMaxKeys`` the sort and segmented scan
        are replaced by one dense scatter-combine pass.  The declared
        operation is applied without calling ``comb``, so the declaration
        must match the combiner exactly on every leaf (a wrong kind
        silently computes the declared operation).  This includes a
        record's key FIELD: under ``"sum"`` the output's key field is the
        leafwise sum ``key * count`` — route by the key EXTRACTOR and read
        the dense output's position (ascending key order), or prefer
        ``"max"``/``"min"``, which are idempotent and leave a key field
        intact."""
        self._monoid = kind
        return self

    def build(self) -> ReduceGPU:
        return ReduceGPU(self._comb, name=self._name,
                         parallelism=self._parallelism,
                         key_extractor=self._key_extractor,
                         max_keys=self._max_keys, monoid=self._monoid)


# ---------------------------------------------------------------------------
# Window builders (reference Keyed_Windows_Builder / Parallel_Windows_Builder /
# Paned_Windows_Builder / MapReduce_Windows_Builder / Ffat_Windows_Builder /
# Ffat_WindowsGPU_Builder, builders.hpp + builders_gpu.hpp:576)
# ---------------------------------------------------------------------------


class _WindowBuilderBase(_BuilderBase):
    def withRebalancing(self):
        raise WindFlowError(
            "window operators route by key / broadcast; REBALANCING does "
            "not apply")

    def __init__(self):
        super().__init__()
        self._win_type = None
        self._win_len = 0
        self._slide = 0
        self._lateness = 0

    def withCBWindows(self, win_len: int, slide: int):
        self._win_type = WinType.CB
        self._win_len, self._slide = int(win_len), int(slide)
        return self

    def withTBWindows(self, win_usec: int, slide_usec: int):
        self._win_type = WinType.TB
        self._win_len, self._slide = int(win_usec), int(slide_usec)
        return self

    def withLateness(self, lateness_usec: int):
        """TB only: how far behind the watermark (µs) a tuple may arrive
        and still count; windows fire that much later."""
        self._lateness = int(lateness_usec)
        return self

    def _spec(self) -> WindowSpec:
        if self._win_type is None:
            raise WindFlowError(
                "window operator needs withCBWindows or withTBWindows")
        if self._win_len <= 0 or self._slide <= 0:
            raise WindFlowError("window length and slide must be > 0")
        return WindowSpec(self._win_type, self._win_len, self._slide,
                          self._lateness)


def _detect_incremental(fn) -> bool:
    """Non-incremental window logic takes the item list (arity 1);
    incremental logic takes (tuple, accumulator) (arity 2) — the Python
    analogue of the reference's type-based dispatch (meta.hpp).  Only
    required positionals count, so a lambda with a defaulted trailing
    argument reads as in the JAX package."""
    return _positional_arity(fn) == 2


class Keyed_Windows_Builder(_WindowBuilderBase):
    _default_name = "keyed_windows"

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def build(self) -> KeyedWindows:
        return KeyedWindows(
            self._fn, self._spec(), name=self._name,
            parallelism=self._parallelism, key_extractor=self._key_extractor,
            incremental=_detect_incremental(self._fn),
            output_batch_size=self._output_batch_size)


class Parallel_Windows_Builder(_WindowBuilderBase):
    _default_name = "parallel_windows"

    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def build(self) -> ParallelWindows:
        return ParallelWindows(
            self._fn, self._spec(), name=self._name,
            parallelism=self._parallelism, key_extractor=self._key_extractor,
            incremental=_detect_incremental(self._fn),
            output_batch_size=self._output_batch_size)


class Paned_Windows_Builder(_WindowBuilderBase):
    _default_name = "paned_windows"

    def __init__(self, plq_fn, wlq_fn):
        super().__init__()
        self._plq_fn = plq_fn
        self._wlq_fn = wlq_fn
        self._wlq_parallelism = 1

    def withParallelisms(self, plq: int, wlq: int):
        self._parallelism = plq
        self._wlq_parallelism = wlq
        return self

    def build(self) -> PanedWindows:
        return PanedWindows(
            self._plq_fn, self._wlq_fn, self._spec(),
            name=self._name,
            plq_parallelism=self._parallelism,
            wlq_parallelism=self._wlq_parallelism,
            key_extractor=self._key_extractor,
            plq_incremental=_detect_incremental(self._plq_fn),
            wlq_incremental=_detect_incremental(self._wlq_fn),
            output_batch_size=self._output_batch_size)


class MapReduce_Windows_Builder(_WindowBuilderBase):
    _default_name = "mapreduce_windows"

    def __init__(self, map_fn, reduce_fn):
        super().__init__()
        self._map_fn = map_fn
        self._reduce_fn = reduce_fn
        self._reduce_parallelism = 1

    def withParallelisms(self, map_p: int, reduce_p: int):
        self._parallelism = map_p
        self._reduce_parallelism = reduce_p
        return self

    def build(self) -> MapReduceWindows:
        return MapReduceWindows(
            self._map_fn, self._reduce_fn, self._spec(),
            name=self._name,
            map_parallelism=self._parallelism,
            reduce_parallelism=self._reduce_parallelism,
            key_extractor=self._key_extractor,
            map_incremental=_detect_incremental(self._map_fn),
            reduce_incremental=_detect_incremental(self._reduce_fn),
            output_batch_size=self._output_batch_size)


class Ffat_Windows_Builder(_WindowBuilderBase):
    _default_name = "ffat_windows"

    def __init__(self, lift_fn, comb_fn):
        super().__init__()
        self._lift = lift_fn
        self._comb = comb_fn

    def build(self) -> FfatWindows:
        return FfatWindows(
            self._lift, self._comb, self._spec(),
            name=self._name,
            parallelism=self._parallelism, key_extractor=self._key_extractor,
            lateness=self._lateness,
            output_batch_size=self._output_batch_size)


class Ffat_WindowsGPU_Builder(_WindowBuilderBase):
    """Reference ``Ffat_WindowsGPU_Builder`` (``builders_gpu.hpp:576``):
    every window a batch completes is computed in the one step, so
    ``withNumWinPerBatch`` has no counterpart.  Count-based windows (rank
    panes) and time-based windows (time-quantum panes on a ring, fired by
    the watermark; lateness applies)."""

    _default_name = "ffat_windows_gpu"

    def __init__(self, lift_fn, comb_fn):
        super().__init__()
        self._lift = lift_fn
        self._comb = comb_fn
        self._max_keys = 1
        self._monoid = None
        self._pane_capacity = None
        self._overflow_policy = "drop"

    def withMaxKeys(self, n: int):
        """Size of the dense device key space [0, n)."""
        self._max_keys = int(n)
        return self

    def withCompactedKeys(self):
        """Arbitrary int32 keys through key compaction
        (``parallel/compaction.py``): the graph build attaches a pinned
        key -> slot remap of ``Config.key_compaction_slots`` slots, so the
        dense pane state works without a declared key bound.  Keys are
        admitted at the host staging boundary; keys beyond the slot budget
        (or never admitted) are masked invalid and counted.  Needs
        ``withKeyBy`` and ``Config.key_compaction`` on; the fired records
        carry the user's keys."""
        self._max_keys = None
        return self

    def withSumCombiner(self):
        """Declare the combiner leafwise addition (``withMonoidCombiner
        ("sum")``)."""
        self._monoid = "sum"
        return self

    def withMonoidCombiner(self, kind: str):
        """Declare the combiner a leafwise commutative monoid — ``"sum"``,
        ``"max"`` or ``"min"`` on every leaf.  Count-based pane cells are
        then built by one scatter-combine (no batch permutation) and the
        sliding fold drops its flag lane; time-based placement needs no
        grouping at all.  The declaration must match the combiner
        exactly."""
        self._monoid = kind
        return self

    def withPaneCapacity(self, n: int):
        """TB only: length of the pane ring (window span panes plus slack
        for the time spread of a batch and the lateness); by default it
        is sized from the first batch and grows as needed."""
        self._pane_capacity = int(n)
        return self

    def withOverflowPolicy(self, policy: str):
        """TB ring overflow: ``"drop"`` (default: suppress windows that
        lost data panes, counted in Windows_dropped_on_overflow),
        ``"count"`` (fire them over the surviving panes: wrong
        aggregates, counted in Pane_cells_evicted) or ``"error"`` (raise
        at the next host checkpoint)."""
        self._overflow_policy = policy
        return self

    def build(self) -> FfatWindowsGPU:
        return FfatWindowsGPU(
            self._lift, self._comb, self._spec(),
            max_keys=self._max_keys, name=self._name,
            parallelism=self._parallelism,
            key_extractor=self._key_extractor,
            pane_capacity=self._pane_capacity,
            overflow_policy=self._overflow_policy, monoid=self._monoid)
