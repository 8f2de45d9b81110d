"""Fluent operator builders (the port of ``windflow_tpu/graph/builders.py``;
reference ``builders.hpp`` and ``builders_gpu.hpp``).  Device builders take
the reference's GPU names: ``MapGPU_Builder``, ``FilterGPU_Builder``,
``ReduceGPU_Builder`` and ``Ffat_WindowsGPU_Builder``."""

from __future__ import annotations

from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import RoutingMode, WindFlowError, WinType
from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
from windflow_tpu_torch.ops.reduce import ReduceGPU
from windflow_tpu_torch.ops.sink import Sink
from windflow_tpu_torch.ops.source import Source
from windflow_tpu_torch.windows.engine import WindowSpec
from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU


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

    def _routing(self) -> RoutingMode:
        return (RoutingMode.KEYBY if self._key_extractor is not None
                else RoutingMode.FORWARD)


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


class Sink_Builder(_BuilderBase):
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


class MapGPU_Builder(_BuilderBase):
    _default_name = "map_gpu"

    def __init__(self, fn: Callable, batch_fn: bool = False) -> None:
        super().__init__()
        self._fn = fn
        self._batch_fn = batch_fn

    def build(self) -> MapGPU:
        return MapGPU(self._fn, name=self._name,
                      parallelism=self._parallelism,
                      batch_fn=self._batch_fn, routing=self._routing(),
                      key_extractor=self._key_extractor)


class FilterGPU_Builder(_BuilderBase):
    _default_name = "filter_gpu"

    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self._fn = fn

    def build(self) -> FilterGPU:
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
    * a declared monoid WITHOUT ``withMaxKeys`` takes the sorted route
      here (the JAX package compacts it through a ``KeyCompactor``,
      not ported yet) — the records are the same either way."""

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


class Ffat_WindowsGPU_Builder(_BuilderBase):
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
        self._win_type = None
        self._win_len = 0
        self._slide = 0
        self._lateness = 0
        self._pane_capacity = None
        self._overflow_policy = "drop"

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

    def withMaxKeys(self, n: int):
        """Size of the dense device key space [0, n)."""
        self._max_keys = int(n)
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
        if self._win_type is None:
            raise WindFlowError(
                "window operator needs withCBWindows or withTBWindows")
        if self._win_len <= 0 or self._slide <= 0:
            raise WindFlowError("window length and slide must be > 0")
        return FfatWindowsGPU(
            self._lift, self._comb,
            WindowSpec(self._win_type, self._win_len, self._slide,
                       self._lateness),
            max_keys=self._max_keys, name=self._name,
            parallelism=self._parallelism,
            key_extractor=self._key_extractor,
            pane_capacity=self._pane_capacity,
            overflow_policy=self._overflow_policy, monoid=self._monoid)
