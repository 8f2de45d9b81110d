"""Flight recorder: per-batch span tracing and log-bucketed latency
histograms (the port of ``windflow_tpu/monitoring/recorder.py``).

Device work is enqueued on the card's stream and runs later, so a
per-operator running average does not say where a batch spends its time.
This module records it a batch at a time:

* **Span events.**  A sampled batch carries a trace id
  (``HostBatch.trace`` / ``DeviceBatch.trace`` = ``(trace_id,
  t_origin_usec)``) from its birth at a source emitter or the staging
  plane to the sink.  Hooks on the batch path append ``(trace_id, stage,
  t)`` into a preallocated per-replica ring (:class:`ReplicaRing`),
  stages ``staged``, ``emitted``, ``dispatched``, ``device_done``,
  ``collected`` and ``sunk``; a full ring overwrites its oldest events.

* **Sampling.**  One batch in ``Config.trace_sample_every`` is traced;
  the others carry ``trace=None`` and every hook is one attribute check.
  ``device_done`` waits for the step's device work (a CUDA event recorded
  after the step, then synchronized), so only every
  ``Config.trace_device_sync_every``-th traced batch stamps it.

* **Histograms.**  :class:`LatencyHistogram` buckets microseconds by
  log2 (64 buckets, constant memory) and reports ``p50/p95/p99`` by
  interpolation inside the bucket, clamped to the observed ``[min,
  max]``.  Per-operator service-time histograms live in ``StatsRecord``;
  sinks fill the staged→sunk one from the trace lane.

* **Export.**  :func:`chrome_trace_from_events` renders the merged rings
  as Chrome-trace JSON (``traceEvents``), loadable in ``chrome://tracing``
  or Perfetto beside a ``torch.profiler`` capture;
  ``PipeGraph.dump_trace()`` wraps it.

With ``Config.flight_recorder`` off no recorder is built: replicas hold
``ring = None`` and emitters ``flight = None``.

* **Host spans.**  Where the batch stamps say when, the spans say where
  the host's one thread spends a sweep.  :func:`span` opens a named span
  of the graph's :class:`SpanTable` (``count``, ``total_ns`` and
  ``self_ns`` a name; self time is the span less the spans nested in
  it); while a ``torch.profiler`` capture records, each span also opens
  ``record_function(<name>)``, so the capture holds the spans on the
  clock of the card's kernels and copies.  ``PipeGraph.step`` turns the
  spans on for a sweep under ``Config.tracing_enabled`` or while a
  profiler records; off, :func:`span` is one attribute check that
  returns the shared no-op :data:`NO_SPAN` and reads no clock.  The
  spans are those of the thread that runs the sweep (the host worker
  pool's threads record none).  A replica's own span
  (:class:`ServiceSpan`: ``wf:drain:<op>`` a dispatch, ``wf:tick:<op>``
  a source tick) always takes its two clock reads, which feed the
  replica's service histogram, and joins the table when the spans are
  on.  ``stats()["Spans"]`` is :meth:`SpanTable.summary`.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from typing import List, Optional

import numpy as np

from windflow_tpu_torch.analysis import debug_concurrency as _dbg
from windflow_tpu_torch.analysis.hotpath import hot_path
from windflow_tpu_torch.basic import current_time_usecs

#: span stage codes (rings store the code, exports the name)
STAGED = 0       # host rows fixed into a device batch (staging plane)
EMITTED = 1      # host batch formed and shipped by an emitter
DISPATCHED = 2   # the step's device work enqueued for the batch
DEVICE_DONE = 3  # the step's device work finished (sampled wait)
COLLECTED = 4    # batch pulled from a replica inbox for processing
SUNK = 5         # batch reached a terminal (sink) replica

STAGE_NAMES = ("staged", "emitted", "dispatched", "device_done",
               "collected", "sunk")


class LatencyHistogram:
    """Log2-bucketed latency histogram (microseconds).  ``add`` is one
    ``int.bit_length`` and one array increment; percentiles interpolate
    inside the winning bucket and clamp to the observed ``[min, max]``,
    so empty, single-sample and boundary cases are exact."""

    __slots__ = ("counts", "count", "total", "min", "max")

    NBUCKETS = 64

    def __init__(self) -> None:
        self.counts = np.zeros(self.NBUCKETS, np.int64)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    @hot_path
    def add(self, usec: float) -> None:
        if usec < 0:
            usec = 0.0
        # bucket b holds values in [2^(b-1), 2^b); 0 lands in bucket 0
        b = int(usec).bit_length()
        if b >= self.NBUCKETS:
            b = self.NBUCKETS - 1
        self.counts[b] += 1
        self.count += 1
        self.total += usec
        if usec < self.min:
            self.min = usec
        if usec > self.max:
            self.max = usec

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        self.counts += other.counts
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Value at quantile ``p`` in [0, 1]; an empty histogram gives
        0.0."""
        if self.count == 0:
            return 0.0
        rank = p * self.count
        cum = 0
        for b in range(self.NBUCKETS):
            c = int(self.counts[b])
            if c == 0:
                continue
            if cum + c >= rank:
                lo = 0.0 if b == 0 else float(1 << (b - 1))
                hi = float(1 << b)
                frac = (rank - cum) / c
                val = lo + frac * (hi - lo)
                return min(max(val, self.min), self.max)
            cum += c
        return self.max

    def bucket_counts(self) -> list:
        """Nonzero ``[upper_bound_usec, count]`` pairs (bucket ``b`` holds
        values below ``2^b``)."""
        return [[float(1 << b) if b else 1.0, int(c)]
                for b, c in enumerate(self.counts.tolist()) if c]

    def quantiles(self) -> dict:
        """The ``p50/p95/p99`` dict of ``StatsRecord.to_json`` and
        ``PipeGraph.stats()``, with ``sum`` and the raw ``buckets``."""
        return {
            "count": self.count,
            "mean": round(self.mean(), 3),
            "p50": round(self.percentile(0.50), 3),
            "p95": round(self.percentile(0.95), 3),
            "p99": round(self.percentile(0.99), 3),
            "max": round(self.max, 3) if self.count else 0.0,
            "sum": round(self.total, 3),
            "buckets": self.bucket_counts(),
        }


class ReplicaRing:
    """Preallocated span-event ring of one replica: ``record`` writes four
    scalars into numpy arrays at a wrapping index, with no allocation and
    no lock (one thread drives a replica)."""

    __slots__ = ("op_name", "replica_index", "size", "trace", "stage", "t",
                 "shared_k", "n")

    def __init__(self, op_name: str, replica_index: int, size: int) -> None:
        self.op_name = op_name
        self.replica_index = replica_index
        self.size = max(8, int(size))
        self.trace = np.zeros(self.size, np.int64)
        self.stage = np.zeros(self.size, np.int8)
        self.t = np.zeros(self.size, np.int64)
        #: K of the megastep group whose stamp the event shares (0: the
        #: batch's own stamp)
        self.shared_k = np.zeros(self.size, np.int16)
        self.n = 0          # events ever recorded (wraps the index)

    @hot_path
    def record(self, trace_id: int, stage: int, t_usec: int,
               shared: int = 0) -> None:
        if _dbg.ENABLED:
            # the lock-free write is safe only because one thread drives
            # a replica at a time: overlapping writes are the race
            with _dbg.entry_guard(self, "ReplicaRing.record"):
                return self._record_impl(trace_id, stage, t_usec, shared)
        return self._record_impl(trace_id, stage, t_usec, shared)

    @hot_path
    def _record_impl(self, trace_id: int, stage: int, t_usec: int,
                     shared: int = 0) -> None:
        i = self.n % self.size
        self.trace[i] = trace_id
        self.stage[i] = stage
        self.t[i] = t_usec
        self.shared_k[i] = shared
        self.n += 1

    def events(self) -> List[dict]:
        """Retained events, oldest first."""
        k = min(self.n, self.size)
        start = self.n % self.size if self.n > self.size else 0
        out = []
        for j in range(k):
            i = (start + j) % self.size
            out.append({
                "op": self.op_name,
                "replica": self.replica_index,
                "trace": int(self.trace[i]),
                "stage": STAGE_NAMES[int(self.stage[i])],
                "t_usec": int(self.t[i]),
                "shared_k": int(self.shared_k[i]),
            })
        return out


class FlightRecorder:
    """Graph-scoped recorder: the per-replica rings, the trace-id counter
    and the sampling decision.  Built by ``PipeGraph._build`` when
    ``Config.flight_recorder`` is on."""

    def __init__(self, sample_every: int = 64, ring_events: int = 65536,
                 device_sync_every: int = 8,
                 expected_rings: int = 1) -> None:
        self.sample_every = max(1, int(sample_every))
        self.ring_events = max(8, int(ring_events))
        self.device_sync_every = max(0, int(device_sync_every))
        self.expected_rings = max(1, int(expected_rings))
        self.rings: List[ReplicaRing] = []
        # itertools.count: __next__ is atomic under the GIL
        self._seq = itertools.count(1)
        self.traces_started = 0

    def maybe_trace(self) -> Optional[tuple]:
        """Sampling decision for one new batch: ``(trace_id, t_origin)``
        for the 1-in-N sampled batch, None otherwise."""
        seq = next(self._seq)
        if seq % self.sample_every:
            return None
        self.traces_started += 1
        return (seq, current_time_usecs())

    def ring_for(self, op_name: str, replica_index: int) -> ReplicaRing:
        # ring_events splits over the graph's replicas, so retained events
        # stay bounded whatever the graph's width
        per = max(64, self.ring_events // self.expected_rings)
        ring = ReplicaRing(op_name, replica_index, per)
        self.rings.append(ring)
        return ring

    def events(self) -> List[dict]:
        ev = [e for ring in self.rings for e in ring.events()]
        ev.sort(key=lambda e: e["t_usec"])
        return ev

    def summary(self) -> dict:
        return {
            "enabled": True,
            "sample_every": self.sample_every,
            "device_sync_every": self.device_sync_every,
            "traces_started": self.traces_started,
            "events_recorded": sum(r.n for r in self.rings),
            "events_retained": sum(min(r.n, r.size) for r in self.rings),
            "rings": len(self.rings),
        }

    def to_chrome_trace(self) -> dict:
        return chrome_trace_from_events(self.events())


def chrome_trace_from_events(events: List[dict],
                             metadata: Optional[dict] = None) -> dict:
    """Render span events as Chrome-trace JSON (``traceEvents``), loadable
    in ``chrome://tracing`` and Perfetto; ``metadata`` is merged into
    ``otherData``.  One thread track per ``(op, replica)`` with an instant
    event a record, and one async span per traced batch and stage pair
    (``b``/``e`` keyed by the trace id)."""
    trace_events: List[dict] = []
    tids = {}
    for e in events:
        key = (e["op"], e["replica"])
        if key not in tids:
            tids[key] = len(tids)
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": 1,
                "tid": tids[key],
                "args": {"name": f"{e['op']}[{e['replica']}]"},
            })
    per_trace = {}
    for e in events:
        trace_events.append({
            "name": e["stage"], "ph": "i", "s": "t",
            "ts": e["t_usec"], "pid": 1, "tid": tids[(e["op"],
                                                      e["replica"])],
            "args": {"trace": e["trace"]},
        })
        per_trace.setdefault(e["trace"], []).append(e)
    for trace_id, evs in per_trace.items():
        evs.sort(key=lambda e: e["t_usec"])
        for a, b in zip(evs, evs[1:]):
            span = {"cat": "batch", "id": trace_id, "pid": 1, "tid": 0,
                    "name": f"{a['stage']}→{b['stage']}"}
            trace_events.append(dict(span, ph="b", ts=a["t_usec"]))
            trace_events.append(dict(span, ph="e", ts=b["t_usec"]))
    other = {"source": "windflow_tpu flight recorder", "clock": "wall_usec"}
    if metadata:
        other.update(metadata)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_chrome_trace(events: List[dict], path: str,
                       metadata: Optional[dict] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace_from_events(events, metadata), f)
    return path


# -- host spans ---------------------------------------------------------------

class _NoSpan:
    """The context every :func:`span` returns while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


#: the shared no-op span
NO_SPAN = _NoSpan()


class _Active(threading.local):
    #: the table of the sweep running on this thread, None when its
    #: spans are off
    table = None


_active = _Active()


def span(name: str):
    """A context manager timing ``name`` in the running sweep's
    :class:`SpanTable`; :data:`NO_SPAN` while spans are off."""
    tab = _active.table
    if tab is None:
        return NO_SPAN
    return tab.span(name)


def activate(table: Optional["SpanTable"]) -> Optional["SpanTable"]:
    """Make ``table`` this thread's span table (None: spans off);
    returns the previous one, for the caller to restore."""
    prev = _active.table
    _active.table = table
    return prev


def note_staged(n: int = 1) -> None:
    """Count ``n`` batches staged into the running sweep's table (the
    per-batch denominator of its spans)."""
    tab = _active.table
    if tab is not None:
        tab.batches_staged += n


_tprof = None


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` capture records (torch's own
    flag, set by the profiler's start and cleared by its stop)."""
    global _tprof
    if _tprof is None:
        from torch.autograd import profiler
        _tprof = profiler
    return bool(getattr(_tprof, "_is_profiler_enabled", False))


class _Span:
    """One name's span of a table, made once and entered again at every
    site of that name."""

    __slots__ = ("table", "name", "index")

    def __init__(self, table: "SpanTable", name: str, index: int) -> None:
        self.table = table
        self.name = name
        self.index = index

    def __enter__(self):
        self.table.enter(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.table.exit()
        return False


class SpanTable:
    """Graph-scoped host spans: per name, ``count``, ``total_ns`` and
    ``self_ns`` (the span's time less that of the spans nested in it),
    and the stack of open spans.  ``clock`` is injectable (the tests')."""

    def __init__(self, clock=time.perf_counter_ns) -> None:
        self.clock = clock
        #: True once a sweep ran with the spans on
        self.enabled = False
        #: open ``record_function`` beside each span (a profiler records)
        self.profiling = False
        #: batches staged while the spans were on
        self.batches_staged = 0
        self._spans = {}
        self.names: List[str] = []
        self.count: List[int] = []
        self.total_ns: List[int] = []
        self.self_ns: List[int] = []
        #: open spans: [index, start, nested ns, record_function or None]
        self._stack: list = []

    def span(self, name: str) -> _Span:
        s = self._spans.get(name)
        if s is None:
            s = _Span(self, name, len(self.names))
            self.names.append(name)
            self.count.append(0)
            self.total_ns.append(0)
            self.self_ns.append(0)
            self._spans[name] = s
        return s

    def enter(self, s: _Span) -> None:
        rf = None
        if self.profiling:
            profiler_recording()        # loads torch's profiler module
            rf = _tprof.record_function(s.name)
            rf.__enter__()
        self._stack.append([s.index, self.clock(), 0, rf])

    def exit(self) -> int:
        """Close the innermost span; returns its duration in ns."""
        t1 = self.clock()
        i, t0, nested, rf = self._stack.pop()
        if rf is not None:
            rf.__exit__(None, None, None)
        dur = t1 - t0
        self.count[i] += 1
        self.total_ns[i] += dur
        self.self_ns[i] += dur - nested
        if self._stack:
            self._stack[-1][2] += dur
        return dur

    def summary(self) -> dict:
        """``stats()["Spans"]``: ``{"enabled": False}`` until the spans
        have been on."""
        if not self.enabled:
            return {"enabled": False}
        rows = list(zip(self.names, self.count, self.total_ns,
                        self.self_ns))
        return {"enabled": True, "batches_staged": self.batches_staged,
                "spans": {n: {"count": c, "total_ms": t / 1e6,
                              "self_ms": s / 1e6}
                          for n, c, t, s in rows}}


class ServiceSpan:
    """A replica's own span (``wf:drain:<op>`` around each dispatch,
    ``wf:tick:<op>`` around a source's tick).  Its two clock reads are
    always taken and feed ``stats``' service time and histogram; while
    the spans are on the same reads are the table's.  One thread drives a
    replica, so one instance serves every entry."""

    __slots__ = ("name", "stats", "_t0", "_tab")

    def __init__(self, name: str, stats) -> None:
        self.name = name
        self.stats = stats
        self._t0 = 0
        self._tab = None

    def __enter__(self):
        tab = _active.table
        self._tab = tab
        if tab is None:
            self._t0 = time.perf_counter_ns()
        else:
            tab.enter(tab.span(self.name))
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        tab = self._tab
        if tab is None:
            dur = time.perf_counter_ns() - self._t0
        else:
            self._tab = None
            dur = tab.exit()
        if exc_type is None:
            self.stats.add_service(dur / 1e3)
        return False
