"""Latency ledger: per-batch critical-path decomposition and SLO verdicts
(the port of ``windflow_tpu/monitoring/latency_ledger.py``).

The flight recorder (``monitoring/recorder.py``) stamps every sampled
batch's journey: ``staged``/``emitted`` at birth, ``dispatched`` at the
step's enqueue, ``device_done`` on the sampled wait, ``collected`` at
each inbox pull and ``sunk`` at the sink.  This ledger harvests those
rings at cadence (no work on the batch path) and lands every completed
trace in five per-operator segment histograms:

==============================  ==========================================
segment                         meaning
==============================  ==========================================
``staged_to_emitted``           ingest / staging wait
``emitted_to_dispatched``       group-formation wait (under the megastep
                                plane, the K-wait)
``dispatched_to_device_done``   device work (waited traces only)
``device_done_to_collected``    egress and the downstream inbox wait
``collected_to_sunk``           the sink's processing
==============================  ==========================================

The decomposition is a running-max boundary walk over the trace's events
(the latest occurrence of each stage), so the five segments telescope:
their sum is the trace's first→last span exactly.  A ``device_done``
stamp shared by a megastep group (``shared_k = K``) keeps its whole wall
value in the histogram but is credited 1/K in ``device_busy_usec``.

With ``Config.latency_slo_ms`` set, :meth:`LatencyLedger.tick` judges the
p99 of a rolling window of recent traces at cadence; over budget enters
a latched ``SLO_VIOLATED`` verdict naming the dominant (operator,
segment) pair of that window, cleared after ``clear_after`` consecutive
in-budget evaluations.  The health plane paints it on that operator;
``analysis/latency.py`` and ``tools/wf_slo.py`` turn the section into a
megastep/tick-chunk plan.

The window-freshness gauge (:meth:`LatencyLedger.note_window_fire`) reads
the fired records' ``ts``/``valid``: on the card a device-to-host copy,
so the window replicas call it only for a batch whose device work the
recorder has already waited on.

Off (``Config.latency_ledger`` False or no flight recorder) no ledger is
built: each call site keeps one ``is not None`` check.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from windflow_tpu_torch.analysis.hotpath import hot_path
from windflow_tpu_torch.basic import current_time_usecs
from windflow_tpu_torch.monitoring.recorder import (COLLECTED, DEVICE_DONE,
                                                    DISPATCHED, EMITTED,
                                                    SUNK, LatencyHistogram)

#: the five critical-path segments, in pipeline order; segment i ends at
#: the boundary stage ``_SEG_STAGE[i]``
SEGMENTS = (
    "staged_to_emitted",
    "emitted_to_dispatched",
    "dispatched_to_device_done",
    "device_done_to_collected",
    "collected_to_sunk",
)

_SEG_STAGE = (EMITTED, DISPATCHED, DEVICE_DONE, COLLECTED, SUNK)

#: human form for verdict messages
SEGMENT_ARROWS = {
    "staged_to_emitted": "staged→emitted",
    "emitted_to_dispatched": "emitted→dispatched",
    "dispatched_to_device_done": "dispatched→device_done",
    "device_done_to_collected": "device_done→collected",
    "collected_to_sunk": "collected→sunk",
}


def _p99(values: List[float]) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    return s[min(len(s) - 1, int(0.99 * (len(s) - 1) + 0.999))]


def _host(t) -> np.ndarray:
    """A tensor's values as numpy: a device tensor is copied into pinned
    host memory behind an event (its producer already finished: the
    callers waited on it), a CPU tensor is viewed."""
    if t.device.type == "cpu":
        return t.numpy()
    import torch
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    # wfverify: ok (the window-freshness read, behind the recorder's
    # wait only)
    ev.synchronize()
    return out.numpy()


class _OpLatency:
    """Per-operator accumulation: a histogram a segment, the wall total,
    the shared_k-deflated device-busy credit and the fire freshness."""

    __slots__ = ("segments", "total_usec", "device_busy_usec",
                 "shared_k_traces", "freshness")

    def __init__(self) -> None:
        self.segments: Dict[str, LatencyHistogram] = {}
        self.total_usec = 0.0
        self.device_busy_usec = 0.0
        self.shared_k_traces = 0
        self.freshness: Optional[LatencyHistogram] = None

    def add_segment(self, seg: str, dt: float, shared: int) -> None:
        h = self.segments.get(seg)
        if h is None:
            h = self.segments[seg] = LatencyHistogram()
        h.add(dt)
        self.total_usec += dt
        if seg == "dispatched_to_device_done":
            if shared > 1:
                self.device_busy_usec += dt / shared
                self.shared_k_traces += 1
            else:
                self.device_busy_usec += dt

    def dominant_segment(self) -> Optional[str]:
        best, best_sum = None, 0.0
        for seg, h in self.segments.items():
            if h.total > best_sum:
                best, best_sum = seg, h.total
        return best


class LatencyLedger:
    """Graph-scoped latency plane, built by ``PipeGraph._build`` when
    ``Config.latency_ledger`` and the flight recorder are on; harvests
    the recorder's rings incrementally (a cursor a ring) at cadence."""

    #: traces held open awaiting their ``sunk`` event; beyond it the
    #: oldest are dropped (and counted)
    MAX_OPEN = 2048
    #: recently finalized trace ids, so a late event cannot re-open one
    DONE_RECENT = 4096

    def __init__(self, recorder, slo_ms: float = 0.0, window: int = 512,
                 clear_after: int = 3, min_samples: int = 8) -> None:
        self.recorder = recorder
        self.slo_usec = float(slo_ms) * 1000.0
        self.clear_after = max(1, int(clear_after))
        self.min_samples = max(1, int(min_samples))
        self._cursors: Dict[int, int] = {}      # id(ring) -> consumed n
        self._open: Dict[int, list] = {}        # trace -> [(op, st, t, sh)]
        self._done_recent = deque(maxlen=self.DONE_RECENT)
        self._done_set = set()
        # rolling evaluation window: (e2e_usec, [(op, seg, dt), ...])
        self._recent = deque(maxlen=max(16, int(window)))
        self.per_op: Dict[str, _OpLatency] = {}
        self.e2e = LatencyHistogram()
        self.segment_totals = {seg: 0.0 for seg in SEGMENTS}
        self.traces_decomposed = 0
        self.traces_dropped = 0
        self.events_lost = 0
        #: the megastep plane (set by PipeGraph._build): each edge's K and
        #: freshness floor
        self.megastep_plane = None
        self.slo_active = False
        self.slo_entered = 0
        self.slo_cleared = 0
        self._ok_ticks = 0
        self._recent_p99_usec = 0.0
        self.verdict: Optional[dict] = None
        self.last_verdict: Optional[dict] = None

    # -- harvest (cadence only) ---------------------------------------------
    @hot_path
    def harvest(self) -> None:
        """Consume the ring events since the last harvest, then finalize
        every trace whose ``sunk`` arrived (all rings first, so a trace's
        upstream events are in hand when its sink event is)."""
        sunk_now = []
        for ring in self.recorder.rings:
            n_now = ring.n        # a snapshot: the writer may advance
            key = id(ring)
            n0 = self._cursors.get(key, 0)
            if n_now - n0 > ring.size:
                # the ring wrapped past unconsumed events: counted (a
                # span missing its middle still telescopes)
                self.events_lost += (n_now - n0) - ring.size
                n0 = n_now - ring.size
            for j in range(n0, n_now):
                i = j % ring.size
                trace = int(ring.trace[i])
                stage = int(ring.stage[i])
                if trace in self._done_set:
                    continue
                ev = self._open.get(trace)
                if ev is None:
                    ev = self._open[trace] = []
                ev.append((ring.op_name, stage, int(ring.t[i]),
                           int(ring.shared_k[i])))
                if stage == SUNK:
                    sunk_now.append(trace)
            self._cursors[key] = n_now
        for trace in sunk_now:
            ev = self._open.pop(trace, None)
            if ev is not None:
                self._finalize(ev)
                self._remember_done(trace)
        if len(self._open) > self.MAX_OPEN:
            drop = len(self._open) - self.MAX_OPEN
            for _ in range(drop):
                trace = next(iter(self._open))
                del self._open[trace]
                self._remember_done(trace)
            self.traces_dropped += drop

    @hot_path
    def _remember_done(self, trace: int) -> None:
        if len(self._done_recent) == self._done_recent.maxlen:
            self._done_set.discard(self._done_recent[0])
        self._done_recent.append(trace)
        self._done_set.add(trace)

    @hot_path
    def _finalize(self, events: list) -> None:
        """Running-max boundary walk: each stage's latest occurrence, in
        pipeline order; the segment is the boundary delta, attributed to
        the operator that recorded the boundary event."""
        events.sort(key=lambda e: e[2])
        t0 = events[0][2]
        prev = t0
        segs = []
        for si, stage in enumerate(_SEG_STAGE):
            best = None
            for e in events:
                if e[1] == stage and (best is None or e[2] >= best[2]):
                    best = e
            if best is None:
                continue        # stage absent (an unwaited trace)
            b = best[2] if best[2] > prev else prev
            segs.append((best[0], SEGMENTS[si], float(b - prev), best[3]))
            prev = b
        e2e = float(prev - t0)
        for op_name, seg, dt, shared in segs:
            track = self.per_op.get(op_name)
            if track is None:
                track = self.per_op[op_name] = _OpLatency()
            track.add_segment(seg, dt, shared)
            self.segment_totals[seg] += dt
        self.e2e.add(e2e)
        self.traces_decomposed += 1
        brief = []
        for op_name, seg, dt, _shared in segs:
            brief.append((op_name, seg, dt))
        self._recent.append((e2e, brief))

    # -- the freshness gauge (waited batches only) ---------------------------
    def note_window_fire(self, op_name: str, ts, valid,
                         now_usec: Optional[int] = None) -> None:
        """Fire time minus window-close event time over the fired records
        of one window batch whose device work was already waited on."""
        v = _host(valid).astype(bool, copy=False)
        if not v.any():
            return
        close = int(_host(ts)[v].max())
        if close <= 0:
            return
        if now_usec is None:
            now_usec = current_time_usecs()
        track = self.per_op.get(op_name)
        if track is None:
            track = self.per_op[op_name] = _OpLatency()
        if track.freshness is None:
            track.freshness = LatencyHistogram()
        track.freshness.add(max(0.0, float(now_usec - close)))

    # -- SLO evaluation (cadence) -------------------------------------------
    def tick(self) -> None:
        """Harvest, then judge the SLO over the rolling window: enter at
        once, latch, clear after ``clear_after`` in-budget evaluations."""
        self.harvest()
        if self.slo_usec <= 0:
            return
        e2es = [e for e, _segs in self._recent]
        if len(e2es) < self.min_samples:
            return
        p99 = _p99(e2es)
        self._recent_p99_usec = p99
        if p99 > self.slo_usec:
            if not self.slo_active:
                self.slo_active = True
                self.slo_entered += 1
            self._ok_ticks = 0
            self.verdict = self._build_verdict(p99)
            self.last_verdict = self.verdict
        elif self.slo_active:
            self._ok_ticks += 1
            if self._ok_ticks >= self.clear_after:
                self.slo_active = False
                self.slo_cleared += 1
                self.verdict = None

    def _build_verdict(self, p99_usec: float) -> dict:
        """The violation, attributed to the dominant (operator, segment)
        pair of the same window the p99 came from."""
        sums: Dict[tuple, float] = {}
        total = 0.0
        for _e2e, segs in self._recent:
            for op_name, seg, dt in segs:
                sums[(op_name, seg)] = sums.get((op_name, seg), 0.0) + dt
                total += dt
        dom_op, dom_seg, share = None, None, 0.0
        if sums:
            (dom_op, dom_seg), dom_sum = max(sums.items(),
                                             key=lambda kv: kv[1])
            share = dom_sum / total if total else 0.0
        p99_ms = round(p99_usec / 1000.0, 3)
        budget_ms = round(self.slo_usec / 1000.0, 3)
        arrow = SEGMENT_ARROWS.get(dom_seg, dom_seg or "?")
        msg = (f"p99 budget {budget_ms:g} ms, e2e {p99_ms:g} ms, "
               f"{share:.0%} in {arrow} on op `{dom_op}`")
        if dom_seg == "emitted_to_dispatched" and self._megastep_k(dom_op):
            msg += " — megastep K-wait"
        return {
            "state": "SLO_VIOLATED",
            "p99_ms": p99_ms,
            "budget_ms": budget_ms,
            "dominant_op": dom_op,
            "dominant_segment": dom_seg,
            "share": round(share, 4),
            "message": msg,
        }

    def _edge(self, op_name: Optional[str]):
        plane = self.megastep_plane
        if plane is None or op_name is None:
            return None
        for edge in plane.edges:
            if edge.op.name == op_name:
                return edge
        return None

    def _megastep_k(self, op_name: Optional[str]) -> int:
        edge = self._edge(op_name)
        return edge.k if edge is not None else 0

    # -- export --------------------------------------------------------------
    def section(self) -> dict:
        """The ``stats()["Latency_plane"]`` payload (also the postmortem's
        ``latency.json`` and the input of ``analysis/latency.py``)."""
        graph_total = sum(self.segment_totals.values()) or 0.0
        per_op = {}
        for op_name, track in sorted(self.per_op.items()):
            entry = {
                "segments_usec": {seg: h.quantiles()
                                  for seg, h in sorted(
                                      track.segments.items())},
                "total_usec": round(track.total_usec, 3),
                "budget_share": round(track.total_usec / graph_total, 4)
                if graph_total else 0.0,
                "dominant_segment": track.dominant_segment(),
                "device_busy_usec": round(track.device_busy_usec, 3),
                "shared_k_traces": track.shared_k_traces,
            }
            if track.freshness is not None:
                entry["freshness_usec"] = track.freshness.quantiles()
            edge = self._edge(op_name)
            if edge is not None and edge.k:
                entry["megastep_k"] = edge.k
                entry["freshness_floor_usec"] = edge.freshness_floor_usec()
            per_op[op_name] = entry
        return {
            "enabled": True,
            "slo_ms": round(self.slo_usec / 1000.0, 3),
            "traces_decomposed": self.traces_decomposed,
            "traces_open": len(self._open),
            "traces_dropped": self.traces_dropped,
            "events_lost": self.events_lost,
            "e2e_usec": self.e2e.quantiles(),
            "segments_total_usec": {s: round(v, 3) for s, v
                                    in self.segment_totals.items()},
            "per_op": per_op,
            "slo": {
                "active": self.slo_active,
                "entered": self.slo_entered,
                "cleared": self.slo_cleared,
                "recent_p99_ms": round(self._recent_p99_usec / 1000.0, 3),
                "budget_ms": round(self.slo_usec / 1000.0, 3),
                "window": len(self._recent),
                "verdict": self.verdict,
                "last_verdict": self.last_verdict,
            },
        }
