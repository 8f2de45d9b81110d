"""Health plane: per-operator watchdog, stall attribution, postmortems
(the port of ``windflow_tpu/monitoring/health.py``).

* **State machine.**  :class:`HealthPlane` derives ``OK``,
  ``BACKPRESSURED``, ``STALLED`` or ``FAILED`` per operator from the
  gauges the stats cadence samples: queue depth, watermark-frontier
  advancement, input progress, and capture storms (recaptures in the
  step registry, ``monitoring/jit_registry.py``).  It runs at cadence
  (``stats()`` reads, ``health_tick``, the stall path), never per batch;
  with ``Config.health_watchdog`` off no plane is built.

* **Stall attribution.**  On a stall (a scheduler sweep made no
  progress, or an operator's frontier stayed frozen past the grace
  period), :meth:`HealthPlane.diagnose_stall` walks the operators in
  reverse topological order and names the first one still holding
  pending input: the root cause whose refusal to drain explains every
  backlog upstream.  The diagnosis goes into the raised
  ``WindFlowError``.

* **Verdict timeline.**  State changes append to a bounded deque, so a
  postmortem shows when each operator degraded.

* **Plane verdicts.**  Three ledgers publish latched verdicts the
  watchdog paints on one operator each, and only while it is otherwise
  OK: the roofline ledger's advisory ``ROOFLINE_DEGRADED`` on its
  dominant hop (``monitoring/calibration.RooflineLedger``), the latency
  ledger's ``SLO_VIOLATED`` on the operator its verdict names
  (``monitoring/latency_ledger.py``), and the tenant ledger's
  ``OVER_BUDGET`` on the tenant's heaviest operator
  (``monitoring/tenant_ledger.py``), in that rising order of severity.
  With a plane off its verdict is unreachable.

``tools/wf_doctor.py`` renders the bundle this plane feeds
(``PipeGraph.dump_postmortem``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from windflow_tpu_torch.basic import current_time_usecs

#: operator health states, worst last (the graph's verdict is the worst)
OK = "OK"
ROOFLINE_DEGRADED = "ROOFLINE_DEGRADED"
SLO_VIOLATED = "SLO_VIOLATED"
OVER_BUDGET = "OVER_BUDGET"
BACKPRESSURED = "BACKPRESSURED"
STALLED = "STALLED"
FAILED = "FAILED"
STATES = (OK, ROOFLINE_DEGRADED, SLO_VIOLATED, OVER_BUDGET, BACKPRESSURED,
          STALLED, FAILED)
_SEVERITY = {s: i for i, s in enumerate(STATES)}

#: postmortem bundle schema tag (tools/wf_doctor.py validates it)
POSTMORTEM_SCHEMA = "wf-postmortem/1"


class _OpTrack:
    """Watchdog memory of one operator: the previous sample's counters
    and the timestamps the state machine derives ages from."""

    __slots__ = ("name", "state", "since_usec", "last_advance_usec",
                 "last_inputs", "last_frontier", "queue_depth", "frontier",
                 "compile_storm", "failure", "stall_latched", "hot_shard",
                 "slo", "over_budget", "roofline")

    def __init__(self, name: str, now: int) -> None:
        self.name = name
        self.state = OK
        self.since_usec = now          # when the current state began
        self.last_advance_usec = now   # inputs or frontier last moved
        self.last_inputs = -1
        self.last_frontier: Optional[int] = None
        self.queue_depth = 0
        self.frontier: Optional[int] = None
        self.compile_storm = False
        self.failure: Optional[str] = None
        #: set by diagnose_stall (or a grace-window detection): STALLED
        #: holds until the operator makes progress again
        self.stall_latched = False
        #: the replica holding the backlog of a degraded operator at
        #: parallelism > 1
        self.hot_shard: Optional[dict] = None
        #: the latency ledger's SLO verdict while it names this operator
        self.slo: Optional[dict] = None
        #: the tenant ledger's budget verdict while this is the tenant's
        #: heaviest operator
        self.over_budget: Optional[dict] = None
        #: the roofline ledger's collapse verdict while this is the
        #: dominant hop
        self.roofline: Optional[dict] = None

    def verdict(self, now: int) -> dict:
        v = {
            "state": self.state,
            "since_usec": self.since_usec,
            "queue_depth": self.queue_depth,
            "watermark_frontier_usec": self.frontier,
            "last_advance_age_usec": max(0, now - self.last_advance_usec),
            "compile_storm": self.compile_storm,
            "failure": self.failure,
        }
        if self.hot_shard is not None:
            v["hot_shard"] = self.hot_shard
        if self.slo is not None:
            v["slo"] = self.slo
        if self.over_budget is not None:
            v["over_budget"] = self.over_budget
        if self.roofline is not None:
            v["roofline"] = self.roofline
        return v


class HealthPlane:
    """Graph-scoped watchdog, built by ``PipeGraph._build`` when
    ``Config.health_watchdog`` is on; every entry point is cadence-rate
    and takes the plane's own lock."""

    def __init__(self, graph) -> None:
        self.graph = graph
        cfg = graph.config
        self.stall_grace_usec = max(0, int(cfg.health_stall_grace_usec))
        self.backpressure_depth = int(cfg.health_backpressure_depth) \
            or max(1, cfg.max_inbox_messages // 2)
        self.recompile_storm = max(1, int(cfg.health_recompile_storm))
        now = current_time_usecs()
        self._tracks: Dict[str, _OpTrack] = {
            op.name: _OpTrack(op.name, now) for op in graph._operators}
        #: state-change timeline: {"t_usec", "changes": {op: state}}
        self.timeline: deque = deque(maxlen=max(8, int(cfg.health_history)))
        self.stall_events = 0
        self.last_stall: Optional[dict] = None
        self.samples_taken = 0
        self.sample_usec_total = 0.0
        self._stall_bundle_written = False   # cadence auto-bundle: once
        #: thread id of a bundle write in progress: an auto-bundle fired
        #: from the stats sample on that thread would deadlock the
        #: postmortem lock
        self._bundle_thread = None
        #: the ledgers whose latched verdicts the sample paints, bound by
        #: PipeGraph._build when their planes are on: the latency ledger,
        #: the tenant handle and the roofline ledger (None: one check)
        self.latency = None
        self.tenant = None
        self.roofline = None
        self._lock = threading.Lock()
        #: the registry is process-wide: baseline its recapture counts so
        #: a storm verdict reflects this graph's run
        self._recompile_base = self._recompile_counts()

    # -- sampling (the watchdog tick) ---------------------------------------
    def sample(self, now: Optional[int] = None) -> dict:
        """One watchdog evaluation; returns the per-operator verdicts."""
        t0 = time.perf_counter()
        now = now if now is not None else current_time_usecs()
        storms = self._compile_storms()
        # the ledgers' latest published verdicts, read once (they tick on
        # the same cadence, just before this sample)
        lat = self.latency
        slo_v = lat.verdict if lat is not None and lat.slo_active else None
        ten = self.tenant
        ob_v = ten.health_verdict() if ten is not None else None
        rfl = self.roofline
        rf_v = rfl.health_verdict() if rfl is not None else None
        with self._lock:
            changes = {}
            for op in self.graph._operators:
                track = self._tracks.get(op.name)
                if track is None:
                    track = self._tracks[op.name] = _OpTrack(op.name, now)
                state = self._evaluate_op(op, track, now,
                                          storms.get(op.name, False),
                                          slo_v, ob_v, rf_v)
                if state != track.state:
                    track.state = state
                    track.since_usec = now
                    changes[op.name] = state
            if changes:
                self.timeline.append({"t_usec": now, "changes": changes})
            verdicts = {name: t.verdict(now)
                        for name, t in self._tracks.items()}
            self.samples_taken += 1
            self.sample_usec_total += (time.perf_counter() - t0) * 1e6
            newly_stalled = [op for op, s in changes.items()
                             if s == STALLED]
            write_bundle = False
            if newly_stalled:
                # a watchdog-confirmed stall: counted, and bundled once a
                # graph (wait_end's hard stall writes its own fresher one)
                self.stall_events += 1
                if not self._stall_bundle_written \
                        and self._bundle_thread != threading.get_ident() \
                        and self.graph.config.health_postmortem_on_crash:
                    self._stall_bundle_written = True
                    write_bundle = True
        if write_bundle:
            self.graph._safe_postmortem(
                "watchdog: stalled operator(s) " + ", ".join(newly_stalled))
        return verdicts

    def _evaluate_op(self, op, track: _OpTrack, now: int,
                     storm: bool, slo_v: Optional[dict] = None,
                     ob_v: Optional[dict] = None,
                     rf_v: Optional[dict] = None) -> str:
        # the gauges' own walk: the watchdog judges what the lag gauge
        # reports
        depth, frontier = self.graph.op_frontier_and_depth(op)
        inputs = 0
        alive = False
        for rep in op.replicas:
            inputs += rep.stats.inputs_received
            if not rep.done:
                alive = True
        advanced = inputs != track.last_inputs \
            or (frontier is not None and frontier != track.last_frontier)
        if advanced:
            track.last_advance_usec = now
        track.last_inputs = inputs
        track.last_frontier = frontier
        track.queue_depth = depth
        track.frontier = frontier
        track.compile_storm = storm
        track.slo = track.over_budget = track.roofline = None
        # the replica with the deepest backlog (ties: the most lagged
        # frontier)
        track.hot_shard = None
        if len(op.replicas) > 1 and depth > 0:
            from windflow_tpu_torch.batch import WM_MAX, WM_NONE
            worst, w_depth, w_front = None, -1, None
            for rep in op.replicas:
                d = len(rep.inbox)
                wm = rep.current_wm
                f = wm if (wm != WM_NONE and wm < WM_MAX) else None
                if d > w_depth or (d == w_depth and f is not None
                                   and (w_front is None or f < w_front)):
                    worst, w_depth, w_front = rep.index, d, f
            if worst is not None and w_depth > 0:
                track.hot_shard = {
                    "shard": worst,
                    "queue_depth": w_depth,
                    "watermark_frontier_usec": w_front,
                }
        if advanced:
            track.stall_latched = False
        if track.failure is not None:
            return FAILED
        if not alive:
            # ended cleanly; a latched verdict stays the run's last word
            return self._paint(op, track, slo_v, ob_v, rf_v)
        if track.stall_latched:
            return STALLED
        if depth > 0 and not advanced \
                and now - track.last_advance_usec >= self.stall_grace_usec:
            # a grace-window detection is a confirmed stall: latched, so
            # diagnose_stall does not count it a second time
            track.stall_latched = True
            return STALLED
        if depth >= self.backpressure_depth or storm:
            return BACKPRESSURED
        return self._paint(op, track, slo_v, ob_v, rf_v)

    @staticmethod
    def _paint(op, track: _OpTrack, slo_v, ob_v, rf_v) -> str:
        """An otherwise-OK operator's state under the ledgers' verdicts:
        each attaches to the operator it names, the most severe takes the
        state (roofline < SLO < budget)."""
        state = OK
        if rf_v is not None and rf_v.get("dominant_op") == op.name:
            track.roofline = rf_v
            state = ROOFLINE_DEGRADED
        if slo_v is not None and slo_v.get("dominant_op") == op.name:
            track.slo = slo_v
            state = SLO_VIOLATED
        if ob_v is not None and ob_v.get("heaviest_op") == op.name:
            track.over_budget = ob_v
            state = OVER_BUDGET
        return state

    def _recompile_counts(self) -> dict:
        """Recaptures per operator from the step registry, by exact name
        or a "."-suffixed variant."""
        from windflow_tpu_torch.monitoring.jit_registry import \
            default_registry
        snap = default_registry().snapshot()
        return {op.name: sum(
            entry.get("recompiles", 0) for name, entry in snap.items()
            if name == op.name or name.startswith(op.name + "."))
            for op in self.graph._operators}

    def _compile_storms(self) -> dict:
        """Operators whose recaptures since this plane was built reach
        ``Config.health_recompile_storm``."""
        counts = self._recompile_counts()
        return {name: True for name, n in counts.items()
                if n - self._recompile_base.get(name, 0)
                >= self.recompile_storm}

    # -- failure / stall notifications --------------------------------------
    def note_failure(self, exc: BaseException) -> Optional[str]:
        """Crash-path attribution: the innermost replica frame of the
        traceback marks its operator FAILED.  Returns the operator's name
        (None without a replica frame, e.g. a driver-loop failure)."""
        op_name = None
        tb = getattr(exc, "__traceback__", None)
        while tb is not None:
            me = tb.tb_frame.f_locals.get("self")
            op = getattr(getattr(me, "op", None), "name", None)
            if op is not None and hasattr(me, "inbox"):
                op_name = op
            tb = tb.tb_next
        now = current_time_usecs()
        with self._lock:
            target = self._tracks.get(op_name) if op_name else None
            if target is not None:
                target.failure = f"{type(exc).__name__}: {exc}"[:300]
                if target.state != FAILED:
                    target.state = FAILED
                    target.since_usec = now
                    self.timeline.append({"t_usec": now,
                                          "changes": {op_name: FAILED}})
        return op_name

    def diagnose_stall(self) -> dict:
        """Attribution of a confirmed stall: sample once more, then name
        the deepest operator still holding pending input.  Records the
        stall event and returns the diagnosis (kept as ``last_stall``)."""
        now = current_time_usecs()
        verdicts = self.sample(now)
        root = None
        already_counted = False
        with self._lock:
            for op in reversed(self.graph._operators):
                track = self._tracks[op.name]
                live = any(not r.done for r in op.replicas)
                if live and track.queue_depth > 0:
                    # a cadence tick may have latched (and counted) it
                    already_counted = track.stall_latched
                    if track.state != STALLED:
                        track.since_usec = now
                    track.state = STALLED
                    track.stall_latched = True
                    root = op.name
                    break
            if root is not None and not already_counted:
                verdicts[root] = self._tracks[root].verdict(now)
                self.timeline.append({"t_usec": now,
                                      "changes": {root: STALLED}})
            if not already_counted:
                self.stall_events += 1
            diag = {"t_usec": now, "root_cause": root, "verdicts": verdicts}
            self.last_stall = diag
        if root is not None:
            # the shard plane's load and hot keys of the root operator
            led = getattr(self.graph, "_shard", None)
            if led is not None:
                try:
                    diag["shard"] = led.op_summary(root)
                except Exception:  # lint: broad-except-ok (a ledger fault must
                    # not replace the stall diagnosis)
                    pass
        return diag

    @staticmethod
    def format_diagnosis(diag: dict) -> str:
        """The text of a stall diagnosis, embedded in the raised
        ``WindFlowError``."""
        root = diag.get("root_cause")
        verdicts = diag.get("verdicts") or {}
        if root:
            v = verdicts.get(root, {})
            head = (f"root cause '{root}': stopped draining with "
                    f"{v.get('queue_depth', '?')} message(s) pending "
                    f"(frontier={v.get('watermark_frontier_usec')}, "
                    f"last advance "
                    f"{(v.get('last_advance_age_usec') or 0) / 1e6:.3f}s "
                    "ago)")
            hs = v.get("hot_shard")
            if hs:
                head += (f"; hot shard {hs.get('shard')} holds "
                         f"{hs.get('queue_depth')} of them")
            sh = diag.get("shard") or {}
            hot = (sh.get("hot_keys") or [{}])[0]
            if hot.get("key") is not None:
                head += (f" — key {hot['key']} alone carries "
                         f"{100 * (hot.get('share') or 0):.0f}% of the "
                         f"stream (shard ledger, {sh.get('basis')})")
        else:
            head = ("no operator holds pending input — sources idle but "
                    "the graph never terminated (source starvation or a "
                    "lost EOS)")
        per_op = "; ".join(
            f"{name}={v.get('state')}"
            f"(queue={v.get('queue_depth')}, "
            f"age={(v.get('last_advance_age_usec') or 0) / 1e6:.1f}s)"
            for name, v in verdicts.items())
        return f"{head}. Per-operator: {per_op}"

    # -- reporting -----------------------------------------------------------
    def section(self, sample_first: bool = True) -> dict:
        """The ``stats()["Health"]`` payload (a fresh tick by default)."""
        now = current_time_usecs()
        if sample_first:
            self.sample(now)
        with self._lock:
            return {
                "enabled": True,
                "graph_state": max(
                    (t.state for t in self._tracks.values()),
                    key=_SEVERITY.__getitem__) if self._tracks else OK,
                "verdicts": {name: t.verdict(now)
                             for name, t in self._tracks.items()},
                "stall_events": self.stall_events,
                "last_stall": self.last_stall,
                "samples_taken": self.samples_taken,
                "watchdog_usec_total": round(self.sample_usec_total, 1),
                "thresholds": {
                    "stall_grace_usec": self.stall_grace_usec,
                    "backpressure_depth": self.backpressure_depth,
                    "recompile_storm": self.recompile_storm,
                },
                "timeline": list(self.timeline),
            }
