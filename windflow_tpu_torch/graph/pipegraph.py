"""PipeGraph: application container, wiring, and the host scheduler loop
(the port of ``windflow_tpu/graph/pipegraph.py``; reference
``pipegraph.hpp``).

``run()`` wires replica inboxes, emitters and collectors, then drives
everything from a single cooperative dispatch loop: device work is
enqueued on the card's stream and runs asynchronously, so while the card
works on batch N the loop is already staging N+1.  Backpressure caps the
in-flight device batches per inbox; end of stream cascades EOS
punctuations and flushes window state (reference
``PipeGraph::wait_end``).

The graph is a DAG of MultiPipes (splits and merges).  ``_edges`` walks
it once; replica construction, the build-time capacity check, the fusion
planner (``windflow_tpu_torch/fusion``) and the wiring all read that one
walk.  At build, ``Config.whole_chain_fusion`` runs each executable
operator chain as one hop, and after the wiring ``Config.key_compaction``
attaches a ``KeyCompactor`` to every keyed declared-monoid ReduceGPU,
every host-fed interning stateful operator and every
``withCompactedKeys`` window, and wires their feeding emitters for
admission (``parallel/compaction.attach_compaction``).  Then the wire
plane (``wire.attach_wire``: compressed staging on edges with a record
spec) and the megastep plane (``megastep.attach_plane``: K staged
batches of an eligible edge as one group, one CUDA graph replay on the
card) attach, and under an active plane each source tick pulls K
batches' worth.  With ``Config.durability`` set the durability plane
(``windflow_tpu_torch/durability``) attaches last: every
``durability_epoch_sweeps``-th sweep ends in a watermark-aligned
checkpoint, and ``restore()`` resumes a freshly composed graph at the
last complete epoch.

Observability (``windflow_tpu_torch/monitoring``), built after the
wiring: the flight recorder's per-replica rings bound to the replicas and
their emitters, the health plane (a stall raises ``WindFlowError`` with
the root-cause operator and writes a postmortem bundle), the sweep
ledger, and the shard plane, whose sketches the compactors then rank
their residents by.  After the megastep and durability planes come the
latency ledger (the traces' five staged→sunk segments and the SLO
verdict), the graph's registration in the process tenant ledger
(per-tenant bytes and device budgets), the calibration store named by
``Config.calibration`` and the live roofline; ``health_tick`` ticks
them, then the watchdog, which paints their verdicts.  Under
``Config.tracing_enabled`` ``run()`` starts a ``MonitoringThread`` that
ticks on a cadence and ships reports to a dashboard.  ``stats()``
carries the JAX package's sections (``Flight_recorder``, ``Latency``,
``Latency_plane``, ``Tenant``, ``Roofline``, ``Gauges``, ``Health``,
``Device``, ``Sweep``, ``Shard``, ...); a telemetry read never takes the
pipeline down, and a section that failed says so under ``"error"``.
Under ``Config.tracing_enabled``, or while a ``torch.profiler`` capture
records, each sweep runs with the host spans on (``wf:sweep`` and, inside
it, the source tick's, the staging's, the megastep group's, each
dispatch's and the sink's; ``monitoring/recorder.py``), read as
``stats()["Spans"]`` and, in a capture, as ``record_function`` ranges.
``start()`` runs the preflight checker first (``check()``,
``windflow_tpu_torch/analysis``) under ``Config.preflight``, before any
replica, staging buffer or capture exists; ``stats()["Preflight"]``
carries its findings.  With ``Config.reshard_executor`` on, the reshard
executor (``windflow_tpu_torch/serving``) is built last: it ticks
between driver sweeps, after the durability call site, applies the
reshard advisor's plans through the quiesce barrier, and scales the
source tick chunk by its admission factor; ``stats()["Reshard"]`` and
the postmortem's ``reshard.json`` carry its counters.

Host-heavy pipelines (window engines, FlatMaps, sink serializers) share
the driver thread, where the reference runs a thread per replica
(``basic_operator.hpp:54``).  ``Config.host_worker_threads > 0`` builds
a worker pool: each sweep, the pooled replicas with pending input drain
concurrently, one task a replica (per-replica processing stays serial,
and keyed routing still pins a key to one replica), while the driver
thread drains the rest; the sweep joins the pool's tasks before the
prefetch, the durability cadence and the reshard executor, so a quiesce
never overlaps a pooled drain.  A replica is pooled only when its
operator is a host operator, not a source, ``host_pool_safe``, and no
edge into or out of it carries device batches: the device-to-host copy
of an egress runs in its consumer and the staging of a host-to-device
edge in its producer, so a pool thread never touches the card and never
lands a copy inside a CUDA graph capture on the driver thread.  (The
JAX package pools every host replica: a ``device_get`` may run on any
thread.)  GIL-releasing host work (numpy, native calls, blocking I/O)
then overlaps; pure-Python per-tuple work stays GIL-bound.

The capture audit (``analysis/ir_audit.py``, ``Config.ir_audit``)
records the first step of each device operator and each megastep
capture; ``stats()["IR_audit"]``, the postmortem's ``ir_audit.json``
and ``check()``'s table read its WF9xx findings.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from concurrent.futures import wait as wait_futures
from typing import List, Optional

from windflow_tpu_torch.basic import (Config, ExecutionMode, RoutingMode,
                                      TimePolicy, WindFlowError,
                                      current_time_usecs, default_config,
                                      resolve_device)
from windflow_tpu_torch.fusion.chains import edge_degrees
from windflow_tpu_torch.fusion.executor import (apply_fusion,
                                                attribute_member_stats)
from windflow_tpu_torch.graph.multipipe import MultiPipe
from windflow_tpu_torch.monitoring import recorder as flightrec
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.chained import ChainedGPU
from windflow_tpu_torch.ops.source import Source, SourceReplica
from windflow_tpu_torch.parallel.collectors import create_collector
from windflow_tpu_torch.parallel.emitters import (SplittingEmitter,
                                                  create_emitter)


class PipeGraph:
    def __init__(self, name: str = "app",
                 mode: ExecutionMode = ExecutionMode.DEFAULT,
                 time_policy: TimePolicy = TimePolicy.INGRESS,
                 config: Optional[Config] = None) -> None:
        self.name = name
        self.mode = mode
        self.time_policy = time_policy
        self.config = config or dataclasses.replace(default_config)
        self.pipes: List[MultiPipe] = []
        self._merges: List[MultiPipe] = []
        #: fused segments installed at build (fusion/executor.py)
        self._fused_segments: List[dict] = []
        self._started = False
        self._collectors = []
        self._all_replicas = []
        self._source_replicas: List[SourceReplica] = []
        self._operators: List[Operator] = []
        self.device = None
        self._throttle_events = 0
        self._max_inbox_seen = 0
        self._max_inflight_device_seen = 0
        #: the megastep plane (megastep.py), attached by _build
        self._megastep_plane = None
        #: the durability plane (durability/checkpoint.py), built by
        #: _build when Config.durability names a directory
        self._durability = None
        #: the reshard executor (windflow_tpu_torch/serving), built last
        #: by _build under Config.reshard_executor
        self._reshard = None
        #: checkpoint state restore() stashed for start() to apply
        self._pending_restore = None
        self._prefetch_ticks = 0
        #: the observability planes (monitoring/), built by _build; None
        #: leaves one `is not None` check at each hook and read site
        self._recorder = None
        self._health = None
        self._ledger = None
        self._shard = None
        self._latency = None
        self._tenant = None
        self._roofline = None
        #: the monitoring thread run() starts under Config.tracing_enabled
        self._monitor = None
        #: the host spans of the sweeps (step() turns them on)
        self._spans = flightrec.SpanTable()
        #: the last postmortem bundle written; the lock serializes the
        #: writers (a watchdog auto-bundle and the stall/crash path)
        self._postmortem_dir = None
        self._postmortem_lock = threading.Lock()
        #: rolling-throughput samples (monotonic s, tuples sunk), taken by
        #: sample_gauges (every stats() read)
        self._thr_samples = deque(maxlen=64)
        #: the directory the last profile() capture went to
        self._last_profile_dir = None
        #: the last check(): its findings, its cost, and wfverify's report
        self._preflight_diags = None
        self._preflight_ms = None
        self._tracecheck_report = None
        #: the last check()'s capture-audit report (analysis/ir_audit.py)
        self._ir_audit_report = None
        #: the host worker pool (Config.host_worker_threads): the
        #: replicas it drains, and the driver thread's remainder
        self._pool = None
        self._pool_replicas = []
        self._main_replicas = []

    # -- construction --------------------------------------------------------
    def add_source(self, source: Source) -> MultiPipe:
        if self._started:
            raise WindFlowError("cannot add sources to a running PipeGraph")
        mp = MultiPipe(self, source)
        self.pipes.append(mp)
        return mp

    def _register_merge(self, mp: MultiPipe) -> None:
        self._merges.append(mp)
        self.pipes.append(mp)

    # -- the DAG walk --------------------------------------------------------
    def _all_pipes(self) -> List[MultiPipe]:
        """Every MultiPipe, split branches included (the one traversal of
        replica construction and edge wiring)."""
        out = []

        def collect(mp: MultiPipe):
            out.append(mp)
            for child in mp.split_children:
                collect(child)

        for mp in self.pipes:
            collect(mp)
        return out

    def _edges(self):
        """Every graph edge in topological order of the MultiPipe DAG:
        ``("op", a, b)`` for an operator edge (merges included) and
        ``("split", mp)`` for a split point."""
        edges = []
        for mp in self._all_pipes():
            ops = mp.operators
            for a, b in zip(ops, ops[1:]):
                edges.append(("op", a, b))
            if mp.split_children:
                edges.append(("split", mp))
        for merged in self._merges:
            if not merged.operators:
                raise WindFlowError(
                    "a merged MultiPipe has no operators — add an operator "
                    "(and a sink) to the merge result")
            for parent in merged.merge_parents:
                if not parent.operators:
                    raise WindFlowError("cannot merge an empty MultiPipe")
                edges.append(("op", parent.operators[-1],
                              merged.operators[0]))
        return edges

    def _topo_operators(self) -> List[Operator]:
        """Every distinct operator, in the build's enumeration order."""
        seen, out = set(), []
        for mp in self._all_pipes():
            for op in mp.operators:
                if id(op) not in seen:
                    seen.add(id(op))
                    out.append(op)
        return out

    def _check_fixed_capacity_ops(self) -> None:
        """Fixed-capacity device operators (``fixed_capacity_label``) fed
        through a merge must see ONE batch capacity: the mismatch raises
        here, with the sizes, instead of mid-run.  The backstop of a
        ``Config.preflight="off"`` run: otherwise preflight reports it as
        WF403, raised under "error" and warned under "warn"."""
        from windflow_tpu_torch.analysis.preflight import capacity_conflicts
        for op, label, caps in capacity_conflicts(self):
            raise WindFlowError(
                f"'{op.name}' ({label}) compiles for one fixed batch "
                f"capacity but its upstream paths deliver {sorted(caps)}; "
                "give the merged branches equal withOutputBatchSize")

    # -- wiring --------------------------------------------------------------
    def _build(self) -> None:
        # the device first: without CUDA a cuda graph raises here, before
        # any replica exists (no silent CPU fallback)
        self.device = resolve_device(self.config)
        # 1. instantiate replicas
        for op in self._topo_operators():
            op.ordinal = len(self._operators)
            self._operators.append(op)
            op.config = self.config
            op.device = self.device
            op.mesh = self.config.mesh
            op.build_replicas(self.mode, self.time_policy)
        for op in self._operators:
            self._all_replicas.extend(op.replicas)
            if isinstance(op, Source):
                self._source_replicas.extend(op.replicas)
        for rep in self._all_replicas:
            rep.config = self.config
        if getattr(self.config, "preflight", "error") == "off":
            self._check_fixed_capacity_ops()

        # 1a. key-aligned mesh ingest: stamp the eligible host-fed
        # key-sharded consumers before wiring; the emitter dispatch and
        # the consumers' sharded steps read the stamp
        mesh = self.config.mesh
        if mesh is not None \
                and getattr(self.config, "key_aligned_ingest", True):
            from windflow_tpu_torch.parallel.mesh import mark_aligned_ingest
            mark_aligned_ingest(self)

        # 1b. whole-chain fusion, installed before wiring so each segment
        # is wired as one hop; skipped on a mesh (the sharded steps
        # compose by phases)
        if getattr(self.config, "whole_chain_fusion", True) and mesh is None:
            self._fused_segments = apply_fusion(self)
        fused_host = {}          # id(member) -> the segment's host op
        fused_edge_skip = set()  # interior (src, dst) id pairs
        for seg in self._fused_segments:
            members = seg["members"]
            for m in members[:-1]:
                fused_host[id(m)] = members[-1]
            for fa, fb in zip(members, members[1:]):
                fused_edge_skip.add((id(fa), id(fb)))

        # 2. wire edges: emitters on the producing replicas, channels on
        #    the consuming ones.  ``route_op`` carries the edge's routing
        #    contract, ``dst_op`` owns the consuming replicas: they differ
        #    when a fused segment's head hands its edge to the host
        def wire_edge(src_op, route_op, dst_op):
            emitters = []
            for _ in src_op.replicas:
                dests = [(dst_rep, dst_rep.add_channel())
                         for dst_rep in dst_op.replicas]
                emitters.append(create_emitter(
                    route_op.routing, dests, src_op.output_batch_size,
                    src_is_gpu=src_op.is_gpu, dst_is_gpu=dst_op.is_gpu,
                    device=self.device,
                    key_extractor=route_op.key_extractor, mesh=mesh))
            return emitters

        # a stateless chain feeding exactly one KEYBY device consumer
        # extracts the consumer's keys itself and ships them on the
        # batch's keys lane (not when the consumer heads a fused segment:
        # its prelude rewrites the records, so it extracts again)
        edges = self._edges()
        fanout = edge_degrees(edges)[0]
        key_forward = {}
        for edge in edges:
            if edge[0] == "op":
                _, a, b = edge
                if (id(a), id(b)) in fused_edge_skip:
                    continue    # interior to a fused segment: no hop
                if b.routing == RoutingMode.KEYBY and b.is_gpu \
                        and b.key_extractor is not None \
                        and fanout.get(id(a)) == 1 \
                        and id(a) not in fused_host \
                        and id(b) not in fused_host:
                    key_forward[id(a)] = (a, b.key_extractor)
                for rep, em in zip(a.replicas,
                                   wire_edge(a, b, fused_host.get(id(b), b))):
                    rep.emitter = em
            else:  # split point: one SplittingEmitter a source replica
                _, mp = edge
                src_op = mp.operators[-1]
                heads = [child.operators[0] for child in mp.split_children]
                per_branch = [wire_edge(src_op, h, fused_host.get(id(h), h))
                              for h in heads]
                for i, rep in enumerate(src_op.replicas):
                    rep.emitter = SplittingEmitter(
                        mp.split_fn, [per_branch[b][i]
                                      for b in range(len(heads))])
        for a, kx in key_forward.values():
            if a._fusion_exec is not None:
                a._fusion_exec.set_downstream_key_extractor(kx)
            elif isinstance(a, ChainedGPU):
                a.set_downstream_key_extractor(kx)

        # 2b. fused members are inert: no channels (interior edges are
        # skipped) and no EOS cascade, so they read as terminated
        for seg in self._fused_segments:
            for m in seg["members"][:-1]:
                for rep in m.replicas:
                    rep.done = True
                    rep.stats.is_terminated = True

        # 2b'. observability: the recorder's rings on every replica and
        # its emitter, the health plane, the sweep ledger (its baseline
        # excludes earlier graphs' dispatches) and the shard plane (its
        # sketches attach to the keyed edges and the key-forwarding
        # chains, so it comes after the wiring and before compaction)
        cfg = self.config
        if cfg.flight_recorder and cfg.trace_sample_every > 0:
            from windflow_tpu_torch.monitoring.recorder import \
                FlightRecorder
            self._recorder = FlightRecorder(
                sample_every=cfg.trace_sample_every,
                ring_events=cfg.trace_ring_events,
                device_sync_every=cfg.trace_device_sync_every,
                expected_rings=len(self._all_replicas))
            for rep in self._all_replicas:
                rep.ring = self._recorder.ring_for(rep.op.name, rep.index)
        for rep in self._all_replicas:
            if rep.emitter is not None:
                rep.emitter.bind_observability(rep.stats, rep.ring,
                                               self._recorder)
        if cfg.health_watchdog:
            from windflow_tpu_torch.monitoring.health import HealthPlane
            self._health = HealthPlane(self)
        if cfg.sweep_ledger:
            from windflow_tpu_torch.monitoring.sweep_ledger import \
                SweepLedger
            self._ledger = SweepLedger(self)
        if cfg.shard_ledger:
            from windflow_tpu_torch.monitoring.shard_ledger import \
                ShardLedger
            self._shard = ShardLedger(self)

        # 2c. key compaction: after fusion (preludes installed), the
        # wiring (the emitters exist) and the shard plane (the sketches
        # rank the residents), before any step
        if getattr(self.config, "key_compaction", True):
            from windflow_tpu_torch.parallel.compaction import \
                attach_compaction
            attach_compaction(self)

        # 2d. wire plane, then the megastep plane: after fusion (the tail
        # may be a fused segment's host) and compaction (a compacted tail
        # is ineligible), before anything stages; the group body runs
        # the same wire decode as the per-batch unpack
        from windflow_tpu_torch.megastep import (attach_plane,
                                                 round_epoch_to_megastep)
        from windflow_tpu_torch.wire import attach_wire, wire_enabled
        if wire_enabled(self.config):
            attach_wire(self)
        self._megastep_plane = attach_plane(self.config,
                                            self._source_replicas)
        round_epoch_to_megastep(self.config, self._megastep_plane)

        # 2e. durability plane: after the megastep plane (the epoch
        # cadence is converted to whole megasteps above); it switches the
        # Kafka sink replicas to fenced exactly-once buffering
        if self.config.durability:
            from windflow_tpu_torch.durability.checkpoint import \
                DurabilityPlane
            self._durability = DurabilityPlane(self)

        # 2f. the cadence ledgers, after every plane they read: the
        # latency ledger (the recorder's rings, the megastep edges' K),
        # the tenant registration (the final operator and watch set), the
        # calibration store and the roofline (the sweep ledger's bytes)
        self._attach_ledgers()

        # 3. collectors: one per replica with input channels
        for rep in self._all_replicas:
            if rep.num_channels > 0:
                rep.collector = create_collector(self.mode, rep.num_channels)
                self._collectors.append(rep.collector)

        # 4. the reshard executor, last: it discovers the keyed emitters
        # the wiring installed, reads the health plane and the shard
        # ledger at tick cadence, and changes routing only through the
        # quiesce barrier; a mesh graph reshards by rescale-on-restore,
        # never by the executor
        if cfg.reshard_executor and mesh is None:
            from windflow_tpu_torch.serving import ReshardExecutor
            self._reshard = ReshardExecutor(self)

        # every live non-sink replica must have an emitter
        for op in self._operators:
            if op._fused_into is not None:
                continue
            for rep in op.replicas:
                if rep.emitter is None and not op.is_terminal:
                    raise WindFlowError(
                        f"operator '{op.name}' has no downstream consumer — "
                        "every MultiPipe must end in a Sink")

        # 5. the host worker pool's partition, after the wiring: pooled
        # replicas neither consume nor emit device batches
        if cfg.host_worker_threads > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=cfg.host_worker_threads,
                thread_name_prefix=f"wf-{self.name}")
            on_device = _device_edge_ops(edges)
            for op in self._operators:
                pooled = (not op.is_gpu and op.host_pool_safe
                          and not isinstance(op, Source)
                          and id(op) not in on_device)
                (self._pool_replicas if pooled
                 else self._main_replicas).extend(op.replicas)
        else:
            self._main_replicas = self._all_replicas

    def _attach_ledgers(self) -> None:
        cfg = self.config
        if cfg.latency_ledger and self._recorder is not None:
            from windflow_tpu_torch.monitoring.latency_ledger import \
                LatencyLedger
            from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
            self._latency = LatencyLedger(self._recorder,
                                          slo_ms=cfg.latency_slo_ms or 0.0)
            self._latency.megastep_plane = self._megastep_plane
            for op in self._operators:
                if isinstance(op, FfatWindowsGPU):
                    # the window-freshness gauge, at the waited batches
                    for rep in op.replicas:
                        rep.latency = self._latency
        if cfg.tenant_ledger:
            from windflow_tpu_torch.monitoring.tenant_ledger import \
                default_ledger
            self._tenant = default_ledger().register(
                self, cfg.tenant or self.name, cfg.hbm_budget_bytes)
        from windflow_tpu_torch.monitoring import calibration
        if cfg.calibration and not calibration.killed():
            try:
                calibration.set_default_store(
                    calibration.load(cfg.calibration))
            except calibration.CalibrationError as e:
                # a corrupt store degrades the process to its modeled
                # defaults, loudly; it never fails the build
                import warnings
                warnings.warn(f"Config.calibration={cfg.calibration!r} "
                              f"failed to load ({e}) — running "
                              "uncalibrated", RuntimeWarning)
        if cfg.roofline_plane:
            self._roofline = calibration.RooflineLedger(self)
        if self._health is not None:
            self._health.latency = self._latency
            self._health.tenant = self._tenant
            self._health.roofline = self._roofline

    # -- execution -----------------------------------------------------------
    def run(self) -> "PipeGraph":
        """Build, then drive the whole graph to completion (reference
        ``run()`` = ``start()`` + ``wait_end()``)."""
        self.start()
        return self.wait_end()

    # -- static analysis (windflow_tpu_torch/analysis) -----------------------
    def check(self) -> list:
        """Preflight analysis of the composed graph: structure, window
        specs, merged capacities, watermark modes, durability, the named
        wire/kernel/megastep downgrades, and the device operators' user
        functions evaluated on fake tensors (no device work), with
        wfverify folded in.  Returns the FULL list of
        :class:`~windflow_tpu_torch.analysis.diagnostics.Diagnostic`
        findings; ``start()`` runs it first under ``Config.preflight``,
        and ``python -m windflow_tpu_torch.analysis.check`` wraps it."""
        from windflow_tpu_torch.analysis.preflight import check_graph
        t0 = time.perf_counter()
        diags = check_graph(self)
        self._preflight_ms = round((time.perf_counter() - t0) * 1e3, 3)
        self._preflight_diags = diags
        return diags

    def _run_preflight(self) -> None:
        mode = getattr(self.config, "preflight", "error")
        if mode not in ("error", "warn", "off"):
            raise WindFlowError(
                f"Config.preflight must be 'error', 'warn' or 'off', "
                f"got {mode!r}")
        if mode == "off":
            return
        import warnings
        from windflow_tpu_torch.analysis.diagnostics import (PreflightError,
                                                             PreflightWarning)
        diags = self.check()
        errors = [d for d in diags if d.severity == "error"]
        for d in diags:
            if d.severity != "error" or mode == "warn":
                warnings.warn(str(d), PreflightWarning, stacklevel=3)
        if errors and mode == "error":
            raise PreflightError(errors)

    def start(self) -> None:
        if self._started:
            raise WindFlowError("PipeGraph already started")
        # before the build: a refused graph stages, captures and
        # allocates nothing
        self._run_preflight()
        self._started = True
        try:
            self._build()
            if self._durability is not None \
                    and self._pending_restore is not None:
                # restore(): apply the checkpointed operator/replica state
                # now — replicas, fusion preludes and the planes exist,
                # no source has ticked
                pending, self._pending_restore = self._pending_restore, None
                self._durability.apply_restore(pending)
            if self.config.tracing_enabled:
                # reference: tracing spawns a MonitoringThread at run()
                # (pipegraph.hpp:676-678)
                from windflow_tpu_torch.monitoring.monitor import \
                    MonitoringThread
                self._monitor = MonitoringThread(self)
                self._monitor.start()
            for sr in self._source_replicas:
                sr.start()
        except BaseException:
            self._finalize(dump=False, aborted=True)
            raise

    def wait_end(self) -> "PipeGraph":
        if not self._started:
            raise WindFlowError("wait_end before start")
        aborted = False
        try:
            while not self.is_done():
                if not self.step():
                    raise self._stall_error()
        except BaseException as exc:
            aborted = True
            # crash path: the telemetry first (the operator that raised
            # is marked FAILED, the postmortem bundle written), guarded so
            # it never masks the error re-raised below
            try:
                if self._health is not None:
                    self._health.note_failure(exc)
                self._write_crash_postmortem(exc)
            except BaseException:  # lint: broad-except-ok (salvage must never
                # replace the root-cause error)
                pass
            raise
        finally:
            # ended or crashed: the checkpoint store is flushed and
            # closed, so a restore in this process reopens a whole log
            self._finalize(aborted=aborted)
        return self

    def _stall_error(self) -> WindFlowError:
        """The stall error, with the health plane's diagnosis (per-op
        queue depth, frontier, last-advance age; the root-cause
        operator) and the postmortem bundle it wrote."""
        head = ("PipeGraph stalled: no replica made progress but the "
                "graph has not terminated. ")
        if self._health is None:
            return WindFlowError(
                head + "The health watchdog is off "
                "(Config.health_watchdog): no diagnosis; run with it on "
                "for the root cause")
        try:
            diag = self._health.diagnose_stall()
            msg = head + self._health.format_diagnosis(diag)
        except Exception as e:  # lint: broad-except-ok (a watchdog fault must
            # not replace the stall error)
            msg = head + (f"(health diagnosis failed: "
                          f"{type(e).__name__}: {e}"[:200] + ")")
        err = WindFlowError(msg)
        if self.config.health_postmortem_on_crash:
            bundle = self._safe_postmortem("stall")
            if bundle:
                # this exception is bundled: the crash path skips it
                err._wf_postmortem_bundle = bundle
                err.args = (msg + f". Postmortem bundle: {bundle}",)
        return err

    def _write_crash_postmortem(self, exc: BaseException) -> None:
        """The bundle of an abnormal end, unless this exception is the
        stall error whose bundle ``_stall_error`` wrote."""
        if self.config.health_postmortem_on_crash \
                and getattr(exc, "_wf_postmortem_bundle", None) is None:
            self._safe_postmortem(f"crash: {type(exc).__name__}: "
                                  f"{exc}"[:300])

    def _safe_postmortem(self, reason: str) -> Optional[str]:
        try:
            return self.dump_postmortem(reason=reason)
        except Exception:  # lint: broad-except-ok (runs inside crash handlers)
            return None

    def restore(self, checkpoint_dir: Optional[str] = None) -> "PipeGraph":
        """Rebuild this composed-but-unstarted graph at the last complete
        checkpoint epoch (``windflow_tpu_torch/durability``): validates
        the manifest's topology signature against the graph (WF602 named
        diff on mismatch), restores every operator's state (FFAT pane
        rings, stateful slot tables, reduce states, compactor remaps) on
        ``Config.device``, plus per-replica watermark frontiers, seeks
        Kafka sources back to the checkpointed offsets, and re-fences
        exactly-once sinks so the replay neither loses nor duplicates a
        record.  Returns the graph STARTED; drive it with
        :meth:`wait_end` (or :meth:`step`)."""
        from windflow_tpu_torch.durability.checkpoint import restore_graph
        return restore_graph(self, checkpoint_dir)

    def _finalize(self, dump: bool = True, aborted: bool = False) -> None:
        if self._tenant is not None:
            # the tenant roll-up keeps this graph's attribution after its
            # replicas are gone (guarded: telemetry never blocks teardown)
            try:
                self._tenant.freeze()
            except Exception:  # lint: broad-except-ok (see above)
                pass
        if self._pool is not None:
            # before the stores close: no pooled drain outlives them
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._durability is not None:
            # counters stay readable: stats() reads the plane's fields
            self._durability.close()
        if self._monitor is not None:
            # a final report and END_APP on both ends of a run; an abort
            # marks the report
            self._monitor.stop(aborted=aborted)
            self._monitor = None
        if dump and self.config.tracing_enabled:
            self.dump_stats()

    def step(self) -> bool:
        """One scheduler sweep: pull a chunk from each live source (unless
        backpressured), then drain every replica in topological order.
        Returns True on any progress.  Under ``Config.tracing_enabled``,
        or while a ``torch.profiler`` capture records, the sweep runs
        with the graph's host spans on (``wf:sweep`` and the spans inside
        it, ``monitoring/recorder.py``; ``stats()["Spans"]``)."""
        prof = flightrec.profiler_recording()
        if not (prof or self.config.tracing_enabled):
            return self._sweep()
        tab = self._spans
        tab.enabled = True
        tab.profiling = prof
        prev = flightrec.activate(tab)
        try:
            with tab.span("wf:sweep"):
                return self._sweep()
        finally:
            flightrec.activate(prev)

    def _sweep(self) -> bool:
        progress = False
        throttled = self._backpressured()
        if throttled:
            self._throttle_events += 1
        for sr in self._source_replicas:
            if not sr.exhausted and not throttled:
                if self._tick(sr):
                    progress = True
                sr.maybe_punctuate()
        limit = self.config.sweep_drain_limit
        pool = self._pool
        if pool is not None:
            # one task a pooled replica with work: its processing stays
            # serial; the join below ends the sweep's drain phase
            futures = [pool.submit(rep.drain, limit)
                       for rep in self._pool_replicas if rep.inbox]
        try:
            for rep in self._main_replicas:
                if rep.drain(limit):
                    progress = True
        finally:
            if pool is not None:
                # every pooled drain ends before the sweep does, on an
                # error too: nothing writes while the crash path's
                # postmortem and _finalize flush and close the stores
                wait_futures(futures)
        if pool is not None:
            for f in futures:
                if f.result():
                    progress = True
        # staging lookahead: the drain only enqueued device work, so pack
        # the next batch on the host while the card runs
        for _ in range(max(0, self.config.stage_prefetch_depth)):
            if self._backpressured():
                break
            ticked = False
            for sr in self._source_replicas:
                if not sr.exhausted and self._tick(sr):
                    ticked = True
            if not ticked:
                break
            progress = True
            self._prefetch_ticks += 1
        if not progress:
            # never deadlock on our own throttle
            for sr in self._source_replicas:
                if not sr.exhausted and self._tick(sr):
                    progress = True
        if self._durability is not None:
            # epoch cadence: counts sweeps and, every
            # Config.durability_epoch_sweeps-th, quiesces to the aligned
            # barrier and commits a checkpoint epoch.  Under an active
            # megastep plane one sweep paces whole groups, so every
            # quiesce lands between megasteps
            self._durability.on_sweep()
        if self._reshard is not None:
            # executor cadence: one counter compare a sweep; every
            # Config.reshard_check_sweeps-th reads health and the shard
            # plan and applies what fires (between megasteps too)
            self._reshard.on_sweep()
        return progress

    def _tick(self, sr) -> bool:
        # the source's own span (wf:tick:<op>) feeds its service time
        with sr._service:
            return sr.tick(self._tick_chunk(sr))

    def _tick_chunk(self, sr) -> int:
        chunk = self.config.source_tick_chunk \
            or sr.op.output_batch_size or 256
        plane = self._megastep_plane
        if plane is not None and plane.active \
                and getattr(sr.emitter, "_megastep", None) is not None:
            # K-granular pacing: a tick stages a whole group's batches
            chunk *= plane.k
        if self._reshard is not None:
            # admission control: when no plan helps a degraded operator,
            # the source intake throttles instead of inboxes growing
            chunk = self._reshard.admit_chunk(chunk)
        return chunk

    def _backpressured(self) -> bool:
        """True when any replica inbox is at the in-transit cap."""
        cfg = self.config
        hit = False
        for rep in self._all_replicas:
            depth = len(rep.inbox)
            self._max_inbox_seen = max(self._max_inbox_seen, depth)
            self._max_inflight_device_seen = max(
                self._max_inflight_device_seen, rep.inflight_device)
            if rep.inflight_device >= cfg.max_inflight_batches \
                    or depth >= cfg.max_inbox_messages:
                hit = True
        return hit

    def is_done(self) -> bool:
        return all(r.done for r in self._all_replicas)

    # -- introspection -------------------------------------------------------
    def get_num_dropped_tuples(self) -> int:
        """Tuples dropped as too late: by the PROBABILISTIC collectors and
        by the operators (time windows' late tuples)."""
        return sum(c.num_dropped for c in self._collectors) \
            + sum(op.num_dropped_tuples() for op in self._operators)

    #: the reference's camelCase name
    def getNumDroppedTuples(self) -> int:
        return self.get_num_dropped_tuples()

    def to_dot(self) -> str:
        """Graphviz DOT diagram of the graph (reference
        ``pipegraph.hpp:560-576``)."""
        from windflow_tpu_torch.monitoring.diagram import to_dot
        return to_dot(self)

    # -- observability: gauges, health, latency, traces ----------------------
    def sample_gauges(self) -> None:
        """Append one rolling-throughput sample (every ``stats()`` read
        takes one)."""
        total = sum(r.stats.inputs_received for op in self._operators
                    if op.is_terminal for r in op.replicas)
        self._thr_samples.append((time.monotonic(), total))

    def health_tick(self) -> None:
        """One cadence tick: the latency ledger (harvest and the SLO),
        the tenant ledger's budget machine and the roofline's rates, then
        the watchdog, which reads their verdicts.  The monitoring thread
        calls it; with every plane off it is four checks."""
        for plane in (self._latency, self._tenant, self._roofline):
            if plane is not None:
                try:
                    plane.tick()
                except Exception:  # lint: broad-except-ok (a ledger
                    # fault never takes the watchdog down; its section
                    # reports it)
                    pass
        if self._health is not None:
            self._health.sample()

    def _guarded(self, plane, read, error_section=None) -> dict:
        """A plane's section: ``{"enabled": False}`` without the plane,
        and a failed read as its ``"error"``, so a telemetry read never
        takes the pipeline or a stats dump down."""
        if plane is None:
            return {"enabled": False}
        try:
            return read()
        except Exception as e:  # lint: broad-except-ok (see the docstring)
            out = {"enabled": True} if error_section is None \
                else dict(error_section)
            out["error"] = f"{type(e).__name__}: {e}"[:200]
            return out

    def _health_section(self) -> dict:
        return self._guarded(self._health,
                             lambda: self._health.section())

    def _sweep_section(self) -> dict:
        return self._guarded(self._ledger, lambda: self._ledger.section())

    def _shard_section(self) -> dict:
        return self._guarded(self._shard, lambda: self._shard.section())

    def _durability_section(self) -> dict:
        return self._guarded(self._durability,
                             lambda: self._durability.section())

    def _reshard_section(self) -> dict:
        """``{"enabled": False}`` with the executor off: one check."""
        return self._guarded(self._reshard, lambda: self._reshard.section())

    def _latency_plane_section(self) -> dict:
        """Harvests first, so a headless read sees the finished traces."""
        def read():
            self._latency.harvest()
            return self._latency.section()
        return self._guarded(self._latency, read)

    def _tenant_section(self) -> dict:
        """The whole process table, focused on this graph's row."""
        return self._guarded(self._tenant, lambda: self._tenant.section())

    def _roofline_section(self) -> dict:
        """Ticks first, so a headless read sees current rates."""
        def read():
            self._roofline.tick()
            return self._roofline.section()
        return self._guarded(self._roofline, read)

    def _device_section(self) -> dict:
        from windflow_tpu_torch.monitoring import device_metrics
        return self._guarded(self, lambda: device_metrics.device_section(
            self), error_section={})

    def _wire_section(self) -> dict:
        from windflow_tpu_torch.wire import wire_section
        return self._guarded(self, lambda: wire_section(self),
                             error_section={"enabled": None})

    def _ingest_section(self) -> dict:
        """``stats()["Staging"]["Ingest"]``: the rows and chunks the
        frame sources' direct route wrote straight into the staging
        buffers (``io/frames.py``), and the rows those sources handed
        over in all."""
        from windflow_tpu_torch.io.frames import FrameSourceReplica
        reps = [r for r in self._source_replicas
                if isinstance(r, FrameSourceReplica)]
        rows = sum(r.stats.outputs_sent for r in reps)
        direct = sum(r.direct_rows for r in reps)
        return {"direct_rows": direct,
                "direct_chunks": sum(r.direct_chunks for r in reps),
                "rows": rows,
                "direct_share": round(direct / rows, 4) if rows else 0.0}

    def _ir_audit_section(self) -> dict:
        """The capture audit (``analysis/ir_audit.py``): WF9xx findings
        over this graph's recorded step bodies and captures, re-read
        from the process store at read cadence (no step, no capture).
        With ``Config.ir_audit`` off this is the whole cost: one
        check."""
        try:
            from windflow_tpu_torch.analysis import ir_audit
            if not ir_audit.enabled(self.config):
                return {"enabled": False}
            report = ir_audit.audit_graph(self, dry_lower=False)
            self._ir_audit_report = report
            out = {"enabled": True}
            out.update(report.to_json())
            return out
        except Exception as e:  # lint: broad-except-ok (telemetry
            # degrades, the report still ships)
            return {"enabled": True, "error": f"{type(e).__name__}: "
                                              f"{e}"[:200]}

    def _preflight_section(self) -> dict:
        """The last check(): its mode, cost, findings and passes."""
        from windflow_tpu_torch.analysis.preflight import PASSES
        diags = self._preflight_diags
        ran = diags is not None
        return {
            "mode": getattr(self.config, "preflight", "error"),
            "check_ms": self._preflight_ms,
            "diagnostics": None if not ran else [str(d) for d in diags],
            "passes": list(PASSES) if ran else [],
        }

    def _rolling_rate(self, window_s: float) -> float:
        """Sunk tuples a second over at least the trailing ``window_s``."""
        if len(self._thr_samples) < 2:
            return 0.0
        now_t, now_v = self._thr_samples[-1]
        base = None
        for t, v in self._thr_samples:
            if now_t - t >= window_s:
                base = (t, v)
            else:
                break
        if base is None:
            base = self._thr_samples[0]
        dt = now_t - base[0]
        return (now_v - base[1]) / dt if dt > 0 else 0.0

    def op_frontier_and_depth(self, op) -> tuple:
        """``(summed inbox depth, watermark frontier)`` of one operator;
        the frontier is the MIN over replicas, so a stalled replica shows.
        Shared by :meth:`gauges` and the health plane."""
        from windflow_tpu_torch.batch import WM_MAX, WM_NONE
        depth = 0
        fronts = []
        for rep in op.replicas:
            depth += len(rep.inbox)
            wm = rep.current_wm
            if wm != WM_NONE and wm < WM_MAX:
                fronts.append(wm)
        return depth, (min(fronts) if fronts else None)

    def gauges(self) -> dict:
        """Point-in-time gauges: per-operator watermark lag and queue
        depth, staging-pool occupancy, rolling throughput."""
        from windflow_tpu_torch import staging
        now = current_time_usecs()
        per_op = {}
        for op in self._operators:
            depth, front = self.op_frontier_and_depth(op)
            per_op[op.name] = {
                "queue_depth": depth,
                "watermark_frontier_usec": front,
                "watermark_lag_usec":
                    max(0, now - front) if front is not None else None,
            }
        return {
            "sampled_at_usec": now,
            "operators": per_op,
            "staging_pool_held_bytes": staging.pools_stats()["held_bytes"],
            "throughput_1s_tps": round(self._rolling_rate(1.0), 1),
            "throughput_10s_tps": round(self._rolling_rate(10.0), 1),
        }

    def _latency_section(self) -> dict:
        """Per-operator service spans and the staged→sunk latency
        (p50/p95/p99), merged over replicas."""
        from windflow_tpu_torch.monitoring.recorder import LatencyHistogram
        per_op = {}
        e2e = LatencyHistogram()
        for op in self._operators:
            h = LatencyHistogram()
            for rep in op.replicas:
                h.merge(rep.stats.service_hist)
                e2e.merge(rep.stats.e2e_hist)   # nonzero only at sinks
            per_op[op.name] = h.quantiles()
        return {"service_usec_per_operator": per_op,
                "end_to_end_usec": e2e.quantiles()}

    def profile(self, duration_ms: float = 1000.0,
                log_dir: Optional[str] = None) -> str:
        """Drive the started graph for ``duration_ms`` (or to its end)
        under ``torch.profiler`` and write the capture (a Chrome trace,
        ``{name}_profile.json``) into ``log_dir`` / ``Config.profiler_dir``
        (default ``{log_dir}/{name}_profile``).  Traced batches' steps run
        inside ``record_function("op:<name> trace:<id>")``, so the
        capture's device spans line up with :meth:`dump_trace`'s by trace
        id.  Returns the capture directory."""
        if not self._started:
            raise WindFlowError("profile() needs a started graph: call "
                                "start() first (run() returns only when "
                                "the graph is done)")
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile
        d = log_dir or self.config.profiler_dir \
            or os.path.join(self.config.log_dir, f"{self.name}_profile")
        os.makedirs(d, exist_ok=True)
        self._last_profile_dir = d
        activities = [ProfilerActivity.CPU]
        if self.device is not None and self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with torch_profile(activities=activities) as prof:
            deadline = time.monotonic() + duration_ms / 1e3
            while time.monotonic() < deadline and not self.is_done():
                if not self.step():
                    break
        prof.export_chrome_trace(os.path.join(d, f"{self.name}_profile.json"))
        return d

    def dump_trace(self, path: Optional[str] = None) -> str:
        """Write the flight recorder's span events as Chrome-trace JSON
        (``{name}_trace.json`` under ``Config.log_dir``), loadable in
        ``chrome://tracing`` or Perfetto beside a :meth:`profile` capture
        (``otherData`` names the annotation format and the capture
        directory); the raw events go to ``{name}_events.json``.  Returns
        the trace's path."""
        if self._recorder is None:
            raise WindFlowError(
                "the flight recorder is off (Config.flight_recorder) or "
                "the graph has not been built: nothing to dump")
        from windflow_tpu_torch.monitoring.recorder import write_chrome_trace
        d = self.config.log_dir
        os.makedirs(d, exist_ok=True)
        path = path or os.path.join(d, f"{self.name}_trace.json")
        events = self._recorder.events()
        write_chrome_trace(events, path, metadata={
            "profiler_annotation_format": "op:<operator> trace:<trace_id>",
            "profiler_dir": self._last_profile_dir
            or self.config.profiler_dir
            or os.path.join(self.config.log_dir, f"{self.name}_profile"),
            "sweep": self._sweep_section(),
            "shard": self._shard_section(),
            "tenant": self._tenant_section(),
            "calibration": _calibration_summary(),
        })
        root, ext = os.path.splitext(path)
        base = root[:-len("_trace")] if root.endswith("_trace") else root
        with open(f"{base}_events{ext or '.json'}", "w") as f:
            json.dump(events, f)
        return path

    def stats(self) -> dict:
        """Stats report with the JAX package's sections (reference
        dashboard JSON, ``pipegraph.hpp:468-526``)."""
        self.sample_gauges()
        attribute_member_stats(self)
        plane = self._megastep_plane
        reps = self._all_replicas
        cfg = self.config
        off = {"enabled": False}
        return {
            "PipeGraph_name": self.name,
            "Mode": self.mode.value,
            "Backpressure": f"ON (max_inflight_batches="
                            f"{cfg.max_inflight_batches}, "
                            f"max_inbox_messages={cfg.max_inbox_messages})",
            "Backpressure_throttle_events": self._throttle_events,
            "Max_inbox_depth_seen": self._max_inbox_seen,
            "Max_inflight_device_batches_seen":
                self._max_inflight_device_seen,
            "Non_blocking": "ON",     # asynchronous device streams
            "Thread_pinning": "OFF",
            "Host_worker_threads": cfg.host_worker_threads,
            "Staging_pool": _staging_pool_stats(),
            "Staging": {"Wire": self._wire_section(),
                        "Ingest": self._ingest_section()},
            "Stage_prefetch_depth": cfg.stage_prefetch_depth,
            "Stage_prefetch_ticks": self._prefetch_ticks,
            "Dropped_tuples": self.get_num_dropped_tuples(),
            "Operator_number": len(self._operators),
            "Thread_number": 1 + cfg.host_worker_threads,
            "rss_size_kb": _rss_kb(),
            # wire bytes (the transfers) and logical bytes (the decoded
            # lanes): equal unless the wire plane compressed
            "Bytes_H2D_total": sum(r.stats.h2d_bytes for r in reps),
            "Bytes_H2D_logical_total": sum(r.stats.h2d_logical_bytes
                                           for r in reps),
            "Bytes_D2H_total": sum(r.stats.d2h_bytes for r in reps),
            "Flight_recorder": (self._recorder.summary()
                                if self._recorder is not None else off),
            "Spans": self._spans.summary(),
            "Preflight": self._preflight_section(),
            "Latency": self._latency_section(),
            "Latency_plane": self._latency_plane_section(),
            "Tenant": self._tenant_section(),
            "Roofline": self._roofline_section(),
            "Gauges": self.gauges(),
            "Health": self._health_section(),
            "Device": self._device_section(),
            "Sweep": self._sweep_section(),
            "Shard": self._shard_section(),
            "IR_audit": self._ir_audit_section(),
            "Megastep": (plane.summary() if plane is not None
                         else {"k": 1, "edges": [], "refused": []}),
            "Stateful": self._stateful_section(),
            "Durability": self._durability_section(),
            "Reshard": self._reshard_section(),
            "Operators": [op.dump_stats() for op in self._operators],
        }

    def _stateful_section(self) -> dict:
        """Per wavefront operator, the ``batches``, ``passes`` and
        ``lanes`` its steps counted on the device (one read each)."""
        from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
        out = {}
        for op in self._operators:
            if isinstance(op, _StatefulGPUBase):
                counts = op.wavefront_counts()
                if counts is not None:
                    out[op.name] = counts
        return out

    def dump_stats(self, log_dir: Optional[str] = None) -> str:
        """Write ``stats()`` as ``{name}_stats.json`` (``tools/
        wf_metrics.py`` renders it)."""
        d = log_dir or self.config.log_dir
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{self.name}_stats.json")
        with open(path, "w") as f:
            json.dump(self.stats(), f, indent=2)
        return path

    def dump_postmortem(self, dir: Optional[str] = None,
                        reason: str = "manual") -> str:
        """Black-box bundle: the last ``stats()``, the flight recorder's
        events, the health verdicts and stall attribution, the device
        gauges, the step registry, the preflight findings, the capture
        audit, the sweep, shard, latency and tenant ledgers, the
        roofline, the calibration provenance, the durability plane and
        the reshard executor, one
        JSON file each, plus
        ``manifest.json`` — what ``tools/wf_doctor.py`` renders and
        checks.  Every section is guarded on its own (a failure lands in
        the manifest's ``errors``): the crash path writes this exactly
        when parts of the telemetry may be broken.  Returns the bundle's
        directory."""
        with self._postmortem_lock:
            # the stats section re-enters the watchdog's sample: an
            # auto-bundle fired there on this thread would re-enter the
            # lock
            if self._health is not None:
                self._health._bundle_thread = threading.get_ident()
            try:
                return self._dump_postmortem_locked(dir, reason)
            finally:
                if self._health is not None:
                    self._health._bundle_thread = None

    def _dump_postmortem_locked(self, dir: Optional[str],
                                reason: str) -> str:
        d = dir or self.config.health_postmortem_dir \
            or os.path.join(self.config.log_dir, f"{self.name}_postmortem")
        os.makedirs(d, exist_ok=True)
        files: List[str] = []
        errors: dict = {}

        def write(name: str, build) -> None:
            try:
                obj = build()
                with open(os.path.join(d, name), "w") as f:
                    json.dump(obj, f, indent=1, default=str)
                files.append(name)
            except Exception as e:  # lint: broad-except-ok (sections degrade
                # one by one)
                errors[name] = f"{type(e).__name__}: {e}"[:300]

        def jit_tables():
            from windflow_tpu_torch.monitoring.jit_registry import \
                default_registry
            reg = default_registry()
            return {"jit": reg.snapshot(), "totals": reg.totals()}

        write("stats.json", self.stats)
        write("events.json", lambda: self._recorder.events()
              if self._recorder is not None else [])
        write("health.json", lambda: self._health.section(sample_first=False)
              if self._health is not None else {"enabled": False})
        write("device.json", self._device_section)
        write("jit.json", jit_tables)
        write("sweep.json", self._sweep_section)
        write("shard.json", self._shard_section)
        write("latency.json", self._latency_plane_section)
        write("tenant.json", self._tenant_section)
        write("roofline.json", self._roofline_section)
        write("calibration.json", _calibration_summary)
        write("durability.json", self._durability_section)
        write("reshard.json", self._reshard_section)
        write("preflight.json", self._preflight_section)
        write("ir_audit.json", self._ir_audit_section)
        from windflow_tpu_torch.monitoring.health import POSTMORTEM_SCHEMA
        manifest = {
            "schema": POSTMORTEM_SCHEMA,
            "app": self.name,
            "reason": reason,
            "written_at_usec": current_time_usecs(),
            "files": files,
            "errors": errors,
        }
        with open(os.path.join(d, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        self._postmortem_dir = d
        return d


def _device_edge_ops(edges) -> set:
    """ids of the operators at either end of an edge that carries device
    batches (a device producer or a device consumer): the host worker
    pool leaves their replicas on the driver thread."""
    out = set()
    for edge in edges:
        if edge[0] == "op":
            pairs = [(edge[1], edge[2])]
        else:
            mp = edge[1]
            pairs = [(mp.operators[-1], child.operators[0])
                     for child in mp.split_children]
        for a, b in pairs:
            if a.is_gpu or b.is_gpu:
                out.add(id(a))
                out.add(id(b))
    return out


def _calibration_summary() -> dict:
    """Where every modeled constant comes from now (``dump_trace``
    metadata, the postmortem's ``calibration.json``), guarded like every
    telemetry read."""
    try:
        from windflow_tpu_torch.monitoring import calibration
        return calibration.provenance_summary()
    except Exception as e:  # lint: broad-except-ok (never takes a dump down)
        return {"error": f"{type(e).__name__}: {e}"[:200]}


def _staging_pool_stats() -> dict:
    """The staging pools' recycling counters (``stats()["Staging_pool"]``)."""
    from windflow_tpu_torch import staging
    return staging.pools_stats()


def _rss_kb() -> float:
    """Resident set size in KiB (reference ``get_MemUsage``)."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * (os.sysconf("SC_PAGE_SIZE") / 1024.0)
    except (OSError, ValueError, IndexError):
        return 0.0
