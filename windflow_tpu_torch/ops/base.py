"""Operator and replica base classes (the port of ``windflow_tpu/ops/
base.py``; reference ``Basic_Operator`` / ``Basic_Replica``).

A replica is a plain object whose ``drain()`` the host's
cooperative scheduler calls (graph/pipegraph.py); device work is enqueued
on the card's stream and runs asynchronously.  End-of-stream follows the
reference protocol: an EOS punctuation per input channel; when all have
arrived, the replica flushes operator state and its emitter, forwards
EOS, and terminates.  A replica keeps its ``StatsRecord``
(``monitoring/stats.py``) and, with the flight recorder on, its span
ring: ``_dispatch`` stamps ``collected`` on a
traced batch and, at a sink, ``sunk`` plus the staged→sunk latency.
Each dispatch of a batch runs inside the replica's own host span
(``wf:drain:<op>``, ``monitoring/recorder.ServiceSpan``), whose clock
reads feed the stats record's service time.
"""

from __future__ import annotations

import copy
from collections import deque
from typing import Any, Callable, List, Optional

from windflow_tpu_torch.analysis import debug_concurrency as _dbg
from windflow_tpu_torch.basic import (ExecutionMode, RoutingMode, TimePolicy,
                                      WindFlowError, current_time_usecs,
                                      default_config)
from windflow_tpu_torch.batch import (DeviceBatch, HostBatch, Punctuation,
                                      WM_MAX, WM_NONE)
from windflow_tpu_torch.context import RuntimeContext
from windflow_tpu_torch.monitoring import recorder as flightrec
from windflow_tpu_torch.monitoring.stats import StatsRecord


class Replica:
    """One logical replica of an operator (reference ``Basic_Replica``)."""

    #: replicas whose user function may mutate its input copy a shared
    #: (multicast) tuple first (reference ``copyOnWrite``, map.hpp:57-215)
    copy_on_shared = False
    #: the replica's own span is ``wf:<span_kind>:<operator>``
    span_kind = "drain"

    def __init__(self, op: "Operator", index: int) -> None:
        self.op = op
        self.index = index
        self.context = RuntimeContext(op.parallelism, index, op.name)
        self.inbox: deque = deque()
        #: outstanding device batches in this inbox (the in-transit count
        #: the scheduler throttles against)
        self.inflight_device = 0
        self.collector = None                       # wired by the graph
        self.emitter = None                         # wired by the graph
        self.config = default_config                # PipeGraph overrides
        self.num_channels = 0
        self._eos_channels = set()
        self.done = False
        self.current_wm = WM_NONE
        #: the last watermark handed to on_watermark
        self._hooked_wm = WM_NONE
        self.stats = StatsRecord(operator_name=op.name, replica_index=index,
                                 is_gpu=op.is_gpu)
        #: the replica's own host span: each dispatch's two clock reads
        #: feed the stats record's service time and histogram
        self._service = flightrec.ServiceSpan(
            f"wf:{self.span_kind}:{op.name}", self.stats)
        #: flight-recorder span ring (monitoring/recorder.py), bound by
        #: PipeGraph._build when Config.flight_recorder is on; None
        #: leaves one `is not None` check a batch
        self.ring = None
        #: traced batches seen (the device_done cadence)
        self._traced_seen = 0
        #: latency ledger (monitoring/latency_ledger.py), bound on window
        #: replicas by PipeGraph._build for the freshness gauge; None
        #: leaves one `is not None` check at the waited batch
        self.latency = None
        self.mode = ExecutionMode.DEFAULT
        self.time_policy = TimePolicy.INGRESS
        #: origin id of the input being processed (HostBatch.ids): relays
        #: pass it on so DETERMINISTIC ordering breaks timestamp ties the
        #: same way under any parallelism (reference Single_t id)
        self.cur_tid = None

    # -- wiring -------------------------------------------------------------
    def add_channel(self) -> int:
        ch = self.num_channels
        self.num_channels += 1
        return ch

    # -- runtime ------------------------------------------------------------
    def receive(self, channel: int, msg) -> None:
        self.inbox.append((channel, msg))
        if isinstance(msg, DeviceBatch):
            self.inflight_device += 1

    def drain(self, limit: int = 0) -> bool:
        """Process pending inbox messages (at most ``limit`` when > 0).
        Returns True if any progress was made."""
        if _dbg.ENABLED:
            # single-consumer contract: the scheduler drains a replica
            # from one thread at a time; a second thread draining it
            # concurrently is a scheduler race
            with _dbg.entry_guard(self, "Replica.drain"):
                return self._drain_impl(limit)
        return self._drain_impl(limit)

    def _drain_impl(self, limit: int) -> bool:
        progressed = False
        n = 0
        while self.inbox:
            if limit and n >= limit:
                break
            n += 1
            channel, msg = self.inbox.popleft()
            if isinstance(msg, DeviceBatch):
                self.inflight_device -= 1
            progressed = True
            if isinstance(msg, Punctuation) and msg.is_eos:
                self._handle_channel_eos(channel)
                continue
            for ready in self.collector.on_message(channel, msg):
                self._dispatch(ready)
        return progressed

    def _handle_channel_eos(self, channel: int) -> None:
        if channel in self._eos_channels:
            return
        self._eos_channels.add(channel)
        for ready in self.collector.on_channel_eos(channel):
            self._dispatch(ready)
        if len(self._eos_channels) == self.num_channels:
            self._terminate()

    def _terminate(self) -> None:
        if self.done:
            return
        self.on_eos()
        if self.emitter is not None:
            self.emitter.flush(self.current_wm)
            self.emitter.propagate_punctuation(WM_MAX)
        cf = self.op.closing_func
        if cf is not None:
            from windflow_tpu_torch.meta import adapt
            adapt(cf, 0)(self.context)
        self.done = True
        self.stats.is_terminated = True

    def _dispatch(self, msg) -> None:
        if _dbg.ENABLED:
            # a stats record belongs to one replica, driven by one thread
            # at a time: an overlapping dispatch from another thread means
            # two threads drive the same replica (exception safe: an
            # operator raising mid-batch leaves no stale entry behind)
            with _dbg.entry_guard(self.stats, "Replica._dispatch"):
                return self._dispatch_impl(msg)
        return self._dispatch_impl(msg)

    def _dispatch_impl(self, msg) -> None:
        if isinstance(msg, Punctuation):
            self._advance_wm(msg.watermark)
            self._maybe_hook_wm()
            if self.emitter is not None:
                self.emitter.propagate_punctuation(self.current_wm)
            return
        # flight recorder: span events of the 1-in-N traced batch; an
        # untraced batch costs one attribute check
        tr = msg.trace if self.ring is not None else None
        if tr is not None:
            self.ring.record(tr[0], flightrec.COLLECTED,
                             current_time_usecs())
        with self._service:
            if isinstance(msg, DeviceBatch):
                self._advance_wm(msg.watermark)
                self.stats.inputs_received += msg.known_size or 0
                self.process_device_batch(msg)
            else:
                if not isinstance(msg, HostBatch):
                    raise WindFlowError(
                        f"operator '{self.op.name}' received {type(msg)}")
                self._advance_wm(msg.watermark)
                self.stats.inputs_received += len(msg)
                # a multicast batch is shared by sibling replicas: an
                # in-place-capable operator mutates a private copy
                cow = msg.shared and self.copy_on_shared
                for item, ts, tid in zip(msg.items, msg.tss,
                                         msg.ids_or_nones()):
                    if cow:
                        item = copy.deepcopy(item)
                    self.cur_tid = tid
                    self.context._set_context(ts, msg.watermark)
                    self.process_single(item, ts, msg.watermark)
                self.cur_tid = None
            self._maybe_hook_wm()
        if tr is not None and self.op.is_terminal:
            # the staged→sunk span closes at sink receipt (a deferred
            # columnar sink copies later)
            now = current_time_usecs()
            self.ring.record(tr[0], flightrec.SUNK, now)
            self.stats.e2e_hist.add(now - tr[1])

    def _maybe_hook_wm(self) -> None:
        # the (possibly O(open windows)) hook runs on a real advance only
        if self.current_wm != self._hooked_wm:
            self._hooked_wm = self.current_wm
            self.on_watermark(self.current_wm)

    def _advance_wm(self, wm: int) -> None:
        if wm != WM_NONE and wm > self.current_wm:
            self.current_wm = wm

    # -- operator logic (overridden by concrete replicas) --------------------
    def process_single(self, item: Any, ts: int, wm: int) -> None:
        raise WindFlowError(
            f"operator '{self.op.name}' cannot consume host tuples")

    def process_device_batch(self, batch: DeviceBatch) -> None:
        raise WindFlowError(
            f"operator '{self.op.name}' cannot consume device batches")

    def on_eos(self) -> None:
        """Flush hook: window firing, sink finalization, etc."""

    def on_watermark(self, wm: int) -> None:
        """Watermark-advance hook (fires time windows past the frontier)."""


class Operator:
    """Descriptor for one operator in the graph (reference
    ``Basic_Operator``): name, parallelism, input routing, output batch
    size, and whether its compute runs on the card."""

    replica_class = Replica
    is_terminal = False
    ordinal = 0
    closing_func = None
    #: non-None on device operators whose state layout is tied to ONE
    #: batch capacity: the graph build refuses merged upstream paths
    #: that deliver unequal capacities (the label names it in the error)
    fixed_capacity_label = None
    #: whole-chain fusion (windflow_tpu_torch/fusion): on a fused
    #: segment's MEMBERS, the name of the hop they folded into (their
    #: replicas are inert; stats are attributed from the hop)
    _fused_into = None
    #: on a segment's stateful TAIL: the members' record transform,
    #: ``(payload, valid) -> (payload, valid)``, which the tail applies
    #: ahead of its own step
    _fused_prelude = None
    #: on an all-stateless segment's last member: the FusedStatelessExec
    #: its replicas run instead of their own step
    _fusion_exec = None
    #: key compaction (parallel/compaction.py): the KeyCompactor the
    #: graph build attached to this keyed consumer, else None
    _compactor = None
    #: the step registry's handle (``watch``), made lazily
    _watch = None
    #: host operators whose replicas the host worker pool may drain
    #: concurrently (``Config.host_worker_threads``); operators with
    #: cross-replica shared mutable state (a shared persistent DB handle)
    #: clear this to stay on the driver thread
    host_pool_safe = True

    def __init__(self, name: str, parallelism: int,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 output_batch_size: int = 0,
                 is_gpu: bool = False,
                 key_extractor: Optional[Callable] = None) -> None:
        if parallelism < 1:
            raise WindFlowError(
                f"operator '{name}' must have parallelism >= 1")
        self.name = name
        self.parallelism = parallelism
        self.routing = routing
        self.output_batch_size = output_batch_size
        self.is_gpu = is_gpu
        self.key_extractor = key_extractor
        self.replicas: List[Replica] = []
        self.config = default_config
        #: the torch.device the graph runs on, set by PipeGraph._build
        self.device = None
        #: Config.mesh, set by PipeGraph._build: mesh-aware operators run
        #: their sharded steps when this is not None (parallel/mesh.py)
        self.mesh = None

    @property
    def is_keyed(self) -> bool:
        return self.routing == RoutingMode.KEYBY

    def build_replicas(self, mode: ExecutionMode,
                       time_policy: TimePolicy) -> List[Replica]:
        if self.is_gpu and mode != ExecutionMode.DEFAULT:
            # reference builders reject GPU operators outside DEFAULT mode
            raise WindFlowError(
                f"GPU operator '{self.name}' requires DEFAULT execution mode")
        self.replicas = [self.replica_class(self, i)
                         for i in range(self.parallelism)]
        for r in self.replicas:
            r.mode = mode
            r.time_policy = time_policy
        return self.replicas

    def key_space(self) -> Optional[int]:
        """Declared dense key-space bound of a keyed operator
        (``withMaxKeys`` / dense ``withNumKeySlots``), or None for
        arbitrary or interned keys.  The shard ledger keeps an exact
        per-key histogram for a bounded space and the count-min sketch
        otherwise."""
        return None

    @property
    def watch(self):
        """This operator's handle in the step registry
        (``monitoring/jit_registry.py``), made at its first use."""
        w = self._watch
        if w is None:
            from windflow_tpu_torch.monitoring.jit_registry import \
                default_registry
            w = self._watch = default_registry().watch(self.name)
        return w

    def num_dropped_tuples(self) -> int:
        """Tuples this operator dropped as too late (time windows);
        folded into ``PipeGraph.get_num_dropped_tuples``."""
        return 0

    #: True on operators holding cross-batch state the durability plane
    #: cannot snapshot (the host window engines and the persistent
    #: suite; preflight names them as WF603)
    checkpoint_opaque = False

    def snapshot_state(self) -> Optional[dict]:
        """Durable-state hook (windflow_tpu_torch/durability): one
        picklable blob capturing ALL cross-batch state this operator
        owns (its replicas' included), taken at the quiesced checkpoint
        barrier.  ``None`` means stateless — nothing written, nothing
        restored.  Device tensors come back as numpy COPIES
        (``utils.tree.host_copy``: the steps update state in place, so a
        view would change under the next step), and the layout is the
        JAX package's, so either package's blob restores into the
        other's operator."""
        return None

    def restore_state(self, blob: dict) -> None:
        """Inverse of :meth:`snapshot_state`, applied to a freshly built
        (never-stepped) operator before the first source tick; tensors
        land on the graph's device (``utils.tree.place_tree``)."""
        raise WindFlowError(
            f"operator '{self.name}' ({type(self).__name__}) cannot "
            "restore checkpoint state it never snapshots")

    def _state_device(self):
        """The device restored state lands on: the graph's, or the
        Config's before a build."""
        if self.device is not None:
            return self.device
        from windflow_tpu_torch.basic import resolve_device
        return resolve_device(self.config)

    def dump_stats(self) -> dict:
        st = {
            "Operator_name": self.name,
            "Operator_type": type(self).__name__,
            "Parallelism": self.parallelism,
            "Replicas": [r.stats.to_json() for r in self.replicas],
        }
        if self._fused_into is not None:
            # this operator's work runs inside a fused hop; the counters
            # above are attributed from that hop
            st["Fused_into"] = self._fused_into
        mesh = self.mesh if self.is_gpu else None
        if mesh is not None:
            # a mesh operator's shape, positions' devices and processes
            st["Mesh"] = {"shape": dict(mesh.shape),
                          "devices": [str(d) for d in mesh.devices.ravel()],
                          "processes": mesh.process_count}
        return st
