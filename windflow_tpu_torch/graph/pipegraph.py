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
last complete epoch.  The JAX package's preflight, calibration and
monitoring planes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from windflow_tpu_torch.basic import (Config, ExecutionMode, RoutingMode,
                                      TimePolicy, WindFlowError,
                                      default_config, resolve_device)
from windflow_tpu_torch.fusion.chains import edge_degrees
from windflow_tpu_torch.fusion.executor import (apply_fusion,
                                                attribute_member_stats)
from windflow_tpu_torch.graph.multipipe import MultiPipe
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
        #: checkpoint state restore() stashed for start() to apply
        self._pending_restore = None

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
        here, with the sizes, instead of mid-run."""
        for op, label, caps in capacity_conflicts(self._edges()):
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
            op.build_replicas(self.mode, self.time_policy)
        for op in self._operators:
            self._all_replicas.extend(op.replicas)
            if isinstance(op, Source):
                self._source_replicas.extend(op.replicas)
        for rep in self._all_replicas:
            rep.config = self.config
        self._check_fixed_capacity_ops()

        # 1b. whole-chain fusion, installed before wiring so each segment
        # is wired as one hop
        if getattr(self.config, "whole_chain_fusion", True):
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
                    key_extractor=route_op.key_extractor))
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

        # 2c. key compaction: after fusion (preludes installed) and the
        # wiring (the emitters exist), before any step
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

        # 3. collectors: one per replica with input channels
        for rep in self._all_replicas:
            if rep.num_channels > 0:
                rep.collector = create_collector(self.mode, rep.num_channels)
                self._collectors.append(rep.collector)
            if rep.emitter is not None:
                rep.emitter.bind_stats(rep.stats)

        # every live non-sink replica must have an emitter
        for op in self._operators:
            if op._fused_into is not None:
                continue
            for rep in op.replicas:
                if rep.emitter is None and not op.is_terminal:
                    raise WindFlowError(
                        f"operator '{op.name}' has no downstream consumer — "
                        "every MultiPipe must end in a Sink")

    # -- execution -----------------------------------------------------------
    def run(self) -> "PipeGraph":
        """Build, then drive the whole graph to completion (reference
        ``run()`` = ``start()`` + ``wait_end()``)."""
        self.start()
        return self.wait_end()

    def start(self) -> None:
        if self._started:
            raise WindFlowError("PipeGraph already started")
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
            for sr in self._source_replicas:
                sr.start()
        except BaseException:
            self._finalize()
            raise

    def wait_end(self) -> "PipeGraph":
        if not self._started:
            raise WindFlowError("wait_end before start")
        try:
            while not self.is_done():
                if not self.step():
                    raise WindFlowError(
                        "PipeGraph stalled: no replica made progress but "
                        "the graph has not terminated")
        finally:
            # ended or crashed: the checkpoint store is flushed and
            # closed, so a restore in this process reopens a whole log
            self._finalize()
        return self

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

    def _finalize(self) -> None:
        if self._durability is not None:
            # counters stay readable: stats() reads the plane's fields
            self._durability.close()

    def step(self) -> bool:
        """One scheduler sweep: pull a chunk from each live source (unless
        backpressured), then drain every replica in topological order.
        Returns True on any progress."""
        progress = False
        throttled = self._backpressured()
        if throttled:
            self._throttle_events += 1
        for sr in self._source_replicas:
            if not sr.exhausted and not throttled:
                if sr.tick(self._tick_chunk(sr)):
                    progress = True
                sr.maybe_punctuate()
        limit = self.config.sweep_drain_limit
        for rep in self._all_replicas:
            if rep.drain(limit):
                progress = True
        # staging lookahead: the drain only enqueued device work, so pack
        # the next batch on the host while the card runs
        for _ in range(max(0, self.config.stage_prefetch_depth)):
            if self._backpressured():
                break
            ticked = False
            for sr in self._source_replicas:
                if not sr.exhausted and sr.tick(self._tick_chunk(sr)):
                    ticked = True
            if not ticked:
                break
            progress = True
        if not progress:
            # never deadlock on our own throttle
            for sr in self._source_replicas:
                if not sr.exhausted and sr.tick(self._tick_chunk(sr)):
                    progress = True
        if self._durability is not None:
            # epoch cadence: counts sweeps and, every
            # Config.durability_epoch_sweeps-th, quiesces to the aligned
            # barrier and commits a checkpoint epoch.  Under an active
            # megastep plane one sweep paces whole groups, so every
            # quiesce lands between megasteps
            self._durability.on_sweep()
        return progress

    def _tick_chunk(self, sr) -> int:
        chunk = self.config.source_tick_chunk \
            or sr.op.output_batch_size or 256
        plane = self._megastep_plane
        if plane is not None and plane.active \
                and getattr(sr.emitter, "_megastep", None) is not None:
            # K-granular pacing: a tick stages a whole group's batches
            chunk *= plane.k
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

    def stats(self) -> dict:
        from windflow_tpu_torch.wire import wire_section
        attribute_member_stats(self)
        plane = self._megastep_plane
        reps = self._all_replicas
        return {
            "PipeGraph_name": self.name,
            "Device": str(self.device),
            "Operators": [op.dump_stats() for op in self._operators],
            "Backpressure": {
                "throttle_events": self._throttle_events,
                "max_inbox_depth": self._max_inbox_seen,
                "max_inflight_device": self._max_inflight_device_seen,
            },
            # wire bytes (the transfers) and logical bytes (the decoded
            # lanes): equal unless the wire plane compressed
            "Bytes_H2D_total": sum(r.stats.h2d_bytes for r in reps),
            "Bytes_H2D_logical_total": sum(r.stats.h2d_logical_bytes
                                           for r in reps),
            "Staging": {"Wire": wire_section(self)},
            "Megastep": (plane.summary() if plane is not None
                         else {"k": 1, "edges": [], "refused": []}),
            "Durability": (self._durability.section()
                           if self._durability is not None
                           else {"enabled": False}),
        }


# ---------------------------------------------------------------------------
# the build-time capacity walk (the port's copy of capacity_conflicts,
# windflow_tpu/analysis/preflight.py:130; preflight itself is ROADMAP A9)
# ---------------------------------------------------------------------------

def _upstream_map(edges) -> dict:
    """id(op) -> (op, [upstream ops]) over every edge, split fan-outs
    included."""
    ups: dict = {}
    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            ups.setdefault(id(b), (b, []))[1].append(a)
        else:
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                if child.operators:
                    head = child.operators[0]
                    ups.setdefault(id(head), (head, []))[1].append(src)
    return ups


def _effective_caps(op, ups, seen=None) -> set:
    """Batch capacities a device batch can arrive with at ``op``: a host
    operator (or a device source) stamps its ``output_batch_size``;
    device operators pass their input capacity through."""
    seen = seen if seen is not None else set()
    if id(op) in seen:
        return set()
    seen.add(id(op))
    if not op.is_gpu or isinstance(op, Source):
        return {op.output_batch_size}
    caps = set()
    for up in ups.get(id(op), (None, []))[1]:
        caps |= _effective_caps(up, ups, seen)
    return caps


def capacity_conflicts(edges) -> list:
    """``[(op, label, caps)]``: fixed-capacity device operators whose
    upstream paths deliver unequal batch capacities."""
    ups = _upstream_map(edges)
    out = []
    for op, preds in ups.values():
        label = op.fixed_capacity_label
        if label is None:
            continue
        caps = set()
        for up in preds:
            caps |= _effective_caps(up, ups)
        if len(caps) > 1:
            out.append((op, label, caps))
    return out
