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

At build, ``Config.key_compaction`` gives every keyed declared-monoid
``withMaxKeys`` ReduceGPU its bounded compacted step.  The JAX package's
preflight, calibration, wire, megastep, durability, whole-chain fusion,
monitoring planes and ``KeyCompactor`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from windflow_tpu_torch.basic import (Config, ExecutionMode,
                                      TimePolicy, WindFlowError,
                                      default_config, resolve_device)
from windflow_tpu_torch.graph.multipipe import MultiPipe
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.reduce import ReduceGPU
from windflow_tpu_torch.ops.source import Source, SourceReplica
from windflow_tpu_torch.parallel.collectors import create_collector
from windflow_tpu_torch.parallel.emitters import create_emitter


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
        self._started = False
        self._collectors = []
        self._all_replicas = []
        self._source_replicas: List[SourceReplica] = []
        self._operators: List[Operator] = []
        self.device = None
        self._throttle_events = 0
        self._max_inbox_seen = 0
        self._max_inflight_device_seen = 0

    # -- construction --------------------------------------------------------
    def add_source(self, source: Source) -> MultiPipe:
        if self._started:
            raise WindFlowError("cannot add sources to a running PipeGraph")
        mp = MultiPipe(self, source)
        self.pipes.append(mp)
        return mp

    # -- wiring --------------------------------------------------------------
    def _build(self) -> None:
        # the device first: without CUDA a cuda graph raises here, before
        # any replica exists (no silent CPU fallback)
        self.device = resolve_device(self.config)
        # 1. instantiate replicas
        for mp in self.pipes:
            for op in mp.operators:
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
        if getattr(self.config, "key_compaction", True):
            # keyed declared-monoid withMaxKeys reduces: the bounded
            # compacted step (parallel/compaction.py)
            for op in self._operators:
                if isinstance(op, ReduceGPU) and op.monoid is not None \
                        and op.max_keys is not None \
                        and op.key_extractor is not None:
                    op.enable_bounded_compaction()

        # 2. wire edges: emitters on the producing replicas, channels on
        #    the consuming ones
        for mp in self.pipes:
            for a, b in zip(mp.operators, mp.operators[1:]):
                for src_rep in a.replicas:
                    dests = [(dst_rep, dst_rep.add_channel())
                             for dst_rep in b.replicas]
                    src_rep.emitter = create_emitter(
                        b.routing, dests, a.output_batch_size,
                        src_is_gpu=a.is_gpu, dst_is_gpu=b.is_gpu,
                        device=self.device)

        # 3. collectors: one per replica with input channels
        for rep in self._all_replicas:
            if rep.num_channels > 0:
                rep.collector = create_collector(self.mode, rep.num_channels)
                self._collectors.append(rep.collector)
            if rep.emitter is not None:
                rep.emitter.bind_stats(rep.stats)

        # every non-sink replica must have an emitter
        for op in self._operators:
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
        self._build()
        for sr in self._source_replicas:
            sr.start()

    def wait_end(self) -> "PipeGraph":
        if not self._started:
            raise WindFlowError("wait_end before start")
        while not self.is_done():
            if not self.step():
                raise WindFlowError(
                    "PipeGraph stalled: no replica made progress but the "
                    "graph has not terminated")
        return self

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
        return progress

    def _tick_chunk(self, sr) -> int:
        return self.config.source_tick_chunk \
            or sr.op.output_batch_size or 256

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

    def stats(self) -> dict:
        return {
            "PipeGraph_name": self.name,
            "Device": str(self.device),
            "Operators": [op.dump_stats() for op in self._operators],
            "Backpressure": {
                "throttle_events": self._throttle_events,
                "max_inbox_depth": self._max_inbox_seen,
                "max_inflight_device": self._max_inflight_device_seen,
            },
        }
