"""Kafka_Source operator (the port of ``windflow_tpu/kafka/
kafka_source.py``; reference ``kafka_source.hpp:127,355``).

Each replica owns one consumer joined to the operator's consumer group, so
topic partitions spread across replicas and rebalance when replicas come
and go — exactly the reference's per-replica ``KafkaConsumer`` with the
cooperative rebalance callback (``kafka_source.hpp:57-123``).

The user deserializer runs per consumed message:
``fn(msg: KafkaMessage | None, shipper[, kafka_ctx]) -> bool | None`` —
``None`` msg means the consumer has been idle for ``idle_time_usec``
(reference ``consume(idleTime)`` timeout path); returning ``False`` stops
this replica (its EOS then flows through the graph).  Any other return
continues.  The shipper mirrors ``Source_Shipper``: ``push`` (ingress
timestamping) and ``pushWithTimestamp`` (event time).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from windflow_tpu_torch.basic import WindFlowError, current_time_usecs
from windflow_tpu_torch.kafka.client import (ASSIGNMENT_POLICIES,
                                       make_consumer)
from windflow_tpu_torch.kafka.kafka_context import KafkaRuntimeContext
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.source import Source, SourceReplica


class KafkaShipper:
    """Push interface handed to the deserializer (reference
    ``Source_Shipper``, ``source_shipper.hpp:59-``)."""

    __slots__ = ("_replica",)

    def __init__(self, replica: "KafkaSourceReplica") -> None:
        self._replica = replica

    def push(self, item: Any) -> None:
        r = self._replica
        ts = current_time_usecs()
        if ts <= r._last_ts:
            ts = r._last_ts + 1
        self.pushWithTimestamp(item, ts)

    def pushWithTimestamp(self, item: Any, ts: int) -> None:
        r = self._replica
        r._last_ts = max(r._last_ts, int(ts))
        # Per-partition watermarking: a replica assigned several partitions
        # must not let one partition's progress mark a lagging sibling's
        # tuples late — its watermark is the MIN over its assigned
        # partitions' event-time progress (what Kafka ecosystems call
        # per-partition watermarks).  An assigned partition that has not
        # delivered yet HOLDS THE WATERMARK DOWN (poll rotation may simply
        # not have reached it), until it stays silent for idle_time_usec —
        # then it stops gating (an empty partition must not stall event
        # time forever).  Pushes with no current partition (idle callback,
        # closing function) fold through the same gated per-partition
        # minimum — the replica-wide max could jump the watermark past a
        # lagging partition's pending data.
        if r._cur_tp is not None:
            pm = r._part_max
            prev = pm.get(r._cur_tp)
            advanced = prev is None or ts > prev
            if advanced:
                pm[r._cur_tp] = int(ts)
            # recompute only when this partition's frontier moved or the
            # fold was gated on an unheard partition — otherwise the min
            # is unchanged and the scan (and its clock read) is skipped
            if advanced or r._wm_gated:
                wm = r._partition_wm()
                r._wm_gated = wm is None
                if wm is not None:
                    r._advance_wm(wm)
        else:
            wm = r._partition_wm()
            if wm is None:
                # Distinguish "gated by a lagging partition" (hold the
                # watermark) from "no partitions assigned at all" (e.g.
                # parallelism > partition count): a partition-less
                # replica's heartbeat pushes exist precisely to keep
                # event time flowing — nothing can lag, so the replica-
                # wide max is safe there.
                asn = r._poll_asn
                if asn is None and r._consumer is not None:
                    asn = r._consumer.assignment()
                if not asn:
                    wm = r._last_ts
            if wm is not None:
                r._advance_wm(wm)
        r.stats.outputs_sent += 1
        r._tid_seq += 1
        r.emitter.emit(item, int(ts), r.current_wm,
                       tid=(r.op.ordinal, r.index, r._tid_seq))
        r._count_toward_punctuation(1)


class KafkaSourceReplica(SourceReplica):
    def __init__(self, op: "KafkaSource", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.deser_fn, 2)
        self._shipper = KafkaShipper(self)
        self._consumer = None
        self._last_activity = 0
        #: (topic, partition) of the message currently being deserialized
        self._cur_tp = None
        #: per-partition max pushed event ts (see KafkaShipper watermarking)
        self._part_max = {}
        #: first wall time each assigned partition was observed (grace
        #: anchor — per partition, so one gained in a later REBALANCE gets
        #: its own hold-down window, not the replica's long-expired one)
        self._part_seen_at = {}
        #: wall time of each partition's last delivered message — a heard
        #: partition silent past idle_time_usec stops gating the fold (it
        #: would otherwise pin the watermark forever on a live stream)
        self._part_last_at = {}
        self._wm_gated = True
        #: per-poll snapshots of assignment / idle partitions (tick
        #: refreshes; None until the first poll → computed on demand)
        self._poll_asn = None
        self._poll_idle = None

    def _partition_wm(self):
        """Min event-time progress over assigned LIVE partitions; None
        while an assigned partition still gates — unheard with data
        possibly pending (the watermark must not advance past data poll
        rotation hasn't reached).  An IDLE partition — confirmed drained
        by the consumer (exact, in-memory broker), or silent past
        idle_time_usec (wall-clock fallback, real-client adapters) — stops
        gating until it delivers again: it must not stall or pin event
        time on a live stream."""
        # per-poll snapshots (tick refreshes them): the per-push fast path
        # must not hit the consumer per tuple
        asn = self._poll_asn
        caught = self._poll_idle
        if asn is None:
            asn = self._consumer.assignment()
            caught = self._consumer.idle_partitions()
        idle_usec = self.op.idle_time_usec
        now = None
        lo = None
        for tp in asn:
            idle = caught is not None and tp in caught
            pts = self._part_max.get(tp)
            if pts is None:
                if idle:
                    continue         # confirmed empty: not gating
                if caught is None:
                    if now is None:
                        now = current_time_usecs()
                    seen = self._part_seen_at.setdefault(tp, now)
                    if now - seen >= idle_usec:
                        continue     # silent past the grace window
                return None          # unheard, possibly pending: gate
            if idle:
                continue             # heard, confirmed drained: no gate
            if caught is None and len(asn) > 1:
                if now is None:
                    now = current_time_usecs()
                if now - self._part_last_at.get(tp, now) >= idle_usec:
                    continue         # heard-then-silent: stops gating
            if lo is None or pts < lo:
                lo = pts
        return lo

    def start(self) -> None:
        self._consumer = make_consumer(self.op.brokers,
                                       self.op.assignment_policy)
        self._consumer.subscribe(self.op.topics, self.op.group_id,
                                 self.op.offsets)
        # durability restore (windflow_tpu_torch/durability): seek back to the
        # checkpointed per-partition cursors — the group may still hold
        # post-barrier positions from the run that crashed (messages it
        # polled but lost), and replaying them is exactly the point
        if self.op._restore_positions:
            self._consumer.seek_positions(self.op._restore_positions)
        if self.op._restore_part_max:
            # group-level per-partition event-time frontiers: every
            # replica seeds the full merged map (assignment may differ
            # from the checkpointing run); the first poll prunes entries
            # for partitions this replica does not own
            self._part_max.update(self.op._restore_part_max)
        # riched deserializers see a KafkaRuntimeContext (reference passes
        # KafkaRuntimeContext instead of RuntimeContext, kafka_source.hpp:134)
        self.context = KafkaRuntimeContext(
            self.op.parallelism, self.index, self.op.name,
            consumer=self._consumer)
        self._last_activity = current_time_usecs()

    def tick(self, max_items: int) -> bool:
        if self._exhausted:
            return False
        msgs = self._consumer.poll(max_items)
        run = True
        # snapshot once per poll for the per-push watermark fold: idleness
        # as of this poll (a refilled partition resumes gating at the next
        # poll; within-poll pushes can't contain its data anyway).  A
        # partition that DELIVERED in this poll is live by definition even
        # if the poll drained it — in the normal steady state (consumer
        # keeping pace) every partition is always caught up, and treating
        # that as idle would freeze the watermark forever.
        self._poll_asn = asn = self._consumer.assignment()
        # a partition revoked in a rebalance must not leave stale tracking
        # behind: re-gained later, it starts a fresh grace window and a
        # fresh event-time frontier (its backlog would otherwise be gated
        # by a long-expired _part_seen_at anchor and marked late)
        if asn is not None:
            live = set(asn)
            for d in (self._part_max, self._part_seen_at,
                      self._part_last_at):
                for tp in [t for t in d if t not in live]:
                    del d[tp]
        caught = self._consumer.idle_partitions()
        if caught is not None and msgs:
            caught = caught - {(m.topic, m.partition) for m in msgs}
        self._poll_idle = caught
        if msgs:
            self._last_activity = current_time_usecs()
            for msg in msgs:
                self._cur_tp = tp = (msg.topic, msg.partition)
                # delivery = liveness, even if the deserializer pushes
                # nothing for this message (one clock read per poll)
                self._part_last_at[tp] = self._last_activity
                ret = self._fn(msg, self._shipper, self.context)
                self._cur_tp = None
                self.stats.inputs_received += 1
                if ret is False:
                    run = False
                    break
        else:
            now = current_time_usecs()
            if now - self._last_activity >= self.op.idle_time_usec:
                self._last_activity = now
                ret = self._fn(None, self._shipper, self.context)
                if ret is False:
                    run = False
        if not run:
            self._exhausted = True
            # terminate first: the closing function (reference
            # kafka_closing_func, kafka_source.hpp:296) must see a live
            # consumer (commit offsets, read assignment); close after
            self._terminate()
            self._consumer.close()
            return True  # termination (EOS cascade) is progress
        return True


class KafkaSource(Source):
    replica_class = KafkaSourceReplica

    #: per-(topic, partition) cursors a durability restore stashes before
    #: start(); replicas seek to them right after subscribing (None on
    #: fresh runs — one attribute check at start, nothing per poll)
    _restore_positions = None
    #: merged per-partition event-time frontiers (same restore path):
    #: group-level, seeded into every replica at start
    _restore_part_max = None

    def __init__(self, deser_fn: Callable, brokers, topics: Sequence[str],
                 group_id: str = "windflow",
                 offsets: Optional[Sequence[int]] = None,
                 idle_time_usec: int = 100_000,
                 assignment_policy: str = "cooperative-sticky",
                 name: str = "kafka_source", parallelism: int = 1,
                 output_batch_size: int = 0) -> None:
        if not topics:
            raise WindFlowError("Kafka_Source needs at least one topic")
        if assignment_policy not in ASSIGNMENT_POLICIES:
            raise WindFlowError(
                f"unknown assignment policy '{assignment_policy}' "
                f"(one of {ASSIGNMENT_POLICIES})")
        # bypass Source.__init__'s generator plumbing; Operator init only
        super().__init__(gen_fn=lambda: iter(()), name=name,
                         parallelism=parallelism,
                         output_batch_size=output_batch_size)
        self.deser_fn = deser_fn
        self.brokers = brokers
        self.topics = list(topics)
        self.group_id = group_id
        self.offsets = list(offsets) if offsets is not None else None
        self.idle_time_usec = idle_time_usec
        self.assignment_policy = assignment_policy
