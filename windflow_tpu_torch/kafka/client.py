"""Kafka client layer (the port of ``windflow_tpu/kafka/client.py``):
message type, abstract consumer/producer, an in-process broker with
topics, partitions, consumer groups (partition assignment + cooperative
rebalance) and the exactly-once sink fence, and the gated adapters for a
real client library.

The reference binds directly to librdkafka (``kafka_source.hpp`` consumer
+ rebalance callback, ``kafka_sink.hpp`` per-replica producer).  Here the
operators talk to a small client interface; :class:`InMemoryBroker` is the
replayable source and fenced sink every durability chaos cell runs on;
any other ``brokers`` value is a bootstrap address for the
``confluent_kafka`` adapters (:class:`ConfluentConsumer`,
:class:`ConfluentProducer`, librdkafka underneath), whose import is
guarded: without the package, connecting raises a ``WindFlowError``
naming it.  The adapters are exercised against a faked module, never a
live broker.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from windflow_tpu_torch.basic import (WindFlowError, current_time_usecs,
                                stable_hash)


@dataclasses.dataclass
class KafkaMessage:
    """One consumed record (reference ``RdKafka::Message`` surface the user
    deserializer touches: topic/partition/offset/key/payload/timestamp)."""
    topic: str
    partition: int
    offset: int
    key: Optional[bytes]
    value: Any
    timestamp_usec: int


#: partition assignment strategies the client layer understands; the
#: in-memory broker implements one cooperative round-robin assignment (the
#: names map onto it)
ASSIGNMENT_POLICIES = ("cooperative-sticky", "roundrobin", "range")


class ConsumerClient:
    #: selected partition assignment strategy (withAssignmentPolicy)
    assignment_policy = "cooperative-sticky"

    def idle_partitions(self):
        """Partitions confirmed drained/idle, or None when the client
        cannot know (the source then uses wall-clock idleness)."""
        return None

    def positions(self):
        """Next-poll offset per assigned (topic, partition) — what a
        durability checkpoint records so restore resumes exactly where
        the barrier drained to — or None when the client cannot tell."""
        return None

    def seek_positions(self, positions) -> None:
        """Rewind/advance the consumer to explicit per-partition
        offsets (restore path).  Default: unsupported, ignored — the
        source then falls back to the coarser per-topic start offsets."""

    def subscribe(self, topics: Sequence[str], group_id: str,
                  offsets: Optional[Sequence[int]] = None) -> None:
        raise NotImplementedError

    def poll(self, max_msgs: int) -> List[KafkaMessage]:
        raise NotImplementedError

    def assignment(self) -> List[Tuple[str, int]]:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class ProducerClient:
    def produce(self, topic: str, value: Any, key: Optional[bytes] = None,
                partition: Optional[int] = None,
                timestamp_usec: Optional[int] = None) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# In-process broker
# ---------------------------------------------------------------------------

class _Partition:
    __slots__ = ("log",)

    def __init__(self) -> None:
        self.log: List[KafkaMessage] = []


class InMemoryBroker:
    """Topics × partitions with consumer-group assignment.

    Rebalance model: joining or leaving a group recomputes the round-robin
    assignment of every subscribed (topic, partition) over the group's
    members in join order; read positions live with the *group* (per
    topic-partition), so a partition handed to another member resumes where
    the previous owner stopped — the in-process analogue of the reference's
    cooperative incremental rebalance (``kafka_source.hpp:77-123``)."""

    def __init__(self) -> None:
        self._topics: Dict[str, List[_Partition]] = {}
        self._groups: Dict[str, "_Group"] = {}
        self._lock = threading.Lock()
        self._rr = itertools.count()
        # exactly-once sink fences (windflow_tpu_torch/durability): fence_id ->
        # (epoch, seq) of the LAST message committed through
        # fenced_commit.  The in-process stand-in for Kafka transactions:
        # commit + fence advance are atomic under the broker lock, so a
        # kill can never half-publish an epoch, and a replayed commit
        # dedupes on the producer-lifetime sequence number.
        self._fences: Dict[str, Tuple[int, int]] = {}

    # -- admin ---------------------------------------------------------------
    def create_topic(self, name: str, num_partitions: int = 1) -> None:
        with self._lock:
            if name in self._topics:
                if len(self._topics[name]) != num_partitions:
                    raise WindFlowError(
                        f"topic '{name}' already exists with "
                        f"{len(self._topics[name])} partitions")
                return
            self._topics[name] = [_Partition()
                                  for _ in range(num_partitions)]
            self._rebalance_subscribers(name)

    def _rebalance_subscribers(self, topic: str) -> None:
        """New topic (explicit or auto-created by produce): groups already
        subscribed to it must pick up its partitions, like a metadata
        refresh on a real broker.  Caller holds the lock."""
        for g in self._groups.values():
            if any(topic in m._topics for m in g.members):
                g.rebalance(self)

    def partitions(self, topic: str) -> int:
        with self._lock:
            if topic not in self._topics:
                raise WindFlowError(f"unknown topic '{topic}'")
            return len(self._topics[topic])

    def topic_size(self, topic: str) -> int:
        with self._lock:
            return sum(len(p.log) for p in self._topics.get(topic, ()))

    # -- produce -------------------------------------------------------------
    def _append(self, topic: str, value: Any, key: Optional[bytes],
                partition: Optional[int], ts: Optional[int]) -> None:
        with self._lock:
            self._append_locked(topic, value, key, partition, ts)

    def _append_locked(self, topic: str, value: Any, key: Optional[bytes],
                       partition: Optional[int], ts: Optional[int]) -> None:
        parts = self._topics.get(topic)
        if parts is None:
            parts = self._topics[topic] = [_Partition()]
            self._rebalance_subscribers(topic)
        if partition is None:
            if key is not None:
                # deterministic placement: Python's hash() is salted
                # per process, which would scatter one key across
                # partitions between producer processes (Kafka uses
                # murmur2 for the same reason); stable_hash is crc32
                # for bytes
                partition = stable_hash(key) % len(parts)
            else:
                partition = next(self._rr) % len(parts)
        if not 0 <= partition < len(parts):
            raise WindFlowError(
                f"partition {partition} out of range for '{topic}'")
        p = parts[partition]
        p.log.append(KafkaMessage(
            topic=topic, partition=partition, offset=len(p.log), key=key,
            value=value,
            timestamp_usec=ts if ts is not None else current_time_usecs()))

    # -- exactly-once sink fence (windflow_tpu_torch/durability) ------------
    def fenced_commit(self, fence_id: str, epoch: int, msgs) -> Tuple[int,
                                                                      int]:
        """Atomically publish an epoch's buffered sink messages, deduping
        on the producer-lifetime sequence number: ``msgs`` is a list of
        ``(seq, topic, value, key, partition, ts)`` with ``seq`` strictly
        increasing across the replica's whole lifetime (checkpoint state
        restores it, so a replayed epoch regenerates the SAME seqs).
        Messages at/below the fence were already committed by the run
        that crashed after its commit — they are skipped, which is the
        whole exactly-once story for the mid-sink-flush kill window.
        Returns ``(appended, deduped)``."""
        with self._lock:
            _, fseq = self._fences.get(fence_id, (-1, -1))
            appended = deduped = 0
            for seq, topic, value, key, partition, ts in msgs:
                if seq <= fseq:
                    deduped += 1
                    continue
                self._append_locked(topic, value, key, partition, ts)
                self._fences[fence_id] = (epoch, seq)
                fseq = seq
                appended += 1
            return appended, deduped

    def fence(self, fence_id: str):
        """Last committed (epoch, seq) for a sink fence, or None."""
        with self._lock:
            return self._fences.get(fence_id)

    # -- clients -------------------------------------------------------------
    def producer(self) -> "InMemoryProducer":
        return InMemoryProducer(self)

    def consumer(self) -> "InMemoryConsumer":
        return InMemoryConsumer(self)


class _Group:
    def __init__(self) -> None:
        self.members: List["InMemoryConsumer"] = []
        # group-held read positions: (topic, partition) -> next offset
        self.positions: Dict[Tuple[str, int], int] = {}

    def rebalance(self, broker: InMemoryBroker) -> None:
        tps: List[Tuple[str, int]] = []
        topics = sorted({t for m in self.members for t in m._topics})
        for t in topics:
            for p in range(len(broker._topics.get(t, ()))):
                tps.append((t, p))
        for m in self.members:
            m._assignment = []
        for i, tp in enumerate(tps):
            owners = [m for m in self.members if tp[0] in m._topics]
            if owners:
                owners[i % len(owners)]._assignment.append(tp)


class InMemoryProducer(ProducerClient):
    def __init__(self, broker: InMemoryBroker) -> None:
        self._broker = broker
        self.produced = 0

    def produce(self, topic, value, key=None, partition=None,
                timestamp_usec=None):
        self._broker._append(topic, value, key, partition, timestamp_usec)
        self.produced += 1

    def fenced_commit(self, fence_id: str, epoch: int, msgs):
        """Exactly-once epoch commit (windflow_tpu_torch/durability): the
        broker appends + fence-advances atomically.  A producer
        without a fence makes the sink degrade to flush-per-epoch
        (at-least-once)."""
        appended, deduped = self._broker.fenced_commit(fence_id, epoch,
                                                       msgs)
        self.produced += appended
        return appended, deduped

    def flush(self) -> None:
        pass  # appends are synchronous

    def close(self) -> None:
        pass


class InMemoryConsumer(ConsumerClient):
    def __init__(self, broker: InMemoryBroker) -> None:
        self._broker = broker
        self._group: Optional[_Group] = None
        self._group_id: Optional[str] = None
        self._topics: List[str] = []
        self._assignment: List[Tuple[str, int]] = []
        self._next_part = 0
        self._closed = False

    def subscribe(self, topics, group_id, offsets=None):
        with self._broker._lock:
            self._topics = list(topics)
            self._group_id = group_id
            g = self._broker._groups.setdefault(group_id, _Group())
            self._group = g
            if self not in g.members:
                g.members.append(self)
            # explicit starting offsets: one per topic, -1 = keep current
            # (reference rebalance-callback offset override,
            # kafka_source.hpp:81-91)
            if offsets:
                for t, off in zip(topics, offsets):
                    if off is not None and off > -1:
                        for p in range(len(self._broker._topics.get(t, ()))):
                            g.positions[(t, p)] = off
            g.rebalance(self._broker)

    def poll(self, max_msgs: int) -> List[KafkaMessage]:
        if self._group is None:
            raise WindFlowError("poll before subscribe")
        out: List[KafkaMessage] = []
        with self._broker._lock:
            n_parts = len(self._assignment)
            for _ in range(n_parts):
                if len(out) >= max_msgs:
                    break
                tp = self._assignment[self._next_part % n_parts]
                self._next_part += 1
                t, p = tp
                log = self._broker._topics[t][p].log
                pos = self._group.positions.get(tp, 0)
                take = min(max_msgs - len(out), len(log) - pos)
                if take > 0:
                    out.extend(log[pos:pos + take])
                    self._group.positions[tp] = pos + take
        return out

    def positions(self):
        """Next-poll offset per assigned partition (group-held read
        positions) — the durability checkpoint's replay cursor."""
        with self._broker._lock:
            return {tp: self._group.positions.get(tp, 0)
                    for tp in self._assignment}

    def seek_positions(self, positions) -> None:
        """Restore path: rewind the GROUP's read positions to the
        checkpointed offsets.  Group-level on purpose — whichever
        replica a partition lands on after the restart resumes at the
        barrier's cursor, exactly as committed offsets behave on a real
        broker."""
        with self._broker._lock:
            self._group.positions.update(dict(positions))

    def idle_partitions(self):
        """Assigned partitions with nothing pending RIGHT NOW (consumer
        position at the log end) — the exact form of 'idle' the source's
        per-partition watermark fold wants (such a partition must not gate
        or pin event time).  Computed live under the broker lock, so a
        partition refilled since its last visit immediately resumes
        gating.  Real-client adapters return None (unknown) and the source
        falls back to wall-clock idleness."""
        out = set()
        with self._broker._lock:
            for tp in self._assignment:
                t, p = tp
                log = self._broker._topics[t][p].log
                if self._group.positions.get(tp, 0) >= len(log):
                    out.add(tp)
        return out

    def assignment(self) -> List[Tuple[str, int]]:
        return list(self._assignment)

    def close(self) -> None:
        if self._closed or self._group is None:
            return
        self._closed = True
        with self._broker._lock:
            self._group.members.remove(self)
            self._group.rebalance(self._broker)


# ---------------------------------------------------------------------------
# Real-client adapters (gated: confluent_kafka is an optional package).
# Exercised against a faked confluent_kafka module only; what a fake cannot
# show stays unverified against a live broker: the cooperative protocol's
# incremental on_assign, offset commit on revoke (librdkafka auto-commit),
# consumer-lag timing of the watermark grace path (idle_partitions() is
# None here), and broker-side errors other than a message's error().
# ---------------------------------------------------------------------------

def _require_confluent():
    try:
        import confluent_kafka  # noqa: F401
        return confluent_kafka
    except ImportError as e:
        raise WindFlowError(
            "connecting to a real Kafka broker requires the "
            "'confluent_kafka' package, which is not installed; pass an "
            "InMemoryBroker for in-process streaming") from e


class ConfluentConsumer(ConsumerClient):
    """Thin adapter over confluent_kafka.Consumer (librdkafka underneath —
    the same library the reference binds)."""

    def __init__(self, brokers: str,
                 assignment_policy: str = "cooperative-sticky") -> None:
        self._ck = _require_confluent()
        self._brokers = brokers
        self.assignment_policy = assignment_policy
        self._consumer = None
        self._consumed_tps = set()   # partitions that delivered data
        #: restore cursors awaiting assignment (seek_positions):
        #: librdkafka assignment materializes asynchronously through
        #: on_assign during later poll()s, so an immediate seek() right
        #: after subscribe() would hit unassigned partitions and raise —
        #: the cursors are applied in on_assign instead, exactly like
        #: the user start-offset path below
        self._pending_seek = {}

    def subscribe(self, topics, group_id, offsets=None):
        self._consumed_tps = set()   # scoped to this consumer session
        cooperative = self.assignment_policy == "cooperative-sticky"
        conf = {"bootstrap.servers": self._brokers,
                "group.id": group_id,
                "auto.offset.reset": "earliest",
                "partition.assignment.strategy": self.assignment_policy}
        self._consumer = self._ck.Consumer(conf)

        def on_assign(consumer, partitions):
            for part in partitions:
                tp = (part.topic, part.partition)
                # apply a start cursor only until the partition has
                # actually DELIVERED data (tracked in poll): an EAGER
                # rebalance re-delivers the full assignment, and
                # re-seeking a mid-stream partition would rewind it
                # into duplicates — but a partition revoked before
                # consuming anything must still get its cursor, not
                # auto.offset.reset.  Durability restore cursors
                # (seek_positions — exact per-partition offsets) take
                # precedence over the user's per-topic start offsets.
                if tp in self._consumed_tps:
                    continue
                seek = self._pending_seek.get(tp)
                if seek is not None:
                    part.offset = seek
                    continue
                if not offsets:
                    continue
                try:
                    off = offsets[topics.index(part.topic)]
                except (ValueError, IndexError):
                    continue
                if off is not None and off > -1:
                    part.offset = off
            # librdkafka requires incremental_assign under the
            # COOPERATIVE protocol and plain assign under EAGER
            # strategies (roundrobin/range)
            if cooperative:
                consumer.incremental_assign(partitions)
            else:
                consumer.assign(partitions)

        # the callback is always installed: restore cursors arrive via
        # seek_positions AFTER subscribe() but BEFORE the first poll —
        # the only point librdkafka lets them apply is on_assign
        self._consumer.subscribe(list(topics), on_assign=on_assign)

    def poll(self, max_msgs: int) -> List[KafkaMessage]:
        out = []
        for _ in range(max_msgs):
            msg = self._consumer.poll(0)
            if msg is None:
                break
            if msg.error():
                continue
            ts_type, ts_ms = msg.timestamp()
            self._consumed_tps.add((msg.topic(), msg.partition()))
            out.append(KafkaMessage(
                topic=msg.topic(), partition=msg.partition(),
                offset=msg.offset(), key=msg.key(), value=msg.value(),
                timestamp_usec=ts_ms * 1000 if ts_type else
                current_time_usecs()))
        return out

    def assignment(self):
        return [(p.topic, p.partition)
                for p in self._consumer.assignment()]

    def positions(self):
        """Durability checkpoint cursor via librdkafka position() — the
        next offset to be fetched per assigned partition.  Every
        assigned partition gets a cursor: a never-fetched partition
        reports OFFSET_INVALID and falls back to the group's committed
        offset (then to 0 = earliest, matching auto.offset.reset) —
        omitting it would let the group's auto-commit advance it past
        the barrier and the restore skip unreplayed records.
        Unverified against a live broker (see the adapter notes
        above)."""
        try:
            parts = self._consumer.assignment()
            out = {}
            missing = []
            for p in self._consumer.position(parts):
                if p.offset is not None and p.offset >= 0:
                    out[(p.topic, p.partition)] = p.offset
                else:
                    missing.append(p)
            if missing:
                for p in self._consumer.committed(missing, timeout=5):
                    off = p.offset if p.offset is not None \
                        and p.offset >= 0 else 0
                    out[(p.topic, p.partition)] = off
            return out
        except Exception:  # lint: broad-except-ok (a position probe must
            # degrade to "unknown" — the checkpoint then records no
            # cursor and restore falls back to the per-topic offsets)
            return None

    def seek_positions(self, positions) -> None:
        """Restore path: stage the checkpointed per-partition cursors
        for ``subscribe``'s on_assign callback — assignment does not
        exist yet when the source calls this (right after subscribe),
        so an immediate ``seek()`` would raise on every partition;
        partitions already assigned (a later re-seek) ARE sought
        directly.  Unverified against a live broker (see the adapter
        notes above)."""
        self._pending_seek.update(dict(positions))
        TopicPartition = self._ck.TopicPartition
        try:
            assigned = {(p.topic, p.partition)
                        for p in self._consumer.assignment()}
        except Exception:  # lint: broad-except-ok (no assignment yet —
            # the normal restore case; on_assign applies the cursors)
            return
        for (topic, part), off in dict(positions).items():
            if (topic, part) in assigned:
                self._consumer.seek(TopicPartition(topic, part, off))

    def close(self):
        if self._consumer is not None:
            self._consumer.close()


class ConfluentProducer(ProducerClient):
    def __init__(self, brokers: str) -> None:
        self._ck = _require_confluent()
        self._producer = self._ck.Producer({"bootstrap.servers": brokers})

    def produce(self, topic, value, key=None, partition=None,
                timestamp_usec=None):
        kwargs = {}
        if partition is not None:
            kwargs["partition"] = partition
        if timestamp_usec is not None:
            kwargs["timestamp"] = timestamp_usec // 1000
        while True:
            try:
                self._producer.produce(topic, value=value, key=key, **kwargs)
                break
            except BufferError:
                # librdkafka's delivery queue is full: service callbacks
                # until there is room (sustained backpressure can take
                # several poll rounds)
                self._producer.poll(1.0)
        self._producer.poll(0)  # service delivery callbacks as we go

    def flush(self):
        self._producer.flush()

    def close(self):
        self.flush()


def make_consumer(brokers,
                  assignment_policy: str = "cooperative-sticky") \
        -> ConsumerClient:
    if isinstance(brokers, InMemoryBroker):
        c = brokers.consumer()
        # the in-memory broker's single cooperative round-robin assignment
        # serves every strategy; record the choice for introspection
        c.assignment_policy = assignment_policy
        return c
    return ConfluentConsumer(str(brokers), assignment_policy)


def make_producer(brokers) -> ProducerClient:
    if isinstance(brokers, InMemoryBroker):
        return brokers.producer()
    return ConfluentProducer(str(brokers))
