"""Kafka_Sink operator (the port of ``windflow_tpu/kafka/kafka_sink.py``;
reference ``kafka_sink.hpp:71,229``): terminal operator producing each
tuple to Kafka through a per-replica producer
(``kafka_sink.hpp:86,123-132``).

The user serializer runs per tuple:
``fn(item[, kafka_ctx]) -> KafkaSinkMessage | None`` — ``None`` drops the
tuple (produces nothing); otherwise the returned message names the topic,
payload and optional partition/key (reference serializer returns
topic+payload, ``kafka_sink.hpp:179-182``).  The producer is flushed at EOS.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.kafka.client import make_producer
from windflow_tpu_torch.kafka.kafka_context import KafkaRuntimeContext
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


@dataclasses.dataclass
class KafkaSinkMessage:
    """What the serializer returns (reference ``wf_kafka_sink_msg``)."""
    topic: str
    payload: Any
    partition: Optional[int] = None
    key: Optional[bytes] = None


class KafkaSinkReplica(Replica):
    def __init__(self, op: "KafkaSink", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.ser_fn, 1)
        self._producer = make_producer(op.brokers)
        self.context = KafkaRuntimeContext(
            op.parallelism, index, op.name, producer=self._producer)
        # exactly-once plumbing (windflow_tpu_torch/durability): with the
        # durability plane active, serialized messages BUFFER per epoch
        # and publish atomically at the checkpoint barrier through the
        # broker fence, deduped on the replica-lifetime sequence number
        # (the checkpoint restores `_seq`, so replay regenerates the
        # same seqs and already-committed messages skip).  Without the
        # plane every produce ships immediately, as before.
        self._durable = False       # set by the plane at graph build
        self._fence_id = None
        self._pending = []          # [(seq, topic, value, key, part, ts)]
        self._seq = 0               # lifetime serialized-message count
        self._epoch = 0             # epoch currently buffering
        self._dedupe_hits = 0
        # EOS fence: once on_eos flushed, the producer's output is final
        # — a straggler produce would either silently vanish into the
        # closed producer (the pre-fence latent drop) or duplicate after
        # a restore that replays past EOS; fail loudly instead
        self._fenced = False

    def process_single(self, item, ts, wm):
        msg = self._fn(item, self.context)
        if msg is None:
            return
        if self._fenced:
            raise WindFlowError(
                f"Kafka sink '{self.op.name}' received a tuple after its "
                "EOS flush-and-fence — the produce would race the "
                "producer teardown and be silently dropped")
        self.stats.outputs_sent += 1
        if self._durable:
            self._seq += 1
            self._pending.append((self._seq, msg.topic, msg.payload,
                                  msg.key, msg.partition, ts))
            return
        self._producer.produce(msg.topic, msg.payload, key=msg.key,
                               partition=msg.partition,
                               timestamp_usec=ts)

    # -- durability-plane hooks ----------------------------------------------
    def commit_epoch(self, epoch: int) -> None:
        """Publish the epoch's buffered messages atomically.  Brokers
        with a fence (InMemoryBroker) dedupe on the lifetime seq —
        exactly-once across restore even when the kill lands between the
        sink commit and the checkpoint manifest; fence-less producers
        degrade to produce+flush per epoch (at-least-once)."""
        msgs, self._pending = self._pending, []
        fc = getattr(self._producer, "fenced_commit", None)
        if fc is not None:
            _, deduped = fc(self._fence_id, epoch, msgs)
            self._dedupe_hits += deduped
        else:
            for _, topic, value, key, partition, ts in msgs:
                self._producer.produce(topic, value, key=key,
                                       partition=partition,
                                       timestamp_usec=ts)
            self._producer.flush()
        self._epoch = epoch + 1

    def on_eos(self):
        # flush-AND-fence: the final epoch's buffered messages commit
        # through the same fence as barrier commits (restore after a
        # clean EOS replays nothing), the producer drains its in-flight
        # queue, and the fence flag turns any straggler produce into a
        # loud error instead of a silent drop.  The closing function
        # (reference kafka_closing_func) still runs after on_eos with
        # the producer usable for final side-channel messages;
        # _terminate below closes it afterwards.
        if self._durable:
            self.commit_epoch(self._epoch)
        self._producer.flush()
        self._fenced = True

    def _terminate(self):
        was_done = self.done
        super()._terminate()   # on_eos flush-and-fence → closing_func
        if not was_done:
            self._producer.flush()
            self._producer.close()


class KafkaSink(Operator):
    replica_class = KafkaSinkReplica
    is_terminal = True

    def __init__(self, ser_fn: Callable, brokers,
                 name: str = "kafka_sink", parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None) -> None:
        super().__init__(name, parallelism, routing=routing,
                         key_extractor=key_extractor)
        self.ser_fn = ser_fn
        self.brokers = brokers
