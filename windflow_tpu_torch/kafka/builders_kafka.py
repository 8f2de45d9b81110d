"""Fluent builders for the Kafka operators (the port of
``windflow_tpu/kafka/builders_kafka.py``; reference
``builders_kafka.hpp:128,293``): brokers, topics,
per-topic starting offsets, consumer group id and idleness for the source;
brokers for the sink."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.graph.builders import _BuilderBase
from windflow_tpu_torch.kafka.kafka_sink import KafkaSink
from windflow_tpu_torch.kafka.kafka_source import KafkaSource


class KafkaSource_Builder(_BuilderBase):
    _default_name = "kafka_source"

    def __init__(self, deser_fn: Callable) -> None:
        super().__init__()
        self._deser_fn = deser_fn
        self._brokers = None
        self._topics: list = []
        self._group_id = "windflow"
        self._offsets: Optional[list] = None
        self._idle_usec = 100_000
        self._assignment_policy = "cooperative-sticky"

    def withBrokers(self, brokers):
        """A broker address string ('host:port') or an InMemoryBroker."""
        self._brokers = brokers
        return self

    def withTopics(self, *topics: str):
        self._topics = list(topics)
        return self

    def withGroupID(self, group_id: str):
        self._group_id = group_id
        return self

    def withOffsets(self, offsets: Sequence[int]):
        """Starting offset per topic; -1 keeps the group's current position
        (reference rebalance-callback offset override)."""
        self._offsets = list(offsets)
        return self

    def withIdleness(self, idle_usec: int):
        self._idle_usec = int(idle_usec)
        return self

    def withAssignmentPolicy(self, policy: str):
        """Partition assignment strategy (reference withAssignmentPolicy,
        ``builders_kafka.hpp``): one of "cooperative-sticky" (default),
        "roundrobin", "range"; the in-memory broker's single cooperative
        round-robin assignment serves all three."""
        self._assignment_policy = policy
        return self

    def withKeyBy(self, *_):
        raise WindFlowError("a Kafka_Source has no input to key by")

    def withKafkaClosingFunction(self, fn: Callable):
        """Reference-named alias of withClosingFunction
        (``builders_kafka.hpp`` withKafkaClosingFunction): Kafka replicas
        own a KafkaRuntimeContext, so ``fn(ctx)`` receives it directly."""
        return self.withClosingFunction(fn)

    def build(self) -> KafkaSource:
        if self._brokers is None:
            raise WindFlowError("Kafka_Source needs withBrokers(...)")
        return KafkaSource(self._deser_fn, self._brokers, self._topics,
                           group_id=self._group_id, offsets=self._offsets,
                           idle_time_usec=self._idle_usec,
                           assignment_policy=self._assignment_policy,
                           name=self._name,
                           parallelism=self._parallelism,
                           output_batch_size=self._output_batch_size)


class KafkaSink_Builder(_BuilderBase):
    _default_name = "kafka_sink"

    def __init__(self, ser_fn: Callable) -> None:
        super().__init__()
        self._ser_fn = ser_fn
        self._brokers = None

    def withBrokers(self, brokers):
        self._brokers = brokers
        return self

    def withOutputBatchSize(self, *_):
        raise WindFlowError("a Kafka_Sink has no output to batch")

    def withKafkaClosingFunction(self, fn: Callable):
        """Reference-named alias of withClosingFunction (see
        KafkaSource_Builder.withKafkaClosingFunction)."""
        return self.withClosingFunction(fn)

    def build(self) -> KafkaSink:
        if self._brokers is None:
            raise WindFlowError("Kafka_Sink needs withBrokers(...)")
        return KafkaSink(self._ser_fn, self._brokers, name=self._name,
                         parallelism=self._parallelism,
                         key_extractor=self._key_extractor)
