"""Kafka integration (the port of ``windflow_tpu/kafka``; reference
``wf/kafka/``): Kafka_Source / Kafka_Sink operators, KafkaRuntimeContext,
fluent builders, and the in-memory client layer (topics, partitions,
consumer groups, the exactly-once sink fence)."""

from windflow_tpu_torch.kafka.builders_kafka import (KafkaSink_Builder,
                                                     KafkaSource_Builder)
from windflow_tpu_torch.kafka.client import (ConsumerClient, InMemoryBroker,
                                             KafkaMessage, ProducerClient)
from windflow_tpu_torch.kafka.kafka_context import KafkaRuntimeContext
from windflow_tpu_torch.kafka.kafka_sink import KafkaSink, KafkaSinkMessage
from windflow_tpu_torch.kafka.kafka_source import KafkaSource
