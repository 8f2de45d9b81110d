"""KafkaRuntimeContext (the port of ``windflow_tpu/kafka/kafka_context.py``;
reference ``kafka_context.hpp:58``): the plain RuntimeContext plus access
to the replica's Kafka client, so riched deserializers/serializers can
commit, inspect assignment, or produce side-channel messages."""

from __future__ import annotations

from typing import Optional

from windflow_tpu_torch.context import RuntimeContext
from windflow_tpu_torch.kafka.client import ConsumerClient, ProducerClient


class KafkaRuntimeContext(RuntimeContext):
    def __init__(self, parallelism: int, replica_index: int,
                 operator_name: str = "",
                 consumer: Optional[ConsumerClient] = None,
                 producer: Optional[ProducerClient] = None) -> None:
        super().__init__(parallelism, replica_index, operator_name)
        self._consumer = consumer
        self._producer = producer

    @property
    def consumer(self) -> Optional[ConsumerClient]:
        return self._consumer

    @property
    def producer(self) -> Optional[ProducerClient]:
        return self._producer
