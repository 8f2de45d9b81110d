"""Source operator (the port of ``windflow_tpu/ops/source.py``; reference
``source.hpp:55-309``).  A source replica is *pulled* by the host scheduler:
the user's generator yields records, each scheduler tick pulls a bounded
chunk.  INGRESS stamps arrival time, EVENT uses a timestamp extractor;
watermarks are the monotone max of assigned timestamps.  The bulk sources
of ``windflow_tpu_torch/io`` share :class:`BaseSourceReplica`."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

from windflow_tpu_torch.basic import (RoutingMode, TimePolicy, WindFlowError,
                                      current_time_usecs)
from windflow_tpu_torch.batch import WM_NONE
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.ops.base import Operator, Replica


class BaseSourceReplica(Replica):
    """Shared source-replica mechanics: monotone timestamps
    (``_last_ts``), the end-of-stream flag, and the punctuation cadence
    (reference ``basic.hpp:189-206``, ``forward_emitter.hpp:226-262``):
    every ``punctuation_interval_usec`` of wall clock, or every
    ``punctuation_amount`` tuples when that is > 0."""

    #: a source's own span is its tick (``PipeGraph._tick``)
    span_kind = "tick"

    def __init__(self, op: Operator, index: int) -> None:
        super().__init__(op, index)
        self._tid_seq = 0
        self._last_ts = WM_NONE
        self._exhausted = False
        self._since_punct = 0
        self._last_punct_usec = current_time_usecs()

    @property
    def exhausted(self) -> bool:
        return self._exhausted

    def maybe_punctuate(self, now_usec: Optional[int] = None) -> None:
        """Emit a watermark punctuation if the cadence interval elapsed
        (reference ``forward_emitter.hpp:226-262``)."""
        if self._exhausted:
            return
        now = now_usec if now_usec is not None else current_time_usecs()
        if now - self._last_punct_usec >= self.config.punctuation_interval_usec:
            self.punctuate(now)

    def punctuate(self, now_usec: Optional[int] = None) -> None:
        now = now_usec if now_usec is not None else current_time_usecs()
        if self.time_policy == TimePolicy.INGRESS:
            self._advance_wm(now)
            self._last_ts = max(self._last_ts, now)
        if self.current_wm == WM_NONE:
            return
        self._since_punct = 0
        self._last_punct_usec = now
        self.emitter.propagate_punctuation(self.current_wm)

    def _count_toward_punctuation(self, n: int) -> None:
        amount = self.config.punctuation_amount
        if amount <= 0:
            return
        self._since_punct += n
        if self._since_punct >= amount:
            self.punctuate()


class SourceReplica(BaseSourceReplica):
    def __init__(self, op: "Source", index: int) -> None:
        super().__init__(op, index)
        self._iter = None

    def start(self) -> None:
        iterable = adapt(self.op.gen_fn, 0)(self.context)
        if iterable is None:
            raise WindFlowError(
                f"source '{self.op.name}' generator returned None")
        self._iter = iter(iterable)

    def tick(self, max_items: int) -> bool:
        """Pull up to ``max_items`` tuples; True on any progress."""
        if self._exhausted:
            return False
        if self._iter is None:
            raise WindFlowError(f"source '{self.op.name}' not started")
        produced = 0
        while produced < max_items:
            try:
                item = next(self._iter)
            except StopIteration:
                self._exhausted = True
                self._terminate()
                return True
            if item is None:
                return True         # idle yield: the source is live
            ts = self._assign_ts(item)
            self._advance_wm(ts)
            self.stats.outputs_sent += 1
            self._tid_seq += 1
            self.emitter.emit(item, ts, self.current_wm,
                              tid=(self.op.ordinal, self.index,
                                   self._tid_seq))
            produced += 1
            self._count_toward_punctuation(1)
        return produced > 0

    def _assign_ts(self, item: Any) -> int:
        if self.time_policy == TimePolicy.EVENT:
            if self.op.ts_extractor is None:
                raise WindFlowError(
                    f"source '{self.op.name}': EVENT time policy requires a "
                    "timestamp extractor")
            ts = int(self.op.ts_extractor(item))
        else:
            ts = current_time_usecs()
            if ts <= self._last_ts:
                ts = self._last_ts + 1
        self._last_ts = max(self._last_ts, ts)
        return ts


class Source(Operator):
    replica_class = SourceReplica

    def __init__(self, gen_fn: Callable[..., Iterable], name: str = "source",
                 parallelism: int = 1, output_batch_size: int = 0,
                 ts_extractor: Optional[Callable[[Any], int]] = None,
                 record_spec: Optional[Any] = None) -> None:
        super().__init__(name, parallelism, routing=RoutingMode.NONE,
                         output_batch_size=output_batch_size)
        self.gen_fn = gen_fn
        self.ts_extractor = ts_extractor
        #: an example record declaring the source's lanes: the
        #: preflight spec walk's input, and the wire plane's
        self.record_spec = record_spec
