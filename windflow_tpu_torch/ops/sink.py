"""Sink operator (the port of ``windflow_tpu/ops/sink.py``; reference
``sink.hpp:56-``): the user function receives each tuple, and ``None``
once at end-of-stream.  Columnar mode (``withColumnarSink``) delivers one
:class:`SinkColumns` per device batch instead of per-record dicts.  A
device batch's host spans: ``wf:egress`` (the device-to-host copy) and
``wf:sink`` (the user's function)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from windflow_tpu_torch.basic import RoutingMode
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.monitoring.recorder import span
from windflow_tpu_torch.ops.base import Operator, Replica


@dataclasses.dataclass
class SinkColumns:
    """One device batch delivered columnar: ``cols`` mirrors the payload
    pytree with ``[n]``-leading numpy arrays; ``tss`` is int64 ``[n]``."""

    cols: Any
    tss: Any
    watermark: int

    def __len__(self) -> int:
        return len(self.tss)


class SinkReplica(Replica):
    def __init__(self, op: "Sink", index: int) -> None:
        super().__init__(op, index)
        self._fn = adapt(op.fn, 1)
        self._pending = []          # deferred device batches (columnar)

    def process_single(self, item, ts, wm):
        self._fn(item, self.context)

    def process_device_batch(self, batch):
        from windflow_tpu_torch.batch import transfer_nbytes
        self.stats.d2h_bytes += transfer_nbytes(batch)
        if self.op.columnar:
            # hold the last ``defer`` batches: the copy of batch i then
            # overlaps the device work of later batches
            self._pending.append(batch)
            if len(self._pending) > self.op.columnar_defer:
                pend, self._pending = self._pending, []
                self._deliver_columns(pend)
            return
        from windflow_tpu_torch.batch import device_to_host
        with span("wf:egress"):
            hb = device_to_host(batch)
        with span("wf:sink"):
            for item, ts in zip(hb.items, hb.tss):
                self.context._set_context(ts, batch.watermark)
                self._fn(item, self.context)

    def _deliver_columns(self, batches):
        from windflow_tpu_torch.batch import device_to_columns_multi
        with span("wf:egress"):
            got = device_to_columns_multi(batches)
        with span("wf:sink"):
            for b, (cols, tss) in zip(batches, got):
                if len(tss):
                    self.context._set_context(int(tss[-1]), b.watermark)
                    self._fn(SinkColumns(cols, tss, b.watermark),
                             self.context)

    def on_eos(self):
        if self._pending:
            self._deliver_columns(self._pending)
            self._pending = []
        self._fn(None, self.context)


class Sink(Operator):
    replica_class = SinkReplica
    is_terminal = True

    def __init__(self, fn: Callable[[Optional[Any]], None], name: str = "sink",
                 parallelism: int = 1,
                 routing: RoutingMode = RoutingMode.FORWARD,
                 key_extractor=None, columnar: bool = False,
                 columnar_defer: int = 2) -> None:
        super().__init__(name, parallelism, routing=routing,
                         key_extractor=key_extractor)
        self.fn = fn
        self.columnar = columnar
        self.columnar_defer = max(0, columnar_defer)
