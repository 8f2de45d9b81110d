"""FrameSource: bulk binary/CSV ingestion into columns (the port of
``windflow_tpu/io/frames.py``).

Instead of one Python object per tuple, the source pulls **byte chunks**
from the user, parses them to columns in C++ (``native/wf_host.cpp``
``wf_parse_frames`` / ``wf_parse_csv``; the numpy parsers of
``io/parse.py`` when the native library is off) and hands whole columns
to the staging emitter (``DeviceStageEmitter.emit_columns``), so a batch
travels from bytes to the card's memory with no per-tuple Python work.
A tick's host spans (``monitoring/recorder.span``): ``wf:source.fetch``
(the user's iterator), ``wf:source.parse`` (the carry and the parse),
``wf:source.columns`` (frontier, key lane, value casts) and
``wf:stage.pack`` (the staging emitter, a megastep group's run included).

Record wire format (``fmt="frames"``): little-endian ``int64 key, int64
ts, nv × float64 values``.  CSV (``fmt="csv"``): ``key,ts,v0[,v1...]``
lines.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import numpy as np

from windflow_tpu_torch import native
from windflow_tpu_torch.basic import (RoutingMode, TimePolicy, WindFlowError,
                                      current_time_usecs)
from windflow_tpu_torch.meta import adapt
from windflow_tpu_torch.monitoring.recorder import span
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.source import BaseSourceReplica, Source


class FrameSourceReplica(BaseSourceReplica):
    def __init__(self, op: "FrameSource", index: int) -> None:
        super().__init__(op, index)
        self._chunks = None
        self._carry = b""

    def start(self) -> None:
        self._chunks = iter(self.op.chunks_fn(self.context))

    def tick(self, max_items: int) -> bool:
        """Parse and emit one chunk (``max_items`` is a per-record notion;
        a bulk source's quantum is the user's chunk)."""
        if self._exhausted:
            return False
        try:
            with span("wf:source.fetch"):
                chunk = next(self._chunks)
        except StopIteration:
            self._flush_carry()
            self._exhausted = True
            self._terminate()
            return True
        self._ingest(chunk)
        return True

    def _flush_carry(self) -> None:
        if self._carry:
            if self.op.fmt == "csv" and not self._carry.endswith(b"\n"):
                # a file without a trailing newline still ends in a
                # complete record; an unterminated frame is partial
                self._carry += b"\n"
            self._ingest(b"", final=True)

    def _ingest(self, chunk: bytes, final: bool = False) -> None:
        """Parse the carried partial record and ``chunk``, then stage the
        records' columns; a partial record at the end is carried."""
        nv = self.op.nv
        parser = native.parse_frames if self.op.fmt == "frames" \
            else native.parse_csv
        with span("wf:source.parse"):
            buf = self._carry + chunk
            keys, tss, vals, consumed = parser(buf, nv)
            self._carry = b"" if final else buf[consumed:]
        n = len(keys)
        if n == 0:
            return
        with span("wf:source.columns"):
            if self.time_policy == TimePolicy.INGRESS:
                # the chunk's records arrived with it: one arrival stamp,
                # monotone against earlier chunks
                base = max(current_time_usecs(), self._last_ts)
                tss = np.full(n, base, dtype=np.int64)
                row_wms = tss
            else:
                # per-row frontier: the running max event ts, so the
                # staging emitter can stamp batches that split this chunk
                # exactly
                row_wms = np.maximum(np.maximum.accumulate(tss),
                                     max(self._last_ts, 0))
            self._last_ts = max(self._last_ts, int(tss.max()))
            self._advance_wm(self._last_ts)
            self.stats.outputs_sent += n
            # int32 key lanes when the keys fit (the JAX package's rule,
            # kept as is so both packages stage the same dtypes); wider
            # keys keep int64
            keys = keys.astype(np.int64)
            if len(keys) and np.int32(keys.max() >> 31) \
                    == (keys.min() >> 31) \
                    and -(1 << 31) <= keys.min() and keys.max() < (1 << 31):
                keys = keys.astype(np.int32)
            cols = {"key": keys}
            vd = self.op.value_dtype
            for i, name in enumerate(self.op.fields):
                cols[name] = np.ascontiguousarray(
                    vals[:, i].astype(vd, copy=False))
        with span("wf:stage.pack"):
            self.emitter.emit_columns(cols, tss, self.current_wm,
                                      row_wms=row_wms)
        self._count_toward_punctuation(n)


class FrameSource(Source):
    """Bulk source over a byte-chunk generator.

    ``chunks_fn`` (optionally taking a RuntimeContext) yields ``bytes``;
    records may span chunk boundaries (the remainder is carried).
    ``fields`` names the ``nv`` value columns; records surface downstream
    as ``{"key": int, <field>: float, ...}``.  Value columns stage as
    ``value_dtype``, float32 by default (half the bytes of the float64
    wire values); keys stage as int32 when they fit, int64 otherwise."""

    replica_class = FrameSourceReplica

    def __init__(self, chunks_fn: Callable[..., Iterable[bytes]],
                 nv: int = 1, fields: Optional[List[str]] = None,
                 fmt: str = "frames", name: str = "frame_source",
                 parallelism: int = 1, output_batch_size: int = 0,
                 value_dtype=np.float32, record_spec=None) -> None:
        if fmt not in ("frames", "csv"):
            raise WindFlowError(f"unknown frame format '{fmt}'")
        if fields is not None and len(fields) != nv:
            raise WindFlowError("fields must name all nv value columns")
        Operator.__init__(self, name, parallelism, routing=RoutingMode.NONE,
                          output_batch_size=output_batch_size)
        self.chunks_fn = adapt(chunks_fn, 0)
        self.nv = nv
        self.fields = fields or [f"v{i}" for i in range(nv)]
        self.fmt = fmt
        self.value_dtype = np.dtype(value_dtype)
        self.ts_extractor = None
        self.record_spec = record_spec
