"""Emitters: output routing per edge (the port of the classes of
``windflow_tpu/parallel/emitters.py`` that the count-window path creates).

* :class:`ForwardEmitter` — host tuples round-robin, batched per
  destination (reference ``forward_emitter.hpp``).
* :class:`DeviceStageEmitter` — host→device boundary: accumulates records
  into one packed staging buffer of fixed capacity and ships it with one
  copy (reference ``Forward_Emitter_GPU``); bulk sources hand it whole
  columns (``emit_columns``), which stream into pooled staging buffers
  with no per-tuple work.
* :class:`DevicePassEmitter` — device→device edge: batches move by handle.
* :class:`DeviceToHostEmitter` — device→host boundary: one packed copy
  back, then the whole HostBatch goes to an inner host emitter.

Keyed routing to several replicas (``KeyedDeviceStageEmitter``,
``DeviceKeyByEmitter``, ``KeyByEmitter``) and broadcast are not ported
yet; :func:`create_emitter` names a keyed multi-replica edge instead of
mis-routing it.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np

from windflow_tpu_torch import staging
from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.batch import (DeviceBatch, HostBatch, Punctuation,
                                      WM_NONE, columns_to_device,
                                      device_to_host, host_to_device,
                                      stage_packed, transfer_nbytes)
from windflow_tpu_torch.utils.tree import tree_flatten


class Emitter:
    """Base emitter: owns destination inboxes and per-destination channel
    ids (reference ``Basic_Emitter``)."""

    def __init__(self, dests: Sequence[Tuple[Any, int]],
                 output_batch_size: int) -> None:
        self.dests = list(dests)
        self.output_batch_size = output_batch_size
        #: the owning replica's stats record (transfer byte counters),
        #: bound by PipeGraph._build
        self.stats = None

    def bind_stats(self, stats) -> None:
        self.stats = stats

    def emit(self, item: Any, ts: int, wm: int,
             shared: bool = False, tid=None) -> None:
        raise NotImplementedError

    def emit_device_batch(self, batch: DeviceBatch) -> None:
        raise NotImplementedError

    def emit_host_batch(self, hb: HostBatch) -> None:
        """Route a whole HostBatch downstream (per tuple by default)."""
        for item, ts, tid in zip(hb.items, hb.tss, hb.ids_or_nones()):
            self.emit(item, ts, hb.watermark, hb.shared, tid=tid)

    def emit_columns(self, cols, tss, wm: int, row_wms=None) -> None:
        """Emit a block of tuples given as SoA numpy columns.  ``wm`` is
        the frontier after the block's LAST row; ``row_wms`` (int64 [n],
        optional) the frontier after EACH row.  Host destinations take
        records, so the default explodes the block into per-tuple emits;
        the device staging emitter overrides it with a columnar route."""
        names = list(cols)
        arrs = [cols[n] for n in names]
        for i in range(len(tss)):
            item = {n: a[i].item() for n, a in zip(names, arrs)}
            self.emit(item, int(tss[i]),
                      int(row_wms[i]) if row_wms is not None else wm)

    def propagate_punctuation(self, wm: int) -> None:
        """Flush open batches, then multicast a watermark punctuation."""
        self.flush(wm)
        for replica, ch in self.dests:
            replica.receive(ch, Punctuation(wm))

    def flush(self, wm: int) -> None:
        """Send any partially-filled batches downstream."""

    def _send(self, dest_idx: int, msg) -> None:
        replica, ch = self.dests[dest_idx]
        replica.receive(ch, msg)


class _OpenBatch:
    """Accumulates tuples for one destination; the watermark folds the
    MINIMUM frontier (reference ``Batch_CPU_t::addTuple``)."""

    __slots__ = ("items", "tss", "wm", "shared", "tids", "any_tid")

    def __init__(self):
        self.items: list = []
        self.tss: list = []
        self.wm: int = WM_NONE
        self.shared: bool = False
        self.tids: list = []
        self.any_tid: bool = False

    def add(self, item, ts, wm, shared=False, tid=None):
        self.items.append(item)
        self.tss.append(ts)
        self.tids.append(tid)
        self.any_tid |= tid is not None
        self.shared |= shared
        if wm != WM_NONE:
            self.wm = wm if self.wm == WM_NONE else min(self.wm, wm)

    def ids_or_none(self):
        return self.tids if self.any_tid else None


class ForwardEmitter(Emitter):
    """FORWARD / REBALANCING routing of host tuples: round-robin over
    destinations, per-destination batches of ``output_batch_size``."""

    def __init__(self, dests, output_batch_size):
        super().__init__(dests, output_batch_size)
        self._open = [_OpenBatch() for _ in dests]
        self._next = 0

    def emit(self, item, ts, wm, shared=False, tid=None):
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        ob = self._open[d]
        ob.add(item, ts, wm, shared, tid)
        if len(ob.items) >= max(1, self.output_batch_size):
            self._flush_dest(d)

    def _flush_dest(self, d):
        ob = self._open[d]
        if ob.items:
            self._send(d, HostBatch(ob.items, ob.tss, ob.wm,
                                    shared=ob.shared,
                                    ids=ob.ids_or_none()))
            self._open[d] = _OpenBatch()

    def emit_host_batch(self, hb):
        # batch-granular round-robin; the destination's open batch goes
        # first so per-destination arrival order is preserved
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._flush_dest(d)
        self._send(d, hb)

    def flush(self, wm):
        for d in range(len(self.dests)):
            self._flush_dest(d)


def _concat(arrs):
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


class DeviceStageEmitter(Emitter):
    """Host→device boundary: stages DeviceBatches of fixed capacity
    ``output_batch_size`` onto ``device`` and round-robins destinations.
    The fixed capacity keeps every staged batch at one shape.

    * Records (``emit``) accumulate in an open batch, which ships with ONE
      packed copy (``batch.host_to_device``); its data timestamp extrema
      ride on the batch (``DeviceBatch.ts_min``/``ts_max``).
    * Columns (``emit_columns``) of packable 1-D lanes stream straight
      into a pooled (pinned, for the card) staging buffer at their final
      packed offsets (``staging.PackedBatchBuilder``); a full buffer ships
      as one non-blocking copy (``batch.stage_packed``).  Other lanes
      accumulate as chunks and ship through ``batch.columns_to_device``.

    Watermark lane: a chunk-level ``wm`` is valid only after the chunk's
    LAST row, so a batch that splits a chunk is stamped with the running
    row frontier at ITS last row (``row_wms`` when the source gives it).
    ``flush`` ships the open columnar builder, then the buffered chunks,
    then the record path's open batch.  ``packed_batches``,
    ``chunked_batches`` and ``record_batches`` count what each route
    staged."""

    def __init__(self, dests, output_batch_size, device):
        if output_batch_size <= 0:
            # reference multipipe.hpp:441-444
            raise WindFlowError(
                "a GPU operator requires the upstream operator to set an "
                "output batch size > 0")
        super().__init__(dests, output_batch_size)
        self.device = device
        self._ob = _OpenBatch()
        self._next = 0
        #: newest watermark seen (monotone): staged batches carry it as
        #: DeviceBatch.frontier
        self._frontier = WM_NONE
        # chunk route: (cols, tss, per-row frontier) chunks and their rows
        self._col_chunks = []
        self._col_rows = 0
        # packed route: the open builder, its lane structure, the running
        # row-frontier max and the open batch's data-ts extrema
        self._builder = None
        self._b_dtypes = None
        self._b_treedef = None
        self._b_wm = WM_NONE
        self._b_ts_min = None
        self._b_ts_max = None
        self.packed_batches = 0
        self.chunked_batches = 0
        self.record_batches = 0

    def _advance_frontier(self, wm):
        if wm != WM_NONE and wm > self._frontier:
            self._frontier = wm

    def _ship(self, db):
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._send(d, db)

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._advance_frontier(wm)
        self._ob.add(item, ts, wm)
        if len(self._ob.items) >= self.output_batch_size:
            self.flush(wm)

    def emit_columns(self, cols, tss, wm, row_wms=None):
        """Columnar route: packable 1-D lanes stream into the packed
        builder; anything else (or anything after a chunk is buffered)
        takes the chunk-accumulate route, after the open builder ships, so
        arrival order is kept."""
        if not self._col_chunks:
            leaves, treedef = tree_flatten(
                {nm: np.asarray(a) for nm, a in cols.items()})
            if all(l.ndim == 1 and staging.packable_dtype(l.dtype)
                   for l in leaves):
                self._emit_columns_packed(leaves, treedef, tss, wm, row_wms)
                return
        if self._builder is not None:
            self._finalize_builder()
        self._emit_columns_chunked(cols, tss, wm, row_wms)

    def _emit_columns_packed(self, leaves, treedef, tss, wm, row_wms):
        tss = np.ascontiguousarray(tss, np.int64)
        dtypes = tuple(str(l.dtype) for l in leaves)
        if self._builder is not None and (treedef != self._b_treedef
                                          or dtypes != self._b_dtypes):
            self._finalize_builder()    # lane structure changed
        m = len(tss)
        pos = 0
        while pos < m:
            if self._builder is None:
                self._b_treedef = treedef
                self._b_dtypes = dtypes
                self._builder = staging.PackedBatchBuilder(
                    dtypes, self.output_batch_size,
                    pool=staging.pool_for(self.device))
                self._b_ts_min = None
                self._b_ts_max = None
            take = min(self._builder.room, m - pos)
            sl = slice(pos, pos + take)
            tsl = tss[sl]
            self._builder.append([l[sl] for l in leaves], tsl)
            lo, hi = int(tsl.min()), int(tsl.max())
            if self._b_ts_min is None or lo < self._b_ts_min:
                self._b_ts_min = lo
            if self._b_ts_max is None or hi > self._b_ts_max:
                self._b_ts_max = hi
            if row_wms is not None:
                w = int(np.max(row_wms[sl]))
                if w != WM_NONE and w > self._b_wm:
                    self._b_wm = w
            elif pos + take == m and wm != WM_NONE and wm > self._b_wm:
                # a chunk-level wm is valid only after the chunk's last row
                self._b_wm = wm
            pos += take
            if self._builder.room == 0:
                self._finalize_builder()

    def _finalize_builder(self, fallback_wm: int = WM_NONE) -> None:
        """Ship the open packed batch: one non-blocking copy; the pooled
        buffer is recycled behind the copy's event (``stage_packed``)."""
        b, self._builder = self._builder, None
        if b is None:
            return
        if b.n == 0:
            b.abandon()
            return
        wm = self._b_wm if self._b_wm != WM_NONE else fallback_wm
        self._advance_frontier(wm)
        buf = b.finish()
        if self.stats is not None:
            self.stats.h2d_bytes += buf.nbytes
        db = stage_packed(buf, self._b_treedef, self._b_dtypes, b.capacity,
                          b.n, self.device, watermark=wm,
                          frontier=self._frontier, ts_max=self._b_ts_max,
                          ts_min=self._b_ts_min, pool=b.pool)
        self.packed_batches += 1
        self._ship(db)

    def _emit_columns_chunked(self, cols, tss, wm, row_wms=None):
        """Chunk-accumulate route (non-packable lanes): full batches go
        out with one concatenate and one staging each."""
        if row_wms is None:
            # chunk-level wm: valid only after the last row
            row_wms = np.full(len(tss), WM_NONE, np.int64)
            if len(tss) and wm != WM_NONE:
                row_wms[-1] = wm
        self._col_chunks.append((cols, tss, row_wms))
        self._col_rows += len(tss)
        cap = self.output_batch_size
        if self._col_rows < cap:
            return
        names = list(self._col_chunks[0][0])
        cat = {n: _concat([c[0][n] for c in self._col_chunks])
               for n in names}
        tcat = _concat([c[1] for c in self._col_chunks])
        wcat = np.maximum.accumulate(
            _concat([c[2] for c in self._col_chunks]))
        total = len(tcat)
        for lo in range(0, total - total % cap, cap):
            bwm = int(wcat[lo + cap - 1])
            self._advance_frontier(bwm)
            self._stage_columns({n: a[lo:lo + cap] for n, a in cat.items()},
                                tcat[lo:lo + cap], bwm)
        rem = total % cap
        self._col_chunks = [] if rem == 0 else [
            ({n: a[total - rem:] for n, a in cat.items()},
             tcat[total - rem:], wcat[total - rem:])]
        self._col_rows = rem

    def _stage_columns(self, cols, tss, wm):
        db = columns_to_device(cols, tss, self.output_batch_size,
                               self.device, watermark=wm,
                               frontier=self._frontier)
        if self.stats is not None:
            self.stats.h2d_bytes += transfer_nbytes(db)
        self.chunked_batches += 1
        self._ship(db)

    def flush(self, wm):
        if self._builder is not None:
            self._finalize_builder(fallback_wm=wm)
        if self._col_chunks:
            names = list(self._col_chunks[0][0])
            cat = {n: _concat([c[0][n] for c in self._col_chunks])
                   for n in names}
            tcat = _concat([c[1] for c in self._col_chunks])
            # everything buffered ships in this batch: the newest row
            # frontier applies
            w = max(int(c[2].max()) for c in self._col_chunks)
            self._col_chunks = []
            self._col_rows = 0
            self._advance_frontier(w)
            self._stage_columns(cat, tcat, w if w != WM_NONE else wm)
        self._advance_frontier(wm)
        if not self._ob.items:
            return
        hb = HostBatch(self._ob.items, self._ob.tss, self._ob.wm)
        self._ob = _OpenBatch()
        db = host_to_device(hb, capacity=self.output_batch_size,
                            device=self.device, frontier=self._frontier)
        if self.stats is not None:
            self.stats.h2d_bytes += transfer_nbytes(db)
        self.record_batches += 1
        self._ship(db)


class DevicePassEmitter(Emitter):
    """Device→device edge: batches move by handle (no copies),
    round-robin over destinations."""

    def __init__(self, dests):
        super().__init__(dests, output_batch_size=0)
        self._next = 0

    def emit_device_batch(self, batch: DeviceBatch):
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._send(d, batch)


class DeviceToHostEmitter(Emitter):
    """Device→host boundary: the batch comes back in one packed copy
    (``device_to_host``) and the whole HostBatch goes through the inner
    host emitter."""

    def __init__(self, inner: Emitter):
        super().__init__(inner.dests, inner.output_batch_size)
        self.inner = inner

    def bind_stats(self, stats):
        super().bind_stats(stats)
        self.inner.bind_stats(stats)

    def emit(self, item, ts, wm, shared=False, tid=None):
        self.inner.emit(item, ts, wm, shared, tid=tid)

    def emit_device_batch(self, batch: DeviceBatch):
        if self.stats is not None:
            self.stats.d2h_bytes += transfer_nbytes(batch)
        hb = device_to_host(batch)
        if hb.items:        # all-invalid batches carry no data
            self.inner.emit_host_batch(hb)

    def emit_host_batch(self, hb):
        self.inner.emit_host_batch(hb)

    def propagate_punctuation(self, wm):
        self.inner.propagate_punctuation(wm)

    def flush(self, wm):
        self.inner.flush(wm)


def create_emitter(routing: RoutingMode, dests, output_batch_size: int,
                   src_is_gpu: bool, dst_is_gpu: bool, device) -> Emitter:
    """Pick the emitter for an edge from (routing, src-on-device,
    dst-on-device), mirroring the reference's dispatch
    (``multipipe.hpp:236-350``)."""
    if routing == RoutingMode.KEYBY and len(dests) > 1:
        raise WindFlowError(
            "keyed routing to several replicas is not ported yet "
            "(KeyedDeviceStageEmitter / DeviceKeyByEmitter / KeyByEmitter); "
            "use parallelism 1 on keyed operators")
    if dst_is_gpu:
        if src_is_gpu:
            return DevicePassEmitter(dests)
        return DeviceStageEmitter(dests, output_batch_size, device)
    if src_is_gpu and dests \
            and all(getattr(r.op, "columnar", False) for r, _ in dests):
        # columnar sinks consume DeviceBatches whole (bulk copy inside
        # the sink replica)
        return DevicePassEmitter(dests)
    inner = ForwardEmitter(dests, output_batch_size)
    if src_is_gpu:
        return DeviceToHostEmitter(inner)
    return inner
