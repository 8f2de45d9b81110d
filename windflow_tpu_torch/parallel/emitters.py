"""Emitters: output routing per edge (the port of the classes of
``windflow_tpu/parallel/emitters.py`` that the count-window path creates).

* :class:`ForwardEmitter` — host tuples round-robin, batched per
  destination (reference ``forward_emitter.hpp``).
* :class:`DeviceStageEmitter` — host→device boundary: accumulates records
  into one packed staging buffer of fixed capacity and ships it with one
  copy (reference ``Forward_Emitter_GPU``).
* :class:`DevicePassEmitter` — device→device edge: batches move by handle.
* :class:`DeviceToHostEmitter` — device→host boundary: one packed copy
  back, then the whole HostBatch goes to an inner host emitter.

Keyed routing to several replicas (``KeyedDeviceStageEmitter``,
``DeviceKeyByEmitter``, ``KeyByEmitter``), broadcast and the columnar
staging path of bulk sources are not ported yet; :func:`create_emitter`
names a keyed multi-replica edge instead of mis-routing it.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.batch import (DeviceBatch, HostBatch, Punctuation,
                                      WM_NONE, device_to_host, host_to_device,
                                      transfer_nbytes)


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


class DeviceStageEmitter(Emitter):
    """Host→device boundary: accumulates host records, stages one
    DeviceBatch of fixed capacity ``output_batch_size`` onto ``device``
    with ONE packed copy (``batch.host_to_device``), and round-robins
    destinations.  The fixed capacity keeps every staged batch at one
    shape.  The open batch's data timestamp extrema come from the one
    vectorised pass staging makes over its timestamps and ride on the
    batch (``DeviceBatch.ts_min``/``ts_max``), for the time-window ring
    downstream."""

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

    def _advance_frontier(self, wm):
        if wm != WM_NONE and wm > self._frontier:
            self._frontier = wm

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._advance_frontier(wm)
        self._ob.add(item, ts, wm)
        if len(self._ob.items) >= self.output_batch_size:
            self.flush(wm)

    def flush(self, wm):
        self._advance_frontier(wm)
        if not self._ob.items:
            return
        hb = HostBatch(self._ob.items, self._ob.tss, self._ob.wm)
        self._ob = _OpenBatch()
        db = host_to_device(hb, capacity=self.output_batch_size,
                            device=self.device, frontier=self._frontier)
        if self.stats is not None:
            self.stats.h2d_bytes += transfer_nbytes(db)
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._send(d, db)


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
