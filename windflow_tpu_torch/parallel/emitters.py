"""Emitters: output routing per edge (the port of
``windflow_tpu/parallel/emitters.py``; reference ``*_emitter.hpp`` and
``*_emitter_gpu.hpp``).

* :class:`ForwardEmitter` — host tuples round-robin, batched per
  destination (reference ``forward_emitter.hpp``).
* :class:`KeyByEmitter` — host tuples by ``stable_hash(key) % n``
  (reference ``keyby_emitter.hpp``).
* :class:`BroadcastEmitter` — every destination sees every host tuple.
* :class:`DeviceStageEmitter` — host→device boundary: accumulates records
  into one packed staging buffer of fixed capacity and ships it with one
  copy (reference ``Forward_Emitter_GPU``); bulk sources hand it whole
  columns (``emit_columns``), which stream into pooled staging buffers
  with no per-tuple work.  With the wire plane on (``wire.py``) each
  finished buffer is re-encoded before its copy; with a megastep edge
  attached (``megastep.py``) each finished batch is offered to it first.
* :class:`KeyedDeviceStageEmitter` — host→device KEYBY: tuples (or column
  rows) partitioned by ``splitmix64(key) % n`` into one staging emitter a
  destination.
* :class:`DevicePassEmitter` — device→device edge: batches move by handle
  (round-robin, or to every destination under BROADCAST).
* :class:`DeviceKeyByEmitter` — device→device KEYBY: one mask a
  destination over the same buffers (no sort, gather or host read).
* :class:`DeviceToHostEmitter` — device→host boundary: one packed copy
  back, then the whole HostBatch goes to an inner host emitter.
* :class:`SplittingEmitter` — a MultiPipe split point: the device-native
  mask split when the split function evaluates on a whole batch, else the
  host per-tuple route.

Keyed placement is splitmix64 of the int32-wrapped key, bit-identical on
the host record path (:func:`splitmix64_int`), numpy columns
(:func:`splitmix64_np`) and the card (:func:`splitmix64_torch`), so a
keyed operator fed by a host edge and a device edge at once (a merge)
sees each key on one replica.

Key compaction (``parallel/compaction.py``) hooks in at three places,
wired by ``attach_compaction``: the keyed staging emitter admits every
key it routes (record and columnar paths) and, for an evictable
compactor at parallelism > 1, places slotted keys by ``slot % n``; the
device keyby applies the same placement on the card; the plain staging
emitter admits through its key probe
(``monitoring/shard_ledger.HostKeyProbe``).  :class:`KeyInterner` is the
stateful operators' host key -> slot map.

Observability (``monitoring/``), bound by ``PipeGraph._build`` through
``bind_observability``: an emitter where a batch is born (a host batch
flushed, a device batch staged) draws the flight recorder's sampling
decision and stamps ``emitted`` or ``staged`` on a traced batch; the
shard plane's key-skew sketch (``monitoring/shard_ledger.ShardSketch``)
rides the keyed emitters: host-side on the keyed staging edge (its key
column and per-destination counts exist there), from one sampled key a
flushed batch on the host KEYBY edge, and on the card inside the device
keyby split (``device_sketch_update``, no host read).

The reshard executor (``windflow_tpu_torch/serving``) acts through two
hooks: ``set_override`` on :class:`KeyByEmitter` and
:class:`KeyedDeviceStageEmitter` (a key→shard map ahead of the hash and
of the compactor's placement: moved keys route to their new shard), and
``set_preagg`` on the keyed staging emitter (split_hot_key: a hot key's
tuples fold through the consumer's associative combiner at this boundary
and ship as one partial record a flush).  The columnar keyed staging
partitions through the native ``wf_keyby_partition``
(``windflow_tpu_torch/native``).

On a mesh (``Config.mesh``) a staging emitter's capacity must divide
over the mesh's positions; the staged batch lands whole on the graph's
device and the consumer's sharded step lays it out
(``parallel/mesh.py``).  In a multi-process job each process stages only
its own ``capacity / process_count`` lanes.  Mesh staging ships raw (no
wire), as in the JAX package.  :class:`AlignedMeshStageEmitter` is the
key-aligned ingest: each record goes to its key owner's column.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from windflow_tpu_torch import staging
from windflow_tpu_torch.analysis.hotpath import hot_path
from windflow_tpu_torch.basic import (RoutingMode, WindFlowError, int32_key,
                                      stable_hash)
from windflow_tpu_torch.monitoring import recorder as flightrec
from windflow_tpu_torch.batch import (DeviceBatch, HostBatch, Punctuation,
                                      WM_NONE, columns_to_device,
                                      device_to_host, host_to_device,
                                      stage_packed, transfer_nbytes)
from windflow_tpu_torch.utils.tree import tree_flatten, tree_map

_M64 = (1 << 64) - 1
_SM_ADD = 0x9E3779B97F4A7C15
_SM_MUL1 = 0xBF58476D1CE4E5B9
_SM_MUL2 = 0x94D049BB133111EB


def splitmix64_int(k: int) -> int:
    """splitmix64 of a Python int (taken mod 2^64): the host record path's
    placement hash."""
    x = (k + _SM_ADD) & _M64
    x = ((x ^ (x >> 30)) * _SM_MUL1) & _M64
    x = ((x ^ (x >> 27)) * _SM_MUL2) & _M64
    return x ^ (x >> 31)


def splitmix64_np(keys) -> np.ndarray:
    """splitmix64 over an int key column (sign-extended to int64, then
    taken as uint64): the columnar path's placement hash, equal to
    :func:`splitmix64_int` lane for lane."""
    x = np.asarray(keys).astype(np.int64).astype(np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(_SM_ADD)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(_SM_MUL1)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(_SM_MUL2)
    return x ^ (x >> np.uint64(31))


def _signed64(c: int) -> int:
    """A 64-bit constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _srl(x, s: int):
    """Logical right shift of an int64 tensor: ``>>`` on int64 is
    arithmetic, so the sign-filled top ``s`` bits are masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64_torch(keys):
    """splitmix64 of an int key lane as torch int64 ops, with the same bits
    as :func:`splitmix64_int` of the sign-extended key: additions and
    multiplications wrap mod 2^64, the multipliers above 2^63 are written
    as their int64 two's complements, and the shifts are logical."""
    import torch
    x = keys.to(torch.int64) + _signed64(_SM_ADD)
    x = (x ^ _srl(x, 30)) * _signed64(_SM_MUL1)
    x = (x ^ _srl(x, 27)) * _signed64(_SM_MUL2)
    return x ^ _srl(x, 31)


def place_torch(keys, n: int):
    """``splitmix64(key) mod n`` as an unsigned remainder, in int64 torch
    ops: ``x = 2 * (x >>> 1) + (x & 1)``, and both parts are reduced mod n
    without a negative operand."""
    h = splitmix64_torch(keys)
    return ((_srl(h, 1) % n) * 2 + (h & 1)) % n


class KeyInterner:
    """Host map from arbitrary user keys to dense int slots, assigned in
    arrival order: the stateful operators' per-key state lives in dense
    ``[num_slots, ...]`` tables indexed by them (the reference copies the
    batch's distinct keys to the host at the keyby boundary too,
    ``dist_keys_cpu``, ``keyby_emitter_gpu.hpp:519-583``)."""

    def __init__(self) -> None:
        self._ids = {}

    def intern(self, key: Any) -> int:
        i = self._ids.get(key)
        if i is None:
            i = len(self._ids)
            self._ids[key] = i
        return i

    def __len__(self) -> int:
        return len(self._ids)

    def keys_by_slot(self) -> list:
        out = [None] * len(self._ids)
        for k, i in self._ids.items():
            out[i] = k
        return out


class Emitter:
    """Base emitter: owns destination inboxes and per-destination channel
    ids (reference ``Basic_Emitter``)."""

    #: whether this emitter takes host tuples (``emit``); device-only
    #: emitters say False so a split's host route can refuse up front
    can_emit_host_items = True

    def __init__(self, dests: Sequence[Tuple[Any, int]],
                 output_batch_size: int) -> None:
        self.dests = list(dests)
        self.output_batch_size = output_batch_size
        #: bound by PipeGraph._build through the owning replica: its
        #: stats record (transfer byte counters), its span ring and the
        #: graph's FlightRecorder (trace birth); ring and flight are None
        #: with the recorder off
        self.stats = None
        self.ring = None
        self.flight = None

    def bind_observability(self, stats, ring=None, flight=None) -> None:
        """Attach the owning replica's stats and ring and the graph's
        recorder; compound emitters pass the binding on."""
        self.stats = stats
        self.ring = ring
        self.flight = flight

    def _new_trace(self, stage: int = flightrec.EMITTED):
        """Trace lane of a batch born here: the 1-in-N sampling decision
        and the birth event; None (one check) with the recorder off or
        an unsampled batch."""
        if self.flight is None:
            return None
        tr = self.flight.maybe_trace()
        if tr is not None and self.ring is not None:
            self.ring.record(tr[0], stage, tr[1])
        return tr

    def emit(self, item: Any, ts: int, wm: int,
             shared: bool = False, tid=None) -> None:
        """``shared`` marks an item also delivered elsewhere (a split's
        multicast): in-place consumers copy it before mutating.  ``tid``
        is the origin id relayed for DETERMINISTIC tie-breaking."""
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

    @hot_path
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

    @hot_path
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
                                    ids=ob.ids_or_none(),
                                    trace=self._new_trace()))
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


class KeyByEmitter(Emitter):
    """KEYBY routing of host tuples: ``stable_hash(key) % n`` per tuple,
    per-destination open batches (reference ``keyby_emitter.hpp:216-257``)."""

    def __init__(self, dests, output_batch_size,
                 key_extractor: Callable[[Any], Any]):
        super().__init__(dests, output_batch_size)
        self.key_extractor = key_extractor
        self._open = [_OpenBatch() for _ in dests]
        #: shard-plane sketch, attached at graph build: a flushed batch
        #: credits its shard exactly and its first key as the sample
        self._sketch = None
        #: reshard-executor key→shard override: moved keys route to their
        #: assigned shard before the hash.  None leaves one check a tuple
        self._override = None

    def set_override(self, override) -> None:
        """Install or replace the key→destination override map (executor
        moves; a restore re-installs the checkpointed maps)."""
        self._override = dict(override) if override else None

    @hot_path
    def emit(self, item, ts, wm, shared=False, tid=None):
        key = self.key_extractor(item)
        d = None
        if self._override is not None:
            d = self._override.get(key)
        if d is None:
            d = stable_hash(key) % len(self.dests)
        ob = self._open[d]
        ob.add(item, ts, wm, shared, tid)
        if len(ob.items) >= max(1, self.output_batch_size):
            self._flush_dest(d)

    def _flush_dest(self, d):
        ob = self._open[d]
        if ob.items and self._sketch is not None:
            try:
                key = self.key_extractor(ob.items[0])
            except Exception:  # lint: broad-except-ok (a sample of a user
                # function: the load below still counts)
                key = None
            self._sketch.note_flush(d, len(ob.items), key)
        if ob.items:
            self._send(d, HostBatch(ob.items, ob.tss, ob.wm,
                                    shared=ob.shared,
                                    ids=ob.ids_or_none(),
                                    trace=self._new_trace()))
            self._open[d] = _OpenBatch()

    def flush(self, wm):
        for d in range(len(self.dests)):
            self._flush_dest(d)


class BroadcastEmitter(Emitter):
    """BROADCAST routing of host tuples: every destination sees every
    tuple (reference ``broadcast_emitter.hpp``).  One batch object is
    delivered to every inbox, marked shared, so in-place consumers copy
    before mutating."""

    def __init__(self, dests, output_batch_size):
        super().__init__(dests, output_batch_size)
        self._ob = _OpenBatch()

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._ob.add(item, ts, wm, shared, tid)
        if len(self._ob.items) >= max(1, self.output_batch_size):
            self.flush(wm)

    def flush(self, wm):
        if self._ob.items:
            b = HostBatch(self._ob.items, self._ob.tss, self._ob.wm,
                          shared=len(self.dests) > 1 or self._ob.shared,
                          ids=self._ob.ids_or_none(),
                          trace=self._new_trace())
            for d in range(len(self.dests)):
                self._send(d, b)
            self._ob = _OpenBatch()

    def emit_host_batch(self, hb):
        self.flush(hb.watermark)
        if len(self.dests) > 1:
            hb = HostBatch(hb.items, hb.tss, hb.watermark, shared=True,
                           ids=hb.ids, trace=hb.trace)
        for d in range(len(self.dests)):
            self._send(d, hb)


def _concat(arrs):
    return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)


class _StagedPacket:
    """One finalized packed batch before its copy: everything the
    per-batch ship stamps, captured at finalize time, so the megastep
    plane (``megastep.py``) can queue K of them and either fold them into
    one group or replay the per-batch ship (``_ship_packed``) in FIFO
    order.  ``wm_pane`` is filled in by the megastep edge for a
    time-window tail."""

    __slots__ = ("buf", "fmt", "wm", "frontier", "ts_min", "ts_max", "n",
                 "pool", "treedef", "dtypes", "capacity", "wm_pane", "trace",
                 "logical_nbytes")

    def __init__(self, buf, fmt, wm, frontier, ts_min, ts_max, n, pool,
                 treedef, dtypes, capacity, trace=None, logical_nbytes=None):
        self.buf = buf
        self.fmt = fmt
        self.wm = wm
        self.frontier = frontier
        self.ts_min = ts_min
        self.ts_max = ts_max
        self.n = n
        self.pool = pool
        self.treedef = treedef
        self.dtypes = dtypes
        self.capacity = capacity
        self.wm_pane = None
        #: the flight recorder's lane, drawn when the batch was staged
        self.trace = trace
        self.logical_nbytes = logical_nbytes


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
    staged; while the host spans are on, each staged batch also counts
    in the span table's ``batches_staged`` (``recorder.note_staged``).

    Wire plane (``wire.py``, enabled by ``wire.attach_wire``): a finished
    packed buffer is re-encoded lane by lane into a pooled wire buffer,
    decoded on the card in the unpack; the record path then stacks its
    open batch into columns and takes the packed route.  Megastep plane
    (``megastep.py``, attached by ``PipeGraph._build``): each finalized
    packed batch is offered to ``self._megastep``, which queues K of
    them for one group; ``flush`` (the external entry: EOS, punctuation)
    drains that queue per batch after shipping what is open."""

    def __init__(self, dests, output_batch_size, device, mesh=None):
        if output_batch_size <= 0:
            # reference multipipe.hpp:441-444
            raise WindFlowError(
                "a GPU operator requires the upstream operator to set an "
                "output batch size > 0")
        #: the mesh the consumer runs on: capacities divide over its
        #: positions, and each process stages its share of the lanes
        self._mesh = mesh
        if mesh is not None:
            if output_batch_size % mesh.size:
                raise WindFlowError(
                    f"output batch size {output_batch_size} not divisible "
                    f"by the mesh's {mesh.size} devices")
            output_batch_size //= mesh.process_count
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
        #: key probe (monitoring/shard_ledger.HostKeyProbe), attached at
        #: graph build when this edge feeds a compacted keyed consumer:
        #: it admits the consumer's keys before each batch ships
        self._shard_probe = None
        # wire plane: off leaves one flag check a finalize
        self._wire_on = False
        self._wire_reseed = 64
        self._wire_encoders = {}
        #: the megastep edge this emitter feeds (megastep.MegastepEdge),
        #: or None: the per-batch ship
        self._megastep = None

    def _advance_frontier(self, wm):
        if wm != WM_NONE and wm > self._frontier:
            self._frontier = wm

    def enable_wire(self, reseed_every: int = 64) -> None:
        """Turn on wire compression of this emitter's packed staging
        (``wire.attach_wire``, at graph build); mesh staging ships raw."""
        if self._mesh is not None:
            return
        self._wire_on = True
        self._wire_reseed = max(1, reseed_every)

    def _wire_encoder(self, dtypes, capacity: int):
        key = (dtypes, capacity)
        enc = self._wire_encoders.get(key)
        if enc is None:
            from windflow_tpu_torch.wire import WireEncoder
            enc = WireEncoder(dtypes, capacity,
                              reseed_every=self._wire_reseed)
            self._wire_encoders[key] = enc
        return enc

    def _ship(self, db):
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._send(d, db)

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._advance_frontier(wm)
        self._ob.add(item, ts, wm)
        if len(self._ob.items) >= self.output_batch_size:
            # capacity flush: internal, so a megastep edge keeps its queue
            self._flush_impl(wm)

    def emit_columns(self, cols, tss, wm, row_wms=None):
        """Columnar route: packable 1-D lanes stream into the packed
        builder; anything else (or anything after a chunk is buffered)
        takes the chunk-accumulate route, after the open builder ships, so
        arrival order is kept."""
        if self._shard_probe is not None:
            self._shard_probe.columns(cols, len(tss))
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
        """Finish the open packed batch (wire-encoded when the plane is
        on), offer it to the megastep edge, else ship it."""
        b, self._builder = self._builder, None
        if b is None:
            return
        if b.n == 0:
            b.abandon()
            return
        wm = self._b_wm if self._b_wm != WM_NONE else fallback_wm
        self._advance_frontier(wm)
        buf = b.finish()
        logical_nbytes = buf.nbytes
        fmt = None
        if self._wire_on:
            # a batch compression cannot shrink ships the logical buffer
            # unchanged (fmt None)
            enc = self._wire_encoder(self._b_dtypes, b.capacity)
            buf, fmt = enc.encode(buf, pool=b.pool)
        if self.stats is not None:
            self.stats.h2d_bytes += buf.nbytes
            self.stats.h2d_logical_bytes += logical_nbytes
        self.packed_batches += 1
        flightrec.note_staged()
        pkt = _StagedPacket(buf, fmt, wm, self._frontier, self._b_ts_min,
                            self._b_ts_max, b.n, b.pool, self._b_treedef,
                            self._b_dtypes, b.capacity,
                            self._new_trace(flightrec.STAGED),
                            logical_nbytes)
        ms = self._megastep
        if ms is not None and ms.offer(pkt):
            return
        self._ship_packed(pkt)

    def _ship_packed(self, pkt: _StagedPacket) -> None:
        """The per-batch ship of one finalized packed batch: one
        non-blocking copy, the pooled buffer recycled behind the copy's
        event (``stage_packed``).  Stamps come from the packet, never
        from the emitter: a queued batch shipped later must not borrow a
        frontier that advanced past it."""
        self._ship(stage_packed(
            pkt.buf, pkt.treedef, pkt.dtypes, pkt.capacity, pkt.n,
            self.device, watermark=pkt.wm, frontier=pkt.frontier,
            ts_max=pkt.ts_max, ts_min=pkt.ts_min, pool=pkt.pool,
            wire=pkt.fmt, trace=pkt.trace,
            logical_nbytes=pkt.logical_nbytes))

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
                               frontier=self._frontier,
                               trace=self._new_trace(flightrec.STAGED))
        if self.stats is not None:
            self.stats.h2d_bytes += transfer_nbytes(db)
            self.stats.h2d_logical_bytes += transfer_nbytes(db)
        self.chunked_batches += 1
        flightrec.note_staged()
        self._ship(db)

    def flush(self, wm):
        """External flush (EOS, punctuation): ship everything open, then
        drain the megastep queue per batch, so a watermark never
        overtakes batches parked for a future group."""
        self._flush_impl(wm)
        ms = self._megastep
        if ms is not None:
            ms.drain_remainder()

    def _flush_impl(self, wm):
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
        if self._shard_probe is not None:
            self._shard_probe.items(self._ob.items)
        if self._wire_on and self._ship_records_packed():
            return
        hb = HostBatch(self._ob.items, self._ob.tss, self._ob.wm)
        self._ob = _OpenBatch()
        db = host_to_device(hb, capacity=self.output_batch_size,
                            device=self.device, frontier=self._frontier,
                            trace=self._new_trace(flightrec.STAGED))
        if self.stats is not None:
            self.stats.h2d_bytes += transfer_nbytes(db)
            self.stats.h2d_logical_bytes += transfer_nbytes(db)
        self.record_batches += 1
        flightrec.note_staged()
        self._ship(db)

    def _ship_records_packed(self) -> bool:
        """The record path's wire route: stack the open batch into columns
        and ship it through the packed (wire) route, stamped exactly as
        the record path would (the open batch's min-folded watermark).
        False when the records do not stack into packable 1-D lanes."""
        from windflow_tpu_torch.batch import _stack_records
        try:
            leaves, treedef = tree_flatten(_stack_records(self._ob.items))
            ok = all(getattr(l, "ndim", 0) == 1
                     and staging.packable_dtype(l.dtype) for l in leaves)
        except Exception:  # lint: broad-except-ok (arbitrary user records may
            # not stack into columns: take the uncompressed record path)
            ok = False
        if not ok:
            return False
        ob, self._ob = self._ob, _OpenBatch()
        tss = np.ascontiguousarray(ob.tss, np.int64)
        # stamp this batch with the open batch's wm, then restore the
        # running row frontier: a later columnar batch never stamps lower
        # than the wire-off run would
        prev_wm = self._b_wm
        self._b_wm = ob.wm
        self._emit_columns_packed(leaves, treedef, tss, WM_NONE, None)
        self._b_wm = ob.wm
        self._finalize_builder()
        self._b_wm = max(prev_wm, ob.wm)
        return True


def host_keys(key_fn, cols, n: int) -> np.ndarray:
    """The int32-wrapped key of every row of a column block, as int64.
    The extractor is a per-record torch function: it runs on the numpy
    columns when it can, else on CPU torch views of them.  Raises
    ``ValueError`` when neither gives one key a row."""
    import torch

    from windflow_tpu_torch.utils.tree import tree_map
    for wrap in (np.asarray, lambda a: torch.from_numpy(np.asarray(a))):
        try:
            k = key_fn(tree_map(wrap, cols))
        except Exception:  # lint: broad-except-ok (a probe of a user function)
            continue
        k = k.numpy() if isinstance(k, torch.Tensor) else np.asarray(k)
        if k.shape == (n,):
            # the device's int32 cast first, so routing collapses exactly
            # the keys the state collapses
            return k.astype(np.int64).astype(np.int32).astype(np.int64)
    raise ValueError("the key extractor is not elementwise over columns")


def _to_torch(v):
    import torch
    return torch.from_numpy(np.array(v))


def _to_host(v):
    """A combiner's output leaf back to numpy: a 0-d result becomes a
    numpy scalar of its dtype (the record path stacks it as such)."""
    import torch
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return v[()] if isinstance(v, np.ndarray) and v.ndim == 0 else v


def _comb_records(comb, a, b):
    """``comb(a, b)`` for two host records: the port's combiners are
    torch ops over a record's fields, so the fields go in as CPU tensors
    (numpy's dtypes: a Python float is float64, as on the record path)
    and come back as numpy scalars."""
    return tree_map(_to_host, comb(tree_map(_to_torch, a),
                                   tree_map(_to_torch, b)))


def _log_fold(comb, rec: dict, m: int) -> dict:
    """Fold ``m`` records held as ``[m]`` numpy columns into one record
    through an ASSOCIATIVE combiner by repeated halving: the combiner runs
    log2(m) times over vectorized halves (CPU tensors) instead of m - 1
    times over scalars.  Only the grouping changes (float sums keep the
    dense route's rounding tolerance)."""
    import torch
    t = {k: _to_torch(v) for k, v in rec.items()}
    while m > 1:
        h = m // 2
        c = comb({k: v[:h] for k, v in t.items()},
                 {k: v[h:2 * h] for k, v in t.items()})
        c = {k: torch.atleast_1d(torch.as_tensor(c[k])) for k in t}
        if m - 2 * h:
            t = {k: torch.cat([c[k].to(v.dtype), v[2 * h:]])
                 for k, v in t.items()}
        else:
            t = c
        m = h + (m - 2 * h)
    return {k: _to_host(v[0]) for k, v in t.items()}


def _key_column(key_extractor, cols, n: int) -> np.ndarray:
    """:func:`host_keys`, else the extractor row by row (a constant or
    Python-level extractor)."""
    try:
        return host_keys(key_extractor, cols, n)
    except ValueError:
        pass
    return np.array([int32_key(key_extractor(
        {nm: np.asarray(v)[i].item() for nm, v in cols.items()}))
        for i in range(n)], np.int64)


class KeyedDeviceStageEmitter(Emitter):
    """Host→device boundary with KEYBY routing (reference CPU→GPU
    ``KeyBy_Emitter_GPU``, ``keyby_emitter_gpu.hpp:400-476``): tuples are
    partitioned by ``splitmix64(key) % n`` into one single-destination
    :class:`DeviceStageEmitter` a destination, so every key's tuples flow
    through one replica in arrival order.  Columns partition by the native
    hash (``native.keyby_partition``, bit-identical to the numpy one) and
    reuse the inner emitters' packed route and per-row frontier lanes
    (the row frontier is global, so each partition's slice of it stays a
    valid stamp).  The executor's override map (int32 keys) wins over the
    compactor's placement and the hash; a pre-aggregated hot key's tuples
    fold into one partial record a flush (``set_preagg``)."""

    def __init__(self, dests, output_batch_size, key_extractor, device,
                 mesh=None):
        super().__init__(dests, output_batch_size)
        self.key_extractor = key_extractor
        self._inner = [DeviceStageEmitter([d], output_batch_size, device,
                                          mesh=mesh)
                       for d in dests]
        #: key compactor of the consumer (attached at graph build): every
        #: routed key is admitted here before its batch ships, and an
        #: evictable compactor with placement_override routes slotted
        #: keys by ``slot % n`` instead of the splitmix hash
        self._compactor = None
        #: shard-plane sketch (attached at graph build): the record path
        #: buffers the routed int32 keys and updates a bulk every 256;
        #: the columnar path updates from the key column and the counts
        self._sketch = None
        self._sk_buf = []
        #: reshard-executor key→shard override, keyed by the int32 key the
        #: device state collapses to; it beats every derived placement
        self._override = None
        #: split_hot_key pre-aggregation: the named hot keys' tuples fold
        #: through the consumer's associative combiner here and ship as
        #: one partial record a flush (the final per-key aggregate is
        #: unchanged; per-batch partials coarsen).  None leaves one check
        #: an emit path
        self._preagg = None         # {"keys": set, "comb": fn}
        self._preagg_acc = {}       # k32 -> [record, max_ts, n]
        self.preagg_folds = 0       # tuples absorbed into partials

    def set_override(self, override) -> None:
        """Install or replace the key→destination override map, keyed by
        the int32-truncated key."""
        if not override:
            self._override = None
            return
        self._override = {int32_key(k): d for k, d in override.items()}

    def set_preagg(self, keys, comb) -> None:
        """Pre-aggregate ``keys`` (the split_hot_key action) through
        ``comb``, the consumer's associative record combiner (torch ops
        over a record's fields); ``None``/empty turns it off.  What is
        folded so far ships first."""
        self._flush_preagg(WM_NONE)
        if not keys or comb is None:
            self._preagg = None
            return
        self._preagg = {"keys": {int32_key(k) for k in keys}, "comb": comb}

    def _fold_into(self, k32, item, ts):
        acc = self._preagg_acc.get(k32)
        if acc is None:
            self._preagg_acc[k32] = [item, ts, 1]
            return
        acc[0] = _comb_records(self._preagg["comb"], acc[0], item)
        acc[1] = max(acc[1], ts)
        acc[2] += 1
        self.preagg_folds += 1

    def _flush_preagg(self, wm) -> None:
        if not self._preagg_acc:
            return
        acc, self._preagg_acc = self._preagg_acc, {}
        for k32, (item, ts, _n) in acc.items():
            self._route_one(k32, item, ts, wm)

    def bind_observability(self, stats, ring=None, flight=None):
        super().bind_observability(stats, ring, flight)
        for e in self._inner:
            e.bind_observability(stats, ring, flight)

    @property
    def packed_batches(self) -> int:
        return sum(e.packed_batches for e in self._inner)

    @property
    def chunked_batches(self) -> int:
        return sum(e.chunked_batches for e in self._inner)

    @property
    def record_batches(self) -> int:
        return sum(e.record_batches for e in self._inner)

    def emit(self, item, ts, wm, shared=False, tid=None):
        k32 = int32_key(self.key_extractor(item))
        pa = self._preagg
        if pa is not None and k32 in pa["keys"]:
            self._fold_into(k32, item, ts)
            return
        self._route_one(k32, item, ts, wm)

    def _route_one(self, k32, item, ts, wm):
        comp = self._compactor
        d = None
        if comp is not None:
            try:
                comp.observe_one(k32)
                if comp.placement_override:
                    d = comp.place_one(k32, len(self.dests))
            except Exception:  # lint: broad-except-ok (admission must never
                # take routing down: the plane deactivates instead)
                comp.deactivate()
                self._compactor = None
        if self._override is not None:
            # an executor move beats every derived placement: the key was
            # moved on purpose, and its state moved with it
            o = self._override.get(k32)
            if o is not None:
                d = o
        if d is None:
            d = splitmix64_int(k32) % len(self.dests)
        self._inner[d].emit(item, ts, wm)
        if self._sketch is not None:
            self._sk_buf.append(k32)
            if len(self._sk_buf) >= 256:
                self._drain_sketch_buf()

    def _drain_sketch_buf(self):
        buf, self._sk_buf = self._sk_buf, []
        try:
            # the placement counts come from the same splitmix hash
            self._sketch.update_host(np.asarray(buf, np.int64))
        except Exception:  # lint: broad-except-ok (a sketch failure drops the
            # sketch, never routing)
            self._sketch = None

    def emit_columns(self, cols, tss, wm, row_wms=None):
        from windflow_tpu_torch import native
        n = len(self.dests)
        keys = _key_column(self.key_extractor, cols, len(tss))
        pa = self._preagg
        if pa is not None:
            hot = np.isin(keys, np.fromiter(pa["keys"], np.int64,
                                            len(pa["keys"])))
            if hot.any():
                self._fold_columns(pa, cols, tss, keys, hot)
                keep = ~hot
                if not keep.any():
                    return
                cols = {k: np.asarray(v)[keep] for k, v in cols.items()}
                tss = np.asarray(tss)[keep]
                keys = keys[keep]
                if row_wms is not None:
                    row_wms = row_wms[keep]
        comp = self._compactor
        if comp is not None:
            try:
                # admission before the batch ships: a host-fed compacted
                # consumer never sees a remap miss
                comp.observe(keys)
            except Exception:  # lint: broad-except-ok (as in emit())
                comp.deactivate()
                comp = self._compactor = None
        if comp is not None and comp.placement_override:
            dest = comp.place_np(keys, n).astype(np.int64)
        else:
            # the native hash + count partition (wf_keyby_partition)
            dest = native.keyby_partition(keys, n)[0].astype(np.int64)
        if self._override is not None:
            # executor moves re-place their keys over the derived
            # placement (a handful of entries: the advisor's move list)
            for k, d_ov in self._override.items():
                dest[keys == k] = d_ov
        counts = np.bincount(dest, minlength=n)
        if self._sketch is not None:
            try:
                self._sketch.update_host(keys, counts=counts)
            except Exception:  # lint: broad-except-ok (as in
                # _drain_sketch_buf)
                self._sketch = None
        for d in range(n):
            if counts[d]:
                idx = np.nonzero(dest == d)[0]
                self._inner[d].emit_columns(
                    {k: np.asarray(v)[idx] for k, v in cols.items()},
                    np.asarray(tss)[idx], wm,
                    row_wms[idx] if row_wms is not None else None)

    def _fold_columns(self, pa, cols, tss, keys, hot) -> None:
        """Columnar half of the pre-aggregating combine: the rows of each
        hot key log-fold through the combiner (vectorized halving) into
        its running partial."""
        comb = pa["comb"]
        arrs = {nm: np.asarray(v) for nm, v in cols.items()}
        tss = np.asarray(tss)
        for k in np.unique(keys[hot]):
            idx = np.nonzero(keys == k)[0]
            folded = _log_fold(comb, {nm: v[idx] for nm, v in arrs.items()},
                               len(idx))
            self.preagg_folds += len(idx) - 1
            self._fold_into(int(k), folded, int(tss[idx].max()))

    def emit_device_batch(self, batch):
        raise WindFlowError(
            "keyed staging emitter received a device batch; device-to-"
            "device keyed edges use DeviceKeyByEmitter")

    def flush(self, wm):
        self._flush_preagg(wm)
        if self._sketch is not None and self._sk_buf:
            self._drain_sketch_buf()
        for e in self._inner:
            e.flush(wm)

    def propagate_punctuation(self, wm):
        self._flush_preagg(wm)
        for e in self._inner:
            e.propagate_punctuation(wm)


class AlignedMeshStageEmitter(Emitter):
    """Host→mesh staging with key-aligned placement: each record goes
    into the ``(data, key)`` block of the key shard that owns its key
    (the dense-range owner ``key // K_local``, exactly the ownership the
    sharded step rebases by), so the consumer's ``ingest="aligned"``
    step skips the data-axis all_gather (``parallel/mesh.py``).

    Rows buffer per key column; a batch ships when a column fills, its
    column's rows split row-major over the ``dd`` data blocks (the order
    the aligned step's data gather rebuilds), with a per-block validity
    computed on the host.  A shipped batch's watermark is capped at the
    oldest data timestamp still buffered, so a row held back by skew
    never turns late against its own channel's stamp.  Executor key
    moves are refused (``set_override``): the ownership is built into the
    sharded step, so a move would stage a key onto a shard that masks it
    out of range; a mesh graph reshards by rescale-on-restore."""

    def __init__(self, dests, output_batch_size, key_extractor, mesh,
                 max_keys: int, device=None):
        super().__init__(dests, output_batch_size)
        kk, dd = mesh.shape["key"], mesh.shape["data"]
        if output_batch_size % (kk * dd):
            raise WindFlowError(
                f"output batch size {output_batch_size} not divisible by "
                f"the mesh's {kk * dd} devices (key-aligned ingest)")
        if max_keys % kk:
            raise WindFlowError(
                f"max_keys {max_keys} not divisible by the key axis {kk}")
        if mesh.process_count > 1:
            raise WindFlowError(
                "key-aligned ingest is single-process (multi-process "
                "meshes stage flat local lanes)")
        self.key_extractor = key_extractor
        self.device = device if device is not None else mesh.home
        self._kk, self._dd = kk, dd
        self._K_local = max_keys // kk
        self._col_cap = output_batch_size // kk
        self._blk = output_batch_size // (kk * dd)
        self._chunks = [[] for _ in range(kk)]     # [(cols dict, tss)]
        self._items = [_OpenBatch() for _ in range(kk)]
        self._rows = [0] * kk
        self._wm = WM_NONE              # running max of received stamps
        #: shard-plane key probe (monitoring/shard_ledger.HostKeyProbe)
        self._shard_probe = None
        self.batches_shipped = 0
        self.rows_shipped = 0

    def set_override(self, override) -> None:
        """Refused: the aligned consumer's key ownership is built into its
        sharded step."""
        if override:
            raise WindFlowError(
                "key-aligned mesh ingest cannot apply executor key "
                "moves: ownership is compiled into the sharded step "
                "(reshard a mesh graph via rescale-on-restore)")

    def _owner_np(self, k32: np.ndarray) -> np.ndarray:
        return np.clip(k32 // self._K_local, 0, self._kk - 1).astype(np.int64)

    def _note_wm(self, wm) -> None:
        if wm != WM_NONE and wm > self._wm:
            self._wm = wm

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._note_wm(wm)
        k32 = int32_key(self.key_extractor(item))
        c = min(max(k32 // self._K_local, 0), self._kk - 1)
        self._items[c].add(item, ts, wm)
        self._rows[c] += 1
        if self._rows[c] >= self._col_cap:
            self._ship_one()

    def emit_columns(self, cols, tss, wm, row_wms=None):
        self._note_wm(int(np.max(row_wms)) if row_wms is not None
                      and len(row_wms) else wm)
        if self._shard_probe is not None:
            self._shard_probe.columns(cols, len(tss))
        keys = host_keys(self.key_extractor, cols, len(tss))
        own = self._owner_np(keys)
        tss = np.ascontiguousarray(tss, np.int64)
        arrs = {n: np.asarray(v) for n, v in cols.items()}
        for c in range(self._kk):
            idx = np.nonzero(own == c)[0]
            if not len(idx):
                continue
            self._chunks[c].append(({n: v[idx] for n, v in arrs.items()},
                                    tss[idx]))
            self._rows[c] += len(idx)
        while any(r >= self._col_cap for r in self._rows):
            self._ship_one()

    def emit_device_batch(self, batch):
        raise WindFlowError(
            "key-aligned staging emitter received a device batch; "
            "device-fed mesh consumers keep the data-sharded ingest")

    def _col_take(self, c: int):
        """Up to ``col_cap`` rows of column ``c`` (record items stacked
        to columns first); the rest stays buffered."""
        from windflow_tpu_torch.batch import _stack_records
        ob = self._items[c]
        if ob.items:
            if self._shard_probe is not None:
                self._shard_probe.items(ob.items)
            soa = _stack_records(ob.items)
            if not isinstance(soa, dict):
                raise WindFlowError(
                    "key-aligned ingest stages dict-shaped records "
                    f"(got {type(ob.items[0]).__name__}); disable "
                    "Config.key_aligned_ingest for this graph")
            self._chunks[c].append(({n: np.asarray(v)
                                     for n, v in soa.items()},
                                    np.asarray(ob.tss, np.int64)))
            self._items[c] = _OpenBatch()
        if not self._chunks[c]:
            return None
        names = list(self._chunks[c][0][0])
        cat = {n: _concat([ch[0][n] for ch in self._chunks[c]])
               for n in names}
        tcat = _concat([ch[1] for ch in self._chunks[c]])
        m = len(tcat)
        take = min(m, self._col_cap)
        if take < m:
            self._chunks[c] = [({n: a[take:] for n, a in cat.items()},
                                tcat[take:])]
            self._rows[c] = m - take
        else:
            self._chunks[c] = []
            self._rows[c] = 0
        return {n: a[:take] for n, a in cat.items()}, tcat[:take]

    def _pending_min_ts(self):
        lo = None
        for c in range(self._kk):
            for ch in self._chunks[c]:
                if len(ch[1]):
                    m = int(ch[1].min())
                    lo = m if lo is None else min(lo, m)
            if self._items[c].tss:
                m = min(self._items[c].tss)
                lo = m if lo is None else min(lo, m)
        return lo

    def _ship_one(self) -> None:
        takes = [self._col_take(c) for c in range(self._kk)]
        if not any(t is not None for t in takes):
            return
        cap, kk, dd, blk = (self.output_batch_size, self._kk, self._dd,
                            self._blk)
        first = next(t for t in takes if t is not None)
        lanes = {n: np.zeros((cap,) + a.shape[1:], a.dtype)
                 for n, a in first[0].items()}
        ts = np.zeros(cap, np.int64)
        valid = np.zeros(cap, bool)
        total = 0
        for c, t in enumerate(takes):
            if t is None:
                continue
            colv, colt = t
            m = len(colt)
            total += m
            # a column's rows split row-major over the dd data blocks:
            # row r lands in block r // blk of column c
            for d in range(dd):
                lo = d * blk
                hi = min(m, lo + blk)
                if hi <= lo:
                    break
                g0 = (d * kk + c) * blk
                seg = slice(g0, g0 + (hi - lo))
                for n, a in colv.items():
                    lanes[n][seg] = a[lo:hi]
                ts[seg] = colt[lo:hi]
                valid[seg] = True
        if total == 0:
            return
        wm = self._wm
        pend = self._pending_min_ts()
        if wm != WM_NONE and pend is not None:
            wm = min(wm, pend)
        # the packed staging copy, the validity riding it as a lane
        db = columns_to_device(lanes, ts, cap, self.device, watermark=wm,
                               frontier=wm,
                               trace=self._new_trace(flightrec.STAGED),
                               mask=valid)
        nb = transfer_nbytes(db)
        if self.stats is not None:
            self.stats.h2d_bytes += nb
            self.stats.h2d_logical_bytes += nb
        self.batches_shipped += 1
        self.rows_shipped += total
        self._send(0, db)

    def flush(self, wm):
        self._note_wm(wm)
        while any(self._rows) or any(ob.items for ob in self._items):
            before = (self.batches_shipped, self.rows_shipped)
            self._ship_one()
            if (self.batches_shipped, self.rows_shipped) == before:
                break   # never spin on an empty remainder


def _mask_view(batch: DeviceBatch, mask, keys=None) -> DeviceBatch:
    """One destination's batch of a mask-only fan-out: the SAME payload,
    ts (and keys) tensors, its own validity mask.  Consumers never write
    into these tensors, so siblings stay intact."""
    return DeviceBatch(batch.payload, batch.ts, mask, keys=keys,
                       watermark=batch.watermark, size=None,
                       frontier=batch.frontier, ts_max=batch.ts_max,
                       ts_min=batch.ts_min, trace=batch.trace)


class DevicePassEmitter(Emitter):
    """Device→device edge: batches move by handle (no copies): round-robin
    over destinations, or to every destination under BROADCAST."""

    can_emit_host_items = False

    def __init__(self, dests, routing: RoutingMode = RoutingMode.FORWARD):
        super().__init__(dests, output_batch_size=0)
        self.routing = routing
        self._next = 0

    def emit_device_batch(self, batch: DeviceBatch):
        if self.routing == RoutingMode.BROADCAST:
            for d in range(len(self.dests)):
                self._send(d, batch)
            return
        d = self._next
        self._next = (self._next + 1) % len(self.dests)
        self._send(d, batch)


class DeviceKeyByEmitter(Emitter):
    """Device→device KEYBY edge (reference GPU→GPU ``KeyBy_Emitter_GPU``,
    ``keyby_emitter_gpu.hpp:519-583``): ``dest = where(valid,
    splitmix64(key) mod n, n)`` and one mask ``dest == d`` a destination,
    all over the same payload/ts/keys tensors.  No sort, gather or host
    read; empty partitions still ship (an all-invalid mask), since
    skipping them would need the partition counts on the host.  The
    batch's keys lane (a chain forwarding them) is used when present.
    With a compactor attached (an evictable one at parallelism > 1), a
    slotted key goes to ``slot % n`` instead, the keyed staging
    emitter's placement.  With a shard sketch attached, the split also
    updates the sketch's device state in place (``device_sketch_update``:
    a few ``index_add_`` passes, no host read)."""

    can_emit_host_items = False

    def __init__(self, dests, key_extractor):
        super().__init__(dests, output_batch_size=0)
        self.key_extractor = key_extractor
        self._compactor = None
        #: shard-plane sketch and its device state (made at the first
        #: sketched batch); None leaves one check a batch
        self._sketch = None
        self._sk_state = None
        #: the split's handle in the step registry (a non-hop program)
        self._watch = None

    def attach_compactor(self, comp) -> None:
        """The remap placement override (graph build): the compactor's
        tables ride the split as two read-only operands."""
        self._compactor = comp

    def attach_shard_sketch(self, sketch) -> None:
        """Fold the shard-plane sketch update into the split (graph
        build); the ledger reads the state at stats cadence."""
        self._sketch = sketch
        sketch.register_device_state(lambda: self._sk_state)

    def split(self, batch: DeviceBatch):
        """``(keys, masks)``: the int32 key lane and one bool mask a
        destination."""
        import torch
        from windflow_tpu_torch.utils.tree import per_record
        n = len(self.dests)
        keys = batch.keys
        if keys is None:
            keys = per_record(self.key_extractor, batch.payload,
                              batch.capacity).to(torch.int32)
        h = place_torch(keys, n)
        if self._compactor is not None:
            from windflow_tpu_torch.parallel.compaction import lookup_slots
            tk, tsl = self._compactor.tables()
            slot, hit = lookup_slots(tk, tsl, keys, batch.valid)
            h = torch.where(hit, (slot % n).to(h.dtype), h)
        dest = torch.where(batch.valid, h, n)
        if self._sketch is not None:
            from windflow_tpu_torch.monitoring.shard_ledger import (
                device_sketch_init, device_sketch_update)
            if self._sk_state is None:
                self._sk_state = device_sketch_init(n, keys.device)
            device_sketch_update(self._sk_state, keys, batch.valid, n,
                                 dest=dest)
        return keys, [dest == d for d in range(n)]

    def emit_device_batch(self, batch):
        w = self._watch
        if w is None:
            from windflow_tpu_torch.monitoring.jit_registry import \
                default_registry
            w = self._watch = default_registry().watch(
                "emitter.device_keyby_split")
        w.note()
        keys, masks = self.split(batch)
        for d, mask in enumerate(masks):
            self._send(d, _mask_view(batch, mask, keys))


class DeviceToHostEmitter(Emitter):
    """Device→host boundary: the batch comes back in one packed copy
    (``device_to_host``) and the whole HostBatch goes through the inner
    host emitter (per tuple only under KEYBY)."""

    def __init__(self, inner: Emitter):
        super().__init__(inner.dests, inner.output_batch_size)
        self.inner = inner

    def bind_observability(self, stats, ring=None, flight=None):
        super().bind_observability(stats, ring, flight)
        self.inner.bind_observability(stats, ring, flight)

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
                   src_is_gpu: bool, dst_is_gpu: bool, device,
                   key_extractor: Optional[Callable] = None,
                   mesh=None) -> Emitter:
    """Pick the emitter for an edge from (routing, src-on-device,
    dst-on-device), mirroring the reference's dispatch
    (``multipipe.hpp:236-350``)."""
    if dst_is_gpu:
        dst_op = dests[0][0].op if dests else None
        if mesh is not None and not src_is_gpu \
                and routing == RoutingMode.KEYBY \
                and key_extractor is not None \
                and getattr(dst_op, "_ingest_mode", None) == "aligned":
            # key-aligned mesh ingest (mesh.mark_aligned_ingest): each
            # record stages straight onto its key owner's column
            from windflow_tpu_torch.parallel.mesh import _aligned_slot_bound
            return AlignedMeshStageEmitter(dests, output_batch_size,
                                           key_extractor, mesh,
                                           _aligned_slot_bound(dst_op),
                                           device=device)
        if routing == RoutingMode.KEYBY and len(dests) > 1 \
                and key_extractor is not None:
            # each key's tuples reach one replica, in arrival order
            if src_is_gpu:
                return DeviceKeyByEmitter(dests, key_extractor)
            return KeyedDeviceStageEmitter(dests, output_batch_size,
                                           key_extractor, device, mesh=mesh)
        if src_is_gpu:
            return DevicePassEmitter(dests, routing)
        return DeviceStageEmitter(dests, output_batch_size, device,
                                  mesh=mesh)
    if src_is_gpu and routing != RoutingMode.KEYBY and dests \
            and all(getattr(r.op, "columnar", False) for r, _ in dests):
        # columnar sinks consume DeviceBatches whole (bulk copy inside
        # the sink replica); keyed ones take the record path below
        return DevicePassEmitter(dests, routing)
    if routing == RoutingMode.KEYBY:
        inner = KeyByEmitter(dests, output_batch_size, key_extractor)
    elif routing == RoutingMode.BROADCAST:
        inner = BroadcastEmitter(dests, output_batch_size)
    else:
        inner = ForwardEmitter(dests, output_batch_size)
    if src_is_gpu:
        return DeviceToHostEmitter(inner)
    return inner


class SplittingEmitter(Emitter):
    """A MultiPipe split point (reference ``splitting_emitter.hpp``): the
    user function maps a tuple to one branch index or an iterable of
    them; one inner emitter a branch.

    A device batch takes the mask-only split (reference
    ``Splitting_Emitter_GPU``, ``splitting_emitter_gpu.hpp:53``) when the
    split function, handed the batch's column dict, returns an integer
    ``[capacity]`` lane: every branch then shares the same buffers with a
    mask of its own.  Whether it does is probed once on ``meta`` tensors
    (no device work; a function that fails there takes the host route).
    A Python-level or multicast split function takes the host per-tuple
    route, which refuses to hand a tuple to a device-only branch."""

    def __init__(self, split_fn: Callable, branch_emitters: Sequence[Emitter]):
        super().__init__([], output_batch_size=0)
        self.split_fn = split_fn
        self.branches = list(branch_emitters)
        #: capacity -> True (mask split) / False (host route)
        self._device_split = {}

    def bind_observability(self, stats, ring=None, flight=None):
        super().bind_observability(stats, ring, flight)
        for b in self.branches:
            b.bind_observability(stats, ring, flight)

    def emit(self, item, ts, wm, shared=False, tid=None):
        self._route(item, ts, wm, self.split_fn(item), shared, tid)

    def _route(self, item, ts, wm, dest, shared, tid):
        if isinstance(dest, (int, np.integer)):
            self.branches[int(dest)].emit(item, ts, wm, shared, tid=tid)
            return
        dest = list(dest)
        # multicast: every branch sees the same object, marked shared so
        # in-place consumers copy it first
        multi = shared or len(dest) > 1
        for d in dest:
            # the copies need distinct origin ids if a DETERMINISTIC stage
            # merges the branches again
            btid = tid + (-1, d) if tid is not None else None
            self.branches[d].emit(item, ts, wm, multi, tid=btid)

    def _splits_on_device(self, batch: DeviceBatch) -> bool:
        import torch
        from windflow_tpu_torch.utils.tree import tree_map
        ok = self._device_split.get(batch.capacity)
        if ok is None:
            meta = tree_map(lambda a: torch.empty_like(a, device="meta"),
                            batch.payload)
            try:
                out = self.split_fn(meta)
                ok = (isinstance(out, torch.Tensor)
                      and tuple(out.shape) == (batch.capacity,)
                      and not out.dtype.is_floating_point
                      and out.dtype != torch.bool
                      and not out.dtype.is_complex)
            except Exception:  # lint: broad-except-ok (a probe of a user
                # function: any failure means the host route)
                ok = False
            self._device_split[batch.capacity] = ok
        return ok

    def split_masks(self, batch: DeviceBatch):
        """One mask a branch: ``where(valid, split_fn(payload), n) == b``."""
        import torch
        n = len(self.branches)
        idx = self.split_fn(batch.payload).to(torch.int32)
        dest = torch.where(batch.valid, idx, n)
        return [dest == b for b in range(n)]

    def emit_device_batch(self, batch: DeviceBatch):
        if self._splits_on_device(batch):
            for b, mask in enumerate(self.split_masks(batch)):
                self.branches[b].emit_device_batch(_mask_view(batch, mask))
            return
        # host route: a device-only branch may not be handed a tuple, but
        # only a tuple actually routed there is an error
        host_ok = [em.can_emit_host_items for em in self.branches]
        hb = device_to_host(batch)
        for item, ts in zip(hb.items, hb.tss):
            dest = self.split_fn(item)
            if not isinstance(dest, (int, np.integer)):
                dest = list(dest)
            for b in ((dest,) if isinstance(dest, (int, np.integer))
                      else dest):
                if not host_ok[int(b)]:
                    raise WindFlowError(
                        "split after a GPU stage routed a tuple to a GPU "
                        f"branch (branch {int(b)}) through the host route, "
                        "so the split function must evaluate on the "
                        "batch's columns (torch ops) and return one branch "
                        "a tuple (got a Python-level or multicast split "
                        "function); make it a torch expression or insert "
                        "a host stage before the GPU branch")
            self._route(item, ts, hb.watermark, dest, False, None)

    def propagate_punctuation(self, wm):
        for b in self.branches:
            b.propagate_punctuation(wm)

    def flush(self, wm):
        for b in self.branches:
            b.flush(wm)
