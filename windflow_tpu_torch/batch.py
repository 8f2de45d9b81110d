"""Data plane: stream messages as batches (the port of
``windflow_tpu/batch.py``).

* :class:`HostBatch` — host records with a parallel timestamp list and a
  scalar watermark (reference ``Batch_CPU_t``).
* :class:`DeviceBatch` — a structure-of-arrays dict of tensors with a
  static leading capacity, an int64 timestamp lane and a bool validity
  mask (reference ``Batch_GPU_t``).  Static capacity + mask keeps every
  step at one shape.

Staging packs every lane of a batch into one uint32 host buffer
(``staging.PackedBatchBuilder``), moves it with ONE ``non_blocking`` copy,
and re-types the lanes on the device with ``.view(dtype)``.  Egress packs
the lanes on the device and moves them back with one copy, from a card
into a page-locked host buffer that each thread reuses.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

from windflow_tpu_torch import staging
from windflow_tpu_torch.utils.dtypes import numpy_dtype, torch_dtype
from windflow_tpu_torch.utils.tree import (tree_flatten, tree_leaves,
                                           tree_map, tree_unflatten)

#: Watermark value meaning "no watermark yet".
WM_NONE = -1
#: Watermark value attached to the end-of-stream punctuation.
WM_MAX = (1 << 62)


@dataclasses.dataclass
class Punctuation:
    """Control message carrying only a watermark; ``WM_MAX`` marks
    end-of-stream."""

    watermark: int

    @property
    def is_eos(self) -> bool:
        return self.watermark >= WM_MAX


@dataclasses.dataclass
class HostBatch:
    """A batch of host-resident records (reference ``Batch_CPU_t``)."""

    items: list
    tss: list
    watermark: int = WM_NONE
    #: optional per-item origin ids (DETERMINISTIC tie-breaking)
    ids: list = None
    #: True when the batch object is multicast to several inboxes
    shared: bool = False
    #: flight-recorder trace lane: ``(trace_id, t_origin_usec)`` on the
    #: 1-in-N sampled batch, None otherwise (monitoring/recorder.py).
    #: Whole-batch paths relay it; host per-tuple stages start fresh
    #: traces at their emitter
    trace: tuple = None

    def __len__(self) -> int:
        return len(self.items)

    def ids_or_nones(self):
        return self.ids if self.ids is not None \
            else (None,) * len(self.items)


class DeviceBatch:
    """A batch resident on the device as a structure of arrays.

    ``payload`` is a pytree of tensors with leading dim ``capacity``;
    ``ts`` int64 ``[capacity]``; ``valid`` bool ``[capacity]``.
    ``watermark`` is the min-folded stamp safe to propagate; ``frontier``
    the newest watermark at staging (valid only for the consumer's own
    place-then-fire decision).  ``ts_min``/``ts_max`` are the data
    timestamp extrema of the staged lanes, known on the host at staging
    (``None`` for device-born batches): outer bounds that stay valid
    through mask-only stages, which the time-window ring sizes itself
    from without reading the device.  ``keys`` is the optional int32
    ``[capacity]`` key lane of a KEYBY edge: the producer extracted the
    consumer's keys from THESE records (a chain forwarding them, a device
    keyby split), so the consumer need not extract them again.  It is
    edge-scoped: a stage that rewrites the records drops it.  ``trace``
    is the flight recorder's lane, ``(trace_id, t_origin_usec)`` on a
    sampled batch (host metadata: it never touches the device)."""

    __slots__ = ("payload", "ts", "valid", "keys", "watermark", "_frontier",
                 "_size", "ts_max", "ts_min", "trace")

    def __init__(self, payload, ts, valid, watermark: int = WM_NONE,
                 size: Optional[int] = None, frontier: Optional[int] = None,
                 ts_max: Optional[int] = None,
                 ts_min: Optional[int] = None, keys=None,
                 trace: Optional[tuple] = None):
        self.payload = payload
        self.ts = ts
        self.valid = valid
        self.keys = keys
        self.watermark = watermark
        self._frontier = frontier
        self._size = size
        self.ts_max = ts_max
        self.ts_min = ts_min
        self.trace = trace

    @property
    def frontier(self) -> int:
        if self._frontier is None:
            return self.watermark
        return max(self._frontier, self.watermark)

    @property
    def size(self) -> int:
        """Number of valid items (a device sync when not known)."""
        if self._size is None:
            self._size = int(self.valid.sum())
        return self._size

    @property
    def known_size(self) -> Optional[int]:
        return self._size

    @property
    def capacity(self) -> int:
        return int(self.valid.shape[0])

    def __len__(self) -> int:
        return self.size


def transfer_nbytes(batch: DeviceBatch) -> int:
    """Whole-batch transfer size (payload + ts + valid lanes)."""
    def nb(t):
        return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
            else 0
    return sum(nb(l) for l in tree_leaves(batch.payload)) \
        + nb(batch.ts) + nb(batch.valid)


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------

def _stack_records(items: Sequence[Any]):
    """Per-record pytrees -> one SoA pytree of numpy arrays.  Flat dicts
    of scalars (the common record) take a column-at-a-time path: the
    generic one walks every record's tree in Python."""
    first = items[0]
    if isinstance(first, dict) and not any(
            isinstance(v, (dict, list, tuple)) for v in first.values()):
        return {k: np.asarray([it[k] for it in items]) for k in first}
    _, treedef = tree_flatten(items[0])
    leaves = [tree_flatten(it)[0] for it in items]
    cols = [np.asarray(col) for col in zip(*leaves)]
    return tree_unflatten(treedef, cols)


def _pad_leading(arr: np.ndarray, capacity: int) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    pad = [(0, capacity - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def unpack_body(dtypes, capacity: int, wire=None):
    """The device unpack of one packed staging buffer (int32 words):
    ``b -> (payload_cols, ts, valid)``.  4-byte lanes are bit views of
    the buffer; 8-byte integer lanes are rebuilt from their lo/hi words;
    the validity mask comes from the trailing fill-count word, on the
    device (no extra transfer).  ``wire`` (a ``wire.WireFormat``) marks
    a wire-compressed buffer: its columnar decode
    (``wire.build_wire_decode``) runs ahead of the mask derivation.  The
    megastep (``megastep.py``) runs this same body inside its group."""
    if wire is not None:
        from windflow_tpu_torch.wire import build_wire_decode
        decode = build_wire_decode(wire, dtypes, capacity)
    else:
        specs = [np.dtype(dt) for dt in tuple(dtypes) + ("int64",)]

        def decode(b: torch.Tensor):
            cols, off = [], 0
            for d in specs:
                if d.itemsize == 8:
                    seg = b[off:off + 2 * capacity]
                    lo = seg[0::2].to(torch.int64) & 0xFFFFFFFF
                    hi = seg[1::2].to(torch.int64)
                    v = (hi << 32) | lo
                    cols.append(v if d == np.int64
                                else v.view(torch_dtype(d)))
                    off += 2 * capacity
                else:
                    cols.append(b[off:off + capacity].view(torch_dtype(d)))
                    off += capacity
            return cols

    def unpack_fn(b: torch.Tensor):
        cols = decode(b)
        valid = torch.arange(capacity, dtype=torch.int32,
                             device=b.device) < b[-1]
        return cols[:-1], cols[-1], valid
    return unpack_fn


def stage_packed(buf: np.ndarray, treedef, dtypes, capacity: int, n: int,
                 device, watermark: int = WM_NONE,
                 frontier: Optional[int] = None,
                 ts_max: Optional[int] = None, ts_min: Optional[int] = None,
                 pool=None, wire=None, trace: Optional[tuple] = None,
                 logical_nbytes: Optional[int] = None) -> DeviceBatch:
    """ONE host→device copy of a packed staging buffer into a
    DeviceBatch.  For a CUDA target the copy is ``non_blocking`` from
    pinned memory and ``buf`` is recycled gated on an event recorded
    after it; for the CPU the words are copied out before recycling.
    ``wire`` marks ``buf`` as wire-compressed: its decode runs in the
    unpack.  The transfer is credited to ``staging.device_bytes``
    (``logical_nbytes``: the decoded size of a wire buffer)."""
    staging.device_bytes.note(buf.nbytes, logical_nbytes)
    hbuf = torch.from_numpy(buf.view(np.int32))
    gate = None
    if device.type == "cuda":
        dbuf = hbuf.to(device, non_blocking=True)
        gate = torch.cuda.Event()
        gate.record(torch.cuda.current_stream(device))
    else:
        dbuf = hbuf.clone()
    cols, ts, valid = unpack_body(dtypes, capacity, wire=wire)(dbuf)
    if pool is not None:
        pool.release(buf, gate=gate)
    return DeviceBatch(tree_unflatten(treedef, cols), ts, valid,
                       watermark=watermark, size=n, frontier=frontier,
                       ts_max=ts_max, ts_min=ts_min, trace=trace)


def _stage_soa(soa, tss, n: int, capacity: int, watermark: int,
               device, frontier: Optional[int] = None,
               trace: Optional[tuple] = None,
               mask: Optional[np.ndarray] = None) -> DeviceBatch:
    """Pad an SoA numpy pytree + timestamps to ``capacity`` and stage it.
    Packable 1-D lanes ride one packed copy; anything else goes lane by
    lane.  The data timestamp extrema ride along as host metadata
    (``DeviceBatch.ts_min``/``ts_max``).  ``mask`` is a host validity
    mask of ``capacity`` rows for lanes laid out with holes (``n`` its
    count); it rides the packed copy as one more int32 lane."""
    tss = np.asarray(tss, dtype=np.int64)
    live = tss[:n] if mask is None else tss[mask]
    ts_max = int(live.max()) if n else None
    ts_min = int(live.min()) if n else None
    tree = soa if mask is None else (soa, mask.astype(np.int32))
    leaves, treedef = tree_flatten(tree)
    if all(l.ndim == 1 and staging.packable_dtype(l.dtype) for l in leaves):
        dtypes = tuple(str(np.dtype(l.dtype)) for l in leaves)
        pool = staging.pool_for(device)
        b = staging.PackedBatchBuilder(dtypes, capacity, pool=pool)
        b.append(leaves, tss)
        out = stage_packed(b.finish(), treedef, dtypes, capacity, n,
                           device, watermark=watermark, frontier=frontier,
                           ts_max=ts_max, ts_min=ts_min, pool=pool,
                           trace=trace)
        if mask is not None:
            out.payload, on = out.payload
            out.valid = on != 0
        return out

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(
            _pad_leading(a, capacity))).to(device)
    payload = tree_map(lambda a: put(np.asarray(a)), soa)
    ts = put(tss)
    valid = (torch.arange(capacity, device=device) < n if mask is None
             else put(mask))
    out = DeviceBatch(payload, ts, valid, watermark=watermark, size=n,
                      frontier=frontier, ts_max=ts_max, ts_min=ts_min,
                      trace=trace)
    staging.device_bytes.note(transfer_nbytes(out))
    return out


def host_to_device(batch: HostBatch, capacity: Optional[int], device,
                   frontier: Optional[int] = None,
                   trace: Optional[tuple] = None) -> DeviceBatch:
    """Stage a HostBatch into device buffers, padding to ``capacity``."""
    n = len(batch)
    if n == 0:
        raise ValueError("cannot stage an empty batch")
    cap = capacity or n
    if n > cap:
        raise ValueError(f"batch of {n} items exceeds capacity {cap}")
    return _stage_soa(_stack_records(batch.items), batch.tss, n, cap,
                      batch.watermark, device, frontier,
                      trace if trace is not None else batch.trace)


def columns_to_device(cols, tss, capacity: int, device,
                      watermark: int = WM_NONE,
                      frontier: Optional[int] = None,
                      trace: Optional[tuple] = None,
                      mask: Optional[np.ndarray] = None) -> DeviceBatch:
    """Stage columnar (SoA numpy) data directly into a DeviceBatch.
    ``mask``: the columns hold ``capacity`` rows laid out with holes and
    this host mask marks the valid ones."""
    n = len(tss) if mask is None else int(np.count_nonzero(mask))
    if n == 0:
        raise ValueError("cannot stage an empty column batch")
    if n > capacity or (mask is not None and len(tss) != capacity):
        raise ValueError(f"column batch of {n} exceeds capacity {capacity}")
    return _stage_soa(dict(cols), tss, n, capacity, watermark, device,
                      frontier, trace, mask)


# ---------------------------------------------------------------------------
# device -> host
# ---------------------------------------------------------------------------

def _egress_packable(batch: DeviceBatch) -> bool:
    cap = batch.capacity
    return all(isinstance(l, torch.Tensor) and l.ndim == 1
               and l.shape[0] == cap
               and (l.dtype == torch.bool or l.element_size() in (4, 8))
               for l in tree_leaves(batch.payload))


def _to_words(t: torch.Tensor) -> torch.Tensor:
    """A lane as int32 words: bool widens to one word a row; 4-byte lanes
    are bit views; 8-byte lanes view as little-endian lo/hi pairs."""
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    return t.contiguous().view(torch.int32)


#: per thread, the page-locked int32 buffer a card's egress lands in
_egress_host = threading.local()


def _egress_buffer(words: int) -> torch.Tensor:
    """The calling thread's page-locked egress buffer, at least ``words``
    int32 words long (grown to the next power of two, kept for reuse):
    a copy into it runs at the link's speed, where a fresh pageable
    array is faulted in and filled through CUDA's own staging buffer
    on every delivery."""
    buf = getattr(_egress_host, "buf", None)
    if buf is None or buf.shape[0] < words:
        size = 1 << max(20, (words - 1).bit_length())
        buf = torch.empty(size, dtype=torch.int32, pin_memory=True)
        _egress_host.buf = buf
    return buf


def _egress_unpack(raw: np.ndarray, specs, treedef, cap: int,
                   n: Optional[int], reused: bool = False):
    """One batch's columns from its packed words.  ``reused``: ``raw``
    views a buffer the next delivery overwrites, so every column is
    copied out of it (a gather copies anyway)."""
    def take(off, d):
        if d == np.bool_:
            return raw[off:off + cap].astype(np.bool_), off + cap
        w = 2 if d.itemsize == 8 else 1
        return raw[off:off + w * cap].view(d), off + w * cap

    off = 0
    cols_flat = []
    for d in specs:
        col, off = take(off, d)
        cols_flat.append(col)
    tss, off = take(off, np.dtype(np.int64))
    valid = raw[off:off + cap].astype(np.bool_)
    if n is not None and bool(valid[:n].all()):
        sel = slice(None, n)
        if reused:
            return (tree_unflatten(treedef, [c[sel].copy()
                                             for c in cols_flat]),
                    tss[sel].copy())
    else:
        sel = np.nonzero(valid)[0]
    return tree_unflatten(treedef, [c[sel] for c in cols_flat]), tss[sel]


def device_to_columns_multi(batches):
    """Columnar egress of several device batches in ONE device→host copy:
    each batch's lanes are packed into int32 words on the device and the
    packed buffers ride one concatenated copy, from a card into the
    thread's page-locked buffer.  Returns ``(cols, tss)`` per batch, in
    order; the arrays own their memory or view a fresh host copy."""
    out = [None] * len(batches)
    packed, metas = [], []
    for i, b in enumerate(batches):
        leaves, treedef = tree_flatten(b.payload)
        if not _egress_packable(b):
            out[i] = _columns_fallback(b)
            continue
        parts = [_to_words(l) for l in leaves]
        parts += [_to_words(b.ts), _to_words(b.valid)]
        buf = torch.cat(parts)
        specs = [numpy_dtype(l.dtype) for l in leaves]
        metas.append((i, treedef, specs, b.capacity, b.known_size,
                      buf.shape[0]))
        packed.append(buf)
    if packed:
        flat = packed[0] if len(packed) == 1 else torch.cat(packed)
        reused = flat.is_cuda
        if reused:
            host = _egress_buffer(flat.shape[0])[:flat.shape[0]]
            host.copy_(flat)                                  # ONE copy
            raw_all = host.numpy()
        else:
            raw_all = flat.cpu().numpy()
        off = 0
        for i, treedef, specs, cap, n, nwords in metas:
            out[i] = _egress_unpack(raw_all[off:off + nwords], specs,
                                    treedef, cap, n, reused)
            off += nwords
    return out


def device_to_columns(batch: DeviceBatch):
    """One batch's valid lanes as SoA numpy columns plus int64 ``tss``."""
    return device_to_columns_multi([batch])[0]


def _columns_fallback(batch: DeviceBatch):
    valid = batch.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    cols = tree_map(lambda a: a.cpu().numpy()[idx], batch.payload)
    return cols, batch.ts.cpu().numpy()[idx]


def device_to_host(batch: DeviceBatch) -> HostBatch:
    """Transfer a DeviceBatch back to host records, dropping padding
    slots (reference ``Batch_GPU_t::transfer2CPU``)."""
    cols, tss = device_to_columns(batch)
    tss = tss.tolist()
    if isinstance(cols, dict) and all(isinstance(c, np.ndarray)
                                      and c.ndim == 1
                                      for c in cols.values()):
        names = list(cols)
        items = [dict(zip(names, vals))
                 for vals in zip(*(cols[nm].tolist() for nm in names))]
        return HostBatch(items=items, tss=tss, watermark=batch.watermark,
                         trace=batch.trace)
    leaves, treedef = tree_flatten(cols)
    items = [tree_unflatten(treedef, [c[i].item() if c[i].ndim == 0
                                      else c[i] for c in leaves])
             for i in range(len(tss))]
    return HostBatch(items=items, tss=tss, watermark=batch.watermark,
                     trace=batch.trace)
