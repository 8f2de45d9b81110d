"""Wire plane: columnar compression of staged batches, decoded on the
card (the port of ``windflow_tpu/wire.py``).

The staging plane's packed buffer (``staging.PackedBatchBuilder``) is
re-encoded lane by lane with cheap columnar codecs before its one
host→device copy, and the inverse decode (:func:`build_wire_decode`,
torch ops on the int32 word tensor) runs ahead of the valid-mask
derivation in the same unpack (``batch.unpack_body``).  In eager
PyTorch the decode adds launches to the per-batch unpack; inside a
captured megastep (``megastep.py``) it rides the one graph launch.

Codecs (per lane, chosen every ``reseed_every`` batches from the data):

* ``raw``    — passthrough words (the fallback);
* ``const``  — all rows equal: 2 header words carry the value;
* ``delta``  — zigzag deltas bit-packed at 0/8/16/32 bits behind an
  int64 base (two's-complement wrap on both sides: exact over the whole
  int64 domain);
* ``delta2`` — delta-of-delta behind base + first delta;
* ``dict``   — a ≤64Ki-entry sorted value table + 8/16-bit indices.

A lane whose data stops fitting its codec ships raw for that batch
(counted) and the next batch reseeds.  Wire buffer layout, padded to a
:func:`staging.size_class` so the pool recycles across codec churn::

    [lane0 header+payload | lane1 ... | ts lane | pad ... | n]

The encoder is host numpy and gives the JAX package's wire words and
codec table for the same input.  Compression attaches (:func:`attach_wire`)
only to staging edges whose records have a declared or inferred spec
(a source's ``record_spec``, a ``DeviceSource``'s ``batch_fn``, carried
through the operators that keep records): the JAX package's preflight
verdict, so a spec-less edge ships raw (its WF606).
``Config.wire_compression`` is the switch: "auto" is on exactly when
the graph's device is CUDA.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from windflow_tpu_torch import staging

#: codec kind tags (descriptor fields are plain strings/ints so the
#: descriptor tuple is hashable — it keys the megastep's captured graph)
RAW, CONST, DELTA, DELTA2, DICT = "raw", "const", "delta", "delta2", "dict"

#: largest dictionary a lane may ship per batch (16-bit indices)
DICT_MAX = 1 << 16
#: dictionaries at/below this size pack 8-bit indices
DICT_SMALL = 1 << 8


class LaneCodec(NamedTuple):
    """Static per-lane codec descriptor: ``kind``, packed bits per
    element (``width`` in {0, 8, 16, 32}), and ``extra`` (padded dict
    table size; 0 otherwise).  Hashable — part of the megastep graph's
    cache key."""

    kind: str
    width: int = 32
    extra: int = 0


class WireFormat(NamedTuple):
    """Whole-buffer descriptor: one :class:`LaneCodec` per lane
    (payload lanes in order, then the implicit int64 ts lane) plus the
    size-class-padded word count of the wire buffer."""

    codecs: Tuple[LaneCodec, ...]
    words: int


RAW_CODEC = LaneCodec(RAW, 32, 0)


def _packed_words(count: int, width: int) -> int:
    if width == 0 or count <= 0:
        return 0
    per = 32 // width
    return (count + per - 1) // per


def lane_wire_words(codec: LaneCodec, dtype, capacity: int) -> int:
    """Static wire words one lane occupies under ``codec`` (headers are
    always int64 → 2 words each; dict entries are raw lane words)."""
    w = staging.lane_words(dtype)
    if codec.kind == RAW:
        return w * capacity
    if codec.kind == CONST:
        return 2
    if codec.kind == DELTA:
        return 2 + _packed_words(capacity - 1, codec.width)
    if codec.kind == DELTA2:
        return 4 + _packed_words(capacity - 2, codec.width)
    if codec.kind == DICT:
        return codec.extra * w + _packed_words(capacity, codec.width)
    raise ValueError(f"unknown lane codec kind {codec.kind!r}")


def wire_words_total(fmt_codecs, dtypes, capacity: int) -> int:
    """Unpadded wire words of a whole batch (+1 for the fill count)."""
    return 1 + sum(lane_wire_words(c, d, capacity)
                   for c, d in zip(fmt_codecs, dtypes))


# ---------------------------------------------------------------------------
# host-side encode (numpy, vectorized — runs once per staged batch)
# ---------------------------------------------------------------------------

def _zigzag(d: np.ndarray) -> np.ndarray:
    """Signed int64 deltas → unsigned zigzag (small magnitudes of either
    sign become small unsigned values).  Shift overflow wraps two's-
    complement, matching the device-side inverse exactly."""
    return ((d << 1) ^ (d >> 63)).astype(np.uint64)


def _width_for(zz_max: int) -> Optional[int]:
    if zz_max == 0:
        return 0
    if zz_max < (1 << 8):
        return 8
    if zz_max < (1 << 16):
        return 16
    if zz_max < (1 << 32):
        return 32
    return None


def _pack_width(vals: np.ndarray, width: int) -> np.ndarray:
    """Bit-pack uint32 values at ``width`` bits into little-endian
    uint32 words (byte-aligned widths only — the device unpack is a
    shift+mask, no cross-word fields)."""
    if width == 0 or len(vals) == 0:
        return np.empty(0, np.uint32)
    if width == 32:
        return np.ascontiguousarray(vals, np.uint32)
    per = 32 // width
    words = np.zeros((len(vals) + per - 1) // per, np.uint32)
    view = words.view(np.uint8 if width == 8 else np.uint16)
    view[:len(vals)] = vals.astype(view.dtype)
    return words


def _i64_header(v: int) -> List[np.ndarray]:
    """An int64 header value as [lo, hi] uint32 words (python-int
    masking: exact for the full signed domain)."""
    v = int(v)
    return [np.array([v & 0xFFFFFFFF], np.uint32),
            np.array([(v >> 32) & 0xFFFFFFFF], np.uint32)]


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (max(1, n) - 1).bit_length())


class _LaneState:
    """Per-lane encoder state: the current codec choice plus the dict
    table it was chosen with (tables stay stable between reseeds so the
    per-batch fit check is one searchsorted pass)."""

    __slots__ = ("codec", "table")

    def __init__(self) -> None:
        self.codec: Optional[LaneCodec] = None
        self.table: Optional[np.ndarray] = None


class WireStats:
    """Wire-plane counters for ``stats()["Staging"]["Wire"]`` and the
    OpenMetrics ``wf_wire_*`` families.  Plain int adds (telemetry
    tolerance of the staging plane's other counters)."""

    __slots__ = ("batches", "raw_batches", "fallback_lanes", "reseeds",
                 "logical_bytes", "wire_bytes", "encode_usec")

    def __init__(self) -> None:
        self.batches = 0          # compressed batches shipped
        self.raw_batches = 0      # batches where compression lost
        self.fallback_lanes = 0   # per-batch codec misfits (lane → raw)
        self.reseeds = 0
        self.logical_bytes = 0    # decoded bytes (what raw would ship)
        self.wire_bytes = 0       # bytes actually transferred
        self.encode_usec = 0.0

    def merge(self, other: "WireStats") -> None:
        self.batches += other.batches
        self.raw_batches += other.raw_batches
        self.fallback_lanes += other.fallback_lanes
        self.reseeds += other.reseeds
        self.logical_bytes += other.logical_bytes
        self.wire_bytes += other.wire_bytes
        self.encode_usec += other.encode_usec

    def to_json(self) -> dict:
        ratio = (round(self.logical_bytes / self.wire_bytes, 4)
                 if self.wire_bytes else None)
        return {
            "batches": self.batches,
            "raw_batches": self.raw_batches,
            "fallback_lanes": self.fallback_lanes,
            "reseeds": self.reseeds,
            "logical_bytes": self.logical_bytes,
            "wire_bytes": self.wire_bytes,
            "compression_ratio": ratio,
            "encode_usec": round(self.encode_usec, 1),
        }


class WireEncoder:
    """Per-emitter lane encoder: turns one finished logical staging
    buffer into a (usually much smaller) wire buffer + its
    :class:`WireFormat`.  Codec choice per lane is re-evaluated every
    ``reseed_every`` encoded batches; in between, each batch pays one
    vectorized fit-check+encode pass per lane.  A batch compression
    cannot shrink ships the logical buffer unchanged (``fmt=None``)."""

    def __init__(self, dtypes: Sequence, capacity: int,
                 reseed_every: int = 64) -> None:
        self.dtypes = tuple(np.dtype(d) for d in dtypes) \
            + (np.dtype(np.int64),)             # + implicit ts lane
        self.capacity = capacity
        self.reseed_every = max(1, reseed_every)
        self._lane_words = [staging.lane_words(d) for d in self.dtypes]
        self._offsets = []
        off = 0
        for w in self._lane_words:
            self._offsets.append(off)
            off += w * capacity
        self._logical_words = off + 1
        self._lanes = [_LaneState() for _ in self.dtypes]
        self._since = self.reseed_every     # force choice on first batch
        self.stats = WireStats()

    # -- lane value views ---------------------------------------------------
    def _values(self, buf: np.ndarray, i: int) -> np.ndarray:
        """Lane ``i`` of the logical buffer as int64 work values (signed
        interpretation for 4-byte lanes; lo/hi recombined for 8-byte) —
        the exact domain the device decode reconstructs."""
        off, w = self._offsets[i], self._lane_words[i]
        seg = buf[off:off + w * self.capacity]
        if w == 1:
            return seg.view(np.int32).astype(np.int64)
        lo = seg[0::2].astype(np.uint64)
        hi = seg[1::2].astype(np.uint64)
        return (lo | (hi << np.uint64(32))).view(np.int64)

    def _raw_words(self, buf: np.ndarray, i: int) -> np.ndarray:
        off, w = self._offsets[i], self._lane_words[i]
        return buf[off:off + w * self.capacity]

    # -- codec selection (reseed cadence) -----------------------------------
    def _choose(self, v: np.ndarray, i: int) -> None:
        st = self._lanes[i]
        dt = self.dtypes[i]
        cap = self.capacity
        best, best_w = RAW_CODEC, lane_wire_words(RAW_CODEC, dt, cap)
        prev_table = st.table if (st.codec is not None
                                  and st.codec.kind == DICT) else None
        st.table = None
        if cap >= 1 and bool((v == v[0]).all()):
            c = LaneCodec(CONST)
            w = lane_wire_words(c, dt, cap)
            if w < best_w:
                best, best_w = c, w
        if cap >= 2:
            d = np.diff(v)
            wd = _width_for(int(_zigzag(d).max()))
            if wd is not None:
                c = LaneCodec(DELTA, wd)
                w = lane_wire_words(c, dt, cap)
                if w < best_w:
                    best, best_w = c, w
            if cap >= 3:
                wdd = _width_for(int(_zigzag(np.diff(d)).max()))
                if wdd is not None:
                    c = LaneCodec(DELTA2, wdd)
                    w = lane_wire_words(c, dt, cap)
                    if w < best_w:
                        best, best_w = c, w
        uniq = np.unique(v)
        if prev_table is not None:
            # UNION with the previous table: a low-cardinality lane
            # whose batches sample the value space converges on the
            # full set instead of flip-flopping dict→raw per batch —
            # each flip would mint a new descriptor and recapture the
            # decode; the pow2 padding usually keeps the grown table's
            # descriptor (and its captured graph) stable
            uniq = np.unique(np.concatenate([prev_table, uniq]))
        if len(uniq) <= DICT_MAX:
            padded = _pow2ceil(len(uniq))
            c = LaneCodec(DICT, 8 if padded <= DICT_SMALL else 16, padded)
            w = lane_wire_words(c, dt, cap)
            if w < best_w:
                best, best_w = c, w
                st.table = np.concatenate(
                    [uniq, np.full(padded - len(uniq), uniq[-1],
                                   np.int64)])
        st.codec = best

    # -- per-batch encode ---------------------------------------------------
    def _encode_lane(self, buf, v: np.ndarray,
                     i: int) -> Tuple[List[np.ndarray], LaneCodec]:
        """Encode lane ``i`` under its current codec; a misfit (data
        stopped matching the choice) degrades to raw for this batch and
        forces a reseed at the next."""
        st = self._lanes[i]
        c = st.codec or RAW_CODEC
        out = self._try_encode(buf, v, i, c, st)
        if out is not None:
            return out, c
        self.stats.fallback_lanes += 1
        self._since = self.reseed_every     # re-choose next batch
        return [self._raw_words(buf, i)], RAW_CODEC

    def _try_encode(self, buf, v, i, c: LaneCodec,
                    st: _LaneState) -> Optional[List[np.ndarray]]:
        if c.kind == RAW:
            return [self._raw_words(buf, i)]
        if c.kind == CONST:
            if not bool((v == v[0]).all()):
                return None
            return _i64_header(v[0])
        if c.kind == DELTA:
            d = np.diff(v)
            zz = _zigzag(d)
            if len(zz) and int(zz.max()) >= (1 << max(1, c.width)):
                return None
            if c.width == 0 and len(zz) and int(zz.max()) != 0:
                return None
            return _i64_header(v[0]) \
                + [_pack_width(zz.astype(np.uint32), c.width)]
        if c.kind == DELTA2:
            d = np.diff(v)
            dd = np.diff(d)
            zz = _zigzag(dd)
            if len(zz) and int(zz.max()) >= (1 << max(1, c.width)):
                return None
            if c.width == 0 and len(zz) and int(zz.max()) != 0:
                return None
            return _i64_header(v[0]) + _i64_header(d[0] if len(d) else 0) \
                + [_pack_width(zz.astype(np.uint32), c.width)]
        if c.kind == DICT:
            table = st.table
            if table is None:
                return None
            idx = np.searchsorted(table, v)
            idx = np.clip(idx, 0, len(table) - 1)
            if not bool((table[idx] == v).all()):
                return None
            w = self._lane_words[i]
            if w == 1:
                tw = (table & np.int64(0xFFFFFFFF)).astype(np.uint32)
            else:
                u = table.view(np.uint64)
                tw = np.empty(2 * len(table), np.uint32)
                tw[0::2] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                tw[1::2] = (u >> np.uint64(32)).astype(np.uint32)
            return [tw, _pack_width(idx.astype(np.uint32), c.width)]
        return None

    def encode(self, buf: np.ndarray,
               pool=None) -> Tuple[np.ndarray, Optional[WireFormat]]:
        """Encode one FINISHED logical staging buffer (tail zeroed, fill
        count stamped at ``buf[-1]``).  Returns ``(wire_buf, fmt)`` —
        the wire buffer is acquired from ``pool`` at its size class and
        ``buf`` is released back (host-only use, no gate) — or
        ``(buf, None)`` when compression would not shrink the transfer
        (the caller ships the logical buffer exactly as before)."""
        t0 = time.perf_counter()
        if buf.shape[0] != self._logical_words:
            # capacity drift (defensive): ship raw rather than corrupt
            return buf, None
        if self._since >= self.reseed_every:
            for i in range(len(self.dtypes)):
                self._choose(self._values(buf, i), i)
            self._since = 0
            self.stats.reseeds += 1
        self._since += 1
        parts: List[List[np.ndarray]] = []
        used: List[LaneCodec] = []
        total = 1
        for i in range(len(self.dtypes)):
            st = self._lanes[i]
            # raw lanes copy words straight through: no int64 lift, no
            # fit check — the steady-state cost of an incompressible
            # lane is one memcpy, nothing more
            v = None if (st.codec is None or st.codec.kind == RAW) \
                else self._values(buf, i)
            arrs, c = self._encode_lane(buf, v, i)
            parts.append(arrs)
            used.append(c)
            total += lane_wire_words(c, self.dtypes[i], self.capacity)
        padded = staging.size_class(total)
        if padded >= self._logical_words:
            # compression lost: the logical buffer ships unchanged —
            # accrue it at FULL size on both counters so the reported
            # compression_ratio is the blended transfer truth, not the
            # compressed-batches-only flatter (the honesty contract)
            self.stats.raw_batches += 1
            self.stats.wire_bytes += self._logical_words * 4
            self.stats.logical_bytes += self._logical_words * 4
            self.stats.encode_usec += (time.perf_counter() - t0) * 1e6
            return buf, None
        wire = pool.acquire(padded) if pool is not None \
            else np.empty(padded, np.uint32)
        off = 0
        for arrs in parts:
            for a in arrs:
                wire[off:off + len(a)] = a
                off += len(a)
        # pad gap is never read by the decode; recycled buffers
        # arrive with undefined contents anyway (StagingPool contract)
        wire[-1] = buf[-1]
        if pool is not None:
            pool.release(buf, None)     # host-only scratch: no gate
        self.stats.batches += 1
        self.stats.logical_bytes += self._logical_words * 4
        self.stats.wire_bytes += padded * 4
        self.stats.encode_usec += (time.perf_counter() - t0) * 1e6
        return wire, WireFormat(tuple(used), padded)

    def codec_table(self) -> list:
        """Current per-lane codec choices (stats surface)."""
        return [{"lane": i, "dtype": str(d),
                 "codec": (st.codec.kind if st.codec else "unseeded"),
                 "width": (st.codec.width if st.codec else None),
                 "dict_size": (st.codec.extra if st.codec else 0)}
                for i, (d, st) in enumerate(zip(self.dtypes, self._lanes))]


# ---------------------------------------------------------------------------
# device-side decode (torch ops, inlined into batch.unpack_body)
# ---------------------------------------------------------------------------

_LO32 = 0xFFFFFFFF


def build_wire_decode(fmt: WireFormat, dtypes, capacity: int):
    """Inverse of :class:`WireEncoder` on the card: maps the int32 wire
    word tensor to the typed payload columns + the int64 ts lane, for
    ``batch.unpack_body`` to run ahead of its valid-mask derivation.
    ``dtypes`` are the payload lane dtypes; the ts lane is implicit.

    torch has no uint32 arithmetic on CUDA, so every word is widened to
    int64 and masked to its 32 bits (``& 0xFFFFFFFF``) before a shift:
    the shifts are then logical.  delta/delta2 rebuild values with an
    int64 ``cumsum`` that wraps two's-complement, as the encoder's numpy
    arithmetic does."""
    import torch

    from windflow_tpu_torch.utils.dtypes import torch_dtype

    all_dts = tuple(np.dtype(d) for d in dtypes) + (np.dtype(np.int64),)

    def _u32(w):
        return w.to(torch.int64) & _LO32

    def _unpack_width(b, off, count, width):
        if width == 0 or count <= 0:
            return torch.zeros(max(count, 0), dtype=torch.int64,
                               device=b.device)
        if width == 32:
            return _u32(b[off:off + count])
        per = 32 // width
        idx = torch.arange(count, dtype=torch.int64, device=b.device)
        w = _u32(b[off:][torch.div(idx, per, rounding_mode="floor")])
        return (w >> ((idx % per) * width)) & ((1 << width) - 1)

    def _i64(lo, hi):
        return (hi.to(torch.int64) << 32) | _u32(lo)

    def _unzigzag(z):
        return (z >> 1) ^ -(z & 1)

    def _from_i64(v, dt):
        if dt.itemsize == 8:
            return v if dt == np.dtype(np.int64) \
                else v.view(torch_dtype(dt))
        # the low word, as a signed int32, viewed as the lane's dtype
        w = ((v & _LO32) ^ 0x80000000) - 0x80000000
        return w.to(torch.int32).view(torch_dtype(dt))

    def _cumsum0(d):
        # [0, d0, d0 + d1, ...] in wrapping int64
        return torch.cat([d.new_zeros(1), torch.cumsum(d, 0)])

    def decode(b):
        cols = []
        off = 0
        for c, dt in zip(fmt.codecs, all_dts):
            w = staging.lane_words(dt)
            if c.kind == RAW:
                seg = b[off:off + w * capacity]
                if w == 2:
                    cols.append(_from_i64(_i64(seg[0::2], seg[1::2]), dt))
                else:
                    cols.append(seg.view(torch_dtype(dt)))
            elif c.kind == CONST:
                v = _i64(b[off], b[off + 1])
                cols.append(_from_i64(v, dt).reshape(1).repeat(capacity))
            elif c.kind == DELTA:
                base = _i64(b[off], b[off + 1])
                d = _unzigzag(_unpack_width(b, off + 2, capacity - 1,
                                            c.width))
                cols.append(_from_i64(base + _cumsum0(d), dt))
            elif c.kind == DELTA2:
                base = _i64(b[off], b[off + 1])
                d0 = _i64(b[off + 2], b[off + 3])
                dd = _unzigzag(_unpack_width(b, off + 4, capacity - 2,
                                             c.width))
                d = d0 + _cumsum0(dd)
                cols.append(_from_i64(base + _cumsum0(d[:capacity - 1]),
                                      dt))
            elif c.kind == DICT:
                idx = _unpack_width(b, off + c.extra * w, capacity, c.width)
                if w == 1:
                    cols.append(b[off:off + c.extra][idx].view(
                        torch_dtype(dt)))
                else:
                    seg = b[off:off + 2 * c.extra]
                    cols.append(_from_i64(_i64(seg[0::2][idx],
                                               seg[1::2][idx]), dt))
            else:
                raise ValueError(f"unknown lane codec {c.kind!r}")
            off += lane_wire_words(c, dt, capacity)
        return cols

    return decode


# ---------------------------------------------------------------------------
# graph attachment + stats surfaces
# ---------------------------------------------------------------------------

def wire_enabled(cfg) -> bool:
    """Resolve ``Config.wire_compression``: True/False ("1"/"0", "on"/
    "off") are explicit; "auto" (the default) enables compression exactly
    when the graph's device is CUDA.  On the CPU host and "device" share
    memory, so the wire is a memcpy and encode/decode would be pure
    overhead; across PCIe every wire byte is what the plane shrinks."""
    v = getattr(cfg, "wire_compression", "auto")
    if v in (True, 1, "1", "on", "true"):
        return True
    if v in (False, 0, None, "", "0", "off", "false"):
        return False
    if v != "auto":
        from windflow_tpu_torch.basic import WindFlowError
        raise WindFlowError(
            f"Config.wire_compression must be 'auto', True or False, "
            f"got {v!r}")
    import torch
    return torch.device(getattr(cfg, "device", "cuda")).type == "cuda"


def iter_stage_emitters(graph):
    """Yield ``(edge_src_op, route_op, emitter)`` for every host→device
    staging emitter of a BUILT graph, descending into keyed staging
    emitters' per-partition inner emitters and split branches — the one
    walk shared by :func:`attach_wire` and :func:`wire_section`."""
    from windflow_tpu_torch.parallel.emitters import (
        DeviceStageEmitter, KeyedDeviceStageEmitter, SplittingEmitter)

    def expand(a, route_op, em):
        if isinstance(em, KeyedDeviceStageEmitter):
            for inner in em._inner:
                yield a, route_op, inner
        elif isinstance(em, DeviceStageEmitter):
            yield a, route_op, em

    for edge in graph._edges():
        if edge[0] == "op":
            _, a, b = edge
            for rep in a.replicas:
                yield from expand(a, b, rep.emitter)
        else:
            _, mp = edge
            src = mp.operators[-1]
            heads = [c.operators[0] for c in mp.split_children
                     if c.operators]
            for rep in src.replicas:
                em = rep.emitter
                if not isinstance(em, SplittingEmitter):
                    continue
                for head, br in zip(heads, em.branches):
                    yield from expand(src, head, br)


def _source_has_spec(op) -> bool:
    from windflow_tpu_torch.io.device_source import DeviceSource
    if getattr(op, "record_spec", None) is not None:
        return True
    return isinstance(op, DeviceSource) and op.batch_fn is not None


def _out_has_spec(op, known: bool) -> bool:
    """Whether ``op``'s output records have a known spec, given whether
    its input's is known: the JAX package's ``propagate_specs`` rules
    (``analysis/preflight.py:1209-1368``), reduced to known/unknown."""
    from windflow_tpu_torch.ops.chained import ChainedGPU
    from windflow_tpu_torch.ops.filter_op import Filter
    from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
    from windflow_tpu_torch.ops.gpu_stateful import (StatefulFilterGPU,
                                                     StatefulMapGPU)
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    if isinstance(op, (MapGPU, FilterGPU, ChainedGPU, ReduceGPU, Filter,
                       StatefulFilterGPU)):
        return known
    if isinstance(op, StatefulMapGPU):
        # an associative map's output is its projection: not inferred
        return known and op.assoc is None
    # windows emit window results; host Map/FlatMap/Reduce and sinks run
    # arbitrary Python the spec walk never calls
    return False


def known_input_specs(graph) -> dict:
    """``id(op) -> bool``: whether the records reaching ``op`` have a
    declared or inferred spec (a merge needs every branch's)."""
    from windflow_tpu_torch.analysis.preflight import _upstream_map
    from windflow_tpu_torch.ops.source import Source
    ups = _upstream_map(graph._edges())
    in_known, out_known = {}, {}

    def in_of(op):
        if id(op) not in in_known:
            in_known[id(op)] = False       # cycle guard
            preds = ups.get(id(op), (None, []))[1]
            in_known[id(op)] = bool(preds) and all(out_of(u) for u in preds)
        return in_known[id(op)]

    def out_of(op):
        if id(op) not in out_known:
            out_known[id(op)] = _source_has_spec(op) \
                if isinstance(op, Source) else _out_has_spec(op, in_of(op))
        return out_known[id(op)]

    for op in graph._topo_operators():
        in_of(op)
    return in_known


def attach_wire(graph) -> None:
    """Enable wire compression on the staging emitters whose feeding edge
    has a declared or inferred record spec (spec-less edges stay raw
    passthrough: the JAX package's WF606 downgrade).  Called by
    ``PipeGraph._build`` after the wiring, before any batch stages; with
    ``Config.wire_compression`` off it is never called and no encoder
    attaches anywhere."""
    known = known_input_specs(graph)
    reseed = getattr(graph.config, "key_compaction_reseed", 64)
    for _src, route_op, em in iter_stage_emitters(graph):
        if em._mesh is not None:
            continue    # mesh staging ships raw, as in the JAX package
        if known.get(id(route_op), False):
            em.enable_wire(reseed)


def wire_section(graph) -> dict:
    """``stats()["Staging"]["Wire"]``: merged wire counters over the
    graph's staging emitters plus the current per-lane codec table (one
    table per distinct lane layout)."""
    enabled = wire_enabled(graph.config)
    agg = WireStats()
    codecs = []
    emitters = 0
    for _src, _route, em in iter_stage_emitters(graph):
        for enc in em._wire_encoders.values():
            emitters += 1
            agg.merge(enc.stats)
            if enc.stats.batches and len(codecs) < 8:
                codecs.append(enc.codec_table())
    out = {"enabled": enabled, "encoders": emitters}
    out.update(agg.to_json())
    out["codecs"] = codecs[0] if len(codecs) == 1 else codecs
    return out
