"""Device-side key compaction for the keyed reduce: the program pieces of
``windflow_tpu/parallel/compaction.py`` (``:75-472``).

``make_compacted_reduce`` builds the compacted keyed-reduce step: lanes
whose key has a dense slot fold into a ``[table_size]`` monoid table
(through the ``dense_monoid_table`` kernel where its gates hold), the
other lanes (misses) run the sorted segmented reduce, over a
``capacity // 32`` overflow lane when they fit and over the full batch
when they do not, and both result sets merge by key rank into the
sorted path's output: distinct keys ascending, compacted to the front
of a ``[capacity]`` batch.

The ``bounded`` step (``withMaxKeys``) is the one a graph builds: the
remap is the identity over ``[0, max_keys)`` and out-of-range keys ride
the overflow lane instead of being dropped.  The unbounded step takes a
sorted key table and its slots as operands; the host ``KeyCompactor``
that owns such tables is not ported yet.

What differs from JAX, for torch on the card:

* ``lax.cond`` becomes one host read of the miss count per batch
  (``int(n_miss)``), which picks the branch; the sink's copy back on
  the same stream waits for the batch anyway;
* ``jnp.nonzero(size=T)`` becomes the cumsum + ``searchsorted``
  compaction the overflow lane already uses (no host sync);
* ``dynamic_update_slice`` at a device offset becomes an index put at
  device positions (no host sync);
* the rank merge scatters into a ``[capacity + 1]`` index buffer whose
  last row takes every dead lane (torch's ``index_put_`` with duplicate
  indices is nondeterministic on CUDA; only the dump row sees them).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from windflow_tpu_torch.kernels import reduce_cuda as rc
from windflow_tpu_torch.kernels.ffat_cuda import monoid_identity
from windflow_tpu_torch.ops.reduce import _bshape, _segmented_reduce
from windflow_tpu_torch.utils.tree import per_record, tree_flatten, \
    tree_map, tree_unflatten

#: remap sentinel: pads the sorted key table (a real key equal to it is
#: never admitted and rides the overflow lane)
KEY_SENTINEL = np.int32(2**31 - 1)
#: miss-candidate ring geometry
MISS_RING = 64
MISS_PER_BATCH = 8
#: overflow lane budget as a fraction of the batch capacity
OVERFLOW_DENOM = 32

I64MAX = int(np.iinfo(np.int64).max)
I64MIN = int(np.iinfo(np.int64).min)
_I32MIN = int(np.iinfo(np.int32).min)


def overflow_cap(capacity: int) -> int:
    return min(capacity, max(32, capacity // OVERFLOW_DENOM))


def lookup_slots(table_keys, table_slots, keys, valid):
    """``(slot, hit)`` for an int32 key lane against the sorted key table;
    misses carry the table size as their slot."""
    size = int(table_keys.shape[0])
    k32 = keys.to(torch.int32)
    pos = torch.clamp(torch.searchsorted(table_keys, k32), 0,
                      size - 1).long()
    cand = table_slots[pos]
    hit = valid & (table_keys[pos] == k32) & (cand < size)
    return torch.where(hit, cand, torch.full_like(cand, size)), hit


def cstats_init(device=None):
    """Fresh compaction stats: hit/miss counters, batch count, full-width
    fallbacks and the miss-candidate ring."""
    return {
        "hits": torch.zeros((), dtype=torch.int64, device=device),
        "misses": torch.zeros((), dtype=torch.int64, device=device),
        "batches": torch.zeros((), dtype=torch.int32, device=device),
        "big": torch.zeros((), dtype=torch.int64, device=device),
        "cand": torch.full((MISS_RING,), _I32MIN, dtype=torch.int32,
                           device=device),
    }


def cstats_update(st, keys, hit, miss, big=None):
    """Counters plus a strided sample of MISS keys into the ring, the
    sample offset rotating with the batch counter.  All device
    arithmetic: the ring offset is never read on the host."""
    dev = keys.device
    k32 = keys.to(torch.int32)
    cap = int(k32.shape[0])
    c = min(MISS_PER_BATCH, cap)
    stride = max(1, cap // c)
    i32 = dict(dtype=torch.int32, device=dev)
    idx = ((st["batches"] * 7 + stride * torch.arange(c, **i32))
           % cap).long()
    cand_new = torch.where(miss[idx], k32[idx],
                           torch.full((c,), _I32MIN, **i32))
    slots = max(1, MISS_RING // c)
    # dynamic_update_slice clamps its start so the slice fits
    start = torch.clamp((st["batches"] % slots) * c, 0, MISS_RING - c)
    cand = st["cand"].clone()
    cand[(start + torch.arange(c, **i32)).long()] = cand_new
    return {
        "hits": st["hits"] + hit.sum(dtype=torch.int64),
        "misses": st["misses"] + miss.sum(dtype=torch.int64),
        "batches": st["batches"] + 1,
        "big": st["big"] + (0 if big is None else big),
        "cand": cand,
    }


_PACK_FLOATS = (torch.float32, torch.float64)


def _pack_ok(dtype) -> bool:
    """True when a leaf dtype maps order-isomorphically into an int64
    carrier (the packed one-scatter combine under max/min)."""
    if dtype == torch.bool or dtype in _PACK_FLOATS:
        return True
    if dtype.is_floating_point or dtype.is_complex:
        return False
    if dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        return True
    # unsigned fits the signed carrier only below 64 bits
    return dtype in (torch.uint8, torch.uint16, torch.uint32)


def _enc64(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of one supported leaf into int64: floats take
    the sign-folded bit cast (-0.0 folds onto +0.0, equal under max/min;
    NaN-free streams only, as the monoid contract requires)."""
    if x.dtype == torch.float32:
        bi = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(bi >= 0, bi, -2**31 - bi)
    if x.dtype == torch.float64:
        bi = x.contiguous().view(torch.int64)
        # I64MIN - bi wraps (two's complement): still bijective
        return torch.where(bi >= 0, bi, I64MIN - bi)
    return x.to(torch.int64)


def _dec64(c: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`_enc64` for one carrier column."""
    if dtype == torch.float32:
        bi = torch.where(c >= 0, c, -2**31 - c).to(torch.int32)
        return bi.view(torch.float32)
    if dtype == torch.float64:
        bi = torch.where(c >= 0, c, I64MIN - c)
        return bi.view(torch.float64)
    return c.to(dtype)


def _zeros_where_not(mask, a):
    return torch.where(_bshape(mask, a), a,
                       torch.zeros((), dtype=a.dtype, device=a.device))


def make_compacted_reduce(capacity: int, table_size: int, monoid: str,
                          comb: Callable, key_fn: Optional[Callable],
                          bounded: bool, kernels: bool = False):
    """Build the compacted keyed-reduce step

    ``(keys, payload, ts, valid[, table_keys, table_slots], cstats) ->
    (out_payload, out_ts, out_valid, cstats')``

    (``keys`` may be ``None``: the step extracts them with ``key_fn``).
    The output equals the sorted segmented reduce's record for record
    whenever the declared monoid matches the combiner exactly.
    ``bounded`` is the ``withMaxKeys`` variant (identity remap over
    ``[0, table_size)``, no table operands).  ``kernels`` routes the
    dense half through ``dense_monoid_table`` where its gates hold (the
    packed int64 carrier as one multi-column leaf; per-leaf otherwise)."""
    T = int(table_size)
    ovf = overflow_cap(capacity)

    def body(keys, payload, ts, valid, *rest):
        if bounded:
            (cst,) = rest
            table_keys = table_slots = None
        else:
            table_keys, table_slots, cst = rest
        dev = valid.device
        i32 = dict(dtype=torch.int32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        if keys is None:
            keys = per_record(key_fn, payload, capacity)
        keys = keys.to(torch.int32)
        if bounded:
            hit = valid & (keys >= 0) & (keys < T)
            slot = keys
        else:
            slot, hit = lookup_slots(table_keys, table_slots, keys, valid)
        miss = valid & ~hit
        n_miss_t = miss.sum()

        # -- dense half: miss and invalid lanes go to dump row T.  The ts
        # max doubles as the liveness bit; a lane ts of exactly INT64_MIN
        # is clamped up by one (the reserved ts value).
        row = torch.where(hit, slot, torch.full_like(slot, T)).contiguous()
        sts = torch.clamp(ts, min=I64MIN + 1)
        leaves, treedef = tree_flatten(payload)
        packed = monoid in ("max", "min") and all(
            _pack_ok(l.dtype) for l in leaves)
        if packed:
            # every leaf encodes into int64 carrier columns and the ts max
            # rides as one more column (negated under "min" so it stays a
            # max; the second reserved ts value I64MIN + 1 keeps a live
            # row from reading as the min identity)
            tcol = sts if monoid == "max" \
                else -torch.clamp(sts, min=I64MIN + 2)
            cols = [_enc64(l).reshape(capacity, -1) for l in leaves]
            widths = [int(c.shape[1]) for c in cols]
            upd = torch.cat(cols + [tcol[:, None]], 1)
            ident = I64MIN if monoid == "max" else I64MAX
            if kernels and rc.table_supported(capacity, T) \
                    and rc.table_leaf_ok(tuple(upd.shape), upd.dtype):
                tbl = rc.dense_monoid_table(row, [upd], [monoid], [ident],
                                            T)[0]
            else:
                tbl = rc.table_leaf_plain(row, upd, monoid, ident, T)
            has = tbl[:, -1] != ident
            last = tbl[:, -1] if monoid == "max" else -tbl[:, -1]
            ts_t = torch.where(has, last, torch.full_like(last, I64MIN))
            outs, off = [], 0
            for leaf, w in zip(leaves, widths):
                col = tbl[:, off:off + w].reshape((T,) + tuple(leaf.shape[1:]))
                outs.append(_dec64(col, leaf.dtype))
                off += w
            table = tree_unflatten(treedef, outs)
        else:
            def scat(leaf):
                return rc.table_leaf_plain(
                    row, leaf, monoid, monoid_identity(monoid, leaf.dtype), T)

            def lax_ts():
                return rc.table_leaf_plain(row, sts, "max", I64MIN, T)

            routed = None
            if kernels:
                routed = rc.routed_monoid_tables(
                    row, payload, monoid, T, lax_leaf=scat, ts=sts,
                    ts_init=I64MIN, lax_ts=lax_ts)
            if routed is not None:
                table, ts_t, _ = routed
            else:
                table = tree_map(scat, payload)
                ts_t = lax_ts()
            has = ts_t != I64MIN

        # key-ascending view of the dense table: bounded slots ARE keys
        if bounded:
            dvals, dts, dhas = table, ts_t, has
            dkeys = torch.arange(T, **i64)
        else:
            perm = torch.clamp(table_slots, max=T - 1).long()
            live = table_slots < T
            dvals = tree_map(lambda a: a[perm], table)
            dts = ts_t[perm]
            dhas = has[perm] & live
            dkeys = table_keys.to(torch.int64)

        # live-row index list: the j-th live row is the first whose
        # running count reaches j + 1 (jnp.nonzero's fill never shows:
        # dlive masks it)
        cs_d = torch.cumsum(dhas.to(torch.int64), 0)
        n_d = cs_d[-1]
        didx = torch.clamp(torch.searchsorted(
            cs_d, torch.arange(1, T + 1, **i64)), max=T - 1)
        dlive = torch.arange(T, device=dev) < n_d

        def dcompact(a):
            return _zeros_where_not(dlive, a[didx])

        cvals = tree_map(dcompact, dvals)
        cts = dcompact(dts)
        ckeys = torch.where(dlive, dkeys[didx],
                            torch.full_like(dkeys[didx], I64MAX))

        n_miss = int(n_miss_t)      # the one host read of the step
        big = n_miss > ovf

        def no_miss():
            def padd(a):
                if capacity <= T:
                    return a[:capacity]
                return torch.cat([a, torch.zeros(
                    (capacity - T,) + tuple(a.shape[1:]), dtype=a.dtype,
                    device=dev)])
            return (tree_map(padd, cvals), padd(cts),
                    torch.arange(capacity, device=dev) < n_d)

        def merge(okeys, ovals, ots, ovalid):
            # two sorted, disjoint key lists interleave by searchsorted
            # rank; one index scatter, then every leaf gathers
            W = int(okeys.shape[0])
            okeys_s = torch.where(ovalid, okeys,
                                  torch.full_like(okeys, I64MAX))
            n_o = ovalid.sum()
            drank = torch.arange(T, **i64) + torch.searchsorted(okeys_s,
                                                                ckeys)
            orank = torch.arange(W, **i64) + torch.searchsorted(ckeys,
                                                                okeys_s)
            dpos = torch.where(dlive, drank, torch.full_like(drank,
                                                             capacity))
            opos = torch.where(ovalid, orank, torch.full_like(orank,
                                                              capacity))
            gidx = torch.zeros(capacity + 1, **i32)
            gidx[dpos] = torch.arange(T, **i32)
            gidx[opos] = torch.arange(W, **i32) + T
            gidx = gidx[:capacity].long()
            out_valid = torch.arange(capacity, device=dev) < (n_d + n_o)

            def pick(src_d, src_o):
                g = torch.cat([src_d, src_o], 0)[gidx]
                return _zeros_where_not(out_valid, g)

            return (tree_map(pick, cvals, ovals), pick(cts, ots),
                    out_valid)

        def ovf_small():
            # the j-th miss is the first lane whose running miss count
            # reaches j + 1
            cs_m = torch.cumsum(miss.to(torch.int64), 0)
            midx = torch.clamp(torch.searchsorted(
                cs_m, torch.arange(1, ovf + 1, **i64)), max=capacity - 1)
            mvalid = torch.arange(ovf, device=dev) < n_miss_t
            ok, op_, ots, ov = _segmented_reduce(
                keys[midx], tree_map(lambda a: a[midx], payload),
                ts[midx], mvalid, comb, ovf)
            return merge(ok, op_, ots, ov)

        def ovf_big():
            return merge(*_segmented_reduce(keys, payload, ts, miss, comb,
                                            capacity))

        if n_miss == 0:
            out_payload, out_ts, out_valid = no_miss()
        elif big:
            out_payload, out_ts, out_valid = ovf_big()
        else:
            out_payload, out_ts, out_valid = ovf_small()
        cst = cstats_update(cst, keys, hit, miss, big=int(big))
        return out_payload, out_ts, out_valid, cst

    return body
