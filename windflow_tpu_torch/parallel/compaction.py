"""Device-side key compaction: the port of
``windflow_tpu/parallel/compaction.py``.

* **Program pieces** (``:75-472``).  ``make_compacted_reduce`` builds the
  compacted keyed-reduce step: lanes whose key has a dense slot fold
  into a ``[table_size]`` monoid table (through the ``dense_monoid_table``
  kernel where its gates hold), the other lanes (misses) run the sorted
  segmented reduce, over a ``capacity // 32`` overflow lane when they
  fit and over the full batch when they do not, and both result sets
  merge by key rank into the sorted path's output: distinct keys
  ascending, compacted to the front of a ``[capacity]`` batch.  The
  ``bounded`` step (``withMaxKeys``) remaps by the identity over
  ``[0, max_keys)``; the unbounded one takes a sorted key table and its
  slots as operands.  ``lookup_slots``, ``cstats_update`` and
  ``slots_to_user_keys`` are the pieces the stateful and window steps
  share.
* **The host compactor** (``:479-895``).  :class:`KeyCompactor` owns one
  consumer's ``key -> stable slot`` dict and its sorted key/slot
  mirror, uploaded to the card (:meth:`KeyCompactor.tables`) only when
  admission changed it.  Keys are admitted on the host where the
  feeding edge already holds them (the keyed staging emitter, the plain
  staging emitter's :class:`~windflow_tpu_torch.monitoring.shard_ledger.
  HostKeyProbe`), and, every ``reseed_every`` batches, from the steps'
  miss rings (one device read).  Pinned compactors (stateful, windows:
  slots index live state) never evict; evictable ones (the per-batch
  reduce) recycle their coldest slots for candidates the consumer's
  shard sketch (``monitoring/shard_ledger.ShardSketch``, bound by
  :func:`attach_compaction`) estimates at least twice as hot: the
  ``churn`` counter.
* **Graph attachment** (``:896-1013``).  :func:`attach_compaction` gives
  every qualifying keyed consumer its compactor and wires the feeding
  emitters for admission and placement.

What differs from JAX, for torch on the card:

* the nested ``lax.cond`` (no miss / the overflow lane / the full
  width) becomes one 3-body CUDA graph SWITCH node whose branch index,
  computed from the miss count on the device, the ``cond_select``
  kernel reads (``kernels/cond_cuda.py``): with the kernels on, the
  step on the card runs as a cached standalone graph over static
  buffers (the megastep refuses compacted key spaces), with no host
  read.  The plain route (``Config(cuda_kernels="0")``) reads the index
  on the host to pick the branch, and the CPU picks it by the kernel's
  plain twin;
* ``jnp.nonzero(size=T)`` becomes the cumsum + ``searchsorted``
  compaction the overflow lane already uses (no host sync);
* ``dynamic_update_slice`` at a device offset becomes an index put at
  device positions (no host sync);
* the rank merge scatters into a ``[capacity + 1]`` index buffer whose
  last row takes every dead lane (torch's ``index_put_`` with duplicate
  indices is nondeterministic on CUDA; only the dump row sees them);
* the tables go to the card in one non-blocking copy from pinned
  memory; the miss rings and counters are read only at the reseed
  cadence and at stats time;
* ``snapshot``/``restore`` carry the remap across a checkpoint (the
  JAX package's layout).

On a mesh (``Config.mesh``) the arbitrary-key reduce takes a compactor
whose remap overrides the owner hash (hot keys balanced over the mesh
positions, ``parallel/mesh.make_sharded_reduce_arbitrary``); a declared
``withMaxKeys`` mesh reduce takes none, and compacted window keys are
refused (they are single-device).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from windflow_tpu_torch.basic import WindFlowError, int32_key
from windflow_tpu_torch.kernels import cond_cuda as cc
from windflow_tpu_torch.kernels import ffat_cuda as fc
from windflow_tpu_torch.kernels import reduce_cuda as rc
from windflow_tpu_torch.kernels.ffat_cuda import monoid_identity
from windflow_tpu_torch.ops.reduce import _bshape, _segmented_reduce
from windflow_tpu_torch.utils.tree import per_record, tree_flatten, \
    tree_map, tree_unflatten

#: remap sentinel: pads the sorted key table (a real key equal to it is
#: never admitted and rides the overflow lane)
KEY_SENTINEL = np.int32(2**31 - 1)
_SENT = int(KEY_SENTINEL)
#: miss-candidate ring geometry
MISS_RING = 64
MISS_PER_BATCH = 8
#: the compacted reduce's conditional node in ``cond_cuda``'s body
#: counters (body 0 no_miss, 1 ovf_small, 2 ovf_big)
BRANCH_SITE = "compacted reduce"
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


def slots_to_user_keys(key_lane, table_keys, table_slots):
    """The inverse remap of an output key lane holding slots: ``inv[slot]
    = key`` over a ``[T + 1]`` buffer whose last row takes the sentinel
    pads (they all write the sentinel), then a gather."""
    T = int(table_keys.shape[0])
    inv = torch.zeros(T + 1, dtype=table_keys.dtype,
                      device=table_keys.device)
    inv[table_slots.long()] = table_keys
    return inv[torch.clamp(key_lane, 0, T).long()].to(key_lane.dtype)


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
    packed int64 carrier as one multi-column leaf; per-leaf otherwise),
    and picks JAX's ``lax.cond`` branch — ``no_miss``, ``ovf_small`` or
    ``ovf_big`` — on the device, through a SWITCH node on the card
    (``kernels/cond_cuda.py``); with ``kernels`` off the plain route
    reads the branch index on the host."""
    T = int(table_size)
    ovf = overflow_cap(capacity)

    def step(select, keys, payload, ts, valid, *rest):
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
        if packed:  # wfverify: ok (a decision on the leaves' dtypes)
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
            if kernels and rc.table_leaf_ok(tuple(upd.shape), upd.dtype) \
                    and rc.table_supported(capacity, T):
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

        # the branch index on the device: 0 no miss, 1 the misses fit
        # the overflow lane, 2 they do not (ovf >= 32, so 2 implies a miss)
        big = (n_miss_t > ovf).to(torch.int64)
        branch = (n_miss_t > 0).to(torch.int32) + big.to(torch.int32)

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

        # each branch fills the same buffers, allocated before the
        # switch: the node's outputs whatever branch ran
        out_payload = tree_map(torch.empty_like, payload)
        out_ts = torch.empty_like(ts)
        out_valid = torch.empty_like(valid)
        outs = [out_ts, out_valid] + tree_flatten(out_payload)[0]

        def fill(branch_fn):
            def run():
                p, t, v = branch_fn()
                for o, r in zip(outs, [t, v] + tree_flatten(p)[0]):
                    o.copy_(r)
            return run

        select(branch, [fill(no_miss), fill(ovf_small), fill(ovf_big)])
        cst = cstats_update(cst, keys, hit, miss, big=big)
        return out_payload, out_ts, out_valid, cst

    region = cc.RegionGraph("compacted reduce", lambda *a: step(
        lambda i, bodies: cc.switch(i, bodies, BRANCH_SITE), *a))

    def body(keys, payload, ts, valid, *rest):
        if not kernels:
            return step(cc.switch_plain, keys, payload, ts, valid, *rest)
        fc._gate("cond_select", valid.device.type == "cuda")
        return region(keys, payload, ts, valid, *rest)

    return body


# ---------------------------------------------------------------------------
# the host-side compactor
# ---------------------------------------------------------------------------

class _PinnedFull(Exception):
    """Internal admission signal: a full pinned table whose consumer has
    a lossless host-interning escape (never escapes ``observe*``)."""


def upload_pair(tk: np.ndarray, tsl: np.ndarray, device):
    """Two int32 ``[n]`` host tables on ``device``: for the card, one
    non-blocking copy of both from a fresh pinned buffer (the caching
    host allocator keeps it until the copy has run), never a
    synchronising copy."""
    n = tk.shape[0]
    both = np.concatenate([tk, tsl])
    if device is None or torch.device(device).type != "cuda":
        t = torch.from_numpy(both)
    else:
        host = torch.empty(2 * n, dtype=torch.int32, pin_memory=True)
        host.copy_(torch.from_numpy(both))
        t = host.to(device, non_blocking=True)
    return t[:n], t[n:]


class KeyCompactor:
    """Key -> dense-slot remap for ONE compacted consumer operator.

    Host state is the authoritative ``key -> stable slot`` dict plus the
    sorted key / slot mirror arrays; :meth:`tables` hands the consumer's
    step their device copies, uploaded again only after admission
    changed them.  A ``pinned`` compactor (stateful, windows: slots index
    live state) never evicts; on a full pinned table an
    ``intern_fallback`` compactor deactivates, so the stateful consumer
    adopts the mapping into its host interner, which raises its own
    ``num_key_slots`` error on the overflowing key, while a plain pinned
    table (windows) counts ``full_rejects`` and the consumer masks and
    counts the key's lanes.  An evictable compactor (the per-batch
    reduce) may recycle its coldest slots at the reseed cadence, which
    is safe because a reduce rebuilds its dense table every batch.
    Sibling host emitter replicas may admit concurrently: admission,
    reseed and the table and placement reads hold ``_lock``."""

    def __init__(self, slots: int, *, pinned: bool = False,
                 bounded: bool = False, reseed_every: int = 64,
                 placement_override: bool = False,
                 intern_fallback: bool = False, name: str = "",
                 device=None) -> None:
        self.slots = int(slots)
        self.pinned = pinned
        #: withMaxKeys mode: the remap is the identity over [0, max_keys);
        #: no table, only the stats surface and the overflow reroute
        self.bounded = bounded
        self.reseed_every = max(1, int(reseed_every))
        #: keyed placement override: slotted keys go to ``slot % n``
        #: (hot keys balanced deterministically); per-batch consumers
        #: only, since moving a key between replicas mid-stream would
        #: break per-key order for stateful state
        self.placement_override = placement_override
        #: the consumer has a lossless host-interning fallback: a
        #: sentinel-valued key (2^31-1, never admissible) or a full
        #: table deactivates the compactor instead of losing records
        self.intern_fallback = intern_fallback
        self.name = name
        #: the device the tables are uploaded to
        self.device = device
        #: False after a host observation path failed: consumers fall
        #: back to their own path
        self.active = True
        self._lock = threading.Lock()
        self._key_slot: dict = {}
        self._free = list(range(self.slots - 1, -1, -1))
        self._tk = np.full(self.slots, KEY_SENTINEL, np.int32)
        self._tsl = np.full(self.slots, self.slots, np.int32)
        self._dev = None          # (table_keys, table_slots) on the device
        self.admits = 0
        self.churn = 0
        self.reseeds = 0
        self.full_rejects = 0     # table full at admission time
        self.sentinel_rejects = 0  # real keys equal to KEY_SENTINEL seen
        self._batches = 0
        self._sketch = None       # the consumer's shard sketch: ranks keys
        self._stats_getters = []  # the consumers' device cstats

    # -- wiring --------------------------------------------------------------
    def bind_sketch(self, sketch) -> None:
        """A shard sketch (``hot_candidates(limit)``, ``_estimate(key)``)
        to seed and rank from at reseed."""
        self._sketch = sketch

    def register_device_stats(self, getter) -> None:
        """Register one step site's live cstats getter; read at every
        summary and reseed."""
        self._stats_getters.append(getter)

    # -- device mirrors ------------------------------------------------------
    def _rebuild(self) -> None:
        n = len(self._key_slot)
        tk = np.full(self.slots, KEY_SENTINEL, np.int32)
        tsl = np.full(self.slots, self.slots, np.int32)
        if n:
            ks = np.fromiter(self._key_slot.keys(), np.int32, count=n)
            sl = np.fromiter(self._key_slot.values(), np.int32, count=n)
            order = np.argsort(ks, kind="stable")
            tk[:n] = ks[order]
            tsl[:n] = sl[order]
        self._tk, self._tsl = tk, tsl
        self._dev = None          # uploaded again at the next table read

    def tables(self):
        """The ``(table_keys, table_slots)`` device operands for this
        batch, uploaded only when admission changed them (under the lock,
        so a sibling's rebuild never pairs new keys with stale slots)."""
        dev = self._dev
        if dev is None:
            with self._lock:
                dev = self._dev
                if dev is None:
                    dev = self._dev = upload_pair(self._tk, self._tsl,
                                                  self.device)
        return dev

    # -- admission (host-visible key paths) ----------------------------------
    def _admit(self, k32: int) -> bool:
        if k32 == _SENT:
            # reserved: rides the overflow lane (reduce); a compacted
            # window masks and counts it, so the encounter is counted
            self.sentinel_rejects += 1
            return False
        if k32 in self._key_slot:
            return False
        if not self._free:
            if self.pinned and self.intern_fallback:
                raise _PinnedFull
            self.full_rejects += 1
            return False
        self._key_slot[k32] = self._free.pop()
        self.admits += 1
        return True

    def observe(self, keys: np.ndarray) -> None:
        """Bulk admission from a key column: new keys get slots BEFORE
        their batch ships, so host-fed consumers see a miss-free remap."""
        if not self.active:
            return
        u = np.unique(np.asarray(keys).astype(np.int64).astype(np.int32))
        if self.intern_fallback and u.size and u[-1] == KEY_SENTINEL:
            self.deactivate()   # sorted unique: the sentinel is last
            return
        full = False
        with self._lock:
            n = len(self._key_slot)
            if n and u.size:
                # keys already seated are the steady state: drop them in
                # one vectorized lookup before the per-key admission
                tk = self._tk[:n]
                pos = np.minimum(np.searchsorted(tk, u), n - 1)
                u = u[tk[pos] != u]
            changed = False
            for k in u:
                try:
                    changed |= self._admit(int(k))
                except _PinnedFull:
                    full = True
                    break
            if changed:
                # keys admitted before the table filled still reach the
                # device mirror
                self._rebuild()
        if full:
            # the consumer adopts the mapping; its interner raises the
            # num_key_slots error on this batch
            self.deactivate()

    def observe_one(self, k32: int) -> None:
        """Scalar admission for the per-tuple emit path: a lock-free dict
        read in the admitted steady state; only a new key takes the
        lock, and a full evictable or plain pinned table never does."""
        if not self.active:
            return
        k = int32_key(k32)
        if k == _SENT:
            if self.intern_fallback:
                self.deactivate()
            else:
                self.sentinel_rejects += 1
            return
        if k in self._key_slot:
            return
        if not self._free and not (self.pinned and self.intern_fallback):
            # only a reseed can seat the key: keep the per-tuple path
            # lock-free (_free only shrinks; the counter is telemetry)
            self.full_rejects += 1
            return
        try:
            with self._lock:
                if self._admit(k):
                    self._rebuild()
        except _PinnedFull:
            self.deactivate()

    def deactivate(self) -> None:
        """A host observation path failed: consumers fall back to their
        own path at their next step."""
        self.active = False

    def export_mapping(self) -> dict:
        """key -> slot, for a consumer falling back to host interning
        (its state rows keep meaning the same keys)."""
        with self._lock:
            return dict(self._key_slot)

    # -- placement -----------------------------------------------------------
    def slot_of(self, k32: int) -> Optional[int]:
        return self._key_slot.get(int(np.int32(k32)))

    def place_np(self, keys: np.ndarray, n_dests: int) -> np.ndarray:
        """Keyed placement with the remap override: slotted keys go to
        ``slot % n``, the cold tail keeps the splitmix placement."""
        from windflow_tpu_torch.parallel.emitters import splitmix64_np
        k = np.asarray(keys, np.int64)
        k32 = k.astype(np.int32)
        with self._lock:
            tk, tsl, n = self._tk, self._tsl, len(self._key_slot)
        pos = np.searchsorted(tk[:max(1, n)], k32)
        pos = np.clip(pos, 0, max(0, n - 1))
        found = (n > 0) & (tk[pos] == k32) & (tsl[pos] < self.slots)
        slot = tsl[pos].astype(np.int64)
        h = (splitmix64_np(k) % np.uint64(n_dests)).astype(np.int64)
        return np.where(found, slot % n_dests, h).astype(np.intp)

    def place_one(self, k32: int, n_dests: int) -> Optional[int]:
        s = self.slot_of(k32)
        return None if s is None else s % n_dests

    # -- reseed cadence ------------------------------------------------------
    def on_batch(self) -> None:
        """Per-consumer-step hook: counts batches and reseeds on the
        cadence (the plane's one device read)."""
        self._batches += 1
        if self._batches % self.reseed_every == 0 and not self.bounded:
            self.reseed()

    def _miss_candidates(self) -> list:
        out = []
        sentinel = np.iinfo(np.int32).min
        for getter in self._stats_getters:
            st = getter()
            if st is None:
                continue
            # wfverify: ok (the reseed read of the miss rings, every
            # key_compaction_reseed batches)
            ring = st["cand"].cpu().numpy().astype(np.int64)
            out.extend(int(k) for k in ring if k != sentinel)
        return out

    def reseed(self) -> None:
        """Fold the sketch's hot candidates (when a sketch is bound) and
        the steps' miss rings into the table.  Pinned tables only admit;
        evictable ones recycle their coldest slots for candidates at
        least twice as hot (the ``churn`` counter)."""
        self.reseeds += 1
        cands = self._miss_candidates()
        est = {}
        if self._sketch is not None:
            # the sketch's device states are read here (reseed cadence)
            for k, e in self._sketch.hot_candidates(self.slots):
                est[int(np.int32(int(k)))] = int(e)
        for k in cands:
            # miss-ring candidates carry no estimate: admitted only into
            # free slots, never past the eviction hysteresis
            est.setdefault(k, 0)
        with self._lock:
            fresh = [k for k in est
                     if k not in self._key_slot and k != _SENT]
            if not fresh:
                return
            fresh.sort(key=lambda k: est.get(k, 0), reverse=True)
            changed = False
            residents = None
            ri = 0
            for k in fresh:
                if self._free:
                    changed |= self._admit(k)
                    continue
                if self.pinned:
                    break         # pinned tables never evict live state
                if residents is None:
                    # one estimation pass over the residents, coldest
                    # first; candidates walk it hottest first
                    residents = self._resident_coldness()
                if residents is None or ri >= len(residents):
                    break
                cold_est, coldest = residents[ri]
                if est.get(k, 0) < 2 * max(1, cold_est):
                    break         # 2x hysteresis; later ones are colder
                ri += 1
                changed = True
                self._key_slot[k] = self._key_slot.pop(coldest)
                self.admits += 1
                self.churn += 1
            if changed:
                self._rebuild()

    def _resident_coldness(self) -> Optional[list]:
        """``(estimate, key)`` for every resident key, coldest first, or
        None (no sketch: nothing to rank by, so nothing is evicted)."""
        if self._sketch is None or not self._key_slot:
            return None
        out = []
        for k in self._key_slot:
            try:
                out.append((self._sketch._estimate(k), k))
            except Exception:  # lint: broad-except-ok (an exact-histogram
                # sketch has no count-min: nothing to rank by this round)
                return None
        out.sort()
        return out

    # -- read path -----------------------------------------------------------
    def summary(self) -> dict:
        """Host and device counters for ``dump_stats``: hit rate,
        overflow share, churn, occupancy (device reads: stats time)."""
        hits = misses = big = batches = 0
        for getter in self._stats_getters:
            st = getter()
            if st is None:
                continue
            hits += int(st["hits"])
            misses += int(st["misses"])
            big += int(st["big"])
            batches += int(st["batches"])
        total = hits + misses
        out = {
            "slots": self.slots,
            "occupied": len(self._key_slot),
            "pinned": self.pinned,
            "bounded": self.bounded,
            "batches": batches,
            "tuples": total,
            "hits": hits,
            "hit_rate": round(hits / total, 4) if total else None,
            "overflow_share": round(misses / total, 4) if total else None,
            "overflow_tuples": misses,
            "big_fallbacks": big,
            "admits": self.admits,
            "churn": self.churn,
            "churn_per_sweep": round(self.churn / batches, 4)
            if batches else 0.0,
            "reseeds": self.reseeds,
            "placement_override": self.placement_override,
        }
        if self.full_rejects:
            out["full_rejects"] = self.full_rejects
        if self.sentinel_rejects:
            out["sentinel_rejects"] = self.sentinel_rejects
        if not self.active:
            out["deactivated"] = True
        return out

    # -- durable state (windflow_tpu_torch/durability) -----------------------
    def snapshot(self) -> dict:
        """The remap IS operator state: a restored stateful/FFAT table
        indexes rows by these slots, so replays stay record-for-record.
        The JAX package's ``KeyCompactor.snapshot`` layout."""
        with self._lock:
            return {
                "key_slot": dict(self._key_slot),
                "free": list(self._free),
                "admits": self.admits,
                "churn": self.churn,
                "reseeds": self.reseeds,
                "batches": self._batches,
                "active": self.active,
            }

    def restore(self, blob: dict) -> None:
        with self._lock:
            self._key_slot = {int(k): int(v)
                              for k, v in blob["key_slot"].items()}
            self._free = [int(s) for s in blob["free"]]
            self.admits = blob["admits"]
            self.churn = blob["churn"]
            self.reseeds = blob["reseeds"]
            self._batches = blob["batches"]
            self.active = blob["active"]
            self._rebuild()


# ---------------------------------------------------------------------------
# graph attachment (PipeGraph._build, after fusion and wiring)
# ---------------------------------------------------------------------------

def attach_compaction(graph) -> None:
    """Attach a KeyCompactor to every qualifying keyed consumer, bind the
    consumer's shard sketch to it, and wire the feeding emitters for host
    admission and placement.  Runs after fusion (preludes installed), the
    wiring and the shard plane (sketches attached), before any step;
    with ``Config.key_compaction`` off it never runs."""
    from windflow_tpu_torch.analysis.preflight import _upstream_map
    from windflow_tpu_torch.monitoring.shard_ledger import HostKeyProbe
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.parallel.emitters import (DeviceKeyByEmitter,
                                                      DeviceStageEmitter,
                                                      DeviceToHostEmitter,
                                                      KeyedDeviceStageEmitter,
                                                      SplittingEmitter)
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU

    cfg = graph.config
    slots = max(2, int(getattr(cfg, "key_compaction_slots", 1024)))
    reseed = max(1, int(getattr(cfg, "key_compaction_reseed", 64)))
    upstreams = _upstream_map(graph._edges())
    sketches = graph._shard._sketches if graph._shard is not None else {}

    def host_fed(op) -> bool:
        ups = upstreams.get(id(op), (op, []))[1]
        return bool(ups) and all(not u.is_gpu for u in ups)

    for op in graph._operators:
        comp = None
        if isinstance(op, ReduceGPU):
            if op.key_extractor is None:
                continue
            if op.mesh is not None:
                if op.max_keys is None:
                    # arbitrary-key mesh reduce: the remap overrides the
                    # owner hash; the per-position sort path is unchanged
                    comp = KeyCompactor(slots, reseed_every=reseed,
                                        placement_override=True,
                                        name=op.name, device=graph.device)
            elif op.monoid is None:
                continue
            else:
                bounded = op.max_keys is not None
                comp = KeyCompactor(
                    op.max_keys if bounded else slots, bounded=bounded,
                    reseed_every=reseed,
                    # slot % n placement is per-batch-safe only, and
                    # means nothing for the identity (bounded) remap
                    placement_override=not bounded and op.parallelism > 1,
                    name=op.name, device=graph.device)
        elif isinstance(op, _StatefulGPUBase):
            # the device-resident interner: needs every feeding edge
            # host-staged (admission sees every key before its batch
            # ships) and no fused prelude (post-prelude keys are never
            # on the host)
            if op.dense_keys or op.mesh is not None \
                    or op._fused_prelude is not None \
                    or not host_fed(op) or len(op._interner):
                continue
            comp = KeyCompactor(op.num_key_slots, pinned=True,
                                reseed_every=reseed, intern_fallback=True,
                                name=op.name, device=graph.device)
        elif isinstance(op, FfatWindowsGPU):
            if op.max_keys is not None or op.key_extractor is None:
                continue
            if op.mesh is not None:
                raise WindFlowError(
                    f"operator '{op.name}': compacted key spaces are "
                    "single-device; declare withMaxKeys (divisible by the "
                    "key axis) for mesh execution")
            comp = KeyCompactor(slots, pinned=True, reseed_every=reseed,
                                name=op.name, device=graph.device)
        if comp is None:
            continue
        comp.bind_sketch(sketches.get(id(op)))
        op.enable_compaction(comp)

    def visit(em):
        if em is None:
            return
        if isinstance(em, SplittingEmitter):
            for b in em.branches:
                visit(b)
            return
        if isinstance(em, DeviceToHostEmitter):
            visit(em.inner)
            return
        if not em.dests:
            return
        consumer = em.dests[0][0].op
        comp = consumer._compactor
        if comp is None or comp.bounded:
            return
        if isinstance(em, KeyedDeviceStageEmitter):
            # a fused tail extracts its keys after the prelude: admitting
            # the pre-prelude keys here would seat keys it never looks up
            if consumer._fused_prelude is None:
                em._compactor = comp
        elif isinstance(em, DeviceKeyByEmitter):
            if comp.placement_override:
                em.attach_compactor(comp)
        elif isinstance(em, DeviceStageEmitter):
            kx = consumer.key_extractor
            if kx is not None and consumer._fused_prelude is None:
                if em._shard_probe is not None:
                    em._shard_probe.compactor = comp
                else:
                    em._shard_probe = HostKeyProbe(None, kx,
                                                   compactor=comp)

    for op in graph._operators:
        for rep in op.replicas:
            visit(rep.emitter)

