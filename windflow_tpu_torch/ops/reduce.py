"""ReduceGPU: the keyed per-batch device reduce (the single-chip port of
``ReduceTPU``, ``windflow_tpu/ops/tpu.py:186-708``; reference
``Reduce_GPU``, ``reduce_gpu.hpp:107-315``).

Keyed batches shrink to one combined record per distinct key, non-keyed
batches to a single record.  Three routes, picked per operator:

* **sorted** (no declared monoid): a stable sort by key, then a
  segmented scan of the user combiner (``_segmented_reduce``) — the
  reference's ``sort_by_key`` + ``reduce_by_key``;
* **dense** (``withMaxKeys`` + a declared monoid, ``Config.key_compaction``
  off, or non-keyed): one scatter-combine pass into ``[max_keys]``
  tables through the ``dense_monoid_table`` kernel; keys outside
  ``[0, max_keys)`` are dropped and counted;
* **bounded compacted** (``withMaxKeys`` + a declared monoid in a graph
  with ``Config.key_compaction`` on, the default): the dense tables for
  in-range keys, out-of-range keys on the sorted overflow lane
  (``parallel/compaction.py``); the records equal the sorted route's.

Cross-batch aggregation is the windows' job, as in the reference.  The
mesh route, ``KeyCompactor`` (compaction of undeclared key spaces) and
durable state are not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import torch

from windflow_tpu_torch.basic import RoutingMode, WindFlowError
from windflow_tpu_torch.batch import DeviceBatch
from windflow_tpu_torch.kernels import reduce_cuda as rc
from windflow_tpu_torch.kernels.ffat_cuda import (monoid_identity,
                                                  resolve_kernels)
from windflow_tpu_torch.ops.base import Operator
from windflow_tpu_torch.ops.gpu import _GPUReplica
from windflow_tpu_torch.utils.tree import per_record, tree_flatten, \
    tree_map
from windflow_tpu_torch.windows.ffat_kernels import (associative_scan,
                                                     resolve_monoid)


def _bshape(mask: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast a [B] bool mask against a [B, ...] leaf."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ref.ndim - 1))


def _segmented_reduce(keys, payload, ts, valid, comb, capacity):
    """Sorted segmented reduce: ``(distinct_keys, combined_payload,
    seg_ts, out_valid)``, the distinct-key results compacted to the front
    of the batch in ascending key order.

    Invalid lanes take an int64 sentinel beyond the int32 key space, so
    a real key of INT32_MAX is never mistaken for padding.  The sort is
    stable (``jnp.argsort`` is), and the scan is the port of
    ``lax.associative_scan``, so float results keep JAX's combine tree.
    The compaction scatters into a ``[capacity + 1]`` buffer: every
    non-end lane lands in the last (dump) row, never on a real result —
    torch's ``index_put_`` with duplicate indices is nondeterministic on
    CUDA."""
    dev = valid.device
    sentinel = 1 << 32
    skeys = torch.where(valid, keys.to(torch.int64),
                        torch.full((), sentinel, dtype=torch.int64,
                                   device=dev))
    skeys, order = torch.sort(skeys, stable=True)
    spayload = tree_map(lambda a: a[order], payload)
    sts = ts[order]

    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    starts = torch.cat([true1, skeys[1:] != skeys[:-1]])

    def op(a, b):
        # segmented-scan monoid: a segment start resets to b
        fa, pa, ta = a
        fb, pb, tb = b
        combined = comb(pa, pb)
        p = tree_map(lambda c, vb: torch.where(_bshape(fb, c), vb, c),
                     combined, pb)
        t = torch.where(fb, tb, torch.maximum(ta, tb))
        return (fa | fb, p, t)

    _, scanned_payload, scanned_ts = associative_scan(
        op, (starts, spayload, sts))

    ends = torch.cat([skeys[:-1] != skeys[1:], true1]) & (skeys != sentinel)
    dest = torch.cumsum(ends.to(torch.int64), 0) - 1
    n_out = ends.sum()
    scatter_idx = torch.where(ends, dest,
                              torch.full_like(dest, capacity))

    def compact(a):
        out = torch.zeros((capacity + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=dev)
        out[scatter_idx] = torch.where(_bshape(ends, a), a,
                                       torch.zeros((), dtype=a.dtype,
                                                   device=dev))
        return out[:capacity]

    out_payload = tree_map(compact, scanned_payload)
    out_keys = compact(skeys)
    out_ts = compact(scanned_ts)
    out_valid = torch.arange(capacity, device=dev) < n_out
    return out_keys, out_payload, out_ts, out_valid


class ReduceGPU(Operator):
    """Per-batch associative reduce on the device (reference
    ``Reduce_GPU``).  ``comb`` combines two records (column dicts, as
    every per-record function of the port) and must be associative.  The
    key extractor runs on the device and returns integers."""

    replica_class = _GPUReplica

    def __init__(self, comb: Callable[[Any, Any], Any],
                 name: str = "reduce_gpu", parallelism: int = 1,
                 key_extractor=None, max_keys: Optional[int] = None,
                 monoid: Optional[str] = None) -> None:
        routing = RoutingMode.KEYBY if key_extractor is not None \
            else RoutingMode.FORWARD
        super().__init__(name, parallelism, routing=routing, is_gpu=True,
                         key_extractor=key_extractor)
        self.comb = comb
        #: bound of the dense key space [0, max_keys)
        self.max_keys = max_keys
        try:
            self.monoid = resolve_monoid(monoid)
        except ValueError as e:
            raise WindFlowError(str(e)) from None
        self._steps = {}
        self._checked = False
        #: the bounded compacted route, set at graph build
        #: (Config.key_compaction)
        self.bounded_compaction = False
        #: compaction stats of the bounded route (device tensors)
        self._cstats = None
        #: device int64 scalar of dense-route key drops, read only at
        #: stats time
        self._dropped = None
        # one-time drop warning of the dense route, checked on a 64-step
        # cadence against the counter enqueued one cadence earlier
        self._drop_warned = False
        self._drop_steps = 0
        self._pending_drop = None

    def enable_bounded_compaction(self) -> None:
        """Graph build, ``Config.key_compaction``: a keyed declared-monoid
        ``withMaxKeys`` reduce reroutes out-of-range keys to the sorted
        overflow lane instead of dropping them."""
        self.bounded_compaction = True

    # -- step builders -------------------------------------------------------
    def _keys(self, payload, capacity: int, device):
        if self.key_extractor is None:
            return torch.zeros(capacity, dtype=torch.int32, device=device)
        return per_record(self.key_extractor, payload,
                          capacity).to(torch.int32)

    def _get_step(self, capacity: int):
        """The sorted route."""
        step = self._steps.get(capacity)
        if step is None:
            comb = self.comb

            def step(payload, ts, valid):
                keys = self._keys(payload, capacity, valid.device)
                return _segmented_reduce(keys, payload, ts, valid, comb,
                                         capacity)
            self._steps[capacity] = step
        return step

    def _get_dense_step(self, capacity: int):
        """The dense route: one scatter-combine pass builds the ``[K]``
        distinct-key tables (K = max_keys keyed, 1 non-keyed); keys
        outside ``[0, K)`` are dropped and counted."""
        step = self._steps.get(("dense", capacity))
        if step is None:
            K = self.max_keys if self.key_extractor is not None else 1
            monoid = self.monoid
            kernels = resolve_kernels(self.config)

            def step(payload, ts, valid):
                dev = valid.device
                keys = self._keys(payload, capacity, dev)
                in_range = (keys >= 0) & (keys < K)
                ok = valid & in_range
                n_drop = (valid & ~in_range).sum(dtype=torch.int64)
                row = torch.where(ok, keys, torch.full_like(keys, K))

                def scat(leaf):
                    return rc.table_leaf_plain(
                        row, leaf, monoid, monoid_identity(monoid,
                                                           leaf.dtype), K)

                def lax_ts():
                    return rc.table_leaf_plain(row, ts, "max", -1, K)

                routed = None
                if kernels:
                    routed = rc.routed_monoid_tables(
                        row, payload, monoid, K, lax_leaf=scat, ts=ts,
                        ts_init=-1, lax_ts=lax_ts, want_count=True)
                if routed is not None:
                    table, ts_t, cnt = routed
                    has = cnt > 0
                else:
                    table = tree_map(scat, payload)
                    ts_t = lax_ts()
                    has = torch.zeros(K + 1, dtype=torch.bool, device=dev)
                    has.index_fill_(0, row.long(), True)
                    has = has[:K]
                return table, ts_t, has, n_drop
            self._steps[("dense", capacity)] = step
        return step

    def _get_compacted_step(self, capacity: int):
        """The bounded compacted route (parallel/compaction.py)."""
        step = self._steps.get(("compact", capacity))
        if step is None:
            from windflow_tpu_torch.parallel import compaction
            step = compaction.make_compacted_reduce(
                capacity, self.max_keys, self.monoid, self.comb,
                self.key_extractor, bounded=True,
                kernels=resolve_kernels(self.config))
            self._steps[("compact", capacity)] = step
        return step

    # -- stats ---------------------------------------------------------------
    def num_dropped_tuples(self) -> int:
        if self._dropped is None:
            return 0
        return int(self._dropped)   # one device read, diagnostics only

    def _maybe_warn_drops(self, n_drop: int) -> None:
        """One RuntimeWarning the first time the dense route is seen
        dropping out-of-range keys."""
        if self._drop_warned or n_drop <= 0:
            return
        self._drop_warned = True
        warnings.warn(
            f"ReduceGPU '{self.name}': withMaxKeys({self.max_keys}) + "
            "withMonoidCombiner uses the dense-table contract — "
            f"{n_drop} tuple(s) with out-of-range keys (outside "
            f"[0, {self.max_keys})) were dropped and counted in "
            "Out_of_range_keys_dropped; the undeclared sorted path keeps "
            "arbitrary int32 keys", RuntimeWarning, stacklevel=3)

    def dump_stats(self) -> dict:
        st = super().dump_stats()
        if self._cstats is not None:
            cs = {k: int(v) for k, v in self._cstats.items() if k != "cand"}
            st["Key_compaction"] = {
                "bounded": True, "batches": cs["batches"],
                "hits": cs["hits"], "overflow_tuples": cs["misses"],
                "big_fallbacks": cs["big"]}
            if cs["misses"]:
                # keys outside [0, max_keys) were rerouted to the sorted
                # overflow lane (kept, not dropped)
                st["Out_of_range_keys_rerouted"] = cs["misses"]
        if self._dropped is not None:
            dropped = self.num_dropped_tuples()
            st["Out_of_range_keys_dropped"] = dropped
            self._maybe_warn_drops(dropped)
            if self._drop_warned:
                st["Out_of_range_keys_note"] = (
                    "dense-table contract (withMaxKeys + "
                    "withMonoidCombiner): keys outside [0, max_keys) are "
                    "dropped; the undeclared sorted path keeps arbitrary "
                    "int32 keys")
        return st

    # -- the step ------------------------------------------------------------
    def _check_comb_contract(self, payload) -> None:
        """The combiner must return the full record structure with every
        leaf's shape and dtype: checked once, on a one-lane slice of the
        first batch, so every route gives this message instead of an
        opaque mismatch from inside a scan."""
        one = tree_map(lambda a: a[:1], payload)
        out = self.comb(one, one)
        in_leaves, in_def = tree_flatten(one)
        out_leaves, out_def = tree_flatten(out)
        if in_def != out_def:
            if isinstance(one, dict) and isinstance(out, dict) \
                    and sorted(one) != sorted(out):
                want, got = sorted(one), sorted(out)
            else:
                want, got = in_def, out_def
            raise WindFlowError(
                "ReduceGPU combiner must return the same record structure "
                f"as its inputs (records have {want}, combiner returned "
                f"{got}); carry every field through the combine")
        names = [str(i) for i in range(len(in_leaves))]
        if isinstance(one, dict) and all(not isinstance(v, (dict, list,
                                                            tuple))
                                         for v in one.values()):
            names = sorted(one)
        for name, a, b in zip(names, in_leaves, out_leaves):
            b = torch.as_tensor(b)
            if tuple(a.shape[1:]) != tuple(b.shape[1:]) or b.ndim != a.ndim \
                    or a.dtype != b.dtype:
                raise WindFlowError(
                    "ReduceGPU combiner must preserve each field's shape "
                    f"and dtype: field {name} is {tuple(a.shape[1:])}/"
                    f"{a.dtype} in the records but the combiner returned "
                    f"{tuple(b.shape[1:]) if b.ndim else ()}/{b.dtype}")

    def _step(self, batch: DeviceBatch) -> DeviceBatch:
        if not self._checked:
            self._check_comb_contract(batch.payload)
            self._checked = True
        cap = batch.capacity
        if self.bounded_compaction:
            # in-range keys on the dense tables, the rest on the sorted
            # overflow lane; records equal the sorted route's
            if self._cstats is None:
                from windflow_tpu_torch.parallel.compaction import \
                    cstats_init
                self._cstats = cstats_init(batch.valid.device)
            out_payload, out_ts, out_valid, self._cstats = \
                self._get_compacted_step(cap)(None, batch.payload,
                                              batch.ts, batch.valid,
                                              self._cstats)
            return DeviceBatch(out_payload, out_ts, out_valid,
                               watermark=batch.watermark, size=None,
                               frontier=batch.frontier)
        if self.monoid is not None and self.max_keys is not None:
            # dense tables: a [max_keys] batch of distinct-key records in
            # ascending key order (the order the sorted route emits)
            table, ts_out, has, n_drop = self._get_dense_step(cap)(
                batch.payload, batch.ts, batch.valid)
            self._dropped = n_drop if self._dropped is None \
                else self._dropped + n_drop
            self._drop_steps += 1
            if not self._drop_warned and self._drop_steps % 64 == 0:
                prev = self._pending_drop
                self._pending_drop = self._dropped
                if prev is not None:
                    self._maybe_warn_drops(int(prev))
            return DeviceBatch(table, ts_out, has,
                               watermark=batch.watermark, size=None,
                               frontier=batch.frontier)
        _, out_payload, out_ts, out_valid = self._get_step(cap)(
            batch.payload, batch.ts, batch.valid)
        return DeviceBatch(out_payload, out_ts, out_valid,
                           watermark=batch.watermark, size=None,
                           frontier=batch.frontier)
