"""Shard plane: per-shard attribution and key-skew sketches (the port of
``windflow_tpu/monitoring/shard_ledger.py``).

Every gauge of the other planes is per OPERATOR: a keyed operator at
parallelism 4 whose replica 3 holds the hot key shows one flat row.
This plane attributes per replica (shard) and measures the key skew:

* **Key-skew sketches on the keyed edges** — a count-min sketch (DEPTH
  rows of WIDTH int64 counters, each row one 16-bit field of the
  splitmix64 hash) plus hot-key candidates, updated where the key lane
  already exists:

  - on the card, inside the device keyby split and the fused chain step
    that extracts a downstream KEYBY consumer's keys
    (:func:`device_sketch_update`: ``index_add_`` into preallocated
    tensors and ``index_copy_`` at device-computed positions; no host
    read, capturable).  The state is read on the host only at stats
    cadence, and at the compactors' reseed cadence (``hot_candidates``);
  - on the host at the keyed staging edge (its key column and
    per-destination counts exist there), at a plain staging edge into a
    keyed device consumer (:class:`HostKeyProbe`), and from one sampled
    key a flushed batch on the host KEYBY edge;
  - as an exact dense histogram where the consumer declares a bounded
    key space (``key_space()``).

  The sketch's estimates equal the JAX package's bit for bit on the same
  keys: the same hash, the same int64 counters.

* **Per-shard attribution** of queue depth, watermark frontier and lag,
  service-time quantiles and the hop's tensor bytes.

* **Key compaction** ranks its residents by the sketch: a full evictable
  compactor recycles its coldest slots for hotter candidates (``churn``),
  as in the JAX package (``parallel/compaction.py``).

* **The mesh's inter-position model** (:meth:`ShardLedger._ici_model`):
  the bytes one dispatch of a mesh operator's sharded step moves between
  positions, derived from the collectives ``parallel/mesh.py`` runs (the
  JAX package's ICI model, field names kept).  On one card the
  positions share its memory, so the "ICI" time divides by the
  calibrated same-device copy rate (``ici_bytes_per_sec``), not a link.

Surfaces: ``PipeGraph.stats()["Shard"]``, ``dump_trace()`` metadata and
the postmortem bundle's ``shard.json``.  ``Config.shard_ledger`` off
attaches no sketch anywhere.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

#: count-min geometry: DEPTH rows of WIDTH counters; WIDTH is a power of
#: two <= 2^16, so a row's index is one 16-bit field of the 64-bit hash
SKETCH_DEPTH = 4
SKETCH_WIDTH = 2048
#: device hot-key candidate ring: CAND_PER_BATCH strided lanes a batch
#: overwrite a CAND_RING-slot ring
CAND_RING = 64
CAND_PER_BATCH = 8
#: declared key spaces up to this bound keep an exact histogram
EXACT_KEYS_LIMIT = 1 << 16
#: cap on the host candidate set between prunes
_CAND_POOL_LIMIT = 1024
_I32MIN = int(np.iinfo(np.int32).min)


def _splitmix64_np(k) -> np.ndarray:
    from windflow_tpu_torch.parallel.emitters import splitmix64_np
    return splitmix64_np(k)


def _key32_np(k: np.ndarray) -> np.ndarray:
    """int64 -> the int32 key the device state collapses to."""
    return np.asarray(k).astype(np.int64).astype(np.int32).astype(np.int64)


# ---------------------------------------------------------------------------
# the device sketch state, updated inside the step
# ---------------------------------------------------------------------------

def device_sketch_init(n_shards: int, device=None) -> dict:
    """A fresh device sketch state: ``cms`` [DEPTH, WIDTH] int64,
    ``counts`` [n + 1] int64 (the last row takes the invalid lanes),
    ``cand`` [CAND_RING] int32, ``batches`` and ``total`` int64
    scalars."""
    import torch
    n = max(1, n_shards)
    return {
        "cms": torch.zeros((SKETCH_DEPTH, SKETCH_WIDTH), dtype=torch.int64,
                           device=device),
        "counts": torch.zeros(n + 1, dtype=torch.int64, device=device),
        "cand": torch.full((CAND_RING,), _I32MIN, dtype=torch.int32,
                           device=device),
        "batches": torch.zeros((), dtype=torch.int64, device=device),
        "total": torch.zeros((), dtype=torch.int64, device=device),
    }


def device_sketch_update(state: dict, keys, valid, n_shards: int,
                         dest=None) -> None:
    """Update a device sketch state in place from one batch's int32 key
    lane: no host read, no allocation that depends on the data, so it may
    run inside a captured CUDA graph.  ``dest`` is the per-lane
    destination the keyby split computed (invalid lanes == n); None
    derives it from the splitmix placement."""
    import torch
    from windflow_tpu_torch.parallel.emitters import (place_torch,
                                                      splitmix64_torch)
    n = max(1, n_shards)
    k32 = keys.to(torch.int32)
    h = splitmix64_torch(k32)
    vi = valid.to(torch.int64)
    cms = state["cms"]
    for i in range(SKETCH_DEPTH):
        # the masked field of the int64 hash: ``%`` on a negative int64
        # would give the wrong row
        idx = (h >> (16 * i)) & (SKETCH_WIDTH - 1)
        cms[i].index_add_(0, idx, vi)
    if dest is None:
        dest = torch.where(valid, place_torch(k32, n), n)
    state["counts"].index_add_(0, dest.to(torch.int64),
                               torch.ones_like(vi))
    cap = int(k32.shape[0])
    c = min(CAND_PER_BATCH, cap)
    stride = max(1, cap // c)
    cand_new = torch.where(valid[::stride][:c], k32[::stride][:c],
                           torch.full_like(k32[:c], _I32MIN))
    slots = max(1, CAND_RING // c)
    start = (state["batches"] % slots) * c
    pos = start + torch.arange(c, device=k32.device, dtype=torch.int64)
    state["cand"].index_copy_(0, pos, cand_new)
    state["batches"].add_(1)
    state["total"].add_(vi.sum())


def _host_state(st: dict, n: int) -> dict:
    """A device sketch state read on the host (stats / reseed cadence)."""
    # wfverify: ok (the sketches' state, read at stats and reseed
    # cadence)
    return {"cms": st["cms"].cpu().numpy(),
            "counts": st["counts"].cpu().numpy()[:n],
            "cand": st["cand"].cpu().numpy().astype(np.int64),
            "batches": int(st["batches"]), "total": int(st["total"])}


# ---------------------------------------------------------------------------
# the per-consumer sketch: host accumulators + registered device states
# ---------------------------------------------------------------------------

class ShardSketch:
    """Key-skew sketch of ONE keyed consumer.  Host update paths keep
    numpy state; device sites register a state getter, merged only when
    :meth:`summary` or :meth:`hot_candidates` runs."""

    def __init__(self, n_shards: int, topk: int = 8,
                 max_keys: Optional[int] = None,
                 placement: str = "splitmix", key_axis: int = 1) -> None:
        self.n_shards = max(1, n_shards)
        self.topk = max(1, topk)
        #: "splitmix" (device and keyed-staging routing), "stable_hash"
        #: (the host KEYBY edge), "dense_range" (a mesh's key-axis
        #: ownership) or "mod" (the mesh arbitrary-key reduce's owner
        #: hash, uint32(key) % n)
        self.placement = placement
        self.key_axis = max(1, key_axis)
        #: the reshard executor's key→shard override, set when it
        #: re-places keys, so hot-key attribution follows the live routing
        self.override: Optional[dict] = None
        self.shard_counts = np.zeros(self.n_shards, np.int64)
        self.total = 0
        self.batches = 0
        self.update_usec = 0.0
        self.max_keys = max_keys if (max_keys
                                     and max_keys <= EXACT_KEYS_LIMIT) \
            else None
        if self.max_keys is not None:
            # exact histogram; row K counts the out-of-range keys
            self.hist = np.zeros(self.max_keys + 1, np.int64)
            self.cms = None
        else:
            self.hist = None
            self.cms = np.zeros((SKETCH_DEPTH, SKETCH_WIDTH), np.int64)
        #: count-min hot-key candidates, pruned by estimate
        self._cands: Dict[int, int] = {}
        #: sampled weights of the host KEYBY edge (one key a batch)
        self._sampled: Dict[int, int] = {}
        self._sampled_n = 0
        #: device sites: callables returning the live state (or None)
        self._device_states: List = []
        self._lock = threading.Lock()

    # -- update paths --------------------------------------------------------
    def update_host(self, keys: np.ndarray,
                    counts: Optional[np.ndarray] = None) -> None:
        """Bulk host update from a key column; ``counts`` are the
        per-destination totals the keyed staging edge computed."""
        t0 = time.perf_counter()
        keys = np.asarray(keys, np.int64)
        n = keys.size
        if n == 0:
            return
        self.batches += 1
        self.total += n
        if counts is not None:
            self.shard_counts += np.asarray(counts, np.int64)
        elif self.placement == "dense_range":
            pass    # derived from the histogram's key ranges at summary
        elif self.placement == "mod":
            d = ((keys & 0xFFFFFFFF) % self.n_shards).astype(np.intp)
            self.shard_counts += np.bincount(d, minlength=self.n_shards)
        elif self.n_shards > 1:
            h = _splitmix64_np(keys)
            d = (h % np.uint64(self.n_shards)).astype(np.intp)
            self.shard_counts += np.bincount(d, minlength=self.n_shards)
        if self.hist is not None:
            k = np.where((keys < 0) | (keys >= self.max_keys),
                         self.max_keys, keys)
            self.hist += np.bincount(k.astype(np.intp),
                                     minlength=self.max_keys + 1)
        else:
            h = _splitmix64_np(keys)
            for i in range(SKETCH_DEPTH):
                idx = ((h >> np.uint64(16 * i))
                       % np.uint64(SKETCH_WIDTH)).astype(np.intp)
                self.cms[i] += np.bincount(idx, minlength=SKETCH_WIDTH)
            step = max(1, n // CAND_PER_BATCH)
            # a per-batch rotating offset: a fixed stride over a periodic
            # key layout would sample one phase forever
            off = int((self.batches * 7) % step)
            with self._lock:
                for k in keys[off::step][:CAND_PER_BATCH]:
                    self._cands[int(k)] = 0
            if len(self._cands) > _CAND_POOL_LIMIT:
                self._prune_cands()
        self.update_usec += (time.perf_counter() - t0) * 1e6

    def note_flush(self, shard: int, n: int, sample_key=None) -> None:
        """Host KEYBY edge, a flushed batch: exact shard load, and one
        sampled key (the ``"sampled"`` basis)."""
        self.batches += 1
        self.total += n
        self.shard_counts[shard] += n
        if sample_key is None:
            return
        try:
            with self._lock:
                self._sampled[sample_key] = \
                    self._sampled.get(sample_key, 0) + n
                self._sampled_n += n
                if len(self._sampled) > _CAND_POOL_LIMIT:
                    keep = sorted(self._sampled.items(),
                                  key=lambda kv: kv[1],
                                  reverse=True)[:_CAND_POOL_LIMIT // 2]
                    self._sampled = dict(keep)
        except TypeError:
            pass    # an unhashable user key: the load still counted

    def register_device_state(self, getter) -> None:
        """A device site: ``getter()`` returns its live cumulative state,
        or None before its first batch."""
        self._device_states.append(getter)

    def _device_reads(self) -> list:
        out = []
        for getter in self._device_states:
            st = getter()
            if st is not None:
                out.append(_host_state(st, self.n_shards))
        return out

    # -- read path (stats / reseed cadence) ----------------------------------
    def _prune_cands(self) -> None:
        with self._lock:
            est = [(k, self._estimate(k)) for k in self._cands]
            est.sort(key=lambda kv: kv[1], reverse=True)
            self._cands = {k: 0 for k, _ in est[:_CAND_POOL_LIMIT // 2]}

    def _estimate(self, key: int, cms: Optional[np.ndarray] = None) -> int:
        c = self.cms if cms is None else cms
        h = _splitmix64_np(np.asarray([key], np.int64))[0]
        return int(min(
            c[i][int((h >> np.uint64(16 * i)) % np.uint64(SKETCH_WIDTH))]
            for i in range(SKETCH_DEPTH)))

    def hot_candidates(self, limit: int) -> list:
        """``[(key, est_tuples), ...]``, hottest first, at most ``limit``:
        the exact histogram's counts, or the merged count-min's
        estimates of the host candidates and the device rings (the
        compactors' reseed)."""
        if self.hist is not None:
            body = self.hist[:self.max_keys]
            order = np.argsort(body)[::-1][:limit]
            return [(int(k), int(body[k])) for k in order if body[k] > 0]
        cms = self.cms.copy()
        with self._lock:
            cands = set(self._cands)
            cands.update(k for k in self._sampled
                         if isinstance(k, (int, np.integer)))
        for st in self._device_reads():
            cms = cms + st["cms"]
            cands.update(int(k) for k in st["cand"] if k != _I32MIN)
        est = [(int(k), self._estimate(int(k), cms)) for k in cands]
        est.sort(key=lambda kv: kv[1], reverse=True)
        return est[:limit]

    def shard_of(self, key: int) -> int:
        from windflow_tpu_torch.basic import int32_key, stable_hash
        from windflow_tpu_torch.parallel.emitters import splitmix64_int
        if self.override:
            d = self.override.get(key)
            if isinstance(d, int) and 0 <= d < self.n_shards:
                return d
        if self.placement == "dense_range" and self.max_keys:
            per = max(1, self.max_keys // self.key_axis)
            return min(self.key_axis - 1, max(0, int(key)) // per)
        if self.placement == "mod":
            return (int(key) & 0xFFFFFFFF) % self.n_shards
        if self.placement == "stable_hash":
            return stable_hash(key) % self.n_shards
        return splitmix64_int(int32_key(key)) % self.n_shards

    def summary(self) -> dict:
        """Host and device accumulators merged: per-shard loads, the
        top-K hot keys and the basis ("exact", "mixed", "cms" or
        "sampled")."""
        counts = self.shard_counts.copy()
        total = self.total
        batches = self.batches
        hist = self.hist.copy() if self.hist is not None else None
        cms = self.cms.copy() if self.cms is not None else None
        with self._lock:
            cands = set(self._cands)
        dev_fed = False
        for st in self._device_reads():
            if st["counts"].size == counts.size:
                counts = counts + st["counts"]
            total += st["total"]
            batches += st["batches"]
            if cms is None:
                # a bounded consumer fed by a device site: the site
                # carries a count-min, so the merged view needs one
                cms = np.zeros((SKETCH_DEPTH, SKETCH_WIDTH), np.int64)
            cms = cms + st["cms"]
            cands.update(int(k) for k in st["cand"] if k != _I32MIN)
            dev_fed = True
        if self.placement == "dense_range" and hist is not None \
                and self.key_axis > 1:
            per = max(1, self.max_keys // self.key_axis)
            counts = hist[:per * self.key_axis] \
                .reshape(self.key_axis, per).sum(axis=1)
        out = {
            "n_shards": int(counts.size),
            "placement": self.placement,
            "total_tuples": int(total),
            "batches": int(batches),
            "tuples": [int(c) for c in counts],
        }
        if total > 0 and counts.size > 1 and counts.sum() > 0:
            mean = counts.sum() / counts.size
            out["imbalance_ratio"] = round(float(counts.max() / mean), 4)
            out["hot_shard"] = int(counts.argmax())
        top: List[dict] = []
        if hist is not None and hist[:self.max_keys].sum() > 0:
            out["basis"] = "exact"
            body = hist[:self.max_keys]
            order = np.argsort(body)[::-1][:4 * self.topk]
            est_map = {int(k): int(body[k]) for k in order if body[k] > 0}
            if dev_fed and cms is not None:
                out["basis"] = "mixed"
                for k in cands:
                    est_map[k] = est_map.get(k, 0) \
                        + self._estimate(k, cms)
            ranked = sorted(est_map.items(), key=lambda kv: kv[1],
                            reverse=True)
            top = [{"key": k, "est_tuples": v}
                   for k, v in ranked[:self.topk] if v > 0]
            if hist[self.max_keys]:
                out["out_of_range_tuples"] = int(hist[self.max_keys])
        elif cms is not None and cands:
            out["basis"] = "cms"
            est = [(k, self._estimate(k, cms)) for k in cands]
            est.sort(key=lambda kv: kv[1], reverse=True)
            top = [{"key": int(k), "est_tuples": int(v)}
                   for k, v in est[:self.topk] if v > 0]
        elif self._sampled:
            out["basis"] = "sampled"
            est = sorted(self._sampled.items(), key=lambda kv: kv[1],
                         reverse=True)
            top = [{"key": k, "est_tuples": v}
                   for k, v in est[:self.topk]]
        else:
            out["basis"] = "cms" if cms is not None else "exact"
        for t in top:
            if total > 0:
                t["share"] = round(t["est_tuples"] / total, 4)
            try:
                t["shard"] = self.shard_of(t["key"])
            except (TypeError, ValueError):
                pass
        out["hot_keys"] = top
        if top and total > 0:
            out["hot_key_share"] = round(top[0]["est_tuples"] / total, 4)
        if self.update_usec:
            out["host_update_usec"] = round(self.update_usec, 1)
        return out


class HostKeyProbe:
    """Key probe on a plain staging emitter feeding a keyed device
    consumer whose key extraction runs in its step: the emitter holds the
    batch's fields on the host, so the consumer's extractor runs there, a
    batch at a time (``columns`` on the columnar path, ``items`` on the
    record path).  It feeds the shard sketch and, for a host-fed
    compacted consumer, is the compactor's admission point
    (``parallel/compaction.py``), so the consumer sees a miss-free remap.
    Any extractor failure disables the probe for good and deactivates the
    compactor, so the consumer falls back to its own path."""

    __slots__ = ("sketch", "key_fn", "dead", "compactor")

    def __init__(self, sketch: Optional[ShardSketch], key_fn,
                 compactor=None) -> None:
        self.sketch = sketch
        self.key_fn = key_fn
        self.compactor = compactor
        self.dead = False

    def _fail(self) -> None:
        self.dead = True
        if self.compactor is not None:
            self.compactor.deactivate()

    def columns(self, cols, n: int) -> None:
        if self.dead or n == 0:
            return
        from windflow_tpu_torch.parallel.emitters import host_keys
        try:
            k32 = host_keys(self.key_fn, cols, n)
            if self.compactor is not None:
                self.compactor.observe(k32)
            if self.sketch is not None:
                self.sketch.update_host(k32)
        except Exception:  # lint: broad-except-ok (any failure means the probe
            # cannot see; the staging path must go on)
            self._fail()

    def items(self, items) -> None:
        if self.dead or not items:
            return
        from windflow_tpu_torch.batch import _stack_records
        try:
            cols = _stack_records(items)
        except Exception:  # lint: broad-except-ok (records that do not stack)
            self._fail()
            return
        self.columns(cols, len(items))


# ---------------------------------------------------------------------------
# the graph-scoped ledger
# ---------------------------------------------------------------------------

def _steady_tensor_bytes(op) -> Optional[float]:
    """Tensor bytes a step of the hop's dominant handle (the sweep
    ledger's steady number, scaled per replica below)."""
    from windflow_tpu_torch.monitoring.sweep_ledger import _op_wrappers
    best_d, best = 0, None
    for w in _op_wrappers(op):
        if w.dispatches > 0 and w.tensor_bytes is not None \
                and w.dispatches >= best_d:
            best_d, best = w.dispatches, float(w.tensor_bytes)
    return best


class ShardLedger:
    """Graph-scoped shard plane, built by ``PipeGraph._build`` when
    ``Config.shard_ledger`` is on: construction attaches the sketches to
    the keyed edges; ``section()`` reads at stats cadence."""

    def __init__(self, graph) -> None:
        self._graph = graph
        self.topk = max(1, int(getattr(graph.config, "shard_topk", 8)))
        #: id(consumer op) -> its ShardSketch (every edge into the
        #: consumer shares it)
        self._sketches: Dict[int, ShardSketch] = {}
        self._statics: Optional[dict] = None
        self._attach()

    def _compute_statics(self) -> dict:
        """Per operator: the record bytes a tuple reaching it (the
        preflight walk, ``bpt``: the byte basis of the mesh model), its
        upstream operators and its effective capacity; computed once, at
        the first read."""
        from windflow_tpu_torch.analysis.preflight import (_effective_caps,
                                                           _upstream_map,
                                                           propagate_specs,
                                                           record_nbytes)
        g = self._graph
        edges = g._edges()
        upstreams = _upstream_map(edges)
        in_specs, _ = propagate_specs(g, edges=edges, upstreams=upstreams)
        ups: Dict[int, list] = {}
        for edge in edges:
            if edge[0] == "op":
                ups.setdefault(id(edge[2]), []).append(edge[1])
        statics = {}
        for op in g._operators:
            caps = sorted(c for c in _effective_caps(op, upstreams) if c)
            statics[id(op)] = {
                "bpt": record_nbytes(in_specs.get(id(op))),
                "ups": ups.get(id(op), []),
                "cap": getattr(op, "output_batch_size", 0)
                or (caps[0] if caps else 0),
            }
        return statics

    # -- the mesh's inter-position model ------------------------------------
    def _ici_model(self, op, bpt: Optional[float],
                   cap: int) -> Optional[dict]:
        """The bytes one dispatch of ``op``'s sharded step moves between
        mesh positions, from its collective structure (``bpt`` =
        payload and lane bytes a tuple, ``cap`` = the batch capacity):
        aligned ingest keeps only the within-column data gather; a dense
        reduce's table collective moves ~2(n-1) tables (ring all-reduce);
        the arbitrary-key reduce's all_to_all moves (n-1)/n of the
        lanes; key-sharded state gathers the data-sharded batch on every
        key shard."""
        mesh = getattr(op, "mesh", None)
        if mesh is None or bpt is None or not cap:
            return None
        from windflow_tpu_torch.ops.reduce import ReduceGPU
        dd, kk = mesh.shape["data"], mesh.shape["key"]
        n = dd * kk
        if getattr(op, "_ingest_mode", None) == "aligned":
            total = cap * bpt * (dd - 1)
            kind = "all_gather(data|key-aligned)"
        elif isinstance(op, ReduceGPU):
            if op.max_keys is not None:
                k = op.max_keys if op.key_extractor is not None else 1
                total = 2.0 * (n - 1) * k * bpt
                kind = f"psum([{k}] table)"
            else:
                total = cap * bpt * (n - 1) / n
                kind = "all_to_all(lanes)"
        else:
            total = kk * cap * bpt * (dd - 1)
            kind = "all_gather(data)"
        from windflow_tpu_torch.monitoring import calibration
        ici_bps, ici_prov = calibration.constant("ici_bytes_per_sec")
        return {
            "collective": kind,
            "mesh": {"data": dd, "key": kk},
            "ici_bytes_per_dispatch": round(total, 1),
            "ici_bytes_per_tuple": round(total / cap, 2),
            "ici_usec_per_dispatch": round((total / n) / ici_bps * 1e6, 3),
            "ici_bandwidth_assumed_bps": ici_bps,
            "ici_bandwidth_provenance": ici_prov,
            "provenance": calibration.MODELED,
            "model": "structural (the collectives of parallel/mesh.py; "
                     "positions on one card copy within its memory)",
        }

    def _op_ici(self, op) -> Optional[dict]:
        """:meth:`_ici_model` of one operator from the cached statics
        (host constants only); with no record spec on a mesh, the
        measured staging bytes a tuple of the feeding edges."""
        from windflow_tpu_torch.monitoring.sweep_ledger import \
            LANE_BYTES_PER_TUPLE
        if getattr(op, "mesh", None) is None:
            return None
        if self._statics is None:
            self._statics = self._compute_statics()
        st = self._statics.get(id(op)) or {}
        spec_bpt = st.get("bpt")
        bpt = spec_bpt + LANE_BYTES_PER_TUPLE \
            if spec_bpt is not None else None
        basis = "record spec"
        if bpt is None:
            h2d = sum(r.stats.h2d_bytes for u in st.get("ups", ())
                      for r in u.replicas)
            inputs = sum(r.stats.inputs_received for r in op.replicas)
            if h2d > 0 and inputs > 0:
                bpt = h2d / inputs
                basis = "measured H2D bytes/tuple"
        ici = self._ici_model(op, bpt, st.get("cap", 0))
        if ici is not None:
            ici["bytes_per_tuple_basis"] = basis
        return ici

    def _sketch_for(self, consumer, n_shards: int,
                    placement: str) -> ShardSketch:
        sk = self._sketches.get(id(consumer))
        if sk is None:
            mesh = getattr(consumer, "mesh", None)
            key_axis = 1
            if mesh is not None:
                if consumer.key_space() is not None:
                    # key shard i owns keys [i*K/kk, (i+1)*K/kk)
                    key_axis = mesh.shape["key"]
                    placement, n_shards = "dense_range", key_axis
                else:
                    # arbitrary keys route to owner uint32(key) % n
                    placement, n_shards = "mod", mesh.size
            sk = ShardSketch(n_shards, topk=self.topk,
                             max_keys=consumer.key_space(),
                             placement=placement, key_axis=key_axis)
            self._sketches[id(consumer)] = sk
        return sk

    def _attach(self) -> None:
        from windflow_tpu_torch.parallel.emitters import (
            AlignedMeshStageEmitter, DeviceKeyByEmitter, DeviceStageEmitter,
            DeviceToHostEmitter, KeyByEmitter, KeyedDeviceStageEmitter,
            SplittingEmitter)
        g = self._graph

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
            if isinstance(em, AlignedMeshStageEmitter):
                # key-aligned mesh ingest: the keys are on the host here
                kx = consumer.key_extractor
                if consumer.is_keyed and kx is not None:
                    sk = self._sketch_for(consumer, consumer.parallelism,
                                          "splitmix")
                    em._shard_probe = HostKeyProbe(sk, kx)
            elif isinstance(em, KeyedDeviceStageEmitter):
                em._sketch = self._sketch_for(consumer, len(em.dests),
                                              "splitmix")
            elif isinstance(em, DeviceKeyByEmitter):
                em.attach_shard_sketch(self._sketch_for(
                    consumer, len(em.dests), "splitmix"))
            elif isinstance(em, KeyByEmitter):
                em._sketch = self._sketch_for(consumer, len(em.dests),
                                              "stable_hash")
            elif isinstance(em, DeviceStageEmitter):
                # a plain staging edge into a keyed device consumer whose
                # extraction runs in its step: probe the host records
                # (not for a fused tail: its extractor reads post-prelude
                # records, this edge stages the chain head's); a
                # dense-keys stateful step extracts the keys on the card
                # anyway, so the sketch rides that step, as a chain's
                kx = consumer.key_extractor
                if consumer.is_keyed and kx is not None \
                        and consumer.is_gpu \
                        and consumer._fused_prelude is None:
                    sk = self._sketch_for(consumer, consumer.parallelism,
                                          "splitmix")
                    if getattr(consumer, "dense_keys", False) \
                            and getattr(consumer, "mesh", None) is None:
                        consumer.attach_shard_sketch(sk)
                    else:
                        em._shard_probe = HostKeyProbe(sk, kx)

        for op in g._operators:
            for rep in op.replicas:
                visit(rep.emitter)
        # a chain extracting its downstream consumer's keys on the card:
        # the sketch updates in that same step
        downstream = {id(e[1]): e[2] for e in g._edges() if e[0] == "op"}
        for op in g._operators:
            for exec_ in (op._fusion_exec, getattr(op, "_chain", None)):
                if exec_ is None or exec_._key_extractor is None:
                    continue
                consumer = downstream.get(id(op))
                if consumer is None or not consumer.is_keyed:
                    continue
                if consumer.parallelism > 1:
                    # the device keyby split downstream sketches this
                    # stream already: a second update would count twice
                    continue
                exec_.attach_shard_sketch(
                    self._sketch_for(consumer, consumer.parallelism,
                                     "splitmix"), consumer.parallelism)
                break

    def op_summary(self, op_name: str) -> Optional[dict]:
        """Load and hot-key summary of one operator by name (the health
        plane's stall-diagnosis hook)."""
        for op in self._graph._operators:
            if op.name == op_name:
                sk = self._sketches.get(id(op))
                return sk.summary() if sk is not None else None
        return None

    def ici_totals(self) -> dict:
        """The inter-position model's totals over the mesh operators (0
        off a mesh).  Host constants: the tenant ledger reads them at
        tick cadence without the sketches' device reads."""
        total = 0.0
        for op in self._graph._operators:
            ici = self._op_ici(op)
            if ici is not None:
                total += ici["ici_bytes_per_tuple"]
        return {"ici_bytes_per_tuple": round(total, 2),
                "ici_provenance": "modeled"}

    def section(self) -> dict:
        from windflow_tpu_torch.basic import current_time_usecs
        from windflow_tpu_torch.batch import WM_MAX, WM_NONE
        from windflow_tpu_torch.monitoring.sweep_ledger import \
            LANE_BYTES_PER_TUPLE
        if self._statics is None:
            self._statics = self._compute_statics()
        g = self._graph
        now = current_time_usecs()
        per_op: Dict[str, dict] = {}
        worst = (0.0, None)     # (imbalance ratio, op name)
        hot = (0.0, None)       # (hot key share, op name)
        sketch_usec = 0.0
        ici_time_prov = None
        for op in g._operators:
            tb = _steady_tensor_bytes(op) if op.is_gpu else None
            replicas = []
            lags = []
            for rep in op.replicas:
                wm = rep.current_wm
                front = wm if (wm != WM_NONE and wm < WM_MAX) else None
                lag = max(0, now - front) if front is not None else None
                if lag is not None:
                    lags.append(lag)
                q = rep.stats.service_hist.quantiles()
                slot = {
                    "shard": rep.index,
                    "queue_depth": len(rep.inbox),
                    "watermark_frontier_usec": front,
                    "watermark_lag_usec": lag,
                    "inputs": rep.stats.inputs_received,
                    "outputs": rep.stats.outputs_sent,
                    "dispatches": rep.stats.device_programs_launched,
                    "service_usec": {k: q.get(k)
                                     for k in ("p50", "p95", "p99")},
                }
                if tb is not None:
                    slot["hbm_bytes"] = round(
                        tb * rep.stats.device_programs_launched, 1)
                replicas.append(slot)
            entry: dict = {
                "parallelism": op.parallelism,
                "keyed": op.is_keyed,
                "replicas": replicas,
            }
            if len(lags) > 1:
                entry["lag_spread_usec"] = max(lags) - min(lags)
            sk = self._sketches.get(id(op))
            if sk is not None:
                load = sk.summary()
                entry["load"] = load
                sketch_usec += load.get("host_update_usec", 0.0)
                r = load.get("imbalance_ratio")
                if isinstance(r, (int, float)) and r > worst[0]:
                    worst = (r, op.name)
                s = load.get("hot_key_share")
                if isinstance(s, (int, float)) and s > hot[0]:
                    hot = (s, op.name)
            if op._compactor is not None:
                entry["compaction"] = op._compactor.summary()
            spec_bpt = self._statics[id(op)]["bpt"]
            if spec_bpt is not None:
                # the JAX package's ``bpt``: payload and lane bytes a
                # tuple, the basis its ICI model prices collectives by
                entry["record_bytes_per_tuple"] = \
                    spec_bpt + LANE_BYTES_PER_TUPLE
            ici = self._op_ici(op)
            if ici is not None:
                entry["ici"] = ici
                ici_time_prov = ici["ici_bandwidth_provenance"]
            per_op[op.name] = entry
        return {
            "enabled": True,
            "per_op": per_op,
            "totals": {
                "max_imbalance_ratio": round(worst[0], 4) if worst[1]
                else None,
                "max_imbalance_op": worst[1],
                "hot_key_share": round(hot[0], 4) if hot[1] else None,
                "hot_key_op": hot[1],
                **self.ici_totals(),
                "ici_time_provenance": ici_time_prov,
                "sketch_host_update_usec": round(sketch_usec, 1),
                "keyed_edges_sketched": len(self._sketches),
            },
        }
