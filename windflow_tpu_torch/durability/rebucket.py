"""Re-bucketing of checkpointed keyed state for shape-changing restores
(the port of ``windflow_tpu/durability/rebucket.py``, its replica
shapes).

``PipeGraph.restore()`` onto a graph whose keyed operator runs at a
different parallelism re-buckets each keyed row/entry to the replica the
NEW placement assigns it.  Every checkpoint snapshot is taken at a
quiesced aligned barrier with the state pulled to host numpy, so a
rescale is pure host-side array surgery between ``load_checkpoint`` and
``restore_state``.  Placement mirrors the routing plane exactly (the
state must land where the keys will):

* host ``KeyByEmitter`` edges (host Reduce): ``stable_hash(key) % n``;
* keyed staging / device keyby edges (FFAT, stateful):
  ``splitmix64(k32) % n``;
* compacted key spaces (``parallel/compaction.py``): ``slot % n`` — the
  remap table itself rides the operator blob;
* recorded placement overrides are applied before the hash.

Mesh shapes re-bucket too (:func:`mesh_shape` is the manifest's
record): CB pane tables and stateful slot tables are one global table
whose key rows split over any key axis that divides them; TB rings carry
one clock lane a key shard, re-shaped onto the new key axis when the
clocks agree.

What cannot re-bucket raises :class:`RescaleError` (WF605): state of an
unknown kind, TB pane rings whose per-replica or per-shard clocks
disagree at the barrier, and a key space the new key axis does not
divide.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from windflow_tpu_torch.basic import WindFlowError, int32_key, stable_hash
from windflow_tpu_torch.utils.tree import tree_flatten, tree_map

#: the TB scalar-clock lanes of a ring state (shape ())
TB_SCALARS = ("base", "win_next", "max_seen", "n_late", "n_evicted",
              "n_win_dropped")
#: TB clock lanes that must AGREE across merged replica states (the ring
#: alignment invariants); the remaining scalars merge (max / sum)
TB_ALIGNED = ("base", "win_next")


class RescaleError(WindFlowError):
    """A shape-changing restore that cannot re-bucket (WF605)."""

    def __init__(self, op_name: str, why: str) -> None:
        super().__init__(
            f"WF605 restore: operator '{op_name}' cannot re-bucket its "
            f"checkpointed state onto the new shard shape — {why}")


def mesh_shape(mesh) -> Optional[dict]:
    """The JSON-able shape record a checkpoint manifest pins for a mesh
    graph (the JAX package's layout)."""
    if mesh is None:
        return None
    return {"devices": int(mesh.size), "data": int(mesh.shape["data"]),
            "key": int(mesh.shape["key"])}


def _owner_fn(kind: str, n: int, override: Optional[dict]):
    """Shard owner of a key/row under one placement — bit-identical to
    the emitter the edge routes through (parallel/emitters.py).  The
    override map must be keyed in the SAME domain the owner is asked
    about (user keys for hash placements, ring rows for ``slot_mod``)."""
    from windflow_tpu_torch.parallel.emitters import splitmix64_int
    ov = override or {}

    def owner(key) -> int:
        d = ov.get(key)
        if isinstance(d, int) and 0 <= d < n:
            return d
        if kind == "slot_mod":
            return int(key) % n
        if kind == "stable_hash":
            return stable_hash(key) % n
        return splitmix64_int(int32_key(key)) % n

    return owner


def _slot_override(blob: dict, override: Optional[dict]
                   ) -> Optional[dict]:
    """Translate a key→shard override (USER keys — the domain the
    emitters route by) into the ROW/slot domain a compacted ring's state
    is indexed by, through the compactor's checkpointed key→slot map."""
    if not override:
        return None
    key_slot = (blob.get("compactor") or {}).get("key_slot") or {}
    ks = {int32_key(k): int(v) for k, v in key_slot.items()}
    out = {}
    for k, dst in override.items():
        slot = ks.get(int32_key(k))
        if slot is not None:
            out[slot] = dst
    return out or None


# ---------------------------------------------------------------------------
# per-kind re-bucketing
# ---------------------------------------------------------------------------

def _rebucket_reduce_host(op, blob, new_p: int,
                          override: Optional[dict]) -> dict:
    """Host Reduce per-replica per-key dicts: merge, re-split by the
    host keyby placement (``stable_hash(key) % n`` with overrides
    first) — each key's rolling state lands on the replica its tuples
    will now reach."""
    merged = {}
    for d in blob.get("replicas") or []:
        merged.update(d)
    owner = _owner_fn("stable_hash", new_p, override)
    reps = [dict() for _ in range(new_p)]
    for k, v in merged.items():
        reps[owner(k)][k] = v
    return {"kind": "reduce_host", "replicas": reps}


def _tb_scalar(v) -> np.ndarray:
    """A TB clock scalar as a 1-D lane array (states carry shape ())."""
    a = np.asarray(v)
    return a.reshape(1) if a.ndim == 0 else a


def _check_aligned(op, states: dict, names=TB_ALIGNED) -> dict:
    """All contributing TB states must agree on the ring alignment
    scalars; returns the agreed value per name."""
    agreed = {}
    for name in names:
        vals = set()
        for st in states.values():
            for x in _tb_scalar(st[name]).tolist():
                vals.add(int(x))
        if len(vals) > 1:
            raise RescaleError(
                op.name,
                f"TB pane-ring clocks disagree across shards at the "
                f"checkpoint barrier ({name} in {sorted(vals)}); "
                "restore once on the checkpointed shape to reconcile "
                "the rings, then rescale")
        agreed[name] = vals.pop() if vals else 0
    return agreed


def _rebucket_ffat(op, blob, old_p: int, new_p: int, old_kk: int,
                   new_kk: int, override: Optional[dict]) -> dict:
    """FFAT pane rings.  CB state is purely per-key (one shared table,
    per-key clock lanes): it passes through, once the new mesh key axis
    divides the key space.  TB state carries ring clocks: one lane a
    mesh key shard, or one full ring a replica when keyed at
    parallelism > 1; both re-bucket only when the clocks agree at the
    barrier (see :class:`RescaleError`)."""
    K = int(op.max_keys)
    if new_kk > 1 and K % new_kk:
        raise RescaleError(
            op.name, f"max_keys {K} not divisible by the new mesh key "
                     f"axis {new_kk}")
    states: Dict[int, dict] = blob["states"]
    is_tb = bool(getattr(op, "is_tb", False))
    kind = "slot_mod" if blob.get("compactor") is not None else "splitmix"
    old_per_rep = is_tb and op.key_extractor is not None and old_p > 1
    new_per_rep = is_tb and op.key_extractor is not None and new_p > 1
    if not old_per_rep and not new_per_rep:
        if not is_tb or old_kk == new_kk or not states:
            return blob     # per-key state only: nothing shard-local
        # the TB clock lanes re-shaped old_kk -> new_kk (1: one device)
        st = dict(states[0])
        agreed = _check_aligned(op, {0: st})

        def lane(name, fill, first_only=False):
            a = np.zeros((max(1, new_kk),), _tb_scalar(st[name]).dtype)
            if first_only:
                a[0] = fill
            else:
                a[:] = fill
            return a if new_kk > 1 else a.reshape(())
        for name in TB_ALIGNED:
            st[name] = lane(name, agreed[name])
        st["max_seen"] = lane("max_seen",
                              int(_tb_scalar(st["max_seen"]).max()))
        for name in ("n_late", "n_evicted", "n_win_dropped"):
            st[name] = lane(name, int(_tb_scalar(st[name]).sum()),
                            first_only=True)
        out = dict(blob)
        out["states"] = {0: st}
        return out

    live = {s: st for s, st in states.items() if st}
    if not live:
        return blob
    agreed = _check_aligned(op, live)
    max_seen = max(int(_tb_scalar(st["max_seen"]).max())
                   for st in live.values())
    counters = {name: sum(int(_tb_scalar(st[name]).sum())
                          for st in live.values())
                for name in ("n_late", "n_evicted", "n_win_dropped")}
    if kind == "slot_mod":
        # compacted rings index rows by SLOT; overrides are keyed by
        # USER key — translate through the checkpointed remap
        override = _slot_override(blob, override)
    owner_old = _owner_fn(kind, max(1, old_p), override if old_per_rep
                          else None)
    owner_new = _owner_fn(kind, max(1, new_p), override)
    o_old = np.array([owner_old(r) for r in range(K)])
    o_new = np.array([owner_new(r) for r in range(K)])
    template = next(iter(live.values()))
    n_new_states = new_p if new_per_rep else 1

    def build(j: int) -> dict:
        out = {}
        rows_j = o_new == j if new_per_rep else np.ones(K, bool)
        for name, val in template.items():
            if name in TB_SCALARS:
                dt = _tb_scalar(val).dtype
                if name in TB_ALIGNED:
                    v = agreed[name]
                elif name == "max_seen":
                    v = max_seen
                else:
                    v = counters[name] if j == 0 else 0
                out[name] = np.asarray(v, dt).reshape(())
                continue
            # per-key leaves (cells/cell_valid/horizon): axis 0 is K;
            # each leaf is matched across the old states by its index in
            # the flattened tree
            t_leaves = tree_flatten(val)[0]
            srcs = {s: tree_flatten(st[name])[0] for s, st in live.items()}

            def gather(i, leaf):
                acc = np.zeros_like(np.asarray(leaf))
                for s in live:
                    m = rows_j & (o_old == s)
                    if m.any():
                        acc[m] = np.asarray(srcs[s][i])[m]
                return acc

            idx = iter(range(len(t_leaves)))
            out[name] = tree_map(lambda leaf: gather(next(idx), leaf), val)
        return out

    out = dict(blob)
    out["states"] = {j: build(j) for j in range(n_new_states)}
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _rebucket_stateful(op, blob, new_kk: int) -> dict:
    """A stateful slot table is one table shared by the replicas (and
    split by key rows on a mesh): shape-independent, once the new key
    axis divides it."""
    S = int(getattr(op, "num_key_slots", 0) or 0)
    if new_kk > 1 and S and S % new_kk:
        raise RescaleError(
            op.name, f"num_key_slots {S} not divisible by the new mesh "
                     f"key axis {new_kk}")
    return blob


def rebucket_blob(op, blob: dict, old_p: int, new_p: int,
                  old_mesh: Optional[dict] = None,
                  new_mesh: Optional[dict] = None,
                  override: Optional[dict] = None) -> dict:
    """Re-bucket one operator's checkpoint blob from the shape it was
    written under (``old_p`` replicas on ``old_mesh``) onto the shape the
    restoring graph builds (``new_p`` on ``new_mesh``, :func:`mesh_shape`
    records).  Blobs whose state is shape-independent pass through
    unchanged; unknown kinds under a genuine shape change raise
    :class:`RescaleError`."""
    old_kk = (old_mesh or {}).get("key", 1) or 1
    new_kk = (new_mesh or {}).get("key", 1) or 1
    if old_p == new_p and old_kk == new_kk \
            and (old_mesh is None) == (new_mesh is None):
        return blob
    kind = blob.get("kind") if isinstance(blob, dict) else None
    if kind == "reduce_host":
        return _rebucket_reduce_host(op, blob, new_p, override)
    if kind == "ffat_tpu":
        return _rebucket_ffat(op, blob, old_p, new_p, old_kk, new_kk,
                              override)
    if kind == "stateful_tpu":
        return _rebucket_stateful(op, blob, new_kk)
    if kind == "reduce_tpu":
        # drop counters + remap: shard-shape independent
        return blob
    raise RescaleError(
        op.name,
        f"state of kind {kind!r} has no re-bucketing rule (the operator "
        "declares neither a dense key space nor a compaction remap)")
