"""Reshard advisor (the port of ``windflow_tpu/analysis/resharding.py``):
rank shard imbalance and emit a rebalance plan.

The shard ledger (``monitoring/shard_ledger.py``) measures per-shard
load, hot keys and lag spread; this module plans: given a live
``stats()["Shard"]`` section it ranks every keyed operator by imbalance
and emits the rebalance contract a resharding executor implements.

The unit of work is a **key→shard override**: a keyed edge places
``splitmix64(key) % n`` (``stable_hash`` on host edges); an executor
honouring an override map routes the named keys to their assigned shard
before the hash.  The advisor builds the map greedily from the ledger's
hot-key table — the hottest known keys move off the most loaded shard
onto the least loaded until the projection balances — and flags keys
too hot to place anywhere (``split_hot_key``: one key above the mean
per-shard load needs a partial-aggregation tier, not placement).

Entry points: :func:`imbalance` (ranked per-op summary),
:func:`rebalance_actions` and :func:`plan` (the executor contract).
"""

from __future__ import annotations

from typing import List, Optional

#: imbalance ratio (max shard load over mean) below which an operator
#: is considered balanced — no plan entry is emitted for it
DEFAULT_THRESHOLD = 1.25


def imbalance(shard_section: dict) -> List[dict]:
    """Ranked per-operator imbalance summary out of a live
    ``stats()["Shard"]`` section: worst first, keyed operators with a
    measured load only."""
    out = []
    for name, entry in (shard_section.get("per_op") or {}).items():
        load = entry.get("load")
        if not isinstance(load, dict):
            continue
        row = {
            "op": name,
            "parallelism": entry.get("parallelism"),
            "n_shards": load.get("n_shards"),
            "placement": load.get("placement"),
            "basis": load.get("basis"),
            "total_tuples": load.get("total_tuples", 0),
            "loads": load.get("tuples") or [],
            "imbalance_ratio": load.get("imbalance_ratio"),
            "hot_shard": load.get("hot_shard"),
            "hot_keys": load.get("hot_keys") or [],
            "hot_key_share": load.get("hot_key_share"),
            "lag_spread_usec": entry.get("lag_spread_usec"),
        }
        if entry.get("ici"):
            row["ici_bytes_per_tuple"] = \
                entry["ici"].get("ici_bytes_per_tuple")
        out.append(row)
    out.sort(key=lambda r: (r["imbalance_ratio"] or 0.0,
                            r["hot_key_share"] or 0.0), reverse=True)
    return out


def _project(loads: List[int], moves: List[dict]) -> Optional[float]:
    """Imbalance ratio after applying the move list to the load vector."""
    sim = list(loads)
    for m in moves:
        sim[m["from_shard"]] -= m["est_tuples"]
        sim[m["to_shard"]] += m["est_tuples"]
    total = sum(sim)
    if total <= 0 or not sim:
        return None
    return round(max(sim) / (total / len(sim)), 4)


def _rebalance_actions(row: dict, threshold: float) -> List[dict]:
    """Greedy move plan for one operator: shift the hottest KNOWN keys
    off overloaded shards onto the least loaded one until the projection
    balances (or the hot-key table runs dry — the ledger only knows the
    top-K, and an honest plan says what it could not place)."""
    loads = list(row["loads"])
    n = len(loads)
    total = sum(loads)
    if n < 2 or total <= 0:
        return []
    mean = total / n
    actions: List[dict] = []
    moves: List[dict] = []
    sim = list(loads)
    # hottest first; each key is movable once, to the then-coldest shard
    for hk in sorted(row["hot_keys"],
                     key=lambda h: h.get("est_tuples", 0), reverse=True):
        src = hk.get("shard")
        est = hk.get("est_tuples", 0)
        if src is None or not isinstance(src, int) or not est:
            continue
        if est > mean:
            # routing cannot balance a key hotter than a whole shard's
            # fair share: it needs a partial-aggregation split tier
            actions.append({
                "kind": "split_hot_key",
                "key": hk["key"],
                "est_tuples": est,
                "share": hk.get("share"),
                "note": "single key exceeds the mean per-shard load "
                        f"({est} > {mean:.0f}); moving it only moves "
                        "the hot spot — pre-aggregate it across shards",
            })
            continue
        if sim[src] / mean <= threshold:
            continue    # its shard is already within bounds
        dst = min(range(n), key=lambda i: sim[i])
        if dst == src:
            continue
        moves.append({"key": hk["key"], "from_shard": src,
                      "to_shard": dst, "est_tuples": est})
        sim[src] -= est
        sim[dst] += est
    if moves:
        actions.insert(0, {
            "kind": "move_keys",
            "moves": moves,
            # the executor contract: route these keys to the assigned
            # shard BEFORE the hash placement
            "override": {str(m["key"]): m["to_shard"] for m in moves},
            "projected_imbalance_ratio": _project(row["loads"], moves),
        })
    return actions


def rebalance_actions(row: dict, threshold: float = DEFAULT_THRESHOLD
                      ) -> List[dict]:
    """Public form of the per-operator action builder: given one
    :func:`imbalance` row (loads + hot-key table), emit the
    move_keys/split_hot_key actions (a reshard executor's trigger may
    fire before the cumulative ratio crosses the plan threshold)."""
    return _rebalance_actions(row, threshold)


def plan(shard_section: dict, graph_name: Optional[str] = None,
         threshold: float = DEFAULT_THRESHOLD, top: int = 0) -> dict:
    """The reshard plan (the ``fusion.plan`` shape): keyed
    operators ranked worst-imbalance first, each with its measured loads
    and the rebalance actions a resharding executor would apply.
    ``threshold`` bounds what counts as imbalanced (max/mean);
    operators at or under it appear with an empty action list only when
    nothing else qualifies."""
    if not isinstance(shard_section, dict) \
            or not shard_section.get("enabled", True):
        return {"graph": graph_name, "threshold": threshold, "ops": []}
    rows = imbalance(shard_section)
    ops = []
    for row in rows:
        r = row.get("imbalance_ratio")
        actionable = isinstance(r, (int, float)) and r > threshold
        entry = dict(row)
        entry["actions"] = _rebalance_actions(row, threshold) \
            if actionable else []
        ops.append(entry)
    if top:
        ops = ops[:top]
    return {
        "graph": graph_name,
        "threshold": threshold,
        "ops": ops,
        "actionable": sum(1 for o in ops if o["actions"]),
    }
