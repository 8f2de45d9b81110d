"""Tenancy advisor: the tenant ledger's attribution as a scheduler plan
(the port of ``windflow_tpu/analysis/tenancy.py``).

The tenant ledger (``monitoring/tenant_ledger.py``) measures per-tenant
resident device bytes, dispatches, staged bytes and latency share across
every PipeGraph in the process, with the budget state machine; this
module plans: given a ``stats()["Tenant"]`` section it ranks every tenant
by budget pressure and emits the per-tenant action contract a tenant
scheduler executes.

The plan's unit of work is a **tenant action**:

``throttle_admission``
    the tenant's OVER_BUDGET verdict is active (sustained, latched):
    slow admission by the overage ratio, rounded up, before shedding
    state.

``rescale_tenant``
    the tenant is over budget (pressure > 1): ``shed_bytes`` is the
    overage to reclaim (smaller window capacity, fewer max keys, or a
    renegotiated budget).

``drain_shards``
    an over-budget tenant whose heaviest op holds at least
    ``DRAIN_SHARE`` of its resident bytes: drain that operator's shards
    first.

``rebalance_hot_tenant``
    a within-budget tenant taking at least ``HOT_SHARE`` of the
    process's decomposed latency beside other tenants: rebalance its
    placement before its neighbours' SLOs pay.

Entry points: :func:`rank` (worst pressure first) and :func:`plan` (the
scheduler contract), both read by ``tools/wf_tenant.py``.  Pure stdlib.
"""

from __future__ import annotations

import math
from typing import List

#: heaviest-op share of the tenant's resident bytes above which the
#: plan names that op's shards as the first thing to drain
DRAIN_SHARE = 0.5

#: latency share above which a within-budget tenant is "hot" enough to
#: rebalance (only with co-resident tenants — a lone tenant owns 100%)
HOT_SHARE = 0.6


def rank(tenant_section: dict) -> List[dict]:
    """Ranked per-tenant summary out of a live ``stats()["Tenant"]``
    section: highest budget pressure first, budget-less tenants last
    (ordered by resident bytes)."""
    out = []
    for name, agg in (tenant_section.get("tenants") or {}).items():
        if not isinstance(agg, dict):
            continue
        budget = agg.get("budget") or {}
        per_op = agg.get("per_op") or {}
        heaviest = agg.get("heaviest_op")
        resident = agg.get("resident_state_bytes") or 0
        h_bytes = 0
        if heaviest and isinstance(per_op.get(heaviest), dict):
            h_bytes = per_op[heaviest].get("resident_bytes") or 0
        out.append({
            "tenant": name,
            "graphs": agg.get("graphs") or [],
            "pressure": budget.get("pressure"),
            "over_budget": bool(budget.get("active")),
            "budget_bytes": budget.get("budget_bytes") or 0,
            "hbm_bytes": resident,
            "heaviest_op": heaviest,
            "heaviest_op_bytes": h_bytes,
            "dispatches": agg.get("dispatches") or 0,
            "compile_ms": agg.get("compile_ms") or 0.0,
            "h2d_bytes": agg.get("h2d_bytes") or 0,
            "d2h_bytes": agg.get("d2h_bytes") or 0,
            "ici_bytes_per_tuple": agg.get("ici_bytes_per_tuple") or 0.0,
            "latency_share": agg.get("latency_share"),
            "verdict": budget.get("verdict") or budget.get("last_verdict"),
        })
    out.sort(key=lambda r: (-(r["pressure"] or -1.0), -r["hbm_bytes"],
                            r["tenant"]))
    return out


def _actions(row: dict, n_tenants: int) -> List[dict]:
    """Tenant actions for one ranked row (deterministic: the golden plan
    the tests pin)."""
    acts: List[dict] = []
    pressure = row.get("pressure") or 0.0
    over = pressure > 1.0
    if over and row["over_budget"]:
        acts.append({
            "kind": "throttle_admission",
            "factor": int(math.ceil(pressure)),
            "note": f"OVER_BUDGET is latched at {pressure:.2f}x the "
                    f"budget — slow admission by the overage factor "
                    f"before shedding state",
        })
    if over:
        shed = max(0, row["hbm_bytes"] - row["budget_bytes"])
        acts.append({
            "kind": "rescale_tenant",
            "shed_bytes": shed,
            "note": f"resident state {row['hbm_bytes']} B exceeds the "
                    f"{row['budget_bytes']} B budget — shed {shed} B "
                    f"(smaller window capacity / fewer max keys, or "
                    f"renegotiate the budget)",
        })
        if row["hbm_bytes"] > 0 and row.get("heaviest_op") \
                and row["heaviest_op_bytes"] / row["hbm_bytes"] \
                >= DRAIN_SHARE:
            acts.append({
                "kind": "drain_shards",
                "op": row["heaviest_op"],
                "resident_bytes": row["heaviest_op_bytes"],
                "note": f"op '{row['heaviest_op']}' alone holds "
                        f"{row['heaviest_op_bytes']} B of the tenant's "
                        f"{row['hbm_bytes']} B — drain its shards "
                        f"first for the biggest reclaim per quiesce",
            })
    elif n_tenants > 1 and (row.get("latency_share") or 0.0) >= HOT_SHARE:
        acts.append({
            "kind": "rebalance_hot_tenant",
            "latency_share": row["latency_share"],
            "note": f"within budget but consuming "
                    f"{row['latency_share']:.0%} of the process's "
                    f"decomposed latency across {n_tenants} tenants — "
                    f"rebalance placement before neighbours' SLOs pay",
        })
    return acts


def plan(tenant_section: dict, top: int = 0) -> dict:
    """The tenant-scheduler contract: ranked tenants, each with its
    actions, plus the process-level reconciliation the CI gate checks
    (``attributed.staged_fraction``)."""
    ranked = rank(tenant_section)
    n = len(ranked)
    tenants = []
    for row in ranked:
        row = dict(row)
        row["actions"] = _actions(row, n)
        tenants.append(row)
    if top:
        tenants = tenants[:top]
    over = [t["tenant"] for t in tenants if t["over_budget"]]
    worst = tenants[0]["pressure"] if tenants else None
    return {
        "advisor": "tenancy/1",
        "tenants_total": n,
        "over_budget_tenants": over,
        "worst_pressure": worst,
        "attributed": tenant_section.get("attributed") or {},
        "actionable": sum(1 for t in tenants if t["actions"]),
        "tenants": tenants,
    }
