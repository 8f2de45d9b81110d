"""Latency advisor: the latency ledger's decomposition as a sizing plan
(the port of ``windflow_tpu/analysis/latency.py``).

The latency ledger (``monitoring/latency_ledger.py``) measures five
critical-path segment histograms per operator, the rolling e2e p99 and
the SLO verdict; this module plans: given a ``stats()["Latency_plane"]``
section it ranks every operator by its share of the decomposed critical
path and emits the per-operator knob contract an adaptive sizer
implements.

The plan's unit of work is a **knob override**:

``set_megastep_sweeps``
    the dominant segment is ``emitted_to_dispatched`` (the megastep
    K-wait) on an operator with a megastep edge and the e2e p99 is over
    budget: ``recommended_k = clamp(k // ceil(p99 / budget), 1, k)``,
    cutting the group wait by at least the overshoot factor.

``shrink_tick_chunk``
    the dominant segment is ``staged_to_emitted`` (ingest and staging)
    and the p99 is over budget: shrink the source's tick chunk by the
    overshoot factor.

``regrow_megastep_sweeps``
    the p99 is under budget with at least ``REGROW_HEADROOM``× headroom
    on an operator with a megastep edge: double K back toward
    throughput.  Only with an SLO declared.

Entry points: :func:`rank` (worst budget share first) and :func:`plan`
(the sizer contract), both read by ``tools/wf_slo.py``.  Pure stdlib.
"""

from __future__ import annotations

import math
from typing import List, Optional

#: p99 must be under budget by this factor before the advisor suggests
#: regrowing megastep K back toward throughput
REGROW_HEADROOM = 2.0

#: segments whose fix is a megastep-K shrink vs a source-side shrink
_K_WAIT_SEGMENT = "emitted_to_dispatched"
_INGEST_SEGMENT = "staged_to_emitted"


def rank(latency_section: dict) -> List[dict]:
    """Ranked per-operator summary out of a live
    ``stats()["Latency_plane"]`` section: largest budget share first."""
    out = []
    for name, entry in (latency_section.get("per_op") or {}).items():
        if not isinstance(entry, dict):
            continue
        segs = entry.get("segments_usec") or {}
        row = {
            "op": name,
            "budget_share": entry.get("budget_share"),
            "total_usec": entry.get("total_usec"),
            "dominant_segment": entry.get("dominant_segment"),
            "segment_p99_usec": {
                seg: (q or {}).get("p99") for seg, q in segs.items()
                if isinstance(q, dict)},
            "device_busy_usec": entry.get("device_busy_usec"),
        }
        if entry.get("megastep_k"):
            row["megastep_k"] = entry["megastep_k"]
            row["freshness_floor_usec"] = \
                entry.get("freshness_floor_usec")
        if isinstance(entry.get("freshness_usec"), dict):
            row["freshness_p99_usec"] = \
                entry["freshness_usec"].get("p99")
        out.append(row)
    out.sort(key=lambda r: r["budget_share"] or 0.0, reverse=True)
    return out


def _actions(row: dict, over: float, headroom: float) -> List[dict]:
    """Knob overrides for one ranked op given the graph-wide overshoot
    factor (p99/budget; 0 when no SLO is declared)."""
    acts: List[dict] = []
    k = row.get("megastep_k") or 0
    dom = row.get("dominant_segment")
    if over > 1.0:
        if dom == _K_WAIT_SEGMENT and k > 1:
            rec = max(1, min(k, k // int(math.ceil(over))))
            if rec < k:
                acts.append({
                    "kind": "set_megastep_sweeps",
                    "from_k": k,
                    "recommended_k": rec,
                    "note": f"megastep K-wait dominates at "
                            f"{over:.2f}x the budget — cut the group "
                            f"wait by the overshoot factor",
                })
        elif dom == _INGEST_SEGMENT:
            factor = int(math.ceil(over))
            acts.append({
                "kind": "shrink_tick_chunk",
                "shrink_factor": factor,
                "note": f"ingest/staging wait dominates at "
                        f"{over:.2f}x the budget — tuples queue before "
                        f"entering the graph; shrink the source tick "
                        f"chunk {factor}x",
            })
    elif 0.0 < over and headroom >= REGROW_HEADROOM and k >= 1:
        acts.append({
            "kind": "regrow_megastep_sweeps",
            "from_k": k,
            "recommended_k": k * 2,
            "note": f"p99 holds {headroom:.1f}x headroom under the "
                    f"budget — trade latency back for throughput",
        })
    return acts


def plan(latency_section: dict, graph_name: Optional[str] = None,
         top: int = 0) -> dict:
    """The adaptive-sizer contract: ranked ops, each with its knob
    overrides.  ``over_budget``/``headroom_ratio`` are graph-wide (the
    SLO is an e2e budget); actions are per-operator, attributed by each
    op's dominant segment."""
    slo = latency_section.get("slo") or {}
    budget_ms = slo.get("budget_ms") or latency_section.get("slo_ms") or 0
    p99_usec = (latency_section.get("e2e_usec") or {}).get("p99") or 0
    p99_ms = p99_usec / 1000.0
    over = (p99_ms / budget_ms) if budget_ms and p99_ms else 0.0
    headroom = (budget_ms / p99_ms) if budget_ms and p99_ms else 0.0
    ops = []
    for row in rank(latency_section):
        row = dict(row)
        row["actions"] = _actions(row, over, headroom)
        ops.append(row)
    if top:
        ops = ops[:top]
    return {
        "advisor": "latency/1",
        "graph": graph_name,
        "slo_budget_ms": budget_ms or None,
        "e2e_p99_ms": round(p99_ms, 3),
        "over_budget": over > 1.0,
        "overshoot_factor": round(over, 4) if over else None,
        "headroom_ratio": round(headroom, 4) if headroom else None,
        "slo_active": bool(slo.get("active")),
        "verdict": slo.get("verdict") or slo.get("last_verdict"),
        "traces_decomposed": latency_section.get("traces_decomposed"),
        "actionable": sum(1 for o in ops if o["actions"]),
        "ops": ops,
    }
