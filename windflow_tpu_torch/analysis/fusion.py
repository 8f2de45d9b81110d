"""Fusion advisor (the port of ``plan`` in ``windflow_tpu/analysis/
fusion.py``): the maximal fusible chains of a graph, ranked by what
fusing them would save a batch.

``fusion/chains.fusible_chains`` finds the runs of adjacent device
operators one hop could replace (the runs ``Config.whole_chain_fusion``
fuses at build); :func:`plan` ranks them by the bytes a fused hop never
writes and re-reads at its interior boundaries, then by the step
dispatches it saves.  Given a ``stats()["Sweep"]`` section it ranks by
the MEASURED per-hop numbers (dispatches a batch, the boundary tensor
bytes); without one, a dispatch a member and the boundary bytes of the
preflight record specs (``analysis/preflight.propagate_specs``).
"""

from __future__ import annotations

from typing import Optional


def _batched_bytes(spec_bytes: Optional[int],
                   capacity: Optional[int]) -> Optional[int]:
    from windflow_tpu_torch.monitoring.sweep_ledger import \
        LANE_BYTES_PER_TUPLE
    if spec_bytes is None or not capacity:
        return None
    return (spec_bytes + LANE_BYTES_PER_TUPLE) * capacity


def plan(graph, sweep: Optional[dict] = None, top: int = 0) -> dict:
    """The fusion plan: chains ranked by projected bytes saved a batch
    (each interior boundary's batch, written by one hop and read by the
    next, both gone in one hop), then by dispatches saved.  ``sweep``
    (a live ``stats()["Sweep"]``) upgrades the projection to measured
    dispatch counts and boundary bytes."""
    from windflow_tpu_torch.analysis.preflight import (_effective_caps,
                                                       _upstream_map,
                                                       propagate_specs,
                                                       record_nbytes)
    from windflow_tpu_torch.fusion.chains import fusible_chains
    edges = graph._edges()
    upstreams = _upstream_map(edges)
    _, out_specs = propagate_specs(graph, edges=edges, upstreams=upstreams)
    per_hop = (sweep or {}).get("per_hop") or {}
    out = []
    for chain in fusible_chains(graph):
        ops = chain["ops"]
        disp_now = 0.0
        bytes_saved = 0.0
        measured = True
        for op in ops:
            d = (per_hop.get(op.name) or {}).get("dispatches_per_batch")
            if d is None:
                d = 1.0
                measured = False
            disp_now += d
        for op in ops[:-1]:     # interior boundaries only
            bb = (per_hop.get(op.name) or {}) \
                .get("fusion_fuel_bytes_per_batch")
            if bb is None:
                caps = sorted(c for c in _effective_caps(op, upstreams)
                              if c)
                bb = _batched_bytes(record_nbytes(out_specs.get(id(op))),
                                    caps[0] if caps else None)
                measured = False
            if bb:
                bytes_saved += 2 * bb
        out.append({
            "ops": [op.name for op in ops],
            "links": chain["links"],
            "provable_now": all(k == "chainable" for k in chain["links"]),
            "tail_boundary": chain["tail_boundary"],
            "dispatches_per_batch_now": round(disp_now, 3),
            "dispatches_saved_per_batch": round(disp_now - 1.0, 3),
            "projected_bytes_saved_per_batch": round(bytes_saved, 1),
            # the port donates no buffer: nothing to miss (sweep ledger)
            "donation_miss_bytes_per_batch": 0.0,
            "basis": "measured" if (measured and per_hop) else "projected",
        })
    out.sort(key=lambda c: (c["projected_bytes_saved_per_batch"],
                            c["dispatches_saved_per_batch"]),
             reverse=True)
    if top:
        out = out[:top]
    return {"graph": graph.name, "chains": out}
