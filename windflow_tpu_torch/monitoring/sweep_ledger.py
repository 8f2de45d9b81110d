"""Sweep ledger: per-hop dispatch and tensor-byte attribution (the port
of ``windflow_tpu/monitoring/sweep_ledger.py``).

It reads counters that already exist and adds no work to the batch
path:

* **dispatches a batch a hop** — the step registry
  (``monitoring/jit_registry.py``) counts every step call on the
  operator's handle (a megastep replay counts its K rows); the ledger
  baselines the handles at graph build and divides by the replicas'
  ``device_programs_launched`` batch counts.  A chained or fused
  ``a|b`` hop shows 1 where the unfused pair shows 2.
* **bytes a hop** — the tensors one step reads and writes (input batch,
  output batch, operator state), taken from their shapes at the handle's
  first step, times the hop's dispatches: provenance ``"tensor-bytes"``
  (the JAX package reads XLA cost analysis instead).
* **the record byte model** — each hop's declared payload bytes a tuple
  (the preflight record specs, ``analysis/preflight.propagate_specs``)
  plus the 9 lane bytes every batch carries, and the measured bytes a
  tuple above it (``payload_bytes_per_tuple``,
  ``overhead_bytes_per_tuple``, ``excess_vs_model``), as in JAX;
* **hop-boundary residency** — hops whose output stays on the device and
  is consumed by the next device hop: the bytes a fused hop would never
  materialise ("fusion fuel").
* **donation misses** — meaningless for torch steps, which update their
  state in place and allocate their outputs: the key stays, ``None``,
  with the reason.

Surfaces: ``PipeGraph.stats()["Sweep"]``, ``dump_trace()`` metadata and
the postmortem bundle's ``sweep.json``.  ``Config.sweep_ledger`` off
leaves one ``is not None`` check at each read site.
"""

from __future__ import annotations

from typing import Dict, Optional

#: bytes per tuple of the lanes every device batch carries beside the
#: payload: the int64 timestamp and the bool validity mask
LANE_BYTES_PER_TUPLE = 9

#: why the donation keys are None in the port
DONATION_NOTE = ("torch steps update their state in place and allocate "
                 "their outputs: there is no input buffer to donate")


def _op_wrappers(op):
    """The step-registry handles of one operator: its own (made at its
    first step) and its fused stateless executor's."""
    out = []
    if op._watch is not None:
        out.append(op._watch)
    fx = op._fusion_exec
    if fx is not None and fx._watch is not None:
        out.append(fx._watch)
    return out


class SweepLedger:
    """Per-graph view over the step registry: built at
    ``PipeGraph._build`` (baseline dispatch snapshot), read at stats,
    trace and postmortem cadence."""

    def __init__(self, graph) -> None:
        from windflow_tpu_torch.monitoring.jit_registry import \
            default_registry
        self._graph = graph
        self._base = default_registry().dispatch_counts()
        self._wbase = {id(w): w.dispatches
                       for op in graph._operators
                       for w in _op_wrappers(op)}
        self._statics: Optional[dict] = None

    def _compute_statics(self) -> dict:
        """Record specs (the preflight walk), effective batch capacities
        and hop-boundary residency of the built graph, cached after the
        first read."""
        from windflow_tpu_torch.analysis.preflight import (_effective_caps,
                                                           _upstream_map,
                                                           propagate_specs,
                                                           record_nbytes)
        g = self._graph
        edges = g._edges()
        upstreams = _upstream_map(edges)
        in_specs, out_specs = propagate_specs(g, edges=edges,
                                              upstreams=upstreams)
        downs: Dict[int, list] = {}
        for edge in edges:
            if edge[0] == "op":
                _, a, b = edge
                downs.setdefault(id(a), []).append(b)
            else:
                # a split fans out on the host: its source is not resident
                _, mp = edge
                downs.setdefault(id(mp.operators[-1]), []).append(None)
        statics = {}
        for op in g._operators:
            caps = sorted(c for c in _effective_caps(op, upstreams) if c)
            consumers = downs.get(id(op), [])
            statics[id(op)] = {
                "capacity": caps[0] if caps else None,
                "in_bytes_per_tuple": record_nbytes(in_specs.get(id(op))),
                "out_bytes_per_tuple": record_nbytes(out_specs.get(id(op))),
                "resident_output": bool(consumers) and all(
                    c is not None and c.is_gpu for c in consumers),
            }
        return statics

    def section(self) -> dict:
        from windflow_tpu_torch.monitoring.jit_registry import \
            default_registry
        from windflow_tpu_torch.ops.source import Source
        if self._statics is None:
            self._statics = self._compute_statics()
        snapshot = default_registry().snapshot()
        g = self._graph
        # ops sharing one name merge into one hop, as the registry does
        groups: Dict[str, list] = {}
        for op in g._operators:
            groups.setdefault(op.name, []).append(op)
        fused_member_of: Dict[str, str] = {}
        fused_hosts: Dict[str, dict] = {}
        for seg in g._fused_segments:
            for n in seg["member_names"][:-1]:
                fused_member_of[n] = seg["name"]
            fused_hosts[seg["host_name"]] = seg
        per_hop: Dict[str, dict] = {}
        claimed = set()
        tot_bpt = tot_dpb = 0.0
        tot_disp = tot_attr_disp = 0
        for op in g._operators:
            key = op.name
            if key in per_hop:
                continue
            siblings = groups[key]
            wrappers = [w for sib in siblings for w in _op_wrappers(sib)]
            if not op.is_gpu and not wrappers:
                continue
            claimed.update(w.op_name for w in wrappers)
            batches = sum(r.stats.device_programs_launched
                          for sib in siblings for r in sib.replicas)
            disp = attr_disp = 0
            bytes_total = 0.0
            # the hop's dominant handle: its bytes are the steady cost of
            # one more batch, undiluted by one-shot steps (an EOS flush)
            primary_d, primary = 0, None
            for w in wrappers:
                d = w.dispatches - self._wbase.get(id(w), 0)
                if d <= 0:
                    continue
                disp += d
                if w.tensor_bytes is not None:
                    attr_disp += d
                    bytes_total += d * float(w.tensor_bytes)
                    if d > primary_d:
                        primary_d, primary = d, w
            st = self._statics.get(id(op), {})
            cap = st.get("capacity")
            hop = {
                "kind": type(op).__name__,
                "batches": batches,
                "dispatches": disp,
                "dispatches_per_batch":
                    round(disp / batches, 3) if batches else None,
                "capacity": cap,
                "resident_output": st.get("resident_output", False),
                # the key stays for the JAX package's readers
                "donation_miss": None,
                "donation_miss_reason": DONATION_NOTE,
            }
            if key in fused_member_of and all(
                    sib._fused_into is not None for sib in siblings):
                # an inert member: its work runs in the fused hop
                hop["fused_into"] = fused_member_of[key]
            elif key in fused_hosts:
                seg = fused_hosts[key]
                hop["fused_program"] = seg["name"]
                hop["fused_members"] = seg["member_names"]
            if batches and attr_disp:
                bpb = bytes_total / batches
                hop["bytes_per_batch"] = round(bpb, 1)
                hop["bytes_per_tuple"] = round(bpb / cap, 2) if cap \
                    else None
                hop["bytes_provenance"] = "tensor-bytes"
                if primary is not None and cap:
                    hop["steady_bytes_per_tuple"] = \
                        round(primary.tensor_bytes / cap, 2)
                if disp > attr_disp:
                    hop["unattributed_dispatches"] = disp - attr_disp
            payload = st.get("in_bytes_per_tuple")
            if payload is not None:
                model = payload + LANE_BYTES_PER_TUPLE
                hop["payload_bytes_per_tuple"] = model
                bpt = hop.get("bytes_per_tuple")
                if bpt is not None:
                    hop["overhead_bytes_per_tuple"] = round(bpt - model, 2)
                    hop["excess_vs_model"] = round(bpt / model, 2)
            if st.get("resident_output") and cap and primary is not None:
                # what a fused hop never materialises: the output lanes
                hop["fusion_fuel_bytes_per_batch"] = primary.out_bytes
            per_hop[key] = hop
            if hop.get("bytes_per_tuple") is not None:
                tot_bpt += hop["bytes_per_tuple"]
            if hop["dispatches_per_batch"] is not None \
                    and not isinstance(op, Source):
                tot_dpb += hop["dispatches_per_batch"]
            tot_disp += disp
            tot_attr_disp += attr_disp
        # programs that dispatched but belong to no hop (the device keyby
        # split)
        non_hop = {}
        for name, e in snapshot.items():
            if name in claimed:
                continue
            d = e.get("dispatches", 0) - self._base.get(name, 0)
            if d > 0:
                non_hop[name] = {"dispatches": d}
                tot_disp += d
        chains = []
        dsaved = bsaved = 0.0
        for seg in g._fused_segments:
            n_members = len(seg["member_names"])
            dpb = (per_hop.get(seg["host_name"]) or {}) \
                .get("dispatches_per_batch")
            bsum = 0.0
            for mn in seg["member_names"][:-1]:
                fuel = (per_hop.get(mn) or {}) \
                    .get("fusion_fuel_bytes_per_batch")
                if fuel:
                    bsum += 2 * fuel
            entry = {
                "name": seg["name"],
                "members": seg["member_names"],
                "host": seg["host_name"],
                "donated_inputs": False,
                "dispatches_per_batch": dpb,
                "unfused_dispatches_per_batch": float(n_members),
                "bytes_saved_per_batch": round(bsum, 1),
            }
            if dpb is not None:
                entry["dispatches_saved_per_batch"] = \
                    round(n_members - dpb, 3)
                dsaved += n_members - dpb
            bsaved += bsum
            chains.append(entry)
        wire_h2d = sum(r.stats.h2d_bytes for r in g._all_replicas)
        logical_h2d = sum(r.stats.h2d_logical_bytes for r in g._all_replicas)
        # each process stages only its own lanes: the bytes are this
        # process's share (parallel/multihost.py)
        from windflow_tpu_torch.parallel.multihost import (process_count,
                                                           process_index)
        return {
            "enabled": True,
            "per_hop": per_hop,
            "non_hop": non_hop,
            "wire": {
                "process_index": process_index(),
                "process_count": process_count(),
                "wire_bytes": wire_h2d,
                "logical_bytes": logical_h2d,
                "compression_ratio": round(logical_h2d / wire_h2d, 4)
                if wire_h2d else None,
                "bytes_provenance": "measured",
            },
            "fusion": {
                "enabled": bool(chains),
                "fused_chains": [c["name"] for c in chains],
                "chains": chains,
                "dispatches_saved_per_batch": round(dsaved, 3),
                "bytes_saved_per_batch": round(bsaved, 1),
            },
            "totals": {
                "bytes_per_tuple": round(tot_bpt, 2),
                "bytes_provenance": "tensor-bytes",
                "dispatches_per_batch": round(tot_dpb, 3),
                # None: see each hop's donation_miss_reason
                "donation_miss_bytes_per_batch": None,
                "dispatches": tot_disp,
                "cost_attributed_dispatch_fraction":
                    round(tot_attr_disp / tot_disp, 4) if tot_disp
                    else None,
            },
        }
