"""Restore-time checks (the port of the restore half of
``windflow_tpu/analysis/preflight.py``): the WF602 named diff between a
composed graph and a checkpoint manifest, and the WF605 rescale plan.
The graph preflight passes (WF1xx-WF6xx at ``start()``) are not ported
yet."""

from __future__ import annotations

from typing import List

from windflow_tpu_torch.analysis.diagnostics import Diagnostic


def _checkpoints_unrebucketable_state(op) -> bool:
    """True when the operator overrides ``snapshot_state`` (it
    checkpoints something) but is none of the kinds
    ``durability/rebucket.py`` knows how to re-bucket."""
    from windflow_tpu_torch.ops.base import Operator
    impl = type(op).snapshot_state
    if impl is Operator.snapshot_state:
        return False    # stateless: nothing to re-bucket
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.ops.reduce_op import Reduce
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    # identity on the IMPLEMENTATION, not the class: a subclass that
    # overrides snapshot_state checkpoints a kind the re-bucketer has
    # never seen, however familiar its base class is
    known = {Reduce.snapshot_state, ReduceGPU.snapshot_state,
             FfatWindowsGPU.snapshot_state,
             _StatefulGPUBase.snapshot_state}
    return impl not in known


def manifest_conflicts(graph, manifest,
                       allow_rescale: bool = False) -> List[Diagnostic]:
    """WF602: named diff between a composed (possibly unbuilt) graph and
    a checkpoint manifest's topology signature — the gate
    ``PipeGraph.restore()`` runs before touching any state.  Empty list
    means the restore may proceed.

    ``allow_rescale`` (the ``manifest_rescale_plan`` path) exempts the
    supported shape change from WF602: a parallelism difference on a
    KEYED non-terminal, non-source operator (restore on N±1 replica
    shards), which re-buckets state through ``durability/rebucket.py``
    instead of refusing."""
    from windflow_tpu_torch.durability.checkpoint import topology_signature
    from windflow_tpu_torch.ops.source import Source
    diags: List[Diagnostic] = []
    want = manifest.get("topology") or []
    ops = graph._topo_operators()
    have = topology_signature(ops)
    if len(want) != len(have):
        diags.append(Diagnostic(
            "WF602",
            f"checkpoint has {len(want)} operator(s), graph has "
            f"{len(have)} — "
            f"checkpoint: {[w['name'] for w in want]}, "
            f"graph: {[h['name'] for h in have]}"))
        return diags
    for i, (w, h) in enumerate(zip(want, have)):
        for field in ("name", "type", "parallelism", "routing",
                      "is_tpu", "record_spec"):
            if w.get(field) == h.get(field):
                continue
            op = ops[i]
            if allow_rescale and field == "parallelism" \
                    and op.key_extractor is not None \
                    and not op.is_terminal \
                    and not isinstance(op, Source):
                continue    # keyed replica rescale: re-bucketable
            hint = ("restore needs the same composition that wrote "
                    "the checkpoint (names, types, parallelism, "
                    "record specs)")
            if field == "parallelism":
                hint += ("; only keyed non-terminal operators may "
                         "change parallelism on a rescale restore")
            diags.append(Diagnostic(
                "WF602",
                f"operator #{i} {field} differs: checkpoint has "
                f"{w.get(field)!r} ('{w.get('name')}'), graph has "
                f"{h.get(field)!r} ('{h.get('name')}')",
                node=h.get("name"), hint=hint))
    return diags


def manifest_rescale_plan(graph, manifest):
    """Restore-time validation with rescale awareness: returns
    ``(diagnostics, rescaled)``.  Blocking diagnostics are WF602
    (genuine topology mismatch) and WF605 (a shape change the state
    cannot re-bucket: an operator of unknown state kind, or a manifest
    written on a mesh).  ``rescaled`` is True when a keyed parallelism
    change is in effect."""
    diags = manifest_conflicts(graph, manifest, allow_rescale=True)
    want = manifest.get("topology") or []
    ops = graph._topo_operators()
    rescaled = False
    if len(want) == len(ops):
        for w, op in zip(want, ops):
            if w.get("parallelism") == op.parallelism:
                continue
            rescaled = True
            if _checkpoints_unrebucketable_state(op):
                diags.append(Diagnostic(
                    "WF605",
                    f"operator '{op.name}' ({type(op).__name__}) "
                    f"changes parallelism "
                    f"{w.get('parallelism')} → {op.parallelism} but "
                    "checkpoints state with no re-bucketing rule",
                    node=op.name,
                    hint="restore on the checkpointed shard shape, or "
                         "use the built-in keyed operators"))
    if manifest.get("mesh") is not None:
        rescaled = True
        diags.append(Diagnostic(
            "WF605",
            f"the checkpoint was written on a mesh "
            f"{manifest.get('mesh')} and this graph runs on one device; "
            "mesh rescale-on-restore is not ported (ROADMAP A10)",
            hint="restore on the checkpointed mesh shape"))
    return diags, rescaled
