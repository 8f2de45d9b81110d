"""Preflight graph checker (the port of ``windflow_tpu/analysis/
preflight.py``): abstract evaluation of a whole PipeGraph before any
device work.

WindFlow rejects an illegal composition at C++ compile time; a Python
graph has no compiler seam, so a map whose field comes back the wrong
shape used to fail mid-run, after staging and perhaps inside a CUDA
graph capture, and only the first fault showed.  :func:`check_graph`
walks the composed, unstarted graph and reports **every** violation it
can prove, in the JAX package's pass order:

* structure (WF301-WF304), window specs (WF201-WF204), merged batch
  capacities (WF403), key-compaction advice (WF404, WF405), watermark
  modes across merges (WF501-WF503), durability (WF601, WF603);
* the user functions of the device operators, evaluated on fake tensors
  (:func:`_eval`, the port's ``jax.eval_shape``): dtype and shape drift
  in a chain, a non-boolean predicate, combiner contract drift, a
  non-integer key extractor (WF101-WF106);
* the named downgrades of the wire (WF606), the kernels (WF607) and the
  megastep (WF608), read off the same functions the runtime consults;
* wfverify (``analysis/tracecheck.py``), folded in as the WF8xx/WF61x
  codes, a failure of the verifier itself as WF800.

On a mesh (``Config.mesh``) the mesh pass checks that staging
capacities divide over the mesh's positions (WF401) and key spaces over
its key axis (WF402), and the durability pass flags keyed state with no
re-bucketing rule (WF604).  ``PASSES`` lists what runs.  The restore half
(:func:`manifest_conflicts`, :func:`manifest_rescale_plan`) is the gate
``PipeGraph.restore()`` runs before it touches any state.  The graph
walk helpers (:func:`_upstream_map`, :func:`_effective_caps`,
:func:`capacity_conflicts`, :func:`propagate_specs`,
:func:`record_nbytes`) are shared with the build, the wire plane, the
sweep and shard ledgers and the fusion advisor.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from windflow_tpu_torch.analysis.diagnostics import Diagnostic
from windflow_tpu_torch.basic import (RoutingMode, TimePolicy, WindFlowError,
                                      WinType)
from windflow_tpu_torch.utils.tree import tree_flatten, tree_map

#: sentinel for "record structure unknown at this point of the chain"
_UNKNOWN = None

#: the passes :func:`check_graph` runs, in order (``stats()["Preflight"]``)
PASSES = ("structural", "window_spec", "capacity", "mesh", "compaction",
          "watermark", "durability", "kernel", "wire", "kernel_downgrade",
          "megastep", "tracecheck", "ir_audit")


# ---------------------------------------------------------------------------
# record specs
# ---------------------------------------------------------------------------

class Spec:
    """Shape and dtype of one record leaf (the port's
    ``jax.ShapeDtypeStruct``).  ``lane`` is False for a combiner output
    that came back without the batch dimension (a batch-wide value where
    a lane was due)."""

    __slots__ = ("shape", "dtype", "lane")

    def __init__(self, shape, dtype, lane: bool = True) -> None:
        self.shape = tuple(int(d) for d in shape)
        self.dtype = dtype
        self.lane = lane

    def __eq__(self, other) -> bool:
        return isinstance(other, Spec) and self.shape == other.shape \
            and self.dtype == other.dtype and self.lane == other.lane

    def __repr__(self) -> str:
        s = f"{self.shape}/{self.dtype}"
        return s if self.lane else s + " (batch-wide, not a lane)"


def _torch_dtype(dt):
    """numpy dtype -> torch dtype (raises on dtypes torch has not)."""
    import torch
    return torch.from_numpy(np.zeros(0, np.dtype(dt))).dtype


def _as_struct(example):
    """An example record (a pytree of scalars, arrays or tensors, or of
    :class:`Spec`) -> its per-record spec.  Host metadata only."""
    import torch

    def leaf(x):
        if isinstance(x, Spec):
            return x
        if isinstance(x, torch.Tensor):
            return Spec(tuple(x.shape), x.dtype)
        a = np.asarray(x)
        return Spec(a.shape, _torch_dtype(a.dtype))

    return tree_map(leaf, example)


def _leaf_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in canonical leaf order, paths rendered as the
    JAX package's ``keystr`` (``['k']``, ``[0]``)."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, c in enumerate(node):
                walk(c, f"{path}[{i}]")
        else:
            out.append((path, node))

    walk(tree, "")
    return out


def _structure(tree):
    return tree_flatten(tree)[1]


def _same_struct(a, b) -> bool:
    return _structure(a) == _structure(b)


def _struct_str(tree) -> str:
    """A readable structure: the field paths."""
    return "{" + ", ".join(p or "." for p, _ in _leaf_paths(tree)) + "}"


def _leaf_mismatch(want, got) -> Optional[str]:
    """First leaf whose shape/dtype drifts between two same-structure
    specs, rendered for the message; None when they agree."""
    for (path, a), (_, b) in zip(_leaf_paths(want), _leaf_paths(got)):
        if a != b:
            return (f"field {path or '.'} is {a!r} in the records but came "
                    f"back {b!r}")
    return None


def record_nbytes(spec) -> Optional[int]:
    """Payload bytes of ONE record under a spec (summed leaf ``shape x
    itemsize``): the record byte model the sweep ledger splits measured
    bytes against.  ``None`` when the spec is unknown."""
    if spec is _UNKNOWN:
        return None
    total = 0
    for _, leaf in _leaf_paths(spec):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        total += n * leaf.dtype.itemsize
    return total


# ---------------------------------------------------------------------------
# the abstract evaluator
# ---------------------------------------------------------------------------

#: lanes of the fake batches a per-record function is evaluated on
EVAL_LANES = 8


def _eval(fn, *specs, n: int = EVAL_LANES, device="cpu", call="record"):
    """The port's ``jax.eval_shape``: ``fn`` run on fake tensors, with
    the exception surfaced as a string (the diagnostic payload).

    Each spec becomes a fake ``[n]``-lane batch on ``device`` (a
    ``FakeTensorMode`` tensor: shape, dtype and device, no storage, no
    kernel, no copy), and ``fn`` runs as the runtime runs it:
    ``call="record"`` through ``utils.tree.per_record`` (map, filter and
    key functions, a window's lift), ``"record2"`` through
    ``per_record2`` (stateful functions), ``"batch"`` directly on the
    batches (combiners, batch maps), ``"index"`` on the batch index
    (a DeviceSource's ``batch_fn``).  A closed-over real tensor is taken
    as a constant, as ``jax.eval_shape`` takes a closed-over array; a
    host read (``.item()``, ``if`` on a tensor) raises, the WF101 that
    JAX's concretization error gives.  Returns ``(out, None)`` with the
    output as a tree of :class:`Spec` (the lane dimension stripped), or
    ``(None, error)``.

    ``FakeTensorMode`` is a private torch API: this is its one use."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from windflow_tpu_torch.utils.tree import per_record, per_record2
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = [_fake_batch(s, n, device) for s in specs]
            if call == "record":
                out = per_record(fn, args[0], n)
            elif call == "record2":
                out = per_record2(fn, args[0], args[1], n)
            elif call == "index":
                out = fn(0)
            else:
                out = fn(*args)
            return _lane_specs(out, n), None
    except Exception as e:  # noqa: BLE001 - lint: broad-except-ok (user
        # functions raise arbitrary exception types under abstract eval;
        # the point of the pass is to turn ANY of them into a finding)
        return None, f"{type(e).__name__}: {e}"


def _fake_batch(spec, n: int, device):
    """A spec tree as fake ``[n]``-lane tensors (inside the fake mode);
    a bare torch dtype is a ``[n]`` lane of it (a validity mask)."""
    import torch
    if isinstance(spec, torch.dtype):
        return torch.empty((n,), dtype=spec, device=device)
    return tree_map(lambda s: torch.empty((n,) + s.shape, dtype=s.dtype,
                                          device=device), spec)


def _lane_specs(out, n: int):
    """Output tree -> per-record specs: a ``[n, ...]`` tensor is a lane;
    anything else is batch-wide (``lane=False``)."""
    import torch

    def leaf(x):
        if isinstance(x, torch.Tensor):
            if x.ndim >= 1 and x.shape[0] == n:
                return Spec(tuple(x.shape[1:]), x.dtype)
            return Spec(tuple(x.shape), x.dtype, lane=False)
        a = np.asarray(x)
        return Spec(a.shape, _torch_dtype(a.dtype), lane=False)

    return tree_map(leaf, out)


def _eval_records(fn, *specs, n: int, device, call="record"):
    """:func:`_eval` of a per-record function, plus the per-record
    contract: ``per_record`` broadcasts a leaf that comes back without
    the batch dimension (a constant), so a field whose shape follows the
    batch size (``torch.cat([t["v"], t["v"]])``: ``[2n]``) would run as
    a garbage broadcast.  A second evaluation at ``n + 1`` lanes tells
    the two apart."""
    out, err = _eval(fn, *specs, n=n, device=device, call=call)
    if err is not None or not any(s.shape for _, s in _leaf_paths(out)):
        return out, err
    out2, err2 = _eval(fn, *specs, n=n + 1, device=device, call=call)
    if err2 is not None:
        return None, err2
    for (path, a), (_, b) in zip(_leaf_paths(out), _leaf_paths(out2)):
        if a.shape != b.shape:
            return None, (
                f"field {path or '.'} comes back {a.shape} for {n} "
                f"records and {b.shape} for {n + 1}: a per-record "
                "function must stay elementwise over the lanes")
    return out, None


# ---------------------------------------------------------------------------
# graph structure helpers (shared with PipeGraph._build)
# ---------------------------------------------------------------------------

def _upstream_map(edges) -> Dict[int, Tuple[Any, list]]:
    """``id(op) -> (op, [upstream ops])`` over every graph edge, split
    fan-outs included."""
    ups: Dict[int, Tuple[Any, list]] = {}
    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            ups.setdefault(id(b), (b, []))[1].append(a)
        else:   # split: each child's head is fed by the split source
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                if child.operators:
                    head = child.operators[0]
                    ups.setdefault(id(head), (head, []))[1].append(src)
    return ups


def _effective_caps(op, ups, seen=None) -> set:
    """Batch capacities a device batch can arrive with at ``op``: a host
    operator (or a device source) stamps its ``output_batch_size``;
    device operators pass their input capacity through."""
    from windflow_tpu_torch.ops.source import Source
    seen = seen if seen is not None else set()
    if id(op) in seen:
        return set()
    seen.add(id(op))
    if not op.is_gpu or isinstance(op, Source):
        return {op.output_batch_size}
    caps = set()
    for up in ups.get(id(op), (None, []))[1]:
        caps |= _effective_caps(up, ups, seen)
    return caps


def capacity_conflicts(graph, upstreams=None) -> List[Tuple[Any, str, set]]:
    """``[(op, label, caps)]``: fixed-capacity device operators whose
    upstream paths deliver unequal batch capacities.  Shared by the
    preflight pass (WF403) and ``PipeGraph._build``'s backstop for
    ``Config.preflight="off"``."""
    if upstreams is None:
        upstreams = _upstream_map(graph._edges())
    out = []
    for op, preds in upstreams.values():
        label = op.fixed_capacity_label
        if label is None:
            continue
        caps = set()
        for up in preds:
            caps |= _effective_caps(up, upstreams)
        if len(caps) > 1:
            out.append((op, label, caps))
    return out


def _downstream_map(edges) -> Dict[int, list]:
    """``id(op) -> [downstream ops]``, split fan-outs included."""
    down: Dict[int, list] = {}
    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            down.setdefault(id(a), []).append(b)
        else:
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                if child.operators:
                    down.setdefault(id(src), []).append(child.operators[0])
    return down


# ---------------------------------------------------------------------------
# the passes
# ---------------------------------------------------------------------------

def check_graph(graph) -> List[Diagnostic]:
    """Run every preflight pass over a composed PipeGraph and return the
    full list of diagnostics (errors AND warnings, never just the
    first).  No device work: the kernel pass runs on fake tensors."""
    diags: List[Diagnostic] = []
    try:
        edges = graph._edges()
    except WindFlowError as e:
        diags.append(Diagnostic("WF304", str(e)))
        return diags
    ops = graph._topo_operators()
    upstreams = _upstream_map(edges)

    _structural_pass(graph, ops, edges, diags)
    _window_spec_pass(ops, diags)
    _capacity_pass(graph, upstreams, diags)
    _mesh_pass(graph, ops, edges, diags)
    _compaction_pass(graph, ops, diags)
    _watermark_pass(graph, ops, upstreams, diags)
    _durability_pass(graph, ops, diags)
    _kernel_pass(graph, ops, edges, upstreams, diags)
    _wire_pass(graph, edges, diags)
    _kernel_downgrade_pass(graph, ops, diags)
    _megastep_pass(graph, ops, edges, upstreams, diags)
    _tracecheck_pass(graph, diags)
    _ir_audit_pass(graph, diags)
    return diags


def _ir_audit_pass(graph, diags) -> None:
    """The capture audit (``analysis/ir_audit.py``): WF9xx over the
    recorded step bodies and captures, plus a dry run of the user
    functions over the record specs when the graph has recorded nothing
    yet.  Guarded like wfverify: an auditor fault degrades to WF900,
    never blocks a run."""
    try:
        from windflow_tpu_torch.analysis import ir_audit
        if not ir_audit.enabled(getattr(graph, "config", None)):
            return
        report = ir_audit.audit_graph(graph)
        graph._ir_audit_report = report
        diags.extend(report.diagnostics)
    except Exception as e:  # noqa: BLE001 - lint: broad-except-ok (an
        # auditor fault degrades to a note instead of masking the
        # preflight result)
        diags.append(Diagnostic(
            "WF900", f"ir-audit pass failed internally and was skipped "
                     f"— {type(e).__name__}: {e}"[:300]))


def _structural_pass(graph, ops, edges, diags) -> None:
    has_downstream = set()
    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            has_downstream.add(id(a))
            if a.is_terminal:
                diags.append(Diagnostic(
                    "WF301",
                    f"operator '{b.name}' is composed downstream of sink "
                    f"'{a.name}' — a sink terminates its pipeline and "
                    "forwards nothing",
                    node=b.name,
                    hint="route the data before the sink (split the pipe) "
                         "or drop the trailing operators"))
        else:
            _, mp = edge
            has_downstream.add(id(mp.operators[-1]))
    for op in ops:
        if not op.is_terminal and id(op) not in has_downstream:
            diags.append(Diagnostic(
                "WF302",
                f"operator '{op.name}' has no downstream consumer — "
                "every MultiPipe must end in a Sink",
                node=op.name, hint="append add_sink(...) to the pipeline"))
        if op.routing == RoutingMode.KEYBY and op.key_extractor is None:
            diags.append(Diagnostic(
                "WF303",
                f"operator '{op.name}' uses KEYBY routing but declares no "
                "key extractor",
                node=op.name, hint="pass withKeyBy(fn) on the builder"))


def _window_spec_pass(ops, diags) -> None:
    from windflow_tpu_torch.windows.engine import WindowSpec
    for op in ops:
        spec = getattr(op, "spec", None)
        if not isinstance(spec, WindowSpec):
            continue
        if spec.win_len <= 0 or spec.slide <= 0:
            diags.append(Diagnostic(
                "WF201",
                f"operator '{op.name}': window length {spec.win_len} / "
                f"slide {spec.slide} must both be positive",
                node=op.name))
            continue   # the remaining spec arithmetic assumes positives
        if spec.slide > spec.win_len:
            diags.append(Diagnostic(
                "WF202",
                f"operator '{op.name}': slide {spec.slide} exceeds window "
                f"length {spec.win_len} — tuples landing in the "
                f"{spec.slide - spec.win_len}-wide gaps belong to no "
                "window (hopping-with-gaps is supported, but a swapped "
                "(length, slide) pair silently drops data)",
                node=op.name,
                hint="use slide <= length unless the gaps are intended"))
        if spec.lateness < 0:
            diags.append(Diagnostic(
                "WF204",
                f"operator '{op.name}': lateness {spec.lateness} is "
                "negative", node=op.name))
        elif spec.lateness > 0 and spec.win_type == WinType.CB:
            diags.append(Diagnostic(
                "WF203",
                f"operator '{op.name}': lateness "
                f"{spec.lateness} declared on a count-based window — "
                "lateness gates time-based windows only and is ignored "
                "here", node=op.name,
                hint="drop withLateness or switch to withTBWindows"))


def _capacity_pass(graph, upstreams, diags) -> None:
    for op, label, caps in capacity_conflicts(graph, upstreams):
        diags.append(Diagnostic(
            "WF403",
            f"'{op.name}' ({label}) compiles for one fixed batch capacity "
            f"but its upstream paths deliver {sorted(caps)}; give the "
            "merged branches equal withOutputBatchSize",
            node=op.name))


_MONOID_OPS = {"add": "sum", "maximum": "max", "minimum": "min"}


def _monoid_comb_mismatches(comb, key_fn, monoid, spec, device) -> list:
    """Leaves where the user combiner PROVABLY diverges from the declared
    monoid (WF405), read off the combiner's aten graph
    (``make_fx(tracing_mode="fake")``, no device work).  Two classes,
    both free of false positives: an output leaf passed through from ONE
    input unchanged (legal only for the key leaf itself under an
    idempotent max/min — the ``{"key": a["key"], ...}`` idiom; under
    "sum" the dense scatter ADDS equal keys), and a leaf combined by a
    recognized monoid op of the WRONG kind.  Anything else is
    inconclusive and stays silent."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx
    from windflow_tpu_torch.utils.tree import tree_unflatten
    paths = _leaf_paths(spec)
    treedef = _structure(spec)
    n = len(paths)

    def flat_comb(*leaves):
        out = comb(tree_unflatten(treedef, list(leaves[:n])),
                   tree_unflatten(treedef, list(leaves[n:])))
        out_leaves, out_def = tree_flatten(out)
        if out_def != treedef:
            raise ValueError("combiner structure drift (WF103's finding)")
        return tuple(out_leaves)

    def flat_key(*leaves):
        return key_fn(tree_unflatten(treedef, list(leaves)))

    with FakeTensorMode(allow_non_fake_inputs=True):
        # distinct tensors per input: make_fx aliases repeated objects
        ins = [_fake_batch(s, EVAL_LANES, device)
               for _ in range(2) for _, s in paths]
        gm = make_fx(flat_comb, tracing_mode="fake")(*ins)
        key_leaf = None
        if key_fn is not None:
            kg = make_fx(flat_key, tracing_mode="fake")(*ins[:n])
            kph = [nd for nd in kg.graph.nodes if nd.op == "placeholder"]
            kout = [nd for nd in kg.graph.nodes if nd.op == "output"][0]
            karg = kout.args[0]
            if isinstance(karg, (list, tuple)) and len(karg) == 1:
                karg = karg[0]
            if karg in kph:
                key_leaf = kph.index(karg)
    ph = [nd for nd in gm.graph.nodes if nd.op == "placeholder"]
    pos = {nd: i for i, nd in enumerate(ph)}
    outs = [nd for nd in gm.graph.nodes if nd.op == "output"][0].args[0]
    if len(ph) != 2 * n or len(outs) != n:
        return []
    found = []
    for i, (path, _) in enumerate(paths):
        name = path or "."
        node = outs[i]
        j = pos.get(node)
        if j is not None:
            if monoid == "sum" or key_leaf is None \
                    or i != key_leaf or j % n != i:
                found.append((name, f"returns input {'ab'[j // n]}'s leaf "
                                    "unchanged"))
            continue
        if getattr(node, "op", None) != "call_function":
            continue
        op_name = getattr(getattr(node.target, "overloadpacket", None),
                          "__name__", "")
        kind = _MONOID_OPS.get(op_name)
        if kind is None or kind == monoid:
            continue
        operands = {pos.get(a) for a in node.args[:2]}
        if operands == {i, n + i}:
            found.append((name, f"computes leafwise '{kind}'"))
    return found


def _compaction_pass(graph, ops, diags) -> None:
    """WF404: a keyed reduce declaring a bounded key space
    (``withMaxKeys``) without a monoid runs the sorted route; WF405: a
    declared monoid REPLACES the combiner on the dense and compacted
    routes, so a combiner that provably diverges from it leafwise
    changes results exactly where the declaration applies."""
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    in_specs = None
    device = graph.config.device
    for op in ops:
        if isinstance(op, ReduceGPU) \
                and op.monoid in _MONOID_OPS.values():
            if in_specs is None:
                in_specs = propagate_specs(graph, ops=ops)[0]
            spec = in_specs.get(id(op))
            if spec is None:
                continue
            try:
                bad = _monoid_comb_mismatches(
                    op.comb, op.key_extractor, op.monoid, spec, device)
            except Exception:  # noqa: BLE001 - lint: broad-except-ok (the
                # probe must never block a run the runtime would accept;
                # exotic-but-correct combiners simply go unchecked)
                bad = []
            for leaf, why in bad:
                diags.append(Diagnostic(
                    "WF405",
                    f"operator '{op.name}': declared "
                    f"withMonoidCombiner(\"{op.monoid}\") but the "
                    f"combiner {why} at record leaf {leaf} — the dense/"
                    "compacted routes compute the DECLARED "
                    f"'{op.monoid}' there instead, silently diverging "
                    "from the sorted route",
                    node=op.name,
                    hint="make the combiner leafwise "
                         f"'{op.monoid}' on every field (a key leaf may "
                         "pass through under idempotent max/min), or "
                         "drop the declaration to keep the sorted "
                         "route's semantics"))
    for op in ops:
        if isinstance(op, ReduceGPU) and op.key_extractor is not None \
                and op.max_keys is not None and op.monoid is None:
            diags.append(Diagnostic(
                "WF404",
                f"operator '{op.name}': withMaxKeys({op.max_keys}) "
                "declares a bounded key space but no monoid combiner — "
                "the reduce takes the sorted arbitrary-key route (a "
                "sort and a segmented scan a batch, against one table "
                "pass)",
                node=op.name,
                hint="declare withMonoidCombiner/withSumCombiner for "
                     "the dense route; an undeclared key space "
                     "with a monoid still compacts (Config."
                     "key_compaction)"))


def _source_wm_mode(op, time_policy, diags) -> str:
    """How a source advances watermarks: "ingress" (wall clock), "event"
    (data timestamps) or "none" (cannot advance).  Other Source
    subclasses (frames, Kafka) manage time themselves."""
    from windflow_tpu_torch.io.device_source import DeviceSource
    from windflow_tpu_torch.ops.source import Source, SourceReplica
    if isinstance(op, DeviceSource):
        if time_policy == TimePolicy.EVENT:
            if op.ts_fn is None or op.wm_fn is None:
                diags.append(Diagnostic(
                    "WF501",
                    f"device source '{op.name}': EVENT time policy needs "
                    "both ts_fn (device lane) and wm_fn (host frontier)",
                    node=op.name, hint="use withTimestampFn(ts_fn, wm_fn)"))
                return "none"
            return "event"
        if op.ts_fn is not None:
            diags.append(Diagnostic(
                "WF501",
                f"device source '{op.name}': withTimestampFn requires the "
                "EVENT time policy (INGRESS stamps arrival time itself)",
                node=op.name))
        return "ingress"
    if type(op) is Source or op.replica_class is SourceReplica:
        if time_policy == TimePolicy.EVENT:
            if op.ts_extractor is None:
                diags.append(Diagnostic(
                    "WF501",
                    f"source '{op.name}': EVENT time policy requires a "
                    "timestamp extractor",
                    node=op.name,
                    hint="use withTimestampExtractor(fn) on the builder"))
                return "none"
            return "event"
        return "ingress"
    return "event" if time_policy == TimePolicy.EVENT else "ingress"


def _watermark_pass(graph, ops, upstreams, diags) -> None:
    from windflow_tpu_torch.ops.source import Source
    from windflow_tpu_torch.windows.engine import WindowSpec
    # demand-driven fold over the upstream map (merge-connection edges
    # sort last in _edges())
    memo: Dict[int, set] = {}

    def modes_of(op, stack=frozenset()):
        if id(op) in memo:
            return memo[id(op)]
        if id(op) in stack:         # defensive: compositions cannot cycle
            return set()
        if isinstance(op, Source):
            m = {_source_wm_mode(op, graph.time_policy, diags)}
        else:
            m = set()
            for up in upstreams.get(id(op), (None, []))[1]:
                m |= modes_of(up, stack | {id(op)})
        memo[id(op)] = m
        return m

    for op in ops:
        modes_of(op)    # classifies every source (WF501) exactly once
    # the watermark collector min-folds channel watermarks, so one
    # watermark-less parent pins the merged frontier forever
    for merged in graph._merges:
        if not merged.operators:
            continue
        head = merged.operators[0]
        got = memo.get(id(head), set())
        if len(got) > 1:
            diags.append(Diagnostic(
                "WF502",
                f"merge into '{head.name}' joins branches with mixed "
                f"watermark modes {sorted(got)} — the merged watermark "
                "min-folds over channels, so the least-advancing branch "
                "gates every time window downstream",
                node=head.name,
                hint="give every merged branch the same timestamping "
                     "(all event-timestamped, or all ingress)"))
    for op in ops:
        got = memo.get(id(op), set())
        if "none" not in got:
            continue
        spec = getattr(op, "spec", None)
        if isinstance(spec, WindowSpec) and spec.win_type == WinType.TB:
            diags.append(Diagnostic(
                "WF503",
                f"time-based window operator '{op.name}' is fed by a "
                "branch that never advances watermarks — its windows "
                "fire only at end-of-stream",
                node=op.name))


def _mesh_pass(graph, ops, edges, diags) -> None:
    """WF401: a host→device staging edge whose batch size does not
    divide over the mesh's positions; WF402: a key-sharded state space
    the key axis does not divide (or a compacted window key space, which
    is single-device).  The sharded steps raise the same at their
    build; reported here for the whole graph at once."""
    mesh = graph.config.mesh
    if mesh is None:
        return
    total = mesh.size
    key_extent = mesh.shape["key"]
    for edge in edges:
        if edge[0] != "op":
            continue
        _, a, b = edge
        if b.is_gpu and not a.is_gpu and a.output_batch_size > 0 \
                and a.output_batch_size % total:
            diags.append(Diagnostic(
                "WF401",
                f"staging edge '{a.name}' -> '{b.name}': output batch "
                f"size {a.output_batch_size} not divisible by the mesh's "
                f"{total} devices",
                node=b.name,
                hint=f"pick a withOutputBatchSize that is a multiple of "
                     f"{total}"))
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    for op in ops:
        if isinstance(op, FfatWindowsGPU) and op.max_keys is None:
            diags.append(Diagnostic(
                "WF402",
                f"operator '{op.name}': compacted key space "
                "(withCompactedKeys) is single-device; mesh execution "
                "needs a declared dense key space",
                node=op.name,
                hint=f"declare withMaxKeys (a multiple of the key axis "
                     f"{key_extent})"))
        elif isinstance(op, FfatWindowsGPU) and op.max_keys % key_extent:
            diags.append(Diagnostic(
                "WF402",
                f"operator '{op.name}': max_keys {op.max_keys} not "
                f"divisible by key axis {key_extent}",
                node=op.name))
        elif isinstance(op, _StatefulGPUBase) \
                and op.num_key_slots % key_extent:
            diags.append(Diagnostic(
                "WF402",
                f"operator '{op.name}': num_key_slots {op.num_key_slots} "
                f"not divisible by key axis {key_extent}",
                node=op.name))


def _durability_pass(graph, ops, diags) -> None:
    """With ``Config.durability`` set: sources whose replay is not
    deterministic (WF601), operators whose cross-batch state the
    checkpoint cannot capture (WF603), and on a mesh keyed operators
    whose checkpointed state has no re-bucketing rule (WF604)."""
    if not getattr(graph.config, "durability", ""):
        return
    on_mesh = graph.config.mesh is not None
    # on a mesh the same gaps also block rescale-on-restore
    mesh_tail = (" — on a mesh this also makes the operator "
                 "rescale-incompatible (restore on N±1 shards replays "
                 "through the checkpoint)") if on_mesh else ""
    from windflow_tpu_torch.io.device_source import DeviceSource
    from windflow_tpu_torch.kafka.kafka_source import KafkaSource
    from windflow_tpu_torch.ops.source import Source
    for op in ops:
        if isinstance(op, Source):
            if isinstance(op, KafkaSource):
                continue    # offset-addressed: the replayable case
            if isinstance(op, DeviceSource) and op.ts_fn is not None:
                continue    # EVENT-time device source: a pure function of
                #             the batch index, replays bit for bit
            diags.append(Diagnostic(
                "WF601",
                f"source '{op.name}' cannot replay deterministically "
                "after a restore (no offsets to seek, "
                "wall-clock/ingress timestamps re-stamp on replay) — "
                "restored runs will diverge from the checkpointed "
                "stream position" + mesh_tail,
                node=op.name,
                hint="feed checkpointed graphs from a Kafka source or "
                     "an EVENT-time DeviceSource (withTimestampFn / "
                     "withTimestampBounds)"))
        elif op.checkpoint_opaque:
            diags.append(Diagnostic(
                "WF603",
                f"operator '{op.name}' ({type(op).__name__}) holds "
                "cross-batch state the checkpoint cannot capture — a "
                "restore silently resets it" + mesh_tail,
                node=op.name,
                hint="use the device window/stateful operators "
                     "(FfatWindowsGPU, StatefulMapGPU, Reduce) for "
                     "checkpointed graphs"))
        elif on_mesh and op.key_extractor is not None \
                and _checkpoints_unrebucketable_state(op):
            diags.append(Diagnostic(
                "WF604",
                f"keyed operator '{op.name}' ({type(op).__name__}) on "
                "a mesh checkpoints state with no re-bucketing rule "
                "(no declared key space or compaction remap) — a "
                "restore onto a different mesh shape will refuse with "
                "WF605",
                node=op.name,
                hint="use the built-in keyed operators (FfatWindowsGPU, "
                     "StatefulMapGPU, ReduceGPU, Reduce) for rescalable "
                     "checkpoints, or keep the mesh shape fixed"))


def _wire_pass(graph, edges, diags) -> None:
    """WF606: with ``Config.wire_compression`` on, a host→device staging
    edge whose records have no declared or inferred spec ships raw.  The
    verdict is :func:`wire.known_input_specs`, the walk
    ``wire.attach_wire`` decides by, so preflight and the runtime never
    disagree on an edge."""
    from windflow_tpu_torch.wire import known_input_specs, wire_enabled
    if not wire_enabled(graph.config):
        return
    known = known_input_specs(graph)
    seen = set()

    def note(a, b) -> None:
        if known.get(id(b), False) or (id(a), id(b)) in seen:
            return
        seen.add((id(a), id(b)))
        diags.append(Diagnostic(
            "WF606",
            f"staging edge '{a.name}' → '{b.name}' has no "
            "declared/inferred record spec: wire compression "
            "(Config.wire_compression) downgrades to raw passthrough "
            "on this edge",
            node=b.name,
            hint="declare the stream's record shape with "
                 "Source_Builder.withRecordSpec(example); DeviceSource "
                 "infers its spec from batch_fn"))

    for edge in edges:
        if edge[0] == "op":
            _, a, b = edge
            if b.is_gpu and not a.is_gpu:
                note(a, b)
        else:
            _, mp = edge
            src = mp.operators[-1]
            for child in mp.split_children:
                if child.operators and child.operators[0].is_gpu \
                        and not src.is_gpu:
                    note(src, child.operators[0])


def _kernel_downgrade_pass(graph, ops, diags) -> None:
    """WF607: CUDA kernels forced on (``Config.cuda_kernels="1"``) name
    their downgrades instead of taking them silently — the WF606
    contract applied to the kernel plane:

    * a graph on the CPU: every wrapper takes its plain torch version
      (the wrappers route by the tensor's device) and no kernel builds;
    * an FFAT window with a GENERIC combiner (no declared sum/max/min
      monoid): the sliding-fold kernel only exists for declared
      monoids, so the fold keeps the plain body (the grouping kernel
      still applies).

    ``auto`` picks silently and never warns."""
    import torch
    from windflow_tpu_torch.kernels.ffat_cuda import kernels_forced
    if not kernels_forced(graph.config):
        return
    if torch.device(getattr(graph.config, "device", "cuda")).type != "cuda":
        diags.append(Diagnostic(
            "WF607",
            "Config.cuda_kernels='1' forced but the graph runs on the CPU "
            "(Config.device): every kernel wrapper takes its plain torch "
            "version and no kernel builds",
            hint="run on the card (Config.device='cuda'), or leave "
                 "cuda_kernels at 'auto'"))
        return
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    for op in ops:
        if isinstance(op, FfatWindowsGPU) and op.monoid is None:
            diags.append(Diagnostic(
                "WF607",
                f"window '{op.name}' has a generic combiner: the "
                "sliding-fold kernel only exists for declared "
                "sum/max/min monoids, so its fold keeps the plain torch "
                "body (the grouping kernel still applies)",
                node=op.name,
                hint="declare the combiner with withMonoidCombiner/"
                     "withSumCombiner if it is a leafwise monoid"))


def _megastep_pass(graph, ops, edges, upstreams, diags) -> None:
    """WF608: a FORCED megastep width (``Config.megastep_sweeps`` an
    integer > 1) names its downgrades instead of taking them silently.
    The group exists only for a single-destination host→device staging
    edge whose post-fusion tail steps entirely on the card
    (``megastep.tail_kind``, the classifier ``attach_plane`` consults at
    build, so preflight and the runtime never disagree on a reason):

    * a multi-destination staging edge (a split, or a keyed fan-out);
    * a parallel tail, a compacted key space (host admission runs per
      batch), or ``tail_kind``'s reason verbatim (a host operator, a
      host-interning stateful tail, a wavefront one with the CUDA
      kernels off, parallel window state);
    * a spec-less source: packed signatures drift batch to batch, so a
      K-group never assembles.

    ``auto`` picks silently and never warns; every case runs correctly
    at the per-batch cadence."""
    from windflow_tpu_torch.fusion.executor import _is_stateless
    from windflow_tpu_torch.io.device_source import DeviceSource
    from windflow_tpu_torch.megastep import megastep_forced, tail_kind
    from windflow_tpu_torch.ops.sink import Sink
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU

    k = megastep_forced(graph.config)
    if not k:
        return
    down = _downstream_map(edges)
    roots = [op for op in ops
             if not (upstreams.get(id(op)) or (None, []))[1]
             and down.get(id(op))]

    def warn(src, reason: str, node=None) -> None:
        diags.append(Diagnostic(
            "WF608",
            f"Config.megastep_sweeps={k} forced but the staging edge from "
            f"'{src.name}' keeps per-batch dispatch: {reason}",
            node=node,
            hint="the downgrade is correctness-neutral (the per-batch "
                 "path is the reference semantics); leave "
                 "megastep_sweeps at 'auto' or restructure the edge to a "
                 "single-destination device tail"))

    for src in roots:
        if getattr(src, "record_spec", None) is None and not (
                isinstance(src, DeviceSource) and src.batch_fn is not None):
            warn(src, "the source declares/infers no record spec, so "
                      "packed batch signatures can drift and a K-group "
                      "never assembles (declare withRecordSpec)",
                 node=src.name)
            continue
        tail = src
        while True:
            dests = down.get(id(tail), [])
            if len(dests) != 1:
                warn(src, "multi-destination staging edge "
                          "(keyed/round-robin fan-out ships per batch)",
                     node=tail.name)
                tail = None
                break
            tail = dests[0]
            if not (_is_stateless(tail) and tail.is_gpu):
                break
        if tail is None or isinstance(tail, Sink):
            # an all-stateless run ending at the sink has no stateful
            # step to carry: quiet, as in the JAX package
            continue
        if tail.parallelism != 1 and not isinstance(tail, FfatWindowsGPU):
            warn(src, "parallel tail (per-replica state shards the "
                      "group carry)", node=tail.name)
            continue
        if _will_compact(graph.config, tail):
            # the compactor attaches at build (parallel/compaction.
            # attach_compaction), so tail_kind cannot see it on an
            # unstarted graph: predict it from the same criteria
            warn(src, "compacted key space (host admission runs per "
                      "batch; Config.key_compaction=False folds this "
                      "edge)", node=tail.name)
            continue
        kind, reason = tail_kind(tail)
        if kind is None:
            warn(src, reason, node=tail.name)


def _will_compact(config, op) -> bool:
    """Whether ``attach_compaction`` will hang a KeyCompactor on ``op``
    at build: its criteria restated over the unstarted graph."""
    if not getattr(config, "key_compaction", True):
        return False
    from windflow_tpu_torch.ops.gpu_stateful import _StatefulGPUBase
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    if isinstance(op, ReduceGPU):
        return op.key_extractor is not None and op.monoid is not None
    if isinstance(op, FfatWindowsGPU):
        return op.key_extractor is not None and op.max_keys is None
    if isinstance(op, _StatefulGPUBase):
        return not op.dense_keys
    return False


def _tracecheck_pass(graph, diags) -> None:
    """wfverify (``analysis/tracecheck.py``) over the live callables.
    Guarded: a verifier fault degrades to a WF800 note, never blocks a
    run the runtime would accept, and is never swallowed silently."""
    try:
        from windflow_tpu_torch.analysis.tracecheck import verify_graph
        report = verify_graph(graph)
        graph._tracecheck_report = report
        diags.extend(report.diagnostics)
    except Exception as e:  # noqa: BLE001 - lint: broad-except-ok (the
        # verifier inspects arbitrary user sources; a failure of its own
        # becomes the WF800 finding instead of masking the preflight)
        diags.append(Diagnostic(
            "WF800", f"wfverify pass failed internally and was skipped "
                     f"— {type(e).__name__}: {e}"[:300],
            severity="warning"))


# ---------------------------------------------------------------------------
# abstract kernel evaluation
# ---------------------------------------------------------------------------

def _check_key_extractor(op, spec, n, device, diags) -> None:
    if op.key_extractor is None:
        return
    out, err = _eval_records(op.key_extractor, spec, n=n, device=device)
    if err is not None:
        diags.append(Diagnostic(
            "WF104",
            f"operator '{op.name}': key extractor failed abstract "
            f"evaluation over the record spec — {err}",
            node=op.name))
        return
    leaf = out if isinstance(out, Spec) else None
    if leaf is None or leaf.shape != () or not _is_integer(leaf.dtype):
        got = leaf if leaf is not None else _struct_str(out)
        diags.append(Diagnostic(
            "WF104",
            f"operator '{op.name}': key extractor must return an integer "
            f"scalar, got {got!r} — keys index the dense key tables on "
            "the card",
            node=op.name,
            hint="return an int field (cast with .to(torch.int32))"))


def _is_integer(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and str(dtype) != "torch.bool"


def _check_comb(op, one, n, device, code, what, diags) -> bool:
    """The combiner maps (records, records) -> records with structure,
    shapes and dtypes preserved: the contract every fold route (sort and
    scan, dense tables) runs against."""
    out, err = _eval(op.comb, one, one, n=n, device=device, call="batch")
    if err is not None:
        diags.append(Diagnostic(
            code,
            f"operator '{op.name}': {what} combiner failed abstract "
            f"evaluation — {err}", node=op.name))
        return False
    if not _same_struct(one, out):
        diags.append(Diagnostic(
            code,
            f"operator '{op.name}': {what} combiner must return the same "
            f"record structure as its inputs (records have "
            f"{_struct_str(one)}, combiner returned {_struct_str(out)}); "
            "carry every field through the combine", node=op.name))
        return False
    drift = _leaf_mismatch(one, out)
    if drift is not None:
        diags.append(Diagnostic(
            code,
            f"operator '{op.name}': {what} combiner must preserve each "
            f"field's shape and dtype: {drift}", node=op.name))
        return False
    return True


def _check_predicate(op, out, err, diags, what) -> None:
    if err is not None:
        diags.append(Diagnostic(
            "WF101",
            f"operator '{op.name}': {what} failed abstract evaluation — "
            f"{err}", node=op.name))
        return
    import torch
    leaf = out if isinstance(out, Spec) else None
    if leaf is None or leaf.shape != () or leaf.dtype != torch.bool:
        got = leaf if leaf is not None else _struct_str(out)
        diags.append(Diagnostic(
            "WF102",
            f"operator '{op.name}': {what} must return a boolean scalar, "
            f"got {got!r} — the validity-mask intersection needs a bool "
            "lane", node=op.name))


def _kernel_pass(graph, ops, edges, upstreams, diags) -> None:
    """Diagnostic face of :func:`propagate_specs` (the WF1xx codes)."""
    propagate_specs(graph, ops=ops, edges=edges, upstreams=upstreams,
                    diags=diags)


def propagate_specs(graph, ops=None, edges=None, upstreams=None,
                    diags=None) -> Tuple[Dict[int, Any], Dict[int, Any]]:
    """Propagate record specs from the sources through every chain,
    abstractly evaluating each device operator's user functions where a
    spec is known.  Returns ``(in_specs, out_specs)`` keyed by
    ``id(op)``, ``None`` marking "unknown at this point of the chain".

    The one shared graph walk: the kernel pass appends its WF1xx
    diagnostics through ``diags``; the sweep and shard ledgers and the
    fusion advisor take the per-op record specs only."""
    import torch
    if diags is None:
        diags = []
    if edges is None:
        edges = graph._edges()
    if ops is None:
        ops = graph._topo_operators()
    if upstreams is None:
        upstreams = _upstream_map(edges)
    from windflow_tpu_torch.io.device_source import DeviceSource
    from windflow_tpu_torch.ops.chained import ChainedGPU
    from windflow_tpu_torch.ops.filter_op import Filter
    from windflow_tpu_torch.ops.gpu import FilterGPU, MapGPU
    from windflow_tpu_torch.ops.gpu_stateful import (StatefulFilterGPU,
                                                     StatefulMapGPU)
    from windflow_tpu_torch.ops.reduce import ReduceGPU
    from windflow_tpu_torch.ops.source import Source
    from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU
    # the fake tensors take the graph's device (a fake ``cuda`` tensor
    # needs no card)
    device = graph.config.device

    def cap_of(op) -> int:
        caps = sorted(c for c in _effective_caps(op, upstreams) if c)
        return caps[0] if caps else EVAL_LANES

    def source_spec(op):
        if getattr(op, "record_spec", None) is not None:
            try:
                return _as_struct(op.record_spec)
            except Exception as e:  # noqa: BLE001 - lint: broad-except-ok
                # (withRecordSpec takes arbitrary user pytrees; a bad one
                # degrades to "unknown" with its finding)
                diags.append(Diagnostic(
                    "WF101",
                    f"source '{op.name}': withRecordSpec example could "
                    f"not be abstracted — {type(e).__name__}: {e}",
                    node=op.name))
                return _UNKNOWN
        if isinstance(op, DeviceSource) and op.batch_fn is not None:
            out, err = _eval(op.batch_fn, n=op.capacity, device=device,
                             call="index")
            if err is None and out is not None:
                return out      # per-record view of the [capacity] lanes
        return _UNKNOWN

    def map_stage(op, fn, batch_fn, spec, what):
        """One map's output spec (or _UNKNOWN with its WF101)."""
        cap = cap_of(op)
        if batch_fn:
            out, err = _eval(fn, spec, torch.bool, n=max(2, cap),
                             device=device, call="batch")
        else:
            out, err = _eval_records(fn, spec, n=EVAL_LANES, device=device)
        if err is not None:
            diags.append(Diagnostic(
                "WF101",
                f"operator '{op.name}': {what} failed abstract "
                f"evaluation over the incoming record spec — {err}",
                node=op.name,
                hint="the record fields/dtypes reaching this operator "
                     "do not match what the kernel expects"))
            return _UNKNOWN
        return out

    def filter_stage(op, fn, spec, what):
        out, err = _eval_records(fn, spec, n=EVAL_LANES, device=device)
        _check_predicate(op, out, err, diags, what)

    def out_spec(op, spec):
        """Output record spec of ``op`` given its input ``spec`` (which
        may be _UNKNOWN), appending findings for provable violations.
        Device functions MUST evaluate (WF101); host functions are never
        called (their side effects would fire before the stream runs)."""
        if spec is not _UNKNOWN and op.is_keyed:
            # device integer extractors only: the reduce and the windows
            # extract keys inside the step, dense stateful ops index slot
            # tables; interned and host keys may be any hashable
            if isinstance(op, (ReduceGPU, FfatWindowsGPU)) \
                    or (isinstance(op, (StatefulMapGPU, StatefulFilterGPU))
                        and op.dense_keys):
                _check_key_extractor(op, spec, EVAL_LANES, device, diags)
        if isinstance(op, (MapGPU, FilterGPU, ChainedGPU)):
            stages = op.stages if isinstance(op, ChainedGPU) else [op]
            fused = isinstance(op, ChainedGPU)
            cur = spec
            for st in stages:
                if cur is _UNKNOWN:
                    return _UNKNOWN
                if isinstance(st, MapGPU):
                    if fused:
                        what = "fused batch-map stage" if st.batch_fn \
                            else "fused map stage"
                    else:
                        what = "batch kernel" if st.batch_fn else "kernel"
                    cur = map_stage(op, st.fn, st.batch_fn, cur, what)
                else:
                    filter_stage(op, st.fn, cur, "fused predicate"
                                 if fused else "predicate")
            return cur
        if isinstance(op, ReduceGPU):
            if spec is not _UNKNOWN:
                _check_comb(op, spec, EVAL_LANES, device, "WF103",
                            "reduce", diags)
            return spec
        if isinstance(op, FfatWindowsGPU):
            if spec is not _UNKNOWN:
                agg, err = _eval_records(op.lift, spec, n=EVAL_LANES,
                                         device=device)
                if err is not None:
                    diags.append(Diagnostic(
                        "WF101",
                        f"operator '{op.name}': lift failed abstract "
                        f"evaluation over the incoming record spec — "
                        f"{err}", node=op.name))
                else:
                    _check_ffat_comb(op, agg, device, diags)
            return _UNKNOWN   # emits window results, not input records
        if isinstance(op, (StatefulMapGPU, StatefulFilterGPU)):
            if spec is not _UNKNOWN and op.assoc is None:
                state = tree_map(lambda a: Spec(tuple(a.shape[1:]),
                                                a.dtype), op._state)
                out, err = _eval_records(op.fn, spec, state, n=EVAL_LANES,
                                         device=device, call="record2")
                if err is not None:
                    diags.append(Diagnostic(
                        "WF101",
                        f"operator '{op.name}': stateful kernel failed "
                        f"abstract evaluation — {err}", node=op.name))
                    return _UNKNOWN
                if isinstance(op, StatefulMapGPU):
                    try:
                        return out[0]
                    except (TypeError, IndexError, KeyError):
                        return _UNKNOWN
                return spec
            return spec if isinstance(op, StatefulFilterGPU) else _UNKNOWN
        if isinstance(op, Filter):
            # the predicate is not invoked (host functions may have side
            # effects); records pass through unchanged either way
            return spec
        # host Map/FlatMap/Reduce, sinks, unknown types: arbitrary Python
        # the runtime never evaluates ahead of the stream
        return _UNKNOWN

    # demand-driven propagation over the upstream map (merge and split
    # fan-in edges included): order-independent, so a merged pipe's
    # chain sees the specs its parents deliver
    in_spec: Dict[int, Any] = {}
    out_cache: Dict[int, Any] = {}
    visiting: set = set()

    def in_of(op):
        if id(op) in in_spec:
            return in_spec[id(op)]
        spec = _UNKNOWN
        first = True
        for up in upstreams.get(id(op), (None, []))[1]:
            s = out_of(up)
            if first:
                spec, first = s, False
            elif spec is _UNKNOWN or s is _UNKNOWN:
                spec = _UNKNOWN
            else:
                drift = (f"record structures {_struct_str(spec)} "
                         f"vs {_struct_str(s)}"
                         if not _same_struct(spec, s)
                         else _leaf_mismatch(spec, s))
                if drift is not None:
                    diags.append(Diagnostic(
                        "WF106",
                        f"operator '{op.name}': merged branches deliver "
                        f"different records ({drift}) — downstream "
                        "kernels were checked against neither",
                        node=op.name))
                    spec = _UNKNOWN
        in_spec[id(op)] = spec
        return spec

    def out_of(op):
        if id(op) in out_cache:
            return out_cache[id(op)]
        if id(op) in visiting:      # defensive: compositions cannot cycle
            return _UNKNOWN
        visiting.add(id(op))
        if isinstance(op, Source):
            spec = source_spec(op)
        else:
            spec = out_spec(op, in_of(op))
        visiting.discard(id(op))
        out_cache[id(op)] = spec
        return spec

    for op in ops:
        out_of(op)      # every operator's function checks
        in_of(op)       # and every input spec
    return in_spec, out_cache


def _check_ffat_comb(op, agg, device, diags) -> None:
    """The window combiner folds lifted aggregates: (agg, agg) -> agg
    with the lift's structure preserved (WF105)."""
    out, err = _eval(op.comb, agg, agg, n=EVAL_LANES, device=device,
                     call="batch")
    if err is not None:
        diags.append(Diagnostic(
            "WF105",
            f"operator '{op.name}': window combiner failed abstract "
            f"evaluation over the lifted aggregate — {err}",
            node=op.name))
        return
    if not _same_struct(agg, out):
        diags.append(Diagnostic(
            "WF105",
            f"operator '{op.name}': window combiner must return the "
            f"lift's aggregate structure ({_struct_str(agg)}), "
            f"got {_struct_str(out)}", node=op.name))
        return
    drift = _leaf_mismatch(agg, out)
    if drift is not None:
        diags.append(Diagnostic(
            "WF105",
            f"operator '{op.name}': window combiner must preserve the "
            f"aggregate's shapes and dtypes: {drift}", node=op.name))


# ---------------------------------------------------------------------------
# restore-time checks
# ---------------------------------------------------------------------------

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
    written on a mesh shape its state cannot re-bucket onto).
    ``rescaled`` is True when a keyed parallelism
    change (keyed parallelism or mesh shape) is in effect."""
    from windflow_tpu_torch.durability.rebucket import mesh_shape
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
    old_mesh = manifest.get("mesh")
    new_mesh = mesh_shape(graph.config.mesh)
    if old_mesh != new_mesh:
        rescaled = True
        for op in ops:
            if op.key_extractor is not None \
                    and _checkpoints_unrebucketable_state(op):
                diags.append(Diagnostic(
                    "WF605",
                    f"mesh shape changes {old_mesh} → {new_mesh} but "
                    f"keyed operator '{op.name}' "
                    f"({type(op).__name__}) checkpoints state with no "
                    "re-bucketing rule",
                    node=op.name,
                    hint="restore on the checkpointed mesh shape, or "
                         "use the built-in keyed operators"))
    return diags, rescaled
