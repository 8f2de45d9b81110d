"""wfir, the capture audit: what the port actually runs, read as the
WF9xx family (the port of ``windflow_tpu/analysis/ir_audit.py``).

The JAX package parses the lowered StableHLO of each ``wf_jit`` program
into facts.  The port has no StableHLO: its device steps are eager torch
calls, and a megastep edge captures K of them as one CUDA graph.  So the
audit records facts from the ops the port runs.  A recording
``TorchDispatchMode`` rides

* the first step of each device operator replica (the cold path where
  its step registry handle, ``monitoring/jit_registry.StepWatch``, is
  made): ``ops/gpu._GPUReplica`` shadows its step with
  :func:`record_step` once, then drops the shadow;
* each megastep capture (``megastep.MegastepEdge._capture``, inside
  ``kernels.ffat_cuda.CountedGraph.capture``).

It makes no extra step call and no extra capture (the twin of the JAX
package's "zero extra compiles").  Each recorded program gives a fact
record: the aten ops, their output dtypes and devices, the host reads
and syncs with the Python frame that made them, the data-dependent
shapes, the kernel gates that held and the kernel launches made.
:func:`program_findings` reads the facts as

* **WF902** a crossing to host tensors inside a CUDA step body: a
  device-to-host copy, or host compute on CPU tensors of more than one
  element;
* **WF903** f64/c128 values in a step body on the ``cuda`` backend.
  Int64 lanes (the ``ts`` lane, int64 keys and counters) are native on
  Hopper and carried by both packages, so they are not findings; on the
  CPU backend nothing is, as in the JAX package;
* **WF904** data-dependent output shapes: ``aten.nonzero``,
  ``masked_select``, ``unique*``, ``repeat_interleave`` by a tensor, and
  a bool-mask ``index.Tensor`` / ``index_put``;
* **WF906** a host read in the body: ``aten._local_scalar_dense``
  (``.item()``, ``int(t)``, ``bool(t)``), or, on the card, any
  ``cudaStreamSynchronize``-class sync ``torch.cuda``'s sync debug mode
  reports (``.tolist()``, ``.cpu()``, an explicit synchronize): the
  static twin of the card tests' ``set_sync_debug_mode("error")``;
* **WF907** a step recorded on CUDA with the kernels resolved on
  (``kernels.resolve_kernels``) in which a kernel's gate held
  (``grouping_supported`` / ``fold_supported`` / ``table_supported``,
  or a stateful wavefront taking its device loop, ``wavefront_loop``;
  counted per kernel by ``ffat_cuda.gates_open``) while that kernel's
  ``launch_counts()`` entry did not move: its plain version ran on the
  card, whatever the other kernels of the step launched;
* **WF901** a collective that crosses the mesh's key axis with more
  than one element an operand (``parallel/mesh.py`` records each
  collective a recorded step runs: kind, axes, elements), in the step
  of a mesh consumer that key-aligned ingest stamped collective-free,
  or that qualifies for aligned ingest but runs without it.  Scalar
  counters (the drop-count psum) and within-column data-axis gathers
  are not charged (:func:`cross_key_collectives`, the JAX rule).
* **WF905** (a donated operand with no aliased output) is not
  applicable: torch steps donate nothing and carry their state
  functionally (the step returns the new state; under a megastep the
  capture copies it into the static carry), and the sweep ledger's
  donation-miss column that JAX cross-checks is ``None`` in the port.
  No fact is recorded for it.

The host reads the port makes on purpose (ROADMAP "No host reads in the
steps") are exempt by name, in :data:`SANCTIONED_HOST_READS`: a hazard
whose Python stack passes through one of those functions is listed
under ``exempt`` with its reason and is not a finding.

Wired as in the JAX package: ``stats()["IR_audit"]`` and the
postmortem's ``ir_audit.json`` (``tools/wf_doctor.py`` renders it);
``PipeGraph.check()`` folds :func:`audit_graph`, whose dry pass runs
each device operator's user function under ``FakeTensorMode`` over the
preflight record specs (no device work) when the graph has recorded
nothing yet; ``python -m windflow_tpu_torch.analysis.ir`` is the CLI.
The kill switch ``Config.ir_audit`` / ``WF_TPU_IR_AUDIT=0`` leaves one
flag check on the cold first-step path.  A ``# wfverify: ok (reason)``
on (or two lines above) the operator's user function suppresses its
findings, counted in the report, as wfverify counts its own.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import warnings
from typing import Dict, List, Optional

from torch.utils._python_dispatch import TorchDispatchMode

from windflow_tpu_torch.analysis.diagnostics import Diagnostic

#: process-wide kill switch (the first-step hook's one flag check);
#: Config.ir_audit gates each graph on top
ENABLED = os.environ.get("WF_TPU_IR_AUDIT", "1").lower() \
    not in ("0", "", "false", "off")


def enabled(config=None) -> bool:
    """The audit gate: the process switch AND (when a config is given)
    the graph's ``Config.ir_audit``."""
    if not ENABLED:
        return False
    if config is None:
        return True
    return bool(getattr(config, "ir_audit", True))


#: the purposeful host reads of the port's steps (ROADMAP "No host reads
#: in the steps"), by (module under windflow_tpu_torch, function
#: qualname): a host read, sync or crossing whose stack passes through
#: one of these is exempt, with its reason.  None is a branch pick: the
#: JAX package's lax.conds run on the card as conditional nodes
#: (kernels/cond_cuda.py), and their plain routes' reads are findings
SANCTIONED_HOST_READS = {
    ("parallel/compaction.py", "KeyCompactor._miss_candidates"):
        "the compactor's reseed read of its consumers' miss rings",
    ("windows/ffat_gpu.py", "FfatWindowsGPU._size_ring"):
        "the TB ring's first sizing",
    ("windows/ffat_gpu.py", "FfatWindowsGPU._rebase_ring"):
        "the TB ring's rebase before its first firing (growth cadence)",
    ("windows/ffat_gpu.py", "FfatWindowsGPU._tb_counter"):
        "the TB ring's eviction count, read when it grows to its ceiling",
    ("windows/ffat_gpu.py", "_LateRead.__init__"):
        "the 32-step checkpoint's copy, read one checkpoint late",
    ("windows/ffat_gpu.py", "_LateRead.value"):
        "the 32-step checkpoint",
    ("windows/ffat_gpu.py", "FfatWindowsGPU._flush_tb"):
        "the EOS flush",
    ("ops/gpu_stateful.py", "_StatefulGPUBase._read_depth"):
        "the wavefront's depth, read at stats cadence",
    ("ops/gpu_stateful.py", "_StatefulGPUBase._intern_batch"):
        "the interning route's key and mask reads",
    ("utils/tree.py", "host_copy.<locals>.leaf"):
        "the durability checkpoint's host copy",
    ("ops/gpu.py", "wait_for_device"):
        "the flight recorder's sampled device_done wait",
    ("monitoring/shard_ledger.py", "_host_state"):
        "the shard sketches' device state",
    ("monitoring/latency_ledger.py", "_host"):
        "the latency ledger's window-freshness read",
    ("serving/executor.py", "ReshardExecutor._ring_clocks"):
        "the reshard executor's ring-clock compare",
}

#: aten packets whose output shape follows the data
_DYNAMIC_OPS = frozenset({
    "nonzero", "masked_select", "unique_consecutive", "_unique",
    "_unique2", "unique_dim", "unique_dim_consecutive", "argwhere"})
#: aten packets that read a tensor's value on the host
_HOST_READ_OPS = frozenset({"_local_scalar_dense", "item"})
#: factories and lifts: a host tensor made to be copied to the card is
#: not host compute
_HOST_FACTORY_OPS = frozenset({
    "lift_fresh", "lift_fresh_copy", "empty", "empty_strided", "zeros",
    "ones", "full", "arange", "scalar_tensor", "tensor", "_to_copy",
    "copy_", "detach", "alias", "view", "reshape", "_unsafe_view"})
#: 64-bit element types the audit names (WF903)
_WIDE = {"torch.float64": "f64", "torch.complex128": "c128"}
#: the sync debug mode's warning text
_SYNC_TEXT = "synchroniz"

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_THIS = os.path.abspath(__file__)
#: frames of the standard library and of torch are never the site
_SKIP = (os.path.dirname(os.path.abspath(os.__file__)) + os.sep,
         f"{os.sep}torch{os.sep}")


def _frame_site(limit: int = 48):
    """(where, exempt reason or None) of the current Python stack: the
    innermost frame outside torch and this module, and the first frame
    whose (module, qualname) is a sanctioned host read."""
    f = sys._getframe(2)
    where, reason = None, None
    n = 0
    while f is not None and n < limit:
        code = f.f_code
        path = os.path.abspath(code.co_filename)
        if path.startswith(_ROOT + os.sep):
            rel = os.path.relpath(path, _ROOT).replace(os.sep, "/")
            qual = getattr(code, "co_qualname", code.co_name)
            if reason is None:
                reason = SANCTIONED_HOST_READS.get((rel, qual))
            if where is None and path != _THIS:
                where = f"windflow_tpu_torch/{rel}:{f.f_lineno} ({qual})"
        elif where is None and not path.startswith(_SKIP[0]) \
                and _SKIP[1] not in path:
            where = (f"{code.co_filename}:{f.f_lineno} "
                     f"({getattr(code, 'co_qualname', code.co_name)})")
        f = f.f_back
        n += 1
    return where or "?", reason


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Recorder(TorchDispatchMode):
    """Lists the aten ops of one program and the hazards among them.
    Bookkeeping never raises into the step: a fault lands in
    ``error`` and the program is reported pending."""

    def __init__(self, backend: str) -> None:
        super().__init__()
        self.backend = backend
        self.thread = threading.get_ident()
        self.ops: Dict[str, int] = {}
        self.hazards: Dict[str, List[str]] = {
            "crossings": [], "host_ops": [], "dynamic": [],
            "host_reads": [], "syncs": []}
        self.wide = set()
        self.exempt: List[dict] = []
        #: the mesh collectives the program ran (parallel/mesh.recording)
        self.collectives: List[dict] = []
        self.error: Optional[BaseException] = None

    def note(self, kind: str, what: str) -> None:
        where, reason = _frame_site()
        entry = f"{what} @ {where}"
        if reason is not None:
            e = {"fact": kind, "what": entry, "reason": reason}
            if e not in self.exempt:
                self.exempt.append(e)
        elif entry not in self.hazards[kind]:
            self.hazards[kind].append(entry)

    def _pre(self, func, args, kwargs) -> None:
        name = func.overloadpacket.__name__
        if func.namespace == "prim":
            return
        key = f"aten.{name}"
        self.ops[key] = self.ops.get(key, 0) + 1
        if name in _HOST_READ_OPS:
            self.note("host_reads", key)
        elif name in _DYNAMIC_OPS or (
                name == "repeat_interleave"
                and len(args) > 1 and hasattr(args[1], "dtype")):
            self.note("dynamic", key)
        elif name in ("index", "index_put", "index_put_"):
            idx = args[1] if len(args) > 1 else ()
            import torch
            if any(t is not None and isinstance(t, torch.Tensor)
                   and t.dtype == torch.bool for t in idx):
                self.note("dynamic", f"{key} (bool mask)")

    def _post(self, func, args, kwargs, out) -> None:
        if func.namespace == "prim":
            return
        name = func.overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            w = _WIDE.get(str(t.dtype))
            if w is not None:
                self.wide.add(w)
        if self.backend != "cuda":
            return
        on_card = any(t.device.type == "cuda" for t in ins)
        to_host = [t for t in outs if t.device.type == "cpu"]
        if on_card and to_host:
            self.note("crossings", f"aten.{name} (to host)")
        elif ins and not on_card and name not in _HOST_FACTORY_OPS \
                and any(t.numel() > 1 for t in ins):
            self.note("host_ops", f"aten.{name} (on host tensors)")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        try:
            self._pre(func, args, kwargs)
        except Exception as e:  # lint: broad-except-ok (bookkeeping
            # never breaks the step; the program reports pending)
            self.error = e
        out = func(*args, **kwargs)
        try:
            self._post(func, args, kwargs, out)
        except Exception as e:  # lint: broad-except-ok (as above)
            self.error = e
        return out

    def facts(self, kind: str) -> dict:
        return {
            "kind": kind,
            "backend": self.backend,
            "aten_ops": sum(self.ops.values()),
            "ops": sorted(self.ops),
            "crossings": list(self.hazards["crossings"]),
            "host_ops": list(self.hazards["host_ops"]),
            "wide_dtypes": sorted(self.wide),
            "dynamic": list(self.hazards["dynamic"]),
            "host_reads": list(self.hazards["host_reads"]),
            "syncs": list(self.hazards["syncs"]),
            "exempt": list(self.exempt),
            "collectives": sorted({c["op"] for c in self.collectives}),
            "collective_ops": list(self.collectives),
        }


class _Recording:
    """One program's recording: the dispatch mode, and on the card the
    sync debug mode's warnings (raised from "off" to "warn" for the
    recording only; a mode the caller set stays), the kernel gates and
    launches around it."""

    def __init__(self, backend: str, capture: bool = False) -> None:
        self.rec = _Recorder(backend)
        self.backend = backend
        self.capture = capture
        self._sync_prev = None
        self._warn_ctx = None

    def __enter__(self):
        from windflow_tpu_torch.kernels import ffat_cuda as fc
        self.launches0 = fc.launch_counts()
        self.gates0 = fc.gates_open()
        if self.backend == "cuda" and not self.capture:
            self._watch_syncs()
        self.rec.__enter__()
        return self

    def _watch_syncs(self) -> None:
        import torch
        prev = torch.cuda.get_sync_debug_mode()
        self._sync_prev = prev
        if prev == 0:
            with warnings.catch_warnings():
                # torch warns once that the mode is a prototype
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode(1)
        rec, raised = self.rec, prev == 0
        self._warn_ctx = warnings.catch_warnings()
        self._warn_ctx.__enter__()
        warnings.filterwarnings("always", message=f".*{_SYNC_TEXT}")
        orig = self._warn_ctx._showwarning

        def hook(message, category, filename, lineno, file=None,
                 line=None):
            mine = threading.get_ident() == rec.thread \
                and _SYNC_TEXT in str(message)
            if mine:
                rec.note("syncs", "cuda sync")
                if raised:
                    return
            orig(message, category, filename, lineno, file, line)
        warnings.showwarning = hook

    def __exit__(self, *exc) -> None:
        self.rec.__exit__(*exc)
        if self._warn_ctx is not None:
            self._warn_ctx.__exit__(*exc)
            self._warn_ctx = None
        if self._sync_prev == 0:
            import torch
            torch.cuda.set_sync_debug_mode(0)
        self._sync_prev = None

    def facts(self, kind: str, kernels: bool, launches=None) -> dict:
        from windflow_tpu_torch.kernels import ffat_cuda as fc
        if launches is None:
            after = fc.launch_counts()
            launches = {k: after[k] - self.launches0[k] for k in after}
        out = self.rec.facts(kind)
        out["kernels_resolved"] = bool(kernels)
        gates = fc.gates_open()
        out["kernel_gates"] = {k: gates[k] - self.gates0[k] for k in gates
                               if gates[k] != self.gates0[k]}
        out["launches_by_kernel"] = {k: int(v) for k, v in launches.items()
                                     if v}
        out["kernel_launches"] = int(sum(launches.values()))
        return out


# ---------------------------------------------------------------------------
# the process-wide program store
# ---------------------------------------------------------------------------

#: per-program cap on distinct recorded signatures
MAX_SIGS_PER_OP = 16

_store: Dict[str, Dict[object, dict]] = {}
_store_lock = threading.Lock()
#: programs whose recording failed, warned once each
_warned = set()


def record_program(op_name: str, sig, facts: dict) -> None:
    """Store the facts of one recorded program (the twin of the JAX
    package's ``record_lowered``)."""
    if not ENABLED:
        return
    with _store_lock:
        progs = _store.setdefault(op_name, {})
        if sig in progs or len(progs) < MAX_SIGS_PER_OP:
            progs[sig] = facts


def store_snapshot() -> Dict[str, List[dict]]:
    """program name -> recorded facts (a copy)."""
    with _store_lock:
        return {name: list(progs.values())
                for name, progs in _store.items()}


def reset_store() -> None:
    """Drop every recorded program (tests)."""
    with _store_lock:
        _store.clear()


def _claim(op, name: str, sig, facts: dict) -> None:
    """Keep the facts on the operator too: a graph's audit reads its own
    operators' programs, whatever other graph reused a name."""
    with _store_lock:
        progs = op.__dict__.setdefault("_audit_programs", {})
        progs.setdefault(name, {})[sig] = facts


def _fail(op, name: str, e: BaseException) -> None:
    op._audit_failed = True
    if name in _warned:
        return
    _warned.add(name)
    warnings.warn(
        f"capture audit: recording '{name}' failed ({type(e).__name__}: "
        f"{e}); its program stays unaudited (pending in "
        "stats()['IR_audit'])", RuntimeWarning, stacklevel=3)


def _batch_sig(batch):
    from windflow_tpu_torch.utils.tree import tree_leaves
    return (int(batch.valid.shape[0]),
            tuple((str(a.dtype), tuple(a.shape[1:]))
                  for a in tree_leaves(batch.payload)
                  if hasattr(a, "dtype")))


def record_step(rep, batch):
    """Run ``rep``'s step on ``batch`` under the recorder (its first
    step; ``ops/gpu._GPUReplica``) and store the facts under the name
    its step registry handle carries.  Returns the step's output."""
    op = rep.op
    fx = op._fusion_exec
    name = (op if fx is None else fx).name
    try:
        sig = _batch_sig(batch)
        from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
        kernels = resolve_kernels(op.config)
        recording = _Recording(batch.valid.device.type)
    except Exception as e:  # lint: broad-except-ok (the audit never
        # breaks a step: the program reports pending)
        _fail(op, name, e)
        return rep._op_step(batch)
    from windflow_tpu_torch.parallel import mesh as M
    with recording, M.recording() as coll:
        out = rep._op_step(batch)
    recording.rec.collectives = coll
    try:
        facts = recording.facts("step", kernels)
        if recording.rec.error is not None:
            raise recording.rec.error
        record_program(name, sig, facts)
        _claim(op, name, sig, facts)
    except Exception as e:  # lint: broad-except-ok (as above)
        _fail(op, name, e)
    return out


class CaptureAudit:
    """The recording of one megastep capture (``megastep.py``): enter it
    inside the ``CountedGraph`` capture, around the group body; call
    :meth:`finish` with the graph's captured launches once the capture
    has ended."""

    def __init__(self, op, name: str, sig, kernels: bool) -> None:
        self.op, self.name, self.sig = op, name, sig
        self.kernels = kernels
        self.recording = _Recording("cuda", capture=True)

    def __enter__(self):
        self.recording.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.recording.__exit__(*exc)

    def finish(self, launches: dict) -> None:
        try:
            facts = self.recording.facts("capture", self.kernels,
                                         launches=launches)
            if self.recording.rec.error is not None:
                raise self.recording.rec.error
            record_program(self.name, self.sig, facts)
            _claim(self.op, self.name, self.sig, facts)
        except Exception as e:  # lint: broad-except-ok (as above)
            _fail(self.op, self.name, e)


def capture_audit(op, name: str, sig, config) -> Optional[CaptureAudit]:
    """A :class:`CaptureAudit` for a megastep capture, or None when the
    audit is off."""
    if not enabled(config):
        return None
    from windflow_tpu_torch.kernels.ffat_cuda import resolve_kernels
    return CaptureAudit(op, name, sig, resolve_kernels(config))


# ---------------------------------------------------------------------------
# fact -> diagnostic interpretation
# ---------------------------------------------------------------------------

def cross_key_collectives(facts: dict, mesh=None) -> List[str]:
    """The collective kinds in ``facts`` that move non-scalar data across
    the mesh's key axis: the traffic aligned ingest removes, and the
    only collectives WF901 charges.  Scalar counter reduces and
    within-column (data-axis) gathers are excluded.  A record carries
    its ``crosses_key`` flag (``parallel/mesh.py``), or ``groups`` of
    flat position indices (data-major) read against ``mesh``; a record
    with neither counts as crossing, and facts without records fall
    back to every collective."""
    ops = facts.get("collective_ops")
    if ops is None:
        return list(facts.get("collectives") or [])
    kk = mesh.shape["key"] if mesh is not None else None
    out = set()
    for e in ops:
        numel = e.get("numel")
        if numel is not None and numel <= 1:
            continue
        if "crosses_key" in e:
            if e["crosses_key"]:
                out.add(e["op"])
            continue
        groups = e.get("groups")
        if kk is None or groups is None:
            out.add(e["op"])
            continue
        if any(len({int(i) % kk for i in grp}) > 1 for grp in groups):
            out.add(e["op"])
    return sorted(out)


def _collective_context(graph, op) -> tuple:
    """``(promised, alignable_unaligned)`` for WF901: ``promised`` when
    key-aligned ingest stamped this consumer collective-free,
    ``alignable_unaligned`` when it qualifies for aligned ingest but
    runs without it (the collective is provably avoidable)."""
    if getattr(graph.config, "mesh", None) is None:
        return False, False
    if getattr(op, "_ingest_mode", None) == "aligned":
        return True, False
    from windflow_tpu_torch.parallel.mesh import _aligned_slot_bound
    alignable = (getattr(op, "is_gpu", False)
                 and _aligned_slot_bound(op) is not None
                 and op.is_keyed and op.parallelism == 1)
    return False, alignable


def program_findings(op_name: str, facts: dict, *,
                     promised_collective_free: bool = False,
                     alignable_unaligned: bool = False,
                     cross_key: Optional[List[str]] = None
                     ) -> List[Diagnostic]:
    """WF9xx diagnostics for ONE program's facts under graph context.
    WF901 needs the caller to say what the graph promised; ``cross_key``
    (:func:`cross_key_collectives`) narrows it to the collectives that
    cross the key axis, None to every collective of the program."""
    out: List[Diagnostic] = []
    backend = facts.get("backend")
    coll = facts.get("collectives") if cross_key is None else cross_key
    if coll and (promised_collective_free or alignable_unaligned):
        what = ", ".join(coll)
        if promised_collective_free:
            msg = (f"program '{op_name}' runs cross-device collective(s) "
                   f"[{what}] on an edge the aligned-ingest plan "
                   "promised collective-free")
            hint = ("the aligned sharded step regressed: the modeled "
                    "inter-position drop (shard ledger) no longer holds")
        else:
            msg = (f"program '{op_name}' pays cross-device "
                   f"collective(s) [{what}] on an edge aligned ingest "
                   "would make collective-free")
            hint = ("enable Config.key_aligned_ingest "
                    "(WF_TPU_KEY_ALIGNED=1) so the consumer takes "
                    "pre-placed lanes instead of the in-step gather")
        out.append(Diagnostic("WF901", msg, node=op_name, hint=hint))
    host = list(facts.get("crossings") or []) \
        + list(facts.get("host_ops") or [])
    if host and backend == "cuda":
        out.append(Diagnostic(
            "WF902",
            f"program '{op_name}' crosses to host tensors inside its CUDA "
            f"step body: {'; '.join(host[:4])}",
            node=op_name,
            hint="keep the step on the card; move host work to a host "
                 "operator or a sink"))
    if facts.get("wide_dtypes") and backend == "cuda":
        out.append(Diagnostic(
            "WF903",
            f"program '{op_name}' carries 64-bit floating values "
            f"[{', '.join(facts['wide_dtypes'])}] on the cuda backend "
            "(int64 lanes are native and not counted)",
            node=op_name,
            hint="stage float32 (a record spec's np.float32 lanes; a "
                 "Python float stages float64)"))
    if facts.get("dynamic"):
        out.append(Diagnostic(
            "WF904",
            f"program '{op_name}' runs data-dependent output shape(s): "
            f"{'; '.join(facts['dynamic'][:4])} — a host sync, and no "
            "CUDA graph captures it",
            node=op_name,
            hint="keep lanes at fixed capacity and mask them"))
    reads = list(facts.get("host_reads") or []) \
        + list(facts.get("syncs") or [])
    if reads:
        out.append(Diagnostic(
            "WF906",
            f"program '{op_name}' reads the device on the host inside its "
            f"step body: {'; '.join(reads[:4])}",
            node=op_name,
            hint="return the value with the batch and read it at drain "
                 "time, or list a purposeful read in "
                 "ir_audit.SANCTIONED_HOST_READS"))
    launched = facts.get("launches_by_kernel") or {}
    missed = sorted(k for k, n in (facts.get("kernel_gates") or {}).items()
                    if n > 0 and not launched.get(k))
    if backend == "cuda" and facts.get("kernels_resolved") and missed:
        out.append(Diagnostic(
            "WF907",
            f"program '{op_name}' ran on the card with the kernels "
            f"resolved on and the gate of [{', '.join(missed)}] holding, "
            "but launched no such kernel — its plain version ran in its "
            "place",
            node=op_name,
            hint="the WF607 downgrade, proven on the program: check "
                 "Config.cuda_kernels and the kernel wrappers "
                 "(windflow_tpu_torch/kernels)"))
    return out


# ---------------------------------------------------------------------------
# graph-level report
# ---------------------------------------------------------------------------

class IRAuditReport:
    """One audit's result: programs audited, WF9xx diagnostics, the
    operators whose programs ran unrecorded, and the pass cost."""

    def __init__(self) -> None:
        self.programs_audited = 0
        self.dry_lowered = 0
        self.findings: List[Diagnostic] = []
        self.suppressed = 0
        self.pending: List[str] = []
        self.check_ms = 0.0
        #: every program name this graph's operators claimed
        self.op_names: set = set()
        #: one row a program: name, kind, backend, aten ops, launches
        self.programs: List[dict] = []
        #: sanctioned host reads seen, with their reasons
        self.exempt: List[dict] = []

    @property
    def diagnostics(self) -> List[Diagnostic]:
        return self.findings

    def to_json(self) -> dict:
        return {
            "programs_audited": self.programs_audited,
            "dry_lowered": self.dry_lowered,
            "findings": [d.to_json() for d in self.findings],
            "suppressed": self.suppressed,
            "pending": sorted(self.pending),
            "check_ms": round(self.check_ms, 3),
            "programs": list(self.programs),
            "exempt_host_reads": list(self.exempt),
        }

    def _add(self, name: str, facts: dict, **context) -> List[Diagnostic]:
        self.programs_audited += 1
        self.programs.append({
            "name": name, "kind": facts.get("kind"),
            "backend": facts.get("backend"),
            "aten_ops": facts.get("aten_ops", 0),
            "kernel_launches": facts.get("kernel_launches", 0)})
        for e in facts.get("exempt") or []:
            row = dict(e, program=name)
            if row not in self.exempt:
                self.exempt.append(row)
        return program_findings(name, facts, **context)


def _graph_ops(graph) -> list:
    seen, out = set(), []
    for mp in graph._all_pipes():
        for op in mp.operators:
            if id(op) not in seen:
                seen.add(id(op))
                out.append(op)
    return out


def _suppression_anchor(op):
    """(path, lineno) of the operator's primary user function, or None:
    where a ``# wfverify: ok (reason)`` suppresses its findings."""
    import inspect
    for attr in ("fn", "comb", "lift", "key_extractor", "gen_fn"):
        fn = getattr(op, attr, None)
        if not callable(fn):
            continue
        try:
            path = inspect.getsourcefile(fn)
            _, lineno = inspect.getsourcelines(fn)
        except (OSError, TypeError):
            continue
        if path:
            return path, lineno
    return None


def _apply_suppression(op, findings: List[Diagnostic],
                       report: IRAuditReport) -> List[Diagnostic]:
    if not findings:
        return findings
    anchor = _suppression_anchor(op)
    if anchor is None:
        return findings
    try:
        from windflow_tpu_torch.analysis.tracecheck import suppression_at
        state = suppression_at(*anchor)
    except Exception:  # lint: broad-except-ok (suppression lookup reads
        # user source files; unreadable source means no suppression)
        state = None
    if state == "ok":
        report.suppressed += len(findings)
        return []
    return findings


def _stepped(op) -> bool:
    for w in (op._watch, getattr(op._fusion_exec, "_watch", None)):
        if w is not None and w.dispatches > 0:
            return True
    return False


def _dry_record(op, spec, cap: int, device: str) -> Optional[dict]:
    """The user function of a device operator run under
    ``FakeTensorMode`` over a fake ``[cap]``-lane batch of its record
    spec, with the recorder on top: shapes, dtypes and devices only, no
    storage and no device work.  None when the operator has no
    per-record function."""
    fn = getattr(op, "fn", None)
    if fn is None or getattr(op, "batch_fn", False) or not callable(fn):
        return None
    from torch._subclasses.fake_tensor import FakeTensorMode

    from windflow_tpu_torch.analysis.preflight import _fake_batch
    from windflow_tpu_torch.utils.tree import per_record
    recording = _Recording(device, capture=True)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = _fake_batch(spec, cap, device)
            with recording:
                per_record(fn, args, cap)
    except Exception as e:  # noqa: BLE001 - lint: broad-except-ok (the
        # kernel pass reports an un-evaluable function as WF101; a
        # data-dependent shape surfaces here as the fake mode's refusal)
        if "DynamicOutputShape" in type(e).__name__ \
                or "nonzero" in str(e):
            recording.rec.hazards["dynamic"].append(
                f"{type(e).__name__} under FakeTensorMode")
    return recording.rec.facts("dry")


def audit_graph(graph, dry_lower: bool = True) -> IRAuditReport:
    """Audit every recorded program of ``graph``'s operators, plus, on a
    graph not started yet, a dry run of each device operator's user
    function over the preflight record specs.  Cold path: called at
    check()/stats/postmortem cadence."""
    t0 = time.perf_counter()
    report = IRAuditReport()
    if not enabled(getattr(graph, "config", None)):
        report.check_ms = (time.perf_counter() - t0) * 1e3
        return report
    in_specs = None
    unknown = None
    mesh = getattr(graph.config, "mesh", None)
    for op in _graph_ops(graph):
        promised, alignable = _collective_context(graph, op)
        findings: List[Diagnostic] = []
        rows = []
        with _store_lock:
            for n, sigs in op.__dict__.get("_audit_programs", {}).items():
                report.op_names.add(n)
                rows.extend((n, f) for f in sigs.values())
        for n, facts in rows:
            findings.extend(report._add(
                n, facts, promised_collective_free=promised,
                alignable_unaligned=alignable,
                cross_key=cross_key_collectives(facts, mesh)))
        if not rows and getattr(op, "is_gpu", False) and dry_lower \
                and not getattr(graph, "_started", False):
            if in_specs is None:
                from windflow_tpu_torch.analysis.preflight import (
                    _UNKNOWN, propagate_specs)
                in_specs, _ = propagate_specs(graph)
                unknown = _UNKNOWN
            spec = in_specs.get(id(op), unknown)
            if spec is not unknown:
                cap = graph.config.default_batch_size or 1
                for up in _graph_ops(graph):
                    if getattr(up, "output_batch_size", 0):
                        cap = up.output_batch_size
                        break
                dev = str(getattr(graph.config, "device", "cpu"))
                facts = _dry_record(op, spec, min(cap, 1 << 16),
                                    "cuda" if dev.startswith("cuda")
                                    else "cpu")
                if facts is not None:
                    report.dry_lowered += 1
                    findings.extend(report._add(
                        f"{op.name} (dry-recorded function)", facts))
        if not rows and getattr(op, "is_gpu", False) \
                and (op.__dict__.get("_audit_failed") or _stepped(op)):
            report.pending.append(op.name)
        report.findings.extend(_apply_suppression(op, findings, report))
    report.check_ms = (time.perf_counter() - t0) * 1e3
    return report


def audit_orphans(claimed) -> IRAuditReport:
    """Context-free audit of the recorded programs NO audited graph
    claimed (another graph's in this process); the CLI runs this sweep
    last so every recorded program is covered once."""
    t0 = time.perf_counter()
    report = IRAuditReport()
    if not ENABLED:
        report.check_ms = (time.perf_counter() - t0) * 1e3
        return report
    claimed = set(claimed)
    for op_name, facts_list in sorted(store_snapshot().items()):
        if op_name in claimed:
            continue
        report.op_names.add(op_name)
        for facts in facts_list:
            report.findings.extend(report._add(op_name, facts))
    report.check_ms = (time.perf_counter() - t0) * 1e3
    return report
