"""Diagnostic records shared by every static-analysis pass (the port of
``windflow_tpu/analysis/diagnostics.py``).

One record type carries what the analysis plane finds: the preflight
graph checker (``analysis/preflight.py``), wfverify
(``analysis/tracecheck.py``), the hot-path lint (``tools/wf_lint.py``)
and the race detector (``analysis/debug_concurrency.py``): a stable
``WFxxx`` code, a severity, the graph node or ``file:line`` it anchors
to, and a fix hint, readable by a machine (``to_json``) and a person
(``__str__``).  The code table is the JAX package's, code for code and
severity for severity, so its tools and JSON readers take the port's
output; the descriptions name what the port does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from windflow_tpu_torch.basic import WindFlowError

#: code -> (default severity, one-line description).  Codes are
#: append-only: a released code never changes meaning.
CODES = {
    # -- abstract evaluation of operator chains (WF1xx) ----------------------
    "WF101": ("error", "operator kernel failed abstract evaluation "
                       "(dtype/shape mismatch in the chain)"),
    "WF102": ("error", "filter predicate must return a boolean scalar"),
    "WF103": ("error", "reduce combiner must preserve the record "
                       "structure, shapes and dtypes"),
    "WF104": ("error", "key extractor of a keyed device operator must "
                       "return an integer scalar"),
    "WF105": ("error", "window combiner must preserve the lifted "
                       "aggregate structure"),
    "WF106": ("warning", "merged branches deliver different record "
                         "structures"),
    # -- window specifications (WF2xx) ---------------------------------------
    "WF201": ("error", "window length and slide must be positive"),
    "WF202": ("warning", "window slide exceeds window length: tuples in "
                         "the gaps belong to no window"),
    "WF203": ("warning", "lateness on a count-based window is ignored"),
    "WF204": ("error", "window lateness must be non-negative"),
    # -- graph composition / routing (WF3xx) ---------------------------------
    "WF301": ("error", "operator follows a terminal (sink) operator"),
    "WF302": ("error", "pipeline does not end in a sink"),
    "WF303": ("error", "KEYBY routing requires a key extractor"),
    "WF304": ("error", "malformed graph composition"),
    # -- mesh / sharding (WF4xx) ---------------------------------------------
    "WF401": ("error", "staged batch capacity not divisible across the "
                       "mesh devices"),
    "WF402": ("error", "keyed state space not divisible by the mesh key "
                       "axis"),
    "WF403": ("error", "merged upstream paths deliver unequal fixed "
                       "batch capacities"),
    "WF404": ("warning", "bounded key space declared but no monoid "
                         "combiner: the reduce takes the sorted path"),
    "WF405": ("warning", "declared monoid combiner diverges from the "
                         "user combiner on at least one record leaf"),
    # -- watermarks / time (WF5xx) -------------------------------------------
    "WF501": ("error", "EVENT time policy requires a timestamp "
                       "extractor on every source"),
    "WF502": ("error", "merge joins branches with mixed watermark modes"),
    "WF503": ("warning", "time-based windows fed by a watermark-less "
                         "source fire only at end-of-stream"),
    # -- durability / checkpoint-restore (WF6xx) -----------------------------
    "WF601": ("warning", "checkpointing enabled with a source that "
                         "cannot replay deterministically"),
    "WF602": ("error", "restore target graph mismatches the checkpoint "
                       "manifest topology"),
    "WF603": ("warning", "operator holds cross-batch state the "
                         "checkpoint cannot capture"),
    "WF604": ("warning", "keyed operator on a mesh checkpoints state "
                         "with no declared key space or compaction "
                         "remap: a shape-changing restore cannot "
                         "re-bucket it"),
    "WF605": ("error", "restore manifest shard shape cannot be "
                       "re-bucketed onto the target graph"),
    "WF606": ("warning", "wire compression downgraded to raw "
                         "passthrough: the staging edge has no "
                         "declared/inferred record spec"),
    "WF607": ("warning", "CUDA kernels forced on but downgraded to the "
                         "plain torch path (a CPU device, or a generic "
                         "combiner on the sliding fold)"),
    "WF608": ("warning", "megastep forced on but the edge downgraded "
                         "to per-batch dispatch (host operator, "
                         "host-interning or wavefront tail, compacted "
                         "key space, fan-out, or spec-less source)"),
    # -- determinism for replay (WF61x, wfverify) ----------------------------
    "WF611": ("warning", "RNG without an explicitly threaded generator "
                         "in a kernel/callback of a checkpointed graph"),
    "WF612": ("warning", "wall-clock read in a kernel/callback of a "
                         "checkpointed graph"),
    "WF613": ("warning", "id()/hash() identity dependence in a "
                         "kernel/callback of a checkpointed graph"),
    "WF614": ("warning", "set iteration-order dependence in a "
                         "kernel/callback of a checkpointed graph"),
    # -- hot-path lint (WF7xx, tools/wf_lint.py) -----------------------------
    "WF701": ("error", "allocation inside a @hot_path function"),
    "WF702": ("error", "host synchronization inside a @hot_path function"),
    "WF703": ("error", "lock acquisition inside a @hot_path function"),
    "WF711": ("error", "bare except"),
    "WF712": ("error", "broad 'except Exception' without an allowlist "
                       "justification"),
    "WF721": ("error", "lock-guarded attribute accessed outside its "
                       "declared lock"),
    # -- wfverify: the function objects handed to device operators and
    #    the port's own step bodies (analysis/tracecheck.py) ---------------
    "WF800": ("warning", "wfverify pass failed internally and was "
                         "skipped (analysis degraded, graph unchecked "
                         "by the object-level verifier)"),
    "WF801": ("error", "host read of a device tensor inside a device "
                       "kernel a CUDA graph may capture"),
    "WF802": ("error", "Python control flow on a device tensor inside a "
                       "device kernel"),
    "WF803": ("warning", "mutation of closure/global/default-arg state "
                         "inside a device kernel (a side effect a "
                         "captured replay skips)"),
    "WF804": ("warning", "print() inside a device kernel (runs at "
                         "capture only, never on a replay)"),
    "WF811": ("warning", "per-call host value frozen into a device "
                         "kernel (stale in a captured graph's replays)"),
    "WF812": ("warning", "data-dependent output shape inside a device "
                         "kernel (a host sync; no CUDA graph captures "
                         "it)"),
    # the port donates no buffer: the family never fires there
    "WF821": ("error", "donated operand read after dispatch (the buffer "
                       "is dead once the compiled program owns it)"),
    # -- the capture audit (WF9xx, analysis/ir_audit.py) ---------------------
    "WF900": ("warning", "ir-audit pass failed internally and was "
                         "skipped (analysis degraded, programs "
                         "unchecked)"),
    "WF901": ("error", "cross-chip collective in a program on an edge "
                       "the aligned-ingest plan promised (or would "
                       "make) collective-free"),
    "WF902": ("error", "host crossing inside a device step body (a "
                       "device-to-host copy or host compute)"),
    "WF903": ("error", "64-bit values survived into a device program "
                       "past the compiled-dtype gates"),
    "WF904": ("warning", "dynamic-shape op in a device program (IR "
                         "twin of the WF812 hazard)"),
    "WF905": ("error", "donation miss at IR level (not applicable in "
                       "the port: torch steps donate nothing and carry "
                       "state functionally)"),
    "WF906": ("warning", "mid-program device<->host transfer (scalar "
                         "D2H sync) in a device program"),
    "WF907": ("warning", "a CUDA kernel's plain version ran on the "
                         "card (the WF607 downgrade, proven on the "
                         "program)"),
}


@dataclasses.dataclass
class Diagnostic:
    """One analysis finding: ``node`` names the graph operator (preflight
    passes), ``location`` carries ``file:line`` (lint and wfverify)."""

    code: str
    message: str
    node: Optional[str] = None
    location: Optional[str] = None
    hint: Optional[str] = None
    severity: str = ""

    def __post_init__(self) -> None:
        if not self.severity:
            self.severity = CODES.get(self.code, ("error",))[0]

    def to_json(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "node": self.node,
            "location": self.location,
            "hint": self.hint,
        }

    def __str__(self) -> str:
        where = self.location or (f"node '{self.node}'" if self.node
                                  else "graph")
        s = f"{self.code} [{self.severity}] {where}: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s


class PreflightWarning(UserWarning):
    """Carrier of warning-severity preflight diagnostics (and of every
    finding under ``Config.preflight = "warn"``)."""


class PreflightError(WindFlowError):
    """Raised by ``PipeGraph.start()`` under ``Config.preflight="error"``
    when the checker finds error-severity diagnostics.  Carries ALL of
    them: the message lists every violation, not just the first."""

    def __init__(self, diagnostics: List[Diagnostic]) -> None:
        self.diagnostics = list(diagnostics)
        n = len(self.diagnostics)
        lines = "\n  ".join(str(d) for d in self.diagnostics)
        super().__init__(
            f"pre-flight check found {n} error(s) "
            f"(Config.preflight='warn'/'off' to bypass):\n  {lines}")
