"""Diagnostic records (the port of ``windflow_tpu/analysis/diagnostics.py``):
one record type with a stable ``WFxxx`` code, a severity, the graph node
it anchors to and a fix hint.  The port carries the codes its ported
checks emit: the restore-time WF602 and WF605."""

from __future__ import annotations

import dataclasses
from typing import Optional

#: code -> (default severity, one-line description); the JAX package's
#: table, restricted to the codes the port emits (append-only there too)
CODES = {
    "WF602": ("error", "restore target graph mismatches the checkpoint "
                       "manifest topology"),
    "WF605": ("error", "restore manifest shard shape cannot be "
                       "re-bucketed onto the target graph"),
}


@dataclasses.dataclass
class Diagnostic:
    """One analysis finding: ``node`` names the graph operator."""

    code: str
    message: str
    node: Optional[str] = None
    hint: Optional[str] = None
    severity: str = ""

    def __post_init__(self) -> None:
        if not self.severity:
            self.severity = CODES.get(self.code, ("error",))[0]

    def __str__(self) -> str:
        where = f"node '{self.node}'" if self.node else "graph"
        s = f"{self.code} [{self.severity}] {where}: {self.message}"
        if self.hint:
            s += f" (hint: {self.hint})"
        return s
