"""The ``@hot_path`` annotation (the port of ``windflow_tpu/analysis/
hotpath.py``): a performance contract the AST lint checks.

The staging pack loop, the flight recorder's ring writes, the emitters'
and collectors' per-tuple paths, the step registry's dispatch counters
and the latency ledger's harvest keep three rules: no allocation, no
host synchronization, no lock acquisition.  ``tools/wf_lint.py``
enforces them on every function carrying the mark (WF701, WF702,
WF703).  At runtime the decorator is the identity plus one attribute:
it adds nothing to the marked function's cost.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)

#: attribute stamped on marked functions (introspection, tests)
HOT_PATH_ATTR = "__wf_hot_path__"


def hot_path(fn: F) -> F:
    """Mark ``fn`` as hot-path code: ``tools/wf_lint.py`` rejects
    allocation, host synchronization and lock acquisition in its body."""
    setattr(fn, HOT_PATH_ATTR, True)
    return fn
