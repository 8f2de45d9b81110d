"""Static analysis and advisors (the port of ``windflow_tpu/analysis``).

One :class:`~windflow_tpu_torch.analysis.diagnostics.Diagnostic` record
(``WFxxx`` code, severity, graph node or ``file:line``, fix hint) for:

* ``analysis.preflight`` — ``PipeGraph.check()``: the whole graph
  evaluated on fake tensors before any device work (run first by
  ``start()`` under ``Config.preflight``), and the restore-time
  manifest checks ``PipeGraph.restore()`` runs;
* ``analysis.tracecheck`` — wfverify, the object-level verifier of the
  functions a graph runs and of the port's step bodies (WF80x, WF81x,
  WF61x), folded into ``check()``;
* ``analysis.hotpath`` — the ``@hot_path`` mark ``tools/wf_lint.py``
  enforces (WF701-WF703);
* ``analysis.debug_concurrency`` — the ``WF_TPU_DEBUG_CONCURRENCY=1``
  race detector on the shared structures.

The advisors plan over a ``stats()`` section: ``fusion.plan`` (the
fusible chains over ``Sweep``), ``resharding.plan`` (``Shard``),
``latency.plan`` (``Latency_plane``) and ``tenancy.plan`` (``Tenant``).
``python -m windflow_tpu_torch.analysis.check module:fn [--json]`` is
the command-line face of ``check()``; ``analysis.verify``,
``analysis.advisor`` and ``analysis.ir`` are those of wfverify, the
fusion plan and ``analysis.ir_audit``, the capture audit (WF9xx) of
each device replica's first step and each megastep capture.
"""

from windflow_tpu_torch.analysis.debug_concurrency import (
    ConcurrencyViolation, set_enabled)
from windflow_tpu_torch.analysis.diagnostics import CODES, Diagnostic
from windflow_tpu_torch.analysis.hotpath import hot_path


def check_graph(graph):
    """Every preflight pass over a composed PipeGraph (imported lazily:
    the hot-path consumers of ``hot_path`` keep this package cheap)."""
    from windflow_tpu_torch.analysis.preflight import check_graph as _cg
    return _cg(graph)


def verify_graph(graph):
    """The wfverify families alone over a composed PipeGraph: a
    :class:`~windflow_tpu_torch.analysis.tracecheck.VerifyReport`."""
    from windflow_tpu_torch.analysis.tracecheck import verify_graph as _vg
    return _vg(graph)


__all__ = ["CODES", "ConcurrencyViolation", "Diagnostic", "check_graph",
           "hot_path", "set_enabled", "verify_graph"]
