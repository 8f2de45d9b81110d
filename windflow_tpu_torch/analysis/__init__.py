"""Static analysis (the port of ``windflow_tpu/analysis``, its
restore-time half): the :class:`~windflow_tpu_torch.analysis.diagnostics.
Diagnostic` record and the checkpoint-manifest checks ``PipeGraph.restore()``
runs before it touches any state (``preflight.manifest_conflicts``,
``preflight.manifest_rescale_plan``).  The graph preflight passes are not
ported yet."""
