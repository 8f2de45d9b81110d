"""Static analysis and advisors (the port of ``windflow_tpu/analysis``,
in part): the :class:`~windflow_tpu_torch.analysis.diagnostics.
Diagnostic` record, the checkpoint-manifest checks ``PipeGraph.restore()``
runs before it touches any state (``preflight.manifest_conflicts``,
``preflight.manifest_rescale_plan``), and the two plane advisors:
``latency.plan`` over ``stats()["Latency_plane"]`` and ``tenancy.plan``
over ``stats()["Tenant"]``.  The graph preflight passes are not ported
yet."""
