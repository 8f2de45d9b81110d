"""The routing and distribution plane of the port: emitters, collectors,
key compaction, and the multi-GPU mesh (``parallel.mesh``,
``parallel.multihost``), whose names are exported lazily, as in the JAX
package."""

_MESH_EXPORTS = (
    "DATA_AXIS", "KEY_AXIS", "make_mesh", "make_sharded_ffat_state",
    "make_sharded_ffat_step", "make_sharded_keyed_reduce", "stage_batch",
)


def __getattr__(name):
    # lazy (PEP 562): the mesh imports the window and operator modules,
    # which import this package
    if name in _MESH_EXPORTS + ("mesh",):
        import windflow_tpu_torch.parallel.mesh as _mesh
        return _mesh if name == "mesh" else getattr(_mesh, name)
    raise AttributeError(name)
