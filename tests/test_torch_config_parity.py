"""The port's ``Config`` against the JAX package's: the only field only
JAX has is the kernel switch the port renames (``pallas_kernels`` →
``cuda_kernels``); every shared field, the mesh's two (``mesh``,
``key_aligned_ingest``) included, has the JAX default.  And the
``Config.ffat_grouping`` rider: the argsort grouping gives the counting
grouping's records, and JAX's, on count and time windows."""

import dataclasses

import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt


def _fields(cls):
    return {f.name for f in dataclasses.fields(cls)}


def test_config_fields_differ_only_by_the_mesh_and_the_kernel_switch():
    jax_only = _fields(wf.Config) - _fields(wt.Config)
    port_only = _fields(wt.Config) - _fields(wf.Config)
    assert jax_only == {"pallas_kernels"}
    assert port_only == {"device", "cuda_kernels"}
    shared = _fields(wf.Config) & _fields(wt.Config)
    assert len(shared) == 55
    jc, tc = wf.Config(), wt.Config()
    assert {n: getattr(tc, n) for n in shared} == \
        {n: getattr(jc, n) for n in shared}
    for name in ("host_worker_threads", "ir_audit", "default_batch_size",
                 "ffat_grouping", "mesh", "key_aligned_ingest"):
        assert name in shared


def _window_run(pkg, grouping, tb, monoid):
    """Keyed windows over 4,096 integer-valued records in batches of
    512: (key, wid, value) records."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 16, 4096)
    vals = rng.integers(-50, 51, 4096).astype(np.float32)
    recs = [{"key": np.int32(k), "v": np.float32(v), "ts": np.int64(i * 7)}
            for i, (k, v) in enumerate(zip(keys, vals))]
    out = []
    b = (wt.Ffat_WindowsGPU_Builder if pkg is wt
         else wf.Ffat_WindowsTPU_Builder)(lambda t: t["v"],
                                          lambda a, b: a + b)
    b = b.withTBWindows(700, 350) if tb else b.withCBWindows(16, 4)
    b = b.withKeyBy(lambda t: t["key"]).withMaxKeys(16)
    if monoid:
        b = b.withSumCombiner()
    kw = {"device": "cpu"} if pkg is wt else {}
    g = pkg.PipeGraph("grouping", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT if tb else pkg.TimePolicy.INGRESS,
                      config=pkg.Config(ffat_grouping=grouping, **kw))
    src = pkg.Source_Builder(lambda: iter(recs)).withOutputBatchSize(512)
    if tb:
        src = src.withTimestampExtractor(lambda t: t["ts"])
    g.add_source(src.build()).add(b.build()).add_sink(pkg.Sink_Builder(
        lambda r: out.append((int(r["key"]), int(r["wid"]),
                              float(r["value"]))) if r is not None
        else None).build())
    g.run()
    return sorted(out)


@pytest.mark.parametrize("monoid", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_ffat_grouping_argsort_equals_rank_scatter_and_jax(tb, monoid):
    got = _window_run(wt, "argsort", tb, monoid)
    assert got
    assert got == _window_run(wt, "rank_scatter", tb, monoid)
    assert got == _window_run(wf, "argsort", tb, monoid)


def test_ffat_grouping_argsort_keeps_the_kernel_on_cuda_tensors():
    """``ffat_grouping="argsort"`` sorts only where the grouping kernel
    cannot run: kernels off, or a CPU tensor.  A CUDA tensor with the
    kernels on keeps the kernel (the same records by construction)."""
    from windflow_tpu_torch.windows.ffat_kernels import _sorts
    assert not _sorts("argsort", True, True)
    assert _sorts("argsort", False, True)
    assert _sorts("argsort", True, False)
    assert not _sorts("rank_scatter", False, False)


def test_ffat_grouping_is_validated_at_step_build():
    with pytest.raises(wt.WindFlowError, match="ffat_grouping"):
        _window_run(wt, "bogus", False, False)
