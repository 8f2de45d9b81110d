"""The whole count-window slice through ``PipeGraph.run()`` in both
packages, plus the port's device and isolation rules.

The same graph — Source → Map → Filter (chained) → keyed FFAT CB → Sink,
the user functions of bench.py:716-721 — is built with the JAX package's
TPU builders and the port's GPU builders, run in DEFAULT mode on the
same numpy records, and the sink records are compared sorted by
(key, wid).  Tolerances: record-identical on integer-valued values (both
combiners).  On random floats rtol 1e-5 for both: XLA on the CPU
contracts the map's ``v0 * 1.5 + 1.0`` into one fused multiply-add where
torch rounds twice (about 1 in 5 lanes differs in the last bit), and the
declared sum's pane cells are a scatter-add whose order differs (see
test_torch_ffat.py, which holds the window step itself bit-identical on
the generic combiner).
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu_torch.kernels import ffat_cuda as fc

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, KEYS, N = 512, 16, 2600


def _records(seed, floats):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, KEYS, N).astype(np.int32)
    if floats:
        vals = rng.standard_normal(N).astype(np.float32)
    else:
        vals = rng.integers(-100, 101, N).astype(np.float32)
    return keys, vals


def _run(pkg, keys, vals, sum_combiner, config, win=64, slide=16):
    out = []

    def gen():
        for k, v in zip(keys, vals):
            yield {"key": k, "v0": v}

    gpu = pkg is wt
    MB = wt.MapGPU_Builder if gpu else wf.MapTPU_Builder
    FB = wt.FilterGPU_Builder if gpu else wf.FilterTPU_Builder
    WB = wt.Ffat_WindowsGPU_Builder if gpu else wf.Ffat_WindowsTPU_Builder
    src = pkg.Source_Builder(gen).withOutputBatchSize(CAP).build()
    m = MB(lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build()
    f = FB(lambda t: (t["key"] & 7) != 7).build()
    wb = (WB(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(win, slide).withKeyBy(lambda t: t["key"])
          .withMaxKeys(KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    snk = pkg.Sink_Builder(
        lambda t: out.append(t) if t is not None else None).build()
    g = pkg.PipeGraph("slice", pkg.ExecutionMode.DEFAULT, config=config)
    pipe = g.add_source(src)
    pipe.add(m)
    pipe.chain(f)
    pipe.add(wb.build()).add_sink(snk)
    g.run()
    return sorted(((r["key"], r["wid"]), r["value"]) for r in out)


def _jax_cfg():
    # punctuation off the clock so batch boundaries are the same in both
    return dataclasses.replace(wf.default_config,
                               punctuation_interval_usec=10 ** 12)


def _port_cfg(**kw):
    return wt.Config(device="cpu", punctuation_interval_usec=10 ** 12, **kw)


def _oracle(keys, vals, win, slide):
    keep = (keys & 7) != 7
    ks = keys[keep]
    vs = (vals[keep] * np.float32(1.5) + np.float32(1.0)).astype(np.float64)
    out = {}
    for k in np.unique(ks):
        v = vs[ks == k]
        for w, s in enumerate(range(0, len(v), slide)):
            out[(int(k), w)] = float(v[s:s + win].sum())
    return out


@pytest.mark.parametrize("sum_combiner", [False, True])
def test_slice_record_identical_on_integer_values(sum_combiner):
    keys, vals = _records(1, floats=False)
    a = _run(wf, keys, vals, sum_combiner, _jax_cfg())
    b = _run(wt, keys, vals, sum_combiner, _port_cfg())
    assert a == b
    assert dict(b) == _oracle(keys, vals, 64, 16)


@pytest.mark.parametrize("sum_combiner", [False, True])
def test_slice_random_floats(sum_combiner):
    keys, vals = _records(2, floats=True)
    a = _run(wf, keys, vals, sum_combiner, _jax_cfg())
    b = _run(wt, keys, vals, sum_combiner, _port_cfg())
    assert [r[0] for r in a] == [r[0] for r in b]
    np.testing.assert_allclose([r[1] for r in b], [r[1] for r in a],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sum_combiner", [False, True])
def test_kill_switch_same_records_and_builds_nothing(sum_combiner):
    keys, vals = _records(3, floats=False)
    before = fc.kernel_build_count()
    off = _run(wt, keys, vals, sum_combiner, _port_cfg(cuda_kernels="0"))
    assert fc.kernel_build_count() == before
    on = _run(wt, keys, vals, sum_combiner, _port_cfg(cuda_kernels="auto"))
    assert fc.kernel_build_count() > before
    assert on == off


def test_non_keyed_window_and_tumbling_shape():
    keys, vals = _records(4, floats=False)
    a, b = [], []
    for pkg, out, cfg in ((wf, a, _jax_cfg()), (wt, b, _port_cfg())):
        WB = wt.Ffat_WindowsGPU_Builder if pkg is wt \
            else wf.Ffat_WindowsTPU_Builder

        def gen():
            for k, v in zip(keys, vals):
                yield {"key": k, "v0": v}
        g = pkg.PipeGraph("nk", pkg.ExecutionMode.DEFAULT, config=cfg)
        g.add_source(pkg.Source_Builder(gen).withOutputBatchSize(CAP)
                     .build()).add(
            WB(lambda t: t["v0"], lambda a_, b_: a_ + b_)
            .withCBWindows(32, 32).build()).add_sink(
            pkg.Sink_Builder(lambda t, o=out: o.append(t)
                             if t is not None else None).build())
        g.run()
    assert sorted((r["key"], r["wid"], r["value"]) for r in a) == \
        sorted((r["key"], r["wid"], r["value"]) for r in b)


def test_columnar_sink_gets_the_same_windows():
    keys, vals = _records(5, floats=False)
    rows = _run(wt, keys, vals, True, _port_cfg())
    cols = []

    def gen():
        for k, v in zip(keys, vals):
            yield {"key": k, "v0": v}
    g = wt.PipeGraph("col", config=_port_cfg())
    pipe = g.add_source(wt.Source_Builder(gen).withOutputBatchSize(CAP)
                        .build())
    pipe.chain(wt.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
             .withCBWindows(64, 16).withKeyBy(lambda t: t["key"])
             .withMaxKeys(KEYS).withSumCombiner().build())
    pipe.add_sink(wt.Sink_Builder(
        lambda c: cols.append(c) if c is not None else None)
        .withColumnarSink(defer=1).build())
    g.run()
    got = sorted(((int(k), int(w)), float(v)) for c in cols
                 for k, w, v in zip(c.cols["key"], c.cols["wid"],
                                    c.cols["value"]))
    assert got == rows
    st = g.stats()
    assert [d["platform"] for d in st["Device"]["memory"]] == ["cpu"]
    assert [o["Operator_type"] for o in st["Operators"]] == \
        ["Source", "ChainedGPU", "FfatWindowsGPU", "Sink"]


# ---------------------------------------------------------------------------
# device rules and isolation
# ---------------------------------------------------------------------------

def _tiny_graph(config=None):
    g = wt.PipeGraph("dev", config=config)
    pipe = g.add_source(wt.Source_Builder(lambda: iter([{"k": np.int32(1)}]))
                        .withOutputBatchSize(8).build())
    pipe.add(wt.MapGPU_Builder(lambda t: t).build())
    pipe.add_sink(wt.Sink_Builder(lambda t: None).build())
    return g


def test_default_device_is_the_card_and_never_falls_back(monkeypatch):
    assert wt.Config().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(wt.WindFlowError, match="device='cpu'"):
        _tiny_graph().run()
    with pytest.raises(wt.WindFlowError):
        _tiny_graph(wt.Config(device="cuda")).run()
    _tiny_graph(wt.Config(device="cpu")).run()


def test_gpu_operators_need_default_mode_and_batched_input():
    g = wt.PipeGraph("m", wt.ExecutionMode.DETERMINISTIC,
                     config=wt.Config(device="cpu"))
    pipe = g.add_source(wt.Source_Builder(lambda: iter([]))
                        .withOutputBatchSize(8).build())
    pipe.add(wt.MapGPU_Builder(lambda t: t).build())
    pipe.add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(wt.WindFlowError, match="DEFAULT"):
        g.run()
    g2 = wt.PipeGraph("b", config=wt.Config(device="cpu"))
    pipe2 = g2.add_source(wt.Source_Builder(lambda: iter([])).build())
    with pytest.raises(wt.WindFlowError, match="batch size"):
        pipe2.add(wt.MapGPU_Builder(lambda t: t).build())


def test_unported_window_kinds_are_named():
    with pytest.raises(wt.WindFlowError):
        wt.Ffat_WindowsGPU_Builder(lambda t: t, lambda a, b: a + b).build()
    with pytest.raises(wt.WindFlowError, match="monoid"):
        (wt.Ffat_WindowsGPU_Builder(lambda t: t, lambda a, b: a + b)
         .withCBWindows(4, 2).withMonoidCombiner("avg").build())


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, windflow_tpu_torch, windflow_tpu_torch.interop, "
            "windflow_tpu_torch.kernels.build, windflow_tpu_torch.entry, "
            "windflow_tpu_torch.fusion, "
            "windflow_tpu_torch.analysis.ir_audit, "
            "windflow_tpu_torch.durability.chaos\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'windflow_tpu' or "
            "m.startswith('windflow_tpu.')]\n"
            "assert not bad, bad\nprint('clean')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "clean" in r.stdout


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_of_the_port_or_chip_smoke_imports_jax():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "chip_profile.py")]
    for root, _, names in os.walk(os.path.join(REPO, "windflow_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imported_roots(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "windflow_tpu"), (path, mod)


#: names of ``windflow_tpu.__all__`` whose modules the port has not
#: ported yet: none since the host window engine and the persistent
#: operators came over (A11a).  A name added to the JAX package's
#: exports without a port counterpart would go here, with its item.
NOT_YET_PORTED = set()


def test_top_level_exports_every_ported_name():
    """Every name the JAX package exports whose module is ported has its
    counterpart at the port's top level (TPU -> GPU in the name), in
    ``__all__`` too; the not-yet-ported list names no ported name."""
    import windflow_tpu as wf
    missing = []
    for name in wf.__all__:
        if name in NOT_YET_PORTED:
            assert not hasattr(wt, name.replace("TPU", "GPU")), name
            continue
        ported = name.replace("TPU", "GPU")
        if not hasattr(wt, ported) or ported not in wt.__all__:
            missing.append(ported)
    assert not missing, missing
    assert NOT_YET_PORTED <= set(wf.__all__)
    assert wt.EpochFileSink.__module__.startswith("windflow_tpu_torch.")
    assert wt.FfatWindowsGPU.__name__ == "FfatWindowsGPU"
