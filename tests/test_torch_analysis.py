"""The analysis plane (windflow_tpu_torch/analysis) against the JAX
package's (windflow_tpu/analysis): the preflight matrix, the modes of
``Config.preflight``, the hot-path lint, the race detector, the code
table, the check CLI, and the fusion, reshard, sweep and shard readers
of the preflight spec walk.

The matrix builds each seeded case in both packages (the builder prefix
swapped; jnp for torch in the user functions; a count-based FFAT window
where the JAX test used the host window engine the port has not yet) and
holds the sorted ``(code, severity, node)`` findings equal; messages may
differ.  The port's graphs run on the CPU (``Config(device="cpu")``);
its checks need no card (fake tensors), so the WF607 case checks a
``device="cuda"`` graph without running it.
"""

import dataclasses
import importlib.util
import json
import os
import textwrap
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu_torch import staging
from windflow_tpu_torch.analysis import debug_concurrency as dbg
from windflow_tpu_torch.analysis.diagnostics import (CODES, PreflightError,
                                                     PreflightWarning)
from windflow_tpu_torch.monitoring.recorder import ReplicaRing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(pkg, **kw):
    """A Config of either package; the port's on the CPU unless the case
    names a device.  The wire plane is off unless the case turns it on
    (its WF606 has a case of its own)."""
    kw.setdefault("wire_compression", False)
    if pkg is wt:
        kw.setdefault("device", "cpu")
        return wt.Config(**kw)
    kw.pop("device", None)
    kw.pop("cuda_kernels", None)
    return dataclasses.replace(wf.default_config, **kw)


def _graph(pkg, name, tp="INGRESS", **cfg):
    return pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                         getattr(pkg.TimePolicy, tp), config=_cfg(pkg, **cfg))


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


def _cat(pkg, xs):
    return jnp.concatenate(xs) if pkg is wf else torch.cat(xs)


def _maximum(pkg):
    return jnp.maximum if pkg is wf else torch.maximum


def _where(pkg):
    return jnp.where if pkg is wf else torch.where


def _rec_src(pkg, cap=8, fields=None, name="src"):
    fields = fields or {"k": np.int32(0), "v": np.float32(0.0)}

    def gen():
        return iter({"k": i % 2, "v": float(i)} for i in range(4))

    return (pkg.Source_Builder(gen).withOutputBatchSize(cap)
            .withRecordSpec(fields).withName(name).build())


def _empty_src(pkg, cap=0, name="src", ts=False):
    b = pkg.Source_Builder(lambda: iter([])).withName(name)
    if cap:
        b = b.withOutputBatchSize(cap)
    if ts:
        b = b.withTimestampExtractor(lambda t: t["ts"])
    return b.build()


def _sink(pkg, acc=None, name="snk"):
    if acc is None:
        return pkg.Sink_Builder(lambda r: None).withName(name).build()
    return pkg.Sink_Builder(
        lambda r: acc.append(r) if r is not None else None) \
        .withName(name).build()


def _window(pkg, win=(4, 2), name="w", tb=False, lateness=0, keys=2,
            comb=None, monoid=None):
    b = _dev(pkg, "Ffat_Windows")(lambda t: t["v"],
                                  comb or (lambda a, b: a + b))
    b = b.withTBWindows(*win) if tb else b.withCBWindows(*win)
    if lateness:
        b = b.withLateness(lateness)
    b = b.withKeyBy(lambda t: t["k"]).withMaxKeys(keys).withName(name)
    if monoid:
        b = b.withMonoidCombiner(monoid)
    return b.build()


def _window_op(pkg, spec_args, name="w"):
    """An FFAT window built directly from a WindowSpec (the builders
    refuse the specs WF201/WF204 name)."""
    if pkg is wt:
        from windflow_tpu_torch.windows.engine import WindowSpec
        from windflow_tpu_torch.windows.ffat_gpu import FfatWindowsGPU as W
    else:
        from windflow_tpu.windows.engine import WindowSpec
        from windflow_tpu.windows.ffat_tpu import FfatWindowsTPU as W
    win_type, *rest = spec_args
    return W(lambda t: t["v"], lambda a, b: a + b,
             WindowSpec(getattr(pkg.WinType, win_type), *rest), max_keys=2,
             name=name, key_extractor=lambda t: t["k"])


def findings(g):
    return sorted((d.code, d.severity, d.node or "") for d in g.check())


# ---------------------------------------------------------------------------
# the matrix: one builder per case, both packages
# ---------------------------------------------------------------------------

def case_wf101(pkg):
    g = _graph(pkg, "bad_chain")
    g.add_source(_rec_src(pkg)).add(
        _dev(pkg, "Map")(lambda t: dict(t)).withName("ok_map").build()) \
        .add(_dev(pkg, "Map")(lambda t: {"v": _cat(pkg, [t["v"], t["v"]])})
             .withName("bad_map").build()).add_sink(_sink(pkg))
    return g


def case_wf102(pkg):
    g = _graph(pkg, "bad_pred")
    g.add_source(_rec_src(pkg)).add(
        _dev(pkg, "Filter")(lambda t: t["v"]).withName("f").build()) \
        .add_sink(_sink(pkg))
    return g


def case_wf103(pkg):
    g = _graph(pkg, "bad_comb")
    g.add_source(_rec_src(pkg)).add(
        _dev(pkg, "Reduce")(lambda a, b: {"v": a["v"] + b["v"]})
        .withName("red").build()).add_sink(_sink(pkg))
    return g


def case_wf104(pkg):
    g = _graph(pkg, "bad_key")
    g.add_source(_rec_src(pkg)).add(
        _dev(pkg, "Reduce")(lambda a, b: {"k": a["k"],
                                          "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["v"]).withName("red").build()) \
        .add_sink(_sink(pkg))
    return g


def case_wf105(pkg):
    g = _graph(pkg, "bad_ffat")
    g.add_source(_rec_src(pkg)).add(
        _window(pkg, comb=lambda a, b: (a + b, a))).add_sink(_sink(pkg))
    return g


def case_wf106(pkg):
    g = _graph(pkg, "dtype_drift")
    merged = g.add_source(_rec_src(pkg, fields={"v": np.int32(0)},
                                   name="sa")).merge(
        g.add_source(_rec_src(pkg, fields={"v": np.float32(0)},
                              name="sb")))
    merged.add(_dev(pkg, "Map")(lambda t: {"v": t["v"] & 7})
               .withName("m").build())
    merged.add_sink(_sink(pkg))
    return g


def case_wf201(pkg):
    g = _graph(pkg, "win_zero")
    g.add_source(_empty_src(pkg, 8)).add(
        _window_op(pkg, ("CB", 0, 2))).add_sink(_sink(pkg))
    return g


def case_wf202(pkg):
    g = _graph(pkg, "bad_win")
    g.add_source(_empty_src(pkg, 8)).add(_window(pkg, win=(4, 8))) \
        .add_sink(_sink(pkg))
    return g


def case_wf203(pkg):
    g = _graph(pkg, "warn_win")
    g.add_source(_empty_src(pkg, 8)).add(
        _window(pkg, win=(8, 4), lateness=1000)).add_sink(_sink(pkg))
    return g


def case_wf204(pkg):
    g = _graph(pkg, "neg_late")
    g.add_source(_empty_src(pkg, 8)).add(
        _window_op(pkg, ("TB", 4000, 2000, -5))).add_sink(_sink(pkg))
    return g


def case_wf301(pkg):
    g = _graph(pkg, "after_sink")
    mp = g.add_source(_empty_src(pkg, 8))
    mp.add(_sink(pkg))
    # a keyed host operator: a device one after a sink (batch size 0)
    # is refused already at composition
    mp.add(pkg.Map_Builder(lambda t: t).withKeyBy(lambda t: t["k"])
           .withName("m").build())
    return g


def case_wf302(pkg):
    g = _graph(pkg, "no_sink")
    g.add_source(_empty_src(pkg)).add(
        pkg.Map_Builder(lambda t: t).withName("m").build())
    return g


def case_wf303(pkg):
    g = _graph(pkg, "keyby_no_key")
    op = pkg.Map_Builder(lambda t: t).withName("m").build()
    op.routing = pkg.RoutingMode.KEYBY
    g.add_source(_empty_src(pkg)).add(op).add_sink(_sink(pkg))
    return g


def case_wf304(pkg):
    g = _graph(pkg, "empty_merge")
    g.add_source(_empty_src(pkg, name="a")).merge(
        g.add_source(_empty_src(pkg, name="b")))
    return g


def case_wf403(pkg):
    def src(k, cap, name):
        return (pkg.Source_Builder(lambda: iter({"k": k, "v": float(i)}
                                                for i in range(8)))
                .withOutputBatchSize(cap).withName(name).build())
    g = _graph(pkg, "warn_cap")
    merged = g.add_source(src(0, 7, "s1")).merge(
        g.add_source(src(1, 4, "s2")))
    merged.add(_dev(pkg, "Map")(lambda t: dict(t)).withName("m").build())
    merged.add(_dev(pkg, "Reduce")(
        lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["k"]).withMaxKeys(2).withName("red").build())
    merged.add_sink(_sink(pkg))
    return g


def _bounded_reduce(pkg, declare):
    g = _graph(pkg, "kc_wf404", key_compaction=True)
    b = (_dev(pkg, "Reduce")(
        lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["k"]).withMaxKeys(8).withName("red"))
    if declare:
        b = b.withSumCombiner()
    g.add_source(_rec_src(pkg)).add(b.build()).add_sink(_sink(pkg))
    return g


def case_wf404(pkg):
    return _bounded_reduce(pkg, False)


def case_wf404_declared(pkg):
    return _bounded_reduce(pkg, True)


def _wf405(pkg, comb, monoid, fields=None):
    g = _graph(pkg, "kc_wf405", key_compaction=True)
    g.add_source(_rec_src(pkg, fields=fields)).add(
        _dev(pkg, "Reduce")(comb).withKeyBy(lambda t: t["k"])
        .withMonoidCombiner(monoid).withName("red").build()) \
        .add_sink(_sink(pkg))
    return g


def case_wf405_key_passthrough_sum(pkg):
    return _wf405(pkg, lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]},
                  "sum")


def case_wf405_key_passthrough_max(pkg):
    mx = _maximum(pkg)
    return _wf405(pkg, lambda a, b: {"k": a["k"], "v": mx(a["v"], b["v"])},
                  "max")


def case_wf405_wrong_kind(pkg):
    mx = _maximum(pkg)
    return _wf405(pkg, lambda a, b: {"k": a["k"] + b["k"],
                                     "v": mx(a["v"], b["v"])}, "sum")


def case_wf405_matching_max(pkg):
    mx = _maximum(pkg)
    return _wf405(pkg, lambda a, b: {"k": mx(a["k"], b["k"]),
                                     "v": mx(a["v"], b["v"])}, "max")


def case_wf405_matching_sum(pkg):
    return _wf405(pkg, lambda a, b: {"k": a["k"] + b["k"],
                                     "v": a["v"] + b["v"]}, "sum")


def case_wf405_where_inconclusive(pkg):
    wh = _where(pkg)
    return _wf405(pkg, lambda a, b: {"k": a["k"],
                                     "v": wh(a["v"] > b["v"], a["v"],
                                             b["v"])}, "max")


def case_wf405_key_into_value(pkg):
    mx = _maximum(pkg)
    return _wf405(pkg, lambda a, b: {"k": mx(a["k"], b["k"]), "v": a["k"]},
                  "max", fields={"k": np.int32(0), "v": np.int32(0)})


def case_wf502(pkg):
    g = _graph(pkg, "mix", tp="EVENT")
    merged = g.add_source(_empty_src(pkg, 8, "s1", ts=True)).merge(
        g.add_source(_empty_src(pkg, 8, "s2")))
    merged.add(_window(pkg, win=(1000, 1000), tb=True))
    merged.add_sink(_sink(pkg))
    return g


def case_wf503_past_merge(pkg):
    g = _graph(pkg, "mix2", tp="EVENT")
    merged = g.add_source(_empty_src(pkg, 8, "s1", ts=True)).merge(
        g.add_source(_empty_src(pkg, 8, "s2")))
    merged.add(pkg.Map_Builder(lambda t: t).withOutputBatchSize(8)
               .withName("m").build())
    merged.add(_window(pkg, win=(1000, 1000), tb=True))
    merged.add_sink(_sink(pkg))
    return g


def _durable(pkg, name, opaque=False):
    g = _graph(pkg, name, durability="/nonexistent/ck")
    src = (pkg.Source_Builder(lambda: iter([{"v": 1}]))
           .withOutputBatchSize(8).withName("src").build())
    m = pkg.Map_Builder(lambda t: t).withName("m").build()
    if opaque:
        m.checkpoint_opaque = True
    g.add_source(src).add(m).add_sink(_sink(pkg))
    return g


def case_wf601(pkg):
    return _durable(pkg, "p")


def case_wf603(pkg):
    return _durable(pkg, "p3", opaque=True)


def _wire(pkg, declared, **cfg):
    g = _graph(pkg, "wire", **cfg)
    src = _rec_src(pkg) if declared else _empty_src(pkg, 8)
    g.add_source(src).add(_dev(pkg, "Map")(lambda t: dict(t))
                          .withName("m").build()).add_sink(_sink(pkg))
    return g


def case_wf606(pkg):
    return _wire(pkg, False, wire_compression=True)


def case_wf606_declared(pkg):
    return _wire(pkg, True, wire_compression=True)


def case_wf606_off(pkg):
    return _wire(pkg, False, wire_compression=False)


def _forced_kernels(pkg, forced):
    mode = "1" if forced else "auto"
    if pkg is wt:
        cfg = {"device": "cuda", "cuda_kernels": mode}
    else:
        cfg = {"pallas_kernels": mode}
    g = _graph(pkg, "wf607", **cfg)
    g.add_source(_empty_src(pkg, 32)).add(_window(pkg, win=(8, 4),
                                                  keys=4)) \
        .add_sink(_sink(pkg))
    return g


def case_wf607(pkg):
    return _forced_kernels(pkg, True)


def case_wf607_auto(pkg):
    return _forced_kernels(pkg, False)


def _ms_source(pkg, spec=True):
    b = pkg.Source_Builder(lambda: iter(())).withOutputBatchSize(256) \
        .withName("src")
    if spec:
        b = b.withRecordSpec({"k": np.int32(0), "v": np.float32(0)})
    return b.build()


def _host_reduce(pkg):
    return (pkg.Reduce_Builder(
        lambda item, st: st.__setitem__("n", st.get("n", 0) + 1), dict)
        .withKeyBy(lambda t: t["k"]).withName("hred").build())


def case_wf608_eligible(pkg):
    g = _graph(pkg, "ok", megastep_sweeps=8)
    g.add_source(_ms_source(pkg)).add(_window(pkg, win=(64, 32), keys=8)) \
        .add_sink(_sink(pkg))
    return g


def case_wf608_host_tail(pkg):
    g = _graph(pkg, "host", megastep_sweeps=8)
    g.add_source(_ms_source(pkg)).add(_host_reduce(pkg)).add_sink(
        _sink(pkg))
    return g


def case_wf608_specless(pkg):
    g = _graph(pkg, "specless", megastep_sweeps=8)
    g.add_source(_ms_source(pkg, spec=False)).add(
        _window(pkg, win=(64, 32), keys=8)).add_sink(_sink(pkg))
    return g


def case_wf608_compacted(pkg):
    g = _graph(pkg, "compacted", megastep_sweeps=8, key_compaction=True)
    g.add_source(_ms_source(pkg)).add(
        _dev(pkg, "Reduce")(lambda a, b: {"k": a["k"] + b["k"],
                                          "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["k"]).withMaxKeys(8).withSumCombiner()
        .withName("red").build()).add_sink(_sink(pkg))
    return g


def case_wf608_auto(pkg):
    g = _graph(pkg, "auto", megastep_sweeps="auto")
    g.add_source(_ms_source(pkg)).add(_host_reduce(pkg)).add_sink(
        _sink(pkg))
    return g


def case_wf608_fused_prelude(pkg):
    g = _graph(pkg, "fused", megastep_sweeps=8)
    p = g.add_source(_ms_source(pkg))
    p.add(_dev(pkg, "Map")(lambda t: {"k": t["k"], "v": t["v"] * 2})
          .withName("m").build())
    p.chain(_dev(pkg, "Filter")(lambda t: (t["k"] & 1) == 0)
            .withName("f").build())
    p.add(_window(pkg, win=(64, 32), keys=8)).add_sink(_sink(pkg))
    return g


def case_tensor_closure_map(pkg):
    """A device map closing over a real array/tensor: a constant, as
    ``jax.eval_shape`` takes it (a meta-tensor evaluator would raise)."""
    lut = jnp.arange(10, dtype=jnp.float32) if pkg is wf \
        else torch.arange(10, dtype=torch.float32)
    g = _graph(pkg, "lut")
    g.add_source(_rec_src(pkg)).add(_dev(pkg, "Map")(
        lambda t: {"k": t["k"], "v": t["v"] * 2.0 + lut[t["k"] % 10]})
        .withName("m").build()).add_sink(_sink(pkg))
    return g


def case_clean_chain(pkg):
    g = _graph(pkg, "clean")
    g.add_source(_rec_src(pkg)).add(_dev(pkg, "Map")(
        lambda t: {"k": t["k"], "v": t["v"] * 2.0}).withName("m").build()) \
        .add(_window(pkg)).add_sink(_sink(pkg))
    return g


#: case -> the codes it must produce (in both packages)
CASES = {
    case_wf101: {"WF101"}, case_wf102: {"WF102"}, case_wf103: {"WF103"},
    case_wf104: {"WF104"}, case_wf105: {"WF105"}, case_wf106: {"WF106"},
    case_wf201: {"WF201"}, case_wf202: {"WF202"}, case_wf203: {"WF203"},
    case_wf204: {"WF204"}, case_wf301: {"WF301", "WF302"},
    case_wf302: {"WF302"}, case_wf303: {"WF303"}, case_wf304: {"WF304"},
    case_wf403: {"WF403", "WF404"}, case_wf404: {"WF404"},
    case_wf404_declared: {"WF405"},
    case_wf405_key_passthrough_sum: {"WF405"},
    case_wf405_key_passthrough_max: set(),
    case_wf405_wrong_kind: {"WF405"}, case_wf405_matching_max: set(),
    case_wf405_matching_sum: set(), case_wf405_where_inconclusive: set(),
    case_wf405_key_into_value: {"WF405"},
    case_wf502: {"WF501", "WF502", "WF503"},
    case_wf503_past_merge: {"WF501", "WF502", "WF503"},
    case_wf601: {"WF601"}, case_wf603: {"WF601", "WF603"},
    case_wf606: {"WF606"}, case_wf606_declared: set(),
    case_wf606_off: set(), case_wf607: {"WF607"}, case_wf607_auto: set(),
    case_wf608_eligible: set(), case_wf608_host_tail: {"WF608"},
    case_wf608_specless: {"WF608"}, case_wf608_compacted: {"WF608"},
    case_wf608_auto: set(), case_wf608_fused_prelude: set(),
    case_tensor_closure_map: set(), case_clean_chain: set(),
}


@pytest.mark.parametrize("case", list(CASES), ids=[c.__name__[5:]
                                                   for c in CASES])
def test_preflight_findings_equal_jax(case):
    got, want = findings(case(wt)), findings(case(wf))
    assert got == want
    assert {c for c, _, _ in got} == CASES[case]
    for code, sev, _ in got:
        assert CODES[code][0] == sev


def test_matrix_covers_the_listed_codes():
    covered = set().union(*CASES.values())
    listed = {f"WF{n}" for n in (101, 102, 103, 104, 105, 106, 201, 202,
                                 203, 204, 301, 302, 303, 304, 403, 404,
                                 405, 501, 502, 503, 601, 603, 606, 607,
                                 608)}
    assert listed <= covered


def test_wf101_names_the_operator_and_the_batch_shape():
    (d,) = [d for d in case_wf101(wt).check()]
    assert d.code == "WF101" and d.node == "bad_map"
    assert "elementwise" in d.message


def test_wf607_names_a_cpu_graph():
    """Forced kernels on a CPU graph: the plain twins run, no kernel
    builds, and the downgrade is named once for the graph."""
    g = _graph(wt, "wf607cpu", cuda_kernels="1")
    g.add_source(_empty_src(wt, 32)).add(_window(wt, win=(8, 4), keys=4,
                                                 monoid="sum")) \
        .add_sink(_sink(wt))
    (d,) = [d for d in g.check() if d.code == "WF607"]
    assert d.node is None and "CPU" in d.message


def test_wf606_verdict_equals_the_wire_walk():
    """WF606 names exactly the staging edges ``wire.attach_wire`` leaves
    raw: the spec-less one is raw in ``wire_section``, the declared one
    compresses."""
    from windflow_tpu_torch.wire import (iter_stage_emitters,
                                         known_input_specs)
    for declared in (False, True):
        g = case_wf606_declared(wt) if declared else case_wf606(wt)
        named = {d.node for d in g.check() if d.code == "WF606"}
        known = known_input_specs(g)
        ops = {op.name: op for op in g._topo_operators()}
        assert named == ({"m"} if not declared else set())
        assert known[id(ops["m"])] is declared
        g.run()
        assert [em._wire_on for _, _, em in iter_stage_emitters(g)] \
            == [declared]


def test_wf608_names_a_keyed_fanout_and_the_run_agrees():
    """A keyed window at parallelism 2 behind a forced K = 8: WF608 names
    the window, and the run forms no group on it."""
    g = _graph(wt, "fan", megastep_sweeps=8)
    w = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
         .withCBWindows(4, 2).withKeyBy(lambda t: t["k"]).withMaxKeys(2)
         .withParallelism(2).withName("w").build())
    acc = []
    g.add_source(_rec_src(wt)).add(w).add_sink(_sink(wt, acc))
    (d,) = [d for d in g.check() if d.code == "WF608"]
    assert d.node == "w"
    g.run()
    assert g.stats()["Megastep"]["edges"] == [] and acc


# ---------------------------------------------------------------------------
# start() and Config.preflight
# ---------------------------------------------------------------------------

def _two_fault_graph():
    g = _graph(wt, "two_faults")
    g.add_source(_rec_src(wt, name="s1")).add(
        wt.MapGPU_Builder(lambda t: {"v": torch.cat([t["v"], t["v"]])})
        .withName("m").build()).add_sink(_sink(wt, name="k1"))
    g.add_source(_rec_src(wt, name="s2")).add(
        wt.FilterGPU_Builder(lambda t: t["v"]).withName("f").build()) \
        .add_sink(_sink(wt, name="k2"))
    return g


def test_start_reports_all_violations_not_just_first():
    g = _two_fault_graph()
    with pytest.raises(PreflightError) as ei:
        g.start()
    err = ei.value
    assert sorted(d.code for d in err.diagnostics) == ["WF101", "WF102"]
    assert "WF101" in str(err) and "WF102" in str(err)
    assert isinstance(err, wt.WindFlowError)
    # refused before the build: no replica, no staging, no device
    assert g._all_replicas == [] and g.device is None


def test_preflight_warn_mode_warns_and_runs():
    acc = []
    g = _graph(wt, "warn_run", preflight="warn")
    g.add_source(_rec_src(wt)).add(
        _window(wt, win=(2, 1), lateness=5)).add_sink(_sink(wt, acc))
    with pytest.warns(PreflightWarning, match="WF203"):
        g.run()
    assert acc


def test_preflight_warn_mode_really_bypasses_capacity_backstop():
    g = case_wf403(wt)
    g.config.preflight = "warn"
    with pytest.warns(PreflightWarning, match="WF403"):
        g.start()
    g._finalize(dump=False)


def test_preflight_off_reaches_the_runtime_error():
    """preflight='off' skips the pass: the host read the checker names
    (WF101) raises from inside the step instead."""
    g = _graph(wt, "off_mode", preflight="off")
    g.add_source(_rec_src(wt)).add(
        wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"].item()})
        .build()).add_sink(_sink(wt))
    assert "WF101" in [d.code for d in g.check()]
    g2 = _graph(wt, "off_mode2", preflight="off")
    g2.add_source(_rec_src(wt)).add(
        wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"].item()})
        .build()).add_sink(_sink(wt))
    with pytest.raises(Exception) as ei:
        g2.run()
    assert not isinstance(ei.value, PreflightError)


def test_preflight_mode_is_validated_and_read_from_the_environment():
    g = _graph(wt, "bad_mode", preflight="loud")
    g.add_source(_rec_src(wt)).add_sink(_sink(wt))
    with pytest.raises(wt.WindFlowError, match="Config.preflight"):
        g.start()
    assert wt.Config().preflight == wf.default_config.preflight == "error"


def test_check_never_invokes_host_map_user_functions():
    calls = []

    def side_effectful(t):
        calls.append(t)
        return t

    g = _graph(wt, "host_pure")
    g.add_source(_rec_src(wt)).add(
        wt.Map_Builder(side_effectful).build()).add_sink(_sink(wt))
    assert g.check() == []
    assert calls == []


def test_clean_graph_zero_diagnostics_and_no_staging():
    g = case_clean_chain(wt)
    held = staging.pools_stats()["held_bytes"]
    before = staging.device_bytes.staged_batches_total
    assert g.check() == []
    assert g._all_replicas == []
    assert staging.device_bytes.staged_batches_total == before
    assert staging.pools_stats()["held_bytes"] == held
    assert g._preflight_ms is not None


def test_preflight_section_and_postmortem(tmp_path):
    g = case_clean_chain(wt)
    g.config.log_dir = str(tmp_path)
    g.run()
    sec = g.stats()["Preflight"]
    assert sec["mode"] == "error" and sec["diagnostics"] == []
    assert sec["check_ms"] > 0 and "kernel" in sec["passes"]
    d = g.dump_postmortem(str(tmp_path / "pm"))
    with open(os.path.join(d, "preflight.json")) as f:
        assert json.load(f)["passes"] == sec["passes"]
    off = _graph(wt, "off", preflight="off")
    off.add_source(_rec_src(wt)).add_sink(_sink(wt))
    off.run()
    assert off.stats()["Preflight"] == {"mode": "off", "check_ms": None,
                                        "diagnostics": None, "passes": []}


def test_failed_pass_becomes_wf800(monkeypatch):
    from windflow_tpu_torch.analysis import tracecheck

    def boom(graph):
        raise RuntimeError("verifier fault")
    monkeypatch.setattr(tracecheck, "verify_graph", boom)
    (d,) = case_clean_chain(wt).check()
    assert d.code == "WF800" and d.severity == "warning"
    assert "verifier fault" in d.message


# ---------------------------------------------------------------------------
# the code table and the exports
# ---------------------------------------------------------------------------

def test_code_table_equals_jax():
    from windflow_tpu.analysis import CODES as JCODES
    assert set(CODES) == set(JCODES)
    for code, (sev, desc) in CODES.items():
        assert JCODES[code][0] == sev, code
        assert code.startswith("WF") and code[2:].isdigit()
        assert "Pallas" not in desc and "TPU" not in desc, code
    d = wt.Diagnostic("WF101", "boom", node="x")
    assert d.severity == "error" and d.to_json()["code"] == "WF101"
    assert set(d.to_json()) == set(wf.Diagnostic("WF101", "b").to_json())
    assert "WF101" in str(d)


def test_analysis_exports_match_jax():
    import windflow_tpu.analysis as ja
    import windflow_tpu_torch.analysis as ta
    assert set(ta.__all__) == set(ja.__all__)
    assert ta.hot_path is wt.hot_path
    assert issubclass(wt.ConcurrencyViolation, wt.WindFlowError)
    assert issubclass(wt.PreflightError, wt.WindFlowError)
    assert issubclass(wt.PreflightWarning, UserWarning)


# ---------------------------------------------------------------------------
# tools/wf_lint.py over the port
# ---------------------------------------------------------------------------

def test_wf_lint_runs_clean_on_the_port():
    lint = _load_tool("wf_lint")
    findings_ = lint.lint_paths([os.path.join(REPO, "windflow_tpu_torch")])
    assert findings_ == [], findings_


def test_hot_path_marks_where_jax_has_them():
    from windflow_tpu_torch.analysis.hotpath import HOT_PATH_ATTR
    from windflow_tpu_torch.monitoring.jit_registry import StepWatch
    from windflow_tpu_torch.monitoring.latency_ledger import LatencyLedger
    from windflow_tpu_torch.monitoring.recorder import LatencyHistogram
    from windflow_tpu_torch.parallel import collectors, emitters
    marked = [staging.PackedBatchBuilder.append,
              staging.PackedBatchBuilder._append_impl,
              staging.PackedBatchBuilder.finish,
              staging.PackedBatchBuilder._finish_impl,
              emitters._OpenBatch.add, emitters.ForwardEmitter.emit,
              emitters.KeyByEmitter.emit,
              collectors.WatermarkCollector.on_message,
              LatencyHistogram.add, ReplicaRing.record,
              ReplicaRing._record_impl, StepWatch.note, StepWatch.note_step,
              LatencyLedger.harvest, LatencyLedger._remember_done,
              LatencyLedger._finalize]
    assert all(getattr(f, HOT_PATH_ATTR, False) for f in marked)


def test_wf_lint_seeded_violation_fixture(tmp_path):
    fixture = tmp_path / "seeded.py"
    fixture.write_text(textwrap.dedent("""\
        import threading
        import numpy as np
        from windflow_tpu_torch.analysis.hotpath import hot_path

        class Thing:
            __lock_guards__ = {"_lock": ("_state",)}

            def __init__(self):
                self._lock = threading.Lock()
                self._state = {}

            def bad_touch(self):
                self._state["x"] = 1

            @hot_path
            def hot(self, xs):
                buf = np.zeros(4)
                ys = [x for x in xs]
                np.asarray(xs)
                with self._lock:
                    pass
                return buf, ys

        def swallow():
            try:
                pass
            except Exception:
                pass
            try:
                pass
            except:
                pass
    """))
    lint = _load_tool("wf_lint")
    got = sorted(f["code"] for f in lint.lint_paths([str(fixture)]))
    assert got == ["WF701", "WF701", "WF702", "WF703", "WF711",
                   "WF712", "WF721"]


# ---------------------------------------------------------------------------
# the check CLI
# ---------------------------------------------------------------------------

APP = """\
import numpy as np
import torch
import windflow_tpu_torch as wt

def make_graph():
    src = (wt.Source_Builder(lambda: iter([])).withOutputBatchSize(8)
           .withRecordSpec({"v": np.float32(0)}).build())
    g = wt.PipeGraph("demo_broken", config=wt.Config(device="cpu"))
    g.add_source(src).add(wt.MapGPU_Builder(
        lambda t: {"v": torch.cat([t["v"], t["v"]])}).build()).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    return g
"""


def test_check_cli_json_on_broken_app(tmp_path, monkeypatch, capsys):
    from windflow_tpu_torch.analysis import check
    (tmp_path / "wtcheck_demo_app.py").write_text(APP)
    monkeypatch.syspath_prepend(str(tmp_path))
    rc = check.main(["wtcheck_demo_app", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert out["errors"] == 1 and out["graph"] == "demo_broken"
    assert out["diagnostics"][0]["code"] == "WF101"
    assert out["check_ms"] is not None
    assert set(out["diagnostics"][0]) == {"code", "severity", "message",
                                          "node", "location", "hint"}
    assert check.main(["wtcheck_demo_app:nothing"]) == 2


# ---------------------------------------------------------------------------
# the race detector (WF_TPU_DEBUG_CONCURRENCY)
# ---------------------------------------------------------------------------

@pytest.fixture
def debug_mode():
    dbg.set_enabled(True)
    try:
        yield
    finally:
        dbg.set_enabled(False)


def _in_thread(fn):
    caught = []

    def run():
        try:
            fn()
        except wt.ConcurrencyViolation as e:
            caught.append(e)

    t = threading.Thread(target=run, name="attacker")
    t.start()
    t.join()
    return caught


def test_cross_thread_staging_pool_mutation_is_caught(debug_mode):
    pool = staging.StagingPool(depth=2)
    pool.release(np.empty(64, np.uint32))      # the locked path: fine
    caught = _in_thread(lambda: pool._slots.__setitem__(999, "raced"))
    assert len(caught) == 1 and "StagingPool._slots" in str(caught[0])
    assert 999 not in pool._slots
    assert pool.acquire(64).shape == (64,)     # the locked API still works


def test_cross_thread_slot_deque_mutation_is_caught(debug_mode):
    pool = staging.StagingPool(depth=4)
    pool.release(np.empty(64, np.uint32))
    caught = _in_thread(
        lambda: pool._slots[64].append((np.empty(64, np.uint32), None)))
    assert len(caught) == 1 and "slot deque" in str(caught[0])


def test_flag_off_pool_mutation_not_caught():
    assert not dbg.ENABLED
    pool = staging.StagingPool(depth=2)
    pool._slots[999] = "unchecked"     # a plain dict when the flag is off
    assert type(pool._slots) is dict and pool._slots[999] == "unchecked"


def test_entry_guard_catches_overlapping_ring_writes(debug_mode):
    ring = ReplicaRing("op", 0, 64)
    dbg.enter(ring, "ReplicaRing.record")      # main thread mid-write
    caught = _in_thread(lambda: ring.record(1, 0, 123))
    dbg.exit_(ring)
    assert len(caught) == 1 and "single-consumer" in str(caught[0])
    ring.record(1, 0, 123)                     # sequential use stays fine
    assert ring.n == 1


def test_builder_cross_thread_append_is_caught(debug_mode):
    b = staging.PackedBatchBuilder([np.float32], 8)
    dbg.enter(b, "PackedBatchBuilder.append")
    caught = _in_thread(lambda: b.append([np.ones(2, np.float32)],
                                         np.arange(2, dtype=np.int64)))
    dbg.exit_(b)
    assert len(caught) == 1
    b.abandon()


def test_cross_thread_drain_is_caught(debug_mode):
    from windflow_tpu_torch.ops.map_op import Map
    op = Map(lambda t: t, name="m")
    rep = op.build_replicas(wt.ExecutionMode.DEFAULT,
                            wt.TimePolicy.INGRESS)[0]
    dbg.enter(rep, "Replica.drain")
    caught = _in_thread(lambda: rep.drain())
    dbg.exit_(rep)
    assert len(caught) == 1 and "Replica.drain" in str(caught[0])


def test_cross_thread_dispatch_is_caught(debug_mode):
    from windflow_tpu_torch.batch import HostBatch
    from windflow_tpu_torch.ops.map_op import Map
    op = Map(lambda t: t, name="m")
    rep = op.build_replicas(wt.ExecutionMode.DEFAULT,
                            wt.TimePolicy.INGRESS)[0]
    dbg.enter(rep.stats, "Replica._dispatch")
    caught = _in_thread(lambda: rep._dispatch(HostBatch([], [], 0)))
    dbg.exit_(rep.stats)
    assert len(caught) == 1 and "Replica._dispatch" in str(caught[0])


def test_debug_guard_is_exception_safe(debug_mode):
    from windflow_tpu_torch.batch import HostBatch
    from windflow_tpu_torch.ops.map_op import Map

    class Boom(RuntimeError):
        pass

    def explode(t):
        raise Boom()

    op = Map(explode, name="m")
    rep = op.build_replicas(wt.ExecutionMode.DEFAULT,
                            wt.TimePolicy.INGRESS)[0]
    with pytest.raises(Boom):
        rep._dispatch(HostBatch([{"v": 1}], [0], 0))
    # the raise left no stale dispatch guard: another thread's dispatch
    # (an empty batch) enters it cleanly
    assert _in_thread(lambda: rep._dispatch(HostBatch([], [], 0))) == []


def test_pipeline_runs_clean_under_debug_flag(debug_mode):
    """No false positive: a graph with staging, a device map and a window
    completes under the detector, its records equal to the flag-off
    run's."""
    def run():
        acc = []
        g = _graph(wt, "dbg_run")
        src = (wt.Source_Builder(
            lambda: iter({"k": i % 2, "v": np.float32(i)}
                         for i in range(64)))
            .withOutputBatchSize(16)
            .withRecordSpec({"k": np.int32(0), "v": np.float32(0)})
            .build())
        g.add_source(src).add(
            wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] + 1.0})
            .build()).add(_window(wt)).add_sink(_sink(wt, acc))
        g.run()
        return sorted((r["key"], r["wid"], float(r["value"])) for r in acc)
    on = run()
    dbg.set_enabled(False)
    assert on and on == run()


def test_debug_flag_off_path_is_one_flag_check(monkeypatch):
    """Structural, not timed: with the flag off no guard is entered and
    no checked container is built."""
    assert not dbg.ENABLED

    def forbidden(*a, **k):
        raise AssertionError("a debug hook ran with the flag off")
    for name in ("enter", "exit_", "entry_guard", "DebugLock",
                 "LockCheckedDict", "LockCheckedDeque"):
        monkeypatch.setattr(dbg, name, forbidden)
    ring = ReplicaRing("op", 0, 64)
    ring.record(1, 0, 5)
    pool = staging.StagingPool(depth=2)
    pool.release(pool.acquire(16))
    b = staging.PackedBatchBuilder([np.float32], 8, pool=pool)
    b.append([np.ones(2, np.float32)], np.arange(2, dtype=np.int64))
    b.finish()
    acc = []
    g = _graph(wt, "off_path")
    g.add_source(_rec_src(wt)).add(_sink(wt, acc))
    g.run()
    assert ring.n == 1 and len(acc) == 4


# ---------------------------------------------------------------------------
# the advisors and the ledgers' spec walk
# ---------------------------------------------------------------------------

def _fusion_graph(pkg):
    g = _graph(pkg, "fuse", whole_chain_fusion=False)
    p = g.add_source(_rec_src(pkg, cap=64))
    p.add(_dev(pkg, "Map")(lambda t: {"k": t["k"], "v": t["v"] * 2.0})
          .withName("m1").build())
    p.add(_dev(pkg, "Filter")(lambda t: t["k"] >= 0).withName("f").build())
    p.add(_dev(pkg, "Map")(lambda t: {"k": t["k"], "v": t["v"] + 1.0})
          .withName("m2").build())
    p.add(_window(pkg)).add_sink(_sink(pkg))
    return g


def test_fusion_plan_equals_jax():
    from windflow_tpu.analysis import fusion as jfusion
    from windflow_tpu_torch.analysis import fusion
    got = fusion.plan(_fusion_graph(wt))
    want = jfusion.plan(_fusion_graph(wf))
    assert got == want
    (chain,) = got["chains"]
    assert chain["ops"] == ["m1", "f", "m2", "w"]
    # (8 payload + 9 lane bytes) x 64 lanes, written and read, 3 times
    assert chain["projected_bytes_saved_per_batch"] == 2 * 17 * 64 * 3
    assert fusion.plan(_fusion_graph(wt), top=1) == got


def test_fusion_plan_reads_a_measured_sweep():
    from windflow_tpu_torch.analysis import fusion
    g = _fusion_graph(wt)
    g.run()
    p = fusion.plan(g, sweep=g.stats()["Sweep"])
    (chain,) = p["chains"]
    assert chain["basis"] == "measured"
    assert chain["dispatches_per_batch_now"] == pytest.approx(4.0, abs=0.5)


SHARD = {"enabled": True, "per_op": {
    "red": {"parallelism": 4, "lag_spread_usec": 10, "load": {
        "n_shards": 4, "placement": "splitmix", "basis": "exact",
        "total_tuples": 1000, "tuples": [700, 100, 100, 100],
        "imbalance_ratio": 2.8, "hot_shard": 0,
        "hot_keys": [{"key": 5, "shard": 0, "est_tuples": 400,
                      "share": 0.4},
                     {"key": 9, "shard": 0, "est_tuples": 200,
                      "share": 0.2},
                     {"key": 3, "shard": 0, "est_tuples": 60,
                      "share": 0.06}],
        "hot_key_share": 0.4}},
    "even": {"parallelism": 2, "load": {
        "n_shards": 2, "tuples": [50, 50], "imbalance_ratio": 1.0,
        "hot_keys": []}}}}


def test_resharding_plan_equals_jax():
    from windflow_tpu.analysis import resharding as jr
    from windflow_tpu_torch.analysis import resharding as tr
    assert tr.plan(SHARD, "g") == jr.plan(SHARD, "g")
    assert tr.imbalance(SHARD) == jr.imbalance(SHARD)
    row = tr.imbalance(SHARD)[0]
    assert tr.rebalance_actions(row) == jr.rebalance_actions(row)
    assert [a["kind"] for a in tr.plan(SHARD)["ops"][0]["actions"]] == \
        ["move_keys", "split_hot_key"]


def _skewed_graph(pkg):
    keys = [0] * 48 + [1, 2, 3] * 16

    def gen():
        return iter({"k": k, "v": np.float32(1.0)} for k in keys)
    g = _graph(pkg, "skew")
    src = (pkg.Source_Builder(gen).withOutputBatchSize(16)
           .withRecordSpec({"k": np.int32(0), "v": np.float32(0)})
           .withName("src").build())
    g.add_source(src).add(
        _dev(pkg, "Map")(lambda t: dict(t)).withName("m").build()).add(
        _dev(pkg, "Reduce")(lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["k"]).withParallelism(2).withName("red")
        .build()).add_sink(_sink(pkg))
    return g


def test_resharding_plan_over_a_live_shard_section():
    from windflow_tpu.analysis import resharding as jr
    from windflow_tpu_torch.analysis import resharding as tr
    g = _skewed_graph(wt)
    g.run()
    sec = g.stats()["Shard"]
    got = tr.plan(sec, g.name, threshold=1.0)
    assert got == jr.plan(sec, g.name, threshold=1.0)
    assert [o["op"] for o in got["ops"]] == ["red"]


def test_sweep_and_shard_ledgers_take_the_spec_walk():
    """The payload/overhead split of the sweep ledger and the shard
    ledger's record bytes come from the same spec walk as JAX's."""
    from windflow_tpu.monitoring.sweep_ledger import \
        LANE_BYTES_PER_TUPLE as JLANE
    from windflow_tpu_torch.monitoring.sweep_ledger import \
        LANE_BYTES_PER_TUPLE
    assert LANE_BYTES_PER_TUPLE == JLANE
    g, jg = _skewed_graph(wt), _skewed_graph(wf)
    g.run()
    jg.run()
    hop = g.stats()["Sweep"]["per_hop"]
    jhop = jg.stats()["Sweep"]["per_hop"]
    for name in ("m", "red"):
        assert hop[name]["payload_bytes_per_tuple"] == \
            jhop[name]["payload_bytes_per_tuple"] == 8 + JLANE
        assert hop[name]["overhead_bytes_per_tuple"] == pytest.approx(
            hop[name]["bytes_per_tuple"] - hop[name]
            ["payload_bytes_per_tuple"], abs=0.01)
    shard = g.stats()["Shard"]["per_op"]
    jstat = jg._shard._compute_statics()
    for op in jg._operators:
        bpt = jstat[id(op)]["bpt"]
        got = shard[op.name].get("record_bytes_per_tuple")
        assert got == (bpt + JLANE if bpt is not None else None), op.name


def test_plans_and_check_run_without_jax_in_a_subprocess(tmp_path):
    """The analysis plane needs no JAX: the CLI runs where it is not
    importable."""
    import subprocess
    import sys
    (tmp_path / "wtcli_app.py").write_text(APP)
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['windflow_tpu'] = None; "
            "from windflow_tpu_torch.analysis import check; "
            "sys.exit(check.main(['wtcli_app', '--json']))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 1, out.stderr
    assert json.loads(out.stdout)["diagnostics"][0]["code"] == "WF101"


def test_check_warns_nothing_on_a_clean_graph():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g = case_clean_chain(wt)
        g.run()
