"""The capture audit (``windflow_tpu_torch/analysis/ir_audit.py``) held
against the JAX package's wfir (``tests/test_ir_audit.py``): each
WF902-WF907 rule on a seeded fact record and its clean twin, the same
rules on facts the recorder takes from real steps (on the CPU) and from
the dry pass (fake CUDA tensors), the stats/postmortem/check() wiring
against the JAX package's keys, the ``python -m
windflow_tpu_torch.analysis.ir`` round trip, the no-extra-step pin, the
kill switch and the recording-failure warning.

WF901 reads the collectives a mesh step records (``parallel/mesh.py``);
its three JAX tests are twinned below on an 8-position CPU mesh against
JAX's 8 virtual devices.

Not applicable to the port, by the JAX test they twin:

* ``test_real_lowering_donation_markers`` and
  ``test_wf905_static_and_runtime_donation_miss_cross_validate``: they
  read XLA's input-output aliasing of donated operands and the sweep
  ledger's donation-miss bytes; torch steps donate nothing, and that
  ledger column is ``None`` in the port.  WF905 itself is not
  applicable there: the port's steps carry their state functionally, so
  a step that rebinds its state audits clean (tested below).
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.analysis import ir_audit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CAP = 256
N = 8 * CAP

#: the JAX tests with no port fact, by name (see the module docstring)
NOT_APPLICABLE = {
    "test_real_lowering_donation_markers": "XLA buffer donation",
    "test_wf905_static_and_runtime_donation_miss_cross_validate":
        "XLA buffer donation",
}


def _spec():
    return {"key": np.int32(0), "v": np.float32(0.0)}


def _source(name="ira_src", n=N, cap=CAP):
    return (wt.Source_Builder(
        lambda: iter({"key": np.int32(i % 8), "v": np.float32(i)}
                     for i in range(n)))
        .withName(name).withOutputBatchSize(cap)
        .withRecordSpec(_spec()).build())


def _map_graph(app, map_name, src_name, fn=None, **cfg):
    fn = fn or (lambda t: {"key": t["key"], "v": t["v"] * 2.0})
    m = wt.MapGPU_Builder(fn).withName(map_name).build()
    snk = wt.Sink_Builder(lambda r: None).withName("snk").build()
    g = wt.PipeGraph(app, wt.ExecutionMode.DEFAULT,
                     config=wt.Config(device="cpu", **cfg))
    g.add_source(_source(src_name)).add(m).add_sink(snk)
    return g


@pytest.fixture(scope="module")
def run_graph():
    g = _map_graph("ira_app", "ira_ma", "ira_src_shared")
    g.run()
    return g


def _codes(findings):
    return sorted({d.code for d in findings})


def _facts(**kw):
    base = {"kind": "step", "backend": "cuda", "aten_ops": 4, "ops": [],
            "crossings": [], "host_ops": [], "wide_dtypes": [],
            "dynamic": [], "host_reads": [], "syncs": [], "exempt": [],
            "collectives": [],
            "kernels_resolved": True, "kernel_gates": {},
            "launches_by_kernel": {}, "kernel_launches": 0}
    base.update(kw)
    return base


def _recorded(g, name):
    """The one recorded program of operator ``name`` of a run graph."""
    op = next(o for o in g._topo_operators() if o.name == name)
    (facts,) = [f for sigs in op._audit_programs.values()
                for f in sigs.values()]
    return facts


# ---------------------------------------------------------------------------
# the rules on seeded facts, and on facts the recorder takes
# ---------------------------------------------------------------------------

def test_not_applicable_tests_name_real_jax_tests():
    src = open(os.path.join(REPO, "tests", "test_ir_audit.py")).read()
    for name in NOT_APPLICABLE:
        assert f"def {name}(" in src, name


def test_wf902_crossing_fixture_and_clean_twin():
    f = _facts(crossings=["aten._to_copy (to host) @ x.py:1 (fn)"])
    assert _codes(ir_audit.program_findings("p", f)) == ["WF902"]
    f = _facts(host_ops=["aten.add (on host tensors) @ x.py:1 (fn)"])
    assert _codes(ir_audit.program_findings("p", f)) == ["WF902"]
    assert ir_audit.program_findings("p", _facts()) == []
    # the CPU backend runs on host tensors by design
    cpu = _facts(backend="cpu", host_ops=["aten.add (on host tensors)"])
    assert ir_audit.program_findings("p", cpu) == []


def test_wf903_wide_dtype_fixture_and_clean_twin():
    f = _facts(wide_dtypes=["f64"])
    assert _codes(ir_audit.program_findings("p", f)) == ["WF903"]
    assert ir_audit.program_findings("p", _facts(
        backend="cpu", wide_dtypes=["f64"])) == []
    # a real CPU step widening to float64: the fact is taken, and reads
    # as WF903 on the cuda backend only; int64 lanes are never wide
    g = _map_graph("ira_wide", "ira_wide_m", "ira_wide_src",
                   fn=lambda t: {"key": t["key"].long(),
                                 "v": t["v"].double()})
    g.run()
    facts = _recorded(g, "ira_wide_m")
    assert facts["wide_dtypes"] == ["f64"] and facts["backend"] == "cpu"
    assert ir_audit.program_findings("p", facts) == []
    assert _codes(ir_audit.program_findings(
        "p", dict(facts, backend="cuda"))) == ["WF903"]


def test_wf904_dynamic_fixture_and_real_step():
    f = _facts(dynamic=["aten.nonzero @ x.py:1 (fn)"])
    assert _codes(ir_audit.program_findings("p", f)) == ["WF904"]
    g = _map_graph("ira_dyn", "ira_dyn_m", "ira_dyn_src",
                   preflight="off",
                   fn=lambda t: {"key": t["key"],
                                 "v": t["v"] + t["v"][t["v"] > 3].sum()})
    g.run()
    facts = _recorded(g, "ira_dyn_m")
    assert any("bool mask" in d for d in facts["dynamic"])
    assert [f["code"] for f in g.stats()["IR_audit"]["findings"]] == [
        "WF904"]


class _RebindingMap(wt.MapGPU):
    """A device map carrying a counter; ``rebind`` replaces the tensor
    each step (the port's functional carry), else it updates in place."""

    def __init__(self, rebind):
        super().__init__(lambda t: t, name="ira_carry")
        self.rebind = rebind
        self.count = torch.zeros(4, dtype=torch.int64)

    def _step(self, batch):
        if self.rebind:
            self.count = self.count + 1
        else:
            self.count.add_(1)
        return super()._step(batch)


@pytest.mark.parametrize("rebind", [True, False])
def test_wf905_inplace_carry_rebound_and_its_twin(rebind):
    op = _RebindingMap(rebind)
    g = wt.PipeGraph(f"ira_carry_{rebind}",
                     config=wt.Config(device="cpu"))
    g.add_source(_source("ira_carry_src")).add(op).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    g.run()
    sec = g.stats()["IR_audit"]
    # WF905 is not applicable in the port: no carry is donated, so a
    # rebound state and an in-place one both audit clean
    assert sec["findings"] == [] and sec["programs_audited"] == 1
    assert int(op.count[0]) == N // CAP


def test_wf906_host_read_fixture_and_real_step():
    f = _facts(host_reads=["aten._local_scalar_dense @ x.py:1 (fn)"])
    assert _codes(ir_audit.program_findings("p", f)) == ["WF906"]
    assert _codes(ir_audit.program_findings(
        "p", _facts(syncs=["cuda sync @ x.py:1 (fn)"]))) == ["WF906"]
    g = _map_graph("ira_item", "ira_item_m", "ira_item_src",
                   preflight="off",
                   fn=lambda t: {"key": t["key"],
                                 "v": t["v"] * float(t["v"].sum().item())})
    g.run()
    (f,) = g.stats()["IR_audit"]["findings"]
    assert f["code"] == "WF906" and f["severity"] == "warning"
    assert "test_torch_ir_audit.py" in f["message"]


def test_sanctioned_host_reads_are_exempt_by_name():
    """A read through a function of the sanctioned table is listed with
    its reason, not a finding; the table names functions that exist."""
    import importlib
    for (mod, qual), reason in ir_audit.SANCTIONED_HOST_READS.items():
        m = importlib.import_module(
            "windflow_tpu_torch." + mod[:-3].replace("/", "."))
        obj = m
        for part in qual.split(".<locals>.")[0].split("."):
            obj = getattr(obj, part)
        assert callable(obj) and reason, (mod, qual)
    g = wt.PipeGraph("ira_tb", time_policy=wt.TimePolicy.EVENT,
                     config=wt.Config(device="cpu"))
    g.add_source(wt.Source_Builder(
        lambda: iter({"key": np.int32(i % 8), "v": np.float32(i),
                      "ts": np.int64(i * 10)} for i in range(N)))
        .withTimestampExtractor(lambda t: t["ts"]).withOutputBatchSize(CAP)
        .withRecordSpec({"key": np.int32(0), "v": np.float32(0.0),
                         "ts": np.int64(0)}).build()) \
        .add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                        lambda a, b: a + b)
             .withTBWindows(1000, 500).withKeyBy(lambda t: t["key"])
             .withMaxKeys(8).build()) \
        .add_sink(wt.Sink_Builder(lambda r: None).build())
    g.run()
    sec = g.stats()["IR_audit"]
    assert sec["findings"] == []
    assert sec["exempt_host_reads"] and all(
        e["reason"] in ir_audit.SANCTIONED_HOST_READS.values()
        for e in sec["exempt_host_reads"])


def test_wf907_kernel_fixture_and_clean_twins():
    gates = {"grouping_rank_hist": 2}
    f = _facts(kernel_gates=gates)
    assert _codes(ir_audit.program_findings("p", f)) == ["WF907"]
    assert ir_audit.program_findings(
        "p", _facts(kernel_gates=gates,
                    launches_by_kernel={"grouping_rank_hist": 2},
                    kernel_launches=2)) == []
    assert ir_audit.program_findings(
        "p", _facts(kernel_gates=gates, kernels_resolved=False)) == []
    assert ir_audit.program_findings(
        "p", _facts(backend="cpu", kernel_gates=gates)) == []
    assert ir_audit.program_findings(
        "p", _facts(kernel_gates={})) == []


def test_wf907_is_held_per_kernel():
    """The sum-combiner step's shape: the grouping kernel launched while
    the fold's gate held and the fold ran its plain version.  The step's
    total launches are not zero, and it is WF907 for the fold."""
    f = _facts(kernel_gates={"grouping_rank_hist": 2, "sliding_fold": 1},
               launches_by_kernel={"grouping_rank_hist": 1},
               kernel_launches=1)
    (d,) = ir_audit.program_findings("p", f)
    assert d.code == "WF907" and "sliding_fold" in d.message
    assert "grouping_rank_hist" not in d.message
    f["launches_by_kernel"]["sliding_fold"] = 1
    assert ir_audit.program_findings("p", f) == []


def test_wf907_names_a_plain_wavefront_on_the_card():
    """The stateful wavefront's gate is its route: with the kernels on,
    a step on the card takes the device loop and launches
    ``wavefront_loop``.  A recorded CUDA step whose wavefront gate held
    and that launched no loop ran the plain host loop: WF907 for it;
    the same facts with the launch, with the kernels off, or on the CPU
    are clean.  On the CPU a real dense wavefront step counts the gate
    and no launch."""
    f = _facts(kernel_gates={"wavefront_loop": 1})
    (d,) = ir_audit.program_findings("p", f)
    assert d.code == "WF907" and "wavefront_loop" in d.message
    assert ir_audit.program_findings("p", _facts(
        kernel_gates={"wavefront_loop": 1},
        launches_by_kernel={"wavefront_loop": 1}, kernel_launches=1)) == []
    assert ir_audit.program_findings("p", _facts(
        kernel_gates={"wavefront_loop": 1}, kernels_resolved=False)) == []
    assert ir_audit.program_findings("p", _facts(
        backend="cpu", kernel_gates={"wavefront_loop": 1})) == []
    g = wt.PipeGraph("ira_wave", config=wt.Config(device="cpu"))
    g.add_source(_source("ira_wave_src")).add(
        wt.MapGPU_Builder(lambda t, s: ({"key": t["key"], "v": t["v"] + s},
                                        s + t["v"]))
        .withInitialState(np.float32(0)).withKeyBy(lambda t: t["key"])
        .withNumKeySlots(8).withDenseKeys().withName("ira_wave_m").build()
    ).add_sink(wt.Sink_Builder(lambda r: None).build())
    g.run()
    facts = _recorded(g, "ira_wave_m")
    assert facts["kernel_gates"]["wavefront_loop"] >= 1
    assert "wavefront_loop" not in facts["launches_by_kernel"]
    assert g.stats()["IR_audit"]["findings"] == []


def test_table_gate_counts_only_where_a_launch_follows():
    """The reduce front door checks its leaves before the slot gate: a
    payload with no leaf the table kernel takes keeps its torch scatters
    and counts no gate (else WF907 would name a kernel that had no work
    to do)."""
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import reduce_cuda as rc
    row = torch.zeros(8, dtype=torch.int32)
    before = fc.gates_open()
    assert rc.routed_monoid_tables(
        row, {"v": torch.zeros(8, dtype=torch.float64)}, "sum", 4,
        lambda leaf: leaf) is None
    assert fc.gates_open() == before
    assert rc.routed_monoid_tables(
        row, {"v": torch.ones(8)}, "sum", 4, lambda leaf: leaf) is not None
    after = fc.gates_open()
    assert after["dense_monoid_table"] == before["dense_monoid_table"] + 1


def test_wf907_facts_of_a_real_cpu_window_step():
    """A count-window step on the CPU passes the grouping gate (its
    wrappers take their plain versions there): the gate is counted, no
    launch is, and the CPU backend makes it no finding."""
    g = wt.PipeGraph("ira_cb", config=wt.Config(device="cpu"))
    g.add_source(_source("ira_cb_src")).add(
        wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
        .withCBWindows(16, 4).withKeyBy(lambda t: t["key"]).withMaxKeys(8)
        .withName("ira_cb_w").build()).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    g.run()
    facts = _recorded(g, "ira_cb_w")
    assert facts["kernels_resolved"] \
        and facts["kernel_gates"]["grouping_rank_hist"] > 0
    assert facts["kernel_launches"] == 0 \
        and facts["launches_by_kernel"] == {}
    assert ir_audit.program_findings("ira_cb_w", facts) == []


def test_dry_pass_records_crossings_on_fake_cuda_tensors():
    """Twin of the JAX test's real host-callback lowering: a device
    function that takes its values to the host (``.cpu()``) records a
    crossing on fake CUDA tensors, with no device, and reads as WF902;
    so does the JAX package's ``pure_callback`` on the JAX side."""
    g = wt.PipeGraph("ira_cross", config=wt.Config(device="cuda"))
    g.add_source(wt.Source_Builder(lambda: iter(())).withOutputBatchSize(64)
                 .withRecordSpec(_spec()).build()).add(
        wt.MapGPU_Builder(
            lambda t: {"key": t["key"], "v": t["v"].cpu() * 2.0})
        .withName("ira_cross_m").build()).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    rep = ir_audit.audit_graph(g)
    assert rep.dry_lowered == 1
    assert _codes(rep.findings) == ["WF902"]


# ---------------------------------------------------------------------------
# graph-level wiring: audit_graph, stats, postmortem + wf_doctor
# ---------------------------------------------------------------------------

def test_run_graph_audits_clean(run_graph):
    report = ir_audit.audit_graph(run_graph, dry_lower=False)
    assert report.programs_audited >= 1
    assert report.findings == [] and report.pending == []
    assert "ira_ma" in report.op_names
    sec = run_graph.stats()["IR_audit"]
    assert sec["enabled"] is True
    assert sec["programs_audited"] >= 1 and sec["findings"] == []
    assert sec["programs"][0]["name"] == "ira_ma"
    json.dumps(sec)


def test_run_graph_section_has_the_jax_keys(run_graph):
    import windflow_tpu as wf
    jg = wf.PipeGraph("ira_app_jax", config=wf.Config())
    jg.add_source(wf.Source_Builder(
        lambda: iter({"key": np.int32(i % 8), "v": np.float32(i)}
                     for i in range(N))).withOutputBatchSize(CAP)
        .withRecordSpec(_spec()).build()).add(
        wf.MapTPU_Builder(lambda t: {"key": t["key"], "v": t["v"] * 2.0})
        .withName("ira_ma_jax").build()).add_sink(
        wf.Sink_Builder(lambda r: None).build())
    jg.run()
    jsec = jg.stats()["IR_audit"]
    sec = run_graph.stats()["IR_audit"]
    assert set(sec) == set(jsec) | {"programs", "exempt_host_reads"}
    assert sec["findings"] == jsec["findings"] == []


def _load_doctor():
    spec = importlib.util.spec_from_file_location(
        "wf_doctor", os.path.join(REPO, "tools", "wf_doctor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_postmortem_ir_audit_section_roundtrips_wf_doctor(run_graph,
                                                          tmp_path):
    doctor = _load_doctor()
    d = run_graph.dump_postmortem(str(tmp_path / "bundle"),
                                  reason="wfir test")
    bundle = doctor.load_bundle(d)
    doctor.validate(bundle)
    sec = bundle["sections"]["ir_audit.json"]
    assert sec["enabled"] is True and sec["programs_audited"] >= 1
    diag = doctor.diagnose(bundle)
    assert diag["ir_audit"]["programs_audited"] >= 1
    assert "IR audit" in doctor.render_text(diag)
    path = os.path.join(d, "ir_audit.json")
    with open(path) as f:
        sec = json.load(f)
    sec["findings"] = [{"code": "OOPS"}]
    with open(path, "w") as f:
        json.dump(sec, f)
    with pytest.raises(doctor.BundleError):
        doctor.validate(doctor.load_bundle(d))


# ---------------------------------------------------------------------------
# preflight integration: check() folds the dry pass
# ---------------------------------------------------------------------------

def _read_kernel(t):
    return {"key": t["key"], "v": t["v"] * float(t["v"].sum().item())}


# the capture audit shares wfverify's inline suppression; the token on the
# def line below is the seeded fixture the suppression test reads
def _read_kernel_suppressed(t):  # wfverify: ok (seeded wfir suppression fixture)
    return {"key": t["key"], "v": t["v"] * float(t["v"].sum().item())}


def _unstarted_graph(app, fn, name):
    src = (wt.Source_Builder(lambda: iter(()))
           .withOutputBatchSize(64).withName(f"{name}_src")
           .withRecordSpec(_spec()).build())
    m = wt.MapGPU_Builder(fn).withName(name).build()
    g = wt.PipeGraph(app, config=wt.Config(device="cpu"))
    g.add_source(src).add(m).add_sink(wt.Sink_Builder(lambda r: None).build())
    return g


def test_preflight_check_folds_dry_pass():
    g = _unstarted_graph("ira_pf_rd", _read_kernel, "ira_pf_rd_map")
    ds = g.check()
    assert "WF906" in {d.code for d in ds}
    assert g._ir_audit_report.dry_lowered >= 1
    assert "ir_audit" in g.stats()["Preflight"]["passes"]
    g2 = _unstarted_graph(
        "ira_pf_clean",
        lambda t: {"key": t["key"], "v": t["v"] * 2.0}, "ira_pf_clean_m")
    ds2 = g2.check()
    assert {d.code for d in ds2} & {"WF901", "WF902", "WF903", "WF904",
                                    "WF905", "WF906", "WF907"} == set()
    assert g2._ir_audit_report.dry_lowered >= 1


def test_preflight_suppression_shares_wfverify_syntax():
    g = _unstarted_graph("ira_pf_sup", _read_kernel_suppressed,
                         "ira_pf_sup_map")
    ds = g.check()
    assert "WF906" not in {d.code for d in ds}
    assert g._ir_audit_report.suppressed >= 1


def test_failed_audit_pass_becomes_wf900(monkeypatch):
    def boom(graph, dry_lower=True):
        raise RuntimeError("seeded auditor fault")
    monkeypatch.setattr(ir_audit, "audit_graph", boom)
    g = _unstarted_graph("ira_pf_900", lambda t: t, "ira_pf_900_m")
    codes = {d.code for d in g.check()}
    assert "WF900" in codes


# ---------------------------------------------------------------------------
# CLI round trip (python -m windflow_tpu_torch.analysis.ir)
# ---------------------------------------------------------------------------

APP = """\
import numpy as np
import {pkg} as wf

def make_graph():
    src = (wf.Source_Builder(lambda: iter(()))
           .withOutputBatchSize(256).withName("cli_src")
           .withRecordSpec({{"key": np.int32(0), "v": np.float32(0.0)}})
           .build())
    m = (wf.{map}(lambda t: {{"key": t["key"], "v": t["v"] * 2.0}})
         .withName("cli_map").build())
    g = wf.PipeGraph("cli_clean"{cfg})
    g.add_source(src).add(m).add_sink(
        wf.Sink_Builder(lambda r: None).build())
    return g
"""

BAD_APP = """\
import numpy as np
import windflow_tpu_torch as wf

def _rd(t):
    return {"key": t["key"], "v": t["v"] * float(t["v"].sum().item())}

def make_graph():
    src = (wf.Source_Builder(lambda: iter(()))
           .withOutputBatchSize(256).withName("cli_bad_src")
           .withRecordSpec({"key": np.int32(0), "v": np.float32(0.0)})
           .build())
    m = wf.MapGPU_Builder(_rd).withName("cli_bad_map").build()
    g = wf.PipeGraph("cli_bad", config=wf.Config(device="cpu",
                                                  preflight="off"))
    g.add_source(src).add(m).add_sink(
        wf.Sink_Builder(lambda r: None).build())
    return g
"""


def _write_apps(tmp_path):
    (tmp_path / "cli_clean_app.py").write_text(APP.format(
        pkg="windflow_tpu_torch", map="MapGPU_Builder",
        cfg=', config=wf.Config(device="cpu")'))
    (tmp_path / "cli_bad_app.py").write_text(BAD_APP)
    (tmp_path / "cli_jax_app.py").write_text(APP.format(
        pkg="windflow_tpu", map="MapTPU_Builder", cfg=""))


def test_cli_json_strict_roundtrip(tmp_path):
    """``--drive`` runs the graphs, ``--json`` emits the JAX tool's
    per-app keys, ``--strict`` turns the seeded WF906 into exit 1 while
    the clean app audits 0 errors; ``WF_TPU_IR_AUDIT=0`` exits 2."""
    _write_apps(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))
    r = subprocess.run(
        [sys.executable, "-m", "windflow_tpu_torch.analysis.ir",
         "cli_clean_app", "cli_bad_app", "--drive", "512", "--json",
         "--strict"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 1, (r.stdout, r.stderr)
    out = json.loads(r.stdout)
    clean = out["cli_clean_app"]
    assert clean["graph"] == "cli_clean"
    assert clean["errors"] == 0 and clean["programs_audited"] >= 1
    assert [p["kind"] for p in clean["programs"]] == ["step"]
    bad = out["cli_bad_app"]
    assert bad["warnings"] >= 1
    assert "WF906" in {f["code"] for f in bad["findings"]}
    # the JAX tool's per-app keys, on the JAX twin of the clean app
    rj = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "wf_ir.py"),
         "cli_jax_app", "--json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert rj.returncode == 0, rj.stderr
    jout = json.loads(rj.stdout)["cli_jax_app"]
    assert set(clean) == set(jout) | {"programs", "exempt_host_reads"}
    # without --strict a warning alone exits 0, as the JAX tool does
    r1 = subprocess.run(
        [sys.executable, "-m", "windflow_tpu_torch.analysis.ir",
         "cli_bad_app", "--drive", "512"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r1.returncode == 0, r1.stderr
    r2 = subprocess.run(
        [sys.executable, "-m", "windflow_tpu_torch.analysis.ir",
         "cli_clean_app"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(env, WF_TPU_IR_AUDIT="0"))
    assert r2.returncode == 2
    assert "WF_TPU_IR_AUDIT=0" in r2.stderr
    r3 = subprocess.run(
        [sys.executable, "-m", "windflow_tpu_torch.analysis.ir",
         "no_such_app_module"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r3.returncode == 2


# ---------------------------------------------------------------------------
# no extra step + kill switch + recording-failure warning
# ---------------------------------------------------------------------------

def test_audit_performs_no_extra_step_or_capture(run_graph):
    """The audit reads what the run recorded: auditing (the dry pass
    included, on fake tensors) leaves every step count and the step
    registry's totals where they were."""
    from windflow_tpu_torch.monitoring.jit_registry import default_registry
    before = default_registry().totals()
    counts = default_registry().dispatch_counts()
    ir_audit.audit_graph(run_graph, dry_lower=False)
    ir_audit.audit_orphans(set())
    g = _unstarted_graph(
        "ira_zero_steps",
        lambda t: {"key": t["key"], "v": t["v"] * 2.0}, "ira_zs_map")
    rep = ir_audit.audit_graph(g, dry_lower=True)
    assert rep.dry_lowered >= 1
    assert default_registry().totals() == before
    assert default_registry().dispatch_counts() == counts


def test_kill_switch_leaves_nothing_recorded(monkeypatch):
    g = _map_graph("ira_kill_app", "ira_kill_ma", "ira_kill_src",
                   ir_audit=False)
    g.run()
    assert g.stats()["IR_audit"] == {"enabled": False}
    assert ir_audit.audit_graph(g).programs_audited == 0
    op = next(o for o in g._topo_operators() if o.name == "ira_kill_ma")
    assert "_audit_programs" not in op.__dict__
    # the first step's shadow is gone after one step either way
    assert "_op_step" not in op.replicas[0].__dict__
    # the process switch: recording and every report become no-ops
    monkeypatch.setattr(ir_audit, "ENABLED", False)
    ir_audit.record_program("ira_kill_never", ("sig",), {})
    assert "ira_kill_never" not in ir_audit.store_snapshot()
    assert ir_audit.audit_orphans(set()).programs_audited == 0
    g2 = _map_graph("ira_kill2", "ira_kill2_ma", "ira_kill2_src")
    g2.run()
    assert g2.stats()["IR_audit"] == {"enabled": False}


def test_recording_failure_warns_once_and_reports_pending(monkeypatch):
    def boom(op_name, sig, facts):
        raise RuntimeError("seeded recording failure")
    monkeypatch.setattr(ir_audit, "record_program", boom)
    g = _map_graph("ira_capfail_app", "ira_capfail_ma", "ira_capfail_src")
    g.config = dataclasses.replace(g.config, trace_sample_every=0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        g.run()
    mine = [str(x.message) for x in w
            if "recording 'ira_capfail_ma' failed" in str(x.message)]
    assert len(mine) == 1, mine
    assert "pending" in mine[0] and "RuntimeError" in mine[0]
    report = ir_audit.audit_graph(g, dry_lower=False)
    assert "ira_capfail_ma" in report.pending


# ---------------------------------------------------------------------------
# WF901: the mesh steps' collectives (parallel/mesh.py records them)
# ---------------------------------------------------------------------------

def _mesh_reduce_step_facts():
    """The facts the recorder takes from one unaligned dense mesh reduce
    step (its [K]-table pmax crosses the key axis)."""
    from windflow_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(8, data=2, devices=["cpu"] * 8)
    step = M.make_sharded_reduce_step(
        mesh, 64, 8, lambda a, b: {"k": torch.maximum(a["k"], b["k"])},
        lambda t: t["k"], monoid="max")
    rec = ir_audit._Recording("cpu")
    with rec, M.recording() as coll:
        step({"k": torch.arange(64, dtype=torch.int32) % 8},
             torch.zeros(64, dtype=torch.int64),
             torch.ones(64, dtype=torch.bool))
    rec.rec.collectives = coll
    return rec.facts("step", False), mesh


def test_wf901_collective_fixture_and_clean_twin():
    import ast

    import windflow_tpu.analysis.ir_audit as jir
    tree = ast.parse(open(os.path.join(REPO, "tests",
                                       "test_ir_audit.py")).read())
    gold = next(n.value.value for n in tree.body
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "GOLD_COLLECTIVE")
    facts, _ = _mesh_reduce_step_facts()
    assert "pmax" in facts["collectives"]
    for mod, f in ((ir_audit, facts), (jir, jir.extract_facts(gold))):
        assert _codes(mod.program_findings(
            "p", f, promised_collective_free=True)) == ["WF901"]
        assert _codes(mod.program_findings(
            "p", f, alignable_unaligned=True)) == ["WF901"]
        # no graph context: a collective is not a finding by itself
        assert mod.program_findings("p", f) == []
    clean = _facts(backend="cpu")
    assert ir_audit.program_findings(
        "p", clean, promised_collective_free=True) == []


def test_wf901_cross_key_classification():
    """Only non-scalar collectives across the key axis count: scalar
    counter psums and within-column data gathers are excluded, in both
    packages' classifications."""
    import windflow_tpu.analysis.ir_audit as jir
    from windflow_tpu.parallel import mesh as JM
    from windflow_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh(8, data=2, devices=["cpu"] * 8)
    jmesh = JM.make_mesh(8, data=2)
    kk = mesh.shape["key"]
    data_groups = [[d * kk + k for d in range(2)] for k in range(kk)]
    all_ids = list(range(8))
    jkey = {}
    for idx in np.ndindex(jmesh.devices.shape):
        jkey[idx[0] * kk + idx[1]] = int(jmesh.devices[idx].id)

    def facts_for(groups, numel):
        return {"collectives": ["all_gather"],
                "collective_ops": [{"op": "all_gather", "groups": groups,
                                    "numel": numel}]}

    def jfacts(groups, numel):
        g = None if groups is None else [[jkey[i] for i in grp]
                                         for grp in groups]
        return facts_for(g, numel)

    for groups, numel, want in (([all_ids], 16, ["all_gather"]),
                                (data_groups, 16, []),
                                ([all_ids], 1, []),
                                (None, 16, ["all_gather"])):
        assert ir_audit.cross_key_collectives(
            facts_for(groups, numel), mesh) == want
        assert jir.cross_key_collectives(
            jfacts(groups, numel), jmesh) == want
    # the records the mesh layer writes carry the verdict themselves
    with M.recording() as rec:
        grid = {p: torch.ones(4) for p in mesh.local_positions}
        M.all_gather(grid, mesh, M.DATA_AXIS)
        M.psum({p: torch.ones(()) for p in mesh.local_positions}, mesh,
               M.AXES)
        M.psum(grid, mesh, M.KEY_AXIS)
    f = {"collectives": sorted({r["op"] for r in rec}),
         "collective_ops": rec}
    assert ir_audit.cross_key_collectives(f, mesh) == ["psum"]
    # facts without the detail fall back to every collective
    assert ir_audit.cross_key_collectives(
        {"collectives": ["all_to_all"]}, mesh) == ["all_to_all"]


def _mesh_reduce_run(pkg, aligned, tag):
    import jax.numpy as jnp

    import windflow_tpu as wf
    if pkg is wt:
        from windflow_tpu_torch.parallel import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(8, data=1, devices=["cpu"] * 8)
        cfg = wt.Config(device="cpu", mesh=mesh,
                        key_aligned_ingest=aligned)
        mx = torch.maximum
        audit = ir_audit
    else:
        from windflow_tpu.analysis import ir_audit as audit
        from windflow_tpu.parallel import mesh as mesh_mod
        mesh = mesh_mod.make_mesh(8, data=1)
        cfg = dataclasses.replace(wf.default_config, mesh=mesh,
                                  key_aligned_ingest=aligned)
        mx = jnp.maximum
    kk = mesh.shape["key"]
    cap, K = 16 * 8, 4 * kk
    rng = np.random.default_rng(5)
    records = [{"key": int(k), "value": float(v)}
               for k, v in zip(rng.integers(0, K, 4 * cap),
                               rng.integers(0, 97, 4 * cap))]
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(cap).build())
    b = wt.ReduceGPU_Builder if pkg is wt else wf.ReduceTPU_Builder
    red = (b(lambda a, b: {"key": mx(a["key"], b["key"]),
                           "value": mx(a["value"], b["value"])})
           .withKeyBy(lambda t: t["key"]).withMaxKeys(K)
           .withMonoidCombiner("max").withName(f"ira_red_{tag}").build())
    g = pkg.PipeGraph(f"ira_mesh_{tag}", config=cfg)
    g.add_source(src).add(red).add_sink(
        pkg.Sink_Builder(lambda r: None).build())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    return red, audit.audit_graph(g, dry_lower=False)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_wf901_mesh_reduce_aligned_vs_unaligned_twin(pkg):
    """The aligned-ingest mesh reduce audits with no WF901 (its only
    cross-key collective is the scalar drop-count psum every layout
    keeps); the unaligned twin, whose [K]-table pmax rides the key
    axis, yields at least one."""
    import windflow_tpu as wf
    pk = wt if pkg == "port" else wf
    red_a, rep_a = _mesh_reduce_run(pk, True, f"a{pkg}")
    assert getattr(red_a, "_ingest_mode", None) == "aligned"
    assert [d for d in rep_a.findings if d.code == "WF901"] == []
    red_u, rep_u = _mesh_reduce_run(pk, False, f"u{pkg}")
    assert getattr(red_u, "_ingest_mode", None) is None
    wf901 = [d for d in rep_u.findings if d.code == "WF901"]
    assert len(wf901) >= 1
    assert "aligned ingest" in wf901[0].message
