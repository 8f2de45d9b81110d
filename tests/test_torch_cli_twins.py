"""The command-line twins of the JAX package's tools that import
``windflow_tpu``: ``python -m windflow_tpu_torch.analysis.verify``
(``tools/wf_verify.py``), ``...analysis.advisor``
(``tools/wf_advisor.py``) and ``...durability.chaos``
(``tools/wf_chaos.py``); ``...analysis.ir`` (``tools/wf_ir.py``) is held
in ``tests/test_torch_ir_audit.py``.  Each emits its JAX tool's JSON keys
and exit codes: 0 clean, 1 on findings (or any under ``--strict``), 2
when the application cannot be loaded."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

APP = """\
import numpy as np
import {pkg} as wf

def make_graph():
    src = (wf.Source_Builder(lambda: iter(()))
           .withOutputBatchSize(256).withName("cli_src")
           .withRecordSpec({{"key": np.int32(0), "v": np.float32(0.0)}})
           .build())
    g = wf.PipeGraph("cli_app"{cfg})
    g.add_source(src).add(
        wf.{dev}("Map")(lambda t: {{"key": t["key"], "v": t["v"] * 2.0}})
        .withName("m").build()).add(
        wf.{dev}("Filter")(lambda t: t["v"] > 1.0).withName("f").build()) \\
        .add_sink(wf.Sink_Builder(lambda r: None).build())
    return g

def host_graph():
    g = wf.PipeGraph("cli_host"{cfg})
    g.add_source(wf.Source_Builder(lambda: iter(())).withOutputBatchSize(8)
                 .build()).add(wf.Map_Builder(lambda t: t).build()) \\
        .add_sink(wf.Sink_Builder(lambda r: None).build())
    return g
"""

BAD = """\
import numpy as np
import windflow_tpu_torch as wf

def make_graph():
    src = (wf.Source_Builder(lambda: iter(()))
           .withOutputBatchSize(256)
           .withRecordSpec({"key": np.int32(0), "v": np.float32(0.0)})
           .build())
    g = wf.PipeGraph("cli_bad", config=wf.Config(device="cpu"))
    g.add_source(src).add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v": t["v"] * float(t["v"].sum().item())})
        .build()).add_sink(wf.Sink_Builder(lambda r: None).build())
    return g
"""


def _env(tmp_path):
    for pkg, name, dev, cfg in (
            ("windflow_tpu_torch", "port_app", "GPU", ', config=wf.Config('
             'device="cpu")'),
            ("windflow_tpu", "jax_app", "TPU", "")):
        (tmp_path / f"{name}.py").write_text(APP.format(
            pkg=pkg, cfg=cfg,
            dev=f"__dict__.get if False else (lambda n: getattr(wf, n + "
                f"'{dev}_Builder'))"))
    (tmp_path / "bad_app.py").write_text(BAD)
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join([str(tmp_path), REPO]))


def _port(env, mod, *args):
    return subprocess.run([sys.executable, "-m", mod, *args],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)


def _jax(env, tool, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", tool),
                           *args], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_verify_twin_json_keys_and_exit_codes(tmp_path):
    env = _env(tmp_path)
    mod = "windflow_tpu_torch.analysis.verify"
    r = _port(env, mod, "port_app", "bad_app", "--json", "--strict")
    assert r.returncode == 1, r.stderr
    out = json.loads(r.stdout)
    assert out["port_app"]["errors"] == 0 and out["port_app"]["graph"] \
        == "cli_app"
    assert out["bad_app"]["errors"] >= 1
    assert "WF801" in {d["code"] for d in out["bad_app"]["diagnostics"]}
    rj = _jax(env, "wf_verify.py", "jax_app", "--json", "--strict")
    assert rj.returncode == 0, rj.stderr
    # the port's report adds the donation family's verdict (not
    # applicable: torch steps donate no buffer)
    assert set(out["port_app"]) == set(json.loads(rj.stdout)["jax_app"]) \
        | {"donation"}
    assert _port(env, mod, "port_app", "--strict").returncode == 0
    assert _port(env, mod, "no_such_module").returncode == 2


def test_advisor_twin_json_keys_and_exit_codes(tmp_path):
    env = _env(tmp_path)
    mod = "windflow_tpu_torch.analysis.advisor"
    r = _port(env, mod, "port_app", "--json")
    assert r.returncode == 0, r.stderr
    plan = json.loads(r.stdout)
    assert [c["ops"] for c in plan["chains"]] == [["m", "f"]]
    rj = _jax(env, "wf_advisor.py", "jax_app", "--json")
    assert rj.returncode == 0, rj.stderr
    jplan = json.loads(rj.stdout)
    assert set(plan) == set(jplan)
    assert set(plan["chains"][0]) == set(jplan["chains"][0])
    assert [c["ops"] for c in jplan["chains"]] == [["m", "f"]]
    # no fusible chain: 1, as the JAX tool; a load failure: 2
    assert _port(env, mod, "port_app:host_graph").returncode == 1
    assert _jax(env, "wf_advisor.py", "jax_app:host_graph").returncode == 1
    assert _port(env, mod, "no_such_module").returncode == 2
    assert _port(env, mod, "port_app", "--stats",
                 str(tmp_path / "missing.json")).returncode == 2


def test_chaos_twin_json_keys_and_exit_codes(tmp_path):
    env = _env(tmp_path)
    args = ["--family", "reduce", "--point", "mid_epoch", "--fusion", "on",
            "--records", "2048", "--rescale", "off", "--json"]
    r = _port(env, "windflow_tpu_torch.durability.chaos", *args,
              "--device", "cpu", "--workdir", str(tmp_path / "port"))
    assert r.returncode == 0, r.stderr
    body = r.stdout[:r.stdout.rindex("]") + 1]
    (cell,) = json.loads(body)
    assert cell["diff"] is None and cell["family"] == "reduce"
    assert "wf_chaos: OK" in r.stdout
    rj = _jax(env, "wf_chaos.py", *args, "--workdir", str(tmp_path / "jax"))
    assert rj.returncode == 0, rj.stderr
    (jcell,) = json.loads(rj.stdout[:rj.stdout.rindex("]") + 1])
    assert set(jcell) <= set(cell)
    assert cell["records"] == jcell["records"]
    # the mesh rescale cells (logical CPU meshes), as JAX's full matrix
    # runs them
    rm = _port(env, "windflow_tpu_torch.durability.chaos", "--mesh",
               "--family", "window_cb", "--records", "4096", "--json",
               "--device", "cpu", "--workdir", str(tmp_path / "mesh"))
    assert rm.returncode == 0, rm.stderr
    cells = json.loads(rm.stdout[:rm.stdout.rindex("]") + 1])
    assert [c["mesh"] for c in cells] == ["1x4->1x2", "1x2->1x4"]
    assert all(c["diff"] is None for c in cells)
