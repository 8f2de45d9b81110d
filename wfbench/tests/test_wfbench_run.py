"""Whole runs of the command at a test size on the CPU: the result line,
the imports, a cell added from new files alone, and the look for a
card."""

import ast
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from wfbench import run
from wfbench.tests._small import SMALL, overrides

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
KEYS = {"correct", "attempted", "failed", "metrics", "device"}
SEED = 2 ** 33 + 11


def run_line(cell, trace=0, seed=SEED, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "1.5", "--trace", str(trace)],
                      device="cpu", **(kw or overrides(cell)))
    return rc, out.getvalue().splitlines(), err.getvalue().splitlines()


def metric_names(kind, cell):
    return {m["name"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line_holds_the_contract_keys(cell):
    rc, out, err = run_line(cell)
    assert rc == 0
    line = json.loads(out[-1])
    assert set(line) == KEYS | {"checks"} and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == metric_names("end_to_end", cell)
    assert all(set(m) == {"value", "unit"} and m["value"] > 0
               for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # the numbers compared, beside their limits, end standard error
    assert [ln.split()[1] for ln in err[-len(line["checks"]):]] \
        == list(line["checks"])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_line_holds_per_layer_metrics(cell):
    rc, out, _ = run_line(cell, trace=1)
    assert rc == 0
    line = json.loads(out[-1])
    assert set(line) <= KEYS | {"breakdown", "checks"}
    assert line["correct"] is True
    assert set(line["metrics"]) <= metric_names("per_layer", cell)
    # the CPU has no device trace: the program's counters and spans (the
    # latency plane's only when it sampled a batch in so short a run)
    assert "h2d_bytes_per_tuple" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])


def test_no_card_no_result():
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = run.main(["--workload", "ysb.catchup", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("windflow_tpu_torch_like", sys)
    assert "windflow_tpu" not in run.forbidden_modules()
    assert set(run.FORBIDDEN) == {"jax", "jaxlib", "flax", "windflow_tpu"}


def _python(code, cwd=ROOT):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json; sys.path.insert(0, '.')\n"
        "from wfbench import run\n"
        "from wfbench.tests._small import overrides\n"
        "rc = run.main(['--workload', 'ysb.catchup', '--seed', '3',"
        " '--seconds', '1', '--trace', '0'], device='cpu',"
        " **overrides('ysb.catchup'))\n"
        "print(json.dumps([rc, sorted({m.split('.')[0] for m in"
        " sys.modules})]))\n")
    p = _python(code)
    rc, tops = json.loads(p.stdout.splitlines()[-1])
    assert rc == 0, p.stderr[-2000:]
    assert not {"jax", "jaxlib", "flax", "windflow_tpu"} & set(tops)
    assert "windflow_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "import wfbench.reference.ysb\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in"
            " sys.modules})))\n")
    tops = set(json.loads(_python(code).stdout.splitlines()[-1]))
    assert not {"windflow_tpu_torch", "windflow_tpu", "jax", "torch",
                "chip_smoke", "tests"} & tops
    ref = os.path.join(ROOT, "wfbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            mods = {a.name.split(".")[0] for n in ast.walk(tree)
                    if isinstance(n, ast.Import) for a in n.names}
            mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom) and n.module}
            assert mods <= {"numpy", "__future__"}, (name, mods)


def test_a_cell_added_from_new_files_alone(tmp_path):
    """A new configuration (its JSON, graph, reference), mix and metric
    as new files and new BENCHMARK.json entries: it runs, and no file
    that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "wfbench"), root / "wfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "windflow_tpu_torch"),
               root / "windflow_tpu_torch")
    before = {p: p.read_bytes() for p in root.joinpath("wfbench").rglob("*")
              if p.is_file()}
    w = root / "wfbench"
    cfg = json.load(open(w / "configs" / "ysb.json"))
    cfg.update(SMALL["ysb.catchup"][0], name="ysb_tiny", campaigns=10,
               record=dict(cfg["record"], key_range=100))
    (w / "configs" / "ysb_tiny.json").write_text(json.dumps(cfg))
    (w / "configs" / "ysb_tiny.py").write_text(
        "from wfbench.configs.ysb import build, collect, draw, "
        "least_bytes  # noqa: F401\n")
    (w / "reference" / "ysb_tiny.py").write_text(
        "from wfbench.reference.ysb import check, control  # noqa: F401\n")
    (w / "traffic" / "trickle.json").write_text(json.dumps(
        dict(SMALL["ysb.catchup"][1], event_rate_per_s=100_000,
             hot_keys=2, hot_share=0.5)))
    (w / "metrics" / "results_per_batch.py").write_text(
        "def read(run):\n    return run.results_per_batch or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "ysb_tiny", "source": "a test",
                             "file": "wfbench/configs/ysb_tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ysb_tiny.trickle",
                               "config": "ysb_tiny", "traffic": "trickle",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "results_per_batch",
                               "unit": "results", "better": "higher",
                               "source": "host_clock", "layer": "sink",
                               "moves": "throughput",
                               "workloads": ["ysb_tiny.trickle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys, json; sys.path.insert(0, '.')\n"
            "from wfbench import run\n"
            "sys.exit(run.main(['--workload', 'ysb_tiny.trickle', '--seed',"
            " '9', '--seconds', '1', '--trace', '1'], device='cpu'))\n")
    p = _python(code, cwd=root)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert line["metrics"]["results_per_batch"]["value"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())
