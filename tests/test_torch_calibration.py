"""The port's calibration plane (``windflow_tpu_torch/monitoring/
calibration.py``, ``calibrate.py``) against the JAX package's
(``tests/test_calibration.py``), on the CPU with ``Config(device="cpu")``.

* The provenance vocabulary, the store's validation, ``constant``'s
  degrade paths (missing key, another device kind, stale, kill switch)
  and the provenance summary behave as JAX's; the modeled defaults keep
  JAX's six keys with H100 values, and no TPU figure.
* The roofline ledger steps as JAX's on the same synthetic counters and
  clock (rates, ratios, the ROOFLINE_DEGRADED enter/latch/clear), and on
  a real graph carries the sweep ledger's tensor bytes with a legal
  provenance tag.
* The probe module writes a file that ``tools/wf_calibrate.py --check``
  accepts unchanged (tiny shapes on the CPU), its own ``--check`` keeps
  JAX's exit codes, ``Config.calibration`` installs it, and the
  postmortem's ``calibration.json`` and ``roofline.json`` pass
  ``tools/wf_doctor.py --check``.  The off path is checked structurally.
"""

import json
import os
import subprocess
import sys
import time
import types
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu.monitoring import calibration as jcal
from windflow_tpu_torch.monitoring import calibrate as tprobe
from windflow_tpu_torch.monitoring import calibration as cal
from windflow_tpu_torch.monitoring.openmetrics import (parse_exposition,
                                                       render_openmetrics)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CAP, KEYS = 4096, 256, 8

#: tiny probe shapes for the CPU
TINY = {"h2d_tunnel_bytes_per_sec": {"cap": 4096, "reps": 3},
        "dispatch_overhead_usec": {"reps": 20},
        "sampled_sync_usec": {"reps": 5},
        "hbm_bytes_per_sec": {"nbytes": 1 << 20, "reps": 3},
        "kernel_step_usec": {"cap": 2048, "keys": 16, "reps": 2,
                             "steps": 2}}


@pytest.fixture(autouse=True)
def _clean_store():
    cal.set_default_store(None)
    jcal.set_default_store(None)
    yield
    cal.set_default_store(None)
    jcal.set_default_store(None)


def _store_doc(recorded_at=None, device_kind="cpu", constants=None):
    return {
        "schema": cal.SCHEMA,
        "recorded_at": time.time() if recorded_at is None else recorded_at,
        "device_kind": device_kind,
        "backend": "cpu",
        "jax_version": "torch test",
        "torch_version": torch.__version__,
        "constants": constants or {
            "ici_bytes_per_sec": 42e9,
            "h2d_tunnel_bytes_per_sec": 1e9,
            "hbm_bytes_per_sec": 5e9,
            "dispatch_overhead_usec": 8.0,
            "sampled_sync_usec": 2.0,
            "kernel_step_usec": 500.0,
        },
    }


def _install(**kw):
    store = cal.CalibrationStore(_store_doc(**kw), path="<test>")
    cal.set_default_store(store)
    return store


def _graph(name="cal_app", n=N, **kw):
    blob = _blob(n)
    step = CAP * 24

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    kw.setdefault("key_compaction", False)
    fired = []
    g = wt.PipeGraph(name, config=wt.Config(device="cpu", **kw),
                     time_policy=wt.TimePolicy.EVENT)
    g.add_source(wt.FrameSource(chunks, nv=1, fields=["v"],
                                output_batch_size=CAP)) \
        .add(wt.MapGPU_Builder(lambda t: {"key": t["key"],
                                          "v": t["v"] * 2.0})
             .withName("m").build()) \
        .add(wt.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7)
             .withName("f").build()) \
        .add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
             .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
             .withMaxKeys(KEYS).withName("win").build()) \
        .add_sink(wt.Sink_Builder(lambda r: fired.append(r)
                                  if r is not None else None)
                  .withName("snk").build())
    return g, fired


def _blob(n, seed=11):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, KEYS, n)
    rec["ts"] = np.arange(n, dtype=np.int64) * 500
    rec["v"] = rng.integers(0, 100, n)
    return rec.tobytes()


def _drive(g):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.start()
        while not g.is_done():
            if not g.step():
                break
            g.health_tick()
        g.wait_end()
        g.health_tick()


# ---------------------------------------------------------------------------
# the vocabulary, the store, constant()
# ---------------------------------------------------------------------------

def test_vocabulary_and_tags_equal_jax():
    for age in (0, 5, 90, 119, 120, 3599, 7200, 86400, 2 * 86400 + 5,
                30 * 86400):
        assert cal.calibrated_tag(age) == jcal.calibrated_tag(age)
    for tag in ("measured", "modeled", "interpret", cal.calibrated_tag(5),
                "guessed", "", None, 1.0, "calibrated", "tensor-bytes"):
        assert cal.legal_provenance(tag) == jcal.legal_provenance(tag)
    assert (cal.SCHEMA, cal.MEASURED, cal.MODELED, cal.INTERPRET) == \
        (jcal.SCHEMA, jcal.MEASURED, jcal.MODELED, jcal.INTERPRET)
    assert cal.MESH_ONLY_KEYS == jcal.MESH_ONLY_KEYS
    assert cal.TTL_S == jcal.TTL_S


def test_modeled_defaults_are_h100_figures_under_jax_keys():
    assert set(cal.MODELED_DEFAULTS) == set(jcal.MODELED_DEFAULTS)
    assert cal.MODELED_DEFAULTS["hbm_bytes_per_sec"] == 3.35e12
    assert cal.MODELED_DEFAULTS["h2d_tunnel_bytes_per_sec"] == 64e9
    src = open(cal.__file__).read() + open(tprobe.__file__).read()
    for tpu_figure in ("819e9", "819", "19e6"):
        assert tpu_figure not in src


@pytest.mark.parametrize("mutate", [
    lambda d: d.update(schema="wf-calibration/999"),
    lambda d: d.update(recorded_at="yesterday"),
    lambda d: d.update(device_kind=""),
    lambda d: d.update(jax_version=None),
    lambda d: d.update(constants={}),
    lambda d: d["constants"].update(warp_drive_factor=9.0),
    lambda d: d["constants"].update(hbm_bytes_per_sec=float("nan")),
    lambda d: d["constants"].update(hbm_bytes_per_sec=-1.0),
], ids=["schema", "recorded_at", "device_kind", "jax_version",
        "empty_constants", "unknown_key", "nan", "negative"])
def test_corrupt_store_rejected_as_jax(mutate):
    doc = _store_doc()
    mutate(doc)
    with pytest.raises(cal.CalibrationError):
        cal.CalibrationStore(doc)
    with pytest.raises(jcal.CalibrationError):
        jcal.CalibrationStore(doc)


def test_store_round_trips_with_torch_version():
    s = cal.CalibrationStore(_store_doc())
    doc = s.to_json()
    assert doc["torch_version"] == torch.__version__
    assert jcal.CalibrationStore(doc).to_json() == {
        k: v for k, v in doc.items() if k != "torch_version"}


def test_corrupt_file_degrades_graph_build_with_warning(tmp_path):
    bad = tmp_path / "cal.json"
    bad.write_text("{not json")
    g, _ = _graph(calibration=str(bad), n=512, name="cal_bad_app")
    with pytest.warns(RuntimeWarning, match="running uncalibrated"):
        g.start()
    g.wait_end()
    assert cal.constant("hbm_bytes_per_sec") == (
        cal.MODELED_DEFAULTS["hbm_bytes_per_sec"], "modeled")


def test_constant_round_trip_and_degrade_paths_as_jax():
    assert cal.live_device_kind() == jcal.live_device_kind() == "cpu"
    for key in cal.MODELED_DEFAULTS:
        assert cal.constant(key) == (cal.MODELED_DEFAULTS[key], "modeled")
    doc = _store_doc()
    cal.set_default_store(cal.CalibrationStore(doc, path="<t>"))
    jcal.set_default_store(jcal.CalibrationStore(doc, path="<t>"))
    now = time.time()
    for key in cal.MODELED_DEFAULTS:
        tv, tp = cal.constant(key, now=now)
        jv, jp = jcal.constant(key, now=now)
        assert tv == jv == doc["constants"][key] and tp == jp
        assert cal.is_calibrated(tp)
    cal.set_default_store(None)
    assert cal.constant("ici_bytes_per_sec")[1] == "modeled"


def test_missing_key_stays_modeled():
    _install(constants={"hbm_bytes_per_sec": 5e9})
    assert cal.constant("dispatch_overhead_usec") == (
        cal.MODELED_DEFAULTS["dispatch_overhead_usec"], "modeled")


def test_device_kind_mismatch_degrades_with_one_warning():
    _install(device_kind="NVIDIA H100 80GB HBM3")
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        v, prov = cal.constant("hbm_bytes_per_sec")
        cal.constant("ici_bytes_per_sec")
    assert (v, prov) == (cal.MODELED_DEFAULTS["hbm_bytes_per_sec"],
                         "modeled")
    assert len([w for w in wlog if "device kind" in str(w.message)]) == 1


def test_ttl_staleness_degrades_with_one_warning():
    _install(recorded_at=time.time() - cal.TTL_S - 3600)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        v, prov = cal.constant("hbm_bytes_per_sec")
        cal.constant("hbm_bytes_per_sec")
    assert prov == "modeled"
    assert len([w for w in wlog if "days old" in str(w.message)]) == 1
    v, prov = cal.constant("hbm_bytes_per_sec",
                           now=time.time() - cal.TTL_S - 3000)
    assert (v, cal.is_calibrated(prov)) == (5e9, True)


def test_kill_switch_blocks_config_load(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(_store_doc()))
    monkeypatch.setenv("WF_TPU_CALIBRATION", "0")
    assert cal.killed()
    g, _ = _graph(calibration=str(path), n=512, name="cal_kill_app")
    g.run()
    assert cal.default_store() is None
    assert cal.constant("hbm_bytes_per_sec")[1] == "modeled"


def test_provenance_summary_shape_equals_jax():
    doc = _store_doc()
    cal.set_default_store(cal.CalibrationStore(doc, path="<t>"))
    jcal.set_default_store(jcal.CalibrationStore(doc, path="<t>"))
    now = time.time()
    t, j = cal.provenance_summary(now), jcal.provenance_summary(now)
    assert t["store"].pop("torch_version") == torch.__version__
    assert t == j
    assert all(cal.is_calibrated(s["provenance"])
               for s in t["constants"].values())


# ---------------------------------------------------------------------------
# the roofline ledger
# ---------------------------------------------------------------------------

def _fake_graph(jax_side, names=("win",), bpt=None):
    ops = []
    for name in names:
        rep = types.SimpleNamespace(
            stats=types.SimpleNamespace(inputs_received=0))
        ops.append(types.SimpleNamespace(name=name, is_tpu=True,
                                         is_gpu=True, replicas=[rep]))
    ledger = None
    if bpt is not None:
        prov = "modeled" if jax_side else "tensor-bytes"
        ledger = types.SimpleNamespace(section=lambda: {
            "per_hop": {n: {"steady_bytes_per_tuple": bpt,
                            "bytes_provenance": prov} for n in names}})
    return types.SimpleNamespace(_operators=ops, _ledger=ledger)


def _feed(led, g, t, rate, ticks, dt=1.0):
    for _ in range(ticks):
        t += dt
        for op in g._operators:
            op.replicas[0].stats.inputs_received += int(rate * dt)
        led.tick(now_s=t)
    return t


def test_roofline_rates_and_ratio_equal_jax():
    doc = _store_doc(constants={"hbm_bytes_per_sec": 48000.0})
    cal.set_default_store(cal.CalibrationStore(doc, path="<t>"))
    jcal.set_default_store(jcal.CalibrationStore(doc, path="<t>"))
    tg, jg = _fake_graph(False, bpt=24.0), _fake_graph(True, bpt=24.0)
    t, j = cal.RooflineLedger(tg), jcal.RooflineLedger(jg)
    _feed(t, tg, 0.0, 1000.0, 10)
    _feed(j, jg, 0.0, 1000.0, 10)
    ts, js = t.section(), j.section()
    hop = ts["per_hop"]["win"]
    assert hop.pop("bytes_per_tuple_source") == "tensor-bytes"
    assert hop["bytes_per_tuple_provenance"] == "modeled"
    assert hop == js["per_hop"]["win"]
    assert hop["ratio_vs_roofline"] == pytest.approx(0.5, abs=1e-6)
    for key in ("dominant_op", "bandwidth_bytes_per_sec",
                "bandwidth_provenance", "ticks", "verdict", "thresholds"):
        assert ts[key] == js[key], key


def test_roofline_degraded_enter_latch_clear_as_jax():
    tg, jg = _fake_graph(False), _fake_graph(True)
    t, j = cal.RooflineLedger(tg), jcal.RooflineLedger(jg)
    clock = [0.0, 0.0]
    script = [(1000.0, t.MIN_SAMPLES + 2), (100.0, 1), (100.0, 1),
              (0.0, 5), (1000.0, t.CLEAR_AFTER - 1), (1000.0, 1)]
    for rate, ticks in script:
        clock[0] = _feed(t, tg, clock[0], rate, ticks)
        clock[1] = _feed(j, jg, clock[1], rate, ticks)
        assert (t.verdict, t.entered, t.cleared) == \
            (j.verdict, j.entered, j.cleared)
    assert t.entered == 1 and t.cleared == 1 and t.verdict is None
    assert t.last_verdict["state"] == "ROOFLINE_DEGRADED"


def test_drained_graph_never_latches():
    g = _fake_graph(False)
    led = cal.RooflineLedger(g)
    t = _feed(led, g, 0.0, 1000.0, led.MIN_SAMPLES + 2)
    for _ in range(20):
        t += 1.0
        led.tick(now_s=t)
    assert led.verdict is None and led.entered == 0


def test_roofline_section_on_real_graph(monkeypatch):
    monkeypatch.setattr(cal.RooflineLedger, "TICK_MIN_INTERVAL_S", 0.0)
    g, fired = _graph(name="cal_live_app")
    _drive(g)
    assert fired
    sec = g.stats()["Roofline"]
    assert sec["per_hop"] and sec["dominant_op"] in sec["per_hop"]
    assert sec["bandwidth_provenance"] == "modeled"
    assert sec["bandwidth_bytes_per_sec"] == 3.35e12
    joined = 0
    for hop in sec["per_hop"].values():
        assert hop["achieved_tuples_per_sec"] > 0
        if "bytes_per_tuple" in hop:
            joined += 1
            assert hop["bytes_per_tuple_source"] == "tensor-bytes"
            assert jcal.legal_provenance(hop["bytes_per_tuple_provenance"])
            # the CPU's rate against an H100's bandwidth rounds to ~0
            # at JAX's 6 decimals; the card's phase 11 holds it > 0
            assert 0 <= hop["ratio_vs_roofline"] <= 1.05
            assert hop["ratio_vs_roofline"] == round(
                hop["achieved_bytes_per_sec"] / 3.35e12, 6)
            assert hop["achieved_bytes_per_sec"] == pytest.approx(
                hop["achieved_tuples_per_sec"] * hop["bytes_per_tuple"],
                rel=0.01)
    assert joined
    assert set(sec["calibration"]["constants"]) == set(cal.MODELED_DEFAULTS)
    fams = parse_exposition(render_openmetrics(g.stats()))
    for _, lab, _ in fams["wf_roofline_bytes_per_tuple"]["samples"]:
        assert jcal.legal_provenance(lab["provenance"])
    assert fams["wf_roofline_degraded"]["samples"][0][2] == 0
    prov = {lab["constant"]: lab["provenance"] for _, lab, _ in
            fams["wf_provenance"]["samples"]}
    assert set(prov) == set(cal.MODELED_DEFAULTS)


def test_roofline_verdict_surfaces_in_health_dominant_op_only():
    g, _ = _graph(name="cal_health_app")
    _drive(g)
    v = {"state": "ROOFLINE_DEGRADED", "dominant_op": "m",
         "current_tuples_per_sec": 10.0, "baseline_tuples_per_sec": 1000.0,
         "ratio_vs_baseline": 0.01, "degrade_ratio": 0.5, "entered_tick": 9}
    g._roofline.verdict = g._roofline.last_verdict = v
    g.health_tick()
    h = g.stats()["Health"]
    assert h["graph_state"] == "ROOFLINE_DEGRADED"
    for name, hv in h["verdicts"].items():
        if name == "m":
            assert hv["state"] == "ROOFLINE_DEGRADED"
            assert hv["roofline"]["ratio_vs_baseline"] == 0.01
        else:
            assert hv["state"] != "ROOFLINE_DEGRADED" and "roofline" not in hv


def test_off_path_never_builds():
    g, fired = _graph(roofline_plane=False, name="cal_off_app")
    _drive(g)
    assert fired and g._roofline is None
    assert g._health is None or g._health.roofline is None
    assert g.stats()["Roofline"] == {"enabled": False}


# ---------------------------------------------------------------------------
# the probes, the CLI, JAX's tools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    doc = tprobe.run_probes("cpu", overrides=TINY, log=lambda m: None)
    path = tmp_path_factory.mktemp("cal") / "calibration.json"
    path.write_text(json.dumps(doc))
    return doc, str(path)


def test_probes_fill_every_single_device_key(probed):
    doc, _ = probed
    want = set(cal.MODELED_DEFAULTS) - set(cal.MESH_ONLY_KEYS)
    assert set(doc["constants"]) == want
    assert all(v > 0 for v in doc["constants"].values())
    assert doc["device_kind"] == "cpu" and doc["backend"] == "cpu"
    assert doc["jax_version"] == "torch " + torch.__version__
    assert doc["torch_version"] == torch.__version__
    assert "ici_bytes_per_sec" not in doc["constants"]


def _run_tool(args, env_extra=None):
    env = dict(os.environ)
    env.pop("WF_TPU_CALIBRATION", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)


@pytest.mark.parametrize("tool", ["jax", "port"])
def test_check_exit_codes(probed, tmp_path, tool):
    cli = [os.path.join(REPO, "tools", "wf_calibrate.py")] if tool == "jax" \
        else ["-m", "windflow_tpu_torch.monitoring.calibrate"]
    _, fresh = probed
    r = _run_tool(cli + ["--check", fresh])
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr + r.stdout
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(
        _store_doc(recorded_at=time.time() - cal.TTL_S - 86400)))
    r = _run_tool(cli + ["--check", str(stale)])
    assert r.returncode == 1 and "days old" in r.stderr
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{broken")
    assert _run_tool(cli + ["--check", str(corrupt)]).returncode == 1
    assert _run_tool(cli + ["--check", str(tmp_path / "no.json")]) \
        .returncode == 1
    r = _run_tool(cli + ["--check", fresh],
                  env_extra={"WF_TPU_CALIBRATION": "0"})
    assert r.returncode == 2 and "kill switch" in r.stderr


def test_config_calibration_installs_the_probed_store(probed):
    _, path = probed
    g, fired = _graph(calibration=path, n=512, name="cal_cfg_app")
    _drive(g)
    assert fired
    assert cal.default_store().path == path
    sec = g.stats()["Roofline"]
    assert cal.is_calibrated(sec["bandwidth_provenance"])
    assert sec["bandwidth_bytes_per_sec"] == \
        json.load(open(path))["constants"]["hbm_bytes_per_sec"]
    assert all(cal.is_calibrated(s["provenance"])
               for k, s in cal.provenance_summary()["constants"].items()
               if k not in cal.MESH_ONLY_KEYS)


def test_postmortem_calibration_and_roofline_pass_wf_doctor(probed,
                                                            tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(cal.RooflineLedger, "TICK_MIN_INTERVAL_S", 0.0)
    _, path = probed
    g, _ = _graph(calibration=path, name="cal_pm_app",
                  log_dir=str(tmp_path))
    _drive(g)
    bundle = g.dump_postmortem(str(tmp_path / "pm"))
    files = json.load(open(os.path.join(bundle, "manifest.json")))["files"]
    for name in ("calibration.json", "roofline.json", "latency.json",
                 "tenant.json"):
        assert name in files
    r = _run_tool([os.path.join(REPO, "tools", "wf_doctor.py"), "--check",
                   bundle])
    assert r.returncode == 0, r.stderr
    rfl = json.load(open(os.path.join(bundle, "roofline.json")))
    assert rfl["per_hop"] and cal.is_calibrated(rfl["bandwidth_provenance"])
