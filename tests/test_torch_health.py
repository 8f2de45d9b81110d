"""The health plane of the port against the JAX package's
(``windflow_tpu_torch/monitoring/health.py`` vs
``windflow_tpu/monitoring/health.py``), the families of
``tests/test_health.py`` on the same seeded graphs: a healthy run all
OK, a wedged sink named as the stall's root cause (in the error, the
verdicts and the bundle), a crash marked FAILED, the backpressure
verdict, the stall latch clearing on progress, one stall counted once,
the postmortem bundle round-tripping ``tools/wf_doctor.py`` and a corrupt
one rejected, and the watchdog-off path checked structurally (nothing
installed, nothing called)."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import default_config as jax_default_config
from windflow_tpu_torch.monitoring import health as th
from windflow_tpu_torch.monitoring.health import (BACKPRESSURED, FAILED, OK,
                                                  STALLED, HealthPlane)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCTOR = os.path.join(REPO, "tools", "wf_doctor.py")


def _cfg(pkg, tmp_path=None, **kw):
    if tmp_path is not None:
        kw.setdefault("log_dir", str(tmp_path / pkg.__name__))
    if pkg is wt:
        kw.setdefault("device", "cpu")
        return wt.Config(**kw)
    return dataclasses.replace(jax_default_config, **kw)


def _graph(pkg, cfg, n=3000, cap=256, name="health_app", bad=None):
    src = (pkg.Source_Builder(
        lambda: iter({"key": np.int32(i % 8), "v": np.float32(i)}
                     for i in range(n)))
        .withName("src").withOutputBatchSize(cap).build())
    dev = getattr(pkg, "MapGPU_Builder" if pkg is wt else "MapTPU_Builder")
    m = (dev(lambda t: {"key": t["key"], "v": t["v"] * 2.0})
         .withName("mdev").build())
    snk = pkg.Sink_Builder(lambda t, ctx=None: None).withName("snk").build()
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT, config=cfg)
    pipe = g.add_source(src).add(m)
    if bad is not None:
        pipe.add(pkg.Map_Builder(bad).withName("bad_map").build())
    pipe.add_sink(snk)
    return g, snk


def _wedge(snk):
    snk.replicas[0].drain = lambda limit=0: False


def _doctor(*args):
    return subprocess.run([sys.executable, DOCTOR, *args],
                          capture_output=True, text=True, timeout=120)


def test_states_and_schema_equal_jax():
    assert th.STATES == wf.monitoring.health.STATES
    assert th.POSTMORTEM_SCHEMA == wf.monitoring.health.POSTMORTEM_SCHEMA


def test_healthy_run_all_ok_as_in_jax(tmp_path):
    sections = {}
    for pkg in (wt, wf):
        g, _ = _graph(pkg, _cfg(pkg, tmp_path))
        g.run()
        sections[pkg] = g.stats()["Health"]
    h, jh = sections[wt], sections[wf]
    assert h["enabled"] is True and h["graph_state"] == OK
    assert {n: v["state"] for n, v in h["verdicts"].items()} == \
        {n: v["state"] for n, v in jh["verdicts"].items()} == \
        {"src": OK, "mdev": OK, "snk": OK}
    assert h["stall_events"] == jh["stall_events"] == 0
    assert h["last_stall"] is None and h["samples_taken"] > 0
    assert set(h) == set(jh) and set(h["thresholds"]) == set(jh["thresholds"])
    json.dumps(h)


def test_watchdog_off_installs_nothing_and_calls_nothing(tmp_path,
                                                         monkeypatch):
    """The off path, structurally: no plane, and no watchdog method is
    ever entered (health_tick is one check)."""
    calls = []
    for name in ("sample", "section", "diagnose_stall", "note_failure"):
        monkeypatch.setattr(HealthPlane, name,
                            lambda self, *a, _n=name, **k: calls.append(_n))
    g, _ = _graph(wt, _cfg(wt, tmp_path, health_watchdog=False))
    g.run()
    for _ in range(100):
        g.health_tick()
    assert g._health is None
    assert g.stats()["Health"] == {"enabled": False}
    assert calls == []


def test_wedged_sink_named_as_in_jax(tmp_path):
    out = {}
    for pkg in (wt, wf):
        g, snk = _graph(pkg, _cfg(pkg, tmp_path,
                                  health_stall_grace_usec=50_000),
                        name="stall_app")
        g.start()
        _wedge(snk)
        with pytest.raises(pkg.WindFlowError) as ei:
            g.wait_end()
        out[pkg] = (str(ei.value), g.stats()["Health"], g._postmortem_dir)
    msg, h, bundle = out[wt]
    jmsg, jh, _ = out[wf]
    assert "root cause 'snk'" in msg and "root cause 'snk'" in jmsg
    assert "message(s) pending" in msg and bundle in msg
    assert h["graph_state"] == jh["graph_state"] == STALLED
    assert {n: v["state"] for n, v in h["verdicts"].items()} == \
        {n: v["state"] for n, v in jh["verdicts"].items()}
    assert h["verdicts"]["snk"]["queue_depth"] > 0
    assert h["stall_events"] == jh["stall_events"] == 1
    assert h["last_stall"]["root_cause"] == "snk"
    assert any("snk" in e["changes"] for e in h["timeline"])
    # the bundle round-trips wf_doctor: checked, and rendered with the
    # root cause
    r = _doctor("--check", bundle)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr
    r = _doctor(bundle)
    assert r.returncode == 0 and "ROOT CAUSE: 'snk'" in r.stdout, r.stderr
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["schema"] == "wf-postmortem/1"
    assert manifest["app"] == "stall_app" and manifest["reason"] == "stall"
    assert set(manifest["files"]) >= {
        "stats.json", "events.json", "health.json", "device.json",
        "jit.json", "preflight.json", "sweep.json", "shard.json",
        "durability.json"}
    assert manifest["errors"] == {}


def test_corrupt_bundle_rejected(tmp_path):
    g, snk = _graph(wt, _cfg(wt, tmp_path, health_stall_grace_usec=50_000))
    g.start()
    _wedge(snk)
    with pytest.raises(wt.WindFlowError):
        g.wait_end()
    hp = os.path.join(g._postmortem_dir, "health.json")
    with open(hp) as f:
        h = json.load(f)
    h["verdicts"]["snk"]["state"] = "ZOMBIE"
    with open(hp, "w") as f:
        json.dump(h, f)
    r = _doctor("--check", g._postmortem_dir)
    assert r.returncode == 1 and "illegal state" in r.stderr


def test_manual_postmortem_on_healthy_graph(tmp_path):
    g, _ = _graph(wt, _cfg(wt, tmp_path))
    g.run()
    bundle = g.dump_postmortem(str(tmp_path / "pm"), reason="manual")
    r = _doctor("--check", bundle)
    assert r.returncode == 0, r.stderr


def _boom(t):
    if t["v"] > 500:
        raise ValueError("seeded operator crash")
    return t


def test_crash_marked_failed_as_in_jax(tmp_path):
    out = {}
    for pkg in (wt, wf):
        g, _ = _graph(pkg, _cfg(pkg, tmp_path), name="crash_app", bad=_boom)
        with pytest.raises(ValueError, match="seeded operator crash"):
            g.run()
        out[pkg] = (g.stats()["Health"], g._postmortem_dir)
    (h, bundle), (jh, _) = out[wt], out[wf]
    assert h["verdicts"]["bad_map"]["state"] == FAILED
    assert "ValueError" in h["verdicts"]["bad_map"]["failure"]
    assert h["graph_state"] == jh["graph_state"] == FAILED
    assert {n: v["state"] for n, v in h["verdicts"].items()} == \
        {n: v["state"] for n, v in jh["verdicts"].items()}
    with open(os.path.join(bundle, "manifest.json")) as f:
        assert json.load(f)["reason"].startswith("crash: ValueError")


def test_backpressure_verdict_on_deep_queue(tmp_path):
    cfg = _cfg(wt, tmp_path, health_backpressure_depth=2,
               health_stall_grace_usec=60_000_000)
    g, snk = _graph(wt, cfg, n=4000, cap=128)
    g.start()
    rep = snk.replicas[0]
    real = type(rep).drain
    _wedge(snk)
    for _ in range(40):
        if len(rep.inbox) >= 2:
            break
        g.step()
    assert len(rep.inbox) >= 2, "backlog never built"
    assert g._health.sample()["snk"]["state"] == BACKPRESSURED
    del rep.drain
    assert rep.drain.__func__ is real
    g.wait_end()
    assert g._health.sample()["snk"]["state"] == OK


def test_stall_latch_clears_on_progress(tmp_path):
    g, snk = _graph(wt, _cfg(wt, tmp_path, health_stall_grace_usec=50_000))
    g.start()
    rep = snk.replicas[0]
    real = type(rep).drain
    _wedge(snk)
    with pytest.raises(wt.WindFlowError):
        g.wait_end()
    assert g._health.sample()["snk"]["state"] == STALLED
    rep.drain = lambda limit=0: real(rep, limit)
    while rep.inbox:
        rep.drain(0)
    assert g._health.sample()["snk"]["state"] == OK


def test_watchdog_then_hard_stall_counts_one_event(tmp_path):
    g, snk = _graph(wt, _cfg(wt, tmp_path, health_stall_grace_usec=20_000))
    g.start()
    _wedge(snk)
    for _ in range(20):
        g.step()
    g._health.sample()
    time.sleep(0.05)
    v = g._health.sample()
    assert v["snk"]["state"] == STALLED and g._health.stall_events == 1
    with open(os.path.join(g._postmortem_dir, "manifest.json")) as f:
        assert json.load(f)["reason"].startswith("watchdog: stalled")
    with pytest.raises(wt.WindFlowError):
        g.wait_end()
    assert g._health.stall_events == 1
    with open(os.path.join(g._postmortem_dir, "manifest.json")) as f:
        assert json.load(f)["reason"] == "stall"


def test_capture_storm_baselined_per_graph(tmp_path):
    """The registry is process-wide: an earlier graph's recaptures do not
    flag a fresh graph's operator of the same name; recaptures during
    this run past the threshold do."""
    from windflow_tpu_torch.monitoring.jit_registry import default_registry
    entry = default_registry().entry("mdev")
    before = entry.recompiles
    try:
        entry.recompiles = before + 10
        g, _ = _graph(wt, _cfg(wt, tmp_path, health_recompile_storm=4))
        g.start()
        entry.compiles = max(entry.compiles, 1)
        assert g._health.sample()["mdev"]["compile_storm"] is False
        entry.recompiles += 4
        v = g._health.sample()
        assert v["mdev"]["compile_storm"] is True
        assert v["mdev"]["state"] == BACKPRESSURED
        g.wait_end()
    finally:
        entry.recompiles = before


def test_format_diagnosis_equals_jax():
    diag = {"root_cause": None, "verdicts": {
        "src": {"state": OK, "queue_depth": 0, "last_advance_age_usec": 0}}}
    msg = HealthPlane.format_diagnosis(diag)
    assert "source starvation" in msg
    assert msg == wf.monitoring.health.HealthPlane.format_diagnosis(diag)
    diag = {"root_cause": "snk", "verdicts": {"snk": {
        "state": STALLED, "queue_depth": 3, "watermark_frontier_usec": 9,
        "last_advance_age_usec": 2_500_000,
        "hot_shard": {"shard": 1, "queue_depth": 3}}},
        "shard": {"hot_keys": [{"key": 7, "share": 0.4}], "basis": "cms"}}
    assert HealthPlane.format_diagnosis(diag) == \
        wf.monitoring.health.HealthPlane.format_diagnosis(diag)
