"""The port's monitoring thread, dashboard server, web UI and SVG
diagram (``windflow_tpu_torch/monitoring/{monitor,dashboard,webui,
diagram}.py``) against the JAX package's (``tests/test_dashboard.py``,
the monitor cases of ``tests/test_monitoring.py``), on the CPU with
``Config(device="cpu")``.

A traced graph registers over TCP, reports and ends (NEW_APP,
NEW_REPORT, END_APP); the HTTP side serves ``/``, ``/apps``,
``/apps/<id>[/latest|/diagram]`` and ``/metrics``, which JAX's
``tools/wf_metrics.py --check`` accepts.  The two packages' protocol ends
interoperate both ways.  A run with no dashboard keeps sampling its
gauges and ledgers; an aborted run ships its final report marked
``Aborted``; a cadence tick never overlaps a CUDA graph capture (it
holds the capture lock).  Every module of ``windflow_tpu_torch.
monitoring`` and ``windflow_tpu_torch.analysis`` imports neither jax nor
``windflow_tpu``.
"""

import dataclasses
import json
import os
import pkgutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.monitoring import DashboardServer as JDashboardServer
from windflow_tpu_torch.monitoring import (DashboardServer,
                                           MonitoringThread, monitor, to_svg)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


LOG_DIR = {}


@pytest.fixture(autouse=True)
def _fast_cadence(monkeypatch, tmp_path):
    monkeypatch.setattr(monitor, "SAMPLE_INTERVAL_SEC", 0.05)
    LOG_DIR["path"] = str(tmp_path)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _graph(name, port, n=20_000, tracing=True, boom=False, tenant=""):
    cfg = wt.Config(device="cpu", tracing_enabled=tracing,
                    dashboard_host="127.0.0.1", dashboard_port=port,
                    tenant=tenant, log_dir=LOG_DIR["path"])

    def fn(t):
        if boom and t["v"] > 5000:
            raise ValueError("seeded operator crash")
        return {"key": t["key"], "v": t["v"] * 2}
    src = (wt.Source_Builder(lambda: iter({"key": i % 4, "v": i}
                                          for i in range(n)))
           .withName("src").withOutputBatchSize(256).build())
    g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT, config=cfg)
    g.add_source(src).add(wt.Map_Builder(fn).withName("map")
                          .withOutputBatchSize(256).build()) \
        .add(wt.MapGPU_Builder(lambda t: {"key": t["key"], "v": t["v"] + 1})
             .withName("gmap").build()) \
        .add_sink(wt.Sink_Builder(lambda t: time.sleep(0.00002)
                                  if t is not None else None)
                  .withName("snk").build())
    return g


def _wait_ended(server, names, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with server._lock:
            apps = {a.name: a for a in server.apps.values()}
        if set(names) <= set(apps) and all(apps[n].ended for n in names):
            return apps
        time.sleep(0.02)
    return apps


def test_dashboard_end_to_end():
    server = DashboardServer(tcp_port=0, http_port=0).start()
    try:
        g = _graph("dash_app", server.tcp_port)
        g.run()
        assert g._monitor is None
        _wait_ended(server, ["dash_app"])
        status, body = _get(server.http_port, "/apps")
        assert status == 200
        (app,) = json.loads(body)
        assert app["name"] == "dash_app" and app["alive"] is False
        assert app["num_reports"] >= 2          # >= 1 report + END_APP
        status, body = _get(server.http_port, f"/apps/{app['id']}/latest")
        report = json.loads(body)
        assert report["PipeGraph_name"] == "dash_app"
        assert report["Operator_number"] == 4
        for sec in ("Latency_plane", "Tenant", "Roofline"):
            assert report[sec]["enabled"], sec
        status, body = _get(server.http_port, f"/apps/{app['id']}")
        assert len(json.loads(body)["reports"]) == app["num_reports"]
        status, body = _get(server.http_port, f"/apps/{app['id']}/diagram")
        assert status == 200 and b"<svg" in body[:300]
        assert _get(server.http_port, "/apps/999")[0] == 404
        assert _get(server.http_port, "/nope")[0] == 404
        status, body = _get(server.http_port, "/")
        assert status == 200 and b"windflow_tpu_torch dashboard" in body
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "wf_metrics.py"),
             f"http://127.0.0.1:{server.http_port}/metrics", "--check"],
            capture_output=True, text=True, timeout=60)
        assert r.returncode == 0 and "OK" in r.stdout, r.stderr
    finally:
        server.stop()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_protocol_interoperates_with_jax(direction):
    server = (JDashboardServer if direction == "port_to_jax"
              else DashboardServer)(tcp_port=0, http_port=0).start()
    try:
        if direction == "port_to_jax":
            g = _graph("x_app", server.tcp_port, n=4000)
        else:
            cfg = dataclasses.replace(
                wf.default_config, tracing_enabled=True,
                dashboard_host="127.0.0.1", dashboard_port=server.tcp_port)
            g = wf.PipeGraph("x_app", wf.ExecutionMode.DEFAULT, config=cfg)
            g.add_source(wf.Source_Builder(
                lambda: iter({"k": i % 3, "v": i} for i in range(2000)))
                .build()).add_sink(wf.Sink_Builder(lambda t: None).build())
        g.run()
        apps = _wait_ended(server, ["x_app"])
        rec = apps["x_app"]
        assert rec.ended and rec.reports[-1]["PipeGraph_name"] == "x_app"
        assert "<svg" in rec.diagram[:300]
    finally:
        server.stop()


def test_two_apps_and_an_aborted_one():
    server = DashboardServer(tcp_port=0, http_port=0).start()
    try:
        for tenant in ("twin_a", "twin_b"):
            _graph("twin_app", server.tcp_port, n=4000, tenant=tenant).run()
        bad = _graph("bad_app", server.tcp_port, n=20_000, boom=True)
        with pytest.raises(ValueError, match="seeded operator crash"):
            bad.run()
        apps = _wait_ended(server, ["twin_app", "bad_app"])
        assert apps["bad_app"].ended
        assert apps["bad_app"].reports[-1].get("Aborted") is True
        with server._lock:
            twins = [a for a in server.apps.values() if a.name == "twin_app"]
        assert len(twins) == 2 and all(a.ended for a in twins)
        assert not any(a.reports[-1].get("Aborted") for a in twins)
        status, body = _get(server.http_port, "/metrics")
        from windflow_tpu.monitoring.openmetrics import parse_exposition
        fams = parse_exposition(body.decode())
        pairs = {(lab.get("app"), lab.get("tenant")) for _, lab, _
                 in fams["wf_operator_outputs_total"]["samples"]}
        assert {("twin_app", "twin_a"), ("twin_app", "twin_b")} <= pairs
    finally:
        server.stop()


def test_monitor_switches_off_when_unreachable_but_keeps_sampling():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()[1]
    s.close()
    g = _graph("headless_app", dead, n=20_000)
    ticks = []
    real = g.health_tick

    def counted():
        ticks.append(1)
        return real()
    g.health_tick = counted
    g.run()
    assert g.is_done() and g._monitor is None
    assert ticks, "the cadence never sampled"
    assert os.path.exists(os.path.join(g.config.log_dir,
                                       "headless_app_stats.json"))


def test_no_monitor_without_tracing():
    g = _graph("quiet_app", 1, n=2000, tracing=False)
    g.run()
    assert g._monitor is None


def test_tick_holds_the_capture_lock():
    """A cadence tick and a CUDA graph capture never overlap: the tick
    waits while a capture holds ``capture_lock``."""
    from windflow_tpu_torch.kernels.ffat_cuda import capture_lock
    g = _graph("lock_app", 1, n=2000, tracing=False)
    g.run()
    m = MonitoringThread(g, interval=0.01)
    done = threading.Event()
    t = threading.Thread(target=lambda: (m._tick(), done.set()))
    with capture_lock:
        t.start()
        assert not done.wait(0.2), "the tick ran during a capture"
    assert done.wait(5.0) and m.samples_taken == 1
    t.join()


def test_svg_fallback_and_dot():
    g = _graph("svg_app", 1, n=10, tracing=False)
    g.run()
    svg = to_svg(g)
    assert svg.lstrip().startswith("<svg") or "<svg" in svg[:400]
    for name in ("src", "map", "gmap", "snk"):
        assert name in svg
    from windflow_tpu_torch.monitoring.diagram import _fallback_svg
    fb = _fallback_svg(g)
    assert fb.startswith("<svg") and fb.count("<rect") == 4
    assert "#ffd700" in fb        # the device operator, gold


def test_webui_has_the_jax_surfaces():
    from windflow_tpu.monitoring.webui import INDEX_HTML as J
    from windflow_tpu_torch.monitoring.webui import INDEX_HTML as T
    for needle in ("/apps", "Latency_plane", "Tenant", "provenance",
                   "esc(", "OVER_BUDGET", "hSLO_VIOLATED"):
        assert needle in T and needle in J, needle


def test_monitoring_and_analysis_import_no_jax():
    """Every module of the port's monitoring and analysis packages, in a
    fresh interpreter, imports neither jax nor windflow_tpu."""
    import windflow_tpu_torch.analysis as an
    import windflow_tpu_torch.monitoring as mon
    mods = ["windflow_tpu_torch"]
    for pkg in (mon, an):
        mods.append(pkg.__name__)
        mods += [f"{pkg.__name__}.{m.name}"
                 for m in pkgutil.iter_modules(pkg.__path__)]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'windflow_tpu' or "
            "m.startswith('windflow_tpu.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    for name in ("calibrate", "calibration", "dashboard", "latency_ledger",
                 "monitor", "openmetrics", "tenant_ledger", "webui"):
        assert f"windflow_tpu_torch.monitoring.{name}" in mods
    assert "windflow_tpu_torch.analysis.latency" in mods
    assert "windflow_tpu_torch.analysis.tenancy" in mods
    # the capture audit and the command-line twins of the JAX tools
    for name in ("ir_audit", "ir", "verify", "advisor", "check"):
        assert f"windflow_tpu_torch.analysis.{name}" in mods
