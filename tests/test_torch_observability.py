"""The observability plane of the port against the JAX package's
(``windflow_tpu_torch/monitoring`` vs ``windflow_tpu/monitoring``), on
the CPU: the latency histogram, span ring, sampling and Chrome-trace
families of ``tests/test_observability.py`` (the port's Chrome trace equal
to JAX's on the same events), the flight recorder through a graph, the
``stats()`` section key sets, the ``Device`` section's schema and CPU
guard with ``tools/wf_metrics.py --check`` over ``dump_stats``, the
sweep ledger's dispatch counts of ``tests/test_sweep_ledger.py`` (equal
to JAX's on the same graph; the chained pair one dispatch), ``to_dot``,
and the recorder-off path, checked structurally (nothing installed,
nothing called)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import default_config as jax_default_config
from windflow_tpu.monitoring import recorder as jrec
from windflow_tpu_torch.monitoring import recorder as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(pkg, **kw):
    if pkg is wt:
        kw.setdefault("device", "cpu")
        return wt.Config(**kw)
    return dataclasses.replace(jax_default_config, **kw)


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


# ---------------------------------------------------------------------------
# LatencyHistogram, ReplicaRing, sampling, Chrome trace: port == JAX
# ---------------------------------------------------------------------------

SAMPLE_SETS = {
    "empty": [],
    "single": [137.0],
    "boundaries": [0, 1, 2, 255, 256, 257],
    "range": [float(i) for i in range(1000)],
    "negative_and_huge": [-5.0, 3.5, 2.0 ** 70, 12345.678],
    "lognormal": list(np.random.default_rng(7).lognormal(6, 2, 500)),
}


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_histogram_quantiles_equal_jax(name):
    t, j = trec.LatencyHistogram(), jrec.LatencyHistogram()
    for v in SAMPLE_SETS[name]:
        t.add(v)
        j.add(v)
    assert t.quantiles() == j.quantiles()
    for p in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0):
        assert t.percentile(p) == j.percentile(p)
    assert t.bucket_counts() == j.bucket_counts()


def test_histogram_edges():
    h = trec.LatencyHistogram()
    assert h.percentile(0.5) == 0.0
    assert h.quantiles()["count"] == 0
    h.add(137.0)
    for p in (0.0, 0.5, 0.99, 1.0):
        assert h.percentile(p) == 137.0     # one sample reports itself
    g = trec.LatencyHistogram()
    for i in range(1000):
        g.add(float(i))
    p50, p95, p99 = (g.percentile(p) for p in (0.5, 0.95, 0.99))
    assert 256 <= p50 < 1024 and p50 <= p95 <= p99 <= g.max


def test_histogram_merge_equals_jax():
    a, b = trec.LatencyHistogram(), trec.LatencyHistogram()
    ja, jb = jrec.LatencyHistogram(), jrec.LatencyHistogram()
    for v in (10, 20, 30):
        a.add(v)
        ja.add(v)
    for v in (1000, 5):
        b.add(v)
        jb.add(v)
    assert a.merge(b).quantiles() == ja.merge(jb).quantiles()
    assert a.min == 5 and a.max == 1000


def test_ring_wraps_and_equals_jax():
    r, j = trec.ReplicaRing("op", 3, 16), jrec.ReplicaRing("op", 3, 16)
    for i in range(40):
        r.record(i, i % 6, 1000 + i, shared=i % 3)
        j.record(i, i % 6, 1000 + i, shared=i % 3)
    ev = r.events()
    assert len(ev) == 16 and r.n == 40
    assert ev[0]["trace"] == 24 and ev[-1]["trace"] == 39
    assert ev == j.events()


def test_recorder_sampling_equals_jax():
    t, j = trec.FlightRecorder(sample_every=4), jrec.FlightRecorder(
        sample_every=4)
    tp = [t.maybe_trace() for _ in range(40)]
    jp = [j.maybe_trace() for _ in range(40)]
    assert [x is None for x in tp] == [x is None for x in jp]
    assert sum(x is not None for x in tp) == 10
    assert [x[0] for x in tp if x] == [x[0] for x in jp if x]
    assert trec.STAGE_NAMES == jrec.STAGE_NAMES


def _events(n=30, seed=3):
    rng = np.random.default_rng(seed)
    return [{"op": f"op{int(rng.integers(3))}",
             "replica": int(rng.integers(2)), "trace": int(i // 4),
             "stage": trec.STAGE_NAMES[int(rng.integers(6))],
             "t_usec": int(1_000_000 + rng.integers(10_000)),
             "shared_k": 0} for i in range(n)]


@pytest.mark.parametrize("n", [0, 1, 30])
def test_chrome_trace_equals_jax(n):
    ev = _events(n)
    meta = {"profiler_dir": "x", "sweep": {"enabled": False}}
    assert trec.chrome_trace_from_events(ev) == \
        jrec.chrome_trace_from_events(ev)
    assert trec.chrome_trace_from_events(ev, meta) == \
        jrec.chrome_trace_from_events(ev, meta)


# ---------------------------------------------------------------------------
# the recorder through a graph
# ---------------------------------------------------------------------------

def _graph(pkg, cfg, n=4000, cap=512, name="obs_app", chained=False,
           three=False):
    seen = []
    src = (pkg.Source_Builder(
        lambda: iter({"key": np.int32(i % 8), "v": np.float32(i)}
                     for i in range(n)))
        .withName("src").withOutputBatchSize(cap).build())
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT, config=cfg)
    pipe = g.add_source(src)
    pipe.add(_dev(pkg, "Map")(lambda t: {"key": t["key"],
                                         "v": t["v"] * 2.0})
             .withName("ma").build())
    if three:
        fb = (_dev(pkg, "Filter")(lambda t: (t["key"] & 1) == 0)
              .withName("fb").build())
        pipe.chain(fb) if chained else pipe.add(fb)
        pipe.add(_dev(pkg, "Map")(lambda t: {"key": t["key"],
                                             "v": t["v"] + 1.0})
                 .withName("mc").build())
    pipe.add_sink(pkg.Sink_Builder(
        lambda t, ctx=None: seen.append(t) if t is not None else None)
        .withName("snk").build())
    return g, seen


@pytest.fixture(scope="module")
def traced_runs(tmp_path_factory):
    """One traced run per package of the same graph (1 batch in 2)."""
    d = tmp_path_factory.mktemp("obs")
    out = {}
    for pkg in (wt, wf):
        cfg = _cfg(pkg, trace_sample_every=2, log_dir=str(d / pkg.__name__))
        g, seen = _graph(pkg, cfg)
        g.run()
        out[pkg] = (g, g.stats(), seen)
    return out


def test_traced_run_records_and_latency(traced_runs):
    g, st, seen = traced_runs[wt]
    _, jst, jseen = traced_runs[wf]
    assert sorted((r["key"], r["v"]) for r in seen) == \
        sorted((r["key"], r["v"]) for r in jseen)
    fr, jfr = st["Flight_recorder"], jst["Flight_recorder"]
    assert fr["enabled"] is True
    assert fr["traces_started"] == jfr["traces_started"] > 0
    assert fr["events_recorded"] >= 3 * fr["traces_started"]
    stages = {e["stage"] for e in g._recorder.events()}
    assert {"staged", "dispatched", "collected", "sunk"} <= stages
    lat = st["Latency"]
    assert lat["end_to_end_usec"]["count"] == \
        jst["Latency"]["end_to_end_usec"]["count"] > 0
    assert 0 < lat["end_to_end_usec"]["p50"] <= lat["end_to_end_usec"]["p99"]
    assert set(lat["service_usec_per_operator"]) == {"src", "ma", "snk"}
    assert st["Bytes_H2D_total"] > 0 and st["Bytes_D2H_total"] > 0
    ma = next(o for o in st["Operators"] if o["Operator_name"] == "ma")
    rj = ma["Replicas"][0]
    assert rj["Service_latency_usec"]["count"] > 0
    assert set(rj) == set(next(
        o for o in jst["Operators"] if o["Operator_name"] == "ma")
        ["Replicas"][0])


def trace_stamps_ordered(events) -> int:
    """staged ≤ dispatched ≤ device_done ≤ sunk for every trace that
    reached a sink (each stage's first stamp; a trace is collected at
    every hop).  Returns the number of such traces."""
    by = {}
    for e in events:
        by.setdefault(e["trace"], {}).setdefault(e["stage"], e["t_usec"])
    sunk = 0
    for t in by.values():
        assert "staged" in t or "emitted" in t
        if "sunk" not in t:
            continue
        sunk += 1
        seq = [t[s] for s in ("staged", "dispatched", "device_done", "sunk")
               if s in t]
        assert seq == sorted(seq), t
    return sunk


def test_every_trace_is_ordered(traced_runs):
    assert trace_stamps_ordered(traced_runs[wt][0]._recorder.events()) > 0


def test_device_done_sampling_and_is_terminated():
    cfg = _cfg(wt, trace_sample_every=1, trace_device_sync_every=2)
    g, _ = _graph(wt, cfg, n=4000, cap=256, name="dd")
    g.start()
    reps = [r for o in g.stats()["Operators"] for r in o["Replicas"]]
    assert not any(r["Is_terminated"] for r in reps)
    g.wait_end()
    reps = [r for o in g.stats()["Operators"] for r in o["Replicas"]]
    assert all(r["Is_terminated"] for r in reps)
    ev = g._recorder.events()
    done = [e for e in ev if e["stage"] == "device_done"]
    disp = [e for e in ev if e["stage"] == "dispatched"]
    assert len(disp) == 16 and len(done) == 8


def test_dump_trace_schema_and_export_tool(traced_runs, tmp_path):
    g = traced_runs[wt][0]
    path = g.dump_trace(str(tmp_path / "app_trace.json"))
    with open(path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"]
    assert {e["ph"] for e in evs} >= {"i", "b", "e", "M"}
    opens = {}
    for e in evs:
        if e["ph"] in "be":
            k = (e["id"], e["name"])
            opens[k] = opens.get(k, 0) + (1 if e["ph"] == "b" else -1)
    assert all(v == 0 for v in opens.values())
    other = trace["otherData"]
    assert "trace:<trace_id>" in other["profiler_annotation_format"]
    assert other["profiler_dir"] and other["sweep"]["enabled"] is True
    assert (tmp_path / "app_events.json").exists()
    out = tmp_path / "re_trace.json"
    tool = os.path.join(REPO, "tools", "trace_export.py")
    r = subprocess.run([sys.executable, tool,
                        str(tmp_path / "app_events.json"), "-o", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run([sys.executable, tool, "--check", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr


def test_gauges_shape(traced_runs):
    st = traced_runs[wt][1]
    gau = st["Gauges"]
    assert set(gau) == set(traced_runs[wf][1]["Gauges"])
    assert set(gau["operators"]) == {"src", "ma", "snk"}
    assert all(o["queue_depth"] == 0 for o in gau["operators"].values())
    assert gau["throughput_1s_tps"] >= 0.0


# ---------------------------------------------------------------------------
# stats(): JAX's section keys
# ---------------------------------------------------------------------------

#: sections whose key sets are held against JAX's
PORTED = ("Flight_recorder", "Latency", "Gauges", "Health", "Device",
          "Sweep", "Shard", "Staging_pool", "Preflight")


def test_stats_sections_have_jax_keys(traced_runs):
    st, jst = traced_runs[wt][1], traced_runs[wf][1]
    # the port's host spans (monitoring/recorder.py) and the wavefront's
    # device counters have no JAX twin: spans off in this run (no
    # tracing_enabled, no profiler), no stateful operator
    assert set(st) == set(jst) | {"Spans", "Stateful"}
    assert st["Stateful"] == {}
    assert st["Spans"] == {"enabled": False}
    for sec in PORTED:
        # the port's Preflight section also lists the passes that ran
        extra = {"passes"} if sec == "Preflight" else set()
        assert set(st[sec]) == set(jst[sec]) | extra, sec
    for sec in ("Health", "Sweep", "Shard"):
        for sub in ("totals", "thresholds", "fusion", "wire"):
            if sub in jst[sec]:
                assert set(st[sec][sub]) == set(jst[sec][sub]), (sec, sub)
    assert set(st["Health"]["verdicts"]["ma"]) == \
        set(jst["Health"]["verdicts"]["ma"])
    assert set(st["Shard"]["per_op"]["ma"]["replicas"][0]) <= \
        set(jst["Shard"]["per_op"]["ma"]["replicas"][0]) | {"hbm_bytes"}
    for sec in ("Latency_plane", "Tenant", "Roofline"):
        assert st[sec]["enabled"] and set(st[sec]) == set(jst[sec]), sec
    # the capture audit's section: JAX's keys, plus the recorded
    # programs and the sanctioned host reads seen
    assert st["IR_audit"]["enabled"] and jst["IR_audit"]["enabled"]
    assert set(st["IR_audit"]) == set(jst["IR_audit"]) | {
        "programs", "exempt_host_reads"}
    assert st["Reshard"] == {"enabled": False}
    json.dumps(st)


def test_device_section_schema_and_cpu_guard(traced_runs):
    dev = traced_runs[wt][1]["Device"]
    jdev = traced_runs[wf][1]["Device"]
    assert set(dev) == set(jdev)
    assert set(dev["staging"]) == set(jdev["staging"])
    e = dev["jit"]["ma"]
    assert e["dispatches"] >= 8 and e["compiles"] == 0
    assert e["cost"] is None and e["provenance"]
    assert set(e) - {"provenance"} == set(jdev["jit"]["ma"])
    assert dev["jit_totals"]["compiles"] >= 0
    assert set(dev["jit_totals"]) == set(jdev["jit_totals"])
    assert dev["memory"] == [{"device": "cpu", "platform": "cpu",
                              "stats": None}]
    assert dev["live_buffers"]["count"] == 0
    assert dev["staging"]["staged_device_bytes_total"] > 0
    assert dev["staging"]["staged_device_batches_total"] > 0


def test_wf_metrics_check_over_dump_stats(traced_runs, tmp_path):
    g = traced_runs[wt][0]
    path = g.dump_stats(str(tmp_path))
    tool = os.path.join(REPO, "tools", "wf_metrics.py")
    r = subprocess.run([sys.executable, tool, path, "--check"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr


# ---------------------------------------------------------------------------
# the sweep ledger: dispatch counts equal JAX's
# ---------------------------------------------------------------------------

N_BATCHES, SWEEP_CAP = 8, 256


@pytest.mark.parametrize("chained", [False, True], ids=["pair", "chained"])
def test_sweep_dispatches_equal_jax(chained):
    hops = {}
    for pkg in (wt, wf):
        g, _ = _graph(pkg, _cfg(pkg, whole_chain_fusion=False),
                      n=N_BATCHES * SWEEP_CAP, cap=SWEEP_CAP,
                      name="sweep_app", chained=chained, three=True)
        g.run()
        hops[pkg] = g.stats()["Sweep"]
    sw, jsw = hops[wt], hops[wf]
    names = ("ma|fb", "mc") if chained else ("ma", "fb", "mc")
    assert sorted(sw["per_hop"]) == sorted(jsw["per_hop"]) == sorted(names)
    for name in names:
        h, jh = sw["per_hop"][name], jsw["per_hop"][name]
        for k in ("batches", "dispatches", "dispatches_per_batch",
                  "capacity", "resident_output"):
            assert h[k] == jh[k], (name, k, h[k], jh[k])
        assert h["dispatches"] == N_BATCHES
        assert h["bytes_provenance"] == "tensor-bytes"
        assert h["bytes_per_tuple"] > 0 and h["donation_miss"] is None
    total = 2.0 if chained else 3.0
    assert sw["totals"]["dispatches_per_batch"] == \
        jsw["totals"]["dispatches_per_batch"] == total
    assert sw["per_hop"]["mc"]["resident_output"] is False


def test_fused_hop_shows_one_dispatch_a_batch():
    g, _ = _graph(wt, _cfg(wt), n=N_BATCHES * SWEEP_CAP, cap=SWEEP_CAP,
                  name="fused_sweep", three=True)
    g.run()
    sw = g.stats()["Sweep"]
    assert sw["per_hop"]["ma"]["fused_into"] == "ma|fb|mc"
    assert sw["per_hop"]["fb"]["dispatches"] == 0
    host = sw["per_hop"]["mc"]
    assert host["fused_program"] == "ma|fb|mc"
    assert host["dispatches"] == N_BATCHES == host["batches"]
    chain = sw["fusion"]["chains"][0]
    assert chain["dispatches_per_batch"] == 1.0
    assert chain["dispatches_saved_per_batch"] == 2.0


# ---------------------------------------------------------------------------
# to_dot; the recorder off
# ---------------------------------------------------------------------------

def test_to_dot_names_every_operator_and_edge():
    g, _ = _graph(wt, _cfg(wt), name="dot_app", three=True)
    dot = g.to_dot()       # a composed graph draws too
    assert dot.startswith('digraph "dot_app" {') and dot.endswith("}")
    for name in ("src", "ma", "fb", "mc", "snk"):
        assert f'label="{name}\\n' in dot
    assert dot.count(" -> ") == 4 and "[GPU]" in dot
    g.run()
    assert g.to_dot().count(" -> ") == 4


def test_recorder_off_installs_nothing_and_calls_nothing(monkeypatch):
    """The off path, structurally: no recorder, no rings, no trace lane
    on any batch, no sampling call and no ``record_function``."""
    import torch.autograd.profiler as tap
    calls = {"trace": 0, "annotate": 0}
    real_trace = trec.FlightRecorder.maybe_trace

    def counting_trace(self):
        calls["trace"] += 1
        return real_trace(self)

    class Annotation:
        def __init__(self, *a, **k):
            calls["annotate"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(trec.FlightRecorder, "maybe_trace", counting_trace)
    monkeypatch.setattr(tap, "record_function", Annotation)
    g, _ = _graph(wt, _cfg(wt, flight_recorder=False), name="off_app")
    g.start()
    seen = []
    snk_rep = [o for o in g._operators if o.name == "snk"][0].replicas[0]
    orig = snk_rep.receive
    snk_rep.receive = lambda ch, msg: (seen.append(
        getattr(msg, "trace", None)), orig(ch, msg))
    g.wait_end()
    assert g._recorder is None
    assert all(r.ring is None for r in g._all_replicas)
    assert all(r.emitter is None or r.emitter.flight is None
               for r in g._all_replicas)
    assert seen and all(t is None for t in seen)
    assert calls == {"trace": 0, "annotate": 0}
    st = g.stats()
    assert st["Flight_recorder"] == {"enabled": False}
    assert st["Latency"]["end_to_end_usec"]["count"] == 0
    with pytest.raises(wt.WindFlowError):
        g.dump_trace()
    # and on: the traced batches are annotated
    g2, _ = _graph(wt, _cfg(wt, trace_sample_every=2), name="on_app")
    g2.run()
    assert calls["trace"] > 0 and calls["annotate"] > 0


def test_profile_writes_a_capture_with_the_traced_annotation(tmp_path):
    """``profile()`` drives a started graph under ``torch.profiler`` and
    writes a Chrome trace whose CPU spans carry ``op:<name>
    trace:<id>`` for the traced steps."""
    g, seen = _graph(wt, _cfg(wt, trace_sample_every=1,
                              log_dir=str(tmp_path)), name="prof_app")
    g.start()
    d = g.profile(duration_ms=60_000, log_dir=str(tmp_path / "prof"))
    g.wait_end()
    assert seen and g._last_profile_dir == d
    with open(os.path.join(d, "prof_app_profile.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("op:ma trace:") for n in names)
    with pytest.raises(wt.WindFlowError, match="started"):
        _graph(wt, _cfg(wt), name="cold")[0].profile(1)
