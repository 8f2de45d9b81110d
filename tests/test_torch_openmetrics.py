"""The port's OpenMetrics exposition (``windflow_tpu_torch/monitoring/
openmetrics.py``) against the JAX package's, on the CPU.

``render_openmetrics`` of both packages over one stats dict gives the same
families, types, labels and values (only HELP texts may name the port's
counterparts); the dicts are the port's own ``stats()`` of traced runs
with every plane on (latency, tenant, roofline, health, sweep, shard,
megastep and wire), JAX's ``stats()`` of the same stream, and hand-made
edge cases.  The strict parsers accept and reject the same texts, and the
dashboard's multi-app merge renders as JAX's.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.io.frames import FrameSource as JFrameSource
from windflow_tpu.monitoring import openmetrics as jom
from windflow_tpu_torch.monitoring import openmetrics as tom

torch.set_num_threads(1)

N, CAP, KEYS = 4096, 256, 8


def _blob(seed=11):
    rng = np.random.default_rng(seed)
    rec = np.zeros(N, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, KEYS, N)
    rec["ts"] = np.arange(N, dtype=np.int64) * 500
    rec["v"] = rng.integers(0, 100, N)
    return rec.tobytes()


def _stats(pkg, **kw):
    blob = _blob()

    def chunks():
        for i in range(0, len(blob), CAP * 24):
            yield blob[i:i + CAP * 24]
    kw = dict(dict(trace_sample_every=1, key_compaction=False,
                   punctuation_interval_usec=10 ** 12, latency_slo_ms=0.001,
                   hbm_budget_bytes=1, tenant="om_tenant"), **kw)
    if pkg is wt:
        cfg, G, src = wt.Config(device="cpu", **kw), "GPU", wt.FrameSource
    else:
        cfg = dataclasses.replace(wf.default_config, **kw)
        G, src = "TPU", JFrameSource
    g = pkg.PipeGraph("om_app", config=cfg, time_policy=pkg.TimePolicy.EVENT)
    g.add_source(src(chunks, nv=1, fields=["v"], output_batch_size=CAP)) \
        .add(getattr(pkg, f"Map{G}_Builder")(
            lambda t: {"key": t["key"], "v": t["v"] * 2.0})
            .withName("m").build()) \
        .add(getattr(pkg, f"Ffat_Windows{G}_Builder")(lambda t: t["v"],
                                                      lambda a, b: a + b)
             .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
             .withMaxKeys(KEYS).withName("win").build()) \
        .add_sink(pkg.Sink_Builder(lambda r: None).withName("snk").build())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.start()
        while not g.is_done():
            if not g.step():
                break
            g.health_tick()
        g.wait_end()
        for _ in range(3):
            g.health_tick()
            g._tenant.ledger.tick(force=True)
    return g.stats()


@pytest.fixture(scope="module")
def stats_dicts():
    return {"port_k1": _stats(wt), "port_k4": _stats(wt, megastep_sweeps=4),
            "jax_k1": _stats(wf)}


def _parsed(mod, text):
    fams = mod.parse_exposition(text)
    return {name: (f["type"], f["samples"]) for name, f in fams.items()}


@pytest.mark.parametrize("which", ["port_k1", "port_k4", "jax_k1"])
def test_render_equals_jax_on_one_stats_dict(stats_dicts, which):
    st = stats_dicts[which]
    t, j = tom.render_openmetrics(st), jom.render_openmetrics(st)
    assert _parsed(tom, t) == _parsed(jom, j)
    strip = [ln for ln in t.splitlines() if not ln.startswith("# HELP")]
    assert strip == [ln for ln in j.splitlines()
                     if not ln.startswith("# HELP")]
    assert _parsed(jom, t) == _parsed(tom, t)


def test_port_stats_reach_every_plane_family(stats_dicts):
    fams = tom.parse_exposition(tom.render_openmetrics(
        stats_dicts["port_k4"]))
    for name in ("wf_latency_segment_usec", "wf_latency_budget_share",
                 "wf_latency_traces_decomposed_total", "wf_slo_active",
                 "wf_slo_budget_ms", "wf_tenant_hbm_bytes",
                 "wf_tenant_budget_pressure", "wf_tenant_over_budget",
                 "wf_tenant_attributed_staged_fraction",
                 "wf_roofline_degraded", "wf_provenance",
                 "wf_operator_health", "wf_sweep_dispatches_per_batch",
                 "wf_end_to_end_latency_usec", "wf_service_latency_usec",
                 "wf_latency_freshness_floor_usec"):
        assert fams[name]["samples"], name
    slo = fams["wf_slo_active"]["samples"]
    assert slo[0][2] == 1
    health = {(lab["operator"], lab["state"]): v for _, lab, v
              in fams["wf_operator_health"]["samples"]}
    assert any(s == "over_budget" and v == 1 for (_, s), v in health.items())
    for _, lab, _ in fams["wf_operator_outputs_total"]["samples"]:
        assert lab["app"] == "om_app" and lab["tenant"] == "om_tenant"


def test_multi_app_merge_equals_jax(stats_dicts):
    reports = [({"app": "a", "app_id": "1"}, stats_dicts["port_k1"]),
               ({"app": "b", "app_id": "2"}, stats_dicts["port_k4"]),
               ({"app": "c", "app_id": "3"}, stats_dicts["jax_k1"])]
    t = tom.render_openmetrics_multi(reports)
    j = jom.render_openmetrics_multi(reports)
    assert _parsed(tom, t) == _parsed(jom, j)
    assert sum(1 for ln in t.splitlines() if ln.startswith("# TYPE")) == \
        len(tom.parse_exposition(t))


def test_label_escaping_round_trips_as_jax():
    nasty = 'evil"op\\name\nnewline'
    stats = {"PipeGraph_name": 'app"with\\quirks',
             "Operators": [{"Operator_name": nasty,
                            "Replicas": [{"Inputs_received": 3,
                                          "Outputs_sent": 2}]}],
             "Tenant": {"enabled": True, "tenant": nasty,
                        "tenants": {nasty: {"resident_state_bytes": 5}}}}
    t = tom.render_openmetrics(stats)
    assert _parsed(tom, t) == _parsed(jom, jom.render_openmetrics(stats))
    fams = tom.parse_exposition(t)
    assert [lab["operator"] for _, lab, _ in
            fams["wf_operator_outputs_total"]["samples"]] == [nasty]
    assert {lab["tenant"] for _, lab, _ in
            fams["wf_tenant_hbm_bytes"]["samples"]} == {nasty}


BAD_TEXTS = {
    "orphan": "wf_orphan 1\n",
    "decreasing": ("# TYPE wf_h histogram\nwf_h_bucket{le=\"1\"} 5\n"
                   "wf_h_bucket{le=\"2\"} 3\nwf_h_bucket{le=\"+Inf\"} 3\n"
                   "wf_h_sum 4\nwf_h_count 3\n"),
    "no_inf": ("# TYPE wf_h histogram\nwf_h_bucket{le=\"1\"} 5\n"
               "wf_h_sum 4\nwf_h_count 5\n"),
    "count": ("# TYPE wf_h histogram\nwf_h_bucket{le=\"+Inf\"} 4\n"
              "wf_h_sum 4\nwf_h_count 5\n"),
    "negative_counter": "# TYPE wf_c_total counter\nwf_c_total -1\n",
    "bad_escape": "# TYPE wf_g gauge\nwf_g{a=\"x\\q\"} 1\n",
    "bad_name": "# TYPE 9bad gauge\n9bad 1\n",
    "type_after_sample": ("# TYPE wf_g gauge\nwf_g 1\n# TYPE wf_g gauge\n"),
    "bad_type": "# TYPE wf_g meter\nwf_g 1\n",
    "suffix_on_gauge": "# TYPE wf_g gauge\nwf_g_sum 1\n",
    "bare_histogram": ("# TYPE wf_h histogram\nwf_h 1\n"),
    "le_outside_bucket": "# TYPE wf_g gauge\nwf_g{le=\"1\"} 1\n",
    "bad_value": "# TYPE wf_g gauge\nwf_g one\n",
}


@pytest.mark.parametrize("name", sorted(BAD_TEXTS))
def test_parser_rejects_as_jax(name):
    text = BAD_TEXTS[name]
    with pytest.raises(ValueError) as te:
        tom.parse_exposition(text)
    with pytest.raises(ValueError) as je:
        jom.parse_exposition(text)
    assert str(te.value) == str(je.value)


def test_parser_accepts_as_jax():
    ok = ("# HELP wf_x_total x\n# TYPE wf_x_total counter\nwf_x_total 1\n"
          "# a free comment\n# TYPE wf_h histogram\n"
          "wf_h_bucket{le=\"1\",op=\"a\\\"b\"} 1\n"
          "wf_h_bucket{le=\"+Inf\",op=\"a\\\"b\"} 2\n"
          "wf_h_sum{op=\"a\\\"b\"} 3.5\nwf_h_count{op=\"a\\\"b\"} 2\n"
          "# TYPE wf_g gauge\nwf_g NaN\nwf_g +Inf 1700000000\n")
    assert _parsed(tom, ok) == _parsed(jom, ok)
