"""The port's tenant plane (``windflow_tpu_torch/monitoring/
tenant_ledger.py``, ``analysis/tenancy.py``) against the JAX package's
(``tests/test_tenant_plane.py``), on the CPU with ``Config(device="cpu")``.

Two seeded graphs (a Zipf-hot tenant and a uniform one) run in one
process through each package.  The tenant sections agree key by key:
dispatches, staged and fetched bytes, the resident device bytes of each
operator (the window state has the JAX layout), the heaviest operator
and the attributed fraction, exact.  Each tenant's bytes are its graph's
own ``Bytes_H2D_total``/``Bytes_D2H_total``.  The budget state machine
steps as JAX's on the same levels, ``OVER_BUDGET`` is painted on the
heaviest operator only, the advisor plans as JAX's, the tenant
scheduler (``serving/tenant_scheduler.py``) queues that plan as JAX's
does and refuses contract drift, and JAX's
``tools/wf_tenant.py`` and ``tools/wf_doctor.py`` read the port's dumps
unchanged.  The resident walk counts a storage once however many views
reach it.  The off path is checked structurally.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.analysis import tenancy as jten
from windflow_tpu.monitoring import tenant_ledger as jtl
from windflow_tpu_torch.analysis import tenancy as tten
from windflow_tpu_torch.monitoring import tenant_ledger as ttl
from windflow_tpu_torch.monitoring.health import OVER_BUDGET
from windflow_tpu_torch.monitoring.openmetrics import (parse_exposition,
                                                       render_openmetrics)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CAP, KEYS = 4096, 256, 8


def _graph(pkg, name, tenant, prefix, keys_fn, budget=0, n=N, **cfg_kw):
    """Source → map → CB window → sink, with per-graph op names."""
    kw = dict(tenant=tenant, hbm_budget_bytes=budget, **cfg_kw)
    if pkg is wt:
        cfg, G = wt.Config(device="cpu", **kw), "GPU"
    else:
        cfg, G = dataclasses.replace(wf.default_config, **kw), "TPU"
    src = (pkg.Source_Builder(
        lambda: iter({"key": keys_fn(i), "v": float(i)} for i in range(n)))
        .withName(f"{prefix}_src").withOutputBatchSize(CAP).build())
    m = (getattr(pkg, f"Map{G}_Builder")(
        lambda t: {"key": t["key"], "v": t["v"] * 2.0})
        .withName(f"{prefix}_map").build())
    w = (getattr(pkg, f"Ffat_Windows{G}_Builder")(lambda t: t["v"],
                                                  lambda a, b: a + b)
         .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
         .withMaxKeys(KEYS).withName(f"{prefix}_win").build())
    snk = pkg.Sink_Builder(lambda r: None).withName(f"{prefix}_snk").build()
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT, config=cfg)
    g.add_source(src).add(m).add(w).add_sink(snk)
    return g


def _drive(g):
    g.start()
    while not g.is_done():
        if not g.step():
            break
        g.health_tick()
    g.wait_end()
    g.health_tick()


def _ledger(pkg):
    return (ttl if pkg is wt else jtl).default_ledger()


def _two(pkg):
    led = _ledger(pkg)
    led.reset()
    graphs = {}
    for tenant, prefix, fn in (("acme", "za", lambda i: 0 if i % 4
                                else i % KEYS),
                               ("blue", "zb", lambda i: i % KEYS)):
        g = _graph(pkg, f"ten_{tenant}_app", tenant, prefix, fn,
                   budget=64 << 20)
        _drive(g)
        graphs[tenant] = g
    return graphs, led.section(), {t: g.stats() for t, g in graphs.items()}


@pytest.fixture(scope="module")
def two_tenants():
    return {wt: _two(wt), wf: _two(wf)}


def _comparable(sec):
    out = {}
    for name, agg in sec["tenants"].items():
        row = {k: agg[k] for k in ("graphs", "dispatches", "h2d_bytes",
                                   "h2d_logical_bytes", "d2h_bytes",
                                   "resident_state_bytes", "heaviest_op",
                                   "ici_bytes_per_tuple")}
        row["per_op"] = {op: {k: v for k, v in d.items()
                              if k != "compile_ms"}
                         for op, d in agg["per_op"].items()}
        b = dict(agg["budget"])
        row["budget"] = b
        out[name] = row
    return out, sec["attributed"]


def test_sections_equal_jax(two_tenants):
    t, j = two_tenants[wt][1], two_tenants[wf][1]
    assert _comparable(t) == _comparable(j)
    assert t["attributed"]["staged_fraction"] == 1.0


def test_attribution_sums_to_graph_totals(two_tenants):
    graphs, sec, stats = two_tenants[wt]
    assert set(sec["tenants"]) == {"acme", "blue"}
    for tenant, g in graphs.items():
        agg, st = sec["tenants"][tenant], stats[tenant]
        assert agg["h2d_bytes"] == st["Bytes_H2D_total"] > 0
        assert agg["h2d_logical_bytes"] == st["Bytes_H2D_logical_total"]
        assert agg["d2h_bytes"] == st["Bytes_D2H_total"]
        assert agg["graphs"] == [g.name]
        assert agg["dispatches"] > 0 and agg["resident_state_bytes"] > 0
        assert all(op.startswith(("za_", "zb_")) for op in agg["per_op"])
        assert agg["heaviest_op"] in agg["per_op"]
        assert not agg["budget"]["active"]


def test_staged_fraction_reconciles(two_tenants):
    att = two_tenants[wt][1]["attributed"]
    assert att["staged_bytes_process_total"] > 0
    assert att["staged_fraction"] >= 0.9
    assert att["staged_bytes_tenants_total"] == sum(
        t["h2d_bytes"] for t in two_tenants[wt][1]["tenants"].values())


def test_stats_tenant_section_focuses_own_graph(two_tenants):
    graphs, _, stats = two_tenants[wt]
    for tenant, g in graphs.items():
        ten = stats[tenant]["Tenant"]
        assert ten["tenant"] == tenant and ten["graph"]["graph"] == g.name
        assert set(ten["tenants"]) == {"acme", "blue"}


def test_dump_trace_carries_tenant(two_tenants, tmp_path):
    g = two_tenants[wt][0]["acme"]
    with open(g.dump_trace(str(tmp_path / "t.json"))) as f:
        other = json.load(f)["otherData"]
    assert other["tenant"]["tenant"] == "acme"
    assert other["calibration"]["schema"] == "wf-calibration/1"


# ---------------------------------------------------------------------------
# the budget state machine
# ---------------------------------------------------------------------------

def test_tenant_track_steps_as_jax():
    t, j = ttl._TenantTrack("t", 100), jtl._TenantTrack("t", 100)
    levels = [150, 150, 160, 50, 50, 50, 150, 150, 90, 200, 200, 200]
    for lv in levels:
        t.tick(lv, "g", "op")
        j.tick(lv, "g", "op")
        assert t.budget_json(lv) == j.budget_json(lv)
    assert t.entered == 2 and t.cleared == 1 and t.active
    assert (ttl.ENTER_AFTER, ttl.CLEAR_AFTER) == \
        (jtl.ENTER_AFTER, jtl.CLEAR_AFTER)


def test_tenant_track_no_budget_is_inert():
    tr = ttl._TenantTrack("t", budget_bytes=0)
    for _ in range(10):
        tr.tick(1 << 40, "g", "op")
    assert not tr.active and tr.entered == 0
    assert tr.budget_json(1 << 40)["pressure"] is None


def test_over_budget_paints_health_on_heaviest_op_and_latches():
    led = _ledger(wt)
    g = _graph(wt, "ten_ob_app", "ob_tenant", "ob", lambda i: i % KEYS,
               budget=1)
    _drive(g)
    for _ in range(ttl.ENTER_AFTER):
        led.tick(tenant="ob_tenant", force=True)
    ten = g.stats()["Tenant"]
    bud = ten["tenants"]["ob_tenant"]["budget"]
    assert bud["active"] and bud["pressure"] > 1.0
    v = bud["verdict"]
    assert v["state"] == "OVER_BUDGET" and v["graph"] == g.name
    heaviest = v["heaviest_op"]
    assert heaviest == "ob_win"
    g.health_tick()
    h = g.stats()["Health"]
    assert h["graph_state"] == OVER_BUDGET
    for name, hv in h["verdicts"].items():
        if name == heaviest:
            assert hv["state"] == OVER_BUDGET
            assert hv["over_budget"]["message"] == v["message"]
        else:
            assert hv["state"] != OVER_BUDGET and "over_budget" not in hv
    assert led.verdict_for(g.name) is not None
    fams = parse_exposition(render_openmetrics(g.stats()))
    over = {lab["tenant"]: val for _, lab, val
            in fams["wf_tenant_over_budget"]["samples"]}
    assert over["ob_tenant"] == 1


def test_off_path_never_registers():
    g = _graph(wt, "ten_off_app", "off_tenant", "off", lambda i: i % KEYS,
               tenant_ledger=False)
    _drive(g)
    assert g._tenant is None
    assert g._health is None or g._health.tenant is None
    assert g.stats()["Tenant"] == {"enabled": False}
    assert "off_tenant" not in _ledger(wt).section()["tenants"]


# ---------------------------------------------------------------------------
# the resident-bytes walk
# ---------------------------------------------------------------------------

class _Obj:
    def __init__(self, name, **kw):
        self.name = name
        self.__dict__.update(kw)


def test_resident_walk_counts_each_storage_once():
    base = torch.zeros(1000, dtype=torch.float32)
    other = torch.ones(10, dtype=torch.int64)
    a = _Obj("a", t=base, view=base[10:20], nested={"x": [base.view(10, 100)]})
    b = _Obj("b", again=base, other=other, meta=torch.empty(4, device="meta"))
    per = {}
    total = ttl._resident_state_bytes([a, b], torch.device("cpu"), per)
    assert total == 4000 + 80
    assert per == {"a": 4000, "b": 80}
    assert ttl._resident_state_bytes([a], "cuda") == 0


def test_resident_bytes_of_a_window_are_its_state_tensors(two_tenants):
    graphs, sec, _ = two_tenants[wt]
    op = next(o for o in graphs["blue"]._operators if o.name == "zb_win")
    seen = set()
    want = 0
    for leaf in _tensors(op.__dict__):
        st = leaf.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            want += st.nbytes()
    got = sec["tenants"]["blue"]["per_op"]["zb_win"]["resident_bytes"]
    assert got > 0 and got <= want


def _tensors(obj, depth=4):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif depth and isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, depth - 1)
    elif depth and isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, depth - 1)
    elif depth and hasattr(obj, "__dict__") and not isinstance(obj, type):
        yield from _tensors(vars(obj), depth - 1)


# ---------------------------------------------------------------------------
# the advisor, OpenMetrics and JAX's tools on the port's dumps
# ---------------------------------------------------------------------------

def _synthetic_section():
    def agg(graphs, resident, per_op, heaviest, budget=None,
            latency_share=None):
        out = {"graphs": graphs, "dispatches": 10, "compile_ms": 1.0,
               "h2d_bytes": 1000, "h2d_logical_bytes": 1000,
               "d2h_bytes": 100, "resident_state_bytes": resident,
               "ici_bytes_per_tuple": 0.0, "latency_usec_total": 0.0,
               "latency_share": latency_share, "per_op": per_op,
               "heaviest_op": heaviest}
        if budget is not None:
            out["budget"] = budget
        return out
    hog_v = {"state": "OVER_BUDGET", "tenant": "hog", "hbm_bytes": 250,
             "budget_bytes": 100, "overage_bytes": 150, "graph": "hog_g",
             "heaviest_op": "h_win", "message": "hog over"}
    return {
        "enabled": True,
        "tenants": {
            "hog": agg(["hog_g"], 250,
                       {"h_win": {"dispatches": 5, "resident_bytes": 200},
                        "h_map": {"dispatches": 5, "resident_bytes": 50}},
                       "h_win",
                       budget={"budget_bytes": 100, "hbm_bytes": 250,
                               "pressure": 2.5, "active": True,
                               "entered": 1, "cleared": 0,
                               "verdict": hog_v, "last_verdict": hog_v}),
            "warm": agg(["warm_g"], 50,
                        {"w_map": {"dispatches": 8, "resident_bytes": 50}},
                        "w_map", latency_share=0.7,
                        budget={"budget_bytes": 1000, "hbm_bytes": 50,
                                "pressure": 0.05, "active": False,
                                "entered": 0, "cleared": 0,
                                "verdict": None, "last_verdict": None}),
            "idle": agg(["idle_g"], 10,
                        {"i_map": {"dispatches": 1, "resident_bytes": 10}},
                        "i_map"),
        },
        "attributed": {"staged_bytes_tenants_total": 3000,
                       "staged_bytes_process_total": 3000,
                       "staged_fraction": 1.0},
    }


def test_advisor_plan_equals_jax(two_tenants):
    for sec in (_synthetic_section(), two_tenants[wt][1]):
        assert tten.plan(sec) == jten.plan(sec)
        assert tten.rank(sec) == jten.rank(sec)
    kinds = [a["kind"] for t in tten.plan(_synthetic_section())["tenants"]
             for a in t["actions"]]
    assert kinds == ["throttle_admission", "rescale_tenant",
                     "drain_shards", "rebalance_hot_tenant"]


# ---------------------------------------------------------------------------
# the tenant scheduler consumes the plan (tests/test_tenant_plane.py:358-393)
# ---------------------------------------------------------------------------

def test_tenant_scheduler_consumes_plan():
    """The port's scheduler queues the port's plan exactly as the JAX
    scheduler queues the JAX plan."""
    from windflow_tpu.serving import TenantScheduler as JSched
    from windflow_tpu_torch.serving import TenantScheduler
    from windflow_tpu_torch.serving.tenant_scheduler import (
        default_scheduler)
    sched, jsched = TenantScheduler(), JSched()
    assert sched.ingest(tten.plan(_synthetic_section())) == 4 \
        == jsched.ingest(jten.plan(_synthetic_section()))
    assert sched.plans_ingested == 1
    pending = sched.pending()
    assert pending == jsched.pending()
    assert [a["kind"] for a in pending] == [
        "throttle_admission", "rescale_tenant", "drain_shards",
        "rebalance_hot_tenant"]
    assert pending[0]["tenant"] == "hog"
    first = sched.apply_next()
    assert first == jsched.apply_next()
    assert first["kind"] == "throttle_admission"
    assert first["applied"] is False
    assert len(sched.pending()) == 3
    assert sched.section() == jsched.section()
    assert sched.section()["timeline"] == [first]
    assert default_scheduler() is default_scheduler()


def test_tenant_scheduler_rejects_contract_drift():
    from windflow_tpu_torch.serving import TenantScheduler
    sched = TenantScheduler()
    with pytest.raises(ValueError, match="tenancy/1"):
        sched.ingest({"advisor": "tenancy/2", "tenants": []})
    with pytest.raises(ValueError, match="unknown action kind"):
        sched.ingest({"advisor": "tenancy/1", "tenants": [
            {"tenant": "x", "actions": [{"kind": "evict_tenant"}]}]})
    with pytest.raises(ValueError, match="missing required field"):
        sched.ingest({"advisor": "tenancy/1", "tenants": [
            {"tenant": "x",
             "actions": [{"kind": "throttle_admission"}]}]})
    assert sched.rejected_plans == 3 and not sched.pending()


def test_openmetrics_tenant_families_carry_the_section(two_tenants):
    st = two_tenants[wt][2]["acme"]
    fams = parse_exposition(render_openmetrics(st))
    for tenant, agg in st["Tenant"]["tenants"].items():
        for fam, key in (("wf_tenant_hbm_bytes", "resident_state_bytes"),
                         ("wf_tenant_dispatches_total", "dispatches"),
                         ("wf_tenant_h2d_bytes_total", "h2d_bytes")):
            rows = {lab["tenant"]: val for _, lab, val
                    in fams[fam]["samples"]}
            assert rows[tenant] == agg[key]
    for _, lab, _ in fams["wf_operator_outputs_total"]["samples"]:
        assert lab["tenant"] == "acme"


def _tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", name),
                           *args], capture_output=True, text=True,
                          timeout=60)


def test_wf_tenant_reads_the_port_dump(two_tenants, tmp_path):
    path = tmp_path / "stats.json"
    path.write_text(json.dumps(two_tenants[wt][2]["acme"]))
    r = _tool("wf_tenant.py", "--check", "--stats", str(path))
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr + r.stdout
    r = _tool("wf_tenant.py", "--json", "--stats", str(path))
    assert json.loads(r.stdout) == jten.plan(
        two_tenants[wt][2]["acme"]["Tenant"])


def test_wf_tenant_check_gates_the_port_over_budget(tmp_path):
    led = _ledger(wt)
    led.reset()
    g = _graph(wt, "ten_gate_app", "gate", "ga", lambda i: i % KEYS,
               budget=1, log_dir=str(tmp_path))
    _drive(g)
    for _ in range(ttl.ENTER_AFTER):
        led.tick(tenant="gate", force=True)
    path = g.dump_stats()
    r = _tool("wf_tenant.py", "--check", "--stats", path)
    assert r.returncode == 1 and "OVER BUDGET" in r.stdout
    r = _tool("wf_tenant.py", "--stats", path)
    assert r.returncode == 0 and "rescale_tenant" in r.stdout
    bundle = g.dump_postmortem(str(tmp_path / "pm"))
    r = _tool("wf_doctor.py", "--check", bundle)
    assert r.returncode == 0, r.stderr
    r = _tool("wf_doctor.py", bundle)
    assert "tenancy:" in r.stdout and "OVER BUDGET (latched)" in r.stdout


def test_tick_reads_no_shard_sketch(monkeypatch):
    """The budget tick reads tensor metadata and host counters only: the
    shard plane's section (its sketches' device state) is never read."""
    from windflow_tpu_torch.monitoring.shard_ledger import ShardLedger

    def boom(self):
        raise AssertionError("the tenant tick read the shard sketches")
    led = _ledger(wt)
    led.reset()
    g = _graph(wt, "ten_tick_app", "tick", "tk", lambda i: i % KEYS,
               budget=1)
    _drive(g)
    assert g._shard is not None
    monkeypatch.setattr(ShardLedger, "section", boom)
    for _ in range(ttl.ENTER_AFTER):
        led.tick(tenant="tick", force=True)
    row = led.section()["tenants"]["tick"]
    assert row["budget"]["active"] and row["ici_provenance"] == "modeled"
