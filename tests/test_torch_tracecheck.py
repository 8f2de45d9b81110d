"""wfverify on the port (windflow_tpu_torch/analysis/tracecheck.py)
against the JAX package's (windflow_tpu/analysis/tracecheck.py).

One seeded fixture per code, caught with the exact code and anchored to
this file, and a clean twin (no finding); where the fixture is plain
Python it is fed to both verifiers and their codes must agree, where it
needs the array library each package gets its own (jnp / torch).  Then
the torch-only rules (``.item()``, ``.cpu()``, ``masked_select``,
``repeat_interleave`` without ``output_size``, ``torch.rand`` without a
generator), the suppression contract, the graph-level integration
(``check()`` surfaces WF8xx beside WF1xx-WF6xx), and the port's own step
bodies, whose deliberate host reads each carry a justified suppression.
"""

import os
import random as _random
import time as _time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.analysis import tracecheck as jtc
from windflow_tpu_torch.analysis import tracecheck as tc
from windflow_tpu_torch.analysis.diagnostics import CODES, PreflightError

torch.set_num_threads(1)

THIS = os.path.basename(__file__)


def codes(findings):
    return [f.code for f in findings]


# ---------------------------------------------------------------------------
# fixtures both verifiers read (plain Python over the record)
# ---------------------------------------------------------------------------

def k_clean(t):
    return {"k": t["k"], "v": t["v"] * 2.0}


def k_wf801(t):
    return {"k": t["k"], "v": float(t["v"]) + 1.0}


def k_wf801_np(t):
    return {"k": t["k"], "v": np.asarray(t["v"]) + 1.0}


def k_wf802(t):
    if t["v"] > 0:
        return {"k": t["k"], "v": t["v"]}
    return {"k": t["k"], "v": -t["v"]}


_ACC = []


def k_wf803(t):
    _ACC.append(t)
    return t


def k_wf803_local(t):
    local = []                   # local containers are fine
    local.append(t["v"])
    return {"k": t["k"], "v": local[0]}


def k_wf804(t):
    print("saw", t)
    return t


_BUF = [1.0, 2.0, 3.0]


def k_wf811(t):
    return {"k": t["k"], "v": t["v"] * len(_BUF)}


_FROZEN = (1.0, 2.0, 3.0)


def k_wf811_clean(t):
    return {"k": t["k"], "v": t["v"] * len(_FROZEN)}


def k_wf811_next(t, it=iter(range(10))):
    return {"k": t["k"], "v": t["v"] + next(it)}


def k_wf812_mask(p, v):
    return {"k": p["k"], "v": p["v"][p["v"] > 0]}


def k_wf612(t):
    return {"k": t["k"], "v": t["v"] + _time.time()}


def s_wf611(r):
    if r is None:
        return
    _ = _random.random()


def s_wf611_np(r):
    if r is None:
        return
    _ = np.random.rand()


def s_wf611_clean(r):
    if r is None:
        return
    _ = sorted([1, 2, 3])


def s_wf613_id(r):
    if r is None:
        return
    _ = id(r)


def s_wf613_hash(r):
    if r is None:
        return
    _ = hash("bucket")


_KEYSET = {"a", "b", "c"}


def s_wf614(r):
    if r is None:
        return
    for k in _KEYSET:
        _ = k


def s_wf614_clean(r):
    if r is None:
        return
    for k in sorted(_KEYSET):    # order-insensitive consumer: fine
        _ = k


SHARED_CASES = [
    ("WF801", k_wf801, True, False),
    ("WF801", k_wf801_np, True, False),
    ("WF802", k_wf802, True, False),
    ("WF803", k_wf803, True, False),
    ("WF804", k_wf804, True, False),
    ("WF811", k_wf811, True, False),
    ("WF811", k_wf811_next, True, False),
    ("WF812", k_wf812_mask, True, False),
    ("WF612", k_wf612, True, True),
    ("WF611", s_wf611, False, True),
    ("WF611", s_wf611_np, False, True),
    ("WF613", s_wf613_id, False, True),
    ("WF613", s_wf613_hash, False, True),
    ("WF614", s_wf614, False, True),
]

SHARED_CLEAN = [
    (k_clean, True, True),
    (k_wf803_local, True, False),
    (k_wf811_clean, True, False),
    (s_wf611_clean, False, True),
    (s_wf614_clean, False, True),
]


def _anchored(want, fn, findings):
    assert want in codes(findings), codes(findings)
    hit = next(f for f in findings if f.code == want)
    assert os.path.basename(hit.path) == THIS
    lo = fn.__code__.co_firstlineno
    assert lo <= hit.lineno <= lo + 10
    assert want in CODES


@pytest.mark.parametrize("want,fn,traced,durable", SHARED_CASES,
                         ids=[f"{c[0]}-{c[1].__name__}"
                              for c in SHARED_CASES])
def test_seeded_violation_caught_as_in_jax(want, fn, traced, durable):
    got = tc.verify_callable(fn, traced=traced, durable=durable)
    _anchored(want, fn, got)
    assert codes(got) == codes(jtc.verify_callable(fn, traced=traced,
                                                   durable=durable))


@pytest.mark.parametrize("fn,traced,durable", SHARED_CLEAN,
                         ids=[c[0].__name__ for c in SHARED_CLEAN])
def test_clean_twin_no_diagnostics(fn, traced, durable):
    assert tc.verify_callable(fn, traced=traced, durable=durable) == []
    assert jtc.verify_callable(fn, traced=traced, durable=durable) == []


# ---------------------------------------------------------------------------
# twins that need the array library: jnp for JAX, torch for the port
# ---------------------------------------------------------------------------

def j_wf812(p, v):
    return {"k": p["k"], "v": jnp.nonzero(p["v"])[0].astype(jnp.float32)}


def t_wf812(p, v):
    return {"k": p["k"], "v": torch.nonzero(p["v"])[:, 0].float()}


def j_wf812_where(p, v):
    return {"k": p["k"], "v": jnp.where(p["v"] > 0)[0]}


def t_wf812_where(p, v):
    return {"k": p["k"], "v": torch.where(p["v"] > 0)[0]}


def j_wf812_unique(p, v):
    return {"k": jnp.unique(p["k"]), "v": p["v"]}


def t_wf812_unique(p, v):
    return {"k": torch.unique(p["k"]), "v": p["v"]}


def j_wf812_clean(p, v):
    return {"k": p["k"], "v": jnp.where(p["v"] > 0, p["v"], 0.0)}


def t_wf812_clean(p, v):
    return {"k": p["k"], "v": torch.where(p["v"] > 0, p["v"], 0.0)}


def j_wf802_clean(t):
    extra = t["x"] if "x" in t else t["v"]
    assert extra is not None
    return {"k": t["k"], "v": jnp.where(t["v"] > 0, t["v"], -t["v"])}


def t_wf802_clean(t):
    extra = t["x"] if "x" in t else t["v"]
    assert extra is not None
    return {"k": t["k"], "v": torch.where(t["v"] > 0, t["v"], -t["v"])}


TWIN_CASES = [
    ("WF812", j_wf812, t_wf812),
    ("WF812", j_wf812_where, t_wf812_where),
    ("WF812", j_wf812_unique, t_wf812_unique),
    (None, j_wf812_clean, t_wf812_clean),
    (None, j_wf802_clean, t_wf802_clean),
]


@pytest.mark.parametrize("want,jfn,tfn", TWIN_CASES,
                         ids=[c[2].__name__ for c in TWIN_CASES])
def test_twin_fixtures_agree_with_jax(want, jfn, tfn):
    got = tc.verify_callable(tfn, traced=True)
    assert codes(got) == codes(jtc.verify_callable(jfn, traced=True))
    if want is None:
        assert got == []
    else:
        _anchored(want, tfn, got)


# ---------------------------------------------------------------------------
# the torch rules
# ---------------------------------------------------------------------------

def t_item(t):
    return {"k": t["k"], "v": t["v"] * t["v"].max().item()}


def t_tolist(t):
    return {"k": t["k"], "v": t["v"] * len(t["k"].tolist())}


def t_cpu(t):
    return {"k": t["k"], "v": t["v"].cpu()}


def t_numpy(t):
    return {"k": t["k"], "v": t["v"].numpy()}


def t_bool(t):
    return {"k": t["k"], "v": t["v"] * bool(t["k"].any())}


def t_while(t):
    v = t["v"]
    while v.sum() > 100:
        v = v / 2
    return {"k": t["k"], "v": v}


def t_masked_select(t):
    return {"k": t["k"], "v": torch.masked_select(t["v"], t["v"] > 0)}


def t_repeat(t):
    return {"k": t["k"].repeat_interleave(t["k"]), "v": t["v"]}


def t_repeat_sized(t):
    return {"k": t["k"].repeat_interleave(t["k"], output_size=8),
            "v": t["v"]}


def t_rand(t):
    return {"k": t["k"], "v": t["v"] + torch.rand(t["v"].shape)}


_GEN = torch.Generator().manual_seed(7)


def t_rand_threaded(t):
    return {"k": t["k"], "v": t["v"] + torch.rand(t["v"].shape,
                                                  generator=_GEN)}


def t_metadata(t):
    # shapes, dtypes and devices are host metadata: never flagged
    if t["v"].shape[0] > 0 and t["v"].dtype == torch.float32 \
            and t["v"].device.type in ("cpu", "cuda"):
        n = t["v"].numel() + t["v"].size(0)
        return {"k": t["k"], "v": t["v"] * n}
    return t


TORCH_CASES = [
    ("WF801", t_item, False), ("WF801", t_tolist, False),
    ("WF801", t_cpu, False), ("WF801", t_numpy, False),
    ("WF801", t_bool, False), ("WF802", t_while, False),
    ("WF812", t_masked_select, False), ("WF812", t_repeat, False),
    ("WF611", t_rand, True),
]


@pytest.mark.parametrize("want,fn,durable", TORCH_CASES,
                         ids=[c[1].__name__ for c in TORCH_CASES])
def test_torch_rule_caught(want, fn, durable):
    _anchored(want, fn, tc.verify_callable(fn, traced=True,
                                           durable=durable))


@pytest.mark.parametrize("fn,durable", [(t_repeat_sized, False),
                                        (t_rand_threaded, True),
                                        (t_metadata, False)],
                         ids=["repeat_sized", "rand_threaded", "metadata"])
def test_torch_rule_clean_twin(fn, durable):
    assert tc.verify_callable(fn, traced=True, durable=durable) == []


def test_host_callables_are_not_traced():
    # a sink callback may read anything on the host
    assert tc.verify_callable(t_item, traced=False) == []


def test_determinism_family_gated_on_durability():
    with_d = codes(tc.verify_callable(k_wf612, traced=True, durable=True))
    without = codes(tc.verify_callable(k_wf612, traced=True,
                                       durable=False))
    assert "WF612" in with_d and "WF811" not in with_d
    assert "WF811" in without and "WF612" not in without


def test_verify_cache_by_code_object():
    f1 = tc.verify_callable(k_clean, traced=True, durable=False)
    f2 = tc.verify_callable(k_clean, traced=True, durable=False)
    assert f1 is f2


# ---------------------------------------------------------------------------
# suppression contract and the graph surfaces
# ---------------------------------------------------------------------------

def k_suppressed(t):
    # the cast below is provably concrete in this fixture's contract
    v = float(t["v"])  # wfverify: ok (seeded fixture for the suppression test)
    return {"k": t["k"], "v": v}


def k_suppressed_no_reason(t):
    v = float(t["v"])  # wfverify: ok
    return {"k": t["k"], "v": v}


def _graph(kfn=k_clean, sink_fn=None, durability="", win=None):
    def gen():
        return iter({"k": i % 2, "v": np.float32(i)} for i in range(8))

    cfg = wt.Config(device="cpu", durability=durability)
    src = (wt.Source_Builder(gen).withOutputBatchSize(8)
           .withRecordSpec({"k": np.int32(0), "v": np.float32(0.0)})
           .build())
    g = wt.PipeGraph("tcheck", config=cfg)
    pipe = g.add_source(src)
    pipe.add(wt.MapGPU_Builder(kfn).withName("m").build())
    if win is not None:
        pipe.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v"],
                                            lambda a, b: a + b)
                 .withCBWindows(*win).withKeyBy(lambda t: t["k"])
                 .withMaxKeys(2).withName("w").build())
    pipe.add_sink(wt.Sink_Builder(sink_fn or (lambda r: None))
                  .withName("s").build())
    return g


def test_suppression_with_reason_honored():
    assert tc.verify_callable(k_suppressed, traced=True) != []
    rep = tc.verify_graph(_graph(k_suppressed))
    assert rep.diagnostics == []
    assert [d.code for d in rep.suppressed] == ["WF801"]


def test_suppression_without_reason_rejected():
    rep = tc.verify_graph(_graph(k_suppressed_no_reason))
    assert [d.code for d in rep.diagnostics] == ["WF801"]
    assert "without a (reason)" in rep.diagnostics[0].message
    assert rep.suppressed == []


def test_verify_graph_names_operator_and_location():
    rep = tc.verify_graph(_graph(k_wf801))
    hits = [d for d in rep.diagnostics if d.code == "WF801"]
    assert hits and hits[0].node == "m"
    assert THIS in hits[0].location


def test_verify_graph_clean_repo_style_graph():
    rep = tc.verify_graph(_graph(k_clean, win=(4, 2)))
    assert rep.diagnostics == [] and rep.checked > 4
    assert rep.to_json()["donation"].startswith("not applicable")


def test_check_surfaces_wf8xx_alongside_existing_codes():
    # slide > len (WF202, warning) + a host-reading kernel (WF801, error):
    # one check() reports both families; the fake-tensor evaluation
    # fails the same kernel on its own (WF101)
    g = _graph(k_wf801, win=(4, 9))
    got = [d.code for d in g.check()]
    assert "WF202" in got and "WF801" in got and "WF101" in got
    with pytest.warns(Warning):
        with pytest.raises(PreflightError) as ei:
            g.start()
    assert "WF801" in str(ei.value)


def test_check_durability_sink_determinism():
    g = _graph(k_clean, sink_fn=s_wf611, durability="/nonexistent/ck")
    ds = [d for d in g.check() if d.code == "WF611"]
    assert ds and ds[0].severity == "warning"


def test_preflight_reports_tracecheck():
    g = _graph(k_clean)
    g.check()
    assert g._tracecheck_report is not None
    assert g._tracecheck_report.checked > 0


def test_graph_verdicts_equal_jax():
    """The same user kernels in both packages' graphs: equal codes and
    nodes from verify_graph."""
    def jgraph(kfn):
        src = (wf.Source_Builder(lambda: iter(())).withOutputBatchSize(8)
               .withRecordSpec({"k": np.int32(0), "v": np.float32(0.0)})
               .build())
        g = wf.PipeGraph("tcheck")
        g.add_source(src).add(wf.MapTPU_Builder(kfn).withName("m")
                              .build()).add_sink(
            wf.Sink_Builder(lambda r: None).withName("s").build())
        return g
    for kfn in (k_clean, k_wf801, k_wf802, k_wf803, k_wf811):
        got = sorted((d.code, d.node) for d in
                     tc.verify_graph(_graph(kfn)).diagnostics)
        want = sorted((d.code, d.node) for d in
                      jtc.verify_graph(jgraph(kfn)).diagnostics)
        assert got == want, kfn.__name__


# ---------------------------------------------------------------------------
# the port's own step bodies
# ---------------------------------------------------------------------------

def _run_graphs():
    """Representative graphs, run on the CPU so every step body they
    cache exists: a chained map|filter into a count window, the reduce on
    its three routes, both stateful bodies, and the compacted window."""
    out = []

    def src(name="src"):
        keys = np.arange(64, dtype=np.int32) % 4
        return (wt.Source_Builder(lambda: iter(
            {"k": np.int32(k), "v": np.float32(k)} for k in keys))
            .withOutputBatchSize(16)
            .withRecordSpec({"k": np.int32(0), "v": np.float32(0)})
            .withName(name).build())

    def sink():
        return wt.Sink_Builder(lambda r: None).build()

    g = wt.PipeGraph("fw_chain", config=wt.Config(device="cpu"))
    p = g.add_source(src())
    p.add(wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] * 2.0})
          .build())
    p.chain(wt.FilterGPU_Builder(lambda t: t["k"] >= 0).build())
    p.add(wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
          .withCBWindows(4, 2).withKeyBy(lambda t: t["k"]).withMaxKeys(4)
          .build()).add_sink(sink())
    out.append(g)
    for kc, declare, bound in ((True, True, False), (False, True, True),
                               (True, False, False)):
        g = wt.PipeGraph(f"fw_red_{kc}_{declare}",
                         config=wt.Config(device="cpu", key_compaction=kc))
        b = (wt.ReduceGPU_Builder(lambda a, b: {"k": a["k"] + b["k"],
                                                "v": a["v"] + b["v"]})
             .withKeyBy(lambda t: t["k"]))
        if bound:
            b = b.withMaxKeys(4)
        if declare:
            b = b.withSumCombiner()
        g.add_source(src()).add(b.build()).add_sink(sink())
        out.append(g)
    for assoc in (False, True):
        g = wt.PipeGraph(f"fw_state_{assoc}", config=wt.Config(device="cpu"))
        b = (wt.MapGPU_Builder(lambda t, s: ({"k": t["k"],
                                               "v": t["v"] + s},
                                              s + t["v"]))
             .withInitialState(np.float32(0)).withKeyBy(lambda t: t["k"])
             .withNumKeySlots(8).withDenseKeys())
        if assoc:
            b = b.withAssociativeUpdate(
                lambda t: t["v"], lambda a, b: a + b,
                lambda t, s: {"k": t["k"], "v": s})
        g.add_source(src()).add(b.build()).add_sink(sink())
        out.append(g)
    g = wt.PipeGraph("fw_compact", config=wt.Config(device="cpu"))
    g.add_source(src()).add(
        wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
        .withCBWindows(4, 2).withKeyBy(lambda t: t["k"])
        .withCompactedKeys().build()).add_sink(sink())
    out.append(g)
    for g in out:
        g.run()
    return out


def test_framework_bodies_clean():
    """Every step body the run graphs cached verifies clean: its host
    reads are the deliberate ones, each suppressed with its reason."""
    checked = 0
    for g in _run_graphs():
        bodies = tc._framework_traced_bodies(g)
        rep = tc.verify_graph(g)
        assert rep.diagnostics == [], (g.name, [str(d) for d in
                                                rep.diagnostics])
        checked += len(bodies)
        assert all("wfverify: ok" in open(
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))),
                d.location.rsplit(":", 1)[0])).read()
            for d in rep.suppressed)
    assert checked >= 6
