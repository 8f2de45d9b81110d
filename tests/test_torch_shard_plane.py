"""The shard plane of the port against the JAX package's
(``windflow_tpu_torch/monitoring/shard_ledger.py`` vs
``windflow_tpu/monitoring/shard_ledger.py``): the non-mesh families of
``tests/test_shard_plane.py`` on the same seeded Zipf graphs (the hot
shard and key named, estimates equal to JAX's, per-replica attribution,
the device keyby's and the fused chain's sketch on the card with no
extra dispatch, a chain into a parallel keyby counted once, the
postmortem's ``shard.json`` through ``tools/wf_doctor.py``, the health
verdict naming the hot shard, the kill switch), and the sketches
themselves: the host count-min and the device state update equal to
JAX's bit for bit on the same keys.  The mesh families wait for the
multi-GPU item."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import default_config as jax_default_config
from windflow_tpu.monitoring import shard_ledger as jsl
from windflow_tpu_torch.monitoring import shard_ledger as tsl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_BATCHES = 16
CAP = 256
N = N_BATCHES * CAP
HOT_KEY = 7
PAR = 4


def _cfg(pkg, tmp_path=None, **kw):
    if tmp_path is not None:
        kw.setdefault("log_dir", str(tmp_path / pkg.__name__))
    if pkg is wt:
        kw.setdefault("device", "cpu")
        return wt.Config(**kw)
    return dataclasses.replace(jax_default_config, **kw)


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


def _zipf_keys(n=N, n_keys=64, hot=HOT_KEY, share=0.4, seed=5):
    rng = np.random.default_rng(seed)
    ks = rng.integers(0, n_keys, n)
    ks[rng.random(n) < share] = hot
    return ks


ZIPF_KEYS = _zipf_keys()


def _records():
    return iter({"key": int(k), "v": float(i)}
                for i, k in enumerate(ZIPF_KEYS))


def _zipf_graph(pkg, cfg, name="zipf_app", par=PAR):
    src = (pkg.Source_Builder(_records).withOutputBatchSize(CAP)
           .withName("src").build())
    red = (_dev(pkg, "Reduce")(
        lambda a, b: {"key": b["key"], "v": a["v"] + b["v"]})
        .withKeyBy(lambda t: t["key"]).withParallelism(par)
        .withName("red").build())
    snk = pkg.Sink_Builder(lambda t, ctx=None: None).withName("snk").build()
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT, config=cfg)
    g.add_source(src).add(red).add_sink(snk)
    return g


@pytest.fixture(scope="module")
def zipf_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    out = {}
    for pkg in (wt, wf):
        g = _zipf_graph(pkg, _cfg(pkg, d))
        g.run()
        out[pkg] = (g, g.stats()["Shard"])
    return out


def _expected_shard_counts(ks=ZIPF_KEYS, par=PAR):
    from windflow_tpu_torch.parallel.emitters import splitmix64_int
    out = np.zeros(par, np.int64)
    for k in ks:
        out[splitmix64_int(int(k)) % par] += 1
    return out


# ---------------------------------------------------------------------------
# the sketches: host count-min and device update, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_keys", [None, 64])
def test_host_sketch_equals_jax(max_keys):
    rng = np.random.default_rng(11)
    t = tsl.ShardSketch(4, max_keys=max_keys)
    j = jsl.ShardSketch(4, max_keys=max_keys)
    for _ in range(6):
        keys = rng.integers(-50, 5000, 300)
        keys[rng.random(300) < 0.3] = 42
        t.update_host(keys)
        j.update_host(keys)
    if max_keys is None:
        assert np.array_equal(t.cms, j.cms)
        for k in (42, 0, -7, 4999, 123456):
            assert t._estimate(k) == j._estimate(k)
    else:
        assert np.array_equal(t.hist, j.hist)
    st, sj = t.summary(), j.summary()
    st.pop("host_update_usec", None)
    sj.pop("host_update_usec", None)
    assert st == sj
    assert t.hot_candidates(5) == j.hot_candidates(5)


def test_device_sketch_update_equals_jax():
    """The in-step update on torch (CPU) against JAX's traced update:
    the count-min rows, the shard counts, the candidate ring and the
    batch/tuple counters, batch after batch (the ring wraps)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    n = 3
    st = tsl.device_sketch_init(n)
    js = jsl.device_sketch_init(n)
    for b in range(12):
        cap = 64 if b % 2 else 200
        keys = rng.integers(-(2 ** 31), 2 ** 31 - 1, cap).astype(np.int32)
        keys[rng.random(cap) < 0.5] = 7
        valid = rng.random(cap) < 0.8
        tsl.device_sketch_update(st, torch.from_numpy(keys),
                                 torch.from_numpy(valid), n)
        js = jsl.device_sketch_update(js, jnp.asarray(keys),
                                      jnp.asarray(valid), n)
        assert np.array_equal(st["cms"].numpy(), np.asarray(js["cms"]))
        assert np.array_equal(st["counts"].numpy()[:n],
                              np.asarray(js["counts"]))
        assert np.array_equal(st["cand"].numpy(), np.asarray(js["cand"]))
        assert int(st["batches"]) == int(js["batches"])
        assert int(st["total"]) == int(js["total"])


def test_device_sketch_matches_host_sketch():
    """A sketch fed by a device site summarises like one fed on the host
    with the same keys."""
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 5000, 512)
    keys[:100] = 99
    host = tsl.ShardSketch(2)
    host.update_host(keys)
    dev = tsl.ShardSketch(2)
    state = tsl.device_sketch_init(2)
    dev.register_device_state(lambda: state)
    tsl.device_sketch_update(state, torch.from_numpy(keys),
                             torch.ones(512, dtype=torch.bool), 2)
    assert np.array_equal(dev._device_reads()[0]["cms"], host.cms)
    sd, sh = dev.summary(), host.summary()
    assert sd["tuples"] == sh["tuples"] and sd["total_tuples"] == 512
    assert sd["hot_keys"][0]["key"] == sh["hot_keys"][0]["key"] == 99
    assert sd["hot_keys"][0]["est_tuples"] == \
        sh["hot_keys"][0]["est_tuples"]


# ---------------------------------------------------------------------------
# the seeded-skew graph
# ---------------------------------------------------------------------------

def test_zipf_hot_shard_and_key_attributed_as_in_jax(zipf_runs):
    _, sec = zipf_runs[wt]
    _, jsec = zipf_runs[wf]
    load, jload = sec["per_op"]["red"]["load"], jsec["per_op"]["red"]["load"]
    expected = _expected_shard_counts()
    assert load["tuples"] == jload["tuples"] == [int(c) for c in expected]
    assert load["total_tuples"] == N and load["basis"] == "cms"
    assert load["hot_shard"] == int(expected.argmax())
    assert load["imbalance_ratio"] == jload["imbalance_ratio"] > 1.5
    assert load["hot_keys"] == jload["hot_keys"]
    assert load["hot_keys"][0]["key"] == HOT_KEY
    assert load["hot_keys"][0]["shard"] == load["hot_shard"]
    assert load["hot_key_share"] == jload["hot_key_share"]
    assert sec["totals"]["max_imbalance_op"] == "red"
    assert sec["totals"]["hot_key_op"] == "red"
    assert set(sec["totals"]) == set(jsec["totals"])
    json.dumps(sec)


def test_sketch_estimate_within_accuracy_bound(zipf_runs):
    load = zipf_runs[wt][1]["per_op"]["red"]["load"]
    true_hot = int((ZIPF_KEYS == HOT_KEY).sum())
    est = load["hot_keys"][0]["est_tuples"]
    assert true_hot <= est <= true_hot * 1.05 + 4 * N / 2048


def test_per_replica_runtime_attribution(zipf_runs):
    _, sec = zipf_runs[wt]
    entry = sec["per_op"]["red"]
    assert entry["parallelism"] == PAR and entry["keyed"] is True
    reps = entry["replicas"]
    assert [r["shard"] for r in reps] == list(range(PAR))
    for r, expect in zip(reps, entry["load"]["tuples"]):
        assert r["inputs"] == expect
        assert r["queue_depth"] == 0 and r["dispatches"] >= 1
        assert r["hbm_bytes"] > 0
    assert "load" not in sec["per_op"]["snk"]
    assert len(sec["per_op"]["snk"]["replicas"]) == 1


def _stateful(pkg, par, name="st"):
    return (_dev(pkg, "Map")(
        lambda t, s: ({"key": t["key"], "run": s + t["v"]}, s + t["v"]))
        .withInitialState(0.0).withKeyBy(lambda t: t["key"])
        .withNumKeySlots(64).withDenseKeys().withParallelism(par)
        .withName(name).build())


def _split_dispatches():
    from windflow_tpu_torch.monitoring.jit_registry import default_registry
    e = default_registry().snapshot().get("emitter.device_keyby_split")
    return (e or {}).get("dispatches", 0)


def test_device_keyby_sketch_on_the_card_no_extra_dispatch(tmp_path):
    loads = {}
    for on in (False, True):
        d0 = _split_dispatches()
        g = wt.PipeGraph(f"dk_{on}", config=_cfg(wt, tmp_path,
                                                 shard_ledger=on))
        g.add_source(wt.Source_Builder(_records).withOutputBatchSize(CAP)
                     .withName("src").build()) \
            .add(wt.MapGPU_Builder(lambda t: {"key": t["key"],
                                              "v": t["v"] * 2.0})
                 .withName("m").build()) \
            .add(_stateful(wt, 2)) \
            .add_sink(wt.Sink_Builder(lambda t: None).withName("snk")
                      .build())
        g.run()
        assert _split_dispatches() - d0 == N_BATCHES
        loads[on] = g.stats()["Shard"]
    assert loads[False] == {"enabled": False}
    load = loads[True]["per_op"]["st"]["load"]
    assert load["total_tuples"] == N
    assert load["hot_keys"][0]["key"] == HOT_KEY
    assert load["tuples"] == [int(c) for c in _expected_shard_counts(par=2)]


def test_dense_stateful_step_sketches_on_the_card(tmp_path):
    """A plain staging edge into a dense-keys stateful operator: the
    step's own keys feed the sketch on the device, so the edge keeps no
    host key probe (and frames into it may take the direct route); the
    load counts every tuple and names the hot key."""
    g = wt.PipeGraph("dense_st", config=_cfg(wt, tmp_path))
    src = (wt.Source_Builder(_records).withOutputBatchSize(CAP)
           .withName("src").build())
    g.add_source(src).add(_stateful(wt, 1)).add_sink(
        wt.Sink_Builder(lambda t: None).withName("snk").build())
    g.run()
    assert getattr(src.replicas[0].emitter, "_shard_probe", None) is None
    load = g.stats()["Shard"]["per_op"]["st"]["load"]
    assert load["total_tuples"] == N and load["batches"] == N_BATCHES
    assert load["hot_keys"][0]["key"] == HOT_KEY
    assert "host_update_usec" not in load


@pytest.mark.parametrize("par", [1, 2], ids=["chain_sketch", "keyby_once"])
def test_chain_sketch_as_in_jax(tmp_path, par):
    """A chained pair forwarding a KEYBY consumer's keys: at parallelism
    1 the sketch rides the chain's own step (one dispatch a batch); at 2
    the device keyby split sketches and the chain does not (counted
    once)."""
    out = {}
    for pkg in (wt, wf):
        g = pkg.PipeGraph(f"chain_{par}", pkg.ExecutionMode.DEFAULT,
                          config=_cfg(pkg, tmp_path,
                                      whole_chain_fusion=False))
        pipe = g.add_source(pkg.Source_Builder(_records)
                            .withOutputBatchSize(CAP).withName("src")
                            .build())
        pipe.add(_dev(pkg, "Map")(lambda t: {"key": t["key"],
                                             "v": t["v"] * 2.0})
                 .withName("ma").build())
        pipe.chain(_dev(pkg, "Filter")(lambda t: t["v"] >= 0.0)
                   .withName("fb").build())
        pipe.add(_stateful(pkg, par)).add_sink(
            pkg.Sink_Builder(lambda t, ctx=None: None).withName("snk")
            .build())
        g.run()
        st = g.stats()
        out[pkg] = (st["Sweep"]["per_hop"]["ma|fb"],
                    st["Shard"]["per_op"]["st"]["load"])
    (hop, load), (jhop, jload) = out[wt], out[wf]
    assert hop["dispatches_per_batch"] == jhop["dispatches_per_batch"] \
        == 1.0
    assert load["total_tuples"] == jload["total_tuples"] == N
    assert sum(load["tuples"]) == N
    assert load["tuples"] == jload["tuples"]
    assert load["hot_keys"][0]["key"] == HOT_KEY
    assert [h["key"] for h in load["hot_keys"]] == \
        [h["key"] for h in jload["hot_keys"]]


def _load_doctor():
    spec = importlib.util.spec_from_file_location(
        "_wf_doctor", os.path.join(REPO, "tools", "wf_doctor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_postmortem_shard_roundtrips_wf_doctor(zipf_runs, tmp_path):
    doctor = _load_doctor()
    g, sec = zipf_runs[wt]
    d = g.dump_postmortem(str(tmp_path / "bundle"), reason="shard test")
    bundle = doctor.load_bundle(d)
    doctor.validate(bundle)
    shard = bundle["sections"]["shard.json"]
    assert shard["per_op"]["red"]["load"]["tuples"] == \
        sec["per_op"]["red"]["load"]["tuples"]
    diag = doctor.diagnose(bundle)
    si = diag["shard_imbalance"]
    assert si["op"] == "red" and si["hot_key"] == HOT_KEY
    assert "worst imbalance 'red'" in doctor.render_text(diag)
    spath = os.path.join(d, "shard.json")
    with open(spath) as f:
        obj = json.load(f)
    obj["per_op"]["red"]["load"]["imbalance_ratio"] = "lots"
    with open(spath, "w") as f:
        json.dump(obj, f)
    with pytest.raises(doctor.BundleError):
        doctor.validate(doctor.load_bundle(d))


def test_health_verdict_names_hot_shard(tmp_path):
    g = _zipf_graph(wt, _cfg(wt, tmp_path), name="health_shard")
    g.run()
    red = g._operators[1]
    assert red.name == "red"
    red.replicas[2].inbox.append((0, object()))
    for rep in red.replicas:
        rep.done = False
    hs = g._health.sample()["red"].get("hot_shard")
    assert hs and hs["shard"] == 2 and hs["queue_depth"] == 1
    diag = g._health.diagnose_stall()
    assert diag["root_cause"] == "red"
    assert diag["shard"]["hot_keys"][0]["key"] == HOT_KEY
    msg = g._health.format_diagnosis(diag)
    assert "hot shard 2" in msg and f"key {HOT_KEY}" in msg


def test_kill_switch_attaches_no_sketch(tmp_path):
    g = _zipf_graph(wt, _cfg(wt, tmp_path, shard_ledger=False),
                    name="ks_app")
    g.run()
    assert g._shard is None
    assert g.stats()["Shard"] == {"enabled": False}
    for rep in g._operators[0].replicas:
        em = rep.emitter
        assert em._sketch is None and em._sk_buf == []
