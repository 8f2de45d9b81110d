"""The port's serving plane (``windflow_tpu_torch/serving``) against the
JAX package's (``tests/test_reshard.py``), on the CPU.

Twins of the eight executor tests: the same streams and ``Config``,
records exact against the pure-Python oracle (integer-valued or max
data: exact, no tolerance).  Where the trigger is imbalance only, the
executor's action sequence (timeline events in order, the keys each
emitter's override moved) equals the JAX run's on the same stream.
Beyond the twins:

* the per-replica TB ring-row move (``_move_ffat_rows``), which has no
  JAX test: a keyed TB window at parallelism 3, moved by the imbalance
  trigger and by a fixed plan handed to ``_apply_moves`` mid-stream in
  both packages; the fired windows equal the oracle's and JAX's, and
  the port moves the rows in place (every ring tensor keeps its
  storage, so a captured megastep would replay over the moved rows);
* split_hot_key on the columnar path (FrameSource → keyed staging →
  declared-sum ReduceGPU): ``_fold_columns`` folds the hot key through
  the torch combiner; the per-key totals equal JAX's and the oracle;
* F1: a JAX checkpoint taken after a ``move_keys`` (so it records
  placements) restores in the port at the same parallelism, the
  override installed, the restored suffix equal to JAX's restored
  suffix.
"""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.basic import stable_hash
from windflow_tpu.durability import chaos as jchaos
from windflow_tpu.durability.checkpoint import \
    keyed_emitters_into as jemitters
from windflow_tpu.durability.checkpoint import load_checkpoint as jload
from windflow_tpu.io import FrameSource as JFrameSource
from windflow_tpu_torch.durability import chaos
from windflow_tpu_torch.durability.checkpoint import \
    keyed_emitters_into as temitters
from windflow_tpu_torch.parallel.emitters import splitmix64_int

torch.set_num_threads(1)

N_SHARDS = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(pkg, **kw):
    cfg = dataclasses.replace(pkg.default_config)
    if pkg is wt:
        cfg.device = "cpu"
    cfg.reshard_executor = True
    cfg.reshard_check_sweeps = 4
    cfg.reshard_trigger_ticks = 2
    cfg.reshard_ok_ticks = 2
    cfg.reshard_imbalance_threshold = 1.6
    # determinism: wall-clock punctuation moves batch boundaries
    cfg.punctuation_interval_usec = 10 ** 12
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _colocated_keys(n_shards, shard, want=2, upto=200, place=None):
    place = place or (lambda k: stable_hash(k) % n_shards)
    out = [k for k in range(upto) if place(k) == shard]
    assert len(out) >= want
    return out[:want]


def _run_reduce_graph(pkg, records, cfg, parallelism=N_SHARDS):
    """Host keyed Reduce: per-key running (count, sum) states, the move
    target whose state re-homes with the key."""
    def red_fn(item, state):
        state["key"] = item["key"]
        state["n"] = state.get("n", 0) + 1
        state["s"] = state.get("s", 0.0) + item["value"]

    outs = []
    g = pkg.PipeGraph("reshard_t", config=cfg)
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(256).build())
    red = (pkg.Reduce_Builder(red_fn, dict)
           .withKeyBy(lambda t: t["key"])
           .withParallelism(parallelism).withName("red").build())
    snk = pkg.Sink_Builder(
        lambda r: outs.append(dict(r)) if r is not None else None).build()
    g.add_source(src).add(red).add_sink(snk)
    g.run()
    return g, red, outs


def _assert_reduce_exact(outs, records):
    per = {}
    for t in records:
        n, s = per.get(t["key"], (0, 0.0))
        per[t["key"]] = (n + 1, s + t["value"])
    final = {r["key"]: (r["n"], r["s"]) for r in outs}
    for k, want in per.items():
        assert final.get(k) == want, (k, final.get(k), want)


def _events(rs):
    return [(e["op"], e["event"]) for e in rs["timeline"]]


def _overrides(g, op, emitters):
    return [em._override for em in emitters(g, op)]


def _same_actions(jg, jop, tg, top):
    """The imbalance-only trigger acts alike in both packages: the same
    timeline events in order, the same counters, the same overrides."""
    js, ts = jg.stats()["Reshard"], tg.stats()["Reshard"]
    assert _events(js) == _events(ts)
    for k in ("ticks", "plans_applied", "keys_moved", "splits_applied",
              "moves_skipped", "admission_throttles", "preagg_folds",
              "admission_factor", "scale_down_events"):
        assert js[k] == ts[k], (k, js[k], ts[k])
    assert _overrides(jg, jop, jemitters) == _overrides(tg, top, temitters)


def _warm_pair_records(n, keys=12, hot=None, value=lambda i: i % 97):
    h1, h2 = hot or _colocated_keys(N_SHARDS, 0)
    out = []
    for i in range(n):
        r = i % 20
        k = h1 if r < 5 else (h2 if r < 10 else (i % keys))
        out.append({"key": k, "value": float(value(i))})
    return out


# ---------------------------------------------------------------------------
# off path and section plumbing
# ---------------------------------------------------------------------------

def test_executor_off_by_default():
    """Off by default in both packages: no plane, the section reads
    disabled, the records flow."""
    for pkg in (wf, wt):
        cfg = dataclasses.replace(pkg.default_config)
        if pkg is wt:
            cfg.device = "cpu"
        assert cfg.reshard_executor is False
        got = []
        g = pkg.PipeGraph("reshard_off", config=cfg)
        src = pkg.Source_Builder(
            lambda: iter([{"key": i % 4, "value": 1.0} for i in range(512)])
        ).withOutputBatchSize(128).build()
        g.add_source(src).add_sink(pkg.Sink_Builder(
            lambda r: got.append(r) if r is not None else None).build())
        g.run()
        assert g._reshard is None
        assert g.stats()["Reshard"] == {"enabled": False}
        assert len(got) == 512


def test_config_fields_match_jax():
    fields = ("reshard_executor", "reshard_check_sweeps",
              "reshard_trigger_ticks", "reshard_ok_ticks",
              "reshard_imbalance_threshold", "reshard_scale_down_ticks")
    for f in fields:
        assert getattr(wt.Config(), f) == getattr(wf.Config(), f), f


# ---------------------------------------------------------------------------
# imbalance -> move_keys -> recovered
# ---------------------------------------------------------------------------

def test_move_keys_separates_colocated_warm_keys():
    records = _warm_pair_records(24000)
    jg, jred, jouts = _run_reduce_graph(wf, records, _cfg(wf))
    g, red, outs = _run_reduce_graph(wt, records, _cfg(wt))
    rs = g.stats()["Reshard"]
    assert rs["enabled"] and rs["plans_applied"] >= 1
    assert rs["keys_moved"] >= 1
    events = [e["event"] for e in rs["timeline"]]
    assert "move_keys" in events and "recovered" in events
    assert rs["recovery_ms"] is not None and rs["quiesce_ms"] is not None
    assert any(_overrides(g, red, temitters)), \
        "no emitter carries the move override"
    _assert_reduce_exact(outs, records)
    _same_actions(jg, jred, g, red)


def test_zipf_shift_mid_run_migration():
    p1 = _colocated_keys(N_SHARDS, 0)
    p2 = _colocated_keys(N_SHARDS, 1)
    N = 40000
    records = []
    for i in range(N):
        hot = p1 if i < N // 2 else p2
        r = i % 20
        k = hot[0] if r < 5 else (hot[1] if r < 10 else (i % 12))
        records.append({"key": k, "value": float(i % 89)})
    jg, jred, _ = _run_reduce_graph(wf, records, _cfg(wf))
    g, red, outs = _run_reduce_graph(wt, records, _cfg(wt))
    rs = g.stats()["Reshard"]
    assert rs["plans_applied"] >= 2, rs["timeline"]
    assert len([e for e in rs["timeline"]
                if e["event"] == "move_keys"]) >= 2
    assert [e for e in rs["timeline"] if e["event"] == "recovered"]
    assert rs["admission_factor"] == 1.0
    _assert_reduce_exact(outs, records)
    _same_actions(jg, jred, g, red)


# ---------------------------------------------------------------------------
# hot key -> split -> pre-aggregating partial combine
# ---------------------------------------------------------------------------

SPLIT_N, SPLIT_KEYS, SPLIT_HOT = 24000, 8, 5


def _split_key(i):
    return SPLIT_HOT if i % 10 < 6 else (i % SPLIT_KEYS)


def _split_v(i):
    return -2.0 - ((i * 29) % 83) / 7.0


def _split_graph(pkg):
    mx = jnp.maximum if pkg is wf else torch.maximum
    rb = wf.ReduceTPU_Builder if pkg is wf else wt.ReduceGPU_Builder
    outs = []
    g = pkg.PipeGraph("split_t", config=_cfg(
        pkg, reshard_imbalance_threshold=1.25))
    src = pkg.Source_Builder(
        lambda: iter({"key": _split_key(i), "v": _split_v(i)}
                     for i in range(SPLIT_N))).withOutputBatchSize(256).build()
    red = (rb(lambda a, b: {"key": mx(a["key"], b["key"]),
                            "v": mx(a["v"], b["v"])})
           .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max")
           .withParallelism(2).withMaxKeys(SPLIT_KEYS).withName("dred")
           .build())
    snk = pkg.Sink_Builder(
        lambda r: outs.append({"key": int(r["key"]), "v": float(r["v"])})
        if r is not None else None).build()
    g.add_source(src).add(red).add_sink(snk)
    g.run()
    return g, red, outs


def test_split_hot_key_partial_combine_on_monoid_reduce():
    """A 60% hot key: the split engages a pre-aggregating combine at the
    keyed staging boundary (the record path's ``_fold_into`` through the
    torch combiner); the final per-key max is exact."""
    jg, jred, _ = _split_graph(wf)
    g, red, outs = _split_graph(wt)
    rs = g.stats()["Reshard"]
    assert rs["splits_applied"] >= 1, rs["timeline"]
    assert rs["preagg_folds"] > 0
    assert "split_hot_key" in [e["event"] for e in rs["timeline"]]
    per = {}
    for i in range(SPLIT_N):
        per[_split_key(i)] = max(per.get(_split_key(i), -1e18), _split_v(i))
    got = {}
    for r in outs:
        got[r["key"]] = max(got.get(r["key"], -1e18), r["v"])
    assert got == per
    _same_actions(jg, jred, g, red)


def _frames(keys, tss, vals):
    """Binary frames (LE ``int64 key, int64 ts, nv × float64``)."""
    vals = np.asarray(vals, np.float64).reshape(len(keys), -1)
    rec = np.zeros(len(keys), np.dtype([("k", "<i8"), ("t", "<i8"),
                                        ("v", "<f8", (vals.shape[1],))]))
    rec["k"], rec["t"], rec["v"] = keys, tss, vals
    return rec.tobytes()


def test_split_hot_key_on_the_columnar_path():
    """FrameSource → keyed staging → declared-sum ReduceGPU at
    parallelism 3 with one key holding 60% of the tuples: the split's
    columnar fold (``_fold_columns``: a log-halving through the torch
    combiner) absorbs the hot key's rows.  A declared sum folds every
    field, the key too, so each record carries a count lane ``n`` and
    its key is ``key / n``; the per-key totals equal the oracle and the
    JAX run (integer values: exact)."""
    rng = np.random.default_rng(7)
    n, hot = 64 * 512, 3
    keys = np.where(rng.random(n) < 0.6, hot, rng.integers(0, 16, n))
    vals = rng.integers(0, 9, n).astype(np.float64)
    blob = _frames(keys, np.arange(n) * 10,
                   np.stack([vals, np.ones(n)], 1))

    def run(pkg):
        sums = {}

        def sink(r, ctx=None):
            if r is not None:
                k = int(r["key"]) // int(r["n"])
                sums[k] = sums.get(k, 0.0) + float(r["v0"])
        rb = wf.ReduceTPU_Builder if pkg is wf else wt.ReduceGPU_Builder
        fs = JFrameSource if pkg is wf else wt.FrameSource
        g = pkg.PipeGraph("split_cols", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT, config=_cfg(
                              pkg, reshard_imbalance_threshold=1.25,
                              reshard_check_sweeps=2))
        src = fs(lambda: (blob[i:i + 32 * 512]
                          for i in range(0, len(blob), 32 * 512)),
                 nv=2, fields=["v0", "n"], output_batch_size=512)
        red = (rb(lambda a, b: {"key": a["key"] + b["key"],
                                "v0": a["v0"] + b["v0"],
                                "n": a["n"] + b["n"]})
               .withKeyBy(lambda t: t["key"]).withMonoidCombiner("sum")
               .withMaxKeys(16).withParallelism(3).withName("sred").build())
        g.add_source(src).add(red).add_sink(pkg.Sink_Builder(sink).build())
        g.run()
        return g, red, sums

    jg, jred, jsums = run(wf)
    g, red, sums = run(wt)
    want = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        want[k] = want.get(k, 0.0) + v
    rs = g.stats()["Reshard"]
    assert rs["splits_applied"] >= 1 and rs["preagg_folds"] > 0, \
        rs["timeline"]
    assert sums == want == jsums
    _same_actions(jg, jred, g, red)


# ---------------------------------------------------------------------------
# no plan helps -> admission control at the source
# ---------------------------------------------------------------------------

def test_no_plan_admission_control_degrades_and_holds_exactness():
    N, KEYS, HOT = 20000, 8, 5
    records = [{"key": HOT if i % 10 < 6 else (i % KEYS),
                "value": float(i % 53)} for i in range(N)]
    g, red, outs = _run_reduce_graph(
        wt, records, _cfg(wt, reshard_imbalance_threshold=1.25))
    rs = g.stats()["Reshard"]
    assert rs["admission_throttles"] >= 1, rs["timeline"]
    admissions = [e for e in rs["timeline"] if e["event"] == "admission"]
    assert any("throttled" in e["detail"] for e in admissions)
    _assert_reduce_exact(outs, records)
    x = g._reshard
    x._admission = 0.25
    assert x.admit_chunk(256) == 64 and x.admit_chunk(2) == 1


# ---------------------------------------------------------------------------
# surfaces: OpenMetrics + postmortem / wf_doctor
# ---------------------------------------------------------------------------

def test_reshard_openmetrics_families_and_postmortem(tmp_path):
    records = _warm_pair_records(16000, value=lambda i: 1)
    g, red, outs = _run_reduce_graph(wt, records, _cfg(wt))
    stats = g.stats()
    assert stats["Reshard"]["enabled"]
    from windflow_tpu_torch.monitoring.openmetrics import (
        parse_exposition, render_openmetrics)
    fams = parse_exposition(render_openmetrics(stats))
    for fam in ("wf_reshard_plans_applied_total",
                "wf_reshard_keys_moved_total",
                "wf_reshard_admission_factor"):
        assert fam in fams, fam
    d = g.dump_postmortem(str(tmp_path / "bundle"), reason="test")
    with open(os.path.join(d, "reshard.json")) as f:
        rj = json.load(f)
    assert rj["enabled"] and isinstance(rj["timeline"], list)
    assert rj["plans_applied"] == stats["Reshard"]["plans_applied"]
    tool = os.path.join(REPO, "tools", "wf_doctor.py")
    out = subprocess.run([sys.executable, tool, d, "--check"],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    render = subprocess.run([sys.executable, tool, d],
                            capture_output=True, text=True)
    assert "Reshard" in render.stdout, render.stdout


# ---------------------------------------------------------------------------
# the state machine itself: health BACKPRESSURED drives the transitions
# ---------------------------------------------------------------------------

def test_state_machine_backpressured_to_move_keys_to_recovered():
    import windflow_tpu_torch.serving.executor as ex
    records = [{"key": i % 6, "value": 1.0} for i in range(6000)]
    g, red, outs = _run_reduce_graph(
        wt, records, _cfg(wt, reshard_check_sweeps=10 ** 9))
    x = g._reshard
    assert x is not None and "red" in x._targets
    move = {"kind": "move_keys",
            "moves": [{"key": 0, "from_shard": 0, "to_shard": 1,
                       "est_tuples": 10}]}
    plan_entry = {"op": "red", "loads": [100, 10, 10],
                  "imbalance_ratio": 2.5, "hot_keys": [],
                  "actions": [move]}
    x._health_verdicts = lambda: {"red": {"state": "BACKPRESSURED"}}
    x._plan = lambda: {"ops": [plan_entry]}
    tr = x._tracks["red"]
    x.tick()
    assert tr.state == ex.E_TRIGGERED
    x.tick()
    assert tr.state == ex.E_RECOVERING
    assert x.plans_applied == 1 and x.keys_moved == 1
    x._health_verdicts = lambda: {"red": {"state": "OK"}}
    x._delta_imbalance = lambda name, loads: 1.0
    x.tick()
    x.tick()
    assert tr.state == ex.E_OK
    assert [e["event"] for e in x.timeline][:3] == [
        "triggered", "move_keys", "recovered"]


# ---------------------------------------------------------------------------
# scale-down on sustained OK
# ---------------------------------------------------------------------------

def test_scale_down_consolidates_on_sustained_ok():
    records = [{"key": i % 12, "value": 1.0} for i in range(20000)]
    kw = dict(reshard_scale_down_ticks=3, reshard_check_sweeps=2)
    jg, jred, _ = _run_reduce_graph(wf, records, _cfg(wf, **kw))
    g, red, outs = _run_reduce_graph(wt, records, _cfg(wt, **kw))
    rs = g.stats()["Reshard"]
    assert rs["scale_down_events"] >= 1, rs["timeline"]
    assert "scale_down" in [e["event"] for e in rs["timeline"]]
    _assert_reduce_exact(outs, records)
    _same_actions(jg, jred, g, red)


# ---------------------------------------------------------------------------
# the per-replica TB ring-row move
# ---------------------------------------------------------------------------

TB_N, TB_KEYS, TB_MAXK = 24000, 12, 64
TB_W, TB_S = 40_000, 10_000


def _tb_records():
    """Two warm keys colocated by the keyed staging placement
    (splitmix64 % 3) over a background of 12 keys: every shard sees
    tuples in every pane, so the ring clocks agree at a move."""
    hot = _colocated_keys(N_SHARDS, 0, upto=400,
                          place=lambda k: splitmix64_int(k) % N_SHARDS)
    hot = [k for k in hot if k >= TB_KEYS] or hot
    recs = []
    for i in range(TB_N):
        r = i % 20
        k = hot[0] if r < 5 else (hot[1] if r < 10 else (i % TB_KEYS))
        recs.append({"key": k, "v": float(i % 7), "ts": i * 100})
    return recs


def _tb_oracle(recs):
    per = {}
    for t in recs:
        ts = t["ts"]
        first = max(0, -(-(ts - TB_W + 1) // TB_S))
        for w in range(first, ts // TB_S + 1):
            per[(t["key"], w)] = per.get((t["key"], w), 0.0) + t["v"]
    return sorted((k, w, v) for (k, w), v in per.items())


def _tb_graph(pkg, recs, **kw):
    out = []
    g = pkg.PipeGraph("tbmove", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT, config=_cfg(pkg, **kw))
    src = (pkg.Source_Builder(lambda: iter(recs))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(256).build())
    wb = wf.Ffat_WindowsTPU_Builder if pkg is wf \
        else wt.Ffat_WindowsGPU_Builder
    w = (wb(lambda t: t["v"], lambda a, b: a + b)
         .withTBWindows(TB_W, TB_S).withKeyBy(lambda t: t["key"])
         .withMaxKeys(TB_MAXK).withParallelism(N_SHARDS).withName("win")
         .build())
    g.add_source(src).add(w).add_sink(pkg.Sink_Builder(
        lambda r: out.append((int(r["key"]), int(r["wid"]),
                              float(r["value"])))
        if r is not None else None).build())
    return g, w, out


def test_tb_ring_rows_move_on_the_imbalance_trigger():
    recs = _tb_records()
    want = _tb_oracle(recs)
    runs = {}
    for pkg in (wf, wt):
        g, w, out = _tb_graph(pkg, recs)
        g.run()
        runs[pkg] = (g, w, sorted(out))
    (jg, jw, jout), (g, w, out) = runs[wf], runs[wt]
    rs = g.stats()["Reshard"]
    assert rs["keys_moved"] >= 1 and rs["rows_moved"] >= 1
    assert rs["moves_skipped"] < rs["keys_moved"]
    assert rs["clock_reads"] >= rs["rows_moved"]
    assert out == want == jout
    assert w.dump_stats()["Late_tuples_dropped"] == 0
    _same_actions(jg, jw, g, w)


def _drive_with_fixed_plan(pkg, recs, moves, after_steps=40):
    g, w, out = _tb_graph(pkg, recs, reshard_check_sweeps=10 ** 9)
    g.start()
    for _ in range(after_steps):
        g.step()
    x = g._reshard
    assert x._apply_moves(x._tracks["win"], {"moves": moves})
    g.wait_end()
    return g, w, x, sorted(out)


def test_tb_ring_rows_move_on_a_fixed_plan_in_place():
    """The same move plan, handed to ``_apply_moves`` after the same
    number of driver sweeps in both packages: equal fired windows, equal
    to the oracle; the port's rings keep every tensor's storage across
    the move."""
    recs = _tb_records()
    hot = recs[0]["key"]
    src = splitmix64_int(hot) % N_SHARDS
    moves = [{"key": hot, "from_shard": src,
              "to_shard": (src + 1) % N_SHARDS, "est_tuples": 1}]
    _, _, jx, jout = _drive_with_fixed_plan(wf, recs, moves)

    g, w, out = _tb_graph(wt, recs, reshard_check_sweeps=10 ** 9)
    g.start()
    for _ in range(40):
        g.step()
    from windflow_tpu_torch.utils.tree import tree_flatten

    def leaves():
        return {(i, n): t for i, st in w._states.items()
                for n, t in zip(*_named(st, tree_flatten))}
    # the barrier first (steps rebind the rings functionally); the move's
    # own quiesce then finds nothing in flight
    from windflow_tpu_torch.durability.checkpoint import quiesce
    quiesce(g)
    before = {k: (t, t.data_ptr()) for k, t in leaves().items()}
    x = g._reshard
    assert x._apply_moves(x._tracks["win"], {"moves": moves})
    after = leaves()
    for k, (t, ptr) in before.items():
        assert after[k] is t and t.data_ptr() == ptr, k
    g.wait_end()
    assert x.rows_moved == jx.keys_moved == 1 and x.moves_skipped == 0
    assert sorted(out) == jout == _tb_oracle(recs)
    assert [em._override for em in temitters(g, w)] \
        == [{hot: (src + 1) % N_SHARDS}]


def _named(state, flatten):
    names, leaves = [], []
    for name in sorted(state):
        ls = flatten(state[name])[0]
        names += [f"{name}[{j}]" for j in range(len(ls))]
        leaves += ls
    return names, leaves


# ---------------------------------------------------------------------------
# F1: a JAX checkpoint that carries placements restores in the port
# ---------------------------------------------------------------------------

F1_N = 16384


def _restore_suffix(make, pending, d, **kw):
    shutil.rmtree(d, ignore_errors=True)
    cell = make("reduce", str(d / "ck"), out_dir=str(d / "out"), n=F1_N,
                parallelism=N_SHARDS, **kw)
    g = cell["factory"]()
    # a restore adopts the blobs' host state (a Reduce's dicts): each
    # package restores its own copy
    g._pending_restore = dict(copy.deepcopy(pending), rescaled=False)
    g.start()
    g.wait_end()
    return g, cell["read"]()


def test_f1_jax_checkpoint_with_placements_restores_in_the_port(tmp_path):
    """A JAX run with durability on moves a key mid-stream through the
    executor's ``_apply_moves`` and is abandoned after the next epoch
    (mid-stream), whose manifest records the placement.  The port
    restores that checkpoint at the same parallelism: the override lands
    on the keyed emitter, and the restored suffix equals the JAX
    package's own restored suffix record for record."""
    from windflow_tpu.serving import ReshardExecutor
    d = tmp_path / "jax"
    cell = jchaos.make_cell("reduce", str(d / "ck"), out_dir=str(d / "out"),
                            n=F1_N, parallelism=N_SHARDS)
    g = cell["factory"]()
    g.start()
    for _ in range(4):
        g.step()
    key = 3
    dst = (stable_hash(key) + 1) % N_SHARDS
    # the JAX cell takes no Config fields: an executor over the started
    # graph applies the move by hand (its tick never runs)
    x = ReshardExecutor(g)
    assert x._apply_moves(x._tracks["red"], {"moves": [
        {"key": key, "from_shard": stable_hash(key) % N_SHARDS,
         "to_shard": dst, "est_tuples": 1}]})
    for _ in range(2):      # the epoch at sweep 6, then the graph dies
        g.step()
    pending = jload(str(d / "ck"))
    ordinal = [op.ordinal for op in g._operators if op.name == "red"][0]
    assert pending["placements"] == {ordinal: {key: dst}}
    pos = [r.get("kafka_positions") for r in pending["reps"]
           if r.get("kafka_positions")]
    assert 0 < pos[0][("in", 0)] < F1_N    # mid-stream

    jg, jout = _restore_suffix(jchaos.make_cell, pending, tmp_path / "j")
    tg, tout = _restore_suffix(chaos.make_cell, pending, tmp_path / "t",
                               device="cpu")
    red = [op for op in tg._operators if op.name == "red"][0]
    assert [em._override for em in temitters(tg, red)] == [{key: dst}]
    assert chaos.diff_records(jout, tout) is None
    assert sum(len(p) for p in tout) > 0
