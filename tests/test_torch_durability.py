"""Durable state of the port (windflow_tpu_torch/durability) against the
JAX package (windflow_tpu/durability), on the CPU.

The fast cells of tests/test_durability.py, each on the port's chaos
harness and builders: one chaos cell per mechanism (:58, :65, :75, :82,
:87), the replica rescale cells (:116, :131), the torn-fence refusal and
the file sink's rescale (:200, :223), the manifest (:286), the WF605
plan (:300), the re-bucketing units (:362, :395), the store layout and
GC (:446), the WF602 diff (:474), the shared Config (:503), the empty
store (:520), the file sink's refusal and cold restart (:527, :546), the
unpicklable state (:561), the Kafka frontiers (:597) and the restore in
``stats()`` (:773); tests/test_key_compaction.py's restore across the
compaction switch, chaos remap cell and compactor round trip (:345,
:483, :499); tests/test_wire.py's chaos cells with the wire on and off
(:373-398); tests/test_megastep.py's chaos cell and epoch cadence under
K = 4 (:283-333); and a structural off-path test.

The cross-package A/B (exact: every cell's data is integer-valued):
(i) each family's killed and restored port run equals the JAX package's
uninterrupted run; (ii) the port's checkpoint blobs equal the JAX
package's at the same epoch leaf by leaf (keys, shapes, dtypes, values;
no torch object in the pickle), for FFAT CB, FFAT TB, the compacted
window, the dense and compacted stateful operator and the GPU reduce;
(iii) a JAX blob restored into the port's operator, then the suffix,
gives the JAX package's records, and the reverse.  The JAX baselines
are built once per module.  The mesh rescale cells (:143, :181-197) are
held in ``tests/test_torch_mesh_cells.py``.  Left out, with the ROADMAP
item they wait for: WF601/WF603 and the wall-clock family (:333, :679,
:698; A9), and the OpenMetrics and postmortem surfaces (:735; A8).
"""

import copy
import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.durability import chaos as jchaos
from windflow_tpu.durability.checkpoint import load_checkpoint as jload
from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.durability import chaos
from windflow_tpu_torch.durability.checkpoint import (load_checkpoint,
                                                      topology_signature)
from windflow_tpu_torch.kafka.client import InMemoryBroker
from windflow_tpu_torch.kafka.kafka_source import KafkaSource
from windflow_tpu_torch.parallel.compaction import KeyCompactor

torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _cell(tmp_path, family, tag, **kw):
    return chaos.make_cell(family, str(tmp_path / f"ck_{tag}"),
                           out_dir=str(tmp_path / f"out_{tag}"), **CPU,
                           **kw)


def _run_cell(tmp_path, family, point, *, fusion=True, spec=None, **kw):
    base = _cell(tmp_path, family, "a", fusion=fusion, **kw)
    chal = _cell(tmp_path, family, "b", fusion=fusion, **kw)
    v = chaos.run_ab(base["factory"], chal["factory"],
                     spec or chaos.default_kill(family, point),
                     base["read"], chal["read"])
    assert v["diff"] is None, f"{family}/{point}/fusion={fusion}: " \
                              f"{v['diff']}"
    assert v["restored_epoch"] is not None and v["records"] > 0
    return v


# ---------------------------------------------------------------------------
# baselines shared by the cross-package tests (built once per module)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def baselines(tmp_path_factory):
    """``get(pkg, family)`` -> the uninterrupted run of the family's cell
    in one package: its output, its last complete checkpoint and its
    directory.  Memoized, so each package's baseline of a family runs
    once."""
    root = tmp_path_factory.mktemp("baselines")
    memo = {}

    def get(pkg, family):
        key = (pkg, family)
        if key not in memo:
            d = root / f"{pkg}_{family}"
            if pkg == "jax":
                cell = jchaos.make_cell(family, str(d / "ck"),
                                        out_dir=str(d / "out"))
                jchaos.run_baseline(cell["factory"])
                pending = jload(str(d / "ck"))
            else:
                cell = chaos.make_cell(family, str(d / "ck"),
                                       out_dir=str(d / "out"), **CPU)
                chaos.run_baseline(cell["factory"])
                pending = load_checkpoint(str(d / "ck"))
            memo[key] = {"out": cell["read"](), "pending": pending,
                         "dir": d}
        return memo[key]
    return get


# ---------------------------------------------------------------------------
# chaos A/B: one fast cell per mechanism
# ---------------------------------------------------------------------------

def test_chaos_window_mid_epoch_fused(tmp_path):
    """:58 — kill between checkpoints on the fused map→CB-window chain:
    the pane ring and frontier restore mid-stream, the Kafka source
    seeks back, and the resumed output matches record for record."""
    _run_cell(tmp_path, "window_cb", "mid_epoch", fusion=True)


def test_chaos_window_mid_sink_flush_dedupes(tmp_path):
    """:65 — kill in the torn two-phase window (sink epoch committed,
    manifest never written): the replay re-commits the epoch and the
    broker fence dedupes every already-published message."""
    v = _run_cell(tmp_path, "window_cb", "mid_sink_flush", fusion=False)
    assert v["dedupe_hits"] > 0


def test_chaos_stateful_mid_window(tmp_path):
    """:75 — kill the dense-key stateful operator mid-batch: the slot
    table restores to the barrier and the replay continues it."""
    _run_cell(tmp_path, "stateful", "mid_window")


def test_chaos_reduce_mid_epoch(tmp_path):
    """:82 — host keyed Reduce: per-replica rolling state dicts."""
    _run_cell(tmp_path, "reduce", "mid_epoch")


def test_chaos_file_sink_mid_sink_flush(tmp_path):
    """:87 — EpochFileSink: the replayed epoch overwrites its file
    idempotently and nothing is left staged."""
    _run_cell(tmp_path, "stateless_chain", "mid_sink_flush")
    assert wt.EpochFileSink.read_committed(str(tmp_path / "out_b"))
    assert not os.path.exists(
        str(tmp_path / "out_b" / ".staging" / "open.jsonl"))


def test_chaos_remap_restores_record_for_record(tmp_path):
    """tests/test_key_compaction.py:483 — the compacted window's rings
    index by remap slots: the remap restores exactly."""
    _run_cell(tmp_path, "window_compact", "mid_epoch")


# ---------------------------------------------------------------------------
# restore on N±1 replicas
# ---------------------------------------------------------------------------

def test_rescale_restore_reduce_fewer_and_more_shards(tmp_path):
    """:116 — the keyed host Reduce killed at 3 replicas, restored at 2
    and at 4: the per-key state dicts re-bucket through the new
    placement and every key's records stay exact."""
    for restore_p in (2, 4):
        v = chaos.run_rescale_ab(
            "reduce", "mid_epoch", str(tmp_path), shards_kill=3,
            shards_restore=restore_p, n=4096, **CPU)
        assert v["diff"] is None, f"3->{restore_p}: {v['diff']}"
        assert v["restored_epoch"] is not None and v["records"] == 4096


def test_rescale_restore_window_cb_replicas(tmp_path):
    """:131 — keyed CB windows at parallelism 2 restored at 3: the
    shared pane table passes through; the routing re-buckets."""
    v = chaos.run_rescale_ab("window_cb", "mid_epoch", str(tmp_path),
                             shards_kill=2, shards_restore=3, n=4096,
                             **CPU)
    assert v["diff"] is None, v["diff"]
    assert v["restored_epoch"] is not None


def test_rescale_restore_window_tb_replicas(tmp_path):
    """The per-replica TB rings re-home their rows by key when their
    clocks agree (the slow matrix's window_tb 2 -> 3 cell, :158)."""
    v = chaos.run_rescale_ab("window_tb", "mid_epoch", str(tmp_path),
                             shards_kill=2, shards_restore=3, n=6558,
                             **CPU)
    assert v["diff"] is None, v["diff"]


def test_rescale_refuses_torn_sink_fence_then_reconciles(tmp_path):
    """:200 — a kill in the torn window leaves the broker fence one
    epoch ahead of the manifest: a shape-changing restore refuses
    (WF605), a same-shape restore reconciles through the dedupe."""
    cell = _cell(tmp_path, "reduce", "x", n=4096, parallelism=3)
    with pytest.raises(WindFlowError, match="WF605.*fence"):
        chaos.run_killed_and_restored(
            cell["factory"],
            chaos.default_kill("reduce", "mid_sink_flush"),
            restore_factory=lambda: cell["factory"](parallelism=2))
    cell2 = _cell(tmp_path, "reduce", "y", n=4096, parallelism=3)
    g = chaos.run_killed_and_restored(
        cell2["factory"], chaos.default_kill("reduce", "mid_sink_flush"))
    assert g.stats()["Durability"]["dedupe_hits"] > 0


def test_epoch_file_sink_rescale_overwrite_reconciles(tmp_path):
    """:223 — the idempotent rename makes the file sink self-healing
    across a rescale: the committed concatenation stays per-key exact."""
    def build(out_dir, ckpt, parallelism):
        sink = wt.EpochFileSink(out_dir)
        broker = InMemoryBroker()
        broker.create_topic("in", 1)
        p = broker.producer()
        for i in range(4096):
            p.produce("in", {"key": i % 8, "value": float(i)},
                      timestamp_usec=1_000 + i * 7)
        p.produce("in", "EOS", timestamp_usec=1_000 + 4096 * 7)

        def deser(msg, shipper):
            if msg is None:
                return True
            if msg.value == "EOS":
                return False
            shipper.pushWithTimestamp(dict(msg.value), msg.timestamp_usec)
            return True

        def factory(parallelism=parallelism):
            cfg = wt.Config(device="cpu", durability=ckpt,
                            durability_epoch_sweeps=3,
                            punctuation_interval_usec=10 ** 12)

            def red_fn(item, state):
                state["key"] = item["key"]
                state["n"] = state.get("n", 0) + 1

            g = wt.PipeGraph("fsr", config=cfg)
            src = KafkaSource(deser, broker, ["in"], group_id="fsr",
                              name="ksrc", output_batch_size=256)
            g.add_source(src).add(
                wt.Reduce_Builder(red_fn, dict)
                .withKeyBy(lambda t: t["key"])
                .withParallelism(parallelism).withName("red").build()) \
                .add_sink(wt.Sink_Builder(sink).withName("fs").build())
            return g
        return factory

    fb = build(str(tmp_path / "out_a"), str(tmp_path / "ck_a"), 3)
    chaos.run_baseline(fb)
    fc = build(str(tmp_path / "out_b"), str(tmp_path / "ck_b"), 3)
    chaos.run_killed_and_restored(
        fc, chaos.KillSpec("mid_sink_flush", after=2),
        restore_factory=lambda: fc(parallelism=2))
    base = wt.EpochFileSink.read_committed(str(tmp_path / "out_a"))
    resc = wt.EpochFileSink.read_committed(str(tmp_path / "out_b"))
    assert len(base) == 4096
    assert chaos.diff_keyed_records([base], [resc]) is None


def test_manifest_records_mesh_shape_and_placements(tmp_path):
    """:286 (mesh None) — the manifest pins the shard shape: no mesh on
    a one-device graph, and no placement overrides."""
    cell = _cell(tmp_path, "reduce", "m", n=2048, parallelism=2)
    chaos.run_baseline(cell["factory"])
    pending = load_checkpoint(str(tmp_path / "ck_m"))
    assert pending["manifest"]["mesh"] is None
    assert pending["manifest"]["placements"] == {}
    assert pending["placements"] == {}


def test_wf605_unrebucketable_state_refuses_rescale(tmp_path):
    """:300 — a Reduce rescale plans cleanly; an operator overriding
    snapshot_state with an unknown kind refuses a parallelism change
    with WF605, named; so does a mesh-shape change, as in JAX."""
    from windflow_tpu_torch.analysis.preflight import manifest_rescale_plan
    cell = _cell(tmp_path, "reduce", "p", n=2048, parallelism=3)
    g = cell["factory"]()
    ops = g._topo_operators()
    red = [op for op in ops if op.name == "red"][0]
    manifest = {"topology": [dict(s) for s in topology_signature(ops)],
                "mesh": None}
    manifest["topology"][ops.index(red)]["parallelism"] = 5
    diags, rescaled = manifest_rescale_plan(g, manifest)
    assert rescaled and not diags

    class _Custom(type(red)):
        def snapshot_state(self):
            return {"kind": "custom"}
    red.__class__ = _Custom
    manifest = {"topology": [dict(s) for s in topology_signature(ops)],
                "mesh": None}
    manifest["topology"][ops.index(red)]["parallelism"] = 5
    diags, rescaled = manifest_rescale_plan(g, manifest)
    assert rescaled and any(d.code == "WF605" and d.node == "red"
                            for d in diags), diags
    manifest["topology"][ops.index(red)]["parallelism"] = 3
    manifest["mesh"] = {"devices": 4, "data": 1, "key": 4}
    diags, rescaled = manifest_rescale_plan(g, manifest)
    assert rescaled and [d.code for d in diags] == ["WF605"]
    assert "mesh shape changes" in diags[0].message and diags[0].node == "red"


class _FakeTB:
    name = "w"
    max_keys = 8
    is_tb = True
    key_extractor = staticmethod(lambda t: t["key"])


def _tb_state(base, mark_row=None, win_next=0, max_seen=0):
    cells = np.zeros((8, 4), np.float32)
    valid = np.zeros((8, 4), bool)
    if mark_row is not None:
        cells[mark_row, 0] = 42.0
        valid[mark_row, 0] = True
    return {"cells": cells, "cell_valid": valid,
            "horizon": np.full(8, -(1 << 60), np.int64),
            "base": np.asarray(base, np.int64),
            "win_next": np.asarray(win_next, np.int64),
            "max_seen": np.asarray(max_seen, np.int64),
            "n_late": np.asarray(0, np.int64),
            "n_evicted": np.asarray(0, np.int64),
            "n_win_dropped": np.asarray(0, np.int64)}


def test_rebucket_tb_clock_disagreement_raises():
    """:362 — per-replica TB rings whose clocks disagree at the barrier
    cannot merge: RescaleError with the reconciliation recipe, in both
    packages."""
    from windflow_tpu.durability.rebucket import RescaleError as JErr
    from windflow_tpu.durability.rebucket import rebucket_blob as jrb
    from windflow_tpu_torch.durability.rebucket import (RescaleError,
                                                        rebucket_blob)
    blob = {"kind": "ffat_tpu", "states": {0: _tb_state(3),
                                           1: _tb_state(7)},
            "compactor": None}
    with pytest.raises(RescaleError, match="clocks disagree"):
        rebucket_blob(_FakeTB(), blob, 2, 3)
    with pytest.raises(JErr, match="clocks disagree"):
        jrb(_FakeTB(), blob, 2, 3, None, None)
    # a mesh-shape change re-buckets the same rings: the same refusal
    with pytest.raises(RescaleError, match="clocks disagree"):
        rebucket_blob(_FakeTB(), blob, 2, 2, None, {"key": 2})
    with pytest.raises(JErr, match="clocks disagree"):
        jrb(_FakeTB(), blob, 2, 2, None, {"key": 2})


def test_rebucket_compacted_override_translates_keys_to_slots():
    """:395 — a user-key override is translated to the compacted ring's
    slot domain through the checkpointed remap; the result equals the
    JAX re-bucketer's leaf by leaf."""
    from windflow_tpu.durability.rebucket import rebucket_blob as jrb
    from windflow_tpu_torch.durability.rebucket import rebucket_blob
    blob = {"kind": "ffat_tpu",
            "states": {0: _tb_state(5, win_next=2, max_seen=9),
                       1: _tb_state(5, win_next=2, max_seen=9),
                       2: _tb_state(5, 3, win_next=2, max_seen=9)},
            "compactor": {"key_slot": {100: 3}}}
    out = rebucket_blob(_FakeTB(), blob, 3, 4, override={100: 2})
    assert bool(out["states"][2]["cell_valid"][3, 0])
    assert float(out["states"][2]["cells"][3, 0]) == 42.0
    assert not bool(out["states"][3]["cell_valid"][3, 0])
    _same_leaves(out, jrb(_FakeTB(), blob, 3, 4, None, None,
                          override={100: 2}))


# ---------------------------------------------------------------------------
# checkpoint protocol units
# ---------------------------------------------------------------------------

def test_checkpoint_store_layout_and_gc(tmp_path):
    """:446 — epoch-versioned entries, the manifest as the commit
    marker, GC of epochs beyond durability_keep."""
    cell = _cell(tmp_path, "window_cb", "gc", n=4096, epoch_sweeps=2)
    g = cell["factory"]()
    g.run()
    sec = g.stats()["Durability"]
    assert sec["enabled"] and sec["epochs_committed"] >= 3
    assert sec["last_checkpoint_bytes"] > 0
    assert sec["checkpoint_ms_total"] >= sec["last_checkpoint_ms"]
    pending = load_checkpoint(str(tmp_path / "ck_gc"))
    last = sec["epochs_committed"] - 1
    assert pending["epoch"] == last
    assert pending["manifest"]["topology"] == topology_signature(
        g._operators)
    from windflow_tpu_torch.persistent.kv import LogKV
    kv = LogKV(str(tmp_path / "ck_gc" / "checkpoint.kv"))
    try:
        eps = {int(k.split(b"/", 2)[1]) for k in kv.keys()
               if k.startswith(b"ep/")}
        assert 0 not in eps and last in eps
        assert len(eps) <= g.config.durability_keep
    finally:
        kv.close()


def test_restore_into_mismatched_graph_errors_named_diff(tmp_path):
    """:474 — WF602 names the operator and field; nothing starts."""
    cell = _cell(tmp_path, "window_cb", "mm", n=2048)
    cell["factory"]().run()
    cfg = wt.Config(device="cpu", durability=str(tmp_path / "ck_mm"))
    wrong = wt.PipeGraph("chaos", config=cfg)
    src = (wt.Source_Builder(lambda: iter(()))
           .withName("ksrc").withOutputBatchSize(256).build())
    wrong.add_source(src).add(
        wt.MapGPU_Builder(lambda t: t).withName("m").build()).add_sink(
        wt.Sink_Builder(lambda r: None).withName("snk").build())
    with pytest.raises(WindFlowError) as ei:
        wrong.restore()
    assert "WF602" in str(ei.value) and "checkpoint has" in str(ei.value)
    assert not wrong._started
    wrong2 = cell["factory"]()
    wrong2._topo_operators()[1].name = "renamed"
    with pytest.raises(WindFlowError) as ei2:
        wrong2.restore(str(tmp_path / "ck_mm"))
    assert "WF602" in str(ei2.value) and "renamed" in str(ei2.value)


def test_jax_manifest_fails_wf602_against_a_port_graph(tmp_path,
                                                       baselines):
    """The manifest names each package's operator types, so a whole JAX
    checkpoint is refused by a port graph (the blobs cross, the
    manifests do not)."""
    d = baselines("jax", "window_cb")["dir"]
    g = _cell(tmp_path, "window_cb", "x")["factory"]()
    with pytest.raises(WindFlowError, match="WF602.*type"):
        g.restore(str(d / "ck"))


def test_restore_does_not_mutate_shared_config(tmp_path):
    """:503 — restore(dir) copies a shared Config instead of writing the
    checkpoint directory through it."""
    cell = _cell(tmp_path, "window_cb", "sc", n=4096)
    cell["factory"]().run()
    shared = wt.Config(device="cpu", punctuation_interval_usec=10 ** 12)
    assert shared.durability == ""
    g = cell["factory"]()
    g.config = shared
    g.restore(str(tmp_path / "ck_sc"))
    g.wait_end()
    assert shared.durability == ""
    assert g.config.durability == str(tmp_path / "ck_sc")


def test_restore_needs_a_complete_epoch(tmp_path):
    """:520"""
    g = _cell(tmp_path, "window_cb", "empty", n=2048)["factory"]()
    with pytest.raises(WindFlowError, match="nothing to restore"):
        g.restore()


def test_epoch_file_sink_rejects_parallelism(tmp_path):
    """:527 — a shared EpochFileSink at sink parallelism > 1 is refused
    at build, and the store is closed again."""
    cfg = wt.Config(device="cpu", durability=str(tmp_path / "ck"))
    g = wt.PipeGraph("par", config=cfg)
    src = (wt.Source_Builder(lambda: iter([{"v": 1}]))
           .withOutputBatchSize(8).build())
    g.add_source(src).add_sink(
        wt.Sink_Builder(wt.EpochFileSink(str(tmp_path / "out")))
        .withParallelism(2).build())
    with pytest.raises(WindFlowError, match="parallelism == 1"):
        g.start()


def test_epoch_file_sink_cold_restart_discards_stale_staging(tmp_path):
    """:546"""
    d = str(tmp_path / "out")
    dead = wt.EpochFileSink(d)
    dead({"ghost": 1})
    dead._f.flush()
    fresh = wt.EpochFileSink(d)
    fresh({"real": 1})
    fresh.commit_epoch(0)
    assert wt.EpochFileSink.read_committed(d) == [{"real": 1}]


def test_unpicklable_state_errors_name_the_operator(tmp_path):
    """:561"""
    g = _cell(tmp_path, "window_cb", "u", n=4096)["factory"]()
    g.start()
    g._operators[0].snapshot_state = lambda: {"bad": lambda: None}
    with pytest.raises(WindFlowError, match="not.*picklable"):
        g._durability.checkpoint()
    assert "ksrc" in str(
        pytest.raises(WindFlowError, g._durability.checkpoint).value)
    g._finalize()


def test_kafka_part_max_restores_group_level(tmp_path):
    """:597 — per-partition event-time frontiers are group-level:
    every source replica seeds the merged map after a restore."""
    broker = InMemoryBroker()
    broker.create_topic("in", 2)
    p = broker.producer()
    for i in range(3000):
        p.produce("in", {"key": i % 4, "value": float(i)},
                  partition=i % 2, timestamp_usec=1_000 + i)

    def deser(msg, shipper):
        if msg is None:
            return True
        shipper.pushWithTimestamp(dict(msg.value), msg.timestamp_usec)
        return True

    def factory():
        cfg = wt.Config(device="cpu", durability=str(tmp_path / "ck"),
                        durability_epoch_sweeps=2,
                        punctuation_interval_usec=10 ** 12)
        src = KafkaSource(deser, broker, ["in"], group_id="gp",
                          name="ksrc", parallelism=2, output_batch_size=128)
        g = wt.PipeGraph("pmax", config=cfg)
        g.add_source(src).add_sink(wt.Sink_Builder(lambda r: None).build())
        return g

    g = factory()
    g.start()
    chaos.arm(g, chaos.KillSpec("mid_epoch", after=5))
    with pytest.raises(chaos.ChaosKill):
        g.wait_end()
    chaos.abandon(g)
    g2 = factory()
    g2.restore()
    src_op = g2._topo_operators()[0]
    merged = src_op._restore_part_max
    assert set(merged) == {("in", 0), ("in", 1)}
    for rep in src_op.replicas:
        for tp, ts in merged.items():
            assert rep._part_max.get(tp) == ts
    g2._finalize()
    chaos.abandon(g2)


def test_restored_graph_reports_restore_in_stats(tmp_path):
    """:773 — the restored epoch and restore_ms in stats()."""
    cell = _cell(tmp_path, "window_cb", "st", n=4096)
    g2 = chaos.run_killed_and_restored(
        cell["factory"], chaos.default_kill("window_cb", "mid_epoch"))
    sec = g2.stats()["Durability"]
    assert sec["restored_epoch"] is not None
    assert sec["restore_ms"] is not None and sec["restore_ms"] >= 0


def test_durability_off_builds_no_plane(tmp_path):
    """Structural off-path: with Config.durability empty no plane is
    built, the stats section says so and the Kafka sink ships each
    record unbuffered."""
    cell = _cell(tmp_path, "window_cb", "off", n=1024)
    g = cell["factory"]()
    g.config = dataclasses.replace(g.config, durability="")
    g.run()
    assert g._durability is None
    assert g.stats()["Durability"] == {"enabled": False}
    snk = [op for op in g._operators if op.is_terminal][0]
    assert not snk.replicas[0]._durable and not snk.replicas[0]._pending
    assert not os.path.exists(str(tmp_path / "ck_off"))
    assert sum(len(p) for p in cell["read"]()) > 0


def test_snapshot_copies_do_not_alias_live_state(tmp_path):
    """The steps update state in place: a snapshot taken mid-stream
    must not change under the next steps (CPU tensors share memory with
    ``.numpy()``)."""
    cell = _cell(tmp_path, "window_cb", "al", n=4096)
    g = cell["factory"]()
    g.start()
    win = [op for op in g._operators if op.name == "w"][0]
    while not win._states:
        g.step()
    blob = win.snapshot_state()
    frozen = copy.deepcopy(blob)
    for _ in range(4):
        g.step()
    _same_leaves(blob, frozen)
    g._finalize()
    chaos.abandon(g)


# ---------------------------------------------------------------------------
# key compaction (tests/test_key_compaction.py:345, :499)
# ---------------------------------------------------------------------------

def _stream(n, key_of, v_of):
    return [{"key": np.int32(key_of(i)), "v": np.float32(v_of(i))}
            for i in range(n)]


def _kc_cfg(pkg, compact):
    if pkg is wt:
        return wt.Config(device="cpu", key_compaction=compact,
                         punctuation_interval_usec=10 ** 12)
    return dataclasses.replace(wf.basic.default_config,
                               key_compaction=compact,
                               punctuation_interval_usec=10 ** 12)


def _records(got):
    def sink(r, ctx=None):
        if r is not None:
            got.append(tuple(sorted((k, float(v)) for k, v in r.items())))
    return sink


def _stateful_graph(pkg, stream, compact, restore=None):
    """A host-fed keyed stateful map over arbitrary int32 keys (the
    compacted route with key compaction on, interning off); ``restore``
    is a blob applied after the build, before the first tick."""
    got = []
    src = (pkg.Source_Builder(lambda: iter(stream))
           .withOutputBatchSize(64).withName("src").build())
    mb = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
    op = (mb(lambda t, s: ({"key": t["key"], "v": t["v"] + s}, s + 1.0))
          .withInitialState(np.float32(0.0))
          .withKeyBy(lambda t: t["key"])
          .withNumKeySlots(64).withName("sm").build())
    g = pkg.PipeGraph("kc_xkill", pkg.ExecutionMode.DEFAULT,
                      config=_kc_cfg(pkg, compact))
    g.add_source(src).add(op).add_sink(
        pkg.Sink_Builder(_records(got)).build())
    g.start()
    if restore is not None:
        op.restore_state(restore)
    g.wait_end()
    return got, op


KC_STREAM = _stream(512, lambda i: (i * 13) % 37 - 5, lambda i: float(i))


def test_stateful_restore_across_kill_switch():
    """:345 — a compacted checkpoint restored with compaction off folds
    the remap into the host interner; an interned checkpoint restored
    with compaction on keeps the interning route."""
    _, op_a = _stateful_graph(wt, KC_STREAM[:256], True)
    _, op_b = _stateful_graph(wt, KC_STREAM[:256], False)
    blob_a, blob_b = op_a.snapshot_state(), op_b.snapshot_state()
    op_b.restore_state(blob_a)
    assert op_b._interner._ids == op_a._compactor.export_mapping()
    assert op_a._compactor is not None
    op_a.restore_state(blob_b)
    assert op_a._compactor is None


def test_compactor_snapshot_round_trip():
    """:499 — snapshot/restore reproduce the key→slot table, the free
    list and the cadence counters on a fresh instance."""
    c = KeyCompactor(8, reseed_every=4, name="u")
    c.observe(np.array([5, 9, 5, 130], np.int64))
    c.on_batch()
    blob = c.snapshot()
    r = KeyCompactor(8, reseed_every=4, name="u")
    r.restore(blob)
    assert r.slot_of(5) == c.slot_of(5) and r.slot_of(130) == c.slot_of(130)
    assert sorted(r._free) == sorted(c._free)
    assert np.array_equal(r._tk, c._tk) and np.array_equal(r._tsl, c._tsl)
    assert (r.admits, r._batches, r.active) == (c.admits, c._batches, True)


# ---------------------------------------------------------------------------
# wire (tests/test_wire.py:373-398) and megastep (test_megastep.py:283-333)
# ---------------------------------------------------------------------------

def _wire_output(tmp_path, family, wire_on, tag, kill=False, n=1024):
    cell = _cell(tmp_path, family, tag, n=n, wire_compression=wire_on)
    if kill:
        g = chaos.run_killed_and_restored(
            cell["factory"], chaos.default_kill(family, "mid_epoch"))
    else:
        g = chaos.run_baseline(cell["factory"])
    if wire_on and family != "reduce":
        ws = g.stats()["Staging"]["Wire"]
        assert ws["batches"] > 0, (family, ws)
    return cell["read"]()


@pytest.mark.parametrize("family", ["window_cb", "window_tb", "reduce",
                                    "stateless_chain"])
def test_chaos_family_ab_compressed_vs_killswitch(family, tmp_path):
    on = _wire_output(tmp_path, family, True, "on")
    off = _wire_output(tmp_path, family, False, "off")
    assert chaos.diff_records(off, on) is None


def test_durability_kill_restore_diff_with_compression_on(tmp_path):
    base = _wire_output(tmp_path, "window_cb", True, "base", n=4096)
    killed = _wire_output(tmp_path, "window_cb", True, "killed",
                          kill=True, n=4096)
    assert chaos.diff_records(base, killed) is None


def test_chaos_kill_restore_megastep_epochs(tmp_path):
    """K = 4 forced on the CPU (the wire makes the Kafka record path a
    packed staged edge): the CB cell folds, its cadence of 3 logical
    sweeps rounds to 1 scheduler sweep so every quiesce lands between
    megasteps, and a mid-epoch kill + restore diffs empty."""
    kw = dict(megastep_sweeps=4, wire_compression=True)
    base = _cell(tmp_path, "window_cb", "ma", **kw)
    chal = _cell(tmp_path, "window_cb", "mb", **kw)
    gb = chaos.run_baseline(base["factory"])
    ms = gb.stats()["Megastep"]
    assert ms["k"] == 4 and ms["edges"][0]["megasteps"] > 0
    assert gb.config.durability_epoch_sweeps == 1
    gc = chaos.run_killed_and_restored(
        chal["factory"], chaos.KillSpec("mid_epoch", after=2))
    assert chaos.diff_records(base["read"](), chal["read"]()) is None
    assert gc.stats()["Durability"]["restored_epoch"] is not None


def test_epoch_cadence_keeps_logical_sweep_meaning(tmp_path):
    """The cadence reads as logical sweeps under a folded edge: K = 4
    commits at least as many epochs as K = 1, never K times fewer."""
    def committed(k):
        g = chaos.run_baseline(_cell(
            tmp_path, "window_cb", f"k{k}", epoch_sweeps=4,
            megastep_sweeps=k, wire_compression=True)["factory"])
        return g.stats()["Durability"]["epochs_committed"]
    c1, c4 = committed(1), committed(4)
    assert c1 > 0 and c4 >= c1


# ---------------------------------------------------------------------------
# cross-package A/B
# ---------------------------------------------------------------------------

def _same_leaves(a, b, path="blob"):
    """Leaf-by-leaf equality: dict keys, array shapes, dtypes and
    values, scalar values and types."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            (path, set(a) ^ set(b) if isinstance(b, dict) else b)
        for k in a:
            _same_leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_leaves(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        x, y = np.asarray(a), np.asarray(b)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), \
            (path, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("family", chaos.FAMILIES)
def test_port_restored_equals_jax_uninterrupted(family, tmp_path,
                                                baselines):
    """(i) — the port's killed and restored run equals both its own
    uninterrupted run and the JAX package's, record for record."""
    cell = _cell(tmp_path, family, "k")
    chaos.run_killed_and_restored(cell["factory"],
                                  chaos.default_kill(family, "mid_epoch"))
    got = cell["read"]()
    assert chaos.diff_records(baselines("port", family)["out"], got) \
        is None
    assert chaos.diff_records(baselines("jax", family)["out"], got) is None


CKPT_FAMILIES = ("window_cb", "window_tb", "stateful", "window_compact")


@pytest.mark.parametrize("family", CKPT_FAMILIES)
def test_checkpoint_blobs_equal_jax_leaf_by_leaf(family, baselines):
    """(ii) — the same cell checkpoints at the same epoch and stream
    position in both packages, and each operator blob is the JAX one
    leaf by leaf; the pickled port blob holds no torch object."""
    pt = baselines("port", family)["pending"]
    pj = baselines("jax", family)["pending"]
    assert pt["epoch"] == pj["epoch"]
    pos = [[r.get("kafka_positions") for r in p["reps"]] for p in (pt, pj)]
    assert pos[0] == pos[1]
    assert set(pt["ops"]) == set(pj["ops"]) and pt["ops"]
    for ordinal in pt["ops"]:
        _same_leaves(pt["ops"][ordinal], pj["ops"][ordinal])
        assert b"torch" not in pickle.dumps(pt["ops"][ordinal])


def _restore_suffix(make, pending, blobs, d, family, **kw):
    """Build a fresh cell of the family (its own broker, the same
    input) whose graph restores ``pending`` with its operator blobs
    replaced by ``blobs``, drive it to the end, and return what it sank:
    the suffix after the checkpoint."""
    shutil.rmtree(d, ignore_errors=True)
    cell = make(family, str(d / "ck"), out_dir=str(d / "out"), **kw)
    g = cell["factory"]()
    pend = dict(pending, ops=dict(blobs), rescaled=False)
    g._pending_restore = pend
    g.start()
    g.wait_end()
    return cell["read"]()


@pytest.mark.parametrize("family", CKPT_FAMILIES)
def test_blobs_cross_restore_both_ways(family, tmp_path, baselines):
    """(iii) — a JAX blob restored into the port's operator, then the
    suffix, gives the JAX package's uninterrupted records from the
    checkpoint on; a port blob restored into the JAX operator gives the
    port's."""
    bt, bj = baselines("port", family), baselines("jax", family)
    seq = [r["sink_seq"] for r in bt["pending"]["reps"]
           if "sink_seq" in r][0]
    got = _restore_suffix(chaos.make_cell, bt["pending"],
                          bj["pending"]["ops"], tmp_path / "t", family,
                          **CPU)
    back = _restore_suffix(jchaos.make_cell, bj["pending"],
                           bt["pending"]["ops"], tmp_path / "j", family)
    assert chaos.diff_records([bj["out"][0][seq:]], got) is None
    assert chaos.diff_records([bt["out"][0][seq:]], back) is None
    assert sum(len(p) for p in got) > 0


def test_stateful_compacted_blob_equals_jax_and_crosses(tmp_path):
    """(ii) and (iii) for the compacted stateful route: after the same
    prefix the blobs (table, interner, remap) are equal leaf by leaf,
    and the suffix run from either package's blob in the other's
    operator gives the JAX package's uninterrupted records."""
    pre, suf = KC_STREAM[:256], KC_STREAM[256:]
    full, _ = _stateful_graph(wf, KC_STREAM, True)
    _, op_t = _stateful_graph(wt, pre, True)
    _, op_j = _stateful_graph(wf, pre, True)
    bt, bj = op_t.snapshot_state(), op_j.snapshot_state()
    _same_leaves(bt, bj)
    assert b"torch" not in pickle.dumps(bt)
    got_t, _ = _stateful_graph(wt, suf, True, restore=bj)
    got_j, _ = _stateful_graph(wf, suf, True, restore=bt)
    assert got_t == got_j == full[256:]


def _reduce_graph(pkg, stream, compact, max_keys, restore=None):
    got = []
    mx = torch.maximum if pkg is wt else __import__("jax").numpy.maximum
    src = (pkg.Source_Builder(lambda: iter(stream))
           .withOutputBatchSize(64).withName("src").build())
    rb = wt.ReduceGPU_Builder if pkg is wt else wf.ReduceTPU_Builder
    b = (rb(lambda a, b: {"key": mx(a["key"], b["key"]),
                          "v": mx(a["v"], b["v"])})
         .withKeyBy(lambda t: t["key"]).withMonoidCombiner("max")
         .withName("red"))
    if max_keys is not None:
        b = b.withMaxKeys(max_keys)
    op = b.build()
    g = pkg.PipeGraph("red_blob", pkg.ExecutionMode.DEFAULT,
                      config=_kc_cfg(pkg, compact))
    g.add_source(src).add(op).add_sink(
        pkg.Sink_Builder(_records(got)).build())
    g.start()
    if restore is not None:
        op.restore_state(restore)
    g.wait_end()
    return got, op


@pytest.mark.parametrize("route", ["dense", "compacted"])
def test_gpu_reduce_blob_equals_jax_and_crosses(route):
    """(ii) and (iii) for ReduceGPU: the dense route's accumulated drop
    counter (keys beyond withMaxKeys) and the unbounded compacted
    route's remap, equal leaf by leaf after the same prefix; restored
    across packages, the suffix gives the JAX records and the drop
    count continues from the checkpoint."""
    if route == "dense":
        stream = _stream(512, lambda i: (i * 7) % 29, lambda i: i % 11)
        compact, mk = False, 23
    else:
        stream = _stream(512, lambda i: (i * 7) % 23 + 1000,
                         lambda i: i % 11)
        compact, mk = True, None
    pre, suf = stream[:256], stream[256:]
    full, op_full = _reduce_graph(wf, stream, compact, mk)
    _, op_t = _reduce_graph(wt, pre, compact, mk)
    _, op_j = _reduce_graph(wf, pre, compact, mk)
    bt, bj = op_t.snapshot_state(), op_j.snapshot_state()
    _same_leaves(bt, bj)
    assert b"torch" not in pickle.dumps(bt)
    got_t, rt = _reduce_graph(wt, suf, compact, mk, restore=bj)
    got_j, rj = _reduce_graph(wf, suf, compact, mk, restore=bt)
    assert got_t == got_j == full[len(full) - len(got_t):]
    assert rt.num_dropped_tuples() == rj.num_dropped_tuples() == \
        op_full.num_dropped_tuples()
    if route == "dense":
        assert bt["dropped"] > 0


def test_durability_modules_import_neither_jax_nor_the_jax_package():
    """The new subpackages stand alone: importing every module of
    ``durability``, ``kafka``, ``persistent`` and ``analysis`` pulls in
    neither JAX nor ``windflow_tpu``."""
    import subprocess
    import sys
    mods = ["durability", "durability.chaos", "durability.checkpoint",
            "durability.rebucket", "durability.sinks", "kafka",
            "kafka.client", "kafka.kafka_source", "kafka.kafka_sink",
            "kafka.builders_kafka", "persistent", "persistent.kv",
            "analysis.diagnostics", "analysis.preflight"]
    code = ("import sys\n"
            + "".join(f"import windflow_tpu_torch.{m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'windflow_tpu')]\n"
              "assert not bad, bad\nprint('clean')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr
