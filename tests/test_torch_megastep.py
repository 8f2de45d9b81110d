"""The port's megastep plane (windflow_tpu_torch/megastep.py) against the
JAX package's (windflow_tpu/megastep.py), on the CPU: the eager K-row
loop, the plain version of the captured CUDA graph the card replays.

Seeded numpy frames (``tests/test_megastep.py``'s shape: N 4,096 tuples,
batches of 256, 8 keys, integer-valued values) feed one foldable tail per
family of ``tests/test_megastep.py:42``:

* the port at K = 1, the port at K = 4 and ``windflow_tpu`` at K = 4 give
  identical records, and the ``Megastep`` stats section counts
  (``megasteps``, ``batches``, ``fallback_batches``, ``warmup_batches``,
  ``freshness_floor_usec``) equal JAX's;
* ``stateful`` runs twice: with ``withAssociativeUpdate`` and as JAX's
  wavefront function; both fold (the wavefront's device loop is a WHILE
  node the card's capture holds, as JAX's scan holds its
  ``lax.while_loop``); under ``Config(cuda_kernels="0")`` on the card
  the wavefront is refused with the named reason;
* K = 8 on a window, wire plus megastep together, a forced TB ring
  regrow (the group body is rebuilt, records equal), "auto" on the CPU,
  K = 1 (no edge), ``round_epoch_to_megastep``, ``tail_kind``'s
  refusals, and the launch counters' arithmetic under a stub graph.
Exact everywhere.
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.io.frames import FrameSource as JFrameSource
from windflow_tpu_torch import megastep as ms
from windflow_tpu_torch.kernels import ffat_cuda as fc

# one intra-op thread: toy sizes beside other test workers
torch.set_num_threads(1)

N, CAP, KEYS = 4096, 256, 8
SPEC = {"key": np.int32(0), "v": np.float32(0.0)}
COUNTS = ("megasteps", "batches", "fallback_batches", "warmup_batches",
          "freshness_floor_usec")


def _blob(n, seed=7, gaps=None):
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    rec["k"] = rng.integers(0, KEYS, n)
    rec["ts"] = np.arange(n, dtype=np.int64) * 500 if gaps is None \
        else np.cumsum(gaps)
    rec["v"] = rng.integers(0, 100, n)
    return rec.tobytes()


def _source(pkg, n, spec=False, gaps=None):
    blob = _blob(n, gaps=gaps)
    step = CAP * 24

    def chunks():
        for i in range(0, len(blob), step):
            yield blob[i:i + step]
    cls = wt.FrameSource if pkg is wt else JFrameSource
    src = cls(chunks, nv=1, fields=["v"], output_batch_size=CAP)
    if spec:
        src.record_spec = SPEC      # the JAX FrameSource: an attribute
    return src


def _tail(pkg, family):
    jax_side = pkg is wf
    FB = wf.Ffat_WindowsTPU_Builder if jax_side \
        else wt.Ffat_WindowsGPU_Builder
    RB = wf.ReduceTPU_Builder if jax_side else wt.ReduceGPU_Builder
    MB = wf.MapTPU_Builder if jax_side else wt.MapGPU_Builder
    if family == "window_cb":
        return (FB(lambda t: t["v"], lambda a, b: a + b)
                .withCBWindows(64, 32).withKeyBy(lambda t: t["key"])
                .withMaxKeys(KEYS).withName("w").build())
    if family == "window_tb":
        return (FB(lambda t: t["v"], lambda a, b: a + b)
                .withTBWindows(16_000, 4_000).withKeyBy(lambda t: t["key"])
                .withMaxKeys(KEYS).withLateness(8_000).withName("w")
                .build())
    if family == "reduce_sorted":
        return (RB(lambda a, b: {"key": a["key"], "v": a["v"] + b["v"]})
                .withKeyBy(lambda t: t["key"]).withName("w").build())
    if family == "reduce_dense":
        return (RB(lambda a, b: a).withKeyBy(lambda t: t["key"])
                .withMaxKeys(KEYS).withSumCombiner().withName("w").build())

    def f(rec, st):
        st = {"acc": st["acc"] + rec["v"]}
        return {"key": rec["key"], "v": st["acc"]}, st
    b = (MB(f).withKeyBy(lambda t: t["key"])
         .withInitialState({"acc": np.float32(0)})
         .withNumKeySlots(KEYS).withDenseKeys())
    if family == "stateful_assoc":
        b = b.withAssociativeUpdate(
            lambda r: {"acc": r["v"]},
            lambda a, c: {"acc": a["acc"] + c["acc"]},
            lambda r, s: {"key": r["key"], "v": s["acc"]})
    return b.withName("w").build()


def _run(pkg, family, k, n=N, wire=False, gaps=None):
    """One graph run at ``megastep_sweeps=k``: (records, Megastep
    section, graph).  Punctuation off the wall clock, so the group
    boundaries are the same in both packages; key compaction off, as
    tests/test_megastep.py runs the fold itself."""
    out = []
    kw = dict(megastep_sweeps=k, key_compaction=False,
              wire_compression=wire, punctuation_interval_usec=10 ** 12)
    cfg = wt.Config(device="cpu", **kw) if pkg is wt \
        else dataclasses.replace(wf.default_config, **kw)
    g = pkg.PipeGraph(f"ms_{family}_{k}", time_policy=pkg.TimePolicy.EVENT,
                      config=cfg)
    g.add_source(_source(pkg, n, spec=wire, gaps=gaps)) \
        .add(_tail(pkg, family)).add_sink(pkg.Sink_Builder(
            lambda r: out.append(r) if r is not None else None).build())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g.run()
    return out, g.stats()["Megastep"], g


def _norm(recs):
    """Records as rows of (field, kind, value): exact, in sink order."""
    return [tuple(sorted((k, np.asarray(v).dtype.kind, np.asarray(v).item())
                         for k, v in r.items())) for r in recs]


def _counts(edge):
    return {k: edge[k] for k in COUNTS}


@pytest.mark.parametrize("family", ["window_cb", "window_tb",
                                    "reduce_sorted", "reduce_dense",
                                    "stateful_assoc", "stateful"])
def test_k4_equals_k1_and_jax(family):
    base, ms1, _ = _run(wt, family, 1)
    fold, ms4, g = _run(wt, family, 4)
    jfold, jms4, _ = _run(wf, family, 4)
    assert base, "empty output proves nothing"
    assert _norm(base) == _norm(fold) == _norm(jfold)
    # K = 1 is the kill switch: no plane edges
    assert ms1["k"] == 1 and ms1["edges"] == []
    e, je = ms4["edges"][0], jms4["edges"][0]
    assert e["kind"] == je["kind"] and e["k"] == 4
    assert _counts(e) == _counts(je)
    assert e["megasteps"] > 0 and e["batches"] == 4 * e["megasteps"]
    assert e["batches"] + e["warmup_batches"] + e["fallback_batches"] \
        == N // CAP
    assert e["captures"] == 1 and ms4["refused"] == []
    # every logical batch was counted on the tail replica
    rep = g.pipes[0].operators[1].replicas[0]
    assert rep.stats.device_programs_launched >= N // CAP


def test_stateful_wavefront_is_refused_by_name_records_equal():
    """The dense wavefront folds (K = 4 records equal K = 1 and JAX's, one
    group body) wherever its device loop is in force: on the CPU and
    with the kernels on.  Under ``cuda_kernels="0"`` on the card its
    plain version reads its per-rank lane counts on the host, so the
    plane refuses it with a reason that names the kernels being off."""
    base, _, _ = _run(wt, "stateful", 1)
    got, ms4, _ = _run(wt, "stateful", 4)
    jgot, jms4, _ = _run(wf, "stateful", 4)
    assert base and _norm(base) == _norm(got) == _norm(jgot)
    assert ms4["refused"] == [] and ms4["edges"][0]["kind"] == "stateful"
    assert ms4["edges"][0]["megasteps"] == jms4["edges"][0]["megasteps"] > 0
    op = _tail(wt, "stateful")
    assert ms.tail_kind(op) == ("stateful", None)
    op.device = torch.device("cuda", 0)
    assert ms.tail_kind(op) == ("stateful", None)
    op.config = dataclasses.replace(op.config, cuda_kernels="0")
    kind, why = ms.tail_kind(op)
    assert kind is None and why.startswith("stateful wavefront")
    assert "cuda_kernels='0'" in why
    op.device = torch.device("cpu")
    assert ms.tail_kind(op) == ("stateful", None)


def test_k8_on_a_window():
    base, _, _ = _run(wt, "window_cb", 1, n=8192)
    fold, ms8, _ = _run(wt, "window_cb", 8, n=8192)
    jfold, jms8, _ = _run(wf, "window_cb", 8, n=8192)
    assert _norm(base) == _norm(fold) == _norm(jfold)
    e = ms8["edges"][0]
    assert e["k"] == 8 and e["megasteps"] > 0
    assert _counts(e) == _counts(jms8["edges"][0])


@pytest.mark.parametrize("family", ["window_cb", "window_tb"])
def test_wire_and_megastep_together(family):
    """The group body runs the same wire decode the per-batch unpack
    runs: records and counts equal K = 1 and JAX with wire on."""
    base, _, _ = _run(wt, family, 1, wire=True)
    fold, ms4, g = _run(wt, family, 4, wire=True)
    jfold, jms4, _ = _run(wf, family, 4, wire=True)
    assert _norm(base) == _norm(fold) == _norm(jfold)
    assert _counts(ms4["edges"][0]) == _counts(jms4["edges"][0])
    ws = g.stats()["Staging"]["Wire"]
    assert ws["batches"] == N // CAP and ws["wire_bytes"] \
        < ws["logical_bytes"]


def test_tb_ring_regrow_rebuilds_the_group_body():
    """A stream whose time spread grows mid-run regrows the TB ring: the
    step is rebuilt, so the group body is rebuilt (a recapture on the
    card), and the records equal K = 1's and JAX's."""
    gaps = np.r_[np.full(N // 2, 500), np.full(N // 2, 20_000)]
    base, _, _ = _run(wt, "window_tb", 1, gaps=gaps)
    fold, ms4, g = _run(wt, "window_tb", 4, gaps=gaps)
    jfold, jms4, _ = _run(wf, "window_tb", 4, gaps=gaps)
    assert base and _norm(base) == _norm(fold) == _norm(jfold)
    e = ms4["edges"][0]
    assert e["captures"] >= 2 and e["megasteps"] > 0
    assert _counts(e) == _counts(jms4["edges"][0])


def test_auto_resolves_per_device():
    assert ms.resolve_megastep(wt.Config(device="cpu")) == 1
    assert ms.resolve_megastep(wt.Config(device="cuda")) == ms.AUTO_K == 8
    assert ms.resolve_megastep(wt.Config(device="cpu",
                                         megastep_sweeps=4)) == 4
    assert ms.resolve_megastep(wt.Config(device="cuda",
                                         megastep_sweeps="1")) == 1
    assert ms.megastep_forced(wt.Config(megastep_sweeps="auto")) == 0
    assert ms.megastep_forced(wt.Config(megastep_sweeps=8)) == 8
    assert ms.megastep_forced(wt.Config(megastep_sweeps=1)) == 0


def test_auto_on_the_cpu_and_k1_build_no_edge():
    for k in ("auto", 1):
        _, sec, g = _run(wt, "reduce_dense", k)
        assert sec == {"k": 1, "edges": [], "refused": []}
        em = g.pipes[0].operators[0].replicas[0].emitter
        assert em._megastep is None
        assert g._tick_chunk(g._source_replicas[0]) == CAP


def test_round_epoch_to_megastep():
    """The configured cadence reads as logical sweeps and becomes
    scheduler sweeps: ceil(eps / K); stable at its fixpoint; inactive
    planes leave it alone."""
    plane = ms.MegastepPlane(4)
    plane.edges.append(object())
    cfg = types.SimpleNamespace(durability_epoch_sweeps=3)
    assert ms.round_epoch_to_megastep(cfg, plane) == 1
    assert cfg.durability_epoch_sweeps == 1
    cfg.durability_epoch_sweeps = 8
    assert ms.round_epoch_to_megastep(cfg, plane) == 2
    cfg.durability_epoch_sweeps = 1
    assert ms.round_epoch_to_megastep(cfg, plane) is None
    cfg.durability_epoch_sweeps = 3
    assert ms.round_epoch_to_megastep(cfg, ms.MegastepPlane(1)) is None
    assert cfg.durability_epoch_sweeps == 3
    # the port's Config carries the field with the JAX default (64
    # logical sweeps): 16 scheduler sweeps at K = 4
    cfg = wt.Config()
    assert ms.round_epoch_to_megastep(cfg, plane) == 16
    assert cfg.durability_epoch_sweeps == 16


def _built(tail, fuse=True, compact=False, pre=None):
    g = wt.PipeGraph("tk", time_policy=wt.TimePolicy.EVENT,
                     config=wt.Config(device="cpu", megastep_sweeps=4,
                                      key_compaction=compact,
                                      whole_chain_fusion=fuse))
    pipe = g.add_source(_source(wt, CAP))
    if pre is not None:
        pipe = pipe.add(pre)
    pipe.add(tail).add_sink(wt.Sink_Builder(lambda r: None).build())
    g._build()
    return g


def test_tail_kind_refusals_are_named():
    host = wt.Reduce_Builder(lambda t, st: None, dict).withKeyBy(
        lambda t: t["key"]).build()
    assert ms.tail_kind(host)[1].startswith("host operator")
    # compacted: a declared-monoid reduce under key compaction
    red = (wt.ReduceGPU_Builder(lambda a, b: a).withKeyBy(lambda t: t["key"])
           .withMaxKeys(KEYS).withSumCombiner().build())
    g = _built(red, compact=True)
    assert red._compactor is not None
    assert ms.tail_kind(red)[1].startswith("compacted key space")
    assert g.stats()["Megastep"]["refused"][0]["operator"] == red.name
    # the mesh placeholder (the port has no mesh path yet)
    win = _tail(wt, "window_cb")
    assert ms.tail_kind(win) == ("ffat_cb", None)
    win.mesh = object()
    assert ms.tail_kind(win)[1].startswith("mesh-sharded state")
    # an all-stateless fused segment: no stateful tail step to carry
    m = wt.MapGPU_Builder(lambda t: t).build()
    f = wt.FilterGPU_Builder(lambda t: t["key"] >= 0).build()
    g = _built(f, pre=m)
    assert f._fusion_exec is not None
    assert ms.tail_kind(f)[1].startswith("all-stateless fused segment")
    assert g.stats()["Megastep"]["edges"] == []
    # the wavefront: its device loop folds (the kernels-off refusal on
    # the card: test_stateful_wavefront_is_refused_by_name_records_equal)
    assert ms.tail_kind(_tail(wt, "stateful")) == ("stateful", None)
    assert ms.tail_kind(_tail(wt, "stateful_assoc")) == ("stateful", None)


def test_launch_counters_count_each_captured_call_once_a_replay():
    """The counter arithmetic of ``CountedGraph`` with a stub graph: calls
    made while capturing count nothing then and once on every replay."""

    class StubGraph:
        replays = 0

        def replay(self):
            StubGraph.replays += 1

    fc.reset_launch_counts()
    fc.count_launch("dense_monoid_table")        # one eager launch
    cg = fc.CountedGraph(StubGraph())
    with cg.capture(_NullCtx()):
        fc.count_launch("grouping_rank_hist")
        fc.count_launch("sliding_fold")
        fc.count_launch("sliding_fold")
    assert cg.launches == {"grouping_rank_hist": 1, "sliding_fold": 2}
    assert cg.launches_per_replay() == 3
    assert fc.launch_counts() == {"grouping_rank_hist": 0, "sliding_fold": 0,
                                  "dense_monoid_table": 1,
                                  "wavefront_loop": 0,
                                  "cond_select": 0}
    for _ in range(3):
        cg.replay()
    assert StubGraph.replays == 3
    assert fc.launch_counts() == {"grouping_rank_hist": 3, "sliding_fold": 6,
                                  "dense_monoid_table": 1,
                                  "wavefront_loop": 0,
                                  "cond_select": 0}
    fc.reset_launch_counts()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
