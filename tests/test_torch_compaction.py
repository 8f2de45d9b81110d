"""Key compaction of the port (windflow_tpu_torch/parallel/compaction.py:
``KeyCompactor``, ``attach_compaction`` and the compacted reduce,
stateful and window routes) against the JAX package, on the CPU.

The families of tests/test_key_compaction.py, each run through both
packages' ``PipeGraph.run()`` on the same records where it builds a
graph: the unbounded compacted reduce against the sorted and
declared-dense routes, an undeclared reduce that never compacts, the
compacted stateful route against interning, compacted window keys
(count and time windows) against a declared baseline with the user's
keys in the output, the all-cold / all-hot / Zipf-shift streams, the
sentinel key on the reduce and the stateful routes, the window and
stateful slot overflows, the dead admission path, concurrent admission,
one step a batch, the kill switch and its window error, and the
compactor's unit contracts (one estimation pass a reseed, the packed
min at the ts floor, lock-free ``observe_one``, the sentinel counter);
plus the placement override on the keyed staging and device keyby
edges.  The bounded reroute (:428) is in tests/test_torch_reduce.py.

Left out, with the parts they need: the restore across the kill switch
(:345), the chaos remap cell (:465 of the stats section is the shard
plane's, :483) and the snapshot round trip (:499) wait for durability
(ROADMAP A7) and the shard plane (A8); the preflight advice WF404/WF405
(:561, :585) waits for the analysis plane (A9).  Without the shard
sketch (A8) no port graph ranks its residents, so a full evictable
table does not churn: the Zipf-shift family checks the records and the
reseeds, and the eviction walk itself is checked on a bound sketch
(:658).

Tolerance: every family is exact (max over floats, integer-valued sums).
"""

import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu.parallel import compaction as jcp
from windflow_tpu_torch.parallel import compaction as tcp
from windflow_tpu_torch.parallel.compaction import KEY_SENTINEL, KeyCompactor

# one intra-op thread: these tests run at toy sizes beside other test
# workers, and torch's default pool would oversubscribe the CPU
torch.set_num_threads(1)

CAP = 64
MAX = {wf: jnp.maximum, wt: torch.maximum}


def _cfg(pkg, compact=True, **kw):
    # no time-driven punctuation: a flush would cut a batch short at a
    # moment that depends on the host's speed, and the per-batch reduce
    # records depend on the batches
    kw.setdefault("punctuation_interval_usec", 10 ** 12)
    if pkg is wt:
        return wt.Config(device="cpu", key_compaction=compact, **kw)
    return dataclasses.replace(wf.basic.default_config,
                               key_compaction=compact, **kw)


def _dev(pkg, kind):
    return getattr(pkg, f"{kind}{'GPU' if pkg is wt else 'TPU'}_Builder")


def _sink(pkg, got):
    def s(r, ctx=None):
        if r is None:
            return
        got.append(tuple(sorted((k, float(v)) for k, v in r.items()))
                   if isinstance(r, dict) else float(r))
    return pkg.Sink_Builder(s).withName("snk").build()


def _run_reduce(pkg, stream, *, compact=True, monoid="max", max_keys=None,
                name="red", cap=CAP, par=1, device_edge=False, **cfg_kw):
    got = []
    mx = MAX[pkg]
    src = (pkg.Source_Builder(lambda: iter(stream))
           .withOutputBatchSize(cap).withName("src").build())
    b = (_dev(pkg, "Reduce")(
            lambda a, b: {"key": mx(a["key"], b["key"]),
                          "v": mx(a["v"], b["v"])})
         .withKeyBy(lambda t: t["key"]).withName(name)
         .withParallelism(par))
    if monoid is not None:
        b = b.withMonoidCombiner(monoid)
    if max_keys is not None:
        b = b.withMaxKeys(max_keys)
    op = b.build()
    g = pkg.PipeGraph("kc_reduce", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, compact, **cfg_kw))
    pipe = g.add_source(src)
    if device_edge:
        pipe.add(_dev(pkg, "Map")(lambda t: {"key": t["key"], "v": t["v"]})
                 .withName("relay").build())
    pipe.add(op).add_sink(_sink(pkg, got))
    g.run()
    return got, op, g


def _stream(n, key_of, v_of=None):
    v_of = v_of or (lambda i: -2.0 - ((i * 29) % 83) / 7.0)
    return [{"key": np.int32(key_of(i)), "v": np.float32(v_of(i))}
            for i in range(n)]


def _same_summary(op_t, op_j, keys=("tuples", "hit_rate", "overflow_share",
                                    "overflow_tuples", "big_fallbacks",
                                    "occupied", "admits", "batches",
                                    "pinned", "bounded")):
    st, sj = op_t._compactor.summary(), op_j._compactor.summary()
    for k in keys:
        assert st[k] == sj[k], (k, st[k], sj[k])
    return st


# ---------------------------------------------------------------------------
# record-for-record: compacted vs sorted vs declared-dense
# ---------------------------------------------------------------------------

def test_compacted_reduce_matches_sorted_and_dense():
    """:73 — arbitrary sparse int32 keys, declared monoid: the unbounded
    compacted route emits the sorted route's records and the JAX
    package's; the same stream shifted into [0, K) through the
    declared-dense route agrees too."""
    stream = _stream(512, lambda i: (i * 7) % 23 + 1000)
    compacted, op, _ = _run_reduce(wt, stream, compact=True)
    jcompacted, jop, _ = _run_reduce(wf, stream, compact=True)
    sorted_, sop, _ = _run_reduce(wt, stream, compact=False)
    assert compacted == jcompacted == sorted_ and len(compacted) > 0
    assert sop._compactor is None and not op.bounded_compaction
    s = _same_summary(op, jop)
    assert s["hit_rate"] == 1.0 and s["overflow_share"] == 0.0
    base = _stream(512, lambda i: (i * 7) % 23)
    dense, _, _ = _run_reduce(wt, base, compact=False, max_keys=23)
    shift = [tuple((k, v - 1000.0 if k == "key" else v) for k, v in r)
             for r in compacted]
    assert shift == dense


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_undeclared_reduce_keeps_sorted_path(pkg):
    """:93 — no monoid: nothing attaches, the records stay sorted's."""
    stream = _stream(256, lambda i: (i * 11) % 19 + 500)
    a, op, _ = _run_reduce(pkg, stream, compact=True, monoid=None)
    b, _, _ = _run_reduce(pkg, stream, compact=False, monoid=None)
    assert a == b and op._compactor is None


def _stateful_run(pkg, stream, compact, slots):
    got = []
    src = (pkg.Source_Builder(lambda: iter(stream))
           .withOutputBatchSize(CAP).withName("src").build())
    op = (_dev(pkg, "Map")(
            lambda t, s: ({"key": t["key"], "v": t["v"] + s}, s + 1.0))
          .withInitialState(np.float32(0.0))
          .withKeyBy(lambda t: t["key"])
          .withNumKeySlots(slots).withName("sm").build())
    g = pkg.PipeGraph("kc_stateful", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, compact))
    g.add_source(src).add(op).add_sink(_sink(pkg, got))
    g.run()
    return got, op


def test_stateful_compacted_matches_interned():
    """:103 — a host-fed interning stateful operator takes the compacted
    route: records equal interning's and the JAX package's, a miss-free
    remap, and no host interning."""
    stream = _stream(512, lambda i: (i * 13) % 37 - 5,
                     v_of=lambda i: float(i))
    a, op_a = _stateful_run(wt, stream, True, 64)
    b, op_b = _stateful_run(wt, stream, False, 64)
    ja, jop = _stateful_run(wf, stream, True, 64)
    assert a == b == ja and len(a) == 512
    assert op_b._compactor is None and len(op_b._interner) == 37
    s = _same_summary(op_a, jop)
    assert s["pinned"] and s["hit_rate"] == 1.0
    assert len(op_a._interner) == 0
    # the same key -> slot assignment in both packages
    assert op_a._compactor.export_mapping() == jop._compactor.export_mapping()


def _ffat_stream():
    for i in range(768):
        k = 1015 - (i * 7) % 16 if i >= 128 else 1010 + (i % 3)
        yield {"key": np.int32(k), "v": np.float32(i),
               "ts": np.int64(i * 100)}


def _ffat_run(pkg, mode, records, tb=False, slots=None, sum_comb=False):
    got = []
    src = (pkg.Source_Builder(lambda: iter(records))
           .withOutputBatchSize(CAP).withName("src"))
    if tb:
        src = src.withTimestampExtractor(lambda t: t["ts"])
    b = _dev(pkg, "Ffat_Windows")(lambda t: t["v"], lambda a, b: a + b) \
        .withName("w")
    b = b.withTBWindows(1600, 800) if tb else b.withCBWindows(8, 4)
    if sum_comb:
        b = b.withSumCombiner()
    if mode == "compact":
        b = b.withKeyBy(lambda t: t["key"]).withCompactedKeys()
    elif mode == "shifted":
        b = b.withKeyBy(lambda t: t["key"] - 1000).withMaxKeys(16)
    else:
        b = b.withKeyBy(lambda t: t["key"]).withMaxKeys(8)
    op = b.build()
    kw = {} if slots is None else {"key_compaction_slots": slots}
    g = pkg.PipeGraph("kc_ffat", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT if tb else pkg.TimePolicy.INGRESS,
                      config=_cfg(pkg, True, **kw))
    g.add_source(src.build()).add(op).add_sink(_sink(pkg, got))
    g.run()
    return got, op


@pytest.mark.parametrize("tb,sum_comb", [(False, False), (False, True),
                                         (True, False)])
def test_ffat_compacted_matches_declared_with_user_keys(tb, sum_comb):
    """:132 — withCompactedKeys against a withMaxKeys baseline whose
    extractor applies the dense mapping by hand: the same windows and
    values, and the fired records (EOS partials included) carry the
    USER's keys although admission order scrambles the slots; the JAX
    package's compacted run equals the port's."""
    recs = list(_ffat_stream())
    a, op_a = _ffat_run(wt, "compact", recs, tb=tb, sum_comb=sum_comb)
    ja, jop = _ffat_run(wf, "compact", recs, tb=tb, sum_comb=sum_comb)
    b, _ = _ffat_run(wt, "shifted", recs, tb=tb, sum_comb=sum_comb)
    norm = sorted(tuple((k, v - 1000.0 if k == "key" else v)
                        for k, v in r) for r in a)
    assert sorted(a) == sorted(ja)
    assert norm == sorted(b) and len(a) > 0
    assert _same_summary(op_a, jop)["hit_rate"] == 1.0
    assert op_a._compactor.export_mapping() == jop._compactor.export_mapping()


# ---------------------------------------------------------------------------
# adversarial key streams
# ---------------------------------------------------------------------------

def test_all_cold_stream_overflows_to_sorted():
    """:173 — distinct keys far beyond the slot budget: nearly every lane
    misses, the full-width sorted lane runs, the records stay sorted's."""
    stream = _stream(2048, lambda i: i * 3 + 7)
    a, op, _ = _run_reduce(wt, stream, compact=True, cap=128,
                           key_compaction_slots=32)
    ja, jop, _ = _run_reduce(wf, stream, compact=True, cap=128,
                             key_compaction_slots=32)
    b, _, _ = _run_reduce(wt, stream, compact=False, cap=128)
    assert a == ja == b and len(a) == 2048
    s = _same_summary(op, jop)
    assert s["big_fallbacks"] > 0 and s["overflow_share"] > 0.9


def test_all_hot_stream_stays_dense():
    """:186 — cardinality under the budget: everything admits at the
    staging boundary; no overflow, no churn."""
    stream = _stream(1024, lambda i: (i % 8) * 1000)
    a, op, _ = _run_reduce(wt, stream, compact=True)
    ja, jop, _ = _run_reduce(wf, stream, compact=True)
    b, _, _ = _run_reduce(wt, stream, compact=False)
    assert a == ja == b
    s = _same_summary(op, jop)
    assert s["hit_rate"] == 1.0 and s["churn"] == 0
    assert s["big_fallbacks"] == 0


def test_zipf_shift_mid_run_reseeds():
    """:198 — the hot set shifts mid-stream on a full table: the records
    equal the sorted route's and the JAX package's throughout; the reseed
    cadence folds the shard sketch's new hot candidates in and evicts
    provably colder slots (``churn``), seating the new hot key 9000; the
    churn, hit rate and reseeds equal the JAX package's."""
    def key_of(i):
        if i < 1024:
            return 100 + i % 16
        return 9000 + i % 4 if i % 8 else 100 + i % 16

    stream = _stream(4096, key_of)
    kw = dict(cap=128, key_compaction_slots=16, key_compaction_reseed=4)
    a, op, _ = _run_reduce(wt, stream, compact=True, **kw)
    ja, jop, _ = _run_reduce(wf, stream, compact=True, **kw)
    b, _, _ = _run_reduce(wt, stream, compact=False, cap=128)
    assert a == ja == b
    s = _same_summary(op, jop, keys=("churn", "hit_rate", "reseeds",
                                     "occupied", "admits", "tuples"))
    assert s["reseeds"] == 32 // 4 and s["churn"] > 0, s
    assert op._compactor.slot_of(9000) is not None


def test_sentinel_key_rides_overflow_lane():
    """:220 — a record keyed exactly INT32_MAX is never admitted and
    never wrong: it rides the overflow lane."""
    stream = _stream(128, lambda i: 2**31 - 1 if i % 16 == 0 else i % 5)
    a, op, _ = _run_reduce(wt, stream, compact=True)
    ja, _, _ = _run_reduce(wf, stream, compact=True)
    b, _, _ = _run_reduce(wt, stream, compact=False)
    assert a == ja == b
    assert op._compactor.slot_of(int(KEY_SENTINEL)) is None
    assert op._compactor.summary()["overflow_tuples"] > 0


def test_sentinel_key_deactivates_stateful_to_intern():
    """:231 — the stateful route has a lossless intern fallback: a
    sentinel user key deactivates the compactor and the run matches
    plain interning (and the JAX package)."""
    stream = _stream(256, lambda i: 2**31 - 1 if i == 40 else i % 9,
                     v_of=lambda i: float(i))
    a, op_a = _stateful_run(wt, stream, True, 32)
    b, _ = _stateful_run(wt, stream, False, 32)
    ja, _ = _stateful_run(wf, stream, True, 32)
    assert a == b == ja and len(a) == 256
    assert op_a._compactor is None or not op_a._compactor.active


def test_ffat_slot_overflow_masks_and_counts():
    """:258 — more distinct keys than the pinned budget: admitted keys
    keep their windows, the rest are masked and counted (full_rejects,
    misses), with no deactivation; the admitted keys' windows equal a
    declared run over the stream filtered to them."""
    stream = [{"key": np.int32(i % 8), "v": np.float32(i),
               "ts": np.int64(i)} for i in range(512)]
    a, op = _ffat_run(wt, "compact", stream, slots=4)
    ja, jop = _ffat_run(wf, "compact", stream, slots=4)
    assert sorted(a) == sorted(ja)
    s = op._compactor.summary()
    assert s["full_rejects"] > 0 and "deactivated" not in s
    assert 0.0 < s["hit_rate"] < 1.0
    assert s["hit_rate"] == jop._compactor.summary()["hit_rate"]
    admitted = {k for k in range(8)
                if op._compactor.slot_of(k) is not None}
    assert len(admitted) == 4
    base, _ = _ffat_run(wt, "dense",
                        [r for r in stream if int(r["key"]) in admitted])
    assert sorted(a) == sorted(base) and len(a) > 0


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_stateful_slot_overflow_raises_interner_error(pkg):
    """:297 — distinct keys beyond num_key_slots on the pinned
    intern-fallback compactor surface as the interner's error."""
    stream = _stream(256, lambda i: i % 12, v_of=lambda i: float(i))
    with pytest.raises(pkg.WindFlowError, match="num_key_slots"):
        _stateful_run(pkg, stream, True, 8)


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_ffat_dead_admission_path_fails_loudly(pkg):
    """:318 — a compacted window has no lossless fallback: once its host
    admission path is dead the next step raises with the withMaxKeys
    hint."""
    op = (_dev(pkg, "Ffat_Windows")(lambda t: t["v"], lambda a, b: a + b)
          .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
          .withCompactedKeys().withName("w").build())

    def gen():
        # after the build attached the compactor, before the first batch
        op._compactor.deactivate()
        for i in range(256):
            yield {"key": np.int32(i % 4), "v": np.float32(i)}

    src = (pkg.Source_Builder(gen).withOutputBatchSize(CAP)
           .withName("src").build())
    g = pkg.PipeGraph("kc_dead", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, True))
    g.add_source(src).add(op).add_sink(_sink(pkg, []))
    with pytest.raises(pkg.WindFlowError, match="admission"):
        g.run()


def test_failing_probe_deactivates_the_compactor():
    """An extractor that fails on the host columns kills the staging
    probe, which deactivates the compactor: a compacted window then
    raises, a stateful operator falls back to interning."""
    from windflow_tpu_torch.monitoring.shard_ledger import HostKeyProbe
    comp = KeyCompactor(8, pinned=True)

    def bad(t):
        raise RuntimeError("not on the host")
    probe = HostKeyProbe(None, bad, compactor=comp)
    probe.columns({"key": np.arange(4)}, 4)
    assert probe.dead and not comp.active
    probe = HostKeyProbe(None, lambda t: t["key"].to(torch.int32),
                         compactor=KeyCompactor(8, pinned=True))
    probe.items([{"key": 3}, {"key": 5}])     # a torch-only extractor
    assert not probe.dead and probe.compactor.slot_of(5) is not None


def test_concurrent_admission_keeps_table_consistent():
    """:384 — sibling emitters admit into one compactor concurrently: the
    sorted key mirror, the slot mirror and the dict stay consistent and
    every slot is accounted for once."""
    import sys
    comp = KeyCompactor(256, name="hammer")
    errs = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for _ in range(200):
                comp.observe(rng.randint(0, 300, 32).astype(np.int64))
                comp.place_np(rng.randint(0, 300, 16).astype(np.int64), 4)
        except Exception as e:      # noqa: BLE001 — the regression
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts) and errs == []
    n = len(comp._key_slot)
    keys = np.sort(np.fromiter(comp._key_slot.keys(), np.int32, count=n))
    assert np.array_equal(keys, comp._tk[:n])
    for k, slot in comp._key_slot.items():
        pos = int(np.searchsorted(comp._tk[:n], np.int32(k)))
        assert comp._tsl[pos] == slot
    assert sorted(list(comp._key_slot.values())
                  + list(comp._free)) == list(range(256))


def test_one_compacted_step_a_batch():
    """:450 — the remap rides the consumer's one step: one step call a
    batch, no other step built, the tables uploaded once (admission
    happened before the first batch)."""
    stream = _stream(512, lambda i: (i * 7) % 23 + 1000)
    _, op, _ = _run_reduce(wt, stream, compact=True, name="zed")
    assert list(op._steps) == [("compact", CAP)]
    assert sum(r.stats.device_programs_launched
               for r in op.replicas) == 512 // CAP
    assert op._compactor.summary()["batches"] == 512 // CAP


def test_kill_switch_attaches_nothing():
    """:519 — key_compaction off: no compactor, no emitter hook, no
    Key_compaction stats."""
    stream = _stream(256, lambda i: (i * 7) % 23 + 1000)
    _, op, g = _run_reduce(wt, stream, compact=False)
    assert op._compactor is None and op._cstats is None
    for o in g._operators:
        assert o._compactor is None
        for rep in o.replicas:
            em = rep.emitter
            if em is not None:
                assert getattr(em, "_compactor", None) is None
                # the shard plane's key probe may sit on the staging
                # edge; with compaction off it admits into no compactor
                probe = getattr(em, "_shard_probe", None)
                assert probe is None or probe.compactor is None
    assert "Key_compaction" not in op.dump_stats()
    assert "compaction" not in g.stats()["Shard"]["per_op"][op.name]


@pytest.mark.parametrize("pkg", [wt, wf], ids=["port", "jax"])
def test_ffat_compacted_keys_require_plane(pkg):
    """:540 — withCompactedKeys with key_compaction off fails at the first
    batch with the declare-withMaxKeys hint."""
    src = (pkg.Source_Builder(
        lambda: iter([{"key": np.int32(5), "v": np.float32(1.0)}] * 64))
        .withOutputBatchSize(32).withName("src").build())
    op = (_dev(pkg, "Ffat_Windows")(lambda t: t["v"], lambda a, b: a + b)
          .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
          .withCompactedKeys().withName("w").build())
    g = pkg.PipeGraph("kc_kill", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, False))
    g.add_source(src).add(op).add_sink(_sink(pkg, []))
    with pytest.raises(pkg.WindFlowError, match="withMaxKeys"):
        g.run()


def test_compacted_windows_refuse_no_key():
    with pytest.raises(wt.WindFlowError, match="withKeyBy"):
        (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
         .withCBWindows(8, 4).withCompactedKeys().build())


# ---------------------------------------------------------------------------
# placement override on the keyed edges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_edge", [False, True])
def test_placement_override_at_parallelism(device_edge):
    """An unbounded compacted reduce at parallelism 2: slotted keys go to
    ``slot % 2`` on the keyed staging emitter (host edge) and on the
    device keyby (device edge); the records equal the JAX package's (the
    replicas' batches depend on the placement, so the per-batch records
    differ from the hash-placed sorted route's, whose per-key maxima
    over the stream they equal)."""
    stream = _stream(768, lambda i: (i * 5) % 29 + 300)
    a, op, g = _run_reduce(wt, stream, compact=True, par=2,
                           device_edge=device_edge)
    ja, _, _ = _run_reduce(wf, stream, compact=True, par=2,
                           device_edge=device_edge)
    b, _, _ = _run_reduce(wt, stream, compact=False, par=2,
                          device_edge=device_edge)
    assert sorted(a) == sorted(ja) and len(a) > 0

    def maxima(recs):
        out = {}
        for r in recs:
            d = dict(r)
            out[d["key"]] = max(out.get(d["key"], -np.inf), d["v"])
        return out
    assert maxima(a) == maxima(b)
    comp = op._compactor
    assert comp.placement_override
    ems = [rep.emitter for o in g._operators for rep in o.replicas
           if rep.emitter is not None and rep.emitter.dests
           and rep.emitter.dests[0][0].op is op]
    assert ems and all(em._compactor is comp for em in ems)
    if device_edge:
        # the table fills from the miss rings only: nothing upstream of
        # a device edge sees the keys on the host
        assert comp.summary()["overflow_tuples"] > 0
    else:
        assert comp.summary()["hit_rate"] == 1.0
        # both replicas get slotted keys: slot % 2 balances them
        assert all(r.stats.inputs_received > 0 for r in op.replicas)


def test_place_np_matches_the_jax_compactor():
    keys = np.array([5, -7, 2**31 - 1, 0, 9, 3, 11, 70000], np.int64)
    comp, jcomp = KeyCompactor(4), jcp.KeyCompactor(4)
    for c in (comp, jcomp):
        c.observe(np.array([9, 3, 70000, 5, 1], np.int64))
    for n in (2, 3, 4):
        assert np.array_equal(comp.place_np(keys, n), jcomp.place_np(keys, n))
        assert [comp.place_one(int(k), n) for k in keys] \
            == [jcomp.place_one(int(k), n) for k in keys]
    assert np.array_equal(comp._tk, jcomp._tk)
    assert np.array_equal(comp._tsl, jcomp._tsl)


# ---------------------------------------------------------------------------
# KeyCompactor unit contracts
# ---------------------------------------------------------------------------

def test_reseed_one_estimation_pass():
    """:658 — a reseed that evicts pays ONE estimation pass over the
    residents (coldest first), not one a candidate."""
    class Sketch:
        def __init__(self):
            self.calls = 0
            self.hot = [(100 + i, 1000 - i) for i in range(4)]

        def hot_candidates(self, limit):
            return self.hot[:limit]

        def _estimate(self, k):
            self.calls += 1
            return int(k)

    comp = KeyCompactor(4, reseed_every=1, name="reseed_cost")
    comp.observe(np.arange(1, 5, dtype=np.int64))   # fill: keys 1..4
    sk = Sketch()
    comp.bind_sketch(sk)
    comp.reseed()
    assert comp.churn == 4
    assert set(comp._key_slot) == {100, 101, 102, 103}
    assert sk.calls == 4


def test_reseed_admits_miss_ring_candidates_into_free_slots():
    """The miss rings a consumer's step fills are read at the cadence and
    their keys admitted while slots are free; a pinned table never
    evicts."""
    comp = KeyCompactor(4, reseed_every=2, pinned=True)
    st = tcp.cstats_init()
    keys = torch.tensor([7, 8, 9, 7] * 4, dtype=torch.int32)
    valid = torch.ones(16, dtype=torch.bool)
    hit = torch.zeros(16, dtype=torch.bool)
    st = tcp.cstats_update(st, keys, hit, valid)
    comp.register_device_stats(lambda: st)
    comp.observe(np.array([1, 2], np.int64))
    comp.on_batch()
    assert comp.reseeds == 0
    comp.on_batch()
    assert comp.reseeds == 1 and comp.summary()["occupied"] == 4
    assert comp.churn == 0


def test_packed_min_liveness_at_ts_floor():
    """:690 — packed "min": a lane ts at the int64 floor must not read
    its row back as dead."""
    cap, T = 8, 4
    body = tcp.make_compacted_reduce(
        cap, T, "min", lambda a, b: {"v": torch.minimum(a["v"], b["v"])},
        None, True)
    i64min = np.iinfo(np.int64).min
    keys = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3], dtype=torch.int32)
    payload = {"v": torch.arange(8, dtype=torch.float32)}
    valid = torch.ones(cap, dtype=torch.bool)
    for floor_ts in (i64min, i64min + 1):
        ts = torch.full((cap,), floor_ts, dtype=torch.int64)
        out_p, _, out_valid, _ = body(keys, payload, ts, valid,
                                      tcp.cstats_init())
        assert int(out_valid.sum()) == 4
        assert out_p["v"][:4].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_observe_one_lock_free_on_full_table():
    """:714 — a full evictable table never takes the lock on the
    per-tuple path: cold keys are counted, not admitted."""
    comp = KeyCompactor(2, name="full_fast")
    comp.observe(np.asarray([1, 2], np.int64))
    assert not comp._free
    with comp._lock:           # would deadlock if the path locked
        comp.observe_one(99)
        comp.observe_one(int(KEY_SENTINEL))
    assert comp.slot_of(99) is None
    s = comp.summary()
    assert s["full_rejects"] == 1 and s["sentinel_rejects"] == 1


def test_sentinel_key_counted_not_silent():
    """:730 — a real key equal to the sentinel is never admitted and the
    encounter is counted."""
    comp = KeyCompactor(4, name="sentinel")
    comp.observe(np.asarray([int(KEY_SENTINEL), 7], np.int64))
    assert comp.slot_of(7) is not None
    assert comp.slot_of(int(KEY_SENTINEL)) is None
    assert comp.summary()["sentinel_rejects"] == 1


def test_slots_to_user_keys_matches_jax():
    rng = np.random.default_rng(4)
    comp, jcomp = KeyCompactor(16), jcp.KeyCompactor(16)
    ks = rng.integers(-1000, 1000, 10).astype(np.int64)
    comp.observe(ks)
    jcomp.observe(ks)
    lane = rng.integers(0, 17, 40).astype(np.int32)
    tk, tsl = comp.tables()
    got = tcp.slots_to_user_keys(torch.from_numpy(lane), tk, tsl)
    want = jcp.slots_to_user_keys(jnp.asarray(lane), *jcomp.tables())
    assert np.array_equal(got.numpy(), np.asarray(want))
