"""The host window engine of the port (``windflow_tpu_torch/windows/
{engine,ops,flatfat,ffat_op}.py``) against the JAX package's, through
``PipeGraph.run()`` in both packages on the same seeded streams (the port
on ``Config(device="cpu")``).

* the matrix of tests/test_windows.py: keyed count and time windows in
  DEFAULT and DETERMINISTIC mode, parallel, paned, map-reduce and host
  FFAT windows, the non-invertible combiner, FlatFAT's structure and the
  time-window boundary ties, each also against the JAX test's oracle;
* the sweep of tests/test_metamorphic_windows.py (every host family ×
  count/time × both modes, random parallelism and batch size) without
  its device leg;
* both tests of tests/test_punctuation.py, the first of which needs the
  watermark hook (a time window fires while the source idles);
* host windows behind a device stage (a CPU ``MapGPU``), the
  composites' expansion, ``chain`` falling back to ``add``, preflight's
  WF603, a checkpointed graph holding a host window, and its restore
  (every other operator's state back, as in the JAX package).

Tolerances: none.  DETERMINISTIC results compare as the sink's sequence,
DEFAULT results as the sorted records (per key, order is the engine's and
equal too); every value is exact.
"""

import operator
import random
import time
import zlib

import pytest
import torch

import windflow_tpu as wf
import windflow_tpu_torch as wt

torch.set_num_threads(1)

N_KEYS = 4
LENGTH = 400
WIN, SLIDE = 16, 4              # count windows
TWIN, TSLIDE = 16_000, 4_000    # time windows (µs)


def stream():
    return [{"key": i % N_KEYS, "value": i, "ts": i * 1000}
            for i in range(LENGTH)]


def oracle_cb(win, slide):
    per_key = {}
    for t in stream():
        per_key.setdefault(t["key"], []).append(t["value"])
    count, total = 0, 0
    for vals in per_key.values():
        w = 0
        while w * slide < len(vals):
            count += 1
            total += sum(vals[w * slide: w * slide + win])
            w += 1
    return count, total


def oracle_tb(win_us, slide_us):
    per_key = {}
    for t in stream():
        per_key.setdefault(t["key"], []).append((t["ts"], t["value"]))
    count, total = 0, 0
    for pts in per_key.values():
        wids = set()
        for ts, _ in pts:
            first = max(0, -(-(ts - win_us + 1) // slide_us))
            wids.update(range(first, ts // slide_us + 1))
        for w in sorted(wids):
            items = [v for ts, v in pts
                     if w * slide_us <= ts < w * slide_us + win_us]
            if items:
                count += 1
                total += sum(items)
    return count, total


def config(pkg, **kw):
    # punctuation off the wall clock, so both packages see the same
    # watermark sequence
    kw.setdefault("punctuation_interval_usec", 10 ** 12)
    if pkg is wt:
        return wt.Config(device="cpu", **kw)
    return wf.Config(**kw)


def run_graph(pkg, make_op, batch, mode="DEFAULT", sink_parallelism=1,
              items=None):
    """Source (EVENT time) → ``make_op(pkg)`` → Sink; returns the sink's
    ``(key, wid, value)`` records in arrival order."""
    got = []
    data = items if items is not None else stream()
    src = (pkg.Source_Builder(lambda: iter(data))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(batch).build())
    snk = (pkg.Sink_Builder(
        lambda r: got.append((r.key, r.wid, r.value))
        if r is not None else None)
        .withParallelism(sink_parallelism).build())
    g = pkg.PipeGraph("win", getattr(pkg.ExecutionMode, mode),
                      pkg.TimePolicy.EVENT, config=config(pkg))
    g.add_source(src).add(make_op(pkg)).add_sink(snk)
    g.run()
    return got


def both(make_op, batch, mode, **kw):
    """The port's records, held equal to the JAX package's: as sequences
    in DETERMINISTIC mode, sorted in DEFAULT."""
    want = run_graph(wf, make_op, batch, mode, **kw)
    got = run_graph(wt, make_op, batch, mode, **kw)
    if mode == "DETERMINISTIC":
        assert got == want
    else:
        assert sorted(got) == sorted(want)
    return got


def summary(recs):
    return len(recs), sum(int(v) for _, _, v in recs)


NONINC = lambda items: sum(t["value"] for t in items)    # noqa: E731
INC = lambda t, acc: (acc or 0) + t["value"]             # noqa: E731


# ---------------------------------------------------------------------------
# tests/test_windows.py's matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
@pytest.mark.parametrize("fn", [NONINC, INC], ids=["nonincremental",
                                                   "incremental"])
def test_keyed_windows_cb(mode, fn):
    rnd = random.Random(5)
    for _ in range(3):
        par, batch = rnd.randint(1, 3), rnd.randint(1, 16)
        got = both(lambda p: (p.Keyed_Windows_Builder(fn)
                              .withCBWindows(WIN, SLIDE)
                              .withKeyBy(lambda t: t["key"])
                              .withParallelism(par).build()), batch, mode)
        assert summary(got) == oracle_cb(WIN, SLIDE)


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_keyed_windows_tb(mode):
    rnd = random.Random(6)
    for _ in range(3):
        par, batch = rnd.randint(1, 3), rnd.randint(1, 16)
        got = both(lambda p: (p.Keyed_Windows_Builder(NONINC)
                              .withTBWindows(TWIN, TSLIDE)
                              .withKeyBy(lambda t: t["key"])
                              .withParallelism(par).build()), batch, mode)
        assert summary(got) == oracle_tb(TWIN, TSLIDE)


@pytest.mark.parametrize("wtype", ["cb", "tb"])
def test_parallel_windows(wtype):
    rnd = random.Random(7)
    for _ in range(3):
        par, batch = rnd.randint(1, 3), rnd.randint(1, 16)

        def make(p):
            b = p.Parallel_Windows_Builder(NONINC)
            b = (b.withCBWindows(WIN, SLIDE) if wtype == "cb"
                 else b.withTBWindows(TWIN, TSLIDE))
            return b.withKeyBy(lambda t: t["key"]).withParallelism(par) \
                .build()
        got = both(make, batch, "DEFAULT")
        assert summary(got) == (oracle_cb(WIN, SLIDE) if wtype == "cb"
                                else oracle_tb(TWIN, TSLIDE))


@pytest.mark.parametrize("family", ["paned", "mapreduce"])
@pytest.mark.parametrize("wtype", ["cb", "tb"])
def test_composite_windows(family, wtype):
    rnd = random.Random(8 if family == "paned" else 9)
    second = lambda parts: sum(parts)    # noqa: E731
    for _ in range(2):
        p1, p2, batch = rnd.randint(1, 3), rnd.randint(1, 3), \
            rnd.randint(1, 16)

        def make(p):
            b = (p.Paned_Windows_Builder(NONINC, second)
                 if family == "paned"
                 else p.MapReduce_Windows_Builder(NONINC, second))
            b = (b.withCBWindows(WIN, SLIDE) if wtype == "cb"
                 else b.withTBWindows(TWIN, TSLIDE))
            return b.withKeyBy(lambda t: t["key"]).withParallelisms(p1, p2) \
                .build()
        got = both(make, batch, "DEFAULT")
        assert summary(got) == (oracle_cb(WIN, SLIDE) if wtype == "cb"
                                else oracle_tb(TWIN, TSLIDE))


@pytest.mark.parametrize("wtype", ["cb", "tb"])
def test_ffat_windows(wtype):
    rnd = random.Random(10)
    for _ in range(3):
        par, batch = rnd.randint(1, 3), rnd.randint(1, 16)

        def make(p):
            b = p.Ffat_Windows_Builder(lambda t: t["value"],
                                       lambda a, b: a + b)
            b = (b.withCBWindows(WIN, SLIDE) if wtype == "cb"
                 else b.withTBWindows(TWIN, TSLIDE))
            return b.withKeyBy(lambda t: t["key"]).withParallelism(par) \
                .build()
        got = both(make, batch, "DEFAULT")
        assert summary(got) == (oracle_cb(WIN, SLIDE) if wtype == "cb"
                                else oracle_tb(TWIN, TSLIDE))


def test_ffat_windows_non_invertible():
    """A max combiner (no inverse): FlatFAT's range queries, equal to the
    JAX package's records and to the per-key oracle."""
    got = both(lambda p: (p.Ffat_Windows_Builder(lambda t: t["value"], max)
                          .withCBWindows(WIN, SLIDE)
                          .withKeyBy(lambda t: t["key"]).build()),
               8, "DETERMINISTIC")
    per_key = {}
    for t in stream():
        per_key.setdefault(t["key"], []).append(t["value"])
    exp = {}
    for k, vals in per_key.items():
        w = 0
        while w * SLIDE < len(vals):
            exp[(k, w)] = max(vals[w * SLIDE: w * SLIDE + WIN])
            w += 1
    assert {(k, w): v for k, w, v in got} == exp


def test_flatfat_structure():
    """FlatFAT against naive range folds, operation for operation with
    the JAX package's tree."""
    rnd = random.Random(11)
    fats = [wt.FlatFAT(operator.add, 16), wf.FlatFAT(operator.add, 16)]
    vals = []
    for pos in range(50):
        v = rnd.randint(0, 100)
        vals.append(v)
        lo = max(0, pos - 15)
        for fat in fats:
            fat.update(pos, v)
            assert fat.query(lo, pos + 1) == sum(vals[lo:pos + 1])
            for old in range(lo):
                fat.evict(old)
        assert fats[0]._tree == fats[1]._tree
        assert fats[0]._slot_pos == fats[1]._slot_pos
    assert fats[0].live_items() == fats[1].live_items()
    with pytest.raises(ValueError):
        fats[0].query(0, 17)


def test_tb_boundary_ties_ordered_mode():
    """In ordered modes tuples sharing the frontier timestamp all land in
    their window: a window ending at ts+1 fires only once a strictly
    later timestamp arrives."""
    items = [{"k": 0, "v": "a", "ts": 5}, {"k": 0, "v": "b", "ts": 9},
             {"k": 0, "v": "c", "ts": 9}, {"k": 0, "v": "d", "ts": 12}]
    for make in [
        lambda p: (p.Keyed_Windows_Builder(lambda its: len(its))
                   .withTBWindows(10, 10).withKeyBy(lambda t: t["k"])
                   .build()),
        lambda p: (p.Ffat_Windows_Builder(lambda t: 1, lambda a, b: a + b)
                   .withTBWindows(10, 10).withKeyBy(lambda t: t["k"])
                   .build()),
    ]:
        got = both(make, 1, "DETERMINISTIC", items=items)
        assert sorted((w, v) for _, w, v in got) == [(0, 3), (1, 1)]


def test_lateness_and_ignored_tuples():
    """An out-of-order stream under DEFAULT mode: tuples behind the fired
    frontier count as ignored, the lateness gate delays firing; the
    records and the ignored counts equal the JAX package's."""
    rnd = random.Random(12)
    items = [{"key": i % 3, "value": i,
              "ts": max(0, i * 1000 - rnd.randint(0, 6000))}
             for i in range(300)]
    for lateness in (0, 3000):
        for make in [
            lambda p: (p.Keyed_Windows_Builder(NONINC)
                       .withTBWindows(8000, 4000).withLateness(lateness)
                       .withKeyBy(lambda t: t["key"]).build()),
            lambda p: (p.Ffat_Windows_Builder(lambda t: t["value"],
                                              lambda a, b: a + b)
                       .withTBWindows(8000, 4000).withLateness(lateness)
                       .withKeyBy(lambda t: t["key"]).build()),
        ]:
            ops = {}

            def keep(p):
                ops[p] = make(p)
                return ops[p]
            both(keep, 5, "DEFAULT", items=items)
            ign = {p: sum(r.stats.inputs_ignored for r in op.replicas)
                   for p, op in ops.items()}
            assert ign[wt] == ign[wf]


# ---------------------------------------------------------------------------
# tests/test_metamorphic_windows.py's sweep, host families
# ---------------------------------------------------------------------------

def _sweep_builder(pkg, family, wtype, rnd):
    lift = lambda t: t["value"]      # noqa: E731
    comb = lambda a, b: a + b        # noqa: E731
    par = rnd.randint(1, 4)
    if family == "keyed":
        b = pkg.Keyed_Windows_Builder(NONINC).withParallelism(par)
    elif family == "parallel":
        b = pkg.Parallel_Windows_Builder(NONINC).withParallelism(par)
    elif family == "paned":
        b = pkg.Paned_Windows_Builder(
            NONINC, lambda panes: sum(panes)).withParallelisms(
                par, rnd.randint(1, 4))
    elif family == "mapreduce":
        b = pkg.MapReduce_Windows_Builder(
            NONINC, lambda partials: sum(partials)).withParallelisms(
                par, rnd.randint(1, 4))
    else:
        b = pkg.Ffat_Windows_Builder(lift, comb).withParallelism(par)
    b = (b.withCBWindows(WIN, SLIDE) if wtype == "cb"
         else b.withTBWindows(TWIN, TSLIDE))
    return b.withKeyBy(lambda t: t["key"])


@pytest.mark.parametrize("wtype", ["cb", "tb"])
@pytest.mark.parametrize("family", ["keyed", "parallel", "paned",
                                    "mapreduce", "ffat_host"])
def test_window_sweep(family, wtype):
    seed = zlib.crc32(f"{family}/{wtype}".encode())
    oracle = oracle_cb(WIN, SLIDE) if wtype == "cb" \
        else oracle_tb(TWIN, TSLIDE)
    for mode in ("DEFAULT", "DETERMINISTIC"):
        for i in range(2):
            # the same random configuration in both packages
            rj = random.Random(seed + i)
            rt = random.Random(seed + i)
            batch = rj.randint(1, 257)
            rt.randint(1, 257)
            sink_par = rj.randint(1, 3)
            rt.randint(1, 3)
            ops = {wf: _sweep_builder(wf, family, wtype, rj).build(),
                   wt: _sweep_builder(wt, family, wtype, rt).build()}
            recs = {p: run_graph(p, lambda p: ops[p], batch, mode,
                                 sink_parallelism=sink_par)
                    for p in (wf, wt)}
            assert sorted(recs[wt]) == sorted(recs[wf]), (family, mode)
            if sink_par == 1 and mode == "DETERMINISTIC":
                assert recs[wt] == recs[wf]
            assert summary(recs[wt]) == oracle


# ---------------------------------------------------------------------------
# tests/test_punctuation.py
# ---------------------------------------------------------------------------

def _idle_fire(pkg):
    cfg = config(pkg, punctuation_interval_usec=5_000)
    results = []
    state = {"fired_during_idle": False}

    def gen():
        for _ in range(10):
            yield {"key": 0, "value": 1}
        t_end = time.time() + 0.15
        while time.time() < t_end:
            time.sleep(0.005)
            yield None
        # the window of the first 10 tuples must have fired by now,
        # before the EOS flush could be responsible
        state["fired_during_idle"] = len(results) > 0
        for _ in range(5):
            yield {"key": 0, "value": 1}

    win = (pkg.Keyed_Windows_Builder(
        lambda items: sum(t["value"] for t in items))
        .withTBWindows(20_000, 20_000).withKeyBy(lambda t: t["key"])
        .build())
    src = pkg.Source_Builder(gen).build()
    snk = pkg.Sink_Builder(
        lambda r: results.append(r) if r is not None else None).build()
    g = pkg.PipeGraph("idle_fire", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS, config=cfg)
    g.add_source(src).add(win).add_sink(snk)
    g.run()
    return state["fired_during_idle"], sum(r.value for r in results)


def test_tb_window_fires_while_source_idle():
    """The watermark hook: a punctuation on an idle stream fires the time
    window (in the JAX package as in the port)."""
    assert _idle_fire(wf) == (True, 15)
    assert _idle_fire(wt) == (True, 15)


def test_punctuation_amount_triggers_flush():
    for pkg in (wf, wt):
        cfg = config(pkg, punctuation_amount=8,
                     punctuation_interval_usec=10 ** 9)
        seen = []

        def gen():
            yield from range(32)
            for _ in range(3):
                yield None

        src = pkg.Source_Builder(gen).withOutputBatchSize(10_000).build()
        snk = pkg.Sink_Builder(
            lambda x: seen.append(x) if x is not None else None).build()
        g = pkg.PipeGraph("amount", config=cfg)
        g.add_source(src).add(pkg.Map_Builder(lambda x: x).build()) \
            .add_sink(snk)
        g.start()
        for _ in range(6):
            g.step()
        assert len(seen) >= 8, pkg.__name__
        while not g.is_done():
            g.step()
        g._finalize()
        assert sorted(seen) == list(range(32))


def test_watermark_hook_runs_on_advance_only():
    """``on_watermark`` runs once a real advance, after a punctuation and
    after a batch, as in the JAX package."""
    calls = {wf: [], wt: []}
    for pkg in (wf, wt):
        rep = pkg.Map_Builder(lambda x: x).build().build_replicas(
            pkg.ExecutionMode.DEFAULT, pkg.TimePolicy.EVENT)[0]
        rep.on_watermark = calls[pkg].append
        for wm in (5, 5, 7, 3, 9):
            rep._dispatch(pkg.Punctuation(wm))
    assert calls[wt] == calls[wf] == [5, 7, 9]


# ---------------------------------------------------------------------------
# host windows on the port's graph
# ---------------------------------------------------------------------------

def _behind_map(pkg, make_win, mode="DEFAULT", placement=None):
    """Source → MapGPU/MapTPU (a device stage, on the CPU) → host window
    → Sink: the window's records come back through the egress.  With a
    ``placement`` dict, it maps each window stage's name to the keys each
    of its replicas held, by replica index."""
    got = []
    MB = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
    src = (pkg.Source_Builder(lambda: iter(stream()))
           .withTimestampExtractor(lambda t: t["ts"])
           .withOutputBatchSize(64).build())
    m = MB(lambda t: {"key": t["key"], "value": t["value"] * 2}).build()
    snk = pkg.Sink_Builder(
        lambda r: got.append((r.key, r.wid, r.value))
        if r is not None else None).build()
    g = pkg.PipeGraph("behind", getattr(pkg.ExecutionMode, mode),
                      pkg.TimePolicy.EVENT, config=config(pkg))
    g.add_source(src).add(m).add(make_win(pkg)).add_sink(snk)
    g.run()
    if placement is not None:
        for op in g._operators:
            keys = [sorted(r.engine.keys if r.engine is not None else ())
                    if hasattr(r, "engine") else sorted(r._keys)
                    for r in op.replicas
                    if hasattr(r, "engine") or hasattr(r, "_keys")]
            if keys:
                placement[op.name] = keys
    return got


@pytest.mark.parametrize("family", ["keyed_cb", "keyed_tb", "parallel",
                                    "paned", "mapreduce", "ffat"])
def test_host_window_behind_a_device_stage(family):
    def make(p):
        nonin = lambda items: sum(t["value"] for t in items)  # noqa: E731
        kx = lambda t: t["key"]    # noqa: E731
        if family == "keyed_cb":
            return p.Keyed_Windows_Builder(
                lambda t, acc: (acc or 0) + t["value"]) \
                .withCBWindows(WIN, SLIDE).withKeyBy(kx) \
                .withParallelism(3).build()
        if family == "keyed_tb":
            return p.Keyed_Windows_Builder(nonin).withTBWindows(
                TWIN, TSLIDE).withKeyBy(kx).withParallelism(2).build()
        if family == "parallel":
            return p.Parallel_Windows_Builder(nonin).withCBWindows(
                WIN, SLIDE).withKeyBy(kx).withParallelism(2).build()
        if family == "paned":
            return p.Paned_Windows_Builder(nonin, sum).withCBWindows(
                WIN, SLIDE).withKeyBy(kx).withParallelisms(2, 2).build()
        if family == "mapreduce":
            return p.MapReduce_Windows_Builder(nonin, sum).withTBWindows(
                TWIN, TSLIDE).withKeyBy(kx).withParallelisms(2, 2).build()
        return p.Ffat_Windows_Builder(lambda t: t["value"],
                                      lambda a, b: a + b) \
            .withCBWindows(WIN, SLIDE).withKeyBy(kx).withParallelism(2) \
            .build()
    placed = {wt: {}, wf: {}}
    got = _behind_map(wt, make, placement=placed[wt])
    assert sorted(got) == sorted(_behind_map(wf, make,
                                             placement=placed[wf]))
    # each key reached the replica JAX's stable_hash places it on
    assert placed[wt] and placed[wt] == placed[wf]
    # keys came back as Python ints: one record a (key, wid)
    assert {type(k) for k, _, _ in got} == {int}
    assert len(set((k, w) for k, w, _ in got)) == len(got)
    n, total = summary(got)
    exp = oracle_cb(WIN, SLIDE) if family in ("keyed_cb", "parallel",
                                               "paned", "ffat") \
        else oracle_tb(TWIN, TSLIDE)
    assert (n, total) == (exp[0], 2 * exp[1])


def test_composites_expand_and_chain_falls_back():
    """A composite's stages join the pipe (its closing function handed
    down); ``chain`` of a composite or a host Reduce is an ``add``."""
    closed = []
    pw = (wt.Paned_Windows_Builder(NONINC, sum).withCBWindows(WIN, SLIDE)
          .withKeyBy(lambda t: t["key"]).withName("pw")
          .withClosingFunction(lambda: closed.append(1)).build())
    mr = (wt.MapReduce_Windows_Builder(
        lambda items: sum(r.value for r in items), sum)
        .withCBWindows(2, 2).withKeyBy(lambda r: r.key).withName("mr")
        .build())
    red = wt.Reduce_Builder(lambda r, s: None, dict).build()
    g = wt.PipeGraph("comp", config=config(wt))
    pipe = g.add_source(wt.Source_Builder(lambda: iter(stream()))
                        .withTimestampExtractor(lambda t: t["ts"])
                        .build())
    pipe.add(pw).chain(mr).chain(red)
    pipe.add_sink(wt.Sink_Builder(lambda r: None).build())
    names = [op.name for op in pipe.operators]
    assert names == ["source", "pw_plq", "pw_wlq", "mr_map", "mr_reduce",
                     "reduce", "sink"]
    assert [type(op).__name__ for op in pipe.operators[1:5]] == [
        "ParallelWindows", "_WLQWindows", "ParallelWindows", "_WindowMerge"]
    assert g.check() == []
    g.run()
    assert closed == [1, 1]     # one a replica of each paned stage


def test_builders_reject_what_the_jax_package_rejects():
    for pkg in (wf, wt):
        with pytest.raises(pkg.WindFlowError):
            pkg.Keyed_Windows_Builder(NONINC).build()
        with pytest.raises(pkg.WindFlowError):
            pkg.Keyed_Windows_Builder(NONINC).withCBWindows(0, 1).build()
        with pytest.raises(pkg.WindFlowError):
            pkg.Keyed_Windows_Builder(NONINC).withRebalancing()
        with pytest.raises(pkg.WindFlowError):
            pkg.Keyed_Windows_Builder(NONINC).withCBWindows(4, 2) \
                .withParallelism(2).build()
        with pytest.raises(pkg.WindFlowError):
            pkg.Ffat_Windows_Builder(lambda t: t, max).withCBWindows(4, 2) \
                .withParallelism(2).build()


@pytest.mark.parametrize("fn,incremental", [
    (lambda items: 0, False),
    (lambda t, acc: 0, True),
    (lambda t, acc=None: 0, False),      # a defaulted argument: arity 1
    (lambda t, acc, ctx=None: 0, True),
    (lambda *a: 0, False),
    (max, False),
])
def test_detect_incremental_reads_arity_as_jax(fn, incremental):
    from windflow_tpu.graph.builders import _detect_incremental as jdet
    from windflow_tpu_torch.graph.builders import _detect_incremental as tdet
    assert tdet(fn) == jdet(fn) == incremental
    op = wt.Keyed_Windows_Builder(fn).withCBWindows(4, 2).build()
    assert op.incremental == incremental


def test_preflight_names_host_windows_under_durability(tmp_path):
    """WF603 names each checkpoint-opaque host window (a composite by its
    stages), as the JAX package does; without durability, nothing."""
    diags = {}
    for pkg in (wf, wt):
        g = pkg.PipeGraph("dur", config=config(
            pkg, durability=str(tmp_path / pkg.__name__)))
        pipe = g.add_source(pkg.Source_Builder(lambda: iter(stream()))
                            .build())
        pipe.add(pkg.Keyed_Windows_Builder(NONINC).withCBWindows(4, 2)
                 .withKeyBy(lambda t: t["key"]).withName("kw").build())
        pipe.add(pkg.MapReduce_Windows_Builder(
            lambda items: len(items), sum).withCBWindows(2, 2)
            .withKeyBy(lambda r: r.key).withName("mr").build())
        pipe.add_sink(pkg.Sink_Builder(lambda r: None).build())
        diags[pkg] = sorted((d.code, d.node) for d in g.check())
    assert diags[wt] == diags[wf]
    assert ("WF603", "kw") in diags[wt] and ("WF603", "mr_map") in diags[wt]
    g = wt.PipeGraph("nodur", config=config(wt))
    g.add_source(wt.Source_Builder(lambda: iter(stream())).build()).add(
        wt.Keyed_Windows_Builder(NONINC).withCBWindows(4, 2)
        .withKeyBy(lambda t: t["key"]).build()).add_sink(
        wt.Sink_Builder(lambda r: None).build())
    assert g.check() == []


def test_checkpointed_graph_with_a_host_window(tmp_path):
    """A durable graph holding a host window runs (preflight warns WF603
    and WF601), commits epochs, and its records equal the run without
    durability; the window writes no state into the checkpoint."""
    def build(durability):
        got = []
        kw = {"durability": durability, "durability_epoch_sweeps": 2,
              "preflight": "warn"} if durability else {}
        g = wt.PipeGraph("ck", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT, config=config(wt, **kw))
        g.add_source(wt.Source_Builder(lambda: iter(stream()))
                     .withTimestampExtractor(lambda t: t["ts"])
                     .withOutputBatchSize(16).build()) \
            .add(wt.Keyed_Windows_Builder(INC).withTBWindows(TWIN, TSLIDE)
                 .withKeyBy(lambda t: t["key"]).withName("kw").build()) \
            .add_sink(wt.Sink_Builder(
                lambda r: got.append((r.key, r.wid, r.value))
                if r is not None else None).build())
        return g, got
    g0, plain = build(None)
    g0.run()
    g1, durable = build(str(tmp_path / "ck"))
    with pytest.warns(wt.PreflightWarning, match="WF603"):
        g1.run()
    assert durable == plain
    assert g1.stats()["Durability"]["epochs_committed"] > 0
    kw = [op for op in g1._operators if op.name == "kw"][0]
    assert kw.snapshot_state() is None


def test_restore_of_a_graph_holding_a_host_window(tmp_path):
    """A checkpoint of a graph holding a host window restores every other
    operator: the host Reduce's keyed states come back as checkpointed
    (the same as the JAX package's restore of the same graph), the
    window starts empty (WF603's reset), and the restored graph runs to
    its end."""
    def build(pkg, ck):
        g = pkg.PipeGraph("rs", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT, config=config(
                              pkg, durability=ck,
                              durability_epoch_sweeps=2,
                              preflight="off"))
        g.add_source(pkg.Source_Builder(lambda: iter(stream()))
                     .withTimestampExtractor(lambda t: t["ts"])
                     .withOutputBatchSize(16).build()) \
            .add(pkg.Reduce_Builder(
                lambda t, s: {"key": t["key"], "n": s["n"] + 1,
                              "value": t["value"]}, {"key": -1, "n": 0})
                 .withKeyBy(lambda t: t["key"]).withName("red").build()) \
            .add(pkg.Keyed_Windows_Builder(INC).withCBWindows(WIN, SLIDE)
                 .withKeyBy(lambda t: t["key"]).withName("kw").build()) \
            .add_sink(pkg.Sink_Builder(lambda r: None).build())
        return g
    restored = {}
    for pkg in (wf, wt):
        ck = str(tmp_path / pkg.__name__)
        g = build(pkg, ck)
        g.run()
        assert g.stats()["Durability"]["epochs_committed"] > 0
        g2 = build(pkg, ck)
        g2.restore(ck)
        red = [op for op in g2._operators if op.name == "red"][0]
        kw = [op for op in g2._operators if op.name == "kw"][0]
        restored[pkg] = {k: dict(v) for r in red.replicas
                         for k, v in r._states.items()}
        assert restored[pkg]
        assert all(r.engine is None or not r.engine.keys
                   for r in kw.replicas)
        g2.wait_end()
    assert restored[wt] == restored[wf]


def test_fusion_never_takes_a_host_window():
    """Whole-chain fusion folds the device Map/Filter run and stops at a
    host window (a composite's stages included): the segments hold device
    operators only, equal to the JAX package's, and the records equal the
    unfused run's."""
    def build(pkg, fuse, got):
        MB = wt.MapGPU_Builder if pkg is wt else wf.MapTPU_Builder
        FB = wt.FilterGPU_Builder if pkg is wt else wf.FilterTPU_Builder
        g = pkg.PipeGraph("fz", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT,
                          config=config(pkg, whole_chain_fusion=fuse))
        pipe = g.add_source(pkg.Source_Builder(lambda: iter(stream()))
                            .withTimestampExtractor(lambda t: t["ts"])
                            .withOutputBatchSize(64).build())
        pipe.add(MB(lambda t: {"key": t["key"], "value": t["value"] + 1})
                 .withName("m").build())
        pipe.chain(FB(lambda t: t["key"] != 3).withName("f").build())
        pipe.add(pkg.Paned_Windows_Builder(NONINC, sum)
                 .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
                 .withName("pw").build())
        pipe.add_sink(pkg.Sink_Builder(
            lambda r: got.append((r.key, r.wid, r.value))
            if r is not None else None).build())
        return g
    runs = {}
    for pkg in (wf, wt):
        for fuse in (True, False):
            got = []
            g = build(pkg, fuse, got)
            assert g.check() == []
            g.run()
            segs = [[m.name for m in seg["members"]]
                    for seg in g._fused_segments]
            runs[(pkg, fuse)] = (sorted(got), segs)
            for op in g._operators:
                if op.name.startswith("pw"):
                    assert op._fused_into is None
                    assert op._fused_prelude is None
    assert runs[(wt, True)][0] == runs[(wt, False)][0] \
        == runs[(wf, True)][0]
    assert runs[(wt, True)][1] == runs[(wf, True)][1]
    assert all(not n.startswith("pw") for seg in runs[(wt, True)][1]
               for n in seg)
