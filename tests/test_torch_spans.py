"""The port's host spans (windflow_tpu_torch/monitoring/recorder.py:
``span``, ``SpanTable``, ``ServiceSpan``), on the CPU.

* self time under nesting, on an injected clock;
* the off path: ``span()`` returns the shared no-op, records nothing
  and reads no clock;
* a FrameSource → filter → TB window → columnar sink graph at K = 2 (the
  eager megastep body) under a CPU ``torch.profiler``: the capture holds
  every ``wf:`` span, each nested in a ``wf:sweep``; ``stats()["Spans"]``
  counts the chunks ticked, the packed batches and the megasteps, and
  the self times add up to the sweeps' time;
* the service spans: ``service_usec_per_operator`` now holds the source's
  ticks, with the spans on or off, and the host worker pool's threads
  time their dispatches without touching the sweep's table;
* the megastep body records the same ops with the spans on and off.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import windflow_tpu_torch as wt
from windflow_tpu_torch import megastep as ms
from windflow_tpu_torch.monitoring import recorder as rec
from windflow_tpu_torch.monitoring.stats import StatsRecord

# one intra-op thread: toy sizes beside other test workers
torch.set_num_threads(1)

N, CAP, KEYS = 4096, 256, 8
#: a chunk of whole records: no carry, one parse a chunk
CHUNK = CAP * 24 * 2
CHUNKS = -(-N * 24 // CHUNK)
SPEC = {"key": np.int32(0), "v": np.float32(0.0)}
GRAPH_SPANS = {"wf:sweep", "wf:tick:src", "wf:source.fetch",
               "wf:source.parse", "wf:source.columns", "wf:stage.pack",
               "wf:megastep.stack", "wf:megastep.launch",
               "wf:megastep.emit", "wf:drain:snk", "wf:egress", "wf:sink"}


class Clock:
    """An injected clock: ``advance`` moves it, each read returns it."""

    def __init__(self):
        self.t = 1_000
        self.reads = 0

    def __call__(self):
        self.reads += 1
        return self.t

    def advance(self, ns):
        self.t += ns


@pytest.fixture
def table():
    clock = Clock()
    tab = rec.SpanTable(clock=clock)
    tab.enabled = True
    prev = rec.activate(tab)
    yield tab, clock
    rec.activate(prev)


def _row(tab, name):
    i = tab.names.index(name)
    return tab.count[i], tab.total_ns[i], tab.self_ns[i]


def test_self_time_under_nesting(table):
    tab, clock = table
    with rec.span("a"):
        clock.advance(10)
        with rec.span("b"):
            clock.advance(5)
            with rec.span("c"):
                clock.advance(2)
            clock.advance(1)
        with rec.span("b"):
            clock.advance(7)
        clock.advance(3)
    # b: 8 + 7, of which c's 2 is nested; a: 10 + 15 + 3, b's 15 nested
    assert _row(tab, "a") == (1, 28, 13)
    assert _row(tab, "b") == (2, 15, 13)
    assert _row(tab, "c") == (1, 2, 2)
    assert tab._stack == []
    # the self times partition the outermost span
    assert sum(tab.self_ns) == 28
    s = tab.summary()
    assert s["enabled"] is True and s["batches_staged"] == 0
    assert s["spans"]["a"] == {"count": 1, "total_ms": 28e-6,
                               "self_ms": 13e-6}


def test_a_raise_inside_a_span_closes_it(table):
    tab, clock = table
    with pytest.raises(KeyError):
        with rec.span("outer"):
            with rec.span("inner"):
                clock.advance(4)
                raise KeyError("x")
    assert tab._stack == []
    assert _row(tab, "inner") == (1, 4, 4)
    assert _row(tab, "outer") == (1, 4, 0)


def test_service_span_feeds_the_stats_and_the_table(table):
    tab, clock = table
    st = StatsRecord(operator_name="op")
    svc = rec.ServiceSpan("wf:drain:op", st)
    with rec.span("wf:sweep"):
        with svc:
            clock.advance(3_000)
        with svc:
            clock.advance(5_000)
    assert _row(tab, "wf:drain:op") == (2, 8_000, 8_000)
    assert _row(tab, "wf:sweep") == (1, 8_000, 0)
    # the same two reads, in µs, feed the service time and histogram
    assert st.num_service_samples == 2 and st.service_time_usec == 8.0
    assert st.service_hist.count == 2 and st.avg_service_time_usec() == 4.0
    assert st.to_json()["Service_time_usec"] == 4.0


def test_service_span_times_with_the_spans_off(monkeypatch):
    assert rec.activate(None) is None
    reads = iter([100, 2_600])
    monkeypatch.setattr(rec.time, "perf_counter_ns", lambda: next(reads))
    st = StatsRecord()
    with rec.ServiceSpan("wf:tick:src", st):
        pass
    assert st.num_service_samples == 1 and st.service_time_usec == 2.5


def test_off_path_is_the_shared_no_op(monkeypatch):
    prev = rec.activate(None)
    try:
        def no_clock():
            raise AssertionError("the off path read a clock")
        monkeypatch.setattr(rec.time, "perf_counter_ns", no_clock)
        spans = {rec.span(n) for n in ("wf:sweep", "wf:source.parse", "x")}
        assert spans == {rec.NO_SPAN}
        with rec.span("wf:sweep") as s:
            assert s is rec.NO_SPAN
        rec.note_staged(3)      # no table: nothing to count into
    finally:
        rec.activate(prev)


def test_spans_never_on_read_disabled():
    tab = rec.SpanTable(clock=Clock())
    assert tab.summary() == {"enabled": False}


# -- a graph ------------------------------------------------------------------

def _blob(n=N, seed=5):
    rng = np.random.default_rng(seed)
    r = np.zeros(n, dtype=[("k", "<i8"), ("ts", "<i8"), ("v", "<f8")])
    r["k"] = rng.integers(0, KEYS, n)
    r["ts"] = np.arange(n, dtype=np.int64) * 500
    r["v"] = rng.integers(0, 4, n)
    return r.tobytes()


def _graph(name, out, **cfg):
    blob = _blob()

    def chunks():
        for i in range(0, len(blob), CHUNK):
            yield blob[i:i + CHUNK]
    src = wt.FrameSource(chunks, nv=1, fields=["v"], name="src",
                         output_batch_size=CAP, record_spec=SPEC)
    kw = dict(device="cpu", megastep_sweeps=2, key_compaction=False,
              punctuation_interval_usec=10 ** 12)
    kw.update(cfg)
    g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=wt.Config(**kw))
    p = g.add_source(src)
    p.add(wt.FilterGPU_Builder(lambda e: e["v"] < 3).withName("keep")
          .build())
    p.add(wt.Ffat_WindowsGPU_Builder(lambda e: e["v"], lambda a, b: a + b)
          .withName("w").withTBWindows(16_000, 16_000)
          .withKeyBy(lambda e: e["key"]).withMaxKeys(KEYS).build())

    def sink(d):
        if d is not None:
            out.extend(zip(np.asarray(d.cols["key"]).tolist(),
                           np.asarray(d.cols["wid"]).tolist(),
                           np.asarray(d.cols["value"]).tolist()))
    p.add_sink(wt.Sink_Builder(sink).withName("snk").withColumnarSink()
               .build())
    return g


def _run(name, prof=False, **cfg):
    out = []
    g = _graph(name, out, **cfg)
    g.start()
    if prof:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            g.wait_end()
    else:
        p = None
        g.wait_end()
    return sorted(out), g, p


def _emitter(g):
    return g._source_replicas[0].emitter


@pytest.fixture(scope="module")
def profiled():
    return _run("spans_prof", prof=True)


def test_capture_holds_every_span_nested_in_a_sweep(profiled):
    _, _, prof = profiled
    ev = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
          for e in prof.profiler.kineto_results.events()
          if e.name().startswith("wf:")]
    assert GRAPH_SPANS <= {n for n, _, _, _ in ev}
    sweeps = [(a, b, t) for n, a, b, t in ev if n == "wf:sweep"]
    for name, a, b, t in ev:
        if name != "wf:sweep":
            assert any(sa <= a and b <= sb and st == t
                       for sa, sb, st in sweeps), name


def test_counts_match_chunks_batches_and_megasteps(profiled):
    out, g, _ = profiled
    assert out, "empty output proves nothing"
    sp = g.stats()["Spans"]
    assert sp["enabled"] is True and set(sp["spans"]) >= GRAPH_SPANS
    counts = {k: v["count"] for k, v in sp["spans"].items()}
    # the fetch and the tick run once more: the fetch that ends the stream
    assert counts["wf:source.fetch"] == counts["wf:tick:src"] == CHUNKS + 1
    assert counts["wf:source.parse"] == counts["wf:source.columns"] \
        == counts["wf:stage.pack"] == CHUNKS
    em = _emitter(g)
    assert sp["batches_staged"] == em.packed_batches == N // CAP
    edge = g.stats()["Megastep"]["edges"][0]
    assert edge["megasteps"] > 0
    for part in ("stack", "launch", "emit"):
        assert counts[f"wf:megastep.{part}"] == edge["megasteps"]
    for row in sp["spans"].values():
        assert 0 <= row["self_ms"] <= row["total_ms"]
    # every span nests in a sweep: the self times add up to the sweeps'
    tab = g._spans
    assert sum(tab.self_ns) == _row(tab, "wf:sweep")[1]


def test_records_equal_with_the_spans_on_and_off(profiled):
    got, _, _ = profiled
    off, g, _ = _run("spans_off")
    assert off == got
    assert g.stats()["Spans"] == {"enabled": False}


def test_service_per_operator_holds_the_source(profiled):
    _, g, _ = profiled
    _, goff, _ = _run("spans_svc_off")
    for graph in (g, goff):
        lat = graph.stats()["Latency"]["service_usec_per_operator"]
        assert lat["src"]["count"] == CHUNKS + 1
        assert lat["src"]["sum"] > 0 and lat["snk"]["count"] > 0
        src = next(o for o in graph.stats()["Operators"]
                   if o["Operator_name"] == "src")
        assert src["Replicas"][0]["Service_time_usec"] > 0


def test_tracing_enabled_turns_the_spans_on_without_the_profiler(tmp_path):
    _, g, _ = _run("spans_tracing", tracing_enabled=True,
                   log_dir=str(tmp_path))
    sp = g.stats()["Spans"]
    assert sp["enabled"] is True and set(sp["spans"]) >= GRAPH_SPANS
    assert g._spans.profiling is False
    assert sp["batches_staged"] == N // CAP


def test_pool_threads_time_their_dispatches_off_the_table(tmp_path):
    """A host map on the worker pool: its dispatches feed its service
    time from a pool thread, and the sweep's table holds none of them."""
    out = []
    src = (wt.Source_Builder(lambda: iter({"key": i % 4, "v": i}
                                          for i in range(600)))
           .withName("gen").withOutputBatchSize(50).build())
    g = wt.PipeGraph("spans_pool", config=wt.Config(
        device="cpu", host_worker_threads=2, tracing_enabled=True,
        log_dir=str(tmp_path)))
    g.add_source(src).add(wt.Map_Builder(
        lambda t: {"key": t["key"], "v": t["v"] + 1}).withName("m")
        .build()).add_sink(wt.Sink_Builder(
            lambda r: out.append(r) if r is not None else None)
            .withName("out").build())
    g.start()
    assert [r.op.name for r in g._pool_replicas].count("m") == 1
    g.wait_end()
    assert len(out) == 600
    lat = g.stats()["Latency"]["service_usec_per_operator"]
    assert lat["m"]["count"] > 0 and lat["gen"]["count"] > 0
    spans = g.stats()["Spans"]["spans"]
    assert "wf:drain:m" not in spans and "wf:tick:gen" in spans


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_megastep_body_is_the_same_with_the_spans_on_and_off(monkeypatch,
                                                            tmp_path):
    """The group body's ops, recorded at every group, are the same with
    the spans off, on under the profiler and on under tracing: nothing
    of a span enters the body."""
    orig = ms.MegastepEdge._body

    def recording(seen):
        def body(self, step, pkt):
            f = orig(self, step, pkt)

            def run(carry, x, wm):
                with _OpLog() as log:
                    res = f(carry, x, wm)
                seen.append(tuple(log.ops))
                return res
            return run
        return body
    runs = {}
    for how in ("off", "profiler", "tracing"):
        seen = []
        monkeypatch.setattr(ms.MegastepEdge, "_body", recording(seen))
        kw = {"tracing_enabled": True, "log_dir": str(tmp_path)} \
            if how == "tracing" else {}
        recs, g, _ = _run(f"spans_body_{how}", prof=how == "profiler", **kw)
        runs[how] = (recs, seen)
        assert g.stats()["Spans"]["enabled"] is (how != "off")
    recs, seen = runs["off"]
    assert recs and seen and seen[0]
    assert not any("profiler" in op for ops in seen for op in ops)
    for how in ("profiler", "tracing"):
        assert runs[how] == (recs, seen)
