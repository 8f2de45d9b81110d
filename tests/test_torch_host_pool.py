"""The host worker pool (``Config.host_worker_threads``) of the port,
held against the JAX package: twins of ``tests/test_host_pool.py``, the
race detector's pool case (``tests/test_analysis.py``) and a tier-1
sized twin of the pooled soak (``tests/test_soak_memory.py``), plus the
port's own rule: a pooled replica never consumes or emits a device
batch, so a pool thread never touches the card."""

import dataclasses
import tempfile
import threading

import numpy as np
import pytest

import windflow_tpu as wf
import windflow_tpu_torch as wt
from windflow_tpu_torch.batch import DeviceBatch


def _cfg(pkg, workers, **kw):
    if pkg is wt:
        kw.setdefault("device", "cpu")
    return pkg.Config(host_worker_threads=workers, **kw)


def _dev(pkg, name):
    return getattr(pkg, name + ("GPU_Builder" if pkg is wt
                                else "TPU_Builder"))


def _host_graph(pkg, workers):
    """Source -> keyed FlatMap(4) -> KeyedWindows(4) -> Sink(2), all host
    (each key flows through one channel end to end, so the windows'
    contents do not depend on the schedule)."""
    results = []
    lock = threading.Lock()
    n, keys = 4000, 16

    def gen():
        for i in range(n):
            yield {"k": i % keys, "v": float(i)}

    def expand(t, shipper):
        shipper.push({"k": t["k"], "v": t["v"]})
        if t["k"] % 2 == 0:
            shipper.push({"k": t["k"], "v": -t["v"]})

    def win(t, acc):
        return (acc or 0.0) + t["v"]

    def sink(r):
        if r is not None:
            with lock:
                results.append((int(r.key), int(r.wid), float(r.value)))

    g = pkg.PipeGraph("host_pool", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, workers))
    src = pkg.Source_Builder(gen).withOutputBatchSize(64).build()
    fm = (pkg.FlatMap_Builder(expand).withKeyBy(lambda t: t["k"])
          .withParallelism(4).build())
    kw = (pkg.Keyed_Windows_Builder(win).withCBWindows(8, 4)
          .withKeyBy(lambda t: t["k"]).withParallelism(4).build())
    snk = pkg.Sink_Builder(sink).withParallelism(2).build()
    g.add_source(src).add(fm).add(kw).add_sink(snk)
    g.run()
    return sorted(results), g


def test_pool_matches_single_thread_host_graph():
    pooled, g = _host_graph(wt, 4)
    assert len(g._pool_replicas) == 10       # every host replica
    assert pooled == _host_graph(wt, 0)[0] == _host_graph(wf, 4)[0]


def _mixed(pkg, workers):
    acc = {}

    def sink(t):
        if t is not None:
            k = int(t["k"])
            acc[k] = acc.get(k, 0.0) + float(t["v"])

    g = pkg.PipeGraph("pool_mixed", pkg.ExecutionMode.DEFAULT,
                      config=_cfg(pkg, workers))
    src = (pkg.Source_Builder(
            lambda: iter({"k": i % 8, "v": float(i)} for i in range(4096)))
           .withOutputBatchSize(256).build())
    m = (pkg.Map_Builder(lambda t: {"k": t["k"], "v": t["v"] * 2})
         .withParallelism(3).withOutputBatchSize(256).build())
    red = (_dev(pkg, "Reduce")(
            lambda a, b: {"k": a["k"], "v": a["v"] + b["v"]})
           .withKeyBy(lambda t: t["k"]).build())
    snk = pkg.Sink_Builder(sink).build()
    g.add_source(src).add(m).add(red).add_sink(snk)
    g.run()
    return acc, g


def test_pool_matches_single_thread_mixed_gpu_graph():
    """Host stages around a device reduce: records equal at 0 and 4
    threads and to JAX's.  Both host stages sit on an edge that carries
    device batches (the map stages into the reduce, the sink takes its
    egress), so the port keeps them on the driver thread."""
    pooled, g = _mixed(wt, 4)
    assert pooled == _mixed(wt, 0)[0] == _mixed(wf, 4)[0]
    assert g._pool is None                    # shut down at the end
    assert g._pool_replicas == []
    assert len(g._main_replicas) == len(g._all_replicas)


def test_pool_shared_db_stays_on_driver_thread():
    """Shared-DB persistent replicas are not pool-safe: the graph runs
    right with the pool on, and the partition keeps them off it."""
    from windflow_tpu_torch.persistent import P_Map_Builder

    with tempfile.TemporaryDirectory() as d:
        seen = []

        def fn(t, state):
            state["sum"] += t["v"]
            return {"k": t["k"], "v": state["sum"]}

        g = wt.PipeGraph("pool_pdb", wt.ExecutionMode.DEFAULT,
                         config=_cfg(wt, 4))
        src = (wt.Source_Builder(
                lambda: iter({"k": i % 4, "v": 1.0} for i in range(64)))
               .withOutputBatchSize(16).build())
        pm = (P_Map_Builder(fn).withDbPath(f"{d}/kv").withSharedDb()
              .withInitialState({"sum": 0.0})
              .withKeyBy(lambda t: t["k"]).withParallelism(2).build())
        snk = wt.Sink_Builder(
            lambda t: seen.append((t["k"], t["v"]))
            if t is not None else None).build()
        g.add_source(src).add(pm).add_sink(snk)
        g.run()
        assert pm.host_pool_safe is False
        assert pm.replicas[0] in g._main_replicas
        assert pm.replicas[0] not in g._pool_replicas
        assert snk.replicas[0] in g._pool_replicas
        finals = {}
        for k, v in seen:
            finals[k] = max(finals.get(k, 0.0), v)
        assert finals == {k: 16.0 for k in range(4)}


def test_pool_deterministic_mode_matches():
    def run(pkg, workers):
        out = []
        g = pkg.PipeGraph("pool_det", pkg.ExecutionMode.DETERMINISTIC,
                          config=_cfg(pkg, workers))
        src = (pkg.Source_Builder(lambda: iter(range(2000)))
               .withParallelism(3).withOutputBatchSize(32).build())
        m = pkg.Map_Builder(lambda x: x * 2).withParallelism(2).build()
        snk = pkg.Sink_Builder(
            lambda x: out.append(x) if x is not None else None).build()
        g.add_source(src).add(m).add_sink(snk)
        g.run()
        return out

    assert run(wt, 4) == run(wt, 0) == run(wf, 4)


def test_operator_error_propagates_and_releases_pool():
    class Boom(RuntimeError):
        pass

    def bad(t):
        if t >= 64:
            raise Boom("user fn failed")
        return t

    with tempfile.TemporaryDirectory() as d:
        g = wt.PipeGraph("err_path", wt.ExecutionMode.DEFAULT,
                         config=_cfg(wt, 2, tracing_enabled=True,
                                     log_dir=d))
        g.add_source(wt.Source_Builder(lambda: iter(range(256)))
                     .withOutputBatchSize(32).build()) \
         .add(wt.Map(bad)) \
         .add_sink(wt.Sink_Builder(lambda t: None).build())
        with pytest.raises(Boom):
            g.run()
        assert g._pool is None
        assert g._monitor is None


def test_source_start_failure_releases_pool():
    class BootBoom(RuntimeError):
        pass

    def bad_gen():
        raise BootBoom("generator factory failed")

    g = wt.PipeGraph("start_err", wt.ExecutionMode.DEFAULT,
                     config=_cfg(wt, 2))
    g.add_source(wt.Source_Builder(bad_gen)
                 .withOutputBatchSize(32).build()) \
     .add(wt.Map(lambda t: t)) \
     .add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(BootBoom):
        g.run()
    assert g._pool is None
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("wf-start_err")]
    assert not alive, alive


def _slow_fast(workers, n=240):
    """A keyed Map of 2 replicas: key 0's replica blocks on a
    GIL-releasing wait every tuple, key 1's does not.  Driven sweep by
    sweep: returns the records and, per replica, the sweep at which it
    first emitted."""
    out = []
    lock = threading.Lock()
    stall = threading.Event()

    def fn(t):
        if t["k"] == 0:
            stall.wait(0.0005)    # never set: a short blocking wait
        return t

    def sink(t):
        if t is not None:
            with lock:
                out.append((t["k"], t["v"]))

    g = wt.PipeGraph("slow_replica", wt.ExecutionMode.DEFAULT,
                     config=_cfg(wt, workers,
                                 punctuation_interval_usec=1 << 50))
    src = (wt.Source_Builder(lambda: iter({"k": i % 2, "v": i}
                                          for i in range(n)))
           .withOutputBatchSize(32).build())
    m = (wt.Map_Builder(fn).withKeyBy(lambda t: t["k"])
         .withParallelism(2).build())
    g.add_source(src).add(m).add_sink(wt.Sink_Builder(sink).build())
    g.start()
    first = {}
    sweep = 0
    while not g.is_done():
        assert g.step()
        sweep += 1
        for rep in m.replicas:
            if rep.stats.outputs_sent and rep.index not in first:
                first[rep.index] = sweep
    g._finalize()
    return sorted(out), first, sweep, m


def test_pool_slow_replica_does_not_starve_siblings():
    """Structural twin of the JAX timing test: with the pool, the slow
    replica and its sibling drain as tasks of one sweep, each in its own
    thread; the sibling emits by the same sweep as in the serial run and
    no later than the slow one, every sweep, and the records are
    identical.  No wall clock is read."""
    serial_out, serial_first, serial_sweeps, _ = _slow_fast(0)
    pooled_out, pooled_first, pooled_sweeps, m = _slow_fast(2)
    assert pooled_out == serial_out
    assert set(pooled_first) == {0, 1}
    assert pooled_first[1] <= serial_first[1]
    assert pooled_first[1] <= pooled_first[0]
    assert pooled_sweeps <= serial_sweeps + 1


def test_pool_config_stats_and_env(monkeypatch):
    """``Config(host_worker_threads=4)`` builds a pool: stats() reports
    4 workers and 5 threads; the default reads ``WF_TPU_HOST_WORKERS``
    as the JAX package's does."""
    g = wt.PipeGraph("pool_stats", config=_cfg(wt, 4))
    g.add_source(wt.Source_Builder(lambda: iter(range(100)))
                 .withOutputBatchSize(10).build()) \
     .add(wt.Map(lambda x: x + 1)) \
     .add_sink(wt.Sink_Builder(lambda x: None).build())
    g.run()
    st, jst = g.stats(), None
    assert st["Host_worker_threads"] == 4 and st["Thread_number"] == 5
    jg = wf.PipeGraph("pool_stats", config=wf.Config(host_worker_threads=4))
    jg.add_source(wf.Source_Builder(lambda: iter(range(100)))
                  .withOutputBatchSize(10).build()) \
      .add(wf.Map(lambda x: x + 1)) \
      .add_sink(wf.Sink_Builder(lambda x: None).build())
    jg.run()
    jst = jg.stats()
    for key in ("Host_worker_threads", "Thread_number"):
        assert st[key] == jst[key]
    assert wt.Config().host_worker_threads == wf.Config().host_worker_threads
    monkeypatch.setenv("WF_TPU_HOST_WORKERS", "3")
    import importlib

    import windflow_tpu_torch.basic as basic
    fresh = importlib.reload(basic)
    try:
        assert fresh.Config().host_worker_threads == 3
    finally:
        monkeypatch.delenv("WF_TPU_HOST_WORKERS")
        importlib.reload(basic)


def test_pooled_replicas_never_touch_device_batches():
    """The port's partition: a host replica is pooled only when no edge
    into or out of it carries device batches.  A graph with a host stage
    before a device map, one behind it, and a host-only chain after:
    the pooled replicas are exactly the host-only chain's, and none of
    them ever receives or emits a device batch, or runs on the driver
    thread."""
    acc = []
    g = wt.PipeGraph("pool_rule", config=_cfg(wt, 4))
    src = (wt.Source_Builder(lambda: iter({"k": i % 4, "v": np.float32(i)}
                                          for i in range(2048)))
           .withOutputBatchSize(128)
           .withRecordSpec({"k": np.int32(0), "v": np.float32(0)}).build())
    pre = (wt.Map_Builder(lambda t: t).withName("pre")
           .withOutputBatchSize(128).build())
    dev = (wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] * 2})
           .withName("dev").build())
    post = wt.Map_Builder(lambda t: t).withName("post").build()
    tail = (wt.Map_Builder(lambda t: {"k": int(t["k"]), "v": float(t["v"])})
            .withName("tail").withParallelism(2).build())
    snk = (wt.Sink_Builder(lambda t: acc.append(t) if t is not None
                           else None).withName("snk").build())
    g.add_source(src).add(pre).add(dev).add(post).add(tail).add_sink(snk)
    g.start()
    pooled = {r.op.name for r in g._pool_replicas}
    assert pooled == {"tail", "snk"}
    driver = threading.get_ident()
    seen = {"device": 0, "threads": set()}
    for rep in g._pool_replicas:
        rd, rec = rep.receive, rep.drain

        def receive(ch, msg, _rd=rd):
            if isinstance(msg, DeviceBatch):
                seen["device"] += 1
            _rd(ch, msg)

        def drain(limit=0, _rec=rec):
            seen["threads"].add(threading.get_ident())
            return _rec(limit)
        rep.receive, rep.drain = receive, drain
        em = rep.emitter
        if em is not None:
            def emit_dev(*a, **k):
                seen["device"] += 1
            em.emit_device_batch = emit_dev
    g.wait_end()
    assert seen["device"] == 0
    assert seen["threads"] and driver not in seen["threads"]
    assert sorted((r["k"], r["v"]) for r in acc) == sorted(
        (i % 4, float(2 * i)) for i in range(2048))


def test_race_detector_pipeline_with_pool_runs_clean():
    """Twin of ``tests/test_analysis.py``'s pool case: staging, a device
    map and a 2-thread pool under ``WF_TPU_DEBUG_CONCURRENCY`` complete
    with no violation and every record."""
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.analysis import debug_concurrency as dbg
    saved = dict(staging._pools)
    staging._pools.clear()
    dbg.set_enabled(True)
    try:
        acc = []
        lock = threading.Lock()

        def sink(t):
            if t is not None:
                with lock:
                    acc.append(t)
        cfg = dataclasses.replace(wt.Config(device="cpu"),
                                  host_worker_threads=2)
        g = wt.PipeGraph("dbg_run", config=cfg)
        src = (wt.Source_Builder(
            lambda: iter({"k": i % 2, "v": float(i)} for i in range(64)))
            .withOutputBatchSize(16).build())
        g.add_source(src).add(
            wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] + 1.0})
            .build()).add(wt.Map(lambda t: t)).add(
            wt.Map(lambda t: t)).add_sink(wt.Sink_Builder(sink).build())
        g.run()
        assert len(acc) == 64
        assert len(g._pool_replicas) == 2     # the host-only tail
    finally:
        dbg.set_enabled(False)
        staging._pools.clear()
        staging._pools.update(saved)


def test_soak_pool_counts_exact_small():
    """Tier-1 sized twin of the pooled soak: Source -> keyed FlatMap(4)
    -> KeyedWindows(4) -> Sink(2) on 4 pool threads; the counts are
    exact (no RSS timing: the nightly JAX soak keeps that)."""
    n_tuples, n_keys = 32768, 64
    got = [0, 0]
    lock = threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                got[0] += 1
                got[1] += int(r.value)

    g = wt.PipeGraph("soak_pool", wt.ExecutionMode.DEFAULT,
                     config=_cfg(wt, 4))
    g.add_source(wt.Source_Builder(
        lambda: iter({"k": i % n_keys, "v": 1} for i in range(n_tuples)))
        .withOutputBatchSize(512).build()) \
     .add(wt.FlatMap_Builder(lambda t, s: s.push(t))
          .withKeyBy(lambda t: t["k"]).withParallelism(4).build()) \
     .add(wt.Keyed_Windows_Builder(lambda t, acc: (acc or 0) + t["v"])
          .withCBWindows(64, 64).withKeyBy(lambda t: t["k"])
          .withParallelism(4).build()) \
     .add_sink(wt.Sink_Builder(sink).withParallelism(2).build())
    g.run()
    assert got == [n_tuples // 64, n_tuples]


def test_driver_drain_error_joins_pooled_drains_first():
    """A driver-thread replica that raises mid-sweep leaves the sweep
    only after the sweep's pooled drains have ended: the crash path's
    postmortem (and then the stores' close) never runs beside a pooled
    drain that is still writing."""
    class Boom(RuntimeError):
        pass

    in_flight = [0]
    lock = threading.Lock()
    stall = threading.Event()

    def slow(t):
        with lock:
            in_flight[0] += 1
        stall.wait(0.005)           # never set: a short blocking wait
        with lock:
            in_flight[0] -= 1
        return t

    def boom(t):
        if t is not None:
            # fail while the sweep's pooled drain of the Map is running
            for _ in range(1000):
                if in_flight[0]:
                    break
                stall.wait(0.001)
            raise Boom("driver-thread sink failed")

    g = wt.PipeGraph("join_on_error", wt.ExecutionMode.DEFAULT,
                     config=_cfg(wt, 2))
    snk = wt.Sink_Builder(boom).build()
    snk.host_pool_safe = False      # the sink drains on the driver thread
    g.add_source(wt.Source_Builder(lambda: iter(range(512)))
                 .withOutputBatchSize(32).build()) \
     .add(wt.Map(slow)).add_sink(snk)
    seen = []
    g._write_crash_postmortem = lambda exc: seen.append(in_flight[0])
    with pytest.raises(Boom):
        g.run()
    assert seen == [0]
    assert {r.op.name for r in g._main_replicas} >= {snk.name}
    assert g._pool is None
