"""The JAX package's randomized DAG fuzzer run through both packages,
with the host worker pool as the dimension under test: each seed's
random DAG (host and device stages, an optional split or merge, a keyed
window or reduce tail) and random parallelism/batch configuration runs
once through ``windflow_tpu`` (``tests/test_dag_fuzz.py::_run_dag``, the
oracle) and through the port at 0, 2 and 4 pool threads
(``Config.host_worker_threads``), every other draw the same.  Outputs
compare as the JAX fuzzer compares them (exact; reduce tails by
totals)."""

import random
import threading

import pytest

import windflow_tpu_torch as wt
from test_dag_fuzz import (ALL_STAGES, HOST_STAGES, N_KEYS, _run_dag,
                           stream)

#: the JAX fuzzer's tier-1 seeds
SEEDS = (101, 303, 606, 2009, 2011, 2018, 2031)

_oracles = {}


def _oracle(seed):
    if seed not in _oracles:
        _oracles[seed] = _run_dag(seed, random.Random(seed * 13 + 1))
    return _oracles[seed]


def _mk_stage(kind, rnd):
    par = rnd.randint(1, 3)
    obs = rnd.randint(1, 32)
    if kind == "map":
        return (wt.Map_Builder(lambda t: {**t, "value": t["value"] + 7})
                .withParallelism(par).withOutputBatchSize(obs).build())
    if kind == "flatmap":
        def fm(t, shipper):
            shipper.push(dict(t))
            if t["value"] % 3 == 0:
                shipper.push({**t, "value": 1})
        return (wt.FlatMap_Builder(fm)
                .withParallelism(par).withOutputBatchSize(obs).build())
    if kind == "filter":
        return (wt.Filter_Builder(lambda t: t["value"] % 5 != 0)
                .withParallelism(par).withOutputBatchSize(obs).build())
    if kind == "map_tpu":
        return wt.MapGPU_Builder(
            lambda t: {**t, "value": t["value"] * 2}).build()
    return wt.FilterGPU_Builder(lambda t: (t["value"] & 3) != 3).build()


def _run_dag_port(seed, config_rnd, workers):
    """``tests/test_dag_fuzz.py::_run_dag`` on the port, draw for draw,
    with the pool dimension pinned to ``workers``."""
    topo_rnd = random.Random(seed)
    n_stages = topo_rnd.randint(1, 3)
    tail = topo_rnd.choice(["none", "window", "reduce", "tb_window"])
    pool = HOST_STAGES if tail == "window" else ALL_STAGES
    kinds = [topo_rnd.choice(pool) for _ in range(n_stages)]
    do_split = topo_rnd.random() < 0.5
    do_merge = not do_split and topo_rnd.random() < 0.5
    mode = (wt.ExecutionMode.DETERMINISTIC if tail == "window"
            else wt.ExecutionMode.DEFAULT)

    accs = {}
    acc_lock = threading.Lock()

    def mk_sink(name):
        accs[name] = [0, 0]

        def s(r, ctx=None):
            if r is None:
                return
            v = r.value if hasattr(r, "value") else r["value"]
            with acc_lock:
                accs[name][0] += 1
                accs[name][1] += int(v)
        return wt.Sink_Builder(s).withParallelism(
            config_rnd.randint(1, 2)).build()

    config_rnd.choice([0, 0, 2, 4])       # the JAX draw, pinned below
    cfg = wt.Config(device="cpu", host_worker_threads=workers,
                    whole_chain_fusion=config_rnd.choice([True, True,
                                                          False]),
                    key_compaction=config_rnd.choice([True, True, False]),
                    cuda_kernels=config_rnd.choice(["auto", "auto", "0"]),
                    megastep_sweeps=config_rnd.choice(["auto", "auto", 4]))
    g = wt.PipeGraph("fuzz", mode, wt.TimePolicy.EVENT, config=cfg)
    src_batch = config_rnd.randint(1, 64)
    mp = g.add_source(
        wt.Source_Builder(lambda: iter(stream(seed)))
        .withTimestampExtractor(lambda t: t["ts"])
        .withOutputBatchSize(src_batch).build())
    if do_merge:
        b2 = (src_batch if tail == "tb_window"
              else config_rnd.randint(1, 64))
        mp2 = g.add_source(
            wt.Source_Builder(lambda: iter(stream(seed + 1)))
            .withTimestampExtractor(lambda t: t["ts"])
            .withOutputBatchSize(b2).build())
        mp = mp.merge(mp2)
    for kind in kinds:
        mp.add(_mk_stage(kind, config_rnd))

    def add_tail(pipe, name):
        if tail == "window":
            pipe.add(wt.Keyed_Windows_Builder(
                lambda items: sum(t["value"] for t in items))
                .withCBWindows(8, 4).withKeyBy(lambda t: t["key"])
                .withParallelism(config_rnd.randint(1, 3)).build())
        elif tail == "reduce":
            pipe.add(wt.ReduceGPU_Builder(
                lambda a, b: {"key": a["key"],
                              "value": a["value"] + b["value"],
                              "ts": b["ts"]})
                .withKeyBy(lambda t: t["key"]).build())
        elif tail == "tb_window":
            pipe.add(wt.Ffat_WindowsGPU_Builder(
                lambda t: t["value"], lambda a, b: a + b)
                .withTBWindows(16_000, 8_000)
                .withKeyBy(lambda t: t["key"])
                .withMaxKeys(N_KEYS).build())
        pipe.add_sink(mk_sink(name))

    if do_split:
        mp.split(lambda t: t["key"] % 2, 2)
        add_tail(mp.select(0), "b0")
        add_tail(mp.select(1), "b1")
    else:
        add_tail(mp, "b0")
    g.run()
    if tail == "reduce":
        return {k: v[1] for k, v in accs.items()}, g
    return {k: tuple(v) for k, v in accs.items()}, g


@pytest.mark.parametrize("workers", [0, 2, 4])
@pytest.mark.parametrize("seed", SEEDS)
def test_dag_fuzz_port_equals_jax_under_the_pool(seed, workers):
    got, g = _run_dag_port(seed, random.Random(seed * 13 + 1), workers)
    assert got == _oracle(seed), (seed, workers, got)
    st = g.stats()
    assert st["Host_worker_threads"] == workers
    assert st["Thread_number"] == 1 + workers
