#!/usr/bin/env python3
"""Where the time of the port's slices goes, on one GPU.

    python3 chip_profile.py

On the main paths of ``chip_smoke.py`` (the same graphs, built by
``chip_smoke.main_path_graph`` and ``chip_smoke.reduce_graph``: 262,144
tuples a batch, 1,024 keys; CB windows 1,024/128) it measures, in one
process:

* host: one source tick of a batch of per-record tuples through the
  staging emitter, and ``host_to_device`` alone (record stacking +
  packing + the one copy), on the host clock;
* device: the graph's Map|Filter chain step and FFAT step (generic
  combiner and ``withSumCombiner``) on staged batches, by CUDA events,
  and the egress of one window batch;
* the kernels of one FFAT step of each kind, by ``torch.profiler``;
* the ReduceGPU step on each route — (a) compacted max, (b) compacted
  sum, (c) dense max, (d) sorted max — on a staged, filtered batch:
  wall time on the host clock around a synchronised step (the compacted
  step's one host read of its miss count included), device time and
  launches by ``torch.profiler``;
* the device busy share of a whole ``PipeGraph.run()`` (8 batches) of
  FFAT with the sum combiner and of the reduce's route (a): device time
  of every kernel over the host wall time;
* the dense-table kernel alone at the reduce routes' three calls
  (``chip_smoke.py`` phase 2's inputs) for lane tiles of 2,048, 4,096
  and 8,192 (``reduce_cuda.TABLE_TILE``), device time of each of its
  two kernels by ``torch.profiler``;
* the shared- and global-memory atomic instructions each kernel library
  was compiled to (``cuobjdump -sass``), by kernel: a 64-bit fold that
  has no native instruction shows as a compare-and-swap loop.

Prints one JSON object a line, then the card's name and power limit.
Needs CUDA; exits nonzero when ``torch.profiler`` records no device time.
"""

import json
import subprocess
import sys
import time

from chip_smoke import (BATCHES, CAP, KEYS, _device_us, cuda_time, fail,
                        main_path_data, main_path_graph, reduce_graph)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def host_phase(dev):
    import torch
    from windflow_tpu_torch.batch import HostBatch, host_to_device
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    keys, vals = main_path_data(CAP, seed=5)
    got = []

    class Inbox:
        def receive(self, ch, msg):
            got.append(msg)
    em = DeviceStageEmitter([(Inbox(), 0)], CAP, dev)
    items = [{"key": k, "v0": v} for k, v in zip(keys, vals)]
    t0 = time.perf_counter()
    for i, it in enumerate(items):
        em.emit(it, i, i)
    torch.cuda.synchronize()
    t_emit = time.perf_counter() - t0
    hb = HostBatch(items, list(range(CAP)))
    t0 = time.perf_counter()
    host_to_device(hb, CAP, dev)
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in ({"key": k, "v0": v} for k, v in zip(keys, vals)):
        pass
    t_gen = time.perf_counter() - t0
    emit(phase="host", tuples=CAP, generator_s=t_gen,
         emit_and_stage_s=t_emit, host_to_device_s=t_stage,
         note="host clock, one batch; emit_and_stage includes "
              "host_to_device")
    return got[0]


def device_phase(staged):
    import torch
    from windflow_tpu_torch.batch import device_to_host
    keys, vals = main_path_data(CAP, seed=5)
    out = {}
    for sum_combiner in (False, True):
        g, pipe = main_path_graph("cuda", sum_combiner, keys, vals,
                                  lambda t: None)
        g._build()               # config, device and replicas, as run() does
        chain, w = pipe.operators[1], pipe.operators[2]
        mid = chain._step(staged)
        for _ in range(4):    # state + first-use build; then every
            w._step(mid)      # further step fires ~2 windows a key
        state0 = {k: v.clone() if hasattr(v, "clone") else v
                  for k, v in w._state.items()}
        out["chain_ms"] = cuda_time(lambda: chain._step(staged))

        def ffat_step():
            w._state = dict(state0)
            return w._step(mid)
        key = "ffat_sum_ms" if sum_combiner else "ffat_generic_ms"
        out[key] = cuda_time(ffat_step, iters=10, warmup=2)
        res = ffat_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hb = device_to_host(res)
        out["egress_one_window_batch_s"] = time.perf_counter() - t0
        out["windows_per_batch"] = len(hb.items)
        out[key.replace("_ms", "_profile")] = profile_step(ffat_step)
    emit(phase="device", capacity=CAP, keys=KEYS, **out)


def reduce_phase(staged):
    """The ReduceGPU step of each route on the same staged batch, after
    the Map|Filter chain."""
    import torch
    keys, vals = main_path_data(CAP, seed=5)
    out = {}
    for label, monoid, declare, kc in (("a_compacted_max", "max", True, True),
                                       ("b_compacted_sum", "sum", True, True),
                                       ("c_dense_max", "max", True, False),
                                       ("d_sorted_max", "max", False, True)):
        g, red = reduce_graph("cuda", monoid, declare, kc, keys, vals,
                              lambda c: None)
        g._build()          # config, device and compaction, as run() does
        chain = g.pipes[0].operators[1]
        mid = chain._step(staged)
        for _ in range(3):
            red._step(mid)
        torch.cuda.synchronize()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            red._step(mid)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[label] = {"wall_ms": 1e3 * sum(walls) / len(walls),
                      "profile": profile_step(lambda: red._step(mid))}
    emit(phase="reduce", capacity=CAP, keys=KEYS,
         note="wall: host clock around one synchronised step, mean of 10",
         **out)


def profile_step(fn):
    """Top kernels of one call of ``fn`` by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(_device_us(e), e.key, e.count) for e in prof.key_averages()
            if e.device_type.name == "CUDA" and _device_us(e) > 0]
    if not rows:
        fail("torch.profiler recorded no device time for the step")
    rows.sort(reverse=True)
    return {"device_us": sum(r[0] for r in rows),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "us": t, "count": c}
                    for t, k, c in rows[:8]]}


def run_phase():
    """Device busy share of one whole PipeGraph.run() of each path: FFAT
    with the sum combiner, and the reduce's route (a), compacted max."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keys, vals = main_path_data(CAP * BATCHES, seed=9)
    for path in ("ffat_sum", "reduce_compacted_max"):
        n = [0]
        if path == "ffat_sum":
            g, _ = main_path_graph(
                "cuda", True, keys, vals,
                lambda t: n.__setitem__(0, n[0] + 1) if t is not None
                else None)
        else:
            g, _ = reduce_graph(
                "cuda", "max", True, True, keys, vals,
                lambda c: n.__setitem__(0, n[0] + len(c)) if c is not None
                else None)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(_device_us(e) for e in prof.key_averages())
        if busy_us <= 0:
            fail("torch.profiler recorded no device time for "
                 "PipeGraph.run()")
        emit(phase="run", path=path, tuples=len(keys), records=n[0],
             wall_s=wall, device_busy_s=busy_us / 1e6,
             device_idle_share=1 - busy_us / 1e6 / wall)


def table_tile_phase(dev):
    """The dense-table kernel's device time per call at three tile sizes,
    on the inputs of chip_smoke's three main-path calls."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import reduce_cuda as rc
    from windflow_tpu_torch.parallel.compaction import _enc64
    keys, vals = main_path_data(CAP, seed=13, key_range=KEYS + 16)
    vals = vals * np.float32(1.5) + np.float32(1.0)
    keep = (keys & 7) != 7
    k_t, v_t = (torch.from_numpy(a).to(dev) for a in (keys, vals))
    ts_t = torch.arange(CAP, dtype=torch.int64, device=dev) + 10 ** 15
    ok = torch.from_numpy(keep).to(dev)
    row = torch.where(ok & (k_t < KEYS), k_t, torch.full_like(k_t, KEYS))
    carrier = torch.cat([_enc64(k_t)[:, None], _enc64(v_t)[:, None],
                         ts_t[:, None]], 1).contiguous()
    ones = torch.ones(CAP, dtype=torch.int32, device=dev)
    i64min = -2 ** 63
    calls = {"a": ([carrier], ["max"], [i64min]),
             "b": ([k_t, v_t, ts_t], ["sum", "sum", "max"], [0, 0.0, i64min]),
             "c": ([k_t, v_t, ones, ts_t], ["max", "max", "sum", "max"],
                   [-2 ** 31, float("-inf"), 0, -1])}
    default = rc.TABLE_TILE
    out = {}
    try:
        for tile in (2048, 4096, 8192):
            rc.TABLE_TILE = tile
            for tag, args in calls.items():
                def call():
                    return rc.dense_monoid_table(row, *args, KEYS)
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                us = {}
                for e in prof.key_averages():
                    for kernel in ("table_pass1", "table_pass2"):
                        if kernel in e.key and _device_us(e) > 0:
                            us[kernel] = us.get(kernel, 0.0) + _device_us(e) / 20
                if len(us) != 2:
                    fail(f"torch.profiler missed a table kernel: {us}")
                out[f"{tag}_tile{tile}"] = {"device_us": sum(us.values()),
                                            **us}
    finally:
        rc.TABLE_TILE = default
    emit(phase="table_tiles", default_tile=default, **out)


def sass_phase():
    """Atomic opcodes in the SASS of each built kernel library, counted
    per kernel (``cuobjdump`` from the toolkit that built them)."""
    import collections
    import os
    from windflow_tpu_torch.kernels import build
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    for name in build.SOURCES:
        r = subprocess.run([cuobjdump, "-sass", build._lib_path(name)],
                           capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            fail(f"cuobjdump failed on {name}: {r.stderr.strip()[-400:]}")
        ops = collections.Counter()
        kernel = None
        for line in r.stdout.splitlines():
            if "Function :" in line:
                kernel = line.split("Function :")[1].strip()
            elif "*/" in line:
                op = line.split("*/", 1)[1].strip().split(" ")[0]
                if op.startswith(("ATOM", "RED")):
                    ops[f"{kernel} {op}"] += 1
        emit(phase="sass", library=name, atomic_opcodes=dict(ops))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    from windflow_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all()
    staged = host_phase(dev)
    device_phase(staged)
    reduce_phase(staged)
    run_phase()
    table_tile_phase(dev)
    sass_phase()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
