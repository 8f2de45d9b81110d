#!/usr/bin/env python3
"""Where the time of the port's count-window slice goes, on one GPU.

    python3 chip_profile.py

On the main path of ``chip_smoke.py`` (the same graph, built by
``chip_smoke.main_path_graph``: 262,144 tuples a batch, 1,024 keys, CB
windows 1,024/128) it measures, in one process:

* host: one source tick of a batch of per-record tuples through the
  staging emitter, and ``host_to_device`` alone (record stacking +
  packing + the one copy), on the host clock;
* device: the graph's Map|Filter chain step and FFAT step (generic
  combiner and ``withSumCombiner``) on staged batches, by CUDA events,
  and the egress of one window batch;
* the kernels of one FFAT step of each kind, by ``torch.profiler``;
* the device busy share of a whole ``PipeGraph.run()`` (sum combiner,
  8 batches): device time of every kernel over the host wall time.

Prints one JSON object a line, then the card's name and power limit.
Needs CUDA; exits nonzero when ``torch.profiler`` records no device time.
"""

import json
import subprocess
import sys
import time

from chip_smoke import (BATCHES, CAP, KEYS, cuda_time, fail, main_path_data,
                        main_path_graph)


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


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if t is None else t


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
        fail("torch.profiler recorded no device time for the FFAT step")
    rows.sort(reverse=True)
    return {"device_us": sum(r[0] for r in rows),
            "kernel_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "us": t, "count": c}
                    for t, k, c in rows[:8]]}


def run_phase():
    """Device busy share of one whole PipeGraph.run()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    keys, vals = main_path_data(CAP * BATCHES, seed=9)
    n = [0]
    g, _ = main_path_graph(
        "cuda", True, keys, vals,
        lambda t: n.__setitem__(0, n[0] + 1) if t is not None else None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(_device_us(e) for e in prof.key_averages())
    if busy_us <= 0:
        fail("torch.profiler recorded no device time for PipeGraph.run()")
    emit(phase="run", tuples=len(keys), windows=n[0], wall_s=wall,
         device_busy_s=busy_us / 1e6,
         device_idle_share=1 - busy_us / 1e6 / wall)


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
    run_phase()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
