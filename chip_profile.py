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
  steps replay their cached graph: the branch is picked on the card),
  device time and launches by ``torch.profiler``;
* the device busy share of a whole ``PipeGraph.run()`` (8 batches) of
  FFAT with the sum combiner and of the reduce's route (a): device time
  of every kernel over the host wall time;
* the time-window runs of ``chip_smoke.py`` phase 4 ((a) YSB, generic
  and ``withSumCombiner``; (b) telemetry; (c) the grouping kernel's
  shape), on graphs built by its ``ysb_graph`` and ``keyed_tb_graph``:
  per batch the host time of emitting and staging the records, the
  Map|Filter chain and TB step (wall on the host clock around a
  synchronised step, device time and launches by ``torch.profiler``),
  the egress of one TB output batch, and the device idle share of the
  whole ``PipeGraph.run()``;
* the columnar ingest runs of ``chip_smoke.py`` phase 5, (i) frames
  into the count windows (generic and ``withSumCombiner``) and (ii) the
  YSB frames into the time windows, on graphs built by its
  ``frames_cb_graph`` and ``ysb_frames_graph``: per batch the host time
  of parsing the frames (``FrameSourceReplica._ingest``: parse, key
  narrowing, value cast), of packing the columns into the staging
  buffer (``emit_columns``) and of the copy (the finalize, its
  non-blocking copy and a synchronise); the chain and window step
  (wall on the host clock around a synchronised step, device time and
  launches by ``torch.profiler``); the egress of one output batch; and
  the whole ``PipeGraph.run()`` of 16 batches: wall, tuples/s, device
  idle share.  Beside them, from the same process, the record path on
  the same records: per batch one ``emit`` a record through the staging
  emitter, and its whole run (``chip_smoke.main_path_graph``,
  ``ysb_graph``);
* fusion: the four graphs of ``chip_smoke.py`` phase 6 (a) fused and
  unfused (``Config.whole_chain_fusion``), on the same staged batch: the
  hop's device work as each graph runs it (Map, Filter and tail steps;
  or the tail's step with the prelude inside), wall on the host clock
  around a synchronised call, device time and launches by
  ``torch.profiler``; and whole runs of 16 batches in the order
  unfused, fused, fused, unfused (tuples/s);
* stateful: the steps of ``chip_smoke.py`` phase 7 on staged batches of
  its data: (a) the dense fraud scorer's wavefront (with its depth and
  the share of its device time its slot grouping ``auto_order`` takes),
  (c) the associative running count and sum on a uniform and a Zipf
  stream, (b) the scorer over arbitrary card ids, compacted and
  interned, (d) the unbounded compacted reduce: wall on the host clock
  around a synchronised step (mean of 10, state restored), device time
  and launches by ``torch.profiler``;
* the dense-table kernel alone at the reduce routes' three calls
  (``chip_smoke.py`` phase 2's inputs) for lane tiles of 2,048, 4,096
  and 8,192 (``reduce_cuda.TABLE_TILE``), device time of each of its
  two kernels by ``torch.profiler``;
* the fold kernel alone at ``chip_smoke.py`` phase 2's two masks (90% of
  the panes valid, and the FFAT step's own) for runs of 4, 8 and 16
  outputs a thread (``ffat_cuda.FOLD_RUN``), device time by
  ``torch.profiler``;
* megastep: the CB generic step (phase 5 (i)'s count-window graph) and
  the TB generic step (the YSB frames graph, generic combiner) fed
  finalized packets at ``megastep_sweeps`` 1 and 8: wall a logical batch
  on the host clock from the hand-over to a synchronise (copy, unpack and
  step; at K = 8 the super-buffer, the graph replay and the clones), and
  by ``torch.profiler`` device time, kernels and launch calls
  (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``) a
  logical batch; then the eager unpack of one batch with the wire off
  and on (its launches, wire and logical bytes a tuple, the host encode);
* the shared- and global-memory atomic instructions each kernel library
  was compiled to (``cuobjdump -sass``), by kernel: a 64-bit fold that
  has no native instruction shows as a compare-and-swap loop; and the
  global load and store widths of the fold's R = 8 sum kernels
  (``LDG.E.128`` against ``LDG.E``).

    python3 chip_profile.py --only fold_tiles --package-root DIR

runs the named phases only (comma-separated: host, device, reduce, run,
tb, columnar, fusion, stateful, table_tiles, fold_tiles, sass, megastep),
on the
``windflow_tpu_torch`` package
under DIR (another checkout, e.g. a parent commit unpacked by ``git
archive``) instead of the one beside this script.

Prints one JSON object a line, then the card's name and power limit.
Needs CUDA; exits nonzero when ``torch.profiler`` records no device time.
"""

import argparse
import json
import subprocess
import sys
import time

from chip_smoke import (BATCHES, CAP, CHUNK_BYTES, COL_BATCHES, KEYS,
                        TBC_GAP, TBC_KEYS, TBC_WIN, TELE_KEYS, TELE_LATENESS,
                        TELE_WIN, _device_us, cuda_time, fail, fold_inputs,
                        frame_blob, frames_cb_graph, frames_reduce_graph,
                        keyed_frames_tb_graph, keyed_tb_graph,
                        main_path_data, main_path_graph, reduce_graph,
                        telemetry_data, ysb_data, ysb_frames,
                        ysb_frames_graph, ysb_graph)



def _unfused(g):
    """Time the Map|Filter chain and the tail's step apart: build the
    graph without whole-chain fusion, so the tail's step is its own."""
    g.config.whole_chain_fusion = False

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
        _unfused(g)
        g._build()               # config, device and replicas, as run() does
        chain, w = pipe.operators[1], pipe.operators[2]
        mid = chain._step(staged)
        for _ in range(4):    # state + first-use build; then every
            w._step(mid)      # further step fires ~2 windows a key
        state0 = {k: v.clone() if hasattr(v, "clone") else v
                  for k, v in w._states[0].items()}
        out["chain_ms"] = cuda_time(lambda: chain._step(staged))

        def ffat_step():
            w._states[0] = dict(state0)
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
        _unfused(g)
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


def _tb_cases(n):
    """(label, graph builder, records of the first ``n`` tuples) of the
    four time-window runs of chip_smoke.py phase 4."""
    import numpy as np
    nn = CAP * BATCHES
    table, ad, etype, ts_a = ysb_data(nn)
    tk, tv, tts = telemetry_data(nn)
    rng = np.random.default_rng(6)
    ck = rng.integers(0, TBC_KEYS, nn).astype(np.int32)
    cv = rng.integers(-100, 101, nn).astype(np.float32)
    cts = np.arange(nn, dtype=np.int64) * TBC_GAP
    ysb_items = [{"ad_id": a, "etype": e, "ts": t} for a, e, t in
                 zip(ad[:n], etype[:n], ts_a[:n].tolist())]

    def kv(keys, vals, ts):
        return [{"key": k, "v0": v, "ts": t} for k, v, t in
                zip(keys[:n], vals[:n], ts[:n].tolist())]
    return [
        ("a_ysb_generic", lambda f: ysb_graph("cuda", False, table, ad,
                                               etype, ts_a, f), ysb_items),
        ("a_ysb_sum", lambda f: ysb_graph("cuda", True, table, ad, etype,
                                          ts_a, f), ysb_items),
        ("b_telemetry", lambda f: keyed_tb_graph(
            "cuda", "telemetry", tk, tv, tts, TELE_KEYS, TELE_WIN, f,
            lateness=TELE_LATENESS, normalize=True), kv(tk, tv, tts)),
        ("c_grouping_kernel", lambda f: keyed_tb_graph(
            "cuda", "tbc", ck, cv, cts, TBC_KEYS, TBC_WIN, f),
         kv(ck, cv, cts)),
    ]


def tb_phase(dev):
    """Per batch of each time-window run: host emit + staging, the chain
    and TB step (wall and device), egress of one output batch; then the
    device idle share of the whole run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.batch import device_to_columns
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    from windflow_tpu_torch.utils.tree import tree_map
    warm = 4
    for label, build, items in _tb_cases(CAP * (warm + 1)):
        g, win = build(lambda c: None)
        _unfused(g)
        g._build()              # config, device and replicas, as run() does
        chain = g.pipes[0].operators[1:-2]
        staged = []

        class Inbox:
            def receive(self, ch, msg):
                staged.append(msg)
        em = DeviceStageEmitter([(Inbox(), 0)], CAP, dev)
        t0 = time.perf_counter()
        wm = -1
        for it in items[:CAP]:
            wm = max(wm, it["ts"])
            em.emit(it, it["ts"], wm)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        for it in items[CAP:]:
            wm = max(wm, it["ts"])
            em.emit(it, it["ts"], wm)
        mids = []
        for b in staged:
            for op in chain:
                b = op._step(b)
            mids.append(b)
        for b in mids[:warm]:       # ring sizing, kernel build, steady ring
            win._step(b)
        torch.cuda.synchronize()
        state0 = tree_map(lambda t: t.clone(), win._states[0])
        step_in = mids[warm]

        def tb_step():
            win._states[0] = tree_map(lambda t: t.clone(), state0)
            win._overflow_steps = 1          # keep off the checkpoint
            return win._step(step_in)
        chain_ms = cuda_time(lambda: [op._step(staged[warm])
                                      for op in chain]) if chain else 0.0
        walls = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tb_step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        cols, _ = device_to_columns(out)
        egress_s = time.perf_counter() - t0
        emit(phase="tb", run=label, capacity=CAP, ring_np=win.NP,
             out_lanes=int(out.valid.shape[0]),
             windows_per_batch=int(len(cols["key"])), host_emit_stage_s=host_s,
             chain_ms=chain_ms, step_wall_ms=1e3 * sum(walls) / len(walls),
             step_profile=profile_step(tb_step), egress_s=egress_s,
             note="host clock: emit+stage one batch, step wall (mean of 10, "
                  "state restored each time), egress; device: profiler")
        n = [0]
        g, _ = build(lambda c: n.__setitem__(0, n[0] + len(c))
                     if c is not None else None)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy_us = sum(_device_us(e) for e in prof.key_averages())
        if busy_us <= 0:
            fail(f"torch.profiler recorded no device time for TB {label}")
        emit(phase="tb_run", run=label, tuples=CAP * BATCHES, records=n[0],
             wall_s=wall, device_busy_s=busy_us / 1e6,
             device_idle_share=1 - busy_us / 1e6 / wall)


class _Inbox:
    """A destination that keeps what an emitter sends."""

    def __init__(self):
        self.got = []

    def receive(self, ch, msg):
        self.got.append(msg)


def _whole_run(build):
    """Two ``run()``s of fresh graphs from ``build()``: the first on the
    host clock alone (wall, tuples/s), the second under
    ``torch.profiler`` (device busy time over that run's wall: the idle
    share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = CAP * COL_BATCHES
    g = build()
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g = build()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = sum(_device_us(e) for e in prof.key_averages()) / 1e6
    if busy <= 0:
        fail("torch.profiler recorded no device time for PipeGraph.run()")
    return {"wall_s": wall, "tuples_per_s": n / wall,
            "profiled_wall_s": pwall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / pwall}


def _columnar_host_split(dev, blob, policy, batches=2):
    """Host seconds per batch of the columnar path, the mean over
    ``batches`` batches of frames after one warm-up batch (the staging
    pool's first pinned allocations and the first pinned copy): parse
    (the replica's ``_ingest`` into a recording emitter), pack
    (``emit_columns`` into an open builder) and copy (finalize: the
    non-blocking copy, then a synchronise)."""
    import torch
    from windflow_tpu_torch.io import FrameSource
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter

    class Record:
        def __init__(self):
            self.blocks = []

        def emit_columns(self, cols, tss, wm, row_wms=None):
            self.blocks.append((cols, tss, wm, row_wms))
    src = FrameSource(lambda: iter(()), nv=1, output_batch_size=CAP)
    rep = src.replica_class(src, 0)
    rep.time_policy = policy
    rec = Record()
    rep.emitter = rec
    per = CAP * 24
    split = {"parse_s": 0.0, "pack_s": 0.0, "copy_s": 0.0}
    for b in range(batches + 1):
        chunk = blob[b * per:(b + 1) * per]
        rec.blocks = []
        t = [time.perf_counter()]
        for lo in range(0, len(chunk), CHUNK_BYTES):
            rep._ingest(chunk[lo:lo + CHUNK_BYTES])
        t.append(time.perf_counter())
        # one lane of room more than the batch: the pack does not ship
        em = DeviceStageEmitter([(_Inbox(), 0)], CAP + 1, dev)
        for cols, tss, wm, row_wms in rec.blocks:
            em.emit_columns(cols, tss, wm, row_wms=row_wms)
        t.append(time.perf_counter())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        em.flush(rec.blocks[-1][2])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        if b:
            split["parse_s"] += t[1] - t[0]
            split["pack_s"] += t[2] - t[1]
            split["copy_s"] += t[4] - t[3]
    return {k: v / batches for k, v in split.items()}


def _step_split(chain, win, staged_batches, warm):
    """Chain and window step of one batch after ``warm`` steps: wall on
    the host clock (mean of 10, state restored each time), device time
    and launches (``profile_step``); and the egress of its output."""
    import torch
    from windflow_tpu_torch.batch import device_to_columns
    from windflow_tpu_torch.utils.tree import tree_map
    mids = []
    for b in staged_batches:
        for op in chain:
            b = op._step(b)
        mids.append(b)
    for b in mids[:warm]:
        win._step(b)
    torch.cuda.synchronize()
    state0 = tree_map(lambda t: t.clone(), win._states[0])
    step_in = mids[warm]

    def step():
        win._states[0] = tree_map(lambda t: t.clone(), state0)
        win._overflow_steps = 1          # keep off the TB checkpoint
        return win._step(step_in)
    chain_ms = cuda_time(lambda: [op._step(staged_batches[warm])
                                  for op in chain]) if chain else 0.0
    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    cols, _ = device_to_columns(out)
    egress = time.perf_counter() - t0
    return {"chain_ms": chain_ms, "step_wall_ms": 1e3 * sum(walls) / 10,
            "step_profile": profile_step(step), "egress_s": egress,
            "out_records": int(len(cols["key"]))}


def _record_emit_s(dev, items, tss):
    """Host seconds of one batch of records through the staging emitter
    (one ``emit`` a record, the packed copy and a synchronise)."""
    import torch
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
    t0 = time.perf_counter()
    for it, t in zip(items, tss):
        em.emit(it, t, t)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def columnar_phase(dev):
    """The columnar runs (i) and (ii) beside the record path on the same
    records (see the module docstring)."""
    import numpy as np
    from windflow_tpu_torch.basic import TimePolicy
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    n = CAP * COL_BATCHES
    warm = 4
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    k32 = keys.astype(np.int32)
    for sum_combiner in (False, True):
        label = "i_frames_" + ("sum" if sum_combiner else "generic")
        split = _columnar_host_split(dev, blob, TimePolicy.INGRESS)
        g, _ = frames_cb_graph("cuda", sum_combiner, blob, lambda c: None)
        _unfused(g)
        g._build()
        chain, win = g.pipes[0].operators[1:-2], g.pipes[0].operators[-2]
        em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
        for b in range(warm + 1):
            sl = slice(b * CAP, (b + 1) * CAP)
            em.emit_columns({"key": k32[sl], "v0": vals[sl]},
                            np.arange(b * CAP, (b + 1) * CAP), b * CAP)
        steps = _step_split(chain, win, em.dests[0][0].got, warm)
        whole = _whole_run(lambda: frames_cb_graph(
            "cuda", sum_combiner, blob, lambda c: None)[0])
        emit(phase="columnar", run=label, capacity=CAP, batches=COL_BATCHES,
             host_per_batch=split, **steps, whole_run=whole)
        items = [{"key": k, "v0": v} for k, v in zip(k32[:CAP], vals[:CAP])]
        rec = {"host_emit_stage_s": _record_emit_s(dev, items,
                                                   list(range(CAP)))}
        rec["whole_run"] = _whole_run(lambda: main_path_graph(
            "cuda", sum_combiner, k32, vals, lambda t: None)[0])
        emit(phase="columnar_record_path", run=label, **rec)
    table, ad, ts, etype = ysb_frames(n)
    blob = frame_blob(ad, ts, etype.astype(np.float64))
    split = _columnar_host_split(dev, blob, TimePolicy.EVENT)
    g, _, win = ysb_frames_graph("cuda", table, blob, lambda c: None)
    _unfused(g)
    g._build()
    chain = g.pipes[0].operators[1:-2]
    em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
    ad32 = ad.astype(np.int32)
    ev = etype.astype(np.float32)
    for b in range(warm + 1):
        sl = slice(b * CAP, (b + 1) * CAP)
        em.emit_columns({"key": ad32[sl], "v0": ev[sl]}, ts[sl],
                        int(ts[sl][-1]))
    steps = _step_split(chain, win, em.dests[0][0].got, warm)
    whole = _whole_run(lambda: ysb_frames_graph(
        "cuda", table, blob, lambda c: None)[0])
    emit(phase="columnar", run="ii_ysb_frames_sum", capacity=CAP,
         batches=COL_BATCHES, ring_np=win.NP, host_per_batch=split, **steps,
         whole_run=whole)
    items = [{"ad_id": a, "etype": e, "ts": t}
             for a, e, t in zip(ad32[:CAP], etype[:CAP].astype(np.int32),
                                ts[:CAP].tolist())]
    rec = {"host_emit_stage_s": _record_emit_s(dev, items,
                                               ts[:CAP].tolist())}
    rec["whole_run"] = _whole_run(lambda: ysb_graph(
        "cuda", True, table, ad32, etype.astype(np.int32), ts,
        lambda c: None)[0])
    emit(phase="columnar_record_path", run="ii_ysb_frames_sum", **rec)
    # the YSB lift is an integer count (atomics); the ordered f32 sum of
    # the TB step: chip_smoke's float TB graph (100 keys, 10 s windows)
    fk = rng.integers(0, 100, n)
    fv = rng.standard_normal(n).astype(np.float32)
    fts = np.arange(n, dtype=np.int64) * 152
    g = keyed_frames_tb_graph("cuda", frame_blob(fk, fts, fv),
                              lambda c: None)
    _unfused(g)
    g._build()
    win = g.pipes[0].operators[-2]
    em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
    for b in range(warm + 1):
        sl = slice(b * CAP, (b + 1) * CAP)
        em.emit_columns({"key": fk[sl].astype(np.int32), "v0": fv[sl]},
                        fts[sl], int(fts[sl][-1]))
    steps = _step_split([], win, em.dests[0][0].got, warm)
    emit(phase="columnar", run="tb_f32_sum_step", capacity=CAP,
         ring_np=win.NP, **steps)


def _fusion_graph(kind, fuse, blobs, dev_name):
    """One graph of ``chip_smoke.py`` phase 6 (a), built with
    ``.add(map).add(filter)``, fused or not; returns ``(graph, [the two
    chain operators, the tail])``."""
    blob_i, blob_ii, table = blobs
    if kind.startswith("cb"):
        g, _ = frames_cb_graph(dev_name, kind == "cb_sum", blob_i,
                               lambda c: None, chain=False, fuse=fuse)
    elif kind == "ysb_sum":
        g = ysb_frames_graph(dev_name, table, blob_ii, lambda c: None,
                             chain=False, fuse=fuse)[0]
    else:
        return frames_reduce_graph(dev_name, blob_i, lambda c: None, fuse)
    return g, g.pipes[0].operators[1:4]


def _fusion_hop(ops, fuse, staged, warm):
    """The hop's device work on ``staged[warm]`` after ``warm`` steps, as
    the graph runs it: unfused, the chain's steps then the tail's; fused,
    the tail's step alone (the prelude inside).  Returns ``{"step": fn}``;
    ``fn`` restores the window state first."""
    import torch
    from windflow_tpu_torch.utils.tree import tree_map
    chain, tail = ([] if fuse else ops[:2]), ops[2]

    def hop(b):
        for op in chain:
            b = op._step(b)
        return tail._step(b)
    for b in staged[:warm]:
        hop(b)
    torch.cuda.synchronize()
    state0 = tree_map(lambda t: t.clone(), tail._states[0]) \
        if hasattr(tail, "_states") else None

    def step():
        if state0 is not None:
            tail._states[0] = tree_map(lambda t: t.clone(), state0)
            tail._overflow_steps = 1     # keep off the TB checkpoint
        return hop(staged[warm])
    return {"step": step}


def _mean_wall_ms(fn, iters=10):
    """Mean host-clock ms of ``fn`` between two synchronises."""
    import torch
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return 1e3 * sum(walls) / len(walls)


def fusion_phase(dev):
    """Fused against unfused hops (``Config.whole_chain_fusion``) on the
    four graphs of ``chip_smoke.py`` phase 6 (a): on the same staged
    batch, after ``warm`` steps, the hop's device work as the graph runs
    it — unfused, the Map step, the Filter step and the tail's step;
    fused, the tail's step with the prelude inside — wall on the host
    clock around it with a synchronise (mean of 10, state restored,
    taken in the order unfused, fused, fused, unfused), and device time
    and launches by ``torch.profiler``; then whole ``PipeGraph.run()``s
    of 16 batches in the same order: tuples/s on the host clock."""
    import numpy as np
    import torch
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    n = CAP * COL_BATCHES
    warm = 4
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    table, ad, ts_y, etype = ysb_frames(n)
    blobs = (frame_blob(keys, np.arange(n), vals),
             frame_blob(ad, ts_y, etype.astype(np.float64)), table)
    for kind in ("cb_generic", "cb_sum", "ysb_sum", "reduce_max"):
        if kind == "ysb_sum":
            cols = {"key": ad.astype(np.int32),
                    "v0": etype.astype(np.float32)}
            ts = ts_y
        else:
            cols = {"key": keys.astype(np.int32), "v0": vals}
            ts = np.arange(n, dtype=np.int64)
        em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
        for b in range(warm + 1):
            sl = slice(b * CAP, (b + 1) * CAP)
            em.emit_columns({k: v[sl] for k, v in cols.items()}, ts[sl],
                            int(ts[sl][-1]))
        staged = em.dests[0][0].got
        hops = {}
        for fuse in (False, True):
            g, ops = _fusion_graph(kind, fuse, blobs, dev.type)
            g._build()
            hops[fuse] = _fusion_hop(ops, fuse, staged, warm)
            hops[fuse]["segments"] = [sg["name"]
                                      for sg in g._fused_segments]
        walls = {False: [], True: []}
        for fuse in (False, True, True, False):
            walls[fuse].append(_mean_wall_ms(hops[fuse]["step"]))
        out = {("fused" if fuse else "unfused"): {
            "segments": h["segments"], "hop_wall_ms": walls[fuse],
            "hop_profile": profile_step(h["step"])}
            for fuse, h in hops.items()}
        whole = []
        for fuse in (False, True, True, False):
            g, _ = _fusion_graph(kind, fuse, blobs, dev.type)
            t0 = time.perf_counter()
            g.run()
            torch.cuda.synchronize()
            whole.append({"fused": fuse,
                          "tuples_per_s": n / (time.perf_counter() - t0)})
        emit(phase="fusion", run=kind, capacity=CAP, batches=COL_BATCHES,
             whole_runs=whole, **out)


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


def fold_tile_phase(dev):
    """The fold kernel's device time per call at the two masks of
    chip_smoke's phase 2, for each run length the module offers (a
    checkout without ``FOLD_RUN`` is timed at its one design)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    default = getattr(fc, "FOLD_RUN", None)
    runs = (4, 8, 16) if default is not None else (None,)
    out = {}
    try:
        for pattern in ("dense", "main"):
            x, valid, R = fold_inputs(dev, np.random.default_rng(11), pattern)
            for run in runs:
                if run is not None:
                    fc.FOLD_RUN = run
                fc.sliding_fold(x, valid, R, "sum")
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fc.sliding_fold(x, valid, R, "sum")
                    torch.cuda.synchronize()
                us = sum(_device_us(e) for e in prof.key_averages()
                         if e.device_type.name == "CUDA") / 20
                if us <= 0:
                    fail("torch.profiler recorded no device time for the fold")
                out[f"{pattern}_run{run or 'fixed'}_us"] = us
    finally:
        if default is not None:
            fc.FOLD_RUN = default
    emit(phase="fold_tiles", default_run=default, **out)


def sass_phase():
    """Atomic opcodes in the SASS of each built kernel library, counted
    per kernel, and the global load/store opcodes of the fold library's
    R = 8 sum kernels (``cuobjdump`` from the toolkit that built them)."""
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
        memops = collections.Counter()
        kernel = None
        for line in r.stdout.splitlines():
            if "Function :" in line:
                kernel = line.split("Function :")[1].strip()
            elif "*/" in line:
                words = line.split("*/", 1)[1].split()
                if words and words[0].startswith("@"):
                    words = words[1:]
                op = words[0] if words else ""
                if op.startswith(("ATOM", "RED")):
                    ops[f"{kernel} {op}"] += 1
                # the sum kernels of the main path's R = 8 (both paths)
                if op.startswith(("LDG", "STG")) and kernel and (
                        "fold_runs_kernelILi0ELi8E" in kernel
                        or "fold_rows_smem_kernelILi0E" in kernel):
                    memops[f"{kernel} {op}"] += 1
        extra = {"global_load_store_opcodes": dict(memops)} if memops else {}
        emit(phase="sass", library=name, atomic_opcodes=dict(ops), **extra)


def _stage(dev, cols, n_batches):
    """``n_batches`` batches of ``cols`` staged by a DeviceStageEmitter."""
    import numpy as np
    from windflow_tpu_torch.parallel.emitters import DeviceStageEmitter
    em = DeviceStageEmitter([(_Inbox(), 0)], CAP, dev)
    for b in range(n_batches):
        sl = slice(b * CAP, (b + 1) * CAP)
        ts = np.arange(b * CAP, (b + 1) * CAP, dtype=np.int64)
        em.emit_columns({k: v[sl] for k, v in cols.items()}, ts,
                        int(ts[-1]))
    return em.dests[0][0].got


def _stateful_case(op, batches, warm):
    """``op``'s step on ``batches[warm]`` after ``warm`` steps, its state
    (and compaction stats) restored before every call: wall (mean of 10,
    synchronised), device time and launches by ``torch.profiler``."""
    import torch
    from windflow_tpu_torch.utils.tree import tree_map
    for b in batches[:warm]:
        op._step(b)
    torch.cuda.synchronize()
    saved = {a: tree_map(lambda t: t.clone(), getattr(op, a))
             for a in ("_state", "_cstats") if getattr(op, a, None)
             is not None}

    def step():
        for a, v in saved.items():
            setattr(op, a, tree_map(lambda t: t.clone(), v))
        return op._step(batches[warm])
    return {"step_wall_ms": _mean_wall_ms(step),
            "step_profile": profile_step(step)}


def stateful_phase(dev):
    """The stateful steps and the compacted reduce of ``chip_smoke.py``
    phase 7 on staged batches of its data (262,144 tuples, after 4 warm
    steps): (a) the dense fraud scorer (the wavefront; its depth, and the
    device time of its slot grouping ``auto_order`` alone on the same
    slots, as a share of the step's); (c) the associative running count
    and sum on the uniform and the Zipf stream; (b) the scorer over
    arbitrary card ids, compacted (keys admitted first) and interned;
    (d) the unbounded compacted reduce (max).  Wall on the host clock
    around a synchronised step (mean of 10), device time and launches by
    ``torch.profiler``."""
    import numpy as np
    import torch
    from chip_smoke import (FRAUD_CARDS, assoc_graph, fraud_data,
                            fraud_graph, kc_reduce_graph, zipf_draws,
                            zipf_shift_keys)
    from windflow_tpu_torch.ops.gpu_stateful import _sort_by_slot
    warm = 4
    n = CAP * (warm + 1)
    rng = np.random.default_rng(2026)
    table, cards, etype, card_ids = fraud_data(rng, n)
    # (a): the scorer behind the cast map, unfused
    g, scorer = fraud_graph(dev.type, b"", table, lambda c: None,
                            fuse=False)
    g._build()
    cast = g.pipes[0].operators[1]
    staged = [cast._step(b) for b in _stage(
        dev, {"key": cards.astype(np.int32),
              "v0": etype.astype(np.float32)}, warm + 1)]
    res = _stateful_case(scorer, staged, warm)
    b = staged[warm]
    keys = b.payload["card"]
    valid = b.valid & (keys >= 0) & (keys < FRAUD_CARDS)
    res["wavefront_depth"] = scorer.last_depth
    res["auto_order"] = profile_step(
        lambda: _sort_by_slot(valid, keys, FRAUD_CARDS))
    res["auto_order_share"] = res["auto_order"]["device_us"] \
        / res["step_profile"]["device_us"]
    emit(phase="stateful", run="(a) fraud dense, wavefront", capacity=CAP,
         slots=FRAUD_CARDS, **res)
    # (c): the associative update, uniform and Zipf
    for dist in ("uniform", "zipf"):
        if dist == "uniform":
            keys = rng.integers(0, FRAUD_CARDS, n)
        else:
            keys = rng.permutation(FRAUD_CARDS)[
                zipf_draws(rng, n, FRAUD_CARDS)]
        g, op = assoc_graph(dev.type, b"", lambda c: None)
        g._build()
        batches = _stage(dev, {"key": keys.astype(np.int32),
                               "v0": rng.integers(0, 4, n)
                               .astype(np.float32)}, warm + 1)
        hot = int(np.bincount(keys[warm * CAP:], minlength=1).max())
        emit(phase="stateful", run=f"(c) assoc {dist}", capacity=CAP,
             slots=FRAUD_CARDS, hottest_key_lanes=hot,
             **_stateful_case(op, batches, warm))
    # (b): arbitrary card ids, compacted and interned
    cols = {"key": card_ids, "v0": etype.astype(np.float32)}
    for kc in (True, False):
        g, scorer = fraud_graph(dev.type, b"", table, lambda c: None,
                                dense=False, key_compaction=kc)
        g._build()
        if kc:
            scorer._compactor.observe(card_ids)
        emit(phase="stateful",
             run=f"(b) fraud ids, {'compacted' if kc else 'interned'}",
             capacity=CAP, slots=FRAUD_CARDS,
             **_stateful_case(scorer, _stage(dev, cols, warm + 1), warm))
    # (d): the unbounded compacted reduce
    keys = zipf_shift_keys(rng, n)
    g, red = kc_reduce_graph(dev.type, "max", b"", lambda c: None)
    g._build()
    red._compactor.observe(keys[:CAP])
    res = _stateful_case(red, _stage(
        dev, {"key": keys, "v0": rng.integers(-100, 101, n)
              .astype(np.float32)}, warm + 1), warm)
    emit(phase="stateful", run="(d) compacted reduce max", capacity=CAP,
         compactor=red._compactor.summary(), **res)


class _Drop:
    """A tail emitter that drops what it is handed (no sink work)."""

    def emit_device_batch(self, batch):
        pass

    def flush(self, wm):
        pass

    def propagate_punctuation(self, wm):
        pass


def _packets(cols_of, n_batches, pool, wire):
    """``n_batches`` finalized packets of ``cols_of(i) -> (cols, tss)``,
    packed (and wire-encoded when ``wire``) ahead of the timed window, as
    the staging emitter finalizes them; the host encode seconds; and the
    logical (unencoded) bytes of a batch."""
    import numpy as np
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.parallel.emitters import _StagedPacket
    from windflow_tpu_torch.utils.tree import tree_flatten
    from windflow_tpu_torch.wire import WireEncoder
    out, enc, enc_s = [], None, 0.0
    for i in range(n_batches):
        cols, tss = cols_of(i)
        leaves, treedef = tree_flatten(cols)
        dtypes = tuple(str(l.dtype) for l in leaves)
        b = staging.PackedBatchBuilder(dtypes, CAP, pool=pool)
        b.append(leaves, tss)
        buf = b.finish()
        logical = buf.nbytes
        fmt = None
        if wire:
            enc = enc or WireEncoder(dtypes, CAP)
            t0 = time.perf_counter()
            buf, fmt = enc.encode(buf, pool=pool)
            enc_s += time.perf_counter() - t0
        wm = int(tss[-1])
        out.append(_StagedPacket(buf, fmt, wm, wm, int(tss.min()),
                                 int(tss.max()), CAP, pool, treedef,
                                 dtypes, CAP))
    return out, enc_s, logical


def _launch_profile(fn, per):
    """``fn()`` under ``torch.profiler``: device µs, kernels run and
    launch calls made (kernel launches, graph launches, copies), each over
    ``per`` logical batches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and _device_us(e) > 0]
    api = {}
    for ev in prof.events():
        if ev.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cudaGraphLaunch", "cudaMemcpyAsync"):
            api[ev.name] = api.get(ev.name, 0) + 1
    if not kern:
        fail("torch.profiler recorded no device time for the megastep case")
    return {"device_us_a_batch": sum(_device_us(e) for e in kern) / per,
            "kernels_a_batch": sum(e.count for e in kern) / per,
            "launch_calls_a_batch": {k: v / per for k, v in api.items()}}


def _megastep_case(label, build, cols_of, k, dev, groups=3):
    """One tail at ``megastep_sweeps=k``, fed finalized packets directly:
    one warm-up batch, one group (the capture; at K = 1 eight batches),
    then ``groups`` timed groups of 8 logical batches.  Wall: host clock
    from the packets' hand-over (copy, unpack, step; at K = 8 the
    super-buffer stack, replay and clones) to a synchronise; then one
    more group under ``torch.profiler``."""
    import torch
    from windflow_tpu_torch import staging
    g, tail_op = build(megastep_sweeps=k, wire_compression=False)
    g._build()
    em = g._source_replicas[0].emitter
    rep = em.dests[0][0]
    rep.emitter = _Drop()
    edge = em._megastep
    if (edge is not None) != (k > 1):
        fail(f"{label} K={k}: megastep edge {edge}")
    total = 1 + 8 + 8 * (groups + 1)
    # room for every packet: a full pool would wait on each released
    # buffer's copy inside the timed window
    pool = staging.StagingPool(depth=total, max_bytes=1 << 31, pinned=True)
    pkts = _packets(cols_of, total, pool, wire=False)[0]

    def feed(batch_pkts):
        for p in batch_pkts:
            if edge is None or not edge.offer(p):
                em._ship_packed(p)
            rep.drain()
    feed(pkts[:9])
    torch.cuda.synchronize()
    walls = []
    for gi in range(groups):
        lo = 9 + 8 * gi
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed(pkts[lo:lo + 8])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / 8)
    lo = 9 + 8 * groups
    before = edge.megasteps if edge is not None else 0
    try:
        from windflow_tpu_torch.kernels.cond_cuda import standalone_replays
    except ImportError:     # a package from before the conditional nodes
        def standalone_replays():
            return 0
    regions0 = standalone_replays()
    prof = _launch_profile(lambda: feed(pkts[lo:lo + 8]), 8)
    # besides one a megastep, one a replay of a standalone
    # conditional-node graph (the TB fold's, three a per-batch step)
    regions = standalone_replays() - regions0
    graph_launches = 8 * prof["launch_calls_a_batch"].get(
        "cudaGraphLaunch", 0) - regions
    ran = (edge.megasteps if edge is not None else 0) - before
    if graph_launches != ran or ran != (1 if k > 1 else 0):
        fail(f"{label} K={k}: {graph_launches} cudaGraphLaunch for {ran} "
             "megasteps in the profiled group")
    out = {"case": label, "k": k, "wall_ms_a_batch":
           1e3 * sum(walls) / len(walls),
           "wall_ms_groups": [1e3 * w for w in walls], **prof}
    if edge is not None:
        out["megastep"] = edge.summary()
        if edge.megasteps != groups + 2:
            fail(f"{label} K={k}: {edge.megasteps} megasteps, "
                 f"{groups + 2} expected")
    return out


def megastep_phase(dev):
    """The megastep plane: CB generic (the frames count-window graph of
    phase 5 (i)) and TB generic (the YSB frames graph, generic combiner)
    steps at K = 1 against K = 8 a logical batch — wall, device time,
    kernels and launch calls; then the eager unpack's launches with the
    wire off and on, and the host encode a batch."""
    import numpy as np
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.batch import stage_packed
    rng = np.random.default_rng(2031)
    n_max = CAP * 48
    keys = rng.integers(0, KEYS, n_max).astype(np.int32)
    vals = rng.integers(-100, 101, n_max).astype(np.float32)
    table, ad, ts_y, etype = ysb_frames(n_max)

    def cb_cols(i):
        sl = slice(i * CAP, (i + 1) * CAP)
        return ({"key": keys[sl], "v0": vals[sl]},
                np.arange(i * CAP, (i + 1) * CAP, dtype=np.int64))

    def ysb_cols(i):
        sl = slice(i * CAP, (i + 1) * CAP)
        return ({"key": ad[sl].astype(np.int32),
                 "v0": etype[sl].astype(np.float32)}, ts_y[sl])

    def cb_build(**cfg):
        g, _ = frames_cb_graph("cuda", False, b"", lambda c: None,
                               event=True, **cfg)
        return g, g.pipes[0].operators[-2]

    def ysb_build(**cfg):
        g, _, win = ysb_frames_graph("cuda", table, b"", lambda c: None,
                                     sum_combiner=False, **cfg)
        return g, win

    for label, build, cols_of in (("CB generic", cb_build, cb_cols),
                                  ("TB generic", ysb_build, ysb_cols)):
        rows = [_megastep_case(label, build, cols_of, k, dev)
                for k in (1, 8)]
        for r in rows:
            emit(phase="megastep", **r)
        emit(phase="megastep", case=label, wall_k1_over_k8=
             rows[0]["wall_ms_a_batch"] / rows[1]["wall_ms_a_batch"])
    # the eager unpack with the wire off and on (the decode's own ops)
    pool = staging.StagingPool(depth=8, pinned=True)
    for label, cols_of in (("CB frames", cb_cols), ("YSB frames", ysb_cols)):
        for wire in (False, True):
            pkts, enc_s, logical = _packets(cols_of, 3, pool, wire)

            def unpack(p=pkts[2]):
                stage_packed(p.buf, p.treedef, p.dtypes, CAP, p.n, dev,
                             pool=None, wire=p.fmt)
            unpack(pkts[1])             # warm
            prof = _launch_profile(unpack, 1)
            emit(phase="megastep_unpack", case=label, wire=wire,
                 wire_bytes_a_tuple=pkts[2].buf.nbytes / CAP,
                 logical_bytes_a_tuple=logical / CAP,
                 fmt=None if pkts[2].fmt is None else
                 [tuple(c) for c in pkts[2].fmt.codecs],
                 encode_ms_a_batch=1e3 * enc_s / 3, **prof)


PHASES = ("host", "device", "reduce", "run", "tb", "columnar", "fusion",
          "stateful", "table_tiles", "fold_tiles", "sass", "megastep")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run")
    ap.add_argument("--package-root", default=None,
                    help="directory holding the windflow_tpu_torch to run")
    args = ap.parse_args()
    only = args.only.split(",")
    unknown = set(only) - set(PHASES)
    if unknown:
        fail(f"unknown phases {sorted(unknown)}")
    if args.package_root:
        sys.path.insert(0, args.package_root)
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    from windflow_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all()
    staged = None
    if {"host", "device", "reduce"} & set(only):
        staged = host_phase(dev)
    if "device" in only:
        device_phase(staged)
    if "reduce" in only:
        reduce_phase(staged)
    if "run" in only:
        run_phase()
    if "tb" in only:
        tb_phase(dev)
    if "columnar" in only:
        columnar_phase(dev)
    if "fusion" in only:
        fusion_phase(dev)
    if "stateful" in only:
        stateful_phase(dev)
    if "table_tiles" in only:
        table_tile_phase(dev)
    if "fold_tiles" in only:
        fold_tile_phase(dev)
    if "sass" in only:
        sass_phase()
    if "megastep" in only:
        megastep_phase(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
