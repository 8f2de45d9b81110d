#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each exits nonzero on failure; none is skipped):

1. build every CUDA kernel of the port from ``windflow_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain torch version on the card, at the
   main paths' shapes and at the edges (exact, except the dense table's
   f32 sums of non-integer data: rtol 1e-5 and identical bits from call
   to call), and time the kernel, the plain version and the PyTorch
   calls computing the same function (a yardstick only: the port never
   calls them): device time by ``torch.profiler`` (``device_ms``), with
   the CUDA-event time of back-to-back calls printed beside it.  The
   dense table is timed at each of the reduce routes' three calls, (a)
   compacted max, (b) compacted sum and (c) dense max, each a row of its
   own in the JSON line;
3. drive the main paths through ``PipeGraph.run()`` at the repo's chip
   configuration (262,144 tuples a batch, 1,024 keys), each with the
   launch counts set to 0 just before and read just after:
   * Source → MapGPU | FilterGPU → Ffat_WindowsGPU (count windows of
     1,024 sliding by 128, keyed) → Sink, 8 batches, once with the
     generic combiner and once with ``withSumCombiner()``; every fired
     window against a numpy oracle;
   * Source → MapGPU | FilterGPU → ReduceGPU (keyed, ``withMaxKeys
     (1024)``) → Sink (columnar), every batch's records against a numpy
     oracle of that batch: (a) declared ``max``, the bounded compacted
     route, 8 batches; (b) declared ``sum``, 8 batches; (c) declared
     ``max`` with ``Config(key_compaction=False)``, the dense route, 4
     batches; (d) undeclared ``max``, the sorted route (no kernel), 4
     batches; (e) 2 batches each with keys drawn from [0, 1040) and
     [0, 1100) on routes (a) and (c): the overflow lane, then the
     full-width one; (a) keeps the out-of-range keys, (c) drops and
     counts them.
   The paths run at full width; the reduce runs are cut in depth to the
   batches above so that the whole stays far inside the time limit.

Before the last line it prints the card's name and power limit and one
JSON line with every kernel's launches, error and times; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
package beside it, it exits nonzero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

#: the repo's chip configuration (bench.py CONFIGS["tpu"])
CAP, KEYS, WIN, SLIDE = 262144, 1024, 1024, 128
BATCHES = 8
#: H100 SXM memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM 32-bit rate outside the tensor cores, operations/s
OPS_PER_S = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_time(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0.0) if t is None else t


def device_ms(fn, iters=20):
    """Mean device milliseconds of ``fn()``: the kernel time that
    ``torch.profiler`` records over ``iters`` calls, gaps between
    kernels left out (CUDA events over back-to-back calls measure the
    host's issue rate instead wherever a call's Python and launch
    overhead exceeds its device work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    us = sum(_device_us(e) for e in evs if e.device_type.name == "CUDA")
    if us <= 0:
        fail("torch.profiler recorded no device time: "
             f"{[(e.key[:40], e.device_type.name) for e in evs][:20]}")
    return us / iters / 1e3


def timings(label, **fns):
    """Device ms of each named call (``device_ms``), with the CUDA-event
    ms of back-to-back calls printed beside them."""
    dev = {k: device_ms(fn) for k, fn in fns.items()}
    ev = {k: cuda_time(fn) for k, fn in fns.items()}
    print(f"{label}: " + ", ".join(
        f"{k} {dev[k]:.5f} ms device / {ev[k]:.5f} ms events"
        for k in fns))
    return dev


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_grouping(dev):
    """Grouping kernel vs its plain version: main shape + edges, exact.
    Edges: one id for every lane (the widest match-any group), NB = 4096,
    the gate's 2^22 lanes, B not a multiple of the 2,048-lane tile."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.grouping import invert_perm
    rng = np.random.default_rng(7)
    worst = 0
    # (lanes, buckets, the one id of every lane or None for random ids)
    cases = [(CAP, KEYS + 1, None), (1000, 2, None), (CAP + 77, 4096, None),
             (255, 4096, None), (257, 129, None), (CAP, KEYS + 1, 7),
             (4097, 2, 1), (4096, 4096, 4095), (1 << 22, KEYS + 1, None),
             (1 << 22, 4096, None), (4095, 4096, None), (1, 2, 0)]
    for B, NB, one in cases:
        ids = rng.integers(0, NB, B) if one is None else np.full(B, one)
        ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        got = fc.grouping_rank_hist(ids, NB)
        torch.cuda.synchronize()
        want = fc.grouping_rank_hist_plain(ids, NB)
        for name, g, w in zip(("dest", "rank", "hist"), got, want):
            worst = max(worst, (g.long() - w.long()).abs().max().item())
            if not torch.equal(g, w):
                fail(f"grouping_rank_hist {name} differs at B={B} NB={NB} "
                     f"one={one}")
        order = invert_perm(got[0])
        if not torch.equal(order.long(), torch.sort(ids, stable=True).indices):
            fail(f"order_hist is not the stable argsort at B={B} NB={NB}")
    ids = torch.from_numpy(
        rng.integers(0, KEYS + 1, CAP).astype(np.int32)).to(dev)
    NB = KEYS + 1
    t = timings(f"grouping_rank_hist at B={CAP} NB={NB}",
                kernel=lambda: fc.grouping_rank_hist(ids, NB),
                plain=lambda: fc.grouping_rank_hist_plain(ids, NB),
                library=lambda: (torch.sort(ids, stable=True),
                                 torch.bincount(ids, minlength=NB)))
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    # the function's own bytes and work, whatever the design: ids in,
    # dest and rank out, hist out; one count and one rank a lane
    b_ms, b_by = bound_ms(CAP * 4 + 2 * CAP * 4 + NB * 4, 2 * CAP)
    return [{"name": "grouping_rank_hist", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/grouping_rank_hist.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:214",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}]


def check_fold(dev):
    """Fold kernel vs its plain version on [1024, 2057], R = 8, every
    monoid × f32/i32, exact."""
    import torch
    import torch.nn.functional as F
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    rng = np.random.default_rng(11)
    P = int(np.gcd(WIN, SLIDE))
    R = WIN // P
    NPP = (R - 1) + CAP // P + 2
    valid = torch.from_numpy(rng.random((KEYS, NPP)) < 0.9).to(dev)
    worst = 0.0
    for dt in (torch.float32, torch.int32):
        if dt == torch.float32:
            x = torch.from_numpy(
                rng.standard_normal((KEYS, NPP)).astype(np.float32)).to(dev)
        else:
            x = torch.from_numpy(rng.integers(-1 << 20, 1 << 20, (KEYS, NPP))
                                 .astype(np.int32)).to(dev)
        for monoid in ("sum", "max", "min"):
            got = fc.sliding_fold(x, valid, R, monoid)
            torch.cuda.synchronize()
            want = fc.fold_leaf_plain(x, valid, R, monoid)
            err = (got.double() - want.double()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                fail(f"sliding_fold {monoid} {dt} differs (max {err})")
    # edges: R = 1, R not a power of two, ragged panes, few rows
    for (K, N, R_) in ((3, 300, 1), (5, 257, 13), (2, 4096 - 511, 512)):
        x = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) \
            .to(dev)
        v = torch.from_numpy(rng.random((K, N)) < 0.7).to(dev)
        for monoid in ("sum", "max", "min"):
            if not torch.equal(fc.sliding_fold(x, v, R_, monoid),
                               fc.fold_leaf_plain(x, v, R_, monoid)):
                fail(f"sliding_fold {monoid} differs at K={K} N={N} R={R_}")
    x = torch.from_numpy(
        rng.standard_normal((KEYS, NPP)).astype(np.float32)).to(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.ones((1, 1, R), dtype=torch.float32, device=dev)

    def conv_sum():
        xin = torch.where(valid, x, 0.0)[:, None, :]
        return F.conv1d(F.pad(xin, (R - 1, 0)), w)
    t = timings(f"sliding_fold sum at [{KEYS}, {NPP}] R={R}",
                kernel=lambda: fc.sliding_fold(x, valid, R, "sum"),
                plain=lambda: fc.fold_leaf_plain(x, valid, R, "sum"),
                library=conv_sum,
                max_pool1d=lambda: F.max_pool1d(
                    F.pad(torch.where(valid, x, float("-inf"))[:, None, :],
                          (R - 1, 0), value=float("-inf")), R, stride=1))
    ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
    if not torch.allclose(conv_sum()[:, 0], fc.sliding_fold(x, valid, R, "sum"),
                          rtol=1e-5, atol=1e-5):
        fail("conv1d yardstick disagrees with the fold")
    n = KEYS * NPP
    levels = R.bit_length()
    nops = n * (levels - 1 + bin(R).count("1") - 1)
    b_ms, b_by = bound_ms(n * 4 + n * 1 + n * 4, nops)
    return [{"name": "sliding_fold", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/sliding_fold.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:407",
             "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}]


def table_yardstick(row, leaves, ops, inits, S):
    """The PyTorch calls that compute the same tables as one
    ``dense_monoid_table`` call: per leaf one ``index_add_`` (sum) or
    ``scatter_reduce_`` (max/min) into an ``[S + 1]`` buffer whose last
    row takes the lanes outside ``[0, S)``.  Returns ``(run, bufs)``: the
    buffers start at the inits, and ``run()`` folds into them (max/min
    are idempotent; a repeated sum only changes the values)."""
    import torch
    idx = torch.where((row >= 0) & (row < S), row,
                      torch.full_like(row, S)).long()
    bufs, calls = [], []
    for l, op, init in zip(leaves, ops, inits):
        buf = torch.full((S + 1,) + tuple(l.shape[1:]), init, dtype=l.dtype,
                         device=l.device)
        bufs.append(buf)
        if op == "sum":
            calls.append(lambda b=buf, l=l: b.index_add_(0, idx, l))
        else:
            ix = idx.reshape((-1,) + (1,) * (l.ndim - 1)).expand(l.shape)
            calls.append(lambda b=buf, l=l, ix=ix, r="a" + op:
                         b.scatter_reduce_(0, ix, l, r, include_self=True))

    def run():
        for c in calls:
            c()
    return run, bufs


def check_table(dev):
    """Dense-table kernel vs its plain version: the reduce routes' three
    calls at the main shape (B = 262,144, S = 1,024), each timed beside
    its PyTorch yardstick and its bound; the edges of
    tests/test_pallas_kernels.py and of the kernel's design (every lane
    in one slot, S = 4096, the gate's 2^22 lanes, B not a multiple of
    the 2,048-lane tile), every op and dtype, rows outside [0, S).
    Exact, except f32 sums of non-integer data (rtol 1e-5 and the same
    bits on two calls)."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.kernels import reduce_cuda as rc
    from windflow_tpu_torch.parallel.compaction import _enc64
    rng = np.random.default_rng(13)
    I64MIN = -2 ** 63
    keys, vals = main_path_data(CAP, seed=13, key_range=KEYS + 16)
    vals = vals * np.float32(1.5) + np.float32(1.0)
    keep = (keys & 7) != 7
    ts = np.arange(CAP, dtype=np.int64) + 10 ** 15
    k_t, v_t, ts_t = (torch.from_numpy(a).to(dev) for a in (keys, vals, ts))
    hit = torch.from_numpy(keep & (keys < KEYS)).to(dev)
    row = torch.where(hit, k_t, torch.full_like(k_t, KEYS)).contiguous()
    carrier = torch.cat([_enc64(k_t)[:, None], _enc64(v_t)[:, None],
                         ts_t[:, None]], 1).contiguous()
    ok = torch.from_numpy(keep).to(dev)
    drow = torch.where(ok & (k_t < KEYS), k_t,
                       torch.full_like(k_t, KEYS)).contiguous()
    ones = torch.ones(CAP, dtype=torch.int32, device=dev)
    # the reduce routes' calls (half-integer values: every sum is exact)
    main_calls = {
        "a": ("compacted max (packed int64 carrier [B, 3])",
              (row, [carrier], ["max"], [I64MIN])),
        "b": ("compacted sum (key i32, v0 f32, ts i64 max)",
              (row, [k_t, v_t, ts_t], ["sum", "sum", "max"],
               [0, 0.0, I64MIN])),
        "c": ("dense max (key, v0, count, ts)",
              (drow, [k_t, v_t, ones, ts_t], ["max", "max", "sum", "max"],
               [-2 ** 31, float("-inf"), 0, -1])),
    }
    worst = 0
    out = []
    for tag, (name, args) in main_calls.items():
        got = rc.dense_monoid_table(*args, KEYS)
        torch.cuda.synchronize()
        want = rc.dense_monoid_table_plain(*args, KEYS)
        lib, bufs = table_yardstick(*args, KEYS)
        lib()
        for g, w, b in zip(got, want, bufs):
            worst = max(worst, (g.double() - w.double()).abs().max().item())
            if not torch.equal(g, w):
                fail(f"dense_monoid_table differs on {name}")
            if not torch.equal(g, b[:KEYS]):
                fail(f"the yardstick disagrees with the table on {name}")
        t = timings(f"dense_monoid_table ({tag}) {name} at B={CAP} S={KEYS}",
                    kernel=lambda: rc.dense_monoid_table(*args, KEYS),
                    plain=lambda: rc.dense_monoid_table_plain(*args, KEYS),
                    library=lib)
        r, leaves = args[0], args[1]
        nbytes = r.numel() * 4 + sum(
            l.numel() * l.element_size() + KEYS * (l.numel() // CAP)
            * l.element_size() for l in leaves)
        b_ms, b_by = bound_ms(nbytes, sum(l.numel() for l in leaves))
        out.append({"name": f"dense_monoid_table[{tag}]", "route": "cuda",
                    "source": "windflow_tpu_torch/csrc/dense_monoid_table.cu",
                    "replaces": "windflow_tpu/kernels/pallas_ffat.py:530",
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t["library"]})
    # (lanes, slots, the one slot of every lane or None for random rows)
    for B, S, one in ((64, 8, None), (300, 17, None), (100, 4096, None),
                      (5, 1, None), (262221, 4096, None), (CAP, KEYS, 5),
                      (4097, 4096, 4095), (1 << 22, KEYS, None),
                      (4095, 33, None)):
        r = rng.integers(-3, S + 3, B) if one is None else np.full(B, one)
        r = torch.from_numpy(r.astype(np.int32)).to(dev)
        leaves = [torch.from_numpy(a).to(dev) for a in (
            rng.integers(-2 ** 40, 2 ** 40, (B, 3)),
            rng.integers(-100, 100, B).astype(np.float32),
            rng.integers(-1000, 1000, (B, 8)).astype(np.int32),
            rng.random(B) < 0.3)]
        for op in ("sum", "max", "min"):
            inits = [fc.monoid_identity(op, l.dtype) for l in leaves]
            got = rc.dense_monoid_table(r, leaves, [op] * 4, inits, S)
            torch.cuda.synchronize()
            want = rc.dense_monoid_table_plain(r, leaves, [op] * 4, inits, S)
            for g, w in zip(got, want):
                worst = max(worst,
                            (g.double() - w.double()).abs().max().item())
                if not torch.equal(g, w):
                    fail(f"dense_monoid_table {op} differs at B={B} S={S} "
                         f"one={one}")
        # one f32-sum column of non-integer data: the same bits on two
        # calls, within rtol 1e-5 of the exact sum and of the plain
        # scatter-add (whose own f32 rounding is ~1e-5 where one slot
        # takes 262,144 lanes, so there only the exact sum)
        x = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32)) \
            .to(dev)
        a = rc.dense_monoid_table(r, [x], ["sum"], [0.0], S)[0]
        b = rc.dense_monoid_table(r, [x], ["sum"], [0.0], S)[0]
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail(f"dense_monoid_table f32 sum not deterministic at B={B}")
        exact = rc.dense_monoid_table_plain(r, [x.double()], ["sum"], [0.0],
                                            S)[0]
        if not torch.allclose(a.double(), exact, rtol=1e-5, atol=0):
            fail(f"dense_monoid_table f32 sum beyond rtol 1e-5 of the exact "
                 f"sum at B={B} S={S}")
        if one is None and not torch.allclose(a, rc.dense_monoid_table_plain(
                r, [x], ["sum"], [0.0], S)[0], rtol=1e-5, atol=0):
            fail(f"dense_monoid_table f32 sum beyond rtol 1e-5 at B={B}")
    for row_ in out:
        row_["max_abs_err"] = worst
    return out


def oracle(keys, vals):
    """{(key, wid): sum} over every CB window with data, partial windows
    flushed at EOS included; float64 (exact for the half-integer data)."""
    out = {}
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order].astype(np.float64)
    bounds = np.flatnonzero(np.diff(ks)) + 1
    for seg_k, seg_v in zip(np.split(ks, bounds), np.split(vs, bounds)):
        if not len(seg_k):
            continue
        cs = np.concatenate([[0.0], np.cumsum(seg_v)])
        n = len(seg_v)
        starts = np.arange(0, n, SLIDE)
        ends = np.minimum(starts + WIN, n)
        sums = cs[ends] - cs[starts]
        for w, s in enumerate(sums):
            out[(int(seg_k[0]), w)] = s
    return out


def main_path_data(n, seed=2024, key_range=KEYS):
    """``n`` records of the main path: int32 keys in [0, key_range) and
    integer-valued float32 values (every window sum is exact)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_range, n).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    return keys, vals


def main_path_graph(dev_name, sum_combiner, keys, vals, sink_fn):
    """The main path as a user builds it: Source → MapGPU | FilterGPU
    (chained) → Ffat_WindowsGPU (count windows, keyed) → Sink over the
    records ``keys``/``vals``.  Returns ``(graph, pipe)``; the pipe's
    operators are [source, map|filter chain, windows, sink]."""
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))

    src = wf.Source_Builder(gen).withOutputBatchSize(CAP).build()
    m = wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build()
    f = wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build()
    wb = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    snk = wf.Sink_Builder(sink_fn).build()
    g = wf.PipeGraph("chip_smoke", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(src)
    pipe.add(m)
    pipe.chain(f)
    pipe.add(wb.build()).add_sink(snk)
    return g, pipe


def run_main_path(dev_name, sum_combiner):
    """One PipeGraph.run() of the main path; returns (records, seconds,
    tuples)."""
    n = CAP * BATCHES
    keys, vals = main_path_data(n)
    rows = []
    g, _ = main_path_graph(dev_name, sum_combiner, keys, vals,
                           lambda t: rows.append(t) if t is not None else None)
    t0 = time.perf_counter()
    g.run()
    import torch
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keep = (keys & 7) != 7
    want = oracle(keys[keep], vals[keep] * np.float32(1.5) + np.float32(1.0))
    got = {(r["key"], r["wid"]): r["value"] for r in rows}
    if len(got) != len(rows):
        fail("duplicate (key, wid) records")
    if set(got) != set(want):
        fail(f"fired windows differ: {len(got)} got, {len(want)} expected")
    bad = [k for k in want if got[k] != want[k]]
    if bad:
        fail(f"{len(bad)} window sums differ, e.g. {bad[0]}: "
             f"{got[bad[0]]} vs {want[bad[0]]}")
    if not all(np.isfinite(v) for v in got.values()):
        fail("non-finite window values")
    return len(rows), secs, n


def reduce_graph(dev_name, monoid, declare, key_compaction, keys, vals,
                 sink_fn):
    """The reduce path as a user builds it: Source → MapGPU | FilterGPU
    (chained) → ReduceGPU (keyed by ``key``, ``withMaxKeys(KEYS)``, the
    leafwise ``monoid`` combiner, declared when ``declare``) → columnar
    Sink.  Returns ``(graph, reduce operator)``."""
    import torch
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v} for k, v in zip(keys, vals))

    op = {"max": torch.maximum, "sum": torch.add}[monoid]
    rb = (wf.ReduceGPU_Builder(lambda a, b: {"key": op(a["key"], b["key"]),
                                             "v0": op(a["v0"], b["v0"])})
          .withKeyBy(lambda t: t["key"]).withMaxKeys(KEYS))
    if declare:
        rb = rb.withMonoidCombiner(monoid)
    red = rb.build()
    g = wf.PipeGraph("chip_smoke_reduce", wf.ExecutionMode.DEFAULT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12,
                                      key_compaction=key_compaction))
    pipe = g.add_source(wf.Source_Builder(gen).withOutputBatchSize(CAP)
                        .build())
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    pipe.add(red).add_sink(wf.Sink_Builder(sink_fn)
                           .withColumnarSink().build())
    return g, red


def reduce_oracle(keys, vals, monoid, max_keys=None):
    """One batch's records, ascending keys: ``(key field, v0)`` after the
    map and filter; ``max_keys`` drops keys outside [0, max_keys)."""
    v = vals * np.float32(1.5) + np.float32(1.0)
    keep = (keys & 7) != 7
    if max_keys is not None:
        keep &= (keys >= 0) & (keys < max_keys)
    uk, inv = np.unique(keys[keep], return_inverse=True)
    if monoid == "max":
        out = np.full(len(uk), -np.inf, np.float32)
        np.maximum.at(out, inv, v[keep])
        return uk.astype(np.int32), out
    sums = np.zeros(len(uk), np.float64)
    np.add.at(sums, inv, v[keep].astype(np.float64))
    counts = np.bincount(inv, minlength=len(uk))
    return (uk.astype(np.int64) * counts).astype(np.int32), \
        sums.astype(np.float32)


def run_reduce(dev_name, monoid, declare, key_compaction, batches,
               key_range=KEYS, seed=4048):
    """One PipeGraph.run() of the reduce path; every batch's records
    against the oracle.  Returns (records, seconds, tuples, stats)."""
    import torch
    n = CAP * batches
    keys, vals = main_path_data(n, seed=seed, key_range=key_range)
    got = []
    g, red = reduce_graph(dev_name, monoid, declare, key_compaction, keys,
                          vals, lambda c: got.append(c) if c is not None
                          else None)
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    dense = declare and not key_compaction
    if len(got) != batches:
        fail(f"reduce: {len(got)} sink batches for {batches} batches")
    nrec = 0
    for i, c in enumerate(got):
        sl = slice(i * CAP, (i + 1) * CAP)
        wk, wv = reduce_oracle(keys[sl], vals[sl], monoid,
                               KEYS if dense else None)
        gk, gv = np.asarray(c.cols["key"]), np.asarray(c.cols["v0"])
        if not (np.array_equal(gk, wk) and np.array_equal(gv, wv)):
            fail(f"reduce {monoid} (declared={declare}, compaction="
                 f"{key_compaction}, keys < {key_range}) batch {i}: "
                 f"{len(gk)} records vs {len(wk)} expected, or values "
                 "differ")
        if not np.isfinite(gv).all():
            fail("non-finite reduce values")
        nrec += len(gk)
    keep = (keys & 7) != 7
    n_oor = int((keep & (keys >= KEYS)).sum())
    st = red.dump_stats()
    if dense:
        if st.get("Out_of_range_keys_dropped", 0) != n_oor:
            fail(f"dense route counted {st.get('Out_of_range_keys_dropped')}"
                 f" dropped tuples, {n_oor} expected")
    elif declare:
        if st.get("Out_of_range_keys_rerouted", 0) != n_oor:
            fail(f"compacted route rerouted "
                 f"{st.get('Out_of_range_keys_rerouted')}, {n_oor} expected")
    return nrec, secs, n, st


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(2)
    try:
        from windflow_tpu_torch.kernels import build
        from windflow_tpu_torch.kernels import ffat_cuda as fc
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        sys.exit(2)
    if "jax" in sys.modules or "windflow_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    nvcc_s = build.build_all()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {nvcc_s:.2f} s, {build.nvcc_runs} compilations)")

    # 2. kernels against their plain versions
    rows = check_grouping(dev) + check_fold(dev) + check_table(dev)
    print("phase 2: kernels equal their plain versions at the main-path "
          "shapes and edges")

    # 3. the main path, counts read just after each run, by run label
    run_counts = {}
    for sum_comb, need in ((False, ("grouping_rank_hist",)),
                           (True, ("grouping_rank_hist", "sliding_fold"))):
        fc.reset_launch_counts()
        nrec, secs, n = run_main_path("cuda", sum_comb)
        counts = fc.launch_counts()
        for name in need:
            if counts[name] <= 0:
                fail(f"main path ({'sum' if sum_comb else 'generic'} "
                     f"combiner) never launched {name}")
        run_counts["ffat sum" if sum_comb else "ffat generic"] = counts
        print(f"phase 3: PipeGraph.run() {'withSumCombiner' if sum_comb else 'generic combiner'}: "
              f"{nrec} windows match the oracle; {n} tuples in {secs:.3f} s "
              f"= {n / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}")
    # the reduce path: (route, monoid, declared, key_compaction, batches,
    # key range, the kernel launched or not)
    from windflow_tpu_torch.parallel.compaction import overflow_cap
    runs = [("(a) compacted", "max", True, True, BATCHES, KEYS, True),
            ("(b) compacted sum", "sum", True, True, BATCHES, KEYS, True),
            ("(c) dense", "max", True, False, 4, KEYS, True),
            ("(d) sorted", "max", False, True, 4, KEYS, False),
            ("(e) compacted, keys < 1040", "max", True, True, 2, 1040, True),
            ("(e) compacted, keys < 1100", "max", True, True, 2, 1100, True),
            ("(e) dense, keys < 1040", "max", True, False, 2, 1040, True),
            ("(e) dense, keys < 1100", "max", True, False, 2, 1100, True)]
    for label, monoid, declare, kc, nb, kr, need in runs:
        fc.reset_launch_counts()
        nrec, secs, n, st = run_reduce("cuda", monoid, declare, kc, nb,
                                       key_range=kr)
        counts = fc.launch_counts()
        got_k = counts["dense_monoid_table"]
        if need and got_k <= 0:
            fail(f"reduce {label} never launched dense_monoid_table")
        if not need and got_k:
            fail(f"reduce {label} launched dense_monoid_table")
        run_counts[label] = counts
        extra = ""
        if "Key_compaction" in st:
            kcs = st["Key_compaction"]
            extra = (f"; rerouted {kcs['overflow_tuples']}, full-width "
                     f"fallbacks {kcs['big_fallbacks']} (overflow lane "
                     f"{overflow_cap(CAP)} lanes)")
            if kr == 1040 and (kcs["overflow_tuples"] == 0
                               or kcs["big_fallbacks"]):
                fail(f"reduce {label} did not take the overflow lane")
            if kr == 1100 and kcs["big_fallbacks"] != nb:
                fail(f"reduce {label} did not take the full-width lane")
        if "Out_of_range_keys_dropped" in st:
            extra = f"; dropped {st['Out_of_range_keys_dropped']}"
        print(f"phase 3: PipeGraph.run() reduce {label}: {nrec} records "
              f"match the oracle batch by batch; {n} tuples in {secs:.3f} s "
              f"= {n / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}{extra}")
    # each kernel row's launches: the runs that make its calls (the
    # table's (e) runs make the calls of routes (a) and (c))
    runs_of = {"grouping_rank_hist": ("ffat generic", "ffat sum"),
               "sliding_fold": ("ffat generic", "ffat sum"),
               "dense_monoid_table[a]": ("(a) compacted",
                                         "(e) compacted, keys < 1040",
                                         "(e) compacted, keys < 1100"),
               "dense_monoid_table[b]": ("(b) compacted sum",),
               "dense_monoid_table[c]": ("(c) dense", "(e) dense, keys < 1040",
                                         "(e) dense, keys < 1100")}
    for r in rows:
        counter = r["name"].split("[")[0]
        r["launches"] = sum(run_counts[label][counter]
                            for label in runs_of[r["name"]])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
