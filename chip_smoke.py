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
   fold is timed on two masks, ``sliding_fold[dense]`` (90% of the panes
   valid) and ``sliding_fold[main]`` (the FFAT step's own: the carried
   panes and 1-3 new ones a key); the dense table at each of the reduce
   routes' three calls, (a) compacted max, (b) compacted sum and (c)
   dense max; the grouping a second time at the time-window path's
   shape, ``grouping_rank_hist[tb]`` (run (c) of phase 4: ids of 32 keys
   × a 68-pane ring, NB = 2,177); each a row of its own in the JSON
   line;
3. drive the main paths through ``PipeGraph.run()`` at the repo's chip
   configuration (262,144 tuples a batch, 1,024 keys), each with the
   launch counts set to 0 just before and read just after:
   * Source → MapGPU | FilterGPU → Ffat_WindowsGPU (count windows of
     1,024 sliding by 128, keyed) → Sink, 8 batches, once with the
     generic combiner and once with ``withSumCombiner()`` (one fold
     launch a step); every fired window against a numpy oracle;
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
   batches above so that the whole stays far inside the time limit;
4. drive the time-window path, Source (EVENT time) → [MapGPU |
   FilterGPU] → Ffat_WindowsGPU (``withTBWindows``) → columnar Sink,
   through ``PipeGraph.run()``, 8 batches of 262,144 tuples each, every
   window record (EOS-flushed ones included) against a numpy version of
   the TB oracle (``tests/conftest.py`` ``tb_window_sums``), with no late
   tuple, evicted pane cell or suppressed window:
   * (a) YSB (``windflow_tpu/models/ad_analytics.py``, bench.py's YSB
     leg): 1,000 ads onto 100 campaigns by a seeded table on the device,
     views kept, 10 s tumbling windows keyed by campaign, tuples 305 µs
     apart; the generic combiner (the radix grouping of 6,801 (key,
     pane) ids) and ``withSumCombiner`` (the scatter placement);
   * (b) telemetry (``windflow_tpu/models/telemetry_frames.py``): 1,024
     sensors, 60 s windows sliding by 5 s, lateness 1 s, overflow policy
     drop, readings 100 µs apart jittered back by up to 0.5 s; the
     stable sort of 77,825 ids;
   * (c) 32 keys, 4 s windows sliding by 1 s, tuples 10 µs apart: the
     ring sizes to 68 panes, 2,177 ids, under the grouping kernel's
     gate; the kernel must launch on every step.

5. drive the columnar ingest path through ``PipeGraph.run()``, 16
   batches of 262,144 tuples each (bench.py ``CONFIGS["tpu"]``'s
   ``e2e_tuples``), each run against its oracle and with the launch
   counts set to 0 just before and read just after:
   * (i) bench.py's e2e leg: a seeded blob of 4,194,304 binary frames
     (96 MiB) read in 1 MiB chunks → ``FrameSource`` → MapGPU | FilterGPU
     → the keyed count windows of phase 3 → columnar Sink (``defer=4``),
     with the generic combiner and with ``withSumCombiner``; every batch
     must stage packed (16 packed batches, no record batch);
   * (ii) bench.py's YSB leg: frames of (ad, event time, event type) →
     ``FrameSource`` → FilterGPU (views) | MapGPU (ad → campaign, a
     seeded table on the device) → 10 s tumbling time windows,
     ``withSumCombiner``, EVENT time, event times over ~64 windows; 16
     packed batches, no late tuple, evicted pane or suppressed window;
   * (iii) bench.py's device-source leg: ``DeviceSource`` batches born
     on the card (the bench's lane hash, in int64) into the graph of (i),
     both combiners;
   then the declared f32 sums repeat bit for bit: a CB and a TB graph
   with ``withSumCombiner`` over random float values, each run twice,
   give the same bits and stay within rtol 1e-5 of a float64 oracle.

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
#: time-window runs (EVENT time, CAP tuples a batch, BATCHES batches):
#: (a) YSB: ads, campaigns, µs between tuples, 10 s tumbling windows
YSB_ADS, YSB_CAMPAIGNS, YSB_GAP, YSB_WIN = 1000, 100, 305, (10 ** 7, 10 ** 7)
#: (b) telemetry: sensors, µs between tuples, windows, lateness, jitter
TELE_KEYS, TELE_GAP, TELE_WIN = 1024, 100, (60 * 10 ** 6, 5 * 10 ** 6)
TELE_LATENESS, TELE_JITTER = 10 ** 6, 5 * 10 ** 5
#: (c) the grouping kernel on the TB path: keys, µs between tuples,
#: windows, panes a window, and the ring the first batch sizes
TBC_KEYS, TBC_GAP, TBC_WIN, TBC_R, TBC_NP = 32, 10, (4 * 10 ** 6, 10 ** 6), \
    4, 68
#: columnar runs (phase 5): batches a run, and bytes a FrameSource chunk
COL_BATCHES, CHUNK_BYTES = 16, 1 << 20
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


def device_ms(fn, iters=20, attempts=3):
    """Mean device milliseconds of ``fn()``: the kernel time that
    ``torch.profiler`` records over ``iters`` calls, gaps between
    kernels left out (CUDA events over back-to-back calls measure the
    host's issue rate instead wherever a call's Python and launch
    overhead exceeds its device work).  A trace that holds no device
    record at all (the profiler now and then delivers none) is taken
    again, up to ``attempts`` traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = prof.key_averages()
        us = sum(_device_us(e) for e in evs if e.device_type.name == "CUDA")
        if us > 0:
            return us / iters / 1e3
        print(f"chip_smoke: torch.profiler recorded no device time "
              f"(trace {attempt} of {attempts})", file=sys.stderr)
    fail("torch.profiler recorded no device time: "
         f"{[(e.key[:40], e.device_type.name) for e in evs][:20]}")


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


def tb_grouping_ids(rng, K, NP, n):
    """The (key, pane) ids of a TB step at run (c)'s shape
    (``ffat_kernels.make_ffat_tb_step``'s ``sid``): ``key * NP + rel``
    for the lanes of ``n`` tuples ``TBC_GAP`` µs apart, panes of 1 s, the
    ring base one window span behind the batch."""
    keys = rng.integers(0, K, n)
    rel = (np.arange(n) * TBC_GAP) // TBC_WIN[1] + TBC_R
    return (keys * NP + rel).astype(np.int32)


def check_grouping_tb(dev):
    """The grouping kernel at the TB path's shape, run (c): ids int32
    [262144], NB = K*NP + 1 = 2,177; bit for bit against its plain
    version (and its order against the stable sort), timed beside it,
    its bound and ``sort(stable)`` + ``bincount``."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.grouping import invert_perm
    NB = TBC_KEYS * TBC_NP + 1
    ids = torch.from_numpy(tb_grouping_ids(np.random.default_rng(17),
                                           TBC_KEYS, TBC_NP, CAP)).to(dev)
    got = fc.grouping_rank_hist(ids, NB)
    torch.cuda.synchronize()
    want = fc.grouping_rank_hist_plain(ids, NB)
    worst = 0
    for name, g, w in zip(("dest", "rank", "hist"), got, want):
        worst = max(worst, (g.long() - w.long()).abs().max().item())
        if not torch.equal(g, w):
            fail(f"grouping_rank_hist[tb] {name} differs from its plain "
                 "version")
    if not torch.equal(invert_perm(got[0]).long(),
                       torch.sort(ids, stable=True).indices):
        fail("order_hist[tb] is not the stable argsort")
    t = timings(f"grouping_rank_hist[tb] at B={CAP} NB={NB}",
                kernel=lambda: fc.grouping_rank_hist(ids, NB),
                plain=lambda: fc.grouping_rank_hist_plain(ids, NB),
                library=lambda: (torch.sort(ids, stable=True),
                                 torch.bincount(ids, minlength=NB)))
    b_ms, b_by = bound_ms(CAP * 4 + 2 * CAP * 4 + NB * 4, 2 * CAP)
    return [{"name": "grouping_rank_hist[tb]", "route": "cuda",
             "source": "windflow_tpu_torch/csrc/grouping_rank_hist.cu",
             "replaces": "windflow_tpu/kernels/pallas_ffat.py:214",
             "max_abs_err": worst, "ms": t["kernel"], "plain_ms": t["plain"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": t["library"]}]


def main_fold_mask(rng, K, NPP, R):
    """The FFAT step's pane mask at the fold (``ffat_kernels.py``'s
    ``full_valid``): the R-1 carried panes, then 1-3 new ones a key
    (~256 tuples a key a batch at P = 128), and no live pane for the keys
    that the filter ``(key & 7) != 7`` empties."""
    live = (R - 1) + rng.integers(1, 4, K)
    v = np.arange(NPP)[None, :] < live[:, None]
    v[(np.arange(K) & 7) == 7] = False
    return v


def fold_bits(t):
    """A fold result as int32 bits (-0.0 and 0.0 differ)."""
    import torch
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def fold_err(got, want):
    """Largest difference of two fold results (equal infinities count 0)."""
    if not got.numel():
        return 0.0
    d = got.double() - want.double()
    return d.masked_fill(got.double() == want.double(), 0.0).abs().max().item()


def fold_edges(dev, rng):
    """The fold kernel against its plain version at its edges, bit for
    bit: -0.0 at column 0 of every case, all-invalid and all-valid rows,
    row pitches that are and are not a multiple of 4, R = 1, 2, 7, 8, 16,
    17, 31, 33, 512 (the register path ends at 16), N < R, K = 1, a view
    off 16-byte alignment (the shared-memory path), runs of 4 and 16
    outputs a thread, and pytrees of f32 and i32 leaves (one launch up to
    four leaves).  Returns the largest difference."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    worst = 0.0

    def same(got, want, what):
        nonlocal worst
        worst = max(worst, fold_err(got, want))
        if not torch.equal(fold_bits(got), fold_bits(want)):
            fail(f"sliding_fold differs from its plain version: {what}")

    # (K, N, R, mask: "rows" = a third of the rows all invalid, a third
    # all valid, the rest 80% valid; "main" = the FFAT step's)
    cases = [(KEYS, 2056, 8, "main"), (64, 2056, 8, "rows"),
             (33, 2057, 2, "rows"), (9, 300, 7, "rows"), (9, 300, 1, "rows"),
             (9, 300, 16, "rows"), (9, 300, 17, "main"),
             (9, 300, 31, "main"), (9, 300, 33, "rows"),
             (2, 4096 - 511, 512, "rows"), (5, 5, 8, "rows"),
             (4, 3, 33, "rows"), (1, 2057, 8, "rows"), (1, 1, 1, "rows")]
    for K, N, R, pattern in cases:
        if pattern == "main":
            v = main_fold_mask(rng, K, N, R)
        else:
            v = rng.random((K, N)) < 0.8
            v[0::3] = False
            v[1::3] = True
        v = torch.from_numpy(v).to(dev)
        x = rng.standard_normal((K, N)) * 1000
        x[:, 0] = -0.0
        for dt in (torch.float32, torch.int32):
            xt = torch.from_numpy(x).to(dt).to(dev)
            for monoid in ("sum", "max", "min"):
                fc.reset_launch_counts()
                got = fc.sliding_fold(xt, v, R, monoid)
                if fc.launch_counts()["sliding_fold"] != 1:
                    fail("sliding_fold took more than one launch for a leaf")
                torch.cuda.synchronize()
                same(got, fc.fold_leaf_plain(xt, v, R, monoid),
                     f"{monoid} {dt} K={K} N={N} R={R} {pattern}")
    # main shape: a view 4 bytes off alignment, and every run length
    P = int(np.gcd(WIN, SLIDE))
    R = WIN // P
    NPP = (R - 1) + CAP // P + 2
    base = torch.from_numpy(rng.standard_normal((KEYS + 1, NPP))
                            .astype(np.float32)).to(dev)
    default_run = fc.FOLD_RUN
    try:
        for run in (4, 8, 16):
            fc.FOLD_RUN = run
            for pattern in ("dense", "main"):
                v = torch.from_numpy(
                    main_fold_mask(rng, KEYS, NPP, R) if pattern == "main"
                    else rng.random((KEYS, NPP)) < 0.9).to(dev)
                for x in (base[:KEYS], base[1:]):
                    for monoid in ("sum", "max", "min"):
                        same(fc.sliding_fold(x, v, R, monoid),
                             fc.fold_leaf_plain(x, v, R, monoid),
                             f"{monoid} run {run} {pattern} "
                             f"offset {x.data_ptr() % 16}")
    finally:
        fc.FOLD_RUN = default_run
    # pytrees: f32 and i32 leaves of one dict, four leaves a launch
    v = torch.from_numpy(main_fold_mask(rng, KEYS, NPP, R)).to(dev)
    for nleaves, launches in ((2, 1), (4, 1), (5, 2)):
        tree = {f"l{i}": torch.from_numpy(
            rng.integers(-1000, 1000, (KEYS, NPP))
            .astype(np.float32 if i % 2 == 0 else np.int32)).to(dev)
            for i in range(nleaves)}
        for monoid in ("sum", "max", "min"):
            fc.reset_launch_counts()
            got = fc.sliding_fold(tree, v, R, monoid)
            if fc.launch_counts()["sliding_fold"] != launches:
                fail(f"sliding_fold took {fc.launch_counts()['sliding_fold']}"
                     f" launches for {nleaves} leaves, {launches} expected")
            for k, leaf in tree.items():
                if got[k].dtype != leaf.dtype:
                    fail("sliding_fold changed a leaf's dtype")
                same(got[k], fc.fold_leaf_plain(leaf, v, R, monoid),
                     f"pytree of {nleaves} leaves, {k}, {monoid}")
    return worst


def fold_inputs(dev, rng, pattern):
    """The main-path call's inputs, f32 [1024, 2057] + bool mask, R = 8:
    ``dense`` has 90% of the panes valid, ``main`` the FFAT step's mask."""
    import torch
    P = int(np.gcd(WIN, SLIDE))
    R = WIN // P
    NPP = (R - 1) + CAP // P + 2
    if pattern == "main":
        v = main_fold_mask(rng, KEYS, NPP, R)
    else:
        v = rng.random((KEYS, NPP)) < 0.9
    x = rng.standard_normal((KEYS, NPP)).astype(np.float32)
    return (torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev), R)


def fold_bound(valid, R):
    """Bound of one f32 fold call: the mask read, the output written, and
    the values of the 32-byte sectors that hold a valid pane; one
    combine a level and a stitch for each output whose window holds a
    valid pane."""
    import torch
    n = valid.numel()
    flat = torch.nn.functional.pad(valid.reshape(-1).to(torch.uint8),
                                   (0, -n % 8))
    sectors = int(flat.reshape(-1, 8).any(1).sum())
    c = torch.nn.functional.pad(valid.int().cumsum(1), (R, 0))
    live = int(((c[:, R:] - c[:, :-R]) > 0).sum())
    nops = live * (R.bit_length() - 1 + bin(R).count("1") - 1)
    return bound_ms(n + 4 * n + 32 * sectors, nops)


def check_fold(dev):
    """Fold kernel vs its plain version on [1024, 2057], R = 8, every
    monoid × f32/i32, bit for bit, at both rows' masks, plus the edges of
    ``fold_edges``; each row timed beside its plain version, its bound and
    ``conv1d``."""
    import torch
    import torch.nn.functional as F
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    rng = np.random.default_rng(11)
    worst = fold_edges(dev, rng)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for pattern in ("dense", "main"):
        x, valid, R = fold_inputs(dev, rng, pattern)
        xi = torch.from_numpy(rng.integers(-1 << 20, 1 << 20, tuple(x.shape))
                              .astype(np.int32)).to(dev)
        for xt in (x, xi):
            for monoid in ("sum", "max", "min"):
                got = fc.sliding_fold(xt, valid, R, monoid)
                torch.cuda.synchronize()
                want = fc.fold_leaf_plain(xt, valid, R, monoid)
                worst = max(worst, fold_err(got, want))
                if not torch.equal(fold_bits(got), fold_bits(want)):
                    fail(f"sliding_fold[{pattern}] {monoid} {xt.dtype} "
                         "differs from its plain version")
        w = torch.ones((1, 1, R), dtype=torch.float32, device=dev)

        def conv_sum(x=x, valid=valid, w=w, R=R):
            xin = torch.where(valid, x, 0.0)[:, None, :]
            return F.conv1d(F.pad(xin, (R - 1, 0)), w)
        t = timings(f"sliding_fold[{pattern}] sum at {list(x.shape)} R={R}",
                    kernel=lambda: fc.sliding_fold(x, valid, R, "sum"),
                    plain=lambda: fc.fold_leaf_plain(x, valid, R, "sum"),
                    library=conv_sum)
        if not torch.allclose(conv_sum()[:, 0],
                              fc.sliding_fold(x, valid, R, "sum"),
                              rtol=1e-5, atol=1e-5):
            fail(f"conv1d yardstick disagrees with the fold [{pattern}]")
        b_ms, b_by = fold_bound(valid, R)
        out.append({"name": f"sliding_fold[{pattern}]", "route": "cuda",
                    "source": "windflow_tpu_torch/csrc/sliding_fold.cu",
                    "replaces": "windflow_tpu/kernels/pallas_ffat.py:407",
                    "ms": t["kernel"], "plain_ms": t["plain"],
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": t["library"]})
    for r in out:
        r["max_abs_err"] = worst
    return out


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


def tb_oracle(keys, ts, vals, win, slide):
    """numpy version of the TB oracle (tests/conftest.py
    ``tb_window_sums``): the sum of every window ``[w*slide, w*slide +
    win)`` that holds a tuple, per key, EOS-flushed windows included.
    Returns ``(codes, sums)`` sorted by ``code = key * WIDS + wid``
    (float64: exact for integer-valued data).  ``win`` is a multiple of
    ``slide`` here, so a tuple lies in windows ``ts // slide - o`` for
    ``o`` in ``[0, win / slide)``."""
    last = ts // slide
    ks, ws, vs = [], [], []
    for o in range(win // slide):
        w = last - o
        m = w >= 0
        ks.append(keys[m])
        ws.append(w[m])
        vs.append(vals[m])
    k, w = np.concatenate(ks).astype(np.int64), np.concatenate(ws)
    codes, inv = np.unique(k * tb_wids(ts, slide) + w, return_inverse=True)
    return codes, np.bincount(inv, weights=np.concatenate(vs)
                              .astype(np.float64))


def tb_wids(ts, slide):
    return int(ts.max()) // slide + 1


def check_tb_records(label, cols, keys, ts, vals, win, slide):
    """The run's window records (columnar sink batches) against
    ``tb_oracle``, record for record; returns the record count."""
    codes, sums = tb_oracle(keys, ts, vals, win, slide)
    if not cols:
        fail(f"TB {label}: no window records")
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
    w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
    v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
    got = k.astype(np.int64) * tb_wids(ts, slide) + w
    order = np.argsort(got, kind="stable")
    if len(np.unique(got)) != len(got):
        fail(f"TB {label}: duplicate (key, wid) records")
    if not np.array_equal(got[order], codes):
        fail(f"TB {label}: {len(got)} windows fired, {len(codes)} expected,"
             " or other (key, wid)s")
    if not np.isfinite(v).all():
        fail(f"TB {label}: non-finite window values")
    bad = np.flatnonzero(v[order].astype(np.float64) != sums)
    if len(bad):
        i = bad[0]
        fail(f"TB {label}: {len(bad)} window sums differ, e.g. (key, wid) "
             f"code {codes[i]}: {v[order][i]} vs {sums[i]}")
    return len(got)


def ysb_data(n, seed=3):
    """(a): ad ids over 1,000 ads, event types uniform over {0, 1, 2},
    timestamps YSB_GAP µs apart in event-time order, and the seeded
    ad → campaign table."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, YSB_CAMPAIGNS, YSB_ADS).astype(np.int32)
    ad = rng.integers(0, YSB_ADS, n).astype(np.int32)
    etype = rng.integers(0, 3, n).astype(np.int32)
    ts = np.arange(n, dtype=np.int64) * YSB_GAP
    return table, ad, etype, ts


def ysb_graph(dev_name, sum_combiner, table, ad, etype, ts, sink_fn):
    """(a) as a user builds it (windflow_tpu/models/ad_analytics.py,
    bench.py's YSB leg): Source (EVENT time) → FilterGPU (views) |
    MapGPU (ad → campaign, a gather from the table on the device) →
    Ffat_WindowsGPU (10 s tumbling TB counts, keyed by campaign) →
    columnar Sink.  Returns ``(graph, window operator)``."""
    import torch
    import windflow_tpu_torch as wf
    dev_table = torch.from_numpy(table).to(dev_name)

    def gen():
        yield from ({"ad_id": a, "etype": e, "ts": t}
                    for a, e, t in zip(ad, etype, ts.tolist()))

    win = (wf.Ffat_WindowsGPU_Builder(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(*YSB_WIN).withKeyBy(lambda e: e["campaign"])
           .withMaxKeys(YSB_CAMPAIGNS))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = wf.PipeGraph("chip_smoke_ysb", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(wf.Source_Builder(gen)
                        .withTimestampExtractor(lambda e: e["ts"])
                        .withOutputBatchSize(CAP).build())
    pipe.add(wf.FilterGPU_Builder(lambda e: e["etype"] == 1).build())
    pipe.chain(wf.MapGPU_Builder(
        lambda e: {"campaign": dev_table[e["ad_id"].long()], "one": 1})
        .build())
    pipe.add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, win


def telemetry_data(n, seed=5):
    """(b): sensors uniform over TELE_KEYS, integer-valued float32
    readings, timestamps TELE_GAP µs apart in arrival order, each
    jittered back by up to TELE_JITTER (inside the lateness)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, TELE_KEYS, n).astype(np.int32)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    ts = np.maximum(np.arange(n, dtype=np.int64) * TELE_GAP
                    - rng.integers(0, TELE_JITTER + 1, n), 0)
    return keys, vals, ts


def keyed_tb_graph(dev_name, name, keys, vals, ts, max_keys, win, sink_fn,
                   lateness=0, policy="drop", normalize=False):
    """Source (EVENT time) of ``{"key", "v0", "ts"}`` records → [MapGPU
    normalize | FilterGPU drop-NaN, as windflow_tpu/models/
    telemetry_frames.py builds them] → Ffat_WindowsGPU (TB ``win``,
    keyed, generic ``a + b``) → columnar Sink.  Returns ``(graph, window
    operator)``."""
    import windflow_tpu_torch as wf

    def gen():
        yield from ({"key": k, "v0": v, "ts": t}
                    for k, v, t in zip(keys, vals, ts.tolist()))

    win_op = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"],
                                         lambda a, b: a + b)
              .withTBWindows(*win).withKeyBy(lambda t: t["key"])
              .withMaxKeys(max_keys).withLateness(lateness)
              .withOverflowPolicy(policy).build())
    g = wf.PipeGraph(name, wf.ExecutionMode.DEFAULT, wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(wf.Source_Builder(gen)
                        .withTimestampExtractor(lambda t: t["ts"])
                        .withOutputBatchSize(CAP).build())
    if normalize:
        pipe.add(wf.MapGPU_Builder(
            lambda t: {"key": t["key"], "v0": t["v0"]}).build())
        pipe.chain(wf.FilterGPU_Builder(lambda t: t["v0"] == t["v0"])
                   .build())
    pipe.add(win_op).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                              .build())
    return g, win_op


def tb_run(label, build, keys, ts, vals, win):
    """One PipeGraph.run() of a TB graph built by ``build(sink_fn)``;
    every window record against the oracle, and no late tuple, evicted
    pane cell or suppressed window.  Returns (records, seconds, NP)."""
    import torch
    cols = []
    g, op = build(lambda c: cols.append(c) if c is not None else None)
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    nrec = check_tb_records(label, cols, keys, ts, vals, *win)
    st = op.dump_stats()
    counts = [st[k] for k in ("Late_tuples_dropped", "Pane_cells_evicted",
                              "Windows_dropped_on_overflow")]
    if counts != [0, 0, 0]:
        fail(f"TB {label}: late / evicted / dropped {counts}, 0 expected")
    return nrec, secs, op.NP


def tb_runs(dev_name="cuda"):
    """Phase 4: the three time-window runs; returns their launch counts
    by label."""
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * BATCHES
    table, ad, etype, ts_a = ysb_data(n)
    views = etype == 1
    keys_a = table[ad[views]]
    ones = np.ones(int(views.sum()))
    tk, tv, tts = telemetry_data(n)
    rng = np.random.default_rng(6)
    ck = rng.integers(0, TBC_KEYS, n).astype(np.int32)
    cv = rng.integers(-100, 101, n).astype(np.float32)
    cts = np.arange(n, dtype=np.int64) * TBC_GAP
    runs = [
        ("(a) YSB generic", YSB_CAMPAIGNS, YSB_WIN,
         lambda f: ysb_graph(dev_name, False, table, ad, etype, ts_a, f),
         (keys_a, ts_a[views], ones)),
        ("(a) YSB withSumCombiner", YSB_CAMPAIGNS, YSB_WIN,
         lambda f: ysb_graph(dev_name, True, table, ad, etype, ts_a, f),
         (keys_a, ts_a[views], ones)),
        ("(b) telemetry", TELE_KEYS, TELE_WIN,
         lambda f: keyed_tb_graph(dev_name, "chip_smoke_telemetry", tk, tv,
                                  tts, TELE_KEYS, TELE_WIN, f,
                                  lateness=TELE_LATENESS, policy="drop",
                                  normalize=True),
         (tk, tts, tv)),
        ("(c) grouping kernel", TBC_KEYS, TBC_WIN,
         lambda f: keyed_tb_graph(dev_name, "chip_smoke_tbc", ck, cv, cts,
                                  TBC_KEYS, TBC_WIN, f),
         (ck, cts, cv)),
    ]
    out = {}
    for label, K, win, build, (keys, ts, vals) in runs:
        fc.reset_launch_counts()
        nrec, secs, NP = tb_run(label, build, keys, ts, vals, win)
        counts = fc.launch_counts()
        out[label] = counts
        print(f"phase 4: PipeGraph.run() TB {label}: ring NP {NP}, "
              f"K*NP+1 {K * NP + 1} (key, pane) ids; {nrec} windows match "
              f"the oracle, no late, evicted or dropped; {n} tuples in "
              f"{secs:.3f} s = {n / secs:.0f} tuples/s (host clock, "
              f"information only); launches {counts}")
        if label.startswith("(c)"):
            if NP != TBC_NP:
                fail(f"TB (c): ring NP {NP}, {TBC_NP} expected")
            if K * NP + 1 > fc.MAX_BUCKETS:
                fail("TB (c): (key, pane) ids beyond the kernel gate")
            if counts["grouping_rank_hist"] < BATCHES:
                fail(f"TB (c): grouping_rank_hist launched "
                     f"{counts['grouping_rank_hist']} times in {BATCHES} "
                     "steps")
        elif any(counts.values()):
            # radix, scatter and stable-sort placements: no kernel
            fail(f"TB {label} launched a kernel off its path: {counts}")
    return out


def frame_blob(keys, ts, vals):
    """Binary frames (LE ``int64 key, int64 ts, float64 v0``) of the
    given columns."""
    rec = np.empty(len(keys), dtype=[("k", "<i8"), ("t", "<i8"),
                                     ("v", "<f8")])
    rec["k"], rec["t"], rec["v"] = keys, ts, vals
    return rec.tobytes()


def chunked(blob, step=CHUNK_BYTES):
    """A FrameSource chunk generator over ``blob``: ``step`` bytes a
    chunk, records split across chunks."""
    def gen():
        for lo in range(0, len(blob), step):
            yield blob[lo:lo + step]
    return gen


def cb_tail(pipe, sum_combiner, sink_fn):
    """The e2e leg's operators after its source: MapGPU ``v0*1.5+1`` |
    FilterGPU ``(key & 7) != 7`` (chained) → keyed count windows →
    columnar Sink (``defer=4``)."""
    import windflow_tpu_torch as wf
    pipe.add(wf.MapGPU_Builder(
        lambda t: {"key": t["key"], "v0": t["v0"] * 1.5 + 1.0}).build())
    pipe.chain(wf.FilterGPU_Builder(lambda t: (t["key"] & 7) != 7).build())
    wb = (wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
          .withCBWindows(WIN, SLIDE).withKeyBy(lambda t: t["key"])
          .withMaxKeys(KEYS))
    if sum_combiner:
        wb = wb.withSumCombiner()
    pipe.add(wb.build()).add_sink(wf.Sink_Builder(sink_fn)
                                  .withColumnarSink(defer=4).build())


def frames_cb_graph(dev_name, sum_combiner, blob, sink_fn):
    """(i): FrameSource over ``blob`` → ``cb_tail``, INGRESS time as
    bench.py's e2e leg.  Returns ``(graph, source)``."""
    import windflow_tpu_torch as wf
    src = wf.FrameSource(chunked(blob), nv=1, fmt="frames",
                         output_batch_size=CAP,
                         record_spec={"key": np.int32(0),
                                      "v0": np.float32(0.0)})
    g = wf.PipeGraph("chip_smoke_frames", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.INGRESS,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    cb_tail(g.add_source(src), sum_combiner, sink_fn)
    return g, src


def device_batch(i, dev):
    """(iii): batch ``i`` of bench.py's device-source leg, born on the
    card: lane-derived keys and values, mixed by the batch index (the
    hash in int64, then narrowed, so it does not wrap in int32)."""
    import torch
    lane = torch.arange(CAP, dtype=torch.int64, device=dev)
    mixed = (lane * 2654435761 + i * 40503) & 0x7FFFFFFF
    return {"key": (mixed % KEYS).to(torch.int32),
            "v0": (mixed % 1024).to(torch.float32) / 1024.0}


def device_batch_numpy(n_batches):
    """The records of ``device_batch`` 0..n_batches-1, in order."""
    lane = np.arange(CAP, dtype=np.int64)
    mixed = np.concatenate([(lane * 2654435761 + i * 40503) & 0x7FFFFFFF
                            for i in range(n_batches)])
    return ((mixed % KEYS).astype(np.int32),
            (mixed % 1024).astype(np.float32) / np.float32(1024.0))


def devsrc_cb_graph(dev_name, sum_combiner, sink_fn):
    """(iii): DeviceSource → ``cb_tail``.  Returns ``(graph, source)``."""
    import torch
    import windflow_tpu_torch as wf
    dev = torch.device(dev_name)
    src = (wf.DeviceSource_Builder(lambda i: device_batch(i, dev))
           .withCapacity(CAP).withNumBatches(COL_BATCHES).build())
    g = wf.PipeGraph("chip_smoke_devsrc", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.INGRESS,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    cb_tail(g.add_source(src), sum_combiner, sink_fn)
    return g, src


def ysb_frames(n, seed=3):
    """(ii): bench.py's YSB records: ad ids over 1,000 ads as the frame
    key, event times spread over ~64 windows, event types uniform over
    {0, 1, 2} as the value; and the seeded ad → campaign table."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, YSB_CAMPAIGNS, YSB_ADS).astype(np.int32)
    ad = rng.integers(0, YSB_ADS, n)
    ts = np.arange(n, dtype=np.int64) * max(1, 64 * YSB_WIN[0] // n)
    etype = rng.integers(0, 3, n)
    return table, ad, ts, etype


def ysb_frames_graph(dev_name, table, blob, sink_fn, sum_combiner=True):
    """(ii) as bench.py builds it: FrameSource (EVENT time) → FilterGPU
    (views) | MapGPU (ad → campaign) → tumbling TB counts keyed by
    campaign → columnar Sink.  Returns ``(graph, source, windows)``."""
    import torch
    import windflow_tpu_torch as wf
    dev_table = torch.from_numpy(table).to(dev_name)
    src = wf.FrameSource(chunked(blob), nv=1, fmt="frames",
                         output_batch_size=CAP)
    win = (wf.Ffat_WindowsGPU_Builder(lambda e: e["one"], lambda a, b: a + b)
           .withTBWindows(*YSB_WIN).withKeyBy(lambda e: e["campaign"])
           .withMaxKeys(YSB_CAMPAIGNS))
    if sum_combiner:
        win = win.withSumCombiner()
    win = win.build()
    g = wf.PipeGraph("chip_smoke_ysb_frames", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    pipe = g.add_source(src)
    pipe.add(wf.FilterGPU_Builder(lambda e: e["v0"] == 1.0).build())
    pipe.chain(wf.MapGPU_Builder(
        lambda e: {"campaign": dev_table[e["key"].long()], "one": 1})
        .build())
    pipe.add(win).add_sink(wf.Sink_Builder(sink_fn).withColumnarSink()
                           .build())
    return g, src, win


def check_cb_columns(label, cols, keys, vals, exact=True):
    """A CB run's columnar sink batches against ``oracle`` (after the map
    and filter): the same (key, wid)s, and sums equal (``exact``) or
    within rtol 1e-5."""
    k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
    w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
    v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
    keep = (keys & 7) != 7
    want = oracle(keys[keep], vals[keep] * np.float32(1.5) + np.float32(1.0))
    got = dict(zip(zip(k.tolist(), w.tolist()), v.tolist()))
    if len(got) != len(k):
        fail(f"{label}: duplicate (key, wid) records")
    if set(got) != set(want):
        fail(f"{label}: {len(got)} windows fired, {len(want)} expected")
    g = np.array([got[x] for x in want])
    e = np.array(list(want.values()))
    if not np.isfinite(g).all():
        fail(f"{label}: non-finite window values")
    bad = np.flatnonzero(g != e) if exact else \
        np.flatnonzero(~np.isclose(g, e, rtol=1e-5, atol=1e-3))
    if len(bad):
        fail(f"{label}: {len(bad)} window sums differ, e.g. "
             f"{list(want)[bad[0]]}: {g[bad[0]]} vs {e[bad[0]]}")
    return len(k)


def collect():
    """A columnar sink function and the list it fills."""
    out = []
    return out, (lambda c: out.append(c) if c is not None else None)


def staged_only_packed(label, src, batches):
    """The FrameSource's staging emitter staged ``batches`` packed
    batches and nothing on the record or chunk routes."""
    em = src.replicas[0].emitter
    got = (em.packed_batches, em.chunked_batches, em.record_batches)
    if got != (batches, 0, 0):
        fail(f"{label}: staged (packed, chunked, record) batches {got}, "
             f"({batches}, 0, 0) expected")


def float_sum_repeats(dev_name):
    """C2 on the card: the declared f32 sums of a CB and a TB graph over
    random float values (4 batches each), each run twice: the same bits,
    and within rtol 1e-5 of the float64 oracle."""
    import torch
    nb = 4
    rng = np.random.default_rng(41)
    n = CAP * nb
    keys = rng.integers(0, KEYS, n)
    vals = rng.standard_normal(n).astype(np.float32)
    blob = frame_blob(keys, np.arange(n), vals)
    outs = []
    for _ in range(2):
        cols, sink = collect()
        g, _ = frames_cb_graph(dev_name, True, blob, sink)
        g.run()
        torch.cuda.synchronize()
        check_cb_columns("C2 CB f32 sum", cols, keys.astype(np.int32), vals,
                         exact=False)
        outs.append(b"".join(np.asarray(c.cols[f]).tobytes()
                             for c in cols for f in ("key", "wid", "value")))
    if outs[0] != outs[1]:
        fail("C2: the CB declared f32 sum differs between two runs")
    tk = rng.integers(0, YSB_CAMPAIGNS, n)
    tts = np.arange(n, dtype=np.int64) * 152
    tv = rng.standard_normal(n).astype(np.float32)
    blob = frame_blob(tk, tts, tv)
    outs = []
    for _ in range(2):
        cols, sink = collect()
        g = keyed_frames_tb_graph(dev_name, blob, sink)
        g.run()
        torch.cuda.synchronize()
        codes, sums = tb_oracle(tk, tts, tv.astype(np.float64), *YSB_WIN)
        k = np.concatenate([np.asarray(c.cols["key"]) for c in cols])
        w = np.concatenate([np.asarray(c.cols["wid"]) for c in cols])
        v = np.concatenate([np.asarray(c.cols["value"]) for c in cols])
        got = k.astype(np.int64) * tb_wids(tts, YSB_WIN[1]) + w
        order = np.argsort(got, kind="stable")
        if not np.array_equal(got[order], codes) or not np.allclose(
                v[order], sums, rtol=1e-5, atol=1e-3):
            fail("C2: the TB declared f32 sum disagrees with its oracle")
        outs.append(k.tobytes() + w.tobytes() + v.tobytes())
    if outs[0] != outs[1]:
        fail("C2: the TB declared f32 sum differs between two runs")
    print(f"phase 5: C2 declared f32 sums repeat bit for bit: CB "
          f"{n} tuples, TB {n} tuples, within rtol 1e-5 of float64")


def keyed_frames_tb_graph(dev_name, blob, sink_fn):
    """FrameSource (EVENT time) → 10 s tumbling TB windows summing v0,
    ``withSumCombiner``, keyed by the frame key (100 keys) → columnar
    Sink.  Returns the graph."""
    import windflow_tpu_torch as wf
    g = wf.PipeGraph("chip_smoke_tb_f32", wf.ExecutionMode.DEFAULT,
                     wf.TimePolicy.EVENT,
                     config=wf.Config(device=dev_name,
                                      punctuation_interval_usec=10 ** 12))
    g.add_source(wf.FrameSource(chunked(blob), nv=1,
                                output_batch_size=CAP)) \
        .add(wf.Ffat_WindowsGPU_Builder(lambda t: t["v0"], lambda a, b: a + b)
             .withTBWindows(*YSB_WIN).withKeyBy(lambda t: t["key"])
             .withMaxKeys(YSB_CAMPAIGNS).withSumCombiner().build()) \
        .add_sink(wf.Sink_Builder(sink_fn).withColumnarSink().build())
    return g


def columnar_runs(dev_name="cuda"):
    """Phase 5: runs (i)-(iii) against their oracles; returns their
    launch counts by label."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    n = CAP * COL_BATCHES
    rng = np.random.default_rng(2025)
    keys = rng.integers(0, KEYS, n)
    vals = rng.integers(-100, 101, n).astype(np.float32)
    blob_i = frame_blob(keys, np.arange(n), vals)
    keys32 = keys.astype(np.int32)
    dk, dv = device_batch_numpy(COL_BATCHES)
    table, ad, ts_y, etype = ysb_frames(n)
    blob_ii = frame_blob(ad, ts_y, etype.astype(np.float64))
    views = etype == 1
    out = {}
    for label, kind, sum_comb in (
            ("(i) frames generic", "frames", False),
            ("(i) frames sum", "frames", True),
            ("(iii) device source generic", "device", False),
            ("(iii) device source sum", "device", True),
            ("(ii) YSB frames sum", "ysb", True)):
        cols, sink = collect()
        if kind == "frames":
            g, src = frames_cb_graph(dev_name, sum_comb, blob_i, sink)
        elif kind == "device":
            g, src = devsrc_cb_graph(dev_name, sum_comb, sink)
        else:
            g, src, win = ysb_frames_graph(dev_name, table, blob_ii, sink)
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        g.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = fc.launch_counts()
        out[label] = counts
        if kind == "ysb":
            nrec = check_tb_records(label, cols, table[ad[views]],
                                    ts_y[views], np.ones(int(views.sum())),
                                    *YSB_WIN)
            st = win.dump_stats()
            bad = [st[k] for k in ("Late_tuples_dropped",
                                   "Pane_cells_evicted",
                                   "Windows_dropped_on_overflow")]
            if bad != [0, 0, 0]:
                fail(f"{label}: late / evicted / dropped {bad}")
            if any(counts.values()):
                # K*NP+1 (key, pane) ids beyond the kernel gate: the sort
                fail(f"{label} launched a kernel off its path: {counts}")
            extra = f"; ring NP {win.NP}"
        else:
            nrec = check_cb_columns(label, cols,
                                    keys32 if kind == "frames" else dk,
                                    vals if kind == "frames" else dv)
            need = ("grouping_rank_hist", "sliding_fold") if sum_comb \
                else ("grouping_rank_hist",)
            for name in need:
                if counts[name] <= 0:
                    fail(f"{label} never launched {name}")
            if sum_comb and counts["sliding_fold"] != COL_BATCHES:
                fail(f"{label} launched sliding_fold "
                     f"{counts['sliding_fold']} times in {COL_BATCHES} steps")
            extra = ""
        if kind != "device":
            staged_only_packed(label, src, COL_BATCHES)
            extra += f"; {COL_BATCHES} packed batches, no record batch"
        print(f"phase 5: PipeGraph.run() {label}: {nrec} windows match the "
              f"oracle; {n} tuples in {secs:.3f} s = {n / secs:.0f} "
              f"tuples/s (host clock, information only); launches "
              f"{counts}{extra}")
    float_sum_repeats(dev_name)
    return out


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
    rows = check_grouping(dev) + check_grouping_tb(dev) + check_fold(dev) \
        + check_table(dev)
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
        if sum_comb and counts["sliding_fold"] != BATCHES:
            fail(f"the sum combiner's run launched sliding_fold "
                 f"{counts['sliding_fold']} times in {BATCHES} steps")
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
    # 4. the time-window runs, counts read just after each run
    run_counts.update(tb_runs())
    # 5. the columnar ingest runs, counts read just after each run
    run_counts.update(columnar_runs())
    if "jax" in sys.modules or "windflow_tpu" in sys.modules:
        fail("JAX or the JAX package was imported")
    # each kernel row's launches: the runs that make its calls (the
    # table's (e) runs make the calls of routes (a) and (c))
    cb_runs = ("ffat generic", "ffat sum", "(i) frames generic",
               "(i) frames sum", "(iii) device source generic",
               "(iii) device source sum")
    runs_of = {"grouping_rank_hist": cb_runs,
               "grouping_rank_hist[tb]": ("(c) grouping kernel",),
               "sliding_fold[dense]": cb_runs,
               "sliding_fold[main]": cb_runs,
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
