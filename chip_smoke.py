#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each exits nonzero on failure; none is skipped):

1. build every CUDA kernel of the port from ``windflow_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain torch version on the card, at the
   main path's shapes and at the edges (exact), and time the kernel, the
   plain version and one PyTorch call computing the same function (a
   yardstick only: the port never calls it), with CUDA events;
3. drive the main path — ``PipeGraph.run()`` of Source → MapGPU →
   FilterGPU → Ffat_WindowsGPU (count windows, keyed) → Sink at the
   repo's chip configuration (262,144 tuples a batch, 1,024 keys, windows
   of 1,024 sliding by 128, 8 batches) — once with the generic combiner
   and once with ``withSumCombiner()``; check every fired window against
   a numpy oracle and that each kernel of the path was launched.

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


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_grouping(dev):
    """Grouping kernel vs its plain version: main shape + edges, exact."""
    import torch
    from windflow_tpu_torch.kernels import ffat_cuda as fc
    from windflow_tpu_torch.windows.grouping import invert_perm
    rng = np.random.default_rng(7)
    worst = 0
    cases = [(CAP, KEYS + 1), (1000, 2), (CAP + 77, 4096), (255, 4096),
             (257, 129)]
    for B, NB in cases:
        ids = torch.from_numpy(rng.integers(0, NB, B).astype(np.int32)).to(dev)
        got = fc.grouping_rank_hist(ids, NB)
        torch.cuda.synchronize()
        want = fc.grouping_rank_hist_plain(ids, NB)
        for name, g, w in zip(("dest", "rank", "hist"), got, want):
            worst = max(worst, (g.long() - w.long()).abs().max().item())
            if not torch.equal(g, w):
                fail(f"grouping_rank_hist {name} differs at B={B} NB={NB}")
        order = invert_perm(got[0])
        if not torch.equal(order.long(), torch.sort(ids, stable=True).indices):
            fail(f"order_hist is not the stable argsort at B={B} NB={NB}")
    ids = torch.from_numpy(
        rng.integers(0, KEYS + 1, CAP).astype(np.int32)).to(dev)
    NB = KEYS + 1
    ms = cuda_time(lambda: fc.grouping_rank_hist(ids, NB))
    plain_ms = cuda_time(lambda: fc.grouping_rank_hist_plain(ids, NB))
    lib_ms = cuda_time(lambda: (torch.sort(ids, stable=True),
                                torch.bincount(ids, minlength=NB)))
    nbytes = CAP * 4 + 2 * CAP * 4 + NB * 4
    # one count and one rank per lane, plus the within-tile compares
    nops = 2 * CAP + CAP * (fc.LANE_TILE - 1) // 2
    b_ms, b_by = bound_ms(nbytes, nops)
    return {"name": "grouping_rank_hist", "route": "cuda",
            "source": "windflow_tpu_torch/csrc/grouping_rank_hist.cu",
            "replaces": "windflow_tpu/kernels/pallas_ffat.py:214",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


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
    ms = cuda_time(lambda: fc.sliding_fold(x, valid, R, "sum"))
    plain_ms = cuda_time(lambda: fc.fold_leaf_plain(x, valid, R, "sum"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = torch.ones((1, 1, R), dtype=torch.float32, device=dev)

    def conv_sum():
        xin = torch.where(valid, x, 0.0)[:, None, :]
        return F.conv1d(F.pad(xin, (R - 1, 0)), w)
    lib_ms = cuda_time(conv_sum)
    pool_ms = cuda_time(lambda: F.max_pool1d(
        F.pad(torch.where(valid, x, float("-inf"))[:, None, :], (R - 1, 0),
              value=float("-inf")), R, stride=1))
    if not torch.allclose(conv_sum()[:, 0], fc.sliding_fold(x, valid, R, "sum"),
                          rtol=1e-5, atol=1e-5):
        fail("conv1d yardstick disagrees with the fold")
    n = KEYS * NPP
    levels = R.bit_length()
    nops = n * (levels - 1 + bin(R).count("1") - 1)
    b_ms, b_by = bound_ms(n * 4 + n * 1 + n * 4, nops)
    print(f"fold yardstick: conv1d sum {lib_ms:.4f} ms, max_pool1d max "
          f"{pool_ms:.4f} ms at [{KEYS}, {NPP}] R={R}")
    return {"name": "sliding_fold", "route": "cuda",
            "source": "windflow_tpu_torch/csrc/sliding_fold.cu",
            "replaces": "windflow_tpu/kernels/pallas_ffat.py:407",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


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


def main_path_data(n, seed=2024):
    """``n`` records of the main path: int32 keys in [0, KEYS) and
    integer-valued float32 values (every window sum is exact)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, KEYS, n).astype(np.int32)
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
    rows = {r["name"]: r for r in (check_grouping(dev), check_fold(dev))}
    print("phase 2: kernels equal their plain versions at the main-path "
          "shapes and edges")

    # 3. the main path, counts read just after each run
    launches = {name: 0 for name in rows}
    for sum_comb, need in ((False, ("grouping_rank_hist",)),
                           (True, ("grouping_rank_hist", "sliding_fold"))):
        fc.reset_launch_counts()
        nrec, secs, n = run_main_path("cuda", sum_comb)
        counts = fc.launch_counts()
        for name in need:
            if counts[name] <= 0:
                fail(f"main path ({'sum' if sum_comb else 'generic'} "
                     f"combiner) never launched {name}")
        for name in launches:
            launches[name] += counts[name]
        print(f"phase 3: PipeGraph.run() {'withSumCombiner' if sum_comb else 'generic combiner'}: "
              f"{nrec} windows match the oracle; {n} tuples in {secs:.3f} s "
              f"= {n / secs:.0f} tuples/s (host clock, information only); "
              f"launches {counts}")
    for name, r in rows.items():
        r["launches"] = launches[name]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
