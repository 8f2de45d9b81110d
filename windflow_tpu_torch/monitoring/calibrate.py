"""Probe the card and write calibration.json (the port of the probe half
of ``tools/wf_calibrate.py``).

The roofline's ceiling, the tenant ledger's modeled columns and the
sampled-wait cost read constants (``calibration.MODELED_DEFAULTS``) that
are spec sheets or guesses until measured.  This module measures them
with a short seeded probe suite on the device this process has and
writes a versioned ``calibration.json`` keyed by device kind.  Point
``Config.calibration`` / ``WF_TPU_CALIBRATION`` at the file and every
read site's provenance flips from ``modeled`` to ``calibrated(<age>)``
until the file goes stale or the device kind changes.

Probes, each timed by CUDA events on the card (the host clock on the
CPU) and reported as the median of its repetitions:

* ``h2d_tunnel_bytes_per_sec`` — one pinned 262,144-tuple staging pack
  (the ``PackedBatchBuilder`` buffer the runtime stages through) copied
  host to device non-blocking;
* ``dispatch_overhead_usec`` — host wall of one tiny kernel launch;
* ``sampled_sync_usec`` — an event record and synchronize behind a tiny
  kernel (what the flight recorder's sampled ``device_done`` pays);
* ``hbm_bytes_per_sec`` — an elementwise read and write over at least
  1 GiB (bytes = twice the array);
* ``kernel_step_usec`` — the CB FFAT step at ``bench.py``'s
  ``CONFIGS["tpu"]`` shape (262,144 tuples, 1,024 keys, windows of
  1,024 sliding by 128) with a declared sum, so the grouping and fold
  kernels launch;
* ``ici_bytes_per_sec`` — a psum over a ``(data, key)`` mesh of
  ``mesh_positions`` positions (``parallel/mesh.py``), priced by the
  ring all-reduce's ~2(N-1)/N of the payload a position, JAX's formula.
  Off by default (``calibration.MESH_ONLY_KEYS``): ``--mesh-positions N``
  turns it on.  The positions are the visible cards, or the probed
  device repeated when fewer are visible: a logical mesh on one card,
  whose "ICI" is then a copy between positions sharing its memory, not a
  link; the probe's detail says which it measured.

The file keeps the JAX package's schema and its required
``jax_version`` field, filled with ``"torch <version>"``, with
``torch_version`` beside it, so ``tools/wf_calibrate.py --check``
validates it unchanged.

Usage::

    python -m windflow_tpu_torch.monitoring.calibrate --out calibration.json
    python -m windflow_tpu_torch.monitoring.calibrate --check calibration.json
        # exit 0 fresh and valid, 1 stale/corrupt/missing, 2 kill switch
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Optional

import numpy as np

from windflow_tpu_torch.monitoring import calibration as calib

#: the bench shape of the staging and step probes
CAP, KEYS, WIN, SLIDE = 262_144, 1_024, 1_024, 128
#: bytes of the bandwidth probe's array on the card (the CPU takes less)
HBM_BYTES_CUDA = 1 << 30
HBM_BYTES_CPU = 64 << 20


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


class _Timer:
    """Elapsed milliseconds of a block: CUDA events on the card, the host
    clock on the CPU."""

    def __init__(self, device) -> None:
        self.cuda = device.type == "cuda"

    def __call__(self, fn: Callable[[], None]) -> float:
        import torch
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def probe_h2d(device, reps: int = 7, cap: int = CAP):
    """Host-to-device rate of one packed staging buffer."""
    import torch

    from windflow_tpu_torch import staging
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 20, cap).astype(np.int32)
    vals = rng.random(cap, dtype=np.float32)
    tss = np.arange(cap, dtype=np.int64)
    pool = staging.pool_for(device)
    b = staging.PackedBatchBuilder([np.int32, np.float32], cap, pool)
    b.append([keys, vals], tss)
    buf = b.finish()
    host = torch.from_numpy(buf.view(np.int32))
    dst = torch.empty(host.shape, dtype=torch.int32, device=device)
    timer = _Timer(device)
    dst.copy_(host, non_blocking=True)          # first touch off the clock
    _sync(device)
    rates = []
    for _ in range(reps):
        ms = timer(lambda: dst.copy_(host, non_blocking=True))
        rates.append(host.numel() * 4 / (ms / 1e3))
    pool.release(buf, None)
    return _median(rates), {"buffer_bytes": int(host.numel() * 4),
                            "pinned": bool(pool.pinned), "reps": reps}


def probe_dispatch(device, reps: int = 200):
    """Host wall of one tiny kernel launch (µs), the launches queued
    back to back and the wait for them left off the clock."""
    import torch
    x = torch.zeros(8, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    torch.add(x, 1.0, out=y)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.add(x, 1.0, out=y)
    usec = (time.perf_counter() - t0) * 1e6 / reps
    _sync(device)
    return usec, {"reps": reps}


def probe_sync(device, reps: int = 50):
    """One event record and synchronize behind a tiny kernel (µs)."""
    import torch

    from windflow_tpu_torch.ops.gpu import wait_for_device
    x = torch.zeros(8, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ts = []
    for _ in range(reps):
        torch.add(x, 1.0, out=y)
        t0 = time.perf_counter()
        wait_for_device(y)
        ts.append((time.perf_counter() - t0) * 1e6)
    return _median(ts), {"reps": reps}


def probe_hbm(device, reps: int = 7, nbytes: Optional[int] = None):
    """Memory bandwidth of an elementwise read and write of one array."""
    import torch
    if nbytes is None:
        nbytes = HBM_BYTES_CUDA if device.type == "cuda" else HBM_BYTES_CPU
    n = nbytes // 4
    x = torch.ones(n, dtype=torch.float32, device=device)
    out = torch.empty_like(x)
    timer = _Timer(device)
    torch.mul(x, 1.0000001, out=out)
    _sync(device)
    rates = []
    for _ in range(reps):
        ms = timer(lambda: torch.mul(x, 1.0000001, out=out))
        rates.append(2 * n * 4 / (ms / 1e3))
    del x, out
    return _median(rates), {"array_bytes": int(n * 4), "reps": reps}


def probe_kernel_step(device, reps: int = 5, steps: int = 10,
                      cap: int = CAP, keys: int = KEYS):
    """One CB FFAT step with a declared sum (µs a step) through the
    kernels; the detail counts their launches a step."""
    import math

    import torch

    from windflow_tpu_torch.kernels import ffat_cuda
    from windflow_tpu_torch.windows.ffat_kernels import (make_ffat_state,
                                                         make_ffat_step)
    pn = math.gcd(WIN, SLIDE)
    R, D = WIN // pn, SLIDE // pn
    step = make_ffat_step(cap, keys, pn, R, D, lambda t: t["v"],
                          lambda a, b: a + b, lambda t: t["k"],
                          monoid="sum", kernels=True)
    rng = np.random.default_rng(1)
    payload = {
        "k": torch.from_numpy(rng.integers(0, keys, cap).astype(np.int32))
        .to(device),
        "v": torch.from_numpy(rng.random(cap, dtype=np.float32)).to(device),
    }
    tss = torch.arange(cap, dtype=torch.int64, device=device)
    valid = torch.ones(cap, dtype=torch.bool, device=device)
    st = make_ffat_state(torch.zeros((), dtype=torch.float32), keys, R,
                         device=device)
    for _ in range(2):                        # warm, off the clock
        st, _out, _valid, _ts = step(st, payload, tss, valid)
    _sync(device)
    timer = _Timer(device)
    before = ffat_cuda.launch_counts()
    box = [st]

    def run():
        for _ in range(steps):
            box[0] = step(box[0], payload, tss, valid)[0]
    ts = [timer(run) * 1e3 / steps for _ in range(reps)]
    after = ffat_cuda.launch_counts()
    per_step = {k: (after[k] - before[k]) / (reps * steps) for k in after
                if after[k] != before[k]}
    return _median(ts), {"cap": cap, "keys": keys, "win": WIN,
                         "slide": SLIDE, "monoid": "sum", "reps": reps,
                         "steps": steps, "kernel_launches_per_step":
                         per_step}


def probe_ici(device, positions: int = 4, reps: int = 7,
              n: int = 1 << 20):
    """The mesh collective's rate: a psum of ``n`` float32 a position
    over ``positions`` mesh positions, bytes counted as the ring
    all-reduce's ``2(N-1)/N`` of the payload a position.  The positions
    are the visible cards of ``device``'s type, or ``device`` repeated
    (a logical mesh) when fewer are visible."""
    import torch

    from windflow_tpu_torch.parallel import mesh as M
    if device.type == "cuda" and torch.cuda.device_count() >= positions:
        devs = [torch.device("cuda", i) for i in range(positions)]
    else:
        devs = [device] * positions
    mesh = M.make_mesh(positions, devices=devs)
    grid = {p: torch.ones(n, dtype=torch.float32,
                          device=mesh.device_of(p))
            for p in mesh.local_positions}
    timer = _Timer(device)
    M.psum(grid, mesh, M.AXES)
    _sync(device)
    moved = 2 * (positions - 1) / positions * n * 4 * positions
    rates = []
    for _ in range(reps):
        ms = timer(lambda: M.psum(grid, mesh, M.AXES))
        rates.append(moved / (ms / 1e3))
    distinct = len({str(d) for d in devs})
    return _median(rates), {
        "positions": positions, "devices": sorted({str(d) for d in devs}),
        "payload_bytes": n * 4, "reps": reps,
        "measured": ("a copy between logical mesh positions sharing one "
                     "device's memory (not a link)") if distinct == 1
        else "a copy between distinct devices"}


PROBES = (
    ("h2d_tunnel_bytes_per_sec", probe_h2d),
    ("dispatch_overhead_usec", probe_dispatch),
    ("sampled_sync_usec", probe_sync),
    ("hbm_bytes_per_sec", probe_hbm),
    ("kernel_step_usec", probe_kernel_step),
)


def run_probes(device=None, overrides: Optional[dict] = None,
               log=print, mesh_positions: int = 0) -> dict:
    """Run every probe on ``device`` (default: the card when one is
    visible, else the CPU) and return the calibration document.  A probe
    that raises leaves its key out and its error in ``probes``.
    ``overrides`` maps a probe key to keyword arguments (tests shrink
    the shapes on the CPU); ``mesh_positions >= 2`` adds the mesh
    collective probe (:func:`probe_ici`)."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    constants, probes = {}, {}
    for key, fn in PROBES:
        try:
            value, detail = fn(device, **(overrides or {}).get(key, {}))
        except Exception as e:  # lint: broad-except-ok (one dead
            # probe keeps the others; its key stays modeled and the
            # detail says why)
            probes[key] = {"error": f"{type(e).__name__}: {e}"[:200]}
            log(f"calibrate: note: probe {key} failed "
                f"({type(e).__name__}: {e})")
            continue
        probes[key] = detail
        constants[key] = round(float(value), 3)
        log(f"calibrate: {key} = {constants[key]}")
    if mesh_positions >= 2:
        try:
            value, detail = probe_ici(device, mesh_positions,
                                      **(overrides or {}).get(
                                          "ici_bytes_per_sec", {}))
            probes["ici_bytes_per_sec"] = detail
            constants["ici_bytes_per_sec"] = round(float(value), 3)
            log(f"calibrate: ici_bytes_per_sec = "
                f"{constants['ici_bytes_per_sec']} ({detail['measured']})")
        except Exception as e:  # lint: broad-except-ok (as above)
            probes["ici_bytes_per_sec"] = {
                "error": f"{type(e).__name__}: {e}"[:200]}
    else:
        probes["ici_bytes_per_sec"] = {
            "note": "no mesh asked for (--mesh-positions): skipped"}
    return {
        "schema": calib.SCHEMA,
        "recorded_at": time.time(),
        "device_kind": kind,
        "backend": device.type,
        "jax_version": "torch " + torch.__version__,
        "torch_version": torch.__version__,
        "constants": constants,
        "probes": probes,
    }


def calibrate(out_path: str, device=None, log=print,
              mesh_positions: int = 0) -> int:
    """Probe and write ``out_path``; 0 on success, 1 when every probe
    failed, 2 under the kill switch."""
    if calib.killed():
        log("calibrate: FAIL: WF_TPU_CALIBRATION=0 — the kill switch is "
            "on; unset it to calibrate")
        return 2
    doc = run_probes(device, log=log, mesh_positions=mesh_positions)
    if not doc["constants"]:
        log("calibrate: FAIL: every probe failed — nothing to write")
        return 1
    store = calib.CalibrationStore(doc, path=out_path)
    with open(out_path, "w") as f:
        json.dump(store.to_json(), f, indent=2)
        f.write("\n")
    log(f"calibrate: wrote {out_path} ({len(doc['constants'])} "
        f"constant(s) for {doc['device_kind']}, {doc['jax_version']})")
    return 0


def check(path: str, log=print) -> int:
    """Validate a store: 0 fresh and valid, 1 stale/corrupt/missing, 2
    under the kill switch."""
    if calib.killed():
        log("calibrate: kill switch (WF_TPU_CALIBRATION=0) — calibration "
            "disabled process-wide")
        return 2
    try:
        store = calib.load(path)
    except calib.CalibrationError as e:
        log(f"calibrate: FAIL: {path}: {e}")
        return 1
    age = store.age_s()
    if not store.fresh():
        log(f"calibrate: FAIL: {path} is {age / 86400:.1f} days old (TTL "
            f"{calib.TTL_S / 86400:.1f}d) — re-run the probes")
        return 1
    missing = [k for k in calib.MODELED_DEFAULTS
               if k not in store.constants and k not in calib.MESH_ONLY_KEYS]
    note = f", {len(missing)} key(s) still modeled: {missing}" \
        if missing else ""
    log(f"calibrate: OK ({path}: {len(store.constants)} constant(s) for "
        f"{store.device_kind}, {store.jax_version}, age "
        f"{age / 3600:.1f}h{note})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m windflow_tpu_torch.monitoring.calibrate",
        description="Probe the device and write calibration.json.")
    ap.add_argument("--out", default="calibration.json",
                    help="output path (default ./calibration.json)")
    ap.add_argument("--check", nargs="?", const="", metavar="PATH",
                    help="validate an existing store instead of probing "
                         "(default: --out, then WF_TPU_CALIBRATION)")
    ap.add_argument("--mesh-positions", type=int, default=0,
                    help="probe the mesh collective over N positions "
                         "(ici_bytes_per_sec; the visible cards, or the "
                         "device repeated when fewer are visible)")
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr if "FAIL" in msg or "kill switch" in msg
              else sys.stdout)
    if args.check is not None:
        path = args.check or os.environ.get("WF_TPU_CALIBRATION") \
            or args.out
        return check(path, log)
    return calibrate(args.out, log=log, mesh_positions=args.mesh_positions)


if __name__ == "__main__":
    sys.exit(main())
