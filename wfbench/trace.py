"""Reduces a ``torch.profiler`` capture of the traced window to the
numbers the per-layer metrics and the result's ``breakdown`` read: the
device's busy time (the union of its operations' intervals), kernel time
and counts by name, host-side call counts by name, and the idle gaps,
each named by the innermost host span open at its middle."""

from __future__ import annotations

import collections

import numpy as np

#: the host span the harness records around each scheduler sweep
STEP_SPAN = "wfbench:step"
#: gaps shorter than this are the device's own launch spacing
MIN_GAP_NS = 5_000
#: gaps named one by one (the longest); the rest are left out
NAMED_GAPS = 4096
#: host spans looked at, back from a gap's middle
SCAN = 4096


def warm_up(cuda: bool) -> None:
    """Profiles one small operation, so that the profiler's first start
    (its device tracer's set-up, seconds on a card) falls in set-up and
    not in the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])):
        x = torch.ones(1024, device="cuda" if cuda else "cpu")
        (x + 1).sum().item()


def _ns(e, end=False):
    try:
        return e.end_ns() if end else e.start_ns()
    except AttributeError:      # older torch: microseconds
        return int(1000 * (e.end_us() if end else e.start_us()))


def _on_device(e) -> bool:
    return str(e.device_type()).split(".")[-1].upper() in ("CUDA", "GPU")


def _short(name: str) -> str:
    # record_function("op:<name> trace:<id>"): one name an operator
    return name.split(" trace:")[0][:160]


def reduce(prof, window_s: float) -> dict:
    """``prof``: a stopped ``torch.profiler.profile``; ``window_s``: the
    traced window on the host clock."""
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        (dev if _on_device(e) else cpu).append((e.name(), _ns(e),
                                                _ns(e, True)))
    # a host span's mirror on the device's timeline (record_function)
    # carries the host span's name and does no work
    host_names = {n for n, _, _ in cpu}
    dev = [d for d in dev if d[0] not in host_names]
    kernel_s = 0.0
    kernels = collections.Counter()
    by_op = collections.Counter()
    for name, a, b in dev:
        by_op[_short(name)] += (b - a) / 1e9
        if not name.startswith(("Memcpy", "Memset")):
            kernels[name] += 1
            kernel_s += (b - a) / 1e9
    busy_s, gaps = 0.0, []
    if dev:
        iv = np.array([(a, b) for _, a, b in dev], np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        # merged intervals: a new one starts where every earlier has ended
        first = np.flatnonzero(np.r_[True, iv[1:, 0] > ends[:-1]])
        starts = iv[first, 0]
        stops = ends[np.r_[first[1:] - 1, len(iv) - 1]]
        busy_s = float((stops - starts).sum()) / 1e9
        g_lo, g_hi = stops[:-1], starts[1:]
        if cpu:
            # the window's edges: the first and last host span traced
            g_lo = np.r_[min(a for _, a, _ in cpu), g_lo, stops[-1]]
            g_hi = np.r_[starts[0], g_hi, max(b for _, _, b in cpu)]
        keep = (g_hi - g_lo) >= MIN_GAP_NS
        gaps = list(zip(g_lo[keep].tolist(), g_hi[keep].tolist()))
    return {
        "window_s": float(window_s),
        "busy_s": busy_s,
        "kernel_s": kernel_s,
        "kernel_counts": dict(kernels),
        "call_counts": dict(collections.Counter(n for n, _, _ in cpu)),
        "device_ops": [[n, s] for n, s in by_op.most_common(10)],
        "idle_gaps": [[n, s] for n, s in
                      _name_gaps(gaps, cpu).most_common(10)],
    }


def _name_gaps(gaps, cpu) -> collections.Counter:
    """Idle seconds by the innermost host span open at each gap's middle
    (the longest ``NAMED_GAPS`` gaps)."""
    out = collections.Counter()
    cpu = sorted(cpu, key=lambda e: e[1])
    starts = np.array([a for _, a, _ in cpu], np.int64)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:NAMED_GAPS]:
        mid = (a + b) // 2
        name = "host outside any traced span"
        i = int(np.searchsorted(starts, mid, side="right")) - 1
        # nested spans of one thread: scanning back from the last start
        # before the middle, the first span still open is the innermost
        for j in range(i, max(-1, i - SCAN), -1):
            if cpu[j][2] >= mid:
                name = cpu[j][0]
                break
        if name == STEP_SPAN:
            name = "host in a sweep, outside any torch call"
        out[_short(name)] += (b - a) / 1e9
    return out
