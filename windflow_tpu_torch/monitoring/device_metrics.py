"""Device-plane gauges (the port of ``windflow_tpu/monitoring/
device_metrics.py``): the ``"Device"`` section of ``PipeGraph.stats()``.

* **jit** — the step registry's per-op table and totals
  (``monitoring/jit_registry.py``: step dispatches, CUDA graph captures
  and recaptures).
* **memory** — ``torch.cuda.memory_stats`` per CUDA device: bytes
  allocated and reserved, their peaks, allocation retries and OOMs, and
  the device's capacity.  A CPU graph has no allocator stats: one
  ``cpu`` entry with ``stats: None`` (the JAX package's CPU guard).
* **live_buffers** — the caching allocator's active blocks and bytes per
  CUDA device (PyTorch keeps no registry of live tensors, the counterpart
  of ``jax.live_arrays``); none on the CPU.
* **staging** — the staging plane's accounting: bytes copied host→device
  (``staging.device_bytes``, wire and decoded), batches staged, and the
  host bytes the staging pools retain, so device growth and host-pool
  growth tell apart at a glance.

Everything here runs at stats cadence, never per batch; the allocator
reads are host-side counters (no device synchronisation).
"""

from __future__ import annotations

from typing import Optional

#: torch.cuda.memory_stats keys -> the section's names
_MEMORY_KEYS = (("allocated_bytes.all.current", "bytes_in_use"),
                ("allocated_bytes.all.peak", "peak_bytes_in_use"),
                ("reserved_bytes.all.current", "bytes_reserved"),
                ("reserved_bytes.all.peak", "peak_bytes_reserved"),
                ("num_alloc_retries", "num_alloc_retries"),
                ("num_ooms", "num_ooms"))


def _cuda_devices(graph) -> list:
    """Indices of the CUDA devices to report: the graph's card, or every
    card without a graph; none for a CPU graph."""
    import torch
    dev = getattr(graph, "device", None)
    if dev is not None:
        if dev.type != "cuda":
            return []
        return [dev.index if dev.index is not None
                else torch.cuda.current_device()]
    if not torch.cuda.is_available():
        return []
    return list(range(torch.cuda.device_count()))


def memory_stats_per_device(graph=None) -> list:
    """Allocator gauges per CUDA device; ``stats=None`` for the CPU."""
    import torch
    idx = _cuda_devices(graph)
    if not idx:
        return [{"device": "cpu", "platform": "cpu", "stats": None}]
    out = []
    for i in idx:
        raw = torch.cuda.memory_stats(i)
        stats = {name: int(raw.get(key, 0)) for key, name in _MEMORY_KEYS}
        stats["bytes_limit"] = int(
            torch.cuda.get_device_properties(i).total_memory)
        out.append({"device": f"cuda:{i}", "platform": "cuda",
                    "name": torch.cuda.get_device_name(i), "stats": stats})
    return out


def live_buffer_gauges(graph=None) -> dict:
    """Active allocator blocks and their bytes, per CUDA device."""
    import torch
    idx = _cuda_devices(graph)
    if not idx:
        return {"count": 0, "bytes": 0, "per_device": {},
                "note": "no CUDA device: live buffers are the caching "
                        "allocator's, which a CPU graph does not use"}
    per_device = {}
    for i in idx:
        raw = torch.cuda.memory_stats(i)
        per_device[f"cuda:{i}"] = {
            "count": int(raw.get("active.all.current", 0)),
            "bytes": int(raw.get("active_bytes.all.current", 0))}
    return {"count": sum(v["count"] for v in per_device.values()),
            "bytes": sum(v["bytes"] for v in per_device.values()),
            "per_device": per_device}


def device_section(graph: Optional[object] = None) -> dict:
    """The ``stats()["Device"]`` payload.  The registry, the allocator
    and the staging gauges are process-scoped; ``graph`` picks the card
    and the profiler pointer."""
    from windflow_tpu_torch import staging
    from windflow_tpu_torch.monitoring.jit_registry import default_registry
    reg = default_registry()
    section = {
        "jit": reg.snapshot(),
        "jit_totals": reg.totals(),
        "memory": memory_stats_per_device(graph),
        "live_buffers": live_buffer_gauges(graph),
        "staging": {
            "pool_host_held_bytes": staging.pools_stats()["held_bytes"],
            "staged_device_bytes_total":
                staging.device_bytes.staged_bytes_total,
            "staged_logical_bytes_total":
                staging.device_bytes.logical_bytes_total,
            "staged_device_batches_total":
                staging.device_bytes.staged_batches_total,
        },
    }
    if graph is not None:
        cfg = getattr(graph, "config", None)
        section["profiler_dir"] = getattr(cfg, "profiler_dir", "") or None
    return section
