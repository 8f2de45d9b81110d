"""One run of one cell: set-up, the measured window, the drain, the
comparison with the reference, and the result line's numbers.

The cell ``<config>.<traffic>`` names ``configs/<config>.json`` and
``configs/<config>.py`` (the graph), ``reference/<config>.py`` and
``traffic/<traffic>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  Nothing here names a configuration, a mix or
a metric: a later cell adds files and ``BENCHMARK.json`` entries only.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import time
from types import SimpleNamespace

import numpy as np

from wfbench import generator, trace as tracing

HERE = os.path.dirname(os.path.abspath(__file__))
#: the traced window: its length and its start after the window's start
TRACE_SECONDS = 2.0
TRACE_OFFSET = 1.0 / 3.0


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str):
    """The cell's workload entry, its configuration entry, and the
    end-to-end and per-layer metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return cell, conf, mine(bench["end_to_end"]), mine(bench["per_layer"])


def load_cell(root, name, cfg_override=None, traffic_override=None):
    """Everything a run of cell ``name`` reads before it draws its data:
    its entries, the configuration's and the mix's parameters (updated by
    the overrides: the CPU tests' sizes), the configuration's module and
    its reference."""
    cell, conf, e2e, layers = cell_spec(load_bench(root), name)
    with open(os.path.join(root, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    cfg.update(cfg_override or {})
    traffic.update(traffic_override or {})
    return SimpleNamespace(
        cell=cell, e2e=e2e, layers=layers, cfg=cfg, traffic=traffic,
        mod=importlib.import_module(f"wfbench.configs.{cell['config']}"),
        ref=importlib.import_module(f"wfbench.reference.{cell['config']}"))


def draw(c, seed):
    """The seed's tables and log: the same seed, the same data."""
    rng = np.random.default_rng(seed)
    tables = c.mod.draw(c.cfg, rng)
    return tables, generator.draw_pool(c.cfg["record"], c.traffic, rng)


def run_cell(root, name, seed, seconds, trace, device="cuda",
             t_process=None, cfg_override=None, traffic_override=None):
    """Runs cell ``name`` once; returns ``(result, checks, info)``: the
    result line's dict, ``{name: (value, limit)}`` of the comparison, and
    what the run saw besides (stderr)."""
    t0 = time.perf_counter() if t_process is None else t_process
    c = load_cell(root, name, cfg_override, traffic_override)
    cell, cfg, traffic, mod, ref = c.cell, c.cfg, c.traffic, c.mod, c.ref

    import torch
    import windflow_tpu_torch as wt
    marks = {"imports": time.perf_counter() - t0}

    tables, pool = draw(c, seed)
    keys, values = pool["key"], pool["v"]    # never changed by the replay
    stream = generator.ChunkStream(pool, traffic,
                                   cfg["warmup_batches"] * cfg["batch"],
                                   seconds)
    marks["data"] = time.perf_counter() - t0

    got, receipts = [], []

    def sink(delivery, ctx=None):
        if delivery is not None:
            receipts.append((time.perf_counter(), len(delivery)))
            got.append(mod.collect(delivery.cols, delivery.tss))

    # the deployment's settings of the program, beside its sizes
    config = wt.Config(device=device,
                       log_dir=os.path.join(root, "log", "wfbench"),
                       **cfg.get("program_config", {}))
    g = mod.build(cfg, tables, stream, sink, config)
    cuda = torch.device(device).type == "cuda"
    if trace:
        tracing.warm_up(cuda)
        marks["profiler"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    marks["build"] = time.perf_counter() - t0
    g.start()
    marks["start"] = time.perf_counter() - t0
    tr = _drive(g, stream, cfg["batch"], cuda,
                TRACE_OFFSET * seconds if trace else None,
                min(TRACE_SECONDS, seconds / 3))
    g.wait_end()                   # end of stream: drain to the sink
    if cuda:
        torch.cuda.synchronize()
    t_done = time.perf_counter()
    t_start = stream.t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats = g.stats()
    megastep = stats["Megastep"]
    del g
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the comparison, after the window and with the graph freed ----
    cols = tuple(np.concatenate(a) for a in zip(*got)) if got else None
    got.clear()
    checks, index, due = ref.check(cfg, tables, keys, values, stream.gap,
                                   stream.records, cols)
    mismatched = sum(v for v, _ in checks.values())
    correct = all(v <= lim for v, lim in checks.values())

    # -- end-to-end metrics -------------------------------------------
    t_got = np.repeat([t for t, _ in receipts], [n for _, n in receipts])
    chunk = stream.chunk_of(np.maximum(index, 0))
    timed = (index >= 0) & (chunk >= stream.warmup_chunks)
    lat_ms = (t_got[timed] - stream.handed[chunk[timed]]) * 1e3
    window = t_done - t_start
    values_e2e = {
        "throughput": stream.window_records / window,
        "latency_p50_ms": float(np.percentile(lat_ms, 50))
        if len(lat_ms) else None,
        "latency_p95_ms": float(np.percentile(lat_ms, 95))
        if len(lat_ms) else None,
        "setup_s": t_start - t0,
    }
    kind = torch.cuda.get_device_name() if cuda else "cpu"
    device_out = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(due),
              "failed": int(mismatched)}
    if not trace:
        result["metrics"] = {m["name"]: {"value": values_e2e[m["name"]],
                                         "unit": m["unit"]}
                             for m in c.e2e
                             if values_e2e.get(m["name"]) is not None}
        result["device"] = device_out
    else:
        summary = tracing.reduce(tr["prof"], tr["window_s"]) \
            if "prof" in tr else None
        run = SimpleNamespace(cfg=cfg, traffic=traffic, cell=cell, module=mod,
                  stats=stats, trace=summary,
                  trace_batches=tr.get("batches", 0.0),
                  tuples=stream.records, kind=kind, pool=pool,
                  device=device,
                  results_per_batch=len(index) * cfg["batch"]
                  / max(1, stream.records))
        out = {}
        for m in c.layers:
            reader = importlib.import_module(f"wfbench.metrics.{m['name']}")
            v = reader.read(run)
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = out
        device_out["busy_s"] = summary["busy_s"] if summary else 0.0
        device_out["window_s"] = summary["window_s"] if summary else 0.0
        result["device"] = device_out
        if summary:
            top = sorted(summary["kernel_counts"].items(),
                         key=lambda kv: -kv[1])[:8]
            tr["kernels"] = [sum(summary["kernel_counts"].values()),
                             [[k[:80], v] for k, v in top]]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    info = {"window_s": window, "window_records": stream.window_records,
            "results": len(index),
            "timed_results": int(timed.sum()),
            "megastep": megastep, "setup_marks_s": marks,
            "trace_kernels": tr.get("kernels"),
            "trace_batches": tr.get("batches"),
            "trace_start_s": tr.get("start_s"),
            "drain_s": t_done - stream.handed[stream.chunks - 1],
            "warmup_stalls": _stalls(stream),
            "chunks_per_s": _rates(stream),
            "after_window_s": time.perf_counter() - t_done}
    return result, checks, info


def _drive(g, stream, batch, cuda, trace_at, trace_s):
    """Steps the started graph until the generator ends the window.  With
    ``trace_at`` (seconds after the window's start), ``torch.profiler``
    records ``trace_s`` seconds of it; returns the capture, its length and
    the batches handed over in it, or ``{}``."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    tr, prof = {}, None
    while stream.stop_at is None:
        now = time.perf_counter()
        if trace_at is not None and not tr and stream.t_start is not None \
                and now - stream.t_start >= trace_at:
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []))
            prof.start()
            t = time.perf_counter()
            tr = {"t": t, "chunk": stream.chunks, "start_s": t - now}
        if prof is None:
            progress = g.step()
        else:
            with record_function(tracing.STEP_SPAN):
                progress = g.step()
            now = time.perf_counter()
            if now - tr["t"] >= trace_s:
                prof.stop()
                tr.update(prof=prof, window_s=now - tr["t"], batches=(
                    stream.records - stream.records_before(tr["chunk"]))
                    / batch)
                prof = None
        if not progress:
            raise RuntimeError("the graph made no progress")
    return tr


def _stalls(stream, over=0.25):
    """``[chunk, seconds]`` of the set-up's waits between two handovers
    longer than ``over``: where warm-up spends its time."""
    h = stream.handed[:stream.warmup_chunks + 1]
    d = np.diff(h)
    return [[int(i) + 1, float(d[i])] for i in np.flatnonzero(d > over)]


def _rates(stream):
    """Chunks handed over in each second of the window."""
    h = stream.handed[stream.warmup_chunks:stream.chunks] - stream.t_start
    return np.bincount(h.astype(np.int64)).tolist() if len(h) else []
