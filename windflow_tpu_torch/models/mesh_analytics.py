"""MeshAnalytics: the multi-GPU configuration of the flagship pipeline
(the JAX package's ``windflow_tpu/models/mesh_analytics.py``), on the
port.

The graph of ``ffat_analytics``, ``Source → MapGPU ⊕ FilterGPU →
Ffat_WindowsGPU → Sink``, run on a ``(data, key)`` mesh through
``Config(mesh=...)``: staged batches divide over the mesh's positions,
the chained map and filter run on the graph's device, and the keyed
window state is key-sharded with each position's step gathering the
batch over ``data`` (``windflow_tpu_torch.parallel.mesh``).  ``devices``
names the mesh's positions: the visible CUDA devices by default, or one
device repeated (a logical mesh, e.g. ``["cpu"] * 8`` on the CPU or
``["cuda:0"] * 4`` on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence

import windflow_tpu_torch as wt
from windflow_tpu_torch.parallel import mesh as M


def build(records: Iterable[dict],
          on_window: Optional[Callable] = None, *,
          n_devices: Optional[int] = None,
          data_axis: int = 1,
          win_len: int = 64, slide: int = 16,
          max_keys: int = 64, batch: int = 1024,
          config: Optional[wt.Config] = None,
          devices: Optional[Sequence] = None) -> wt.PipeGraph:
    """``records`` are dicts with int field ``k`` and float field ``v``;
    ``max_keys`` must be divisible by the mesh's key-axis extent and
    ``batch`` by its positions.  ``on_window(key, wid, value)`` receives
    each fired window.  ``config`` (the card by default) gets the mesh
    over ``devices``."""
    mesh = M.make_mesh(n_devices=n_devices, data=data_axis, devices=devices)
    cfg = dataclasses.replace(config or wt.Config(), mesh=mesh)

    src = (wt.Source_Builder(lambda: iter(records))
           .withName("records").withOutputBatchSize(batch).build())
    mp = (wt.MapGPU_Builder(lambda t: {"k": t["k"], "v": t["v"] * 1.5})
          .withName("scale").build())
    flt = (wt.FilterGPU_Builder(lambda t: t["v"] >= 0.0)
           .withName("clip").build())
    win = (wt.Ffat_WindowsGPU_Builder(lambda t: t["v"], lambda a, b: a + b)
           .withName("sharded_windows")
           .withCBWindows(win_len, slide)
           .withKeyBy(lambda t: t["k"]).withMaxKeys(max_keys).build())

    def emit(r, ctx=None):
        if r is not None and on_window is not None:
            on_window(int(r["key"]), int(r["wid"]), float(r["value"]))

    snk = wt.Sink_Builder(emit).withName("windows_out").build()

    g = wt.PipeGraph("mesh_analytics", wt.ExecutionMode.DEFAULT, config=cfg)
    pipe = g.add_source(src)
    pipe.add(mp)
    pipe.chain(flt)
    pipe.add(win).add_sink(snk)
    return g


def run(records: Iterable[dict], **kwargs) -> List[tuple]:
    out: List[tuple] = []
    g = build(records, on_window=lambda k, w, v: out.append((k, w, v)),
              **kwargs)
    g.run()
    return out
