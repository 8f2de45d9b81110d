"""Telemetry over binary frames: the zero-per-tuple-Python pipeline (the
JAX package's ``windflow_tpu/models/telemetry_frames.py``), on the port.

``FrameSource → MapGPU⊕FilterGPU (chained) → Ffat_WindowsGPU (TB) →
columnar Sink``: byte chunks parse to columns, all lanes of a batch ride
one packed host→device copy, time-based sliding windows fire on the
watermark frontier with a configurable ring-overflow policy, and results
leave through the deferred single-copy columnar egress — no per-tuple
Python object exists on the hot path.  The wire format is the
``io.frames`` record layout (``int64 key, int64 ts, float64 value``).
The graph runs on ``config.device`` (the card by default).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

import windflow_tpu_torch as wt
from windflow_tpu_torch.io import FrameSource


def build(chunks: Callable[[], Iterable[bytes]],
          on_windows: Optional[Callable] = None,
          *, win_usec: int = 60_000_000, slide_usec: int = 5_000_000,
          max_keys: int = 1024, batch: int = 8192,
          lateness_usec: int = 1_000_000,
          overflow_policy: str = "drop",
          transform: Optional[Callable] = None,
          predicate: Optional[Callable] = None,
          lift: Optional[Callable] = None,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """``chunks`` yields byte blobs in the frames wire format;
    ``on_windows`` receives :class:`windflow_tpu_torch.SinkColumns` (SoA
    numpy: ``key``, ``wid``, ``value`` columns + the timestamp lane) once
    per result batch.

    ``transform``/``predicate``/``lift`` customize the three stages (torch
    ops over the batch's columns); a custom ``transform`` must keep the
    ``key`` field, and the default ``predicate`` and ``lift`` read field
    ``v0`` — a transform that renames or drops ``v0`` must supply its own
    ``predicate`` and ``lift``.  The source declares the parsed columns'
    layout (an int32 ``key``, a float32 ``v0``), so on the card its
    staging edge ships wire-compressed batches."""
    transform = transform or (
        lambda t: {"key": t["key"], "v0": t["v0"]})
    predicate = predicate or (lambda t: t["v0"] == t["v0"])  # drop NaNs
    lift = lift or (lambda t: t["v0"])

    def emit(cols, ctx=None):
        if cols is not None and on_windows is not None:
            on_windows(cols)

    src = FrameSource(chunks, nv=1, fmt="frames", name="frames_in",
                      output_batch_size=batch,
                      record_spec={"key": np.int32(0),
                                   "v0": np.float32(0.0)})
    mp = wt.MapGPU_Builder(transform).withName("normalize").build()
    flt = wt.FilterGPU_Builder(predicate).withName("drop_nan").build()
    win = (wt.Ffat_WindowsGPU_Builder(lift, lambda a, b: a + b)
           .withName("tb_windows")
           .withTBWindows(win_usec, slide_usec)
           .withKeyBy(lambda t: t["key"])
           .withMaxKeys(max_keys)
           .withLateness(lateness_usec)
           .withOverflowPolicy(overflow_policy).build())
    sink = (wt.Sink_Builder(emit).withName("columns_out")
            .withColumnarSink().build())

    g = wt.PipeGraph("telemetry_frames", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=config or wt.Config())
    pipe = g.add_source(src)
    pipe.add(mp)
    pipe.chain(flt)        # Map+Filter run as one hop
    pipe.add(win).add_sink(sink)
    return g
