"""FFAT analytics: the flagship device pipeline (the JAX package's
``windflow_tpu/models/ffat_analytics.py``), on the port.

``Source → MapGPU → FilterGPU → Ffat_WindowsGPU → Sink``: staged columnar
batches, an elementwise transform and predicate chained on the card, and
per-key sliding count windows over the device pane state — every fired
window of every key computed in one step a batch, its grouping by the
hand-written grouping kernel (``csrc/grouping_rank_hist.cu``) while the
window's (key, pane) ids stay under the kernel's gate.  The graph runs on
``config.device`` (the card by default).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import windflow_tpu_torch as wt


def build(records: Iterable[dict],
          on_window: Optional[Callable] = None,
          *, win_len: int = 1024, slide: int = 128, max_keys: int = 1024,
          batch: int = 4096,
          transform: Optional[Callable] = None,
          predicate: Optional[Callable] = None,
          lift: Optional[Callable] = None,
          comb: Optional[Callable] = None,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """Records are dicts of scalars with an int ``k`` key field and a float
    ``v`` value field (arbitrary extra lanes ride along).  The user
    functions see the batch's columns as tensors.  The source declares
    that layout (``withRecordSpec``), so on the card its staging edge
    ships wire-compressed batches."""
    transform = transform or (
        lambda t: {"k": t["k"], "v": t["v"] * 1.5 + 1.0})
    predicate = predicate or (lambda t: (t["k"] & 7) != 7)
    lift = lift or (lambda t: t["v"])
    comb = comb or (lambda a, b: a + b)

    def emit(res, ctx=None):
        if res is not None and on_window is not None:
            on_window(res)

    src = (wt.Source_Builder(lambda: iter(records)).withName("ingest")
           .withOutputBatchSize(batch)
           .withRecordSpec({"k": 0, "v": 0.0}).build())
    mp = wt.MapGPU_Builder(transform).withName("transform").build()
    flt = wt.FilterGPU_Builder(predicate).withName("select").build()
    ffat = (wt.Ffat_WindowsGPU_Builder(lift, comb)
            .withName("ffat")
            .withCBWindows(win_len, slide)
            .withKeyBy(lambda t: t["k"])
            .withMaxKeys(max_keys).build())
    sink = wt.Sink_Builder(emit).withName("windows_out").build()

    g = wt.PipeGraph("ffat_analytics", wt.ExecutionMode.DEFAULT,
                     config=config or wt.Config())
    pipe = g.add_source(src)
    pipe.chain(mp)          # chained device stages run as one hop
    pipe.chain(flt)
    pipe.add(ffat).add_sink(sink)
    return g


def run(records: Iterable[dict], **kwargs) -> List[dict]:
    """Run to completion; returns window records
    ``{"key": int, "wid": int, "value": float}``."""
    results: List[dict] = []
    g = build(records, on_window=results.append, **kwargs)
    g.run()
    return results
