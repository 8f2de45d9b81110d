"""MarketTicker: per-symbol sliding high/low tracker (DSPBench's "stock
analytics" family), on the port (the JAX package's ``windflow_tpu/models/
market_ticker.py``).

``Source(ticks) → Ffat_WindowsGPU(declared max) → Sink``: one device
window op computes BOTH the sliding high and the sliding low per symbol in
a single step, by lifting each tick to the two-leaf aggregate
``{"hi": price, "lo": -price}`` under a leafwise ``torch.maximum``
combiner — ``min(x) == -max(-x)``, so one declared-"max" monoid covers
both ends.  The declaration routes the step onto the scatter-combine path:
the pane cells by a scatter-max, the sliding windows by the hand-written
fold kernel (``csrc/sliding_fold.cu``, both leaves in one launch).  The
lift folds prices in float32, the fold kernel's type: a Python-float
price stages as a float64 lane, and its high and low come out as the
JAX package's (which folds float64) rounded to float32 — exactly, since
rounding is monotonic.  The graph runs on ``config.device`` (the card by
default).
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch

import windflow_tpu_torch as wt


def build(ticks: Iterable[dict],
          on_window: Optional[Callable] = None,
          *, win_len: int = 64, slide: int = 16, max_symbols: int = 64,
          batch: int = 1024,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """Ticks are dicts ``{"sym": int, "price": float}`` (extra lanes ride
    along).  Each fired window emits ``{"sym", "wid", "high", "low"}``.
    The source declares that layout (``withRecordSpec``), so on the card
    its staging edge ships wire-compressed batches."""

    def emit(res, ctx=None):
        if res is not None and on_window is not None:
            on_window({"sym": int(res["key"]), "wid": int(res["wid"]),
                       "high": float(res["value"]["hi"]),
                       "low": -float(res["value"]["lo"])})

    src = (wt.Source_Builder(lambda: iter(ticks)).withName("ticks")
           .withOutputBatchSize(batch)
           .withRecordSpec({"sym": 0, "price": 0.0}).build())
    hilo = (wt.Ffat_WindowsGPU_Builder(
                lambda t: {"hi": t["price"].to(torch.float32),
                           "lo": -t["price"].to(torch.float32)},
                lambda a, b: {"hi": torch.maximum(a["hi"], b["hi"]),
                              "lo": torch.maximum(a["lo"], b["lo"])})
            .withName("hilo")
            .withCBWindows(win_len, slide)
            .withKeyBy(lambda t: t["sym"])
            .withMaxKeys(max_symbols)
            .withMonoidCombiner("max").build())
    sink = wt.Sink_Builder(emit).withName("quotes_out").build()

    g = wt.PipeGraph("market_ticker", wt.ExecutionMode.DEFAULT,
                     config=config or wt.Config())
    g.add_source(src).add(hilo).add_sink(sink)
    return g


def run(ticks: Iterable[dict], **kwargs) -> List[dict]:
    """Run to completion; returns ``{"sym", "wid", "high", "low"}`` rows."""
    results: List[dict] = []
    build(ticks, on_window=results.append, **kwargs).run()
    return results
