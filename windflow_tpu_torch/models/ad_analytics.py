"""AdAnalytics: the Yahoo-Streaming-Benchmark-shaped advertising pipeline
(the JAX package's ``windflow_tpu/models/ad_analytics.py``), on the port.

``Source(events) → FilterGPU(view events) → MapGPU(project) →
Ffat_WindowsGPU(per-campaign TB count) → Sink`` — the canonical
filter/project/windowed-count workload, expressed device-first: the filter
and projection chain into one hop, the ad→campaign join is a gather from
a campaign table on the graph's device (YSB's Redis join becomes a lookup
on the card), and the per-campaign counts come from time-based FFAT
windows fired on the watermark frontier.  The graph runs on
``config.device`` (the card by default).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch.basic import resolve_device


def build(events: Iterable[dict],
          ad_to_campaign: List[int],
          on_count: Optional[Callable[[int, int, int], None]] = None, *,
          win_usec: int = 10_000_000, slide_usec: int = 10_000_000,
          batch: int = 4096,
          view_type: int = 1,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """``events`` are dicts with int columns ``ad_id``, ``etype``, ``ts``
    (µs).  ``ad_to_campaign[ad]`` maps each ad to its campaign id; the
    table is closed over by the projection as an int32 tensor on the
    graph's device (no per-tuple host lookup).

    ``on_count(campaign, window_id, n)`` receives each fired window count.
    The source declares the events' layout (``withRecordSpec``), so on
    the card its staging edge ships wire-compressed batches."""
    config = config or wt.Config()
    table = torch.as_tensor(list(ad_to_campaign), dtype=torch.int32,
                            device=resolve_device(config))
    n_campaigns = int(max(ad_to_campaign)) + 1 if len(ad_to_campaign) else 1

    src = (wt.Source_Builder(lambda: iter(events))
           .withName("ad_events")
           .withTimestampExtractor(lambda e: e["ts"])
           .withOutputBatchSize(batch)
           .withRecordSpec({"ad_id": 0, "etype": 0, "ts": 0}).build())
    # filter + project chain into one hop a batch
    flt = (wt.FilterGPU_Builder(lambda e: e["etype"] == view_type)
           .withName("view_filter").build())
    prj = (wt.MapGPU_Builder(
            lambda e: {"campaign": table[e["ad_id"].long()], "one": 1})
           .withName("campaign_join").build())
    win = (wt.Ffat_WindowsGPU_Builder(lambda e: e["one"],
                                      lambda a, b: a + b)
           .withName("campaign_counts")
           .withTBWindows(win_usec, slide_usec)
           .withKeyBy(lambda e: e["campaign"])
           .withMaxKeys(n_campaigns).build())

    def emit(r, ctx=None):
        if r is not None and on_count is not None:
            on_count(int(r["key"]), int(r["wid"]), int(r["value"]))

    sink = wt.Sink_Builder(emit).withName("count_sink").build()

    g = wt.PipeGraph("ad_analytics", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT, config=config)
    pipe = g.add_source(src)
    pipe.add(flt)
    pipe.chain(prj)
    pipe.add(win).add_sink(sink)
    return g


def run(events: Iterable[dict], ad_to_campaign: List[int],
        **kwargs) -> Dict[Tuple[int, int], int]:
    counts: Dict[Tuple[int, int], int] = {}
    g = build(events, ad_to_campaign,
              on_count=lambda c, w, n: counts.__setitem__((c, w), n),
              **kwargs)
    g.run()
    return counts
