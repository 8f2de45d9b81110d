"""YSB's advertising query on the port (the graph of the port's
``models/ad_analytics.py``, fed by frames): FrameSource (EVENT time) →
FilterGPU (views) | MapGPU (ad → campaign, a gather from a table on the
card: YSB's Redis join) → Ffat_WindowsGPU (per-campaign counts over
tumbling event-time windows, the generic combiner ``a + b``) → columnar
Sink.  The source declares no record spec, so the wire plane stays off."""

from __future__ import annotations

import numpy as np


def draw(cfg: dict, rng) -> dict:
    """The seeded ad → campaign table: ``ads_per_campaign`` ads each."""
    ads = np.repeat(np.arange(cfg["campaigns"], dtype=np.int32),
                    cfg["ads_per_campaign"])
    return {"campaign_of_ad": rng.permutation(ads)}


def build(cfg: dict, tables: dict, chunks, sink_fn, config):
    import torch
    import windflow_tpu_torch as wt
    fields = [f["name"] for f in cfg["record"]["values"]]
    view = float(cfg["view_type"])
    campaign_of = torch.from_numpy(tables["campaign_of_ad"]).to(
        config.device)
    win = cfg["window_usec"]
    src = wt.FrameSource(chunks, nv=len(fields), fields=fields,
                         name="ysb_events",
                         output_batch_size=cfg["batch"])
    g = wt.PipeGraph("ysb", wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT,
                     config=config)
    pipe = g.add_source(src)
    pipe.add(wt.FilterGPU_Builder(lambda e: e["event_type"] == view)
             .withName("view_filter").build())
    pipe.chain(wt.MapGPU_Builder(
        lambda e: {"campaign": campaign_of[e["key"].long()], "one": 1})
        .withName("campaign_join").build())
    pipe.add(wt.Ffat_WindowsGPU_Builder(lambda e: e["one"],
                                        lambda a, b: a + b)
             .withName("campaign_counts").withTBWindows(win, win)
             .withKeyBy(lambda e: e["campaign"])
             .withMaxKeys(cfg["campaigns"]).build())
    pipe.add_sink(wt.Sink_Builder(sink_fn).withName("count_sink")
                  .withColumnarSink().build())
    return g


def collect(cols, tss) -> tuple:
    """One sink delivery as ``(campaign, wid, count)`` arrays."""
    return (np.asarray(cols["key"], np.int64),
            np.asarray(cols["wid"], np.int64),
            np.asarray(cols["value"], np.int64))


def least_bytes(run) -> float:
    """The least bytes one batch's step must move: the three lanes the
    query reads (ad id int32, ts int64, event type float32) once, the ad
    table once, the count cells of the windows the batch touches read
    and written once (int64), and the fired counts written once
    (campaign int32, wid, count and ts int64)."""
    cfg, b = run.cfg, run.cfg["batch"]
    gap = 1_000_000 // run.traffic["event_rate_per_s"]
    windows = -(-b * gap // cfg["window_usec"]) + 1
    return (16 * b + 4 * cfg["campaigns"] * cfg["ads_per_campaign"]
            + 2 * 8 * cfg["campaigns"] * windows
            + 28 * run.results_per_batch)
