"""SpikeDetection: sensor-stream anomaly application (DSPBench suite), on
the port (the JAX package ships it as ``windflow_tpu/models/
spike_detection.py``).

``Source(readings) → keyed sliding-window average → Filter(spike) → Sink``:
per-sensor moving average over a count-based sliding window, flagging
readings that deviate more than ``threshold`` × average — exercises the
host keyed windows with incremental logic and a keyed filter on window
results.  Every stage runs on the host; the graph follows
``config.device`` (the card by default).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional

import windflow_tpu_torch as wt


@dataclasses.dataclass
class Reading:
    device: int
    value: float


@dataclasses.dataclass
class Spike:
    device: int
    window_id: int
    average: float


def build(readings: Iterable[Reading],
          on_spike: Optional[Callable[[Spike], None]] = None,
          win_len: int = 16, slide: int = 1,
          threshold: float = 1.25,
          window_parallelism: int = 2,
          detector_parallelism: int = 1,
          config: Optional[wt.Config] = None) -> wt.PipeGraph:
    """Build the SpikeDetection graph.  ``on_spike(spike)`` observes every
    detection."""

    def moving_avg(r, acc):
        # incremental (tuple, accumulator) logic: track sum/count/last value
        if acc is None:
            acc = {"sum": 0.0, "n": 0, "last": 0.0}
        acc["sum"] += r.value
        acc["n"] += 1
        acc["last"] = r.value
        return acc

    def is_spike(res):
        avg = res.value["sum"] / res.value["n"]
        return abs(res.value["last"]) > threshold * abs(avg)

    def emit(res, ctx=None):
        if res is not None and on_spike is not None:
            on_spike(Spike(device=res.key, window_id=res.wid,
                           average=res.value["sum"] / res.value["n"]))

    src = (wt.Source_Builder(lambda: iter(readings))
           .withName("sensor_source").build())
    win = (wt.Keyed_Windows_Builder(moving_avg)
           .withName("moving_average")
           .withCBWindows(win_len, slide)
           .withKeyBy(lambda r: r.device)
           .withParallelism(window_parallelism).build())
    det = (wt.Filter_Builder(is_spike).withName("spike_detector")
           .withParallelism(detector_parallelism)
           .withKeyBy(lambda res: res.key).build())
    sink = wt.Sink_Builder(emit).withName("spike_sink").build()

    g = wt.PipeGraph("spike_detection", wt.ExecutionMode.DEFAULT,
                     config=config or wt.Config())
    g.add_source(src).add(win).add(det).add_sink(sink)
    return g


def run(readings: Iterable[Reading], **kwargs) -> List[Spike]:
    spikes: List[Spike] = []
    g = build(readings, on_spike=spikes.append, **kwargs)
    g.run()
    return spikes
