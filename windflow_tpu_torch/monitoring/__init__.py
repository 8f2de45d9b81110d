"""Observability of the port (the port of ``windflow_tpu/monitoring``,
part one): per-replica stats records, the flight recorder (span tracing
and latency histograms), the step registry, the sweep ledger, the device
gauges, the health plane, the shard plane, and the graph's DOT diagram.
The latency, tenant and calibration ledgers, the OpenMetrics exposition,
the dashboard, the web UI and the monitoring thread come later."""

from windflow_tpu_torch.monitoring.diagram import to_dot
from windflow_tpu_torch.monitoring.health import HealthPlane
from windflow_tpu_torch.monitoring.recorder import (FlightRecorder,
                                                    LatencyHistogram,
                                                    chrome_trace_from_events)
from windflow_tpu_torch.monitoring.shard_ledger import ShardSketch
from windflow_tpu_torch.monitoring.stats import StatsRecord

__all__ = ["FlightRecorder", "HealthPlane", "LatencyHistogram",
           "ShardSketch", "StatsRecord", "chrome_trace_from_events",
           "to_dot"]
