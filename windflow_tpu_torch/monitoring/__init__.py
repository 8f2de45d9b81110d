"""Observability of the port (the port of ``windflow_tpu/monitoring``):
per-replica stats records, the flight recorder (span tracing and latency
histograms), the step registry, the sweep ledger, the device gauges, the
health plane, the shard plane, the latency ledger (staged→sunk segments
and the SLO), the tenant ledger (per-tenant bytes and device budgets),
the calibration store and live roofline, the OpenMetrics exposition, the
graph's DOT and SVG diagrams, the monitoring thread and the dashboard
server with its web UI."""

from windflow_tpu_torch.monitoring.dashboard import DashboardServer
from windflow_tpu_torch.monitoring.diagram import to_dot, to_svg
from windflow_tpu_torch.monitoring.health import HealthPlane
from windflow_tpu_torch.monitoring.monitor import MonitoringThread
from windflow_tpu_torch.monitoring.openmetrics import (parse_exposition,
                                                       render_openmetrics)
from windflow_tpu_torch.monitoring.recorder import (FlightRecorder,
                                                    LatencyHistogram,
                                                    chrome_trace_from_events)
from windflow_tpu_torch.monitoring.shard_ledger import ShardSketch
from windflow_tpu_torch.monitoring.stats import StatsRecord

__all__ = ["DashboardServer", "FlightRecorder", "HealthPlane",
           "LatencyHistogram", "MonitoringThread", "ShardSketch",
           "StatsRecord", "chrome_trace_from_events", "parse_exposition",
           "render_openmetrics", "to_dot", "to_svg"]
