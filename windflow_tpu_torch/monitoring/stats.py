"""Per-replica statistics (the port of
``windflow_tpu/monitoring/stats.py``; reference ``stats_record.hpp``).

A replica records its inputs, outputs, transfer bytes and service times;
device replicas also count their step launches.  Beside the lifetime
counters and the running average, every replica keeps log-bucketed
latency histograms (``monitoring/recorder.py``): ``service_hist`` holds
every service span, and sinks fill ``e2e_hist`` with staged→sunk
latencies from the flight recorder's trace lane.  Both surface as
``p50/p95/p99`` here and, merged, in ``PipeGraph.stats()``.

A service span is the replica's own host span
(``recorder.ServiceSpan``): an operator's dispatch of one batch
(``wf:drain:<op>``), a source's tick (``wf:tick:<op>``).  It is host
time: the step's Python and launch work, not the device work it enqueued
(that is the flight recorder's ``device_done``).
"""

from __future__ import annotations

import dataclasses

from windflow_tpu_torch.basic import current_time_usecs
from windflow_tpu_torch.monitoring.recorder import LatencyHistogram


@dataclasses.dataclass
class StatsRecord:
    operator_name: str = ""
    replica_index: int = 0
    is_gpu: bool = False
    start_time_usec: int = dataclasses.field(default_factory=current_time_usecs)
    inputs_received: int = 0
    #: inputs the operator ignored (late tuples of a window operator)
    inputs_ignored: int = 0
    outputs_sent: int = 0
    #: summed service spans and their count (reference
    #: startStatsRecording / endStatsRecording)
    service_time_usec: float = 0.0
    num_service_samples: int = 0
    device_programs_launched: int = 0
    #: bytes actually copied host→device (the wire bytes)
    h2d_bytes: int = 0
    #: bytes the staged lanes occupy decoded (equal to ``h2d_bytes``
    #: unless the wire plane compressed the transfer)
    h2d_logical_bytes: int = 0
    d2h_bytes: int = 0
    is_terminated: bool = False
    #: per-batch service-span distribution
    service_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)
    #: staged→sunk latency, filled only at sink replicas from the trace
    #: lane
    e2e_hist: LatencyHistogram = dataclasses.field(
        default_factory=LatencyHistogram)

    def add_service(self, usec: float) -> None:
        """One service span: the replica's own host span
        (``monitoring/recorder.ServiceSpan``)."""
        self.service_time_usec += usec
        self.num_service_samples += 1
        self.service_hist.add(usec)

    def avg_service_time_usec(self) -> float:
        if self.num_service_samples == 0:
            return 0.0
        return self.service_time_usec / self.num_service_samples

    def to_json(self) -> dict:
        """The JAX package's per-replica schema (reference
        ``basic_operator.hpp:292-317``)."""
        out = {
            "Replica_id": self.replica_index,
            "Starting_time_usec": self.start_time_usec,
            "Inputs_received": self.inputs_received,
            "Inputs_ignored": self.inputs_ignored,
            "Outputs_sent": self.outputs_sent,
            "Service_time_usec": round(self.avg_service_time_usec(), 3),
            "Service_latency_usec": self.service_hist.quantiles(),
            "Is_terminated": self.is_terminated,
            "Device_programs_launched": self.device_programs_launched,
            "Bytes_H2D": self.h2d_bytes,
            "Bytes_H2D_logical": self.h2d_logical_bytes,
            "Bytes_D2H": self.d2h_bytes,
        }
        if self.e2e_hist.count:
            out["End_to_end_latency_usec"] = self.e2e_hist.quantiles()
        return out
