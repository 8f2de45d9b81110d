"""Monitoring thread speaking the reference dashboard protocol (the port
of ``windflow_tpu/monitoring/monitor.py``; reference ``monitoring.hpp:
160-295``).

A background thread samples the graph on a cadence (default once a
second) and ships reports to the dashboard over a length-prefixed TCP
protocol (default ``localhost:20207``):

* ``NEW_APP``  (type 0): preamble ``[type, len]`` (two big-endian int32)
  and a NUL-terminated SVG diagram; ack ``[status, identifier]``.
* ``NEW_REPORT`` (type 1): preamble ``[type, identifier, len]`` and the
  NUL-terminated JSON of ``PipeGraph.stats()``; ack ``[status, _]``.
* ``END_APP`` (type 2): framed as NEW_REPORT, sent once at the end.

Sampling is decoupled from shipping: every cadence tick runs
``sample_gauges`` and ``health_tick`` (the latency, tenant and roofline
ledgers, then the watchdog), shipped or not, so a headless run (no
dashboard listening, or one that died mid-run) keeps its rolling gauges
and verdicts.  Once the dashboard is unreachable or a send fails the
thread ships nothing more, as in the reference: monitoring never takes
the pipeline down.  Both ends of a run, normal and aborted, ship a final
report and ``END_APP``, degraded to a minimal payload when ``stats()``
itself fails.

**Against a CUDA graph capture.**  A megastep edge captures its group
body with ``torch.cuda.graph`` on the scheduler's thread, and a stats read
from this thread touches the card (the shard sketches' host copy, the
allocator's gauges): inside a capture that invalidates it.  Each tick
therefore holds ``kernels.ffat_cuda.capture_lock``, which every capture
holds too, so a tick and a capture never overlap.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import Optional

#: the cadence (seconds) a thread samples at unless given another; read
#: when the thread is made
SAMPLE_INTERVAL_SEC = 1.0
TYPE_NEW_APP = 0
TYPE_NEW_REPORT = 1
TYPE_END_APP = 2


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes (both protocol ends use it)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the connection")
        buf += chunk
    return buf


def _capture_lock():
    from windflow_tpu_torch.kernels.ffat_cuda import capture_lock
    return capture_lock


class MonitoringThread:
    def __init__(self, graph, interval: Optional[float] = None) -> None:
        self.graph = graph
        self.interval = SAMPLE_INTERVAL_SEC if interval is None \
            else float(interval)
        self.identifier = -1
        self._sock = None
        self._thread = None
        self._stop = threading.Event()
        self.active = False      # a dashboard connection is up
        self.samples_taken = 0   # cadence ticks (shipped or not)
        self.aborted = False     # the run ended abnormally

    # -- protocol ------------------------------------------------------------
    def _register_app(self) -> None:
        from windflow_tpu_torch.monitoring.diagram import to_svg
        payload = to_svg(self.graph).encode() + b"\0"
        self._sock.sendall(struct.pack(">ii", TYPE_NEW_APP, len(payload)))
        self._sock.sendall(payload)
        status, ident = struct.unpack(">ii", recv_exact(self._sock, 8))
        if status != 0:
            raise ConnectionError(f"dashboard rejected NEW_APP: {status}")
        self.identifier = ident

    def _send_report(self, msg_type: int, report: dict) -> None:
        payload = json.dumps(report).encode() + b"\0"
        self._sock.sendall(struct.pack(">iii", msg_type, self.identifier,
                                       len(payload)))
        self._sock.sendall(payload)
        status, _ = struct.unpack(">ii", recv_exact(self._sock, 8))
        if status != 0:
            raise ConnectionError(f"dashboard rejected report: {status}")

    def _send_final(self) -> None:
        """The final report and END_APP, best-effort on both ends of a
        run; the report degrades to the graph's name, the abort mark and
        its tenant when ``stats()`` fails."""
        if not self.active:
            return
        try:
            with _capture_lock():
                report = self.graph.stats()
            if self.aborted:
                report["Aborted"] = True
        except Exception:  # lint: broad-except-ok (END_APP must still go out)
            report = {"PipeGraph_name": self.graph.name, "Aborted": True,
                      "Tenant": {"enabled": False, "tenant":
                                 getattr(self.graph.config, "tenant", "")
                                 or self.graph.name},
                      "stats_error": "stats() raised during termination"}
        try:
            self._send_report(TYPE_END_APP, report)
        except Exception:  # lint: broad-except-ok (a dead socket is a
            # no-op here)
            pass

    def _tick(self) -> None:
        """One cadence sample, serialised against CUDA graph captures:
        the gauges and the ledgers' ticks, then the report if a dashboard
        listens."""
        with _capture_lock():
            self.samples_taken += 1
            try:
                self.graph.sample_gauges()
                self.graph.health_tick()
            except Exception:  # lint: broad-except-ok (a sampling fault must
                # not kill the thread; the final report still goes out)
                pass
            if not self.active:
                return
            try:
                report = self.graph.stats()
            except Exception:  # lint: broad-except-ok (a transient stats fault
                # raises before any byte is sent: the protocol is in
                # sync, skip this tick)
                return
        try:
            self._send_report(TYPE_NEW_REPORT, report)
        except OSError:
            self._disconnect()      # keep sampling headless

    # -- thread --------------------------------------------------------------
    def _run(self) -> None:
        try:
            self._sock = socket.create_connection(
                (self.graph.config.dashboard_host,
                 self.graph.config.dashboard_port), timeout=2.0)
            self._register_app()
            self.active = True
        except OSError:
            # reference: "Monitoring thread switched off" — the shipping
            # half only: the sampling below still runs
            self._disconnect()
        try:
            last = time.monotonic()
            # check 20 times a second: END_APP goes out promptly without
            # taking GIL time from the scheduler loop
            while not self._stop.wait(0.05) and not self.graph.is_done():
                now = time.monotonic()
                if now - last >= self.interval:
                    last = now
                    self._tick()
            self._send_final()
        finally:
            self._disconnect()

    def _disconnect(self) -> None:
        self.active = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="wf-monitoring")
        self._thread.start()

    def stop(self, timeout: float = 5.0, aborted: bool = False) -> None:
        if aborted:
            self.aborted = True   # the final report carries the mark
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
