"""Dashboard server: receives monitoring reports and serves them over
HTTP (the port of ``windflow_tpu/monitoring/dashboard.py``).

An in-process counterpart of the reference's out-of-process dashboard
(``dashboard/Server/...ServerWF.java:93-160``): the TCP side speaks the
length-prefixed protocol of :mod:`windflow_tpu_torch.monitoring.monitor`
(NEW_APP / NEW_REPORT / END_APP) and keeps each application's diagram and
report history; the HTTP side serves what the reference's REST API does
(``SpringServer/RequestController.java:38-52``):

* ``GET /``                  — the single-page UI (``webui.py``)
* ``GET /apps``              — the application list (id, name, alive,
  report count)
* ``GET /apps/<id>``         — an application's report history (JSON)
* ``GET /apps/<id>/latest``  — its most recent report
* ``GET /apps/<id>/diagram`` — its registered SVG diagram
* ``GET /metrics``           — the Prometheus text exposition of every
  application's latest report (``openmetrics.py``), one family each

Run standalone: ``python -m windflow_tpu_torch.monitoring.dashboard
[tcp_port [http_port]]``.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from windflow_tpu_torch.monitoring.monitor import recv_exact


class AppRecord:
    def __init__(self, ident: int, diagram: str) -> None:
        self.ident = ident
        self.diagram = diagram
        self.reports: List[dict] = []
        self.ended = False

    @property
    def name(self) -> str:
        if self.reports:
            return self.reports[-1].get("PipeGraph_name", "?")
        return "?"

    def summary(self) -> dict:
        return {"id": self.ident, "name": self.name,
                "alive": not self.ended, "num_reports": len(self.reports)}


class DashboardServer:
    def __init__(self, tcp_port: int = 20207, http_port: int = 20208,
                 host: str = "127.0.0.1", max_reports: int = 3600) -> None:
        self.host = host
        self.max_reports = max_reports
        self.apps: Dict[int, AppRecord] = {}
        self._next_id = 1
        self._lock = threading.Lock()
        self._tcp = socket.socket()
        self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp.bind((host, tcp_port))
        self._tcp.listen(16)
        self.tcp_port = self._tcp.getsockname()[1]
        self._http = ThreadingHTTPServer((host, http_port),
                                         self._make_handler())
        self.http_port = self._http.server_address[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- TCP protocol side ---------------------------------------------------
    def _serve_client(self, conn: socket.socket) -> None:
        app: Optional[AppRecord] = None
        try:
            mtype, length = struct.unpack(">ii", recv_exact(conn, 8))
            if mtype != 0:
                return
            diagram = recv_exact(conn, length).rstrip(b"\0").decode(
                "utf-8", "replace")
            with self._lock:
                ident = self._next_id
                self._next_id += 1
                app = self.apps[ident] = AppRecord(ident, diagram)
            conn.sendall(struct.pack(">ii", 0, ident))
            while not self._stop.is_set():
                mtype, ident_in, length = struct.unpack(
                    ">iii", recv_exact(conn, 12))
                payload = recv_exact(conn, length).rstrip(b"\0")
                try:
                    report = json.loads(payload)
                except json.JSONDecodeError:
                    report = {"malformed": True}
                with self._lock:
                    app.reports.append(report)
                    del app.reports[:-self.max_reports]
                    if mtype == 2:  # END_APP
                        app.ended = True
                conn.sendall(struct.pack(">ii", 0, 0))
                if mtype == 2:
                    break
        except (ConnectionError, struct.error, OSError):
            pass
        finally:
            if app is not None and not app.ended:
                with self._lock:
                    app.ended = True  # connection dropped = app gone
            conn.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._tcp.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve_client, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    # -- HTTP side -----------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parts = [p for p in self.path.split("/") if p]
                if not parts or parts == ["index.html"]:
                    # the single-page UI (reference React SPA equivalent)
                    from windflow_tpu_torch.monitoring.webui import INDEX_HTML
                    body = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parts == ["metrics"]:
                    # snapshot under the lock, render OUTSIDE it (same
                    # stance as the JSON endpoints below)
                    with server._lock:
                        latest = [(a.ident, a.name, a.reports[-1])
                                  for a in server.apps.values()
                                  if a.reports]
                    from windflow_tpu_torch.monitoring.openmetrics import \
                        render_openmetrics_multi
                    body = render_openmetrics_multi(
                        [({"app": name, "app_id": str(ident)}, report)
                         for ident, name, report in latest]).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                # Snapshot under the lock, serialize and write OUTSIDE it: a
                # stalled HTTP client must never block TCP report ingestion
                # (monitors time out and switch off for good).
                obj, code, svg = None, 200, None
                with server._lock:
                    if parts == ["apps"]:
                        obj = [a.summary() for a in server.apps.values()]
                    elif len(parts) >= 2 and parts[0] == "apps":
                        try:
                            app = server.apps[int(parts[1])]
                        except (KeyError, ValueError):
                            obj, code = {"error": "unknown app"}, 404
                        else:
                            if len(parts) == 2:
                                obj = {**app.summary(),
                                       "reports": list(app.reports)}
                            elif parts[2] == "latest":
                                obj = app.reports[-1] if app.reports else {}
                            elif parts[2] == "diagram":
                                svg = app.diagram
                if svg is not None:
                    body = svg.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "image/svg+xml")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if obj is None:
                    obj, code = {"error": "not found"}, 404
                self._json(obj, code)

        return Handler

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DashboardServer":
        for target in (self._accept_loop, self._http.serve_forever):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._tcp.close()
        except OSError:
            pass
        self._http.shutdown()
        self._http.server_close()


def main(argv=None) -> None:
    import sys
    args = list(argv if argv is not None else sys.argv[1:])
    tcp_port = int(args[0]) if args else 20207
    http_port = int(args[1]) if len(args) > 1 else 20208
    server = DashboardServer(tcp_port=tcp_port, http_port=http_port,
                             host="0.0.0.0")
    server.start()
    print(f"windflow_tpu_torch dashboard: TCP {server.tcp_port} / "
          f"HTTP {server.http_port} (open http://localhost:"
          f"{server.http_port}/ for the UI; GET /apps for JSON)")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
