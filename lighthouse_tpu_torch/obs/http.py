"""Standalone metrics scrape endpoint — twin of ``beacon_node/http_metrics``.

A stdlib ``ThreadingHTTPServer`` on its own port (``bn --metrics-port``),
separate from the beacon API server, serving:

* ``/metrics`` — the process-global registry via ``metrics.render()``
  (Prometheus text exposition format 0.0.4);
* ``/health``  — ``utils/monitoring.SystemHealth`` plus process info,
  as JSON;
* ``/trace``   — the flight recorder as Chrome trace-event JSON
  (loadable in Perfetto / ``chrome://tracing``).

Port 0 binds an ephemeral port (the bound port is logged and exposed as
``MetricsServer.port``); the server thread is a daemon and never blocks
node shutdown.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import get_logger
from ..utils.metrics import render as render_metrics
from ..utils.monitoring import SystemHealth
from .tracer import TRACER

log = get_logger("obs.http")

# The most recently started server, for tests that boot `bn
# --metrics-port 0` and need to learn the ephemeral port.
_LAST: "MetricsServer | None" = None


def last_server() -> "MetricsServer | None":
    return _LAST


class MetricsServer:
    """Serve ``/metrics``, ``/health`` and ``/trace`` on a daemon thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", tracer=None):
        self._host = host
        self._want_port = port
        self._tracer = tracer if tracer is not None else TRACER
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int = 0

    def start(self) -> "MetricsServer":
        global _LAST
        tracer = self._tracer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet access log
                pass

            def _send(self, code: int, body: bytes, content_type: str):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200, render_metrics().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/health":
                        health = dataclasses.asdict(SystemHealth.observe())
                        health.update(status="ok", pid=os.getpid())
                        self._send(
                            200, json.dumps(health).encode(),
                            "application/json",
                        )
                    elif path == "/trace":
                        doc = tracer.chrome_trace()
                        self._send(
                            200, json.dumps(doc).encode(),
                            "application/json",
                        )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as exc:  # scrape must not kill the server thread
                    log.warning("metrics request %s failed: %s", path, exc)

        self._httpd = ThreadingHTTPServer((self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="obs-metrics-http",
            daemon=True,
        )
        self._thread.start()
        _LAST = self
        log.info(
            "metrics endpoint on http://%s:%d/metrics (/health, /trace)",
            self._host, self.port,
        )
        return self

    def stop(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
