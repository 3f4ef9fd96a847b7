"""HTTP front door for the verification service (the port's copy of the JAX
package's ``serve/http.py``).

A stdlib ``ThreadingHTTPServer`` on its own port (``python -m
lighthouse_tpu_torch.serve``), Beacon-API-shaped JSON (the ``/eth/v1/...`` path
discipline and ``{"data": ...}`` / ``{"code", "message"}`` envelopes of
the reference's ``http_api``):

* ``POST /eth/v1/verify/batch`` — submit one batch::

      {"tenant": "vc-7", "deadline_ms": 250,
       "sets": [{"signature": "0x...", "pubkeys": ["0x..."],
                 "message": "0x..."}, ...]}

  202 with ``{"data": {"request_id": "r00000001", "status": "queued"}}``
  on admission; 400 malformed, 429 rate-limit / queue-full, 503
  degraded-mode shed.
* ``GET /eth/v1/verify/batch/<request_id>`` — poll verdicts: ``queued``
  or ``done`` with per-set booleans and the deadline-miss flag; 404 for
  ids never admitted (or evicted after completion).
* ``GET /eth/v1/verify/tenants`` — per-tenant accept/shed/queued stats.
* ``GET /health`` — liveness.

Port 0 binds an ephemeral port (exposed as ``ServeApiServer.port``); the
server thread is a daemon and never blocks shutdown.  This server is the
tenant-facing edge only.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.logging import get_logger

log = get_logger("serve.http")

# The most recently started server, for callers that start one on port 0
# and need to learn the ephemeral port.
_LAST: "ServeApiServer | None" = None


def last_server() -> "ServeApiServer | None":
    return _LAST

#: shed reason -> HTTP status (the Beacon-API error envelope carries the
#: reason string either way)
_SHED_STATUS = {
    "malformed": 400,
    "rate-limit": 429,
    "queue-full": 429,
    "degraded": 503,
}


def _unhex(s: str) -> bytes:
    if not isinstance(s, str):
        raise ValueError("expected hex string")
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def decode_sets(raw) -> list:
    """Wire set dicts -> validated ``SignatureSet`` objects.  Raises
    ``ValueError`` on any shape or point-decode problem (the transport
    maps that to 400)."""
    from ..crypto.bls.api import PublicKey, Signature, SignatureSet

    if not isinstance(raw, list) or not raw:
        raise ValueError("sets must be a non-empty list")
    out = []
    for i, entry in enumerate(raw):
        if not isinstance(entry, dict):
            raise ValueError(f"set {i}: expected an object")
        try:
            sig = Signature.from_bytes(_unhex(entry["signature"]))
            pks = [PublicKey.from_bytes(_unhex(p))
                   for p in entry["pubkeys"]]
            msg = _unhex(entry["message"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ValueError(f"set {i}: {exc}") from exc
        except Exception as exc:  # point decode (BlsError subclasses vary)
            raise ValueError(f"set {i}: {exc}") from exc
        if not pks:
            raise ValueError(f"set {i}: empty pubkeys")
        out.append(SignatureSet(sig, pks, msg))
    return out


class ServeApiServer:
    """The tenant-facing submit/poll edge over one ``VerifyService``."""

    def __init__(self, service, port: int = 0, host: str = "127.0.0.1"):
        self.service = service
        self._host = host
        self._want_port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.port: int = 0

    def start(self) -> "ServeApiServer":
        global _LAST
        service = self.service

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet access log
                pass

            def _send_json(self, code: int, doc):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _error(self, code: int, message: str):
                self._send_json(code, {"code": code, "message": message})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path != "/eth/v1/verify/batch":
                        self._error(404, "not found")
                        return
                    n = int(self.headers.get("Content-Length") or 0)
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        self._error(400, "invalid JSON body")
                        return
                    if not isinstance(body, dict):
                        self._error(400, "expected a JSON object")
                        return
                    try:
                        sets = decode_sets(body.get("sets"))
                    except ValueError as exc:
                        self._error(400, str(exc))
                        return
                    deadline_s = None
                    if body.get("deadline_ms") is not None:
                        try:
                            deadline_s = float(body["deadline_ms"]) / 1000.0
                        except (TypeError, ValueError):
                            self._error(400, "bad deadline_ms")
                            return
                    res = service.submit_payload({
                        "tenant": body.get("tenant"),
                        "sets": sets,
                        "deadline_s": deadline_s,
                    })
                    if res.accepted:
                        self._send_json(202, {"data": res.to_json()})
                    else:
                        self._error(_SHED_STATUS.get(res.reason, 429),
                                    res.reason)
                except Exception as exc:  # a request must not kill the thread
                    log.warning("serve POST %s failed: %s", path, exc)
                    try:
                        self._error(500, "internal error")
                    except Exception:
                        pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path.startswith("/eth/v1/verify/batch/"):
                        rid = path.rsplit("/", 1)[1]
                        doc = service.result(rid)
                        if doc is None:
                            self._error(404, f"unknown request {rid}")
                        else:
                            self._send_json(200, {"data": doc})
                    elif path == "/eth/v1/verify/tenants":
                        self._send_json(
                            200, {"data": service.admission.stats()}
                        )
                    elif path == "/health":
                        self._send_json(200, {"status": "ok"})
                    else:
                        self._error(404, "not found")
                except Exception as exc:
                    log.warning("serve GET %s failed: %s", path, exc)

        self._httpd = ThreadingHTTPServer(
            (self._host, self._want_port), Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="serve-api-http",
            daemon=True,
        )
        self._thread.start()
        _LAST = self
        log.info("verification service on http://%s:%d/eth/v1/verify/batch",
                 self._host, self.port)
        return self

    def stop(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
