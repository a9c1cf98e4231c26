"""Prometheus text-format exposition over HTTP (stdlib only).

The master opts in with ``--metrics_port`` (or
``DLROVER_TPU_METRICS_PORT``); scraping is then::

    curl http://<master-host>:<port>/metrics

Built on ``http.server.ThreadingHTTPServer`` — no ``prometheus_client``
``start_http_server``, keeping the zero-dependency contract. Tests that
only need the payload call ``registry.render()`` directly and never
bind a socket.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.obs.metrics import MetricsRegistry, get_registry

logger = get_logger("obs.http")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _make_handler(
    registry: MetricsRegistry,
    health: Optional[Callable[[], dict]] = None,
):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                self._send(200, registry.render().encode(), CONTENT_TYPE)
            elif path == "/":
                # Pure liveness, always 200: a critical verdict about
                # a WORKER must not make the master process look dead
                # to a probe pointed at the root path.
                self._send(200, b"ok\n", "text/plain")
            elif path == "/healthz":
                if health is None:
                    # No health plane attached (bare exposition
                    # server): liveness-only answer, as before.
                    self._send(200, b"ok\n", "text/plain")
                    return
                try:
                    payload = health()
                except Exception:  # noqa: BLE001 — a broken health
                    # provider must not 500 the liveness probe
                    logger.warning(
                        "health provider failed", exc_info=True
                    )
                    payload = {"ok": True, "error": "health provider failed"}
                # Readiness semantics for the deploy/ CRD probes: 200
                # while no CRITICAL verdict is active, 503 otherwise —
                # the JSON body carries the score either way so a
                # smarter prober can apply its own floor.
                status = 200 if payload.get("ok", True) else 503
                self._send(
                    status,
                    (json.dumps(payload, sort_keys=True) + "\n").encode(),
                    "application/json",
                )
            else:
                self.send_error(404)

        def log_message(self, fmt, *args):
            # Scrapes land every few seconds; keep them out of stderr.
            logger.debug("http: " + fmt, *args)

    return Handler


class MetricsHTTPServer:
    """Serves ``GET /metrics`` for a registry on a daemon thread."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        port: int = 0,
        host: str = "0.0.0.0",
        health: Optional[Callable[[], dict]] = None,
    ):
        """``health`` — a callable returning the /healthz JSON body
        (``HealthMonitor.healthz_payload``); /healthz then answers
        200 (healthy) / 503 (critical verdicts active) with the
        score, instead of the bare liveness ``ok``."""
        self.registry = registry or get_registry()
        self._server = ThreadingHTTPServer(
            (host, port), _make_handler(self.registry, health=health)
        )
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="metrics-http",
                daemon=True,
            )
            self._thread.start()
            logger.info(
                "metrics endpoint on http://127.0.0.1:%d/metrics",
                self.port,
            )

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
