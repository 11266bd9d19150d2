"""Prometheus-text ``/metrics`` endpoint on a worker-side thread (the port's
copy of ``llmq_tpu/obs/exporter.py``).

Stdlib only (``http.server`` on a daemon thread): no client library, no
asyncio coupling — the exporter must keep answering scrapes while the
worker's event loop is wedged in a long engine step, which is exactly
when an operator wants to look at it.

Off by default. ``LLMQ_METRICS_PORT=<port>`` turns it on; port ``0``
binds an ephemeral port (tests; the bound port is in
``MetricsExporter.port``).
"""

from __future__ import annotations

import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from llmq_tpu_torch.obs.metrics import MetricsRegistry, get_registry

logger = logging.getLogger(__name__)

_exporter_lock = threading.Lock()
_exporter: Optional["MetricsExporter"] = None


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: MetricsRegistry  # set per-server subclass

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        if self.path.split("?")[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = self.registry.render_prometheus().encode("utf-8")
        except Exception:  # noqa: BLE001 — a broken gauge must not 500 forever
            logger.exception("metrics render failed")
            self.send_error(500)
            return
        self.send_response(200)
        self.send_header(
            "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
        )
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("metrics scrape: " + format, *args)


class MetricsExporter:
    """HTTP /metrics server on a daemon thread."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        port: int = 0,
        host: str = "0.0.0.0",
    ) -> None:
        self.registry = registry or get_registry()
        handler = type(
            "_BoundMetricsHandler",
            (_MetricsHandler,),
            {"registry": self.registry},
        )
        self._server = ThreadingHTTPServer((host, port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="llmq-metrics-exporter",
            daemon=True,
        )

    def start(self) -> "MetricsExporter":
        self._thread.start()
        logger.info("metrics exporter listening on :%d/metrics", self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


def maybe_start_exporter(
    registry: Optional[MetricsRegistry] = None,
) -> Optional[MetricsExporter]:
    """Start the process-wide exporter if ``LLMQ_METRICS_PORT`` is set.

    Idempotent: the first successful start wins (workers and probes may
    both call this). Returns the live exporter, or None when export is
    off or the port cannot be bound (a taken port logs a warning rather
    than killing the worker).
    """
    global _exporter
    raw = os.environ.get("LLMQ_METRICS_PORT")
    if raw is None or raw.strip() == "":
        return None
    with _exporter_lock:
        if _exporter is not None:
            return _exporter
        try:
            port = int(raw)
        except ValueError:
            logger.warning("LLMQ_METRICS_PORT=%r is not a port; ignoring", raw)
            return None
        try:
            _exporter = MetricsExporter(registry, port=port).start()
        except OSError as exc:
            logger.warning(
                "metrics exporter could not bind port %d: %s", port, exc
            )
            return None
        return _exporter


def stop_exporter() -> None:
    """Tear down the process-wide exporter (tests)."""
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None
