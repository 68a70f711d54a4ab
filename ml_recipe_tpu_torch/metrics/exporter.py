"""Opt-in /metrics + /healthz HTTP exporter for long-running processes (the
port of ``ml_recipe_tpu/metrics/exporter.py``).

The serving plane's front end (``serve/server.py``) already exposes its
registry at ``GET /metrics``; this is the same stdlib HTTP plumbing
repackaged for processes that are not themselves HTTP servers — the
trainer (``--metrics_port``) foremost. A daemon ``ThreadingHTTPServer``
serves:

- ``GET /metrics`` — Prometheus text exposition of the bound registry,
  after running the registered pre-render hooks (scrape-time gauges:
  watchdog heartbeat age, supervisor sidecar counts);
- ``GET /healthz`` — small JSON liveness document from the health
  callback (or a plain ``{"status": "ok"}``).

Port 0 binds an ephemeral port (tests and multi-process hosts); the bound
port is on ``.port``. Everything runs on daemon threads — a wedged scraper
can never block training shutdown.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional

from .registry import Registry

logger = logging.getLogger(__name__)


class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    server: "_MetricsHTTPServer"

    def log_message(self, fmt, *args):  # quiet stderr; route to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        try:
            extra = self.server.route(self.path)
            if self.path == "/metrics":
                self._send(
                    200, self.server.render().encode("utf-8"),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif self.path == "/healthz":
                self._send(
                    200, json.dumps(self.server.health()).encode("utf-8"),
                    "application/json",
                )
            elif extra is not None:
                render_fn, content_type = extra
                try:
                    body = render_fn()
                except Exception as e:  # noqa: BLE001 - a broken extra route
                    # (e.g. pod aggregation mid-topology-change) must 500,
                    # not take the exporter thread down
                    logger.exception(f"route {self.path} failed")
                    self._send(
                        500,
                        json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode(),
                        "application/json",
                    )
                    return
                self._send(200, body.encode("utf-8"), content_type)
            else:
                self._send(
                    404,
                    json.dumps({"error": f"no route {self.path!r}"}).encode(),
                    "application/json",
                )
        except OSError:  # scraper went away mid-write
            self.close_connection = True


class _MetricsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, registry: Registry,
                 health_fn: Optional[Callable[[], dict]],
                 pre_render: List[Callable[[], None]],
                 routes: Dict[str, tuple]):
        super().__init__(addr, _MetricsHandler)
        self._registry = registry
        self._health_fn = health_fn
        self._pre_render = pre_render
        self._routes = routes

    def route(self, path: str):
        return self._routes.get(path)

    def render(self) -> str:
        for hook in self._pre_render:
            try:
                hook()
            except Exception:  # noqa: BLE001 - a broken scrape-time gauge
                # must degrade that gauge, not the whole scrape
                logger.exception("metrics pre-render hook failed")
        return self._registry.render()

    def health(self) -> dict:
        if self._health_fn is None:
            return {"status": "ok"}
        try:
            return self._health_fn()
        except Exception as e:  # noqa: BLE001 - health must always answer
            logger.exception("health callback failed")
            return {"status": "error", "error": f"{type(e).__name__}: {e}"}


class MetricsExporter:
    """Registry + HTTP listener on a daemon thread, as one unit."""

    def __init__(
        self,
        registry: Registry,
        *,
        port: int,
        host: str = "0.0.0.0",
        health_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry
        self._pre_render: List[Callable[[], None]] = []
        self._routes: Dict[str, tuple] = {}
        self._httpd = _MetricsHTTPServer(
            (host, port), registry, health_fn, self._pre_render, self._routes
        )
        self._thread: Optional[threading.Thread] = None

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def add_pre_render(self, hook: Callable[[], None]) -> None:
        """Run ``hook`` before every /metrics render (scrape-time gauges)."""
        self._pre_render.append(hook)

    def add_route(
        self,
        path: str,
        render_fn: Callable[[], str],
        content_type: str = "text/plain; version=0.0.4; charset=utf-8",
    ) -> None:
        """Serve ``render_fn()`` at ``path`` (e.g. the pod-scope merged
        page at ``/metrics/pod``). ``/metrics`` and ``/healthz`` stay
        reserved."""
        if path in ("/metrics", "/healthz"):
            raise ValueError(f"route {path!r} is reserved")
        self._routes[path] = (render_fn, content_type)

    def render(self) -> str:
        """Render exactly what a scrape would see (tests)."""
        return self._httpd.render()

    def start(self) -> "MetricsExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="metrics-exporter", daemon=True,
            )
            self._thread.start()
            logger.info(
                f"Metrics exporter serving http://{self.host}:{self.port}"
                f"/metrics"
            )
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5.0)
            self._thread = None
