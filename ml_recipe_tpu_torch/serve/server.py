"""stdlib-only HTTP front end for the QA serving engine (the port of
``ml_recipe_tpu/serve/server.py``).

Endpoints:

- ``POST /v1/qa`` — body ``{"question": ..., "document": ...}``; answers
  ``200 {"answer", "label", "score", ...}``. Backpressure maps to status
  codes: ``429`` queue-full (bounded queue, explicit reject-on-full),
  ``503`` draining/shutdown, ``400`` unservable request, ``504`` deadline.
- ``GET /healthz`` — ``{"status": "ok" | "draining"}`` (ready/liveness).
- ``GET /metrics`` — Prometheus text format (latency histogram +
  p50/p95/p99 gauges, queue depth, batch occupancy, padding waste).

Shutdown: SIGTERM (and SIGINT) triggers a DRAIN — admissions stop with clean 503s, every admitted
request is flushed through normal batch launches to a real response, then
the listener closes and the process exits 0. No request that got a 200
admission is ever dropped on the floor.

Threading: ``ThreadingHTTPServer`` handler threads block on their own
request's completion ticket; device batches are serialized on the batcher
thread. An in-flight handler counter lets the drain path wait until the
last response byte is written before the process exits.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..metrics import trace as trace_mod
from ..resilience.faults import fire as _fault
from .batcher import DrainingError, QueueFullError
from .engine import QAEngine, RequestRejected

logger = logging.getLogger(__name__)

_MAX_BODY_BYTES = 4 << 20  # 4 MB of JSON is far beyond any bucketable doc


class _QAHandler(BaseHTTPRequestHandler):
    # the default HTTP/1.0 would close the connection per request and make
    # client keep-alive benches meaningless
    protocol_version = "HTTP/1.1"

    server: "_QAHTTPServer"

    # -- plumbing --------------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet stderr; route to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, payload: dict, *, extra_headers=()) -> None:
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, content_type: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- routes ----------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        if self.path == "/healthz":
            status = "draining" if self.server.draining else "ok"
            engine = self.server.engine
            self._send_json(200, {
                "status": status,
                "buckets": [str(b) for b in engine.grid],
                # queue pressure, for a router's health-driven shedding
                "queue_depth": int(engine.m_queue_depth.value),
                "queue_limit": int(engine.batcher.queue_size),
            })
        elif self.path == "/metrics":
            self._send_text(
                200, self.server.engine.render_metrics(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        else:
            self._send_json(404, {"error": f"no route {self.path!r}"})

    def _read_body(self) -> bytes:
        """Read the request body, or None-equivalent sentinel on a missing/
        oversized Content-Length. ALWAYS consumes (or kills) the body on a
        keep-alive connection: replying without reading it would leave the
        bytes in the stream to be parsed as the next request line."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length <= 0 or length > _MAX_BODY_BYTES:
            self.close_connection = True  # can't safely skip an unknown body
            return b""
        return self.rfile.read(length)

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        body = self._read_body()
        if self.path != "/v1/qa":
            self._send_json(404, {"error": f"no route {self.path!r}"})
            return
        if self.server.draining:
            self._send_json(503, {"error": "draining"})
            return
        if not body:
            self._send_json(400, {"error": "missing or oversized body"})
            return
        try:
            payload = json.loads(body)
            question = payload["question"]
            document = payload["document"]
        except (ValueError, KeyError, TypeError):
            self._send_json(
                400, {"error": 'body must be {"question": ..., "document": ...}'}
            )
            return

        # fleet chaos site: 'fleet.engine:kill@N' (resilience/faults.py)
        # kills this engine process on its Nth admitted request, the drill
        # that proves the router ejects a dead engine mid-load (%hostN
        # scopes it: the fleet manager stamps MLRT_HOST with the index)
        _fault("fleet.engine")

        # a router hop forwards its own request id; threading it through
        # the ticket keeps the trace spans joinable across the hop
        request_id = self.headers.get("X-Request-Id") or None

        # the 200 send happens INSIDE the in-flight window: the drain path
        # waits on this counter, so decrementing before the response bytes
        # are written would let the process exit mid-write
        self.server.handler_began()
        try:
            ticket = self.server.engine.submit(
                question, document, request_id=request_id)
            # 'respond' span: admission done -> response bytes written (the
            # handler-side wait the client experiences)
            with trace_mod.span(
                "respond", cat="serve",
                args={"request_id": ticket.request_id},
            ):
                result = ticket.result(timeout=self.server.request_timeout_s)
                payload = result.to_json()
                payload["request_id"] = ticket.request_id
                self._send_json(200, payload)
        except QueueFullError as e:
            self._send_json(
                429, {"error": f"queue full: {e}"},
                extra_headers=(("Retry-After", "1"),),
            )
        except DrainingError:
            self._send_json(503, {"error": "draining"})
        except RequestRejected as e:
            self._send_json(400, {"error": str(e)})
        except TimeoutError as e:
            self._send_json(504, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 - a request must get SOME answer
            logger.exception("request failed")
            try:
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:  # client already gone mid-write
                self.close_connection = True
        finally:
            self.server.handler_done()


class _QAHTTPServer(ThreadingHTTPServer):
    # a wedged client connection must not block process exit; drain
    # correctness is handled by the in-flight handler counter instead
    daemon_threads = True
    engine: QAEngine
    draining: bool
    request_timeout_s: float

    def __init__(self, addr, engine: QAEngine, request_timeout_s: float):
        super().__init__(addr, _QAHandler)
        self.engine = engine
        self.draining = False
        self.request_timeout_s = request_timeout_s
        self._active = 0
        self._active_cv = threading.Condition()

    def handler_began(self) -> None:
        with self._active_cv:
            self._active += 1

    def handler_done(self) -> None:
        with self._active_cv:
            self._active -= 1
            self._active_cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._active_cv:
            while self._active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._active_cv.wait(remaining)
        return True


class QAServer:
    """Engine + HTTP listener + SIGTERM drain, as one runnable unit."""

    def __init__(
        self,
        engine: QAEngine,
        *,
        host: str = "127.0.0.1",
        port: int = 8080,
        request_timeout_s: float = 60.0,
        drain_timeout_s: float = 30.0,
    ):
        self.engine = engine
        self.drain_timeout_s = drain_timeout_s
        self._httpd = _QAHTTPServer((host, port), engine, request_timeout_s)
        self._serve_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        """Serve in a background thread (tests; the CLI uses run_forever)."""
        if self._serve_thread is not None:
            return
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http", daemon=True
        )
        self._serve_thread.start()
        logger.info("serving QA on http://%s:%d (buckets: %s)",
                    self.host, self.port,
                    ",".join(str(b) for b in self.engine.grid))

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> drain-and-exit (a supervisor forwards SIGTERM
        to its child and expects it to stand down cleanly)."""
        def _on_signal(signum, frame):  # noqa: ARG001 - signal API
            logger.info("received %s; draining", signal.Signals(signum).name)
            # flip the admission gate HERE, not in shutdown(): from the
            # signal instant every new POST gets a clean 503 while requests
            # admitted before it flush to real answers
            self._httpd.draining = True
            self._stop.set()

        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def shutdown(self) -> None:
        """Drain in-flight + queued work, answer it, then close the listener.

        Order matters: (1) stop admitting (new POSTs get 503 immediately),
        (2) flush the engine queue so every admitted ticket completes,
        (3) wait for handler threads to write their last response bytes,
        (4) stop the accept loop and close the socket.
        """
        self._httpd.draining = True
        self.engine.drain(timeout=self.drain_timeout_s)
        if not self._httpd.wait_idle(self.drain_timeout_s):
            logger.warning(
                "drain: handler threads still active after %.0fs; exiting "
                "anyway", self.drain_timeout_s,
            )
        self.engine.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
            self._serve_thread = None
        logger.info("drain complete; listener closed")

    def wait(self) -> None:
        """Block until a signal (or .stop()) requests shutdown."""
        while not self._stop.wait(0.2):
            pass

    def run_forever(self) -> None:
        """Start, then block until a signal (or .stop()) triggers the drain.
        Returns after a clean drain so the caller can exit 0."""
        self.install_signal_handlers()
        self.start()
        try:
            self.wait()
        finally:
            self.shutdown()

    def stop(self) -> None:
        self._stop.set()
