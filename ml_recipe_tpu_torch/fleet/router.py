"""Shared-nothing HTTP router tier in front of N QA serving engines (the
port of ``ml_recipe_tpu/fleet/router.py``; stdlib only, it imports no
torch).

The router owns no model state at all — it is a pure stdlib
``ThreadingHTTPServer`` (the same HTTP plumbing as ``serve/server.py``)
that hashes each request's document content hash onto a consistent-hash
ring (``fleet/ring.py``) and forwards the request to the owning engine,
so repeat traffic for a document lands on the engine whose tier-1/-2
caches (serve/cache.py) are already warm.

Health-first load shedding, in escalation order:

1. **weight-reduce** — an engine that fails a health poll, reports queue
   pressure past ``queue_pressure``, or answers a forward with 429/503 has
   its ring weight cut to ``degrade_weight`` (fewer virtual nodes, smaller
   keyspace share);
2. **eject** — ``eject_after`` consecutive failures remove it from the
   ring entirely (``fleet_ejections_total``); its keys spill to the next
   ring position, everyone else's stay put;
3. **spill** — a forward that fails mid-flight (connection refused, 429,
   503) is retried once per remaining ring position up to
   ``spill_retries`` (``fleet_spilled_requests_total``);
4. **shed** — only when NO engine can take the request does the router
   itself answer 503 with ``Retry-After`` (``fleet_shed_requests_total``).

A recovered engine (health poll passing again) is restored to full weight
and re-admitted to the ring (``fleet_readmissions_total``). Rolling
restarts (fleet/manager.py) use ``cordon``/``replace_engine``/``readmit``
to take one engine out of rotation without counting it as a failure.

Observability: the router assigns every request an ``X-Request-Id`` it
forwards to the engine (the engine threads it through its trace spans and
echoes it in the response), and splits latency per hop — the
engine-reported service time vs the router-added overhead
(``fleet_hop_latency_seconds``). ``GET /metrics`` is the router's own
registry; ``GET /metrics/fleet`` aggregates every engine's /metrics page
through ``metrics/aggregator.py`` (sum/min/max + per-engine series).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from ..metrics.aggregator import PodAggregator
from ..metrics.registry import Registry
from ..serve.cache import content_key
from .ring import HashRing

logger = logging.getLogger(__name__)

_MAX_BODY_BYTES = 4 << 20  # mirrors serve/server.py's request-body cap

_REQUEST_IDS = itertools.count(1)


@dataclass
class EngineEndpoint:
    """One engine's address + optional checkpoint label (A/B routing)."""

    node_id: str
    host: str
    port: int
    checkpoint: Optional[str] = None

    @property
    def target(self) -> str:
        return f"{self.host}:{self.port}"


@dataclass
class _EngineState:
    endpoint: EngineEndpoint
    weight: float = 1.0
    in_ring: bool = True
    cordoned: bool = False
    ejected: bool = False
    consecutive_failures: int = 0
    queue_depth: int = 0
    queue_limit: int = 0
    last_status: str = "unknown"
    lock: threading.Lock = field(default_factory=threading.Lock)


class _RouterHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    server: "_RouterHTTPServer"

    def log_message(self, fmt, *args):  # quiet stderr; route to logging
        logger.debug("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, code: int, payload: dict, *, extra_headers=()) -> None:
        self._send_raw(code, json.dumps(payload).encode("utf-8"),
                       "application/json", extra_headers=extra_headers)

    def _send_raw(self, code: int, body: bytes, content_type: str,
                  *, extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        router = self.server.router
        if self.path == "/healthz":
            self._send_json(200, router.health())
        elif self.path == "/metrics":
            self._send_raw(200, router.metrics.render().encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
        elif self.path == "/metrics/fleet":
            try:
                page = router.render_fleet_metrics()
            except Exception as e:  # noqa: BLE001 - aggregation mid-topology-
                # change must 500 this scrape, not kill the handler thread
                logger.exception("fleet aggregation failed")
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_raw(200, page.encode("utf-8"),
                           "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._send_json(404, {"error": f"no route {self.path!r}"})

    def _read_body(self) -> bytes:
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
        if not body:
            self._send_json(400, {"error": "missing or oversized body"})
            return
        try:
            payload = json.loads(body)
            document = payload["document"]
            if not isinstance(document, str):
                raise TypeError("document must be a string")
        except (ValueError, KeyError, TypeError):
            self._send_json(
                400, {"error": 'body must be {"question": ..., "document": ...}'}
            )
            return
        code, resp_body, headers = self.server.router.handle(document, body)
        self._send_raw(code, resp_body, "application/json",
                       extra_headers=headers)


class _RouterHTTPServer(ThreadingHTTPServer):
    # a wedged client must never block router shutdown; engines own the
    # drain correctness story (serve/server.py)
    daemon_threads = True
    router: "FleetRouter"

    def __init__(self, addr, router: "FleetRouter"):
        super().__init__(addr, _RouterHandler)
        self.router = router


class FleetRouter:
    """Consistent-hash router + health poller over N engine endpoints."""

    def __init__(
        self,
        engines: Sequence[EngineEndpoint] = (),
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        ring_replicas: int = 64,
        health_poll_s: float = 1.0,
        eject_after: int = 2,
        degrade_weight: float = 0.25,
        queue_pressure: float = 0.75,
        spill_retries: int = 1,
        request_timeout_s: float = 60.0,
        routing: str = "hash",
        rng_seed: int = 0,
        fetch=None,
    ):
        if routing not in ("hash", "random"):
            raise ValueError(f"routing must be 'hash' or 'random', got {routing!r}")
        self.health_poll_s = float(health_poll_s)
        self.eject_after = max(1, int(eject_after))
        self.degrade_weight = float(degrade_weight)
        self.queue_pressure = float(queue_pressure)
        self.spill_retries = max(0, int(spill_retries))
        self.request_timeout_s = float(request_timeout_s)
        self.routing = routing
        self._rng = random.Random(rng_seed)
        self._fetch = fetch  # injectable transport (tests); None = urllib
        self._ring = HashRing(replicas=ring_replicas)
        self._states: Dict[str, _EngineState] = {}
        self._lock = threading.Lock()
        self._id_prefix = f"r{os.getpid()}"

        m = self.metrics = Registry()
        self.m_requests = m.counter(
            "fleet_requests_total", "QA requests arriving at the router.")
        self.m_engine_requests = m.labeled_gauge(
            "fleet_engine_requests_total",
            "Completed forwards per engine (200s served).", "engine")
        self.m_spilled = m.counter(
            "fleet_spilled_requests_total",
            "Forwards retried on the successor ring position after an "
            "engine failure (connection error, 429, 503).")
        self.m_shed = m.counter(
            "fleet_shed_requests_total",
            "Requests the router answered 503 + Retry-After itself "
            "(whole tier saturated or empty).")
        self.m_ejections = m.counter(
            "fleet_ejections_total",
            "Engines removed from the ring by the health ladder.")
        self.m_readmissions = m.counter(
            "fleet_readmissions_total",
            "Ejected/cordoned engines restored to the ring.")
        self.m_degraded = m.counter(
            "fleet_degraded_total",
            "Weight reductions (health failure or queue pressure).")
        self.m_in_ring = m.gauge(
            "fleet_engines_in_ring", "Engines currently on the ring.")
        self.m_engines = m.gauge(
            "fleet_engines_total", "Engines known to the router.")
        self.m_poll_failures = m.counter(
            "fleet_health_poll_failures_total",
            "Health polls that errored or reported an unhealthy engine.")
        self.m_latency = m.histogram(
            "fleet_request_latency_seconds",
            "End-to-end request latency at the router.")
        self.m_hop = m.histogram(
            "fleet_hop_latency_seconds",
            "Router-added overhead per forwarded request: end-to-end at "
            "the router minus the engine-reported service time for the "
            "same forwarded request id.")

        for ep in engines:
            self.add_engine(ep)

        self._httpd = _RouterHTTPServer((host, port), self)
        self._serve_thread: Optional[threading.Thread] = None
        self._poll_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- addresses -------------------------------------------------------------

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- membership (manager-facing) -------------------------------------------

    def add_engine(self, endpoint: EngineEndpoint) -> None:
        with self._lock:
            if endpoint.node_id in self._states:
                raise ValueError(f"engine {endpoint.node_id!r} already registered")
            self._states[endpoint.node_id] = _EngineState(endpoint=endpoint)
            self._ring.add(endpoint.node_id)
            self._update_ring_gauges()

    def cordon(self, node_id: str) -> None:
        """Take ``node_id`` out of rotation (rolling restart) — removed
        from the ring but NOT counted as an ejection."""
        with self._lock:
            st = self._states[node_id]
            st.cordoned = True
            st.in_ring = False
            self._ring.remove(node_id)
            self._update_ring_gauges()

    def replace_engine(self, node_id: str, host: str, port: int) -> None:
        """Point ``node_id`` at its relaunched process (new ephemeral
        port). The node stays cordoned until :meth:`readmit`."""
        with self._lock:
            st = self._states[node_id]
            st.endpoint.host = host
            st.endpoint.port = port
            st.consecutive_failures = 0
            st.queue_depth = 0
            st.last_status = "unknown"

    def readmit(self, node_id: str) -> None:
        """Restore a cordoned engine to the ring at full weight."""
        with self._lock:
            st = self._states[node_id]
            st.cordoned = False
            st.ejected = False
            st.weight = 1.0
            st.consecutive_failures = 0
            if not st.in_ring:
                st.in_ring = True
                self._ring.add(node_id, 1.0)
                self.m_readmissions.inc()
            self._update_ring_gauges()

    def endpoints(self) -> List[EngineEndpoint]:
        with self._lock:
            return [st.endpoint for st in self._states.values()]

    def _update_ring_gauges(self) -> None:
        # caller holds self._lock
        self.m_in_ring.set(sum(1 for st in self._states.values() if st.in_ring))
        self.m_engines.set(len(self._states))

    # -- health ladder ---------------------------------------------------------

    def _note_failure(self, node_id: str, reason: str) -> None:
        """One rung down the shedding ladder for ``node_id``."""
        with self._lock:
            st = self._states.get(node_id)
            if st is None or st.cordoned:
                return
            st.consecutive_failures += 1
            st.last_status = reason
            if st.consecutive_failures >= self.eject_after:
                if st.in_ring:
                    st.in_ring = False
                    st.ejected = True
                    self._ring.remove(node_id)
                    self.m_ejections.inc()
                    self._update_ring_gauges()
                    logger.warning("engine %s ejected from ring (%s)",
                                   node_id, reason)
            elif st.in_ring and st.weight > self.degrade_weight:
                st.weight = self.degrade_weight
                self._ring.set_weight(node_id, st.weight)
                self.m_degraded.inc()
                logger.warning("engine %s weight-reduced to %.2f (%s)",
                               node_id, st.weight, reason)

    def _note_healthy(self, node_id: str, depth: int, limit: int) -> None:
        with self._lock:
            st = self._states.get(node_id)
            if st is None or st.cordoned:
                return
            st.queue_depth = depth
            st.queue_limit = limit
            st.last_status = "ok"
            pressured = limit > 0 and depth >= self.queue_pressure * limit
            if pressured:
                # healthy but saturated: shrink its keyspace share without
                # advancing the ejection counter — backpressure is load to
                # move, not a failure to punish
                st.consecutive_failures = 0
                if st.in_ring and st.weight > self.degrade_weight:
                    st.weight = self.degrade_weight
                    self._ring.set_weight(node_id, st.weight)
                    self.m_degraded.inc()
                return
            st.consecutive_failures = 0
            if st.in_ring and st.weight < 1.0:
                st.weight = 1.0
                self._ring.set_weight(node_id, 1.0)
            elif not st.in_ring:
                st.in_ring = True
                st.ejected = False
                st.weight = 1.0
                self._ring.add(node_id, 1.0)
                self.m_readmissions.inc()
                self._update_ring_gauges()
                logger.info("engine %s re-admitted to ring", node_id)

    def _poll_once(self) -> None:
        with self._lock:
            targets = [
                (nid, st.endpoint.host, st.endpoint.port)
                for nid, st in self._states.items() if not st.cordoned
            ]
        for nid, host, port in targets:
            try:
                doc = json.loads(self._http_get(
                    f"http://{host}:{port}/healthz",
                    timeout=max(0.5, min(self.health_poll_s, 2.0)),
                ))
            except (OSError, ValueError) as e:
                self.m_poll_failures.inc()
                self._note_failure(nid, f"poll: {type(e).__name__}")
                continue
            if doc.get("status") == "ok":
                self._note_healthy(
                    nid,
                    int(doc.get("queue_depth", 0) or 0),
                    int(doc.get("queue_limit", 0) or 0),
                )
            else:
                self.m_poll_failures.inc()
                self._note_failure(nid, f"status={doc.get('status')!r}")

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.health_poll_s):
            self._poll_once()

    def _http_get(self, url: str, timeout: float) -> str:
        if self._fetch is not None:
            return self._fetch(url, timeout)
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.read().decode("utf-8")

    # -- request path ----------------------------------------------------------

    def _candidates(self, document: str) -> List[str]:
        limit = 1 + self.spill_retries
        if self.routing == "random":
            nodes = self._ring.nodes()
            with self._lock:
                self._rng.shuffle(nodes)
            return nodes[:limit]
        return self._ring.preference(content_key(document), limit=limit)

    def _reroute(self, document: str, exclude) -> List[str]:
        """One ring member outside ``exclude`` for a request whose candidate
        left the ring or was replaced mid-route (the current ring's choice:
        the key's next owner, or a random member)."""
        if self.routing == "random":
            nodes = [n for n in self._ring.nodes() if n not in exclude]
            with self._lock:
                self._rng.shuffle(nodes)
            return nodes[:1]
        return [n for n in self._ring.preference(content_key(document))
                if n not in exclude][:1]

    def _moved(self, node_id: str, endpoint: Tuple[str, int]) -> bool:
        """``node_id`` left the ring or got a new process since its
        forward was addressed to ``endpoint``."""
        with self._lock:
            st = self._states.get(node_id)
            return st is None or not st.in_ring or \
                (st.endpoint.host, st.endpoint.port) != endpoint

    def handle(self, document: str, body: bytes) -> Tuple[int, bytes, List]:
        """Route one /v1/qa body; returns (status, body, extra headers).

        Beyond the JAX router: a request whose candidate leaves the ring or
        is replaced between routing and its answer (a rolling restart moves
        from one engine to the next, an ejection) takes the current ring
        instead of being shed, and that engine's refusal is not counted as
        its failure; the JAX router sheds such a request with a 503."""
        self.m_requests.inc()
        rid = f"{self._id_prefix}-{next(_REQUEST_IDS)}"
        t0 = time.perf_counter()
        candidates = self._candidates(document)
        tried = set()
        attempted = False
        # every reroute follows a membership change; bound them anyway
        reroutes = 2 * len(self._states) + 2
        while candidates:
            node_id = candidates.pop(0)
            tried.add(node_id)
            with self._lock:
                st = self._states.get(node_id)
                in_ring = st is not None and st.in_ring
                if in_ring:
                    endpoint = (st.endpoint.host, st.endpoint.port)
            if not in_ring:
                if reroutes > 0:
                    reroutes -= 1
                    candidates += self._reroute(document,
                                                tried | set(candidates))
                continue
            if attempted:
                # a prior ring position already refused this request: this
                # forward IS the spill to the successor
                self.m_spilled.inc()
            attempted = True
            outcome = self._forward(
                f"http://{endpoint[0]}:{endpoint[1]}/v1/qa", body, rid)
            if outcome is None or outcome[0] in (429, 503):
                if reroutes > 0 and self._moved(node_id, endpoint):
                    reroutes -= 1
                    # a replacement back on the ring may take it again; a
                    # node off the ring is never in its preference
                    tried.discard(node_id)
                    candidates += self._reroute(document,
                                                tried | set(candidates))
                    continue
                self._note_failure(
                    node_id, "forward: connection" if outcome is None
                    else f"forward: {outcome[0]}")
                continue
            status, resp_body = outcome
            total_s = time.perf_counter() - t0
            if status == 200:
                self.m_latency.observe(total_s)
                with self._lock:
                    self.m_engine_requests.inc(node_id)
                try:
                    engine_ms = float(json.loads(resp_body).get("latency_ms", 0.0))
                except (ValueError, TypeError) as e:
                    logger.debug("unparseable engine response timing: %s", e)
                    engine_ms = 0.0
                self.m_hop.observe(max(0.0, total_s - engine_ms / 1e3))
            return status, resp_body, [
                ("X-Request-Id", rid), ("X-Fleet-Engine", node_id),
            ]
        # every candidate refused (or the ring is empty): the tier is
        # saturated — shed at the router with an honest retry hint
        self.m_shed.inc()
        return 503, json.dumps({
            "error": "fleet saturated: no engine accepted the request",
            "request_id": rid,
        }).encode("utf-8"), [("Retry-After", "1"), ("X-Request-Id", rid)]

    def _forward(self, url: str, body: bytes,
                 rid: str) -> Optional[Tuple[int, bytes]]:
        """POST ``body`` to one engine. None = connection-level failure."""
        req = urllib.request.Request(url, data=body, headers={
            "Content-Type": "application/json",
            "X-Request-Id": rid,
        })
        try:
            with urllib.request.urlopen(
                req, timeout=self.request_timeout_s
            ) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read() or b"{}"
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            logger.warning("forward to %s failed: %s", url, e)
            return None

    # -- introspection ---------------------------------------------------------

    def health(self) -> dict:
        with self._lock:
            engines = {
                nid: {
                    "host": st.endpoint.host,
                    "port": st.endpoint.port,
                    "checkpoint": st.endpoint.checkpoint,
                    "in_ring": st.in_ring,
                    "cordoned": st.cordoned,
                    "weight": st.weight,
                    "queue_depth": st.queue_depth,
                    "consecutive_failures": st.consecutive_failures,
                    "last_status": st.last_status,
                }
                for nid, st in self._states.items()
            }
            saturated = not any(st.in_ring for st in self._states.values())
        return {
            "status": "saturated" if saturated else "ok",
            "routing": self.routing,
            "engines": engines,
        }

    def render_fleet_metrics(self) -> str:
        """Aggregate every engine's /metrics page (metrics/aggregator.py)."""
        with self._lock:
            targets = [st.endpoint.target for st in self._states.values()]
        fetch = None
        if self._fetch is not None:
            fetch = lambda target: self._fetch(  # noqa: E731
                f"http://{target}/metrics", 2.0)
        return PodAggregator(targets, fetch=fetch).render()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FleetRouter":
        if self._serve_thread is None:
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, name="fleet-router",
                daemon=True)
            self._serve_thread.start()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="fleet-health", daemon=True)
            self._poll_thread.start()
            logger.info("fleet router on http://%s:%d (%d engines, %s routing)",
                        self.host, self.port, len(self._states), self.routing)
        return self

    def close(self) -> None:
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=5.0)
            self._poll_thread = None
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5.0)
            self._serve_thread = None
