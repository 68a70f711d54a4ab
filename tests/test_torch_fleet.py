"""The port's fleet (``fleet/``, ``cli/fleet.py``) against the JAX package's.

- ``HashRing.node_for`` / ``preference`` equal to JAX's over 1,000 keys
  while nodes are added, removed and re-weighted;
- ``classify_exit``, ``parse_prometheus_text`` and ``PodAggregator``
  equal to JAX's;
- a JAX ``FleetRouter`` and a port ``FleetRouter`` over the same stub
  engines (``tests/test_fleet.py``'s ``StubEngine``) take the same scripted
  steps — hash routing, random routing from one seed, spill on 429/503,
  shedding with ``Retry-After``, the health ladder (degrade, eject,
  readmit) from one injected health fetch, queue-pressure degrade, a
  cordon and readmit — and agree on every status, engine, header, ring
  state and counter;
- the port router's HTTP front end: request-id forwarding, ``/metrics``,
  ``/metrics/fleet``, ``/healthz``, malformed bodies;
- ``engine_argv`` is JAX's plus the port's ``--device`` and
  ``--long_scatter_chunks``, and the child's parsers read it back;
- ``python -m ml_recipe_tpu_torch.cli.fleet -c config/fleet.cfg`` with two
  ``--device cpu`` engines (bert-tiny, both caches, trace spans): hash
  affinity, hot answers equal to cold ones without a device batch, a
  SIGHUP rolling restart under live load with 0 failed requests, clean
  drains and 0 kernel builds, equal answers after it, every trace file
  holding the six serving spans of a router-forwarded request id, and a
  SIGTERM exit 0. The fleet process has its own deadline and its process
  group is killed past it.
"""

import json
import re
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from ml_recipe_tpu.config import parser as jax_parser
from ml_recipe_tpu.fleet import FleetRouter as JaxFleetRouter
from ml_recipe_tpu.fleet import HashRing as JaxHashRing
from ml_recipe_tpu.metrics import aggregator as jax_aggregator
from ml_recipe_tpu.resilience.supervisor import classify_exit as jax_classify
from ml_recipe_tpu_torch.config.parser import (
    get_fleet_parser,
    get_model_parser,
    get_params,
    get_serve_parser,
)
from ml_recipe_tpu_torch.fleet import FleetRouter, HashRing
from ml_recipe_tpu_torch.metrics import aggregator
from ml_recipe_tpu_torch.resilience.supervisor import classify_exit
from ml_recipe_tpu_torch.serve.cache import content_key

from helpers import write_vocab
from test_fleet import StubEngine
from test_torch_serve_cache import span_names_by_request

_REPO = Path(__file__).resolve().parents[1]
FLEET_DEADLINE_S = 150


# -- the ring --------------------------------------------------------------------


def _ring_trace(cls):
    ring = cls(replicas=16)
    keys = [f"doc-{i}" for i in range(1000)]
    out = []
    for step in (("add", "engine0", 1.0), ("add", "engine1", 1.0),
                 ("add", "engine2", 0.5), ("weight", "engine1", 0.25),
                 ("remove", "engine0", None), ("weight", "engine1", 1.0),
                 ("add", "engine0", 0.75), ("remove", "engine2", None)):
        kind, node, weight = step
        if kind == "add":
            ring.add(node, weight)
        elif kind == "weight":
            ring.set_weight(node, weight)
        else:
            ring.remove(node)
        out.append(([ring.node_for(k) for k in keys],
                    [ring.preference(k) for k in keys[::7]],
                    [ring.preference(k, limit=2) for k in keys[::13]],
                    ring.nodes(), len(ring)))
    return out


def test_ring_placement_equals_jax():
    got = _ring_trace(HashRing)
    assert got == _ring_trace(JaxHashRing)
    # every node owned keys at some step, and removals moved keys
    assert {n for placement, *_ in got for n in placement} == {
        "engine0", "engine1", "engine2"}


# -- exit classes and the aggregator ------------------------------------------------


@pytest.mark.parametrize("rc", [0, 1, 2, 75, 87, 89, -9, -15, -1, 137, 143,
                                129, 255])
def test_classify_exit_equals_jax(rc):
    assert classify_exit(rc) == jax_classify(rc)


_PAGES = {
    "a:1": ("# TYPE qa_requests_total counter\nqa_requests_total 7\n"
            "# TYPE qa_latency histogram\nqa_latency_bucket{le=\"0.1\"} 3\n"
            "qa_latency_sum 0.25\nqa_latency_count 3\n"
            "qa_info{precision=\"bf16\"} 1\ntrain_step_seconds_sum 2.0\n"
            "train_step_seconds_count 4\nbroken line here\n"),
    "b:2": ("# TYPE qa_requests_total counter\nqa_requests_total 5.5\n"
            "# TYPE qa_latency histogram\nqa_latency_bucket{le=\"0.1\"} 1\n"
            "qa_latency_sum 0.5\nqa_latency_count 1\n"
            "train_step_seconds_sum 3.0\ntrain_step_seconds_count 4\n"),
}


def _fetch(target):
    if target not in _PAGES:
        raise OSError("down")
    return _PAGES[target]


def test_aggregator_equals_jax():
    for page in _PAGES.values():
        assert aggregator.parse_prometheus_text(page) == \
            jax_aggregator.parse_prometheus_text(page)
    targets = ["a:1", "b:2", "c:3"]
    got = aggregator.PodAggregator(targets, fetch=_fetch).render()
    assert got == jax_aggregator.PodAggregator(targets, fetch=_fetch).render()
    assert "pod_hosts_unreachable 1" in got
    assert 'qa_requests_total_pod{agg="sum"} 12.5' in got


# -- the router against the JAX router ---------------------------------------------


@pytest.fixture()
def stubs():
    engines = [StubEngine(f"engine{i}") for i in range(3)]
    yield engines
    for s in engines:
        s.close()


def _router_state(router):
    health = router.health()
    engines = {nid: {k: v for k, v in st.items() if k not in ("host", "port")}
               for nid, st in health["engines"].items()}
    counters = {name: int(getattr(router, name).value) for name in (
        "m_requests", "m_spilled", "m_shed", "m_ejections", "m_readmissions",
        "m_degraded", "m_in_ring", "m_engines", "m_poll_failures")}
    return health["status"], engines, counters, \
        router.m_engine_requests.values()


def _handle(router, document):
    code, body, headers = router.handle(
        document, json.dumps({"question": "q ?",
                              "document": document}).encode("utf-8"))
    headers = dict(headers)
    return (code, headers.get("X-Fleet-Engine"), headers.get("Retry-After"),
            json.loads(body).get("answer"))


def _script(router, stubs, health):
    """The steps both routers take; returns every observable."""
    docs = [f"document number {i}" for i in range(24)]
    out = [[_handle(router, d) for d in docs], _router_state(router)]
    # the owner of doc 0 refuses: spill to the successor, degrade the owner
    owner = next(s for s in stubs if s.name == out[0][0][1])
    owner.qa_status = 503
    out += [[_handle(router, d) for d in docs[:8]], _router_state(router)]
    # every engine refuses: shed with Retry-After
    for s in stubs:
        s.qa_status = 429
    out += [[_handle(router, d) for d in docs[:3]], _router_state(router)]
    for s in stubs:
        s.qa_status = 200
    # the health ladder from one injected fetch: engine1 fails twice
    # (degrade, then eject), engine2 is saturated, then all recover
    health.update(engine1="fail", engine2="pressure")
    for _ in range(2):
        router._poll_once()
        out.append(_router_state(router))
    out += [[_handle(router, d) for d in docs], _router_state(router)]
    health.update(engine1="ok", engine2="ok")
    router._poll_once()
    out.append(_router_state(router))
    # a cordon (rolling restart) is not an ejection
    router.cordon("engine0")
    out += [[_handle(router, d) for d in docs[:6]], _router_state(router)]
    router.readmit("engine0")
    out += [[_handle(router, d) for d in docs], _router_state(router)]
    return out


def _health_fetch(stubs, health):
    ports = {s.port: s.name for s in stubs}

    def fetch(url, timeout):  # noqa: ARG001 - the router's fetch signature
        name = ports[int(url.split(":")[2].split("/")[0])]
        mode = health.get(name, "ok")
        if mode == "fail":
            raise OSError("connection refused")
        depth = 90 if mode == "pressure" else 0
        return json.dumps({"status": "ok", "queue_depth": depth,
                           "queue_limit": 100})

    return fetch


@pytest.mark.parametrize("routing", ["hash", "random"])
def test_router_decisions_equal_jax(stubs, routing):
    runs = []
    for cls in (JaxFleetRouter, FleetRouter):
        for s in stubs:
            s.qa_status, s.requests = 200, []
        health = {}
        router = cls([s.endpoint() for s in stubs], health_poll_s=30.0,
                     eject_after=2, routing=routing, rng_seed=7,
                     fetch=_health_fetch(stubs, health))
        try:
            runs.append(_script(router, stubs, health))
        finally:
            router._httpd.server_close()
    ref, got = runs
    assert got == ref
    status, engines, counters, _ = got[-1]
    # the script reached every rung of the ladder
    assert counters["m_ejections"] >= 1 and counters["m_readmissions"] >= 1
    assert counters["m_spilled"] >= 1 and counters["m_shed"] == 3
    assert counters["m_degraded"] >= 2 and status == "ok"


class _DrainingStub(StubEngine):
    """A stub whose next /v1/qa answer comes while a rolling restart takes
    it out of rotation: reading its status runs ``on_post`` (the router's
    cordon) and answers 503, as a draining engine does."""

    def __init__(self, name):
        self.on_post = None
        super().__init__(name)

    @property
    def qa_status(self):
        if self.on_post is not None:
            hook, self.on_post = self.on_post, None
            hook()
            self._status = 503  # the handler reads the status twice
        return self._status

    @qa_status.setter
    def qa_status(self, value):
        self._status = value


@pytest.mark.parametrize("cls,expect", [(JaxFleetRouter, 503),
                                        (FleetRouter, 200)],
                         ids=["jax_sheds", "port_reroutes"])
def test_request_racing_a_rolling_restart_is_rerouted(cls, expect):
    """The owner is cordoned while the request is on its way to it (the
    manager's next leg), with no spill left (``spill_retries`` 0): the JAX
    router sheds the request; the port's takes the current ring."""
    stubs = [_DrainingStub(f"engine{i}") for i in range(2)]
    router = cls([s.endpoint() for s in stubs], health_poll_s=30.0,
                 spill_retries=0)
    try:
        doc = "a document in flight"
        owner = router._ring.node_for(content_key(doc))
        stub = next(s for s in stubs if s.name == owner)
        stub.on_post = lambda: router.cordon(owner)
        code, engine, retry, _ = _handle(router, doc)
        assert code == expect
        if expect == 200:
            assert engine != owner and retry is None
            state = router.health()["engines"][owner]
            # a refusal from an engine leaving the ring is no failure
            assert state["consecutive_failures"] == 0
            assert int(router.m_degraded.value) == 0
            assert int(router.m_shed.value) == 0
    finally:
        router._httpd.server_close()
        for s in stubs:
            s.close()


def _request(url, payload=None, headers=None):
    data = None if payload is None else (
        payload if isinstance(payload, bytes)
        else json.dumps(payload).encode("utf-8"))
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode("utf-8"), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8"), dict(e.headers)


def test_router_http_front_end(stubs):
    router = FleetRouter([s.endpoint() for s in stubs[:2]],
                         health_poll_s=30.0).start()
    try:
        url = f"http://{router.host}:{router.port}"
        status, _, headers = _request(f"{url}/v1/qa", {
            "question": "q ?", "document": "traced document"})
        assert status == 200
        owner = next(s for s in stubs if s.name == headers["X-Fleet-Engine"])
        assert owner.requests == [headers["X-Request-Id"]]
        _, page, _ = _request(f"{url}/metrics")
        assert "fleet_requests_total 1" in page
        assert f'fleet_engine_requests_total{{engine="{owner.name}"}} 1' in page
        assert "fleet_hop_latency_seconds_bucket" in page
        _, fleet_page, _ = _request(f"{url}/metrics/fleet")
        assert 'qa_requests_total_pod{agg="sum"} 14' in fleet_page
        status, health, _ = _request(f"{url}/healthz")
        assert status == 200 and json.loads(health)["status"] == "ok"
        assert _request(f"{url}/v1/qa", b"not json")[0] == 400
        assert _request(f"{url}/v1/qa", {"question": "q"})[0] == 400
        assert _request(f"{url}/nowhere")[0] == 404
        assert len(owner.requests) == 1  # nothing malformed was forwarded
    finally:
        router.close()
    with pytest.raises(ValueError):
        FleetRouter(routing="round-robin")


# -- the fleet CLI ---------------------------------------------------------------------


def _fleet_namespaces(cfg_args):
    _, (fleet, serve, model) = get_params(
        (get_fleet_parser, get_serve_parser, get_model_parser), cfg_args)
    return fleet, serve, model


def test_engine_argv_is_jax_plus_device_and_scatter_threshold():
    from ml_recipe_tpu.cli.fleet import engine_argv as jax_engine_argv
    from ml_recipe_tpu_torch.cli.fleet import engine_argv

    args = ["-c", str(_REPO / "config" / "fleet.cfg"), "--vocab_file", "v.txt",
            "--device", "cpu", "--long_scatter_chunks", "12",
            "--trace_spans", "spans"]
    fleet, serve, model = _fleet_namespaces(args)
    assert (fleet.engines, fleet.routing, fleet.ring_replicas) == (2, "hash", 64)
    argv = engine_argv(serve, model)
    _, (_, jserve, jmodel) = jax_parser.get_params(
        (jax_parser.get_fleet_parser, jax_parser.get_serve_parser,
         jax_parser.get_model_parser),
        [a for a in args if a not in ("--device", "cpu")])
    ref = jax_engine_argv(jserve, jmodel)
    i = argv.index("--device")
    j = argv.index("--long_scatter_chunks")
    assert argv[i:i + 2] == ["--device", "cpu"]
    assert argv[j:j + 2] == ["--long_scatter_chunks", "12"]
    assert argv[:i] + argv[i + 2:j] + argv[j + 2:] == ref
    # the child's parsers read the forwarded flags back
    _, (child, child_model) = get_params(
        (get_serve_parser, get_model_parser), argv)
    for key in ("buckets", "serve_cache_bytes", "doc_cache_bytes",
                "trace_spans", "long_scatter_chunks", "quantize",
                "aot_cache", "hbm_preflight", "autotune"):
        assert getattr(child, key) == getattr(serve, key), key
    assert child_model.device == "cpu" and child_model.lowercase


_QUESTIONS = [
    ("what is the capital of england ?",
     "<P> London is the capital of England . </P> "
     "<P> Big Ben was built in the city . </P>"),
    ("what runs through london ?",
     "<P> The river Thames runs through London . </P> "
     "<P> The city was built over the river . </P>"),
    ("what was built in the city ?",
     "<P> Big Ben was built in the city . </P> <P> The tower is in London . "
     "</P> " * 3),
    ("what is the quick fox ?",
     "<P> The quick brown fox jumps over the lazy dog . </P> "
     "<P> The dog was lazy . </P>"),
]
_FIELDS = ("answer", "label", "score", "start", "end", "n_chunks")


def _metric(port, name):
    _, page, _ = _request(f"http://127.0.0.1:{port}/metrics")
    for line in page.splitlines():
        if line.split(" ")[0] == name:
            return float(line.split()[-1])
    raise AssertionError(f"{name} not on the page")


def _wait_for(path, deadline, proc, what):
    while not path.exists():
        assert proc.poll() is None, f"the fleet exited before {what}"
        assert time.monotonic() < deadline, f"no {what} before the deadline"
        time.sleep(0.2)


def test_fleet_cli_on_cpu_rolling_restart(tmp_path):
    vocab = write_vocab(tmp_path)
    ready = tmp_path / "ready.json"
    run_dir, spans = tmp_path / "run", tmp_path / "spans"
    env = dict(os.environ, PYTHONPATH=str(_REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ml_recipe_tpu_torch.cli.fleet",
         "-c", str(_REPO / "config" / "fleet.cfg"), "--model", "bert-tiny",
         "--vocab_file", str(vocab), "--device", "cpu", "--port", "0",
         "--buckets", "4x64", "--max_batch_delay_ms", "5",
         "--max_question_len", "16", "--doc_stride", "24",
         "--health_poll_s", "0.3", "--fleet_run_dir", str(run_dir),
         "--ready_file", str(ready), "--trace_spans", str(spans)],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    deadline = time.monotonic() + FLEET_DEADLINE_S
    try:
        _wait_for(ready, deadline, proc, "the ready file")
        info = json.loads(ready.read_text())
        url = f"http://{info['host']}:{info['port']}/v1/qa"
        ports = {e["node"]: e["port"] for e in info["engines"]}

        def ask(q, d):
            status, body, headers = _request(url, {"question": q,
                                                   "document": d})
            assert status == 200, body
            body = json.loads(body)
            return ({k: body[k] for k in _FIELDS},
                    headers["X-Fleet-Engine"], headers["X-Request-Id"])

        cold = [ask(q, d) for q, d in _QUESTIONS]
        batches = {n: _metric(p, "qa_batches_total") for n, p in ports.items()}
        hot = [ask(q, d) for q, d in _QUESTIONS]
        assert [c[:2] for c in cold] == [h[:2] for h in hot]  # affinity too
        assert {n: _metric(p, "qa_batches_total")
                for n, p in ports.items()} == batches  # no device batch
        hits = sum(_metric(p, "qa_chunk_cache_hits_total")
                   for p in ports.values())
        assert hits == sum(c[0]["n_chunks"] for c in cold)
        for p in ports.values():
            assert _metric(p, "qa_kernel_build_misses_total") == 0

        stop, results = threading.Event(), []

        def load():
            i = 0
            while not stop.is_set():
                q, d = _QUESTIONS[i % len(_QUESTIONS)]
                status, body, _ = _request(url, {"question": q, "document": d})
                results.append((status, json.loads(body).get("answer")))
                i += 1

        loader = threading.Thread(target=load)
        loader.start()
        try:
            os.kill(proc.pid, signal.SIGHUP)
            _wait_for(run_dir / "rolling_restart.json", deadline, proc,
                      "a rolling restart report")
        finally:
            stop.set()
            loader.join(timeout=60)
        report = json.loads((run_dir / "rolling_restart.json").read_text())
        assert report["passes"] == 1 and len(report["reports"]) == 2
        for leg in report["reports"]:
            assert leg["drain_exit"] == "clean", leg
            assert leg["build_misses"] == 0 and leg["new_port"] != 0, leg
        assert results and all(s == 200 for s, _ in results), results[:5]
        after = [ask(q, d) for q, d in _QUESTIONS]
        assert [a[0] for a in after] == [c[0] for c in cold]

        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=max(1, deadline - time.monotonic()))
        assert proc.returncode == 0, err[-3000:]
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert "Input fleet parameters:" in err
    logs = sorted(run_dir.glob("engine*.log"))
    assert len(logs) == 2
    served_before_restart = 0
    for log in logs:
        text = log.read_text()
        # two starts each (the rolling restart), both on the plain attention
        assert text.count("attention route plain") == 2, text[-2000:]
        # and two closes, each logging the process's final device batches
        # (its warmup forwards included: one a bucket, and the measured
        # cost's forwards where the tuning cache had none) and kernel
        # launches, 0 on the CPU
        closes = re.findall(r"serving closed after (\d+) device batches "
                            r"\((\d+) warmup\); kernel launches (\{.*\})",
                            text)
        assert len(closes) == 2, text[-2000:]
        assert all(int(w) >= 1 for _, w, _ in closes)
        assert not any(n for _, _, k in closes for n in json.loads(k).values())
        served_before_restart += int(closes[0][0]) - int(closes[0][1])
    assert served_before_restart >= sum(batches.values()) > 0
    # four engine processes, four trace files; the cold requests' ids were
    # the router's, and each carries the six serving spans
    files = sorted(spans.glob("serve_trace_*.json"))
    assert len(files) == 4
    by_rid = {}
    for f in files:
        by_rid.update(span_names_by_request(json.loads(f.read_text())))
    six = {"admission", "queue", "flush", "device", "span_reduce", "respond"}
    for _, _, rid in cold:
        assert by_rid[rid] == six, rid
    for _, _, rid in hot:
        assert by_rid[rid] == {"admission", "span_reduce", "respond"}, rid
