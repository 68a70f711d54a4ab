"""Elastic pod supervision (``--elastic on``) in the port against the JAX
package's, on the CPU.

- ``resilience/coordination.py``: host and child documents written by
  either package and read by the other; ``read_coordination_json``'s torn,
  absent, degraded, non-object and schema-mismatch cases, with the same
  results and backoff delays in both packages;
- ``parallel/dist.py`` ``elastic_world_override`` on valid and malformed
  values, ``parallel/mesh.py`` ``elastic_axes`` and ``parallel/plan.py``
  ``ParallelPlan.elastic_from_spec`` on a table of requests (the refusals
  and the ZeRO-1 re-pad included), against the JAX package's;
- ``ElasticSupervisor`` over scripted attempts and hand-written peer
  documents (the JAX package's ``test_resilience.py`` scenarios): the
  same outcomes, status, generation, live world, sidecar status and
  goodput-ledger events in both packages. One scenario pins where the
  port departs from the JAX package on purpose: a crash while a peer's
  heartbeat ages is held until the peer is fresh or lost, so the port
  relaunches on the live world (``["host-lost", "clean"]``) where the JAX
  supervisor first relaunches on the old one (``["crash", "host-lost",
  "clean"]``);
- the host-death drill with torch-only children (the JAX package's
  ``test_chaos_host_death_shrinks_mesh_and_resumes``): two hosts whose
  children meet in a gloo all-reduce each step; host 1 dies at step 4
  (``trainer.step:kill@4%host1``), host 0's child's collective fails,
  and host 0's supervisor declares host 1 lost, relaunches on the shrunk
  world (``data:2`` -> ``data:1``) and resumes from the step-3 checkpoint;
- one real drill of ``python -m ml_recipe_tpu_torch.cli.train --supervise
  --elastic on`` at bert-tiny: two host supervisors over gloo, ZeRO-1 on
  ``data:2``, host 1's child killed at its third step and host 1's
  supervisor killed as soon as its child is gone; host 0 ends rc 0 on
  ``data:1``, resumed from the epoch-1 checkpoint, with ``hosts_lost``
  1 in the ledger and ``mesh_shrunk`` in the flight recorder.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from ml_recipe_tpu.parallel import dist as jdist
from ml_recipe_tpu.parallel import mesh as jmesh
from ml_recipe_tpu.parallel.plan import ParallelPlan as JaxPlan
from ml_recipe_tpu.resilience import coordination as jcoord
from ml_recipe_tpu.resilience import supervisor as jsup
from ml_recipe_tpu_torch.metrics.artifacts import atomic_write_json, wall_now
from ml_recipe_tpu_torch.metrics.flightrec import (
    FLIGHTREC_PREFIX,
    newest_flight_record,
)
from ml_recipe_tpu_torch.metrics.goodput import read_ledger, summarize_events
from ml_recipe_tpu_torch.parallel import dist as tdist
from ml_recipe_tpu_torch.parallel import mesh as tmesh
from ml_recipe_tpu_torch.parallel.plan import ParallelPlan
from ml_recipe_tpu_torch.resilience import coordination as tcoord
from ml_recipe_tpu_torch.resilience import supervisor as tsup
from ml_recipe_tpu_torch.resilience.faults import KILL_EXIT_CODE

from helpers import make_tokenizer, nq_line, write_corpus

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (jcoord, jsup), "port": (tcoord, tsup)}


# -- the coordination plane ------------------------------------------------------

def test_constants_are_the_jax_package_s():
    for name in ("COORD_DIRNAME", "COORD_SCHEMA_VERSION", "ELASTIC_WORLD_ENV"):
        assert getattr(tcoord, name) == getattr(jcoord, name), name
    assert tdist.ELASTIC_WORLD_ENV == jcoord.ELASTIC_WORLD_ENV


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_pod_documents_cross_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer][0], PACKAGES[reader][0]
    pod = tmp_path / "pod"
    w.PodCoordinator(pod, host=1, n_hosts=2).publish(
        "restarting", generation=3, attempt=2, step=5, exit_class="crash",
        live_hosts=[0, 1])
    w.write_child_heartbeat(pod, 1, step=17)
    view = r.PodCoordinator(pod, host=0, n_hosts=2)
    doc = view.peer_state(1)
    assert {k: doc[k] for k in ("schema", "host", "status", "generation",
                                "attempt", "step", "exit_class",
                                "live_hosts")} == {
        "schema": 1, "host": 1, "status": "restarting", "generation": 3,
        "attempt": 2, "step": 5, "exit_class": "crash", "live_hosts": [0, 1]}
    assert abs(doc["heartbeat"] - wall_now()) < 60
    assert view.child_step(1) == 17 and view.child_step(0) is None
    assert set(view.peer_states()) == {1}


def _read_case(pkg, tmp_path, case):
    """One ``read_coordination_json`` case: (result or error text, the
    backoff delays it slept)."""
    coord = PACKAGES[pkg][0]
    path = tmp_path / pkg / "host-001.json"
    path.parent.mkdir()
    delays = []
    kw = {}
    if case == "torn_heals":
        path.write_text('{"schema": 1, "status": "runn')

        def sleep(s):
            delays.append(s)
            if len(delays) == 2:
                path.write_text('{"schema": 1, "status": "running"}')
    else:
        sleep = delays.append
        text = {"absent": None, "degrades": "not json at all",
                "old_schema": '{"schema": 0, "status": "running"}',
                "no_schema": '{"status": "running"}',
                "not_an_object": "[1, 2, 3]"}[case]
        if text is not None:
            path.write_text(text)
        if case == "degrades":
            kw["retries"] = 2
    try:
        got = coord.read_coordination_json(path, sleep=sleep, **kw)
    except coord.CoordinationSchemaError as e:
        got = ("schema error", str(e).split(" carries ")[1].split(",")[0])
    return got, delays


@pytest.mark.parametrize("case", ["absent", "torn_heals", "degrades",
                                  "old_schema", "no_schema", "not_an_object"])
def test_read_coordination_json_equals_jax(tmp_path, case):
    got = _read_case("port", tmp_path, case)
    assert got == _read_case("jax", tmp_path, case)
    want = {"absent": (None, []),
            "torn_heals": ({"schema": 1, "status": "running"}, [0.05, 0.1]),
            "degrades": (None, [0.05, 0.1]),
            "old_schema": (("schema error", "schema 0"), []),
            "no_schema": (("schema error", "schema None"), []),
            "not_an_object": (None, [])}[case]
    assert got == want


def test_supervisor_sidecar_is_a_coordination_document(tmp_path):
    path = tmp_path / "supervisor_state.json"
    tsup.write_supervisor_state(path, {"status": "running"})
    assert jsup.peek_supervisor_state(path)["schema"] == 1
    path.write_text('{"status": "running"}')
    assert tsup.peek_supervisor_state(path) is None


# -- the live world and the shrunk mesh -----------------------------------------

def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("raw", [None, "", "2:0", "1:0", "4:3", "2", "a:b",
                                 "2:2", "0:0", "2:-1", "2:0:1"])
def test_elastic_world_override_equals_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(tcoord.ELASTIC_WORLD_ENV, raising=False)
    else:
        monkeypatch.setenv(tcoord.ELASTIC_WORLD_ENV, raw)
    got = _outcome(tdist.elastic_world_override)
    assert got == _outcome(jdist.elastic_world_override)
    if raw in ("2", "a:b", "2:0:1"):
        assert got[0] == "ValueError" and "malformed" in got[1]


REQUESTS = [({"data": 8}, 4, 1), ({"data": 4}, 4, 1), ({"data": 3}, 2, 1),
            ({"data": 4, "seq": 2}, 4, 1), ({"data": 2, "seq": 2}, 3, 1),
            ({"data": 2, "seq": 8}, 4, 1), ({"seq": 4}, 2, 1),
            ({"data": 8}, 2, 4), ({"data": 8}, 8, 4)]


@pytest.mark.parametrize("axes,n,min_data", REQUESTS)
def test_elastic_axes_equals_jax(axes, n, min_data):
    got = _outcome(tmesh.elastic_axes, axes, n, min_data=min_data)
    assert got == _outcome(jmesh.elastic_axes, axes, n, min_data=min_data)
    if axes == {"data": 2, "seq": 8}:
        assert got[0] == "ElasticMeshError" and "Only the data axis" in got[1]


def _port_plan(monkeypatch, n, spec, elastic=True):
    monkeypatch.setattr(tdist, "process_count", lambda: n)
    monkeypatch.setattr(tdist, "process_index", lambda: 0)
    if elastic:
        return ParallelPlan.elastic_from_spec(spec)
    return ParallelPlan.from_spec(spec)


@pytest.mark.parametrize("spec,n", [("data:8", 4), ("data:4", 4),
                                    ("data:2,seq:2", 2), ("data:2,seq:8", 4),
                                    (None, 2)])
def test_elastic_plan_equals_jax(monkeypatch, spec, n):
    import jax

    want = _outcome(JaxPlan.elastic_from_spec, spec,
                    devices=jax.devices()[:n])
    got = _outcome(_port_plan, monkeypatch, n, spec)
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got[1] == want[1]
        return
    got, want = got[1], want[1]
    assert (got.describe(), got.shrunk, got.requested_axes) == (
        dict(want.describe()), want.shrunk, want.requested_axes)
    assert not _port_plan(monkeypatch, n, f"data:{n}", elastic=False).shrunk


def test_elastic_plan_repads_zero1_on_the_shrunk_mesh(monkeypatch):
    """The JAX package's re-pad pin: a leaf of 18 padded to 24 at data:8
    re-pads to 20 at the shrunk data:4 (a stale padding would corrupt the
    crop/zero-fill restore)."""
    import jax
    import numpy as np

    full = _port_plan(monkeypatch, 8, "data:8", elastic=False)
    shrunk = _port_plan(monkeypatch, 4, "data:8")
    got = [p.zero1([("mu", (18,))], min_size=0)["mu"] for p in (full, shrunk)]
    tree = {"mu": np.zeros(18, np.float32)}
    want = [JaxPlan.from_spec("data:8", devices=jax.devices()[:8]),
            JaxPlan.elastic_from_spec("data:8", devices=jax.devices()[:4])]
    want = [p.zero1(tree, min_size=0)["mu"] for p in want]
    assert [(z.axis, z.padded) for z in got] == [
        (z.axis, z.padded) for z in want] == [(0, 24), (0, 20)]


# -- ElasticSupervisor over scripted attempts ------------------------------------

def _write_peer(coord_dir, host, *, status="running", generation=0, age=0.0,
                step=None):
    atomic_write_json(os.path.join(str(coord_dir), f"host-{host:03d}.json"), {
        "schema": 1, "host": host, "pid": 0, "status": status,
        "generation": generation, "attempt": 0, "step": step,
        "exit_class": None, "live_hosts": None, "heartbeat": wall_now() - age})


def _elastic_supervisor(pkg, tmp, children, steps, *, host=0, n_hosts=2,
                        min_world=1, host_timeout=60.0):
    coord, sup = PACKAGES[pkg]
    child_iter, step_iter = iter(children), iter(steps)
    return sup.ElasticSupervisor(
        lambda i: next(child_iter),
        coordinator=coord.PodCoordinator(tmp / "pod", host=host,
                                         n_hosts=n_hosts),
        host_timeout=host_timeout, poll_interval=0.01, min_world=min_world,
        progress=lambda: next(step_iter),
        # any budget-charged restart would end the loop: a run that goes
        # on past a coordinated outcome shows the exemption
        policy=sup.RetryPolicy(max_restarts=0, crash_loop_window=10),
        sleep=lambda s: None, ledger_path=str(tmp / "goodput.jsonl"),
        flight_dir=str(tmp))


_EVENT_KEYS = ("ev", "host", "lost", "generation", "last_step", "live_hosts",
               "attempt", "resume_step", "returncode", "outcome", "step",
               "origin")


def _summary(sup, res, tmp):
    own = jcoord.read_coordination_json(tmp / "pod" / "host-000.json") or {}
    events = [{k: e[k] for k in _EVENT_KEYS if k in e}
              for e in read_ledger(tmp / "goodput.jsonl")]
    found = newest_flight_record(tmp)
    return dict(
        status=res.status, exit_code=res.exit_code, outcomes=res.outcomes(),
        generation=sup.generation, live=sup.live_hosts(), world=sup.world
        if sup.live_hosts() else None, done=sorted(sup._done_hosts),
        why={h: ("host death" in w, "crash-loop" in w)
             for h, w in sup._lost_why.items()},
        own=(own.get("status"), own.get("generation")), events=events,
        hosts_lost=summarize_events(read_ledger(tmp / "goodput.jsonl"))[
            "hosts_lost"],
        flight=sorted({e["kind"] for e in found[1]["events"]})
        if found else [], diagnosis=("--min_world floor" in res.diagnosis,
                                     "rendezvous" in res.diagnosis))


SCENARIOS = {
    # a peer at a higher generation: the pod restarts, nothing is lost
    "generation_bump": (dict(peers=[(1, dict(generation=3))]),
                        dict(children=[1, 0], steps=[None, None, None, 1])),
    # a silently stale heartbeat: a dead host, the world shrinks
    "stale_heartbeat": (dict(peers=[(1, dict(age=120.0, step=41))], beat=41),
                        dict(children=[1, 0], steps=[None, None, None, 7],
                             host_timeout=5.0)),
    # a peer that published 'failed': a classified crash-loop
    "peer_failed": (dict(peers=[(1, dict(status="failed"))]),
                    dict(children=[1, 0], steps=[None, None, None, 2])),
    "min_world_floor": (dict(peers=[(1, dict(age=120.0))]),
                        dict(children=[1], steps=[None, None],
                             host_timeout=5.0, min_world=2)),
    "host0_lost_with_peers": (
        dict(peers=[(0, dict(age=120.0)), (2, {})]),
        dict(children=[1], steps=[None, None], host=1, n_hosts=3,
             host_timeout=5.0)),
    "sole_survivor": (dict(peers=[(0, dict(age=120.0))]),
                      dict(children=[1, 0], steps=[None, None, None, 5],
                           host=1, host_timeout=5.0)),
    "done_peer": (dict(peers=[(1, dict(status="done"))]),
                  dict(children=[0], steps=[None, 3], host_timeout=5.0)),
}


def _run_scenario(pkg, tmp, setup, kw):
    tmp.mkdir()
    (tmp / "pod").mkdir()
    for host, fields in setup["peers"]:
        _write_peer(tmp / "pod", host, **fields)
    if "beat" in setup:
        PACKAGES[pkg][0].write_child_heartbeat(tmp / "pod", 1,
                                               step=setup["beat"])
    sup = _elastic_supervisor(pkg, tmp, **kw)
    res = sup.run()
    out = _summary(sup, res, tmp)
    if kw.get("host", 0) != 0:   # the sidecar of host 0 is not this one's
        out["own"] = None
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_elastic_scenarios_equal_jax(tmp_path, name):
    setup, kw = SCENARIOS[name]
    got = _run_scenario("port", tmp_path / "port", setup, kw)
    assert got == _run_scenario("jax", tmp_path / "jax", setup, kw)
    expect = {"generation_bump": ["pod-restart", "clean"],
              "stale_heartbeat": ["host-lost", "clean"],
              "peer_failed": ["host-lost", "clean"],
              "min_world_floor": ["host-lost"],
              "host0_lost_with_peers": ["host-lost"],
              "sole_survivor": ["host-lost", "clean"],
              "done_peer": ["clean"]}[name]
    assert got["outcomes"] == expect
    if name == "stale_heartbeat":
        assert got["hosts_lost"] == 1 and "host_lost" in got["flight"]
        assert got["world"] == {"hosts": [0], "size": 1, "rank": 0,
                                "generation": 1}
        lost = [e for e in got["events"] if e["ev"] == "host_lost"]
        assert lost[0]["lost"] == 1 and lost[0]["last_step"] == 41


def _aging_peer(tmp, host_timeout):
    """A peer whose last heartbeat is about to go stale: its host died just
    as this host's child crashed."""
    (tmp / "pod").mkdir(parents=True)
    _write_peer(tmp / "pod", 1, age=host_timeout - 0.4)


def test_crash_beside_a_dying_peer_waits_for_the_live_world(tmp_path):
    """The port's departure from the JAX package, pinned: this host's child
    crashes (rc 1: the gloo collective failed when the peer died) while
    the peer's heartbeat still looks live. The JAX supervisor bumps the
    generation and relaunches on the OLD world (its next child would
    rendezvous with the dead host); the port holds the relaunch until the
    peer is fresh or lost, so the crash becomes host-lost and the next
    attempt runs on the live world of one."""
    runs = {}
    for pkg in ("jax", "port"):
        tmp = tmp_path / pkg
        _aging_peer(tmp, 2.0)
        worlds = []
        sup_holder = []

        def launch(i, rcs=iter([1, 0, 0])):
            worlds.append(sup_holder[0].world["size"])
            return next(rcs)
        coord, sup_mod = PACKAGES[pkg]
        sup = sup_mod.ElasticSupervisor(
            launch, coordinator=coord.PodCoordinator(tmp / "pod", host=0,
                                                     n_hosts=2),
            host_timeout=2.0, poll_interval=0.05,
            progress=lambda: None, sleep=lambda s: None,
            policy=sup_mod.RetryPolicy(max_restarts=3, crash_loop_window=10))
        sup_holder.append(sup)
        t0 = time.monotonic()
        res = sup.run()
        runs[pkg] = (res.outcomes(), worlds, time.monotonic() - t0)
    assert runs["jax"][:2] == (["crash", "clean"], [2, 2])
    assert runs["port"][:2] == (["host-lost", "clean"], [2, 1])
    assert runs["port"][2] < 2.0 + 1.0


def test_crash_beside_a_live_peer_is_a_crash(tmp_path):
    """A peer whose supervisor keeps publishing is fresh: the hold ends
    after a poll or two and the crash stays a crash, as in the JAX
    package; the generation moves one past the attempt's."""
    (tmp_path / "pod").mkdir()
    stop = threading.Event()
    peer = tcoord.PodCoordinator(tmp_path / "pod", host=1, n_hosts=2)

    def publish():
        while not stop.is_set():
            peer.publish("running", generation=0, attempt=0)
            time.sleep(0.02)

    thread = threading.Thread(target=publish)
    thread.start()
    try:
        rcs = iter([1, 0])
        sup = tsup.ElasticSupervisor(
            lambda i: next(rcs), coordinator=tcoord.PodCoordinator(
                tmp_path / "pod", host=0, n_hosts=2),
            host_timeout=5.0, poll_interval=0.05, progress=lambda: None,
            sleep=lambda s: None,
            policy=tsup.RetryPolicy(max_restarts=3, crash_loop_window=10))
        res = sup.run()
    finally:
        stop.set()
        thread.join()
    assert res.outcomes() == ["crash", "clean"]
    assert sup.live_hosts() == [0, 1] and sup.generation == 1


# -- the host-death drill with torch-only children -------------------------------

# Two hosts, one process each. Per step each child fires the fault site,
# works, beats its child heartbeat and meets the other in a gloo
# all-reduce: when a participant dies the survivor's collective fails (gloo
# does not wedge). Host 0 appends goodput windows and saves a checkpoint
# after each collective. The mesh comes from ParallelPlan.elastic_from_spec
# over the CURRENT world (MLRT_ELASTIC_WORLD), so a shrunk relaunch
# re-derives data:2 -> data:1.
_ELASTIC_CHILD = textwrap.dedent(
    """
    import json, os, pathlib, sys, time
    import torch
    import torch.distributed as dist

    size, rank = (int(x) for x in os.environ["MLRT_ELASTIC_WORLD"].split(":"))
    host = int(os.environ["MLRT_HOST"])
    exp, n_steps, port = (pathlib.Path(sys.argv[1]), int(sys.argv[2]),
                          sys.argv[3])

    from ml_recipe_tpu_torch.metrics.artifacts import atomic_write_json
    from ml_recipe_tpu_torch.metrics.flightrec import FlightRecorder
    from ml_recipe_tpu_torch.metrics.goodput import append_event
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.parallel.plan import ParallelPlan
    from ml_recipe_tpu_torch.resilience import faults
    from ml_recipe_tpu_torch.resilience.coordination import (
        write_child_heartbeat)

    torch.set_num_threads(1)
    if size > 1:
        pdist.initialize_distributed(
            init_method=f"tcp://127.0.0.1:{port}", world_size=size,
            rank=rank, backend="gloo", timeout_s=60.0)
    plan = ParallelPlan.elastic_from_spec("data:2")
    (exp / f"plan-w{size}-h{host}.json").write_text(json.dumps({
        "axes": plan.describe(), "shrunk": plan.shrunk,
        "requested": plan.requested_axes}))
    if plan.shrunk and rank == 0:
        rec = FlightRecorder.open_in(str(exp), process_index=10 + host)
        rec.record("mesh_shrunk", old=plan.requested_axes,
                   new=plan.describe())
        rec.dump("elastic")
    ckpt, ledger = exp / "ckpt.json", str(exp / "goodput.jsonl")
    w, start = 0.0, 0
    if ckpt.exists():
        state = json.loads(ckpt.read_text())
        w, start = state["w"], state["step"]
    if rank == 0:
        append_event(ledger, "run_start", step=start + 1)
    for step in range(start + 1, n_steps + 1):
        faults.fire("trainer.step")
        t0 = time.time()
        time.sleep(0.05)
        w += 1.0
        write_child_heartbeat(exp / "pod", host, step=step)
        if rank == 0:
            append_event(ledger, "steps", first_step=step, last_step=step,
                         steps=1, productive_s=time.time() - t0)
        if size > 1:
            dist.all_reduce(torch.ones(1))
        if rank == 0:
            atomic_write_json(str(ckpt), {"step": step, "w": w})
    pdist.shutdown()
    print(f"DONE host={host} step={n_steps} w={w}")
    """
)


DRILL_DEADLINE_S = 60


def _child_env(size, rank, host):
    env = dict(os.environ)
    env["MLRT_FAULTS"] = "trainer.step:kill@4%host1"
    env["MLRT_HOST"] = str(host)
    env["MLRT_ELASTIC_WORLD"] = f"{size}:{rank}"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_host_death_shrinks_the_mesh_and_resumes(tmp_path):
    import torch_ddp_worker as worker

    exp = tmp_path / "exp"
    (exp / "pod").mkdir(parents=True)
    script = exp / "child.py"
    script.write_text(_ELASTIC_CHILD)
    n_steps, port = 5, worker.free_port()

    def spawn(size, rank, host, tag):
        fh = open(exp / f"{tag}.log", "ab")
        return subprocess.Popen(
            [sys.executable, str(script), str(exp), str(n_steps), str(port)],
            env=_child_env(size, rank, host), cwd=str(REPO), stdout=fh,
            stderr=fh)

    # host 1: its "supervisor" publishes while its child lives; when the
    # fault kills the child the host is gone: silence, no restart
    doomed = {}

    def run_doomed_host():
        coord = tcoord.PodCoordinator(exp / "pod", host=1, n_hosts=2)
        child = spawn(2, 1, 1, "host1")
        while child.poll() is None:
            coord.publish("running", generation=0, attempt=0,
                          step=coord.child_step(1))
            time.sleep(0.1)
        doomed["rc"] = child.returncode

    host1 = threading.Thread(target=run_doomed_host)
    host1.start()
    sup_holder = []

    def launch(attempt_i):
        world = sup_holder[0].world
        return spawn(world["size"], world["rank"], 0, f"host0-a{attempt_i}")

    def progress():
        path = exp / "ckpt.json"
        return json.loads(path.read_text())["step"] if path.exists() else None

    sup = tsup.ElasticSupervisor(
        launch, coordinator=tcoord.PodCoordinator(exp / "pod", host=0,
                                                  n_hosts=2),
        host_timeout=2.0, poll_interval=0.25, kill_grace=5.0,
        progress=progress, policy=tsup.RetryPolicy(
            max_restarts=2, backoff_base=0.01, backoff_max=0.02),
        state_path=str(exp / "supervisor_state.json"),
        ledger_path=str(exp / "goodput.jsonl"), flight_dir=str(exp))
    sup_holder.append(sup)
    # the deadline: SIGTERM, which the supervisor forwards to its child
    # before it stands down
    timer = threading.Timer(DRILL_DEADLINE_S, os.kill,
                            (os.getpid(), signal.SIGTERM))
    timer.start()
    t0 = time.monotonic()
    try:
        result = sup.run()
    finally:
        timer.cancel()
    elapsed = time.monotonic() - t0
    host1.join(timeout=30)
    assert not host1.is_alive()
    assert doomed["rc"] == KILL_EXIT_CODE

    # the JAX drill's outcomes; the survivor's child failed its collective
    # itself (gloo raises, rc 1) where the JAX child wedges and is killed
    assert result.status == "clean", result.diagnosis
    assert result.outcomes() == ["host-lost", "clean"]
    assert result.attempts[0].returncode == 1
    assert elapsed < 30
    assert "host death" in sup._lost_why[1]

    full = json.loads((exp / "plan-w2-h0.json").read_text())
    assert full == {"axes": {"data": 2}, "shrunk": False,
                    "requested": {"data": 2}}
    shrunk = json.loads((exp / "plan-w1-h0.json").read_text())
    assert shrunk == {"axes": {"data": 1}, "shrunk": True,
                      "requested": {"data": 2}}
    assert result.attempts[0].step_after == 3   # step 4 never landed
    assert result.attempts[1].step_before == 3
    assert progress() == n_steps
    assert f"DONE host=0 step={n_steps} w={float(n_steps)}" in (
        exp / "host0-a1.log").read_text(errors="replace")

    s = summarize_events(read_ledger(exp / "goodput.jsonl"))
    assert s["attempts"] == 2 and s["hosts_lost"] == 1
    assert s["badput_s"]["restart_downtime"] > 0
    assert s["recomputed_steps"] == 1   # step 4 ran, was lost, ran again
    accounted = s["productive_s"] + sum(s["badput_s"].values())
    assert accounted == pytest.approx(s["total_wall_s"], rel=1e-9)
    kinds = set()
    for path in exp.glob(f"{FLIGHTREC_PREFIX}*.json"):
        kinds.update(e["kind"] for e in json.loads(path.read_text())["events"])
    assert {"host_lost", "mesh_shrunk"} <= kinds


# -- the CLI drill: cli.train --supervise --elastic on at bert-tiny ------------

CLI_DEADLINE_S = 150


def _cli_cfg(root: Path, corpus: Path) -> Path:
    cfg = root / "elastic.cfg"
    cfg.write_text("\n".join([
        "model=bert-tiny", f"vocab_file={root / 'vocab.txt'}",
        f"data_path={corpus}", f"processed_data_path={root / 'proc'}",
        f"dump_dir={root / 'results'}", "experiment_name=pod",
        "max_seq_len=64", "max_question_len=16", "doc_stride=16",
        "hidden_dropout_prob=0.0", "attention_probs_dropout_prob=0.0",
        "compute_dtype=float32", "n_epochs=2", "train_batch_size=8",
        "test_batch_size=8", "batch_split=2", "n_jobs=1", "seed=0",
        "lr=1e-3"]) + "\n")
    return cfg


def _children_of(pid: int):
    try:
        text = Path(f"/proc/{pid}/task/{pid}/children").read_text()
    except OSError:
        return []
    return [int(p) for p in text.split()]


def _gone(pid: int) -> bool:
    try:
        return Path(f"/proc/{pid}/stat").read_text().split(") ")[1][0] == "Z"
    except (OSError, IndexError):
        return True


@pytest.fixture(scope="module")
def cli_drill(tmp_path_factory):
    import torch_ddp_worker as worker

    root = tmp_path_factory.mktemp("elastic_cli")
    make_tokenizer(root)
    corpus = write_corpus(root, [nq_line(example_id=str(i))
                                 for i in range(24)])
    port = worker.free_port()
    argv = ["-m", "ml_recipe_tpu_torch.cli.train", "-c",
            str(_cli_cfg(root, corpus)), "--device", "cpu", "--supervise",
            "--elastic", "on", "--host_timeout", "2", "--coord_poll", "0.2",
            "--backoff_base", "0.01", "--backoff_max", "0.02",
            "--watchdog_timeout", "120", "--goodput_ledger",
            "--flight_recorder", "--optimizer_sharding", "zero1",
            "--mesh", "data:2", "--dist_world_size", "2",
            "--dist_init_method", f"tcp://127.0.0.1:{port}",
            "--fault_plan", "trainer.step:kill@3%host1"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, *argv, "--local_rank", str(h)], cwd=str(REPO),
        env=env, stdout=subprocess.DEVNULL,
        stderr=open(root / f"host{h}.log", "w")) for h in range(2)]
    deadline = time.monotonic() + CLI_DEADLINE_S
    try:
        # host 1 dies with its child: its supervisor is killed as soon as
        # the child is gone (a dead host is silent)
        child = None
        while time.monotonic() < deadline and procs[1].poll() is None:
            kids = _children_of(procs[1].pid)
            if child is None and kids:
                child = kids[0]
            if child is not None and _gone(child):
                procs[1].send_signal(signal.SIGKILL)
                break
            time.sleep(0.005)
        procs[1].wait(timeout=10)
        rc = procs[0].wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return root, rc


def test_cli_elastic_drill_ends_on_the_shrunk_world(cli_drill):
    root, rc = cli_drill
    exp = root / "results" / "pod"
    log = (root / "host0.log").read_text(errors="replace")
    assert rc == 0, log[-4000:]
    state = json.loads((exp / "supervisor_state.json").read_text())
    assert state["outcomes"] == ["host-lost", "clean"]
    assert state["status"] == "clean"
    # the relaunch joined the live world of one and resumed epoch 1's
    # checkpoint (two steps of 8 rows an epoch)
    assert "launching attempt 2 generation 1 as rank 0/1 (live hosts [0])" \
        in log
    assert "last.ch (step 2)" in log
    assert "ELASTIC RESUME: mesh re-derived" in log
    from ml_recipe_tpu_torch.train.checkpoint import peek_global_step

    # a resume replays every epoch from the checkpoint's step, as in the
    # JAX package: two more epochs of two steps
    assert peek_global_step(exp / "last.ch") == 6
    events = read_ledger(exp / "goodput.jsonl")
    assert summarize_events(events)["hosts_lost"] == 1
    kinds = set()
    for path in exp.glob(f"{FLIGHTREC_PREFIX}*.json"):
        kinds.update(e["kind"] for e in json.loads(path.read_text())["events"])
    assert {"host_lost", "mesh_shrunk"} <= kinds


def test_sigterm_inside_a_step_takes_effect_at_its_end(tmp_path,
                                                       monkeypatch):
    """A coordinated stop (SIGTERM) that lands inside an optimizer step is
    held to the step's end, so ``interrupt.ch`` holds whole steps: here the
    signal arrives as step 1 starts, the step completes and the
    checkpoint is of step 2 with the weights the two steps made."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.train import checkpoint as tckpt

    make_tokenizer(tmp_path)
    corpus = write_corpus(tmp_path, [nq_line(example_id=str(i))
                                     for i in range(24)])
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        ["-c", str(_cli_cfg(tmp_path, corpus)), "--device", "cpu"])
    monkeypatch.delenv(tsup.SUPERVISED_ENV, raising=False)
    trainer = train_cli.build_trainer(params, model_params)
    step = trainer.train_step

    def signalled(inputs, labels):
        if trainer.global_step == 1:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return step(inputs, labels)

    trainer.train_step = signalled
    train_cli.train(trainer, params)
    path = tmp_path / "results" / "pod" / "interrupt.ch"
    assert len(trainer.history) == 2
    assert tckpt.peek_global_step(path) == 2
    saved = tckpt.read_state(path)["model"]
    import numpy as np
    from ml_recipe_tpu_torch.models import to_jax_params

    live = to_jax_params(trainer.model.state_dict())
    import jax

    for (k, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(saved),
                              jax.tree_util.tree_leaves_with_path(live)):
        assert np.array_equal(np.asarray(a), np.asarray(b)), k

