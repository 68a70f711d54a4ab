"""The port's resilience subsystem against the JAX package's, on the CPU.

Every case feeds the same inputs to ``ml_recipe_tpu.resilience`` and
``ml_recipe_tpu_torch.resilience`` and compares what comes out:

- ``FaultPlan``: parsed specs, which arrivals fire, ``%hostN`` scoping,
  ``!once`` markers across plans and across a process, and the rejects
  (same ``ValueError`` text);
- ``retry_transient``: results, raised errors and the backoff delays;
- the watchdog, with injected exit functions and sub-second deadlines:
  the label and code it fires with, ticks that defer it, nested frames;
- ``Supervisor`` over scripted child exits: outcomes, the seeded backoff
  sequence, the crash-loop abort and the sidecar JSON (pid and time
  masked); ``build_child_argv``;
- ``peek_global_step`` on the port's single-file and sharded checkpoints
  and on the JAX package's, torn, missing and mid-swap ones;
- the fault sites: the checkpoint writer's leave the previous checkpoint,
  ``loader.read`` retries, ``dist.barrier`` counts arrivals alone,
  ``loader.prefetch`` surfaces on the consumer and ``fleet.engine`` ends
  a request before the engine sees it;
- the CLI drill: ``python -m ml_recipe_tpu_torch.cli.train --supervise
  --fault_plan 'trainer.step:kill@2!once'`` on bert-tiny over a
  ``tests/helpers`` corpus, beside the JAX package's ``supervise_cli`` on
  the same corpus, from the same initial checkpoint (dropout 0, f32): the
  same attempt events in the goodput ledgers (outcomes, return codes,
  resumed steps), the same sidecar, and final parameters within the
  training parity tolerance of ``tests/test_torch_train.py`` (2e-5).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from ml_recipe_tpu.resilience import faults as jfaults
from ml_recipe_tpu.resilience import supervisor as jsup
from ml_recipe_tpu.resilience import watchdog as jwd
from ml_recipe_tpu.train import checkpoint as jckpt
from ml_recipe_tpu_torch.resilience import faults as tfaults
from ml_recipe_tpu_torch.resilience import supervisor as tsup
from ml_recipe_tpu_torch.resilience import watchdog as twd
from ml_recipe_tpu_torch.train import checkpoint as tckpt

from helpers import make_tokenizer, nq_line, write_corpus

REPO = Path(__file__).resolve().parents[1]

# end params after 3 Adam steps at lr 1e-3 (tests/test_torch_train.py's
# PARAM_ATOL: an Adam step moves each element by ~lr whatever the gradient)
PARAM_ATOL = 2e-5
DRILL_DEADLINE_S = 240
DRILL_FLAGS = ["--max_restarts", "2", "--backoff_base", "0.01",
               "--backoff_max", "0.02", "--watchdog_timeout", "120",
               "--fault_plan", "trainer.step:kill@2!once"]

# -- FaultPlan -----------------------------------------------------------------

SPECS = [
    "ckpt.pre_manifest:kill@2!once; loader.read:raise@1x3;"
    "trainer.step:stall~5;dist.barrier:raise@4x*",
    "trainer.step:kill@4%host1; loader.read:raise@2",
    "fleet.engine:slow@3x2~0.25;checkpoint.persist:kill!once%host0",
    "",
]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parses_as_the_jax_package(spec):
    j = jfaults.FaultPlan.parse(spec)
    t = tfaults.FaultPlan.parse(spec)
    as_tuples = lambda plan: [
        (s.site, s.kind, s.hit, s.count, s.seconds, s.once, s.host)
        for s in plan.specs]
    assert as_tuples(t) == as_tuples(j)
    assert bool(t) == bool(j)
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES
    assert tfaults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 89


@pytest.mark.parametrize("bad", [
    "trainer.stpe:kill", "trainer.step:explode", "trainer.step", "x:y:z",
    "trainer.step:kill@0", "trainer.step:kill%h1", "trainer.step:kill%host",
])
def test_fault_plan_rejects_as_the_jax_package(bad):
    with pytest.raises(ValueError) as j:
        jfaults.FaultPlan.parse(bad)
    with pytest.raises(ValueError) as t:
        tfaults.FaultPlan.parse(bad)
    assert str(t.value) == str(j.value)


def _arrivals(mod, spec, sites, state_dir=None):
    """Which arrivals raise, for a plan of ``raise``/``slow`` specs."""
    plan = mod.FaultPlan.parse(spec, state_dir=state_dir)
    out = []
    for site in sites:
        try:
            plan.fire(site)
            out.append((site, "ok"))
        except mod.FaultError as e:
            out.append((site, str(e)))
    return out, {s: plan.hits(s) for s in set(sites)}


def test_fault_plan_fires_on_the_same_arrivals(monkeypatch):
    monkeypatch.delenv(tfaults.HOST_ENV, raising=False)
    spec = ("loader.read:raise@2x2;trainer.step:raise@3x*;"
            "dist.barrier:slow@1~0.001;trainer.eval_step:raise%host1")
    sites = (["loader.read"] * 5 + ["trainer.step"] * 5 + ["dist.barrier"] * 2
             + ["trainer.eval_step"] * 2)
    t = _arrivals(tfaults, spec, sites)
    assert t == _arrivals(jfaults, spec, sites)
    assert t[0][-2] == ("trainer.eval_step", "ok")   # scoped to host 1
    # %hostN: the action is scoped, the counters advance on every host
    monkeypatch.setenv(tfaults.HOST_ENV, "1")
    t = _arrivals(tfaults, spec, sites)
    assert t == _arrivals(jfaults, spec, sites)
    assert t[0][-2][1].startswith("injected fault at trainer.eval_step")


def test_fault_once_markers_survive_restarts_and_processes(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv(tfaults.HOST_ENV, "0")
    spec = "loader.read:raise@1!once;trainer.step:raise@2!once"
    sites = ["loader.read", "trainer.step", "trainer.step"]
    results = {}
    for name, mod in (("jax", jfaults), ("port", tfaults)):
        state = tmp_path / name
        first = _arrivals(mod, spec, sites, state_dir=str(state))
        # a new plan over the same state dir (the restarted process) does
        # not fire again
        second = _arrivals(mod, spec, sites, state_dir=str(state))
        results[name] = (first, second, sorted(os.listdir(state)))
    assert results["port"] == results["jax"]
    assert all(r == "ok" for _, r in results["port"][1][0])
    # a real second process reads the markers the first one left
    code = ("from ml_recipe_tpu_torch.resilience.faults import FaultPlan;"
            f"p = FaultPlan.parse({spec!r}, state_dir={str(tmp_path / 'port')!r});"
            "[p.fire(s) for s in ('loader.read', 'trainer.step', "
            "'trainer.step')]; print('quiet')")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0 and "quiet" in res.stdout, res.stderr[-2000:]


def test_install_plan_and_env_plan(monkeypatch):
    try:
        monkeypatch.setenv(tfaults.FAULT_ENV, "loader.read:raise@1")
        tfaults._plan, tfaults._env_checked = None, False
        with pytest.raises(tfaults.FaultError):
            tfaults.fire("loader.read")
        assert tfaults.install_plan("trainer.step:raise@2").hits(
            "trainer.step") == 0
        tfaults.fire("trainer.step")
        with pytest.raises(tfaults.FaultError, match="arrival 2"):
            tfaults.fire("trainer.step")
        tfaults.install_plan(None)
        tfaults.fire("trainer.step")   # disarmed: one None check
    finally:
        tfaults.install_plan(None)


def _retry_trace(mod, failures, retries):
    sleeps, calls = [], []

    def fn():
        calls.append(len(calls))
        if len(calls) <= failures:
            raise OSError(f"flaky {len(calls)}")
        return "done"

    try:
        out = mod.retry_transient(fn, retries=retries, base_delay=0.05,
                                  factor=3.0, sleep=sleeps.append,
                                  what="drill read")
    except OSError as e:
        out = f"raised {e}"
    return out, len(calls), sleeps


@pytest.mark.parametrize("failures,retries", [(0, 3), (2, 3), (3, 3), (5, 2)])
def test_retry_transient_matches(failures, retries):
    assert (_retry_trace(tfaults, failures, retries)
            == _retry_trace(jfaults, failures, retries))


def test_loader_read_site_retries_through_the_plan():
    from ml_recipe_tpu_torch.data.loader import read_with_retry

    try:
        tfaults.install_plan("loader.read:raise@1x2")
        assert read_with_retry(["a", "b"], 1, retries=3, base_delay=0.0) == "b"
        tfaults.install_plan("loader.read:raise@1x*")
        with pytest.raises(tfaults.FaultError):
            read_with_retry(["a"], 0, retries=1, base_delay=0.0)
    finally:
        tfaults.install_plan(None)


# -- the watchdog ---------------------------------------------------------------

def _watchdog_fire(mod, scenario):
    fired, hooks = [], []
    done = threading.Event()

    def exit_fn(code):
        fired.append(code)
        done.set()

    wd = mod.Watchdog(0.5, poll_interval=0.02, exit_fn=exit_fn,
                      on_timeout=hooks.append)
    try:
        scenario(wd)
        # a missed 0.5 s deadline fires within one poll after it
        done.wait(1.5)
    finally:
        wd.stop()
    return fired, hooks


def _stalled_step(wd):
    with wd.watch("train epoch 1") as tick:
        tick("train step 0")
        wd.note_progress(1)
        time.sleep(1.0)


def _ticked(wd):
    with wd.watch("train epoch 1") as tick:
        for i in range(6):
            tick(f"train step {i}")
            time.sleep(0.08)


def _nested(wd):
    with wd.watch("train epoch 1"):
        with wd.watch("checkpoint save", 2.0):
            time.sleep(0.7)   # inside the generous inner frame: no fire
        time.sleep(1.0)       # the outer frame's clock restarted: fires


@pytest.mark.parametrize("scenario,expect", [
    (_stalled_step, ([87], ["train step 0"])),
    (_ticked, ([], [])),
    (_nested, ([87], ["train epoch 1"])),
], ids=["stall", "ticks", "nested"])
def test_watchdog_fires_as_the_jax_package(scenario, expect, capfd):
    assert _watchdog_fire(twd, scenario) == expect
    assert _watchdog_fire(jwd, scenario) == expect
    if expect[0]:
        err = capfd.readouterr().err
        assert err.count("WATCHDOG: 'train") == 2
        assert twd.WATCHDOG_EXIT_CODE == jwd.WATCHDOG_EXIT_CODE == 87


def test_watchdog_heartbeat_and_rate_limited_beat():
    for mod in (twd, jwd):
        wd = mod.Watchdog(30.0)
        beats = []
        assert wd.heartbeat_age() is None
        wd.add_on_beat(beats.append, min_interval=60.0)
        with wd.watch("x") as tick:
            wd.note_progress(3)
            tick()
            wd.note_progress(4)
        wd.stop()
        assert beats == [3] and 0.0 <= wd.heartbeat_age() < 5.0
    assert twd.install(None) is None and twd.current() is None
    with twd.watched("nothing installed") as tick:
        tick("no-op")


# -- the supervisor -------------------------------------------------------------

def _supervise(mod, children, steps, policy_kw, tmp_path):
    sleeps = []
    child_iter, step_iter = iter(children), iter(steps)
    state = tmp_path / f"{mod.__name__.split('.')[0]}_state.json"
    result = mod.Supervisor(
        lambda i: next(child_iter), progress=lambda: next(step_iter),
        policy=mod.RetryPolicy(**policy_kw), sleep=sleeps.append,
        state_path=state).run()
    doc = json.loads(state.read_text())
    for key in ("pid", "updated_at"):
        doc.pop(key)
    return (result.status, result.exit_code, result.outcomes(),
            [(a.returncode, a.step_before, a.step_after, a.backoff)
             for a in result.attempts],
            sleeps, result.diagnosis.split("\n")[0], doc)


SCRIPTS = {
    "crash then clean": ([89, 0], [None, 1, 1, 3], {}),
    "hang, preempt, clean": ([87, 75, 0], [None, 1, 1, 2, 2, 5], {}),
    "crash loop": ([1, 1, 1, 1], [None] * 8, dict(crash_loop_window=2)),
    "budget": ([1, 1, 0], [None, None, None, None, None, None],
               dict(max_restarts=1, crash_loop_window=5)),
    "signals": ([-15, -9, 137, 0], [None, 1, 1, 2, 2, 2, 2, 3],
                dict(seed=7, backoff_base=0.5, jitter=0.2)),
    "seeded backoff": ([1, 1, 1, 1, 0], [None] * 10,
                       dict(seed=3, crash_loop_window=9, backoff_max=3.0)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_supervisor_decides_as_the_jax_package(name, tmp_path):
    children, steps, policy = SCRIPTS[name]
    t = _supervise(tsup, children, steps, policy, tmp_path)
    j = _supervise(jsup, children, steps, policy, tmp_path)
    assert t == j
    if name == "crash loop":
        assert t[0] == "crash-loop" and "no global_step progress" in t[5]


@pytest.mark.parametrize("rc", [0, 87, 75, -15, -9, 143, 137, 129, 1, 89, 2])
def test_classify_exit_matches(rc):
    assert tsup.classify_exit(rc) == jsup.classify_exit(rc)


@pytest.mark.parametrize("argv,resume", [
    (["-c", "a.cfg", "--supervise", "--lr", "1e-3"], None),
    (["--supervise=true", "--last", "old.ch", "--seed", "0"], "new.ch"),
    (["--last=old.ch", "--device", "cpu", "--supervise"], "new.ch"),
    (["--last", "old.ch"], None),
])
def test_build_child_argv_matches(argv, resume):
    assert (tsup.build_child_argv(argv, resume=resume)
            == jsup.build_child_argv(argv, resume=resume))


def test_sidecar_is_read_by_both_and_schema_checked(tmp_path):
    path = tmp_path / "supervisor_state.json"
    tsup.write_supervisor_state(path, {"attempts": 2, "outcomes": ["hang"]})
    assert jsup.peek_supervisor_state(path) == tsup.peek_supervisor_state(path)
    path.write_text(json.dumps({"attempts": 1, "schema": 99}))
    assert tsup.peek_supervisor_state(path) is None
    assert tsup.peek_supervisor_state(tmp_path / "absent.json") is None


# -- peek_global_step ------------------------------------------------------------

def _tiny_model():
    import torch

    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel

    cfg = EncoderConfig(vocab_size=40, hidden_size=16, num_layers=1,
                        num_heads=2, intermediate_size=32,
                        max_position_embeddings=34, num_labels=5)
    return QAModel(cfg, dtype=torch.float32, device="cpu")


def test_peek_global_step_on_both_layouts_of_both_packages(tmp_path):
    model = _tiny_model()
    port_single = tmp_path / "port.ch"
    tckpt.save_state_dict(port_single, model=model, global_step=7)
    port_sharded = tmp_path / "port_sharded.ch"
    tckpt.save_state_dict_sharded(port_sharded, model=model, global_step=9)
    jax_single = tmp_path / "jax.ch"
    jckpt.save_state_dict(str(jax_single), params={"w": np.arange(4.0)},
                          global_step=5)
    jax_sharded = tmp_path / "jax_sharded.ch"
    jckpt.save_state_dict_sharded(str(jax_sharded),
                                  params={"w": np.arange(4.0)}, global_step=6)
    garbage = tmp_path / "garbage.ch"
    garbage.write_bytes(b"not a checkpoint")
    empty = tmp_path / "empty.ch"
    empty.mkdir()
    paths = [port_single, port_sharded, jax_single, jax_sharded, garbage,
             empty, tmp_path / "missing.ch"]
    got = [tckpt.peek_global_step(p) for p in paths]
    assert got == [jckpt.peek_global_step(str(p)) for p in paths]
    assert got == [7, 9, 5, 6, None, None, None]
    # a swap interrupted between its renames: the previous checkpoint is
    # rolled back into place, and its step read
    os.rename(port_sharded, str(port_sharded) + ".old")
    assert tckpt.peek_global_step(port_sharded) == 9
    assert port_sharded.is_dir()


def test_checkpoint_fault_sites_leave_the_previous_checkpoint(tmp_path):
    model = _tiny_model()
    path = tmp_path / "ck.ch"
    tckpt.save_state_dict_sharded(path, model=model, global_step=1)
    # a fault before the manifest leaves step 1; one between the swap's
    # renames leaves a complete staged step 2, which the next reader rolls
    # forward (as the JAX reader does)
    for site, step in (("checkpoint.persist", 1), ("ckpt.pre_shard_write", 1),
                       ("ckpt.pre_manifest", 1), ("ckpt.mid_swap", 2)):
        try:
            tfaults.install_plan(f"{site}:raise")
            with pytest.raises(tfaults.FaultError):
                tckpt.save_state_dict_sharded(path, model=model,
                                              global_step=2)
        finally:
            tfaults.install_plan(None)
        assert tckpt.peek_global_step(path) == step, site
    single = tmp_path / "single.ch"
    tckpt.save_state_dict(single, model=model, global_step=3)
    try:
        tfaults.install_plan("ckpt.pre_write:raise")
        with pytest.raises(tfaults.FaultError):
            tckpt.save_state_dict(single, model=model, global_step=4)
    finally:
        tfaults.install_plan(None)
    assert tckpt.peek_global_step(single) == 3


# -- the CLI kill drill, beside the JAX package's ---------------------------------

def _drill_cfg(root: Path, tag: str, corpus: Path) -> Path:
    cfg = root / f"{tag}.cfg"
    cfg.write_text("\n".join([
        "model=bert-tiny", f"vocab_file={root / 'vocab.txt'}",
        f"data_path={corpus}", f"processed_data_path={root / tag / 'proc'}",
        f"dump_dir={root / tag / 'results'}", "experiment_name=sup",
        "max_seq_len=64", "max_question_len=16", "doc_stride=16",
        "hidden_dropout_prob=0.0", "attention_probs_dropout_prob=0.0",
        "compute_dtype=float32", "n_epochs=2", "train_batch_size=16",
        "test_batch_size=8", "batch_split=2", "n_jobs=2", "seed=0",
        "lr=1e-3", "goodput_ledger=True"]) + "\n")
    return cfg


def _initial_checkpoint(cfg: Path, path: Path) -> None:
    """The drills' shared start: the port's seeded bert-tiny and a fresh
    optimizer state, in the JAX layout both packages read."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)

    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        ["-c", str(cfg), "--device", "cpu"])
    trainer = train_cli.build_trainer(params, model_params)
    trainer.save_state_dict(path)
    trainer.close()


def _ledger_attempts(path: Path):
    keep = ("ev", "attempt", "resume_step", "returncode", "outcome", "step")
    return [{k: e[k] for k in keep if k in e}
            for e in map(json.loads, path.read_text().splitlines())
            if e["ev"] in ("attempt_start", "attempt_end", "run_start")]


def _params_of(path: Path):
    import jax

    state = tckpt.read_state(path)
    return (state["global_step"],
            jax.tree_util.tree_leaves_with_path(state["model"]))


@pytest.fixture(scope="module")
def kill_drill(tmp_path_factory):
    from ml_recipe_tpu.config.parser import get_model_parser as jmp
    from ml_recipe_tpu.config.parser import get_params as jget_params
    from ml_recipe_tpu.config.parser import get_trainer_parser as jtp

    root = tmp_path_factory.mktemp("kill_drill")
    make_tokenizer(root)
    corpus = write_corpus(root, [nq_line(example_id=str(i))
                                 for i in range(24)])
    init = root / "init.ch"
    _initial_checkpoint(_drill_cfg(root, "init", corpus), init)
    saved = dict(os.environ)
    # the drill's !once marker outlives attempt 1; one XLA device and one
    # CPU thread a child, as the other tests' children
    os.environ.pop("XLA_FLAGS", None)
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        os.environ[tfaults.FAULT_STATE_ENV] = str(root / "port_faults")
        port = subprocess.Popen(
            [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", "-c",
             str(_drill_cfg(root, "port", corpus)), "--device", "cpu",
             "--last", str(init), "--supervise", *DRILL_FLAGS],
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ))
        try:
            # the JAX package's supervisor, in this process, over its CLI
            os.environ[tfaults.FAULT_STATE_ENV] = str(root / "jax_faults")
            argv = ["-c", str(_drill_cfg(root, "jax", corpus)), "--last",
                    str(init), *DRILL_FLAGS]
            _, (jparams, _) = jget_params((jtp, jmp), argv)
            # the deadline: SIGTERM, which the supervisor forwards to its
            # child and then stands down (each child's watchdog bounds a
            # hang inside it)
            timer = threading.Timer(DRILL_DEADLINE_S, os.kill,
                                    (os.getpid(), signal.SIGTERM))
            timer.start()
            try:
                jax_rc = jsup.supervise_cli(jparams, argv)
            finally:
                timer.cancel()
            out, _ = port.communicate(timeout=DRILL_DEADLINE_S)
        finally:
            if port.poll() is None:
                port.kill()
                port.wait()
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return root, port.returncode, out, jax_rc


def test_supervised_kill_drill_recovers_as_the_jax_package(kill_drill):
    root, port_rc, out, jax_rc = kill_drill
    assert port_rc == jax_rc == 0, out[-4000:]
    assert "FAULT: kill at trainer.step (arrival 2) -> os._exit(89)" in out
    exp = {tag: root / tag / "results" / "sup" for tag in ("port", "jax")}
    attempts = {tag: _ledger_attempts(d / "goodput.jsonl")
                for tag, d in exp.items()}
    assert attempts["port"] == attempts["jax"]
    assert [(e.get("outcome"), e.get("returncode"), e.get("step"))
            for e in attempts["port"] if e["ev"] == "attempt_end"] == [
        ("crash", 89, 1), ("clean", 0, 3)]
    assert [e["step"] for e in attempts["port"]
            if e["ev"] == "run_start"] == [0, 1]
    sidecars = {tag: json.loads((d / "supervisor_state.json").read_text())
                for tag, d in exp.items()}
    for doc in sidecars.values():
        doc.pop("pid")
        doc.pop("updated_at")
    assert sidecars["port"] == sidecars["jax"]
    assert sidecars["port"]["outcomes"] == ["crash", "clean"]


def test_supervised_kill_drill_final_checkpoint_matches_jax(kill_drill):
    root = kill_drill[0]
    t_step, t_leaves = _params_of(root / "port" / "results" / "sup" / "last.ch")
    j_step, j_leaves = _params_of(root / "jax" / "results" / "sup" / "last.ch")
    _, init_leaves = _params_of(root / "init.ch")
    assert t_step == j_step == 3
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    moved = 0
    for (path, a), (_, b), (_, c) in zip(j_leaves, t_leaves, init_leaves):
        np.testing.assert_allclose(b, a, atol=PARAM_ATOL, err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(t_leaves) // 2


# -- the other sites ---------------------------------------------------------------

def test_barrier_prefetch_and_engine_sites_fire():
    import http.client

    from ml_recipe_tpu_torch.data.device_prefetch import DevicePrefetcher
    from ml_recipe_tpu_torch.data.loader import DataLoaderWorkerError
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.serve.engine import RequestRejected
    from ml_recipe_tpu_torch.serve.server import QAServer

    class Engine:
        grid, calls = [], 0

        def submit(self, question, document, request_id=None):
            Engine.calls += 1
            raise RequestRejected("no model here")

    def post(port):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.request("POST", "/v1/qa",
                         json.dumps({"question": "q", "document": "d"}))
            return conn.getresponse().status
        except (ConnectionError, http.client.HTTPException):
            return None    # the handler died on the injected fault
        finally:
            conn.close()

    try:
        tfaults.install_plan("dist.barrier:raise@2")
        pdist.barrier("first")     # alone the site still counts arrivals
        with pytest.raises(tfaults.FaultError, match="dist.barrier"):
            pdist.barrier("second")
        tfaults.install_plan("loader.prefetch:raise@2")
        it = iter(DevicePrefetcher(iter([1, 2, 3]), lambda b: b, depth=1))
        assert next(it) == 1
        with pytest.raises(DataLoaderWorkerError, match="loader.prefetch"):
            next(it)
        tfaults.install_plan("fleet.engine:raise@1")
        server = QAServer(Engine(), port=0)
        server.start()
        try:
            # the first admitted request dies before the engine sees it
            assert [post(server.port), post(server.port)] == [None, 400]
        finally:
            server._httpd.shutdown()
            server._httpd.server_close()
        assert Engine.calls == 1
    finally:
        tfaults.install_plan(None)
