"""The port's observability plane against the JAX package's, on the CPU.

Same inputs through ``ml_recipe_tpu`` and ``ml_recipe_tpu_torch``:

- ``SlowStepDetector`` reports over a scripted step sequence;
- ``summarize_events`` over a scripted ledger, and ``GoodputLedger``'s
  records (stamps masked);
- flight-record dumps (stamps and pid masked), ``newest_flight_record``
  and ``timeline_lines``;
- ``TrainTelemetry``'s ``/metrics`` page over a scripted observation
  sequence (the HELP texts, which name the port's kernel builds where JAX
  names its AOT store, and the wall-clock gauges masked), scraped from a
  ``MetricsExporter`` on port 0 beside ``/healthz``, an added route and
  the reserved paths (and the CLI's exporter serving ``/metrics/pod``
  with ``--metrics_hosts``);
- the trainers' trace spans on the same tiny config (2 steps, an eval, an
  async save and a restore): the same names, as many of each (but one
  ``data_wait`` more: the JAX trainer takes the run's first batch for its
  HBM pre-flight outside its timed iterator), the same step arguments.

And the port alone:

- ``StepTimer`` over a scripted clock (against the JAX one) and
  ``device_trace``; the ``trainer.step`` and ``trainer.eval_step`` sites;
- training with every instrument on (telemetry with the goodput ledger and
  the flight recorder, the span tracer, the watchdog, the profiler window)
  leaves the parameters bit-identical to the run with them off (the JAX
  package's ``test_observability_off_is_bit_identical``);
- ``cli.train`` with ``--trace --trace_spans --metrics_port 0
  --goodput_ledger --flight_recorder --watchdog_timeout`` on the CPU writes
  the profiler window's Chrome trace, the span file, the ledger and the
  recorder's dump;
- the stall drill: ``--supervise --fault_plan
  'trainer.step:stall@2~60!once' --watchdog_timeout 3`` on bert-tiny over
  a ``tests/helpers`` corpus: the watchdog ends attempt 1 with 87, the
  supervisor classifies it a hang and resumes, and the attempts and
  resumed steps equal what the JAX package's ``Supervisor`` decides on the
  same child exits and checkpoint steps.
"""

import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ml_recipe_tpu.metrics import anomaly as janomaly
from ml_recipe_tpu.metrics import exporter as jexporter
from ml_recipe_tpu.metrics import flightrec as jflightrec
from ml_recipe_tpu.metrics import goodput as jgoodput
from ml_recipe_tpu.metrics import trace as jtrace
from ml_recipe_tpu.resilience import supervisor as jsup
from ml_recipe_tpu.train import telemetry as jtelemetry
from ml_recipe_tpu_torch.metrics import anomaly as tanomaly
from ml_recipe_tpu_torch.metrics import exporter as texporter
from ml_recipe_tpu_torch.metrics import flightrec as tflightrec
from ml_recipe_tpu_torch.metrics import goodput as tgoodput
from ml_recipe_tpu_torch.metrics import trace as ttrace
from ml_recipe_tpu_torch.resilience import supervisor as tsup
from ml_recipe_tpu_torch.resilience import watchdog as twd
from ml_recipe_tpu_torch.train import telemetry as ttelemetry

from helpers import make_tokenizer, nq_line, write_corpus, write_vocab

REPO = Path(__file__).resolve().parents[1]
MAX_SEQ_LEN, MAX_Q_LEN = 32, 8
DRILL_DEADLINE_S = 180


# -- anomaly detector -----------------------------------------------------------

def _step_script():
    rng = np.random.default_rng(3)
    out = []
    for step in range(40):
        wait, host, device = 0.002, 0.004, 0.05 + 0.002 * rng.random()
        if step in (20, 33):
            wait = 0.4           # a stalled loader
        if step == 27:
            device = 0.6         # a slow device step
        out.append((step, wait, host, device))
    return out


def _detect(mod):
    det = mod.SlowStepDetector(factor=3.0, window=16, min_steps=8)
    reports = []
    for step, wait, host, device in _step_script():
        r = det.update(step, wait + host + device,
                       {"data_wait": wait, "host": host, "device": device})
        if r is not None:
            reports.append((vars(r), r.message()))
    return reports, det.anomalies


def test_slow_step_reports_match():
    t = _detect(tanomaly)
    assert t == _detect(janomaly)
    assert [r["attribution"] for r, _ in t[0]] == [
        "data_wait", "device", "data_wait"]


# -- goodput --------------------------------------------------------------------

LEDGER_EVENTS = [
    {"ev": "attempt_start", "t": 100.0, "attempt": 0},
    {"ev": "run_start", "t": 101.0, "step": 0},
    {"ev": "steps", "t": 110.0, "first_step": 0, "last_step": 3, "steps": 4,
     "productive_s": 6.0, "data_wait_s": 0.5, "compile_s": 1.5},
    {"ev": "checkpoint", "t": 111.0, "kind": "save", "seconds": 0.75},
    {"ev": "checkpoint", "t": 111.5, "kind": "save", "seconds": 0.25,
     "overlapped": True},
    {"ev": "eval", "t": 112.0, "seconds": 0.4},
    {"ev": "aot", "t": 112.1, "hits": 3, "misses": 1},
    {"ev": "attempt_end", "t": 113.0, "attempt": 0, "returncode": 89},
    {"ev": "attempt_start", "t": 115.0, "attempt": 1},
    {"ev": "run_start", "t": 116.0, "step": 2},
    {"ev": "checkpoint", "t": 116.5, "kind": "restore", "seconds": 0.3},
    {"ev": "steps", "t": 120.0, "first_step": 2, "last_step": 5, "steps": 4,
     "productive_s": 3.0, "data_wait_s": 0.1, "compile_s": 0.2},
    {"ev": "run_end", "t": 121.0, "step": 6},
    {"ev": "torn"},
]


@pytest.mark.parametrize("now", [None, 130.0])
def test_summarize_events_matches(now):
    t = tgoodput.summarize_events(LEDGER_EVENTS, now=now)
    assert t == jgoodput.summarize_events(LEDGER_EVENTS, now=now)
    assert t["recomputed_steps"] == 2 and t["attempts"] == 2
    parts = t["productive_s"] + sum(t["badput_s"].values())
    assert parts == pytest.approx(t["total_wall_s"], rel=1e-12)


def _ledger_records(mod, path):
    ledger = mod.GoodputLedger(path, flush_every=2)
    ledger.note_run_start(0)
    for step in range(5):
        ledger.note_step(step, wall_s=0.5, data_wait_s=0.125,
                         compile=step == 0, aot_hit=True if step == 0 else None)
    ledger.note_checkpoint("save", 0.25)
    ledger.note_checkpoint("save", 1.5, overlapped=True)
    ledger.note_eval(0.75)
    ledger.note_aot(2, 0, 0.125)
    ledger.note_run_end(5)
    strip = lambda e: {k: v for k, v in e.items() if k not in ("t", "pid")}
    written = [strip(e) for e in mod.read_ledger(path)]
    return written, [strip(e) for e in ledger.events()]


def test_goodput_ledger_records_match(tmp_path):
    t = _ledger_records(tgoodput, tmp_path / "t.jsonl")
    assert t == _ledger_records(jgoodput, tmp_path / "j.jsonl")
    assert t[0] == t[1] and [e["ev"] for e in t[0]].count("steps") == 3
    # a resumed attempt's ledger reads the earlier attempt's events
    again = tgoodput.GoodputLedger(tmp_path / "t.jsonl")
    assert len(again.events()) == len(t[0])


# -- flight recorder --------------------------------------------------------------

def _flight(mod, directory):
    rec = mod.FlightRecorder(os.path.join(directory, "flightrec_p0_a.json"),
                             capacity=8, flush_every=4)
    for step in range(11):
        rec.record("step", step=step, total_s=0.25, heartbeat_age_s=None)
    rec.record("checkpoint_save", seconds=1.5)
    path = rec.dump("watchdog", label="train step 11")
    doc = json.loads(Path(path).read_text())
    found_path, found = mod.newest_flight_record(directory)
    lines = [re.sub(r"\[\d\d:\d\d:\d\d\]", "[T]", line)
             for line in mod.timeline_lines(found, last=3)]
    for key in ("dumped_at", "pid"):
        doc.pop(key)
    for event in doc["events"]:
        event.pop("t")
    return doc, os.path.basename(found_path), lines, len(rec)


def test_flight_record_dumps_match(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    (tmp_path / "t" / "flightrec_p0_garbage.json").write_text("{torn")
    t = _flight(tflightrec, str(tmp_path / "t"))
    assert t == _flight(jflightrec, str(tmp_path / "j"))
    assert t[0]["reason"] == "watchdog" and len(t[0]["events"]) == 8
    opened = tflightrec.FlightRecorder.open_in(tmp_path, process_index=1)
    assert os.path.basename(opened.path).startswith("flightrec_p1_")


# -- telemetry and the exporter -----------------------------------------------------

class _Plan:
    def __init__(self, lo, hi, nbytes):
        self.lo, self.hi, self.nbytes = lo, hi, nbytes


def _telemetry(tel_mod, gp_mod, fr_mod, tmp_path, tag):
    state = tmp_path / f"{tag}_supervisor_state.json"
    state.write_text(json.dumps({
        "schema": 1, "attempts": 3, "restarts_used": 1,
        "outcomes": ["crash", "hang", "preempted"]}))
    tele = tel_mod.TrainTelemetry(
        process_index=0, process_count=1, anomaly_window=16,
        supervisor_state_path=state,
        goodput=gp_mod.GoodputLedger(None),
        flightrec=fr_mod.FlightRecorder(tmp_path / f"{tag}_fr.json"))
    tele.observe_aot("hit", 0.25)
    tele.observe_aot("miss", 2.0)
    for step, wait, host, device in _step_script()[:24]:
        tele.observe_step(step, data_wait_s=wait, host_s=host,
                          device_s=device, examples=16, real_tokens=400,
                          total_tokens=512, host_overlapped=step % 2 == 1)
        tele.observe_scalars({"loss": 2.0 - step / 100, "lr": 1e-3 * step,
                              "loss_scale": 2.0 ** (15 - step // 8)})
    tele.observe_checkpoint_save(1.25)
    tele.observe_checkpoint_snapshot(0.125)
    tele.observe_checkpoint_persist(3.0, stalled_s=0.5)
    tele.observe_checkpoint_restore(0.75)
    tele.observe_eval(2.5)
    tele.observe_zero1_buckets([_Plan(0, 3, 4096), _Plan(3, 5, 1024)])
    return tele


_WALL = ("train_goodput_ratio", "train_badput_seconds_total")


def _masked(page: str):
    """The page without HELP lines, the wall-clock gauges' values masked."""
    out = []
    for line in page.splitlines():
        if line.startswith("# HELP"):
            continue
        if line.startswith(_WALL):
            line = line.rsplit(" ", 1)[0] + " <wall>"
        out.append(line)
    return out


def _help_names(page: str):
    return [line.split()[2] for line in page.splitlines()
            if line.startswith("# HELP")]


def test_telemetry_page_matches(tmp_path):
    t = _telemetry(ttelemetry, tgoodput, tflightrec, tmp_path, "t")
    j = _telemetry(jtelemetry, jgoodput, jflightrec, tmp_path, "j")
    t.refresh()
    j.refresh()
    tp, jp = t.registry.render(), j.registry.render()
    assert _masked(tp) == _masked(jp)
    assert _help_names(tp) == _help_names(jp)
    assert t.breakdown_summary() == j.breakdown_summary()
    assert "train_supervisor_exits_hang 1" in tp
    health = t.health_document(global_step=24)
    jhealth = j.health_document(global_step=24)
    for doc in (health, jhealth):
        assert doc.pop("goodput_ratio") is not None
        assert doc.pop("last_event_age_s") >= 0.0
    assert health == jhealth


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _scrape(tel_mod, gp_mod, fr_mod, exp_mod, tmp_path, tag):
    tele = _telemetry(tel_mod, gp_mod, fr_mod, tmp_path, tag)
    exporter = exp_mod.MetricsExporter(
        tele.registry, port=0, host="127.0.0.1",
        health_fn=lambda: {"status": "ok", "global_step": 24}).start()
    exporter.add_pre_render(tele.refresh)
    exporter.add_route("/metrics/pod", lambda: "pod 1\n")
    exporter.add_route("/broken", lambda: 1 / 0)
    with pytest.raises(ValueError, match="reserved"):
        exporter.add_route("/healthz", lambda: "")
    try:
        base = f"http://127.0.0.1:{exporter.port}"
        got = {path: _get(base + path) for path in
               ("/metrics", "/healthz", "/metrics/pod", "/broken", "/nope")}
    finally:
        exporter.close()
    got["/metrics"] = (got["/metrics"][0], _masked(got["/metrics"][1]))
    return got


def test_exporter_scrape_on_port_0_matches(tmp_path):
    t = _scrape(ttelemetry, tgoodput, tflightrec, texporter, tmp_path, "t")
    j = _scrape(jtelemetry, jgoodput, jflightrec, jexporter, tmp_path, "j")
    assert t == j
    assert t["/healthz"] == (200, '{"status": "ok", "global_step": 24}')
    assert [t[p][0] for p in ("/metrics/pod", "/broken", "/nope")] == [
        200, 500, 404]


def _timed(mod, monkeypatch, result):
    """A StepTimer over a scripted clock: 4 steps of 1, 2, 3, 4 s."""
    ticks = iter([0.0, 1.0, 1.0, 3.0, 3.0, 6.0, 6.0, 10.0])
    monkeypatch.setattr(mod, "time",
                        SimpleNamespace(perf_counter=lambda: next(ticks)))
    timer = mod.StepTimer(warmup=1)
    dts = []
    for _ in range(4):
        timer.start()
        dts.append(timer.stop(result))
    return dts, timer.count, timer.mean()


def test_step_timer_and_device_trace(tmp_path, monkeypatch):
    from ml_recipe_tpu.utils import profiler as jprofiler
    from ml_recipe_tpu_torch.utils import profiler as tprofiler

    t = _timed(tprofiler, monkeypatch, {"loss": torch.ones(2)})
    assert t == _timed(jprofiler, monkeypatch, None) == (
        [1.0, 2.0, 3.0, 4.0], 4, 3.0)
    with tprofiler.device_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with tprofiler.device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    names = {e.get("name", "") for e in json.loads(
        (tmp_path / "trace" / "profile_p0_steps0-0.json").read_text()
    )["traceEvents"]}
    assert "aten::sum" in names


def _cuda_window(tmp_path, monkeypatch, **kw):
    """A ProfilerWindow that takes itself for a CUDA capture: its captures
    hold CPU activity only, so each one comes back without CUDA activity."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    window = ttrace.ProfilerWindow(tmp_path / "trace", **kw)
    window.device = torch.device("cuda")
    return window


def test_profiler_window_moves_on_after_an_empty_capture(tmp_path,
                                                         monkeypatch):
    """On CUDA a capture without CUDA activity is not written: the window
    captures the next steps instead, and raises once every capture came
    back empty, at the last capture or when the run ends first."""
    window = _cuda_window(tmp_path, monkeypatch, start=1, steps=2,
                          captures=2)
    window.on_step_start()                      # step 0: before the start
    assert not window.on_step_end() and window._prof is None
    for _ in range(2):                          # steps 1-2: empty
        window.on_step_start()
        torch.ones(8).sum()
        assert not window.on_step_end()
    assert (window.empty_captures, window.done) == (1, False)
    window.on_step_start()                      # steps 3-4: empty again
    assert not window.on_step_end()
    window.on_step_start()
    with pytest.raises(RuntimeError, match="2 torch.profiler captures"):
        window.on_step_end()
    assert not (tmp_path / "trace").exists()

    short = _cuda_window(tmp_path, monkeypatch, start=0, steps=1)
    short.on_step_start()
    assert not short.on_step_end()
    short.on_step_start()                       # the epoch ends mid-capture
    with pytest.raises(RuntimeError, match="the run ended"):
        short.finish()
    assert short.empty_captures == 2 and not short.done


def test_cli_exporter_serves_the_pod_page(tmp_path):
    """``--metrics_port`` with ``--metrics_hosts``: rank 0's exporter adds
    ``/metrics/pod``, the aggregator's merge of the listed exporters (here
    its own)."""
    from ml_recipe_tpu_torch.cli import train as train_cli

    tele = _telemetry(ttelemetry, tgoodput, tflightrec, tmp_path, "t")
    params = SimpleNamespace(metrics_port=0, metrics_hosts=None)
    trainer = SimpleNamespace(global_step=24)
    exporter = train_cli._start_exporter(params, tele, trainer, 0)
    try:
        params.metrics_hosts = f"127.0.0.1:{exporter.port}"
        pod = train_cli._start_exporter(params, tele, trainer, 0)
        try:
            status, page = _get(f"http://127.0.0.1:{pod.port}/metrics/pod")
            health = json.loads(_get(
                f"http://127.0.0.1:{pod.port}/healthz")[1])
        finally:
            pod.close()
    finally:
        exporter.close()
    assert status == 200 and "train_steps_total" in page
    assert health["global_step"] == 24 and health["status"] == "ok"


# -- trainers: span names, instruments on vs off ------------------------------------

def _port_trainer(tmp_path, *, dropout=0.1, **extra):
    from ml_recipe_tpu_torch.data.collate import make_collate_fun
    from ml_recipe_tpu_torch.data.datasets import DummyDataset
    from ml_recipe_tpu_torch.losses import build_loss
    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.tokenizer import Tokenizer
    from ml_recipe_tpu_torch.train.trainer import Trainer

    tmp_path.mkdir(parents=True, exist_ok=True)
    tok = Tokenizer("bert", str(write_vocab(tmp_path)), lowercase=True)
    rng = np.random.default_rng(0)
    kw = dict(tokenizer=tok, max_seq_len=MAX_SEQ_LEN,
              max_question_len=MAX_Q_LEN, rng=rng)
    train_ds, test_ds = DummyDataset(dataset_len=32, **kw), DummyDataset(
        dataset_len=10, **kw)
    cfg = EncoderConfig(
        vocab_size=len(tok), hidden_size=16, num_layers=2, num_heads=2,
        intermediate_size=32, max_position_embeddings=MAX_SEQ_LEN + 2,
        num_labels=5, hidden_dropout_prob=dropout,
        attention_probs_dropout_prob=dropout)
    torch.manual_seed(0)
    model = QAModel(cfg, dtype=torch.float32, device="cpu")
    tp = SimpleNamespace(loss="smooth", smooth_alpha=0.01, focal_alpha=1.0,
                         focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                         w_end_reg=0.5, w_cls=1, lr=1e-3, weight_decay=0.01,
                         warmup_coef=0.3, optimizer="adam", finetune=False)
    return Trainer(model, build_loss(tp),
                   make_collate_fun(tok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=tp, train_dataset=train_ds,
                   test_dataset=test_ds, n_epochs=1, train_batch_size=16,
                   test_batch_size=8, batch_split=2, n_jobs=2,
                   warmup_coef=0.3, max_grad_norm=1.0, seed=0, **extra)


def _spans(path):
    events = json.loads(Path(path).read_text())["traceEvents"]
    for e in events:
        assert e["ph"] in ("X", "i") and e["ts"] >= 0
        assert e["ph"] == "i" or e["dur"] >= 0
    return events


def _span_run(trainer, tracer, tmp_path):
    trainer.train()
    trainer.test(1)
    trainer.save_state_dict(tmp_path / "obs.ch")
    trainer.finish_pending_checkpoint()
    trainer.load_state_dict(tmp_path / "obs.ch")
    events = _spans(tracer.close())
    steps = sorted(e["args"]["step"] for e in events if e["name"] == "step")
    rows = {e["args"]["rows"] for e in events if e["name"] == "step"}
    return Counter(e["name"] for e in events), steps, rows


def test_trainer_span_names_match_the_jax_trainer(tmp_path):
    from test_trainer import _make_trainer

    (tmp_path / "j").mkdir()
    tracer = jtrace.install(jtrace.TraceWriter(str(tmp_path / "j.json")))
    try:
        jt, _ = _make_trainer(tmp_path / "j", dropout=0.0, mesh_spec="data:1",
                              max_seq_len=MAX_SEQ_LEN, async_checkpoint=True,
                              device_prefetch=0)
        j = _span_run(jt, tracer, tmp_path / "j")
    finally:
        jtrace.install(None)
    tracer = ttrace.install(ttrace.TraceWriter(str(tmp_path / "t.json")))
    try:
        tt = _port_trainer(tmp_path, dropout=0.0, async_checkpoint=True)
        t = _span_run(tt, tracer, tmp_path)
    finally:
        ttrace.install(None)
    # the JAX trainer takes the run's first batch outside its timed
    # iterator (its HBM pre-flight step), so that fetch has no data_wait
    # span; the port times every fetch
    assert t[0] - Counter({"data_wait": 1}) == j[0]
    assert t[1:] == j[1:]
    assert t[0] == Counter({"data_wait": 2, "place": 2, "step": 2,
                            "_train": 1, "_test": 1, "checkpoint_save": 1,
                            "ckpt_snapshot": 1, "checkpoint_restore": 1})
    assert t[1] == [0, 1] and t[2] == {16}


def test_trainer_step_and_eval_sites_fire_on_their_arrivals(tmp_path):
    from ml_recipe_tpu_torch.resilience import faults

    trainer = _port_trainer(tmp_path, dropout=0.0)
    try:
        faults.install_plan("trainer.step:raise@2;trainer.eval_step:raise@2")
        with pytest.raises(faults.FaultError, match="trainer.step"):
            trainer.train()
        assert trainer.global_step == 1     # the first step ran
        with pytest.raises(faults.FaultError, match="trainer.eval_step"):
            trainer.test(1)
        assert trainer.eval_batches == 1
    finally:
        faults.install_plan(None)


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_instruments_on_leave_the_parameters_bit_identical(tmp_path):
    off = _port_trainer(tmp_path / "off", device_prefetch=2)
    off.train()
    base = _params(off)

    on_dir = tmp_path / "on"
    tracer = ttrace.install(ttrace.TraceWriter(str(on_dir / "trace.json")))
    wd = twd.Watchdog(120.0)
    try:
        tele = ttelemetry.TrainTelemetry(
            goodput=tgoodput.GoodputLedger(str(on_dir / "goodput.jsonl"),
                                           flush_every=1),
            flightrec=tflightrec.FlightRecorder(
                str(on_dir / "flightrec_p0.json"), flush_every=1),
            watchdog=wd)
        on = _port_trainer(on_dir, device_prefetch=2, telemetry=tele,
                           watchdog=wd, trace_dir=on_dir / "profile")
        on.train()
    finally:
        ttrace.install(None)
        wd.stop()
    names = Counter(e["name"] for e in _spans(tracer.close()))
    assert names["step"] == 2 and names["prefetch_stage"] == 2
    assert names["profiler_capture_start"] == names["profiler_capture_stop"] == 1
    assert tele.m_steps.value == 2 and tele.m_device.sum > 0
    assert tele.m_step.sum <= (tele.m_data_wait.sum + tele.m_host.sum
                               + tele.m_device.sum)   # host overlapped
    assert tgoodput.read_ledger(on_dir / "goodput.jsonl")
    assert tflightrec.newest_flight_record(on_dir) is not None
    window = on.profiler_window
    assert window.done and (window.start, os.path.exists(window.path)) == (
        0, True)   # an epoch of 2 steps traces from step 0
    instrumented = _params(on)
    assert list(base) == list(instrumented)
    for k in base:
        assert torch.equal(base[k], instrumented[k]), k


def test_cli_writes_the_profiler_trace_spans_ledger_and_record(tmp_path):
    from ml_recipe_tpu_torch.cli import train as train_cli

    vocab = write_vocab(tmp_path)
    dump = tmp_path / "results"
    train_cli.main([
        "--model", "bert-tiny", "--device", "cpu", "--debug",
        "--dummy_dataset", "--vocab_file", str(vocab), "--dump_dir",
        str(dump), "--max_seq_len", "32", "--max_question_len", "8",
        "--train_batch_size", "8", "--test_batch_size", "4", "--batch_split",
        "2", "--n_jobs", "2", "--seed", "0", "--trace", "--trace_spans",
        str(tmp_path / "spans"), "--metrics_port", "0", "--goodput_ledger",
        "--flight_recorder", "--watchdog_timeout", "120"])
    assert twd.current() is None and ttrace.current() is None
    traces = list((dump / "board" / "test" / "trace").glob("profile_p0_*.json"))
    assert [p.name for p in traces] == ["profile_p0_steps0-0.json"]
    profile = json.loads(traces[0].read_text())
    names = {e.get("name", "") for e in profile["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)   # the step's CPU ops
    spans = Counter(e["name"] for e in _spans(
        tmp_path / "spans" / "train_trace_p0.json"))
    assert spans["step"] == 2 and spans["_test"] == 2
    assert spans["profiler_capture_start"] == spans["profiler_capture_stop"] == 1
    exp = dump / "test"
    events = [e["ev"] for e in tgoodput.read_ledger(exp / "goodput.jsonl")]
    assert events[0] == "run_start" and events[-1] == "run_end"
    assert events.count("aot") == 1
    found = tflightrec.newest_flight_record(exp)
    assert found[1]["reason"] == "clean"
    assert [e["kind"] for e in found[1]["events"]].count("step") == 2


# -- the stall drill --------------------------------------------------------------

def test_supervised_stall_drill_recovers_from_a_watchdog_abort(tmp_path):
    make_tokenizer(tmp_path)
    corpus = write_corpus(tmp_path, [nq_line(example_id=str(i))
                                     for i in range(24)])
    cfg = tmp_path / "stall.cfg"
    cfg.write_text("\n".join([
        "model=bert-tiny", f"vocab_file={tmp_path / 'vocab.txt'}",
        f"data_path={corpus}", f"processed_data_path={tmp_path / 'proc'}",
        f"dump_dir={tmp_path / 'results'}", "experiment_name=stall",
        "max_seq_len=64", "max_question_len=16", "doc_stride=16",
        "n_epochs=2", "train_batch_size=16", "test_batch_size=8",
        "batch_split=2", "n_jobs=2", "seed=0"]) + "\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               MLRT_FAULT_STATE=str(tmp_path / "faults"))
    res = subprocess.run(
        [sys.executable, "-m", "ml_recipe_tpu_torch.cli.train", "-c",
         str(cfg), "--device", "cpu", "--supervise", "--max_restarts", "2",
         "--backoff_base", "0.01", "--backoff_max", "0.02",
         # stall >> timeout >> a legitimate bert-tiny step on a loaded CPU
         "--fault_plan", "trainer.step:stall@2~60!once",
         "--watchdog_timeout", "3", "--goodput_ledger", "--flight_recorder"],
        cwd=str(REPO), capture_output=True, text=True, env=env,
        timeout=DRILL_DEADLINE_S)
    assert res.returncode == 0, res.stderr[-4000:]
    err = res.stderr
    # the stall fires before epoch 2's first tick: its frame's own label
    assert "WATCHDOG: 'train epoch 2' exceeded 3s" in err
    assert "last completed step: 1" in err
    exp = tmp_path / "results" / "stall"
    ledger = tgoodput.read_ledger(exp / "goodput.jsonl")
    ends = [(e["returncode"], e["step"]) for e in ledger
            if e["ev"] == "attempt_end"]
    assert ends == [(87, 1), (0, 3)]
    # the JAX package's supervisor on the same exits and checkpoint steps
    steps = [None]
    for e in ledger:
        if e["ev"] == "attempt_start":
            steps.append(e["resume_step"])
        elif e["ev"] == "attempt_end":
            steps.append(e["step"])
    steps = steps[1:]
    def decide(mod):
        rcs, progress = iter([rc for rc, _ in ends]), iter(steps)
        return mod.Supervisor(
            lambda i: next(rcs), progress=lambda: next(progress),
            policy=mod.RetryPolicy(max_restarts=2, backoff_base=0.01,
                                   backoff_max=0.02),
            sleep=lambda s: None).run()

    jres = decide(jsup)
    sidecar = json.loads((exp / "supervisor_state.json").read_text())
    assert sidecar["outcomes"] == jres.outcomes() == ["hang", "clean"]
    assert [(a.step_before, a.step_after) for a in jres.attempts] == [
        (None, 1), (1, 3)]
    assert decide(tsup).outcomes() == jres.outcomes()
    # the hang's timeline survived the abort: the recorder dumped on it
    dumps = [json.loads(p.read_text()) for p in exp.glob("flightrec_*.json")]
    assert sorted(d["reason"] for d in dumps) == ["clean", "watchdog"]
