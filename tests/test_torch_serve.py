"""The port's serving path against the JAX package's, on the same weights.

A tiny JAX QAModel (tests/test_serve.py's geometry) is initialised from a
seed; its params cross the bridge into the port's QAModel (f32, CPU). Both
engines answer the same fixed requests, one of them a multi-chunk document,
and must agree on the answer, label, span and chunk count, with the score
within an f32 tolerance. The same holds for the int8 engines of both
packages, each converted by its own ``quant.quantize_model``. Then the
port's HTTP front end, its config parsing and the serve CLI as a
subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.serve.bucketing import BucketGrid as JaxBucketGrid
from ml_recipe_tpu_torch.config.parser import (
    check_serve_flags,
    get_model_parser,
    get_params,
    get_serve_parser,
)
from ml_recipe_tpu_torch.data.labels import labels2id
from ml_recipe_tpu_torch.infer.score import OUT_KEYS
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, from_jax_params
from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
from ml_recipe_tpu_torch.tokenizer import Tokenizer

from helpers import write_vocab

_REPO = Path(__file__).resolve().parents[1]

# f32 forward on both sides: the packed scores agree to summation-order
# rounding (~1e-6 on O(1) logit sums)
SCORE_ATOL = 1e-4

_QUESTION = "what is the capital of england ?"
_DOCUMENT = (
    "<P> London is the capital of England . </P> "
    "<P> Big Ben was built in the city . The river Thames runs through "
    "London . </P>"
)
_LONG_DOCUMENT = " ".join([_DOCUMENT] * 6)  # several 64-token windows
_REQUESTS = [
    (_QUESTION, _DOCUMENT),
    ("is big ben a tower ?", _DOCUMENT),
    ("what runs through london ?", _LONG_DOCUMENT),
    ("was the city built in a year ?", "the quick brown fox jumps over "
                                       "the lazy dog . " * 12),
]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    vocab = str(write_vocab(tmp_path_factory.mktemp("torch_serve")))
    jtok = JaxTokenizer("bert", vocab, lowercase=True)
    tok = Tokenizer("bert", vocab, lowercase=True)
    kw = dict(vocab_size=len(tok), hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_position_embeddings=66, num_labels=5)
    jmodel = JaxQAModel(JaxEncoderConfig(**kw))
    params = jmodel.init(jax.random.key(0),
                         np.zeros((1, 8), np.int32))["params"]
    model = QAModel(EncoderConfig(**kw), device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree_util.tree_map(np.asarray, params)))

    common = dict(max_batch_delay_ms=5, queue_size=64, max_question_len=16,
                  doc_stride=24)
    jengine = JaxQAEngine(jmodel, params, jtok,
                          grid=JaxBucketGrid.from_spec("4x64,8x64"),
                          mesh=build_mesh(), **common)
    jengine.warmup(hbm_preflight=False)
    engine = QAEngine(model, tok, grid=BucketGrid.from_spec("4x64,8x64"),
                      **common)
    report = engine.warmup()
    yield SimpleNamespace(jax=jengine, port=engine, tok=tok, report=report,
                          jtok=jtok, jmodel=jmodel, params=params, common=common)
    jengine.close()
    engine.close()


@pytest.fixture(scope="module")
def int8_engines(engines):
    """Both packages' int8 engines over the fixture's weights."""
    from ml_recipe_tpu.quant import quantize_model as jax_quantize_model
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu_torch.quant import quantize_model
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    jq, jqparams, _ = jax_quantize_model(engines.jmodel, engines.params)
    jengine = JaxQAEngine(jq, jqparams, engines.jtok,
                          grid=JaxBucketGrid.from_spec("4x64,8x64"),
                          mesh=build_mesh(), quantize="int8", **engines.common)
    jengine.warmup(hbm_preflight=False)
    qmodel, _ = quantize_model(engines.port.model)
    engine = QAEngine(qmodel, engines.tok,
                      grid=BucketGrid.from_spec("4x64,8x64"), **engines.common)
    report = engine.warmup()
    yield SimpleNamespace(jax=jengine, port=engine, report=report)
    jengine.close()
    engine.close()


def test_warmup_runs_every_bucket(engines):
    assert engines.report["buckets"] == ["4x64", "8x64"]
    assert engines.report["device"] == "cpu"
    assert engines.report["wire"] == "ids"


def test_answers_match_jax_engine(engines):
    n_multi = 0
    for question, document in _REQUESTS:
        ref = engines.jax.submit(question, document).result(timeout=60)
        got = engines.port.submit(question, document).result(timeout=60)
        assert (got.answer, got.label, got.start, got.end, got.n_chunks) == (
            ref.answer, ref.label, ref.start, ref.end, ref.n_chunks)
        assert abs(got.score - ref.score) <= SCORE_ATOL
        n_multi += ref.n_chunks > 1
    assert n_multi >= 1


def test_long_scatter_path_matches_jax_engine(engines):
    """``--long_scatter_chunks 3``: a request of at least three windows
    launches its chunks as dedicated batches (``BucketGrid.scatter_plan``)
    in both packages, with the same answers and the same batch count (two
    passes over the requests: two of them scatter, one batch each)."""
    from ml_recipe_tpu.serve.engine import QAEngine as JaxQAEngine
    from ml_recipe_tpu_torch.serve.engine import QAEngine

    jengine = JaxQAEngine(engines.jmodel, engines.params, engines.jtok,
                          grid=JaxBucketGrid.from_spec("4x64,8x64"),
                          mesh=build_mesh(), long_scatter_chunks=3,
                          **engines.common)
    jengine.warmup(hbm_preflight=False)
    engine = QAEngine(engines.port.model, engines.tok,
                      grid=BucketGrid.from_spec("4x64,8x64"),
                      long_scatter_chunks=3, **engines.common)
    engine.warmup()
    try:
        for question, document in _REQUESTS * 2:
            ref = jengine.submit(question, document).result(timeout=60)
            got = engine.submit(question, document).result(timeout=60)
            assert (got.answer, got.label, got.start, got.end,
                    got.n_chunks) == (ref.answer, ref.label, ref.start,
                                      ref.end, ref.n_chunks)
            assert abs(got.score - ref.score) <= 1e-6
        assert engine.m_longdoc_batches.value == \
            jengine.m_longdoc_batches.value == 4
        assert engine.m_longdoc_requests.value == \
            jengine.m_longdoc_requests.value > 0
    finally:
        jengine.close()
        engine.close()


def test_int8_answers_match_jax_int8_engine(int8_engines):
    for question, document in _REQUESTS:
        ref = int8_engines.jax.submit(question, document).result(timeout=60)
        got = int8_engines.port.submit(question, document).result(timeout=60)
        assert (got.answer, got.label, got.start, got.end, got.n_chunks) == (
            ref.answer, ref.label, ref.start, ref.end, ref.n_chunks)
        assert abs(got.score - ref.score) <= SCORE_ATOL


def _gauge(metrics: str, name: str) -> float:
    return float(next(line.split()[-1] for line in metrics.splitlines()
                      if line.startswith(name + " ")))


def test_int8_engine_reports_its_precision_and_smaller_weights(
        engines, int8_engines):
    port = int8_engines.port
    assert port.quantize == "int8" and engines.port.quantize == "off"
    report = int8_engines.report
    assert report["quantize"] == "int8"
    assert report["quant_mem_bytes"] < engines.report["quant_mem_bytes"]
    metrics = port.render_metrics()
    assert 'qa_active_precision{device="cpu",precision="int8"} 1' in metrics
    int8_bytes = _gauge(metrics, "qa_weight_bytes")
    assert int8_bytes == report["quant_mem_bytes"]
    assert int8_bytes < _gauge(engines.port.render_metrics(),
                               "qa_weight_bytes")


def test_packed_output_matches_jax(engines):
    tok = engines.tok
    rows = []
    for question, document in _REQUESTS:
        q = tok.encode(question)[:16]
        d = tok.encode(document)[:40]
        rows.append([tok.cls_token_id, *q, tok.sep_token_id, *d,
                     tok.sep_token_id])
    ids = np.full((4, 64), tok.pad_token_id, np.int32)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
    inputs = {"input_ids": ids}
    ref = np.asarray(engines.jax._jit(engines.jax.params,
                                      engines.jax._wire_pack(inputs)))
    out = engines.port.run_packed(inputs)
    assert out.shape == ref.shape == (len(OUT_KEYS), 4)
    for i, key in enumerate(OUT_KEYS):
        if key in ("start_ids", "end_ids", "labels"):
            assert np.array_equal(out[i], ref[i]), key
        else:
            np.testing.assert_allclose(out[i], ref[i], atol=SCORE_ATOL,
                                       err_msg=key)


def test_three_plane_wire_matches_ids_wire(engines):
    """A vocab of 2**16 or more switches to the [3, B, L] int32 wire; both
    wires must score a batch identically."""
    from ml_recipe_tpu_torch.infer.score import build_score_fn

    tok = engines.tok
    ids = np.full((2, 64), tok.pad_token_id, np.int32)
    ids[:, :20] = np.random.default_rng(0).integers(5, len(tok), (2, 20))
    ids[:, 0], ids[:, 8], ids[:, 19] = (tok.cls_token_id, tok.sep_token_id,
                                        tok.sep_token_id)
    host = engines.port._host_arrays(ids, np.array([20, 20], np.int32))
    three = torch.from_numpy(np.stack([host["input_ids"],
                                       host["attention_mask"],
                                       host["token_type_ids"]]))
    fn = build_score_fn(engines.port.model, wire_ids_only=False)
    with torch.inference_mode():
        out = fn(three).numpy()
    assert np.array_equal(out, engines.port.run_packed({"input_ids": ids}))


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        f"{url}/v1/qa", data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.read().decode("utf-8")


def test_http_round_trip(engines):
    from ml_recipe_tpu_torch.serve.server import QAServer

    server = QAServer(engines.port, port=0, request_timeout_s=60)
    server.start()
    try:
        url = f"http://{server.host}:{server.port}"
        status, body = _post(url, {"question": _QUESTION,
                                   "document": _LONG_DOCUMENT})
        assert status == 200 and body["label"] in labels2id
        assert body["n_chunks"] > 1
        assert _post(url, {"question": _QUESTION})[0] == 400
        status, health = _get(f"{url}/healthz")
        health = json.loads(health)
        assert status == 200 and health["status"] == "ok"
        assert health["buckets"] == ["4x64", "8x64"]
        status, metrics = _get(f"{url}/metrics")
        assert status == 200
        assert "qa_requests_completed_total" in metrics
        assert 'qa_active_precision{device="cpu",precision="f32"} 1' in metrics
    finally:
        # the engine fixture closes the engine; stop only the listener
        server._httpd.shutdown()
        server._httpd.server_close()


def test_serve_cfg_parses_with_the_port_flag():
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), "--vocab_file", "v.txt"])
    assert params.buckets == "8x128,8x384,32x384"
    assert model_params.model == "bert-base-uncased"
    assert model_params.compute_dtype == "bfloat16"
    assert model_params.device == "cuda"
    check_serve_flags(params, model_params)  # cfg values are all accepted


@pytest.mark.parametrize("flag", [
    ["--mesh", "data:1"], ["--flash_attention", "ring"],
    # --hf_checkpoint is ported (test_torch_hf_convert.py): a mesh of
    # more than one device takes its place
    ["--mesh", "data:2"],
])
def test_unported_flags_raise(flag):
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), *flag])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_serve_flags(params, model_params)


@pytest.mark.parametrize("flag", [
    ["--serve_cache_bytes", "1M"], ["--doc_cache_bytes", "64K"],
    ["--trace_spans", "spans"],
])
def test_cache_and_trace_flags_are_accepted(flag):
    """The serving caches and trace spans are ported
    (tests/test_torch_serve_cache.py)."""
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), *flag])
    check_serve_flags(params, model_params)


@pytest.mark.parametrize("flag", [
    ["--quantize", "int8"], ["--ln_impl", "fused"], ["--ln_impl", "auto"],
    ["--quantize", "int8", "--ln_impl", "fused"],
])
def test_int8_and_fused_layer_norm_flags_are_accepted(flag):
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), *flag])
    check_serve_flags(params, model_params)


@pytest.mark.parametrize("flag", [["--ln_impl", "bogus"],
                                  ["--quantize", "fp4"]])
def test_unknown_quantize_and_ln_impl_values_raise(flag):
    with pytest.raises(SystemExit):
        get_params((get_serve_parser, get_model_parser),
                   ["-c", str(_REPO / "config" / "serve.cfg"), *flag])


def test_ln_impl_interpret_has_no_port_counterpart():
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), "--ln_impl", "interpret"])
    with pytest.raises(ValueError, match="interpret"):
        check_serve_flags(params, model_params)


def _drive_serve_cli(tmp_path, *extra) -> str:
    """The serve CLI on the CPU: ready file, one answered request, SIGTERM
    drain to exit 0; returns its log."""
    vocab = write_vocab(tmp_path)
    ready = tmp_path / "ready.json"
    env = dict(os.environ, PYTHONPATH=str(_REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ml_recipe_tpu_torch.cli.serve",
         "-c", str(_REPO / "config" / "serve.cfg"), "--model", "bert-tiny",
         "--vocab_file", str(vocab), "--device", "cpu", "--port", "0",
         "--buckets", "2x64", "--max_question_len", "16",
         "--doc_stride", "24", "--ready_file", str(ready), *extra],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not ready.exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "server never became ready"
            time.sleep(0.2)
        info = json.loads(ready.read_text())
        url = f"http://{info['host']}:{info['port']}"
        status, body = _post(url, {"question": _QUESTION,
                                   "document": _DOCUMENT})
        assert status == 200 and body["label"] in labels2id
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "Warm-up plane (live)" in out
        return out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_serve_cli_on_cpu_answers_and_drains(tmp_path):
    _drive_serve_cli(tmp_path)


def test_serve_cli_int8_with_fused_layer_norm_on_cpu(tmp_path):
    out = _drive_serve_cli(tmp_path, "--quantize", "int8", "--ln_impl",
                           "fused")
    assert "Post-training quantization (int8): 17 kernels converted" in out
    assert "LayerNorm fused, int8" in out
