"""The PyTorch port stands alone: no JAX, no ``ml_recipe_tpu``, no CPU fallback.

- an AST walk of every module of ``ml_recipe_tpu_torch/`` and of
  ``chip_smoke.py`` finds no import of jax, flax, optax or the JAX package
  (``ml_recipe_tpu`` itself or ``ml_recipe_tpu.*`` — not the bare prefix,
  which the port's own name shares), and the port's launcher
  ``scripts/worker_torch.sh`` names no module of them;
- importing the serving, training, validation and train-metrics entry
  points in a fresh interpreter loads no jax;
- the entry points default to CUDA and raise without it.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_REPO = Path(__file__).resolve().parents[1]
# safetensors and transformers: the card has neither (the port reads HF
# checkpoints itself, models/hf_convert.py)
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_recipe_tpu",
              "safetensors", "transformers")


def _sources():
    files = sorted((_REPO / "ml_recipe_tpu_torch").rglob("*.py"))
    return files + [_REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == name or module.startswith(name + ".")
               for name in _FORBIDDEN)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_forbidden_matches_the_package_not_the_prefix():
    assert _forbidden("ml_recipe_tpu") and _forbidden("ml_recipe_tpu.serve")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("ml_recipe_tpu_torch.serve")
    assert not _forbidden("jaxtyping")


def test_no_port_module_imports_jax_or_the_jax_package():
    files = _sources()
    assert len(files) > 20 and files[-1].exists()
    # the walk covers the training and data-parallel slices' modules too
    names = {str(f.relative_to(_REPO)) for f in files}
    for module in ("cli/train.py", "train/trainer.py", "train/optim.py",
                   "train/checkpoint.py", "train/callback.py",
                   "train/writer.py", "losses/losses.py", "data/datasets.py",
                   "data/collate.py", "data/loader.py", "data/bucketing.py",
                   "data/device_prefetch.py", "metrics/meters.py",
                   "utils/msgpack.py", "utils/seed.py",
                   "ops/flash_attention.py", "ops/layer_norm.py",
                   "ops/quant_matmul.py", "quant/__init__.py",
                   "quant/quantize.py", "quant/layers.py",
                   "quant/calibrate.py", "cli/validate.py",
                   "cli/train_metrics.py", "infer/predictor.py",
                   "data/preprocessor.py", "data/sentence.py",
                   "data/synthetic.py", "utils/pipeline.py",
                   "data/packing.py", "parallel/__init__.py",
                   "parallel/dist.py", "parallel/collectives.py",
                   "parallel/pipeline.py",
                   "models/hf_convert.py", "train/loss_scale.py",
                   "resilience/__init__.py",
                   "resilience/checkpoint_async.py",
                   "resilience/supervisor.py", "resilience/coordination.py",
                   "serve/cache.py",
                   "metrics/artifacts.py", "metrics/trace.py",
                   "metrics/aggregator.py", "fleet/__init__.py",
                   "fleet/ring.py", "fleet/router.py", "fleet/manager.py",
                   "cli/fleet.py", "utils/logging.py",
                   "resilience/faults.py", "resilience/watchdog.py",
                   "metrics/anomaly.py", "metrics/exporter.py",
                   "metrics/flightrec.py", "metrics/goodput.py",
                   "train/telemetry.py", "utils/profiler.py",
                   # the model axis: the mesh, its rules and plan, the
                   # split layers and the conjugate operators
                   "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/plan.py", "models/encoder.py",
                   "models/qa_model.py", "models/convert.py",
                   "ops/attention.py"):
        assert f"ml_recipe_tpu_torch/{module}" in names, module
    offenders = [f"{path.relative_to(_REPO)}: {mod}"
                 for path in files for mod in _imports(path)
                 if _forbidden(mod)]
    assert not offenders, offenders


def test_card_worker_of_the_model_axis_imports_no_jax():
    """The tensor-parallel tests' worker also runs the card's
    ``-k model_pair`` pair, where there is no jax."""
    path = _REPO / "tests" / "test_torch_tensor_parallel_worker.py"
    assert not [m for m in _imports(path) if _forbidden(m)]


def test_card_worker_of_pipe_model_imports_no_jax():
    """The pipe x model tests' worker also runs the card's
    ``-k pipe_model_pair`` quad, where there is no jax."""
    path = _REPO / "tests" / "test_torch_pipe_model_worker.py"
    assert not [m for m in _imports(path) if _forbidden(m)]


def test_launcher_script_names_no_jax_module():
    text = (_REPO / "scripts" / "worker_torch.sh").read_text()
    named = set(re.findall(r"python[0-9.]* -m ([\w.]+)", text))
    assert named == {"ml_recipe_tpu_torch.cli.train"}
    words = set(re.findall(r"[A-Za-z_][\w.]*", text))
    assert not [w for w in words if _forbidden(w.rstrip("."))]


def test_entry_points_load_no_jax():
    code = ("import sys, ml_recipe_tpu_torch.cli.serve, "
            "ml_recipe_tpu_torch.serve.engine, ml_recipe_tpu_torch.serve.server, "
            "ml_recipe_tpu_torch.cli.train, ml_recipe_tpu_torch.train.trainer, "
            "ml_recipe_tpu_torch.quant, ml_recipe_tpu_torch.cli.validate, "
            "ml_recipe_tpu_torch.cli.train_metrics, "
            "ml_recipe_tpu_torch.infer.predictor, "
            "ml_recipe_tpu_torch.parallel, "
            "ml_recipe_tpu_torch.models.hf_convert, "
            "ml_recipe_tpu_torch.resilience.checkpoint_async, "
            "ml_recipe_tpu_torch.cli.fleet, ml_recipe_tpu_torch.fleet, "
            "ml_recipe_tpu_torch.serve.cache, "
            "ml_recipe_tpu_torch.metrics.trace, "
            "ml_recipe_tpu_torch.resilience.supervisor, "
            "ml_recipe_tpu_torch.resilience.faults, "
            "ml_recipe_tpu_torch.resilience.watchdog, "
            "ml_recipe_tpu_torch.metrics.goodput, "
            "ml_recipe_tpu_torch.metrics.flightrec, "
            "ml_recipe_tpu_torch.metrics.exporter, "
            "ml_recipe_tpu_torch.train.telemetry, "
            "ml_recipe_tpu_torch.utils.profiler; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'ml_recipe_tpu', 'safetensors', "
            "'transformers')); "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(_REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_default_device_without_cuda_raises(monkeypatch, tmp_path):
    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.config.parser import get_model_parser
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab
    from ml_recipe_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    vocab = write_synthetic_bert_vocab(tmp_path / "vocab.txt", size=200)
    params, _ = get_model_parser().parse_known_args(
        ["--model", "bert-tiny", "--vocab_file", vocab])
    assert params.device == "cuda"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_model(params)
    # asking for the CPU on purpose works
    model, _ = init_model(params, device="cpu")
    assert model.device.type == "cpu"
    # the predictor's entry points default to CUDA too
    from ml_recipe_tpu_torch.cli import train_metrics, validate
    from ml_recipe_tpu_torch.config.parser import get_params, get_predictor_parser

    for cli in (validate, train_metrics):
        _, (pparams, mparams) = get_params(
            (get_predictor_parser, get_model_parser),
            ["--model", "bert-tiny", "--vocab_file", vocab])
        assert mparams.device == "cuda"
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(pparams, mparams)
