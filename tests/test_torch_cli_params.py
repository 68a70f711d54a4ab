"""Each port CLI logs its parameter block as the JAX package's CLIs do.

``cli.serve``, ``cli.fleet``, ``cli.train``, ``cli.validate`` and
``cli.train_metrics`` log "Input <name> parameters:" and every field,
sorted, before they build anything (JAX ``utils/logging.py``
``show_params``, called at the same points of the JAX CLIs). Each CLI runs
until just after its block (the next call raises); the block it logged
must equal JAX ``show_params`` on the same namespaces.
"""

import logging
from pathlib import Path

import pytest

from ml_recipe_tpu.utils.logging import show_params as jax_show_params
from ml_recipe_tpu_torch.cli import fleet as fleet_cli
from ml_recipe_tpu_torch.cli import serve as serve_cli
from ml_recipe_tpu_torch.cli import train as train_cli
from ml_recipe_tpu_torch.cli import train_metrics as train_metrics_cli
from ml_recipe_tpu_torch.cli import validate as validate_cli
from ml_recipe_tpu_torch.config.parser import (
    get_fleet_parser,
    get_model_parser,
    get_params,
    get_serve_parser,
)

from helpers import write_vocab

_REPO = Path(__file__).resolve().parents[1]


class _Stop(Exception):
    """Raised by the call that follows the parameter block."""


def _jax_block(blocks) -> list:
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("jax_show_params_reference")
    log.propagate = False
    log.setLevel(logging.INFO)
    handler = Keep()
    log.addHandler(handler)
    try:
        for params, name in blocks:
            jax_show_params(params, name, log)
    finally:
        log.removeHandler(handler)
    return records


def _port_block(caplog) -> list:
    return [r.getMessage() for r in caplog.records
            if r.name == "ml_recipe_tpu_torch.utils.logging"]


def _stop(*args, **kwargs):
    raise _Stop(args)


def _serve(tmp_path, monkeypatch):
    _, (params, model) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "serve.cfg"), "--vocab_file",
         str(write_vocab(tmp_path)), "--device", "cpu"])
    monkeypatch.setattr(serve_cli, "build_engine", _stop)
    return lambda: serve_cli.main(params, model), \
        lambda: [(model, "model"), (params, "serve")]


def _fleet(tmp_path, monkeypatch):
    _, (fleet, params, model) = get_params(
        (get_fleet_parser, get_serve_parser, get_model_parser),
        ["-c", str(_REPO / "config" / "fleet.cfg"), "--vocab_file",
         str(write_vocab(tmp_path)), "--device", "cpu"])
    monkeypatch.setattr(fleet_cli, "check_serve_flags", _stop)
    return lambda: fleet_cli.main(fleet, params, model), \
        lambda: [(model, "model"), (params, "serve"), (fleet, "fleet")]


def _predictor_args(tmp_path):
    return ["--model", "bert-tiny", "--device", "cpu", "--vocab_file",
            str(write_vocab(tmp_path)), "--data_path", str(tmp_path / "d"),
            "--processed_data_path", str(tmp_path / "p")]


def _validate(tmp_path, monkeypatch):
    params, model = validate_cli.parse(_predictor_args(tmp_path))
    monkeypatch.setattr(validate_cli, "check_predict_flags", _stop)
    return lambda: validate_cli.main(params, model), \
        lambda: [(model, "model"), (params, "predictor")]


def _train_metrics(tmp_path, monkeypatch):
    params, model = train_metrics_cli.parse(_predictor_args(tmp_path))
    monkeypatch.setattr(train_metrics_cli, "check_predict_flags", _stop)
    return lambda: train_metrics_cli.main(params, model), \
        lambda: [(model, "model"), (params, "test")]


def _train(tmp_path, monkeypatch):
    seen = []

    def record(parser, namespace, path):  # noqa: ARG001 - write_config_file's
        seen.append(namespace)
        if len(seen) == 2:
            raise _Stop()

    monkeypatch.setattr(train_cli, "write_config_file", record)
    argv = ["-c", str(_REPO / "config" / "test_bert.cfg"), "--model",
            "bert-tiny", "--device", "cpu", "--vocab_file",
            str(write_vocab(tmp_path)), "--dump_dir", str(tmp_path / "out")]
    # the trainer's namespace first, then the model's
    return lambda: train_cli.main(argv), \
        lambda: [(seen[1], "model"), (seen[0], "trainer")]


@pytest.mark.parametrize("cli", [_serve, _fleet, _train, _validate,
                                 _train_metrics])
def test_parameter_block_equals_jax_show_params(cli, tmp_path, monkeypatch,
                                                 caplog):
    run, blocks = cli(tmp_path, monkeypatch)
    with caplog.at_level(logging.INFO), pytest.raises(_Stop):
        run()
    got = _port_block(caplog)
    ref = _jax_block(blocks())
    assert got == ref
    names = [line for line in got if line.startswith("Input ")]
    assert len(names) >= 2 and all(line.endswith(" parameters:")
                                   for line in names)
