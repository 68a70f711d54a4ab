"""HF warm start, BPE dropout, ``--param_dtype`` and the CLIs with this
slice's flags, against the JAX package, on the CPU.

- HF conversion: a seeded random HF BERT state dict (``bert.`` prefix, the
  ``position_ids`` buffer, a task-head entry) written as
  ``pytorch_model.bin`` (``torch.save``) and as ``model.safetensors`` (the
  port's writer), and a roberta one: the port's model after
  ``load_pretrained_into`` is ``torch.equal`` to JAX
  ``load_pretrained_into``'s parameters through ``from_jax_params``, heads
  included (both keep their init); a widened position table keeps the same
  rows as JAX's; a wrong shape raises in both; a hub name raises;
- the port's safetensors reader equals ``safetensors.numpy.load_file``
  (the oracle only: the card has no ``safetensors``);
- ``compose.init_model``: checkpoint > ``--hf_checkpoint`` > random;
- BPE dropout: the same seeded generator gives both packages the same
  pieces at p = 0.1 and 0.9; ``init_tokenizer(..., bpe_dropout=p)``
  reaches the tokenizer and turns the dataset's token cache off;
- ``--param_dtype bfloat16``: JAX's ``init_model`` keeps every leaf f32,
  the port accepts the flag, logs it, and trains bit for bit as without;
- the CLIs: ``cli.train`` with every option of this slice on, then
  ``cli.validate`` from ``--hf_checkpoint`` alone.
"""

import logging
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from safetensors.numpy import load_file as st_load_file

from ml_recipe_tpu.compose import init_model as jax_init_model
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.models.hf_convert import (
    load_pretrained_into as jax_load_pretrained_into,
)
from ml_recipe_tpu.tokenizer.bpe import ByteLevelBPETokenizer as JaxBPE
from ml_recipe_tpu_torch.cli import train as train_cli
from ml_recipe_tpu_torch.compose import init_model, init_tokenizer
from ml_recipe_tpu_torch.config.parser import (
    check_serve_flags,
    check_train_flags,
    get_model_parser,
    get_params,
    get_serve_parser,
    get_trainer_parser,
)
from ml_recipe_tpu_torch.data.datasets import SplitDataset
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, from_jax_params
from ml_recipe_tpu_torch.models.config import MODEL_PRESETS
from ml_recipe_tpu_torch.models.hf_convert import (
    load_hf_state_dict,
    load_pretrained_into,
    read_safetensors,
    synthetic_hf_state_dict,
    write_safetensors,
)
from ml_recipe_tpu_torch.tokenizer.bpe import ByteLevelBPETokenizer
from ml_recipe_tpu_torch.train.checkpoint import save_state_dict

from helpers import write_bpe_files, write_vocab
from test_torch_nq_data import write_mixed_corpus

REPO = Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=60, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position_embeddings=64, num_labels=5)


def _write_hf(path: Path, sd: dict, fmt: str) -> Path:
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
    else:
        write_safetensors(path / "model.safetensors", sd)
    return path


def _jax_init(**cfg):
    jcfg = JaxEncoderConfig(**{**TINY, **cfg})
    params = JaxQAModel(jcfg).init(jax.random.key(1),
                                   np.zeros((1, 8), np.int32))["params"]
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def _port_model(jax_params, **cfg):
    model = QAModel(EncoderConfig(**{**TINY, **cfg}), dtype=torch.float32,
                    device="cpu")
    model.load_state_dict(from_jax_params(jax_params), strict=True)
    return model


def _assert_equal_to_jax(model, jax_params):
    want = from_jax_params(jax_params)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


CASES = [("bert", "bin", {}), ("bert", "safetensors", {}),
         ("roberta", "safetensors", {}),
         # a 1024-row table from a 64-row checkpoint: the tail keeps its init
         ("bert", "bin", dict(max_position_embeddings=1024))]


@pytest.mark.parametrize("model_type,fmt,cfg", CASES,
                         ids=["bert-bin", "bert-safetensors",
                              "roberta-safetensors", "bert-widened"])
def test_warm_start_equals_jax_load_pretrained_into(tmp_path, model_type,
                                                    fmt, cfg):
    # a roberta checkpoint has 2 position rows more than its usable ones
    rows = TINY["max_position_embeddings"] + (2 if model_type == "roberta"
                                              else 0)
    sd = synthetic_hf_state_dict(EncoderConfig(
        **{**TINY, "max_position_embeddings": rows}), seed=5)
    sd = {k.replace("bert.", f"{model_type}.", 1): v for k, v in sd.items()}
    path = _write_hf(tmp_path / "hf", sd, fmt)
    jcfg, jparams = _jax_init(**cfg)
    want = jax.tree_util.tree_map(np.asarray, jax_load_pretrained_into(
        jparams, str(path), jcfg.num_layers))
    model = _port_model(jparams, **cfg)
    load_pretrained_into(model, str(path))
    _assert_equal_to_jax(model, want)
    table = model.transformer.embeddings.position_embeddings.weight
    n = min(rows, table.shape[0])
    assert torch.equal(table[:n], sd[f"{model_type}.embeddings."
                                     f"position_embeddings.weight"][:n])
    if table.shape[0] > rows:   # the widened tail: the model's own init
        init = from_jax_params(jparams)[
            "transformer.embeddings.position_embeddings.weight"]
        assert torch.equal(table[rows:], init[rows:])
    # the heads keep their init
    assert torch.equal(model.classifier.weight,
                       from_jax_params(jparams)["classifier.weight"])


def test_a_wrong_shape_raises_in_both(tmp_path):
    sd = synthetic_hf_state_dict(EncoderConfig(**{**TINY, "hidden_size": 64,
                                                  "intermediate_size": 128}),
                                 seed=5)
    path = _write_hf(tmp_path / "hf", sd, "safetensors")
    jcfg, jparams = _jax_init()
    with pytest.raises(ValueError, match="does not fit the model config"):
        jax_load_pretrained_into(jparams, str(path), jcfg.num_layers)
    model = _port_model(jparams)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    with pytest.raises(ValueError, match="does not fit the model config"):
        load_pretrained_into(model, str(path))
    assert all(torch.equal(t, before[n]) for n, t in model.state_dict().items())


def test_a_hub_name_raises_naming_local_checkpoints():
    with pytest.raises(FileNotFoundError, match="only local checkpoints"):
        load_hf_state_dict("bert-base-uncased")


def test_safetensors_reader_equals_the_reference_reader(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a.weight": torch.from_numpy(rng.normal(size=(7, 5))
                                            .astype(np.float32)),
               "b.half": torch.from_numpy(rng.normal(size=(3,))
                                          .astype(np.float16)),
               "c.ids": torch.arange(12, dtype=torch.int64).reshape(3, 4),
               "d.scalar": torch.tensor(2.5), "e.empty": torch.zeros(0, 4)}
    path = tmp_path / "t.safetensors"
    write_safetensors(path, tensors)
    ref = st_load_file(str(path))
    got = read_safetensors(path)
    assert set(got) == set(ref) == set(tensors)
    for name, arr in ref.items():
        assert got[name].numpy().dtype == arr.dtype, name
        assert np.array_equal(got[name].numpy(), arr), name
    bf16 = torch.randn(4, 3).to(torch.bfloat16)
    write_safetensors(path, {"w": bf16})
    assert torch.equal(read_safetensors(path)["w"], bf16)


def _model_params(vocab, **kw):
    return SimpleNamespace(**{**dict(
        model="bert-tiny", vocab_file=str(vocab), merges_file=None,
        lowercase=True, handle_chinese_chars=False, hf_checkpoint=None,
        max_position_embeddings=None, compute_dtype="float32",
        flash_attention="xla", remat=False, ln_impl="xla", device="cpu",
        param_dtype="float32"), **kw})


def test_init_model_priority_checkpoint_then_hf_then_random(tmp_path):
    vocab = write_vocab(tmp_path)
    cfg = MODEL_PRESETS["bert-tiny"]
    path = _write_hf(tmp_path / "hf", synthetic_hf_state_dict(cfg, seed=9),
                     "safetensors")
    random, _ = init_model(_model_params(vocab), train=True, rng_seed=3)
    warm, _ = init_model(_model_params(vocab, hf_checkpoint=str(path)),
                         train=True, rng_seed=3)
    sd = read_safetensors(path / "model.safetensors")
    assert torch.equal(warm.transformer.layer_1.mlp.output.weight,
                       sd["bert.encoder.layer.1.output.dense.weight"])
    assert torch.equal(warm.classifier.weight, random.classifier.weight)
    assert not torch.equal(warm.transformer.pooler.weight,
                           random.transformer.pooler.weight)
    ckpt = tmp_path / "random.ch"
    save_state_dict(ckpt, model=random)
    restored, _ = init_model(_model_params(vocab, hf_checkpoint=str(path)),
                             checkpoint=str(ckpt), train=True, rng_seed=3)
    for name, t in random.state_dict().items():
        assert torch.equal(restored.state_dict()[name], t), name


# -- BPE dropout -----------------------------------------------------------------

CORPUS = ["the theory and the practice", "123 is in the answer",
          "another 'sentence' on the thin end...", "then there and thence"]


@pytest.mark.parametrize("p", [0.1, 0.9])
def test_bpe_dropout_pieces_match_jax(tmp_path, p):
    vocab, merges = write_bpe_files(tmp_path)
    mine = ByteLevelBPETokenizer(str(vocab), str(merges), dropout=p,
                                 rng=np.random.default_rng(4))
    ref = JaxBPE(str(vocab), str(merges), dropout=p,
                 rng=np.random.default_rng(4))
    for _ in range(3):
        for text in CORPUS:
            assert mine.tokenize(text) == ref.tokenize(text), text


def test_bpe_dropout_reaches_the_tokenizer_and_turns_the_cache_off(tmp_path):
    vocab, merges = write_bpe_files(tmp_path)
    params = _model_params(vocab, model="roberta-base", merges_file=str(merges))
    tok = init_tokenizer(params, bpe_dropout=0.1)
    assert tok.tokenizer.dropout == 0.1 and tok._native is None
    kw = dict(indexes=[0], max_seq_len=64, max_question_len=16, doc_stride=16)
    assert SplitDataset(tmp_path, tok, **kw).cache_size == 0
    assert SplitDataset(tmp_path, init_tokenizer(params), **kw).cache_size > 0


# -- --param_dtype -----------------------------------------------------------------

def _cli_args(tmp_path, *extra):
    vocab = write_vocab(tmp_path)
    return ["--model", "bert-tiny", "--device", "cpu", "--dummy_dataset",
            "--vocab_file", str(vocab), "--dump_dir", str(tmp_path / "results"),
            "--max_seq_len", "32", "--max_question_len", "8",
            "--train_batch_size", "8", "--test_batch_size", "4",
            "--batch_split", "2", "--n_jobs", "1", "--seed", "0", *extra]


def test_param_dtype_bfloat16_is_accepted_and_changes_nothing(tmp_path,
                                                              caplog):
    jax_params = SimpleNamespace(
        **{**vars(_model_params(write_vocab(tmp_path))),
           "param_dtype": "bfloat16", "vocab_file": str(write_vocab(tmp_path))})
    _, params, _ = jax_init_model(jax_params)
    assert {np.asarray(x).dtype for x in jax.tree_util.tree_leaves(params)} \
        == {np.dtype(np.float32)}

    ends = []
    for extra in ([], ["--param_dtype", "bfloat16"]):
        _, (p, mp) = get_params((get_trainer_parser, get_model_parser),
                                _cli_args(tmp_path, "--debug", *extra))
        with caplog.at_level(logging.INFO):
            check_train_flags(p, mp)
        trainer = train_cli.build_trainer(p, mp)
        trainer.train()
        ends.append({n: t.detach().clone()
                     for n, t in trainer.model.named_parameters()})
        assert all(t.dtype == torch.float32 for t in ends[-1].values())
    assert "--param_dtype bfloat16" in caplog.text
    assert all(torch.equal(ends[0][n], ends[1][n]) for n in ends[0])


# -- the CLIs ----------------------------------------------------------------------

def _run(module, *args):
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stderr


def test_cli_trains_with_every_option_then_validates_from_hf(tmp_path):
    cfg = MODEL_PRESETS["bert-tiny"]
    hf = _write_hf(tmp_path / "hf", synthetic_hf_state_dict(cfg, seed=2),
                   "bin")
    vocab = write_vocab(tmp_path)
    data = ["--model", "bert-tiny", "--device", "cpu", "--vocab_file",
            str(vocab), "--data_path", str(write_mixed_corpus(tmp_path,
                                                              n_docs=12)),
            "--processed_data_path", str(tmp_path / "proc"),
            "--max_question_len", "16", "--n_jobs", "1"]
    log = _run("ml_recipe_tpu_torch.cli.train", *data,
               "--dump_dir", str(tmp_path / "results"), "--max_seq_len", "64",
               "--doc_stride", "32", "--train_batch_size", "4",
               "--test_batch_size", "4", "--batch_split", "2", "--seed", "0",
               "--n_epochs", "1", "--ln_impl", "fused",
               "--hf_checkpoint", str(hf), "--optimizer", "adamod",
               "--apex_loss_scale", "dynamic", "--async_checkpoint",
               "--finetune", "--finetune_transformer", "--finetune_class",
               "--param_dtype", "bfloat16", "--bpe_dropout", "0.1")
    # a WordPiece vocabulary takes the flag and says it has no merges to drop
    assert "BPE dropout is not supported by the WordPiece tokenizer" in log
    assert "Encoder weights converted from" in log
    assert "Loss scaling enabled: dynamic" in log
    assert "Async checkpoint: step" in log and "loss_scale: 3.277e+04" in log
    exp = tmp_path / "results" / "test"
    assert (exp / "last.ch").exists() and (exp / "epoch_1.ch").exists()

    log = _run("ml_recipe_tpu_torch.cli.validate", *data, "--max_seq_len",
               "384", "--batch_size", "2", "--limit", "2",
               "--hf_checkpoint", str(hf))
    assert "Encoder weights converted from" in log
    assert "Validation: " in log


def test_serve_flags_accept_hf_checkpoint():
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(REPO / "config" / "serve.cfg"), "--hf_checkpoint", "d"])
    check_serve_flags(params, model_params)
