"""ZeRO-1 in the port (``--optimizer_sharding zero1`` over the ``data``
axis) against the port's unsharded step and against the JAX package's
ZeRO-1 ``Trainer``, on the CPU.

The port's pairs are gloo processes of ``tests/torch_ddp_worker.py``:
``zero1`` and ``zero1_off``, the tiny trainer on ``data:2`` at
``batch_split`` 1, dropout 0, every leaf planned (``zero_min_size`` 0, so
the odd-sized leaves pad: the 5-label classifier's bias pads to 6). The
JAX side is its ``Trainer`` on the mesh ``data:2`` of the conftest's
virtual CPU devices with ``optimizer_sharding='zero1'`` and the same
``zero_min_size``, from the same weights on the same items (at
``batch_split`` 1 the one JAX process's global batch is the two ranks'
rows, in rank order).

- zero1 and off: step values equal and end parameters ``torch.equal``
  (the update is elementwise on the same values);
- zero1 against JAX: step losses ``rtol=2e-5``, parameters ``atol=5e-5``
  (the JAX package's own pins), optimizer moments ``atol=1e-5``;
- a JAX zero1 checkpoint (single file and sharded directory) resumes in
  the port's zero1 pair with every padded moment bit for bit, and the
  port's resumes in the JAX trainer likewise; ``opt_sharding`` and
  ``mesh_axes`` equal the JAX checkpoint's; a sharded zero1 checkpoint of
  the port reloads in one process (``data:1``, cropped);
- each zero1 rank holds about half of the moments' bytes;
- ``_zero_leaf_plan`` equals the JAX package's leaf by leaf on bert-base's
  parameter shapes at data sizes 2, 3, 5 and 8 (5 pads), and
  ``zero_pad_tree`` / ``zero_unpad_tree`` equal JAX's on a small tree.
"""

import concurrent.futures
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu.data.collate import make_collate_fun as jax_collate
from ml_recipe_tpu.data.datasets import DatasetItem as JaxItem
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh as jax_build_mesh
from ml_recipe_tpu.parallel.sharding import _zero_leaf_plan as jax_leaf_plan
from ml_recipe_tpu.parallel.sharding import zero1_plan as jax_zero1_plan
from ml_recipe_tpu.parallel.sharding import zero_pad_tree as jax_pad_tree
from ml_recipe_tpu.parallel.sharding import zero_unpad_tree as jax_unpad_tree
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu_torch.models import QAModel, to_jax_params
from ml_recipe_tpu_torch.models.config import MODEL_PRESETS
from ml_recipe_tpu_torch.parallel.sharding import (
    _zero_leaf_plan,
    zero1_plan,
    zero1_state_bytes,
    zero_pad_tree,
    zero_unpad_tree,
)
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train.checkpoint import read_state

RTOL, PARAMS_ATOL, STATE_ATOL = 2e-5, 5e-5, 1e-5


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, tree))


def _assert_same_tree(a, b, atol=None):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape, path
        if atol is None:
            assert np.array_equal(x, y), path
        else:
            np.testing.assert_allclose(x, y, atol=atol, err_msg=str(path))


def _jax_zero1_trainer(tmp, steps, **trainer_kw):
    tok = JaxTokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    ttok = Tokenizer("bert", str(write_vocab(tmp)), lowercase=True)
    init = to_jax_params(worker.tiny_model(len(ttok), dropout=0.0).state_dict())
    mesh = jax_build_mesh("data:2")
    cfg = JaxEncoderConfig(vocab_size=len(tok), hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, **worker.TINY_MODEL)
    tp, weights = worker.trainer_params(), worker.train_weights()
    return init, JaxTrainer(
        model=JaxQAModel(cfg, attention_impl="xla", mesh=mesh,
                         ln_impl="fused"),
        params=init, loss=jax_build_loss(tp, weights),
        collate_fun=jax_collate(tok, max_seq_len=worker.MAX_SEQ_LEN),
        trainer_params=tp,
        train_dataset=worker.VariedDataset(tok, worker.N_TRAIN, seed=1,
                                           item=JaxItem),
        mesh=mesh, train_batch_size=worker.TRAIN_BATCH, batch_split=1,
        n_jobs=1, warmup_coef=0.0, max_grad_norm=worker.MAX_GRAD_NORM,
        train_weights=weights, debug=True, seed=0, hbm_preflight=False,
        optimizer_sharding="zero1", zero_min_size=0, **trainer_kw,
        on_train_metrics=lambda meters, step: steps.append(
            {k: float(v) if k == "lr" else float(v())
             for k, v in meters.items()}))


def _jax_state(jt):
    return serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jt.opt_state))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        off = pool.submit(worker.worker_pairs, "zero1_off", out=tmp)
        steps = []
        init, jt = _jax_zero1_trainer(tmp, steps)
        assert jt.zero_enabled()
        jt.train()
        trained = _jax_state(jt)
        jax_params = jax.tree_util.tree_map(np.asarray, jt.params)
        jt.debug = False
        jt.save_state_dict(tmp / "jax.ch")
        jt.sharded_checkpoint = True
        jt.save_state_dict(tmp / "jax_dir")
        results = worker.worker_pairs("zero1", out=tmp) + off.result()
    for pair in results:
        for rc, err in pair:
            assert rc == 0, err[-3000:]
    port = {mode: [torch.load(tmp / mode / f"zero{r}.pt", weights_only=False)
                   for r in range(2)]
            for mode in ("zero1", "zero1_off")}
    runs_ = {mode: [torch.load(tmp / mode / f"rank{r}.pt") for r in range(2)]
             for mode in ("zero1", "zero1_off")}
    # the port's checkpoints into the JAX trainer
    resumed = {}
    for name, sharded in (("port.ch", False), ("port_dir", True)):
        jt.sharded_checkpoint = sharded
        jt.load_state_dict(tmp / "zero1" / name)
        resumed[name] = _jax_state(jt)
    return dict(tmp=tmp, steps=steps, init=init, jax_state=trained,
                jax_params=jax_params, port=port, runs=runs_, resumed=resumed)


def test_zero1_is_bit_identical_to_off(runs):
    z, off = runs["runs"]["zero1"], runs["runs"]["zero1_off"]
    for r in range(2):
        assert z[r]["values"] == off[r]["values"]
        for name, p in off[r]["params"].items():
            assert torch.equal(z[r]["params"][name], p), name
    assert z[0]["values"] == z[1]["values"]


def test_zero1_equals_the_jax_zero1_trainer(runs):
    want, got = runs["steps"], runs["runs"]["zero1"][0]["values"]
    assert len(want) == len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    params = to_jax_params(runs["runs"]["zero1"][0]["params"])
    _assert_same_tree(params, runs["jax_params"], atol=PARAMS_ATOL)
    # the padded moments, as the JAX trainer lays them out
    _assert_same_tree(runs["port"]["zero1"][0]["state"], runs["jax_state"],
                      atol=STATE_ATOL)


def test_checkpoints_cross_both_ways_with_jax(runs):
    port = runs["port"]["zero1"]
    for r in range(2):
        for name in ("jax.ch", "jax_dir"):
            _assert_same_tree(port[r][name], runs["jax_state"])
    for name in ("port.ch", "port_dir"):
        _assert_same_tree(runs["resumed"][name], port[0]["state"])
    _assert_same_tree(port[0]["saved"], port[0]["state"])
    ours, theirs = (read_state(runs["tmp"] / "zero1" / "port.ch"),
                    read_state(runs["tmp"] / "jax.ch"))
    for key in ("opt_sharding", "mesh_axes"):
        assert ours[key] == theirs[key], key
    assert ours["opt_sharding"] == "zero1" and ours["mesh_axes"] == {"data": 2}
    off = read_state(runs["tmp"] / "zero1_off" / "port.ch")
    assert off["opt_sharding"] == "off"


def test_sharded_zero1_checkpoint_reloads_in_one_process(runs, tmp_path,
                                                         caplog):
    trainer = worker.tiny_trainer(tmp_path, dropout=0.0, batch_split=1)
    events = []
    trainer.telemetry = SimpleNamespace(
        observe_checkpoint_restore=lambda seconds: None,
        flightrec=SimpleNamespace(
            record=lambda kind, **f: events.append((kind, f))))
    with caplog.at_level(logging.WARNING):
        trainer.load_state_dict(runs["tmp"] / "zero1" / "port_dir")
    state = trainer.optimizer.flax_state()
    want = runs["port"]["zero1_off"][0]["state"]
    # the padded moments cropped to the parameters: the unsharded run's
    _assert_same_tree(state, want)
    assert trainer.global_step == 2
    # a restore across meshes is loud and recorded (the JAX trainer's
    # _warn_topology_change): saved under data:2, restored onto data:1
    assert "ELASTIC RESUME / topology change" in caplog.text
    assert events == [("mesh_shrunk", {"old": {"data": 2},
                                       "new": {"data": 1}})]


def test_zero1_ranks_hold_half_the_moments(runs):
    z, off = runs["port"]["zero1"], runs["port"]["zero1_off"]
    whole = off[0]["opt_bytes"]
    for r in range(2):
        assert z[r]["opt_bytes"] <= whole // 2 + 4096
    assert z[0]["opt_bytes"] + z[1]["opt_bytes"] >= whole


@pytest.mark.parametrize("data", [2, 3, 5, 8])
def test_leaf_plan_equals_jax_on_bert_base(data):
    model = QAModel(MODEL_PRESETS["bert-base-uncased"], device="meta")
    tree = to_jax_params({n: torch.empty(p.shape) for n, p in
                          model.named_parameters()
                          if "layer_" not in n or "layer_0." in n})
    padded = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        want = jax_leaf_plan(path, leaf.shape, data_size=data, has_tp=False,
                             min_size=16384)
        got = _zero_leaf_plan(path, leaf.shape, data_size=data)
        assert (tuple(want.spec) + (None,) * (leaf.ndim - len(want.spec)),
                want.axis, want.padded) == (got.spec, got.axis, got.padded)
        padded += got.axis is not None and got.padded != leaf.shape[got.axis]
    assert (padded > 0) == (data == 5)
    sizes = zero1_state_bytes(tree, data_size=data)
    assert sizes["zero1_bytes"] < sizes["replicated_bytes"]


def test_pad_and_unpad_trees_equal_jax():
    rng = np.random.default_rng(0)
    tree = {"dense": {"kernel": rng.normal(size=(7, 3)).astype(np.float32),
                      "bias": rng.normal(size=(5,)).astype(np.float32)},
            "count": np.asarray(3, np.int32)}
    plan = zero1_plan(tree, data_size=4, min_size=0)
    jplan = jax_zero1_plan(tree, jax_build_mesh("data:4"), min_size=0)
    padded, jpadded = zero_pad_tree(tree, plan), jax_pad_tree(tree, jplan)
    _assert_same_tree(padded, jpadded)
    assert padded["dense"]["kernel"].shape == (8, 3)
    _assert_same_tree(zero_unpad_tree(padded, plan, tree),
                      jax_unpad_tree(jpadded, jplan, tree))
    _assert_same_tree(zero_unpad_tree(padded, plan, tree), tree)
