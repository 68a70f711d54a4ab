"""The port's training options against the JAX package's, on the CPU.

Every input comes from a numpy seed and goes through both packages:

- AdaMod: 5 steps of ``build_optimizer(--optimizer adamod)`` on a tiny
  parameter tree with the decay mask, against the JAX ``adamod`` chain:
  parameters and the three moments at ``rtol=1e-6``; its ``flax_state``
  is the JAX chain's ``to_state_dict``, and loads back;
- fine-tune masks: for every set of the four ``--finetune_*`` flags the
  port's trainable names are ``trainable_mask``'s, none raises
  ``AttributeError``, and the masked chains' state layouts (``{}`` for a
  frozen leaf) are the JAX package's;
- loss scaling: ``update_state`` over a run of finite flags that grows,
  hits the 2^16 cap, backs off to the 2^-14 floor and grows again, equal
  to the JAX ``update_state`` at every step; a static scale never moves;
- the trainer: the port's ``Trainer`` and a tiny JAX ``Trainer`` take 5
  steps from the same weights on the same items (dropout 0, ``data:1``),
  with ``--optimizer adamod``, ``--apex_loss_scale dynamic``,
  ``--apex_loss_scale 128`` and ``--finetune --finetune_position
  --finetune_class``: step losses, lr and end parameters agree, and the
  frozen leaves are bit for bit their start;
- overflow: both packages resume a JAX checkpoint whose dynamic scale is
  2^127, so the first steps' scaled gradients overflow f32: both skip the
  same three steps, log the same scales and lr, and end at the same
  parameters.

Tolerances are f32's: both sides compute in float32, in other summation
orders, ~1e-7 relative per op.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from ml_recipe_tpu.data.collate import make_collate_fun as jax_make_collate
from ml_recipe_tpu.data.datasets import DummyDataset as JaxDummyDataset
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu.tokenizer import Tokenizer as JaxTokenizer
from ml_recipe_tpu.train import Trainer as JaxTrainer
from ml_recipe_tpu.train import loss_scale as jax_ls
from ml_recipe_tpu.train.optim import build_optimizer as jax_build_optimizer
from ml_recipe_tpu.train.optim import trainable_mask as jax_trainable_mask
from ml_recipe_tpu_torch.data.collate import make_collate_fun
from ml_recipe_tpu_torch.data.datasets import DummyDataset
from ml_recipe_tpu_torch.losses import build_loss
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.models.convert import jax_path
from ml_recipe_tpu_torch.tokenizer import Tokenizer
from ml_recipe_tpu_torch.train import loss_scale as ls
from ml_recipe_tpu_torch.train.optim import (
    AdaMod,
    AdamW,
    build_optimizer,
    trainable_mask,
)
from ml_recipe_tpu_torch.train.trainer import Trainer

from helpers import write_vocab

MAX_SEQ_LEN, MAX_Q_LEN = 48, 12
# end parameters after 5 steps: a step moves each element by ~lr whatever
# its gradient's scale, so an element whose gradient is near 0 and differs
# in its last bits moves by a few lr*1e-3 more on one side
PARAM_ATOL = 2e-5
FLAGS = ("finetune_transformer", "finetune_position", "finetune_position_reg",
         "finetune_class")


@pytest.fixture(scope="module", autouse=True)
def _one_cpu_thread():
    """One intra-op thread for this module's tiny models (the processes it
    starts get ``OMP_NUM_THREADS=1``): the test workers share the host's
    cores, and more threads a process only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tp(**kw):
    base = dict(loss="smooth", smooth_alpha=0.01, focal_alpha=1.0,
                focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                w_end_reg=0.5, w_cls=1, lr=1e-3, weight_decay=0.01,
                warmup_coef=0.3, optimizer="adam", finetune=False,
                apex_loss_scale=None, best_metric="map", best_order=">")
    base.update(kw)
    return SimpleNamespace(**base)


def _tree_of(arrays: dict) -> dict:
    return jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {n: torch.from_numpy(v) for n, v in arrays.items()}))


def _structure(tree):
    """Nested keys down to the leaves, ``{}`` kept (optax MaskedNode)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _assert_same_state(mine: dict, ref: dict, rtol=0.0):
    assert _structure(mine) == _structure(ref)
    ml = jax.tree_util.tree_leaves_with_path(mine)
    rl = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in ml] == [p for p, _ in rl]
    for (path, a), (_, b) in zip(ml, rl):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=0, err_msg=str(path))


# -- AdaMod ---------------------------------------------------------------------

SHAPES = {"transformer.layer_0.attention.query.weight": (4, 3),
          "transformer.layer_0.attention.query.bias": (4,),
          "transformer.layer_0.attention.layer_norm.weight": (4,),
          "transformer.embeddings.word_embeddings.weight": (6, 4),
          "position_outputs.weight": (2, 4), "position_outputs.bias": (2,),
          "classifier.weight": (5, 4), "classifier.bias": (5,)}


def test_adamod_matches_the_jax_chain():
    rng = np.random.default_rng(7)
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    tp = _tp(optimizer="adamod", lr=1e-2, weight_decay=0.1, warmup_coef=0.3)
    jparams = _tree_of(init)
    tx, schedule, count_of = jax_build_optimizer(tp, jparams,
                                                 num_training_steps=10)
    jstate = tx.init(jparams)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = build_optimizer(tp, params, num_training_steps=10)
    assert isinstance(opt, AdaMod) and opt.eps == 1e-8 and opt.beta3 == 0.999
    for step in range(5):
        grads = {n: (rng.normal(size=v.shape) * 3).astype(np.float32)
                 for n, v in init.items()}
        updates, jstate = tx.update(_tree_of(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = opt.step({n: torch.from_numpy(g) for n, g in grads.items()})
        # the lr of the pre-increment count: 0 under warmup at step 0
        assert lr == float(schedule(step)) and (lr == 0.0) == (step == 0)
    assert opt.count == opt.schedule_count == int(count_of(jstate)) == 5

    ref = serialization.to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             jstate))
    _assert_same_state(opt.flax_state(), ref, rtol=1e-6)
    got = to_jax_params({n: p.detach() for n, p in params.items()})
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                   err_msg=str(path))
    # a round trip through the layout
    fresh = build_optimizer(tp, {n: torch.nn.Parameter(torch.zeros(s))
                                 for n, s in SHAPES.items()},
                            num_training_steps=10)
    fresh.load_flax_state(ref)
    _assert_same_state(fresh.flax_state(), ref)
    # the adam chain's layout is another optimizer's state
    with pytest.raises(ValueError, match="AdamW"):
        build_optimizer(_tp(), dict(params), num_training_steps=10) \
            .load_flax_state(ref)


# -- fine-tune masks ------------------------------------------------------------

COMBOS = [c for n in range(1, 5) for c in itertools.combinations(FLAGS, n)]


@pytest.mark.parametrize("flags", COMBOS, ids=["+".join(
    f.removeprefix("finetune_") for f in c) for c in COMBOS])
def test_trainable_names_match_jax_mask(flags):
    tp = _tp(finetune=True, **{f: True for f in flags})
    mine = trainable_mask(SHAPES, tp)
    ref = jax_trainable_mask(_tree_of({n: np.zeros(s, np.float32)
                                       for n, s in SHAPES.items()}), tp)
    for name, trains in mine.items():
        node = ref
        for part in jax_path(name):
            node = node[part]
        assert trains == bool(node), name
    assert trainable_mask(SHAPES, _tp()) is None


def test_finetune_without_a_module_raises():
    tp = _tp(finetune=True)
    with pytest.raises(AttributeError, match="at least one module"):
        trainable_mask(SHAPES, tp)
    with pytest.raises(AttributeError, match="at least one module"):
        jax_trainable_mask(_tree_of({n: np.zeros(s, np.float32)
                                     for n, s in SHAPES.items()}), tp)
    params = {n: torch.nn.Parameter(torch.zeros(s)) for n, s in SHAPES.items()}
    with pytest.raises(AttributeError):
        build_optimizer(tp, params, num_training_steps=4)


@pytest.mark.parametrize("optimizer", ["adam", "adamod"])
def test_finetune_state_layout_matches_jax(optimizer):
    tp = _tp(optimizer=optimizer, finetune=True, finetune_position=True,
             finetune_class=True)
    rng = np.random.default_rng(3)
    init = {n: rng.normal(size=s).astype(np.float32) for n, s in SHAPES.items()}
    tx, _, _ = jax_build_optimizer(tp, _tree_of(init), num_training_steps=4)
    ref = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, tx.init(_tree_of(init))))
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in init.items()}
    opt = build_optimizer(tp, params, num_training_steps=4)
    assert type(opt) is {"adam": AdamW, "adamod": AdaMod}[optimizer]
    frozen = {n for n in SHAPES if n.startswith("transformer.")}
    assert set(opt.frozen) == frozen and set(opt.params) == set(SHAPES) - frozen
    assert all(params[n].requires_grad == (n not in frozen) for n in SHAPES)
    _assert_same_state(opt.flax_state(), ref)
    opt.load_flax_state(ref)


# -- loss scaling ---------------------------------------------------------------

def test_loss_scale_update_state_matches_jax():
    flags = ([True] * 7 + [False] * 34 + [True] * 5 + [False, True, True]
             + [True] * 4)
    kw = dict(growth_interval=3)
    mine, ref = ls.init_state("dynamic"), jax_ls.init_state(2.0 ** 15,
                                                            dynamic=True)
    seen = set()
    for finite in flags:
        mine = ls.update_state(mine, finite, **kw)
        ref = jax_ls.update_state(ref, jnp.asarray(finite), **kw)
        for key, value in mine.state_dict().items():
            want = np.asarray(getattr(ref, key))
            assert value.dtype == want.dtype and value == want, key
        seen.add(mine.scale)
    assert {2.0 ** 16, 2.0 ** -14} <= seen      # both clamps were reached
    static = ls.init_state(128.0)
    ref = jax_ls.init_state(128.0, dynamic=False)
    for finite in (False, True, True, True, False):
        static = ls.update_state(static, finite, **kw)
        ref = jax_ls.update_state(ref, jnp.asarray(finite), **kw)
        assert static.scale == float(ref.scale) == 128.0
    assert ls.LossScaleState.from_state_dict(mine.state_dict()) == mine
    with pytest.raises(ValueError, match="positive"):
        ls.init_state(0.0)


# -- the trainer against the JAX Trainer ------------------------------------------

def _tiny_cfg(kind, vocab_size):
    return kind(vocab_size=vocab_size, hidden_size=16, num_layers=2,
                num_heads=2, intermediate_size=32,
                max_position_embeddings=MAX_SEQ_LEN + 2, num_labels=5,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _own_aot_programs(monkeypatch, request):
    """The JAX package's AOT program store keys a train step by its shapes
    and shardings, not by the loss-scale mode: a dynamic run's program
    would serve the static run's trainer (and fail). A salt per test keeps
    each test's programs its own."""
    monkeypatch.setenv("MLRT_AOT_SALT", request.node.name)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("options")
    vocab = str(write_vocab(tmp))
    jtok, ttok = (JaxTokenizer("bert", vocab, lowercase=True),
                  Tokenizer("bert", vocab, lowercase=True))
    kw = dict(max_seq_len=MAX_SEQ_LEN, max_question_len=MAX_Q_LEN,
              dataset_len=40)
    jds = JaxDummyDataset(tokenizer=jtok, rng=np.random.default_rng(0), **kw)
    tds = DummyDataset(tokenizer=ttok, rng=np.random.default_rng(0), **kw)
    jcfg = _tiny_cfg(JaxEncoderConfig, len(jtok))
    init = JaxQAModel(jcfg).init(
        jax.random.key(0), np.zeros((1, MAX_SEQ_LEN), np.int32))["params"]
    return SimpleNamespace(tmp=tmp, jtok=jtok, ttok=ttok, jds=jds, tds=tds,
                           jcfg=jcfg, mesh=build_mesh("data:1"),
                           init=jax.tree_util.tree_map(np.asarray, init))


def jax_trainer(world, tp, params, log, **kw):
    return JaxTrainer(
        model=JaxQAModel(world.jcfg, attention_impl="xla", mesh=world.mesh),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        loss=jax_build_loss(tp),
        collate_fun=jax_make_collate(world.jtok, max_seq_len=MAX_SEQ_LEN),
        trainer_params=tp, train_dataset=world.jds, mesh=world.mesh,
        n_epochs=1, train_batch_size=8, batch_split=2, n_jobs=1,
        warmup_coef=0.3, max_grad_norm=0.5, seed=0, hbm_preflight=False,
        on_train_metrics=lambda m, step: log.append(_logged(m, step)), **kw)


def port_trainer(world, tp, params, log, **kw):
    model = QAModel(_tiny_cfg(EncoderConfig, len(world.ttok)),
                    dtype=torch.float32, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return Trainer(model, build_loss(tp),
                   make_collate_fun(world.ttok, max_seq_len=MAX_SEQ_LEN),
                   trainer_params=tp, train_dataset=world.tds, n_epochs=1,
                   train_batch_size=8, batch_split=2, n_jobs=1,
                   warmup_coef=0.3, max_grad_norm=0.5, seed=0,
                   on_train_metrics=lambda m, step: log.append(
                       _logged(m, step)), **kw)


def _logged(meters, step):
    out = {"step": step, "lr": float(meters["lr"])}
    for key in ("loss", "loss_scale", "grads_finite"):
        if key in meters:
            out[key] = meters[key]()
    return out


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


OPTIONS = {
    "adamod": dict(optimizer="adamod"),
    "dynamic": dict(apex_loss_scale="dynamic"),
    "static128": dict(apex_loss_scale=128.0),
    "finetune": dict(finetune=True, finetune_position=True,
                     finetune_class=True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_trainer_steps_match_jax_trainer(world, option):
    tp = _tp(**OPTIONS[option])
    j_log, t_log = [], []
    jt = jax_trainer(world, tp, world.init, j_log)
    jt.train()
    tt = port_trainer(world, tp, world.init, t_log)
    tt.train()
    assert len(j_log) == len(t_log) == 5 == tt.global_step == jt.global_step
    for a, b in zip(t_log, j_log):
        assert a.keys() == b.keys(), (a, b)
        assert a["lr"] == b["lr"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        for key in ("loss_scale", "grads_finite"):
            if key in b:
                assert a[key] == b[key]
    if tp.apex_loss_scale is not None:
        assert t_log[-1]["grads_finite"] == 1.0
        assert tt.loss_scale.scale == (2.0 ** 15 if option == "dynamic"
                                       else 128.0)
    got = to_jax_params(tt.model.state_dict())
    ref = jax.tree_util.tree_map(np.asarray, jt.params)
    moved = 0
    for (path, a), (_, b), (_, c) in zip(_leaves(got), _leaves(ref),
                                         _leaves(world.init)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=PARAM_ATOL,
                                   err_msg=str(path))
        if option == "finetune" and path[0].key in ("transformer",
                                                    "reg_start", "reg_end"):
            assert np.array_equal(a, c) and np.array_equal(b, c), path
        else:
            moved += not np.array_equal(a, c)
    assert moved > 0
    ref_state = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, jt._split_ls()[0]))
    assert _structure(tt.optimizer.flax_state()) == _structure(ref_state)


def test_overflow_resume_skips_the_same_steps(world):
    """A JAX checkpoint at dynamic scale 2^127: the scaled losses (and
    gradients) of the first steps overflow f32 in both packages. The head
    weights of 4 make three steps overflow, so the first finite step runs
    at 2^124: at exactly 2^126 the JAX step's f32 ``1/scale`` is the
    smallest normal, which XLA's CPU code flushes, so its unscaled
    gradients vanish there and no port could follow."""
    tp = _tp(apex_loss_scale="dynamic", w_start=4, w_end=4, w_cls=4)
    jt = jax_trainer(world, tp, world.init, [])
    inner, state = jt._split_ls()
    jt.opt_state = jax_ls.OptStateWithLS(inner, state._replace(
        scale=jnp.float32(2.0 ** 127), growth_count=jnp.int32(7)))
    path = world.tmp / "overflow.ch"
    jt.save_state_dict(path)

    j_log, t_log = [], []
    jt = jax_trainer(world, tp, world.init, j_log)
    jt.load_state_dict(path)
    jt.train()
    tt = port_trainer(world, tp, world.init, t_log)
    tt.load_state_dict(path)
    assert tt.loss_scale == ls.LossScaleState(2.0 ** 127, 7, True)
    before = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    tt.train()
    finite = [h["grads_finite"] for h in tt.history]
    assert finite == [0.0, 0.0, 0.0, 1.0, 1.0], finite
    assert [h["loss_scale"] for h in tt.history] == [
        2.0 ** 126, 2.0 ** 125, 2.0 ** 124, 2.0 ** 124, 2.0 ** 124]
    assert [x["lr"] for x in t_log] == [x["lr"] for x in j_log]
    assert [x["loss_scale"] for x in t_log] == [x["loss_scale"] for x in j_log]
    assert [x["grads_finite"] for x in t_log] == \
        [x["grads_finite"] for x in j_log]
    np.testing.assert_allclose([x["loss"] for x in t_log],
                               [x["loss"] for x in j_log], rtol=1e-5)
    # skipped steps leave the lr at the schedule's count, not the step's
    skipped = finite.index(1.0)
    assert tt.optimizer.count == len(t_log) - skipped
    assert t_log[skipped]["lr"] == tt.optimizer.schedule(0)
    assert tt.loss_scale.scale == float(jt._split_ls()[1].scale)
    got = to_jax_params(tt.model.state_dict())
    ref = jax.tree_util.tree_map(np.asarray, jt.params)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=PARAM_ATOL,
                                   err_msg=str(path))
    assert any(not torch.equal(p.detach(), before[n])
               for n, p in tt.model.named_parameters())
