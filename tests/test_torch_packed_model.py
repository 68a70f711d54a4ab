"""The port's packed model, loss and gradients against the JAX package's.

Packed rows come from the port's ``collate_packed`` (held bit for bit
against the JAX one in tests/test_torch_packing.py) over numpy-seeded items
of mixed length, split fragments included, and feed both packages:

- the packed ``QAModel`` forward (per-segment span logits ``[B, S, L]``,
  cls and regressors ``[B, S, ...]``) against the JAX model on the same
  weights (``models/convert.py``), f32: in eval mode against the JAX
  model's XLA attention, and in training mode with attention dropout 0.1
  against its Pallas kernels in interpret mode, both sides given the same
  dropout seed per layer;
- a packed row holding one segment from position 0 equals the unpacked
  forward of that chunk;
- ``PackedWeightedLoss`` for every loss kind, absent segments and pad rows
  included, value and gradient;
- the parameter gradients of one packed micro-batch (attention dropout
  0.1, hidden dropout 0) against ``jax.grad``.

Tolerances are f32: both sides compute in float32 in other summation
orders (~1e-7 relative per op).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ml_recipe_tpu.ops.attention as jax_attention
import ml_recipe_tpu.ops.flash_attention as jax_flash
from ml_recipe_tpu.losses import PackedWeightedLoss as JaxPackedLoss
from ml_recipe_tpu.losses import build_loss as jax_build_loss
from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu_torch.data.datasets import DatasetItem
from ml_recipe_tpu_torch.data.packing import SequencePacker, collate_packed
from ml_recipe_tpu_torch.losses import PackedWeightedLoss, build_loss
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel, from_jax_params
from ml_recipe_tpu_torch.models import encoder as port_encoder
from ml_recipe_tpu_torch.models.qa_model import QA_OUTPUT_KEYS

# logits and regressors of two f32 layers in other summation orders
F32_ATOL = 1e-5
# loss values and their gradients: a few f32 reductions over <= 64 rows
LOSS_ATOL = 1e-6
# parameter gradients of one micro-batch through two f32 layers
GRAD_ATOL = 1e-6

L, S, VOCAB = 64, 4, 100
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=L,
           hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the per-layer attention-dropout seeds both sides are given
LAYER_SEEDS = (123456789, -987654321)


def _tok():
    return SimpleNamespace(pad_token_id=0, sep_token_id=3, cls_token_id=2,
                           model_name="bert")


def _items(n, seed=0, lo=8, hi=40):
    """QA items of mixed length over the tiny vocab: [CLS] question [SEP]
    body [SEP], a span in the body or none."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        length = int(rng.integers(lo, hi + 1))
        q = int(rng.integers(2, 5))
        ids = [2, *rng.integers(5, VOCAB, q).tolist(), 3,
               *rng.integers(5, VOCAB, length - q - 3).tolist(), 3]
        if rng.random() < 0.3:
            start = end = -1
        else:
            start = int(rng.integers(q + 2, length - 1))
            end = min(start + int(rng.integers(0, 3)), length - 2)
        out.append(DatasetItem(
            example_id=str(i), input_ids=ids, start_id=start, end_id=end,
            label_id=int(rng.integers(0, 5)),
            start_position=max(start, 0) / L, end_position=max(end, 0) / L))
    return out


def _packed(rows=3, seed=0, splitting="fill", pad_rows=0):
    """Packed rows from the splitting packer (min fragment 8, so a 64-token
    row leaves holes that fragments fill), and ``pad_rows`` eval pad rows
    repeating the last real one with ``segment_mask`` 0."""
    packer = SequencePacker(L, max_segments=S, splitting=splitting,
                            min_fragment=8, open_rows=4)
    done = []
    for item in _items(40, seed):
        done.extend(packer.add(item, len(item.input_ids),
                               (item.start_id, item.end_id)))
        if len(done) >= rows:
            break
    done = done[:rows]
    assert len(done) == rows
    done += [done[-1]] * pad_rows
    inputs, labels = collate_packed(done, _tok(), max_seq_len=L,
                                    max_segments=S)
    if pad_rows:
        labels["segment_mask"][rows:] = 0
    return done, inputs, labels


def _models(cfg=CFG, seed=0):
    jmodel = JaxQAModel(JaxEncoderConfig(**cfg), attention_impl="xla")
    params = jmodel.init(jax.random.key(seed), np.zeros((1, 8), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    model = QAModel(EncoderConfig(**cfg), device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return jmodel, params, model


def _port_inputs(inputs):
    return {k: torch.from_numpy(v).long() if k != "attention_mask"
            else torch.from_numpy(v) for k, v in inputs.items()}


@pytest.fixture
def seeded_dropout(monkeypatch):
    """Both packages draw LAYER_SEEDS, one per layer in order, as their
    attention-dropout seeds; the JAX dispatcher's Pallas path runs the
    kernels in interpret mode (as tests/test_ops.py runs them)."""
    j_calls, t_calls = [], []

    def jax_seed(_rng):
        j_calls.append(1)
        return jnp.asarray([LAYER_SEEDS[(len(j_calls) - 1) % 2]], jnp.int32)

    def port_seed(_gen):
        t_calls.append(1)
        return torch.tensor([LAYER_SEEDS[(len(t_calls) - 1) % 2]],
                            dtype=torch.int32)

    flash = jax_flash.flash_attention
    monkeypatch.setattr(jax_attention, "_dropout_seed", jax_seed)
    monkeypatch.setattr(jax_flash, "flash_attention",
                        lambda *a, **kw: flash(*a, interpret=True, **kw))
    monkeypatch.setattr(port_encoder, "dropout_seed", port_seed)
    return j_calls, t_calls


def _jax_apply(jmodel, params, inputs, train=False):
    kw = dict(deterministic=not train)
    if train:
        kw["rngs"] = {"dropout": jax.random.key(0)}
    return jmodel.apply({"params": params}, **inputs, **kw)


def test_packed_forward_matches_jax_eval():
    jmodel, params, model = _models()
    _, inputs, _ = _packed(rows=4, seed=1)
    assert (inputs["position_ids"].max() > 0
            and inputs["segment_ids"].max() > 1)
    ref = _jax_apply(jmodel, params, inputs)
    with torch.inference_mode():
        out = model.eval()(**_port_inputs(inputs))
    for key in QA_OUTPUT_KEYS:
        assert out[key].shape == tuple(np.shape(ref[key])), key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=F32_ATOL, rtol=0, err_msg=key)
    assert out["start_class"].shape == (4, S, L)
    # segment s's logits keep its tokens only
    seg = torch.from_numpy(inputs["segment_ids"])
    own = seg[:, None, :] == torch.arange(1, S + 1)[None, :, None]
    assert (out["start_class"][~own] < -1e8).all()
    assert (out["start_class"][own] > -1e8).all()


def test_packed_forward_with_attention_dropout_matches_pallas(seeded_dropout):
    cfg = dict(CFG, attention_probs_dropout_prob=0.1)
    _, params, model = _models(cfg)
    jmodel = JaxQAModel(JaxEncoderConfig(**cfg), attention_impl="pallas")
    _, inputs, _ = _packed(rows=2, seed=2)
    ref = _jax_apply(jmodel, params, inputs, train=True)
    out = model.train()(**_port_inputs(inputs),
                        generator=torch.Generator().manual_seed(0))
    j_calls, t_calls = seeded_dropout
    assert len(j_calls) == len(t_calls) == cfg["num_layers"]
    for key in QA_OUTPUT_KEYS:
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), atol=F32_ATOL,
                                   rtol=0, err_msg=key)
    # the dropout acted: eval mode gives other logits
    with torch.inference_mode():
        ev = model.eval()(**_port_inputs(inputs))
    assert not torch.allclose(ev["cls"], out["cls"].detach(), atol=1e-3)


def test_single_segment_row_equals_unpacked_forward():
    _, _, model = _models()
    item = _items(1, seed=5, lo=30, hi=30)[0]
    inputs, _ = collate_packed([[item]], _tok(), max_seq_len=L,
                               max_segments=S, with_labels=False)
    n = len(item.input_ids)
    ids = np.zeros((1, L), np.int64)
    ids[0, :n] = item.input_ids
    mask = (np.arange(L) < n).astype(np.int32)[None]
    sep = item.input_ids.index(3)
    tt = ((np.arange(L) > sep) & (np.arange(L) < n)).astype(np.int64)[None]
    assert np.array_equal(tt, inputs["token_type_ids"])
    model.eval()
    with torch.inference_mode():
        packed = model(**_port_inputs(inputs))
        plain = model(torch.from_numpy(ids), torch.from_numpy(mask),
                      torch.from_numpy(tt))
    for key in ("start_class", "end_class"):
        np.testing.assert_allclose(packed[key][:, 0, :n].numpy(),
                                   plain[key][:, :n].numpy(), atol=1e-6)
    for key in ("start_reg", "end_reg", "cls"):
        np.testing.assert_allclose(packed[key][:, 0].numpy(),
                                   plain[key].numpy(), atol=1e-6)


def test_packed_call_needs_segment_ids_and_positions():
    _, _, model = _models()
    _, inputs, _ = _packed(rows=1)
    kw = _port_inputs(inputs)
    del kw["position_ids"]
    with pytest.raises(ValueError, match="segment_ids AND position_ids"):
        model.eval()(**kw)


def _tp(kind, **kw):
    base = dict(loss=kind, smooth_alpha=0.01, focal_alpha=1.0,
                focal_gamma=2.0, w_start=1, w_end=1, w_start_reg=0.5,
                w_end_reg=0.5, w_cls=1)
    base.update(kw)
    return SimpleNamespace(**base)


def _loss_case(seed=3):
    """Per-segment predictions of a packed batch with absent segments and
    two pad rows."""
    _, _, labels = _packed(rows=3, seed=seed, pad_rows=2)
    rng = np.random.default_rng(seed)
    R = labels["cls"].shape[0]
    preds = {
        "start_class": rng.normal(size=(R, S, L)).astype(np.float32) * 3,
        "end_class": rng.normal(size=(R, S, L)).astype(np.float32) * 3,
        "start_reg": rng.random((R, S)).astype(np.float32),
        "end_reg": rng.random((R, S)).astype(np.float32),
        "cls": rng.normal(size=(R, S, 5)).astype(np.float32) * 2,
    }
    assert 0 < labels["segment_mask"].sum() < R * S
    return preds, labels


@pytest.mark.parametrize("kind,kw", [
    ("ce", {}), ("ce", {"label_weights": [1.0, 2.0, 0.5, 3.0, 1.5]}),
    ("focal", {}), ("smooth", {}), ("smooth", {"smooth_alpha": 0.0})],
    ids=["ce", "ce-weighted", "focal", "smooth", "smooth-0"])
def test_packed_loss_matches_jax(kind, kw):
    weights = kw.pop("label_weights", None)
    tp = _tp(kind, **kw)
    tw = None if weights is None else {"label_weights": weights}
    preds, labels = _loss_case()
    jloss = JaxPackedLoss(jax_build_loss(tp, tw))
    jl = {k: jnp.asarray(v) for k, v in labels.items()}
    jp = {k: jnp.asarray(v) for k, v in preds.items()}
    j_total, j_values = jloss(jp, jl)
    j_grads = jax.grad(lambda p: jloss(p, jl)[0])(jp)

    tloss = PackedWeightedLoss(build_loss(tp, tw))
    tp_ = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    tl = {k: torch.from_numpy(v) for k, v in labels.items()}
    t_total, t_values = tloss(tp_, tl)
    t_total.backward()
    assert set(t_values) == set(j_values)
    for key in j_values:
        np.testing.assert_allclose(t_values[key].item(),
                                   float(j_values[key]), atol=LOSS_ATOL,
                                   err_msg=key)
    for key in preds:
        np.testing.assert_allclose(tp_[key].grad.numpy(),
                                   np.asarray(j_grads[key]),
                                   atol=LOSS_ATOL, err_msg=key)
    # absent segments and pad rows take no gradient
    dead = labels["segment_mask"] == 0
    assert (tp_["cls"].grad.numpy()[dead] == 0).all()
    # the summed global denominators give back the same loss
    dens = tloss.denominators(tl)
    again, _ = tloss(tp_, tl, dens)
    np.testing.assert_allclose(again.item(), t_total.item(), rtol=1e-6)


def test_packed_micro_batch_gradients_match_jax_grad(seeded_dropout):
    cfg = dict(CFG, attention_probs_dropout_prob=0.1)
    _, params, model = _models(cfg, seed=4)
    jmodel = JaxQAModel(JaxEncoderConfig(**cfg), attention_impl="pallas")
    _, inputs, labels = _packed(rows=2, seed=4)
    tp = _tp("smooth")
    jloss = JaxPackedLoss(jax_build_loss(tp))
    jl = {k: jnp.asarray(v) for k, v in labels.items()}

    def objective(p):
        return jloss(_jax_apply(jmodel, p, inputs, train=True), jl)[0]

    j_val, j_grads = jax.value_and_grad(objective)(params)
    model.train()
    preds = model(**_port_inputs(inputs),
                  generator=torch.Generator().manual_seed(0))
    total, _ = PackedWeightedLoss(build_loss(tp))(
        preds, {k: torch.from_numpy(v) for k, v in labels.items()})
    total.backward()
    np.testing.assert_allclose(total.item(), float(j_val), atol=LOSS_ATOL)
    t_grads = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads))
    checked = 0
    for name, p in model.named_parameters():
        want = t_grads[name].numpy()
        got = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=name)
        checked += bool(np.abs(want).max() > 0)
    assert checked > len(t_grads) // 2
