"""The port's QAModel, weight bridge and checkpoint reader against the JAX package.

The JAX ``QAModel(attention_impl='xla')`` is initialised from a seed, its
params cross the bridge (``from_jax_params``), and both models score the
same numpy batch. Hidden dropout is 0 and both run in eval mode, so the
comparison is deterministic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.train.checkpoint import load_state_dict as jax_load_state_dict
from ml_recipe_tpu.train.checkpoint import save_state_dict as jax_save_state_dict
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.models.qa_model import QA_OUTPUT_KEYS, init_weights
from ml_recipe_tpu_torch.train.checkpoint import (
    load_params,
    load_state_dict,
    read_state,
)
from ml_recipe_tpu_torch.utils.msgpack import unpackb

# tests/test_models.py's tiny HF-parity geometry
TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ROBERTA = dict(TINY, model_type="roberta", type_vocab_size=1, pad_token_id=1,
               position_offset=2, layer_norm_eps=1e-5,
               max_position_embeddings=66)

# f32: same math, different summation order in the matmuls and LayerNorm
# statistics (~1e-7 relative per op over 2 layers; measured <= 6e-7 on
# O(1) logits)
F32_ATOL = 1e-5
# bf16: both sides round activations to bf16 (8 significant bits, ~4e-3
# relative) after every op, but at different points (flax promotes some
# elementwise ops, torch computes LayerNorm and GELU internally in f32);
# over 2 layers the O(1) logits drift by a few bf16 ulps (measured
# <= 2.2e-2)
BF16_ATOL = 6e-2


def _batch(B=2, L=12, vocab=100, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 4:] = 0
    ids[1, L - 4:] = 0
    tt = np.zeros((B, L), np.int32)
    tt[:, L // 2:] = 1
    return ids, mask, tt


def _jax_model(cfg_kw, dtype=jnp.float32, seed=0):
    model = JaxQAModel(JaxEncoderConfig(**cfg_kw), dtype=dtype,
                       attention_impl="xla")
    params = model.init(jax.random.key(seed),
                        np.zeros((1, 8), np.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(cfg_kw, params, dtype=torch.float32):
    model = QAModel(EncoderConfig(**cfg_kw), dtype=dtype, device="cpu")
    model.load_state_dict(from_jax_params(params), strict=True)
    return model.eval()


def _compare(cfg_kw, jdtype, tdtype, atol):
    jmodel, params = _jax_model(cfg_kw, jdtype)
    ids, mask, tt = _batch(vocab=cfg_kw["vocab_size"])
    ref = jmodel.apply({"params": params}, ids, mask, tt, deterministic=True)
    model = _port_model(cfg_kw, params, tdtype)
    with torch.inference_mode():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    torch.from_numpy(tt).long())
    assert set(out) == set(QA_OUTPUT_KEYS)
    for key in QA_OUTPUT_KEYS:
        got = out[key]
        assert got.dtype == torch.float32, key
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=0, err_msg=key)
    # the f32 pad penalty lands on exactly the padded positions
    assert (out["start_class"][1, -4:] < -1e8).all()
    assert (out["start_class"][0] > -1e8).all()


@pytest.mark.parametrize("cfg_kw", [TINY, ROBERTA], ids=["bert", "roberta"])
def test_qa_model_matches_jax_f32(cfg_kw):
    _compare(cfg_kw, jnp.float32, torch.float32, F32_ATOL)


@pytest.mark.parametrize("cfg_kw", [TINY, ROBERTA], ids=["bert", "roberta"])
def test_qa_model_matches_jax_bf16(cfg_kw):
    _compare(cfg_kw, jnp.bfloat16, torch.bfloat16, BF16_ATOL)


def test_roberta_ignores_token_types_and_offsets_positions():
    _, params = _jax_model(ROBERTA)
    model = _port_model(ROBERTA, params)
    ids, mask, tt = _batch()
    with torch.inference_mode():
        a = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                  torch.from_numpy(tt).long())
        b = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                  torch.zeros_like(torch.from_numpy(tt)).long())
    for key in QA_OUTPUT_KEYS:
        assert torch.equal(a[key], b[key])
    assert model.transformer.embeddings.token_type_embeddings.weight.shape[0] == 1
    # positions 0..L-1 read table rows 2..L+1: the table must hold L+2 rows
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros((1, 65), dtype=torch.long))


def test_converter_round_trips():
    _, params = _jax_model(TINY)
    sd = from_jax_params(params)
    back = to_jax_params(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, b)
    # and from the port side: a seeded port init survives port -> JAX -> port
    model = QAModel(EncoderConfig(**TINY), device="cpu")
    init_weights(model, torch.Generator().manual_seed(3))
    sd = model.state_dict()
    again = from_jax_params(to_jax_params(sd))
    assert sd.keys() == again.keys()
    for key in sd:
        assert torch.equal(sd[key], again[key]), key


def test_kernel_transpose_matches_flax_dense():
    _, params = _jax_model(TINY)
    sd = from_jax_params(params)
    k = params["transformer"]["layer_0"]["attention"]["query"]["kernel"]
    assert np.array_equal(
        sd["transformer.layer_0.attention.query.weight"].numpy(), k.T)


def test_seeded_init_is_reproducible():
    def build(seed):
        m = QAModel(EncoderConfig(**TINY), device="cpu")
        init_weights(m, torch.Generator().manual_seed(seed))
        return m.state_dict()

    a, b, c = build(0), build(0), build(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["classifier.weight"], c["classifier.weight"])


def test_checkpoint_reader_matches_jax_reader(tmp_path):
    jmodel, params = _jax_model(TINY, seed=4)
    path = tmp_path / "last.ch"
    jax_save_state_dict(path, params=params, global_step=7)

    template = _jax_model(TINY, seed=9)[1]
    jax_params, _, _, step = jax_load_state_dict(path, params=template)
    port_params, port_step = load_params(path)
    assert step == port_step == 7
    jl = jax.tree_util.tree_leaves_with_path(jax_params)
    pl = jax.tree_util.tree_leaves_with_path(port_params)
    assert [p for p, _ in jl] == [p for p, _ in pl]
    for (_, a), (_, b) in zip(jl, pl):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)

    model = QAModel(EncoderConfig(**TINY), device="cpu")
    assert load_state_dict(model, path) == 7
    ids, mask, tt = _batch()
    ref = jmodel.apply({"params": params}, ids, mask, tt, deterministic=True)
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask), torch.from_numpy(tt).long())
    np.testing.assert_allclose(out["cls"].numpy(), np.asarray(ref["cls"]),
                               atol=F32_ATOL)


def test_checkpoint_reader_refuses_sharded_dirs_and_skips_missing(tmp_path):
    with pytest.raises(NotImplementedError, match="sharded"):
        read_state(tmp_path)
    model = QAModel(EncoderConfig(**TINY), device="cpu")
    assert load_state_dict(model, tmp_path / "missing.ch") is None


def test_msgpack_decoder_matches_flax():
    from flax import serialization

    import ml_dtypes

    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "bf16": np.array([1.5, -2.0, 3.25], dtype=ml_dtypes.bfloat16),
        "i32": np.array([[-(2 ** 31), 2 ** 31 - 1]], np.int32),
        "scalar": np.float32(2.5),
        "nested": {"none": None, "flag": True, "s": "x" * 40,
                   "ints": [0, -1, 127, 128, -33, 70000, -(2 ** 40), 2 ** 63 - 1],
                   "float": 0.25, "bytes": b"\x00" * 300},
    }
    blob = serialization.msgpack_serialize(tree)
    out = unpackb(blob)
    ref = serialization.msgpack_restore(blob)
    assert np.array_equal(out["f32"], ref["f32"])
    assert out["bf16"].dtype == np.float32
    assert np.array_equal(out["bf16"], ref["bf16"].astype(np.float32))
    assert np.array_equal(out["i32"], ref["i32"])
    assert out["scalar"] == ref["scalar"]
    assert out["nested"] == ref["nested"]


def test_msgpack_decoder_reassembles_chunked_arrays(monkeypatch):
    from flax import serialization

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    arr = np.arange(300, dtype=np.float32).reshape(10, 30)
    blob = serialization.msgpack_serialize({"w": arr})
    assert b"__msgpack_chunked_array__" in blob
    assert np.array_equal(unpackb(blob)["w"], arr)
