"""The port's int8 serving path against the JAX package's, on the CPU.

Every check of the quantization grid and the int8 product is bit for bit
(``np.array_equal``), since both packages do integer arithmetic and the
same f32 roundings:

- ``quantize_rowwise`` codes and scales, f32 and bf16 activations;
- ``quantize_kernel``/``quantize_params`` over the same float tree (a
  seeded JAX ``QAModel`` init), the report included;
- ``int8_matmul_plain`` (the kernel's reference on the card) against the
  JAX ``int8_matmul``: its Pallas kernel in interpret mode wherever the TPU
  package runs that kernel (``supports_q8_kernel``), its XLA emulation at
  the ragged shapes it routes there (the QA heads, the pooler's few rows);
- the whole quantized model: the JAX ``QAModel(quantize='int8',
  ln_impl='fused')`` against the port's, through the bridge both ways, and
  the port's own conversion (``quantize_model``) giving the same tree;
- ``init_model(quantize='int8')`` quantizes the f32 master weights, before
  the serving cast.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.ops.quant_matmul import int8_matmul as jax_int8_matmul
from ml_recipe_tpu.ops.quant_matmul import quantize_rowwise as jax_quantize_rowwise
from ml_recipe_tpu.ops.quant_matmul import supports_q8_kernel
from ml_recipe_tpu.quant import quantize_model as jax_quantize_model
from ml_recipe_tpu.quant.quantize import param_bytes as jax_param_bytes
from ml_recipe_tpu.quant.quantize import quantize_kernel as jax_quantize_kernel
from ml_recipe_tpu.quant.quantize import quantize_params as jax_quantize_params
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    to_jax_params,
)
from ml_recipe_tpu_torch.models.qa_model import QA_OUTPUT_KEYS
from ml_recipe_tpu_torch.ops import quant_matmul as q8
from ml_recipe_tpu_torch.quant import (
    QuantLinear,
    param_bytes,
    quantize_kernel,
    quantize_model,
    quantize_params,
    weight_kernel_bytes,
)

TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the model tolerances of tests/test_torch_model.py
F32_ATOL, BF16_ATOL = 1e-5, 6e-2


def _tree_equal(a, b, path=""):
    assert set(a) == set(b), path
    for k in a:
        if isinstance(a[k], dict):
            _tree_equal(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_rowwise_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 40, 96)) * 3).astype(np.float32)
    x[0, 0] = 0.0                     # an all-zero row: the 1e-8 floor
    x[1, 2, :4] = [127.0, 63.5, -0.5, 1.5]   # exact halves: half to even
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jq, js = jax_quantize_rowwise(jnp.asarray(x).astype(jdt))
    q, s = q8.quantize_rowwise(torch.from_numpy(x).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == (3, 40, 1)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert not q[0, 0].any()


def _jax_tree(seed=0, **kw):
    model = JaxQAModel(JaxEncoderConfig(**TINY), attention_impl="xla", **kw)
    params = model.init(jax.random.key(seed), np.zeros((1, 8), np.int32))
    return model, jax.tree_util.tree_map(np.asarray, params["params"])


def test_quantize_params_matches_jax_bit_for_bit():
    _, params = _jax_tree()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 20)).astype(np.float32)
    w[:, 3] = 0.0                      # an all-zero column
    for a, b in zip(quantize_kernel(w), jax_quantize_kernel(w)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    qtree, report = quantize_params(params)
    jtree, jreport = jax_quantize_params(params)
    _tree_equal(qtree, jtree)
    assert report == jreport
    # 6 per layer, the pooler and the 4 heads
    assert report["n_quantized"] == 6 * TINY["num_layers"] + 5
    assert weight_kernel_bytes(qtree) * 4 == weight_kernel_bytes(params)
    assert param_bytes(qtree) == jax_param_bytes(jtree)


# (M, K, N): aligned shapes the TPU kernel takes, and the ragged ones it
# routes to its emulation: the heads (N = 2, 5, 1) and a pooler of 8 rows
SHAPES = [(64, 128, 256), (96, 256, 128), (64, 128, 2), (8, 128, 5),
          (40, 32, 1), (8, 64, 64)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_plain_matches_jax_bit_for_bit(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = (rng.standard_normal((M, K)) * 2).astype(np.float32)
    wq, ws = jax_quantize_kernel(rng.standard_normal((K, N)).astype(np.float32))
    jxq, jxs = jax_quantize_rowwise(jnp.asarray(x))
    kernel = supports_q8_kernel(M, K, N)
    assert kernel == (N >= 128 and M >= 32)
    ref = jax_int8_matmul(jxq, jxs, jnp.asarray(wq), jnp.asarray(ws),
                          impl="pallas" if kernel else "emulate",
                          interpret=kernel)
    xq, xs = q8.quantize_rowwise(torch.from_numpy(x))
    got = q8.int8_matmul(xq, xs, torch.from_numpy(wq.T.copy()),
                         torch.from_numpy(ws))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_int8_matmul_keeps_leading_dims_and_refuses_cpu_launch():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(np.float32))
    wq, ws = quantize_kernel(rng.standard_normal((64, 3)).astype(np.float32))
    w = torch.from_numpy(wq.T.copy())
    xq, xs = q8.quantize_rowwise(x)
    got = q8.int8_matmul(xq, xs, w, torch.from_numpy(ws))
    flat = q8.int8_matmul_plain(xq.reshape(10, 64), xs.reshape(10, 1), w,
                                torch.from_numpy(ws))
    assert got.shape == (2, 5, 3) and torch.equal(got.reshape(10, 3), flat)
    before = q8.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        q8.int8_matmul_cuda(xq, xs, w, torch.from_numpy(ws))
    assert q8.KERNEL.launches == before


def _batch(B=2, L=12, vocab=100, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 4:] = 0
    tt = np.zeros((B, L), np.int32)
    tt[:, L // 2:] = 1
    return ids, mask, tt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantized_fused_model_matches_jax(dtype):
    jdt, tdt, atol = ((jnp.float32, torch.float32, F32_ATOL) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    jmodel, params = _jax_tree(seed=3, ln_impl="fused")
    jmodel = jmodel.clone(dtype=jdt)
    jq, jqparams, jreport = jax_quantize_model(jmodel, params)
    ids, mask, tt = _batch()
    ref = jq.apply({"params": jqparams}, ids, mask, tt, deterministic=True)

    # the JAX int8 tree through the bridge into a quantized port model
    model = QAModel(EncoderConfig(**TINY), dtype=tdt, device="cpu",
                    ln_impl="fused", quantize="int8")
    model.load_state_dict(from_jax_params(jqparams), strict=True)
    quant = [m for m in model.modules() if isinstance(m, QuantLinear)]
    assert len(quant) == jreport["n_quantized"]
    assert not any(isinstance(p, torch.Tensor) and p.dtype == torch.int8
                   for p in model.parameters())
    # and back: the same tree, bit for bit, and the same bytes
    back = to_jax_params(model.state_dict())
    _tree_equal(back, jax.tree_util.tree_map(np.asarray, jqparams))
    assert param_bytes(back) == jax_param_bytes(jqparams)

    # the port's own conversion of the float model gives that model
    fmodel = QAModel(EncoderConfig(**TINY), dtype=tdt, device="cpu",
                     ln_impl="fused")
    fmodel.load_state_dict(from_jax_params(params), strict=True)
    qmodel, report = quantize_model(fmodel.eval())
    assert qmodel.quantize == "int8" and qmodel.ln_impl == "fused"
    assert not qmodel.training and report["n_quantized"] == len(quant)
    for (k, a), (_, b) in zip(qmodel.state_dict().items(),
                              model.state_dict().items()):
        assert torch.equal(a, b), k

    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask),
                           torch.from_numpy(tt).long())
    for key in QA_OUTPUT_KEYS:
        np.testing.assert_allclose(out[key].float().numpy(),
                                   np.asarray(ref[key]), atol=atol, rtol=0,
                                   err_msg=key)


def _int8_leaves(tree, path=""):
    """{path: leaf} of the kernel_q / kernel_scale leaves of a tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_int8_leaves(v, f"{path}/{k}"))
        elif k in ("kernel_q", "kernel_scale"):
            out[f"{path}/{k}"] = np.asarray(v)
    return out


def test_init_model_quantizes_the_f32_master_weights(tmp_path):
    """``init_model(quantize='int8')`` converts before the serving cast:
    its codes are those of the f32 weights, which the bf16-cast weights
    would not all give, and the embeddings are still cast for serving."""
    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.config.parser import get_model_parser
    from ml_recipe_tpu_torch.models.encoder import Embedding
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    vocab = write_synthetic_bert_vocab(tmp_path / "vocab.txt", size=200)
    params, _ = get_model_parser().parse_known_args(
        ["--model", "bert-tiny", "--vocab_file", vocab, "--ln_impl", "fused"])
    qmodel, _ = init_model(params, device="cpu", quantize="int8")
    fmodel, _ = init_model(params, device="cpu", train=True)
    assert qmodel.quantize == "int8" and not qmodel.training
    assert qmodel.ln_impl == "fused" and qmodel.dtype == torch.bfloat16
    f32_tree = to_jax_params(fmodel.state_dict())
    got, want = (_int8_leaves(t) for t in (
        to_jax_params(qmodel.state_dict()), quantize_params(f32_tree)[0]))
    assert got.keys() == want.keys() and len(got) == 2 * (6 * 2 + 5)
    assert all(np.array_equal(got[k], want[k]) for k in got)
    bf16_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)), f32_tree)
    f32_q = quantize_params(f32_tree)[0]["transformer"]["layer_0"]
    bf16_q = quantize_params(bf16_tree)[0]["transformer"]["layer_0"]
    assert not np.array_equal(f32_q["mlp"]["intermediate"]["kernel_scale"],
                              bf16_q["mlp"]["intermediate"]["kernel_scale"])
    for m in qmodel.modules():
        if isinstance(m, Embedding):
            assert m.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="serving"):
        init_model(params, device="cpu", train=True, quantize="int8")
    with pytest.raises(ValueError, match="quantization mode"):
        quantize_model(fmodel, "fp4")
