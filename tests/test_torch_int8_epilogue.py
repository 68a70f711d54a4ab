"""The int8 serving epilogues against the JAX package, on the CPU.

``ops.quant_matmul.int8_linear`` is ``QuantLinear``'s forward after the
quantize: one launch of ``csrc/q8_matmul.cu`` with the bias and the cast in
its epilogue on the card, and on a CPU tensor its plain version, which the
card's kernel is held against bit for bit. ``ops.layer_norm.layer_norm_q8``
is the LayerNorm forward that also writes the int8 row codes of its own
output. Checked here:

- ``int8_linear`` (plain) against the JAX ``QuantDense`` on the same numpy
  inputs, weight codes, scales and bias, bit for bit, f32 and bf16, at the
  widths of the int8 serving path (N = 1, 2, 5 heads, 768, 3072);
- ``layer_norm_q8`` (plain) against the JAX ``FusedLayerNorm`` (its Pallas
  kernel in interpret mode) followed by ``quantize_rowwise``: its codes
  and scales are ``quantize_rowwise`` of its own output, bit for bit, and
  that output is the JAX one within the LayerNorm tests' limits;
- the routing of a quantized model's forward: each distinct projection
  input is quantized once (Q/K/V share theirs, the classifier and the
  regressors theirs, the pooler takes the [CLS] rows of the last
  LayerNorm's codes), with either LayerNorm.

The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_recipe_tpu.models.encoder import FusedLayerNorm as JaxFusedLayerNorm
from ml_recipe_tpu.ops.quant_matmul import quantize_rowwise as jax_quantize_rowwise
from ml_recipe_tpu.quant.layers import QuantDense
from ml_recipe_tpu.quant.quantize import quantize_kernel as jax_quantize_kernel
from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
from ml_recipe_tpu_torch.ops import layer_norm as ln
from ml_recipe_tpu_torch.ops import quant_matmul as q8
from ml_recipe_tpu_torch.quant import quantize_model
from ml_recipe_tpu_torch.quant.layers import first_token, row_codes, with_row_codes

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EPS = 1e-12
# the port's plain LayerNorm against the JAX kernel in interpret mode:
# statistics summed in another order, ~1e-7 of the row's scale (the limit
# of tests/test_torch_layer_norm.py), plus one bf16 step for a bf16 output
F32_RTOL = 1e-6


def _bf16_step(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("K,N", [(768, 1), (768, 2), (768, 5), (768, 768),
                                 (768, 3072), (3072, 768)])
def test_int8_linear_matches_jax_quant_dense_bit_for_bit(K, N, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(K + N)
    M = 12
    x = (rng.standard_normal((2, M // 2, K)) * 3).astype(np.float32)
    x[0, 1] = 0.0                                  # an all-zero row
    wq, ws = jax_quantize_kernel(
        (rng.standard_normal((K, N)) * 0.05).astype(np.float32))
    bias = (rng.standard_normal(N) * 0.1).astype(np.float32)
    params = {"kernel_q": jnp.asarray(wq), "kernel_scale": jnp.asarray(ws),
              "bias": jnp.asarray(bias)}
    xj = jnp.asarray(x).astype(jdt)
    ref = QuantDense(features=N, dtype=jdt).apply({"params": params}, xj)

    xt = torch.from_numpy(x).to(tdt)
    x_q, x_scale = q8.quantize_rows(xt)
    got = q8.int8_linear(x_q, x_scale, torch.from_numpy(wq.T.copy()),
                         torch.from_numpy(ws), torch.from_numpy(bias), tdt)
    assert got.dtype == tdt and got.shape == (2, M // 2, N)
    assert np.array_equal(got.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))
    # the plain version is the f32 product, + bias, one cast
    f32 = q8.int8_matmul(x_q, x_scale, torch.from_numpy(wq.T.copy()),
                         torch.from_numpy(ws))
    assert torch.equal(got, (f32 + torch.from_numpy(bias)).to(tdt))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,C", [(16, 32), (24, 768)])
def test_layer_norm_codes_are_quantize_rowwise_of_their_own_output(N, C,
                                                                   dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(N * C)
    h = (rng.standard_normal((N, C)) * 2 + 0.5).astype(np.float32)
    h[3] = 0.25                         # a constant row: y = beta exactly
    gamma = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.1).astype(np.float32)
    module = JaxFusedLayerNorm(epsilon=EPS, dtype=jdt, impl="interpret")
    yj = module.apply({"params": {"scale": jnp.asarray(gamma),
                                  "bias": jnp.asarray(beta)}},
                      jnp.asarray(h).astype(jdt))
    qj, sj = jax_quantize_rowwise(yj)

    y, q, s = ln.layer_norm_q8(torch.from_numpy(h).to(tdt),
                               torch.from_numpy(gamma),
                               torch.from_numpy(beta), eps=EPS, dtype=tdt)
    assert y.dtype == tdt and q.dtype == torch.int8 and s.shape == (N, 1)
    want_q, want_s = q8.quantize_rowwise(y)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(y, ln.layer_norm(torch.from_numpy(h).to(tdt),
                                        torch.from_numpy(gamma),
                                        torch.from_numpy(beta), eps=EPS,
                                        dtype=tdt))
    yt = y.float().numpy()
    yr = np.asarray(yj.astype(jnp.float32))
    tol = F32_RTOL * np.maximum(np.abs(yr), 1.0)
    if dtype == "bf16":
        tol = tol + _bf16_step(yr)
    assert np.all(np.abs(yt - yr) <= tol)
    # where the two LayerNorms agree to the bit (most bf16 rows, the
    # constant row), so do the codes: the grid is a function of the row;
    # elsewhere y moved by the limit above, so a code by at most one step
    same = np.all(yt == yr, axis=-1)
    assert same[3] and (dtype == "f32" or same.sum() >= N // 2), same
    assert np.array_equal(q.numpy()[same], np.asarray(qj)[same])
    assert np.array_equal(s.numpy()[same], np.asarray(sj)[same])
    assert np.abs(q.numpy().astype(int) - np.asarray(qj).astype(int)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5, atol=0)


TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.mark.parametrize("ln_impl", ["fused", "xla"])
def test_int8_forward_quantizes_each_distinct_input_once(ln_impl,
                                                         monkeypatch):
    """On the CPU every quantize is a ``quantize_rowwise`` call: count them
    and the tensors they see over one int8 forward."""
    torch.manual_seed(0)
    fmodel = QAModel(EncoderConfig(**TINY), dtype=torch.float32,
                     device="cpu", ln_impl=ln_impl)
    qmodel, _ = quantize_model(fmodel.eval())
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(5, 100, (2, 12))).long()

    with torch.inference_mode():
        want = qmodel(ids)
    seen = []
    plain = q8.quantize_rowwise

    def counting(x, **kw):
        seen.append(tuple(x.shape))
        return plain(x, **kw)

    monkeypatch.setattr(q8, "quantize_rowwise", counting)
    with torch.inference_mode():
        got = qmodel(ids)
    layers = TINY["num_layers"]
    # the embeddings' LayerNorm, per layer the attention context, the
    # attention LayerNorm, the GELU output and the FFN LayerNorm, and the
    # pooled output: 6 projections a layer + the pooler + 4 heads read them.
    # A fused LayerNorm writes the codes of its output, and the pooler takes
    # the [CLS] rows of the last one's; with 'xla' the pooler quantizes
    # those rows itself, before the span head reads every row
    H, I = TINY["hidden_size"], TINY["intermediate_size"]
    cls_rows = ln_impl == "xla"
    assert len(seen) == 1 + 4 * layers + 1 + cls_rows, seen
    assert seen.count((2, 12, I)) == layers
    assert seen.count((2, H)) == 1 + cls_rows
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_row_codes_are_kept_on_the_tensor_and_its_first_token(monkeypatch):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    calls = []
    plain = q8.quantize_rowwise
    monkeypatch.setattr(q8, "quantize_rowwise",
                        lambda t, **kw: calls.append(1) or plain(t, **kw))
    a = row_codes(x)
    assert row_codes(x) is a and len(calls) == 1
    cls = first_token(x)
    q, s = row_codes(cls)
    want_q, want_s = plain(x[:, 0])
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert len(calls) == 1
    y = x + 0                 # a new tensor carries no codes
    row_codes(y)
    assert len(calls) == 2
    z = with_row_codes(torch.zeros(2, 4), *plain(torch.zeros(2, 4)))
    assert not row_codes(z)[0].any()
