"""The port's LayerNorm pair against the JAX package's TPU kernels, on the CPU.

The same numpy inputs go through the JAX ``layer_norm(impl='interpret')``
(the Pallas kernels ``_ln_fwd_kernel``/``_ln_bwd_kernel`` in interpret
mode, as tests/test_layer_norm.py runs them) and the port's plain versions,
which are what the CUDA kernels are held against on the card:

- forward, f32 and bf16 activations, at three (N, C), one of them two row
  blocks of the interpret geometry;
- backward: ``torch.autograd`` through ``FusedLayerNormFn`` against
  ``jax.vjp`` of the interpret-mode op (dh, dgamma, dbeta), the two-block N
  included (the TPU kernel's cross-block dgamma/dbeta accumulation);
- the whole model with ``ln_impl='fused'`` against the JAX ``QAModel`` with
  ``ln_impl='fused'`` (off the TPU that is ``_xla_layer_norm``, the same
  function), f32 and bf16, forward and gradients; remat with the fused
  LayerNorm;
- dispatch: 'xla' and 'auto' on a CPU tensor run the plain version, the
  CUDA wrappers refuse CPU tensors, an unknown impl raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ml_recipe_tpu.models import EncoderConfig as JaxEncoderConfig
from ml_recipe_tpu.models import QAModel as JaxQAModel
from ml_recipe_tpu.ops.layer_norm import _rows_block
from ml_recipe_tpu.ops.layer_norm import layer_norm as jax_layer_norm
from ml_recipe_tpu_torch.models import (
    EncoderConfig,
    QAModel,
    from_jax_params,
    init_weights,
)
from ml_recipe_tpu_torch.models.encoder import FusedLayerNorm, LayerNorm
from ml_recipe_tpu_torch.models.qa_model import QA_OUTPUT_KEYS
from ml_recipe_tpu_torch.ops import layer_norm as ln

EPS = 1e-12
# f32: the same formula, statistics summed in another order (~1e-7 of the
# row's scale); held at 1e-6 of max(|ref|, 1) per element
F32_RTOL = 1e-6
# backward, f32: dh's (g*gamma - m1 - xhat*m2) cancels on near-zero
# elements, so reordered sums show at ~1e-7 of the row scale, not of the
# element (tests/test_layer_norm.py's _close); held at 1e-5 of max|ref|
BWD_ATOL_REL = 1e-5
# (N, C): one block at C = 32 and 768, and N = 1040 = 2 blocks of 520 rows
SHAPES = [(16, 32), (24, 768), (1040, 32)]
# the row counts of chip_smoke.py's LN_RAGGED (the CUDA backward's ragged
# grids) that interpret mode takes, N a multiple of 8: part of a block of
# the CUDA kernel's grid, and four passes of it and 64 rows (28 interpret
# blocks of 304 rows)
BWD_TILING_SHAPES = [(40, 768), (8512, 768)]
TINY = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the model tolerances of tests/test_torch_model.py
F32_ATOL, BF16_ATOL = 1e-5, 6e-2


def _inputs(N, C, seed=0):
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal((N, C)) * 2 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(C) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(C) * 0.1).astype(np.float32)
    g = rng.standard_normal((N, C)).astype(np.float32)
    return h, gamma, beta, g


def _bf16_step(x):
    """bf16 spacing (8 significant bits) at each element's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_multi_block_shape_takes_two_interpret_blocks():
    assert _rows_block(1040, 32, 4) == 520
    assert _rows_block(24, 768, 4) == 24


@pytest.mark.parametrize("N,C", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_pallas_interpret(N, C, dtype):
    h, gamma, beta, _ = _inputs(N, C, seed=N + C)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = np.asarray(jax_layer_norm(
        jnp.asarray(h).astype(jdt), jnp.asarray(gamma), jnp.asarray(beta),
        eps=EPS, dtype=jdt, impl="interpret")).astype(np.float32)
    got = ln.layer_norm_plain(torch.from_numpy(h).to(tdt),
                              torch.from_numpy(gamma), torch.from_numpy(beta),
                              EPS, tdt)
    assert got.dtype == tdt and got.shape == (N, C)
    got = got.float().numpy()
    if dtype == "f32":
        tol = F32_RTOL * np.maximum(np.abs(ref), 1.0)
    else:  # at most one bf16 step at the element's magnitude
        tol = _bf16_step(ref)
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def _jax_vjp(h, gamma, beta, g, jdt):
    fn = lambda h, gm, b: jax_layer_norm(h, gm, b, eps=EPS, dtype=jdt,
                                         impl="interpret")
    _, vjp = jax.vjp(fn, jnp.asarray(h).astype(jdt), jnp.asarray(gamma),
                     jnp.asarray(beta))
    return [np.asarray(x).astype(np.float32)
            for x in vjp(jnp.asarray(g).astype(jdt))]


@pytest.mark.parametrize("N,C", SHAPES + BWD_TILING_SHAPES)
def test_backward_matches_pallas_interpret_vjp(N, C):
    h, gamma, beta, g = _inputs(N, C, seed=7 * N + C)
    ref = _jax_vjp(h, gamma, beta, g, jnp.float32)
    x = [torch.from_numpy(a).requires_grad_() for a in (h, gamma, beta)]
    y = ln.layer_norm(*x, eps=EPS, dtype=torch.float32, impl="fused")
    # the reshape back to h's shape over the Function's output
    assert "FusedLayerNormFn" in y.grad_fn.next_functions[0][0].name()
    got = torch.autograd.grad(y, x, torch.from_numpy(g))
    for name, a, b in zip(("dh", "dgamma", "dbeta"), got, ref):
        a = a.numpy()
        assert a.dtype == np.float32, name
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=BWD_ATOL_REL * np.abs(b).max(),
                                   err_msg=name)


def test_backward_bf16_matches_pallas_interpret_vjp():
    """bf16 activations: dh comes back in bf16 (one bf16 step at its size,
    on top of the f32 case's cancellation slack), dgamma/dbeta in f32."""
    N, C = 1040, 32
    h, gamma, beta, g = _inputs(N, C, seed=3)
    ref = _jax_vjp(h, gamma, beta, g, jnp.bfloat16)
    x = [torch.from_numpy(h).to(torch.bfloat16).requires_grad_(),
         torch.from_numpy(gamma).requires_grad_(),
         torch.from_numpy(beta).requires_grad_()]
    y = ln.layer_norm(*x, eps=EPS, dtype=torch.bfloat16, impl="fused")
    got = torch.autograd.grad(y, x, torch.from_numpy(g).to(torch.bfloat16))
    assert got[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    dh = got[0].float().numpy()
    tol = _bf16_step(ref[0]) + BWD_ATOL_REL * np.abs(ref[0]).max()
    assert (np.abs(dh - ref[0]) <= tol).all()
    for name, a, b in zip(("dgamma", "dbeta"), got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=BWD_ATOL_REL * np.abs(b).max(),
                                   err_msg=name)


def test_dispatch_routes_cpu_tensors_to_the_plain_version():
    h, gamma, beta, _ = _inputs(8, 32)
    h, gamma, beta = (torch.from_numpy(a) for a in (h, gamma, beta))
    ref = ln.layer_norm_plain(h, gamma, beta, EPS, torch.float32)
    for impl in ("xla", "fused", "auto"):
        got = ln.layer_norm(h.reshape(2, 4, 32), gamma, beta, eps=EPS,
                            impl=impl)
        assert got.shape == (2, 4, 32)
        assert torch.equal(got.reshape(8, 32), ref), impl
    # 'auto' routes as 'fused' whatever the dtype: a CPU tensor runs the
    # plain version, f16 included
    h16 = h.half()
    assert torch.equal(
        ln.layer_norm(h16, gamma, beta, eps=EPS, dtype=torch.float16,
                      impl="auto"),
        ln.layer_norm_plain(h16, gamma, beta, EPS, torch.float16))
    with pytest.raises(ValueError, match="impl"):
        ln.layer_norm(h, gamma, beta, impl="interpret")
    before = (ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches)
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_fwd_cuda(h, gamma, beta, EPS, torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ln.layer_norm_bwd_cuda(h, gamma, h, EPS)
    assert (ln.FWD_KERNEL.launches, ln.BWD_KERNEL.launches) == before


def _batch(B=2, L=12, vocab=100, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 4:] = 0
    tt = np.zeros((B, L), np.int32)
    tt[:, L // 2:] = 1
    return ids, mask, tt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_model_matches_jax_fused_model(dtype):
    jdt, tdt, atol = ((jnp.float32, torch.float32, F32_ATOL) if dtype == "f32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    jmodel = JaxQAModel(JaxEncoderConfig(**TINY), dtype=jdt,
                        attention_impl="xla", ln_impl="fused")
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(0), np.zeros((1, 8), np.int32))["params"])
    ids, mask, tt = _batch()
    ref = jmodel.apply({"params": params}, ids, mask, tt, deterministic=True)
    model = QAModel(EncoderConfig(**TINY), dtype=tdt, device="cpu",
                    ln_impl="fused")
    model.load_state_dict(from_jax_params(params), strict=True)
    lns = [m for m in model.modules() if isinstance(m, FusedLayerNorm)]
    assert len(lns) == 1 + 2 * TINY["num_layers"]
    assert not any(isinstance(m, LayerNorm) for m in model.modules())
    with torch.inference_mode():
        out = model.eval()(torch.from_numpy(ids).long(),
                           torch.from_numpy(mask),
                           torch.from_numpy(tt).long())
    for key in QA_OUTPUT_KEYS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=atol, rtol=0, err_msg=key)


def test_fused_model_gradients_match_jax():
    """f32 training-mode gradients (dropout 0) of every parameter, through
    FusedLayerNormFn, against jax.grad of the JAX fused model."""
    jmodel = JaxQAModel(JaxEncoderConfig(**TINY), attention_impl="xla",
                        ln_impl="fused")
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(1), np.zeros((1, 8), np.int32))["params"])
    ids, mask, tt = _batch(seed=2)

    def jloss(p):
        out = jmodel.apply({"params": p}, ids, mask, tt, deterministic=True)
        return sum(jnp.sum(jnp.sin(out[k]) * (i + 1))
                   for i, k in enumerate(QA_OUTPUT_KEYS))

    jgrad = from_jax_params(jax.tree_util.tree_map(
        np.asarray, jax.grad(jloss)(params)))
    model = QAModel(EncoderConfig(**TINY), device="cpu", ln_impl="fused")
    model.load_state_dict(from_jax_params(params), strict=True)
    out = model.train()(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                        torch.from_numpy(tt).long(),
                        generator=torch.Generator().manual_seed(0))
    sum(torch.sin(out[k]).sum() * (i + 1)
        for i, k in enumerate(QA_OUTPUT_KEYS)).backward()
    for name, p in model.named_parameters():
        ref = jgrad[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=name)


def test_remat_with_fused_layer_norm_keeps_gradients():
    """remat_layer replays the layer, FusedLayerNormFn included: the same
    gradients with remat on and off, dropout drawn from one generator."""
    cfg = dict(TINY, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids, mask, tt = (torch.from_numpy(x).long() for x in _batch(seed=4))
    grads = []
    for remat in (False, True):
        model = QAModel(EncoderConfig(**cfg), device="cpu", ln_impl="fused",
                        remat=remat)
        init_weights(model, torch.Generator().manual_seed(5))
        out = model.train()(ids, mask, tt,
                            generator=torch.Generator().manual_seed(6))
        sum(out[k][mask.bool()].sum() if k.endswith("class")
            else out[k].sum() for k in QA_OUTPUT_KEYS).backward()
        grads.append(torch.cat([p.grad.reshape(-1)
                                for p in model.parameters()]))
    assert (grads[0] - grads[1]).abs().max() <= 1e-6 * grads[1].abs().max()
