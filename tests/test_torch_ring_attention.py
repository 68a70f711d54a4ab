"""The port's ring attention (``ml_recipe_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``ring_attention``, on the CPU.

The port's ranks are gloo processes (``tests/torch_ddp_worker.py`` mode
``ring``) on the meshes ``seq:2`` and ``seq:4``, each holding its block of
the same numpy inputs; every hop runs the kernel pair's plain versions.
The JAX side runs in this process on the conftest's virtual CPU devices,
under ``jax.jit`` (its dense inner without segments; with segment ids its
composed streaming inner, in interpret mode, at the shortest length that
has a streaming geometry: 512 over ``seq:2``). Cases: a key mask at rate 0
and 0.3, packed segment ids (with padding) at rate 0.3, and a probe whose
output is the keep-mask itself (q = k = 0, v = the identity), which must
be bit-identical. The same outputs equal the port's one call over the
whole sequence (``fused_attention``, plain).

Tolerances: everything is f32 in other summation orders (per-hop merges,
the f32 dq/dk/dv sums over hops), so values and gradients agree to
``ATOL = 2e-5`` (the JAX package's own composed-vs-dense pins use 5e-5).
Each group of processes has :data:`torch_ddp_worker.PAIR_DEADLINE_S`.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ddp_worker as worker
from ml_recipe_tpu.ops.ring_attention import _stream_row_seeds as jax_row_seeds
from ml_recipe_tpu.ops.ring_attention import ring_attention as jax_ring
from ml_recipe_tpu.parallel import build_mesh
from ml_recipe_tpu_torch.ops.flash_attention import NEG_INF, fused_attention
from ml_recipe_tpu_torch.ops.ring_attention import _merge_hop, _stream_row_seeds

ATOL = 2e-5
SEED = 42
B, L, H, D = 2, 64, 2, 16
L_SEG = 512


def _cases():
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    mask = np.ones((B, L), np.int32)
    mask[0, -20:] = 0          # padding across the block edge at seq:4
    seg_mask = np.ones((1, L_SEG), np.int32)
    seg_mask[0, -40:] = 0
    seg = (np.sort(rng.integers(1, 4, size=(1, L_SEG)), axis=1)
           .astype(np.int32) * seg_mask)
    eye = np.broadcast_to(np.eye(32, dtype=np.float32)[None, :, None, :],
                          (1, 32, 1, 32)).copy()
    zeros = np.zeros((1, 32, 1, 32), np.float32)
    dense = dict(q=normal(B, L, H, D), k=normal(B, L, H, D),
                 v=normal(B, L, H, D), g=normal(B, L, H, D), mask=mask,
                 seg=None)
    return [
        dict(dense, rate=0.0),
        dict(dense, rate=0.3),
        dict(q=normal(1, L_SEG, H, D), k=normal(1, L_SEG, H, D),
             v=normal(1, L_SEG, H, D), g=normal(1, L_SEG, H, D),
             mask=seg_mask, seg=seg, rate=0.3),
        # the keep-mask probe: out[i, j] = keep_ij / (32 * (1 - rate))
        dict(q=zeros, k=zeros, v=eye, g=eye, mask=np.ones((1, 32), np.int32),
             seg=None, rate=0.3),
    ]


def _jax_run(case, n_shards):
    """(out, dq, dk, dv) of the JAX package's ring at ``seq:n_shards``."""
    mesh = build_mesh(f"seq:{n_shards}")
    seg = case["seg"]
    kw = dict(mesh=mesh, axis_name="seq", rate=case["rate"],
              seed=jnp.array([SEED], jnp.int32),
              inner="auto" if seg is not None else "dense",
              segment_ids=None if seg is None else jnp.asarray(seg))
    mask, g = jnp.asarray(case["mask"]), jnp.asarray(case["g"])

    def loss(q, k, v):
        out = jax_ring(q, k, v, mask, **kw)
        return (out * g).sum(), out

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    (_, out), grads = step(*(jnp.asarray(case[n]) for n in ("q", "k", "v")))
    return [np.asarray(x) for x in (out, *grads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    cases = _cases()
    as_torch = [{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                 for k, v in c.items()} for c in cases]
    for c in as_torch:
        c["seed"] = torch.tensor([SEED], dtype=torch.int32)
    port = {}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {}
        for S in (2, 4):
            (tmp / f"s{S}").mkdir()
            torch.save(as_torch, tmp / f"s{S}" / "inputs.pt")
            futures[S] = pool.submit(worker.worker_pairs, "ring",
                                     out=tmp / f"s{S}", ranks=S)
        jax_out = {S: [_jax_run(c, 2 if c["seg"] is not None else S)
                       for c in cases] for S in (2, 4)}
        for S, future in futures.items():
            for results in future.result():
                for rc, err in results:
                    assert rc == 0, err[-3000:]
            port[S] = [torch.load(tmp / f"s{S}" / "ring" / f"ring{r}.pt")
                       for r in range(S)]
    return dict(cases=cases, torch_cases=as_torch, jax=jax_out, port=port)


def _whole(port, i, key):
    """Case ``i``'s ``key`` of every rank, concatenated along the sequence."""
    return torch.cat([p["results"][i][key] for p in port], dim=1).numpy()


@pytest.mark.parametrize("S", [2, 4])
def test_ring_matches_the_jax_ring(runs, S):
    for i, case in enumerate(runs["cases"]):
        want = runs["jax"][S][i]
        valid = (case["mask"] > 0)[:, :, None, None]
        for key, ref in zip(("out", "dq", "dk", "dv"), want):
            got = _whole(runs["port"][S], i, key)
            if key == "out":   # rows masked everywhere: the JAX ring's own
                got, ref = got * valid, ref * valid
            np.testing.assert_allclose(got, ref, atol=ATOL,
                                       err_msg=f"seq:{S} case {i} {key}")


@pytest.mark.parametrize("S", [2, 4])
def test_ring_keep_masks_are_bit_identical_to_jax(runs, S):
    got = _whole(runs["port"][S], 3, "out")[0, :, 0]
    ref = runs["jax"][S][3][0][0, :, 0]
    keep = got != 0
    assert 0.5 < keep.mean() < 0.9
    assert np.array_equal(keep, ref != 0)


@pytest.mark.parametrize("S", [2, 4])
def test_ring_equals_one_call_over_the_whole_sequence(runs, S):
    for i, case in enumerate(runs["torch_cases"][:3]):
        q, k, v = (case[n].clone().requires_grad_() for n in ("q", "k", "v"))
        seg = case["seg"]
        out = fused_attention(q, k, v, case["mask"] if seg is None else seg,
                              seed=case["seed"], rate=case["rate"],
                              segmented=seg is not None)
        (out * case["g"]).sum().backward()
        valid = (case["mask"] > 0)[:, :, None, None].numpy()
        for key, ref in (("out", out.detach()), ("dq", q.grad),
                         ("dk", k.grad), ("dv", v.grad)):
            got, ref = _whole(runs["port"][S], i, key), ref.numpy()
            if key == "out":
                got, ref = got * valid, ref * valid
            np.testing.assert_allclose(got, ref, atol=ATOL,
                                       err_msg=f"seq:{S} case {i} {key}")


@pytest.mark.parametrize("S", [2, 4])
def test_ring_hops(runs, S):
    # per call: S - 1 forward hops, S - 1 backward hops and the homeward one
    for p in runs["port"][S]:
        assert p["hops"] == len(runs["cases"]) * (2 * S - 1)


def test_merge_hop_keeps_masked_rows_finite():
    o = torch.zeros(1, 2, 1, 1)
    lse = torch.full((1, 1, 2), NEG_INF)
    hop = torch.tensor([1.0, 2.0]).reshape(1, 2, 1, 1)
    # row 0 masked in the hop, row 1 a real score
    o, lse = _merge_hop(o, lse, hop, torch.tensor([[[NEG_INF, 0.5]]]))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert o[0, 1, 0, 0] == 2.0 and lse[0, 0, 1] == 0.5
    # a real hop after a masked one takes the row over
    o, lse = _merge_hop(o, lse, hop * 3, torch.tensor([[[0.0, NEG_INF]]]))
    assert o[0, 0, 0, 0] == 3.0 and o[0, 1, 0, 0] == 2.0


@pytest.mark.parametrize("dp", [1, 2, 3])
def test_stream_row_seeds_fold_the_data_index_as_jax(dp):
    seed = jnp.array([123456789], jnp.int32)
    rows = 4 * dp
    want = np.asarray(jax_row_seeds(seed, B=rows, H=12, dp_size=dp))
    got = torch.cat([_stream_row_seeds(torch.tensor([123456789]), B=4, H=12,
                                       data_index=r) for r in range(dp)])
    assert np.array_equal(got.numpy(), want)
