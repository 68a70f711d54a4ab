"""The port's data-parallel step against the JAX package's, on the CPU.

Two gloo processes of the port's tiny trainer (``tests/torch_ddp_worker.py``
mode ``trainer_nodrop``) and two ``jax.distributed`` processes of the JAX
package's ``Trainer`` (``tests/jax_ddp_worker.py``) start from the same
weights and take the same 2 steps on the same items: each process collates
its rows of every global batch through its package's sampler (weighted,
shuffled), and the JAX package forms global micro-batch g from the
processes' local micro-batches g (``make_global_array(..., batch_axis=1)``)
and takes every loss's denominator over it (weighted CE over no-answer
spans). The port must give the same step losses and end parameters.

Dropout is 0 on both sides: flax's dropout stream cannot be reproduced.
``tests/test_torch_ddp.py`` holds the port's step with dropout to the
one-process step on the regrouped batch.

Tolerances: both sides compute in f32, in other summation orders (flax's
and the port's products, the micro-batch sums, the all-reduce), so step
losses agree to ``rtol=1e-5``; end parameters to ``atol=2e-6`` after two
Adam steps at lr 1e-3, as in ``tests/test_torch_ddp.py`` (a gradient that
is rounding noise on both sides, e.g. the attention key bias's, moves its
parameter by up to ~lr * 1e-3 per step).
"""

import json
import sys

import numpy as np
import pytest
import torch

import jax
from flax import serialization

import torch_ddp_worker as worker
from helpers import write_vocab
from ml_recipe_tpu_torch.models import to_jax_params
from ml_recipe_tpu_torch.tokenizer import Tokenizer

RTOL, PARAM_ATOL = 1e-5, 2e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_jax")
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    jax_dir.mkdir()
    (port_dir / "trainer_nodrop").mkdir(parents=True)
    tok = Tokenizer("bert", str(write_vocab(jax_dir)), lowercase=True)
    init = to_jax_params(worker.tiny_model(len(tok), dropout=0.0).state_dict())
    (jax_dir / "init.msgpack").write_bytes(
        serialization.msgpack_serialize(init))
    jax_argv = lambda rank, port: [   # noqa: E731
        sys.executable, str(worker.REPO / "tests" / "jax_ddp_worker.py"),
        str(rank), str(port), str(jax_dir)]
    port_argv = lambda rank, port: [   # noqa: E731
        sys.executable, str(worker.REPO / "tests" / "torch_ddp_worker.py"),
        "trainer_nodrop", str(rank), "2", str(port),
        str(port_dir / "trainer_nodrop"), "cpu"]
    # one CPU device per JAX process, as the two-process world has
    for results in worker.run_pairs(jax_argv, port_argv,
                                    drop_env=("XLA_FLAGS",)):
        for rc, err in results:
            assert rc == 0, err[-3000:]
    with open(jax_dir / "jax_params.msgpack", "rb") as fh:
        jax_params = serialization.msgpack_restore(fh.read())
    return dict(
        init=init, jax_steps=json.loads((jax_dir / "jax_steps.json").read_text()),
        jax_params=jax_params,
        port=[torch.load(port_dir / "trainer_nodrop" / f"rank{r}.pt")
              for r in range(2)])


def test_two_process_steps_equal_the_jax_two_process_trainer(runs):
    want, port = runs["jax_steps"], runs["port"]
    assert len(want) == len(port[0]["values"]) == 2
    for step, (got, ref) in enumerate(zip(port[0]["values"], want)):
        assert got == port[1]["values"][step]
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    assert want[1]["lr"] > 0
    got = to_jax_params(port[0]["params"])
    paths = jax.tree_util.tree_leaves_with_path
    assert [p for p, _ in paths(got)] == [p for p, _ in paths(
        runs["jax_params"])]
    moved = 0
    for (path, a), (_, b), (_, c) in zip(paths(got), paths(
            runs["jax_params"]), paths(runs["init"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=PARAM_ATOL,
                                   err_msg=str(path))
        moved += not np.array_equal(b, c)
    assert moved > len(paths(got)) // 2
