"""The bucketed ZeRO-1 exchange (``--zero1_overlap bucketed``) in the port
against its ``off`` step and against the JAX package's bucketed ZeRO-1
``Trainer``, on the CPU.

The port's pairs are gloo processes of ``tests/torch_ddp_worker.py``:

- ``zero1_bucketed``: ``zero1`` (the tiny trainer on ``data:2`` at
  ``batch_split`` 1, dropout 0, every leaf planned) with buckets of
  ``BUCKET_MB`` 0.001 (33 buckets of one to a few leaves), against the
  ``zero1`` pair (``zero1_overlap`` off) and against the JAX ``Trainer`` on
  the mesh ``data:2`` with ``zero1_overlap='bucketed'`` and the same
  bucket size (as the JAX package's ``test_dp_equivalence.py`` runs it);
- ``zero1_bucketed_options``: ``batch_split`` 2 (the exchange is armed for
  the last micro-batch only), dropout 0.1, adamod and dynamic loss
  scaling under ZeRO-1, bucketed, against the replicated
  ``trainer_options`` pair.

The pins are ``tests/test_torch_zero1.py``'s: step values ``rtol=2e-5``,
parameters ``atol=5e-5``. ``off`` keeps the monolithic exchange: no
buckets, and its parameters ``torch.equal`` to the replicated step's, as
before the bucketed path existed. The bucket plan equals the JAX package's
(count and leaves) on bert-tiny's and bert-base's shapes at several bucket
sizes, and the inert cases are logged.
"""

import concurrent.futures
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import torch_ddp_worker as worker
from ml_recipe_tpu.parallel.sharding import zero1_bucket_plan as jax_bucket_plan
from ml_recipe_tpu_torch.models import QAModel
from ml_recipe_tpu_torch.models.config import MODEL_PRESETS
from ml_recipe_tpu_torch.models.convert import jax_path
from ml_recipe_tpu_torch.parallel.sharding import (
    flax_shape,
    tree_order,
    zero1_bucket_plan,
)
from ml_recipe_tpu_torch.train.trainer import Trainer
from test_torch_zero1 import PARAMS_ATOL, RTOL, _jax_zero1_trainer

MODES = ("zero1_bucketed", "zero1", "zero1_off", "zero1_bucketed_options",
         "trainer_options")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero1_overlap")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        pairs = pool.submit(worker.worker_pairs, *MODES, out=tmp)
        steps = []
        _, jt = _jax_zero1_trainer(tmp, steps, zero1_overlap="bucketed",
                                   zero1_bucket_mb=worker.BUCKET_MB)
        jt.train()
        jax_params = jax.tree_util.tree_map(np.asarray, jt.params)
        for pair in pairs.result():
            for rc, err in pair:
                assert rc == 0, err[-3000:]
    records = {mode: [torch.load(tmp / mode / f"rank{r}.pt")
                      for r in range(2)] for mode in MODES}
    buckets = {mode: [torch.load(tmp / mode / f"buckets{r}.pt")
                      for r in range(2)]
               for mode in ("zero1_bucketed", "zero1_bucketed_options")}
    zero = [torch.load(tmp / "zero1" / f"zero{r}.pt", weights_only=False)
            for r in range(2)]
    return dict(records=records, buckets=buckets, zero=zero, steps=steps,
                jax_params=jax_params, jax_buckets=jt.zero1_bucket_count)


def _assert_close_runs(got, want, exact=False):
    assert len(got["values"]) == len(want["values"]) == 2
    for step, (g, w) in enumerate(zip(got["values"], want["values"])):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    for name, p in want["params"].items():
        if exact:
            assert torch.equal(got["params"][name], p), name
        else:
            np.testing.assert_allclose(got["params"][name], p,
                                       atol=PARAMS_ATOL, err_msg=name)


@pytest.mark.parametrize("mode,off", [
    ("zero1_bucketed", "zero1"), ("zero1_bucketed_options", "trainer_options")])
def test_bucketed_equals_off(runs, mode, off):
    got, want = runs["records"][mode], runs["records"][off]
    for r in range(2):
        _assert_close_runs(got[r], want[r])
        # every rank updates the same whole parameters
        _assert_close_runs(got[r], got[0], exact=True)
    for r in range(2):
        info = runs["buckets"][mode][r]
        assert info["buckets"] == 33
        assert [s["early"] + s["late"] for s in info["stats"]] == [33, 33]
    # the options run's scale stayed finite, agreed over the two ranks
    if mode == "zero1_bucketed_options":
        assert [v["grads_finite"] for v in got[0]["values"]] == [1.0, 1.0]


def test_bucketed_equals_the_jax_bucketed_trainer(runs):
    want = runs["steps"]
    got = runs["records"]["zero1_bucketed"][0]["values"]
    assert len(want) == len(got) == 2
    for step, (g, w) in enumerate(zip(got, want)):
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=f"step {step} {key}")
    from ml_recipe_tpu_torch.models import to_jax_params

    params = to_jax_params(runs["records"]["zero1_bucketed"][0]["params"])
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_leaves_with_path(params),
            jax.tree_util.tree_leaves_with_path(runs["jax_params"])):
        np.testing.assert_allclose(x, y, atol=PARAMS_ATOL, err_msg=str(path))
    assert runs["jax_buckets"] == runs["buckets"]["zero1_bucketed"][0][
        "buckets"]


def test_off_keeps_the_monolithic_exchange(runs):
    z, off = runs["records"]["zero1"], runs["records"]["zero1_off"]
    for r in range(2):
        assert runs["zero"][r]["buckets"] == 0
        assert not runs["zero"][r]["exchange"]
        assert z[r]["values"] == off[r]["values"]
        _assert_close_runs(z[r], off[r], exact=True)


def _named_shapes(preset):
    model = QAModel(MODEL_PRESETS[preset], device="meta")
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _jax_shape_tree(named_shapes):
    tree = {}
    for name, shape in named_shapes:
        *path, leaf = jax_path(name)
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jax.ShapeDtypeStruct(flax_shape(name, shape), np.float32)
    return tree


@pytest.mark.parametrize("preset", ["bert-tiny", "bert-base-uncased"])
@pytest.mark.parametrize("bucket_mb", [0.001, 0.25, 4.0, 25.0])
def test_bucket_plan_equals_jax(preset, bucket_mb):
    named = _named_shapes(preset)
    tree = _jax_shape_tree(named)
    want = jax_bucket_plan(tree, bucket_mb=bucket_mb)
    got = zero1_bucket_plan(named, bucket_mb=bucket_mb)
    assert [tuple(b) for b in got] == [tuple(b) for b in want]
    # the same leaves, in the same order, in both packages
    jax_leaves = [tuple(k.key for k in path) for path, _ in
                  jax.tree_util.tree_leaves_with_path(tree)]
    assert [jax_path(n) for n in tree_order(dict(named))] == jax_leaves
    assert sum(b.size for b in got) == sum(int(np.prod(s)) for _, s in named)


@pytest.mark.parametrize("why,zero,seq", [
    ("without an active zero1 layout", None, 1),
    ("on a seq mesh", object(), 2)])
def test_inert_cases_are_logged(caplog, why, zero, seq):
    trainer = SimpleNamespace(
        zero1_overlap="bucketed", seq_size=seq,
        optimizer=SimpleNamespace(zero=zero))
    with caplog.at_level(logging.INFO):
        assert Trainer._build_exchange(trainer, model=None) == []
    assert f"zero1_overlap=bucketed {why}" in caplog.text
    assert "bucketing is inert" in caplog.text or "unchanged" in caplog.text
