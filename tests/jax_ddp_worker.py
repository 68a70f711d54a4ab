"""One process of the JAX package's two-process ``Trainer`` on the CPU: the
reference that the port's data-parallel step is held to.

    JAX_PLATFORMS=cpu python tests/jax_ddp_worker.py RANK PORT OUT

Both processes join one ``jax.distributed`` world at ``127.0.0.1:PORT``
and train, over a ``data`` mesh of both processes' CPU devices, the tiny
trainer of ``tests/torch_ddp_worker.py`` with dropout 0: the same items,
sizes, class and sampler weights, ``batch_split``, clip and seed, from the
weights in ``OUT/init.msgpack`` (the port's seed-0 weights in the JAX
layout). Debug mode: 2 epochs of one step. Rank 0 writes
``OUT/jax_steps.json`` (each step's per-head and total losses and lr, as
the ``on_train_metrics`` tap reads them) and ``OUT/jax_params.msgpack``
(the trained parameters).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE.parent), str(_HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from flax import serialization  # noqa: E402

import torch_ddp_worker as tiny  # noqa: E402
from ml_recipe_tpu.data.collate import make_collate_fun  # noqa: E402
from ml_recipe_tpu.data.datasets import DatasetItem  # noqa: E402
from ml_recipe_tpu.losses import build_loss  # noqa: E402
from ml_recipe_tpu.models import EncoderConfig, QAModel  # noqa: E402
from ml_recipe_tpu.parallel import build_mesh, initialize_distributed  # noqa: E402
from ml_recipe_tpu.parallel.dist import process_count  # noqa: E402
from ml_recipe_tpu.parallel.sharding import gather_to_host  # noqa: E402
from ml_recipe_tpu.tokenizer import Tokenizer  # noqa: E402
from ml_recipe_tpu.train import Trainer  # noqa: E402


def main(argv) -> None:
    rank, port, out = int(argv[0]), int(argv[1]), Path(argv[2])
    initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank)
    assert process_count() == 2
    tok = Tokenizer("bert", str(out / "vocab.txt"), lowercase=True)
    with open(out / "init.msgpack", "rb") as fh:
        params = serialization.msgpack_restore(fh.read())
    mesh = build_mesh()
    cfg = EncoderConfig(vocab_size=len(tok), hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0, **tiny.TINY_MODEL)
    tp, weights = tiny.trainer_params(), tiny.train_weights()
    steps = []

    def tap(meters, step):
        steps.append({k: float(v) if k == "lr" else float(v())
                      for k, v in meters.items()})

    trainer = Trainer(
        model=QAModel(cfg, attention_impl="xla", mesh=mesh, ln_impl="fused"),
        params=params, loss=build_loss(tp, weights),
        collate_fun=make_collate_fun(tok, max_seq_len=tiny.MAX_SEQ_LEN),
        trainer_params=tp,
        train_dataset=tiny.VariedDataset(tok, tiny.N_TRAIN, seed=1,
                                         item=DatasetItem),
        mesh=mesh, train_batch_size=tiny.TRAIN_BATCH,
        batch_split=tiny.BATCH_SPLIT, n_jobs=1, warmup_coef=0.0,
        max_grad_norm=tiny.MAX_GRAD_NORM, train_weights=weights, debug=True,
        seed=0, hbm_preflight=False, on_train_metrics=tap)
    trainer.train()
    trained = jax.tree_util.tree_map(np.asarray, gather_to_host(trainer.params))
    if rank == 0:
        (out / "jax_steps.json").write_text(json.dumps(steps))
        (out / "jax_params.msgpack").write_bytes(
            serialization.msgpack_serialize(trained))


if __name__ == "__main__":
    main(sys.argv[1:])
