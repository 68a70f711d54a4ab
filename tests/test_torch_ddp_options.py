"""Data-parallel training with this slice's options, two gloo processes on
the CPU (``tests/torch_ddp_worker.py``, one CPU thread per process, a
deadline per pair).

- ``--optimizer adamod --apex_loss_scale dynamic``: each step's values,
  the first step's gradients where they reach the clip (unscaled), and the
  end parameters of the two processes equal the one-process step on the
  regrouped global batches at ``rtol=1e-5``; the replicas are
  ``torch.equal``;
- a planted overflow, an inf in rank 1's gradient alone before the
  all-reduce: BOTH ranks skip that step (the finite check reads the summed
  gradients), back the scale off to 2^14, keep their replicas equal and
  take the next step;
- ``--async_checkpoint --sharded_checkpoint`` at world size 2: the save is
  synchronous, logged once as such, and complete when it returns.
"""

import numpy as np
import pytest
import torch

import torch_ddp_worker as worker
from torch_ddp_worker import oracle, worker_pairs

RTOL, ATOL = 1e-5, 1e-7
# end parameters: AdaMod's first steps are bounded by its EMA to ~1e-3 of
# Adam's, so rounding noise in a near-zero gradient moves a parameter far
# less than the Adam tests' 2e-6
PARAM_ATOL = 2e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_options")
    modes = ("trainer_options", "trainer_overflow", "async_sharded")
    for results in worker_pairs(*modes, out=tmp):
        for rc, err in results:
            assert rc == 0, err[-3000:]
    return tmp, {mode: [torch.load(tmp / mode / f"rank{r}.pt")
                        for r in range(2)] for mode in modes}


def test_adamod_and_loss_scaling_equal_the_one_process_step(runs):
    tmp, records = runs
    record = records["trainer_options"]
    ref = oracle(tmp, record, options=worker.OPTIONS)
    assert len(ref.values) == len(record[0]["values"]) == 2
    for step, (got, want) in enumerate(zip(record[0]["values"], ref.values)):
        assert got == record[1]["values"][step]
        assert got["lr"] == want["lr"]
        assert got["loss_scale"] == want["loss_scale"] == 2.0 ** 15
        assert got["grads_finite"] == want["grads_finite"] == 1.0
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{step} {key}")
    for name, want in ref.grads.items():
        np.testing.assert_allclose(record[0]["grads"][name], want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name, want in ref.params.items():
        np.testing.assert_allclose(record[0]["params"][name], want,
                                   rtol=RTOL, atol=PARAM_ATOL, err_msg=name)
        assert torch.equal(record[0]["params"][name],
                           record[1]["params"][name]), name
    assert record[0]["optimizer_count"] == 2


def test_overflow_on_one_rank_skips_the_step_on_both(runs):
    _, records = runs
    record, clean = records["trainer_overflow"], records["trainer_options"]
    for rank in range(2):
        values = record[rank]["values"]
        assert [v["grads_finite"] for v in values] == [0.0, 1.0], rank
        assert [v["loss_scale"] for v in values] == [2.0 ** 14] * 2, rank
        # the skipped step moved nothing: one update was applied
        assert record[rank]["optimizer_count"] == 1
    # the losses were still logged, the same as the clean run's first
    np.testing.assert_allclose(record[0]["values"][0]["loss"],
                               clean[0]["values"][0]["loss"], rtol=RTOL)
    for name, p in record[0]["params"].items():
        assert torch.equal(p, record[1]["params"][name]), name
    assert any(not torch.equal(p, clean[0]["params"][n])
               for n, p in record[0]["params"].items())


def test_async_sharded_save_at_world_two_is_synchronous(runs):
    tmp, _ = runs
    for rank in range(2):
        out = torch.load(tmp / "async_sharded" / f"async{rank}.pt")
        assert out["complete"]
        said = [w for w in out["warnings"] if "saving synchronously" in w]
        assert len(said) == 1, out["warnings"]
