#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``ml_recipe_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, and no result line):

1. the card's name and power limit (``nvidia-smi``), and the build of every
   hand-written kernel from ``ml_recipe_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together); then the registers, shared memory and spill
   bytes of each bf16 tensor-core attention kernel at D = 32, 64 and 128
   (ptxas and ``cudaFuncGetAttributes``), fatal on any spill or local
   memory; the spill bytes of every int8 and LayerNorm kernel (ptxas, fatal
   on any), and the tensor-core and asynchronous-copy instructions of the
   int8 library (``cuobjdump -sass``: fatal without IMMA or IGMMA, or
   without LDGSTS or UTMALDG);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (bert-base: 12 heads of
   64), bf16 and f32, with key masks, segments (all-masked pad rows
   included), dropout and the logsumexp output; the autograd Function's
   gradients against ``torch.autograd`` through the plain forward; then
   timings by CUDA events (median of several runs) of each kernel, its
   plain version and one PyTorch library call computing the same function,
   beside the least time the card could take (``bound_ms``);
3. the serving path at full width: ``config/serve.cfg`` through the
   parsers, ``compose.init_model`` (bert-base-uncased, 12 layers, bf16,
   seeded random weights, a synthetic vocab), ``QAEngine`` over the
   ``8x128,8x384,32x384`` grid, warmup and ``QAServer`` on port 0, then
   concurrent ``POST /v1/qa`` requests reaching both seq buckets and a full
   32-row batch. Launch counts are set to 0 just before this phase and read
   just after: the forward kernel must have run exactly 12 times per device
   batch, the backward never. One full batch is scored again with the plain
   attention and must agree;
4. the training path at full width: ``config/test_bert.cfg`` through the
   trainer and model parsers, ``check_train_flags``, then the build and
   train sequence of ``ml_recipe_tpu_torch.cli.train`` (bert-base-uncased,
   bf16 compute, f32 master weights, 2 debug steps of 8 micro-batches of
   32x512, an eval after each epoch). Launch counts are set to 0 just before
   the training run and read just after: the backward kernel must have run
   12 times per micro-batch and the forward 12 times per micro-batch and
   per eval batch. Losses must be finite and the parameters must have moved.
   Then one micro-batch's forward+backward is timed and split by kernel
   family (the port's kernels, cuBLAS products, dropout RNG, GELU, the
   optimizer's multi-tensor kernels, casts and copies, other elementwise,
   and "other" with its ten largest kernels named), its gradients with
   kernel attention are held against plain attention, and one checkpoint
   is written and read back;
5. both kernels past 512, where they stand for the TPU's blocked and
   streaming kernels: against their plain versions at 32x768 and 32x1024
   (blocked), 2x4096 (streaming) and 2x1024 with non-zero bases, ``L_hash``
   and split q/k segment ids, bf16 and f32, key masks and segments,
   dropout and the lse; then each shape's kernel, plain and library times
   beside its bound, and the backward's time split by its three device
   kernels;
6. long-context training at full width: ``config/long_context.cfg`` as
   written (2 debug steps of 4 micro-batches of 32x1024, dropout 0.1,
   ``shard_optimizer``, ``sharded_checkpoint``) through the same build and
   train sequence, with counts zeroed just before and read just after (12
   forward launches per micro-batch and per eval batch, 12 backward per
   micro-batch), one micro-batch split by kernel family, one sharded
   checkpoint written and read back; then the cfg's single-chip variant
   (``--max_seq_len=4096 --max_position_embeddings=4096 --remat``, 2 x 2 x
   4096 per step), where the recompute makes it 24 forward launches per
   micro-batch, and one 2x4096 micro-batch's peak memory and gradients
   with remat on and off;
7. the LayerNorm pair, the int8 product and the row quantize against
   their plain versions at the shapes the paths give them, each launched
   twice and bit-stable (LayerNorm: 12288 and 16384 rows of 768, bf16, and
   the backward's ragged grids of 1, 40, 65, 2113 and 8512 rows, the forward
   within a bf16 step, the backward within the stated limits; the
   forward's quantize epilogue: its codes and scales ``torch.equal`` to
   ``quantize_rowwise`` of its own output; int8: every bert-base projection
   at 32x384, the pooler and the heads, both epilogues (f32, and bias plus
   the bf16 or f32 cast) and the quantize of each activation,
   ``torch.equal``), then their times beside their bounds, their plain
   versions and one PyTorch call each (``F.layer_norm`` and its backward;
   ``torch._int_mm`` with the rescale, and with the bias and cast, and the
   bf16 ``F.linear`` the float path runs), each wrapper's host time per
   launch (events minus the profiler's device time), and the LayerNorm
   backward's device time split between its row and column-sum kernels;
8. int8 serving: phase 3's 10-request burst with ``--quantize int8
   --ln_impl fused`` (counts zeroed just before warmup: 77 int8 matmul, 25
   LayerNorm with their codes, 25 row quantize and 12 attention launches
   per device batch), latency, one 32x384 scoring forward beside phase 3's
   split by kernel family ("int8 quantize" apart from "other"), and the
   share of windows where int8 and bf16 pick the same span
   (``quant.span_parity``, recorded, not a gate);
9. fused-LayerNorm training: ``config/test_bert.cfg --ln_impl fused``
   (counts zeroed just before: 25 LayerNorm forward launches per
   micro-batch and eval batch, 25 backward per micro-batch, attention as in
   phase 4), one 32x512 micro-batch split by kernel family beside phase
   4's, and its gradients with the LayerNorm kernels against their plain
   version;
10. the NQ corpus recipe: a seeded NQ-schema corpus of NQ_DOCS documents
    (log-uniform NQ_WORDS words in ``<P>`` paragraphs, five balanced
    classes, over the synthetic vocab) written and preprocessed, with the
    chunk lengths of its test split by bucket; ``config/test_bert.cfg``
    copied with ``dummy_dataset=False`` and the corpus paths, trained
    through phase 4's sequence (counts zeroed just before and read just
    after: 12 forward launches per micro-batch and eval batch, 12 backward
    per micro-batch), and ``last.ch`` saved; ``cli.validate`` with
    ``config/validate.cfg`` (16x512, ``--limit`` NQ_LIMIT) in bf16 (12
    forward launches per batch, no backward; each document's candidate is
    the best valid chunk of the per-chunk outputs; in one full batch each
    layer's attention call, kernel against plain on the batch's own inputs
    within ATOL, and the whole batch's scores under plain attention and
    under a planted fault recorded; the same documents scored again read
    in advance) and with ``--quantize int8 --ln_impl fused`` (phase 8's
    per-batch counts, no plain int8 pass; one full batch ``torch.equal``
    to its composition of plain int8 passes; the share of documents
    keeping bf16's candidate recorded); then ``cli.train_metrics`` on
    ``last.ch``,
    whose test-split "Test metrics" line must equal the train run's last
    one digit for digit;
11. data parallelism: the script starts itself again as two ranks of
    ``cli.train``'s ``main`` (``config/test_bert.cfg --ln_impl fused
    --dist_world_size 2``, bert-base, 128 of every 256 rows per rank in 8
    micro-batches of 16x512) sharing the card over gloo (NCCL refuses two
    ranks on one device), with each rank's counts zeroed just before and
    read just after (12 attention and 25 LayerNorm launches per micro-batch
    and eval batch, backward per micro-batch); the replicas' parameters
    must end bit-identical and the ranks' step losses equal; an oracle
    process (``cli.train.build_trainer`` in one process) takes the first
    global batch regrouped in rank order: the first step's gradient as it
    reaches the clip (all-reduced and scaled, its magnitude intact) must be
    within DP_GRAD_REL_TOL of the oracle's and the first step's logged loss
    within DP_LOSS_REL_TOL of its loss; a run with a planted fault (rank 1
    skips the all-reduce) must miss the gradient by at least
    DP_FAULT_FACTOR times its tolerance and break the replicas; a one-rank NCCL
    group's bucketed all-reduce and broadcast over bert-base's parameters
    must give back their inputs bit for bit; the step walls, all-reduce
    times and the global-shape dropout draw's extra cost are printed.

It then prints one ``{"kernels": [...]}`` line (the attention kernels'
lines carry the tensor-core kernels' resources and every timed shape's
``ms`` and ratio to ``scaled_dot_product_attention`` under ``by_shape``)
and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or outside a checkout
of the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chip_smoke_out"     # the synthetic vocab (git-ignored)

H, D = 12, 64                      # bert-base attention heads
# (B, L): serving buckets, the 32x384 serving batch, the 16x512 validate
# batch (config/validate.cfg), and 2x200 ragged
SHAPES = [(8, 128), (8, 384), (32, 384), (16, 512), (2, 200)]
SERVING_SHAPE = (32, 384)          # the serving path's full batch
TRAIN_SHAPE = (32, 512)            # the training micro-batch (test_bert.cfg)
BWD_SHAPES = [(32, 512), (8, 128), (2, 200)]         # 2x200 ragged
TRAIN_RATE = 0.1                   # attention_probs_dropout_prob
# kernel vs plain, per output type. bf16: the kernel rounds each
# probability to bf16 against its running row max, the plain version
# against the final max (2**-9 relative each), and both round the output
# to bf16 (2**-9 relative); |out| < 4 here, so a few bf16 ulps.
ATOL = {"bf16": 3e-2, "f32": 1e-4}
LSE_ATOL = 1e-3   # f32 logsumexp of O(10) scores, summed in other orders
# backward kernel vs plain, on the same forward residuals. Unit-normal
# q, k, v and g give dq, dk, dv of mean size 0.01-0.13 and largest size
# 1-5 (each check prints both). f32: the same formula in another summation
# order over up to 512 keys (~1e-6 relative), held to an atol. bf16: both
# round p_drop and ds to bf16 at the same points and sum in f32, so a
# result a hair from a bf16 rounding boundary rounds either way: one bf16
# step (8 significant bits) at its size. Two limits: the largest error
# within BWD_BF16_STEPS steps at max|ref| (2**-7 to 2**-6 of max|ref|; a
# wrong scale, a dropped 1/(1-rate) or a wrong tile moves far more), and,
# in both dtypes, the relative L2 error within BWD_REL_L2, which another
# summation order meets by 10x (~5e-5) and a misplaced bf16 rounding point
# misses by 5x (~2.6e-3; tests/test_torch_cuda.py pins both on the CPU)
BWD_ATOL_F32 = 2e-4
BWD_BF16_STEPS = 2
BWD_REL_L2 = 5e-4
# the Function's f32 gradients against torch.autograd through the plain
# forward: two different algorithms (lse + delta identity vs the softmax
# chain rule), f32 throughout
GRAD_ATOL = 2e-4
# one bert-base micro-batch's flat gradient, kernel vs plain attention, in
# bf16 compute: attention outputs and their gradients differ by bf16
# rounding (2**-9 relative) at different points, and 12 post-LN layers
# forward and back carry that into every parameter's gradient
TRAIN_GRAD_REL_TOL = 0.05
# the full 12-layer model, kernel vs plain attention in bf16: attention
# outputs differ by bf16 ulps and 12 post-LN layers carry that into O(1)
# logits; span ids must match wherever the top-2 margin exceeds this
SCORE_ATOL = 0.25

# past 512: config/long_context.cfg's 768 and 1024 buckets (the TPU's
# q-blocked regime) and its single-chip variant's 4096 (the streaming one)
LONG_SHAPES = [(32, 768), (32, 1024), (2, 4096)]
BLOCKED_SHAPE, STREAM_SHAPE = (32, 1024), (2, 4096)
# a 1024-row block at rows 1024.., columns 3072.. of a 4096-long sequence,
# with its own q-side and k-side segment ids (the ring's streaming call)
OFFSETS = dict(base=(1024, 3072), L_hash=4096)
LONG_CFG = "long_context.cfg"
LONG_VARIANT = ["--max_seq_len=4096", "--max_position_embeddings=4096",
                "--remat", "--train_batch_size", "4", "--batch_split", "2",
                "--test_batch_size", "2"]
# one 2x4096 micro-batch's flat gradient, remat on against off, same
# generator: remat replays every dropout draw, so only the summation order
# of reductions that use atomics may differ (f32, ~1e-7 relative); a
# recompute that drew other masks is off by O(1)
REMAT_GRAD_REL_TOL = 1e-5

# the LayerNorm rows of the serving (32x384), training (32x512) and
# validate (16x512) paths
LN_SHAPES = [(12288, 768), (16384, 768), (8192, 768)]
# row counts of the backward's grid (csrc/layer_norm.cu: 8 warps a block,
# a warp a row, at most 264 blocks, so 2112 rows a pass): one row, part of
# a block, a block and a row (9 blocks, an odd count), a pass and a row,
# and four passes and 64 rows (warps with 4 rows and warps with 5)
LN_RAGGED = [(1, 768), (40, 768), (65, 768), (2113, 768), (8512, 768)]
LN_EPS = 1e-12                     # bert-base layer_norm_eps
# LayerNorm kernel vs plain: within the limits ops/layer_norm.py states
# beside the plain versions (ln.fwd_limit, ln.dh_limit, ln.dparam_close)
# LayerNorm launches per model forward: the embeddings' and two per layer
LN_PER_FORWARD = 25
# int8 matmul shapes at 32x384 (M = 12288 tokens) and at validate's 16x512
# (M = 8192): the four attention projections (768, 768), FFN in (768, 3072)
# and out (3072, 768); at 32x384 the pooler over the 32 [CLS] rows, the
# span head over every token, the classifier and regressors over the
# pooled rows
Q8_PROJ = [(12288, 768, 768), (12288, 768, 3072), (12288, 3072, 768),
           (8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768)]
Q8_SHAPES = Q8_PROJ + [(32, 768, 768), (12288, 768, 2), (32, 768, 5),
                       (32, 768, 1)]
Q8_PER_FORWARD = 77                # 6 x 12 layers + pooler + 4 heads
# row quantize launches per int8 forward with the fused LayerNorm, whose
# launches write the codes of their own outputs: the attention context and
# the GELU output of each layer, and the pooled output
QUANT_PER_FORWARD = 25
# the activations the int8 path quantizes at 32x384 and at 16x512: hidden
# and context rows (K = 768), GELU rows (3072), the pooled rows
QUANT_SHAPES = [(12288, 768), (12288, 3072), (32, 768), (8192, 768),
                (8192, 3072)]
# the fused-LayerNorm micro-batch's gradient, LayerNorm kernels vs their
# plain version, both with kernel attention in bf16: LayerNorm outputs and
# dh differ by bf16 rounding at a few elements, which 12 post-LN layers
# carry into every gradient, as TRAIN_GRAD_REL_TOL says for attention
LN_GRAD_REL_TOL = TRAIN_GRAD_REL_TOL

# published peaks per H100 part (NVIDIA data sheets, dense): device-memory
# rate, bf16 tensor-core rate, int8 tensor-core rate, f32 outside the
# tensor cores; matched against the nvidia-smi name
PEAKS = [("PCIe", dict(bw=2.0e12, bf16=756e12, int8=1513e12, f32=51e12)),
         ("NVL", dict(bw=3.9e12, bf16=835e12, int8=1670e12, f32=60e12)),
         ("H100", dict(bw=3.35e12, bf16=989e12, int8=1979e12, f32=67e12))]

# the port's kernels by name, each with its launch count (filled in main)
KERNELS = {}


def zero_counts() -> None:
    """Set every kernel's launch count to 0: a path starts here."""
    for kernel in KERNELS.values():
        kernel.launches = 0


def counts() -> dict:
    """Every kernel's launch count: a path ends here."""
    return {name: kernel.launches for name, kernel in KERNELS.items()}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str) -> dict:
    for key, peaks in PEAKS:
        if key in name:
            return peaks
    fail(f"no peak rates known for card {name!r}")


def ptxas_reports(build_log: str):
    """``(kernel, report)`` per compiled kernel from nvcc's ``-Xptxas -v``
    output: the kernel's name and template arguments (element types, head
    dim), and its registers, stack and spills on one line."""
    kernel, parts = None, []
    for line in build_log.splitlines():
        entry = re.search(r"Compiling entry function '_ZN\w*?\d+"
                          r"((?:fused_attention|layer_norm|q8)_[a-z_]+)"
                          r"(?:I(\w+?)E)?E", line)
        if entry:
            if kernel is not None:
                yield kernel, "; ".join(parts)
            name, targs = entry.groups()
            # template arguments: element types (f, __nv_bfloat16 or its
            # back-reference S1_), then integers (the attention kernels'
            # head dim and tile width, Li64E; vector widths) and flags
            # (Lb1E: b1)
            names = {"f": "f32", "13__nv_bfloat16": "bf16", "S1_": "bf16"}
            targs = [names.get(t, t.strip("LiE")) for t in re.findall(
                r"13__nv_bfloat16|S1_|Li\d+E?|Lb\dE?|f", targs or "")]
            kernel = f"{name}<{' '.join(targs)}>" if targs else name
            parts = []
        elif kernel is not None and ("registers" in line or "spill" in line):
            parts.append(line.split(":", 1)[-1].strip() if "ptxas" in line
                         else line.strip())
    if kernel is not None:
        yield kernel, "; ".join(parts)


def _spill_bytes(report: str):
    """Spill stores and loads together, in bytes, of one ptxas report
    line; None when the line has no spill figures."""
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", report)
    return sum(int(x) for x in spills) if spills else None


def check_tc_kernels(fa, reports: dict) -> dict:
    """Registers, shared memory and spill bytes of every bf16 tensor-core
    attention kernel at D = 32, 64 and 128: from ``cudaFuncGetAttributes``
    and, where this run built the library, ptxas's report. Fails on any
    spill and on any local memory (a spilled or stack-resident array)."""
    found = {}
    for D in fa.KERNEL_HEAD_DIMS:
        for name, a in fa.tc_kernel_attributes(D).items():
            report = reports.get(f"{name}<bf16 {D}>")
            spill = _spill_bytes(report) if report else None
            entry = dict(registers=a["registers"],
                         smem_bytes=a["static_smem_bytes"]
                         + a["dynamic_smem_bytes"],
                         local_bytes=a["local_bytes"],
                         spill_bytes=spill)
            found[f"{name}<{D}>"] = entry
            say(f"tensor-core kernel {name}<bf16, D={D}>: {entry['registers']}"
                f" registers, {entry['smem_bytes']} B shared memory, "
                f"{entry['local_bytes']} B local, spill bytes "
                f"{'not in this run (library cached)' if spill is None else spill}")
            if spill or entry["local_bytes"]:
                fail(f"{name}<bf16, D={D}> spills or uses local memory: "
                     f"{entry}")
    return found


# the instructions the int8 product must compile to: a tensor-core int8
# product (mma.sync: IMMA; wgmma: IGMMA) and an asynchronous copy into
# shared memory (cp.async: LDGSTS; TMA: UTMALDG)
Q8_SASS = (("IMMA", "IGMMA"), ("LDGSTS", "UTMALDG"))


def check_row_kernels(cuda_build, q8, ln, built) -> dict:
    """Spill bytes of every kernel of the int8 and LayerNorm libraries
    (ptxas, where this run built them; fatal on any, and on a built library
    without a report; said when a library was cached), and the counts of
    the int8 library's tensor-core, copy and ldmatrix instructions
    (``cuobjdump -sass``; fatal without Q8_SASS)."""
    for lib in (q8.LIBRARY, ln.LIBRARY):
        if lib not in built:
            say(f"spill bytes of {lib.path.name}'s kernels: not checked "
                f"(library cached, no ptxas report in this run)")
            continue
        found = [(k, r) for k, r in ptxas_reports(lib.build_log)
                 if k.startswith(("q8_", "layer_norm_"))]
        if not found:
            fail(f"no ptxas report of a kernel in {lib.source.name}'s build")
        for kernel, report in found:
            spill = _spill_bytes(report)
            if spill is None:
                fail(f"{kernel}: no spill figures in ptxas's report {report}")
            if spill:
                fail(f"{kernel} spills {spill} bytes: {report}")
        say(f"spill bytes of {lib.source.name}'s {len(found)} kernels: 0")
    cuobjdump = Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(q8.LIBRARY.path)],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed on the int8 library: {sass.stderr}")
    ops = {}
    for op in re.findall(r"\b(IMMA|IGMMA|HMMA|LDGSTS|UTMALDG|LDSM)\S*",
                         sass.stdout):
        ops[op] = ops.get(op, 0) + 1
    say(f"SASS of {q8.LIBRARY.path.name}: instruction counts {ops}")
    for group in Q8_SASS:
        if not any(ops.get(op) for op in group):
            fail(f"the int8 library has none of {group} in its SASS")
    return ops


def time_ms(torch, fn, reps: int = 15, warm: int = 3) -> float:
    """Median device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _attention_inputs(torch, fa, rng, B, L, dtype):
    """q, k, v, key mask, segment ids (three packed segments, then padding,
    and in the last row every token padding) and row seeds, from ``rng``."""
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D),
                                                    dtype=np.float32))
               .to("cuda", dtype) for _ in range(3))
    mask = (rng.random((B, L)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    seg = np.zeros((B, L), np.int32)
    for b in range(B - 1):
        c1, c2, c3 = sorted(rng.choice(np.arange(1, L), 3, replace=False))
        seg[b, :c1], seg[b, c1:c2], seg[b, c2:c3] = 1, 2, 3
    seeds = fa.row_seeds(torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)), B, H, "cuda")
    return (q, k, v, torch.from_numpy(mask).cuda(),
            torch.from_numpy(seg).cuda(), seeds)


def bf16_step(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def _bound(n_bytes, n_ops, bw, flops):
    """``(bound_ms, bound_by)``: the larger of the bytes and operations
    terms at the card's published peaks (``flops``: the rate for the
    operations' type)."""
    t_bytes, t_ops = n_bytes / bw, n_ops / flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


CASES = [
    ("mask", dict()),
    ("mask+dropout", dict(rate=TRAIN_RATE)),
    ("segmented", dict(segmented=True)),
    ("segmented+dropout", dict(segmented=True, rate=TRAIN_RATE)),
]


def phase_kernels(torch, fa, bw, flops):
    """The forward kernel against its plain version at the serving and
    training shapes, then timings (serving configuration at the serving
    shapes, training configuration at 32x512)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    results, max_err = {}, 0.0
    cases = [
        ("mask", dict()),
        ("mask+dropout+lse", dict(rate=TRAIN_RATE, want_lse=True)),
        ("segmented+lse", dict(segmented=True, want_lse=True)),
        ("segmented+dropout", dict(segmented=True, rate=TRAIN_RATE)),
    ]
    runs = [(B, L, torch.bfloat16, "bf16", cases)
            for B, L in SHAPES + [TRAIN_SHAPE]]
    runs += [(2, 200, torch.float32, "f32", cases),
             (8, 128, torch.float32, "f32", cases[1:2])]
    for B, L, dtype, tname, run_cases in runs:
        q, k, v, mask, seg, seeds = _attention_inputs(torch, fa, rng, B, L,
                                                      dtype)
        for case, kw in run_cases:
            m = seg if kw.get("segmented") else mask
            args = dict(seeds=seeds if kw.get("rate") else None, **kw)
            got = fa.fused_attention_cuda(q, k, v, m, **args)
            ref = fa.fused_attention_plain(q, k, v, m, **args)
            torch.cuda.synchronize()
            if kw.get("want_lse"):
                (got, lse), (ref, ref_lse) = got, ref
                lse_err = (lse - ref_lse).abs().max().item()
            else:
                lse_err = 0.0
            if not bool(torch.isfinite(got.float()).all()):
                fail(f"kernel output not finite at {B}x{L} {tname} {case}")
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= ATOL[tname] and lse_err <= LSE_ATOL
            say(f"kernel-vs-plain fused_attention_fwd B={B} L={L} H={H} D={D} "
                f"{tname} {case}: max_abs_err={err:.3e} (tol {ATOL[tname]:g})"
                f" lse_err={lse_err:.3e} (tol {LSE_ATOL:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"kernel disagrees with plain at {B}x{L} {tname} {case}")
            max_err = max(max_err, err)

        if dtype != torch.bfloat16:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bool_mask = (mask > 0)[:, None, None, :]
        n_ops = 4 * B * H * L * L * D
        if (B, L) == TRAIN_SHAPE:
            # the training configuration: dropout and the lse output
            config = "rate 0.1, lse"
            kernel_ms = time_ms(torch, lambda: fa.fused_attention_cuda(
                q, k, v, mask, seeds, TRAIN_RATE, want_lse=True))
            plain_ms = time_ms(torch, lambda: fa.fused_attention_plain(
                q, k, v, mask, seeds, TRAIN_RATE, want_lse=True))
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bool_mask, dropout_p=TRAIN_RATE))
            n_bytes = (4 * B * L * H * D * q.element_size() + mask.numel() * 4
                       + B * 4 + B * H * L * 4)
        else:
            # the serving configuration: key mask, rate 0, no lse
            config = "rate 0"
            kernel_ms = time_ms(torch, lambda: fa.fused_attention_cuda(q, k, v, mask))
            plain_ms = time_ms(torch, lambda: fa.fused_attention_plain(q, k, v, mask))
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bool_mask))
            n_bytes = 4 * B * L * H * D * q.element_size() + mask.numel() * 4
        bound_ms, bound_by = _bound(n_bytes, n_ops, bw, flops)
        results[(B, L)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bound_ms,
                               bound_by=bound_by, config=config)
        say(f"timing fused_attention_fwd {B}x{L}x{H}x{D} bf16 ({config}): "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(sdpa)={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; {n_bytes} B, {n_ops} ops)")
    return results, max_err


def phase_bwd_kernel(torch, fa, bw, flops):
    """The backward kernel against its plain version on the same forward
    residuals, the Function's gradients against autograd through the plain
    forward, then timings at the training micro-batch."""
    import torch.nn.functional as F

    rng = np.random.default_rng(1)
    max_err = 0.0
    for B, L in BWD_SHAPES:
        for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            q, k, v, mask, seg, seeds = _attention_inputs(torch, fa, rng, B,
                                                          L, dtype)
            g = torch.from_numpy(rng.standard_normal(
                (B, L, H, D), dtype=np.float32)).to("cuda", dtype)
            for case, kw in CASES:
                m = seg if kw.get("segmented") else mask
                rate = kw.get("rate", 0.0)
                sd = seeds if rate else None
                segmented = kw.get("segmented", False)
                out, lse = fa.fused_attention_plain(q, k, v, m, sd, rate,
                                                    segmented, want_lse=True)
                args = (q, k, v, g, out, lse, m, sd, rate, segmented)
                got = fa.fused_attention_bwd_cuda(*args)
                ref = fa.fused_attention_bwd_plain(*args)
                torch.cuda.synchronize()
                errs, tols, rels, refs, means = [], [], [], [], []
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    a, b = a.float(), b.float()
                    if not bool(torch.isfinite(a).all()):
                        fail(f"backward {name} not finite at {B}x{L} {tname} "
                             f"{case}")
                    errs.append((a - b).abs().max().item())
                    rels.append(((a - b).norm() / b.norm()).item())
                    refs.append(b.abs().max().item())
                    means.append(b.abs().mean().item())
                    tols.append(BWD_BF16_STEPS * bf16_step(refs[-1])
                                if tname == "bf16" else BWD_ATOL_F32)
                ok = all(e <= t and r <= BWD_REL_L2
                         for e, t, r in zip(errs, tols, rels))
                say(f"kernel-vs-plain fused_attention_bwd B={B} L={L} H={H} "
                    f"D={D} {tname} {case}: dq/dk/dv max_abs_err "
                    f"{errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e} (tol "
                    f"{tols[0]:.3e} {tols[1]:.3e} {tols[2]:.3e}), rel_l2 "
                    f"{rels[0]:.2e} {rels[1]:.2e} {rels[2]:.2e} (tol "
                    f"{BWD_REL_L2:g}); max|ref| {refs[0]:.3f} {refs[1]:.3f} "
                    f"{refs[2]:.3f}, mean|ref| {means[0]:.3f} {means[1]:.3f} "
                    f"{means[2]:.3f} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"backward kernel disagrees with plain at {B}x{L} "
                         f"{tname} {case}")
                max_err = max(max_err, *errs)
            del q, k, v, g, out, lse, got, ref

    # the kernel pair under autograd against autograd of the plain forward
    # (f32; segmented pad rows get a zero cotangent, as downstream masking
    # gives them: the TPU backward zeroes their contributions)
    for B, L in ((8, 128), (2, 200)):
        q, k, v, mask, seg, seeds = _attention_inputs(torch, fa, rng, B, L,
                                                      torch.float32)
        for segmented in (False, True):
            m = seg if segmented else mask
            g = torch.from_numpy(rng.standard_normal(
                (B, L, H, D), dtype=np.float32)).cuda()
            if segmented:
                g = g * (m > 0)[:, :, None, None]
            grads = []
            for plain in (False, True):
                x = [t.clone().requires_grad_() for t in (q, k, v)]
                if plain:
                    out = fa.fused_attention_plain(*x, m, seeds, TRAIN_RATE,
                                                   segmented)
                else:
                    out = fa.fused_attention(*x, m, seed=seeds,
                                             rate=TRAIN_RATE,
                                             segmented=segmented)
                    if out.grad_fn is None:
                        fail("fused_attention on CUDA tensors that require "
                             "grad returned no grad_fn")
                grads.append(torch.autograd.grad(out, x, g))
            err = max((a - b).abs().max().item() for a, b in zip(*grads))
            say(f"FusedAttention grads vs autograd of the plain forward "
                f"B={B} L={L} f32 {'segmented' if segmented else 'mask'}"
                f"+dropout: max_abs_err={err:.3e} (tol {GRAD_ATOL:g}) "
                f"{'ok' if err <= GRAD_ATOL else 'FAIL'}")
            if not err <= GRAD_ATOL:
                fail("the autograd Function's gradients disagree")

    # timings: the training micro-batch, bf16, key mask, dropout 0.1
    B, L = TRAIN_SHAPE
    q, k, v, mask, _, seeds = _attention_inputs(torch, fa, rng, B, L,
                                                torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(
        (B, L, H, D), dtype=np.float32)).to("cuda", torch.bfloat16)
    out, lse = fa.fused_attention_cuda(q, k, v, mask, seeds, TRAIN_RATE,
                                       want_lse=True)
    args = (q, k, v, g, out, lse, mask, seeds, TRAIN_RATE, False)
    kernel_ms = time_ms(torch, lambda: fa.fused_attention_bwd_cuda(*args))
    plain_ms = time_ms(torch, lambda: fa.fused_attention_bwd_plain(*args),
                       reps=5)
    # yardstick: scaled_dot_product_attention's backward with the same
    # boolean mask and dropout rate, timed as (forward + backward) minus
    # forward
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2)
    bool_mask = (mask > 0)[:, None, None, :]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bool_mask,
                                              dropout_p=TRAIN_RATE)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

    library_ms = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd)
    n_bytes = (8 * B * L * H * D * q.element_size() + B * H * L * 4
               + mask.numel() * 4 + B * 4)
    n_ops = 5 * 2 * B * H * L * L * D
    bound_ms, bound_by = _bound(n_bytes, n_ops, bw, flops)
    split = _bwd_split(torch, fa, args)
    say(f"timing fused_attention_bwd {B}x{L}x{H}x{D} bf16 (rate 0.1): "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms(sdpa backward, fwd+bwd minus fwd)={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {n_bytes} B, {n_ops} ops); "
        f"{_split_line(split)}")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                device_ms_by_kernel=split["split_ms"]), max_err


def phase_ln_kernels(torch, ln, q8, peaks):
    """The LayerNorm pair against its plain version at the paths' shapes
    (and f32 at one more), the forward's quantize epilogue against
    ``quantize_rowwise`` of its own output, every kernel launched twice and
    bit-stable, then timings. Returns ``(timings, fwd max err, bwd max
    err)``."""
    import torch.nn.functional as F

    max_fwd = max_bwd = 0.0
    runs = [(N, C, torch.bfloat16, "bf16") for N, C in LN_SHAPES + LN_RAGGED]
    runs += [(1000, 768, torch.float32, "f32"), (333, 1024, torch.float32,
                                                  "f32")]
    for N, C, dtype, tname in runs:
        h, gamma, beta, g = ln.seeded_inputs(N, C, dtype, N + C)
        y = ln.layer_norm_fwd_cuda(h, gamma, beta, LN_EPS, dtype)
        y_again = ln.layer_norm_fwd_cuda(h, gamma, beta, LN_EPS, dtype)
        ref = ln.layer_norm_plain(h, gamma, beta, LN_EPS, dtype)
        got = ln.layer_norm_bwd_cuda(h, gamma, g, LN_EPS)
        want = ln.layer_norm_bwd_plain(h, gamma, g, LN_EPS)
        again = ln.layer_norm_bwd_cuda(h, gamma, g, LN_EPS)
        yq, q, scale = ln.layer_norm_q8_cuda(h, gamma, beta, LN_EPS, dtype)
        yq2, q2, scale2 = ln.layer_norm_q8_cuda(h, gamma, beta, LN_EPS, dtype)
        want_q, want_s = q8.quantize_rowwise(yq)
        torch.cuda.synchronize()
        r = ref.float()
        tol = ln.fwd_limit(ref)
        err = (y.float() - r).abs()
        ratio = (err / tol).max().item()
        ok_f = bool(torch.isfinite(y.float()).all()) and ratio <= 1.0
        dh, dh_ref = got[0].float(), want[0].float()
        errs = [(dh - dh_ref).abs().max().item()]
        ok_b = bool(torch.isfinite(dh).all()) and \
            bool(((dh - dh_ref).abs() <= ln.dh_limit(want[0])).all())
        for a, b in zip(got[1:], want[1:]):
            errs.append((a - b).abs().max().item())
            ok_b = ok_b and ln.dparam_close(a, b)
        stable = (all(torch.equal(a, b) for a, b in zip(got, again))
                  and torch.equal(y, y_again))
        # the epilogue's y is the forward's, and its codes are the grid of
        # that y, bit for bit
        ok_c = (torch.equal(yq, y) and torch.equal(q, want_q)
                and torch.equal(scale, want_s) and torch.equal(yq2, yq)
                and torch.equal(q2, q) and torch.equal(scale2, scale))
        say(f"kernel-vs-plain layer_norm N={N} C={C} {tname}: forward "
            f"max_abs_err={err.max().item():.3e} (within {ln.FWD_REL} of "
            f"max(|ref|, 1){' plus one bf16 step' if tname == 'bf16' else ''};"
            f" worst "
            f"err/tol {ratio:.3f}) "
            f"{'ok' if ok_f else 'FAIL'}; backward dh/dgamma/dbeta "
            f"max_abs_err {errs[0]:.3e} {errs[1]:.3e} {errs[2]:.3e} (max|ref| "
            f"{dh_ref.abs().max().item():.3f} {want[1].abs().max().item():.3f}"
            f" {want[2].abs().max().item():.3f}) {'ok' if ok_b else 'FAIL'}; "
            f"two launches of each {'bit-identical' if stable else 'DIFFER'};"
            f" quantize epilogue: y {'=' if torch.equal(yq, y) else '!='} the "
            f"forward's, codes and scales "
            f"{'equal' if ok_c else 'NOT equal'} to quantize_rowwise(y)")
        if not (ok_f and ok_b and stable and ok_c):
            fail(f"a LayerNorm kernel disagrees with its plain version or is "
                 f"not bit-stable at N={N} C={C} {tname}")
        max_fwd, max_bwd = max(max_fwd, err.max().item()), max(max_bwd, *errs)

    timings = {}
    for N, C in LN_SHAPES:
        h, gamma, beta, g = ln.seeded_inputs(N, C, torch.bfloat16, 7)
        gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

        def fwd_launch():
            return ln.layer_norm_fwd_cuda(h, gamma, beta, LN_EPS,
                                          torch.bfloat16)

        def q8_launch():
            return ln.layer_norm_q8_cuda(h, gamma, beta, LN_EPS,
                                         torch.bfloat16)

        fwd = dict(
            ms=time_ms(torch, fwd_launch),
            plain_ms=time_ms(torch, lambda: ln.layer_norm_plain(
                h, gamma, beta, LN_EPS, torch.bfloat16)),
            library_ms=time_ms(torch, lambda: F.layer_norm(
                h, (C,), gb, bb, LN_EPS)))
        # h in, y out (bf16); gamma, beta in (f32); ~8 f32 operations an
        # element (mean, centre, square, variance, scale, affine)
        fwd["bound_ms"], fwd["bound_by"] = _bound(
            2 * N * C * 2 + 2 * C * 4, 8 * N * C, peaks["bw"], peaks["f32"])
        # a launch this short can take less device time than the wrapper
        # takes on the host, which the events then measure: the profiler's
        # device time beside them, and the difference as the host's
        fwd["device_ms"] = profile_kernels(
            torch, fwd_launch, ("layer_norm_fwd",))["layer_norm_fwd"]
        fwd["host_ms"] = less(fwd["ms"], fwd["device_ms"])
        # the quantize epilogue: the codes (1 byte) and a scale a row more,
        # ~4 more operations an element (abs, max, divide, round)
        codes = dict(ms=time_ms(torch, q8_launch),
                     plain_ms=time_ms(torch, lambda: ln.layer_norm_q8_plain(
                         h, gamma, beta, LN_EPS, torch.bfloat16)))
        codes["bound_ms"], codes["bound_by"] = _bound(
            2 * N * C * 2 + N * C + 4 * N + 2 * C * 4, 12 * N * C,
            peaks["bw"], peaks["f32"])
        codes["device_ms"] = profile_kernels(
            torch, q8_launch, ("layer_norm_fwd",))["layer_norm_fwd"]
        codes["host_ms"] = less(codes["ms"], codes["device_ms"])
        fwd["with_codes"] = codes
        timings[(N, C, "fwd")] = fwd
        say(f"timing layer_norm_fwd {N}x{C} bf16: kernel_ms={fwd['ms']:.4f} "
            f"(device ms {not_measured(fwd['device_ms'])}, host ms per "
            f"launch {not_measured(fwd['host_ms'])}) plain_ms="
            f"{fwd['plain_ms']:.4f} "
            f"library_ms(F.layer_norm)={fwd['library_ms']:.4f} bound_ms="
            f"{fwd['bound_ms']:.4f} ({fwd['bound_by']}); with the quantize "
            f"epilogue kernel_ms={codes['ms']:.4f} (device ms "
            f"{not_measured(codes['device_ms'])}, host "
            f"{not_measured(codes['host_ms'])}) "
            f"plain_ms={codes['plain_ms']:.4f} bound_ms="
            f"{codes['bound_ms']:.4f} ({codes['bound_by']})")
        hr, gr, br = (t.detach().requires_grad_() for t in (h, gb, bb))

        def lib_fwd():
            return F.layer_norm(hr, (C,), gr, br, LN_EPS)

        def lib_fwd_bwd():
            torch.autograd.grad(lib_fwd(), (hr, gr, br), g)

        bwd = dict(
            ms=time_ms(torch, lambda: ln.layer_norm_bwd_cuda(
                h, gamma, g, LN_EPS)),
            plain_ms=time_ms(torch, lambda: ln.layer_norm_bwd_plain(
                h, gamma, g, LN_EPS)),
            library_ms=time_ms(torch, lib_fwd_bwd) - time_ms(torch, lib_fwd))
        # h, g in and dh out (bf16); gamma in, dgamma and dbeta out (f32);
        # ~16 f32 operations an element (statistics again, the two means,
        # dh, the dgamma/dbeta sums)
        bwd["bound_ms"], bwd["bound_by"] = _bound(
            3 * N * C * 2 + 3 * C * 4, 16 * N * C, peaks["bw"], peaks["f32"])
        bwd["split_ms"] = profile_kernels(
            torch, lambda: ln.layer_norm_bwd_cuda(h, gamma, g, LN_EPS),
            ("layer_norm_bwd_warp_kernel", "layer_norm_bwd_sum_kernel"))
        bwd["device_ms"] = (None if None in bwd["split_ms"].values()
                            else round(sum(bwd["split_ms"].values()), 4))
        bwd["host_ms"] = less(bwd["ms"], bwd["device_ms"])
        timings[(N, C, "bwd")] = bwd
        say(f"timing layer_norm_bwd {N}x{C} bf16: kernel_ms={bwd['ms']:.4f} "
            f"(device ms {not_measured(bwd['device_ms'])}, host ms per "
            f"launch {not_measured(bwd['host_ms'])}) plain_ms="
            f"{bwd['plain_ms']:.4f} "
            f"library_ms(F.layer_norm backward, fwd+bwd minus fwd)="
            f"{bwd['library_ms']:.4f} bound_ms="
            f"{bwd['bound_ms']:.4f} ({bwd['bound_by']}); device ms by kernel "
            f"{bwd['split_ms']}")
    return timings, max_fwd, max_bwd


def _q8_inputs(torch, q8, M, K, N, seed):
    """bf16 activations quantized per row (the plain version), f32 weights
    quantized per output channel by ``quant.quantize_kernel`` in the port's
    [N, K] layout and an f32 bias; also the bf16 activations and the bf16
    weight and bias the float path would multiply."""
    from ml_recipe_tpu_torch.quant import quantize_kernel

    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((M, K), generator=gen) * 3).to("cuda", torch.bfloat16)
    w = torch.randn((N, K), generator=gen) * 0.05
    bias = (torch.randn(N, generator=gen) * 0.1).cuda()
    wq, ws = quantize_kernel(w.t().numpy())
    xq, xs = q8.quantize_rowwise(x)
    return (xq, xs, torch.from_numpy(wq.T.copy()).cuda(),
            torch.from_numpy(ws).cuda(), bias, x,
            w.to("cuda", torch.bfloat16), bias.to(torch.bfloat16))


def phase_q8_kernel(torch, q8, peaks):
    """The int8 product in both epilogues and the row quantize against
    their plain versions (``torch.equal``, and a second launch bit for
    bit) at every shape of the int8 serving path, then timings at the
    projections and at the quantized activations. Returns ``(product
    timings by shape, quantize timings by shape, the product's largest
    |kernel - plain|, the quantize's largest |kernel - plain| over codes
    and scales)``."""
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    max_err = quant_err = 0.0

    def check_quantize(x, label):
        """The row quantize of ``x`` against ``quantize_rowwise``: codes
        and scales equal, a second launch bit for bit. Returns the verdict
        and the largest |kernel - plain| of the codes (as integers) and of
        the scales."""
        (qa, sa), (qb, sb) = (q8.quantize_rowwise_cuda(x),
                              q8.quantize_rowwise_cuda(x))
        want_q, want_s = q8.quantize_rowwise(x)
        torch.cuda.synchronize()
        same = torch.equal(qa, want_q) and torch.equal(sa, want_s)
        stable = torch.equal(qa, qb) and torch.equal(sa, sb)
        err = max((qa.int() - want_q.int()).abs().max().item(),
                  (sa - want_s).abs().max().item())
        say(f"kernel-vs-plain q8_quantize_rows {label} bf16: codes and "
            f"scales {'bit-identical' if same else 'DIFFER'} (max_abs_err "
            f"{err:.3e}), two launches "
            f"{'bit-identical' if stable else 'DIFFER'}")
        return same and stable, err

    for M, K, N in Q8_SHAPES:
        xq, xs, wq, ws, bias, x, _, _ = _q8_inputs(torch, q8, M, K, N,
                                                   M + K + N)
        runs = {
            "f32": lambda: q8.int8_matmul_cuda(xq, xs, wq, ws),
            "bf16+bias": lambda: q8.int8_linear_cuda(xq, xs, wq, ws, bias,
                                                     bf16),
            "f32+bias": lambda: q8.int8_linear_cuda(xq, xs, wq, ws, bias,
                                                    f32)}
        plain = {
            "f32": q8.int8_matmul_plain(xq, xs, wq, ws),
            "bf16+bias": q8.int8_linear_plain(xq, xs, wq, ws, bias, bf16),
            "f32+bias": q8.int8_linear_plain(xq, xs, wq, ws, bias, f32)}
        got = {k: (fn(), fn()) for k, fn in runs.items()}
        torch.cuda.synchronize()
        verdicts = []
        for k, (a, b) in got.items():
            same = bool(torch.equal(a, plain[k]))
            stable = bool(torch.equal(a, b))
            err = (a.float() - plain[k].float()).abs().max().item()
            max_err = max(max_err, err)
            verdicts.append(same and stable)
            say(f"kernel-vs-plain q8_matmul M={M} K={K} N={N} {k}: "
                f"{'bit-identical' if same else 'DIFFER'} (max_abs_err "
                f"{err:.3e}, max|ref| {plain[k].float().abs().max().item():.3f}"
                f"), two launches {'bit-identical' if stable else 'DIFFER'}")
        ok, err = check_quantize(x, f"M={M} K={K}")
        quant_err = max(quant_err, err)
        verdicts.append(ok)
        if not all(verdicts):
            fail(f"an int8 kernel differs from its plain version or is not "
                 f"bit-stable at M={M} K={K} N={N}")

    timings = {}
    for M, K, N in Q8_PROJ:
        xq, xs, wq, ws, bias, x, wb, bb = _q8_inputs(torch, q8, M, K, N, 1)
        wt, xs2, ws2 = wq.t(), xs.reshape(M, 1), ws.reshape(1, N)
        modes = {}
        for mode, dt in (("bf16+bias", bf16), ("f32", f32)):
            if dt is f32:
                def launch():
                    return q8.int8_matmul_cuda(xq, xs, wq, ws)

                def plain_fn():
                    return q8.int8_matmul_plain(xq, xs, wq, ws)

                def lib_fn():
                    return torch._int_mm(xq, wt).float() * xs2 * ws2
                out_bytes = 4 * M * N
            else:
                def launch():
                    return q8.int8_linear_cuda(xq, xs, wq, ws, bias, bf16)

                def plain_fn():
                    return q8.int8_linear_plain(xq, xs, wq, ws, bias, bf16)

                def lib_fn():
                    return ((torch._int_mm(xq, wt).float() * xs2 * ws2 + bias)
                            .to(bf16))
                out_bytes = 2 * M * N + 4 * N
            t = dict(ms=time_ms(torch, launch),
                     plain_ms=time_ms(torch, plain_fn, reps=5))
            try:
                t["library_ms"] = time_ms(torch, lib_fn)
            except RuntimeError as exc:   # a yardstick only: report, go on
                t["library_ms"] = None
                say(f"timing q8_matmul {M}x{K}x{N}: torch._int_mm refused "
                    f"the shape ({exc}); library_ms null")
            # x, w in (int8), their scales in (f32), the output out
            t["bound_ms"], t["bound_by"] = _bound(
                M * K + N * K + 4 * (M + N) + out_bytes, 2 * M * N * K,
                peaks["bw"], peaks["int8"])
            t["device_ms"] = profile_kernels(
                torch, launch, ("q8_matmul",))["q8_matmul"]
            t["host_ms"] = less(t["ms"], t["device_ms"])
            modes[mode] = t
        t = modes["bf16+bias"]
        t["linear_bf16_ms"] = time_ms(torch, lambda: F.linear(x, wb, bb))
        t["f32_mode"] = modes["f32"]
        timings[(M, K, N)] = t
        for mode, m in modes.items():
            lib = ("null" if m["library_ms"] is None
                   else f"{m['library_ms']:.4f}")
            say(f"timing q8_matmul M={M} K={K} N={N} {mode}: kernel_ms="
                f"{m['ms']:.4f} (device ms {not_measured(m['device_ms'])}, "
                f"host ms per launch {not_measured(m['host_ms'])}) "
                f"plain_ms={m['plain_ms']:.4f} "
                f"library_ms(torch._int_mm + rescale"
                f"{' + bias + cast' if mode != 'f32' else ''})={lib} "
                f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']})"
                + (f" bf16 F.linear ms={t['linear_bf16_ms']:.4f}"
                   if mode != "f32" else ""))

    quant = {}
    for M, K in QUANT_SHAPES:
        gen = torch.Generator().manual_seed(M + K)
        x = (torch.randn((M, K), generator=gen) * 3).to("cuda", bf16)
        ok, err = check_quantize(x, f"M={M} K={K}")
        quant_err = max(quant_err, err)
        if not ok:
            fail(f"the row quantize differs from quantize_rowwise or is not "
                 f"bit-stable at M={M} K={K}")

        def launch():
            return q8.quantize_rowwise_cuda(x)

        t = dict(ms=time_ms(torch, launch),
                 plain_ms=time_ms(torch, lambda: q8.quantize_rowwise(x)),
                 library_ms=None)
        # x in (bf16), codes and a scale a row out; ~5 f32 operations an
        # element (abs, max, divide, round, clamp)
        t["bound_ms"], t["bound_by"] = _bound(
            2 * M * K + M * K + 4 * M, 5 * M * K, peaks["bw"], peaks["f32"])
        t["device_ms"] = profile_kernels(
            torch, launch,
            ("q8_quantize_rows_kernel",))["q8_quantize_rows_kernel"]
        t["host_ms"] = less(t["ms"], t["device_ms"])
        quant[(M, K)] = t
        say(f"timing q8_quantize_rows M={M} K={K} bf16: kernel_ms="
            f"{t['ms']:.4f} (device ms {not_measured(t['device_ms'])}, host "
            f"ms per launch {not_measured(t['host_ms'])}) plain_ms="
            f"{t['plain_ms']:.4f} "
            f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}); no library "
            f"call computes it")
    return timings, quant, max_err, quant_err


def _post(url: str, payload: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        f"{url}/v1/qa", data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}, time.perf_counter() - t0


def _serve_burst(torch, extra=()):
    """``config/serve.cfg`` with ``extra`` flags through the parsers,
    ``check_serve_flags``, ``compose.init_model`` and ``QAEngine``, then the
    10-request burst over HTTP. Launch counts are set to 0 just before the
    warmup and read just after the burst. Returns a namespace of what the
    checks read."""
    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.config.parser import (
        check_serve_flags, get_model_parser, get_params, get_serve_parser)
    from ml_recipe_tpu_torch.data import labels2id
    from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
    from ml_recipe_tpu_torch.serve.engine import QAEngine
    from ml_recipe_tpu_torch.serve.server import QAServer
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    label = " ".join(extra) or "bf16"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(REPO / "config" / "serve.cfg"), "--vocab_file", vocab,
         "--port", "0", *extra])
    check_serve_flags(params, model_params)
    t0 = time.perf_counter()
    model, tokenizer = init_model(model_params, checkpoint=params.checkpoint,
                                  quantize=params.quantize)
    say(f"serving ({label}): {model_params.model} {model.cfg.num_layers} "
        f"layers hidden {model.cfg.hidden_size} {model.dtype} on "
        f"{model.device}, LayerNorm {model.ln_impl}, quantize "
        f"{model.quantize}, built in {time.perf_counter() - t0:.1f}s")
    if model.cfg.num_layers != 12 or model.dtype != torch.bfloat16:
        fail("the serving configuration is not bert-base in bf16")
    engine = QAEngine(
        model, tokenizer, grid=BucketGrid.from_spec(params.buckets),
        max_batch_delay_ms=params.max_batch_delay_ms,
        queue_size=params.queue_size,
        max_question_len=params.max_question_len,
        doc_stride=params.doc_stride,
        long_scatter_chunks=params.long_scatter_chunks,
    )

    rng = np.random.default_rng(1)

    def words(n):  # whole-word tokens of the synthetic vocab, some tags
        ids = rng.integers(1, 7000, n)
        ws = [f"tok{4 * i + 1}" for i in ids]
        for pos in range(0, n, 50):
            ws[pos] = "<P>"
        return " ".join(ws)

    requests = ([(words(8), words(60)) for _ in range(6)]        # seq 128
                + [(words(10), words(300)) for _ in range(3)]    # seq 384
                + [(words(12), words(4700))])                    # 35+ chunks

    # record which (seq, rows) batches the batcher launches, and the host
    # time of each (its packed output is fetched, so the device is done)
    seen, batch_ms = [], []
    run_batch = engine.batcher._run_fn

    def recording(seq, works):
        seen.append((seq, len(works)))
        t = time.perf_counter()
        run_batch(seq, works)
        batch_ms.append(round((time.perf_counter() - t) * 1e3, 2))

    engine.batcher._run_fn = recording

    zero_counts()                   # the main path starts here
    warm = engine.warmup()
    server = QAServer(engine, host=params.host, port=params.port,
                      request_timeout_s=params.request_timeout_s,
                      drain_timeout_s=params.drain_timeout_s)
    server.start()
    url = f"http://{server.host}:{server.port}"
    results = [None] * len(requests)

    def worker(i):
        q, d = requests[i]
        results[i] = _post(url, {"question": q, "document": d})

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = counts()             # the main path ends here
    batches = int(engine.m_batches.value)
    metrics = engine.render_metrics()
    server.stop()
    server.shutdown()

    if any(t.is_alive() for t in threads):
        fail("a request thread did not finish")
    lat = []
    for i, (status, body, seconds) in enumerate(results):
        if status != 200 or body.get("label") not in labels2id:
            fail(f"request {i} answered {status}: {body}")
        lat.append(seconds * 1e3)
    n_chunks = sum(r[1]["n_chunks"] for r in results)
    device_batches = len(warm["buckets"]) + batches
    say(f"serving ({label}): {len(results)} requests ({n_chunks} chunks) "
        f"answered 200 in {wall:.2f}s; {batches} traffic batches (seq, rows) "
        f"{seen} taking {batch_ms} ms + {len(warm['buckets'])} warmup "
        f"batches; warmup seconds {warm['bucket_seconds']}")
    say(f"serving ({label}): request latency ms p50="
        f"{statistics.median(lat):.1f} p95={np.percentile(lat, 95):.1f} "
        f"max={max(lat):.1f}")
    if len(seen) != batches or (384, 32) not in seen or \
            {seq for seq, _ in seen} != {128, 384}:
        fail("traffic did not reach both seq buckets and a full 32-row batch")
    return SimpleNamespace(model=model, tokenizer=tokenizer, engine=engine,
                           params=params, requests=requests, counts=launched,
                           device_batches=device_batches, warm=warm,
                           metrics=metrics)


def _full_batch_ids(tokenizer, requests, params):
    """One full 32x384 batch: the first 32 windows of the long request."""
    from ml_recipe_tpu_torch.quant import make_parity_batches

    question, document = requests[-1]
    ids = make_parity_batches(
        tokenizer, [{"question_text": question, "document_text": document}],
        max_seq_len=384, max_question_len=params.max_question_len,
        doc_stride=params.doc_stride, batch_size=32, limit=32)[0]["input_ids"]
    # a document of fewer windows fills the batch by repeating its last
    if (ids[-1] == ids[-2]).all():
        fail("the long document windows into fewer than 32 chunks")
    return ids


def phase_serving(torch, fa, kernel_ms):
    """The serving path at full width. ``kernel_ms``: the kernel's time at
    32x384, for the forward's breakdown. Returns the attention launch
    count, the burst's namespace, the 32x384 batch and its forward ms."""
    from ml_recipe_tpu_torch.infer.score import OUT_KEYS

    burst = _serve_burst(torch)
    model, tokenizer, engine = burst.model, burst.tokenizer, burst.engine
    launched = burst.counts
    launches = launched["fused_attention_fwd"]
    device_batches = burst.device_batches
    layers = model.cfg.num_layers
    say(f"serving: attention launches={launches}, expected {layers} x "
        f"{device_batches} device batches = {layers * device_batches}; "
        f"launch counts {launched}")
    if launches != layers * device_batches:
        fail(f"attention launch count is not {layers} per device batch")
    if any(n for k, n in launched.items() if k != "fused_attention_fwd"):
        fail("the bf16 serving path launched a kernel other than the "
             "attention forward")

    # one full 32x384 batch, kernel attention vs plain attention
    ids = _full_batch_ids(tokenizer, burst.requests, burst.params)
    seps = (ids == tokenizer.sep_token_id).astype(np.int32)
    tt = np.clip(np.cumsum(seps, axis=-1) - seps, 0, 1)
    attn = [m for m in model.modules() if hasattr(m, "attention_impl")]

    def run(impl):
        for m in attn:
            m.attention_impl = impl
        try:
            packed = engine.run_packed({"input_ids": ids})
            with torch.inference_mode():
                preds = model(
                    torch.from_numpy(ids).long().cuda(),
                    torch.from_numpy(ids != tokenizer.pad_token_id).int().cuda(),
                    torch.from_numpy(tt).long().cuda())
        finally:
            for m in attn:
                m.attention_impl = "auto"
        return packed, {k: v.float().cpu().numpy() for k, v in preds.items()}

    before = fa.KERNEL.launches
    out_k, preds_k = run("auto")
    out_p, _ = run("xla")
    if fa.KERNEL.launches - before != 2 * layers:
        fail("the kernel-vs-plain batch did not route as asked")
    rows = {k: i for i, k in enumerate(OUT_KEYS)}
    score_err = float(np.abs(out_k[rows["scores"]] - out_p[rows["scores"]]).max())

    def margin(x):
        top2 = np.sort(x, axis=-1)[:, -2:]
        return top2[:, 1] - top2[:, 0]

    checked = 0
    for key, logits in (("start_ids", "start_class"), ("end_ids", "end_class"),
                        ("labels", "cls")):
        sure = margin(preds_k[logits]) > SCORE_ATOL
        same = out_k[rows[key]] == out_p[rows[key]]
        if not same[sure].all():
            fail(f"{key} differ between kernel and plain attention where the "
                 f"top-2 margin exceeds {SCORE_ATOL}")
        checked += int(sure.sum())
    say(f"serving: 32x384 batch kernel-vs-plain attention: score max_abs_err="
        f"{score_err:.4f} (tol {SCORE_ATOL}), {checked} of 96 span/label "
        f"argmaxes past the margin all equal")
    if not score_err <= SCORE_ATOL:
        fail("packed scores differ between kernel and plain attention")
    if not np.isfinite(out_k).all():
        fail("packed output not finite")

    # where the time of one full batch goes: the scoring forward with the
    # kernel's attention and with the plain attention
    wire = engine._wire_pack({"input_ids": ids})
    forward_ms = {}
    for impl in ("auto", "xla"):
        for m in attn:
            m.attention_impl = impl
        with torch.inference_mode():
            forward_ms[impl] = time_ms(torch, lambda: engine._score(wire), reps=10)
    for m in attn:
        m.attention_impl = "auto"
    say(f"serving: 32x384 scoring forward ms={forward_ms['auto']:.3f} with the "
        f"kernel ({layers * kernel_ms:.3f} ms of it in {layers} attention "
        f"launches, {layers * kernel_ms / forward_ms['auto']:.1%}); "
        f"{forward_ms['xla']:.3f} with the plain attention")
    profile_forward(torch, lambda: engine._score(wire), "serving")
    return launches, burst, ids, forward_ms["auto"]


@contextmanager
def _plain_q8_passes():
    """Counts of the plain int8 quantize, product and epilogue passes run
    inside the block (by name); the int8 path runs none on the card."""
    from ml_recipe_tpu_torch.ops import quant_matmul as q8

    calls = dict.fromkeys(("quantize_rowwise", "int8_matmul_plain",
                           "int8_linear_plain"), 0)
    originals = {n: getattr(q8, n) for n in calls}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in calls:
        setattr(q8, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(q8, name, fn)


def phase_int8_serving(torch, bf16, ids, bf16_forward_ms):
    """int8 serving with the fused LayerNorm: phase_serving's burst with
    ``--quantize int8 --ln_impl fused``; ``bf16`` is phase_serving's burst
    (the same seeded weights unquantized), ``ids`` its 32x384 batch and
    ``bf16_forward_ms`` that batch's scoring forward. Returns the launch
    counts of the path."""
    from ml_recipe_tpu_torch.quant import make_parity_batches, span_parity

    # count the plain quantize, product, bias and cast passes the burst
    # runs: on the card, none
    with _plain_q8_passes() as plain_calls:
        burst = _serve_burst(torch, ("--quantize", "int8", "--ln_impl",
                                     "fused"))
    say(f"serving (int8): plain passes on the card during the burst "
        f"{plain_calls}")
    if any(plain_calls.values()):
        fail("int8 serving ran a plain quantize, product or epilogue pass")
    model, engine, launched = burst.model, burst.engine, burst.counts
    db, layers = burst.device_batches, model.cfg.num_layers
    want = {"fused_attention_fwd": layers * db,
            "q8_matmul": Q8_PER_FORWARD * db,
            "layer_norm_fwd": LN_PER_FORWARD * db,
            "q8_quantize": QUANT_PER_FORWARD * db,
            "fused_attention_bwd": 0, "layer_norm_bwd": 0}
    say(f"serving (int8): launch counts {launched}, expected {want} ({db} "
        f"device batches x {layers} attention, {Q8_PER_FORWARD} int8 matmul,"
        f" {LN_PER_FORWARD} LayerNorm with their codes, {QUANT_PER_FORWARD} "
        f"row quantize)")
    if launched != want:
        fail("int8 serving launch counts do not match the path")
    if (model.quantize, model.ln_impl) != ("int8", "fused") or \
            burst.warm["quantize"] != "int8":
        fail("the int8 serving model is not quantized with the fused LN")
    line = [m for m in burst.metrics.splitlines()
            if m.startswith("qa_weight_bytes ")]
    say(f"serving (int8): {line[0] if line else 'no qa_weight_bytes'}, "
        f"warmup quant_mem_bytes {burst.warm['quant_mem_bytes']} against "
        f"{bf16.warm['quant_mem_bytes']} in bf16")
    if 'precision="int8"' not in burst.metrics or \
            burst.warm["quant_mem_bytes"] >= bf16.warm["quant_mem_bytes"]:
        fail("/metrics does not report the int8 precision and its weights")

    wire = engine._wire_pack({"input_ids": ids})
    with torch.inference_mode():
        packed = engine._score(wire).float().cpu().numpy()
        forward_ms = time_ms(torch, lambda: engine._score(wire), reps=10)
    if not np.isfinite(packed).all():
        fail("int8 packed output not finite")
    say(f"serving (int8): 32x384 scoring forward ms={forward_ms:.3f} against "
        f"{bf16_forward_ms:.3f} in bf16 (x{forward_ms / bf16_forward_ms:.2f})")
    profile_forward(torch, lambda: engine._score(wire), "serving (int8)")

    lines = [{"question_text": q, "document_text": d}
             for q, d in burst.requests]
    batches = make_parity_batches(
        burst.tokenizer, lines, max_seq_len=384,
        max_question_len=burst.params.max_question_len,
        doc_stride=burst.params.doc_stride, batch_size=32, limit=96)
    parity = span_parity(bf16.model, model, batches)
    say(f"serving (int8): span parity with bf16 (recorded, not a gate): "
        f"{json.dumps(parity)}")
    return launched


def _run_training(torch, cfg: str, extra=()):
    """``config/<cfg>`` (or the cfg file at the path ``cfg``) with ``extra``
    flags through the trainer and model parsers, ``check_train_flags`` and the build and train sequence of
    ``ml_recipe_tpu_torch.cli.train``. The launch counts are set to 0 just
    before ``train`` and read just after. Returns the trainer, the trainer
    flags, every kernel's launch count and the wall seconds."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        check_train_flags, get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    cfg_path = cfg if isinstance(cfg, Path) else REPO / "config" / cfg
    cfg = cfg_path.name
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        ["-c", str(cfg_path), "--vocab_file", vocab,
         "--dump_dir", str(OUT_DIR / "results"), *extra])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    check_train_flags(params, model_params)
    t0 = time.perf_counter()
    trainer = train_cli.build_trainer(params, model_params)
    model = trainer.model
    say(f"training {cfg}: {model_params.model} {model.cfg.num_layers} layers "
        f"hidden {model.cfg.hidden_size} compute {model.dtype} params "
        f"{next(model.parameters()).dtype} on {model.device}, batch "
        f"{params.train_batch_size} = {params.batch_split} x "
        f"{params.train_batch_size // params.batch_split} x "
        f"{params.max_seq_len}; built in {time.perf_counter() - t0:.1f}s "
        f"(of it {trainer.plan_seconds:.2f}s planning "
        f"{trainer.planned_steps_per_epoch} steps/epoch over the training "
        f"items)")
    if (model.cfg.num_layers != 12 or model.dtype != torch.bfloat16
            or any(p.dtype != torch.float32 for p in model.parameters())):
        fail(f"the {cfg} training configuration is not bert-base with bf16 "
             f"compute and f32 master weights")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    zero_counts()                   # the main path starts here
    t0 = time.perf_counter()
    train_cli.train(trainer, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()             # the main path ends here
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in model.named_parameters())
    say(f"training {cfg} {' '.join(extra)}: {moved} of {len(before)} "
        f"parameter tensors changed; launch counts {launched}")
    if moved == 0:
        fail("no parameter changed after two steps")
    return trainer, params, launched, wall


def _micro_batch(torch, trainer, rows: int):
    """``fwd_bwd(impl="auto", seed=0)``: one micro-batch of ``rows`` dummy
    items through the model's forward, the loss and backward, dropout drawn
    from a generator seeded with ``seed``, attention by ``impl``."""
    model = trainer.model
    items = [trainer.train_dataloader.dataset[i] for i in range(rows)]
    inputs, labels = trainer.collate_fun(items)[:2]
    inputs = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}
    labels = {k: torch.from_numpy(v).cuda() for k, v in labels.items()}
    params_t = list(model.parameters())
    attn = [m for m in model.modules() if hasattr(m, "attention_impl")]

    def fwd_bwd(impl="auto", seed=0):
        for m in attn:
            m.attention_impl = impl
        for p in params_t:
            p.grad = None
        gen = torch.Generator(device="cuda").manual_seed(seed)
        preds = model(**trainer._model_inputs(inputs), generator=gen)
        total, _ = trainer.loss(preds, labels)
        total.backward()

    return fwd_bwd


def phase_training(torch, fa):
    """The training path at full width; returns the forward and backward
    launch counts of the training run."""
    from ml_recipe_tpu_torch.train.checkpoint import read_state

    trainer, params, launched, wall = _run_training(torch, "test_bert.cfg")
    fwd = launched["fused_attention_fwd"]
    bwd = launched["fused_attention_bwd"]
    model = trainer.model
    layers = model.cfg.num_layers
    micro = len(trainer.history) * params.batch_split
    say(f"training: {len(trainer.history)} steps + {trainer.eval_batches} eval "
        f"batches in {wall:.1f}s; step wall seconds "
        f"{[round(h['seconds'], 3) for h in trainer.history]}; lr "
        f"{[h['lr'] for h in trainer.history]}; loss "
        f"{[round(h['loss'], 4) for h in trainer.history]}")
    say(f"training: attention launches forward={fwd} (expected {layers} x "
        f"({micro} micro-batches + {trainer.eval_batches} eval batches) = "
        f"{layers * (micro + trainer.eval_batches)}), backward={bwd} "
        f"(expected {layers} x {micro} = {layers * micro})")
    if len(trainer.history) != 2 or micro != 16:
        fail("the debug run did not take 2 steps of 8 micro-batches")
    if bwd != layers * micro or fwd != layers * (micro + trainer.eval_batches):
        fail("attention launch counts do not match the training path")
    if any(launched[k] for k in ("layer_norm_fwd", "layer_norm_bwd",
                                 "q8_matmul", "q8_quantize")):
        fail("the ln_impl=xla training path launched a LayerNorm or int8 "
             "kernel")
    if not all(np.isfinite(v) for h in trainer.history for k, v in h.items()
               if k not in ("step", "rows", "seconds")):
        fail("a training loss is not finite")
    if trainer.eval_batches != 22:
        fail(f"expected 2 x 11 debug eval batches, ran {trainer.eval_batches}")

    # one 32x512 micro-batch: device time of forward+backward, split by kernel
    params_t = list(model.parameters())
    attn = [m for m in model.modules() if hasattr(m, "attention_impl")]
    fwd_bwd = _micro_batch(torch, trainer, TRAIN_SHAPE[0])
    model.train()
    step_ms = time_ms(torch, fwd_bwd, reps=5, warm=2)
    split = profile_fwd_bwd(torch, fwd_bwd, "training")
    say(f"training: one 32x512 micro-batch forward+backward device ms="
        f"{step_ms:.3f}: {_split_text(step_ms, split)} (from a torch.profiler "
        f"trace; layer_norm: PyTorch's LayerNorm kernels of ln_impl=xla, "
        f"without the f32 casts around them; rest: the device idle between "
        f"kernels)")

    # its gradients with kernel attention vs plain attention (same dropout)
    flat = []
    for impl in ("auto", "xla"):
        fwd_bwd(impl, seed=7)
        flat.append(torch.cat([p.grad.float().reshape(-1) for p in params_t]))
    for m in attn:
        m.attention_impl = "auto"
    for p in params_t:
        p.grad = None
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    say(f"training: 32x512 micro-batch gradient, kernel vs plain attention: "
        f"relative L2 error {rel:.3e} (tol {TRAIN_GRAD_REL_TOL:g})")
    if not (np.isfinite(rel) and rel <= TRAIN_GRAD_REL_TOL):
        fail("kernel and plain attention gradients disagree")
    del flat

    # one checkpoint with debug off, read back
    trainer.debug = False
    path = OUT_DIR / "results" / "smoke.ch"
    t0 = time.perf_counter()
    trainer.save_state_dict(path)
    save_s = time.perf_counter() - t0
    state = read_state(path)
    ok = (state["global_step"] == 2 and state["optimizer"] is not None
          and int(state["optimizer"]["0"]["0"]["count"]) == 2
          and f"layer_{layers - 1}" in state["model"]["transformer"])
    say(f"training: checkpoint {path.stat().st_size} bytes written in "
        f"{save_s:.1f}s and read back: global_step {state['global_step']} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the checkpoint did not read back")
    path.unlink()
    return fwd, bwd, step_ms, split


def phase_ln_training(torch, xla_ms, xla_split):
    """``config/test_bert.cfg --ln_impl fused`` at full width: the counts of
    the LayerNorm pair and the attention pair, one 32x512 micro-batch split
    by kernel beside the ``ln_impl=xla`` one (``xla_ms``, ``xla_split``) and
    its gradients with the LayerNorm kernels against their plain version.
    Returns the launch counts of the path."""
    from ml_recipe_tpu_torch.models.encoder import FusedLayerNorm

    trainer, params, launched, wall = _run_training(
        torch, "test_bert.cfg", ["--ln_impl", "fused"])
    model = trainer.model
    layers = model.cfg.num_layers
    micro = len(trainer.history) * params.batch_split
    evals = trainer.eval_batches
    want = {"fused_attention_fwd": layers * (micro + evals),
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": LN_PER_FORWARD * (micro + evals),
            "layer_norm_bwd": LN_PER_FORWARD * micro, "q8_matmul": 0,
            "q8_quantize": 0}
    say(f"training --ln_impl fused: {len(trainer.history)} steps + {evals} "
        f"eval batches in {wall:.1f}s; step wall seconds "
        f"{[round(h['seconds'], 3) for h in trainer.history]}; loss "
        f"{[round(h['loss'], 4) for h in trainer.history]}; launch counts "
        f"{launched}, expected {want} ({LN_PER_FORWARD} LayerNorm per forward "
        f"x ({micro} micro-batches + {evals} eval batches), backward x "
        f"{micro})")
    lns = [m for m in model.modules() if isinstance(m, FusedLayerNorm)]
    if len(lns) != LN_PER_FORWARD or micro != 16 or evals != 22:
        fail("the fused-LayerNorm run is not test_bert.cfg's 2 debug steps "
             "with 25 fused LayerNorms")
    if launched != want:
        fail("launch counts do not match the fused-LayerNorm training path")
    if not all(np.isfinite(v) for h in trainer.history for k, v in h.items()
               if k not in ("step", "rows", "seconds")):
        fail("a fused-LayerNorm training loss is not finite")

    params_t = list(model.parameters())
    fwd_bwd = _micro_batch(torch, trainer, TRAIN_SHAPE[0])
    model.train()
    step_ms = time_ms(torch, fwd_bwd, reps=5, warm=2)
    split = profile_fwd_bwd(torch, fwd_bwd, "training --ln_impl fused")
    say(f"training --ln_impl fused: one 32x512 micro-batch forward+backward "
        f"device ms={step_ms:.3f}: {_split_text(step_ms, split)}; with "
        f"ln_impl=xla {xla_ms:.3f}: {_split_text(xla_ms, xla_split)} (from "
        f"torch.profiler traces)")

    # its gradients, LayerNorm kernels vs their plain version (same dropout)
    flat = []
    for impl in ("fused", "xla"):
        for m in lns:
            m.impl = impl
        fwd_bwd(seed=7)
        flat.append(torch.cat([p.grad.float().reshape(-1) for p in params_t]))
    for m in lns:
        m.impl = "fused"
    for p in params_t:
        p.grad = None
    rel = ((flat[0] - flat[1]).norm() / flat[1].norm()).item()
    say(f"training --ln_impl fused: 32x512 micro-batch gradient, LayerNorm "
        f"kernels vs plain: relative L2 error {rel:.3e} (tol "
        f"{LN_GRAD_REL_TOL:g})")
    if not (np.isfinite(rel) and rel <= LN_GRAD_REL_TOL):
        fail("LayerNorm kernel and plain gradients disagree")
    del flat, trainer, model, fwd_bwd
    torch.cuda.empty_cache()
    return launched


def _split_ids(torch, rng, seg, B, L):
    """``seg`` followed by another block's segment ids: the [B, 2L] plane
    of a ``seg_split`` call."""
    other = np.zeros((B, L), np.int32)
    for b in range(B - 1):
        c1, c2 = sorted(rng.choice(np.arange(1, L), 2, replace=False))
        other[b, :c1], other[b, c1:c2] = 2, 3
    return torch.cat([seg, torch.from_numpy(other).cuda()], dim=1).contiguous()


def _bwd_check(torch, got, ref, tname):
    """``(ok, errs, tols, rels)`` of dq, dk, dv against their plain values
    (the limits of phase_bwd_kernel)."""
    errs, tols, rels = [], [], []
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            return False, [math.inf] * 3, [0.0] * 3, [math.inf] * 3
        errs.append((a - b).abs().max().item())
        rels.append(((a - b).norm() / b.norm()).item())
        top = b.abs().max().item()
        tols.append(BWD_BF16_STEPS * bf16_step(top) if tname == "bf16"
                    else BWD_ATOL_F32)
    ok = all(e <= t and r <= BWD_REL_L2 for e, t, r in zip(errs, tols, rels))
    return ok, errs, tols, rels


BWD_KERNELS = ("fused_attention_bwd_row_term", "fused_attention_bwd_dkdv",
               "fused_attention_bwd_dq")


def _bwd_split(torch, fa, args) -> dict:
    """The backward launch's device time by its three kernels, their sum
    against the launch's device span (``split_of_span``)."""
    split, span = profile_split(
        torch, lambda: fa.fused_attention_bwd_cuda(*args), BWD_KERNELS)
    if split is None:
        return dict(split_ms=None, device_ms=None, split_of_span=None)
    return dict(split_ms=split, device_ms=span,
                split_of_span=sum(split.values()) / span)


def _split_line(t: dict) -> str:
    if t["split_ms"] is None:
        return "device ms by kernel not measured"
    return (f"device ms by kernel {t['split_ms']}, together "
            f"{t['split_of_span']:.1%} of the launch's device span "
            f"{t['device_ms']:.4f} ms")


def phase_long_kernels(torch, fa, bw, flops):
    """Both kernels against their plain versions past 512, then timings at
    each regime's shape; returns ``(timings, fwd max err, bwd max err)``."""
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    max_fwd = max_bwd = 0.0
    runs = [(B, L, dt, tn, {}) for B, L in LONG_SHAPES
            for dt, tn in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))]
    runs += [(2, 1024, dt, tn, OFFSETS)
             for dt, tn in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))]
    for B, L, dtype, tname, coords in runs:
        q, k, v, mask, seg, seeds = _attention_inputs(torch, fa, rng, B, L,
                                                      dtype)
        g = torch.from_numpy(rng.standard_normal(
            (B, L, H, D), dtype=np.float32)).to("cuda", dtype)
        cases = CASES
        if coords:   # a block of a longer sequence: split q/k ids
            seg = _split_ids(torch, rng, seg, B, L)
            cases = [("mask+dropout", dict(rate=TRAIN_RATE)),
                     ("seg_split+dropout", dict(segmented=True,
                                                rate=TRAIN_RATE))]
        for case, kw in cases:
            segmented = kw.get("segmented", False)
            m = seg if segmented else mask
            kw = dict(rate=kw.get("rate", 0.0), segmented=segmented,
                      seg_split=bool(coords) and segmented, **coords)
            sd = seeds if kw["rate"] else None
            out, lse = fa.fused_attention_cuda(q, k, v, m, sd, want_lse=True,
                                               **kw)
            ref, ref_lse = fa.fused_attention_plain(q, k, v, m, sd,
                                                    want_lse=True, **kw)
            got_g = fa.fused_attention_bwd_cuda(q, k, v, g, ref, ref_lse, m,
                                                sd, **kw)
            ref_g = fa.fused_attention_bwd_plain(q, k, v, g, ref, ref_lse, m,
                                                 sd, **kw)
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(out.float()).all())
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok_f = finite and err <= ATOL[tname] and lse_err <= LSE_ATOL
            ok_b, errs, tols, rels = _bwd_check(torch, got_g, ref_g, tname)
            where = (f"B={B} L={L} H={H} D={D} {tname} {case}"
                     + (f" base={coords['base']} L_hash={coords['L_hash']}"
                        if coords else ""))
            say(f"kernel-vs-plain long {where}: forward max_abs_err="
                f"{err:.3e} (tol {ATOL[tname]:g}) lse_err={lse_err:.3e}; "
                f"backward dq/dk/dv max_abs_err {errs[0]:.3e} {errs[1]:.3e} "
                f"{errs[2]:.3e} (tol {tols[0]:.3e} {tols[1]:.3e} "
                f"{tols[2]:.3e}), rel_l2 {rels[0]:.2e} {rels[1]:.2e} "
                f"{rels[2]:.2e} (tol {BWD_REL_L2:g}) "
                f"{'ok' if ok_f and ok_b else 'FAIL'}")
            if not (ok_f and ok_b):
                fail(f"a kernel disagrees with its plain version at {where}")
            max_fwd, max_bwd = max(max_fwd, err), max(max_bwd, *errs)
            del out, lse, ref, ref_lse, got_g, ref_g
        del q, k, v, g, mask, seg, seeds
        torch.cuda.empty_cache()

    # timings: the training configuration (bf16, key mask, dropout 0.1)
    timings = {}
    for B, L in LONG_SHAPES:
        q, k, v, mask, _, seeds = _attention_inputs(torch, fa, rng, B, L,
                                                    torch.bfloat16)
        g = torch.from_numpy(rng.standard_normal(
            (B, L, H, D), dtype=np.float32)).to("cuda", torch.bfloat16)
        elems = B * L * H * D * q.element_size()
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        gt = g.transpose(1, 2)
        bool_mask = (mask > 0)[:, None, None, :]

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bool_mask, dropout_p=TRAIN_RATE)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), gt)

        with torch.no_grad():
            sdpa_fwd_ms = time_ms(torch, sdpa_fwd)
        fwd = dict(
            ms=time_ms(torch, lambda: fa.fused_attention_cuda(
                q, k, v, mask, seeds, TRAIN_RATE, want_lse=True)),
            plain_ms=time_ms(torch, lambda: fa.fused_attention_plain(
                q, k, v, mask, seeds, TRAIN_RATE, want_lse=True), reps=5),
            library_ms=sdpa_fwd_ms)
        n_bytes = 4 * elems + mask.numel() * 4 + B * 4 + B * H * L * 4
        fwd["bound_ms"], fwd["bound_by"] = _bound(
            n_bytes, 4 * B * H * L * L * D, bw, flops)
        out, lse = fa.fused_attention_cuda(q, k, v, mask, seeds, TRAIN_RATE,
                                           want_lse=True)
        args = (q, k, v, g, out, lse, mask, seeds, TRAIN_RATE, False)
        bwd = dict(
            ms=time_ms(torch, lambda: fa.fused_attention_bwd_cuda(*args)),
            plain_ms=time_ms(torch, lambda: fa.fused_attention_bwd_plain(
                *args), reps=3),
            library_ms=time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd))
        n_bytes = 8 * elems + B * H * L * 4 + mask.numel() * 4 + B * 4
        bwd["bound_ms"], bwd["bound_by"] = _bound(
            n_bytes, 10 * B * H * L * L * D, bw, flops)
        bwd.update(_bwd_split(torch, fa, args))
        for name, t in (("fused_attention_fwd", fwd),
                        ("fused_attention_bwd", bwd)):
            say(f"timing {name} {B}x{L}x{H}x{D} bf16 (rate 0.1"
                f"{', lse' if name.endswith('fwd') else ''}): kernel_ms="
                f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                f"library_ms(sdpa{' backward, fwd+bwd minus fwd' if name.endswith('bwd') else ''})"
                f"={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
                f"({t['bound_by']})"
                + (f"; {_split_line(t)}" if "split_ms" in t else ""))
        timings[(B, L)] = dict(fwd=fwd, bwd=bwd)
        del q, k, v, g, out, lse, args, qt, kt, vt, gt
        torch.cuda.empty_cache()
    return timings, max_fwd, max_bwd


def phase_long_training(torch):
    """config/long_context.cfg and its 4096 remat variant at full width;
    returns the launch counts of each run."""
    import gc
    import shutil

    from ml_recipe_tpu_torch.train.checkpoint import MANIFEST, read_state

    out = {}
    for label, extra in (("1024", ()), ("4096 remat", LONG_VARIANT)):
        trainer, params, launched, wall = _run_training(
            torch, LONG_CFG, ["--dummy_dataset", "--debug", *extra])
        fwd = launched["fused_attention_fwd"]
        bwd = launched["fused_attention_bwd"]
        model = trainer.model
        layers = model.cfg.num_layers
        remat = label.endswith("remat")
        micro = len(trainer.history) * params.batch_split
        per_micro = 2 * layers if remat else layers   # the recompute
        want_fwd = per_micro * micro + layers * trainer.eval_batches
        say(f"training {LONG_CFG} {label}: {len(trainer.history)} steps of "
            f"{params.batch_split} x {params.train_batch_size // params.batch_split}"
            f" x {params.max_seq_len} + {trainer.eval_batches} eval batches of "
            f"{params.test_batch_size} x {params.max_seq_len} in {wall:.1f}s; "
            f"step wall seconds "
            f"{[round(h['seconds'], 3) for h in trainer.history]}; loss "
            f"{[round(h['loss'], 4) for h in trainer.history]}")
        say(f"training {LONG_CFG} {label}: attention launches forward={fwd} "
            f"(expected {per_micro} x {micro} micro-batches + {layers} x "
            f"{trainer.eval_batches} eval batches = {want_fwd}), backward="
            f"{bwd} (expected {layers} x {micro} = {layers * micro})")
        want_seq = 4096 if remat else 1024
        if (params.max_seq_len != want_seq
                or model.cfg.max_position_embeddings != want_seq
                or model.transformer.remat != remat
                or not (params.shard_optimizer and trainer.sharded_checkpoint)
                or params.train_batch_size != (4 if remat else 128)):
            fail(f"{LONG_CFG} {label} did not build as configured")
        if len(trainer.history) != 2 or trainer.eval_batches != 22 or \
                micro != (4 if remat else 8):
            fail(f"{LONG_CFG} {label}: the debug run did not take 2 steps "
                 f"and 22 eval batches")
        if fwd != want_fwd or bwd != layers * micro:
            fail(f"attention launch counts do not match {LONG_CFG} {label}")
        if not all(np.isfinite(v) for h in trainer.history
                   for k, v in h.items() if k not in ("step", "rows",
                                                      "seconds")):
            fail(f"a {LONG_CFG} {label} training loss is not finite")
        out[label] = dict(fwd=fwd, bwd=bwd)

        rows = params.train_batch_size // params.batch_split
        fwd_bwd = _micro_batch(torch, trainer, rows)
        model.train()
        if not remat:
            # one 32x1024 micro-batch: device time, split by kernel
            step_ms = time_ms(torch, fwd_bwd, reps=5, warm=2)
            split = profile_fwd_bwd(torch, fwd_bwd,
                                    f"training {LONG_CFG} {label}")
            say(f"training {LONG_CFG} {label}: one {rows}x{want_seq} "
                f"micro-batch forward+backward device ms={step_ms:.3f}: "
                f"{_split_text(step_ms, split)} (from a torch.profiler "
                f"trace)")
            # one sharded checkpoint with debug off, read back
            trainer.debug = False
            path = OUT_DIR / "results" / "smoke_sharded.ch"
            t0 = time.perf_counter()
            trainer.save_state_dict(path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            state = read_state(path)
            read_s = time.perf_counter() - t0
            size = sum(f.stat().st_size for f in path.iterdir())
            ok = ((path / MANIFEST).exists() and state["global_step"] == 2
                  and int(state["optimizer"]["0"]["0"]["count"]) == 2
                  and f"layer_{layers - 1}" in state["model"]["transformer"])
            say(f"training {LONG_CFG} {label}: sharded checkpoint "
                f"{sorted(f.name for f in path.iterdir())} ({size} bytes) "
                f"written in {save_s:.1f}s and read back in {read_s:.1f}s: "
                f"global_step {state['global_step']} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail("the sharded checkpoint did not read back")
            shutil.rmtree(path)
            del state
        else:
            # one 2x4096 micro-batch, remat on and off: peak memory, time
            # and the gradients for one generator
            params_t = list(model.parameters())
            peak, flat, ms = {}, {}, {}
            for on in (True, False):
                model.transformer.remat = on
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                fwd_bwd(seed=7)
                torch.cuda.synchronize()
                peak[on] = torch.cuda.max_memory_allocated()
                flat[on] = torch.cat([p.grad.float().reshape(-1)
                                      for p in params_t]).cpu()
                ms[on] = time_ms(torch, fwd_bwd, reps=3, warm=1)
            model.transformer.remat = True
            for p in params_t:
                p.grad = None
            rel = ((flat[True] - flat[False]).norm()
                   / flat[False].norm()).item()
            same = bool(torch.equal(flat[True], flat[False]))
            say(f"training {LONG_CFG} {label}: one {rows}x{want_seq} "
                f"micro-batch, remat on / off: peak CUDA memory "
                f"{peak[True]} / {peak[False]} bytes, forward+backward "
                f"device ms {ms[True]:.3f} / {ms[False]:.3f}; gradients "
                f"{'bit-identical' if same else 'differ'}, relative L2 "
                f"{rel:.3e} (tol {REMAT_GRAD_REL_TOL:g})")
            if not (np.isfinite(rel) and rel <= REMAT_GRAD_REL_TOL):
                fail("remat changes the gradients")
            out[label].update(peak_on=peak[True], peak_off=peak[False])
            del flat
        del trainer, model, fwd_bwd
        gc.collect()
        torch.cuda.empty_cache()
    return out


# -- phase 10: the NQ corpus recipe ------------------------------------------

NQ_DOCS = 4096                     # documents of the synthetic NQ corpus
NQ_WORDS = (50, 6000)              # log-uniform document length, in words
NQ_GRID = (128, 256, 384, 512)     # test_bert.cfg's length_buckets=auto
NQ_LIMIT = 20                      # validate --limit: batches 0..20


def _bucket_hist(lengths) -> dict:
    """Counts of ``lengths`` by the smallest NQ_GRID bucket that holds them."""
    hist = dict.fromkeys(NQ_GRID, 0)
    for n in lengths:
        hist[next((g for g in NQ_GRID if n <= g), NQ_GRID[-1])] += 1
    return hist


@contextmanager
def _log_lines(logger_name: str, needle: str):
    """The messages of one logger that contain ``needle``, logged inside the
    block (the logger at INFO for its duration)."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if needle in msg:
                lines.append(msg)

    log, handler = logging.getLogger(logger_name), Keep(logging.INFO)
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield lines
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def phase_nq_corpus(torch):
    """Phase 10, step 1: a seeded NQ-schema corpus over the synthetic vocab,
    preprocessed into the train/test split; the chunk lengths of the test
    split (sentence chunks at 512, as training cuts them) by bucket."""
    import shutil

    from ml_recipe_tpu_torch.data.datasets import ChunkDataset
    from ml_recipe_tpu_torch.data.preprocessor import RawPreprocessor
    from ml_recipe_tpu_torch.data.synthetic import write_nq_corpus
    from ml_recipe_tpu_torch.tokenizer import (
        Tokenizer, write_synthetic_bert_vocab)

    nq = OUT_DIR / "nq"
    shutil.rmtree(nq, ignore_errors=True)
    nq.mkdir(parents=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    t0 = time.perf_counter()
    corpus = write_nq_corpus(nq / "corpus.jsonl", vocab, n_docs=NQ_DOCS,
                             seed=0, min_words=NQ_WORDS[0],
                             max_words=NQ_WORDS[1])
    write_s = time.perf_counter() - t0
    with open(corpus) as fh:
        words = [len(json.loads(line)["document_text"].split()) for line in fh]
    t0 = time.perf_counter()
    counter, _, (train_idx, _, test_idx, _) = RawPreprocessor(
        corpus, nq / "processed", clear=True)()
    pre_s = time.perf_counter() - t0
    say(f"nq corpus: {len(words)} documents, {corpus.stat().st_size} bytes, "
        f"words per document p0/p50/p90/p100 "
        f"{np.percentile(words, [0, 50, 90, 100]).astype(int).tolist()} "
        f"(tags included), written in {write_s:.1f}s; preprocessed in "
        f"{pre_s:.2f}s into {len(train_idx)} train / {len(test_idx)} test "
        f"documents; label counts {dict(sorted(counter.items()))}")
    if (len(words) != NQ_DOCS or len(train_idx) + len(test_idx) != NQ_DOCS
            or sorted(counter) != list(range(5))
            or max(counter.values()) - min(counter.values()) > 1):
        fail("the NQ corpus is not the 5 balanced classes asked for")

    tokenizer = Tokenizer("bert", vocab, lowercase=True)
    t0 = time.perf_counter()
    chunks = ChunkDataset(nq / "processed", tokenizer, test_idx,
                          max_seq_len=NQ_GRID[-1], max_question_len=64,
                          split_by_sentence=True, truncate=True, cache_size=0)
    lengths = [len(c.input_ids) for i in range(len(chunks)) for c in chunks[i]]
    hist = _bucket_hist(lengths)
    say(f"nq corpus: the test split's {len(lengths)} sentence chunks at "
        f"{NQ_GRID[-1]} by bucket {hist} ({len(lengths) / len(test_idx):.1f} "
        f"a document, the largest document {max(words)} words; "
        f"{time.perf_counter() - t0:.1f}s)")
    if not all(hist.values()) or max(lengths) > NQ_GRID[-1]:
        fail("the NQ chunks do not reach every length bucket")
    return SimpleNamespace(dir=nq, corpus=corpus, proc=nq / "processed",
                           vocab=vocab, test_docs=len(test_idx))


def _nq_cfg(nq) -> Path:
    """A copy of config/test_bert.cfg with ``dummy_dataset=False`` and the
    corpus paths: a ``store_true`` set in a cfg cannot be unset on the
    command line."""
    keys = {"dummy_dataset": "False", "data_path": str(nq.corpus),
            "processed_data_path": str(nq.proc)}
    out = []
    for line in (REPO / "config" / "test_bert.cfg").read_text().splitlines():
        key = line.split("=", 1)[0].strip()
        out.append(f"{key}={keys.pop(key)}" if key in keys else line)
    if keys:
        fail(f"config/test_bert.cfg has no {sorted(keys)}")
    path = nq.dir / "test_bert_nq.cfg"
    path.write_text("\n".join(out) + "\n")
    return path


def phase_nq_training(torch, nq):
    """Phase 10, step 2: the copied test_bert.cfg on the corpus through the
    training sequence of phase 4, then ``last.ch`` saved (a debug run writes
    none). Returns the run's launch counts, final "Test metrics" and paths."""
    import gc

    cfg = _nq_cfg(nq)
    with _log_lines("ml_recipe_tpu_torch.train.trainer",
                    "Test metrics after epoch") as lines:
        trainer, params, launched, wall = _run_training(
            torch, cfg, ["--seed", "0", "--experiment_name", "nq"])
    model, loader = trainer.model, trainer.train_dataloader
    layers = model.cfg.num_layers
    micro = len(trainer.history) * params.batch_split
    want = dict.fromkeys(KERNELS, 0)
    want.update(fused_attention_fwd=layers * (micro + trainer.eval_batches),
                fused_attention_bwd=layers * micro)
    seq_of = {rows: seq for seq, rows in loader.batch_sizes.items()}
    steps = [(seq_of.get(h["rows"]), h["rows"]) for h in trainer.history]
    items = _bucket_hist(m[0] for m in loader._len_cache.values())
    say(f"nq training: {len(trainer.history)} steps + {trainer.eval_batches} "
        f"eval batches in {wall:.1f}s; step wall seconds "
        f"{[round(h['seconds'], 3) for h in trainer.history]}; (seq, rows) "
        f"of each step {steps}; planned {trainer.planned_steps_per_epoch} "
        f"steps/epoch in {trainer.plan_seconds:.1f}s over {len(loader._len_cache)} "
        f"sampled items, by bucket {items}; per-bucket batches "
        f"{loader.batch_sizes}; loss {[round(h['loss'], 4) for h in trainer.history]}")
    say(f"nq training: launch counts {launched}, expected {want} ({layers} x "
        f"({micro} micro-batches + {trainer.eval_batches} eval batches) "
        f"forward, {layers} x {micro} backward)")
    if len(trainer.history) != 2 or None in [s for s, _ in steps]:
        fail("the NQ debug run did not take 2 bucketed steps")
    if launched != want:
        fail("NQ training launch counts do not match the path")
    if not all(np.isfinite(v) for h in trainer.history for k, v in h.items()
               if k not in ("step", "rows", "seconds")):
        fail("an NQ training loss is not finite")
    if len(lines) != 2:
        fail(f"expected 2 'Test metrics' lines, got {len(lines)}")
    trainer.debug = False
    ckpt = params.dump_dir / params.experiment_name / "last.ch"
    trainer.save_state_dict(ckpt)
    out = SimpleNamespace(cfg=cfg, ckpt=ckpt, final=lines[-1].split(" - ", 1)[1],
                          launched=launched, eval_batches=trainer.eval_batches,
                          test_batch_size=params.test_batch_size)
    say(f"nq training: final {lines[-1]}; {ckpt.name} saved "
        f"({ckpt.stat().st_size} bytes)")
    del trainer, model, loader
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _nq_best(dump) -> dict:
    """Per document, the candidate the predictor's rules keep from its
    per-chunk outputs (a valid span, a score not below the best so far)."""
    best = {}
    for scores, starts, ends, labels, items in dump:
        for r, item in enumerate(items):
            start, end = int(starts[r]), int(ends[r])
            if start > end or start < item.question_len + 2:
                continue
            if float(scores[r]) >= best.get(item.item_id, (0.0,))[0]:
                best[item.item_id] = (float(scores[r]), start, end,
                                      int(labels[r]))
    return best


def _nq_kernel_vs_plain(torch, predictor):
    """One full 16x512 validation batch. The gate: each layer's attention,
    on the q, k, v and key mask this batch gives it, kernel against the
    plain version at ATOL (the kernel at the path's own tiles and padding).
    Recorded beside it, not a gate: the whole batch scored with the plain
    attention, and with a planted fault (keys 64..127 dropped in every
    layer's kernel call), each against the kernel's scores: 12 post-LN
    layers carry attention's bf16 rounding into the scores, so the two
    readings say how far an end-to-end limit could separate a fault.
    Returns the batch's scoring forward ms, timed alone."""
    from ml_recipe_tpu_torch.infer.score import OUT_KEYS
    from ml_recipe_tpu_torch.models import encoder
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    items = next(d[-1] for d in predictor.dump
                 if len(d[-1]) == predictor.batch_size)
    inputs = predictor.collate_fun(items)[0]
    wire = predictor._wire(inputs).cuda()
    model = predictor.model
    attn = [m for m in model.modules() if hasattr(m, "attention_impl")]
    dpa = encoder.dot_product_attention
    seen = []

    def run(impl, drop_keys=False, keep=False):
        def attention(q, k, v, mask, **kw):
            if keep:
                seen.append((q.clone(), k.clone(), v.clone(), mask.clone()))
            if drop_keys:
                mask = mask.clone()
                mask[:, 64:128] = 0
            return dpa(q, k, v, mask, **kw)

        encoder.dot_product_attention = attention
        for m in attn:
            m.attention_impl = impl
        try:
            with torch.inference_mode():
                return predictor._score(wire).float().cpu().numpy()
        finally:
            encoder.dot_product_attention = dpa
            for m in attn:
                m.attention_impl = "auto"

    out_k = run("auto", keep=True)
    layers = list(seen)
    seen.clear()
    errs, top = [], 0.0
    with torch.inference_mode():
        for q, k, v, mask in layers:
            got = fa.fused_attention_cuda(q, k, v, mask)
            ref = fa.fused_attention_plain(q, k, v, mask)
            errs.append((got.float() - ref.float()).abs().max().item())
            top = max(top, ref.float().abs().max().item())
    torch.cuda.synchronize()
    del layers
    out_p = run("xla")
    out_f = run("auto", drop_keys=True)
    rows = {k: i for i, k in enumerate(OUT_KEYS)}
    ids = [rows[k] for k in ("start_ids", "end_ids", "labels")]

    def gap(other):
        return (float(np.abs(out_k[rows["scores"]]
                             - other[rows["scores"]]).max()),
                int((out_k[ids] == other[ids]).sum()))

    (sound, same_p), (fault, same_f) = gap(out_p), gap(out_f)
    n_ids = len(ids) * len(items)
    with torch.inference_mode():
        forward_ms = time_ms(torch, lambda: predictor._score(wire), reps=10)
    shape = f"{len(items)}x{inputs['input_ids'].shape[1]}"
    say(f"validate: one {shape} batch, each of its {len(errs)} attention "
        f"calls kernel vs plain on the batch's own inputs: max_abs_err "
        f"{max(errs):.3e} (tol {ATOL['bf16']:g}; max|ref| {top:.3f}), by "
        f"layer {[float(f'{e:.3e}') for e in errs]}")
    say(f"validate: the same batch end to end (recorded, not a gate): plain "
        f"attention moves the scores by at most {sound:.4f} and leaves "
        f"{same_p} of {n_ids} span/label ids equal; keys 64..127 dropped in "
        f"the kernel moves them by {fault:.4f}, {same_f} of {n_ids} equal; "
        f"the scoring forward alone {forward_ms:.3f} ms (CUDA events, no "
        f"loader running)")
    if len(errs) != model.cfg.num_layers or max(errs) > ATOL["bf16"]:
        fail("validate: the attention kernel disagrees with plain on the "
             "batch's own inputs")
    if not all(np.isfinite(o).all() for o in (out_k, out_p, out_f)):
        fail("validate: a 16x512 batch's scores are not finite")
    return forward_ms


def _nq_int8_vs_composition(torch, predictor) -> None:
    """One full 16x512 batch of the int8 validate run scored again with
    every quantize, product, bias and cast a plain pass on the card tensors
    and every LayerNorm the forward kernel without its codes (as
    tests/test_torch_cuda.py's composition test does): the kernels are bit
    for bit with those passes and attention is the same deterministic
    kernel, so the packed outputs must be ``torch.equal``. Holds the int8
    kernels at the path's M = 8192 rows and its ragged padding."""
    from ml_recipe_tpu_torch.models.encoder import FusedLayerNorm
    from ml_recipe_tpu_torch.ops import quant_matmul as q8
    from ml_recipe_tpu_torch.quant import layers as qlayers

    items = next(d[-1] for d in predictor.dump
                 if len(d[-1]) == predictor.batch_size)
    wire = predictor._wire(predictor.collate_fun(items)[0]).cuda()
    with torch.inference_mode():
        got = predictor._score(wire)
    torch.cuda.synchronize()
    before = {k: k.launches for k in (q8.KERNEL, q8.QUANT_KERNEL)}
    saved = (qlayers.int8_linear, qlayers.quantize_rows)
    lns = [m for m in predictor.model.modules()
           if isinstance(m, FusedLayerNorm)]
    codes = [m.codes for m in lns]
    qlayers.int8_linear = q8.int8_linear_plain
    qlayers.quantize_rows = q8.quantize_rowwise
    for m in lns:
        m.codes = False
    try:
        with torch.inference_mode():
            want = predictor._score(wire)
        torch.cuda.synchronize()
    finally:
        qlayers.int8_linear, qlayers.quantize_rows = saved
        for m, c in zip(lns, codes):
            m.codes = c
    plain = all(k.launches == n for k, n in before.items())
    equal = bool(torch.equal(got, want))
    say(f"validate int8: one {tuple(wire.shape)} batch, kernels vs their "
        f"composition of plain passes ({len(lns)} LayerNorms without codes, "
        f"no int8 kernel launched: {plain}): packed outputs "
        f"{'equal' if equal else 'DIFFER'} (max_abs_err "
        f"{(got - want).abs().max().item():.3e})")
    if not (plain and equal and len(lns) == LN_PER_FORWARD):
        fail("validate int8: the batch differs from its composition of "
             "plain int8 passes")


def _nq_preread_rate(predictor, params) -> dict:
    """The validate run's model and collate in a new ``Predictor`` over the
    documents the run scored, read in advance (a list of their chunk
    lists): no tokenizer thread runs beside the scoring loop. Returns its
    stats."""
    from ml_recipe_tpu_torch.compose import init_validation_dataset
    from ml_recipe_tpu_torch.infer.predictor import Predictor

    tokenizer = predictor.collate_fun.keywords["tokenizer"]
    dataset = init_validation_dataset(params, tokenizer=tokenizer)
    order = np.arange(len(dataset))
    np.random.default_rng(0).shuffle(order)   # the ListDataloader's order
    docs, n = [], 0
    for i in order:
        if n >= predictor.stats["chunks"]:
            break
        docs.append(dataset[int(i)])
        n += len(docs[-1])
    # every chunk of those documents, no --limit
    again = Predictor(predictor.model, collate_fun=predictor.collate_fun,
                      batch_size=predictor.batch_size, n_jobs=predictor.n_jobs)
    s = again(docs).stats
    say(f"validate, the same {len(docs)} documents read in advance: "
        f"{s['chunks']} chunks in {s['batches']} batches, "
        f"{s['chunks'] / s['seconds']:.1f} chunks/s ({s['seconds']:.2f}s), "
        f"host {s['host_ms_per_batch']:.2f} ms per batch: the same scoring "
        f"loop with no tokenizer thread beside it")
    return s


def phase_nq_validate(torch, nq, ckpt, bf16=None):
    """Phase 10, steps 3 and 4: ``cli.validate`` with config/validate.cfg on
    ``ckpt`` (``--limit`` NQ_LIMIT), in bf16, or with ``--quantize int8
    --ln_impl fused`` when ``bf16`` (the bf16 run's candidates) is given.
    Counts are zeroed just before and read just after. Returns the launch
    counts, the candidates and the run's figures."""
    import gc

    from ml_recipe_tpu_torch.cli import validate

    int8 = bf16 is not None
    label = "validate int8" if int8 else "validate"
    params, model_params = validate.parse(
        ["-c", str(REPO / "config" / "validate.cfg"), "--checkpoint",
         str(ckpt), "--vocab_file", nq.vocab, "--lowercase", "--data_path",
         str(nq.corpus), "--processed_data_path", str(nq.proc), "--limit",
         str(NQ_LIMIT), *(("--quantize", "int8", "--ln_impl", "fused")
                          if int8 else ())])
    with _plain_q8_passes() as plain:
        zero_counts()               # the main path starts here
        t0 = time.perf_counter()
        predictor = validate.main(params, model_params, save_dump=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()         # the main path ends here
    model, stats = predictor.model, predictor.stats
    n, layers = stats["batches"], predictor.model.cfg.num_layers
    want = dict.fromkeys(KERNELS, 0)
    want["fused_attention_fwd"] = layers * n
    if int8:
        want.update(q8_matmul=Q8_PER_FORWARD * n, q8_quantize=QUANT_PER_FORWARD * n,
                    layer_norm_fwd=LN_PER_FORWARD * n)
    best = _nq_best(predictor.dump)
    got = {d: (predictor.scores[d], c.start_id, c.end_id, c.label)
           for d, c in predictor.candidates.items()}
    shape = (predictor.batch_size, params.max_seq_len)
    first = stats["first_batch_seconds"]
    say(f"{label}: {stats['documents']} documents, {stats['chunks']} chunks "
        f"in {n} batches of {shape[0]}x{shape[1]}, {stats['candidates']} "
        f"candidates; {stats['chunks'] / stats['seconds']:.1f} chunks/s over "
        f"the predictor's {stats['seconds']:.2f}s, "
        f"{(stats['chunks'] - shape[0]) / (stats['seconds'] - first):.1f} "
        f"after the first batch (staged at {first:.2f}s; the call "
        f"{wall:.1f}s, model build included), host "
        f"{stats['host_ms_per_batch']:.2f} ms per batch "
        f"(transfer thread, loader waits included); launch counts {launched}, "
        f"expected {want}; plain int8 passes {plain}")
    if n != NQ_LIMIT + 1 or shape != (16, 512):
        fail(f"{label} did not score {NQ_LIMIT + 1} batches of 16x512")
    if launched != want:
        fail(f"{label} launch counts do not match the path")
    if any(plain.values()):
        fail(f"{label} ran a plain int8 pass on the card")
    if got != best:
        fail(f"{label}: the candidates are not the best valid chunk of each "
             f"document")
    if int8 != (model.quantize == "int8"):
        fail(f"{label}: the model is not quantized as asked")
    forward_ms = preread = None
    if not int8:
        forward_ms = _nq_kernel_vs_plain(torch, predictor)
        preread = _nq_preread_rate(predictor, params)
    else:
        _nq_int8_vs_composition(torch, predictor)
        docs = {it.item_id for d in predictor.dump for it in d[-1]}
        same = sum(bf16.get(d, (None,))[1:] == got.get(d, (None,))[1:]
                   for d in docs)
        say(f"{label}: {same} of {len(docs)} documents keep bf16's candidate "
            f"({same / len(docs):.1%}; recorded, not a gate: random weights)")
    out = SimpleNamespace(launched=launched, candidates=got, stats=stats,
                          forward_ms=forward_ms, preread=preread)
    del predictor, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_nq_train_metrics(torch, nq, train):
    """Phase 10, step 5: ``cli.train_metrics`` on the saved ``last.ch``, with
    the copied cfg and the train run's eval batches: its test split's "Test
    metrics" line must equal the train run's last one digit for digit."""
    from ml_recipe_tpu_torch.cli import train_metrics

    params, model_params = train_metrics.parse(
        ["-c", str(train.cfg), "--checkpoint", str(train.ckpt),
         "--vocab_file", nq.vocab, "--dump_dir", str(OUT_DIR / "results"),
         "--batch_size", str(train.test_batch_size), "--seed", "0"])
    with _log_lines("ml_recipe_tpu_torch.train.trainer",
                    "Test metrics after epoch") as lines:
        zero_counts()               # the main path starts here
        t0 = time.perf_counter()
        train_metrics.main(params, model_params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()         # the main path ends here
    layers = 12
    # debug: 11 eval batches of the train split, and of the test split as
    # many as each epoch of the train run
    want = dict.fromkeys(KERNELS, 0)
    want["fused_attention_fwd"] = layers * (11 + train.eval_batches // 2)
    say(f"train_metrics: {wall:.1f}s; launch counts {launched}, expected "
        f"{want}; train split {lines[0] if lines else None}")
    if launched != want:
        fail("train_metrics launch counts do not match the path")
    if len(lines) != 2:
        fail(f"expected 2 'Test metrics' lines, got {len(lines)}")
    test_line = lines[1].split(" - ", 1)[1]
    say(f"train_metrics: test split {test_line}\n"
        f"train run, last epoch:  {train.final}\n"
        f"digit for digit: {test_line == train.final}")
    if test_line != train.final:
        fail("train_metrics on last.ch does not reproduce the train run's "
             "final Test metrics line")
    return launched


def profile_kernels(torch, fn, names, calls: int = 3) -> dict:
    """Device ms of one ``fn()`` in the kernels whose names contain each of
    ``names`` (:func:`profile_split`); None for each where the trace held
    no device events."""
    return profile_split(torch, fn, names, calls)[0] or dict.fromkeys(names)


# a spin kernel (torch.cuda._sleep) of this many cycles before each call
# of a profiled function: it marks where one call's kernels start
SPIN_CYCLES = 20000
TRACE_TRIES = 5


def not_measured(x, digits: int = 4) -> str:
    """``x`` with ``digits`` decimals, or "not measured" for None (a number
    that only a torch.profiler trace gives, from a trace that held no
    device events)."""
    return "not measured" if x is None else f"{x:.{digits}f}"


def less(a, b):
    """``a - b``, or None where either is None (:func:`not_measured`)."""
    return None if a is None or b is None else a - b


def device_trace(torch, run):
    """``(name, start, end)`` of every device event in a torch.profiler
    trace of ``run()``. A trace that holds no device events at all is taken
    again (such traces have come back from the card, several in a row),
    up to TRACE_TRIES times; after that the breakdown is not measured and
    None comes back. Only breakdowns come from these traces: every time
    that a gate or the kernels line needs is taken with CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [(e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        say("profile: the trace holds no device events; tracing again")
    say(f"profile: {TRACE_TRIES} traces held no device events; this "
        f"breakdown is not measured")
    return None


def profile_split(torch, fn, names, calls: int = 3):
    """``(split, span_ms)`` of one ``fn()`` from a torch.profiler trace of
    ``calls`` calls, each after a spin kernel that marks where its kernels
    start. ``split``: device ms in the kernels whose names contain each of
    ``names``, the mean launch of a name times its launches per call, so a
    launch the trace dropped (single-call traces lost one kernel of a
    multi-kernel call) does not count as 0 ms. ``span_ms``: the median over
    calls of a call's first kernel start to its last kernel end, the gaps
    between its kernels included. ``(None, None)`` without device events
    (:func:`device_trace`); fails when a named kernel is missing from every
    call of a trace that holds events (the names seen are printed)."""
    fn()
    torch.cuda.synchronize()

    def marked_calls():
        for _ in range(calls):
            torch.cuda._sleep(SPIN_CYCLES)
            fn()

    events = device_trace(torch, marked_calls)
    if events is None:
        return None, None
    events = sorted(events, key=lambda e: e[1])
    runs, run = [], []          # each call's kernels, split at the markers
    for name, start, end in events:
        if "spin_kernel" in name:
            runs.append(run)
            run = []
        else:
            run.append((name, start, end))
    runs = [r for r in runs + [run] if r]
    spans = [e for r in runs for e in r]
    out = {}
    for n in names:
        us = [end - start for e, start, end in spans if n in e]
        if not us:
            fail(f"no launch of {n} in a trace of {calls} calls; device "
                 f"kernels seen: {sorted({e[:80] for e, _, _ in spans})}")
        if len(us) % calls:
            say(f"profile: {len(us)} launches of {n} in a trace of {calls} "
                f"calls")
        per_call = max(1, round(len(us) / calls))
        out[n] = round(sum(us) / len(us) * per_call / 1e3, 4)
    span = statistics.median(max(e for _, _, e in r) - min(s for _, s, _ in r)
                             for r in runs)
    return out, round(span / 1e3, 4)


def _ln_family(name: str):
    """'forward' or 'backward' for a LayerNorm kernel: the port's
    (``layer_norm_fwd``/``layer_norm_bwd``) or PyTorch's own
    (``vectorized_layer_norm_kernel``; ``layer_norm_grad_input_kernel`` and
    the ``GammaBeta`` column sums), else None."""
    if "layer_norm_bwd" in name or "layer_norm_grad" in name \
            or "GammaBeta" in name:
        return "backward"
    if "layer_norm" in name:
        return "forward"
    return None


def _split_text(step_ms: float, split) -> str:
    if split is None:
        return "split by kernel family not measured"
    rest = step_ms - sum(split.values())
    return ", ".join([f"{k} {v:.3f}" for k, v in split.items()]
                     + [f"rest {rest:.3f}"])


# the training micro-batch's kernel families past the port's attention
# and LayerNorm kernels, by words in PyTorch's kernel names (lower case),
# first match first: cuBLAS products, the dropout masks' uniforms, GELU and
# its gradient, the optimizer's multi-tensor kernels, casts and copies,
# then the remaining elementwise kernels; anything else is "other"
TRAIN_FAMILIES = (
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("dropout rng", ("distribution", "uniform", "bernoulli", "philox",
                     "dropout")),
    ("gelu", ("gelu",)),
    ("optimizer", ("foreach", "multi_tensor")),
    ("casts and copies", ("copy", "memcpy", "memset", "cast")),
    ("other elementwise", ("elementwise",)),
)
TOP_OTHER = 10


def _train_family(name: str) -> str:
    if "fused_attention_fwd" in name:
        return "attention forward"
    if "fused_attention_bwd" in name:
        return "attention backward"
    ln = _ln_family(name)
    if ln:
        return f"layer_norm {ln}"
    low = name.lower()
    for family, words in TRAIN_FAMILIES:
        if any(w in low for w in words):
            return family
    return "other"


def profile_fwd_bwd(torch, fn, label: str) -> dict:
    """Device ms of one ``fn()`` by kernel family (the attention and
    LayerNorm kernels' forward and backward, then TRAIN_FAMILIES and
    "other"), from a torch.profiler trace (:func:`device_trace`); says the
    TOP_OTHER largest kernels of "other" by name under ``label``. None
    where the trace held no device events."""
    split = {f: 0.0 for f in ("attention forward", "attention backward",
                              "layer_norm forward", "layer_norm backward")}
    split.update({f: 0.0 for f, _ in TRAIN_FAMILIES})
    split["other"] = 0.0
    others = {}
    events = device_trace(torch, fn)
    if events is None:
        return None
    for name, start, end in events:
        family = _train_family(name)
        split[family] += (end - start) / 1e3
        if family == "other":
            others[name] = others.get(name, 0.0) + (end - start) / 1e3
    top = sorted(others.items(), key=lambda kv: -kv[1])[:TOP_OTHER]
    say(f"{label}: the {len(top)} largest kernels of 'other', device ms: "
        + "; ".join(f"{n[:100]} {ms:.3f}" for n, ms in top))
    return split


def profile_forward(torch, forward, label: str, reps: int = 5) -> None:
    """Device time of ``forward`` by kernel family, and the device's idle
    share over ``reps`` back-to-back calls, from a ``torch.profiler`` trace.
    Informative only: a trace without device events (:func:`device_trace`)
    prints 'not measured'."""
    def calls():
        with torch.inference_mode():
            for _ in range(reps):
                forward()

    spans = device_trace(torch, calls)
    if spans is None:
        say(f"{label}: profile of the 32x384 forward: not measured (the "
            f"trace holds no device events)")
        return
    family_us = {"attention": 0.0, "matmul": 0.0, "int8 matmul": 0.0,
                 "int8 quantize": 0.0, "layer_norm": 0.0, "other": 0.0}
    for name, start, end in spans:
        if "fused_attention_fwd" in name:
            family = "attention"
        elif "q8_matmul" in name:
            family = "int8 matmul"
        elif "q8_quantize" in name:
            family = "int8 quantize"
        elif _ln_family(name):
            family = "layer_norm"
        elif any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
            family = "matmul"
        else:
            family = "other"
        family_us[family] += end - start
    busy, cursor = 0.0, None        # union of the device intervals
    for _, start, end in sorted(spans, key=lambda s: s[1]):
        if cursor is None or start > cursor:
            busy += end - start
            cursor = end
        elif end > cursor:
            busy += end - cursor
            cursor = end
    window = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
    per_call = ", ".join(f"{k} {v / reps / 1e3:.3f}"
                         for k, v in family_us.items())
    say(f"{label}: profile of the 32x384 forward, device ms per call: "
        f"{per_call}; device idle {1 - busy / window:.1%} of "
        f"{window / 1e3:.3f} ms over {reps} back-to-back calls")


# -- phase 11: data parallelism --------------------------------------------------

DP_CFG = ["-c", str(REPO / "config" / "test_bert.cfg"), "--ln_impl", "fused"]
DP_DIR = OUT_DIR / "dp"
DP_DEADLINE_S = 300
DP_WORLD = 2
# relative L2 of the all-reduced first-step gradient against the one-process
# step on the regrouped global batch. The grouping's own noise: bf16
# products over 16x512 rows per rank against 32x512 in one process, and the
# gradient sum split at the all-reduce; the gradient at the clip read
# 1.015e-3 on an NVIDIA H100 80GB HBM3 at 700 W (two ranks on the card),
# where a missing all-reduce read 0.495 to 0.508
DP_GRAD_REL_TOL = 5e-3
# the first step's loss, logged by the ranks against the oracle's: the same
# bf16 noise in one scalar averaged over the batch's rows; it read 2.87e-6
# on that card
DP_LOSS_REL_TOL = 1e-4
DP_FAULT_FACTOR = 10            # the planted fault must miss by this much
DP_HIDDEN_DRAWS = 25            # hidden-dropout masks per bert-base forward


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _register_kernels():
    from ml_recipe_tpu_torch.ops import flash_attention as fa
    from ml_recipe_tpu_torch.ops import layer_norm as ln
    from ml_recipe_tpu_torch.ops import quant_matmul as q8

    KERNELS.update({"fused_attention_fwd": fa.KERNEL,
                    "fused_attention_bwd": fa.BWD_KERNEL,
                    "layer_norm_fwd": ln.FWD_KERNEL,
                    "layer_norm_bwd": ln.BWD_KERNEL,
                    "q8_matmul": q8.KERNEL,
                    "q8_quantize": q8.QUANT_KERNEL})
    return fa, ln, q8


def _capture_pre_clip_grads(torch, store: dict) -> None:
    """Have the trainer's first clip store the gradients it is handed,
    flattened in the optimizer's parameter order (one order in every
    process) on the CPU: all-reduced and scaled by ``1/batch_split``, their
    magnitude intact, where the clipped gradient keeps only its direction
    (test_bert.cfg's clip of 1 bites at every step)."""
    from ml_recipe_tpu_torch.train import trainer as trainer_module

    clip = trainer_module.clip_by_global_norm_

    def capture(tensors, max_norm):
        if "grads" not in store:
            store["grads"] = torch.cat(
                [g.detach().float().reshape(-1) for g in tensors]).cpu()
        return clip(tensors, max_norm)

    trainer_module.clip_by_global_norm_ = capture


def _param_digest(model) -> str:
    import hashlib

    digest = hashlib.sha256()
    for name, p in sorted(model.named_parameters(), key=lambda x: x[0]):
        digest.update(name.encode())
        digest.update(p.detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def _wait_for(paths, deadline: float) -> None:
    while not all(p.exists() for p in paths):
        if time.monotonic() > deadline:
            fail(f"gave up waiting for {[str(p) for p in paths]}")
        time.sleep(0.5)


def dp_worker(kind: str, rank: int, port: int) -> int:
    """One rank of phase 11's run: ``cli.train``'s ``main`` with
    ``--dist_world_size 2``, the launch counts set to 0 just before and
    read just after. The ranks share card 0, so the worker joins a gloo
    world there first (NCCL refuses two ranks on one device) and the CLI
    keeps it. Records the first local batch, the first step's all-reduced
    gradient as it reaches the clip, each all-reduce's time, the step walls
    and losses and a digest of the final parameters. With ``kind='fault'``
    rank 1 skips the gradient all-reduce: it adds zeros to the others' sum
    and keeps its own gradients."""
    import torch

    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.parallel import collectives
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.train.trainer import Trainer

    _register_kernels()
    out = DP_DIR / kind
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=DP_WORLD,
        rank=rank, backend="gloo", device=torch.device("cuda", 0))
    reduce = collectives.all_reduce_gradients
    reduce_ms = []

    def timed_reduce(named, *args, **kwargs):
        named = list(named)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "fault" and rank == 1:
            own = [p.grad for _, p in named]
            for _, p in named:
                p.grad = torch.zeros_like(p)
            buckets = reduce(named, *args, **kwargs)
            for (_, p), grad in zip(named, own):
                p.grad = grad
        else:
            buckets = reduce(named, *args, **kwargs)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        return buckets

    collectives.all_reduce_gradients = timed_reduce
    step = Trainer.train_step
    first = {}
    _capture_pre_clip_grads(torch, first)

    def train_step(self, inputs, labels):
        if "batch" not in first:
            first["batch"] = ({k: v.cpu() for k, v in inputs.items()},
                              {k: v.cpu() for k, v in labels.items()})
        return step(self, inputs, labels)

    Trainer.train_step = train_step
    argv = [*DP_CFG, "--vocab_file", str(OUT_DIR / "vocab.txt"),
            "--dump_dir", str(out / "results"), "--dist_world_size",
            str(DP_WORLD), "--local_rank", str(rank), "--dist_init_method",
            f"tcp://127.0.0.1:{port}"]
    zero_counts()                   # the main path starts here
    t0 = time.perf_counter()
    trainer = train_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()             # the main path ends here
    torch.save(first["batch"], out / f"batch{rank}.pt")
    if rank == 0 or kind == "fault":
        torch.save(first["grads"], out / f"grads{rank}.pt")
    record = {
        "launched": launched, "wall": wall, "reduce_ms": reduce_ms,
        "steps": [{k: h[k] for k in ("loss", "lr", "seconds", "rows")}
                  for h in trainer.history],
        "eval_batches": trainer.eval_batches,
        "batch_split": trainer.batch_split,
        "local_rows": int(first["batch"][0]["input_ids"].shape[0]),
        "layers": trainer.model.cfg.num_layers,
        "digest": _param_digest(trainer.model),
        "world": trainer.process_count,
        "device": str(trainer.device),
    }
    (out / f"rank{rank}.json").write_text(json.dumps(record))
    return 0


def dp_oracle() -> int:
    """Phase 11's oracle: the same ``Trainer`` through
    ``cli.train.build_trainer`` in one process, fed each run's first global
    batch regrouped in rank order; its loss, and the relative L2 distance
    of its gradient at the clip to the run's, in full and in direction
    alone (each side scaled to norm 1, as a clip that bites leaves it)."""
    import torch

    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.parallel import regroup_for_world

    torch.cuda.set_device(0)
    deadline = time.monotonic() + DP_DEADLINE_S
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [*DP_CFG, "--vocab_file", str(OUT_DIR / "vocab.txt"), "--dump_dir",
         str(DP_DIR / "oracle")])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    trainer = train_cli.build_trainer(params, model_params)
    init = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    result, captured = {}, {}
    _capture_pre_clip_grads(torch, captured)
    for kind in ("clean", "fault"):
        captured.clear()
        out = DP_DIR / kind
        _wait_for([out / f"rank{r}.json" for r in range(DP_WORLD)], deadline)
        # each run's own first global batch (test_bert.cfg's seed=None draws
        # each process's dummy items anew), from the same parameters
        batches = [torch.load(out / f"batch{r}.pt") for r in range(DP_WORLD)]
        inputs, labels = (
            {k: v.cuda() for k, v in regroup_for_world(
                {k: torch.cat([b[i][k] for b in batches]) for k in
                 batches[0][i]}, DP_WORLD, trainer.batch_split).items()}
            for i in range(2))
        with torch.no_grad():
            for n, p in trainer.model.named_parameters():
                p.copy_(init[n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values = trainer.train_step(inputs, labels)
        torch.cuda.synchronize()
        result[f"{kind}_step_seconds"] = time.perf_counter() - t0
        result[f"{kind}_loss"] = values["loss"]
        result["micro_rows"] = (int(inputs["input_ids"].shape[0])
                                // trainer.batch_split)
        grads = captured["grads"]
        result[f"{kind}_grad_norm"] = float(grads.norm())
        for r in range(DP_WORLD):
            path = out / f"grads{r}.pt"
            if path.exists():
                got = torch.load(path)
                result[f"{kind}{r}"] = float((got - grads).norm()
                                             / grads.norm())
                result[f"{kind}{r}_direction"] = float(
                    (got / got.norm() - grads / grads.norm()).norm())
                result[f"{kind}{r}_grad_norm"] = float(got.norm())
        if kind == "fault":
            # each rank's own gradient (rank 0 reduced only zeros from rank
            # 1): how parallel the two halves of the sum are
            g0, g1 = (torch.load(out / f"grads{r}.pt") for r in range(2))
            result["fault_cosine"] = float(g0 @ g1 / (g0.norm() * g1.norm()))
    (DP_DIR / "oracle.json").write_text(json.dumps(result))
    return 0


def dp_nccl() -> int:
    """Phase 11 (b): a one-rank NCCL group runs the bucketed gradient
    all-reduce and the parameter broadcast over bert-base's parameter set;
    each must give back its input bit for bit. It joins and builds at once
    and times when the rest of the phase is done, alone on the card."""
    import torch

    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.parallel import collectives
    from ml_recipe_tpu_torch.parallel import dist as pdist

    dev = torch.device("cuda", 0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0,
        backend="nccl", device=dev)
    try:
        model = QAModel(EncoderConfig(), dtype=torch.bfloat16, device=dev)
        named = list(model.named_parameters())
        gen = torch.Generator(device=dev).manual_seed(0)
        for _, p in named:
            p.grad = torch.randn(p.shape, device=dev, generator=gen)
        want = [p.grad.clone() for _, p in named]
        params = [p.detach().clone() for _, p in named]
        result = {"backend": pdist.backend(), "params": sum(
            p.numel() for _, p in named), "reduce_ms": [], "broadcast_ms": []}
        _wait_for([DP_DIR / "oracle.json"],
                  time.monotonic() + DP_DEADLINE_S)
        equal = True
        for _ in range(4):
            for key, fn in (("reduce_ms", collectives.all_reduce_gradients),
                            ("broadcast_ms", collectives.broadcast_parameters)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result["buckets"] = fn(named)
                torch.cuda.synchronize()
                result[key].append((time.perf_counter() - t0) * 1e3)
            equal &= all(torch.equal(p.grad, g) for (_, p), g in
                         zip(named, want))
            equal &= all(torch.equal(p.detach(), q) for (_, p), q in
                         zip(named, params))
        result["equal"] = bool(equal)
    finally:
        pdist.shutdown()
    (DP_DIR / "nccl.json").write_text(json.dumps(result))
    return 0


def _spawn(args, log: Path):
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), *map(str, args)],
            cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT)


def _join(procs, deadline: float) -> None:
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail(f"data parallel: {name} outlived its deadline; its log ends "
                 f"{log.read_text()[-3000:]}")
        if rc != 0:
            fail(f"data parallel: {name} exited {rc}; its log ends "
                 f"{log.read_text()[-3000:]}")


def _dp_pair(kind: str) -> dict:
    port = _free_port()
    return {f"{kind} rank {r}": (
        _spawn(["--dp-worker", kind, r, port], DP_DIR / f"{kind}{r}.log"),
        DP_DIR / f"{kind}{r}.log") for r in range(DP_WORLD)}


def phase_data_parallel(torch):
    """Phase 11: ``cli.train`` as two ranks sharing the one card over gloo,
    its oracle and a planted fault, and a one-rank NCCL group. Returns the
    ranks' launch counts, summed."""
    import shutil

    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    deadline = time.monotonic() + DP_DEADLINE_S
    t0 = time.perf_counter()
    procs = {}
    try:
        clean = _dp_pair("clean")
        procs.update(clean)
        procs["oracle"] = (_spawn(["--dp-oracle"], DP_DIR / "oracle.log"),
                           DP_DIR / "oracle.log")
        procs["nccl"] = (_spawn(["--dp-nccl"], DP_DIR / "nccl.log"),
                         DP_DIR / "nccl.log")
        _join(clean, deadline)
        procs.update(_dp_pair("fault"))
        _join(procs, deadline)
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0

    runs = {kind: [json.loads((DP_DIR / kind / f"rank{r}.json").read_text())
                   for r in range(DP_WORLD)] for kind in ("clean", "fault")}
    oracle = json.loads((DP_DIR / "oracle.json").read_text())
    ranks = runs["clean"]
    r0 = ranks[0]
    layers, split = r0["layers"], r0["batch_split"]
    micro = len(r0["steps"]) * split
    evals = r0["eval_batches"]
    want = {"fused_attention_fwd": layers * (micro + evals),
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": LN_PER_FORWARD * (micro + evals),
            "layer_norm_bwd": LN_PER_FORWARD * micro, "q8_matmul": 0,
            "q8_quantize": 0}
    for r, rec in enumerate(ranks):
        say(f"data parallel: rank {r} of {rec['world']} (gloo, CUDA tensors, "
            f"sharing the card, "
            f"{rec['device']}): {len(rec['steps'])} steps of {split} "
            f"micro-batches of {rec['local_rows'] // split}x512 "
            f"({rec['local_rows']} of {rec['steps'][0]['rows']} rows) + "
            f"{rec['eval_batches']} eval batches in {rec['wall']:.1f}s; step "
            f"wall seconds {[round(s['seconds'], 3) for s in rec['steps']]}; "
            f"gradient all-reduce ms {[round(x, 1) for x in rec['reduce_ms']]}"
            f" (~110M f32 over gloo: a host path, no measure of NCCL); loss {[round(s['loss'], 4) for s in rec['steps']]}; launch "
            f"counts {rec['launched']}, expected {want}")
    per_micro = {k: v / (micro + evals) if k.endswith("fwd") else v / micro
                 for k, v in r0["launched"].items() if want[k]}
    say(f"data parallel: launches per micro-batch and rank {per_micro} "
        f"(forward per micro-batch and eval batch); phase wall {wall:.1f}s")
    rows = 256
    if micro != 16 or evals != 22 or r0["local_rows"] != rows // DP_WORLD \
            or r0["steps"][0]["rows"] != rows or r0["world"] != DP_WORLD:
        fail(f"the data-parallel run is not test_bert.cfg's 2 debug steps of "
             f"{rows // DP_WORLD} rows per rank in 8 micro-batches")
    if any(rec["launched"] != want for rec in ranks):
        fail("launch counts do not match the data-parallel training path")
    if any([(s["loss"], s["lr"]) for s in rec["steps"]] !=
           [(s["loss"], s["lr"]) for s in r0["steps"]] for rec in ranks):
        fail("the ranks logged other step losses")
    if not all(np.isfinite(s["loss"]) for s in r0["steps"]):
        fail("a data-parallel training loss is not finite")
    same = len({rec["digest"] for rec in ranks}) == 1
    fault_same = len({rec["digest"] for rec in runs["fault"]}) == 1
    rel = oracle["clean0"]
    faults = [oracle[f"fault{r}"] for r in range(DP_WORLD)]
    loss, want_loss = r0["steps"][0]["loss"], oracle["clean_loss"]
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    fault_norms = [round(oracle[f"fault{r}_grad_norm"], 4)
                   for r in range(DP_WORLD)]
    fault_dirs = [f"{oracle[f'fault{r}_direction']:.3e}"
                  for r in range(DP_WORLD)]
    say(f"data parallel: replicas after the run bit-identical: {same}; "
        f"first step against the one-process step on the regrouped global "
        f"batch ({oracle['micro_rows']}x512 micro-batches, "
        f"{oracle['clean_step_seconds']:.2f}s): loss {loss!r} against "
        f"{want_loss!r}, relative {loss_rel:.3e} (tol {DP_LOSS_REL_TOL:g}); "
        f"gradient at the clip (norm {oracle['clean0_grad_norm']:.4g} against "
        f"{oracle['clean_grad_norm']:.4g}) relative L2 {rel:.3e} (tol "
        f"{DP_GRAD_REL_TOL:g}), in direction alone "
        f"{oracle['clean0_direction']:.3e}; planted fault (rank 1 skips the "
        f"all-reduce): ranks {[f'{x:.3e}' for x in faults]} "
        f"({min(faults) / DP_GRAD_REL_TOL:.0f}x the tolerance; norms "
        f"{fault_norms} against {oracle['fault_grad_norm']:.4g}; in "
        f"direction alone {fault_dirs}; the ranks' own gradients' cosine "
        f"{oracle['fault_cosine']:.4f}), replicas equal: {fault_same}")
    if not same:
        fail("the data-parallel replicas differ")
    if not (np.isfinite(loss_rel) and loss_rel <= DP_LOSS_REL_TOL):
        fail("the first step's loss disagrees with the one-process step")
    if not (np.isfinite(rel) and rel <= DP_GRAD_REL_TOL):
        fail("the all-reduced gradient disagrees with the one-process step")
    if not min(faults) >= DP_FAULT_FACTOR * DP_GRAD_REL_TOL or fault_same:
        fail("the planted fault was not caught")
    nccl = json.loads((DP_DIR / "nccl.json").read_text())
    say(f"data parallel (b): one-rank {nccl['backend']} group, bucketed "
        f"all-reduce of {nccl['params']} f32 gradients in {nccl['buckets']} "
        f"buckets ms {[round(x, 2) for x in nccl['reduce_ms']]}, broadcast "
        f"ms {[round(x, 2) for x in nccl['broadcast_ms']]}; equal to its "
        f"input: {nccl['equal']} (one card: says nothing of several)")
    if nccl["backend"] != "nccl" or not nccl["equal"]:
        fail("the one-rank NCCL round trip is not exact")

    # the extra hidden-dropout RNG of a rank: each of a micro-batch's masks
    # is drawn at the global micro-batch's shape (2 x 16 rows) instead of
    # its own 16 rows
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = r0["local_rows"] // split
    rng_ms = {rows: time_ms(torch, lambda rows=rows: [torch.rand(
        (rows, 512, 768), generator=gen, device="cuda")
        for _ in range(DP_HIDDEN_DRAWS)], reps=9, warm=2)
        for rows in (m, DP_WORLD * m)}
    say(f"data parallel: a micro-batch's {DP_HIDDEN_DRAWS} hidden-dropout "
        f"masks' uniforms {rng_ms[m]:.4f} ms at {m}x512x768, "
        f"{rng_ms[DP_WORLD * m]:.4f} ms at the global {DP_WORLD * m}x512x768: "
        f"{rng_ms[DP_WORLD * m] - rng_ms[m]:.4f} ms more per rank and "
        f"micro-batch (CUDA events)")
    return {k: sum(rec["launched"][k] for rec in ranks)
            for k in r0["launched"]}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's kernels need a GPU")
    try:
        from ml_recipe_tpu_torch.ops import cuda_build
        from ml_recipe_tpu_torch.ops import flash_attention as fa
        from ml_recipe_tpu_torch.ops import layer_norm as ln
        from ml_recipe_tpu_torch.ops import quant_matmul as q8
    except ImportError as exc:
        fail(f"run from a checkout of the repository ({exc})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    bw, flops = peaks["bw"], peaks["bf16"]
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
        f"peaks used for bound_ms: {bw / 1e12:g} TB/s, {flops / 1e12:g} "
        f"TFLOP/s bf16, {peaks['int8'] / 1e12:g} TOP/s int8, "
        f"{peaks['f32'] / 1e12:g} TFLOP/s f32 (no tensor cores)")
    KERNELS.update({"fused_attention_fwd": fa.KERNEL,
                    "fused_attention_bwd": fa.BWD_KERNEL,
                    "layer_norm_fwd": ln.FWD_KERNEL,
                    "layer_norm_bwd": ln.BWD_KERNEL,
                    "q8_matmul": q8.KERNEL,
                    "q8_quantize": q8.QUANT_KERNEL})

    libraries = [fa.KERNEL.library, fa.BWD_KERNEL.library, ln.LIBRARY,
                 q8.KERNEL.library]
    t0 = time.perf_counter()
    built = cuda_build.build(*libraries)
    say(f"kernel build: {len(built)} of {len(libraries)} libraries built in "
        f"{time.perf_counter() - t0:.1f}s")
    reports = {}
    for lib in built:
        for kernel, report in ptxas_reports(lib.build_log):
            say(f"ptxas {lib.source.name} {kernel}: {report}")
            reports[kernel] = report
    tc_kernels = check_tc_kernels(fa, reports)
    q8_sass = check_row_kernels(cuda_build, q8, ln, built)
    tc_fwd = {k: v for k, v in tc_kernels.items() if "_fwd_" in k}
    tc_bwd = {k: v for k, v in tc_kernels.items() if "_bwd_" in k}

    timings, fwd_err = phase_kernels(torch, fa, bw, flops)
    bwd, bwd_err = phase_bwd_kernel(torch, fa, bw, flops)
    ln_t, ln_fwd_err, ln_bwd_err = phase_ln_kernels(torch, ln, q8, peaks)
    q8_t, quant_t, q8_err, quant_err = phase_q8_kernel(torch, q8, peaks)
    long_t, long_fwd_err, long_bwd_err = phase_long_kernels(torch, fa, bw,
                                                            flops)
    serving_fwd, bf16_burst, ids, bf16_ms = phase_serving(
        torch, fa, timings[SERVING_SHAPE]["ms"])
    int8 = phase_int8_serving(torch, bf16_burst, ids, bf16_ms)
    del bf16_burst
    torch.cuda.empty_cache()
    train_fwd, train_bwd, xla_ms, xla_split = phase_training(torch, fa)
    ln_train = phase_ln_training(torch, xla_ms, xla_split)
    long = phase_long_training(torch)
    torch.cuda.empty_cache()
    nq = phase_nq_corpus(torch)
    nq_train = phase_nq_training(torch, nq)
    nq_val = phase_nq_validate(torch, nq, nq_train.ckpt)
    nq_val8 = phase_nq_validate(torch, nq, nq_train.ckpt,
                                bf16=nq_val.candidates)
    nq_metrics = phase_nq_train_metrics(torch, nq, nq_train)
    torch.cuda.empty_cache()
    dp = phase_data_parallel(torch)
    nq_fwd = {"nq training": nq_train.launched["fused_attention_fwd"],
              "validate": nq_val.launched["fused_attention_fwd"],
              "validate int8": nq_val8.launched["fused_attention_fwd"],
              "train_metrics": nq_metrics["fused_attention_fwd"]}

    def int8_paths(kernel):
        return {"serving int8": int8[kernel],
                "validate int8": nq_val8.launched[kernel]}

    fwd = timings[TRAIN_SHAPE]

    def entry(kernel, replaces, launches, err, t, shape, source=None,
              **more):
        return {"name": kernel, "route": "cuda",
                "source": f"ml_recipe_tpu_torch/csrc/{source or kernel}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "shape": shape, **more}

    def by_shape(t, config):
        return dict(ms=t["ms"], library_ms=t["library_ms"],
                    x_library=t["ms"] / t["library_ms"],
                    bound_ms=t["bound_ms"], config=config)

    # every timed bf16 shape of each attention kernel, and its ratio to
    # scaled_dot_product_attention (forward, or backward as fwd+bwd - fwd)
    fwd_shapes = {f"{B}x{L}": by_shape(t, t["config"])
                  for (B, L), t in timings.items()}
    fwd_shapes.update({f"{B}x{L}": by_shape(t["fwd"], "rate 0.1, lse")
                       for (B, L), t in long_t.items()})
    bwd_shapes = {f"{TRAIN_SHAPE[0]}x{TRAIN_SHAPE[1]}": by_shape(bwd,
                                                                 "rate 0.1")}
    bwd_shapes.update({f"{B}x{L}": by_shape(t["bwd"], "rate 0.1")
                       for (B, L), t in long_t.items()})
    fwd_more = dict(tc_kernels=tc_fwd, by_shape=fwd_shapes)
    bwd_more = dict(tc_kernels=tc_bwd, by_shape=bwd_shapes)

    blocked, stream = long_t[BLOCKED_SHAPE], long_t[STREAM_SHAPE]
    blocked_shape = "32x1024x12x64 bf16, dropout 0.1 (config/long_context.cfg)"
    stream_shape = ("2x4096x12x64 bf16, dropout 0.1 (config/long_context.cfg "
                    "--max_seq_len=4096 --remat)")
    # rows 6 and 7: one backward launch runs the row-term pre-pass, the
    # dk/dv kernel and the dq kernel; ms and the bound are the launch's
    shared = dict(device_ms_by_kernel=stream["bwd"]["split_ms"],
                  covers="one launch: dq and dk/dv (flash_streaming.py:339 "
                         "and :374)", **bwd_more)
    long_kernels = [
        entry("fused_attention_fwd", "ml_recipe_tpu/ops/flash_attention.py:364",
              long["1024"]["fwd"], long_fwd_err, blocked["fwd"],
              blocked_shape + ", lse", **fwd_more),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_attention.py:305",
              long["1024"]["bwd"], long_bwd_err, blocked["bwd"],
              blocked_shape, device_ms_by_kernel=blocked["bwd"]["split_ms"],
              **bwd_more),
        entry("fused_attention_fwd", "ml_recipe_tpu/ops/flash_streaming.py:241",
              long["4096 remat"]["fwd"], long_fwd_err, stream["fwd"],
              stream_shape + ", lse", **fwd_more),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_streaming.py:339",
              long["4096 remat"]["bwd"], long_bwd_err, stream["bwd"],
              stream_shape, **shared),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_streaming.py:374",
              long["4096 remat"]["bwd"], long_bwd_err, stream["bwd"],
              stream_shape, **shared),
    ]
    ln_fwd, ln_bwd = ln_t[(16384, 768, "fwd")], ln_t[(16384, 768, "bwd")]
    ln_serve = ln_t[(12288, 768, "fwd")]
    q8_ffn = q8_t[(12288, 768, 3072)]
    new_kernels = [
        entry("layer_norm_fwd", "ml_recipe_tpu/ops/layer_norm.py:84",
              int8["layer_norm_fwd"] + ln_train["layer_norm_fwd"]
              + nq_val8.launched["layer_norm_fwd"] + dp["layer_norm_fwd"],
              ln_fwd_err, ln_fwd, "16384x768 bf16 (32x512, training)",
              source="layer_norm",
              launches_by_path={**int8_paths("layer_norm_fwd"),
                                "training fused": ln_train["layer_norm_fwd"],
                                "data parallel": dp["layer_norm_fwd"]},
              device_ms=ln_fwd["device_ms"], host_ms=ln_fwd["host_ms"],
              at_32x384={k: ln_serve[k] for k in (
                  "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                  "bound_ms", "with_codes")}),
        entry("layer_norm_bwd", "ml_recipe_tpu/ops/layer_norm.py:96",
              ln_train["layer_norm_bwd"] + dp["layer_norm_bwd"], ln_bwd_err,
              ln_bwd, "16384x768 bf16 (32x512, training)", source="layer_norm",
              launches_by_path={"training fused": ln_train["layer_norm_bwd"],
                                "data parallel": dp["layer_norm_bwd"]},
              device_ms=ln_bwd["device_ms"], host_ms=ln_bwd["host_ms"],
              device_ms_by_kernel=ln_bwd["split_ms"],
              by_shape={f"{N}x{C}": {k: t[k] for k in (
                  "ms", "device_ms", "host_ms", "split_ms", "plain_ms",
                  "library_ms", "bound_ms")}
                  for (N, C, kind), t in ln_t.items() if kind == "bwd"}),
        entry("q8_matmul", "ml_recipe_tpu/ops/quant_matmul.py:85",
              int8["q8_matmul"] + nq_val8.launched["q8_matmul"], q8_err,
              q8_ffn, "M=12288 K=768 N=3072, + bias, bf16 out (32x384 FFN in, "
              "int8 serving)", sass=q8_sass,
              launches_by_path=int8_paths("q8_matmul"),
              by_shape={f"{M}x{K}x{N}": t for (M, K, N), t in q8_t.items()}),
        entry("q8_quantize_rows",
              "none: port-only; the JAX package's quantize_rowwise "
              "(ml_recipe_tpu/ops/quant_matmul.py:62) is XLA, no pallas_call",
              int8["q8_quantize"] + nq_val8.launched["q8_quantize"],
              quant_err, quant_t[(12288, 768)],
              "12288x768 bf16 (32x384 attention context, int8 serving)",
              source="q8_matmul", launches_by_path=int8_paths("q8_quantize"),
              by_shape={f"{M}x{K}": t for (M, K), t in quant_t.items()}),
    ]
    say(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "ml_recipe_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "ml_recipe_tpu/ops/flash_attention.py:129",
        "launches": (serving_fwd + train_fwd + int8["fused_attention_fwd"]
                     + ln_train["fused_attention_fwd"] + sum(nq_fwd.values())
                     + dp["fused_attention_fwd"]),
        "launches_by_path": {"serving": serving_fwd, "training": train_fwd,
                             "serving int8": int8["fused_attention_fwd"],
                             "training fused": ln_train["fused_attention_fwd"],
                             **nq_fwd,
                             "data parallel": dp["fused_attention_fwd"]},
        "max_abs_err": fwd_err,
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "shape": "32x512x12x64 bf16, dropout 0.1, lse (training)",
        **fwd_more,
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "ml_recipe_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "ml_recipe_tpu/ops/flash_attention.py:266",
        "launches": (train_bwd + ln_train["fused_attention_bwd"]
                     + nq_train.launched["fused_attention_bwd"]
                     + dp["fused_attention_bwd"]),
        "launches_by_path": {"serving": 0, "training": train_bwd,
                             "training fused": ln_train["fused_attention_bwd"],
                             "nq training":
                                 nq_train.launched["fused_attention_bwd"],
                             "data parallel": dp["fused_attention_bwd"]},
        "max_abs_err": bwd_err,
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "shape": "32x512x12x64 bf16, dropout 0.1 (training)",
        "device_ms_by_kernel": bwd["device_ms_by_kernel"],
        **bwd_more,
    }, *long_kernels, *new_kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # phase 11 starts this script again as its worker processes
    if sys.argv[1:2] == ["--dp-worker"]:
        kind, rank, port = sys.argv[2:]
        sys.exit(dp_worker(kind, int(rank), int(port)))
    if sys.argv[1:] == ["--dp-oracle"]:
        sys.exit(dp_oracle())
    if sys.argv[1:] == ["--dp-nccl"]:
        sys.exit(dp_nccl())
    sys.exit(main())
