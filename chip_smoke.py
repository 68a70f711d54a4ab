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
   version.

It then prints one ``{"kernels": [...]}`` line (the attention kernels'
lines carry the tensor-core kernels' resources and every timed shape's
``ms`` and ratio to ``scaled_dot_product_attention`` under ``by_shape``)
and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or outside a checkout
of the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
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
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chip_smoke_out"     # the synthetic vocab (git-ignored)

H, D = 12, 64                      # bert-base attention heads
SHAPES = [(8, 128), (8, 384), (32, 384), (2, 200)]   # (B, L); 2x200 ragged
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

# the LayerNorm rows of the serving (32x384) and training (32x512) paths
LN_SHAPES = [(12288, 768), (16384, 768)]
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
# int8 matmul shapes at 32x384 (M = 12288 tokens): the four attention
# projections (768, 768), FFN in (768, 3072) and out (3072, 768); the
# pooler over the 32 [CLS] rows, the span head over every token, the
# classifier and regressors over the pooled rows
Q8_PROJ = [(12288, 768, 768), (12288, 768, 3072), (12288, 3072, 768)]
Q8_SHAPES = Q8_PROJ + [(32, 768, 768), (12288, 768, 2), (32, 768, 5),
                       (32, 768, 1)]
Q8_PER_FORWARD = 77                # 6 x 12 layers + pooler + 4 heads
# row quantize launches per int8 forward with the fused LayerNorm, whose
# launches write the codes of their own outputs: the attention context and
# the GELU output of each layer, and the pooled output
QUANT_PER_FORWARD = 25
# the activations the int8 path quantizes at 32x384: hidden and context
# rows (K = 768), GELU rows (3072), the pooled rows
QUANT_SHAPES = [(12288, 768), (12288, 3072), (32, 768)]
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
        fwd["host_ms"] = fwd["ms"] - fwd["device_ms"]
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
        codes["host_ms"] = codes["ms"] - codes["device_ms"]
        fwd["with_codes"] = codes
        timings[(N, C, "fwd")] = fwd
        say(f"timing layer_norm_fwd {N}x{C} bf16: kernel_ms={fwd['ms']:.4f} "
            f"(device ms {fwd['device_ms']:.4f}, host ms per launch "
            f"{fwd['host_ms']:.4f}) plain_ms={fwd['plain_ms']:.4f} "
            f"library_ms(F.layer_norm)={fwd['library_ms']:.4f} bound_ms="
            f"{fwd['bound_ms']:.4f} ({fwd['bound_by']}); with the quantize "
            f"epilogue kernel_ms={codes['ms']:.4f} (device ms "
            f"{codes['device_ms']:.4f}, host {codes['host_ms']:.4f}) "
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
        bwd["device_ms"] = round(sum(bwd["split_ms"].values()), 4)
        bwd["host_ms"] = bwd["ms"] - bwd["device_ms"]
        timings[(N, C, "bwd")] = bwd
        say(f"timing layer_norm_bwd {N}x{C} bf16: kernel_ms={bwd['ms']:.4f} "
            f"(device ms {bwd['device_ms']:.4f}, host ms per launch "
            f"{bwd['host_ms']:.4f}) plain_ms={bwd['plain_ms']:.4f} "
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
            t["host_ms"] = t["ms"] - t["device_ms"]
            modes[mode] = t
        t = modes["bf16+bias"]
        t["linear_bf16_ms"] = time_ms(torch, lambda: F.linear(x, wb, bb))
        t["f32_mode"] = modes["f32"]
        timings[(M, K, N)] = t
        for mode, m in modes.items():
            lib = ("null" if m["library_ms"] is None
                   else f"{m['library_ms']:.4f}")
            say(f"timing q8_matmul M={M} K={K} N={N} {mode}: kernel_ms="
                f"{m['ms']:.4f} (device ms {m['device_ms']:.4f}, host ms per "
                f"launch {m['host_ms']:.4f}) plain_ms={m['plain_ms']:.4f} "
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
        t["host_ms"] = t["ms"] - t["device_ms"]
        quant[(M, K)] = t
        say(f"timing q8_quantize_rows M={M} K={K} bf16: kernel_ms="
            f"{t['ms']:.4f} (device ms {t['device_ms']:.4f}, host ms per "
            f"launch {t['host_ms']:.4f}) plain_ms={t['plain_ms']:.4f} "
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
    from types import SimpleNamespace

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


def phase_int8_serving(torch, bf16, ids, bf16_forward_ms):
    """int8 serving with the fused LayerNorm: phase_serving's burst with
    ``--quantize int8 --ln_impl fused``; ``bf16`` is phase_serving's burst
    (the same seeded weights unquantized), ``ids`` its 32x384 batch and
    ``bf16_forward_ms`` that batch's scoring forward. Returns the launch
    counts of the path."""
    from ml_recipe_tpu_torch.ops import quant_matmul as q8
    from ml_recipe_tpu_torch.quant import make_parity_batches, span_parity

    # count the plain quantize, product, bias and cast passes the burst
    # runs: on the card, none
    plain_calls = dict.fromkeys(("quantize_rowwise", "int8_matmul_plain",
                                 "int8_linear_plain"), 0)
    originals = {n: getattr(q8, n) for n in plain_calls}

    def counting(name):
        def call(*args, **kw):
            plain_calls[name] += 1
            return originals[name](*args, **kw)
        return call

    for name in plain_calls:
        setattr(q8, name, counting(name))
    try:
        burst = _serve_burst(torch, ("--quantize", "int8", "--ln_impl",
                                     "fused"))
    finally:
        for name, fn in originals.items():
            setattr(q8, name, fn)
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
    """``config/<cfg>`` with ``extra`` flags through the trainer and model
    parsers, ``check_train_flags`` and the build and train sequence of
    ``ml_recipe_tpu_torch.cli.train``. The launch counts are set to 0 just
    before ``train`` and read just after. Returns the trainer, the trainer
    flags, every kernel's launch count and the wall seconds."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        check_train_flags, get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        ["-c", str(REPO / "config" / cfg), "--vocab_file", vocab,
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
        f"{trainer.planned_steps_per_epoch} steps/epoch over the dummy items)")
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
    return dict(split_ms=split, device_ms=span,
                split_of_span=sum(split.values()) / span)


def _split_line(t: dict) -> str:
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


def profile_kernels(torch, fn, names, calls: int = 3) -> dict:
    """Device ms of one ``fn()`` in the kernels whose names contain each of
    ``names`` (:func:`profile_split`)."""
    return profile_split(torch, fn, names, calls)[0]


# a spin kernel (torch.cuda._sleep) of this many cycles before each call
# of a profiled function: it marks where one call's kernels start
SPIN_CYCLES = 20000
TRACE_TRIES = 3


def device_trace(torch, run):
    """``(name, start, end)`` of every device event in a torch.profiler
    trace of ``run()``. A trace that holds no device events at all is taken
    again (such traces have come back from the card), up to TRACE_TRIES
    times; fails after that."""
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
    fail(f"{TRACE_TRIES} profiler traces held no device events")


def profile_split(torch, fn, names, calls: int = 3):
    """``(split, span_ms)`` of one ``fn()`` from a torch.profiler trace of
    ``calls`` calls, each after a spin kernel that marks where its kernels
    start. ``split``: device ms in the kernels whose names contain each of
    ``names``, the mean launch of a name times its launches per call, so a
    launch the trace dropped (single-call traces lost one kernel of a
    multi-kernel call) does not count as 0 ms. ``span_ms``: the median over
    calls of a call's first kernel start to its last kernel end, the gaps
    between its kernels included. Fails without device events
    (:func:`device_trace`), and when a named kernel is missing from every
    call (the names seen are printed)."""
    fn()
    torch.cuda.synchronize()

    def marked_calls():
        for _ in range(calls):
            torch.cuda._sleep(SPIN_CYCLES)
            fn()

    events = sorted(device_trace(torch, marked_calls), key=lambda e: e[1])
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


def _split_text(step_ms: float, split: dict) -> str:
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
    TOP_OTHER largest kernels of "other" by name under ``label``."""
    split = {f: 0.0 for f in ("attention forward", "attention backward",
                              "layer_norm forward", "layer_norm backward")}
    split.update({f: 0.0 for f, _ in TRAIN_FAMILIES})
    split["other"] = 0.0
    others = {}
    for name, start, end in device_trace(torch, fn):
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
    Informative only: a trace without device events prints 'not measured'."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
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
              int8["layer_norm_fwd"] + ln_train["layer_norm_fwd"],
              ln_fwd_err, ln_fwd, "16384x768 bf16 (32x512, training)",
              source="layer_norm",
              launches_by_path={"serving int8": int8["layer_norm_fwd"],
                                "training fused": ln_train["layer_norm_fwd"]},
              device_ms=ln_fwd["device_ms"], host_ms=ln_fwd["host_ms"],
              at_32x384={k: ln_serve[k] for k in (
                  "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                  "bound_ms", "with_codes")}),
        entry("layer_norm_bwd", "ml_recipe_tpu/ops/layer_norm.py:96",
              ln_train["layer_norm_bwd"], ln_bwd_err, ln_bwd,
              "16384x768 bf16 (32x512, training)", source="layer_norm",
              device_ms=ln_bwd["device_ms"], host_ms=ln_bwd["host_ms"],
              device_ms_by_kernel=ln_bwd["split_ms"],
              by_shape={f"{N}x{C}": {k: t[k] for k in (
                  "ms", "device_ms", "host_ms", "split_ms", "plain_ms",
                  "library_ms", "bound_ms")}
                  for (N, C, kind), t in ln_t.items() if kind == "bwd"}),
        entry("q8_matmul", "ml_recipe_tpu/ops/quant_matmul.py:85",
              int8["q8_matmul"], q8_err, q8_ffn,
              "M=12288 K=768 N=3072, + bias, bf16 out (32x384 FFN in, int8 "
              "serving)", sass=q8_sass,
              by_shape={f"{M}x{K}x{N}": t for (M, K, N), t in q8_t.items()}),
        entry("q8_quantize_rows",
              "none: port-only; the JAX package's quantize_rowwise "
              "(ml_recipe_tpu/ops/quant_matmul.py:62) is XLA, no pallas_call",
              int8["q8_quantize"], quant_err, quant_t[(12288, 768)],
              "12288x768 bf16 (32x384 attention context, int8 serving)",
              source="q8_matmul",
              by_shape={f"{M}x{K}": t for (M, K), t in quant_t.items()}),
    ]
    say(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "ml_recipe_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "ml_recipe_tpu/ops/flash_attention.py:129",
        "launches": (serving_fwd + train_fwd + int8["fused_attention_fwd"]
                     + ln_train["fused_attention_fwd"]),
        "launches_by_path": {"serving": serving_fwd, "training": train_fwd,
                             "serving int8": int8["fused_attention_fwd"],
                             "training fused": ln_train["fused_attention_fwd"]},
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
        "launches": train_bwd + ln_train["fused_attention_bwd"],
        "launches_by_path": {"serving": 0, "training": train_bwd,
                             "training fused": ln_train["fused_attention_bwd"]},
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
    sys.exit(main())
