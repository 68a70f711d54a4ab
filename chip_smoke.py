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
   without LDGSTS or UTMALDG); and ``make -C native`` (the C++ tokenizer:
   ``native/build/`` is git-ignored), fatal unless the tokenizer then
   loads, so every phase tokenizes in C++ (phases 10, 14 and 19 print the
   backend);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (bert-base: 12 heads of
   64), bf16 and f32, with key masks, segments (all-masked pad rows
   included), dropout and the logsumexp output; the autograd Function's
   gradients against ``torch.autograd`` through the plain forward; then
   timings by CUDA events (median of several runs) of each kernel, its
   plain version and one PyTorch library call computing the same function,
   beside the least time the card could take (``bound_ms``);
3. the serving path at full width: ``config/serve.cfg --aot_cache off``
   (eager dispatch: every batch launched by the wrappers; phase 17 runs the
   same with the buckets' CUDA graphs) through the parsers, the warm-up
   plane's configuration, ``compose.init_model`` (bert-base-uncased, 12
   layers, bf16, seeded random weights, a synthetic vocab), ``QAEngine``
   over the ``8x128,8x384,32x384`` grid, warmup (the memory pre-flight's
   measured forward, one run and the measured cost's timed runs per
   bucket) and ``QAServer`` on port 0, then concurrent ``POST /v1/qa``
   requests reaching both seq buckets and a full 32-row batch. Launch
   counts are set to 0 just before this phase and read just after: the
   forward kernel must have run exactly 12 times per device batch (warmup's
   forwards included), the backward never. One full batch is scored again
   with the plain attention and must agree;
4. the training path at full width: ``config/test_bert.cfg`` through the
   trainer and model parsers, ``check_train_flags``, then the build and
   train sequence of ``ml_recipe_tpu_torch.cli.train`` (bert-base-uncased,
   bf16 compute, f32 master weights, 2 debug steps of 8 micro-batches of
   32x512, an eval after each epoch). Launch counts are set to 0 just before
   the training run and read just after: the backward kernel must have run
   12 times per micro-batch and the forward 12 times per micro-batch and
   per eval batch. The memory pre-flight's probes (one micro-batch forward
   and backward each, no update, before the first step) are counted apart
   in every training phase, and must have launched the backward 12 times
   each. Losses must be finite and the parameters must have moved.
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
8. int8 serving: phase 3's eager 10-request burst with ``--quantize int8
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
    times and the global-shape dropout draw's extra cost are printed;
12. the fine-tune's training options at full width: a seeded random
    bert-base HF checkpoint (f32, ``bert.`` prefix) written as
    ``pytorch_model.bin`` and as ``model.safetensors``, each loaded through
    ``compose.init_model`` (every encoder leaf ``torch.equal`` to its
    source, the heads their seeded init); ``config/test_bert.cfg
    --ln_impl fused --hf_checkpoint DIR --optimizer adamod
    --apex_loss_scale dynamic --async_checkpoint`` trained through phase
    4's sequence (counts zeroed just before and read just after: phase 9's
    counts), losses finite and the scale 2^15 after both steps; the
    optimizer step alone, AdaMod against adam; one 32x512 micro-batch's
    gradient at scale 2^15, unscaled, against scale 1 within
    LS_GRAD_REL_TOL; a planted overflow (the dynamic state at 2^127 and an
    infinite gradient in the classifier bias) leaving the parameters,
    AdaMod's three moments and the counts ``torch.equal`` and the scale at
    2^126; an async checkpoint byte-equal to a sync save of the same state,
    with the snapshot's, the persist's and the sync save's seconds; one
    fine-tune step (``--finetune --finetune_position --finetune_class``,
    counts zeroed just before and read just after: the forward launches
    of 8 micro-batches, no backward launch), the encoder equal to the warm
    start and both heads moved, and the micro-batch's device time with the
    encoder frozen and trained;
13. serving's caches, trace spans and the fleet: a seeded random bert-base
    checkpoint, then ``python -m ml_recipe_tpu_torch.cli.fleet -c
    config/fleet.cfg`` (two engines on the card behind the hash router,
    both caches at 64M, trace spans on) as a child process. FLEET_DOCS
    documents of 2-6 windows at 384, each asked two questions, go through
    the router one at a time, cold, then hot: every hot response equals
    its cold one, every request for a document reaches one engine, the hot
    pass launches no device batch and hits both caches for every request
    and window, and the cold pass's doc-cache hits equal the document
    count (the two questions of a document have one length). Then SIGHUP
    asks for a rolling restart while a client keeps sending the set: 0
    failed requests, clean drains, and every replacement reports 0 kernel
    builds, 0 ``qa_aot_cache_misses_total`` and at least one library
    loaded from the store the engines share (``artifacts/aot``, which the
    first engines warmed); answers after it equal the cold ones. Each engine loads at least one built library, logs the
    fused attention route at both starts and writes a trace file holding
    the six serving spans for a router-forwarded request id; SIGTERM ends
    the fleet with 0. The engines' attention launches are read from their
    /metrics (each process starts at 0). 13b: one ``cli.serve`` engine
    (``build_engine``) with ``--quantize int8 --ln_impl fused`` and both
    caches, the documents' first questions twice (counts zeroed just
    before its warmup: phase 8's launches per device batch, none on the
    hot pass, hot equal to cold). Latency percentiles, hit rates,
    requests per engine and the restart's seconds are printed;
14. sequence packing on phase 10's corpus: the copied test_bert.cfg with
    ``--sequence_packing on --pack_splitting fill --ln_impl fused``
    (bert-base, 32 packed rows of 512 per micro-batch, up to 8 segments a
    row) through phase 4's sequence, counts zeroed just before and read
    just after (12 segmented attention and 25 LayerNorm launches per
    micro-batch and packed eval batch forward, per micro-batch backward),
    ``last.ch`` saved; each step's rows, segments, fragments and pad
    tokens, the packing efficiency beside phase 10's bucketed padding, and
    the step walls and data waits of both phases (the tokenizer backend
    printed). The 12 attention calls of the run's first packed micro-batch,
    each on its own q, k, v, segment ids and seeds, kernel against plain
    forward (out, lse) and backward at phase 2's limits, the pad positions
    finite with zero gradients; the segmented pair timed there beside
    ``scaled_dot_product_attention`` with the block-diagonal boolean mask.
    Then ``cli.validate`` (config/validate.cfg) on that ``last.ch`` over
    PACK_VAL_DOCS test documents, with ``--sequence_packing on
    --pack_splitting fill`` and without (counts zeroed just before each:
    12 launches per batch): both score the same chunks, every packed score
    finite; the largest per-chunk score gap is printed, not gated. The
    last packed validate batch's 12 attention calls (pad tails) are held
    kernel against plain as validate ran them, and again with dropout 0.1,
    kernel and plain both against the plain version in f32 (TRUTH_RATIO).
    The packed run's LR plan replays phase 10's item metas (the same
    corpus, sampler and seed) instead of tokenizing the items again;
15. sequence parallelism and ZeRO-1: the script starts itself again as
    two ranks of ``cli.train`` (``--sp-worker``, gloo on the card):
    ``config/longdoc.cfg --dummy_dataset --debug --seed 7`` (bert-base's
    widths cut to SP_LAYERS layers, as every run of the phase,
    ``mesh=data:1,seq:2``, 8192 tokens, ``--remat``, dropout 0.1: each
    rank holds 2x4096 of every 2x8192 micro-batch, every attention a ring
    over the two ranks whose hops stage through pinned host buffers).
    Counts zeroed just before and read just after: 2 forward launches a
    ring call (twice a layer and micro-batch under remat, once a layer
    and eval batch), 2 backward a layer and micro-batch, and the hops
    counted (1 a forward ring call, 2 a backward); the ranks' losses and
    weights equal. The same run in this process at ``--mesh data:1`` (one
    2x8192 call a layer): the step-1 loss within SP_LOSS_REL_TOL and the
    gradient at the clip within SP_GRAD_REL_TOL of the ring's. Every hop
    of the ring calls captured at the first and the last layer of both
    ranks (rows and columns at bases 0 or 4096, ``L_hash`` 8192), kernel
    and plain against the f32 plain version (TRUTH_RATIO), forward and
    backward on the merged output and lse; the hops merged equal the
    ring's training output bit for bit, and within ATOL of one kernel
    call over all 8192; one hop timed beside its bound, plain and sdpa.
    Then ``config/long_context.cfg --dummy_dataset --debug --seed 0
    --dist_world_size 2`` as two ranks with its ZeRO-1 and as two with
    ``--optimizer_sharding off``, all four at once (cuBLAS's
    deterministic workspace): launch counts, the optimizer bytes each
    rank holds (zero1: at most half of the whole), the parameters after
    both runs bit-identical, and the zero1 run's sharded checkpoint
    reloaded in this process (weights and every moment equal).
16. the runtime subsystems (``phase_runtime``): ``config/test_bert.cfg
    --dummy_dataset --debug --seed 0 --ln_impl fused`` through ``python -m
    ml_recipe_tpu_torch.cli.train`` as a child process with ``--trace
    --trace_spans --metrics_port --goodput_ledger --flight_recorder
    --watchdog_timeout 600``: ``/metrics`` and ``/healthz`` scraped after
    its first step (the step, the watchdog's heartbeat, the kernel
    libraries loaded and none built, the ledger's ratio); the profiler
    window's Chrome trace holding one step's launches (12 attention and 25
    LayerNorm kernels per micro-batch, forward and backward), its device
    ms by kernel family printed; the span file's training spans; the
    child's own launch counts (phase 9's); the run's exit code gates the
    phase (a capture without CUDA activity moves the window to the next
    step; the run fails when every capture came back empty). Then the
    resume drill, on test_bert.cfg copied with ``debug`` and
    ``drop_optimizer`` off, bert-base cut to RT_DRILL_LAYERS of its layers
    (``$SMOKE_LAYERS``), its dummy datasets cut to RT_DUMMY_LEN items
    (2 epochs of 2 steps, each ending in ``last.ch``; the observer writes
    no checkpoint copy that nothing reads): a plain
    uninterrupted run; the same resumed by hand from its ``epoch_1.ch``
    with every runtime flag but ``--trace`` (untraced); and every runtime
    flag under ``--supervise --fault_plan 'trainer.step:kill@3!once'``,
    which must end rc 0 after a crash and a clean attempt, its attempt 2
    resuming step RT_RESUME_STEP (the ledger, the ``checkpoint_restore``
    span), what its restore carried and its parameter update within
    RT_UPDATE_REL_TOL relative L2 and its last-step loss within
    RT_LOSS_REL_TOL of untraced's; step 1's wall of each run beside
    plain's, the ledger's goodput summary and the restart gap are
    printed. An observer the phase puts on the children's PYTHONPATH
    (``sitecustomize``, RT_OBSERVER) records each run's steps, launch
    counts, restored state and parameter update, and cuts the drill's
    dummy datasets.
17. the warm-up plane (``phase_warmup_plane``), on a fresh temporary
    library store and tuning cache: the script starts itself as a cold
    engine process (``--warm-engines``: ``config/serve.cfg`` in bf16, then
    ``--quantize int8 --ln_impl fused``, through ``cli.serve``'s
    ``build_engine`` and warmup), whose store misses must be the libraries
    it built, then as a warm one on the same store, which must build
    nothing, miss nothing and load every library from it;
    ``python -m ml_recipe_tpu_torch.ops.aot --verify`` must exit 0.
    Meanwhile: ``config/test_bert.cfg --dummy_dataset --debug`` with the
    card's memory stood in by a limit below the need phase 4 measured at
    ``batch_split`` 8 (phase 4, at the card's own limit, must have changed
    nothing), which must raise the split and run its steps; and phase 3's
    burst with graphs under a limit between the measured needs of
    ``8x384`` and ``32x384``, which must drop ``32x384`` alone and still
    answer at 384. Then phase 3's and phase 8's bursts with every bucket's
    CUDA graph (12, and 77 / 25 / 25 / 12, launches per device batch);
    each kept bucket's replay on a real batch ``np.array_equal`` to the
    eager forward with one forward's launches; and, beside the eager
    figures, on a 32x384 batch the host ms to issue it, its device ms, the
    host ms of a whole batch, the device idle share of each, and the
    bursts' p50.
18. the elastic pod and bucketed ZeRO-1 (``phase_elastic``):
    ``config/test_bert.cfg``'s 2 debug steps as two gloo ranks of the CLI
    on ``--mesh data:2`` (bert-base's widths at EL_PAIR_LAYERS layers),
    ZeRO-1 with ``--zero1_overlap off``, with
    ``bucketed`` and without ZeRO-1: off bit-identical to the replicated
    pair, bucketed within the ZeRO-1 pins of off (losses ``rtol`` 2e-5,
    parameters ``atol`` 5e-5), the bucket count and step walls printed.
    Then the elastic drill on phase 16's resume copy of the cfg: two
    supervisors (hosts 0 and 1) with ``--supervise --elastic on`` on
    ``--mesh data:2 --optimizer_sharding zero1 --zero1_overlap bucketed``,
    host 1's child killed at its third step by ``--fault_plan
    'trainer.step:kill@3%host1'`` and host 1's supervisor killed as soon
    as the child is gone: host 0 must end rc 0 with ``host-lost`` among
    its outcomes, relaunched as rank 0 of 1 within 3 x ``--host_timeout``
    of the kill, resuming epoch 1's checkpoint on ``data:1``; the ledger's
    ``hosts_lost`` 1 and the flight recorder's ``host_lost`` and
    ``mesh_shrunk``; the resumed run's update and last loss within phase
    16's tolerances of the same resume by hand in one process; both
    attempts launching the attention and LayerNorm kernels.
19. pipeline parallelism (``phase_pipeline``): ``config/test_bert.cfg``'s
    2 debug steps with ``--ln_impl fused`` and dropout 0 as two gloo ranks
    of the CLI on ``--mesh pipe:2`` (bert-base's widths at PP_LAYERS
    layers: stage 0 the embeddings and layers 0..1, stage 1 layers 2..3
    and the heads), on GPipe and then on 1F1B, and in this process at
    ``data:1``: each rank's launches equal its stage's path (2 attention
    and 5 or 4 LayerNorm launches per
    micro-batch and eval batch forward, as many backward per
    micro-batch), GPipe and 1F1B within PP_SCHEDULE_TOL, pipe:2 against
    one process within PP_LOSS_REL_TOL and PP_UPDATE_REL_TOL; per rank
    the step walls, the stage transport's sends, bytes and seconds, the
    measured (a step's share waiting on the other stage) and the modeled
    bubble, peak CUDA memory and the parameter and moment bytes. Then
    ``--mesh data:2,pipe:2 --optimizer_sharding zero1
    --sharded_checkpoint`` as four ranks for one debug step and its save,
    which must peek as the stage layout with 4-way pieces and reload in
    one process bit for bit.
20. tensor parallelism (``phase_tensor_parallel``):
    ``config/test_bert.cfg --ln_impl fused --train_batch_size 64
    --batch_split 2 --test_batch_size 4`` (bert-base at full width and
    depth, dropout 0.1, 2 debug steps of 2 micro-batches of 32x512) as two
    gloo ranks of the CLI
    on ``--mesh model:2`` (6 heads and 1536 MLP columns a rank), and at 2
    layers in f32 on the plain attention and LayerNorm, each against the
    same in this process at ``data:1``: f32 within TP_F32_LOSS_RTOL and
    TP_F32_GRAD_REL (loss, whole gradient at the first clip), bf16 within
    TP_BF16_LOSS_RTOL (loss); each rank's launches its path's (12
    attention and 25 LayerNorm launches per micro-batch and eval batch,
    backward per micro-batch) and 2 forward and 2 backward all-reduces a
    layer through the host. Then ``--mesh data:2,model:2
    --optimizer_sharding zero1 --sharded_checkpoint`` at 4 layers as four
    ranks for one debug step and its save, which must peek ``mesh_axes``
    {data: 2, model: 2} with 4-way pieces and reload in one process bit
    for bit. Per rank: step walls and their all-reduce seconds, the
    transport's all-reduces, bytes and seconds, parameter and moment
    bytes, peak CUDA memory. Then, on the card alone, both attention
    kernels at a model:2 rank's shape (32x512x6x64 bf16, dropout 0.1 at
    the rank's seed offset, whose dropout uniforms are one process's for
    its heads bit for bit) against their plain versions, timed beside
    sdpa.
21. pipe x model (``phase_pipe_model``): ``config/test_bert.cfg`` at
    ``pipe:2,model:2`` and ``data:2,pipe:2,model:2`` (PM_RUNS), then the
    LayerNorm pair and the attention pair at a rank's shapes on the card
    alone.

For the time limit, three side lanes (SIDE_LANES, ``--side-phases``) run
phases in a process of their own beside the main process's: 19 and 20
beside 10 and 11, 21 beside 12 and 13, 16 beside 15 and 17. No kernel
time of the kernels line is taken beside a lane (phase 14 runs alone,
phase 15's ring hop is timed once lane c joined), nor phase 18's drill,
which holds a relaunch time. Every line either
process prints while a lane runs ends in ``[contended: beside ...]``: its
times were taken on a card and host cores that another process shared.

It then prints one ``{"kernels": [...]}`` line (the attention kernels'
lines carry the tensor-core kernels' resources and every timed shape's
``ms`` and ratio to ``scaled_dot_product_attention`` under ``by_shape``)
and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or outside a checkout
of the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import atexit
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


# what the printing process's phases run beside (a side lane, or the main
# process's phases), named on every line printed meanwhile: the times on
# such a line were taken on a card and host cores that another process
# shared
BESIDE: list = []


def say(msg: str) -> None:
    if BESIDE:
        msg = f"{msg} [contended: beside {BESIDE[-1]}]"
    print(msg, flush=True)


def start_native_build():
    """``make -C native`` started (the C++ tokenizer and coordination
    helper; ``native/build/`` is git-ignored, so a checkout has none), to
    run beside the kernels' build: ``(process, log file)``."""
    import shutil
    import tempfile

    log = tempfile.TemporaryFile("w+")
    if shutil.which("make"):
        cmd = ["make", "-C", str(REPO / "native")]
    else:   # the Makefile's rules, for a machine without make
        cxx = "g++ -O2 -std=c++17 -fPIC -Wall"
        cmd = ["sh", "-c", f"mkdir -p build && {cxx} -shared -o "
               f"build/libqatok.so qatok/wordpiece.cc qatok/bpe.cc && {cxx} "
               f"-shared -o build/libqacoord.so coord/coord.cc && {cxx} "
               f"-DQACOORD_MAIN -o build/qacoord coord/coord.cc"]
    return subprocess.Popen(cmd, cwd=str(REPO / "native"), stdout=log,
                            stderr=subprocess.STDOUT, text=True), log


def finish_native_build(started, t0: float) -> None:
    """Wait for :func:`start_native_build`; fails unless the C++ tokenizer
    then loads, so every phase tokenizes in C++."""
    proc, log = started
    try:
        rc = proc.wait(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "a timeout"
    log.seek(0)
    out = log.read()
    log.close()
    if rc != 0:
        fail(f"the native build ended with {rc}: {out[-2000:]}")
    from ml_recipe_tpu_torch.tokenizer import native as native_tok

    say(f"native build: {' '.join(proc.args)} done "
        f"{time.perf_counter() - t0:.1f}s into the smoke (beside the kernel "
        f"build); the C++ tokenizer loads: {native_tok.available()}")
    if not native_tok.available():
        fail("the native tokenizer did not load after its build")


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
            say(f"spill bytes of {lib.source.name}'s kernels: not checked "
                f"(library loaded from the store, no ptxas report in this "
                f"run)")
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
    q8.LIBRARY.lib()              # its bytes, from the build or the store
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    so = OUT_DIR / f"{q8.LIBRARY.name}.so"
    so.write_bytes(q8.LIBRARY.blob)
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump failed on the int8 library: {sass.stderr}")
    ops = {}
    for op in re.findall(r"\b(IMMA|IGMMA|HMMA|LDGSTS|UTMALDG|LDSM)\S*",
                         sass.stdout):
        ops[op] = ops.get(op, 0) + 1
    say(f"SASS of {q8.LIBRARY.source.name}'s library: instruction counts "
        f"{ops}")
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


def _serve_burst(torch, extra=(), *, dispatch="eager", planes=(),
                 limit_bytes=None, tag="", rounds=()):
    """``config/serve.cfg`` with ``extra`` flags through the parsers,
    ``check_serve_flags``, the warm-up plane's configuration
    (``cli.serve.configure_planes``), ``compose.init_model`` and
    ``QAEngine``, then the 10-request burst over HTTP. ``dispatch``
    ``eager`` adds ``--aot_cache off`` (every batch launched by the
    wrappers), ``graph`` keeps the store on (every batch a replay of its
    bucket's CUDA graph); ``planes`` are more warm-up flags, ``limit_bytes``
    the pre-flight's stand-in for the card's memory, ``tag`` a suffix of the
    label. Launch counts are set to 0 just before the warmup and read just
    after the burst. ``rounds`` are more bursts on the same engine and
    server after that, each ``graph`` or ``eager`` (the engine's graphs set
    aside for that burst: the smoke's own hook, no user option): back to
    back from one process state. Returns a namespace of what the checks
    read."""
    from ml_recipe_tpu_torch.cli.serve import configure_planes
    from ml_recipe_tpu_torch.config.parser import (
        check_serve_flags, get_model_parser, get_params, get_serve_parser)
    from ml_recipe_tpu_torch.ops import aot, autotune
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    label = " ".join(extra) or "bf16"
    if dispatch == "graph":
        label += ", graphs"
    if tag:
        label += f", {tag}"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(REPO / "config" / "serve.cfg"), "--vocab_file", vocab,
         "--port", "0", *extra, *planes,
         *(("--aot_cache", "off") if dispatch == "eager" else ())])
    check_serve_flags(params, model_params)
    configure_planes(params)
    try:
        return _burst(torch, params, model_params, label, dispatch,
                      limit_bytes, rounds)
    finally:
        # the process-wide planes back to their defaults for later phases
        aot.reset()
        autotune.reset()


# every burst's figures by label, and every _run_training's pre-flight
# report, for phase 17
BURSTS = {}
PREFLIGHT_REPORTS = []


def _burst(torch, params, model_params, label, dispatch, limit_bytes,
           rounds=()):
    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.data import labels2id
    from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
    from ml_recipe_tpu_torch.serve.engine import QAEngine
    from ml_recipe_tpu_torch.serve.server import QAServer

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
    warm = engine.warmup(hbm_preflight=params.hbm_preflight,
                         limit_bytes=limit_bytes)
    if warm["dispatch"] != dispatch:
        fail(f"serving ({label}) dispatched {warm['dispatch']}, not "
             f"{dispatch}")
    server = QAServer(engine, host=params.host, port=params.port,
                      request_timeout_s=params.request_timeout_s,
                      drain_timeout_s=params.drain_timeout_s)
    server.start()
    url = f"http://{server.host}:{server.port}"

    def send():
        """The burst: every request at once; its latencies in ms."""
        results = [None] * len(requests)

        def worker(i):
            q, d = requests[i]
            results[i] = _post(url, {"question": q, "document": d})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            fail("a request thread did not finish")
        deadline = time.monotonic() + 10   # the last batch's time is kept
        while len(batch_ms) < len(seen) and time.monotonic() < deadline:
            time.sleep(0.001)
        for i, (status, body, _) in enumerate(results):
            if status != 200 or body.get("label") not in labels2id:
                fail(f"request {i} answered {status}: {body}")
        return results, [seconds * 1e3 for _, _, seconds in results]

    t0 = time.perf_counter()
    results, lat = send()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launched = counts()             # the main path ends here
    batches = int(engine.m_batches.value)
    metrics = engine.render_metrics()
    n_main = len(seen)
    by_mode = {}
    for mode in rounds:
        graphs = engine._graphs
        if mode == "eager":
            engine._graphs = {}
        start = len(batch_ms)
        try:
            _, round_lat = send()
        finally:
            engine._graphs = graphs
        got = by_mode.setdefault(mode, {"latency_ms": [], "batch_ms": []})
        got["latency_ms"] += round_lat
        got["batch_ms"] += batch_ms[start:]
    del seen[n_main:], batch_ms[n_main:]    # the checks read the main burst
    server.stop()
    server.shutdown()
    n_chunks = sum(r[1]["n_chunks"] for r in results)
    # warmup's device forwards: the pre-flight's measured one, the graph's
    # side-stream run (or the eager run) and the cost's timed runs
    device_batches = warm["device_batches"] + batches
    say(f"serving ({label}): {len(results)} requests ({n_chunks} chunks) "
        f"answered 200 in {wall:.2f}s; {batches} traffic batches (seq, rows) "
        f"{seen} taking {batch_ms} ms + {warm['device_batches']} warmup "
        f"forwards over {len(warm['buckets'])} buckets ({warm['dispatch']} "
        f"dispatch); warmup seconds {warm['bucket_seconds']}; pre-flight "
        f"{warm['preflight']}, dropped {warm['dropped']}; measured costs "
        f"{warm['program_costs']}")
    say(f"serving ({label}): request latency ms p50="
        f"{statistics.median(lat):.1f} p95={np.percentile(lat, 95):.1f} "
        f"max={max(lat):.1f}")
    full = engine.grid.max_batch_for(384)
    if len(seen) != batches or (384, full) not in seen or \
            {seq for seq, _ in seen} != {128, 384}:
        fail(f"traffic did not reach both seq buckets and a full {full}-row "
             f"batch")
    BURSTS[label] = SimpleNamespace(p50=statistics.median(lat),
                                    batch_ms=list(batch_ms), warm=warm,
                                    seen=list(seen))
    return SimpleNamespace(model=model, tokenizer=tokenizer, engine=engine,
                           params=params, requests=requests, counts=launched,
                           device_batches=device_batches, warm=warm,
                           metrics=metrics, batch_ms=batch_ms, latency_ms=lat,
                           seen=seen, by_mode=by_mode)


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


def _train_flags(cfg_path: Path, extra=()):
    """The trainer and model flags of the cfg file at ``cfg_path`` with
    ``extra``, the synthetic vocab and the smoke's dump directory."""
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = OUT_DIR / "vocab.txt"
    if not vocab.exists():   # rank processes may be reading it (phase 19)
        write_synthetic_bert_vocab(vocab)
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        ["-c", str(cfg_path), "--vocab_file", str(vocab),
         "--dump_dir", str(OUT_DIR / "results"), *extra])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 2))
    return params, model_params


def _time_data_waits(trainer) -> list:
    """The seconds the training loop waits for each placed batch (its
    ``next`` on the loader's staged batches), appended to the list
    returned."""
    waits, batches = [], trainer._batches

    def timed(loader, name, *host_stats):
        it, prefetcher = batches(loader, name, *host_stats)
        if loader is not trainer.train_dataloader:
            return it, prefetcher

        def waited():
            while True:
                t0 = time.perf_counter()
                placed = next(it, None)
                if placed is None:
                    return
                waits.append(time.perf_counter() - t0)
                yield placed

        return waited(), prefetcher

    trainer._batches = timed
    return waits


def _run_training(torch, cfg: str, extra=(), setup=None, layers: int = 12):
    """``config/<cfg>`` (or the cfg file at the path ``cfg``) with ``extra``
    flags through the trainer and model parsers, ``check_train_flags`` and the build and train sequence of
    ``ml_recipe_tpu_torch.cli.train``, bert-base cut to ``layers`` encoder
    layers (:func:`_shallow`; 12: as built). The launch counts are set to 0 just
    before ``train`` and read just after; ``setup(trainer)`` runs before
    that, and the data waits of the run's training steps are kept in
    ``trainer.data_waits``. Returns the trainer, the trainer flags, every
    kernel's launch count less the memory pre-flight's probes (checked and
    printed apart, :func:`_without_probes`) and the wall seconds."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import check_train_flags

    cfg_path = cfg if isinstance(cfg, Path) else REPO / "config" / cfg
    cfg = cfg_path.name
    params, model_params = _train_flags(cfg_path, extra)
    check_train_flags(params, model_params)
    t0 = time.perf_counter()
    with _shallow(layers if layers != 12 else 0):
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
    if (model.cfg.num_layers != layers or model.dtype != torch.bfloat16
            or any(p.dtype != torch.float32 for p in model.parameters())):
        fail(f"the {cfg} training configuration is not bert-base with bf16 "
             f"compute and f32 master weights")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.data_waits = _time_data_waits(trainer)
    if setup is not None:
        setup(trainer)

    probe = _count_probes(trainer)
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
    launched = _without_probes(trainer, launched, probe)
    PREFLIGHT_REPORTS.append((cfg, tuple(extra), trainer.preflight_report))
    return trainer, params, launched, wall


def _count_probes(trainer) -> dict:
    """Count the launches of the memory pre-flight's probes (each one
    training micro-batch's forward and backward, no update) apart: wraps
    ``trainer._probe_step``. Returns the running tally."""
    tally = dict.fromkeys(KERNELS, 0)
    probe = trainer._probe_step

    def counted(*args, **kw):
        before = counts()
        try:
            return probe(*args, **kw)
        finally:
            for k, n in counts().items():
                tally[k] += n - before[k]

    trainer._probe_step = counted
    return tally


def _without_probes(trainer, launched: dict, tally: dict) -> dict:
    """``launched`` less the pre-flight probes' launches (the phases' count
    formulas are of the training steps and eval batches), after checking
    that the probes ran on the card, each with one micro-batch's attention
    backward (``layers`` launches, or one a ring hop)."""
    probes = trainer.preflight_probes
    layers = trainer.model.cfg.num_layers
    report = trainer.preflight_report or {}
    say(f"memory pre-flight: {probes} probe(s), split "
        f"{report.get('batch_split_before')} -> {report.get('batch_split')}, "
        f"need {report.get('bytes') or report.get('buckets')} B of "
        f"{report.get('limit_bytes')} B; probe launches {tally}")
    bwd = tally["fused_attention_bwd"]
    if trainer.hbm_preflight and (probes < 1 or not bwd
                                  or bwd % (layers * probes)):
        fail("the memory pre-flight did not run its probes on the card")
    return {k: n - tally[k] for k, n in launched.items()}


def _batch(torch, trainer, rows: int):
    """The first ``rows`` training items, collated, on the card:
    ``(inputs, labels)``."""
    items = [trainer.train_dataloader.dataset[i] for i in range(rows)]
    inputs, labels = trainer.collate_fun(items)[:2]
    return ({k: torch.from_numpy(v).cuda() for k, v in inputs.items()},
            {k: torch.from_numpy(v).cuda() for k, v in labels.items()})


def _micro_batch(torch, trainer, rows: int):
    """``fwd_bwd(impl="auto", seed=0)``: one micro-batch of ``rows`` dummy
    items through the model's forward, the loss and backward, dropout drawn
    from a generator seeded with ``seed``, attention by ``impl``."""
    model = trainer.model
    inputs, labels = _batch(torch, trainer, rows)
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

# documents of the synthetic NQ corpus (2048 until phase 21 joined the
# smoke: half the corpus halves phase 10's preprocess and LR plan, which
# run on the host beside phases 19 and 20, and phase 14's; a cut for the
# smoke's time limit)
NQ_DOCS = 1024
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
    from ml_recipe_tpu_torch.tokenizer import Tokenizer

    nq = OUT_DIR / "nq"
    shutil.rmtree(nq, ignore_errors=True)
    nq.mkdir(parents=True)
    # written when missing: phases 19 and 20's ranks run beside this phase
    vocab = str(_vocab())
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
    pad_share = (loader.epoch_stats or {}).get("padding_waste_pct")
    say(f"nq training: data wait seconds before each step "
        f"{[round(w, 3) for w in trainer.data_waits]}; the last epoch's "
        f"bucketed batches {pad_share}% padding (tokenizer backend "
        f"{trainer.collate_fun.keywords['tokenizer'].backend})")
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
                          test_batch_size=params.test_batch_size,
                          pad_share=pad_share, data_waits=trainer.data_waits,
                          step_walls=[h["seconds"] for h in trainer.history],
                          plan_metas=dict(loader._len_cache))
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
    plain version at ATOL, or one bf16 step of |out| where that is wider
    (phase 14's allowance: a trained model's deep layers pass |out| = 4,
    where bf16's spacing exceeds ATOL; the kernel at the path's own tiles
    and padding).
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
    errs, steps, top = [], [], 0.0
    with torch.inference_mode():
        for q, k, v, mask in layers:
            got = fa.fused_attention_cuda(q, k, v, mask)
            ref = fa.fused_attention_plain(q, k, v, mask).float()
            diff = (got.float() - ref).abs()
            errs.append(diff.max().item())
            # phase 14's allowance: ATOL, or one bf16 step of |out| where
            # that is wider (past |out| = 4 on a trained model's layers)
            step = torch.exp2(torch.floor(torch.log2(
                ref.abs().clamp(min=1e-30)))) / 128
            steps.append((diff / step.clamp(min=ATOL["bf16"])).max().item())
            top = max(top, ref.abs().max().item())
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
        f"{max(errs):.3e} (tol {ATOL['bf16']:g}, or one bf16 step of |out| "
        f"where wider: {max(steps):.3f} of the limit; max|ref| {top:.3f}), "
        f"by layer {[float(f'{e:.3e}') for e in errs]}")
    say(f"validate: the same batch end to end (recorded, not a gate): plain "
        f"attention moves the scores by at most {sound:.4f} and leaves "
        f"{same_p} of {n_ids} span/label ids equal; keys 64..127 dropped in "
        f"the kernel moves them by {fault:.4f}, {same_f} of {n_ids} equal; "
        f"the scoring forward alone {forward_ms:.3f} ms (CUDA events, no "
        f"loader running)")
    if len(errs) != model.cfg.num_layers or max(steps) > 1.0:
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


# phase 14: sequence packing on phase 10's corpus
PACK_FLAGS = ["--sequence_packing", "on", "--pack_splitting", "fill",
              "--ln_impl", "fused"]
PACK_VAL_DOCS = 24                 # test documents of the validate pair
PACK_VAL_WORDS = 1500              # ... each of at most this many words


@contextmanager
def _capture_attention(torch, n: int, last: bool = False):
    """The first (or with ``last`` the last) ``n`` calls of the encoder's
    attention inside the block, each's q, k, v, key mask, segment ids, row
    seeds and rate, cloned; the calls themselves run as before."""
    from collections import deque

    from ml_recipe_tpu_torch.models import encoder
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    calls, dpa = deque(maxlen=n if last else None), encoder.dot_product_attention

    def attention(q, k, v, mask, **kw):
        if last or len(calls) < n:
            seed, seg = kw.get("seed"), kw.get("segment_ids")
            B, _, H, _ = q.shape
            calls.append(SimpleNamespace(
                q=q.detach().clone(), k=k.detach().clone(),
                v=v.detach().clone(), mask=mask.clone(),
                seg=None if seg is None else seg.to(torch.int32).contiguous(),
                seeds=(None if seed is None
                       else fa.row_seeds(seed, B, H, q.device)),
                rate=kw.get("dropout_rate", 0.0)))
        return dpa(q, k, v, mask, **kw)

    encoder.dot_product_attention = attention
    try:
        yield calls
    finally:
        encoder.dot_product_attention = dpa


def _record_packed_batches(trainer) -> list:
    """Each packed training batch the loader emits, as ``(epoch, rows,
    segments, fragments, pad tokens)`` (debug steps take the first of each
    epoch; the prefetcher reads ahead)."""
    loader, seen = trainer.train_dataloader, []
    emit = loader._emit

    def recorded(rows, stats, **kw):
        b = emit(rows, stats, **kw)
        frags = (int((b.provenance["chunk_id"] >= 0).sum())
                 if b.provenance is not None else 0)
        seen.append((loader._epoch, b.rows, b.segments, frags,
                     int((b.inputs["segment_ids"] == 0).sum())))
        return b

    loader._emit = recorded
    return seen


@contextmanager
def _plan_metas(metas):
    """Inside the block a packed training loader (not ``pad_last``) starts
    its planning cache with ``metas``: phase 10's ``(length, start_id,
    end_id)`` of each item its LR plan read, on the same corpus, sampler
    and seed, so the packed plan replays them instead of tokenizing the
    same items again; an index missing from them is read as before."""
    from ml_recipe_tpu_torch.data.packing import PackedDataLoader

    init = PackedDataLoader.__init__

    def seeded(self, *args, **kw):
        init(self, *args, **kw)
        if metas and not self.pad_last:
            self._len_cache.update(metas)

    PackedDataLoader.__init__ = seeded
    try:
        yield
    finally:
        PackedDataLoader.__init__ = init


def _segment_pairs(seg) -> int:
    """The (query, key) pairs a block-diagonal mask allows: the sum over
    rows and non-zero segment ids of the segment's length squared (pad
    positions, id 0, attend to nothing)."""
    n = 0
    for row in seg.cpu().numpy():
        lens = np.bincount(row)[1:]
        n += int((lens.astype(np.int64) ** 2).sum())
    return n


def _hold_segmented_calls(torch, calls, what: str):
    """Each captured segmented attention call, on its own q, k, v, segment
    ids, seeds and rate, kernel against plain: forward (out, lse) at phase
    10's limits (out within ATOL, or within one bf16 step of the plain
    value where that step is wider: past |out| 4, where a trained model's
    deep layers go, ATOL is narrower than one bf16 step), and backward
    with a seeded random cotangent at phase 2's;
    the pad positions (id 0) keep a finite output and lse and take exactly
    zero dq, dk and dv. Fails on any miss; returns the largest forward
    and backward errors."""
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    fwd_errs, lse_errs, bwd_errs, bwd_ok, pad_ok = [], [], [], True, True
    fwd_steps = []   # each call's largest |out - ref| over its limit
    g_gen = torch.Generator(device="cuda").manual_seed(14)
    for c in calls:
        args = (c.q, c.k, c.v, c.seg, c.seeds, c.rate, True, True)
        out, lse = fa.fused_attention_cuda(*args)
        ref, ref_lse = fa.fused_attention_plain(*args)
        g = torch.randn(c.q.shape, generator=g_gen, device="cuda",
                        dtype=torch.float32).to(c.q.dtype)
        bargs = (c.q, c.k, c.v, g, ref, ref_lse, c.seg, c.seeds, c.rate, True)
        got = fa.fused_attention_bwd_cuda(*bargs)
        want = fa.fused_attention_bwd_plain(*bargs)
        torch.cuda.synchronize()
        pad = c.seg == 0
        diff = (out.float() - ref.float()).abs()
        fwd_errs.append(diff.max().item())
        bf16_step = torch.exp2(torch.floor(torch.log2(
            ref.float().abs().clamp(min=1e-30)))) / 128
        fwd_steps.append((diff / bf16_step.clamp(min=ATOL["bf16"])).max()
                         .item())
        lse_errs.append((lse - ref_lse).abs().max().item())
        ok, errs, _, _ = _bwd_check(torch, got, want, "bf16")
        bwd_ok &= ok
        bwd_errs.append(max(errs))
        pad_ok &= bool(torch.isfinite(out.float()).all()
                       and torch.isfinite(lse).all()
                       and all(bool((x[pad] == 0).all()) for x in got))
    c = calls[-1]
    B, L = c.q.shape[:2]
    say(f"{what} {B}x{L}: {int((c.seg == 0).sum())} pad positions, "
        f"{int((c.seg.amax(1) == 0).sum())} rows all pad, segment ids up to "
        f"{int(c.seg.max())}, rate {c.rate:g}; each of its {len(calls)} "
        f"attention calls kernel vs plain: forward max_abs_err "
        f"{max(fwd_errs):.3e} (tol {ATOL['bf16']:g}, or one bf16 step of "
        f"|out| where wider: {max(fwd_steps):.3f} of the limit), lse "
        f"{max(lse_errs):.3e} (tol {LSE_ATOL:g}); backward max_abs_err "
        f"{max(bwd_errs):.3e} (phase 2's bf16 limits: "
        f"{'ok' if bwd_ok else 'FAIL'}); outputs and lse finite, pad "
        f"positions with zero dq/dk/dv: {pad_ok}")
    if (max(fwd_steps) > 1.0 or max(lse_errs) > LSE_ATOL
            or not bwd_ok or not pad_ok):
        fail(f"a segmented attention kernel disagrees with plain on the "
             f"{what}")
    return max(fwd_errs), max(bwd_errs)


# The last packed validate batch held again with dropout 0.1. On a
# trained model's deep layers |out| passes 4 and dq comes out of a near
# cancellation (|dq| ~0.03 from terms of |ds| x |k| ~1): outside the
# domain that ATOL and phase 2's limits were set on (|out| < 4, unit-normal
# inputs), the kernel and the plain version, both rounding to bf16 at the
# same points, differ there by the bf16 noise of the summed terms (one
# bf16 step of |out| past 4 exceeds ATOL; a dq mostly rounding noise
# exceeds BWD_REL_L2; both are printed). So both are held
# against the same function evaluated in f32, and the kernel must come as
# close to it as the plain version does: its relative L2 error within
# TRUTH_RATIO of the plain version's for out, dq, dk and dv. A wrong keep
# bit, scale or rounding point moves it more (a misplaced bf16 rounding
# point adds ~2.6e-3 to a ~2.4e-3 error of dk and dv: 1.46x).
TRUTH_RATIO = 1.1


def _hold_against_f32(torch, calls, what: str):
    """Each captured segmented call, kernel and plain in bf16 on its own q,
    k, v, segment ids, seeds and rate, against the plain version in f32 on
    the same inputs: forward (out; lse within LSE_ATOL of plain's) and
    backward with a seeded random cotangent, the kernel's relative L2
    error within TRUTH_RATIO of the plain version's; the pad positions
    (id 0) keep a finite output and lse and take exactly zero dq, dk and
    dv. Fails on any miss; returns the largest kernel-vs-plain forward and
    backward errors."""
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    def rel(a, t):
        return ((a.float() - t).norm() / t.norm()).item()

    ratio, fwd_errs, lse_errs, bwd_errs, pad_ok = 0.0, [], [], [], True
    phase2_ok, rels, far = True, [], (0.0, 0.0)   # far: kernel, plain
    g_gen = torch.Generator(device="cuda").manual_seed(14)
    for c in calls:
        rest = (c.seg, c.seeds, c.rate, True)
        out, lse = fa.fused_attention_cuda(c.q, c.k, c.v, *rest, True)
        ref, ref_lse = fa.fused_attention_plain(c.q, c.k, c.v, *rest, True)
        q32, k32, v32 = (x.float() for x in (c.q, c.k, c.v))
        t, t_lse = fa.fused_attention_plain(q32, k32, v32, *rest, True)
        g = torch.randn(c.q.shape, generator=g_gen, device="cuda",
                        dtype=torch.float32).to(c.q.dtype)
        bargs = (c.q, c.k, c.v, g, ref, ref_lse, *rest)
        got = fa.fused_attention_bwd_cuda(*bargs)
        want = fa.fused_attention_bwd_plain(*bargs)
        truth = fa.fused_attention_bwd_plain(q32, k32, v32, g.float(), t,
                                             t_lse, *rest)
        torch.cuda.synchronize()
        for a, b, x in zip((out, *got), (ref, *want), (t, *truth)):
            ratio = max(ratio, rel(a, x) / max(rel(b, x), 1e-12))
            far = max(far, (rel(a, x), rel(b, x)))
        ok, _, _, r = _bwd_check(torch, got, want, "bf16")
        phase2_ok &= ok
        rels.append(max(r))
        pad = c.seg == 0
        fwd_errs.append((out.float() - ref.float()).abs().max().item())
        lse_errs.append((lse - ref_lse).abs().max().item())
        bwd_errs.append(max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(got, want)))
        pad_ok &= bool(torch.isfinite(out.float()).all()
                       and torch.isfinite(lse).all()
                       and all(bool((x[pad] == 0).all()) for x in got))
    c = calls[-1]
    B, L = c.q.shape[:2]
    say(f"{what} {B}x{L}: {int((c.seg == 0).sum())} pad positions, rate "
        f"{c.rate:g}; each of its {len(calls)} attention calls, kernel and "
        f"plain in bf16 against plain in f32: the kernel's relative L2 error "
        f"at most {ratio:.4f}x the plain version's over out, dq, dk, dv "
        f"(limit {TRUTH_RATIO:g}); lse {max(lse_errs):.3e} (tol "
        f"{LSE_ATOL:g}); kernel vs plain max_abs_err forward "
        f"{max(fwd_errs):.3e}, backward {max(bwd_errs):.3e}, relative L2 "
        f"{max(rels):.3e}, by layer {[float(f'{x:.2e}') for x in rels]} "
        f"(recorded: ATOL {'met' if max(fwd_errs) <= ATOL['bf16'] else 'exceeded'}"
        f", phase 2's limits {'met' if phase2_ok else 'exceeded'}; see "
        f"TRUTH_RATIO); the largest relative L2 error against f32 "
        f"{far[0]:.4e} for the kernel, {far[1]:.4e} for plain; outputs and "
        f"lse finite, pad positions with zero dq/dk/dv: {pad_ok}")
    if ratio > TRUTH_RATIO or max(lse_errs) > LSE_ATOL or not pad_ok:
        fail(f"a segmented attention kernel strays from the f32 function "
             f"further than plain on the {what}")
    return max(fwd_errs), max(bwd_errs)


def phase_packed_training(torch, nq, nq_train=None):
    """Phase 14a and b: the copied test_bert.cfg with ``--sequence_packing
    on --pack_splitting fill --ln_impl fused`` on phase 10's corpus through
    phase 4's sequence (counts zeroed just before and read just after),
    ``last.ch`` saved; then the 12 attention calls of its first packed
    micro-batch, each on its own q, k, v, segment ids and seeds, kernel
    against plain forward (out, lse) and backward (dq, dk, dv), and the
    segmented kernels timed at that micro-batch."""
    import gc

    import torch.nn.functional as F

    from ml_recipe_tpu_torch.data.packing import PackedDataLoader
    from ml_recipe_tpu_torch.losses import PackedWeightedLoss
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    cfg = _nq_cfg(nq)
    emitted = []
    metas = None if nq_train is None else nq_train.plan_metas
    with _log_lines("ml_recipe_tpu_torch.train.trainer",
                    "Packed epoch") as epochs, \
            _capture_attention(torch, 12) as calls, _plan_metas(metas):
        trainer, params, launched, wall = _run_training(
            torch, cfg, ["--seed", "0", "--experiment_name", "packed",
                         *PACK_FLAGS],
            setup=lambda t: emitted.extend([_record_packed_batches(t)]))
    emitted = emitted[0]
    model, loader = trainer.model, trainer.train_dataloader
    if not (isinstance(loader, PackedDataLoader)
            and isinstance(trainer.test_dataloader, PackedDataLoader)
            and isinstance(trainer.loss, PackedWeightedLoss)):
        fail("packed training did not build the packed loaders and loss")
    layers = model.cfg.num_layers
    micro = len(trainer.history) * params.batch_split
    evals = trainer.eval_batches
    want = dict.fromkeys(KERNELS, 0)
    want.update(fused_attention_fwd=layers * (micro + evals),
                fused_attention_bwd=layers * micro,
                layer_norm_fwd=LN_PER_FORWARD * (micro + evals),
                layer_norm_bwd=LN_PER_FORWARD * micro)
    stats = loader.epoch_stats
    steps = [next(e for e in emitted if e[0] == epoch)
             for epoch in sorted({e[0] for e in emitted})]
    waits = trainer.data_waits
    say(f"packed training: {len(trainer.history)} steps + {evals} eval "
        f"batches in {wall:.1f}s; step wall seconds "
        f"{[round(h['seconds'], 3) for h in trainer.history]}; data wait "
        f"seconds before each step {[round(w, 3) for w in waits]} (phase "
        f"10: walls {None if nq_train is None else [round(x, 3) for x in nq_train.step_walls]}, "
        f"waits {None if nq_train is None else [round(w, 3) for w in nq_train.data_waits]}; "
        f"tokenizer backend "
        f"{trainer.collate_fun.keywords['tokenizer'].backend}); loss "
        f"{[round(h['loss'], 4) for h in trainer.history]}; planned "
        f"{trainer.planned_steps_per_epoch} steps/epoch in "
        f"{trainer.plan_seconds:.1f}s ({len(metas or ())} item metas of "
        f"phase 10's plan replayed, {len(loader._len_cache) - len(metas or ())}"
        f" items read)")
    say(f"packed training: each step's (rows, segments, fragments, pad "
        f"tokens) {[e[1:] for e in steps]}; segments per step (meter "
        f"weights) {[h['rows'] for h in trainer.history]}; the last epoch's "
        f"packing efficiency {stats['packing_efficiency']:.4f} (supervised "
        f"tokens / rows x 512), padding {stats['padding_waste_pct']}% against "
        f"phase 10's bucketed {None if nq_train is None else nq_train.pad_share}%"
        f" and {stats['padmax_waste_pct']}% padded to 512; {stats['split_count']}"
        f" splits in {stats['fragment_rows']} fragment rows over "
        f"{stats['batches']} batches read; {epochs}")
    say(f"packed training: launch counts {launched}, expected {want} "
        f"({layers} segmented attention launches forward and backward per "
        f"micro-batch, {LN_PER_FORWARD} LayerNorm)")
    if len(trainer.history) != 2 or micro != 16 or len(epochs) != 2:
        fail("the packed debug run did not take 2 steps of 8 micro-batches")
    if launched != want:
        fail("packed training launch counts do not match the path")
    if not all(np.isfinite(v) for h in trainer.history for k, v in h.items()
               if k not in ("step", "rows", "seconds")):
        fail("a packed training loss is not finite")
    if not (stats["items"] > stats["rows"] and stats["split_count"] > 0):
        fail("the packed loader did not pack several chunks a row and split")

    # b: the first micro-batch's 12 attention calls, kernel vs plain
    if len(calls) != layers or any(c.seg is None or c.rate <= 0
                                   for c in calls):
        fail("the packed micro-batch's attention calls were not segmented "
             "with dropout")
    fwd_err, bwd_err = _hold_segmented_calls(torch, calls,
                                             "packed micro-batch")

    # the segmented kernels timed at that micro-batch, beside sdpa with the
    # block-diagonal boolean mask
    c = calls[0]
    B, L, Hc, Dc = c.q.shape
    g_gen = torch.Generator(device="cuda").manual_seed(15)
    args = (c.q, c.k, c.v, c.seg, c.seeds, c.rate, True, True)
    out, lse = fa.fused_attention_cuda(*args)
    g = torch.randn(c.q.shape, generator=g_gen, device="cuda",
                    dtype=torch.float32).to(c.q.dtype)
    bargs = (c.q, c.k, c.v, g, out, lse, c.seg, c.seeds, c.rate, True)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (c.q, c.k, c.v))
    allowed = fa._allowed(c.seg, True)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                              dropout_p=c.rate)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), g.transpose(1, 2))

    peaks = card_peaks(torch.cuda.get_device_name(0))
    bw, flops, elt = peaks["bw"], peaks["bf16"], c.q.element_size()
    # the operations the function needs: only the pairs within a segment
    # (the kernel's tiles cover all B*L*L pairs, printed beside it)
    pairs, tiles = _segment_pairs(c.seg), B * L * L
    fwd_t = dict(ms=time_ms(torch, lambda: fa.fused_attention_cuda(*args)),
                 plain_ms=time_ms(torch,
                                  lambda: fa.fused_attention_plain(*args),
                                  reps=5),
                 library_ms=time_ms(torch, sdpa_fwd))
    fwd_t["bound_ms"], fwd_t["bound_by"] = _bound(
        4 * B * L * Hc * Dc * elt + B * L * 4 + B * 4 + B * Hc * L * 4,
        4 * Hc * Dc * pairs, bw, flops)
    bwd_t = dict(ms=time_ms(torch, lambda: fa.fused_attention_bwd_cuda(*bargs)),
                 plain_ms=time_ms(torch,
                                  lambda: fa.fused_attention_bwd_plain(*bargs),
                                  reps=5),
                 library_ms=time_ms(torch, sdpa_fwd_bwd) - time_ms(torch,
                                                                   sdpa_fwd))
    bwd_t["bound_ms"], bwd_t["bound_by"] = _bound(
        8 * B * L * Hc * Dc * elt + B * Hc * L * 4 + B * L * 4 + B * 4,
        10 * Hc * Dc * pairs, bw, flops)
    say(f"packed micro-batch {B}x{L}: {pairs} query-key pairs within its "
        f"segments ({pairs / tiles:.4f} of the {tiles} the kernels' tiles "
        f"cover): bounds from the pairs, forward 4*H*D*pairs = "
        f"{4 * Hc * Dc * pairs} and backward 10*H*D*pairs = "
        f"{10 * Hc * Dc * pairs} operations (every tile: "
        f"{4 * Hc * Dc * tiles} and {10 * Hc * Dc * tiles}, "
        f"{4 * Hc * Dc * tiles / flops * 1e3:.4f} and "
        f"{10 * Hc * Dc * tiles / flops * 1e3:.4f} ms at the bf16 peak)")
    for name, t in (("fused_attention_fwd", fwd_t),
                    ("fused_attention_bwd", bwd_t)):
        say(f"timing {name} {B}x{L}x{Hc}x{Dc} bf16 segmented (rate "
            f"{c.rate:g}{', lse' if name.endswith('fwd') else ''}; the packed "
            f"micro-batch's own ids): kernel_ms={t['ms']:.4f} plain_ms="
            f"{t['plain_ms']:.4f} library_ms(sdpa, block-diagonal boolean "
            f"mask)={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']})")
    del calls, out, lse, g, qt, kt, vt, allowed

    trainer.debug = False
    ckpt = params.dump_dir / params.experiment_name / "last.ch"
    trainer.save_state_dict(ckpt)
    say(f"packed training: {ckpt.name} saved ({ckpt.stat().st_size} bytes)")
    out = SimpleNamespace(launched=launched, ckpt=ckpt, fwd=fwd_t, bwd=bwd_t,
                          fwd_err=fwd_err, bwd_err=bwd_err)
    del trainer, model, loader
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _val_subset(nq) -> Path:
    """A processed directory holding PACK_VAL_DOCS of phase 10's test
    documents (in split order, each of at most PACK_VAL_WORDS words),
    linked to phase 10's files, as its whole test split."""
    import pickle
    import shutil

    dst = nq.dir / "val_subset"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir()
    with open(nq.proc / "split.info", "rb") as fh:
        train_idx, train_lab, test_idx, test_lab = pickle.load(fh)
    keep = []
    for i, idx in enumerate(test_idx):
        with open(nq.proc / f"{idx}.json") as fh:
            if len(json.load(fh)["document_text"].split()) <= PACK_VAL_WORDS:
                keep.append(i)
        if len(keep) == PACK_VAL_DOCS:
            break
    for i in keep:
        (dst / f"{test_idx[i]}.json").symlink_to(nq.proc / f"{test_idx[i]}.json")
    (dst / "label.info").symlink_to(nq.proc / "label.info")
    with open(dst / "split.info", "wb") as fh:
        pickle.dump((train_idx, train_lab, test_idx[keep], test_lab[keep]), fh)
    return dst


def phase_packed_validate(torch, nq, ckpt):
    """Phase 14c: ``cli.validate`` with config/validate.cfg on the packed
    run's ``last.ch`` over PACK_VAL_DOCS test documents, with
    ``--sequence_packing on --pack_splitting fill`` and without (counts
    zeroed just before each and read just after: 12 attention launches per
    batch). Both must score the same chunks, and every packed score must
    be finite; the largest per-chunk score gap is printed."""
    import gc

    from ml_recipe_tpu_torch.cli import validate
    from ml_recipe_tpu_torch.ops import flash_attention as fa

    subset = _val_subset(nq)
    runs = {}
    for label, extra in (("packed", ["--sequence_packing", "on",
                                     "--pack_splitting", "fill"]),
                         ("unpacked", [])):
        params, model_params = validate.parse(
            ["-c", str(REPO / "config" / "validate.cfg"), "--checkpoint",
             str(ckpt), "--vocab_file", nq.vocab, "--lowercase",
             "--data_path", str(nq.corpus), "--processed_data_path",
             str(subset), "--limit", "100000", *extra])
        with _capture_attention(torch, 12, last=True) as calls:
            zero_counts()           # the main path starts here
            t0 = time.perf_counter()
            predictor = validate.main(params, model_params, save_dump=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()     # the main path ends here
        stats = predictor.stats
        want = dict.fromkeys(KERNELS, 0)
        want["fused_attention_fwd"] = 12 * stats["batches"]
        scores = {(item.item_id, item.chunk_start): float(sc)
                  for d in predictor.dump
                  for sc, item in zip(d[0], d[-1])}
        say(f"validate {label}: {stats['documents']} documents, "
            f"{stats['chunks']} chunks ({stats.get('segments', 0)} segments, "
            f"{predictor.pack_split_count} split) in {stats['batches']} "
            f"batches of {params.batch_size}x{params.max_seq_len}, "
            f"{stats['candidates']} candidates; "
            f"{stats['chunks'] / stats['seconds']:.1f} chunks/s "
            f"({stats['seconds']:.2f}s, the call {wall:.1f}s); launch counts "
            f"{launched}, expected {want}")
        if launched != want:
            fail(f"validate {label} launch counts do not match the path")
        err = (0.0, 0.0)
        if label == "packed":
            # the last packed batch: the packer's flushed rows, pad tails;
            # as validate ran it (rate 0), then with training's dropout so
            # that dropout meets pad tails on real packed rows
            err = _hold_segmented_calls(torch, list(calls),
                                        "last packed validate batch")
            B, _, Hc, _ = calls[0].q.shape
            dropped = [SimpleNamespace(
                **{**vars(c), "rate": TRAIN_RATE,
                   "seeds": fa.row_seeds(14 + i, B, Hc, "cuda")})
                for i, c in enumerate(calls)]
            err = tuple(map(max, err, _hold_against_f32(
                torch, dropped, "last packed validate batch with dropout "
                                "(seeds 14..25)")))
            del dropped
        runs[label] = SimpleNamespace(launched=launched, scores=scores,
                                      stats=stats, errs=err)
        del calls
        del predictor
        gc.collect()
        torch.cuda.empty_cache()
    packed, plain = runs["packed"], runs["unpacked"]
    gap = max(abs(packed.scores[k] - v) for k, v in plain.scores.items()
              if k in packed.scores) if plain.scores else math.inf
    say(f"validate: packed against unpacked on the same {len(plain.scores)} "
        f"chunks: largest per-chunk |score| difference {gap:.4f} (recorded, "
        f"not a gate: random weights, and a split chunk's fragments attend "
        f"only within themselves)")
    if not (packed.stats["chunks"] == plain.stats["chunks"] > 0
            and set(packed.scores) == set(plain.scores)):
        fail("packed and unpacked validate did not score the same chunks")
    if not all(np.isfinite(v) for v in packed.scores.values()):
        fail("a packed validate score is not finite")
    return runs


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


def device_trace(torch, run, warmup: bool = False):
    """``(name, start, end)`` of every device event in a torch.profiler
    trace of ``run()``. A trace that holds no device events at all is taken
    again (such traces have come back from the card, several in a row),
    up to TRACE_TRIES times; after that the breakdown is not measured and
    None comes back. Only breakdowns come from these traces: every time
    that a gate or the kernels line needs is taken with CUDA events. With
    ``warmup`` the profiler's schedule runs ``run()`` once in a warm-up
    step, whose events it drops, before the recorded one: a first traced
    CUDA-graph replay has come back short of kernel events (a third of one
    replay's, in three traces in a row)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kw = ({"schedule": schedule(wait=0, warmup=1, active=1, repeat=1)}
          if warmup else {})
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA], **kw) as prof:
            for _ in range(2 if warmup else 1):
                run()
                torch.cuda.synchronize()
                if warmup:
                    prof.step()
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


def profile_forward(torch, forward, label: str, reps: int = 5):
    """Device time of ``forward`` by kernel family, and the device's idle
    share over ``reps`` back-to-back calls, from a ``torch.profiler`` trace;
    returns the idle share. Informative only: a trace without device events
    (:func:`device_trace`) prints 'not measured' and returns None."""
    def calls():
        with torch.inference_mode():
            for _ in range(reps):
                forward()

    spans = device_trace(torch, calls)
    if spans is None:
        say(f"{label}: profile of the 32x384 forward: not measured (the "
            f"trace holds no device events)")
        return None
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
    return 1 - busy / window


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

    def capture(tensors, max_norm, **kw):
        if "grads" not in store:
            store["grads"] = torch.cat(
                [g.detach().float().reshape(-1) for g in tensors]).cpu()
        return clip(tensors, max_norm, **kw)

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
    probe_step, probe = Trainer._probe_step, dict.fromkeys(KERNELS, 0)

    def counted_probe(self, *args, **kw):
        before = counts()
        try:
            return probe_step(self, *args, **kw)
        finally:
            for k, n in counts().items():
                probe[k] += n - before[k]

    Trainer._probe_step = counted_probe
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
    launched = _without_probes(trainer, launched, probe)
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
    each must give back its input bit for bit. Then the ZeRO-1 bucketed
    exchange (``--zero1_overlap bucketed``) over the same parameters in
    their 4 MB plan: a backward that adds zeros fires its hooks, each
    bucket goes out as NCCL's ``reduce_scatter_tensor`` (the branch two
    gloo ranks on one card never take), and every reduced gradient must
    equal its input. It joins and builds at once and times when the rest
    of the phase is done, alone on the card."""
    import torch

    from ml_recipe_tpu_torch.models import EncoderConfig, QAModel
    from ml_recipe_tpu_torch.parallel import collectives
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.parallel.sharding import (
        tree_order, zero1_bucket_plan, zero1_param_plan)

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
        by_name = dict(named)
        names = tree_order(by_name)
        shapes = [(n, by_name[n].shape) for n in names]
        plan = zero1_param_plan(shapes, data_size=1)
        buckets = zero1_bucket_plan(shapes, bucket_mb=4.0)
        exchange = collectives.BucketedExchange(
            [(n, by_name[n], plan[n]) for n in names], buckets, index=0,
            size=1)
        bucketed = {"buckets": len(buckets), "ms": [], "equal": True}
        for _ in range(4):
            zero = sum((p * 0).sum() for _, p in named)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exchange.arm()
            zero.backward()
            reduced = exchange.finish()
            torch.cuda.synchronize()
            bucketed["ms"].append((time.perf_counter() - t0) * 1e3)
            bucketed["equal"] &= all(
                torch.equal(reduced[n], g.float())
                for (n, _), g in zip(named, want))
            bucketed["stats"] = dict(exchange.stats)
        result["bucketed"] = bucketed
    finally:
        pdist.shutdown()
    (DP_DIR / "nccl.json").write_text(json.dumps(result))
    return 0


def _spawn(args, log: Path):
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), *map(str, args)],
            cwd=str(REPO), stdout=fh, stderr=subprocess.STDOUT)


def _join(procs, deadline: float, what: str = "data parallel") -> None:
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail(f"{what}: {name} outlived its deadline; its log ends "
                 f"{log.read_text()[-3000:]}")
        if rc != 0:
            fail(f"{what}: {name} exited {rc}; its log ends "
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
    bucketed = nccl["bucketed"]
    say(f"data parallel (b): the ZeRO-1 bucketed exchange over the same "
        f"one-rank NCCL group (reduce_scatter_tensor): {bucketed['buckets']} "
        f"buckets, backward + exchange ms "
        f"{[round(x, 2) for x in bucketed['ms']]}, issued "
        f"{bucketed['stats']}; equal to its input: {bucketed['equal']}")
    if not bucketed["equal"] or bucketed["buckets"] < 2:
        fail("the one-rank NCCL bucketed exchange is not exact")

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


# -- phase 12: the fine-tune's training options ------------------------------------

OPT_DIR = OUT_DIR / "options"
HF_SEED = 12
# the tentpole command's flags (the HF directory comes with them)
OPT_FLAGS = ["--ln_impl", "fused", "--optimizer", "adamod",
             "--apex_loss_scale", "dynamic", "--async_checkpoint"]
# the fine-tune step: without warmup, so that its one step has lr > 0
FINETUNE_FLAGS = ["--finetune", "--finetune_position", "--finetune_class",
                  "--warmup_coef", "0"]
# a micro-batch's unscaled gradient at scale 2^15 against the same
# micro-batch at scale 1, same generator: a power of two scales every bf16
# and f32 value exactly, so only reductions whose order follows the
# scheduling of atomics may differ: the order of phase 6's remat gate; a
# scale applied twice, or never undone, misses by 2^15
LS_GRAD_REL_TOL = REMAT_GRAD_REL_TOL
PLANTED_SCALE = 2.0 ** 127


def phase_train_options(torch):
    """Phase 12: ``config/test_bert.cfg`` with this slice's options at
    full width: an HF warm start from both file formats, the training run
    with AdaMod and dynamic loss scaling, the scale's exactness, a planted
    overflow, a fine-tune step with the encoder frozen and an async
    checkpoint against a sync one. Returns the launch counts of the
    training run and of the fine-tune step."""
    import filecmp
    import shutil

    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.models.config import MODEL_PRESETS
    from ml_recipe_tpu_torch.models.hf_convert import (
        hf_to_encoder_params, synthetic_hf_state_dict, write_safetensors)
    from ml_recipe_tpu_torch.train import loss_scale as ls_lib
    from ml_recipe_tpu_torch.train.optim import AdaMod, AdamW

    shutil.rmtree(OPT_DIR, ignore_errors=True)
    OPT_DIR.mkdir(parents=True)
    t_phase = time.perf_counter()

    # 1. the warm start: a seeded random bert-base HF checkpoint in both
    # formats, each loaded through compose.init_model
    cfg = MODEL_PRESETS["bert-base-uncased"]
    sd = synthetic_hf_state_dict(cfg, seed=HF_SEED)
    dirs = {"pytorch_model.bin": OPT_DIR / "hf_bin",
            "model.safetensors": OPT_DIR / "hf_safetensors"}
    write_s = {}
    for name, d in dirs.items():
        d.mkdir()
        t0 = time.perf_counter()
        if name.endswith(".bin"):
            torch.save(sd, d / name)
        else:
            write_safetensors(d / name, sd)
        write_s[name] = time.perf_counter() - t0
    expect = hf_to_encoder_params(sd, cfg.num_layers)
    mb = sum(t.numel() * t.element_size() for t in sd.values()) / 1e6
    test_bert = REPO / "config" / "test_bert.cfg"
    params, model_params = _train_flags(test_bert)
    random, _ = init_model(model_params, rng_seed=0, device="cuda", train=True)
    heads = {n: p.detach().clone() for n, p in random.named_parameters()
             if not n.startswith("transformer.")}
    del random
    for name, d in dirs.items():
        model_params.hf_checkpoint = str(d)
        t0 = time.perf_counter()
        model, _ = init_model(model_params, rng_seed=0, device="cuda",
                              train=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        enc = model.transformer.state_dict()
        same = sum(torch.equal(enc[n].cpu(), t) for n, t in expect.items())
        head_same = all(torch.equal(p.detach(), heads[n])
                        for n, p in model.named_parameters()
                        if not n.startswith("transformer."))
        say(f"training options: warm start from {name} ({mb:.0f} MB f32, "
            f"written in {write_s[name]:.1f}s): built in {load_s:.1f}s; "
            f"{same} of {len(expect)} encoder leaves equal their source "
            f"({len(enc)} in the encoder); heads equal to the seeded init: "
            f"{head_same}")
        if same != len(expect) or len(enc) != len(expect) or not head_same:
            fail(f"the warm start from {name} is not the checkpoint's encoder "
                 f"under the seeded heads")
        del model, enc
    del sd
    torch.cuda.empty_cache()

    # 2. the training run: test_bert.cfg's 2 debug steps of 8 x 32x512
    hf = str(dirs["model.safetensors"])
    trainer, params, launched, wall = _run_training(
        torch, "test_bert.cfg", [*OPT_FLAGS, "--hf_checkpoint", hf])
    model = trainer.model
    layers = model.cfg.num_layers
    micro = len(trainer.history) * params.batch_split
    evals = trainer.eval_batches
    want = {"fused_attention_fwd": layers * (micro + evals),
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": LN_PER_FORWARD * (micro + evals),
            "layer_norm_bwd": LN_PER_FORWARD * micro, "q8_matmul": 0,
            "q8_quantize": 0}
    hist = trainer.history
    say(f"training options ({' '.join(OPT_FLAGS)} --hf_checkpoint): "
        f"{len(hist)} steps + {evals} eval batches in {wall:.1f}s; step wall "
        f"seconds {[round(h['seconds'], 3) for h in hist]}; loss "
        f"{[round(h['loss'], 4) for h in hist]}; lr {[h['lr'] for h in hist]};"
        f" loss_scale {[h['loss_scale'] for h in hist]}; grads_finite "
        f"{[h['grads_finite'] for h in hist]}; launch counts {launched}, "
        f"expected {want}")
    if not isinstance(trainer.optimizer, AdaMod) or micro != 16 or evals != 22:
        fail("the options run is not test_bert.cfg's 2 debug steps with AdaMod")
    if launched != want:
        fail("launch counts do not match the options training path")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail("a training loss under loss scaling is not finite")
    if trainer.loss_scale.scale != 2.0 ** 15 or any(
            h["grads_finite"] != 1.0 or h["loss_scale"] != 2.0 ** 15
            for h in hist):
        fail("the dynamic scale did not stay at 2^15 over two finite steps")

    # the optimizer step alone, AdaMod against the adam chain, on copies of
    # bert-base's parameters and one gradient
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = {n: torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for n, p in trainer.optimizer.params.items()}
    opt_ms = {}
    for cls in (AdamW, AdaMod):
        copies = {n: torch.nn.Parameter(p.detach().clone())
                  for n, p in trainer.optimizer.params.items()}
        opt = cls(copies, schedule=lambda step: 1e-5, weight_decay=1e-4)
        opt_ms[cls.__name__] = time_ms(torch, lambda: opt.step(grads), reps=5,
                                       warm=2)
        del opt, copies
    say(f"training options: one optimizer step over bert-base's "
        f"{len(grads)} f32 tensors, device ms (CUDA events): adam "
        f"{opt_ms['AdamW']:.3f}, adamod {opt_ms['AdaMod']:.3f}")
    del grads
    torch.cuda.empty_cache()

    # 3. the scale's exactness on one 32x512 micro-batch
    inputs, labels = _batch(torch, trainer, TRAIN_SHAPE[0])
    params_t = list(model.parameters())
    model.train()

    def unscaled_grads(state):
        for p in params_t:
            p.grad = None
        gen = torch.Generator(device="cuda").manual_seed(7)
        preds = model(**trainer._model_inputs(inputs), generator=gen)
        total, _ = trainer.loss(preds, labels)
        ls_lib.scale_loss(total, state).backward()
        g = [p.grad for p in params_t]
        ls_lib.unscale_(g, state)
        return torch.cat([x.float().reshape(-1) for x in g])

    scaled = unscaled_grads(ls_lib.init_state("dynamic"))
    plain = unscaled_grads(ls_lib.init_state(1.0))
    rel = ((scaled - plain).norm() / plain.norm()).item()
    top = plain.abs().max().item()
    say(f"training options: 32x512 micro-batch gradient at scale 2^15, "
        f"unscaled, against scale 1: relative L2 {rel:.3e} (tol "
        f"{LS_GRAD_REL_TOL:g}); equal elements "
        f"{(scaled == plain).float().mean().item():.6f}; largest |gradient| "
        f"{top:.4g}, so x 2^127 = {top * PLANTED_SCALE:.4g} "
        f"({'overflows' if top * PLANTED_SCALE >= 2.0 ** 128 else 'stays finite in'} f32)")
    if not (np.isfinite(rel) and rel <= LS_GRAD_REL_TOL):
        fail("the unscaled gradient at 2^15 is not the gradient at scale 1")
    del scaled, plain
    for p in params_t:
        p.grad = None

    # 4. a planted overflow: the dynamic state at 2^127 and, so that the
    # step overflows whatever its gradients' size, an infinite gradient
    # planted in the classifier bias's backward
    opt = trainer.optimizer
    inputs, labels = _batch(torch, trainer, params.train_batch_size)

    def state_of():
        return ({n: p.detach().clone() for n, p in opt.params.items()},
                {k: {n: t.clone() for n, t in getattr(opt, k).items()}
                 for k in ("exp_avg", "exp_avg_sq", "exp_avg_lr")},
                opt.count, trainer.global_step)

    before = state_of()
    trainer.loss_scale = ls_lib.LossScaleState(PLANTED_SCALE, 0, True)
    hook = model.classifier.bias.register_hook(
        lambda g: torch.full_like(g, float("inf")))
    try:
        values = trainer.train_step(inputs, labels)
    finally:
        hook.remove()
    after = state_of()
    unchanged = (all(torch.equal(a, before[0][n]) for n, a in after[0].items())
                 and all(torch.equal(t, before[1][k][n])
                         for k, ts in after[1].items() for n, t in ts.items())
                 and after[2:] == before[2:])
    say(f"training options: planted overflow at scale 2^127: grads_finite "
        f"{values['grads_finite']}, scale after {trainer.loss_scale.scale!r} "
        f"(2^{math.log2(trainer.loss_scale.scale):g}); parameters, the three "
        f"AdaMod moments and the counts torch.equal to before: {unchanged}; "
        f"lr logged {values['lr']!r}, loss {values['loss']:.4f}")
    if values["grads_finite"] != 0.0 or not unchanged or \
            trainer.loss_scale.scale != PLANTED_SCALE / 2:
        fail("the overflow step changed the state or did not back off")
    del before, after

    # the micro-batch's device time with the encoder trained, then frozen
    fwd_bwd = _micro_batch(torch, trainer, TRAIN_SHAPE[0])
    train_ms = time_ms(torch, fwd_bwd, reps=5, warm=2)

    # 6. the async checkpoint against a sync one of the same state
    trainer.debug = False
    paths = {"async": OPT_DIR / "async.ch", "sync": OPT_DIR / "sync.ch"}
    trainer.save_state_dict(paths["async"])
    snapshot_s = trainer.checkpoint_seconds["snapshot"]
    t0 = time.perf_counter()
    trainer.finish_pending_checkpoint()
    barrier_s = time.perf_counter() - t0
    persist_s = trainer.checkpoint_seconds["persist"]
    saver, trainer._async_ckpt = trainer._async_ckpt, None
    try:
        trainer.save_state_dict(paths["sync"])
    finally:
        trainer._async_ckpt = saver
    sync_s = trainer.checkpoint_seconds["save"]
    size = paths["sync"].stat().st_size
    same = filecmp.cmp(paths["async"], paths["sync"], shallow=False)
    say(f"training options: async checkpoint of {size / 1e9:.3f} GB "
        f"(parameters and three AdaMod moments, f32): the step blocked "
        f"{snapshot_s:.3f}s for the snapshot, the persist took {persist_s:.3f}s "
        f"on its thread (the barrier waited {barrier_s:.3f}s more); a sync "
        f"save {sync_s:.3f}s; byte-equal to the sync save: {same}")
    if not same:
        fail("the async checkpoint differs from a sync save of the state")
    for path in paths.values():
        path.unlink()
    del trainer, model, params_t, fwd_bwd, saver, opt
    torch.cuda.empty_cache()

    # 5. one fine-tune step, the encoder frozen
    params, model_params = _train_flags(
        test_bert, [*OPT_FLAGS, "--hf_checkpoint", hf, *FINETUNE_FLAGS])
    trainer = train_cli.build_trainer(params, model_params)
    model = trainer.model
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    inputs, labels = _batch(torch, trainer, params.train_batch_size)
    zero_counts()                   # the fine-tune step starts here
    values = trainer.train_step(inputs, labels)
    torch.cuda.synchronize()
    tuned = counts()                # and ends here
    steps = params.batch_split
    want_ft = {"fused_attention_fwd": layers * steps,
               "fused_attention_bwd": 0,
               "layer_norm_fwd": LN_PER_FORWARD * steps, "layer_norm_bwd": 0,
               "q8_matmul": 0, "q8_quantize": 0}
    enc = model.transformer.state_dict()
    frozen = all(torch.equal(enc[n].cpu(), t) for n, t in expect.items())
    moved = sorted({n.split(".")[0] for n, p in model.named_parameters()
                    if not torch.equal(p.detach(), start[n])})
    fwd_bwd = _micro_batch(torch, trainer, TRAIN_SHAPE[0])
    frozen_ms = time_ms(torch, fwd_bwd, reps=5, warm=2)
    say(f"training options: one fine-tune step ({' '.join(FINETUNE_FLAGS)}): "
        f"loss {values['loss']:.4f}; launch counts {tuned}, expected "
        f"{want_ft}; the encoder equal to the warm start: {frozen}; modules "
        f"moved {moved}; one 32x512 micro-batch forward+backward device ms "
        f"{frozen_ms:.3f} with the encoder frozen, {train_ms:.3f} trained "
        f"(CUDA events)")
    if tuned != want_ft:
        fail("launch counts do not match the fine-tune step")
    if not frozen or moved != ["classifier", "position_outputs"]:
        fail("the fine-tune step moved a frozen module or left a head")
    del trainer, model, start, fwd_bwd, enc, expect
    shutil.rmtree(OPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    say(f"training options: phase wall {time.perf_counter() - t_phase:.1f}s")
    return launched, tuned


FLEET_DIR = OUT_DIR / "fleet"
# the shared library store config/fleet.cfg names (relative to the
# fleet's working directory, the repository root)
FLEET_AOT = REPO / "artifacts" / "aot"
FLEET_DOCS = 16                     # documents, each asked 2 questions
FLEET_WINDOWS = (2, 6)              # windows at 384 per document
FLEET_Q_WORDS = 8                   # both questions of a document: 8 words
FLEET_SEED = 13                     # the random bert-base checkpoint
FLEET_DEADLINE_S = 300
SIX_SPANS = {"admission", "queue", "flush", "device", "span_reduce",
             "respond"}
HOT_SPANS = {"admission", "span_reduce", "respond"}
RESULT_FIELDS = ("answer", "label", "start", "end", "score", "n_chunks")


def _fleet_requests(params):
    """FLEET_DOCS documents of FLEET_WINDOWS windows at 384 (whole words of
    the synthetic vocab, one token each: ``window_chunks`` starts a window
    every ``doc_stride`` tokens), each asked two questions of FLEET_Q_WORDS
    words: the first questions of every document, then the second ones.
    Returns ``[(question, document, doc_index, windows)]``."""
    rng = np.random.default_rng(FLEET_SEED)

    def words(n):
        return " ".join(f"tok{4 * int(i) + 1}"
                        for i in rng.integers(1, 7000, n))

    lo, hi = FLEET_WINDOWS
    docs = []
    for d in range(FLEET_DOCS):
        windows = lo + d % (hi - lo + 1)
        docs.append((words(windows * params.doc_stride - 40), windows))
    questions = [[words(FLEET_Q_WORDS) for _ in range(2)] for _ in docs]
    return [(questions[d][k], docs[d][0], d, docs[d][1])
            for k in range(2) for d in range(len(docs))]


def _fleet_post(url: str, payload: dict):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return (resp.status, json.loads(resp.read()), dict(resp.headers),
                    (time.perf_counter() - t0) * 1e3)
    except urllib.error.HTTPError as e:
        return e.code, {"error": e.read().decode()}, dict(e.headers), 0.0
    except OSError as e:
        return 0, {"error": repr(e)}, {}, 0.0


def _scrape(port: int) -> dict:
    """One engine's /metrics as {sample name with labels: value}."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        page = resp.read().decode("utf-8")
    out = {}
    for line in page.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def _engine_numbers(port: int) -> dict:
    m = _scrape(port)
    keys = {"batches": "qa_batches_total",
            "doc_hits": "qa_doc_cache_hits_total",
            "doc_misses": "qa_doc_cache_misses_total",
            "chunk_hits": "qa_chunk_cache_hits_total",
            "chunk_misses": "qa_chunk_cache_misses_total",
            "build_hits": "qa_kernel_build_hits_total",
            "build_misses": "qa_kernel_build_misses_total",
            "aot_hits": "qa_aot_cache_hits_total",
            "aot_misses": "qa_aot_cache_misses_total",
            "attention": 'qa_kernel_launches_total{kernel="fused_attention_fwd"}'}
    missing = [v for v in keys.values() if v not in m]
    if missing:
        fail(f"engine on port {port} exports no {missing}")
    return {k: int(m[v]) for k, v in keys.items()}


def _span_names(trace_doc) -> dict:
    """Span names per request id (``request_id``, or a batch's
    ``request_ids``)."""
    out = {}
    for event in trace_doc["traceEvents"]:
        args = event.get("args", {})
        for rid in args.get("request_ids") or [args.get("request_id")]:
            if rid is not None:
                out.setdefault(str(rid), set()).add(event["name"])
    return out


def _pcts(ms) -> str:
    return (f"p50 {statistics.median(ms):.2f} ms, p95 "
            f"{np.percentile(ms, 95):.2f} ms")


def phase_fleet(torch):
    """Phase 13a: ``python -m ml_recipe_tpu_torch.cli.fleet -c
    config/fleet.cfg`` on the card: two cached bert-base engines behind the
    hash router, a cold and a hot pass, a SIGHUP rolling restart under
    load. The engines are child processes, so their kernel counts start at
    0 with each process; each logs its final device batches and launches
    when its drain ends, and those lines are summed over all four engine
    processes. Returns the fleet's attention launches."""
    import shutil
    import signal

    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.config.parser import (
        get_fleet_parser, get_model_parser, get_params, get_serve_parser)
    from ml_recipe_tpu_torch.train.checkpoint import save_state_dict

    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    vocab = OUT_DIR / "vocab.txt"
    ckpt = FLEET_DIR / "bert_base_seeded.ch"
    args = ["-c", str(REPO / "config" / "fleet.cfg"), "--vocab_file",
            str(vocab), "--checkpoint", str(ckpt), "--port", "0",
            "--fleet_run_dir", str(FLEET_DIR / "run"), "--ready_file",
            str(FLEET_DIR / "ready.json"), "--trace_spans",
            str(FLEET_DIR / "spans")]
    fleet_params, params, model_params = get_params(
        (get_fleet_parser, get_serve_parser, get_model_parser), args)[1]
    if (fleet_params.engines, params.buckets, model_params.model,
            params.aot_cache) != (2, "8x128,8x384,32x384",
                                  "bert-base-uncased", "artifacts/aot"):
        fail("config/fleet.cfg is not two bert-base engines on the serving "
             "grid sharing the store artifacts/aot")
    t0 = time.perf_counter()
    model, _ = init_model(model_params, rng_seed=FLEET_SEED, device="cuda",
                          train=True)
    save_state_dict(ckpt, model=model)
    del model
    torch.cuda.empty_cache()
    say(f"fleet: seeded bert-base checkpoint ({ckpt.stat().st_size:,} B) "
        f"written in {time.perf_counter() - t0:.1f}s")
    requests = _fleet_requests(params)

    log = open(FLEET_DIR / "fleet.log", "wb")
    t_start = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ml_recipe_tpu_torch.cli.fleet", *args],
        cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT,
        start_new_session=True)
    deadline = time.monotonic() + FLEET_DEADLINE_S

    def wait_for(path, what):
        while not path.exists():
            if proc.poll() is not None:
                fail(f"the fleet exited rc={proc.returncode} before {what}: "
                     f"{(FLEET_DIR / 'fleet.log').read_text()[-3000:]}")
            if time.monotonic() > deadline:
                fail(f"the fleet gave no {what} within {FLEET_DEADLINE_S}s")
            time.sleep(0.2)

    try:
        wait_for(FLEET_DIR / "ready.json", "ready file")
        ready_s = time.perf_counter() - t_start
        info = json.loads((FLEET_DIR / "ready.json").read_text())
        url = f"http://{info['host']}:{info['port']}/v1/qa"
        ports = {e["node"]: e["port"] for e in info["engines"]}
        say(f"fleet: router and {len(ports)} engines ready in {ready_s:.1f}s "
            f"({ports})")

        def run_pass(label):
            out = []
            for question, document, d, windows in requests:
                status, body, headers, ms = _fleet_post(
                    url, {"question": question, "document": document})
                if status != 200:
                    fail(f"fleet {label} request answered {status}: {body}")
                if body["n_chunks"] != windows:
                    fail(f"document {d} windows into {body['n_chunks']}, "
                         f"not {windows}")
                out.append(dict(fields={k: body[k] for k in RESULT_FIELDS},
                                engine=headers["X-Fleet-Engine"],
                                rid=headers["X-Request-Id"], doc=d, ms=ms))
            return out

        # the first engines warm the shared store (config/fleet.cfg's
        # aot_cache): each loads its library from it or builds it there
        n0 = {n: _engine_numbers(p) for n, p in ports.items()}
        if any(v["build_hits"] + v["build_misses"] < 1
               or v["aot_misses"] != v["build_misses"]
               or v["aot_hits"] != v["build_hits"] for v in n0.values()):
            fail(f"an engine loaded no library, or built one outside the "
                 f"shared store: {n0}")
        say(f"fleet: first engines' library store outcomes "
            f"{ {n: (v['aot_hits'], v['aot_misses']) for n, v in n0.items()} } "
            f"(hits, misses) in {FLEET_AOT}")
        cold = run_pass("cold")
        n1 = {n: _engine_numbers(p) for n, p in ports.items()}
        hot = run_pass("hot")
        n2 = {n: _engine_numbers(p) for n, p in ports.items()}

        for c, h in zip(cold, hot):
            if c["fields"] != h["fields"]:
                fail(f"a hot response differs from its cold one: {c} {h}")
        owners = {}
        for r in cold + hot:
            owners.setdefault(r["doc"], set()).add(r["engine"])
        if any(len(e) != 1 for e in owners.values()):
            fail(f"a document reached more than one engine: {owners}")
        windows = sum(r["fields"]["n_chunks"] for r in cold)

        def total(snap, key):
            return sum(v[key] for v in snap.values())

        if any(n2[n]["batches"] != n1[n]["batches"] for n in ports):
            fail(f"the hot pass launched device batches: {n1} -> {n2}")
        if total(n1, "doc_hits") - total(n0, "doc_hits") != FLEET_DOCS:
            fail(f"cold doc-cache hits are not {FLEET_DOCS}: {n0} -> {n1}")
        if total(n2, "doc_hits") - total(n1, "doc_hits") != len(requests) or \
                total(n2, "chunk_hits") - total(n1, "chunk_hits") != windows:
            fail(f"the hot pass was not all hits: {n1} -> {n2}")
        doc_rate = (total(n2, "doc_hits") / (total(n2, "doc_hits")
                                             + total(n2, "doc_misses")))
        chunk_rate = (total(n2, "chunk_hits") / (total(n2, "chunk_hits")
                                                 + total(n2, "chunk_misses")))
        per_engine = {n: sum(r["engine"] == n for r in cold + hot)
                      for n in ports}
        say(f"fleet: cold {_pcts([r['ms'] for r in cold])}; hot "
            f"{_pcts([r['ms'] for r in hot])} ({len(requests)} requests each, "
            f"{windows} windows of 384, sequential)")
        say(f"fleet: hit rates over both passes: doc cache {doc_rate:.4f}, "
            f"chunk cache {chunk_rate:.4f}; requests per engine {per_engine}; "
            f"device batches cold {total(n1, 'batches') - total(n0, 'batches')},"
            f" hot {total(n2, 'batches') - total(n1, 'batches')}")
        old_attention = total(n2, "attention")

        stop, results = threading.Event(), []

        def load():
            i = 0
            while not stop.is_set():
                question, document, _, _ = requests[i % len(requests)]
                status, body, _, _ = _fleet_post(
                    url, {"question": question, "document": document})
                results.append(status)
                i += 1

        loader = threading.Thread(target=load)
        loader.start()
        t_restart = time.perf_counter()
        try:
            os.kill(proc.pid, signal.SIGHUP)
            wait_for(FLEET_DIR / "run" / "rolling_restart.json",
                     "rolling restart report")
        finally:
            stop.set()
            loader.join(timeout=120)
        restart_s = time.perf_counter() - t_restart
        report = json.loads(
            (FLEET_DIR / "run" / "rolling_restart.json").read_text())
        failed = [s for s in results if s != 200]
        say(f"fleet: rolling restart in {restart_s:.1f}s under "
            f"{len(results)} requests ({len(failed)} failed): "
            f"{report['reports']}")
        if not results or failed:
            fail(f"the rolling restart failed requests: {failed[:10]}")
        for leg in report["reports"]:
            if leg["drain_exit"] != "clean" or leg["build_misses"] != 0 \
                    or leg["aot_misses"] != 0 or leg["aot_hits"] < 1:
                fail(f"a rolling restart leg was not clean and build-free: "
                     f"{leg}")
        new_ports = {leg["node"]: leg["new_port"] for leg in report["reports"]}
        after = run_pass("after the restart")
        for c, a in zip(cold, after):
            if c["fields"] != a["fields"]:
                fail(f"an answer changed across the restart: {c} {a}")
        n3 = {n: _engine_numbers(p) for n, p in new_ports.items()}
        if any(v["build_hits"] < 1 or v["build_misses"] or v["aot_misses"]
               or v["aot_hits"] < 1 for v in n3.values()):
            fail(f"a replacement engine built a kernel: {n3}")
        new_attention = total(n3, "attention")

        os.kill(proc.pid, signal.SIGTERM)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        if rc != 0:
            fail(f"the fleet exited rc={rc} on SIGTERM")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        log.close()

    logs = sorted((FLEET_DIR / "run").glob("engine*.log"))
    if len(logs) != 2:
        fail(f"expected 2 engine logs, found {len(logs)}")
    closes = []                     # (device batches, launches) per process
    for path in logs:
        text = path.read_text()
        routes = re.findall(r"attention route (\w+)", text)
        if routes != ["fused", "fused"]:
            fail(f"{path.name} logged attention routes {routes}, not the "
                 f"fused kernel at both starts")
        found = [(int(b), json.loads(k)) for b, k in re.findall(
            r"serving closed after (\d+) device batches \(\d+ warmup\); "
            r"kernel launches (\{.*\})", text)]
        if len(found) != 2:
            fail(f"{path.name} logged {len(found)} final kernel counts, not "
                 f"one for each of its two processes")
        for batches, launched in found:
            if launched["fused_attention_fwd"] != 12 * batches:
                fail(f"{path.name}: fused_attention_fwd launched "
                     f"{launched['fused_attention_fwd']}, not 12 x {batches} "
                     f"device batches")
        closes.extend(found)
    old_final = sum(closes[i][1]["fused_attention_fwd"] for i in (0, 2))
    new_final = sum(closes[i][1]["fused_attention_fwd"] for i in (1, 3))
    if old_final < old_attention or new_final < new_attention:
        fail(f"final attention launches {old_final} + {new_final} fall "
             f"below the scraped {old_attention} + {new_attention}")
    launches = old_final + new_final
    device_batches = sum(b for b, _ in closes)
    traces = sorted((FLEET_DIR / "spans").glob("serve_trace_*.json"))
    prefix = f"r{proc.pid}-"
    for path in traces:
        names = _span_names(json.loads(path.read_text()))
        forwarded = {r: n for r, n in names.items() if r.startswith(prefix)}
        if not any(n == SIX_SPANS for n in forwarded.values()):
            fail(f"{path.name} holds no router-forwarded request with the "
                 f"six spans")
    hot_ids = {r["rid"] for r in hot}
    hot_seen = {r: n for path in traces
                for r, n in _span_names(json.loads(path.read_text())).items()
                if r in hot_ids}
    if len(traces) != 4 or len(logs) != 2 or \
            any(n != HOT_SPANS for n in hot_seen.values()) or \
            len(hot_seen) != len(hot_ids):
        fail(f"expected 4 trace files and 2 engine logs, and hot requests "
             f"without queue or device spans: {len(traces)}, {len(logs)}")
    say(f"fleet: attention route fused in every engine start; {len(traces)} "
        f"trace files with the six spans; attention launches {launches} "
        f"over {device_batches} device batches in four engine processes "
        f"({old_final} in the two restarted ones, {old_attention} of them "
        f"before the restart); whole phase "
        f"{time.perf_counter() - t_start:.1f}s")
    return launches


def phase_fleet_int8(torch):
    """Phase 13b: one ``cli.serve`` engine (``build_engine``) with
    ``--quantize int8 --ln_impl fused`` and both caches on; the first
    question of every fleet document twice. Counts are set to 0 just
    before its warmup and read just after the second pass."""
    from ml_recipe_tpu_torch.cli.serve import build_engine
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_serve_parser)

    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(REPO / "config" / "serve.cfg"), "--vocab_file",
         str(OUT_DIR / "vocab.txt"), "--quantize", "int8", "--ln_impl",
         "fused", "--serve_cache_bytes", "64M", "--doc_cache_bytes", "64M"])
    engine = build_engine(params, model_params)
    requests = _fleet_requests(params)[:FLEET_DOCS]
    zero_counts()                   # the path starts here
    warm = engine.warmup(hbm_preflight=params.hbm_preflight)
    try:
        passes = []
        for _ in range(2):
            batches, out = engine.m_batches.value, []
            t0 = time.perf_counter()
            for question, document, _, _ in requests:
                r = engine.submit(question, document).result(timeout=120)
                out.append(r.to_json() | {"latency_ms": 0})
            passes.append((out, engine.m_batches.value - batches,
                           time.perf_counter() - t0))
        torch.cuda.synchronize()
        launched = counts()         # the path ends here
        stats = engine.cache_stats()
    finally:
        engine.close()
    (cold, cold_batches, cold_s), (hot, hot_batches, hot_s) = passes
    if cold != hot:
        fail("int8 cached engine: a hot response differs from its cold one")
    if hot_batches != 0 or stats["chunk"]["hits"] != sum(
            r["n_chunks"] for r in cold):
        fail(f"int8 cached engine: the hot pass reached the device "
             f"({hot_batches} batches, {stats})")
    device_batches = warm["device_batches"] + cold_batches
    want = {"fused_attention_fwd": 12, "q8_matmul": 77, "layer_norm_fwd": 25,
            "q8_quantize": 25}
    for kernel, per in want.items():
        if launched[kernel] != per * device_batches:
            fail(f"int8 cached engine: {kernel} launched {launched[kernel]}, "
                 f"not {per} x {device_batches} device batches")
    say(f"fleet int8 (--quantize int8 --ln_impl fused, both caches, "
        f"{warm['dispatch']} dispatch): {len(requests)} requests cold in "
        f"{cold_s:.2f}s ({int(cold_batches)} batches), hot in {hot_s:.3f}s "
        f"(0 batches); launches {launched}")
    return launched


# -- phase 15: sequence parallelism and ZeRO-1 -----------------------------------

SP_DIR = OUT_DIR / "sp"
SP_DEADLINE_S = 900
SP_WORLD = 2
LONGDOC = ["-c", str(REPO / "config" / "longdoc.cfg"), "--dummy_dataset",
           "--debug", "--seed", "7"]
ZERO1 = ["-c", str(REPO / "config" / "long_context.cfg"), "--dummy_dataset",
         "--debug", "--seed", "0"]
# the runs of phase 15's worker processes: longdoc.cfg as written (its
# mesh data:1,seq:2), and long_context.cfg at W = 2 with its zero1 and off.
# The seeds make the two ranks and the runs compared draw the same items
SP_RUNS = {"longdoc": LONGDOC, "zero1": ZERO1,
           "off": [*ZERO1, "--optimizer_sharding", "off"]}
# seq:2 against seq:1 (the same items, seeds and weights): the first step's
# loss and its gradient where it reaches the clip, relative. Both runs
# compute in bf16, and the ring rounds each hop's attention output and
# gradients to bf16 before it merges them in f32 where one call rounds
# once: attention outputs that differ by bf16 rounding at different
# points, which 12 post-LN layers carry into every gradient, as phase 4's
# kernel-vs-plain gradient (TRAIN_GRAD_REL_TOL). The port's bert-tiny run
# on the CPU in bf16 (2 layers, 2x256) read 4.7e-4 for the loss and
# 6.1e-3 for the gradient; a loss counted once per seq rank doubles the
# gradient (1.0), and a missed hop or another dropout mask moves both by
# O(1)
SP_LOSS_REL_TOL = 5e-3
SP_GRAD_REL_TOL = TRAIN_GRAD_REL_TOL
# encoder layers of phase 15's runs (the widths kept): a ring hop and a
# ZeRO-1 slice do not depend on the depth
SP_LAYERS = 4


def sp_worker(kind: str, rank: int, port: int) -> int:
    """One rank of phase 15's runs (``SP_RUNS[kind]``) through
    ``cli.train``'s parse, ``build_trainer`` and ``train``, on card 0 over
    gloo (NCCL refuses two ranks on one device), the launch counts and the
    ring's transport counters set to 0 just before ``train`` and read just
    after. ``longdoc`` also keeps the ring calls of the first micro-batch's
    forward at the first and the last layer, and rank 0's first gradient
    at the clip; ``zero1`` writes a sharded
    checkpoint after the run. The long_context runs compare bit for bit:
    they run with cuBLAS's deterministic workspace and
    ``use_deterministic_algorithms`` (warn only)."""
    if kind != "longdoc":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.ops import ring_attention as ra
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.parallel.sharding import opt_state_bytes_per_chip

    if kind != "longdoc":
        torch.use_deterministic_algorithms(True, warn_only=True)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _register_kernels()
    out = SP_DIR / kind
    out.mkdir(parents=True, exist_ok=True)
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=SP_WORLD,
        rank=rank, backend="gloo", device=torch.device("cuda", 0))
    first, captured = {}, []
    _capture_pre_clip_grads(torch, first)
    ring = ra.ring_attention
    calls, capture = [0], set()   # capture: the layers, once built

    def capturing(q, k, v, mask=None, **kw):
        got = ring(q, k, v, mask, **kw)
        if calls[0] in capture:
            captured.append(dict(
                layer=calls[0], q=q.detach().clone(), k=k.detach().clone(),
                v=v.detach().clone(), mask=mask.detach().clone(),
                seed=kw["seed"].detach().clone(), rate=kw["rate"],
                out=got.detach().clone()))
        calls[0] += 1
        return got

    ra.ring_attention = capturing
    try:
        _, (params, model_params) = get_params(
            (get_trainer_parser, get_model_parser),
            [*SP_RUNS[kind], "--vocab_file", str(OUT_DIR / "vocab.txt"),
             "--dump_dir", str(out / "results"), "--dist_world_size",
             str(SP_WORLD), "--local_rank", str(rank), "--dist_init_method",
             f"tcp://127.0.0.1:{port}"])
        params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2) // 4))
        with _shallow(SP_LAYERS):
            trainer = train_cli.build_trainer(params, model_params)
        capture.update((0, trainer.model.cfg.num_layers - 1))
        ring_stats = {}
        if trainer.mesh.ring is not None:
            trainer.mesh.ring.reset()
            ring_stats = trainer.mesh.ring.stats
        probe = _count_probes(trainer)
        zero_counts()               # the main path starts here
        t0 = time.perf_counter()
        train_cli.train(trainer, params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()         # the main path ends here
        launched = _without_probes(trainer, launched, probe)
        record = {
            "launched": launched, "wall": wall, "ring": ring_stats,
            "steps": [{k: h[k] for k in ("loss", "lr", "seconds", "rows")}
                      for h in trainer.history],
            "eval_batches": trainer.eval_batches,
            "preflight_probes": trainer.preflight_probes,
            "batch_split": trainer.batch_split,
            "layers": trainer.model.cfg.num_layers,
            "attention_impl": trainer.model.attention_impl,
            "mesh": trainer.plan.describe(),
            "opt_sharding": trainer.effective_opt_sharding,
            "opt_bytes": opt_state_bytes_per_chip(trainer.optimizer),
            "grad_norm": float(first["grads"].norm()),
            "micro_shape": [params.train_batch_size // trainer.plan.data_size
                            // trainer.batch_split,
                            params.max_seq_len // trainer.plan.seq_size],
        }
        if kind == "zero1":
            trainer.debug = False
            t0 = time.perf_counter()
            trainer.save_state_dict(out / "ckpt")
            record["save_seconds"] = time.perf_counter() - t0
        record["digest"] = _param_digest(trainer.model)
        if kind == "longdoc":
            torch.save(captured, out / f"capture{rank}.pt")
            if rank == 0:
                torch.save(first["grads"], out / "grads.pt")
        (out / f"rank{rank}.json").write_text(json.dumps(record))
    finally:
        ra.ring_attention = ring
        pdist.shutdown()
    return 0


def _sp_pair(kind: str) -> dict:
    port = _free_port()
    return {f"{kind} rank {r}": (
        _spawn(["--sp-worker", kind, r, port], SP_DIR / f"{kind}{r}.log"),
        SP_DIR / f"{kind}{r}.log") for r in range(SP_WORLD)}


@contextmanager
def _pre_clip_grads(torch, store: dict):
    """:func:`_capture_pre_clip_grads` in this process, undone on exit."""
    from ml_recipe_tpu_torch.train import trainer as trainer_module

    clip = trainer_module.clip_by_global_norm_
    _capture_pre_clip_grads(torch, store)
    try:
        yield store
    finally:
        trainer_module.clip_by_global_norm_ = clip


def _hold_ring_hops(torch, fa, bw, flops):
    """Phase 15b: every hop of the captured ring calls (both ranks, the
    first and the last layer), kernel and plain in bf16 against the plain version in f32
    (TRUTH_RATIO), forward (out, and the lse within LSE_ATOL) at its
    ``base`` and ``L_hash``, and backward on the merged output and lse
    with a seeded random cotangent; the hops merged as the ring merges
    them equal the output the ring returned in training bit for bit, and
    the merged output is held against one whole-sequence kernel call.
    Returns the largest errors and the hop's shape (its timing:
    :func:`_time_ring_hop`)."""
    from ml_recipe_tpu_torch.ops.ring_attention import (
        _merge_hop, _stream_row_seeds)

    caps = [torch.load(SP_DIR / "longdoc" / f"capture{r}.pt",
                       map_location="cuda") for r in range(SP_WORLD)]
    S = SP_WORLD

    def rel(a, t):
        return ((a.float() - t).norm() / t.norm()).item()

    ratio, lse_errs, fwd_errs, bwd_errs, merged_errs = 0.0, [], [], [], []
    exact, hops = True, 0
    g_gen = torch.Generator(device="cuda").manual_seed(15)
    for i in range(len(caps[0])):
        calls = [c[i] for c in caps]
        B, L_loc, Hh, _ = calls[0]["q"].shape
        L_hash, rate = S * L_loc, calls[0]["rate"]
        seeds = _stream_row_seeds(calls[0]["seed"], B=B, H=Hh,
                                  data_index=0).cuda()
        per_rank = []
        for r in range(S):
            q, q32 = calls[r]["q"], calls[r]["q"].float()
            # the ring's own accumulators: zeros and -1e30 before hop 0
            merged = {key: (torch.zeros(q.shape, dtype=torch.float32,
                                        device="cuda"),
                            torch.full((B, Hh, L_loc), fa.NEG_INF,
                                       device="cuda"))
                      for key in ("kernel", "truth")}
            hop_args = []
            for step in range(S):
                src = (r - step) % S
                k, v, m = (calls[src][n] for n in ("k", "v", "mask"))
                kw = dict(base=(r * L_loc, src * L_loc), L_hash=L_hash)
                m = m.to(torch.int32).contiguous()
                rest = (m, seeds, rate, False, True)
                out, lse = fa.fused_attention_cuda(q, k, v, *rest, **kw)
                ref, ref_lse = fa.fused_attention_plain(q, k, v, *rest, **kw)
                t, t_lse = fa.fused_attention_plain(q32, k.float(), v.float(),
                                                    *rest, **kw)
                ratio = max(ratio, rel(out, t) / max(rel(ref, t), 1e-12))
                lse_errs.append((lse - ref_lse).abs().max().item())
                fwd_errs.append((out.float() - ref.float()).abs().max().item())
                for key, o, l in (("kernel", out, lse), ("truth", t, t_lse)):
                    merged[key] = _merge_hop(*merged[key], o, l)
                hop_args.append((k, v, m, kw))
                hops += 1
            m_out = merged["kernel"][0].to(q.dtype)
            exact &= bool(torch.equal(m_out, calls[r]["out"]))
            t_out, t_lse = merged["truth"]
            g = torch.randn(q.shape, generator=g_gen, device="cuda",
                            dtype=torch.float32).to(q.dtype)
            for k, v, m, kw in hop_args:
                bargs = (g, m_out, merged["kernel"][1], m, seeds, rate, False)
                got = fa.fused_attention_bwd_cuda(q, k, v, *bargs, **kw)
                want = fa.fused_attention_bwd_plain(q, k, v, *bargs, **kw)
                truth = fa.fused_attention_bwd_plain(
                    q32, k.float(), v.float(), g.float(), t_out, t_lse, m,
                    seeds, rate, False, **kw)
                for a, b, x in zip(got, want, truth):
                    ratio = max(ratio, rel(a, x) / max(rel(b, x), 1e-12))
                bwd_errs.append(max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(got, want)))
                del got, want, truth
            per_rank.append(m_out)
            del t_out, t_lse, merged
            torch.cuda.empty_cache()
        # the merged ring output against one kernel call over all 8192
        whole = [torch.cat([c[n] for c in calls], dim=1).contiguous()
                 for n in ("q", "k", "v", "mask")]
        one = fa.fused_attention_cuda(
            *whole[:3], whole[3].to(torch.int32).contiguous(), seeds, rate)
        merged_errs.append((torch.cat(per_rank, dim=1).float()
                            - one.float()).abs().max().item())
        del whole, one, per_rank
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    say(f"ring hops: {hops} hops of the captured calls (layers "
        f"{[c['layer'] for c in caps[0]]} of both ranks, {B}x{L_loc}x{Hh}x64 bf16, rate "
        f"{rate:g}, bases (row, col) in {{0, {L_loc}}}, L_hash {L_hash}), "
        f"kernel and plain in bf16 against plain in f32: the kernel's "
        f"relative L2 error at most {ratio:.4f}x the plain version's over "
        f"out, dq, dk, dv (limit {TRUTH_RATIO:g}); lse {max(lse_errs):.3e} "
        f"(tol {LSE_ATOL:g}); kernel vs plain max_abs_err forward "
        f"{max(fwd_errs):.3e}, backward {max(bwd_errs):.3e} (recorded); the "
        f"hops merged equal the ring's training output bit for bit: {exact}; "
        f"merged against one whole-sequence kernel call at {L_hash}: "
        f"max_abs_err {[f'{e:.3e}' for e in merged_errs]} (tol "
        f"{ATOL['bf16']:g})")
    if ratio > TRUTH_RATIO or max(lse_errs) > LSE_ATOL:
        fail("a ring hop's kernel strays from the f32 function further than "
             "plain")
    if not exact:
        fail("the captured hops merged do not reproduce the ring's output")
    if max(merged_errs) > ATOL["bf16"]:
        fail("the merged ring output disagrees with one whole-sequence call")

    del caps
    torch.cuda.empty_cache()
    return dict(fwd_err=max(fwd_errs), bwd_err=max(bwd_errs),
                merged_err=max(merged_errs), shape=f"{B}x{L_loc}x{Hh}x64")


def _time_ring_hop(torch, fa, bw, flops) -> dict:
    """Phase 15b's timing, which the main process takes on the card alone
    once the side lane beside phase 15 joined: one hop of the captured
    ring's first call at its training shape, rank 1's rows against rank
    0's block (base (4096, 0)), key mask and dropout, forward and backward,
    beside its bound, plain and sdpa."""
    import torch.nn.functional as F

    from ml_recipe_tpu_torch.ops.ring_attention import _stream_row_seeds

    c0, c1 = (torch.load(SP_DIR / "longdoc" / f"capture{r}.pt",
                         map_location="cuda")[0] for r in range(SP_WORLD))
    B, L_loc, Hh, _ = c0["q"].shape
    L_hash, rate = SP_WORLD * L_loc, c0["rate"]
    seeds = _stream_row_seeds(c0["seed"], B=B, H=Hh, data_index=0).cuda()
    g_gen = torch.Generator(device="cuda").manual_seed(15)
    q, k, v = c1["q"], c0["k"], c0["v"]
    m = c0["mask"].to(torch.int32).contiguous()
    kw = dict(base=(L_loc, 0), L_hash=L_hash)
    elems = q.numel() * q.element_size()
    g = torch.randn(q.shape, generator=g_gen, device="cuda",
                    dtype=torch.float32).to(q.dtype)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    bool_mask = (m > 0)[:, None, None, :]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bool_mask,
                                              dropout_p=rate)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), g.transpose(1, 2))

    with torch.no_grad():
        sdpa_fwd_ms = time_ms(torch, sdpa_fwd)
    fwd = dict(
        ms=time_ms(torch, lambda: fa.fused_attention_cuda(
            q, k, v, m, seeds, rate, False, True, **kw)),
        plain_ms=time_ms(torch, lambda: fa.fused_attention_plain(
            q, k, v, m, seeds, rate, False, True, **kw), reps=3),
        library_ms=sdpa_fwd_ms)
    fwd["bound_ms"], fwd["bound_by"] = _bound(
        4 * elems + m.numel() * 4 + B * 4 + B * Hh * L_loc * 4,
        4 * B * Hh * L_loc * L_loc * q.shape[3], bw, flops)
    out, lse = fa.fused_attention_cuda(q, k, v, m, seeds, rate, False, True,
                                       **kw)
    args = (q, k, v, g, out, lse, m, seeds, rate, False)
    bwd = dict(
        ms=time_ms(torch, lambda: fa.fused_attention_bwd_cuda(*args, **kw)),
        plain_ms=time_ms(torch, lambda: fa.fused_attention_bwd_plain(
            *args, **kw), reps=3),
        library_ms=time_ms(torch, sdpa_fwd_bwd) - sdpa_fwd_ms)
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        8 * elems + B * Hh * L_loc * 4 + m.numel() * 4 + B * 4,
        10 * B * Hh * L_loc * L_loc * q.shape[3], bw, flops)
    for name, t in (("fused_attention_fwd", fwd), ("fused_attention_bwd", bwd)):
        say(f"timing {name} ring hop {B}x{L_loc}x{Hh}x64 bf16 (rate "
            f"{rate:g}, base {kw['base']}, L_hash {L_hash}): kernel_ms="
            f"{t['ms']:.4f} plain_ms={t['plain_ms']:.4f} library_ms(sdpa"
            f"{' backward, fwd+bwd minus fwd' if name.endswith('bwd') else ''}"
            f", its own dropout stream)={t['library_ms']:.4f} bound_ms="
            f"{t['bound_ms']:.4f} ({t['bound_by']})")
    del c0, c1, q, k, v, g, out, lse, args, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd)


def _sp_records(kind: str) -> list:
    return [json.loads((SP_DIR / kind / f"rank{r}.json").read_text())
            for r in range(SP_WORLD)]


def _reload_zero1_at_one_process(torch, digest: str):
    """Phase 15c: the zero1 run's sharded checkpoint into a one-process
    trainer of the same cfg (``data:1``, the optimizer kept): the weights
    are the run's (digest), and every moment is the checkpoint's."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.models.convert import from_jax_params
    from ml_recipe_tpu_torch.train.checkpoint import read_state

    path = SP_DIR / "zero1" / "ckpt"
    params, model_params = _train_flags(REPO / "config" / "long_context.cfg",
                                        ZERO1[2:])
    with _shallow(SP_LAYERS):
        trainer = train_cli.build_trainer(params, model_params)
    trainer.drop_optimizer = False
    t0 = time.perf_counter()
    trainer.load_state_dict(path)
    seconds = time.perf_counter() - t0
    state = read_state(path)
    manifest = json.dumps(state.get("mesh_axes")), state.get("opt_sharding")
    same = _param_digest(trainer.model) == digest
    saved = trainer.optimizer.flax_state()
    moments_equal = True
    for key in ("mu", "nu"):
        want = from_jax_params(state["optimizer"]["0"]["0"][key])
        got = from_jax_params(saved["0"]["0"][key])
        moments_equal &= all(torch.equal(got[n], want[n]) for n in want)
    say(f"ZeRO-1: the zero1 run's sharded checkpoint ({manifest[1]}, "
        f"mesh_axes {manifest[0]}) reloaded in one process in "
        f"{seconds:.1f}s: weights equal the run's: {same}; every adam moment "
        f"equal to the checkpoint's: {moments_equal}; global step "
        f"{trainer.global_step}")
    if manifest[1] != "zero1" or not same or not moments_equal:
        fail("the zero1 sharded checkpoint did not reload at W = 1")
    del trainer, saved, state
    torch.cuda.empty_cache()


def phase_sequence_parallel(torch, fa, bw, flops):
    """Phase 15: config/longdoc.cfg as two ranks on the card (ring
    attention over ``seq:2``) against one process at ``data:1``, every
    captured hop against plain, and config/long_context.cfg at W = 2 with
    ZeRO-1 against the same with the optimizer whole. Returns the launch
    counts by path and the hop's timings."""
    import shutil

    shutil.rmtree(SP_DIR, ignore_errors=True)
    SP_DIR.mkdir(parents=True)
    deadline = time.monotonic() + SP_DEADLINE_S
    t_phase = time.perf_counter()
    procs = {}
    try:
        procs = _sp_pair("longdoc")
        _join(procs, deadline, "sequence parallel")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = _sp_records("longdoc")
    r0 = ranks[0]
    S, layers, split = SP_WORLD, r0["layers"], r0["batch_split"]
    micro, evals = len(r0["steps"]) * split, r0["eval_batches"]
    # per ring call S hop launches; remat runs each layer's forward twice
    want = {"fused_attention_fwd": layers * S * (2 * micro + evals),
            "fused_attention_bwd": layers * S * micro,
            "layer_norm_fwd": 0, "layer_norm_bwd": 0, "q8_matmul": 0,
            "q8_quantize": 0}
    for r, rec in enumerate(ranks):
        ring = rec["ring"]
        say(f"longdoc seq:2 rank {r} ({rec['mesh']}, attention "
            f"{rec['attention_impl']}, gloo on the card): {len(rec['steps'])} "
            f"steps of {split} micro-batches of {rec['micro_shape'][0]}x"
            f"{rec['micro_shape'][1]} per rank + {evals} eval batches in "
            f"{rec['wall']:.1f}s; step walls "
            f"{[round(s['seconds'], 2) for s in rec['steps']]} s; losses "
            f"{[round(s['loss'], 5) for s in rec['steps']]}; ring: "
            f"{ring['hops']} hops, {ring['bytes'] / 1e9:.2f} GB sent, "
            f"{ring['staged_bytes'] / 1e9:.2f} GB staged through pinned host "
            f"buffers, {ring['seconds']:.2f} s in hops; launch counts "
            f"{rec['launched']}, expected {want}")
    if r0["mesh"] != {"data": 1, "seq": 2} or r0["attention_impl"] != "ring":
        fail("the longdoc run is not ring attention over data:1,seq:2")
    if any(rec["launched"] != want for rec in ranks):
        fail("launch counts do not match the ring's training path")
    # the memory pre-flight's probe is one more micro-batch of ring calls
    hops = layers * (4 * (micro + r0["preflight_probes"]) + evals)
    if any(rec["ring"]["hops"] != hops or rec["ring"]["staged_bytes"] <= 0
           for rec in ranks):
        fail(f"the ring did not take its {hops} staged hops per rank")
    if any([s["loss"] for s in rec["steps"]] != [s["loss"] for s in
                                                 r0["steps"]]
           or rec["digest"] != r0["digest"] for rec in ranks):
        fail("the ranks of the seq group logged other losses or ended "
             "with other weights")
    if not all(np.isfinite(s["loss"]) for s in r0["steps"]):
        fail("a longdoc loss is not finite")

    # the same run in one process: data:1, the streaming kernels at 8192
    store = {}
    with _pre_clip_grads(torch, store):
        trainer, _, one, one_wall = _run_training(
            torch, "longdoc.cfg", [*LONGDOC[2:], "--mesh", "data:1"],
            layers=SP_LAYERS)
    one_steps = [(h["loss"], h["seconds"]) for h in trainer.history]
    want1 = {k: v // S for k, v in want.items()}
    del trainer
    torch.cuda.empty_cache()
    grads = torch.load(SP_DIR / "longdoc" / "grads.pt")
    rel = float((grads - store["grads"]).norm() / store["grads"].norm())
    loss, loss1 = r0["steps"][0]["loss"], one_steps[0][0]
    loss_rel = abs(loss - loss1) / abs(loss1)
    norm1 = float(store["grads"].norm())
    say(f"longdoc seq:1 (one process, data:1, {r0['micro_shape'][0]}x"
        f"{S * r0['micro_shape'][1]} micro-batches): "
        f"{one_wall:.1f}s, step walls {[round(s, 2) for _, s in one_steps]} "
        f"s, losses {[round(l, 5) for l, _ in one_steps]}; launch counts "
        f"{one}, expected {want1}; step 1 seq:2 against seq:1: loss {loss!r} "
        f"against {loss1!r}, relative {loss_rel:.3e} (tol "
        f"{SP_LOSS_REL_TOL:g}); gradient at the clip global norm "
        f"{r0['grad_norm']:.6g} against {norm1:.6g}, relative L2 {rel:.3e} "
        f"(tol {SP_GRAD_REL_TOL:g})")
    if one != want1:
        fail("launch counts do not match the one-process longdoc path")
    if not (np.isfinite(loss_rel) and loss_rel <= SP_LOSS_REL_TOL):
        fail("the seq:2 step-1 loss disagrees with seq:1")
    if not (np.isfinite(rel) and rel <= SP_GRAD_REL_TOL):
        fail("the seq:2 step-1 gradient disagrees with seq:1")
    del grads, store
    hop = _hold_ring_hops(torch, fa, bw, flops)

    # ZeRO-1: long_context.cfg at W = 2, zero1 (the cfg's) and off together
    procs = {}
    try:
        procs = {**_sp_pair("zero1"), **_sp_pair("off")}
        _join(procs, deadline, "ZeRO-1")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    zero, off = _sp_records("zero1"), _sp_records("off")
    whole = off[0]["opt_bytes"]      # off keeps every moment whole
    zmicro = len(zero[0]["steps"]) * zero[0]["batch_split"]
    layers = zero[0]["layers"]
    zwant = {"fused_attention_fwd": layers * (zmicro + zero[0]["eval_batches"]),
             "fused_attention_bwd": layers * zmicro, "layer_norm_fwd": 0,
             "layer_norm_bwd": 0, "q8_matmul": 0, "q8_quantize": 0}
    for kind, recs in (("zero1", zero), ("off", off)):
        for r, rec in enumerate(recs):
            say(f"long_context W=2 {kind} rank {r} ({rec['opt_sharding']}, "
                f"{rec['mesh']}): {rec['wall']:.1f}s, step walls "
                f"{[round(s['seconds'], 2) for s in rec['steps']]} s, losses "
                f"{[round(s['loss'], 5) for s in rec['steps']]}; optimizer "
                f"state {rec['opt_bytes'] / 1e6:.1f} MB on this rank (whole: "
                f"{whole / 1e6:.1f} MB); launch counts "
                f"{rec['launched']}, expected {zwant}")
    same = len({rec["digest"] for rec in zero + off}) == 1
    say(f"ZeRO-1: parameters after the zero1 and off runs bit-identical: "
        f"{same}; losses equal: "
        f"{[s['loss'] for s in zero[0]['steps']] == [s['loss'] for s in off[0]['steps']]}; "
        f"sharded save {zero[0]['save_seconds']:.1f}s")
    if any(rec["launched"] != zwant for rec in zero + off):
        fail("launch counts do not match the long_context W = 2 path")
    if [r["opt_sharding"] for r in zero + off] != ["zero1"] * 2 + ["off"] * 2:
        fail("the zero1 run did not shard its optimizer state, or off did")
    if not all(2 * rec["opt_bytes"] <= whole * 1.01 for rec in zero):
        fail("a zero1 rank holds more than half the optimizer state")
    if not same:
        fail("zero1 and off ended with other parameters")
    _reload_zero1_at_one_process(torch, zero[0]["digest"])
    say(f"phase 15 wall {time.perf_counter() - t_phase:.1f}s")
    return dict(longdoc={k: sum(rec["launched"][k] for rec in ranks)
                         for k in r0["launched"]},
                one=one, zero1={k: sum(rec["launched"][k]
                                       for rec in zero + off)
                                for k in zero[0]["launched"]},
                hop=hop)


RT_DIR = OUT_DIR / "runtime"
RT_CMD = ["-m", "ml_recipe_tpu_torch.cli.train", "-c",
          str(REPO / "config" / "test_bert.cfg"), "--dummy_dataset",
          "--debug", "--seed", "0", "--ln_impl", "fused"]
RT_DEADLINE_S = 420
RT_LOSS_REL_TOL = 1e-3
RT_UPDATE_REL_TOL = 1e-2
# the resume drill's dummy train and test sets: 2 steps of 256 an epoch
# and 32 eval batches of 16, so each epoch ends in its checkpoints
RT_DUMMY_LEN = 512
RT_RESUME_STEP = 2              # the step of epoch 1's checkpoints
# the resume drill's depth: bert-base widths, 4 of its 12 layers (what a
# resume carries and replays does not depend on the depth; phase 16's
# instrumented run and phase 18 keep all 12)
RT_DRILL_LAYERS = 4
# the profiler window's kernels, by the words in their names: one kernel
# of each per wrapper launch (a backward attention launch runs its row
# term, dk/dv and dq kernels: dq counts it; a LayerNorm backward launch its
# row kernel and the column sum)
RT_TRACE_KERNELS = {"fused_attention_fwd": ("fused_attention_fwd", None),
                    "fused_attention_bwd": ("fused_attention_bwd_dq", None),
                    "layer_norm_fwd": ("layer_norm_fwd", None),
                    "layer_norm_bwd": ("layer_norm_bwd", "_sum")}

# Phase 16's observer in the CLI processes it starts (found on PYTHONPATH
# as sitecustomize): each Trainer notes its parameters when built and,
# after a restore, writes what the checkpoint carried (restored minus
# built); when it closes, it writes its step records, its process's kernel
# launch counts, its optimizer state's bytes, its ZeRO-1 bucket count and
# its parameter update (final minus built) under $SMOKE_RUNTIME_OUT. With
# $SMOKE_DUMMY_LEN it cuts the dummy datasets to that many items; with
# $SMOKE_SAVES (comma-separated file names) it writes only the checkpoints
# of those names: the ones a run resumes (last.ch, and plain's
# epoch_1.ch), not the copies nothing reads (a bert-base save with its
# moments takes seconds); with $SMOKE_LAYERS every QAModel is built with
# that many encoder layers (the widths kept); with $SMOKE_GLOO a world of
# several ranks joins over gloo (two ranks share the one card, where NCCL
# refuses a device twice, as phase 11's workers join). It then imports the next sitecustomize on the path,
# if there is one.
RT_OBSERVER = """
import os
import sys

_OUT = os.environ.get("SMOKE_RUNTIME_OUT")
if _OUT:
    import json

    import torch

    from ml_recipe_tpu_torch.data import datasets as _datasets
    from ml_recipe_tpu_torch.ops import flash_attention as _fa
    from ml_recipe_tpu_torch.ops import layer_norm as _ln
    from ml_recipe_tpu_torch.parallel.sharding import (
        opt_state_bytes_per_chip as _opt_bytes)
    from ml_recipe_tpu_torch.train import trainer as _trainer

    if os.environ.get("SMOKE_GLOO"):
        from ml_recipe_tpu_torch.parallel import dist as _pdist

        _pdist.resolve_backend = lambda backend, device: "gloo"

    def _flat(model):
        return torch.cat([p.detach().float().reshape(-1).cpu()
                          for p in model.parameters()])

    _init, _close = _trainer.Trainer.__init__, _trainer.Trainer.close
    _load = _trainer.Trainer.load_state_dict
    _save = _trainer.Trainer.save_state_dict
    _saves = os.environ.get("SMOKE_SAVES")

    def _observed_save(self, path):
        if _saves is None or os.path.basename(str(path)) in _saves.split(","):
            _save(self, path)

    def _observed_init(self, *args, **kwargs):
        _init(self, *args, **kwargs)
        self._smoke_start = _flat(self.model)

    def _observed_load(self, path):
        _load(self, path)
        torch.save(_flat(self.model) - self._smoke_start,
                   os.path.join(_OUT, f"restored_{os.getpid()}.pt"))

    def _observed_close(self):
        _close(self)
        pid = os.getpid()
        torch.save(_flat(self.model) - self._smoke_start,
                   os.path.join(_OUT, f"update_{pid}.pt"))
        with open(os.path.join(_OUT, f"run_{pid}.json"), "w") as fh:
            json.dump({"history": self.history,
                       "global_step": self.global_step,
                       "eval_batches": self.eval_batches,
                       "preflight_probes": self.preflight_probes,
                       "opt_bytes": _opt_bytes(self.optimizer)
                       if self.optimizer is not None else 0,
                       "zero1_buckets": self.zero1_bucket_count,
                       "mesh": self.plan.describe(),
                       "launches": {
                           "fused_attention_fwd": _fa.KERNEL.launches,
                           "fused_attention_bwd": _fa.BWD_KERNEL.launches,
                           "layer_norm_fwd": _ln.FWD_KERNEL.launches,
                           "layer_norm_bwd": _ln.BWD_KERNEL.launches}}, fh)

    _trainer.Trainer.__init__ = _observed_init
    _trainer.Trainer.load_state_dict = _observed_load
    _trainer.Trainer.close = _observed_close
    _trainer.Trainer.save_state_dict = _observed_save

    _layers = int(os.environ.get("SMOKE_LAYERS") or 0)
    if _layers:
        import dataclasses

        from ml_recipe_tpu_torch.models import qa_model as _qa

        _qa_init = _qa.QAModel.__init__

        def _shallow_init(self, cfg, *args, **kwargs):
            _qa_init(self, dataclasses.replace(cfg, num_layers=_layers),
                     *args, **kwargs)

        _qa.QAModel.__init__ = _shallow_init

    _cap = int(os.environ.get("SMOKE_DUMMY_LEN") or 0)
    if _cap:
        _dummy_init = _datasets.DummyDataset.__init__

        def _capped_init(self, *args, **kwargs):
            _dummy_init(self, *args, **kwargs)
            self.dataset_len = min(self.dataset_len, _cap)

        _datasets.DummyDataset.__init__ = _capped_init

_here = os.path.dirname(os.path.abspath(__file__))
_me = sys.modules.pop("sitecustomize", None)
_path = list(sys.path)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _here]
try:
    import sitecustomize  # noqa: F401  (the next one on the path)
except ImportError:
    pass
finally:
    sys.path[:] = _path
    sys.modules["sitecustomize"] = _me
"""


def _rt_env(run: Path, dummy_len: int = 0, saves: str = None,
            layers: int = 0) -> dict:
    """A fresh ``run`` directory (an earlier run's checkpoints or fault
    markers would change what this one does) and the environment of its
    CLI: the observer's site directory and the repo on PYTHONPATH, its
    records going to ``run/observed``, the dummy datasets cut to
    ``dummy_len`` items, the checkpoints written cut to ``saves`` and the
    encoder cut to ``layers`` when they are set."""
    import shutil

    site = RT_DIR / "site"
    site.mkdir(parents=True, exist_ok=True)
    observer = site / "sitecustomize.py"
    # written once: runs that start beside each other import it meanwhile
    if not observer.exists() or observer.read_text() != RT_OBSERVER:
        observer.write_text(RT_OBSERVER)
    shutil.rmtree(run, ignore_errors=True)
    out = run / "observed"
    out.mkdir(parents=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(site), str(REPO)] + ([env["PYTHONPATH"]]
                                  if env.get("PYTHONPATH") else []))
    env["SMOKE_RUNTIME_OUT"] = str(out)
    if dummy_len:
        env["SMOKE_DUMMY_LEN"] = str(dummy_len)
    if saves:
        env["SMOKE_SAVES"] = saves
    if layers:
        env["SMOKE_LAYERS"] = str(layers)
    return env


def _rt_records(out: Path):
    """The observer's records of the runs under ``out``, in the order the
    runs ended: each its record, its update and what its restore carried
    (None without a restore)."""
    import torch

    recs = []
    for path in sorted(out.glob("run_*.json"),
                       key=lambda p: p.stat().st_mtime):
        pid = path.stem.split("_", 1)[1]
        restored = out / f"restored_{pid}.pt"
        recs.append(SimpleNamespace(
            record=json.loads(path.read_text()),
            update=torch.load(out / f"update_{pid}.pt"),
            restored=torch.load(restored) if restored.exists() else None))
    return recs


def _rt_launch(cmd, extra, env, log: Path):
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, *cmd, *map(str, extra)], cwd=str(REPO),
            env=env, stdout=fh, stderr=subprocess.STDOUT)


def _rt_wait(proc, log: Path, what: str) -> int:
    try:
        return proc.wait(timeout=RT_DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"runtime phase: the {what} run outlived {RT_DEADLINE_S}s; its "
             f"log ends {log.read_text()[-3000:]}")


def _rt_run(cmd, extra, env, log: Path, what: str):
    """One CLI run to its end; fails unless it exits 0. Returns its
    observed run (the one Trainer it built)."""
    rc = _rt_wait(_rt_launch(cmd, extra, env, log), log, what)
    if rc != 0:
        fail(f"runtime phase: the {what} run exited {rc}; its log ends "
             f"{log.read_text()[-3000:]}")
    (rec,) = _rt_records(Path(env["SMOKE_RUNTIME_OUT"]))
    return rec


def _rt_scrape(port: int, proc, log: Path) -> tuple:
    """``/metrics`` (as {sample: value}) and ``/healthz`` of the running
    CLI once it has taken its first step."""
    deadline = time.monotonic() + RT_DEADLINE_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail(f"runtime phase: the run exited {proc.returncode} before "
                 f"its /metrics showed a step; its log ends "
                 f"{log.read_text()[-3000:]}")
        try:
            metrics = _scrape(port)
        except OSError:
            metrics = {}
        if metrics.get("train_steps_total", 0) >= 1:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=30) as resp:
                return metrics, json.loads(resp.read().decode())
        time.sleep(0.1)
    fail("runtime phase: /metrics showed no step before the deadline")


def _rt_trace(path: Path, micro: int, layers: int) -> dict:
    """The profiler window's launches of the four kernels and its device
    ms by kernel family; fails unless the window holds one step's launches
    (``layers`` attention and LN_PER_FORWARD LayerNorm launches per
    micro-batch, forward and backward)."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {k: sum(key in e["name"] and not (skip and skip in e["name"])
                       for e in kernels)
                for k, (key, skip) in RT_TRACE_KERNELS.items()}
    want = {"fused_attention_fwd": layers * micro,
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": LN_PER_FORWARD * micro,
            "layer_norm_bwd": LN_PER_FORWARD * micro}
    by_family = {}
    for e in kernels:
        family = _train_family(e["name"])
        by_family[family] = by_family.get(family, 0.0) + e["dur"] / 1e3
    say(f"runtime: --trace window {path.name}: {len(kernels)} device "
        f"kernels, {len(events)} events; launches {launches}, expected "
        f"{want}; device ms by family "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])))
    if launches != want:
        fail("the --trace window does not hold one step's launches of the "
             "attention and LayerNorm kernels")
    return {"launches": launches, "device_ms": by_family}


def _rt_resume_cfg() -> Path:
    """A copy of config/test_bert.cfg for the resume drill: ``debug`` off,
    so each epoch ends in its checkpoints, and ``drop_optimizer`` off, so a
    resume restores the whole training state (a ``store_true`` set in a
    cfg cannot be unset on the command line)."""
    keys = {"debug": "False", "drop_optimizer": "False"}
    out = []
    for line in (REPO / "config" / "test_bert.cfg").read_text().splitlines():
        key = line.split("=", 1)[0].strip()
        out.append(f"{key}={keys.pop(key)}" if key in keys else line)
    if keys:
        fail(f"config/test_bert.cfg has no {sorted(keys)}")
    RT_DIR.mkdir(parents=True, exist_ok=True)
    path = RT_DIR / "test_bert_resume.cfg"
    path.write_text("\n".join(out) + "\n")
    return path


def _rel(a, b) -> float:
    """Relative L2 distance of ``a`` from the reference ``b``."""
    return ((a - b).norm() / b.norm()).item()


def _rt_plain_and_untraced(cmd, instruments, plain_dir: Path,
                           untraced_dir: Path):
    """The resume drill's plain run, then untraced from its ``epoch_1.ch``
    (:func:`phase_runtime`); fails unless they took 2 epochs of 2 steps."""
    import shutil

    plain = _rt_run(cmd, ["--dump_dir", plain_dir / "results"],
                    _rt_env(plain_dir, RT_DUMMY_LEN, "last.ch,epoch_1.ch",
                            RT_DRILL_LAYERS),
                    plain_dir / "cli.log", "plain")
    # only epoch_1.ch is read again: the disk holds one run's checkpoints
    for ckpt in (plain_dir / "results" / "test").glob("*.ch"):
        if ckpt.name != "epoch_1.ch":
            ckpt.unlink()
    untraced = _rt_run(cmd, [
        "--dump_dir", untraced_dir / "results", "--last",
        plain_dir / "results" / "test" / "epoch_1.ch", "--trace_spans",
        untraced_dir / "spans", "--metrics_port", _free_port(),
        *instruments], _rt_env(untraced_dir, RT_DUMMY_LEN, "last.ch",
                               RT_DRILL_LAYERS),
        untraced_dir / "cli.log", "untraced")
    shutil.rmtree(plain_dir / "results", ignore_errors=True)
    shutil.rmtree(untraced_dir / "results", ignore_errors=True)
    steps = 2 * RT_DUMMY_LEN // 256     # test_bert.cfg's train_batch_size
    if (len(plain.record["history"]), plain.record["global_step"],
            untraced.record["global_step"]) != (
                steps, steps, RT_RESUME_STEP + steps):
        fail("runtime phase: the resume drill's runs did not take 2 epochs "
             "of 2 steps")
    return plain, untraced


def _rt_resume_drill(torch, cmd, instruments) -> dict:
    """Phase 16, step 2: the resume drill of ``cmd`` (a train CLI command
    on :func:`_rt_resume_cfg`'s copy), its dummy datasets cut to
    RT_DUMMY_LEN items; see :func:`phase_runtime`. Returns the observed
    plain, untraced and supervised (attempt 2) runs."""
    import shutil

    from ml_recipe_tpu_torch.metrics.goodput import (
        read_ledger, summarize_events)

    plain_dir, untraced_dir = RT_DIR / "plain", RT_DIR / "untraced"
    # the supervised run needs nothing of the other two: it runs beside them
    sup = RT_DIR / "supervised"
    env = _rt_env(sup, RT_DUMMY_LEN, "last.ch", RT_DRILL_LAYERS)
    env["MLRT_FAULT_STATE"] = str(sup / "faults")
    log = sup / "cli.log"
    t0 = time.perf_counter()
    proc = _rt_launch(cmd, [
        "--dump_dir", sup / "results", "--trace", "--trace_spans",
        sup / "spans", "--metrics_port", _free_port(), *instruments,
        "--supervise", "--backoff_base", "0.5", "--fault_plan",
        f"trainer.step:kill@{RT_RESUME_STEP + 1}!once"], env, log)
    try:
        plain, untraced = _rt_plain_and_untraced(cmd, instruments,
                                                 plain_dir, untraced_dir)
        rc = _rt_wait(proc, log, "supervised")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sup_wall = time.perf_counter() - t0
    exp = sup / "results" / "test"
    sidecar = json.loads((exp / "supervisor_state.json").read_text())
    say(f"runtime: supervised run rc {rc} in {sup_wall:.1f}s; sidecar "
        f"outcomes {sidecar['outcomes']}, return codes "
        f"{sidecar['last_returncode']}, status {sidecar['status']}")
    if rc != 0 or sidecar["outcomes"] != ["crash", "clean"]:
        fail(f"runtime phase: the supervised drill did not recover in two "
             f"attempts; its log ends {log.read_text()[-3000:]}")
    events = read_ledger(exp / "goodput.jsonl")
    shutil.rmtree(sup / "results", ignore_errors=True)
    ends = [e for e in events if e["ev"] == "attempt_end"]
    starts = [e for e in events if e["ev"] == "attempt_start"]
    resumed_from = [e["resume_step"] for e in starts]
    restores = [e for e in json.loads((sup / "spans" / "train_trace_p0.json")
                                      .read_text())["traceEvents"]
                if e["name"] == "checkpoint_restore"]
    say(f"runtime: attempts resumed from steps {resumed_from}; "
        f"checkpoint_restore spans "
        f"{[(e['args']['path'], round(e['dur'] / 1e6, 3)) for e in restores]}"
        f" (path, s)")
    if resumed_from != [None, RT_RESUME_STEP] or len(restores) != 1:
        fail(f"runtime phase: attempt 2 did not resume epoch 1's "
             f"checkpoint of step {RT_RESUME_STEP}")
    (resumed,) = _rt_records(sup / "observed")
    last = lambda r: r.record["history"][-1]["loss"]
    carried_rel = _rel(resumed.restored, untraced.restored)
    update_rel = _rel(resumed.update, untraced.update)
    loss_rel = abs(last(resumed) - last(untraced)) / abs(last(untraced))
    summary = summarize_events(events)
    gap = starts[1]["t"] - ends[0]["t"]
    say(f"runtime: supervised attempt 2 against untraced (the same restore "
        f"by hand): restored state relative L2 {carried_rel:.2e} (bit for "
        f"bit: {torch.equal(resumed.restored, untraced.restored)}), "
        f"parameter update relative L2 {update_rel:.2e} (bit for bit: "
        f"{torch.equal(resumed.update, untraced.update)}; tol "
        f"{RT_UPDATE_REL_TOL:g}); last-step loss {last(resumed):.6f} vs "
        f"untraced {last(untraced):.6f} (relative {loss_rel:.2e}, tol "
        f"{RT_LOSS_REL_TOL:g}; plain's, 2 steps fewer from the same "
        f"checkpoint: {last(plain):.6f}); attempt exits "
        f"{[(e['returncode'], e['outcome'], e['step']) for e in ends]}; "
        f"restart gap {gap:.3f}s (backoff base 0.5 s, seeded jitter); "
        f"goodput ratio {summary['goodput_ratio']:.4f} over "
        f"{summary['total_wall_s']:.1f}s, badput "
        + ", ".join(f"{k} {v:.2f}s" for k, v in summary["badput_s"].items())
        + f"; kernel library hits {summary['aot_hits']} misses "
        f"{summary['aot_misses']}")
    if not (carried_rel <= RT_UPDATE_REL_TOL
            and update_rel <= RT_UPDATE_REL_TOL
            and loss_rel <= RT_LOSS_REL_TOL):
        fail("runtime phase: the supervised resume does not reproduce the "
             "same resume by hand")
    if [e["returncode"] for e in ends] != [89, 0]:
        fail("runtime phase: the ledger's attempt exits are not the drill's")
    return {"plain": plain, "untraced": untraced, "resumed": resumed}


def phase_runtime(torch):
    """Phase 16: the runtime subsystems through the CLI on the card.

    1. ``test_bert.cfg --dummy_dataset --debug --seed 0 --ln_impl fused``
       (bert-base, 2 steps of 8 micro-batches of 32x512) as a child
       process with ``--trace --trace_spans --metrics_port --goodput_ledger
       --flight_recorder --watchdog_timeout 600``, gated on its exit code;
       ``/metrics`` and ``/healthz`` scraped after its first step; the
       profiler window's Chrome trace parsed (one step: 12 attention and 25
       LayerNorm launches per micro-batch, forward and backward), its
       device ms by kernel family printed; the child's own launch counts
       (phase 9's);
    2. the resume drill, on a copy of test_bert.cfg with ``debug`` and
       ``drop_optimizer`` off and the dummy datasets cut to RT_DUMMY_LEN
       items (2 epochs of 2 steps, each ending in ``last.ch``, and
       plain's epoch 1 in ``epoch_1.ch``: the observer skips the
       ``epoch_<n>.ch`` and ``best.ch`` copies nothing reads), three ways:

       - plain: uninterrupted, without the runtime flags;
       - untraced: every runtime flag but ``--trace``, resumed by hand
         from plain's ``epoch_1.ch`` (``--last``);
       - supervised: every runtime flag, ``--supervise --fault_plan
         'trainer.step:kill@3!once'``: the kill ends attempt 1 at epoch
         2's first step, after ``last.ch`` of step RT_RESUME_STEP.

       The supervised run runs beside plain and untraced (it reads
       nothing of theirs), so their walls are taken beside it. A resume
       replays every epoch from the checkpoint's step (as in the JAX
       package), so it takes 2 steps more than plain: the supervised
       run is held against untraced, the same resume by hand from the
       uninterrupted run's checkpoint. Gates: rc 0 after two attempts (a
       crash, then clean), the ledger's attempt 2 resuming step
       RT_RESUME_STEP and the span file holding its
       ``checkpoint_restore``; what the supervised restore carried
       (restored minus built) and its parameter update (final minus built)
       within RT_UPDATE_REL_TOL relative L2 of untraced's, its last-step
       loss within RT_LOSS_REL_TOL relative. Step walls: step 1 of each
       run beside plain's (the per-step sync and the telemetry; the
       profiler window). The ledger's goodput summary and the restart gap
       are printed.

    Returns the runs' launch counts by path.
    """
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    instruments = ["--goodput_ledger", "--flight_recorder",
                   "--watchdog_timeout", "600"]
    layers, micro = 12, 8

    # 1. every instrument on
    run = RT_DIR / "instrumented"
    port = _free_port()
    log = run / "cli.log"
    env = _rt_env(run)
    proc = _rt_launch(RT_CMD, [
        "--vocab_file", vocab, "--dump_dir", run / "results", "--trace",
        "--trace_spans", run / "spans", "--metrics_port", port,
        *instruments], env, log)
    metrics, health = _rt_scrape(port, proc, log)
    rc = _rt_wait(proc, log, "instrumented")
    if rc != 0:
        fail(f"runtime phase: the instrumented run exited {rc}; its log "
             f"ends {log.read_text()[-3000:]}")
    say(f"runtime: /metrics after step 1: "
        + ", ".join(f"{k} {metrics.get(k)}" for k in (
            "train_steps_total", "train_step_device_seconds_count",
            "train_step_seconds_sum", "train_watchdog_heartbeat_age_seconds",
            "train_aot_cache_hits_total", "train_aot_cache_misses_total",
            "train_goodput_ratio")) + f"; /healthz {health}")
    if not (metrics.get("train_steps_total", 0) >= 1
            and metrics.get("train_step_device_seconds_count", 0) >= 1
            and metrics.get("train_watchdog_heartbeat_age_seconds", -1) >= 0
            and metrics.get("train_aot_cache_hits_total", 0) >= 1
            and metrics.get("train_aot_cache_misses_total") == 0
            and health.get("status") == "ok"
            and health.get("global_step", 0) >= 1
            and health.get("watchdog_heartbeat_age_s") is not None
            and health.get("goodput_ratio") is not None
            and health.get("last_event_age_s") is not None):
        fail("runtime phase: /metrics or /healthz does not show the running "
             "step, the watchdog, the kernel libraries' loads and the ledger")
    # one window of one step: step 0, or step 1 after a capture of step 0
    # without CUDA activity (the window moves on; the log says so)
    traces = sorted((run / "results" / "board" / "test" / "trace").glob(
        "profile_p0_*.json"))
    empty = log.read_text().count("held no CUDA activity")
    say(f"runtime: --trace wrote {[p.name for p in traces]} after {empty} "
        f"capture(s) without CUDA activity")
    if [p.name for p in traces] != [f"profile_p0_steps{empty}-{empty}.json"]:
        fail(f"runtime phase: --trace wrote {traces}, not one window of "
             f"one step")
    window = _rt_trace(traces[0], micro, layers)
    spans = json.loads((run / "spans" / "train_trace_p0.json").read_text())
    names = {e["name"] for e in spans["traceEvents"]}
    want_spans = {"data_wait", "place", "step", "prefetch_stage", "_train",
                  "_test", "profiler_capture_start", "profiler_capture_stop"}
    if not want_spans <= names:
        fail(f"runtime phase: the span file lacks {want_spans - names}")
    (inst,) = _rt_records(run / "observed")
    evals = inst.record["eval_batches"]
    # the memory pre-flight's probes: one micro-batch forward and backward
    # a length bucket
    probes = inst.record["preflight_probes"]
    want = {"fused_attention_fwd": layers * (2 * micro + probes + evals),
            "fused_attention_bwd": layers * (2 * micro + probes),
            "layer_norm_fwd": LN_PER_FORWARD * (2 * micro + probes + evals),
            "layer_norm_bwd": LN_PER_FORWARD * (2 * micro + probes)}
    say(f"runtime: instrumented run's launch counts "
        f"{inst.record['launches']}, expected {want} ({probes} pre-flight "
        f"probes, one a length bucket)")
    if probes < 1:
        fail("runtime phase: the instrumented run ran no memory pre-flight "
             "probe")
    if inst.record["launches"] != want or evals != 22:
        fail("runtime phase: the instrumented run's launch counts do not "
             "match test_bert.cfg's 2 debug steps")

    # 2. the resume drill
    drill = _rt_resume_drill(torch, [
        "-m", "ml_recipe_tpu_torch.cli.train", "-c", _rt_resume_cfg(),
        "--dummy_dataset", "--seed", "0", "--ln_impl", "fused",
        "--vocab_file", vocab], instruments)
    plain, untraced = drill["plain"], drill["untraced"]
    walls = {k: [round(h["seconds"], 4) for h in r.record["history"]]
             for k, r in (("instrumented", inst), ("plain", plain),
                          ("untraced", untraced))}
    say(f"runtime: step walls, s (step 0 carries the kernel libraries' "
        f"loads; step 1 is steady; instrumented is the debug run of 1 at "
        f"12 layers; plain and untraced at {RT_DRILL_LAYERS}, beside the "
        f"supervised run): "
        + ", ".join(f"{k} {v}" for k, v in walls.items())
        + "; step 1 minus plain: "
        + ", ".join(f"{k} {1e3 * (v[1] - walls['plain'][1]):.1f} ms"
                    for k, v in walls.items() if k != "plain"))
    say(f"runtime phase: {time.perf_counter() - t_phase:.1f}s")
    return {"runtime instrumented": inst.record["launches"],
            "runtime plain": plain.record["launches"],
            "runtime untraced": untraced.record["launches"],
            "runtime supervised, attempt 2":
                drill["resumed"].record["launches"],
            "window": window}


# -- phase 17: the warm-up plane ---------------------------------------------------

WARM_DIR = OUT_DIR / "warmup"
WARM_DEADLINE_S = 240
INT8_FLAGS = ("--quantize", "int8", "--ln_impl", "fused")
# the engines of the cold and the warm process, one after the other
WARM_RUNS = ((), INT8_FLAGS)
# the store series of an engine's /metrics
STORE_SERIES = ("qa_aot_cache_hits_total", "qa_aot_cache_misses_total",
                "qa_kernel_build_hits_total", "qa_kernel_build_misses_total")
# launches per device batch of the bf16 and the int8 serving forward
# the rounds after phase 17's counted graph burst, on the same engine: the
# eager and the graph p50 and traffic batch times come from these
BACK_TO_BACK = ("eager", "graph", "graph", "eager")
PER_BATCH = {"bf16": {"fused_attention_fwd": 12},
             "int8": {"fused_attention_fwd": 12, "q8_matmul": Q8_PER_FORWARD,
                      "layer_norm_fwd": LN_PER_FORWARD,
                      "q8_quantize": QUANT_PER_FORWARD}}


def warm_engines(store: str, tuning: str, out: str) -> int:
    """Phase 17's engine process: ``config/serve.cfg`` in bf16, then with
    ``--quantize int8 --ln_impl fused``, each through ``cli.serve``'s
    ``build_engine`` and warmup on the library store ``store``; writes the
    store's session, the build counts and each engine's store series from
    its ``/metrics`` to ``out``."""
    import torch

    from ml_recipe_tpu_torch.cli.serve import build_engine
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_serve_parser)
    from ml_recipe_tpu_torch.ops import aot, cuda_build

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    fa, ln, q8 = _register_kernels()
    t0 = time.perf_counter()
    engines = []
    for extra in WARM_RUNS:
        _, (params, model_params) = get_params(
            (get_serve_parser, get_model_parser),
            ["-c", str(REPO / "config" / "serve.cfg"), "--vocab_file",
             str(OUT_DIR / "vocab.txt"), "--aot_cache", store,
             "--autotune_cache", tuning, *extra])
        engine = build_engine(params, model_params)
        warm = engine.warmup(hbm_preflight=params.hbm_preflight)
        page = {}
        for line in engine.render_metrics().splitlines():
            if line and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                page[name] = float(value)
        engines.append({"flags": " ".join(extra) or "bf16",
                        "dispatch": warm["dispatch"],
                        "graphs": warm["graphs"],
                        "warmup_seconds": warm["warmup_seconds"],
                        "store": {k: page[k] for k in STORE_SERIES}})
        engine.close()
        del engine
        torch.cuda.empty_cache()
    record = {"aot": aot.get().session_summary(),
              "builds": cuda_build.build_counts(),
              "libraries": {lib.name: lib.outcome for lib in (
                  fa.KERNEL.library, fa.BWD_KERNEL.library, ln.LIBRARY,
                  q8.KERNEL.library)},
              "engines": engines, "seconds": time.perf_counter() - t0}
    Path(out).write_text(json.dumps(record))
    return 0


def _real_batch(burst, batch: int, seq: int) -> np.ndarray:
    """``batch`` windows of the burst's requests at ``seq``: a traffic
    batch's ids."""
    from ml_recipe_tpu_torch.quant import make_parity_batches

    lines = [{"question_text": q, "document_text": d}
             for q, d in burst.requests]
    return make_parity_batches(
        burst.tokenizer, lines, max_seq_len=seq,
        max_question_len=burst.params.max_question_len,
        doc_stride=burst.params.doc_stride, batch_size=batch,
        limit=batch)[0]["input_ids"]


def _host_ms(torch, fn, reps: int = 20) -> float:
    """Median host milliseconds of one ``fn()`` call, the device idle
    before each (the launches' issue time when ``fn`` does not wait)."""
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(samples)


# the device functions each wrapper's launch starts, by the kernel's count
# name (one of them per launch at the serving shapes)
DEVICE_FUNCTIONS = {
    "fused_attention_fwd": ("fused_attention_fwd_kernel",
                            "fused_attention_fwd_tc"),
    "fused_attention_bwd": ("fused_attention_bwd_dq",),
    "layer_norm_fwd": ("layer_norm_fwd_warp_kernel", "layer_norm_fwd_kernel"),
    "layer_norm_bwd": ("layer_norm_bwd_warp_kernel", "layer_norm_bwd_kernel"),
    "q8_matmul": ("q8_matmul_kernel", "q8_matmul_wgmma_kernel"),
    "q8_quantize": ("q8_quantize_rows_kernel",),
}
REPLAYS_TRACED = 3
# traces of a bucket's replays taken until one shows its launches (a
# trace's edge has dropped a kernel event before, and a spin kernel on each
# side guards it); a replay that launches too few kernels shows in each
REPLAY_TRACES = 3


def _traced_replay_launches(torch, graph):
    """Each hand-written kernel's launches per replay of ``graph``, counted
    from the device events of a torch.profiler trace of REPLAYS_TRACED
    replays between two spin kernels (:func:`device_trace`); None when the
    trace held none."""
    torch.cuda.synchronize()

    def replays():
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(REPLAYS_TRACED):
            graph.replay()
        torch.cuda._sleep(SPIN_CYCLES)

    events = device_trace(torch, replays, warmup=True)
    if events is None:
        return None
    seen = {k: 0 for k in KERNELS}
    for name, _, _ in events:
        for k, functions in DEVICE_FUNCTIONS.items():
            if any(f in name for f in functions):
                seen[k] += 1
    return {k: n / REPLAYS_TRACED for k, n in seen.items()}


def _graphs_against_eager(torch, key: str, burst) -> dict:
    """Every kept bucket's replay on a real batch against the eager forward
    (``np.array_equal``), with one forward's launches per replay both in
    the counts the replay adds and in the device events of a traced replay
    (measured: equal to the capture's tally and to PER_BATCH); then, on
    the 32x384 batch, the host ms to issue one batch (eager launches
    against one replay), its device ms, the host ms of a whole batch (copy
    in, run, rows out), and the device's idle share from a profiled run of
    each."""
    engine = burst.engine
    want = {k: PER_BATCH[key].get(k, 0) for k in KERNELS}
    traced = {}
    for bucket in engine.grid:
        ids = _real_batch(burst, bucket.batch, bucket.seq)
        c0 = counts()
        eager = engine.run_packed({"input_ids": ids})
        c1 = counts()
        graph = engine._dispatch(bucket.batch, bucket.seq, {"input_ids": ids})
        c2 = counts()
        per_eager = {k: c1[k] - c0[k] for k in c0}
        per_replay = {k: c2[k] - c1[k] for k in c0}
        if not np.array_equal(graph, eager):
            fail(f"warm-up plane ({key}): bucket {bucket}'s graph replay "
                 f"differs from the eager forward by up to "
                 f"{np.abs(graph - eager).max()}")
        if per_replay != want or per_eager != want:
            fail(f"warm-up plane ({key}): bucket {bucket} launched "
                 f"{per_replay} per replay and {per_eager} eager, not {want}")
        g = engine._graphs[(bucket.batch, bucket.seq)]
        tally = {k: g.tally.get(k, 0) for k in KERNELS}
        for _ in range(REPLAY_TRACES):
            on_device = _traced_replay_launches(torch, g.graph)
            if on_device is None:
                fail(f"warm-up plane ({key}): no trace of bucket {bucket}'s "
                     f"replays held device events; its launches are not "
                     f"measured")
            if on_device == tally == want:
                break
            say(f"warm-up plane ({key}): a trace of bucket {bucket}'s "
                f"replays showed {on_device} per replay")
        if on_device != tally or on_device != want:
            fail(f"warm-up plane ({key}): bucket {bucket}'s traced replay "
                 f"launched {on_device} on the device; its capture's tally "
                 f"is {tally}, a forward launches {want}")
        traced[str(bucket)] = {k: n for k, n in on_device.items() if n}
    say(f"warm-up plane ({key}): {len(engine.grid)} buckets' graph replays "
        f"equal to the eager forward on real batches (np.array_equal), "
        f"{want} launched per replay as per eager batch; device events per "
        f"replay in a trace of {REPLAYS_TRACED} replays each: {traced}")
    ids = _full_batch_ids(burst.tokenizer, burst.requests, burst.params)
    wire = engine._wire_pack({"input_ids": ids})
    g = engine._graphs[(32, 384)]
    with torch.inference_mode():
        out = dict(
            eager_issue_ms=_host_ms(torch, lambda: engine._score(wire)),
            graph_issue_ms=_host_ms(torch, g.graph.replay),
            eager_device_ms=time_ms(torch, lambda: engine._score(wire)),
            graph_device_ms=time_ms(torch, g.graph.replay),
            eager_batch_ms=_host_ms(
                torch, lambda: engine.run_packed({"input_ids": ids}), 10),
            graph_batch_ms=_host_ms(
                torch, lambda: engine._dispatch(32, 384, {"input_ids": ids}),
                10))
    out["eager_idle"] = profile_forward(torch, lambda: engine._score(wire),
                                        f"warm-up plane ({key} eager)")
    out["graph_idle"] = profile_forward(torch, g.graph.replay,
                                        f"warm-up plane ({key} graph replay)")
    say(f"warm-up plane ({key}), one 32x384 batch: host ms to issue it "
        f"eager {out['eager_issue_ms']:.3f}, graph replay "
        f"{out['graph_issue_ms']:.3f}; device ms eager "
        f"{out['eager_device_ms']:.3f}, graph {out['graph_device_ms']:.3f}; "
        f"host ms per whole batch (copy in, run, rows out) eager "
        f"{out['eager_batch_ms']:.3f}, graph {out['graph_batch_ms']:.3f}; "
        f"device idle eager {not_measured(out['eager_idle'])}, graph "
        f"{not_measured(out['graph_idle'])}")
    return out


def _warm_records(name: str, proc, log: Path, deadline: float) -> dict:
    _join({name: (proc, log)}, deadline, "warm-up plane")
    rec = json.loads((WARM_DIR / f"{name}.json").read_text())
    say(f"warm-up plane: {name} engine process ({rec['seconds']:.1f}s): "
        f"store {rec['aot']['cache']} hits {rec['aot']['hits']} misses "
        f"{rec['aot']['misses']}, nvcc runs {rec['builds']['misses']}, "
        f"libraries {rec['libraries']}; engines "
        + "; ".join(f"{e['flags']}: {e['dispatch']} dispatch, warmup "
                    f"{e['warmup_seconds']}s, {e['store']}"
                    for e in rec["engines"]))
    if any(e["dispatch"] != "graph" for e in rec["engines"]):
        fail(f"warm-up plane: a {name} engine did not dispatch through its "
             f"buckets' graphs")
    return rec


def _warmup_training(torch) -> dict:
    """``config/test_bert.cfg --dummy_dataset --debug`` with the card's
    memory stood in by a limit of 3/4 of the need phase 4 measured at
    batch_split 8 (its largest bucket): the split is raised and the steps
    run. Returns the run's launch counts."""
    from ml_recipe_tpu_torch.utils import hbm

    cfg, _, base = next(r for r in PREFLIGHT_REPORTS
                        if r[0] == "test_bert.cfg" and r[1] == ())
    say(f"warm-up plane: phase 4's pre-flight at the card's own limit "
        f"({base['limit_bytes']} B): batch_split {base['batch_split_before']}"
        f" -> {base['batch_split']}, applied {base['applied']}; need by "
        f"bucket {base['buckets']}")
    if base["applied"] or base["batch_split"] != 8 or not base["buckets"]:
        fail("warm-up plane: at the card's own limit the pre-flight changed "
             "test_bert.cfg's plan")
    # a quarter below: the need moves by a few MB from run to run
    need = max(b["bytes"] for b in base["buckets"])
    limit = need * 3 // 4
    real = hbm.device_hbm_bytes
    hbm.device_hbm_bytes = lambda device=None: limit
    try:
        trainer, params, launched, wall = _run_training(
            torch, "test_bert.cfg", ["--dummy_dataset", "--debug"])
    finally:
        hbm.device_hbm_bytes = real
    report = trainer.preflight_report
    layers = trainer.model.cfg.num_layers
    micro = len(trainer.history) * trainer.batch_split
    evals = trainer.eval_batches
    want = {"fused_attention_fwd": layers * (micro + evals),
            "fused_attention_bwd": layers * micro}
    say(f"warm-up plane: training under a limit of {limit} B (3/4 of "
        f"phase 4's need): batch_split {report['batch_split_before']} -> "
        f"{report['batch_split']} (applied {report['applied']}), need by "
        f"bucket {report['buckets']}; {len(trainer.history)} steps of "
        f"{trainer.batch_split} micro-batches in {wall:.1f}s, losses "
        f"{[round(h['loss'], 4) for h in trainer.history]}; launch counts "
        f"{launched}, expected {want}")
    if not report["applied"] or trainer.batch_split <= 8 or \
            report["batch_split"] != trainer.batch_split:
        fail("warm-up plane: the reduced limit did not raise batch_split")
    if len(trainer.history) != 2 or any(
            launched[k] != n for k, n in want.items()) or not all(
            np.isfinite(h["loss"]) for h in trainer.history):
        fail("warm-up plane: the raised split's steps did not run as "
             "configured")
    del trainer
    torch.cuda.empty_cache()
    return launched


def phase_warmup_plane(torch) -> dict:
    """Phase 17, the warm-up plane, on a fresh temporary library store and
    tuning cache. Returns each of its paths' launch counts."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(WARM_DIR, ignore_errors=True)
    WARM_DIR.mkdir(parents=True)
    store, tuning = WARM_DIR / "aot", WARM_DIR / "tuning"
    planes = ("--autotune_cache", str(tuning))
    deadline = time.monotonic() + WARM_DEADLINE_S
    paths = {}

    # 1. a cold engine process builds into the empty store; the training
    # pre-flight runs meanwhile
    spawn = ["--warm-engines", store, tuning]
    procs = []
    try:
        return _warmup_plane(torch, spawn, procs, store, planes, deadline,
                             paths, t_phase)
    finally:
        for proc in procs:         # none outlives the phase, failed or not
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _warmup_plane(torch, spawn, procs, store, planes, deadline, paths,
                  t_phase) -> dict:
    cold = _spawn([*spawn, WARM_DIR / "cold.json"], WARM_DIR / "cold.log")
    procs.append(cold)
    paths["training pre-flight"] = _warmup_training(torch)
    cold_rec = _warm_records("cold", cold, WARM_DIR / "cold.log", deadline)
    built = cold_rec["builds"]["misses"]
    if not built or cold_rec["aot"]["misses"] != built or \
            cold_rec["aot"]["hits"] or cold_rec["builds"]["hits"]:
        fail("warm-up plane: the cold engines' store misses are not the "
             "libraries they built")

    # 2. a warm engine process on the same store builds nothing; the grid
    # pre-flight runs meanwhile
    warm = _spawn([*spawn, WARM_DIR / "warm.json"], WARM_DIR / "warm.log")
    procs.append(warm)
    needs = {b: v["bytes"] for b, v in BURSTS["bf16"].warm["preflight"].items()}
    limit = (needs["8x384"] + needs["32x384"]) // 2
    grid = _serve_burst(torch, dispatch="graph", planes=planes,
                        limit_bytes=limit, tag="reduced limit")
    say(f"warm-up plane: grid pre-flight needs {needs} B (phase 3, measured "
        f"at the card's limit); at a limit of {limit} B the grid drops "
        f"{grid.warm['dropped']} and keeps {grid.warm['buckets']}; 384-token "
        f"batches {[r for s, r in grid.seen if s == 384]}")
    if grid.warm["dropped"] != ["32x384"] or \
            grid.warm["buckets"] != ["8x128", "8x384"]:
        fail("warm-up plane: the reduced limit did not drop 32x384 alone")
    paths["grid pre-flight"] = grid.counts
    del grid
    torch.cuda.empty_cache()
    warm_rec = _warm_records("warm", warm, WARM_DIR / "warm.log", deadline)
    n_libs = len([o for o in cold_rec["libraries"].values() if o])
    if warm_rec["aot"]["misses"] or warm_rec["builds"]["misses"] or \
            warm_rec["aot"]["hits"] != n_libs or any(
            e["store"]["qa_aot_cache_misses_total"] for e in warm_rec["engines"]):
        fail(f"warm-up plane: the warm engines missed the store or built a "
             f"library (hits {warm_rec['aot']['hits']} of {n_libs})")
    tool = [sys.executable, "-m", "ml_recipe_tpu_torch.ops.aot",
            "--cache_dir", str(store)]
    listing = subprocess.run([*tool, "--list"], capture_output=True,
                             text=True, timeout=60, cwd=str(REPO))
    verify = subprocess.run([*tool, "--verify"], capture_output=True,
                            text=True, timeout=60, cwd=str(REPO))
    say("warm-up plane: python -m ml_recipe_tpu_torch.ops.aot --list: "
        + " | ".join(listing.stdout.strip().splitlines()))
    say(f"warm-up plane: --verify exit {verify.returncode}: "
        + " | ".join(verify.stdout.strip().splitlines()[-1:]))
    if verify.returncode != 0 or listing.returncode != 0:
        fail("warm-up plane: the store's tool failed on the warm store")

    # 3. phase 3's and phase 8's bursts with graphs, then eager and graph
    # bursts back to back on the same engine, and every bucket's replay
    # against the eager forward
    figures = {}
    for key, extra, eager_label in (
            ("bf16", (), "bf16"),
            ("int8", INT8_FLAGS, " ".join(INT8_FLAGS))):
        burst = _serve_burst(torch, extra, dispatch="graph", planes=planes,
                             rounds=BACK_TO_BACK)
        db = burst.device_batches
        want = {k: PER_BATCH[key].get(k, 0) * db for k in KERNELS}
        if burst.counts != want:
            fail(f"warm-up plane ({key}): the graph burst launched "
                 f"{burst.counts}, not {want} ({db} device batches)")
        if burst.warm["dispatch"] != "graph" or set(burst.warm["graphs"]) != {
                "8x128", "8x384", "32x384"}:
            fail(f"warm-up plane ({key}): not every bucket has its graph")
        paths[f"serving {key}, graphs"] = burst.counts
        figures[key] = _graphs_against_eager(torch, key, burst)
        rounds = burst.by_mode
        figures[key].update(
            eager_p50_ms=statistics.median(rounds["eager"]["latency_ms"]),
            graph_p50_ms=statistics.median(rounds["graph"]["latency_ms"]),
            eager_traffic_batch_ms=statistics.median(
                rounds["eager"]["batch_ms"]),
            graph_traffic_batch_ms=statistics.median(
                rounds["graph"]["batch_ms"]))
        say(f"warm-up plane ({key}): bursts back to back on one engine "
            f"({', '.join(BACK_TO_BACK)}, {len(burst.requests)} requests "
            f"each): request latency p50 eager "
            f"{figures[key]['eager_p50_ms']:.1f} ms, graphs "
            f"{figures[key]['graph_p50_ms']:.1f} ms; traffic batches' host ms "
            f"eager {rounds['eager']['batch_ms']}, graphs "
            f"{rounds['graph']['batch_ms']}; the first burst (graphs, the "
            f"counted main path) p50 {statistics.median(burst.latency_ms):.1f}"
            f" ms, phase {3 if key == 'bf16' else 8}'s eager burst p50 "
            f"{BURSTS[eager_label].p50:.1f} ms (a fresh engine's first burst:"
            f" not comparable)")
        del burst
        torch.cuda.empty_cache()
    say(f"warm-up plane: {json.dumps(figures)}")
    say(f"warm-up plane phase: {time.perf_counter() - t_phase:.1f}s")
    return paths


# -- phase 18: the elastic pod and bucketed ZeRO-1 ---------------------------------

EL_DIR = OUT_DIR / "elastic"
EL_DEADLINE_S = 300
EL_WORLD = 2
EL_HOST_TIMEOUT = 10.0
EL_COORD_POLL = 0.5
# tests/test_torch_zero1.py's pins (the JAX package's): step losses
# relative, final parameters absolute
ZERO1_RTOL, ZERO1_PARAMS_ATOL = 2e-5, 5e-5
# phase 18a's runs, one after another in each of two rank processes:
# test_bert.cfg's 2 debug steps on data:2 (128 of every 256 rows a rank, 4
# micro-batches of 32x512), with ZeRO-1 and its exchange off or bucketed,
# and without ZeRO-1
DRILL_KERNELS = ("fused_attention_fwd", "fused_attention_bwd",
                 "layer_norm_fwd", "layer_norm_bwd")
# encoder layers of 18a's runs (the widths kept)
EL_PAIR_LAYERS = 4
EL_PAIRS = {
    "off": ["--optimizer_sharding", "zero1", "--zero1_overlap", "off"],
    "bucketed": ["--optimizer_sharding", "zero1", "--zero1_overlap",
                 "bucketed"],
    "replicated": ["--optimizer_sharding", "off"],
}


def _el_world_flags(rank: int, port: int):
    return ["--mesh", f"data:{EL_WORLD}", "--dist_world_size", EL_WORLD,
            "--local_rank", rank, "--dist_init_method",
            f"tcp://127.0.0.1:{port}"]


def el_worker(rank: int, port: int) -> int:
    """One rank of phase 18a: the EL_PAIRS runs one after another in this
    process, each through ``cli.train``'s parse, ``build_trainer`` and
    ``train`` on card 0 over gloo (NCCL refuses two ranks on one device),
    with the launch counts set to 0 just before ``train`` and read just
    after, cuBLAS's deterministic workspace and deterministic algorithms
    (the runs compare bit for bit). Writes each run's record (steps,
    launches less the pre-flight probes', optimizer bytes, bucket count,
    the digest of its parameters) to ``EL_DIR/rank<r>.json``; rank 0 also
    writes what the runs' parameter updates (final minus built) say of
    each other: off against replicated bit for bit, bucketed against off
    largest difference."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.parallel import dist as pdist
    from ml_recipe_tpu_torch.parallel.sharding import opt_state_bytes_per_chip

    torch.use_deterministic_algorithms(True, warn_only=True)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _register_kernels()
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=EL_WORLD,
        rank=rank, backend="gloo", device=torch.device("cuda", 0))
    flat = lambda model: torch.cat([p.detach().float().reshape(-1).cpu()
                                    for p in model.parameters()])
    records, updates = {}, {}
    try:
        for kind, flags in EL_PAIRS.items():
            _, (params, model_params) = get_params(
                (get_trainer_parser, get_model_parser),
                [*RT_CMD[2:], "--vocab_file", str(OUT_DIR / "vocab.txt"),
                 "--dump_dir", str(EL_DIR / kind / "results"),
                 *map(str, _el_world_flags(rank, port)), *flags])
            params.n_jobs = max(1, min(params.n_jobs,
                                       (os.cpu_count() or 2) // 4))
            t0 = time.perf_counter()
            with _shallow(EL_PAIR_LAYERS):
                trainer = train_cli.build_trainer(params, model_params)
            start = flat(trainer.model)
            probe = _count_probes(trainer)
            zero_counts()               # the main path starts here
            train_cli.train(trainer, params)
            torch.cuda.synchronize()
            launched = counts()         # the main path ends here
            updates[kind] = flat(trainer.model) - start
            records[kind] = {
                "launched": _without_probes(trainer, launched, probe),
                "steps": [{k: h[k] for k in ("loss", "lr", "seconds")}
                          for h in trainer.history],
                "opt_bytes": opt_state_bytes_per_chip(trainer.optimizer),
                "buckets": trainer.zero1_bucket_count,
                "digest": _param_digest(trainer.model),
                "wall": time.perf_counter() - t0}
            del trainer
            torch.cuda.empty_cache()
        if rank == 0:
            records["compared"] = {
                "off_equals_replicated": bool(torch.equal(
                    updates["off"], updates["replicated"])),
                "bucketed_params_diff": float(
                    (updates["bucketed"] - updates["off"]).abs().max())}
        (EL_DIR / f"rank{rank}.json").write_text(json.dumps(records))
    finally:
        pdist.shutdown()
    return 0


def _children_of(pid: int):
    try:
        text = Path(f"/proc/{pid}/task/{pid}/children").read_text()
    except OSError:
        return []
    return [int(p) for p in text.split()]


def _gone(pid: int) -> bool:
    """The process ``pid`` has exited (a zombie, or reaped)."""
    try:
        return Path(f"/proc/{pid}/stat").read_text().split(") ")[1][0] == "Z"
    except (OSError, IndexError):
        return True


def _el_drill(torch, vocab: Path) -> dict:
    """Phase 18b: the elastic drill (see :func:`phase_elastic`)."""
    import shutil

    from ml_recipe_tpu_torch.metrics.flightrec import FLIGHTREC_PREFIX
    from ml_recipe_tpu_torch.metrics.goodput import (
        read_ledger, summarize_events)
    from ml_recipe_tpu_torch.parallel.dist import TIMEOUT_S

    run = EL_DIR / "drill"
    shutil.rmtree(run, ignore_errors=True)
    exp = run / "results" / "test"
    cfg = _rt_resume_cfg()
    cmd = ["-m", "ml_recipe_tpu_torch.cli.train", "-c", cfg,
           "--dummy_dataset", "--seed", "0", "--ln_impl", "fused",
           "--vocab_file", vocab]
    port = _free_port()
    sups = []
    for host in range(EL_WORLD):
        env = _rt_env(run / f"host{host}", RT_DUMMY_LEN, "last.ch")
        env["SMOKE_GLOO"] = "1"
        log = run / f"host{host}.log"
        sups.append((_rt_launch(cmd, [
            "--dump_dir", run / "results", *_el_world_flags(host, port),
            "--optimizer_sharding", "zero1", "--zero1_overlap", "bucketed",
            "--supervise", "--elastic", "on", "--host_timeout",
            EL_HOST_TIMEOUT, "--coord_poll", EL_COORD_POLL,
            "--backoff_base", "0.5", "--goodput_ledger", "--flight_recorder",
            "--watchdog_timeout", "600", "--fault_plan",
            f"trainer.step:kill@{RT_RESUME_STEP + 1}%host1"], env, log), log))
    deadline = time.monotonic() + EL_DEADLINE_S
    (sup0, log0), (sup1, log1) = sups
    # host 1 dies with its child: its supervisor is killed as soon as the
    # child is gone (a dead host is silent); host 0's first child is
    # watched too, to copy the checkpoint it leaves before attempt 2 runs
    watched = {0: None, 1: None}
    t_kill = ref = None
    copy = run / "epoch_1_copy.ch"
    while time.monotonic() < deadline:
        for host, (proc, _) in enumerate(sups):
            kids = _children_of(proc.pid)
            if watched[host] is None and kids:
                watched[host] = kids[0]
        if t_kill is None and watched[1] is not None and _gone(watched[1]):
            sup1.kill()
            t_kill = time.time()
        if (ref is None and watched[0] is not None and _gone(watched[0])):
            if not (exp / "last.ch").exists():
                fail("elastic phase: host 0's first attempt left no "
                     "last.ch")
            shutil.copyfile(exp / "last.ch", copy)
            # the same resume by hand in one process, beside attempt 2
            ref = _rt_launch(cmd, [
                "--dump_dir", run / "reference", "--last", copy,
                "--mesh", "data:1", "--optimizer_sharding", "zero1"],
                _rt_env(run / "ref", RT_DUMMY_LEN, "none"),
                run / "reference.log")
        if t_kill is not None and ref is not None:
            break
        if sup0.poll() is not None or (t_kill is None
                                       and sup1.poll() is not None):
            fail(f"elastic phase: a supervisor ended before the drill's "
                 f"kill; host 0's log ends {log0.read_text()[-3000:]}; "
                 f"host 1's ends {log1.read_text()[-3000:]}")
        time.sleep(0.005)
    if t_kill is None or ref is None:
        fail("elastic phase: the drill's host 1 never died")
    sup1.wait()
    rc = _rt_wait(sup0, log0, "elastic host 0")
    ref_rc = _rt_wait(ref, run / "reference.log", "elastic reference")
    log = log0.read_text()
    if rc != 0 or ref_rc != 0:
        fail(f"elastic phase: host 0's supervisor exited {rc}, the "
             f"reference {ref_rc}; host 0's log ends {log[-3000:]}")
    sidecar = json.loads((exp / "supervisor_state.json").read_text())
    events = read_ledger(exp / "goodput.jsonl")
    summary = summarize_events(events)
    starts = [e for e in events if e["ev"] == "attempt_start"]
    ends = [e for e in events if e["ev"] == "attempt_end"]
    lost = [e for e in events if e["ev"] == "host_lost"]
    kinds = set()
    for path in exp.glob(f"{FLIGHTREC_PREFIX}*.json"):
        kinds.update(e["kind"] for e in json.loads(path.read_text())[
            "events"])
    worlds = re.findall(r"launching attempt \d+ generation \d+ as rank "
                        r"(\d+)/(\d+)", log)
    relaunch = starts[-1]["t"] - t_kill
    say(f"elastic: host 0's supervisor rc {rc}, outcomes "
        f"{sidecar['outcomes']}, attempts' (rank, world) {worlds}, resumed "
        f"from steps {[e['resume_step'] for e in starts]}; host_lost "
        f"{[(e['lost'], e['why']) for e in lost]}; flight recorder "
        f"{sorted(kinds)}; hosts_lost {summary['hosts_lost']}")
    if ("host-lost" not in sidecar["outcomes"]
            or sidecar["status"] != "clean"
            or worlds[-1] != ("0", "1")
            or starts[-1]["resume_step"] != RT_RESUME_STEP):
        fail("elastic phase: host 0 did not end clean on the world of one, "
             "resumed from epoch 1's checkpoint, after losing host 1")
    if summary["hosts_lost"] != 1 or not {"host_lost",
                                          "mesh_shrunk"} <= kinds:
        fail("elastic phase: the ledger or the flight recorder lacks the "
             "lost host or the shrunk mesh")
    detect = lost[0]["t"] - t_kill
    gap = starts[-1]["t"] - ends[-2]["t"] if len(ends) > 1 else float("nan")
    say(f"elastic: host 1 killed; declared lost after {detect:.3f}s "
        f"(--host_timeout {EL_HOST_TIMEOUT:g}, --coord_poll "
        f"{EL_COORD_POLL:g}), relaunched on the world of one "
        f"{relaunch:.3f}s after the kill (restart gap {gap:.3f}s from "
        f"attempt {len(ends) - 1}'s end; the collectives' timeout is "
        f"{TIMEOUT_S:g}s); goodput ratio {summary['goodput_ratio']:.4f}, "
        f"badput " + ", ".join(f"{k} {v:.2f}s"
                              for k, v in summary["badput_s"].items()))
    if not relaunch < min(3 * EL_HOST_TIMEOUT, TIMEOUT_S / 10):
        fail("elastic phase: the relaunch came too late after the kill")
    attempts = _rt_records(run / "host0" / "observed")
    (reference,) = _rt_records(run / "ref" / "observed")
    first, resumed = attempts[0], attempts[-1]
    for name, rec in (("attempt 1", first), ("the last attempt", resumed)):
        if min(rec.record["launches"].values()) < 1:
            fail(f"elastic phase: host 0's {name} launched no kernel of "
                 f"{rec.record['launches']}")
    last = lambda r: r.record["history"][-1]["loss"]
    update_rel = _rel(resumed.update, reference.update)
    loss_rel = abs(last(resumed) - last(reference)) / abs(last(reference))
    walls = {k: [round(h["seconds"], 4) for h in r.record["history"]]
             for k, r in (("data:2", first), ("data:1", resumed),
                          ("reference", reference))}
    say(f"elastic: the resumed run against the same resume by hand in one "
        f"process: parameter update relative L2 {update_rel:.2e} (bit for "
        f"bit: {torch.equal(resumed.update, reference.update)}; tol "
        f"{RT_UPDATE_REL_TOL:g}), last loss {last(resumed):.6f} against "
        f"{last(reference):.6f} (relative {loss_rel:.2e}, tol "
        f"{RT_LOSS_REL_TOL:g}); step walls, s: "
        + ", ".join(f"{k} {v}" for k, v in walls.items())
        + f"; ZeRO-1 moments a rank {first.record['opt_bytes']} B on "
        f"{first.record['mesh']} in {first.record['zero1_buckets']} "
        f"buckets, {resumed.record['opt_bytes']} B on "
        f"{resumed.record['mesh']} ({resumed.record['zero1_buckets']} "
        f"buckets: inert); launches attempt 1 {first.record['launches']}, "
        f"last attempt {resumed.record['launches']}")
    if not (update_rel <= RT_UPDATE_REL_TOL and loss_rel <= RT_LOSS_REL_TOL):
        fail("elastic phase: the elastic resume does not reproduce the same "
             "resume by hand")
    if resumed.record["mesh"] != {"data": 1} or first.record["mesh"] != {
            "data": 2}:
        fail("elastic phase: the attempts did not run data:2, then data:1")
    shutil.rmtree(run / "results", ignore_errors=True)
    shutil.rmtree(run / "reference", ignore_errors=True)
    copy.unlink()
    return {"detect_s": detect, "relaunch_s": relaunch, "gap_s": gap,
            "first": first, "resumed": resumed, "reference": reference,
            "outcomes": sidecar["outcomes"]}


def phase_elastic(torch):
    """Phase 18: elastic pod supervision and the bucketed ZeRO-1 exchange.

    18a. ``config/test_bert.cfg --dummy_dataset --debug --seed 0 --ln_impl
    fused`` on ``--mesh data:2``: the script starts itself again as two
    ranks (``--el-worker``, gloo on the card), each running three runs one
    after another (EL_PAIRS, :func:`el_worker`): ZeRO-1 with
    ``--zero1_overlap off``, with ``bucketed`` and without ZeRO-1. Off must
    equal the replicated pair bit for bit (the invariant phase 15 holds on
    long_context.cfg, here on the test_bert run: the exchange that was
    there before bucketing), bucketed must hold its step losses within
    ZERO1_RTOL and its parameters within ZERO1_PARAMS_ATOL of off, each
    pair's ranks equal. The bucket count and each run's step walls are
    printed. The pair runs beside 18b (its walls are taken beside the
    drill's processes).

    18b. The elastic drill on phase 16's resume copy of test_bert.cfg (2
    epochs of 2 steps of 256, RT_DUMMY_LEN items, each epoch ending in
    ``last.ch``; the observer writes no other checkpoint): two supervisor
    processes, hosts 0 and 1, ``--supervise --elastic on --host_timeout
    EL_HOST_TIMEOUT --coord_poll EL_COORD_POLL --goodput_ledger
    --flight_recorder`` on ``--mesh data:2 --optimizer_sharding zero1
    --zero1_overlap bucketed`` with ``--fault_plan 'trainer.step:kill@3%
    host1'``. The phase kills host 1's supervisor (SIGKILL) as soon as its
    child is gone. Host 0's supervisor must end rc 0 with ``host-lost``
    among its outcomes, its last attempt as rank 0 of 1 resuming step
    RT_RESUME_STEP, less than 3 x EL_HOST_TIMEOUT (and far less than the
    collectives' timeout) from the kill to the relaunch; the ledger's
    ``hosts_lost`` 1, the flight recorder's ``host_lost`` and
    ``mesh_shrunk``; the resumed run's parameter update and last loss
    within RT_UPDATE_REL_TOL / RT_LOSS_REL_TOL of the same checkpoint
    resumed by hand in one process at ``--mesh data:1`` (started beside
    attempt 2); both attempts launching the attention and LayerNorm
    kernels. Detection and relaunch seconds, step walls before and after
    the shrink and the ZeRO-1 moments' bytes a rank are printed.

    Returns the runs' launch counts by path."""
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    t_phase = time.perf_counter()
    EL_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    port = _free_port()
    # 18a's pair runs beside the drill: the drill's card and host are idle
    # through its supervisors' waits and its checkpoint writes
    pair = {f"18a rank {r}": (
        _spawn(["--el-worker", r, port], EL_DIR / f"rank{r}.log"),
        EL_DIR / f"rank{r}.log") for r in range(EL_WORLD)}
    drill = _el_drill(torch, vocab)
    _join(pair, time.monotonic() + EL_DEADLINE_S, "elastic phase (a)")
    ranks = [json.loads((EL_DIR / f"rank{r}.json").read_text())
             for r in range(EL_WORLD)]
    pairs, compared = ranks[0], ranks[0]["compared"]
    for kind in EL_PAIRS:
        if len({r[kind]["digest"] for r in ranks}) != 1 or len(
                {tuple(h["loss"] for h in r[kind]["steps"])
                 for r in ranks}) != 1:
            fail(f"elastic phase: the {kind} pair's ranks parted")
        if min(pairs[kind]["launched"][k] for k in DRILL_KERNELS) < 1:
            fail(f"elastic phase: the {kind} pair missed a kernel of "
                 f"{pairs[kind]['launched']}")
    off, bucketed = pairs["off"], pairs["bucketed"]
    losses = {k: [h["loss"] for h in pairs[k]["steps"]] for k in EL_PAIRS}
    params_diff = compared["bucketed_params_diff"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
        losses["bucketed"], losses["off"]))
    same = compared["off_equals_replicated"]
    say(f"elastic (a): {bucketed['buckets']} gradient buckets of ~4 MB "
        f"(off: {off['buckets']}); step losses "
        + ", ".join(f"{k} {v}" for k, v in losses.items())
        + f"; bucketed against off: losses relative {loss_rel:.2e} (tol "
        f"{ZERO1_RTOL:g}), parameters max |diff| {params_diff:.2e} (tol "
        f"{ZERO1_PARAMS_ATOL:g}); off equal to replicated bit for bit: "
        f"{same}; step walls, s: "
        + ", ".join(f"{k} {[round(h['seconds'], 4) for h in pairs[k]['steps']]}"
                    for k in EL_PAIRS)
        + "; each run's build and train, s: "
        + ", ".join(f"{k} {pairs[k]['wall']:.1f}" for k in EL_PAIRS)
        + "; optimizer bytes a rank: "
        + ", ".join(f"{k} {pairs[k]['opt_bytes']}" for k in EL_PAIRS))
    if bucketed["buckets"] < 2 or off["buckets"]:
        fail("elastic phase: the bucket counts are not the exchanges asked")
    if not same:
        fail("elastic phase: ZeRO-1 with --zero1_overlap off no longer "
             "equals the replicated step")
    if not (loss_rel <= ZERO1_RTOL and params_diff <= ZERO1_PARAMS_ATOL):
        fail("elastic phase: the bucketed exchange parts from off")
    say(f"elastic phase: {time.perf_counter() - t_phase:.1f}s")
    return {**{f"elastic (a) {k}": {
                kernel: sum(r[k]["launched"][kernel] for r in ranks)
                for kernel in DRILL_KERNELS} for k in EL_PAIRS},
            "elastic (b) attempt 1, host 0": drill["first"].record["launches"],
            "elastic (b) last attempt, host 0":
                drill["resumed"].record["launches"],
            "elastic (b) reference": drill["reference"].record["launches"],
            "drill": drill}


# -- phase 19: pipeline parallelism ------------------------------------------------

PP_DIR = OUT_DIR / "pipe"
PP_DEADLINE_S = 600
# test_bert.cfg at full width (bert-base, 2 debug steps of 256x512 in 8
# micro-batches of 32x512), the fused LayerNorm, dropout 0: the schedules
# and the one-process run compute the same function. The two dropout
# values are written with "=": get_params reads a value token that two
# flags share as an argument no parser takes
PP_BASE = ["-c", str(REPO / "config" / "test_bert.cfg"), "--seed", "0",
           "--ln_impl", "fused", "--hidden_dropout_prob=0",
           "--attention_probs_dropout_prob=0"]
# phase 19's runs: (ranks, flags). 19a: pipe:2 on GPipe and on 1F1B; 19b:
# data:2,pipe:2 with ZeRO-1 for one debug step, then a sharded save
PP_RUNS = {"gpipe": (2, ["--mesh", "pipe:2"]),
           "1f1b": (2, ["--mesh", "pipe:2", "--pipe_schedule", "1f1b"]),
           "zero1": (4, ["--mesh", "data:2,pipe:2", "--optimizer_sharding",
                         "zero1", "--sharded_checkpoint"])}
# the worlds the runs take, one after another in each: 19a's two schedules
# share one pair of processes
PP_WORLDS = {"schedules": ("gpipe", "1f1b"), "zero1": ("zero1",)}
# encoder layers of phase 19's runs (the widths kept): a stage's hand-offs
# do not depend on the depth
PP_LAYERS = 4
# LayerNorms a forward runs on stage 0 (with the embeddings') and 1
PP_STAGE_LN = (PP_LAYERS + 1, PP_LAYERS)
# GPipe against 1F1B: both run the backwards in micro-batch order, so the
# steps agree bit for bit under deterministic cuBLAS; the gate allows the
# f32 rounding of a changed summation order and no more
PP_SCHEDULE_TOL = 1e-6
# pipe:2 against one process: the same kernels on the same micro-batches;
# the clip's norm sums the stages' squares (another order than one
# process's norm of norms), and Adam carries that rounding into the update
PP_LOSS_REL_TOL = RT_LOSS_REL_TOL
PP_UPDATE_REL_TOL = RT_UPDATE_REL_TOL


def pp_worker(world_kind: str, rank: int, port: int) -> int:
    """One rank of phase 19's world ``world_kind`` (PP_WORLDS): joins it on
    card 0 over gloo, with cuBLAS's deterministic workspace, and runs its
    runs one after another (:func:`_pp_run_one`)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import gc

    import torch

    from ml_recipe_tpu_torch.parallel import dist as pdist

    torch.use_deterministic_algorithms(True, warn_only=True)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _register_kernels()
    world = PP_RUNS[PP_WORLDS[world_kind][0]][0]
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=torch.device("cuda", 0))
    try:
        for kind in PP_WORLDS[world_kind]:
            _pp_run_one(torch, kind, rank, port)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        pdist.shutdown()
    return 0


def _pp_run_one(torch, kind: str, rank: int, port: int) -> None:
    """One rank of phase 19's ``kind`` run (PP_RUNS) through ``cli.train``'s
    parse, ``build_trainer`` and ``train``, counts set to 0 just before
    ``train`` and read just after (less the pre-flight's probes). Each
    step's wall and stage-transport seconds are kept (the stage's wait
    share is its measured bubble). Writes ``PP_DIR/<kind>/rank<r>.json``
    and the parameters it stores (``params<r>.pt``, f32, with those it was
    built with); ``zero1`` runs one step and then writes its sharded
    checkpoint, and records each parameter's digest."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.parallel import pipeline
    from ml_recipe_tpu_torch.parallel.sharding import opt_state_bytes_per_chip

    world, flags = PP_RUNS[kind]
    out = PP_DIR / kind
    out.mkdir(parents=True, exist_ok=True)
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [*PP_BASE, *flags, "--vocab_file", str(OUT_DIR / "vocab.txt"),
         "--dump_dir", str(out / "results"), "--dist_world_size",
         str(world), "--local_rank", str(rank), "--dist_init_method",
         f"tcp://127.0.0.1:{port}"])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2)
                               // (2 * world)))
    with _shallow(PP_LAYERS):
        trainer = train_cli.build_trainer(params, model_params)
    if kind == "zero1":
        trainer.n_epochs = 1
    lay, stage = trainer.pipe, trainer.mesh.stage
    tokenizer = trainer.collate_fun.keywords["tokenizer"]
    built = {n: p.detach().cpu().clone()
             for n, p in trainer.model.named_parameters()
             if p.device.type != "meta"}
    per_step = []
    step = trainer.train_step

    def timed(inputs, labels):
        torch.cuda.synchronize()
        t0, s0 = time.perf_counter(), stage.stats["seconds"]
        values = step(inputs, labels)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0,
                         stage.stats["seconds"] - s0))
        return values

    trainer.train_step = timed
    probe = _count_probes(trainer)
    stage.reset()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()               # the main path starts here
    t0 = time.perf_counter()
    train_cli.train(trainer, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()         # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    launched = {k: n - probe[k] for k, n in launched.items()}
    stored = {n: p.detach().cpu() for n, p in
              trainer.model.named_parameters() if p.device.type != "meta"}
    record = {
        "launched": launched, "probe_launches": probe,
        "preflight_probes": trainer.preflight_probes, "wall": wall,
        "stage": lay.index, "layers": [lay.lo, lay.hi],
        "layout": lay.layout, "schedule": trainer.pipe_schedule,
        "mesh": trainer.plan.describe(),
        "data_index": trainer.mesh.data_index,
        "batch_split": trainer.batch_split,
        "steps": [{k: h[k] for k in ("loss", "lr", "seconds", "rows")}
                  for h in trainer.history],
        "step_transport_s": [s for _, s in per_step],
        "step_walls": [w for w, _ in per_step],
        "transport": dict(stage.stats),
        "in_flight": trainer.pipe_runner.in_flight,
        "modeled_bubble": pipeline.modeled_bubble_fraction(
            lay.K, trainer.batch_split, trainer.pipe_schedule),
        "peak_bytes": peak,
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in stored.values()),
        "opt_bytes": opt_state_bytes_per_chip(trainer.optimizer),
        "eval_batches": trainer.eval_batches,
        "tokenizer": tokenizer.backend,
        "device": str(trainer.device),
    }
    if kind == "zero1":
        trainer.debug = False
        t0 = time.perf_counter()
        trainer.save_state_dict(out / "ckpt")
        record["save_seconds"] = time.perf_counter() - t0
        record["digests"] = {n: _tensor_digest(p) for n, p in stored.items()}
    elif trainer.mesh.data_index == 0:
        torch.save({"built": built, "final": stored}, out / f"params{rank}.pt")
    (out / f"rank{rank}.json").write_text(json.dumps(record))


def _tensor_digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


def _pp_world(world_kind: str) -> dict:
    """Phase 19's ranks of ``world_kind`` (PP_WORLDS), started."""
    world = PP_RUNS[PP_WORLDS[world_kind][0]][0]
    port = _free_port()
    return {f"{world_kind} rank {r}": (
        _spawn(["--pp-worker", world_kind, r, port],
               PP_DIR / f"{world_kind}{r}.log"),
        PP_DIR / f"{world_kind}{r}.log") for r in range(world)}


def _pp_records(kind: str) -> list:
    world, _ = PP_RUNS[kind]
    return [json.loads((PP_DIR / kind / f"rank{r}.json").read_text())
            for r in range(world)]


def _pp_join(procs: dict, deadline: float) -> None:
    try:
        _join(procs, deadline, "pipeline")
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _pp_want(rec: dict) -> dict:
    """A stage's launches on test_bert.cfg's path: its layers' attention
    (and PP_STAGE_LN LayerNorms: the embeddings' on stage 0) per micro-batch
    forward and eval batch, the same per micro-batch backward."""
    layers = rec["layers"][1] - rec["layers"][0]
    ln = PP_STAGE_LN[rec["stage"]]
    micro = len(rec["steps"]) * rec["batch_split"]
    fwd = micro + rec["eval_batches"]
    return {"fused_attention_fwd": layers * fwd,
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": ln * fwd, "layer_norm_bwd": ln * micro,
            "q8_matmul": 0, "q8_quantize": 0}


def _pp_print(kind: str, recs: list) -> None:
    for r, rec in enumerate(recs):
        tr = rec["transport"]
        bubble = [round(s / w, 4) for s, w in zip(rec["step_transport_s"],
                                                  rec["step_walls"])]
        say(f"pipeline {kind} rank {r} (stage {rec['stage']}, layers "
            f"{rec['layers'][0]}..{rec['layers'][1] - 1}, {rec['mesh']}, "
            f"data {rec['data_index']}, {rec['layout']} layout, "
            f"{rec['schedule']}, gloo on the card, tokenizer "
            f"{rec['tokenizer']}): {len(rec['steps'])} steps of "
            f"{rec['batch_split']} micro-batches + {rec['eval_batches']} eval "
            f"batches in {rec['wall']:.1f}s; step walls "
            f"{[round(w, 3) for w in rec['step_walls']]} s; stage transport "
            f"{tr['hops']} sends, {tr['bytes'] / 1e9:.3f} GB sent, "
            f"{tr['staged_bytes'] / 1e9:.3f} GB staged through host memory, "
            f"{tr['seconds']:.2f} s in sends and receives (a step's: "
            f"{[round(s, 3) for s in rec['step_transport_s']]}); measured "
            f"bubble (a step's share waiting on the other stage) {bubble}, "
            f"modeled {rec['modeled_bubble']:.4f}; at most "
            f"{rec['in_flight']} micro-batches in flight; peak CUDA memory "
            f"{rec['peak_bytes'] / 1e9:.3f} GB; parameters "
            f"{rec['param_bytes'] / 1e6:.1f} MB, moments "
            f"{rec['opt_bytes'] / 1e6:.1f} MB on this rank; losses "
            f"{[s['loss'] for s in rec['steps']]}; launches {rec['launched']}"
            f" (expected {_pp_want(rec)}; {rec['preflight_probes']} pre-flight"
            f" probes launched {rec['probe_launches']})")


def _pp_check(kind: str, recs: list) -> None:
    world, _ = PP_RUNS[kind]
    for rec in recs:
        layers = rec["layers"][1] - rec["layers"][0]
        if rec["launched"] != _pp_want(rec):
            fail(f"pipeline {kind}: launch counts do not match the stage's "
                 f"path")
        if rec["preflight_probes"] < 1 or rec["probe_launches"][
                "fused_attention_bwd"] != layers * rec["preflight_probes"]:
            fail(f"pipeline {kind}: the pre-flight's probes did not run the "
                 f"stage's kernels")
        if rec["transport"]["hops"] < 1 or not all(
                np.isfinite(s["loss"]) for s in rec["steps"]):
            fail(f"pipeline {kind}: a stage sent nothing, or a loss is not "
                 f"finite")
        if [s["loss"] for s in rec["steps"]] != [s["loss"] for s in
                                                 recs[0]["steps"]]:
            fail(f"pipeline {kind}: the ranks logged other losses")
    if sorted((r["stage"], r["data_index"]) for r in recs) != sorted(
            (k, d) for k in range(2) for d in range(world // 2)):
        fail(f"pipeline {kind}: the ranks are not the mesh's stages")


def _pp_params(kind: str, which: str):
    """The whole model ``which`` (``built`` or ``final``) from the data
    index 0 rank of each stage."""
    import torch

    out = {}
    for path in sorted((PP_DIR / kind).glob("params*.pt")):
        out.update(torch.load(path)[which])
    return out


def _pp_reload(torch, recs: list) -> None:
    """Phase 19b's sharded checkpoint into a one-process trainer of the same
    flags at ``data:1`` (the optimizer kept): every parameter's digest is
    the one its stage recorded, every moment the checkpoint's."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.models.convert import from_jax_params
    from ml_recipe_tpu_torch.train.checkpoint import (
        peek_checkpoint_layout, read_state)

    path = PP_DIR / "zero1" / "ckpt"
    layout = peek_checkpoint_layout(path)
    params, model_params = _train_flags(REPO / "config" / "test_bert.cfg",
                                        PP_BASE[2:])
    with _shallow(PP_LAYERS):
        trainer = train_cli.build_trainer(params, model_params)
    trainer.drop_optimizer = False
    t0 = time.perf_counter()
    trainer.load_state_dict(path)
    seconds = time.perf_counter() - t0
    want = {}
    for rec in recs:
        want.update(rec["digests"])
    got = {n: _tensor_digest(p) for n, p in trainer.model.named_parameters()}
    same = got == want
    state = read_state(path)
    saved = trainer.optimizer.flax_state()
    moments_equal = True
    for key in ("mu", "nu"):
        ref = from_jax_params(state["optimizer"]["0"]["0"][key])
        mine = from_jax_params(saved["0"]["0"][key])
        moments_equal &= all(torch.equal(mine[n], ref[n]) for n in ref)
    say(f"pipeline zero1: the sharded checkpoint (layout "
        f"{json.dumps({k: layout[k] for k in ('mesh_axes', 'pipe_schedule', 'pipe_param_layout', 'opt_sharding', 'shards', 'process_count')})}"
        f", saved in {recs[0]['save_seconds']:.1f}s) reloaded in one process "
        f"(data:1) in {seconds:.1f}s: every parameter bit for bit the "
        f"stages': {same} ({len(want)} of {len(got)} recorded); every adam "
        f"moment the checkpoint's: {moments_equal}; global step "
        f"{trainer.global_step}")
    if (layout["pipe_param_layout"] != "stage" or layout["shards"] != 4
            or layout["opt_sharding"] != "zero1"):
        fail("pipeline zero1: the checkpoint does not record the stage "
             "layout's ZeRO-1 pieces")
    if not same or not moments_equal or trainer.global_step != 1:
        fail("pipeline zero1: the checkpoint did not restore in one process "
             "bit for bit")
    del trainer, saved, state
    torch.cuda.empty_cache()


def phase_pipeline(torch):
    """Phase 19: pipeline parallelism on the card (``--mesh pipe:2``).

    19a. ``config/test_bert.cfg --seed 0 --ln_impl fused`` with dropout 0
    (2 debug steps of 256x512 in 8 micro-batches of 32x512, 11 eval
    batches after each) as two ranks of ``cli.train`` (``--pp-worker
    schedules``, gloo on the card; bert-base's widths at PP_LAYERS layers:
    stage 0 the embeddings and layers 0..1, stage 1 layers 2..3, the
    pooler, the heads and the loss), on GPipe and then on 1F1B in the same
    pair, and in this process at ``data:1``
    (beside 19b's ranks): each rank's launches equal
    its stage's path, the two schedules' losses and final parameters agree
    within PP_SCHEDULE_TOL (bit for bit printed), and pipe:2 against the
    one process within PP_LOSS_REL_TOL (losses) and PP_UPDATE_REL_TOL
    (the parameter update, relative L2). Printed per rank: step walls, the
    stage transport's sends, bytes and seconds, the measured bubble (a
    step's share of waiting on the other stage: both stages share the one
    card, so it is not a two-card bubble) beside the modeled one, peak CUDA
    memory, parameter and moment bytes, the tokenizer backend.

    19b. ``--mesh data:2,pipe:2 --optimizer_sharding zero1
    --sharded_checkpoint`` as four ranks for one debug step, then its
    sharded save; the checkpoint peeks as the stage layout with 4-way
    pieces and restores in one process bit for bit (:func:`_pp_reload`).

    Returns the launch counts by path."""
    import shutil

    t_phase = time.perf_counter()
    shutil.rmtree(PP_DIR, ignore_errors=True)
    PP_DIR.mkdir(parents=True)
    _vocab()
    deadline = time.monotonic() + PP_DEADLINE_S
    _pp_join(_pp_world("schedules"), deadline)
    runs = {k: _pp_records(k) for k in ("gpipe", "1f1b")}
    for kind, recs in runs.items():
        _pp_print(kind, recs)
        _pp_check(kind, recs)
    gp, ofob = _pp_params("gpipe", "final"), _pp_params("1f1b", "final")
    built = _pp_params("gpipe", "built")
    sched_diff = max(float((gp[n] - ofob[n]).abs().max()) for n in gp)
    sched_equal = all(torch.equal(gp[n], ofob[n]) for n in gp)
    losses = {k: [s["loss"] for s in recs[0]["steps"]]
              for k, recs in runs.items()}
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(losses["1f1b"],
                                                        losses["gpipe"]))

    # 19b's four ranks start beside the one-process run (its walls are
    # taken beside them; the card holds both)
    zero_world = _pp_world("zero1")
    torch.cuda.reset_peak_memory_stats()
    try:
        trainer, _, one, one_wall = _run_training(torch, "test_bert.cfg",
                                                  PP_BASE[2:],
                                                  layers=PP_LAYERS)
        one_losses = [h["loss"] for h in trainer.history]
        final = {n: p.detach().cpu()
                 for n, p in trainer.model.named_parameters()}
        flat = lambda d: torch.cat([d[n].float().reshape(-1)
                                    for n in sorted(d)])
        update_rel = _rel(flat(gp) - flat(built), flat(final) - flat(built))
        one_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["gpipe"],
                                                          one_losses))
        say(f"pipeline: GPipe against 1F1B: losses {losses['gpipe']} and "
            f"{losses['1f1b']} (relative {loss_diff:.2e}), final parameters "
            f"max |diff| {sched_diff:.2e} (tol {PP_SCHEDULE_TOL:g}; bit for "
            f"bit: {sched_equal}); pipe:2 against one process "
            f"({one_wall:.1f}s beside 19b's ranks, step walls "
            f"{[round(h['seconds'], 3) for h in trainer.history]} s, "
            f"launches {one}): losses {one_losses}, relative "
            f"{one_rel:.2e} (tol {PP_LOSS_REL_TOL:g}), parameter update "
            f"relative L2 {update_rel:.2e} (tol {PP_UPDATE_REL_TOL:g})")
        for kind, recs in runs.items():
            say(f"pipeline {kind}: peak CUDA memory by rank "
                f"{[round(r['peak_bytes'] / 1e9, 3) for r in recs]} GB (one "
                f"process: {torch.cuda.max_memory_allocated() / 1e9:.3f} GB)")
        if sched_diff > PP_SCHEDULE_TOL or loss_diff > PP_SCHEDULE_TOL:
            fail("pipeline: GPipe and 1F1B part")
        if runs["1f1b"][0]["in_flight"] >= runs["gpipe"][0]["in_flight"]:
            fail("pipeline: 1F1B held as many micro-batches as GPipe")
        if not (one_rel <= PP_LOSS_REL_TOL
                and update_rel <= PP_UPDATE_REL_TOL):
            fail("pipeline: pipe:2 parts from the one-process run")
        del trainer, final, gp, ofob, built
        torch.cuda.empty_cache()
    finally:
        _pp_join(zero_world, deadline)
    zero = _pp_records("zero1")
    _pp_print("zero1", zero)
    _pp_check("zero1", zero)
    if any(len(r["steps"]) != 1 or r["layout"] != "stage" for r in zero):
        fail("pipeline zero1: not one step of the stage layout")
    _pp_reload(torch, zero)
    say(f"phase 19 wall {time.perf_counter() - t_phase:.1f}s")
    total = lambda recs: {k: sum(r["launched"][k] for r in recs)
                          for k in recs[0]["launched"]}
    return {"pipe:2 gpipe": total(runs["gpipe"]),
            "pipe:2 1f1b": total(runs["1f1b"]),
            "pipe:2 one process": one,
            "data:2,pipe:2 zero1": total(zero)}


# -- phase 20: tensor parallelism ---------------------------------------------

TP_DIR = OUT_DIR / "tp"
TP_DEADLINE_S = 420
# test_bert.cfg at full width (bert-base: 12 heads of 64, intermediate
# 3072, bf16 compute, f32 master weights), the fused LayerNorm, dropout
# live (the cfg's 0.1), cut to 2 debug steps of 64 rows in 2 micro-batches
# of 32x512 and eval batches of 4 rows (each eval forward's 24 all-reduces
# cross the host)
TP_BASE = ["-c", str(REPO / "config" / "test_bert.cfg"), "--seed", "0",
           "--ln_impl", "fused", "--train_batch_size", "64",
           "--batch_split", "2", "--test_batch_size", "4"]
# phase 20's runs: (ranks, flags, encoder layers). 20a: model:2 in bf16 on
# the kernels at 12 layers, and in f32 on the plain attention and
# LayerNorm at 2 (the exact gate); 20b: data:2,model:2 with ZeRO-1 at 4
# layers for one debug step, then a sharded save
TP_RUNS = {"bf16": (2, ["--mesh", "model:2"], 12),
           "f32": (2, ["--mesh", "model:2", "--compute_dtype", "float32",
                       "--flash_attention", "xla", "--ln_impl", "xla"], 2),
           "zero1": (4, ["--mesh", "data:2,model:2", "--optimizer_sharding",
                         "zero1", "--sharded_checkpoint"], 4)}
TP_WORLDS = {"pair": ("bf16", "f32"), "zero1": ("zero1",)}
# model:2 against one process on the same rows and dropout draws. f32: the
# same function in another summation order (a row-split product's two
# partial sums, the clip's split sum of squares): the JAX package's TP pins
# are 2e-5 on a CPU; bf16: a rank rounds each partial product to bf16
# before the all-reduce sums them, one process rounds the whole product
# once, and 12 post-LN layers carry that into the loss
TP_F32_LOSS_RTOL = 1e-5
TP_F32_GRAD_REL = 1e-5
TP_BF16_LOSS_RTOL = 1e-2
TP_HEADS = H // 2              # a rank's heads at model:2


@contextmanager
def _shallow(layers: int):
    """Every ``QAModel`` built inside is cut to ``layers`` encoder layers
    (the widths kept); 0 or the preset's depth: unchanged."""
    import dataclasses

    from ml_recipe_tpu_torch.models import qa_model

    init = qa_model.QAModel.__init__

    def shallow(self, cfg, *args, **kwargs):
        init(self, dataclasses.replace(cfg, num_layers=layers) if layers
             else cfg, *args, **kwargs)

    qa_model.QAModel.__init__ = shallow
    try:
        yield
    finally:
        qa_model.QAModel.__init__ = init


def _tp_capture(torch, trainer, store: dict) -> None:
    """The trainer's first clip stores the whole gradient it is handed
    (each split leaf's slices gathered over the ``model`` group), flattened
    in sorted name order on the CPU: the same layout one process's
    :func:`_tp_capture` stores."""
    from ml_recipe_tpu_torch.train import trainer as trainer_module

    clip = trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)
    split = trainer.tp

    def capture(tensors, max_norm, **kw):
        if "grads" not in store:
            whole = {n: (split.gather(n, g) if split is not None else g)
                     for n, g in zip(names, tensors)}
            store["grads"] = torch.cat([whole[n].detach().float().reshape(-1)
                                        for n in sorted(whole)]).cpu()
        return clip(tensors, max_norm, **kw)

    trainer_module.clip_by_global_norm_ = capture


def tp_worker(world_kind: str, rank: int, port: int) -> int:
    """One rank of phase 20's world ``world_kind`` (TP_WORLDS): joins it on
    card 0 over gloo and runs its runs one after another
    (:func:`_tp_run_one`)."""
    import gc

    import torch

    from ml_recipe_tpu_torch.parallel import dist as pdist

    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _register_kernels()
    world = TP_RUNS[TP_WORLDS[world_kind][0]][0]
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=torch.device("cuda", 0))
    try:
        for kind in TP_WORLDS[world_kind]:
            _tp_run_one(torch, kind, rank, port)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        pdist.shutdown()
    return 0


def _tp_flags(kind: str, extra=()):
    """Phase 20's ``kind`` flags (TP_RUNS) over TP_BASE."""
    return [*TP_BASE, *TP_RUNS[kind][1], *extra]


def _tp_run_one(torch, kind: str, rank: int, port: int) -> None:
    """One rank of phase 20's ``kind`` run through ``cli.train``'s parse,
    ``build_trainer`` and ``train`` (its model cut to the run's depth),
    counts and the model group's transport statistics set to 0 just before
    ``train`` and read just after (less the pre-flight's probes). Writes
    ``TP_DIR/<kind>/rank<r>.json``: each step's wall and all-reduce
    seconds, the transport's totals, launches, peak memory, parameter and
    moment bytes, the first batch's digest, the first step's loss, and the
    whole gradient at the first clip (``grads.pt``, rank 0); ``zero1``
    runs one step, writes its sharded checkpoint and records the digest of
    every whole parameter."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.parallel.sharding import opt_state_bytes_per_chip

    world, _, layers = TP_RUNS[kind]
    out = TP_DIR / kind
    out.mkdir(parents=True, exist_ok=True)
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [*_tp_flags(kind), "--vocab_file", str(OUT_DIR / "vocab.txt"),
         "--dump_dir", str(out / "results"), "--dist_world_size",
         str(world), "--local_rank", str(rank), "--dist_init_method",
         f"tcp://127.0.0.1:{port}"])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2)
                               // (2 * world)))
    with _shallow(layers):
        trainer = train_cli.build_trainer(params, model_params)
    if kind == "zero1":
        trainer.n_epochs = 1
    transport = trainer.mesh.model_transport
    first = {}
    _tp_capture(torch, trainer, first)
    per_step = []
    step = trainer.train_step

    def timed(inputs, labels):
        if "digest" not in first:
            first["digest"] = _tensor_digest(inputs["input_ids"])
        torch.cuda.synchronize()
        t0, s0 = time.perf_counter(), transport.stats["seconds"]
        values = step(inputs, labels)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0,
                         transport.stats["seconds"] - s0))
        return values

    trainer.train_step = timed
    probe = _count_probes(trainer)
    transport.reset()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()               # the main path starts here
    t0 = time.perf_counter()
    train_cli.train(trainer, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()         # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    launched = {k: n - probe[k] for k, n in launched.items()}
    model = trainer.model
    record = {
        "launched": launched, "probe_launches": probe,
        "preflight_probes": trainer.preflight_probes,
        "preflight": trainer.preflight_report, "wall": wall,
        "mesh": trainer.plan.describe(), "layers": model.cfg.num_layers,
        "heads": model.transformer.layer_0.attention.query.weight.shape[0]
        // model.cfg.head_dim,
        "data_index": trainer.mesh.data_index,
        "model_index": trainer.mesh.model_index,
        "batch_split": trainer.batch_split,
        "steps": [{k: h[k] for k in ("loss", "lr", "seconds", "rows")}
                  for h in trainer.history],
        "step_walls": [w for w, _ in per_step],
        "step_allreduce_s": [s for _, s in per_step],
        "transport": dict(transport.stats),
        "peak_bytes": peak,
        "param_count": sum(p.numel() for p in model.parameters()),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in model.parameters()),
        "opt_bytes": opt_state_bytes_per_chip(trainer.optimizer),
        "opt_sharding": trainer.effective_opt_sharding,
        "eval_batches": trainer.eval_batches,
        "batch_digest": first.get("digest"),
        "device": str(trainer.device),
        "dtype": str(model.dtype),
    }
    if rank == 0 and "grads" in first:
        torch.save(first["grads"], out / "grads.pt")
    if kind == "zero1":
        trainer.debug = False
        t0 = time.perf_counter()
        trainer.save_state_dict(out / "ckpt")
        record["save_seconds"] = time.perf_counter() - t0
        split = trainer.tp
        record["digests"] = {n: _tensor_digest(split.gather(n, p.detach()))
                             for n, p in model.named_parameters()}
    (out / f"rank{rank}.json").write_text(json.dumps(record))


def _tp_world(world_kind: str) -> dict:
    """Phase 20's ranks of ``world_kind`` (TP_WORLDS), started."""
    world = TP_RUNS[TP_WORLDS[world_kind][0]][0]
    port = _free_port()
    return {f"{world_kind} rank {r}": (
        _spawn(["--tp-worker", world_kind, r, port],
               TP_DIR / f"{world_kind}{r}.log"),
        TP_DIR / f"{world_kind}{r}.log") for r in range(world)}


def start_tensor_parallel_worlds() -> dict:
    """Phase 20's worlds (TP_WORLDS), started at once on a fresh
    ``TP_DIR``: ``{world_kind: procs}``."""
    import shutil

    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    _vocab()
    return {kind: _tp_world(kind) for kind in TP_WORLDS}


def _vocab() -> Path:
    """The synthetic vocab, written when missing: rank processes may be
    reading it."""
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    path = OUT_DIR / "vocab.txt"
    if not path.exists():
        write_synthetic_bert_vocab(path)
    return path


def _tp_records(kind: str) -> list:
    world = TP_RUNS[kind][0]
    return [json.loads((TP_DIR / kind / f"rank{r}.json").read_text())
            for r in range(world)]


def _tp_want(rec: dict, ln: bool = True) -> dict:
    """A rank's launches on the path: every layer's attention (and 25
    LayerNorms) per micro-batch forward and eval batch, the same per
    micro-batch backward (none on the plain path)."""
    micro = len(rec["steps"]) * rec["batch_split"]
    fwd = micro + rec["eval_batches"]
    kernels = rec["dtype"] == "torch.bfloat16"
    layers = rec["layers"] if kernels else 0
    norms = (2 * rec["layers"] + 1) if kernels and ln else 0
    return {"fused_attention_fwd": layers * fwd,
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": norms * fwd, "layer_norm_bwd": norms * micro,
            "q8_matmul": 0, "q8_quantize": 0}


def _tp_print(kind: str, recs: list) -> None:
    for r, rec in enumerate(recs):
        tr = rec["transport"]
        say(f"tensor parallel {kind} rank {r} ({rec['mesh']}, data "
            f"{rec['data_index']}, model {rec['model_index']}, "
            f"{rec['layers']} layers of {rec['heads']} heads a rank, "
            f"{rec['dtype']}, {rec['opt_sharding']}, gloo on the card): "
            f"{len(rec['steps'])} steps of {rec['batch_split']} "
            f"micro-batches + {rec['eval_batches']} eval batches in "
            f"{rec['wall']:.1f}s; step walls "
            f"{[round(w, 3) for w in rec['step_walls']]} s, of them in the "
            f"model group's all-reduces "
            f"{[round(s, 3) for s in rec['step_allreduce_s']]} s; transport "
            f"{tr['all_reduces']} all-reduces ({tr['forward']} forward, "
            f"{tr['backward']} backward), {tr['bytes'] / 1e9:.3f} GB reduced,"
            f" {tr['staged_bytes'] / 1e9:.3f} GB staged through host memory, "
            f"{tr['seconds']:.2f} s; peak CUDA memory "
            f"{rec['peak_bytes'] / 1e9:.3f} GB; parameters "
            f"{rec['param_count'] / 1e6:.2f} M ({rec['param_bytes'] / 1e6:.1f}"
            f" MB), moments {rec['opt_bytes'] / 1e6:.1f} MB on this rank; "
            f"losses {[s['loss'] for s in rec['steps']]}; launches "
            f"{rec['launched']} (expected {_tp_want(rec)}; "
            f"{rec['preflight_probes']} pre-flight probes launched "
            f"{rec['probe_launches']}; pre-flight need "
            f"{(rec['preflight'] or {}).get('bytes') or (rec['preflight'] or {}).get('buckets')}"
            f" B)")


def _tp_check(kind: str, recs: list) -> None:
    world, _, layers = TP_RUNS[kind]
    for rec in recs:
        if rec["launched"] != _tp_want(rec):
            fail(f"tensor parallel {kind}: launch counts do not match the "
                 f"path")
        if rec["layers"] != layers or rec["heads"] != TP_HEADS:
            fail(f"tensor parallel {kind}: a rank does not hold {TP_HEADS} "
                 f"heads of {layers} layers")
        tr = rec["transport"]
        micro = len(rec["steps"]) * rec["batch_split"]
        probes = rec["preflight_probes"]
        # 2 forward all-reduces a layer, 2 backward (the probes' too)
        if (tr["backward"] != 2 * layers * (micro + probes)
                or tr["forward"] != 2 * layers * (micro + probes
                                                  + rec["eval_batches"])
                or tr["staged_bytes"] <= 0):
            fail(f"tensor parallel {kind}: the model group did not take "
                 f"its all-reduces through the host")
        if not all(np.isfinite(s["loss"]) for s in rec["steps"]):
            fail(f"tensor parallel {kind}: a loss is not finite")
        if [s["loss"] for s in rec["steps"]] != [s["loss"] for s in
                                                 recs[0]["steps"]]:
            fail(f"tensor parallel {kind}: the ranks logged other losses")
    if sorted((r["data_index"], r["model_index"]) for r in recs) != sorted(
            (d, m) for d in range(world // 2) for m in range(2)):
        fail(f"tensor parallel {kind}: the ranks are not the mesh's places")


def _tp_kernels(torch, fa, bw, flops) -> dict:
    """Both attention kernels against their plain versions at a model:2
    rank's shape (32x512x6x64 bf16, dropout 0.1 with the rank's seed
    offset, ``ops.attention.model_row_seeds``); the rank's dropout
    uniforms (the hash) equal to one process's for those heads of its 12,
    bit for bit; then each kernel, its plain version and
    ``scaled_dot_product_attention`` timed beside the bound."""
    import torch.nn.functional as F

    from ml_recipe_tpu_torch.ops.attention import model_row_seeds

    rng = np.random.default_rng(20)
    B, L = TRAIN_SHAPE
    q, k, v, mask, _, _ = _attention_inputs(torch, fa, rng, B, L,
                                            torch.bfloat16)
    seed = torch.tensor([int(rng.integers(-2**31, 2**31 - 1))],
                        dtype=torch.int32, device="cuda")
    n, r = TP_HEADS, 1
    heads = slice(r * n, (r + 1) * n)
    seeds = model_row_seeds(seed, B, H, r, 2)
    same_masks = torch.equal(
        fa.uniform_grid(seeds, n, L),
        fa.uniform_grid(fa.row_seeds(seed, B, H, "cuda"), H, L)[:, heads])
    if not same_masks:
        fail("a model:2 rank's dropout at its seed offset is not one "
             "process's for its heads")
    q, k, v = (x[:, :, heads].contiguous() for x in (q, k, v))
    ref, lse = fa.fused_attention_plain(q, k, v, mask, seeds, TRAIN_RATE,
                                        want_lse=True)
    got, got_lse = fa.fused_attention_cuda(q, k, v, mask, seeds, TRAIN_RATE,
                                           want_lse=True)
    torch.cuda.synchronize()
    fwd_err = (got.float() - ref.float()).abs().max().item()
    lse_err = (got_lse - lse).abs().max().item()
    g = torch.from_numpy(rng.standard_normal(
        (B, L, n, D), dtype=np.float32)).to("cuda", torch.bfloat16)
    args = (q, k, v, g, ref, lse, mask, seeds, TRAIN_RATE, False)
    got_b, ref_b = (fa.fused_attention_bwd_cuda(*args),
                    fa.fused_attention_bwd_plain(*args))
    torch.cuda.synchronize()
    bwd_err, ok = 0.0, fwd_err <= ATOL["bf16"] and lse_err <= LSE_ATOL
    for a, b in zip(got_b, ref_b):
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        rel = ((a - b).norm() / b.norm()).item()
        ok &= (err <= BWD_BF16_STEPS * bf16_step(b.abs().max().item())
               and rel <= BWD_REL_L2)
        bwd_err = max(bwd_err, err)
    say(f"kernel-vs-plain at a model:2 rank's shape {B}x{L}x{n}x{D} bf16, "
        f"dropout {TRAIN_RATE} at rank {r}'s seed offset: forward "
        f"max_abs_err={fwd_err:.3e} (tol {ATOL['bf16']:g}) lse_err="
        f"{lse_err:.3e}; backward dq/dk/dv max_abs_err={bwd_err:.3e}; the "
        f"rank's dropout uniforms one process's for its heads bit for bit: "
        f"{same_masks} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("an attention kernel disagrees with plain at the model:2 shape")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    bool_mask = (mask > 0)[:, None, None, :]
    fwd = dict(
        ms=time_ms(torch, lambda: fa.fused_attention_cuda(
            q, k, v, mask, seeds, TRAIN_RATE, want_lse=True)),
        plain_ms=time_ms(torch, lambda: fa.fused_attention_plain(
            q, k, v, mask, seeds, TRAIN_RATE, want_lse=True)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bool_mask, dropout_p=TRAIN_RATE)))
    fwd["bound_ms"], fwd["bound_by"] = _bound(
        4 * B * L * n * D * 2 + mask.numel() * 4 + B * 4 + B * n * L * 4,
        4 * B * n * L * L * D, bw, flops)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    gt = g.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=bool_mask,
                                              dropout_p=TRAIN_RATE)

    bwd = dict(
        ms=time_ms(torch, lambda: fa.fused_attention_bwd_cuda(*args)),
        plain_ms=time_ms(torch, lambda: fa.fused_attention_bwd_plain(*args),
                         reps=5),
        library_ms=time_ms(torch, lambda: torch.autograd.grad(
            sdpa_fwd(), (qg, kg, vg), gt)) - time_ms(torch, sdpa_fwd))
    bwd["bound_ms"], bwd["bound_by"] = _bound(
        8 * B * L * n * D * 2 + B * n * L * 4 + mask.numel() * 4 + B * 4,
        5 * 2 * B * n * L * L * D, bw, flops)
    for name, t in (("fwd", fwd), ("bwd", bwd)):
        say(f"timing fused_attention_{name} {B}x{L}x{n}x{D} bf16 (a "
            f"model:2 rank, rate 0.1): kernel_ms={t['ms']:.4f} "
            f"plain_ms={t['plain_ms']:.4f} library_ms(sdpa)="
            f"{t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']})")
    return dict(fwd=fwd, bwd=bwd, fwd_err=max(fwd_err, lse_err),
                bwd_err=bwd_err)


def _tp_one_process(torch, kind: str):
    """Phase 20a's ``kind`` run (TP_RUNS) in this process at ``data:1``
    through the CLI's build and train sequence: its launches (less the
    pre-flight's probes), first batch digest, steps and the whole gradient
    at the first clip."""
    from ml_recipe_tpu_torch.cli import train as train_cli

    layers = TP_RUNS[kind][2]
    flags = [f for f in _tp_flags(kind) if f not in ("--mesh", "model:2")]
    params, model_params = _train_flags(REPO / "config" / "test_bert.cfg",
                                        flags[2:])
    with _shallow(layers):
        trainer = train_cli.build_trainer(params, model_params)
    first = {}
    _tp_capture(torch, trainer, first)
    step = trainer.train_step

    def digested(inputs, labels):
        first.setdefault("digest", _tensor_digest(inputs["input_ids"]))
        return step(inputs, labels)

    trainer.train_step = digested
    probe = _count_probes(trainer)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()               # the main path starts here
    t0 = time.perf_counter()
    train_cli.train(trainer, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()         # the main path ends here
    launched = {k: n - probe[k] for k, n in launched.items()}
    out = dict(launched=launched, wall=wall, grads=first["grads"],
               digest=first["digest"], peak=torch.cuda.max_memory_allocated(),
               losses=[h["loss"] for h in trainer.history],
               walls=[h["seconds"] for h in trainer.history],
               param_count=sum(p.numel() for p in trainer.model.parameters()),
               eval_batches=trainer.eval_batches,
               batch_split=trainer.batch_split)
    del trainer
    torch.cuda.empty_cache()
    return out


def _tp_gate(torch, kind: str, recs: list, one: dict) -> dict:
    """Phase 20a's ``kind`` run against the one process: the first step's
    loss (relative) and the whole gradient at the first clip (relative L2);
    fails past TP_F32_* (f32) or TP_BF16_LOSS_RTOL (bf16)."""
    if recs[0]["batch_digest"] != one["digest"]:
        fail(f"tensor parallel {kind}: model:2 and the one process drew "
             f"other first batches")
    grads = torch.load(TP_DIR / kind / "grads.pt")
    rel = float((grads - one["grads"]).norm() / one["grads"].norm())
    loss, loss1 = recs[0]["steps"][0]["loss"], one["losses"][0]
    loss_rel = abs(loss - loss1) / abs(loss1)
    tol = TP_F32_LOSS_RTOL if kind == "f32" else TP_BF16_LOSS_RTOL
    say(f"tensor parallel {kind}: model:2 against one process "
        f"({one['wall']:.1f}s, step walls {[round(w, 3) for w in one['walls']]}"
        f" s, {one['param_count'] / 1e6:.2f} M parameters, peak CUDA memory "
        f"{one['peak'] / 1e9:.3f} GB, launches {one['launched']}): step-1 "
        f"loss {loss!r} against {loss1!r}, relative {loss_rel:.3e} (tol "
        f"{tol:g}); gradient at the first clip relative L2 {rel:.3e}"
        + (f" (tol {TP_F32_GRAD_REL:g})" if kind == "f32" else
           " (recorded)"))
    if not (np.isfinite(loss_rel) and loss_rel <= tol):
        fail(f"tensor parallel {kind}: the model:2 loss parts from one "
             f"process")
    if kind == "f32" and not rel <= TP_F32_GRAD_REL:
        fail("tensor parallel f32: the model:2 gradient parts from one "
             "process")
    return dict(loss_rel=loss_rel, grad_rel=rel)


def _tp_reload(torch, recs: list) -> None:
    """Phase 20b's sharded checkpoint into a one-process trainer of the same
    flags and depth at ``data:1`` (the optimizer kept): every parameter's
    digest is the whole one the ranks recorded, every moment the
    checkpoint's."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.models.convert import from_jax_params
    from ml_recipe_tpu_torch.train.checkpoint import (
        peek_checkpoint_layout, read_state)

    path = TP_DIR / "zero1" / "ckpt"
    layout = peek_checkpoint_layout(path)
    flags = [f for f in _tp_flags("zero1") if f not in (
        "--mesh", "data:2,model:2", "--sharded_checkpoint")]
    params, model_params = _train_flags(REPO / "config" / "test_bert.cfg",
                                        flags[2:])
    with _shallow(TP_RUNS["zero1"][2]):
        trainer = train_cli.build_trainer(params, model_params)
    trainer.drop_optimizer = False
    t0 = time.perf_counter()
    trainer.load_state_dict(path)
    seconds = time.perf_counter() - t0
    got = {n: _tensor_digest(p) for n, p in trainer.model.named_parameters()}
    same = all(got == rec["digests"] for rec in recs)
    state = read_state(path)
    saved = trainer.optimizer.flax_state()
    moments_equal = True
    for key in ("mu", "nu"):
        ref = from_jax_params(state["optimizer"]["0"]["0"][key])
        mine = from_jax_params(saved["0"]["0"][key])
        moments_equal &= all(torch.equal(
            mine[n], ref[n][tuple(slice(0, d) for d in mine[n].shape)])
            for n in ref)
    say(f"tensor parallel zero1: the sharded checkpoint (layout "
        f"{json.dumps({k: layout[k] for k in ('mesh_axes', 'opt_sharding', 'shards', 'process_count')})}"
        f", saved in {recs[0]['save_seconds']:.1f}s) reloaded in one process "
        f"(data:1) in {seconds:.1f}s: every parameter bit for bit the "
        f"gathered whole: {same}; every adam moment the checkpoint's: "
        f"{moments_equal}; global step {trainer.global_step}")
    if (layout["mesh_axes"] != {"data": 2, "model": 2}
            or layout["shards"] != 4 or layout["opt_sharding"] != "zero1"):
        fail("tensor parallel zero1: the checkpoint does not record the "
             "data:2,model:2 ZeRO-1 pieces")
    if not same or not moments_equal or trainer.global_step != 1:
        fail("tensor parallel zero1: the checkpoint did not restore in one "
             "process bit for bit")
    del trainer, saved, state
    torch.cuda.empty_cache()


def phase_tensor_parallel(torch):
    """Phase 20: tensor parallelism on the card (``--mesh model:2``).

    20a. ``config/test_bert.cfg --seed 0 --ln_impl fused
    --train_batch_size 64 --batch_split 2 --test_batch_size 4`` (bert-base
    at full width and depth, dropout 0.1, 2 debug steps of 2 micro-batches
    of 32x512, 11 eval batches of 4 rows after each) as two ranks of ``cli.train`` on ``--mesh model:2`` (``--tp-worker
    pair``, gloo on the card: a rank holds 6 heads and 1536 MLP columns a
    layer), and the same at 2 layers in f32 on the plain attention and
    LayerNorm; each against this process at ``data:1`` on the same rows
    and dropout draws: f32 within TP_F32_LOSS_RTOL (loss) and
    TP_F32_GRAD_REL (the whole gradient at the first clip), bf16 within
    TP_BF16_LOSS_RTOL (loss), its gradient gap recorded. Each rank's launches equal the path's, its transport took 2
    forward and 2 backward all-reduces a layer through the host.

    20b. ``--mesh data:2,model:2 --optimizer_sharding zero1
    --sharded_checkpoint`` at 4 layers as four ranks for one debug step,
    then its sharded save, which must peek ``mesh_axes`` {data: 2, model:
    2} with 4-way pieces and reload in one process bit for bit
    (:func:`_tp_reload`).

    Both worlds run at once (:func:`start_tensor_parallel_worlds`).
    Printed per rank: step walls and their all-reduce seconds, the
    transport's all-reduces, bytes and seconds, launches, parameter and
    moment bytes, peak CUDA memory. Returns the launch counts by path and
    the gates' gaps. (The attention kernels at a rank's shape are phase
    20c, :func:`_tp_kernels`, run by :func:`main` on the card alone.)"""
    t_phase = time.perf_counter()
    deadline = time.monotonic() + TP_DEADLINE_S
    for procs in start_tensor_parallel_worlds().values():
        _pp_join(procs, deadline)
    runs = {k: _tp_records(k) for k in TP_WORLDS["pair"]}
    for kind, recs in runs.items():
        _tp_print(kind, recs)
        _tp_check(kind, recs)
    ones = {kind: _tp_one_process(torch, kind) for kind in ("bf16", "f32")}
    gates = {kind: _tp_gate(torch, kind, runs[kind], ones[kind])
             for kind in ones}
    one = ones["bf16"]["launched"]
    if one != _tp_want(dict(runs["bf16"][0], batch_split=ones["bf16"][
            "batch_split"], eval_batches=ones["bf16"]["eval_batches"])):
        fail("tensor parallel: the one process's launches do not match the "
             "path")
    zero = _tp_records("zero1")
    _tp_print("zero1", zero)
    _tp_check("zero1", zero)
    if any(len(r["steps"]) != 1 or r["opt_sharding"] != "zero1"
           for r in zero):
        fail("tensor parallel zero1: not one ZeRO-1 step")
    _tp_reload(torch, zero)
    say(f"phase 20 wall {time.perf_counter() - t_phase:.1f}s")
    total = lambda recs: {k: sum(r["launched"][k] for r in recs)
                          for k in recs[0]["launched"]}
    return {"model:2 bf16": total(runs["bf16"]),
            "model:2 one process": one,
            "data:2,model:2 zero1": total(zero), "gates": gates}


# -- phase 21: pipeline stages of tensor-parallel layers ----------------------

PM_DIR = OUT_DIR / "pm"
PM_DEADLINE_S = 600
# phase 21's runs over TP_BASE (test_bert.cfg at full width, the fused
# LayerNorm, dropout 0.1, 2 debug steps of 64 rows in 2 micro-batches of
# 32x512, eval batches of 4 rows): (ranks, flags, encoder layers). 21a:
# pipe:2,model:2 in bf16 on the kernels at 12 layers (a rank: 6 layers of
# 6 heads and 1536 MLP columns) under GPipe and 1F1B, and in f32 on the
# plain attention and LayerNorm at 2 layers (the exact gate); 21b:
# data:2,pipe:2,model:2 with ZeRO-1 at 4 layers for one debug step, then a
# sharded save. The memory pre-flight's probes (a micro-batch forward
# and backward a bucket, through the pipeline) run in the GPipe and ZeRO-1
# runs; the 1F1B and f32 runs of the same world skip them (their gloo
# all-reduces load the host beside phases 12 and 13)
PM_RUNS = {"gpipe": (4, ["--mesh", "pipe:2,model:2"], 12),
           "1f1b": (4, ["--mesh", "pipe:2,model:2", "--pipe_schedule",
                        "1f1b", "--hbm_preflight", "false"], 12),
           "f32": (4, ["--mesh", "pipe:2,model:2", "--compute_dtype",
                       "float32", "--flash_attention", "xla", "--ln_impl",
                       "xla", "--hbm_preflight", "false"], 2),
           "zero1": (8, ["--mesh", "data:2,pipe:2,model:2",
                         "--optimizer_sharding", "zero1",
                         "--sharded_checkpoint"], 4)}
PM_WORLDS = {"quad": ("gpipe", "1f1b", "f32"), "octo": ("zero1",)}
# against one process on the same rows and the pipeline's dropout draws
# (:func:`_pm_one_process`): f32, the same function in another summation
# order (a row-split product's partial sums, the clip's split and staged
# sums of squares), the JAX package's TP pins; bf16: a rank rounds each
# partial product to bf16 before the all-reduce sums them, and 12 post-LN
# layers carry that into the loss
PM_F32_LOSS_RTOL = 1e-5
PM_F32_GRAD_REL = 1e-5
PM_BF16_LOSS_RTOL = 1e-3


def pm_worker(world_kind: str, rank: int, port: int) -> int:
    """One rank of phase 21's world ``world_kind`` (PM_WORLDS): joins it on
    card 0 over gloo, with cuBLAS's deterministic workspace (GPipe and
    1F1B are held bit for bit), and runs its runs one after another
    (:func:`_pm_run_one`)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import gc

    import torch

    from ml_recipe_tpu_torch.parallel import dist as pdist

    torch.use_deterministic_algorithms(True, warn_only=True)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    _register_kernels()
    world = PM_RUNS[PM_WORLDS[world_kind][0]][0]
    torch.cuda.set_device(0)
    pdist.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
        backend="gloo", device=torch.device("cuda", 0))
    try:
        for kind in PM_WORLDS[world_kind]:
            _pm_run_one(torch, kind, rank, port)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        pdist.shutdown()
    return 0


def _pm_flags(kind: str, extra=()):
    """Phase 21's ``kind`` flags (PM_RUNS) over TP_BASE."""
    return [*TP_BASE, *PM_RUNS[kind][1], *extra]


def _pm_run_one(torch, kind: str, rank: int, port: int) -> None:
    """One rank of phase 21's ``kind`` run through ``cli.train``'s parse,
    ``build_trainer`` and ``train`` (its model cut to the run's depth),
    counts and both transports' statistics set to 0 just before ``train``
    and read just after (less the pre-flight's probes). Writes
    ``PM_DIR/<kind>/rank<r>.json``: each step's wall, stage-transport and
    all-reduce seconds, both transports' totals, launches, peak memory,
    parameter and moment bytes, the first batch's digest, the losses and
    the digest of every parameter the rank stores; a stage's whole
    gradient at the first clip (each split leaf gathered over the
    ``model`` group; ``grads<stage>.pt``, by its data 0, model 0 rank);
    ``zero1`` runs one step, writes its sharded checkpoint and records the
    digest of every whole parameter of the stage."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.config.parser import (
        get_model_parser, get_params, get_trainer_parser)
    from ml_recipe_tpu_torch.parallel import pipeline
    from ml_recipe_tpu_torch.parallel.sharding import opt_state_bytes_per_chip
    from ml_recipe_tpu_torch.train import trainer as trainer_module

    world, _, layers = PM_RUNS[kind]
    out = PM_DIR / kind
    out.mkdir(parents=True, exist_ok=True)
    _, (params, model_params) = get_params(
        (get_trainer_parser, get_model_parser),
        [*_pm_flags(kind), "--vocab_file", str(OUT_DIR / "vocab.txt"),
         "--dump_dir", str(out / "results"), "--dist_world_size",
         str(world), "--local_rank", str(rank), "--dist_init_method",
         f"tcp://127.0.0.1:{port}"])
    params.n_jobs = max(1, min(params.n_jobs, (os.cpu_count() or 2)
                               // (2 * world)))
    with _shallow(layers):
        trainer = train_cli.build_trainer(params, model_params)
    if kind == "zero1":
        trainer.n_epochs = 1
    mesh, lay, split = trainer.mesh, trainer.pipe, trainer.tp
    stage, transport = mesh.stage, mesh.model_transport
    writer = mesh.data_index == 0 and mesh.model_index == 0
    first = {}
    clip = trainer_module.clip_by_global_norm_
    names = list(trainer.optimizer.params)

    def capture(tensors, max_norm, **kw):
        if "grads" not in first:
            first["grads"] = True
            whole = {n: split.gather(n, g).detach().float().cpu()
                     for n, g in zip(names, tensors)}
            if writer and kind in ("gpipe", "f32"):
                torch.save(whole, out / f"grads{lay.index}.pt")
        return clip(tensors, max_norm, **kw)

    trainer_module.clip_by_global_norm_ = capture
    per_step = []
    step = trainer.train_step

    def timed(inputs, labels):
        if "digest" not in first:
            first["digest"] = _tensor_digest(inputs["input_ids"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0, a0 = stage.stats["seconds"], transport.stats["seconds"]
        values = step(inputs, labels)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0,
                         stage.stats["seconds"] - s0,
                         transport.stats["seconds"] - a0))
        return values

    trainer.train_step = timed
    probe = _count_probes(trainer)
    stage.reset()
    transport.reset()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()               # the main path starts here
    t0 = time.perf_counter()
    train_cli.train(trainer, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()         # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    trainer_module.clip_by_global_norm_ = clip
    launched = {k: n - probe[k] for k, n in launched.items()}
    model = trainer.model
    stored = {n: p.detach() for n, p in model.named_parameters()
              if p.device.type != "meta"}
    record = {
        "launched": launched, "probe_launches": probe,
        "preflight_probes": trainer.preflight_probes, "wall": wall,
        "mesh": trainer.plan.describe(), "stage": lay.index,
        "layers": [lay.lo, lay.hi], "layout": lay.layout,
        "schedule": trainer.pipe_schedule,
        "heads": (model.transformer.layer_0.attention.query.weight.shape[0]
                  // model.cfg.head_dim),
        "data_index": mesh.data_index, "model_index": mesh.model_index,
        "model_ranks": list(mesh.model_ranks),
        "pipe_ranks": list(mesh.pipe_ranks),
        "batch_split": trainer.batch_split,
        "steps": [{k: h[k] for k in ("loss", "lr", "seconds", "rows")}
                  for h in trainer.history],
        "step_walls": [w for w, _, _ in per_step],
        "step_stage_s": [s for _, s, _ in per_step],
        "step_allreduce_s": [a for _, _, a in per_step],
        "stage_transport": dict(stage.stats),
        "transport": dict(transport.stats),
        "in_flight": trainer.pipe_runner.in_flight,
        "modeled_bubble": pipeline.modeled_bubble_fraction(
            lay.K, trainer.batch_split, trainer.pipe_schedule),
        "peak_bytes": peak,
        "param_count": sum(p.numel() for p in stored.values()),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in stored.values()),
        "opt_bytes": opt_state_bytes_per_chip(trainer.optimizer),
        "opt_sharding": trainer.effective_opt_sharding,
        "eval_batches": trainer.eval_batches,
        "batch_digest": first.get("digest"),
        "digests": {n: _tensor_digest(p) for n, p in stored.items()},
        "device": str(trainer.device),
        "dtype": str(model.dtype),
    }
    if kind == "zero1":
        trainer.debug = False
        t0 = time.perf_counter()
        trainer.save_state_dict(out / "ckpt")
        record["save_seconds"] = time.perf_counter() - t0
        record["whole_digests"] = {
            n: _tensor_digest(split.gather(n, p)) for n, p in stored.items()}
    (out / f"rank{rank}.json").write_text(json.dumps(record))


def start_pipe_model_worlds() -> dict:
    """Phase 21's worlds (PM_WORLDS), started at once on a fresh
    ``PM_DIR``: ``{world_kind: procs}``."""
    import shutil

    shutil.rmtree(PM_DIR, ignore_errors=True)
    PM_DIR.mkdir(parents=True)
    _vocab()
    worlds = {}
    for world_kind, kinds in PM_WORLDS.items():
        world, port = PM_RUNS[kinds[0]][0], _free_port()
        worlds[world_kind] = {f"{world_kind} rank {r}": (
            _spawn(["--pm-worker", world_kind, r, port],
                   PM_DIR / f"{world_kind}{r}.log"),
            PM_DIR / f"{world_kind}{r}.log") for r in range(world)}
    return worlds


def _pm_records(kind: str) -> list:
    world = PM_RUNS[kind][0]
    return [json.loads((PM_DIR / kind / f"rank{r}.json").read_text())
            for r in range(world)]


def _pm_want(rec: dict) -> dict:
    """A rank's launches on its stage's path: its layers' attention (and
    2 LayerNorms a layer, with the embeddings' on stage 0) per micro-batch
    forward and eval batch, the same per micro-batch backward (none on the
    plain path)."""
    micro = len(rec["steps"]) * rec["batch_split"]
    fwd = micro + rec["eval_batches"]
    kernels = rec["dtype"] == "torch.bfloat16"
    layers = rec["layers"][1] - rec["layers"][0] if kernels else 0
    norms = (2 * layers + (rec["stage"] == 0)) if kernels else 0
    return {"fused_attention_fwd": layers * fwd,
            "fused_attention_bwd": layers * micro,
            "layer_norm_fwd": norms * fwd, "layer_norm_bwd": norms * micro,
            "q8_matmul": 0, "q8_quantize": 0}


def _pm_print(kind: str, recs: list) -> None:
    for r, rec in enumerate(recs):
        tr, st = rec["transport"], rec["stage_transport"]
        say(f"pipe x model {kind} rank {r} ({rec['mesh']}, stage "
            f"{rec['stage']} (layers {rec['layers'][0]}..{rec['layers'][1] - 1}"
            f"), data {rec['data_index']}, model {rec['model_index']} of "
            f"group {rec['model_ranks']}, pipeline {rec['pipe_ranks']}, "
            f"{rec['heads']} heads a layer, {rec['dtype']}, "
            f"{rec['schedule']}, {rec['layout']} layout, "
            f"{rec['opt_sharding']}, gloo on the card): {len(rec['steps'])} "
            f"steps of {rec['batch_split']} micro-batches + "
            f"{rec['eval_batches']} eval batches in {rec['wall']:.1f}s; step "
            f"walls {[round(w, 3) for w in rec['step_walls']]} s, of them "
            f"in stage hand-offs {[round(s, 3) for s in rec['step_stage_s']]}"
            f" s and in the model group's all-reduces "
            f"{[round(a, 3) for a in rec['step_allreduce_s']]} s; stage "
            f"transport {st['hops']} sends, {st['bytes'] / 1e9:.3f} GB sent,"
            f" {st['staged_bytes'] / 1e9:.3f} GB staged; model transport "
            f"{tr['all_reduces']} all-reduces ({tr['forward']} forward, "
            f"{tr['backward']} backward), {tr['bytes'] / 1e9:.3f} GB "
            f"reduced, {tr['staged_bytes'] / 1e9:.3f} GB staged through host "
            f"memory, {tr['seconds']:.2f} s; modeled bubble "
            f"{rec['modeled_bubble']:.4f}, at most {rec['in_flight']} "
            f"micro-batches in flight; peak CUDA memory "
            f"{rec['peak_bytes'] / 1e9:.3f} GB; parameters "
            f"{rec['param_count'] / 1e6:.2f} M ({rec['param_bytes'] / 1e6:.1f}"
            f" MB), moments {rec['opt_bytes'] / 1e6:.1f} MB on this rank; "
            f"losses {[s['loss'] for s in rec['steps']]}; launches "
            f"{rec['launched']} (expected {_pm_want(rec)}; "
            f"{rec['preflight_probes']} pre-flight probes launched "
            f"{rec['probe_launches']})")


def _pm_check(kind: str, recs: list) -> None:
    world, _, layers = PM_RUNS[kind]
    stage_layers = layers // 2
    for r, rec in enumerate(recs):
        if rec["launched"] != _pm_want(rec):
            fail(f"pipe x model {kind}: launch counts do not match the "
                 f"stage's path")
        if (rec["layers"][1] - rec["layers"][0] != stage_layers
                or rec["heads"] != TP_HEADS):
            fail(f"pipe x model {kind}: a rank does not hold {TP_HEADS} "
                 f"heads of {stage_layers} layers")
        tr = rec["transport"]
        micro = len(rec["steps"]) * rec["batch_split"]
        probes = rec["preflight_probes"]
        # 2 forward all-reduces a layer, 2 backward (the probes' too)
        if (tr["backward"] != 2 * stage_layers * (micro + probes)
                or tr["forward"] != 2 * stage_layers * (
                    micro + probes + rec["eval_batches"])
                or tr["staged_bytes"] <= 0
                or rec["stage_transport"]["hops"] < 1):
            fail(f"pipe x model {kind}: the model group did not take its "
                 f"all-reduces through the host, or the stage sent nothing")
        if not all(np.isfinite(s["loss"]) for s in rec["steps"]):
            fail(f"pipe x model {kind}: a loss is not finite")
        if [s["loss"] for s in rec["steps"]] != [s["loss"] for s in
                                                 recs[0]["steps"]]:
            fail(f"pipe x model {kind}: the ranks logged other losses")
        # a model group and a pipeline are the JAX device order's
        T, K = 2, 2
        if (rec["model_ranks"] != [r - r % T + j for j in range(T)]
                or rec["pipe_ranks"] != [r % (world // K) + k * (world // K)
                                         for k in range(K)]):
            fail(f"pipe x model {kind}: rank {r}'s groups are not the JAX "
                 f"mesh's")
    if sorted((r["stage"], r["data_index"], r["model_index"]) for r in recs
              ) != sorted((k, d, m) for k in range(2)
                          for d in range(world // 4) for m in range(2)):
        fail(f"pipe x model {kind}: the ranks are not the mesh's places")


def _pm_one_process(torch, kind: str):
    """Phase 21a's ``kind`` run (PM_RUNS) in this process at ``data:1``: its
    first batch (the loader's, through the CLI's build), one optimizer
    step's micro-batches forward and backward on the pipeline's dropout
    draws (``parallel.pipeline.step_generator`` of each micro-batch and
    layer: a pipeline does not draw what one process's step draws), no
    update. Returns the batch's digest, the step's loss (the micro-batches'
    mean, as the pipeline logs it), the gradient over ``batch_split`` by
    name, walls and memory."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.parallel import pipeline

    layers = PM_RUNS[kind][2]
    flags = [f for f in _pm_flags(kind) if f not in ("--mesh",
                                                      "pipe:2,model:2")]
    params, model_params = _train_flags(REPO / "config" / "test_bert.cfg",
                                        flags[2:])
    with _shallow(layers):
        trainer = train_cli.build_trainer(params, model_params)
    loader = trainer.train_dataloader
    loader.set_epoch(1)
    batches, prefetcher = trainer._batches(loader, "phase 21 one process")
    placed = next(iter(batches)).ready()
    if prefetcher is not None:
        prefetcher.close()
    inputs, labels = placed["inputs"], placed["labels"]
    model, m = trainer.model, trainer.batch_split
    model.train()
    x = trainer._model_inputs(inputs)
    micro = x["input_ids"].shape[0] // m
    L = model.cfg.num_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    total_loss = None
    for i in range(m):
        rows = slice(i * micro, (i + 1) * micro)
        xi = {k: v[rows] for k, v in x.items()}

        def gen(slot, i=i):
            return pipeline.step_generator(trainer.seed, 0, i, slot,
                                           trainer.device)

        h = model.embed(xi["input_ids"], xi["token_type_ids"], gen(0))
        y = model.layers(h, xi["attention_mask"], 0, L,
                         lambda li: gen(1 + li))
        preds = model.tail(y, xi["attention_mask"], gen(1 + L))
        total, values = trainer.loss(preds, {k: v[rows] for k, v in
                                             labels.items()})
        total.backward()
        v = values["loss"].detach().float()
        total_loss = v if total_loss is None else total_loss + v
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grads = {n: (p.grad.float() / m).cpu()
             for n, p in model.named_parameters()}
    out = dict(digest=_tensor_digest(inputs["input_ids"]),
               loss=float(total_loss * (1.0 / m)), grads=grads, wall=wall,
               peak=torch.cuda.max_memory_allocated(),
               param_count=sum(p.numel() for p in model.parameters()))
    del trainer, model
    torch.cuda.empty_cache()
    return out


def _pm_gate(torch, kind: str, recs: list, one: dict) -> dict:
    """Phase 21a's ``kind`` run against the one process: the first step's
    loss (relative) and the whole gradient at the first clip, the stages'
    joined (relative L2); fails past PM_F32_* (f32) or PM_BF16_LOSS_RTOL
    (bf16)."""
    if recs[0]["batch_digest"] != one["digest"]:
        fail(f"pipe x model {kind}: the ranks and the one process drew "
             f"other first batches")
    grads = {}
    for path in sorted((PM_DIR / kind).glob("grads*.pt")):
        grads.update(torch.load(path))
    if set(grads) != set(one["grads"]):
        fail(f"pipe x model {kind}: the stages' gradients do not cover the "
             f"model")
    flat = lambda d: torch.cat([d[n].reshape(-1) for n in sorted(d)])
    rel = _rel(flat(grads), flat(one["grads"]))
    loss, loss1 = recs[0]["steps"][0]["loss"], one["loss"]
    loss_rel = abs(loss - loss1) / abs(loss1)
    tol = PM_F32_LOSS_RTOL if kind == "f32" else PM_BF16_LOSS_RTOL
    say(f"pipe x model {kind}: pipe:2,model:2 against one process on the "
        f"pipeline's dropout draws ({one['wall']:.2f}s for the step's "
        f"micro-batches, {one['param_count'] / 1e6:.2f} M parameters, peak "
        f"CUDA memory {one['peak'] / 1e9:.3f} GB): step-1 loss {loss!r} "
        f"against {loss1!r}, relative {loss_rel:.3e} (tol {tol:g}); "
        f"gradient at the first clip relative L2 {rel:.3e}"
        + (f" (tol {PM_F32_GRAD_REL:g})" if kind == "f32" else
           " (recorded)"))
    if not (np.isfinite(loss_rel) and loss_rel <= tol):
        fail(f"pipe x model {kind}: the pipe:2,model:2 loss parts from one "
             f"process")
    if kind == "f32" and not rel <= PM_F32_GRAD_REL:
        fail("pipe x model f32: the pipe:2,model:2 gradient parts from one "
             "process")
    return dict(loss_rel=loss_rel, grad_rel=rel)


def _pm_reload(torch, recs: list) -> None:
    """Phase 21b's sharded checkpoint, peeked, then loaded into a
    one-process trainer of the same flags and depth at ``data:1`` (the
    optimizer kept): every parameter's digest is the whole one its stage's
    ranks recorded, every moment the checkpoint's."""
    from ml_recipe_tpu_torch.cli import train as train_cli
    from ml_recipe_tpu_torch.models.convert import from_jax_params
    from ml_recipe_tpu_torch.train.checkpoint import (
        peek_checkpoint_layout, read_state)

    path = PM_DIR / "zero1" / "ckpt"
    layout = peek_checkpoint_layout(path)
    flags = [f for f in _pm_flags("zero1") if f not in (
        "--mesh", "data:2,pipe:2,model:2", "--sharded_checkpoint")]
    params, model_params = _train_flags(REPO / "config" / "test_bert.cfg",
                                        flags[2:])
    with _shallow(PM_RUNS["zero1"][2]):
        trainer = train_cli.build_trainer(params, model_params)
    trainer.drop_optimizer = False
    t0 = time.perf_counter()
    trainer.load_state_dict(path)
    seconds = time.perf_counter() - t0
    want = {}
    for rec in recs:
        want.update(rec["whole_digests"])
    got = {n: _tensor_digest(p) for n, p in trainer.model.named_parameters()}
    same = got == want and all(
        rec["whole_digests"][n] == want[n] for rec in recs
        for n in rec["whole_digests"])
    state = read_state(path)
    saved = trainer.optimizer.flax_state()
    moments_equal = True
    for key in ("mu", "nu"):
        ref = from_jax_params(state["optimizer"]["0"]["0"][key])
        mine = from_jax_params(saved["0"]["0"][key])
        moments_equal &= all(torch.equal(
            mine[n], ref[n][tuple(slice(0, d) for d in mine[n].shape)])
            for n in ref)
    say(f"pipe x model zero1: the sharded checkpoint (layout "
        f"{json.dumps({k: layout[k] for k in ('mesh_axes', 'pipe_schedule', 'pipe_param_layout', 'opt_sharding', 'shards', 'process_count')})}"
        f", saved in {recs[0]['save_seconds']:.1f}s) reloaded in one process "
        f"(data:1) in {seconds:.1f}s: every parameter bit for bit the "
        f"stages' gathered whole: {same}; every adam moment the "
        f"checkpoint's: {moments_equal}; global step {trainer.global_step}")
    if (layout["mesh_axes"] != {"pipe": 2, "data": 2, "model": 2}
            or layout["pipe_param_layout"] != "stage"
            or layout["shards"] < 4 or layout["opt_sharding"] != "zero1"
            or layout["process_count"] != 8):
        fail("pipe x model zero1: the checkpoint does not record the "
             "data:2,pipe:2,model:2 stage layout's ZeRO-1 pieces")
    if not same or not moments_equal or trainer.global_step != 1:
        fail("pipe x model zero1: the checkpoint did not restore in one "
             "process bit for bit")
    del trainer, saved, state
    torch.cuda.empty_cache()


def _pm_worlds(torch, worlds: dict, deadline: float):
    """Phase 21a and 21b over the started ``worlds``: the one-process
    references beside them, then each world's records, checks and gates
    (see :func:`phase_pipe_model`). Returns the GPipe, 1F1B and ZeRO-1
    records and the gates' gaps."""
    # the one-process references run beside the worlds (the card and the
    # host have room; their gates hold numbers, not times)
    try:
        ones = {kind: _pm_one_process(torch, kind)
                for kind in ("gpipe", "f32")}
    finally:
        _pp_join(worlds["quad"], deadline)
    runs = {k: _pm_records(k) for k in PM_WORLDS["quad"]}
    for kind, recs in runs.items():
        _pm_print(kind, recs)
        _pm_check(kind, recs)
    gp, ofob = runs["gpipe"], runs["1f1b"]
    same = all(a["digests"] == b["digests"] for a, b in zip(gp, ofob))
    same_losses = ([s["loss"] for s in gp[0]["steps"]]
                   == [s["loss"] for s in ofob[0]["steps"]])
    say(f"pipe x model: GPipe against 1F1B: losses "
        f"{[s['loss'] for s in gp[0]['steps']]} and "
        f"{[s['loss'] for s in ofob[0]['steps']]}; every rank's parameters "
        f"bit for bit: {same}; in flight {[r['in_flight'] for r in gp]} and "
        f"{[r['in_flight'] for r in ofob]}")
    if not (same and same_losses):
        fail("pipe x model: GPipe and 1F1B part")
    gates = {kind: _pm_gate(torch, kind, runs[kind], one)
             for kind, one in ones.items()}
    del ones
    _pp_join(worlds["octo"], deadline)
    zero = _pm_records("zero1")
    _pm_print("zero1", zero)
    _pm_check("zero1", zero)
    if any(len(r["steps"]) != 1 or r["opt_sharding"] != "zero1"
           for r in zero):
        fail("pipe x model zero1: not one ZeRO-1 step")
    return gp, ofob, gates, zero


def phase_pipe_model(torch):
    """Phase 21: pipeline stages of tensor-parallel layers on the card
    (``--mesh pipe:2,model:2``).

    21a. ``config/test_bert.cfg --seed 0 --ln_impl fused
    --train_batch_size 64 --batch_split 2 --test_batch_size 4`` (bert-base
    at full width and depth, dropout 0.1, 2 debug steps of 2 micro-batches
    of 32x512, 11 eval batches of 4 rows after each) as four ranks of
    ``cli.train`` on ``--mesh pipe:2,model:2`` (``--pm-worker quad``, gloo
    on the card: a rank holds 6 layers of 6 heads and 1536 MLP columns),
    under GPipe and then 1F1B in the same world, then in f32 at 2 layers on
    the plain attention and LayerNorm. GPipe and 1F1B must agree bit for
    bit (every parameter's digest on every rank, and the losses); GPipe
    (bf16) and f32 against this process at ``data:1`` on the same rows and
    the pipeline's dropout draws (:func:`_pm_one_process`): f32 within
    PM_F32_LOSS_RTOL (loss) and PM_F32_GRAD_REL (the whole gradient at the
    first clip), bf16 within PM_BF16_LOSS_RTOL (loss), its gradient gap
    recorded. Each rank's launches equal its stage's path, its model group
    took 2 forward and 2 backward all-reduces a layer through the host, its
    stage sent, and its groups are the JAX mesh's.

    21b. ``--mesh data:2,pipe:2,model:2 --optimizer_sharding zero1
    --sharded_checkpoint`` at 4 layers as eight ranks for one debug step,
    then its sharded save, which must peek ``mesh_axes`` {pipe: 2, data:
    2, model: 2}, the stage layout and ZeRO-1, and reload in one process
    bit for bit (:func:`_pm_reload`).

    Both worlds run at once (:func:`start_pipe_model_worlds`), and the
    one-process references beside them. Printed per
    rank: step walls and their stage and all-reduce seconds, both
    transports' sends, all-reduces, bytes and seconds, launches,
    parameter and moment bytes, peak CUDA memory. Returns the launch
    counts by path and the gates' gaps. (The kernels at a rank's shapes
    are phase 21c, :func:`_pm_kernels`, run by :func:`main` on the card
    alone.)"""
    t_phase = time.perf_counter()
    deadline = time.monotonic() + PM_DEADLINE_S
    worlds = start_pipe_model_worlds()
    try:
        gp, ofob, gates, zero = _pm_worlds(torch, worlds, deadline)
    finally:
        for procs in worlds.values():   # a failed gate leaves no rank
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    _pm_reload(torch, zero)
    say(f"phase 21 wall {time.perf_counter() - t_phase:.1f}s")
    total = lambda recs: {k: sum(r["launched"][k] for r in recs)
                          for k in recs[0]["launched"]}
    return {"pipe:2,model:2 gpipe": total(gp),
            "pipe:2,model:2 1f1b": total(ofob),
            "data:2,pipe:2,model:2 zero1": total(zero), "gates": gates}


def _pm_kernels(torch, ln, tp_kernels: dict, ln_t: dict) -> dict:
    """Phase 21c: the kernels at a ``pipe:2,model:2`` rank's shapes, on the
    card alone. The attention pair runs at a ``model:2`` rank's
    32x512x6x64 (a stage's layers are those layers): phase 20c's check and
    timings of this run (``tp_kernels``). The LayerNorm pair runs at the
    whole width (each LayerNorm of a rank acts on the all-reduced
    ``[32, 512, 768]``): held here against its plain version at 16384x768
    bf16, its timings phase 8's of this run (``ln_t``)."""
    h, gamma, beta, g = ln.seeded_inputs(16384, 768, torch.bfloat16, 21)
    y = ln.layer_norm_fwd_cuda(h, gamma, beta, LN_EPS, torch.bfloat16)
    ref = ln.layer_norm_plain(h, gamma, beta, LN_EPS, torch.bfloat16)
    got = ln.layer_norm_bwd_cuda(h, gamma, g, LN_EPS)
    want = ln.layer_norm_bwd_plain(h, gamma, g, LN_EPS)
    torch.cuda.synchronize()
    fwd_err = (y.float() - ref.float()).abs()
    ok = bool(((fwd_err / ln.fwd_limit(ref)).max() <= 1.0).item())
    dh = (got[0].float() - want[0].float()).abs()
    ok &= bool((dh <= ln.dh_limit(want[0])).all())
    ok &= all(ln.dparam_close(a, b) for a, b in zip(got[1:], want[1:]))
    bwd_err = max([dh.max().item()] + [(a - b).abs().max().item()
                                       for a, b in zip(got[1:], want[1:])])
    att = tp_kernels
    lf, lb = ln_t[(16384, 768, "fwd")], ln_t[(16384, 768, "bwd")]
    say(f"pipe x model 21c: a rank's attention pair at 32x512x6x64 bf16 "
        f"(phase 20c of this run): forward max_abs_err "
        f"{att['fwd_err']:.3e}, backward {att['bwd_err']:.3e}; kernel / "
        f"plain / sdpa ms fwd {att['fwd']['ms']:.4f} / "
        f"{att['fwd']['plain_ms']:.4f} / {att['fwd']['library_ms']:.4f}, "
        f"bwd {att['bwd']['ms']:.4f} / {att['bwd']['plain_ms']:.4f} / "
        f"{att['bwd']['library_ms']:.4f}; its LayerNorm pair at 16384x768 "
        f"bf16 against plain: forward max_abs_err "
        f"{fwd_err.max().item():.3e}, backward dh/dgamma/dbeta "
        f"{bwd_err:.3e} {'ok' if ok else 'FAIL'}; kernel / plain / "
        f"F.layer_norm ms fwd {lf['ms']:.4f} / {lf['plain_ms']:.4f} / "
        f"{lf['library_ms']:.4f}, bwd {lb['ms']:.4f} / {lb['plain_ms']:.4f}"
        f" / {lb['library_ms']:.4f} (phase 8 of this run)")
    if not ok:
        fail("pipe x model: a LayerNorm kernel disagrees with plain at a "
             "rank's shape")
    return dict(ln_fwd_err=fwd_err.max().item(), ln_bwd_err=bwd_err)


SIDE_DIR = OUT_DIR / "side"
SIDE_DEADLINE_S = 900
# the phases a side process runs, one after the other, by lane, and the
# main process's phases it runs beside: 19 and 20 beside 10 and 11, 21
# beside 12 and 13, 16 beside 15 and 17. No kernel time of the kernels
# line is taken beside a lane (phase 14 runs alone, phase 15's ring hop is
# timed after lane c joins), nor phase 18's drill, which holds a relaunch
# time; every other line printed by either process while a lane runs is
# marked contended (BESIDE), for the card and the host cores are shared
# then
SIDE_LANES = {"a": ((("pp", "phase_pipeline", "19"),
                     ("tp", "phase_tensor_parallel", "20")), "10 and 11"),
              "b": ((("pm", "phase_pipe_model", "21"),), "12 and 13"),
              "c": ((("rt", "phase_runtime", "16"),), "15 and 17")}


def _phases(numbers: str) -> str:
    """``"phase 21"`` or ``"phases 19 and 20"``."""
    return f"phase{'s' if ' ' in numbers else ''} {numbers}"


def _lane_phases(lane: str) -> str:
    """The phases of side lane ``lane``, as :func:`_phases` names them."""
    return _phases(" and ".join(n for _, _, n in SIDE_LANES[lane][0]))


def side_phases(lane: str, out: str) -> int:
    """The phases of side lane ``lane`` (SIDE_LANES) in a process of their
    own (``--side-phases LANE OUT``), which :func:`main` starts beside a
    stretch of its own phases: the kernel libraries loaded from the store
    phase 1 built, the lane's phases one after the other, each with its
    own launch counts (counts are a process's); their launch counts by
    path and the gates' gaps are written to ``out`` as JSON."""
    import torch

    from ml_recipe_tpu_torch.ops import cuda_build

    fa, ln, q8 = _register_kernels()
    cuda_build.build(fa.KERNEL.library, fa.BWD_KERNEL.library, ln.LIBRARY,
                     q8.KERNEL.library)
    t0 = time.perf_counter()
    result = {}
    phases, beside = SIDE_LANES[lane]
    BESIDE.append(f"the main process's {_phases(beside)}")
    for key, phase, number in phases:
        result[key] = globals()[phase](torch)
        say(f"phase {number} done {time.perf_counter() - t0:.1f}s into the "
            f"side process")
        torch.cuda.empty_cache()
    Path(out).write_text(json.dumps(result))
    return 0


def start_side_phases(lane: str):
    """:func:`side_phases` of ``lane`` started: ``(process, log, result
    path, lane)``."""
    import shutil

    lane_dir = SIDE_DIR / lane
    shutil.rmtree(lane_dir, ignore_errors=True)
    lane_dir.mkdir(parents=True)
    _vocab()
    out, log = lane_dir / "result.json", lane_dir / "side.log"
    proc = _spawn(["--side-phases", lane, out], log)
    # a failed main phase leaves no side process running
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    say(f"side lane {lane}: {_lane_phases(lane)} started beside "
        f"{_phases(SIDE_LANES[lane][1])}; the lines of either until it "
        f"joins are marked contended")
    BESIDE.append(_lane_phases(lane))
    return proc, log, out, lane


def join_side_phases(started) -> dict:
    """Wait for :func:`start_side_phases`'s process, print its output, and
    return its phases' results by key (SIDE_LANES); fails when it
    failed."""
    proc, log, out, lane = started
    _join({_lane_phases(lane): (proc, log)},
          time.monotonic() + SIDE_DEADLINE_S, "side phases")
    BESIDE.clear()
    for line in log.read_text().splitlines():
        if not line.startswith(("INFO", "WARNING", "DEBUG")):
            print(line, flush=True)
    return json.loads(out.read_text())


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
    t0 = t_start = time.perf_counter()

    def lap(phases: str) -> None:
        say(f"{phases} done {time.perf_counter() - t_start:.1f}s into the "
            f"smoke")

    native = start_native_build()
    built = cuda_build.build(*libraries)
    say(f"kernel build: {len(built)} of {len(libraries)} libraries built in "
        f"{time.perf_counter() - t0:.1f}s")
    finish_native_build(native, t0)
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
    lap("phases 1, 2, 5 and 7 (the kernels)")
    serving_fwd, bf16_burst, ids, bf16_ms = phase_serving(
        torch, fa, timings[SERVING_SHAPE]["ms"])
    int8 = phase_int8_serving(torch, bf16_burst, ids, bf16_ms)
    lap("phases 3 and 8 (serving)")
    del bf16_burst
    torch.cuda.empty_cache()
    train_fwd, train_bwd, xla_ms, xla_split = phase_training(torch, fa)
    ln_train = phase_ln_training(torch, xla_ms, xla_split)
    long = phase_long_training(torch)
    lap("phases 4, 9 and 6 (training)")
    torch.cuda.empty_cache()
    # phases 19 and 20 (gloo worlds of a few ranks each) run in a process
    # of their own beside phases 10 and 11
    side = start_side_phases("a")
    nq = phase_nq_corpus(torch)
    nq_train = phase_nq_training(torch, nq)
    nq_val = phase_nq_validate(torch, nq, nq_train.ckpt)
    nq_val8 = phase_nq_validate(torch, nq, nq_train.ckpt,
                                bf16=nq_val.candidates)
    nq_metrics = phase_nq_train_metrics(torch, nq, nq_train)
    lap("phase 10")
    torch.cuda.empty_cache()
    dp = phase_data_parallel(torch)
    lap("phase 11")
    side = join_side_phases(side)
    pp, tp = side["pp"], side["tp"]
    # 20c: the attention pair at a model:2 rank's shape, on the card alone
    tp["kernels"] = _tp_kernels(torch, fa, bw, flops)
    lap("phases 19 and 20 (beside phases 10 and 11)")
    torch.cuda.empty_cache()
    # phase 21 (gloo worlds of four and eight ranks) runs in a process of
    # its own beside phases 12 and 13
    side = start_side_phases("b")
    opt_run, opt_tune = phase_train_options(torch)
    lap("phase 12")
    torch.cuda.empty_cache()
    fleet_fwd = phase_fleet(torch)
    fleet8 = phase_fleet_int8(torch)
    lap("phase 13")
    torch.cuda.empty_cache()
    pm = join_side_phases(side)["pm"]
    # 21c: a pipe:2,model:2 rank's kernels, on the card alone
    pm["kernels"] = _pm_kernels(torch, ln, tp["kernels"], ln_t)
    lap("phase 21 (beside phases 12 and 13)")
    torch.cuda.empty_cache()
    # phase 14 times kernels for the kernels line: on the card alone
    packed = phase_packed_training(torch, nq, nq_train)
    packed_val = phase_packed_validate(torch, nq, packed.ckpt)
    lap("phase 14")
    torch.cuda.empty_cache()
    # phase 16 (CLI runs and a supervised drill) runs in a process of its
    # own beside phases 15 and 17
    side = start_side_phases("c")
    sp = phase_sequence_parallel(torch, fa, bw, flops)
    lap("phase 15")
    torch.cuda.empty_cache()
    warm = phase_warmup_plane(torch)
    lap("phase 17")
    torch.cuda.empty_cache()
    rt = join_side_phases(side)["rt"]
    lap("phase 16 (beside phases 15 and 17)")
    # 15b's ring hop timed on the card alone
    sp["hop"].update(_time_ring_hop(torch, fa, bw, flops))
    el = phase_elastic(torch)
    lap("phase 18")
    torch.cuda.empty_cache()

    def elastic_paths(kernel):
        return {path: n[kernel] for path, n in el.items() if path != "drill"}

    def pipe_paths(kernel):
        return {path: n[kernel] for path, n in pp.items()}

    def tp_paths(kernel):
        return {path: tp[path][kernel] for path in (
            "model:2 bf16", "model:2 one process", "data:2,model:2 zero1")}

    def pm_paths(kernel):
        return {path: pm[path][kernel] for path in (
            "pipe:2,model:2 gpipe", "pipe:2,model:2 1f1b",
            "data:2,pipe:2,model:2 zero1")}

    def warm_paths(kernel):
        return {f"warm-up plane, {path}": n[kernel]
                for path, n in warm.items() if n[kernel]}

    def runtime_paths(kernel):
        return {path: rt[path][kernel] for path in (
            "runtime instrumented", "runtime plain", "runtime untraced",
            "runtime supervised, attempt 2")}
    nq_fwd = {"nq training": nq_train.launched["fused_attention_fwd"],
              "validate": nq_val.launched["fused_attention_fwd"],
              "validate int8": nq_val8.launched["fused_attention_fwd"],
              "train_metrics": nq_metrics["fused_attention_fwd"]}

    def packed_paths(kernel):
        return {"packed training": packed.launched[kernel],
                "packed validate": packed_val["packed"].launched[kernel],
                "validate, phase 14 unpacked":
                    packed_val["unpacked"].launched[kernel]}

    def option_paths(kernel):
        return {"training options": opt_run[kernel],
                "fine-tune step": opt_tune[kernel]}

    def int8_paths(kernel):
        return {"serving int8": int8[kernel],
                "validate int8": nq_val8.launched[kernel],
                "serving int8 cached": fleet8[kernel],
                "warm-up plane, serving int8, graphs":
                    warm["serving int8, graphs"][kernel]}

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
    fwd_shapes["32x512 segmented"] = by_shape(
        packed.fwd, "segmented, rate 0.1, lse (the packed micro-batch's ids)")
    hop_config = ("ring hop: base (4096, 0), L_hash 8192, rate 0.1, lse "
                  "(config/longdoc.cfg, seq:2)")
    fwd_shapes[f"{sp['hop']['shape']} ring hop"] = by_shape(
        sp["hop"]["fwd"], hop_config)
    tp_config = ("a model:2 rank: 6 of 12 heads, rate 0.1 at its seed "
                 "offset, lse (config/test_bert.cfg --mesh model:2)")
    fwd_shapes["32x512x6x64 model:2 rank"] = by_shape(
        tp["kernels"]["fwd"], tp_config)
    bwd_shapes = {f"{TRAIN_SHAPE[0]}x{TRAIN_SHAPE[1]}": by_shape(bwd,
                                                                 "rate 0.1"),
                  "32x512 segmented": by_shape(
                      packed.bwd, "segmented, rate 0.1 (the packed "
                                  "micro-batch's ids)")}
    bwd_shapes.update({f"{B}x{L}": by_shape(t["bwd"], "rate 0.1")
                       for (B, L), t in long_t.items()})
    bwd_shapes[f"{sp['hop']['shape']} ring hop"] = by_shape(
        sp["hop"]["bwd"], hop_config.replace(", lse", ""))
    bwd_shapes["32x512x6x64 model:2 rank"] = by_shape(
        tp["kernels"]["bwd"], tp_config.replace(", lse", ""))
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
    # phase 15: long_context.cfg at W = 2 (zero1 and off) in the blocked
    # rows; longdoc.cfg's ring hops at 2x4096 with bases (seq:2) and its
    # one-process 2x8192 run in the streaming rows
    def blocked_paths(kernel):
        side = kernel.rsplit("_", 1)[1]     # long's runs count fwd / bwd
        return {"long_context": long["1024"][side],
                "long_context W=2, zero1 and off": sp["zero1"][kernel]}

    def stream_paths(kernel):
        side = kernel.rsplit("_", 1)[1]
        return {"long_context 4096 remat": long["4096 remat"][side],
                "longdoc seq:2 ring hops": sp["longdoc"][kernel],
                "longdoc data:1": sp["one"][kernel]}

    ring_err = dict(fwd=max(long_fwd_err, sp["hop"]["fwd_err"]),
                    bwd=max(long_bwd_err, sp["hop"]["bwd_err"]))
    long_kernels = [
        entry("fused_attention_fwd", "ml_recipe_tpu/ops/flash_attention.py:364",
              sum(blocked_paths("fused_attention_fwd").values()),
              long_fwd_err, blocked["fwd"], blocked_shape + ", lse",
              launches_by_path=blocked_paths("fused_attention_fwd"),
              **fwd_more),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_attention.py:305",
              sum(blocked_paths("fused_attention_bwd").values()),
              long_bwd_err, blocked["bwd"], blocked_shape,
              device_ms_by_kernel=blocked["bwd"]["split_ms"],
              launches_by_path=blocked_paths("fused_attention_bwd"),
              **bwd_more),
        entry("fused_attention_fwd", "ml_recipe_tpu/ops/flash_streaming.py:241",
              sum(stream_paths("fused_attention_fwd").values()),
              ring_err["fwd"], stream["fwd"], stream_shape + ", lse",
              launches_by_path=stream_paths("fused_attention_fwd"),
              **fwd_more),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_streaming.py:339",
              sum(stream_paths("fused_attention_bwd").values()),
              ring_err["bwd"], stream["bwd"], stream_shape,
              launches_by_path=stream_paths("fused_attention_bwd"), **shared),
        entry("fused_attention_bwd", "ml_recipe_tpu/ops/flash_streaming.py:374",
              sum(stream_paths("fused_attention_bwd").values()),
              ring_err["bwd"], stream["bwd"], stream_shape,
              launches_by_path=stream_paths("fused_attention_bwd"), **shared),
    ]
    ln_fwd, ln_bwd = ln_t[(16384, 768, "fwd")], ln_t[(16384, 768, "bwd")]
    ln_serve = ln_t[(12288, 768, "fwd")]
    q8_ffn = q8_t[(12288, 768, 3072)]
    new_kernels = [
        entry("layer_norm_fwd", "ml_recipe_tpu/ops/layer_norm.py:84",
              sum(int8_paths("layer_norm_fwd").values())
              + ln_train["layer_norm_fwd"] + dp["layer_norm_fwd"]
              + opt_run["layer_norm_fwd"] + opt_tune["layer_norm_fwd"]
              + packed.launched["layer_norm_fwd"]
              + sum(runtime_paths("layer_norm_fwd").values())
              + sum(elastic_paths("layer_norm_fwd").values())
              + sum(pipe_paths("layer_norm_fwd").values())
              + sum(tp_paths("layer_norm_fwd").values())
              + sum(pm_paths("layer_norm_fwd").values()),
              max(ln_fwd_err, pm["kernels"]["ln_fwd_err"]), ln_fwd,
              "16384x768 bf16 (32x512, training)",
              source="layer_norm",
              launches_by_path={**int8_paths("layer_norm_fwd"),
                                "training fused": ln_train["layer_norm_fwd"],
                                "data parallel": dp["layer_norm_fwd"],
                                **option_paths("layer_norm_fwd"),
                                "packed training":
                                    packed.launched["layer_norm_fwd"],
                                **runtime_paths("layer_norm_fwd"),
                                **elastic_paths("layer_norm_fwd"),
                                **pipe_paths("layer_norm_fwd"),
                                **tp_paths("layer_norm_fwd"),
                                **pm_paths("layer_norm_fwd")},
              device_ms=ln_fwd["device_ms"], host_ms=ln_fwd["host_ms"],
              at_32x384={k: ln_serve[k] for k in (
                  "ms", "device_ms", "host_ms", "plain_ms", "library_ms",
                  "bound_ms", "with_codes")}),
        entry("layer_norm_bwd", "ml_recipe_tpu/ops/layer_norm.py:96",
              ln_train["layer_norm_bwd"] + dp["layer_norm_bwd"]
              + opt_run["layer_norm_bwd"] + opt_tune["layer_norm_bwd"]
              + packed.launched["layer_norm_bwd"]
              + sum(runtime_paths("layer_norm_bwd").values())
              + sum(elastic_paths("layer_norm_bwd").values())
              + sum(pipe_paths("layer_norm_bwd").values())
              + sum(tp_paths("layer_norm_bwd").values())
              + sum(pm_paths("layer_norm_bwd").values()),
              max(ln_bwd_err, pm["kernels"]["ln_bwd_err"]),
              ln_bwd, "16384x768 bf16 (32x512, training)", source="layer_norm",
              launches_by_path={"training fused": ln_train["layer_norm_bwd"],
                                "data parallel": dp["layer_norm_bwd"],
                                **option_paths("layer_norm_bwd"),
                                "packed training":
                                    packed.launched["layer_norm_bwd"],
                                **runtime_paths("layer_norm_bwd"),
                                **elastic_paths("layer_norm_bwd"),
                                **pipe_paths("layer_norm_bwd"),
                                **tp_paths("layer_norm_bwd"),
                                **pm_paths("layer_norm_bwd")},
              device_ms=ln_bwd["device_ms"], host_ms=ln_bwd["host_ms"],
              device_ms_by_kernel=ln_bwd["split_ms"],
              by_shape={f"{N}x{C}": {k: t[k] for k in (
                  "ms", "device_ms", "host_ms", "split_ms", "plain_ms",
                  "library_ms", "bound_ms")}
                  for (N, C, kind), t in ln_t.items() if kind == "bwd"}),
        entry("q8_matmul", "ml_recipe_tpu/ops/quant_matmul.py:85",
              sum(int8_paths("q8_matmul").values()), q8_err,
              q8_ffn, "M=12288 K=768 N=3072, + bias, bf16 out (32x384 FFN in, "
              "int8 serving)", sass=q8_sass,
              launches_by_path=int8_paths("q8_matmul"),
              by_shape={f"{M}x{K}x{N}": t for (M, K, N), t in q8_t.items()}),
        entry("q8_quantize_rows",
              "none: port-only; the JAX package's quantize_rowwise "
              "(ml_recipe_tpu/ops/quant_matmul.py:62) is XLA, no pallas_call",
              sum(int8_paths("q8_quantize").values()),
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
                     + dp["fused_attention_fwd"]
                     + sum(option_paths("fused_attention_fwd").values())
                     + fleet_fwd + fleet8["fused_attention_fwd"]
                     + sum(packed_paths("fused_attention_fwd").values())
                     + sum(runtime_paths("fused_attention_fwd").values())
                     + sum(warm_paths("fused_attention_fwd").values())
                     + sum(elastic_paths("fused_attention_fwd").values())
                     + sum(pipe_paths("fused_attention_fwd").values())
                     + sum(tp_paths("fused_attention_fwd").values())
                     + sum(pm_paths("fused_attention_fwd").values())),
        "launches_by_path": {"serving": serving_fwd, "training": train_fwd,
                             "serving int8": int8["fused_attention_fwd"],
                             "training fused": ln_train["fused_attention_fwd"],
                             **nq_fwd,
                             "data parallel": dp["fused_attention_fwd"],
                             **option_paths("fused_attention_fwd"),
                             "fleet": fleet_fwd,
                             "serving int8 cached":
                                 fleet8["fused_attention_fwd"],
                             **packed_paths("fused_attention_fwd"),
                             **runtime_paths("fused_attention_fwd"),
                             **warm_paths("fused_attention_fwd"),
                             **elastic_paths("fused_attention_fwd"),
                             **pipe_paths("fused_attention_fwd"),
                             **tp_paths("fused_attention_fwd"),
                             **pm_paths("fused_attention_fwd")},
        "max_abs_err": max(fwd_err, packed.fwd_err,
                           packed_val["packed"].errs[0],
                           tp["kernels"]["fwd_err"]),
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
                     + dp["fused_attention_bwd"]
                     + sum(option_paths("fused_attention_bwd").values())
                     + packed.launched["fused_attention_bwd"]
                     + sum(runtime_paths("fused_attention_bwd").values())
                     + sum(warm_paths("fused_attention_bwd").values())
                     + sum(elastic_paths("fused_attention_bwd").values())
                     + sum(pipe_paths("fused_attention_bwd").values())
                     + sum(tp_paths("fused_attention_bwd").values())
                     + sum(pm_paths("fused_attention_bwd").values())),
        "launches_by_path": {"serving": 0, "training": train_bwd,
                             "training fused": ln_train["fused_attention_bwd"],
                             "nq training":
                                 nq_train.launched["fused_attention_bwd"],
                             "data parallel": dp["fused_attention_bwd"],
                             **option_paths("fused_attention_bwd"),
                             "packed training":
                                 packed.launched["fused_attention_bwd"],
                             **runtime_paths("fused_attention_bwd"),
                             **warm_paths("fused_attention_bwd"),
                             **elastic_paths("fused_attention_bwd"),
                             **pipe_paths("fused_attention_bwd"),
                             **tp_paths("fused_attention_bwd"),
                             **pm_paths("fused_attention_bwd")},
        "max_abs_err": max(bwd_err, packed.bwd_err,
                           packed_val["packed"].errs[1],
                           tp["kernels"]["bwd_err"]),
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
    if sys.argv[1:2] == ["--sp-worker"]:
        kind, rank, port = sys.argv[2:]
        sys.exit(sp_worker(kind, int(rank), int(port)))
    # phase 20 starts it as the ranks of its model groups
    if sys.argv[1:2] == ["--tp-worker"]:
        kind, rank, port = sys.argv[2:]
        sys.exit(tp_worker(kind, int(rank), int(port)))
    # phase 21 starts it as the ranks of its stages' model groups
    if sys.argv[1:2] == ["--pm-worker"]:
        kind, rank, port = sys.argv[2:]
        sys.exit(pm_worker(kind, int(rank), int(port)))
    # phases 19 and 20, and 21, run in processes of their own (main starts
    # them)
    if sys.argv[1:2] == ["--side-phases"]:
        sys.exit(side_phases(sys.argv[2], sys.argv[3]))
    # phase 19 starts it as the ranks of its pipelines
    if sys.argv[1:2] == ["--pp-worker"]:
        kind, rank, port = sys.argv[2:]
        sys.exit(pp_worker(kind, int(rank), int(port)))
    # phase 18 starts it as the two ranks of its ZeRO-1 pairs
    if sys.argv[1:2] == ["--el-worker"]:
        rank, port = sys.argv[2:]
        sys.exit(el_worker(int(rank), int(port)))
    # phase 17 starts it as its cold and warm engine processes
    if sys.argv[1:2] == ["--warm-engines"]:
        sys.exit(warm_engines(*sys.argv[2:]))
    sys.exit(main())
