#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``ml_recipe_tpu_torch``) on one GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, and no result line):

1. the card's name and power limit (``nvidia-smi``), and the build of every
   hand-written kernel from ``ml_recipe_tpu_torch/csrc`` (one ``nvcc`` per
   source, started together);
2. every kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (bert-base: 12 heads of 64, bf16), with
   key masks, segments, dropout and the logsumexp output; then timings by
   CUDA events (median of several runs) of the kernel, the plain version
   and one PyTorch library call computing the same function, beside the
   least time the card could take (``bound_ms``);
3. the serving path at full width: ``config/serve.cfg`` through the
   parsers, ``compose.init_model`` (bert-base-uncased, 12 layers, bf16,
   seeded random weights, a synthetic vocab), ``QAEngine`` over the
   ``8x128,8x384,32x384`` grid, warmup and ``QAServer`` on port 0, then
   concurrent ``POST /v1/qa`` requests reaching both seq buckets and a full
   32-row batch. Launch counts are set to 0 just before this phase and read
   just after: every kernel must have run, and attention exactly 12 times
   per device batch. One full batch is scored again with the plain
   attention and must agree.

It then prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line. Without CUDA, or outside a checkout
of the repository, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chip_smoke_out"     # the synthetic vocab (git-ignored)

H, D = 12, 64                      # bert-base attention heads
SHAPES = [(8, 128), (8, 384), (32, 384), (2, 200)]   # (B, L); 2x200 ragged
SERVING_SHAPE = (32, 384)          # the shape the kernels line reports
# kernel vs plain, per output type. bf16: the kernel rounds each
# probability to bf16 against its running row max, the plain version
# against the final max (2**-9 relative each), and both round the output
# to bf16 (2**-9 relative); |out| < 4 here, so a few bf16 ulps.
ATOL = {"bf16": 3e-2, "f32": 1e-4}
LSE_ATOL = 1e-3   # f32 logsumexp of O(10) scores, summed in other orders
# the full 12-layer model, kernel vs plain attention in bf16: attention
# outputs differ by bf16 ulps and 12 post-LN layers carry that into O(1)
# logits; span ids must match wherever the top-2 margin exceeds this
SCORE_ATOL = 0.25

# published peaks per H100 part (NVIDIA data sheets; dense bf16 tensor-core
# rate, device-memory rate); matched against the nvidia-smi name
PEAKS = [("PCIe", 2.0e12, 756e12), ("NVL", 3.9e12, 835e12),
         ("H100", 3.35e12, 989e12)]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    fail(f"no peak rates known for card {name!r}")


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


def phase_kernels(torch, fa, bw, flops):
    """Kernel against plain version at the serving shapes, then timings."""
    import numpy as np

    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    results, max_err = {}, 0.0

    def inputs(B, L, dtype):
        q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D),
                                                        dtype=np.float32))
                   .to("cuda", dtype) for _ in range(3))
        mask = (rng.random((B, L)) > 0.2).astype(np.int32)
        mask[:, 0] = 1
        seg = np.zeros((B, L), np.int32)
        for b in range(B):  # three packed segments, then padding
            c1, c2, c3 = sorted(rng.choice(np.arange(1, L), 3, replace=False))
            seg[b, :c1], seg[b, c1:c2], seg[b, c2:c3] = 1, 2, 3
        seeds = fa.row_seeds(torch.from_numpy(
            rng.integers(-2**31, 2**31 - 1, B).astype(np.int32)), B, H, "cuda")
        return (q, k, v, torch.from_numpy(mask).cuda(),
                torch.from_numpy(seg).cuda(), seeds)

    cases = [
        ("mask", dict()),
        ("mask+dropout+lse", dict(rate=0.1, want_lse=True)),
        ("segmented+lse", dict(segmented=True, want_lse=True)),
        ("segmented+dropout", dict(segmented=True, rate=0.1)),
    ]
    runs = [(B, L, torch.bfloat16, "bf16", cases) for B, L in SHAPES]
    runs += [(2, 200, torch.float32, "f32", cases),
             (8, 128, torch.float32, "f32", cases[1:2])]
    for B, L, dtype, tname, run_cases in runs:
        q, k, v, mask, seg, seeds = inputs(B, L, dtype)
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
        # timings of the serving configuration: key mask, rate 0, no lse
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        bool_mask = (mask > 0)[:, None, None, :]
        kernel_ms = time_ms(torch, lambda: fa.fused_attention_cuda(q, k, v, mask))
        plain_ms = time_ms(torch, lambda: fa.fused_attention_plain(q, k, v, mask))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bool_mask))
        n_bytes = 4 * B * L * H * D * q.element_size() + mask.numel() * 4
        n_ops = 4 * B * H * L * L * D
        bound_ms = max(n_bytes / bw, n_ops / flops) * 1e3
        bound_by = "bytes" if n_bytes / bw >= n_ops / flops else "operations"
        results[(B, L)] = dict(ms=kernel_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
        say(f"timing fused_attention_fwd {B}x{L}x{H}x{D} bf16: "
            f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(sdpa)={library_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; {n_bytes} B, {n_ops} ops)")
    return results, max_err


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


def phase_serving(torch, fa, kernel_ms):
    """The serving path at full width; returns the attention launch count.
    ``kernel_ms``: the kernel's time at 32x384, for the forward's breakdown."""
    import numpy as np

    from ml_recipe_tpu_torch.compose import init_model
    from ml_recipe_tpu_torch.config.parser import (
        check_serve_flags, get_model_parser, get_params, get_serve_parser)
    from ml_recipe_tpu_torch.data import (
        assemble_input_ids, encode_document, labels2id, window_chunks)
    from ml_recipe_tpu_torch.infer.score import OUT_KEYS
    from ml_recipe_tpu_torch.serve.bucketing import BucketGrid
    from ml_recipe_tpu_torch.serve.engine import QAEngine
    from ml_recipe_tpu_torch.serve.server import QAServer
    from ml_recipe_tpu_torch.tokenizer import write_synthetic_bert_vocab

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    vocab = write_synthetic_bert_vocab(OUT_DIR / "vocab.txt")
    _, (params, model_params) = get_params(
        (get_serve_parser, get_model_parser),
        ["-c", str(REPO / "config" / "serve.cfg"), "--vocab_file", vocab,
         "--port", "0"])
    check_serve_flags(params, model_params)
    t0 = time.perf_counter()
    model, tokenizer = init_model(model_params, checkpoint=params.checkpoint)
    say(f"serving: {model_params.model} {model.cfg.num_layers} layers "
        f"hidden {model.cfg.hidden_size} {model.dtype} on {model.device}, "
        f"built in {time.perf_counter() - t0:.1f}s")
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

    fa.KERNEL.launches = 0          # the main path starts here
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
    launches = fa.KERNEL.launches   # the main path ends here
    batches = int(engine.m_batches.value)
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
    say(f"serving: {len(results)} requests ({n_chunks} chunks) answered 200 "
        f"in {wall:.2f}s; {batches} traffic batches (seq, rows) {seen} "
        f"taking {batch_ms} ms + "
        f"{len(warm['buckets'])} warmup batches; warmup seconds "
        f"{warm['bucket_seconds']}")
    say(f"serving: request latency ms p50={statistics.median(lat):.1f} "
        f"p95={np.percentile(lat, 95):.1f} max={max(lat):.1f}")
    layers = model.cfg.num_layers
    say(f"serving: attention launches={launches}, expected {layers} x "
        f"{device_batches} device batches = {layers * device_batches}")
    if launches != layers * device_batches:
        fail(f"attention launch count is not {layers} per device batch")
    if len(seen) != batches or (384, 32) not in seen or \
            {seq for seq, _ in seen} != {128, 384}:
        fail("traffic did not reach both seq buckets and a full 32-row batch")

    # one full 32x384 batch, kernel attention vs plain attention
    tokens, _, _ = encode_document(tokenizer, requests[-1][1])
    enc_q = tokenizer.encode(requests[-1][0])[:params.max_question_len]
    records = window_chunks(tokens, ("unknown", -1, -1),
                            question_len=len(enc_q), max_seq_len=384,
                            doc_stride=params.doc_stride)
    if len(records) < 32:
        fail(f"the long document windows into {len(records)} < 32 chunks")
    ids = np.full((32, 384), tokenizer.pad_token_id, np.int32)
    for i, rec in enumerate(records[:32]):
        row = assemble_input_ids(tokenizer.cls_token_id,
                                 tokenizer.sep_token_id, enc_q, rec)
        ids[i, :len(row)] = row
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
    profile_forward(torch, lambda: engine._score(wire))
    return launches


def profile_forward(torch, forward, reps: int = 5) -> None:
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
        say("serving: profile of the 32x384 forward: not measured (the "
            "trace holds no device events)")
        return
    family_us = {"attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, start, end in spans:
        if "fused_attention_fwd" in name:
            family = "attention"
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
    say(f"serving: profile of the 32x384 forward, device ms per call: "
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
    bw, flops = card_peaks(name)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; "
        f"peaks used for bound_ms: {bw / 1e12:g} TB/s, {flops / 1e12:g} "
        f"TFLOP/s bf16")

    libraries = [fa.KERNEL.library]
    t0 = time.perf_counter()
    built = cuda_build.build(*libraries)
    say(f"kernel build: {len(built)} of {len(libraries)} libraries built in "
        f"{time.perf_counter() - t0:.1f}s")
    for lib in built:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {lib.source.name}: {line.strip()}")

    timings, max_err = phase_kernels(torch, fa, bw, flops)
    t = timings[SERVING_SHAPE]
    launches = phase_serving(torch, fa, t["ms"])
    say(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "ml_recipe_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "ml_recipe_tpu/ops/flash_attention.py:129",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
