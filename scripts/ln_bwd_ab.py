#!/usr/bin/env python3
"""The port's LayerNorm backward against other builds of its source, in turns
on one card.

Run from the repository root on a machine with an NVIDIA GPU::

    python3 scripts/ln_bwd_ab.py --against OTHER/ml_recipe_tpu_torch/csrc/layer_norm.cu

``OTHER`` is another tree of the repository (another commit's, unpacked
with ``git archive`` into a git-ignored directory) or a copy of ``csrc/``
with a constant changed; its ``layer_norm.cu`` includes the ``rowwise.cuh``
beside it. ``ml_recipe_tpu_torch/csrc/layer_norm.cu`` and every
``--against`` source are built with the port's nvcc flags and loaded side
by side; each backward is held against ``layer_norm_bwd_plain`` at every
shape (within ``dh_limit``/``dparam_close``, and two launches bit-equal).
Then, shape by shape, the builds are timed in turns (this, the others, the
others again in reverse, this; ``--rounds`` times): device ms of all the
kernels of one launch, and of each of them, from a torch.profiler trace,
and ms per launch by CUDA events (the ctypes wrapper's host time
included). It prints the card's name and power limit, ptxas's registers
and spills of each backward kernel it built, then one JSON line per shape
with each build's medians. Exits non-zero without a CUDA device or when a
build disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# the training path's 32x384 and 32x512 rows at bert-base width, 133 row
# tiles, bert-large's width, and the f32 shapes of chip_smoke.py
SHAPES = ("12288x768:bf16,16384x768:bf16,8512x768:bf16,16384x1024:bf16,"
          "1000x768:f32,333x1024:f32")
DTYPES = {"bf16": "bfloat16", "f32": "float32"}


def _declare(lib) -> None:
    """The wrapper's declarations, or for a build that sizes its scratch
    by row tiles (``layer_norm_rows_per_tile``) a scratch row for every
    row, which covers any tiling."""
    import ctypes

    from ml_recipe_tpu_torch.ops import layer_norm as ln

    if hasattr(lib, "layer_norm_bwd_scratch_rows"):
        ln._declare(lib)
        return
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.layer_norm_bwd.argtypes = [vp] * 7 + [ci] * 4 + [cf, vp]
    lib.layer_norm_bwd.restype = ci
    lib.scratch_rows = 1 << 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another layer_norm.cu to build and time beside "
                         "this tree's (repeatable)")
    ap.add_argument("--shapes", default=SHAPES,
                    help="comma-separated NxC:bf16|f32 (default %(default)s)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="turns of every build in each direction per shape")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ln_bwd_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from ml_recipe_tpu_torch.ops import layer_norm as ln
    from ml_recipe_tpu_torch.ops.cuda_build import CudaLibrary, build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr}", flush=True)

    libraries = {"this": ln.LIBRARY}
    for path in args.against:
        libraries[path] = CudaLibrary(str(Path(path).resolve()), _declare)
    for lib in build(*libraries.values()):
        for kernel, report in smoke.ptxas_reports(lib.build_log):
            if kernel.startswith("layer_norm_bwd"):
                print(f"ptxas {lib.source} {kernel}: {report}", flush=True)
    loaded = {name: lib.lib() for name, lib in libraries.items()}
    order = list(loaded) + list(reversed(loaded))
    ok = True
    for spec in args.shapes.split(","):
        shape, tname = spec.split(":")
        N, C = (int(x) for x in shape.split("x"))
        h, gamma, _, g = ln.seeded_inputs(N, C, getattr(torch, DTYPES[tname]),
                                          N + C)
        want = ln.layer_norm_bwd_plain(h, gamma, g, smoke.LN_EPS)

        def launch():
            return ln.layer_norm_bwd_cuda(h, gamma, g, smoke.LN_EPS)

        agree, kernels = {}, {}
        for name, lib in loaded.items():
            ln.LIBRARY._lib = lib
            got, again = launch(), launch()
            torch.cuda.synchronize()
            # the names of the launch's kernels, from a trace of three
            kernels[name] = sorted({
                re.search(r"layer_norm_bwd\w*", e).group()
                for e, _, _ in smoke.device_trace(
                    torch, lambda: [launch() for _ in range(3)])
                if "layer_norm_bwd" in e})
            agree[name] = (
                bool(((got[0].float() - want[0].float()).abs()
                      <= ln.dh_limit(want[0])).all())
                and all(ln.dparam_close(a, b)
                        for a, b in zip(got[1:], want[1:]))
                and all(torch.equal(a, b) for a, b in zip(got, again)))
            ok = ok and agree[name]
        times = {name: dict(split=[], ms=[]) for name in loaded}
        for _ in range(args.rounds):
            for name in order:
                ln.LIBRARY._lib = loaded[name]
                times[name]["split"].append(smoke.profile_kernels(
                    torch, launch, kernels[name]))
                times[name]["ms"].append(smoke.time_ms(torch, launch))
        ln.LIBRARY._lib = loaded["this"]
        builds = {}
        for name, t in times.items():
            device = [sum(split.values()) for split in t["split"]]
            builds[name] = dict(
                agrees_with_plain=agree[name],
                device_ms=statistics.median(device),
                split_ms={k: statistics.median(split[k] for split in t["split"])
                          for k in kernels[name]},
                ms=statistics.median(t["ms"]), device_ms_runs=device,
                ms_runs=t["ms"])
        print(json.dumps({"shape": f"{N}x{C}", "dtype": tname,
                          "builds": builds}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
