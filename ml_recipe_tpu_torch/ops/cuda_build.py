"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``csrc/build/`` (git-ignored), under a name keyed
by a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so a checkout builds its own kernels and an edited source or header never
loads a stale library. There is no
fallback: a missing ``nvcc`` or a failed build raises.

``build(*libraries)`` starts one ``nvcc`` per source at once and waits for
all of them, so a caller that needs every kernel pays for the slowest build
only. ``build_counts()`` says what this process paid: every ``nvcc`` run is
a miss, every library loaded as it was found in ``csrc/build/`` a hit (a
serving engine exports both, and a fleet's rolling restart asserts that a
replacement built nothing). ``launch_scope`` and ``stream_of`` are the wrappers' per-launch host
work: no device switch when the tensor is on the current device.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills of every kernel, kept in
    # CudaLibrary.build_log
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises when there is none."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        f"{CSRC_DIR} at first use and need the CUDA toolkit"
    )


_COUNTS_LOCK = threading.Lock()
_COUNTS = {"hits": 0, "misses": 0}


def _count(kind: str) -> None:
    with _COUNTS_LOCK:
        _COUNTS[kind] += 1


def build_counts() -> Dict[str, int]:
    """This process's kernel builds: ``misses``, the ``nvcc`` runs;
    ``hits``, the libraries loaded from ``csrc/build/`` without one."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


_NO_SCOPE = contextlib.nullcontext()


def launch_scope(device: torch.device):
    """The context a launch on ``device`` runs in: nothing to enter when
    ``device`` is the current device (the serving and training paths), else
    ``torch.cuda.device(device)``."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _NO_SCOPE
    return torch.cuda.device(device)


# the current stream's raw handle without building a Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_of(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream, as the launch
    functions take it."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class CudaLibrary:
    """One ``csrc/<source>`` built into a ctypes library on first use.

    ``declare`` sets ``argtypes``/``restype`` on the loaded library."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC_DIR / source
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        # nvcc built this library in this process (its load is no hit)
        self.built = False

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def _start(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source, or return None when the library
        for this exact source is already built."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _count("misses")
        return proc

    def _finish(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n{out}")
        os.replace(tmp, self.path)  # atomic: no half-written library
        self.built = True

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                if not self.path.exists():
                    build(self)
                lib = ctypes.CDLL(str(self.path))
                self._declare(lib)
                self._lib = lib
                if not self.built:
                    _count("hits")
            return self._lib


class Kernel:
    """A kernel of a built library and the count of its launches: its
    wrapper adds one where it launches the kernel, and nowhere else."""

    def __init__(self, library: CudaLibrary):
        self.library = library
        self.launches = 0


def build(*libraries: CudaLibrary) -> List[CudaLibrary]:
    """Build every library that is not built yet, one ``nvcc`` each, all
    started together. Returns the libraries that were built now."""
    started = [(lib, lib._start()) for lib in libraries]
    built, errors = [], []
    for lib, proc in started:  # every nvcc ends before anything raises
        if proc is None:
            continue
        try:
            lib._finish(proc)
            built.append(lib)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return built
