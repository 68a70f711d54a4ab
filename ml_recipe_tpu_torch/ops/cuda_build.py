"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Every build and
every load goes through the store of built libraries (``ops/aot.py``), by
default in ``csrc/build/`` (git-ignored), else ``MLRT_AOT_CACHE`` or
``--aot_cache DIR``: a library is looked up by its name and the target
architecture, and validated by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags (``MLRT_AOT_SALT`` mixed in) and by the
torch, CUDA and ``nvcc`` versions, so a checkout builds its own kernels and
an edited source or header never loads a stale library. There is no
fallback: a missing ``nvcc`` or a failed build raises. With the store off
(``--aot_cache off``) this process builds every library it uses.

``build(*libraries)`` starts one ``nvcc`` per library that the store does
not hold, all at once, and waits for all of them, so a caller that needs
every kernel pays for the slowest build only. ``build_counts()`` says what
this process paid: every ``nvcc`` run is a miss, every library loaded as
the store held it a hit (a serving engine exports both, and a fleet's
rolling restart asserts that a replacement built nothing);
``load_events()`` lists each load with its seconds (the training telemetry
and goodput ledger record them). ``launch_scope`` and ``stream_of`` are
the wrappers' per-launch host work: no device switch when the tensor is on
the current device. ``Kernel.count`` is where a wrapper counts a launch: a
call made while its stream is being captured into a CUDA graph is no
launch, and is counted apart (``captured``) for the graph's owner to add on
each replay.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from . import aot

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"

ARCH = "sm_90a"
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


_NVCC_VERSION: Optional[str] = None


def nvcc_version() -> str:
    """The release line of ``nvcc --version`` (memoized), ``none`` without
    an ``nvcc``: a component of the store's and the tuning cache's keys."""
    global _NVCC_VERSION
    if _NVCC_VERSION is None:
        try:
            out = subprocess.run([find_nvcc(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [ln for ln in out.splitlines() if "release" in ln]
            _NVCC_VERSION = (lines[-1].split("release", 1)[1].strip()
                             if lines else "unknown")
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _NVCC_VERSION = "none"
    return _NVCC_VERSION


def build_counts() -> Dict[str, int]:
    """This process's kernel builds, from the store's session: ``misses``,
    the ``nvcc`` runs (the store on or off); ``hits``, the libraries loaded
    from the store without one."""
    summary = aot.get().session_summary()
    return {"hits": summary["hits"],
            "misses": summary["misses"] + summary["bypass"]}


def load_events() -> List[tuple]:
    """``(outcome, seconds)`` of every library taken in this process, in
    order, from the store's session: ``"hit"`` for a library the store
    held, ``"miss"`` for one this process built; ``seconds`` from the first
    use to the library's bytes (the ``nvcc`` run included when the first
    use started it). The training telemetry's ``train_aot_*`` series read
    them."""
    return [("hit" if e["outcome"] == "hit" else "miss", e["seconds"])
            for e in aot.get().session_summary()["events"]]


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


# this process's scratch directory for nvcc outputs and the libraries it
# loads (each file is removed as soon as it is read or loaded)
_SCRATCH: Optional[str] = None
_SCRATCH_IDS = itertools.count()


def _scratch_file(stem: str) -> Path:
    global _SCRATCH
    if _SCRATCH is None:
        _SCRATCH = tempfile.mkdtemp(prefix="mlrt_cuda_")
        atexit.register(shutil.rmtree, _SCRATCH, True)
    return Path(_SCRATCH) / f"{stem}-{next(_SCRATCH_IDS)}.so"


class CudaLibrary:
    """One ``csrc/<source>`` built into a ctypes library on first use.

    ``declare`` sets ``argtypes``/``restype`` on the loaded library; ``blob``
    keeps the loaded library's bytes (a disassembler reads them)."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = CSRC_DIR / source
        self.name = self.source.stem
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        self.blob: Optional[bytes] = None
        # the store outcome of this process's load: 'hit', 'miss' (nvcc
        # built it, the store on) or 'bypass' (built, the store off)
        self.outcome: Optional[str] = None
        self._t0: Optional[float] = None
        # _start's lookup in the store, handed to _take (read once per load)
        self._looked_up: Optional[tuple] = None

    @property
    def built(self) -> bool:
        """nvcc built this library in this process (its load is no hit)."""
        return self.outcome in ("miss", "bypass")

    def code(self) -> str:
        """Hash of the source, the shared headers and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def _start(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this library, or return None when it is
        loaded or taken already, or the store holds it."""
        if self._lib is not None or self.blob is not None:
            return None
        if self._t0 is None:
            self._t0 = time.perf_counter()
        store = aot.get()
        if store.enabled and self._looked_up is None:
            self._looked_up = store.lookup(
                self.name, store.fingerprint(self.code(), ARCH))
            if self._looked_up[0] is not None:
                return None
        tmp = _scratch_file(self.name)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def _finish(self, proc: subprocess.Popen) -> bytes:
        """The built library's bytes, once ``proc`` ends; raises on a
        failed build."""
        out, _ = proc.communicate()
        self.build_log = out
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        try:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} (exit "
                                   f"{proc.returncode}):\n{out}")
            return tmp.read_bytes()
        finally:
            tmp.unlink(missing_ok=True)

    def _take(self, proc: Optional[subprocess.Popen]) -> None:
        """The library's bytes through the store: its copy found by
        ``_start``, or the build ``proc`` runs."""
        looked_up, self._looked_up = self._looked_up, None
        self.blob, self.outcome, _ = aot.get().load_or_build_ex(
            self.name, lambda: self._finish(proc or self._start()),
            code=self.code(), arch=ARCH, looked_up=looked_up,
            started=self._t0)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if the store does not hold it."""
        with self._lock:
            if self._lib is None:
                if self._t0 is None:
                    self._t0 = time.perf_counter()
                if self.blob is None:
                    build(self)
                path = _scratch_file(self.name)
                path.write_bytes(self.blob)
                try:
                    lib = ctypes.CDLL(str(path))
                finally:
                    path.unlink(missing_ok=True)   # the mapping stays
                self._declare(lib)
                self._lib = lib
            return self._lib


class Kernel:
    """A kernel of a built library and the count of its launches: its
    wrapper calls :meth:`count` where it launches the kernel, and nowhere
    else."""

    def __init__(self, library: CudaLibrary):
        self.library = library
        self.launches = 0
        # calls recorded into a CUDA graph under capture (not launches: the
        # graph's replays launch them)
        self.captured = 0

    def count(self) -> None:
        try:
            capturing = torch.cuda.is_current_stream_capturing()
        except Exception:  # noqa: BLE001 - a CPU-only build captures nothing
            capturing = False
        if capturing:
            self.captured += 1
        else:
            self.launches += 1


def build(*libraries: CudaLibrary) -> List[CudaLibrary]:
    """Build every library that the store does not hold and that is not
    built yet, one ``nvcc`` each, all started together. Returns the
    libraries that were built now."""
    pending = [(lib, lib._start()) for lib in libraries
               if lib._lib is None and lib.blob is None]
    built, errors = [], []
    for lib, proc in pending:  # every nvcc ends before anything raises
        try:
            lib._take(proc)
        except RuntimeError as exc:
            errors.append(str(exc))
            continue
        if lib.built:
            built.append(lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return built
