"""Shared loader for the first-party C++ helper libraries (native/).

Single source of truth for the ``native/build/<lib>.so`` path resolution used
by both the tokenizer bindings (tokenizer/native.py) and the host-coordination
bindings (parallel/dist.py). Successful loads are cached per library name;
a missing .so is re-probed on each call so a ``make -C native`` mid-process
is picked up.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build",
)

_cache: Dict[str, ctypes.CDLL] = {}


def native_lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, name)


def load_native_lib(name: str) -> Optional[ctypes.CDLL]:
    """CDLL for ``native/build/<name>``, or None when not built."""
    if name in _cache:
        return _cache[name]
    path = native_lib_path(name)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    _cache[name] = lib
    return lib
