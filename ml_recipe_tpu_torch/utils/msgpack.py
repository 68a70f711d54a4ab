"""A small pure-Python msgpack decoder for the JAX package's checkpoints.

The JAX package writes checkpoints with ``flax.serialization.msgpack_serialize``;
the port reads them without ``msgpack`` or ``flax`` installed. Covered:
nil, bool, int, float, str, bin, array, map, and flax's ext types — 1, a
numpy array as msgpack ``(shape, dtype name, C-order bytes)``, and 3, a
numpy scalar in the same encoding — plus flax's chunked-array dicts for
arrays past its chunk size. A ``bfloat16`` array is returned as float32
(numpy has no bf16; the widening is exact).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Malformed or unsupported msgpack input."""


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, data = unpackb(payload, unchunk=False)
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        bits = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack input")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise MsgpackError(f"unsupported msgpack ext type {code}")

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B")[0])),
            0xC5: lambda: bytes(self.take(self.unpack(">H")[0])),
            0xC6: lambda: bytes(self.take(self.unpack(">I")[0])),
            0xC7: lambda: self._ext_sized(">B"),
            0xC8: lambda: self._ext_sized(">H"),
            0xC9: lambda: self._ext_sized(">I"),
            0xCA: lambda: self.unpack(">f")[0],
            0xCB: lambda: self.unpack(">d")[0],
            0xCC: lambda: self.unpack(">B")[0],
            0xCD: lambda: self.unpack(">H")[0],
            0xCE: lambda: self.unpack(">I")[0],
            0xCF: lambda: self.unpack(">Q")[0],
            0xD0: lambda: self.unpack(">b")[0],
            0xD1: lambda: self.unpack(">h")[0],
            0xD2: lambda: self.unpack(">i")[0],
            0xD3: lambda: self.unpack(">q")[0],
            0xD4: lambda: self._ext_fixed(1),
            0xD5: lambda: self._ext_fixed(2),
            0xD6: lambda: self._ext_fixed(4),
            0xD7: lambda: self._ext_fixed(8),
            0xD8: lambda: self._ext_fixed(16),
            0xD9: lambda: str(self.take(self.unpack(">B")[0]), "utf-8"),
            0xDA: lambda: str(self.take(self.unpack(">H")[0]), "utf-8"),
            0xDB: lambda: str(self.take(self.unpack(">I")[0]), "utf-8"),
            0xDC: lambda: self.array(self.unpack(">H")[0]),
            0xDD: lambda: self.array(self.unpack(">I")[0]),
            0xDE: lambda: self.map(self.unpack(">H")[0]),
            0xDF: lambda: self.map(self.unpack(">I")[0]),
        }
        if t not in simple:
            raise MsgpackError(f"unsupported msgpack type byte 0x{t:02x}")
        return simple[t]()

    def _ext_sized(self, fmt: str) -> Any:
        n = self.unpack(fmt)[0]
        code = self.unpack(">b")[0]
        return self.ext(code, n)

    def _ext_fixed(self, n: int) -> Any:
        code = self.unpack(">b")[0]
        return self.ext(code, n)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(tree: Any) -> Any:
    """Reassemble flax's chunked-array dicts (``{"__msgpack_chunked_array__":
    True, "shape": {"0": d0, ...}, "chunks": {"0": flat0, ...}}``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes, *, unchunk: bool = True) -> Any:
    """Decode one msgpack object from ``data`` (all of it)."""
    reader = _Reader(data)
    obj = reader.value()
    if reader.pos != len(reader.buf):
        raise MsgpackError(
            f"{len(reader.buf) - reader.pos} trailing bytes after the object")
    return _unchunk(obj) if unchunk else obj
