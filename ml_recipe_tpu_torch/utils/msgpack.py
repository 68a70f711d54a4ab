"""A small pure-Python msgpack codec for the JAX package's checkpoints.

The JAX package writes checkpoints with ``flax.serialization.msgpack_serialize``
and reads them with ``msgpack_restore``; the port reads and writes the same
bytes without ``msgpack`` or ``flax`` installed. Covered: nil, bool, int,
float, str, bin, array, map, and flax's ext types — 1, a numpy array as
msgpack ``(shape, dtype name, C-order bytes)``, and 3, a numpy scalar in the
same encoding — plus flax's chunked-array dicts for arrays past its chunk
size (:data:`MAX_CHUNK_SIZE` bytes). A ``bfloat16`` array is read as
float32 (numpy has no bf16; the widening is exact).
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30   # flax.serialization.MAX_CHUNK_SIZE, in bytes


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


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n <= 0x7F or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"),
                                 ((1 << 64) - 1, 0xCF, ">Q")):
            if n <= limit:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise MsgpackError(f"int {n} does not fit msgpack's 64 bits")
    else:
        for limit, code, fmt in ((-(1 << 7), 0xD0, ">b"), (-(1 << 15), 0xD1, ">h"),
                                 (-(1 << 31), 0xD2, ">i"), (-(1 << 63), 0xD3, ">q")):
            if n >= limit:
                out += bytes([code]) + struct.pack(fmt, n)
                return
        raise MsgpackError(f"int {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix_base: Optional[int], fix_max: int, codes, out) -> None:
    """A container/str/bin header: the fix form when it exists and fits,
    else the 8/16/32-bit length form (``codes``: None or the 8-bit code,
    then the 16- and 32-bit codes)."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        out += bytes([c8, n])
    elif n <= 0xFFFF:
        out += bytes([c16]) + struct.pack(">H", n)
    else:
        out += bytes([c32]) + struct.pack(">I", n)


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n]]) + struct.pack(">b", code)
    elif n <= 0xFF:
        out += bytes([0xC7, n]) + struct.pack(">b", code)
    elif n <= 0xFFFF:
        out += bytes([0xC8]) + struct.pack(">Hb", n, code)
    else:
        out += bytes([0xC9]) + struct.pack(">Ib", n, code)
    out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError(f"cannot pack an array of dtype {arr.dtype}")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an array past :data:`MAX_CHUNK_SIZE`."""
    size = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
        else:
            _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for value in obj:
            _pack(value, out)
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as ``flax.serialization.msgpack_serialize`` would:
    numpy arrays and scalars as flax's ext types, arrays past
    :data:`MAX_CHUNK_SIZE` bytes in flax's chunked form."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)
