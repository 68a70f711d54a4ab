"""ctypes bindings for the C++ WordPiece backend (native/qatok).

The shared library is built with ``make -C native`` (g++, no deps). When the
.so is absent this module reports unavailable and the pure-Python
implementation serves — behaviour is identical either way: the native path
only ever receives ASCII text, where its semantics are exactly the Python
spec's (see native/qatok/wordpiece.cc header).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from ..utils.nativelib import load_native_lib

    lib = load_native_lib("libqatok.so")
    if lib is None:
        return None
    lib.qatok_wordpiece_new.restype = ctypes.c_void_p
    lib.qatok_wordpiece_new.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
    lib.qatok_wordpiece_free.argtypes = [ctypes.c_void_p]
    lib.qatok_vocab_size.restype = ctypes.c_int32
    lib.qatok_vocab_size.argtypes = [ctypes.c_void_p]
    lib.qatok_token_to_id.restype = ctypes.c_int32
    lib.qatok_token_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.qatok_wordpiece_encode.restype = ctypes.c_int32
    lib.qatok_wordpiece_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    lib.qatok_bpe_new.restype = ctypes.c_void_p
    lib.qatok_bpe_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.qatok_bpe_free.argtypes = [ctypes.c_void_p]
    lib.qatok_bpe_vocab_size.restype = ctypes.c_int32
    lib.qatok_bpe_vocab_size.argtypes = [ctypes.c_void_p]
    lib.qatok_bpe_token_to_id.restype = ctypes.c_int32
    lib.qatok_bpe_token_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.qatok_bpe_encode.restype = ctypes.c_int32
    lib.qatok_bpe_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _encode_ids(lib_fn, handle, tls, text: str) -> List[int]:
    """Shared ctypes encode protocol: per-thread buffer (the loaders encode
    from a ThreadPoolExecutor and ctypes releases the GIL during the C call —
    a shared buffer races), NUL stripped (cannot cross the C-string boundary;
    the facade routes NUL-bearing texts to the Python path), grow-and-retry
    when the buffer is too small."""
    if not hasattr(tls, "buf"):
        tls.cap = 8192
        tls.buf = (ctypes.c_int32 * tls.cap)()

    raw = text.encode().replace(b"\x00", b"")
    n = lib_fn(handle, raw, tls.buf, tls.cap)
    if n < 0:  # grow and retry
        tls.cap = max(-n, tls.cap * 2)
        tls.buf = (ctypes.c_int32 * tls.cap)()
        n = lib_fn(handle, raw, tls.buf, tls.cap)
    return list(tls.buf[:n])


class NativeWordPiece:
    """Handle on a loaded C++ WordPiece vocab. ASCII text only — callers
    route non-ASCII to the Python implementation."""

    def __init__(self, vocab_file: str, *, lowercase: bool = True,
                 handle_chinese_chars: bool = False, unk_token: str = "[UNK]"):
        # handle_chinese_chars only affects CJK codepoints, which are
        # non-ASCII and therefore always routed to the Python path — the flag
        # is accepted for facade symmetry and has no native effect.
        del handle_chinese_chars
        lib = _load()
        if lib is None:
            raise RuntimeError("native qatok library not built (make -C native)")
        self._lib = lib
        self._handle = lib.qatok_wordpiece_new(
            vocab_file.encode(), int(lowercase), unk_token.encode()
        )
        if not self._handle:
            raise RuntimeError(
                f"qatok could not load vocab {vocab_file!r} (missing file or "
                f"missing {unk_token!r} entry)"
            )
        import threading

        self._tls = threading.local()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.qatok_wordpiece_free(handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.qatok_vocab_size(self._handle))

    def token_to_id(self, token: str) -> Optional[int]:
        i = int(self._lib.qatok_token_to_id(self._handle, token.encode()))
        return None if i < 0 else i

    def encode(self, text: str) -> List[int]:
        # NUL-stripping here IS the spec: the Python pipeline drops it too
        # (wordpiece.py:87 cp == 0).
        return _encode_ids(
            self._lib.qatok_wordpiece_encode, self._handle, self._tls, text
        )


class NativeByteLevelBPE:
    """Handle on a loaded C++ byte-level BPE (vocab.json + merges.txt).
    ASCII text only, no BPE-dropout — callers route non-ASCII or stochastic
    encodes to the Python implementation."""

    def __init__(self, vocab_file: str, merges_file: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native qatok library not built (make -C native)")
        self._lib = lib
        self._handle = lib.qatok_bpe_new(vocab_file.encode(), merges_file.encode())
        if not self._handle:
            raise RuntimeError(
                f"qatok could not load BPE files {vocab_file!r} / {merges_file!r}"
            )
        import threading

        self._tls = threading.local()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.qatok_bpe_free(handle)
            self._handle = None

    def __len__(self) -> int:
        return int(self._lib.qatok_bpe_vocab_size(self._handle))

    def token_to_id(self, token: str) -> Optional[int]:
        i = int(self._lib.qatok_bpe_token_to_id(self._handle, token.encode()))
        return None if i < 0 else i

    def encode(self, text: str) -> List[int]:
        # NUL diverges from the Python spec here (byte-level BPE encodes byte
        # 0 as a real token) — the facade routes NUL-bearing texts to the
        # Python path; the helper's strip is only a belt against direct calls.
        return _encode_ids(
            self._lib.qatok_bpe_encode, self._handle, self._tls, text
        )
