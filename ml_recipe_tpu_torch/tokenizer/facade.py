"""Uniform tokenizer facade.

Parity target: reference ``modules/model/model/tokenizer.py:8-93`` — one class
selecting WordPiece (BERT special tokens ``[PAD]/[SEP]/[CLS]/[UNK]``) or
byte-level BPE (RoBERTa ``<pad>/</s>/<s>/<unk>``) with a uniform
``encode``/``decode``/token-id-property API and optional BPE dropout.

Backend selection: the C++ implementation (``native/qatok``) is used when its
shared library has been built (~10x faster WordPiece, identical output);
otherwise the pure-Python implementations in this package serve as both the
behavioural spec and the fallback.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from .bpe import ByteLevelBPETokenizer
from .wordpiece import WordPieceTokenizer

logger = logging.getLogger(__name__)


def _try_native_backend():
    try:
        from . import native  # noqa: WPS433

        return native if native.available() else None
    except Exception:
        return None


class Tokenizer:
    def __init__(
        self,
        model_name: str,
        vocab_file: str,
        *,
        merges_file: Optional[str] = None,
        lowercase: bool = True,
        handle_chinese_chars: bool = False,
        dropout: Optional[float] = None,
        use_native: bool = True,
    ):
        self.model_name = model_name
        self._native = None

        if model_name == "bert":
            self._pad_token = "[PAD]"
            self._sep_token = "[SEP]"
            self._cls_token = "[CLS]"
            self._unk_token = "[UNK]"

            if dropout is not None:
                logger.warning("BPE dropout is not supported by the WordPiece tokenizer.")

            self.tokenizer = WordPieceTokenizer(
                vocab_file,
                lowercase=lowercase,
                handle_chinese_chars=handle_chinese_chars,
                unk_token=self._unk_token,
            )
            if use_native:
                backend = _try_native_backend()
                if backend is not None:
                    self._native = backend.NativeWordPiece(
                        vocab_file,
                        lowercase=lowercase,
                        handle_chinese_chars=handle_chinese_chars,
                        unk_token=self._unk_token,
                    )
                    logger.info("Using native C++ WordPiece backend.")
        elif model_name == "roberta":
            if merges_file is None:
                raise AttributeError("To use the byte-level BPE tokenizer, specify a merges file.")

            self._pad_token = "<pad>"
            self._sep_token = "</s>"
            self._cls_token = "<s>"
            self._unk_token = "<unk>"

            self.tokenizer = ByteLevelBPETokenizer(
                vocab_file=vocab_file, merges_file=merges_file, dropout=dropout
            )
            # native fast path: deterministic encodes only — BPE-dropout is
            # stochastic regularization and stays on the Python path
            if use_native and not dropout:
                backend = _try_native_backend()
                if backend is not None:
                    self._native = backend.NativeByteLevelBPE(vocab_file, merges_file)
                    logger.info("Using native C++ byte-level BPE backend.")
        else:
            raise NotImplementedError(
                f"Tokenizer initialization for model {model_name} is not implemented."
            )

    def __len__(self) -> int:
        return len(self.tokenizer)

    def encode(self, string: str) -> List[int]:
        # ASCII texts (the NQ hot path) take the C++ backend, whose semantics
        # are exactly the Python spec's on that domain; anything with
        # multibyte UTF-8 (accents, CJK) uses the full-Unicode Python path.
        # NUL also routes to Python: it cannot cross the C-string boundary,
        # and byte-level BPE (unlike WordPiece, which drops it) encodes byte 0
        # as a real token.
        if self._native is not None and string.isascii() and "\x00" not in string:
            return self._native.encode(string)
        return self.tokenizer.encode(string)

    def decode(self, ids, *, skip_special_tokens: bool = True) -> str:
        # The trailing ' ##' strip reproduces the reference wrapper's own
        # decode post-processing (tokenizer.py:61), applied on top of the
        # backend decode for BOTH models — it is a no-op for WordPiece output
        # but visibly rewrites byte-BPE decodes whose text contains ' ##'.
        return self.tokenizer.decode(
            ids, skip_special_tokens=skip_special_tokens
        ).replace(" ##", "")

    @property
    def pad_token_id(self) -> int:
        return self.tokenizer.token_to_id(self._pad_token)

    @property
    def sep_token_id(self) -> int:
        return self.tokenizer.token_to_id(self._sep_token)

    @property
    def cls_token_id(self) -> int:
        return self.tokenizer.token_to_id(self._cls_token)

    @property
    def unk_token_id(self) -> int:
        return self.tokenizer.token_to_id(self._unk_token)

    @property
    def pad_token(self) -> str:
        return self._pad_token

    @property
    def sep_token(self) -> str:
        return self._sep_token

    @property
    def cls_token(self) -> str:
        return self._cls_token

    @property
    def unk_token(self) -> str:
        return self._unk_token
