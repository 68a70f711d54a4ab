"""First-party WordPiece tokenizer (BERT style).

Replaces the Rust ``tokenizers.BertWordPieceTokenizer`` dependency the
reference wraps in ``modules/model/model/tokenizer.py:26-31``. Implements the
standard BERT pipeline: text cleaning, optional lowercase + accent stripping,
punctuation splitting, optional CJK isolation, then greedy longest-match
WordPiece with ``##`` continuations.

Pure-Python reference implementation; a C++ backend with identical behaviour
can be swapped in through :class:`ml_recipe_tpu_torch.tokenizer.facade.Tokenizer`.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as fh:
        for i, line in enumerate(fh):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class WordPieceTokenizer:
    def __init__(
        self,
        vocab_file: str,
        *,
        lowercase: bool = True,
        handle_chinese_chars: bool = False,
        unk_token: str = "[UNK]",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = load_vocab(vocab_file)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.handle_chinese_chars = handle_chinese_chars
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def __len__(self) -> int:
        return len(self.vocab)

    # -- basic tokenization ---------------------------------------------------

    def _clean_text(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _tokenize_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _split_punctuation(self, word: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def basic_tokenize(self, text: str) -> List[str]:
        text = self._clean_text(text)
        if self.handle_chinese_chars:
            text = self._tokenize_cjk(text)
        words: List[str] = []
        for word in text.split():
            if self.lowercase:
                word = word.lower()
                word = "".join(
                    ch for ch in unicodedata.normalize("NFD", word)
                    if unicodedata.category(ch) != "Mn"
                )
            words.extend(self._split_punctuation(word))
        return words

    # -- wordpiece ------------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]

        tokens: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur: Optional[str] = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens

    # -- public API -----------------------------------------------------------

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic_tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens (callers add [CLS]/[SEP])."""
        unk_id = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk_id) for t in self.tokenize(text)]

    def decode(self, ids: List[int], *, skip_special_tokens: bool = True) -> str:
        specials = {"[PAD]", "[SEP]", "[CLS]", "[UNK]", "[MASK]"}
        tokens = []
        for i in ids:
            tok = self.inv_vocab.get(int(i), self.unk_token)
            if skip_special_tokens and tok in specials:
                continue
            tokens.append(tok)
        # Matches the Rust WordPiece decoder with ``cleanup=True`` (the
        # reference's decode path, tokenizer.py:61): each non-first token is
        # either a ``##`` continuation (prefix stripped, no space) or gets a
        # leading space, and the cleanup substitution chain runs PER PIECE —
        # not on the joined string, so e.g. a lone apostrophe piece " '" is
        # never collapsed. Fuzz-verified in tests/test_tokenizer_diff.py.
        pieces = []
        for idx, tok in enumerate(tokens):
            if idx != 0:
                tok = tok[2:] if tok.startswith("##") else " " + tok
            for dirty, clean in (
                (" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
                (" ' ", "' "), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
                (" 've", "'ve"), (" 're", "'re"),
            ):
                tok = tok.replace(dirty, clean)
            pieces.append(tok)
        return "".join(pieces)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)
