"""First-party byte-level BPE tokenizer (RoBERTa/GPT-2 style).

Replaces the Rust ``tokenizers.ByteLevelBPETokenizer`` the reference wraps in
``modules/model/model/tokenizer.py:42-49``, including the optional BPE-dropout
(Provilkov et al., 2019) the reference exposes via ``--bpe_dropout``.
"""

from __future__ import annotations

import heapq
import json
import re
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte->printable-unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


try:
    # the exact GPT-2 pre-split pattern needs \p{L}/\p{N} classes (letters
    # exclude '_'; numbers include Nl/No like 'Ⅻ'/'½'), which stdlib `re`
    # cannot express — `regex` ships with transformers, so it is always
    # present in practice; the `re` fallback is approximate on those classes
    import regex as _re_mod

    _GPT2_SPLIT = _re_mod.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
    )
except ImportError:  # pragma: no cover
    _GPT2_SPLIT = re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+"
    )


class ByteLevelBPETokenizer:
    def __init__(
        self,
        vocab_file: str,
        merges_file: str,
        *,
        dropout: Optional[float] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        with open(vocab_file, "r", encoding="utf-8") as fh:
            self.vocab: Dict[str, int] = json.load(fh)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}

        self.merge_ranks: Dict[Tuple[str, str], int] = {}
        with open(merges_file, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                self.merge_ranks[(a, b)] = len(self.merge_ranks)

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.dropout = dropout
        self.rng = rng if rng is not None else np.random.default_rng()
        self._cache: Dict[str, List[str]] = {}

    def __len__(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        use_dropout = self.dropout is not None and self.dropout > 0
        if use_dropout:
            return self._bpe_dropout(token)
        if token in self._cache:
            return self._cache[token]

        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            ranked = [
                (self.merge_ranks[p], p) for p in pairs if p in self.merge_ranks
            ]
            if not ranked:
                break
            _, best = min(ranked)
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged

        self._cache[token] = word
        return word

    def _bpe_dropout(self, token: str) -> List[str]:
        """BPE-dropout (Provilkov et al.) with the Rust library's QUEUE
        semantics (word.rs ``merge_all``): candidates pop in (rank,
        position) order; each pop rolls dropout — a skipped candidate goes
        to a side buffer and is RE-QUEUED as soon as any merge is accepted,
        so merging only stops when a run of consecutive drops exhausts the
        queue. (A naive re-roll-every-sweep scheme over-fragments: measured
        ~165 tokens vs Rust's ~152 at p=0.1 on the same text; permanent
        single-roll drops over-fragment even more, ~195.)"""
        syms = list(token)
        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prev = [-1] + list(range(n - 1))
        alive = [True] * n
        heap: List[tuple] = []
        skipped: List[tuple] = []

        def push(i: int) -> None:
            j = nxt[i]
            if j == -1:
                return
            r = self.merge_ranks.get((syms[i], syms[j]))
            if r is not None:
                heapq.heappush(heap, (r, i, syms[i], syms[j]))

        for i in range(n - 1):
            push(i)

        while heap:
            top = heapq.heappop(heap)
            if self.rng.random() < self.dropout:
                skipped.append(top)  # dies only if the queue empties first
                continue
            for t in skipped:
                heapq.heappush(heap, t)
            skipped.clear()

            _, i, a, b = top
            if not alive[i]:
                continue
            j = nxt[i]
            if j == -1 or syms[i] != a or syms[j] != b:
                # stale: a neighbour merge changed the pair — requeue the
                # position's CURRENT pair (rust re-pushes the corrected
                # candidate) and move on
                push(i)
                continue
            syms[i] = a + b
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prev[nxt[j]] = i
            if prev[i] != -1:
                push(prev[i])
            push(i)

        return [s for k, s in enumerate(syms) if alive[k]]

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for piece in _GPT2_SPLIT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens (callers add <s>/</s>)."""
        unk = self.vocab.get("<unk>", 0)
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]

    def decode(self, ids: List[int], *, skip_special_tokens: bool = True) -> str:
        # ``skip_special_tokens`` is accepted but inert: a Rust
        # ByteLevelBPETokenizer loaded from vocab/merges FILES (the
        # reference's construction, tokenizer.py:42-49) registers no added
        # special tokens, so its decode renders '<s>'/'</s>'/'<pad>' as
        # literal text regardless of the flag — fuzz-verified in
        # tests/test_tokenizer_diff.py.
        del skip_special_tokens
        text = ""
        for i in ids:
            tok = self.inv_vocab.get(int(i), "<unk>")
            text += tok
        # No strip: the Rust ByteLevel decoder preserves surrounding
        # whitespace exactly (fuzz-verified in tests/test_tokenizer_diff.py).
        raw = bytearray(self.byte_decoder.get(ch, ord(" ")) for ch in text)
        return raw.decode("utf-8", errors="replace")

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)
