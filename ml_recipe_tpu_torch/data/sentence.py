"""Lightweight English sentence splitter (a copy of
``ml_recipe_tpu/data/sentence.py``).

Replaces the reference's nltk punkt dependency (split_dataset.py:230-241),
which requires a runtime model download.
Rule-based: split after sentence-final punctuation followed by whitespace and
an upper-case/digit/quote opener, with an abbreviation guard. Boundaries only
steer chunk packing, so "reasonable" is sufficient; exact punkt parity is not
a semantic requirement.
"""

from __future__ import annotations

import re
from typing import List

_ABBREVIATIONS = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "no", "vs", "etc",
    "e.g", "i.e", "fig", "vol", "inc", "ltd", "co", "corp", "dept", "est",
    "approx", "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep", "sept",
    "oct", "nov", "dec", "u.s", "u.k",
}

_BOUNDARY = re.compile(r"([.!?]+)(\s+)(?=[\"'‘“(\[]?[A-Z0-9<])")


def _last_word(text: str) -> str:
    stripped = text.rstrip(".!?")
    idx = max(stripped.rfind(" "), stripped.rfind("\n"))
    return stripped[idx + 1:].lower()


def split_sentences(text: str) -> List[str]:
    """Split text into sentences; whitespace inside sentences is preserved."""
    if not text:
        return []

    sentences: List[str] = []
    last = 0
    for match in _BOUNDARY.finditer(text):
        candidate_end = match.end(1)
        prefix = text[last:candidate_end]
        word = _last_word(prefix)
        # Do not break after known abbreviations or single-letter initials.
        if word in _ABBREVIATIONS or (len(word) == 1 and word.isalpha()):
            continue
        sentences.append(text[last:match.end(2)].rstrip())
        last = match.end(2)

    tail = text[last:].strip()
    if tail:
        sentences.append(tail)

    # reachable with an empty list only for whitespace-only input (any real
    # content lands in the tail) — no sentences is the right answer there
    return sentences
