"""Synthetic NQ-schema corpora (no download is possible where the port runs).

Two corpora, both written from a seed:

- the LEARNABLE corpus (a copy of the first half of
  ``ml_recipe_tpu/data/synthetic.py``): one paragraph per document, five
  balanced classes, the QUESTION's first word encodes the class label
  (``is it yes`` -> yes, ``is it no`` -> no, ``find the needle`` -> short,
  ``describe it all`` -> long, ``nothing is here`` -> unknown); for
  ``short`` the answer is the one marker word ``needle``, for
  ``yes``/``no``/``long`` the whole paragraph, ``unknown`` lines carry no
  annotation. A model that learns beats chance by a wide margin, a broken
  optimizer/loss/pipeline cannot. ``make_convergence_trainer`` of the JAX
  module waits for the benchmark's ``converge`` mode;
- the NQ-SHAPED corpus (:func:`write_nq_corpus`): documents of
  log-uniformly distributed length in ``<P>`` paragraphs of sentences
  ending in ``.``, over the whole words of a WordPiece vocab, five balanced
  classes with a random paragraph as the long answer and a few of its words
  as the short answer. Its answers are not learnable; it exists to put real
  length variation through the input path: chunks of every length bucket,
  and long documents that yield many sentence chunks.
"""

from __future__ import annotations

import json
from pathlib import Path

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
KEYWORDS = ["yes", "no", "find", "describe", "nothing"]
MARKER = "needle"
SUPPORT = ["is", "it", "the", "all", "here", "?", "."]
FILLERS = [
    "alpha", "bravo", "carol", "delta", "echo", "fern", "golf", "hotel",
    "india", "jade", "kilo", "lima", "mike", "norse", "oscar", "papa",
]

QUESTIONS = {
    "yes": "is it yes ?",
    "no": "is it no ?",
    "short": "find the needle ?",
    "long": "describe it all ?",
    "unknown": "nothing is here ?",
}
CLASS_CYCLE = ["yes", "no", "short", "long", "unknown"]


def write_learnable_vocab(out_dir) -> Path:
    """WordPiece vocab covering exactly the corpus' closed vocabulary (every
    word is a single whole-word piece, so word index == token index within
    the paragraph body)."""
    out_dir = Path(out_dir)
    vocab_file = out_dir / "vocab.txt"
    vocab_file.write_text(
        "\n".join(SPECIALS + KEYWORDS + [MARKER] + SUPPORT + FILLERS) + "\n"
    )
    return vocab_file


def make_learnable_line(i: int, rng) -> dict:
    """One NQ-schema json line of class ``CLASS_CYCLE[i % 5]``."""
    label = CLASS_CYCLE[i % len(CLASS_CYCLE)]

    n_body = int(rng.integers(8, 24))
    body = list(rng.choice(FILLERS, size=n_body))
    if label == "short":
        pos = int(rng.integers(0, n_body))
        body[pos] = MARKER
        # word index within document_text.split(): one leading <P> tag word
        marker_word = 1 + pos
        short_answers = [{"start_token": marker_word, "end_token": marker_word + 1}]
    else:
        short_answers = []

    words = ["<P>"] + body + ["</P>"]
    long_span = {"start_token": 0, "end_token": len(words), "candidate_index": 0}
    annotation = {
        "yes_no_answer": {"yes": "YES", "no": "NO"}.get(label, "NONE"),
        "long_answer": (
            {"start_token": -1, "end_token": -1, "candidate_index": -1}
            if label == "unknown"
            else long_span
        ),
        "short_answers": short_answers,
    }
    return {
        "example_id": str(i),
        "document_text": " ".join(words),
        "question_text": QUESTIONS[label],
        "annotations": [annotation],
        "long_answer_candidates": [
            {"start_token": 0, "end_token": len(words), "top_level": True}
        ],
    }


def write_learnable_corpus(out_path, *, n_examples: int = 200, seed: int = 0) -> Path:
    import numpy as np

    out_path = Path(out_path)
    rng = np.random.default_rng(seed)
    with open(out_path, "w") as fh:
        for i in range(n_examples):
            fh.write(json.dumps(make_learnable_line(i, rng)) + "\n")
    return out_path


NQ_CLASS_CYCLE = ["yes", "no", "short", "long", "unknown"]


def vocab_words(vocab_file) -> list:
    """The whole words of a WordPiece vocab: no ``##`` continuations, no
    ``[...]`` specials."""
    words = []
    with open(vocab_file) as fh:
        for line in fh:
            token = line.strip()
            if token and not token.startswith("##") and not (
                    token.startswith("[") and token.endswith("]")):
                words.append(token)
    return words


def make_nq_line(i: int, rng, words, *, min_words: int = 50,
                 max_words: int = 6000) -> dict:
    """One NQ-schema json line of class ``NQ_CLASS_CYCLE[i % 5]`` whose
    document has about log-uniform(``min_words``, ``max_words``) words
    (tag words not counted) in ``<P>`` paragraphs of 2-8 sentences of 5-30
    words, each sentence capitalised and ending in ``.``."""
    import numpy as np

    label = NQ_CLASS_CYCLE[i % len(NQ_CLASS_CYCLE)]
    target = int(round(float(np.exp(rng.uniform(np.log(min_words),
                                                np.log(max_words))))))
    doc: list = []
    paragraphs = []   # (start word index of <P>, end index past </P>)
    n_body = 0
    while n_body < target:
        start = len(doc)
        doc.append("<P>")
        for _ in range(int(rng.integers(2, 9))):
            n = int(rng.integers(5, 31))
            sentence = [words[j] for j in rng.integers(0, len(words), n)]
            sentence[0] = sentence[0].capitalize()
            sentence[-1] += "."
            doc.extend(sentence)
            n_body += n
        doc.append("</P>")
        paragraphs.append((start, len(doc)))

    answer = int(rng.integers(0, len(paragraphs)))
    p_start, p_end = paragraphs[answer]
    short_answers = []
    if label == "short":
        s = int(rng.integers(p_start + 1, p_end - 1))
        e = min(s + int(rng.integers(1, 4)), p_end - 1)
        short_answers = [{"start_token": s, "end_token": e}]
    long_answer = ({"start_token": -1, "end_token": -1, "candidate_index": -1}
                   if label == "unknown" else
                   {"start_token": p_start, "end_token": p_end,
                    "candidate_index": answer})
    question = [words[j] for j in rng.integers(0, len(words),
                                               int(rng.integers(4, 13)))]
    return {
        "example_id": str(i),
        "document_text": " ".join(doc),
        "question_text": " ".join(question) + " ?",
        "annotations": [{
            "yes_no_answer": {"yes": "YES", "no": "NO"}.get(label, "NONE"),
            "long_answer": long_answer,
            "short_answers": short_answers,
        }],
        "long_answer_candidates": [
            {"start_token": s, "end_token": e, "top_level": True}
            for s, e in paragraphs],
    }


def write_nq_corpus(out_path, vocab_file, *, n_docs: int = 4096,
                    seed: int = 0, min_words: int = 50,
                    max_words: int = 6000) -> Path:
    """Write ``n_docs`` lines of :func:`make_nq_line` (classes cycling, so
    balanced) over the whole words of ``vocab_file``, from ``seed``."""
    import numpy as np

    out_path = Path(out_path)
    words = vocab_words(vocab_file)
    rng = np.random.default_rng(seed)
    with open(out_path, "w") as fh:
        for i in range(n_docs):
            fh.write(json.dumps(make_nq_line(
                i, rng, words, min_words=min_words, max_words=max_words))
                + "\n")
    return out_path
