"""Vocab file utilities.

The reference assumes ``bert-base-uncased-vocab.txt`` was downloaded next to
the data (config/test_bert.cfg:4). This environment has no egress, so smoke
runs and benchmarks generate a synthetic vocab with the exact BERT layout:
[PAD]=0, [unused0..98]=1..99, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103,
then filler wordpieces up to ``size``. Token *strings* are irrelevant for
DummyDataset runs — only ids and special-token positions matter.
"""

from __future__ import annotations

import os


def write_synthetic_bert_vocab(path, size: int = 30522) -> str:
    path = os.fspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tokens = ["[PAD]"]
    tokens += [f"[unused{i}]" for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    i = 0
    while len(tokens) < size:
        # mix whole words and continuations so chunking code sees both
        tokens.append(f"tok{i}" if i % 4 else f"##tok{i}")
        i += 1
    with open(path, "w") as fh:
        fh.write("\n".join(tokens[:size]) + "\n")
    return path
