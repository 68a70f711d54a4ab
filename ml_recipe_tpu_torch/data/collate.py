"""Fixed-shape batch collation (a copy of ``ml_recipe_tpu/data/collate.py``).

Pads every batch to the static ``max_seq_len`` (the bucket's seq on the
bucketed path), builds the attention mask from true lengths and BERT
token-type ids (segment 1 after the first [SEP]), and packs the 5-key label
dict. Outputs are host numpy arrays; device placement happens in the
training loop.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np


def collate_fun(items, tokenizer, *, max_seq_len: Optional[int] = None,
                return_items: bool = False):
    batch_size = len(items)
    pad_token_id = tokenizer.pad_token_id

    lengths = np.asarray([len(item.input_ids) for item in items], dtype=np.int32)
    target_len = int(max_seq_len) if max_seq_len is not None else int(lengths.max())
    if lengths.max() > target_len:
        raise ValueError(f"Item of length {lengths.max()} exceeds static "
                         f"max_seq_len {target_len}.")

    tokens = np.full((batch_size, target_len), pad_token_id, dtype=np.int32)
    token_type_ids = np.zeros((batch_size, target_len), dtype=np.int32)

    is_bert = getattr(tokenizer, "model_name", "bert") == "bert"
    sep_token_id = tokenizer.sep_token_id

    for i, item in enumerate(items):
        row = item.input_ids
        tokens[i, : len(row)] = row
        if is_bert:
            # segment 0 up to and including the first [SEP], segment 1 after
            sep_pos = row.index(sep_token_id) if sep_token_id in row else len(row) - 1
            token_type_ids[i, sep_pos + 1 : len(row)] = 1

    positions = np.arange(target_len, dtype=np.int32)[None, :]
    attention_mask = (positions < lengths[:, None]).astype(np.int32)

    inputs = {
        "input_ids": tokens,
        "attention_mask": attention_mask,
        "token_type_ids": token_type_ids,
    }
    labels = {
        "start_class": np.asarray([item.start_id for item in items], dtype=np.int32),
        "end_class": np.asarray([item.end_id for item in items], dtype=np.int32),
        "start_reg": np.asarray([item.start_position for item in items], dtype=np.float32),
        "end_reg": np.asarray([item.end_position for item in items], dtype=np.float32),
        "cls": np.asarray([item.label_id for item in items], dtype=np.int32),
    }
    if return_items:
        return [inputs, labels, items]
    return [inputs, labels]


def make_collate_fun(tokenizer, *, max_seq_len: Optional[int] = None,
                     return_items: bool = False):
    """Bind tokenizer/shape args (reference init.py:204-205)."""
    return functools.partial(collate_fun, tokenizer=tokenizer,
                             max_seq_len=max_seq_len, return_items=return_items)


def rebind_collate_seq(collate, max_seq_len: int):
    """A copy of a bound collate with its static pad length replaced (the
    bucketed loader collates each bucket at the bucket's seq)."""
    if not isinstance(collate, functools.partial) or collate.func is not collate_fun:
        raise TypeError(f"rebind_collate_seq needs a make_collate_fun-style "
                        f"partial of collate_fun, got {collate!r}")
    kwargs = dict(collate.keywords)
    kwargs["max_seq_len"] = int(max_seq_len)
    return functools.partial(collate.func, *collate.args, **kwargs)
