"""Host-side input pipeline: the serving subset (chunking and the label table)."""

from .chunking import (
    ChunkRecord,
    assemble_input_ids,
    drop_tags_and_encode,
    encode_document,
    window_chunks,
)
from .labels import id2labels, labels2id

__all__ = [
    "ChunkRecord",
    "assemble_input_ids",
    "drop_tags_and_encode",
    "encode_document",
    "id2labels",
    "labels2id",
    "window_chunks",
]
