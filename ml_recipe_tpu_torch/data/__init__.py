"""Host-side input pipeline. The package exports the serving subset
(chunking and the label table); the corpus and training modules
(``sentence``, ``preprocessor``, ``datasets``, ``synthetic``, ``collate``,
``loader``, ``bucketing``, ``device_prefetch``) are imported from their own
modules."""

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
