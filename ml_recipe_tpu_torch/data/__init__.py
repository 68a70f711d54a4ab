"""Host-side input pipeline. The package exports the serving subset
(chunking and the label table) and sequence packing (``packing``); the
corpus and other training modules (``sentence``, ``preprocessor``,
``datasets``, ``synthetic``, ``collate``, ``loader``, ``bucketing``,
``device_prefetch``) are imported from their own modules."""

from .chunking import (
    ChunkRecord,
    assemble_input_ids,
    drop_tags_and_encode,
    encode_document,
    window_chunks,
)
from .labels import id2labels, labels2id
from .packing import (
    PackedBatch,
    PackedDataLoader,
    SequencePacker,
    collate_packed,
    parse_sequence_packing,
)

__all__ = [
    "ChunkRecord",
    "PackedBatch",
    "PackedDataLoader",
    "SequencePacker",
    "assemble_input_ids",
    "collate_packed",
    "drop_tags_and_encode",
    "encode_document",
    "id2labels",
    "labels2id",
    "parse_sequence_packing",
    "window_chunks",
]
