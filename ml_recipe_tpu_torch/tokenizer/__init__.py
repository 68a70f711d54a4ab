from .facade import Tokenizer
from .wordpiece import WordPieceTokenizer
from .bpe import ByteLevelBPETokenizer
from .vocab_utils import write_synthetic_bert_vocab

__all__ = ["Tokenizer", "WordPieceTokenizer", "ByteLevelBPETokenizer", "write_synthetic_bert_vocab"]
