"""In-tree tokenizer stack (reference: python/hetu/data/tokenizers/ — the
reference vendors GPT2-BPE, SentencePiece, tiktoken and an HF wrapper; this
package vendors a self-contained byte-level BPE (train/save/load, no
downloads) plus a thin HF delegate for pretrained vocabularies)."""
from hetu_tpu_torch.data.tokenizers.bpe import ByteLevelBPETokenizer
from hetu_tpu_torch.data.tokenizers.hf import HFTokenizer, build_tokenizer
from hetu_tpu_torch.data.tokenizers.sp_model import SentencePieceTokenizer
from hetu_tpu_torch.data.tokenizers.tiktoken_bpe import TikTokenizer

__all__ = ["ByteLevelBPETokenizer", "HFTokenizer", "build_tokenizer",
           "SentencePieceTokenizer", "TikTokenizer"]
