"""HF tokenizer delegate + factory (reference: python/hetu/data/tokenizers/
build_tokenizer.py — the reference exposes one build function over its
GPT2/SP/tiktoken/HF stacks; here the in-tree BPE is the no-dependency path
and transformers is the pretrained path, chosen explicitly).

The port's copy of `hetu_tpu/data/tokenizers/hf.py`, unchanged but for its
imports (host code: the port never imports the JAX package).
"""
from __future__ import annotations

from typing import List, Optional


class HFTokenizer:
    """Thin delegate to a transformers tokenizer — the EXPLICIT external
    dependency (round-1 review: the HF fallback used to be implicit)."""

    def __init__(self, name_or_path: str, **kw):
        try:
            from transformers import AutoTokenizer
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "HFTokenizer needs the `transformers` package; use the "
                "in-tree ByteLevelBPETokenizer for dependency-free runs"
            ) from e
        self._tok = AutoTokenizer.from_pretrained(name_or_path, **kw)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids) -> str:
        return self._tok.decode(ids)

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.convert_tokens_to_ids(token)


def build_tokenizer(kind: str, path: Optional[str] = None, **kw):
    """kind: "bpe" (in-tree byte-level BPE; path = saved vocab dir) |
    "hf" (pretrained via transformers; path = model name or dir) |
    "sp" (sentencepiece .model file, runtime-free loader) |
    "tiktoken" (tiktoken rank file)."""
    if kind == "bpe":
        from hetu_tpu_torch.data.tokenizers.bpe import ByteLevelBPETokenizer
        if path is None:
            raise ValueError("bpe tokenizer needs path (saved vocab dir)")
        return ByteLevelBPETokenizer.load(path, **kw)
    if kind == "hf":
        if path is None:
            raise ValueError("hf tokenizer needs a model name or dir")
        return HFTokenizer(path, **kw)
    if kind == "sp":
        from hetu_tpu_torch.data.tokenizers.sp_model import SentencePieceTokenizer
        if path is None:
            raise ValueError("sp tokenizer needs a .model file path")
        return SentencePieceTokenizer(path, **kw)
    if kind == "tiktoken":
        from hetu_tpu_torch.data.tokenizers.tiktoken_bpe import TikTokenizer
        if path is None:
            raise ValueError("tiktoken tokenizer needs a rank file path")
        return TikTokenizer(path, **kw)
    raise ValueError(f"unknown tokenizer kind {kind!r} (bpe|hf|sp|tiktoken)")
