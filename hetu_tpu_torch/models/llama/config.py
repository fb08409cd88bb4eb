"""LLaMA configuration, the port of `hetu_tpu/models/llama/config.py`.

Only the fields the serving path reads are kept; the training knobs
(scan, remat, dropout, pipeline layout) arrive with the training slice.
Dtypes are torch dtypes; the policy is the reference's: parameters
stored in `param_dtype`, activations computed in `compute_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02
    num_experts: int = 0
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.num_experts:
            raise NotImplementedError(
                "MoE layers (num_experts > 0) are not in the serving slice; "
                "they arrive with the multi-GPU slice (ROADMAP Queue A 10)")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads {self.num_attention_heads} must divide "
                f"by num_key_value_heads {self.num_key_value_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    # -- canonical sizes (same presets as the reference) ---------------------
    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config."""
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=256)
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        d = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=8, max_position_embeddings=8192,
                 rope_theta=500000.0)
        d.update(kw)
        return LlamaConfig(**d)

    def num_params(self) -> int:
        h, i, v, L = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_hidden_layers)
        kvh = self.num_key_value_heads * self.head_dim
        ffn = 3 * h * i
        per_layer = h * (h + 2 * kvh + h) + ffn + 2 * h  # attn + ffn + norms
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return L * per_layer + emb + h
