"""LLaMA configuration, the port of `hetu_tpu/models/llama/config.py`.

Only the fields the ported paths read are kept.  Dtypes are torch
dtypes; the policy is the reference's: parameters stored in
`param_dtype`, activations computed in `compute_dtype`.  The layers are
always an `nn.ModuleList` (the reference's `use_scan` has no
counterpart).  Dropout and remat policies other than "nothing" raise
NotImplementedError naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hetu_tpu_torch.nn.remat import validate_remat_policy

_TRAINING_3 = "the third training slice (ROADMAP Queue A item 2)"


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
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    num_experts: int = 0
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True             # recompute each block in the backward
    remat_policy: str = "nothing"  # what a block saves: nothing
    use_flash_attention: bool = True

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.num_experts:
            raise NotImplementedError(
                "MoE layers (num_experts > 0) are not in the serving slice; "
                "they arrive with the multi-GPU slice (ROADMAP Queue A 10)")
        for name in ("attention_dropout", "hidden_dropout"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"{name}={getattr(self, name)} is not in the port yet "
                    f"(the reference's dropout bits cannot be matched); it "
                    f"arrives with {_TRAINING_3}")
        validate_remat_policy(self.remat_policy)
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

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (forward and backward,
        6 N plus the attention term), the reference's formula."""
        attn = 12 * self.num_hidden_layers * self.hidden_size * seq_len
        return 6.0 * self.num_params() + attn
