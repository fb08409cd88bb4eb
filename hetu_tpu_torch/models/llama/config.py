"""LLaMA configuration, the port of `hetu_tpu/models/llama/config.py`.

Only the fields the ported paths read are kept.  Dtypes are torch
dtypes; the policy is the reference's: parameters stored in
`param_dtype`, activations computed in `compute_dtype`.  The layers are
always an `nn.ModuleList` (the reference's `use_scan` has no
counterpart).  `use_flash_attention` routes the attention to the flash
kernels on the card; `remat_policy` is "nothing", "dots", "dots_attn" or
"offload" (`nn/remat.py`).  `attention_dropout` and `hidden_dropout` act
when the training forward is given a dropout key and
`deterministic=False` (the Trainer's `dropout_deterministic=False`).
`num_experts > 0` makes every block's MLP a Mixture-of-Experts layer
(`nn/moe.py`) with the reference's `moe_*` fields; `num_params` and
`flops_per_token` are the reference's, which count all the experts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from hetu_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from hetu_tpu_torch.nn.moe import MoEConfig
from hetu_tpu_torch.nn.remat import validate_remat_policy


def check_dropout_rates(config):
    """Dropout rates lie in [0, 1)."""
    for name in ("attention_dropout", "hidden_dropout"):
        rate = getattr(config, name)
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"{name} must lie in [0, 1), got {rate}")


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
    # MoE (0 experts = dense): the reference's fields and defaults
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_gate: str = "topk"       # topk|top1|ktop1|balance|hash|sam
    moe_dispatch: str = "sort"   # sort (O(T·k) indices) | dense ([T,E,C])
    moe_sam_group_size: int = 0  # sam gate: experts per locality group
    param_dtype: torch.dtype = DEFAULT_POLICY.param_dtype
    compute_dtype: torch.dtype = DEFAULT_POLICY.compute_dtype
    remat: bool = True             # recompute each block in the backward
    remat_policy: str = "nothing"  # what a block saves (nn/remat.py)
    use_flash_attention: bool = True

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.num_experts:
            self.moe_config()           # checks the gate and dispatch
        check_dropout_rates(self)
        validate_remat_policy(self.remat_policy)
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError(
                f"num_attention_heads {self.num_attention_heads} must divide "
                f"by num_key_value_heads {self.num_key_value_heads}")

    def moe_config(self) -> MoEConfig:
        """The blocks' `MoEConfig` (num_experts > 0)."""
        return MoEConfig(num_experts=self.num_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor,
                         gate=self.moe_gate, dispatch=self.moe_dispatch,
                         sam_group_size=self.moe_sam_group_size)

    @property
    def policy(self) -> DTypePolicy:
        """The dtype policy of `param_dtype` and `compute_dtype`."""
        return DTypePolicy(self.param_dtype, self.compute_dtype)

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
    def llama2_7b(**kw) -> "LlamaConfig":
        d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32,
                 num_key_value_heads=32, max_position_embeddings=4096)
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def llama2_13b(**kw) -> "LlamaConfig":
        d = dict(vocab_size=32000, hidden_size=5120, intermediate_size=13824,
                 num_hidden_layers=40, num_attention_heads=40,
                 num_key_value_heads=40, max_position_embeddings=4096)
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
        ffn = 3 * h * i * max(self.num_experts, 1)
        per_layer = h * (h + 2 * kvh + h) + ffn + 2 * h  # attn + ffn + norms
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return L * per_layer + emb + h

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (forward and backward,
        6 N plus the attention term), the reference's formula; with
        experts N counts them all, not the top-k a token runs."""
        attn = 12 * self.num_hidden_layers * self.hidden_size * seq_len
        return 6.0 * self.num_params() + attn
