"""GPT configuration, the port of `hetu_tpu/models/gpt/model.py`
`GPTConfig`.

The reference's fields keep their names and defaults; dtypes are torch
dtypes.  The blocks are always an `nn.ModuleList`: `use_scan` picks
only the layout of the reference tree `load_jax_params` expects (its
stacked `model.blocks` when True, its per-layer `model.block_<i>` when
False).  `use_flash_attention` routes the attention to the flash
kernels on the card; `remat_policy` is "nothing", "dots", "dots_attn"
or "offload" (`nn/remat.py`); dropout as in `LlamaConfig`.  Pipeline
stages raise NotImplementedError naming the slice that brings them;
the reference's `supports_hetero_tp` flag belongs to its
heterogeneous pipeline and has no counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch

from hetu_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from hetu_tpu_torch.models.llama.config import check_dropout_rates
from hetu_tpu_torch.nn.remat import validate_remat_policy

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    initializer_range: float = 0.02
    attention_dropout: float = 0.0
    hidden_dropout: float = 0.0
    pipeline_stage_layers: object = None
    param_dtype: torch.dtype = DEFAULT_POLICY.param_dtype
    compute_dtype: torch.dtype = DEFAULT_POLICY.compute_dtype
    use_scan: bool = True
    remat: bool = True             # recompute each block in the backward
    remat_policy: str = "nothing"  # what a block saves (nn/remat.py)
    use_flash_attention: bool = True

    def __post_init__(self):
        check_dropout_rates(self)
        if self.pipeline_stage_layers is not None:
            raise NotImplementedError(
                "pipeline_stage_layers is not in the port yet; pipelines "
                f"arrive with {_MULTI_GPU}")
        validate_remat_policy(self.remat_policy)
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size} must divide by "
                f"num_attention_heads {self.num_attention_heads}")

    @property
    def policy(self) -> DTypePolicy:
        """The dtype policy of `param_dtype` and `compute_dtype`."""
        return DTypePolicy(self.param_dtype, self.compute_dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    # -- canonical sizes (same presets as the reference) ---------------------
    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        d = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, max_position_embeddings=256)
        d.update(kw)
        return GPTConfig(**d)

    @staticmethod
    def gpt2_large(**kw) -> "GPTConfig":
        d = dict(hidden_size=1280, num_hidden_layers=36,
                 num_attention_heads=20)
        d.update(kw)
        return GPTConfig(**d)

    def num_params(self) -> int:
        """The reference's count: blocks, both embedding tables and the
        final norm (a tied head adds nothing)."""
        h, L, v = self.hidden_size, self.num_hidden_layers, self.vocab_size
        per_layer = 4 * h * h + 2 * 4 * h * h + 9 * h + 4 * h
        emb = v * h + self.max_position_embeddings * h
        return L * per_layer + emb + 2 * h

    def flops_per_token(self, seq_len: int) -> float:
        """Approximate training FLOPs per token (forward and backward,
        6 N plus the attention term), the reference's formula."""
        n = self.num_params()
        return 6.0 * n + 12 * self.num_hidden_layers * self.hidden_size \
            * seq_len
