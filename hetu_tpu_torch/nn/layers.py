"""Single-device layers: the port of `hetu_tpu/nn/layers.py` `Embedding`
and `hetu_tpu/nn/parallel.py` `ParallelRMSNorm` (with its fused
`residual` pair) / `RowParallelLinear` (tensor/sequence parallelism
arrives with the multi-GPU slice).

Weights keep the reference layout — a linear weight is [in, out] and
y = x @ W — so JAX parameters load key for key.  Parameters are
created on their device in `param_dtype` and drawn from an explicit
torch.Generator by `reset_parameters`; they start with
requires_grad=False (serving needs no graph), and the training
`Trainer` turns gradients on.
"""
from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch.ops.norms import residual_rms_norm, rms_norm


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 dtype=torch.float32, device=None, init_std: float = 0.02):
        super().__init__()
        self.init_std = init_std
        self.weight = _param((num_embeddings, embedding_dim), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids]


class Linear(nn.Module):
    """Bias-free y = x @ W with W [in, out] (RowParallelLinear at tp=1)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype=torch.float32, device=None, init_std: float = 0.02):
        super().__init__()
        self.init_std = init_std
        self.weight = _param((in_features, out_features), dtype, device)

    def reset_parameters(self, generator: torch.Generator):
        self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), dtype, device)

    def reset_parameters(self, generator: torch.Generator = None):
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)

    def residual(self, x: torch.Tensor, h: torch.Tensor):
        """The pre-norm block's fused pair: (norm(x + h), x + h), one
        pass through the fused residual-norm kernel."""
        return residual_rms_norm(x, h, self.weight, self.eps)
