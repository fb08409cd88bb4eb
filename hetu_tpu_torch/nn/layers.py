"""Single-device layers: the port of `hetu_tpu/nn/layers.py` `Embedding`
and `hetu_tpu/nn/parallel.py` `ParallelRMSNorm` / `ParallelLayerNorm`
(each with its fused `residual` pair) / `RowParallelLinear`
(tensor/sequence parallelism arrives with the multi-GPU slice).

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

from hetu_tpu_torch.nn.remat import project
from hetu_tpu_torch.ops.norms import (layer_norm, residual_layer_norm,
                                      residual_rms_norm, rms_norm)


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
    """y = x @ W (+ b) with W [in, out] (RowParallelLinear at tp=1); the
    bias starts at zero, as the reference's does."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = False, dtype=torch.float32, device=None,
                 init_std: float = 0.02):
        super().__init__()
        self.init_std = init_std
        self.weight = _param((in_features, out_features), dtype, device)
        self.bias = _param((out_features,), dtype, device) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        self.weight.normal_(0.0, self.init_std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = project(x, self.weight)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


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
        pass through the fused residual-norm kernel (which takes the
        gain in fp32, as `forward` applies it; an fp32 gain is passed
        as it is)."""
        return residual_rms_norm(x, h, self.weight.float(), self.eps)


class LayerNorm(nn.Module):
    """LayerNorm with a unit gain and, unless `bias` is off, a zero bias
    (ParallelLayerNorm at tp=1)."""

    def __init__(self, dim: int, *, eps: float = 1e-5, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param((dim,), dtype, device)
        self.bias = _param((dim,), dtype, device) if bias else None

    def reset_parameters(self, generator: torch.Generator = None):
        self.weight.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)

    def residual(self, x: torch.Tensor, h: torch.Tensor):
        """The pre-norm block's fused pair: (norm(x + h), x + h), one
        pass through the fused residual-norm kernel's LayerNorm arm
        (gain and bias in fp32, as `RMSNorm.residual` passes its gain)."""
        bias = None if self.bias is None else self.bias.float()
        return residual_layer_norm(x, h, self.weight.float(), bias, self.eps)
