"""Normalization, the port of `hetu_tpu/ops/norms.py` (`rms_norm`).

Computed in float32 whatever the input dtype, cast back at the end.
"""
import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)
