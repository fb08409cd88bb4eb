"""Normalization, the port of `hetu_tpu/ops/norms.py` (`rms_norm`,
`residual_rms_norm`).

`rms_norm` is computed in float32 whatever the input dtype, cast back
at the end.  `residual_rms_norm` is the pre-norm block's fused pair:
one call to `ops.cuda.fused_norm.fused_residual_rmsnorm` — the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors.  Both
follow the reference's Pallas kernel, which normalizes the UNROUNDED
fp32 sum; the reference's fallback rounds s to the input dtype first,
so in bf16 the two differ by the rounding of s (in fp32 they agree).
"""
import torch

from hetu_tpu_torch.ops.cuda.fused_norm import fused_residual_rmsnorm


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (y * weight.float()).to(x.dtype)


def residual_rms_norm(x: torch.Tensor, h: torch.Tensor,
                      weight: torch.Tensor, eps: float = 1e-5):
    """(rms_norm(x + h) * weight, x + h) in one fused pass."""
    return fused_residual_rmsnorm(x, h, weight, eps, device=x.device)
