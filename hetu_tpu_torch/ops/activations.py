"""Activations, the port of `hetu_tpu/ops/activations.py` (`swiglu`,
`gelu`).

`gelu` is the tanh form, the reference's default (`approximate=True`),
in plain PyTorch: the reference has no Pallas kernel for it.

`swiglu` is the dispatcher the MLP calls on its fused gate/up
projection: one call to `ops.cuda.swiglu.fused_swiglu` — the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors, and
differentiable either way.  Both compute in fp32 and round once, as the
reference's Pallas kernel does (the reference's own plain composition
computes in the input dtype instead; in fp32 the two agree).
"""
import torch

from hetu_tpu_torch.ops.cuda.swiglu import fused_swiglu


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine of gu [..., 2, inner]: silu(gu[..., 0, :]) *
    gu[..., 1, :]."""
    return fused_swiglu(gu, device=gu.device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (jax.nn.gelu(approximate=True))."""
    return torch.nn.functional.gelu(x, approximate="tanh")
