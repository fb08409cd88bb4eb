"""Activations, the port of `hetu_tpu/ops/activations.py` (`swiglu`).

`swiglu` is the dispatcher the MLP calls: one call to
`ops.cuda.swiglu.fused_swiglu` — the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.  Both compute in fp32 and round once,
as the reference's Pallas kernel does (the reference's own plain
composition computes in the input dtype instead; in fp32 the two
agree).
"""
import torch

from hetu_tpu_torch.ops.cuda.swiglu import fused_swiglu


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine: silu(gate) * up."""
    return fused_swiglu(gate, up, device=gate.device)
