"""Fused SwiGLU, forward and backward: wrappers, plain versions, launch
counters and the autograd Function.

Replaces `hetu_tpu/ops/pallas/swiglu.py` `fused_swiglu` (the forward
`_fwd_kernel` and the custom-VJP backward `_bwd_kernel`).  Kernels:
`csrc/swiglu.cu`, bound by bytes on the H100 (see its header): one
fp32 pass, one rounding per output.  The MLP's fused gate/up
projection gu [..., 2, inner] is the operand: the kernels read its two
halves through their row stride in place, and the backward writes
dgate and dup into the two halves of ONE gradient buffer shaped like
gu, so autograd never assembles the gradient from two slices.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: forward kernel launches (the plain version never counts)
launches = 0
#: backward kernel launches
bwd_launches = 0

_FWD = {torch.float32: "hetu_swiglu_fwd_f32",
        torch.bfloat16: "hetu_swiglu_fwd_bf16"}
_BWD = {torch.float32: "hetu_swiglu_bwd_f32",
        torch.bfloat16: "hetu_swiglu_bwd_bf16"}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 7 + [
    ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {**dict.fromkeys(_FWD.values(), _FWD_ARGS),
               **dict.fromkeys(_BWD.values(), _BWD_ARGS)}


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in fp32, rounded once to gate's dtype (the Pallas
    kernel's arithmetic)."""
    g, u = gate.float(), up.float()
    return (g * torch.sigmoid(g) * u).to(gate.dtype)


def swiglu_bwd_plain(gate, up, dy):
    """(dgate, dup) in fp32, each rounded once (the Pallas `_bwd_kernel`
    arithmetic)."""
    g, u, d = gate.float(), up.float(), dy.float()
    sig = torch.sigmoid(g)
    dg = d * u * sig * (1.0 + g * (1.0 - sig))
    return dg.to(gate.dtype), (d * g * sig).to(up.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., inner] -> a [tokens, inner] view with unit inner stride (a
    copy only when the leading dims cannot merge)."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(1) == 1 else x2.contiguous()


def _check(name, gu):
    if gu.dim() < 2 or gu.shape[-2] != 2:
        raise ValueError(f"{name} takes the fused gate/up [..., 2, inner], "
                         f"got {tuple(gu.shape)}")
    if gu.dtype not in _FWD:
        raise ValueError(f"{name} takes fp32/bf16, got {gu.dtype}")


def swiglu_fwd(gu: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """silu(gu[..., 0, :]) * gu[..., 1, :], no autograd.  `device`
    "cuda" launches the kernel, "cpu" runs the plain version; the tensor
    must lie there."""
    dev = build.check_device("swiglu_fwd", device, gu)
    _check("swiglu_fwd", gu)
    gate, up = gu[..., 0, :], gu[..., 1, :]
    if dev.type == "cpu":
        return swiglu_plain(gate, up)
    g2, u2 = _rows(gate), _rows(up)
    tokens, inner = g2.shape
    out = torch.empty(gate.shape, dtype=gu.dtype, device=gu.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(gu.device):
        err = build.bind("swiglu", _FWD[gu.dtype], _FWD_ARGS)(
            g2.data_ptr(), u2.data_ptr(), out.data_ptr(), tokens, inner,
            g2.stride(0), u2.stride(0),
            torch.cuda.current_stream(gu.device).cuda_stream)
    build.check_launch(err, "swiglu_fwd")
    global launches
    launches += 1
    return out


def swiglu_bwd(gu: torch.Tensor, dy: torch.Tensor, *,
               device="cuda") -> torch.Tensor:
    """The cotangent of gu from the saved gu and the cotangent dy of the
    output: one [..., 2, inner] buffer holding dgate and dup."""
    dev = build.check_device("swiglu_bwd", device, gu, dy)
    _check("swiglu_bwd", gu)
    if dy.shape != gu[..., 0, :].shape or dy.dtype != gu.dtype:
        raise ValueError(f"swiglu_bwd: dy {dy.dtype} {tuple(dy.shape)} "
                         f"does not match gu {gu.dtype} {tuple(gu.shape)}")
    gate, up = gu[..., 0, :], gu[..., 1, :]
    if dev.type == "cpu":
        return torch.stack(swiglu_bwd_plain(gate, up, dy), dim=-2)
    g2, u2, d2 = _rows(gate), _rows(up), _rows(dy)
    tokens, inner = g2.shape
    dgu = torch.empty(gu.shape, dtype=gu.dtype, device=gu.device)
    if dgu.numel() == 0:
        return dgu
    dg2, du2 = dgu[..., 0, :].reshape(-1, inner), \
        dgu[..., 1, :].reshape(-1, inner)        # views, row stride 2*inner
    with torch.cuda.device(gu.device):
        err = build.bind("swiglu", _BWD[gu.dtype], _BWD_ARGS)(
            g2.data_ptr(), u2.data_ptr(), d2.data_ptr(), dg2.data_ptr(),
            du2.data_ptr(), tokens, inner, g2.stride(0), u2.stride(0),
            d2.stride(0), dg2.stride(0), du2.stride(0),
            torch.cuda.current_stream(gu.device).cuda_stream)
    build.check_launch(err, "swiglu_bwd")
    global bwd_launches
    bwd_launches += 1
    return dgu


class _SwiGLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gu, device):
        ctx.save_for_backward(gu)
        ctx.device = device
        return swiglu_fwd(gu, device=device)

    @staticmethod
    def backward(ctx, dy):
        (gu,) = ctx.saved_tensors
        return swiglu_bwd(gu, dy, device=ctx.device), None


def fused_swiglu(gu: torch.Tensor, *, device="cuda") -> torch.Tensor:
    """silu(gate) * up for the fused gate/up projection gu [..., 2,
    inner] (gate = gu[..., 0, :], up = gu[..., 1, :]); gu may be a
    strided view.  Differentiable: the backward runs the backward kernel
    (its plain version on the CPU).  `device` as in `swiglu_fwd`."""
    if torch.is_grad_enabled() and gu.requires_grad:
        return _SwiGLU.apply(gu, device)
    return swiglu_fwd(gu, device=device)
