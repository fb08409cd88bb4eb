"""Fused SwiGLU forward: wrapper, plain version and launch counter.

Replaces `hetu_tpu/ops/pallas/swiglu.py` `fused_swiglu` (forward).
Kernel: `csrc/swiglu.cu`, bound by bytes on the H100 (see its header):
one fp32 pass, one rounding, strided gate/up rows read in place.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0

_SYMBOLS = {torch.float32: "hetu_swiglu_fwd_f32",
            torch.bfloat16: "hetu_swiglu_fwd_bf16"}
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p]


def swiglu_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up in fp32, rounded once to gate's dtype (the Pallas
    kernel's arithmetic)."""
    g, u = gate.float(), up.float()
    return (g * torch.sigmoid(g) * u).to(gate.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., inner] -> a [tokens, inner] view with unit inner stride (a
    copy only when the leading dims cannot merge)."""
    x2 = x.reshape(-1, x.shape[-1])
    return x2 if x2.stride(1) == 1 else x2.contiguous()


def fused_swiglu(gate: torch.Tensor, up: torch.Tensor, *,
                 device="cuda") -> torch.Tensor:
    """silu(gate) * up over [..., inner]; gate/up may be strided views.
    `device` "cuda" launches the kernel, "cpu" runs the plain version;
    the tensors must lie there."""
    dev = build.check_device("fused_swiglu", device, gate, up)
    if gate.shape != up.shape:
        raise ValueError(f"gate/up shapes differ: {tuple(gate.shape)} vs "
                         f"{tuple(up.shape)}")
    if gate.dim() < 1 or gate.dtype != up.dtype or gate.dtype not in _SYMBOLS:
        raise ValueError(f"fused_swiglu takes matching fp32/bf16 tensors, "
                         f"got {gate.dtype} / {up.dtype}")
    if dev.type == "cpu":
        return swiglu_plain(gate, up)
    g2, u2 = _rows(gate), _rows(up)
    tokens, inner = g2.shape
    out = torch.empty(gate.shape, dtype=gate.dtype, device=gate.device)
    if out.numel() == 0:
        return out
    fn = getattr(build.library("swiglu"), _SYMBOLS[gate.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(gate.device):
        err = fn(g2.data_ptr(), u2.data_ptr(), out.data_ptr(), tokens, inner,
                 g2.stride(0), u2.stride(0),
                 torch.cuda.current_stream(gate.device).cuda_stream)
    build.check_launch(err, "fused_swiglu")
    global launches
    launches += 1
    return out
