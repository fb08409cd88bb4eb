"""Fused rotary embedding on q and k, forward and backward: wrapper,
plain version, launch counters and the autograd Function.

Replaces `hetu_tpu/ops/pallas/rotary.py` `fused_rotary_qk` (forward
`_apply` and the custom-VJP backward `_rotary_bwd`).  Kernel:
`csrc/rotary.cu`, bound by bytes on the H100 (see its header): one
launch rotates both tensors from one read of the tables.  The backward
is the same kernel rotating the cotangents by -theta: the wrapper
passes the kernel a sign of -1 for the sin table (no negated copy of
the table is made).  Autograd's cotangents may be strided; the
Function makes them contiguous before the launch.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: forward kernel launches (the plain version never counts)
launches = 0
#: backward kernel launches (the same kernel, rotating by -theta)
bwd_launches = 0

_SYMBOLS = {torch.float32: "hetu_rotary_qk_f32",
            torch.bfloat16: "hetu_rotary_qk_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = dict.fromkeys(_SYMBOLS.values(), _ARGTYPES)


def rotary_qk_plain(q, k, cos_t, sin_t):
    """Half-split rotation of q and k by cos_t/sin_t [b, s, hd/2], fp32
    math, one rounding (the Pallas kernel's arithmetic)."""
    c = cos_t[:, :, None, :].float()
    s = sin_t[:, :, None, :].float()

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _check(q, k, cos_t, sin_t):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected [b, s, heads, hd], got {tuple(q.shape)}"
                         f" / {tuple(k.shape)}")
    b, s, _, hd = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"q/k disagree outside the head dim: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if hd % 2:
        raise ValueError(f"head dim {hd} must be even for the half-split "
                         "rotation")
    if q.dtype != k.dtype or q.dtype not in _SYMBOLS:
        raise ValueError(f"q/k must share an fp32/bf16 dtype, got {q.dtype}"
                         f" / {k.dtype}")
    for name, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        if t.shape != (b, s, hd // 2) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be fp32 [b={b}, s={s}, "
                             f"{hd // 2}], got {t.dtype} {tuple(t.shape)}")


def _rotate(q, k, cos_t, sin_t, sign: float, device, name: str):
    """Rotate q and k by sign * theta; returns (q_out, k_out, launched)."""
    dev = build.check_device(name, device, q, k, cos_t, sin_t)
    _check(q, k, cos_t, sin_t)
    if dev.type == "cpu":
        return (*rotary_qk_plain(q, k, cos_t, sin_t if sign > 0 else -sin_t),
                False)
    for arg, t in (("q", q), ("k", k), ("cos_t", cos_t), ("sin_t", sin_t)):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {arg}")
    b, s, nq, hd = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if q.numel() + k.numel() == 0:
        return q_out, k_out, False
    with torch.cuda.device(q.device):
        err = build.bind("rotary", _SYMBOLS[q.dtype], _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
            q_out.data_ptr(), k_out.data_ptr(), b * s, nq, k.shape[2],
            hd // 2, sign, torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, name)
    return q_out, k_out, True


def rotary_qk_fwd(q, k, cos_t, sin_t, *, device="cuda"):
    """Rotate q [b, s, nq, hd] and k [b, s, nk, hd] by the pre-gathered
    per-position tables cos_t/sin_t [b, s, hd/2] in one launch, no
    autograd.  `device` "cuda" launches the kernel, "cpu" runs the plain
    version; the tensors must lie there."""
    q_out, k_out, launched = _rotate(q, k, cos_t, sin_t, 1.0, device,
                                     "rotary_qk_fwd")
    global launches
    launches += launched
    return q_out, k_out


def rotary_qk_bwd(dq, dk, cos_t, sin_t, *, device="cuda"):
    """The cotangents of q and k from those of the rotated outputs: the
    rotation by -theta (the kernel with sin's sign flipped)."""
    dq_in, dk_in, launched = _rotate(dq, dk, cos_t, sin_t, -1.0, device,
                                     "rotary_qk_bwd")
    global bwd_launches
    bwd_launches += launched
    return dq_in, dk_in


class _RotaryQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos_t, sin_t, device):
        ctx.save_for_backward(cos_t, sin_t)
        ctx.device = device
        return rotary_qk_fwd(q, k, cos_t, sin_t, device=device)

    @staticmethod
    def backward(ctx, dq, dk):
        cos_t, sin_t = ctx.saved_tensors
        dq, dk = rotary_qk_bwd(dq.contiguous(), dk.contiguous(), cos_t,
                               sin_t, device=ctx.device)
        return dq, dk, None, None, None


def fused_rotary_qk(q, k, cos_t, sin_t, *, device="cuda"):
    """Rotate q [b, s, nq, hd] and k [b, s, nk, hd] by the pre-gathered
    per-position tables cos_t/sin_t [b, s, hd/2] in one launch.
    Differentiable in q and k: the backward runs the same kernel by
    -theta (the plain version on the CPU).  `device` as in
    `rotary_qk_fwd`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _RotaryQK.apply(q, k, cos_t, sin_t, device)
    return rotary_qk_fwd(q, k, cos_t, sin_t, device=device)
