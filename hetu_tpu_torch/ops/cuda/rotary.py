"""Fused rotary embedding on q and k, forward and backward: wrapper,
plain version, launch counters and the autograd Function.

Replaces `hetu_tpu/ops/pallas/rotary.py` `fused_rotary_qk` (forward
`_apply` and the custom-VJP backward `_rotary_bwd`).  Kernel:
`csrc/rotary.cu`, bound by bytes on the H100 (see its header): one
launch rotates both tensors from one read of the tables.  The backward
is the same kernel rotating the cotangents by -theta: the wrapper
passes the kernel a sign of -1 for the sin table (no negated copy of
the table is made).

The kernel reads q and k in place through their strides, so the
LLaMA attention hands it slices of its fused QKV projection [b, s,
n_kv, group+2, hd] without a copy: q as the grouped view [b, s, n_kv,
group, hd] (q head h at (h // group, h % group), the head order of
`reshape(b, s, nq, hd)`), k as [b, s, n_kv, hd].  The head dim must
have unit stride; the outputs are contiguous [b, s, nq, hd] and [b, s,
nk, hd].  Autograd's cotangents are taken with their strides too.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: forward kernel launches (the plain version never counts)
launches = 0
#: backward kernel launches (the same kernel, rotating by -theta)
bwd_launches = 0
#: each counter's launches by arm (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "bwd_launches")

_SYMBOLS = {torch.float32: "hetu_rotary_qk_f32",
            torch.bfloat16: "hetu_rotary_qk_bf16",
            torch.float16: "hetu_rotary_qk_f16"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 7
             + [ctypes.c_float, ctypes.c_void_p])
#: the largest head dim the kernel takes (a block's thread per pair)
MAX_HEAD_DIM = 2048
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


def _heads(q):
    """q [b, s, nq, hd] or the grouped view [b, s, n_kv, group, hd] ->
    (nq, group, its strides as [b, s, kv head, group]); a size-1 dim's
    stride is 0 (it is never stepped)."""
    if q.dim() == 4:
        st = (q.stride(0), q.stride(1), q.stride(2), 0)
        dims, nq, group = q.shape[:3] + (1,), q.shape[2], 1
    else:
        st = q.stride()[:4]
        dims, nq, group = q.shape[:4], q.shape[2] * q.shape[3], q.shape[3]
    return nq, group, tuple(0 if n == 1 else x for n, x in zip(dims, st))


def _check(name, q, k, cos_t, sin_t):
    if q.dim() not in (4, 5) or k.dim() != 4:
        raise ValueError(f"{name}: expected q [b, s, nq, hd] or [b, s, "
                         f"n_kv, group, hd] and k [b, s, nk, hd], got "
                         f"{tuple(q.shape)} / {tuple(k.shape)}")
    b, s, hd = q.shape[0], q.shape[1], q.shape[-1]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"{name}: q/k disagree outside the heads: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if hd % 2 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} must be even and at most "
                         f"{MAX_HEAD_DIM} for the half-split rotation")
    if q.dtype != k.dtype or q.dtype not in _SYMBOLS:
        raise ValueError(f"{name}: q/k must share an fp32/bf16/fp16 dtype, "
                         f"got {q.dtype} / {k.dtype}")
    for arg, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        if t.shape != (b, s, hd // 2) or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be fp32 [b={b}, s={s}, "
                             f"{hd // 2}], got {t.dtype} {tuple(t.shape)}")


def _rotate(q, k, cos_t, sin_t, sign: float, device, name: str):
    """Rotate q and k by sign * theta; returns (q_out [b, s, nq, hd],
    k_out, launched)."""
    dev = build.check_device(name, device, q, k, cos_t, sin_t)
    _check(name, q, k, cos_t, sin_t)
    b, s, hd = q.shape[0], q.shape[1], q.shape[-1]
    nq, group, q_st = _heads(q)
    if dev.type == "cpu":
        return (*rotary_qk_plain(q.reshape(b, s, nq, hd), k, cos_t,
                                 sin_t if sign > 0 else -sin_t), False)
    for arg, t in (("q", q), ("k", k)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs {arg} with a unit stride on the "
                             f"head dim, got strides {t.stride()}")
    for arg, t in (("cos_t", cos_t), ("sin_t", sin_t)):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous {arg}")
    nk = k.shape[2]
    q_out = torch.empty((b, s, nq, hd), dtype=q.dtype, device=q.device)
    k_out = torch.empty((b, s, nk, hd), dtype=k.dtype, device=k.device)
    if q_out.numel() + k_out.numel() == 0:
        return q_out, k_out, False
    k_st = tuple(0 if n == 1 else x
                 for n, x in zip(k.shape[:3], k.stride()[:3]))
    with torch.cuda.device(q.device):
        err = build.bind("rotary", _SYMBOLS[q.dtype], _ARGTYPES)(
            q.data_ptr(), k.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
            q_out.data_ptr(), k_out.data_ptr(), b, s, nq, nk, group, hd // 2,
            *q_st, *k_st, sign,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, name)
    return q_out, k_out, True


def rotary_qk_fwd(q, k, cos_t, sin_t, *, device="cuda"):
    """Rotate q [b, s, nq, hd] (or the grouped view [b, s, n_kv, group,
    hd]) and k [b, s, nk, hd] by the pre-gathered per-position tables
    cos_t/sin_t [b, s, hd/2] in one launch, no autograd; returns
    contiguous q [b, s, nq, hd] and k.  `device` "cuda" launches the
    kernel, "cpu" runs the plain version; the tensors must lie there."""
    q_out, k_out, launched = _rotate(q, k, cos_t, sin_t, 1.0, device,
                                     "rotary_qk_fwd")
    if launched:
        build.count(globals(), "launches", q.dtype)
    return q_out, k_out


def rotary_qk_bwd(dq, dk, cos_t, sin_t, *, device="cuda"):
    """The cotangents of q and k from those of the rotated outputs: the
    rotation by -theta (the kernel with sin's sign flipped)."""
    dq_in, dk_in, launched = _rotate(dq, dk, cos_t, sin_t, -1.0, device,
                                     "rotary_qk_bwd")
    if launched:
        build.count(globals(), "bwd_launches", dq.dtype)
    return dq_in, dk_in


def _unit_last(t):
    """t itself where its last dim has unit stride (the kernel takes any
    other strides), else a contiguous copy."""
    return t if t.stride(-1) == 1 else t.contiguous()


class _RotaryQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, cos_t, sin_t, device):
        ctx.save_for_backward(cos_t, sin_t)
        ctx.device, ctx.q_shape = device, q.shape
        return rotary_qk_fwd(q, k, cos_t, sin_t, device=device)

    @staticmethod
    def backward(ctx, dq, dk):
        cos_t, sin_t = ctx.saved_tensors
        dq, dk = rotary_qk_bwd(_unit_last(dq), _unit_last(dk), cos_t, sin_t,
                               device=ctx.device)
        # dq in the shape of q's view (the grouped slice of the fused
        # projection): autograd scatters it into that slice's gradient
        return dq.view(ctx.q_shape), dk, None, None, None


def fused_rotary_qk(q, k, cos_t, sin_t, *, device="cuda"):
    """Rotate q [b, s, nq, hd] (or the grouped view [b, s, n_kv, group,
    hd] of a fused QKV projection, read in place) and k [b, s, nk, hd]
    by the pre-gathered per-position tables cos_t/sin_t [b, s, hd/2] in
    one launch; returns contiguous q [b, s, nq, hd] and k.
    Differentiable in q and k: the backward runs the same kernel by
    -theta (the plain version on the CPU).  `device` as in
    `rotary_qk_fwd`."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _RotaryQK.apply(q, k, cos_t, sin_t, device)
    return rotary_qk_fwd(q, k, cos_t, sin_t, device=device)
