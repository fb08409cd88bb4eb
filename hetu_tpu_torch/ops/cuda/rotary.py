"""Fused rotary forward on q and k: wrapper, plain version and launch
counter.

Replaces `hetu_tpu/ops/pallas/rotary.py` `fused_rotary_qk` (forward).
Kernel: `csrc/rotary.cu`, bound by bytes on the H100 (see its header):
one launch rotates both tensors from one read of the tables.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0

_SYMBOLS = {torch.float32: "hetu_rotary_qk_f32",
            torch.bfloat16: "hetu_rotary_qk_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


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


def fused_rotary_qk(q, k, cos_t, sin_t, *, device="cuda"):
    """Rotate q [b, s, nq, hd] and k [b, s, nk, hd] by the pre-gathered
    per-position tables cos_t/sin_t [b, s, hd/2] in one launch.
    `device` "cuda" launches the kernel, "cpu" runs the plain version;
    the tensors must lie there."""
    dev = build.check_device("fused_rotary_qk", device, q, k, cos_t, sin_t)
    _check(q, k, cos_t, sin_t)
    if dev.type == "cpu":
        return rotary_qk_plain(q, k, cos_t, sin_t)
    for name, t in (("q", q), ("k", k), ("cos_t", cos_t), ("sin_t", sin_t)):
        if not t.is_contiguous():
            raise ValueError(f"fused_rotary_qk needs contiguous {name}")
    b, s, nq, hd = q.shape
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if q.numel() + k.numel() == 0:
        return q_out, k_out
    fn = getattr(build.library("rotary"), _SYMBOLS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), cos_t.data_ptr(),
                 sin_t.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
                 b * s, nq, k.shape[2], hd // 2,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "fused_rotary_qk")
    global launches
    launches += 1
    return q_out, k_out
