"""Fused AdamW update of one parameter leaf, in place: wrapper, plain
version and launch counter.

Replaces `hetu_tpu/ops/pallas/adam.py` `adam_update`.  Kernel:
`csrc/adam.cu`, bound by bytes on the H100 (28 bytes per fp32
element; see its header): one pass reads p, g, m and v and writes p, m
and v in place.  Every leaf goes through it: the Pallas `% 128` gate
is a TPU lane rule, and the CUDA kernel takes any element count.
lr, c1 and c2 arrive as host floats (the optimizer computes them in
fp32 from the step count, as JAX does in its graph), so the update
never reads a value back from the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0

_SYMBOLS = {torch.float32: "hetu_adam_f32", torch.bfloat16: "hetu_adam_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
    ctypes.c_float] * 9 + [ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = dict.fromkeys(_SYMBOLS.values(), _ARGTYPES)


def _f32(x) -> float:
    """A Python float holding x rounded to fp32, the value both the
    kernel (by value) and the plain version (as a scalar) compute with."""
    return float(np.float32(x))


def _scalars(lr, c1, c2, b1, b2, eps, weight_decay):
    """(b1, 1 - b1, b2, 1 - b2, lr, c1, c2, eps, wd) in fp32; 1 - b is
    taken in double and then rounded, as JAX's `(1.0 - b1) * g` does
    with its Python-float b1."""
    return tuple(_f32(v) for v in (b1, 1.0 - b1, b2, 1.0 - b2, lr, c1, c2,
                                   eps, weight_decay))


def adam_plain(p, g, m, v, lr, c1, c2, *, b1, b2, eps, weight_decay):
    """The kernel's arithmetic in PyTorch ops, updating p, m and v in
    place (fp32 math; p rounded once to its dtype)."""
    b1, omb1, b2, omb2, lr, c1, c2, eps, wd = _scalars(
        lr, c1, c2, b1, b2, eps, weight_decay)
    # the divisors as tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, a second rounding (filled on
    # the device, so the update can be captured in a CUDA graph)
    c1, c2 = (torch.full((), c, dtype=torch.float32, device=m.device)
              for c in (c1, c2))
    gf = g.float()
    m_new = m * b1 + gf * omb1
    v_new = v * b2 + (gf * gf) * omb2
    pf = p.float()
    upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + pf * wd
    p.copy_(pf - upd * lr)
    m.copy_(m_new)
    v.copy_(v_new)


def adam_update(p, g, m, v, lr, c1, c2, *, b1: float, b2: float,
                eps: float, weight_decay: float, device="cuda") -> None:
    """One leaf's AdamW step, IN PLACE on p (fp32 or bf16), m and v
    (fp32), from the fp32 gradient g.  lr, c1 = 1 - b1^step and
    c2 = 1 - b2^step are host numbers.  `device` "cuda" launches the
    kernel, "cpu" runs the plain version; the tensors must lie there."""
    dev = build.check_device("adam_update", device, p, g, m, v)
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p/g/m/v shapes must match, got {tuple(p.shape)} "
                         f"{tuple(g.shape)} {tuple(m.shape)} "
                         f"{tuple(v.shape)}")
    if p.dtype not in _SYMBOLS or (g.dtype, m.dtype, v.dtype) != (
            torch.float32,) * 3:
        raise ValueError(f"adam_update takes an fp32/bf16 p and fp32 g/m/v, "
                         f"got {p.dtype} {g.dtype} {m.dtype} {v.dtype}")
    with torch.no_grad():
        if dev.type == "cpu":
            adam_plain(p, g, m, v, lr, c1, c2, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay)
            return
        for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"adam_update needs contiguous {name}")
        if p.numel() == 0:
            return
        with torch.cuda.device(p.device):
            err = build.bind("adam", _SYMBOLS[p.dtype], _ARGTYPES)(
                p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                p.numel(), *_scalars(lr, c1, c2, b1, b2, eps, weight_decay),
                torch.cuda.current_stream(p.device).cuda_stream)
    build.check_launch(err, "adam_update")
    global launches
    launches += 1
