"""Fused residual-add + RMSNorm / LayerNorm, forward and backward:
wrappers, plain versions, launch counters and the autograd Functions.

Replaces `hetu_tpu/ops/pallas/fused_norm.py` `fused_residual_rmsnorm`
and `fused_residual_layernorm` (`_fwd_kernel` and `_bwd_kernel`, both
arms, the LayerNorm one with and without a bias).  Kernels:
`csrc/fused_norm.cu`, bound by bytes on the H100 (see its header): one
block per row holds the row in registers, so each operand is read once
and each result written once; the backward's dw (and db) is written as
per-block partial rows summed here with one `torch.sum`, deterministic,
never with atomics.
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: forward kernel launches (the plain version never counts)
launches = 0
#: backward kernel launches
bwd_launches = 0
#: LayerNorm forward kernel launches
ln_launches = 0
#: LayerNorm backward kernel launches
ln_bwd_launches = 0

_FWD = {torch.float32: "hetu_rmsnorm_fwd_f32",
        torch.bfloat16: "hetu_rmsnorm_fwd_bf16"}
_BWD = {torch.float32: "hetu_rmsnorm_bwd_f32",
        torch.bfloat16: "hetu_rmsnorm_bwd_bf16"}
_LN_FWD = {torch.float32: "hetu_layernorm_fwd_f32",
           torch.bfloat16: "hetu_layernorm_fwd_bf16"}
_LN_BWD = {torch.float32: "hetu_layernorm_bwd_f32",
           torch.bfloat16: "hetu_layernorm_bwd_bf16"}
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]
# the LayerNorm arm adds one pointer to each: the bias, and db's partials
_LN_FWD_ARGS = [ctypes.c_void_p] + _FWD_ARGS
_LN_BWD_ARGS = [ctypes.c_void_p] + _BWD_ARGS
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {**dict.fromkeys(_FWD.values(), _FWD_ARGS),
               **dict.fromkeys(_BWD.values(), _BWD_ARGS),
               **dict.fromkeys(_LN_FWD.values(), _LN_FWD_ARGS),
               **dict.fromkeys(_LN_BWD.values(), _LN_BWD_ARGS)}
#: the kernels hold a row in 256 threads x at most 32 values each
MAX_HIDDEN = 256 * 32
#: blocks of the backward, so at most this many dw partial rows
_BWD_BLOCKS = 512
#: the LayerNorm backward's: at [8192, 1280] bf16 on an H100 1024 blocks
#: took 0.067 ms where 512 took 0.079, their partial rows summed
_LN_BWD_BLOCKS = 1024


def residual_rmsnorm_plain(x, h, weight, eps: float):
    """s = x + h in fp32; y = s * rsqrt(mean(s^2) + eps) * w from the
    UNROUNDED s; both rounded once to x's dtype (the Pallas kernel's
    arithmetic)."""
    s = x.float() + h.float()
    inv = torch.rsqrt(s.square().mean(dim=-1, keepdim=True) + eps)
    y = s * inv * weight.float()
    return y.to(x.dtype), s.to(x.dtype)


def residual_rmsnorm_bwd_plain(s, weight, dy, dr, eps: float):
    """(dx, dw) from the saved rounded s and the cotangents of y (dy)
    and s (dr); dx is also the cotangent of h."""
    sf = s.float()
    inv = torch.rsqrt(sf.square().mean(dim=-1, keepdim=True) + eps)
    xhat = sf * inv
    dyf = dy.float()
    g = dyf * weight.float()
    dx = inv * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dx = dx + dr.float()
    dw = (dyf * xhat).reshape(-1, s.shape[-1]).sum(dim=0)
    return dx.to(s.dtype), dw.to(weight.dtype)


def residual_layernorm_plain(x, h, weight, bias, eps: float):
    """s = x + h in fp32; y = (s - mean) * rsqrt(var + eps) * w (+ b)
    from the UNROUNDED s, the variance of the centred values; both
    rounded once to x's dtype (the Pallas kernel's arithmetic).  `bias`
    may be None (scale-only)."""
    s = x.float() + h.float()
    mu = s.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((s - mu).square().mean(dim=-1, keepdim=True) + eps)
    y = (s - mu) * inv * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype), s.to(x.dtype)


def residual_layernorm_bwd_plain(s, weight, dy, dr, eps: float,
                                 has_bias: bool = True):
    """(dx, dw, db) from the saved rounded s and the cotangents of y
    (dy) and s (dr); db is None for the scale-only arm."""
    sf = s.float()
    mu = sf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((sf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (sf - mu) * inv
    dyf = dy.float()
    g = dyf * weight.float()
    dx = inv * (g - g.mean(dim=-1, keepdim=True)
                - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dx = dx + dr.float()
    hidden = s.shape[-1]
    dw = (dyf * xhat).reshape(-1, hidden).sum(dim=0)
    db = dyf.reshape(-1, hidden).sum(dim=0).to(weight.dtype) if has_bias \
        else None
    return dx.to(s.dtype), dw.to(weight.dtype), db


def _check(name, a, b, weight, bias=None):
    if a.shape != b.shape or a.dim() < 2:
        raise ValueError(f"{name}: operands must share a [..., hidden] "
                         f"shape, got {tuple(a.shape)} / {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _FWD:
        raise ValueError(f"{name} takes matching fp32/bf16 operands, got "
                         f"{a.dtype} / {b.dtype}")
    if weight.shape != (a.shape[-1],) or weight.dtype != torch.float32:
        raise ValueError(f"{name}: weight must be fp32 [{a.shape[-1]}], "
                         f"got {weight.dtype} {tuple(weight.shape)}")
    if bias is not None and (bias.shape != weight.shape
                             or bias.dtype != torch.float32):
        raise ValueError(f"{name}: bias must be fp32 [{a.shape[-1]}], "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if a.shape[-1] > MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {a.shape[-1]} exceeds the "
                         f"kernel's {MAX_HIDDEN}")


def residual_rmsnorm_fwd(x, h, weight, eps: float = 1e-5, *,
                         device="cuda"):
    """One pass: (y, s) = (rms_norm(x + h) * weight, x + h), no
    autograd.  `device` "cuda" launches the kernel, "cpu" runs the plain
    version; the tensors must lie there."""
    dev = build.check_device("residual_rmsnorm_fwd", device, x, h, weight)
    _check("residual_rmsnorm_fwd", x, h, weight)
    if dev.type == "cpu":
        return residual_rmsnorm_plain(x, h, weight, eps)
    x, h, w = x.contiguous(), h.contiguous(), weight.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty_like(y)
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    if rows:
        with torch.cuda.device(x.device):
            err = build.bind("fused_norm", _FWD[x.dtype], _FWD_ARGS)(
                x.data_ptr(), h.data_ptr(), w.data_ptr(), y.data_ptr(),
                s.data_ptr(), rows, hidden, eps,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check_launch(err, "residual_rmsnorm_fwd")
        global launches
        launches += 1
    return y, s


def residual_rmsnorm_bwd(s, weight, dy, dr, eps: float = 1e-5, *,
                         device="cuda"):
    """(dx, dw) of the fused norm from the saved s and the cotangents dy
    (of y) and dr (of s), no autograd.  dw comes back fp32, in the
    weight's dtype."""
    dev = build.check_device("residual_rmsnorm_bwd", device, s, weight, dy,
                             dr)
    _check("residual_rmsnorm_bwd", s, dy, weight)
    _check("residual_rmsnorm_bwd", s, dr, weight)
    if dev.type == "cpu":
        return residual_rmsnorm_bwd_plain(s, weight, dy, dr, eps)
    s, dy, dr = s.contiguous(), dy.contiguous(), dr.contiguous()
    hidden = s.shape[-1]
    rows = s.numel() // hidden
    grid = max(1, min(rows, _BWD_BLOCKS))
    dx = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    parts = torch.empty((grid, hidden), dtype=torch.float32,
                        device=s.device)
    if rows:
        with torch.cuda.device(s.device):
            err = build.bind("fused_norm", _BWD[s.dtype], _BWD_ARGS)(
                s.data_ptr(), weight.contiguous().data_ptr(),
                dy.data_ptr(), dr.data_ptr(), dx.data_ptr(),
                parts.data_ptr(), rows, hidden, grid, eps,
                torch.cuda.current_stream(s.device).cuda_stream)
        build.check_launch(err, "residual_rmsnorm_bwd")
        global bwd_launches
        bwd_launches += 1
    else:
        parts.zero_()
    return dx, parts.sum(dim=0)


class _ResidualRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, weight, eps, device):
        y, s = residual_rmsnorm_fwd(x, h, weight, eps, device=device)
        ctx.save_for_backward(s, weight)
        ctx.eps, ctx.device = eps, device
        return y, s

    @staticmethod
    def backward(ctx, dy, dr):
        s, weight = ctx.saved_tensors
        dx, dw = residual_rmsnorm_bwd(s, weight, dy, dr, ctx.eps,
                                      device=ctx.device)
        # s = x + h: x and h take the same cotangent
        return dx, dx, dw, None, None


def fused_residual_rmsnorm(x, h, weight, eps: float = 1e-5, *,
                           device="cuda"):
    """s = x + h; y = rms_norm(s) * weight, in one pass.  Returns (y, s).
    Differentiable: the backward runs the backward kernel (its plain
    version on the CPU).  `device` as in `residual_rmsnorm_fwd`."""
    if torch.is_grad_enabled() and (x.requires_grad or h.requires_grad
                                    or weight.requires_grad):
        return _ResidualRMSNorm.apply(x, h, weight, eps, device)
    return residual_rmsnorm_fwd(x, h, weight, eps, device=device)


def residual_layernorm_fwd(x, h, weight, bias, eps: float = 1e-5, *,
                           device="cuda"):
    """One pass: (y, s) = (layer_norm(x + h) * weight (+ bias), x + h),
    no autograd; `bias` None is the scale-only arm.  `device` as in
    `residual_rmsnorm_fwd`."""
    tensors = (x, h, weight) + (() if bias is None else (bias,))
    dev = build.check_device("residual_layernorm_fwd", device, *tensors)
    _check("residual_layernorm_fwd", x, h, weight, bias)
    if dev.type == "cpu":
        return residual_layernorm_plain(x, h, weight, bias, eps)
    x, h, w = x.contiguous(), h.contiguous(), weight.contiguous()
    b = None if bias is None else bias.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty_like(y)
    hidden = x.shape[-1]
    rows = x.numel() // hidden
    if rows:
        with torch.cuda.device(x.device):
            err = build.bind("fused_norm", _LN_FWD[x.dtype], _LN_FWD_ARGS)(
                x.data_ptr(), h.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), y.data_ptr(),
                s.data_ptr(), rows, hidden, eps,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check_launch(err, "residual_layernorm_fwd")
        global ln_launches
        ln_launches += 1
    return y, s


def residual_layernorm_bwd(s, weight, dy, dr, eps: float = 1e-5, *,
                           has_bias: bool = True, device="cuda"):
    """(dx, dw, db) of the fused LayerNorm from the saved s and the
    cotangents dy (of y) and dr (of s), no autograd.  dw and db come
    back fp32; db is None when `has_bias` is off (the kernel then writes
    no db partials)."""
    dev = build.check_device("residual_layernorm_bwd", device, s, weight,
                             dy, dr)
    _check("residual_layernorm_bwd", s, dy, weight)
    _check("residual_layernorm_bwd", s, dr, weight)
    if dev.type == "cpu":
        return residual_layernorm_bwd_plain(s, weight, dy, dr, eps, has_bias)
    s, dy, dr = s.contiguous(), dy.contiguous(), dr.contiguous()
    hidden = s.shape[-1]
    rows = s.numel() // hidden
    grid = max(1, min(rows, _LN_BWD_BLOCKS))
    dx = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    parts = torch.empty((1 + has_bias, grid, hidden), dtype=torch.float32,
                        device=s.device)
    if rows:
        with torch.cuda.device(s.device):
            err = build.bind("fused_norm", _LN_BWD[s.dtype], _LN_BWD_ARGS)(
                s.data_ptr(), weight.contiguous().data_ptr(),
                dy.data_ptr(), dr.data_ptr(), dx.data_ptr(),
                parts[0].data_ptr(),
                parts[1].data_ptr() if has_bias else None, rows, hidden,
                grid, eps, torch.cuda.current_stream(s.device).cuda_stream)
        build.check_launch(err, "residual_layernorm_bwd")
        global ln_bwd_launches
        ln_bwd_launches += 1
    else:
        parts.zero_()
    sums = parts.sum(dim=1)
    return dx, sums[0], sums[1] if has_bias else None


class _ResidualLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h, weight, bias, eps, device):
        y, s = residual_layernorm_fwd(x, h, weight, bias, eps, device=device)
        ctx.save_for_backward(s, weight)
        ctx.eps, ctx.device, ctx.has_bias = eps, device, bias is not None
        return y, s

    @staticmethod
    def backward(ctx, dy, dr):
        s, weight = ctx.saved_tensors
        dx, dw, db = residual_layernorm_bwd(s, weight, dy, dr, ctx.eps,
                                            has_bias=ctx.has_bias,
                                            device=ctx.device)
        # s = x + h: x and h take the same cotangent
        return dx, dx, dw, db, None, None


def fused_residual_layernorm(x, h, weight, bias, eps: float = 1e-5, *,
                             device="cuda"):
    """s = x + h; y = layer_norm(s) * weight (+ bias), in one pass.
    Returns (y, s); `bias` None is the scale-only LayerNorm.
    Differentiable: the backward runs the backward kernel (its plain
    version on the CPU).  `device` as in `residual_rmsnorm_fwd`."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, h, weight, bias)):
        return _ResidualLayerNorm.apply(x, h, weight, bias, eps, device)
    return residual_layernorm_fwd(x, h, weight, bias, eps, device=device)
