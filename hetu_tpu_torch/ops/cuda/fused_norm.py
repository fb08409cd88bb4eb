"""Fused residual-add + RMSNorm / LayerNorm, forward and backward:
wrappers, plain versions, launch counters, the launch plan and the
autograd Functions.

Replaces `hetu_tpu/ops/pallas/fused_norm.py` `fused_residual_rmsnorm`
and `fused_residual_layernorm` (`_fwd_kernel` and `_bwd_kernel`, both
arms, the LayerNorm one with and without a bias).  Kernels:
`csrc/fused_norm.cu`, bound by bytes on the H100 (see its header): a
row is held in registers as 16-byte chunks spread over a warp-multiple
of threads (`launch_plan`), so each operand is read once and each
result written once; the backward runs one wave of blocks, each
summing dw (and db) over its rows in registers and writing one partial
row, summed here with one `torch.sum`, deterministic, never with
atomics.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

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
#: each counter's launches by arm (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "bwd_launches", "ln_launches",
                                "ln_bwd_launches")

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_FWD = {t: f"hetu_rmsnorm_fwd_{x}" for t, x in _SUFFIX.items()}
_BWD = {t: f"hetu_rmsnorm_bwd_{x}" for t, x in _SUFFIX.items()}
_LN_FWD = {t: f"hetu_layernorm_fwd_{x}" for t, x in _SUFFIX.items()}
_LN_BWD = {t: f"hetu_layernorm_bwd_{x}" for t, x in _SUFFIX.items()}
# every entry point ends in the plan (vpt, threads, block rows, grid,
# scalar) and the stream
_PLAN_ARGS = [ctypes.c_int] * 5 + [ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float] + _PLAN_ARGS
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float] + _PLAN_ARGS
# the LayerNorm arm adds one pointer to each: the bias, and db's partials
_LN_FWD_ARGS = [ctypes.c_void_p] + _FWD_ARGS
_LN_BWD_ARGS = [ctypes.c_void_p] + _BWD_ARGS
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {**dict.fromkeys(_FWD.values(), _FWD_ARGS),
               **dict.fromkeys(_BWD.values(), _BWD_ARGS),
               **dict.fromkeys(_LN_FWD.values(), _LN_FWD_ARGS),
               **dict.fromkeys(_LN_BWD.values(), _LN_BWD_ARGS)}
#: 16-byte chunks a thread may hold, per storage type: the kernels'
#: instantiations (`kMaxVpt` in csrc/fused_norm.cu), each in a vector
#: and a scalar arm
INSTANCES = {torch.float32: (1, 2, 4), torch.bfloat16: (1, 2),
             torch.float16: (1, 2)}
#: threads a block at most (`kMaxThreads`): a block this large always
#: fits an SM, two where a thread holds one chunk a row
#: (`kBlocksPerSm`), so a backward grid of that many blocks an SM is one
#: wave
MAX_THREADS = 512
#: the widest row: 512 threads x the widest instantiation's chunks
MAX_HIDDEN = 8192
#: narrow rows share a block up to this many threads
_BLOCK_THREADS = 256
#: values a thread holds where a row allows it (registers: the
#: backward keeps a row's values and its dw and db sums)
_THREAD_VALUES = 16
#: the forward's grid-stride cap
_MAX_GRID = 65535


class Plan(NamedTuple):
    """How the kernels lay [rows, hidden] out: a row over `threads`
    threads (a multiple of a warp) holding `vpt` 16-byte chunks each,
    `block_rows` rows a block, `grid` blocks, and the arm: element-wise
    loads and stores (`scalar`) where a width or a base is off 16
    bytes.  The backward writes one partial row a block."""
    vpt: int
    threads: int
    block_rows: int
    grid: int
    scalar: bool


def launch_plan(hidden: int, dtype: torch.dtype, rows: int,
                ptrs: Sequence[int], *, backward: bool, sms: int) -> Plan:
    """The plan for [rows, hidden] of `dtype` whose operands start at
    `ptrs` (data pointers) on a card of `sms` SMs.  A thread takes the
    fewest chunks that keep a row within 256 threads and a thread
    within 16 values (else within 512 threads).  The forward runs a
    block a row group, narrow rows sharing a block up to 256 threads;
    the backward one wave: a block an SM, two where a thread holds one
    chunk, each holding as many rows as MAX_THREADS allows (one partial
    row a block)."""
    esize = torch.finfo(dtype).bits // 8
    chunks = -(-hidden // (16 // esize))
    vpts = INSTANCES[dtype]
    vpt = next((v for v in vpts if -(-chunks // v) <= _BLOCK_THREADS
                and v * 16 // esize <= _THREAD_VALUES), vpts[-1])
    threads = 32 * -(-chunks // (32 * vpt))
    block = MAX_THREADS if backward else _BLOCK_THREADS
    block_rows = max(1, min(block // threads, rows))
    groups = -(-rows // block_rows)
    scalar = (hidden * esize) % 16 != 0 or any(p % 16 for p in ptrs)
    wave = sms * (2 if vpt == 1 else 1)
    return Plan(vpt, threads, block_rows,
                min(groups, wave if backward else _MAX_GRID), scalar)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(symbol, argtypes, name, ptrs, rows, hidden, eps, plan, dev):
    """One launch of `symbol` under `plan`; raises on a refused launch."""
    with torch.cuda.device(dev):
        err = build.bind("fused_norm", symbol, argtypes)(
            *ptrs, rows, hidden, eps, plan.vpt, plan.threads,
            plan.block_rows, plan.grid, int(plan.scalar),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(err, name)


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
        raise ValueError(f"{name} takes matching fp32/bf16/fp16 operands, "
                         f"got {a.dtype} / {b.dtype}")
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
        ptrs = (x.data_ptr(), h.data_ptr(), w.data_ptr(), y.data_ptr(),
                s.data_ptr())
        plan = launch_plan(hidden, x.dtype, rows, ptrs, backward=False,
                           sms=_sms(x.device.index))
        _launch(_FWD[x.dtype], _FWD_ARGS, "residual_rmsnorm_fwd", ptrs,
                rows, hidden, eps, plan, x.device)
        build.count(globals(), "launches", x.dtype)
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
    w = weight.contiguous()
    hidden = s.shape[-1]
    rows = s.numel() // hidden
    dx = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    plan = launch_plan(hidden, s.dtype, rows,
                       (s.data_ptr(), w.data_ptr(), dy.data_ptr(),
                        dr.data_ptr()), backward=True,
                       sms=_sms(s.device.index))
    parts = torch.empty((plan.grid, hidden), dtype=torch.float32,
                        device=s.device)      # no rows: no partials
    if rows:
        _launch(_BWD[s.dtype], _BWD_ARGS, "residual_rmsnorm_bwd",
                (s.data_ptr(), w.data_ptr(), dy.data_ptr(), dr.data_ptr(),
                 dx.data_ptr(), parts.data_ptr()), rows, hidden, eps, plan,
                s.device)
        build.count(globals(), "bwd_launches", s.dtype)
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
        ptrs = (x.data_ptr(), h.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), y.data_ptr(),
                s.data_ptr())
        plan = launch_plan(hidden, x.dtype, rows,
                           [p for p in ptrs if p is not None],
                           backward=False, sms=_sms(x.device.index))
        _launch(_LN_FWD[x.dtype], _LN_FWD_ARGS, "residual_layernorm_fwd",
                ptrs, rows, hidden, eps, plan, x.device)
        build.count(globals(), "ln_launches", x.dtype)
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
    w = weight.contiguous()
    hidden = s.shape[-1]
    rows = s.numel() // hidden
    dx = torch.empty(s.shape, dtype=s.dtype, device=s.device)
    plan = launch_plan(hidden, s.dtype, rows,
                       (s.data_ptr(), w.data_ptr(), dy.data_ptr(),
                        dr.data_ptr()), backward=True,
                       sms=_sms(s.device.index))
    parts = torch.empty((1 + has_bias, plan.grid, hidden),
                        dtype=torch.float32, device=s.device)
    if rows:
        _launch(_LN_BWD[s.dtype], _LN_BWD_ARGS, "residual_layernorm_bwd",
                (s.data_ptr(), w.data_ptr(), dy.data_ptr(), dr.data_ptr(),
                 dx.data_ptr(), parts[0].data_ptr(),
                 parts[1].data_ptr() if has_bias else None), rows, hidden,
                eps, plan, s.device)
        build.count(globals(), "ln_bwd_launches", s.dtype)
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
