#!/usr/bin/env python3
"""Time the port's SwiGLU forward, RoPE and fused residual-norm kernels
for one tree of the repository on one CUDA card.

    python3 tools_elementwise_bench.py [--root DIR]

Imports `chip_smoke` and `hetu_tpu_torch` from DIR (default: this
file's directory; a `git archive` of another commit unpacked there
compares two versions in one call, run in the order A, B, B, A), builds
the three kernels' sources there and, at the shapes of `PERF.md`'s
table, holds each against its plain version (one bf16 ulp; the norms
as chip_smoke.py holds them) and times it as chip_smoke.py times its
cases (CUDA-graph replay, the wrapper call whole: the backward's
partial sum included), beside its bound and the PyTorch composition of
the same function:

- `fused_swiglu` on the strided halves of [tokens, 2, inner]: [8,
  14336], [256, 14336], [4096, 14336] and the draft's [256, 8192];
- `fused_rotary_qk` on contiguous q [b, s, 32, hd] and k [b, s, 8, hd]:
  [8, 1] and [1, 256] at hd 128, [2, 2048] at hd 128 forward and
  backward (`rotary_qk_bwd`), the draft's [1, 256] at hd 64;
- RoPE as the LLaMA attention feeds it, from the fused projection qkv
  [b, s, 8, 4+2, hd] at [2, 2048] (hd 128) and the draft's [1, 256] (hd
  64): the views read in place where the tree's wrapper takes them,
  else (a tree before that) q reshaped and k made contiguous first, the
  copies timed with the launch;
- the fused norms: the RMS forward at [4096, 4096] and the draft's
  [256, 2048] (bf16) beside `x + h` then `F.rms_norm`; the RMS backward
  at [4096, 4096] bf16 beside PyTorch's rms_norm backward then `+ dr`
  (forward + backward less forward, one CUDA graph each); the
  LayerNorm forward and backward at GPT-2-large's [8192, 1280], bf16
  and fp32, with a bias, beside `x + h` then `F.layer_norm` and aten's
  `native_layer_norm_backward` then `+ dr`.

Prints the card line and one JSON line {"root", "ms": {case: ms},
"composition_ms": {case: ms}, "bound_ms": {case: ms}, "rope_views":
true where the tree read the views in place}.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SEED = 0


def swiglu_cases(cs, sw, g):
    import torch
    import torch.nn.functional as F
    res = {}
    for tokens, inner in ((8, 14336), (256, 14336), (4096, 14336),
                          (256, 8192)):
        gu = torch.randn((tokens, 2, inner), generator=g,
                         device="cuda").bfloat16()
        n = tokens * inner
        res[f"fused_swiglu [{tokens},{inner}]"] = cs.case(
            f"fused_swiglu [{tokens},{inner}] bf16", cs.ulps(1),
            lambda i, gu=gu: sw.fused_swiglu(gu),
            lambda i, gu=gu: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
            3 * n * 2, 5 * n,
            composition=lambda i, gu=gu: F.silu(gu[:, 0]) * gu[:, 1])
    return res


def rotation(q, k, cos_t, sin_t, sign):
    """The half-split rotation as PyTorch ops in q's dtype (the
    composition a fused launch replaces)."""
    import torch
    c, s = cos_t.to(q.dtype), (sign * sin_t).to(q.dtype)

    def rot(x):
        x1, x2 = x.chunk(2, dim=-1)
        cx, sx = c[:, :, None, :], s[:, :, None, :]
        return torch.cat([x1 * cx - x2 * sx, x2 * cx + x1 * sx], dim=-1)
    return lambda i: (rot(q), rot(k))


def rotary_cases(cs, ro, g):
    import torch
    from hetu_tpu_torch.ops.rotary import build_rope_cache
    res = {}
    for b, s, hd, bwd in ((8, 1, 128, False), (1, 256, 128, False),
                          (2, 2048, 128, False), (2, 2048, 128, True),
                          (1, 256, 64, False)):
        cos, sin = build_rope_cache(8192, hd, 500000.0, device="cuda")
        pos = torch.randint(0, 2048, (b, s), generator=g, device="cuda")
        cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
        q = torch.randn((b, s, 32, hd), generator=g, device="cuda").bfloat16()
        k = torch.randn((b, s, 8, hd), generator=g, device="cuda").bfloat16()
        sign = -1.0 if bwd else 1.0
        fn = ro.rotary_qk_bwd if bwd else ro.fused_rotary_qk
        name = (f"{'rotary_qk_bwd' if bwd else 'fused_rotary_qk'} "
                f"[{b},{s},32+8,{hd}]")
        res[name] = cs.case(
            name + " bf16", cs.ulps(1),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t, fn=fn: fn(q, k, c, s_),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t, sign=sign:
                ro.rotary_qk_plain(q, k, c, sign * s_),
            2 * (q.numel() + k.numel()) * 2 + 2 * cos_t.numel() * 4,
            3 * (q.numel() + k.numel()),
            composition=rotation(q, k, cos_t, sin_t, sign))
    return res


def attention_rope_cases(cs, ro, g):
    """RoPE on the fused projection's slices, as the attention calls it."""
    import torch
    from hetu_tpu_torch.ops.rotary import build_rope_cache
    res, views = {}, True
    for b, s, hd in ((2, 2048, 128), (1, 256, 64)):
        cos, sin = build_rope_cache(8192, hd, 500000.0, device="cuda")
        pos = torch.randint(0, 2048, (b, s), generator=g, device="cuda")
        cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
        qkv = torch.randn((b, s, 8, 6, hd), generator=g,
                          device="cuda").bfloat16()
        q, k = qkv[..., :4, :], qkv[..., 4, :]
        q4, k4 = q.reshape(b, s, 32, hd), k.contiguous()
        try:
            ro.fused_rotary_qk(q, k, cos_t, sin_t)
        except ValueError:          # a tree whose wrapper takes no views
            views = False
        if views:
            def run(i, q=q, k=k, c=cos_t, s_=sin_t):
                return ro.fused_rotary_qk(q, k, c, s_)
        else:
            def run(i, q=q, k=k, c=cos_t, s_=sin_t, b=b, s=s, hd=hd):
                return ro.fused_rotary_qk(q.reshape(b, s, 32, hd),
                                          k.contiguous(), c, s_)
        name = f"rope from qkv [{b},{s},8,4+2,{hd}]"
        n = q4.numel() + k4.numel()
        res[name] = cs.case(
            name + " bf16", cs.ulps(1), run,
            lambda i, q4=q4, k4=k4, c=cos_t, s_=sin_t:
                ro.rotary_qk_plain(q4, k4, c, s_),
            2 * n * 2 + 2 * cos_t.numel() * 4, 3 * n)
    return res, views


def norm_cases(cs, fn, g):
    """The fused norms at the training and draft shapes (module
    docstring), dy and dr cotangents of one draw."""
    import torch
    import torch.nn.functional as F
    eps, res = 1e-5, {}

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)
    for rows, hidden in ((4096, 4096), (256, 2048)):
        x, h = randn(rows, hidden), randn(rows, hidden)
        w = 1.0 + randn(hidden, dtype=torch.float32, std=0.1)
        wb, n = w.bfloat16(), rows * hidden
        name = f"residual_rmsnorm_fwd [{rows},{hidden}]"
        res[name] = cs.case(
            name + " bf16", cs.ulps(1, 1e-6),
            lambda i, x=x, h=h, w=w: fn.residual_rmsnorm_fwd(x, h, w, eps),
            lambda i, x=x, h=h, w=w: fn.residual_rmsnorm_plain(x, h, w, eps),
            8 * n + hidden * 4, 6 * n,
            composition=lambda i, x=x, h=h, wb=wb, hidden=hidden:
                cs._add_then(F.rms_norm, x, h, (hidden,), wb, eps))
        if rows != 4096:
            continue
        _, s = fn.residual_rmsnorm_fwd(x, h, w, eps)
        dy, dr = randn(rows, hidden), randn(rows, hidden)
        leaves = [t.detach().clone().requires_grad_(True) for t in (s, wb)]

        def fwd_bwd(leaves=leaves, dy=dy, dr=dr, hidden=hidden):
            ds, dw = torch.autograd.grad(
                F.rms_norm(leaves[0], (hidden,), leaves[1], eps), leaves,
                dy)
            return ds + dr, dw
        with torch.no_grad():
            f_ms = cs.device_ms(lambda: F.rms_norm(s, (hidden,), wb, eps))
        fb_ms = cs.device_ms(fwd_bwd)
        name = f"residual_rmsnorm_bwd [{rows},{hidden}]"
        res[name] = cs.case(
            name + " bf16", (cs.ulps(1, 1e-6), cs.rel(1e-5, of_max=True)),
            lambda i: fn.residual_rmsnorm_bwd(s, w, dy, dr, eps),
            lambda i: fn.residual_rmsnorm_bwd_plain(s, w, dy, dr, eps),
            8 * n + 2 * hidden * 4, 11 * n, composition_ms=fb_ms - f_ms)
        del x, h, s, dy, dr, leaves
    rows, hidden = 8192, 1280
    n = rows * hidden
    for dtype in (torch.bfloat16, torch.float32):
        x, h, dy, dr = (randn(rows, hidden, dtype=dtype) for _ in range(4))
        w = 1.0 + randn(hidden, dtype=torch.float32, std=0.1)
        b = randn(hidden, dtype=torch.float32, std=0.1)
        wd, bd = w.to(dtype), b.to(dtype)
        _, s = fn.residual_layernorm_fwd(x, h, w, b, eps)
        _, mean, rstd = torch.ops.aten.native_layer_norm(s, (hidden,), wd,
                                                         bd, eps)
        bf16 = dtype == torch.bfloat16
        tol = cs.ulps(1, 1e-6) if bf16 else cs.rel(1e-5, 1e-5)
        sums = cs.rel(1e-5, of_max=True)
        esize, text = (2, "bf16") if bf16 else (4, "fp32")
        name = f"residual_layernorm_fwd [{rows},{hidden}] {text}"
        res[name] = cs.case(
            name, tol,
            lambda i, x=x, h=h, w=w, b=b: fn.residual_layernorm_fwd(
                x, h, w, b, eps),
            lambda i, x=x, h=h, w=w, b=b: fn.residual_layernorm_plain(
                x, h, w, b, eps),
            4 * n * esize + 2 * hidden * 4, 8 * n,
            composition=lambda i, x=x, h=h, wd=wd, bd=bd: cs._add_then(
                F.layer_norm, x, h, (hidden,), wd, bd, eps))

        def bwd_composition(i, s=s, dy=dy, dr=dr, wd=wd, bd=bd, mean=mean,
                            rstd=rstd):
            dx, dw, db = torch.ops.aten.native_layer_norm_backward(
                dy, s, (hidden,), mean, rstd, wd, bd, [True, True, True])
            return dx + dr, dw, db
        name = f"residual_layernorm_bwd [{rows},{hidden}] {text}"
        res[name] = cs.case(
            name, (tol, sums, sums),
            lambda i, s=s, w=w, dy=dy, dr=dr: fn.residual_layernorm_bwd(
                s, w, dy, dr, eps),
            lambda i, s=s, w=w, dy=dy, dr=dr: fn.residual_layernorm_bwd_plain(
                s, w, dy, dr, eps),
            4 * n * esize + 3 * hidden * 4, 18 * n,
            composition=bwd_composition)
        del x, h, dy, dr, s, mean, rstd
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("tools_elementwise_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hetu_tpu_torch.ops.cuda import build
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    for name, rep in build.build(["swiglu", "rotary", "fused_norm"]).items():
        print(f"--- nvcc -Xptxas -v: {name}\n{rep.strip()}")
    print(f"card: {cs.card_line()}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    res = {**swiglu_cases(cs, sw, g), **rotary_cases(cs, ro, g)}
    more, views = attention_rope_cases(cs, ro, g)
    res.update(more)
    res.update(norm_cases(cs, fn, g))
    print(json.dumps({
        "root": args.root, "ms": {n: r["ms"] for n, r in res.items()},
        "composition_ms": {n: r["composition_ms"] for n, r in res.items()},
        "bound_ms": {n: r["bound_ms"] for n, r in res.items()},
        "rope_views": views}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
