#!/usr/bin/env python3
"""Time the fused residual-norm kernels under the launch plan
`ops/cuda/fused_norm.py` `launch_plan` picks and under alternatives, on
one CUDA card.

    python3 tools_norm_plans.py

The kernels take their plan (16-byte chunks a thread, threads a row,
rows a block, grid and arm) from the
caller, so one build serves every variant.  Each plan's outputs are
held against the plain version (as chip_smoke.py holds the kernels)
before it is timed as chip_smoke.py times its cases (CUDA-graph replay
of the launch alone; the backward's partial sum is timed once, apart):

- the RMS forward at the draft's [256, 2048] and [4096, 4096], bf16;
- the RMS backward at [4096, 4096] bf16 and the LayerNorm backward at
  [8192, 1280] bf16 and fp32: rows a block and blocks an SM (the grid,
  so the partial rows).

Prints the card line and one JSON line {case: {plan: ms}}; the plan
`launch_plan` picks is marked "(plan)".
"""
from __future__ import annotations

import json
import sys

import torch

EPS = 1e-5


def forward_cases(cs, fn, g, sms):
    res = {}
    for rows, hidden in ((256, 2048), (4096, 4096)):
        x, h = (torch.randn((rows, hidden), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        w = 1.0 + 0.1 * torch.randn(hidden, generator=g, device="cuda")
        y, s = torch.empty_like(x), torch.empty_like(x)
        ptrs = (x.data_ptr(), h.data_ptr(), w.data_ptr(), y.data_ptr(),
                s.data_ptr())
        chosen = fn.launch_plan(hidden, x.dtype, rows, ptrs, backward=False,
                                sms=sms)
        plans = {"(plan)": chosen}
        for vpt, threads, block_rows in ((1, 256, 1), (2, 128, 1),
                                         (2, 128, 2), (1, 512, 1),
                                         (2, 256, 1)):
            if threads * vpt * 8 < hidden or threads * block_rows > 512 \
                    or (threads - 32) * vpt * 8 >= hidden:
                continue
            p = fn.Plan(vpt, threads, block_rows,
                        -(-rows // block_rows), False)
            plans.setdefault(f"vpt {vpt} x {threads} x {block_rows} rows",
                             p)
        case = f"residual_rmsnorm_fwd [{rows},{hidden}] bf16"
        res[case] = {}
        ref = fn.residual_rmsnorm_plain(x, h, w, EPS)
        for name, p in plans.items():
            def run(p=p):
                fn._launch(fn._FWD[x.dtype], fn._FWD_ARGS, case, ptrs, rows,
                           hidden, EPS, p, x.device)
                return y, s
            cs.compare(f"{case} {name}", cs.ulps(1, 1e-6), run(), ref)
            res[case][f"{name} {tuple(p)}"] = cs.device_ms(run)
    return res


def backward_cases(cs, fn, g, sms):
    res = {}
    for kind, rows, hidden, dtype in (
            ("rms", 4096, 4096, torch.bfloat16),
            ("ln", 8192, 1280, torch.bfloat16),
            ("ln", 8192, 1280, torch.float32)):
        s, dy, dr = (torch.randn((rows, hidden), generator=g, device="cuda")
                     .to(dtype) for _ in range(3))
        w = 1.0 + 0.1 * torch.randn(hidden, generator=g, device="cuda")
        dx = torch.empty_like(s)
        ins = (s.data_ptr(), w.data_ptr(), dy.data_ptr(), dr.data_ptr())
        chosen = fn.launch_plan(hidden, dtype, rows, ins, backward=True,
                                sms=sms)
        plans = {"(plan)": chosen}
        for block_rows in range(1, fn.MAX_THREADS // chosen.threads + 1):
            for per_sm in (1, 2, 3, 4):
                if per_sm * block_rows * chosen.threads > 1024:
                    continue
                plans.setdefault(
                    f"{block_rows} rows a block, {per_sm} an SM",
                    chosen._replace(block_rows=block_rows,
                                    grid=sms * per_sm))
        text = "bf16" if dtype == torch.bfloat16 else "fp32"
        case = (f"residual_{'rmsnorm' if kind == 'rms' else 'layernorm'}"
                f"_bwd [{rows},{hidden}] {text}")
        res[case] = {}
        if kind == "rms":
            ref = fn.residual_rmsnorm_bwd_plain(s, w, dy, dr, EPS)
        else:
            ref = fn.residual_layernorm_bwd_plain(s, w, dy, dr, EPS)
        tol = cs.ulps(1, 1e-6) if dtype == torch.bfloat16 \
            else cs.rel(1e-5, 1e-5)
        for name, p in plans.items():
            parts = torch.empty((1 + (kind == "ln"), p.grid, hidden),
                                device="cuda")
            sym = (fn._BWD if kind == "rms" else fn._LN_BWD)[dtype]
            args = fn._BWD_ARGS if kind == "rms" else fn._LN_BWD_ARGS
            ptrs = ins + (dx.data_ptr(), parts[0].data_ptr()) + (
                (parts[1].data_ptr(),) if kind == "ln" else ())

            def run(p=p, sym=sym, args=args, ptrs=ptrs):
                fn._launch(sym, args, case, ptrs, rows, hidden, EPS, p,
                           s.device)
                return dx, parts

            def full(run=run):
                _, parts = run()
                return (dx,) + tuple(parts.sum(dim=1))
            cs.compare(f"{case} {name}", (tol,) + (cs.rel(
                1e-5, of_max=True),) * (len(ref) - 1), full(), ref)
            res[case][f"{name} {tuple(p)}"] = cs.device_ms(run)
            res[case][f"{name} + partial sum"] = cs.device_ms(full)
        del s, dy, dr, dx
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("tools_norm_plans: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hetu_tpu_torch.ops.cuda import build
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    build.build(["fused_norm"])
    print(f"card: {cs.card_line()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(0)
    res = {**forward_cases(cs, fn, g, sms), **backward_cases(cs, fn, g, sms)}
    for case, times in res.items():
        print(case)
        for name, ms in times.items():
            print(f"  {ms:.5f}  {name}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
