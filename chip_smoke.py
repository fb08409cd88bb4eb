#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hetu_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and nothing carries on:

 1. the card: `nvidia-smi` name and power limit, `torch` device name
    (no CUDA device -> exit 1 before anything else runs);
 2. build: every CUDA kernel from hetu_tpu_torch/csrc, one nvcc per
    source, all at once; prints the ptxas report (registers, shared
    memory, spills) and the build time;
 3. kernels: each kernel at the shapes each path gives it for Llama-3-8B
    (serving: decode and a 256-token prefill chunk, checked here;
    training: 2 x 2048 tokens per micro-batch, every kernel of that
    path, SwiGLU and RoPE forward again at its shapes, checked after
    phase 6, so their large buffers and CUDA graphs never precede the
    host-bound serving run), held against its plain PyTorch version on
    the same inputs at the stated tolerance, and timed on the card
    (CUDA-graph replay, CUDA events) beside its plain version, its
    bound — the larger of the bytes it must move over 3.35 TB/s and its
    operations over the peak rate of their type (all of them fp32 math
    outside the tensor cores, 67 TFLOP/s) — and, for AdamW, the one
    PyTorch call that computes the same update (`torch._fused_adamw_`,
    timed as a yardstick only; the port never calls it).  Tolerances:
    one bf16 ulp where a kernel rounds once to bf16 (paged attention on
    bf16 pools: the plain version on the same values in fp32, rounded
    once — half an ulp, plus 1e-5 for fp32 summation order); fp32
    outputs 1e-5 relative (the norm's dw, a sum over 4096 rows taken in
    another order: 1e-5 of its largest entry); AdamW one fp32 ulp
    (rtol 3e-7), its bf16 parameter one bf16 ulp;
 4. serving reference: Llama-3-8B widths cut to 2 layers, in fp32 — the
    serving engine on the card (the kernels) against the same engine on
    the CPU (the plain versions), same weights and trace: prefill logits
    within 1e-3 and identical greedy tokens;
 5. serving: Llama-3-8B at full width and depth (bf16 weights drawn on
    the card from --seed) behind `ServingEngine(ServeConfig(num_slots=8,
    page_size=16, max_len=2048, prefill_chunk=256))`: warmup, then 8
    Poisson-arriving requests with 64-1024-token prompts and 32 new
    tokens each.  Every launch count is set to 0 just before the run and
    read just after; each serving kernel must have launched;
 6. serving time: one decode step over 8 slots and one 256-token
    prefill chunk, each timed on the host (enqueue, and wall to a
    synchronize) and under torch.profiler (the summed time of the
    kernels it saw on the card): the card's idle share and its heaviest
    kernels;
 7. training reference: a narrow Llama (hidden 512, 4 q / 2 kv heads of
    128, SwiGLU 1536, vocab 4096, 2 layers, fp32) takes 3 `Trainer`
    steps on the card (the kernels) and on the CPU (the plain versions)
    from the same weights and batches: losses and grad norms within
    1e-5 relative; parameters within 2 x the summed lr everywhere and
    within 1e-5 on all but 0.1% of elements (AdamW divides by sqrt(v),
    so a gradient within rounding of zero moves its element by up to lr
    in one run and not the other);
 8. training: Llama-3-8B at full width cut to 8 layers (fp32 parameters
    and AdamW state, bf16 compute, per-block recompute, the dense
    attention) through `Trainer(model, TrainingConfig(global_batch_size=4,
    micro_batch_size=2, seq_len=2048), device="cuda").train(...)`, 6
    steps on one repeated seeded batch.  Every launch count is set to 0
    just before and read after each step: each training kernel must
    grow by exactly its count per step (forward kernels 2 x layers x
    micro-batches under recompute, backward kernels layers x
    micro-batches, AdamW once per parameter leaf).  The first loss lies
    within 0.5 of ln(vocab) + sigma^2 / 2 (sigma = 0.02 * sqrt(4096),
    the logits' spread at init), every loss is finite and the last is
    below the first.  Prints step time p50, tokens/s, mfu (model FLOPs
    per token, no recompute, over 989 TFLOP/s), peak memory; then one
    step under torch.profiler (idle share, heaviest kernels, the time of
    each ported kernel in the step) and the dense attention and the
    LM head + loss timed apart at the step's shapes.  Past 70 GiB of
    peak memory the micro-batch halves (printed as a cut).

Prints the `kernels` JSON line, the nvidia-smi line, and last the
`{"ok": true, "device": ...}` line.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12}    # fp32 outside the tensor cores
TRAIN_PEAK_GIB = 70.0


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events, so host launch overhead
    does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (inner * reps)


def event_ms(fn, reps: int = 5) -> float:
    """Time of one call between CUDA events, after one warm call (for
    work that allocates through autograd and cannot be graph-captured;
    at these sizes the card, not the host, sets the time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ulps(n: float, atol: float = 0.0):
    """Tolerance: |a - b| <= n bf16 ulps of the larger of the two + atol;
    returns how far the worst element goes past it (<= 0: within)."""
    def excess(a, b):
        a, b = a.float(), b.float()
        _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
        ulp = torch.ldexp(torch.ones_like(a), exp - 8)  # 8 significant bits
        return ((a - b).abs() - n * ulp - atol).max().item()
    excess.text = f"{n} bf16 ulp + {atol}"
    return excess


def rel(rtol: float, atol: float = 0.0, of_max: bool = False):
    """Tolerance: |a - b| <= rtol * |b| + atol, or with `of_max`
    rtol * max|b| + atol."""
    def excess(a, b):
        a, b = a.float(), b.float()
        scale = b.abs().max() if of_max else b.abs()
        return ((a - b).abs() - rtol * scale - atol).max().item()
    excess.text = (f"{rtol} x {'max|ref|' if of_max else '|ref|'}"
                   f" + {atol}")
    return excess


def bound(nbytes: float, ops: float, op_dtype=torch.float32) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def case(label, tols, run, plain, nbytes, ops, *, exact=None, library=None):
    """Hold run(0) against plain(0) (or `exact`(0), the plain version on
    the same values in fp32, where given), output by output with `tols`
    (one tolerance, or one per output); then time the kernel, its plain
    version and `library` (one PyTorch call computing the same function,
    a yardstick) on the card.  Each is called with a running count, so a
    case can cycle through copies of its inputs."""
    out, ref = run(0), (exact or plain)(0)
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    tols = tols if isinstance(tols, tuple) else (tols,) * len(outs)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(outs, refs))
    excess = max(t(a, b) for t, a, b in zip(tols, outs, refs))
    check(all(bool(torch.isfinite(a).all()) for a in outs),
          f"{label}: non-finite output")
    check(excess <= 0, f"{label}: kernel disagrees with its plain version "
                       f"(max abs err {err}, {excess} past the tolerance)")
    calls = [0]

    def cycled(fn):
        def go():
            calls[0] += 1
            return fn(calls[0])
        return go
    ms = device_ms(cycled(run))
    plain_ms = device_ms(cycled(plain))
    library_ms = device_ms(cycled(library)) if library else None
    b_ms, b_by = bound(nbytes, ops)
    res = {"case": label, "max_abs_err": err,
           "tolerance": " / ".join(dict.fromkeys(t.text for t in tols)),
           "excess": excess, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
    print(f"kernel {label}: max_abs_err={err:.3g} (excess over tolerance "
          f"{excess:.3g}) ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({b_by})"
          + ("" if library is None else f" library_ms={library_ms:.5f}"))
    return res


# ------------------------------------------------------------ kernels
def paged_case(dtype, seed, copies):
    """Decode at Llama-3-8B's attention shape: 8 slots at mixed depths
    (one inactive, pinned to the null page), 32 q heads over 8 kv heads,
    head dim 128, pages of 16, 128 pages per slot.  `copies` distinct
    pools so timed launches find their pages cold in L2, as decode does
    (a whole step of weight reads separates a layer's two visits)."""
    S, nq, n_kv, hd, ps, mp = 8, 32, 8, 128, 16, 128
    P = S * mp + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    depths = [2047, 1536, 1100, 777, 400, 130, 17]
    positions = torch.tensor(depths + [0], dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    used = 0
    for s, d in enumerate(depths):
        n = d // ps + 1
        table[s, :n] = perm[used:used + n]
        used += n
    pools = [(torch.randn((P, ps, n_kv, hd), generator=g, device="cuda")
              .to(dtype),
              torch.randn((P, ps, n_kv, hd), generator=g, device="cuda")
              .to(dtype)) for _ in range(copies)]
    q = torch.randn((S, nq, hd), generator=g, device="cuda").to(dtype)
    live = sum(d + 1 for d in depths) + 1          # + the inactive row
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * S * nq * hd * esize + table.numel() * 4 + S * 4
              + 2 * live * n_kv * hd * esize)
    ops = 4 * live * nq * hd
    return q, pools, table, positions, nbytes, ops


def serving_kernel_phase(seed: int):
    """The serving kernels at the serving path's shapes."""
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache

    # paged attention: bf16 pools (the path's) held against the plain
    # version in fp32 on the same values, fp32 pools at 1e-4
    paged = []
    for dtype, tol in ((torch.bfloat16, ulps(0.5, 1e-5)),
                       (torch.float32, ulps(0, 1e-4))):
        q, pools, table, pos, nbytes, ops = paged_case(dtype, seed, 4)
        scale = 128 ** -0.5
        paged.append(case(
            f"paged_attention S=8 nq=32 n_kv=8 hd=128 ps=16 mp=128 "
            f"{str(dtype)[6:]}", tol,
            lambda i, q=q, pools=pools, table=table, pos=pos:
                pa.paged_attention(q, *pools[i % len(pools)], table, pos,
                                   softmax_scale=scale),
            lambda i, q=q, pools=pools, table=table, pos=pos:
                pa.paged_attention_plain(q, *pools[i % len(pools)], table,
                                         pos, scale),
            nbytes, ops,
            exact=lambda i, q=q, pools=pools, table=table, pos=pos:
                pa.paged_attention_plain(
                    q.float(), *(t.float() for t in pools[i % len(pools)]),
                    table, pos, scale)))
        del pools
    # rotary: the decode shape and the prefill chunk
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cos, sin = build_rope_cache(8192, 128, 500000.0, device="cuda")
    rotary = []
    for b, s in ((8, 1), (1, 256)):
        q = torch.randn((b, s, 32, 128), generator=g,
                        device="cuda").bfloat16()
        k = torch.randn((b, s, 8, 128), generator=g,
                        device="cuda").bfloat16()
        pos = torch.randint(0, 2048, (b, s), generator=g, device="cuda")
        cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
        nbytes = 2 * (q.numel() + k.numel()) * 2 + 2 * cos_t.numel() * 4
        ops = 6 * (q.numel() + k.numel()) // 2
        rotary.append(case(
            f"fused_rotary_qk q=[{b},{s},32,128] k=[{b},{s},8,128] bf16",
            ulps(1),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t:
                ro.fused_rotary_qk(q, k, c, s_),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t:
                ro.rotary_qk_plain(q, k, c, s_),
            nbytes, ops))
    # swiglu: the fused gate/up projection's strided halves
    swiglu = []
    for tokens in (8, 256):
        gu = torch.randn((tokens, 2, 14336), generator=g,
                         device="cuda").bfloat16()
        n = tokens * 14336
        swiglu.append(case(
            f"fused_swiglu [{tokens},14336] bf16", ulps(1),
            lambda i, gu=gu: sw.fused_swiglu(gu),
            lambda i, gu=gu: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
            3 * n * 2, 5 * n))
    return {"paged_attention": paged, "fused_rotary_qk": rotary,
            "fused_swiglu": swiglu}


def training_kernel_phase(seed: int):
    """Every kernel the training path launches, at its shapes: 2 x 2048
    tokens per micro-batch, Llama-3-8B widths, bf16 activations (SwiGLU
    and RoPE forward too, keyed beside their serving shapes); AdamW on
    the largest leaf (w_gate_up, 117M fp32 elements) and a bf16 leaf."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache, rope_tables

    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)

    tokens, hidden, inter, eps = 4096, 4096, 14336, 1e-5
    # fused residual RMSNorm: forward (y, s), backward (dx, dw)
    x, h, dy, dr = (randn(tokens, hidden) for _ in range(4))
    w = 1.0 + randn(hidden, dtype=torch.float32, std=0.1)
    act = tokens * hidden * 2
    # y and dx: one bf16 ulp, plus 1e-6 for the fp32 row sums taken in
    # another order (dx can cancel to far below its terms)
    norm_fwd = [case(
        f"residual_rmsnorm_fwd [{tokens},{hidden}] bf16, w fp32",
        ulps(1, 1e-6),
        lambda i: fn.residual_rmsnorm_fwd(x, h, w, eps),
        lambda i: fn.residual_rmsnorm_plain(x, h, w, eps),
        4 * act + hidden * 4, 6 * tokens * hidden)]
    _, s = fn.residual_rmsnorm_fwd(x, h, w, eps)
    norm_bwd = [case(
        f"residual_rmsnorm_bwd [{tokens},{hidden}] bf16, dw fp32",
        (ulps(1, 1e-6), rel(1e-5, of_max=True)),
        lambda i: fn.residual_rmsnorm_bwd(s, w, dy, dr, eps),
        lambda i: fn.residual_rmsnorm_bwd_plain(s, w, dy, dr, eps),
        4 * act + 2 * hidden * 4, 11 * tokens * hidden)]
    del x, h, dy, dr, s
    # SwiGLU forward from the strided gate/up halves, and its backward
    # into one [tokens, 2, inter] buffer
    gu, dy = randn(tokens, 2, inter), randn(tokens, inter)
    n = tokens * inter
    swiglu = [case(
        f"fused_swiglu [{tokens},{inter}] bf16", ulps(1),
        lambda i: sw.fused_swiglu(gu),
        lambda i: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
        3 * n * 2, 5 * n)]
    swiglu_bwd = [case(
        f"swiglu_bwd [{tokens},{inter}] bf16", ulps(1),
        lambda i: sw.swiglu_bwd(gu, dy),
        lambda i: torch.stack(sw.swiglu_bwd_plain(gu[:, 0], gu[:, 1], dy),
                              dim=-2),
        5 * n * 2, 12 * n)]
    del gu, dy
    # RoPE backward: the forward kernel rotating by -theta
    cos, sin = build_rope_cache(8192, 128, 500000.0, device="cuda")
    cos_t, sin_t = rope_tables(cos, sin, 2, 2048)
    dq, dk = randn(2, 2048, 32, 128), randn(2, 2048, 8, 128)
    pairs = (dq.numel() + dk.numel()) // 2
    rotary = [case(
        "fused_rotary_qk q=[2,2048,32,128] k=[2,2048,8,128] bf16", ulps(1),
        lambda i: ro.fused_rotary_qk(dq, dk, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(dq, dk, cos_t, sin_t),
        2 * (dq.numel() + dk.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * pairs)]
    rotary_bwd = [case(
        "rotary_qk_bwd q=[2,2048,32,128] k=[2,2048,8,128] bf16", ulps(1),
        lambda i: ro.rotary_qk_bwd(dq, dk, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(dq, dk, cos_t, -sin_t),
        2 * (dq.numel() + dk.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * pairs)]
    del dq, dk
    # AdamW, in place: p/m/v of the kernel, the plain version and the
    # library call each start from the same values and stay their own
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    step, lr = 10, 3e-4
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
    c2 = float(np.float32(1) - np.float32(0.95) ** np.float32(step))
    adam = []
    for label, numel, dtype in (
            ("w_gate_up [4096,2,14336] fp32", hidden * 2 * inter,
             torch.float32),
            ("wqkv [4096,8,6,128] bf16", hidden * 8 * 6 * 128,
             torch.bfloat16)):
        p0 = randn(numel, dtype=dtype, std=0.02)
        grad = randn(numel, dtype=torch.float32, std=1e-3)
        m0 = randn(numel, dtype=torch.float32, std=1e-4)
        v0 = randn(numel, dtype=torch.float32, std=1e-6).abs()
        mine = [t.clone() for t in (p0, m0, v0)]
        ref = [t.clone() for t in (p0, m0, v0)]
        library = None
        if dtype == torch.float32:
            lib = [t.clone() for t in (p0, m0, v0)]
            steps = [torch.full((), float(step), device="cuda")]

            def library(i, lib=lib, grad=grad, steps=steps):
                torch._fused_adamw_([lib[0]], [grad], [lib[1]], [lib[2]],
                                    [], steps, lr=lr, beta1=0.9,
                                    beta2=0.95, weight_decay=0.1, eps=1e-8,
                                    amsgrad=False, maximize=False)
        del p0, m0, v0
        esize = torch.finfo(dtype).bits // 8
        adam.append(case(
            f"adam_update {label}",
            (ulps(1) if dtype == torch.bfloat16 else rel(3e-7),
             rel(3e-7), rel(3e-7)),
            lambda i, t=mine, grad=grad: (
                ad.adam_update(t[0], grad, t[1], t[2], lr, c1, c2, **kw),
                tuple(t))[1],
            lambda i, t=ref, grad=grad: (
                ad.adam_plain(t[0], grad, t[1], t[2], lr, c1, c2, **kw),
                tuple(t))[1],
            numel * (2 * esize + 4 + 4 * 4), 15 * numel, library=library))
        del mine, ref, grad
    return {"residual_rmsnorm_fwd": norm_fwd,
            "residual_rmsnorm_bwd": norm_bwd, "fused_swiglu": swiglu,
            "swiglu_bwd": swiglu_bwd, "fused_rotary_qk": rotary,
            "rotary_qk_bwd": rotary_bwd, "adam_update": adam}


def kernel_table():
    """{kernel: (wrapper module, its launch counter, source, the TPU
    kernel it replaces)} for every ported kernel."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    src, tpu = "hetu_tpu_torch/csrc/", "hetu_tpu/ops/pallas/"
    return {
        "paged_attention": (pa, "launches", src + "paged_attention.cu",
                            tpu + "paged_attention.py:285"),
        "fused_rotary_qk": (ro, "launches", src + "rotary.cu",
                            tpu + "rotary.py:82"),
        "fused_swiglu": (sw, "launches", src + "swiglu.cu",
                         tpu + "swiglu.py:74"),
        "residual_rmsnorm_fwd": (fn, "launches", src + "fused_norm.cu",
                                 tpu + "fused_norm.py:138"),
        "residual_rmsnorm_bwd": (fn, "bwd_launches", src + "fused_norm.cu",
                                 tpu + "fused_norm.py:157"),
        "swiglu_bwd": (sw, "bwd_launches", src + "swiglu.cu",
                       tpu + "swiglu.py:103"),
        "rotary_qk_bwd": (ro, "bwd_launches", src + "rotary.cu",
                          tpu + "rotary.py:112"),
        "adam_update": (ad, "launches", src + "adam.cu", tpu + "adam.py:87"),
    }


def zero_counts(kernels):
    for mod, attr, *_ in kernels.values():
        setattr(mod, attr, 0)


def read_counts(kernels):
    return {name: getattr(mod, attr)
            for name, (mod, attr, *_) in kernels.items()}


# ---------------------------------------------------------- reference
def reference_phase(seed: int):
    """Llama-3-8B widths at 2 layers, fp32: engine on the card vs the
    same engine on the CPU."""
    from hetu_tpu_torch.models.generation import extend_cache
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2,
                                compute_dtype=torch.float32)
    t0 = time.perf_counter()
    card = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    serve = ServeConfig(num_slots=2, page_size=16, max_len=256,
                        prefill_chunk=64)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 64))
    logits = []
    tokens = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        shape = (2, 1, 256, cfg.num_key_value_heads, cfg.head_dim)
        scratch = (torch.zeros(shape, device=dev), torch.zeros(shape,
                                                               device=dev))
        lg, _ = extend_cache(model, torch.as_tensor(ids, device=dev),
                             scratch, 0)
        logits.append(lg.cpu())
        reqs = synthetic_requests(
            2, vocab_size=cfg.vocab_size, prompt_lens=(70, 120),
            max_new=(4, 4), arrivals=poisson_arrivals(2, 100.0, seed=seed),
            seed=seed)
        eng = ServingEngine(model, serve, device=dev).warmup()
        tokens.append([r.tokens for r in eng.run(reqs)])
    err = (logits[0] - logits[1]).abs().max().item()
    check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
    check(tuple(logits[0].shape) == (1, 64, cfg.vocab_size),
          f"logits shape {tuple(logits[0].shape)}")
    check(err <= 1e-3, f"card vs CPU prefill logits differ by {err}")
    check(tokens[0] == tokens[1], f"card vs CPU tokens differ: {tokens}")
    print(f"reference: Llama-3-8B widths, 2 layers, fp32: card vs CPU "
          f"prefill logits max_abs_err={err:.3g} (tol 1e-3); greedy tokens "
          f"identical {tokens[0]} ({time.perf_counter() - t0:.1f}s)")


# ------------------------------------------------------------ serving
def serving_phase(seed: int, kernels):
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(), "parameter count")
    print(f"serving: Llama-3-8B {cfg.num_hidden_layers} layers, "
          f"{n_params / 1e9:.3f}B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256)
    eng = ServingEngine(model, serve, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    print(f"serving: warmup {time.perf_counter() - t0:.2f}s")
    reqs = synthetic_requests(
        8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
        max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
        seed=seed)
    check(sum(r.prompt_len > serve.prefill_chunk for r in reqs) >= 2,
          "the trace has too few multi-chunk prompts")
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    check(len(results) == len(reqs), f"{len(results)} of {len(reqs)} done")
    for r in results:
        check(r.finished_reason == "length" and len(r.tokens) == 32,
              f"request {r.rid}: {r.finished_reason}, {len(r.tokens)} "
              "tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    eng.scheduler.check_invariants()
    check(eng.pool.free_count == eng.pool.num_pages, "pages leaked")
    reg = eng.registry
    steps = int(reg.counter_value("serve.decode_steps"))
    chunks = int(reg.counter_value("serve.prefill_chunks"))
    L = cfg.num_hidden_layers
    check(launches["paged_attention"] == steps * L,
          "paged_attention launches != decode steps x layers")
    check(launches["fused_rotary_qk"] == (steps + chunks) * L
          and launches["fused_swiglu"] == (steps + chunks) * L,
          "rotary/swiglu launches != (decode steps + chunks) x layers")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("paged_attention", "fused_rotary_qk",
                              "fused_swiglu")),
          f"a training kernel launched while serving: {launches}")
    ttft = sorted(r.stats.ttft_s for r in results)
    e2e = sorted(r.stats.e2e_s for r in results)
    decode = reg.histogram("serve.token_latency_s")
    tokens_out = sum(len(r.tokens) for r in results)
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    out = {
        "requests": len(results), "prompt_tokens":
            sum(r.prompt_len for r in reqs),
        "tokens_out": tokens_out,
        "decode_steps": steps, "prefill_chunks": chunks,
        "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "e2e_s_p50": e2e[len(e2e) // 2], "e2e_s_max": e2e[-1],
        "decode_step_s_p50": decode.percentile(50),
        "decode_step_s_max": decode.vmax,
        # end to end: every token out over the whole run's wall time
        "tokens_per_s": tokens_out / wall,
        # the decode layer alone: decode tokens over decode calls' wall
        "decode_only_tokens_per_s": decode_tokens / decode.total,
        "run_wall_s": wall, "peak_memory_gib": peak_gb,
        "launches": launches,
    }
    print("serving " + json.dumps(out))
    serving_time_phase(eng, reqs)
    return launches


def _profile(fn, steps: int, top: int = 5):
    """Summed device time (ms) per call of the kernels torch.profiler
    sees while `fn` runs `steps` times, the host wall per call around a
    synchronize, and the `top` heaviest kernels by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), wall_ms, by_name, \
        [(n[:60], t) for n, t in heavy[:top]]


def serving_time_phase(eng, reqs):
    """One decode step and one prefill chunk at the serving shapes:
    host enqueue, wall, device busy time and the card's idle share."""
    from hetu_tpu_torch.models.generation import (decode_step_paged,
                                                  extend_cache)
    model, S = eng.model, eng.config.num_slots
    mp = eng.scheduler.max_pages
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s, d in enumerate(depths):
        n = d // eng.config.page_size + 1
        table[s, :n] = torch.arange(1 + s * mp, 1 + s * mp + n)
    pos = torch.tensor(depths, dtype=torch.int32, device="cuda")
    tok = torch.zeros(S, dtype=torch.int32, device="cuda")
    scratch = eng._new_scratch()
    ids = torch.zeros((1, eng.config.prefill_chunk), dtype=torch.long,
                      device="cuda")
    calls = {
        "decode_step": lambda: decode_step_paged(model, tok, eng.pool.k,
                                                 eng.pool.v, table, pos),
        "prefill_chunk": lambda: extend_cache(model, ids, scratch, 256),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
        busy, _, _, top = _profile(fn, 3)
        out[name] = {"host_enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
                     "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / (wall * 1e3),
                     "top_kernels_ms": top}
    print("serving time " + json.dumps(out))


# ----------------------------------------------------------- training
def _train_batch(vocab: int, batch: int, seq: int, seed: int):
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq))
    ids = ids.astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def training_reference_phase(seed: int):
    """A narrow Llama, 3 Trainer steps on the card and on the CPU."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel

    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1536,
                           vocab_size=4096, num_hidden_layers=2,
                           compute_dtype=torch.float32,
                           use_flash_attention=False)
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100)
    batch = _train_batch(cfg.vocab_size, 4, 64, seed)
    batch["labels"][1, :5] = -100
    t0 = time.perf_counter()
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
    card = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    runs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        tr = Trainer(model, tc, device=dev)
        metrics = [tr.train_step(batch) for _ in range(3)]
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     [p.detach().cpu() for p in model.parameters()]))
    (on_card, card_p), (on_cpu, cpu_p) = runs
    worst = {k: max(abs(g[k] - c[k]) / abs(c[k])
                    for g, c in zip(on_card, on_cpu))
             for k in ("loss", "grad_norm", "lr")}
    bound_p = 2 * sum(m["lr"] for m in on_cpu)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(card_p, cpu_p)])
    p_err, p_frac = d.max().item(), (d > 1e-5).float().mean().item()
    check(all(math.isfinite(m["loss"]) for m in on_card), "non-finite loss")
    check(all(v <= 1e-5 for v in worst.values()),
          f"card vs CPU training metrics differ: {worst}")
    check(p_err <= bound_p and p_frac <= 1e-3,
          f"card vs CPU parameters differ: max {p_err} (bound {bound_p}), "
          f"{p_frac} of elements past 1e-5")
    print(f"training reference: hidden 512, 2 layers, fp32, 3 steps: card "
          f"vs CPU loss/grad_norm/lr worst relative diff {worst} (tol "
          f"1e-5); parameters max abs diff {p_err:.3g} (bound "
          f"{bound_p:.3g}), {p_frac:.3g} of elements past 1e-5 (tol "
          f"1e-3); losses {[m['loss'] for m in on_card]} "
          f"({time.perf_counter() - t0:.1f}s)")


def training_phase(seed: int, kernels, card: str, steps: int = 6):
    """Llama-3-8B widths, 8 layers, through the Trainer on the card."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=8,
                                use_flash_attention=False)
    L, seq, gbs = cfg.num_hidden_layers, 2048, 4
    batch = _train_batch(cfg.vocab_size, gbs, seq, seed)
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    expect_first = math.log(cfg.vocab_size) + sigma ** 2 / 2
    for mbs in (2, 1):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
        tr = Trainer(model, TrainingConfig(
            global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
            lr=1e-3, warmup_steps=2, total_steps=1000, log_every=1),
            device="cuda").build()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tr.params)
        print(f"training: Llama-3-8B widths, {L} layers, {n_params / 1e9:.3f}B"
              f" params fp32 + fp32 grads and AdamW moments, bf16 compute, "
              f"remat, micro-batch {mbs} x {seq}; built in "
              f"{time.perf_counter() - t0:.1f}s")
        n_micro = gbs // mbs
        fwd, bwd = 2 * L * n_micro, L * n_micro
        per_step = {name: 0 for name in kernels}
        per_step.update(fused_rotary_qk=fwd, fused_swiglu=fwd,
                        residual_rmsnorm_fwd=fwd, residual_rmsnorm_bwd=bwd,
                        swiglu_bwd=bwd, rotary_qk_bwd=bwd,
                        adam_update=len(tr.params))
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        losses, step_s, launches = [], [], {name: 0 for name in kernels}
        cut = False
        for i in range(steps):
            t0 = time.perf_counter()
            # log_every=1: train() reads the loss, a wait for the card
            metrics = tr.train([batch], num_steps=1)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            counts = read_counts(kernels)
            check(counts == per_step, f"step {i + 1} launches {counts}, "
                                      f"expected {per_step}")
            for name, n in counts.items():
                launches[name] += n
            zero_counts(kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if i == 0 and peak > TRAIN_PEAK_GIB and mbs > 1:
                print(f"training: CUT micro-batch {mbs} -> {mbs // 2}: peak "
                      f"{peak:.1f} GiB > {TRAIN_PEAK_GIB} GiB")
                cut = True
                break
        if not cut:
            break
        del tr, model
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - expect_first) <= 0.5,
          f"first loss {losses[0]} is not within 0.5 of {expect_first}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens = gbs * seq
    p50 = float(np.median(step_s))
    flops = cfg.flops_per_token(seq) * tokens
    reg = tr.registry
    out = {
        "layers": L, "micro_batch": mbs, "micro_batches": n_micro,
        "seq_len": seq, "tokens_per_step": tokens, "losses": losses,
        "expected_first_loss": expect_first,
        "step_s": step_s, "step_s_p50": p50, "tokens_per_s": tokens / p50,
        "mfu": flops / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        "model_tflop_per_step": flops / 1e12,
        "peak_memory_gib": peak,
        "trainer.steps": reg.counter_value("trainer.steps"),
        "trainer.step_time_s_p50": reg.histogram(
            "trainer.step_time_s").percentile(50),
        "launches_per_step": per_step, "launches": launches, "card": card,
    }
    print("training " + json.dumps(out))
    training_time_phase(tr, batch, p50 * 1e3, card)
    return launches


def training_time_phase(tr, batch, step_ms: float, card: str):
    """Where a training step's time goes: one step under torch.profiler
    (device busy, heaviest kernels, each ported kernel's summed time;
    the idle share against `step_ms`, the unprofiled step's synchronised
    p50); then the dense attention and the LM head + loss timed apart at
    the step's shapes and scaled to the step's call counts."""
    from hetu_tpu_torch.ops.attention import attention
    from hetu_tpu_torch.ops.losses import softmax_cross_entropy_sparse

    busy, wall, by_name, top = _profile(lambda: tr.train_step(batch), 1,
                                        top=10)
    ours = {key: sum(t for n, t in by_name.items() if key in n)
            for key in ("rmsnorm_fwd", "rmsnorm_bwd", "swiglu_fwd",
                        "swiglu_bwd", "rotary_qk", "adam_kernel")}
    cfg, c = tr.model.config, tr.config
    n_micro, L = tr.n_micro, cfg.num_hidden_layers
    mbs, seq = c.micro_batch_size, c.seq_len
    # apart: free the trainer's step memory first
    tr.model.zero_grad(set_to_none=True)
    g = torch.Generator(device="cuda").manual_seed(7)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(
            dtype).requires_grad_(True)
    q = leaf(mbs, seq, cfg.num_attention_heads, cfg.head_dim)
    k, v = (leaf(mbs, seq, cfg.num_key_value_heads, cfg.head_dim)
            for _ in range(2))
    do = torch.randn_like(q)

    def attn_fwd():
        with torch.no_grad():
            attention(q, k, v, causal=True)

    def attn_fwd_bwd():
        attention(q, k, v, causal=True).backward(do)
    a_f, a_fb = event_ms(attn_fwd), event_ms(attn_fwd_bwd)
    del q, k, v, do
    hidden = leaf(mbs, seq, cfg.hidden_size)
    labels = torch.randint(0, cfg.vocab_size, (mbs, seq), device="cuda")
    head = tr.model.lm_head

    def head_loss():
        lg = hidden @ head.to(hidden.dtype)
        softmax_cross_entropy_sparse(lg[:, :-1], labels[:, 1:],
                                     reduction="sum").backward()
    h_fb = event_ms(head_loss)
    head.grad = None
    del hidden
    # recompute runs each block's forward twice per micro-batch
    attention_ms = L * n_micro * (a_f + a_fb)
    head_ms = n_micro * h_fb
    out = {"step_ms_p50": step_ms, "profiled_wall_ms": wall,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / step_ms,
           "top_kernels_ms": top, "ported_kernels_ms": ours,
           "dense_attention_fwd_ms": a_f, "dense_attention_fwd_bwd_ms": a_fb,
           "dense_attention_ms_per_step": attention_ms,
           "lm_head_loss_fwd_bwd_ms": h_fb, "lm_head_loss_ms_per_step": head_ms,
           "adamw_ms_per_step": ours["adam_kernel"],
           "other_device_ms": busy - attention_ms - head_ms
           - sum(ours.values()), "card": card}
    print("training time " + json.dumps(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}")
    # fp32 matrix products in full fp32 (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from hetu_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    reports = build.build()
    for name, rep in reports.items():
        print(f"--- nvcc -Xptxas -v: {name}")
        print(rep.strip())
    print(f"build: {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.2f}s")

    # each path runs beside its own kernel checks: serving first, so
    # the training kernels' large buffers and CUDA graphs come after it
    kernels = kernel_table()
    cases = serving_kernel_phase(args.seed)
    reference_phase(args.seed)
    by_path = {"serving": serving_phase(args.seed, kernels)}
    gc.collect()
    torch.cuda.empty_cache()
    for name, more in training_kernel_phase(args.seed).items():
        cases.setdefault(name, []).extend(more)
    training_reference_phase(args.seed)
    by_path["training"] = training_phase(args.seed, kernels, smi)

    line = []
    for name, (mod, attr, source, replaces) in kernels.items():
        head = cases[name][0]       # the first path's first shape
        counts = {path: n[name] for path, n in by_path.items()}
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts["serving"] or counts["training"],
            "launches_by_path": counts,
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "cases": cases[name]})
    print(json.dumps({"kernels": line}))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
