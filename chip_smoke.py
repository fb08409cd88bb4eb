#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hetu_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and nothing carries on:

 1. the card: `nvidia-smi` name and power limit, `torch` device name
    (no CUDA device -> exit 1 before anything else runs);
 2. build: every CUDA kernel of the serving path from
    hetu_tpu_torch/csrc, one nvcc per source, all at once; prints the
    ptxas report (registers, shared memory, spills) and the build time;
 3. kernels: each kernel at the shapes the serving path gives it for
    Llama-3-8B, held against its plain PyTorch version on the same
    inputs at the stated tolerance (bf16 paged attention: its output
    must be the plain version on the same values in fp32, rounded once
    to bf16 — within half a bf16 ulp, plus 1e-5 for fp32 summation
    order), and timed on the card (CUDA-graph
    replay, CUDA events) beside its plain version and its bound: the
    larger of the bytes it must move over 3.35 TB/s and its operations
    over 989 TFLOP/s (bf16) or 67 TFLOP/s (fp32);
 4. reference: Llama-3-8B widths cut to 2 layers, in fp32 — the serving
    engine on the card (the kernels) against the same engine on the CPU
    (the plain versions), same weights and trace: prefill logits within
    1e-3 and identical greedy tokens;
 5. slice: Llama-3-8B at full width and depth (bf16 weights drawn on the
    card from --seed) behind `ServingEngine(ServeConfig(num_slots=8,
    page_size=16, max_len=2048, prefill_chunk=256))`: warmup, then 8
    Poisson-arriving requests with 64-1024-token prompts and 32 new
    tokens each.  Every kernel's launch count is set to 0 just before
    the run and read just after; each must have launched;
 6. where the time goes: one decode step over 8 slots at the trace's
    depths and one 256-token prefill chunk, each timed on the host
    (enqueue, and wall to a synchronize) and under torch.profiler (the
    summed time of the kernels it saw on the card), giving the card's
    idle share of the step and its heaviest kernels.

Prints the `kernels` JSON line, the nvidia-smi line, and last the
`{"ok": true, "device": ...}` line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float32: 67e12}    # fp32 outside the tensor cores


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


def ulp_excess(a: torch.Tensor, b: torch.Tensor, ulps: float,
               atol: float) -> float:
    """How far |a - b| goes past `ulps` bf16 ulps of the larger of the
    two plus `atol`, at its worst (<= 0: within the tolerance)."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)       # 8 significant bits
    return ((a - b).abs() - ulps * ulp - atol).max().item()


def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def kernel_phase(seed: int):
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache

    def case(label, dtype, tol, run, plain, nbytes, ops, exact=None):
        """`tol` = (ulps, atol): |kernel - reference| <= ulps bf16 ulps
        of the larger + atol, elementwise.  The reference is the plain
        version on the same inputs, or `exact`, the plain version on
        the same values in fp32, where given."""
        out, ref = run(0), (exact or plain)(0)
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(outs, refs))
        excess = max(ulp_excess(a, b, *tol) for a, b in zip(outs, refs))
        check(all(bool(torch.isfinite(a).all()) for a in outs),
              f"{label}: non-finite output")
        check(excess <= 0, f"{label}: kernel disagrees with its plain "
                           f"version (max abs err {err}, {excess} past "
                           f"the tolerance)")
        calls = [0]

        def cycled(fn):
            def go():
                calls[0] += 1
                return fn(calls[0])
            return go
        ms = device_ms(cycled(run))
        plain_ms = device_ms(cycled(plain))
        b_ms, b_by = bound(nbytes, ops, dtype)
        res = {"case": label, "max_abs_err": err,
               "tolerance": f"{tol[0]} bf16 ulp + {tol[1]}",
               "excess": excess,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        print(f"kernel {label}: max_abs_err={err:.3g} (excess over "
              f"tolerance {excess:.3g}) ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by})")
        return res

    # paged attention: bf16 pools (the path's) held against the plain
    # version in fp32 on the same values, fp32 pools at 1e-4
    paged = []
    for dtype, tol in ((torch.bfloat16, (0.5, 1e-5)),
                       (torch.float32, (0, 1e-4))):
        q, pools, table, pos, nbytes, ops = paged_case(dtype, seed, 4)
        scale = 128 ** -0.5
        paged.append(case(
            f"paged_attention S=8 nq=32 n_kv=8 hd=128 ps=16 mp=128 "
            f"{str(dtype)[6:]}", dtype, tol,
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
            torch.bfloat16, (1, 0.0),
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
            f"fused_swiglu [{tokens},14336] bf16", torch.bfloat16,
            (1, 0.0),
            lambda i, gu=gu: sw.fused_swiglu(gu[:, 0], gu[:, 1]),
            lambda i, gu=gu: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
            3 * n * 2, 5 * n))
    return {
        "paged_attention": (pa, "hetu_tpu_torch/csrc/paged_attention.cu",
                            "hetu_tpu/ops/pallas/paged_attention.py:285",
                            paged),
        "fused_rotary_qk": (ro, "hetu_tpu_torch/csrc/rotary.cu",
                            "hetu_tpu/ops/pallas/rotary.py:82", rotary),
        "fused_swiglu": (sw, "hetu_tpu_torch/csrc/swiglu.cu",
                         "hetu_tpu/ops/pallas/swiglu.py:74", swiglu),
    }


# ---------------------------------------------------------- reference
def reference_phase(seed: int):
    """Llama-3-8B widths at 2 layers, fp32: engine on the card vs the
    same engine on the CPU."""
    from hetu_tpu_torch.models.generation import extend_cache
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    torch.backends.cuda.matmul.allow_tf32 = False
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


# -------------------------------------------------------------- slice
def slice_phase(seed: int, kernels):
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(), "parameter count")
    print(f"slice: Llama-3-8B {cfg.num_hidden_layers} layers, "
          f"{n_params / 1e9:.3f}B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256)
    eng = ServingEngine(model, serve, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    print(f"slice: warmup {time.perf_counter() - t0:.2f}s")
    reqs = synthetic_requests(
        8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
        max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
        seed=seed)
    check(sum(r.prompt_len > serve.prefill_chunk for r in reqs) >= 2,
          "the trace has too few multi-chunk prompts")
    torch.cuda.reset_peak_memory_stats()
    for mod, *_ in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, (mod, *_) in kernels.items()}
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
    for name, n in launches.items():
        check(n > 0, f"{name} never launched on the main path")
    reg = eng.registry
    steps = int(reg.counter_value("serve.decode_steps"))
    chunks = int(reg.counter_value("serve.prefill_chunks"))
    L = cfg.num_hidden_layers
    check(launches["paged_attention"] == steps * L,
          "paged_attention launches != decode steps x layers")
    check(launches["fused_rotary_qk"] == (steps + chunks) * L
          and launches["fused_swiglu"] == (steps + chunks) * L,
          "rotary/swiglu launches != (decode steps + chunks) x layers")
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
    print("slice " + json.dumps(out))
    return launches, eng, reqs


def _kernel_time(fn, steps: int):
    """Summed device time (ms) per call of the kernels torch.profiler
    sees while `fn` runs `steps` times, and the five heaviest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), [(n[:60], t) for n, t in top]


def time_phase(eng, reqs):
    """One decode step and one prefill chunk at the slice's shapes:
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
        busy, top = _kernel_time(fn, 3)
        out[name] = {"host_enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
                     "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / (wall * 1e3),
                     "top_kernels_ms": top}
    print("time " + json.dumps(out))


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

    from hetu_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    reports = build.build()
    for name, rep in reports.items():
        print(f"--- nvcc -Xptxas -v: {name}")
        print(rep.strip())
    print(f"build: {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.2f}s")

    kernels = kernel_phase(args.seed)
    reference_phase(args.seed)
    launches, eng, reqs = slice_phase(args.seed, kernels)
    time_phase(eng, reqs)

    line = []
    for name, (mod, source, replaces, cases) in kernels.items():
        head = cases[0]       # the decode-path shape (bf16)
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "cases": cases})
    print(json.dumps({"kernels": line}))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
