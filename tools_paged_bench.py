#!/usr/bin/env python3
"""Time the port's paged attention kernels, and the decode step that
runs them, for one tree of the repository on one CUDA card.

    python3 tools_paged_bench.py [--root DIR]

Imports `chip_smoke` and `hetu_tpu_torch` from DIR (default: this
file's directory; a `git archive` of another commit unpacked there
compares two versions in one call, run in the order A, B, B, A), builds
the kernels there and measures:

- chip_smoke.py's paged cases: decode on exact pages at the Llama-3-8B
  serving shape (`paged_case`, bf16 and fp32), decode on int8 / int4
  pages and verify (C = 5) on exact / int8 / int4 pages at the verify
  grid's depths (`paged_cases`), GPT-2-large's exact and int8 decode and
  int8 verify — each held against its plain version at chip_smoke.py's
  tolerance and timed as chip_smoke.py times it (CUDA-graph replay, 4
  cold pool copies);
- the wrapper's host cost: the enqueue of 200 calls (Llama exact decode,
  int8 verify);
- chip_smoke.py phase 6's greedy decode step: Llama-3-8B, 32 layers,
  bf16 weights drawn from seed 0, the same engine and trace: the
  engine's run of the trace (TTFT and decode gap p50), then the host
  enqueue and the wall of a step at the trace's depths (10 rounds of 20
  steps, each round's mean and the rounds' median), and where 10 steps'
  host time goes under cProfile.

Prints the card line and one JSON line {"root", "ms": {case: ms},
"host_us_per_call": {...}, "decode_step": {...}}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

SEED = 0


def paged_kernels(cs, pa):
    import torch
    ms = {}
    for dtype, tol in ((torch.bfloat16, cs.ulps(0.5, 1e-5)),
                       (torch.float32, cs.ulps(0, 1e-4))):
        q, pools, table, pos, nbytes, ops = cs.paged_case(dtype, SEED, 4)
        scale = 128 ** -0.5
        label = f"paged_attention llama decode exact {str(dtype)[6:]}"
        res = cs.case(
            label, tol,
            lambda i, q=q, pools=pools: pa.paged_attention(
                q, *pools[i % 4], table, pos, softmax_scale=scale),
            lambda i, q=q, pools=pools: pa.paged_attention_plain(
                q, *pools[i % 4], table, pos, scale),
            nbytes, ops,
            exact=lambda i, q=q, pools=pools: pa.paged_attention_plain(
                q.float(), *(t.float() for t in pools[i % 4]), table, pos,
                scale))
        ms[label] = res["ms"]
        del pools
    modes = (("int8", 1), ("int4", 1), ("none", 5), ("int8", 5), ("int4", 5))
    for _, res in cs.paged_cases(SEED, modes):
        ms[res["case"]] = res["ms"]
    for _, res in cs.paged_cases(
            SEED + 7, (("none", 1), ("int8", 1), ("int8", 5)),
            cs.GPT_DEPTHS, nq=20, n_kv=20, hd=64, mp=64):
        ms[res["case"]] = res["ms"]
    return ms


def wrapper_host_us(cs, pa):
    """The enqueue of 200 wrapper calls, no synchronize, in µs a call."""
    import torch
    host_us = {}
    for quant, C in (("none", 1), ("int8", 5)):
        q, pools, table, pos, _, _ = cs.serving_pages(SEED, quant, C, 1)
        k, v, ks, vs = pools[0]
        kw = {} if quant == "none" else dict(k_scale=ks, v_scale=vs,
                                             quant=quant)
        fn = (lambda: pa.paged_verify(q, k, v, table, pos, **kw)) if C > 1 \
            else (lambda: pa.paged_attention(q[:, 0], k, v, table, pos, **kw))
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host_us[f"{quant} C={C}"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    return host_us


def decode_step():
    """chip_smoke.py phase 6's engine and trace: the engine's run of the
    trace, then a greedy decode step's host enqueue and wall (ms)."""
    import numpy as np
    import torch
    from hetu_tpu_torch.models.generation import decode_step_paged
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)
    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    model = LlamaLMHeadModel(cfg, device="cuda", seed=SEED)
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256)
    eng = ServingEngine(model, serve, device="cuda")
    eng.warmup()
    reqs = synthetic_requests(
        8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
        max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=SEED),
        seed=SEED)
    results = eng.run(reqs)
    ttft = sorted(r.stats.ttft_s for r in results)
    gap = eng.registry.histogram("serve.token_latency_s")
    # serving_time_phase's step: the trace's depths, positions on the host
    S, mp = serve.num_slots, eng.scheduler.max_pages
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s, d in enumerate(depths):
        n = d // serve.page_size + 1
        table[s, :n] = torch.arange(1 + s * mp, 1 + s * mp + n)
    pos = np.asarray(depths, np.int32)
    tok = torch.zeros(S, dtype=torch.int32, device="cuda")

    def step():
        return decode_step_paged(model, tok, eng.pool.k, eng.pool.v, table,
                                 pos)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    enqueue, wall = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        enqueue.append((time.perf_counter() - t0) / 20 * 1e3)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) / 20 * 1e3)
    return {"host_enqueue_ms": enqueue, "wall_ms": wall,
            "host_profile": host_profile(step),
            "host_enqueue_ms_p50": float(np.median(enqueue)),
            "wall_ms_p50": float(np.median(wall)),
            "run_ttft_s_p50": ttft[len(ttft) // 2],
            "run_decode_step_s_p50": gap.percentile(50)}


def host_profile(step, steps: int = 10):
    """Where a step's host time goes, under cProfile (which slows every
    Python call alike): ms a step in all, and of each function of the
    paged wrapper's module and the 8 heaviest by own time."""
    import cProfile
    import pstats
    import torch
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    for _ in range(steps):
        step()
    prof.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(prof).stats
    own = {f"{Path(f).name}:{n}": tt * 1e3 / steps
           for (f, _, n), (_, _, tt, _, _) in stats.items()}
    paged = {n: {"calls": nc / steps, "own_ms": tt * 1e3 / steps,
                 "cum_ms": ct * 1e3 / steps}
             for (f, _, n), (_, nc, tt, ct, _) in stats.items()
             if f.endswith("cuda/paged_attention.py")}
    return {"ms_per_step": sum(own.values()), "paged_wrapper": paged,
            "heaviest_own_ms": sorted(own.items(), key=lambda kv: -kv[1])[:8]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("tools_paged_bench: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hetu_tpu_torch.ops.cuda import build
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    print(f"card: {cs.card_line()}")
    out = {"root": args.root, "ms": paged_kernels(cs, pa),
           "host_us_per_call": wrapper_host_us(cs, pa),
           "decode_step": decode_step()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
