#!/usr/bin/env python3
"""A/B of the port's AdamW kernel against variants of itself, on one card.

    python3 tools_adam_variants.py

Each variant is a copy of hetu_tpu_torch/csrc/adam.cu with one change,
built with the port's nvcc flags into build/adam_variants/ (git-ignored):
fewer or more vectors in flight a thread, other block sizes, streaming
(`ld.global.cs` / `st.global.cs`) or L2-prefetch load hints, and `same
traffic` — the kernel's loads and stores with no arithmetic, the
ceiling of its memory access pattern.  Each is timed (CUDA graphs
between CUDA events, `chip_smoke.device_ms`) at chip_smoke.py's three
AdamW cases — fp32 117M, bf16 25M and GPT-2-large's 436 leaves in one
launch — in turns (A B ... B A ... A B ...), and printed beside the
byte bound.  Needs a CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def variants(src: str) -> dict:
    """{name: source}: the kernel and its one-change copies."""
    def sub(text, old, new):
        assert old in text, old
        return text.replace(old, new)

    def unroll(t, u):
        return sub(t, "constexpr int ADAM_UNROLL = 4;",
                   f"constexpr int ADAM_UNROLL = {u};")

    def threads(t, n):
        return sub(t, "constexpr int ADAM_THREADS = 256;",
                   f"constexpr int ADAM_THREADS = {n};")

    def streaming(t):
        t = sub(t, "const float4 v = *reinterpret_cast<const float4*>(p);",
                "const float4 v = __ldcs(reinterpret_cast<const float4*>(p));")
        t = sub(t, "const uint2 v = *reinterpret_cast<const uint2*>(p);",
                "const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));")
        t = sub(t, "*reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], "
                   "x[2], x[3]);",
                "__stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], "
                "x[2], x[3]));")
        return sub(t, "*reinterpret_cast<uint2*>(p) = v;",
                   "__stcs(reinterpret_cast<uint2*>(p), v);")

    def l2_prefetch(t):
        t = sub(t, "const float4 v = *reinterpret_cast<const float4*>(p);",
                'float4 v; asm volatile("ld.global.L2::256B.v4.f32 '
                '{%0, %1, %2, %3}, [%4];" : "=f"(v.x), "=f"(v.y), "=f"(v.z), '
                '"=f"(v.w) : "l"(p));')
        return sub(t, "const uint2 v = *reinterpret_cast<const uint2*>(p);",
                   'uint2 v; asm volatile("ld.global.L2::256B.v2.u32 '
                   '{%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "l"(p));')

    def same_traffic(t):
        a = t.index("__device__ __forceinline__ float adam_step(")
        b = t.index("__device__ __forceinline__ void load4(const float* p")
        return t[:a] + (
            "__device__ __forceinline__ float adam_step(float pf, float gv, "
            "float& m, float& v, const Hyper& h) {\n"
            "  m = m + gv; v = v + gv; return pf + gv;\n}\n\n") + t[b:]
    return {"kernel": src, "unroll 2": unroll(src, 2),
            "unroll 8": unroll(src, 8), "128 threads": threads(src, 128),
            "512 threads": threads(src, 512), "streaming": streaming(src),
            "L2 prefetch": l2_prefetch(src), "same traffic": same_traffic(src)}


def main() -> int:
    if not torch.cuda.is_available():
        print("tools_adam_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.ops.cuda import build

    print(cs.card_line(), flush=True)
    out_dir = ROOT / "build" / "adam_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((build.CSRC / "adam.cu").read_text())
    procs, libs = {}, {}
    for i, (name, text) in enumerate(srcs.items()):
        cu, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        cs.check(proc.returncode == 0, f"{name}: nvcc failed\n{log}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines()
                if "Used" in line or "spill" in line]
        print(f"{name}: {regs}", flush=True)
        libs[name] = lib = ctypes.CDLL(str(so))
        for sym in ad._SIGNATURES:
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = ad._ARGTYPES, ctypes.c_int

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(n, dtype, std):
        return (std * torch.randn(n, generator=g, device="cuda")).to(dtype)
    scalars = ad._scalars(3e-4, 0.65, 0.4, 0.9, 0.95, 1e-8, 0.1)
    cases = {"fp32 117M": ([4096 * 2 * 14336], torch.float32),
             "bf16 25M": ([4096 * 8 * 6 * 128], torch.bfloat16),
             "GPT-2-large's 436 leaves": (cs.gpt_leaf_numels(),
                                          torch.float32)}
    names = list(srcs)
    for label, (numels, dtype) in cases.items():
        p = [randn(n, dtype, 0.02) for n in numels]
        gr = [randn(n, torch.float32, 1e-3) for n in numels]
        m = [randn(n, torch.float32, 1e-4) for n in numels]
        v = [randn(n, torch.float32, 1e-6).abs_() for n in numels]
        tables = ad.make_tables(p, gr, m, v, scalars)
        esize = torch.finfo(dtype).bits // 8
        bound_ms = cs.bound(sum(numels) * (2 * esize + 4 + 16), 0)[0]
        times = {name: [] for name in names}
        for order in (names, names[::-1], names):
            for name in order:
                fn = getattr(libs[name], ad._SYMBOLS[dtype])

                def call(fn=fn):
                    stream = torch.cuda.current_stream().cuda_stream
                    for t in tables:
                        build.check_launch(fn(ctypes.byref(t), stream),
                                           "adam variant")
                times[name].append(cs.device_ms(call, inner=10, reps=3))
        print(f"{label}: bound {bound_ms:.5f} ms", flush=True)
        for name in names:
            ms = statistics.median(times[name])
            print(f"  {name}: {ms:.5f} ms, {ms / bound_ms:.3f} x bound "
                  f"(runs {', '.join(f'{t:.5f}' for t in times[name])})",
                  flush=True)
        del p, gr, m, v, tables
    return 0


if __name__ == "__main__":
    sys.exit(main())
