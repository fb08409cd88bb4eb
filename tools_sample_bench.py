#!/usr/bin/env python3
"""Time the port's two sampler kernels (`csrc/sample.cu`) for one tree of
the repository on one CUDA card, and digest the tokens of seeded rows.

    python3 tools_sample_bench.py [--root DIR]

Imports `chip_smoke` and `hetu_tpu_torch` from DIR (default: this
file's directory; a `git archive` of another commit unpacked there
compares two versions in one call, run in the order A, B, B, A), builds
`sample.cu` there and, at the shapes of `PERF.md`'s table, holds each
case against its plain version and times it as chip_smoke.py does
(`chip_smoke.sampler_cases`, `chip_smoke.case`: CUDA-graph replay):

- the product (kernel (a), `lm_head_logits`) and the fused sampler
  (product + draw) at hidden [40, 4096] x Llama-3-8B's head [4096,
  128256] and at hidden [40, 1280] x GPT-2-large's tied head wte.t()
  [1280, 50257] (with a tree whose chip_smoke.py times one, the
  product's one-call PyTorch yardstick beside it);
- the draw alone (`sample_logits`) over bf16 logits [8, 128256], [40,
  128256] and [40, 50257].

Then the digest: 4,096 rows, 2,048 over each vocabulary (128,256 and
50,257), logits and per-row arguments drawn from a fixed seed (greedy,
temperature alone, top-k, top-p, both; top-k from 1 past V, top-p from
1e-6 to 0.999999; every other batch rounded to 1/8 so values repeat),
fp32 and bf16 batches of 256 rows through `sample_logits`, half of
them launched whole and half in launches of 8 rows (the draw kernel's
two builds, many waves and one): the sha256 of their tokens.  Two trees
with equal digests drew every token alike.

Prints the card line and one JSON line {"root", "ms", "plain_ms",
"library_ms", "bound_ms", "clusters", "digest"}.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

SEED = 0
DIGEST_ROWS = 2048   # a vocabulary
BATCH = 256


def product_cases(cs, g):
    """The product and the fused sampler over both heads."""
    import torch
    res = {}
    for name, shape, tied in (("llama", (4096, 128256), False),
                              ("gpt", (1280, 50257), True)):
        H, V = shape
        if tied:
            table = (0.02 * torch.randn((V, H), generator=g,
                                        device="cuda")).bfloat16()
            head, text = table.t(), f"wte.t() [{H},{V}]"
        else:
            head = (0.02 * torch.randn((H, V), generator=g,
                                       device="cuda")).bfloat16()
            text = f"[{H},{V}]"
        fused, product = cs.sampler_cases(g, SEED, head, text)
        res[f"product {name}"] = product
        res[f"fused {name}"] = fused
        del head
    return res


def draw_cases(cs, sa, g):
    import torch
    res, clusters = {}, {}
    for rows, V in ((8, 128256), (40, 128256), (40, 50257)):
        temps, top_ks, top_ps, words = cs._sampler_rows(SEED, 40, V)
        args = tuple(t[:rows] for t in (words, temps, top_ks, top_ps))
        lg = (4.0 * torch.randn((rows, V), generator=g,
                                device="cuda")).bfloat16()
        res[f"draw [{rows},{V}]"] = cs.case(
            f"sample_logits [{rows},{V}] bf16", cs.same(),
            lambda i, lg=lg, args=args: sa.sample_logits(lg, *args),
            lambda i, lg=lg, args=args: sa.sample_plain(lg, *args),
            rows * V * 2 + rows * 4 * 5, rows * V * 4)
        if hasattr(sa, "active_clusters"):
            clusters[f"[{rows},{V}]"] = sa.active_clusters(rows, V)
    return res, clusters


def digest(sa):
    """sha256 of the tokens of the seeded rows (module docstring)."""
    import numpy as np
    import torch
    from hetu_tpu_torch.serving.sampling import key_words
    rng = np.random.default_rng(SEED)
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    h = hashlib.sha256()
    for V in (128256, 50257):
        for b in range(DIGEST_ROWS // BATCH):
            R = BATCH
            kind = rng.integers(0, 5, R)   # greedy, temp, top-k, top-p, both
            temps = np.where(kind == 0, 0.0, rng.uniform(0.5, 1.5, R))
            ks = np.array([1, 2, 5, 20, 50, 200, 1000, V - 1, V + 5])
            ps = np.array([1e-6, 0.1, 0.5, 0.8, 0.9, 0.95, 0.99, 0.999999])
            top_ks = np.where((kind == 2) | (kind == 4),
                              ks[rng.integers(0, len(ks), R)], 0)
            top_ps = np.where((kind == 3) | (kind == 4),
                              ps[rng.integers(0, len(ps), R)], 0.0)
            scale = torch.from_numpy(rng.uniform(0.5, 8.0, (R, 1))).float()
            logits = torch.randn((R, V), generator=g,
                                 device="cuda") * scale.cuda()
            if b % 2:
                logits = torch.round(logits * 8.0) / 8.0
            if b % 4 >= 2:
                logits = logits.bfloat16()
            words = key_words(torch.from_numpy(rng.integers(0, 2 ** 32, R)),
                              torch.from_numpy(rng.integers(0, 4096, R)))
            args = (words.cuda(), torch.from_numpy(temps).float().cuda(),
                    torch.from_numpy(top_ks).int().cuda(),
                    torch.from_numpy(top_ps).float().cuda())
            # whole batches, and batches in launches of 8 rows (one wave)
            step = R if b % 4 < 2 else 8
            tokens = torch.cat([sa.sample_logits(
                logits[i:i + step], *(a[i:i + step] for a in args))
                for i in range(0, R, step)])
            h.update(tokens.cpu().numpy().astype(np.int32).tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("tools_sample_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from hetu_tpu_torch.ops.cuda import build
    from hetu_tpu_torch.ops.cuda import sample as sa
    for name, rep in build.build(["sample"]).items():
        print(f"--- nvcc -Xptxas -v: {name}\n{rep.strip()}")
    print(f"card: {cs.card_line()}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    res = product_cases(cs, g)
    more, clusters = draw_cases(cs, sa, g)
    res.update(more)
    print(json.dumps({
        "root": args.root, "ms": {n: r["ms"] for n, r in res.items()},
        "plain_ms": {n: r["plain_ms"] for n, r in res.items()},
        "library_ms": {n: r["library_ms"] for n, r in res.items()
                       if r["library_ms"] is not None},
        "bound_ms": {n: r["bound_ms"] for n, r in res.items()},
        "clusters": clusters, "digest": digest(sa)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
