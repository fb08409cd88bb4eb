"""Rotary position embeddings, the port of `hetu_tpu/ops/rotary.py`.

The serving forwards (`models/generation.py`) gather the per-position
cos/sin rows once per call with `rope_tables` (one small gather, kept
in Python as the reference's dispatcher does) and rotate q and k in
every layer with one call to `ops.cuda.rotary.fused_rotary_qk` — the
CUDA kernel for CUDA tensors, its plain version for CPU tensors.
`apply_rotary` is the reference's plain two-call composition, kept for
the parity tests.
"""
from typing import Optional

import torch


def build_rope_cache(max_len: int, head_dim: int, base: float = 10000.0,
                     dtype=torch.float32, device=None):
    """Precompute cos/sin tables [max_len, head_dim//2] (fp32 inv_freq,
    the reference's formula)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (base ** exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


def _gather_tables(cos, sin, seq: int,
                   position_ids: Optional[torch.Tensor]):
    if position_ids is None:
        return cos[:seq], sin[:seq]
    return cos[position_ids], sin[position_ids]


def apply_rotary(x, cos, sin, position_ids: Optional[torch.Tensor] = None):
    """Apply RoPE. x: [..., seq, heads, head_dim]; cos/sin: [max_len,
    hd//2]; position_ids: [..., seq] (defaults to arange)."""
    cos_t, sin_t = _gather_tables(cos, sin, x.shape[-3], position_ids)
    cos_t, sin_t = cos_t[..., None, :].float(), sin_t[..., None, :].float()
    x1, x2 = x.float().chunk(2, dim=-1)
    out1 = x1 * cos_t - x2 * sin_t
    out2 = x2 * cos_t + x1 * sin_t
    return torch.cat([out1, out2], dim=-1).to(x.dtype)


def rope_tables(cos, sin, b: int, s: int,
                position_ids: Optional[torch.Tensor] = None):
    """The per-position rows the fused kernel takes: cos_t/sin_t
    [b, s, hd/2], fp32, contiguous.  A forward that rotates every layer
    at the same positions gathers them once."""
    cos_t, sin_t = _gather_tables(cos, sin, s, position_ids)
    d2 = cos.shape[-1]
    return (cos_t.float().expand(b, s, d2).contiguous(),
            sin_t.float().expand(b, s, d2).contiguous())

