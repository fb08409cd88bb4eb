"""Blockwise int4 storage quantization, the port of
`hetu_tpu/ops/quantization.py` (the nibble packer and int4 pair).

Plain PyTorch, as the reference's are plain jnp: no TPU kernel backs
them.  The storage layout is the reference's: two values per byte, the
EVEN index in the LOW nibble, values offset by +8.  The int4 KV pages of
`serving/kv_pool.py` use this layout, and the paged-attention kernels
unpack it.  `quantize_heads` / `dequantize_heads` are the KV pages'
per-head-vector quantization (the reference's `serving/kv_pool.py`
pair): int8 through the blockwise kernels (quantize and dequantize),
int4 through `quantize_int4` / `dequantize_int4`.  The serving path
writes its pages through the fused page write (`ops/cuda/kv_write.py`),
which quantizes on the way with these bits; `quantize_heads` is that
write's plain version on the CPU and builds quantized pools for tests
and tools, and `dequantize_heads` reads pages back (`PagePool.gather`,
the prefix cache's prime).
"""
from __future__ import annotations

from typing import Tuple

import torch

from hetu_tpu_torch.ops.cuda.quant import (KERNEL_DTYPES,
                                          dequantize_blockwise,
                                          quantize_blockwise)


def pack_nibbles(u: torch.Tensor, *, even_high: bool = False
                 ) -> torch.Tensor:
    """Unsigned nibble values in [0, 15], even last dim -> uint8 [...,
    n/2]: two adjacent values a byte, the even index in the low nibble
    (the storage format), or with `even_high` in the high nibble (the
    reference's `comm/compress.pack_int4` format, which its resident
    experts use)."""
    if u.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, got "
                         f"{u.shape[-1]}")
    u = u.to(torch.uint8)
    even, odd = u[..., 0::2], u[..., 1::2]
    return ((even << 4) | odd) if even_high else (even | (odd << 4))


def unpack_nibbles(p: torch.Tensor, *, even_high: bool = False
                   ) -> torch.Tensor:
    """Inverse of `pack_nibbles`: uint8 [..., n] -> values [..., 2n] in
    [0, 15] (uint8)."""
    lo, hi = p & 0xF, (p >> 4) & 0xF
    even, odd = (hi, lo) if even_high else (lo, hi)
    return torch.stack([even, odd], dim=-1).reshape(
        *p.shape[:-1], 2 * p.shape[-1])


def quantize_int4(x: torch.Tensor, block_size: int = 64
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise absmax int4: (packed uint8 [n/bs, bs/2], scales fp32
    [n/bs]).  scale = max|x| / 7 floored at 1e-12; values
    round-half-to-even(x / scale) clipped to [-7, 7], stored +8."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n % block_size or block_size % 2:
        raise ValueError(f"{n} elements do not split into even blocks of "
                         f"{block_size}")
    blocks = flat.reshape(-1, block_size).float()
    # a true division on every device (see ops/cuda/quant.py)
    seven = blocks.new_full((), 7.0)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True) / seven,
                            1e-12)
    q = torch.clamp(torch.round(blocks / scale), -7, 7).to(torch.int8) + 8
    return pack_nibbles(q), scale[:, 0]


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    """(packed [nb, bs/2], scales [nb]) -> fp32 of `shape`."""
    blocks = unpack_nibbles(packed).to(torch.int32) - 8
    return (blocks.float() * scale[:, None]).reshape(shape)


def quantize_heads(x: torch.Tensor, bits: int = 8):
    """[..., hd] -> (payload, scales fp32 [...]): one absmax scale per
    head vector.  int8 payload [..., hd] through the blockwise kernel on
    x's device (its plain version on the CPU; x is copied contiguous
    first); `bits=4` packs nibbles into a uint8 [..., hd / 2] payload
    (plain PyTorch).  The pages' own writer is the fused page write
    (`ops/cuda/kv_write.py`), with the same bits."""
    hd = x.shape[-1]
    if bits == 4:
        q, s = quantize_int4(x, block_size=hd)
        return q.reshape(*x.shape[:-1], hd // 2), s.reshape(x.shape[:-1])
    q, s = quantize_blockwise(x.contiguous(), hd, device=x.device)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def dequantize_heads(q: torch.Tensor, s: torch.Tensor, bits: int = 8, *,
                     out_dtype=torch.float32):
    """Inverse of `quantize_heads`: fp32 values (or `out_dtype`, cast
    once from them).  int8 through the blockwise dequantize kernel on
    q's device (its plain version on the CPU; bf16 or fp16 out of the
    kernel directly), int4 in plain PyTorch."""
    if bits == 4:
        hd = 2 * q.shape[-1]
        return dequantize_int4(q.reshape(-1, q.shape[-1]), s.reshape(-1),
                               (*q.shape[:-1], hd)).to(out_dtype)
    y_dtype = out_dtype if out_dtype in KERNEL_DTYPES else torch.float32
    y = dequantize_blockwise(q.reshape(-1, q.shape[-1]), s.reshape(-1),
                             out_dtype=y_dtype, device=q.device)
    return y.reshape(q.shape).to(out_dtype)
