"""Blockwise int4 storage quantization, the port of
`hetu_tpu/ops/quantization.py` (the nibble packer and int4 pair).

Plain PyTorch, as the reference's are plain jnp: no TPU kernel backs
them.  The storage layout is the reference's: two values per byte, the
EVEN index in the LOW nibble, values offset by +8.  The int4 KV pages of
`serving/kv_pool.py` use this layout, and the paged-attention kernels
unpack it.  `quantize_heads` / `dequantize_heads` are the KV pages'
per-head-vector quantization (the reference's `serving/kv_pool.py`
pair): int8 through the blockwise kernel, int4 through
`quantize_int4`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from hetu_tpu_torch.ops.cuda.quant import quantize_blockwise


def pack_nibbles(u: torch.Tensor) -> torch.Tensor:
    """Unsigned nibble values in [0, 15], even last dim -> uint8 [...,
    n/2]: two adjacent values a byte, the even index in the low
    nibble."""
    if u.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, got "
                         f"{u.shape[-1]}")
    u = u.to(torch.uint8)
    even, odd = u[..., 0::2], u[..., 1::2]
    return even | (odd << 4)


def unpack_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of `pack_nibbles`: uint8 [..., n] -> values [..., 2n] in
    [0, 15] (uint8)."""
    return torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
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
    x's device (its plain version on the CPU); `bits=4` packs nibbles
    into a uint8 [..., hd / 2] payload (plain PyTorch)."""
    hd = x.shape[-1]
    if bits == 4:
        q, s = quantize_int4(x, block_size=hd)
        return q.reshape(*x.shape[:-1], hd // 2), s.reshape(x.shape[:-1])
    q, s = quantize_blockwise(x.contiguous(), hd, device=x.device)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def dequantize_heads(q: torch.Tensor, s: torch.Tensor, bits: int = 8):
    """Inverse of `quantize_heads`, in fp32."""
    if bits == 4:
        hd = 2 * q.shape[-1]
        return dequantize_int4(q.reshape(-1, q.shape[-1]), s.reshape(-1),
                               (*q.shape[:-1], hd))
    return q.float() * s[..., None]
