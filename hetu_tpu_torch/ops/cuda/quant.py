"""Blockwise absmax quantize: wrapper, plain version and launch counter.

Replaces `hetu_tpu/ops/pallas/quant.py` `quantize_blockwise_pallas`
(its arithmetic is `hetu_tpu/comm/compress.py` `quantize_blockwise`,
deterministic rounding).  Kernel: `csrc/quant.cu`, bound by bytes on
the H100 (see its header): a warp a block, one read of the input (bf16
widened in registers), one write of the int8 payload and fp32 scales;
the payload is bit-identical to the plain version.  The serving engine
quantizes int8 KV pages through it (`serving/kv_pool.quantize_heads`).
Stochastic rounding feeds only the compressed collectives and arrives
with them; the dequantize kernel too.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0

_BLOCK_SIZES = (32, 64, 128, 256)
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"
_SYMBOLS = {torch.float32: "hetu_quantize_blockwise_f32",
            torch.bfloat16: "hetu_quantize_blockwise_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = dict.fromkeys(_SYMBOLS.values(), _ARGTYPES)


def qmax(bits: int) -> float:
    """The largest payload magnitude of a bit width: 127 or 7."""
    if bits == 8:
        return 127.0
    if bits == 4:
        return 7.0
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def quantize_blockwise_plain(x: torch.Tensor, block_size: int,
                             bits: int = 8
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's arithmetic in PyTorch: fp32 blocks, scale =
    max|x| / qmax floored at 1e-12, payload round-half-to-even(x /
    scale) clipped to [-qmax, qmax] as int8."""
    qm = qmax(bits)
    blocks = x.reshape(-1, block_size).float()
    # a divisor on the data's device: PyTorch's CUDA division by a host
    # scalar multiplies by its reciprocal, which is not a true division
    qm_t = blocks.new_full((), qm)
    scale = torch.clamp_min(blocks.abs().amax(dim=1) / qm_t, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qm, qm)
    return q.to(torch.int8), scale


def quantize_blockwise(x: torch.Tensor, block_size: int, *, bits: int = 8,
                       stochastic: bool = False, device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat buffer (any shape, numel % block_size == 0) -> (q int8
    [n // bs, bs], scales fp32 [n // bs]).  `device` "cuda" launches
    the kernel (fp32 or bf16 input, block sizes 32, 64, 128 or 256),
    "cpu" runs the plain version; the tensor must lie there."""
    if stochastic:
        raise NotImplementedError(
            "stochastic rounding feeds the compressed collectives; it "
            f"arrives with {_MULTI_GPU}")
    dev = build.check_device("quantize_blockwise", device, x)
    qmax(bits)
    n = x.numel()
    if block_size < 1 or n % block_size:
        raise ValueError(f"buffer of {n} elements is not a multiple of "
                         f"block_size={block_size}")
    if dev.type == "cpu":
        return quantize_blockwise_plain(x, block_size, bits)
    if x.dtype not in _SYMBOLS:
        raise ValueError(f"the CUDA kernel takes fp32/bf16, got {x.dtype}")
    if block_size not in _BLOCK_SIZES:
        raise ValueError(f"the CUDA kernel takes block sizes {_BLOCK_SIZES}"
                         f" (a block in one warp's registers), got "
                         f"{block_size}")
    if not x.is_contiguous():
        raise ValueError("quantize_blockwise needs a contiguous buffer")
    nb = n // block_size
    q = torch.empty((nb, block_size), dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.bind("quant", _SYMBOLS[x.dtype], _ARGTYPES)(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), nb, block_size,
            qmax(bits), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, "quantize_blockwise")
    global launches
    launches += 1
    return q, scales
