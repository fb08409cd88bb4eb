"""Blockwise absmax quantize and dequantize: wrappers, plain versions
and launch counters.

Replaces `hetu_tpu/ops/pallas/quant.py` `quantize_blockwise_pallas` and
`dequantize_blockwise_pallas` (their arithmetic is
`hetu_tpu/comm/compress.py` `quantize_blockwise` with deterministic
rounding, and `dequantize_blockwise`).  Kernels: `csrc/quant.cu`, bound
by bytes on the H100 (see its header).  The quantize runs the
head-vector body of `csrc/quant.cuh` (a block held by bs * 2 / 16 lanes
for bf16 or fp16, bs * 4 / 16 for fp32, one 16-byte load a lane, the
absmax by shuffles inside the group, the payload stored packed): one
read of the input (16-bit values widened exactly in registers), one
write of the int8 payload and fp32 scales; the payload is bit-identical
to the plain version.  The dequantize runs a thread per 16 payload
bytes and writes fp32, or bf16 or fp16 rounded once (the bits of
fp32-then-cast), so a caller that wants 16-bit weights writes half the
bytes; it is bit-identical to its plain version.  Launches are counted
by arm in `arm_launches`.  The serving engine writes its KV pages through
the fused page write on the same body (`ops/cuda/kv_write.py`), reads
int8 pages back densely for the prefix cache's prime through the
dequantize (`ops/quantization.dequantize_heads`), and the model drafter
quantizes its matrices once at load through the quantize, keeps them
resident in int8 and dequantizes a working copy every forward
(`serving/spec_decode._dequantize_resident`).  Stochastic rounding
feeds only the compressed collectives and arrives with them.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from hetu_tpu_torch.ops.cuda import build

#: quantize kernel launches (the plain versions never count)
launches = 0
#: dequantize kernel launches
dequant_launches = 0
#: each counter's launches by arm: the quantize's input type, the
#: dequantize's output type (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "dequant_launches")

_BLOCK_SIZES = (32, 64, 128, 256)
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"
_SYMBOLS = {torch.float32: "hetu_quantize_blockwise_f32",
            torch.bfloat16: "hetu_quantize_blockwise_bf16",
            torch.float16: "hetu_quantize_blockwise_f16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p]
_DQ_SYMBOLS = {torch.float32: "hetu_dequantize_blockwise_f32",
               torch.bfloat16: "hetu_dequantize_blockwise_bf16",
               torch.float16: "hetu_dequantize_blockwise_f16"}
_DQ_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
#: the types the kernels read (quantize) and write (dequantize) directly
KERNEL_DTYPES = tuple(_SYMBOLS)
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {**dict.fromkeys(_SYMBOLS.values(), _ARGTYPES),
               **dict.fromkeys(_DQ_SYMBOLS.values(), _DQ_ARGTYPES)}


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
    the kernel (fp32, bf16 or fp16 input on a 16-byte boundary, block sizes
    32, 64, 128 or 256), "cpu" runs the plain version; the tensor must
    lie there."""
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
        raise ValueError(f"the CUDA kernel takes fp32/bf16/fp16, got "
                         f"{x.dtype}")
    if block_size not in _BLOCK_SIZES:
        raise ValueError(f"the CUDA kernel takes block sizes {_BLOCK_SIZES}"
                         f" (a block in one warp's registers), got "
                         f"{block_size}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("quantize_blockwise needs a contiguous buffer on "
                         "a 16-byte boundary (the kernel's 16-byte loads)")
    nb = n // block_size
    q = torch.empty((nb, block_size), dtype=torch.int8, device=x.device)
    scales = torch.empty(nb, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.bind("quant", _SYMBOLS[x.dtype], _ARGTYPES)(
            x.data_ptr(), q.data_ptr(), scales.data_ptr(), nb, block_size,
            qmax(bits), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(err, "quantize_blockwise")
    build.count(globals(), "launches", x.dtype)
    return q, scales


def dequantize_blockwise_plain(q: torch.Tensor,
                               scale: torch.Tensor) -> torch.Tensor:
    """The reference's arithmetic: (q int8 [nb, bs], scales fp32 [nb])
    -> flat fp32 [nb * bs], each row times its scale."""
    return (q.float() * scale[:, None]).reshape(-1)


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, *,
                         out_dtype=torch.float32,
                         device="cuda") -> torch.Tensor:
    """(q int8 [nb, bs], scales fp32 [nb]) -> flat [nb * bs] of
    `out_dtype`: fp32, or bf16 or fp16 rounded once from the fp32
    product (the bits of the reference's fp32 output cast).
    `device` "cuda" launches the kernel (rows of q contiguous, any
    bs >= 1, any base alignment), "cpu" runs the plain version and
    casts; the tensors must lie there."""
    dev = build.check_device("dequantize_blockwise", device, q, scale)
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"dequantize_blockwise takes an int8 payload [nb, "
                         f"bs], got {q.dtype} {tuple(q.shape)}")
    nb, bs = q.shape
    if scale.dtype != torch.float32 or tuple(scale.shape) != (nb,):
        raise ValueError(f"dequantize_blockwise takes fp32 scales [{nb}], "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if out_dtype not in _DQ_SYMBOLS:
        raise ValueError(f"out_dtype must be fp32, bf16 or fp16, got "
                         f"{out_dtype}")
    if dev.type == "cpu":
        return dequantize_blockwise_plain(q, scale).to(out_dtype)
    if nb and bs and (q.stride(1) != 1 or (nb > 1 and q.stride(0) != bs)):
        raise ValueError("dequantize_blockwise needs a payload whose rows "
                         f"are contiguous, got strides {q.stride()}")
    scale = scale.contiguous()
    y = torch.empty(nb * bs, dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = build.bind("quant", _DQ_SYMBOLS[out_dtype], _DQ_ARGTYPES)(
            q.data_ptr(), scale.data_ptr(), y.data_ptr(), nb, bs,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "dequantize_blockwise")
    build.count(globals(), "dequant_launches", out_dtype)
    return y
