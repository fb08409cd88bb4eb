"""Activations, the port of `hetu_tpu/ops/activations.py` (`swiglu`,
`gelu`, `dropout`).

`gelu` is the tanh form, the reference's default (`approximate=True`),
in plain PyTorch: the reference has no Pallas kernel for it.

`swiglu` is the dispatcher the MLP calls on its fused gate/up
projection: one call to `ops.cuda.swiglu.fused_swiglu` — the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors, and
differentiable either way.  Both compute in fp32 and round once, as the
reference's Pallas kernel does (the reference's own plain composition
computes in the input dtype instead; in fp32 the two agree).

`dropout` keeps the reference's arithmetic — `where(keep, x / keep_prob,
0)` with keep_prob cast to x's dtype first, as JAX casts the Python
float — but not its bits: JAX's threefry stream cannot be reproduced,
so the mask is counter-based.  A 32-bit integer hash of (the key, a
counter) gives two elements their 16-bit draws (element 2i the low
half of counter i's word, 2i + 1 the high half), computed with plain
torch integer ops on int64 (every product below 2^63), so the CPU and
the card draw the same mask, and so does every recompute of the same
site: the mask needs no saved state and no generator.  An element is
kept when its draw lies below round(keep_prob * 2^16) (the keep share
is keep_prob to 2^-17).  A key is a tuple of ints — the Trainer's
(seed + 1, step, micro-batch), the model's layer and the site — folded
on the host into two 32-bit words (`DropoutKey`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from hetu_tpu_torch.ops.cuda.swiglu import fused_swiglu

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
# odd multipliers below 2^31: a 32-bit value times one stays below 2^63
_C1, _C2, _C3 = 0x2C1B3C6D, 0x297A2D39, 0x27D4EB2F


def swiglu(gu: torch.Tensor) -> torch.Tensor:
    """SwiGLU combine of gu [..., 2, inner]: silu(gu[..., 0, :]) *
    gu[..., 1, :]."""
    return fused_swiglu(gu, device=gu.device)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (jax.nn.gelu(approximate=True))."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


class DropoutKey(tuple):
    """A dropout stream: a tuple of non-negative ints (the reference's
    `fold_in` chain).  `fold(i)` derives a sub-stream, as
    `jax.random.fold_in` does."""

    def fold(self, i: int) -> "DropoutKey":
        return DropoutKey(self + (int(i),))

    def words(self) -> Tuple[int, int]:
        """The two 32-bit words the element hash mixes in."""
        h = 0
        for v in self:
            h = _splitmix64(h ^ (int(v) & _M64))
        return h & _M32, (h >> 32) & _M32


def dropout_bits(numel: int, key: DropoutKey, device) -> torch.Tensor:
    """[ceil(numel / 2)] int64 in [0, 2^32): the hash of each counter
    under `key` (two rounds of multiply-xorshift around the key words),
    the draws of elements 2i (low 16 bits) and 2i + 1 (high)."""
    k1, k2 = key.words()
    x = torch.arange((numel + 1) // 2, dtype=torch.int64, device=device)
    x.bitwise_xor_(k1)
    x.mul_(_C1).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 15)
    x.mul_(_C2).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 13)
    x.bitwise_xor_(k2)
    x.mul_(_C3).bitwise_and_(_M32)
    x.bitwise_xor_(x >> 16)
    return x


def keep_mask(shape, rate: float, key: DropoutKey, device) -> torch.Tensor:
    """The bool mask of `shape` whose elements are kept, each with
    probability 1 - rate (to 2^-17)."""
    n = 1
    for d in shape:
        n *= int(d)
    threshold = round((1.0 - rate) * 2 ** 16)
    bits = dropout_bits(n, key, device)
    low = bits.bitwise_and(0xFFFF) < threshold
    high = bits.bitwise_right_shift_(16) < threshold
    return torch.stack((low, high), dim=-1).view(-1)[:n].view(shape)


def _scaled(x: torch.Tensor, mask: torch.Tensor, keep: float):
    """where(mask, x / keep, 0), keep in x's dtype (JAX's weak-typed
    Python float), the quotient rounded once to x's dtype."""
    q = x / torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, q, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


class _Dropout(torch.autograd.Function):
    """Saves nothing: the backward draws the same mask again."""

    @staticmethod
    def forward(ctx, x, rate, key):
        ctx.rate, ctx.key = rate, key
        return _scaled(x, keep_mask(x.shape, rate, key, x.device), 1 - rate)

    @staticmethod
    def backward(ctx, g):
        mask = keep_mask(g.shape, ctx.rate, ctx.key, g.device)
        return _scaled(g, mask, 1 - ctx.rate), None, None


def dropout(x: torch.Tensor, rate: float, key: Optional[DropoutKey] = None,
            deterministic: bool = True) -> torch.Tensor:
    """Functional dropout (the reference's `ops.dropout`): x unchanged
    when `deterministic`, the rate is 0 or there is no key."""
    if deterministic or rate == 0.0 or key is None:
        return x
    return _Dropout.apply(x, float(rate), DropoutKey(key))
