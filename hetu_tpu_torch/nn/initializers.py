"""Parameter initializers, the port of `hetu_tpu/nn/initializers.py`.

Each factory returns init(shape, dtype=torch.float32, generator=None,
device=None) -> a new tensor: drawn in fp32 from `generator` (a
torch.Generator on `device`) and cast to `dtype`, as the reference
draws in fp32 from its PRNG key.  Fans are the reference's: [in, out]
for a matrix, receptive fields multiplied in for convolution kernels
(h, w, in, out).
"""
from __future__ import annotations

import math

import torch


def _empty(shape, device):
    return torch.empty(tuple(shape), dtype=torch.float32, device=device)


def zeros(shape, dtype=torch.float32, generator=None, device=None):
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, generator=None, device=None):
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def constant(value):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        return torch.full(tuple(shape), value, dtype=dtype, device=device)
    return init


def normal(stddev=0.02, mean=0.0):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        x = _empty(shape, device).normal_(generator=generator)
        return (mean + stddev * x).to(dtype)
    return init


def truncated_normal(stddev=0.02):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        x = torch.nn.init.trunc_normal_(_empty(shape, device), 0.0, 1.0,
                                        -2.0, 2.0, generator=generator)
        return (stddev * x).to(dtype)
    return init


def _uniform(shape, limit, dtype, generator, device):
    x = _empty(shape, device).uniform_(-limit, limit, generator=generator)
    return x.to(dtype)


def uniform(scale=0.05):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        return _uniform(shape, scale, dtype, generator, device)
    return init


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def xavier_uniform(gain=1.0):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        fan_in, fan_out = _fans(shape)
        limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(shape, limit, dtype, generator, device)
    return init


def xavier_normal(gain=1.0):
    def init(shape, dtype=torch.float32, generator=None, device=None):
        std = gain * math.sqrt(2.0 / sum(_fans(shape)))
        x = _empty(shape, device).normal_(generator=generator)
        return (std * x).to(dtype)
    return init


def he_uniform():
    def init(shape, dtype=torch.float32, generator=None, device=None):
        fan_in, _ = _fans(shape)
        return _uniform(shape, math.sqrt(6.0 / fan_in), dtype, generator,
                        device)
    return init


def he_normal():
    def init(shape, dtype=torch.float32, generator=None, device=None):
        fan_in, _ = _fans(shape)
        x = _empty(shape, device).normal_(generator=generator)
        return (math.sqrt(2.0 / fan_in) * x).to(dtype)
    return init
