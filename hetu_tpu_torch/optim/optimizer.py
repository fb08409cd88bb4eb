"""Optimizers, the port of `hetu_tpu/optim/optimizer.py` (`AdamW`, `Adam`,
`clip_by_global_norm`, `cosine_schedule`, `constant_schedule`).

The reference is functional and donates the old buffers to its jitted
step; here `AdamW.update` and `clip_by_global_norm` write into the
tensors they are given.  The update is the reference's arithmetic —
b2 = 0.95, eps outside the square root, weight decay inside the
bracket on EVERY leaf, fp32 moments — through `ops.cuda.adam`, one
launch per leaf; not torch.optim.AdamW, whose decoupled decay is other
arithmetic.  `AdamW(device=...)`, "cuda" by default, is where the update
runs: the kernel, or with "cpu" its plain version; the tensors must lie
there.  `clip_by_global_norm` launches no kernel of its own and runs
where its gradients lie.

The step-dependent scalars — the schedule's lr and the bias
corrections c1 = 1 - b1^step, c2 = 1 - b2^step — are computed on the
host in fp32 with numpy, as the reference computes them in fp32 inside
its graph.  The step count is a Python int, so nothing is read back
from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Union

import numpy as np
import torch

from hetu_tpu_torch.ops.cuda.adam import adam_update

_f32 = np.float32


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """Scale the fp32 `grads` in place by min(1, max_norm / max(norm,
    1e-12)),
    the reference's rule (torch's clip_grad_norm_ divides by
    norm + 1e-6 instead).  Returns (grads, the global L2 norm before
    clipping, a 0-d fp32 tensor on the grads' device)."""
    gnorm = torch.stack([g.float().square().sum() for g in grads]).sum()
    gnorm = gnorm.sqrt()
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads, gnorm


@dataclasses.dataclass
class AdamW:
    """AdamW with bias correction.  `lr` is a number or a schedule
    step -> lr (the step counts from 1); `device` as in
    `ops.cuda.adam.adam_update`."""

    lr: Union[float, Callable[[int], float]] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    device: Union[str, torch.device] = "cuda"

    def init(self, params: List[torch.Tensor]):
        """{"step": 0, "m": [...], "v": [...]}: fp32 zeros per leaf."""
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return {"step": 0, "m": zeros,
                "v": [torch.zeros_like(z) for z in zeros]}

    def _lr(self, step: int) -> float:
        return float(self.lr(step) if callable(self.lr) else _f32(self.lr))

    def update(self, grads, state, params):
        """One step over every leaf, IN PLACE on params, state["m"] and
        state["v"]; state["step"] advances.  Returns (params, state)."""
        step = state["step"] + 1
        lr = self._lr(step)
        c1 = _f32(1.0) - _f32(self.b1) ** _f32(step)
        c2 = _f32(1.0) - _f32(self.b2) ** _f32(step)
        for p, g, m, v in zip(params, grads, state["m"], state["v"]):
            adam_update(p, g, m, v, lr, c1, c2, b1=self.b1, b2=self.b2,
                        eps=self.eps, weight_decay=self.weight_decay,
                        device=self.device)
        state["step"] = step
        return params, state


def Adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, device="cuda"):
    return AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=0.0,
                 device=device)


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warmup to `peak_lr`, then a cosine down to
    peak_lr * min_ratio at `total_steps`; fp32 as in the reference."""
    def lr(step: int) -> float:
        s = _f32(step)
        warm = _f32(peak_lr) * s / _f32(max(warmup_steps, 1))
        prog = np.clip((s - _f32(warmup_steps))
                       / _f32(max(total_steps - warmup_steps, 1)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(peak_lr) * (_f32(min_ratio) + _f32((1 - min_ratio) * 0.5)
                               * (_f32(1.0) + np.cos(_f32(np.pi) * prog)))
        return float(warm if step < warmup_steps else cos)

    return lr


def constant_schedule(lr_value: float):
    def lr(step: int) -> float:
        return float(_f32(lr_value))
    return lr
