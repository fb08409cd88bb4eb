"""Dynamic loss scaling, the port of `hetu_tpu/optim/grad_scaler.py`
(`GradScaler`, `classify_transition`).

The state lives on the device — {"scale": fp32, "growth_tracker":
int32}, both 0-d — and every method is tensor arithmetic on it, so a
training step updates the scale without the host reading anything.  The
arithmetic is the reference's `update_scale`: a finite step adds one to
the tracker and, once it reaches `growth_interval`, multiplies the scale
by `growth_factor` and resets it; a non-finite step multiplies the scale
by `backoff_factor` and resets the tracker.  The loss scaling and the
unscale live in the Trainer (the unscale folded into the token divide,
as the reference's step does), and finiteness is the gradients' global
norm's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class GradScaler:
    init_scale: float = 2.0 ** 16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000

    def init(self, device="cpu") -> Dict[str, torch.Tensor]:
        return {"scale": torch.tensor(self.init_scale, dtype=torch.float32,
                                      device=device),
                "growth_tracker": torch.zeros((), dtype=torch.int32,
                                              device=device)}

    def update(self, state, all_finite: torch.Tensor):
        """update_scale: grow on streaks of finite steps, back off on a
        non-finite one."""
        tracker = torch.where(all_finite, state["growth_tracker"] + 1,
                              torch.zeros_like(state["growth_tracker"]))
        grow = tracker >= self.growth_interval
        scale = state["scale"]
        scale = torch.where(
            all_finite,
            torch.where(grow, scale * self.growth_factor, scale),
            scale * self.backoff_factor)
        tracker = torch.where(grow, torch.zeros_like(tracker), tracker)
        return {"scale": scale, "growth_tracker": tracker}


def classify_transition(prev: Optional[float], new: float) -> Optional[str]:
    """The host's reading of one step's scale against the previous one:
    "growth", "backoff", or None (unchanged, or the first reading)."""
    if prev is None or new == prev:
        return None
    return "growth" if new > prev else "backoff"
