"""AdamW's direction from its moments, shared by the port's tests that
bound how far two runs' parameters may drift apart (torch only: the card
tests, which import no JAX, use it too)."""
from __future__ import annotations

import torch


def adam_direction(m, v, step: int, opt) -> torch.Tensor:
    """AdamW's direction m^ / (sqrt(v^) + eps) from the moments after
    `step`."""
    c1, c2 = 1.0 - opt.b1 ** step, 1.0 - opt.b2 ** step
    return (m / c1) / (torch.sqrt(v / c2) + opt.eps)
