"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.  The default is the GPU;
    asking for CUDA on a machine without a card raises instead of
    quietly running on the CPU (pass device="cpu" for that).  A bare
    "cuda" resolves to the current card, so two entry points asked for
    "cuda" and "cuda:0" agree."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
