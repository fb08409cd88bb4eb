"""Recompute (activation checkpointing) per decoder block, the port of
`hetu_tpu/nn/remat.py`.

Policy "nothing" — save nothing inside the block, recompute it all in
the backward — is `torch.utils.checkpoint` (non-reentrant) around the
block.  Under it every forward kernel of a block launches twice per
micro-batch: once in the forward, once in the backward's recompute.
The reference's other policies keep chosen activations and arrive with
the second training slice.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("nothing", "dots", "dots_attn", "offload")
_LATER = "the second training slice (ROADMAP Queue A item 2)"


def validate_remat_policy(name: str):
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of "
                         f"{REMAT_POLICIES}")
    if name != "nothing":
        raise NotImplementedError(
            f"remat_policy={name!r} is not in the port yet; it arrives "
            f"with {_LATER} (the port recomputes whole blocks, policy "
            "'nothing')")


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)
