"""Recompute (activation checkpointing) per decoder block, the port of
`hetu_tpu/nn/remat.py`.

`remat(fn, *args)` is `torch.utils.checkpoint` (non-reentrant): fn's
activations are dropped after the forward and recomputed in the
backward.  The model applies it by policy (`LlamaBlock` in
`models/llama/model.py`):

  * "nothing"   — around the whole block: nothing inside it is kept, and
                  every forward kernel of a block launches twice per
                  micro-batch (forward, and the backward's recompute);
  * "dots"      — the reference keeps the outputs of the matrix products
                  without batch dimensions (the qkv, o, gate-up and down
                  projections) and recomputes the rest.  Here the four
                  projections run outside any checkpoint and the
                  segments between them (input norm; RoPE + attention;
                  residual add + post norm; SwiGLU) are each recomputed.
                  PyTorch's matrix products keep their inputs for the
                  weight gradient, so the segments' outputs stay alive
                  as well: the policy saves less memory than the
                  reference's, and launches what the reference's does;
  * "dots_attn" — "dots", and the attention runs outside the checkpoint
                  too, so its output (and its lse, [b, hq, s] fp32) is
                  kept and the flash forward is not launched again in
                  the backward: the costliest recompute under "dots".

Gradients are the same under every policy.  "offload" (dots staged in
pinned host memory) launches no kernel and no configuration of the
reference's benchmarks uses it; it arrives with the third training
slice.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

REMAT_POLICIES = ("nothing", "dots", "dots_attn", "offload")
_OFFLOAD_SLICE = "the third training slice (ROADMAP Queue A item 2)"


def validate_remat_policy(name: str):
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of "
                         f"{REMAT_POLICIES}")
    if name == "offload":
        raise NotImplementedError(
            f"remat_policy='offload' is not in the port yet; it arrives "
            f"with {_OFFLOAD_SLICE}")


def remat(fn, *args):
    """fn(*args), its activations recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False)
