"""Recompute (activation checkpointing) per decoder block, the port of
`hetu_tpu/nn/remat.py`.

What a block keeps for its backward, by `remat_policy` (the reference's
`jax.checkpoint` policies; `jax.ad_checkpoint.saved_residuals` of its
block lists the same tensors, `tests/test_torch_train3.py`):

  * "nothing"   — the block's inputs; the whole block runs again in the
                  backward (every forward kernel twice a micro-batch);
  * "dots"      — `dots_with_no_batch_dims_saveable`: the outputs of the
                  projections that the backward reads — qkv, o and
                  gate-up (GPT: up); the down projection's output is
                  read by nothing (the residual add's backward needs no
                  value).  Everything else, the projections' inputs
                  included, is recomputed from them; the products are
                  not;
  * "dots_attn" — "dots" and the attention's output (the reference's
                  `save_only_these_names("attn_out")`), and on the flash
                  route the kernel's lse [b, hq, s] fp32, which its
                  backward reads: the flash forward runs once;
  * "offload"   — "dots", staged in pinned host memory after the forward
                  and brought back for the backward
                  (`offload_dot_with_no_batch_dims("device",
                  "pinned_host")`): the block's input and the
                  parameters stay on the device.

The mechanism is `recompute(pre, *inputs, weight=w)`: an autograd
Function that runs pre(*inputs) without a graph, then the projection
`project(h, w)` on its first output, and keeps only its inputs (and w).
Its backward runs pre again with a graph and feeds it the projection's
input gradient; the projection's two products are taken from the
recomputed h.  A block is a chain of such segments, each starting at a
kept tensor, so what `ctx.save_for_backward` sees — and
`saved_tensors_hooks` with it — is exactly the kept set.  Nothing is
cached between the forward and the recompute, so a kernel that fills a
buffer it allocated fills a new one each time.  `offloading(...)` wraps
a block's forward in the hooks that stage its kept tensors on the host.
Gradients are the same under every policy.  A segment differentiates
through its tensor inputs and its weight, as PyTorch's reentrant
checkpoint does: were all of them frozen, the parameters used inside
it would get no gradient (the Trainer trains every parameter; a PEFT
slice must pass its trainable ones in).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from hetu_tpu_torch.ops.activations import DropoutKey

REMAT_POLICIES = ("nothing", "dots", "dots_attn", "offload")

#: bytes the "offload" policy staged to the host (and brought back)
offloaded_bytes = 0


def validate_remat_policy(name: str):
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of "
                         f"{REMAT_POLICIES}")


def project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection without batch dimensions: h [..., K] times w [K, *out]
    (the reference's einsums "bsh,hkgd->bskgd", "bsh,hci->bsci" and
    `x @ W`), w cast to h's dtype; one matrix product."""
    k = w.shape[0]
    y = h.reshape(-1, k) @ w.reshape(k, -1).to(h.dtype)
    return y.view(*h.shape[:-1], *w.shape[1:])


def _project_backward(h, w, g):
    """(dh, dw) of `project`, the products autograd would take."""
    k = w.shape[0]
    wc = w.reshape(k, -1).to(h.dtype)
    gf = g.reshape(-1, wc.shape[1])
    dh = (gf @ wc.t()).view(h.shape)
    dw = (h.detach().reshape(-1, k).t() @ gf).view(w.shape).to(w.dtype)
    return dh, dw


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre, weight, *inputs):
        outs = pre(*inputs)
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        if weight is not None:
            outs = (project(outs[0], weight),) + outs[1:]
        ctx.pre, ctx.single = pre, single
        ctx.save_for_backward(weight, *inputs)
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *grads):
        weight, *inputs = ctx.saved_tensors
        args = [t.detach().requires_grad_(need) if t is not None else None
                for t, need in zip(inputs, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.pre(*args)
        outs = (outs,) if ctx.single else outs
        grads = list(grads)
        dweight = None
        if weight is not None:
            grads[0], dweight = _project_backward(outs[0], weight, grads[0])
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, dweight) + tuple(
            a.grad if a is not None and a.requires_grad else None
            for a in args)


def recompute(pre: Callable, *inputs, weight: Optional[torch.Tensor] = None):
    """pre(*inputs) (a tensor or a tuple; with `weight`, its first
    output projected by `project`), keeping only `inputs` and `weight`
    for the backward, which runs pre again.  Outside a graph it is a
    plain call."""
    if not torch.is_grad_enabled():
        outs = pre(*inputs)
        if weight is None:
            return outs
        if isinstance(outs, tuple):
            return (project(outs[0], weight),) + outs[1:]
        return project(outs, weight)
    return _Recompute.apply(pre, weight, *inputs)


def _shares_storage(t: torch.Tensor, others: Iterable[torch.Tensor]):
    ptr = t.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == ptr for o in others)


class offloading(torch.autograd.graph.saved_tensors_hooks):
    """Within it, every tensor an autograd node keeps is copied to
    pinned host memory (on the CPU: to a separate host tensor) and its
    device copy dropped; the backward brings it back.  Tensors sharing
    storage with `keep` — the block's input, its parameters — pass
    untouched.  Adds each staged tensor's bytes to `offloaded_bytes`."""

    def __init__(self, keep: Iterable[torch.Tensor]):
        kept = [t for t in keep if t is not None]

        def pack(t):
            global offloaded_bytes
            if _shares_storage(t, kept):
                return t
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                   pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.clone()
            offloaded_bytes += t.numel() * t.element_size()
            return t.device, host

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            device, host = packed
            return host.to(device, non_blocking=True)

        super().__init__(pack, unpack)


def run_blocks(config, blocks, x, args, rng):
    """x through `blocks` (LLaMA's or GPT's), each called with `args`
    and its layer's dropout key (`rng` folded by the layer index; no
    dropout without `rng`), recomputed in the backward as
    `config.remat_policy` says when gradients are on; under "offload"
    each block's kept tensors are staged on the host, all but its input,
    its arguments and its parameters."""
    remat = config.remat and torch.is_grad_enabled()
    policy = config.remat_policy
    for i, block in enumerate(blocks):
        key = None if rng is None else DropoutKey(rng).fold(i)
        if not remat:
            x = block(x, *args, key)
        elif policy == "offload":
            with offloading(keep=(x, *args, *block.parameters())):
                x = block.forward_remat(x, *args, key, policy="dots")
        else:
            x = block.forward_remat(x, *args, key, policy=policy)
    return x
