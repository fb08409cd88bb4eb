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
it would get no gradient.

LoRA (`peft/lora.py`) binds adapters to frozen weights for a forward
(`adapters_bound`): `project` and `weight_of` then use the merged
weight W + ((A @ B).reshape(W.shape) * scale).to(W.dtype), the
reference's arithmetic.  A segment whose weight has an adapter keeps W,
A and B, not the merged weight (which would keep a second copy of every
adapted matrix until the backward: ~7.0B elements at Llama-3-8B), merges
again in the backward and returns A's and B's gradients; a block
recomputed whole ("nothing") takes its adapters as inputs
(`adapted=`) and rebinds them for its recompute.  The bits are those of
a merge before the forward.  A numerics tap made while a segment
recomputes is skipped (`obs.numerics.suspended`): the forward made it.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable, Iterable, NamedTuple, Optional

import torch

from hetu_tpu_torch.obs import numerics
from hetu_tpu_torch.ops.activations import DropoutKey

REMAT_POLICIES = ("nothing", "dots", "dots_attn", "offload")

#: bytes the "offload" policy staged to the host (and brought back)
offloaded_bytes = 0


def validate_remat_policy(name: str):
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {name!r}; one of "
                         f"{REMAT_POLICIES}")


class Adapter(NamedTuple):
    """A LoRA adapter of a weight W [in, *out]: a [in, r] and b [r, out]
    in fp32, and the scale alpha / r."""
    a: torch.Tensor
    b: torch.Tensor
    scale: float


def merge_weight(w: torch.Tensor, adapter: Adapter) -> torch.Tensor:
    """The reference's merge: delta = (A @ B).reshape(w.shape) * scale
    in fp32, then w + delta in w's dtype."""
    delta = (adapter.a @ adapter.b).reshape(w.shape) * adapter.scale
    return w + delta.to(w.dtype)


_bound = threading.local()


@contextlib.contextmanager
def adapters_bound(pairs):
    """Within it, each (weight, Adapter) of `pairs` is merged wherever
    the weight is projected (`project`, `weight_of`) on this thread."""
    prev = getattr(_bound, "map", None)
    _bound.map = {id(w): (w, ad) for w, ad in pairs}
    try:
        yield
    finally:
        _bound.map = prev


def adapter_of(w: torch.Tensor) -> Optional[Adapter]:
    """The adapter bound to `w` (the same tensor object), or None."""
    bound = getattr(_bound, "map", None)
    hit = bound.get(id(w)) if bound else None
    return hit[1] if hit is not None and hit[0] is w else None


def weight_of(w: torch.Tensor) -> torch.Tensor:
    """`w`, merged with its bound adapter if it has one."""
    ad = adapter_of(w)
    return w if ad is None else merge_weight(w, ad)


def bound_factors(params: Iterable[torch.Tensor]):
    """The A and B of the adapters bound to `params`."""
    return [t for p in params if (ad := adapter_of(p)) is not None
            for t in (ad.a, ad.b)]


def project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A projection without batch dimensions: h [..., K] times w [K, *out]
    (the reference's einsums "bsh,hkgd->bskgd", "bsh,hci->bsci" and
    `x @ W`), w (merged with its bound adapter) cast to h's dtype; one
    matrix product."""
    w = weight_of(w)
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
    def forward(ctx, pre, weight, adapted, n, *tensors):
        # tensors: pre's n inputs, then A and B of each adapted weight
        outs = pre(*tensors[:n])
        single = not isinstance(outs, tuple)
        outs = (outs,) if single else outs
        if weight is not None:
            outs = (project(outs[0], weight),) + outs[1:]
        ctx.pre, ctx.single, ctx.adapted, ctx.n = pre, single, adapted, n
        ctx.save_for_backward(weight, *tensors)
        return outs[0] if single else outs

    @staticmethod
    def backward(ctx, *grads):
        weight, *tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        args = [t.detach().requires_grad_(g) if t is not None else None
                for t, g in zip(tensors, need)]
        inputs, factors = args[:ctx.n], args[ctx.n:]
        rebound = [(w, Adapter(factors[2 * i], factors[2 * i + 1], scale))
                   for i, (w, scale) in enumerate(ctx.adapted)]
        with torch.enable_grad(), adapters_bound(rebound), \
                numerics.suspended():
            outs = ctx.pre(*inputs)
            w_eff = None if weight is None else weight_of(weight)
        outs = (outs,) if ctx.single else outs
        grads = list(grads)
        dweight, merged = None, []
        if weight is not None:
            grads[0], dweight = _project_backward(outs[0], w_eff.detach(),
                                                  grads[0])
            if w_eff is not weight:     # merged: d(A, B) through the merge
                merged = [(w_eff, dweight)]
                if not ctx.needs_input_grad[1]:
                    dweight = None
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad] + merged
        if pairs:
            torch.autograd.backward([o for o, _ in pairs],
                                    [g for _, g in pairs])
        return (None, dweight, None, None) + tuple(
            a.grad if a is not None and a.requires_grad else None
            for a in args)


def recompute(pre: Callable, *inputs, weight: Optional[torch.Tensor] = None,
              adapted: Iterable[torch.Tensor] = ()):
    """pre(*inputs) (a tensor or a tuple; with `weight`, its first
    output projected by `project`), keeping only `inputs` and `weight`
    (and the adapter factors of `weight` and of `adapted`, the weights
    pre itself projects with) for the backward, which runs pre again.
    Outside a graph it is a plain call."""
    if not torch.is_grad_enabled():
        outs = pre(*inputs)
        if weight is None:
            return outs
        if isinstance(outs, tuple):
            return (project(outs[0], weight),) + outs[1:]
        return project(outs, weight)
    seen, bound = set(), []
    for w in ((weight,) if weight is not None else ()) + tuple(adapted):
        ad = adapter_of(w)
        if ad is not None and id(w) not in seen:
            seen.add(id(w))
            bound.append((w, ad))
    return _Recompute.apply(pre, weight, [(w, ad.scale) for w, ad in bound],
                            len(inputs), *inputs,
                            *(t for _, ad in bound for t in (ad.a, ad.b)))


def _shares_storage(t: torch.Tensor, others: Iterable[torch.Tensor]):
    ptr = t.untyped_storage().data_ptr()
    return any(o.untyped_storage().data_ptr() == ptr for o in others)


class offloading(torch.autograd.graph.saved_tensors_hooks):
    """Within it, every tensor an autograd node keeps is copied to
    pinned host memory (on the CPU: to a separate host tensor) and its
    device copy dropped; the backward brings it back.  Tensors sharing
    storage with `keep` — the block's input, its parameters — pass
    untouched.  A tensor two nodes keep (an MoE block's attention
    output, kept by its router and its expert segments) is staged once.
    Adds each staged tensor's bytes to `offloaded_bytes`."""

    def __init__(self, keep: Iterable[torch.Tensor]):
        kept = [t for t in keep if t is not None]
        staged = {}     # id(t) -> (weakref to t, its version, packed)

        def pack(t):
            global offloaded_bytes
            if _shares_storage(t, kept):
                return t
            hit = staged.get(id(t))
            if hit is not None and hit[0]() is t and hit[1] == t._version:
                return hit[2]
            if t.device.type == "cuda":
                host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                                   pin_memory=True)
                host.copy_(t, non_blocking=True)
            else:
                host = t.clone()
            offloaded_bytes += t.numel() * t.element_size()
            staged[id(t)] = (weakref.ref(t), t._version, (t.device, host))
            return t.device, host

        def unpack(packed):
            if isinstance(packed, torch.Tensor):
                return packed
            device, host = packed
            return host.to(device, non_blocking=True)

        super().__init__(pack, unpack)


def run_blocks(config, blocks, x, args, rng, token_ids=None):
    """x through `blocks` (LLaMA's or GPT's), each called with `args`
    and its layer's dropout key (`rng` folded by the layer index; no
    dropout without `rng`), recomputed in the backward as
    `config.remat_policy` says when gradients are on; under "offload"
    each block's kept tensors are staged on the host, all but its input,
    its arguments, its parameters and their bound adapters.  Returns
    (x, aux): aux sums the MoE blocks' aux losses in layer order (their
    hash gate routed by `token_ids`), None without MoE blocks."""
    remat = config.remat and torch.is_grad_enabled()
    policy = config.remat_policy
    kw = {"token_ids": token_ids} if getattr(config, "num_experts", 0) \
        else {}
    aux = None
    for i, block in enumerate(blocks):
        key = None if rng is None else DropoutKey(rng).fold(i)
        if not remat:
            x = block(x, *args, key, **kw)
        elif policy == "offload":
            params = list(block.parameters())
            with offloading(keep=(x, *args, *params,
                                  *bound_factors(params))):
                x = block.forward_remat(x, *args, key, policy="dots", **kw)
        else:
            x = block.forward_remat(x, *args, key, policy=policy, **kw)
        if isinstance(x, tuple):
            x, a = x
            aux = a if aux is None else aux + a
    return x, aux
