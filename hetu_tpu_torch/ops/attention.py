"""Attention, the port of `hetu_tpu/ops/attention.py`.

`attention` is the reference's plain composition: GQA by repeating the
kv heads, q/k/v upcast to fp32, the scale applied after the dot, a
causal mask aligned bottom-right (`tril(k=sk-sq)`) and an optional
segment mask, softmax and the weighted sum in fp32, cast back to q's
dtype.  `flash_attention` is the dispatcher the model calls.  The
reference routes it to its Pallas flash kernel on a TPU and to
`attention` everywhere else; the port routes it by device: on the card
to the flash kernels of `ops/cuda/flash_attention.py` (forward, and dq
and dk/dv in the backward), on the CPU to `attention`, as the reference
does off the TPU.

Dropout on the probabilities exists only in `attention`, as in the
reference, whose models leave the flash kernel when
`attention_dropout > 0` (the mask: `ops.activations.dropout`).

`attention_keeping_output` is the attention of the recompute policy
"dots_attn" (`nn/remat.py`): it keeps its output (on the flash route,
and the kernel's lse) and recomputes only its inputs in the backward,
so the flash forward runs once.
"""
from typing import Callable, Optional

import torch

from hetu_tpu_torch.ops.activations import DropoutKey, dropout
from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda import flash_attention as flash


def attention(q, k, v, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              softmax_scale: Optional[float] = None,
              dropout_rate: float = 0.0,
              dropout_key: Optional[DropoutKey] = None) -> torch.Tensor:
    """Softmax attention.  q [b, sq, hq, d], k/v [b, sk, hk, d] (hk
    divides hq; each kv head serves hq/hk consecutive q heads).  With a
    `dropout_key` and a rate above 0, dropout on the fp32 probabilities.
    Returns [b, sq, hq, d] in q's dtype."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if hk != hq:
        k = torch.repeat_interleave(k, hq // hk, dim=2)
        v = torch.repeat_interleave(v, hq // hk, dim=2)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~mask, neg)
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~same[:, None], neg)
    probs = torch.softmax(scores, dim=-1)
    probs = dropout(probs, dropout_rate, dropout_key, deterministic=False)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None,
                    use_pallas: Optional[bool] = None, device="cuda"):
    """The model's attention entry point.  `use_pallas=False` runs
    `attention`.  Otherwise `device` "cuda" launches the flash kernels
    (the reference's auto and forced routes alike: there is no shape
    gate that quietly falls back, an unsupported shape raises), and
    "cpu" runs `attention` on auto (None), as the reference's dispatcher
    does off the TPU, and the flash kernels' plain version when forced
    (True)."""
    dev = build.check_device("attention", device, q, k, v)
    if not _routes_to_flash(use_pallas, dev):
        return attention(q, k, v, causal=causal, segment_ids=segment_ids,
                         softmax_scale=softmax_scale)
    return flash.flash_attention(q, k, v, causal=causal,
                                 segment_ids=segment_ids,
                                 softmax_scale=softmax_scale, device=dev)


def _routes_to_flash(use_pallas, dev, rate: float = 0.0,
                     key: Optional[DropoutKey] = None) -> bool:
    """The one route rule: the flash kernels unless the dense attention
    is asked for (`use_pallas=False`), the CPU's auto route, or dropout
    on the probabilities (a rate above 0 with a key)."""
    return not (use_pallas is False or (rate > 0.0 and key is not None)
                or (use_pallas is None and dev.type == "cpu"))


def self_attention(q, k, v, *, segment_ids=None, use_pallas=None,
                   dropout_rate: float = 0.0,
                   dropout_key: Optional[DropoutKey] = None,
                   device="cuda") -> torch.Tensor:
    """The models' causal self-attention, heads merged [b, s, hq * d]:
    `flash_attention`, or with attention dropout in force the
    composition with dropout on its probabilities, as the reference's
    models route it."""
    b, s = q.shape[:2]
    dev = build.check_device("attention", device, q, k, v)
    if _routes_to_flash(use_pallas, dev, dropout_rate, dropout_key):
        o = flash.flash_attention(q, k, v, causal=True,
                                  segment_ids=segment_ids, device=dev)
    else:
        o = attention(q, k, v, causal=True, segment_ids=segment_ids,
                      dropout_rate=dropout_rate, dropout_key=dropout_key)
    return o.reshape(b, s, -1)


class _KeptAttention(torch.autograd.Function):
    """attn = self_attention(*heads(qkv)), keeping attn (and on the
    flash route the kernel's lse) for the backward, which recomputes
    heads(qkv) — RoPE, views, a bias add — and then launches only the
    flash backward; on the composition route it recomputes the
    attention (its backward needs the probabilities)."""

    @staticmethod
    def forward(ctx, heads, kw, qkv):
        q, k, v = heads(qkv)
        dev = build.check_device("attention", kw["device"], q, k, v)
        lse = None
        if _routes_to_flash(kw["use_pallas"], dev, kw["dropout_rate"],
                            kw["dropout_key"]):
            o, lse = flash.flash_attention_with_lse(
                q, k, v, causal=True, segment_ids=kw["segment_ids"],
                device=dev)
            attn = o.reshape(*q.shape[:2], -1)
        else:
            attn = self_attention(q, k, v, **kw)
        ctx.heads, ctx.kw = heads, kw
        ctx.save_for_backward(qkv, attn, lse)
        return attn

    @staticmethod
    def backward(ctx, dattn):
        qkv, attn, lse = ctx.saved_tensors
        kw = ctx.kw
        x = qkv.detach().requires_grad_(True)
        with torch.enable_grad():
            q, k, v = ctx.heads(x)
            if lse is None:
                torch.autograd.backward(self_attention(q, k, v, **kw), dattn)
            else:
                grads = flash.flash_attention_backward(
                    q.detach(), k.detach(), v.detach(), attn.view(q.shape),
                    lse, dattn.reshape(q.shape), causal=True,
                    segment_ids=kw["segment_ids"], device=q.device)
                torch.autograd.backward((q, k, v), grads)
        return None, None, x.grad


def attention_keeping_output(heads: Callable, qkv: torch.Tensor, *,
                             segment_ids=None, use_pallas=None,
                             dropout_rate: float = 0.0,
                             dropout_key: Optional[DropoutKey] = None,
                             device="cuda") -> torch.Tensor:
    """`self_attention(*heads(qkv))` keeping for the backward only qkv,
    the output and (flash) lse [b, hq, s] fp32 (the policy "dots_attn";
    without a graph, a plain call)."""
    kw = dict(segment_ids=segment_ids, use_pallas=use_pallas,
              dropout_rate=dropout_rate, dropout_key=dropout_key,
              device=device)
    if not torch.is_grad_enabled():
        return self_attention(*heads(qkv), **kw)
    return _KeptAttention.apply(heads, kw, qkv)
