"""Attention, the port of `hetu_tpu/ops/attention.py`.

`attention` is the reference's plain composition: GQA by repeating the
kv heads, q/k/v upcast to fp32, the scale applied after the dot, a
causal mask aligned bottom-right (`tril(k=sk-sq)`) and an optional
segment mask, softmax and the weighted sum in fp32, cast back to q's
dtype.  `flash_attention` is the dispatcher the model calls.  The
reference routes it to its Pallas flash kernel on a TPU and to
`attention` everywhere else; the port's flash kernels (forward and
backward) arrive with the second training slice, so until then asking
for flash on the card raises, and the CPU runs `attention`, as the
reference does off the TPU.
"""
from typing import Optional

import torch

from hetu_tpu_torch.ops.cuda import build

_FLASH_SLICE = "the second training slice (ROADMAP Queue A item 2)"


def attention(q, k, v, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None,
              softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention.  q [b, sq, hq, d], k/v [b, sk, hk, d] (hk
    divides hq; each kv head serves hq/hk consecutive q heads).
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
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None,
                    use_pallas: Optional[bool] = None, device="cuda"):
    """The model's attention entry point.  `use_pallas=False` runs
    `attention`; otherwise (the reference's auto or forced flash route)
    `device` "cuda" raises NotImplementedError until the flash kernels
    are ported, and "cpu" runs `attention`, as the reference's
    dispatcher does off the TPU."""
    dev = torch.device(device)
    if use_pallas is not False and dev.type == "cuda":
        raise NotImplementedError(
            "flash attention on the card is not in the port yet; it "
            f"arrives with {_FLASH_SLICE}.  Set "
            "LlamaConfig.use_flash_attention=False for the dense "
            "attention.")
    build.check_device("attention", dev, q, k, v)
    return attention(q, k, v, causal=causal, segment_ids=segment_ids,
                     softmax_scale=softmax_scale)
