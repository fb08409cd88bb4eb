"""The serving forwards, the port of `hetu_tpu/models/generation.py`, for
both families (`LlamaLMHeadModel`, `GPTLMHeadModel`).

`last_logits` runs a whole prompt through the model's forward (flash
attention and the fused residual-norm kernel on the card; RoPE and
SwiGLU for LLaMA) and returns the last position's logits, the
reference's `prefill` logits without its cache: the model drafter's
forward.  Three programs carry the serving engine's main path:

  * `extend_cache` — chunked prefill: a [b, C] token block at positions
    start..start+C-1 writes its K/V into a dense per-request cache and
    attends causally over it (`_attend_cached_chunk`, a plain einsum,
    as in the reference).
  * `decode_step_paged` — gather-free decode: one token per slot writes
    its K/V into the slot's page and attends over the slot's pages
    through the page table (the `paged_attention` kernel).
  * `verify_step_paged` — the speculative verify step: k + 1 tokens per
    slot write their K/V into the slot's pages and attend causally over
    them in one launch a layer (the `paged_verify` kernel).

Both paged forwards take exact pools, or int8/int4 pools with their
per-head-vector fp32 scales: each layer writes this step's K and V into
its pages in one launch of the fused page write
(`ops/cuda/kv_write.write_kv_tokens`: cast to the pool's type, or
quantized on the way in), which reads K and V in place from the
projection's views, and the attention kernels dequantize pages in
registers.  Positions of a token block past the slot's table row write
into the null page.

They drive the model's modules layer by layer, because the KV cache is
written between the projection and the attention: one loop for both
families, through the model's `embed_at` (GPT adds its learned `wpe`
rows), `rope_at` (LLaMA's RoPE rows; GPT has none) and `final_norm`,
and each block's `serve_qkv` / `serve_tail` (an MoE block's layer
routes every row of the call, as the reference's: a decode step's idle
slots and a chunk's padded tail take capacity).  What is the same for
every layer (the RoPE rows of the positions, the page slots the tokens
write) is computed once per call.  A position past
max_position_embeddings raises ValueError, checked on the host before
any lookup (positions handed over as a CUDA tensor cost one
synchronize for it; the engine hands them over as host arrays).

Where the reference is functional (its caches and pools are returned
as new arrays and the engine donates the old buffers), the port updates
the caches and pools IN PLACE and returns the same tensors.

The LM head as a [hidden, vocab] matrix (the reference's
`lm_head_weight`, the fused sampler's weight) is the model's
`lm_head_weight()`.
"""
from __future__ import annotations

import torch

from hetu_tpu_torch.ops.cuda.kv_write import write_kv_tokens
from hetu_tpu_torch.ops.cuda.paged_attention import (paged_attention,
                                                     paged_verify,
                                                     resolve_quant)
from hetu_tpu_torch.ops.cuda.rotary import fused_rotary_qk

_NEG = -1e30


def _check_context_length(config, max_len: int):
    """Past the trained context GPT's `wpe` and LLaMA's RoPE table
    lookups would run off their ends — fail loudly instead.  One guard
    for every entry point that takes positions."""
    if max_len > config.max_position_embeddings:
        raise ValueError(
            f"cache length {max_len} exceeds max_position_embeddings "
            f"{config.max_position_embeddings}")


def _attend_cached_chunk(q, ck, cv, qpos: torch.Tensor, scale: float):
    """Multi-query cached attention for chunked prefill.  q: [b, C, nq,
    hd] at absolute positions qpos, [C] (every row alike) or [b, C];
    ck/cv: [b, M, n_kv, hd].  Key position k is visible to query i iff
    k <= qpos[i] (of its row).  GQA contracts the grouped q heads
    against the kv heads directly (no repeated cache).  Scores, softmax
    and the weighted sum in fp32."""
    b, M, n_kv, hd = ck.shape
    C, nq = q.shape[1], q.shape[2]
    group = nq // n_kv
    qg = q.reshape(b, C, n_kv, group, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * scale
    mask = torch.arange(M, device=q.device) <= qpos[..., None]  # [(b,) C, M]
    if mask.dim() == 3:
        mask = mask[:, None, None]
    s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    return out.reshape(b, C, nq, hd).to(q.dtype)


def _rotate(rope, q, k):
    """RoPE on q and k (LLaMA: the fused kernel, reading `serve_qkv`'s
    views in place; q comes out [b, s, nq, hd]) or nothing (GPT)."""
    if rope is None:
        return q, k
    return fused_rotary_qk(q, k, *rope, device=q.device)


@torch.no_grad()
def last_logits(model, input_ids: torch.Tensor) -> torch.Tensor:
    """The reference's `prefill` logits: the prompt input_ids [b, plen]
    through the model's forward (`model.hidden`, every block as its
    training forward runs it, without recompute), and the LM head on the
    last position only.  Returns [b, vocab]; no cache is built (the
    model drafter's forward).  The reference's `prefill` runs each
    block's training forward too, so its residual add + ln2 / post-norm
    is the fused norm kernel here as there; only the cache-writing
    forwards below apply the norm after the add, unfused, as the
    reference's do.  An MoE model's hash gate routes by row index here,
    as the reference's `prefill` calls its blocks."""
    _check_context_length(model.config, input_ids.shape[1])
    kw = {"route_by_ids": False} if getattr(model.config, "num_experts",
                                            0) else {}
    return model.logits(model.hidden(input_ids, **kw)[:, -1])


@torch.no_grad()
def extend_cache(model, tokens: torch.Tensor, cache, start):
    """Advance a dense KV cache by a whole token block (chunked prefill).

    tokens: [b, C] int; row r sits at absolute positions
    start[r]..start[r]+C-1, where `start` is an int (every row alike,
    the engine's form: the chunk is written as one slice) or [b] (as the
    reference takes it: the chunk is scattered row by row); cache:
    (k, v), each [L, b, M, n_kv, hd] in the compute dtype, updated in
    place.  Each query attends causally over its row's
    cache[:start+i+1]; the attention reads only the cache rows a chunk
    can see.  Returns (logits [b, C, vocab], cache)."""
    c = model.config
    cache_k, cache_v = cache
    b, C = tokens.shape
    M = cache_k.shape[2]
    start = torch.as_tensor(start)
    if start.dim() > 1 or (start.dim() == 1 and start.numel() != b):
        raise ValueError(f"start must be an int or [b={b}], got shape "
                         f"{tuple(start.shape)}")
    lo, hi = int(start.min()), int(start.max())
    if lo < 0 or hi + C > M:
        raise ValueError(f"chunk [{lo}, {hi + C}) outside the "
                         f"{M}-position cache")
    _check_context_length(c, hi + C)
    steps = torch.arange(C, device=tokens.device)
    if start.dim() == 0:
        qpos = lo + steps                                           # [C]
        rows = slice(None)
        write = slice(lo, lo + C)
    else:
        qpos = start.to(tokens.device).long()[:, None] + steps      # [b, C]
        rows = torch.arange(b, device=tokens.device)[:, None]
        write = qpos
    x = model.embed_at(tokens, qpos.expand(b, C))
    rope = model.rope_at(b, C, qpos.expand(b, C))
    scale = c.head_dim ** -0.5
    end = hi + C
    for li, layer in enumerate(model.layers):
        q, k, v = layer.serve_qkv(x)
        q, k = _rotate(rope, q, k)
        ck, cv = cache_k[li], cache_v[li]
        ck[rows, write] = k.to(ck.dtype)
        cv[rows, write] = v.to(cv.dtype)
        attn = _attend_cached_chunk(q, ck[:, :end], cv[:, :end], qpos,
                                    scale)
        x = layer.serve_tail(x, attn)
    return model.logits(model.final_norm(x)), cache


def _paged_forward(model, tokens, k_pool, v_pool, table, positions,
                   k_scale, v_scale, kv_quant, verify: bool):
    """The layers of a paged step over a token block tokens [S, C]:
    returns the final-norm hidden states [S, C, hidden]; the pools (and
    scales) are updated in place.  `verify` attends through
    `paged_verify`, else (C = 1) through `paged_attention`."""
    c = model.config
    kv_quant = resolve_quant(kv_quant, k_scale, v_scale)
    if kv_quant != "none":
        # here, not at the top: serving imports this module
        from hetu_tpu_torch.serving.kv_pool import tap_kv_snr
    S, C = tokens.shape
    positions = torch.as_tensor(positions)
    if positions.numel():
        _check_context_length(c, int(positions.max()) + C)
    table = table.to(torch.int32).contiguous()
    positions = positions.to(device=table.device,
                             dtype=torch.int32).contiguous()
    qpos = positions.long()[:, None] + torch.arange(C, device=table.device)
    x = model.embed_at(tokens, qpos)
    rope = model.rope_at(S, C, qpos)
    scale = c.head_dim ** -0.5
    for li, layer in enumerate(model.layers):
        q, k, v = layer.serve_qkv(x)
        q, k = _rotate(rope, q, k)
        kp, vp = k_pool[li], v_pool[li]
        ksc = vsc = None
        if kv_quant != "none":
            ksc, vsc = k_scale[li], v_scale[li]
            # the pool's numerics kv_pages SNR of the tokens this step
            # writes (HETU_TORCH_NUMERICS; nothing without a collector)
            bits = 4 if kv_quant == "int4" else 8
            tap_kv_snr(k, bits)
            tap_kv_snr(v, bits)
        write_kv_tokens(kp, vp, table, positions, k, v, k_scale=ksc,
                        v_scale=vsc, quant=kv_quant, device=q.device)
        kw = dict(softmax_scale=scale, k_scale=ksc, v_scale=vsc,
                  quant=kv_quant, device=q.device)
        if verify:
            attn = paged_verify(q.contiguous(), kp, vp, table, positions,
                                **kw)
        else:
            attn = paged_attention(q[:, 0].contiguous(), kp, vp, table,
                                   positions, **kw)
        x = layer.serve_tail(x, attn.reshape(S, C, -1))
    return model.final_norm(x)


def _pools_out(k_pool, v_pool, k_scale, v_scale):
    if k_scale is None:
        return k_pool, v_pool
    return k_pool, v_pool, k_scale, v_scale


@torch.no_grad()
def decode_step_paged(model, tokens: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor, *, k_scale=None,
                      v_scale=None, kv_quant=None):
    """One decode step attending directly over a paged KV pool.

    tokens: [S] int; k_pool/v_pool: [L, P, page_size, n_kv, hd] (page 0
    = the null page); table: [S, max_pages] int32; positions: [S] int
    (a tensor or a host array) — slot s's token sits at positions[s]
    and attends over everything at or before it.  This step's K/V are
    written into each slot's page BEFORE the kernel runs, so the token
    sees itself (write, then attend).  int8 pools pass their fp32 scales [L, P, page_size, n_kv]
    as k_scale/v_scale; int4 pools also pass ``kv_quant="int4"`` (uint8
    nibble payloads of head dim hd / 2).  The pools are updated in
    place.  Returns (logits [S, vocab], k_pool, v_pool[, k_scale,
    v_scale])."""
    hidden = _paged_forward(model, tokens[:, None], k_pool, v_pool, table,
                            positions, k_scale, v_scale, kv_quant,
                            verify=False)
    return (model.logits(hidden)[:, 0],
            *_pools_out(k_pool, v_pool, k_scale, v_scale))


@torch.no_grad()
def verify_step_paged(model, tokens: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor, *, k_scale=None,
                      v_scale=None, kv_quant=None,
                      return_hidden: bool = False):
    """The speculative VERIFY step over a paged KV pool: tokens [S, C]
    (the last emitted token + k drafts a slot); token i of slot s sits
    at positions[s] + i and attends causally over the slot's pages (the
    `paged_verify` kernel).  The block's K/V are written BEFORE the
    kernel runs; pools, scales and `kv_quant` as `decode_step_paged`.
    Returns (logits [S, C, vocab], *pools), or with
    ``return_hidden=True`` the final-norm hidden states [S, C, hidden]
    in the logits' place — the fused sampling epilogue consumes them,
    so the logits plane never leaves the sampling kernels' scratch."""
    hidden = _paged_forward(model, tokens, k_pool, v_pool, table,
                            positions, k_scale, v_scale, kv_quant,
                            verify=True)
    out = hidden if return_hidden else model.logits(hidden)
    return (out, *_pools_out(k_pool, v_pool, k_scale, v_scale))
