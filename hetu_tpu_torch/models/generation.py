"""The serving forwards, the port of `hetu_tpu/models/generation.py`.

Two programs carry the serving engine's main path:

  * `extend_cache` — chunked prefill: a [b, C] token block at positions
    start..start+C-1 writes its K/V into a dense per-request cache and
    attends causally over it (`_attend_cached_chunk`, a plain einsum,
    as in the reference).
  * `decode_step_paged` — gather-free decode: one token per slot writes
    its K/V into the slot's page (`_paged_write`) and attends over the
    slot's pages through the page table (the `paged_attention` kernel).

Both drive the model's modules layer by layer, because the KV cache is
written between the projection and the attention; what is the same for
every layer (the RoPE rows of the positions, the page slots the token
writes) is computed once per call.  Where the reference
is functional (its caches and pools are returned as new arrays and the
engine donates the old buffers), the port updates the caches and pools
IN PLACE and returns the same tensors.

The LM head as a [hidden, vocab] matrix (the reference's
`lm_head_weight`) is `LlamaLMHeadModel.lm_head_weight`.
"""
from __future__ import annotations

import torch

from hetu_tpu_torch.ops.cuda.paged_attention import paged_attention
from hetu_tpu_torch.ops.cuda.rotary import fused_rotary_qk
from hetu_tpu_torch.ops.rotary import rope_tables

_NEG = -1e30


def _check_context_length(config, max_len: int):
    """Past the trained context the RoPE table lookup would run off its
    end — fail loudly instead.  One guard for every cache-building entry
    point."""
    if max_len > config.max_position_embeddings:
        raise ValueError(
            f"cache length {max_len} exceeds max_position_embeddings "
            f"{config.max_position_embeddings}")


def _attend_cached_chunk(q, ck, cv, start: int, scale: float):
    """Multi-query cached attention for chunked prefill.  q: [b, C, nq,
    hd] sits at absolute positions start..start+C-1; ck/cv: [b, M, n_kv,
    hd].  Key position k is visible to query i iff k <= start + i.  GQA
    contracts the grouped q heads against the kv heads directly (no
    repeated cache).  Scores, softmax and the weighted sum in fp32."""
    b, M, n_kv, hd = ck.shape
    C, nq = q.shape[1], q.shape[2]
    group = nq // n_kv
    qg = q.reshape(b, C, n_kv, group, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.float()) * scale
    qpos = start + torch.arange(C, device=q.device)               # [C]
    mask = torch.arange(M, device=q.device)[None, :] <= qpos[:, None]
    s = s.masked_fill(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
    return out.reshape(b, C, nq, hd).to(q.dtype)


def _layer_tail(layer, h, attn):
    """o_proj + residual, then the MLP on the post-norm + residual."""
    b, s = attn.shape[:2]
    h = h + layer.attn.o_proj(attn.reshape(b, s, -1))
    return h + layer.mlp(layer.post_norm(h))


@torch.no_grad()
def extend_cache(model, tokens: torch.Tensor, cache, start: int):
    """Advance a dense KV cache by a whole token block (chunked prefill).

    tokens: [b, C] int at absolute positions start..start+C-1; cache:
    (k, v), each [L, b, M, n_kv, hd] in the compute dtype, updated in
    place.  Each query attends causally over cache[:start+i+1]; the
    attention reads only the first start+C cache rows, the only ones a
    chunk can see, so rows past them are never read.  Returns (logits
    [b, C, vocab], cache)."""
    c = model.config
    cache_k, cache_v = cache
    b, C = tokens.shape
    M = cache_k.shape[2]
    if start < 0 or start + C > M:
        raise ValueError(f"chunk [{start}, {start + C}) outside the "
                         f"{M}-position cache")
    x = model.model.embed(tokens.long()).to(c.compute_dtype)
    qpos = (start + torch.arange(C, device=tokens.device)).expand(b, C)
    cos_t, sin_t = rope_tables(model.rope_cos, model.rope_sin, b, C, qpos)
    scale = c.head_dim ** -0.5
    end = start + C
    for li, layer in enumerate(model.model.layers):
        q, k, v = layer.attn.project_qkv(layer.input_norm(x))
        q, k = fused_rotary_qk(q.contiguous(), k.contiguous(), cos_t,
                               sin_t, device=q.device)
        ck, cv = cache_k[li], cache_v[li]
        ck[:, start:end] = k.to(ck.dtype)
        cv[:, start:end] = v.to(cv.dtype)
        attn = _attend_cached_chunk(q, ck[:, :end], cv[:, :end], start,
                                    scale)
        x = _layer_tail(layer, x, attn)
    hidden = model.model.final_norm(x)
    return model.logits(hidden), cache


def _page_slots(table, positions, ps: int):
    """Where each slot's token goes: (table[s, pos // ps], pos % ps).
    Rows that are not decoding point at the null page (id 0) at
    position 0: their writes land there, and only there, so the
    duplicate indices among them touch no real page."""
    pos = positions.long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    return table[rows, pos // ps].long(), pos % ps


def _paged_write(pool, page, offset, t):
    """Write one token's K (or V) [S, n_kv, hd] into ONE layer's page
    array [P, ps, n_kv, hd] at the slots `_page_slots` gave, in place."""
    pool[page, offset] = t.to(pool.dtype)


@torch.no_grad()
def decode_step_paged(model, tokens: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, table: torch.Tensor,
                      positions: torch.Tensor):
    """One decode step attending directly over a paged KV pool.

    tokens: [S] int; k_pool/v_pool: [L, P, page_size, n_kv, hd] (page 0
    = the null page); table: [S, max_pages] int32; positions: [S] int32
    — slot s's token sits at positions[s] and attends over everything
    at or before it.  This step's K/V are written into each slot's page
    BEFORE the kernel runs, so the token sees itself (write, then
    attend).  The pools are updated in place.  Returns (logits [S,
    vocab], k_pool, v_pool)."""
    c = model.config
    S = tokens.shape[0]
    table = table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    x = model.model.embed(tokens.long()[:, None]).to(c.compute_dtype)
    cos_t, sin_t = rope_tables(model.rope_cos, model.rope_sin, S, 1,
                               positions.long()[:, None])
    page, offset = _page_slots(table, positions, k_pool.shape[2])
    scale = c.head_dim ** -0.5
    for li, layer in enumerate(model.model.layers):
        q, k, v = layer.attn.project_qkv(layer.input_norm(x))
        q, k = fused_rotary_qk(q.contiguous(), k.contiguous(), cos_t,
                               sin_t, device=q.device)
        kp, vp = k_pool[li], v_pool[li]
        _paged_write(kp, page, offset, k[:, 0])
        _paged_write(vp, page, offset, v[:, 0])
        attn = paged_attention(q[:, 0], kp, vp, table, positions,
                               softmax_scale=scale, device=q.device)
        x = _layer_tail(layer, x, attn.reshape(S, 1, -1))
    hidden = model.model.final_norm(x)
    return model.logits(hidden)[:, 0], k_pool, v_pool
