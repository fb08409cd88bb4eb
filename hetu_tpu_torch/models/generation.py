"""The serving forwards, the port of `hetu_tpu/models/generation.py`.

Three programs carry the serving engine's main path:

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
per-head-vector fp32 scales: this step's K/V are quantized on the way
in (`ops/quantization.quantize_heads`: the blockwise kernel for int8)
and the kernels dequantize pages in registers.  Positions of a token
block past the slot's table row write into the null page.

They drive the model's modules layer by layer, because the KV cache is
written between the projection and the attention; what is the same for
every layer (the RoPE rows of the positions, the page slots the tokens
write) is computed once per call.  Where the reference is functional
(its caches and pools are returned as new arrays and the engine donates
the old buffers), the port updates the caches and pools IN PLACE and
returns the same tensors.

The LM head as a [hidden, vocab] matrix (the reference's
`lm_head_weight`, the fused sampler's weight) is
`LlamaLMHeadModel.lm_head_weight`.
"""
from __future__ import annotations

import torch

from hetu_tpu_torch.ops.cuda.paged_attention import (paged_attention,
                                                     paged_verify,
                                                     resolve_quant)
from hetu_tpu_torch.ops.cuda.rotary import fused_rotary_qk
from hetu_tpu_torch.ops.quantization import quantize_heads
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


def _token_block_pages(table, positions, C: int, ps: int):
    """Where a C-token block at positions[s] + i writes: (page ids,
    offsets), each [S, C].  Positions past the slot's table row land in
    the null page (id 0), and rows that are not decoding point there
    already (their zeroed table rows, position 0): those writes touch no
    real page."""
    S, mp = table.shape
    pos = positions.long()[:, None] + torch.arange(C, device=table.device)
    pidx = pos // ps
    rows = torch.arange(S, device=table.device)[:, None]
    page = table[rows, pidx.clamp(max=mp - 1)].long()
    return torch.where(pidx < mp, page, torch.zeros_like(page)), pos % ps


def _paged_write_tokens(pool, page, offset, t):
    """Write a token block's K (or V) [S, C, n_kv, hd] into ONE layer's
    page array [P, ps, n_kv, hd] at `_token_block_pages`' slots, in
    place."""
    pool[page, offset] = t.to(pool.dtype)


def _paged_write_tokens_q(pool, scale, page, offset, t, bits: int):
    """The quantized form: payload and per-head-vector fp32 scale, by
    the pool's own quantizer, so pool contents agree whichever program
    wrote them."""
    q, s = quantize_heads(t, bits)
    pool[page, offset] = q
    scale[page, offset] = s


def _paged_forward(model, tokens, k_pool, v_pool, table, positions,
                   k_scale, v_scale, kv_quant, verify: bool):
    """The layers of a paged step over a token block tokens [S, C]:
    returns the final-norm hidden states [S, C, hidden]; the pools (and
    scales) are updated in place.  `verify` attends through
    `paged_verify`, else (C = 1) through `paged_attention`."""
    c = model.config
    kv_quant = resolve_quant(kv_quant, k_scale, v_scale)
    S, C = tokens.shape
    table = table.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    x = model.model.embed(tokens.long()).to(c.compute_dtype)
    qpos = positions.long()[:, None] + torch.arange(C, device=x.device)
    cos_t, sin_t = rope_tables(model.rope_cos, model.rope_sin, S, C, qpos)
    page, offset = _token_block_pages(table, positions, C, k_pool.shape[2])
    scale = c.head_dim ** -0.5
    for li, layer in enumerate(model.model.layers):
        q, k, v = layer.attn.project_qkv(layer.input_norm(x))
        q, k = fused_rotary_qk(q.contiguous(), k.contiguous(), cos_t,
                               sin_t, device=q.device)
        kp, vp = k_pool[li], v_pool[li]
        ksc = vsc = None
        if kv_quant == "none":
            _paged_write_tokens(kp, page, offset, k)
            _paged_write_tokens(vp, page, offset, v)
        else:
            ksc, vsc = k_scale[li], v_scale[li]
            bits = 4 if kv_quant == "int4" else 8
            _paged_write_tokens_q(kp, ksc, page, offset, k, bits)
            _paged_write_tokens_q(vp, vsc, page, offset, v, bits)
        kw = dict(softmax_scale=scale, k_scale=ksc, v_scale=vsc,
                  quant=kv_quant, device=q.device)
        if verify:
            attn = paged_verify(q, kp, vp, table, positions, **kw)
        else:
            attn = paged_attention(q[:, 0], kp, vp, table, positions, **kw)
        x = _layer_tail(layer, x, attn.reshape(S, C, -1))
    return model.model.final_norm(x)


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
    = the null page); table: [S, max_pages] int32; positions: [S] int32
    — slot s's token sits at positions[s] and attends over everything
    at or before it.  This step's K/V are written into each slot's page
    BEFORE the kernel runs, so the token sees itself (write, then
    attend).  int8 pools pass their fp32 scales [L, P, page_size, n_kv]
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
