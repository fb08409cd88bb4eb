"""Paged-attention decode: wrapper, plain version and launch counter.

Replaces `hetu_tpu/ops/pallas/paged_attention.py` `paged_attention`
(exact pages; the int8/int4 page modes and `paged_verify` come in a
later slice).  Kernel: `csrc/paged_attention.cu`, bound by the bytes
of the live K/V pages on the H100 (see its header): one block per
(slot, kv head) stages tiles of keys in shared memory, reads each live
K/V row once for the whole q-head group, and never loads a key past the
slot's position.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0

#: the kernel's limits (csrc/paged_attention.cu PA_MAX_GROUP, PA_MAX_D *
#: PA_THREADS)
MAX_GROUP = 16
MAX_HEAD_DIM = 256

_NEG = -1e30
_SYMBOLS = {torch.float32: "hetu_paged_attention_f32",
            torch.bfloat16: "hetu_paged_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                         ctypes.c_void_p]


def paged_attention_plain(q, k_pool, v_pool, table, positions,
                          softmax_scale: float):
    """Dense form of the same function: gather each slot's pages, mask
    keys past positions[s] (their scores AND their values, so stale
    bytes in unread pages cannot reach the output), softmax in fp32."""
    S, nq, hd = q.shape
    _, ps, n_kv, _ = k_pool.shape
    mp = table.shape[1]
    group = nq // n_kv
    idx = table.long()
    ks = k_pool[idx].reshape(S, mp * ps, n_kv, hd).float()
    vs = v_pool[idx].reshape(S, mp * ps, n_kv, hd).float()
    visible = (torch.arange(mp * ps, device=q.device)[None, :]
               <= positions.long()[:, None])                     # [S, M]
    qg = q.float().reshape(S, n_kv, group, hd)
    s = torch.einsum("shgd,skhd->shgk", qg, ks) * softmax_scale
    s = s.masked_fill(~visible[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    vs = vs.masked_fill(~visible[:, :, None, None], 0.0)
    o = torch.einsum("shgk,skhd->shgd", p, vs)
    return o.reshape(S, nq, hd).to(q.dtype)


def _check(q, k_pool, v_pool, table, positions):
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"expected q [S, nq, hd] and pool [P, ps, n_kv, hd],"
                         f" got {tuple(q.shape)} / {tuple(k_pool.shape)}")
    S, nq, hd = q.shape
    _, _, n_kv, hd_p = k_pool.shape
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} vs "
                         f"{tuple(v_pool.shape)}")
    if hd_p != hd:
        raise ValueError(f"head dim mismatch: q {hd}, pool {hd_p}")
    if nq % n_kv:
        raise ValueError(f"q heads {nq} must divide by kv heads {n_kv}")
    if q.dtype not in _SYMBOLS or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise ValueError(f"q and pools must share an fp32/bf16 dtype, got "
                         f"{q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    if table.dim() != 2 or table.shape[0] != S or table.dtype != torch.int32:
        raise ValueError(f"table must be int32 [S={S}, max_pages], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if positions.shape != (S,) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 [S={S}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")


def paged_attention(q, k_pool, v_pool, table, positions, *,
                    softmax_scale: Optional[float] = None,
                    device="cuda"):
    """Decode attention over paged KV.  q: [S, nq, hd] (one token per
    slot); k_pool/v_pool: [P, page_size, n_kv, hd] (page 0 = the null
    page); table: [S, max_pages] int32 page ids; positions: [S] int32 —
    slot s attends over global positions <= positions[s].  Returns
    [S, nq, hd] in q's dtype.  `device` "cuda" launches the kernel,
    "cpu" runs the plain version; the tensors must lie there."""
    dev = build.check_device("paged_attention", device, q, k_pool, v_pool,
                             table, positions)
    _check(q, k_pool, v_pool, table, positions)
    S, nq, hd = q.shape
    _, ps, n_kv, _ = k_pool.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    if dev.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, positions,
                                     scale)
    group = nq // n_kv
    if group > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes q-head groups <= "
                         f"{MAX_GROUP} and head dims <= {MAX_HEAD_DIM}, got "
                         f"group {group}, hd {hd}")
    # the kernel stages K/V rows with 16-byte loads
    if (hd * q.element_size()) % 16 or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel needs 16-byte K/V rows on "
                         f"16-byte-aligned pools, got hd {hd} of "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("table", table), ("positions", positions)):
        if not t.is_contiguous():
            raise ValueError(f"paged_attention needs contiguous {name}")
    out = torch.empty_like(q)
    fn = getattr(build.library("paged_attention"), _SYMBOLS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 table.data_ptr(), positions.data_ptr(), out.data_ptr(),
                 S, n_kv, group, hd, ps, table.shape[1], scale,
                 torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "paged_attention")
    global launches
    launches += 1
    return out
