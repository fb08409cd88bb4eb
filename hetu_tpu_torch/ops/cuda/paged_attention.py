"""Paged attention, decode and speculative verify: wrappers, plain
versions and launch counters.

Replaces `hetu_tpu/ops/pallas/paged_attention.py` `paged_attention`
(decode, one query token a slot) and `paged_verify` (C = k + 1 query
tokens a slot), each over exact, int8 or int4 pages (`_load_page`).
Kernel: `csrc/paged_attention.cuh` (its symbols exported a query type a
source: `paged_attention_bf16.cu`, `paged_attention_f32.cu`,
`paged_attention_f16.cu`), one kernel for both, bound by the
bytes of the live K/V pages on the H100 (see its header): each slot's
keys are split across blocks by `split_plan` (from the table's width
and the row count alone, so a launch never reads `positions` on the
host and can be captured in a CUDA graph), each block streams its pages
through a cp.async ring and never loads a key past the slot's last
query position, and a second kernel merges the splits in a fixed
order.  `paged_verify_split_plain` is that split-then-merge arithmetic
in PyTorch, for the tests.  fp32, bf16 and fp16 queries each have their
arm (16-bit products on the tensor cores, fp32 scores and P.V, o rounded
once to q's type); launches are counted by arm in `arm_launches`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.quantization import unpack_nibbles

#: decode launches over exact pages (the plain versions never count)
launches = 0
#: decode launches over int8 / int4 pages
int8_launches = 0
int4_launches = 0
#: verify launches, every page mode
verify_launches = 0
#: each counter's launches by the query's arm (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "int8_launches", "int4_launches",
                                "verify_launches")

#: the kernel's limits (csrc/paged_attention.cuh PA_MAX_ROWS,
#: PA_MAX_HD, PA_MAX_SPLIT): C * group query rows a kv head, the head
#: dim, the keys a split
MAX_ROWS = 32
MAX_HEAD_DIM = 256
MAX_SPLIT = 1024
# keys a split where a kv head holds few query rows (decode) and many
# (verify), timed on the card (csrc/paged_attention.cuh's header)
_SPLIT_KEYS_FEW_ROWS = 256
_SPLIT_KEYS_MANY_ROWS = 128

_NEG = -1e30
_MODES = ("none", "int8", "int4")
_PAYLOAD = {"int8": torch.int8, "int4": torch.uint8}
_SYMBOLS = {
    (torch.float32, "none"): "hetu_paged_attention_f32",
    (torch.bfloat16, "none"): "hetu_paged_attention_bf16",
    (torch.float32, "int8"): "hetu_paged_attention_int8_f32",
    (torch.bfloat16, "int8"): "hetu_paged_attention_int8_bf16",
    (torch.float32, "int4"): "hetu_paged_attention_int4_f32",
    (torch.bfloat16, "int4"): "hetu_paged_attention_int4_bf16",
    (torch.float16, "none"): "hetu_paged_attention_f16",
    (torch.float16, "int8"): "hetu_paged_attention_int8_f16",
    (torch.float16, "int4"): "hetu_paged_attention_int4_f16",
}
#: the library (csrc/<name>.cu) that exports each query type's symbols:
#: one source a type, so the three build in parallel
_LIBRARY = {torch.float32: "paged_attention_f32",
            torch.bfloat16: "paged_attention_bf16",
            torch.float16: "paged_attention_f16"}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p])
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = dict.fromkeys(_SYMBOLS.values(), _ARGTYPES)


def resolve_quant(quant, k_scale, v_scale) -> str:
    """The reference's rule: scales given iff the pages are quantized;
    scales without a mode mean int8."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if quant is None:
        quant = "int8" if k_scale is not None else "none"
    if quant not in _MODES:
        raise ValueError(f"paged-attention page mode {quant!r} unsupported; "
                         f"known: {_MODES}")
    if (quant != "none") != (k_scale is not None):
        raise ValueError(f"page mode {quant!r} needs scales iff quantized "
                         "(int8/int4)")
    return quant


def _dense(pool, scale, table, quant: str, hd: int):
    """Each slot's pages gathered and dequantized: [S, mp * ps, n_kv, hd]
    in fp32 (int8: k * scale; int4: (nibble - 8) * scale)."""
    S, mp = table.shape
    idx = table.long()
    g = pool[idx]                            # [S, mp, ps, n_kv, hd_p]
    if quant == "int4":
        g = unpack_nibbles(g).to(torch.int32) - 8
    g = g.float()
    if quant != "none":
        g = g * scale[idx][..., None]
    return g.reshape(S, mp * pool.shape[1], pool.shape[2], hd)


def paged_verify_plain(q, k_pool, v_pool, table, positions,
                       softmax_scale: float, k_scale=None, v_scale=None,
                       quant: str = "none"):
    """Dense form of the verify function: gather and dequantize each
    slot's pages, mask keys past positions[s] + c for query c (scores),
    and past the last query's position (values, so stale bytes in
    unread pages cannot reach the output), softmax in fp32."""
    S, C, nq, hd = q.shape
    n_kv = k_pool.shape[2]
    group = nq // n_kv
    ks = _dense(k_pool, k_scale, table, quant, hd)
    vs = _dense(v_pool, v_scale, table, quant, hd)
    M = ks.shape[1]
    keys = torch.arange(M, device=q.device)
    qpos = positions.long()[:, None] + torch.arange(C, device=q.device)
    visible = keys[None, None, :] <= qpos[:, :, None]            # [S, C, M]
    qg = q.float().reshape(S, C, n_kv, group, hd)
    s = torch.einsum("schgd,skhd->shgck", qg, ks) * softmax_scale
    s = s.masked_fill(~visible[:, None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    vs = vs.masked_fill(~visible[:, -1, :, None, None], 0.0)
    o = torch.einsum("shgck,skhd->schgd", p, vs)
    return o.reshape(S, C, nq, hd).to(q.dtype)


def paged_attention_plain(q, k_pool, v_pool, table, positions,
                          softmax_scale: float, k_scale=None, v_scale=None,
                          quant: str = "none"):
    """Dense form of the decode function: the verify form with one
    query a slot."""
    return paged_verify_plain(q[:, None], k_pool, v_pool, table, positions,
                              softmax_scale, k_scale, v_scale, quant)[:, 0]


def split_plan(max_pages: int, page_size: int, rows: int):
    """(splits, keys a split) of the kernel's grid for a table of
    `max_pages` pages of `page_size` and `rows` = C * group query rows a
    kv head.  Shapes alone decide it, never `positions`: the kernel
    reads those on the card, so a launch never waits on the device and
    a CUDA graph replays it for any positions.  Keys a split are a
    multiple of the page size; one split when it covers the table."""
    target = _SPLIT_KEYS_FEW_ROWS if rows <= 8 else _SPLIT_KEYS_MANY_ROWS
    keys = max(1, target // page_size) * page_size
    total = max_pages * page_size
    if total <= keys:
        return 1, total
    return -(-total // keys), keys


def paged_verify_split_plain(q, k_pool, v_pool, table, positions,
                             softmax_scale: float, k_scale=None,
                             v_scale=None, quant: str = "none",
                             keys_per_split: Optional[int] = None):
    """The kernel's split-then-merge arithmetic in PyTorch (for the
    tests; any `keys_per_split`, `split_plan`'s by default): each split
    j over keys [j K, (j + 1) K) keeps each row's max m_j (the finite
    sentinel -1e30 where it sees no key), sum l_j and unnormalised
    accumulator; splits starting past a slot's last visible key are not
    live; the live ones merge in split order, M = max m_j, out = sum
    acc_j exp(m_j - M) / sum l_j exp(m_j - M) (l == 0 -> 1).  Same
    arguments and result as `paged_verify_plain`."""
    S, C, nq, hd = q.shape
    n_kv = k_pool.shape[2]
    group = nq // n_kv
    ps = k_pool.shape[1]
    K = keys_per_split or split_plan(table.shape[1], ps, C * group)[1]
    ks = _dense(k_pool, k_scale, table, quant, hd)
    vs = _dense(v_pool, v_scale, table, quant, hd)
    M = ks.shape[1]
    keys = torch.arange(M, device=q.device)
    qpos = positions.long()[:, None] + torch.arange(C, device=q.device)
    visible = keys[None, None, :] <= qpos[:, :, None]            # [S, C, M]
    qg = q.float().reshape(S, C, n_kv, group, hd)
    s = torch.einsum("schgd,skhd->shgck", qg, ks) * softmax_scale
    s = s.masked_fill(~visible[:, None, None], _NEG)
    vs = vs.masked_fill(~visible[:, -1, :, None, None], 0.0)
    n_keys = torch.clamp(positions.long() + C, max=M)             # [S]
    parts = []                      # each split's (live, m, l, acc)
    for j0 in range(0, M, K):
        sj = s[..., j0:j0 + K]
        vis = visible[:, None, None, :, j0:j0 + K]
        m = sj.amax(dim=-1)         # -1e30 where the split sees no key
        p = torch.where(vis, torch.exp(sj - m[..., None]), 0.0)
        acc = torch.einsum("shgck,skhd->shgcd", p, vs[:, j0:j0 + K])
        live = ((j0 < n_keys) | (j0 == 0))[:, None, None, None]
        parts.append((live, m, p.sum(dim=-1), acc))
    # the merge: live splits only, summed in split order
    m_max = torch.stack([torch.where(live, m, _NEG)
                         for live, m, _, _ in parts]).amax(dim=0)
    l_sum = torch.zeros_like(m_max)
    o_sum = torch.zeros_like(parts[0][3])
    for live, m, l, acc in parts:
        f = torch.where(live, torch.exp(m - m_max), 0.0)
        l_sum = l_sum + l * f
        o_sum = o_sum + acc * f[..., None]
    out = o_sum / torch.where(l_sum == 0, 1.0, l_sum)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(S, C, nq, hd).to(q.dtype)


def _check(q, k_pool, v_pool, table, positions, k_scale, v_scale,
           quant: str):
    """q is [S, C, nq, hd] here."""
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError(f"expected q [S, (C,) nq, hd] and pool [P, ps, "
                         f"n_kv, hd], got {tuple(q.shape)} / "
                         f"{tuple(k_pool.shape)}")
    S, C, nq, hd = q.shape
    P, ps, n_kv, hd_p = k_pool.shape
    if C < 1:
        raise ValueError("verify needs at least one query position")
    if v_pool.shape != k_pool.shape or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"k/v pools differ: {tuple(k_pool.shape)} "
                         f"{k_pool.dtype} vs {tuple(v_pool.shape)} "
                         f"{v_pool.dtype}")
    want_hd = hd // 2 if quant == "int4" else hd
    if hd_p != want_hd or (quant == "int4" and hd % 2):
        raise ValueError(f"head dim mismatch: q {hd} expects pool "
                         f"{want_hd} ({quant} pages), got {hd_p}")
    if nq % n_kv:
        raise ValueError(f"q heads {nq} must divide by kv heads {n_kv}")
    if q.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"q must be fp32/bf16/fp16, got {q.dtype}")
    want = q.dtype if quant == "none" else _PAYLOAD[quant]
    if k_pool.dtype != want:
        raise ValueError(f"{quant} pages need {want} pools, got "
                         f"{k_pool.dtype}")
    if quant != "none":
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(sc.shape) != (P, ps, n_kv) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be fp32 [P={P}, ps={ps}, "
                                 f"n_kv={n_kv}], got {sc.dtype} "
                                 f"{tuple(sc.shape)}")
    if table.dim() != 2 or table.shape[0] != S or table.dtype != torch.int32:
        raise ValueError(f"table must be int32 [S={S}, max_pages], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if positions.shape != (S,) or positions.dtype != torch.int32:
        raise ValueError(f"positions must be int32 [S={S}], got "
                         f"{positions.dtype} {tuple(positions.shape)}")


def _launch(q, k_pool, v_pool, table, positions, k_scale, v_scale,
            quant: str, scale: float):
    """The kernel on q [S, C, nq, hd]; returns out like q."""
    S, C, nq, hd = q.shape
    _, ps, n_kv, _ = k_pool.shape
    group = nq // n_kv
    mp = table.shape[1]
    if C * group > MAX_ROWS or hd > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes C * group <= {MAX_ROWS} "
                         f"query rows a kv head and head dims <= "
                         f"{MAX_HEAD_DIM}, got C {C}, group {group}, hd {hd}")
    # the kernel stages page rows with 16-byte copies
    if (k_pool.shape[-1] * k_pool.element_size()) % 16 \
            or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"the CUDA kernel needs 16-byte page rows on "
                         f"16-byte-aligned pools, got hd {hd} of "
                         f"{quant} pages")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("table", table), ("positions", positions)]
    if quant != "none":
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"paged attention needs contiguous {name}")
    splits, kps = split_plan(mp, ps, C * group)
    if kps > MAX_SPLIT:
        raise ValueError(f"the CUDA kernel takes pages of at most "
                         f"{MAX_SPLIT} keys, got {ps}")
    out = torch.empty_like(q)
    # the splits' fp32 partials: the accumulators of each (slot, kv head,
    # split, row), then their (m, l)
    part = None
    if splits > 1:
        part = torch.empty(S * n_kv * splits * C * group * (hd + 2),
                           dtype=torch.float32, device=q.device)
    sc = (k_scale.data_ptr(), v_scale.data_ptr()) if quant != "none" \
        else (None, None)
    with torch.cuda.device(q.device):
        err = build.bind(_LIBRARY[q.dtype], _SYMBOLS[(q.dtype, quant)],
                         _ARGTYPES)(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *sc,
            table.data_ptr(), positions.data_ptr(), out.data_ptr(), S, C,
            n_kv, group, hd, ps, mp, scale,
            None if part is None else part.data_ptr(), kps,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(err, "paged_attention")
    return out


def _prepare(name, device, q, k_pool, v_pool, table, positions, k_scale,
             v_scale, quant):
    scales = [t for t in (k_scale, v_scale) if t is not None]
    dev = build.check_device(name, device, q, k_pool, v_pool, table,
                             positions, *scales)
    return dev, resolve_quant(quant, k_scale, v_scale)


def paged_attention(q, k_pool, v_pool, table, positions, *,
                    softmax_scale: Optional[float] = None, k_scale=None,
                    v_scale=None, quant: Optional[str] = None,
                    device="cuda"):
    """Decode attention over paged KV.  q: [S, nq, hd] (one token per
    slot); k_pool/v_pool: [P, page_size, n_kv, hd] (page 0 = the null
    page) in q's type (fp32, bf16 or fp16), or int8 payloads, or
    (`quant="int4"`) uint8
    nibble payloads [P, page_size, n_kv, hd / 2], with fp32 scales
    k_scale/v_scale [P, page_size, n_kv]; table: [S, max_pages] int32
    page ids; positions: [S] int32 — slot s attends over global
    positions <= positions[s].  Returns [S, nq, hd] in q's dtype.
    `device` "cuda" launches the kernel, "cpu" runs the plain version;
    the tensors must lie there."""
    dev, quant = _prepare("paged_attention", device, q, k_pool, v_pool,
                          table, positions, k_scale, v_scale, quant)
    if q.dim() != 3:
        raise ValueError(f"expected q [S, nq, hd], got {tuple(q.shape)}")
    _check(q[:, None], k_pool, v_pool, table, positions, k_scale, v_scale,
           quant)
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    if dev.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, table, positions,
                                     scale, k_scale, v_scale, quant)
    out = _launch(q[:, None], k_pool, v_pool, table, positions, k_scale,
                  v_scale, quant, scale)
    counter = {"none": "launches", "int8": "int8_launches",
               "int4": "int4_launches"}[quant]
    build.count(globals(), counter, q.dtype)
    return out[:, 0]


def paged_verify(q, k_pool, v_pool, table, positions, *,
                 softmax_scale: Optional[float] = None, k_scale=None,
                 v_scale=None, quant: Optional[str] = None, device="cuda"):
    """Multi-query verify attention over paged KV (speculative
    decoding).  q: [S, C, nq, hd] — slot s's C = k + 1 query tokens sit
    at global positions positions[s]..positions[s] + C - 1, each
    attending causally over the slot's pages; pools, scales and table
    exactly as `paged_attention`.  Returns [S, C, nq, hd]."""
    dev, quant = _prepare("paged_verify", device, q, k_pool, v_pool,
                          table, positions, k_scale, v_scale, quant)
    _check(q, k_pool, v_pool, table, positions, k_scale, v_scale, quant)
    scale = softmax_scale if softmax_scale is not None \
        else q.shape[-1] ** -0.5
    if dev.type == "cpu":
        return paged_verify_plain(q, k_pool, v_pool, table, positions,
                                  scale, k_scale, v_scale, quant)
    out = _launch(q, k_pool, v_pool, table, positions, k_scale, v_scale,
                  quant, scale)
    build.count(globals(), "verify_launches", q.dtype)
    return out
