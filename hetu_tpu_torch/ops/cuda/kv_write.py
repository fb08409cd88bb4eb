"""The fused KV page write: wrappers, plain versions and launch counters.

Replaces the serving pool's page writes over
`hetu_tpu/ops/pallas/quant.py` `quantize_blockwise_pallas` (the int8
pages' quantize): `hetu_tpu/serving/kv_pool.py` `write_token`,
`write_tokens` and `write_pages`, each a `quantize_heads` (the Pallas
quantize for int8, `ops/quantization.quantize_int4` for int4) and two
scatters a tensor.  Kernel: `csrc/kv_write.cu`, bound by bytes on the
H100 (see its header), on the head-vector quantize of `csrc/quant.cuh`
that the flat `quantize_blockwise` shares.

  * `write_kv_tokens` — one layer of a paged serving step: a token
    block's K and V [S, C, n_kv, hd] (fp32, bf16 or fp16) into the
    layer's pages at `token_block_pages`' slots, in one launch (exact
    pages cast to the pool's type; int8 or int4 payloads with their fp32
    scales, of the values widened exactly to fp32).  K and
    V are read in place through their strides (views of the fused QKV
    projection need no copy); the table and positions stay on the
    device.
  * `write_kv_pages` — a prefill's K and V scratch, all layers, into the
    non-null pages of a page row on the device, in one launch.

Neither reads a host value, so a CUDA graph can capture them.  The
plain versions are the port's earlier page writes in PyTorch alone: the
slot arithmetic, then a scatter of the cast values (exact pages) or of
the head vectors' quantize (`quantize_heads_plain`, the bits of
`ops/quantization.quantize_heads`) with its scales; the plain page
write quantizes only the real pages' rows (the same bits, a head vector
at a time).
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda.paged_attention import resolve_quant
from hetu_tpu_torch.ops.cuda.quant import quantize_blockwise_plain
from hetu_tpu_torch.ops.quantization import quantize_heads

#: write_kv_tokens kernel launches (the plain versions never count)
launches = 0
#: write_kv_pages kernel launches
pages_launches = 0
#: each counter's launches by the K and V arm (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "pages_launches")

#: the kernel's page modes (csrc/kv_write.cu KvMode): exact by pool type
_MODES = {("none", torch.float32): 0, ("none", torch.bfloat16): 1,
          ("none", torch.float16): 2, ("int8", torch.int8): 8,
          ("int4", torch.uint8): 4}
#: the kernel's input types (csrc/kv_write.cu KvIn)
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_FLOATS = tuple(_IN_DTYPES)
_PAYLOAD = {"int8": torch.int8, "int4": torch.uint8}
#: the largest head dim the kernel takes (a head vector in one warp)
MAX_HEAD_DIM = 256
#: the page write's grid (csrc/kv_write.cu KV_MAX_ENTRIES): row entries,
#: and 2 x layers
MAX_GRID_ENTRIES = 65535
_TOKENS_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                    + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                    + [ctypes.c_void_p])
_PAGES_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {"hetu_write_kv_tokens": _TOKENS_ARGTYPES,
               "hetu_write_kv_pages": _PAGES_ARGTYPES}


# ------------------------------------------------------- plain versions
def token_block_pages(table, positions, C: int, ps: int):
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


def quantize_heads_plain(x, bits: int):
    """`ops/quantization.quantize_heads` in PyTorch on any device: [...,
    hd] -> (int8 [..., hd] or nibbles uint8 [..., hd / 2], fp32 scales
    [...]), one absmax scale a head vector."""
    if bits == 4:            # plain PyTorch on every device already
        return quantize_heads(x, 4)
    q, s = quantize_blockwise_plain(x, x.shape[-1], bits)
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _scatter(pool, scale, idx, t, bits: int):
    """pool[idx] = t cast to the pool's type (exact pages, scale None),
    or its per-head-vector quantize and scale (the pool's own
    quantizer's bits, so pool contents agree whichever program wrote
    them)."""
    if scale is None:
        pool[idx] = t.to(pool.dtype)
        return
    q, s = quantize_heads_plain(t, bits)
    pool[idx] = q
    scale[idx] = s


def write_kv_tokens_plain(k_pool, v_pool, table, positions, k, v,
                          k_scale=None, v_scale=None, quant="none"):
    """The token-block page write in PyTorch: the slots of
    `token_block_pages`, then one scatter of K and one of V (and of
    their scales)."""
    bits = 4 if quant == "int4" else 8
    page, offset = token_block_pages(table, positions, k.shape[1],
                                     k_pool.shape[1])
    _scatter(k_pool, k_scale, (page, offset), k, bits)
    _scatter(v_pool, v_scale, (page, offset), v, bits)


def write_kv_pages_plain(k_pool, v_pool, pages_row, ks, vs, k_scale=None,
                         v_scale=None, quant="none"):
    """The prefill page write in PyTorch: the scratch's rows of each
    non-null entry of the page row into that page, every layer (only
    those rows are quantized; the bits are a head vector's own)."""
    bits = 4 if quant == "int4" else 8
    L, _, ps, n_kv = k_pool.shape[:4]
    mp = pages_row.shape[0]
    src = torch.nonzero(pages_row).reshape(-1)
    dst = pages_row[src].long()
    for pool, scale, x in ((k_pool, k_scale, ks), (v_pool, v_scale, vs)):
        x = x.reshape(L, mp, ps, n_kv, x.shape[-1])[:, src]
        _scatter(pool, scale, (slice(None), dst), x, bits)


# ------------------------------------------------------------ wrappers
def _check_pools(name, k_pool, v_pool, k_scale, v_scale, quant, hd,
                 lead: int):
    """The pools a mode takes: payload [(L,) P, ps, n_kv, hd] of the
    exact type or hd (int8) / hd / 2 (int4) bytes, scales [(L,) P, ps,
    n_kv] fp32."""
    hd_p = hd // 2 if quant == "int4" else hd
    if k_pool.dim() != lead + 4 or k_pool.shape != v_pool.shape or \
            k_pool.shape[-1] != hd_p:
        raise ValueError(f"{name}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not hold head vectors "
                         f"of {hd} in page mode {quant!r}")
    if quant == "none":
        if k_pool.dtype not in _FLOATS or v_pool.dtype != k_pool.dtype:
            raise ValueError(f"{name}: exact pages are fp32, bf16 or fp16, "
                             f"got {k_pool.dtype} / {v_pool.dtype}")
        return
    if k_pool.dtype != _PAYLOAD[quant] or v_pool.dtype != _PAYLOAD[quant]:
        raise ValueError(f"{name}: {quant} pages hold {_PAYLOAD[quant]}, "
                         f"got {k_pool.dtype} / {v_pool.dtype}")
    for s in (k_scale, v_scale):
        if s.dtype != torch.float32 or s.shape != k_pool.shape[:-1]:
            raise ValueError(f"{name}: scales must be fp32 "
                             f"{tuple(k_pool.shape[:-1])}, got {s.dtype} "
                             f"{tuple(s.shape)}")


def _check_kernel_inputs(name, hd, tensors, pools):
    """What the kernel takes: fp32, bf16 or fp16 head vectors of 16-byte
    chunks, at most MAX_HEAD_DIM, unit-stride head dims and 16-byte
    aligned bases and strides; contiguous pools on 16-byte boundaries."""
    dtype = tensors[0].dtype
    if dtype not in _FLOATS or any(t.dtype != dtype for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes fp32, bf16 or "
                         f"fp16 K and V of one type, got "
                         f"{[str(t.dtype) for t in tensors]}")
    esize = tensors[0].element_size()
    if (hd * esize) % 16 or hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dims of "
                         f"16-byte chunks up to {MAX_HEAD_DIM}, got {hd} "
                         f"{dtype}")
    for t in tensors:
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                (s * esize) % 16 for s in _strides(t)):
            raise ValueError(f"{name}: K and V need a unit-stride head dim "
                             f"and 16-byte aligned bases and strides, got "
                             f"strides {t.stride()}")
    for p in pools:
        if p is not None and (not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"{name}: pools and scales must be contiguous "
                             "on 16-byte boundaries")


def _strides(t):
    """The element strides of t's three leading dims, 0 for a dim of size
    1 (never stepped: a view's size-1 dim may carry any stride)."""
    return tuple(0 if n == 1 else st
                 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _launch_args(quant, pool, k):
    """(K and V's type code, the page mode) as the kernel numbers them."""
    return _IN_DTYPES[k.dtype], _MODES[(quant, pool.dtype)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def write_kv_tokens(k_pool, v_pool, table, positions, k, v, *,
                    k_scale=None, v_scale=None, quant=None, device="cuda"):
    """Write a token block's K and V [S, C, n_kv, hd] into ONE layer's
    pages [P, ps, n_kv, hd] (int4: uint8 [..., hd / 2]; quantized pools
    pass their fp32 scales [P, ps, n_kv]) in place: token i of slot s at
    positions[s] + i goes to page table[s, (positions[s] + i) // ps]
    (the null page 0 past the row) at offset (positions[s] + i) % ps.
    table [S, mp] int32, positions [S] int32, both on the device.
    `device` "cuda" launches the kernel (fp32, bf16 or fp16 K and V read
    through their strides), "cpu" runs the plain version; the tensors
    must lie there."""
    quant = resolve_quant(quant, k_scale, v_scale)
    scales = () if k_scale is None else (k_scale, v_scale)
    dev = build.check_device("write_kv_tokens", device, k_pool, v_pool,
                             table, positions, k, v, *scales)
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"write_kv_tokens: K and V must be [S, C, n_kv, "
                         f"hd] alike, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    S, C, n_kv, hd = k.shape
    _check_pools("write_kv_tokens", k_pool, v_pool, k_scale, v_scale, quant,
                 hd, 0)
    P, ps = k_pool.shape[:2]
    if k_pool.shape[2] != n_kv or table.dim() != 2 or table.shape[0] != S \
            or tuple(positions.shape) != (S,):
        raise ValueError(f"write_kv_tokens: K/V {tuple(k.shape)}, pools "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(table.shape)} and positions "
                         f"{tuple(positions.shape)} disagree")
    if dev.type == "cpu":
        write_kv_tokens_plain(k_pool, v_pool, table, positions, k, v,
                              k_scale, v_scale, quant)
        return
    if table.dtype != torch.int32 or positions.dtype != torch.int32 or \
            not table.is_contiguous() or not positions.is_contiguous():
        raise ValueError("write_kv_tokens: the CUDA kernel takes a "
                         "contiguous int32 table and positions")
    if 2 * S * C * n_kv >= 2 ** 31:
        raise ValueError(f"write_kv_tokens: {2 * S * C * n_kv} head vectors "
                         "exceed the kernel's grid")
    _check_kernel_inputs("write_kv_tokens", hd, (k, v),
                         (k_pool, v_pool, k_scale, v_scale))
    in_dtype, mode = _launch_args(quant, k_pool, k)
    with torch.cuda.device(k.device):
        err = build.bind("kv_write", "hetu_write_kv_tokens",
                         _TOKENS_ARGTYPES)(
            k.data_ptr(), v.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _ptr(k_scale), _ptr(v_scale), table.data_ptr(),
            positions.data_ptr(), S, C, n_kv, hd, ps, table.shape[1],
            *_strides(k), *_strides(v), in_dtype, mode,
            torch.cuda.current_stream(k.device).cuda_stream)
    build.check_launch(err, "write_kv_tokens")
    build.count(globals(), "launches", k.dtype)


def write_kv_pages(k_pool, v_pool, pages_row, ks, vs, *, k_scale=None,
                   v_scale=None, quant=None, device="cuda"):
    """Write a prefill's K and V scratch ks / vs [L, mp * ps, n_kv, hd]
    (any strides with a unit-stride head dim: `cache[:, 0]` of a dense
    [L, 1, M, n_kv, hd] cache) into the pages of pages_row [mp] (int32
    page ids on the device; null entries skipped) of the pools [L, P,
    ps, n_kv, hd] (int4: uint8 [..., hd / 2]; quantized pools pass their
    fp32 scales [L, P, ps, n_kv]), every layer, in place.  `device`
    "cuda" launches the kernel, "cpu" runs the plain version; the
    tensors must lie there."""
    quant = resolve_quant(quant, k_scale, v_scale)
    scales = () if k_scale is None else (k_scale, v_scale)
    dev = build.check_device("write_kv_pages", device, k_pool, v_pool,
                             pages_row, ks, vs, *scales)
    if ks.dim() != 4 or ks.shape != vs.shape:
        raise ValueError(f"write_kv_pages: K and V must be [L, M, n_kv, hd] "
                         f"alike, got {tuple(ks.shape)} / {tuple(vs.shape)}")
    L, M, n_kv, hd = ks.shape
    _check_pools("write_kv_pages", k_pool, v_pool, k_scale, v_scale, quant,
                 hd, 1)
    P, ps = k_pool.shape[1:3]
    mp = pages_row.shape[0] if pages_row.dim() == 1 else -1
    if k_pool.shape[0] != L or k_pool.shape[3] != n_kv or M != mp * ps:
        raise ValueError(f"write_kv_pages: K/V {tuple(ks.shape)}, pools "
                         f"{tuple(k_pool.shape)} and a page row of "
                         f"{tuple(pages_row.shape)} disagree (M must be "
                         f"mp * page_size)")
    if dev.type == "cpu":
        write_kv_pages_plain(k_pool, v_pool, pages_row, ks, vs, k_scale,
                             v_scale, quant)
        return
    if pages_row.dtype != torch.int32 or not pages_row.is_contiguous():
        raise ValueError("write_kv_pages: the CUDA kernel takes a "
                         "contiguous int32 page row")
    if mp > MAX_GRID_ENTRIES or 2 * L > MAX_GRID_ENTRIES:
        raise ValueError(f"write_kv_pages: {mp} row entries and 2 x {L} "
                         f"layers must each be at most {MAX_GRID_ENTRIES} "
                         "(the kernel's grid)")
    _check_kernel_inputs("write_kv_pages", hd, (ks, vs),
                         (k_pool, v_pool, k_scale, v_scale))
    in_dtype, mode = _launch_args(quant, k_pool, ks)
    with torch.cuda.device(ks.device):
        err = build.bind("kv_write", "hetu_write_kv_pages", _PAGES_ARGTYPES)(
            ks.data_ptr(), vs.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
            pages_row.data_ptr(), L, P, mp, ps, n_kv, hd, *_strides(ks),
            *_strides(vs), in_dtype, mode,
            torch.cuda.current_stream(ks.device).cuda_stream)
    build.check_launch(err, "write_kv_pages")
    build.count(globals(), "pages_launches", ks.dtype)
