"""Flash attention, forward and backward: wrappers, plain versions,
launch counters and the autograd Function.

Replaces `hetu_tpu/ops/pallas/flash_attention.py`: `_fwd` (the forward
kernel, o and lse) and `_bwd` (the dq kernel and the dk/dv kernel), with
its public entries `flash_attention` and `flash_attention_with_lse`.
Kernels: `csrc/flash_attention.cu` (see its header for the design and
what bounds it on the H100).

What carries over unchanged is the semantics:

  * a static `BlockMask` — a hashable [nq][nk] grid of live tiles in
    units of (block_q, block_k) — decides which tiles exist at all: a
    dead tile is never computed, even where its elements would pass the
    position and segment masks.  `causal_block_mask`, `full_block_mask`,
    `block_mask_live_frac` and `fit_block` are the reference's host
    functions;
  * inside a live tile the mask is by explicit global positions
    (q_pos >= k_pos) and segment ids (equal), both [b, s] int32;
    defaults are kv positions arange(sk) and q positions arange(sq) +
    (sk - sq), the bottom-right alignment;
  * a row that sees nothing gives o = 0 and lse = NEG_INF (-1e30), and
    takes and gives zero gradients (the dense `attention` gives such a
    row a uniform softmax instead; causal self-attention has none);
  * `_bwd` returns dq, dk, dv in fp32 (a ring accumulates them); the
    autograd Function casts once to the inputs' dtypes.

What does not carry over is the TPU's geometry: the 1024 x 1024 default
blocks and the lane rules (head dim % 128, the 128 ladder of
`check_default_shapes`).  Here the default block is 128, the kernels'
own tile is 64 x 64 whatever the block, and the kernels take head dim 64
or 128, fp32, bf16 or fp16, hq a multiple of hkv; anything else raises.
The bf16 and fp16 kernels (forward, dq, dk/dv: one set of Hopper
kernels over the 16-bit element type) class each pair of tiles dead,
empty, full or partial (`tile_classes`): they compute neither a dead nor
an empty one, skip the element mask on a full one, and run one or more
64-row tiles a block (the launchers' rule in the CUDA source).

On CUDA tensors every entry launches its kernel or raises; the plain
versions (`flash_fwd_plain`, `flash_bwd_plain`) run for CPU tensors and
as the card checks' yardstick of correctness.  They expand the masks to
elements (live block and positions and segments), take the softmax in
fp32 and use the explicit backward formulas p = exp(s - lse),
ds = p * (dp - delta).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from hetu_tpu_torch.ops.cuda import build

NEG_INF = -1e30

#: default API block (the unit of a BlockMask) on this card
DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

#: forward kernel launches (the plain version never counts)
launches = 0
#: dq kernel launches
dq_launches = 0
#: dk/dv kernel launches
dkv_launches = 0
#: each counter's launches by arm (`build.arm_counts`)
arm_launches = build.arm_counts("launches", "dq_launches", "dkv_launches")

HEAD_DIMS = (64, 128)

BlockMask = Tuple[Tuple[bool, ...], ...]  # hashable [nq][nk] live-tile grid


# ------------------------------------------------ static block masks (host)
def causal_block_mask(sq: int, sk: int, block_q: int, block_k: int,
                      q_offset: Optional[int] = None,
                      k_offset: int = 0) -> BlockMask:
    """Live-tile grid for contiguous causal attention: tile (qi, ki) is
    live iff its last query position can see its first key position.
    `q_offset`/`k_offset` are the global positions of element 0 on each
    side (default: bottom-right alignment, q_offset = sk - sq +
    k_offset), which is how a ring step says "my queries against a
    rotated KV chunk"."""
    nq, nk = sq // block_q, sk // block_k
    if q_offset is None:
        q_offset = sk - sq + k_offset
    rows = []
    for qi in range(nq):
        q_max = q_offset + qi * block_q + block_q - 1
        rows.append(tuple(k_offset + ki * block_k <= q_max
                          for ki in range(nk)))
    return tuple(rows)


def full_block_mask(sq: int, sk: int, block_q: int, block_k: int) -> BlockMask:
    return tuple((True,) * (sk // block_k) for _ in range(sq // block_q))


def block_mask_live_frac(mask: BlockMask) -> float:
    """Fraction of tiles computed (diagnostics, cost models)."""
    flat = [x for row in mask for x in row]
    return sum(flat) / max(1, len(flat))


def fit_block(requested: int, s: int) -> int:
    """Largest block <= requested that divides s: down the 128-aligned
    ladder first, then any divisor (the one block-picking rule of the
    single-device entries and the ring)."""
    b = min(requested, s)
    while s % b:
        b = b - 128 if b > 128 else b - 1
        if b <= 0:
            raise ValueError(f"cannot block seq len {s}")
    return b


def _check_mask(mask: BlockMask, nq: int, nk: int):
    if len(mask) != nq or any(len(row) != nk for row in mask):
        raise ValueError(
            f"block_mask shape ({len(mask)},{len(mask[0]) if mask else 0}) "
            f"does not match the ({nq},{nk}) block grid; rebuild it with "
            f"the actual (possibly clamped) block sizes")


@functools.lru_cache(maxsize=256)
def _mask_tensor(mask: BlockMask, device: torch.device) -> torch.Tensor:
    """The [nq][nk] grid as a uint8 tensor on `device`, made once per
    static mask (the kernels index it; the plain versions expand it)."""
    return torch.tensor(mask, dtype=torch.uint8,
                        device=device).reshape(len(mask), -1)


# ------------------------------------------------------------ plain versions
def _element_mask(b, sq, sk, q_pos, k_pos, q_seg, k_seg, causal, block_q,
                  block_k, live: torch.Tensor) -> torch.Tensor:
    """[b, 1, 1, sq, sk] bool: live block and positions and segments."""
    m = live.bool().repeat_interleave(block_q, 0).repeat_interleave(
        block_k, 1)[None].expand(b, sq, sk)
    if causal:
        m = m & (q_pos[:, :, None] >= k_pos[:, None, :])
    if q_seg is not None:
        m = m & (q_seg[:, :, None] == k_seg[:, None, :])
    return m[:, None, None]


#: the kernels' own tile: 64 rows a side, `tile_at` in the CUDA source
TILE = 64
#: classes of a (q tile, k tile) pair (`tile_classes`)
DEAD, PARTIAL, FULL, EMPTY = 0, 1, 2, 3


def _tiles(block: int, n_blocks: int):
    """(API block, first row, rows) of each kernel tile along one side:
    an API block holds ceil(block / 64) tiles, the last one ragged."""
    per = -(-block // TILE)
    for t in range(n_blocks * per):
        blk, sub = divmod(t, per)
        yield blk, blk * block + sub * TILE, min(TILE, block - sub * TILE)


def tile_classes(q_pos, k_pos, q_seg, k_seg, *, causal, block_q, block_k,
                 live: torch.Tensor) -> torch.Tensor:
    """[b, q tiles, k tiles] int8, the class of each pair of kernel
    tiles as the bf16 Hopper kernels decide it: DEAD where its API block
    is dead (never loaded nor computed).  Where both tiles have all 64
    rows: EMPTY where the mask is causal and max(q_pos of the q tile) <
    min(k_pos of the k tile) (every element masked: not computed, which
    gives the same bits); FULL where the mask is not causal or min(q_pos)
    >= max(k_pos), and segments are off or one segment id covers both
    tiles (no element mask is applied).  Else PARTIAL (the element mask
    applies).  Min and max run over the whole tile: positions need not be
    monotone."""
    b, nq, nk = q_pos.shape[0], live.shape[0], live.shape[1]
    q_tiles = list(_tiles(block_q, nq))
    k_tiles = list(_tiles(block_k, nk))
    out = torch.full((b, len(q_tiles), len(k_tiles)), PARTIAL,
                     dtype=torch.int8)

    def span(t, r0, rows):
        part = t[:, r0:r0 + rows]
        return part.amin(1), part.amax(1)
    for i, (qb, q0, qr) in enumerate(q_tiles):
        q_min, q_max = span(q_pos, q0, qr)
        qs_min, qs_max = span(q_seg, q0, qr) if q_seg is not None else (
            None, None)
        for j, (kb, k0, kr) in enumerate(k_tiles):
            if not live[qb, kb]:
                out[:, i, j] = DEAD
                continue
            if qr < TILE or kr < TILE:
                continue
            full = torch.ones(b, dtype=torch.bool)
            empty = torch.zeros(b, dtype=torch.bool)
            if causal:
                k_min, k_max = span(k_pos, k0, kr)
                empty = q_max < k_min
                full &= q_min >= k_max
            if q_seg is not None:
                ks_min, ks_max = span(k_seg, k0, kr)
                full &= (qs_min == qs_max) & (ks_min == ks_max) & (
                    qs_min == ks_min)
            out[:, i, j] = torch.where(empty, EMPTY, torch.where(
                full, FULL, PARTIAL)).to(torch.int8)
    return out


def _scores(q, k, mask, scale):
    """Masked scaled scores [b, hkv, group, sq, sk] in fp32; q comes
    grouped [b, hkv, group, sq, d], k stays [b, hkv, sk, d]."""
    s = torch.einsum("bkgqd,bksd->bkgqs", q, k) * scale
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def flash_fwd_plain(q, k, v, q_pos, k_pos, q_seg, k_seg, *, scale, causal,
                    block_q, block_k, live):
    """(o [b, hq, sq, d] in q's dtype, lse [b, hq, sq] fp32) for q
    [b, hq, sq, d], k/v [b, hkv, sk, d]; `live` is the [nq][nk] uint8
    block mask."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    mask = _element_mask(b, sq, sk, q_pos, k_pos, q_seg, k_seg, causal,
                         block_q, block_k, live)
    qg = q.float().reshape(b, hkv, hq // hkv, sq, d)
    s = _scores(qg, k.float(), mask, scale)
    m = s.amax(dim=-1, keepdim=True)
    # a row that sees nothing: exp(s - m) would be 1; shift the
    # reference point so p underflows to 0
    p = torch.exp(s - torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float()) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF),
                      m + torch.log(l_safe))
    return o.reshape(b, hq, sq, d).to(q.dtype), lse.reshape(b, hq, sq)


def flash_bwd_plain(q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg, *,
                    scale, causal, block_q, block_k, live):
    """(dq [b, hq, sq, d], dk, dv [b, hkv, sk, d]) in fp32 from the saved
    lse and delta = rowsum(do * o), both [b, hq, sq] fp32."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    mask = _element_mask(b, sq, sk, q_pos, k_pos, q_seg, k_seg, causal,
                         block_q, block_k, live)
    qg = q.float().reshape(b, hkv, g, sq, d)
    dog = do.float().reshape(b, hkv, g, sq, d)
    kf, vf = k.float(), v.float()
    lse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(_scores(qg, kf, mask, scale)
                  - lse.reshape(b, hkv, g, sq, 1))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    ds = p * (dp - delta.reshape(b, hkv, g, sq, 1))
    dq = scale * torch.einsum("bkgqs,bksd->bkgqd", ds, kf)
    dk = scale * torch.einsum("bkgqs,bkgqd->bksd", ds, qg)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    return dq.reshape(b, hq, sq, d), dk, dv


# -------------------------------------------------------------------- kernels
class _FlashArgs(ctypes.Structure):
    """`struct FlashArgs` of csrc/flash_attention.cu, field for field."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "lse", "dout", "delta", "dq", "dk", "dv",
            "q_pos", "k_pos", "q_seg", "k_seg", "live")]
        + [(f"{t}_{s}", ctypes.c_longlong)
           for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
           for s in ("sb", "sh", "ss")]
        + [(n, ctypes.c_longlong) for n in (
            "qpos_sb", "kpos_sb", "qseg_sb", "kseg_sb")]
        + [(n, ctypes.c_int) for n in (
            "b", "hq", "hkv", "sq", "sk", "block_q", "block_k", "nq", "nk",
            "causal")]
        + [("scale", ctypes.c_float)])


_ARGTYPES = [ctypes.POINTER(_FlashArgs), ctypes.c_int, ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {f"hetu_flash_{kernel}_{suffix}": _ARGTYPES
               for kernel in ("fwd", "bwd_dq", "bwd_dkv")
               for suffix in _SUFFIX.values()}


def _check(name, q, k, v, q_pos, k_pos, q_seg, k_seg, block_q, block_k,
           block_mask):
    """Shapes and types every entry takes; returns the block mask."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name} takes q [b, hq, sq, d] and k, v "
                         f"[b, hkv, sk, d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not match (hq must divide "
                         f"by hkv)")
    if q.dtype not in _SUFFIX or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes q, k, v of one dtype, fp32, bf16 or "
                         f"fp16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if sq % block_q or sk % block_k:
        raise ValueError(f"seq lens ({sq},{sk}) must divide by blocks "
                         f"({block_q},{block_k})")
    if q_pos is None or k_pos is None:
        raise ValueError(f"{name} needs q_pos and k_pos (the public entries "
                         f"fill in the defaults)")
    for label, t, s in (("q_pos", q_pos, sq), ("k_pos", k_pos, sk),
                        ("q_seg", q_seg, sq), ("k_seg", k_seg, sk)):
        if t is not None and (t.shape != (b, s) or t.dtype != torch.int32):
            raise ValueError(f"{name}: {label} must be int32 [{b}, {s}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if (q_seg is None) != (k_seg is None):
        raise ValueError(f"{name}: q_seg and k_seg come together")
    if block_mask is None:
        block_mask = full_block_mask(sq, sk, block_q, block_k)
    _check_mask(block_mask, sq // block_q, sk // block_k)
    return block_mask


def _strided(t: torch.Tensor) -> torch.Tensor:
    """`t` [b, h, s, d] as the kernels read it: unit stride along d and
    16-byte aligned rows (a copy only where a view cannot give that)."""
    ok = (t.stride(3) == 1 and t.data_ptr() % 16 == 0
          and all(t.stride(i) % 8 == 0 for i in range(3)))
    return t if ok else t.contiguous()


def _bhsd_empty(shape, dtype, device) -> torch.Tensor:
    """An empty [b, h, s, d] tensor laid out as [b, s, h, d], so the
    public entries' transpose back is a contiguous tensor."""
    b, h, s, d = shape
    return torch.empty((b, s, h, d), dtype=dtype,
                       device=device).transpose(1, 2)


def _int_row(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A [b, s] int32 tensor with unit stride along s (its batch stride
    may be 0, a broadcast)."""
    if t is None or t.stride(1) == 1:
        return t
    return t.contiguous()


def _launch(kernel: str, counter: str, d: int, dtype, device, tensors,
            ints, scale: float):
    """Fill a FlashArgs from {field: tensor or None} and launch."""
    args = _FlashArgs()
    for name, t in tensors.items():
        if t is None:
            continue
        setattr(args, name, t.data_ptr())
        prefix = {"dout": "do"}.get(name, name)
        if t.dim() == 4:
            for axis, s in enumerate(("sb", "sh", "ss")):
                setattr(args, f"{prefix}_{s}", t.stride(axis))
        elif name in ("q_pos", "k_pos", "q_seg", "k_seg"):
            setattr(args, name.replace("_", "") + "_sb", t.stride(0))
    for name, value in ints.items():
        setattr(args, name, value)
    args.scale = scale
    symbol = f"hetu_flash_{kernel}_{_SUFFIX[dtype]}"
    with torch.cuda.device(device):
        err = build.bind("flash_attention", symbol, _ARGTYPES)(
            ctypes.byref(args), d,
            torch.cuda.current_stream(device).cuda_stream)
    build.check_launch(err, f"flash_{kernel}")
    build.count(globals(), counter, dtype)


def _kernel_inputs(name, q, k, v, q_pos, k_pos, q_seg, k_seg, block_q,
                   block_k, block_mask, causal):
    """What every launch shares: the checked head dim, the tensors as
    the kernels read them and the integer fields."""
    b, hq, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head dim {HEAD_DIMS}, "
                         f"got {d}")
    tensors = dict(q=_strided(q), k=_strided(k), v=_strided(v),
                   q_pos=_int_row(q_pos), k_pos=_int_row(k_pos),
                   q_seg=_int_row(q_seg), k_seg=_int_row(k_seg),
                   live=_mask_tensor(block_mask, q.device))
    ints = dict(b=b, hq=hq, hkv=k.shape[1], sq=sq, sk=k.shape[2],
                block_q=block_q, block_k=block_k, nq=sq // block_q,
                nk=k.shape[2] // block_k, causal=int(bool(causal)))
    return d, tensors, ints


def _fwd(q, k, v, q_pos, k_pos, q_seg, k_seg, *, scale, causal, block_q,
         block_k, block_mask: Optional[BlockMask] = None, device="cuda"):
    """q [b, hq, sq, d]; k, v [b, hkv, sk, d]; positions and segments
    [b, s] int32 (segments may be None).  `block_mask` is a static
    live-tile grid in units of (block_q, block_k); dead tiles are never
    computed.  Returns (o [b, hq, sq, d] in q's dtype, lse [b, hq, sq]
    fp32).  `device` "cuda" launches the kernel, "cpu" runs the plain
    version; the tensors must lie there.  No autograd."""
    given = [t for t in (q, k, v, q_pos, k_pos, q_seg, k_seg)
             if t is not None]
    dev = build.check_device("flash_fwd", device, *given)
    block_mask = _check("flash_fwd", q, k, v, q_pos, k_pos, q_seg, k_seg,
                        block_q, block_k, block_mask)
    if dev.type == "cpu":
        return flash_fwd_plain(
            q, k, v, q_pos, k_pos, q_seg, k_seg, scale=scale, causal=causal,
            block_q=block_q, block_k=block_k,
            live=_mask_tensor(block_mask, q.device))
    d, tensors, ints = _kernel_inputs("flash_fwd", q, k, v, q_pos, k_pos,
                                      q_seg, k_seg, block_q, block_k,
                                      block_mask, causal)
    o = _bhsd_empty(q.shape, q.dtype, q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("fwd", "launches", d, q.dtype, q.device,
                dict(tensors, o=o, lse=lse), ints, scale)
    return o, lse


def _bwd_checked(name, device, q, k, v, lse, do, delta, q_pos, k_pos, q_seg,
                 k_seg, block_q, block_k, block_mask):
    """The backward entries' shared checks; returns (device, mask)."""
    given = [t for t in (q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg)
             if t is not None]
    dev = build.check_device(name, device, *given)
    block_mask = _check(name, q, k, v, q_pos, k_pos, q_seg, k_seg, block_q,
                        block_k, block_mask)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{name}: do {do.dtype} {tuple(do.shape)} must "
                         f"match q {q.dtype} {tuple(q.shape)}")
    for label, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name}: {label} must be fp32 "
                             f"{tuple(q.shape[:3])}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    return dev, block_mask


def _bwd_part(part, q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg, *,
              scale, causal, block_q, block_k, block_mask, device):
    """One backward kernel: `part` "dq" -> (dq,), "dkv" -> (dk, dv)."""
    name = f"flash_bwd_{part}"
    dev, block_mask = _bwd_checked(name, device, q, k, v, lse, do, delta,
                                   q_pos, k_pos, q_seg, k_seg, block_q,
                                   block_k, block_mask)
    if dev.type == "cpu":
        grads = flash_bwd_plain(
            q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg, scale=scale,
            causal=causal, block_q=block_q, block_k=block_k,
            live=_mask_tensor(block_mask, q.device))
        return grads[:1] if part == "dq" else grads[1:]
    d, tensors, ints = _kernel_inputs(name, q, k, v, q_pos, k_pos, q_seg,
                                      k_seg, block_q, block_k, block_mask,
                                      causal)
    tensors.update(dout=_strided(do), lse=lse.contiguous(),
                   delta=delta.contiguous())
    if part == "dq":
        out = dict(dq=_bhsd_empty(q.shape, torch.float32, q.device))
    else:
        out = dict(dk=_bhsd_empty(k.shape, torch.float32, q.device),
                   dv=_bhsd_empty(k.shape, torch.float32, q.device))
    if q.numel() and k.numel():
        _launch(f"bwd_{part}", f"{part}_launches", d, q.dtype, q.device,
                dict(tensors, **out), ints, scale)
    else:
        for t in out.values():
            t.zero_()
    return tuple(out.values())


def flash_bwd_dq(q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg, *,
                 scale, causal, block_q, block_k,
                 block_mask: Optional[BlockMask] = None, device="cuda"):
    """dq [b, hq, sq, d] in fp32 from the forward's inputs, its saved lse
    [b, hq, sq], the cotangent do of o and delta = rowsum(do * o): the
    dq kernel alone.  `device` as in `_fwd`."""
    return _bwd_part("dq", q, k, v, lse, do, delta, q_pos, k_pos, q_seg,
                     k_seg, scale=scale, causal=causal, block_q=block_q,
                     block_k=block_k, block_mask=block_mask,
                     device=device)[0]


def flash_bwd_dkv(q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg, *,
                  scale, causal, block_q, block_k,
                  block_mask: Optional[BlockMask] = None, device="cuda"):
    """(dk, dv) [b, hkv, sk, d] in fp32, each summed over its kv head's
    group of q heads: the dk/dv kernel alone.  Arguments as
    `flash_bwd_dq`."""
    return _bwd_part("dkv", q, k, v, lse, do, delta, q_pos, k_pos, q_seg,
                     k_seg, scale=scale, causal=causal, block_q=block_q,
                     block_k=block_k, block_mask=block_mask, device=device)


def _bwd(q, k, v, o, lse, do, q_pos, k_pos, q_seg, k_seg, *, scale, causal,
         block_q, block_k, block_mask: Optional[BlockMask] = None,
         delta=None, device="cuda"):
    """(dq [b, hq, sq, d], dk, dv [b, hkv, sk, d]) in fp32 from the
    forward's inputs, its saved o and lse, and the cotangent do of o.
    `delta` = rowsum(do * o) [b, hq, sq] fp32 may be passed in (it does
    not change over a ring's steps).  `device` as in `_fwd`."""
    if delta is None:
        if o.shape != do.shape:
            raise ValueError(f"flash_bwd: o {tuple(o.shape)} and do "
                             f"{tuple(do.shape)} must match")
        delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(scale=scale, causal=causal, block_q=block_q, block_k=block_k,
              block_mask=block_mask, device=device)
    args = (q, k, v, lse, do, delta, q_pos, k_pos, q_seg, k_seg)
    if torch.device(device).type == "cpu":     # one pass gives all three
        dev, mask = _bwd_checked("flash_bwd", device, *args, block_q,
                                 block_k, block_mask)
        return flash_bwd_plain(
            *args, scale=scale, causal=causal, block_q=block_q,
            block_k=block_k, live=_mask_tensor(mask, q.device))
    return (flash_bwd_dq(*args, **kw), *flash_bwd_dkv(*args, **kw))


# ----------------------------------------------------------------- public API
class _Flash(torch.autograd.Function):
    """o = flash(q, k, v) on [b, h, s, d]; saves q, k, v, o and lse; the
    backward launches the dq and the dk/dv kernels (the plain backward
    on the CPU) and casts their fp32 results once."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, q_seg, k_seg, scale, causal,
                block_q, block_k, block_mask, device):
        o, lse = _fwd(q, k, v, q_pos, k_pos, q_seg, k_seg, scale=scale,
                      causal=causal, block_q=block_q, block_k=block_k,
                      block_mask=block_mask, device=device)
        ctx.save_for_backward(q, k, v, o, lse, q_pos, k_pos, q_seg, k_seg)
        ctx.static = (scale, causal, block_q, block_k, block_mask, device)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_pos, k_pos, q_seg, k_seg = ctx.saved_tensors
        scale, causal, block_q, block_k, block_mask, device = ctx.static
        dq, dk, dv = _bwd(q, k, v, o, lse, do, q_pos, k_pos, q_seg, k_seg,
                          scale=scale, causal=causal, block_q=block_q,
                          block_k=block_k, block_mask=block_mask,
                          device=device)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)) + (None,) * 10


def _prepare(q, k, causal, segment_ids, kv_segment_ids, q_positions,
             kv_positions, softmax_scale, block_q, block_k, block_mask):
    """The public entries' shared front: fitted blocks, the default
    causal block mask, default positions, int32 masks."""
    b, sq, _, d = q.shape
    sk = k.shape[1]
    block_q, block_k = fit_block(block_q, sq), fit_block(block_k, sk)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    # contiguous positions on both sides: tiles above the diagonal are
    # dead, forward and backward
    if block_mask is None and causal and q_positions is None \
            and kv_positions is None:
        block_mask = causal_block_mask(sq, sk, block_q, block_k)
    if q_positions is None:
        # bottom-right alignment for sq != sk: the queries are the LAST
        # sq positions
        q_positions = (torch.arange(sq, dtype=torch.int32, device=q.device)
                       + (sk - sq)).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(sk, dtype=torch.int32,
                                    device=q.device).expand(b, sk)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    as_int = lambda t: None if t is None else t.to(torch.int32)
    return (as_int(q_positions), as_int(kv_positions), as_int(segment_ids),
            as_int(kv_segment_ids), scale, block_q, block_k, block_mask)


def flash_attention(q, k, v, *, causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    softmax_scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    block_mask: Optional[BlockMask] = None,
                    device="cuda") -> torch.Tensor:
    """Flash attention.  q [b, sq, hq, d]; k, v [b, sk, hkv, d] (hkv
    divides hq: GQA, no repeat is materialised).  segment_ids [b, s]:
    packed-batch ids; positions [b, s]: global positions for the causal
    mask (defaults: kv arange(sk), q arange(sq) + (sk - sq)).
    `block_mask` (a static [nq][nk] grid in units of the fitted blocks)
    overrides the set of computed tiles; by default causal attention
    over contiguous positions computes the tiles at or below the
    diagonal.  Returns [b, sq, hq, d].  Differentiable in q, k, v.
    `device` "cuda" launches the kernels, "cpu" runs the plain versions;
    the tensors must lie there."""
    q_pos, k_pos, q_seg, k_seg, scale, block_q, block_k, block_mask = \
        _prepare(q, k, causal, segment_ids, kv_segment_ids, q_positions,
                 kv_positions, softmax_scale, block_q, block_k, block_mask)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        o = _Flash.apply(qt, kt, vt, q_pos, k_pos, q_seg, k_seg, scale,
                         causal, block_q, block_k, block_mask, device)
    else:
        o, _ = _fwd(qt, kt, vt, q_pos, k_pos, q_seg, k_seg, scale=scale,
                    causal=causal, block_q=block_q, block_k=block_k,
                    block_mask=block_mask, device=device)
    return o.transpose(1, 2)


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             segment_ids=None, kv_segment_ids=None,
                             q_positions=None, kv_positions=None,
                             softmax_scale: Optional[float] = None,
                             block_q: int = DEFAULT_BLOCK_Q,
                             block_k: int = DEFAULT_BLOCK_K,
                             block_mask: Optional[BlockMask] = None,
                             device="cuda"):
    """Forward only: (o [b, sq, hq, d], lse [b, hq, sq]) for a ring's
    online-softmax merge; the ring layer differentiates."""
    q_pos, k_pos, q_seg, k_seg, scale, block_q, block_k, block_mask = \
        _prepare(q, k, causal, segment_ids, kv_segment_ids, q_positions,
                 kv_positions, softmax_scale, block_q, block_k, block_mask)
    o, lse = _fwd(*(t.transpose(1, 2) for t in (q, k, v)), q_pos, k_pos,
                  q_seg, k_seg, scale=scale, causal=causal, block_q=block_q,
                  block_k=block_k, block_mask=block_mask, device=device)
    return o.transpose(1, 2), lse


def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             segment_ids=None,
                             softmax_scale: Optional[float] = None,
                             block_q: int = DEFAULT_BLOCK_Q,
                             block_k: int = DEFAULT_BLOCK_K, device="cuda"):
    """The backward of `flash_attention` from a kept forward: (dq, dk,
    dv) in q, k and v's layout [b, s, h, d] and dtypes, given the
    forward's o [b, sq, hq, d] and lse [b, hq, sq] (from
    `flash_attention_with_lse`) and do, the cotangent of o.  The same
    kernels and casts as `flash_attention`'s own backward, so the same
    bits; the recompute policy "dots_attn" calls it (`ops.attention`)."""
    q_pos, k_pos, q_seg, k_seg, scale, block_q, block_k, block_mask = \
        _prepare(q, k, causal, segment_ids, None, None, None, softmax_scale,
                 block_q, block_k, None)
    qt, kt, vt, ot, dot = (t.transpose(1, 2) for t in (q, k, v, o, do))
    dq, dk, dv = _bwd(qt, kt, vt, ot, lse, dot, q_pos, k_pos, q_seg, k_seg,
                      scale=scale, causal=causal, block_q=block_q,
                      block_k=block_k, block_mask=block_mask, device=device)
    return tuple(d.to(t.dtype).transpose(1, 2)
                 for d, t in ((dq, q), (dk, k), (dv, v)))
