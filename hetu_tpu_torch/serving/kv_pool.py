"""Paged KV cache: a page-pool allocator with per-sequence page tables,
the port of `hetu_tpu/serving/kv_pool.py` (exact pages).

The serving engine's cache is a POOL of fixed-size pages

    k / v : [L, num_pages + 1, page_size, n_kv, hd]   (compute dtype)

plus, per decode slot, a page-table row [max_pages] of page ids that
maps a sequence position p to (table[p // page_size], p % page_size).
A finished sequence's pages go back on the free list and are recycled
by the next admission.

Pages are reference-counted for the radix prefix cache's copy-on-write
sharing (`serving/prefix_cache.py`): a freshly allocated page has one
owner; the cache and every slot sharing the page each hold one more,
and `free` releases one ownership — a page returns to the free list
when its last owner lets go.  Without sharing every count stays 0 or 1.
`gather` reads one slot's pages back as a dense cache (the prefix
cache's prime).

Page 0 is the reserved NULL page: never allocated; empty table entries
point at it and rows that are not decoding write into it.  The decode
kernel reads only positions <= each slot's position, so null-page
garbage never reaches attention.

The pool tensors are allocated with torch.zeros, never torch.empty:
a fresh allocation can hold NaN bit patterns, and although no kernel
reads a key past its slot's position, zeros keep a stray read finite.
`write_pages` updates the pool in place (the reference returned a new
pool and the engine donated the old one).

Quantized page modes (`quant="int8"|"int4"`): pages store blockwise
values plus one fp32 absmax scale per head vector (block = head_dim),

    k / v             : [L, num_pages + 1, page_size, n_kv, hd]  int8
                        (int4: uint8 [..., hd / 2], two nibbles a byte)
    k_scale / v_scale : [L, num_pages + 1, page_size, n_kv]      fp32

Pages of every mode are written by the fused page write
(`ops/cuda/kv_write.py`: `write_pages` here, one launch a prefill;
`models/generation`'s paged forwards, one launch a layer a step), which
quantizes as it writes: int8 one byte a value, int4 the reference's
nibble layout (even index in the LOW nibble, +8 offset), the bits of
`ops/quantization.quantize_heads`.  The paged-attention kernels
dequantize in registers; `gather` dequantizes by the scales (int8
through the blockwise dequantize kernel).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from hetu_tpu_torch.ops.cuda.kv_write import write_kv_pages
# quantize_heads: the reference's kv_pool holds the pair, and so does this
# module (the tests quantize pools through it)
from hetu_tpu_torch.ops.quantization import (dequantize_heads,  # noqa: F401
                                             quantize_heads)

#: bytes an element of each exact page mode takes
_ELEM_BYTES = {"fp32": 4.0, "bf16": 2.0, "fp16": 2.0}


def kv_bytes_per_token(num_layers: int, num_kv_heads: int, head_dim: int,
                       mode: str = "fp32") -> float:
    """Cache bytes one token position takes (K and V, every layer):
    int8 carries one fp32 scale per head vector, int4 half a byte a
    value plus the same scale."""
    elems = 2.0 * num_layers * num_kv_heads * head_dim
    if mode == "int8":
        return elems * (1.0 + 4.0 / head_dim)
    if mode == "int4":
        return elems * (0.5 + 4.0 / head_dim)
    try:
        return elems * _ELEM_BYTES[mode]
    except KeyError:
        raise ValueError(f"unknown kv mode {mode!r}; "
                         f"known: {sorted(_ELEM_BYTES)} + ['int8', 'int4']")


class PagePool:
    """Host-side allocator + device-side page tensors.

    num_pages counts USABLE pages; one extra null page (index 0) is
    added on top, so the tensors hold num_pages + 1 pages."""

    NULL_PAGE = 0

    def __init__(self, *, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32,
                 quant: str = "none", device="cuda"):
        if quant not in ("none", "int8", "int4"):
            raise ValueError(f"kv quant mode {quant!r} invalid; "
                             "choices: ('none', 'int8', 'int4')")
        if quant == "int4" and head_dim % 2:
            raise ValueError(f"int4 pages need an even head_dim, "
                             f"got {head_dim}")
        if num_pages < 1:
            raise ValueError("need at least one usable page")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        self.quant = quant
        #: payload bit width of quantized pages
        self.quant_bits = 4 if quant == "int4" else 8
        shape = (num_layers, num_pages + 1, page_size, num_kv_heads,
                 head_dim)
        self.k_scale = self.v_scale = None
        if quant == "none":
            self.k = torch.zeros(shape, dtype=dtype, device=device)
            self.v = torch.zeros(shape, dtype=dtype, device=device)
        else:
            pshape, ptype = shape, torch.int8
            if quant == "int4":
                pshape, ptype = shape[:-1] + (head_dim // 2,), torch.uint8
            self.k = torch.zeros(pshape, dtype=ptype, device=device)
            self.v = torch.zeros(pshape, dtype=ptype, device=device)
            self.k_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
            self.v_scale = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        # LIFO free list: recently freed pages are reused first (their
        # garbage is overwritten by the next prefill/decode write before
        # any read can see it)
        self._free: List[int] = list(range(num_pages, 0, -1))
        # copy-on-write reference counts: one per owner (the slot that
        # allocated the page, each slot sharing it, the prefix cache)
        self.refcount = np.zeros(num_pages + 1, np.int64)
        self.allocs = 0
        self.frees = 0

    # ---------------------------------------------------------- allocator
    def pages_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.page_size))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.used_count / self.num_pages

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages off the free list (refcount 1 each), or None (the
        caller queues) when the pool cannot satisfy the reservation."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        self.allocs += n
        return pages

    def incref(self, pages: List[int]):
        """Add one owner to each live page (prefix-cache sharing)."""
        for p in pages:
            if not (0 < p <= self.num_pages):
                raise ValueError(f"incref of invalid page id {p}")
            if self.refcount[p] < 1:
                raise ValueError(f"incref of free page {p}")
        for p in pages:     # one at a time: a page may repeat
            self.refcount[p] += 1

    def free(self, pages: List[int]):
        """Release one ownership of each page (decref); a page whose
        last owner released it returns to the free list."""
        for p in pages:
            if not (0 < p <= self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if self.refcount[p] < 1 or p in self._free:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                self.frees += 1

    # ------------------------------------------------------- device ops
    def gather(self, pages_row: np.ndarray):
        """One slot's dense cache from its pages: pages_row [mp] host
        page ids (null-padded) -> (k, v), each [L, 1, mp * page_size,
        n_kv, hd] in the pool's compute dtype, the layout of a prefill
        scratch.  Quantized pages dequantize by their per-(token, head)
        scales; null entries read page 0, whose rows no query of the
        prefill reads before it overwrites them."""
        idx = torch.as_tensor(np.asarray(pages_row), dtype=torch.long,
                              device=self.k.device)
        L, M = self.num_layers, idx.shape[0] * self.page_size
        out = []
        for pool, scale in ((self.k, self.k_scale), (self.v, self.v_scale)):
            g = pool[:, idx]                  # [L, mp, ps, n_kv, hd(/2)]
            if scale is not None:
                g = dequantize_heads(g, scale[:, idx], self.quant_bits,
                                     out_dtype=self.dtype)
            out.append(g.reshape(L, 1, M, self.num_kv_heads, self.head_dim))
        return out[0], out[1]

    def write_pages(self, pages_row: np.ndarray, ks: torch.Tensor,
                    vs: torch.Tensor):
        """Bulk-write a prefilled sequence's K/V into its pages, in
        place.  pages_row: [mp] host page ids, null-padded; ks/vs:
        [L, mp * page_size, n_kv, hd] (views of the dense scratch are
        read through their strides).  Only the real (non-null) entries
        are written: a scatter with repeated null-page indices would
        write page 0 several times in no defined order, and skipping
        them keeps the write deterministic and page 0 untouched.  One
        launch of the fused page write (`ops/cuda/kv_write.py`) for K
        and V of every layer; quantized pools quantize the real pages'
        rows only, the bits the reference's quantize of the whole
        scratch gives them."""
        pages_row = np.asarray(pages_row)
        mp = pages_row.shape[0]
        if ks.shape[1] != mp * self.page_size:
            raise ValueError(f"K/V hold {ks.shape[1]} positions, the row "
                             f"covers {mp} pages of {self.page_size}")
        row = torch.as_tensor(pages_row, dtype=torch.int32,
                              device=self.k.device)
        write_kv_pages(self.k, self.v, row, ks, vs, k_scale=self.k_scale,
                       v_scale=self.v_scale, quant=self.quant,
                       device=self.k.device)
