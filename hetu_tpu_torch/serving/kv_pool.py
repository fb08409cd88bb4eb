"""Paged KV cache: a page-pool allocator with per-sequence page tables,
the port of `hetu_tpu/serving/kv_pool.py` (exact pages).

The serving engine's cache is a POOL of fixed-size pages

    k / v : [L, num_pages + 1, page_size, n_kv, hd]   (compute dtype)

plus, per decode slot, a page-table row [max_pages] of page ids that
maps a sequence position p to (table[p // page_size], p % page_size).
A finished sequence's pages go back on the free list and are recycled
by the next admission.

Page 0 is the reserved NULL page: never allocated; empty table entries
point at it and rows that are not decoding write into it.  The decode
kernel reads only positions <= each slot's position, so null-page
garbage never reaches attention.

The pool tensors are allocated with torch.zeros, never torch.empty:
a fresh allocation can hold NaN bit patterns, and although no kernel
reads a key past its slot's position, zeros keep a stray read finite.
`write_pages` updates the pool in place (the reference returned a new
pool and the engine donated the old one).

The int8/int4 page modes and the copy-on-write refcounts of the radix
prefix cache arrive with those features.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch


class PagePool:
    """Host-side allocator + device-side page tensors.

    num_pages counts USABLE pages; one extra null page (index 0) is
    added on top, so the tensors hold num_pages + 1 pages."""

    NULL_PAGE = 0

    def __init__(self, *, num_layers: int, num_pages: int, page_size: int,
                 num_kv_heads: int, head_dim: int, dtype=torch.float32,
                 device="cuda"):
        if num_pages < 1:
            raise ValueError("need at least one usable page")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.dtype = dtype
        shape = (num_layers, num_pages + 1, page_size, num_kv_heads,
                 head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        # LIFO free list: recently freed pages are reused first (their
        # garbage is overwritten by the next prefill/decode write before
        # any read can see it)
        self._free: List[int] = list(range(num_pages, 0, -1))
        self._live = set()
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
        """Pop n pages off the free list, or None (the caller queues)
        when the pool cannot satisfy the reservation."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._live.update(pages)
        self.allocs += n
        return pages

    def free(self, pages: List[int]):
        """Return pages to the free list."""
        for p in pages:
            if not (0 < p <= self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if p not in self._live:
                raise ValueError(f"double free of page {p}")
        for p in pages:
            self._live.discard(p)
            self._free.append(p)
            self.frees += 1

    def is_live(self, page: int) -> bool:
        return page in self._live

    # ------------------------------------------------------- device ops
    def write_pages(self, pages_row: np.ndarray, ks: torch.Tensor,
                    vs: torch.Tensor):
        """Bulk-write a prefilled sequence's K/V into its pages, in
        place.  pages_row: [mp] host page ids, null-padded; ks/vs:
        [L, mp * page_size, n_kv, hd].  Only the real (non-null) entries
        are written: a scatter with repeated null-page indices would
        write page 0 several times in no defined order, and skipping
        them keeps the write deterministic and page 0 untouched."""
        pages_row = np.asarray(pages_row)
        mp = pages_row.shape[0]
        if ks.shape[1] != mp * self.page_size:
            raise ValueError(f"K/V hold {ks.shape[1]} positions, the row "
                             f"covers {mp} pages of {self.page_size}")
        idx = np.flatnonzero(pages_row != self.NULL_PAGE)
        if idx.size == 0:
            return
        dst = torch.as_tensor(pages_row[idx], dtype=torch.long,
                              device=self.k.device)
        src = torch.as_tensor(idx, dtype=torch.long, device=self.k.device)
        paged = (self.num_layers, mp, self.page_size, self.num_kv_heads,
                 self.head_dim)
        for pool, x in ((self.k, ks), (self.v, vs)):
            pool[:, dst] = x.reshape(paged)[:, src].to(pool.dtype)
