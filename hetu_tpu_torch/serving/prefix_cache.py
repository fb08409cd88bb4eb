"""Radix prefix cache, copied from `hetu_tpu/serving/prefix_cache.py`
(host-only numpy): shared-prompt KV pages stay resident across requests.

Serving traffic is dominated by shared prefixes — the system prompt
every request carries, few-shot preambles, multi-turn histories.  This
module keeps their KV pages alive after the owning request finishes,
indexed by a radix tree over the token stream at page granularity:

* **Tree shape.**  Each edge holds exactly ``page_size`` tokens and the
  id of the pool page caching their K/V.  Matching a prompt walks the
  tree page block by page block; the matched chain is the resident
  prefix.  An edge matches wholly or not at all.

* **COW refcounts** (`serving/kv_pool.py`): every owner of a page — the
  cache itself and each live slot sharing it — holds one reference; a
  page frees when its last owner releases it.  Shared pages are never
  written by sharers: a page is cacheable only when the sequence has
  advanced past it, and an admitting request writes strictly above its
  shared prefix, so "copy"-on-write is allocate-fresh-for-the-suffix —
  no page is ever copied on the card.

* **Match cap.**  A hit covers at most the page-aligned prefix of
  ``plen - 1`` tokens: at least one prompt token always prefills, so
  the engine has last-position logits to emit the first token from.

* **Eviction.**  LRU over leaves (a parent's page is live context for
  every descendant).  The scheduler calls ``evict()`` when an
  admission's reservation comes up short, so cached pages are
  best-effort slack, never a reason to queue.

The device sees nothing of it but the page tables it already reads.
The engine attaches one with ``ServeConfig(prefix_cache=True)``
(``prefix_cache_pages`` caps its pages; 0 = bounded by pool pressure
only).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class _Node:
    """One radix-tree node; the edge INTO it carries `block` (a
    page_size token tuple) and `page` (the pool page caching it)."""

    __slots__ = ("block", "page", "children", "parent", "last_used")

    def __init__(self, block: Optional[Tuple[int, ...]],
                 page: Optional[int], parent: Optional["_Node"]):
        self.block = block
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0.0


class RadixPrefixCache:
    """Token-prefix -> resident-page-chain index over a PagePool."""

    def __init__(self, pool, *, max_pages: int = 0):
        self.pool = pool
        self.page_size = pool.page_size
        #: cache page budget; 0 = bounded only by pool pressure (the
        #: scheduler evicts on demand when reservations come up short)
        self.max_pages = max_pages
        self.root = _Node(None, None, None)
        self._pages = 0         # pages the cache currently owns
        self._clock = 0.0       # virtual LRU clock (monotonic)
        self.hits = 0
        self.misses = 0
        self.shared_tokens_total = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # ------------------------------------------------------------ sizing
    @property
    def num_pages(self) -> int:
        return self._pages

    def _blocks(self, tokens: np.ndarray, limit: int
                ) -> List[Tuple[int, ...]]:
        """Page-granular blocks of `tokens[:limit]` (full pages only)."""
        ps = self.page_size
        n = limit // ps
        return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])
                for i in range(n)]

    # ------------------------------------------------------------- match
    def match(self, prompt: np.ndarray, now: float = 0.0
              ) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of `prompt`, capped at
        ``plen - 1`` tokens (at least one token must prefill).  Returns
        (shared_tokens, shared_pages); the pages are NOT ref'd — the
        caller (scheduler admission) increfs what it takes."""
        self._clock = max(self._clock, now)
        plen = int(len(prompt))
        node, pages = self.root, []
        for block in self._blocks(prompt, plen - 1):
            child = node.children.get(block)
            if child is None:
                break
            child.last_used = self._clock
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
            self.shared_tokens_total += len(pages) * self.page_size
        else:
            self.misses += 1
        return len(pages) * self.page_size, pages

    # ------------------------------------------------------------ insert
    def insert(self, prompt: np.ndarray, pages: List[int],
               now: float = 0.0) -> int:
        """Index a just-prefilled prompt: walk the tree along its full
        page blocks, and for each block not yet cached take ownership
        of the request's corresponding page (incref — the request keeps
        its own reference and releases it normally on finish).  Blocks
        already cached keep the EXISTING page (the request's duplicate
        stays private to it).  Returns pages newly adopted.

        Only blocks the sequence has advanced past are insertable: the
        cap at ``plen - 1`` matches `match`, so a block is cached only
        when no live writer can ever touch it again (the COW
        invariant).  Respects ``max_pages`` by evicting LRU leaves
        first; blocks that still do not fit are simply not cached."""
        self._clock = max(self._clock, now)
        plen = int(len(prompt))
        node, adopted = self.root, 0
        for i, block in enumerate(self._blocks(prompt, plen - 1)):
            child = node.children.get(block)
            if child is None:
                if self.max_pages and self._pages >= self.max_pages:
                    if self.evict(1, protect=node) < 1:
                        break
                page = pages[i]
                self.pool.incref([page])
                child = _Node(block, page, node)
                node.children[block] = child
                self._pages += 1
                self.inserted_pages += 1
                adopted += 1
            child.last_used = self._clock
            node = child
        return adopted

    # ---------------------------------------------------------- eviction
    def _leaves(self) -> List[_Node]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root and not n.children:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def evict(self, n_pages: int, protect: Optional[_Node] = None, *,
              require_free: bool = False) -> int:
        """Drop up to `n_pages` LRU leaf entries, releasing the cache's
        reference on each.  Evicting a leaf may expose its parent as
        the next leaf — the loop re-walks until satisfied or the tree
        is spent.

        ``require_free=False`` (the insert-budget path) counts cache
        ENTRIES released — the goal is bounding the cache's footprint.
        ``require_free=True`` (the scheduler's page-pressure path)
        counts pages actually RETURNED to the free list, and only
        considers leaves the cache solely owns (refcount 1): evicting
        a leaf a live slot still shares frees nothing now and burns
        its future hit value for zero benefit.  Returns the count in
        the requested currency."""
        released = 0
        while released < n_pages:
            leaves = [lf for lf in self._leaves() if lf is not protect]
            if require_free:
                leaves = [lf for lf in leaves
                          if self.pool.refcount[lf.page] == 1]
            if not leaves:
                break
            victim = min(leaves, key=lambda lf: lf.last_used)
            victim.parent.children.pop(victim.block)
            free0 = self.pool.free_count
            self.pool.free([victim.page])
            self._pages -= 1
            self.evicted_pages += 1
            released += (self.pool.free_count - free0 if require_free
                         else 1)
        return released

    def clear(self):
        self.evict(self._pages + 1)

    # --------------------------------------------------------- integrity
    def owned_pages(self) -> List[int]:
        """Every page the cache holds a reference on (one entry per
        tree node) — the scheduler's `check_invariants` counts these
        against the pool refcounts."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            if n is not self.root:
                out.append(n.page)
            stack.extend(n.children.values())
        return out

    def stats(self) -> Dict[str, float]:
        lookups = self.hits + self.misses
        return {
            "pages": self._pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "shared_tokens": self.shared_tokens_total,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }
