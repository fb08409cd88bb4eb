"""Continuous-batching scheduler: token-granular admission into fixed
decode slots, copied from `hetu_tpu/serving/scheduler.py` (host-only
code).

The decode step runs over `num_slots` batch rows; the scheduler keeps
those rows full.  A sequence is admitted the moment a slot AND its full
page reservation are free (reserve-on-admit: prompt + max_new_tokens
pages up front, so a running sequence never runs out of pages
mid-flight), evicted the step it finishes, and its pages recycled
through the pool's free list.  Requests join and leave the batch at
token boundaries.

All state here is host-side Python/numpy — the device only sees the
[slots, max_pages] int32 page table and the per-slot position vector.
`check_invariants()` is the correctness contract: no two live slots
share a page, live + free partition the pool, table rows mirror the
slots' page lists.

The prefix-cache, quota, preemption, failover and disaggregation
branches of the reference arrive with those features.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

import numpy as np

from hetu_tpu_torch.serving.kv_pool import PagePool
from hetu_tpu_torch.serving.request import Request, RequestStats


@dataclass
class SlotState:
    """One live decode slot.  A freshly admitted slot spends its first
    engine steps PREFILLING (one chunk per step); it joins the decode
    batch when the last chunk lands."""
    request: Request
    pages: List[int]
    pos: int                     # next cache write position (= tokens cached)
    generated: List[int] = field(default_factory=list)
    stats: RequestStats = field(default_factory=RequestStats)
    prefilling: bool = False
    prefill_cache: object = None      # dense scratch (k, v) while prefilling
    chunks_done: int = 0


class Scheduler:
    """Slot + page bookkeeping for the continuous-batching engine."""

    def __init__(self, *, num_slots: int, pool: PagePool, max_len: int):
        if max_len % pool.page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {pool.page_size}")
        self.num_slots = num_slots
        self.pool = pool
        self.max_len = max_len
        self.max_pages = max_len // pool.page_size
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self.queue: Deque[Request] = collections.deque()
        # the device-facing view: row s = slot s's pages, null-padded
        self.page_table = np.zeros((num_slots, self.max_pages), np.int32)
        self.admitted = 0
        self.released = 0
        #: why the LAST failed admission attempt stalled: "no_slot" =
        #: every decode slot live, "no_pages" = the queue head's full
        #: reservation was short; None = no stall observed
        self.last_stall: Optional[str] = None

    # ----------------------------------------------------------- queue
    def submit(self, req: Request):
        """Queue a request.  Rejects loudly what could NEVER run (a
        permanently stalled queue must be a bug report, not a hang)."""
        if req.total_len > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens} exceeds max_len "
                f"{self.max_len}")
        if self.pool.pages_for(req.total_len) > self.pool.num_pages:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self.pool.pages_for(req.total_len)} pages but the pool "
                f"only has {self.pool.num_pages}")
        self.queue.append(req)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    # ----------------------------------------------------------- slots
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    @property
    def occupancy(self) -> float:
        return len(self.active_slots()) / self.num_slots

    # ------------------------------------------------------- admission
    def admit_next(self, now: float) -> Optional[Tuple[int, SlotState]]:
        """Admit the queue head if a slot and its full page reservation
        are available; FIFO — a large head request blocks the queue
        rather than starving (head-of-line policy)."""
        if not self.queue:
            self.last_stall = None
            return None
        free = self.free_slots()
        if not free:
            self.last_stall = "no_slot"
            return None
        req = self.queue[0]
        pages = self.pool.alloc(self.pool.pages_for(req.total_len))
        if pages is None:
            self.last_stall = "no_pages"
            return None
        self.last_stall = None
        self.queue.popleft()
        slot_idx = free[0]
        st = SlotState(request=req, pages=pages, pos=0,
                       stats=RequestStats(arrival_t=req.arrival_t,
                                          admit_t=now))
        self.slots[slot_idx] = st
        row = self.page_table[slot_idx]
        row[:] = PagePool.NULL_PAGE
        row[: len(pages)] = pages
        self.admitted += 1
        return slot_idx, st

    def release(self, slot_idx: int):
        """Evict a finished sequence: pages freed, table row re-pointed
        at the null page (the slot rides along in the decode batch as an
        inactive row; its writes dump into page 0)."""
        st = self.slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is not live")
        self.pool.free(st.pages)
        self.slots[slot_idx] = None
        self.page_table[slot_idx, :] = PagePool.NULL_PAGE
        self.released += 1

    # ------------------------------------------------------ invariants
    def check_invariants(self):
        """The memory-pool correctness contract:
        * no page is held by two slots, and no slot holds the null page,
        * live pages are exactly the pool's allocated set, and live +
          free pages partition the pool,
        * each table row mirrors its slot's page list, null-padded; an
          empty slot's row is all null,
        * every live position fits its reservation and max_len,
        * no rid is live in two slots or both queued and live."""
        owners = {}
        for i, st in enumerate(self.slots):
            if st is None:
                if (self.page_table[i] != PagePool.NULL_PAGE).any():
                    raise AssertionError(f"empty slot {i} has a non-null "
                                         "table row")
                continue
            for p in st.pages:
                if p == PagePool.NULL_PAGE:
                    raise AssertionError(f"slot {i} owns the null page")
                if p in owners:
                    raise AssertionError(f"page {p} aliased by slots "
                                         f"{owners[p]} and {i}")
                if not self.pool.is_live(p):
                    raise AssertionError(f"slot {i} holds page {p} the "
                                         "pool counts as free")
                owners[p] = i
            want = st.pages + [PagePool.NULL_PAGE] * (self.max_pages
                                                      - len(st.pages))
            if list(self.page_table[i]) != want:
                raise AssertionError(f"slot {i} table row "
                                     f"{list(self.page_table[i])} != "
                                     f"pages {want}")
            if st.pos > len(st.pages) * self.pool.page_size:
                raise AssertionError(
                    f"slot {i} position {st.pos} beyond its "
                    f"{len(st.pages)}-page reservation")
            if st.pos > self.max_len:
                raise AssertionError(f"slot {i} position {st.pos} beyond "
                                     f"max_len {self.max_len}")
        free = self.pool._free
        if len(set(free)) != len(free):
            raise AssertionError("duplicate pages on the free list")
        if PagePool.NULL_PAGE in free:
            raise AssertionError("null page on the free list")
        overlap = set(free) & set(owners)
        if overlap:
            raise AssertionError(f"pages both live and free: {overlap}")
        if len(owners) + len(free) != self.pool.num_pages:
            raise AssertionError(
                f"pool leak: {len(owners)} live + {len(free)} free != "
                f"{self.pool.num_pages} pages")
        slot_rids = [st.request.rid for st in self.slots if st is not None]
        if len(slot_rids) != len(set(slot_rids)):
            raise AssertionError(f"a request is live in two slots: "
                                 f"{slot_rids}")
        both = set(slot_rids) & {r.rid for r in self.queue}
        if both:
            raise AssertionError(
                f"requests both queued and live in a slot: {sorted(both)}")
