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

With a radix prefix cache attached (`serving/prefix_cache.py`), an
admission starts with its page-aligned shared prefix already resident:
the shared pages are ref'd (copy-on-write, never written by the slot)
and only the unshared suffix is reserved.

All state here is host-side Python/numpy — the device only sees the
[slots, max_pages] int32 page table and the per-slot position vector.
`check_invariants()` is the correctness contract: refcounts equal owner
counts, a page is shared only inside shared prefixes, live + free
partition the pool, table rows mirror the slots' page lists.

The policy branches: per-tenant quotas gate admission
(`quota_exceeded`), `admit_direct` admits a disaggregated shipment's
request without queueing, `preempt` / `requeue_lost` put a live request
back at the queue head (a higher-priority admission, a lost replica),
the shipment gate dedupes redelivered KV shipments before any page is
allocated, and `drop_queued` withdraws a queued request.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from hetu_tpu_torch.serving.kv_pool import PagePool
from hetu_tpu_torch.serving.request import Request, RequestStats, TenantQuota


@dataclass
class SlotState:
    """One live decode slot.  A freshly admitted slot spends its first
    engine steps PREFILLING (one chunk per step, interleaved with the
    decode batch — the engine drives these fields); it joins the decode
    batch when the last chunk lands.  ``shared_tokens`` > 0 means the
    leading pages of ``pages`` are radix-cache pages resident from an
    earlier request (serving/prefix_cache.py) — prefill starts at that
    boundary and those pages are never written by this slot."""
    request: Request
    pages: List[int]
    pos: int                     # next cache write position (= tokens cached)
    generated: List[int] = field(default_factory=list)
    stats: RequestStats = field(default_factory=RequestStats)
    prefilling: bool = False
    prefill_cache: object = None      # scratch KV carry while prefilling
    chunks_done: int = 0
    shared_tokens: int = 0
    admit_seq: int = 0                # admission order (preemption ties)


class Scheduler:
    """Slot + page bookkeeping for the continuous-batching engine.

    ``lookahead`` (speculative decoding, serving/spec_decode.py) widens
    every page reservation by k cache positions: a verify step writes
    draft K/V up to ``pos + k``, so reserve-on-admit must cover
    ``total_len + k`` for the no-mid-flight-out-of-pages guarantee to
    keep holding.  ``prefix_cache`` (serving/prefix_cache.py) lets an
    admission start with its page-aligned shared prefix already
    resident: the reservation shrinks to the unshared suffix and the
    shared pages are ref'd, not copied."""

    def __init__(self, *, num_slots: int, pool: PagePool, max_len: int,
                 prefix_cache=None, lookahead: int = 0,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 retry_budget: int = 0):
        if max_len % pool.page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {pool.page_size}")
        if lookahead < 0:
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self.num_slots = num_slots
        self.pool = pool
        self.max_len = max_len
        self.max_pages = max_len // pool.page_size
        self.prefix_cache = prefix_cache
        self.lookahead = lookahead
        #: per-tenant admission caps (HETU_TORCH_SERVE_QUOTAS); tenants
        #: absent from the dict are unlimited, {} / None = quota-free
        self.quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self.slots: List[Optional[SlotState]] = [None] * num_slots
        self.queue: Deque[Request] = collections.deque()
        # the device-facing view: row s = slot s's pages, null-padded
        self.page_table = np.zeros((num_slots, self.max_pages), np.int32)
        self.admitted = 0
        self.released = 0
        self.preempted = 0
        #: failover accounting (HETU_TORCH_SERVE_RETRY): how many times
        #: each rid re-entered the queue after a replica loss, and the
        #: budget check_invariants() holds every rid to (0 = no budget
        #: configured — requeue_lost is then never legal)
        self.retry_budget = retry_budget
        self.retries: Dict[int, int] = {}
        self.replica_requeues = 0
        #: disaggregated-shipment dedupe (docs/serving.md): seqs whose
        #: KV shipment was already adopted (a redelivery of any of them
        #: must NOT allocate — at-least-once delivery made idempotent),
        #: the per-rid apply history for live requests (popped by
        #: `ship_forget` at finish; check_invariants holds it dup-free),
        #: and how many deliveries the dedupe gate absorbed
        self.ship_seqs: set = set()
        self.ship_applied: Dict[int, List[int]] = {}
        self.ship_dedups = 0
        self._admit_seq = 0
        # live per-tenant usage, maintained at admit/release (the quota
        # check reads these instead of rescanning the slots each time);
        # check_invariants() recomputes them from scratch
        self.tenant_slots: Dict[str, int] = {}
        self.tenant_pages: Dict[str, int] = {}
        #: why the LAST failed admission attempt stalled (the
        #: reserve-on-admit attribution the flight recorder reads):
        #: "no_slot" = every decode slot live, "no_pages" = the queue
        #: head's full reservation was short, "quota_exceeded" = the
        #: head's tenant was over its cap; None = no stall observed
        self.last_stall: Optional[str] = None

    def _reserve_tokens(self, req: Request) -> int:
        """Cache positions an admission must cover: the worst-case
        sequence plus the spec-decode write lookahead."""
        return req.total_len + self.lookahead

    # ----------------------------------------------------------- queue
    def submit(self, req: Request):
        """Queue a request.  Rejects loudly what could NEVER run (a
        permanently stalled queue must be a bug report, not a hang)."""
        if self._reserve_tokens(req) > self.max_len:
            extra = (f" + spec lookahead {self.lookahead}"
                     if self.lookahead else "")
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new {req.max_new_tokens}{extra} exceeds max_len "
                f"{self.max_len}")
        if self.pool.pages_for(self._reserve_tokens(req)) \
                > self.pool.num_pages:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self.pool.pages_for(self._reserve_tokens(req))} pages "
                f"but the pool only has {self.pool.num_pages}")
        q = self.quotas.get(req.tenant)
        if q is not None and q.max_pages and \
                self.pool.pages_for(self._reserve_tokens(req)) > q.max_pages:
            raise ValueError(
                f"request {req.rid}: tenant {req.tenant!r} quota caps "
                f"pages at {q.max_pages} but the reservation alone needs "
                f"{self.pool.pages_for(self._reserve_tokens(req))} — it "
                "could never be admitted")
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
        rather than starving (head-of-line policy, documented limit).

        With a prefix cache attached, the head's page-aligned cached
        prefix admits ALREADY RESIDENT: its pages are ref-shared (COW —
        never written by this slot) and only the unshared suffix is
        freshly allocated.  A short allocation first asks the cache to
        evict LRU entries — cached pages are best-effort slack, never a
        reason to queue."""
        if not self.queue:
            self.last_stall = None
            return None
        free = self.free_slots()
        if not free:
            self.last_stall = "no_slot"
            return None
        req = self.queue[0]
        if not self._quota_admits(req):
            self.last_stall = "quota_exceeded"
            return None
        shared_tokens, shared_pages = 0, []
        if self.prefix_cache is not None:
            shared_tokens, shared_pages = self.prefix_cache.match(
                req.prompt, now)
            if shared_pages:
                # take the slot's reference BEFORE any eviction can
                # run: an unpinned matched chain is itself an
                # evictable LRU leaf, and evict-then-realloc would
                # hand a matched page back as this admission's "fresh"
                # suffix page — prefix and suffix silently aliased
                # onto one physical page (caught by the regression
                # test; released below if the admission still fails)
                self.pool.incref(shared_pages)
        need = self.pool.pages_for(self._reserve_tokens(req)) \
            - len(shared_pages)
        fresh = self.pool.alloc(need)
        if fresh is None and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.pool.free_count,
                                    require_free=True)
            fresh = self.pool.alloc(need)
        if fresh is None:
            if shared_pages:
                self.pool.free(shared_pages)    # unpin the match
            self.last_stall = "no_pages"
            return None
        pages = list(shared_pages) + fresh
        self.last_stall = None
        self.queue.popleft()
        slot_idx = free[0]
        self._admit_seq += 1
        st = SlotState(request=req, pages=pages, pos=0,
                       stats=RequestStats(arrival_t=req.arrival_t,
                                          admit_t=now),
                       shared_tokens=shared_tokens,
                       admit_seq=self._admit_seq)
        st.stats.shared_prefix_tokens = shared_tokens
        self.slots[slot_idx] = st
        row = self.page_table[slot_idx]
        row[:] = PagePool.NULL_PAGE
        row[: len(pages)] = pages
        self.admitted += 1
        t = req.tenant
        self.tenant_slots[t] = self.tenant_slots.get(t, 0) + 1
        self.tenant_pages[t] = self.tenant_pages.get(t, 0) + len(pages)
        return slot_idx, st

    def admit_direct(self, req: Request,
                     now: float) -> Optional[Tuple[int, SlotState]]:
        """Admit `req` into a free slot WITHOUT it ever entering the
        FIFO queue — the disaggregated adoption path (serving/disagg.py):
        the prefill tier already computed this request's KV, so the
        decode engine admits it the moment its shipment lands instead
        of queueing it behind colocated prefills.  Same reserve-on-admit
        and quota rules as `admit_next`; no prefix-cache match (the
        shipment carries the full prompt KV).  Returns None (with
        `last_stall` set) when no slot / reservation / quota headroom —
        the caller retries next step, the shipment stays pending."""
        if self._reserve_tokens(req) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + max_new "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        live = {st.request.rid for st in self.slots if st is not None}
        if req.rid in live or any(r.rid == req.rid for r in self.queue):
            raise ValueError(
                f"request {req.rid} is already live or queued — a "
                "double adoption would alias its pages")
        free = self.free_slots()
        if not free:
            self.last_stall = "no_slot"
            return None
        if not self._quota_admits(req):
            self.last_stall = "quota_exceeded"
            return None
        need = self.pool.pages_for(self._reserve_tokens(req))
        fresh = self.pool.alloc(need)
        if fresh is None and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.pool.free_count,
                                    require_free=True)
            fresh = self.pool.alloc(need)
        if fresh is None:
            self.last_stall = "no_pages"
            return None
        self.last_stall = None
        slot_idx = free[0]
        self._admit_seq += 1
        st = SlotState(request=req, pages=fresh, pos=0,
                       stats=RequestStats(arrival_t=req.arrival_t,
                                          admit_t=now),
                       admit_seq=self._admit_seq)
        self.slots[slot_idx] = st
        row = self.page_table[slot_idx]
        row[:] = PagePool.NULL_PAGE
        row[: len(fresh)] = fresh
        self.admitted += 1
        t = req.tenant
        self.tenant_slots[t] = self.tenant_slots.get(t, 0) + 1
        self.tenant_pages[t] = self.tenant_pages.get(t, 0) + len(fresh)
        return slot_idx, st

    def _quota_admits(self, req: Request) -> bool:
        """Would admitting `req` keep its tenant within quota?  Checked
        BEFORE the pool is touched, so a quota stall never pins shared
        prefix pages or triggers cache eviction."""
        q = self.quotas.get(req.tenant)
        if q is None:
            return True
        if q.max_slots and \
                self.tenant_slots.get(req.tenant, 0) + 1 > q.max_slots:
            return False
        if q.max_pages:
            need = self.pool.pages_for(self._reserve_tokens(req))
            if self.tenant_pages.get(req.tenant, 0) + need > q.max_pages:
                return False
        return True

    def release(self, slot_idx: int):
        """Evict a finished sequence: pages released (shared prefix
        pages decref — they stay resident while the radix cache or
        another slot holds them), table row re-pointed at the null page
        (the slot keeps decoding as an inactive row; its writes dump
        into page 0)."""
        st = self.slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is not live")
        self.pool.free(st.pages)
        self.slots[slot_idx] = None
        self.page_table[slot_idx, :] = PagePool.NULL_PAGE
        self.released += 1
        t = st.request.tenant
        self.tenant_slots[t] -= 1
        self.tenant_pages[t] -= len(st.pages)

    # ------------------------------------------------------- preemption
    def preempt_victim(self, priority: int) -> Optional[int]:
        """The slot a `priority`-class admission may evict under
        pressure (HETU_TORCH_SERVE_PREEMPT): the lowest-priority live
        slot, STRICTLY below `priority` (equal classes never preempt
        each other — no thrash), youngest admission first among ties
        (least sunk prefill cost).  None = nothing preemptible."""
        live = [(st.request.slo.priority, -st.admit_seq, i)
                for i, st in enumerate(self.slots) if st is not None]
        if not live:
            return None
        prio, _, idx = min(live)
        return idx if prio < priority else None

    def preempt(self, slot_idx: int) -> Request:
        """Evict-and-requeue a live slot: pages released, the ORIGINAL
        request re-queued at the back (it re-prefills from scratch on
        re-admission — deterministic decode regenerates the same
        tokens).  Returns the requeued request."""
        st = self.slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is not live")
        self.release(slot_idx)
        self.released -= 1          # a preemption is not a completion
        self.preempted += 1
        self.queue.append(st.request)
        return st.request

    # -------------------------------------------------------- failover
    def requeue_lost(self, slot_idx: int) -> Request:
        """Requeue a live slot whose serving replica died (chaos
        ``engine_kill``): same mechanics as :meth:`preempt` — pages
        released, the original request re-queued at the back, a
        deterministic re-prefill/decode regenerates the same tokens —
        but billed against the per-rid retry budget
        (HETU_TORCH_SERVE_RETRY).  The CALLER checks the budget before
        requeueing (past it, the request terminates instead);
        `check_invariants` then holds every count to the budget."""
        st = self.slots[slot_idx]
        if st is None:
            raise ValueError(f"slot {slot_idx} is not live")
        rid = st.request.rid
        self.release(slot_idx)
        self.released -= 1          # a failover is not a completion
        self.replica_requeues += 1
        self.retries[rid] = self.retries.get(rid, 0) + 1
        self.queue.append(st.request)
        return st.request

    # ------------------------------------------------- disagg shipments
    def apply_shipment(self, rid: int, seq: int) -> bool:
        """The at-least-once dedupe gate for a delivered KV shipment
        (serving/disagg.py): True = first delivery, the caller may
        adopt it (`admit_direct` + KV write); False = a redelivery (the
        seq was already adopted, or the rid is already live from an
        earlier attempt) — the caller MUST drop it without touching the
        pool.  Double-delivered shipments therefore can never alias
        pages: the second delivery never allocates."""
        if seq in self.ship_seqs:
            self.ship_dedups += 1
            return False
        if any(st is not None and st.request.rid == rid
               for st in self.slots):
            self.ship_dedups += 1
            return False
        self.ship_seqs.add(seq)
        self.ship_applied.setdefault(rid, []).append(seq)
        return True

    def unapply_shipment(self, rid: int, seq: int):
        """Roll back an `apply_shipment` grant whose adoption could not
        land (no slot / reservation / quota headroom): the seq is
        un-burned so the SAME delivery can retry next step without
        counting as a dedupe."""
        self.ship_seqs.discard(seq)
        seqs = self.ship_applied.get(rid)
        if seqs is not None:
            if seq in seqs:
                seqs.remove(seq)
            if not seqs:
                del self.ship_applied[rid]

    def ship_forget(self, rid: int):
        """Drop the per-rid apply history once `rid` finished (the seq
        set stays — late redeliveries of a finished request still hit
        the dedupe gate)."""
        self.ship_applied.pop(rid, None)

    def drop_queued(self, req: Request) -> bool:
        """Remove a still-queued request (a deadline expiry or a
        brownout shed terminates it without ever admitting); False when
        it is not in the queue (already admitted or never submitted)."""
        try:
            self.queue.remove(req)
        except ValueError:
            return False
        return True

    # ------------------------------------------------------ invariants
    def check_invariants(self):
        """The memory-pool correctness contract (fuzz-tested):
        * refcounts are EXACT: every live page's count equals its owner
          count (slots holding it + one per radix-cache entry) — no
          page is shared without a reference, none leaks one,
        * a page shared by two slots is legal ONLY under COW (both
          slots hold it inside their shared page-aligned prefix, below
          every write position) — without a prefix cache this reduces
          to the original no-aliasing rule,
        * live (refcount > 0) + free pages partition the pool exactly,
        * each table row mirrors its slot's page list, null-padded,
        * the null page is never owned and never free-listed,
        * every live position fits its reservation,
        * the incremental per-tenant usage counters match a fresh scan
          of the live slots, and no quota'd tenant exceeds its caps,
        * a requeued request is REALLY requeued: no rid is both queued
          and live in a slot (its pages were released before it
          re-entered the queue — the refcount-after-requeue rule, which
          the partition/refcount checks above then hold to zero leak),
        * no rid's replica-loss requeue count exceeds the configured
          retry budget (HETU_TORCH_SERVE_RETRY), and with no budget
          configured no requeue ever happened,
        * no rid is live in TWO slots (a double-delivered disagg
          shipment adopted twice would put one request in two slots
          with two page sets — the aliasing the `apply_shipment`
          dedupe gate exists to prevent),
        * the shipment-dedupe books are coherent: no rid's applied-seq
          history holds a duplicate, and every applied seq is in the
          global seq set."""
        owners: Dict[int, int] = {}
        writers: Dict[int, List[int]] = {}   # slots holding p UNSHARED
        tslots: Dict[str, int] = {}
        tpages: Dict[str, int] = {}
        for i, st in enumerate(self.slots):
            if st is not None:
                t = st.request.tenant
                tslots[t] = tslots.get(t, 0) + 1
                tpages[t] = tpages.get(t, 0) + len(st.pages)
        if {k: v for k, v in self.tenant_slots.items() if v} != tslots:
            raise AssertionError(
                f"tenant slot usage {self.tenant_slots} != scan {tslots}")
        if {k: v for k, v in self.tenant_pages.items() if v} != tpages:
            raise AssertionError(
                f"tenant page usage {self.tenant_pages} != scan {tpages}")
        for t, q in self.quotas.items():
            if q.max_slots and tslots.get(t, 0) > q.max_slots:
                raise AssertionError(
                    f"tenant {t!r} holds {tslots[t]} slots over its "
                    f"quota {q.max_slots}")
            if q.max_pages and tpages.get(t, 0) > q.max_pages:
                raise AssertionError(
                    f"tenant {t!r} holds {tpages[t]} pages over its "
                    f"quota {q.max_pages}")
        for i, st in enumerate(self.slots):
            if st is None:
                if (self.page_table[i] != PagePool.NULL_PAGE).any():
                    raise AssertionError(f"empty slot {i} has a non-null "
                                         "table row")
                continue
            shared_pages = st.shared_tokens // self.pool.page_size
            for j, p in enumerate(st.pages):
                if p == PagePool.NULL_PAGE:
                    raise AssertionError(f"slot {i} owns the null page")
                owners[p] = owners.get(p, 0) + 1
                if j >= shared_pages:
                    writers.setdefault(p, []).append(i)
            row = self.page_table[i]
            want = st.pages + [PagePool.NULL_PAGE] * (self.max_pages
                                                      - len(st.pages))
            if list(row) != want:
                raise AssertionError(f"slot {i} table row {list(row)} != "
                                     f"pages {want}")
            if st.pos > len(st.pages) * self.pool.page_size:
                raise AssertionError(
                    f"slot {i} position {st.pos} beyond its "
                    f"{len(st.pages)}-page reservation")
            if st.pos > self.max_len:
                raise AssertionError(f"slot {i} position {st.pos} beyond "
                                     f"max_len {self.max_len}")
        for p, slots_w in writers.items():
            # at most one slot may hold a page outside its shared
            # prefix (the original allocator — the only legal writer);
            # two writers would be genuine cache-corrupting aliasing
            if len(slots_w) > 1:
                raise AssertionError(
                    f"page {p} aliased OUTSIDE a shared prefix by "
                    f"slots {slots_w}")
        if self.prefix_cache is not None:
            for p in self.prefix_cache.owned_pages():
                if p == PagePool.NULL_PAGE:
                    raise AssertionError("prefix cache owns the null page")
                owners[p] = owners.get(p, 0) + 1
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
        for p, n in owners.items():
            if self.pool.refcount[p] != n:
                raise AssertionError(
                    f"page {p} refcount {self.pool.refcount[p]} != "
                    f"{n} owners")
        stray = [int(p) for p in range(1, self.pool.num_pages + 1)
                 if self.pool.refcount[p] > 0 and p not in owners]
        if stray:
            raise AssertionError(f"refcounted pages with no owner: {stray}")
        slot_rids = [st.request.rid for st in self.slots
                     if st is not None]
        live_rids = set(slot_rids)
        if len(slot_rids) != len(live_rids):
            dups = sorted({r for r in slot_rids
                           if slot_rids.count(r) > 1})
            raise AssertionError(
                f"requests live in TWO slots (double-adopted "
                f"shipment?): {dups}")
        both = live_rids & {r.rid for r in self.queue}
        if both:
            raise AssertionError(
                f"requests both queued and live in a slot: {sorted(both)}")
        for rid, seqs in self.ship_applied.items():
            if len(set(seqs)) != len(seqs):
                raise AssertionError(
                    f"rid {rid} adopted a shipment seq twice: {seqs}")
            missing = [s for s in seqs if s not in self.ship_seqs]
            if missing:
                raise AssertionError(
                    f"rid {rid} applied seqs {missing} missing from "
                    "the global dedupe set")
        over = {rid: n for rid, n in self.retries.items()
                if n > max(self.retry_budget, 0)}
        if over:
            raise AssertionError(
                f"replica-loss requeues over the retry budget "
                f"{self.retry_budget}: {over}")
