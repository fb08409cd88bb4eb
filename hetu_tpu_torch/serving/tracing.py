"""Request-scoped span tracer: the serving engine's flight recorder.

`RequestTracer` turns the engine's host-side lifecycle callbacks into
the typed spans of `obs/spans.py`, recorded as schema-versioned ``span``
RunLog records.  Timestamps are the DRIVER's clock (the same virtual
clock `ServingEngine.run` advances), so a replayed trace is
deterministic and span durations reconcile with the SLO timeline in
`RequestStats` exactly.

Tiling contract: every span of a request opens where the previous one
closed —

    queued   [arrival_t, admit_t]                (reason: none|no_slot|no_pages)
    prefill  [prev_end, chunk_end]               one per chunk; last ends at TTFT
    decode   [prev_end, boundary]                split at evictions/reshard pauses
    reshard_pause [pause_t0, pause_t1]
    done/evicted/deadline_exceeded/hedge_withdrawn [t, t]
                                                 zero-duration terminal

so ``sum(durations) == done_t - arrival_t == e2e_s`` by construction
(`slo_report` property-tests the reconciliation).

A request may be RE-queued inside the same trace — by a preemption
(``preempted``) or by an engine failover (``replica_lost``,
HETU_TORCH_SERVE_RETRY).  Each requeue bumps the per-request ``attempt``
index (first admission = attempt 1); spans emitted on later attempts
carry an ``attempt`` attr so readers reconcile per-attempt instead of
corrupting the first attempt's tiling.  Attempt-1 spans stay
byte-identical to the pre-failover schema (no attr stamped).

Gated by ``HETU_TORCH_SERVE_TRACE`` (`maybe_tracer`): unset means the
engine holds no tracer and does zero per-step tracing work — a single
None check, the `maybe_health_monitor` discipline.  The tracer itself
never touches the device: enabling it cannot perturb any compiled
program (enforced by the flag's registered identity contract).

Copied from `hetu_tpu/serving/tracing.py` (host-only code; the port
keeps its own copy so it never imports the JAX package). The tracer is
read from HETU_TORCH_SERVE_TRACE.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from hetu_tpu_torch.obs.spans import (SPAN_SCHEMA, RequestTrace, Span,
                                new_trace_id)


class _Open:
    """Per-request open state between span boundaries."""

    __slots__ = ("rid", "trace", "slo_class", "slot", "phase", "last_t",
                 "stall_reason", "seg_tokens", "seg_index", "chunks",
                 "attempt")

    def __init__(self, rid: int, trace: str, slo_class: str,
                 arrival_t: float):
        self.rid = rid
        self.trace = trace
        self.slo_class = slo_class
        self.slot: Optional[int] = None
        self.phase = "queued"
        self.last_t = arrival_t          # where the next span opens
        self.stall_reason = "none"       # reserve-on-admit attribution
        self.seg_tokens = 0              # tokens in the open decode seg
        self.seg_index = 0
        self.chunks = 0
        self.attempt = 1                 # bumped on every requeue


class RequestTracer:
    """Records request lifecycle spans; one instance per engine.

    ``run_log`` receives one ``span`` record per closed span; with
    ``keep=True`` (the default when no run_log is given) completed
    traces are also held in memory (``traces``) for direct inspection —
    tests and the fuzz harness read them without a disk round-trip.
    """

    def __init__(self, run_log=None, registry=None,
                 keep: Optional[bool] = None, max_kept: int = 4096,
                 tier: Optional[str] = None,
                 replica: Optional[int] = None, clock: str = "driver"):
        self.run_log = run_log
        self.registry = registry
        self.keep = (run_log is None) if keep is None else keep
        self.max_kept = max_kept
        #: hop identity (the fleet trace context): ``tier`` names the
        #: pipeline stage this tracer records (prefill|decode; None =
        #: a single colocated engine), ``replica`` the engine index
        #: behind a routing frontend (the frontend stamps it), and
        #: ``clock`` the timestamp basis every span declares
        self.tier = tier
        self.replica = replica
        self.clock = clock
        self._open: Dict[int, _Open] = {}
        #: completed RequestTraces by rid (keep=True only; bounded to
        #: the newest ``max_kept`` so a long-lived runlog-less engine
        #: cannot grow without limit)
        self.traces: Dict[int, RequestTrace] = {}
        #: every completed trace in completion order (keep=True; same
        #: bound) — unlike ``traces`` a rid that carried SEVERAL hops
        #: on this tracer (prefill re-prefills) keeps them all, which
        #: is what `FleetTrace.stitch` wants
        self.completed: List[RequestTrace] = []
        self._kept: Dict[int, RequestTrace] = {}
        self.spans_emitted = 0

    # ------------------------------------------------------------- emit
    def _emit(self, st: _Open, kind: str, t0: float, t1: float,
              **attrs: Any):
        if st.attempt > 1:
            # attempt-1 spans keep the pre-failover record shape
            attrs.setdefault("attempt", st.attempt)
        span = Span(kind=kind, t0=t0, t1=t1, rid=st.rid, trace=st.trace,
                    slot=st.slot, slo_class=st.slo_class,
                    clock=self.clock, tier=self.tier,
                    replica=self.replica, attrs=attrs)
        self.spans_emitted += 1
        if self.registry is not None:
            self.registry.inc("serve.spans", span=kind)
        if self.run_log is not None:
            self.run_log.log("span", **span.record())
        if self.keep:
            tr = self._kept.get(st.rid)
            if tr is None or tr.trace != st.trace:
                tr = self._kept[st.rid] = RequestTrace(
                    rid=st.rid, trace=st.trace, slo_class=st.slo_class)
            tr.spans.append(span)

    # -------------------------------------------------------- lifecycle
    def on_submit(self, req, at: Optional[float] = None) -> str:
        """A request entered the queue; opens the queued span at its
        arrival time (or ``at`` — a prefill-tier hop opens at ROUTING
        time, not arrival, so sibling hops don't double-open the same
        wait).  Returns the assigned trace id."""
        trace = new_trace_id(req.rid)
        slo = getattr(req, "slo", None)
        self._open[req.rid] = _Open(
            req.rid, trace, slo.name if slo is not None else "default",
            float(req.arrival_t) if at is None else float(at))
        return trace

    def on_stall(self, rids: Iterable[int], reason: str):
        """The scheduler declined admission this step; stamp the
        reserve-on-admit reason on every still-queued request (the
        LAST observed reason wins — it names what the request was
        actually waiting on when it finally mattered).  A `preempted`,
        `replica_lost`, or `prefill_tier_down` stamp is sticky: the
        request is back in the queue BECAUSE it was evicted / its
        replica died / its prefill tier went down, and that attribution
        must survive later stalls."""
        for rid in rids:
            st = self._open.get(rid)
            if (st is not None and st.phase == "queued"
                    and st.stall_reason not in ("preempted",
                                                "replica_lost",
                                                "prefill_tier_down")):
                st.stall_reason = reason

    def on_admit(self, req, slot: int, now: float,
                 shared_tokens: int = 0):
        st = self._open.get(req.rid)
        if st is None:
            return
        st.slot = slot
        self._emit(st, "queued", st.last_t, now, reason=st.stall_reason,
                   **({"shared_tokens": shared_tokens}
                      if shared_tokens else {}))
        st.phase = "prefill"
        st.last_t = now

    def on_chunk(self, req, now: float, chunk: int):
        """A non-final prefill chunk landed; the span absorbs any
        inter-step wait since the previous boundary (tiling)."""
        st = self._open.get(req.rid)
        if st is None:
            return
        st.chunks = chunk
        self._emit(st, "prefill", st.last_t, now, chunk=chunk)
        st.last_t = now

    def on_first_token(self, req, slot: int, now: float, *, chunk: int):
        """The final prefill chunk landed and the first token was
        emitted (TTFT); closes prefill and opens the decode segment."""
        st = self._open.get(req.rid)
        if st is None:
            return
        st.slot = slot
        st.chunks = chunk
        self._emit(st, "prefill", st.last_t, now, chunk=chunk, last=True)
        st.phase = "decode"
        st.last_t = now
        st.seg_tokens = 0
        st.seg_index = 0

    def on_token(self, req, now: float):
        st = self._open.get(req.rid)
        if st is not None and st.phase == "decode":
            st.seg_tokens += 1

    def _close_segment(self, st: _Open, now: float, end: str):
        if st.phase != "decode":
            return
        if now > st.last_t or st.seg_tokens:
            self._emit(st, "decode", st.last_t, now,
                       tokens=st.seg_tokens, segment=st.seg_index,
                       end=end)
            st.seg_index += 1
        st.last_t = now
        st.seg_tokens = 0

    def on_split(self, rids: Iterable[int], now: float, why: str):
        """A batch-composition change (an eviction) at `now`: close the
        survivors' decode segments so the boundary is visible."""
        for rid in rids:
            st = self._open.get(rid)
            if st is not None:
                self._close_segment(st, now, end=why)

    def _requeue(self, req, slot: int, now: float, *, reason: str,
                 end: str):
        """Close the open decode segment (or the partial prefill) and
        re-enter the QUEUED phase inside the SAME trace with a sticky
        stall reason — the re-admission emits another queued span, so
        the tiling (and the span-vs-e2e reconciliation) stays exact
        across the requeue.  Bumps the ``attempt`` index: every span
        emitted from here on carries ``attempt`` so readers reconcile
        per-attempt."""
        st = self._open.get(req.rid)
        if st is None:
            return
        st.slot = slot
        if st.phase == "decode":
            self._close_segment(st, now, end=end)
        elif st.phase == "prefill" and now > st.last_t:
            self._emit(st, "prefill", st.last_t, now, chunk=st.chunks,
                       discarded=True)
            st.last_t = now
        st.phase = "queued"
        st.stall_reason = reason
        st.slot = None
        st.chunks = 0
        st.seg_tokens = 0
        st.seg_index = 0
        st.attempt += 1

    def on_preempt(self, req, slot: int, now: float, *,
                   by: Optional[int] = None):
        """A higher-priority admission evicted this request
        (HETU_TORCH_SERVE_PREEMPT); stall reason ``preempted``."""
        self._requeue(req, slot, now, reason="preempted", end="preempt")

    def on_replica_lost(self, req, slot: int, now: float):
        """The engine (replica) serving this request died (chaos
        ``engine_kill``) and the request re-entered the queue under its
        retry budget (HETU_TORCH_SERVE_RETRY); stall reason
        ``replica_lost``.  The warm radix prefix cache makes the
        re-prefill cheap and seeded sampling replays the exact token
        stream — the trace shows the failover as a requeue boundary,
        not a fresh trace."""
        self._requeue(req, slot, now, reason="replica_lost",
                      end="replica_lost")

    def on_pause(self, rids: Iterable[int], t0: float, t1: float,
                 **attrs: Any):
        """A reshard froze decode over [t0, t1]: split segments at t0,
        record the pause, and reopen at t1."""
        for rid in rids:
            st = self._open.get(rid)
            if st is None or st.phase != "decode":
                continue
            self._close_segment(st, t0, end="reshard")
            self._emit(st, "reshard_pause", t0, t1, **attrs)
            st.last_t = t1

    def _finalize(self, st: _Open, kind: str, now: float, **attrs: Any):
        """Emit the zero-duration terminal span and retire the trace."""
        self._emit(st, kind, now, now, **attrs)
        if self.keep and st.rid in self._kept:
            tr = self._kept.pop(st.rid)
            self.traces[st.rid] = tr
            self.completed.append(tr)
            while len(self.traces) > self.max_kept:
                # dicts iterate in insertion order: drop the oldest
                self.traces.pop(next(iter(self.traces)))
            if len(self.completed) > self.max_kept:
                del self.completed[: len(self.completed)
                                   - self.max_kept]

    def on_finish(self, req, slot: int, reason: str, now: float, *,
                  tokens: Optional[int] = None, e2e_s=None,
                  evicted: bool = False):
        """Terminal: close the open decode segment and emit the
        zero-duration ``done`` (or ``evicted``) span.  A mid-prefill
        eviction (a retry-exhausted failover) tiles its partial
        prefill as discarded so the trace still covers [arrival,
        terminal] exactly; a still-QUEUED finish (a disaggregated
        re-prefill that exhausted the retry budget before any
        admission) tiles the queued wait the same way on_expire
        does."""
        st = self._open.pop(req.rid, None)
        if st is None:
            return
        st.slot = slot
        if st.phase == "queued":
            self._emit(st, "queued", st.last_t, now,
                       reason=st.stall_reason)
            st.last_t = now
        elif st.phase == "prefill":
            if now > st.last_t:
                self._emit(st, "prefill", st.last_t, now,
                           chunk=st.chunks, discarded=True)
                st.last_t = now
        else:
            self._close_segment(st, now, end="finish")
        kind = "evicted" if evicted else "done"
        self._finalize(st, kind, now, reason=reason, tokens=tokens,
                       e2e_s=e2e_s, chunks=st.chunks)

    def on_expire(self, req, now: float, *, tokens: int = 0,
                  e2e_s=None):
        """The request's SLO deadline expired (HETU_TORCH_SERVE_DEADLINE):
        tile the trace up to ``now`` from whatever phase it was in —
        the un-admitted queued wait, a discarded partial prefill, or
        the open decode segment — then emit the zero-duration
        ``deadline_exceeded`` terminal span."""
        st = self._open.pop(req.rid, None)
        if st is None:
            return
        if st.phase == "queued":
            self._emit(st, "queued", st.last_t, now,
                       reason=st.stall_reason)
        elif st.phase == "prefill" and now > st.last_t:
            self._emit(st, "prefill", st.last_t, now, chunk=st.chunks,
                       discarded=True)
        else:
            self._close_segment(st, now, end="expire")
        self._finalize(st, "deadline_exceeded", now,
                       reason="deadline_exceeded", tokens=tokens,
                       e2e_s=e2e_s, chunks=st.chunks)

    def on_withdraw(self, req, now: float, *,
                    reason: str = "hedge_loss"):
        """The frontend withdrew this copy of the request from this
        replica — the losing side of a hedged dispatch
        (``reason="hedge_loss"``), or a dead replica's queue being
        re-routed (``reason="rerouted"``).  Close whatever phase is
        open and emit the ``hedge_withdrawn`` terminal so fleet-wide
        span accounting includes the discarded wait/work: stitched
        span-seconds equal the sum of per-attempt lifetimes, losers
        included."""
        st = self._open.pop(req.rid, None)
        if st is None:
            return
        if st.phase == "queued":
            self._emit(st, "queued", st.last_t, now,
                       reason=st.stall_reason)
        elif st.phase == "prefill":
            if now > st.last_t:
                self._emit(st, "prefill", st.last_t, now,
                           chunk=st.chunks, discarded=True)
        else:
            self._close_segment(st, now, end="withdraw")
        self._finalize(st, "hedge_withdrawn", now, reason=reason,
                       tokens=st.seg_tokens, chunks=st.chunks)

    def on_shed(self, req, now: float):
        """The brownout policy shed this still-queued request
        (HETU_TORCH_SERVE_BROWNOUT): close its queued span with the
        ``brownout_shed`` stall reason and emit the ``evicted``
        terminal carrying the same reason."""
        st = self._open.pop(req.rid, None)
        if st is None:
            return
        st.stall_reason = "brownout_shed"
        self._emit(st, "queued", st.last_t, now, reason="brownout_shed")
        self._finalize(st, "evicted", now, reason="brownout_shed",
                       tokens=0, e2e_s=now - float(req.arrival_t),
                       chunks=st.chunks)

    # ------------------------------------------------------------ debug
    def is_open(self, rid: int) -> bool:
        """True while rid has an open (un-terminated) hop here — the
        fleet sim's guard for idempotent hop closes."""
        return rid in self._open

    def open_requests(self) -> List[int]:
        return sorted(self._open)


def maybe_tracer(run_log=None, registry=None,
                 **kw) -> Optional[RequestTracer]:
    """A RequestTracer when HETU_TORCH_SERVE_TRACE is set, else None —
    the one gate the engine uses, so 'flag unset' provably means zero
    per-request tracing work (a single None check)."""
    from hetu_tpu_torch.utils import flags
    if not flags.bool_flag("HETU_TORCH_SERVE_TRACE"):
        return None
    return RequestTracer(run_log=run_log, registry=registry, **kw)


__all__ = ["RequestTracer", "maybe_tracer", "SPAN_SCHEMA"]
