"""Request-scoped span model: the serving flight recorder's data shape.

A serving request's lifecycle is a sequence of typed **spans** that tile
the driver-clock interval from arrival to completion, the way Hetu's
RunLog gives every training step a record:

    queued         arrival -> admission, carrying the stall-attribution
                   reason the scheduler's reserve-on-admit decision
                   produced (``none`` = admitted without waiting,
                   ``no_slot`` = every decode slot was live,
                   ``no_pages`` = the full page reservation was short,
                   ``quota_exceeded`` = the tenant was over its
                   admission quota)
    prefill        one span per prefill chunk (the disaggregated chunk
                   program); the last chunk's span ends at TTFT
    decode         a decode segment — split at evictions and reshard
                   pauses, so batch-composition changes are visible as
                   segment boundaries; carries the tokens emitted in it
    reshard_pause  the window a LoadAdaptiveMesh reshard froze decode
    done/evicted/deadline_exceeded/hedge_withdrawn
                   the zero-duration terminal span (exactly one per
                   request): ``done`` carries the finish reason and
                   token count, ``evicted`` marks a terminal eviction
                   (a retry budget exhausted after a replica loss, a
                   brownout shed), ``deadline_exceeded`` marks an SLO
                   deadline expiry (HETU_TORCH_SERVE_DEADLINE), and
                   ``hedge_withdrawn`` closes the LOSING copy of a
                   hedged request (serving/frontend.py) so fleet-wide
                   span accounting includes the discarded work

Every span additionally carries its **hop identity** — the trace
context ``(rid, attempt, tier, replica)`` of the distributed fleet:
``tier`` names which stage of the disaggregated pipeline emitted it
(``prefill`` | ``decode``; unset means a single colocated engine),
``replica`` the engine index behind a routing frontend, and ``attempt``
(an attr, stamped from 2 up) the failover/requeue incarnation.  A
``clock`` basis field (``driver`` | ``wall``) declares which clock the
``t0``/``t1`` stamps were taken on; `FleetTrace.stitch` refuses to mix
bases rather than silently producing garbage durations.

Spans are recorded as schema-versioned ``span`` RunLog records
(``span_schema`` field; see obs/runlog.py) by
`serving/tracing.RequestTracer` under the ``HETU_TORCH_SERVE_TRACE``
flag.  Timestamps ``t0``/``t1`` are **driver-clock** seconds (virtual
in `ServingEngine.run`/tests, wall in a live server), so a replayed
trace is deterministic; the standard RunLog ``t`` wall stamp rides
along for cross-log merging.

Because consecutive spans share boundaries (each opens where the
previous closed), the span durations of a finished request sum to its
recorded ``e2e_s`` — `reconcile()` checks that, and the tier-1 property
test holds every request to within one engine-step quantum.

This module is pure host-side bookkeeping: no jax, no serving imports —
the one span vocabulary `serving/tracing.py` (writer),
`serving/slo_report.py` (reader) and `obs/trace.py` (renderer) share.

Copied from `hetu_tpu/obs/spans.py` (host-only code; the port keeps its
own copy so it never imports the JAX package).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Iterable, List, Optional

#: bump when the `span` record shape changes incompatibly
SPAN_SCHEMA = 1

SPAN_KINDS = ("queued", "prefill", "decode", "reshard_pause",
              "done", "evicted", "deadline_exceeded", "hedge_withdrawn")
TERMINAL_KINDS = ("done", "evicted", "deadline_exceeded",
                  "hedge_withdrawn")

#: span timestamp bases — ``driver`` is the engine's virtual clock
#: (deterministic under replay; what every tier-1 test runs on),
#: ``wall`` is host wall time (a live server).  Durations from
#: different bases must never be stitched together.
CLOCK_BASES = ("driver", "wall")
#: ``preempted`` marks a RE-queued span: the request was evicted by a
#: higher-priority admission (HETU_TORCH_SERVE_PREEMPT) and waits again —
#: same trace, so the tiling/reconciliation contract still holds.
#: ``replica_lost`` is the failover twin: the serving engine (replica)
#: died mid-flight (chaos ``engine_kill``) and the request re-entered
#: the queue under its retry budget (HETU_TORCH_SERVE_RETRY) — same
#: trace, new ``attempt``.
#: ``quota_exceeded`` means the head request's TENANT was over its
#: admission quota (slots or pages; HETU_TORCH_SERVE_QUOTAS) even though
#: the pool itself could have served it.
#: ``brownout_shed`` stamps the final queued span of a request the
#: sustained-pressure brownout policy shed (HETU_TORCH_SERVE_BROWNOUT) —
#: lowest-priority tenants first; the terminal span is ``evicted``
#: with ``reason="brownout_shed"``.
#: ``prefill_tier_down`` is the disaggregated-serving degradation stamp
#: (serving/disagg.py): the request's prefill
#: tier was dead, so it queued for COLOCATED chunked prefill on the
#: decode replica instead — sticky, like the other fault stamps.
#: ``shipment_wait`` marks a queued span that waited on a prefill-tier
#: KV shipment (a dropped/delayed wire exchange under chaos) rather
#: than on decode capacity.
STALL_REASONS = ("none", "no_slot", "no_pages", "preempted",
                 "quota_exceeded", "replica_lost", "brownout_shed",
                 "prefill_tier_down", "shipment_wait")

#: span-record fields that are structure, not attrs
_CORE_FIELDS = ("schema", "kind", "t", "span_schema", "span", "trace",
                "req", "slot", "slo_class", "t0", "t1", "clock",
                "tier", "replica")

_trace_counter = itertools.count()


def new_trace_id(rid: int) -> str:
    """A process-unique trace id for request `rid` (stable ordering, no
    RNG — deterministic under a replayed virtual clock)."""
    return f"tr{next(_trace_counter):x}.{rid}"


@dataclasses.dataclass
class Span:
    """One typed interval of a request's lifecycle (driver-clock secs)."""
    kind: str
    t0: float
    t1: float
    rid: int
    trace: str
    slot: Optional[int] = None
    slo_class: str = "default"
    clock: str = "driver"
    tier: Optional[str] = None       # prefill|decode; None = colocated
    replica: Optional[int] = None    # engine index behind a frontend
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in SPAN_KINDS:
            raise ValueError(f"unknown span kind {self.kind!r}; "
                             f"known: {SPAN_KINDS}")
        if self.clock not in CLOCK_BASES:
            raise ValueError(f"unknown clock basis {self.clock!r}; "
                             f"known: {CLOCK_BASES}")

    @property
    def dur_s(self) -> float:
        return self.t1 - self.t0

    @property
    def attempt(self) -> int:
        return int(self.attrs.get("attempt", 1))

    def record(self) -> Dict[str, Any]:
        """The RunLog ``span`` record payload (everything but the
        writer-stamped schema/kind/t).  ``clock`` is always stamped;
        the hop-identity fields ride only when set, so a single
        colocated engine's records keep their pre-fleet shape."""
        out = {"span_schema": SPAN_SCHEMA, "span": self.kind,
               "trace": self.trace, "req": self.rid, "slot": self.slot,
               "slo_class": self.slo_class,
               "t0": self.t0, "t1": self.t1, "clock": self.clock}
        if self.tier is not None:
            out["tier"] = self.tier
        if self.replica is not None:
            out["replica"] = self.replica
        out.update(self.attrs)
        return out

    @staticmethod
    def from_record(rec: Dict[str, Any]) -> "Span":
        attrs = {k: v for k, v in rec.items() if k not in _CORE_FIELDS}
        return Span(kind=rec["span"], t0=float(rec["t0"]),
                    t1=float(rec["t1"]), rid=int(rec["req"]),
                    trace=str(rec.get("trace", "")),
                    slot=rec.get("slot"),
                    slo_class=str(rec.get("slo_class", "default")),
                    clock=str(rec.get("clock", "driver")),
                    tier=rec.get("tier"),
                    replica=rec.get("replica"),
                    attrs=attrs)


@dataclasses.dataclass
class RequestTrace:
    """All spans of one request, in emission order."""
    rid: int
    trace: str
    slo_class: str = "default"
    spans: List[Span] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------ views
    def by_kind(self, kind: str) -> List[Span]:
        return [s for s in self.spans if s.kind == kind]

    @property
    def tier(self) -> str:
        """The hop's pipeline tier (``decode`` when unstamped — a
        colocated single engine)."""
        for s in self.spans:
            if s.tier is not None:
                return s.tier
        return "decode"

    @property
    def replica(self) -> Optional[int]:
        for s in self.spans:
            if s.replica is not None:
                return s.replica
        return None

    @property
    def clock(self) -> str:
        return self.spans[0].clock if self.spans else "driver"

    def attempts(self) -> Dict[int, List[Span]]:
        """Spans grouped by failover/requeue attempt (1-based; the
        ``attempt`` attr is only stamped from 2 up)."""
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            out.setdefault(s.attempt, []).append(s)
        return out

    @property
    def lifetime_s(self) -> float:
        """Wall of this hop: first span open -> terminal close (0 for
        an empty trace)."""
        if not self.spans:
            return 0.0
        return self.spans[-1].t1 - self.spans[0].t0

    @property
    def terminal(self) -> Optional[Span]:
        term = [s for s in self.spans if s.kind in TERMINAL_KINDS]
        return term[-1] if term else None

    @property
    def stall_reason(self) -> Optional[str]:
        q = self.by_kind("queued")
        return q[0].attrs.get("reason") if q else None

    def duration_s(self, kind: str) -> float:
        return sum(s.dur_s for s in self.by_kind(kind))

    @property
    def total_s(self) -> float:
        """Sum of all non-terminal span durations — should reconcile
        with the request's recorded ``e2e_s``."""
        return sum(s.dur_s for s in self.spans
                   if s.kind not in TERMINAL_KINDS)

    @property
    def tokens(self) -> Optional[int]:
        t = self.terminal
        return t.attrs.get("tokens") if t is not None else None

    # ------------------------------------------------------- invariants
    def validate(self, *, eps: float = 1e-9):
        """The span-event contract the fuzz test drives:

        * at least one span, the first being ``queued`` with a
          stall-attribution reason from STALL_REASONS,
        * exactly one terminal span (done | evicted), and it is last,
        * spans are ordered and non-overlapping: each span opens no
          earlier than the previous closed (shared boundaries allowed),
        * every span has t1 >= t0 and carries this trace's ids.

        Raises AssertionError naming the violated invariant."""
        if not self.spans:
            raise AssertionError(f"request {self.rid}: empty trace")
        first = self.spans[0]
        if first.kind != "queued":
            raise AssertionError(
                f"request {self.rid}: first span is {first.kind!r}, "
                "not 'queued'")
        if first.attrs.get("reason") not in STALL_REASONS:
            raise AssertionError(
                f"request {self.rid}: queued span carries stall reason "
                f"{first.attrs.get('reason')!r}, not one of "
                f"{STALL_REASONS}")
        terms = [s for s in self.spans if s.kind in TERMINAL_KINDS]
        if len(terms) != 1:
            raise AssertionError(
                f"request {self.rid}: {len(terms)} terminal spans "
                f"({[s.kind for s in terms]}); want exactly one")
        if self.spans[-1].kind not in TERMINAL_KINDS:
            raise AssertionError(
                f"request {self.rid}: terminal span is not last "
                f"(last is {self.spans[-1].kind!r})")
        prev_t1 = None
        for s in self.spans:
            if s.rid != self.rid or s.trace != self.trace:
                raise AssertionError(
                    f"request {self.rid}: span {s.kind} carries foreign "
                    f"ids (req={s.rid}, trace={s.trace!r})")
            if s.t1 < s.t0 - eps:
                raise AssertionError(
                    f"request {self.rid}: span {s.kind} runs backwards "
                    f"({s.t0} -> {s.t1})")
            if prev_t1 is not None and s.t0 < prev_t1 - eps:
                raise AssertionError(
                    f"request {self.rid}: span {s.kind} at {s.t0} "
                    f"overlaps the previous span ending {prev_t1}")
            prev_t1 = s.t1

    def reconcile(self, e2e_s: Optional[float]) -> Optional[float]:
        """Residual between the span tiling and the recorded end-to-end
        latency: ``|sum(span durations) - e2e_s|``.  None when either
        side is missing.  The acceptance property holds this within one
        engine-step quantum."""
        if e2e_s is None or self.terminal is None:
            return None
        return abs(self.total_s - float(e2e_s))


def collect_traces(records: Iterable[Dict[str, Any]]
                   ) -> Dict[int, RequestTrace]:
    """Group RunLog ``span`` records into per-request RequestTraces
    (rid-keyed, spans in record order) — THE reader every consumer
    (slo_report, trace renderer, tests) shares."""
    out: Dict[int, RequestTrace] = {}
    for rec in records:
        if rec.get("kind") != "span" or "span" not in rec:
            continue
        sp = Span.from_record(rec)
        tr = out.get(sp.rid)
        if tr is None or tr.trace != sp.trace:
            # a rid reused across engine incarnations starts a fresh
            # trace; the latest wins (report surfaces completed ones)
            tr = out[sp.rid] = RequestTrace(rid=sp.rid, trace=sp.trace,
                                           slo_class=sp.slo_class)
        tr.spans.append(sp)
    return out


# --------------------------------------------------------------- fleet
#: terminal kinds that produce a CLIENT-visible result (a hedge loser's
#: ``hedge_withdrawn`` closes its hop but never reaches the client)
CLIENT_TERMINALS = ("done", "evicted", "deadline_exceeded")

#: serve events the stitcher consumes as causal-edge endpoints
_EDGE_EVENTS = ("dispatch", "hedge", "hedge_win", "hedge_dupe",
                "ship", "retry", "admit")


def _ev_t(ev: Dict[str, Any]) -> float:
    for k in ("now", "t"):
        if ev.get(k) is not None:
            return float(ev[k])
    return 0.0


def _ev_rid(ev: Dict[str, Any]) -> Optional[int]:
    rid = ev.get("req", ev.get("rid"))
    return int(rid) if rid is not None else None


@dataclasses.dataclass
class FleetTrace:
    """One request's CAUSAL DAG across the disaggregated fleet.

    ``hops`` are the per-engine `RequestTrace`s that carried the rid —
    the decode replica(s), hedged copies, and prefill-tier incarnations
    — each stamped with its hop identity (tier, replica, clock).
    ``events`` are the frontend/shipment serve records for the rid, and
    ``edges`` the explicit causal links the stitcher derived from them:

        dispatch        frontend routing -> a hop's queued span
        hedge_fork      the primary copy forks a hedged duplicate
        hedge_win       the hedge copy produced the client result
        hedge_withdraw  the losing copy's terminal (discarded work)
        ship            prefill tier -> decode (the KV shipment)
        adopt           the shipment's apply/admit on the decode tier
        replay          a kill's requeue re-admission (attempt n -> n+1)
        fallback        a dead prefill tier colocated the request

    `validate` is the fleet-scope tiling contract: every hop tiles per
    attempt, exactly one hop carries the client terminal, no hop is an
    orphan (unreachable from the edges), and the primary hop's union
    covers arrival -> terminal with zero residual (<= one step quantum
    per attempt boundary) under one shared clock basis.
    """
    rid: int
    hops: List[RequestTrace] = dataclasses.field(default_factory=list)
    events: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    edges: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    clock: str = "driver"

    # ------------------------------------------------------------ views
    @property
    def primary(self) -> Optional[RequestTrace]:
        """The hop that produced the CLIENT result: a decode-tier hop
        whose terminal is done/evicted/deadline_exceeded.  A hedge
        loser that ran to completion (``hedge_dupe``) is excluded; ties
        go to the earliest terminal (the copy that won the race)."""
        wins = [h for h in self.hops
                if h.tier != "prefill" and h.terminal is not None
                and h.terminal.kind in CLIENT_TERMINALS]
        if len(wins) > 1:
            dupes = {ev.get("replica") for ev in self.events
                     if ev.get("event") == "hedge_dupe"}
            filt = [h for h in wins if h.replica not in dupes]
            wins = filt or wins
        if not wins:
            return None
        return min(wins, key=lambda h: h.terminal.t1)

    @property
    def slo_class(self) -> str:
        p = self.primary
        return p.slo_class if p is not None else (
            self.hops[0].slo_class if self.hops else "default")

    @property
    def span_seconds(self) -> float:
        """Total non-terminal span-seconds across ALL hops — the
        fleet-wide work ledger, discarded hedge/prefill work included."""
        return sum(h.total_s for h in self.hops)

    @property
    def lifetime_seconds(self) -> float:
        """Sum of per-hop lifetimes (first open -> terminal).  Because
        every hop tiles contiguously, this equals `span_seconds` — the
        satellite accounting identity fleet tests pin."""
        return sum(h.lifetime_s for h in self.hops)

    @property
    def e2e_s(self) -> Optional[float]:
        p = self.primary
        return p.lifetime_s if p is not None else None

    def hop_label(self, hop: RequestTrace) -> str:
        rep = "" if hop.replica is None else f"/{hop.replica}"
        return f"{hop.tier}{rep}"

    # ------------------------------------------------------- invariants
    def residual_s(self) -> float:
        """Uncovered time inside the primary hop's [arrival, terminal]
        interval: the sum of positive gaps between consecutive spans.
        Zero means the stitched union tiles the lifetime exactly."""
        p = self.primary
        if p is None or not p.spans:
            return 0.0
        gap = 0.0
        prev_t1 = p.spans[0].t0
        for s in p.spans:
            gap += max(0.0, s.t0 - prev_t1)
            prev_t1 = max(prev_t1, s.t1)
        return gap

    def validate(self, *, eps: float = 1e-9,
                 step_quantum: float = 0.0):
        """Fleet-scope stitch contract (AssertionError on violation):

        * every hop individually satisfies the `RequestTrace` contract
          and tiles CONTIGUOUSLY within each attempt (gaps only at
          attempt boundaries, each <= one step quantum),
        * exactly one hop carries the client terminal (hedge dupes
          discounted via their ``hedge_dupe`` event),
        * no orphan hops: every non-primary hop is referenced by at
          least one causal edge,
        * the primary hop's union covers arrival -> terminal with
          residual <= one step quantum per attempt boundary."""
        if not self.hops:
            raise AssertionError(f"rid {self.rid}: no hops to stitch")
        for h in self.hops:
            h.validate(eps=eps)
            prev_t1: Optional[float] = None
            prev_attempt = None
            boundaries = 0
            for s in h.spans:
                if prev_t1 is not None:
                    allow = eps
                    if s.attempt != prev_attempt:
                        boundaries += 1
                        allow = step_quantum + eps
                    if s.t0 - prev_t1 > allow:
                        raise AssertionError(
                            f"rid {self.rid} hop {self.hop_label(h)}: "
                            f"span {s.kind} at {s.t0} leaves a "
                            f"{s.t0 - prev_t1:.3g}s hole after "
                            f"{prev_t1} (attempt {s.attempt})")
                prev_t1 = s.t1
                prev_attempt = s.attempt
        wins = [h for h in self.hops
                if h.tier != "prefill" and h.terminal is not None
                and h.terminal.kind in CLIENT_TERMINALS]
        dupes = {ev.get("replica") for ev in self.events
                 if ev.get("event") == "hedge_dupe"}
        effective = [h for h in wins
                     if not dupes or h.replica not in dupes] or wins
        if len(effective) != 1:
            raise AssertionError(
                f"rid {self.rid}: {len(effective)} client-terminal "
                f"hops ({[self.hop_label(h) for h in effective]}); "
                "want exactly one")
        prim = self.primary
        for h in self.hops:
            if h is prim:
                continue
            if not any(e.get("src") == h.trace or e.get("dst") == h.trace
                       for e in self.edges):
                raise AssertionError(
                    f"rid {self.rid}: orphan hop "
                    f"{self.hop_label(h)} ({h.trace}) — no causal edge "
                    "reaches it")
        attempts = len(prim.attempts()) if prim is not None else 1
        allow = eps + step_quantum * max(0, attempts - 1)
        resid = self.residual_s()
        if resid > allow:
            raise AssertionError(
                f"rid {self.rid}: stitched union leaves "
                f"{resid:.3g}s uncovered (> {allow:.3g})")

    # ------------------------------------------------------------ stitch
    @staticmethod
    def stitch(records: Optional[Iterable[Dict[str, Any]]] = None, *,
               traces: Optional[Iterable[RequestTrace]] = None,
               events: Optional[Iterable[Dict[str, Any]]] = None,
               eps: float = 1e-9) -> Dict[int, "FleetTrace"]:
        """Assemble per-rid `FleetTrace`s from RunLog records and/or
        in-memory traces + serve events.  Unlike `collect_traces`
        (latest trace wins) the stitcher keeps EVERY (rid, trace) hop —
        hedge losers and prefill-tier incarnations included.  Raises
        ValueError on mixed clock bases."""
        hops: Dict[int, Dict[str, RequestTrace]] = {}
        evs: Dict[int, List[Dict[str, Any]]] = {}
        clocks = set()

        def add_span(sp: Span):
            clocks.add(sp.clock)
            per = hops.setdefault(sp.rid, {})
            tr = per.get(sp.trace)
            if tr is None:
                tr = per[sp.trace] = RequestTrace(
                    rid=sp.rid, trace=sp.trace, slo_class=sp.slo_class)
            tr.spans.append(sp)

        def add_event(ev: Dict[str, Any]):
            if ev.get("clock") is not None:
                clocks.add(str(ev["clock"]))
            rid = _ev_rid(ev)
            if rid is None or ev.get("event") not in _EDGE_EVENTS:
                return
            evs.setdefault(rid, []).append(ev)

        for rec in records or ():
            if rec.get("kind") == "span" and "span" in rec:
                add_span(Span.from_record(rec))
            elif rec.get("kind") == "serve" and "event" in rec:
                add_event(rec)
        for tr in traces or ():
            for sp in tr.spans:
                add_span(sp)
        for ev in events or ():
            if "event" in ev:
                add_event(ev)
        if len(clocks) > 1:
            raise ValueError(
                "FleetTrace.stitch: mixed clock bases "
                f"{sorted(clocks)} — driver-clock and wall-clock "
                "records cannot be stitched into one timeline; "
                "re-record with a single basis")
        clock = next(iter(clocks)) if clocks else "driver"

        out: Dict[int, FleetTrace] = {}
        for rid, per in hops.items():
            hlist = sorted(
                per.values(),
                key=lambda h: (h.spans[0].t0 if h.spans else 0.0,
                               h.trace))
            ft = FleetTrace(rid=rid, hops=hlist,
                            events=sorted(evs.get(rid, ()), key=_ev_t),
                            clock=clock)
            ft.edges = _build_edges(ft, eps=eps)
            out[rid] = ft
        return out


def _hop_for(hops: List[RequestTrace], *, tier: Optional[str] = None,
             replica: Optional[int] = None,
             at: Optional[float] = None,
             eps: float = 1e-9) -> Optional[RequestTrace]:
    """The hop matching a tier/replica stamp, preferring the latest one
    already open at time ``at`` (re-prefills make several hops per
    tier)."""
    cand = [h for h in hops if h.spans
            and (tier is None or h.tier == tier)
            and (replica is None or h.replica == replica)]
    if not cand:
        return None
    if at is not None:
        started = [h for h in cand if h.spans[0].t0 <= at + eps]
        if started:
            return started[-1]
    return cand[-1]


def _build_edges(ft: FleetTrace, *, eps: float = 1e-9
                 ) -> List[Dict[str, Any]]:
    """Derive the causal edges of one rid's DAG from its serve events
    and hop terminals (see `FleetTrace` for the edge vocabulary)."""
    edges: List[Dict[str, Any]] = []
    prim = ft.primary
    prim_trace = prim.trace if prim is not None else "decode"
    for ev in ft.events:
        kind = ev.get("event")
        t = _ev_t(ev)
        if kind == "dispatch":
            dst = _hop_for(ft.hops, tier=ev.get("tier"),
                           replica=ev.get("replica"), at=t, eps=eps)
            edges.append({"kind": "dispatch", "t": t, "src": "frontend",
                          "dst": dst.trace if dst is not None
                          else str(ev.get("tier") or "decode")})
        elif kind == "hedge":
            p = _hop_for(ft.hops, replica=ev.get("primary"), at=t,
                         eps=eps)
            h = _hop_for(ft.hops, replica=ev.get("hedge"), eps=eps)
            edges.append({"kind": "hedge_fork", "t": t,
                          "src": p.trace if p is not None
                          else "frontend",
                          "dst": h.trace if h is not None else "hedge"})
        elif kind == "hedge_win":
            h = _hop_for(ft.hops, replica=ev.get("hedge"), at=t,
                         eps=eps)
            edges.append({"kind": "hedge_win", "t": t,
                          "src": h.trace if h is not None else "hedge",
                          "dst": "client"})
        elif kind == "ship":
            src = _hop_for(ft.hops, tier="prefill", at=t, eps=eps)
            edges.append({"kind": "ship", "t": t,
                          "src": src.trace if src is not None
                          else "prefill",
                          "dst": prim_trace,
                          **({"seq": ev["seq"]} if "seq" in ev else {})})
        elif kind == "retry":
            att = ev.get("attempt")
            edges.append({"kind": "replay", "t": t, "src": prim_trace,
                          "dst": prim_trace,
                          **({"attempt": att} if att is not None
                             else {})})
        elif kind == "admit" and ev.get("disagg"):
            edges.append({"kind": "adopt", "t": t, "src": "wire",
                          "dst": prim_trace})
    for h in ft.hops:
        term = h.terminal
        if term is None:
            continue
        if term.kind == "hedge_withdrawn":
            edges.append({"kind": "hedge_withdraw", "t": term.t1,
                          "src": h.trace, "dst": "frontend"})
        elif h.tier == "prefill":
            if term.kind == "done":
                if not any(e["kind"] == "ship" and e["src"] == h.trace
                           for e in edges):
                    edges.append({"kind": "ship", "t": term.t1,
                                  "src": h.trace, "dst": prim_trace})
            else:
                edges.append({"kind": "fallback", "t": term.t1,
                              "src": h.trace, "dst": prim_trace})
    return edges
