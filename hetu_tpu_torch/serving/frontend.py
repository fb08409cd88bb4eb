"""Fault-tolerant serving frontend: a health-checked router over N
decode replicas.

One `Frontend` owns a fleet of `ServingEngine` replicas and routes every
arriving request by the replicas' own occupancy digests (queue depth +
live slots — the heartbeat the engines already expose through their
schedulers), skipping replicas that are DOWN (chaos ``engine_kill``
down-windows, `FaultPlan.engine_down`) or DRAINING (operator-initiated
`drain()`; `rejoin()` puts a replica back in rotation).

Fault handling is the engine's own failover machinery composed at fleet
scope:

* a replica death fires `engine.fail_over()` (in-flight requests
  requeue there under HETU_TORCH_SERVE_RETRY, replaying token-identically
  on recovery), then the frontend DRAINS the dead replica's queue and
  re-routes every queued request to a healthy replica — queued work
  never waits out a down-window;
* fleet-wide per-tenant quotas (`TenantQuota.max_slots` counted across
  ALL replicas, not per-engine) hold over-quota arrivals in the
  frontend queue until the tenant's live count drops;
* hedged re-dispatch (HETU_TORCH_SERVE_HEDGE = N router steps): a request
  stuck queued on its replica longer than the hedge patience is
  speculatively re-submitted to the next-best healthy replica.  Results
  are DEDUPED BY RID — the first replica to finish wins (``hedge_win``
  when the hedge copy beat the primary), the loser's queued copy is
  withdrawn, and a loser that already ran to completion is dropped with
  its tokens counted as discarded work (`hedge_discarded_tokens`) so
  EMITTED vs FINISHED token accounting reconciles exactly.

Routing, health, and hedging are pure host-side policy over unmodified
engines, and per-request token streams stay identical to a
single-replica run: the engines' GEMMs keep a fixed M (every slot's
row, in every step), so a row's bits never depend on its neighbours.

Copied from `hetu_tpu/serving/frontend.py` (host-only code), with one
repair: a dead replica's queued request whose hedge copy already runs
on a live replica is not submitted there again (the reference's reroute
would put one rid in two slots of that engine); the copy carries on as
the request's primary.  Replicas are `ServingEngine`s of one device; on
one card they may share one model (its weights once).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence

from hetu_tpu_torch.serving.request import (Request, RequestResult, TenantQuota)
from hetu_tpu_torch.utils.logging import get_logger

logger = get_logger("serving.frontend")


@dataclasses.dataclass
class _Replica:
    """One decode replica and the frontend's view of its health."""
    engine: object
    idx: int
    down: bool = False
    draining: bool = False
    kills: int = 0

    def digest(self) -> Dict[str, object]:
        """The heartbeat/occupancy digest routing consumes (and reports
        surface): everything here is host-side scheduler state the
        engine already maintains."""
        sched = self.engine.scheduler
        return {
            "replica": self.idx,
            "alive": not self.down,
            "draining": self.draining,
            "queue_depth": sched.queue_depth,
            "occupancy": len(sched.active_slots()),
            "num_slots": sched.num_slots,
            "kills": self.kills,
        }


@dataclasses.dataclass
class _Routed:
    """Frontend bookkeeping for one in-flight request."""
    request: Request
    primary: int                 # replica idx the request routed to
    routed_step: int
    hedged_to: Optional[int] = None
    hedged_step: Optional[int] = None


class Frontend:
    """Routes requests over decode replicas; dedupes results by rid.

    ``plan`` drives chaos health: `should_kill_engine(step, rank=idx)`
    kills replica `idx` (one-shot) and `engine_down(step, rank=idx)`
    holds it out of rotation for the down-window.  With no plan the
    frontend is a plain least-loaded balancer."""

    def __init__(self, engines: Sequence, *, plan=None,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 hedge_after: Optional[int] = None, registry=None):
        if not engines:
            raise ValueError("frontend needs at least one replica")
        devices = {str(e.device) for e in engines}
        if len(devices) > 1:
            raise ValueError(f"the replicas live on different devices "
                             f"{sorted(devices)}; a frontend routes over "
                             "replicas of one device")
        if hedge_after is None:
            from hetu_tpu_torch.utils import flags
            hedge_after = flags.int_flag("HETU_TORCH_SERVE_HEDGE")
        if hedge_after < 0:
            raise ValueError(f"hedge_after must be >= 0, "
                             f"got {hedge_after}")
        self.replicas = [_Replica(engine=e, idx=i)
                         for i, e in enumerate(engines)]
        # stamp each replica's hop identity onto its tracer so every
        # span records which engine of the fleet emitted it — the trace
        # context (rid, attempt, tier, replica) the stitcher
        # (obs/spans.FleetTrace) keys causal edges on
        for i, r in enumerate(self.replicas):
            tr = getattr(r.engine, "tracer", None)
            if tr is not None:
                tr.tier = "decode"
                tr.replica = i
        self.plan = plan
        self.quotas = quotas or {}
        self.hedge_after = hedge_after
        # the port keeps no process-global registry: the frontend's
        # counters land in replica 0's unless one is passed
        self._registry = registry if registry is not None \
            else engines[0].registry
        self._held: Deque[Request] = collections.deque()
        self._routed: Dict[int, _Routed] = {}
        self._finished: set = set()
        self._step_idx = 0
        self.reroutes = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_withdrawn = 0
        self.hedge_dupes = 0
        self.hedge_discarded_tokens = 0
        self.quota_holds = 0
        self.steps_done = 0

    # --------------------------------------------------------- operator
    def drain(self, idx: int):
        """Take replica `idx` out of routing rotation (existing work
        finishes; nothing new lands) — the rolling-restart primitive."""
        self.replicas[idx].draining = True
        self._log(event="replica", replica=idx, state="drain")

    def rejoin(self, idx: int):
        """Put a drained (or recovered) replica back in rotation."""
        r = self.replicas[idx]
        was = "drain" if r.draining else ("down" if r.down else "live")
        r.draining = False
        r.down = False
        self._log(event="replica", replica=idx, state="rejoin",
                  was=was)

    def digests(self) -> List[Dict[str, object]]:
        return [r.digest() for r in self.replicas]

    def _log(self, **fields):
        # frontend events ride replica 0's serve-event sink: ONE RunLog
        # carries the whole fleet story for the one-reader report
        self.replicas[0].engine._log_serve(**fields)

    # ---------------------------------------------------------- routing
    def _healthy(self) -> List[_Replica]:
        return [r for r in self.replicas
                if not r.down and not r.draining]

    def _pick(self, exclude: Optional[int] = None) -> Optional[_Replica]:
        """Least-loaded healthy replica (queued + live, ties to the
        lowest idx — deterministic routing for replayable tests)."""
        best = None
        best_key = None
        for r in self._healthy():
            if r.idx == exclude:
                continue
            d = r.digest()
            key = (d["queue_depth"] + d["occupancy"], r.idx)
            if best_key is None or key < best_key:
                best, best_key = r, key
        return best

    def _holder(self, rid: int, exclude: int) -> Optional[_Replica]:
        """A healthy replica other than `exclude` that holds `rid`,
        queued or live (a hedge copy), or None."""
        for r in self._healthy():
            sched = r.engine.scheduler
            if r.idx != exclude and (
                    any(q.rid == rid for q in sched.queue)
                    or any(st is not None and st.request.rid == rid
                           for st in sched.slots)):
                return r
        return None

    def _tenant_live(self, tenant: str) -> int:
        """Fleet-wide live+queued count for `tenant` — the frontend's
        admission view (its own books, no engine scan)."""
        return sum(1 for rt in self._routed.values()
                   if rt.request.tenant == tenant)

    def _over_quota(self, req: Request) -> bool:
        q = self.quotas.get(req.tenant)
        return (q is not None and q.max_slots
                and self._tenant_live(req.tenant) >= q.max_slots)

    def submit(self, req: Request, now: Optional[float] = None):
        if now is not None:
            req.arrival_t = now
        self._held.append(req)

    def _route_held(self, now: float):
        deferred: List[Request] = []
        while self._held:
            req = self._held.popleft()
            if self._over_quota(req):
                self.quota_holds += 1
                self._registry.inc("serve.frontend_quota_holds")
                deferred.append(req)
                continue
            r = self._pick()
            if r is None:           # whole fleet down/draining: hold
                deferred.append(req)
                continue
            # arrival_t is already stamped; the engine must see the
            # TRUE arrival so queue-wait accounting spans the held time
            r.engine.submit(req)
            self._routed[req.rid] = _Routed(request=req, primary=r.idx,
                                            routed_step=self._step_idx)
            self._log(event="dispatch", req=req.rid, replica=r.idx,
                      tier="decode", now=now)
        self._held.extend(deferred)

    # ------------------------------------------------------------ hedge
    def _maybe_hedge(self, now: float):
        if not self.hedge_after:
            return
        for rid, rt in self._routed.items():
            if rt.hedged_to is not None:
                continue
            if self._step_idx - rt.routed_step < self.hedge_after:
                continue
            primary = self.replicas[rt.primary]
            if primary.down:
                continue            # death handling reroutes, not hedge
            sched = primary.engine.scheduler
            if not any(q.rid == rid for q in sched.queue):
                continue            # admitted (or already finished)
            alt = self._pick(exclude=rt.primary)
            if alt is None:
                continue
            alt.engine.submit(rt.request)
            rt.hedged_to = alt.idx
            rt.hedged_step = self._step_idx
            self.hedges += 1
            self._registry.inc("serve.hedges")
            self._log(event="hedge", req=rid, primary=rt.primary,
                      hedge=alt.idx, now=now,
                      waited_steps=self._step_idx - rt.routed_step)

    def _withdraw(self, rid: int, rt: _Routed, winner: int,
                  res: RequestResult, now: float):
        """The OTHER copy of a hedged rid must not reach the client:
        withdraw it if still queued, otherwise let it finish and drop
        the duplicate result (its tokens are discarded work)."""
        loser_idx = rt.hedged_to if winner == rt.primary else rt.primary
        loser = self.replicas[loser_idx]
        if loser.engine.scheduler.drop_queued(rt.request):
            self.hedge_withdrawn += 1
            self._registry.inc("serve.hedge_withdrawn")
            # the losing copy gets its TERMINAL span so fleet-wide
            # span accounting closes over the discarded wait too
            tr = getattr(loser.engine, "tracer", None)
            if tr is not None:
                tr.on_withdraw(rt.request, now, reason="hedge_loss")
        if winner == rt.hedged_to:
            self.hedge_wins += 1
            self._registry.inc("serve.hedge_wins")
            self._log(event="hedge_win", req=rid, primary=rt.primary,
                      hedge=rt.hedged_to, now=now,
                      tokens=len(res.tokens))

    # ------------------------------------------------------------- step
    def _check_health(self, now: float):
        if self.plan is None:
            return
        for r in self.replicas:
            if self.plan.should_kill_engine(self._step_idx, rank=r.idx):
                r.kills += 1
                r.engine.fail_over(now)
                r.down = True
                self._registry.inc("serve.frontend_replica_kills")
                self._log(event="replica", replica=r.idx, state="down",
                          now=now)
                # queued work must not wait out the down-window: pull
                # the dead replica's ENTIRE queue and re-route it (the
                # requeued in-flight included — another replica replays
                # them token-identically from the prompt)
                sched = r.engine.scheduler
                tracer = getattr(r.engine, "tracer", None)
                pulled = []
                while sched.queue:
                    pulled.append(sched.queue.popleft())
                for req in pulled:
                    sched.retries.pop(req.rid, None)
                    # close the dead replica's hop with a withdrawal
                    # terminal: the rid's story continues on another
                    # replica, but THIS hop's spans must still close
                    if tracer is not None:
                        tracer.on_withdraw(req, now, reason="rerouted")
                    rt = self._routed.get(req.rid)
                    holder = self._holder(req.rid, exclude=r.idx)
                    if holder is not None:
                        # its hedge copy runs on a live replica already:
                        # that copy carries on alone (a second copy in
                        # one engine would put one rid in two slots)
                        if rt is not None:
                            rt.primary = holder.idx
                            rt.routed_step = self._step_idx
                            rt.hedged_to = None
                            rt.hedged_step = None
                        continue
                    alt = self._pick(exclude=r.idx)
                    if alt is None:
                        self._held.append(req)
                        continue
                    alt.engine.submit(req)
                    self._log(event="dispatch", req=req.rid,
                              replica=alt.idx, tier="decode", now=now,
                              rerouted_from=r.idx)
                    if rt is not None:
                        rt.primary = alt.idx
                        rt.routed_step = self._step_idx
                        rt.hedged_to = None
                        rt.hedged_step = None
                    self.reroutes += 1
                    self._registry.inc("serve.frontend_reroutes")
            elif r.down and not self.plan.engine_down(self._step_idx,
                                                      rank=r.idx):
                self.rejoin(r.idx)

    def step(self, now: float) -> List[RequestResult]:
        """One router iteration: health transitions, admission routing,
        hedging, then one step of every live replica; returns the
        rid-deduped results."""
        self._check_health(now)
        self._route_held(now)
        self._maybe_hedge(now)
        out: List[RequestResult] = []
        for r in self.replicas:
            if r.down:
                continue
            for res in r.engine.step(now):
                rid = res.rid
                if rid in self._finished:
                    # the hedge loser ran to completion: duplicate
                    # result, discarded work — never reaches the client
                    self.hedge_dupes += 1
                    self.hedge_discarded_tokens += len(res.tokens)
                    self._registry.inc("serve.hedge_dupes")
                    self._registry.inc("serve.hedge_discarded_tokens",
                                       value=len(res.tokens))
                    self._log(event="hedge_dupe", req=rid,
                              replica=r.idx, now=now,
                              tokens=len(res.tokens))
                    continue
                self._finished.add(rid)
                rt = self._routed.pop(rid, None)
                if rt is not None and rt.hedged_to is not None:
                    self._withdraw(rid, rt, r.idx, res, now)
                out.append(res)
        self._step_idx += 1
        self.steps_done += 1
        return out

    # -------------------------------------------------------------- run
    @property
    def idle(self) -> bool:
        if self._held or self._routed:
            return False
        for r in self.replicas:
            sched = r.engine.scheduler
            if sched.queue or sched.active_slots() \
                    or r.engine._fault_results:
                return False
        return True

    def run(self, requests: Sequence[Request], *,
            start: float = 0.0) -> List[RequestResult]:
        """Drive the fleet over a request trace to completion (the
        engine.run contract: virtual arrivals, wall-cost clock)."""
        pending = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        now = start
        results: List[RequestResult] = []
        i = 0
        while True:
            while i < len(pending) and \
                    pending[i].arrival_t <= now + 1e-12:
                self.submit(pending[i])
                i += 1
            if self.idle:
                if i >= len(pending):
                    break
                now = max(now, pending[i].arrival_t)
                continue
            t0 = time.perf_counter()
            results.extend(self.step(now))
            now += time.perf_counter() - t0
        return sorted(results, key=lambda r: r.rid)

    def summary(self) -> Dict[str, object]:
        return {
            "replicas": self.digests(),
            "reroutes": self.reroutes,
            "hedges": self.hedges,
            "hedge_wins": self.hedge_wins,
            "hedge_withdrawn": self.hedge_withdrawn,
            "hedge_dupes": self.hedge_dupes,
            "hedge_discarded_tokens": self.hedge_discarded_tokens,
            "quota_holds": self.quota_holds,
        }
