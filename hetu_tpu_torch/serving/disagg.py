"""Disaggregated prefill/decode serving: acked KV shipping with
graceful colocation fallback.

The Hetis split (ROADMAP item 1): a PREFILL tier computes prompt KV
with the same chunk program the engine runs colocated, then ships the
finished scratch — optionally int8/int4-quantized on the wire per
EQuARX's cheap-collectives argument — to a DECODE tier that scatters it
into pool pages through the engine's own write program and decodes.
Because chunked prefill, the first-token rule
(`engine.first_token_from_logits`), and the page write are the SAME
programs both ways, the disaggregated path is token-byte-identical to
the single-engine run (with exact `ship_quant="none"` payloads; the
quantized wire modes trade that bit-exactness for bytes, like the
quantized KV pool itself).

Every new seam is a failure mode, so the handoff is an AT-LEAST-ONCE
protocol from day one:

* shipments carry a channel-global ``seq``; the decode side's
  `Scheduler.apply_shipment` gate dedupes redeliveries BEFORE any page
  is allocated — a double-delivered shipment can never alias pages
  (`check_invariants` holds the no-rid-in-two-slots rule);
* the receiver acks every delivery (including dedupes); the sender
  retransmits un-acked shipments after ``ship_timeout`` coordinator
  steps, up to ``ship_retry`` resends;
* past the resend budget — or when the prefill tier died with the
  request in flight — the request RE-PREFILLS under the decode
  engine's per-rid retry budget (HETU_TORCH_SERVE_RETRY): the `attempt`
  accounting rides the same ``retry`` serve events and
  ``stats.retries`` fields replica failover uses, and past THAT budget
  the request terminates ``retry_exhausted``;
* a dead prefill tier (chaos ``prefill_kill``, consulted through
  `chaos.inject.maybe_chaos_disagg`) flips the coordinator DEGRADED:
  arrivals and timed-out re-prefills route to the decode engine's own
  queue — colocated chunked prefill, deterministically the same
  tokens — behind a sticky ``prefill_tier_down`` stall reason, metered
  as degraded-mode seconds, auto-recovering when the down-window
  passes.

The chaos wire kinds ``shipment_drop`` / ``shipment_dup`` /
``shipment_delay`` fire inside `ShipmentChannel` via
`FaultPlan.shipment_fault` — matching-call windows on the ship/ack
exchanges, deterministic given the plan.  On this in-process channel a
``shipment_delay``'s ``delay_s`` is counted in whole coordinator steps
(ceil) so replays are step-deterministic and hardware-free.

The port of `hetu_tpu/serving/disagg.py`.  The prefill tier and the
decode engine share one device and may share one model (its weights
once).  Each live prefill owns its own zeroed scratch (the engine's
rule), freed when the prefill ships, is dropped or is killed.  The wire
crosses the host, as the reference's numpy shipments do: a payload is
packed on the device (int8: the quantize kernel, one launch for K and
one for V), copied to host memory, and on delivery copied back and
unpacked (int8: the dequantize kernel, two launches), so `wire_bytes`
counts host bytes and the ship time holds both copies.  The int4 wire
is plain PyTorch on both sides, as the reference's is plain jnp.  The
coordinator records each shipment's pack and adopt wall times
(`ship_pack_s`, `ship_adopt_s`) and its pack-to-adopt wall
(`ship_wall_s`).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_tpu_torch.chaos.inject import maybe_chaos_disagg
from hetu_tpu_torch.models.generation import extend_cache
from hetu_tpu_torch.serving.engine import _kv_heads, first_token_from_logits
from hetu_tpu_torch.serving.kv_pool import dequantize_heads, quantize_heads
from hetu_tpu_torch.serving.request import Request, RequestResult
from hetu_tpu_torch.serving.tracing import RequestTracer
from hetu_tpu_torch.utils import flags
from hetu_tpu_torch.utils.device import resolve_device

SHIP_QUANT_MODES = ("none", "int8", "int4")


@dataclasses.dataclass
class _Prefill:
    """One in-flight prefill on the worker."""
    request: Request
    cache: object
    chunks_done: int = 0
    attempt: int = 0


class PrefillWorker:
    """The prefill tier: chunked prompt prefill into a dense scratch
    cache with the engine's chunk forward (`models/generation.
    extend_cache`), advancing each in-flight prompt ONE chunk per step
    (the engine's contract, kept off-engine so service times stay
    comparable).  Finished prefills emit ``(request, attempt, t1, ks,
    vs)`` payloads: the full [L, max_len, n_kv, hd] scratch K/V (device
    tensors) plus the first token, computed with the shared
    `first_token_from_logits` rule — everything the decode tier needs to
    adopt the request with the tokens of a colocated prefill.

    No page pool lives here: prefill only touches scratch, one zeroed
    scratch per live prefill.  `device` ("cuda" by default) must be the
    model's."""

    def __init__(self, model, *, prefill_chunk: int, max_len: int,
                 num_slots: int = 2, sampling: bool = False,
                 registry=None, device="cuda"):
        if max_len % prefill_chunk:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"prefill_chunk {prefill_chunk}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"prefill tier was asked for {self.device}")
        self.model = model
        self.prefill_chunk = prefill_chunk
        self.max_len = max_len
        self.num_slots = num_slots
        self.sampling = sampling
        self._registry = registry
        self._queue: Deque[Tuple[Request, int]] = collections.deque()
        self._live: Dict[int, _Prefill] = {}
        self.chunks = 0
        self.finished = 0
        self.killed = 0

    def submit(self, req: Request, attempt: int = 0):
        if req.prompt_len > self.max_len:
            raise ValueError(f"request {req.rid}: prompt "
                             f"{req.prompt_len} exceeds max_len "
                             f"{self.max_len}")
        self._queue.append((req, attempt))

    def has(self, rid: int) -> bool:
        return rid in self._live or any(r.rid == rid
                                        for r, _ in self._queue)

    def drop(self, rid: int):
        """Forget `rid` wherever it sits (a terminated request must not
        keep burning prefill chunks)."""
        self._live.pop(rid, None)
        for item in list(self._queue):
            if item[0].rid == rid:
                self._queue.remove(item)

    @property
    def idle(self) -> bool:
        return not self._live and not self._queue

    def kill(self) -> List[int]:
        """The tier process dies (chaos ``prefill_kill``): every
        in-flight AND queued prefill is lost — the coordinator re-routes
        them (re-prefill / colocation fallback).  Returns the lost
        rids."""
        lost = list(self._live.keys()) + [r.rid for r, _ in self._queue]
        self._live.clear()
        self._queue.clear()
        self.killed += 1
        return lost

    def _new_scratch(self):
        """A zeroed dense [L, 1, max_len, n_kv, hd] K/V pair for one live
        prefill (never shared: the chunk forward writes it in place)."""
        c = self.model.config
        shape = (c.num_hidden_layers, 1, self.max_len, _kv_heads(c),
                 c.head_dim)
        return (torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
                torch.zeros(shape, dtype=c.compute_dtype, device=self.device))

    def step(self) -> List[Tuple[Request, int, int, torch.Tensor,
                                 torch.Tensor]]:
        """Admit up to the slot limit, advance every in-flight prefill
        one chunk; returns the payloads that finished this step (their
        scratch leaves the worker with them)."""
        while len(self._live) < self.num_slots and self._queue:
            req, attempt = self._queue.popleft()
            self._live[req.rid] = _Prefill(request=req,
                                           cache=self._new_scratch(),
                                           attempt=attempt)
        out = []
        for rid in list(self._live.keys()):
            pf = self._live[rid]
            req = pf.request
            plen = req.prompt_len
            C = self.prefill_chunk
            padded = math.ceil(plen / C) * C
            s = pf.chunks_done * C
            ids = np.zeros(C, np.int64)
            seg = req.prompt[s: min(s + C, plen)]
            ids[: len(seg)] = seg
            logits, _ = extend_cache(
                self.model, torch.as_tensor(ids[None], device=self.device),
                pf.cache, s)
            pf.chunks_done += 1
            self.chunks += 1
            if self._registry is not None:
                self._registry.inc("serve.tier_prefill_chunks")
            if s + C < padded:
                continue
            t1 = first_token_from_logits(req, logits[0, plen - 1 - s],
                                         plen, sampling=self.sampling)
            ks, vs = pf.cache[0][:, 0], pf.cache[1][:, 0]
            del self._live[rid]
            self.finished += 1
            out.append((req, pf.attempt, int(t1), ks, vs))
        return out


@dataclasses.dataclass
class Shipment:
    """One prefill→decode KV handoff unit, in host memory.
    ``quant="none"`` ships the exact scratch (the model's compute
    dtype); int8/int4 ship per-head-vector payloads + fp32 scale planes
    (`kv_pool.quantize_heads`)."""
    seq: int
    rid: int
    attempt: int
    t1: int
    quant: str
    ks: torch.Tensor
    vs: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    resend: int = 0

    @property
    def wire_bytes(self) -> int:
        parts = [self.ks, self.vs]
        if self.k_scale is not None:
            parts += [self.k_scale, self.v_scale]
        return sum(t.numel() * t.element_size() for t in parts)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a payload tensor (a fresh tensor even on the CPU,
    so the wire never aliases a scratch)."""
    return t.detach().to("cpu", copy=True)


def pack_shipment(seq: int, req: Request, attempt: int, t1: int,
                  ks: torch.Tensor, vs: torch.Tensor,
                  quant: str = "none") -> Shipment:
    """Pack a prefill payload (device tensors) for the wire: quantize on
    their device (int8: the quantize kernel on the card, one launch each
    for K and V; int4 plain PyTorch), then copy to host memory."""
    if quant not in SHIP_QUANT_MODES:
        raise ValueError(f"ship quant {quant!r} invalid; choices: "
                         f"{SHIP_QUANT_MODES}")
    if quant == "none":
        return Shipment(seq=seq, rid=req.rid, attempt=attempt, t1=t1,
                        quant=quant, ks=_to_host(ks), vs=_to_host(vs))
    bits = 8 if quant == "int8" else 4
    kq, ksc = quantize_heads(ks, bits=bits)
    vq, vsc = quantize_heads(vs, bits=bits)
    return Shipment(seq=seq, rid=req.rid, attempt=attempt, t1=t1,
                    quant=quant, ks=_to_host(kq), vs=_to_host(vq),
                    k_scale=_to_host(ksc), v_scale=_to_host(vsc))


def unpack_shipment(ship: Shipment, device="cpu"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy a wire payload to `device` and unpack it to the dense
    scratch shape the page write takes: the exact wire as shipped, the
    quantized wires dequantized to fp32 (int8: the dequantize kernel on
    the card, one launch each for K and V); the page write casts once
    to the pool's type (or re-quantizes, for a quantized pool)."""
    dev = torch.device(device)
    ks, vs = ship.ks.to(dev), ship.vs.to(dev)
    if ship.quant == "none":
        return ks, vs
    bits = 8 if ship.quant == "int8" else 4
    return (dequantize_heads(ks, ship.k_scale.to(dev), bits=bits),
            dequantize_heads(vs, ship.v_scale.to(dev), bits=bits))


class ShipmentChannel:
    """The deterministic in-process prefill→decode wire: deliveries and
    acks land one coordinator step after their send, with the chaos
    shipment_* kinds consulted per exchange (`FaultPlan.shipment_fault`,
    op ``"ship"`` / ``"ack"``) — a drop loses the message (the sender's
    timeout machinery recovers it), a dup delivers it twice (the
    receiver's dedupe gate absorbs it), a delay defers delivery by
    ceil(delay_s) extra steps."""

    def __init__(self, plan=None, rank: Optional[int] = None):
        self.plan = plan
        self.rank = rank
        self._ships: List[Tuple[int, Shipment]] = []
        self._acks: List[Tuple[int, int]] = []
        self.sent = 0
        self.dropped = 0
        self.duped = 0
        self.delayed = 0
        self.acks_sent = 0
        self.acks_dropped = 0

    def _fault(self, op: str):
        if self.plan is None:
            return None
        return self.plan.shipment_fault(op, self.rank)

    def send(self, ship: Shipment, step: int) -> bool:
        """Put a shipment on the wire at `step`; False = the wire ate
        it (shipment_drop) — the sender keeps it pending and the
        retransmit timeout recovers."""
        self.sent += 1
        spec = self._fault("ship")
        due = step + 1
        if spec is not None and spec.kind == "shipment_drop":
            self.dropped += 1
            return False
        if spec is not None and spec.kind == "shipment_delay":
            due += max(1, math.ceil(spec.delay_s))
            self.delayed += 1
        self._ships.append((due, ship))
        if spec is not None and spec.kind == "shipment_dup":
            self._ships.append((due, ship))
            self.duped += 1
        return True

    def send_ack(self, seq: int, step: int) -> bool:
        """Ack `seq` back to the sender; a dropped ack leaves the
        shipment pending there — the retransmit is then deduped here."""
        self.acks_sent += 1
        spec = self._fault("ack")
        due = step + 1
        if spec is not None and spec.kind == "shipment_drop":
            self.acks_dropped += 1
            return False
        if spec is not None and spec.kind == "shipment_delay":
            due += max(1, math.ceil(spec.delay_s))
        self._acks.append((due, seq))
        if spec is not None and spec.kind == "shipment_dup":
            self._acks.append((due, seq))
        return True

    def requeue(self, ship: Shipment, step: int):
        """Put an undeliverable-right-now shipment (no decode capacity)
        back on the wire for the next step — no fault consult, it
        already survived the wire once."""
        self._ships.append((step + 1, ship))

    def poll(self, step: int) -> Tuple[List[Shipment], List[int]]:
        """Everything due at `step`, in send order (deterministic)."""
        ships = [s for due, s in self._ships if due <= step]
        self._ships = [(d, s) for d, s in self._ships if d > step]
        acks = [a for due, a in self._acks if due <= step]
        self._acks = [(d, a) for d, a in self._acks if d > step]
        return ships, acks

    @property
    def idle(self) -> bool:
        return not self._ships and not self._acks


@dataclasses.dataclass
class _PendingShip:
    """Sender-side bookkeeping for one request's handoff."""
    request: Request
    attempt: int = 0
    deadline: int = 0            # coordinator step the timeout fires at
    shipment: Optional[Shipment] = None
    resends: int = 0


class DisaggCoordinator:
    """Drives one prefill tier + one decode engine through the acked
    shipment protocol on a virtual clock (the engine.run discipline:
    arrivals from ``arrival_t``, time advanced by real step wall cost).

    ``fallback=False`` is the naive no-degradation model: while the
    prefill tier is down, arrivals just wait — the comparison baseline
    the fleet attainment test holds the graceful mode strictly above.
    """

    def __init__(self, prefill: PrefillWorker, decode, *, plan=None,
                 ship_timeout: int = 4, ship_retry: int = 2,
                 ship_quant: Optional[str] = None,
                 fallback: bool = True, rank: Optional[int] = None):
        if ship_timeout < 1:
            raise ValueError(f"ship_timeout must be >= 1, "
                             f"got {ship_timeout}")
        if ship_quant is None:
            ship_quant = flags.str_flag("HETU_TORCH_SERVE_SHIP_QUANT")
        if ship_quant not in SHIP_QUANT_MODES:
            raise ValueError(f"ship_quant {ship_quant!r} invalid; "
                             f"choices: {SHIP_QUANT_MODES}")
        if prefill.device != decode.device:
            raise ValueError(f"the prefill tier lives on {prefill.device}, "
                             f"the decode engine on {decode.device}")
        self.prefill = prefill
        self.decode = decode
        self.plan = plan
        self.ship_timeout = ship_timeout
        self.ship_retry = ship_retry
        self.ship_quant = ship_quant
        self.fallback = fallback
        self.rank = rank
        self.channel = ShipmentChannel(plan=plan, rank=rank)
        self._registry = decode.registry
        # the prefill TIER's flight recorder (only when the decode
        # engine's own tracer is on — same HETU_TORCH_SERVE_TRACE gate):
        # each prefill incarnation of a request is its own hop trace
        # (tier="prefill") of queued -> prefill -> done("shipped"), so
        # FleetTrace.stitch sees the remote prompt work as a first-class
        # node with a ship edge into the decode hop
        self.pf_tracer = None
        if decode.tracer is not None:
            self.pf_tracer = RequestTracer(
                run_log=decode.run_log, registry=self._registry,
                keep=True, tier="prefill", replica=rank,
                clock=decode.clock_basis)
        self._now = 0.0
        self._seq = 0
        self._arrivals: Deque[Request] = collections.deque()
        self._awaiting: Dict[int, _PendingShip] = {}
        self._finished: set = set()
        self._step_idx = 0
        self.degraded = False
        self.degraded_steps = 0
        self.degraded_s = 0.0
        self._degraded_t0: Optional[float] = None
        self.colocated = 0
        self.reprefills = 0
        self.ship_dedups = 0
        self.adoptions = 0
        self.ship_bytes = 0
        self.steps_done = 0
        #: per shipment: pack wall (quantize + copy to host), adopt wall
        #: (copy back + unpack + page write) and the pack-to-adopt wall
        #: (which holds the wire's step of latency)
        self.ship_pack_s: List[float] = []
        self.ship_adopt_s: List[float] = []
        self.ship_wall_s: List[float] = []
        self._packed_at: Dict[int, float] = {}
        #: payloads packed (one a finished prefill) and unpacked (one an
        #: adoption: a delivery is unpacked only once the decode engine
        #: granted it a slot)
        self.packs = 0
        self.unpacks = 0

    # ----------------------------------------------------------- intake
    def submit(self, req: Request, now: Optional[float] = None):
        """Accept a request into the two-tier pipeline: submission
        accounting (and the tracer's queued span) land on the decode
        replica that will own it; routing — prefill tier vs colocated
        fallback — happens at the next coordinator step so it sees the
        current degraded state."""
        self.decode.note_remote_submit(req, now)
        self._arrivals.append(req)

    # ----------------------------------------------------------- faults
    def kill_prefill_tier(self):
        """The prefill tier dies (chaos ``prefill_kill``): every
        in-flight and queued prefill is lost.  Their pending entries'
        timeouts are pulled forward to THIS step — the protocol's
        recovery path (resend has nothing to resend, so each re-prefills
        under the retry budget) runs immediately instead of waiting out
        the timer."""
        lost = self.prefill.kill()
        self._registry.inc("serve.prefill_tier_kills")
        for rid in lost:
            p = self._awaiting.get(rid)
            if p is not None and p.shipment is None:
                p.deadline = self._step_idx
            self._pf_close(rid, self._now, reason="prefill_kill")
        return lost

    def _enter_degraded(self, now: float):
        self.degraded = True
        self._degraded_t0 = now
        self._registry.inc("serve.degraded_entries")
        self.decode._log_serve(event="degraded", state="enter", now=now,
                               queue_depth=self.decode.scheduler
                               .queue_depth)

    def _exit_degraded(self, now: float):
        self.degraded = False
        span = now - (self._degraded_t0 or now)
        self.degraded_s += span
        self._degraded_t0 = None
        self.decode._log_serve(event="degraded", state="exit", now=now,
                               degraded_s=span)

    # ---------------------------------------------------------- routing
    def _fallback_submit(self, req: Request, now: float):
        """Colocated chunked prefill on the decode engine (graceful
        degradation): the request enters the decode scheduler's own
        queue — submission was already accounted at `submit`, so only
        the queue entry and the sticky stall reason land here."""
        self.decode.scheduler.submit(req)
        self.colocated += 1
        self._registry.inc("serve.colocated_prefills")
        if self.decode.tracer is not None:
            self.decode.tracer.on_stall([req.rid], "prefill_tier_down")

    # --------------------------------------- prefill-tier hop tracing
    def _pf_close(self, rid: int, now: float, *, reason: str):
        """Close a still-open prefill hop with an ``evicted`` terminal
        (the tier died / the request re-prefills) so the hop's spans
        stay a complete, stitchable trace."""
        if self.pf_tracer is None or rid not in self.pf_tracer._open:
            return
        st = self.pf_tracer._open[rid]
        p = self._awaiting.get(rid)
        req = p.request if p is not None else None
        if req is None:
            req = Request(rid=rid, prompt=np.zeros(1, np.int32),
                          max_new_tokens=1)
        now = max(now, st.last_t)
        self.pf_tracer.on_finish(req, None, reason, now, tokens=0,
                                 evicted=True)

    def _pf_observe_admissions(self, now: float):
        """Prefill-tier admissions happen inside the worker's step;
        close the hop's queued span the first time we see the rid live
        (its first chunk lands this same step)."""
        if self.pf_tracer is None:
            return
        for rid, pf in self.prefill._live.items():
            st = self.pf_tracer._open.get(rid)
            if st is not None and st.phase == "queued":
                self.pf_tracer.on_admit(pf.request, None, now)

    def _pf_shipped(self, req: Request, now: float):
        """The hop's terminal: the finished scratch went on the wire —
        prefill span closes at the ship and the hop ends ``done``
        (reason ``shipped``), the source node of the stitcher's
        ship -> adopt edge."""
        if self.pf_tracer is None or req.rid not in self.pf_tracer._open:
            return
        st = self.pf_tracer._open[req.rid]
        if st.phase == "queued":     # admitted+finished in one step
            self.pf_tracer.on_admit(req, None, now)
        chunks = math.ceil(req.prompt_len / self.prefill.prefill_chunk)
        self.pf_tracer.on_first_token(req, None, now, chunk=chunks)
        self.pf_tracer.on_finish(req, None, "shipped", now, tokens=0)

    def _route(self, req: Request, now: float, attempt: int = 0):
        if self.degraded and self.fallback:
            self._awaiting.pop(req.rid, None)
            if self.decode._sampled(req.rid):
                self.decode._log_serve(event="dispatch", req=req.rid,
                                       tier="decode", now=now,
                                       fallback=True)
            self._fallback_submit(req, now)
            return
        self.prefill.submit(req, attempt=attempt)
        if self.pf_tracer is not None:
            self.pf_tracer.on_submit(req, at=now)
        if self.decode._sampled(req.rid):
            self.decode._log_serve(event="dispatch", req=req.rid,
                                   tier="prefill", now=now,
                                   **({"attempt": attempt}
                                      if attempt else {}))
        p = self._awaiting.get(req.rid)
        if p is None:
            p = self._awaiting[req.rid] = _PendingShip(request=req)
        p.attempt = attempt
        p.shipment = None
        p.resends = 0
        p.deadline = self._step_idx + self.ship_timeout

    def _log_ship(self, ship: Shipment, now: float, **extra):
        if self.decode._sampled(ship.rid):
            self.decode._log_serve(event="ship", req=ship.rid,
                                   seq=ship.seq, attempt=ship.attempt,
                                   resend=ship.resend, now=now,
                                   quant=ship.quant, **extra)

    def _reprefill(self, rid: int, p: _PendingShip, now: float):
        """The give-up path: the shipment (or the prefill itself) is
        unrecoverable — re-prefill under the decode engine's retry
        budget, or terminate ``retry_exhausted`` past it.  The retry
        rides the same `scheduler.retries` / ``retry`` serve-event
        `attempt` machinery replica failover uses, so done events carry
        the full attempt history either way."""
        sched = self.decode.scheduler
        req = p.request
        self._pf_close(rid, now, reason="reprefill")
        retries = sched.retries.get(rid, 0)
        if retries >= self.decode.config.retry_budget:
            self.prefill.drop(rid)
            self._awaiting.pop(rid, None)
            self._finished.add(rid)
            if self.decode.tracer is not None:
                self.decode.tracer.on_finish(
                    req, -1, "retry_exhausted", now, tokens=0,
                    e2e_s=now - float(req.arrival_t), evicted=True)
            self.decode._finish_faulted(
                req, now, self.decode._fault_results,
                reason="retry_exhausted", event="evict", tokens=[])
            return
        sched.retries[rid] = retries + 1
        self.reprefills += 1
        self._registry.inc("serve.disagg_reprefills")
        if self.decode._sampled(rid):
            self.decode._log_serve(event="retry", req=rid, now=now,
                                   attempt=retries + 1, ship=True,
                                   tokens_discarded=0,
                                   slo_class=req.slo.name,
                                   tenant=req.tenant,
                                   **self.decode._weight_fields())
        self.prefill.drop(rid)
        self._route(req, now, attempt=p.attempt + 1)

    # ------------------------------------------------------------- step
    def step(self, now: float) -> List[RequestResult]:
        """One coordinator iteration: chaos, degraded-state transitions,
        arrival routing, one prefill-tier step, wire deliveries +
        adoption, ack/timeout processing, then one decode-engine step."""
        step_idx = self._step_idx
        self._now = now
        chaos = maybe_chaos_disagg(self.plan, self, step_idx,
                                   self.rank)
        down = chaos["prefill_down"]
        if down and not self.degraded:
            self._enter_degraded(now)
        elif not down and self.degraded:
            self._exit_degraded(now)
        if self.degraded:
            self.degraded_steps += 1

        while self._arrivals:
            req = self._arrivals[0]
            if self.degraded and not self.fallback:
                break               # naive model: wait out the outage
            self._arrivals.popleft()
            self._route(req, now)

        if not down:
            finished_pf = self.prefill.step()
            self._pf_observe_admissions(now)
            for req, attempt, t1, ks, vs in finished_pf:
                self._seq += 1
                tp = time.perf_counter()
                ship = pack_shipment(self._seq, req, attempt, t1, ks,
                                     vs, quant=self.ship_quant)
                self.packs += 1
                self.ship_pack_s.append(time.perf_counter() - tp)
                self._packed_at[ship.seq] = tp
                p = self._awaiting.get(req.rid)
                if p is None:       # dropped/terminated meanwhile
                    self._pf_close(req.rid, now, reason="dropped")
                    continue
                self._pf_shipped(req, now)
                p.shipment = ship
                p.deadline = step_idx + self.ship_timeout
                self.ship_bytes += ship.wire_bytes
                self._registry.inc("serve.ship_sent")
                self._log_ship(ship, now)
                self.channel.send(ship, step_idx)

        ships, acks = self.channel.poll(step_idx)
        sched = self.decode.scheduler
        for ship in ships:
            rid = ship.rid
            if rid in self._finished or rid not in self._awaiting:
                # a late duplicate of a request that already completed
                # its handoff — dedupe, but still ack (the sender may
                # not have heard yet)
                self.ship_dedups += 1
                self._registry.inc("serve.ship_dedups")
                self._log_ship(ship, now, dedup=True)
                self.channel.send_ack(ship.seq, step_idx)
                continue
            if not sched.apply_shipment(rid, ship.seq):
                self.ship_dedups += 1
                self._registry.inc("serve.ship_dedups")
                self._log_ship(ship, now, dedup=True)
                self.channel.send_ack(ship.seq, step_idx)
                continue
            req = self._awaiting[rid].request
            ta = time.perf_counter()

            def unpack(ship=ship):
                # once the decode engine granted a slot: a delivery that
                # finds no capacity is neither copied back nor unpacked
                self.unpacks += 1
                return unpack_shipment(ship, self.decode.device)
            if not self.decode.adopt_prefilled(req, unpack, ship.t1, now):
                # no decode capacity right now: un-burn the seq, put
                # the delivery back for next step, and push the sender
                # deadline — the shipment is safely on the in-process
                # wire, so a retransmit would only add dedupe noise
                sched.unapply_shipment(rid, ship.seq)
                self.channel.requeue(ship, step_idx)
                self._awaiting[rid].deadline = \
                    step_idx + self.ship_timeout
                continue
            self.decode._sync()
            t_end = time.perf_counter()
            self.ship_adopt_s.append(t_end - ta)
            self.ship_wall_s.append(t_end - self._packed_at.pop(ship.seq,
                                                                 ta))
            self.adoptions += 1
            self.channel.send_ack(ship.seq, step_idx)
        for seq in acks:
            for rid, p in list(self._awaiting.items()):
                if p.shipment is not None and p.shipment.seq == seq:
                    del self._awaiting[rid]
                    self._registry.inc("serve.ship_acked")
                    break

        for rid, p in list(self._awaiting.items()):
            if step_idx < p.deadline:
                continue
            live = any(st is not None and st.request.rid == rid
                       for st in sched.slots)
            if rid in self._finished or live:
                # adopted but the ack went missing: retransmit so the
                # receiver's dedupe gate re-acks; past the budget the
                # in-process sender may trust local state and stand down
                if p.shipment is not None and p.resends < self.ship_retry:
                    p.resends += 1
                    p.shipment.resend += 1
                    p.deadline = step_idx + self.ship_timeout
                    self._registry.inc("serve.ship_resends")
                    self._log_ship(p.shipment, now)
                    self.channel.send(p.shipment, step_idx)
                else:
                    del self._awaiting[rid]
                continue
            if p.shipment is not None and p.resends < self.ship_retry:
                p.resends += 1
                p.shipment.resend += 1
                p.deadline = step_idx + self.ship_timeout
                self._registry.inc("serve.ship_resends")
                self._log_ship(p.shipment, now)
                self.channel.send(p.shipment, step_idx)
            elif p.shipment is None and self.prefill.has(rid):
                # no shipment yet but the (live) prefill tier still
                # holds the request — it is queued/advancing, not lost;
                # only a kill clears the worker and lets the timer fire
                p.deadline = step_idx + self.ship_timeout
            else:
                self._reprefill(rid, p, now)

        results = self.decode.step(now)
        for r in results:
            self._finished.add(r.rid)
            self._awaiting.pop(r.rid, None)
            sched.ship_forget(r.rid)
        self._step_idx += 1
        self.steps_done += 1
        return results

    # -------------------------------------------------------------- run
    @property
    def idle(self) -> bool:
        return (not self._arrivals and not self._awaiting
                and self.prefill.idle and self.channel.idle
                and not self.decode.scheduler.active_slots()
                and not self.decode.scheduler.queue
                and not self.decode._fault_results)

    def run(self, requests: Sequence[Request], *, start: float = 0.0,
            on_step=None) -> List[RequestResult]:
        """Drive the two-tier pipeline over a request trace to
        completion (the engine.run contract: virtual arrivals, wall-cost
        clock, ``on_step(i)`` inside the timed window)."""
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
            if on_step is not None:
                self.decode._last_clock = max(
                    self.decode._last_clock, now)
                on_step(self._step_idx)
            results.extend(self.step(now))
            now += time.perf_counter() - t0
        if self.degraded:
            self._exit_degraded(now)
            self.degraded = True        # state stands; metering flushed
        n_tokens = sum(len(r.tokens) for r in results)
        elapsed = max(now - start, 1e-9)
        self.decode._log_serve(event="report", requests=len(results),
                               tokens=n_tokens, elapsed_s=elapsed,
                               now=now,
                               tokens_per_s=n_tokens / elapsed)
        return sorted(results, key=lambda r: r.rid)

    def summary(self) -> Dict[str, object]:
        """Protocol + degradation accounting for reports and tests."""
        return {
            "ship_sent": self.channel.sent,
            "ship_dropped": self.channel.dropped,
            "ship_duped": self.channel.duped,
            "ship_delayed": self.channel.delayed,
            "ship_dedups": self.ship_dedups,
            "ship_resends": self._registry_count("serve.ship_resends"),
            "adoptions": self.adoptions,
            "reprefills": self.reprefills,
            "colocated": self.colocated,
            "degraded_steps": self.degraded_steps,
            "degraded_s": self.degraded_s,
            "ship_bytes": self.ship_bytes,
            "sched_ship_dedups": self.decode.scheduler.ship_dedups,
        }

    def _registry_count(self, name: str) -> int:
        for c in self._registry.snapshot()["counters"]:
            if c["name"] == name:
                return int(c["value"])
        return 0
