"""Fleet observatory: a seeded discrete-event simulator driving the REAL
serving state machines hardware-free.

ROADMAP item 1's proving ground: every fleet-scale policy question
(multi-tenant quotas, preemption fairness, prefix-cache sizing) is
answered by replaying 10^6+ requests through the SAME host-side state
machines the live engine runs — `Scheduler` (admission, reserve-on-
admit, preemption), `PagePool`/`RadixPrefixCache` (COW refcounts, LRU
eviction), `RequestTracer` spans and the SLO/priority policies — under a
virtual clock whose per-step service times come from a pluggable
analytic `ServiceModel` (the bench.py ``detail.serving`` roofline:
params read once per step, every slot reads its context KV), NOT from
running any jax program.  No jax math anywhere in the hot loop: a
million requests complete in seconds, and `check_invariants()` + span
reconciliation fuzz at a scale the jitted tests cannot reach.

What is simulated vs real:

* REAL: admission order, page allocation/eviction/refcounts, tenant
  quotas, preemption victims, span tiling, stall attribution — every
  policy decision is made by the production code path.
* MODELED: step durations (`ServiceModel` roofline) and token values
  (requests always finish by length; no logits exist).  A chaos
  `FaultPlan`'s ``slow_worker``/``decode_stall`` windows inflate the
  modeled step time exactly like the engine's on_step hook inflates
  the wall clock, and its ``engine_kill`` specs drive replica
  death/rejoin: at ``at_step`` every in-flight request is requeued
  under the retry budget (or terminated ``retry_exhausted``), and
  admissions stay suspended for the spec's ``count``-step down-window
  until the replica rejoins.  Deadlines and brownout shedding run the
  same policy code shape as the live engine (docs/fault_tolerance.md).

Accounting is EXACT regardless of RunLog sampling: per-(tenant, class)
aggregates (attainment, goodput, latency reservoirs, stall and cost
attribution) are accumulated in memory for every request, while serve
events / spans are emitted for a deterministic 1-in-N sample of
requests (``HETU_TORCH_RUNLOG_SERVE_SAMPLE``) with ``sample_weight`` so
`slo_report.py` stays unbiased.  The report is derived ONLY from the
virtual clock — same seed + trace, byte-identical `tools_fleet.py
--json` output (docs/serving.md).

Copied from `hetu_tpu/serving/fleet.py` (host-only code; the port keeps
its own copy so it never imports the JAX package). The default chip is
`H100_PROFILE` (datasheet peaks); `hw=` overrides it.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

from hetu_tpu_torch.obs.metrics import Histogram
from hetu_tpu_torch.obs.spans import _EDGE_EVENTS, FleetTrace
from hetu_tpu_torch.serving.costs import COST_FIELDS, CostLedger, CostModel
from hetu_tpu_torch.serving.kv_pool import PagePool, kv_bytes_per_token
from hetu_tpu_torch.serving.request import Request, TenantQuota, rid_sampled
from hetu_tpu_torch.serving.scheduler import Scheduler
from hetu_tpu_torch.serving.tracing import RequestTracer

#: the default chip of `ServiceModel.from_hardware_profile`: NVIDIA H100
#: 80GB HBM3 (SXM, 700 W) DATASHEET peaks — dense bf16 tensor-core
#: FLOP/s and HBM3 bandwidth — not a measurement on the card.  Pass
#: `hw=` for any other profile.
H100_PROFILE = {"chip": "NVIDIA H100 80GB HBM3, 700 W",
                "source": "datasheet", "bf16_tflops": 989.0,
                "hbm_gbps": 3350.0}

#: bump when the fleet report's JSON shape changes
#: (2: faults.tokens_discarded + the two-tier `disagg` section)
FLEET_SCHEMA = 2


@dataclasses.dataclass(frozen=True)
class ServiceModel:
    """Analytic per-step service times: the roofline bench.py's
    ``detail.serving`` record prices decode with (params read once per
    step, each slot reads its own context KV; FLOPs = 2N per token +
    4*L*hidden per cached position), turned into a pluggable clock for
    the simulator.  Frozen + pure arithmetic — deterministic and safe
    in the 10^6-request hot loop."""
    #: matmul FLOPs per computed token (2 * N_params)
    flops_per_token: float
    #: attention FLOPs per computed token per cached context position
    attn_flops_per_ctx: float
    #: parameter bytes streamed once per step (bf16 = 2 * N_params)
    param_bytes: float
    #: cache bytes per resident token position (kv_pool byte model)
    kv_bytes_per_token: float
    #: chip peak (obs/mfu hardware profile)
    peak_flops: float
    hbm_bytes_per_s: float
    #: fixed per-step host/dispatch overhead
    step_overhead_s: float = 50e-6

    @staticmethod
    def from_hardware_profile(*, num_params: float, num_layers: int,
                              hidden_size: int, num_kv_heads: int,
                              head_dim: int, kv_mode: str = "fp16",
                              hw: Optional[dict] = None,
                              step_overhead_s: float = 50e-6
                              ) -> "ServiceModel":
        """Calibrate from a chip profile + model dimensions.  `hw` is a
        dict with ``bf16_tflops`` and ``hbm_gbps``; the default is
        `H100_PROFILE`, the card's datasheet peaks."""
        if hw is None:
            hw = H100_PROFILE
        return ServiceModel(
            flops_per_token=2.0 * float(num_params),
            attn_flops_per_ctx=4.0 * num_layers * hidden_size,
            param_bytes=2.0 * float(num_params),
            kv_bytes_per_token=kv_bytes_per_token(
                num_layers, num_kv_heads, head_dim, kv_mode),
            peak_flops=float(hw["bf16_tflops"]) * 1e12,
            hbm_bytes_per_s=float(hw["hbm_gbps"]) * 1e9,
            step_overhead_s=step_overhead_s)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def prefill_chunk_s(self, chunk: int, ctx: int) -> float:
        """One padded prefill chunk of `chunk` tokens starting at cache
        position `ctx` (static shapes: the PADDED chunk runs)."""
        flops = (self.flops_per_token * chunk
                 + self.attn_flops_per_ctx
                 * (ctx * chunk + chunk * (chunk - 1) / 2.0))
        bytes_ = (self.param_bytes
                  + (ctx + chunk) * self.kv_bytes_per_token)
        return max(flops / self.peak_flops,
                   bytes_ / self.hbm_bytes_per_s) + self.step_overhead_s

    def decode_step_s(self, slots: int, kv_tokens: int) -> float:
        """One batched decode step: `slots` active rows, `kv_tokens`
        total resident context positions read."""
        if slots <= 0:
            return 0.0
        flops = (self.flops_per_token * slots
                 + self.attn_flops_per_ctx * kv_tokens)
        bytes_ = self.param_bytes + kv_tokens * self.kv_bytes_per_token
        return max(flops / self.peak_flops,
                   bytes_ / self.hbm_bytes_per_s) + self.step_overhead_s


def analytic_models(*, num_params: float, num_layers: int,
                    hidden_size: int, num_kv_heads: int, head_dim: int,
                    page_size: int, kv_mode: str = "fp16",
                    hw: Optional[dict] = None
                    ) -> "tuple[ServiceModel, CostModel]":
    """The matched (ServiceModel, CostModel) pair for one model+chip:
    time and cost priced from the same dimensions, so a fleet report's
    latency and FLOPs columns describe the same machine."""
    svc = ServiceModel.from_hardware_profile(
        num_params=num_params, num_layers=num_layers,
        hidden_size=hidden_size, num_kv_heads=num_kv_heads,
        head_dim=head_dim, kv_mode=kv_mode, hw=hw)
    cost = CostModel.from_model_dims(
        num_params=num_params, num_layers=num_layers,
        hidden_size=hidden_size, num_kv_heads=num_kv_heads,
        head_dim=head_dim, page_size=page_size, kv_mode=kv_mode)
    return svc, cost


@dataclasses.dataclass
class FleetConfig:
    """Simulator shape — mirrors ServeConfig's host-side knobs (the sim
    has no device-side ones)."""
    num_slots: int = 64
    page_size: int = 16
    max_len: int = 512
    prefill_chunk: int = 64
    num_pages: int = 0            # 0 = full reservation for every slot
    prefix_cache: bool = False
    prefix_cache_pages: int = 0   # 0 = unbounded (insert-budget off)
    preempt: bool = False
    quotas: Dict[str, TenantQuota] = dataclasses.field(default_factory=dict)
    #: run check_invariants() every N sim steps (plus once at the end);
    #: 0 disables the periodic sweep (the final check still runs)
    invariant_every: int = 997
    #: serve-event/span sampling: 1-in-N requests reach the RunLog/
    #: tracer; 0 = read HETU_TORCH_RUNLOG_SERVE_SAMPLE (default 1 = all)
    sample: int = 0
    # -- the fault-tolerance layer (same knobs as ServeConfig)
    #: replica-death requeues allowed per request before it terminates
    #: ``retry_exhausted`` (chaos engine_kill; 0 = no retries)
    retry_budget: int = 0
    #: enforce SLOClass.deadline_s (expired requests terminate
    #: ``deadline_exceeded``)
    deadline: bool = False
    #: sustained-pressure shedding of the lowest-priority queued band
    brownout: bool = False
    brownout_page_high: float = 0.95
    brownout_queue_min: int = 1
    brownout_streak: int = 4
    # -- disaggregated prefill/decode tiers (serving/disagg.py on the
    #    analytic clock: prompts prefill on a separate tier that runs
    #    CONCURRENTLY with decode, and finished KV ships over an acked
    #    at-least-once wire driven by the chaos shipment_* kinds)
    disagg: bool = False
    #: prefill-tier width (concurrent prefills); 0 = num_slots
    prefill_slots: int = 0
    #: modeled one-way wire latency per shipment delivery
    ship_latency_s: float = 500e-6
    #: virtual seconds before an un-acked shipment retransmits (and,
    #: past ``ship_retry`` resends, the request re-prefills under the
    #: retry budget)
    ship_timeout_s: float = 0.05
    ship_retry: int = 2
    #: dead prefill tier: True (default) degrades to colocated chunked
    #: prefill on the decode tier; False is the naive model — arrivals
    #: wait out the outage (the comparison baseline)
    fallback: bool = True


class _Bucket:
    """Exact per-(tenant, class) accumulator — every request lands here
    regardless of RunLog sampling."""

    __slots__ = ("requests", "tokens", "slo_ok", "goodput_tokens",
                 "preemptions", "retries", "faults", "stalls", "ttft",
                 "e2e", "queue_wait", "costs")

    def __init__(self):
        self.requests = 0
        self.tokens = 0
        self.slo_ok = 0
        self.goodput_tokens = 0
        self.preemptions = 0
        self.retries = 0
        self.faults: Dict[str, int] = {}
        self.stalls: Dict[str, int] = {}
        # seeded reservoirs: deterministic percentiles at any count
        self.ttft = Histogram()
        self.e2e = Histogram()
        self.queue_wait = Histogram()
        self.costs = {k: 0.0 for k in COST_FIELDS}


def _merge_hist(dst: Histogram, src: Histogram):
    """Fold `src`'s reservoir + exact running stats into `dst` (used to
    roll per-(tenant, class) buckets up to per-tenant / per-class rows).
    The merged reservoir is approximate but deterministic; count/total/
    min/max stay exact."""
    for v in src._sample:
        dst.observe(v)
    # the observes above counted only the reservoir; correct the running
    # stats to src's exact values
    dst.count += src.count - len(src._sample)
    dst.total += src.total - sum(src._sample)
    if src.vmin is not None:
        dst.vmin = (src.vmin if dst.vmin is None
                    else min(dst.vmin, src.vmin))
    if src.vmax is not None:
        dst.vmax = (src.vmax if dst.vmax is None
                    else max(dst.vmax, src.vmax))


def _hist_summary(h: Histogram) -> Optional[Dict[str, Any]]:
    if not h.count:
        return None
    return {"mean": h.total / h.count, "p50": h.percentile(50),
            "p95": h.percentile(95), "p99": h.percentile(99),
            "max": h.vmax}


class FleetSimulator:
    """Discrete-event replay of a request trace through the production
    scheduler/page-pool/prefix-cache/preemption machinery.

    One instance = one run: construct, `run(requests)`, read the
    returned report (or `report()` again later).  Wire a RunLog to get
    the sampled serve/span event stream every serving tool understands;
    wire a chaos `FaultPlan` to inflate service times through its
    ``slow_worker`` windows (`step_delay`)."""

    def __init__(self, service: ServiceModel, *,
                 config: Optional[FleetConfig] = None,
                 cost_model: Optional[CostModel] = None,
                 run_log=None, registry=None, fault_plan=None):
        cfg = config or FleetConfig()
        self.cfg = cfg
        self.service = service
        self.run_log = run_log
        self.registry = registry
        self.fault_plan = fault_plan
        pages = cfg.num_pages or cfg.num_slots * (cfg.max_len
                                                  // cfg.page_size)
        # the REAL pool/scheduler/cache — host-side only (no device
        # arrays): policy decisions come from the production code path
        self.pool = PagePool(num_layers=1, num_pages=pages,
                             page_size=cfg.page_size, num_kv_heads=1,
                             head_dim=1, device_arrays=False)
        self.prefix_cache = None
        if cfg.prefix_cache:
            from hetu_tpu_torch.serving.prefix_cache import RadixPrefixCache
            self.prefix_cache = RadixPrefixCache(
                self.pool, max_pages=cfg.prefix_cache_pages)
        self.sched = Scheduler(num_slots=cfg.num_slots, pool=self.pool,
                               max_len=cfg.max_len,
                               prefix_cache=self.prefix_cache,
                               quotas=cfg.quotas,
                               retry_budget=cfg.retry_budget)
        self.ledger = (CostLedger(cost_model)
                       if cost_model is not None else None)
        if cfg.sample:
            self.sample = cfg.sample
        else:
            from hetu_tpu_torch.utils import flags
            self.sample = max(
                1, flags.int_flag("HETU_TORCH_RUNLOG_SERVE_SAMPLE"))
        # the real flight recorder over the SAMPLED requests (keep=True:
        # the end-of-run reconciliation sweep reads the kept traces);
        # stamped with its hop identity so the kept spans stitch
        self.tracer = RequestTracer(run_log=run_log, keep=True,
                                    max_kept=1 << 20, tier="decode")
        #: a SECOND flight recorder for the prefill tier (cfg.disagg):
        #: a rid's prefill incarnations must be separate HOPS in the
        #: stitched fleet trace, not collide with its decode trace.
        #: In-memory only — the end-of-run stitch reads it directly;
        #: the runlog keeps its established record stream.
        self.pf_tracer = (RequestTracer(keep=True, max_kept=1 << 20,
                                        tier="prefill", replica=0)
                          if cfg.disagg else None)
        #: the frontend/shipment EDGE events (dispatch/ship/retry/
        #: admit), captured in memory so `FleetTrace.stitch` can build
        #: the causal DAG without a runlog round-trip
        self._events: List[Dict[str, Any]] = []
        # ---- exact accounting (per request, sampling-independent)
        self._buckets: Dict[tuple, _Bucket] = {}
        self._first_reason: Dict[int, str] = {}
        self._enter_seq: Dict[int, int] = {}
        self._preempt_counts: Dict[int, int] = {}
        #: sticky requeue attribution per rid (preempted/replica_lost) —
        #: the reason the next admission's queued span carries
        self._requeue_reason: Dict[int, str] = {}
        self._stall_seq = 0
        self._stall_reason = "none"
        self.stall_steps: Dict[str, int] = {}
        self.quota_peaks: Dict[str, Dict[str, int]] = {}
        self.submitted = 0
        self.completed = 0
        self.tokens_out = 0
        self.prefill_chunks = 0
        self.preemptions = 0
        # fault-layer accounting (chaos engine_kill / deadlines /
        # brownout): `faulted` counts every fault termination — the
        # run-loop progress check includes it, so a sweep that only
        # expires requests still counts as progress
        self.failovers = 0
        self.replica_requeues = 0
        self.retry_exhausted = 0
        self.expired = 0
        self.shed = 0
        self.faulted = 0
        self._brownout_hot = 0
        #: tokens emitted (counted in tokens_out) whose work was later
        #: discarded — a preemption or a replica-death requeue threw the
        #: partial stream away and the replay re-emits it.  The exact
        #: reconciliation: tokens_out == sum(bucket tokens) + this.
        self.tokens_discarded = 0
        # ---- disaggregated prefill tier (cfg.disagg)
        self._pf_slots = cfg.prefill_slots or cfg.num_slots
        self._pf_arrivals: List[Request] = []
        self._pf_queue: collections.deque = collections.deque()
        self._pf_live: Dict[int, list] = {}   # rid -> [req, chunks, att]
        self._pf_awaiting: Dict[int, dict] = {}
        #: rids with a FINITE deadline (shipped, or lost to a tier
        #: kill) — the per-step timeout scan walks only these, not the
        #: whole awaiting backlog (O(queue) x O(steps) at fleet scale);
        #: a dict, not a set, so iteration order is insertion order and
        #: the determinism golden holds
        self._pf_armed: Dict[int, None] = {}
        self._pf_wire: List[dict] = []        # in-flight shipments
        self._pf_finished: set = set()
        self._pf_seq = 0
        self._pf_degraded = False
        self._pf_degraded_t0 = 0.0
        self.tier_prefill_chunks = 0
        self.ship_sent = 0
        self.ship_dropped = 0
        self.ship_duped = 0
        self.ship_delayed = 0
        self.ship_dedups = 0
        self.ship_resends = 0
        self.adoptions = 0
        self.reprefills = 0
        self.colocated = 0
        self.prefill_kills = 0
        self.degraded_entries = 0
        self.degraded_steps = 0
        self.degraded_s = 0.0
        self.steps = 0
        self.invariant_checks = 0
        self._start = 0.0
        self._end = 0.0

    # ------------------------------------------------------------ utils
    def _sampled(self, rid: int) -> bool:
        return rid_sampled(rid, self.sample)

    def _weight_fields(self) -> Dict[str, Any]:
        return {"sample_weight": self.sample} if self.sample > 1 else {}

    def _bucket(self, tenant: str, cls: str) -> _Bucket:
        b = self._buckets.get((tenant, cls))
        if b is None:
            b = self._buckets[(tenant, cls)] = _Bucket()
        return b

    def _log(self, **fields):
        if fields.get("event") in _EDGE_EVENTS:
            # the stitcher's causal-edge vocabulary rides the same
            # serve events the runlog gets — captured unconditionally
            # so runlog-less sims still stitch
            self._events.append(dict(fields))
        if self.run_log is not None:
            self.run_log.log("serve", **fields)

    # -------------------------------------------------------- lifecycle
    def _submit(self, req: Request):
        if self.cfg.disagg:
            # two-tier intake: the request heads to the prefill tier
            # (or the colocation fallback) at the next sim step —
            # submission accounting and the queued span open here
            self._pf_arrivals.append(req)
        else:
            self.sched.submit(req)
        self.submitted += 1
        self._enter_seq[req.rid] = self._stall_seq
        if self._sampled(req.rid):
            self.tracer.on_submit(req)

    def _queued_reason(self, rid: int) -> str:
        """The stall-attribution reason the tracer would have stamped on
        this request — computed lazily at admission (O(1) per request)
        instead of walking the whole queue every stalled step: a stall
        event is global to the FIFO queue, so 'the last stall observed
        while this request was queued' is exactly 'the last global stall
        if any occurred after it entered'.  A requeue reason
        (``preempted`` / ``replica_lost``) is sticky — latest requeue
        wins — matching RequestTracer.on_stall."""
        requeue = self._requeue_reason.get(rid)
        if requeue is not None:
            return requeue
        if self._stall_seq > self._enter_seq.get(rid, self._stall_seq):
            return self._stall_reason
        return "none"

    def _on_admit(self, slot_idx: int, st, now: float):
        req = st.request
        rid = req.rid
        reason = self._queued_reason(rid)
        # stall attribution reported per request = the FIRST admission's
        # wait (what collect_traces' RequestTrace.stall_reason reads)
        self._first_reason.setdefault(rid, reason)
        self._enter_seq.pop(rid, None)
        st.prefilling = True
        if self.ledger is not None:
            self.ledger.on_admit(rid, len(st.pages), now)
        t = req.tenant
        peaks = self.quota_peaks.get(t)
        if peaks is None:
            peaks = self.quota_peaks[t] = {"slots": 0, "pages": 0}
        peaks["slots"] = max(peaks["slots"],
                             self.sched.tenant_slots.get(t, 0))
        peaks["pages"] = max(peaks["pages"],
                             self.sched.tenant_pages.get(t, 0))
        if self._sampled(rid):
            if reason != "none":
                self.tracer.on_stall([rid], reason)
            self.tracer.on_admit(req, slot_idx, now,
                                 shared_tokens=st.shared_tokens)

    def _try_preempt(self, now: float) -> bool:
        head = self.sched.queue[0]
        victim = self.sched.preempt_victim(head.slo.priority)
        if victim is None:
            return False
        st = self.sched.slots[victim]
        req = st.request
        rid = req.rid
        self._preempt_counts[rid] = self._preempt_counts.get(rid, 0) + 1
        self.preemptions += 1
        if self.ledger is not None:
            self.ledger.on_preempt(rid, now, ctx_start=st.shared_tokens,
                                   tokens_cached=st.pos)
        tokens_discarded = len(st.generated)
        self.tokens_discarded += tokens_discarded
        self.sched.preempt(victim)
        self._enter_seq[rid] = self._stall_seq
        self._requeue_reason[rid] = "preempted"
        b = self._bucket(req.tenant, req.slo.name)
        b.preemptions += 1
        if self._sampled(rid):
            self.tracer.on_preempt(req, victim, now, by=head.rid)
            self._log(event="preempt", req=rid, slot=victim,
                      by=head.rid, by_class=head.slo.name,
                      slo_class=req.slo.name, tenant=req.tenant, now=now,
                      tokens_discarded=tokens_discarded,
                      queue_depth=self.sched.queue_depth,
                      **self._weight_fields())
        return True

    def _advance_prefill(self, slot_idx: int, st, now: float) -> float:
        """One (padded) prefill chunk; on the final chunk the first
        token is emitted — same per-step contract as the engine."""
        req = st.request
        plen = req.prompt_len
        C = self.cfg.prefill_chunk
        base = st.shared_tokens
        s = base + st.chunks_done * C
        dt = self.service.prefill_chunk_s(C, s)
        st.chunks_done += 1
        st.stats.prefill_chunks += 1
        self.prefill_chunks += 1
        padded = base + math.ceil((plen - base) / C) * C
        if s + C < padded:
            if self._sampled(req.rid):
                self.tracer.on_chunk(req, now, st.chunks_done)
            return dt
        # final chunk: prompt fully cached — index it, emit TTFT token
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, st.pages, now)
        st.prefilling = False
        st.pos = plen
        st.generated.append(0)     # modeled token (no logits exist)
        self.tokens_out += 1
        st.stats.first_token_t = now
        rid = req.rid
        if self._sampled(rid):
            self.tracer.on_first_token(req, slot_idx, now,
                                       chunk=st.chunks_done)
            self._log(event="admit", req=rid, slot=slot_idx,
                      prompt_len=plen, chunks=st.stats.prefill_chunks,
                      ttft_s=st.stats.ttft_s,
                      queue_wait_s=st.stats.queue_wait_s, now=now,
                      slo_class=req.slo.name, tenant=req.tenant,
                      shared_tokens=st.shared_tokens,
                      queue_depth=self.sched.queue_depth,
                      page_util=self.pool.utilization,
                      **self._weight_fields())
        if len(st.generated) >= req.max_new_tokens:
            self._finish(slot_idx, st, now)
        return dt

    def _finish(self, slot_idx: int, st, now: float):
        req = st.request
        rid = req.rid
        st.stats.done_t = now
        tokens = len(st.generated)
        self.sched.release(slot_idx)
        if self.cfg.disagg:
            self._pf_finished.add(rid)
            self._pf_awaiting.pop(rid, None)
            self.sched.ship_forget(rid)
        st.stats.preemptions = self._preempt_counts.pop(rid, 0)
        st.stats.retries = self.sched.retries.pop(rid, 0)
        self._requeue_reason.pop(rid, None)
        reason_first = self._first_reason.pop(rid, "none")
        cost = None
        if self.ledger is not None:
            cost = self.ledger.finish(
                rid, now, prompt_len=req.prompt_len,
                shared_tokens=st.stats.shared_prefix_tokens,
                tokens_out=tokens)
        ttft = st.stats.ttft_s
        e2e = st.stats.e2e_s
        gap = ((e2e - ttft) / (tokens - 1)
               if (tokens > 1 and e2e is not None and ttft is not None)
               else 0.0)
        slo = req.slo
        ttft_ok = slo.ttft_s is None or (ttft is not None
                                         and ttft <= slo.ttft_s)
        gap_ok = slo.token_gap_s is None or gap <= slo.token_gap_s
        ok = ttft_ok and gap_ok
        b = self._bucket(req.tenant, slo.name)
        b.requests += 1
        b.tokens += tokens
        b.retries += st.stats.retries
        b.stalls[reason_first] = b.stalls.get(reason_first, 0) + 1
        if ok:
            b.slo_ok += 1
            b.goodput_tokens += tokens
        if ttft is not None:
            b.ttft.observe(ttft)
        if e2e is not None:
            b.e2e.observe(e2e)
        if st.stats.queue_wait_s is not None:
            b.queue_wait.observe(st.stats.queue_wait_s)
        if cost is not None:
            for k in COST_FIELDS:
                b.costs[k] += cost[k]
        self.completed += 1
        if self._sampled(rid):
            self.tracer.on_finish(req, slot_idx, "length", now,
                                  tokens=tokens, e2e_s=e2e)
            self._log(event="done", req=rid, slot=slot_idx,
                      reason="length", tokens=tokens, ttft_s=ttft,
                      e2e_s=e2e,
                      tokens_per_s=(tokens / e2e if e2e else None),
                      now=now, slo_class=slo.name, tenant=req.tenant,
                      slo_ttft_s=slo.ttft_s,
                      slo_token_gap_s=slo.token_gap_s,
                      shared_prefix_tokens=st.stats.shared_prefix_tokens,
                      prompt_len=req.prompt_len,
                      preemptions=st.stats.preemptions,
                      queue_depth=self.sched.queue_depth,
                      slot_occupancy=self.sched.occupancy,
                      page_util=self.pool.utilization,
                      **({"retries": st.stats.retries}
                         if st.stats.retries else {}),
                      **dict(cost or {}), **self._weight_fields())

    # ----------------------------------------------------------- faults
    def _terminate_fault(self, req, st, now: float, *, reason: str,
                         event: str, slot: Optional[int] = None):
        """Terminal fault accounting shared by retry exhaustion,
        deadline expiry and brownout shedding: the request counts in
        its bucket's ``requests`` with ``slo_ok`` unset — attainment
        degrades by construction — and its latencies stay out of the
        reservoirs (they summarize finished requests)."""
        rid = req.rid
        tokens = len(st.generated) if st is not None else 0
        cost = None
        if self.ledger is not None and st is not None:
            st.stats.done_t = now
            cost = self.ledger.finish(
                rid, now, prompt_len=req.prompt_len,
                shared_tokens=st.stats.shared_prefix_tokens,
                tokens_out=tokens)
        preempts = self._preempt_counts.pop(rid, 0)
        retries = self.sched.retries.pop(rid, 0)
        self._requeue_reason.pop(rid, None)
        self._first_reason.pop(rid, None)
        self._enter_seq.pop(rid, None)
        if self.cfg.disagg:
            self._pf_finished.add(rid)
            self._pf_awaiting.pop(rid, None)
            self.sched.ship_forget(rid)
        b = self._bucket(req.tenant, req.slo.name)
        b.requests += 1
        b.tokens += tokens
        b.retries += retries
        b.faults[reason] = b.faults.get(reason, 0) + 1
        self.faulted += 1
        if self._sampled(rid):
            self._log(event=event, req=rid, reason=reason,
                      tokens=tokens, e2e_s=now - req.arrival_t, now=now,
                      slo_class=req.slo.name, tenant=req.tenant,
                      retries=retries, preemptions=preempts,
                      queue_depth=self.sched.queue_depth,
                      **({"slot": slot} if slot is not None else {}),
                      **dict(cost or {}), **self._weight_fields())

    def _fail_over(self, now: float):
        """The replica serving every live slot died (chaos
        ``engine_kill``): requeue each in-flight request under its
        retry budget — the deterministic replay regenerates the same
        tokens — or terminate it ``retry_exhausted`` past the budget.
        Mirrors ServeEngine.fail_over on the analytic clock."""
        sched = self.sched
        self.failovers += 1
        requeued: List[int] = []
        exhausted: List[int] = []
        for i in list(sched.active_slots()):
            st = sched.slots[i]
            req = st.request
            rid = req.rid
            if sched.retries.get(rid, 0) < self.cfg.retry_budget:
                if self.ledger is not None:
                    self.ledger.on_preempt(rid, now,
                                           ctx_start=st.shared_tokens,
                                           tokens_cached=st.pos)
                tokens_discarded = len(st.generated)
                self.tokens_discarded += tokens_discarded
                sched.requeue_lost(i)
                self._enter_seq[rid] = self._stall_seq
                self._requeue_reason[rid] = "replica_lost"
                self.replica_requeues += 1
                requeued.append(rid)
                if self._sampled(rid):
                    self.tracer.on_replica_lost(req, i, now)
                    self._log(event="retry", req=rid, slot=i,
                              attempt=sched.retries[rid] + 1,
                              tokens_discarded=tokens_discarded,
                              slo_class=req.slo.name, tenant=req.tenant,
                              now=now,
                              queue_depth=sched.queue_depth,
                              **self._weight_fields())
            else:
                tokens = len(st.generated)
                if self._sampled(rid):
                    self.tracer.on_finish(req, i, "retry_exhausted",
                                          now, tokens=tokens,
                                          e2e_s=now - req.arrival_t,
                                          evicted=True)
                sched.release(i)
                self.retry_exhausted += 1
                exhausted.append(rid)
                self._terminate_fault(req, st, now,
                                      reason="retry_exhausted",
                                      event="evict", slot=i)
        self._log(event="failover", requeued=len(requeued),
                  exhausted=len(exhausted), now=now,
                  queue_depth=sched.queue_depth)

    def _expire_deadlines(self, now: float):
        """Terminate every request past its SLO deadline (queued and
        live) as ``deadline_exceeded`` — same sweep order as
        ServeEngine._expire_deadlines."""
        sched = self.sched
        for req in [r for r in sched.queue
                    if r.slo.deadline_s is not None
                    and now - r.arrival_t > r.slo.deadline_s]:
            if not sched.drop_queued(req):
                continue
            if self._sampled(req.rid):
                self.tracer.on_expire(req, now,
                                      e2e_s=now - req.arrival_t)
            self.expired += 1
            self._terminate_fault(req, None, now,
                                  reason="deadline_exceeded",
                                  event="expired")
        for i in list(sched.active_slots()):
            st = sched.slots[i]
            req = st.request
            d = req.slo.deadline_s
            if d is None or now - req.arrival_t <= d:
                continue
            if self._sampled(req.rid):
                self.tracer.on_expire(req, now,
                                      tokens=len(st.generated),
                                      e2e_s=now - req.arrival_t)
            sched.release(i)
            self.expired += 1
            self._terminate_fault(req, st, now,
                                  reason="deadline_exceeded",
                                  event="expired", slot=i)

    def _maybe_brownout(self, now: float):
        """Sustained page+queue pressure sheds the lowest-priority
        queued band (same policy shape as ServeEngine._maybe_brownout:
        ``brownout_streak`` consecutive hot steps arm it, one shed per
        trigger, streak resets after)."""
        cfg = self.cfg
        sched = self.sched
        hot = (self.pool.utilization >= cfg.brownout_page_high
               and sched.queue_depth >= cfg.brownout_queue_min)
        if not hot:
            self._brownout_hot = 0
            return
        self._brownout_hot += 1
        if self._brownout_hot < cfg.brownout_streak:
            return
        self._brownout_hot = 0
        min_pri = min(r.slo.priority for r in sched.queue)
        for req in [r for r in sched.queue
                    if r.slo.priority == min_pri]:
            if not sched.drop_queued(req):
                continue
            if self._sampled(req.rid):
                self.tracer.on_shed(req, now)
            self.shed += 1
            self._terminate_fault(req, None, now,
                                  reason="brownout_shed", event="shed")

    # ------------------------------------------- disaggregated tier
    def _pf_route(self, req: Request, attempt: int, now: float):
        """Queue `req` on the prefill tier.  The shipment deadline is
        armed only once a shipment exists (or a tier kill loses the
        prefill) — a healthy tier's queue wait is not a wire fault."""
        self._pf_queue.append((req, attempt))
        self._pf_awaiting[req.rid] = {
            "req": req, "attempt": attempt, "deadline": math.inf,
            "shipped": False, "seq": None, "resends": 0}
        if self.pf_tracer is not None and self._sampled(req.rid):
            # open the prefill-tier HOP at routing time (not arrival:
            # the decode hop's queued span already covers the wait)
            self.pf_tracer.on_submit(req, at=now)
            self._log(event="dispatch", req=req.rid, tier="prefill",
                      now=now,
                      **({"attempt": attempt} if attempt else {}))

    def _fallback_colocate(self, req: Request, now: float):
        """Colocated chunked prefill on the decode tier (graceful
        degradation): the request enters the REAL scheduler queue with
        the sticky ``prefill_tier_down`` stall stamp, and the normal
        admission path prefills it on the decode clock."""
        self._pf_awaiting.pop(req.rid, None)
        self.sched.submit(req)
        self.colocated += 1
        self._enter_seq.setdefault(req.rid, self._stall_seq)
        self._requeue_reason[req.rid] = "prefill_tier_down"
        if self._sampled(req.rid):
            self._log(event="dispatch", req=req.rid, tier="decode",
                      fallback=True, now=now)

    def _kill_prefill_tier(self, now: float):
        """Chaos ``prefill_kill``: every queued and in-flight prefill
        on the tier is lost; their pending entries' timeouts fire THIS
        step, so the recovery path (re-prefill under the retry budget,
        or colocation while degraded) runs immediately."""
        lost = ([(rid, ent[0]) for rid, ent in self._pf_live.items()]
                + [(r.rid, r) for r, _ in self._pf_queue])
        self._pf_live.clear()
        self._pf_queue.clear()
        self.prefill_kills += 1
        for rid, req in lost:
            p = self._pf_awaiting.get(rid)
            if p is not None and not p["shipped"]:
                p["deadline"] = now
                self._pf_armed[rid] = None
            self._pf_hop_evict(req, now, reason="prefill_kill")

    def _pf_hop_evict(self, req: Request, now: float, *, reason: str):
        """Close an OPEN prefill-tier hop ``evicted`` (a tier kill or a
        re-prefill turnaround): the tracer tiles whatever phase was
        open, so the discarded work still stitches and counts in the
        fleet-wide span ledger.  A no-op when the hop already closed
        (shipped) or the rid is unsampled."""
        tr = self.pf_tracer
        if tr is None or not self._sampled(req.rid) \
                or not tr.is_open(req.rid):
            return
        tr.on_finish(req, None, reason, now, tokens=0, evicted=True)

    def _pf_hop_ship(self, req: Request, now: float):
        """Close the prefill-tier hop at the ship: the final chunk
        boundary (the hop's ``last`` prefill span) plus the zero-token
        ``shipped`` terminal — the stitcher's ship edge source."""
        tr = self.pf_tracer
        if tr is None or not self._sampled(req.rid) \
                or not tr.is_open(req.rid):
            return
        C = self.cfg.prefill_chunk
        tr.on_first_token(req, None, now,
                          chunk=math.ceil(req.prompt_len / C))
        tr.on_finish(req, None, "shipped", now, tokens=0)

    def _pf_send(self, rid: int, p: dict, now: float):
        """Put (or re-put) rid's shipment on the modeled wire, driving
        the chaos shipment_* kinds exactly like the real channel."""
        self.ship_sent += 1
        if self._sampled(rid):
            self._log(event="ship", req=rid, seq=p["seq"],
                      attempt=p["attempt"], resend=p["resends"],
                      now=now, **self._weight_fields())
        plan = self.fault_plan
        spec = plan.shipment_fault("ship") if plan is not None else None
        due = now + self.cfg.ship_latency_s
        if spec is not None and spec.kind == "shipment_drop":
            self.ship_dropped += 1
            return                  # the timeout machinery recovers it
        if spec is not None and spec.kind == "shipment_delay":
            due += spec.delay_s
            self.ship_delayed += 1
        entry = {"due": due, "rid": rid, "seq": p["seq"],
                 "attempt": p["attempt"]}
        self._pf_wire.append(entry)
        if spec is not None and spec.kind == "shipment_dup":
            self._pf_wire.append(dict(entry))
            self.ship_duped += 1

    def _pf_reprefill(self, rid: int, p: dict, now: float):
        """Shipment unrecoverable (resends exhausted, or the tier died
        holding the prefill): re-prefill under the decode retry budget
        — the same `scheduler.retries` ledger replica failover bills —
        or terminate ``retry_exhausted`` past it."""
        req = p["req"]
        self._pf_hop_evict(req, now, reason="reprefill")
        retries = self.sched.retries.get(rid, 0)
        if retries >= self.cfg.retry_budget:
            self._pf_awaiting.pop(rid, None)
            self._pf_finished.add(rid)
            self.retry_exhausted += 1
            if self._sampled(rid):
                self.tracer.on_finish(req, -1, "retry_exhausted", now,
                                      tokens=0,
                                      e2e_s=now - req.arrival_t,
                                      evicted=True)
            self._terminate_fault(req, None, now,
                                  reason="retry_exhausted",
                                  event="evict")
            return
        self.sched.retries[rid] = retries + 1
        self.reprefills += 1
        self._requeue_reason[rid] = "shipment_wait"
        if self._sampled(rid):
            self._log(event="retry", req=rid, attempt=retries + 1,
                      ship=True, tokens_discarded=0, now=now,
                      slo_class=req.slo.name, tenant=req.tenant,
                      **self._weight_fields())
        if self._pf_degraded and self.cfg.fallback:
            self._pf_awaiting.pop(rid, None)
            self._fallback_colocate(req, now)
        else:
            self._pf_awaiting.pop(rid, None)
            self._pf_route(req, p["attempt"] + 1, now)

    def _pf_adopt(self, rid: int, req: Request, now: float) -> bool:
        """Deliver one shipment: the dedupe gate, then direct admission
        and the first-token emission — the sim's `adopt_prefilled` on
        the analytic clock.  False = no decode capacity; the caller
        requeues the delivery."""
        sched = self.sched
        adm = sched.admit_direct(req, now)
        if adm is None:
            reason = sched.last_stall or "none"
            self._requeue_reason.setdefault(rid, reason)
            return False
        slot_idx, st = adm
        reason = self._queued_reason(rid)
        self._first_reason.setdefault(rid, reason)
        self._enter_seq.pop(rid, None)
        self._requeue_reason.pop(rid, None)
        if self.ledger is not None:
            self.ledger.on_admit(rid, len(st.pages), now)
        t = req.tenant
        peaks = self.quota_peaks.get(t)
        if peaks is None:
            peaks = self.quota_peaks[t] = {"slots": 0, "pages": 0}
        peaks["slots"] = max(peaks["slots"],
                             sched.tenant_slots.get(t, 0))
        peaks["pages"] = max(peaks["pages"],
                             sched.tenant_pages.get(t, 0))
        st.prefilling = False
        st.pos = req.prompt_len
        st.generated.append(0)      # the shipped first token (modeled)
        self.tokens_out += 1
        self.adoptions += 1
        st.stats.first_token_t = now
        if self._sampled(rid):
            if reason != "none":
                self.tracer.on_stall([rid], reason)
            self.tracer.on_admit(req, slot_idx, now, shared_tokens=0)
            self.tracer.on_first_token(req, slot_idx, now, chunk=0)
            self._log(event="admit", req=rid, slot=slot_idx,
                      prompt_len=req.prompt_len, chunks=0,
                      ttft_s=st.stats.ttft_s,
                      queue_wait_s=st.stats.queue_wait_s, now=now,
                      slo_class=req.slo.name, tenant=req.tenant,
                      shared_tokens=0, disagg=True,
                      queue_depth=sched.queue_depth,
                      page_util=self.pool.utilization,
                      **self._weight_fields())
        if len(st.generated) >= req.max_new_tokens:
            self._finish(slot_idx, st, now)
        return True

    def _disagg_step(self, now: float, step_idx: int) -> float:
        """One prefill-tier step (runs CONCURRENTLY with decode: the
        caller takes max(tier dt, decode dt)): chaos, degraded-state
        transitions, arrival routing, one chunk per live prefill, wire
        deliveries with the dedupe gate, ack/timeout processing."""
        plan = self.fault_plan
        sched = self.sched
        pf_down = False
        if plan is not None:
            if plan.should_kill_prefill(step_idx):
                self._kill_prefill_tier(now)
            pf_down = plan.prefill_down(step_idx)
        if pf_down and not self._pf_degraded:
            self._pf_degraded = True
            self._pf_degraded_t0 = now
            self.degraded_entries += 1
            self._log(event="degraded", state="enter", now=now,
                      queue_depth=sched.queue_depth)
        elif not pf_down and self._pf_degraded:
            self._pf_degraded = False
            span = now - self._pf_degraded_t0
            self.degraded_s += span
            self._log(event="degraded", state="exit", now=now,
                      degraded_s=span)
        if self._pf_degraded:
            self.degraded_steps += 1
        # route arrivals: degraded+fallback -> colocate; degraded
        # without fallback (the naive baseline) -> wait out the outage
        if self._pf_arrivals:
            if not self._pf_degraded:
                for req in self._pf_arrivals:
                    self._pf_route(req, 0, now)
                self._pf_arrivals.clear()
            elif self.cfg.fallback:
                for req in self._pf_arrivals:
                    self._fallback_colocate(req, now)
                self._pf_arrivals.clear()
        dt = 0.0
        if not pf_down:
            while len(self._pf_live) < self._pf_slots \
                    and self._pf_queue:
                req, attempt = self._pf_queue.popleft()
                if req.rid in self._pf_awaiting:
                    self._pf_live[req.rid] = [req, 0, attempt]
                    if self.pf_tracer is not None \
                            and self._sampled(req.rid):
                        self.pf_tracer.on_admit(req, None, now)
            for rid in list(self._pf_live):
                ent = self._pf_live[rid]
                req, done, attempt = ent
                C = self.cfg.prefill_chunk
                s = done * C
                dt += self.service.prefill_chunk_s(C, s)
                ent[1] = done + 1
                self.tier_prefill_chunks += 1
                if s + C < math.ceil(req.prompt_len / C) * C:
                    continue
                del self._pf_live[rid]
                p = self._pf_awaiting.get(rid)
                if p is None:
                    # terminated while prefilling: the hop's work is
                    # discarded but must still tile and stitch
                    self._pf_hop_evict(req, now, reason="dropped")
                    continue
                self._pf_hop_ship(req, now)
                self._pf_seq += 1
                p["shipped"] = True
                p["seq"] = self._pf_seq
                p["deadline"] = now + self.cfg.ship_timeout_s
                self._pf_armed[rid] = None
                self._pf_send(rid, p, now)
        # wire deliveries due by now, in send order
        due = [e for e in self._pf_wire if e["due"] <= now]
        if due:
            self._pf_wire = [e for e in self._pf_wire
                             if e["due"] > now]
            for e in due:
                rid = e["rid"]
                if rid in self._pf_finished \
                        or rid not in self._pf_awaiting:
                    self.ship_dedups += 1   # late duplicate
                    continue
                if not sched.apply_shipment(rid, e["seq"]):
                    self.ship_dedups += 1
                    continue
                p = self._pf_awaiting[rid]
                if self._pf_adopt(rid, p["req"], now):
                    self._pf_awaiting.pop(rid, None)   # implicit ack
                else:
                    # no decode capacity: un-burn the seq, redeliver
                    # next step, hold the sender timer
                    sched.unapply_shipment(rid, e["seq"])
                    e["due"] = now + self.service.step_overhead_s
                    self._pf_wire.append(e)
                    p["deadline"] = now + self.cfg.ship_timeout_s
        # timeouts: resend up to the budget, then re-prefill — walking
        # only the ARMED entries; the unshipped backlog has deadline=inf
        # and never needs the scan
        for rid in list(self._pf_armed):
            p = self._pf_awaiting.get(rid)
            if p is None or p["deadline"] == math.inf:
                del self._pf_armed[rid]     # resolved or re-queued
                continue
            if now < p["deadline"]:
                continue
            if p["shipped"] and p["resends"] < self.cfg.ship_retry:
                p["resends"] += 1
                self.ship_resends += 1
                p["deadline"] = now + self.cfg.ship_timeout_s
                self._pf_send(rid, p, now)
            else:
                self._pf_reprefill(rid, p, now)
        if dt == 0.0 and (self._pf_wire or self._pf_awaiting
                          or self._pf_arrivals or self._pf_queue):
            # the tier is waiting on wire/timeout events: virtual time
            # must advance or the deliveries never come due
            dt = self.service.step_overhead_s
        return dt

    # ------------------------------------------------------------- step
    def _step(self, now: float, step_idx: int) -> float:
        """One engine-step equivalent at virtual time `now`; returns the
        modeled step duration."""
        sched = self.sched
        plan = self.fault_plan
        down = False
        if plan is not None:
            if plan.should_kill_engine(step_idx):
                self._fail_over(now)
            down = plan.engine_down(step_idx)
        if self.cfg.deadline:
            self._expire_deadlines(now)
        pf_dt = 0.0
        if self.cfg.disagg:
            # the prefill tier steps CONCURRENTLY with decode:
            # adoption/colocation it performs is visible to this step's
            # admission loop, and the step consumes max(tier, decode)
            pf_dt = self._disagg_step(now, step_idx)
        if not down:
            while True:
                adm = sched.admit_next(now)
                if adm is None:
                    if (self.cfg.preempt and sched.queue
                            and self._try_preempt(now)):
                        continue
                    break
                slot_idx, st = adm
                self._on_admit(slot_idx, st, now)
        if not down and sched.queue:
            reason = sched.last_stall or "none"
            self._stall_seq += 1
            self._stall_reason = reason
            self.stall_steps[reason] = self.stall_steps.get(reason, 0) + 1
        dt = 0.0
        finished0 = self.completed
        for i in sched.active_slots():
            st = sched.slots[i]
            if st is not None and st.prefilling:
                dt += self._advance_prefill(i, st, now)
        decoding = [i for i in sched.active_slots()
                    if not sched.slots[i].prefilling]
        if decoding:
            kv_tokens = sum(sched.slots[i].pos for i in decoding)
            dt += self.service.decode_step_s(len(decoding), kv_tokens)
            for i in decoding:
                st = sched.slots[i]
                st.generated.append(0)
                st.pos += 1
                self.tokens_out += 1
                if self._sampled(st.request.rid):
                    self.tracer.on_token(st.request, now)
                if len(st.generated) >= st.request.max_new_tokens:
                    self._finish(i, st, now)
        if self.completed > finished0:
            survivors = [sched.slots[i].request.rid
                         for i in sched.active_slots()
                         if not sched.slots[i].prefilling
                         and self._sampled(sched.slots[i].request.rid)]
            if survivors:
                self.tracer.on_split(survivors, now, "evict")
        if self.cfg.brownout:
            self._maybe_brownout(now)
        dt = max(dt, pf_dt)     # disagg tiers overlap in wall-clock
        if plan is not None:
            dt += plan.step_delay(0, step_idx)
        if down:
            # the down-window must consume virtual time even with every
            # slot drained, else the rejoin step never arrives
            dt = max(dt, self.service.step_overhead_s)
        return dt

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> Dict[str, Any]:
        """Replay the trace to completion; returns `report()`."""
        reqs = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        n = len(reqs)
        i = 0
        now = reqs[0].arrival_t if reqs else 0.0
        self._start = now
        sched = self.sched
        every = self.cfg.invariant_every
        while True:
            while i < n and reqs[i].arrival_t <= now + 1e-12:
                self._submit(reqs[i])
                i += 1
            if not any(s is not None for s in sched.slots) \
                    and not sched.queue \
                    and not (self._pf_arrivals or self._pf_queue
                             or self._pf_live or self._pf_wire
                             or self._pf_awaiting):
                if i >= n:
                    break
                now = max(now, reqs[i].arrival_t)
                continue
            before = (sched.admitted, self.completed, self.faulted)
            dt = self._step(now, self.steps)
            self.steps += 1
            if every and self.steps % every == 0:
                sched.check_invariants()
                self.invariant_checks += 1
            if dt <= 0.0:
                # a zero-duration step made no progress toward any
                # event: admit/finish must have moved, else we are
                # wedged (a quota no request can ever satisfy is
                # rejected at submit, so this is a genuine bug)
                if (sched.admitted, self.completed,
                        self.faulted) == before and i >= n:
                    raise RuntimeError(
                        f"fleet sim wedged at step {self.steps}: queue "
                        f"depth {sched.queue_depth}, stall "
                        f"{sched.last_stall!r}, no progress possible")
                dt = self.service.step_overhead_s
            now += dt
        if self._pf_degraded:
            # outage reached end-of-run: flush the open degraded span
            self.degraded_s += now - self._pf_degraded_t0
            self._pf_degraded = False
        self._end = now
        sched.check_invariants()
        self.invariant_checks += 1
        if self.run_log is not None:
            elapsed = max(now - self._start, 1e-9)
            self._log(event="report", requests=self.completed,
                      tokens=self.tokens_out, elapsed_s=elapsed,
                      now=now, tokens_per_s=self.tokens_out / elapsed)
        if self.registry is not None:
            self._flush_registry()
        return self.report()

    def _flush_registry(self):
        """Exact counters/gauges into the metrics registry in one batch
        (the hot loop never takes the registry lock)."""
        reg = self.registry
        reg.inc("serve.requests_submitted", value=self.submitted)
        reg.inc("serve.requests_done", value=self.completed)
        reg.inc("serve.tokens_out", value=self.tokens_out)
        reg.inc("serve.prefill_chunks", value=self.prefill_chunks)
        reg.inc("serve.preemptions", value=self.preemptions)
        if self.failovers:
            reg.inc("serve.failovers", value=self.failovers)
        if self.replica_requeues:
            reg.inc("serve.replica_requeues",
                    value=self.replica_requeues)
        if self.retry_exhausted:
            reg.inc("serve.retry_exhausted", value=self.retry_exhausted)
        if self.expired:
            reg.inc("serve.deadline_exceeded", value=self.expired)
        if self.shed:
            reg.inc("serve.brownout_shed", value=self.shed)
        if self.tokens_discarded:
            reg.inc("serve.tokens_discarded",
                    value=self.tokens_discarded)
        if self.cfg.disagg:
            # same counter names the live DisaggCoordinator flushes, so
            # one reader (slo_report/tools_obs_report) covers both
            reg.inc("serve.tier_prefill_chunks",
                    value=self.tier_prefill_chunks)
            reg.inc("serve.ship_sent", value=self.ship_sent)
            reg.inc("serve.ship_acked", value=self.adoptions)
            if self.ship_dedups:
                reg.inc("serve.ship_dedups", value=self.ship_dedups)
            if self.ship_resends:
                reg.inc("serve.ship_resends", value=self.ship_resends)
            if self.reprefills:
                reg.inc("serve.disagg_reprefills",
                        value=self.reprefills)
            if self.colocated:
                reg.inc("serve.colocated_prefills",
                        value=self.colocated)
            if self.prefill_kills:
                reg.inc("serve.prefill_tier_kills",
                        value=self.prefill_kills)
            if self.degraded_entries:
                reg.inc("serve.degraded_entries",
                        value=self.degraded_entries)
        for reason, c in sorted(self.stall_steps.items()):
            reg.inc("serve.admission_stalls", value=c, reason=reason)
        for t, peaks in sorted(self.quota_peaks.items()):
            reg.set_gauge("serve.tenant_slots_peak", peaks["slots"],
                          tenant=t)
            reg.set_gauge("serve.tenant_pages_peak", peaks["pages"],
                          tenant=t)

    # ----------------------------------------------------------- report
    def _check_traces(self) -> Dict[str, Any]:
        """Validate + reconcile every kept (sampled) trace: exact span
        tiling means zero residual by construction — any nonzero
        residual is a tracer/sim bug, surfaced here."""
        max_residual = 0.0
        checked = 0
        for tr in self.tracer.traces.values():
            tr.validate()
            term = tr.terminal
            e2e = term.attrs.get("e2e_s") if term is not None else None
            r = tr.reconcile(e2e)
            if r is not None:
                checked += 1
                max_residual = max(max_residual, r)
        out = {"traces_checked": checked,
               "max_residual_s": max_residual}
        out.update(self._check_stitch())
        return out

    def _check_stitch(self) -> Dict[str, Any]:
        """Stitch every kept hop (decode + prefill-tier) and captured
        edge event into per-rid `FleetTrace`s, enforce the fleet-scope
        tiling contract, and decompose every completed request's
        critical path — the storm tests assert zero residual off this
        block (docs/observability.md, Distributed tracing)."""
        hops = list(self.tracer.completed)
        if self.pf_tracer is not None:
            hops += self.pf_tracer.completed
        if not hops:
            return {}
        from hetu_tpu_torch.obs.critpath import critical_path
        fts = FleetTrace.stitch(traces=hops, events=self._events)
        quantum = self.service.step_overhead_s
        paths = 0
        max_cp = 0.0
        max_ttft = 0.0
        for ft in fts.values():
            ft.validate(step_quantum=quantum)
            cp = critical_path(ft)
            if cp is None:
                continue
            paths += 1
            max_cp = max(max_cp, abs(cp["residual_s"]))
            if cp["ttft_residual_s"] is not None:
                max_ttft = max(max_ttft, abs(cp["ttft_residual_s"]))
        return {"stitched": len(fts), "critical_paths": paths,
                "max_critpath_residual_s": max_cp,
                "max_ttft_residual_s": max_ttft}

    @staticmethod
    def _bucket_report(b: _Bucket, elapsed: float) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "requests": b.requests, "tokens_out": b.tokens,
            "slo_attainment": (b.slo_ok / b.requests
                               if b.requests else None),
            "goodput_tokens": b.goodput_tokens,
            "goodput_tokens_per_s": (b.goodput_tokens / elapsed
                                     if elapsed > 0 else None),
            "preemptions": b.preemptions,
            "stall_breakdown": dict(sorted(b.stalls.items())),
            "ttft_s": _hist_summary(b.ttft),
            "e2e_s": _hist_summary(b.e2e),
            "queue_wait_s": _hist_summary(b.queue_wait),
        }
        # fault fields only when nonzero: a no-fault run's report stays
        # byte-identical to the pre-fault-layer schema
        if b.retries:
            out["retries"] = b.retries
        if b.faults:
            out["faults"] = dict(sorted(b.faults.items()))
        if any(b.costs.values()):
            out["cost"] = dict(b.costs)
        return out

    def report(self) -> Dict[str, Any]:
        """The fleet report (tools_fleet.py's --json payload): derived
        ONLY from virtual-clock quantities and seeded reservoirs, so the
        same seed + trace reproduces it byte-identically."""
        elapsed = max(self._end - self._start, 0.0)
        tenants: Dict[str, _Bucket] = {}
        classes: Dict[str, _Bucket] = {}
        stall_breakdown: Dict[str, int] = {}
        for (tenant, cls), b in self._buckets.items():
            for agg_key, agg in ((tenant, tenants), (cls, classes)):
                m = agg.get(agg_key)
                if m is None:
                    m = agg[agg_key] = _Bucket()
                m.requests += b.requests
                m.tokens += b.tokens
                m.slo_ok += b.slo_ok
                m.goodput_tokens += b.goodput_tokens
                m.preemptions += b.preemptions
                m.retries += b.retries
                for k, v in b.faults.items():
                    m.faults[k] = m.faults.get(k, 0) + v
                for k, v in b.stalls.items():
                    m.stalls[k] = m.stalls.get(k, 0) + v
                for k, v in b.costs.items():
                    m.costs[k] += v
                for attr in ("ttft", "e2e", "queue_wait"):
                    _merge_hist(getattr(m, attr), getattr(b, attr))
            for k, v in b.stalls.items():
                stall_breakdown[k] = stall_breakdown.get(k, 0) + v
        quotas: Dict[str, Any] = {}
        for t, q in sorted(self.cfg.quotas.items()):
            peaks = self.quota_peaks.get(t, {"slots": 0, "pages": 0})
            quotas[t] = dict(q.to_dict(), peak_slots=peaks["slots"],
                             peak_pages=peaks["pages"])
        costs = {
            "by_tenant": {t: dict(m.costs)
                          for t, m in sorted(tenants.items())
                          if any(m.costs.values())},
        } if self.ledger is not None else None
        if costs is not None:
            total = {k: 0.0 for k in COST_FIELDS}
            for c in costs["by_tenant"].values():
                for k in COST_FIELDS:
                    total[k] += c[k]
            costs["total"] = total
        out: Dict[str, Any] = {
            "fleet_schema": FLEET_SCHEMA,
            "requests": self.submitted,
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "elapsed_s": elapsed,
            "tokens_per_s": (self.tokens_out / elapsed
                             if elapsed > 0 else None),
            "steps": self.steps,
            "admitted": self.sched.admitted,
            "preemptions": self.preemptions,
            "faults": {
                "failovers": self.failovers,
                "replica_requeues": self.replica_requeues,
                "retry_exhausted": self.retry_exhausted,
                "deadline_exceeded": self.expired,
                "brownout_shed": self.shed,
                "faulted": self.faulted,
                "tokens_discarded": self.tokens_discarded,
            },
            "prefill_chunks": self.prefill_chunks,
            "stall_steps": dict(sorted(self.stall_steps.items())),
            "stall_breakdown": dict(sorted(stall_breakdown.items())),
            "tenants": {t: self._bucket_report(m, elapsed)
                        for t, m in sorted(tenants.items())},
            "classes": {c: self._bucket_report(m, elapsed)
                        for c, m in sorted(classes.items())},
            "quotas": quotas,
            "invariants": {"checks": self.invariant_checks, "ok": True},
            "trace_check": self._check_traces(),
            "sample": self.sample,
            "service_model": self.service.to_dict(),
        }
        if self.cfg.disagg:
            # two-tier section only when the tier exists: colocated
            # runs keep the pre-disagg payload byte-identical
            out["disagg"] = {
                "prefill_slots": self._pf_slots,
                "tier_prefill_chunks": self.tier_prefill_chunks,
                "shipments": {
                    "sent": self.ship_sent,
                    "dropped": self.ship_dropped,
                    "duped": self.ship_duped,
                    "delayed": self.ship_delayed,
                    "dedups": self.ship_dedups,
                    "resends": self.ship_resends,
                },
                "adoptions": self.adoptions,
                "reprefills": self.reprefills,
                "colocated_prefills": self.colocated,
                "prefill_kills": self.prefill_kills,
                "degraded_entries": self.degraded_entries,
                "degraded_steps": self.degraded_steps,
                "degraded_s": self.degraded_s,
                "fallback": self.cfg.fallback,
            }
        if costs is not None:
            out["costs"] = costs
        if self.prefix_cache is not None:
            out["prefix_cache"] = {
                k: v for k, v in self.prefix_cache.stats().items()}
        return out


def attainment_delta(report: Dict[str, Any],
                     baseline: Dict[str, Any]) -> Dict[str, Any]:
    """Per-tenant / per-class SLO-attainment degradation of a faulted
    fleet run against its no-fault baseline (two `report()` payloads
    from the same workload).  ``delta`` < 0 means the faults cost that
    tenant attainment; tools_fleet.py and the chaos recovery reports
    surface it."""
    out: Dict[str, Any] = {"tenants": {}, "classes": {}}
    for key in ("tenants", "classes"):
        for name, sec in report.get(key, {}).items():
            base = baseline.get(key, {}).get(name)
            if base is None:
                continue
            a = sec.get("slo_attainment")
            b = base.get("slo_attainment")
            if a is None or b is None:
                continue
            out[key][name] = {"attainment": a, "baseline": b,
                              "delta": a - b}
    return out


def fleet_workload(n: int, *, rate_per_s: float, burst: int = 0,
                   tenants: Sequence[str] = ("default",),
                   slo_classes=None, prompt_lens=(16, 64),
                   max_new=(4, 16), shared_prefix_len: int = 0,
                   vocab_size: int = 32000, seed: int = 0
                   ) -> List[Request]:
    """The canonical multi-tenant fleet trace: seeded arrivals (Poisson,
    or bursty when ``burst`` > 0) with tenants and SLO classes assigned
    round-robin — the shared workload builder tools_fleet.py, the chaos
    ``fleet-storm`` schedule and the tests all use."""
    from hetu_tpu_torch.serving.traces import (bursty_arrivals,
                                         poisson_arrivals,
                                         synthetic_requests)
    arrivals = (bursty_arrivals(n, rate_per_s, burst=burst, seed=seed)
                if burst else poisson_arrivals(n, rate_per_s, seed=seed))
    return synthetic_requests(
        n, vocab_size=vocab_size, prompt_lens=prompt_lens,
        max_new=max_new, arrivals=arrivals, slo_classes=slo_classes,
        shared_prefix_len=shared_prefix_len,
        tenants=list(tenants), seed=seed)
