"""Serving request/result records and their SLO accounting, copied from
`hetu_tpu/serving/request.py` (host-only code).

A `Request` is one user sequence: prompt ids + a decode budget.  The
engine stamps the SLO-relevant timeline into `RequestStats` using the
caller's clock (virtual under `ServingEngine.run`) so TTFT / e2e latency
percentiles are deterministic under a simulated timeline.

Every request belongs to an `SLOClass` (a named latency contract with
a priority for preemptive admission and an optional deadline) and a
tenant (`TenantQuota` caps a tenant's live slots and pages);
`rid_sampled` picks the deterministic 1-in-N of requests whose serve
events the run log keeps.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency contract.  Targets are optional: None means the
    dimension is uncontracted (always attained); the default class has
    no targets at all — classless traffic reports attainment 1.0 and
    its tokens all count toward goodput.

    ``priority`` orders classes for preemptive admission
    (HETU_TORCH_SERVE_PREEMPT): under slot/page pressure a queued request
    of a STRICTLY higher priority may evict-and-requeue the
    lowest-priority live slot.  0 (default) = every class equal —
    preemption can never fire between default-priority classes.

    ``deadline_s`` is an end-to-end wall budget from ARRIVAL: when
    deadline enforcement is on (HETU_TORCH_SERVE_DEADLINE) a request
    still unfinished ``deadline_s`` after it arrived terminates as
    ``deadline_exceeded`` — a real terminal span, costed in the
    ledger.  None (default) = no deadline; with the flag unset the
    engine never even inspects it."""
    name: str = "default"
    ttft_s: Optional[float] = None       # arrival -> first token target
    token_gap_s: Optional[float] = None  # mean inter-token gap target
    priority: int = 0
    deadline_s: Optional[float] = None   # arrival -> done hard budget

    def __post_init__(self):
        if not self.name:
            raise ValueError("SLO class needs a name")
        for fld in ("ttft_s", "token_gap_s", "deadline_s"):
            v = getattr(self, fld)
            if v is not None and v <= 0:
                raise ValueError(f"SLO class {self.name!r}: {fld} must "
                                 f"be positive, got {v}")

    def to_dict(self) -> dict:
        return {"name": self.name, "ttft_s": self.ttft_s,
                "token_gap_s": self.token_gap_s,
                "priority": self.priority,
                "deadline_s": self.deadline_s}

    @staticmethod
    def parse(spec: str) -> "SLOClass":
        """``name[:ttft_s[:token_gap_s[:priority[:deadline_s]]]]``
        (empty/'-' = no target) — the CLI surface:
        ``--slo-class gold:0.2:0.05:2:30``.  Extra fields and
        non-numeric targets are loud errors: a silently dropped field
        would run a different contract than the user typed."""
        parts = spec.split(":")
        if not parts[0] or len(parts) > 5:
            raise ValueError(
                f"bad SLO class spec {spec!r}; want "
                "name[:ttft_s[:token_gap_s[:priority[:deadline_s]]]]")

        def num(i, what, cast=float):
            if len(parts) <= i or parts[i] in ("", "-"):
                return None
            try:
                return cast(parts[i])
            except ValueError:
                raise ValueError(
                    f"bad SLO class spec {spec!r}: {what} "
                    f"{parts[i]!r} is not a number (use '-' for no "
                    "target)") from None
        prio = num(3, "priority", int)
        return SLOClass(parts[0], num(1, "ttft_s"),
                        num(2, "token_gap_s"),
                        prio if prio is not None else 0,
                        num(4, "deadline_s"))


DEFAULT_SLO = SLOClass()


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission quota (HETU_TORCH_SERVE_QUOTAS).

    Caps how many decode slots and KV pages requests of one tenant may
    hold LIVE at once; the scheduler checks the cap at admission, before
    touching the pool, and stalls the queue head with the
    ``quota_exceeded`` reason when its tenant is over.  0 = unlimited in
    that dimension; a tenant with no quota registered is unlimited in
    both — quota-free deployments see exactly the old admission path."""
    tenant: str
    max_slots: int = 0
    max_pages: int = 0

    def __post_init__(self):
        if not self.tenant:
            raise ValueError("tenant quota needs a tenant name")
        if self.max_slots < 0 or self.max_pages < 0:
            raise ValueError(
                f"tenant {self.tenant!r}: quota caps must be >= 0, got "
                f"slots={self.max_slots} pages={self.max_pages}")

    def to_dict(self) -> dict:
        return {"tenant": self.tenant, "max_slots": self.max_slots,
                "max_pages": self.max_pages}

    @staticmethod
    def parse(spec: str) -> "TenantQuota":
        """``tenant[:max_slots[:max_pages]]`` (empty/'-'/0 = unlimited)
        — the CLI/flag surface: ``HETU_TORCH_SERVE_QUOTAS=acme:2:16,free:1:4``."""
        parts = spec.split(":")
        if not parts[0] or len(parts) > 3:
            raise ValueError(f"bad tenant quota spec {spec!r}; want "
                             "tenant[:max_slots[:max_pages]]")

        def num(i, what):
            if len(parts) <= i or parts[i] in ("", "-"):
                return 0
            try:
                return int(parts[i])
            except ValueError:
                raise ValueError(
                    f"bad tenant quota spec {spec!r}: {what} "
                    f"{parts[i]!r} is not an integer (use '-' for "
                    "unlimited)") from None
        return TenantQuota(parts[0], num(1, "max_slots"),
                           num(2, "max_pages"))


def parse_quotas(spec: str) -> dict:
    """Comma-separated TenantQuota specs -> {tenant: TenantQuota}.
    Empty/blank spec = no quotas (the identity contract of
    HETU_TORCH_SERVE_QUOTAS)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        q = TenantQuota.parse(part)
        if q.tenant in out:
            raise ValueError(f"duplicate tenant quota for {q.tenant!r}")
        out[q.tenant] = q
    return out


#: Fibonacci-hash multiplier (2^64 / phi) for rid_sampled's bit mixer
_SAMPLE_MIX = 0x9E3779B97F4A7C15


def rid_sampled(rid: int, n: int) -> bool:
    """Deterministic 1-in-`n` request sampling for RunLog serve events
    and spans (HETU_TORCH_RUNLOG_SERVE_SAMPLE): hash the rid, keep the
    1/n bucket.  The multiplicative mix matters — a plain ``rid % n``
    aliases with anything else assigned round-robin by rid (tenants,
    SLO classes in the workload builders share the same stride), so a
    modulo sample of a 2-tenant trace could contain ONE tenant.  The
    hash is a pure function of (rid, n): the same request is sampled on
    every replay, so goldens stay byte-identical."""
    if n <= 1:
        return True
    return ((rid * _SAMPLE_MIX) & 0xFFFFFFFFFFFFFFFF) >> 32 < \
        (1 << 32) // n


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters (serving/sampling.py).

    The defaults are GREEDY: temperature 0 makes the sampler an argmax
    regardless of the filters, so a default-constructed request decodes
    exactly like the pre-sampling engine.  ``seed`` keys a per-request
    PRNG stream: the key for the token at sequence position p is
    ``fold_in(key(seed), p)`` — a pure function of (seed, position), so
    the same request replays to the same tokens across engine restarts,
    slot assignments and batch compositions (the determinism golden in
    tests/test_serving_decode.py)."""
    temperature: float = 0.0
    top_k: int = 0                     # 0 = filter disabled
    top_p: float = 0.0                 # 0.0 (or >= 1.0) = disabled
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def to_dict(self) -> dict:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One generation request (greedy decode unless ``sampling`` says
    otherwise; per-request EOS)."""
    rid: int
    prompt: np.ndarray                 # [plen] int32 token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_t: float = 0.0
    slo: SLOClass = DEFAULT_SLO
    sampling: SamplingParams = GREEDY
    #: who this request bills to: per-tenant quotas gate admission
    #: (scheduler), and slo_report/costs aggregate per tenant.  The
    #: default tenant keeps tenant-free callers byte-identical.
    tenant: str = "default"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be "
                             ">= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_len(self) -> int:
        """Worst-case cache footprint (prompt + full decode budget) —
        what the scheduler reserves pages for at admission."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class RequestStats:
    """Per-request SLO timeline (driver-clock seconds) + the decoding
    subsystem's per-request accounting (spec-decode acceptance, prefix
    cache hits, preemptions — serving/slo_report.py aggregates these
    from the ``done`` events)."""
    arrival_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    prefill_chunks: int = 0
    #: speculative decoding (serving/spec_decode.py): draft tokens
    #: proposed / accepted over the request's verify steps
    spec_proposed: int = 0
    spec_accepted: int = 0
    #: prompt tokens admitted with their KV pages already resident
    #: (serving/prefix_cache.py) — prefill skipped them entirely
    shared_prefix_tokens: int = 0
    #: times this request was evicted-and-requeued by a higher-priority
    #: admission (HETU_TORCH_SERVE_PREEMPT)
    preemptions: int = 0
    #: times this request re-entered the queue after its serving
    #: replica died (chaos ``engine_kill``; budget HETU_TORCH_SERVE_RETRY)
    retries: int = 0

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.arrival_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from ARRIVAL (queue wait counts: a user
        staring at a spinner does not care which side of the scheduler
        the time went)."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def e2e_s(self) -> Optional[float]:
        if self.done_t is None:
            return None
        return self.done_t - self.arrival_t


@dataclasses.dataclass
class RequestResult:
    """What the engine hands back when a request completes."""
    rid: int
    tokens: List[int]                  # generated ids (EOS included)
    #: "eos" | "length" on the happy path; fault terminations use
    #: "deadline_exceeded" (HETU_TORCH_SERVE_DEADLINE), "brownout_shed"
    #: (HETU_TORCH_SERVE_BROWNOUT) and "retry_exhausted" (an engine_kill
    #: past the HETU_TORCH_SERVE_RETRY budget)
    finished_reason: str
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)

    @property
    def tokens_per_s(self) -> Optional[float]:
        e2e = self.stats.e2e_s
        if not e2e or e2e <= 0:
            return None
        return len(self.tokens) / e2e
