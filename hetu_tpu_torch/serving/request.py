"""Serving request/result records and their SLO accounting, copied from
`hetu_tpu/serving/request.py` (host-only code).

A `Request` is one user sequence: prompt ids + a decode budget.  The
engine stamps the SLO-relevant timeline into `RequestStats` using the
caller's clock (virtual under `ServingEngine.run`) so TTFT / e2e latency
percentiles are deterministic under a simulated timeline.

Tenant quotas and serve-event sampling (`TenantQuota`, `parse_quotas`,
`rid_sampled`) arrive with the engine features that read them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency contract.  Targets are optional: None means the
    dimension is uncontracted.  ``priority`` orders classes for
    preemptive admission and ``deadline_s`` is an end-to-end budget from
    arrival; this slice's engine records both and enforces neither."""
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


DEFAULT_SLO = SLOClass()


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding parameters.  The defaults are GREEDY
    (temperature 0); this slice's engine decodes greedily and refuses a
    request with temperature > 0."""
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


GREEDY = SamplingParams()


@dataclasses.dataclass
class Request:
    """One generation request (greedy decode, per-request EOS)."""
    rid: int
    prompt: np.ndarray                 # [plen] int32 token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    arrival_t: float = 0.0
    slo: SLOClass = DEFAULT_SLO
    sampling: SamplingParams = GREEDY
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
    """Per-request SLO timeline (seconds on the caller's clock)."""
    arrival_t: float = 0.0
    admit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None
    prefill_chunks: int = 0

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_t is None:
            return None
        return self.admit_t - self.arrival_t

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from ARRIVAL (queue wait counts)."""
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
    finished_reason: str               # "eos" | "length"
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)

    @property
    def tokens_per_s(self) -> Optional[float]:
        e2e = self.stats.e2e_s
        if not e2e or e2e <= 0:
            return None
        return len(self.tokens) / e2e
