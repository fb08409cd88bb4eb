"""Per-request serving cost ledger: analytic FLOPs / bytes / page-seconds
attribution.

The Galvatron line (PAPERS.md) stands on calibrated analytic cost models
instead of hardware timers; this module applies the same discipline to
PER-REQUEST serving cost so a fleet run can answer "what did tenant X's
traffic actually consume?" without a profiler.  Every number is derived
from the same closed-form models the bench records already use:

    prefill/decode FLOPs   2N matmul FLOPs per token + 4*L*hidden per
                           cached context position (bench.py
                           `_hardware_free_serving`'s ``flops_tok``),
                           summed in closed form over the positions the
                           request actually computed — shared prefix
                           tokens (radix cache hits) cost nothing
    KV page-seconds        pages held x residency seconds, accumulated
                           across preemption epochs (a preempted request
                           re-pays for its re-admission residency)
    resident KV byte-secs  page-seconds x page_size x
                           `kv_pool.kv_bytes_per_token` (the one
                           analytic byte model for cache footprint)
    wire bytes             (prompt + generated tokens) x the per-token
                           wire price (int32 token ids by default)

`CostLedger` is the host-side accumulator the engine and the fleet
simulator both drive: `on_admit`/`on_release` bracket residency epochs,
`finish` closes the ledger entry and returns the ``cost_*`` fields that
ride on the ``serve`` done event — `serving/slo_report.py` (the ONE
serving RunLog reader) aggregates them per tenant.  No jax anywhere:
pure float arithmetic, safe in the 10^6-request sim hot loop.

Copied from `hetu_tpu/serving/costs.py` (host-only code; the port keeps
its own copy so it never imports the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from hetu_tpu_torch.serving.kv_pool import kv_bytes_per_token

#: the ``cost_*`` fields a costed done event carries (schema doc —
#: obs/runlog.py references this tuple; slo_report sums exactly these)
COST_FIELDS = ("cost_prefill_flops", "cost_decode_flops", "cost_page_s",
               "cost_kv_byte_s", "cost_wire_bytes")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """The per-token prices (pure counts, no time): what one computed
    token / one resident page costs.  Frozen — one model prices every
    request of a run identically."""
    #: matmul FLOPs per computed token (2 * N_params)
    flops_per_token: float
    #: attention FLOPs per computed token per cached context position
    #: (qk + pv = 4 * L * hidden — bench.py's ``flops_tok`` slope)
    attn_flops_per_ctx: float
    #: cache bytes one token position occupies (kv_pool byte model)
    kv_bytes_per_token: float
    #: tokens per KV page (prices page-seconds into byte-seconds)
    page_size: int
    #: wire bytes per prompt/generated token (int32 ids = 4)
    wire_bytes_per_token: float = 4.0

    @staticmethod
    def from_model_dims(*, num_params: float, num_layers: int,
                        hidden_size: int, num_kv_heads: int, head_dim: int,
                        page_size: int, kv_mode: str = "fp32",
                        wire_bytes_per_token: float = 4.0) -> "CostModel":
        """Price from model dimensions — the same inputs bench.py's
        serving record uses, so ledger FLOPs and bench FLOPs can never
        disagree on the formula."""
        return CostModel(
            flops_per_token=2.0 * float(num_params),
            attn_flops_per_ctx=4.0 * num_layers * hidden_size,
            kv_bytes_per_token=kv_bytes_per_token(
                num_layers, num_kv_heads, head_dim, kv_mode),
            page_size=page_size,
            wire_bytes_per_token=wire_bytes_per_token)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    # ------------------------------------------------------ closed forms
    def compute_flops(self, ctx_start: int, n_tokens: int) -> float:
        """FLOPs to compute `n_tokens` consecutive positions whose
        attention contexts are ctx_start, ctx_start+1, ...: the 2N
        matmuls plus the arithmetic-series attention term."""
        if n_tokens <= 0:
            return 0.0
        ctx_sum = n_tokens * ctx_start + n_tokens * (n_tokens - 1) / 2.0
        return (self.flops_per_token * n_tokens
                + self.attn_flops_per_ctx * ctx_sum)


@dataclasses.dataclass
class _Acct:
    """One request's open ledger entry."""
    pages: int = 0
    epoch_t0: Optional[float] = None
    page_s: float = 0.0
    preempt_flops: float = 0.0    # prefill work discarded by preemptions


class CostLedger:
    """Accumulates per-request residency across admission epochs and
    prices the finished request.  Drive it with the scheduler's
    admit/release timeline; `finish` pops the entry (the ledger holds
    only LIVE requests — bounded memory at 10^6 requests)."""

    def __init__(self, model: CostModel):
        self.model = model
        self._open: Dict[int, _Acct] = {}
        #: totals across finished requests (the invariant-check summary)
        self.finished = 0

    def on_admit(self, rid: int, n_pages: int, now: float):
        acct = self._open.setdefault(rid, _Acct())
        acct.pages = n_pages
        acct.epoch_t0 = now

    def on_release(self, rid: int, now: float):
        """Close the current residency epoch (finish OR preemption)."""
        acct = self._open.get(rid)
        if acct is None or acct.epoch_t0 is None:
            return
        acct.page_s += acct.pages * (now - acct.epoch_t0)
        acct.epoch_t0 = None

    def on_preempt(self, rid: int, now: float, *, ctx_start: int,
                   tokens_cached: int):
        """A preemption discards the victim's computed-but-unfinished
        work; the re-run pays again, so the DISCARDED FLOPs are part of
        what the request truly cost."""
        self.on_release(rid, now)
        acct = self._open.get(rid)
        if acct is not None:
            acct.preempt_flops += self.model.compute_flops(
                ctx_start, max(0, tokens_cached - ctx_start))

    def finish(self, rid: int, now: float, *, prompt_len: int,
               shared_tokens: int, tokens_out: int) -> Dict[str, Any]:
        """Close the entry and return the ``cost_*`` done-event fields.
        ``shared_tokens`` (radix-cache resident prefix) never ran, so it
        costs no prefill FLOPs — cache hits are visible as cost savings."""
        self.on_release(rid, now)
        acct = self._open.pop(rid, _Acct())
        m = self.model
        prefill = m.compute_flops(shared_tokens,
                                  prompt_len - shared_tokens)
        decode = m.compute_flops(prompt_len, tokens_out)
        self.finished += 1
        return {
            "cost_prefill_flops": prefill + acct.preempt_flops,
            "cost_decode_flops": decode,
            "cost_page_s": acct.page_s,
            "cost_kv_byte_s": acct.page_s * m.page_size
            * m.kv_bytes_per_token,
            "cost_wire_bytes": (prompt_len + tokens_out)
            * m.wire_bytes_per_token,
        }

    @property
    def open_count(self) -> int:
        return len(self._open)


def aggregate_costs(rows) -> Optional[Dict[str, Any]]:
    """Sum the ``cost_*`` fields over per-request report rows (sample
    weights applied), grouped per tenant + a fleet total.  None when no
    row carries a ledger — cost-free runs keep their report shape."""
    tenants: Dict[str, Dict[str, float]] = {}
    total = {k: 0.0 for k in COST_FIELDS}
    seen = False
    for r in rows:
        if r.get(COST_FIELDS[0]) is None:
            continue
        seen = True
        w = float(r.get("sample_weight") or 1.0)
        t = str(r.get("tenant") or "default")
        bucket = tenants.setdefault(t, {k: 0.0 for k in COST_FIELDS})
        for k in COST_FIELDS:
            v = float(r.get(k) or 0.0) * w
            bucket[k] += v
            total[k] += v
    if not seen:
        return None
    return {"by_tenant": {t: dict(v) for t, v in sorted(tenants.items())},
            "total": total}
