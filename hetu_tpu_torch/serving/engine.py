"""Serving engine: continuous batching + paged KV cache, the port of
`hetu_tpu/serving/engine.py`.

Each engine step runs, in order:

  * admission — the host `Scheduler` admits every queued request a slot
    and a full page reservation allow (plus `spec_k` positions of
    lookahead under speculative decoding).  With
    `ServeConfig(prefix_cache=True)` a radix prefix cache
    (`serving/prefix_cache.py`) admits a prompt's cached page-aligned
    prefix resident: its pages are shared copy-on-write, the slot's
    scratch is PRIMED from them (`PagePool.gather`), and prefill starts
    at the shared boundary;
  * chunked prefill — every prefilling slot advances ONE chunk
    (`models/generation.extend_cache`) into its own dense scratch cache,
    so a long prompt adds engine steps for its own slot and never stalls
    the decode batch; on its last chunk the scratch K/V are written into
    the slot's own pages (`PagePool.write_pages`, quantized in the
    int8/int4 page modes; shared pages are never written), the prompt is
    indexed in the prefix cache, and the first token is taken from the
    last valid prompt position's logits (`first_token_from_logits`);
  * decode — one gather-free step over every slot
    (`models/generation.decode_step_paged`, the `paged_attention`
    kernel), then the next token per slot; or, with
    `spec_decode="ngram"`, one VERIFY step: the host drafter proposes
    `spec_k` tokens a slot, `verify_step_paged` (the `paged_verify`
    kernel) scores the last token and the drafts in one forward, the
    fused sampling epilogue (`sample_hidden_grid`) picks the token the
    sequential path would emit at each position, and the drafts are
    accepted while they match.  With `spec_decode="model"` a draft model
    (`ModelDrafter`, resident int8) proposes with its distributions q,
    and the verify step's logits go through the full p/q rejection rule
    (`spec_decode.stochastic_verify`) instead; the fused sampler stays
    off there.  Rows that are not decoding ride along pinned to the null
    page (`_decode_table`).

Tokens are the greedy argmax, or with `ServeConfig(sampling=True)` the
seeded sampler (`serving/sampling.py`): a token's key is a pure
function of its request's seed and its position, so sampled output is
the same with and without speculation.  On the card every sampling site
runs the sampling kernels.

The reference's pool and scratch are functional arrays donated through
jitted programs; here they are tensors updated in place.  Each step
ends in a host read of the tokens, or in a device synchronize, so the
virtual clock `run()` advances by each step's wall time counts the
device's work and not only its enqueue.

The engine writes serve.* counters, gauges and histograms into a
`MetricsRegistry` (its own, unless one is passed) and, given a run log,
the reference's ``serve`` events.  The serving host layers ride on top,
all host-side policy over the same device steps: SLO-class preemptive
admission (`preempt`), per-tenant quotas (`quotas`), deadlines,
brownout shedding, replica failover under a retry budget (`fail_over`,
the chaos ``engine_kill`` point), the flight recorder (`tracer`), the
serving health detectors (`health`), the per-request cost ledger
(`cost_model`), serve-event sampling (`serve_sample`) and, under
HETU_TORCH_NUMERICS, the ``logits`` stats and the ``kv_pages``
quantization SNR of quantized pages.  A disaggregated prefill tier
hands finished prompts over through `note_remote_submit` /
`adopt_prefilled` (`serving/disagg.py`).

Token identity under preemption and failover rests on a row's bits not
depending on its neighbours: the decode GEMMs always run over all
`num_slots` rows (and a prefill chunk over its fixed width), so a
replayed request emits the tokens of the undisturbed run.  Replays
prime from exact pages only; with quantized pages a re-prefill through
a prefix hit reads dequantized values.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_tpu_torch.models.generation import (_check_context_length,
                                              decode_step_paged,
                                              extend_cache,
                                              verify_step_paged)
from hetu_tpu_torch.obs import numerics as _numerics
from hetu_tpu_torch.obs.health import (maybe_numerics_health_monitor,
                                       maybe_serving_health_monitor)
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import RunLog, default_runlog_path
from hetu_tpu_torch.serving.costs import CostLedger
from hetu_tpu_torch.serving.kv_pool import PagePool
from hetu_tpu_torch.serving.prefix_cache import RadixPrefixCache
from hetu_tpu_torch.serving.request import (Request, RequestResult,
                                            RequestStats, SamplingParams,
                                            parse_quotas, rid_sampled)
from hetu_tpu_torch.serving.sampling import (sample_hidden_grid,
                                             sample_tokens)
from hetu_tpu_torch.serving.scheduler import Scheduler
from hetu_tpu_torch.serving.spec_decode import (accept_counts, make_drafter,
                                                stochastic_verify)
from hetu_tpu_torch.serving.tracing import maybe_tracer
from hetu_tpu_torch.utils import flags
from hetu_tpu_torch.utils.device import resolve_device

#: the later slices of the port (ROADMAP.md, Queue A and B1)
_FP16_SERVING = ("the fp16 serving slice (ROADMAP Queue B1 item 5: fp16 "
                 "arms of the paged attention, page write, sampler and "
                 "dequantize kernels)")
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"
_TELEMETRY = ("the cluster telemetry slice (ROADMAP Queue A item 6: the "
              "push over rpc/)")

#: ServeConfig fields beyond this slice: name -> (default, later slice)
_LATER_FIELDS = {
    "moe_dispatch": ("gspmd", _MULTI_GPU),
    "kv_repage": (False, _MULTI_GPU),
}

#: ServingEngine keyword arguments beyond this slice
_LATER_ENGINE_ARGS = {"telemetry": _TELEMETRY, "reshard": _MULTI_GPU}


def first_token_from_logits(req, logits_row: torch.Tensor, position: int,
                            *, sampling: bool) -> int:
    """The TTFT token from a final prefill chunk's logits row: argmax
    (the first index among ties, as the reference's), or the seeded
    sampler for a sampling request — the (seed, position) key every
    sampling site shares; on the card the sampling kernel."""
    if not (sampling and req.sampling.temperature > 0):
        return int(torch.argmax(logits_row).item())
    sp = req.sampling
    tok = sample_tokens(logits_row[None], [sp.seed & 0xFFFFFFFF],
                        [position], [sp.temperature], [sp.top_k],
                        [sp.top_p], device=logits_row.device)
    return int(tok[0].item())


@dataclasses.dataclass
class ServeConfig:
    """Engine shape knobs.

    num_pages=0 sizes the pool for FULL reservation —
    num_slots * (max_len / page_size) usable pages, so admission never
    waits on pages, only on slots.

    `kv_quant` picks exact ("none"), int8 or int4 pages; `sampling`
    builds the seeded sampler (a greedy-only engine refuses sampling
    requests); `spec_decode="ngram"` verifies `spec_k` host-drafted
    tokens a step, `"model"` a draft model's tokens by the stochastic
    rule (the engine's `draft_model=`); `prefix_cache` keeps shared
    prompt prefixes resident (`prefix_cache_pages` caps the cache's
    pages, 0 = pool pressure only).

    The host policies: `preempt` lets a stalled queue head of a strictly
    higher SLO-class priority evict and requeue the lowest-priority live
    slot; `quotas` ({tenant: TenantQuota}) caps each tenant's live slots
    and pages; `serve_sample` keeps the serve events of a hashed 1-in-N
    of requests (stamped ``sample_weight``); `retry_budget` is how often
    `fail_over` may requeue one request; `deadline` enforces
    `SLOClass.deadline_s`; `brownout` sheds the lowest-priority queued
    band after `brownout_streak` steps at `brownout_page_high` page
    utilization with `brownout_queue_min` queued.  `moe_dispatch` and
    `kv_repage` keep their names and defaults; setting one raises
    NotImplementedError naming the slice that brings it."""
    num_slots: int = 8
    page_size: int = 16
    max_len: int = 256
    prefill_chunk: int = 32
    num_pages: int = 0
    kv_quant: str = "none"
    moe_dispatch: str = "gspmd"
    sampling: bool = False
    spec_decode: str = "none"
    spec_k: int = 4
    prefix_cache: bool = False
    prefix_cache_pages: int = 0
    preempt: bool = False
    quotas: dict = dataclasses.field(default_factory=dict)
    serve_sample: int = 1
    retry_budget: int = 0
    deadline: bool = False
    brownout: bool = False
    brownout_page_high: float = 0.95
    brownout_queue_min: int = 1
    brownout_streak: int = 4
    kv_repage: bool = False

    def __post_init__(self):
        for name, (default, later) in _LATER_FIELDS.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r} is not in "
                    f"the port yet; it arrives with {later}")
        if min(self.num_slots, self.page_size, self.max_len,
               self.prefill_chunk) < 1:
            raise ValueError(f"num_slots, page_size, max_len and "
                             f"prefill_chunk must be >= 1: {self}")
        if self.max_len % self.page_size:
            raise ValueError(f"max_len {self.max_len} must be a multiple "
                             f"of page_size {self.page_size}")
        if self.max_len % self.prefill_chunk:
            # the chunk program pads prompts to a chunk multiple; an
            # uneven tail would write past the max_len scratch cache
            raise ValueError(f"max_len {self.max_len} must be a multiple "
                             f"of prefill_chunk {self.prefill_chunk}")
        if self.kv_quant not in ("none", "int8", "int4"):
            raise ValueError(f"kv_quant {self.kv_quant!r} invalid; "
                             "choices: ('none', 'int8', 'int4')")
        if self.spec_decode not in ("none", "ngram", "model"):
            raise ValueError(
                f"spec_decode {self.spec_decode!r} invalid; choices: "
                "('none', 'ngram', 'model')")
        if self.spec_decode != "none" and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.serve_sample < 1:
            raise ValueError(f"serve_sample must be >= 1, "
                             f"got {self.serve_sample}")
        if self.retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, "
                             f"got {self.retry_budget}")
        if not 0.0 < self.brownout_page_high <= 1.0:
            raise ValueError(f"brownout_page_high must be in (0, 1], "
                             f"got {self.brownout_page_high}")
        if self.brownout_streak < 1 or self.brownout_queue_min < 1:
            raise ValueError(
                "brownout_streak and brownout_queue_min must be >= 1, "
                f"got {self.brownout_streak}/{self.brownout_queue_min}")
        if self.num_pages == 0:
            self.num_pages = self.num_slots * (self.max_len
                                               // self.page_size)

    @property
    def lookahead(self) -> int:
        """Cache positions a verify step may write past the sequence
        head (0 without speculative decoding): widens every page
        reservation."""
        return self.spec_k if self.spec_decode != "none" else 0

    @staticmethod
    def from_flags(**overrides) -> "ServeConfig":
        """Defaults from the serving flags (`utils/flags.py`, the
        HETU_TORCH_SERVE_* surface, HETU_TORCH_KV_QUANT, the spec-decode
        pair and HETU_TORCH_RUNLOG_SERVE_SAMPLE); explicit keywords
        win."""
        vals = dict(
            num_slots=flags.int_flag("HETU_TORCH_SERVE_SLOTS"),
            page_size=flags.int_flag("HETU_TORCH_SERVE_PAGE"),
            max_len=flags.int_flag("HETU_TORCH_SERVE_MAX_LEN"),
            prefill_chunk=flags.int_flag("HETU_TORCH_SERVE_PREFILL_CHUNK"),
            num_pages=flags.int_flag("HETU_TORCH_SERVE_PAGES"),
            kv_quant=flags.str_flag("HETU_TORCH_KV_QUANT"),
            sampling=flags.bool_flag("HETU_TORCH_SERVE_SAMPLE"),
            spec_decode=flags.str_flag("HETU_TORCH_SPEC_DECODE"),
            spec_k=flags.int_flag("HETU_TORCH_SPEC_K"),
            prefix_cache=flags.bool_flag("HETU_TORCH_SERVE_PREFIX_CACHE"),
            prefix_cache_pages=flags.int_flag(
                "HETU_TORCH_SERVE_PREFIX_PAGES"),
            preempt=flags.bool_flag("HETU_TORCH_SERVE_PREEMPT"),
            quotas=parse_quotas(flags.str_flag("HETU_TORCH_SERVE_QUOTAS")),
            serve_sample=flags.int_flag("HETU_TORCH_RUNLOG_SERVE_SAMPLE"),
            retry_budget=flags.int_flag("HETU_TORCH_SERVE_RETRY"),
            deadline=flags.bool_flag("HETU_TORCH_SERVE_DEADLINE"),
            brownout=flags.bool_flag("HETU_TORCH_SERVE_BROWNOUT"),
        )
        vals.update(overrides)
        return ServeConfig(**vals)


def _kv_heads(config) -> int:
    """K/V heads a layer caches: the config's num_key_value_heads, or
    every head where the family has no GQA (GPT), as the reference's
    `init_cache` reads it."""
    return getattr(config, "num_key_value_heads", config.num_attention_heads)


class ServingEngine:
    """Continuous-batching facade over a `LlamaLMHeadModel` or a
    `GPTLMHeadModel`.

    `device` ("cuda" by default) must be the model's device; on a CUDA
    device the decode step runs the hand-written kernels, on the CPU
    their plain versions.  `draft_model` (with
    `ServeConfig(spec_decode="model")`) is a second model of the same
    vocabulary on the same device; the engine's `ModelDrafter` keeps its
    own int8 copy of the matrices and leaves the model as it was.  The
    port's models hold their own weights, so the reference's
    `draft_params` has no counterpart and is refused.

    `run_log` (a `RunLog`; else HETU_TORCH_RUNLOG opens one the engine
    owns and `close()` closes), `tracer` (a `RequestTracer`; else
    HETU_TORCH_SERVE_TRACE), `health` (a `ServingHealthMonitor`; else
    HETU_TORCH_HEALTH) and `cost_model` (a `CostModel`: every done event
    carries its cost fields) are the reference's keywords.  Several
    engines may share one model (its weights once): each holds its own
    pool, scheduler and scratch."""

    def __init__(self, model, config: Optional[ServeConfig] = None, *,
                 run_log: Optional[RunLog] = None,
                 registry: Optional[MetricsRegistry] = None, tracer=None,
                 health=None, drafter=None, draft_model=None,
                 cost_model=None, device="cuda", **later):
        for name in later:
            if name == "draft_params":
                raise TypeError(
                    "ServingEngine(draft_params=...) has no counterpart in "
                    "the port: a port model holds its own weights, so pass "
                    "the draft model alone as draft_model=")
            if name not in _LATER_ENGINE_ARGS:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            raise NotImplementedError(
                f"ServingEngine({name}=...) is not in the port yet; it "
                f"arrives with {_LATER_ENGINE_ARGS[name]}")
        for m in (model, draft_model):
            policy = getattr(getattr(m, "config", None), "policy", None)
            if policy is not None and policy.compute_dtype == torch.float16:
                raise NotImplementedError(
                    f"serving a model that computes in float16 is not in the "
                    f"port yet; it arrives with {_FP16_SERVING}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked for {self.device}")
        self.model = model
        self.config = config or ServeConfig.from_flags()
        c = model.config
        _check_context_length(c, self.config.max_len)
        self.pool = PagePool(
            num_layers=c.num_hidden_layers,
            num_pages=self.config.num_pages,
            page_size=self.config.page_size,
            num_kv_heads=_kv_heads(c), head_dim=c.head_dim,
            dtype=c.compute_dtype, quant=self.config.kv_quant,
            device=self.device)
        # radix prefix cache: shared prompt prefixes admit resident
        self.prefix_cache = None
        if self.config.prefix_cache:
            self.prefix_cache = RadixPrefixCache(
                self.pool, max_pages=self.config.prefix_cache_pages)
        self.scheduler = Scheduler(num_slots=self.config.num_slots,
                                   pool=self.pool,
                                   max_len=self.config.max_len,
                                   prefix_cache=self.prefix_cache,
                                   lookahead=self.config.lookahead,
                                   quotas=self.config.quotas,
                                   retry_budget=self.config.retry_budget)
        # per-request cost ledger (serving/costs.py): with a CostModel
        # every done event carries the analytic cost_* fields
        self.ledger = CostLedger(cost_model) if cost_model is not None \
            else None
        # speculative decoding: the host drafter (`drafter=` overrides
        # the config's mode; the verify step and the page lookahead are
        # sized by the config, so a drafter needs spec_decode set)
        if drafter is not None and self.config.spec_decode == "none":
            raise ValueError("a custom drafter needs spec_decode set "
                             "(e.g. ServeConfig(spec_decode='ngram')) so "
                             "the verify step and page lookahead exist")
        draft_kw = {}
        if draft_model is not None:
            if self.config.spec_decode != "model" or drafter is not None:
                raise ValueError("draft_model= drafts only under "
                                 "ServeConfig(spec_decode='model') and "
                                 "without a drafter=")
            if draft_model.device != self.device:
                raise ValueError(f"the draft model lives on "
                                 f"{draft_model.device}, the engine on "
                                 f"{self.device}")
            if draft_model.config.vocab_size != c.vocab_size:
                raise ValueError("the draft model's vocabulary differs "
                                 "from the target's")
            draft_kw = {"model": draft_model}
        self.drafter = (drafter if drafter is not None
                        else make_drafter(self.config.spec_decode,
                                          **draft_kw))
        self.spec = self.drafter is not None
        #: stochastic drafters report their proposal distributions and
        #: are verified by the full p/q rejection rule
        self.spec_stochastic = bool(
            self.spec and getattr(self.drafter, "stochastic", False))
        #: per-rid preemption counts and the work counters accrued before
        #: each requeue (a request survives its requeues, its SlotState
        #: does not): folded back into the final done event
        self._preempt_counts = {}
        self._carried_stats = {}
        #: fault terminations made between steps (fail_over, a max_new=1
        #: adoption) park here until the next step hands them out
        self._fault_results: List[RequestResult] = []
        #: consecutive steps at brownout pressure
        self._brownout_hot = 0
        #: caller-clock time at the end of the last step: the default
        #: timestamp of between-step fault events
        self._last_clock = 0.0
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        if run_log is None:
            path = default_runlog_path(None)
            run_log = RunLog(path) if path else None
            self._owns_runlog = run_log is not None
        else:
            self._owns_runlog = False
        self.run_log = run_log
        #: the timestamp basis every serve event and span declares (the
        #: engine runs on its caller's clock, virtual under run())
        self.clock_basis = "driver"
        self.tracer = tracer if tracer is not None else \
            maybe_tracer(run_log=self.run_log, registry=self.registry)
        self.health = health if health is not None else \
            maybe_serving_health_monitor(runlog=self.run_log,
                                         registry=self.registry)
        self.steps_done = 0
        # the numerics observatory (HETU_TORCH_NUMERICS), read once: the
        # decode/verify steps and the page writes run inside a collector
        # ("logits" stats, and the kv_pages SNR of quantized pages); the
        # latest non-empty stats are recorded every
        # HETU_TORCH_NUMERICS_EVERY steps and watched by the numerics
        # health detectors under HETU_TORCH_HEALTH
        self._numerics = _numerics.numerics_enabled()
        self._numerics_every = _numerics.record_every()
        self._numerics_stats = None
        self._num_health = (maybe_numerics_health_monitor(
            runlog=self.run_log, registry=self.registry)
            if self._numerics else None)

    # ------------------------------------------------------- device work
    def _new_scratch(self):
        """A zeroed dense [L, 1, max_len, n_kv, hd] K/V pair for one
        prefilling request (the reference's zero template)."""
        c = self.model.config
        shape = (c.num_hidden_layers, 1, self.config.max_len,
                 _kv_heads(c), c.head_dim)
        return (torch.zeros(shape, dtype=c.compute_dtype, device=self.device),
                torch.zeros(shape, dtype=c.compute_dtype, device=self.device))

    def _pools(self) -> dict:
        """The pool arguments of the paged forwards."""
        p = self.pool
        if p.quant == "none":
            return {}
        return dict(k_scale=p.k_scale, v_scale=p.v_scale, kv_quant=p.quant)

    def _sample_args(self, active):
        """Per-slot sampling inputs on the host (rows that are not
        decoding, and every row of a greedy-only engine, ride along
        greedy at seed 0); the sampler moves them to the device in one
        copy with the tokens' keys (`sampling.row_args`)."""
        S = self.config.num_slots
        seeds = np.zeros(S, np.int64)
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int32)
        top_ps = np.zeros(S, np.float32)
        if self.config.sampling:
            for i in active:
                sp = self.scheduler.slots[i].request.sampling
                seeds[i] = sp.seed & 0xFFFFFFFF
                temps[i] = sp.temperature
                top_ks[i] = sp.top_k
                top_ps[i] = sp.top_p
        return seeds, temps, top_ks, top_ps

    def _decode(self, table: np.ndarray, tokens: np.ndarray,
                positions: np.ndarray, active) -> np.ndarray:
        """One decode step over every slot; returns the next token per
        slot on the host (the read waits for the device): the argmax,
        or under `sampling` the seeded sampler at each token's position
        (its input token sits at positions[s])."""
        dev = self.device
        # positions stay on the host: the forward checks them there
        logits = decode_step_paged(
            self.model, torch.as_tensor(tokens, device=dev), self.pool.k,
            self.pool.v, torch.as_tensor(table, device=dev), positions,
            **self._pools())[0]
        if not self.config.sampling:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        seeds, temps, top_ks, top_ps = self._sample_args(active)
        return sample_tokens(logits, seeds, positions.astype(np.int64) + 1,
                             temps, top_ks, top_ps, device=dev).cpu().numpy()

    def _verify(self, table: np.ndarray, tokens: np.ndarray,
                positions: np.ndarray, active, q_probs=None):
        """One verify step over every slot: tokens [S, k+1] (the last
        emitted token + k drafts).  Returns (targets [S, k+1], n_emit
        [S]) on the host: the tokens to emit at each position and how
        many of them (the accepted draft prefix + 1).  Without
        `q_probs` a draft is accepted while it matches the sequential
        path's token; with q_probs [S, k, V] (a stochastic drafter's
        distributions) by the p/q rejection rule over the logits."""
        dev = self.device
        tok = torch.as_tensor(tokens, device=dev)
        out = verify_step_paged(
            self.model, tok, self.pool.k, self.pool.v,
            torch.as_tensor(table, device=dev), positions,
            return_hidden=q_probs is None, **self._pools())[0]
        # the token picked at grid position i sits at positions + i + 1
        pos_grid = positions.astype(np.int64)[:, None] + np.arange(
            1, tokens.shape[1] + 1)
        seeds, temps, top_ks, top_ps = self._sample_args(active)
        if q_probs is not None:
            targets, n_emit = stochastic_verify(
                out, q_probs, tokens[:, 1:], seeds, pos_grid, temps, top_ks,
                top_ps)
            return targets.cpu().numpy(), n_emit.cpu().numpy()
        hidden = out
        targets = sample_hidden_grid(
            hidden, self.model.lm_head_weight(), seeds, pos_grid, temps,
            top_ks, top_ps, device=dev).cpu().numpy()
        return targets, accept_counts(targets, tokens[:, 1:])

    @contextlib.contextmanager
    def _collect(self):
        """Run a decode, verify or page write inside a numerics collector
        (under HETU_TORCH_NUMERICS; else nothing): its stats, when any,
        become the latest to record."""
        if not self._numerics:
            yield
            return
        with _numerics.collecting() as col:
            yield
            stats = col.finalize()
        if stats:
            self._numerics_stats = stats

    def _write_pages(self, pages_row: np.ndarray, ks, vs):
        with self._collect():
            self.pool.write_pages(pages_row, ks, vs)

    def _maybe_record_numerics(self):
        """Every HETU_TORCH_NUMERICS_EVERY engine steps, read the latest
        stats to the host and record them (RunLog record, registry
        gauges), then feed the numerics health detectors."""
        if (not self._numerics or self._numerics_stats is None
                or self.steps_done % self._numerics_every):
            return
        stats, self._numerics_stats = self._numerics_stats, None
        _numerics.record(stats, step=self.steps_done,
                         registry=self.registry, runlog=self.run_log)
        if self._num_health is not None:
            self._num_health.observe(self.steps_done, stats)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Run each piece of the step once — a decode (or verify) over
        the null page, one prefill chunk, one page write, and under
        `sampling` one sampled first token — so the first request's TTFT
        holds no kernel build or library start-up.  Only the null page
        is written, so pool content is untouched."""
        S, C = self.config.num_slots, self.config.prefill_chunk
        zeros = np.zeros(S, np.int32)
        table = np.zeros_like(self.scheduler.page_table)
        if self.spec:
            q_probs = None
            if self.spec_stochastic:
                k, V = self.config.spec_k, self.model.config.vocab_size
                q_probs = torch.full((S, k, V), 1.0 / V,
                                     device=self.device)
                self.drafter.propose_with_probs([0], 1)
            with self._collect():
                self._verify(table, np.zeros((S, self.config.spec_k + 1),
                                             np.int32), zeros, [], q_probs)
        else:
            with self._collect():
                self._decode(table, zeros, zeros, [])
        scratch = self._new_scratch()
        logits, _ = extend_cache(self.model,
                                 torch.zeros((1, C), dtype=torch.long,
                                             device=self.device), scratch, 0)
        null_row = np.zeros(self.scheduler.max_pages, np.int32)
        self._write_pages(null_row, scratch[0][:, 0], scratch[1][:, 0])
        if self.prefix_cache is not None:
            self.pool.gather(null_row)
        if self.config.sampling:
            probe = Request(rid=-1, prompt=np.ones(1, np.int32),
                            max_new_tokens=1,
                            sampling=SamplingParams(temperature=1.0))
            first_token_from_logits(probe, logits[0, 0], 1, sampling=True)
        self._sync()
        return self


    # ----------------------------------------------------------- intake
    def _check_sampling(self, req: Request):
        if req.sampling.temperature > 0 and not self.config.sampling:
            raise ValueError(
                f"request {req.rid} asks for sampling (temperature "
                f"{req.sampling.temperature}) but the engine was built "
                "greedy-only — set HETU_TORCH_SERVE_SAMPLE=1 / "
                "ServeConfig(sampling=True)")

    def submit(self, req: Request, now: Optional[float] = None):
        self._check_sampling(req)
        if now is not None:
            req.arrival_t = now
        self.scheduler.submit(req)
        self.registry.inc("serve.requests_submitted")
        self.registry.inc("serve.requests_submitted_class",
                          slo_class=req.slo.name)
        if self.tracer is not None:
            self.tracer.on_submit(req)

    def note_remote_submit(self, req: Request,
                           now: Optional[float] = None):
        """Account a request whose PREFILL runs on a remote tier
        (serving/disagg.py): the submission counters and the tracer's
        queued span open here, on the decode engine that will own the
        request, but the request does not enter the scheduler queue (it
        admits through `adopt_prefilled` when its KV shipment lands, or
        through the queue on colocation fallback)."""
        self._check_sampling(req)
        if now is not None:
            req.arrival_t = now
        self.registry.inc("serve.requests_submitted")
        self.registry.inc("serve.requests_submitted_class",
                          slo_class=req.slo.name)
        if self.tracer is not None:
            self.tracer.on_submit(req)

    def adopt_prefilled(self, req: Request,
                        unpack: Callable[[], Tuple[torch.Tensor,
                                                   torch.Tensor]],
                        t1: int, now: float) -> bool:
        """Adopt a prefill tier's KV shipment (serving/disagg.py): admit
        `req` straight into a free slot (`admit_direct`, it never
        queues), call `unpack` once the slot is granted for the shipped
        scratch K/V [L, max_len, n_kv, hd] on this engine's device,
        write it into the slot's pages with the page write colocated
        prefill uses, seed the stream with the shipped first token and
        join the decode batch.  The prefill tier ran the same
        chunk forward, so with an exact wire the pool holds what a
        colocated prefill writes and every later token is the same.
        False = no slot, reservation or quota headroom now; the caller
        retries next step."""
        adm = self.scheduler.admit_direct(req, now)
        if adm is None:
            reason = self.scheduler.last_stall or "none"
            self.registry.inc("serve.admission_stalls", reason=reason)
            if self.tracer is not None:
                self.tracer.on_stall([req.rid], reason)
            return False
        slot_idx, st = adm
        if self.ledger is not None:
            self.ledger.on_admit(req.rid, len(st.pages), now)
        if self.tracer is not None:
            self.tracer.on_admit(req, slot_idx, now, shared_tokens=0)
        pages_row = np.full(self.scheduler.max_pages, PagePool.NULL_PAGE,
                            np.int32)
        pages_row[: len(st.pages)] = st.pages
        self._write_pages(pages_row, *unpack())
        st.prefilling = False
        st.pos = req.prompt_len
        st.generated.append(int(t1))
        st.stats.first_token_t = now
        ttft = st.stats.ttft_s
        self.registry.observe("serve.ttft_s", ttft)
        self.registry.observe("serve.ttft_s_class", ttft,
                              slo_class=req.slo.name)
        if st.stats.queue_wait_s is not None:
            self.registry.observe("serve.queue_wait_s",
                                  st.stats.queue_wait_s)
        self.registry.inc("serve.tokens_out")
        self.registry.inc("serve.disagg_adoptions")
        if self.tracer is not None:
            self.tracer.on_first_token(req, slot_idx, now, chunk=0)
        if self.health is not None:
            self.health.observe_ttft(ttft, step=self.steps_done, t=now)
        if self._sampled(req.rid):
            self._log_serve(event="admit", req=req.rid,
                            slot=slot_idx, prompt_len=req.prompt_len,
                            chunks=0, ttft_s=ttft,
                            queue_wait_s=st.stats.queue_wait_s, now=now,
                            slo_class=req.slo.name, tenant=req.tenant,
                            shared_tokens=0, disagg=True,
                            queue_depth=self.scheduler.queue_depth,
                            page_util=self.pool.utilization,
                            **self._weight_fields())
        # a max_new=1 request finishes at adoption: its result waits
        # with the between-step fault results for the next step()
        self._maybe_finish(slot_idx, st, int(t1), now,
                           self._fault_results)
        return True

    def _sampled(self, rid: int) -> bool:
        """Does `rid` emit per-request serve events?  The deterministic
        hashed 1-in-N of `serve_sample` (`rid_sampled`); registry
        counters are never sampled."""
        return rid_sampled(rid, self.config.serve_sample)

    def _weight_fields(self) -> dict:
        """The sample_weight stamp of sampled per-request events (only
        when sampling is on: the N=1 record shape is unchanged)."""
        n = self.config.serve_sample
        return {"sample_weight": n} if n > 1 else {}

    def _log_serve(self, **fields):
        """One serve event to the run log, stamped with its ``clock``
        basis."""
        fields.setdefault("clock", self.clock_basis)
        if self.run_log is not None:
            self.run_log.log("serve", **fields)

    # ------------------------------------------------------------- step
    def _decode_table(self, active) -> np.ndarray:
        """Page-table input for the decode batch: only decoding slots'
        rows are real; prefilling and empty rows are pinned to the null
        page.  The scheduler fills a slot's row at ADMISSION, so a slot
        still prefilling already points at live pages: its ride-along
        (token 0, position 0) write must land in the null page, not in
        row 0 of its first page (under the prefix cache, a shared
        page)."""
        table = np.zeros_like(self.scheduler.page_table)
        for i in active:
            table[i] = self.scheduler.page_table[i]
        return table

    def step(self, now: float) -> List[RequestResult]:
        """One engine iteration at time `now` on the caller's clock:
        expire deadlines, admit every admissible queued request
        (preempting under `preempt`), advance each PREFILLING slot by
        exactly ONE chunk, then one decode step over the slots whose
        prefill is complete; then the gauges, health and brownout.
        Returns requests that finished this step (fault terminations
        made between steps included)."""
        t0 = time.perf_counter()

        def clock() -> float:
            return now + (time.perf_counter() - t0)

        finished: List[RequestResult] = []
        if self._fault_results:
            finished.extend(self._fault_results)
            self._fault_results.clear()
        if self.config.deadline:
            # before admissions: an expired queued request must not take
            # a slot on the step it dies
            self._expire_deadlines(clock(), finished)
        while True:
            t_adm = clock()
            adm = self.scheduler.admit_next(t_adm)
            if adm is None:
                # SLO-class preemption: a stalled head of strictly
                # higher priority may evict the lowest-priority live
                # slot and retry the admission
                if (self.config.preempt and self.scheduler.queue
                        and self._try_preempt(clock())):
                    continue
                break
            slot_idx, st = adm
            st.prefilling = True
            if self.ledger is not None:
                self.ledger.on_admit(st.request.rid, len(st.pages), t_adm)
            self._start_prefill(st)
            if self.tracer is not None:
                self.tracer.on_admit(st.request, slot_idx, t_adm,
                                     shared_tokens=st.shared_tokens)
        if self.scheduler.queue:
            # admission declined with work queued: count the stall and
            # stamp the scheduler's attribution on every waiting request
            reason = self.scheduler.last_stall or "none"
            self.registry.inc("serve.admission_stalls", reason=reason)
            if self.tracer is not None:
                self.tracer.on_stall(
                    [r.rid for r in self.scheduler.queue], reason)

        for i in self.scheduler.active_slots():
            st = self.scheduler.slots[i]
            if st is not None and st.prefilling:
                self._advance_prefill(i, st, clock, finished)

        active = [i for i in self.scheduler.active_slots()
                  if not self.scheduler.slots[i].prefilling]
        if active:
            td = time.perf_counter()
            # inputs derived from scheduler state every step: the last
            # emitted token + next write position per decoding slot;
            # other rows ride along at (0, 0) on the null page
            S = self.config.num_slots
            positions = np.zeros(S, np.int32)
            for i in active:
                positions[i] = self.scheduler.slots[i].pos
            with self._collect():
                if self.spec:
                    emitted = self._spec_decode_step(active, positions)
                else:
                    tokens = np.zeros(S, np.int32)
                    for i in active:
                        tokens[i] = self.scheduler.slots[i].generated[-1]
                    nxt = self._decode(self._decode_table(active), tokens,
                                       positions, active)
                    emitted = {i: [int(nxt[i])] for i in active}
            decode_wall = time.perf_counter() - td
            self.registry.inc("serve.decode_steps")
            # the user-visible inter-token gap IS the step wall (every
            # active slot advances at least one token); the per-token
            # engine cost is its own series
            n_emitted = sum(len(v) for v in emitted.values())
            self.registry.observe("serve.token_latency_s", decode_wall)
            self.registry.observe("serve.token_cost_s",
                                  decode_wall / max(n_emitted, 1))
            tnow = clock()
            n_done0 = len(finished)
            for i in active:
                st = self.scheduler.slots[i]
                for tok in emitted[i]:
                    st.generated.append(tok)
                    st.pos += 1
                    self.registry.inc("serve.tokens_out")
                    if self.tracer is not None:
                        self.tracer.on_token(st.request, tnow)
                    self._maybe_finish(i, st, tok, tnow, finished)
                    if self.scheduler.slots[i] is None:
                        break            # finished: drop surplus drafts
            if self.tracer is not None and len(finished) > n_done0:
                # an eviction changed the batch: split the survivors'
                # decode segments so the boundary shows
                survivors = [self.scheduler.slots[i].request.rid
                             for i in self.scheduler.active_slots()
                             if not self.scheduler.slots[i].prefilling]
                if survivors:
                    self.tracer.on_split(survivors, tnow, "evict")

        self.steps_done += 1
        self._maybe_record_numerics()
        self.registry.set_gauge("serve.queue_depth",
                                self.scheduler.queue_depth)
        self.registry.set_gauge("serve.slot_occupancy",
                                self.scheduler.occupancy)
        self.registry.set_gauge("serve.page_util", self.pool.utilization)
        for t in self.config.quotas:
            # each quota'd tenant's live usage, so a snapshot shows who
            # is pinned at their cap
            self.registry.set_gauge("serve.tenant_slots",
                                    self.scheduler.tenant_slots.get(t, 0),
                                    tenant=t)
            self.registry.set_gauge("serve.tenant_pages",
                                    self.scheduler.tenant_pages.get(t, 0),
                                    tenant=t)
        if self.health is not None:
            self.health.observe_step(
                self.steps_done, queue_depth=self.scheduler.queue_depth,
                page_util=self.pool.utilization, t=clock())
        if self.config.brownout:
            self._maybe_brownout(clock(), finished)
        # a step without a decode ends in no host read: wait for the
        # device so the run's clock counts the prefill work
        self._sync()
        self._last_clock = clock()
        return finished

    # ----------------------------------------------------------- faults
    def _carry(self, req, st):
        """Keep a discarded incarnation's work counters for the final
        done event."""
        carried = self._carried_stats.setdefault(
            req.rid, {"spec_proposed": 0, "spec_accepted": 0,
                      "prefill_chunks": 0})
        carried["spec_proposed"] += st.stats.spec_proposed
        carried["spec_accepted"] += st.stats.spec_accepted
        carried["prefill_chunks"] += st.stats.prefill_chunks

    def _fold_stats(self, req, stats):
        """The preemption and retry counts and the carried work counters
        of `req`, folded into its final stats."""
        stats.preemptions = self._preempt_counts.pop(req.rid, 0)
        stats.retries = self.scheduler.retries.pop(req.rid, 0)
        carried = self._carried_stats.pop(req.rid, None)
        if carried is not None:
            stats.spec_proposed += carried["spec_proposed"]
            stats.spec_accepted += carried["spec_accepted"]
            stats.prefill_chunks += carried["prefill_chunks"]

    def _finish_faulted(self, req, now: float, finished, *, reason: str,
                        event: str, tokens, st=None, slot=None):
        """Terminate `req` with a fault outcome (`deadline_exceeded`,
        `brownout_shed`, `retry_exhausted`): the bookkeeping of a finish
        (carried stats, ledger cost, counters, a sampled serve event)
        for a request the model did not finish.  `st`/`slot` name a live
        incarnation, whose ledger entry closes; queued casualties pass
        neither and cost nothing."""
        stats = st.stats if st is not None else RequestStats(
            arrival_t=req.arrival_t)
        stats.done_t = now
        self._fold_stats(req, stats)
        res = RequestResult(rid=req.rid, tokens=list(tokens),
                            finished_reason=reason, stats=stats)
        self.registry.inc(f"serve.{reason}")
        self.registry.inc(f"serve.{reason}_class", slo_class=req.slo.name)
        cost = {}
        if self.ledger is not None and st is not None:
            cost = self.ledger.finish(
                req.rid, now, prompt_len=req.prompt_len,
                shared_tokens=stats.shared_prefix_tokens,
                tokens_out=len(res.tokens))
        if self._sampled(req.rid):
            self._log_serve(
                event=event, req=req.rid, reason=reason,
                tokens=len(res.tokens), e2e_s=stats.e2e_s, now=now,
                slo_class=req.slo.name, tenant=req.tenant,
                retries=stats.retries, preemptions=stats.preemptions,
                queue_depth=self.scheduler.queue_depth,
                **({"slot": slot} if slot is not None else {}),
                **cost, **self._weight_fields())
        finished.append(res)
        return res

    def fail_over(self, now: Optional[float] = None) -> dict:
        """The serving replica dies and a recovery replica takes over on
        the spot (the chaos `engine_kill` point, called between steps
        from the run() on_step hook): every in-flight request loses its
        slot, pages and partial output.  A request with retry budget
        left re-enters the queue head behind a `replica_lost` stall and
        re-prefills on re-admission; greedy argmax and the
        (seed, position)-keyed sampler are pure functions of the prompt,
        so the replayed stream equals the undisturbed run's.  Past the
        budget a request terminates `retry_exhausted`, handed out by the
        next step().  The model, pool tensors and kernels survive (the
        recovery replica inherits them).  Returns ``{"requeued": [rids],
        "exhausted": [rids]}``."""
        now = self._last_clock if now is None else now
        requeued: List[int] = []
        exhausted: List[int] = []
        self.registry.inc("serve.failovers")
        for i in list(self.scheduler.active_slots()):
            st = self.scheduler.slots[i]
            req = st.request
            if (self.scheduler.retries.get(req.rid, 0)
                    < self.config.retry_budget):
                # the work counters survive the requeue; the ledger
                # bills the discarded incarnation (it re-runs)
                self._carry(req, st)
                if self.ledger is not None:
                    self.ledger.on_preempt(req.rid, now,
                                           ctx_start=st.shared_tokens,
                                           tokens_cached=st.pos)
                self.scheduler.requeue_lost(i)
                self.registry.inc("serve.replica_requeues")
                self.registry.inc("serve.replica_requeues_class",
                                  slo_class=req.slo.name)
                if self.tracer is not None:
                    self.tracer.on_replica_lost(req, i, now)
                if self._sampled(req.rid):
                    self._log_serve(
                        event="retry", req=req.rid, slot=i, now=now,
                        attempt=self.scheduler.retries[req.rid] + 1,
                        slo_class=req.slo.name, tenant=req.tenant,
                        tokens_discarded=len(st.generated),
                        **self._weight_fields())
                requeued.append(req.rid)
            else:
                if self.tracer is not None:
                    self.tracer.on_finish(
                        req, i, "retry_exhausted", now,
                        tokens=len(st.generated),
                        e2e_s=now - float(req.arrival_t), evicted=True)
                tokens = list(st.generated)
                self.scheduler.release(i)
                self._finish_faulted(req, now, self._fault_results,
                                     reason="retry_exhausted",
                                     event="evict", tokens=tokens,
                                     st=st, slot=i)
                exhausted.append(req.rid)
        self._log_serve(event="failover", now=now,
                        requeued=len(requeued),
                        exhausted=len(exhausted),
                        queue_depth=self.scheduler.queue_depth)
        return {"requeued": requeued, "exhausted": exhausted}

    def _expire_deadlines(self, now: float, finished):
        """Terminate every queued or live request older than its SLO
        class deadline as `deadline_exceeded` (traced, costed, counted
        and returned like any finish)."""
        for req in [r for r in self.scheduler.queue
                    if r.slo.deadline_s is not None
                    and now - r.arrival_t > r.slo.deadline_s]:
            if not self.scheduler.drop_queued(req):
                continue
            if self.tracer is not None:
                self.tracer.on_expire(req, now,
                                      e2e_s=now - float(req.arrival_t))
            self._finish_faulted(req, now, finished,
                                 reason="deadline_exceeded",
                                 event="expired", tokens=[])
        for i in list(self.scheduler.active_slots()):
            st = self.scheduler.slots[i]
            req = st.request
            d = req.slo.deadline_s
            if d is None or now - req.arrival_t <= d:
                continue
            if self.tracer is not None:
                self.tracer.on_expire(req, now,
                                      tokens=len(st.generated),
                                      e2e_s=now - float(req.arrival_t))
            tokens = list(st.generated)
            self.scheduler.release(i)
            self._finish_faulted(req, now, finished,
                                 reason="deadline_exceeded",
                                 event="expired", tokens=tokens,
                                 st=st, slot=i)

    def _maybe_brownout(self, now: float, finished):
        """Sustained-pressure shedding: page utilization >=
        brownout_page_high with >= brownout_queue_min queued for
        brownout_streak consecutive steps sheds the LOWEST-priority
        queued band as `brownout_shed`, metered through the health
        monitor when one is attached.  Driven by pool and queue state
        alone, never the clock."""
        c = self.config
        if not (self.pool.utilization >= c.brownout_page_high
                and self.scheduler.queue_depth >= c.brownout_queue_min):
            self._brownout_hot = 0
            return
        self._brownout_hot += 1
        if self._brownout_hot < c.brownout_streak:
            return
        self._brownout_hot = 0
        lowest = min(r.slo.priority for r in self.scheduler.queue)
        shed = [r for r in self.scheduler.queue
                if r.slo.priority == lowest]
        for req in shed:
            if not self.scheduler.drop_queued(req):
                continue
            if self.tracer is not None:
                self.tracer.on_shed(req, now)
            self._finish_faulted(req, now, finished,
                                 reason="brownout_shed", event="shed",
                                 tokens=[])
        if self.health is not None:
            self.health.note_brownout(self.steps_done, shed=len(shed),
                                      page_util=self.pool.utilization,
                                      t=now)

    # ------------------------------------------------------ spec decode
    def _spec_decode_step(self, active, positions):
        """One speculative step over the active slots: draft k tokens a
        slot, verify all k + 1 in ONE batched forward, and accept by
        sample-then-match — or by the full p/q rejection rule when the
        drafter reports its proposal distributions.  Returns {slot:
        emitted tokens} (>= 1 a slot)."""
        S, k = self.config.num_slots, self.config.spec_k
        w = self.drafter.window
        tokens = np.zeros((S, k + 1), np.int32)
        q_probs = (torch.zeros((S, k, self.model.config.vocab_size),
                               device=self.device)
                   if self.spec_stochastic else None)
        for i in active:
            st = self.scheduler.slots[i]
            # only the trailing window the drafter reads
            if w:
                from_prompt = max(0, w - len(st.generated))
                ctx = (st.request.prompt[st.request.prompt_len
                                         - from_prompt:].tolist()
                       + st.generated[-w:])
            else:
                ctx = st.request.prompt.tolist() + st.generated
            tokens[i, 0] = st.generated[-1]
            if q_probs is not None:
                sp = st.request.sampling
                tokens[i, 1:], q = self.drafter.propose_with_probs(
                    ctx, k, seed=sp.seed & 0xFFFFFFFF,
                    start_pos=int(positions[i]) + 1)
                q_probs[i] = torch.as_tensor(q, device=self.device)
            else:
                tokens[i, 1:] = self.drafter.propose(ctx, k)
        targets, n_emit = self._verify(self._decode_table(active), tokens,
                                       positions, active, q_probs)
        emitted = {}
        for i in active:
            n = int(n_emit[i])
            emitted[i] = [int(t) for t in targets[i, :n]]
            st = self.scheduler.slots[i]
            st.stats.spec_proposed += k
            st.stats.spec_accepted += n - 1
            self.registry.inc("serve.spec_proposed", k)
            self.registry.inc("serve.spec_accepted", n - 1)
            self.registry.observe("serve.spec_emitted", float(n))
        return emitted

    # ------------------------------------------------------- preemption
    def _try_preempt(self, now: float) -> bool:
        """Evict and requeue the lowest-priority live slot when the
        stalled queue head outranks it.  True when a slot was freed (the
        caller retries the admission)."""
        head = self.scheduler.queue[0]
        victim = self.scheduler.preempt_victim(head.slo.priority)
        if victim is None:
            return False
        st = self.scheduler.slots[victim]
        req = st.request
        self._preempt_counts[req.rid] = \
            self._preempt_counts.get(req.rid, 0) + 1
        self._carry(req, st)
        if self.ledger is not None:
            # the victim's discarded work is part of what the request
            # cost (it re-runs on re-admission)
            self.ledger.on_preempt(req.rid, now,
                                   ctx_start=st.shared_tokens,
                                   tokens_cached=st.pos)
        self.scheduler.preempt(victim)
        self.registry.inc("serve.preemptions")
        self.registry.inc("serve.preemptions_class", slo_class=req.slo.name)
        if self.tracer is not None:
            self.tracer.on_preempt(req, victim, now, by=head.rid)
        if self._sampled(req.rid):
            self._log_serve(event="preempt", req=req.rid, slot=victim,
                            by=head.rid, by_class=head.slo.name,
                            slo_class=req.slo.name, tenant=req.tenant,
                            now=now,
                            tokens_discarded=len(st.generated),
                            queue_depth=self.scheduler.queue_depth,
                            **self._weight_fields())
        return True

    # ---------------------------------------------------------- prefill
    def _start_prefill(self, st):
        """Attach the prefill scratch to a freshly admitted slot (each
        live prefill its own; it is dropped with the slot when the
        prefill completes, or the request is preempted, lost or
        expired).  With a prefix-cache hit the scratch is PRIMED: the
        shared pages are read into positions [0, shared_tokens)
        (`PagePool.gather`; exact pages give back the bytes written at
        caching time, quantized ones their dequantized values), so the
        suffix chunks attend over the resident prefix and prefill covers
        the suffix only."""
        if st.shared_tokens:
            row = np.full(self.scheduler.max_pages, PagePool.NULL_PAGE,
                          np.int32)
            shared_pages = st.shared_tokens // self.pool.page_size
            row[:shared_pages] = st.pages[:shared_pages]
            st.prefill_cache = self.pool.gather(row)
            self.registry.inc("serve.prefix_hits")
            self.registry.inc("serve.prefix_shared_tokens",
                              st.shared_tokens)
        else:
            st.prefill_cache = self._new_scratch()
            if self.prefix_cache is not None:
                self.registry.inc("serve.prefix_misses")
        if self.prefix_cache is not None:
            self.registry.set_gauge("serve.prefix_cache_pages",
                                    self.prefix_cache.num_pages)

    def _advance_prefill(self, slot_idx: int, st, clock, finished):
        """Run ONE prefill chunk for a prefilling slot; on the last
        chunk, write the scratch K/V into the slot's own pages, index the
        prompt in the prefix cache, emit the first token, and join the
        decode batch.  A prefix hit starts chunking at the shared
        boundary (the primed prefix is already in the scratch) and never
        writes the shared pages.  A chunk that would run past max_len
        (a shared boundary off the chunk grid) is cut at max_len."""
        req = st.request
        plen = req.prompt_len
        C = self.config.prefill_chunk
        base = st.shared_tokens
        padded = base + math.ceil((plen - base) / C) * C
        s = base + st.chunks_done * C
        ids = np.zeros(min(C, self.config.max_len - s), np.int64)
        seg = req.prompt[s: min(s + C, plen)]
        ids[: len(seg)] = seg
        logits, _ = extend_cache(
            self.model, torch.as_tensor(ids[None], device=self.device),
            st.prefill_cache, s)
        st.chunks_done += 1
        st.stats.prefill_chunks += 1
        self.registry.inc("serve.prefill_chunks")
        if s + C < padded:
            if self.tracer is not None:
                self.tracer.on_chunk(req, clock(), st.chunks_done)
            return                        # more chunks: next engine step
        # the first generated token sits at the last VALID prompt
        # position of the final chunk (the padding tail is garbage)
        t1 = first_token_from_logits(req, logits[0, plen - 1 - s], plen,
                                     sampling=self.config.sampling)
        # write only the slot's own pages: the shared prefix's entries
        # point at the null page, which write_pages skips
        pages_row = np.full(self.scheduler.max_pages, PagePool.NULL_PAGE,
                            np.int32)
        pages_row[: len(st.pages)] = st.pages
        pages_row[: base // self.pool.page_size] = PagePool.NULL_PAGE
        ck, cv = st.prefill_cache
        self._write_pages(pages_row, ck[:, 0], cv[:, 0])
        if self.prefix_cache is not None:
            # full page blocks not yet cached adopt this request's pages
            self.prefix_cache.insert(req.prompt, st.pages, clock())
        st.prefilling = False
        st.prefill_cache = None
        st.pos = plen
        st.generated.append(t1)
        tnow = clock()
        st.stats.first_token_t = tnow
        ttft = st.stats.ttft_s
        self.registry.observe("serve.ttft_s", ttft)
        self.registry.observe("serve.ttft_s_class", ttft,
                              slo_class=req.slo.name)
        if st.stats.queue_wait_s is not None:
            self.registry.observe("serve.queue_wait_s",
                                  st.stats.queue_wait_s)
        self.registry.inc("serve.tokens_out")
        if self.tracer is not None:
            self.tracer.on_first_token(req, slot_idx, tnow,
                                       chunk=st.chunks_done)
        if self.health is not None:
            self.health.observe_ttft(ttft, step=self.steps_done, t=tnow)
        if self._sampled(req.rid):
            self._log_serve(event="admit", req=req.rid,
                            slot=slot_idx, prompt_len=plen,
                            chunks=st.stats.prefill_chunks, ttft_s=ttft,
                            queue_wait_s=st.stats.queue_wait_s, now=tnow,
                            slo_class=req.slo.name, tenant=req.tenant,
                            shared_tokens=st.shared_tokens,
                            queue_depth=self.scheduler.queue_depth,
                            page_util=self.pool.utilization,
                            **self._weight_fields())
        self._maybe_finish(slot_idx, st, t1, tnow, finished)

    # ----------------------------------------------------------- finish
    def _maybe_finish(self, slot_idx: int, st, tok: int, tnow: float,
                      finished):
        req = st.request
        if req.eos_token_id is not None and tok == req.eos_token_id:
            reason = "eos"
        elif len(st.generated) >= req.max_new_tokens:
            reason = "length"
        else:
            return
        st.stats.done_t = tnow
        res = RequestResult(rid=req.rid, tokens=list(st.generated),
                            finished_reason=reason, stats=st.stats)
        self.scheduler.release(slot_idx)
        self.registry.inc("serve.requests_done")
        self.registry.inc("serve.requests_done_class",
                          slo_class=req.slo.name)
        if st.stats.e2e_s is not None:
            self.registry.observe("serve.e2e_s", st.stats.e2e_s)
            self.registry.observe("serve.e2e_s_class", st.stats.e2e_s,
                                  slo_class=req.slo.name)
        if self.tracer is not None:
            self.tracer.on_finish(req, slot_idx, reason, tnow,
                                  tokens=len(res.tokens),
                                  e2e_s=st.stats.e2e_s)
        self._fold_stats(req, st.stats)
        cost = {}
        if self.ledger is not None:
            cost = self.ledger.finish(
                req.rid, tnow, prompt_len=req.prompt_len,
                shared_tokens=st.stats.shared_prefix_tokens,
                tokens_out=len(res.tokens))
        if self._sampled(req.rid):
            self._log_serve(
                event="done", req=req.rid, slot=slot_idx,
                reason=reason, tokens=len(res.tokens),
                ttft_s=st.stats.ttft_s, e2e_s=st.stats.e2e_s,
                tokens_per_s=res.tokens_per_s, now=tnow,
                slo_class=req.slo.name, tenant=req.tenant,
                slo_ttft_s=req.slo.ttft_s,
                slo_token_gap_s=req.slo.token_gap_s,
                spec_proposed=st.stats.spec_proposed,
                spec_accepted=st.stats.spec_accepted,
                shared_prefix_tokens=st.stats.shared_prefix_tokens,
                prompt_len=req.prompt_len,
                preemptions=st.stats.preemptions,
                queue_depth=self.scheduler.queue_depth,
                slot_occupancy=self.scheduler.occupancy,
                page_util=self.pool.utilization,
                **({"retries": st.stats.retries}
                   if st.stats.retries else {}),
                **cost, **self._weight_fields())
        finished.append(res)

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *, start: float = 0.0,
            on_step=None) -> List[RequestResult]:
        """Drive the engine over a request trace to completion under a
        virtual clock: arrivals come from each request's `arrival_t`,
        and time advances by the real wall cost of each engine step —
        deterministic token output, realistic latency accounting.

        ``on_step(step_index)`` (optional) runs at each step boundary
        inside the timed window, so the wall time it spends (a chaos
        decode stall) inflates the virtual clock like a slow step; it is
        where the chaos hooks (`chaos.inject.maybe_chaos_serving`,
        `maybe_slow_step`) fire.  With a run log the run ends in a
        ``report`` serve event."""
        pending = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        now = start
        results: List[RequestResult] = []
        i = 0
        step_idx = 0
        while True:
            while i < len(pending) and pending[i].arrival_t <= now + 1e-12:
                self.submit(pending[i])
                i += 1
            if not self.scheduler.active_slots() and not self.scheduler.queue:
                if i >= len(pending):
                    break
                now = max(now, pending[i].arrival_t)   # idle-skip to next
                continue
            t0 = time.perf_counter()
            if on_step is not None:
                # between-step fault events get a current timestamp
                self._last_clock = max(self._last_clock, now)
                on_step(step_idx)
            results.extend(self.step(now))
            now += time.perf_counter() - t0
            step_idx += 1
        if self.run_log is not None:
            n_tokens = sum(len(r.tokens) for r in results)
            elapsed = max(now - start, 1e-9)
            self._log_serve(event="report",
                            requests=len(results), tokens=n_tokens,
                            elapsed_s=elapsed, now=now,
                            tokens_per_s=n_tokens / elapsed)
        return sorted(results, key=lambda r: r.rid)

    def close(self):
        """Close the run log the engine opened itself (from
        HETU_TORCH_RUNLOG); a log passed in stays open."""
        if self._owns_runlog and self.run_log is not None:
            self.run_log.close()
