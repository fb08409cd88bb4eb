"""Serving engine: continuous batching + paged KV cache, the port of
`hetu_tpu/serving/engine.py`.

Each engine step runs, in order:

  * admission — the host `Scheduler` admits every queued request a slot
    and a full page reservation allow (plus `spec_k` positions of
    lookahead under speculative decoding);
  * chunked prefill — every prefilling slot advances ONE chunk
    (`models/generation.extend_cache`) into its own dense scratch cache,
    so a long prompt adds engine steps for its own slot and never stalls
    the decode batch; on its last chunk the scratch K/V are written into
    the slot's pages (`PagePool.write_pages`, quantized in the int8/int4
    page modes) and the first token is taken from the last valid prompt
    position's logits (`first_token_from_logits`);
  * decode — one gather-free step over every slot
    (`models/generation.decode_step_paged`, the `paged_attention`
    kernel), then the next token per slot; or, with
    `spec_decode="ngram"`, one VERIFY step: the host drafter proposes
    `spec_k` tokens a slot, `verify_step_paged` (the `paged_verify`
    kernel) scores the last token and the drafts in one forward, the
    fused sampling epilogue (`sample_hidden_grid`) picks the token the
    sequential path would emit at each position, and the drafts are
    accepted while they match.  Rows that are not decoding ride along
    pinned to the null page (`_decode_table`).

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
`MetricsRegistry` (its own, unless one is passed).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from hetu_tpu_torch.models.generation import (_check_context_length,
                                              decode_step_paged,
                                              extend_cache,
                                              verify_step_paged)
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.serving.kv_pool import PagePool
from hetu_tpu_torch.serving.request import (Request, RequestResult,
                                            SamplingParams)
from hetu_tpu_torch.serving.sampling import (sample_hidden_grid,
                                             sample_tokens)
from hetu_tpu_torch.serving.scheduler import Scheduler
from hetu_tpu_torch.serving.spec_decode import accept_counts, make_drafter
from hetu_tpu_torch.utils.device import resolve_device

#: the later slices of the port (ROADMAP.md, Queue A)
_SERVING_3 = "the third serving slice (ROADMAP Queue A item 3)"
_SERVING_HOST = "the serving host-layer slice (ROADMAP Queue A item 4)"
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"

#: ServeConfig fields beyond this slice: name -> (default, later slice)
_LATER_FIELDS = {
    "moe_dispatch": ("gspmd", _MULTI_GPU),
    "prefix_cache": (False, _SERVING_3),
    "prefix_cache_pages": (0, _SERVING_3),
    "preempt": (False, _SERVING_HOST),
    "quotas": ({}, _SERVING_HOST),
    "serve_sample": (1, _SERVING_3),
    "retry_budget": (0, _SERVING_HOST),
    "deadline": (False, _SERVING_HOST),
    "brownout": (False, _SERVING_HOST),
    "brownout_page_high": (0.95, _SERVING_HOST),
    "brownout_queue_min": (1, _SERVING_HOST),
    "brownout_streak": (4, _SERVING_HOST),
    "kv_repage": (False, _MULTI_GPU),
}

#: ServingEngine keyword arguments beyond this slice
_LATER_ENGINE_ARGS = {
    "run_log": _SERVING_3, "tracer": _SERVING_3, "health": _SERVING_3,
    "telemetry": _SERVING_HOST, "cost_model": _SERVING_HOST,
    "draft_model": _SERVING_3, "draft_params": _SERVING_3,
    "reshard": _MULTI_GPU,
}


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
    tokens a step.  The reference's other options keep their names and
    defaults here; setting one to anything but its default raises
    NotImplementedError naming the slice of the port that brings it."""
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
        if self.spec_decode == "model":
            raise NotImplementedError(
                "ServeConfig.spec_decode='model' (a draft model verified "
                f"by the stochastic rule) arrives with {_SERVING_3}")
        if self.spec_decode != "none" and self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.num_pages == 0:
            self.num_pages = self.num_slots * (self.max_len
                                               // self.page_size)

    @property
    def lookahead(self) -> int:
        """Cache positions a verify step may write past the sequence
        head (0 without speculative decoding): widens every page
        reservation."""
        return self.spec_k if self.spec_decode != "none" else 0


class ServingEngine:
    """Continuous-batching facade over a `LlamaLMHeadModel`.

    `device` ("cuda" by default) must be the model's device; on a CUDA
    device the decode step runs the hand-written kernels, on the CPU
    their plain versions."""

    def __init__(self, model, config: Optional[ServeConfig] = None, *,
                 registry: Optional[MetricsRegistry] = None, drafter=None,
                 device="cuda", **later):
        for name in later:
            if name not in _LATER_ENGINE_ARGS:
                raise TypeError(f"ServingEngine got an unexpected keyword "
                                f"argument {name!r}")
            raise NotImplementedError(
                f"ServingEngine({name}=...) is not in the port yet; it "
                f"arrives with {_LATER_ENGINE_ARGS[name]}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"engine was asked for {self.device}")
        self.model = model
        self.config = config or ServeConfig()
        c = model.config
        _check_context_length(c, self.config.max_len)
        self.pool = PagePool(
            num_layers=c.num_hidden_layers,
            num_pages=self.config.num_pages,
            page_size=self.config.page_size,
            num_kv_heads=c.num_key_value_heads, head_dim=c.head_dim,
            dtype=c.compute_dtype, quant=self.config.kv_quant,
            device=self.device)
        self.scheduler = Scheduler(num_slots=self.config.num_slots,
                                   pool=self.pool,
                                   max_len=self.config.max_len,
                                   lookahead=self.config.lookahead)
        # speculative decoding: the host drafter (`drafter=` overrides
        # the config's mode; the verify step and the page lookahead are
        # sized by the config, so a drafter needs spec_decode set)
        if drafter is not None and self.config.spec_decode == "none":
            raise ValueError("a custom drafter needs spec_decode set "
                             "(e.g. ServeConfig(spec_decode='ngram')) so "
                             "the verify step and page lookahead exist")
        self.drafter = (drafter if drafter is not None
                        else make_drafter(self.config.spec_decode))
        self.spec = self.drafter is not None
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.steps_done = 0

    # ------------------------------------------------------- device work
    def _new_scratch(self):
        """A zeroed dense [L, 1, max_len, n_kv, hd] K/V pair for one
        prefilling request (the reference's zero template)."""
        c = self.model.config
        shape = (c.num_hidden_layers, 1, self.config.max_len,
                 c.num_key_value_heads, c.head_dim)
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
        pos = torch.as_tensor(positions, device=dev)
        logits = decode_step_paged(
            self.model, torch.as_tensor(tokens, device=dev), self.pool.k,
            self.pool.v, torch.as_tensor(table, device=dev), pos,
            **self._pools())[0]
        if not self.config.sampling:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        seeds, temps, top_ks, top_ps = self._sample_args(active)
        return sample_tokens(logits, seeds, positions.astype(np.int64) + 1,
                             temps, top_ks, top_ps, device=dev).cpu().numpy()

    def _verify(self, table: np.ndarray, tokens: np.ndarray,
                positions: np.ndarray, active):
        """One verify step over every slot: tokens [S, k+1] (the last
        emitted token + k drafts).  Returns (targets [S, k+1], n_emit
        [S]) on the host: the sequential path's token at each position
        and how many of them to emit (the matched draft prefix + 1)."""
        dev = self.device
        pos = torch.as_tensor(positions, device=dev)
        tok = torch.as_tensor(tokens, device=dev)
        hidden = verify_step_paged(
            self.model, tok, self.pool.k, self.pool.v,
            torch.as_tensor(table, device=dev), pos, return_hidden=True,
            **self._pools())[0]
        # the token picked at grid position i sits at positions + i + 1
        pos_grid = positions.astype(np.int64)[:, None] + np.arange(
            1, tokens.shape[1] + 1)
        seeds, temps, top_ks, top_ps = self._sample_args(active)
        targets = sample_hidden_grid(
            hidden, self.model.lm_head_weight(), seeds, pos_grid, temps,
            top_ks, top_ps, device=dev).cpu().numpy()
        return targets, accept_counts(targets, tokens[:, 1:])

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
            self._verify(table, np.zeros((S, self.config.spec_k + 1),
                                         np.int32), zeros, [])
        else:
            self._decode(table, zeros, zeros, [])
        scratch = self._new_scratch()
        logits, _ = extend_cache(self.model,
                                 torch.zeros((1, C), dtype=torch.long,
                                             device=self.device), scratch, 0)
        self.pool.write_pages(
            np.zeros(self.scheduler.max_pages, np.int32),
            scratch[0][:, 0], scratch[1][:, 0])
        if self.config.sampling:
            probe = Request(rid=-1, prompt=np.ones(1, np.int32),
                            max_new_tokens=1,
                            sampling=SamplingParams(temperature=1.0))
            first_token_from_logits(probe, logits[0, 0], 1, sampling=True)
        self._sync()
        return self

    # ----------------------------------------------------------- intake
    def submit(self, req: Request, now: Optional[float] = None):
        if req.sampling.temperature > 0 and not self.config.sampling:
            raise ValueError(
                f"request {req.rid} asks for sampling (temperature "
                f"{req.sampling.temperature}) but the engine was built "
                "greedy-only — set ServeConfig(sampling=True)")
        if now is not None:
            req.arrival_t = now
        self.scheduler.submit(req)
        self.registry.inc("serve.requests_submitted")

    # ------------------------------------------------------------- step
    def _decode_table(self, active) -> np.ndarray:
        """Page-table input for the decode batch: only decoding slots'
        rows are real; prefilling and empty rows are pinned to the null
        page.  The scheduler fills a slot's row at ADMISSION, so a slot
        still prefilling already points at live pages: its ride-along
        (token 0, position 0) write must land in the null page, not in
        row 0 of its first page."""
        table = np.zeros_like(self.scheduler.page_table)
        for i in active:
            table[i] = self.scheduler.page_table[i]
        return table

    def step(self, now: float) -> List[RequestResult]:
        """One engine iteration at time `now` on the caller's clock: admit every
        admissible queued request, advance each PREFILLING slot by
        exactly ONE chunk, then one decode step over the slots whose
        prefill is complete.  Returns requests that finished this
        step."""
        t0 = time.perf_counter()

        def clock() -> float:
            return now + (time.perf_counter() - t0)

        finished: List[RequestResult] = []
        while True:
            adm = self.scheduler.admit_next(clock())
            if adm is None:
                break
            _, st = adm
            st.prefilling = True
            st.prefill_cache = self._new_scratch()
        if self.scheduler.queue:
            reason = self.scheduler.last_stall or "none"
            self.registry.inc("serve.admission_stalls", reason=reason)

        for i in self.scheduler.active_slots():
            st = self.scheduler.slots[i]
            if st.prefilling:
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
            for i in active:
                st = self.scheduler.slots[i]
                for tok in emitted[i]:
                    st.generated.append(tok)
                    st.pos += 1
                    self.registry.inc("serve.tokens_out")
                    self._maybe_finish(i, st, tok, tnow, finished)
                    if self.scheduler.slots[i] is None:
                        break            # finished: drop surplus drafts

        self.steps_done += 1
        self.registry.set_gauge("serve.queue_depth",
                                self.scheduler.queue_depth)
        self.registry.set_gauge("serve.slot_occupancy",
                                self.scheduler.occupancy)
        self.registry.set_gauge("serve.page_util", self.pool.utilization)
        # a step without a decode ends in no host read: wait for the
        # device so the run's clock counts the prefill work
        self._sync()
        return finished

    # ------------------------------------------------------ spec decode
    def _spec_decode_step(self, active, positions):
        """One speculative step over the active slots: draft k tokens a
        slot on the host, verify all k + 1 in ONE batched forward, and
        accept by sample-then-match.  Returns {slot: emitted tokens}
        (>= 1 a slot)."""
        S, k = self.config.num_slots, self.config.spec_k
        w = self.drafter.window
        tokens = np.zeros((S, k + 1), np.int32)
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
            tokens[i, 1:] = self.drafter.propose(ctx, k)
        targets, n_emit = self._verify(self._decode_table(active), tokens,
                                       positions, active)
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

    # ---------------------------------------------------------- prefill
    def _advance_prefill(self, slot_idx: int, st, clock, finished):
        """Run ONE prefill chunk for a prefilling slot; on the last
        chunk, write the scratch K/V into the slot's pages, emit the
        first token, and join the decode batch."""
        req = st.request
        plen = req.prompt_len
        C = self.config.prefill_chunk
        padded = math.ceil(plen / C) * C
        s = st.chunks_done * C
        ids = np.zeros(C, np.int64)
        seg = req.prompt[s: min(s + C, plen)]
        ids[: len(seg)] = seg
        logits, _ = extend_cache(
            self.model, torch.as_tensor(ids[None], device=self.device),
            st.prefill_cache, s)
        st.chunks_done += 1
        st.stats.prefill_chunks += 1
        self.registry.inc("serve.prefill_chunks")
        if s + C < padded:
            return                        # more chunks: next engine step
        # the first generated token sits at the last VALID prompt
        # position of the final chunk (the padding tail is garbage)
        t1 = first_token_from_logits(req, logits[0, plen - 1 - s], plen,
                                     sampling=self.config.sampling)
        pages_row = np.full(self.scheduler.max_pages, PagePool.NULL_PAGE,
                            np.int32)
        pages_row[: len(st.pages)] = st.pages
        ck, cv = st.prefill_cache
        self.pool.write_pages(pages_row, ck[:, 0], cv[:, 0])
        st.prefilling = False
        st.prefill_cache = None
        st.pos = plen
        st.generated.append(t1)
        tnow = clock()
        st.stats.first_token_t = tnow
        self.registry.observe("serve.ttft_s", st.stats.ttft_s)
        self.registry.observe("serve.queue_wait_s", st.stats.queue_wait_s)
        self.registry.inc("serve.tokens_out")
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
        finished.append(RequestResult(rid=req.rid,
                                      tokens=list(st.generated),
                                      finished_reason=reason,
                                      stats=st.stats))
        self.scheduler.release(slot_idx)
        self.registry.inc("serve.requests_done")
        self.registry.observe("serve.e2e_s", st.stats.e2e_s)

    # -------------------------------------------------------------- run
    def run(self, requests: Sequence[Request], *,
            start: float = 0.0) -> List[RequestResult]:
        """Drive the engine over a request trace to completion under a
        virtual clock: arrivals come from each request's `arrival_t`,
        and time advances by the real wall cost of each engine step —
        deterministic token output, realistic latency accounting."""
        pending = sorted(requests, key=lambda r: (r.arrival_t, r.rid))
        now = start
        results: List[RequestResult] = []
        i = 0
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
            results.extend(self.step(now))
            now += time.perf_counter() - t0
        return sorted(results, key=lambda r: r.rid)
