"""The port's env-flag registry, a trimmed copy of
`hetu_tpu/utils/flags.py` holding the flags the port reads, under the
`HETU_TORCH_` prefix (the port keeps its own copy so it never imports
the JAX package).  Types, defaults and parse errors are the reference's.

    from hetu_tpu_torch.utils import flags
    if flags.bool_flag("HETU_TORCH_HEALTH"): ...
    every = flags.int_flag("HETU_TORCH_NUMERICS_EVERY")
    cfg = ServeConfig.from_flags()     # the HETU_TORCH_SERVE_* surface
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    kind: str            # "bool" | "str" | "int"
    default: object
    doc: str
    choices: Optional[Tuple[str, ...]] = None


REGISTRY: Dict[str, Flag] = {f.name: f for f in [
    Flag("HETU_TORCH_RUNLOG", "str", "",
         "write the structured run-event JSONL (obs.runlog.RunLog) to this "
         "path; default: <ckpt_dir>/runlog.jsonl when checkpointing, else "
         "off"),
    Flag("HETU_TORCH_RUNLOG_MAX_MB", "int", 0,
         "size-cap one RunLog segment to this many MiB; on overflow the "
         "writer appends a 'rotated' marker record, renames the file to "
         "<path>.<n> and starts a fresh segment (iter_records follows the "
         "whole chain in order).  0 (default) = no rotation"),
    Flag("HETU_TORCH_HEALTH", "bool", False,
         "run the training health monitors (obs.health) in the trainer "
         "loop: loss spikes, NaN/Inf loss or grads, grad-norm blowups, "
         "step-time regressions, data-pipeline stalls (and, with "
         "HETU_TORCH_NUMERICS, the numerics detectors) -> health.* "
         "counters + 'anomaly' RunLog events.  Costs a per-step device "
         "sync for loss/grad_norm; off (default) = zero per-step work"),
    Flag("HETU_TORCH_NUMERICS", "bool", False,
         "the numerics observatory (obs/numerics.py): per-tensor "
         "absmax/rms/l2, nonfinite counts and 16-bit underflow/overflow "
         "fractions at the reference's scopes (embed, hidden, logits, "
         "params, grads, scaler, update, adam_m) -> 'numerics' RunLog "
         "records + numerics.* registry gauges, feeding the numerics "
         "health detectors.  Unset (default) = no tap computes anything"),
    Flag("HETU_TORCH_NUMERICS_EVERY", "int", 1,
         "numerics sampling interval in steps: record the stats every "
         "N-th step"),
    # -- serving (hetu_tpu_torch/serving) ------------------------------
    Flag("HETU_TORCH_KV_QUANT", "str", "none",
         "paged-KV-cache page mode (serving/kv_pool.py): int8 stores "
         "blockwise int8 + one fp32 absmax scale per head vector, int4 "
         "two values a byte under the same scale; none (default) stores "
         "exact pages in the model's compute dtype",
         choices=("none", "int8", "int4")),
    Flag("HETU_TORCH_MOE_DISPATCH", "str", "gspmd",
         "MoE expert dispatch (nn/moe_dispatch.py) and the serving "
         "engine's resident experts (ServeConfig.from_flags): gspmd "
         "(default) and fp32 keep the experts in the model's dtype; int8 "
         "and int4 serve them resident-quantized (serving/experts.py, "
         "blockwise payloads + fp32 scales, one layer's working copy "
         "dequantized a forward).  The explicit expert-parallel "
         "transports need an ep axis: with one device every mode "
         "dispatches as gspmd",
         choices=("gspmd", "fp32", "int8", "int4")),
    Flag("HETU_TORCH_SERVE_SLOTS", "int", 8,
         "serving engine decode-slot count (the decode batch's rows)"),
    Flag("HETU_TORCH_SERVE_PAGE", "int", 16,
         "KV-cache page size in tokens (serving/kv_pool.py block size)"),
    Flag("HETU_TORCH_SERVE_MAX_LEN", "int", 256,
         "per-sequence serving cap (prompt + decode budget); must be a "
         "multiple of HETU_TORCH_SERVE_PAGE and <= the model's "
         "max_position_embeddings"),
    Flag("HETU_TORCH_SERVE_PREFILL_CHUNK", "int", 32,
         "chunked-prefill token budget per engine step (one chunk a "
         "step, interleaved with decode); SERVE_MAX_LEN must be a "
         "multiple of it"),
    Flag("HETU_TORCH_SERVE_PAGES", "int", 0,
         "usable KV pages in the pool; 0 (default) = full reservation "
         "(slots * max_len / page), i.e. admission never waits on pages"),
    Flag("HETU_TORCH_SERVE_SAMPLE", "bool", False,
         "the seeded serving sampler (serving/sampling.py): per-request "
         "temperature/top-k/top-p, a token's key a pure function of "
         "(seed, position); unset (default) builds a greedy-only engine "
         "that refuses sampling requests"),
    Flag("HETU_TORCH_SPEC_DECODE", "str", "none",
         "speculative decoding (serving/spec_decode.py): ngram drafts "
         "HETU_TORCH_SPEC_K tokens a slot a step on the host and one "
         "verify step scores all k+1; model runs a resident int8 draft "
         "model verified by the stochastic p/q rule",
         choices=("none", "ngram", "model")),
    Flag("HETU_TORCH_SPEC_K", "int", 4,
         "draft tokens per speculative decode step; also widens every "
         "page reservation by k positions.  Read only when "
         "HETU_TORCH_SPEC_DECODE is set"),
    Flag("HETU_TORCH_SERVE_PREFIX_CACHE", "bool", False,
         "radix prefix cache (serving/prefix_cache.py): finished "
         "prompts' page-aligned KV pages stay resident, shared "
         "copy-on-write; a request sharing the prefix admits with those "
         "pages resident and prefills only its suffix"),
    Flag("HETU_TORCH_SERVE_PREFIX_PAGES", "int", 0,
         "radix-cache page budget (0 = bounded only by pool pressure: "
         "the scheduler evicts LRU cache entries when an admission's "
         "reservation comes up short)"),
    Flag("HETU_TORCH_SERVE_PREEMPT", "bool", False,
         "SLO-class-aware preemptive admission: when admission stalls "
         "and the queue head's class priority strictly outranks the "
         "lowest-priority live slot, that slot is evicted and requeued "
         "('preempted' stall reason, serve 'preempt' event).  Equal "
         "priorities never preempt"),
    Flag("HETU_TORCH_SERVE_QUOTAS", "str", "",
         "per-tenant admission quotas (serving/request.py parse_quotas): "
         "comma list of tenant[:max_slots[:max_pages]] specs, e.g. "
         "'acme:2:16,free:1:4' — caps the decode slots / KV pages each "
         "tenant's live requests may hold ('quota_exceeded' stall "
         "reason).  Unset/empty (default) = quota-free"),
    Flag("HETU_TORCH_RUNLOG_SERVE_SAMPLE", "int", 1,
         "serve-event/span RunLog sampling: only a deterministic hashed "
         "1-in-N of request ids (serving/request.py rid_sampled) emit "
         "their 'serve'/'span' records, stamped sample_weight=N so "
         "serving/slo_report.py re-weights; registry counters are never "
         "sampled.  1 (default) logs every request"),
    Flag("HETU_TORCH_SERVE_TRACE", "bool", False,
         "serving flight recorder (serving/tracing.py): every request's "
         "lifecycle as schema-versioned 'span' RunLog records (queued "
         "with its stall attribution, prefill chunks, decode segments, "
         "terminal), which obs/spans.py FleetTrace.stitch and "
         "obs/critpath.py read.  Host-side bookkeeping only"),
    Flag("HETU_TORCH_SERVE_RETRY", "int", 0,
         "per-request retry budget after a serving replica death "
         "(chaos engine_kill): in-flight requests re-enter the queue "
         "('replica_lost' stall reason) up to this many times; past it "
         "they terminate as 'retry_exhausted'.  0 (default) = no "
         "retries"),
    Flag("HETU_TORCH_SERVE_DEADLINE", "bool", False,
         "enforce SLOClass deadlines (serving/request.py deadline_s): "
         "each engine step terminates queued and live requests older "
         "than their class deadline as 'deadline_exceeded'"),
    Flag("HETU_TORCH_SERVE_BROWNOUT", "bool", False,
         "sustained-pressure brownout shedding: page utilization at the "
         "high watermark with a backed-up queue for a streak of steps "
         "sheds the lowest-priority queued requests ('brownout_shed')"),
    Flag("HETU_TORCH_SERVE_SHIP_QUANT", "str", "none",
         "wire quantization for prefill->decode KV shipments "
         "(serving/disagg.py pack_shipment): int8/int4 ship per-head "
         "payloads + fp32 scales (quantize_heads); none (default) ships "
         "the exact scratch, token-identical to the colocated run",
         choices=("none", "int8", "int4")),
    Flag("HETU_TORCH_SERVE_HEDGE", "int", 0,
         "frontend hedged re-dispatch (serving/frontend.py): a request "
         "queued on its replica for more than this many router steps "
         "is re-submitted to the next-best healthy replica; the first "
         "to finish wins, deduped by rid.  0 (default) = never hedge"),
]}


def _lookup(name: str) -> Flag:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(REGISTRY)}")


_TRUE = ("1", "true", "True", "TRUE", "yes", "on")
_FALSE = ("0", "false", "False", "FALSE", "no", "off", "")


def bool_flag(name: str) -> bool:
    f = _lookup(name)
    raw = os.environ.get(name)
    if raw is None:
        return bool(f.default)
    if raw in _TRUE:
        return True
    if raw in _FALSE:
        return False
    raise ValueError(
        f"{name}={raw!r} is not a boolean; use one of {_TRUE + _FALSE}")


def str_flag(name: str) -> str:
    f = _lookup(name)
    val = os.environ.get(name, f.default)
    if f.choices and val not in f.choices:
        raise ValueError(
            f"{name}={val!r} invalid; choices: {f.choices}")
    return val


def int_flag(name: str) -> int:
    f = _lookup(name)
    raw = os.environ.get(name)
    return int(raw) if raw else int(f.default)

