"""SLO-class analytics over a serving RunLog: THE one reader.

Everything downstream of a serving run's RunLog — `tools_serving_report.py`
(the dedicated CLI), `tools_obs_report.py`'s serving section, and the
chaos harness's serving recovery report — parses ``serve`` events and
``span`` records through this module, so there is exactly one place that
knows the record schemas (no second RunLog parser, the PR 10
one-tokenizer discipline applied to serving telemetry).

The report answers the questions aggregate histograms cannot:

* **per-class percentiles** — TTFT / e2e / queue wait / mean token gap
  split by `SLOClass` (serving/request.py),
* **SLO attainment** — the fraction of each class's finished requests
  that met their TTFT and token-gap targets (a dimension without a
  target is vacuously attained; the default class attains 1.0),
* **goodput** — tokens/s counted only from requests that finished
  within their class SLO (the Hetis-style metric: violating traffic
  produces load, not goodput),
* **stall attribution** — how queue time divides across the
  scheduler's reserve-on-admit reasons (``no_slot`` / ``no_pages`` /
  ``preempted`` / ``quota_exceeded``, read from the queued spans),
* **per-tenant accounting** — the class table re-grouped by
  ``Request.tenant`` (attainment/goodput per tenant) plus the cost
  ledger's per-tenant ``cost_*`` sums (serving/costs.py) when the run
  priced requests,
* **reconciliation** — per request, queued + prefill + decode + pause
  span durations vs the recorded ``e2e_s`` (the acceptance property:
  within one engine-step quantum; exact by the tracer's tiling
  construction),
* **critical path** — the stitched fleet traces (`FleetTrace.stitch`)
  decomposed into exclusive latency segments (obs/critpath.py) and
  rolled up per SLO class and tenant: where TTFT and e2e actually
  went, summing to the recorded latencies with zero residual
  (docs/observability.md, Distributed tracing),
* **fault accounting** — the failover / deadline / brownout sections
  (docs/fault_tolerance.md): replica deaths and per-class retry counts
  (HETU_TORCH_SERVE_RETRY), deadline expiries and the tokens they
  discarded (HETU_TORCH_SERVE_DEADLINE), and brownout sheds per class
  (HETU_TORCH_SERVE_BROWNOUT),
* **disaggregated serving** — the ``disagg`` section
  (serving/disagg.py): KV shipments/resends on the prefill->decode
  wire, re-prefills per class and degraded-mode (colocated-fallback)
  seconds; and the ``frontend`` section: replica down/drain/rejoin
  transitions plus hedged re-dispatches and hedge wins
  (HETU_TORCH_SERVE_HEDGE).

Span-derived fields degrade gracefully: with ``HETU_TORCH_SERVE_TRACE``
unset there are no span records, and the report still renders the
per-class percentile/attainment tables from the ``done`` events alone
(token-gap attainment then uses e2e-derived mean gaps).

Sampled RunLogs (``HETU_TORCH_RUNLOG_SERVE_SAMPLE`` > 1) stay unbiased:
each sampled done event carries ``sample_weight=N`` and every count/
token-sum/attainment fraction here re-weights by it — only the latency
percentiles stay unweighted (rid sampling is uniform, so the sampled
rows are already a uniform draw of the population).

Pure host-side record munging — no jax, no device contact.

Copied from `hetu_tpu/serving/slo_report.py` (host-only code; the port
keeps its own copy so it never imports the JAX package). It reads the
port's run logs and traces, whose records are the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

from hetu_tpu_torch.obs.metrics import percentile_of_sorted
from hetu_tpu_torch.obs.spans import FleetTrace, RequestTrace, collect_traces
from hetu_tpu_torch.serving.costs import COST_FIELDS, aggregate_costs

#: bump when the report dict shape changes incompatibly (pinned by the
#: CLI smoke tests)
REPORT_SCHEMA = 1


# ---------------------------------------------------------------------------
# the one reader
# ---------------------------------------------------------------------------

def collect(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Group a RunLog's serving records: ``serve`` events by kind plus
    the per-request span traces.  Every serving-report consumer starts
    here."""
    records = list(records)
    serves = [r for r in records if r.get("kind") == "serve"]
    return {
        "admits": [r for r in serves if r.get("event") == "admit"],
        "dones": [r for r in serves if r.get("event") == "done"],
        "reshards": [r for r in serves if r.get("event") == "reshard"],
        "reports": [r for r in serves if r.get("event") == "report"],
        "preempts": [r for r in serves if r.get("event") == "preempt"],
        # the fault-tolerance layer's events (docs/fault_tolerance.md):
        # engine failovers, per-request replica-loss requeues, and the
        # three fault terminations (retry_exhausted rides `evict`,
        # deadline_exceeded rides `expired`, brownout_shed rides `shed`)
        "failovers": [r for r in serves if r.get("event") == "failover"],
        "retries": [r for r in serves if r.get("event") == "retry"],
        "faults": [r for r in serves
                   if r.get("event") in ("evict", "expired", "shed")],
        # the disaggregated-serving layer (serving/disagg.py): KV
        # shipments on the prefill->decode wire and the degraded-mode
        # (colocated-fallback) enter/exit transitions
        "ships": [r for r in serves if r.get("event") == "ship"],
        "degraded": [r for r in serves if r.get("event") == "degraded"],
        # the multi-replica frontend (serving/frontend.py): replica
        # state changes and hedged re-dispatches
        "replicas": [r for r in serves if r.get("event") == "replica"],
        "hedges": [r for r in serves
                   if r.get("event") in ("hedge", "hedge_win")],
        "traces": collect_traces(records),
        # the stitched fleet DAG (obs/spans.py): EVERY (rid, trace) hop
        # — hedge losers and prefill-tier incarnations included — plus
        # the causal edges.  Raises ValueError on mixed clock bases:
        # a driver-clock and a wall-clock log cannot share a timeline.
        "stitched": FleetTrace.stitch(records),
        "anomalies": [r for r in records if r.get("kind") == "anomaly"],
    }


def request_rows(collected: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per finished request: the ``done`` event's SLO timeline
    joined with its span trace (when one was recorded).  ``*_ok``
    fields judge the class targets; ``residual_s`` is the
    span-vs-e2e reconciliation gap (None without spans)."""
    traces: Dict[int, RequestTrace] = collected["traces"]
    admits = {a.get("req"): a for a in collected["admits"]}
    rows = []
    for d in collected["dones"]:
        rid = d.get("req")
        ttft = d.get("ttft_s")
        e2e = d.get("e2e_s")
        tokens = d.get("tokens") or 0
        ttft_target = d.get("slo_ttft_s")
        gap_target = d.get("slo_token_gap_s")
        tr = traces.get(rid)
        row: Dict[str, Any] = {
            "rid": rid,
            "slo_class": str(d.get("slo_class", "default")),
            "tenant": str(d.get("tenant") or "default"),
            "ttft_s": ttft, "e2e_s": e2e, "tokens": tokens,
            "reason": d.get("reason"),
            "ttft_target_s": ttft_target, "token_gap_target_s": gap_target,
        }
        if d.get("sample_weight") is not None:
            # a sampled RunLog (HETU_TORCH_RUNLOG_SERVE_SAMPLE): this row
            # stands for N requests — every count/sum below re-weights
            row["sample_weight"] = d["sample_weight"]
        for k in COST_FIELDS:
            # per-request cost ledger fields (serving/costs.py) ride the
            # done event when the engine ran with a CostModel
            if d.get(k) is not None:
                row[k] = d[k]
        if tr is not None and tr.terminal is not None:
            row["queued_s"] = tr.duration_s("queued")
            row["prefill_s"] = tr.duration_s("prefill")
            row["decode_s"] = tr.duration_s("decode")
            row["pause_s"] = tr.duration_s("reshard_pause")
            row["stall_reason"] = tr.stall_reason
            row["segments"] = len(tr.by_kind("decode"))
            row["residual_s"] = tr.reconcile(e2e)
            # mean USER-VISIBLE gap: pauses count (a reshard freeze is
            # latency the user sits through), so the traced number
            # equals the spanless fallback's (e2e-ttft)/(n-1) and
            # attainment cannot change with the tracing flag
            row["token_gap_s"] = ((row["decode_s"] + row["pause_s"])
                                  / (tokens - 1) if tokens > 1 else None)
        else:
            admit = admits.get(rid, {})
            row["queued_s"] = admit.get("queue_wait_s")
            row["stall_reason"] = None
            row["residual_s"] = None
            row["token_gap_s"] = ((e2e - ttft) / (tokens - 1)
                                  if (e2e is not None and ttft is not None
                                      and tokens > 1) else None)
        row["ttft_ok"] = (ttft_target is None or
                          (ttft is not None and ttft <= ttft_target))
        # no measurable gap (single-token request, or a spanless log
        # missing the timeline) is vacuous attainment, not a miss —
        # there is no inter-token gap to violate
        row["gap_ok"] = (gap_target is None
                         or row["token_gap_s"] is None
                         or row["token_gap_s"] <= gap_target)
        row["slo_ok"] = row["ttft_ok"] and row["gap_ok"]
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def _pcts(vals: List[float]) -> Optional[Dict[str, float]]:
    vals = sorted(v for v in vals if v is not None)
    if not vals:
        return None
    return {"p50": percentile_of_sorted(vals, 50),
            "p95": percentile_of_sorted(vals, 95),
            "max": vals[-1]}


def _elapsed_s(collected: Dict[str, Any],
               rows: List[Dict[str, Any]]) -> Optional[float]:
    """The run's driver-clock span: the final ``report`` event when the
    run wrote one, else [earliest arrival, latest done] from the done
    events' ``now`` stamps."""
    if collected["reports"]:
        v = collected["reports"][-1].get("elapsed_s")
        if v:
            return float(v)
    ends = [d.get("now") for d in collected["dones"]
            if d.get("now") is not None]
    starts = [d["now"] - d["e2e_s"] for d in collected["dones"]
              if d.get("now") is not None and d.get("e2e_s") is not None]
    if not ends or not starts:
        return None
    return max(1e-9, max(ends) - min(starts))


def _weight(r: Dict[str, Any]) -> float:
    """How many requests this row stands for (sample_weight on sampled
    RunLogs, 1 otherwise)."""
    return float(r.get("sample_weight") or 1.0)


def _int_if_whole(v: float):
    """Weighted counts render as ints when they are whole (every
    unsampled log), so pre-sampling report consumers see no shape
    change."""
    return int(v) if float(v).is_integer() else v


def _group_section(rs: List[Dict[str, Any]], elapsed_s: Optional[float],
                   *, targets: bool) -> Dict[str, Any]:
    """One aggregate table section over a row group (a class or a
    tenant): weighted counts/attainment/goodput, unweighted latency
    percentiles (rid-sampling is uniform, so the sampled rows ARE a
    uniform draw — re-weighting would not change the order
    statistics)."""
    n_w = sum(_weight(r) for r in rs)
    tokens = sum(r["tokens"] * _weight(r) for r in rs)
    good_tokens = sum(r["tokens"] * _weight(r) for r in rs if r["slo_ok"])
    sec: Dict[str, Any] = {
        "requests": _int_if_whole(n_w),
        "tokens_out": _int_if_whole(tokens),
        "ttft_s": _pcts([r["ttft_s"] for r in rs]),
        "e2e_s": _pcts([r["e2e_s"] for r in rs]),
        "queue_wait_s": _pcts([r.get("queued_s") for r in rs]),
        "token_gap_s": _pcts([r.get("token_gap_s") for r in rs]),
        "attainment": {
            "ttft": sum(_weight(r) for r in rs if r["ttft_ok"]) / n_w,
            "token_gap": sum(_weight(r) for r in rs if r["gap_ok"]) / n_w,
            "slo": sum(_weight(r) for r in rs if r["slo_ok"]) / n_w,
        },
        "goodput_tokens": _int_if_whole(good_tokens),
    }
    if targets:
        sec["targets"] = {"ttft_s": rs[0]["ttft_target_s"],
                          "token_gap_s": rs[0]["token_gap_target_s"]}
    if elapsed_s:
        sec["goodput_tokens_per_s"] = good_tokens / elapsed_s
        sec["tokens_per_s"] = tokens / elapsed_s
    return sec


def class_report(rows: List[Dict[str, Any]],
                 elapsed_s: Optional[float]) -> Dict[str, Dict[str, Any]]:
    """Per-class table: counts, latency percentiles, attainment
    fractions, goodput."""
    by_cls: Dict[str, List[Dict[str, Any]]] = {}
    for row in rows:
        by_cls.setdefault(row["slo_class"], []).append(row)
    return {cls: _group_section(by_cls[cls], elapsed_s, targets=True)
            for cls in sorted(by_cls)}


def tenant_report(rows: List[Dict[str, Any]],
                  elapsed_s: Optional[float]
                  ) -> Optional[Dict[str, Dict[str, Any]]]:
    """Per-tenant table (same shape as the class table, minus targets —
    a tenant may mix classes).  None when every request is the default
    tenant: tenant-free logs keep their report shape."""
    if all(r["tenant"] == "default" for r in rows):
        return None
    by_t: Dict[str, List[Dict[str, Any]]] = {}
    for row in rows:
        by_t.setdefault(row["tenant"], []).append(row)
    return {t: _group_section(by_t[t], elapsed_s, targets=False)
            for t in sorted(by_t)}


def spec_decode_report(collected: Dict[str, Any]
                       ) -> Optional[Dict[str, Any]]:
    """Speculative-decoding acceptance over a run (from the ``done``
    events' spec counters): drafts proposed/accepted, the measured
    per-draft acceptance rate, and the mean tokens emitted per verify
    step it implies — the number the analytic roofline in
    bench.py detail.serving prices.  None when the run never drafted."""
    dones = [d for d in collected["dones"] if d.get("spec_proposed")]
    if not dones:
        return None
    proposed = sum(int(d.get("spec_proposed") or 0) for d in dones)
    accepted = sum(int(d.get("spec_accepted") or 0) for d in dones)
    return {
        "requests": len(dones),
        "drafts_proposed": proposed,
        "drafts_accepted": accepted,
        "acceptance_rate": accepted / proposed if proposed else 0.0,
    }


def prefix_cache_report(collected: Dict[str, Any]
                        ) -> Optional[Dict[str, Any]]:
    """Radix-cache effectiveness (from the ``admit`` events):
    admissions that hit, prompt tokens admitted already-resident, and
    the prefill-token fraction the cache eliminated.  None when no
    admit event carries the field (pre-cache logs degrade
    gracefully)."""
    admits = [a for a in collected["admits"]
              if a.get("shared_tokens") is not None]
    if not admits:
        return None
    shared = sum(int(a.get("shared_tokens") or 0) for a in admits)
    prompt = sum(int(a.get("prompt_len") or 0) for a in admits)
    hits = sum(1 for a in admits if (a.get("shared_tokens") or 0) > 0)
    return {
        "admits": len(admits),
        "hits": hits,
        "hit_rate": hits / len(admits),
        "shared_tokens": shared,
        "prompt_tokens": prompt,
        "prefill_tokens_saved_frac": shared / prompt if prompt else 0.0,
    }


def preemption_report(collected: Dict[str, Any]
                      ) -> Optional[Dict[str, Any]]:
    """Who preempted whom (from the ``preempt`` events): counts per
    victim class and per preemptor class."""
    pre = collected["preempts"]
    if not pre:
        return None
    victims: Dict[str, int] = {}
    by: Dict[str, int] = {}
    for p in pre:
        victims[str(p.get("slo_class", "default"))] = \
            victims.get(str(p.get("slo_class", "default")), 0) + 1
        by[str(p.get("by_class", "default"))] = \
            by.get(str(p.get("by_class", "default")), 0) + 1
    return {"preemptions": len(pre), "victim_classes": victims,
            "preemptor_classes": by}


def failover_report(collected: Dict[str, Any]
                    ) -> Optional[Dict[str, Any]]:
    """Replica-death recovery accounting (from the ``failover`` and
    ``retry`` events plus the ``done`` events' folded retry counts):
    engine failovers, requests requeued under HETU_TORCH_SERVE_RETRY,
    budget exhaustions, and which classes paid the retries.  None when
    the run never failed over."""
    fo = collected["failovers"]
    retries = collected["retries"]
    if not fo and not retries:
        return None
    by_cls: Dict[str, float] = {}
    for r in retries:
        k = str(r.get("slo_class", "default"))
        by_cls[k] = by_cls.get(k, 0) + _weight(r)
    finished_retried = sum(
        _weight(d) for d in collected["dones"] if d.get("retries"))
    exhausted = [f for f in collected["faults"]
                 if f.get("reason") == "retry_exhausted"]
    return {
        "failovers": len(fo),
        "requeued": sum(int(f.get("requeued") or 0) for f in fo),
        "retry_exhausted": _int_if_whole(
            sum(_weight(f) for f in exhausted)),
        "retried_by_class": {k: _int_if_whole(v)
                             for k, v in sorted(by_cls.items())},
        "finished_after_retry": _int_if_whole(finished_retried),
    }


def deadline_report(collected: Dict[str, Any]
                    ) -> Optional[Dict[str, Any]]:
    """Deadline enforcement (HETU_TORCH_SERVE_DEADLINE, from the
    ``expired`` events): requests expired per class and the decode
    tokens discarded with them.  None when nothing expired."""
    exp = [f for f in collected["faults"] if f.get("event") == "expired"]
    if not exp:
        return None
    by_cls: Dict[str, float] = {}
    for f in exp:
        k = str(f.get("slo_class", "default"))
        by_cls[k] = by_cls.get(k, 0) + _weight(f)
    return {
        "expired": _int_if_whole(sum(_weight(f) for f in exp)),
        "by_class": {k: _int_if_whole(v)
                     for k, v in sorted(by_cls.items())},
        "tokens_discarded": _int_if_whole(
            sum((f.get("tokens") or 0) * _weight(f) for f in exp)),
    }


def brownout_report(collected: Dict[str, Any]
                    ) -> Optional[Dict[str, Any]]:
    """Brownout shedding (HETU_TORCH_SERVE_BROWNOUT, from the ``shed``
    events): queued requests shed per class — always the
    lowest-priority band present at each firing.  None when the policy
    never fired."""
    shed = [f for f in collected["faults"] if f.get("event") == "shed"]
    if not shed:
        return None
    by_cls: Dict[str, float] = {}
    for f in shed:
        k = str(f.get("slo_class", "default"))
        by_cls[k] = by_cls.get(k, 0) + _weight(f)
    return {
        "shed": _int_if_whole(sum(_weight(f) for f in shed)),
        "by_class": {k: _int_if_whole(v)
                     for k, v in sorted(by_cls.items())},
    }


def disagg_report(collected: Dict[str, Any]
                  ) -> Optional[Dict[str, Any]]:
    """Disaggregated prefill/decode accounting (serving/disagg.py, from
    the ``ship``/``degraded``/``retry`` events): KV shipments over the
    acked wire with their resend tally, re-prefills billed to the retry
    budget (``retry`` events carrying ``ship=True``) per class, and the
    degraded-mode (colocated-fallback) entries with their metered
    seconds.  None when the run never shipped or degraded — colocated
    logs keep their report shape."""
    ships = collected["ships"]
    degraded = collected["degraded"]
    if not ships and not degraded:
        return None
    reprefills = [r for r in collected["retries"] if r.get("ship")]
    by_cls: Dict[str, float] = {}
    for r in reprefills:
        k = str(r.get("slo_class", "default"))
        by_cls[k] = by_cls.get(k, 0) + _weight(r)
    entries = sum(1 for d in degraded if d.get("state") == "enter")
    degraded_s = sum(float(d.get("degraded_s") or 0.0)
                     for d in degraded if d.get("state") == "exit")
    return {
        "shipments": len(ships),
        "resends": sum(1 for s in ships if s.get("resend")),
        "reprefills": _int_if_whole(
            sum(_weight(r) for r in reprefills)),
        "reprefills_by_class": {k: _int_if_whole(v)
                                for k, v in sorted(by_cls.items())},
        "degraded_entries": entries,
        "degraded_s": degraded_s,
    }


def frontend_report(collected: Dict[str, Any]
                    ) -> Optional[Dict[str, Any]]:
    """Multi-replica frontend accounting (serving/frontend.py, from the
    ``replica``/``hedge``/``hedge_win`` events): replica health
    transitions (down / drain / rejoin) and hedged re-dispatches with
    how many the hedge copy actually won.  None when the log carries no
    frontend events — single-replica logs keep their report shape."""
    replicas = collected["replicas"]
    hedges = collected["hedges"]
    if not replicas and not hedges:
        return None
    states: Dict[str, int] = {}
    for r in replicas:
        k = str(r.get("state", "unknown"))
        states[k] = states.get(k, 0) + 1
    hedged = [h for h in hedges if h.get("event") == "hedge"]
    wins = [h for h in hedges if h.get("event") == "hedge_win"]
    return {
        "replica_events": dict(sorted(states.items())),
        "replicas_down": states.get("down", 0),
        "hedges": len(hedged),
        "hedge_wins": len(wins),
        "hedge_waited_steps": _pcts(
            [h.get("waited_steps") for h in hedged]),
    }


def stall_breakdown(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """How queued time attributes across the scheduler's stall reasons
    (span-traced runs only): request counts and total queued seconds per
    reason."""
    traced = [r for r in rows if r.get("stall_reason") is not None]
    if not traced:
        return None
    counts: Dict[str, float] = {}
    waited: Dict[str, float] = {}
    for r in traced:
        reason = r["stall_reason"]
        w = _weight(r)
        counts[reason] = counts.get(reason, 0) + w
        waited[reason] = (waited.get(reason, 0.0)
                          + (r.get("queued_s") or 0.0) * w)
    return {"requests": {k: _int_if_whole(v) for k, v in counts.items()},
            "queued_s": {k: round(v, 6) for k, v in waited.items()}}


def critpath_report(collected: Dict[str, Any],
                    rows: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Critical-path rollup (obs/critpath.py) over the stitched fleet
    traces: where each class's and tenant's latency went, decomposed
    into the exclusive frontend_queue / prefill / shipment_wait /
    decode_queue / decode / reshard_pause / replay segments that sum to
    e2e with zero residual.  None when the log has no stitchable spans
    (HETU_TORCH_SERVE_TRACE unset degrades gracefully)."""
    from hetu_tpu_torch.obs.critpath import critical_path, rollup
    fts = collected.get("stitched") or {}
    if not fts:
        return None
    tenants = {r["rid"]: r["tenant"] for r in rows}
    paths: List[Dict[str, Any]] = []
    for rid in sorted(fts):
        cp = critical_path(fts[rid])
        if cp is not None:
            paths.append(dict(cp, tenant=tenants.get(rid, "default")))
    if not paths:
        return None
    by_cls: Dict[str, List[Dict[str, Any]]] = {}
    by_tenant: Dict[str, List[Dict[str, Any]]] = {}
    for cp in paths:
        by_cls.setdefault(cp["slo_class"], []).append(cp)
        by_tenant.setdefault(cp["tenant"], []).append(cp)
    out: Dict[str, Any] = {
        "overall": rollup(paths),
        "by_class": {k: rollup(v) for k, v in sorted(by_cls.items())},
    }
    if any(t != "default" for t in by_tenant):
        out["by_tenant"] = {k: rollup(v)
                            for k, v in sorted(by_tenant.items())}
    return out


#: bump when the request_tree dict shape changes incompatibly (pinned
#: by the tools_serving_report --request --json smoke test)
REQUEST_TREE_SCHEMA = 1


def request_tree(collected: Dict[str, Any], rid: int
                 ) -> Optional[Dict[str, Any]]:
    """One rid's stitched hop tree (`tools_serving_report.py --request`):
    every fleet hop with its span timeline, the causal edges labelled by
    hop identity, the span-seconds/lifetime work ledger, and the
    critical-path decomposition (None while the request is still in
    flight).  None when the rid never recorded a span."""
    from hetu_tpu_torch.obs.critpath import critical_path
    fts = collected.get("stitched") or {}
    ft = fts.get(rid)
    if ft is None:
        return None
    prim = ft.primary
    label = {h.trace: ft.hop_label(h) for h in ft.hops}
    hops = []
    for h in ft.hops:
        hops.append({
            "hop": ft.hop_label(h),
            "trace": h.trace,
            "tier": h.tier,
            "replica": h.replica,
            "primary": prim is not None and h.trace == prim.trace,
            "t0": h.spans[0].t0,
            "t1": h.spans[-1].t1,
            "lifetime_s": h.lifetime_s,
            "attempts": len(h.attempts()),
            "terminal": h.terminal.kind if h.terminal is not None
            else None,
            "spans": [{"kind": s.kind, "t0": s.t0, "t1": s.t1,
                       "attempt": s.attempt,
                       **({"reason": s.attrs["reason"]}
                          if s.attrs.get("reason") is not None else {})}
                      for s in h.spans],
        })
    edges = [dict(e, src=label.get(e.get("src"), e.get("src")),
                  dst=label.get(e.get("dst"), e.get("dst")))
             for e in ft.edges]
    return {
        "request_tree_schema": REQUEST_TREE_SCHEMA,
        "rid": ft.rid,
        "slo_class": ft.slo_class,
        "clock": ft.clock,
        "hops": hops,
        "edges": edges,
        "span_seconds": ft.span_seconds,
        "lifetime_seconds": ft.lifetime_seconds,
        "e2e_s": ft.e2e_s,
        "critical_path": critical_path(ft),
    }


def render_request_tree(tree: Dict[str, Any]) -> str:
    """The hop tree as text: hops indented with their span timelines
    (the primary hop starred), the causal edges, and the critical path
    with its dominant segment highlighted."""
    ln = [f"request {tree['rid']} ({tree['slo_class']}, "
          f"{tree['clock']} clock): {len(tree['hops'])} hop(s), "
          f"fleet work {tree['span_seconds']:.4g} span-s"
          + (f", e2e {tree['e2e_s']:.4g}s"
             if tree.get("e2e_s") is not None else " (in flight)")]
    for h in tree["hops"]:
        star = "*" if h["primary"] else " "
        ln.append(f" {star} {h['hop']:<12} "
                  f"[{h['t0']:.4f} -> {h['t1']:.4f}] "
                  f"{h['lifetime_s']:.4g}s, "
                  f"{h['attempts']} attempt(s) -> "
                  f"{h['terminal'] or 'OPEN'}")
        for s in h["spans"]:
            att = f" attempt={s['attempt']}" if s["attempt"] > 1 else ""
            why = f" ({s['reason']})" if s.get("reason") else ""
            ln.append(f"      {s['kind']:<16} "
                      f"{s['t0']:.4f} -> {s['t1']:.4f} "
                      f"({s['t1'] - s['t0']:.4g}s){att}{why}")
    if tree["edges"]:
        ln.append("  edges:")
        for e in tree["edges"]:
            ln.append(f"      {e['src']} --{e['kind']}--> {e['dst']} "
                      f"@{e['t']:.4f}")
    cp = tree.get("critical_path")
    if cp is not None:
        top = max(cp["segments"], key=lambda s: cp["segments"][s])
        ln.append(f"  critical path (e2e {cp['e2e_s']:.4g}s"
                  + (f", ttft {cp['ttft_s']:.4g}s"
                     if cp.get("ttft_s") is not None else "")
                  + f", residual {cp['residual_s']:.3g}s):")
        for piece in cp["path"]:
            mark = " <-- dominant" if piece["segment"] == top else ""
            ln.append(f"      {piece['segment']:<16} "
                      f"{piece['t0']:.4f} -> {piece['t1']:.4f} "
                      f"({piece['t1'] - piece['t0']:.4g}s){mark}")
    return "\n".join(ln)


def reconciliation(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The acceptance property's summary: span tiling vs recorded e2e
    across every traced request."""
    residuals = [r["residual_s"] for r in rows
                 if r.get("residual_s") is not None]
    if not residuals:
        return None
    return {"requests": len(residuals),
            "max_residual_s": max(residuals),
            "mean_residual_s": sum(residuals) / len(residuals)}


def serving_report(records: Iterable[Dict[str, Any]], *,
                   per_request: bool = False,
                   collected: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """The full SLO-class report over a RunLog's records.  Pass a
    pre-built ``collected`` (from :func:`collect`) to skip re-scanning
    the records — callers that already grouped them (tools_obs_report)
    must not pay the span-grouping walk twice."""
    if collected is None:
        collected = collect(records)
    rows = request_rows(collected)
    elapsed = _elapsed_s(collected, rows)
    n_w = sum(_weight(r) for r in rows)
    tokens = sum(r["tokens"] * _weight(r) for r in rows)
    good = sum(r["tokens"] * _weight(r) for r in rows if r["slo_ok"])
    out: Dict[str, Any] = {
        "report_schema": REPORT_SCHEMA,
        "requests": _int_if_whole(n_w),
        "tokens_out": _int_if_whole(tokens),
        "elapsed_s": elapsed,
        "classes": class_report(rows, elapsed),
        "slo_attainment": (sum(_weight(r) for r in rows if r["slo_ok"])
                           / n_w if rows else None),
        "goodput_tokens": _int_if_whole(good),
        "spans_recorded": sum(len(t.spans)
                              for t in collected["traces"].values()),
        "reshards": len(collected["reshards"]),
    }
    if elapsed:
        out["tokens_per_s"] = tokens / elapsed
        out["goodput_tokens_per_s"] = good / elapsed
    tenants = tenant_report(rows, elapsed)
    if tenants is not None:
        out["tenants"] = tenants
    costs = aggregate_costs(rows)
    if costs is not None:
        out["costs"] = costs
    stalls = stall_breakdown(rows)
    if stalls is not None:
        out["stall_breakdown"] = stalls
    rec = reconciliation(rows)
    if rec is not None:
        out["reconciliation"] = rec
    cp = critpath_report(collected, rows)
    if cp is not None:
        out["critical_path"] = cp
    spec = spec_decode_report(collected)
    if spec is not None:
        out["spec_decode"] = spec
    cache = prefix_cache_report(collected)
    if cache is not None:
        out["prefix_cache"] = cache
    pre = preemption_report(collected)
    if pre is not None:
        out["preemptions"] = pre
    fo = failover_report(collected)
    if fo is not None:
        out["failover"] = fo
    dl = deadline_report(collected)
    if dl is not None:
        out["deadline"] = dl
    bo = brownout_report(collected)
    if bo is not None:
        out["brownout"] = bo
    dg = disagg_report(collected)
    if dg is not None:
        out["disagg"] = dg
    fe = frontend_report(collected)
    if fe is not None:
        out["frontend"] = fe
    if collected["anomalies"]:
        by_kind: Dict[str, int] = {}
        for a in collected["anomalies"]:
            k = str(a.get("anomaly", "unknown"))
            by_kind[k] = by_kind.get(k, 0) + 1
        out["anomalies"] = by_kind
    if per_request:
        out["per_request"] = rows
    return out


# ---------------------------------------------------------------------------
# text rendering
# ---------------------------------------------------------------------------

def _fmt(v, scale=1.0, digits=4) -> str:
    if v is None:
        return "-"
    return f"{v * scale:.{digits}g}"


def render_text(report: Dict[str, Any]) -> str:
    """The report as a fixed-width table (tools_serving_report.py's
    default output)."""
    lines = [
        f"serving report: {report['requests']} requests, "
        f"{report['tokens_out']} tokens"
        + (f", {report['tokens_per_s']:.1f} tok/s"
           if report.get("tokens_per_s") else "")
        + (f", goodput {report['goodput_tokens_per_s']:.1f} tok/s"
           if report.get("goodput_tokens_per_s") is not None else "")]
    hdr = (f"{'class':>10} {'reqs':>5} {'ttft p50':>9} {'ttft p95':>9} "
           f"{'e2e p95':>9} {'gap p95':>9} {'attain':>7} {'goodput':>8}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for cls, sec in report.get("classes", {}).items():
        def pct(key, p):
            d = sec.get(key)
            return _fmt(d.get(p) if d else None)
        lines.append(
            f"{cls:>10} {sec['requests']:>5} "
            f"{pct('ttft_s', 'p50'):>9} {pct('ttft_s', 'p95'):>9} "
            f"{pct('e2e_s', 'p95'):>9} {pct('token_gap_s', 'p95'):>9} "
            f"{sec['attainment']['slo']:>7.0%} "
            f"{_fmt(sec.get('goodput_tokens_per_s'), digits=3):>8}")
    tenants = report.get("tenants")
    if tenants:
        thdr = (f"{'tenant':>10} {'reqs':>7} {'tokens':>8} "
                f"{'ttft p95':>9} {'e2e p95':>9} {'attain':>7} "
                f"{'goodput':>8}")
        lines.append(thdr)
        lines.append("-" * len(thdr))
        for t, sec in tenants.items():
            def tpct(key, p):
                d = sec.get(key)
                return _fmt(d.get(p) if d else None)
            lines.append(
                f"{t:>10} {_fmt(sec['requests'], digits=6):>7} "
                f"{_fmt(sec['tokens_out'], digits=6):>8} "
                f"{tpct('ttft_s', 'p95'):>9} {tpct('e2e_s', 'p95'):>9} "
                f"{sec['attainment']['slo']:>7.0%} "
                f"{_fmt(sec.get('goodput_tokens_per_s'), digits=3):>8}")
    costs = report.get("costs")
    if costs:
        for t, c in costs["by_tenant"].items():
            lines.append(
                f"cost[{t}]: prefill {_fmt(c['cost_prefill_flops'], digits=3)} "
                f"+ decode {_fmt(c['cost_decode_flops'], digits=3)} FLOPs, "
                f"{_fmt(c['cost_page_s'], digits=3)} page-s, "
                f"{_fmt(c['cost_kv_byte_s'], digits=3)} KV byte-s, "
                f"{_fmt(c['cost_wire_bytes'], digits=3)} wire B")
        tot = costs["total"]
        lines.append(
            f"cost[total]: prefill {_fmt(tot['cost_prefill_flops'], digits=3)} "
            f"+ decode {_fmt(tot['cost_decode_flops'], digits=3)} FLOPs, "
            f"{_fmt(tot['cost_page_s'], digits=3)} page-s, "
            f"{_fmt(tot['cost_kv_byte_s'], digits=3)} KV byte-s, "
            f"{_fmt(tot['cost_wire_bytes'], digits=3)} wire B")
    stalls = report.get("stall_breakdown")
    if stalls:
        parts = [f"{k}={v}" for k, v in sorted(stalls["requests"].items())]
        lines.append("stall attribution (requests): " + ", ".join(parts))
        parts = [f"{k}={v:.4g}s" for k, v in sorted(stalls["queued_s"].items())]
        lines.append("stall attribution (queued time): " + ", ".join(parts))
    rec = report.get("reconciliation")
    if rec:
        lines.append(
            f"span reconciliation: {rec['requests']} traced requests, "
            f"max |spans - e2e| = {rec['max_residual_s']:.3g}s")
    cpr = report.get("critical_path")
    if cpr:
        tot = cpr["overall"]
        parts = [f"{seg}={tot['mean_s'][seg]:.4g}s"
                 for seg in tot["mean_s"] if tot["total_s"][seg] > 0]
        lines.append(
            f"critical path ({tot['requests']} stitched, mean s/req): "
            + ", ".join(parts)
            + f"; max residual {tot['max_residual_s']:.3g}s")
        for cls, sec in cpr["by_class"].items():
            top = max(sec["mean_s"], key=lambda s: sec["mean_s"][s])
            lines.append(
                f"  {cls}: dominant segment {top} "
                f"({sec['mean_s'][top]:.4g}s mean of "
                f"{sec['requests']} requests)")
    spec = report.get("spec_decode")
    if spec:
        lines.append(
            f"spec decode: {spec['drafts_accepted']}/"
            f"{spec['drafts_proposed']} drafts accepted "
            f"(acceptance {spec['acceptance_rate']:.0%} over "
            f"{spec['requests']} requests)")
    cache = report.get("prefix_cache")
    if cache:
        lines.append(
            f"prefix cache: {cache['hits']}/{cache['admits']} admissions "
            f"hit ({cache['hit_rate']:.0%}); {cache['shared_tokens']}/"
            f"{cache['prompt_tokens']} prompt tokens resident "
            f"({cache['prefill_tokens_saved_frac']:.0%} of prefill "
            "eliminated)")
    pre = report.get("preemptions")
    if pre:
        victims = ", ".join(f"{k}={v}" for k, v in
                            sorted(pre["victim_classes"].items()))
        lines.append(f"preemptions: {pre['preemptions']} "
                     f"(victims by class: {victims})")
    fo = report.get("failover")
    if fo:
        retried = ", ".join(f"{k}={v}" for k, v in
                            fo["retried_by_class"].items())
        lines.append(
            f"failover: {fo['failovers']} replica deaths, "
            f"{fo['requeued']} requests requeued"
            + (f" ({retried})" if retried else "")
            + f", {fo['retry_exhausted']} over budget, "
            f"{fo['finished_after_retry']} finished after retry")
    dl = report.get("deadline")
    if dl:
        by = ", ".join(f"{k}={v}" for k, v in dl["by_class"].items())
        lines.append(f"deadlines: {dl['expired']} expired ({by}); "
                     f"{dl['tokens_discarded']} tokens discarded")
    bo = report.get("brownout")
    if bo:
        by = ", ".join(f"{k}={v}" for k, v in bo["by_class"].items())
        lines.append(f"brownout: {bo['shed']} queued requests shed ({by})")
    dg = report.get("disagg")
    if dg:
        by = ", ".join(f"{k}={v}" for k, v in
                       dg["reprefills_by_class"].items())
        lines.append(
            f"disagg: {dg['shipments']} KV shipments "
            f"({dg['resends']} resent), {dg['reprefills']} re-prefills"
            + (f" ({by})" if by else "")
            + f"; degraded {dg['degraded_entries']}x for "
            f"{dg['degraded_s']:.3g}s")
    fe = report.get("frontend")
    if fe:
        ev = ", ".join(f"{k}={v}" for k, v in
                       fe["replica_events"].items())
        lines.append(
            f"frontend: replica events [{ev}], {fe['hedges']} hedges, "
            f"{fe['hedge_wins']} hedge wins")
    if report.get("anomalies"):
        lines.append("anomalies: " + ", ".join(
            f"{k}={n}" for k, n in sorted(report["anomalies"].items())))
    if report.get("reshards"):
        lines.append(f"reshards: {report['reshards']}")
    return "\n".join(lines)
