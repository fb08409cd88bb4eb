"""Critical-path extraction over stitched fleet traces.

Answers the fleet-tuning question the stitched DAG exists for: *where
did this request's latency go?*  `critical_path` decomposes one
`FleetTrace`'s client-visible lifetime into EXCLUSIVE per-hop segments

    frontend_queue   routing/held time before the first tier saw it
                     (includes the prefill tier's admission queue)
    prefill          prompt processing — remote tier or colocated
    shipment_wait    waiting on the KV shipment wire (drops, delays,
                     re-prefill turnarounds included)
    decode_queue     waiting on a decode slot/pages after dispatch
    decode           token generation
    reshard_pause    frozen under a LoadAdaptiveMesh reshard
    replay           re-queued time after a preemption / replica loss /
                     prefill-tier fallback (failover re-admission)

The segments PARTITION the primary hop's span tiling — every piece of
every span lands in exactly one bucket — so their sum reconciles with
the end-to-end latency with zero residual (<= one step quantum per
attempt boundary, the same allowance the span contract itself has).
TTFT gets the same decomposition by clipping the piecewise path at the
first-token boundary.

Pure host-side arithmetic over `obs/spans.py` shapes: no jax, no
serving imports.  `serving/slo_report.py` (the one reader) rolls these
up per tenant and SLO class; `tools_serving_report.py --request` renders
one request's hop tree with the path highlighted.

Copied from `hetu_tpu/obs/critpath.py` (host-only code; the port keeps
its own copy so it never imports the JAX package).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from hetu_tpu_torch.obs.spans import (TERMINAL_KINDS, FleetTrace,
                                RequestTrace, _ev_t)

#: the exclusive latency buckets, in pipeline order
SEGMENTS = ("frontend_queue", "prefill", "shipment_wait",
            "decode_queue", "decode", "reshard_pause", "replay")

#: stall reasons whose queued span is failover re-admission time
_REPLAY_REASONS = ("preempted", "replica_lost", "prefill_tier_down",
                   "brownout_shed")


def _pf_hop_bounds(hop: RequestTrace) -> Dict[str, float]:
    """(queue_end, work_end) of one prefill-tier hop: where its queued
    wait turned into chunk work, and where the work stopped (the ship
    or the fallback)."""
    pf = hop.by_kind("prefill")
    first = hop.spans[0]
    q_end = pf[0].t0 if pf else first.t1
    work_end = pf[-1].t1 if pf else q_end
    return {"q_end": q_end, "work_end": work_end}


def _split_queued(span, *, pf_hops: Sequence[RequestTrace],
                  dispatch_ts: Sequence[float],
                  eps: float = 1e-9) -> List[tuple]:
    """Partition one queued span into (t0, t1, segment) pieces using
    the causal context: prefill-tier hop boundaries carve out remote
    prefill and shipment wait, the dispatch event carves frontend
    routing from decode-queue wait, and a failover/preempt re-queue is
    replay wholesale."""
    reason = span.attrs.get("reason")
    if span.attempt > 1 or reason in _REPLAY_REASONS:
        return [(span.t0, span.t1, "replay")]
    if reason == "shipment_wait":
        return [(span.t0, span.t1, "shipment_wait")]
    overlapping = [h for h in pf_hops if h.spans
                   and h.spans[0].t0 <= span.t1 + eps
                   and h.spans[-1].t1 >= span.t0 - eps]
    if overlapping:
        pieces: List[tuple] = []
        cur = span.t0
        first = True
        for hop in overlapping:
            b = _pf_hop_bounds(hop)
            q_end = min(max(b["q_end"], cur), span.t1)
            work_end = min(max(b["work_end"], q_end), span.t1)
            if q_end > cur + eps:
                pieces.append((cur, q_end,
                               "frontend_queue" if first
                               else "shipment_wait"))
            if work_end > q_end + eps:
                pieces.append((q_end, work_end, "prefill"))
            cur = max(cur, work_end)
            first = False
        if span.t1 > cur + eps:
            pieces.append((cur, span.t1, "shipment_wait"))
        return pieces or [(span.t0, span.t1, "shipment_wait")]
    cut = None
    for t in dispatch_ts:
        if span.t0 - eps <= t <= span.t1 + eps:
            cut = min(max(t, span.t0), span.t1)
            break
    if cut is not None and cut > span.t0 + eps:
        return [(span.t0, cut, "frontend_queue"),
                (cut, span.t1, "decode_queue")]
    return [(span.t0, span.t1, "decode_queue")]


def _ttft_t(prim: RequestTrace) -> Optional[float]:
    """First-token time on the primary hop: the close of the final
    prefill chunk (``last=True``; an adopted shipment emits it
    zero-duration at adoption), else the first decode boundary."""
    lasts = [s for s in prim.by_kind("prefill") if s.attrs.get("last")]
    if lasts:
        return lasts[-1].t1
    dec = prim.by_kind("decode")
    if dec:
        return dec[0].t0
    return None


def critical_path(ft: FleetTrace, *, eps: float = 1e-9
                  ) -> Optional[Dict[str, Any]]:
    """Decompose one stitched request into the exclusive SEGMENTS.

    Returns None when the trace has no client terminal (the request is
    still in flight).  Otherwise a dict with the per-segment totals
    (``segments``), the TTFT-clipped totals (``ttft_segments``), the
    merged piecewise ``path`` [(segment, t0, t1)...], and the
    reconciliation ``residual_s`` = e2e - sum(segments) — zero for any
    contiguous tiling, <= one step quantum per attempt boundary
    otherwise."""
    prim = ft.primary
    if prim is None or not prim.spans:
        return None
    pf_hops = [h for h in ft.hops if h.tier == "prefill"]
    dispatch_ts = sorted(
        _ev_t(ev) for ev in ft.events
        if ev.get("event") == "dispatch"
        and ev.get("tier") in (None, "decode"))
    pieces: List[tuple] = []
    for s in prim.spans:
        if s.kind in TERMINAL_KINDS:
            continue
        if s.kind == "queued":
            pieces.extend(_split_queued(s, pf_hops=pf_hops,
                                        dispatch_ts=dispatch_ts,
                                        eps=eps))
        elif s.kind == "prefill":
            pieces.append((s.t0, s.t1, "prefill"))
        elif s.kind == "decode":
            pieces.append((s.t0, s.t1, "decode"))
        elif s.kind == "reshard_pause":
            pieces.append((s.t0, s.t1, "reshard_pause"))
    pieces = [(t0, t1, seg) for (t0, t1, seg) in pieces if t1 > t0]
    # merge adjacent pieces of the same segment for the rendered path
    path: List[Dict[str, Any]] = []
    for t0, t1, seg in pieces:
        if path and path[-1]["segment"] == seg \
                and abs(path[-1]["t1"] - t0) <= eps:
            path[-1]["t1"] = t1
        else:
            path.append({"segment": seg, "t0": t0, "t1": t1})
    segments = {seg: 0.0 for seg in SEGMENTS}
    for t0, t1, seg in pieces:
        segments[seg] += t1 - t0
    arrival = prim.spans[0].t0
    terminal = prim.spans[-1].t1
    e2e_s = terminal - arrival
    ttft_t = _ttft_t(prim)
    ttft_segments = {seg: 0.0 for seg in SEGMENTS}
    ttft_s = None
    if ttft_t is not None:
        ttft_s = ttft_t - arrival
        for t0, t1, seg in pieces:
            ttft_segments[seg] += max(0.0, min(t1, ttft_t) - t0)
    return {
        "rid": ft.rid,
        "slo_class": ft.slo_class,
        "segments": segments,
        "ttft_segments": ttft_segments,
        "path": path,
        "e2e_s": e2e_s,
        "ttft_s": ttft_s,
        "residual_s": e2e_s - sum(segments.values()),
        "ttft_residual_s": (None if ttft_s is None
                            else ttft_s
                            - sum(ttft_segments.values())),
        "attempts": len(prim.attempts()),
        "hops": len(ft.hops),
    }


def rollup(paths: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate per-request decompositions: total and mean seconds per
    segment plus the worst reconciliation residual — the shape
    slo_report embeds per tenant / SLO class."""
    n = len(paths)
    total = {seg: 0.0 for seg in SEGMENTS}
    for cp in paths:
        for seg in SEGMENTS:
            total[seg] += cp["segments"][seg]
    return {
        "requests": n,
        "total_s": total,
        "mean_s": {seg: (total[seg] / n if n else 0.0)
                   for seg in SEGMENTS},
        "max_residual_s": max((abs(cp["residual_s"]) for cp in paths),
                              default=0.0),
    }


__all__ = ["SEGMENTS", "critical_path", "rollup"]
