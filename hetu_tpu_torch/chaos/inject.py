"""The serving fault injection points, the serving half of
`hetu_tpu/chaos/inject.py` (host-only code):

* `decode_stall` — per-step delay inflation at an engine-step injection
  point (`maybe_slow_step`, from the `ServingEngine.run` on_step hook);
* `engine_kill` — fail the engine over at a scheduled step
  (`maybe_chaos_serving`; in-flight requests requeue under
  HETU_TORCH_SERVE_RETRY);
* `prefill_kill` — kill the disaggregated prefill tier at a scheduled
  coordinator step (`maybe_chaos_disagg`).  The shipment_* wire kinds
  are consulted by the shipment channel itself
  (`FaultPlan.shipment_fault`), not here.

The reference's `reshard_storm` pins a load-adaptive mesh onto a
flip-flopping tier; the port has no such mesh yet, so a plan that
schedules one raises NotImplementedError naming the slice that brings
it.  The checkpoint corruptions stay with the chaos harness's slice.
"""
from __future__ import annotations

import time
from typing import Optional

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


def maybe_slow_step(plan, rank: Optional[int], step: int) -> float:
    """Apply any scheduled `slow_worker` / `decode_stall` delay for
    (rank, step): sleeps the plan's per-step inflation and returns the
    seconds slept (0.0 when no plan or no matching spec)."""
    if plan is None:
        return 0.0
    delay = plan.step_delay(rank, step)
    if delay > 0:
        time.sleep(delay)
    return delay


def maybe_chaos_serving(plan, engine, step: int,
                        rank: Optional[int] = None) -> dict:
    """Apply the serving fault kinds for engine step `step` (the
    `on_step` hook of `ServingEngine.run`; no plan = nothing).  Returns
    what fired: ``{"killed": bool, "forced_tier": None}``.

    `engine_kill` is one-shot: `engine.fail_over()` requeues every
    in-flight request (retry budget HETU_TORCH_SERVE_RETRY, stall reason
    `replica_lost`), and greedy or seeded sampling replays each survivor
    token-identically."""
    out = {"killed": False, "forced_tier": None}
    if plan is None:
        return out
    if plan.should_kill_engine(step, rank):
        engine.fail_over()
        out["killed"] = True
    if plan.reshard_storm_offset(step, rank) is not None:
        raise NotImplementedError(
            "the reshard_storm fault pins a load-adaptive mesh, which is "
            f"not in the port yet; it arrives with {_MULTI_GPU}")
    return out


def maybe_chaos_disagg(plan, coordinator, step: int,
                       rank: Optional[int] = None) -> dict:
    """Apply the disaggregated-tier fault kinds for coordinator step
    `step` (no plan = nothing).  Returns what fired:
    ``{"prefill_killed": bool, "prefill_down": bool}``.

    * `prefill_kill` — one-shot: `coordinator.kill_prefill_tier()`
      drops every in-flight prefill (their shipments never arrive, so
      the at-least-once timeout re-prefills each under the retry
      budget).
    * the `prefill_down` window — while True, the coordinator routes
      new admissions through colocated chunked prefill on the decode
      engine (stall reason `prefill_tier_down`) and recovers when the
      window passes."""
    out = {"prefill_killed": False, "prefill_down": False}
    if plan is None:
        return out
    if plan.should_kill_prefill(step, rank):
        coordinator.kill_prefill_tier()
        out["prefill_killed"] = True
    out["prefill_down"] = plan.prefill_down(step, rank)
    return out
