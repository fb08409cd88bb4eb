"""Capacity-factor rebalancing from the live expert-load gauges, the port
of `hetu_tpu/nn/moe_rebalance.py` (host-side).

`nn/moe.py` publishes the router's load through the numerics
observatory: `moe.expert_load` gauges (the share of TOKENS carrying each
expert, summing to ~top_k) and the `moe.capacity_dropped` counter.
`CapacityRebalancer.observe()` reads those gauges and proposes a new
`capacity_factor` when the observed load says the current one is wrong
in either direction; the caller applies it by building a fresh model or
layer with `apply(moe_cfg, factor)` (capacity is a buffer shape).

A balanced router puts top_k / E of the tokens on each expert, and the
hottest expert needs cf >= load_max * E / k to drop nothing:

* GROW  when needed > cf for `strikes` observations in a row
  -> needed * headroom, capped at `max_factor`;
* SHRINK when needed * shrink_margin < cf for `strikes` observations
  -> needed * headroom, floored at `min_factor`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from hetu_tpu_torch.obs.metrics import MetricsRegistry


@dataclasses.dataclass
class RebalanceDecision:
    """One proposed capacity change: the new factor + the evidence."""
    capacity_factor: float
    reason: str                # "grow" | "shrink"
    load_max: float            # observed hottest-expert token share
    needed_factor: float       # cf that would just fit the hottest


class CapacityRebalancer:
    """Watch the `moe.expert_load` gauges, propose capacity changes.
    Call `observe()` once a reporting interval (whenever a numerics
    record refreshed the gauges); it returns a RebalanceDecision when
    `strikes` observations in a row agree, else None.  `registry` is the
    one the records write into (the `Trainer`'s or the engine's): the
    port keeps no process-global registry."""

    def __init__(self, num_experts: int, top_k: int,
                 capacity_factor: float,
                 registry: MetricsRegistry, *,
                 headroom: float = 1.1, shrink_margin: float = 1.5,
                 strikes: int = 2, min_factor: float = 1.0,
                 max_factor: float = 8.0):
        if strikes < 1:
            raise ValueError(f"strikes must be >= 1, got {strikes}")
        self.num_experts = num_experts
        self.top_k = max(top_k, 1)
        self.capacity_factor = float(capacity_factor)
        self.registry = registry
        self.headroom = headroom
        self.shrink_margin = shrink_margin
        self.strikes = strikes
        self.min_factor = min_factor
        self.max_factor = max_factor
        self._grow_streak = 0
        self._shrink_streak = 0

    def _load_max(self) -> Optional[float]:
        loads = [self.registry.gauge_value("moe.expert_load",
                                           expert=str(i))
                 for i in range(self.num_experts)]
        loads = [v for v in loads if v is not None]
        return max(loads) if loads else None

    def observe(self) -> Optional[RebalanceDecision]:
        load_max = self._load_max()
        if load_max is None:
            return None                      # gauges not published yet
        needed = load_max * self.num_experts / self.top_k
        cf = self.capacity_factor
        if needed > cf:
            self._grow_streak += 1
            self._shrink_streak = 0
            if self._grow_streak >= self.strikes:
                return self._decide("grow", load_max, needed)
        elif needed * self.shrink_margin < cf:
            self._shrink_streak += 1
            self._grow_streak = 0
            if self._shrink_streak >= self.strikes:
                return self._decide("shrink", load_max, needed)
        else:
            self._grow_streak = self._shrink_streak = 0
        return None

    def _decide(self, reason: str, load_max: float,
                needed: float) -> Optional[RebalanceDecision]:
        new = min(self.max_factor,
                  max(self.min_factor, needed * self.headroom))
        self._grow_streak = self._shrink_streak = 0
        if abs(new - self.capacity_factor) < 1e-9:
            return None                      # clamped into no-op
        self.capacity_factor = new
        self.registry.set_gauge("moe.capacity_factor", new)
        self.registry.inc("moe.rebalances", reason=reason)
        return RebalanceDecision(capacity_factor=new, reason=reason,
                                 load_max=load_max, needed_factor=needed)


def apply(moe_cfg, factor: float):
    """A MoEConfig with the rebalanced capacity factor — feed it to a
    fresh MoELayer (a LlamaConfig takes it as `moe_capacity_factor`)."""
    return dataclasses.replace(moe_cfg, capacity_factor=float(factor))
