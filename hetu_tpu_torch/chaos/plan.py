"""Deterministic fault-injection schedules.

The chaos subsystem makes the elastic recovery paths *provokable*: a
`FaultPlan` is a seeded, replayable schedule of faults the runtime layers
consult at well-defined injection points —

    rpc_drop / rpc_delay / rpc_dup   the client's wire layer (one
                                     request/response exchange) — a lost,
                                     slow, or duplicated message
    heartbeat_stall                  the client heartbeat loop — mimics a
                                     long GIL-pinned compile that
                                     starves the beat thread
    worker_kill                      the chaos harness — a worker dies at
                                     a given training step
    ckpt_corrupt                     the chaos harness — flip/truncate
                                     bytes in the newest checkpoint before
                                     a restore
    slow_worker                      the training step — deterministic
                                     per-step delay inflation on a target
                                     rank (a straggling host, faked), so
                                     the cluster straggler detector is
                                     testable without real hardware skew
    engine_kill                      the serving engine/fleet replica —
                                     dies at a given ENGINE step: every
                                     in-flight request loses its slot and
                                     re-enters the queue under the
                                     HETU_TORCH_SERVE_RETRY budget
                                     (docs/fault_tolerance.md); `rank`
                                     selects the fleet replica
    reshard_storm                    the serving reshard hook — forces a
                                     LoadAdaptiveMesh tier flip every step
                                     of a window, exercising KV re-paging
                                     under repeated hot switches
    decode_stall                     the serving engine step — the
                                     slow_worker shape on the decode
                                     clock: a deterministic per-step
                                     delay window (a compile storm, a
                                     straggling reshard, faked)
    shipment_drop / shipment_dup /   the disaggregated prefill→decode KV
    shipment_delay                   shipment wire (one ship or ack
                                     exchange; op "ship" | "ack" | "*")
                                     — a lost, duplicated, or delayed
                                     shipment the at-least-once protocol
                                     must absorb (docs/serving.md,
                                     "Disaggregated serving")
    prefill_kill                     the prefill tier — dies at a given
                                     COORDINATOR step: in-flight
                                     prefills are lost (their shipments
                                     never arrive → timeout →
                                     re-prefill), and decode replicas
                                     fall back to colocated chunked
                                     prefill for the spec's
                                     ``count``-step down-window

Everything is deterministic given the plan: trigger windows are counted in
*matching calls* (not wall time), and probabilistic faults draw from one
`random.Random(seed)` stream, so the same plan against the same run
injects the same faults.  Every injection increments a
`chaos.injected_<kind>` counter in the metrics registry, which is what the
acceptance tests reconcile against the `elastic.recovery_*` /
`ckpt.fallbacks` / `rpc.reconnects` accounting on the observation side.

Plans load from JSON (`FaultPlan.load`) or are built programmatically
in tests.  Copied from `hetu_tpu/chaos/plan.py` (host-only code); the
port keeps no process-global metrics registry, so a plan counts its
injections in its own `registry` (or the one it is given).  The port
consults the serving kinds (engine_kill, decode_stall, shipment_*,
prefill_kill); the training and rpc kinds keep their schedule format.
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Any, Dict, List, Optional

from hetu_tpu_torch.obs.metrics import MetricsRegistry

KINDS = ("rpc_drop", "rpc_delay", "rpc_dup",
         "heartbeat_stall", "worker_kill", "ckpt_corrupt", "slow_worker",
         "engine_kill", "reshard_storm", "decode_stall",
         "shipment_drop", "shipment_dup", "shipment_delay",
         "prefill_kill")
_WIRE_KINDS = ("rpc_drop", "rpc_delay", "rpc_dup")
_SHIP_KINDS = ("shipment_drop", "shipment_dup", "shipment_delay")
CORRUPT_MODES = ("flip", "truncate", "delete")


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.  Schedule fields (set by the plan author):

    kind         one of KINDS
    op           rpc op pattern for rpc_* kinds; shipment op pattern
                 ("ship" | "ack") for shipment_* kinds ("*" = any op)
    rank         restrict to one client rank (None = any rank)
    after_calls  skip this many matching calls before firing (rpc_* /
                 heartbeat_stall: matching beats via at_beat instead)
    count        fire on this many consecutive matching calls (a window —
                 count > 1 models a partition that eats several messages)
    prob         per-match firing probability (drawn from the plan's
                 seeded stream — deterministic)
    delay_s      rpc_delay / shipment_delay: added latency per fired
                 call (shipment_delay: virtual seconds the delivery is
                 deferred by)
    at_step      worker_kill / ckpt_corrupt: trigger once the observed
                 training step reaches this value; slow_worker /
                 decode_stall: first slowed step (with `count` following
                 steps slowed and `delay_s` added per step);
                 engine_kill: the engine step the replica dies at;
                 prefill_kill: the coordinator step the prefill tier
                 dies at (`count` steps of down-window before rejoin);
                 reshard_storm: first stormed engine step (`count`
                 steps force a tier flip each)
    at_beat      heartbeat_stall: fire at this beat index
    stall_s      heartbeat_stall: how long the beat thread freezes
    mode         ckpt_corrupt: flip | truncate | delete

    Runtime bookkeeping (never set by the author): seen, injected, done.
    """
    kind: str
    op: str = "*"
    rank: Optional[int] = None
    after_calls: int = 0
    count: int = 1
    prob: float = 1.0
    delay_s: float = 0.0
    at_step: Optional[int] = None
    at_beat: Optional[int] = None
    stall_s: float = 0.0
    mode: str = "flip"
    seen: int = 0
    injected: int = 0
    done: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {KINDS}")
        if self.kind == "ckpt_corrupt" and self.mode not in CORRUPT_MODES:
            raise ValueError(f"unknown ckpt_corrupt mode {self.mode!r}; "
                             f"known: {CORRUPT_MODES}")
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")


class FaultPlan:
    """A seeded schedule of FaultSpecs with thread-safe trigger state."""

    _SCHEDULE_FIELDS = ("kind", "op", "rank", "after_calls", "count",
                        "prob", "delay_s", "at_step", "at_beat",
                        "stall_s", "mode")

    def __init__(self, faults: List[FaultSpec], seed: int = 0, *,
                 registry=None):
        self.seed = int(seed)
        #: where the chaos.injected_* counters go (the port keeps no
        #: process-global registry: pass the engine's to see them there)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.faults = list(faults)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ loading
    @classmethod
    def from_dict(cls, d: Dict[str, Any], *, registry=None) -> "FaultPlan":
        faults = []
        for f in d.get("faults", []):
            unknown = set(f) - set(cls._SCHEDULE_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown fault fields {sorted(unknown)} in {f!r}; "
                    f"known: {cls._SCHEDULE_FIELDS}")
            faults.append(FaultSpec(**f))
        return cls(faults, seed=int(d.get("seed", 0)), registry=registry)

    @classmethod
    def load(cls, path: str, *, registry=None) -> "FaultPlan":
        with open(path) as f:
            return cls.from_dict(json.load(f), registry=registry)

    def to_dict(self) -> Dict[str, Any]:
        return {"seed": self.seed, "faults": [
            {k: getattr(s, k) for k in self._SCHEDULE_FIELDS}
            for s in self.faults]}

    # --------------------------------------------------------- injection
    def _rank_matches(self, spec: FaultSpec, rank: Optional[int]) -> bool:
        if spec.rank is None:
            return True
        return rank is not None and rank == spec.rank

    def wire_fault(self, op: str, rank: Optional[int]) -> Optional[FaultSpec]:
        """Consulted by the rpc client once per request/response exchange.
        Advances the matching-call counter of EVERY matching rpc_* spec
        (order-independent bookkeeping) and returns the first spec whose
        window covers this call; None = deliver the message untouched."""
        fired = None
        with self._lock:
            for spec in self.faults:
                if spec.kind not in _WIRE_KINDS:
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                if spec.op != "*" and spec.op != op:
                    continue
                idx = spec.seen
                spec.seen += 1
                if idx < spec.after_calls or \
                        idx >= spec.after_calls + spec.count:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                if fired is None:
                    spec.injected += 1
                    fired = spec
        if fired is not None:
            self.registry.inc(f"chaos.injected_{fired.kind}", op=op)
        return fired

    def shipment_fault(self, op: str,
                       rank: Optional[int] = None) -> Optional[FaultSpec]:
        """Consulted by the disaggregated shipment channel once per
        ship/ack exchange (op is "ship" or "ack").  Same matching-call
        window semantics as `wire_fault`: every matching shipment_*
        spec's counter advances, the first covering spec fires; None =
        deliver the shipment untouched.  `rank` selects the decode
        replica the shipment is bound for."""
        fired = None
        with self._lock:
            for spec in self.faults:
                if spec.kind not in _SHIP_KINDS:
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                if spec.op != "*" and spec.op != op:
                    continue
                idx = spec.seen
                spec.seen += 1
                if idx < spec.after_calls or \
                        idx >= spec.after_calls + spec.count:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                if fired is None:
                    spec.injected += 1
                    fired = spec
        if fired is not None:
            self.registry.inc(f"chaos.injected_{fired.kind}", op=op)
        return fired

    def should_kill_prefill(self, step: int,
                            rank: Optional[int] = None) -> bool:
        """One-shot: True when a prefill_kill spec has its at_step
        reached on the COORDINATOR-step clock (the disagg layer then
        drops every in-flight prefill; their shipments never arrive and
        the timeout path re-prefills them)."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "prefill_kill" or spec.done:
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                if step >= (spec.at_step or 0):
                    spec.done = True
                    spec.injected += 1
                    break
            else:
                return False
        self.registry.inc("chaos.injected_prefill_kill")
        return True

    def prefill_down(self, step: int,
                     rank: Optional[int] = None) -> bool:
        """Is the prefill tier inside a prefill_kill down-window at this
        step?  The window is [at_step, at_step + count): while down,
        decode replicas run colocated chunked prefill (the graceful
        degradation path) and the tier rejoins when the window passes.
        Pure read: no latch, no counter."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "prefill_kill":
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                start = spec.at_step or 0
                if start <= step < start + max(spec.count, 1):
                    return True
        return False

    def heartbeat_stall(self, beat: int, rank: Optional[int]) -> float:
        """Seconds the heartbeat loop should freeze before this beat
        (0.0 = no stall).  Mimics a long compile pinning the GIL."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "heartbeat_stall":
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                start = spec.at_beat if spec.at_beat is not None else 0
                if start <= beat < start + spec.count and spec.stall_s > 0:
                    spec.injected += 1
                    stall = spec.stall_s
                    break
            else:
                return 0.0
        self.registry.inc("chaos.injected_heartbeat_stall")
        return stall

    def step_delay(self, rank: Optional[int], step: int) -> float:
        """Seconds of slow_worker / decode_stall delay to inflate this
        step by (0.0 = none).  Deterministic: the window is [at_step,
        at_step + count) in observed steps, the delay a fixed delay_s
        per step — a faked straggling host (training) or a decode-clock
        stall window (serving) the detectors must catch.  Overlapping
        specs stack (their delays sum)."""
        total = 0.0
        fired_kinds = []
        with self._lock:
            for spec in self.faults:
                if spec.kind not in ("slow_worker", "decode_stall"):
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                start = spec.at_step if spec.at_step is not None else 0
                if start <= step < start + spec.count and spec.delay_s > 0:
                    spec.injected += 1
                    total += spec.delay_s
                    if spec.kind not in fired_kinds:
                        fired_kinds.append(spec.kind)
        for kind in fired_kinds:
            self.registry.inc(f"chaos.injected_{kind}")
        return total

    def should_kill(self, rank: Optional[int], step: int) -> bool:
        """One-shot: True when a worker_kill spec for this rank has its
        at_step reached (the harness then kills/zombifies the worker)."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "worker_kill" or spec.done:
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                if step >= (spec.at_step or 0):
                    spec.done = True
                    spec.injected += 1
                    break
            else:
                return False
        self.registry.inc("chaos.injected_worker_kill")
        return True

    def should_kill_engine(self, step: int,
                           rank: Optional[int] = None) -> bool:
        """One-shot: True when an engine_kill spec has its at_step
        reached on the ENGINE-step clock (the serving harness then
        fails the engine over; `rank` selects a fleet replica)."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "engine_kill" or spec.done:
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                if step >= (spec.at_step or 0):
                    spec.done = True
                    spec.injected += 1
                    break
            else:
                return False
        self.registry.inc("chaos.injected_engine_kill")
        return True

    def engine_down(self, step: int,
                    rank: Optional[int] = None) -> bool:
        """Is the (replica's) engine inside an engine_kill down-window
        at this step?  The window is [at_step, at_step + count): count=1
        (the default) means the recovery replica takes over by the next
        step.  The fleet simulator suspends admissions while down (the
        live single-engine harness recovers instantly — its fail_over
        IS the recovery replica).  Pure read: no latch, no counter."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "engine_kill":
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                start = spec.at_step or 0
                if start <= step < start + max(spec.count, 1):
                    return True
        return False

    def reshard_storm_offset(self, step: int,
                             rank: Optional[int] = None) -> Optional[int]:
        """The storm-window offset of this engine step (0-based), or
        None when no reshard_storm spec covers it.  The serving harness
        forces the LoadAdaptiveMesh onto tier ``offset % num_tiers``
        each covered step — a deterministic flip-flop that exercises KV
        re-paging under repeated hot switches."""
        with self._lock:
            for spec in self.faults:
                if spec.kind != "reshard_storm":
                    continue
                if not self._rank_matches(spec, rank):
                    continue
                start = spec.at_step if spec.at_step is not None else 0
                if start <= step < start + spec.count:
                    spec.injected += 1
                    off = step - start
                    break
            else:
                return None
        self.registry.inc("chaos.injected_reshard_storm")
        return off

    def take_ckpt_corrupt(self,
                          newest_step: Optional[int]) -> Optional[FaultSpec]:
        """One-shot: the spec to apply when the newest on-disk checkpoint
        step has reached at_step (the harness then corrupts that step)."""
        if newest_step is None:
            return None
        with self._lock:
            for spec in self.faults:
                if spec.kind != "ckpt_corrupt" or spec.done:
                    continue
                if newest_step >= (spec.at_step or 0):
                    spec.done = True
                    spec.injected += 1
                    break
            else:
                return None
        self.registry.inc("chaos.injected_ckpt_corrupt")
        return spec

    # ------------------------------------------------------------ report
    def summary(self) -> Dict[str, int]:
        """Injected-fault counts by kind (kinds present in the plan appear
        even at zero — a schedule that never fired is a signal too)."""
        with self._lock:
            out: Dict[str, int] = {}
            for spec in self.faults:
                out[spec.kind] = out.get(spec.kind, 0) + spec.injected
            return out
