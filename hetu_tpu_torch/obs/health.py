"""Health monitors, the port of `hetu_tpu/obs/health.py`: online
anomaly detection for training and serving.

``HealthMonitor`` watches a training loop step by step for

    loss_spike             loss jumps far above its EWMA baseline
    nan_loss / nan_grad    non-finite loss / grad norm
    grad_blowup            grad-norm explosion above baseline
    step_time_regression   step time regresses
    data_stall             the gap BETWEEN steps (host/input time) blows up

``NumericsHealthMonitor`` watches the numerics observatory's per-step
stats (obs/numerics.py, HETU_TORCH_NUMERICS) for underflow_creep,
quant_snr_collapse, ef_residual_blowup and router_collapse.

``ServingHealthMonitor`` is the serving twin (ttft_regression,
queue_depth_blowup, page_exhaustion_imminent, brownout_shed); the
serving engine does not wire it yet (ROADMAP Queue A item 4).

Each firing increments a ``health.<kind>`` counter, emits an
``anomaly`` RunLog event and — for the severe training kinds — can call
an emergency hook (the trainer's checkpoint save).  Detectors use an
EWMA mean plus an EWMA absolute deviation and fire only after
``warmup`` observations; a per-kind cooldown stops one regime shift
from firing every step.  Gated by ``HETU_TORCH_HEALTH``: unset, the
``maybe_*`` functions return None and the trainer does no health work.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.utils import flags
from hetu_tpu_torch.utils.logging import get_logger

logger = get_logger("obs.health")

#: MAD -> sigma consistency constant
_MAD_SIGMA = 1.4826


class Ewma:
    """EWMA mean + EWMA absolute deviation, with a sample count."""

    __slots__ = ("alpha", "mean", "dev", "n")

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.mean: Optional[float] = None
        self.dev = 0.0
        self.n = 0

    def update(self, v: float):
        if self.mean is None:
            self.mean = v
        else:
            a = self.alpha
            self.dev = (1 - a) * self.dev + a * abs(v - self.mean)
            self.mean = (1 - a) * self.mean + a * v
        self.n += 1


class _MonitorBase:
    """The shared detector chassis: EWMA spike rule, per-kind cooldown,
    and the one firing path (counter + ``anomaly`` RunLog record +
    optional emergency hook) both the training and
    serving monitors use — one record shape, one counter namespace."""

    def __init__(self, runlog=None, registry=None,
                 warmup: int = 8, cooldown_steps: int = 16):
        self.runlog = runlog
        self.registry = (registry if registry is not None
                         else MetricsRegistry())
        self.warmup = warmup
        self.cooldown_steps = cooldown_steps
        self.emergency_hook = None
        self.emergency_kinds: frozenset = frozenset()
        self._cooldown_until: Dict[str, int] = {}
        self.anomalies_total = 0

    def _spike(self, ewma: Ewma, v: float, k: float,
               ratio: Optional[float] = None) -> bool:
        """v far above the EWMA baseline.  Two independent rules, either
        fires: the additive `mean + k*MAD-sigma` (catches spikes in noisy
        signals, where sigma is meaningful) OR the multiplicative
        `mean * ratio` (carries the decision on steady signals whose
        deviation converged to ~0 — and stays live while a sustained
        regression is inflating the deviation, where the additive
        threshold chases the anomaly)."""
        if ewma.n < self.warmup or ewma.mean is None:
            return False
        if v > ewma.mean + k * (_MAD_SIGMA * ewma.dev
                                + 1e-3 * abs(ewma.mean) + 1e-12):
            return True
        return ratio is not None and v > ewma.mean * ratio

    def _sag(self, ewma: Ewma, v: float, k: float,
             floor: Optional[float] = None) -> bool:
        """v far BELOW the EWMA baseline — the mirror of :meth:`_spike`
        for signals whose failure direction is down (quantization SNR,
        router entropy).  Fires on the additive `mean - k*MAD-sigma`
        rule OR on crossing an absolute `floor` (a level no healthy run
        should visit, baseline notwithstanding); both wait out
        ``warmup`` so the first observations can't self-fire."""
        if ewma.n < self.warmup or ewma.mean is None:
            return False
        if v < ewma.mean - k * (_MAD_SIGMA * ewma.dev
                                + 1e-3 * abs(ewma.mean) + 1e-12):
            return True
        return floor is not None and v < floor

    def _fire(self, kind: str, step: int, value: float,
              baseline: Optional[float], t: float,
              out: List[Dict[str, Any]]):
        if step < self._cooldown_until.get(kind, -1):
            return
        self._cooldown_until[kind] = step + self.cooldown_steps
        self.anomalies_total += 1
        self.registry.inc(f"health.{kind}")
        self.registry.inc("health.anomalies")
        rec = {"kind": "anomaly", "t": t, "anomaly": kind, "step": step,
               "value": value, "baseline": baseline}
        logger.warning(f"anomaly[{kind}] at step {step}: value={value!r} "
                       f"baseline={baseline!r}")
        if self.runlog is not None:
            written = self.runlog.log("anomaly", anomaly=kind, step=step,
                                      value=value, baseline=baseline)
            rec = written or rec
        out.append(rec)
        if self.emergency_hook is not None and kind in self.emergency_kinds:
            try:
                self.emergency_hook()
                self.registry.inc("health.emergency_saves")
            except Exception as e:   # telemetry never kills a step
                self.registry.inc("health.emergency_save_failures")
                logger.error(f"emergency hook for {kind} failed: {e!r}")


class HealthMonitor(_MonitorBase):
    """Per-step anomaly detection for a training loop.

    Call :meth:`observe_step` once per completed step.  Returns the list
    of anomalies fired on that step (empty almost always) — the caller
    never needs to look at it; counters/RunLog carry the signal.

    ``emergency_hook`` (no-arg callable, e.g. a bound ``save``) runs on
    kinds in ``emergency_kinds`` — best-effort, never raises into the
    training loop.
    """

    KINDS = ("loss_spike", "nan_loss", "nan_grad", "grad_blowup",
             "step_time_regression", "data_stall")

    def __init__(self, runlog=None, registry=None,
                 emergency_hook=None,
                 emergency_kinds=("nan_loss", "nan_grad"),
                 warmup: int = 8, alpha: float = 0.1,
                 loss_k: float = 6.0, grad_k: float = 8.0,
                 step_time_k: float = 6.0, step_time_ratio: float = 2.0,
                 stall_ratio: float = 5.0, stall_min_s: float = 1.0,
                 cooldown_steps: int = 16):
        super().__init__(runlog=runlog, registry=registry,
                         warmup=warmup, cooldown_steps=cooldown_steps)
        self.emergency_hook = emergency_hook
        self.emergency_kinds = frozenset(emergency_kinds)
        self.loss_k, self.grad_k = loss_k, grad_k
        self.step_time_k, self.step_time_ratio = step_time_k, step_time_ratio
        self.stall_ratio, self.stall_min_s = stall_ratio, stall_min_s
        self._loss = Ewma(alpha)
        self._grad = Ewma(alpha)
        self._step_time = Ewma(alpha)
        self._fetch = Ewma(alpha)
        self._last_t: Optional[float] = None

    # ------------------------------------------------------------------
    def observe_step(self, step: int, step_time_s: float, *,
                     loss: Optional[float] = None,
                     grad_norm: Optional[float] = None,
                     t: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one completed step; returns anomalies fired (usually [])."""
        t = time.time() if t is None else t
        fired: List[Dict[str, Any]] = []

        # data stall: host/input time = inter-observe gap minus the step
        # itself.  The device can be perfectly healthy while the input
        # pipeline starves it — that shows up HERE and nowhere else.
        if self._last_t is not None:
            fetch = max(0.0, (t - self._last_t) - step_time_s)
            if self._fetch.n >= self.warmup and fetch > max(
                    self.stall_min_s,
                    (self._fetch.mean or 0.0) * self.stall_ratio):
                self._fire("data_stall", step, fetch, self._fetch.mean,
                           t, fired)
            self._fetch.update(fetch)
        self._last_t = t

        if loss is not None:
            if not math.isfinite(loss):
                self._fire("nan_loss", step, loss, self._loss.mean, t, fired)
            else:
                if self._spike(self._loss, loss, self.loss_k):
                    self._fire("loss_spike", step, loss, self._loss.mean,
                               t, fired)
                self._loss.update(loss)

        if grad_norm is not None:
            if not math.isfinite(grad_norm):
                self._fire("nan_grad", step, grad_norm, self._grad.mean,
                           t, fired)
            else:
                if self._spike(self._grad, grad_norm, self.grad_k):
                    self._fire("grad_blowup", step, grad_norm,
                               self._grad.mean, t, fired)
                self._grad.update(grad_norm)

        if self._spike(self._step_time, step_time_s, self.step_time_k,
                       ratio=self.step_time_ratio):
            self._fire("step_time_regression", step, step_time_s,
                       self._step_time.mean, t, fired)
        self._step_time.update(step_time_s)
        return fired


def maybe_health_monitor(runlog=None, emergency_hook=None, registry=None,
                         **kw) -> Optional[HealthMonitor]:
    """A HealthMonitor when HETU_TORCH_HEALTH is set, else None — the one
    gate every training loop uses, so 'flag unset' provably means zero
    per-step health work (a single None check)."""
    if not flags.bool_flag("HETU_TORCH_HEALTH"):
        return None
    return HealthMonitor(runlog=runlog, registry=registry,
                         emergency_hook=emergency_hook, **kw)


class ServingHealthMonitor(_MonitorBase):
    """Per-engine-step anomaly detection for the serving front end.

    The engine calls :meth:`observe_ttft` once per first token and
    :meth:`observe_step` once per engine step; all clocks are the
    caller's (virtual in replayed traces), so detector firings are
    deterministic under a simulated timeline.

    Detectors (thresholds are constructor knobs):

    * ``ttft_regression`` — TTFT above the EWMA additive threshold OR
      ``ttft_ratio`` x baseline (the same two-rule spike the training
      step-time detector uses).
    * ``queue_depth_blowup`` — queue depth >= ``queue_min`` AND above
      baseline by the spike rule with ``queue_ratio``: arrivals have
      outrun decode throughput, latency is compounding.
    * ``page_exhaustion_imminent`` — page-pool utilization at or above
      ``page_high`` for ``page_streak`` consecutive steps while
      requests queue: the next admissions will all stall ``no_pages``.
    * ``brownout_shed`` — not a detector: an engine's brownout policy
      reports each shed through
      :meth:`note_brownout`, so load-shedding rides the same anomaly
      stream, counters, and cooldown as the organic detectors.
    """

    KINDS = ("ttft_regression", "queue_depth_blowup",
             "page_exhaustion_imminent", "brownout_shed")

    def __init__(self, runlog=None, registry=None,
                 warmup: int = 8, alpha: float = 0.2,
                 ttft_k: float = 6.0, ttft_ratio: float = 3.0,
                 queue_k: float = 8.0, queue_ratio: float = 4.0,
                 queue_min: int = 4,
                 page_high: float = 0.95, page_streak: int = 4,
                 cooldown_steps: int = 16):
        super().__init__(runlog=runlog, registry=registry,
                         warmup=warmup, cooldown_steps=cooldown_steps)
        self.ttft_k, self.ttft_ratio = ttft_k, ttft_ratio
        self.queue_k, self.queue_ratio = queue_k, queue_ratio
        self.queue_min = queue_min
        self.page_high, self.page_streak = page_high, page_streak
        self._ttft = Ewma(alpha)
        self._queue = Ewma(alpha)
        self._page_hot = 0

    # ------------------------------------------------------------------
    def observe_ttft(self, ttft_s: float, *, step: int,
                     t: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one request's TTFT (engine-step `step` for cooldown)."""
        t = time.time() if t is None else t
        fired: List[Dict[str, Any]] = []
        if self._spike(self._ttft, ttft_s, self.ttft_k,
                       ratio=self.ttft_ratio):
            self._fire("ttft_regression", step, ttft_s, self._ttft.mean,
                       t, fired)
        self._ttft.update(ttft_s)
        return fired

    def observe_step(self, step: int, *, queue_depth: int,
                     page_util: float,
                     t: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one completed engine step's load signals."""
        t = time.time() if t is None else t
        fired: List[Dict[str, Any]] = []
        if queue_depth >= self.queue_min and self._spike(
                self._queue, float(queue_depth), self.queue_k,
                ratio=self.queue_ratio):
            self._fire("queue_depth_blowup", step, float(queue_depth),
                       self._queue.mean, t, fired)
        self._queue.update(float(queue_depth))

        # exhaustion-imminent is a level rule, not a spike rule: a pool
        # DESIGNED to run hot only fires when the queue shows demand the
        # pool can no longer absorb
        if page_util >= self.page_high and queue_depth > 0:
            self._page_hot += 1
            if self._page_hot >= self.page_streak:
                self._fire("page_exhaustion_imminent", step,
                           float(page_util), self.page_high, t, fired)
        else:
            self._page_hot = 0
        return fired

    def note_brownout(self, step: int, *, shed: int, page_util: float,
                      t: Optional[float] = None) -> List[Dict[str, Any]]:
        """The engine's brownout policy shed `shed` queued requests at
        engine step `step` — meter it as a
        ``brownout_shed`` anomaly (value = requests shed, baseline =
        the page utilization that tripped the policy).  Per-kind
        cooldown applies like any detector, so a sustained brownout
        logs at the cooldown cadence, not every step."""
        t = time.time() if t is None else t
        fired: List[Dict[str, Any]] = []
        self._fire("brownout_shed", step, float(shed), float(page_util),
                   t, fired)
        return fired


class NumericsHealthMonitor(_MonitorBase):
    """Detectors over the numerics observatory's per-step stats pytree
    (obs/numerics.py, HETU_TORCH_NUMERICS) — the failure shapes of
    aggressive precision reduction, caught while the loss still looks
    healthy:

    * ``underflow_creep`` — a scope's bf16-underflow fraction is both
      above ``underflow_min`` AND spiking vs its own EWMA baseline
      (weights/grads/activations sliding below the smallest normal:
      silent signal loss long before NaNs).
    * ``quant_snr_collapse`` — a compressed path's measured SNR sags
      far below its baseline or under ``snr_floor_db`` (a bad scale, a
      distribution shift the int8 grid can no longer represent).
    * ``ef_residual_blowup`` — the error-feedback residual RMS spikes
      (the compressor is systematically behind; convergence is next).
    * ``router_collapse`` — max expert load at/above
      ``router_load_max`` for ``router_streak`` consecutive records, or
      router entropy sagging below baseline (one expert is eating the
      batch; the rest are dying).

    Same chassis as the other monitors: per-kind cooldown, health.*
    counters, ``anomaly`` RunLog events — and the same
    ``HETU_TORCH_HEALTH`` gate (one switch, whole health surface).

    Call :meth:`observe` once per recorded numerics step with the
    (host-fetched) ``{scope: {stat: value}}`` dict.
    """

    KINDS = ("underflow_creep", "quant_snr_collapse",
             "ef_residual_blowup", "router_collapse")

    def __init__(self, runlog=None, registry=None,
                 warmup: int = 8, alpha: float = 0.2,
                 underflow_min: float = 0.05, underflow_k: float = 6.0,
                 snr_k: float = 6.0, snr_floor_db: float = 10.0,
                 ef_k: float = 8.0,
                 router_load_max: float = 0.7, router_streak: int = 2,
                 entropy_k: float = 6.0,
                 cooldown_steps: int = 16):
        super().__init__(runlog=runlog, registry=registry,
                         warmup=warmup, cooldown_steps=cooldown_steps)
        self.alpha = alpha
        self.underflow_min, self.underflow_k = underflow_min, underflow_k
        self.snr_k, self.snr_floor_db = snr_k, snr_floor_db
        self.ef_k = ef_k
        self.router_load_max, self.router_streak = (router_load_max,
                                                    router_streak)
        self.entropy_k = entropy_k
        self._ewma: Dict[tuple, Ewma] = {}
        self._router_hot = 0

    def _e(self, *key) -> Ewma:
        e = self._ewma.get(key)
        if e is None:
            e = self._ewma[key] = Ewma(self.alpha)
        return e

    def observe(self, step: int, scopes: Dict[str, Dict[str, Any]],
                *, t: Optional[float] = None) -> List[Dict[str, Any]]:
        """Feed one recorded numerics step; returns anomalies fired."""
        t = time.time() if t is None else t
        fired: List[Dict[str, Any]] = []
        for scope, stats in sorted((scopes or {}).items()):
            uf = stats.get("underflow_frac")
            if uf is not None and math.isfinite(uf):
                e = self._e("uf", scope)
                if uf >= self.underflow_min and self._spike(
                        e, uf, self.underflow_k, ratio=3.0):
                    self._fire("underflow_creep", step, uf, e.mean, t,
                               fired)
                e.update(uf)
            snr = stats.get("snr_db")
            if snr is not None and math.isfinite(snr):
                e = self._e("snr", scope)
                if self._sag(e, snr, self.snr_k,
                             floor=self.snr_floor_db):
                    self._fire("quant_snr_collapse", step, snr, e.mean,
                               t, fired)
                e.update(snr)
            if scope == "ef":
                rms = stats.get("rms")
                if rms is not None and math.isfinite(rms):
                    e = self._e("ef", scope)
                    if self._spike(e, rms, self.ef_k, ratio=4.0):
                        self._fire("ef_residual_blowup", step, rms,
                                   e.mean, t, fired)
                    e.update(rms)
            if scope == "moe":
                lm = stats.get("load_max")
                if lm is not None and math.isfinite(lm):
                    # level rule with a streak: a router pinned on one
                    # expert is collapsed NOW, whatever the baseline
                    # was.  `load` is token-denominated (a balanced
                    # top-k router sits at k/E), so the threshold rises
                    # to 2x balanced for high-k/E configs — a fixed
                    # 0.7 would alarm permanently on e.g. E=4, k=3
                    # (balanced load_max 0.75); past 1.0 the level
                    # rule is unreachable and the entropy sag carries
                    # the detection alone.
                    load = stats.get("load")
                    thresh = self.router_load_max
                    if load is not None and len(load):
                        # load may be a list (RunLog) or ndarray (the
                        # raw device_get pytree) — take plain floats
                        ksum = float(sum(float(v) for v in load))
                        thresh = max(thresh, 2.0 * ksum / len(load))
                    if thresh <= 1.0 + 1e-9 and lm >= thresh - 1e-6:
                        self._router_hot += 1
                        if self._router_hot >= self.router_streak:
                            self._fire("router_collapse", step, lm,
                                       thresh, t, fired)
                    else:
                        self._router_hot = 0
                ent = stats.get("entropy")
                if ent is not None and math.isfinite(ent):
                    e = self._e("entropy", scope)
                    if self._sag(e, ent, self.entropy_k):
                        self._fire("router_collapse", step, ent, e.mean,
                                   t, fired)
                    e.update(ent)
        return fired


def maybe_numerics_health_monitor(runlog=None, registry=None, **kw
                                  ) -> Optional[NumericsHealthMonitor]:
    """A NumericsHealthMonitor when HETU_TORCH_HEALTH is set, else None —
    the numerics observatory's single-None-check gate (same flag as the
    scalar training monitor: one switch turns the whole health surface
    on; the stats themselves additionally need HETU_TORCH_NUMERICS)."""
    if not flags.bool_flag("HETU_TORCH_HEALTH"):
        return None
    return NumericsHealthMonitor(runlog=runlog, registry=registry, **kw)


def maybe_serving_health_monitor(runlog=None, registry=None, **kw
                                 ) -> Optional[ServingHealthMonitor]:
    """A ServingHealthMonitor when HETU_TORCH_HEALTH is set, else None —
    the serving engine's single-None-check gate (same flag as training:
    one switch turns the whole health surface on)."""
    if not flags.bool_flag("HETU_TORCH_HEALTH"):
        return None
    return ServingHealthMonitor(runlog=runlog, registry=registry, **kw)
