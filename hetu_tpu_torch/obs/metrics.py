"""Process-local metrics registry, copied from `hetu_tpu/obs/metrics.py`
(host-only code; the port keeps its own copy so it never imports the
JAX package).

    reg = MetricsRegistry()
    reg.inc("serve.decode_steps")
    reg.set_gauge("serve.page_util", 0.25)
    reg.observe("serve.ttft_s", 0.412)

Counters are monotonic, gauges are last-write-wins, histograms keep a
bounded reservoir and report count/sum/min/max/percentiles.  Every
series is keyed by (name, sorted label items).  All operations are
thread-safe.  There is no process-global registry: whoever needs one
creates it and passes it along.
"""
from __future__ import annotations

import math
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile_of_sorted(sorted_vals: List[float],
                         p: float) -> Optional[float]:
    """Nearest-rank percentile (p in [0, 100]) over an ascending list."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class Histogram:
    """Bounded-reservoir histogram: the first `cap` observations
    verbatim plus running count/sum/min/max; past the cap a uniform
    reservoir (Vitter's Algorithm R) from a per-histogram seeded RNG.
    Non-finite observations are counted apart and never poison the
    statistics."""

    __slots__ = ("cap", "count", "total", "vmin", "vmax", "_sample", "_rng",
                 "nonfinite")

    def __init__(self, cap: int = 2048, seed: int = 0):
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self._sample: List[float] = []
        self._rng = random.Random(seed)
        self.nonfinite = 0

    def observe(self, value: float):
        v = float(value)
        if not math.isfinite(v):
            self.nonfinite += 1
            return
        self.count += 1
        self.total += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        if len(self._sample) < self.cap:
            self._sample.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self._sample[j] = v

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100] over the reservoir (exact until `cap` samples)."""
        return percentile_of_sorted(sorted(self._sample), p)

    def summary(self) -> Dict[str, Any]:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin, "max": self.vmax,
               "mean": (self.total / self.count) if self.count else None}
        for p in (50, 95, 99):
            out[f"p{p}"] = self.percentile(p)
        if self.nonfinite:
            out["nonfinite"] = self.nonfinite
        return out


class MetricsRegistry:
    """One registry of counters/gauges/histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, _LabelKey], float] = {}
        self._gauges: Dict[Tuple[str, _LabelKey], float] = {}
        self._hists: Dict[Tuple[str, _LabelKey], Histogram] = {}

    # ------------------------------------------------------------- write
    def inc(self, name: str, value: float = 1.0, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, value: float, **labels):
        key = (name, _label_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            h.observe(value)

    # -------------------------------------------------------------- read
    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get((name, _label_key(labels)))

    def histogram(self, name: str, **labels) -> Optional[Histogram]:
        return self._hists.get((name, _label_key(labels)))

    def snapshot(self) -> Dict[str, Any]:
        """{'counters': [...], 'gauges': [...], 'histograms': [...]} with
        each series as {'name', 'labels', ...} — JSON-serializable."""
        with self._lock:
            counters = [{"name": n, "labels": dict(lk), "value": v}
                        for (n, lk), v in sorted(self._counters.items())]
            gauges = [{"name": n, "labels": dict(lk), "value": v}
                      for (n, lk), v in sorted(self._gauges.items())]
            hists = [dict({"name": n, "labels": dict(lk)}, **h.summary())
                     for (n, lk), h in sorted(self._hists.items())]
        return {"counters": counters, "gauges": gauges, "histograms": hists}
