"""The numerics observatory, the port of `hetu_tpu/obs/numerics.py`:
tensor statistics at named scopes of a training step, quantization SNR
accounting, and the host-side recording pipeline.

* ``collecting()`` installs a thread-local :class:`Collector` for one
  step; the `Trainer` does so only under ``HETU_TORCH_NUMERICS``, and a
  tap with no collector installed computes nothing.
* ``tap_tree`` / ``tap_stats`` / ``tap_quant_error`` record into the
  collector's top frame.  The reference skips (and counts in
  ``skipped``) a tap made inside a transform whose values cannot escape
  to the frame; eager PyTorch has no such trace, but a recompute
  segment re-running its forward in the backward (`nn/remat.py`) would
  tap a second time: such taps are skipped and counted, never recorded
  twice (``suspended()``).
* ``frame()`` opens a nested frame whose resolved stats are handed back
  (the trainer's per-micro-batch model taps); ``reduce_stacked`` folds
  stats stacked along a leading axis by each stat's rule (max for
  absmax, sum for counts and powers, mean otherwise) and ``merge``
  folds a stats tree into the ambient frame.
* ``Collector.finalize()`` turns accumulated signal/error powers into
  ``snr_db`` and returns ``{scope: {stat: value}}``.

Stats are 0-d tensors on the tapped tensors' device until ``record``,
the one host sink, reads them: a ``numerics`` RunLog record and
``numerics.*`` gauges; ``summarize_numerics`` is the one reader.

Stats per tensor scope (``tree_stats``): ``absmax``, ``rms``, ``l2``,
``nonfinite`` (count), ``underflow_frac`` (of finite nonzero values,
those below the 16-bit reference dtype's smallest normal times a
margin: x256 for the 8-bit-exponent bf16, x4 for fp16) and
``overflow_frac`` (of finite values, those above its max).  The
reference dtype is the tensor's own when it is bf16 or fp16, else bf16.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from hetu_tpu_torch.utils import flags

#: schema version stamped on every ``numerics`` RunLog record
NUMERICS_SCHEMA = 1

#: the quantized paths' block (the reference's `comm.wire.DEFAULT_BLOCK`)
DEFAULT_BLOCK = 256

#: the stats `tree_stats` takes of a tree
TREE_STATS = ("absmax", "rms", "l2", "nonfinite", "underflow_frac",
              "overflow_frac")

_SUM_STATS = frozenset({"nonfinite", "dropped", "sig_pow", "err_pow",
                        "count", "tokens"})
_MAX_STATS = frozenset({"absmax", "load_max"})


def rule_for(name: str) -> str:
    """How a stat combines across taps and stacked frames."""
    if name in _SUM_STATS:
        return "sum"
    if name in _MAX_STATS:
        return "max"
    return "mean"


def numerics_enabled() -> bool:
    """The HETU_TORCH_NUMERICS gate (read once by the trainer)."""
    return flags.bool_flag("HETU_TORCH_NUMERICS")


def record_every() -> int:
    """HETU_TORCH_NUMERICS_EVERY: record the stats every N-th step."""
    return max(1, flags.int_flag("HETU_TORCH_NUMERICS_EVERY"))


# ---------------------------------------------------------------------------
# the collector
# ---------------------------------------------------------------------------

class _Frame:
    __slots__ = ("acc",)

    def __init__(self):
        # scope -> stat -> [rule, value, count]
        self.acc: Dict[str, Dict[str, list]] = {}

    def add(self, scope: str, name: str, value):
        sc = self.acc.setdefault(scope, {})
        rule = rule_for(name)
        slot = sc.get(name)
        if slot is None:
            sc[name] = [rule, value, 1]
        elif rule == "max":
            slot[1] = torch.maximum(torch.as_tensor(slot[1]),
                                    torch.as_tensor(value))
        else:
            slot[1] = slot[1] + value
            slot[2] += rule == "mean"

    def resolve(self) -> Dict[str, Dict[str, Any]]:
        return {scope: {name: value / count if count > 1 else value
                        for name, (_rule, value, count) in stats.items()}
                for scope, stats in self.acc.items()}


class Collector:
    """Per-step tap accumulator (install with :func:`collecting`)."""

    def __init__(self):
        self.frames: List[_Frame] = [_Frame()]
        self.skipped = 0      # taps made while recomputing: never recorded
        self.suspended = 0

    def push_frame(self):
        self.frames.append(_Frame())

    def pop_frame(self) -> Dict[str, Dict[str, Any]]:
        return self.frames.pop().resolve()

    def finalize(self) -> Dict[str, Dict[str, Any]]:
        """The root frame's stats, signal/error powers turned into
        ``snr_db``; scopes and stats in sorted order, as the reference's
        step returns them (a pytree)."""
        if len(self.frames) != 1:
            raise RuntimeError("unbalanced numerics frames")
        return {scope: dict(sorted(stats.items())) for scope, stats in
                sorted(_with_snr(self.frames[0].resolve()).items())}


def _with_snr(scopes):
    for stats in scopes.values():
        if "sig_pow" in stats and "err_pow" in stats:
            sig, err = stats["sig_pow"], stats["err_pow"]
            stats["snr_db"] = 10.0 * torch.log10(
                (sig + 1e-30) / (err + 1e-30))
    return scopes


_tls = threading.local()


def _current() -> Optional[Collector]:
    return getattr(_tls, "collector", None)


def active() -> bool:
    """A collector is installed on this thread."""
    return _current() is not None


@contextlib.contextmanager
def collecting():
    """Install a Collector for the duration of one step."""
    prev = _current()
    col = Collector()
    _tls.collector = col
    try:
        yield col
    finally:
        _tls.collector = prev


@contextlib.contextmanager
def suspended():
    """Within it, taps are skipped and counted in the collector's
    ``skipped`` (a recompute segment's forward run again in the
    backward: its values were tapped in the forward already)."""
    col = _current()
    if col is None:
        yield
        return
    col.suspended += 1
    try:
        yield
    finally:
        col.suspended -= 1


class _FrameHandle:
    __slots__ = ("stats",)

    def __init__(self):
        self.stats: Dict[str, Dict[str, Any]] = {}


@contextlib.contextmanager
def frame():
    """Open a nested frame; on exit its resolved stats land on the
    handle (``{}`` when no collector is installed)."""
    h = _FrameHandle()
    col = _current()
    if col is None:
        yield h
        return
    col.push_frame()
    try:
        yield h
    finally:
        h.stats = col.pop_frame()


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

def _tap(scope: str, name: str, value):
    col = _current()
    if col is None:
        return
    if col.suspended:
        col.skipped += 1
        return
    col.frames[-1].add(scope, name, value)


def tap_stats(scope: str, **stats):
    """Record raw stat values under ``scope``."""
    for name, value in stats.items():
        _tap(scope, name, value)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def leaf_parts(x: torch.Tensor):
    """One float tensor's share of `tree_stats`: ([sum of squares,
    absmax] fp32, [nonfinite, underflow, overflow, finite, finite
    nonzero] counts int64, numel), with no graph."""
    ref = x.dtype if x.dtype in (torch.bfloat16, torch.float16) \
        else torch.bfloat16
    fi = torch.finfo(ref)
    # the underflow band sits a margin above the smallest normal (2^8
    # for 8-bit exponents, 2^2 for fp16's 5-bit one), so it is visited
    # before values flush to zero
    margin = 4.0 if ref == torch.float16 else 256.0
    tiny, fmax = float(fi.tiny) * margin, float(fi.max)
    with torch.no_grad():
        a = x.detach().float().abs()
        finite = torch.isfinite(a)
        af = torch.where(finite, a, 0.0)
        live = finite & (a > 0)
        sums = torch.stack([(af * af).sum(),
                            af.amax() if af.numel() else af.sum()])
        counts = torch.stack([(~finite).sum(), (live & (a < tiny)).sum(),
                              (finite & (a > fmax)).sum(), finite.sum(),
                              live.sum()])
    return sums, counts, x.numel()


def stats_of_parts(parts) -> Dict[str, Any]:
    """`tree_stats` from its leaves' `leaf_parts` (on the first leaf's
    device)."""
    if not parts:
        return {}
    dev = parts[0][0].device
    with torch.no_grad():
        s = torch.stack([p[0].to(dev) for p in parts])
        nonfinite, under, over, n_finite, n_nonzero = torch.stack(
            [p[1].to(dev) for p in parts]).sum(0)
        sum_sq, n = s[:, 0].sum(), sum(p[2] for p in parts)
        # underflow over finite nonzero values, overflow over finite ones
        return {
            "absmax": s[:, 1].amax(),
            "rms": torch.sqrt(sum_sq / max(n, 1)),
            "l2": torch.sqrt(sum_sq),
            "nonfinite": nonfinite,
            "underflow_frac": (under.float()
                               / torch.clamp_min(n_nonzero, 1).float()),
            "overflow_frac": (over.float()
                              / torch.clamp_min(n_finite, 1).float()),
        }


def tree_stats(tree) -> Dict[str, Any]:
    """Statistics over the float tensors of a tree (a tensor, or dicts,
    lists and tuples of them): absmax / rms / l2 / nonfinite count /
    underflow and overflow fractions (module docstring), as 0-d tensors
    on the first leaf's device, with no graph.  Usable anywhere."""
    return stats_of_parts([leaf_parts(x) for x in _leaves(tree)
                           if torch.is_tensor(x) and x.is_floating_point()])


def tap_tree(scope: str, tree):
    """Tap the full tensor-stat set of a tree under ``scope``; computes
    nothing unless a collector is installed and taking taps."""
    col = _current()
    if col is None:
        return
    if col.suspended:
        col.skipped += len(TREE_STATS)
        return
    for name, value in tree_stats(tree).items():
        _tap(scope, name, value)


def tap_quant_error(scope: str, signal, error):
    """Accumulate one quantize site's signal and error powers under
    ``scope`` (``finalize`` turns them into ``snr_db``); ``error`` is
    the site's own residual x - dequantize(quantize(x))."""
    if not active():
        return
    with torch.no_grad():
        s, e = signal.detach().float(), error.detach().float()
        _tap(scope, "sig_pow", (s * s).sum())
        _tap(scope, "err_pow", (e * e).sum())


def tap_quant_roundtrip(scope: str, x, mode: str,
                        block_size: Optional[int] = None):
    """SNR probe for a site that cannot expose its (q, scales) pair:
    the blockwise quantize -> dequantize roundtrip of ``x`` (zero-padded
    to the block) with the port's kernels ("int4*" modes: 4 bits, else
    8), its powers accumulated."""
    if not active():
        return
    from hetu_tpu_torch.ops.cuda.quant import (dequantize_blockwise,
                                               quantize_blockwise)
    bs = block_size or DEFAULT_BLOCK
    with torch.no_grad():
        flat = x.detach().reshape(-1).float()
        pad = (-flat.shape[0]) % bs
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        q, s = quantize_blockwise(flat, bs,
                                  bits=4 if mode.startswith("int4") else 8,
                                  device=flat.device)
        tap_quant_error(scope, flat, flat - dequantize_blockwise(
            q, s, device=flat.device))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def reduce_stacked(scopes: Dict[str, Dict[str, Any]]
                   ) -> Dict[str, Dict[str, Any]]:
    """Fold a stats tree whose values are stacked along a leading axis
    (per micro-batch) by each stat's rule."""
    fold = {"max": lambda v: v.amax(0), "sum": lambda v: v.sum(0),
            "mean": lambda v: v.mean(0)}
    return {scope: {name: fold[rule_for(name)](torch.as_tensor(v))
                    for name, v in stats.items()}
            for scope, stats in scopes.items()}


def stack(frames: List[Dict[str, Dict[str, Any]]]
          ) -> Dict[str, Dict[str, Any]]:
    """Per-micro-batch stats trees (one key set) -> one tree of values
    stacked along a leading axis, for `reduce_stacked`."""
    if not frames or not frames[0]:
        return {}
    return {scope: {name: torch.stack([torch.as_tensor(f[scope][name])
                                       for f in frames])
                    for name in stats}
            for scope, stats in frames[0].items()}


def merge(scopes: Dict[str, Dict[str, Any]]):
    """Fold a stats tree into the ambient collector's top frame."""
    if not scopes or not active():
        return
    for scope, stats in scopes.items():
        for name, v in stats.items():
            _tap(scope, name, v)


# ---------------------------------------------------------------------------
# host side: the one sink and the one reader
# ---------------------------------------------------------------------------

def _jsonable_scopes(scopes) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for scope, stats in scopes.items():
        dst = out.setdefault(str(scope), {})
        for name, v in stats.items():
            a = (v.detach().cpu().numpy() if torch.is_tensor(v)
                 else np.asarray(v))
            dst[str(name)] = a.tolist() if a.ndim else float(a)
    return out


def record(scopes, *, step: int, registry,
           runlog=None) -> Optional[Dict[str, Any]]:
    """The one host sink for a step's stats (tensors or numbers): a
    schema-versioned ``numerics`` RunLog record and ``numerics.*``
    gauges (``moe.*`` for a MoE scope) in `registry`.  Returns the
    record, or None when there was nothing."""
    if not scopes:
        return None
    scopes = _jsonable_scopes(scopes)
    for scope, stats in scopes.items():
        for name, v in stats.items():
            if isinstance(v, list):
                for i, vi in enumerate(v):
                    registry.set_gauge(f"numerics.{name}", vi,
                                       scope=scope, index=str(i))
                continue
            registry.set_gauge(f"numerics.{name}", v, scope=scope)
            if name == "snr_db":
                registry.observe("numerics.snr_db_hist", v, scope=scope)
    moe = scopes.get("moe")
    if moe:
        if moe.get("dropped"):
            registry.inc("moe.capacity_dropped", float(moe["dropped"]))
        for i, vi in enumerate(moe.get("load") or []):
            registry.set_gauge("moe.expert_load", vi, expert=str(i))
        if moe.get("entropy") is not None:
            registry.set_gauge("moe.router_entropy", moe["entropy"])
    registry.inc("numerics.records")
    rec = {"kind": "numerics", "numerics_schema": NUMERICS_SCHEMA,
           "step": step, "scopes": scopes}
    if runlog is not None:
        rec = runlog.log("numerics", numerics_schema=NUMERICS_SCHEMA,
                         step=step, scopes=scopes)
    return rec


def summarize_numerics(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """The one reader over ``numerics`` RunLog records: ``{"records",
    "steps": [first, last], "scopes": {scope: {"last", "min_snr_db",
    "max_underflow_frac", "nonfinite", "taps"}}, "worst": [scope, ...]}``
    with ``worst`` most alarming first (non-finite counts, then the
    lowest SNR, then the highest underflow fraction)."""
    recs = [r for r in records if r.get("kind") == "numerics"]
    scopes: Dict[str, Dict[str, Any]] = {}
    steps: List[int] = []
    for r in recs:
        if r.get("step") is not None:
            steps.append(int(r["step"]))
        for scope, stats in (r.get("scopes") or {}).items():
            agg = scopes.setdefault(scope, {
                "last": {}, "min_snr_db": None,
                "max_underflow_frac": None, "nonfinite": 0, "taps": 0})
            agg["last"] = stats
            agg["taps"] += 1
            snr = stats.get("snr_db")
            if snr is not None and (agg["min_snr_db"] is None
                                    or snr < agg["min_snr_db"]):
                agg["min_snr_db"] = snr
            uf = stats.get("underflow_frac")
            if uf is not None and (agg["max_underflow_frac"] is None
                                   or uf > agg["max_underflow_frac"]):
                agg["max_underflow_frac"] = uf
            nf = stats.get("nonfinite")
            if nf:
                agg["nonfinite"] += int(nf)

    def badness(item):
        name, agg = item
        snr = agg["min_snr_db"]
        uf = agg["max_underflow_frac"] or 0.0
        return (-agg["nonfinite"],
                snr if snr is not None else math.inf,
                -uf, name)

    worst = [name for name, _ in sorted(scopes.items(), key=badness)]
    return {"records": len(recs),
            "steps": [min(steps), max(steps)] if steps else None,
            "scopes": scopes, "worst": worst}
