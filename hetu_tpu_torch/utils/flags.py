"""The port's env-flag registry, a trimmed copy of
`hetu_tpu/utils/flags.py` holding the flags the port reads, under the
`HETU_TORCH_` prefix (the port keeps its own copy so it never imports
the JAX package).  Types, defaults and parse errors are the reference's.

    from hetu_tpu_torch.utils import flags
    if flags.bool_flag("HETU_TORCH_HEALTH"): ...
    every = flags.int_flag("HETU_TORCH_NUMERICS_EVERY")
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    kind: str            # "bool" | "str" | "int"
    default: object
    doc: str


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
    return os.environ.get(name, _lookup(name).default)


def int_flag(name: str) -> int:
    f = _lookup(name)
    raw = os.environ.get(name)
    return int(raw) if raw else int(f.default)

