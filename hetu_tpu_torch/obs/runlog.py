"""Structured run-event log, the port of `hetu_tpu/obs/runlog.py`.

One JSONL record per event, append-only and flushed per record by
default, so a killed run's log is valid up to its last completed step.
The schema is the reference's, so its readers (`RunLog.read`,
`iter_records`, `summarize_numerics`, tools_obs_report.py) parse a
port log unchanged:

    {"schema": 1, "kind": "step", "t": <unix wall time>, ...kind fields}

The kinds the port's trainer writes, with the reference's fields:

    step      step, step_time_s, loss, tokens_per_s, device_mem_bytes,
              plan (the batch shapes)
    scaler    event (growth | backoff), scale, prev, step — one record
              per dynamic-loss-scale transition
    numerics  numerics_schema, step, scopes — {scope: {stat: value}}
              (obs/numerics.py), one per HETU_TORCH_NUMERICS_EVERY steps
    anomaly   anomaly (obs.health kinds), step, value, baseline
    fault     fault (ckpt_corrupt), step, detail — a checkpoint the
              restore walked past
    rotated   segment, records — the size-cap rotation marker
    summary   metrics (a MetricsRegistry snapshot)

With ``HETU_TORCH_RUNLOG_MAX_MB`` set (or ``max_bytes`` passed), a
segment that overflows the cap is closed with a ``rotated`` marker and
renamed to ``<path>.<n>`` (``<path>.1`` the oldest), and a fresh
segment opens at ``path``; ``iter_records``/``read`` follow the whole
chain in order.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from hetu_tpu_torch.utils import flags
from hetu_tpu_torch.utils.logging import get_logger

SCHEMA_VERSION = 1

#: field names every record carries (the reference's stability contract)
REQUIRED_FIELDS = ("schema", "kind", "t")


class RunLog:
    """Append-only JSONL run-event writer."""

    def __init__(self, path: str, flush_every: int = 1,
                 max_bytes: Optional[int] = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._flush_every = max(1, flush_every)
        self._since_flush = 0
        self.records_written = 0
        if max_bytes is None:
            mb = flags.int_flag("HETU_TORCH_RUNLOG_MAX_MB")
            max_bytes = mb * (1 << 20) if mb > 0 else None
        self._max_bytes = max_bytes
        try:
            self._bytes = os.path.getsize(path)
        except OSError:
            self._bytes = 0
        self.rotations = 0

    # ------------------------------------------------------------------
    def log(self, kind: str, **fields) -> Dict[str, Any]:
        rec = {"schema": SCHEMA_VERSION, "kind": kind, "t": time.time()}
        rec.update(fields)
        line = json.dumps(rec, default=_jsonable)
        with self._lock:
            if self._f.closed:
                return rec
            try:
                self._f.write(line + "\n")
                self._bytes += len(line) + 1
                self._since_flush += 1
                self.records_written += 1
                if self._since_flush >= self._flush_every:
                    self._f.flush()
                    self._since_flush = 0
                if self._max_bytes and self._bytes >= self._max_bytes:
                    self._rotate_locked()
            except OSError as e:
                # a full disk under the log disables the writer; the
                # training loop and its checkpoints carry on
                try:
                    self._f.close()
                except OSError:
                    pass
                get_logger("obs.runlog").warning(
                    f"run log write to {self.path} failed ({e!r}); "
                    "disabling run-event logging for this run")
        return rec

    def step(self, step: int, step_time_s: float, *,
             loss: Optional[float] = None,
             tokens_per_s: Optional[float] = None,
             device_mem_bytes: Optional[int] = None,
             plan: Optional[str] = None, **extra) -> Dict[str, Any]:
        return self.log("step", step=step, step_time_s=step_time_s,
                        loss=loss, tokens_per_s=tokens_per_s,
                        device_mem_bytes=device_mem_bytes, plan=plan,
                        **extra)

    def _rotate_locked(self):
        """Close the overflowing segment with a `rotated` marker, rename
        it to the next `<path>.<n>` and open a fresh segment at `path`.
        A rename failure disables rotation, not the log."""
        idx = _max_segment_index(self.path) + 1
        marker = {"schema": SCHEMA_VERSION, "kind": "rotated",
                  "t": time.time(), "segment": idx,
                  "records": self.records_written}
        try:
            self._f.write(json.dumps(marker) + "\n")
            self._f.flush()
            self._f.close()
            os.replace(self.path, f"{self.path}.{idx}")
            self._f = open(self.path, "a")
            self._bytes = 0
            self._since_flush = 0
            self.rotations += 1
        except OSError as e:
            get_logger("obs.runlog").warning(
                f"run log rotation of {self.path} failed ({e!r}); "
                "disabling rotation for this run")
            self._max_bytes = None
            if self._f.closed:
                self._f = open(self.path, "a")

    def close(self):
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        return list(RunLog.iter_records(path))

    @staticmethod
    def segments(path: str) -> List[str]:
        """All on-disk segments of a (possibly rotated) run log, oldest
        first: `<path>.1`, `<path>.2`, ..., then `path` itself."""
        out = [f"{path}.{n}" for n in _segment_indices(path)]
        if os.path.exists(path) or not out:
            out.append(path)
        return out

    @staticmethod
    def iter_records(path: str) -> Iterator[Dict[str, Any]]:
        """Records across all rotated segments in order, skipping torn
        trailing lines."""
        for seg in RunLog.segments(path):
            with open(seg) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("kind"):
                        yield rec


def _segment_indices(path: str) -> List[int]:
    """Sorted rotation indices n for which `<path>.<n>` exists."""
    d, base = os.path.split(path)
    pat = re.compile(re.escape(base) + r"\.(\d+)$")
    out = []
    try:
        for name in os.listdir(d or "."):
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
    except OSError:
        pass
    return sorted(out)


def _max_segment_index(path: str) -> int:
    idx = _segment_indices(path)
    return idx[-1] if idx else 0


def _jsonable(obj):
    """Fallback encoder: numpy scalars and 0-d tensors -> Python
    numbers (`item`), arrays -> lists (`tolist`), else str."""
    for attr in ("item", "tolist"):
        fn = getattr(obj, attr, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, ValueError, RuntimeError):
                pass
    return str(obj)


def default_runlog_path(ckpt_dir: Optional[str]) -> Optional[str]:
    """Where a trainer's run log goes: the HETU_TORCH_RUNLOG flag wins;
    else `runlog.jsonl` next to the checkpoints (local paths only);
    else no log."""
    explicit = flags.str_flag("HETU_TORCH_RUNLOG")
    if explicit:
        return explicit
    if ckpt_dir and "://" not in ckpt_dir:
        return os.path.join(ckpt_dir, "runlog.jsonl")
    return None
