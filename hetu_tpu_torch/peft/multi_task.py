"""Multi-task LoRA batch scheduling, quota planning and training, the
port of `hetu_tpu/peft/multi_task.py` (the LoBRA trainer layer: greedy
max-tokens micro-batching with per-task row spans and cross-task fusion
of leftovers; a weighted-fair per-round quota planner).

Micro batches are [rows, seq+1] int32 blocks from a bucket ladder, rows
grouped per task; each micro carries `batch_offset_list` /
`batch_size_list` so the engine runs each task's contiguous row span
through that task's adapters.  `schedule_micro_batches`, `MicroBatch`
and `TaskQuotaPlanner` are the reference's host code, copied.
`MultiTaskSFTEngine` runs one task's span at a time through its
adapters (`MultiLoRAManager.forward`) and applies AdamW (or any port
optimizer with `init(leaves)` / `update(grads, state, leaves)`) to that
task's adapter leaves alone: one launch a task span.  The reference
keeps one compiled plan per micro shape in a plan pool; eager PyTorch
has none to keep (the plan pool is ROADMAP Queue A item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hetu_tpu_torch.data.bucket import choose_bucket


@dataclasses.dataclass
class MicroBatch:
    """One static-shaped training micro: rows from >=1 tasks.

    data: [batch_size, seq_length + 1] int32 (inputs = [:, :-1], labels =
    [:, 1:] with positions past each row's `valid_lens` entry to be masked
    to -100 — see labels()).
    batch_offset_list/batch_size_list: per-task contiguous row spans
    (reference: batch_scheduler.MicroBatch)."""
    data: np.ndarray
    batch_size: int
    seq_length: int
    batch_offset_list: List[int]
    batch_size_list: List[int]
    valid_lens: np.ndarray   # [batch_size] true token counts per row

    def token_num(self) -> int:
        return self.batch_size * self.seq_length

    def task_ids(self) -> List[int]:
        return [t for t, b in enumerate(self.batch_size_list) if b > 0]

    def _span(self, task: int) -> slice:
        off = self.batch_offset_list[task]
        return slice(off, off + self.batch_size_list[task])

    def task_rows(self, task: int) -> np.ndarray:
        return self.data[self._span(task)]

    def task_inputs(self, task: int) -> np.ndarray:
        return self.data[self._span(task), :-1]

    def task_labels(self, task: int) -> np.ndarray:
        """Pre-shifted next-token targets with pad positions masked to
        -100: target column j = data[:, j+1], valid while j+1 < valid_len
        (pad_id cannot be used as the mask — 0 may be a real token)."""
        rows = self.data[self._span(task), 1:].astype(np.int32)
        lens = self.valid_lens[self._span(task)]
        cols = np.arange(rows.shape[1])[None, :]
        return np.where(cols + 1 < lens[:, None], rows, -100)


def _bucket_len(n: int, bucket_sizes: Sequence[int]) -> int:
    """Strict choose_bucket (`data.bucket.choose_bucket` clamps to the
    largest rung; the scheduler must reject oversize samples instead —
    a silently truncated sample would train on garbage)."""
    b = choose_bucket(n, tuple(bucket_sizes))
    if n > b:
        raise ValueError(f"sample of length {n} exceeds the largest bucket "
                         f"{bucket_sizes[-1]}")
    return b


def schedule_micro_batches(task_samples: Dict[int, List[np.ndarray]],
                           max_tokens: int, train_task_num: int,
                           bucket_sizes: Sequence[int], pad_id: int = 0,
                           fuse_leftovers: bool = True) -> List[MicroBatch]:
    """Greedy max-tokens scheduler (reference: greedy_local_batch_scheduler).

    Per task: samples are bucketed by length, and each bucket emits micros
    of `max_tokens // seq` rows.  Partially-filled leftovers are FUSED
    across tasks at the same bucket length into one micro with per-task
    row spans (fuse_leftovers=False keeps them single-task, padded).
    Every sample is scheduled exactly once."""
    bucket_sizes = sorted(bucket_sizes)
    # task -> seq_bucket -> list of (padded row [seq+1], valid token count)
    grouped: Dict[int, Dict[int, List[tuple]]] = {}
    for task, samples in task_samples.items():
        for s in samples:
            s = np.asarray(s, np.int32)
            b = _bucket_len(max(len(s) - 1, 1), bucket_sizes)
            row = np.full((b + 1,), pad_id, np.int32)
            row[:len(s)] = s
            grouped.setdefault(task, {}).setdefault(b, []).append(
                (row, len(s)))

    def make(items, seq, offs, sizes):
        rows = np.stack([r for r, _ in items])
        lens = np.asarray([v for _, v in items], np.int32)
        return MicroBatch(rows, len(items), seq, offs, sizes, lens)

    micros: List[MicroBatch] = []
    leftovers: Dict[int, List[tuple]] = {}   # seq -> [(task, items)]
    for task in sorted(grouped):
        for seq in sorted(grouped[task]):
            items = grouped[task][seq]
            cap = max(max_tokens // seq, 1)
            while len(items) >= cap:
                take, items = items[:cap], items[cap:]
                offs = [0] * train_task_num
                sizes = [0] * train_task_num
                sizes[task] = cap
                micros.append(make(take, seq, offs, sizes))
            if items:
                leftovers.setdefault(seq, []).append((task, items))

    for seq in sorted(leftovers):
        parts = leftovers[seq]
        cap = max(max_tokens // seq, 1)
        if not fuse_leftovers:
            for task, items in parts:
                offs = [0] * train_task_num
                sizes = [0] * train_task_num
                sizes[task] = len(items)
                micros.append(make(items, seq, offs, sizes))
            continue
        # fuse across tasks, first-fit into <=cap-row micros; rows of one
        # task stay contiguous so the engine slices one span per task
        cur: List[tuple] = []
        cur_rows = 0

        def flush():
            if not cur:
                return
            offs = [0] * train_task_num
            sizes = [0] * train_task_num
            data = []
            off = 0
            for task, items in cur:
                offs[task] = off
                sizes[task] = len(items)
                off += len(items)
                data.extend(items)
            micros.append(make(data, seq, offs, sizes))

        for task, items in sorted(parts, key=lambda p: -len(p[1])):
            while items:
                room = cap - cur_rows
                if room == 0:
                    flush()
                    cur, cur_rows = [], 0
                    room = cap
                take, items = items[:room], items[room:]
                cur.append((task, take))
                cur_rows += len(take)
        flush()
    return micros


@dataclasses.dataclass
class TaskQuotaPlanner:
    """Per-round task quotas: weighted-fair over backlog (the planner.py
    essence — LoBRA allocates per-task resources each round from priority
    and pending work; the full ILP degenerates to weighted-proportional
    shares when every task runs on the same mesh)."""
    weights: Dict[int, float]
    round_tokens: int

    def plan(self, backlog_tokens: Dict[int, int]) -> Dict[int, int]:
        """backlog (pending tokens per task) -> this round's token quota.
        Work-conserving: unused share of drained tasks is redistributed."""
        active = {t: b for t, b in backlog_tokens.items() if b > 0}
        quotas = {t: 0 for t in backlog_tokens}
        remaining = self.round_tokens
        while active and remaining > 0:
            wsum = sum(self.weights.get(t, 1.0) for t in active)
            gave = 0
            for t in sorted(active):
                share = int(remaining * self.weights.get(t, 1.0) / wsum)
                share = min(share, active[t])
                quotas[t] += share
                active[t] -= share
                gave += share
            if gave == 0:   # shares rounded to 0: give the rest to one task
                t = max(active, key=lambda t: self.weights.get(t, 1.0))
                share = min(remaining, active[t])
                quotas[t] += share
                gave = share
            remaining -= gave
            active = {t: b for t, b in active.items() if b > 0}
        return quotas


class MultiTaskSFTEngine:
    """Drive a `MultiLoRAManager` with scheduled micros: each task span
    of a micro through that task's adapters, and `optimizer` over that
    task's adapter leaves alone (the reference's lobra train loop).

    loss_fn(manager, task, ids, labels) -> the mean loss; labels are
    pre-shifted next-token targets with pads masked to -100
    (`MicroBatch.task_labels`).  Default: the base model's own loss with
    `labels_shifted=True`."""

    def __init__(self, manager, optimizer,
                 loss_fn: Optional[Callable] = None):
        self.manager = manager
        self.optimizer = optimizer
        self.opt_states = {t: optimizer.init(manager.parameters(t))
                           for t in manager.tasks()}
        self._loss_fn = loss_fn or (
            lambda mgr, task, ids, labels: mgr.forward(
                task, ids, labels, labels_shifted=True))

    def train_micro(self, micro: MicroBatch) -> Dict[int, float]:
        """Run every task span in the micro; returns task -> mean loss."""
        mgr = self.manager
        tasks = mgr.tasks()
        device = mgr.base_model.device
        out: Dict[int, float] = {}
        for tid in micro.task_ids():
            task = tasks[tid]
            ids = torch.from_numpy(micro.task_inputs(tid)).to(device)
            labels = torch.from_numpy(micro.task_labels(tid)).to(device)
            leaves = mgr.parameters(task)
            loss = self._loss_fn(mgr, task, ids, labels)
            grads = torch.autograd.grad(loss, leaves)
            self.optimizer.update(list(grads), self.opt_states[task],
                                  leaves)
            out[tid] = float(loss.detach())
        return out

    def train(self, micros: Sequence[MicroBatch]) -> Dict[int, List[float]]:
        hist: Dict[int, List[float]] = {}
        for m in micros:
            for tid, loss in self.train_micro(m).items():
                hist.setdefault(tid, []).append(loss)
        return hist
