"""Bucketing, padding and sequence packing: the port's copy of
`hetu_tpu/data/bucket.py` (host-only numpy; the port never imports the
JAX package).

The reference rebuilt the original system's data bucket (pad_data,
greedy pack_data, the head/tail-symmetric CP split) for a static-shape
world: every batch is padded or packed to a length from a fixed bucket
ladder.  Packing yields per-token `position_ids` (restarting at each
packed sequence) and `segment_ids` (the sequence index of each token, 0
for padding); the port's flash kernels and its dense attention both
mask attention across sequences by the segment ids, and the models take
the positions (RoPE rows, or learned positions).  The `cp_*` functions
split a batch along the sequence for context parallelism (the
multi-GPU slice runs them); here they are host arithmetic, held against
the reference's.  The split pattern is an argument, "sym" by default
(the reference's default; its `HETU_TPU_CP_SPLIT` flag arrives with the
multi-GPU slice, which calls these functions).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from hetu_tpu_torch.utils.logging import get_logger

DEFAULT_BUCKET_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def choose_bucket(length: int, buckets: Sequence[int] = DEFAULT_BUCKET_SIZES) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Bucket:
    """A batch of sequences padded/packed to one static length
    (reference: bucket.py:8 Bucket with pad_data/pack_data)."""

    max_seq_len: int
    pad_id: int = 0

    def __post_init__(self):
        self._seqs: List[np.ndarray] = []

    def add(self, ids: np.ndarray):
        self._seqs.append(np.asarray(ids, np.int32)[: self.max_seq_len])

    def __len__(self):
        return len(self._seqs)

    # -- padding mode (reference pad_data :67) ------------------------------
    def pad_batch(self) -> Dict[str, np.ndarray]:
        return pad_batch(self._seqs, self.max_seq_len, self.pad_id)

    # -- packing mode (reference pack_data :86) -----------------------------
    def pack_batch(self, num_packed: Optional[int] = None) -> Dict[str, np.ndarray]:
        return pack_sequences(self._seqs, self.max_seq_len, self.pad_id,
                              num_packed=num_packed)


def pad_batch(seqs: Sequence[np.ndarray], max_len: int, pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Pad each sequence to max_len. labels = ids with pads masked to -100."""
    n = len(seqs)
    ids = np.full((n, max_len), pad_id, np.int32)
    labels = np.full((n, max_len), -100, np.int32)
    position_ids = np.zeros((n, max_len), np.int32)
    segment_ids = np.zeros((n, max_len), np.int32)
    for i, s in enumerate(seqs):
        L = min(len(s), max_len)
        ids[i, :L] = s[:L]
        labels[i, :L] = s[:L]
        position_ids[i, :L] = np.arange(L)
        segment_ids[i, :L] = 1
    return {"input_ids": ids, "labels": labels,
            "position_ids": position_ids, "segment_ids": segment_ids}


def pack_sequences(seqs: Sequence[np.ndarray], max_len: int, pad_id: int = 0,
                   num_packed: Optional[int] = None,
                   on_overflow: str = "warn") -> Dict[str, np.ndarray]:
    """Greedy first-fit packing into rows of length max_len
    (reference: bucket.py:86 pack_data).  Returns ids/labels/position_ids/
    segment_ids; segment 0 = padding, packed sequences are 1-indexed.

    When `num_packed` caps the row count, overflow rows are dropped;
    on_overflow: "warn" logs the loss, "error" raises, "silent" drops."""
    order = np.argsort([-len(s) for s in seqs], kind="stable")
    rows: List[List[np.ndarray]] = []
    used: List[int] = []
    for idx in order:
        s = seqs[idx]
        L = len(s)
        placed = False
        for r in range(len(rows)):
            if used[r] + L <= max_len:
                rows[r].append(s)
                used[r] += L
                placed = True
                break
        if not placed:
            rows.append([s])
            used.append(min(L, max_len))
    if num_packed is not None:
        while len(rows) < num_packed:
            rows.append([])
            used.append(0)
        if len(rows) > num_packed:
            dropped = sum(len(s) for row in rows[num_packed:] for s in row)
            if on_overflow == "error":
                raise ValueError(
                    f"packing overflow: {len(rows) - num_packed} rows "
                    f"({dropped} tokens) do not fit in num_packed={num_packed}")
            if on_overflow == "warn":
                get_logger("data").warning(
                    f"packing dropped {dropped} tokens "
                    f"({len(rows) - num_packed} overflow rows)")
        rows = rows[:num_packed]

    n = len(rows)
    ids = np.full((n, max_len), pad_id, np.int32)
    labels = np.full((n, max_len), -100, np.int32)
    position_ids = np.zeros((n, max_len), np.int32)
    segment_ids = np.zeros((n, max_len), np.int32)
    for r, row in enumerate(rows):
        off = 0
        for j, s in enumerate(row):
            L = min(len(s), max_len - off)
            ids[r, off:off + L] = s[:L]
            labels[r, off:off + L] = s[:L]
            position_ids[r, off:off + L] = np.arange(L)
            segment_ids[r, off:off + L] = j + 1
            # first token of each sequence can't be predicted from the
            # previous sequence: mask its label
            labels[r, off] = -100
            off += L
    return {"input_ids": ids, "labels": labels,
            "position_ids": position_ids, "segment_ids": segment_ids}


def stripe_granularity(seq: int, cp: int):
    """The stripe split's block granularity: finest g = seq/(cp*m) giving
    every rank >= 2 blocks (m from cp down to 2), or None if none divides.
    ONE rule shared by the data split below and the ring's static step
    masks (parallel/ring_attention.ring_step_masks) — drift between the two
    would make the masks skip live tiles."""
    for m in range(cp, 1, -1):
        if seq % (cp * m) == 0:
            return seq // (cp * m)
    return None


def cp_split_batch(batch: Dict[str, np.ndarray], cp: int,
                   split: str = "sym") -> List[Dict[str, np.ndarray]]:
    """Split a packed/padded batch along seq into per-CP-rank slices
    (reference: bucket.py:193 generate_cp_pack_data + the ring's
    HETU_PARALLEL_ATTN_SPLIT=NORMAL|STRIPE|SYM modes,
    ParallelAttention.cc:196-204):

      sym    — of 2*cp equal chunks, rank r owns chunks r and 2*cp-1-r
               (head+tail symmetric; balanced causal work)
      stripe — round-robin token-block striping (chunk i -> rank i % cp)
      normal — contiguous chunks (rank r owns chunk r; causal-imbalanced)

    Returns a list of cp dicts, each with seq_len = total/cp.  Causality
    under any split is preserved by the ring kernel's position-based masks
    (feed the original position_ids through)."""
    seq = batch["input_ids"].shape[1]
    if split == "sym":
        assert seq % (2 * cp) == 0, f"seq {seq} must divide by 2*cp={2*cp}"
        chunk = seq // (2 * cp)
        owner = [(r * chunk, (2 * cp - 1 - r) * chunk) for r in range(cp)]
        idx = [np.concatenate([np.arange(lo, lo + chunk),
                               np.arange(hi, hi + chunk)])
               for lo, hi in owner]
    elif split == "stripe":
        assert seq % cp == 0, f"seq {seq} must divide by cp={cp}"
        g = stripe_granularity(seq, cp)
        if g is None:
            raise ValueError(
                f"stripe split needs seq ({seq}) divisible by cp*m for some "
                f"m >= 2 (cp={cp}); use split='sym' or 'normal'")
        blocks = [np.arange(i * g, (i + 1) * g) for i in range(seq // g)]
        idx = [np.concatenate(blocks[r::cp]) for r in range(cp)]
    elif split == "normal":
        assert seq % cp == 0, f"seq {seq} must divide by cp={cp}"
        chunk = seq // cp
        idx = [np.arange(r * chunk, (r + 1) * chunk) for r in range(cp)]
    else:
        raise ValueError(f"split must be sym|stripe|normal, got {split!r}")
    out = []
    for r in range(cp):
        out.append({k: v[:, idx[r]] for k, v in batch.items()})
    return out


def cp_split_uneven(batch: Dict[str, np.ndarray], lengths: Sequence[int],
                    align: int = 1, pad_id: int = 0) -> Dict[str, np.ndarray]:
    """Heterogeneous-CP split: ring rank r owns `lengths[r]` VALID tokens.

    The reference runs hetero CP rings whose members hold unequal seq shards
    (reference: hetu/graph/ops/ParallelAttention.cc:949-1050 hetero ring with
    per-rank valid lens).  XLA's even-sharding world realizes that as equal
    PHYSICAL shards with per-rank valid prefixes: each rank's region is
    padded to the common width s_max, pads carry segment 0 (masked from all
    valid tokens by the kernel's segment machinery) and label -100.

    Input batch: the usual padded/packed dict over a compact seq of
    sum(lengths) tokens.  Output: same dict re-laid-out to seq = cp*s_max so
    a plain cp sharding of the seq dim gives rank r exactly its tokens —
    run it through the normal ring path, no special casing.
    """
    cp = len(lengths)
    seq = batch["input_ids"].shape[1]
    if sum(lengths) != seq:
        raise ValueError(f"lengths {list(lengths)} must sum to seq {seq}")
    s_max = max(lengths)
    s_max = -(-s_max // align) * align
    starts = np.cumsum([0] + list(lengths[:-1]))
    out = {}
    for key, v in batch.items():
        fill = -100 if key == "labels" else (
            pad_id if key == "input_ids" else 0)
        arr = np.full((v.shape[0], cp * s_max), fill, v.dtype)
        for r, (st0, L) in enumerate(zip(starts, lengths)):
            arr[:, r * s_max:r * s_max + L] = v[:, st0:st0 + L]
        out[key] = arr
    return out


def merge_cp_uneven(batch: Dict[str, np.ndarray], lengths: Sequence[int]
                    ) -> Dict[str, np.ndarray]:
    """Inverse of cp_split_uneven: drop per-rank pads, re-compact the seq."""
    cp = len(lengths)
    s_max = batch["input_ids"].shape[1] // cp
    keep = np.concatenate([np.arange(r * s_max, r * s_max + L)
                           for r, L in enumerate(lengths)])
    return {k: v[:, keep] for k, v in batch.items()}


def cp_split_indices(seq: int, cp: int, split: str = "sym") -> List[np.ndarray]:
    """The global token indices each cp rank owns (for reassembly/tests)."""
    dummy = {"input_ids": np.arange(seq)[None, :]}
    return [s["input_ids"][0] for s in cp_split_batch(dummy, cp, split)]


def merge_cp_batch(shards: List[Dict[str, np.ndarray]],
                   split: str = "sym") -> Dict[str, np.ndarray]:
    """Inverse of cp_split_batch (for tests / unsharded eval)."""
    cp = len(shards)
    seq = sum(s["input_ids"].shape[1] for s in shards)
    idx = cp_split_indices(seq, cp, split)
    merged = {}
    for k in shards[0]:
        total = np.zeros((shards[0][k].shape[0], seq), shards[0][k].dtype)
        for r, sh in enumerate(shards):
            total[:, idx[r]] = sh[k]
        merged[k] = total
    return merged
