"""Data loaders: the port's copy of `hetu_tpu/data/dataloader.py`
(`DataLoader`, `build_data_loader`; reference: python/hetu/data/
dataloader.py:46 build_data_loader + SampleLevelBatchSampler :162, and
the C++ prefetching loader hetu/graph/data/dataloader.h:18).

A loader yields host numpy batches of the whole global batch, which the
`Trainer` splits into micro-batches and copies to the card.  The batch
order, shuffling (numpy's default_rng(seed + epoch)) and collation are
the reference's.  The prefetch thread differs in two places, both
where the reference's would wait forever: a consumer that stops
iterating part-way (a `Trainer.train(..., num_steps)` that ends before
the data does) stops the thread, and an exception raised while a batch
is collated (say a packing overflow under `on_overflow="error"`)
reaches the consumer instead of leaving it waiting for a batch that
never comes.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator

import numpy as np

from hetu_tpu_torch.data.data_collator import DataCollatorForLanguageModel

#: seconds a prefetch thread waits on a full queue before it checks
#: whether its consumer has stopped
_PUT_POLL_S = 0.05


class DataLoader:
    """Batches + collates a dataset; optional background prefetch thread
    (the reference's C++ prefetching loader becomes a host thread that
    keeps `prefetch` batches ready)."""

    def __init__(self, dataset, batch_size: int, collator,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collator = collator
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _index_iter(self, epoch: int) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        n_full = len(idx) // self.batch_size
        for b in range(n_full):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]
        if not self.drop_last and len(idx) % self.batch_size:
            yield idx[n_full * self.batch_size:]

    def _collate(self, seqs):
        # packing produces a data-dependent row count; pin it to
        # batch_size so every step sees ONE shape (underfilled rows are
        # all-pad and contribute no loss)
        if getattr(self.collator, "packing", False):
            return self.collator(seqs, num_rows=self.batch_size)
        return self.collator(seqs)

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for batch_idx in self._index_iter(epoch):
            yield self._collate([self.dataset[int(i)] for i in batch_idx])

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches(epoch)
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item`; False once the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_POLL_S)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self._batches(epoch):
                    if not put(("batch", batch)):
                        return
            except Exception as e:      # handed to the consumer, raised there
                put(("error", e))
                return
            put(("end", None))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "end":
                    break
                if kind == "error":
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def __iter__(self):
        return self.epoch(0)


def build_data_loader(dataset, batch_size: int, max_seq_len: int,
                      pad_id: int = 0, packing: bool = False,
                      shuffle: bool = True, seed: int = 0,
                      prefetch: int = 2) -> DataLoader:
    collator = DataCollatorForLanguageModel(max_seq_len, pad_id, packing)
    return DataLoader(dataset, batch_size, collator, shuffle=shuffle,
                      seed=seed, prefetch=prefetch)
