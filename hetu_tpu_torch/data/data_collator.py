"""Batch collation: the port's copy of `hetu_tpu/data/data_collator.py`
(`DataCollatorForLanguageModel`, reference: python/hetu/data/
data_collator.py)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from hetu_tpu_torch.data.bucket import pad_batch, pack_sequences


class DataCollatorForLanguageModel:
    """Collate tokenized sequences into fixed-shape LM batches.

    packing=False: one sequence per row, padded (reference pad_data).
    packing=True: greedy first-fit packing (reference pack_data).
    """

    def __init__(self, max_seq_len: int, pad_id: int = 0, packing: bool = False):
        self.max_seq_len = max_seq_len
        self.pad_id = pad_id
        self.packing = packing

    def __call__(self, seqs: Sequence[np.ndarray],
                 num_rows: int | None = None) -> Dict[str, np.ndarray]:
        if self.packing:
            return pack_sequences(seqs, self.max_seq_len, self.pad_id,
                                  num_packed=num_rows)
        return pad_batch(seqs, self.max_seq_len, self.pad_id)
