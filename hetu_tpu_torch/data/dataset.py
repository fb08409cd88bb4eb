"""Datasets: the port's copy of `hetu_tpu/data/dataset.py`
(`JsonDataset`, `TokenizedDataset`; reference: python/hetu/data/
dataset.py and the tokenizer stack data/tokenizers/).

Tokenizers: any object with an `encode(str) -> list[int]` method works.
The in-tree stack is `hetu_tpu_torch.data.tokenizers`
(ByteLevelBPETokenizer — dependency-free train/save/load, GPT-2 file
format — plus SentencePiece and tiktoken loaders and the explicit
HFTokenizer delegate).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


class JsonDataset:
    """Reads .json/.jsonl with a text field and tokenizes lazily."""

    def __init__(self, path: str, tokenizer, key: str = "text",
                 max_seq_len: Optional[int] = None, append_eos: bool = True,
                 eos_id: Optional[int] = None):
        self.path = path
        self.tokenizer = tokenizer
        self.key = key
        self.max_seq_len = max_seq_len
        self.append_eos = append_eos
        self.eos_id = eos_id if eos_id is not None else getattr(
            tokenizer, "eos_token_id", None)
        self._texts: List[str] = []
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                for item in json.load(f):
                    self._texts.append(item[key] if isinstance(item, dict) else item)
            else:
                for line in f:
                    line = line.strip()
                    if line:
                        item = json.loads(line)
                        self._texts.append(item[key] if isinstance(item, dict) else item)

    def __len__(self):
        return len(self._texts)

    def __getitem__(self, i: int) -> np.ndarray:
        ids = list(self.tokenizer.encode(self._texts[i]))
        if self.append_eos and self.eos_id is not None:
            ids.append(self.eos_id)
        if self.max_seq_len:
            ids = ids[: self.max_seq_len]
        return np.asarray(ids, np.int32)


class TokenizedDataset:
    """Pre-tokenized sequences (list of int arrays) — used by tests and by
    synthetic-data benchmarks."""

    def __init__(self, seqs: Sequence[np.ndarray]):
        self._seqs = [np.asarray(s, np.int32) for s in seqs]

    @staticmethod
    def synthetic(num: int, vocab: int, min_len: int, max_len: int,
                  seed: int = 0) -> "TokenizedDataset":
        rng = np.random.default_rng(seed)
        seqs = [rng.integers(0, vocab, size=rng.integers(min_len, max_len + 1))
                for _ in range(num)]
        return TokenizedDataset(seqs)

    def __len__(self):
        return len(self._seqs)

    def __getitem__(self, i: int) -> np.ndarray:
        return self._seqs[i]
