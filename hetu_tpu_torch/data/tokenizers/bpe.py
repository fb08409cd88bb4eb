"""Byte-level BPE tokenizer, self-contained (train / save / load / encode /
decode — no network, no external tokenizer runtime).

Rebuild of the reference's vendored GPT2 BPE stack (reference: python/hetu/
data/tokenizers/ gpt2_tokenization.py semantics): byte-level pre-tokenization
(every byte representable, no <unk>), greedy merge application by learned
rank, optional special tokens.  File format matches the public GPT-2
convention — `vocab.json` (token -> id) + `merges.txt` (one merge pair per
line) — so pretrained GPT-2 vocabularies drop in unchanged.

The port's copy of `hetu_tpu/data/tokenizers/bpe.py`, unchanged but for its
imports (host code: the port never imports the JAX package).
"""
from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

try:                  # the GPT-2 split pattern needs unicode properties
    import regex as _re
    _PAT = _re.compile(
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
except ImportError:   # degraded but functional split
    import re as _re
    _PAT = _re.compile(r" ?\w+| ?[^\w\s]+|\s+")


def bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte <-> printable-unicode table (public GPT-2
    convention): printable ASCII/latin bytes map to themselves, the rest to
    256+ offsets, so merges.txt stays human-readable and lossless."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_B2U = bytes_to_unicode()
_U2B = {u: b for b, u in _B2U.items()}


def _word_to_units(word: str) -> Tuple[str, ...]:
    return tuple(_B2U[b] for b in word.encode("utf-8"))


class ByteLevelBPETokenizer:
    """encode/decode with learned merges.

    vocab: unit-string -> id; merges: list of (a, b) in learned order."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 special_tokens: Optional[Sequence[str]] = None):
        self.vocab = dict(vocab)
        self.merges = list(merges)
        self.ranks = {tuple(m): i for i, m in enumerate(self.merges)}
        self.special_tokens = list(special_tokens or [])
        for tok in self.special_tokens:
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self._cache: Dict[str, List[str]] = {}

    # -- core BPE -----------------------------------------------------------
    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        units = list(_word_to_units(word))
        while len(units) > 1:
            cand = [(self.ranks.get((a, b)), i) for i, (a, b) in
                    enumerate(zip(units[:-1], units[1:]))]
            cand = [(r, i) for r, i in cand if r is not None]
            if not cand:
                break
            _, i = min(cand)
            units[i:i + 2] = [units[i] + units[i + 1]]
        self._cache[word] = units
        return units

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for word in _PAT.findall(text):
            for unit in self._bpe(word):
                if unit in self.vocab:
                    out.append(self.vocab[unit])
                else:  # unseen unit: fall back to per-byte units
                    out.extend(self.vocab[u] for u in unit)
        return out

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.inv_vocab[i] for i in ids
                       if i in self.inv_vocab
                       and self.inv_vocab[i] not in self.special_tokens)
        data = bytes(_U2B[u] for u in text)
        return data.decode("utf-8", errors="replace")

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- training (reference trains offline; kept in-tree so tests and small
    # runs need no downloaded vocab) ---------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 1024,
              special_tokens: Sequence[str] = ("<|endoftext|>",)
              ) -> "ByteLevelBPETokenizer":
        """Classic BPE: start from the 256 byte units, repeatedly merge the
        most frequent adjacent pair until vocab_size.

        Incremental: pair counts are adjusted only where a merge touches
        (with a pair->words index and a lazy max-heap for the argmax), so a
        merge costs O(occurrences), not O(corpus) — real vocab sizes train
        in seconds, not hours."""
        import heapq

        word_freq: Counter = Counter()
        for t in texts:
            word_freq.update(_PAT.findall(t))
        words = {w: list(_word_to_units(w)) for w in word_freq}

        pair_freq: Counter = Counter()
        pair_words: Dict[Tuple[str, str], set] = {}
        for w, units in words.items():
            f = word_freq[w]
            for p in zip(units[:-1], units[1:]):
                pair_freq[p] += f
                pair_words.setdefault(p, set()).add(w)

        heap = [(-c, p) for p, c in pair_freq.items()]
        heapq.heapify(heap)

        def bump(p, delta, w):
            pair_freq[p] += delta
            if delta > 0:
                pair_words.setdefault(p, set()).add(w)
                heapq.heappush(heap, (-pair_freq[p], p))

        vocab: Dict[str, int] = {u: i for i, u in
                                 enumerate(sorted(_B2U.values()))}
        merges: List[Tuple[str, str]] = []
        target = vocab_size - len(special_tokens)
        while len(vocab) < target and heap:
            # lazy heap: pop until the entry matches the live count
            neg, pair = heapq.heappop(heap)
            cnt = pair_freq.get(pair, 0)
            if -neg != cnt:
                if cnt > 0:
                    heapq.heappush(heap, (-cnt, pair))
                continue
            if cnt < 2:
                break
            a, b = pair
            ab = a + b
            merges.append(pair)
            vocab[ab] = len(vocab)
            # apply the merge only where it occurs, adjusting neighbors
            for w in pair_words.pop(pair, ()):
                units = words[w]
                f = word_freq[w]
                i = 0
                while i < len(units) - 1:
                    if units[i] != a or units[i + 1] != b:
                        i += 1
                        continue
                    if i > 0:
                        bump((units[i - 1], a), -f, w)
                        bump((units[i - 1], ab), f, w)
                    if i + 2 < len(units):
                        bump((b, units[i + 2]), -f, w)
                        bump((ab, units[i + 2]), f, w)
                    units[i:i + 2] = [ab]
            del pair_freq[pair]
        return cls(vocab, merges, special_tokens)

    # -- GPT-2 file format --------------------------------------------------
    def save(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "vocab.json"), "w") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(os.path.join(directory, "merges.txt"), "w") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")

    @classmethod
    def load(cls, directory: str,
             special_tokens: Sequence[str] = ("<|endoftext|>",)
             ) -> "ByteLevelBPETokenizer":
        with open(os.path.join(directory, "vocab.json")) as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(os.path.join(directory, "merges.txt")) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        # pass requested specials through unchanged: __init__ appends any
        # that are missing from the vocab and keeps existing ids for the rest
        return cls(vocab, merges, list(special_tokens))
