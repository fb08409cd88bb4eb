"""Speculative decoding, the port of `hetu_tpu/serving/spec_decode.py`
(host code, copied): draft k tokens a slot on the host, verify k + 1 in
one batched forward.

A decode step reads every weight once however many tokens it emits; a
drafter proposes k tokens a slot and ONE verify forward
(`models/generation.verify_step_paged`) scores all k + 1 positions.

**Acceptance = sample-then-match.**  At each verify position the engine
computes the token the sequential path would have emitted there —
argmax for greedy rows, the seeded sampler with that position's own key
for sampling rows — and accepts drafts while they match.  For a
deterministic drafter this is exactly the speculative rejection rule,
and because the per-position keys are the sequential path's, sampled
output is token-identical to decoding without speculation.

`NGramDrafter` is the model-free drafter (prompt-lookup decoding):
match the longest recent n-gram earlier in the sequence and replay what
followed it.  The model drafter and its stochastic p/q verify rule
arrive with the third serving slice (ROADMAP Queue A item 3).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

_SERVING_3 = "the third serving slice (ROADMAP Queue A item 3)"


class Drafter:
    """Host-side draft proposer interface."""

    #: how many trailing context tokens `propose` reads; the engine
    #: slices the sequence to this before calling (None = the whole
    #: history), so drafting stays O(window) a step
    window: Optional[int] = None

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        """Propose k draft continuations of `tokens` (the trailing
        `window` of prompt + generated so far).  Must return exactly k
        token ids."""
        raise NotImplementedError


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: find the most recent earlier occurrence
    of the longest trailing n-gram (n down to 1) and propose the tokens
    that followed it; pad by repeating the last token when the lookup
    comes up short (a mismatch costs one rejected draft, not
    correctness)."""

    def __init__(self, max_ngram: int = 3, window: int = 1024):
        if max_ngram < 1:
            raise ValueError("max_ngram must be >= 1")
        self.max_ngram = max_ngram
        self.window = window

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens[-self.window:])
        n = len(toks)
        out: List[int] = []
        for m in range(min(self.max_ngram, n - 1), 0, -1):
            tail = toks[n - m:]
            # most recent earlier occurrence of the trailing m-gram
            for s in range(n - m - 1, -1, -1):
                if toks[s:s + m] == tail:
                    out = toks[s + m: s + m + k]
                    break
            if out:
                break
        last = toks[-1] if toks else 0
        while len(out) < k:
            out.append(out[-1] if out else last)
        return out[:k]


class CallableDrafter(Drafter):
    """Adapter: any ``fn(tokens, k) -> [k] ids`` as a Drafter."""

    def __init__(self, fn):
        self.fn = fn

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        out = list(self.fn(tokens, k))
        if len(out) != k:
            raise ValueError(f"drafter returned {len(out)} tokens, "
                             f"wanted {k}")
        return out


def make_drafter(mode: str, **kw) -> Optional[Drafter]:
    """A `ServeConfig.spec_decode` mode -> a Drafter (None for
    'none')."""
    if mode == "none":
        return None
    if mode == "ngram":
        return NGramDrafter(**kw)
    if mode == "model":
        raise NotImplementedError(
            f"spec-decode mode 'model' (a draft model verified by the "
            f"stochastic rule) arrives with {_SERVING_3}")
    raise ValueError(f"unknown spec-decode mode {mode!r}; "
                     "choices: ('none', 'ngram', 'model')")


def accept_counts(targets: np.ndarray, drafts: np.ndarray) -> np.ndarray:
    """Host-side twin of the engine's acceptance rule.  targets: [S,
    k+1] the per-position sequential-path tokens; drafts: [S, k].
    Returns [S] n_emit in [1, k+1]: the longest matched prefix plus the
    one always-emitted correction/bonus token."""
    match = targets[:, :-1] == drafts            # [S, k]
    acc = np.cumprod(match.astype(np.int64), axis=1).sum(axis=1)
    return acc + 1


def expected_tokens_per_step(acceptance: float, k: int) -> float:
    """E[tokens emitted a verify step] under per-position acceptance
    probability `acceptance`: 1 + a + a^2 + ... + a^k."""
    if not 0.0 <= acceptance <= 1.0:
        raise ValueError(f"acceptance must be in [0, 1], got {acceptance}")
    if acceptance == 1.0:
        return float(k + 1)
    return (1.0 - acceptance ** (k + 1)) / (1.0 - acceptance)
