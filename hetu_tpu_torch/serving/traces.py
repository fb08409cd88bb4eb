"""Synthetic arrival traces for the serving load generator, copied from
`hetu_tpu/serving/traces.py` (host-only code).

Seeded, replayable request streams: the same seed gives the same
requests and arrivals as the reference, so the two engines can be held
against each other on one trace.  The shared-prefix, sampling and
tenant knobs arrive with the engine features that read them; the
sampling stamp is here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from hetu_tpu_torch.serving.request import (DEFAULT_SLO, GREEDY, Request,
                                            SamplingParams, SLOClass)


def poisson_arrivals(n: int, rate_per_s: float, *, seed: int = 0
                     ) -> np.ndarray:
    """[n] arrival times of a Poisson process (exponential gaps at
    `rate_per_s`), starting at t=0."""
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be positive")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    gaps[0] = 0.0
    return np.cumsum(gaps)


def synthetic_requests(n: int, *, vocab_size: int, prompt_lens=(4, 24),
                       max_new=(4, 12), eos_token_id: Optional[int] = None,
                       arrivals: Optional[np.ndarray] = None,
                       slo_classes: Optional[Sequence[SLOClass]] = None,
                       sampling: Optional[SamplingParams] = None,
                       seed: int = 0) -> List[Request]:
    """n seeded requests with uniform prompt lengths / decode budgets and
    the given arrival times (default: all at t=0).  ``slo_classes``
    assigns latency classes round-robin; None keeps every request in the
    default class.  ``sampling`` stamps the given SamplingParams on
    every request with a per-request seed (base seed + rid)."""
    rng = np.random.default_rng(seed)
    if arrivals is None:
        arrivals = np.zeros(n)
    if len(arrivals) != n:
        raise ValueError(f"{len(arrivals)} arrival times for {n} requests")
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        mnew = int(rng.integers(max_new[0], max_new[1] + 1))
        slo = (slo_classes[i % len(slo_classes)] if slo_classes
               else DEFAULT_SLO)
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        sp = GREEDY
        if sampling is not None:
            sp = SamplingParams(temperature=sampling.temperature,
                                top_k=sampling.top_k, top_p=sampling.top_p,
                                seed=sampling.seed + i)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=mnew,
                            eos_token_id=eos_token_id,
                            arrival_t=float(arrivals[i]), slo=slo,
                            sampling=sp))
    return reqs
