"""Seeded token sampling for the serving engine, the port of
`hetu_tpu/serving/sampling.py`.

The key of each sampled token is a pure function of the request's seed
and the token's absolute sequence position,

    key words = key_data(fold_in(key(seed), position))

computed here bit-exactly as JAX computes it (threefry2x32 in numpy
uint32 arithmetic, on the host, where the engine keeps seeds and
positions), so a request replays to the same tokens
across restarts, slot assignments, batch compositions and speculative
re-verification, and on the CPU matches the reference token for token.

Greedy stays greedy: temperature-0 rows take the first-index argmax of
the unfiltered logits.  Filters follow HF: top-k first, the nucleus over
the renormalized top-k distribution, the top token always kept.  The
draw is Gumbel-argmax over the reference's counter hash of the key
words (`ops/cuda/sample.py`).

Every function takes `device=` ("cuda" by default): on the card the
draw is the sampling kernel (`sample_logits` over existing logits,
`fused_sample` over hidden rows and the LM head), on the CPU its plain
version; the logits or hidden rows must lie there.  Per-row inputs
(seeds, positions, temperatures, top-k, top-p) come from the host and
reach the device in one copy (`row_args`).
"""
from __future__ import annotations

import numpy as np
import torch

from hetu_tpu_torch.ops.cuda.sample import fused_sample, sample_logits

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the block (x0, x1) under the key
    (k0, k1): numpy uint32 arrays (wrapping arithmetic), broadcast.
    Returns the two output words."""
    k0, k1, x0, x1 = np.broadcast_arrays(
        *(np.asarray(v, np.uint32) for v in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _host(x) -> np.ndarray:
    """A host array of a tensor (copied off the card: a sync), a numpy
    array or a sequence."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def key_words_host(seeds, positions) -> np.ndarray:
    """uint32 [..., 2]: the raw data of `fold_in(key(seed), position)`,
    on the host.  key(seed) is the word pair (0, seed); fold_in is
    threefry2x32 of the block (0, position) under it.  ``positions``
    are the sampled tokens' ABSOLUTE sequence positions."""
    seeds = _host(seeds).astype(np.int64) & 0xFFFFFFFF
    positions = _host(positions).astype(np.int64) & 0xFFFFFFFF
    w0, w1 = threefry2x32(0, seeds.astype(np.uint32), 0,
                          positions.astype(np.uint32))
    return np.stack([w0, w1], axis=-1)


def key_words(seeds, positions) -> torch.Tensor:
    """`key_words_host` as int64 (uint32 values) on the device of
    `seeds` (the CPU for a host array)."""
    dev = seeds.device if torch.is_tensor(seeds) else "cpu"
    return torch.from_numpy(key_words_host(seeds, positions).astype(
        np.int64)).to(dev)


def row_args(seeds, positions, temps, top_ks, top_ps, device):
    """Host per-row sampling inputs [R] -> the sampler's arguments on
    `device` in ONE host-to-device copy: key words int32 [R, 2] (the
    uint32 bits), temperatures fp32 [R], top-ks int32 [R], top-ps fp32
    [R]."""
    words = key_words_host(seeds, positions).reshape(-1, 2)
    R = words.shape[0]
    buf = np.empty(5 * R, np.uint32)
    buf[:2 * R] = words.reshape(-1)
    buf[2 * R:3 * R] = np.asarray(_host(temps), np.float32).view(np.uint32)
    buf[3 * R:4 * R] = _host(top_ks).astype(np.int32).view(np.uint32)
    buf[4 * R:] = np.asarray(_host(top_ps), np.float32).view(np.uint32)
    t = torch.from_numpy(buf.view(np.int32)).to(device)
    return (t[:2 * R].view(R, 2), t[2 * R:3 * R].view(torch.float32),
            t[3 * R:4 * R], t[4 * R:].view(torch.float32))


def sample_tokens(logits, seeds, positions, temps, top_ks, top_ps, *,
                  device="cuda") -> torch.Tensor:
    """Sample (or argmax) one token a row.  logits [S, V] on `device`;
    the per-row inputs on the host (numpy arrays or sequences; a tensor
    is copied off its device): seeds / positions / top_ks [S] int,
    temps / top_ps [S] fp32.  Returns [S] int32."""
    return sample_logits(logits, *row_args(seeds, positions, temps, top_ks,
                                           top_ps, logits.device),
                         device=device)


def _rep(x, C: int) -> np.ndarray:
    """[S] -> [S * C]: per-slot parameters broadcast over C positions."""
    return np.repeat(_host(x), C)


def sample_token_grid(logits, seeds, positions, temps, top_ks, top_ps, *,
                      device="cuda") -> torch.Tensor:
    """The verify form: logits [S, C, V], positions [S, C] (the sampled
    tokens' absolute positions), per-slot parameters broadcast over C.
    Returns [S, C] int32."""
    S, C, V = logits.shape
    return sample_tokens(logits.reshape(S * C, V), _rep(seeds, C),
                         _host(positions).reshape(-1), _rep(temps, C),
                         _rep(top_ks, C), _rep(top_ps, C),
                         device=device).reshape(S, C)


def sample_hidden(hidden, w, seeds, positions, temps, top_ks, top_ps, *,
                  device="cuda") -> torch.Tensor:
    """The fused epilogue: last-layer hidden rows [R, H] and the LM head
    w [H, V] -> one token a row, with no [R, V] logits leaving the
    sampling kernels' scratch on the card."""
    return fused_sample(hidden, w, *row_args(seeds, positions, temps,
                                             top_ks, top_ps, hidden.device),
                        device=device)


def sample_hidden_grid(hidden, w, seeds, positions, temps, top_ks, top_ps,
                       *, device="cuda") -> torch.Tensor:
    """`sample_hidden` over the verify grid: hidden [S, C, H], positions
    [S, C]; per-slot parameters broadcast over C.  Returns [S, C]
    int32."""
    S, C, H = hidden.shape
    return sample_hidden(hidden.reshape(S * C, H), w, _rep(seeds, C),
                         _host(positions).reshape(-1), _rep(temps, C),
                         _rep(top_ks, C), _rep(top_ps, C),
                         device=device).reshape(S, C)
