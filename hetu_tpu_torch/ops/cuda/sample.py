"""Fused sampling: wrappers, plain versions and launch counters, and the
counter-based noise they share.

Replaces `hetu_tpu/ops/pallas/sample.py` `fused_sample` (`_sample_kernel`
with `hash_uniform`, `gumbel`, `_kth_largest_key`, `_nucleus_key`).
Kernels: `csrc/sample.cu` — (a) the LM-head product into an fp32 logits
scratch buffer, one read of the head (bf16 on the tensor cores); (b)
filter and draw, a cluster of 8 blocks a row, the row held in their
shared memory.  `fused_sample` launches both (B9, counted in `launches`);
`sample_logits` launches (b) alone where the logits already exist (the
decode step and the first token, counted in `logits_launches`), so no
plain sampler runs on the card.

The plain versions are the reference's XLA path: `sample_plain` sorts
each row once (`filtered_logits`, HF semantics: top-k first, the
nucleus over the renormalized top-k distribution, the top token always
kept) and draws by Gumbel-argmax over `gumbel`; `fused_sample_plain` is
the fp32 product followed by `sample_plain`.  Key words are uint32
values held in int64 tensors (`serving/sampling.key_words`), or their
bits in int32 (`serving/sampling.row_args`).
"""
from __future__ import annotations

import ctypes

import torch

from hetu_tpu_torch.ops.cuda import build

#: fused (product + draw) launches (the plain versions never count)
launches = 0
#: filter-and-draw launches over existing logits
logits_launches = 0

#: the longest row the draw kernel holds: a cluster of 8 blocks, each
#: its share of the row in shared memory (csrc/sample.cu SB_CLUSTER x
#: SB_MAX_CHUNK)
MAX_VOCAB = 8 * 26624

#: the filter mask value (the reference's)
_NEG = -1e30
_M32 = 0xFFFFFFFF

_SAMPLE = {torch.float32: "hetu_sample_f32",
           torch.bfloat16: "hetu_sample_bf16"}
_LM_HEAD = {torch.float32: "hetu_lm_head_f32",
            torch.bfloat16: "hetu_lm_head_bf16"}
_SAMPLE_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int] + [ctypes.c_void_p] * 6
_LM_HEAD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = {**dict.fromkeys(_SAMPLE.values(), _SAMPLE_ARGS),
               **dict.fromkeys(_LM_HEAD.values(), _LM_HEAD_ARGS)}


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 values x held in int64, without an
    int64 overflow (the constant split in 16-bit halves)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_uniform(w0, w1, idx, lane: int = 0) -> torch.Tensor:
    """The reference's counter hash (a murmur3 finalizer over the key
    words, the counter index and the stream lane), bit-exact in uint32:
    uniforms in (0, 1), fp32.  Arguments are int64 tensors of uint32
    values and broadcast."""
    x = w0 ^ mul32(idx, 0x9E3779B1) ^ ((lane * 0x85EBCA77) & _M32)
    x = (x + w1) & _M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24)) \
        + (0.5 / (1 << 24))


def gumbel(w0, w1, idx, lane: int = 0) -> torch.Tensor:
    """Gumbel(0, 1) noise from `hash_uniform`: argmax(logits + gumbel)
    is an exact categorical draw."""
    return -torch.log(-torch.log(hash_uniform(w0, w1, idx, lane)))


def filtered_logits(logits, temps, top_ks, top_ps) -> torch.Tensor:
    """Per-row temperature + top-k + top-p, the reference's sort-based
    form.  logits [R, V]; temps [R] (0 = greedy row, returned unscaled
    and unfiltered by the temperature); top_ks [R] (0 = off); top_ps
    [R] (0 or >= 1 = off).  Returns fp32 [R, V], filtered entries at
    -1e30."""
    V = logits.shape[-1]
    temps = temps.float()
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    scaled = logits.float() / safe_t[:, None]
    desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V)).long()
    kth = torch.gather(desc, 1, (k_eff[:, None] - 1).clamp(0, V - 1))
    out = torch.where(scaled < kth, torch.full_like(scaled, _NEG), scaled)
    # the nucleus over the renormalized top-k distribution
    p_on = (top_ps > 0.0) & (top_ps < 1.0)
    ranks = torch.arange(V, device=logits.device)[None, :]
    desc_f = torch.where(ranks < k_eff[:, None], desc,
                         torch.full_like(desc, _NEG))
    probs = torch.softmax(desc_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_ps.float()[:, None]  # mass BEFORE the token
    cutoff = torch.where(keep, desc_f, torch.full_like(desc_f, float("inf")))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    return torch.where(p_on[:, None] & (out < cutoff),
                       torch.full_like(out, _NEG), out)


def sample_plain(logits, key_words, temps, top_ks, top_ps) -> torch.Tensor:
    """One token a row: Gumbel-argmax over `filtered_logits` with the
    noise of each row's key words; temperature-0 rows take the
    first-index argmax of the unfiltered logits.  Returns [R] int32."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1)
    filt = filtered_logits(logits, temps, top_ks, top_ps)
    idx = torch.arange(V, device=logits.device)[None, :]
    kw = key_words.long() & _M32
    g = gumbel(kw[:, 0:1], kw[:, 1:2], idx)
    sampled = torch.argmax(filt + g, dim=-1)
    return torch.where(temps > 0, sampled, greedy).to(torch.int32)


def fused_sample_plain(hidden, w, key_words, temps, top_ks, top_ps):
    """The reference's own fallback: the fp32 product, then
    `sample_plain`."""
    return sample_plain(hidden.float() @ w.float(), key_words, temps,
                        top_ks, top_ps)


def _row_args(name, R, key_words, temps, top_ks, top_ps):
    if tuple(key_words.shape) != (R, 2):
        raise ValueError(f"{name}: key_words {tuple(key_words.shape)} must "
                         f"be [R={R}, 2]")
    for arg, t in (("temps", temps), ("top_ks", top_ks), ("top_ps", top_ps)):
        if tuple(t.shape) != (R,):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} must be "
                             f"[R={R}]")


def _launch_sample(logits, key_words, temps, top_ks, top_ps):
    """Kernel (b) over logits [R, V] (unit column stride)."""
    R, V = logits.shape
    if V > MAX_VOCAB:
        raise ValueError(f"the draw kernel holds rows of up to {MAX_VOCAB} "
                         f"entries, got {V}")
    words = key_words
    if words.dtype != torch.int32:
        words = torch.where(words >= 2 ** 31, words - 2 ** 32,
                            words).to(torch.int32)
    words = words.contiguous()
    temps = temps.to(torch.float32).contiguous()
    top_ks = top_ks.to(torch.int32).contiguous()
    top_ps = top_ps.to(torch.float32).contiguous()
    out = torch.empty(R, dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        err = build.bind("sample", _SAMPLE[logits.dtype], _SAMPLE_ARGS)(
            logits.data_ptr(), logits.stride(0), R, V, words.data_ptr(),
            temps.data_ptr(), top_ks.data_ptr(), top_ps.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(
                logits.device).cuda_stream)
    build.check_launch(err, "sample")
    return out


def sample_logits(logits, key_words, temps, top_ks, top_ps, *,
                  device="cuda") -> torch.Tensor:
    """Filter and draw over existing logits [R, V] (fp32 or bf16): one
    token a row, [R] int32.  key_words [R, 2] (uint32 values in int64,
    or their bits in int32),
    temps / top_ps [R] fp32, top_ks [R] int.  `device` "cuda" launches
    the kernel, "cpu" runs `sample_plain`; the tensors must lie
    there."""
    dev = build.check_device("sample_logits", device, logits, key_words,
                             temps, top_ks, top_ps)
    if logits.dim() != 2:
        raise ValueError(f"sample_logits takes logits [R, V], got "
                         f"{tuple(logits.shape)}")
    _row_args("sample_logits", logits.shape[0], key_words, temps, top_ks,
              top_ps)
    if dev.type == "cpu":
        return sample_plain(logits, key_words, temps, top_ks, top_ps)
    if logits.dtype not in _SAMPLE:
        raise ValueError(f"the CUDA kernel takes fp32/bf16 logits, got "
                         f"{logits.dtype}")
    if logits.stride(1) != 1:
        logits = logits.contiguous()
    out = _launch_sample(logits, key_words, temps, top_ks, top_ps)
    global logits_launches
    logits_launches += 1
    return out


def lm_head_logits(hidden, w) -> torch.Tensor:
    """Kernel (a) alone: fp32 logits [R, V] of hidden [R, H] x w [H, V]
    (fp32 or bf16, one type), on the card.  Counts no launch of its
    own: `fused_sample` counts its pair."""
    R, H = hidden.shape
    V = w.shape[1]
    hidden = hidden.contiguous()
    logits = torch.empty((R, V), dtype=torch.float32, device=hidden.device)
    with torch.cuda.device(hidden.device):
        err = build.bind("sample", _LM_HEAD[hidden.dtype], _LM_HEAD_ARGS)(
            hidden.data_ptr(), w.data_ptr(), logits.data_ptr(), R, H, V,
            w.stride(0), w.stride(1),
            torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check_launch(err, "lm_head")
    return logits


def fused_sample(hidden, w, key_words, temps, top_ks, top_ps, *,
                 device="cuda") -> torch.Tensor:
    """hidden [R, H] + head w [H, V] -> sampled tokens [R] int32: the
    product in fp32, then temperature / top-k / top-p and the Gumbel
    draw keyed by key_words [R, 2] (temperature-0 rows greedy).
    `device` "cuda" launches the two kernels, "cpu" runs
    `fused_sample_plain`; the tensors must lie there."""
    dev = build.check_device("fused_sample", device, hidden, w, key_words,
                             temps, top_ks, top_ps)
    if hidden.dim() != 2 or w.dim() != 2 or w.shape[0] != hidden.shape[1]:
        raise ValueError(f"expected hidden [R, H] and head [H, V], got "
                         f"{tuple(hidden.shape)} / {tuple(w.shape)}")
    _row_args("fused_sample", hidden.shape[0], key_words, temps, top_ks,
              top_ps)
    if dev.type == "cpu":
        return fused_sample_plain(hidden, w, key_words, temps, top_ks,
                                  top_ps)
    if hidden.dtype not in _LM_HEAD or w.dtype != hidden.dtype:
        raise ValueError(f"the CUDA kernels take fp32/bf16 hidden and head "
                         f"of one type, got {hidden.dtype} / {w.dtype}")
    logits = lm_head_logits(hidden, w)
    out = _launch_sample(logits, key_words, temps, top_ks, top_ps)
    global launches
    launches += 1
    return out
