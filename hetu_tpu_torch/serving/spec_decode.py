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

**Stochastic drafters** (``Drafter.stochastic``) report their whole
proposal distribution q a draft position (`propose_with_probs`), and
the engine verifies them with the full rejection rule
(`stochastic_verify`): draft d_i is accepted with probability
min(1, p(d_i) / q(d_i)), and the first rejected position resamples from
the residual norm(max(p - q, 0)).  The output distribution is exactly
the sequential path's p for any q.  Every draw (accept uniforms,
residual and draft Gumbels) is the reference's counter hash of the
(seed, absolute position) key words on its own lane (1, 2 and 3), so
stochastic verification replays like every other sampled token.

`NGramDrafter` is the model-free drafter (prompt-lookup decoding):
match the longest recent n-gram earlier in the sequence and replay what
followed it.  `ModelDrafter` runs a small draft model whose weights stay
resident in int8 (`_quantize_resident`); every forward dequantizes a
working copy through the blockwise dequantize kernel.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_tpu_torch.models.generation import last_logits
from hetu_tpu_torch.ops.cuda.quant import (KERNEL_DTYPES,
                                           dequantize_blockwise,
                                           quantize_blockwise)
from hetu_tpu_torch.ops.cuda.sample import (filtered_logits, gumbel,
                                            hash_uniform)
from hetu_tpu_torch.serving.sampling import (_host, key_words_host,
                                             sample_tokens)


class Drafter:
    """Host-side draft proposer interface."""

    #: how many trailing context tokens `propose` reads; the engine
    #: slices the sequence to this before calling (None = the whole
    #: history), so drafting stays O(window) a step
    window: Optional[int] = None
    #: True for drafters that report their proposal distribution
    #: (`propose_with_probs`) and take the stochastic p/q rule
    stochastic: bool = False

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


def _quantize_resident(params: Mapping[str, torch.Tensor], *, bits: int,
                       block: int):
    """Blockwise-quantize every floating leaf of two or more dimensions of
    a flat {name: tensor} map (a module's `named_parameters()`) for
    resident storage: each leaf flattened (in its own type where the
    kernel reads it, which widens it exactly; else in fp32), zero-padded
    to a block multiple, quantized on its own device (the kernel on the
    card).
    1-D leaves (norm gains) stay as they are.  Returns (tree_q, spec):
    tree_q maps a quantized name to {"q": int8 [nb, block], "s": fp32
    [nb]} and every other name to its tensor; spec maps a quantized name
    to {"shape", "dtype"}."""
    tree, spec = {}, {}
    for name, leaf in params.items():
        if leaf.dim() < 2 or not leaf.is_floating_point():
            tree[name] = leaf
            continue
        flat = leaf.detach().reshape(-1)
        if flat.dtype not in KERNEL_DTYPES:
            flat = flat.float()
        pad = (-flat.numel()) % block
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        q, s = quantize_blockwise(flat, block, bits=bits,
                                  device=flat.device)
        tree[name] = {"q": q, "s": s}
        spec[name] = {"shape": tuple(leaf.shape), "dtype": leaf.dtype}
    return tree, spec


def _dequantize_resident(params_q, spec) -> Dict[str, torch.Tensor]:
    """The inverse of `_quantize_resident`: {name: tensor} with every
    quantized leaf dequantized (the kernel on the card; a bf16 or fp16
    leaf comes out of it in its own type, the bits of fp32-then-cast)
    and the rest as stored."""
    out = {}
    for name, node in params_q.items():
        meta = spec.get(name)
        if meta is None:
            out[name] = node
            continue
        dtype = meta["dtype"]
        y_dtype = dtype if dtype in KERNEL_DTYPES else torch.float32
        flat = dequantize_blockwise(node["q"], node["s"], out_dtype=y_dtype,
                                    device=node["q"].device)
        n = math.prod(meta["shape"])
        out[name] = flat[:n].reshape(meta["shape"]).to(dtype)
    return out


@contextlib.contextmanager
def _weights(model: torch.nn.Module, tensors: Mapping[str, torch.Tensor]):
    """Run `model` with `tensors` in place of its parameters of those
    names, restoring them on exit."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner)
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


class ModelDrafter(Drafter):
    """A small draft model as a stochastic drafter.

    Proposals are sampled from the draft model's temperature-scaled
    softmax — exactly the q `propose_with_probs` reports, which makes
    the engine's p/q rejection rule distribution-exact for any draft
    model.  The draw is Gumbel-argmax over the counter hash (lane 3) of
    the request's (seed, absolute position) key words, so drafts replay
    like every other sampled token; temperature 0 is an argmax rollout
    with a point-mass q.

    The draft model (a `LlamaLMHeadModel` or `GPTLMHeadModel`) is left
    as it was given: its float matrices are blockwise-quantized at
    construction into the drafter's own int8 + fp32 scales, and the drafter runs a copy of the
    module that holds no matrices (drop the model to free its float
    weights).  Each forward dequantizes a working copy
    (`_dequantize_resident`, the blockwise dequantize kernel on the
    card) into that copy and runs its forward over the trailing `window`
    tokens for the last position's logits
    (`models/generation.last_logits`); a propose runs k of them."""

    stochastic = True

    def __init__(self, model, *, temperature: float = 1.0,
                 window: int = 256, quantize_bits: int = 8,
                 quantize_block: int = 64):
        if window < 1:
            raise ValueError("window must be >= 1")
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        params = dict(model.named_parameters())
        self.temperature = float(temperature)
        self.window = int(window)
        self.params_q, self._spec = _quantize_resident(
            params, bits=quantize_bits, block=quantize_block)
        # the module without its quantized matrices; the leaves kept as
        # they are (norm gains) are the copy's own
        self.model = copy.deepcopy(model, {
            id(params[name]): torch.nn.Parameter(
                params[name].new_empty(0), requires_grad=False)
            for name in self._spec})
        own = dict(self.model.named_parameters())
        for name in self.params_q.keys() - self._spec.keys():
            self.params_q[name] = own[name]
        #: forwards run (one a draft token)
        self.forwards = 0

    def _logits(self, toks: List[int]) -> torch.Tensor:
        """fp32 [V] next-token logits of the draft model after `toks`."""
        ctx = torch.as_tensor([toks[-self.window:]], dtype=torch.long,
                              device=self.model.device)
        with _weights(self.model,
                      _dequantize_resident(self.params_q, self._spec)):
            logits = last_logits(self.model, ctx)
        self.forwards += 1
        return logits[0].float()

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        return self.propose_with_probs(tokens, k)[0]

    def propose_with_probs(self, tokens: Sequence[int], k: int, *,
                           seed: int = 0, start_pos: int = 0
                           ) -> Tuple[List[int], torch.Tensor]:
        """k drafts after `tokens` and their proposal distributions q,
        fp32 [k, V] on the draft model's device.  Draft i sits at
        absolute position start_pos + i, whose key words seed its
        draw."""
        toks = list(tokens[-self.window:]) or [0]
        out: List[int] = []
        probs = []
        for i in range(k):
            logits = self._logits(toks)
            V = logits.shape[0]
            if self.temperature > 0:
                scaled = logits / logits.new_full((), self.temperature)
                w = torch.from_numpy(key_words_host(
                    [seed], [start_pos + i]).astype(np.int64)).to(
                        logits.device)
                g = gumbel(w[0, 0], w[0, 1],
                           torch.arange(V, device=logits.device), lane=3)
                tok = int(torch.argmax(scaled + g).item())
                q = torch.softmax(scaled, dim=-1)
            else:
                tok = int(torch.argmax(logits).item())
                q = torch.zeros_like(logits)
                q[tok] = 1.0
            out.append(tok)
            probs.append(q)
            toks.append(tok)
        return out, torch.stack(probs)


def make_drafter(mode: str, **kw) -> Optional[Drafter]:
    """A `ServeConfig.spec_decode` mode -> a Drafter (None for 'none').
    mode='model' needs `model=` (the engine passes its draft_model)."""
    if mode == "none":
        return None
    if mode == "ngram":
        return NGramDrafter(**kw)
    if mode == "model":
        if kw.get("model") is None:
            raise ValueError("spec-decode mode 'model' needs a draft "
                             "model: pass model= (the engine's "
                             "draft_model)")
        return ModelDrafter(**kw)
    raise ValueError(f"unknown spec-decode mode {mode!r}; "
                     "choices: ('none', 'ngram', 'model')")


def stochastic_verify(logits_grid, q_probs, drafts, seeds, positions,
                      temps, top_ks, top_ps):
    """The full speculative rejection rule (the stochastic drafters'
    verify epilogue).

    logits_grid: [S, k+1, V] target logits at the verify positions, on
    the device the rule runs on; q_probs: [S, k, V] the drafter's
    proposal distributions (moved there); drafts: [S, k] the proposed
    tokens; positions: [S, k+1] the absolute positions of the tokens
    being decided (the key input); seeds / temps / top_ks / top_ps: [S]
    per-slot sampling parameters.  The host inputs may be numpy arrays
    or tensors.  Returns (out_tokens [S, k+1] int32, n_emit [S] int32)
    on the logits' device.

    At draft position i the target distribution p is the softmax of the
    filtered temperature-scaled logits (what the sequential sampler
    draws from); the draft is accepted when a lane-1 hash uniform of the
    position's key is <= p(d_i) / q(d_i); the first rejected position
    emits a lane-2 Gumbel-argmax resample from norm(max(p - q, 0)) (from
    p where no residual is left).  Greedy rows (temp 0) accept iff the
    draft is the argmax and correct to the argmax.  Full acceptance
    emits the bonus token, the sequential path's own draw at position k
    (`sampling.sample_tokens`: the draw kernel on the card)."""
    S, C, V = logits_grid.shape
    k = C - 1
    dev = logits_grid.device
    seeds_h = _host(seeds).astype(np.int64)
    pos_h = _host(positions).astype(np.int64).reshape(S, C)
    temps_h = np.asarray(_host(temps), np.float32)
    top_ks_h = _host(top_ks).astype(np.int64)
    top_ps_h = np.asarray(_host(top_ps), np.float32)
    rep = lambda x: torch.as_tensor(np.repeat(x, k), device=dev)  # noqa: E731

    filt = filtered_logits(logits_grid[:, :k].reshape(S * k, V),
                           rep(temps_h), rep(top_ks_h),
                           rep(top_ps_h)).reshape(S, k, V)
    p = torch.softmax(filt, dim=-1)
    q = torch.as_tensor(q_probs, device=dev).float()
    d = torch.as_tensor(_host(drafts), device=dev).long()
    p_d = torch.gather(p, 2, d[..., None])[..., 0]
    q_d = torch.gather(q, 2, d[..., None])[..., 0]

    words = torch.from_numpy(key_words_host(
        np.repeat(seeds_h, k), pos_h[:, :k].reshape(-1)).astype(
            np.int64)).to(dev)
    u = hash_uniform(words[:, 0], words[:, 1],
                     torch.zeros(S * k, dtype=torch.long, device=dev),
                     lane=1).reshape(S, k)
    ratio = p_d / torch.clamp_min(q_d, 1e-30)
    greedy_tok = torch.argmax(logits_grid, dim=-1)
    sampling_row = torch.as_tensor(temps_h > 0, device=dev)[:, None]
    accept = torch.where(sampling_row, u <= ratio, d == greedy_tok[:, :k])

    res = torch.clamp_min(p - q, 0.0)
    has_res = res.sum(dim=-1, keepdim=True) > 1e-9
    scores = torch.where(
        has_res, torch.where(res > 0, torch.log(torch.clamp_min(res, 1e-30)),
                             torch.full_like(res, -1e30)), filt)
    g = gumbel(words[:, 0:1], words[:, 1:2],
               torch.arange(V, device=dev)[None, :], lane=2).reshape(S, k, V)
    resample = torch.argmax(scores + g, dim=-1)
    resample = torch.where(sampling_row, resample, greedy_tok[:, :k])

    bonus = sample_tokens(logits_grid[:, k], seeds_h, pos_h[:, k], temps_h,
                          top_ks_h, top_ps_h, device=dev).long()

    r = torch.cumprod(accept.long(), dim=1).sum(dim=1)      # [S] in [0, k]
    rows = torch.arange(S, device=dev)
    correction = torch.where(r < k, resample[rows, torch.clamp(r, 0, k - 1)],
                             bonus)
    out = torch.cat([d, bonus[:, None]], dim=1)
    out[rows, r] = correction
    return out.to(torch.int32), (r + 1).to(torch.int32)


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
