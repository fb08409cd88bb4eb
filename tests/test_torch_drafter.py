"""The port's model drafter and stochastic verification against the JAX
reference, on the CPU: the blockwise dequantize's plain version, the
resident int8 round trip, `last_logits` (the draft model's forward),
`ModelDrafter`, `stochastic_verify`, and the engine with
`spec_decode="model"`.

Tolerances: the dequantize bit for bit against the Pallas kernel in
interpret mode (HETU_TPU_PALLAS=1, block sizes 128 and 256, the sizes
its gate takes) and against the XLA composition at block 64; resident
payloads identical, scales and dequantized weights within rtol 1e-7
(the reference's XLA path may round a division by qmax differently by
one ulp); `last_logits` against the reference's `prefill` logits 1e-4
(docs/kernels.md, across a model forward); draft distributions 1e-5; tokens identical.  The
stochastic rule draws from the counter hash, whose Gumbel noise goes
through `log` (XLA's and PyTorch's differ by a few fp32 ulps), and
compares a uniform with p / q: only rows whose decision sits within
1e-6 of the uniform, whose resample is a near-tie, or whose residual
p - q is rounding (q = p), may differ, and they are counted.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.comm import compress as jcompress
from hetu_tpu.models import generation as jgen
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu.ops.pallas import quant as jpquant
from hetu_tpu.ops.pallas.sample import gumbel as jgumbel
from hetu_tpu.ops.pallas.sample import hash_uniform as jhash_uniform
from hetu_tpu.serving import sampling as jsampling
from hetu_tpu.serving import spec_decode as jspec
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.models import generation as tgen
from hetu_tpu_torch.ops.cuda import quant as tq
from hetu_tpu_torch.serving import spec_decode as tspec
from test_torch_parity import HD128, MODEL_TOL, jax_llama_and_port

ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)
#: the reference's test draft model (test_serving_decode.py `_draft_llama`)
DRAFT = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=3, **HD128)


def _draft_pair():
    """A (JAX model, params, port model) draft triple, the same weights
    on both sides."""
    return jax_llama_and_port(seed=7, **DRAFT)


# ------------------------------------------------------------ dequantize
def _payload(seed, nb, bs):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, bs)).astype(np.float32)
    x *= rng.exponential(size=(nb, 1)).astype(np.float32)
    x[1] = 0.0
    q, s = tq.quantize_blockwise_plain(_t(x), bs)
    return q, s


@pytest.mark.parametrize("bs", [64, 128, 256])
def test_dequantize_blockwise_matches_reference(bs, monkeypatch):
    """Bit for bit: against the Pallas kernel in interpret mode where
    its gate takes the block size (128, 256), against the XLA
    composition at 64 (where the reference routes on a TPU)."""
    q, s = _payload(bs, 96, bs)
    if bs % 128 == 0:
        monkeypatch.setenv("HETU_TPU_PALLAS", "1")
        monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", "quant")
        ref = jpquant.dequantize_blockwise_pallas(jnp.asarray(q.numpy()),
                                                  jnp.asarray(s.numpy()))
    else:
        ref = jcompress.dequantize_blockwise(jnp.asarray(q.numpy()),
                                             jnp.asarray(s.numpy()))
    before = tq.dequant_launches
    out = tq.dequantize_blockwise(q, s, device="cpu")
    assert tq.dequant_launches == before
    assert out.dtype == torch.float32 and tuple(out.shape) == (96 * bs,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise_plain(q, s).numpy(), np.asarray(ref))
    # the bf16 arm is the fp32 result cast once
    bf = tq.dequantize_blockwise(q, s, out_dtype=torch.bfloat16,
                                 device="cpu")
    assert torch.equal(bf.view(torch.int16),
                       out.to(torch.bfloat16).view(torch.int16))


def test_dequantize_blockwise_refuses_what_it_does_not_take():
    q, s = _payload(0, 4, 32)
    with pytest.raises(ValueError, match="int8"):
        tq.dequantize_blockwise(q.float(), s, device="cpu")
    with pytest.raises(ValueError, match="fp32 scales"):
        tq.dequantize_blockwise(q, s.double(), device="cpu")
    with pytest.raises(ValueError, match="fp32 scales"):
        tq.dequantize_blockwise(q, s[:3], device="cpu")
    with pytest.raises(ValueError, match="out_dtype"):   # fp16 has its arm
        tq.dequantize_blockwise(q, s, out_dtype=torch.float64, device="cpu")
    with pytest.raises(RuntimeError):          # no card here
        tq.dequantize_blockwise(q, s)


# ------------------------------------------------------ resident weights
@pytest.mark.parametrize("bits,block", [(8, 64), (8, 128), (4, 64)])
def test_resident_round_trip_matches_reference(bits, block):
    """`_quantize_resident` / `_dequantize_resident` over the same
    leaves: payloads identical, scales and the restored leaves within
    rtol 1e-7, shapes and dtypes restored, padding dropped, 1-D and
    integer leaves passed through."""
    rng = np.random.default_rng(bits + block)
    leaves = {
        "odd": rng.standard_normal((3, 100)).astype(np.float32),  # pads
        "mat": rng.standard_normal((64, 2, 48)).astype(np.float32),
        "gain": rng.standard_normal(64).astype(np.float32),
        "ids": rng.integers(0, 9, (4, 4)).astype(np.int32),
    }
    bf = rng.standard_normal((16, 32)).astype(np.float32)
    jtree = {k: jnp.asarray(v) for k, v in leaves.items()}
    jtree["bf"] = jnp.asarray(bf, jnp.bfloat16)
    ttree = {k: _t(v) for k, v in leaves.items()}
    ttree["bf"] = _t(bf).bfloat16()
    jq, jspec_ = jspec._quantize_resident(jtree, bits=bits, block=block)
    tq_, tspec_ = tspec._quantize_resident(ttree, bits=bits, block=block)
    assert sorted(tspec_) == sorted(jspec_) == ["bf", "mat", "odd"]
    for name in tspec_:
        np.testing.assert_array_equal(tq_[name]["q"].numpy(),
                                      np.asarray(jq[name]["q"]))
        np.testing.assert_allclose(tq_[name]["s"].numpy(),
                                   np.asarray(jq[name]["s"]), rtol=1e-7)
        assert tspec_[name]["shape"] == jspec_[name]["shape"]
    assert tq_["gain"] is ttree["gain"] and tq_["ids"] is ttree["ids"]
    jback = jspec._dequantize_resident(jq, jspec_)
    tback = tspec._dequantize_resident(tq_, tspec_)
    for name, ref in jback.items():
        mine = tback[name]
        assert tuple(mine.shape) == tuple(ref.shape)
        assert mine.dtype == ttree[name].dtype
        np.testing.assert_allclose(mine.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=1e-7)


# ------------------------------------------------------- the draft forward
def test_last_logits_match_reference_prefill(pair):
    """The draft forward: the port's `last_logits` against the
    reference's `prefill` logits (its cache has no counterpart)."""
    jmodel, jparams, tmodel = pair
    ids = np.random.default_rng(11).integers(
        0, tmodel.config.vocab_size, (2, 13)).astype(np.int32)
    jl, _ = jgen.prefill(jmodel, jparams, jnp.asarray(ids), 32)
    tl = tgen.last_logits(tmodel, _t(ids))
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    with pytest.raises(ValueError):
        tgen.last_logits(tmodel, _t(np.zeros(
            (1, tmodel.config.max_position_embeddings + 1), np.int32)))


@pytest.mark.parametrize("temperature", [1.0, 0.7, 0.0])
def test_model_drafter_proposals_match_reference(temperature):
    """The same draft weights, context, seed and positions: the same
    drafts and proposal distributions (the lane-3 Gumbel draw over the
    dequantized model's logits; a point mass at temperature 0)."""
    jmodel, jparams, tmodel = _draft_pair()
    jd = jspec.ModelDrafter(jmodel, jparams, temperature=temperature,
                            window=12)
    td = tspec.ModelDrafter(tmodel, temperature=temperature, window=12)
    assert td.stochastic and td.window == 12
    # the float matrices live only as int8 payloads in the drafter's own
    # copy of the module; the model it was given is left as it was
    wqkv = tmodel.model.layers[0].attn.wqkv.clone()
    assert td.model is not tmodel
    assert td.model.model.layers[0].attn.wqkv.numel() == 0
    assert td.model.model.final_norm.weight.numel() == DRAFT["hidden_size"]
    rng = np.random.default_rng(int(temperature * 10))
    for trial in range(4):
        toks = rng.integers(0, 256, int(rng.integers(1, 20))).tolist()
        kw = dict(seed=1000 + trial, start_pos=len(toks) + trial)
        jt, jq = jd.propose_with_probs(toks, 3, **kw)
        tt, tq_ = td.propose_with_probs(toks, 3, **kw)
        assert tt == jt
        assert tuple(tq_.shape) == (3, 256)
        np.testing.assert_allclose(tq_.numpy(), jq, atol=1e-5)
    assert td.forwards == 4 * 3
    assert td.propose(toks, 2) == jd.propose(toks, 2)
    assert torch.equal(tmodel.model.layers[0].attn.wqkv, wqkv)
    # so a second drafter over the same model drafts the same
    again = tspec.ModelDrafter(tmodel, temperature=temperature, window=12)
    assert again.propose(toks, 2) == jd.propose(toks, 2)


# ------------------------------------------------------ stochastic verify
def _verify_case(seed, S=48, k=3, V=64):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((S, k + 1, V))).astype(np.float32)
    q = np.exp(1.5 * rng.standard_normal((S, k, V)))
    q = (q / q.sum(-1, keepdims=True)).astype(np.float32)
    # a third of the rows propose q = p at every position (acceptance
    # 1 when the filters are off): long accepted prefixes and bonuses
    drafts = np.stack([[rng.choice(V, p=q[s, i] / q[s, i].sum())
                        for i in range(k)] for s in range(S)]).astype(
                            np.int32)
    seeds = rng.integers(0, 2 ** 31, S).astype(np.int64)
    positions = (rng.integers(0, 500, (S, 1)) + np.arange(k + 1)).astype(
        np.int32)
    temps = np.array([0.0, 1.0, 0.7, 1.3] * (S // 4), np.float32)
    top_ks = np.array([0, 0, 10, 0, 0, 5] * (S // 6), np.int32)
    top_ps = np.array([0.0, 0.9, 0.0, 0.0, 0.8, 0.0, 0.0, 0.0] * (S // 8),
                      np.float32)
    for s in range(0, S, 3):
        p = np.asarray(jax.nn.softmax(jsampling.filtered_logits(
            jnp.asarray(logits[s, :k]), jnp.asarray(np.repeat(temps[s], k)),
            jnp.asarray(np.repeat(top_ks[s], k)),
            jnp.asarray(np.repeat(top_ps[s], k)))))
        q[s] = p
    return logits, q, drafts, seeds, positions, temps, top_ks, top_ps


def _near_miss(logits, q, drafts, seeds, positions, temps, top_ks, top_ps):
    """Per row: True where the reference's decision could flip on a few
    ulps — an accept uniform within 1e-6 of p / q at or before the
    first rejection, or a resample whose top-two gap is under 1e-5 or
    whose residual mass is under 1e-6 (where q = p to rounding, the
    rule resamples from p, or from what rounding left of p - q)."""
    S, C, V = logits.shape
    k = C - 1
    rep = lambda x: jnp.asarray(np.repeat(x, k))  # noqa: E731
    filt = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits[:, :k].reshape(S * k, V)), rep(temps),
        rep(top_ks), rep(top_ps))).reshape(S, k, V)
    p = np.asarray(jax.nn.softmax(jnp.asarray(filt), axis=-1))
    words = np.asarray(jsampling.key_words(
        jnp.asarray(np.repeat(seeds, k)),
        jnp.asarray(positions[:, :k].reshape(-1))))
    u = np.asarray(jhash_uniform(words[:, 0], words[:, 1],
                                 np.zeros(S * k, np.uint32),
                                 lane=1)).reshape(S, k)
    rows = np.arange(S)[:, None]
    ratio = p[rows, np.arange(k), drafts] / np.maximum(
        q[rows, np.arange(k), drafts], 1e-30)
    res = np.maximum(p - q, 0.0)
    scores = np.where(res.sum(-1, keepdims=True) > 1e-9,
                      np.where(res > 0, np.log(np.maximum(res, 1e-30)),
                               -1e30), filt)
    g = np.asarray(jgumbel(words[:, 0:1], words[:, 1:2],
                           np.arange(V, dtype=np.uint32)[None, :],
                           lane=2)).reshape(S, k, V)
    top2 = np.sort(scores + g, axis=-1)[..., -2:]
    mass = res.sum(-1)
    near = np.zeros(S, bool)
    for s in range(S):
        if temps[s] == 0:
            continue
        for i in range(k):
            if abs(u[s, i] - ratio[s, i]) < 1e-6:
                near[s] = True
            if u[s, i] > ratio[s, i]:       # the resample decides here
                if mass[s, i] < 1e-6 or top2[s, i, 1] - top2[s, i, 0] < 1e-5:
                    near[s] = True
                break
    return near


@pytest.mark.parametrize("seed", [0, 1])
def test_stochastic_verify_matches_reference(seed):
    case = _verify_case(seed)
    jout, jn = jspec.stochastic_verify(*(jnp.asarray(a) for a in case))
    tout, tn = tspec.stochastic_verify(_t(case[0]), _t(case[1]), *case[2:])
    assert tout.dtype == tn.dtype == torch.int32
    jout, jn = np.asarray(jout), np.asarray(jn)
    differ = (tout.numpy() != jout).any(axis=1) | (tn.numpy() != jn)
    near = _near_miss(*case)
    assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
    print(f"stochastic_verify seed {seed}: {int(differ.sum())} of "
          f"{len(differ)} rows differ, {int(near.sum())} near a tie")
    assert near.sum() <= 2
    # every path of the rule ran: rejections, full acceptances, greedy
    assert (jn == 1).any() and (jn == case[2].shape[1] + 1).any()
    assert (case[5] == 0).any()


def test_stochastic_verify_analytic_acceptance():
    """The reference's analytic test: over many slots sharing one (p, q)
    pair with independent hash draws, the acceptance rate converges to
    sum_v min(p(v), q(v)) and the first emitted token's marginal to p,
    for q unlike p; greedy rows collapse to accept-iff-argmax."""
    S, V, k = 4096, 32, 1
    rng = np.random.default_rng(0)
    t_logits = rng.normal(size=(1, k + 1, V)).astype(np.float32)
    logits = torch.from_numpy(np.broadcast_to(t_logits,
                                              (S, k + 1, V)).copy())
    p = torch.softmax(torch.from_numpy(t_logits[0, 0]), -1).numpy()
    q = np.exp(rng.normal(size=V))
    q /= q.sum()
    q_probs = torch.from_numpy(np.broadcast_to(q.astype(np.float32),
                                               (S, k, V)).copy())
    drafts = rng.choice(V, size=(S, k), p=q).astype(np.int32)
    seeds = np.arange(S)
    positions = np.broadcast_to(np.arange(k + 1), (S, k + 1))
    ones, zeros_i, zeros_f = (np.ones(S, np.float32), np.zeros(S, np.int32),
                              np.zeros(S, np.float32))
    out, n_emit = tspec.stochastic_verify(logits, q_probs, drafts, seeds,
                                          positions, ones, zeros_i, zeros_f)
    out, n_emit = out.numpy(), n_emit.numpy()
    analytic = float(np.minimum(p, q).sum())
    measured = float((n_emit >= 2).mean())
    assert abs(measured - analytic) < 0.04, (measured, analytic)
    emp = np.bincount(out[:, 0], minlength=V) / S
    assert 0.5 * np.abs(emp - p).sum() < 0.08
    gout, gn = tspec.stochastic_verify(logits, q_probs, drafts, seeds,
                                       positions, zeros_f, zeros_i, zeros_f)
    am = t_logits[0].argmax(axis=-1)
    assert (gout.numpy()[:, 0] == am[0]).all()
    np.testing.assert_array_equal(gn.numpy(),
                                  np.where(drafts[:, 0] == am[0], 2, 1))


# ------------------------------------------------------------ the engine
def _reqs(pkg, vocab, n=3, seed=5, max_new=6, sampling=None):
    """The reference test's trace (`_reqs` of test_serving_decode.py)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sp = sampling(pkg, i) if sampling else pkg.GREEDY
        out.append(pkg.Request(
            rid=i, prompt=rng.integers(0, vocab, size=int(
                rng.integers(4, 20))).astype(np.int32),
            max_new_tokens=max_new, sampling=sp))
    return out


def _sampled(pkg, i):
    return pkg.SamplingParams(temperature=0.9, top_k=20, seed=40 + i)


def _engines(pair, **cfg):
    """(JAX engine, port engine) with spec_decode='model' over fresh
    draft models of the same weights."""
    jmodel, jparams, tmodel = pair
    jdraft, jdparams, tdraft = _draft_pair()
    scfg = dict(ENGINE, sampling=True, spec_decode="model", spec_k=2, **cfg)
    jeng = jserving.ServingEngine(
        jmodel, jparams, jserving.ServeConfig(**scfg),
        draft_model=jdraft, draft_params=jdparams,
        registry=JMetricsRegistry())
    teng = tserving.ServingEngine(tmodel, tserving.ServeConfig(**scfg),
                                  draft_model=tdraft, device="cpu").warmup()
    return jeng, teng


def test_model_drafter_engine_matches_reference_and_replays(pair):
    """spec_decode='model': the resident-int8 draft model proposes, the
    p/q rule verifies.  Greedy requests give the reference engine's
    tokens (and generate()'s) with the same drafts accepted; sampled
    requests give the reference's tokens and replay identically on a
    fresh engine."""
    jmodel, jparams, tmodel = pair
    vocab = tmodel.config.vocab_size
    jeng, teng = _engines(pair)
    assert teng.spec_stochastic and isinstance(teng.drafter,
                                               tspec.ModelDrafter)
    jres = jeng.run(_reqs(jserving, vocab))
    tres = teng.run(_reqs(tserving, vocab))
    teng.scheduler.check_invariants()
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, t.rid
        assert (t.stats.spec_proposed, t.stats.spec_accepted) == \
            (j.stats.spec_proposed, j.stats.spec_accepted)
        out = jgen.generate(jmodel, jparams,
                            jnp.asarray(_reqs(jserving, vocab)[t.rid]
                                        .prompt)[None],
                            max_new_tokens=6)
        assert t.tokens == [int(x) for x in np.asarray(out)[0][-6:]]
    assert sum(r.stats.spec_proposed for r in tres) > 0
    assert teng.registry.counter_value("serve.spec_proposed") == \
        sum(r.stats.spec_proposed for r in tres)
    # sampled: the reference's tokens, and a fresh engine replays them
    s1 = teng.run(_reqs(tserving, vocab, sampling=_sampled))
    s2 = _engines(pair)[1].run(_reqs(tserving, vocab, sampling=_sampled))
    js = jeng.run(_reqs(jserving, vocab, sampling=_sampled))
    for a, b, c in zip(s1, s2, js):
        assert a.tokens == b.tokens == c.tokens, a.rid
    assert any(r.stats.spec_accepted for r in s1)


def test_model_drafter_with_prefix_cache_and_int8_pages(pair):
    """The slice's whole path at a small size: the model drafter over
    int8 pages with the prefix cache on — the greedy tokens of the same
    engine without speculation, a prefix hit for every request after
    the first (they arrive one at a time), and every page back at the
    end but the cache's."""
    _, _, tmodel = pair
    vocab = tmodel.config.vocab_size
    rng = np.random.default_rng(2)
    sysp = rng.integers(0, vocab, 16).astype(np.int32)

    def trace():
        r = np.random.default_rng(3)
        return [tserving.Request(rid=i, prompt=np.concatenate(
                    [sysp, r.integers(0, vocab, 5).astype(np.int32)]),
                    max_new_tokens=5, arrival_t=100.0 * i)
                for i in range(4)]
    draft = _draft_pair()[2]
    eng = tserving.ServingEngine(
        tmodel, tserving.ServeConfig(**ENGINE, kv_quant="int8",
                                     prefix_cache=True, spec_decode="model",
                                     spec_k=2),
        draft_model=draft, device="cpu").warmup()
    spec = eng.run(trace())
    eng.scheduler.check_invariants()
    base = tserving.ServingEngine(
        tmodel, tserving.ServeConfig(**ENGINE, kv_quant="int8",
                                     prefix_cache=True),
        device="cpu").run(trace())
    assert [r.tokens for r in spec] == [r.tokens for r in base]
    assert eng.registry.counter_value("serve.prefix_hits") == 3
    assert eng.pool.used_count == eng.prefix_cache.num_pages
    assert eng.drafter.forwards > 0


def test_model_spec_mode_without_draft_model_is_loud(pair):
    """The reference's rule (a ValueError naming the draft), and the
    port's own: `draft_params` has no counterpart and a draft model
    needs the model mode."""
    _, _, tmodel = pair
    cfg = tserving.ServeConfig(**ENGINE, spec_decode="model", spec_k=2)
    with pytest.raises(ValueError, match="draft"):
        tserving.ServingEngine(tmodel, cfg, device="cpu")
    with pytest.raises(ValueError, match="draft"):
        tspec.make_drafter("model")
    with pytest.raises(TypeError, match="draft_params"):
        tserving.ServingEngine(tmodel, cfg, device="cpu",
                               draft_model=tmodel, draft_params={})
    with pytest.raises(ValueError, match="spec_decode='model'"):
        tserving.ServingEngine(tmodel, tserving.ServeConfig(**ENGINE),
                               device="cpu", draft_model=object())
