"""The port's second serving slice against the JAX reference, on the CPU:
paged attention over int8/int4 pages, the paged verify step, the
quantized and speculative serving forwards, the n-gram drafter, and the
engine with seeded sampling, n-gram speculation and quantized pages.

The reference runs its Pallas kernels in interpret mode
(HETU_TPU_PALLAS=1, HETU_TPU_PALLAS_KERNELS=paged_attn,paged_verify,
sample,quant), as tests/test_serving_decode.py does; the port runs the
kernels' plain versions.  Tolerances: attention 1e-5 (fp32), the
forwards' logits and hidden states 1e-4 (docs/kernels.md), pool
payloads identical, engine tokens identical, with the same speculative
proposals and acceptances.  The model is the 2-layer hd128 pair of
tests/test_torch_parity.py.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.models import generation as jgen
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu.ops.pallas import paged_attention as jpaged
from hetu_tpu.serving import kv_pool as jkv_pool
from hetu_tpu.serving import spec_decode as jspec
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.models import generation as tgen
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.serving import kv_pool as tkv_pool
from hetu_tpu_torch.serving import spec_decode as tspec
from test_torch_parity import HD128, MODEL_TOL, jax_llama_and_port

FWD_TOL = 1e-5
_PALLAS = "paged_attn,paged_verify,sample,quant"
ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", _PALLAS)


@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=3, **HD128)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ paged attention
def _pages(seed, quant, P=9, ps=8, n_kv=2, hd=128, lead=()):
    """Pools of seeded head vectors in a page mode: (k, v, k_scale,
    v_scale) as numpy, quantized by the reference's own pool path."""
    rng = np.random.default_rng(seed)
    shape = (*lead, P, ps, n_kv, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    if quant == "none":
        return k, v, None, None
    bits = 4 if quant == "int4" else 8
    kq, ks = jkv_pool.quantize_heads(jnp.asarray(k), bits)
    vq, vs = jkv_pool.quantize_heads(jnp.asarray(v), bits)
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


_TABLE = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0], [0, 0, 0, 0]],
                  np.int32)
_POSITIONS = np.array([20, 9, 17, 0], np.int32)


def _jax_kw(ks, vs, quant):
    if quant == "none":
        return {}
    return dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                quant=quant)


def _port_kw(ks, vs, quant):
    if quant == "none":
        return {}
    return dict(k_scale=_t(ks), v_scale=_t(vs), quant=quant)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_paged_attention_matches_pallas_kernel(pallas, quant):
    k, v, ks, vs = _pages(1, quant)
    q = np.random.default_rng(2).standard_normal((4, 4, 128)).astype(
        np.float32)
    ref = jpaged.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(_TABLE),
                                 jnp.asarray(_POSITIONS),
                                 **_jax_kw(ks, vs, quant))
    before = (tpaged.int8_launches, tpaged.int4_launches)
    out = tpaged.paged_attention(_t(q), _t(k), _t(v), _t(_TABLE),
                                 _t(_POSITIONS), device="cpu",
                                 **_port_kw(ks, vs, quant))
    assert (tpaged.int8_launches, tpaged.int4_launches) == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_verify_matches_pallas_kernel(pallas, quant):
    k, v, ks, vs = _pages(3, quant)
    q = np.random.default_rng(4).standard_normal((4, 5, 4, 128)).astype(
        np.float32)
    # slot 2's block runs past its table row (positions 30..34 > 31)
    positions = np.array([20, 9, 30, 0], np.int32)
    ref = jpaged.paged_verify(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(_TABLE), jnp.asarray(positions),
                              **_jax_kw(ks, vs, quant))
    out = tpaged.paged_verify(_t(q), _t(k), _t(v), _t(_TABLE), _t(positions),
                              device="cpu", **_port_kw(ks, vs, quant))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)
    # C = 1 is the decode function
    one = tpaged.paged_verify(_t(q[:, :1]), _t(k), _t(v), _t(_TABLE),
                              _t(positions), device="cpu",
                              **_port_kw(ks, vs, quant))
    dec = tpaged.paged_attention(_t(q[:, 0]), _t(k), _t(v), _t(_TABLE),
                                 _t(positions), device="cpu",
                                 **_port_kw(ks, vs, quant))
    np.testing.assert_array_equal(one[:, 0].numpy(), dec.numpy())


def test_paged_verify_ignores_stale_bytes_past_the_block():
    """NaN in every key past positions[s] + C - 1 (freed and null pages)
    must not reach the output."""
    k, v, _, _ = _pages(5, "none")
    q = np.random.default_rng(6).standard_normal((4, 3, 4, 128)).astype(
        np.float32)
    args = (_t(_TABLE), _t(_POSITIONS))
    clean = tpaged.paged_verify(_t(q), _t(k), _t(v), *args, device="cpu")
    ps, C = k.shape[1], 3
    for s in range(4):
        for j in range(_TABLE.shape[1] * ps):
            if j > _POSITIONS[s] + C - 1 and _TABLE[s, j // ps]:
                k[_TABLE[s, j // ps], j % ps] = np.nan
                v[_TABLE[s, j // ps], j % ps] = np.nan
    k[0, C:], v[0, C:] = np.nan, np.nan
    out = tpaged.paged_verify(_t(q), _t(k), _t(v), *args, device="cpu")
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


def test_paged_wrappers_refuse_mismatched_pages():
    k, v, ks, vs = _pages(7, "int8")
    q, table, pos = _t(np.zeros((4, 4, 128), np.float32)), _t(_TABLE), \
        _t(_POSITIONS)
    with pytest.raises(ValueError):                   # one scale only
        tpaged.paged_attention(q, _t(k), _t(v), table, pos, k_scale=_t(ks),
                               device="cpu")
    with pytest.raises(ValueError):                   # int8 as int4
        tpaged.paged_attention(q, _t(k), _t(v), table, pos, k_scale=_t(ks),
                               v_scale=_t(vs), quant="int4", device="cpu")
    with pytest.raises(ValueError):                   # scales, exact mode
        tpaged.paged_attention(q, _t(k), _t(v), table, pos, k_scale=_t(ks),
                               v_scale=_t(vs), quant="none", device="cpu")


# ------------------------------------------------------ serving forwards
def _forward_case(c, quant, seed):
    L, n_kv, hd = c.num_hidden_layers, c.num_key_value_heads, c.head_dim
    k, v, ks, vs = _pages(seed, quant, P=10, n_kv=n_kv, hd=hd, lead=(L,))
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([20, 9, 27, 0], np.int32)
    return k, v, ks, vs, table, positions


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_decode_step_paged_on_quantized_pools(pallas, pair, quant):
    jmodel, jparams, tmodel = pair
    c = tmodel.config
    k, v, ks, vs, table, positions = _forward_case(c, quant, 11)
    tokens = np.random.default_rng(12).integers(0, c.vocab_size, 4).astype(
        np.int32)
    jl, *jpools = jgen.decode_step_paged(
        jmodel, jparams, jnp.asarray(tokens), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(positions), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), kv_quant=quant)
    tpools = [_t(a) for a in (k, v, ks, vs)]
    tl, *out = tgen.decode_step_paged(
        tmodel, _t(tokens), tpools[0], tpools[1], _t(table), _t(positions),
        k_scale=tpools[2], v_scale=tpools[3], kv_quant=quant)
    assert all(a is b for a, b in zip(out, tpools))      # in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    for mine, ref in zip(tpools, jpools):   # page 0 takes the ride-along
        if mine.dtype == torch.float32:
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_verify_step_paged_matches_reference(pallas, pair, quant):
    jmodel, jparams, tmodel = pair
    c = tmodel.config
    k, v, ks, vs, table, positions = _forward_case(c, quant, 13)
    tokens = np.random.default_rng(14).integers(
        0, c.vocab_size, (4, 5)).astype(np.int32)
    jkw = {} if quant == "none" else dict(
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant=quant)
    tpools = [_t(a) for a in (k, v, ks, vs) if a is not None]
    tkw = {} if quant == "none" else dict(k_scale=tpools[2],
                                          v_scale=tpools[3], kv_quant=quant)
    for hidden in (True, False):
        jout, *jpools = jgen.verify_step_paged(
            jmodel, jparams, jnp.asarray(tokens), jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(table), jnp.asarray(positions),
            return_hidden=hidden, **jkw)
        pools = [t.clone() for t in tpools]
        kw = dict(tkw, **({} if quant == "none"
                          else dict(k_scale=pools[2], v_scale=pools[3])))
        tout, *out = tgen.verify_step_paged(
            tmodel, _t(tokens), pools[0], pools[1], _t(table),
            _t(positions), return_hidden=hidden, **kw)
        assert tout.shape == jout.shape
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=MODEL_TOL)
    for mine, ref in zip(out, jpools):
        if mine.dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       atol=MODEL_TOL)


# --------------------------------------------------------- the drafter
def test_ngram_drafter_and_acceptance_match_reference():
    rng = np.random.default_rng(8)
    for _ in range(40):
        toks = rng.integers(0, 6, int(rng.integers(1, 30))).tolist()
        k = int(rng.integers(1, 6))
        for n in (1, 3):
            assert tspec.NGramDrafter(max_ngram=n).propose(toks, k) == \
                jspec.NGramDrafter(max_ngram=n).propose(toks, k)
    targets = rng.integers(0, 3, (16, 5))
    drafts = rng.integers(0, 3, (16, 4))
    np.testing.assert_array_equal(tspec.accept_counts(targets, drafts),
                                  jspec.accept_counts(targets, drafts))
    for a in (0.0, 0.3, 0.8, 1.0):
        assert tspec.expected_tokens_per_step(a, 4) == \
            jspec.expected_tokens_per_step(a, 4)
    assert tspec.CallableDrafter(lambda t, k: [1] * k).propose([2], 3) == \
        [1, 1, 1]
    with pytest.raises(ValueError, match="draft model"):
        tspec.make_drafter("model")


def test_scheduler_reserves_the_lookahead_like_the_reference():
    """Every reservation covers prompt + budget + the lookahead: the
    same pages as the reference, and the same refusal of what could
    never fit."""
    scheds = []
    for pkg, extra in ((jserving, dict(device_arrays=False)),
                       (tserving, dict(device="cpu"))):
        pool = pkg.PagePool(num_layers=1, num_pages=12, page_size=4,
                            num_kv_heads=1, head_dim=2, **extra)
        sch = pkg.Scheduler(num_slots=3, pool=pool, max_len=24, lookahead=3)
        for rid, (n, m) in enumerate([(5, 4), (8, 8), (3, 2), (6, 5)]):
            sch.submit(pkg.Request(rid=rid, prompt=np.ones(n, np.int32),
                                   max_new_tokens=m))
        with pytest.raises(ValueError):          # 14 + 8 + 3 > 24
            sch.submit(pkg.Request(rid=9, prompt=np.ones(14, np.int32),
                                   max_new_tokens=8))
        scheds.append((sch, [sch.admit_next(0.0) for _ in range(4)]))
    (jsch, jadm), (tsch, tadm) = scheds
    assert [a and a[1].pages for a in jadm] == \
        [a and a[1].pages for a in tadm]
    np.testing.assert_array_equal(jsch.page_table, tsch.page_table)
    tsch.check_invariants()


def test_traces_stamp_sampling_like_the_reference():
    sp = dict(temperature=0.8, top_k=40, top_p=0.9, seed=100)
    j = jserving.synthetic_requests(5, vocab_size=256, seed=2,
                                    sampling=jserving.SamplingParams(**sp))
    t = tserving.synthetic_requests(5, vocab_size=256, seed=2,
                                    sampling=tserving.SamplingParams(**sp))
    for a, b in zip(j, t):
        assert a.sampling.seed == b.sampling.seed == 100 + a.rid
        assert (a.sampling.temperature, a.sampling.top_k, a.sampling.top_p) \
            == (b.sampling.temperature, b.sampling.top_k, b.sampling.top_p)
        np.testing.assert_array_equal(a.prompt, b.prompt)


# ------------------------------------------------------------ the engine
def _requests(pkg, vocab, sampled):
    """4 requests, the odd ones seeded-sampled, prompts with repeats so
    the n-gram drafter has something to find."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(4):
        base = rng.integers(0, vocab, 5)
        prompt = np.concatenate([base, base[:3], rng.integers(0, vocab, 4),
                                 base[:2]]).astype(np.int32)
        sp = pkg.GREEDY
        if sampled and i % 2:
            sp = pkg.SamplingParams(temperature=0.9, top_k=40, top_p=0.9,
                                    seed=70 + i)
        out.append(pkg.Request(rid=i, prompt=prompt[: 8 + 2 * i],
                               max_new_tokens=6, sampling=sp,
                               arrival_t=0.01 * i))
    return out


def _both(pair, sampled, **cfg):
    jmodel, jparams, tmodel = pair
    vocab = tmodel.config.vocab_size
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**ENGINE, **cfg),
                                  registry=JMetricsRegistry())
    teng = tserving.ServingEngine(tmodel,
                                  tserving.ServeConfig(**ENGINE, **cfg),
                                  device="cpu").warmup()
    jres = jeng.run(_requests(jserving, vocab, sampled))
    tres = teng.run(_requests(tserving, vocab, sampled))
    teng.scheduler.check_invariants()
    assert teng.pool.free_count == teng.pool.num_pages
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
        assert t.finished_reason == j.finished_reason
        assert (t.stats.spec_proposed, t.stats.spec_accepted) == \
            (j.stats.spec_proposed, j.stats.spec_accepted)
    return jmodel, jparams, teng, tres


def test_engine_greedy_ngram_spec_matches_reference_and_generate(pallas,
                                                                 pair):
    jmodel, jparams, teng, tres = _both(pair, False, spec_decode="ngram",
                                        spec_k=3)
    reg = teng.registry
    assert reg.counter_value("serve.spec_proposed") == \
        sum(r.stats.spec_proposed for r in tres) > 0
    assert reg.counter_value("serve.spec_accepted") == \
        sum(r.stats.spec_accepted for r in tres)
    assert reg.histogram("serve.spec_emitted").count >= \
        reg.counter_value("serve.decode_steps")
    for r in _requests(tserving, teng.model.config.vocab_size, False):
        out = jgen.generate(jmodel, jparams, jnp.asarray(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens)
        ref = [int(t) for t in np.asarray(out)[0][r.prompt_len:]]
        assert tres[r.rid].tokens == ref, r.rid


def test_engine_sampled_ngram_spec_on_int8_pages(pallas, pair):
    _, _, teng, tres = _both(pair, True, sampling=True, spec_decode="ngram",
                             spec_k=3, kv_quant="int8")
    assert teng.pool.k.dtype == torch.int8
    assert sum(r.stats.spec_accepted for r in tres) > 0


def test_engine_sampled_decode_on_int4_pages(pallas, pair):
    _, _, teng, tres = _both(pair, True, sampling=True, kv_quant="int4")
    assert teng.pool.k.dtype == torch.uint8
    assert teng.pool.k.shape[-1] == teng.model.config.head_dim // 2
    # sampling changed something against greedy decoding
    greedy = tserving.ServingEngine(
        teng.model, tserving.ServeConfig(**ENGINE, kv_quant="int4"),
        device="cpu").run(_requests(tserving, teng.model.config.vocab_size,
                                    False))
    assert any(a.tokens != b.tokens for a, b in zip(tres, greedy)
               if a.rid % 2)


def test_write_pages_quantizes_real_pages_only():
    L, P, ps, n_kv, hd, mp = 2, 8, 4, 2, 128, 5
    pool = tkv_pool.PagePool(num_layers=L, num_pages=P, page_size=ps,
                             num_kv_heads=n_kv, head_dim=hd, quant="int8",
                             device="cpu")
    pool.k.fill_(-3)
    rng = np.random.default_rng(0)
    ks = _t(rng.standard_normal((L, mp * ps, n_kv, hd)).astype(np.float32))
    row = np.array([5, 2, 0, 0, 0], np.int32)
    pool.write_pages(row, ks, ks.clone())
    q, s = tkv_pool.quantize_heads(ks.reshape(L, mp, ps, n_kv, hd))
    for j, p in enumerate(row[:2]):
        assert torch.equal(pool.k[:, p], q[:, j])
        assert torch.equal(pool.k_scale[:, p], s[:, j])
    assert bool((pool.k[:, 0] == -3).all()) and \
        bool((pool.k_scale[:, 0] == 0).all())
