"""The port's radix prefix cache against the JAX reference, on the CPU:
the pool's copy-on-write refcounts, `RadixPrefixCache`, the scheduler's
admission with a prefix hit (the COW fuzz drives both schedulers with
one operation sequence: page ids, refcounts and tables equal after
every step), the pool's dense `gather` (the prime) in the three page
modes, and the engine warm against cold.

Tolerances: host bookkeeping identical; `gather` identical for exact
pages and within rtol 1e-7 of the reference for quantized pages (the
scales the reference's XLA path computes may round a division by qmax
differently by one ulp); engine tokens identical, and equal between the
warm and the cold engine.  Engine runs use the 2-layer hd128 pair of
tests/test_torch_parity.py; the reference runs its Pallas kernels in
interpret mode (HETU_TPU_PALLAS=1), as tests/test_serving_decode.py
runs them.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu.serving import kv_pool as jkv_pool
from hetu_tpu.serving.prefix_cache import RadixPrefixCache as JRadix
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.ops.cuda import quant as tq
from hetu_tpu_torch.serving.prefix_cache import RadixPrefixCache as TRadix
from test_torch_parity import HD128, jax_llama_and_port

_PALLAS = "paged_attn,paged_verify,sample,quant"
ENGINE = dict(num_slots=2, page_size=8, max_len=64, prefill_chunk=8)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", _PALLAS)


@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=3, **HD128)


def _pools(num_pages, page_size=4):
    """(JAX host-only pool, port CPU pool) of one shape."""
    return (jserving.PagePool(num_layers=1, num_pages=num_pages,
                              page_size=page_size, num_kv_heads=1,
                              head_dim=8, device_arrays=False),
            tserving.PagePool(num_layers=1, num_pages=num_pages,
                              page_size=page_size, num_kv_heads=1,
                              head_dim=8, device="cpu"))


def _same_pool(jpool, tpool):
    np.testing.assert_array_equal(tpool.refcount, jpool.refcount)
    assert tpool._free == jpool._free
    assert (tpool.allocs, tpool.frees) == (jpool.allocs, jpool.frees)


# --------------------------------------------------------------- the pool
def test_pool_refcounts_match_the_reference():
    jpool, tpool = _pools(6)
    for pool in (jpool, tpool):
        a = pool.alloc(3)
        pool.incref(a[:2])
        pool.incref([a[0]])
        pool.free(a)                     # a[2] frees, a[0:2] stay live
        pool.free([a[0]])
        with pytest.raises(ValueError, match="incref of free page"):
            pool.incref([a[2]])
        with pytest.raises(ValueError, match="invalid page id"):
            pool.incref([0])
        with pytest.raises(ValueError, match="double free"):
            pool.free([a[2]])
        with pytest.raises(ValueError, match="invalid page id"):
            pool.free([7])
        assert pool.alloc(9) is None
    _same_pool(jpool, tpool)
    assert tpool.free_count == 6 - 2


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_gather_matches_the_reference(quant):
    """The prime's dense read of one slot's pages, quantized pages
    dequantized by their per-(token, head) scales."""
    L, P, ps, n_kv, hd = 2, 6, 4, 2, 128
    rng = np.random.default_rng(3)
    jpool = jserving.PagePool(num_layers=L, num_pages=P, page_size=ps,
                              num_kv_heads=n_kv, head_dim=hd, quant=quant)
    tpool = tserving.PagePool(num_layers=L, num_pages=P, page_size=ps,
                              num_kv_heads=n_kv, head_dim=hd, quant=quant,
                              device="cpu")
    x = rng.standard_normal((2, L, P + 1, ps, n_kv, hd)).astype(np.float32)
    if quant == "none":
        parts = [x[0], x[1]]
    else:
        bits = 4 if quant == "int4" else 8
        (kq, ks), (vq, vs) = (jkv_pool.quantize_heads(jnp.asarray(t), bits)
                              for t in x)
        parts = [np.asarray(t) for t in (kq, vq, ks, vs)]
    jpool.arrays = jkv_pool.PoolArrays(*(jnp.asarray(t) for t in parts))
    for name, t in zip(("k", "v", "k_scale", "v_scale"), parts):
        getattr(tpool, name).copy_(torch.from_numpy(np.array(t)))
    before = tq.dequant_launches
    row = np.array([3, 5, 1, 0], np.int32)
    jk, jv = jpool.gather(jpool.arrays.tree(), jnp.asarray(row[None]))
    tk, tv = tpool.gather(row)
    assert tq.dequant_launches == before          # the plain version
    for mine, ref in ((tk, jk), (tv, jv)):
        assert tuple(mine.shape) == (L, 1, 4 * ps, n_kv, hd)
        assert mine.dtype == torch.float32
        if quant == "none":
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        else:
            np.testing.assert_allclose(mine.numpy(), np.asarray(ref),
                                       rtol=1e-7)


# -------------------------------------------------------- the radix cache
def test_radix_cache_match_insert_evict_refcounts():
    """JAX test_serving_decode.py's radix cache test, on both caches."""
    jpool, tpool = _pools(12)
    for pool, Radix in ((jpool, JRadix), (tpool, TRadix)):
        cache = Radix(pool)
        prompt = np.arange(11)
        pages = pool.alloc(3)
        # cap: only full pages of prompt[:plen - 1] = 10 -> 2 blocks
        assert cache.insert(prompt, pages) == 2
        assert pool.refcount[pages[0]] == 2 and pool.refcount[pages[2]] == 1
        assert cache.match(prompt) == (8, pages[:2])
        assert cache.match(np.arange(6)) == (4, pages[:1])
        assert cache.match(np.arange(8))[0] == 4  # >= 1 token prefills
        pool.free(pages)
        assert pool.free_count == 12 - 2
        assert cache.evict(2) == 2
        assert pool.free_count == 12 and cache.num_pages == 0
        st = cache.stats()
        assert st["hits"] == 3 and st["evicted_pages"] == 2
    _same_pool(jpool, tpool)


def test_radix_cache_budget_and_dedup():
    jpool, tpool = _pools(8)
    for pool, Radix in ((jpool, JRadix), (tpool, TRadix)):
        cache = Radix(pool, max_pages=1)
        p1 = pool.alloc(2)
        assert cache.insert(np.arange(9), p1) == 1    # budget caps at 1
        assert cache.num_pages == 1
        p2 = pool.alloc(2)
        assert cache.insert(np.arange(9), p2) == 0    # dedup
        assert pool.refcount[p2[0]] == 1
    _same_pool(jpool, tpool)


def test_evict_counts_freed_pages_only_under_pressure():
    jpool, tpool = _pools(4)
    stats = []
    for pool, Radix in ((jpool, JRadix), (tpool, TRadix)):
        cache = Radix(pool)
        shared = pool.alloc(1)
        cache.insert(np.arange(5), shared)
        sole = pool.alloc(1)
        cache.insert(np.concatenate([np.arange(4) + 100, [1]]), sole)
        pool.free(sole)
        assert cache.evict(1, require_free=True) == 1
        assert pool.free_count == 3 and cache.num_pages == 1
        assert cache.match(np.arange(5))[0] == 4
        assert cache.evict(1) == 1 and pool.free_count == 3
        assert sorted(cache.owned_pages()) == []
        pool.free(shared)
        stats.append(cache.stats())
    assert stats[0] == stats[1]
    _same_pool(jpool, tpool)


# ------------------------------------------------------------ the scheduler
def _both_schedulers(num_pages, max_len, num_slots, **kw):
    jpool, tpool = _pools(num_pages)
    jcache, tcache = JRadix(jpool), TRadix(tpool)
    return ((jserving, jserving.Scheduler(num_slots=num_slots, pool=jpool,
                                          max_len=max_len,
                                          prefix_cache=jcache, **kw),
             jcache),
            (tserving, tserving.Scheduler(num_slots=num_slots, pool=tpool,
                                          max_len=max_len,
                                          prefix_cache=tcache, **kw),
             tcache))


def _same_schedulers(j, t):
    (_, jsch, jcache), (_, tsch, tcache) = j, t
    _same_pool(jsch.pool, tsch.pool)
    np.testing.assert_array_equal(tsch.page_table, jsch.page_table)
    for a, b in zip(jsch.slots, tsch.slots):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.pages, a.shared_tokens, a.request.rid) == \
                (b.pages, b.shared_tokens, b.request.rid)
            assert a.stats.shared_prefix_tokens == \
                b.stats.shared_prefix_tokens
    assert sorted(tcache.owned_pages()) == sorted(jcache.owned_pages())
    assert tcache.stats() == jcache.stats()
    assert tsch.last_stall == jsch.last_stall
    jsch.check_invariants()
    tsch.check_invariants()


def test_admission_pins_matched_chain_before_eviction():
    """The reference's regression: under page pressure the matched
    chain (the cache's only evictable leaf) is pinned, so the admission
    stalls instead of aliasing prefix and suffix on one page."""
    j, t = _both_schedulers(4, 12, 2)
    b_slot = {}
    for pkg, sch, cache in (j, t):
        sch.submit(pkg.Request(rid=0, prompt=np.arange(5),
                               max_new_tokens=3))
        idx, st = sch.admit_next(0.0)
        st.pos = 5
        cache.insert(st.request.prompt, st.pages, 0.0)
        sch.release(idx)
        sch.submit(pkg.Request(rid=1, prompt=np.arange(4) + 50,
                               max_new_tokens=4))
        b_slot[pkg], _ = sch.admit_next(0.5)
        sch.submit(pkg.Request(rid=2, prompt=np.arange(5),
                               max_new_tokens=7))
        assert sch.admit_next(1.0) is None and sch.last_stall == "no_pages"
        assert cache.num_pages == 1 and cache.match(np.arange(5))[0] == 4
    _same_schedulers(j, t)
    for pkg, sch, _ in (j, t):
        sch.release(b_slot[pkg])
        _, st = sch.admit_next(2.0)
        assert st.shared_tokens == 4
        assert len(set(st.pages)) == len(st.pages)
    _same_schedulers(j, t)


def test_scheduler_cow_fuzz_with_prefix_cache():
    """The reference's COW fuzz, one operation sequence through both
    schedulers: 400 steps of random arrival / finish churn over a small
    pool with the radix cache attached and three shared prompt families;
    page ids, refcounts, tables and cache contents equal after every
    transition, and the extended `check_invariants` holds on both."""
    rng = np.random.default_rng(7)
    j, t = _both_schedulers(24, 32, 3)
    prefixes = [rng.integers(0, 50, size=8).astype(np.int32)
                for _ in range(3)]
    rid = 0
    for step in range(400):
        now = float(step)
        if rng.random() < 0.5 and len(t[1].queue) < 4:
            pre = prefixes[int(rng.integers(len(prefixes)))]
            tail = rng.integers(0, 50, size=int(rng.integers(1, 8))).astype(
                np.int32)
            new = int(rng.integers(1, 6))
            for pkg, sch, _ in (j, t):
                sch.submit(pkg.Request(rid=rid,
                                       prompt=np.concatenate([pre, tail]),
                                       max_new_tokens=new))
            rid += 1
        for _, sch, cache in (j, t):
            adm = sch.admit_next(now)
            if adm is not None:
                _, st = adm
                st.pos = st.request.prompt_len    # prefill done at once
                cache.insert(st.request.prompt, st.pages, now)
        _same_schedulers(j, t)
        live = t[1].active_slots()
        if live and rng.random() < 0.4:
            victim = int(rng.choice(live))
            for _, sch, _ in (j, t):
                sch.release(victim)
        if rng.random() < 0.1:
            n = int(rng.integers(1, 4))
            assert j[2].evict(n) == t[2].evict(n)
        _same_schedulers(j, t)
    for _, sch, cache in (j, t):
        for i in sch.active_slots():
            sch.release(i)
        cache.clear()
        sch.check_invariants()
        assert sch.pool.free_count == sch.pool.num_pages
    assert t[2].stats()["hits"] > 0
    _same_schedulers(j, t)


# --------------------------------------------------------------- the engine
def _system_prompt_trace(pkg, vocab):
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, vocab, size=24).astype(np.int32)
    return [pkg.Request(rid=i, prompt=np.concatenate(
                [sysp, rng.integers(0, vocab, size=6).astype(np.int32)]),
                max_new_tokens=6) for i in range(6)]


def _chunks(snapshot):
    return {r["name"]: r["value"]
            for r in snapshot["counters"]}["serve.prefill_chunks"]


def test_prefix_cache_warm_parity_and_chunks_saved(pallas, pair):
    """A shared system prompt through both engines with the cache: warm
    admissions hit it, tokens are identical to the reference's warm
    engine and to the port's cold engine, prefill chunks drop to the
    unshared suffix as the reference's do, and the counters agree."""
    jmodel, jparams, tmodel = pair
    vocab = tmodel.config.vocab_size
    jeng = jserving.ServingEngine(
        jmodel, jparams, jserving.ServeConfig(**ENGINE, prefix_cache=True),
        registry=JMetricsRegistry())
    jwarm = jeng.run(_system_prompt_trace(jserving, vocab))
    teng = tserving.ServingEngine(
        tmodel, tserving.ServeConfig(**ENGINE, prefix_cache=True),
        device="cpu").warmup()
    twarm = teng.run(_system_prompt_trace(tserving, vocab))
    teng.scheduler.check_invariants()
    cold = tserving.ServingEngine(tmodel, tserving.ServeConfig(**ENGINE),
                                  device="cpu")
    tcold = cold.run(_system_prompt_trace(tserving, vocab))
    for a, b, c in zip(twarm, jwarm, tcold):
        assert a.tokens == b.tokens == c.tokens, a.rid
        assert a.stats.shared_prefix_tokens == b.stats.shared_prefix_tokens
    assert teng.prefix_cache.stats() == jeng.prefix_cache.stats()
    st = teng.prefix_cache.stats()
    assert st["hits"] >= 4 and st["shared_tokens"] >= 4 * 24
    reg = teng.registry
    warm_chunks = reg.counter_value("serve.prefill_chunks")
    assert warm_chunks == _chunks(jeng._registry.snapshot())
    # 30-token prompts: 4 chunks cold; a warm hit prefills 1
    assert warm_chunks <= cold.registry.counter_value(
        "serve.prefill_chunks") - 3 * 4 + 3
    assert reg.counter_value("serve.prefix_hits") == st["hits"]
    assert reg.counter_value("serve.prefix_misses") == st["misses"]
    assert reg.counter_value("serve.prefix_shared_tokens") == \
        st["shared_tokens"]
    assert reg.gauge_value("serve.prefix_cache_pages") <= st["pages"]
    # only the cache holds pages once every request is done
    assert teng.pool.used_count == st["pages"]


def test_prefix_cache_on_int8_pages_and_chunk_cut_at_max_len(pair):
    """Quantized pages prime through the dequantize (its plain version
    here) and replay; a shared boundary off the chunk grid whose last
    chunk would run past max_len is cut there (prompts of 60 tokens, a
    shared prefix of 56 = 7 pages, chunks of 16 from 56 reach 72 > 64).
    Requests arrive one at a time (the engine's clock skips idle time),
    so each finds its predecessors' pages cached."""
    _, _, tmodel = pair
    vocab = tmodel.config.vocab_size
    rng = np.random.default_rng(5)
    sysp = rng.integers(0, vocab, size=57).astype(np.int32)
    base = np.concatenate([sysp, [1, 2]])

    def trace():
        return [tserving.Request(rid=i, prompt=np.concatenate(
                    [base, [i + 3]]).astype(np.int32), max_new_tokens=2,
                    arrival_t=100.0 * i) for i in range(3)]
    cfg = dict(num_slots=2, page_size=8, max_len=64, prefill_chunk=16)
    runs = []
    for kv in ("int8", "int8", "none"):
        eng = tserving.ServingEngine(
            tmodel, tserving.ServeConfig(**cfg, kv_quant=kv,
                                         prefix_cache=True), device="cpu")
        res = eng.run(trace())
        eng.scheduler.check_invariants()
        assert [r.stats.shared_prefix_tokens for r in res] == [0, 56, 56]
        runs.append([r.tokens for r in res])
    assert runs[0] == runs[1]
    cold = tserving.ServingEngine(tmodel, tserving.ServeConfig(**cfg),
                                  device="cpu").run(trace())
    assert runs[2] == [r.tokens for r in cold]
