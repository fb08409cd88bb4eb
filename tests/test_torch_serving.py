"""The port's serving slice (hetu_tpu_torch/serving) against the JAX
reference, on the CPU.

The whole slice: the port's `ServingEngine` and the reference's get the
same seeded trace (multi-chunk prompts, staggered arrivals) and the same
weights, and must emit identical greedy tokens.  Around it: the host
modules copied from the reference (traces, scheduler, page allocator,
metrics) held to the reference's own behavior, and the engine's two
page-write rules (the decode table's null-page pin for rows that are not
decoding, and `write_pages` touching only real pages).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch

from hetu_tpu import serving as jserving
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.serving.engine import _LATER_ENGINE_ARGS, _LATER_FIELDS
from test_torch_parity import jax_llama_and_port

ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)


@pytest.fixture(scope="module")
def tiny_pair():
    return jax_llama_and_port(seed=0)


def _trace(pkg, n=6, seed=1):
    arrivals = pkg.poisson_arrivals(n, 40.0, seed=2)
    return pkg.synthetic_requests(n, vocab_size=256, prompt_lens=(3, 20),
                                  max_new=(2, 8), arrivals=arrivals,
                                  seed=seed)


def _port_engine(model, **kw):
    cfg = dict(ENGINE, **kw)
    return tserving.ServingEngine(model, tserving.ServeConfig(**cfg),
                                  device="cpu")


# ---------------------------------------------------------- whole slice
def test_engine_emits_the_reference_engines_tokens(tiny_pair):
    jmodel, jparams, tmodel = tiny_pair
    jreqs, treqs = _trace(jserving), _trace(tserving)
    assert any(r.prompt_len > ENGINE["prefill_chunk"] for r in treqs), \
        "no multi-chunk prefill in the trace"
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**ENGINE),
                                  registry=JMetricsRegistry())
    teng = _port_engine(tmodel).warmup()
    jres, tres = jeng.run(jreqs), teng.run(treqs)
    assert [r.rid for r in tres] == [r.rid for r in jres] == list(range(6))
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
        assert t.finished_reason == j.finished_reason == "length"
        assert len(t.tokens) == treqs[t.rid].max_new_tokens
    teng.scheduler.check_invariants()
    assert teng.pool.free_count == teng.pool.num_pages
    reg = teng.registry
    assert reg.counter_value("serve.requests_done") == 6
    assert reg.counter_value("serve.prefill_chunks") == sum(
        -(-r.prompt_len // ENGINE["prefill_chunk"]) for r in treqs)
    assert reg.histogram("serve.ttft_s").count == 6


def test_traces_match_the_reference():
    for j, t in zip(_trace(jserving, n=8, seed=5),
                    _trace(tserving, n=8, seed=5)):
        assert (j.rid, j.max_new_tokens, j.arrival_t) == \
            (t.rid, t.max_new_tokens, t.arrival_t)
        np.testing.assert_array_equal(j.prompt, t.prompt)


# ----------------------------------------------------------- host layers
def _schedulers(num_pages=6, page_size=4, num_slots=2, max_len=16):
    jpool = jserving.PagePool(num_layers=1, num_pages=num_pages,
                              page_size=page_size, num_kv_heads=1,
                              head_dim=2, device_arrays=False)
    tpool = tserving.PagePool(num_layers=1, num_pages=num_pages,
                              page_size=page_size, num_kv_heads=1,
                              head_dim=2, device="cpu")
    return (jserving.Scheduler(num_slots=num_slots, pool=jpool,
                               max_len=max_len),
            tserving.Scheduler(num_slots=num_slots, pool=tpool,
                               max_len=max_len))


def test_scheduler_admits_and_recycles_like_the_reference():
    """One seeded submit/admit/release script through both schedulers:
    the same slots, pages, stalls and tables at every step."""
    rng = np.random.default_rng(4)
    jsch, tsch = _schedulers()
    rid = 0
    for _ in range(40):
        op = rng.integers(3)
        if op == 0:
            n, m = int(rng.integers(1, 9)), int(rng.integers(1, 9))
            for pkg, sch in ((jserving, jsch), (tserving, tsch)):
                sch.submit(pkg.Request(rid=rid, prompt=np.ones(n, np.int32),
                                       max_new_tokens=m))
            rid += 1
        elif op == 1:
            ja, ta = jsch.admit_next(0.0), tsch.admit_next(0.0)
            assert (ja is None) == (ta is None)
            assert jsch.last_stall == tsch.last_stall
            if ja is not None:
                assert ja[0] == ta[0] and ja[1].pages == ta[1].pages
        else:
            live = tsch.active_slots()
            assert live == jsch.active_slots()
            if live:
                i = live[int(rng.integers(len(live)))]
                jsch.release(i)
                tsch.release(i)
        np.testing.assert_array_equal(jsch.page_table, tsch.page_table)
        assert jsch.pool._free == tsch.pool._free
        tsch.check_invariants()


def test_pool_refuses_double_and_null_frees():
    pool = tserving.PagePool(num_layers=1, num_pages=4, page_size=2,
                             num_kv_heads=1, head_dim=2, device="cpu")
    a = pool.alloc(3)
    assert pool.alloc(2) is None
    pool.free(a[:1])
    with pytest.raises(ValueError):
        pool.free(a[:1])
    with pytest.raises(ValueError):
        pool.free([0])


def test_scheduler_refuses_what_could_never_run():
    _, tsch = _schedulers(num_pages=2)
    with pytest.raises(ValueError):
        tsch.submit(tserving.Request(rid=0, prompt=np.ones(12, np.int32),
                                     max_new_tokens=8))     # > max_len
    with pytest.raises(ValueError):
        tsch.submit(tserving.Request(rid=1, prompt=np.ones(8, np.int32),
                                     max_new_tokens=4))     # > the pool


def test_metrics_registry_matches_the_reference():
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    rng = np.random.default_rng(0)
    for reg in (jreg, treg):
        reg.inc("a")
        reg.inc("a", 2.0, reason="no_slot")
        reg.set_gauge("g", 0.5)
        reg.observe("h", float("nan"))
    for v in rng.exponential(size=3000):
        jreg.observe("h", v)
        treg.observe("h", v)
    assert treg.snapshot() == jreg.snapshot()


# ----------------------------------------------------- page-write rules
def test_decode_leaves_a_prefilling_slots_first_page_alone(tiny_pair):
    """The null-page rule for rows that are not decoding: a slot still
    prefilling already owns pages (reserved at admission), and the
    decode step's ride-along write for its row must land in the null
    page, not in its first page."""
    _, _, tmodel = tiny_pair
    eng = _port_engine(tmodel, num_slots=2)
    short = tserving.Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                             max_new_tokens=12)
    eng.submit(short)
    eng.step(0.0)                   # short prefills and joins decode
    long = tserving.Request(rid=1, prompt=np.arange(1, 30, dtype=np.int32),
                            max_new_tokens=4)
    eng.submit(long)
    eng.pool.k.fill_(7.0)           # recognizable bytes everywhere
    eng.pool.v.fill_(7.0)
    eng.step(0.0)                   # long: chunk 1 of 4; short decodes
    slot = next(i for i in eng.scheduler.active_slots()
                if eng.scheduler.slots[i].request.rid == 1)
    st = eng.scheduler.slots[slot]
    assert st.prefilling
    first = st.pages[0]
    assert bool((eng.pool.k[:, first] == 7.0).all())
    assert bool((eng.pool.v[:, first] == 7.0).all())
    assert not bool((eng.pool.k[:, 0, 0] == 7.0).all())   # null page hit


def test_write_pages_writes_real_pages_exactly():
    """Null entries of the page row are skipped: the real pages hold the
    scratch bytes exactly, page 0 and every page not in the row keep
    theirs."""
    L, P, ps, n_kv, hd, mp = 2, 8, 4, 2, 16, 5
    pool = tserving.PagePool(num_layers=L, num_pages=P, page_size=ps,
                             num_kv_heads=n_kv, head_dim=hd, device="cpu")
    pool.k.fill_(-1.0)
    pool.v.fill_(-1.0)
    rng = np.random.default_rng(0)
    ks = torch.from_numpy(rng.standard_normal((L, mp * ps, n_kv, hd),
                                              dtype=np.float32))
    vs = torch.from_numpy(rng.standard_normal((L, mp * ps, n_kv, hd),
                                              dtype=np.float32))
    row = np.array([5, 2, 0, 0, 0], np.int32)
    pool.write_pages(row, ks, vs)
    paged_k = ks.reshape(L, mp, ps, n_kv, hd)
    paged_v = vs.reshape(L, mp, ps, n_kv, hd)
    for j, p in enumerate(row[:2]):
        assert torch.equal(pool.k[:, p], paged_k[:, j])
        assert torch.equal(pool.v[:, p], paged_v[:, j])
    for p in set(range(P + 1)) - {5, 2}:
        assert bool((pool.k[:, p] == -1.0).all()), p
        assert bool((pool.v[:, p] == -1.0).all()), p


# ----------------------------------------------------- what waits
@pytest.mark.parametrize("field", sorted(_LATER_FIELDS))
def test_serve_config_refuses_options_of_later_slices(field):
    value = {"moe_dispatch": "int8"}.get(field, True)
    with pytest.raises(NotImplementedError, match=field):
        tserving.ServeConfig(**{field: value})


@pytest.mark.parametrize("arg", sorted(_LATER_ENGINE_ARGS))
def test_engine_refuses_arguments_of_later_slices(tiny_pair, arg):
    _, _, tmodel = tiny_pair
    with pytest.raises(NotImplementedError, match=arg):
        tserving.ServingEngine(tmodel, device="cpu", **{arg: object()})


def test_engine_refuses_sampling_requests(tiny_pair):
    """The reference's rule: a greedy-only engine raises ValueError for
    a sampling request; one built with `sampling=True` takes it."""
    _, _, tmodel = tiny_pair
    req = tserving.Request(rid=0, prompt=np.ones(3, np.int32),
                           max_new_tokens=2,
                           sampling=tserving.SamplingParams(temperature=1.0))
    with pytest.raises(ValueError, match="greedy-only"):
        _port_engine(tmodel).submit(req)
    _port_engine(tmodel, sampling=True).submit(req)


@pytest.mark.parametrize("how", ["spec_decode", "draft_model"])
def test_model_drafter_waits_for_its_slice(tiny_pair, how):
    """spec_decode="model" and a draft model came with the third serving
    slice: the config takes the mode, and the engine asks for the draft
    model the mode needs and for the mode a draft model needs; a custom
    drafter needs spec_decode set."""
    _, _, tmodel = tiny_pair
    with pytest.raises(ValueError, match="draft"):
        if how == "spec_decode":
            tserving.ServingEngine(
                tmodel, tserving.ServeConfig(spec_decode="model"),
                device="cpu")
        else:
            tserving.ServingEngine(tmodel, device="cpu", draft_model=object())
    with pytest.raises(ValueError):
        tserving.ServingEngine(tmodel, device="cpu", drafter=object())


_SLICE_OF = {"moe_dispatch": "multi-GPU", "kv_repage": "multi-GPU",
             "reshard": "multi-GPU", "telemetry": "item 6"}


@pytest.mark.parametrize("name", sorted(set(_LATER_FIELDS)
                                        | set(_LATER_ENGINE_ARGS)))
def test_deferred_options_name_their_slice(tiny_pair, name):
    """Every option the port defers names the slice that brings it:
    multi-GPU (MoE dispatch, KV re-paging, the reshard hook) or the
    cluster telemetry push (ROADMAP Queue A item 6)."""
    _, _, tmodel = tiny_pair
    want = _SLICE_OF[name]
    with pytest.raises(NotImplementedError, match=want):
        if name in _LATER_FIELDS:
            tserving.ServeConfig(**{name: {"moe_dispatch": "int8"}.get(
                name, True)})
        else:
            tserving.ServingEngine(tmodel, device="cpu", **{name: object()})
    assert "prefix_cache" not in _LATER_FIELDS
    assert "draft_model" not in _LATER_ENGINE_ARGS


#: the serving host layer's options: name -> (the flag both packages
#: read it from, a value, an invalid value); None = no flag
_HOST_FIELDS = {
    "preempt": ("SERVE_PREEMPT", "1", "maybe"),
    "quotas": ("SERVE_QUOTAS", "acme:2:16,free:1", "acme:x"),
    "serve_sample": ("RUNLOG_SERVE_SAMPLE", "4", "0"),
    "retry_budget": ("SERVE_RETRY", "2", "-1"),
    "deadline": ("SERVE_DEADLINE", "on", "sometimes"),
    "brownout": ("SERVE_BROWNOUT", "true", "2"),
    "brownout_page_high": (None, 0.5, 1.5),
    "brownout_queue_min": (None, 3, 0),
    "brownout_streak": (None, 2, 0),
}
_HOST_ARGS = ("run_log", "tracer", "health", "cost_model")


def _config_view(cfg):
    out = dataclasses.asdict(cfg)
    out["quotas"] = {t: q.to_dict() for t, q in cfg.quotas.items()}
    return out


@pytest.mark.parametrize("name", sorted(set(_HOST_FIELDS) | set(_HOST_ARGS)))
def test_host_layer_option_behaves_like_the_reference(tiny_pair, name,
                                                      monkeypatch,
                                                      tmp_path):
    """Each option the serving host layer brings is taken the
    reference's way: a config field parses from its flag (HETU_TORCH_*
    in the port, HETU_TPU_* in the reference) into an equal ServeConfig
    and refuses the values the reference refuses; an engine keyword is
    wired where the reference wires it, explicitly or through the flag
    that turns it on."""
    jmodel, jparams, tmodel = tiny_pair
    if name in _HOST_FIELDS:
        flag, value, bad = _HOST_FIELDS[name]
        if flag is None:
            kw = {name: value}
            assert _config_view(tserving.ServeConfig(**kw)) == \
                _config_view(jserving.ServeConfig(**kw))
            for pkg in (tserving, jserving):
                with pytest.raises(ValueError):
                    pkg.ServeConfig(**{name: bad})
            return
        monkeypatch.setenv(f"HETU_TORCH_{flag}", value)
        monkeypatch.setenv(f"HETU_TPU_{flag}", value)
        got = tserving.ServeConfig.from_flags()
        assert _config_view(got) == _config_view(
            jserving.ServeConfig.from_flags())
        assert _config_view(got) != _config_view(tserving.ServeConfig())
        monkeypatch.setenv(f"HETU_TORCH_{flag}", bad)
        monkeypatch.setenv(f"HETU_TPU_{flag}", bad)
        for pkg in (tserving, jserving):
            with pytest.raises(ValueError):
                pkg.ServeConfig.from_flags()
        return
    from hetu_tpu.obs.health import ServingHealthMonitor as JHealth
    from hetu_tpu.obs.runlog import RunLog as JRunLog
    from hetu_tpu.serving.costs import CostModel as JCostModel
    from hetu_tpu_torch.obs.health import ServingHealthMonitor
    from hetu_tpu_torch.obs.runlog import RunLog
    from hetu_tpu_torch.serving.costs import CostModel
    cost = dict(num_params=1e6, num_layers=2, hidden_size=64,
                num_kv_heads=2, head_dim=16, page_size=8)
    explicit = {
        "run_log": (lambda: RunLog(str(tmp_path / "t.jsonl")),
                    lambda: JRunLog(str(tmp_path / "j.jsonl"))),
        "tracer": (tserving.RequestTracer, jserving.RequestTracer),
        "health": (ServingHealthMonitor, JHealth),
        "cost_model": (lambda: CostModel.from_model_dims(**cost),
                       lambda: JCostModel.from_model_dims(**cost)),
    }[name]
    attr = {"cost_model": "ledger"}.get(name, name)
    teng = tserving.ServingEngine(tmodel, tserving.ServeConfig(**ENGINE),
                                  device="cpu", **{name: explicit[0]()})
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**ENGINE),
                                  registry=JMetricsRegistry(),
                                  **{name: explicit[1]()})
    assert (getattr(teng, attr) is None) == (getattr(jeng, attr) is None)
    assert getattr(teng, attr) is not None
    if name == "cost_model":
        assert teng.ledger.model.to_dict() == jeng.ledger.model.to_dict()
        return
    # the flag gate: unset leaves it off on both sides, set turns it on
    flag = {"run_log": ("RUNLOG", str(tmp_path / "flag.jsonl")),
            "tracer": ("SERVE_TRACE", "1"),
            "health": ("HEALTH", "1")}[name]
    for on in (False, True):
        if on:
            monkeypatch.setenv(f"HETU_TORCH_{flag[0]}", flag[1])
            monkeypatch.setenv(f"HETU_TPU_{flag[0]}", flag[1])
        teng = tserving.ServingEngine(
            tmodel, tserving.ServeConfig(**ENGINE), device="cpu")
        jeng = jserving.ServingEngine(jmodel, jparams,
                                      jserving.ServeConfig(**ENGINE),
                                      registry=JMetricsRegistry())
        assert (getattr(teng, name) is not None) == on
        assert (getattr(jeng, name) is not None) == on
        teng.close()
        jeng.close()


@pytest.mark.parametrize("field,value", [("kv_quant", "int2"),
                                         ("spec_decode", "tree"),
                                         ("spec_k", 0)])
def test_serve_config_validates_like_the_reference(field, value):
    kw = {field: value}
    if field == "spec_k":
        kw["spec_decode"] = "ngram"
    with pytest.raises(ValueError):
        tserving.ServeConfig(**kw)
    with pytest.raises(ValueError):
        jserving.ServeConfig(**kw)
