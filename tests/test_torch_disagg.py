"""Disaggregated prefill/decode and the replica frontend of the port
(hetu_tpu_torch/serving/disagg.py, frontend.py) against the JAX
reference, on the CPU — the scenarios of the reference's own
`tests/test_disagg.py`.

The tiny Llama of `test_torch_parity` (fp32, the reference's weights)
serves everything.  The two-tier pipeline and the frontend must emit
the colocated engine's tokens (clean, under the shipment storm and
prefill kills, with a dead tier, across a replica kill and hedging);
the coordinator's protocol summary and the wire's bytes equal the
reference's on the same trace and plan; the channel, the scheduler's
dedupe gate and the shipment pack behave as the reference's do.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.chaos.plan import FaultPlan as JFaultPlan
from hetu_tpu.chaos.plan import FaultSpec as JFaultSpec
from hetu_tpu.obs.metrics import MetricsRegistry as JRegistry
from hetu_tpu.serving import disagg as jdisagg
from hetu_tpu_torch import serving
from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from hetu_tpu_torch.obs.critpath import critical_path
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import RunLog
from hetu_tpu_torch.obs.spans import FleetTrace
from hetu_tpu_torch.serving.disagg import (DisaggCoordinator, PrefillWorker,
                                           Shipment, ShipmentChannel,
                                           pack_shipment, unpack_shipment)
from hetu_tpu_torch.serving.frontend import Frontend
from hetu_tpu_torch.serving.kv_pool import PagePool
from hetu_tpu_torch.serving.request import TenantQuota
from hetu_tpu_torch.serving.scheduler import Scheduler
from hetu_tpu_torch.serving.tracing import RequestTracer
from test_torch_parity import jax_llama_and_port

CFG = dict(num_slots=2, page_size=8, max_len=32, prefill_chunk=8)

#: the reference's storm: the wire drops, duplicates and delays
#: shipments and drops acks; the prefill tier dies twice
STORM = [dict(kind="shipment_drop", op="ship", after_calls=1, count=2,
              prob=1.0),
         dict(kind="shipment_dup", op="ship", after_calls=4, count=2,
              prob=1.0),
         dict(kind="shipment_delay", op="ship", after_calls=7, count=2,
              prob=1.0, delay_s=2.0),
         dict(kind="shipment_drop", op="ack", after_calls=2, count=2,
              prob=1.0),
         dict(kind="prefill_kill", at_step=6),
         dict(kind="prefill_kill", at_step=9, count=4)]


@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=0)


def _requests(pkg, *, sampled=False, n=8, seed=11):
    classes = [pkg.SLOClass("gold", priority=2), pkg.SLOClass("bulk")]
    sampling = (pkg.SamplingParams(temperature=0.8, top_k=16, seed=77)
                if sampled else None)
    return pkg.synthetic_requests(
        n, vocab_size=256, prompt_lens=(3, 10), max_new=(4, 8),
        slo_classes=classes, sampling=sampling, seed=seed)


def _engine(model, **kw):
    return serving.ServingEngine(model, serving.ServeConfig(**CFG, **kw),
                                 registry=MetricsRegistry(), device="cpu")


def _two_tier(model, *, plan=None, sampled=False, retry_budget=2,
              ship_quant="none", **coord_kw):
    decode = _engine(model, retry_budget=retry_budget,
                     **({"sampling": True} if sampled else {}))
    worker = PrefillWorker(model, prefill_chunk=8, max_len=32,
                           sampling=sampled, registry=decode.registry,
                           device="cpu")
    coord = DisaggCoordinator(worker, decode, plan=plan,
                              ship_quant=ship_quant, **coord_kw)
    return coord, decode


def _ref_two_tier(pair, *, plan=None, retry_budget=2):
    jmodel, jparams, _ = pair
    decode = jserving.ServingEngine(
        jmodel, jparams, jserving.ServeConfig(**CFG,
                                              retry_budget=retry_budget),
        registry=JRegistry())
    worker = jdisagg.PrefillWorker(jmodel, jparams, prefill_chunk=8,
                                   max_len=32, registry=decode._registry)
    return jdisagg.DisaggCoordinator(worker, decode, plan=plan,
                                     ship_quant="none"), decode


@pytest.fixture(scope="module")
def gold(pair):
    """The colocated engine's tokens, greedy and sampled."""
    out = {}
    for mode in ("greedy", "sampled"):
        eng = _engine(pair[2], **({"sampling": True}
                                  if mode == "sampled" else {}))
        out[mode] = {r.rid: r.tokens for r in eng.run(
            _requests(serving, sampled=mode == "sampled"))}
    return out


def _counters(reg):
    return {c["name"]: c["value"] for c in reg.snapshot()["counters"]}


# ------------------------------------------------------- token identity
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_disagg_clean_token_identical_to_colocated(pair, gold, mode):
    coord, decode = _two_tier(pair[2], sampled=mode == "sampled")
    res = coord.run(_requests(serving, sampled=mode == "sampled"))
    assert {r.rid: r.tokens for r in res} == gold[mode]
    s = coord.summary()
    assert s["adoptions"] == len(gold[mode]) <= s["ship_sent"]
    assert len(coord.ship_pack_s) == len(coord.ship_adopt_s) \
        == len(coord.ship_wall_s) == s["adoptions"]
    decode.scheduler.check_invariants()
    assert decode.pool.free_count == decode.pool.num_pages
    assert coord.prefill.idle and not coord.prefill._live


@pytest.mark.parametrize("plan", ["clean", "storm"])
def test_disagg_summary_equals_the_reference(pair, gold, plan):
    """The protocol's accounting on the same trace and plan — sends,
    drops, dups, delays, dedupes, resends, adoptions, re-prefills,
    colocations, degraded steps and the wire's bytes (fp32 scratch both
    sides) — equals the reference coordinator's, and so do the
    counters; the storm's survivors keep the colocated tokens."""
    mk = (lambda F, S: F([S(**f) for f in STORM], seed=0)) \
        if plan == "storm" else (lambda F, S: None)
    coord, decode = _two_tier(pair[2], plan=mk(FaultPlan, FaultSpec),
                              retry_budget=3)
    jcoord, jdecode = _ref_two_tier(pair, plan=mk(JFaultPlan, JFaultSpec),
                                    retry_budget=3)
    res = coord.run(_requests(serving))
    jres = jcoord.run(_requests(jserving))
    got, want = coord.summary(), jcoord.summary()
    got.pop("degraded_s"), want.pop("degraded_s")
    assert got == want
    assert [(r.rid, r.tokens, r.finished_reason) for r in res] == \
        [(r.rid, r.tokens, r.finished_reason) for r in jres]
    assert {k: v for k, v in _counters(decode.registry).items()
            if k.startswith("serve.")} == \
        {k: v for k, v in _counters(jdecode._registry).items()
         if k.startswith("serve.")}
    for r in res:
        if r.finished_reason in ("length", "eos"):
            assert r.tokens == gold["greedy"][r.rid]
    if plan == "storm":
        assert got["ship_dropped"] >= 2 and got["ship_duped"] >= 2
        assert got["ship_resends"] >= 1 and got["ship_dedups"] >= 1
        assert got["degraded_steps"] > 0
    decode.scheduler.check_invariants()
    assert decode.scheduler.retries == {}


def test_disagg_dead_tier_colocates_everything(pair, gold):
    plan = FaultPlan([FaultSpec(kind="prefill_kill", at_step=0,
                                count=100_000)])
    coord, decode = _two_tier(pair[2], plan=plan)
    res = coord.run(_requests(serving))
    assert {r.rid: r.tokens for r in res} == gold["greedy"]
    s = coord.summary()
    assert s["colocated"] == len(res) and s["adoptions"] == 0
    assert s["ship_sent"] == 0 and s["degraded_steps"] > 0
    decode.scheduler.check_invariants()


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_disagg_quantized_wire_completes_within_error(pair, quant):
    dense, _ = _two_tier(pair[2])
    dense.run(_requests(serving, n=4, seed=5))
    coord, decode = _two_tier(pair[2], ship_quant=quant)
    res = coord.run(_requests(serving, n=4, seed=5))
    assert len(res) == 4
    assert all(r.finished_reason in ("length", "eos") for r in res)
    q_bytes, d_bytes = (coord.summary()["ship_bytes"],
                        dense.summary()["ship_bytes"])
    assert 0 < q_bytes < d_bytes
    if quant == "int4":
        assert q_bytes < d_bytes / 4
    decode.scheduler.check_invariants()


def test_disagg_retry_budget_exhaustion_terminates(pair):
    plan = FaultPlan([FaultSpec(kind="shipment_drop", op="ship",
                                after_calls=0, count=10_000, prob=1.0)])
    coord, decode = _two_tier(pair[2], plan=plan, retry_budget=1,
                              ship_timeout=1, ship_retry=1)
    res = coord.run(_requests(serving, n=3, seed=21))
    assert [r.finished_reason for r in res] == ["retry_exhausted"] * 3
    assert all(r.tokens == [] for r in res)
    assert coord.summary()["reprefills"] >= 3
    assert decode.scheduler.retries == {}
    assert _counters(decode.registry)["serve.retry_exhausted"] == 3
    decode.scheduler.check_invariants()


# ------------------------------------------------------ protocol units
def test_shipment_pack_round_trip_and_wire_bytes_equal_the_reference():
    """The same scratch through both packs: the payloads and scales are
    bit-equal, `wire_bytes` equal, and the unpacked values equal the
    reference's (int4 and none exactly; int8 to fp32 rounding) and sit
    within each wire's quantization grid."""
    rng = np.random.default_rng(0)
    ks = rng.normal(size=(4, 6, 2, 16)).astype(np.float32)
    vs = rng.normal(size=(4, 6, 2, 16)).astype(np.float32)
    req = serving.Request(rid=7, prompt=np.ones(6, np.int32),
                          max_new_tokens=4)
    jreq = jserving.Request(rid=7, prompt=np.ones(6, np.int32),
                            max_new_tokens=4)
    ships = {}
    for q in ("none", "int8", "int4"):
        ship = pack_shipment(3, req, 0, 6, torch.from_numpy(ks),
                             torch.from_numpy(vs), quant=q)
        jship = jdisagg.pack_shipment(3, jreq, 0, 6, ks, vs, quant=q)
        assert (ship.seq, ship.rid, ship.quant) == (3, 7, q)
        assert ship.ks.device.type == "cpu"
        assert ship.wire_bytes == jship.wire_bytes
        np.testing.assert_array_equal(ship.ks.numpy(), jship.ks)
        if q != "none":
            np.testing.assert_array_equal(ship.k_scale.numpy(),
                                          jship.k_scale)
        bk, bv = unpack_shipment(ship)
        jk, _ = jdisagg.unpack_shipment(jship)
        np.testing.assert_allclose(bk.numpy(), jk, rtol=1e-6, atol=0)
        grid = {"none": 1e-12, "int8": 1.0 / 254.0, "int4": 1.0 / 14.0}[q]
        bound = np.abs(ks).max(axis=-1, keepdims=True) * grid + 1e-6
        assert (np.abs(bk.numpy() - ks) <= bound).all(), q
        ships[q] = ship
    assert (ships["none"].wire_bytes > ships["int8"].wire_bytes
            > ships["int4"].wire_bytes)
    with pytest.raises(ValueError):
        pack_shipment(1, req, 0, 6, torch.from_numpy(ks),
                      torch.from_numpy(vs), quant="fp8")


def _channel_plan(F, S):
    return F([S(kind="shipment_drop", op="ship", after_calls=0, count=1,
                prob=1.0),
              S(kind="shipment_dup", op="ship", after_calls=1, count=1,
                prob=1.0),
              S(kind="shipment_delay", op="ship", after_calls=2, count=1,
                prob=1.0, delay_s=3.0),
              S(kind="shipment_drop", op="ack", after_calls=0, count=1,
                prob=1.0)], seed=0)


def test_shipment_channel_drop_dup_delay_and_acks():
    def mk(seq):
        return Shipment(seq=seq, rid=0, attempt=0, t1=4, quant="none",
                        ks=torch.zeros(1), vs=torch.zeros(1))

    ch = ShipmentChannel(plan=_channel_plan(FaultPlan, FaultSpec))
    jch = jdisagg.ShipmentChannel(plan=_channel_plan(JFaultPlan,
                                                     JFaultSpec))
    for c, make in ((ch, mk), (jch, lambda seq: jdisagg.Shipment(
            seq=seq, rid=0, attempt=0, t1=4, quant="none",
            ks=np.zeros(1, np.float32), vs=np.zeros(1, np.float32)))):
        assert not c.send(make(1), step=0)          # eaten by the wire
        assert c.send(make(2), step=0)              # duplicated
        assert c.send(make(3), step=0)              # delayed 3 steps
        assert c.send(make(4), step=0)              # clean
        ships, acks = c.poll(step=1)
        assert [s.seq for s in ships] == [2, 2, 4] and acks == []
        ships, _ = c.poll(step=4)
        assert [s.seq for s in ships] == [3]
        assert not c.send_ack(2, step=3)            # dropped ack
        assert c.send_ack(4, step=3)
        _, acks = c.poll(step=4)
        assert acks == [4]
        c.requeue(make(9), step=4)                  # no fault consult
        ships, _ = c.poll(step=5)
        assert [s.seq for s in ships] == [9] and c.idle
    counts = ("sent", "dropped", "duped", "delayed", "acks_sent",
              "acks_dropped")
    assert [getattr(ch, k) for k in counts] == \
        [getattr(jch, k) for k in counts] == [4, 1, 1, 1, 2, 1]


def test_scheduler_shipment_dedupe_gate_and_rollback():
    pool = PagePool(num_pages=8, page_size=4, num_layers=1,
                    num_kv_heads=1, head_dim=4, device="cpu")
    sched = Scheduler(num_slots=1, pool=pool, max_len=16)
    req = serving.Request(rid=1, prompt=np.ones(4, np.int32),
                          max_new_tokens=4)
    assert sched.apply_shipment(1, 10)
    assert not sched.apply_shipment(1, 10)          # redelivery
    adm = sched.admit_direct(req, 0.0)
    assert adm is not None
    assert not sched.apply_shipment(1, 11), "live rid must refuse"
    req2 = serving.Request(rid=2, prompt=np.ones(4, np.int32),
                           max_new_tokens=4)
    assert sched.apply_shipment(2, 12)
    assert sched.admit_direct(req2, 0.0) is None
    assert sched.last_stall == "no_slot"
    sched.unapply_shipment(2, 12)
    assert sched.apply_shipment(2, 12), "unapply must un-burn the seq"
    sched.unapply_shipment(2, 12)
    with pytest.raises(ValueError):
        sched.admit_direct(req, 0.0)
    sched.release(adm[0])
    sched.ship_forget(1)
    assert not sched.apply_shipment(1, 10)
    sched.check_invariants()
    assert pool.free_count == pool.num_pages


def test_prefill_tier_keeps_one_scratch_per_live_prefill(pair):
    """Two live prefills never share a scratch, and a kill frees both."""
    w = PrefillWorker(pair[2], prefill_chunk=8, max_len=32, device="cpu")
    for rid in range(3):                     # three chunks a prompt
        w.submit(serving.Request(rid=rid, prompt=np.arange(1, 21),
                                 max_new_tokens=4))
    w.step()
    live = list(w._live.values())
    assert len(live) == 2
    assert live[0].cache[0].data_ptr() != live[1].cache[0].data_ptr()
    assert sorted(w.kill()) == [0, 1, 2] and w.idle


# ------------------------------------------------------------ frontend
def test_frontend_failover_token_identical(pair):
    model = pair[2]
    gold = {r.rid: r.tokens
            for r in _engine(model).run(_requests(serving, n=10))}
    plan = FaultPlan([FaultSpec(kind="engine_kill", rank=1, at_step=3,
                                count=4)])
    engines = [_engine(model, retry_budget=2) for _ in range(2)]
    fe = Frontend(engines, plan=plan, registry=MetricsRegistry())
    res = fe.run(_requests(serving, n=10))
    assert {r.rid: r.tokens for r in res} == gold
    assert all(r.finished_reason in ("length", "eos") for r in res)
    assert fe.summary()["reroutes"] >= 1
    for eng in engines:
        eng.scheduler.check_invariants()


def test_frontend_hedge_dedupe_and_traces_stitch(pair, tmp_path):
    """Hedging on congested one-slot replicas: one result a rid, the
    single engine's tokens, and the hops plus the frontend's events
    stitch into per-rid DAGs whose critical path sums to e2e."""
    model = pair[2]
    gold = {r.rid: r.tokens
            for r in _engine(model).run(_requests(serving, n=12, seed=3))}
    path = str(tmp_path / "hedge.jsonl")
    log = RunLog(path)
    engines = [serving.ServingEngine(
        model, serving.ServeConfig(**dict(CFG, num_slots=1)),
        registry=MetricsRegistry(), run_log=log if i == 0 else None,
        tracer=RequestTracer(keep=True), device="cpu") for i in range(2)]
    fe = Frontend(engines, hedge_after=2, registry=MetricsRegistry())
    res = fe.run(_requests(serving, n=12, seed=3))
    log.close()
    assert len(res) == len({r.rid for r in res}) == 12
    assert {r.rid: r.tokens for r in res} == gold
    s = fe.summary()
    assert s["hedges"] >= 1 and s["hedges"] >= s["hedge_wins"]
    hops = engines[0].tracer.completed + engines[1].tracer.completed
    fts = FleetTrace.stitch(RunLog.read(path), traces=hops)
    assert set(fts) == {r.rid for r in res}
    forks = 0
    for rid, ft in sorted(fts.items()):
        ft.validate()
        assert ft.span_seconds == pytest.approx(ft.lifetime_seconds)
        cp = critical_path(ft)
        assert abs(cp["residual_s"]) < 1e-9, rid
        forks += "hedge_fork" in {e["kind"] for e in ft.edges}
    assert forks >= 1


def test_frontend_kill_with_hedge_copies_keeps_one_slot_a_rid(pair):
    """One-slot replicas with hedging, and replica 0 killed while its
    queued requests' hedge copies run on replica 1: those copies carry
    on alone, never resubmitted beside themselves (the reference's
    reroute puts such a rid both queued and live on replica 1).  The
    schedulers' invariants hold after every router step; one result a
    rid, the single engine's tokens."""
    model = pair[2]
    gold = {r.rid: r.tokens
            for r in _engine(model).run(_requests(serving, n=12, seed=3))}
    engines = [serving.ServingEngine(
        model, serving.ServeConfig(**dict(CFG, num_slots=1),
                                   retry_budget=2),
        registry=MetricsRegistry(), device="cpu") for _ in range(2)]
    plan = FaultPlan([FaultSpec(kind="engine_kill", rank=0, at_step=3,
                                count=2)])
    fe = Frontend(engines, plan=plan, hedge_after=2,
                  registry=MetricsRegistry())
    held, holder = [], fe._holder

    def holder_seen(rid, exclude):
        h = holder(rid, exclude)
        held.append(h is not None)
        return h
    fe._holder = holder_seen
    step = fe.step

    def checked_step(now):
        out = step(now)
        for eng in engines:
            eng.scheduler.check_invariants()
        return out
    fe.step = checked_step
    res = fe.run(_requests(serving, n=12, seed=3))
    assert len(res) == len({r.rid for r in res}) == 12
    assert {r.rid: r.tokens for r in res} == gold
    assert sum(held) >= 1, "no queued request had a live hedge copy"
    s = fe.summary()
    assert s["hedges"] >= 1 and s["reroutes"] >= 1


def test_frontend_drain_rejoin_and_fleet_quota(pair):
    model = pair[2]
    engines = [_engine(model) for _ in range(2)]
    fe = Frontend(engines, registry=MetricsRegistry())
    fe.drain(0)
    assert len(fe.run(_requests(serving, n=4, seed=7))) == 4
    assert _counters(engines[0].registry).get("serve.requests_done",
                                              0) == 0
    fe.rejoin(0)
    assert not fe.replicas[0].draining
    engines = [_engine(model) for _ in range(2)]
    fe = Frontend(engines, quotas={"t0": TenantQuota("t0", max_slots=1)},
                  registry=MetricsRegistry())
    reqs = _requests(serving, n=8, seed=13)
    for r in reqs:
        r.tenant = "t0"
    live = []
    orig = fe.step

    def step(now):
        out = orig(now)
        live.append(sum(len(e.scheduler.active_slots()) for e in engines))
        return out
    fe.step = step
    assert len(fe.run(reqs)) == 8
    assert fe.quota_holds > 0 and max(live) == 1


def test_frontend_refuses_replicas_of_two_devices(pair):
    class Meta:
        device = torch.device("meta")
        tracer = None
    with pytest.raises(ValueError, match="devices"):
        Frontend([_engine(pair[2]), Meta()])
