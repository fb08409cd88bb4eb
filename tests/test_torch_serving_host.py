"""The serving host layers of the port (hetu_tpu_torch/serving: SLO
preemption, tenant quotas, retry/failover, deadlines, brownout, serve
sampling; the run log, tracer, health and cost ledger the engine takes)
against the JAX reference's engine, on the CPU.

Both engines get the same seeded trace and the same weights (the tiny
Llama of `test_torch_parity`, fp32) and must agree on everything the
clock does not decide: tokens, finish reasons, `serve.*` counters, span
kinds and stall reasons, run-log records key for key, and the cost
ledger's FLOP and wire fields.  Times are wall-clock on both sides and
are never compared.  Contention is made deterministic by letting every
request arrive at once (admission order is then the rid order), and the
deadline scenario starts the run's clock past every bulk deadline.
"""
from __future__ import annotations

import numpy as np
import pytest

from hetu_tpu import serving as jserving
from hetu_tpu.chaos.inject import maybe_chaos_serving as jchaos
from hetu_tpu.chaos.plan import FaultPlan as JFaultPlan
from hetu_tpu.chaos.plan import FaultSpec as JFaultSpec
from hetu_tpu.obs.health import ServingHealthMonitor as JHealth
from hetu_tpu.obs.metrics import MetricsRegistry as JRegistry
from hetu_tpu.obs.runlog import RunLog as JRunLog
from hetu_tpu.serving.costs import CostModel as JCostModel
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.chaos.inject import maybe_chaos_serving
from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from hetu_tpu_torch.obs.health import ServingHealthMonitor
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import RunLog
from hetu_tpu_torch.serving import slo_report
from hetu_tpu_torch.serving.costs import COST_FIELDS, CostModel
from test_torch_parity import jax_llama_and_port

ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)

#: record fields the wall clock decides (never compared)
TIMED = {"t", "now", "ttft_s", "e2e_s", "queue_wait_s", "tokens_per_s",
         "elapsed_s", "cost_page_s", "cost_kv_byte_s", "t0", "t1",
         "trace", "dur_s", "pause_s", "degraded_s", "value", "baseline"}


@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=0)


def _cost(pkg_cost):
    return pkg_cost.from_model_dims(num_params=1e6, num_layers=2,
                                    hidden_size=64, num_kv_heads=2,
                                    head_dim=16, page_size=8)


def _trace(pkg, *, n=10, classes=None, sampled=False, arrive=0.0):
    """Every request arrives at `arrive`; SLO classes round-robin by rid,
    tenants a, a, b, b; with `sampled` the even rids sample."""
    classes = classes or [pkg.SLOClass("gold", priority=2),
                          pkg.SLOClass("bulk")]
    reqs = pkg.synthetic_requests(
        n, vocab_size=256, prompt_lens=(3, 20), max_new=(3, 9),
        arrivals=np.full(n, arrive), slo_classes=classes,
        tenants=["a", "a", "b", "b"], seed=7)
    if sampled:
        for r in reqs[::2]:
            r.sampling = pkg.SamplingParams(temperature=0.8, top_k=16,
                                            top_p=0.95, seed=100 + r.rid)
    return reqs


def _run(side, model_or_pair, cfg, reqs, tmp_path, *, kill_at=None,
         start=0.0):
    """One engine run with every host keyword on; returns its results,
    registry, run-log records, tracer and engine."""
    ref = side == "ref"
    pkg = jserving if ref else tserving
    log = (JRunLog if ref else RunLog)(str(tmp_path / f"{side}.jsonl"))
    reg = (JRegistry if ref else MetricsRegistry)()
    tracer = pkg.RequestTracer(run_log=log, registry=reg, keep=True)
    health = (JHealth if ref else ServingHealthMonitor)(runlog=log,
                                                        registry=reg)
    kw = dict(run_log=log, registry=reg, tracer=tracer, health=health,
              cost_model=_cost(JCostModel if ref else CostModel))
    if ref:
        jmodel, jparams, _ = model_or_pair
        eng = pkg.ServingEngine(jmodel, jparams, pkg.ServeConfig(**cfg),
                                **kw)
    else:
        eng = pkg.ServingEngine(model_or_pair[2], pkg.ServeConfig(**cfg),
                                device="cpu", **kw)
    on_step = None
    if kill_at is not None:
        plan = (JFaultPlan if ref else FaultPlan)(
            [(JFaultSpec if ref else FaultSpec)(kind="engine_kill",
                                                at_step=kill_at)])
        chaos = jchaos if ref else maybe_chaos_serving

        def on_step(i):
            chaos(plan, eng, i)
            eng.scheduler.check_invariants()
    res = eng.run(reqs, start=start, on_step=on_step)
    eng.scheduler.check_invariants()
    log.close()
    return dict(res=res, reg=reg, recs=(JRunLog if ref else RunLog).read(
        str(tmp_path / f"{side}.jsonl")), tracer=tracer, eng=eng)


def _counters(reg):
    return {(c["name"], tuple(sorted(c.get("labels", {}).items()))):
            c["value"] for c in reg.snapshot()["counters"]
            if c["name"].startswith("serve.")}


def _spans(tracer):
    return {rid: [(s.kind, s.attrs.get("reason"), s.attrs.get("attempt"),
                   s.slot) for s in tr.spans]
            for rid, tr in tracer.traces.items()}


def _untimed(rec):
    return {k: v for k, v in rec.items() if k not in TIMED}


@pytest.fixture(scope="module")
def policies(pair, tmp_path_factory):
    """Preemption, quotas (tenant b: one slot), serve sampling 1-in-2,
    a retry budget of one and an engine kill at step 6, half the
    requests sampled; every host keyword on."""
    cfg = dict(ENGINE, sampling=True, preempt=True, serve_sample=2,
               retry_budget=1)
    out = {}
    for side, pkg in (("ref", jserving), ("port", tserving)):
        c = dict(cfg, quotas=pkg.parse_quotas("b:1"))
        out[side] = _run(side, pair, c, _trace(pkg, sampled=True),
                         tmp_path_factory.mktemp(side), kill_at=6)
    # the undisturbed, policy-free run of the same trace on the port
    base = tserving.ServingEngine(pair[2], tserving.ServeConfig(
        **ENGINE, sampling=True), device="cpu")
    out["base"] = base.run(_trace(tserving, sampled=True))
    return out


@pytest.fixture(scope="module")
def sheds(pair, tmp_path_factory):
    """Deadlines (bulk's passed before the run's clock starts) and
    brownout (a 12-page pool, watermark 0.5, a streak of 2) over three
    classes."""
    cfg = dict(ENGINE, num_pages=12, deadline=True, brownout=True,
               brownout_page_high=0.5, brownout_queue_min=1,
               brownout_streak=2)
    out = {}
    for side, pkg in (("ref", jserving), ("port", tserving)):
        classes = [pkg.SLOClass("gold", priority=2),
                   pkg.SLOClass("bulk", deadline_s=1.0),
                   pkg.SLOClass("std", priority=1)]
        out[side] = _run(side, pair, cfg, _trace(pkg, n=12,
                                                 classes=classes),
                         tmp_path_factory.mktemp(side), start=10.0)
    return out


# --------------------------------------------------------------- policies
@pytest.mark.parametrize("scenario", ["policies", "sheds"])
def test_tokens_and_finish_reasons_equal_the_reference(request, scenario):
    run = request.getfixturevalue(scenario)
    ref, port = run["ref"]["res"], run["port"]["res"]
    assert [r.rid for r in port] == [r.rid for r in ref]
    for t, j in zip(port, ref):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
        assert t.finished_reason == j.finished_reason
        assert (t.stats.preemptions, t.stats.retries,
                t.stats.prefill_chunks) == (j.stats.preemptions,
                                            j.stats.retries,
                                            j.stats.prefill_chunks)


@pytest.mark.parametrize("scenario", ["policies", "sheds"])
def test_serve_counters_equal_the_reference(request, scenario):
    run = request.getfixturevalue(scenario)
    assert _counters(run["port"]["reg"]) == _counters(run["ref"]["reg"])


def test_policies_fire_and_replay_the_undisturbed_tokens(policies):
    """The scenario really exercises every policy, and every request
    ends with the tokens of the undisturbed run (greedy and sampled):
    preemption and failover replay from the prompt."""
    c = {k[0]: v for k, v in _counters(policies["port"]["reg"]).items()
         if not k[1]}
    assert c["serve.preemptions"] > 0 and c["serve.failovers"] == 1
    assert c["serve.replica_requeues"] > 0
    stalls = _counters(policies["port"]["reg"])
    assert stalls[("serve.admission_stalls",
                   (("reason", "quota_exceeded"),))] > 0
    base = {r.rid: r.tokens for r in policies["base"]}
    for r in policies["port"]["res"]:
        assert r.finished_reason == "length"
        assert r.tokens == base[r.rid]
    assert policies["port"]["eng"].scheduler.retries == {}


def test_sheds_fire(sheds):
    reasons = {r.finished_reason for r in sheds["port"]["res"]}
    assert {"deadline_exceeded", "brownout_shed", "length"} <= reasons
    for r in sheds["port"]["res"]:
        if r.finished_reason != "length":
            assert r.tokens == [] or r.finished_reason == \
                "deadline_exceeded"


@pytest.mark.parametrize("scenario", ["policies", "sheds"])
def test_span_kinds_and_stall_reasons_equal_the_reference(request,
                                                          scenario):
    run = request.getfixturevalue(scenario)
    assert _spans(run["port"]["tracer"]) == _spans(run["ref"]["tracer"])
    for tr in run["port"]["tracer"].traces.values():
        tr.validate()


@pytest.mark.parametrize("scenario", ["policies", "sheds"])
def test_run_log_records_equal_the_reference_key_for_key(request,
                                                         scenario):
    run = request.getfixturevalue(scenario)
    ref = [r for r in run["ref"]["recs"] if r["kind"] in ("serve", "span",
                                                          "anomaly")]
    port = [r for r in run["port"]["recs"] if r["kind"] in ("serve",
                                                            "span",
                                                            "anomaly")]
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    assert [_untimed(r) for r in port] == [_untimed(r) for r in ref]


def test_serve_sample_keeps_the_reference_requests(policies):
    """serve_sample=2: the per-request events of the hashed half of the
    rids, stamped sample_weight=2 — the same rids on both sides."""
    def sampled(recs):
        return sorted({r["req"] for r in recs if r["kind"] == "serve"
                       and r.get("event") == "done"})
    got = sampled(policies["port"]["recs"])
    assert got == sampled(policies["ref"]["recs"])
    assert 0 < len(got) < len(policies["port"]["res"])
    assert all(r.get("sample_weight") == 2 for r in policies["port"]["recs"]
               if r["kind"] == "serve" and r.get("event") == "done")


def test_cost_fields_equal_the_reference(policies):
    def costs(recs):
        return {r["req"]: {k: r[k] for k in COST_FIELDS
                           if k not in TIMED}
                for r in recs if r["kind"] == "serve"
                and r.get("event") == "done"}
    port, ref = costs(policies["port"]["recs"]), costs(
        policies["ref"]["recs"])
    assert port == ref and port
    for r in policies["port"]["recs"]:
        if r["kind"] == "serve" and r.get("event") == "done":
            assert r["cost_page_s"] > 0 and r["cost_kv_byte_s"] > 0


def test_slo_report_reconciles_every_request(policies):
    """The port's slo_report over the port's run log: every request's
    spans tile its e2e with zero residual, and the report's sections
    match the reference's report of the reference's log."""
    port = slo_report.serving_report(policies["port"]["recs"])
    ref = jserving.serving_report(policies["ref"]["recs"])
    assert port["reconciliation"]["max_residual_s"] < 1e-9
    for key in ("requests", "tokens_out", "preemptions", "failover"):
        assert port[key] == ref[key], key
    assert set(port["classes"]) == set(ref["classes"])


# -------------------------------------------------------------- numerics
def test_numerics_kv_pages_snr_equals_the_reference(pair, tmp_path,
                                                    monkeypatch):
    """HETU_TORCH_NUMERICS on int8 pages: the engine records the
    reference's scopes (the decode step's logits stats and the kv_pages
    quantization SNR) at the same steps.  The values agree to 2e-3,
    except the quantization residual: the two models' K and V differ
    by ~1e-4 relative after a layer attends over int8 pages, and the
    residual power of ~400 values moves by up to a few percent with
    them (the quantizers themselves are bit-equal), so err_pow is held
    to 5% and snr_db to 0.25 dB."""
    monkeypatch.setenv("HETU_TPU_NUMERICS", "1")
    monkeypatch.setenv("HETU_TORCH_NUMERICS", "1")
    cfg = dict(ENGINE, kv_quant="int8")
    got = {}
    for side, pkg in (("ref", jserving), ("port", tserving)):
        run = _run(side, pair, cfg, _trace(pkg, n=4), tmp_path)
        got[side] = [r for r in run["recs"] if r["kind"] == "numerics"]
    assert len(got["port"]) == len(got["ref"]) > 0
    for t, j in zip(got["port"], got["ref"]):
        assert t["step"] == j["step"]
        assert set(t["scopes"]) == set(j["scopes"]) >= {"kv_pages",
                                                        "logits"}
        for scope, stats in j["scopes"].items():
            assert set(t["scopes"][scope]) == set(stats)
            for name, v in stats.items():
                tol = {"err_pow": dict(rtol=5e-2),
                       "snr_db": dict(atol=0.25)}.get(
                           name, dict(rtol=2e-3, atol=1e-5))
                np.testing.assert_allclose(t["scopes"][scope][name], v,
                                           err_msg=f"{scope}.{name}",
                                           **tol)
