"""The port's fleet simulator and trace readers (hetu_tpu_torch/serving/
fleet.py, slo_report.py, obs/spans.py, critpath.py, trace.py) against
the JAX reference's, on the CPU — after the reference's own
`tests/test_fleet.py`.

The simulator drives the port's real scheduler, page pool, quotas,
preemption and tracer on an analytic clock, so with the same `hw=`
profile, seed and workload its JSON report is byte-identical to the
reference's; the readers, given the same records, give the same
reports, critical paths and chrome traces.
"""
from __future__ import annotations

import json

import pytest

from hetu_tpu.chaos.plan import FaultPlan as JFaultPlan
from hetu_tpu.chaos.plan import FaultSpec as JFaultSpec
from hetu_tpu.obs import critpath as jcritpath
from hetu_tpu.obs import trace as jtrace
from hetu_tpu.obs.spans import FleetTrace as JFleetTrace
from hetu_tpu.serving import fleet as jfleet
from hetu_tpu.serving import request as jrequest
from hetu_tpu.serving import slo_report as jslo
from hetu_tpu.serving import traces as jtraces
from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from hetu_tpu_torch.obs import critpath, trace
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import RunLog
from hetu_tpu_torch.obs.spans import FleetTrace
from hetu_tpu_torch.serving import fleet, request, slo_report, traces

#: one small chip profile, passed to both simulators
HW = {"bf16_tflops": 100.0, "hbm_gbps": 800.0}


def _models(mod, page_size=8):
    return mod.analytic_models(num_params=1e8, num_layers=4,
                               hidden_size=256, num_kv_heads=2,
                               head_dim=32, page_size=page_size, hw=HW)


def _workload(mod, req_mod, n, seed=0, **kw):
    kwargs = dict(rate_per_s=500.0, burst=8,
                  tenants=("acme", "bigco", "free"),
                  slo_classes=[req_mod.SLOClass("gold", ttft_s=0.5,
                                                token_gap_s=0.25,
                                                priority=2),
                               req_mod.SLOClass("bulk", deadline_s=0.05)],
                  prompt_lens=(4, 24), max_new=(2, 8), seed=seed)
    kwargs.update(kw)
    return mod.fleet_workload(n, **kwargs)


def _config(mod, req_mod, **kw):
    kwargs = dict(num_slots=8, page_size=8, max_len=64, prefill_chunk=8,
                  preempt=True, quotas=req_mod.parse_quotas("free:2:16"),
                  invariant_every=101, sample=1)
    kwargs.update(kw)
    return mod.FleetConfig(**kwargs)


#: report variants: quotas + preemption; deadlines + brownout + a
#: replica kill under a retry budget; the two-tier topology under a
#: shipment storm
VARIANTS = {
    "policies": dict(),
    "faults": dict(deadline=True, brownout=True, brownout_page_high=0.5,
                   brownout_streak=2, retry_budget=2,
                   faults=[dict(kind="engine_kill", at_step=40, count=5),
                           dict(kind="slow_worker", rank=0, at_step=10,
                                count=20, delay_s=0.01)]),
    "disagg": dict(disagg=True, prefill_slots=4, retry_budget=2,
                   faults=[dict(kind="shipment_drop", op="ship",
                                after_calls=3, count=4, prob=1.0),
                           dict(kind="prefill_kill", at_step=30,
                                count=6)]),
}


def _report(side, variant, n=2000, seed=7, run_log=None, registry=None):
    ref = side == "ref"
    mod, req_mod = (jfleet, jrequest) if ref else (fleet, request)
    kw = dict(VARIANTS[variant])
    faults = kw.pop("faults", None)
    plan = None
    if faults:
        plan = (JFaultPlan if ref else FaultPlan)(
            [(JFaultSpec if ref else FaultSpec)(**f) for f in faults],
            seed=0)
    svc, cost = _models(mod)
    sim = mod.FleetSimulator(svc, config=_config(mod, req_mod, **kw),
                             cost_model=cost, fault_plan=plan,
                             run_log=run_log, registry=registry)
    return sim.run(_workload(mod, req_mod, n, seed=seed))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fleet_report_is_byte_identical_to_the_reference(variant):
    got = json.dumps(_report("port", variant), indent=2, sort_keys=True)
    want = json.dumps(_report("ref", variant), indent=2, sort_keys=True)
    assert got == want
    rep = json.loads(got)
    assert rep["invariants"]["ok"]
    assert rep["trace_check"]["max_residual_s"] < 1e-9
    if variant == "faults":
        assert rep["faults"]["failovers"] == 1
        assert rep["faults"]["deadline_exceeded"] > 0
    if variant == "disagg":
        assert rep["disagg"]["adoptions"] > 0


@pytest.fixture(scope="module")
def fleet_log(tmp_path_factory):
    """One sampled two-tier fleet run's run log (every event of a
    1-in-3 sample of the rids), from the port's simulator."""
    path = str(tmp_path_factory.mktemp("fleet") / "fleet.jsonl")
    log = RunLog(path)
    VARIANTS["disagg_sampled"] = dict(VARIANTS["disagg"], sample=3)
    try:
        rep = _report("port", "disagg_sampled", n=600, run_log=log,
                      registry=MetricsRegistry())
    finally:
        VARIANTS.pop("disagg_sampled")
    log.close()
    return rep, RunLog.read(path)


def test_slo_report_equals_the_reference(fleet_log):
    _, recs = fleet_log
    got = slo_report.serving_report(recs, per_request=True)
    want = jslo.serving_report(recs, per_request=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["disagg"] is not None
    assert slo_report.render_text(got) == jslo.render_text(want)


def test_critical_paths_equal_the_reference(fleet_log):
    _, recs = fleet_log
    fts, jfts = FleetTrace.stitch(recs), JFleetTrace.stitch(recs)
    assert sorted(fts) == sorted(jfts) and fts
    paths = {rid: critpath.critical_path(ft) for rid, ft in fts.items()}
    jpaths = {rid: jcritpath.critical_path(ft) for rid, ft in jfts.items()}
    assert json.dumps(paths, sort_keys=True, default=str) == \
        json.dumps(jpaths, sort_keys=True, default=str)
    assert max(abs(p["residual_s"]) for p in paths.values()) < 1e-9
    assert json.dumps(critpath.rollup(list(paths.values())),
                      sort_keys=True) == json.dumps(
        jcritpath.rollup(list(jpaths.values())), sort_keys=True)


def test_serving_and_stitched_traces_equal_the_reference(fleet_log):
    _, recs = fleet_log
    assert trace.serving_trace(recs).to_json() == \
        jtrace.serving_trace(recs).to_json()
    assert trace.stitched_trace(FleetTrace.stitch(recs)).to_json() == \
        jtrace.stitched_trace(JFleetTrace.stitch(recs)).to_json()


def test_pipeline_schedule_renders_wait_for_their_slice():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        trace.pipeline_schedule_trace(2, 4)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        trace.schedule_bubble_fraction(2, 4, schedule="gpipe")


def test_service_model_defaults_to_the_h100_datasheet_profile():
    """No `hw=`: the port prices on the H100 datasheet peaks (989 dense
    bf16 TFLOP/s, 3.35 TB/s); `hw=` overrides it as in the reference."""
    dims = dict(num_params=8.03e9, num_layers=32, hidden_size=4096,
                num_kv_heads=8, head_dim=128, kv_mode="bf16")
    svc = fleet.ServiceModel.from_hardware_profile(**dims)
    assert (svc.peak_flops, svc.hbm_bytes_per_s) == (989e12, 3.35e12)
    assert fleet.H100_PROFILE["source"] == "datasheet"
    assert fleet.ServiceModel.from_hardware_profile(
        hw=HW, **dims).to_dict() == jfleet.ServiceModel.from_hardware_profile(
            hw=HW, **dims).to_dict()
    # roofline monotonicity: more slots or context never gets faster
    assert svc.decode_step_s(8, 4096) >= svc.decode_step_s(4, 4096)
    assert svc.decode_step_s(8, 8192) >= svc.decode_step_s(8, 4096)


def test_rid_sampling_arrivals_and_parsers_equal_the_reference():
    for n in (1, 2, 7, 1000):
        assert [request.rid_sampled(r, n) for r in range(5000)] == \
            [jrequest.rid_sampled(r, n) for r in range(5000)]
    assert traces.bursty_arrivals(64, 50.0, burst=8, seed=3).tolist() == \
        jtraces.bursty_arrivals(64, 50.0, burst=8, seed=3).tolist()
    q = request.parse_quotas("acme:2:16, free:1")
    assert {t: v.to_dict() for t, v in q.items()} == \
        {t: v.to_dict() for t, v in
         jrequest.parse_quotas("acme:2:16, free:1").items()}
    assert request.SLOClass.parse("gold:0.2:-:2:30").to_dict() == \
        jrequest.SLOClass.parse("gold:0.2:-:2:30").to_dict()
    for bad in ("a:b:c:d:e:f", ":1"):
        with pytest.raises(ValueError):
            request.SLOClass.parse(bad)
        with pytest.raises(ValueError):
            jrequest.SLOClass.parse(bad)
    for bad in ("acme:x", "acme:1,acme:2", "acme:-1"):
        with pytest.raises(ValueError):
            request.parse_quotas(bad)
        with pytest.raises(ValueError):
            jrequest.parse_quotas(bad)
