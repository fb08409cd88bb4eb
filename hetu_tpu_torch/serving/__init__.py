"""Serving subsystem of the port: continuous batching + paged KV cache
(`hetu_tpu/serving` counterparts), with the serving host layers (SLO
classes and preemption, tenant quotas, failover, deadlines, brownout,
tracing, costs), disaggregated prefill/decode and the replica
frontend.

    from hetu_tpu_torch import serving
    eng = serving.ServingEngine(model, serving.ServeConfig(num_slots=8),
                                device="cuda").warmup()
    results = eng.run(serving.synthetic_requests(16, vocab_size=256,
                                                 seed=0))
"""
from hetu_tpu_torch.serving.costs import (COST_FIELDS,  # noqa: F401
                                          CostLedger, CostModel,
                                          aggregate_costs)
from hetu_tpu_torch.serving.disagg import (DisaggCoordinator,  # noqa: F401
                                           PrefillWorker, Shipment,
                                           ShipmentChannel, pack_shipment,
                                           unpack_shipment)
from hetu_tpu_torch.serving.engine import (ServeConfig,  # noqa: F401
                                           ServingEngine,
                                           first_token_from_logits)
from hetu_tpu_torch.serving.fleet import (FleetConfig,  # noqa: F401
                                          FleetSimulator, ServiceModel,
                                          analytic_models, attainment_delta,
                                          fleet_workload)
from hetu_tpu_torch.serving.frontend import Frontend  # noqa: F401
from hetu_tpu_torch.serving.kv_pool import (PagePool,  # noqa: F401
                                            kv_bytes_per_token)
from hetu_tpu_torch.serving.request import (DEFAULT_SLO, GREEDY,  # noqa: F401
                                            Request, RequestResult,
                                            RequestStats, SamplingParams,
                                            SLOClass, TenantQuota,
                                            parse_quotas, rid_sampled)
from hetu_tpu_torch.serving.scheduler import Scheduler, SlotState  # noqa: F401
from hetu_tpu_torch.serving.slo_report import (render_text,  # noqa: F401
                                               serving_report)
from hetu_tpu_torch.serving.traces import (bursty_arrivals,  # noqa: F401
                                           poisson_arrivals,
                                           synthetic_requests)
from hetu_tpu_torch.serving.tracing import (RequestTracer,  # noqa: F401
                                            maybe_tracer)

__all__ = [
    "ServingEngine", "ServeConfig", "first_token_from_logits",
    "DisaggCoordinator", "PrefillWorker", "Shipment", "ShipmentChannel",
    "pack_shipment", "unpack_shipment", "Frontend",
    "FleetSimulator", "FleetConfig", "ServiceModel", "analytic_models",
    "attainment_delta", "fleet_workload",
    "CostModel", "CostLedger", "COST_FIELDS", "aggregate_costs",
    "PagePool", "kv_bytes_per_token",
    "Request", "RequestResult", "RequestStats", "SLOClass", "DEFAULT_SLO",
    "SamplingParams", "GREEDY", "TenantQuota", "parse_quotas",
    "rid_sampled", "Scheduler", "SlotState", "RequestTracer",
    "maybe_tracer", "serving_report", "render_text",
    "poisson_arrivals", "bursty_arrivals", "synthetic_requests",
]
