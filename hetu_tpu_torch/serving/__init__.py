"""Serving subsystem of the port: continuous batching + paged KV cache
(`hetu_tpu/serving` counterparts).

    from hetu_tpu_torch import serving
    eng = serving.ServingEngine(model, serving.ServeConfig(num_slots=8),
                                device="cuda").warmup()
    results = eng.run(serving.synthetic_requests(16, vocab_size=256,
                                                 seed=0))
"""
from hetu_tpu_torch.serving.engine import (ServeConfig,  # noqa: F401
                                           ServingEngine,
                                           first_token_from_logits)
from hetu_tpu_torch.serving.kv_pool import PagePool  # noqa: F401
from hetu_tpu_torch.serving.request import (DEFAULT_SLO, GREEDY,  # noqa: F401
                                            Request, RequestResult,
                                            RequestStats, SamplingParams,
                                            SLOClass)
from hetu_tpu_torch.serving.scheduler import Scheduler, SlotState  # noqa: F401
from hetu_tpu_torch.serving.traces import (poisson_arrivals,  # noqa: F401
                                           synthetic_requests)

__all__ = [
    "ServingEngine", "ServeConfig", "first_token_from_logits",
    "PagePool", "Request", "RequestResult", "RequestStats", "SLOClass",
    "DEFAULT_SLO", "SamplingParams", "GREEDY", "Scheduler", "SlotState",
    "poisson_arrivals", "synthetic_requests",
]
