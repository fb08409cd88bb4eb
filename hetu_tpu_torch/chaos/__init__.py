"""Deterministic fault injection for the port's serving paths
(`hetu_tpu/chaos` counterparts): the `FaultPlan` schedule and the
serving injection points."""
from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec  # noqa: F401

__all__ = ["FaultPlan", "FaultSpec"]
