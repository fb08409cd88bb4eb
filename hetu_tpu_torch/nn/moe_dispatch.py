"""Expert-parallel MoE dispatch, the port of `hetu_tpu/nn/moe_dispatch.py`:
its single-device part.

The reference's `HETU_TPU_MOE_DISPATCH` picks the token -> expert
transport over the `ep` mesh axis: "gspmd" (the default) leaves the
collectives to the compiler; "fp32", "int8" and "int4" run an explicit
all-to-all and all-gather (quantized under the int modes).  With no ep
axis every mode resolves to "gspmd" — single-device serving decode is
the canonical MoE program — and that is the port's one device.  The
port reads `HETU_TORCH_MOE_DISPATCH` (the same type, default and
choices); the explicit transports arrive with the multi-GPU slice.
"""
from __future__ import annotations

from hetu_tpu_torch.utils import flags

#: HETU_TORCH_MOE_DISPATCH values; "gspmd" = the constraint-based path
MODES = ("gspmd", "fp32", "int8", "int4")

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


def dispatch_mode() -> str:
    """The HETU_TORCH_MOE_DISPATCH flag value."""
    return flags.str_flag("HETU_TORCH_MOE_DISPATCH")


def resolved_mode(ep: int = 1) -> str:
    """The dispatch a forward takes: the flag, demoted to "gspmd" when
    there is no ep axis to dispatch over (ep <= 1, the port's one
    device)."""
    mode = dispatch_mode()
    if mode != "gspmd" and ep <= 1:
        return "gspmd"
    return mode


def explicit_forward(*args, **kwargs):
    """The reference's shard_map dispatch over the ep axis (quantized
    all-to-all + all-gather, hierarchical under a two-level topology)."""
    raise NotImplementedError(
        f"the explicit expert-parallel dispatch arrives with {_MULTI_GPU}")
