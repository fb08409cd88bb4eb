"""The dtype policy, the port of `hetu_tpu/core/dtypes.py` on torch
dtypes.

Parameters (and the optimizer) in `param_dtype`, activations and
matrix products in `compute_dtype`, softmax, losses and large
reductions in `reduce_dtype`: fp32 / bf16 / fp32 by default, as the
reference's.  The models' configs carry `param_dtype` and
`compute_dtype` and hand them out as a policy (`config.policy`): the
models cast their embeddings to the compute dtype through it, the
`Trainer` reads it where it decides the loss scale (a float16 compute
dtype turns the dynamic scale on under `loss_scale="auto"`) and refuses
a float16 parameter dtype, and the `ServingEngine` where it refuses a
float16 compute dtype.  The kernel wrappers pick their fp32, bf16 or
fp16 arm from the tensors' dtype.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy (the reference's autocast analog).

    param_dtype:   dtype parameters are stored in (and the optimizer
                   runs in).
    compute_dtype: dtype activations and matrix products run in.
    reduce_dtype:  dtype of softmax, loss and large reductions.
    """

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    reduce_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        """A floating tensor (fp32, bf16, fp16) in the compute dtype;
        anything else unchanged."""
        if x.dtype in (torch.float32, torch.bfloat16, torch.float16):
            return x.to(self.compute_dtype)
        return x


#: the models' default: bf16 compute over fp32 parameters
DEFAULT_POLICY = DTypePolicy()
