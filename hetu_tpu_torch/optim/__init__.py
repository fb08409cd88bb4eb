"""Optimizers of the port (`hetu_tpu/optim` counterparts): AdamW with
the fused CUDA update, global-norm clipping, the LR schedules and the
dynamic loss scale."""
from hetu_tpu_torch.optim.grad_scaler import (  # noqa: F401
    GradScaler, classify_transition)
from hetu_tpu_torch.optim.optimizer import (  # noqa: F401
    Adam, AdamW, clip_by_global_norm, constant_schedule, cosine_schedule)
