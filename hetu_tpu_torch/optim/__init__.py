"""Optimizers of the port (`hetu_tpu/optim` counterparts): AdamW with
the fused CUDA update, global-norm clipping and the LR schedules."""
from hetu_tpu_torch.optim.optimizer import (  # noqa: F401
    Adam, AdamW, clip_by_global_norm, constant_schedule, cosine_schedule)
