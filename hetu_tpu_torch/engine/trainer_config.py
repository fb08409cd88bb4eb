"""Training configuration, copied from `hetu_tpu/engine/trainer_config.py`
(host-only code; the port keeps its own copy so it never imports the
JAX package).

The reference's fields keep their names and defaults.  Those whose
non-default values need a later slice of the port raise
NotImplementedError naming it; none is accepted and ignored.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_TRAINING_3 = "the third training slice (ROADMAP Queue A item 2)"
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


@dataclasses.dataclass
class TrainingConfig:
    # batch geometry
    global_batch_size: int = 32
    micro_batch_size: int = 4          # per-dp-replica micro batch
    seq_len: int = 1024
    packing: bool = False

    # optimization
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0

    # logging / checkpoint
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1000
    ckpt_keep: int = 3

    # the reference draws its params from it in Trainer.build; the
    # port's model draws its own (LlamaLMHeadModel(seed=...)), and a
    # step without dropout draws nothing
    seed: int = 0
    dropout_deterministic: bool = True  # pretraining default: no dropout

    # pipeline schedule when strategy.pp > 1: "gpipe" or "1f1b"
    pp_schedule: str = "gpipe"

    # AMP loss scaling: "auto" = a dynamic GradScaler iff the model
    # computes in float16; "dynamic" = always on; "none" = always off
    loss_scale: str = "auto"

    def __post_init__(self):
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pp_schedule must be 'gpipe' or '1f1b', got "
                             f"{self.pp_schedule!r}")
        if self.loss_scale not in ("auto", "dynamic", "none"):
            raise ValueError(f"loss_scale must be auto|dynamic|none, got "
                             f"{self.loss_scale!r}")
        later = {
            "packing": (self.packing, _TRAINING_3),
            "ckpt_dir": (self.ckpt_dir is not None, _TRAINING_3),
            "dropout_deterministic": (not self.dropout_deterministic,
                                      _TRAINING_3),
            "loss_scale": (self.loss_scale == "dynamic", _TRAINING_3),
            "pp_schedule": (self.pp_schedule == "1f1b", _MULTI_GPU),
        }
        for name, (refused, slice_) in later.items():
            if refused:
                raise NotImplementedError(
                    f"TrainingConfig.{name}={getattr(self, name)!r} is not "
                    f"in the port yet; it arrives with {slice_}")
        if self.seed != 0:
            raise ValueError(
                "TrainingConfig.seed: the port's Trainer draws nothing; "
                "draw the weights with LlamaLMHeadModel(seed=...)")

    def num_micro_batches(self, dp: int) -> int:
        denom = self.micro_batch_size * dp
        if self.global_batch_size % denom:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} must divide by "
                f"micro_batch_size*dp={denom}")
        return self.global_batch_size // denom
