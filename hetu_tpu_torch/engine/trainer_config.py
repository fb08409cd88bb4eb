"""Training configuration, copied from `hetu_tpu/engine/trainer_config.py`
(host-only code; the port keeps its own copy so it never imports the
JAX package).

The reference's fields keep their names and defaults.  Those whose
non-default values need a later slice of the port raise
NotImplementedError naming it; none is accepted and ignored.
`packing` is the reference's own flag, and the reference's trainer
reads it nowhere either: a packed batch carries its packing in its
`position_ids` (restarting at each packed sequence) and `segment_ids`
(the sequence of each token, 0 for padding), which `data.pack_sequences`
and `data.DataCollatorForLanguageModel(packing=True)` make and the
`Trainer` hands to the model with every micro-batch.  `seed`
seeds the dropout masks (keyed as the reference's `fold_in(key(seed +
1), step)`); the weights are drawn by the model
(`LlamaLMHeadModel(seed=...)`, `GPTLMHeadModel(seed=...)`), where the
reference's `Trainer.build` draws them from `seed` too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


@dataclasses.dataclass
class TrainingConfig:
    # batch geometry
    global_batch_size: int = 32
    micro_batch_size: int = 4          # per-dp-replica micro batch
    seq_len: int = 1024
    packing: bool = False              # batches packed (module docstring)

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

    # the dropout masks' seed; the port's model draws its own weights
    # (LlamaLMHeadModel(seed=...), GPTLMHeadModel(seed=...))
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
        if self.pp_schedule == "1f1b":
            raise NotImplementedError(
                f"TrainingConfig.pp_schedule={self.pp_schedule!r} is not in "
                f"the port yet; it arrives with {_MULTI_GPU}")
        if isinstance(self.seed, bool) or not isinstance(self.seed, int):
            raise ValueError(f"TrainingConfig.seed must be an int, got "
                             f"{self.seed!r}")

    def num_micro_batches(self, dp: int) -> int:
        denom = self.micro_batch_size * dp
        if self.global_batch_size % denom:
            raise ValueError(
                f"global_batch_size={self.global_batch_size} must divide by "
                f"micro_batch_size*dp={denom}")
        return self.global_batch_size // denom
