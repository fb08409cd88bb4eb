"""The training engine of the port (`hetu_tpu/engine` counterparts)."""
from hetu_tpu_torch.engine.trainer import Trainer  # noqa: F401
from hetu_tpu_torch.engine.trainer_config import TrainingConfig  # noqa: F401
from hetu_tpu_torch.engine.sft_trainer import (  # noqa: F401
    SFTTrainer, mask_prompt_labels)
