"""The training engine of the port (`hetu_tpu/engine` counterparts)."""
from hetu_tpu_torch.engine.trainer import Trainer  # noqa: F401
from hetu_tpu_torch.engine.trainer_config import TrainingConfig  # noqa: F401
