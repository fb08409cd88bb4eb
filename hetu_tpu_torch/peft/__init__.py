"""Parameter-efficient fine-tuning (`hetu_tpu/peft` counterparts)."""
from hetu_tpu_torch.peft.lora import (LoRAConfig, LoRAWrappedModel,  # noqa: F401
                                      MultiLoRAManager, init_lora_params,
                                      merge_lora_params)
