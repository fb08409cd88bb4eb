"""GPT-2/3, the port of `hetu_tpu/models/gpt`."""
from hetu_tpu_torch.models.from_jax import load_jax_params  # noqa: F401
from hetu_tpu_torch.models.gpt.config import GPTConfig  # noqa: F401
from hetu_tpu_torch.models.gpt.model import GPTLMHeadModel  # noqa: F401

__all__ = ["GPTConfig", "GPTLMHeadModel", "load_jax_params"]
