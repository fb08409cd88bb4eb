"""LLaMA, the port of `hetu_tpu/models/llama`."""
from hetu_tpu_torch.models.llama.config import LlamaConfig  # noqa: F401
from hetu_tpu_torch.models.llama.from_jax import load_jax_params  # noqa: F401
from hetu_tpu_torch.models.llama.model import LlamaLMHeadModel  # noqa: F401

__all__ = ["LlamaConfig", "LlamaLMHeadModel", "load_jax_params"]
