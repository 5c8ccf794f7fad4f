"""LLaMA-family model zoo of the PyTorch port (LLaMA, Qwen2)."""

from .configuration_utils import LlmMetaConfig, PretrainedConfig  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .qwen2 import Qwen2Config, Qwen2ForCausalLM  # noqa: F401
