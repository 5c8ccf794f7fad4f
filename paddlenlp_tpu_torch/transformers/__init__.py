"""LLaMA-family model zoo of the PyTorch port (LLaMA, Qwen2, Mistral, the
MoE families Mixtral and Qwen2-MoE, and DeepSeek-V2), the Auto
classes, ``PretrainedModel`` and the tokenizer."""

from .auto import (  # noqa: F401
    AutoConfig,
    AutoModel,
    AutoModelForCausalLM,
    AutoModelForCausalLMPipe,
    AutoModelForMaskedLM,
    AutoModelForSequenceClassification,
    AutoModelForTokenClassification,
    AutoTokenizer,
)
from .cache_utils import KVCache, init_cache  # noqa: F401
from .configuration_utils import LlmMetaConfig, PretrainedConfig  # noqa: F401
from .deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM, DeepseekV2Model  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM, LlamaForSequenceClassification  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM, MistralForSequenceClassification, MistralModel  # noqa: F401
from .mixtral import MixtralConfig, MixtralForCausalLM  # noqa: F401
from .model_utils import PretrainedModel  # noqa: F401
from .qwen2 import Qwen2Config, Qwen2ForCausalLM, Qwen2ForSequenceClassification  # noqa: F401
from .qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM  # noqa: F401
from .tokenizer_utils import BatchEncoding, PretrainedTokenizer  # noqa: F401
