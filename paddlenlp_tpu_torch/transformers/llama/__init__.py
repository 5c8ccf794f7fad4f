from .configuration import LlamaConfig  # noqa: F401
from .modeling import LlamaForCausalLM, LlamaForSequenceClassification  # noqa: F401
