from .configuration import Qwen2Config  # noqa: F401
from .modeling import Qwen2ForCausalLM, Qwen2ForSequenceClassification  # noqa: F401
