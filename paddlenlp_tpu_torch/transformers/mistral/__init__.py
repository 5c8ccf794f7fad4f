from .configuration import MistralConfig  # noqa: F401
from .modeling import MistralForCausalLM, MistralForSequenceClassification, MistralModel  # noqa: F401
