from .configuration import MixtralConfig  # noqa: F401
from .modeling import MixtralForCausalLM  # noqa: F401
