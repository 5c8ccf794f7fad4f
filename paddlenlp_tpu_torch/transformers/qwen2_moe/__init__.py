from .configuration import Qwen2MoeConfig  # noqa: F401
from .modeling import Qwen2MoeForCausalLM  # noqa: F401
