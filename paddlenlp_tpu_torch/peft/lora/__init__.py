from .lora_config import LoRAConfig  # noqa: F401
from .lora_model import LoRAModel  # noqa: F401
