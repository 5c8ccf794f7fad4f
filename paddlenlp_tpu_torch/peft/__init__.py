"""Parameter-efficient fine-tuning of the PyTorch port: LoRA, prefix tuning
and VeRA (the exports of ``paddlenlp_tpu/peft/``)."""

from .lora import LoRAConfig, LoRAModel  # noqa: F401
from .prefix import PrefixConfig, PrefixModelForCausalLM  # noqa: F401
from .vera import VeRAConfig, VeRAModel  # noqa: F401
