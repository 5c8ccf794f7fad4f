"""Parameter-efficient fine-tuning of the PyTorch port: LoRA adapters.

Copy of ``paddlenlp_tpu/peft/``'s LoRA half. Prefix tuning and VeRA are not
part of the port yet.
"""

from .lora import LoRAConfig, LoRAModel  # noqa: F401
