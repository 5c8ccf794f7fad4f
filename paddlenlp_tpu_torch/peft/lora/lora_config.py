"""LoRA configuration: a copy of ``paddlenlp_tpu/peft/lora/lora_config.py``."""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional

__all__ = ["LoRAConfig", "DEFAULT_TARGETS"]

LORA_CONFIG_NAME = "lora_config.json"


@dataclasses.dataclass
class LoRAConfig:
    r: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.0
    target_modules: Optional[List[str]] = None  # regexes over param paths; None -> arch default
    rslora: bool = False  # scale alpha/sqrt(r)
    lora_plus_scale: float = 1.0  # LoRA+ lr ratio for B matrices
    trainable_bias: bool = False
    merge_weights: bool = False

    @property
    def scaling(self) -> float:
        return self.lora_alpha / (math.sqrt(self.r) if self.rslora else self.r)

    def save_pretrained(self, save_directory: str):
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, LORA_CONFIG_NAME), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_pretrained(cls, directory: str) -> "LoRAConfig":
        with open(os.path.join(directory, LORA_CONFIG_NAME)) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


DEFAULT_TARGETS = [r"self_attn/(q_proj|k_proj|v_proj|o_proj)/kernel$", r"mlp/(gate_proj|up_proj|down_proj)/kernel$"]
