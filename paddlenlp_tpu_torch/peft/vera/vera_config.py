"""VeRA config: a copy of ``paddlenlp_tpu/peft/vera/vera_config.py``."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

__all__ = ["VeRAConfig"]

DEFAULT_TARGETS = ["q_proj", "k_proj", "v_proj", "o_proj"]


@dataclasses.dataclass
class VeRAConfig:
    r: int = 64
    d_initial: float = 0.1
    target_modules: Optional[List[str]] = None
    seed: int = 0

    def save_pretrained(self, save_directory: str):
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, "vera_config.json"), "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_pretrained(cls, path: str) -> "VeRAConfig":
        with open(os.path.join(path, "vera_config.json")) as f:
            return cls(**json.load(f))
