"""``GenerationConfig``: a copy of ``paddlenlp_tpu/generation/configuration_utils.py``.

``from_pretrained`` reads a local directory (or a ``generation_config.json``
path); the port downloads nothing, so a hub id raises ``FileNotFoundError``.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict

from ..utils.env import GENERATION_CONFIG_NAME
from ..utils.log import logger

__all__ = ["GenerationConfig"]


class GenerationConfig:
    def __init__(self, **kwargs):
        self.max_length = kwargs.pop("max_length", 20)
        self.max_new_tokens = kwargs.pop("max_new_tokens", None)
        self.min_length = kwargs.pop("min_length", 0)
        self.min_new_tokens = kwargs.pop("min_new_tokens", None)
        self.do_sample = kwargs.pop("do_sample", False)
        self.num_beams = kwargs.pop("num_beams", 1)
        self.num_beam_groups = kwargs.pop("num_beam_groups", 1)
        self.temperature = kwargs.pop("temperature", 1.0)
        self.top_k = kwargs.pop("top_k", 50)
        self.top_p = kwargs.pop("top_p", 1.0)
        self.repetition_penalty = kwargs.pop("repetition_penalty", 1.0)
        self.presence_penalty = kwargs.pop("presence_penalty", 0.0)
        self.frequency_penalty = kwargs.pop("frequency_penalty", 0.0)
        self.no_repeat_ngram_size = kwargs.pop("no_repeat_ngram_size", None)
        self.length_penalty = kwargs.pop("length_penalty", 1.0)
        self.early_stopping = kwargs.pop("early_stopping", False)
        self.num_return_sequences = kwargs.pop("num_return_sequences", 1)
        self.pad_token_id = kwargs.pop("pad_token_id", None)
        self.bos_token_id = kwargs.pop("bos_token_id", None)
        self.eos_token_id = kwargs.pop("eos_token_id", None)
        self.decode_strategy = kwargs.pop("decode_strategy", None)  # reference naming
        self.use_cache = kwargs.pop("use_cache", True)
        self.trunc_input = kwargs.pop("trunc_input", True)
        self._from_model_config = kwargs.pop("_from_model_config", False)
        for k, v in kwargs.items():
            try:
                setattr(self, k, v)
            except AttributeError:
                logger.warning(f"can't set generation config key {k}")

    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy({k: v for k, v in self.__dict__.items()})

    def update(self, **kwargs) -> Dict[str, Any]:
        unused = {}
        for k, v in kwargs.items():
            if hasattr(self, k) or not k.startswith("_"):
                setattr(self, k, v)
            else:
                unused[k] = v
        return unused

    def save_pretrained(self, save_directory: str):
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, GENERATION_CONFIG_NAME), "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True, default=str)

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> "GenerationConfig":
        path = str(pretrained_model_name_or_path)
        if os.path.isdir(path):
            path = os.path.join(path, GENERATION_CONFIG_NAME)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no {GENERATION_CONFIG_NAME} at {pretrained_model_name_or_path!r}: the port "
                                    "reads local directories only and downloads nothing")
        with open(path) as f:
            return cls(**{**json.load(f), **kwargs})

    @classmethod
    def from_model_config(cls, model_config) -> "GenerationConfig":
        return cls(
            bos_token_id=getattr(model_config, "bos_token_id", None),
            eos_token_id=getattr(model_config, "eos_token_id", None),
            pad_token_id=getattr(model_config, "pad_token_id", None),
            _from_model_config=True,
        )

    def __repr__(self):
        return f"GenerationConfig {json.dumps(self.to_dict(), indent=2, default=str)}"
