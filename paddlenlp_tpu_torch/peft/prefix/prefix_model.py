"""Prefix tuning over the port's LLaMA-family models.

Port of ``paddlenlp_tpu/peft/prefix/prefix_model.py``: one learned tensor
``prefix_kv`` [L, 2, P, n_kv, head_dim] (keys and values of P virtual tokens
for every layer) sits in the parameter tree beside the frozen base. Where the
JAX package pre-fills a static ``KVCache`` with it, the port's training
forward concatenates it ahead of each layer's keys and values
(``LlamaForCausalLM.hidden_states``), so the gradient reaches it; the
arithmetic is the cached path's (the cache's dtype, query offset P, P ones
ahead of a padding mask, rope positions 0..T-1, the dense attention). Only
the prefix trains.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from ..facade import AdapterFacade

__all__ = ["PrefixConfig", "PrefixModelForCausalLM"]

PREFIX_WEIGHTS_NAME = "prefix_model.safetensors"
PREFIX_CONFIG_NAME = "prefix_config.json"


@dataclasses.dataclass
class PrefixConfig:
    num_prefix_tokens: int = 64
    init_std: float = 0.02

    def save_pretrained(self, d: str):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, PREFIX_CONFIG_NAME), "w") as f:
            json.dump(dataclasses.asdict(self), f)

    @classmethod
    def from_pretrained(cls, d: str):
        with open(os.path.join(d, PREFIX_CONFIG_NAME)) as f:
            return cls(**json.load(f))


class PrefixModelForCausalLM(AdapterFacade):
    """Wraps a port causal LM: ``params`` is the base tree plus ``prefix_kv``
    (fp32, on the model's device, drawn from ``np.random.default_rng(0)``
    times ``init_std`` as in the JAX package). Its directory holds
    ``prefix_config.json`` and ``prefix_kv`` alone."""

    WEIGHTS_NAME = PREFIX_WEIGHTS_NAME
    CONFIG_CLASS = PrefixConfig

    def __init__(self, model, prefix_config: Optional[PrefixConfig] = None, params: Optional[dict] = None):
        self.model = model
        self.prefix_config = self.peft_config = prefix_config or PrefixConfig()
        self.config = cfg = model.config
        if params is not None:
            self.params = params
        else:
            P = self.prefix_config.num_prefix_tokens
            n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
            head_dim = getattr(cfg, "head_dim", cfg.hidden_size // cfg.num_attention_heads)
            rng = np.random.default_rng(0)
            prefix_kv = rng.standard_normal((cfg.num_hidden_layers, 2, P, n_kv, head_dim)).astype(np.float32) \
                * self.prefix_config.init_std
            self.params = dict(model.params)
            self.params["prefix_kv"] = torch.from_numpy(prefix_kv).to(model.device)
        self.generation_config = model.generation_config

    @staticmethod
    def _trainable(path: str) -> bool:
        return path.startswith("prefix_kv")

    # ------------------------------------------------------------------ forward
    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, attention_mask=None,
                position_ids=None, segment_ids=None) -> torch.Tensor:
        """The base model's training forward behind the prefix: logits
        [B, T, V] for the input tokens, differentiable in ``prefix_kv``."""
        params = dict(self.params if params is None else params)
        prefix_kv = params.pop("prefix_kv")
        return self.model.forward(input_ids, params=params, position_ids=position_ids, segment_ids=segment_ids,
                                  attention_mask=attention_mask, prefix_kv=prefix_kv)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, attention_mask=None, params: Optional[dict] = None) -> torch.Tensor:
        """:meth:`forward` without a gradient."""
        return self.forward(input_ids, params=params, attention_mask=attention_mask)
