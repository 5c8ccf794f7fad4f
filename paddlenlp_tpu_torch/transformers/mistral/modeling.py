"""Mistral in PyTorch.

Port of ``paddlenlp_tpu/transformers/mistral/modeling.py``: the LLaMA graph
with ``config.sliding_window`` (4096 by default), which every attention call
of the dense forwards honours. The paged engine serves mistral over the
LLaMA graph and takes no window, as the JAX engine
(``paddlenlp_tpu/experimental/inference_model.py:91-92``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..llama.modeling import LlamaForCausalLM, LlamaForSequenceClassification
from ..model_utils import PretrainedModel
from .configuration import MistralConfig

__all__ = ["MistralModel", "MistralForCausalLM", "MistralForSequenceClassification"]


class MistralForCausalLM(LlamaForCausalLM):
    config_class = MistralConfig


class MistralForSequenceClassification(LlamaForSequenceClassification):
    config_class = MistralConfig


class MistralModel(PretrainedModel):
    """The backbone (JAX ``MistralModel``, ``LlamaModule``): the final-norm
    hidden states [B, T, D], no head. Its tree is the causal model's
    ``model`` subtree at the root (``embed_tokens``, ``layers``, ``norm``),
    as the JAX base model's, so its HF keys have no ``model.`` prefix."""

    config_class = MistralConfig

    @classmethod
    def param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        return {k[len("model/"):]: v for k, v in MistralForCausalLM.param_shapes(config).items()
                if k.startswith("model/")}

    @classmethod
    def _check_config(cls, config):
        MistralForCausalLM._check_config(config)

    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, position_ids=None,
                segment_ids=None, attention_mask=None) -> torch.Tensor:
        """Differentiable: the causal model's :meth:`~LlamaForCausalLM.hidden_states`
        over this tree, in ``compute_dtype``."""
        trunk = MistralForCausalLM(self.config, {"model": self.params if params is None else params})
        trunk.compute_dtype = self.compute_dtype
        return trunk.hidden_states(input_ids, position_ids=position_ids, segment_ids=segment_ids,
                                   attention_mask=attention_mask)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, attention_mask=None, params: Optional[dict] = None) -> torch.Tensor:
        """:meth:`forward` without a gradient."""
        return self.forward(input_ids, params=params, attention_mask=attention_mask)
