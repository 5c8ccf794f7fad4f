"""Qwen2 causal LM: the LLaMA graph with q/k/v biases (see ``Qwen2Config``).

Port of ``paddlenlp_tpu/transformers/qwen2/modeling.py``: the deltas live in
the config (``attention_bias``/``attention_out_bias``), which
:class:`~..llama.modeling.LlamaForCausalLM` and the sequence classifier
already honour.
"""

from __future__ import annotations

from ..llama.modeling import LlamaForCausalLM, LlamaForSequenceClassification
from .configuration import Qwen2Config

__all__ = ["Qwen2ForCausalLM", "Qwen2ForSequenceClassification"]


class Qwen2ForCausalLM(LlamaForCausalLM):
    config_class = Qwen2Config


class Qwen2ForSequenceClassification(LlamaForSequenceClassification):
    """JAX ``qwen2/modeling.py:43``: the LLaMA classifier under ``Qwen2Config``."""

    config_class = Qwen2Config
