"""Qwen2-MoE causal LM in PyTorch.

Port of ``paddlenlp_tpu/transformers/qwen2_moe/modeling.py``: the qwen2
attention (q/k/v biases) with the MoE block of ``moe_layers.py`` as ``mlp``
(router ``gate``, experts ``gate_proj``/``up_proj``/``down_proj``) plus the
always-on shared expert and its sigmoid gate. HF keys: the experts stack
layers x experts (``mlp.experts.{e}.{proj}.weight``), the shared expert is
``mlp.shared_expert.{proj}.weight`` and its gate
``mlp.shared_expert_gate.weight`` (``:60-99``).
"""

from __future__ import annotations

from ..conversion_utils import StackedLayerMapping, auto_name_mappings
from ..llama.modeling import LlamaForCausalLM
from ..moe_layers import MoEMixin
from .configuration import Qwen2MoeConfig

__all__ = ["Qwen2MoeForCausalLM"]


class Qwen2MoeForCausalLM(MoEMixin, LlamaForCausalLM):
    config_class = Qwen2MoeConfig
    mlp_name = "mlp"
    expert_names = ("gate_proj", "up_proj", "down_proj")

    @classmethod
    def _get_name_mappings(cls, config, flat_shapes):
        mappings, plain = [], {}
        n_layers, n_experts = config.num_hidden_layers, config.num_local_experts
        for path, shape in flat_shapes.items():
            tail = path.rsplit("/", 1)[-1]
            if "/mlp/" in path and tail in cls.expert_names and len(shape) >= 3:
                mappings.append(StackedLayerMapping(f"model.layers.{{}}.mlp.experts.{{}}.{tail}.weight", path,
                                                    action="transpose", dims=(n_layers, n_experts)))
            elif "shared_expert_gate/" in path:
                mappings.append(StackedLayerMapping("model.layers.{}.mlp.shared_expert_gate.weight", path,
                                                    action="transpose", dims=(n_layers,)))
            elif "shared_expert_" in path:
                proj = path.rsplit("/", 2)[-2].replace("shared_expert_", "")
                mappings.append(StackedLayerMapping(f"model.layers.{{}}.mlp.shared_expert.{proj}.weight", path,
                                                    action="transpose", dims=(n_layers,)))
            else:
                plain[path] = shape
        return mappings + auto_name_mappings(plain)
