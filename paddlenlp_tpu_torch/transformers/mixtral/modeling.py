"""Mixtral (sparse MoE) causal LM in PyTorch.

Port of ``paddlenlp_tpu/transformers/mixtral/modeling.py``: the LLaMA graph
with ``block_sparse_moe``, the stacked-expert MoE block of
``moe_layers.py`` (router ``gate``, experts ``w1`` gate, ``w3`` up, ``w2``
down), as the MLP of every layer. HF checkpoints hold one key an expert,
``model.layers.{l}.block_sparse_moe.experts.{e}.w{1,2,3}.weight``; the
mapping stacks them layers x experts (``:60-82``).
"""

from __future__ import annotations

from ..conversion_utils import StackedLayerMapping, auto_name_mappings
from ..llama.modeling import LlamaForCausalLM
from ..moe_layers import MoEMixin
from .configuration import MixtralConfig

__all__ = ["MixtralForCausalLM"]


class MixtralForCausalLM(MoEMixin, LlamaForCausalLM):
    config_class = MixtralConfig
    mlp_name = "block_sparse_moe"
    expert_names = ("w1", "w3", "w2")

    @classmethod
    def _get_name_mappings(cls, config, flat_shapes):
        experts = [p for p in flat_shapes if "/block_sparse_moe/" in p and p.rsplit("/", 1)[-1] in ("w1", "w2", "w3")]
        mappings = auto_name_mappings({p: s for p, s in flat_shapes.items() if p not in experts})
        dims = (config.num_hidden_layers, config.num_local_experts)
        for path in experts:
            template = f"model.layers.{{}}.block_sparse_moe.experts.{{}}.{path.rsplit('/', 1)[-1]}.weight"
            mappings.append(StackedLayerMapping(template, path, action="transpose", dims=dims))
        return mappings
