"""Qwen2-MoE configuration (a copy of ``paddlenlp_tpu/transformers/qwen2_moe/configuration.py``)."""

from __future__ import annotations

from ..configuration_utils import PretrainedConfig

__all__ = ["Qwen2MoeConfig"]


class Qwen2MoeConfig(PretrainedConfig):
    model_type = "qwen2_moe"

    def __init__(
        self,
        vocab_size: int = 151936,
        hidden_size: int = 2048,
        intermediate_size: int = 5632,
        num_hidden_layers: int = 24,
        num_attention_heads: int = 16,
        num_key_value_heads: int = 16,
        head_dim: int = None,
        hidden_act: str = "silu",
        max_position_embeddings: int = 32768,
        initializer_range: float = 0.02,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 1e6,
        rope_scaling: dict = None,
        attention_dropout: float = 0.0,
        num_experts: int = 60,
        num_experts_per_tok: int = 4,
        moe_intermediate_size: int = 1408,
        shared_expert_intermediate_size: int = 5632,
        router_aux_loss_coef: float = 0.001,
        norm_topk_prob: bool = False,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.head_dim = head_dim if head_dim is not None else hidden_size // num_attention_heads
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_dropout = attention_dropout
        self.num_local_experts = num_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.moe_intermediate_size = moe_intermediate_size
        self.shared_expert_intermediate_size = shared_expert_intermediate_size
        self.router_aux_loss_coef = router_aux_loss_coef
        self.norm_topk_prob = norm_topk_prob
        # qwen attention biases
        self.attention_bias = True
        self.attention_out_bias = False
        self.mlp_bias = False
        kwargs.setdefault("tie_word_embeddings", False)
        super().__init__(**kwargs)

    @property
    def num_experts(self):
        return self.num_local_experts
