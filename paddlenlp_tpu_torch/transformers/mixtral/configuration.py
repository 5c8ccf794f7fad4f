"""Mixtral configuration (a copy of ``paddlenlp_tpu/transformers/mixtral/configuration.py``)."""

from __future__ import annotations

from ..configuration_utils import PretrainedConfig

__all__ = ["MixtralConfig"]


class MixtralConfig(PretrainedConfig):
    model_type = "mixtral"

    def __init__(
        self,
        vocab_size: int = 32000,
        hidden_size: int = 4096,
        intermediate_size: int = 14336,
        num_hidden_layers: int = 32,
        num_attention_heads: int = 32,
        num_key_value_heads: int = 8,
        head_dim: int = None,
        hidden_act: str = "silu",
        max_position_embeddings: int = 32768,
        initializer_range: float = 0.02,
        rms_norm_eps: float = 1e-5,
        rope_theta: float = 1e6,
        rope_scaling: dict = None,
        sliding_window: int = None,
        attention_dropout: float = 0.0,
        num_local_experts: int = 8,
        num_experts_per_tok: int = 2,
        router_aux_loss_coef: float = 0.02,
        norm_topk_prob: bool = True,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.moe_intermediate_size = intermediate_size
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
        self.sliding_window = sliding_window
        self.attention_dropout = attention_dropout
        self.num_local_experts = num_local_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.router_aux_loss_coef = router_aux_loss_coef
        self.norm_topk_prob = norm_topk_prob
        self.attention_bias = False
        self.mlp_bias = False
        kwargs.setdefault("tie_word_embeddings", False)
        super().__init__(**kwargs)
