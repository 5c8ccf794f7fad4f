"""DeepSeek-V2 configuration (a copy of
``paddlenlp_tpu/transformers/deepseek_v2/configuration.py``)."""

from __future__ import annotations

from ..configuration_utils import PretrainedConfig

__all__ = ["DeepseekV2Config"]


class DeepseekV2Config(PretrainedConfig):
    model_type = "deepseek_v2"

    def __init__(
        self,
        vocab_size: int = 102400,
        hidden_size: int = 4096,
        intermediate_size: int = 11008,
        moe_intermediate_size: int = 1407,
        num_hidden_layers: int = 30,
        num_attention_heads: int = 32,
        n_shared_experts: int = None,
        n_routed_experts: int = None,
        routed_scaling_factor: float = 1.0,
        kv_lora_rank: int = 512,
        q_lora_rank: int = 1536,
        qk_rope_head_dim: int = 64,
        v_head_dim: int = 128,
        qk_nope_head_dim: int = 128,
        topk_method: str = "greedy",
        n_group: int = None,
        topk_group: int = None,
        num_experts_per_tok: int = None,
        moe_layer_freq: int = 1,
        first_k_dense_replace: int = 0,
        norm_topk_prob: bool = False,
        scoring_func: str = "softmax",
        aux_loss_alpha: float = 0.001,
        seq_aux: bool = True,
        hidden_act: str = "silu",
        max_position_embeddings: int = 2048,
        initializer_range: float = 0.02,
        rms_norm_eps: float = 1e-6,
        rope_theta: float = 10000.0,
        rope_scaling: dict = None,
        attention_bias: bool = False,
        attention_dropout: float = 0.0,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.moe_intermediate_size = moe_intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.n_shared_experts = n_shared_experts
        self.n_routed_experts = n_routed_experts
        self.routed_scaling_factor = routed_scaling_factor
        self.kv_lora_rank = kv_lora_rank
        self.q_lora_rank = q_lora_rank
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.qk_nope_head_dim = qk_nope_head_dim
        self.topk_method = topk_method
        self.n_group = n_group
        self.topk_group = topk_group
        self.num_experts_per_tok = num_experts_per_tok
        self.moe_layer_freq = moe_layer_freq
        self.first_k_dense_replace = first_k_dense_replace
        self.norm_topk_prob = norm_topk_prob
        self.scoring_func = scoring_func
        self.aux_loss_alpha = aux_loss_alpha
        self.seq_aux = seq_aux
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        # cache/generation machinery contracts: MLA materializes per-head K of
        # qk_nope+qk_rope dims (V padded up to it inside the cache)
        self.head_dim = qk_nope_head_dim + qk_rope_head_dim
        self.num_key_value_heads = num_attention_heads
        self.mlp_bias = False
        kwargs.setdefault("tie_word_embeddings", False)
        heterogeneous = n_routed_experts is not None and (
            first_k_dense_replace > 0 or moe_layer_freq != 1
        )
        if heterogeneous:
            if kwargs.get("use_scan_layers"):
                raise ValueError(
                    "use_scan_layers needs homogeneous layers; deepseek_v2 with "
                    "first_k_dense_replace/moe_layer_freq mixes dense and MoE layers"
                )
            kwargs["use_scan_layers"] = False  # override the global default
        super().__init__(**kwargs)
