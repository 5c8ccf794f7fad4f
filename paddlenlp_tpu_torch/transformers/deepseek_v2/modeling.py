"""DeepSeek-V2 in PyTorch: Multi-head Latent Attention (MLA) and the grouped
MoE on the LLaMA graph.

Port of ``paddlenlp_tpu/transformers/deepseek_v2/modeling.py``. The family
fills the two per-layer hooks of ``transformers/llama/modeling.py``:

- the attention hook with MLA (``DeepseekV2Attention`` :70-181): q through
  ``q_proj``, or low-rank through ``q_a_proj`` -> ``q_a_layernorm`` ->
  ``q_b_proj`` under ``q_lora_rank``; ``kv_a_proj_with_mqa`` gives the latent
  (normed by ``kv_a_layernorm``, then ``kv_b_proj`` to each head's k_nope and
  v) and one rope head ``k_pe`` shared by every head. Rope runs on the rope
  slices only, after DeepSeek's interleaved-to-half permutation (:62-67);
  YaRN's mscale multiplies the tables and the softmax scale (:56-59,
  :124-134). q and k are ``qk_nope + qk_rope`` = 192 dims a head at the
  published widths; v is padded up to them (in the cache too), so the flash
  kernels run at head_dim 192, and the output is sliced back to
  ``v_head_dim`` before ``o_proj`` (:147-178);
- the MLP hook with the grouped MoE (``DeepseekV2MoE`` :201-265) where
  ``layer >= first_k_dense_replace`` and ``layer % moe_layer_freq == 0``
  (``DeepseekV2DecoderLayer._mlp_module`` :268-284), the SwiGLU elsewhere.
  The MoE routes in fp32 (softmax, optionally ``group_limited_greedy``,
  top-k through ``moe_layers.route``, ``norm_topk_prob`` when K > 1, then
  ``routed_scaling_factor``), runs every routed expert on every token (the
  dense ``[E, N, F]`` products of the JAX block, no sparse dispatch), adds
  the always-on shared experts, and returns the sequence-level (``seq_aux``)
  or batch-level balance loss times ``aux_loss_alpha``.

A heterogeneous stack (dense first layers) is unrolled (``layers_{i}``), as
the configuration forces; a scanned one takes every layer as layer 0 does,
as the JAX module parses no index from ``layers``. There is no kernel here:
attention goes through the dispatcher (``ops/flash_attention.py``), whose
bf16 and fp32 flash kernels take head_dim 192.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.cross_entropy import cross_entropy_with_ignore
from ...ops.rope import rope_frequencies, rope_tables, rotate_half
from .. import moe_layers
from ..conversion_utils import StackedLayerMapping, auto_name_mappings
from ..llama.modeling import LlamaForCausalLM, rms_norm
from ..model_utils import PretrainedModel
from .configuration import DeepseekV2Config

__all__ = ["DeepseekV2ForCausalLM", "DeepseekV2Model", "DeepseekV2PretrainedModel", "DeepseekV2PretrainingCriterion",
           "deepseek_moe", "deepseek_moe_loop", "moe_at"]


def _yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1 or mscale == 0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _interleave_to_half(x: torch.Tensor) -> torch.Tensor:
    """[..., d] pairs (x0, x1, x2, x3, ..) -> (x0, x2, .., x1, x3, ..):
    DeepSeek stores the rope dims interleaved; permuted to the half-rotate
    layout (JAX :62-67)."""
    d = x.shape[-1]
    return x.reshape(x.shape[:-1] + (d // 2, 2)).transpose(-1, -2).reshape(x.shape)


def moe_at(config, layer: int) -> bool:
    """Whether layer ``layer`` runs the MoE block (JAX :274-279)."""
    return (config.n_routed_experts is not None and layer >= config.first_k_dense_replace
            and layer % config.moe_layer_freq == 0)


def _route(config, router_logits: torch.Tensor):
    """(probs [N, E], topk weights [N, K] times ``routed_scaling_factor``,
    topk_idx [N, K]) through ``moe_layers.route``, which ``chip_smoke``'s
    ``PinnedRouting`` records and replays."""
    K = config.num_experts_per_tok
    groups = (config.n_group, config.topk_group) if config.topk_method == "group_limited_greedy" else None
    probs, topk_probs, topk_idx = moe_layers.route(router_logits, K, bool(config.norm_topk_prob) and K > 1,
                                                   groups=groups)
    return probs, topk_probs * config.routed_scaling_factor, topk_idx


def _aux_loss(config, probs: torch.Tensor, topk_idx: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """The balance loss times ``aux_loss_alpha`` (JAX :253-265): per
    sequence under ``seq_aux``, else over the batch; 0 without alpha."""
    E, K = config.n_routed_experts, config.num_experts_per_tok
    if not config.aux_loss_alpha or config.aux_loss_alpha <= 0:
        return torch.zeros((), dtype=torch.float32, device=probs.device)
    sel = F.one_hot(topk_idx, E).to(torch.float32).sum(dim=1)  # [N, E]
    if config.seq_aux:
        ce = sel.reshape(B, T, E).sum(dim=1) / (T * K / E)  # [B, E]
        aux = (ce * probs.reshape(B, T, E).mean(dim=1)).sum(dim=1).mean()
    else:
        fi = sel.mean(dim=0) * E / K
        aux = (fi * probs.mean(dim=0)).sum()
    return aux * config.aux_loss_alpha


def _shared(config, x, proj):
    """The always-on shared experts: one SwiGLU of ``n_shared_experts *
    moe_intermediate_size`` (``_SharedExpertsMLP`` :184-198)."""
    return proj("shared_experts/down_proj",
                F.silu(proj("shared_experts/gate_proj", x)) * proj("shared_experts/up_proj", x))


def deepseek_moe(config, x: torch.Tensor, proj, leaf) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block over x [B, T, D] in x's dtype: ``(out [B, T, D], aux)``.
    ``leaf(path)`` reads one layer's leaf under ``mlp`` (``"gate/kernel"``,
    ``"gate_proj"``), ``proj(name, x)`` runs a projection there (the shared
    experts')."""
    cfg = config
    D = cfg.hidden_size
    B, T, _ = x.shape
    xf = x.reshape(-1, D)
    probs, weights, topk_idx = _route(cfg, xf.float() @ leaf("gate/kernel").float())
    w_gate, w_up, w_down = (leaf(n).to(x.dtype) for n in ("gate_proj", "up_proj", "down_proj"))
    combine = torch.zeros_like(probs).scatter(1, topk_idx, weights)  # [N, E]
    expert_out = moe_layers._experts(xf[None], w_gate, w_up, w_down)  # [E, N, D]: every expert on every token
    out = torch.einsum("end,ne->nd", expert_out, combine.to(expert_out.dtype))
    if cfg.n_shared_experts:
        out = out + _shared(cfg, x, proj).reshape(-1, D)
    return out.reshape(B, T, D), _aux_loss(cfg, probs, topk_idx, B, T)


def deepseek_moe_loop(config, x: torch.Tensor, leaves: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain computation :func:`deepseek_moe` is held to on the card:
    the same routing (``torch.topk`` over the group-masked probabilities), then
    each routed expert's SwiGLU over the tokens routed to it, one expert after
    another, weighted into the output, plus the shared experts, in x's dtype;
    the aux loss from the expert counts. ``leaves`` holds one layer's MLP
    leaves by path (``gate/kernel``, ``gate_proj``, ...,
    ``shared_experts/gate_proj/kernel``)."""
    cfg = config
    E, K, D = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.hidden_size
    B, T, _ = x.shape
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    probs = torch.softmax(xf.float() @ leaves["gate/kernel"].float(), dim=-1)
    scores = probs
    if cfg.topk_method == "group_limited_greedy":
        G = cfg.n_group
        keep = probs.reshape(N, G, E // G).amax(-1).topk(cfg.topk_group, dim=-1).indices
        in_group = torch.zeros(N, G, device=x.device).scatter(1, keep, 1.0).repeat_interleave(E // G, dim=1) > 0
        scores = torch.where(in_group, probs, torch.zeros_like(probs))
    top_p, top_i = scores.topk(K, dim=-1)
    if K > 1 and cfg.norm_topk_prob:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    top_p = top_p * cfg.routed_scaling_factor
    out = torch.zeros_like(xf)
    for e in range(E):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        xe = xf[rows]
        w = [leaves[n][e].to(x.dtype) for n in ("gate_proj", "up_proj", "down_proj")]
        y = (F.silu(xe @ w[0]) * (xe @ w[1])) @ w[2]
        out.index_add_(0, rows, y * top_p[rows, slot, None].to(x.dtype))
    if cfg.n_shared_experts:
        sh = {n: leaves[f"shared_experts/{n}/kernel"].to(x.dtype) for n in ("gate_proj", "up_proj", "down_proj")}
        out = out + (F.silu(xf @ sh["gate_proj"]) * (xf @ sh["up_proj"])) @ sh["down_proj"]
    counts = torch.stack([torch.bincount(row, minlength=E) for row in top_i.reshape(B, T * K)]).float()
    if cfg.seq_aux:
        aux = ((counts / (T * K / E)) * probs.reshape(B, T, E).mean(dim=1)).sum(dim=1).mean()
    else:
        aux = ((counts.sum(0) / N * E / K) * probs.mean(dim=0)).sum()
    return out.reshape(x.shape), aux * (cfg.aux_loss_alpha or 0.0)


class DeepseekV2PretrainedModel(LlamaForCausalLM):
    """The LLaMA graph with MLA and the per-layer MoE choice: the family's
    hooks, leaves and HF name mappings (JAX ``DeepseekV2PretrainedModel``)."""

    config_class = DeepseekV2Config
    mlp_name = "mlp"
    returns_aux_loss = True

    # ------------------------------------------------------------------ attention: MLA
    @classmethod
    def attn_param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        D, N = config.hidden_size, config.num_attention_heads
        Hq = config.qk_nope_head_dim + config.qk_rope_head_dim
        bias = bool(config.attention_bias)
        shapes: Dict[str, Tuple[int, ...]] = {}

        def dense(name, d_in, d_out, has_bias):
            shapes[name + "/kernel"] = (d_in, d_out)
            if has_bias:
                shapes[name + "/bias"] = (d_out,)

        if config.q_lora_rank is None:
            dense("q_proj", D, N * Hq, False)
        else:
            dense("q_a_proj", D, config.q_lora_rank, bias)
            shapes["q_a_layernorm/scale"] = (config.q_lora_rank,)
            dense("q_b_proj", config.q_lora_rank, N * Hq, False)
        dense("kv_a_proj_with_mqa", D, config.kv_lora_rank + config.qk_rope_head_dim, bias)
        shapes["kv_a_layernorm/scale"] = (config.kv_lora_rank,)
        dense("kv_b_proj", config.kv_lora_rank, N * (config.qk_nope_head_dim + config.v_head_dim), False)
        dense("o_proj", N * config.v_head_dim, D, bias)
        return shapes

    def _yarn(self) -> Tuple[float, float]:
        """(the tables' mscale ratio, the softmax scale's factor) of YaRN
        rope scaling; (1, 1) otherwise (JAX :124-134)."""
        scaling = self.config.rope_scaling or {}
        if scaling.get("type", scaling.get("rope_type")) != "yarn":
            return 1.0, 1.0
        factor = float(scaling.get("factor", 1.0))
        m = _yarn_mscale(factor, scaling.get("mscale", 1)) / _yarn_mscale(factor, scaling.get("mscale_all_dim", 0))
        ms = _yarn_mscale(factor, scaling["mscale_all_dim"]) if scaling.get("mscale_all_dim", 0) else 1.0
        return m, ms * ms

    def attn_rope(self, position_ids, device):
        """Tables [B, T, qk_rope_head_dim], YaRN's mscale ratio folded in."""
        cfg = self.config
        inv_freq = torch.from_numpy(rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling))
        cos, sin = rope_tables(position_ids.to(device), inv_freq.to(device))
        m, _ = self._yarn()
        return (cos * m, sin * m) if m != 1.0 else (cos, sin)

    def attn_qkv(self, x, proj, leaf, cos, sin):
        """MLA: q and k [B, T, N, qk_nope + qk_rope], v [B, T, N, v_head_dim]
        zero-padded up to the same head dim."""
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        N, dn, dr, dv = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        eps = cfg.rms_norm_eps
        if cfg.q_lora_rank is None:
            q = proj("q_proj", x)
        else:
            q = proj("q_b_proj", rms_norm(proj("q_a_proj", x), leaf("q_a_layernorm/scale"), eps))
        q = q.reshape(B, T, N, dn + dr)
        ckv = proj("kv_a_proj_with_mqa", x)
        c_kv, k_pe = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
        kvb = proj("kv_b_proj", rms_norm(c_kv, leaf("kv_a_layernorm/scale"), eps)).reshape(B, T, N, dn + dv)
        k_nope, v = kvb[..., :dn], kvb[..., dn:]

        def rope(t):  # [B, T, heads, dr], in fp32, back to t's dtype
            t = _interleave_to_half(t)
            t32 = t.float()
            return (t32 * cos[:, :, None, :] + rotate_half(t32) * sin[:, :, None, :]).to(t.dtype)

        q = torch.cat([q[..., :dn], rope(q[..., dn:])], dim=-1)
        k_pe = rope(k_pe.reshape(B, T, 1, dr))
        k = torch.cat([k_nope, k_pe.expand(B, T, N, dr)], dim=-1)
        return q, k, F.pad(v, (0, dn + dr - dv))

    def attn_scale(self) -> float:
        cfg = self.config
        return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)**-0.5 * self._yarn()[1]

    def attn_output(self, o):
        return o[..., :self.config.v_head_dim].reshape(o.shape[0], o.shape[1], -1)

    # ------------------------------------------------------------------ MLP: dense or MoE by layer
    @classmethod
    def mlp_param_shapes(cls, config, layer: int = 0):
        if not moe_at(config, layer):
            return super().mlp_param_shapes(config, layer)
        E, D, Fm = config.n_routed_experts, config.hidden_size, config.moe_intermediate_size
        shapes = {"gate/kernel": (D, E), "gate_proj": (E, D, Fm), "up_proj": (E, D, Fm), "down_proj": (E, Fm, D)}
        if config.n_shared_experts:
            Fs = Fm * config.n_shared_experts
            shapes.update({"shared_experts/gate_proj/kernel": (D, Fs), "shared_experts/up_proj/kernel": (D, Fs),
                           "shared_experts/down_proj/kernel": (Fs, D)})
        return shapes

    def has_mlp_act(self, layer: int) -> bool:
        """Dense layers keep the ``mlp_act`` tag; the MoE block has none, so
        ``save_attn_mlp`` keeps there what ``save_qkv_attn`` keeps."""
        return not moe_at(self.config, layer)

    def mlp(self, x, proj, leaf, act=None, layer: int = 0):
        if not moe_at(self.config, layer):
            return super().mlp(x, proj, leaf, act=act, layer=layer)
        return deepseek_moe(self.config, x, proj, leaf)

    @classmethod
    def _stays_fp32(cls, path: str) -> bool:
        """The norms' scales and the router's kernel (JAX routes in fp32)."""
        return super()._stays_fp32(path) or path == "mlp/gate/kernel"

    @classmethod
    def _check_config(cls, config):
        super()._check_config(config)
        heterogeneous = config.n_routed_experts is not None and (
            config.first_k_dense_replace > 0 or config.moe_layer_freq != 1)
        if heterogeneous and getattr(config, "use_scan_layers", False):
            raise ValueError("use_scan_layers needs homogeneous layers; deepseek_v2 with "
                             "first_k_dense_replace/moe_layer_freq mixes dense and MoE layers")

    # ------------------------------------------------------------------ checkpoints
    @classmethod
    def _get_name_mappings(cls, config, flat_shapes):
        """Each layer's experts stack from ``model.layers.{i}.mlp.experts.{e}
        .{proj}.weight`` (JAX :311-330); the rest are the mechanical names."""
        mappings, plain = [], {}
        for path, shape in flat_shapes.items():
            tail = path.rsplit("/", 1)[-1]
            if ("/mlp/" in path and "/shared_experts/" not in path and tail in ("gate_proj", "up_proj", "down_proj")
                    and len(shape) == 3):
                layer = f"/{path}".split("/layers_")[1].split("/")[0]
                mappings.append(StackedLayerMapping(f"model.layers.{layer}.mlp.experts.{{}}.{tail}.weight", path,
                                                    action="transpose", dims=(config.n_routed_experts,)))
            else:
                plain[path] = shape
        return mappings + auto_name_mappings(plain)


class DeepseekV2ForCausalLM(DeepseekV2PretrainedModel):
    """DeepSeek-V2 with its LM head (JAX ``DeepseekV2ForCausalLM``)."""


class DeepseekV2Model(PretrainedModel):
    """The backbone (JAX ``DeepseekV2Model``): the final-norm hidden states
    [B, T, D], no head. Its tree is the causal model's ``model`` subtree at
    the root, as the JAX base model's, so its HF keys have no ``model.``
    prefix."""

    config_class = DeepseekV2Config

    @classmethod
    def param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        return {k[len("model/"):]: v for k, v in DeepseekV2ForCausalLM.param_shapes(config).items()
                if k.startswith("model/")}

    @classmethod
    def _check_config(cls, config):
        DeepseekV2ForCausalLM._check_config(config)

    @classmethod
    def _get_name_mappings(cls, config, flat_shapes):
        return DeepseekV2ForCausalLM._get_name_mappings(config, flat_shapes)

    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, position_ids=None,
                segment_ids=None, attention_mask=None) -> torch.Tensor:
        """Differentiable: the causal model's hidden states over this tree,
        in ``compute_dtype``."""
        trunk = DeepseekV2ForCausalLM(self.config, {"model": self.params if params is None else params})
        trunk.compute_dtype = self.compute_dtype
        return trunk.hidden_states(input_ids, position_ids=position_ids, segment_ids=segment_ids,
                                   attention_mask=attention_mask)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, attention_mask=None, params: Optional[dict] = None) -> torch.Tensor:
        """:meth:`forward` without a gradient."""
        return self.forward(input_ids, params=params, attention_mask=attention_mask)


class DeepseekV2PretrainingCriterion:
    """The pretraining loss (JAX ``LlamaPretrainingCriterion``, which
    DeepSeek-V2 takes as its own): the token CE of logits [B, T, V] against
    labels [B, T] as given (no shift), ``ignore_index`` left out."""

    def __init__(self, config, ignore_index: int = -100):
        self.config = config
        self.ignore_index = ignore_index

    def __call__(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return cross_entropy_with_ignore(logits, labels, self.ignore_index)[0]
