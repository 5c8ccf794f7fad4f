"""Mixture-of-Experts feed-forward block in PyTorch.

Port of ``paddlenlp_tpu/transformers/moe_layers.py`` (``MoEMLP`` :49,
``load_balancing_loss`` :40). Expert weights are one stacked tensor per
projection, ``[E, D, F]`` (down ``[E, F, D]``), under the host model's HF
names. Routing is a softmax over the router's logits, computed in fp32 even
under bf16 compute, then top-k (ties to the lower expert index, as
``jax.lax.top_k``), optionally renormalized (``norm_topk_prob``).

- ``config.moe_dispatch = "dense"`` (the default) runs every expert on every
  token, ``[E, N, F]``, and combines by the routing weights: the exact
  computation pretrained checkpoints expect (``:92-99``);
- ``"sparse"`` scatters each kept (token, k) pair into its own slot of
  per-expert capacity buffers ``[E, C, D]``, ``C = min(max(int(ceil(N*K/E) *
  moe_capacity_factor), 1), N)``, runs the experts on their buffers only and
  gathers the outputs back by the routing weights; pairs past an expert's
  capacity are dropped with weight 0 (``:100-121``). Every write and read
  goes through unique indices (a dropped pair has a zero slot of its own
  past the buffers), so two launches give the same bits and a dropped pair
  moves no gradient;
- the qwen2-moe shared expert, a SwiGLU over every token scaled by a
  sigmoid gate, adds to the routed output (``:123-135``);
- the Switch-transformer load-balancing loss, pre-weighted by
  ``router_aux_loss_coef``, comes back beside the output (``:137-139``).

There is no kernel here: the JAX package computes the block as plain XLA
(einsums, top-k, scatter and gather), and so does the port, with torch ops.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["MoEMixin", "load_balancing_loss", "moe_capacity", "moe_mlp", "moe_mlp_loop", "route"]


def load_balancing_loss(router_probs: torch.Tensor, expert_mask: torch.Tensor, num_experts: int,
                        top_k: int) -> torch.Tensor:
    """Switch-transformer aux loss ``E * sum_e f_e * P_e`` (f: the share of
    top-k selections that go to e; P: the mean router probability of e)."""
    tokens_per_expert = expert_mask.mean(dim=0) / top_k
    prob_per_expert = router_probs.mean(dim=0)
    return num_experts * torch.sum(tokens_per_expert * prob_per_expert)


def route(router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool, groups: Optional[Tuple[int, int]] = None):
    """``(probs [N, E], topk_probs [N, K], topk_idx [N, K])`` from fp32
    router logits: softmax, then the K largest probabilities in descending
    order, equal ones by the lower expert index (a stable sort: the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise). ``groups`` =
    ``(n_group, topk_group)``: DeepSeek-V2's ``group_limited_greedy``
    (``paddlenlp_tpu/transformers/deepseek_v2/modeling.py:223-229``): the
    experts fall in ``n_group`` equal groups, each group scores its largest
    probability, and the K come from the ``topk_group`` best groups only
    (the others' probabilities taken as 0)."""
    probs = torch.softmax(router_logits, dim=-1)
    scores = probs
    if groups is not None:
        n_group, topk_group = groups
        N, E = probs.shape
        best = probs.reshape(N, n_group, E // n_group).amax(dim=-1)
        kept = torch.sort(best, dim=-1, descending=True, stable=True).indices[:, :topk_group]
        mask = torch.zeros(N, n_group, dtype=torch.bool, device=probs.device).scatter(1, kept, True)
        scores = torch.where(mask.repeat_interleave(E // n_group, dim=1), probs, torch.zeros_like(probs))
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :top_k]
    topk_probs = scores.gather(1, order)
    if norm_topk_prob:
        topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, topk_probs, order


def moe_capacity(n_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots a expert's buffer holds under sparse dispatch (``moe_layers.py:102``)."""
    return min(max(int(-(-n_tokens * top_k // num_experts) * capacity_factor), 1), n_tokens)


def _experts(xe: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: xe [E or 1, M, D] -> [E, M, D]."""
    return (F.silu(xe @ w_gate) * (xe @ w_up)) @ w_down


def moe_mlp(config, x: torch.Tensor, proj: Callable[[str, torch.Tensor], torch.Tensor],
            leaf: Callable[[str], torch.Tensor], names: Tuple[str, str, str] = ("w1", "w3", "w2"),
            gate_name: str = "gate") -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE block over x [B, T, D] in x's dtype: ``(out [B, T, D], aux)``,
    aux a 0-dim fp32 tensor. ``leaf(path)`` reads one layer's leaf under the
    block (``"w1"``, ``"gate/kernel"``), ``proj(name, x)`` runs its dense
    projection ``name`` (the shared expert's). ``names`` are the (gate, up,
    down) expert leaves, ``gate_name`` the router's."""
    cfg = config
    E, K, D = cfg.num_local_experts, cfg.num_experts_per_tok, cfg.hidden_size
    B, T, _ = x.shape
    dtype = x.dtype
    xf = x.reshape(-1, D)
    N = xf.shape[0]

    router_logits = xf.float() @ leaf(f"{gate_name}/kernel").float()  # [N, E], fp32 routing
    probs, topk_probs, topk_idx = route(router_logits, K, bool(getattr(cfg, "norm_topk_prob", True)))
    w_gate, w_up, w_down = (leaf(n).to(dtype) for n in names)

    if getattr(cfg, "moe_dispatch", "dense") == "dense":
        # every expert on every token: [E, N, F], combined by the routing weights
        combine = torch.zeros_like(probs).scatter(1, topk_idx, topk_probs)  # [N, E]
        expert_out = _experts(xf[None], w_gate, w_up, w_down)  # [E, N, D]
        out = torch.einsum("end,ne->nd", expert_out, combine.to(expert_out.dtype))
    else:
        C = moe_capacity(N, E, K, float(getattr(cfg, "moe_capacity_factor", 2.0)))
        flat_idx = topk_idx.reshape(-1)  # [N*K], token-major: the JAX cumsum order
        sel = F.one_hot(flat_idx, E)
        pos = ((sel.cumsum(dim=0) - 1) * sel).sum(-1)  # each pair's slot in its expert's buffer
        keep = pos < C
        # a dropped pair j writes and reads row E*C + j: zeros, its own
        dest = torch.where(keep, flat_idx * C + pos, E * C + torch.arange(N * K, device=x.device))
        x_rep = xf[:, None].expand(N, K, D).reshape(N * K, D)
        buf = torch.zeros(E * C + N * K, D, dtype=dtype, device=x.device).index_copy(0, dest, x_rep)
        y = _experts(buf[:E * C].reshape(E, C, D), w_gate, w_up, w_down).reshape(E * C, D)
        y = torch.cat([y, y.new_zeros(N * K, D)])
        w = (topk_probs.reshape(-1) * keep).to(y.dtype)  # dropped -> weight 0
        out = (y.index_select(0, dest) * w[:, None]).reshape(N, K, D).sum(dim=1)

    if getattr(cfg, "shared_expert_intermediate_size", 0):
        sh = proj("shared_expert_down_proj",
                  F.silu(proj("shared_expert_gate_proj", x)) * proj("shared_expert_up_proj", x))
        gate_logit = proj("shared_expert_gate", x).reshape(-1, 1)
        out = out + torch.sigmoid(gate_logit.float()).to(out.dtype) * sh.reshape(-1, D)

    expert_mask = torch.zeros_like(probs).scatter(1, topk_idx, 1.0)
    aux = load_balancing_loss(probs, expert_mask, E, K) * getattr(cfg, "router_aux_loss_coef", 0.0)
    return out.reshape(B, T, D), aux


class MoEMixin:
    """The MoE block as a LLaMA-graph family's MLP (``LlamaForCausalLM``'s
    hook): mixed in ahead of the causal model class, with :attr:`mlp_name`
    and the HF leaf names (:attr:`expert_names`, :attr:`router_name`) set by
    the family. The router's kernel stays fp32 in the training forward, as
    the JAX router computes in fp32 from the fp32 master (``:70-73``); the
    block has no ``mlp_act`` tag, so ``save_attn_mlp`` keeps what
    ``save_qkv_attn`` keeps (JAX ``_remat_policy``)."""

    returns_aux_loss = True
    mlp_act = None
    #: the (gate, up, down) expert leaves and the router's subtree under ``mlp_name``
    expert_names: Tuple[str, str, str] = ("w1", "w3", "w2")
    router_name = "gate"

    @classmethod
    def mlp_param_shapes(cls, config, layer: int = 0):
        E, D, F = config.num_local_experts, config.hidden_size, config.moe_intermediate_size
        g, u, d = cls.expert_names
        shapes = {f"{cls.router_name}/kernel": (D, E), g: (E, D, F), u: (E, D, F), d: (E, F, D)}
        Fs = getattr(config, "shared_expert_intermediate_size", 0)
        if Fs:
            shapes.update({"shared_expert_gate_proj/kernel": (D, Fs), "shared_expert_up_proj/kernel": (D, Fs),
                           "shared_expert_down_proj/kernel": (Fs, D), "shared_expert_gate/kernel": (D, 1)})
        return shapes

    def mlp(self, x, proj, leaf, act=None, layer: int = 0):
        return moe_mlp(self.config, x, proj, leaf, self.expert_names, self.router_name)

    @classmethod
    def _stays_fp32(cls, path: str) -> bool:
        return super()._stays_fp32(path) or path == f"{cls.mlp_name}/{cls.router_name}/kernel"


def moe_mlp_loop(config, x: torch.Tensor, router_kernel: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain computation the stacked dispatches are held to (routed
    experts only, no shared expert): each expert's SwiGLU over the tokens
    routed to it, one expert after another (the loop of HF Mixtral's
    ``MixtralSparseMoeBlock``), weighted into the output, in x's dtype;
    routing by ``torch.topk`` and the aux loss from the expert counts.
    ``(out [B, T, D], aux)``."""
    E, K, D = config.num_local_experts, config.num_experts_per_tok, config.hidden_size
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    probs = torch.softmax(xf.float() @ router_kernel.float(), dim=-1)
    top_p, top_i = probs.topk(K, dim=-1)
    if getattr(config, "norm_topk_prob", True):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(xf)
    for e in range(E):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        xe = xf[rows]
        y = (F.silu(xe @ w_gate[e].to(x.dtype)) * (xe @ w_up[e].to(x.dtype))) @ w_down[e].to(x.dtype)
        out.index_add_(0, rows, y * top_p[rows, slot, None].to(x.dtype))
    share = torch.bincount(top_i.reshape(-1), minlength=E).float() / (N * K)
    aux = E * torch.sum(share * probs.mean(dim=0)) * getattr(config, "router_aux_loss_coef", 0.0)
    return out.reshape(x.shape), aux
