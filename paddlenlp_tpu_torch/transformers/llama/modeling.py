"""LLaMA-family causal LM (LLaMA, Qwen2, Mistral) in PyTorch.

Port of ``paddlenlp_tpu/transformers/llama/modeling.py:583``
(``LlamaForCausalLM``). The model holds its parameters as a nested dict of
tensors in one of the JAX package's two layouts, chosen by
``config.use_scan_layers`` as in the JAX ``LlamaModule`` (``:427-460``): the
**scanned** one (the default) stacks the decoder layers on a leading ``[L]``
axis under ``model/layers``; the **unrolled** one keeps layer ``i`` under
``model/layers_{i}``, and its layers may differ (DeepSeek-V2's dense first
layers). Projection kernels are ``[in, out]``. Both packages therefore hold
the same tree, :meth:`LlamaForCausalLM.from_jax_params` is a plain
conversion, and every forward reads a layer through one helper
(:func:`layer_tree`, :meth:`LlamaForCausalLM._layer_leaves`). The paged
inference model (``experimental/inference_model.py``) reads the scanned tree
only, as the JAX engine does.

- ``model(input_ids)`` is a plain dense causal forward with no gradient: the
  reference the paged path is held against. With a padding
  ``attention_mask``, ``position_ids`` and a ``cache`` (``KVCache``) it is
  the cached forward ``generate`` runs (``:224-286``), its attention the
  dispatcher's XLA-path counterpart (``ops/flash_attention.py``
  ``dot_product_attention_dense``).
- :meth:`LlamaForCausalLM.forward` is the training forward (``:190-387``,
  ``:513-518``): differentiable in the (fp32 master) parameters, computed in
  ``compute_dtype``, attention through the flash kernels
  (``ops/flash_attention.py``), with the eight remat policies of the JAX
  ``_remat_policy`` (:336) as ``torch.utils.checkpoint`` segments.
- every forward runs a layer's MLP through one hook (:meth:`LlamaForCausalLM.mlp`,
  its leaves :meth:`~LlamaForCausalLM.mlp_param_shapes` under
  :attr:`~LlamaForCausalLM.mlp_name`, both given the layer's index): the
  SwiGLU here, the MoE block of ``moe_layers.py`` in ``mixtral`` and
  ``qwen2_moe``, whose load-balancing loss :meth:`LlamaForCausalLM.forward`
  hands back with ``return_aux``, DeepSeek-V2's per-layer choice of the two;
- and its attention's projections through another (the JAX ``attn_cls``,
  ``:296``): :meth:`~LlamaForCausalLM.attn_param_shapes` under ``self_attn``,
  :meth:`~LlamaForCausalLM.attn_rope` (the rope tables),
  :meth:`~LlamaForCausalLM.attn_qkv` (post-rope q, k, v from the normed
  input), :meth:`~LlamaForCausalLM.attn_scale` (the softmax scale) and
  :meth:`~LlamaForCausalLM.attn_output` (what ``o_proj`` reads of the
  attention output): q/k/v/o with rope here, DeepSeek-V2's MLA there.
- loading, saving and the constructors are ``model_utils.PretrainedModel``'s
  (``from_pretrained``/``save_pretrained`` in the HF layout, ``from_config``,
  ``init_random``, ``from_jax_params``), and ``generate`` is
  ``generation.GenerationMixin``'s.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ...ops.flash_attention import dense_attention_mask, dot_product_attention, dot_product_attention_dense
from ...ops.rope import apply_rotary_pos_emb, rope_frequencies, rope_tables
from ..cache_utils import KVCache, update_layer_kv
from ..conversion_utils import flatten_params
from ..model_utils import PretrainedModel
from .configuration import LlamaConfig

__all__ = ["LlamaForCausalLM", "LlamaForSequenceClassification", "layer_params", "layer_tree", "rms_norm"]

#: recompute granularities of the training forward (the JAX ``_remat_policy``
#: :336): what each keeps for the backward is in :meth:`LlamaForCausalLM.forward`
RECOMPUTE_GRANULARITIES = ("full", "full_attn", "core_attn", "save_core_attn", "save_qkv_attn", "save_attn_mlp",
                           "save_dots", "offload_attn")

#: the matrix products ``save_dots`` keeps (``dots_with_no_batch_dims_saveable``:
#: a projection ``x @ W`` of a [B, T, D] activation dispatches as ``aten.mm``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _offload_to_host():
    """Saved tensors go to host memory and come back in the backward (pinned
    memory and copies that do not block the host for CUDA tensors, a plain
    host copy for CPU ones): ``offload_attn``'s ``offload_dst="pinned_host"``."""
    def pack(t):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        host.copy_(t, non_blocking=t.is_cuda)
        return t.device, host

    def unpack(packed):
        device, host = packed
        return host.to(device, non_blocking=True)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in fp32, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_params(tree, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` parameter subtree (views)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    return tree[i]


def scanned(model_tree: dict) -> bool:
    """Whether a ``model`` subtree holds the scanned layout (``layers``,
    stacked on ``[L]``) rather than the unrolled one (``layers_{i}``)."""
    return "layers" in model_tree


def layer_tree(model_tree: dict, i: int) -> dict:
    """Layer ``i``'s parameter subtree of a ``model`` subtree in either
    layout: views into the stacked ``layers``, or ``layers_{i}`` itself."""
    return layer_params(model_tree["layers"], i) if scanned(model_tree) else model_tree[f"layers_{i}"]


def _get(tree: dict, path: str):
    """The node at a ``/``-separated path under ``tree``."""
    return functools.reduce(lambda t, k: t[k], path.split("/"), tree)


class LlamaForCausalLM(PretrainedModel):
    """Parameters + a dense forward. ``params`` is the nested dict
    ``{"model": {"embed_tokens", "layers" (or "layers_0", ...), "norm"},
    "lm_head"}`` of the JAX package's scanned (or unrolled) layout."""

    config_class = LlamaConfig
    _keys_to_ignore_on_load_missing = [r"lm_head"]

    # ------------------------------------------------------------------ layout
    @classmethod
    def param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        """Flat ``path -> shape`` of the parameter tree: the scanned layout
        (``model/layers/...`` on ``[L]``) under ``config.use_scan_layers``,
        else the unrolled one (``model/layers_{i}/...``)."""
        L, D, V = config.num_hidden_layers, config.hidden_size, config.vocab_size
        shapes: Dict[str, Tuple[int, ...]] = {"model/embed_tokens/embedding": (V, D)}
        if getattr(config, "use_scan_layers", True):
            shapes.update({f"model/layers/{path}": (L,) + shape
                           for path, shape in cls.layer_param_shapes(config, 0).items()})
        else:
            for i in range(L):
                shapes.update({f"model/layers_{i}/{path}": shape
                               for path, shape in cls.layer_param_shapes(config, i).items()})
        shapes["model/norm/scale"] = (D,)
        if not config.tie_word_embeddings:
            shapes["lm_head/kernel"] = (D, V)
        return shapes

    @classmethod
    def layer_param_shapes(cls, config, layer: int) -> Dict[str, Tuple[int, ...]]:
        """One decoder layer's leaves, ``path -> shape``. ``layer`` is its
        index in the unrolled tree, 0 in the scanned one (the JAX decoder
        layer parses no index from ``layers``: every scanned layer is the
        first's kind)."""
        D = config.hidden_size
        shapes: Dict[str, Tuple[int, ...]] = {"input_layernorm/scale": (D,)}
        shapes.update({f"self_attn/{path}": shape for path, shape in cls.attn_param_shapes(config).items()})
        shapes["post_attention_layernorm/scale"] = (D,)
        shapes.update({f"{cls.mlp_name}/{path}": shape for path, shape in cls.mlp_param_shapes(config, layer).items()})
        return shapes

    # ------------------------------------------------------------------ the attention hook
    @classmethod
    def attn_param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        """One layer's attention leaves under ``self_attn``: q/k/v/o (+ biases)."""
        D, N, K, H = config.hidden_size, config.num_attention_heads, config.num_key_value_heads, config.head_dim
        qkv_bias = bool(getattr(config, "attention_bias", False))
        out_bias = bool(getattr(config, "attention_out_bias", qkv_bias))
        shapes: Dict[str, Tuple[int, ...]] = {}
        for name, d_in, d_out, bias in (("q_proj", D, N * H, qkv_bias), ("k_proj", D, K * H, qkv_bias),
                                        ("v_proj", D, K * H, qkv_bias), ("o_proj", N * H, D, out_bias)):
            shapes[name + "/kernel"] = (d_in, d_out)
            if bias:
                shapes[name + "/bias"] = (d_out,)
        return shapes

    def attn_rope(self, position_ids: torch.Tensor, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rope tables (cos, sin) [B, T, head_dim] in fp32 at ``position_ids``."""
        cfg = self.config
        inv_freq = torch.from_numpy(rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device)
        return rope_tables(position_ids.to(device), inv_freq)

    def attn_qkv(self, x, proj, leaf, cos, sin):
        """(q [B, T, N, H], k [B, T, K, H], v [B, T, K, H]) for attention from
        the input-normed ``x`` [B, T, D], rope applied; ``proj(name, x)`` runs
        the projection ``name`` under ``self_attn``, ``leaf(path)`` reads a
        leaf there. Every forward computes q/k/v through here."""
        cfg = self.config
        B, T = x.shape[0], x.shape[1]
        N, K, H = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        q = proj("q_proj", x).reshape(B, T, N, H)
        k = proj("k_proj", x).reshape(B, T, K, H)
        v = proj("v_proj", x).reshape(B, T, K, H)
        return apply_rotary_pos_emb(q, k, cos, sin) + (v,)

    def attn_scale(self) -> float:
        """The softmax scale: ``head_dim ** -0.5``."""
        return self.config.head_dim**-0.5

    def attn_output(self, o: torch.Tensor) -> torch.Tensor:
        """What ``o_proj`` reads of the attention output o [B, T, N, H]:
        [B, T, N * H]."""
        return o.reshape(o.shape[0], o.shape[1], -1)

    # ------------------------------------------------------------------ the MLP hook
    #: the MLP's subtree in each layer (JAX ``LlamaDecoderLayer.mlp_name``); a
    #: family overrides it with :meth:`mlp_param_shapes`, :meth:`mlp` and
    #: :attr:`mlp_act`, as JAX ``mlp_cls``/``mlp_name`` (``modeling.py:294-301``)
    mlp_name = "mlp"
    #: whether :meth:`forward` can hand back a load-balancing loss (MoE)
    returns_aux_loss = False

    @classmethod
    def mlp_param_shapes(cls, config, layer: int = 0) -> Dict[str, Tuple[int, ...]]:
        """One layer's MLP leaves, ``path under mlp_name -> shape``: the
        SwiGLU ``gate_proj``/``up_proj``/``down_proj`` (+ biases). ``layer``:
        as in :meth:`layer_param_shapes`."""
        D, I = config.hidden_size, config.intermediate_size
        shapes: Dict[str, Tuple[int, ...]] = {}
        for name, d_in, d_out in (("gate_proj", D, I), ("up_proj", D, I), ("down_proj", I, D)):
            shapes[name + "/kernel"] = (d_in, d_out)
            if getattr(config, "mlp_bias", False):
                shapes[name + "/bias"] = (d_out,)
        return shapes

    def mlp_act(self, x, proj, leaf):
        """``silu(gate(x)) * up(x)``: what ``save_attn_mlp`` keeps (the JAX
        tag ``mlp_act``). A family whose MLP has no such tag sets this to None."""
        return F.silu(proj("gate_proj", x)) * proj("up_proj", x)

    def has_mlp_act(self, layer: int) -> bool:
        """Whether layer ``layer``'s MLP carries the ``mlp_act`` tag."""
        return self.mlp_act is not None

    def mlp(self, x, proj, leaf, act=None, layer: int = 0):
        """One layer's MLP over the post-attention-norm ``x``: ``(out, aux)``,
        aux the layer's load-balancing loss (None for a dense MLP).
        ``proj(name, x)`` runs the projection ``name`` (a path) under
        :attr:`mlp_name`, ``leaf(path)`` reads a leaf there; ``act``, when
        given, is :meth:`mlp_act` of x computed already; ``layer`` as in
        :meth:`layer_param_shapes`. Both forwards (the plain and cached
        ``__call__`` and every recompute granularity of :meth:`forward`) run
        the MLP through here."""
        if act is None:
            act = self.mlp_act(x, proj, leaf)
        return proj("down_proj", act), None

    @classmethod
    def _stays_fp32(cls, path: str) -> bool:
        """Layer leaves the training forward does not cast to the compute
        dtype: the norms' scales."""
        return path.endswith("/scale")

    @classmethod
    def _check_config(cls, config):
        if getattr(config, "hidden_act", "silu") != "silu":
            raise NotImplementedError(f"hidden_act {config.hidden_act!r}: the port serves SwiGLU (silu) models")
        if getattr(config, "rms_norm_add_unit_offset", False):
            raise NotImplementedError("rms_norm_add_unit_offset (gemma) is not part of the port yet")

    # ------------------------------------------------------------------ forward
    @property
    def device(self) -> torch.device:
        return self.params["model"]["embed_tokens"]["embedding"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["model"]["embed_tokens"]["embedding"].dtype

    def _forward_dtype(self, params: Optional[dict] = None) -> torch.dtype:
        """The dense forward's compute dtype by default: the embedding's."""
        return (self.params if params is None else params)["model"]["embed_tokens"]["embedding"].dtype

    def _gen_forward(self, params, input_ids, attention_mask, position_ids, cache, quantization_config):
        """``generate``'s forward: the cached dense forward over ``params``."""
        return self(input_ids, params=params, quantization_config=quantization_config,
                    attention_mask=attention_mask, position_ids=position_ids, cache=cache)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None, params: Optional[dict] = None,
                 quantization_config=None,
                 observer: Optional[Callable[[str, torch.Tensor], None]] = None, attention_mask=None,
                 position_ids=None, cache: Optional[KVCache] = None):
        """Dense causal forward over ``input_ids`` [B, T] (positions 0..T-1),
        computed in ``dtype`` (default: the parameters' dtype; each layer's
        weights are cast as the layer runs). Returns logits [B, T, V].

        The cached path (JAX ``LlamaModule`` with a cache, ``:224-286``):
        ``attention_mask`` [B, S] is the padding mask over the key positions
        (1 = keep), ``position_ids`` [B, T] the rope positions (default: from
        the cache's offset), and ``cache`` a ``KVCache`` whose layers take
        this call's keys and values at its offset, in place. With a cache the
        call returns ``(logits, cache)``, the cache's offset advanced by T.
        With a cache or a mask, attention runs
        ``ops.flash_attention.dot_product_attention_dense`` over causal,
        padding and (``sliding_window``) window masks; a call with neither
        keeps the inline attention below.

        ``params`` (default ``self.params``) may hold quantized leaves
        (``quantization.QuantizedModel``): every projection goes through
        ``quantization.linear``, the dispatch the paged model's ``_mm`` runs,
        under ``quantization_config``. ``observer(path, x)``, when given, sees
        each projection's input before it runs, keyed by the unrolled kernel
        path (``model/layers_3/self_attn/q_proj/kernel``, ``lm_head/kernel``):
        the calibration hook of ``quantization.collect_act_scales`` and
        ``collect_hessians`` (the JAX package's ``nn.intercept_methods``)."""
        from ...quantization.quantization_utils import linear  # here: the quantization package imports this one

        cfg = self.config
        params = self.params if params is None else params
        dtype = dtype or params["model"]["embed_tokens"]["embedding"].dtype
        m = params["model"]
        B, T = input_ids.shape
        N = cfg.num_attention_heads
        eps = cfg.rms_norm_eps
        scale = self.attn_scale()
        embed = m["embed_tokens"]["embedding"]
        h = embed[input_ids].to(dtype)
        if getattr(cfg, "scale_embeddings", False):
            h = h * torch.tensor(cfg.hidden_size**0.5, dtype=h.dtype)
        offset = cache.offset if cache is not None else 0
        pos = torch.arange(T, device=h.device)
        if position_ids is None:
            position_ids = (pos + offset)[None, :].expand(B, T)
        cos, sin = self.attn_rope(position_ids, h.device)
        unrolled = not scanned(m)
        dense = cache is not None or attention_mask is not None
        if dense:
            S = cache.keys.shape[2] if cache is not None else T
            mask = dense_attention_mask(B, T, S, h.device, attention_mask, None, offset,
                                        getattr(cfg, "sliding_window", None))
        else:
            causal = pos[None, :] <= pos[:, None]  # [T(q), T(kv)]
            window = getattr(cfg, "sliding_window", None)
            if window is not None:
                causal = causal & (pos[None, :] > pos[:, None] - window)

        def mm(p, name, x, where):
            if observer is not None:
                observer(f"{where}/{name}/kernel", x)
            return linear(_get(p, name), x, dtype, quantization_config)

        def io(p, where):  # a hook's (proj, leaf) over the subtree p at the unrolled path `where`
            return (lambda name, x: mm(p, name, x, where)), (lambda path: _get(p, path))

        for i in range(cfg.num_hidden_layers):
            lp = layer_tree(m, i)
            x = rms_norm(h, lp["input_layernorm"]["scale"], eps)
            attn, at = lp["self_attn"], f"model/layers_{i}/self_attn"
            q, k, v = self.attn_qkv(x, *io(attn, at), cos, sin)
            if dense:
                if cache is not None:
                    k, v = update_layer_kv(*cache.layer(i), k, v, offset)
                o = dot_product_attention_dense(q, k, v, mask, scale)
            else:
                group = N // k.shape[2]
                if group != 1:
                    k = k.repeat_interleave(group, dim=2)
                    v = v.repeat_interleave(group, dim=2)
                s = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * scale
                s = torch.where(causal, s, torch.full_like(s, -1e30))
                o = torch.einsum("bnts,bsnh->btnh", torch.softmax(s, dim=-1), v.float()).to(dtype)
            h = h + mm(attn, "o_proj", self.attn_output(o), at)
            x = rms_norm(h, lp["post_attention_layernorm"]["scale"], eps)
            ml = f"model/layers_{i}/{self.mlp_name}"
            out, _ = self.mlp(x, *io(lp[self.mlp_name], ml), layer=i if unrolled else 0)
            h = h + out
        h = rms_norm(h, m["norm"]["scale"], eps)
        if "lm_head" in params:
            if observer is not None:
                observer("lm_head/kernel", h)
            logits = h @ params["lm_head"]["kernel"].to(dtype)
        else:
            logits = h @ embed.T.to(dtype)
        if cache is None:
            return logits
        return logits, KVCache(keys=cache.keys, values=cache.values, offset=offset + T)

    # ------------------------------------------------------------------ training forward
    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, position_ids=None,
                segment_ids=None, attention_mask=None, prefix_kv=None, return_aux: bool = False):
        """Differentiable causal forward over ``input_ids`` [B, T]: logits
        [B, T, V] in ``compute_dtype`` (the trunk is :meth:`hidden_states`),
        or with ``return_aux`` ``(logits, aux)``, aux the layers' summed
        load-balancing losses over ``num_hidden_layers`` (a 0-dim fp32
        tensor; None for a dense MLP), which the JAX model carries through its
        layers (``modeling.py:328-330``, ``:466``). Kernels and biases are cast to the
        compute dtype, norms stay fp32, and the tied head is ``h @ embed.T``
        (the JAX ``dtype=compute, param_dtype=float32`` model). With
        ``config.recompute``, ``recompute_granularity`` ``"full"`` recomputes
        each layer in the backward; the others keep, by the JAX tags
        ``attn_qkv`` (post-rope q/k/v), ``core_attn`` (the attention output,
        with the flash call's log-sum-exp) and ``mlp_act`` (silu(gate) * up):

        - ``full_attn``: everything but q/k/v and the attention output;
        - ``core_attn``: everything but the attention output;
        - ``save_core_attn``: the attention output only;
        - ``save_qkv_attn``: q/k/v and the attention output;
        - ``save_attn_mlp``: q/k/v, the attention output and ``mlp_act``
          (as ``save_qkv_attn`` for an MLP without that tag);
        - ``save_dots``: the outputs of the matrix products (``aten.mm``);
        - ``offload_attn``: q/k/v and the attention output in host memory
          (the output also stays on the device as the next segment's input).

        Every policy computes the same forward: only what the backward
        recomputes differs. An unknown granularity raises ``ValueError``.
        A padding ``attention_mask`` [B, T] goes to the attention dispatcher,
        as in the JAX ``LlamaAttention`` (:261-274): such a call runs its
        XLA-path counterpart rather than the flash kernels."""
        h, table, aux = self._trunk(input_ids, params, position_ids, segment_ids, attention_mask, prefix_kv)
        params = self.params if params is None else params
        if "lm_head" in params:
            logits = h @ params["lm_head"]["kernel"].to(table.dtype)
        else:
            logits = h @ table.T
        return (logits, aux) if return_aux else logits

    def hidden_states(self, input_ids: torch.Tensor, params: Optional[dict] = None, position_ids=None,
                      segment_ids=None, attention_mask=None, prefix_kv=None) -> torch.Tensor:
        """The training forward's final-norm hidden states [B, T, D] (the JAX
        ``LlamaModule``'s ``last_hidden_state``), differentiable.

        ``prefix_kv`` [L, 2, P, K, H] is a learned prefix of keys and values
        ahead of every row (``peft.PrefixModelForCausalLM``; the JAX package
        pre-fills a ``KVCache`` with it, ``prefix_model.py:128-152``): each
        layer attends over the prefix concatenated with its own keys and
        values, in the cache's dtype (bf16 under a bf16 compute dtype, else
        fp32), from query offset P, through the dense path, with P ones ahead
        of a given ``attention_mask``; rope positions stay 0..T-1. The
        concatenation keeps the prefix in the autograd graph, where the
        cached ``__call__`` writes a cache in place."""
        return self._trunk(input_ids, params, position_ids, segment_ids, attention_mask, prefix_kv)[0]

    def _trunk(self, input_ids, params, position_ids, segment_ids, attention_mask, prefix_kv):
        """(final-norm hidden states, the embedding table in the compute
        dtype, the load-balancing loss or None)."""
        cfg = self.config
        params = self.params if params is None else params
        if getattr(cfg, "attention_dropout", 0.0):
            raise NotImplementedError("forward: attention dropout is not part of the port yet "
                                      "(ROADMAP Queue 1 item 15)")
        recompute = bool(getattr(cfg, "recompute", False))
        granularity = getattr(cfg, "recompute_granularity", "full")
        if recompute and granularity not in RECOMPUTE_GRANULARITIES:
            raise ValueError(f"unknown recompute_granularity {granularity!r}; one of {RECOMPUTE_GRANULARITIES}")
        m = params["model"]
        embed = m["embed_tokens"]["embedding"]
        dtype = self.compute_dtype or embed.dtype
        B, T = input_ids.shape
        K, H = cfg.num_key_value_heads, cfg.head_dim
        eps = cfg.rms_norm_eps
        scale = self.attn_scale()
        table = embed.to(dtype)
        h = F.embedding(input_ids.long(), table)
        if getattr(cfg, "scale_embeddings", False):
            h = h * torch.tensor(cfg.hidden_size**0.5, dtype=h.dtype)
        if position_ids is None:
            position_ids = torch.arange(T, device=h.device)[None, :].expand(B, T)
        cos, sin = self.attn_rope(position_ids, h.device)
        window = getattr(cfg, "sliding_window", None)
        prefix = None
        if prefix_kv is not None:
            if segment_ids is not None:
                raise ValueError("prefix_kv: a learned prefix takes padded batches, not packed segment_ids")
            P = prefix_kv.shape[2]
            prefix = prefix_kv.to(torch.bfloat16 if dtype == torch.bfloat16 else torch.float32).unbind(0)
            if attention_mask is not None:
                attention_mask = torch.cat([torch.ones(B, P, dtype=attention_mask.dtype, device=attention_mask.device),
                                            attention_mask], dim=1)

        layers = self._layer_leaves(m, dtype)
        ml = self.mlp_name + "/"
        unrolled = not scanned(m)

        def dense(lp, name, x):
            y = x @ lp[name + "/kernel"]
            bias = lp.get(name + "/bias")
            return y if bias is None else y + bias

        def hook_io(lp, sub):  # a hook's (proj, leaf) over this layer's leaves under `sub`
            return (lambda name, x: dense(lp, sub + name, x)), (lambda path: lp[sub + path])

        def mlp_io(lp):
            return hook_io(lp, ml)

        def qkv(x, lp):
            return self.attn_qkv(x, *hook_io(lp, "self_attn/"), cos, sin)

        def attn_in(h, lp):
            return qkv(rms_norm(h, lp["input_layernorm/scale"], eps), lp)

        def attn_core(q, k, v, lp):
            pkv = lp.get("prefix_kv")
            if pkv is None:
                return dot_product_attention(q, k, v, attention_mask=attention_mask, segment_ids=segment_ids,
                                             scale=scale, window=window)
            P = pkv.shape[1]
            k = torch.cat([pkv[0][None].expand(B, P, K, H), k.to(pkv.dtype)], dim=1)
            v = torch.cat([pkv[1][None].expand(B, P, K, H), v.to(pkv.dtype)], dim=1)
            return dot_product_attention(q, k, v, attention_mask=attention_mask, q_offset=P, scale=scale,
                                         window=window)

        def o_proj(o, lp):
            return dense(lp, "self_attn/o_proj", self.attn_output(o))

        def mlp(h, lp):  # (h + MLP(norm(h)), aux)
            out, aux = self.mlp(rms_norm(h, lp["post_attention_layernorm/scale"], eps), *mlp_io(lp),
                                layer=lp["layer"])
            return h + out, aux

        def attn_out_act(h, o, lp):
            h = h + o_proj(o, lp)
            return h, self.mlp_act(rms_norm(h, lp["post_attention_layernorm/scale"], eps), *mlp_io(lp))

        def attn_out_mlp(h, o, lp):
            return mlp(h + o_proj(o, lp), lp)

        def layer(h, lp):
            return attn_out_mlp(h, attn_core(*attn_in(h, lp), lp), lp)

        ckpt = functools.partial(checkpoint, use_reentrant=False)
        aux_sum = None
        for i in range(cfg.num_hidden_layers):
            lp = dict(layers[i], layer=i if unrolled else 0)
            if prefix is not None:
                lp["prefix_kv"] = prefix[i]
            if not recompute:
                h, aux = layer(h, lp)
            elif granularity == "full":
                h, aux = ckpt(layer, h, lp)
            elif granularity == "full_attn":
                x = rms_norm(h, lp["input_layernorm/scale"], eps)
                h, aux = mlp(h + ckpt(lambda x, lp: o_proj(attn_core(*qkv(x, lp), lp), lp), x, lp), lp)
            elif granularity == "core_attn":
                q, k, v = attn_in(h, lp)
                h, aux = mlp(h + ckpt(lambda q, k, v, lp: o_proj(attn_core(q, k, v, lp), lp), q, k, v, lp), lp)
            elif granularity == "save_core_attn":
                o = ckpt(lambda h, lp: attn_core(*attn_in(h, lp), lp), h, lp)
                h, aux = ckpt(attn_out_mlp, h, o, lp)
            elif granularity == "save_attn_mlp" and self.has_mlp_act(lp["layer"]):
                q, k, v = ckpt(attn_in, h, lp)
                h, act = ckpt(attn_out_act, h, attn_core(q, k, v, lp), lp)
                out, aux = self.mlp(None, *mlp_io(lp), act=act, layer=lp["layer"])
                h = h + out
            elif granularity == "save_dots":
                h, aux = ckpt(layer, h, lp, context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                                         _save_dots))
            else:  # save_qkv_attn, offload_attn; save_attn_mlp over an MLP without the mlp_act tag
                q, k, v = ckpt(attn_in, h, lp)
                if granularity == "offload_attn":
                    with _offload_to_host():
                        o = attn_core(q, k, v, lp)
                else:
                    o = attn_core(q, k, v, lp)
                h, aux = ckpt(attn_out_mlp, h, o, lp)
            if aux is not None:
                aux_sum = aux if aux_sum is None else aux_sum + aux
        if aux_sum is not None:
            aux_sum = aux_sum / cfg.num_hidden_layers
        return rms_norm(h, m["norm"]["scale"], eps), table, aux_sum

    def _layer_leaves(self, m: dict, dtype: torch.dtype):
        """Each layer's flat leaves ``{path: tensor}`` of the ``model``
        subtree ``m`` in either layout, in the compute ``dtype`` but for
        :meth:`_stays_fp32` leaves. A scanned leaf is cast once and viewed
        per layer, so the backward stacks the layers' grads once instead of
        scattering into ``[L, ...]``."""
        L = self.config.num_hidden_layers

        def cast(path, leaf):
            return leaf if self._stays_fp32(path) else leaf.to(dtype)

        if scanned(m):
            per = {path: cast(path, leaf).unbind(0) for path, leaf in flatten_params(m["layers"]).items()}
            return [{path: ts[i] for path, ts in per.items()} for i in range(L)]
        return [{path: cast(path, leaf) for path, leaf in flatten_params(m[f"layers_{i}"]).items()} for i in range(L)]

    # ------------------------------------------------------------------ accounting
    def get_model_flops(self, batch_size: int, seq_length: int) -> float:
        """Training flops of one step (``modeling.py:675``): 6·N·tokens for the
        matmuls plus the causal attention term, forward and backward."""
        cfg = self.config
        n = self.num_parameters()
        return 6.0 * n * batch_size * seq_length + 6.0 * cfg.num_hidden_layers * cfg.head_dim * \
            cfg.num_attention_heads * (seq_length**2) * batch_size


class LlamaForSequenceClassification(LlamaForCausalLM):
    """The LLaMA trunk with a ``score`` head [D, num_labels] over the hidden
    state of each row's last token (JAX ``LlamaForSequenceClassificationModule``,
    ``modeling.py:532-555``): position ``attention_mask.sum - 1`` (at least 0)
    under a right-padding mask, else T - 1. The tree is the causal model's
    without ``lm_head``; a causal checkpoint loads with ``score`` initialized
    (``_keys_to_ignore_on_load_missing``) and its head left unread."""

    _keys_to_ignore_on_load_missing = [r"score"]

    @classmethod
    def param_shapes(cls, config) -> Dict[str, Tuple[int, ...]]:
        shapes = {k: v for k, v in super().param_shapes(config).items() if not k.startswith("lm_head/")}
        shapes["score/kernel"] = (config.hidden_size, int(config.num_labels))
        return shapes

    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, position_ids=None,
                segment_ids=None, attention_mask=None, prefix_kv=None) -> torch.Tensor:
        """Differentiable: logits [B, num_labels] in ``compute_dtype``."""
        params = self.params if params is None else params
        h = self.hidden_states(input_ids, params, position_ids, segment_ids, attention_mask, prefix_kv)
        B, T = input_ids.shape
        if attention_mask is not None:
            last = (attention_mask.sum(dim=-1).to(torch.int64) - 1).clamp(min=0)
        else:
            last = torch.full((B,), T - 1, dtype=torch.int64, device=h.device)
        pooled = h[torch.arange(B, device=h.device), last.to(h.device)]
        return pooled @ params["score"]["kernel"].to(h.dtype)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, attention_mask=None, params: Optional[dict] = None) -> torch.Tensor:
        """:meth:`forward` without a gradient."""
        return self.forward(input_ids, params=params, attention_mask=attention_mask)
