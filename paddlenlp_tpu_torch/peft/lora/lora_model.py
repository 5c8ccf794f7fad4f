"""LoRA adapters over the port's LLaMA-family models: the serving-exchange half.

PyTorch port of ``paddlenlp_tpu/peft/lora/lora_model.py:41-261``. As in the
JAX package there is no module surgery: the LoRA parameters (A [in, r] and
B [r, out], with the stacked ``[L]`` axis kept on scanned kernels) live as
sibling leaves ``lora_A``/``lora_B`` of each targeted ``kernel`` in the same
nested parameter tree, and a forward merges ``W' = W + scaling * A @ B``
before the unchanged base forward runs. The port's tree has the JAX package's
paths, so a JAX ``save_pretrained`` directory loads here and the flat
``{proj}.lora_A`` exchange keys of :meth:`LoRAModel.export_adapter` carry
over one for one into ``serving.tenancy.AdapterRegistry``.

What this module does: the seeded init (the JAX package's numpy draws, so
both packages start from the same adapters), the differentiable merged
:meth:`LoRAModel.forward` the ``Trainer`` trains through (its
``trainable_mask`` leaves only A and B to the optimizer), the merged dense
forward and ``generate``, ``merge_and_unload``,
``save_pretrained``/``from_pretrained`` and ``export_adapter``. The partition
rules need the meshes of ROADMAP Queue 1 item 12b.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from ...transformers.conversion_utils import flatten_params, sorted_tree, unflatten_params
from ...utils.log import logger
from ...utils.safetensors_io import save_file
from ..facade import AdapterFacade, compile_targets
from .lora_config import DEFAULT_TARGETS, LoRAConfig

__all__ = ["LoRAModel"]

LORA_WEIGHTS_NAME = "lora_model.safetensors"


@torch.no_grad()
def _merge_lora(params: dict, scaling: float) -> dict:
    """``kernel + scaling * A @ B`` wherever adapters exist, in fp32, cast back
    to the kernel's dtype; one layer of a stacked ``[L, in, out]`` kernel at a
    time, so the fp32 temporaries stay one layer's size."""

    def merge(kernel, a, b):
        out = torch.empty_like(kernel)
        k2, a2, b2, o2 = (t.reshape((-1,) + tuple(t.shape[-2:])) for t in (kernel, a, b, out))
        for i in range(k2.shape[0]):
            delta = (a2[i].float() @ b2[i].float()) * scaling
            o2[i] = (k2[i].float() + delta).to(kernel.dtype)
        return out

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "kernel" in out and "lora_A" in out and "lora_B" in out:
            out["kernel"] = merge(out["kernel"], out["lora_A"], out["lora_B"])
        return out

    return walk(params)


def _merged_for_training(params: dict, scaling: float) -> dict:
    """The base tree with ``kernel + scaling * A @ B`` wherever adapters
    exist, differentiable in A and B: the product in fp32 (``@`` batches the
    stacked ``[L, in, r] @ [L, r, out]`` layout), cast to the kernel's dtype
    (the fp32 master) as the JAX ``_merge_lora`` does; the forward then casts
    each kernel to the compute dtype. The adapter leaves are dropped."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items() if k not in ("lora_A", "lora_B")}
        if "lora_A" in node and "lora_B" in node:
            k = out["kernel"]
            delta = (node["lora_A"].float() @ node["lora_B"].float()) * scaling
            out["kernel"] = (k.float() + delta).to(k.dtype)
        return out

    return walk(params)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not part of the PyTorch port yet: ROADMAP {item}")


class LoRAModel(AdapterFacade):
    """Wraps a port ``LlamaForCausalLM`` (or ``Qwen2ForCausalLM``): ``params``
    is the base tree plus the ``lora_A``/``lora_B`` leaves (fp32, on the
    model's device). ``save_pretrained`` writes ONLY the adapters
    (``lora_model.safetensors``) and ``lora_config.json``; its ``params`` is
    the tree to save, which a checkpoint passes as its host copy of the live
    adapters (the JAX package ignores it and saves the facade's tree, which
    its trainer leaves at the initial adapters until training ends; ROADMAP
    Queue 3)."""

    WEIGHTS_NAME = LORA_WEIGHTS_NAME
    CONFIG_CLASS = LoRAConfig

    def __init__(self, model, lora_config: Optional[LoRAConfig] = None, params: Optional[dict] = None):
        self.model = model
        self.lora_config = self.peft_config = lora_config or LoRAConfig()
        self.config = model.config
        self._target_res = compile_targets(self.lora_config.target_modules
                                           or [t.rsplit("/", 1)[0] for t in DEFAULT_TARGETS])
        self.params = params if params is not None else self._init_lora_params(model.params)

    @staticmethod
    def _trainable(path: str) -> bool:
        return "/lora_A" in path or "/lora_B" in path

    # ------------------------------------------------------------------ init
    def _init_lora_params(self, base_params: dict) -> dict:
        """A ~ N(0, 1)/sqrt(in) and B = 0 for every targeted kernel, drawn
        from ``np.random.default_rng(0)`` in the JAX package's order."""
        cfg = self.lora_config
        rng = np.random.default_rng(0)
        flat = flatten_params(base_params)
        added = 0
        out = dict(flat)
        for path, leaf in flatten_params(sorted_tree(base_params)).items():
            if not path.endswith("/kernel") or leaf.dim() < 2 or not self._matches(path):
                continue
            shape = tuple(leaf.shape)
            in_dim, out_dim = shape[-2], shape[-1]
            lead = shape[:-2]  # scanned layers keep the [L] axis on the adapters too
            a = rng.standard_normal(lead + (in_dim, cfg.r)).astype(np.float32) / math.sqrt(in_dim)
            b = np.zeros(lead + (cfg.r, out_dim), dtype=np.float32)
            prefix = path.rsplit("/", 1)[0]
            out[prefix + "/lora_A"] = torch.from_numpy(a).to(leaf.device)
            out[prefix + "/lora_B"] = torch.from_numpy(b).to(leaf.device)
            added += 1
        if added == 0:
            raise ValueError(f"no modules matched LoRA target patterns {cfg.target_modules}")
        logger.info(f"LoRA: adapters added to {added} kernels (r={cfg.r}, scaling={cfg.scaling:.3f})")
        return unflatten_params(out)

    # ------------------------------------------------------------------ trainable mask (data only)
    def mark_only_lora_as_trainable(self) -> dict:
        """The trainable mask (JAX ``:109``): the Trainer reads it and leaves
        every other leaf frozen."""
        return self.trainable_mask()

    # ------------------------------------------------------------------ facade
    def merged_params(self, params: Optional[dict] = None) -> dict:
        """The base tree with every adapter of ``params`` (default: the
        facade's) folded into its kernel."""
        merged = _merge_lora(self.params if params is None else params, self.lora_config.scaling)
        return unflatten_params({p: v for p, v in flatten_params(merged).items() if "/lora_" not in p})

    def __call__(self, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The base model's dense forward over the merged weights: logits
        [B, T, V]."""
        orig = self.model.params
        self.model.params = self.merged_params()
        try:
            return self.model(input_ids, dtype=dtype)
        finally:
            self.model.params = orig

    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, **kwargs) -> torch.Tensor:
        """The base model's training forward over the merged weights,
        differentiable in the adapters (JAX ``_LoRAMergedModule.apply``);
        ``kwargs`` are the base forward's (``attention_mask``,
        ``position_ids``, ``segment_ids``)."""
        merged = _merged_for_training(self.params if params is None else params, self.lora_config.scaling)
        return self.model.forward(input_ids, params=merged, **kwargs)

    def generate(self, *args, **kwargs):
        """The base model's ``generate`` over the merged weights (JAX
        ``:156-163``); ``params``, when given, is a LoRA tree to merge in
        place of the facade's."""
        merged = self.merged_params(kwargs.pop("params", None))
        return self.model.generate(*args, params=merged, **kwargs)

    def get_partition_rules_instance(self):
        _not_ported("LoRA partition rules (meshes)", "Queue 1 item 12b")

    # ------------------------------------------------------------------ save/load
    def merge_and_unload(self):
        """Fold the adapters into the base model's kernels, install that tree
        as the model's parameters and return the model."""
        self.model.params = self.merged_params()
        return self.model

    def export_adapter(self, path: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Flatten the adapters into the serving exchange format: flat
        ``{proj}.lora_A`` [L, d_in, r] / ``{proj}.lora_B`` [L, r, d_out] fp32
        arrays keyed by projection name; per-layer trees stack in layer order.
        With ``path``, also writes a safetensors file carrying ``scaling`` in
        its metadata. Either is a direct ``AdapterRegistry.add`` source, in
        this package or the JAX one."""
        layer_re = re.compile(r"/layers_(\d+)/")
        by_key: Dict[str, Dict[Optional[int], np.ndarray]] = {}
        for p, v in flatten_params(self.params).items():
            part = p.rsplit("/", 1)[-1]
            if part not in ("lora_A", "lora_B"):
                continue
            proj = p.rsplit("/", 2)[-2]
            m = layer_re.search(p)
            layer = int(m.group(1)) if m else None
            by_key.setdefault(f"{proj}.{part}", {})[layer] = v.detach().float().cpu().numpy()
        if not by_key:
            raise ValueError("no LoRA adapters to export")
        L = int(self.config.num_hidden_layers)
        out: Dict[str, np.ndarray] = {}
        for key in sorted(by_key):
            layers = by_key[key]
            if None in layers:  # scanned: already [L, d, r]
                out[key] = layers[None]
            else:
                if sorted(layers) != list(range(L)):
                    raise ValueError(f"adapter {key} covers layers {sorted(layers)}; want all of 0..{L - 1}")
                out[key] = np.stack([layers[i] for i in range(L)])
        if path is not None:
            save_file(out, path, metadata={"format": "np", "scaling": str(self.lora_config.scaling)})
            logger.info(f"LoRA adapter exported to {path} "
                        f"({len(out)} tensors, scaling {self.lora_config.scaling:.3f})")
        return out
