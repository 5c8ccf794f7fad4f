"""VeRA: vector-based random-matrix adaptation over the port's LLaMA-family models.

Port of ``paddlenlp_tpu/peft/vera/vera_model.py``. One pair of frozen random
bases (A [in, r], B [r, out]) is shared by every adapted kernel of the same
shape; each adapted kernel trains two vectors, ``vera_d`` [..., r] (init
``d_initial``) and ``vera_b`` [..., out] (init 0):

    W' = W + ((A * d) @ B) * b

As for LoRA there is no module surgery: the vectors are sibling leaves of
each kernel (the stacked ``[L]`` axis kept on them), the bases sit under
``vera_shared/{in}x{out}``, and the forward merges before the unchanged base
forward runs.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ...transformers.conversion_utils import flatten_params, sorted_tree, unflatten_params
from ...utils.log import logger
from ..facade import AdapterFacade, compile_targets
from .vera_config import DEFAULT_TARGETS, VeRAConfig

__all__ = ["VeRAModel"]

VERA_WEIGHTS_NAME = "vera_model.safetensors"
SHARED_KEY = "vera_shared"


def _merge_vera(params: dict) -> dict:
    """The base tree with ``kernel + ((A * d) @ B) * b`` in fp32 wherever
    vectors exist, cast to the kernel's dtype (JAX ``_merge_vera``),
    differentiable in the vectors; the VeRA leaves and bases are dropped."""
    shared = params.get(SHARED_KEY, {})

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items() if k not in (SHARED_KEY, "vera_d", "vera_b")}
        if "kernel" in out and "vera_d" in node and "vera_b" in node:
            k = out["kernel"]
            base = shared[f"{k.shape[-2]}x{k.shape[-1]}"]
            a, b = base["A"].float(), base["B"].float()  # [in, r], [r, out]
            d, bv = node["vera_d"].float(), node["vera_b"].float()  # [..., r], [..., out]
            delta = ((a * d[..., None, :]) @ b) * bv[..., None, :]  # per-layer axes broadcast over the bases
            out["kernel"] = (k.float() + delta).to(k.dtype)
        return out

    return walk(params)


class VeRAModel(AdapterFacade):
    """Wraps a port causal LM: ``params`` is the base tree plus the VeRA
    vectors and the shared bases (fp32, on the model's device). Its
    directory holds ``vera_config.json``, the vectors and the bases."""

    WEIGHTS_NAME = VERA_WEIGHTS_NAME
    CONFIG_CLASS = VeRAConfig

    def __init__(self, model, vera_config: Optional[VeRAConfig] = None, params: Optional[dict] = None):
        self.model = model
        self.vera_config = self.peft_config = vera_config or VeRAConfig()
        self.config = model.config
        self.generation_config = model.generation_config
        self._target_res = compile_targets(self.vera_config.target_modules or DEFAULT_TARGETS)
        self.params = params if params is not None else self._init_vera_params(model.params)

    @staticmethod
    def _trainable(path: str) -> bool:
        return "/vera_d" in path or "/vera_b" in path

    @classmethod
    def _saved(cls, path: str) -> bool:
        return cls._trainable(path) or path.startswith(SHARED_KEY + "/")

    def _init_vera_params(self, base_params: dict) -> dict:
        """Bases drawn per new shape from ``np.random.default_rng(seed)`` in
        the JAX package's order (A ~ N(0, 1)/sqrt(in), then B ~ N(0, 1)/sqrt(r));
        ``vera_d`` = ``d_initial``, ``vera_b`` = 0."""
        cfg = self.vera_config
        rng = np.random.default_rng(cfg.seed)
        out = dict(flatten_params(base_params))
        shared: Dict[str, np.ndarray] = {}
        added = 0
        for path, leaf in flatten_params(sorted_tree(base_params)).items():
            if not path.endswith("/kernel") or leaf.dim() < 2 or not self._matches(path):
                continue
            in_dim, out_dim = leaf.shape[-2], leaf.shape[-1]
            lead = tuple(leaf.shape[:-2])
            key = f"{in_dim}x{out_dim}"
            if f"{SHARED_KEY}/{key}/A" not in shared:
                # the quotients are float64 (a float64 divisor), rounded to
                # fp32 as the JAX package's jnp.asarray rounds them
                shared[f"{SHARED_KEY}/{key}/A"] = \
                    (rng.standard_normal((in_dim, cfg.r)).astype(np.float32) / np.sqrt(in_dim)).astype(np.float32)
                shared[f"{SHARED_KEY}/{key}/B"] = \
                    (rng.standard_normal((cfg.r, out_dim)).astype(np.float32) / np.sqrt(cfg.r)).astype(np.float32)
            prefix = path.rsplit("/", 1)[0]
            out[prefix + "/vera_d"] = torch.full(lead + (cfg.r,), cfg.d_initial, dtype=torch.float32,
                                                 device=leaf.device)
            out[prefix + "/vera_b"] = torch.zeros(lead + (out_dim,), dtype=torch.float32, device=leaf.device)
            added += 1
        if added == 0:
            raise ValueError(f"no modules matched VeRA target patterns {cfg.target_modules}")
        device = self.model.device
        out.update({k: torch.from_numpy(v).to(device) for k, v in shared.items()})
        logger.info(f"VeRA: {added} kernels adapted (r={cfg.r}, {len(shared) // 2} shared basis pairs)")
        return unflatten_params(out)

    # ------------------------------------------------------------------ forward
    def merged_params(self, params: Optional[dict] = None) -> dict:
        """The base tree with the adaptation of ``params`` (default: the
        facade's) folded into its kernels."""
        return _merge_vera(self.params if params is None else params)

    def forward(self, input_ids: torch.Tensor, params: Optional[dict] = None, **kwargs) -> torch.Tensor:
        """The base model's training forward over the merged weights,
        differentiable in the vectors."""
        return self.model.forward(input_ids, params=self.merged_params(params), **kwargs)

    @torch.no_grad()
    def __call__(self, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The base model's dense forward over the merged weights."""
        return self.model(input_ids, dtype=dtype, params=self.merged_params())

    def generate(self, *args, **kwargs):
        """The base model's ``generate`` over the merged weights."""
        with torch.no_grad():
            merged = self.merged_params(kwargs.pop("params", None))
        return self.model.generate(*args, params=merged, **kwargs)
