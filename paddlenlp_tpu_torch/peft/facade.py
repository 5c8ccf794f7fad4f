"""What the port's PEFT facades share (LoRA, prefix tuning, VeRA).

A facade wraps a base causal LM ``model``; its ``params`` is the base tree
plus the adapter leaves, and a forward reads both. A subclass sets
``WEIGHTS_NAME`` and ``CONFIG_CLASS``, stores its config as ``peft_config``
(under its own name too), and says which leaf paths train
(:meth:`_trainable`) and which its directory holds (:meth:`_saved`, by
default the trainable ones).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Optional

import torch

from ..transformers.conversion_utils import flatten_params, unflatten_params
from ..utils.log import logger
from ..utils.safetensors_io import SafeFile, save_file

__all__ = ["AdapterFacade", "compile_targets"]


def compile_targets(patterns: Iterable[str]) -> List["re.Pattern"]:
    """A bare module name matches as a word; a pattern with ``/`` or a
    trailing ``$`` is a regex over the path (the JAX package's rule)."""
    return [re.compile(p if p.endswith("$") or "/" in p else rf"\b{p}\b") for p in patterns]


class AdapterFacade:
    WEIGHTS_NAME = ""
    CONFIG_CLASS = None

    @staticmethod
    def _trainable(path: str) -> bool:
        raise NotImplementedError

    @classmethod
    def _saved(cls, path: str) -> bool:
        return cls._trainable(path)

    def _matches(self, kernel_path: str) -> bool:
        module_path = kernel_path.rsplit("/", 1)[0]
        return any(p.search(module_path) or p.search(kernel_path) for p in self._target_res)

    # ------------------------------------------------------------------ training glue
    def trainable_mask(self) -> dict:
        """Tree of bool: True = trainable; the Trainer leaves the rest frozen."""
        return unflatten_params({p: self._trainable(p) for p in flatten_params(self.params)})

    def print_trainable_parameters(self):
        """Log (and return) the trainable and total counts: the trainable
        leaves over every leaf, as the JAX package counts them."""
        flat = flatten_params(self.params)
        total = sum(int(v.numel()) for v in flat.values())
        trainable = sum(int(v.numel()) for p, v in flat.items() if self._trainable(p))
        logger.info(f"trainable params: {trainable:,} / {total:,} ({100 * trainable / total:.3f}%)")
        return trainable, total

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def compute_dtype(self):
        return self.model.compute_dtype

    def num_parameters(self, params: Optional[dict] = None) -> int:
        return self.model.num_parameters(self.params if params is None else params)

    def get_model_flops(self, *args, **kwargs):
        return self.model.get_model_flops(*args, **kwargs)

    # ------------------------------------------------------------------ save/load
    def save_pretrained(self, save_directory: str, params: Optional[dict] = None, **kw):
        """The config and the saved leaves of ``params`` (default: the
        facade's), keyed by tree path in the JAX package's order."""
        os.makedirs(save_directory, exist_ok=True)
        self.peft_config.save_pretrained(save_directory)
        params = self.params if params is None else params
        flat = sorted(flatten_params(params).items(), key=lambda kv: kv[0].split("/"))
        tensors = {p: v.detach().cpu() for p, v in flat if self._saved(p)}
        save_file(tensors, os.path.join(save_directory, self.WEIGHTS_NAME), metadata={"format": "np"})
        logger.info(f"{type(self).__name__} adapters saved to {save_directory}")

    @classmethod
    def saved_leaves(cls, directory: str) -> Dict[str, torch.Tensor]:
        """The leaves a ``save_pretrained`` directory holds, by tree path (on
        the CPU)."""
        with SafeFile(os.path.join(directory, cls.WEIGHTS_NAME)) as sf:
            return {key: sf.get_torch(key) for key in sf.keys()}

    @classmethod
    def from_pretrained(cls, model, path: str):
        """The adapters of a ``save_pretrained`` directory (either package's)
        over ``model``."""
        obj = cls(model, cls.CONFIG_CLASS.from_pretrained(path))
        flat = flatten_params(obj.params)
        for key, t in cls.saved_leaves(path).items():
            if key not in flat:
                logger.warning(f"adapter key {key} not in model; skipping")
                continue
            flat[key] = t.to(flat[key].device)
        obj.params = unflatten_params(flat)
        return obj
