"""AdamW with layer-wise learning-rate decay.

Port of ``paddlenlp_tpu/ops/optimizer/adamwdl.py`` (AdamWDL, the BERT/ELECTRA
fine-tuning staple): depth d gets lr scale ``layerwise_decay^(n_layers - d)``.
The depth of a parameter is parsed from its path (``layers_<i>`` /
``h_<i>`` segments; embeddings get depth -1, heads and final norms
``n_layers``). A scanned ``[L]``-stacked parameter (``model/layers/...``, the
layout both packages hold) cannot vary its lr across its own leading axis with
one scalar: it gets the mean of the layers' scales (JAX :42-73).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Union

import torch

from .adamw import AdamW

__all__ = ["adamwdl", "layerwise_lr_decay_mask"]

_DEPTH_RE = re.compile(r"(?:layers?|h|blocks?)_(\d+)\b")


def _param_depth(path: str, n_layers: int) -> int:
    m = _DEPTH_RE.search(path)
    if m:
        return int(m.group(1))
    if any(k in path for k in ("embed", "wte", "wpe", "word_embeddings", "position_embeddings")):
        return -1
    if "/layers/" in f"/{path}" or "/h/" in f"/{path}":
        return -2  # scanned stack: one shared tensor spans all depths
    return n_layers  # head / final norm


def layerwise_lr_decay_mask(params: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, str]:
    """The depth label of each parameter of a flat ``{path: tensor}`` dict."""
    return {p: str(_param_depth(p, n_layers)) for p in params}


def _scales(n_layers: int, layerwise_decay: float) -> Dict[str, float]:
    scales = {str(d): layerwise_decay ** (n_layers - d) for d in range(n_layers)}
    scales[str(-1)] = layerwise_decay ** (n_layers + 1)
    scales[str(n_layers)] = 1.0
    scales[str(-2)] = sum(layerwise_decay ** (n_layers - d) for d in range(n_layers)) / n_layers
    return scales


class _AdamWDL(AdamW):
    def __init__(self, params, schedule, n_layers: int, layerwise_decay: float, **kw):
        super().__init__(params, schedule, **kw)
        scales = _scales(n_layers, layerwise_decay)
        self._scale = {p: scales[d] for p, d in layerwise_lr_decay_mask(params, n_layers).items()}

    def lr_scale(self, name: str) -> float:
        return self._scale[name]


def adamwdl(params: Dict[str, torch.Tensor], learning_rate: Union[Callable[[int], float], float], n_layers: int,
            layerwise_decay: float = 0.8, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            weight_decay: float = 0.01, wd_mask: Optional[Callable[[str], bool]] = None) -> AdamW:
    """AdamW over the flat ``{path: tensor}`` dict ``params`` where depth d
    gets lr scale ``layerwise_decay^(n_layers - d)``. ``wd_mask(path)`` says
    which parameters decay (default: all, as optax's ``mask=None``)."""
    return _AdamWDL(params, learning_rate, n_layers, layerwise_decay, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay, decays=wd_mask or (lambda name: True))
