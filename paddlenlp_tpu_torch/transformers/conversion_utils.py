"""Checkpoint key conversion: HF flat names <-> the nested param paths.

PyTorch port of ``paddlenlp_tpu/transformers/conversion_utils.py:201-265``. The
port keeps the JAX package's parameter layout so both packages hold the same
tree: HF ``nn.Linear.weight`` ``[out, in]`` becomes ``kernel`` ``[in, out]``
(transposed), norms' ``.weight`` becomes ``.scale``, embeddings'
``.weight`` becomes ``.embedding``, and the decoder layers are stacked on a
leading ``[L]`` axis under ``model/layers`` (the scanned layout). The reverse
maps (:meth:`StateDictNameMapping.reverse`, :meth:`StackedLayerMapping.reverse_unstack`)
write the HF layout back.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["StateDictNameMapping", "StackedLayerMapping", "auto_name_mappings", "flatten_params",
           "resolve_stacked_key", "sorted_tree", "tensor_from_numpy", "unflatten_params", "target_to_hf_key"]


@dataclasses.dataclass
class StateDictNameMapping:
    """One target param <- one source checkpoint key."""

    source_name: str  # HF flat key, e.g. "model.embed_tokens.weight"
    target_name: str  # our flat path, e.g. "model/embed_tokens/embedding"
    action: Optional[str] = None  # None | "transpose"

    def apply_stack(self, get_source: Callable[[str], Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        src = get_source(self.source_name)
        if src is None or self.action != "transpose":
            return src
        return src.T.contiguous()

    def reverse(self, t: torch.Tensor) -> torch.Tensor:
        """Our tensor -> the checkpoint's."""
        return t.T.contiguous() if self.action == "transpose" else t.contiguous()


@dataclasses.dataclass
class StackedLayerMapping:
    """One stacked target param ``[d0, d1, ..., ...]`` <- ``prod(d_i)``
    checkpoint keys (``paddlenlp_tpu/transformers/conversion_utils.py:57-87``).
    ``dims`` holds one entry per stacked leading axis, ``(n_layers,)`` or
    ``(n_layers, n_experts)`` for stacked MoE experts, and the template one
    ``{}`` a dim; the keys run over ``itertools.product`` of the dims. The
    bare ``n_layers`` form is ``dims=(n_layers,)``."""

    source_template: str  # e.g. "model.layers.{}.self_attn.q_proj.weight"
    target_name: str  # e.g. "model/layers/self_attn/q_proj/kernel"
    n_layers: int = 0
    action: Optional[str] = None  # applied per slice
    dims: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.dims is None:
            self.dims = (self.n_layers,)

    def _indices(self):
        return itertools.product(*(range(d) for d in self.dims))

    def source_names(self) -> List[str]:
        return [self.source_template.format(*idx) for idx in self._indices()]

    def apply_stack(self, get_source: Callable[[str], Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        slices = []
        for name in self.source_names():
            arr = get_source(name)
            if arr is None:
                return None
            slices.append(arr.T if self.action == "transpose" else arr)
        stacked = torch.stack(slices, dim=0)
        return stacked.reshape(tuple(self.dims) + stacked.shape[1:])

    def reverse_unstack(self, t: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Our stacked ``[d0, d1, ..., ...]`` tensor -> one checkpoint tensor
        per index, in ``itertools.product`` order."""
        flat = t.reshape((-1,) + tuple(t.shape[len(self.dims):]))
        return {name: (flat[j].T if self.action == "transpose" else flat[j]).contiguous()
                for j, name in enumerate(self.source_names())}


def flatten_params(tree, sep: str = "/") -> Dict[str, object]:
    """Nested dict -> { 'a/b/c': leaf } (insertion-ordered, deterministic)."""
    out: Dict[str, object] = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in node:
                rec(prefix + [str(k)], node[k])
        else:
            out[sep.join(prefix)] = node

    rec([], tree)
    return out


def unflatten_params(flat: Dict[str, object], sep: str = "/") -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        keys = path.split(sep)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


#: numpy dtypes of ``ml_dtypes`` (the JAX package's bf16 and fp8 leaves), by
#: name: they enter torch as their raw bits, viewed as the torch dtype
_RAW_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16), "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(arr) -> torch.Tensor:
    """A CPU tensor holding a copy of ``arr`` (a numpy array, or anything
    ``np.asarray`` accepts, such as a JAX array), bit for bit: ``ml_dtypes``
    bf16 and float8_e4m3fn arrays included."""
    arr = np.array(arr, copy=True)
    raw = _RAW_VIEWS.get(arr.dtype.name)
    if raw is None:
        return torch.from_numpy(arr)
    return torch.from_numpy(arr.view(raw[0])).view(raw[1])


def sorted_tree(node):
    """The tree with every level's keys in sorted order: the order the JAX
    package's parameter trees flatten in."""
    if not isinstance(node, dict):
        return node
    return {k: sorted_tree(node[k]) for k in sorted(node)}


def resolve_stacked_key(path: str, flat_stacked: Dict[str, object]):
    """Map an unrolled param path (``model/layers_3/.../kernel``) onto its
    stacked counterpart: ``(stacked_path, (3,))``, one index per stacked
    leading axis in nesting order, or None when the path exists verbatim or
    cannot be resolved (``conversion_utils.py:146`` of the JAX package).
    Calibration results keyed by unrolled paths (activation scales, GPTQ
    Hessians) write back into the stacked tree through it."""
    if path in flat_stacked:
        return None
    segs = path.split("/")
    cand = [i for i, s in enumerate(segs) if re.fullmatch(r".+_\d+", s)]
    for r in range(1, len(cand) + 1):
        for combo in itertools.combinations(cand, r):
            segs2 = list(segs)
            idxs = []
            for i in combo:
                base, n = segs2[i].rsplit("_", 1)
                segs2[i] = base
                idxs.append(int(n))
            key = "/".join(segs2)
            if key in flat_stacked:
                return key, tuple(idxs)
    return None


_LAYERS_RE = re.compile(r"\blayers_(\d+)\b")


def target_to_hf_key(path: str) -> str:
    """Mechanical our-path -> HF-key transform."""
    key = _LAYERS_RE.sub(r"layers.\1", path).replace("/", ".")
    if key.endswith((".kernel", ".scale", ".embedding")):
        key = key.rsplit(".", 1)[0] + ".weight"
    return key


def auto_name_mappings(flat_shapes: Dict[str, Tuple[int, ...]]):
    """The mapping table for a flat ``{path: shape}`` dict of the scanned
    layout: paths under ``/layers/`` are stacked over their leading ``[L]``
    axis, 2-D kernels (per layer) are transposed."""
    mappings = []
    for path, shape in flat_shapes.items():
        stacked = "/layers/" in f"/{path}"
        action = "transpose" if path.endswith("/kernel") and len(shape) - stacked == 2 else None
        if stacked:
            hf_key = target_to_hf_key(path.replace("/layers/", "/layers_0/", 1)).replace("layers.0.", "layers.{}.", 1)
            mappings.append(StackedLayerMapping(hf_key, path, shape[0], action))
        else:
            mappings.append(StateDictNameMapping(target_to_hf_key(path), path, action))
    return mappings
