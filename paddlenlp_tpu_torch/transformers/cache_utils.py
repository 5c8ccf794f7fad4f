"""Static KV cache for autoregressive decoding.

PyTorch port of ``paddlenlp_tpu/transformers/cache_utils.py``: one stacked
tensor per side, ``[L, B, S_max, n_kv, head_dim]``, and the write offset.
Where the JAX package threads a new cache through ``dynamic_update_slice``,
the port writes each layer's new keys and values into the same tensors in
place; the layout is kept, so a beam reorder stays one gather on axis 1.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["KVCache", "init_cache", "update_layer_kv"]


@dataclasses.dataclass
class KVCache:
    """Stacked-by-layer cache: keys/values [L, B, S_max, n_kv, H] and the
    number of positions already written (a host int)."""

    keys: torch.Tensor
    values: torch.Tensor
    offset: int = 0

    def layer(self, idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.keys[idx], self.values[idx]

    def reorder(self, rows: torch.Tensor) -> "KVCache":
        """The cache of batch rows ``rows`` (beam search's gather on axis 1)."""
        return KVCache(keys=self.keys[:, rows], values=self.values[:, rows], offset=self.offset)

    @property
    def nbytes(self) -> int:
        return self.keys.numel() * self.keys.element_size() + self.values.numel() * self.values.element_size()


def init_cache(config, batch_size: int, max_length: int, dtype=torch.bfloat16, device="cuda") -> KVCache:
    n_layers = config.num_hidden_layers
    n_kv = getattr(config, "num_key_value_heads", config.num_attention_heads)
    head_dim = getattr(config, "head_dim", config.hidden_size // config.num_attention_heads)
    shape = (n_layers, batch_size, max_length, n_kv, head_dim)
    return KVCache(keys=torch.zeros(shape, dtype=dtype, device=device),
                   values=torch.zeros(shape, dtype=dtype, device=device), offset=0)


def update_layer_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                    offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k/v [B, T, n_kv, H] into one layer's cache [B, S_max, n_kv, H]
    at ``offset``, in place, and return the full-cache views."""
    T, S = k_new.shape[1], k_cache.shape[1]
    if offset < 0 or offset + T > S:
        raise ValueError(f"update_layer_kv: {T} positions at offset {offset} overflow a cache of {S}")
    k_cache[:, offset:offset + T] = k_new.to(k_cache.dtype)
    v_cache[:, offset:offset + T] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
