"""``jax.random``'s threefry draws, rebuilt in integer torch ops.

The port samples the tokens the JAX package samples for the same seed, so it
computes JAX's random bits exactly: threefry-2x32 (20 rounds) under jax's
default partitionable layout (``jax_threefry_partitionable``, on by default
since jax 0.5), where the draw of element i of a shape is the hash of the
64-bit count i split as (hi, lo), and a 32-bit draw is the xor of the two
output words. Values are uint32 held in int64 tensors; a key is the pair
``(k1, k2)`` of such tensors, of any batch shape.

- :func:`key` is ``jax.random.key(seed)``, :func:`fold_in` and :func:`split`
  are ``jax.random.fold_in`` and ``split``;
- :func:`random_bits`, :func:`uniform`, :func:`gumbel` ("low" mode) and
  :func:`categorical` draw as ``jax.random`` does for float32.

``experimental/inference_model.sample_tokens`` and ``generation/`` both draw
from here.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

__all__ = ["Key", "categorical", "fold_in", "gumbel", "key", "random_bits", "split", "threefry2x32", "uniform"]

U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny

#: a threefry key: the two uint32 words, as int64 tensors of one batch shape
Key = Tuple[torch.Tensor, torch.Tensor]


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values; the
    counterpart of ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & U32
    x2 = (x2 + ks[1]) & U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & U32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & U32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & U32
    return x1, x2


def key(seed: int, device=None) -> Key:
    """``jax.random.key(seed)`` for a 32-bit seed: the words (0, seed)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} does not fit in 32 bits")
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.full((), seed & U32, dtype=torch.int64, device=device))


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in``: the hash of the count (0, data) under ``k``;
    ``data`` broadcasts against the key's batch shape."""
    data = torch.as_tensor(data, device=k[0].device).long() & U32
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` (its fold-like partitionable form): key i
    is the hash of the count i."""
    counts = torch.arange(num, device=k[0].device, dtype=torch.int64)
    b1, b2 = threefry2x32(k[0][..., None], k[1][..., None], torch.zeros_like(counts), counts)
    return [(b1[..., i], b2[..., i]) for i in range(num)]


def random_bits(k: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (32 bits): uint32 values in an int64
    tensor of shape ``k's batch shape + shape``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    counts = torch.arange(n, device=k[0].device, dtype=torch.int64)
    b1, b2 = threefry2x32(k[0][..., None], k[1][..., None], counts >> 32, counts & U32)
    return (b1 ^ b2).reshape(tuple(k[0].shape) + shape)


def uniform(k: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    exponent 0 give [1, 2); minus 1, scaled to [minval, maxval)."""
    bits = random_bits(k, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: Key, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in float32 ("low" mode)."""
    return -torch.log(-torch.log(uniform(k, shape, minval=TINY, maxval=1.0)))


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)``: the argmax of
    ``logits + gumbel(k, logits.shape)`` (the first index on ties)."""
    return (gumbel(k, logits.shape) + logits.float()).argmax(dim=-1)
