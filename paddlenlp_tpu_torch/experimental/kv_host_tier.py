"""Host-RAM KV spill tier: the second level of the hierarchical prefix cache.

PyTorch port of ``paddlenlp_tpu/experimental/kv_host_tier.py``. When
allocation pressure pops a zero-ref cached block off the
:class:`~.paged_cache.BlockManager` LRU, the engine copies its KV bytes out of
the device pool (one batched copy per step) and registers them here under the
SAME chained content hashes the device index used. A later prefix match that
runs past the device index and lands on host-tier entries promotes them back
ahead of prefill.

Where the JAX package kept each spill batch as its own gathered array, the
port keeps every resident block in one host arena allocated once, **pinned**
on CUDA: ``planes`` [max_blocks, L, 2, K, bs, H] (and the scale plane of a
quantized pool), one slot a block. Spills copy into free slots and promotes
copy out of them with asynchronous copies on one side CUDA stream
(``backend.py``), so no spill or promote allocates or pins host memory, and
no host thread ever reads the arena: a slot freed by :meth:`take` and
reused by a later spill is written only after the promote's copy read it,
in that stream's order.

Invariants the tests pin (as in the JAX package): a chain hash is resident
in the device index XOR the host tier; promoted bytes are bitwise equal to the
bytes spilled; ``clear_prefix_cache`` empties the tier with the device index.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

__all__ = ["HostKVTier", "HostPromoteTicket", "gather_blocks", "scatter_blocks", "pool_block_bytes", "slot_runs"]


def gather_blocks(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Whole blocks (all layers, K and V planes) out of a pool plane
    [L, 2, nb, ...], block-major: [n, L, 2, ...], contiguous."""
    return src[:, :, ids].movedim(2, 0).contiguous()


def scatter_blocks(dst: torch.Tensor, data: torch.Tensor, ids: torch.Tensor) -> None:
    """Land block-major ``data`` [n, L, 2, ...] in a pool plane, in place."""
    dst[:, :, ids] = data.movedim(0, 2)


def slot_runs(slots: Sequence[int]) -> List[Tuple[int, int, int]]:
    """``(i, slot, n)`` for each run of consecutive slots: rows ``[i, i + n)``
    map to slots ``[slot, slot + n)``, one copy each."""
    runs: List[Tuple[int, int, int]] = []
    for i, s in enumerate(slots):
        if runs and runs[-1][1] + runs[-1][2] == s:
            runs[-1] = (runs[-1][0], runs[-1][1], runs[-1][2] + 1)
        else:
            runs.append((i, s, 1))
    return runs


def pool_block_bytes(pool) -> int:
    """Bytes one block carries across the host boundary: [L, 2, K, bs, H]
    (+ the scale plane for quantized pools)."""
    kv = pool.kv
    n = kv.element_size() * kv.shape[0] * 2 * kv.shape[3] * kv.shape[4] * kv.shape[5]
    if pool.scale is not None:
        s = pool.scale
        n += s.element_size() * s.shape[0] * 2 * s.shape[3] * s.shape[4] * s.shape[5]
    return int(n)


@dataclasses.dataclass
class HostPromoteTicket:
    """One in-flight host->device block promotion (engine-held)."""

    seq_id: int
    n_blocks: int
    markers: tuple  # CUDA events completing when the copy has landed (empty on the CPU)
    polls: int = 0  # force-land fallback counter (engine-side scheduling)


@dataclasses.dataclass
class _SpillBatch:
    """One batched spill: the arena slot of each of its rows."""

    slots: List[int]
    live: int  # resident tier entries still pointing into this batch


class HostKVTier:
    """Host-side LRU of spilled prefix-cache blocks, keyed by chain hash,
    over the arena ``planes``.

    Owned by the engine loop thread like the :class:`BlockManager` it sits
    under; the metrics plane only reads the scalar ``stats`` counters.
    ``max_blocks == 0`` disables the tier (``accepting`` False)."""

    def __init__(self, max_blocks: int, block_bytes: int = 0, planes: Optional[List[torch.Tensor]] = None):
        self.max_blocks = int(max_blocks)
        self.block_bytes = int(block_bytes)
        #: the arena: [max_blocks, ...] host tensors, kv then the scale plane
        self.planes = planes
        self._free = list(range(self.max_blocks))  # a heap: the lowest free slots first, so runs stay long
        # hash -> (batch, row index along the batch)
        self._entries: "OrderedDict[bytes, Tuple[_SpillBatch, int]]" = OrderedDict()
        #: monotone counters (the metrics plane deltas these) + the live size
        self.stats: Dict[str, int] = {
            "spills": 0,          # spilled blocks, total
            "spill_batches": 0,   # batched D2H copies, total
            "promotes": 0,        # promote (take) calls, total
            "promoted_blocks": 0,
            "promote_bytes": 0,
            "evictions": 0,       # host-LRU evictions under tier pressure
        }

    # ------------------------------------------------------------- queries
    @property
    def accepting(self) -> bool:
        return self.max_blocks > 0

    @property
    def num_blocks(self) -> int:
        """Blocks currently resident in the tier."""
        return len(self._entries)

    def contains(self, h: bytes) -> bool:
        return h in self._entries

    def snapshot(self) -> Dict[str, int]:
        out = dict(self.stats)
        out["blocks"] = len(self._entries)
        out["capacity"] = self.max_blocks
        return out

    # ------------------------------------------------------------- mutation
    def _drop_entry(self, h: bytes):
        batch, row = self._entries.pop(h)
        batch.live -= 1
        heapq.heappush(self._free, batch.slots[row])

    def reserve(self, hashes: List[bytes]) -> List[int]:
        """Arena slots for a spill batch of ``hashes``, to copy into before
        :meth:`put` registers them. A hash already resident is dropped first
        (re-spill: the newest copy wins); then the least recently used
        entries are evicted until the batch fits. As in the JAX package, a
        batch larger than the whole tier keeps only its last ``max_blocks``
        rows: the slots returned are those of ``hashes[-len(slots):]``."""
        if not self.accepting:
            return []
        for h in hashes:
            if h in self._entries:
                self._drop_entry(h)
        n = min(len(hashes), self.max_blocks)
        self.stats["evictions"] += len(hashes) - n
        while len(self._free) < n:
            self._drop_entry(next(iter(self._entries)))
            self.stats["evictions"] += 1
        return [heapq.heappop(self._free) for _ in range(n)]

    def release(self, slots: List[int]):
        """Return reserved slots whose copy failed."""
        for s in slots:
            heapq.heappush(self._free, s)

    def put(self, hashes: List[bytes], slots: List[int]):
        """Register one spill batch: ``hashes[i]`` lives in arena slot
        ``slots[i]`` (from :meth:`reserve`; the copy into it is enqueued)."""
        if not self.accepting or not hashes:
            return
        batch = _SpillBatch(slots=list(slots), live=0)
        for row, h in enumerate(hashes):
            self._entries[h] = (batch, row)
            batch.live += 1
        self.stats["spills"] += len(hashes)
        self.stats["spill_batches"] += 1

    def take(self, hashes: List[bytes]):
        """Pop ``hashes`` (resident-XOR: a promoted hash leaves the tier; the
        engine re-registers it in the device index) and return ``(slots,
        nbytes)``: their arena slots, for the promote's copy, which must be
        enqueued before the slots are reserved again."""
        slots = []
        for h in hashes:
            batch, row = self._entries[h]
            slots.append(batch.slots[row])
            self._drop_entry(h)
        nbytes = len(hashes) * self.block_bytes
        self.stats["promotes"] += 1
        self.stats["promoted_blocks"] += len(hashes)
        self.stats["promote_bytes"] += nbytes
        return slots, nbytes

    def discard(self, h: bytes):
        """Drop one hash if resident: the device index just (re-)claimed it
        (cold re-prefill of a spilled span), and resident-XOR says the tier
        copy yields."""
        if h in self._entries:
            self._drop_entry(h)

    def clear(self):
        """Invalidate every resident block (weight swap / cache-epoch bump:
        pre-swap KV must never serve post-swap traffic)."""
        for h in list(self._entries):
            self._drop_entry(h)
