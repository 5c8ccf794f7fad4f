"""Paged (block) KV cache + host-side block manager.

PyTorch port of ``paddlenlp_tpu/experimental/paged_cache.py``:

- device side: ONE pool tensor ``[L, 2, num_blocks, n_kv, block_size, H]``
  (kv-head-major, the layout the JAX package and the attention kernel share);
  new K/V are scattered into table-addressed slots and attention either
  gathers whole block rows (the plain path) or walks the block tables in the
  kernel. Where JAX donated the pool to a jitted scatter, the port writes the
  pool tensor in place.
- host side: ``BlockManager`` is the JAX package's allocator copied as it is
  (free list, per-sequence tables, refcounted prefix cache with the same
  sha256 chain hashes, LRU eviction, copy-on-write pairs) with the hooks of
  the host-RAM spill tier (``kv_host_tier.py``): LRU evictions queue for a
  batched spill, prefix matches continue into the tier, promoted blocks
  re-register.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["PagedKVPool", "BlockManager", "init_paged_pool", "kv_slots", "quantize_kv", "write_kv_block", "gather_kv",
           "copy_blocks"]


@dataclasses.dataclass
class PagedKVPool:
    """Device-side pool: kv [L, 2, num_blocks, n_kv, block_size, head_dim].

    Quantized caches store ``kv`` as int8 / float8_e4m3fn plus per-token-per-
    head ``scale`` [L, 2, nb, n_kv, bs, 1] fp32; dequant happens at the
    attention read (in-kernel on the kernel path)."""

    kv: torch.Tensor
    scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.kv.shape[2]

    @property
    def block_size(self) -> int:
        return self.kv.shape[4]

    @property
    def quantized(self) -> bool:
        return self.scale is not None


_QMAX = {"int8": 127.0, "fp8": 448.0}  # float8_e4m3 max normal
_QDTYPE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def init_paged_pool(config, num_blocks: int, block_size: int = 16, dtype=torch.bfloat16,
                    quant: Optional[str] = None, device="cuda") -> PagedKVPool:
    n_kv = getattr(config, "num_key_value_heads", config.num_attention_heads)
    head_dim = getattr(config, "head_dim", config.hidden_size // config.num_attention_heads)
    shape = (config.num_hidden_layers, 2, num_blocks, n_kv, block_size, head_dim)
    if quant is None:
        return PagedKVPool(kv=torch.zeros(shape, dtype=dtype, device=device))
    if quant not in _QMAX:
        raise ValueError(f"kv cache quant must be int8/fp8, got {quant!r}")
    return PagedKVPool(
        kv=torch.zeros(shape, dtype=_QDTYPE[quant], device=device),
        scale=torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
    )


def quantize_kv(x: torch.Tensor, qdtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token-per-head symmetric quant over the head dim.

    x [..., H] -> (q [..., H] in qdtype, scale [..., 1] fp32)."""
    qmax = _QMAX["int8" if qdtype == torch.int8 else "fp8"]
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / qmax
    q = x32 / scale
    if qdtype == torch.int8:
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(qdtype), scale


def kv_slots(block_tables: torch.Tensor, start_pos: torch.Tensor, T: int,
             block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where :func:`write_kv_block` puts T new tokens a row: (blocks, offs),
    each [B*T]. Token t of row b lands at logical position p = start_pos[b]
    + t -> (block_tables[b, p // bs], p % bs). A table index past the end
    clamps to the last entry, as JAX's gather does; padded rows address the
    zero sentinel block 0, which no live read depends on. The same for every
    layer of one forward."""
    M = block_tables.shape[1]
    pos = start_pos.long()[:, None] + torch.arange(T, device=block_tables.device)[None, :]
    blocks = torch.gather(block_tables.long(), 1, (pos // block_size).clamp(max=M - 1)).reshape(-1)
    return blocks, (pos % block_size).reshape(-1)


def write_kv_block(pool_layer: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   block_tables: torch.Tensor, start_pos: torch.Tensor,
                   scale_layer: Optional[torch.Tensor] = None,
                   slots: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """Scatter new tokens' K/V into one layer of the pool, for the whole batch
    in one indexed write (the JAX package loops over sequences).

    pool_layer [2, num_blocks, K, bs, H] and scale_layer [2, num_blocks, K,
    bs, 1] are views into the pool, written in place; k/v [B, T, K, H];
    block_tables [B, max_blocks]; start_pos [B]; the tokens' places as
    :func:`kv_slots` gives them (``slots``, computed here when None)."""
    B, T, K, H = k.shape
    blocks, offs = kv_slots(block_tables, start_pos, T, pool_layer.shape[3]) if slots is None else slots
    k = k.reshape(B * T, K, H)
    v = v.reshape(B * T, K, H)
    if scale_layer is not None:
        k, ks = quantize_kv(k, pool_layer.dtype)
        v, vs = quantize_kv(v, pool_layer.dtype)
        scale_layer[0, blocks, :, offs] = ks
        scale_layer[1, blocks, :, offs] = vs
    # advanced indices (blocks, offs) split by the kv-head slice: the indexed
    # rows are [B*T, K, H], matching k/v
    pool_layer[0, blocks, :, offs] = k.to(pool_layer.dtype)
    pool_layer[1, blocks, :, offs] = v.to(pool_layer.dtype)


def gather_kv(pool_layer: torch.Tensor, block_tables: torch.Tensor,
              scale_layer: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather per-sequence K/V views (one layer): pool_layer [2, nb, K, bs, H];
    block_tables [B, max_blocks] -> (k, v) each [B, max_blocks*bs, K, H].
    Masking by context length happens in attention. Quantized pools
    dequantize to bf16 here, as the JAX package's gather path does."""
    tables = block_tables.long()
    k = pool_layer[0][tables]  # [B, M, K, bs, H]
    v = pool_layer[1][tables]
    B, M, K, bs, H = k.shape
    if scale_layer is not None:
        k = (k.float() * scale_layer[0][tables]).to(torch.bfloat16)
        v = (v.float() * scale_layer[1][tables]).to(torch.bfloat16)
    k = k.permute(0, 1, 3, 2, 4).reshape(B, M * bs, K, H)
    v = v.permute(0, 1, 3, 2, 4).reshape(B, M * bs, K, H)
    return k, v


def copy_blocks(pool: PagedKVPool, pairs: Sequence[Tuple[int, int]]) -> PagedKVPool:
    """Copy whole KV blocks src -> dst across every layer (K and V planes), in
    place: the copy-on-write primitive behind prefix caching. The sources are
    read before any destination is written, so overlapping pairs copy the old
    contents, as JAX's functional scatter does."""
    if not pairs:
        return pool
    src = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=pool.kv.device)
    dst = torch.tensor([d for _, d in pairs], dtype=torch.long, device=pool.kv.device)
    pool.kv[:, :, dst] = pool.kv[:, :, src]
    if pool.scale is not None:
        pool.scale[:, :, dst] = pool.scale[:, :, src]
    return pool


class BlockManager:
    """Host-side allocator (the step.cu bookkeeping in Python).

    Block 0 is reserved as the zero sentinel for unused table slots.

    **Prefix caching** (``enable_prefix_cache=True``): every owned block carries
    a refcount, and full blocks of finished prompts are registered in a
    chained-hash index (``h_i = sha256(h_{i-1} || block_i tokens)`` — block-
    granular, content-addressed). ``allocate(..., token_ids=...)`` walks the
    chain and reuses the longest cached prefix of FULL blocks; the caller skips
    prefill for those tokens. Zero-ref cached blocks sit on an LRU list and are
    evicted only under allocation pressure, so the cache can never cause an
    admission failure the uncached allocator wouldn't have had: ``num_free``
    counts them as available.

    **Concurrency model**: lock-free by thread confinement — the manager is
    owned by the engine, which the serving stack drives from ONE loop thread
    (engine_loop.py); ``generate()`` callers are single-threaded by contract.
    Metrics/stats readers on HTTP threads only touch scalar counters
    (``cache_hits``/``num_free``/...), where a stale read is harmless. Do not
    add cross-thread mutation here; route it through the engine loop's
    command queue instead.
    """

    def __init__(self, num_blocks: int, block_size: int, max_blocks_per_seq: int,
                 enable_prefix_cache: bool = False):
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        self.total_usable_blocks = num_blocks - 1
        self.free: List[int] = list(range(1, num_blocks))  # block 0 = sentinel
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.enable_prefix_cache = enable_prefix_cache
        self.ref: Dict[int, int] = {}  # block -> #sequences referencing it
        self._index: Dict[int, int] = {}  # chained prefix hash -> block
        self._block_hash: Dict[int, int] = {}  # registered block -> its hash
        self._lru: "OrderedDict[int, None]" = OrderedDict()  # zero-ref cached blocks
        self._cow_pairs: List[Tuple[int, int]] = []  # (src, dst) device copies owed
        self._cache_epoch = 0  # bumped by clear_prefix_cache()
        self._seq_epoch: Dict[int, int] = {}  # seq -> epoch it was allocated in
        self.cache_hits = 0  # allocations that reused >=1 cached block
        self.cached_tokens_total = 0  # prompt tokens whose prefill was skipped
        self.evictions = 0  # cached blocks recycled under pressure
        # hierarchical cache (kv_host_tier.py): with a tier attached, LRU
        # evictions queue (hash, block) pairs here instead of dropping the
        # content; the engine drains them into one batched spill BEFORE any
        # device launch can overwrite the recycled blocks
        self.host_tier = None
        self._pending_spills: List[Tuple[bytes, int]] = []

    @property
    def num_free(self) -> int:
        """Blocks available to an allocation: the free list plus zero-ref
        cached blocks (evictable on demand, so they ARE capacity)."""
        return len(self.free) + len(self._lru)

    @property
    def num_cached_blocks(self) -> int:
        """Blocks currently registered in the prefix index (shared or idle)."""
        return len(self._block_hash)

    def blocks_needed(self, n_tokens: int) -> int:
        return (n_tokens + self.block_size - 1) // self.block_size

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= self.num_free

    def can_admit(self, n_tokens: int, token_ids=None, match=None,
                  salt: Optional[str] = None) -> bool:
        """Like :meth:`can_allocate`, but cached prefix blocks don't need fresh
        capacity — the scheduler admits a warm request a cold one must wait for.

        Pass a precomputed ``match`` (from :meth:`match_prefix`) to skip
        re-hashing the prompt; matched blocks that are idle on the LRU are
        subtracted from available capacity — they can't be both "no fresh
        block needed" AND "evictable free capacity" at once."""
        if match is None and token_ids is not None:
            match = self.match_prefix(token_ids, min(len(token_ids), n_tokens),
                                      salt=salt)
        matched = match[0] if match is not None else []
        need = self.blocks_needed(n_tokens) - len(matched)
        return need <= self.num_free - self._idle_count(matched)

    # ------------------------------------------------------------- prefix cache
    def _idle_count(self, blocks) -> int:
        """How many of ``blocks`` currently sit on the (counted-as-free) LRU."""
        return sum(1 for b in blocks if b in self._lru)

    def _chain_hashes(self, token_ids, nb_full: int, salt: Optional[str] = None):
        """Chained sha256 content digests of the first ``nb_full`` full blocks.

        Cryptographic on purpose: the index serves another prompt's KV on a
        key collision with no further check, so a non-collision-resistant
        hash would be a silent-wrong-output (and cross-request leak) channel.

        ``salt`` seeds the chain (multi-LoRA: the adapter_id) so two tenants
        with identical prompts but different adapters never share KV — a LoRA
        delta changes every hidden state, so cross-adapter cache hits would be
        silently wrong. ``salt=None`` keeps the historical hash values: the
        no-adapter cache population is untouched."""
        h = hashlib.sha256(salt.encode()).digest() if salt else b""
        bs = self.block_size
        arr = np.ascontiguousarray(
            np.asarray(token_ids[: nb_full * bs], dtype=np.int64))
        out = []
        for i in range(nb_full):
            h = hashlib.sha256(h + arr[i * bs: (i + 1) * bs].tobytes()).digest()
            out.append(h)
        return out

    def match_prefix(self, token_ids, n_tokens: int, salt: Optional[str] = None):
        """Longest cached full-block prefix of ``token_ids``.

        Returns ``(shared_blocks, n_cached_tokens, cow_src)``: blocks to attach
        by reference, tokens covered, and — when the match would cover the whole
        prompt (leaving nothing to prefill) — the tail block to copy-on-write
        instead of sharing, so the re-prefilled last token never mutates a
        shared block. Pure lookup: acquires nothing. ``salt`` must match the
        salt the blocks were registered under (see :meth:`_chain_hashes`)."""
        if not self.enable_prefix_cache:
            return [], 0, None
        bs = self.block_size
        nb_full = min(len(token_ids), n_tokens) // bs
        matched: List[int] = []
        for h in self._chain_hashes(token_ids, nb_full, salt=salt):
            b = self._index.get(h)
            if b is None:
                break
            matched.append(b)
        if not matched:
            return [], 0, None
        if len(matched) * bs == n_tokens:
            # full cover: keep >=1 token to prefill (the sampler needs logits
            # at the last prompt position) — COW the tail block
            return matched[:-1], n_tokens - 1, matched[-1]
        return matched, len(matched) * bs, None

    def _acquire(self, block: int):
        """Take a reference on a cached block (removing it from the LRU if idle)."""
        self.ref[block] = self.ref.get(block, 0) + 1
        self._lru.pop(block, None)

    def _release_block(self, block: int):
        r = self.ref.get(block, 0) - 1
        if r > 0:
            self.ref[block] = r
            return
        self.ref.pop(block, None)
        if block in self._block_hash:
            # zero-ref but cached: evictable, not free — most-recently-used last
            self._lru[block] = None
            self._lru.move_to_end(block)
        else:
            self.free.append(block)

    def _pop_block(self) -> int:
        """A fresh private block: free list first, else evict the LRU cached
        block (allocation pressure is the ONLY thing that shrinks the cache).
        With a host tier attached the evicted block's hash demotes instead of
        dying: it is queued for the engine's batched spill and the tier keeps
        serving it to future prefix matches (:meth:`host_match`)."""
        if self.free:
            b = self.free.pop()
        else:
            b, _ = self._lru.popitem(last=False)
            h = self._block_hash.pop(b)
            self._index.pop(h, None)
            self.evictions += 1
            if self.host_tier is not None and self.host_tier.accepting:
                self._pending_spills.append((h, b))
        self.ref[b] = 1
        return b

    # ------------------------------------------------------------- host tier
    def attach_host_tier(self, tier):
        """Hang a :class:`~.kv_host_tier.HostKVTier` under the LRU: evictions
        demote to it, :meth:`host_match` extends prefix matches into it."""
        self.host_tier = tier

    def drain_pending_spills(self) -> List[Tuple[bytes, int]]:
        """(hash, block) pairs evicted since the last drain; cleared on read.
        The engine MUST consume these before any device launch that writes
        the recycled blocks: the spill gather is enqueued on the compute
        stream ahead of that launch and so reads the old bytes."""
        out, self._pending_spills = self._pending_spills, []
        return out

    def host_match(self, token_ids, n_tokens: int, salt: Optional[str] = None,
                   skip: int = 0) -> List[bytes]:
        """Chain hashes of the full-block prefix run that continues past the
        device match (``skip`` = blocks the device index already covered)
        and is resident in the host tier. Pure lookup: pops nothing."""
        if (not self.enable_prefix_cache or self.host_tier is None
                or not self.host_tier.accepting):
            return []
        bs = self.block_size
        nb_full = min(len(token_ids), n_tokens) // bs
        if nb_full <= skip:
            return []
        out: List[bytes] = []
        for h in self._chain_hashes(token_ids, nb_full, salt=salt)[skip:]:
            if not self.host_tier.contains(h):
                break
            out.append(h)
        return out

    def register_promoted(self, blocks: Sequence[int], hashes: Sequence[bytes]):
        """Re-register just-promoted blocks in the device index (the other
        half of the resident-XOR move that :meth:`HostKVTier.take` started).
        A hash or block already claimed is skipped."""
        for b, h in zip(blocks, hashes):
            if h not in self._index and b not in self._block_hash:
                self._index[h] = b
                self._block_hash[b] = h

    def drain_cow_pairs(self) -> List[Tuple[int, int]]:
        """(src, dst) block copies the caller owes the device pool (see
        :func:`copy_blocks`); cleared on read."""
        pairs, self._cow_pairs = self._cow_pairs, []
        return pairs

    # ------------------------------------------------------------- allocation
    def allocate(self, seq_id: int, n_tokens: int, token_ids=None, match=None,
                 salt: Optional[str] = None):
        """Allocate a sequence's blocks.

        Plain call (``token_ids=None``): the uncached path — returns the block
        list, exactly the historical contract.

        With ``token_ids`` and prefix caching enabled: matches the longest
        cached full-block prefix and returns ``(cached_blocks,
        n_cached_tokens, new_blocks)``; the sequence's table is
        ``cached_blocks [+ cow dst] + new_blocks`` and the caller only
        prefills tokens ``[n_cached_tokens:]``. Pass the ``match`` a prior
        :meth:`match_prefix`/:meth:`can_admit` computed (no mutation may
        happen in between) to avoid re-hashing the prompt."""
        need = self.blocks_needed(n_tokens)
        if need > self.max_blocks_per_seq:
            raise ValueError(f"sequence needs {need} blocks > max_blocks_per_seq {self.max_blocks_per_seq}")
        if match is None and token_ids is not None:
            match = self.match_prefix(token_ids, n_tokens, salt=salt)
        shared, n_cached, cow_src = match if match is not None else ([], 0, None)
        n_fresh = need - len(shared)
        # matched idle blocks are about to leave the LRU: they can't double as
        # evictable capacity for this same allocation's fresh blocks
        available = self.num_free - self._idle_count(shared)
        if n_fresh > available:
            raise RuntimeError(f"out of KV blocks: need {n_fresh}, free {available}")
        # acquire shared refs BEFORE popping fresh blocks: a matched idle block
        # must leave the LRU first or the eviction path could recycle it
        for b in shared:
            self._acquire(b)
        if cow_src is not None and cow_src in self._lru:
            self._lru.move_to_end(cow_src)  # just used: keep it warm
        new_blocks = [self._pop_block() for _ in range(n_fresh)]
        if cow_src is not None:
            # new_blocks[0] becomes the private copy of the shared tail block
            self._cow_pairs.append((cow_src, new_blocks[0]))
        self.tables[seq_id] = shared + new_blocks
        self.lengths[seq_id] = n_tokens
        self._seq_epoch[seq_id] = self._cache_epoch
        if n_cached > 0:
            self.cache_hits += 1
            self.cached_tokens_total += n_cached
        if token_ids is not None:
            return shared, n_cached, new_blocks
        return self.tables[seq_id]

    def extend(self, seq_id: int, n_new_tokens: int = 1) -> Optional[List[int]]:
        """Grow a sequence; returns newly-allocated blocks (None if OOM -> preempt)."""
        new_len = self.lengths[seq_id] + n_new_tokens
        need = self.blocks_needed(new_len) - len(self.tables[seq_id])
        if need > 0:
            if need > self.num_free:
                return None
            if self.blocks_needed(new_len) > self.max_blocks_per_seq:
                return None
            new_blocks = [self._pop_block() for _ in range(need)]
            self.tables[seq_id].extend(new_blocks)
        else:
            new_blocks = []
        self.lengths[seq_id] = new_len
        return new_blocks

    def shrink(self, seq_id: int, new_len: int):
        """Release blocks beyond ``new_len`` tokens (undo speculative multi-step
        extension after a sequence finished early). Refcount-aware: a shared
        block dropped from this table survives for its other holders."""
        if seq_id not in self.tables:
            return
        keep = max(self.blocks_needed(new_len), 1)
        blocks = self.tables[seq_id]
        if keep < len(blocks):
            for b in blocks[keep:]:
                self._release_block(b)
            del blocks[keep:]
        self.lengths[seq_id] = new_len

    def free_seq(self, seq_id: int):
        """Release a sequence WITHOUT registering its blocks (abort/preempt)."""
        blocks = self.tables.pop(seq_id, [])
        self.lengths.pop(seq_id, None)
        self._seq_epoch.pop(seq_id, None)
        for b in blocks:
            self._release_block(b)

    def finish_seq_cached(self, seq_id: int, token_ids, salt: Optional[str] = None):
        """Release a finished sequence, registering its full prompt blocks in
        the prefix index so later requests skip their prefill.

        Chain registration is content-addressed: a block whose hash is already
        claimed by another block is simply not registered (deeper blocks still
        are — a future match mixes providers freely, content is identical).

        A sequence allocated before the last :meth:`clear_prefix_cache` holds
        KV computed under superseded params — it releases without registering
        (the epoch check), otherwise it would re-poison the cleared index."""
        blocks = self.tables.pop(seq_id, None)
        self.lengths.pop(seq_id, None)
        epoch = self._seq_epoch.pop(seq_id, None)
        if blocks is None:
            return
        if self.enable_prefix_cache and token_ids is not None and epoch == self._cache_epoch:
            bs = self.block_size
            nb_full = min(len(token_ids) // bs, len(blocks))
            for i, h in enumerate(self._chain_hashes(token_ids, nb_full, salt=salt)):
                b = blocks[i]
                if h not in self._index and b not in self._block_hash:
                    self._index[h] = b
                    self._block_hash[b] = h
                    # resident-XOR: a cold re-prefill of a spilled span just
                    # re-registered device-side; the (identical) host copy
                    # yields, and a still-queued spill of it dies before the
                    # drain would double-register it
                    if self.host_tier is not None:
                        self.host_tier.discard(h)
                        if self._pending_spills:
                            self._pending_spills = [p for p in self._pending_spills if p[0] != h]
        for b in blocks:
            self._release_block(b)

    def clear_prefix_cache(self):
        """Drop every idle cached block back to the free list (index reset)."""
        for b in list(self._lru):
            self._index.pop(self._block_hash.pop(b), None)
            self.free.append(b)
        self._lru.clear()
        # blocks still referenced by running sequences stay out of the index
        # from now on: unregister them so they free normally on release
        for b in list(self._block_hash):
            self._index.pop(self._block_hash.pop(b), None)
        # in-flight sequences hold KV from before the clear: the epoch bump
        # stops finish_seq_cached from re-registering it into the fresh index
        self._cache_epoch += 1
        # the host tier is the same cache one level down: queued spills die
        # and resident entries invalidate (no KV across weight generations)
        self._pending_spills.clear()
        if self.host_tier is not None:
            self.host_tier.clear()

    def table_array(self, seq_id: int) -> np.ndarray:
        """Padded table row (sentinel block 0 for unused slots)."""
        out = np.zeros(self.max_blocks_per_seq, dtype=np.int32)
        blocks = self.tables.get(seq_id, [])
        out[: len(blocks)] = blocks
        return out

    def longest_seq(self) -> Optional[int]:
        """Preemption candidate (reference step.cu preempts the longest)."""
        if not self.lengths:
            return None
        return max(self.lengths, key=lambda s: self.lengths[s])
