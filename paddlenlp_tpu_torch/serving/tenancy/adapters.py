"""AdapterRegistry: content-addressed LoRA store + fixed-size adapter pool.

Copy of ``paddlenlp_tpu/serving/tenancy/adapters.py``. The engine keeps ONE
base model resident and serves low-rank adapters around it; this module is the
host half of that design. Three layers:

- **host store** -- adapters keyed by ``adapter_id``, each a content-addressed
  set of per-projection A/B pairs (``{proj: {"A": [L, d_in, r], "B":
  [L, r, d_out]}}``, scaling pre-folded into B at add time) loaded from a
  safetensors file or an in-memory dict. The digest makes re-adds idempotent
  and retries token-exact: the same id always resolves to the same bytes.
- **pool** -- fixed-size numpy slot arrays ``[L, P, ...]`` (slot 0 = identity
  zeros, the block-0 sentinel of ``paged_cache``) that the backend copies to
  the device and the step gathers per batch row. Residency follows the
  ``BlockManager`` discipline: refcount per resident adapter, LRU of zero-ref
  residents, eviction ONLY under slot pressure -- a warm adapter stays warm
  until a cold one needs its slot, and an in-use adapter is never evicted.
- **versioning** -- every pool mutation bumps ``version`` and stamps the slot
  it wrote; the backend keeps a device copy and, when the version moved,
  copies only the slots written since its copy (:meth:`copy_pool`).

**Concurrency model.** Unlike ``BlockManager`` (engine-loop confined), the
registry is mutated from two sides: ``acquire``/``release`` on the engine
loop thread and ``add``/``remove`` from admin HTTP threads -- so every state
transition holds ``_lock``, and so does the backend's copy of the pool. The
``engine.adapter_load`` fault point fires inside :meth:`acquire` after the
slot decision but before the pool write; the slot is rolled back on the way
out, so an injected load failure can never leak a slot.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ...utils.faults import FaultPoint
from ...utils.log import logger

__all__ = ["AdapterRegistry", "AdapterPressure", "UnknownAdapterError",
           "adapter_dims_from_config", "PROJ_NAMES"]

#: the projections a LoRA adapter may target, in canonical order -- the same
#: seven matmuls the serving forward applies per layer
PROJ_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj",
              "gate_proj", "up_proj", "down_proj")

_F_ADAPTER_LOAD = FaultPoint("engine.adapter_load")


class AdapterPressure(RuntimeError):
    """Every pool slot is held by an in-use adapter: the acquire must wait.

    The engine treats this exactly like KV-block pressure -- the request stays
    queued and re-tries admission next step; it is NOT an error surfaced to
    the client."""


class UnknownAdapterError(ValueError):
    """``adapter_id`` names no adapter in the host store."""


def adapter_dims_from_config(config) -> Dict[str, Tuple[int, int]]:
    """Per-projection (d_in, d_out) from a model config -- the shapes the pool
    arrays must carry for each targetable matmul."""
    h = int(config.hidden_size)
    n_heads = int(config.num_attention_heads)
    n_kv = int(getattr(config, "num_key_value_heads", n_heads) or n_heads)
    head_dim = int(getattr(config, "head_dim", h // n_heads))
    inter = int(getattr(config, "intermediate_size", 4 * h))
    q = n_heads * head_dim
    kv = n_kv * head_dim
    return {
        "q_proj": (h, q),
        "k_proj": (h, kv),
        "v_proj": (h, kv),
        "o_proj": (q, h),
        "gate_proj": (h, inter),
        "up_proj": (h, inter),
        "down_proj": (inter, h),
    }


class _Entry:
    """One stored adapter: canonical weights + content digest."""

    __slots__ = ("adapter_id", "weights", "rank", "digest")

    def __init__(self, adapter_id: str, weights: Dict[str, Dict[str, np.ndarray]],
                 rank: int, digest: str):
        self.adapter_id = adapter_id
        self.weights = weights
        self.rank = rank
        self.digest = digest


def _digest(weights: Dict[str, Dict[str, np.ndarray]]) -> str:
    h = hashlib.sha256()
    for proj in sorted(weights):
        for part in ("A", "B"):
            arr = np.ascontiguousarray(weights[proj][part])
            h.update(f"{proj}.{part}:{arr.dtype}:{arr.shape}".encode())
            h.update(arr.tobytes())
    return h.hexdigest()


class AdapterRegistry:
    """Content-addressed LoRA adapter store + refcounted device-slot pool.

    ``pool_slots`` counts *adapter* slots; the pool arrays carry one extra
    leading slot (index 0) holding zeros -- the identity adapter every
    ``adapter_id=None`` row gathers, so one jitted program serves mixed
    adapter/no-adapter batches with no branching.
    """

    def __init__(self, config=None, *, num_layers: Optional[int] = None,
                 proj_dims: Optional[Dict[str, Tuple[int, int]]] = None,
                 max_rank: int = 8, pool_slots: int = 4,
                 dtype=np.float32):
        if config is not None:
            num_layers = int(config.num_hidden_layers)
            proj_dims = adapter_dims_from_config(config)
        if num_layers is None or proj_dims is None:
            raise ValueError("AdapterRegistry needs config= or "
                             "(num_layers= and proj_dims=)")
        if pool_slots < 1:
            raise ValueError("pool_slots must be >= 1")
        if max_rank < 1:
            raise ValueError("max_rank must be >= 1")
        unknown = set(proj_dims) - set(PROJ_NAMES)
        if unknown:
            raise ValueError(f"unknown projections {sorted(unknown)}; "
                             f"targetable: {PROJ_NAMES}")
        self.num_layers = num_layers
        self.proj_dims = dict(proj_dims)
        self.max_rank = max_rank
        self.pool_slots = pool_slots
        self.dtype = np.dtype(dtype)
        self._lock = threading.RLock()
        self._store: Dict[str, _Entry] = {}  # guarded-by: _lock
        self._slots: Dict[str, int] = {}  # guarded-by: _lock
        self._refs: Dict[str, int] = {}  # guarded-by: _lock
        self._lru: "OrderedDict[str, None]" = OrderedDict()  # guarded-by: _lock
        self._free: List[int] = list(range(1, pool_slots + 1))  # guarded-by: _lock
        # host pool arrays, mutated in place under the lock; the backend holds
        # a reference and re-places on device only when `version` moved
        P = pool_slots + 1  # + identity slot 0
        self._pool = {  # guarded-by: _lock
            proj: {
                "A": np.zeros((num_layers, P, d_in, max_rank), self.dtype),
                "B": np.zeros((num_layers, P, max_rank, d_out), self.dtype),
            }
            for proj, (d_in, d_out) in self.proj_dims.items()
        }
        self.version = 1  # pool content generation; bumped on load/evict
        # the version each slot was last written at (zeroed or loaded): a
        # device copy made at version v is stale exactly in the slots whose
        # stamp is >= v
        self._slot_written = [0] * P  # guarded-by: _lock
        # monotone counters -- torn reads skew one scrape by one event, the
        # BlockManager cache_hits contract
        self.hits = 0
        self.misses = 0
        self.loads = 0
        self.evictions = 0

    # ----------------------------------------------------------------- store
    def add(self, adapter_id: str, source, *, scaling: Optional[float] = None) -> str:
        """Register an adapter in the host store; returns its content digest.

        ``source`` is a safetensors path (flat ``{proj}.lora_A`` keys, the
        :meth:`LoRAModel.export_adapter` format) or a dict -- nested
        ``{proj: {"A": ..., "B": ...}}`` or the same flat keys. ``scaling``
        (alpha/r) is folded into B here, once, so the pool gather stays a
        plain two-matmul delta; a safetensors source may carry it in
        metadata. Idempotent on identical content; replacing a *different*
        adapter under a live id is refused while any request holds it."""
        if not adapter_id or not isinstance(adapter_id, str):
            raise ValueError("adapter_id must be a non-empty string")
        weights, meta_scaling = self._coerce_source(source)
        if scaling is None:
            scaling = meta_scaling if meta_scaling is not None else 1.0
        weights = self._canonicalize(adapter_id, weights, float(scaling))
        digest = _digest(weights)
        rank = max(w["A"].shape[-1] for w in weights.values())
        with self._lock:
            cur = self._store.get(adapter_id)
            if cur is not None:
                if cur.digest == digest:
                    return digest  # same bytes: no-op re-add
                if self._refs.get(adapter_id, 0) > 0:
                    raise ValueError(
                        f"adapter {adapter_id!r} is in use by "
                        f"{self._refs[adapter_id]} request(s); cannot replace")
                self._evict_locked(adapter_id)  # holds-lock via RLock re-entry
            self._store[adapter_id] = _Entry(adapter_id, weights, rank, digest)
            logger.info(f"adapter {adapter_id!r} registered "
                        f"(rank {rank}, digest {digest[:12]})")
            return digest

    def remove(self, adapter_id: str):
        """Drop an adapter from store and pool. Refused while in use."""
        with self._lock:
            if adapter_id not in self._store:
                raise UnknownAdapterError(f"unknown adapter {adapter_id!r}")
            if self._refs.get(adapter_id, 0) > 0:
                raise ValueError(f"adapter {adapter_id!r} is in use by "
                                 f"{self._refs[adapter_id]} request(s); cannot remove")
            self._evict_locked(adapter_id)
            del self._store[adapter_id]

    def __contains__(self, adapter_id: str) -> bool:
        with self._lock:
            return adapter_id in self._store

    def ids(self) -> List[str]:
        with self._lock:
            return sorted(self._store)

    def digest_of(self, adapter_id: str) -> str:
        with self._lock:
            ent = self._store.get(adapter_id)
            if ent is None:
                raise UnknownAdapterError(f"unknown adapter {adapter_id!r}")
            return ent.digest

    def weights_of(self, adapter_id: str) -> Dict[str, Dict[str, np.ndarray]]:
        """The canonical (B pre-scaled) weights -- the round-trip target of
        ``LoRAModel.export_adapter``."""
        with self._lock:
            ent = self._store.get(adapter_id)
            if ent is None:
                raise UnknownAdapterError(f"unknown adapter {adapter_id!r}")
            return {p: {k: v.copy() for k, v in w.items()}
                    for p, w in ent.weights.items()}

    # ----------------------------------------------------------------- pool
    def acquire(self, adapter_id: str) -> int:
        """Take one reference on ``adapter_id``; returns its pool slot,
        loading it into a (possibly LRU-evicted) slot when not resident.

        Raises :exc:`UnknownAdapterError` for an unregistered id,
        :exc:`AdapterPressure` when every slot is pinned by in-use adapters
        (the caller gates admission, exactly like KV-block pressure), and
        whatever the ``engine.adapter_load`` fault point injects -- with the
        slot rolled back, so chaos never leaks pool capacity."""
        with self._lock:
            ent = self._store.get(adapter_id)
            if ent is None:
                raise UnknownAdapterError(f"unknown adapter {adapter_id!r}")
            slot = self._slots.get(adapter_id)
            if slot is not None:
                self._refs[adapter_id] = self._refs.get(adapter_id, 0) + 1
                self._lru.pop(adapter_id, None)
                self.hits += 1
                return slot
            self.misses += 1
            if self._free:
                slot = self._free.pop()
            elif self._lru:
                victim, _ = self._lru.popitem(last=False)
                slot = self._slots.pop(victim)
                self._zero_slot(slot)
                self.evictions += 1
                self.version += 1
                logger.info(f"adapter {victim!r} evicted from slot {slot} "
                            f"(pressure from {adapter_id!r})")
            else:
                raise AdapterPressure(
                    f"adapter pool exhausted: all {self.pool_slots} slots "
                    f"pinned by in-use adapters")
            try:
                _F_ADAPTER_LOAD.fire(adapter_id=adapter_id)
                self._write_slot(slot, ent)
            except BaseException:
                # the slot was taken but never published: return it -- an
                # injected/real load failure must not leak pool capacity
                self._free.append(slot)
                raise
            self._slots[adapter_id] = slot
            self._refs[adapter_id] = 1
            self.loads += 1
            self.version += 1
            return slot

    def release(self, adapter_id: str):
        """Drop one reference; a zero-ref adapter stays resident on the LRU
        (warm) until slot pressure evicts it."""
        with self._lock:
            r = self._refs.get(adapter_id, 0) - 1
            if r > 0:
                self._refs[adapter_id] = r
                return
            self._refs.pop(adapter_id, None)
            if adapter_id in self._slots:
                self._lru[adapter_id] = None
                self._lru.move_to_end(adapter_id)

    def reset_refs(self):
        """Drop every reference (engine reset: no request survives, so no
        adapter is in use). Residency is kept -- the pool stays warm."""
        with self._lock:
            for aid in list(self._refs):
                self._refs.pop(aid, None)
                if aid in self._slots:
                    self._lru[aid] = None

    def slot_of(self, adapter_id: str) -> Optional[int]:
        with self._lock:
            return self._slots.get(adapter_id)

    def refcount(self, adapter_id: str) -> int:
        with self._lock:
            return self._refs.get(adapter_id, 0)

    def resident(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def pool_arrays(self) -> Tuple[Dict[str, Dict[str, np.ndarray]], int]:
        """(host pool tree, version) -- read atomically so the backend never
        pairs fresh arrays with a stale version."""
        with self._lock:
            return self._pool, self.version

    def copy_pool(self, since: Optional[int],
                  copy: Callable[[Dict[str, Dict[str, np.ndarray]], List[int]], None]) -> int:
        """Hand the host pool and the slots written since version ``since``
        (every slot when None) to ``copy(pool, slots)``, under the lock: an
        admin thread's add or remove cannot rewrite a slot while it is being
        read. ``copy`` must be done reading the arrays when it returns (no
        asynchronous copy out of them). Returns the version the copy holds."""
        with self._lock:
            if since is None:
                slots = list(range(self.pool_slots + 1))
            else:
                slots = [s for s, v in enumerate(self._slot_written) if v >= since]
            if since != self.version:
                copy(self._pool, slots)
            return self.version

    def stats(self) -> Dict:
        with self._lock:
            return {
                "registered": len(self._store),
                "resident": len(self._slots),
                "pool_slots": self.pool_slots,
                "free_slots": len(self._free),
                "pinned": sum(1 for v in self._refs.values() if v > 0),
                "hits": self.hits,
                "misses": self.misses,
                "loads": self.loads,
                "evictions": self.evictions,
                "version": self.version,
            }

    # ------------------------------------------------------------- internals
    # holds-lock: _lock
    def _evict_locked(self, adapter_id: str):
        slot = self._slots.pop(adapter_id, None)
        self._lru.pop(adapter_id, None)
        self._refs.pop(adapter_id, None)
        if slot is not None:
            self._zero_slot(slot)
            self._free.append(slot)
            self.evictions += 1
            self.version += 1

    # holds-lock: _lock
    def _zero_slot(self, slot: int):
        self._slot_written[slot] = self.version
        for w in self._pool.values():
            w["A"][:, slot] = 0
            w["B"][:, slot] = 0

    # holds-lock: _lock
    def _write_slot(self, slot: int, ent: _Entry):
        self._zero_slot(slot)
        for proj, w in ent.weights.items():
            r = w["A"].shape[-1]
            # zero-padding to max_rank is exact: the padded rank columns of A
            # meet the padded rank rows of B at zero, contributing nothing
            self._pool[proj]["A"][:, slot, :, :r] = w["A"]
            self._pool[proj]["B"][:, slot, :r, :] = w["B"]

    def _coerce_source(self, source):
        """source -> (proj -> {"A","B"} float arrays, scaling from metadata)."""
        meta_scaling = None
        if isinstance(source, str):
            from ...utils.safetensors_io import SafeFile

            with SafeFile(source) as sf:
                meta = sf.metadata or {}
                if "scaling" in meta:
                    meta_scaling = float(meta["scaling"])
                elif "lora_alpha" in meta and "r" in meta:
                    meta_scaling = float(meta["lora_alpha"]) / float(meta["r"])
                source = {k: sf.get_tensor(k) for k in sf.keys()}
        if not isinstance(source, dict):
            raise TypeError(f"adapter source must be a safetensors path or a "
                            f"dict, got {type(source).__name__}")
        if any(isinstance(v, dict) for v in source.values()):
            nested = source
        else:  # flat "{proj}.lora_A" keys
            nested = {}
            for key, arr in source.items():
                if "." not in key:
                    raise ValueError(f"flat adapter key {key!r} is not "
                                     "'{proj}.lora_A' / '{proj}.lora_B'")
                proj, part = key.rsplit(".", 1)
                part = {"lora_A": "A", "lora_B": "B", "A": "A", "B": "B"}.get(part)
                if part is None:
                    raise ValueError(f"adapter key {key!r} must end in "
                                     ".lora_A or .lora_B")
                nested.setdefault(proj, {})[part] = arr
        return nested, meta_scaling

    def _canonicalize(self, adapter_id: str, nested, scaling: float):
        """Validate shapes against the model dims; fold scaling into B."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for proj, w in nested.items():
            if proj not in self.proj_dims:
                raise ValueError(f"adapter {adapter_id!r} targets unknown "
                                 f"projection {proj!r}; model has "
                                 f"{sorted(self.proj_dims)}")
            if "A" not in w or "B" not in w:
                raise ValueError(f"adapter {adapter_id!r} projection {proj!r} "
                                 "needs both A and B")
            a = np.asarray(w["A"], dtype=self.dtype)
            b = np.asarray(w["B"], dtype=self.dtype)
            d_in, d_out = self.proj_dims[proj]
            L = self.num_layers
            if a.ndim != 3 or a.shape[0] != L or a.shape[1] != d_in:
                raise ValueError(
                    f"adapter {adapter_id!r} {proj}.A has shape {a.shape}; "
                    f"want [{L}, {d_in}, r<={self.max_rank}]")
            r = a.shape[2]
            if r > self.max_rank:
                raise ValueError(f"adapter {adapter_id!r} rank {r} exceeds "
                                 f"pool max_rank {self.max_rank}")
            if b.shape != (L, r, d_out):
                raise ValueError(
                    f"adapter {adapter_id!r} {proj}.B has shape {b.shape}; "
                    f"want [{L}, {r}, {d_out}] to match A rank {r}")
            out[proj] = {"A": a, "B": b * self.dtype.type(scaling)}
        if not out:
            raise ValueError(f"adapter {adapter_id!r} has no weights")
        return out
