"""Model backend: the seam between the scheduler and the device.

PyTorch port of ``paddlenlp_tpu/experimental/backend.py``. ``InferenceEngine``
(engine.py) owns scheduling: the waiting queue, slot binding, the
``BlockManager``, preemption, chunk budgets and prefix-cache bookkeeping.
Everything that touches the device (model params, the paged KV pool, the
per-slot penalty-count tensor and the step programs) lives behind a
:class:`ModelBackend`. The engine talks to it in host numpy and plain Python.

Contract:

- ``prefill(...)``       batched monolithic prompt prefill, samples token 0;
- ``decode(...)``        multi-token decode for every running slot;
- ``mixed_step(...)``    one ragged step of prefill chunks + decode tokens;
- ``verify(...)``        the speculative-decoding verify forward;
- ``seed_counts``/``reset_counts``  per-slot penalty-count maintenance;
- ``apply_cow(pairs)``   prefix-cache copy-on-write block copies in the pool;
- ``kv_spill``/``kv_promote``/``migration_ready``  the host KV tier's copies;
- ``sync_params(tree)``  install a new parameter tree (live weight swap);
- ``describe()``         placement metadata for ``stats()``.

Every step entry point also sets ``self.step_accounting`` to ``{"fed": <token
positions the launch processed>, "shape": <launch-geometry key>}`` before it
runs; the engine reads it right after the call to feed the goodput ledger.

The serving loop steps the engine under ``torch.inference_mode()`` on its own
thread. The backend's long-lived tensors (the pool, the penalty counts, the
parameters) stay ordinary tensors all the same: they are updated in place or
placed outside inference mode, so the engine stays usable from any thread.

**Ordering of the host-tier copies.** The JAX package threads a functional
pool, so dispatch order alone puts a spill's gather before any overwrite of
the recycled blocks and a promote's scatter before the prefill that reads
it. The port writes its pool in place, so it orders them on CUDA streams:

- a spill's gather is enqueued on the compute stream when ``kv_spill`` is
  called, which the engine does before the launch that rewrites the blocks;
  the D2H copy into pinned memory runs on a side stream that waits on an
  event recorded after the gather;
- a promote's H2D copy runs on the side stream and records an event, the
  ticket's marker (``migration_ready`` queries it, a scheduling signal only).
  The scatter into the pool runs on the compute stream, after the compute
  stream waits on that event, at the first launch whose block tables hold a
  promoted block (or once the copy has landed), in the order the promotes
  were made. Every pool write therefore stays on the compute stream, in
  program order, as in the JAX package.

On the CPU the copies are synchronous and the markers empty.

**Multi-LoRA.** With an ``adapter_registry``, every step takes per-row adapter
slots (``adapter_table=`` on ``prefill``/``decode``/``verify``,
``MixedRow.adapter`` in a mixed step) and the device copy of the registry's
adapter pool. The copy follows the registry's ``version``: when it moved, only
the slots written since the last copy are copied, synchronously and under the
registry's lock (``AdapterRegistry.copy_pool``), so the device pool equals the
host pool whenever a step reads it.

The sharded and disaggregated backends of the JAX package are not part of
the port yet (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..transformers.conversion_utils import flatten_params, unflatten_params
from .inference_model import PagedInferenceModel
from .kv_host_tier import HostPromoteTicket, gather_blocks, scatter_blocks, slot_runs
from .paged_cache import copy_blocks, init_paged_pool

__all__ = ["ModelBackend", "SingleDeviceBackend", "MixedRow", "samp_arrays"]


def samp_arrays(sampling: Sequence, n: Optional[int] = None, device="cuda"):
    """Per-row sampling-parameter tensors for the device sampler.

    ``sampling`` holds SamplingParams-shaped objects (duck-typed) or None for
    padding rows; ``n`` pads/truncates to a fixed row count."""
    rows = list(sampling)
    if n is not None:
        rows = (rows + [None] * n)[:n]
    get = lambda f, d: np.asarray([getattr(s, f) if s is not None else d for s in rows])  # noqa: E731
    t = lambda a, dt: torch.as_tensor(a, dtype=dt).to(device)  # noqa: E731
    return dict(
        seeds=t(get("seed", 0), torch.int32),
        temperature=t(get("temperature", 1.0), torch.float32),
        top_k=t(get("top_k", 0), torch.int32),
        top_p=t(get("top_p", 1.0), torch.float32),
        do_sample=t(get("do_sample", False), torch.bool),
        repetition_penalty=t(get("repetition_penalty", 1.0), torch.float32),
        presence_penalty=t(get("presence_penalty", 0.0), torch.float32),
        frequency_penalty=t(get("frequency_penalty", 0.0), torch.float32),
    )


@dataclasses.dataclass
class MixedRow:
    """One row of a ragged mixed step, as the scheduler sees it.

    A prefill-chunk row feeds ``tokens`` (the next chunk of the prompt)
    starting at absolute position ``start``; a decode row feeds exactly one
    token (the slot's last sampled id). ``emit=True`` means the sampler's
    token at position ``start + len(tokens)`` is kept (final chunks and
    decode rows); non-final chunks discard it."""

    slot: int
    tokens: np.ndarray
    start: int
    table: np.ndarray
    emit: bool
    sampling: object
    is_chunk: bool
    #: adapter-pool slot this row's LoRA delta gathers from (0 = identity --
    #: the no-adapter row); the engine fills it from Request.adapter_slot
    adapter: int = 0


def _bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ModelBackend:
    """Interface base (see module docstring). Subclasses own params, the KV
    pool, the penalty-count tensor and the step functions."""

    #: the PagedInferenceModel running the steps (tests flip its
    #: ``use_paged_kernel``)
    infer: PagedInferenceModel

    #: the last launch's padded token geometry for the goodput ledger
    #: (reassigned, never mutated in place, by every step entry point)
    step_accounting: dict

    def prefill(self, input_ids, block_tables, suffix_lens, cached_entries,
                sampling, slot_idx, adapter_table=None) -> np.ndarray:
        raise NotImplementedError

    def decode(self, last_tokens, block_tables, context_lens, done0, remaining,
               sampling, adapter_table=None) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def mixed_step(self, chunk_rows: List[MixedRow], decode_rows: List[MixedRow]) -> np.ndarray:
        raise NotImplementedError

    def verify(self, tokens, block_tables, start_pos, need_logits: bool, adapter_table=None):
        raise NotImplementedError

    def seed_counts(self, slot_idx, cached_entries):
        raise NotImplementedError

    def reset_counts(self):
        raise NotImplementedError

    def apply_cow(self, pairs):
        raise NotImplementedError

    def host_planes(self, n_blocks: int) -> List[torch.Tensor]:
        """The host tier's arena for ``n_blocks`` blocks: one block-major
        host tensor [n, L, 2, K, bs, H] per pool plane (kv, then the scale
        plane of a quantized pool), pinned when the pool is on CUDA."""
        raise NotImplementedError

    def kv_spill(self, block_ids, planes, slots):
        """Gather ``block_ids`` out of the pool and start their copy into the
        arena ``planes`` at ``slots``. Must be called BEFORE any launch that
        writes the (just recycled) blocks."""
        raise NotImplementedError

    def kv_promote(self, seq_id, block_ids, planes, slots):
        """Start the copy of arena ``slots`` back into the freshly allocated
        pool blocks ``block_ids``. Returns a :class:`HostPromoteTicket` whose
        markers feed :meth:`migration_ready`."""
        raise NotImplementedError

    def migration_ready(self, ticket) -> bool:
        """Non-blocking landed check of a copy ticket's markers: a
        scheduling signal only (the launches that read the blocks are
        ordered after the copy by the backend)."""
        return all(m.query() for m in ticket.markers)

    def sync_params(self, new_params):
        raise NotImplementedError

    def describe(self) -> dict:
        raise NotImplementedError


class _HostCopies:
    """The host KV tier's copies on CUDA, between the pool's blocks and the
    tier's pinned arena: one side stream, ordered against the compute stream
    (the current stream) by events. ``timings`` keeps the recent copies'
    (direction, bytes, start event, done event), timed on the side stream."""

    def __init__(self, device):
        self.device = device
        self._side = None
        self.timings: deque = deque(maxlen=256)

    def _stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _timed(self, kind, nbytes, side):
        start = torch.cuda.Event(enable_timing=True)
        start.record(side)
        done = torch.cuda.Event(enable_timing=True)
        self.timings.append((kind, nbytes, start, done))
        return done

    def to_host(self, blocks: Sequence[torch.Tensor], planes: Sequence[torch.Tensor], slots: Sequence[int]):
        """D2H copies of block-major tensors the compute stream is producing
        into the arena at ``slots``: the side stream waits on an event
        recorded after them, copies each run of consecutive slots and records
        the completion event, which it returns."""
        side = self._stream()
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(self.device))
        side.wait_event(produced)
        with torch.cuda.stream(side):
            done = self._timed("d2h", sum(t.numel() * t.element_size() for t in blocks), side)
            for t, plane in zip(blocks, planes):
                for i, slot, n in slot_runs(slots):
                    plane[slot: slot + n].copy_(t[i: i + n], non_blocking=True)
                t.record_stream(side)  # its memory is not reused before the copy ran
            done.record(side)
        return done

    def to_device(self, planes: Sequence[torch.Tensor], slots: Sequence[int]):
        """H2D copies of the arena's ``slots`` on the side stream: (block-major
        device tensors, completion event)."""
        side = self._stream()
        with torch.cuda.stream(side):
            out = [torch.empty((len(slots),) + tuple(p.shape[1:]), dtype=p.dtype, device=self.device) for p in planes]
            done = self._timed("h2d", sum(t.numel() * t.element_size() for t in out), side)
            for t, plane in zip(out, planes):
                for i, slot, n in slot_runs(slots):
                    t[i: i + n].copy_(plane[slot: slot + n], non_blocking=True)
            done.record(side)
        return out, done

    def compute_wait(self, event, tensors: Iterable[torch.Tensor]):
        """Order the compute stream after ``event``; ``tensors``, made on the
        side stream, are then used on the compute stream."""
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for t in tensors:
            t.record_stream(compute)


class _CpuCopies:
    """The same interface on the CPU: every copy is done when it returns."""

    def to_host(self, blocks, planes, slots):
        for t, plane in zip(blocks, planes):
            plane[list(slots)] = t
        return None

    def to_device(self, planes, slots):
        return [plane[list(slots)] for plane in planes], None

    def compute_wait(self, event, tensors):
        pass


@dataclasses.dataclass
class _PendingPromote:
    """A promote whose H2D copy is in flight and whose scatter into the pool
    has not run yet."""

    ids: torch.Tensor  # target blocks, long, on the pool's device
    blocks: frozenset
    planes: list  # staged block-major [n, L, 2, ...] data for kv (and scale)
    landed: Optional[object]  # the copy's event (None: already there)


class SingleDeviceBackend(ModelBackend):
    """Params, pool and counts on the model's device."""

    def __init__(self, model, *, max_batch_size: int, block_size: int, num_blocks: int,
                 max_blocks_per_seq: int, dtype, decode_steps: int, eos_ids,
                 kv_cache_quant: Optional[str] = None, adapter_registry=None):
        self.model = model
        self.device = model.device
        self.max_batch_size = max_batch_size
        self.step_accounting = {"fed": 0, "shape": ()}
        # multi-LoRA: the registry whose pool the steps gather per-row deltas
        # from, and the pool's device copy with the registry version it holds
        self.adapter_registry = adapter_registry
        self._lora_dev: Optional[dict] = None
        self._lora_version: Optional[int] = None
        self.infer = PagedInferenceModel(
            model, block_size, num_blocks, max_blocks_per_seq, dtype=dtype,
            decode_steps=decode_steps, eos_ids=eos_ids)
        self.pool = init_paged_pool(
            model.config, num_blocks, block_size,
            dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32,
            quant=kv_cache_quant, device=self.device)
        self.counts = torch.zeros((max_batch_size, model.config.vocab_size), dtype=torch.int32,
                                  device=self.device)
        self._copies = _HostCopies(self.device) if self.device.type == "cuda" else _CpuCopies()
        self._promotes: List[_PendingPromote] = []

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _samp(self, sampling, n):
        return samp_arrays(sampling, n, device=self.device)

    # ---------------------------------------------------------------- lora
    def _lora_tree(self):
        """The device copy of the registry's adapter pool, brought up to the
        registry's version first (None without a registry)."""
        reg = self.adapter_registry
        if reg is None:
            return None
        if reg.version != self._lora_version:
            self._lora_version = reg.copy_pool(None if self._lora_dev is None else self._lora_version,
                                               self._copy_lora_slots)
        return self._lora_dev

    def _copy_lora_slots(self, host, slots):
        """Copy pool ``slots`` of every host array into the device copy
        (allocated on first use). Synchronous copies: the registry may
        rewrite its arrays once this returns."""
        if self._lora_dev is None:
            with torch.inference_mode(False):  # placed tensors stay ordinary ones
                self._lora_dev = {proj: {k: torch.from_numpy(a).to(self.device, copy=True) for k, a in w.items()}
                                  for proj, w in host.items()}
            return
        for proj, w in host.items():
            for k, arr in w.items():
                dev = self._lora_dev[proj][k]
                for slot in slots:
                    dev[:, slot].copy_(torch.from_numpy(arr[:, slot]))

    def _adapter_idx(self, adapter_table, n: int) -> Optional[torch.Tensor]:
        """Per-row pool slots of an n-row launch as a device tensor, or None
        when every row is on the identity slot (the delta would add zeros).
        Raises for adapter rows without a registry: a scheduler bug must not
        silently serve base-model tokens."""
        idx = np.zeros(n, np.int32)
        if adapter_table is not None:
            idx[: len(adapter_table)] = np.asarray(adapter_table, np.int32)
        if not idx.any():
            return None
        if self.adapter_registry is None:
            raise ValueError("adapter_table has non-identity rows but the backend has no adapter_registry")
        return self._dev(idx, torch.int32)

    # ---------------------------------------------------------------- counts
    def _cached_counts(self, cached_entries, n_rows: int) -> torch.Tensor:
        """Penalty counts for prefix-cache-hit prompt spans: the fed suffix is
        counted on device, the cached span here via host bincount. Clipped: an
        out-of-vocab id from a direct caller degrades to a garbage count, it
        does not crash the step. ``cached_entries`` = [(row, prompt_ids,
        n_cached)]; returns [n_rows, vocab] int32."""
        vocab = self.model.config.vocab_size
        counts_in = None
        for row, prompt_ids, n_cached in cached_entries:
            if n_cached > 0:
                if counts_in is None:
                    counts_in = np.zeros((n_rows, vocab), np.int32)
                counts_in[row] = np.bincount(np.clip(prompt_ids[:n_cached], 0, vocab - 1),
                                             minlength=vocab)[:vocab]
        if counts_in is None:
            return torch.zeros((n_rows, vocab), dtype=torch.int32, device=self.device)
        return self._dev(counts_in, torch.int32)

    def seed_counts(self, slot_idx, cached_entries):
        rows = self._cached_counts(cached_entries, len(slot_idx))
        self.counts[self._dev(slot_idx, torch.long)] = rows

    def reset_counts(self):
        self.counts.zero_()

    # ---------------------------------------------------------------- steps
    def prefill(self, input_ids, block_tables, suffix_lens, cached_entries,
                sampling, slot_idx, adapter_table=None) -> np.ndarray:
        n = input_ids.shape[0]
        self.step_accounting = {"fed": n * input_ids.shape[1],
                                "shape": ("prefill", n, input_ids.shape[1])}
        cached_lens = np.zeros(n, np.int32)
        for row, _ids, n_cached in cached_entries:
            cached_lens[row] = n_cached
        self._land_promotes(block_tables)
        tokens, counts_rows = self.infer.prefill(
            self.pool, self._dev(input_ids, torch.int32), self._dev(block_tables, torch.int32),
            self._dev(suffix_lens, torch.int32), self._dev(cached_lens, torch.int32),
            self._cached_counts(cached_entries, n), self._samp(sampling, n),
            lora=self._lora_tree(), adapter_idx=self._adapter_idx(adapter_table, n))
        self.counts[self._dev(slot_idx, torch.long)] = counts_rows[: len(slot_idx)]
        return tokens.cpu().numpy()  # THE prefill sync point: sampled int32 ids only

    def decode(self, last_tokens, block_tables, context_lens, done0, remaining,
               sampling, adapter_table=None) -> Tuple[np.ndarray, np.ndarray]:
        B, steps = last_tokens.shape[0], self.infer.decode_steps
        self.step_accounting = {"fed": B * steps, "shape": ("decode", B, steps)}
        self._land_promotes(block_tables)
        toks, valid, _, _, counts = self.infer.decode(
            self.pool, self._dev(last_tokens, torch.int32), self._dev(block_tables, torch.int32),
            self._dev(context_lens, torch.int32), self._dev(done0, torch.bool),
            self._dev(remaining, torch.int32), self.counts, self._samp(sampling, len(sampling)),
            lora=self._lora_tree(), adapter_idx=self._adapter_idx(adapter_table, B))
        self.counts.copy_(counts)
        return toks.cpu().numpy(), valid.cpu().numpy()  # THE decode sync point: ids + flags only

    def verify(self, tokens, block_tables, start_pos, need_logits: bool, adapter_table=None):
        B, T = tokens.shape
        self.step_accounting = {"fed": B * T, "shape": ("verify", B, T)}
        self._land_promotes(block_tables)
        argmax, logits = self.infer.verify(
            self.pool, self._dev(tokens, torch.int32), self._dev(block_tables, torch.int32),
            self._dev(start_pos, torch.int32), need_logits=need_logits,
            lora=self._lora_tree(), adapter_idx=self._adapter_idx(adapter_table, B))
        # THE verify sync point: the argmax, and the fp32 logits only when
        # rejection sampling asks for them
        return argmax.cpu().numpy(), (logits.cpu().numpy() if need_logits else None)

    def apply_cow(self, pairs):
        self._land_promotes([b for pair in pairs for b in pair])
        copy_blocks(self.pool, pairs)

    # ---------------------------------------------------------------- host tier
    def _planes(self):
        return [self.pool.kv] + ([] if self.pool.scale is None else [self.pool.scale])

    def host_planes(self, n_blocks: int) -> List[torch.Tensor]:
        return [torch.empty((n_blocks,) + (p.shape[:2] + p.shape[3:]), dtype=p.dtype,
                            pin_memory=self.device.type == "cuda") for p in self._planes()]

    def kv_spill(self, block_ids, planes, slots):
        self._land_promotes(block_ids)
        ids = self._dev(block_ids, torch.long)
        # the gather is enqueued on the compute stream now, ahead of any
        # launch that rewrites the blocks, so it reads their old bytes
        return self._copies.to_host([gather_blocks(p, ids) for p in self._planes()], planes, slots)

    def kv_promote(self, seq_id, block_ids, planes, slots):
        ids = [int(b) for b in block_ids]
        staged, landed = self._copies.to_device(planes, slots)
        if len(ids) & (len(ids) - 1):
            # the JAX package pads the scatter to a power of two with zero
            # rows aimed at block 0: block 0 ends up zeroed there, so here too
            for plane in self._planes():
                plane[:, :, 0] = 0
        self._promotes.append(_PendingPromote(
            ids=self._dev(ids, torch.long), blocks=frozenset(ids), planes=staged, landed=landed))
        return HostPromoteTicket(seq_id=seq_id, n_blocks=len(ids), markers=() if landed is None else (landed,))

    def _land_promotes(self, blocks):
        """Scatter pending promotes into the pool, on the compute stream and
        in the order they were made: every one up to the last whose blocks
        ``blocks`` (block ids a launch reads or writes) holds, the compute
        stream waiting on its copy, and after those every one whose copy has
        already landed."""
        if not self._promotes:
            return
        wanted = set(np.asarray(blocks, dtype=np.int64).ravel().tolist())
        n = max((i + 1 for i, p in enumerate(self._promotes) if p.blocks & wanted), default=0)
        while n < len(self._promotes) and (self._promotes[n].landed is None or self._promotes[n].landed.query()):
            n += 1
        for p in self._promotes[:n]:
            if p.landed is not None:
                self._copies.compute_wait(p.landed, p.planes)
            for plane, data in zip(self._planes(), p.planes):
                scatter_blocks(plane, data, p.ids)
        del self._promotes[:n]

    def sync_params(self, new_params):
        """Place ``new_params`` on the model's device now (eagerly, so an
        out-of-memory error surfaces inside the caller's rollback window; a
        tree already there is installed as it is), rebind ``model.params``
        and rebuild the paged model's per-layer views, which would otherwise
        keep serving the old tree."""
        flat = flatten_params(new_params)
        if any(v.device != self.device for v in flat.values()):
            with torch.inference_mode(False):  # placed tensors stay ordinary ones
                new_params = unflatten_params({k: v.to(self.device) for k, v in flat.items()})
        self.model.params = new_params
        self.infer.bind_params()

    # ---------------------------------------------------------------- mixed
    def mixed_step(self, chunk_rows: List[MixedRow], decode_rows: List[MixedRow]) -> np.ndarray:
        """One ragged mixed step. Returns sampled tokens in row order
        ``[*chunk_rows, *decode_rows]`` (the scheduler keeps them only where
        ``emit``)."""
        self._land_promotes([r.table for r in chunk_rows + decode_rows])
        # the plain path flattens (decode rows padded to the chunk bucket
        # would dominate its cost); the kernel takes one padded launch
        launch = self._mixed_padded_launch if self.infer.use_paged_kernel else self._mixed_flat_launch
        tokens, mapper = launch(chunk_rows, decode_rows)
        return mapper(tokens.cpu().numpy())  # THE mixed-step sync point: sampled int32 ids only

    def _mixed_padded_launch(self, chunk_rows, decode_rows):
        """One [B, T] launch, every row padded to the chunk bucket: what the
        ragged kernel wants (one grid covers chunks, decodes and dead rows).
        Returns (device tokens, host-order mapper)."""
        B = self.max_batch_size
        T = _bucket(max([len(r.tokens) for r in chunk_rows], default=1), minimum=1)
        self.step_accounting = {"fed": B * T, "shape": ("mixed_padded", B, T)}
        ids = np.zeros((B, T), np.int32)
        tables = np.zeros((B, (chunk_rows or decode_rows)[0].table.shape[0]), np.int32)
        q_lens = np.zeros(B, np.int32)
        q_start = np.zeros(B, np.int32)
        count_fed = np.zeros(B, bool)
        emit = np.zeros(B, bool)
        adapter = np.zeros(B, np.int32)
        sampling: List = [None] * B
        for r in chunk_rows + decode_rows:
            n = len(r.tokens)
            ids[r.slot, :n] = r.tokens
            tables[r.slot] = r.table
            q_lens[r.slot] = n
            q_start[r.slot] = r.start
            count_fed[r.slot] = r.is_chunk  # chunk tokens accumulate into counts
            emit[r.slot] = r.emit
            adapter[r.slot] = r.adapter
            sampling[r.slot] = r.sampling
        tokens, counts = self.infer.mixed_step(
            self.pool, self._dev(ids, torch.int32), self._dev(tables, torch.int32),
            self._dev(q_lens, torch.int32), self._dev(q_start, torch.int32), self.counts,
            self._dev(count_fed, torch.bool), self._dev(emit, torch.bool), self._samp(sampling, B),
            lora=self._lora_tree(), adapter_idx=self._adapter_idx(adapter, B))
        self.counts.copy_(counts)
        rows = chunk_rows + decode_rows
        return tokens, lambda host: np.asarray([host[r.slot] for r in rows])

    def _mixed_flat_launch(self, chunk_rows, decode_rows):
        """Token-flattened layout: chunk rows keep their [C, T] matrix, decode
        rows collapse to a [D, 1] segment, so per-step cost scales with the
        tokens actually fed (bucketed per segment). Token-identical to the
        padded layout. Returns (device tokens, host-order mapper)."""
        C = _bucket(len(chunk_rows), minimum=1)
        T = _bucket(max([len(r.tokens) for r in chunk_rows], default=1), minimum=1)
        D = _bucket(len(decode_rows), minimum=1)
        self.step_accounting = {"fed": C * T + D, "shape": ("mixed_flat", C, T, D)}
        M = (chunk_rows or decode_rows)[0].table.shape[0]
        c_ids = np.zeros((C, T), np.int32)
        c_tables = np.zeros((C, M), np.int32)
        c_qlens = np.zeros(C, np.int32)
        c_start = np.zeros(C, np.int32)
        c_slots = np.zeros(C, np.int32)
        c_emit = np.zeros(C, bool)
        c_adapter = np.zeros(C, np.int32)
        d_tokens = np.zeros(D, np.int32)
        d_tables = np.zeros((D, M), np.int32)
        d_start = np.zeros(D, np.int32)
        d_slots = np.zeros(D, np.int32)
        d_live = np.zeros(D, bool)
        d_adapter = np.zeros(D, np.int32)
        for j, r in enumerate(chunk_rows):
            n = len(r.tokens)
            c_ids[j, :n] = r.tokens
            c_tables[j] = r.table
            c_qlens[j] = n
            c_start[j] = r.start
            c_slots[j] = r.slot
            c_emit[j] = r.emit
            c_adapter[j] = r.adapter
        for j, r in enumerate(decode_rows):
            d_tokens[j] = r.tokens[0]
            d_tables[j] = r.table
            d_start[j] = r.start
            d_slots[j] = r.slot
            d_live[j] = True
            d_adapter[j] = r.adapter
        sampling = ([r.sampling for r in chunk_rows] + [None] * (C - len(chunk_rows))
                    + [r.sampling for r in decode_rows] + [None] * (D - len(decode_rows)))
        i32 = torch.int32
        tokens, counts = self.infer.mixed_step_flat(
            self.pool, self._dev(c_ids, i32), self._dev(c_tables, i32), self._dev(c_qlens, i32),
            self._dev(c_start, i32), self._dev(c_slots, i32), self._dev(c_emit, torch.bool),
            self._dev(d_tokens, i32), self._dev(d_tables, i32), self._dev(d_start, i32),
            self._dev(d_slots, i32), self._dev(d_live, torch.bool), self.counts,
            self._samp(sampling, C + D), lora=self._lora_tree(),
            chunk_adapter=self._adapter_idx(c_adapter, C), dec_adapter=self._adapter_idx(d_adapter, D))
        self.counts.copy_(counts)
        n_c, n_d = len(chunk_rows), len(decode_rows)
        return tokens, lambda host: np.concatenate([host[:n_c], host[C: C + n_d]])

    # ---------------------------------------------------------------- misc
    def describe(self) -> dict:
        return {"kind": "single_device", "devices": 1, "tp_degree": 1, "mesh": None,
                "device": str(self.device)}
