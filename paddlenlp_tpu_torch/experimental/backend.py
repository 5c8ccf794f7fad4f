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
- ``seed_counts``/``reset_counts``  per-slot penalty-count maintenance;
- ``apply_cow(pairs)``   prefix-cache copy-on-write block copies in the pool;
- ``sync_params(tree)``  install a new parameter tree (live weight swap);
- ``describe()``         placement metadata for ``stats()``.

Every step entry point also sets ``self.step_accounting`` to ``{"fed": <token
positions the launch processed>, "shape": <launch-geometry key>}`` before it
runs; the engine reads it right after the call to feed the goodput ledger.

The serving loop steps the engine under ``torch.inference_mode()`` on its own
thread. The backend's long-lived tensors (the pool, the penalty counts, the
parameters) stay ordinary tensors all the same: they are updated in place or
placed outside inference mode, so the engine stays usable from any thread.

The sharded and disaggregated backends of the JAX package, its host-tier
spill/promote entry points and speculative ``verify`` are not part of the
port yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..transformers.conversion_utils import flatten_params, unflatten_params
from .inference_model import PagedInferenceModel
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
                sampling, slot_idx) -> np.ndarray:
        raise NotImplementedError

    def decode(self, last_tokens, block_tables, context_lens, done0, remaining,
               sampling) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def mixed_step(self, chunk_rows: List[MixedRow], decode_rows: List[MixedRow]) -> np.ndarray:
        raise NotImplementedError

    def seed_counts(self, slot_idx, cached_entries):
        raise NotImplementedError

    def reset_counts(self):
        raise NotImplementedError

    def apply_cow(self, pairs):
        raise NotImplementedError

    def sync_params(self, new_params):
        raise NotImplementedError

    def describe(self) -> dict:
        raise NotImplementedError


class SingleDeviceBackend(ModelBackend):
    """Params, pool and counts on the model's device."""

    def __init__(self, model, *, max_batch_size: int, block_size: int, num_blocks: int,
                 max_blocks_per_seq: int, dtype, decode_steps: int, eos_ids,
                 kv_cache_quant: Optional[str] = None):
        self.model = model
        self.device = model.device
        self.max_batch_size = max_batch_size
        self.step_accounting = {"fed": 0, "shape": ()}
        self.infer = PagedInferenceModel(
            model, block_size, num_blocks, max_blocks_per_seq, dtype=dtype,
            decode_steps=decode_steps, eos_ids=eos_ids)
        self.pool = init_paged_pool(
            model.config, num_blocks, block_size,
            dtype=torch.bfloat16 if dtype == torch.bfloat16 else torch.float32,
            quant=kv_cache_quant, device=self.device)
        self.counts = torch.zeros((max_batch_size, model.config.vocab_size), dtype=torch.int32,
                                  device=self.device)

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _samp(self, sampling, n):
        return samp_arrays(sampling, n, device=self.device)

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
                sampling, slot_idx) -> np.ndarray:
        n = input_ids.shape[0]
        self.step_accounting = {"fed": n * input_ids.shape[1],
                                "shape": ("prefill", n, input_ids.shape[1])}
        cached_lens = np.zeros(n, np.int32)
        for row, _ids, n_cached in cached_entries:
            cached_lens[row] = n_cached
        tokens, counts_rows = self.infer.prefill(
            self.pool, self._dev(input_ids, torch.int32), self._dev(block_tables, torch.int32),
            self._dev(suffix_lens, torch.int32), self._dev(cached_lens, torch.int32),
            self._cached_counts(cached_entries, n), self._samp(sampling, n))
        self.counts[self._dev(slot_idx, torch.long)] = counts_rows[: len(slot_idx)]
        return tokens.cpu().numpy()  # THE prefill sync point: sampled int32 ids only

    def decode(self, last_tokens, block_tables, context_lens, done0, remaining,
               sampling) -> Tuple[np.ndarray, np.ndarray]:
        B, steps = last_tokens.shape[0], self.infer.decode_steps
        self.step_accounting = {"fed": B * steps, "shape": ("decode", B, steps)}
        toks, valid, _, _, counts = self.infer.decode(
            self.pool, self._dev(last_tokens, torch.int32), self._dev(block_tables, torch.int32),
            self._dev(context_lens, torch.int32), self._dev(done0, torch.bool),
            self._dev(remaining, torch.int32), self.counts, self._samp(sampling, len(sampling)))
        self.counts.copy_(counts)
        return toks.cpu().numpy(), valid.cpu().numpy()  # THE decode sync point: ids + flags only

    def apply_cow(self, pairs):
        copy_blocks(self.pool, pairs)

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
        sampling: List = [None] * B
        for r in chunk_rows + decode_rows:
            n = len(r.tokens)
            ids[r.slot, :n] = r.tokens
            tables[r.slot] = r.table
            q_lens[r.slot] = n
            q_start[r.slot] = r.start
            count_fed[r.slot] = r.is_chunk  # chunk tokens accumulate into counts
            emit[r.slot] = r.emit
            sampling[r.slot] = r.sampling
        tokens, counts = self.infer.mixed_step(
            self.pool, self._dev(ids, torch.int32), self._dev(tables, torch.int32),
            self._dev(q_lens, torch.int32), self._dev(q_start, torch.int32), self.counts,
            self._dev(count_fed, torch.bool), self._dev(emit, torch.bool), self._samp(sampling, B))
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
        d_tokens = np.zeros(D, np.int32)
        d_tables = np.zeros((D, M), np.int32)
        d_start = np.zeros(D, np.int32)
        d_slots = np.zeros(D, np.int32)
        d_live = np.zeros(D, bool)
        for j, r in enumerate(chunk_rows):
            n = len(r.tokens)
            c_ids[j, :n] = r.tokens
            c_tables[j] = r.table
            c_qlens[j] = n
            c_start[j] = r.start
            c_slots[j] = r.slot
            c_emit[j] = r.emit
        for j, r in enumerate(decode_rows):
            d_tokens[j] = r.tokens[0]
            d_tables[j] = r.table
            d_start[j] = r.start
            d_slots[j] = r.slot
            d_live[j] = True
        sampling = ([r.sampling for r in chunk_rows] + [None] * (C - len(chunk_rows))
                    + [r.sampling for r in decode_rows] + [None] * (D - len(decode_rows)))
        i32 = torch.int32
        tokens, counts = self.infer.mixed_step_flat(
            self.pool, self._dev(c_ids, i32), self._dev(c_tables, i32), self._dev(c_qlens, i32),
            self._dev(c_start, i32), self._dev(c_slots, i32), self._dev(c_emit, torch.bool),
            self._dev(d_tokens, i32), self._dev(d_tables, i32), self._dev(d_start, i32),
            self._dev(d_slots, i32), self._dev(d_live, torch.bool), self.counts,
            self._samp(sampling, C + D))
        self.counts.copy_(counts)
        n_c, n_d = len(chunk_rows), len(decode_rows)
        return tokens, lambda host: np.concatenate([host[:n_c], host[C: C + n_d]])

    # ---------------------------------------------------------------- misc
    def describe(self) -> dict:
        return {"kind": "single_device", "devices": 1, "tp_degree": 1, "mesh": None,
                "device": str(self.device)}
