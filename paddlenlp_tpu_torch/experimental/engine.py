"""Continuous-batching inference engine.

PyTorch port of ``paddlenlp_tpu/experimental/engine.py``: the same host-side
scheduler over a :class:`~.backend.ModelBackend`:

- admission: waiting requests prefill in BATCHES grouped by power-of-two padded
  prompt length, with prefix caching (full prompt blocks are shared by
  content hash, a fully covered prompt copies its tail block on write); the
  first token is sampled on device inside the prefill;
- chunked prefill (``prefill_chunk_tokens=N``): prompt processing is split into
  chunks of at most N tokens interleaved with one decode token per running
  sequence in ONE ragged mixed step, so a long prompt never stalls running
  decodes for the whole prompt;
- decode: all slots advance up to ``decode_steps`` tokens per call, with
  sampling, penalties, eos and length stops on the device; the host reads ids
  and flags once per call;
- preemption: on block exhaustion the youngest sequence is evicted and requeued
  with prompt+generated as its new prompt (recompute). Sampling keys are
  (seed, absolute position), so a recomputed sequence resamples identically;
- streaming: per-request callbacks fire as tokens land;
- observability: the tracer's engine spans (``admission``, ``prefix_cache``,
  ``prefill``, ``mixed_step``, ``decode``) and instants (``kv_alloc``,
  ``kv_free``, ``preempt``), the flight recorder's decision events
  (``admit.*``, ``chunk.grant``, ``preempt``), the ``engine.step`` and
  ``engine.prefill_chunk`` fault points, the per-tenant goodput fold and the
  per-request usage fields the serving meter books;
- weight hot-swap: :meth:`InferenceEngine.sync_params` installs a new
  parameter tree through the backend (the serving loop's swap path).

Options of the JAX engine that this port does not have yet raise
``NotImplementedError`` naming their ROADMAP item (speculative decoding, the
host KV tier, multi-LoRA and tenant quotas, meshes and disaggregated stages,
quantized weights).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..observability.flight_recorder import RECORDER
from ..observability.goodput import GoodputLedger, device_peak_flops, efficiency_doc, estimate_model_flops_per_token
from ..observability.tracer import TRACER
from ..serving.tenancy.adapters import UnknownAdapterError
from ..serving.tenancy.quotas import DEFAULT_TENANT, tenant_goodput_fold
from ..utils.faults import FaultPoint
from ..utils.log import logger
from .backend import MixedRow, ModelBackend, SingleDeviceBackend, _bucket
from .paged_cache import BlockManager

__all__ = ["InferenceEngine", "Request", "SamplingParams"]

_F_STEP = FaultPoint("engine.step")
_F_CHUNK = FaultPoint("engine.prefill_chunk")


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 64
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    seed: int = 0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0


#: admission preference rank per serving priority class (lower admits first);
#: unknown strings rank as interactive
_PRIORITY_RANK = {"interactive": 0, "batch": 1, "best_effort": 2}


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_ids: np.ndarray
    sampling: SamplingParams
    output_ids: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stream_cb: Optional[Callable[[int, bool], None]] = None
    arrival_t: float = 0.0
    sched_t: Optional[float] = None  # first admitted to a slot (prefill launch)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None  # stop | length | abort | capacity
    aborted: bool = False
    base_prompt_len: int = 0  # original prompt length (preemption grows prompt_ids)
    trace: Optional[str] = None  # observability trace id (serving request context)
    # orders the waiting queue under load: interactive admits ahead of batch,
    # batch ahead of best_effort; FIFO within a class
    priority: str = "interactive"
    # which tenant the request bills to (per-tenant goodput fold, metric labels)
    tenant: str = DEFAULT_TENANT
    prefilled_len: int = 0  # prompt tokens whose KV is in the pool (chunked prefill)
    # latency-attribution bookkeeping (engine_loop.request_attribution):
    # first time the request was head-of-queue but deferred by an admission
    # gate (splits queue_wait into pure-queue vs admission-gate) ...
    gated_t: Optional[float] = None
    # ... and decode-window seconds spent riding mixed steps that also carried
    # other requests' prefill chunks (the per-request decode-stall share)
    chunk_stall_s: float = 0.0
    # goodput-ledger bookkeeping: highest absolute position ever fed through
    # a forward for this request — re-feeding below the mark is rework ...
    fed_hwm: int = 0
    # ... COW tail tokens owed by a full-cover prefix-cache admission ...
    cow_pending: int = 0
    # ... and the rework bucket re-fed positions land in (preemption
    # recompute vs a supervisor requeue across a rebuild)
    rework_src: str = "preempt_refill"
    # usage-metering bookkeeping (serving.tenancy.metering.UsageMeter reads
    # these at finish): prefix-cache tokens credited at FIRST admission only
    # (None until admitted: a preemption re-admission must not re-credit) ...
    cached_tokens: Optional[int] = None
    # ... engine-attributed useful fed positions, mirroring the per-tenant
    # goodput fold token for token ...
    useful_tokens: int = 0
    # ... and the block-seconds integral of KV residency (advanced by a
    # per-step checkpoint while kv_occ_t holds the open episode's start;
    # finalized in _free_kv, so it accumulates across preemption episodes)
    kv_block_seconds: float = 0.0
    kv_occ_t: Optional[float] = None

    @property
    def needs_prefill(self) -> bool:
        """True while part of the prompt still awaits a prefill chunk."""
        return self.prefilled_len < len(self.prompt_ids)

    @property
    def total_len(self) -> int:
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds spent waiting before first admission (TTFT = queue + prefill)."""
        if self.sched_t is None:
            return None
        return self.sched_t - self.arrival_t

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.arrival_t

    @property
    def decode_time(self) -> Optional[float]:
        """Seconds from first token to completion (0 for single-token results)."""
        if self.finish_t is None or self.first_token_t is None:
            return None
        return self.finish_t - self.first_token_t

    @property
    def gen_offset(self) -> int:
        """Tokens already regenerated into prompt_ids by a preemption-requeue."""
        return len(self.prompt_ids) - self.base_prompt_len

    @property
    def remaining_new(self) -> int:
        return self.sampling.max_new_tokens - self.gen_offset - len(self.output_ids)


def _not_ported(option: str, item: str):
    raise NotImplementedError(f"{option} is not part of the PyTorch port yet: ROADMAP {item}")


class InferenceEngine:
    def __init__(
        self,
        model,
        tokenizer=None,
        max_batch_size: int = 8,
        block_size: int = 16,
        num_blocks: int = 512,
        max_blocks_per_seq: int = 64,
        eos_token_id: Optional[int] = None,
        dtype: Optional[torch.dtype] = None,  # None: bf16 on CUDA, fp32 on the CPU
        decode_steps: int = 8,
        kv_cache_quant: Optional[str] = None,  # None | "int8" | "fp8"
        # share KV blocks across common prompt prefixes. Content-addressed:
        # only valid while params are frozen
        enable_prefix_cache: bool = True,
        # split prompt processing into chunks of at most this many tokens,
        # interleaved with decode tokens. None/0 = monolithic prefill.
        prefill_chunk_tokens: Optional[int] = None,
        # options of the JAX engine not ported yet: each raises when set
        use_speculative: bool = False,
        draft_model=None,
        mesh_shape=None,
        disagg_stages=None,
        adapter_registry=None,
        tenant_quotas=None,
        host_kv_blocks: int = 0,
    ):
        if use_speculative or draft_model is not None:
            _not_ported("speculative decoding (use_speculative/draft_model)", "Queue 1 item 8")
        if mesh_shape is not None or disagg_stages is not None:
            _not_ported("sharded and disaggregated backends (mesh_shape/disagg_stages)", "Queue 1 item 12")
        if adapter_registry is not None or tenant_quotas is not None:
            _not_ported("multi-LoRA and tenant quotas (adapter_registry/tenant_quotas)", "Queue 1 item 10")
        if host_kv_blocks:
            _not_ported("the host KV tier (host_kv_blocks)", "Queue 1 item 9")
        self.model = model
        self.tokenizer = tokenizer
        if dtype is None:
            dtype = torch.bfloat16 if model.device.type == "cuda" else torch.float32
        eos = eos_token_id if eos_token_id is not None else getattr(model.config, "eos_token_id", None)
        self.eos_ids = set(eos) if isinstance(eos, (list, tuple)) else ({eos} if eos is not None else set())
        self.backend: ModelBackend = SingleDeviceBackend(
            model, max_batch_size=max_batch_size, block_size=block_size, num_blocks=num_blocks,
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype, decode_steps=decode_steps,
            eos_ids=self.eos_ids, kv_cache_quant=kv_cache_quant)
        self.enable_prefix_cache = enable_prefix_cache
        self.mgr = BlockManager(num_blocks, block_size, max_blocks_per_seq,
                                enable_prefix_cache=enable_prefix_cache)
        # per-tenant attributable-token accounting (the tenancy fold over the
        # goodput ledger): monotone engine totals, surviving reset()
        self.tenant_goodput: Dict[str, Dict[str, int]] = {}
        self.max_batch_size = max_batch_size
        self.decode_steps = decode_steps
        # no speculative decoding yet: the counters the metrics plane and
        # /health read stay at zero
        self.spec_stats = {"verify_steps": 0, "tokens_emitted": 0, "drafted": 0, "accepted": 0}
        self.waiting: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_batch_size
        self._next_id = itertools.count()
        self._last_token = np.zeros(max_batch_size, np.int32)
        self.num_preemptions = 0
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 0:
            raise ValueError(f"prefill_chunk_tokens must be >= 0, got {prefill_chunk_tokens}")
        self.prefill_chunk_tokens = prefill_chunk_tokens or None
        # chunked-prefill accounting: monotone totals plus bounded event rings
        self.chunk_stats = {"chunks": 0, "chunk_tokens": 0}
        self._chunk_seq = itertools.count(1)
        self.recent_chunk_sizes: deque = deque(maxlen=256)  # (seq, n_tokens)
        self.recent_decode_stalls: deque = deque(maxlen=256)  # (seq, seconds)
        # monotone step id, stamped on the host spans
        self._step_seq = itertools.count()
        self._cur_step = -1
        # goodput ledger: per-step token-conservation accounting
        # (fed == useful + padding + spec_rejected + rework, exact) + step
        # anatomy; totals survive reset()
        self.ledger = GoodputLedger(
            flops_per_token=estimate_model_flops_per_token(model.config),
            peak_flops=device_peak_flops() if model.device.type == "cuda" else float("nan"))
        # step-time anatomy ring: (seq, gap_s, device_s, host_s); gap_s < 0 =
        # unmeasured (post-idle)
        self.recent_step_times: deque = deque(maxlen=512)
        self._step_time_seq = itertools.count(1)
        self._last_step_end: Optional[float] = None
        self._prev_step_busy = False
        self._step_device_s = 0.0

    # device state lives in the backend; these stay as read paths
    @property
    def infer(self):
        return self.backend.infer

    @property
    def pool(self):
        return self.backend.pool

    @property
    def counts(self):
        return self.backend.counts

    # ------------------------------------------------------------------ api
    def add_request(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                    stream_cb: Optional[Callable] = None, trace: Optional[str] = None,
                    priority: str = "interactive", rework_hwm: int = 0,
                    adapter_id: Optional[str] = None,
                    tenant: str = DEFAULT_TENANT) -> int:
        """``rework_hwm`` marks the first ``rework_hwm`` prompt positions as
        already-fed-once (a supervisor requeue resubmitting a folded prompt
        after an engine rebuild): the goodput ledger then books their
        re-prefill as ``requeue_refill`` rework instead of useful work.

        ``adapter_id`` names a LoRA adapter: the port has no adapter registry
        yet, so any id raises :class:`UnknownAdapterError` at submit.
        ``tenant`` names the billing identity the request's work is
        attributed to."""
        sampling = sampling or SamplingParams()
        if adapter_id is not None:
            raise UnknownAdapterError(
                f"adapter {adapter_id!r} requested but the engine has no adapter_registry")
        req = Request(
            req_id=next(self._next_id),
            prompt_ids=np.asarray(prompt_ids, dtype=np.int32).reshape(-1),
            sampling=sampling,
            stream_cb=stream_cb,
            arrival_t=time.time(),
            trace=trace,
            priority=priority,
            tenant=tenant,
        )
        req.base_prompt_len = len(req.prompt_ids)
        self._tenant_counts(tenant)["requests"] += 1
        if rework_hwm > 0:
            req.fed_hwm = min(int(rework_hwm), len(req.prompt_ids))
            req.rework_src = "requeue_refill"
        # priority-ordered admission: insert before the first waiting request
        # of a STRICTLY lower class; same-class order stays FIFO
        rank = _PRIORITY_RANK.get(priority, 0)
        if not self.waiting or _PRIORITY_RANK.get(self.waiting[-1].priority, 0) <= rank:
            self.waiting.append(req)
        else:
            for i, queued in enumerate(self.waiting):
                if _PRIORITY_RANK.get(queued.priority, 0) > rank:
                    self.waiting.insert(i, req)
                    break
        return req.req_id

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def abort(self, req_id: int) -> Optional[Request]:
        """Cancel a request wherever it is (waiting queue or a running slot):
        frees its KV blocks, marks it ``aborted`` with ``finish_reason='abort'``
        and returns it; None for unknown or finished ids. The stream callback
        is not fired."""
        for i, req in enumerate(self.waiting):
            if req.req_id == req_id:
                del self.waiting[i]
                self._finish_abort(req)
                return req
        for slot, req in enumerate(self.slots):
            if req is not None and req.req_id == req_id:
                self._free_kv(req)
                self.slots[slot] = None
                self._finish_abort(req)
                return req
        return None

    def _free_kv(self, req: Request, cache: bool = False):
        """Release a request's KV blocks. ``cache=True`` (normal finishes)
        registers its full blocks in the prefix index instead of freeing them;
        aborts and preemptions release by refcount without registering."""
        freed = self.mgr.lengths.get(req.req_id)
        if req.kv_occ_t is not None:
            # close the open KV-occupancy episode while the block table still
            # exists: the block-seconds integral is what usage metering bills
            req.kv_block_seconds += (time.perf_counter() - req.kv_occ_t) \
                * len(self.mgr.tables.get(req.req_id, ()))
            req.kv_occ_t = None
        if cache and self.enable_prefix_cache and req.finish_reason in ("stop", "length"):
            # GENERATED blocks register too (a completion is the next turn's
            # prompt prefix); the last sampled token was emitted, never fed,
            # so its KV position was never written
            token_ids = req.prompt_ids
            if len(req.output_ids) > 1:
                token_ids = np.concatenate([req.prompt_ids, np.asarray(req.output_ids[:-1], np.int32)])
            self.mgr.finish_seq_cached(req.req_id, token_ids)
        else:
            self.mgr.free_seq(req.req_id)
        TRACER.instant("kv_free", cat="engine", trace=req.trace,
                       req_id=req.req_id, tokens_held=freed,
                       free_blocks=self.mgr.num_free,
                       cached_blocks=self.mgr.num_cached_blocks)

    def _finish_abort(self, req: Request):
        req.done = True
        req.aborted = True
        req.finish_reason = "abort"
        req.finish_t = time.time()

    def release_request(self, req_id: int) -> bool:
        """Drop a request from the scheduler (waiting queue or its slot) and
        free its KV blocks WITHOUT touching its finish fields: the caller owns
        the request's resolution. Returns True iff the engine held it."""
        for i, req in enumerate(self.waiting):
            if req.req_id == req_id:
                del self.waiting[i]  # waiting requests hold no KV blocks
                return True
        for slot, req in enumerate(self.slots):
            if req is not None and req.req_id == req_id:
                self._free_kv(req)
                self.slots[slot] = None
                return True
        if req_id in self.mgr.lengths:
            # allocated but bound to no slot yet (failure mid-admission)
            self.mgr.free_seq(req_id)
            return True
        return False

    def resync_counts(self):
        """Re-seed the device-side penalty counts of every live slot from
        host-known token history (``prompt[:prefilled_len] + output_ids``).
        The supervisor's slot quarantine calls this after releasing a
        poisoned request: the failed step may have committed count updates
        for tokens whose host-side emit never ran."""
        entries, slot_idx = [], []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            hist = np.concatenate([req.prompt_ids[: req.prefilled_len],
                                   np.asarray(req.output_ids, np.int32)])
            entries.append((len(slot_idx), hist, len(hist)))
            slot_idx.append(slot)
        if slot_idx:
            self.backend.seed_counts(slot_idx, entries)

    def clear_prefix_cache(self):
        """Invalidate every cached prefix block (idle ones return to the free
        list). Required after a weight update: cached KV is only valid under
        the params that produced it."""
        self.mgr.clear_prefix_cache()

    def sync_params(self, new_params):
        """Install a new base-weight tree through the backend seam (eager
        placement on the model's device, see
        :meth:`ModelBackend.sync_params`). Callers own the rest of the swap
        protocol: quiesce, :meth:`clear_prefix_cache` and
        :meth:`resync_counts` for any slots kept live across the swap."""
        self.backend.sync_params(new_params)

    def reset(self):
        """Drop ALL scheduler/allocator state after a failed step. The device
        pool tensor is kept (stale KV is unreachable once the block tables are
        rebuilt). In-flight requests are NOT resolved here."""
        self.waiting.clear()
        self.slots = [None] * self.max_batch_size
        self.mgr = BlockManager(self.mgr.total_usable_blocks + 1, self.mgr.block_size,
                                self.mgr.max_blocks_per_seq,
                                enable_prefix_cache=self.enable_prefix_cache)
        self._last_token[:] = 0
        self.backend.reset_counts()
        # the failed step never ran its anatomy tail: without this, the first
        # post-recovery step would book the whole outage as a "step gap"
        self._last_step_end = None
        self._prev_step_busy = False
        logger.warning("inference engine reset: scheduler + KV allocator state dropped")

    def stats(self) -> Dict:
        """Point-in-time scheduler/allocator stats, in the JAX engine's shape:
        the host tier and speculative counters read zero, the tenancy fold
        appears once a request arrived."""
        out = {
            "queue_depth": len(self.waiting),
            "running": sum(1 for r in self.slots if r is not None),
            "max_batch_size": self.max_batch_size,
            "free_blocks": self.mgr.num_free,
            "total_blocks": self.mgr.total_usable_blocks,
            "num_preemptions": self.num_preemptions,
            "spec_stats": dict(self.spec_stats),
            "prefix_cache": {
                "enabled": self.enable_prefix_cache,
                "hits": self.mgr.cache_hits,
                "cached_tokens": self.mgr.cached_tokens_total,
                "evictions": self.mgr.evictions,
                "cached_blocks": self.mgr.num_cached_blocks,
                "host": {"enabled": False, "promotes_inflight": 0, "blocks": 0, "capacity": 0,
                         "spills": 0, "spill_batches": 0, "promotes": 0, "promoted_blocks": 0,
                         "promote_bytes": 0, "evictions": 0},
            },
            "chunked_prefill": {
                "enabled": bool(self.prefill_chunk_tokens),
                "chunk_tokens": self.prefill_chunk_tokens or 0,
                "chunks": self.chunk_stats["chunks"],
                "chunk_tokens_total": self.chunk_stats["chunk_tokens"],
            },
            "backend": self.backend.describe(),
            "goodput": self.ledger.snapshot(),
        }
        if self.tenant_goodput:
            out["tenancy"] = {"tenants": tenant_goodput_fold(self.tenant_goodput),
                              "adapters": None, "quotas": None}
        return out

    def kv_fragmentation(self) -> float:
        """1 - held tokens / (held blocks * block_size); 0.0 when nothing is
        allocated. Called from HTTP scrape threads while the loop thread
        mutates the BlockManager: the dict snapshots are taken via ``list()``
        and a mid-resize race degrades to one stale scrape."""
        try:
            tables = list(self.mgr.tables.values())
            lengths = list(self.mgr.lengths.values())
        except RuntimeError:  # dict resized mid-copy by the loop thread
            return 0.0
        blocks = sum(len(t) for t in tables)
        if not blocks:
            return 0.0
        return max(0.0, 1.0 - sum(lengths) / (blocks * self.mgr.block_size))

    def efficiency(self) -> Dict:
        """The efficiency document: ledger snapshot, MFU / FLOPs model,
        percentiled step anatomy, occupancy and KV fragmentation."""
        running = sum(1 for r in self.slots if r is not None)
        try:
            step_times = list(self.recent_step_times)
        except RuntimeError:  # loop thread appended mid-copy: drop one window
            step_times = []
        return efficiency_doc(
            self.ledger, step_times, tier="serving",
            extra={
                "occupancy": {
                    "running": running,
                    "max_batch_size": self.max_batch_size,
                    "slot_occupancy": running / max(self.max_batch_size, 1),
                },
                "kv_fragmentation": round(self.kv_fragmentation(), 6),
                "spec": {
                    "drafted": self.spec_stats["drafted"],
                    "accepted": self.spec_stats["accepted"],
                    "acceptance_rate": self.spec_stats["accepted"] / max(self.spec_stats["drafted"], 1),
                },
                "backend": self.backend.describe(),
            })

    def generate(self, prompts: List, sampling: Optional[SamplingParams] = None) -> List[List[int]]:
        """Submit a batch and run to completion (convenience API)."""
        ids = [self.add_request(p, sampling) for p in prompts]
        results: Dict[int, Request] = {}
        while self.has_work():
            for req in self.step():
                results[req.req_id] = req
        return [results[i].output_ids for i in ids]

    # ------------------------------------------------------------------ scheduling
    def step(self) -> List[Request]:
        """One engine iteration: admit + decode. Returns requests finished this step."""
        _F_STEP.fire()
        self._cur_step = next(self._step_seq)
        # step anatomy: host gap since the previous BUSY step ended vs device
        # time inside backend calls vs the step's own host scheduling time
        t_step0 = time.perf_counter()
        gap_s = (t_step0 - self._last_step_end
                 if self._last_step_end is not None and self._prev_step_busy
                 else -1.0)
        self._step_device_s = 0.0
        finished: List[Request] = []
        # the step's range on a torch.profiler timeline (POST /debug/profile)
        with torch.profiler.record_function("engine_step"):
            if self.prefill_chunk_tokens:
                self._admit_chunked(finished)
                if any(r is not None and r.needs_prefill for r in self.slots):
                    # >=1 slot mid-prefill: one ragged mixed step
                    self._mixed_step(finished)
                else:
                    # steady state: the multi-token decode
                    self._decode_running(finished)
            else:
                self._admit(finished)
                self._decode_running(finished)
        # usage metering: advance each admitted request's kv_block_seconds
        # integral piecewise per step (block counts grow during decode)
        t_occ = time.perf_counter()
        for req in self.slots:
            if req is not None and req.kv_occ_t is not None:
                req.kv_block_seconds += (t_occ - req.kv_occ_t) \
                    * len(self.mgr.tables.get(req.req_id, ()))
                req.kv_occ_t = t_occ
        t_end = time.perf_counter()
        host_s = max(t_end - t_step0 - self._step_device_s, 0.0)
        self.ledger.note_step(max(gap_s, 0.0), self._step_device_s, host_s)
        self.recent_step_times.append(
            (next(self._step_time_seq), gap_s, self._step_device_s, host_s))
        self._last_step_end = t_end
        self._prev_step_busy = self.has_work()
        return finished

    def _free_slot_indices(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _tenant_counts(self, tenant: str) -> Dict[str, int]:
        tg = self.tenant_goodput.get(tenant)
        if tg is None:
            tg = self.tenant_goodput[tenant] = {
                "useful": 0, "rework": 0, "requests": 0, "tokens_out": 0}
        return tg

    def _note_fed_span(self, req: Request, start: int, n: int):
        """Goodput split of one fed span ``[start, start+n)``: positions below
        the request's fed high-water mark plus owed COW tail tokens are
        rework; the rest is useful. Advances the mark. Returns
        ``(rework, rework_by|None)``."""
        if n <= 0:
            return 0, None
        overlap = min(max(req.fed_hwm - start, 0), n)
        by = {}
        if overlap:
            by[req.rework_src] = overlap
        cow = min(req.cow_pending, n - overlap)
        if cow:
            by["cow_token"] = cow
            req.cow_pending -= cow
        req.fed_hwm = max(req.fed_hwm, start + n)
        rework = overlap + cow
        # the per-tenant fold and its per-request mirror (the usage record's
        # useful_tokens reconciles against the ledger token for token)
        tg = self._tenant_counts(req.tenant)
        tg["useful"] += n - rework
        tg["rework"] += rework
        req.useful_tokens += n - rework
        return rework, (by or None)

    @staticmethod
    def _merge_rework(total_by: Dict[str, int], by: Optional[Dict[str, int]]):
        if by:
            for k, v in by.items():
                total_by[k] = total_by.get(k, 0) + v

    def _note_gated(self, req: Request, reason: str):
        """Mark the head-of-queue request as gate-deferred, ONCE per wait
        episode: the timestamp splits its queue_wait into pure-queue vs
        admission-gate time, and the single decision event keeps a blocked
        queue from flooding the flight recorder."""
        if req.gated_t is not None:
            return
        req.gated_t = time.time()
        RECORDER.record("admit.defer", req_id=req.req_id, trace=req.trace,
                        reason=reason, queue_depth=len(self.waiting),
                        free_blocks=self.mgr.num_free)

    def _admit_slots(self, finished: List[Request]) -> List[tuple]:
        """Shared admission front half: bind waiting requests to free slots and
        allocate their KV blocks (prefix-cache match + COW included). Returns
        ``[(slot, req, n_cached), ...]``; the caller owns the prefill launch."""
        free = self._free_slot_indices()
        if not self.waiting or not free:
            return []
        queue_depth = len(self.waiting)
        n_finished0 = len(finished)
        admit_t0 = time.perf_counter()
        cache_on = self.enable_prefix_cache
        hits0, cached0 = self.mgr.cache_hits, self.mgr.cached_tokens_total
        admitted: List[tuple] = []
        while self.waiting and free:
            req = self.waiting[0]
            prompt_len = len(req.prompt_ids)
            # a request that can NEVER fit fails fast instead of spinning
            need = self.mgr.blocks_needed(prompt_len + req.remaining_new)
            if need > self.mgr.max_blocks_per_seq or need > self.mgr.total_usable_blocks:
                self.waiting.popleft()
                req.done = True
                req.finish_reason = "capacity"
                req.finish_t = time.time()
                RECORDER.record("admit.reject", req_id=req.req_id, trace=req.trace,
                                reason="capacity", blocks_needed=need,
                                prompt_len=prompt_len)
                logger.warning(f"req {req.req_id}: needs {need} KV blocks (> capacity); rejected")
                finished.append(req)
                continue
            # reserve prompt + 1 so the first decode never immediately preempts;
            # cached prefix blocks need no fresh capacity. The prefix match is
            # computed ONCE and shared with allocate
            match = None
            if cache_on:
                best_need = self.mgr.blocks_needed(prompt_len + 1) - prompt_len // self.mgr.block_size
                if best_need > self.mgr.num_free:
                    self._note_gated(req, "kv_pressure")
                    break
                match = self.mgr.match_prefix(req.prompt_ids, prompt_len)
            if not self.mgr.can_admit(prompt_len + 1, match=match):
                self._note_gated(req, "kv_pressure")
                break
            self.waiting.popleft()
            if req.sched_t is None:  # preserved across preemption-requeues
                req.sched_t = time.time()
            if cache_on:
                _cached_blocks, n_cached, _new = self.mgr.allocate(
                    req.req_id, prompt_len, token_ids=req.prompt_ids, match=match)
            else:
                self.mgr.allocate(req.req_id, prompt_len)
                n_cached = 0
            # full-cover COW admissions owe a tail re-prefill of KV another
            # request already built: the ledger books it as cow_token rework
            req.cow_pending = (prompt_len - n_cached
                               if (match is not None and match[2] is not None) else 0)
            # usage metering: the KV-occupancy episode opens with the blocks;
            # the cache credit bills ONCE, at first admission
            req.kv_occ_t = time.perf_counter()
            if req.cached_tokens is None:
                req.cached_tokens = n_cached
            TRACER.instant("kv_alloc", cat="engine", trace=req.trace,
                           req_id=req.req_id, tokens=prompt_len,
                           cached_tokens=n_cached,
                           free_blocks=self.mgr.num_free)
            slot = free.pop(0)
            RECORDER.record("admit.accept", req_id=req.req_id, trace=req.trace,
                            slot=slot, prompt_len=prompt_len,
                            cached_tokens=n_cached)
            admitted.append((slot, req, n_cached))
        # the admission span closes BEFORE prefill (sibling phases, not
        # nested) and only when something happened
        if admitted or len(finished) > n_finished0:
            TRACER.add_span("admission", TRACER.epoch_time(admit_t0),
                            time.perf_counter() - admit_t0, cat="engine",
                            step=self._cur_step,
                            queue_depth=queue_depth, admitted=len(admitted),
                            rejected_capacity=len(finished) - n_finished0)
        if cache_on and admitted:
            # prefix_cache phase: COW bookkeeping + the owed block copies
            pc_t0 = time.perf_counter()
            cow = self.mgr.drain_cow_pairs()
            if cow:
                self.backend.apply_cow(cow)
            TRACER.add_span("prefix_cache", TRACER.epoch_time(pc_t0),
                            time.perf_counter() - pc_t0, cat="engine",
                            hits=self.mgr.cache_hits - hits0,
                            cached_tokens=self.mgr.cached_tokens_total - cached0,
                            cow_copies=len(cow))
        return admitted

    def _admit(self, finished: List[Request]):
        self._prefill_batch(self._admit_slots(finished), finished)

    def _prefill_batch(self, admitted: List[tuple], finished: List[Request]):
        """Launch monolithic prefill for ``[(slot, req, n_cached), ...]``,
        batched by padded UNCACHED suffix length."""
        by_bucket: Dict[int, List[tuple]] = {}
        for slot, req, n_cached in admitted:
            by_bucket.setdefault(_bucket(len(req.prompt_ids) - n_cached), []).append((slot, req, n_cached))
        for padded, group in by_bucket.items():
            n = _bucket(len(group), minimum=1)
            ids = np.zeros((n, padded), np.int32)
            tables = np.zeros((n, self.mgr.max_blocks_per_seq), np.int32)
            suffix_lens = np.zeros(n, np.int32)
            sampling: List = [None] * n
            for j, (slot, req, n_cached) in enumerate(group):
                suffix = req.prompt_ids[n_cached:]
                ids[j, : len(suffix)] = suffix
                tables[j] = self.mgr.table_array(req.req_id)
                suffix_lens[j] = len(suffix)
                sampling[j] = req.sampling
            entries = [(j, req.prompt_ids, c) for j, (_, req, c) in enumerate(group)]
            with TRACER.span("prefill", cat="engine", bucket=padded, batch=len(group),
                             step=self._cur_step,
                             req_ids=[r.req_id for _, r, _ in group],
                             cached_tokens=sum(c for _, _, c in group)):
                t_dev = time.perf_counter()
                tokens = self.backend.prefill(ids, tables, suffix_lens, entries, sampling,
                                              [slot for slot, _, _ in group])
                self._step_device_s += time.perf_counter() - t_dev
            # goodput: fed = the padded launch geometry; useful = the uncached
            # suffixes minus any re-fed (post-preemption/COW) positions
            acct = self.backend.step_accounting
            g_useful = g_rework = 0
            g_by: Dict[str, int] = {}
            for slot, req, n_cached in group:
                n_fed = len(req.prompt_ids) - n_cached
                rw, by = self._note_fed_span(req, n_cached, n_fed)
                g_useful += n_fed - rw
                g_rework += rw
                self._merge_rework(g_by, by)
            self.ledger.note_shape(acct["shape"])
            self.ledger.record("prefill", acct["fed"], g_useful,
                               padding=acct["fed"] - g_useful - g_rework,
                               rework=g_rework, rework_by=g_by or None)
            for j, (slot, req, _) in enumerate(group):
                req.prefilled_len = len(req.prompt_ids)
                self._settle_sampled(slot, req, int(tokens[j]), finished)

    def _settle_sampled(self, slot: int, req: Request, tok: int, finished: List[Request]):
        """Post-sample bookkeeping shared by every sampling site: emit, then
        either retire the request (KV freed / prefix-cache registered, slot
        vacated) or keep it decoding in its slot."""
        self._emit(req, tok)
        if req.done:
            self._free_kv(req, cache=True)
            self.slots[slot] = None
            finished.append(req)
        else:
            self.slots[slot] = req
            self._last_token[slot] = tok

    # ------------------------------------------------------------------ chunked prefill
    def _admit_chunked(self, finished: List[Request]):
        """Chunked admission: bind slots + allocate KV, but launch NO prefill:
        the request sits in its slot with ``prefilled_len`` = its prefix-cache
        hit and :meth:`_mixed_step` feeds the rest chunk by chunk."""
        admitted = self._admit_slots(finished)
        if not admitted:
            return
        slot_idx = []
        for slot, req, n_cached in admitted:
            req.prefilled_len = n_cached
            self.slots[slot] = req
            slot_idx.append(slot)
        # seed the device-side penalty counts: the cached span never rides
        # through a chunk forward (zeros rows still land: the slot's previous
        # occupant is stale)
        self.backend.seed_counts(
            slot_idx, [(i, req.prompt_ids, c) for i, (_, req, c) in enumerate(admitted)])

    def _mixed_step(self, finished: List[Request]):
        """One ragged mixed step: up to ``prefill_chunk_tokens`` prompt tokens
        (oldest mid-prefill request first) plus ONE decode token for every
        running sequence, in a single forward."""
        _F_CHUNK.fire(
            prefilling=sum(1 for r in self.slots if r is not None and r.needs_prefill))
        # capacity pass: every decoding slot needs a block covering this step's
        # KV write; exhaustion preempts the YOUNGEST active slot
        for slot in sorted([s for s, r in enumerate(self.slots) if r is not None and not r.needs_prefill],
                           key=lambda s: self.slots[s].req_id):
            req = self.slots[slot]
            if req is None or req.needs_prefill:
                continue  # victim of an earlier iteration's preemption
            while True:
                grow = req.total_len - self.mgr.lengths[req.req_id]
                if grow <= 0 or self.mgr.extend(req.req_id, grow) is not None:
                    break
                active = [s for s, r in enumerate(self.slots) if r is not None]
                victim = max(active, key=lambda s: self.slots[s].req_id)
                self._preempt(victim, cause="mixed_capacity")
                if victim == slot:
                    break
        budget = self.prefill_chunk_tokens
        chunk_rows: List[tuple] = []  # (slot, req, n_new)
        decode_rows: List[tuple] = []  # (slot, req)
        prefilling: List[int] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.needs_prefill:
                prefilling.append(slot)
            else:
                decode_rows.append((slot, req))
        for slot in sorted(prefilling, key=lambda s: self.slots[s].req_id):
            if budget <= 0:
                break
            req = self.slots[slot]
            n = min(budget, len(req.prompt_ids) - req.prefilled_len)
            chunk_rows.append((slot, req, n))
            budget -= n
            RECORDER.record("chunk.grant", req_id=req.req_id, trace=req.trace,
                            tokens=n, budget_left=budget, step=self._cur_step)
        if not chunk_rows and not decode_rows:
            return
        t0 = time.perf_counter()
        chunk_payload = []
        for slot, req, n in chunk_rows:
            p0 = req.prefilled_len
            chunk_payload.append(MixedRow(
                slot=slot, tokens=req.prompt_ids[p0: p0 + n], start=p0,
                table=self.mgr.table_array(req.req_id),
                emit=p0 + n == len(req.prompt_ids),  # sampler on last chunk
                sampling=req.sampling, is_chunk=True))
        dec_payload = [
            MixedRow(slot=slot, tokens=np.asarray([self._last_token[slot]], np.int32),
                     start=req.total_len - 1,  # position of the token being fed
                     table=self.mgr.table_array(req.req_id), emit=True,
                     sampling=req.sampling, is_chunk=False)
            for slot, req in decode_rows]
        with TRACER.span("mixed_step", cat="engine", step=self._cur_step,
                         chunks=len(chunk_rows), decodes=len(decode_rows),
                         chunk_tokens=int(sum(n for _, _, n in chunk_rows)),
                         req_ids=[r.req_id for _, r, _ in chunk_rows]), \
                torch.profiler.record_function("mixed_step"):
            t_dev = time.perf_counter()
            tokens = self.backend.mixed_step(chunk_payload, dec_payload)
            self._step_device_s += time.perf_counter() - t_dev
        dur = time.perf_counter() - t0
        # goodput accounting BEFORE settle mutates prefilled_len/total_len
        acct = self.backend.step_accounting
        g_useful = g_rework = 0
        g_by: Dict[str, int] = {}
        for _slot, req, n in chunk_rows:
            rw, by = self._note_fed_span(req, req.prefilled_len, n)
            g_useful += n - rw
            g_rework += rw
            self._merge_rework(g_by, by)
        for _slot, req in decode_rows:
            rw, by = self._note_fed_span(req, req.total_len - 1, 1)
            g_useful += 1 - rw
            g_rework += rw
            self._merge_rework(g_by, by)
        self.ledger.note_shape(acct["shape"])
        self.ledger.record("mixed", acct["fed"], g_useful,
                           padding=acct["fed"] - g_useful - g_rework,
                           rework=g_rework, rework_by=g_by or None)
        if chunk_rows:
            # every decode token in this step waited out the chunk work: the
            # step duration is each riding request's decode-stall share
            for _slot, req in decode_rows:
                req.chunk_stall_s += dur
        for j, (slot, req, n) in enumerate(chunk_rows):
            req.prefilled_len += n
            self.chunk_stats["chunks"] += 1
            self.chunk_stats["chunk_tokens"] += n
            self.recent_chunk_sizes.append((next(self._chunk_seq), n))
            if not req.needs_prefill:
                self._settle_sampled(slot, req, int(tokens[j]), finished)
        for j, (slot, req) in enumerate(decode_rows):
            self._settle_sampled(slot, req, int(tokens[len(chunk_rows) + j]), finished)
        if chunk_rows and decode_rows:
            # every decode token in this step waited out the chunk work
            self.recent_decode_stalls.append((next(self._chunk_seq), dur))

    def _preempt(self, slot: int, cause: str = "decode_growth"):
        """Evict + requeue with prompt+generated as the new prompt (recompute
        recovery). ``cause`` names which capacity pass chose the victim."""
        req = self.slots[slot]
        logger.warning(f"req {req.req_id}: KV blocks exhausted; preempting (recompute)")
        self.num_preemptions += 1
        RECORDER.record("preempt", req_id=req.req_id, trace=req.trace,
                        reason=cause, generated=len(req.output_ids),
                        free_blocks=self.mgr.num_free)
        TRACER.instant("preempt", cat="engine", trace=req.trace, req_id=req.req_id,
                       generated=len(req.output_ids), free_blocks=self.mgr.num_free)
        self._free_kv(req)
        self.slots[slot] = None
        req.prompt_ids = np.concatenate([req.prompt_ids, np.asarray(req.output_ids, np.int32)])
        req.output_ids = []
        # a half-prefilled request's KV is gone with its blocks: re-admission
        # starts the chunk walk over (prefix-cache hits re-credit what they can)
        req.prefilled_len = 0
        req.rework_src = "preempt_refill"
        self.waiting.appendleft(req)

    def _decode_running(self, finished: List[Request]):
        if not any(r is not None for r in self.slots):
            return
        steps = self.decode_steps
        # grow tables for up to `steps` tokens; preempt (recompute-requeue)
        # the youngest on exhaustion. Surplus is shrunk back after the call.
        start_len: Dict[int, int] = {}
        active = [s for s in range(len(self.slots)) if self.slots[s] is not None]
        for slot in sorted(active, key=lambda s: -self.slots[s].req_id):
            req = self.slots[slot]
            needed = min(steps, req.remaining_new)
            start_len[req.req_id] = self.mgr.lengths[req.req_id]
            if self.mgr.extend(req.req_id, max(needed, 1)) is None:
                start_len.pop(req.req_id, None)
                self._preempt(slot)
        if not any(r is not None for r in self.slots):
            return
        B = self.max_batch_size
        tokens = np.array(self._last_token, np.int32)
        tables = np.zeros((B, self.mgr.max_blocks_per_seq), np.int32)
        ctx = np.zeros(B, np.int32)
        done0 = np.ones(B, bool)
        remaining = np.zeros(B, np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            tables[i] = self.mgr.table_array(req.req_id)
            ctx[i] = req.total_len - 1  # position of the token being fed
            done0[i] = False
            remaining[i] = req.remaining_new
        with TRACER.span("decode", cat="engine", steps=steps, step=self._cur_step,
                         active=int(sum(1 for r in self.slots if r is not None))), \
                torch.profiler.record_function("decode"):
            t_dev = time.perf_counter()
            toks, valid = self.backend.decode(tokens, tables, ctx, done0, remaining,
                                              [None if r is None else r.sampling for r in self.slots])
            self._step_device_s += time.perf_counter() - t_dev
        n_emitted = 0
        for s in range(toks.shape[0]):
            for i, req in enumerate(self.slots):
                if req is None or req.done or not valid[s, i]:
                    continue
                self._emit(req, int(toks[s, i]))
                self._last_token[i] = int(toks[s, i])
                n_emitted += 1
                # per-tenant fold: each emitted decode token consumed one fed
                # position (this path bypasses _note_fed_span)
                self._tenant_counts(req.tenant)["useful"] += 1
                req.useful_tokens += 1
        # goodput: the decode call always burns B x decode_steps positions;
        # every emitted token is one useful fed position, the rest is padding
        acct = self.backend.step_accounting
        for req in self.slots:
            if req is not None:
                # the last emitted token was sampled, not fed: mark to total-1
                req.fed_hwm = max(req.fed_hwm, req.total_len - 1)
        self.ledger.note_shape(acct["shape"])
        self.ledger.record("decode", acct["fed"], n_emitted, padding=acct["fed"] - n_emitted)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if req.done:
                self._free_kv(req, cache=True)
                self.slots[i] = None
                finished.append(req)
            elif req.req_id in start_len:
                # return blocks past the tokens actually produced
                self.mgr.shrink(req.req_id, req.total_len)

    def _emit(self, req: Request, tok: int):
        try:
            if req.first_token_t is None:
                req.first_token_t = time.time()
            req.output_ids.append(tok)
            self._tenant_counts(req.tenant)["tokens_out"] += 1
            is_eos = tok in self.eos_ids
            hit_max = req.gen_offset + len(req.output_ids) >= req.sampling.max_new_tokens
            req.done = is_eos or hit_max
            if req.done:
                req.finish_t = time.time()
                req.finish_reason = "stop" if is_eos else "length"
            if req.stream_cb is not None:
                req.stream_cb(tok, req.done)
        except Exception as e:
            # per-request host failure (a poisoned stream callback): attribute
            # it so the serving supervisor can quarantine THIS slot instead of
            # rebuilding the whole engine
            if getattr(e, "req_id", None) is None:
                try:
                    e.req_id = req.req_id
                except Exception:
                    pass
            raise
