"""Background engine-driver thread: thread-safe submission + token streams,
supervised for fault tolerance.

Counterpart of the reference's serving split (``llm/predict/flask_server.py``
pushes prompts into the inference process and reads tokens back over a SysV
message queue): here the ``InferenceEngine`` runs on ONE dedicated thread that
continuously drives ``engine.step()``, and HTTP worker threads talk to it only
through queues — the engine itself is never touched concurrently, so the
host-side block manager needs no locks.

- ``submit()`` returns a :class:`RequestHandle`: a future (``result()``) plus
  a per-request token queue (``tokens()``) fed by the engine's ``stream_cb``;
- ``cancel()`` routes through the loop thread to ``engine.abort`` so KV blocks
  free deterministically between steps;
- per-request deadlines are enforced by the loop (expired requests abort with
  ``finish_reason='abort'`` and ``timed_out=True`` on the handle);
- all request lifecycle events land in the metrics plane (TTFT, queue wait,
  inter-token latency, tokens, preemptions, KV utilization).

**Supervision.** An exception out of ``engine.step()`` no longer kills the
loop. The loop transitions to DEGRADED: in-flight requests are triaged by the
:class:`SupervisorPolicy` — retryable ones (within their bounded retry budget)
are stashed for requeue, the rest resolve immediately with
``finish_reason="engine_error"`` — then the engine is rebuilt (via the
``engine_factory``, or ``engine.reset()`` in place) after an exponential
backoff, stashed requests are resubmitted with their already-streamed tokens
folded into the prompt (the same recompute trick preemption uses, so greedy
and fixed-seed sampled requests continue with identical tokens), and the loop
resumes. While DEGRADED the :class:`~.scheduler.Scheduler` circuit-breaks new
admissions with 503 + ``Retry-After``. Restarts and retries are exported as
``paddlenlp_serving_engine_restarts_total`` /
``paddlenlp_serving_request_retries_total``, and each degraded window lands in
the span tracer as an ``engine_degraded`` span.

**Device state is per thread.** PyTorch's grad mode and current CUDA device
are thread-local: the loop thread enters ``torch.inference_mode()`` around its
iterations and binds the engine's device itself, whatever the thread that
built the engine or started the loop had set.

**A poisoned CUDA context is not retried.** After an illegal address, a
device-side assert or a kernel launch failure, every later call on the
context fails: an in-process rebuild cannot recover it the way an XLA error
is recovered. The supervisor's triage recognizes such an error
(:func:`is_device_fault`), fails the in-flight requests with
``finish_reason="engine_error"``, and holds the loop DEGRADED (503 with
``Retry-After``; no rebuild loop) until the process is replaced. Injected
``FaultPoint`` exceptions and every other error keep the rebuild-and-requeue
path.

**The device profiler runs on the loop thread.** ``run_on_loop(fn)`` runs a
callable on the loop thread between two steps; the server starts and stops
its ``torch.profiler`` capture that way, so the profiler records the thread
that launches the engine's work and is never started or stopped while that
thread is inside an op.

**Concurrency model.** The engine and everything it owns (scheduler state,
``BlockManager``, device handles) are confined to the ONE loop thread — HTTP
worker threads reach them only through the ``_cmds`` queue (thread-safe) and
the per-request :class:`RequestHandle`. ``EngineLoop`` fields are therefore
lock-free by confinement: ``_handles``/``_requeue``/``_last_token_t`` are
written on the loop thread only; ``recent_finished`` is an append-only deque
(atomic ops) that HTTP readers may see a few entries stale; ``_state``/
``_phase``/``_stop`` are single-slot flags where a racy read returns a
momentarily stale-but-valid value by design. The only lock in this module is
``RequestHandle._cb_lock``, guarding the done/callback handoff between the
loop thread and client threads — its fields carry ``# guarded-by:``
annotations enforced by ``tools/analyze`` (lock-discipline checker).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import torch

from ..observability.flight_recorder import RECORDER
from ..observability.goodput import WASTE_KINDS
from ..observability.postmortem import PostmortemDumper
from ..observability.tracer import TRACER
from ..utils.faults import FaultPoint
from ..utils.log import logger
from .metrics import REGISTRY, MetricsRegistry
from .tenancy.adapters import UnknownAdapterError
from .tenancy.metering import UsageMeter
from .tenancy.quotas import DEFAULT_TENANT

__all__ = ["EngineLoop", "RequestHandle", "ServingMetrics", "SupervisorPolicy",
           "ATTRIBUTION_PHASES", "request_attribution", "canary_digest",
           "CANARY_PROMPT_IDS", "is_device_fault"]

#: the per-request latency-attribution phase vocabulary. Non-overlapping by
#: construction: queue + admission_gate span arrival -> first admission, the
#: admission -> first-token window splits into promote_wait (waiting on a
#: host-tier KV promotion copy) + prefill remainder, and the decode window
#: (first token -> finish) splits into chunk_stall + migration_wait + decode
#: remainder — so the phases always sum to e2e exactly when the timeline is
#: complete. The router adds an eighth phase, ``hedge_race``, to the same
#: histogram family for its first-token races.
ATTRIBUTION_PHASES = ("queue", "admission_gate", "promote_wait", "prefill",
                      "chunk_stall", "migration_wait", "decode")


def request_attribution(req) -> Optional[Dict[str, float]]:
    """Decompose one finished request's e2e latency into the attribution
    phases (seconds). Works on engine ``Request``s and ``_FailedRequest``
    shims alike (missing bookkeeping degrades to coarser phases, never an
    error); returns None when the request has no measurable timeline."""
    arrival = getattr(req, "arrival_t", None)
    finish = getattr(req, "finish_t", None)
    if arrival is None or finish is None:
        return None
    sched = getattr(req, "sched_t", None)
    first = getattr(req, "first_token_t", None)
    gated = getattr(req, "gated_t", None)
    out = {p: 0.0 for p in ATTRIBUTION_PHASES}
    end_queue = sched if sched is not None else finish
    if sched is not None and gated is not None and arrival <= gated <= sched:
        # the engine marked the moment the request hit an admission gate at
        # the head of the queue: waiting *behind* others vs waiting *on a
        # gate* are different operator actions (scale out vs retune gates)
        out["queue"] = gated - arrival
        out["admission_gate"] = sched - gated
    else:
        out["queue"] = max(end_queue - arrival, 0.0)
    if sched is not None:
        end_prefill = first if first is not None else finish
        prefill_raw = max(end_prefill - sched, 0.0)
        promote = max(getattr(req, "promote_wait_s", 0.0), 0.0)
        open_promote = getattr(req, "promote_start_t", None)
        if open_promote is not None:
            # finished (abort/quarantine) with the promotion copy still in
            # flight: the open episode ends at the prefill window's end
            promote += max(end_prefill - open_promote, 0.0)
        promote = min(promote, prefill_raw)
        out["promote_wait"] = promote
        out["prefill"] = prefill_raw - promote
    if first is not None:
        decode_raw = max(finish - first, 0.0)
        stall = min(max(getattr(req, "chunk_stall_s", 0.0), 0.0), decode_raw)
        mig = max(getattr(req, "migration_wait_s", 0.0), 0.0)
        open_mig = getattr(req, "migrate_start_t", None)
        if open_mig is not None:
            # the request finished (abort/quarantine) with a migration still
            # in flight: the open episode ends at finish
            mig += max(finish - open_mig, 0.0)
        mig = min(mig, decode_raw - stall)
        out["chunk_stall"] = stall
        out["migration_wait"] = mig
        out["decode"] = decode_raw - stall - mig
    return out

_END = object()  # token-queue sentinel: stream closed

_F_REBUILD = FaultPoint("engine.rebuild")
_F_SLOT_REBUILD = FaultPoint("engine.slot_rebuild")
_F_WEIGHT_SWAP = FaultPoint("engine.weight_swap")

#: the fixed greedy canary probe: low token ids exist in every vocab the stack
#: serves, and greedy decoding makes the output a pure function of the weights
#: — the same prompt on two replicas with the same checkpoint MUST digest
#: identically (the rollout's cross-replica verification contract)
CANARY_PROMPT_IDS = (1, 2, 3, 4, 5, 6, 7, 8)


def canary_digest(token_ids) -> str:
    """Stable digest of a greedy canary generation (order-sensitive, dtype-
    insensitive): what ships in a rollout request and what a reference replica
    records. Pure stdlib so tools/rollout.py can import-free reimplement it."""
    return hashlib.sha256(
        ",".join(str(int(t)) for t in token_ids).encode()).hexdigest()


#: what CUDA reports for the sticky errors that poison a context: every later
#: call on it fails, so no in-process retry can succeed (cudaGetErrorString
#: texts, and the numeric codes the port's kernel wrappers raise with)
_DEVICE_FAULT_TEXTS = (
    "illegal memory access", "unspecified launch failure", "device-side assert",
    "illegal instruction", "misaligned address", "invalid program counter",
    "hardware stack error", "uncorrectable ECC error", "launch timed out",
)
_DEVICE_FAULT_CODES = {"700", "702", "710", "714", "715", "716", "718", "719", "214"}


def is_device_fault(exc: BaseException) -> bool:
    """True when ``exc`` (or an exception it was raised from) is a CUDA error
    that poisoned the context: an illegal address, a device-side assert, a
    failed kernel launch."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        text = str(exc)
        if "CUDA" in text or "cuda" in text:
            if any(t in text for t in _DEVICE_FAULT_TEXTS):
                return True
            code = text.rsplit("CUDA error", 1)[-1].strip(" :()")
            if code.split(" ")[0] in _DEVICE_FAULT_CODES:
                return True
        exc = exc.__cause__ or exc.__context__
    return False


class _CanaryMismatch(RuntimeError):
    """The post-swap canary generation digested differently than expected."""


class _WeightSwap:
    """One in-flight weight-swap command (HTTP thread <-> loop thread handoff).

    The HTTP handler does all validation and checkpoint loading BEFORE
    constructing this (nothing engine-side has mutated if loading fails); the
    loop thread owns quiesce, ``sync_params``, the cache-epoch bump, the
    canary and rollback. ``mode``:

    - ``finish_old``: in-flight requests finish under the old weights; the
      swap waits for the engine to drain (new submissions are held, not
      rejected — the drain is bounded by the caller's timeout).
    - ``pause_resume``: in-flight requests are stashed immediately (the
      supervisor's recompute-requeue trick) and resume under the NEW weights;
      their continuations are explicitly NOT token-identical to what the old
      weights would have produced (``token_identity: false`` in the result).
    """

    def __init__(self, new_params, version: str, mode: str = "finish_old",
                 canary_prompt_ids=None, canary_sampling=None,
                 canary_digest: Optional[str] = None):
        self.new_params = new_params
        self.version = version
        self.mode = mode
        self.canary_prompt_ids = canary_prompt_ids
        self.canary_sampling = canary_sampling
        self.canary_digest = canary_digest
        self.result: Optional[Dict] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    def finish(self, result: Dict):
        self.result = result
        self._done.set()

    def fail(self, error: BaseException):
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float]) -> Dict:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"weight swap to {self.version!r} not finished within {timeout}s")
        if self.error is not None:
            raise self.error
        return self.result


class _LoopCall:
    """One callable handed to the loop thread (``EngineLoop.run_on_loop``).
    A caller that stops waiting cancels it unless it has already begun."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.result = None
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._state = "queued"  # guarded-by: _lock — queued | running | cancelled
        self._done = threading.Event()

    def run(self):
        with self._lock:
            if self._state == "cancelled":
                return
            self._state = "running"
        try:
            self.result = self.fn()
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            self.error = e
        self._done.set()

    def fail(self, error: BaseException):
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float]):
        if not self._done.wait(timeout):
            with self._lock:
                begun = self._state == "running"
                if not begun:
                    self._state = "cancelled"
            if not begun:
                raise TimeoutError(f"the engine loop did not run the call within {timeout}s")
            self._done.wait()  # begun: a call is short, and must not be left half-seen
        if self.error is not None:
            raise self.error
        return self.result


@dataclasses.dataclass
class SupervisorPolicy:
    """Governs the DEGRADED transition after an engine-step exception.

    ``max_retries`` bounds how many engine rebuilds a single request may ride
    through before it is fast-cleared with ``finish_reason="engine_error"``
    (per-request override via ``submit(..., max_retries=)``). The rebuild
    backoff is exponential in the consecutive-failure count, capped at
    ``backoff_max_s``; a healthy stretch of ``failure_reset_s`` resets the
    count. ``max_rebuild_attempts=None`` keeps trying forever — the circuit
    breaker (503) is the pressure valve, not loop death.

    ``max_slot_quarantines`` bounds *partial* recovery: a step failure the
    engine attributed to ONE request (the exception carries a ``req_id``)
    quarantines only that slot — its KV blocks are released, its handle
    resolves ``engine_error``, and the loop resumes without degrading — up to
    this many consecutive quarantines inside a ``failure_reset_s`` window.
    Past the bound (or when attribution is absent) the full degrade/rebuild
    path runs: repeated "single bad request" failures in a tight window
    usually mean the engine itself is poisoned."""

    max_retries: int = 2
    backoff_base_s: float = 0.25
    backoff_max_s: float = 10.0
    failure_reset_s: float = 60.0
    max_rebuild_attempts: Optional[int] = None
    max_slot_quarantines: int = 3


class _FailedRequest:
    """Finished-request shim for handles resolved without a live engine
    request (engine died and the retry budget is spent). Carries exactly the
    fields the metrics plane, the trace emitter, and the HTTP layer read."""

    def __init__(self, req_id, prompt_ids, output_ids, trace,
                 arrival_t, finish_reason="engine_error",
                 tenant: str = DEFAULT_TENANT,
                 adapter_id: Optional[str] = None):
        self.req_id = req_id if req_id is not None else -1
        self.prompt_ids = list(prompt_ids)
        self.output_ids = list(output_ids)
        self.trace = trace
        self.tenant = tenant
        self.adapter_id = adapter_id
        self.aborted = False
        self.done = True
        self.finish_reason = finish_reason
        self.arrival_t = arrival_t
        self.sched_t = None
        self.first_token_t = None
        self.finish_t = time.time()
        self.queue_wait = None
        self.ttft = None
        self.decode_time = None


class RequestHandle:
    """Client-side view of one in-flight request (future + token stream)."""

    def __init__(self, prompt_len: int, deadline_t: Optional[float] = None,
                 trace: Optional[str] = None, max_retries: Optional[int] = None,
                 priority: str = "interactive", tenant: str = DEFAULT_TENANT,
                 adapter_id: Optional[str] = None):
        self.req_id: Optional[int] = None  # assigned on the loop thread
        self.trace = trace  # span-tracer trace id linking this request's phases
        self.prompt_len = prompt_len
        self.priority = priority  # serving priority class (brownout shed order)
        self.tenant = tenant  # isolation/accounting key (requests_total label)
        self.adapter_id = adapter_id  # LoRA adapter this request decodes with
        self.depth_at_submit = 0  # engine backlog when submitted (queue-wait norm)
        self.deadline_t = deadline_t
        self.submitted_t = time.time()
        self.timed_out = False
        self.max_retries = max_retries  # None = supervisor policy default
        self.retries = 0  # engine rebuilds this request rode through
        self._token_q: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._request = None  # engine Request once finished
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._cb_lock = threading.Lock()
        self._callbacks: List = []  # guarded-by: _cb_lock
        # supervisor state: everything needed to resubmit after a rebuild
        self._streamed: List[int] = []  # every token delivered to the client
        self._stream_closed = False  # a done=True token was delivered (EOS/length)
        self._first_token_t: Optional[float] = None  # true TTFT anchor across rebuilds
        self._retry_prefix: List[int] = []  # tokens emitted before the last rebuild
        self._prompt_ids: Optional[List[int]] = None
        self._sampling = None
        # prompt tokens the dying engine had already prefilled when this
        # handle was stashed (goodput: a zero-streamed requeue's re-prefill
        # of those positions is rework, not useful — captured at triage)
        self._prefilled_hint = 0

    # ------------------------------------------------------------- futures
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the request finishes; returns the engine ``Request``."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.req_id} not finished within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._request

    @property
    def output_ids(self) -> List[int]:
        req = self.result()
        return list(req.output_ids)

    @property
    def finish_reason(self) -> Optional[str]:
        return self._request.finish_reason if self._request is not None else None

    # ------------------------------------------------------------- streaming
    def tokens(self, timeout: Optional[float] = None):
        """Yield token ids in generation order until the stream closes.

        ``timeout`` bounds the wait for EACH token (None = wait forever)."""
        while True:
            item = self._token_q.get(timeout=timeout)
            if item is _END:
                return
            tok, done = item
            yield tok
            if done:
                # drain the sentinel the resolver pushes after the last token
                try:
                    self._token_q.get_nowait()
                except queue.Empty:
                    pass
                return

    # ------------------------------------------------------------- loop-side
    def _on_token(self, tok: int, done: bool):
        if self._first_token_t is None:
            self._first_token_t = time.time()
        self._streamed.append(tok)
        if done:
            self._stream_closed = True
        self._token_q.put((tok, done))

    def add_done_callback(self, fn):
        """Run ``fn(handle)`` when the request resolves (immediately if done)."""
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, request, error: Optional[BaseException] = None):
        with self._cb_lock:
            if self._done.is_set():
                return
            self._request = request
            self._error = error
            self._token_q.put(_END)
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception as e:  # a bad callback must not kill the loop
                logger.warning(f"request done-callback failed: {e!r}")


class ServingMetrics:
    """Registers the serving metric catalog against one engine.

    Engine-state gauges are pull-mode (sampled at scrape); request-lifecycle
    series are pushed by the loop. Names are stable API — the README catalog
    and ``tools/bench_serve.py`` consume them."""

    def __init__(self, engine, registry: Optional[MetricsRegistry] = None):
        self.registry = r = registry or REGISTRY
        self.requests = r.counter(
            "paddlenlp_serving_requests_total",
            "Finished requests by terminal state, serving priority class, "
            "and tenant",
            labelnames=("status", "priority", "tenant"))
        self.tokens = r.counter(
            "paddlenlp_serving_tokens_generated_total", "Generated tokens (all requests)")
        self.preemptions = r.counter(
            "paddlenlp_serving_preemptions_total", "KV-exhaustion preemptions (recompute requeues)")
        self.engine_restarts = r.counter(
            "paddlenlp_serving_engine_restarts_total",
            "Engine rebuilds after a step exception (supervisor recoveries)")
        self.request_retries = r.counter(
            "paddlenlp_serving_request_retries_total",
            "In-flight requests requeued across an engine rebuild")
        self.slot_quarantines = r.counter(
            "paddlenlp_serving_slot_quarantines_total",
            "Poisoned requests quarantined by slot-level partial recovery "
            "(KV released, handle failed, engine kept running)")
        self.shed = r.counter(
            "paddlenlp_serving_requests_shed_total",
            "Submissions rejected on arrival by overload controls, by reason "
            "(shed = brownout priority shed; deadline = queue-wait estimate "
            "already blew the request's deadline_ms; tenant_quota = the "
            "tenant's max_inflight admission quota was full), priority class, "
            "and tenant — the per-class view of the brownout ladder's shed "
            "order and the per-tenant view of isolation pushback",
            labelnames=("reason", "priority", "tenant"))
        self.brownout_level = r.gauge(
            "paddlenlp_serving_brownout_level",
            "Current overload-brownout ladder level (0 normal, 1 shed "
            "best-effort, 2 conserve, 3 clamp max_tokens)")
        self.latency_attribution = r.histogram(
            "paddlenlp_serving_latency_attribution_seconds",
            "Per-request e2e latency decomposed by phase (queue/"
            "admission_gate/promote_wait/prefill/chunk_stall/migration_wait/"
            "decode on replicas; hedge_race on the router) — phases sum to e2e",
            labelnames=("phase",))
        self.ttft = r.histogram(
            "paddlenlp_serving_ttft_seconds", "Time from arrival to first token")
        self.queue_wait = r.histogram(
            "paddlenlp_serving_queue_wait_seconds", "Time from arrival to slot admission")
        self.inter_token = r.histogram(
            "paddlenlp_serving_inter_token_seconds", "Latency between consecutive tokens")
        self.e2e = r.histogram(
            "paddlenlp_serving_e2e_seconds", "Time from arrival to completion")
        self.queue_depth = r.gauge(
            "paddlenlp_serving_queue_depth", "Requests waiting for a slot")
        self.running = r.gauge(
            "paddlenlp_serving_running_slots", "Requests actively decoding")
        self.occupancy = r.gauge(
            "paddlenlp_serving_slot_occupancy", "running / max_batch_size")
        self.kv_free = r.gauge(
            "paddlenlp_serving_kv_free_blocks", "Free KV-cache blocks")
        self.kv_util = r.gauge(
            "paddlenlp_serving_kv_utilization", "1 - free/total KV blocks")
        self.spec_accept = r.gauge(
            "paddlenlp_serving_spec_acceptance_rate", "Accepted/drafted speculative tokens")
        self.prefix_hits = r.counter(
            "paddlenlp_serving_prefix_cache_hits_total",
            "Admissions that reused >=1 cached KV block from the prefix cache")
        self.prefix_cached_tokens = r.counter(
            "paddlenlp_serving_prefix_cache_cached_tokens_total",
            "Prompt tokens whose prefill was skipped via cached KV blocks")
        self.prefix_evictions = r.counter(
            "paddlenlp_serving_prefix_cache_evictions_total",
            "Cached KV blocks evicted under allocation pressure")
        self.kv_cached = r.gauge(
            "paddlenlp_serving_kv_cached_blocks",
            "KV blocks registered in the prefix-cache index")
        self.prefill_chunks = r.counter(
            "paddlenlp_serving_prefill_chunks_total",
            "Prompt chunks processed by ragged mixed prefill/decode steps")
        self.prefill_chunk_tokens = r.histogram(
            "paddlenlp_serving_prefill_chunk_tokens",
            "Prompt tokens fed per prefill chunk",
            buckets=(16, 32, 64, 128, 256, 512, 1024, 2048, 4096))
        self.decode_stall = r.histogram(
            "paddlenlp_serving_decode_stall_seconds",
            "Per-step decode gap attributable to concurrent prefill-chunk work "
            "(duration of mixed steps that carried both chunks and decodes)")
        self.stage_kv_util = r.gauge(
            "paddlenlp_serving_stage_kv_utilization",
            "Per-stage share of KV blocks held (disaggregated backends: TTFT "
            "pressure lives on the prefill stage, inter-token on decode)",
            labelnames=("stage",))
        self.stage_queue_depth = r.gauge(
            "paddlenlp_serving_stage_queue_depth",
            "Per-stage queue depth of the disaggregated backend (prefill: "
            "waiting + mid-prefill requests; decode: migrated-pending)",
            labelnames=("stage",))
        self.kv_migrations = r.counter(
            "paddlenlp_serving_kv_migrations_total",
            "Sequences whose KV blocks migrated prefill->decode (disaggregated backend)")
        self.kv_migrated_blocks = r.counter(
            "paddlenlp_serving_kv_migrated_blocks_total",
            "KV blocks copied prefill->decode across stage pools")
        self.kv_migrated_bytes = r.counter(
            "paddlenlp_serving_kv_migrated_bytes_total",
            "Bytes of KV copied prefill->decode (the migration-bandwidth series)")
        self.kv_migration_inflight = r.gauge(
            "paddlenlp_serving_kv_migration_inflight",
            "Prefill->decode block migrations currently in flight")
        # hierarchical KV: the host spill tier under the prefix cache
        self.kv_host_blocks = r.gauge(
            "paddlenlp_serving_kv_host_blocks",
            "Prefix-cache KV blocks currently resident in the host spill tier")
        self.kv_host_spills = r.counter(
            "paddlenlp_serving_kv_host_spills_total",
            "LRU-evicted prefix-cache blocks demoted device->host (batched D2H)")
        self.kv_host_promotes = r.counter(
            "paddlenlp_serving_kv_host_promotes_total",
            "Host-tier blocks promoted host->device ahead of a prefix-matched "
            "request's prefill")
        self.kv_host_promote_bytes = r.counter(
            "paddlenlp_serving_kv_host_promote_bytes_total",
            "Bytes of KV copied host->device by promotions (the promotion-"
            "bandwidth series)")
        self.mesh_devices = r.gauge(
            "paddlenlp_serving_mesh_devices",
            "Devices this replica's engine backend spans (1 = single-chip)")
        self.mesh_axis_size = r.gauge(
            "paddlenlp_serving_mesh_axis_size",
            "Device-mesh axis degree of the sharded serving backend, per named axis",
            labelnames=("axis",))
        # ---- goodput ledger (observability/goodput.py): per-step device-
        # efficiency accounting with the exact conservation invariant
        # fed == useful + padding + spec_rejected + rework
        self.fed_tokens = r.counter(
            "paddlenlp_serving_fed_tokens_total",
            "Token positions the device step programs processed (padded "
            "launch geometry, the goodput denominator)")
        self.useful_tokens = r.counter(
            "paddlenlp_serving_useful_tokens_total",
            "Fed positions that built new KV or emitted a kept token "
            "(the goodput numerator)")
        self.wasted_tokens = r.counter(
            "paddlenlp_serving_wasted_tokens_total",
            "Non-useful fed positions by waste kind (padding = bucket pads + "
            "dead rows + idle decode slots; spec_rejected = drafted-rejected "
            "speculative positions; rework = re-fed positions after "
            "preemption/requeue, COW tails, migration re-seeds)",
            labelnames=("kind",))
        self.goodput_ratio = r.gauge(
            "paddlenlp_serving_goodput_ratio",
            "Lifetime useful/fed token ratio of the engine's device steps")
        self.serving_mfu = r.gauge(
            "paddlenlp_serving_mfu",
            "Estimated model-FLOPs utilization of the serving engine "
            "(useful tokens * flops-per-token / wall / device peak; NaN off the GPU)")
        self.step_gap = r.histogram(
            "paddlenlp_serving_step_gap_seconds",
            "Host gap between consecutive busy engine steps (loop overhead: "
            "command drain, deadlines, metrics) — the host-bound half of "
            "step-time anatomy",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0))
        self.compiles = r.counter(
            "paddlenlp_serving_compiles_total",
            "Backend compilations attributed to a serving step program: "
            "always 0 here, eager PyTorch compiles nothing (the family is kept "
            "so dashboards and scrapers read the same catalog)",
            labelnames=("program",))
        self.compile_seconds = r.counter(
            "paddlenlp_serving_compile_seconds_total",
            "Seconds spent compiling per serving step program: always 0 here, "
            "eager PyTorch compiles nothing",
            labelnames=("program",))
        self.shape_buckets = r.gauge(
            "paddlenlp_serving_jit_shape_buckets",
            "Distinct launch geometries seen by the engine (live "
            "shape-bucket cardinality — growth without bound is a retrace storm)")
        self.kv_fragmentation = r.gauge(
            "paddlenlp_serving_kv_fragmentation",
            "Internal fragmentation of allocated KV blocks "
            "(1 - held tokens / (held blocks * block_size))")
        # spec-decode acceptance as first-class counters (the rate gauge's
        # inputs, and the ledger's spec_rejected bucket = drafted - accepted)
        self.spec_drafted = r.counter(
            "paddlenlp_serving_spec_drafted_tokens_total",
            "Speculative tokens proposed (n-gram or draft-model) for verification")
        self.spec_accepted = r.counter(
            "paddlenlp_serving_spec_accepted_tokens_total",
            "Speculative tokens accepted by the verify forward")
        # billing-grade usage: token counters labeled by who pays for them
        # (UsageMeter increments these once per finished request)
        self.usage_tokens = r.counter(
            "paddlenlp_serving_usage_tokens_total",
            "Metered usage tokens booked per finished request, by tenant, "
            "adapter (\"base\" = no LoRA), and kind "
            "(prompt | cached = prefix-cache credit | completion)",
            labelnames=("tenant", "adapter", "kind"))
        self.usage_records = r.counter(
            "paddlenlp_serving_usage_records_total",
            "Usage records booked (exactly one per finished request id)",
            labelnames=("tenant",))
        # info-style gauge (value is always 1 on the live series): the base-
        # weight version this replica serves — the router's federated scrape
        # makes a mixed-version fleet visible as multiple {version} series
        self.weights_info = r.gauge(
            "paddlenlp_serving_weights_info",
            "Base-weight version this replica currently serves (1 = active; "
            "a completed swap removes the superseded version's series)",
            labelnames=("version",))
        self.rebind(engine)

    def rebind(self, engine):
        """Point the pull-mode gauges at ``engine`` — the supervisor swaps the
        engine on rebuild, and gauges bound to the dead instance would scrape
        a ghost."""
        mgr = engine.mgr
        self.queue_depth.set_function(lambda: len(engine.waiting))
        self.running.set_function(
            lambda: sum(1 for s in engine.slots if s is not None))
        self.occupancy.set_function(
            lambda: sum(1 for s in engine.slots if s is not None) / max(engine.max_batch_size, 1))
        self.kv_free.set_function(lambda: mgr.num_free)
        self.kv_util.set_function(
            lambda: 1.0 - mgr.num_free / max(mgr.total_usable_blocks, 1))
        self.spec_accept.set_function(
            lambda: engine.spec_stats["accepted"] / max(engine.spec_stats["drafted"], 1))
        self.kv_cached.set_function(lambda: getattr(mgr, "num_cached_blocks", 0))
        # goodput pull gauges ride the engine's ledger (stand-in engines
        # without one read as idle: ratio 1.0, NaN MFU, zero cardinality)
        ledger = getattr(engine, "ledger", None)
        self.goodput_ratio.set_function(
            lambda: ledger.ratio() if ledger is not None else 1.0)
        self.serving_mfu.set_function(
            lambda: ledger.mfu() if ledger is not None else float("nan"))
        self.shape_buckets.set_function(
            lambda: len(ledger.shape_buckets) if ledger is not None else 0)
        self.kv_fragmentation.set_function(
            lambda: engine.kv_fragmentation()
            if hasattr(engine, "kv_fragmentation") else 0.0)
        # mesh placement is static per engine: stamped once per (re)bind, not
        # pulled per scrape — a rebuilt engine may come up on a new layout, so
        # axes the new engine doesn't report drop back to degree 1 (a label
        # series, once exposed, must not keep reporting the dead layout)
        backend = getattr(engine, "backend", None)
        desc = backend.describe() if backend is not None else {}
        self.mesh_devices.set(desc.get("devices", 1))
        mesh_axes = desc.get("mesh") or {}
        for axis in getattr(self, "_mesh_axes_stamped", set()) - set(mesh_axes):
            self.mesh_axis_size.set(1, axis=axis)
        for axis, size in mesh_axes.items():
            self.mesh_axis_size.set(size, axis=axis)
        self._mesh_axes_stamped = set(mesh_axes)
        # prefix-cache counters are deltas off the engine's monotone totals;
        # a rebuilt engine restarts its totals at 0, so rebaseline here
        self._pc_last = {
            "hits": getattr(mgr, "cache_hits", 0),
            "cached_tokens": getattr(mgr, "cached_tokens_total", 0),
            "evictions": getattr(mgr, "evictions", 0),
        }
        # host-tier residency is a pull gauge off the tier itself; the spill/
        # promote counters are deltas off its monotone stats, rebaselined here
        # (engine reset keeps the tier instance, so totals usually carry over)
        tier = getattr(engine, "_host_tier", None)
        self.kv_host_blocks.set_function(
            lambda: tier.num_blocks if tier is not None else 0)
        self._host_last = dict(tier.stats) if tier is not None else \
            {"spills": 0, "promoted_blocks": 0, "promote_bytes": 0}
        self._engine = engine
        self._chunk_last = dict(getattr(engine, "chunk_stats", {"chunks": 0}))
        # migration counters are deltas off the backend's monotone totals; a
        # rebuilt engine's backend restarts at 0, so rebaseline like the rest
        self._mig_last = dict(getattr(backend, "migration_stats", None)
                              or {"migrations": 0, "blocks": 0, "bytes": 0})
        # chunked-prefill histograms consume the engine's (seq, value) event
        # rings; start past whatever the (possibly reset-in-place) engine
        # already recorded so a rebuild never re-observes old events
        self._chunk_seq_seen = max(
            [s for s, _ in getattr(engine, "recent_chunk_sizes", ())]
            + [s for s, _ in getattr(engine, "recent_decode_stalls", ())]
            + [0])
        # goodput counters are deltas off the ledger's monotone totals; same
        # rebaseline-on-rebind contract as the prefix-cache/migration deltas
        self._gp_last = dict(ledger.totals) if ledger is not None else {}
        # eager PyTorch compiles nothing: the port's ledger has no compile
        # maps, so the compile families stay registered at zero
        self._compile_last = {}
        self._compile_s_last = {}
        self._spec_last = dict(getattr(engine, "spec_stats", None)
                               or {"drafted": 0, "accepted": 0})
        self._step_time_seen = max(
            [s for s, *_ in getattr(engine, "recent_step_times", ())] + [0])

    def on_finished(self, req):
        status = req.finish_reason or ("abort" if req.aborted else "unknown")
        self.requests.inc(status=status,
                          priority=getattr(req, "priority", "interactive"),
                          tenant=getattr(req, "tenant", DEFAULT_TENANT))
        self.tokens.inc(len(req.output_ids))
        if req.ttft is not None:
            self.ttft.observe(req.ttft)
        if req.queue_wait is not None:
            self.queue_wait.observe(req.queue_wait)
        if req.finish_t is not None:
            self.e2e.observe(req.finish_t - req.arrival_t)

    def on_step(self, stats: Dict, preempt_delta: int):
        if preempt_delta > 0:
            self.preemptions.inc(preempt_delta)
        pc = stats.get("prefix_cache")
        if pc:
            for key, counter in (("hits", self.prefix_hits),
                                 ("cached_tokens", self.prefix_cached_tokens),
                                 ("evictions", self.prefix_evictions)):
                delta = pc.get(key, 0) - self._pc_last[key]
                if delta > 0:
                    counter.inc(delta)
                self._pc_last[key] = pc.get(key, 0)
            host = pc.get("host")
            if host and host.get("enabled"):
                for key, counter in (("spills", self.kv_host_spills),
                                     ("promoted_blocks", self.kv_host_promotes),
                                     ("promote_bytes", self.kv_host_promote_bytes)):
                    delta = host.get(key, 0) - self._host_last.get(key, 0)
                    if delta > 0:
                        counter.inc(delta)
                    self._host_last[key] = host.get(key, 0)
        cp = stats.get("chunked_prefill")
        if cp:
            delta = cp.get("chunks", 0) - self._chunk_last.get("chunks", 0)
            if delta > 0:
                self.prefill_chunks.inc(delta)
            self._chunk_last["chunks"] = cp.get("chunks", 0)
            # histogram observations come from the engine's bounded event rings
            # (on_step runs on the loop thread, the only writer — no race)
            seen = self._chunk_seq_seen
            for seq, n in getattr(self._engine, "recent_chunk_sizes", ()):
                if seq > seen:
                    self.prefill_chunk_tokens.observe(n)
                    self._chunk_seq_seen = max(self._chunk_seq_seen, seq)
            for seq, dur in getattr(self._engine, "recent_decode_stalls", ()):
                if seq > seen:
                    self.decode_stall.observe(dur)
                    self._chunk_seq_seen = max(self._chunk_seq_seen, seq)
        gp = stats.get("goodput")
        if gp:
            totals = gp.get("totals", {})
            delta_fed = totals.get("fed", 0) - self._gp_last.get("fed", 0)
            if delta_fed > 0:
                self.fed_tokens.inc(delta_fed)
            delta_useful = totals.get("useful", 0) - self._gp_last.get("useful", 0)
            if delta_useful > 0:
                self.useful_tokens.inc(delta_useful)
            for kind in WASTE_KINDS:
                delta = totals.get(kind, 0) - self._gp_last.get(kind, 0)
                if delta > 0:
                    self.wasted_tokens.inc(delta, kind=kind)
            self._gp_last = dict(totals)
            for program, n in gp.get("compiles", {}).items():
                delta = n - self._compile_last.get(program, 0)
                if delta > 0:
                    self.compiles.inc(delta, program=program)
                self._compile_last[program] = n
            for program, secs in gp.get("compile_seconds", {}).items():
                delta = secs - self._compile_s_last.get(program, 0.0)
                if delta > 0:
                    self.compile_seconds.inc(delta, program=program)
                self._compile_s_last[program] = secs
            # step-gap observations from the engine's bounded event ring
            # (loop thread, the only writer — the chunk-ring contract); gaps
            # marked unmeasured (< 0: first/post-idle steps) are skipped
            seen = self._step_time_seen
            for seq, gap_s, _dev, _host in getattr(self._engine,
                                                   "recent_step_times", ()):
                if seq > seen:
                    if gap_s >= 0:
                        self.step_gap.observe(gap_s)
                    self._step_time_seen = max(self._step_time_seen, seq)
        sp = stats.get("spec_stats")
        if sp:
            for key, counter in (("drafted", self.spec_drafted),
                                 ("accepted", self.spec_accepted)):
                delta = sp.get(key, 0) - self._spec_last.get(key, 0)
                if delta > 0:
                    counter.inc(delta)
                self._spec_last[key] = sp.get(key, 0)
        dg = stats.get("disagg")
        if dg:
            for stage in ("prefill", "decode"):
                st = dg.get(f"{stage}_stage", {})
                self.stage_kv_util.set(st.get("kv_utilization", 0.0), stage=stage)
                self.stage_queue_depth.set(st.get("queue_depth", 0), stage=stage)
            self.kv_migration_inflight.set(dg.get("migrations_inflight", 0))
            mig = dg.get("migrations", {})
            for key, counter in (("migrations", self.kv_migrations),
                                 ("blocks", self.kv_migrated_blocks),
                                 ("bytes", self.kv_migrated_bytes)):
                delta = mig.get(key, 0) - self._mig_last.get(key, 0)
                if delta > 0:
                    counter.inc(delta)
                self._mig_last[key] = mig.get(key, 0)


class EngineLoop:
    """Owns the engine on one thread; everything else talks through queues."""

    def __init__(self, engine, metrics: Optional[ServingMetrics] = None,
                 registry: Optional[MetricsRegistry] = None, idle_wait_s: float = 0.05,
                 engine_factory: Optional[Callable[[], object]] = None,
                 policy: Optional[SupervisorPolicy] = None,
                 postmortem: Optional[PostmortemDumper] = None,
                 usage: Optional[UsageMeter] = None):
        self.engine = engine
        self.metrics = metrics or ServingMetrics(engine, registry)
        self.idle_wait_s = idle_wait_s
        self.engine_factory = engine_factory
        self.policy = policy or SupervisorPolicy()
        # billing-grade usage: one record per finished request, booked at
        # resolution time (every finish path funnels through _trace_finished
        # except shutdown cleanup, which books directly). PDNLP_TPU_USAGE_DIR
        # arms the durable JSONL ledger.
        self.usage = usage if usage is not None \
            else UsageMeter.from_env(metrics=self.metrics)
        # incident black box: supervisor degrades and slot quarantines
        # auto-dump a bundle (events + spans + health + metrics + config) to
        # PDNLP_TPU_POSTMORTEM_DIR; POST /debug/postmortem forces one
        self.postmortem = postmortem or PostmortemDumper(
            registry=self.metrics.registry, health_fn=self._postmortem_health,
            config_fn=self._postmortem_config)
        self._cmds: "queue.Queue" = queue.Queue()
        self._wake = threading.Event()
        self._handles: Dict[int, RequestHandle] = {}
        self._requeue: List[RequestHandle] = []  # stashed across a rebuild
        self._last_token_t: Dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._started = False
        self._state = "stopped"  # stopped | running | degraded
        self._phase = "init"  # last loop phase (join-failure diagnostics)
        self._consecutive_failures = 0
        self._last_failure_t = 0.0
        # slot-level quarantine accounting (loop-thread only, like the above):
        # the streak escalates to a full rebuild at max_slot_quarantines;
        # slot_quarantines is the monotone total /health reports
        self._quarantine_streak = 0
        self._last_quarantine_t = 0.0
        self.slot_quarantines = 0
        self._retry_after_hint = self.policy.backoff_base_s
        self._trace_seq = itertools.count()
        # live queue-wait estimator: per-backlog-slot queue+gate seconds of
        # recently finished requests (latency attribution), appended on the loop
        # thread, read (sorted) by HTTP threads computing Retry-After hints —
        # iterating a deque concurrently with an append raises RuntimeError,
        # so BOTH sides take the lock (appends are per-finished-request, reads
        # per-rejection: cold path either way). Scaled by the CURRENT backlog
        # at estimate time, the p50 becomes the hint that tracks queue depth.
        self._qw_lock = threading.Lock()
        self._queue_wait_samples: deque = deque(maxlen=64)  # guarded-by: _qw_lock
        # samples only refresh when admitted requests FINISH — if overload
        # leaves a high estimate and then everything is shed/deadline-rejected
        # on arrival, nothing ever refreshes it and the rejection latches on
        # an idle replica. Stale samples (no finish for this long) are
        # dropped, falling back to the cold-start default.
        self.queue_wait_sample_ttl_s = 60.0
        self._qw_fresh_t = 0.0  # guarded-by: _qw_lock — last sample append
        self._default_queue_wait_s = 0.05
        # /debug/requests tail: finished-request summaries (appended only on
        # the loop thread; deque ops are atomic so HTTP readers need no lock)
        self.recent_finished: deque = deque(maxlen=64)
        # live weight-swap state: the version string this replica serves
        # (reported on /health; the rollout orchestrator's convergence check),
        # the swap currently quiescing, and submissions held while it does.
        # All loop-thread-confined except weights_version, which HTTP threads
        # read as a single-slot value (momentarily stale reads are fine).
        self.weights_version = "v0"
        self._pending_swap: Optional[_WeightSwap] = None
        self._held_cmds: List[tuple] = []
        self.metrics.weights_info.set(1.0, version=self.weights_version)
        # repr of the CUDA error that poisoned the device context (None while
        # the device is healthy); once set the loop stays DEGRADED
        self.device_error: Optional[str] = None

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._started:
            return self
        self._started = True
        self._stop = False
        self._state = "running"
        self._thread = threading.Thread(target=self._run, name="engine-loop", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._started and not self._stop

    @property
    def state(self) -> str:
        """``running`` | ``degraded`` | ``stopped``."""
        return self._state

    @property
    def degraded(self) -> bool:
        return self._state == "degraded"

    def retry_after_hint(self) -> float:
        """Suggested client backoff (seconds) while degraded — the current
        rebuild backoff, so Retry-After tracks actual recovery cadence."""
        return max(self._retry_after_hint, 0.1)

    def stop(self, drain: bool = True, timeout: Optional[float] = None,
             join_timeout_s: float = 30.0) -> bool:
        """Stop the loop. ``drain=True`` finishes in-flight work first
        (bounded by ``timeout``); leftovers and ``drain=False`` abort.

        Returns True once the loop thread has actually exited. A thread that
        refuses to join within ``join_timeout_s`` (e.g. wedged inside a device
        call) is reported — with its last-known phase — and ``False`` is
        returned so the caller knows the engine may still be mutating."""
        if not self._started:
            return True
        if drain:
            deadline = None if timeout is None else time.time() + timeout
            while self.pending_count() > 0:
                if self.degraded:
                    # a degraded engine may never come back (factory failing
                    # forever) — draining would spin until the heat death of
                    # the process; abort the stashed work instead
                    logger.warning(
                        f"engine degraded during drain; aborting {self.pending_count()} requests")
                    break
                if deadline is not None and time.time() >= deadline:
                    logger.warning(f"engine loop drain timed out; aborting {self.pending_count()} requests")
                    break
                time.sleep(0.01)
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            if self._thread.is_alive():
                logger.error(
                    f"engine loop thread failed to stop within {join_timeout_s}s "
                    f"(last phase: {self._phase!r}); thread left detached — "
                    "engine state must be treated as poisoned")
                return False
        self._started = False
        self._state = "stopped"
        try:
            # seal the open usage segment: sealed segments are what the
            # offline aggregator (tools/usage_report.py) merges
            self.usage.close()
        except Exception as e:  # noqa: BLE001
            logger.warning(f"usage ledger seal on stop failed: {e!r}")
        return True

    def pending_count(self) -> int:
        return (len(self._handles) + len(self._requeue) + len(self._held_cmds)
                + self._cmds.qsize())

    # ------------------------------------------------------------- client api
    def submit(self, prompt_ids, sampling=None, deadline_s: Optional[float] = None,
               max_retries: Optional[int] = None,
               trace: Optional[str] = None,
               priority: str = "interactive",
               tenant: str = DEFAULT_TENANT,
               adapter_id: Optional[str] = None) -> RequestHandle:
        """Thread-safe request submission; returns immediately with a handle.

        ``max_retries`` overrides the supervisor policy's per-request requeue
        budget (0 = never requeue across an engine rebuild: fail fast with
        ``finish_reason="engine_error"``). ``trace`` adopts an inbound trace id
        (the router's ``rtr-N`` from the traceparent header) instead of minting
        a local ``req-N`` — the key to cross-tier trace stitching.
        ``priority`` orders the engine's waiting queue (interactive ahead of
        batch ahead of best_effort) and selects the brownout shed class.
        ``tenant`` keys per-tenant quotas and metric labels; ``adapter_id``
        selects the LoRA adapter (registry-resident or hot-loadable) the
        engine decodes this request with — None runs the shared base model."""
        if not self.running:
            raise RuntimeError("engine loop is not running")
        deadline_t = None if deadline_s is None else time.time() + deadline_s
        handle = RequestHandle(prompt_len=len(prompt_ids), deadline_t=deadline_t,
                               trace=trace if trace is not None else f"req-{next(self._trace_seq)}",
                               max_retries=max_retries, priority=priority,
                               tenant=tenant, adapter_id=adapter_id)
        handle._prompt_ids = [int(t) for t in prompt_ids]
        handle._sampling = sampling
        self._cmds.put(("submit", handle, prompt_ids, sampling))
        self._wake.set()
        return handle

    def cancel(self, handle: RequestHandle):
        """Request cancellation; resolves the handle once the loop aborts it."""
        handle._cancelled = True
        self._cmds.put(("abort", handle))
        self._wake.set()

    def request_weight_swap(self, new_params, version: str, *,
                            mode: str = "finish_old",
                            canary_prompt_ids=None, canary_sampling=None,
                            canary_digest: Optional[str] = None,
                            timeout_s: Optional[float] = 120.0) -> Dict:
        """Thread-safe live weight swap; blocks until the loop installed the
        new params (canary passed) or rolled back to the retained old ones.

        The caller (the /admin/weights handler) must have fully validated and
        loaded ``new_params`` already — by the time this is called the only
        remaining failure modes are the swap itself and the canary, both of
        which roll back. Returns the loop's result dict (``ok``,
        ``weights_version``, ``canary_digest``, ``resumed``,
        ``token_identity``, ``wall_s`` — plus ``reason``/``error`` on a
        rollback); raises TimeoutError when the quiesce outlives
        ``timeout_s`` (the swap stays queued and will still run)."""
        if not self.running:
            raise RuntimeError("engine loop is not running")
        if mode not in ("finish_old", "pause_resume"):
            raise ValueError(f"unknown swap mode {mode!r} "
                             "(want finish_old | pause_resume)")
        swap = _WeightSwap(new_params, version, mode=mode,
                           canary_prompt_ids=canary_prompt_ids,
                           canary_sampling=canary_sampling,
                           canary_digest=canary_digest)
        self._cmds.put(("weights", swap))
        self._wake.set()
        return swap.wait(timeout_s)

    def run_on_loop(self, fn: Callable, timeout_s: Optional[float] = 60.0):
        """Run ``fn()`` on the loop thread between two engine steps and return
        its result (its exception re-raised here). Thread-safe. For state that
        belongs to the thread launching the engine's work, such as the device
        profiler. Raises RuntimeError when the loop is not running or has lost
        its device, TimeoutError when the loop did not take the call within
        ``timeout_s`` (the call is then dropped)."""
        if not self.running:
            raise RuntimeError("engine loop is not running")
        call = _LoopCall(fn)
        self._cmds.put(("call", call))
        self._wake.set()
        return call.wait(timeout_s)

    # ------------------------------------------------------------- loop body
    def _run(self):
        # grad mode and the current CUDA device are thread-local: this thread
        # sets both itself instead of inheriting the starter's
        with torch.inference_mode():
            self._bind_device()
            try:
                while not self._stop:
                    try:
                        self._run_iteration()
                    except Exception as e:
                        # engine-step (or command-processing) failure: supervise —
                        # degrade, triage, rebuild, resume. Raises only when the
                        # rebuild budget is exhausted.
                        self._supervise(e)
            except BaseException as e:  # loop death must not strand waiters
                logger.error(f"engine loop crashed: {e!r}")
                self._resolve_all_with_error(e)
                raise
            finally:
                self._state = "stopped"
                self._shutdown_cleanup()

    def _bind_device(self):
        """Make the engine's CUDA device current on the loop thread."""
        device = getattr(getattr(self.engine, "model", None), "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)

    def _run_iteration(self):
        if self.device_error is not None:
            # poisoned device: refuse whatever still reaches the loop
            self._phase = "device_lost"
            self._refuse_cmds()
            self._wake.wait(timeout=self.idle_wait_s)
            self._wake.clear()
            return
        self._phase = "drain_cmds"
        self._drain_cmds()
        self._phase = "deadlines"
        self._enforce_deadlines()
        if self._pending_swap is not None:
            swap = self._pending_swap
            # finish_old waits for the engine to run dry at a step boundary
            # (held submissions guarantee it eventually does; deadlines bound
            # wedged streams); pause_resume stashes and swaps immediately
            if swap.mode == "pause_resume" or (
                    not self._handles and not self._requeue):
                self._phase = "weight_swap"
                self._execute_swap(swap)
        if self.engine.has_work():
            self._phase = "step"
            stats_before = self.engine.num_preemptions
            for req in self.engine.step():
                self._finish(req)
            self.metrics.on_step(
                self.engine.stats(), self.engine.num_preemptions - stats_before)
        else:
            self._phase = "idle"
            self._wake.wait(timeout=self.idle_wait_s)
            self._wake.clear()

    # ------------------------------------------------------------- supervisor
    def _supervise(self, exc: Exception):
        """Recover from a step failure: slot-level quarantine when the engine
        attributed it to one poisoned request, otherwise the full DEGRADED
        transition (triage in-flight work, rebuild, requeue, resume)."""
        if is_device_fault(exc):
            self._device_lost(exc)
            return
        if self._try_quarantine(exc):
            return
        now = time.time()
        if now - self._last_failure_t > self.policy.failure_reset_s:
            self._consecutive_failures = 0
        self._consecutive_failures += 1
        self._last_failure_t = now
        self._state = "degraded"
        degraded_t0 = now
        logger.error(
            f"engine step failed (consecutive failure {self._consecutive_failures}): {exc!r}; "
            "entering DEGRADED state")
        RECORDER.record("supervisor.degraded", error=repr(exc)[:200],
                        consecutive=self._consecutive_failures,
                        inflight=len(self._handles))
        TRACER.instant("engine_failure", cat="engine_loop", error=repr(exc),
                       consecutive=self._consecutive_failures,
                       inflight=len(self._handles))
        n_failed = self._triage(exc)
        # black box: snapshot the incident AFTER triage so the bundle's
        # health/events already reflect the dispositions (rate-limited;
        # opt-in via PDNLP_TPU_POSTMORTEM_DIR)
        self.postmortem.dump("supervisor_degraded", detail={
            "error": repr(exc)[:500],
            "consecutive_failures": self._consecutive_failures,
            "failed": n_failed, "requeued": len(self._requeue)})

        attempt = 0
        while not self._stop:
            # exponent clamped: a persistent failure grows the counters without
            # bound, and 2**1000 would overflow float and kill the supervisor
            # that promises to retry forever
            backoff = min(
                self.policy.backoff_base_s
                * (2 ** min(self._consecutive_failures - 1 + attempt, 30)),
                self.policy.backoff_max_s)
            self._retry_after_hint = backoff
            self._phase = "degraded"
            self._wake.wait(timeout=backoff)
            self._wake.clear()
            if self._stop:
                return
            self._phase = "rebuild"
            try:
                _F_REBUILD.fire(attempt=attempt)
                engine = self.engine_factory() if self.engine_factory is not None \
                    else self._reset_engine()
            except Exception as rebuild_exc:
                attempt += 1
                logger.error(f"engine rebuild attempt {attempt} failed: {rebuild_exc!r}")
                if (self.policy.max_rebuild_attempts is not None
                        and attempt >= self.policy.max_rebuild_attempts):
                    for handle in self._requeue:
                        handle._resolve(None, error=rebuild_exc)
                    self._requeue = []
                    raise
                continue
            self.engine = engine
            self._bind_device()
            self.metrics.rebind(engine)
            self.metrics.engine_restarts.inc()
            n_requeued = self._resubmit_stashed()
            self._state = "running"
            RECORDER.record("supervisor.recovered", attempts=attempt + 1,
                            requeued=n_requeued, failed=n_failed)
            dur = time.time() - degraded_t0
            TRACER.add_span("engine_degraded", degraded_t0, dur, cat="engine_loop",
                            wall=True, error=repr(exc), requeued=n_requeued,
                            failed=n_failed, rebuild_attempts=attempt + 1)
            logger.warning(
                f"engine rebuilt after {dur:.2f}s degraded "
                f"(requeued {n_requeued}, failed {n_failed}, attempts {attempt + 1})")
            return

    def _device_lost(self, exc: Exception):
        """Triage for a CUDA error that poisoned the context: no rebuild (it
        would fail on the same context) and no requeue. Every in-flight
        request resolves now (``engine_error``, or the completion its client
        already saw), and the loop stays DEGRADED, so the scheduler answers
        503 until the process is replaced."""
        self.device_error = repr(exc)[:500]
        self._state = "degraded"
        self._retry_after_hint = self.policy.backoff_max_s
        logger.error(f"CUDA context poisoned by {exc!r}: failing in-flight requests; "
                     "the engine stays DEGRADED until the process is replaced")
        RECORDER.record("supervisor.degraded", error=repr(exc)[:200],
                        consecutive=self._consecutive_failures + 1,
                        inflight=len(self._handles), device_lost=True)
        TRACER.instant("engine_failure", cat="engine_loop", error=repr(exc),
                       device_lost=True, inflight=len(self._handles))
        failed = 0
        for handle in list(self._handles.values()) + list(self._requeue):
            if handle.done():
                continue
            streamed = list(handle._streamed)
            reason = self._closed_stream_reason(handle, streamed) \
                or ("abort" if handle._cancelled else "engine_error")
            self._resolve_failed(handle, streamed, finish_reason=reason)
            failed += 1
        self._handles.clear()
        self._requeue = []
        self._last_token_t.clear()
        self._refuse_cmds()
        self.postmortem.dump("device_lost", detail={"error": self.device_error, "failed": failed})

    def _refuse_cmds(self):
        """Resolve every queued command with the device error (submissions
        that raced the 503 gate, held submissions, a pending swap)."""
        err = RuntimeError(f"engine device lost: {self.device_error}")
        if self._pending_swap is not None:
            self._pending_swap.fail(err)
            self._pending_swap = None
        held, self._held_cmds = self._held_cmds, []
        for cmd in held:
            cmd[1]._resolve(None, error=err)
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return
            if cmd[0] == "submit":
                cmd[1]._resolve(None, error=err)
            elif cmd[0] in ("weights", "call"):
                cmd[1].fail(err)

    def _try_quarantine(self, exc: Exception) -> bool:
        """Slot-level partial recovery: when the engine attributed the step
        failure to ONE request (``exc.req_id``), release only that request's
        slot + KV blocks, resolve its handle, sweep up any requests the same
        step had already finished, and resume — the loop never leaves
        ``running``, unaffected streams never pause, and the scheduler's 503
        circuit breaker never trips. Returns True when fully handled; False
        escalates to the full degrade/rebuild path."""
        req_id = getattr(exc, "req_id", None)
        release = getattr(self.engine, "release_request", None)
        if req_id is None or release is None:
            return False
        t0 = time.time()
        if t0 - self._last_quarantine_t > self.policy.failure_reset_s:
            self._quarantine_streak = 0
        if self._quarantine_streak >= self.policy.max_slot_quarantines:
            logger.error(
                f"req {req_id}: poisoned, but {self._quarantine_streak} slots were "
                "already quarantined this window — escalating to a full rebuild")
            return False
        handle = self._handles.pop(req_id, None)
        if handle is None:
            return False
        self._phase = "slot_quarantine"
        try:
            _F_SLOT_REBUILD.fire(req_id=req_id)
            release(req_id)
            # the failed step may have committed device-side penalty-count
            # updates for tokens whose host emit never ran (they regenerate
            # from host state next step) — resync survivors' counts from
            # host truth so penalty-sampling neighbors don't double-count
            resync = getattr(self.engine, "resync_counts", None)
            if resync is not None:
                resync()
        except Exception as rebuild_exc:
            # the slot itself cannot be rebuilt: put the handle back so the
            # full path's triage owns its disposition
            self._handles[req_id] = handle
            logger.error(f"slot quarantine of req {req_id} failed: {rebuild_exc!r}; "
                         "escalating to full rebuild")
            return False
        self._quarantine_streak += 1
        self._last_quarantine_t = t0
        self.slot_quarantines += 1
        self.metrics.slot_quarantines.inc()
        self._last_token_t.pop(req_id, None)
        streamed = list(handle._streamed)
        reason = self._closed_stream_reason(handle, streamed) \
            or ("abort" if handle._cancelled else "engine_error")
        self._resolve_failed(handle, streamed, finish_reason=reason)
        # requests the failed step had already finished (done=True streamed,
        # engine-side state retired) lost only their resolution when step()
        # raised before returning them — resolve them as the completions
        # their clients already saw, exactly triage's closed-stream rule
        swept = 0
        for h in list(self._handles.values()):
            if h.done() or not h._stream_closed:
                continue
            release(h.req_id)  # no-op when the engine already retired it
            self._handles.pop(h.req_id, None)
            self._last_token_t.pop(h.req_id, None)
            s = list(h._streamed)
            self._resolve_failed(h, s, finish_reason=self._closed_stream_reason(h, s) or "stop")
            swept += 1
        RECORDER.record("supervisor.quarantine", req_id=req_id,
                        trace=handle.trace, streak=self._quarantine_streak,
                        swept=swept, error=repr(exc)[:200])
        TRACER.add_span("slot_quarantine", t0, time.time() - t0, cat="engine_loop",
                        wall=True, req_id=req_id, error=repr(exc),
                        streak=self._quarantine_streak, swept=swept)
        self.postmortem.dump("slot_quarantine", detail={
            "req_id": req_id, "trace": handle.trace,
            "error": repr(exc)[:500], "streak": self._quarantine_streak})
        logger.warning(
            f"req {req_id}: quarantined after per-request failure ({exc!r}); "
            f"slot rebuilt, engine kept running ({len(self._handles)} unaffected)")
        return True

    @staticmethod
    def _closed_stream_reason(handle: RequestHandle, streamed: List[int]) -> Optional[str]:
        """Terminal reason for a handle whose stream already delivered its
        done=True token (or full budget) — the crash ate only the finish
        bookkeeping. None when the stream is still open."""
        max_new = getattr(handle._sampling, "max_new_tokens", None)
        if max_new is not None and len(streamed) >= max_new:
            return "length"
        if handle._stream_closed:
            return "stop"
        return None

    def _triage(self, exc: Exception) -> int:
        """Split in-flight handles into the requeue stash and immediate
        ``engine_error`` resolutions, per the retry policy. Returns the number
        fast-cleared."""
        n_failed = 0
        for handle in list(self._handles.values()):
            if handle.done():
                continue
            limit = handle.max_retries if handle.max_retries is not None \
                else self.policy.max_retries
            streamed = list(handle._streamed)
            # a request whose stream already delivered its done=True token
            # (EOS or full budget) just needs its resolution — the crash ate
            # only the finish bookkeeping; requeueing it would generate PAST
            # the end of a completed sequence
            reason = self._closed_stream_reason(handle, streamed)
            if reason is not None:
                self._resolve_failed(handle, streamed, finish_reason=reason)
                continue
            # a cancel that raced the crash is still a cancel, not an engine
            # failure — resolve it as the abort the client asked for
            if handle._cancelled:
                self._resolve_failed(handle, streamed, finish_reason="abort")
                continue
            retryable = (
                handle.retries < limit
                # streamed tokens can only be folded into a retry prompt when
                # the sampling budget is adjustable alongside
                and (not streamed or handle._sampling is not None)
            )
            if retryable:
                handle.retries += 1
                handle._prefilled_hint = self._prefilled_len_of(handle.req_id)
                self.metrics.request_retries.inc()
                self._requeue.append(handle)
            else:
                n_failed += 1
                self._resolve_failed(handle, streamed)
        self._handles.clear()
        self._last_token_t.clear()
        return n_failed

    def _prefilled_len_of(self, req_id) -> int:
        """How many prompt tokens the (possibly poisoned) engine had already
        prefilled for ``req_id`` — read defensively at triage time so the
        requeue's goodput hint covers partial chunk walks too. 0 on any
        stand-in engine without the scheduler surface."""
        try:
            for r in list(self.engine.slots):
                if r is not None and r.req_id == req_id:
                    return int(getattr(r, "prefilled_len", 0))
        except Exception:
            pass
        return 0

    def _resolve_failed(self, handle: RequestHandle, streamed: List[int],
                        finish_reason: str = "engine_error"):
        req = _FailedRequest(handle.req_id, handle._prompt_ids or [], streamed,
                             handle.trace, handle.submitted_t,
                             finish_reason=finish_reason, tenant=handle.tenant,
                             adapter_id=handle.adapter_id)
        req.aborted = finish_reason == "abort"
        req.priority = handle.priority  # requests_total{priority} label
        if handle._first_token_t is not None:
            req.first_token_t = handle._first_token_t
            req.ttft = handle._first_token_t - req.arrival_t
            req.decode_time = req.finish_t - handle._first_token_t
        self.metrics.on_finished(req)
        self._trace_finished(req, handle)
        handle._resolve(req)

    def _resubmit_stashed(self) -> int:
        """Resubmit stashed handles into the rebuilt engine. Tokens already
        streamed become prompt suffix (recompute-requeue, exactly the
        preemption trick) with the remaining budget — positional sampling keys
        make the continuation identical for greedy/fixed-seed requests."""
        stashed, self._requeue = self._requeue, []
        n = 0
        for handle in stashed:
            if handle.done():  # cancelled while degraded
                continue
            streamed = list(handle._streamed)
            prompt = list(handle._prompt_ids or []) + streamed
            sampling = handle._sampling
            if streamed and sampling is not None:
                sampling = dataclasses.replace(
                    sampling, max_new_tokens=sampling.max_new_tokens - len(streamed))
            handle._retry_prefix = streamed
            stream_cb = self._make_stream_cb(handle)
            # goodput: a requeue with streamed tokens re-prefills a prompt the
            # dead engine had fully processed (all but the final sampled
            # token); a zero-streamed requeue may still have been mid-chunk-
            # walk — either way the re-fed span is requeue_refill rework,
            # never useful a second time
            rework_hwm = (len(prompt) - 1 if streamed
                          else min(handle._prefilled_hint, len(prompt)))
            try:
                handle.req_id = self._add_to_engine(handle, prompt, sampling,
                                                    stream_cb,
                                                    rework_hwm=rework_hwm)
            except Exception as e:
                # the rebuilt engine rejected the requeue: fail THIS request
                # rather than losing it (a poisoned engine will re-trip the
                # supervisor on the next step)
                logger.error(f"requeue of {handle.trace} failed: {e!r}")
                self._resolve_failed(handle, streamed)
                continue
            self._handles[handle.req_id] = handle
            n += 1
        return n

    def _reset_engine(self):
        """No factory: recover the existing engine in place via its
        ``reset()`` (drops all scheduler/allocator state)."""
        reset = getattr(self.engine, "reset", None)
        if reset is None:
            raise RuntimeError(
                "engine has no reset() and no engine_factory was provided; "
                "cannot recover from a step failure")
        reset()
        return self.engine

    def _resolve_all_with_error(self, e: BaseException):
        for h in list(self._handles.values()) + list(self._requeue):
            h._resolve(None, error=e)
        self._handles.clear()
        self._requeue = []
        if self._pending_swap is not None:
            self._pending_swap.fail(e)
            self._pending_swap = None
        for cmd in self._held_cmds:
            cmd[1]._resolve(None, error=e)
        self._held_cmds = []
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                break
            if cmd[0] == "submit":
                cmd[1]._resolve(None, error=e)
            elif cmd[0] in ("weights", "call"):
                cmd[1].fail(e)

    # ------------------------------------------------------------- commands
    def _drain_cmds(self):
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return
            kind, handle = cmd[0], cmd[1]
            if kind == "submit":
                _, _, prompt_ids, sampling = cmd
                if handle._cancelled:
                    handle._resolve(None)
                    continue
                if self._pending_swap is not None:
                    # a swap is quiescing: new work must not extend the drain
                    # (finish_old) or race the canary — hold it, re-inject
                    # after the swap settles (the handle's clock keeps
                    # running, so queue-wait metrics see the swap stall)
                    self._held_cmds.append(cmd)
                    continue
                handle.depth_at_submit = self._engine_backlog()
                stream_cb = self._make_stream_cb(handle)
                try:
                    handle.req_id = self._add_to_engine(handle, prompt_ids,
                                                        sampling, stream_cb)
                except UnknownAdapterError as e:
                    # a client error (bad adapter_id), not an engine failure:
                    # resolve the waiter without tripping the supervisor into
                    # a degrade/rebuild cycle
                    handle._resolve(None, error=e)
                    continue
                except BaseException as e:
                    # the command is consumed — resolve the waiter before the
                    # supervisor takes over, or the client blocks forever
                    handle._resolve(None, error=e)
                    raise
                self._handles[handle.req_id] = handle
            elif kind == "abort":
                self._abort_handle(handle)
            elif kind == "call":
                handle.run()
            elif kind == "weights":
                if self._pending_swap is not None:
                    handle.fail(RuntimeError(
                        "another weight swap is already in progress"))
                else:
                    self._pending_swap = handle

    # ------------------------------------------------------------- weight swap
    def _execute_swap(self, swap: _WeightSwap):
        """Perform one quiesced weight swap on the loop thread — all-or-
        nothing per replica: retain old params → ``sync_params`` (eager
        placement) → prefix-cache epoch bump → greedy canary → commit; ANY
        failure restores the retained old params and re-bumps the epoch, so
        the replica keeps serving the version it served before. Old params
        are released (last reference dropped) only after the canary passed."""
        t0 = time.time()
        RECORDER.record("swap.begin", version=swap.version, mode=swap.mode)
        if swap.mode == "pause_resume" and self._handles:
            # stash in-flight requests exactly like the supervisor's triage:
            # streamed tokens fold into the retry prompt and the request
            # resumes under whichever params the swap settles on — explicitly
            # NOT token-identical to an uninterrupted old-weights generation
            for handle in list(self._handles.values()):
                if handle.done():
                    continue
                handle._prefilled_hint = self._prefilled_len_of(handle.req_id)
                self.engine.abort(handle.req_id)
                self.metrics.request_retries.inc()
                self._requeue.append(handle)
            self._handles.clear()
            self._last_token_t.clear()
        engine = self.engine
        old_params = engine.model.params  # retained until canary pass
        digest = None
        try:
            _F_WEIGHT_SWAP.fire(version=swap.version)
            engine.sync_params(swap.new_params)
            engine.clear_prefix_cache()
            if swap.canary_prompt_ids:
                digest = self._run_canary(swap)
                if swap.canary_digest is not None and digest != swap.canary_digest:
                    raise _CanaryMismatch(
                        f"canary digest {digest[:16]}... != expected "
                        f"{swap.canary_digest[:16]}...")
        except Exception as e:
            reason = ("canary_mismatch" if isinstance(e, _CanaryMismatch)
                      else "swap_failed")
            try:
                # a canary that died mid-generate may have left engine-side
                # request state: reset drops it (no client work is resident)
                if engine.has_work() and callable(getattr(engine, "reset", None)):
                    engine.reset()
                engine.sync_params(old_params)
                engine.clear_prefix_cache()
            except Exception as rb:
                # rollback itself failing leaves the replica poisoned — the
                # next step exception sends it through the supervisor
                logger.error(f"weight-swap rollback failed: {rb!r}")
            RECORDER.record("swap.rollback", version=swap.version, reason=reason,
                            error=repr(e)[:200])
            self.postmortem.dump("weight_swap_rollback", detail={
                "version": swap.version, "reason": reason,
                "error": repr(e)[:500], "canary_digest": digest})
            logger.error(
                f"weight swap to {swap.version!r} rolled back ({reason}): {e!r}")
            result = {"ok": False, "reason": reason, "error": repr(e)[:500],
                      "rolled_back": True,
                      "weights_version": self.weights_version,
                      "canary_digest": digest,
                      "wall_s": round(time.time() - t0, 3)}
        else:
            old_version = self.weights_version
            self.weights_version = swap.version
            if old_version != swap.version:
                self.metrics.weights_info.remove_series(version=old_version)
            self.metrics.weights_info.set(1.0, version=swap.version)
            RECORDER.record("swap.done", version=swap.version,
                            resumed=len(self._requeue))
            logger.info(f"weights swapped: {old_version!r} -> {swap.version!r} "
                        f"in {time.time() - t0:.2f}s (canary {digest and digest[:12]})")
            result = {"ok": True, "weights_version": swap.version,
                      "canary_digest": digest,
                      "wall_s": round(time.time() - t0, 3)}
        finally:
            self._pending_swap = None
            held, self._held_cmds = self._held_cmds, []
            for cmd in held:
                self._cmds.put(cmd)
        # pause_resume: the stash resumes under whichever params won (the new
        # ones, or the rolled-back old ones) — resumed continuations are
        # never token-identity-guaranteed, and the result says so
        resumed = self._resubmit_stashed() if self._requeue else 0
        result["resumed"] = resumed
        result["token_identity"] = resumed == 0
        swap.finish(result)

    def _run_canary(self, swap: _WeightSwap) -> str:
        """Greedy canary self-check on the drained engine: generate the fixed
        probe and digest the output ids. Runs on the loop thread between
        steps, so it never interleaves with client work."""
        out = self.engine.generate([list(swap.canary_prompt_ids)],
                                   swap.canary_sampling)[0]
        return canary_digest(out)

    def _add_to_engine(self, handle: RequestHandle, prompt_ids, sampling,
                       stream_cb, rework_hwm: int = 0) -> int:
        """One engine submission. ``priority`` / ``rework_hwm`` / ``tenant`` /
        ``adapter_id`` are forwarded only when non-default so engine stand-ins
        (chaos-test stubs, older backends) with the narrower ``add_request``
        signature keep working."""
        kw = {}
        if handle.priority != "interactive":
            kw["priority"] = handle.priority
        if rework_hwm > 0:
            kw["rework_hwm"] = rework_hwm
        if handle.tenant != DEFAULT_TENANT:
            kw["tenant"] = handle.tenant
        if handle.adapter_id is not None:
            # never dropped on TypeError: silently serving an adapter request
            # from the base model would be a cross-tenant correctness bug
            kw["adapter_id"] = handle.adapter_id
        try:
            return self.engine.add_request(prompt_ids, sampling, stream_cb=stream_cb,
                                           trace=handle.trace, **kw)
        except TypeError:
            dropped = [k for k in ("rework_hwm", "tenant") if k in kw]
            if not dropped:
                raise
            # engine stand-in without the goodput/tenancy kwargs: those hints
            # are best-effort accounting, the resubmission is not
            for k in dropped:
                kw.pop(k)
            return self.engine.add_request(prompt_ids, sampling, stream_cb=stream_cb,
                                           trace=handle.trace, **kw)

    def _engine_backlog(self) -> int:
        """Requests ahead of a new arrival: engine waiting queue + running
        slots. Falls back to the handle count for engines without the standard
        scheduler surface (test stubs). Tolerates concurrent mutation — a
        slightly stale count only jitters the Retry-After hint."""
        try:
            running = sum(1 for s in list(self.engine.slots) if s is not None)
            return len(self.engine.waiting) + running
        except Exception:
            return len(self._handles)

    def queue_wait_estimate(self, backlog: Optional[int] = None) -> float:
        """Live estimate (seconds) of how long a newly arriving request would
        wait for a slot: the p50 of recent per-backlog-slot queue+gate waits
        (latency attribution) scaled by the CURRENT engine backlog — so 429/503
        ``Retry-After`` hints and deadline-aware admission track queue depth
        instead of quoting a constant. Callable from any thread."""
        if backlog is None:
            backlog = self._engine_backlog()
        with self._qw_lock:
            if self._queue_wait_samples and \
                    time.time() - self._qw_fresh_t > self.queue_wait_sample_ttl_s:
                self._queue_wait_samples.clear()
            samples = sorted(self._queue_wait_samples)
        per_slot = samples[len(samples) // 2] if samples else self._default_queue_wait_s
        return per_slot * (backlog + 1)

    def _make_stream_cb(self, handle: RequestHandle):
        def cb(tok: int, done: bool):
            now = time.time()
            last = self._last_token_t.get(handle.req_id)
            if last is not None:
                self.metrics.inter_token.observe(now - last)
            self._last_token_t[handle.req_id] = now
            handle._on_token(tok, done)
        return cb

    def _abort_handle(self, handle: RequestHandle):
        if handle.done():
            return
        if handle.req_id is None:
            # submit command not yet processed; the submit branch resolves it
            return
        req = self.engine.abort(handle.req_id)
        if req is not None:
            self._finish(req)

    def _enforce_deadlines(self):
        now = time.time()
        for handle in list(self._handles.values()):
            if handle.deadline_t is not None and now >= handle.deadline_t and not handle.done():
                logger.warning(f"req {handle.req_id}: deadline exceeded; aborting")
                handle.timed_out = True
                self._abort_handle(handle)

    def _finish(self, req):
        handle = self._handles.pop(req.req_id, None)
        if handle is not None and handle._retry_prefix:
            # a request that rode through >=1 engine rebuilds: its pre-crash
            # tokens were folded into the prompt — unfold so output_ids /
            # usage counts cover the FULL generation the client received, and
            # rebase the timing anchors so TTFT/e2e cover the pre-crash stint
            # and the degraded window (the SLO series must SEE the incident,
            # not report a fresh fast request)
            req.output_ids = list(handle._retry_prefix) + list(req.output_ids)
            req.prompt_ids = req.prompt_ids[: handle.prompt_len]
            req.arrival_t = handle.submitted_t
            if handle._first_token_t is not None:
                req.first_token_t = handle._first_token_t
        self.metrics.on_finished(req)
        self._last_token_t.pop(req.req_id, None)
        self._trace_finished(req, handle)
        if handle is not None:
            handle._resolve(req)

    def _trace_finished(self, req, handle: Optional[RequestHandle]):
        """Retrospective per-request phase spans (the engine's timing fields
        become a queue → prefill → decode timeline under the request's trace)
        plus a summary row for /debug/requests."""
        trace = handle.trace if handle is not None else getattr(req, "trace", None)
        phases = {}
        meta = dict(req_id=req.req_id, prompt_len=len(req.prompt_ids))
        if req.sched_t is not None:
            phases["queue"] = (req.arrival_t, req.sched_t)
        if req.sched_t is not None and req.first_token_t is not None:
            phases["prefill"] = (req.sched_t, req.first_token_t)
        if req.first_token_t is not None and req.finish_t is not None:
            phases["decode"] = (req.first_token_t, req.finish_t)
        for name, (t0, t1) in phases.items():
            TRACER.add_span(name, t0, t1 - t0, cat="request", trace=trace,  # span-names: queue prefill decode
                            wall=True, **meta)
        if req.finish_t is not None:
            TRACER.add_span("request", req.arrival_t, req.finish_t - req.arrival_t,
                            cat="request", trace=trace, wall=True,
                            finish_reason=req.finish_reason,
                            tokens=len(req.output_ids), **meta)
        # latency attribution: every finished request's e2e decomposed into
        # the phase vocabulary, observed into the {phase} histogram family
        # and surfaced on /debug/requests + in postmortem bundles
        attribution = request_attribution(req)
        if attribution is not None:
            for phase, seconds in attribution.items():
                self.metrics.latency_attribution.observe(seconds, phase=phase)
            if handle is not None:
                # feed the live queue-wait estimator: this request's observed
                # pre-admission wait, normalized by the backlog it arrived
                # behind (loop-thread append; see queue_wait_estimate)
                wait = attribution["queue"] + attribution["admission_gate"]
                with self._qw_lock:
                    self._queue_wait_samples.append(
                        wait / (max(handle.depth_at_submit, 0) + 1))
                    self._qw_fresh_t = time.time()
        # billing: exactly one usage record per request id — _trace_finished
        # is the funnel every resolution path passes through (normal finish,
        # abort, engine_error quarantine), and the meter's seen-id set makes
        # a double resolution book nothing twice
        usage_record = self.usage.record_finished(req, handle,
                                                  attribution=attribution)
        self.recent_finished.append({
            "trace": trace,
            "req_id": req.req_id,
            "state": "finished",
            "finish_reason": req.finish_reason,
            "retries": handle.retries if handle is not None else 0,
            "tenant": getattr(req, "tenant", None) or DEFAULT_TENANT,
            "adapter_id": getattr(req, "adapter_id", None)
            or (handle.adapter_id if handle is not None else None),
            "prompt_len": len(req.prompt_ids),
            "output_tokens": len(req.output_ids),
            "arrival_t": req.arrival_t,
            "queue_wait_s": req.queue_wait,
            "ttft_s": req.ttft,
            "decode_time_s": req.decode_time,
            "finish_t": req.finish_t,
            "attribution": attribution,
            "usage": None if usage_record is None else {
                k: usage_record[k]
                for k in ("prompt_tokens", "cached_tokens", "completion_tokens",
                          "useful_tokens", "kv_block_seconds",
                          "adapter_slot_seconds")},
        })

    def inflight_info(self) -> List[Dict]:
        """Point-in-time timelines of in-flight requests for /debug/requests.

        Called from HTTP threads while the loop mutates state: every field read
        is a single attribute/len fetch (atomic under the GIL) and the handle
        map is copied defensively, so the result may be a few tokens stale but
        never corrupt."""
        now = time.time()
        out = []
        handles = list(self._handles.values())
        requeued = list(self._requeue)
        for handle in handles + requeued:
            req = None
            if handle.req_id is not None and handle not in requeued:
                try:
                    req = next((r for r in list(self.engine.slots)
                                if r is not None and r.req_id == handle.req_id), None)
                    if req is None:
                        req = next((r for r in list(self.engine.waiting)
                                    if r.req_id == handle.req_id), None)
                except RuntimeError:
                    # slots/waiting mutated mid-copy by the loop thread: report
                    # the handle-level view only rather than failing the scrape
                    req = None
            info = {
                "trace": handle.trace,
                "req_id": handle.req_id,
                "prompt_len": handle.prompt_len,
                "age_s": now - handle.submitted_t,
                "retries": handle.retries,
                "deadline_in_s": None if handle.deadline_t is None else handle.deadline_t - now,
            }
            if handle in requeued:
                info["state"] = "requeued"  # waiting for the engine rebuild
            elif req is None:
                info["state"] = "submitted"
            else:
                info["state"] = "queued" if req.sched_t is None else (
                    "prefill" if req.first_token_t is None else "decode")
                info["output_tokens"] = len(req.output_ids)
                info["queue_wait_s"] = req.queue_wait
                info["ttft_s"] = req.ttft
                # disagg visibility: which stage pool holds the KV, and how
                # long the request has been waiting on block migration so far
                # — a stuck migration is visible LIVE, not just postmortem
                info["kv_stage"] = getattr(req, "kv_stage", None)
                mig_wait = getattr(req, "migration_wait_s", 0.0)
                open_t = getattr(req, "migrate_start_t", None)
                if open_t is not None:
                    mig_wait += max(now - open_t, 0.0)
                info["migration_wait_s"] = mig_wait
                # host-tier visibility: how long the request has waited on its
                # H2D promotion copy so far (kv_stage == "promoting" while the
                # copy is in flight) — a stuck promotion is visible LIVE too
                promote_wait = getattr(req, "promote_wait_s", 0.0)
                open_t = getattr(req, "promote_start_t", None)
                if open_t is not None:
                    promote_wait += max(now - open_t, 0.0)
                info["promote_wait_s"] = promote_wait
                info["usage_so_far"] = self._usage_so_far(req, handle)
            out.append(info)
        return out

    def _usage_so_far(self, req, handle: RequestHandle) -> Dict:
        """Running usage totals for one in-flight request (the live half of a
        usage record): tokens so far plus the KV-residency integral extended
        to 'now'. Same stale-but-never-corrupt contract as inflight_info."""
        kv_s = float(getattr(req, "kv_block_seconds", 0.0) or 0.0)
        occ_t = getattr(req, "kv_occ_t", None)
        if occ_t is not None:
            try:
                held = len(self.engine.mgr.tables.get(req.req_id, ()))
            except Exception:  # mgr mutated mid-read: report the booked part
                held = 0
            kv_s += max(time.perf_counter() - occ_t, 0.0) * held
        return {
            "prompt_tokens": handle.prompt_len,
            "cached_tokens": int(getattr(req, "cached_tokens", 0) or 0),
            "completion_tokens": len(handle._streamed),
            "useful_tokens": int(getattr(req, "useful_tokens", 0) or 0),
            "kv_block_seconds": round(kv_s, 6),
        }

    # ------------------------------------------------------------- postmortem
    def _postmortem_health(self) -> Dict:
        """Bundle health snapshot: loop + scheduler-visible state, engine
        stats, the in-flight view and the finished tail (which carries each
        request's latency attribution — the offline analyzer reads it)."""
        return {
            "loop_state": self._state,
            "phase": self._phase,
            "pending": self.pending_count(),
            "weights_version": self.weights_version,
            "slot_quarantines": self.slot_quarantines,
            "engine": self.engine.stats(),
            "inflight": self.inflight_info(),
            "recent_finished": list(self.recent_finished),
            "usage": self.usage.snapshot(),
        }

    def _postmortem_config(self) -> Dict:
        """Bundle config snapshot: the engine/supervisor knobs that shaped
        the decisions in the event trail."""
        eng = self.engine
        return {
            "max_batch_size": getattr(eng, "max_batch_size", None),
            "decode_steps": getattr(eng, "decode_steps", None),
            "prefill_chunk_tokens": getattr(eng, "prefill_chunk_tokens", None),
            "enable_prefix_cache": getattr(eng, "enable_prefix_cache", None),
            "staged": getattr(eng, "staged", False),
            "migration_inflight_limit": getattr(eng, "migration_inflight_limit", None),
            "decode_pressure_gate": getattr(eng, "decode_pressure_gate", None),
            "prefill_pressure_gate": getattr(eng, "prefill_pressure_gate", None),
            "backend": self._guarded_describe(),
            "supervisor_policy": dataclasses.asdict(self.policy),
        }

    def _guarded_describe(self) -> Dict:
        try:
            return self.engine.backend.describe()
        except Exception as e:
            return {"error": repr(e)}

    def _shutdown_cleanup(self):
        for handle in list(self._handles.values()):
            if handle.req_id is not None:
                req = self.engine.abort(handle.req_id)
                if req is not None:
                    self.metrics.on_finished(req)
                    # shutdown bypasses _trace_finished (no span emission at
                    # teardown) but the request still consumed tokens — book
                    # it, same idempotent path
                    self.usage.record_finished(req, handle)
                    handle._resolve(req)
                    continue
            handle._resolve(None)
        self._handles.clear()
        # requests stashed for a rebuild that never happened (stop while
        # degraded): their clients are blocked in result() — resolve them
        for handle in self._requeue:
            handle._resolve(None)
        self._requeue = []
        # a swap the stop interrupted (and submissions it was holding):
        # their waiters are blocked — fail/resolve them
        stop_err = RuntimeError("engine loop stopped")
        if self._pending_swap is not None:
            self._pending_swap.fail(stop_err)
            self._pending_swap = None
        for cmd in self._held_cmds:
            cmd[1]._resolve(None)
        self._held_cmds = []
        # submit commands that raced the stop and never reached the engine:
        # their clients are blocked in result() — resolve them too
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                break
            if cmd[0] == "submit":
                cmd[1]._resolve(None)
            elif cmd[0] in ("weights", "call"):
                cmd[1].fail(stop_err)
