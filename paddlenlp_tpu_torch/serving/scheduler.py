"""Admission control + backpressure in front of the engine loop.

The engine's own waiting queue is unbounded (a batch ``generate()`` call wants
that); a server does not — heavy traffic must shed load *before* prompts pile
up in host memory. The scheduler enforces:

- a bounded in-flight window (``max_inflight`` = running + waiting): past it,
  submissions raise :class:`SaturatedError` (HTTP 429, retryable);
- per-request deadlines (``default_timeout_s`` unless the caller overrides) so
  one stuck client cannot hold a slot forever;
- graceful drain: ``drain()`` flips to rejecting new work with
  :class:`ShuttingDownError` (HTTP 503) while in-flight requests finish;
- circuit breaker: while the engine loop is DEGRADED (supervisor rebuilding
  the engine after a step failure), submissions raise :class:`DegradedError`
  (HTTP 503 with ``Retry-After``) instead of queueing behind a dead engine.

**Concurrency model.** ``submit()`` is called from many HTTP worker threads
at once, and ``_release`` fires on whichever thread resolves the handle (the
engine loop, usually). The admission window (``_inflight``) and the drain
flag (``_draining``) are therefore guarded by ``_lock`` — annotated with
``# guarded-by:`` and enforced by ``tools/analyze`` (lock-discipline
checker). The ``rejected_*`` counters are single-writer-ish int bumps read
only by ``stats()``; a momentarily stale read is acceptable and they stay
unguarded on purpose. ``_idle`` is a ``threading.Event`` (self-synchronized).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from ..observability.flight_recorder import RECORDER
from ..observability.tracer import TRACER
from ..utils.faults import FaultPoint
from ..utils.log import logger
from .brownout import PRIORITIES, BrownoutController, BrownoutPolicy
from .engine_loop import EngineLoop, RequestHandle
from .tenancy.quotas import DEFAULT_TENANT, TenantQuotas

__all__ = ["Scheduler", "SchedulerConfig", "SaturatedError", "ShuttingDownError",
           "DegradedError", "ShedError", "DeadlineUnmetError", "TenantQuotaError"]

_F_SUBMIT = FaultPoint("serving.submit")
_F_SHED = FaultPoint("sched.shed")


class SaturatedError(Exception):
    """In-flight window full — shed load (HTTP 429 + ``Retry-After`` from the
    live queue-wait estimate)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class TenantQuotaError(SaturatedError):
    """One tenant's ``max_inflight`` admission quota is full — shed only that
    tenant's traffic (HTTP 429 + ``Retry-After``) while the shared window
    stays open to everyone else. Subclasses :class:`SaturatedError` so every
    429 path handles it without knowing about tenancy."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 tenant: str = DEFAULT_TENANT):
        super().__init__(message, retry_after_s=retry_after_s)
        self.tenant = tenant


class ShuttingDownError(Exception):
    """Scheduler draining/stopped — not accepting work (HTTP 503)."""


class ShedError(Exception):
    """Brownout priority shed: the replica is overloaded and this request's
    priority class is below the current ladder level (HTTP 503 +
    ``Retry-After``)."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 priority: str = "best_effort"):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.priority = priority


class DeadlineUnmetError(Exception):
    """Deadline-aware admission rejected on arrival: the live queue-wait
    estimate already exceeds the request's ``deadline_ms`` budget, so
    admitting it would only burn a slot on a guaranteed timeout (HTTP 503 +
    ``Retry-After``)."""

    def __init__(self, message: str, retry_after_s: float = 1.0,
                 estimate_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.estimate_s = estimate_s


class DegradedError(Exception):
    """Engine loop is DEGRADED (rebuilding) — retry later (HTTP 503 +
    ``Retry-After: retry_after_s``)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class SchedulerConfig:
    def __init__(self, max_inflight: int = 64, default_timeout_s: Optional[float] = 120.0,
                 max_prompt_tokens: Optional[int] = None):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.max_inflight = max_inflight
        self.default_timeout_s = default_timeout_s
        self.max_prompt_tokens = max_prompt_tokens


class Scheduler:
    """Bounded admission window around an :class:`EngineLoop`."""

    def __init__(self, loop: EngineLoop, config: Optional[SchedulerConfig] = None,
                 brownout: Optional[BrownoutController] = None,
                 brownout_policy: Optional[BrownoutPolicy] = None,
                 tenant_quotas: Optional[TenantQuotas] = None):
        self.loop = loop
        self.config = config or SchedulerConfig()
        self.tenant_quotas = tenant_quotas
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self._tenant_inflight: dict = {}  # guarded-by: _lock
        self._draining = False  # guarded-by: _lock
        self._idle = threading.Event()
        self._idle.set()
        self.rejected_saturated = 0
        self.rejected_draining = 0
        self.rejected_degraded = 0
        self.rejected_shed = 0
        self.rejected_deadline = 0
        self.rejected_tenant_quota = 0
        # overload-brownout ladder: evaluated on every submission against the
        # local saturation signal (window occupancy vs the live queue-wait
        # estimate); the router/autoscaler can push a level floor on top
        self.brownout = brownout if brownout is not None else BrownoutController(
            policy=brownout_policy, pressure_fn=self._pressure)
        if self.brownout.pressure_fn is None:
            self.brownout.pressure_fn = self._pressure

    def _reject_if_unavailable(self, trace):  # holds-lock: _lock
        """Caller holds ``_lock``. Raise when this scheduler cannot accept
        work at all — draining/stopped (``ShuttingDownError``) or engine
        DEGRADED (``DegradedError`` with a recovery hint: shed load NOW
        instead of piling work on a dead engine)."""
        if self._draining or not self.loop.running:
            self.rejected_draining += 1
            RECORDER.record("sched.reject", trace=trace, reason="draining")
            TRACER.instant("admission_rejected", cat="scheduler", reason="draining")
            raise ShuttingDownError("server is draining; retry against another replica")
        if self.loop.degraded:
            self.rejected_degraded += 1
            retry_after = self.loop.retry_after_hint()
            RECORDER.record("sched.reject", trace=trace, reason="degraded",
                            retry_after_s=retry_after)
            TRACER.instant("admission_rejected", cat="scheduler", reason="degraded",
                           retry_after_s=retry_after)
            raise DegradedError(
                "engine is recovering from a failure; retry shortly",
                retry_after_s=retry_after)

    def _pressure(self) -> float:
        """Local saturation signal for the brownout ladder: the worse of
        admission-window occupancy and the queue-wait estimate relative to the
        policy's saturation threshold (>= 1.0 means overloaded)."""
        occupancy = self.inflight / max(self.config.max_inflight, 1)
        wait = self.loop.queue_wait_estimate()
        return max(occupancy,
                   wait / max(self.brownout.policy.saturation_wait_s, 1e-9))

    # ------------------------------------------------------------- admission
    def submit(self, prompt_ids, sampling=None, timeout_s: Optional[float] = None,
               max_retries: Optional[int] = None,
               trace: Optional[str] = None,
               priority: str = "interactive",
               deadline_s: Optional[float] = None,
               tenant: str = DEFAULT_TENANT,
               adapter_id: Optional[str] = None) -> RequestHandle:
        """Admit one request or raise (SaturatedError / ShuttingDownError /
        DegradedError / ShedError / DeadlineUnmetError / TenantQuotaError).
        ``max_retries`` is the per-request engine-rebuild requeue budget
        (None = supervisor policy default); ``trace`` adopts an inbound
        cross-tier trace id (None = the loop mints ``req-N``). ``priority``
        selects the brownout shed class and the engine's admission order;
        ``deadline_s`` is the request's total latency budget — rejected on
        arrival when the live queue-wait estimate already exceeds it, and
        enforced as the engine deadline otherwise. ``tenant`` keys the
        per-tenant ``max_inflight`` quota (a full quota sheds only that
        tenant) and the tenant label on every shed/finish metric;
        ``adapter_id`` selects the LoRA adapter the engine decodes with."""
        cfg = self.config
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got {priority!r}")
        if cfg.max_prompt_tokens is not None and len(prompt_ids) > cfg.max_prompt_tokens:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds max_prompt_tokens={cfg.max_prompt_tokens}")
        # availability checks come FIRST: a draining/degraded replica must
        # report draining/degraded (the signal the router's failure
        # classification keys on), not a brownout shed — and drain-induced
        # occupancy must never walk the brownout ladder
        with self._lock:
            self._reject_if_unavailable(trace)
        # overload controls run before the admission window: they shed work
        # the window would only queue toward a guaranteed-bad outcome
        level = self.brownout.evaluate()
        if self.brownout.should_shed(priority):
            self.rejected_shed += 1
            _F_SHED.fire(priority=priority)
            self.loop.metrics.shed.inc(reason="shed", priority=priority,
                                       tenant=tenant)
            retry_after = self.loop.queue_wait_estimate()
            RECORDER.record("sched.reject", trace=trace, reason="shed",
                            level=level)
            TRACER.instant("admission_rejected", cat="scheduler", reason="shed",
                           level=level)
            raise ShedError(
                f"replica browned out (level {level}); {priority} traffic is "
                "being shed — retry later or elsewhere",
                retry_after_s=retry_after, priority=priority)
        if deadline_s is not None:
            estimate = self.loop.queue_wait_estimate()
            if estimate > deadline_s:
                self.rejected_deadline += 1
                self.loop.metrics.shed.inc(reason="deadline", priority=priority,
                                           tenant=tenant)
                RECORDER.record("sched.reject", trace=trace, reason="deadline",
                                estimate_s=round(estimate, 4))
                TRACER.instant("admission_rejected", cat="scheduler",
                               reason="deadline", estimate_s=estimate)
                raise DeadlineUnmetError(
                    f"queue-wait estimate {estimate:.3f}s already exceeds the "
                    f"{deadline_s:.3f}s deadline; rejecting on arrival",
                    retry_after_s=estimate, estimate_s=estimate)
        cap = self.brownout.max_tokens_cap()
        if cap is not None and sampling is not None \
                and getattr(sampling, "max_new_tokens", 0) > cap:
            # level-3 clamp: shorter completions for everyone beats timeouts
            # for everyone — documented in the brownout ladder
            sampling = dataclasses.replace(sampling, max_new_tokens=cap)
        with self._lock:
            # re-checked: a drain/degrade may have started while the overload
            # controls ran outside the lock
            self._reject_if_unavailable(trace)
            if self._inflight >= cfg.max_inflight:
                self.rejected_saturated += 1
                # Retry-After tracks the live backlog, not a constant: a
                # deep queue quotes a longer backoff than a momentary blip
                retry_after = self.loop.queue_wait_estimate()
                RECORDER.record("sched.reject", trace=trace, reason="saturated",
                                inflight=self._inflight)
                TRACER.instant("admission_rejected", cat="scheduler", reason="saturated",
                               inflight=self._inflight)
                raise SaturatedError(
                    f"in-flight window full ({self._inflight}/{cfg.max_inflight}); retry later",
                    retry_after_s=retry_after)
            tcap = None if self.tenant_quotas is None \
                else self.tenant_quotas.max_inflight(tenant)
            if tcap is not None and self._tenant_inflight.get(tenant, 0) >= tcap:
                # per-tenant isolation: one tenant at its quota sheds only its
                # OWN traffic — the shared window stays open to everyone else
                self.rejected_tenant_quota += 1
                self.loop.metrics.shed.inc(reason="tenant_quota",
                                           priority=priority, tenant=tenant)
                retry_after = self.loop.queue_wait_estimate()
                RECORDER.record("sched.reject", trace=trace, reason="tenant_quota",
                                tenant=tenant, inflight=self._tenant_inflight.get(tenant, 0))
                TRACER.instant("admission_rejected", cat="scheduler",
                               reason="tenant_quota", tenant=tenant)
                raise TenantQuotaError(
                    f"tenant {tenant!r} at its max_inflight quota "
                    f"({self._tenant_inflight.get(tenant, 0)}/{tcap}); retry later",
                    retry_after_s=retry_after, tenant=tenant)
            self._inflight += 1
            self._tenant_inflight[tenant] = self._tenant_inflight.get(tenant, 0) + 1
            self._idle.clear()
        deadline = timeout_s if timeout_s is not None else cfg.default_timeout_s
        if deadline_s is not None:
            # the deadline is a TOTAL latency budget: it also bounds the
            # engine-side abort deadline so an admitted-then-stuck request
            # frees its slot at the deadline, not at the generic timeout
            deadline = deadline_s if deadline is None else min(deadline, deadline_s)
        try:
            _F_SUBMIT.fire(prompt_len=len(prompt_ids))
            # recorded retrospectively so Span.trace carries the request's id
            # (assigned by submit) and trace-filtered timelines include admission
            t0 = time.perf_counter()
            handle = self.loop.submit(prompt_ids, sampling, deadline_s=deadline,
                                      max_retries=max_retries, trace=trace,
                                      priority=priority, tenant=tenant,
                                      adapter_id=adapter_id)
            TRACER.add_span("admission", TRACER.epoch_time(t0),
                            time.perf_counter() - t0, cat="scheduler",
                            trace=handle.trace, prompt_len=len(prompt_ids))
        except BaseException:
            self._release(tenant)
            raise
        # release the window slot the moment the request resolves (any reason)
        handle.add_done_callback(lambda _h: self._release(tenant))
        return handle

    def cancel(self, handle: RequestHandle):
        self.loop.cancel(handle)

    def _release(self, tenant: str = DEFAULT_TENANT):
        with self._lock:
            self._inflight -= 1
            n = self._tenant_inflight.get(tenant, 0) - 1
            if n > 0:
                self._tenant_inflight[tenant] = n
            else:
                self._tenant_inflight.pop(tenant, None)
            if self._inflight <= 0:
                self._idle.set()

    # ------------------------------------------------------------- stats/drain
    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def tenant_inflight(self) -> dict:
        """Snapshot of in-flight counts by tenant (quota bookkeeping view)."""
        with self._lock:
            return dict(self._tenant_inflight)

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def stats(self) -> dict:
        return {
            "inflight": self.inflight,
            "max_inflight": self.config.max_inflight,
            "draining": self.draining,
            "engine_state": self.loop.state,
            # slot-level partial recoveries (poisoned requests quarantined
            # without a full rebuild) — surfaced on /health so operators can
            # see a replica absorbing poison before it escalates
            "slot_quarantines": getattr(self.loop, "slot_quarantines", 0),
            "rejected_saturated": self.rejected_saturated,
            "rejected_draining": self.rejected_draining,
            "rejected_degraded": self.rejected_degraded,
            "rejected_shed": self.rejected_shed,
            "rejected_deadline": self.rejected_deadline,
            "rejected_tenant_quota": self.rejected_tenant_quota,
            # per-tenant occupancy of the shared window (tenants currently at
            # zero drop out) + the configured quotas, for /health visibility
            "tenants": {
                "inflight": self.tenant_inflight(),
                "quotas": self.tenant_quotas.describe()
                if self.tenant_quotas is not None else None,
            },
            # the overload ladder, surfaced on /health so the router's pool
            # snapshots (and operators) see a replica shedding before it 503s
            "brownout": self.brownout.stats(),
            "queue_wait_estimate_s": round(self.loop.queue_wait_estimate(), 4),
        }

    def start_drain(self):
        """Flip to rejecting new work WITHOUT waiting for in-flight requests
        — replica-side drain propagation: the router (or an operator) tells
        this server it is leaving the fleet, new direct traffic 503s
        immediately while accepted streams keep finishing."""
        with self._lock:
            self._draining = True
        TRACER.instant("membership", cat="scheduler", op="drain_direct")

    def stop_drain(self):
        """Undo :meth:`start_drain`: resume admitting new work. The rejoin
        half of a rolling weight rollout — the router drains a replica, swaps
        its weights, then un-drains it so it takes traffic again without a
        process restart."""
        with self._lock:
            self._draining = False
        TRACER.instant("membership", cat="scheduler", op="undrain_direct")

    def drain(self, timeout_s: Optional[float] = 30.0) -> bool:
        """Stop admitting; wait for in-flight work. Returns True if empty."""
        self.start_drain()
        ok = self._idle.wait(timeout=timeout_s)
        if not ok:
            logger.warning(f"scheduler drain timed out with {self.inflight} in flight")
        return ok

    def shutdown(self, timeout_s: Optional[float] = 30.0):
        """Drain then stop the engine loop (leftovers abort)."""
        self.drain(timeout_s)
        self.loop.stop(drain=False)
