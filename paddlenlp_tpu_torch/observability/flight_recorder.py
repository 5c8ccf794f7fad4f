"""Always-on flight recorder: a bounded ring of structured decision events.

The serving stack makes dozens of silent scheduling decisions per step —
admission gating, preemption victim choice, chunk-budget splits, migration
deferral, slot quarantine, hedging, drain eviction. Spans answer *where time
went*; the flight recorder answers *why the scheduler did what it did*, so a
degraded incident or one slow request is explainable after the fact. Every
event carries the decision name (validated against
:mod:`.event_catalog` — the name vocabulary is stable API), a monotonic
timestamp, the affected ``req_id``/``trace`` id where one exists, an optional
``reason`` drawn from the event's closed enum, and free-form numeric context.

Recording discipline matches :mod:`..utils.faults`: the disabled fast path is
ONE attribute read (``PDNLP_TPU_FLIGHT_RECORDER=0`` turns the recorder off
process-wide), events land in a ``deque(maxlen=capacity)`` so memory is
bounded and the recorder can stay armed in production, and call sites sit on
decision *edges* (an admission, a deferral episode, a preemption) — never
once-per-step — so a steady-state decode step records nothing at all.

Postmortem bundles (:mod:`.postmortem`) snapshot this ring; the offline
analyzer (``tools/postmortem.py``) joins router-tier and replica-tier events
on the shared trace id to reconstruct one request's cross-tier decision
trail.

**Concurrency model.** ``record``/``snapshot``/``clear`` may be called from
any thread. The ring (``_buf``), the drop counter and the sequence counter
are guarded by ``_lock`` (``# guarded-by:`` annotations, enforced by the
``tools/analyze`` lock-discipline checker); ``_enabled`` is a single-slot
flag whose racy read costs at most one event recorded/skipped around an
enable/disable edge. Stdlib-only (no torch) by contract. A copy of
``paddlenlp_tpu/observability/flight_recorder.py``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .event_catalog import EVENT_CATALOG, EVENT_REASONS

__all__ = ["FlightEvent", "FlightRecorder", "RECORDER", "ENV_VAR"]

ENV_VAR = "PDNLP_TPU_FLIGHT_RECORDER"


class FlightEvent:
    """One recorded decision. ``t`` is epoch-anchored monotonic seconds (the
    same timeline discipline as :class:`~.tracer.SpanTracer`); ``seq`` is a
    per-recorder monotone sequence number (a cursor that survives ring
    eviction, unlike list indices)."""

    __slots__ = ("seq", "name", "t", "req_id", "trace", "reason", "fields")

    def __init__(self, seq: int, name: str, t: float, req_id: Optional[int],
                 trace: Optional[str], reason: Optional[str],
                 fields: Optional[Dict[str, Any]]):
        self.seq = seq
        self.name = name
        self.t = t
        self.req_id = req_id
        self.trace = trace
        self.reason = reason
        self.fields = fields

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"seq": self.seq, "name": self.name, "t": self.t}
        if self.req_id is not None:
            d["req_id"] = self.req_id
        if self.trace is not None:
            d["trace"] = self.trace
        if self.reason is not None:
            d["reason"] = self.reason
        if self.fields:
            d.update(self.fields)
        return d

    def __repr__(self):
        return (f"FlightEvent({self.name!r}, seq={self.seq}, req_id={self.req_id}, "
                f"trace={self.trace!r}, reason={self.reason!r})")


class FlightRecorder:
    """Bounded-ring decision-event recorder; every method is thread-safe."""

    def __init__(self, capacity: int = 4096, enabled: Optional[bool] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        if enabled is None:
            enabled = os.environ.get(ENV_VAR, "1").strip().lower() not in ("0", "false", "off")
        self._enabled = bool(enabled)  # single-slot flag: the disabled fast path reads only this
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock — events evicted by the ring since the last clear()
        # epoch-anchored perf_counter: one monotonic-but-absolute timeline for
        # every event, immune to wall-clock steps (same trick as the tracer)
        self._epoch0 = time.time() - time.perf_counter()

    # ------------------------------------------------------------- state
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool):
        """Flip recording on/off at runtime (tests, overhead A/B)."""
        self._enabled = bool(enabled)

    def now(self) -> float:
        """Current time on the recorder's anchored timeline."""
        return self._epoch0 + time.perf_counter()

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    # ------------------------------------------------------------- recording
    def record(self, name: str, req_id: Optional[int] = None,
               trace: Optional[str] = None, reason: Optional[str] = None,
               **fields):
        """Record one decision event. No-op (one attribute read) when the
        recorder is disabled. ``name`` must be registered in
        :data:`~.event_catalog.EVENT_CATALOG` and ``reason`` (when given) must
        belong to the event's closed enum — typos fail loudly in tests, never
        silently fork the vocabulary."""
        if not self._enabled:
            return
        if name not in EVENT_CATALOG:
            raise ValueError(
                f"unknown decision event {name!r}; register it in "
                "observability/event_catalog.py")
        if reason is not None and reason not in EVENT_REASONS.get(name, ()):
            raise ValueError(
                f"event {name!r}: reason {reason!r} not in its catalog enum "
                f"{EVENT_REASONS.get(name, ())}")
        t = self._epoch0 + time.perf_counter()
        with self._lock:
            self._seq += 1
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(FlightEvent(self._seq, name, t, req_id, trace,
                                         reason, fields or None))

    # ------------------------------------------------------------- reading
    def snapshot(self, trace: Optional[str] = None, req_id: Optional[int] = None,
                 name_prefix: Optional[str] = None,
                 since_seq: Optional[int] = None) -> List[FlightEvent]:
        """Copy of the ring (oldest first), optionally filtered by trace id,
        request id, name prefix (``"router."`` selects one tier) and/or a
        ``since_seq`` cursor for incremental reads."""
        with self._lock:
            events = list(self._buf)
        if since_seq is not None:
            events = [e for e in events if e.seq > since_seq]
        if trace is not None:
            events = [e for e in events if e.trace == trace]
        if req_id is not None:
            events = [e for e in events if e.req_id == req_id]
        if name_prefix is not None:
            events = [e for e in events if e.name.startswith(name_prefix)]
        return events

    def to_dicts(self, events: Optional[List[FlightEvent]] = None) -> List[Dict]:
        return [e.to_dict() for e in (events if events is not None else self.snapshot())]

    def clear(self):
        """Drop every event and reset the drop counter (the sequence counter
        keeps counting — cursors held across a clear() stay valid)."""
        with self._lock:
            self._buf.clear()
            self.dropped = 0


#: process-wide recorder (engine, scheduler, engine loop and router share it;
#: in-process fleets therefore get cross-tier trails joined for free, and
#: separate processes merge their postmortem bundles in tools/postmortem.py)
RECORDER = FlightRecorder()
