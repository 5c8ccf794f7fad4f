"""Thread-safe span tracer with a bounded ring buffer.

The host-side counterpart of a device profile: where ``torch.profiler`` answers
"what did the device run", these spans answer "where did the *host* spend the step" —
admission vs prefill vs decode in the serving engine, read-data vs
forward-backward vs checkpoint in the trainer, and the ``block_until_ready``
sync points in between. Stdlib-only (no torch import) so the serving API, tools
and trainer callbacks can all use it without pulling in a backend.

Spans land in a ``deque(maxlen=capacity)``: recording is O(1), memory is
bounded, and old spans fall off the back — the tracer is always-on without a
leak. Export formats:

- **Chrome trace-event JSON** (``chrome_trace()``): complete-event (``ph="X"``)
  records loadable in Perfetto / ``chrome://tracing``; thread-name metadata
  events make the serving loop / HTTP workers / trainer readable lanes;
- **structured JSONL** (``to_jsonl()``): one JSON object per span for ad-hoc
  ``jq``/pandas analysis.

Trace context: a span can carry a ``trace`` id (e.g. ``req-42`` or ``train``)
linking every phase of one request/step across threads. ``use_trace()`` sets an
ambient id via ``contextvars`` so nested spans inherit it without plumbing.

Head-based sampling: under heavy traffic the per-request span volume (queue/
prefill/decode phases, kv alloc/free instants, sampling spans) dominates the
ring. ``sample_every=N`` keeps 1-in-N traces — the decision is a deterministic
hash of the trace id (:func:`trace_sampled`), so every process that sees the
same id independently agrees — and unsampled traces take a no-op path that
costs one hash + dict probe per span, not a record. A tier ahead of this one
(the router) can pin the decision explicitly via :meth:`SpanTracer.mark_trace`
after parsing the propagated traceparent header (:func:`parse_traceparent`).
Trace-less spans (batch-level engine phases, trainer steps) are never sampled
out.

**Concurrency model.** Every public method may be called from any thread.
The ring (``_buf``), the drop counter and the sampling-mark table are guarded
by ``_lock`` (``# guarded-by:`` annotations, enforced by the
``tools/analyze`` lock-discipline checker); the one deliberate unguarded read
(`trace_is_sampled`'s mark probe) is marked ``# lock-ok`` with its rationale.
``capacity``/``enabled``/``sample_every``/``_epoch0`` are set once at
construction and read-only after.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import threading
import time
import zlib
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "Span", "SpanTracer", "TRACER", "use_trace", "current_trace",
    "trace_sampled", "TRACEPARENT_HEADER", "format_traceparent",
    "parse_traceparent", "merge_chrome_traces",
]

#: cross-tier trace propagation header (traceparent-style: trace id + parent
#: span id + sampled flag). Custom name because our trace ids (``rtr-N``)
#: are not W3C 16-byte hex ids.
TRACEPARENT_HEADER = "X-Pdnlp-Traceparent"


def trace_sampled(trace_id: str, sample_every: int) -> bool:
    """Deterministic 1-in-N sampling decision for a trace id. Stable across
    processes and runs (crc32, not Python ``hash``) so the router and every
    replica agree on the same id without coordination."""
    if sample_every <= 1:
        return True
    return zlib.crc32(trace_id.encode()) % sample_every == 0


def format_traceparent(trace_id: str, parent_id: str = "", sampled: bool = True) -> str:
    """Render the propagation header value: ``<trace>;parent=<id>;sampled=<0|1>``."""
    return f"{trace_id};parent={parent_id};sampled={1 if sampled else 0}"


def parse_traceparent(value: Optional[str]):
    """Parse a propagation header into ``(trace_id, parent_id, sampled)``;
    returns None for missing/malformed values (the receiver then mints its own
    id). Unknown ``k=v`` fields are ignored for forward compatibility."""
    if not value:
        return None
    parts = [p.strip() for p in value.split(";")]
    trace_id = parts[0]
    if not trace_id or any(c.isspace() for c in trace_id):
        return None
    parent_id, sampled = "", True
    for part in parts[1:]:
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        if k == "parent":
            parent_id = v
        elif k == "sampled":
            sampled = v.strip() not in ("0", "false")
    return trace_id, parent_id, sampled

_trace_ctx: contextvars.ContextVar = contextvars.ContextVar("pdnlp_trace", default=None)


def current_trace() -> Optional[str]:
    """Ambient trace id set by :func:`use_trace` (None outside any trace)."""
    return _trace_ctx.get()


@contextlib.contextmanager
def use_trace(trace_id: str):
    """Set the ambient trace id for spans recorded inside the block."""
    token = _trace_ctx.set(trace_id)
    try:
        yield trace_id
    finally:
        _trace_ctx.reset(token)


class Span:
    """One recorded event. ``ts``/``dur`` are epoch-anchored seconds;
    ``dur is None`` marks an instant event."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "thread_name", "trace", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: Optional[float],
                 tid: int, thread_name: str, trace: Optional[str], args: Optional[Dict]):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.thread_name = thread_name
        self.trace = trace
        self.args = args

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "cat": self.cat, "ts": self.ts, "tid": self.tid,
             "thread": self.thread_name}
        if self.dur is not None:
            d["dur"] = self.dur
        if self.trace is not None:
            d["trace"] = self.trace
        if self.args:
            d["args"] = self.args
        return d


class _SpanCtx:
    """Context manager handed out by :meth:`SpanTracer.span`; records on exit.
    ``set(key=value)`` attaches args discovered mid-span (e.g. tokens emitted)."""

    __slots__ = ("_tracer", "_name", "_cat", "_trace", "_args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 trace: Optional[str], args: Optional[Dict]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._trace = trace
        self._args = args
        self._t0 = 0.0

    def set(self, **kw):
        if self._args is None:
            self._args = {}
        self._args.update(kw)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if exc_type is not None:
            self.set(error=repr(exc)[:200])
        self._tracer._record(self._name, self._cat, self._tracer._to_epoch(self._t0),
                             dur, self._trace, self._args)
        return False


class _NullCtx:
    """No-op span for a disabled tracer (keeps call sites unconditional)."""

    __slots__ = ()

    def set(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class SpanTracer:
    """Bounded-ring span recorder; every method is thread-safe."""

    def __init__(self, capacity: int = 8192, enabled: bool = True,
                 sample_every: int = 1):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self.sample_every = sample_every  # 1 = record every trace
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock — spans evicted by the ring since the last clear()
        # explicit per-trace decisions (propagated from an upstream tier);
        # bounded so a long-lived process cannot leak one entry per request —
        # an evicted entry just falls back to the deterministic hash
        self._trace_marks: "OrderedDict[str, bool]" = OrderedDict()  # guarded-by: _lock
        self._marks_cap = 4096
        # anchor perf_counter to the epoch once so spans from all threads share
        # one monotonic-but-absolute timeline (time.time() can step backwards)
        self._epoch0 = time.time() - time.perf_counter()

    def _to_epoch(self, perf_t: float) -> float:
        return self._epoch0 + perf_t

    def epoch_time(self, perf_t: float) -> float:
        """Map a ``time.perf_counter()`` reading onto this tracer's epoch
        timeline (for retrospective :meth:`add_span` from perf timestamps)."""
        return self._to_epoch(perf_t)

    def now(self) -> float:
        """Current time on the tracer's anchored timeline (monotonic; immune
        to wall-clock steps). Use for since_ts cursors over :meth:`snapshot`."""
        return self._to_epoch(time.perf_counter())

    # ------------------------------------------------------------- sampling
    def mark_trace(self, trace_id: str, sampled: bool):
        """Pin the sampling decision for one trace id (propagated from an
        upstream tier's traceparent header — overrides the local hash)."""
        with self._lock:
            self._trace_marks[trace_id] = sampled
            self._trace_marks.move_to_end(trace_id)
            while len(self._trace_marks) > self._marks_cap:
                self._trace_marks.popitem(last=False)

    def trace_is_sampled(self, trace_id: Optional[str]) -> bool:
        """True if spans carrying ``trace_id`` should record. Trace-less spans
        always record; marked traces use the pinned decision; otherwise the
        deterministic hash against ``sample_every``."""
        if trace_id is None:
            return True
        mark = self._trace_marks.get(trace_id)  # lock-ok: racy read is fine — stale bool/None only skews one sampling decision
        if mark is not None:
            return mark
        return self.sample_every <= 1 or trace_sampled(trace_id, self.sample_every)

    # ------------------------------------------------------------- recording
    def span(self, name: str, cat: str = "", trace: Optional[str] = None, **args):
        """``with tracer.span("prefill", cat="engine", batch=4): ...``"""
        if not self.enabled:
            return _NULL
        t = trace if trace is not None else current_trace()
        if not self.trace_is_sampled(t):
            return _NULL
        return _SpanCtx(self, name, cat, t, args or None)

    def instant(self, name: str, cat: str = "", trace: Optional[str] = None, **args):
        """Zero-duration marker (preemption, eviction, window edges)."""
        if not self.enabled:
            return
        t = trace if trace is not None else current_trace()
        if not self.trace_is_sampled(t):
            return
        self._record(name, cat, self._to_epoch(time.perf_counter()), None,
                     t, args or None)

    def add_span(self, name: str, start_t: float, dur: float, cat: str = "",
                 trace: Optional[str] = None, wall: bool = False, **args):
        """Record a span retrospectively — no context manager needed after the
        fact. ``start_t`` is on the tracer's anchored timeline (see
        :meth:`epoch_time`); pass ``wall=True`` for raw ``time.time()``
        timestamps (the engine's per-request ``arrival_t``/``sched_t``/...
        bookkeeping): they are re-anchored so a wall-clock step between capture
        and record cannot shear these spans away from live perf-anchored ones."""
        if not self.enabled or not self.trace_is_sampled(trace):
            return
        if wall:
            start_t = start_t + (self.now() - time.time())
        self._record(name, cat, start_t, max(dur, 0.0), trace, args or None)

    def _record(self, name, cat, ts, dur, trace, args):
        t = threading.current_thread()
        span = Span(name, cat, ts, dur, t.ident or 0, t.name, trace, args)
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(span)

    # ------------------------------------------------------------- reading
    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self, since_ts: Optional[float] = None,
                 trace: Optional[str] = None) -> List[Span]:
        """Copy of the ring (oldest first), optionally filtered by start time
        and/or trace id. The buffer is left untouched."""
        with self._lock:
            spans = list(self._buf)
        if since_ts is not None:
            spans = [s for s in spans if s.ts >= since_ts]
        if trace is not None:
            spans = [s for s in spans if s.trace == trace]
        return spans

    def clear(self):
        """Full reset: spans, the drop count, AND pinned per-trace sampling
        marks — a cleared tracer must not keep suppressing trace ids that a
        previous traffic epoch (or test) marked unsampled."""
        with self._lock:
            self._buf.clear()
            self.dropped = 0
            self._trace_marks.clear()

    # ------------------------------------------------------------- export
    def chrome_trace(self, spans: Optional[Iterable[Span]] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``{"traceEvents": [...]}`` object
        format), loadable in Perfetto / chrome://tracing. ``ts``/``dur`` are
        microseconds per the spec; spans become complete events (``ph="X"``),
        instants ``ph="i"``; thread names ride on ``M`` metadata events."""
        spans = list(spans) if spans is not None else self.snapshot()
        events: List[Dict[str, Any]] = []
        named_tids: Dict[int, str] = {}
        for s in spans:
            ev: Dict[str, Any] = {
                "name": s.name,
                "cat": s.cat or "default",
                "ph": "X" if s.dur is not None else "i",
                "ts": round(s.ts * 1e6, 3),
                "pid": 1,
                "tid": s.tid,
            }
            if s.dur is not None:
                ev["dur"] = round(s.dur * 1e6, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            args = dict(s.args) if s.args else {}
            if s.trace is not None:
                args["trace"] = s.trace
            if args:
                ev["args"] = args
            events.append(ev)
            if s.tid not in named_tids:
                named_tids[s.tid] = s.thread_name
        for tid, tname in sorted(named_tids.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                           "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_jsonl(self, spans: Optional[Iterable[Span]] = None) -> str:
        """One JSON object per line (machine-parseable span log)."""
        spans = list(spans) if spans is not None else self.snapshot()
        return "\n".join(json.dumps(s.to_dict(), default=str) for s in spans)

    def write_chrome_trace(self, path: str, spans: Optional[Iterable[Span]] = None):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(spans), f)


def merge_chrome_traces(tiers: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stitch per-process Chrome traces into one multi-process timeline.

    Each tier is ``{"name": str, "events": [chrome events], "offset_s": float,
    "dropped": int}`` — ``events`` as produced by :meth:`SpanTracer.chrome_trace`
    (or scraped from another process's ``/debug/trace``), ``offset_s`` the
    estimated clock offset of that process relative to the reference tier
    (``remote_now - local_now``; its timestamps are shifted by ``-offset_s`` so
    everything lands on the reference timeline). Tiers become distinct ``pid``
    lanes with ``process_name`` metadata; per-tier ring-drop counts ride in
    ``otherData`` so a consumer knows when a timeline has holes.
    """
    events: List[Dict[str, Any]] = []
    dropped: Dict[str, int] = {}
    for pid, tier in enumerate(tiers, start=1):
        shift_us = -float(tier.get("offset_s", 0.0)) * 1e6
        for ev in tier.get("events", ()):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") != "M" and "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            events.append(ev)
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": tier.get("name", f"process-{pid}")}})
        dropped[tier.get("name", f"process-{pid}")] = int(tier.get("dropped", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped}}


#: process-wide tracer (serving loop, engine phases, trainer steps all share it)
TRACER = SpanTracer()
