"""Shared HTTP observability routes and the on-demand device profile.

A copy of ``paddlenlp_tpu/observability/exporter.py`` minus its training-side
``ObservabilityExporter`` (the trainer's metrics plane, ROADMAP Queue 1 item
15). What the serving API mounts:

    GET  /metrics        Prometheus text exposition (shared MetricsRegistry)
    GET  /debug/trace    span ring buffer as Chrome trace-event JSON (Perfetto)
    GET  /debug/spans    span ring buffer as structured JSONL
    POST /debug/profile  on-demand ``torch.profiler`` capture (?seconds=S; 409
                         while another capture runs: the profiler is
                         process-global)

``torch.profiler`` records the host ops of the thread that starts it and, on
a machine with a CUDA device, every kernel the process launches. The serving
API therefore starts and stops its capture on the engine loop's thread, at a
step boundary (``TorchProfiler(run_on=loop.run_on_loop)``): the trace holds
the loop's ops and kernels, and the profiler is never stopped while the
thread it records is inside an op. An HTTP thread waits out the window and
writes ``trace.json`` (Chrome trace) into the capture directory.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from ..utils.log import logger
from .tracer import SpanTracer

__all__ = ["route_observability", "ProfileCapture", "ProfileInProgressError",
           "PROFILE_CAPTURE", "handle_profile_request", "TorchProfiler"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

TRACES_DROPPED_METRIC = "paddlenlp_traces_dropped_total"

# read-modify-write guard: concurrent /metrics scrapes (ThreadingHTTPServer
# handler threads, or two planes sharing one registry+tracer) computing the
# same delta would double-count evictions into the monotone counter
_dropped_sync_lock = threading.Lock()


def _sync_dropped_counter(registry, tracer: SpanTracer):
    """Top the ``paddlenlp_traces_dropped_total`` counter up to the tracer's
    ring-eviction count at scrape time (the ring drops oldest spans silently;
    this is the only place the loss becomes operator-visible as a rate)."""
    counter = registry.counter(
        TRACES_DROPPED_METRIC,
        "Spans evicted from the bounded trace ring (oldest-first overflow)")
    with _dropped_sync_lock:
        delta = tracer.dropped - counter.value()
        if delta > 0:
            counter.inc(delta)


def route_observability(path: str, registry, tracer: SpanTracer):
    """Shared GET routing for the observability surface: returns
    ``(status, content_type, body_bytes)`` or None for unknown paths. All three
    HTTP planes — this exporter, ``serving/api.py``, and the router — dispatch
    through here so the routes cannot drift.

    ``/debug/trace`` and ``/debug/spans`` accept filters so one request's
    timeline is dumpable without shipping the whole ring:

    - ``?trace=req-42`` — only spans carrying that trace id;
    - ``?since_ts=<epoch seconds>`` — cursor for incremental scrapes (pair it
      with ``SpanTracer.now()`` readings from the previous dump).

    ``/debug/trace`` responses carry ``otherData.dropped_spans`` (the ring's
    eviction count) so a consumer can tell a short timeline from a truncated
    one; ``/metrics`` syncs the same count into ``paddlenlp_traces_dropped_total``.
    """
    parts = urlsplit(path)
    route, query = parts.path, parse_qs(parts.query)
    if route == "/metrics":
        _sync_dropped_counter(registry, tracer)
        return 200, PROMETHEUS_CONTENT_TYPE, registry.expose().encode()
    if route in ("/debug/trace", "/debug/spans"):
        trace = query.get("trace", [None])[0]
        since_raw = query.get("since_ts", [None])[0]
        try:
            since_ts = float(since_raw) if since_raw is not None else None
        except ValueError:
            return (400, "application/json",
                    json.dumps({"error": f"since_ts must be a number, got {since_raw!r}"}).encode())
        spans = tracer.snapshot(since_ts=since_ts, trace=trace)
        if route == "/debug/trace":
            doc = tracer.chrome_trace(spans)
            doc["otherData"] = {"dropped_spans": tracer.dropped}
            return 200, "application/json", json.dumps(doc).encode()
        return 200, "application/jsonl", tracer.to_jsonl(spans).encode()
    return None


class ProfileInProgressError(RuntimeError):
    """A device-profile capture is already running (HTTP 409)."""


class TorchProfiler:
    """``start_trace(path)`` / ``stop_trace()`` over ``torch.profiler``, the
    interface :class:`ProfileCapture` drives. The profiler records the host
    ops of the thread it starts on, and CUDA kernels when the process has a
    CUDA device. ``run_on(fn)`` runs ``fn`` on the thread to record and
    returns its result (default: the calling thread); it starts and stops
    the profiler there. ``stop_trace`` writes ``<path>/trace.json`` on the
    calling thread."""

    def __init__(self, run_on: Optional[Callable] = None):
        self._run_on = run_on or (lambda fn: fn())
        self._prof = None
        self._path: Optional[str] = None

    def start_trace(self, path: str):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        self._run_on(prof.start)
        self._prof, self._path = prof, path

    def stop_trace(self):
        prof, self._prof = self._prof, None
        self._run_on(prof.stop)
        prof.export_chrome_trace(os.path.join(self._path, "trace.json"))


class ProfileCapture:
    """On-demand ``torch.profiler`` capture with a one-at-a-time guard.

    The profiler is process-global state — two overlapping captures corrupt
    each other — so the guard is a non-blocking lock: a second caller gets
    :class:`ProfileInProgressError` (409), never a queue. ``capture`` blocks
    the calling (HTTP handler) thread for the requested window;
    ``max_seconds`` bounds how long an operator can pin the profiler.
    ``profiler`` is injectable for tests (default: a :class:`TorchProfiler`).
    """

    def __init__(self, base_dir: Optional[str] = None, max_seconds: float = 60.0,
                 profiler=None):
        self.base_dir = base_dir or os.environ.get(
            "PDNLP_TPU_PROFILE_DIR",
            os.path.join(tempfile.gettempdir(), "pdnlp_tpu_profiles"))
        self.max_seconds = max_seconds
        self._profiler = profiler
        self._lock = threading.Lock()
        self._seq = 0

    def _get_profiler(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    def capture(self, seconds: float, profiler=None) -> Dict:
        """Capture one ``seconds``-long trace; returns ``{"path": ...,
        "seconds": ...}``. Raises :class:`ProfileInProgressError` if a capture
        is already running, ValueError for an out-of-range window.
        ``profiler`` overrides this guard's own for one capture (the serving
        API's, bound to its engine loop) under the same guard."""
        if not seconds > 0:
            raise ValueError(f"seconds must be > 0, got {seconds}")
        if seconds > self.max_seconds:
            raise ValueError(f"seconds={seconds} exceeds max_seconds={self.max_seconds}")
        if not self._lock.acquire(blocking=False):
            raise ProfileInProgressError("a profile capture is already in progress")
        try:
            profiler = profiler or self._get_profiler()
            self._seq += 1
            path = os.path.join(
                self.base_dir, f"profile-{int(time.time())}-{self._seq}")
            os.makedirs(path, exist_ok=True)
            profiler.start_trace(path)
            try:
                time.sleep(seconds)
            finally:
                profiler.stop_trace()
            return {"path": path, "seconds": seconds}
        finally:
            self._lock.release()


#: process-wide capture guard: the profiler is process-global, so every HTTP
#: plane in the process must share ONE one-at-a-time gate or two planes could
#: start overlapping captures
PROFILE_CAPTURE = ProfileCapture()


def handle_profile_request(path: str, capture: ProfileCapture = PROFILE_CAPTURE,
                           profiler=None):
    """Shared POST handler for ``/debug/profile?seconds=S``: returns
    ``(status, content_type, body_bytes)`` or None if the path doesn't match.
    ``profiler`` is passed on to :meth:`ProfileCapture.capture`."""
    parts = urlsplit(path)
    if parts.path != "/debug/profile":
        return None
    raw = parse_qs(parts.query).get("seconds", ["1.0"])[0]
    try:
        seconds = float(raw)
    except ValueError:
        return (400, "application/json",
                json.dumps({"error": f"seconds must be a number, got {raw!r}"}).encode())
    try:
        result = capture.capture(seconds, profiler)
    except ProfileInProgressError as e:
        return (409, "application/json",
                json.dumps({"error": str(e), "type": "profile_in_progress"}).encode())
    except ValueError as e:
        return (400, "application/json",
                json.dumps({"error": str(e), "type": "invalid_request"}).encode())
    except Exception as e:  # profiler backend failure
        logger.warning(f"observability: profile capture failed: {e!r}")
        return (500, "application/json",
                json.dumps({"error": repr(e), "type": "profile_failed"}).encode())
    return 200, "application/json", json.dumps(result).encode()
