"""Shared HTTP observability routes, the on-demand device profile, and the
background HTTP plane of a training job.

Port of ``paddlenlp_tpu/observability/exporter.py``. What the serving API
mounts:

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

:class:`ObservabilityExporter` is the plane of a process without an HTTP
server, a training job (``TrainingArguments.metrics_port``): the routes above
but the profile, plus ``GET /health``, ``GET /debug/efficiency`` and
``POST /debug/postmortem``, on a daemon thread. A training job's profile is
the ``profiler_options`` step window, started and stopped on the training
thread (``utils/profiler.py``): the training loop has no hook an HTTP thread
could run a capture on.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from ..utils.log import logger
from .tracer import TRACER, SpanTracer

__all__ = ["ObservabilityExporter", "route_observability", "ProfileCapture", "ProfileInProgressError",
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


class ObservabilityExporter:
    """Serve ``/metrics`` + ``/health`` + ``/debug/*`` off a daemon thread."""

    def __init__(self, registry=None, tracer: Optional[SpanTracer] = None,
                 health_fn: Optional[Callable[[], Dict]] = None, postmortem=None,
                 efficiency_fn: Optional[Callable[[], Dict]] = None):
        if registry is None:
            from ..serving.metrics import REGISTRY as registry  # stdlib-only module
        self.registry = registry
        self.efficiency_fn = efficiency_fn
        # explicit None check: SpanTracer defines __len__, so an EMPTY tracer
        # passed here is falsy and `tracer or TRACER` would silently serve
        # the process-wide ring instead of the caller's
        self.tracer = tracer if tracer is not None else TRACER
        self.health_fn = health_fn
        if postmortem is None:
            from .postmortem import PostmortemDumper  # avoid import cycle at module load

            postmortem = PostmortemDumper(registry=self.registry, tracer=self.tracer,
                                          health_fn=health_fn, tier="training")
        self.postmortem = postmortem
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd is not None else None

    def efficiency(self) -> Dict:
        """``GET /debug/efficiency`` for this plane: the caller-provided doc,
        else a training-tier default carrying the process compile counters
        (0 here: eager PyTorch compiles nothing) — every plane answers the
        route, even ones without a goodput ledger."""
        if self.efficiency_fn is not None:
            return self.efficiency_fn()
        doc: Dict = {"tier": "training", "ledger": None}
        for key, name in (("compiles", "jax_jit_compile_total"),
                          ("compile_seconds", "jax_jit_compile_seconds_total")):
            metric = self.registry.get(name)
            if metric is not None:
                doc[key] = metric.value()
        return doc

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind + serve in the background; returns the bound port."""
        if self._httpd is not None:
            return self.port
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("observability: " + fmt % args)

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _fail(self, e: Exception):
                logger.warning(f"observability: error on {self.path}: {e!r}")
                try:
                    self._send(500, json.dumps({"error": str(e)}).encode(), "application/json")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                try:
                    routed = route_observability(self.path, exporter.registry, exporter.tracer)
                    if routed is not None:
                        self._send(routed[0], routed[2], routed[1])
                    elif self.path == "/health":
                        payload = {"status": "ok"}
                        if exporter.health_fn is not None:
                            payload.update(exporter.health_fn())
                        self._send(200, json.dumps(payload, default=str).encode(), "application/json")
                    elif self.path == "/debug/efficiency":
                        self._send(200, json.dumps(exporter.efficiency(), default=str).encode(),
                                   "application/json")
                    else:
                        self._send(404, json.dumps({"error": f"no route {self.path}"}).encode(),
                                   "application/json")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("observability: client disconnected")
                except Exception as e:  # exporter must never take the job down
                    self._fail(e)

            def do_POST(self):
                try:
                    # drain any request body before responding: leftover bytes
                    # would desync the next request on a keep-alive connection
                    n = int(self.headers.get("Content-Length") or 0)
                    if n:
                        self.rfile.read(n)
                    from .postmortem import handle_postmortem_request

                    routed = handle_postmortem_request(self.path, exporter.postmortem)
                    if routed is not None:
                        self._send(routed[0], routed[2], routed[1])
                    else:
                        self._send(404, json.dumps({"error": f"no route {self.path}"}).encode(),
                                   "application/json")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("observability: client disconnected")
                except Exception as e:
                    self._fail(e)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True, name="observability-http")
        self._thread.start()
        bound = self._httpd.server_address[1]
        logger.info(f"observability exporter on {host}:{bound} (GET /metrics /health /debug/trace)")
        return bound

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None
