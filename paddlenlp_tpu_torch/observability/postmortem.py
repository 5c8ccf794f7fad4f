"""Auto-dumped postmortem bundles: one self-contained JSON per incident.

When something goes wrong in production serving — a supervisor degrade, a
slot quarantine, a drain-deadline eviction, an SLO fast burn — the state that
explains it is spread across four in-process planes: the flight recorder's
decision events, the span tracer's timing ring, the live ``stats()``/health
snapshot and the metrics registry. All four are rings or gauges: wait an hour
and the evidence is gone. A :class:`PostmortemDumper` snapshots all of them
into ONE JSON bundle the moment a trigger fires, so the incident is
debuggable offline (``tools/postmortem.py`` reconstructs per-request
cross-tier timelines from it).

Dump policy:

- **auto triggers** (supervisor degrade, quarantine, drain eviction, SLO fast
  burn) write only when ``PDNLP_TPU_POSTMORTEM_DIR`` is set (or an explicit
  ``out_dir`` was given) — an operator opts into the disk writes — and are
  rate-limited (``min_interval_s``, default 30s) so a crash loop produces a
  bundle per window, not a bundle per failure;
- **on-demand** (``POST /debug/postmortem`` on any of the three HTTP planes,
  or ``dump(..., force=True)``) bypasses both the rate limit and the env
  gate, falling back to ``$TMPDIR/pdnlp_tpu_postmortems``.

Dumping is best-effort by contract: every provider is guarded, and a failed
dump logs and returns None — the serving path must never die of its own
black box. Files are written via :func:`~..utils.fileio.atomic_write` so a
reader only ever sees a complete bundle.

**Concurrency model.** ``dump`` may be called from the engine-loop thread
(auto triggers) and HTTP handler threads (on demand) concurrently; the
rate-limit clock is guarded by ``_lock`` (``# guarded-by:`` annotations) and
only AUTO dumps consume its slot (a forced on-demand dump never suppresses
the next incident's bundle). The snapshot itself runs outside the lock —
two concurrent forced dumps produce two bundles, which is fine.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import tempfile
import threading
import time
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlsplit

from ..utils.fileio import atomic_write
from ..utils.log import logger
from .flight_recorder import RECORDER, FlightRecorder
from .tracer import TRACER, SpanTracer

__all__ = ["PostmortemDumper", "handle_postmortem_request", "ENV_DIR",
           "BUNDLE_VERSION"]

ENV_DIR = "PDNLP_TPU_POSTMORTEM_DIR"
BUNDLE_VERSION = 1


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "pdnlp_tpu_postmortems")


#: process-wide filename counter: several dumpers can live in one process (an
#: in-process fleet has one per replica loop plus the router's), and pid +
#: per-dumper seq alone would let two of them collide within one second
_FILE_SEQ = itertools.count(1)


class PostmortemDumper:
    """Snapshots events + spans + health + metrics + config into one JSON.

    ``health_fn``/``config_fn`` are caller-provided callables returning
    JSON-able dicts (engine ``stats()`` + loop state on a replica, pool
    snapshots on the router); ``tier`` labels which plane dumped the bundle
    so the offline analyzer can tell router bundles from replica bundles."""

    def __init__(self, registry=None, tracer: Optional[SpanTracer] = None,
                 recorder: Optional[FlightRecorder] = None,
                 health_fn: Optional[Callable[[], Dict]] = None,
                 config_fn: Optional[Callable[[], Dict]] = None,
                 out_dir: Optional[str] = None,
                 min_interval_s: float = 30.0, tier: str = "replica"):
        self.registry = registry
        # explicit None checks: both rings define __len__, so an EMPTY
        # tracer/recorder is falsy and `x or DEFAULT` would silently swap in
        # the process-wide instance
        self.tracer = tracer if tracer is not None else TRACER
        self.recorder = recorder if recorder is not None else RECORDER
        self.health_fn = health_fn
        self.config_fn = config_fn
        self._out_dir = out_dir  # None: resolve PDNLP_TPU_POSTMORTEM_DIR at dump time
        self.min_interval_s = min_interval_s
        self.tier = tier
        self._lock = threading.Lock()
        self._last_dump_t = -float("inf")  # guarded-by: _lock
        self.dumps = 0  # bundles written (monotone; surfaced in stats/tests)
        self.suppressed = 0  # auto triggers swallowed by the rate limit / env gate
        self.last_path: Optional[str] = None

    # ------------------------------------------------------------- building
    def _guarded(self, fn: Optional[Callable[[], Dict]]) -> Dict:
        if fn is None:
            return {}
        try:
            return fn()
        except Exception as e:  # a broken provider must not kill the dump
            return {"error": repr(e)}

    def build_bundle(self, trigger: str, detail: Optional[Dict] = None) -> Dict:
        """The bundle document (also what ``POST /debug/postmortem`` writes).
        Self-contained by design: events, spans, health, a full metrics
        scrape and the config snapshot all ride in one JSON object."""
        metrics = ""
        if self.registry is not None:
            try:
                metrics = self.registry.expose()
            except Exception as e:
                metrics = f"# scrape failed: {e!r}"
        return {
            "version": BUNDLE_VERSION,
            "tier": self.tier,
            "trigger": trigger,
            "detail": detail or {},
            "wall_time": time.time(),
            "monotonic_now": self.recorder.now(),
            "pid": os.getpid(),
            "events": self.recorder.to_dicts(),
            "events_dropped": self.recorder.dropped,
            "spans": [s.to_dict() for s in self.tracer.snapshot()],
            "spans_dropped": self.tracer.dropped,
            "health": self._guarded(self.health_fn),
            "config": self._guarded(self.config_fn),
            "metrics": metrics,
        }

    # ------------------------------------------------------------- dumping
    def dump(self, trigger: str, detail: Optional[Dict] = None,
             force: bool = False) -> Optional[str]:
        """Write one bundle; returns its path, or None when suppressed (rate
        limit / env gate) or failed. ``force=True`` (the on-demand HTTP path)
        bypasses suppression."""
        out_dir = self._out_dir or os.environ.get(ENV_DIR)
        now = time.time()
        with self._lock:
            prev_t = self._last_dump_t
            if not force:
                if out_dir is None or now - self._last_dump_t < self.min_interval_s:
                    self.suppressed += 1
                    return None
                # only auto dumps consume the rate-limit slot: a forced
                # on-demand dump (operator curl, monitoring scrape) must not
                # suppress the next incident's auto bundle
                self._last_dump_t = now
        if out_dir is None:
            out_dir = _default_dir()
        try:
            bundle = self.build_bundle(trigger, detail)
            os.makedirs(out_dir, exist_ok=True)
            # trigger may be caller-supplied (?trigger=<label>): sanitize the
            # filename component so a slash/space label can't break the write
            # (the bundle itself keeps the original string)
            trig = re.sub(r"[^A-Za-z0-9_.-]", "_", trigger) or "unknown"
            path = os.path.join(
                out_dir, f"postmortem-{self.tier}-{trig}-{int(now)}"
                         f"-{os.getpid()}-{next(_FILE_SEQ)}.json")
            with atomic_write(path) as f:
                json.dump(bundle, f, default=str)
            self.dumps += 1
            self.last_path = path
            logger.warning(f"postmortem bundle dumped: {path} (trigger={trigger})")
            return path
        except Exception as e:  # best-effort: the black box must not crash the plane
            if not force:
                with self._lock:
                    # release the slot a failed write claimed so the next auto
                    # trigger inside the window still produces a bundle
                    if self._last_dump_t == now:
                        self._last_dump_t = prev_t
            logger.warning(f"postmortem dump failed (trigger={trigger}): {e!r}")
            return None


def handle_postmortem_request(path: str, dumper: PostmortemDumper):
    """Shared POST handler for ``/debug/postmortem[?trigger=<label>]`` —
    returns ``(status, content_type, body_bytes)`` or None if the path
    doesn't match. All three HTTP planes (serving API, router, training
    exporter) dispatch through here, like the profile endpoint."""
    parts = urlsplit(path)
    if parts.path != "/debug/postmortem":
        return None
    trigger = parse_qs(parts.query).get("trigger", ["on_demand"])[0]
    out = dumper.dump(trigger, force=True)
    if out is None:
        return (500, "application/json",
                json.dumps({"error": "postmortem dump failed (see server log)",
                            "type": "postmortem_failed"}).encode())
    return (200, "application/json",
            json.dumps({"path": out, "trigger": trigger,
                        "tier": dumper.tier}).encode())
