"""Process-wide metrics plane: counters/gauges/histograms + Prometheus text.

Counterpart of the reference serving stack's monitoring hooks (its
``paddlenlp/server`` deploys behind a gateway that scrapes per-process stats);
here a single in-process registry is the source of truth for everything the
serving runtime reports — TTFT, inter-token latency, queue depth, KV-block
utilization, preemptions, speculative acceptance.

Deliberately stdlib-only (no torch, no prometheus_client): the registry must be
importable from trainer callbacks and tools without pulling in a backend, and
the container has no prometheus_client wheel. Exposition follows the
Prometheus text format 0.0.4 so a real scraper can consume ``/metrics``
unchanged.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS",
]

# seconds; spans sub-ms CPU token steps up to multi-minute queue waits
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

LabelKey = Tuple[Tuple[str, str], ...]


def _format_labels(labels: LabelKey) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name}: got labels {sorted(labels)}, want {sorted(self.labelnames)}")
        return tuple((k, str(labels[k])) for k in self.labelnames)

    def expose(self) -> List[str]:  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    """Monotonically increasing count (requests, tokens, preemptions)."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"counter {self.name}: cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [f"{self.name}{_format_labels(k)} {_format_value(v)}" for k, v in items]


class Gauge(_Metric):
    """Point-in-time value (queue depth, slot occupancy, free blocks).

    ``set_function`` registers a pull-mode callable sampled at exposition —
    the natural shape for engine state the serving loop owns (free blocks,
    running slots) where push-updates from the hot loop would just be noise.
    """

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        super().__init__(name, help, labelnames)
        self._values: Dict[LabelKey, float] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels):
        self.inc(-amount, **labels)

    def set_function(self, fn: Callable[[], float]):
        if self.labelnames:
            raise ValueError(f"gauge {self.name}: set_function needs a label-less gauge")
        self._fn = fn

    def remove_series(self, **labels):
        """Drop one labeled series from the exposition — for label values
        that name entities with a bounded lifetime (a removed replica): a
        gauge pinned to its last value would read as a live fact forever."""
        with self._lock:
            self._values.pop(self._key(labels), None)

    def value(self, **labels) -> float:
        if self._fn is not None:
            return float(self._fn())
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        if self._fn is not None:
            try:
                v = float(self._fn())
            except Exception:
                v = float("nan")
            return [f"{self.name} {_format_value(v)}"]
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        return [f"{self.name}{_format_labels(k)} {_format_value(v)}" for k, v in items]


class Histogram(_Metric):
    """Cumulative-bucket histogram (TTFT, inter-token latency, e2e latency)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        b = sorted(float(x) for x in buckets)
        if not b or b[-1] != float("inf"):
            b.append(float("inf"))
        self.buckets = tuple(b)
        # per-labelset: (bucket counts, sum, count)
        self._data: Dict[LabelKey, Tuple[List[int], float, int]] = {}

    def observe(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            counts, total, n = self._data.get(key, ([0] * len(self.buckets), 0.0, 0))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            self._data[key] = (counts, total + value, n + 1)

    def count(self, **labels) -> int:
        with self._lock:
            return self._data.get(self._key(labels), ([], 0.0, 0))[2]

    def sum(self, **labels) -> float:
        with self._lock:
            return self._data.get(self._key(labels), ([], 0.0, 0))[1]

    def percentile(self, q: float, **labels) -> float:
        """Bucket-interpolated percentile (upper bound of the hit bucket) —
        good enough for the smoke benchmark's p50/p99 without storing samples."""
        with self._lock:
            counts, _, n = self._data.get(self._key(labels), ([], 0.0, 0))
            counts = list(counts)
        if n == 0:
            return 0.0
        target = q * n
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= target:
                ub = self.buckets[i]
                return self.buckets[i - 1] if math.isinf(ub) and i > 0 else ub
        return self.buckets[-2] if len(self.buckets) > 1 else 0.0

    def expose(self) -> List[str]:
        with self._lock:
            items = sorted((k, (list(c), s, n)) for k, (c, s, n) in self._data.items())
        if not items and not self.labelnames:
            items = [((), ([0] * len(self.buckets), 0.0, 0))]
        out: List[str] = []
        for key, (counts, total, n) in items:
            cum = 0
            for i, ub in enumerate(self.buckets):
                cum += counts[i]
                le = "+Inf" if math.isinf(ub) else _format_value(ub)
                lk = key + (("le", le),)
                out.append(f"{self.name}_bucket{_format_labels(lk)} {cum}")
            out.append(f"{self.name}_sum{_format_labels(key)} {_format_value(total)}")
            out.append(f"{self.name}_count{_format_labels(key)} {n}")
        return out


class MetricsRegistry:
    """Named-metric registry with Prometheus text exposition.

    ``counter``/``gauge``/``histogram`` are idempotent: re-requesting an
    existing name returns the registered instance (so engine loop, scheduler
    and API can each grab handles without plumbing objects through)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(f"metric {name} already registered as {m.kind}")
                return m
            m = cls(name, help, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames=labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames=labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames=labelnames, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


#: process-wide default registry (the /metrics endpoint serves this)
REGISTRY = MetricsRegistry()
