"""Prometheus text-format 0.0.4 parsing + exposition lint.

The consumer side of ``serving.metrics.MetricsRegistry.expose()``: the bench
harness scrapes ``/metrics`` over HTTP and folds KV utilization / preemptions /
latency percentiles into its one-line JSON, and ``tools/check_metrics.py``
lints the full metric catalog (HELP/TYPE present, names legal, histogram
buckets cumulative) so a real Prometheus scraper never chokes on us. Stdlib
only — usable from tools without torch. A copy of
``paddlenlp_tpu/observability/prometheus.py``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["MetricFamily", "parse_prometheus_text", "histogram_quantile", "lint_exposition"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
# sample line: name{l1="v1",l2="v2"} value [timestamp]
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})?\s+(\S+)(\s+\d+)?$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class MetricFamily:
    """One metric family: TYPE/HELP plus its samples.

    ``samples`` maps ``(sample_name, frozenset(label items))`` -> float; the
    sample name keeps histogram suffixes (``_bucket``/``_sum``/``_count``).
    """

    def __init__(self, name: str):
        self.name = name
        self.help: Optional[str] = None
        self.type: Optional[str] = None
        self.samples: Dict[Tuple[str, frozenset], float] = {}

    def value(self, sample_name: Optional[str] = None, **labels) -> Optional[float]:
        key = (sample_name or self.name, frozenset(labels.items()))
        return self.samples.get(key)


def _unescape_label(v: str) -> str:
    """Inverse of the exposition escaping (exactly ``\\\\``, ``\\"``, ``\\n`` —
    the format defines no other sequences, and codec-based unescaping like
    unicode_escape corrupts non-ASCII values)."""
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt in ('\\', '"'):
                out.append(nxt)
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    if raw == "NaN":
        return math.nan
    return float(raw)


def _family_name(sample_name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            return sample_name[: -len(suffix)]
    return sample_name


def parse_prometheus_text(text: str) -> Dict[str, MetricFamily]:
    """Parse an exposition into {family name: MetricFamily}. Histogram
    ``_bucket``/``_sum``/``_count`` samples fold into their base family when a
    ``# TYPE <base> histogram`` line announced it."""
    families: Dict[str, MetricFamily] = {}
    histogram_bases = set()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(None, 1)
            fam = families.setdefault(parts[0], MetricFamily(parts[0]))
            fam.help = parts[1] if len(parts) > 1 else ""
        elif line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(None, 1)
            fam = families.setdefault(parts[0], MetricFamily(parts[0]))
            fam.type = parts[1].strip() if len(parts) > 1 else ""
            if fam.type == "histogram":
                histogram_bases.add(parts[0])
        elif line.startswith("#"):
            continue
        else:
            m = _SAMPLE_RE.match(line)
            if not m:
                raise ValueError(f"unparseable sample line: {line!r}")
            sample_name, _, labels_raw, value_raw, _ = m.groups()
            base = _family_name(sample_name)
            name = base if base in histogram_bases else sample_name
            fam = families.setdefault(name, MetricFamily(name))
            labels = frozenset(
                (k, _unescape_label(v))
                for k, v in _LABEL_PAIR_RE.findall(labels_raw or "")
            )
            fam.samples[(sample_name, labels)] = _parse_value(value_raw)
    return families


def histogram_quantile(fam: MetricFamily, q: float, **labels) -> float:
    """Bucket-upper-bound quantile from a parsed histogram family (the same
    estimate ``serving.metrics.Histogram.percentile`` computes in-process)."""
    buckets: List[Tuple[float, float]] = []  # (le, cumulative count)
    want = frozenset(labels.items())
    for (sample_name, lbls), value in fam.samples.items():
        if not sample_name.endswith("_bucket"):
            continue
        le = dict(lbls).get("le")
        if le is None or not (lbls - {("le", le)} == want):
            continue
        buckets.append((_parse_value(le), value))
    buckets.sort()
    if not buckets:
        return 0.0
    total = buckets[-1][1]
    if total == 0:
        return 0.0
    target = q * total
    prev_le = 0.0
    for le, cum in buckets:
        if cum >= target:
            return prev_le if math.isinf(le) else le
        if not math.isinf(le):
            prev_le = le
    return prev_le


def lint_exposition(text: str) -> List[str]:
    """Return a list of problems (empty = clean):

    - sample lines must parse and carry legal metric/label names;
    - every sample's family needs a ``# TYPE`` line, and HELP where given must
      precede samples of that family;
    - every family with a TYPE must have a non-empty HELP;
    - histogram families need ``_sum``/``_count`` and a ``+Inf`` bucket with
      non-decreasing cumulative counts;
    - counter samples must be finite and >= 0.
    """
    problems: List[str] = []
    try:
        families = parse_prometheus_text(text)
    except ValueError as e:
        return [str(e)]

    typed = {n for n, f in families.items() if f.type}
    for name, fam in sorted(families.items()):
        if not _NAME_RE.match(name):
            problems.append(f"{name}: illegal metric name")
        for (sample_name, labels) in fam.samples:
            for k, _ in labels:
                if not _LABEL_RE.match(k) or k.startswith("__"):
                    problems.append(f"{name}: illegal label name {k!r}")
        if fam.samples and name not in typed:
            problems.append(f"{name}: samples without a # TYPE line")
            continue
        if fam.type and not fam.help:
            problems.append(f"{name}: missing # HELP line")
        if fam.type and fam.type not in ("counter", "gauge", "histogram", "summary", "untyped"):
            problems.append(f"{name}: unknown TYPE {fam.type!r}")
        if fam.type == "counter":
            for (sample_name, labels), v in fam.samples.items():
                if math.isnan(v) or math.isinf(v) or v < 0:
                    problems.append(f"{name}: counter sample {sample_name} has value {v}")
        if fam.type == "histogram":
            problems.extend(_lint_histogram(name, fam))
    return problems


def _lint_histogram(name: str, fam: MetricFamily) -> List[str]:
    problems = []
    if not fam.samples:
        # a declared-but-unused labeled histogram (TYPE/HELP, zero series) is
        # valid Prometheus — labeled families expose nothing until observed
        return problems
    sample_names = {s for s, _ in fam.samples}
    for required in (f"{name}_sum", f"{name}_count"):
        if required not in sample_names:
            problems.append(f"{name}: histogram missing {required}")
    # group buckets by their non-le labelset
    series: Dict[frozenset, List[Tuple[float, float]]] = {}
    for (sample_name, labels), v in fam.samples.items():
        if not sample_name.endswith("_bucket"):
            continue
        le = dict(labels).get("le")
        if le is None:
            problems.append(f"{name}: bucket sample without an le label")
            continue
        series.setdefault(labels - {("le", le)}, []).append((_parse_value(le), v))
    if not series:
        problems.append(f"{name}: histogram has no _bucket samples")
    for key, buckets in series.items():
        buckets.sort()
        if not math.isinf(buckets[-1][0]):
            problems.append(f"{name}{dict(key) or ''}: no le=\"+Inf\" bucket")
        last = -1.0
        for le, cum in buckets:
            if cum < last:
                problems.append(
                    f"{name}{dict(key) or ''}: bucket counts not cumulative at le={le}")
                break
            last = cum
    return problems
