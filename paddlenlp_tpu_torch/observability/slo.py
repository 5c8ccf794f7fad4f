"""SLO plane: multi-window availability and TTFT burn rates over the fleet.

"Is the fleet OK" is not a gauge — it is a *rate of error-budget spend*. This
module turns the federated replica counters into the two numbers an on-call
actually pages on (the multi-window burn-rate method from the SRE workbook):

- **availability**: fraction of finished requests that did not terminate in a
  server-side failure (``engine_error`` — the supervisor gave up — or
  ``capacity`` — the request could never fit). Client aborts and clean
  stop/length finishes are *good*; shedding (429/503) never reaches these
  counters because the request was not accepted.
- **TTFT latency**: fraction of requests whose time-to-first-token stayed
  under the objective threshold, read from the ``paddlenlp_serving_ttft_seconds``
  histogram (exact when the threshold sits on a bucket bound; otherwise the
  next-lower bound is used, which *over*-counts violations — the safe side).

For each window W the burn rate is ``(bad rate over W) / (error budget)``:
burn 1.0 = spending exactly the budget the objective allows, 10+ = page now.
Rates need history, so the tracker keeps a pruned deque of cumulative-counter
observations; a window that reaches past recorded history falls back to the
process-start baseline (all-zero counters), so the very first scrape already
reports meaningful lifetime numbers.

Everything is stdlib-only and registry-agnostic: the router feeds it federated
expositions, tests feed it synthetic ones, and the ``paddlenlp_slo_*`` gauges
land in whatever registry the caller owns. A copy of
``paddlenlp_tpu/observability/slo.py``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["SLOObjectives", "SLOTracker", "SLOInputs", "slo_inputs_from_families",
           "ERROR_STATUSES", "DEFAULT_WINDOWS_S"]

#: replica-side terminal states that spend availability error budget
ERROR_STATUSES = ("engine_error", "capacity", "unknown")

#: multi-window burn rates per the SRE-workbook alerting ladder (fast burn on
#: the short window, slow burn on the long one)
DEFAULT_WINDOWS_S: Tuple[float, ...] = (60.0, 300.0, 3600.0)

REQUESTS_METRIC = "paddlenlp_serving_requests_total"
TTFT_METRIC = "paddlenlp_serving_ttft_seconds"


@dataclasses.dataclass(frozen=True)
class SLOObjectives:
    """The objectives burn rates are computed against.

    ``availability``: target fraction of accepted requests finishing without a
    server-side failure. ``ttft_threshold_s``/``ttft_quantile``: "``quantile``
    of requests see first token within ``threshold`` seconds" (the p99-TTFT
    objective)."""

    availability: float = 0.999
    ttft_threshold_s: float = 1.0
    ttft_quantile: float = 0.99

    def __post_init__(self):
        for name, v in (("availability", self.availability),
                        ("ttft_quantile", self.ttft_quantile)):
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v}")
        if not self.ttft_threshold_s > 0:
            raise ValueError(f"ttft_threshold_s must be > 0, got {self.ttft_threshold_s}")


@dataclasses.dataclass(frozen=True)
class SLOInputs:
    """One observation of the fleet's cumulative counters."""

    total: float = 0.0          # finished requests
    errors: float = 0.0         # finished in an ERROR_STATUSES state
    ttft_count: float = 0.0     # TTFT observations
    ttft_violations: float = 0.0  # TTFT observations above the threshold

    def __add__(self, other: "SLOInputs") -> "SLOInputs":
        return SLOInputs(
            total=self.total + other.total,
            errors=self.errors + other.errors,
            ttft_count=self.ttft_count + other.ttft_count,
            ttft_violations=self.ttft_violations + other.ttft_violations)


def slo_inputs_from_families(families: Dict, objectives: SLOObjectives) -> SLOInputs:
    """Fold a parsed (federated) exposition into cumulative SLO inputs.

    ``families`` is ``parse_prometheus_text`` output — per-replica labels just
    sum away. TTFT violations come from histogram buckets: good = cumulative
    count at the largest bucket bound <= threshold (per labelset, so replicas
    with different bucket layouts still sum correctly)."""
    total = errors = 0.0
    req = families.get(REQUESTS_METRIC)
    if req is not None:
        for (_sample, labels), v in req.samples.items():
            total += v
            if dict(labels).get("status") in ERROR_STATUSES:
                errors += v
    ttft_count = good = 0.0
    ttft = families.get(TTFT_METRIC)
    if ttft is not None:
        # group bucket samples by their non-le labelset (one vector per replica)
        series: Dict[frozenset, List[Tuple[float, float]]] = {}
        for (sample_name, labels), v in ttft.samples.items():
            if sample_name.endswith("_count"):
                ttft_count += v
            elif sample_name.endswith("_bucket"):
                le = dict(labels).get("le")
                if le is None:
                    continue
                le_f = math.inf if le == "+Inf" else float(le)
                series.setdefault(labels - {("le", le)}, []).append((le_f, v))
        for buckets in series.values():
            under = [c for le, c in buckets if le <= objectives.ttft_threshold_s]
            if under:
                good += max(under)
    return SLOInputs(total=total, errors=errors, ttft_count=ttft_count,
                     ttft_violations=max(ttft_count - good, 0.0))


class SLOTracker:
    """Windowed burn-rate computer over cumulative counter observations.

    Feed :meth:`observe` one :class:`SLOInputs` per scrape; :meth:`report`
    returns the JSON-ready summary and (when a registry was given) refreshes
    the ``paddlenlp_slo_*`` gauge series. ``now`` is injectable everywhere so
    tests drive synthetic timelines."""

    def __init__(self, objectives: Optional[SLOObjectives] = None,
                 windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
                 registry=None, max_points: int = 4096,
                 fast_burn_threshold: float = 10.0):
        if not windows_s or any(w <= 0 for w in windows_s):
            raise ValueError(f"windows_s must be positive, got {windows_s}")
        self.objectives = objectives or SLOObjectives()
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        self.max_points = max_points
        # fast-burn trigger hook: when the SHORTEST window's burn rate crosses
        # the threshold (the SRE-workbook "page now" line), report() invokes
        # ``on_fast_burn(kind, burn_rate, window_label)`` — the router wires a
        # postmortem dump here so the incident snapshots itself (the dumper
        # owns rate limiting; a sustained burn re-fires every report)
        self.fast_burn_threshold = fast_burn_threshold
        self.on_fast_burn: Optional[Callable[[str, float, str], None]] = None
        self._history: deque = deque()  # (t, SLOInputs), oldest first
        self._baseline = SLOInputs()  # process start: all-zero counters
        self._reset_pending = False  # one unconfirmed total-shrink seen
        # observe/report run from concurrent HTTP handler threads (every
        # /fleet/slo scrape is one of each) — the deque needs one lock
        self._lock = threading.Lock()
        self.registry = registry
        if registry is not None:
            self._register(registry)

    def _register(self, r):
        self.g_availability = r.gauge(
            "paddlenlp_slo_availability",
            "Fraction of finished requests without a server-side failure, per window",
            labelnames=("window",))
        self.g_avail_burn = r.gauge(
            "paddlenlp_slo_availability_burn_rate",
            "Availability error-budget burn rate per window (1.0 = budget-neutral)",
            labelnames=("window",))
        self.g_ttft_violation = r.gauge(
            "paddlenlp_slo_ttft_violation_rate",
            "Fraction of requests whose TTFT exceeded the objective threshold, per window",
            labelnames=("window",))
        self.g_ttft_burn = r.gauge(
            "paddlenlp_slo_ttft_burn_rate",
            "TTFT error-budget burn rate per window (1.0 = budget-neutral)",
            labelnames=("window",))
        self.g_avail_objective = r.gauge(
            "paddlenlp_slo_availability_objective",
            "Configured availability objective")
        self.g_ttft_threshold = r.gauge(
            "paddlenlp_slo_ttft_threshold_seconds",
            "Configured TTFT objective threshold")
        self.g_ttft_quantile = r.gauge(
            "paddlenlp_slo_ttft_quantile_objective",
            "Configured fraction of requests that must meet the TTFT threshold")
        self.g_avail_objective.set(self.objectives.availability)
        self.g_ttft_threshold.set(self.objectives.ttft_threshold_s)
        self.g_ttft_quantile.set(self.objectives.ttft_quantile)

    # ------------------------------------------------------------- observe
    def observe(self, inputs: SLOInputs, now: float):
        """Record one cumulative-counter observation at time ``now``.

        A shrinking total means either a counter reset (a replica restart) —
        deltas across it would go negative and report phantom recovery — or a
        transient scrape blip (one replica skipped from the federated merge
        for a single scrape). The two are indistinguishable from one point, so
        a first shrink only *drops* the observation; a second consecutive one
        confirms the reset and clears history. A blip therefore costs one
        observation, not the whole burn-rate history."""
        with self._lock:
            if self._history and inputs.total < self._history[-1][1].total:
                if not self._reset_pending:
                    self._reset_pending = True
                    return
                self._history.clear()
                self._baseline = SLOInputs()
            self._reset_pending = False
            self._history.append((now, inputs))
            horizon = now - self.windows_s[-1]
            # keep ONE point at-or-before the horizon as the long window's baseline
            while len(self._history) > 1 and self._history[1][0] <= horizon:
                self._history.popleft()
            while len(self._history) > self.max_points:
                self._history.popleft()

    def _baseline_for(self, window_s: float, now: float) -> SLOInputs:
        """Latest observation at or before ``now - window_s``; falls back to
        the process-start zero baseline when the window outruns history.
        Caller holds ``_lock``."""
        cutoff = now - window_s
        best = None
        for t, inputs in self._history:
            if t <= cutoff:
                best = inputs
            else:
                break
        return best if best is not None else self._baseline

    # ------------------------------------------------------------- report
    def report(self, now: Optional[float] = None) -> Dict:
        """Per-window availability/TTFT rates and burn rates from the latest
        observation. Empty windows (no new requests) report availability 1.0
        and burn 0.0 — no traffic spends no budget."""
        with self._lock:
            if not self._history:
                return {"objectives": dataclasses.asdict(self.objectives), "windows": {}}
            t_last, latest = self._history[-1]
            now = now if now is not None else t_last
            baselines = {w: self._baseline_for(w, now) for w in self.windows_s}
        avail_budget = 1.0 - self.objectives.availability
        ttft_budget = 1.0 - self.objectives.ttft_quantile
        windows: Dict[str, Dict] = {}
        for w in self.windows_s:
            base = baselines[w]
            # clamped: one replica's counter reset can hide inside a still-
            # growing fleet total (others grew more), leaving individual
            # deltas negative — availability > 1 / negative burn is nonsense
            d_total = max(latest.total - base.total, 0.0)
            d_errors = max(latest.errors - base.errors, 0.0)
            d_ttft = max(latest.ttft_count - base.ttft_count, 0.0)
            d_viol = max(latest.ttft_violations - base.ttft_violations, 0.0)
            err_rate = d_errors / d_total if d_total > 0 else 0.0
            viol_rate = d_viol / d_ttft if d_ttft > 0 else 0.0
            label = f"{int(w)}s"
            row = {
                "requests": d_total,
                "availability": 1.0 - err_rate,
                "availability_burn_rate": err_rate / avail_budget,
                "ttft_observations": d_ttft,
                "ttft_violation_rate": viol_rate,
                "ttft_burn_rate": viol_rate / ttft_budget,
            }
            windows[label] = row
            if self.registry is not None:
                self.g_availability.set(row["availability"], window=label)
                self.g_avail_burn.set(row["availability_burn_rate"], window=label)
                self.g_ttft_violation.set(row["ttft_violation_rate"], window=label)
                self.g_ttft_burn.set(row["ttft_burn_rate"], window=label)
        self._check_fast_burn(windows)
        return {
            "objectives": dataclasses.asdict(self.objectives),
            "totals": dataclasses.asdict(latest),
            "windows": windows,
        }

    def _check_fast_burn(self, windows: Dict[str, Dict]):
        """Invoke the fast-burn hook when the shortest window is burning past
        the threshold. Best-effort: a broken hook must never take down the
        SLO plane it is meant to explain."""
        if self.on_fast_burn is None or not windows:
            return
        label = f"{int(self.windows_s[0])}s"
        row = windows.get(label)
        if row is None:
            return
        for kind, key in (("availability", "availability_burn_rate"),
                          ("ttft", "ttft_burn_rate")):
            burn = row.get(key, 0.0)
            if burn >= self.fast_burn_threshold:
                try:
                    self.on_fast_burn(kind, burn, label)
                except Exception as e:
                    import logging

                    logging.getLogger(__name__).warning(
                        f"SLO fast-burn hook failed: {e!r}")
                break  # one trigger per report; the dumper's bundle covers both
