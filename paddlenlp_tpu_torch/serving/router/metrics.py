"""Router metrics catalog + fleet metrics federation.

Same contract as :class:`~..engine_loop.ServingMetrics` for the replica plane:
names are stable API — the serving README catalog, ``tools/check_metrics.py``
(which instantiates this class so tier-1 lints the exposition) and
``tools/bench_serve.py --replicas N`` all consume them by string.

Federation (:func:`federate_expositions`): the router scrapes each replica's
``/metrics`` and merges the expositions into one, every sample re-labeled with
``{replica="<id>"}`` — "how is the fleet doing" becomes one scrape instead of
N. HELP/TYPE come from the first replica exposing each family;
:func:`lint_federation` catches the two ways a merge can lie (the same family
exposed with conflicting TYPEs across replicas, and a replica that already
carries a ``replica`` label, which the re-labeling would silently clobber).

A copy of ``paddlenlp_tpu/serving/router/metrics.py``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

from ...observability.prometheus import parse_prometheus_text
from ..metrics import REGISTRY, MetricsRegistry, _format_labels, _format_value

__all__ = ["RouterMetrics", "AutoscalerMetrics", "ROUTE_DECISION_BUCKETS",
           "federate_expositions", "federate_families", "lint_federation"]

# seconds; routing decisions are pure host work (snapshot + sort/hash), so the
# interesting range is tens of microseconds to a few milliseconds — the default
# latency buckets would dump every observation into the first bucket
ROUTE_DECISION_BUCKETS: Tuple[float, ...] = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.05, 0.1,
)


class RouterMetrics:
    """Registers the router metric catalog in one registry.

    Push-mode only: the pool's health poller writes ``replica_healthy`` on
    every poll, and the proxy writes the request/failover counters at request
    terminal — there is no engine to bind pull gauges against."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = r = registry or REGISTRY
        self.requests = r.counter(
            "paddlenlp_router_requests_total",
            "Requests terminated by the router, by backing replica and outcome",
            labelnames=("replica", "outcome"))
        self.replica_healthy = r.gauge(
            "paddlenlp_router_replica_healthy",
            "1 when the replica's last health poll was HEALTHY, else 0",
            labelnames=("replica",))
        self.failovers = r.counter(
            "paddlenlp_router_failovers_total",
            "In-flight requests resubmitted to another replica after their "
            "replica failed before emitting a token")
        self.rerouted = r.counter(
            "paddlenlp_router_rerouted_total",
            "Forward attempts re-routed to the next candidate on a replica "
            "429/503 or connect failure (nothing relayed yet)")
        self.route_decision = r.histogram(
            "paddlenlp_router_route_decision_seconds",
            "Latency of one routing decision (pool snapshot + policy ordering)",
            buckets=ROUTE_DECISION_BUCKETS)
        self.health_polls = r.counter(
            "paddlenlp_router_health_polls_total",
            "Health-poller probes by replica and outcome (ok/degraded/error)",
            labelnames=("replica", "outcome"))
        self.fleet_scrape_errors = r.counter(
            "paddlenlp_router_fleet_scrape_errors_total",
            "Replica /metrics scrapes that failed during federation",
            labelnames=("replica",))
        self.hedges = r.counter(
            "paddlenlp_router_hedges_total",
            "Hedged stream attempts by outcome: primary_won/hedge_won (the "
            "shadow fired and lost/won the first-token race), capped (the "
            "in-flight-hedge cap suppressed it, counted at hedge-fire time), "
            "brownout (a leg's brownout level >= 2 suppressed the race, "
            "counted once per request at candidate selection), failed (both "
            "legs died)",
            labelnames=("outcome",))
        self.membership_changes = r.counter(
            "paddlenlp_router_membership_changes_total",
            "Admin-plane replica membership mutations by op (add/drain/remove)",
            labelnames=("op",))
        self.version_skew_terminations = r.counter(
            "paddlenlp_router_version_skew_total",
            "Token-bearing streams terminated in-band with "
            "finish_reason=version_skew because a weight rollout left no "
            "surviving replica on the stream's weights version")
        # same family name the replicas' ServingMetrics registers: the router
        # contributes the hedge_race phase (time from shadow launch to the
        # first usable event) so one histogram family carries the whole
        # attribution vocabulary across tiers
        self.latency_attribution = r.histogram(
            "paddlenlp_serving_latency_attribution_seconds",
            "Per-request e2e latency decomposed by phase (queue/"
            "admission_gate/prefill/chunk_stall/migration_wait/decode on "
            "replicas; hedge_race on the router) — phases sum to e2e",
            labelnames=("phase",))


class AutoscalerMetrics:
    """The ``paddlenlp_router_autoscaler_*`` catalog — one instance per
    :class:`~.autoscaler.Autoscaler` control loop. Push-mode: the loop stamps
    every decision; the replica gauges track the last observation."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = r = registry or REGISTRY
        self.decisions = r.counter(
            "paddlenlp_router_autoscaler_decisions_total",
            "Autoscaler control-loop decisions by action "
            "(up/down/replace/hold)",
            labelnames=("action",))
        self.replicas = r.gauge(
            "paddlenlp_router_autoscaler_replicas",
            "Live (non-draining) replicas the autoscaler observed on its "
            "last evaluation")
        self.target_envelope = r.gauge(
            "paddlenlp_router_autoscaler_envelope",
            "Configured min/max replica envelope bounds",
            labelnames=("bound",))
        self.provision_failures = r.counter(
            "paddlenlp_router_autoscaler_provision_failures_total",
            "Provision attempts that failed (each retries with backoff on a "
            "later control-loop tick)")
        self.brownout_pushes = r.counter(
            "paddlenlp_router_autoscaler_brownout_pushes_total",
            "Brownout floors pushed to replicas while holding at the max "
            "envelope under sustained overload")


# ----------------------------------------------------------------- federation
# rendering reuses the registry's own exposition formatters (_format_labels /
# _format_value from ..metrics) so the federated plane cannot drift from the
# per-process one on escaping or float rendering


def _sample_key(item):
    """Sort key for one family's samples: sample name, then labelset, then
    ascending numeric ``le`` (+Inf last) so histogram bucket lines come out in
    the cumulative order the exposition format expects."""
    (sample_name, labels), _v = item
    rest = sorted((k, v) for k, v in labels if k != "le")
    le = dict(labels).get("le")
    if le is None:
        le_f = -math.inf
    elif le == "+Inf":
        le_f = math.inf
    else:
        try:
            le_f = float(le)
        except ValueError:
            le_f = math.inf
    return sample_name, rest, le_f


def federate_expositions(expositions: Mapping[str, str]) -> str:
    """Merge per-replica Prometheus expositions into one, each sample
    re-labeled with ``replica="<id>"``.

    ``expositions`` maps replica id -> exposition text (unreachable replicas
    are simply absent — federation is partial by design, never an error).
    Raises ValueError on unparseable text; a caller that must stay partial
    under malformed input (the router) parses per replica itself and feeds
    :func:`federate_families`."""
    return federate_families(
        {rid: parse_prometheus_text(text) for rid, text in expositions.items()})


def federate_families(parsed: Mapping[str, Dict]) -> str:
    """:func:`federate_expositions` over already-parsed families
    (``{replica_id: parse_prometheus_text(...) output}``) — the router's path,
    which parses each scrape once and reuses the families for the SLO fold.
    Histogram ``le`` labels are kept last so bucket lines stay conventional;
    a pre-existing ``replica`` label is overwritten (and flagged by
    :func:`lint_federation`)."""
    names: List[str] = []
    for fams in parsed.values():
        for name in fams:
            if name not in names:
                names.append(name)
    lines: List[str] = []
    for name in sorted(names):
        help_text = type_text = None
        for fams in parsed.values():
            fam = fams.get(name)
            if fam is None:
                continue
            if help_text is None and fam.help:
                help_text = fam.help
            if type_text is None and fam.type:
                type_text = fam.type
        if help_text is not None:
            lines.append(f"# HELP {name} {help_text}")
        if type_text is not None:
            lines.append(f"# TYPE {name} {type_text}")
        for rid in sorted(parsed):
            fam = parsed[rid].get(name)
            if fam is None:
                continue
            for (sample_name, labels), value in sorted(
                    fam.samples.items(), key=_sample_key):
                pairs = [(k, v) for k, v in sorted(labels) if k not in ("replica", "le")]
                pairs.insert(0, ("replica", rid))
                le = dict(labels).get("le")
                if le is not None:
                    pairs.append(("le", le))
                lines.append(f"{sample_name}{_format_labels(pairs)} {_format_value(value)}")
    return "\n".join(lines) + "\n"


def lint_federation(expositions: Mapping[str, str]) -> List[str]:
    """Problems a federated merge would paper over (empty = clean):

    - **duplicate-family conflict**: the same family name exposed with
      different TYPEs across replicas (the merged exposition would attach one
      TYPE to samples of another shape);
    - **label collision**: a replica sample already carrying a ``replica``
      label, which re-labeling overwrites."""
    problems: List[str] = []
    types_seen: Dict[str, Tuple[str, str]] = {}  # family -> (replica, type)
    for rid in sorted(expositions):
        try:
            fams = parse_prometheus_text(expositions[rid])
        except ValueError as e:
            problems.append(f"{rid}: unparseable exposition: {e}")
            continue
        for name, fam in sorted(fams.items()):
            if fam.type:
                prev = types_seen.get(name)
                if prev is not None and prev[1] != fam.type:
                    problems.append(
                        f"{name}: TYPE conflict across replicas "
                        f"({prev[0]}={prev[1]!r} vs {rid}={fam.type!r})")
                else:
                    types_seen.setdefault(name, (rid, fam.type))
            for (_sample, labels) in fam.samples:
                if "replica" in dict(labels):
                    problems.append(
                        f"{name}: {rid} sample already carries a replica label "
                        f"(federation would overwrite it)")
                    break
    return problems
