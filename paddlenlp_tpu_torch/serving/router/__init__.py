"""Multi-replica front tier: health-aware routing, cross-replica failover,
prefix-affinity placement.

The fourth pillar of the serving stack (after the continuous-batching
runtime, the observability layer, and the fault-tolerance supervisor): a
stdlib-only HTTP router that fronts N ``ServingServer`` replicas —

- :mod:`.pool` — replica registry + background health poller
  (HEALTHY → DEGRADED → DOWN → RECOVERING state machine off each replica's
  ``/health`` and ``/metrics`` planes);
- :mod:`.policy` — least-loaded candidate ordering and consistent-hash
  prefix affinity;
- :mod:`.proxy` — ``RouterServer``: SSE passthrough, 429/503 re-routing,
  pre-token failover, in-band ``replica_error`` mid-stream terminal;
- :mod:`.metrics` — the ``paddlenlp_router_*`` catalog;
- :mod:`.launcher` — in-process fleet helpers for tests and the CPU bench;
- :mod:`.autoscaler` — the closed-loop policy thread that watches
  ``/fleet/slo`` + ``/replicas`` and drives the admin plane (scale up/down,
  replace DOWN replicas, brownout handoff at the max envelope).

A copy of ``paddlenlp_tpu/serving/router/`` over the port's serving stack.
No module here imports torch: each replica's engine loop is the only thread
that touches a tensor.
"""

from .autoscaler import (  # noqa: F401
    Autoscaler,
    AutoscalerPolicy,
    FleetObservation,
    InProcessProvisioner,
    ProvisionedReplica,
    ReplicaObservation,
    ReplicaProvisioner,
    RouterAdminClient,
    SubprocessProvisioner,
)
from .launcher import ReplicaFleet, launch_fleet, launch_replicas  # noqa: F401
from .metrics import (  # noqa: F401
    AutoscalerMetrics,
    RouterMetrics,
    federate_expositions,
    lint_federation,
)
from .policy import (  # noqa: F401
    HashRing,
    LeastLoadedPolicy,
    PrefixAffinityPolicy,
    load_score,
    resolve_policy,
)
from .pool import (  # noqa: F401
    DEGRADED,
    DOWN,
    DRAINED,
    DRAINING,
    HEALTHY,
    RECOVERING,
    REMOVED,
    DrainPendingError,
    ProbeResult,
    Replica,
    ReplicaPool,
    ReplicaSnapshot,
)
from .proxy import RouterServer  # noqa: F401

__all__ = [
    "RouterServer",
    "Autoscaler",
    "AutoscalerPolicy",
    "AutoscalerMetrics",
    "FleetObservation",
    "ReplicaObservation",
    "ReplicaProvisioner",
    "ProvisionedReplica",
    "InProcessProvisioner",
    "SubprocessProvisioner",
    "RouterAdminClient",
    "ReplicaPool",
    "Replica",
    "ReplicaSnapshot",
    "ProbeResult",
    "RouterMetrics",
    "federate_expositions",
    "lint_federation",
    "LeastLoadedPolicy",
    "PrefixAffinityPolicy",
    "HashRing",
    "load_score",
    "resolve_policy",
    "ReplicaFleet",
    "launch_replicas",
    "launch_fleet",
    "HEALTHY",
    "DEGRADED",
    "DOWN",
    "RECOVERING",
    "DRAINING",
    "DRAINED",
    "REMOVED",
    "DrainPendingError",
]
