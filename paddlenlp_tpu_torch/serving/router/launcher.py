"""In-process fleet launcher: N ``ServingServer`` replicas on ephemeral ports.

The whole front tier is exercisable under tier-1 CPU tests and the smoke
bench without any external process management: ``launch_replicas`` builds N
real serving replicas (each with its **own** ``MetricsRegistry`` — the pull
gauges bind to one engine, so replicas must never share a registry) and
``launch_fleet`` puts a started ``RouterServer`` in front of them.

Everything here takes an ``engine_factory`` callable instead of an engine so
the module stays import-light (no engine until a factory runs) and each replica's
supervisor can rebuild its engine independently. A copy of
``paddlenlp_tpu/serving/router/launcher.py`` over the port's
``ServingServer``: in one process every replica's engine shares the
process's CUDA context and default stream.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

from ...utils.log import logger
from ..api import ServingServer
from ..metrics import MetricsRegistry
from .proxy import RouterServer

__all__ = ["ReplicaFleet", "launch_replicas", "launch_fleet"]


class ReplicaFleet:
    """Handle over N started in-process replicas (and optionally a router).

    With a router attached the fleet is *elastic*: :meth:`add_replica` grows
    it live (new ``ServingServer`` + pool registration + an immediate probe)
    and :meth:`drain_replica` shrinks it with zero stream loss (drain → wait
    for the router's live forwards to land → remove → shut the server down)
    — the in-process mirror of the router's ``POST /replicas`` /
    ``POST /replicas/drain`` / ``DELETE /replicas/{id}`` admin plane."""

    def __init__(self, servers: List[ServingServer], ports: List[int], host: str,
                 engine_factory: Optional[Callable[[], object]] = None,
                 replica_kw: Optional[dict] = None):
        self.servers = servers
        self.ports = ports
        self.host = host
        self.engine_factory = engine_factory
        self.replica_kw = dict(replica_kw or {})
        self.router: Optional[RouterServer] = None
        self.router_port: Optional[int] = None

    def endpoints(self) -> List[Tuple[str, int]]:
        return [(self.host, p) for p in self.ports]

    def registries(self) -> List[MetricsRegistry]:
        return [s.registry for s in self.servers]

    def replica_id(self, index: int) -> str:
        """The pool id of the index-th replica (the launcher registers
        replicas under their ``host:port``)."""
        return f"{self.host}:{self.ports[index]}"

    def add_replica(self) -> str:
        """Start one more in-process replica and join it to the router's pool
        (probed before the id is returned, so it routes on real health)."""
        if self.router is None:
            raise RuntimeError("add_replica needs a router (use launch_fleet)")
        if self.engine_factory is None:
            raise RuntimeError("fleet was built without an engine_factory")
        server = ServingServer(
            self.engine_factory(), registry=MetricsRegistry(),
            engine_factory=self.engine_factory, **self.replica_kw)
        port = server.start_in_thread(host=self.host)
        try:
            self.router.pool.add(self.host, port)
        except BaseException:
            server.shutdown(drain_timeout_s=1.0)
            raise
        self.servers.append(server)
        self.ports.append(port)
        rid = f"{self.host}:{port}"
        # targeted probe, same as the HTTP admin plane: no full-fleet sweep
        # (and no drain bookkeeping) on the caller thread
        self.router.pool.probe_one(rid)
        return rid

    def drain_replica(self, replica, deadline_s: float = 30.0,
                      wait_timeout_s: float = 60.0, poll_every_s: float = 0.05) -> bool:
        """Drain one replica (index or pool id) out of the fleet: no new
        requests, in-flight streams finish (bounded by ``deadline_s``, after
        which token-less survivors fail over), then the replica is removed
        from the pool and its server shut down. Returns True when the drain
        completed cleanly before removal."""
        if self.router is None:
            raise RuntimeError("drain_replica needs a router (use launch_fleet)")
        rid = self.replica_id(replica) if isinstance(replica, int) else str(replica)
        pool = self.router.pool
        pool.start_drain(rid, deadline_s=deadline_s)
        deadline = time.time() + wait_timeout_s
        drained = False
        # a started router's own poller drives the drain sweeps; only a pool
        # without a poller thread needs manual sweeps (concurrent poll_once
        # from two threads is tolerated but pointless)
        drive_manually = pool._thread is None
        while time.time() < deadline:
            if drive_manually:
                pool.poll_once()  # probe + drain-progress + deadline hook
            status = pool.drain_status(rid)
            if status is not None and status.get("drained"):
                drained = True
                break
            time.sleep(poll_every_s)
        # through the router's admin method (not bare pool.remove) so the
        # removal also drops the router-side accounting for the id
        code, doc = self.router.admin_remove_replica(rid, force=not drained)
        if code != 200:
            raise RuntimeError(f"removing {rid} failed: {doc}")
        idx = next((i for i, p in enumerate(self.ports)
                    if f"{self.host}:{p}" == rid), None)
        if idx is not None:
            server = self.servers.pop(idx)
            self.ports.pop(idx)
            try:
                server.shutdown(drain_timeout_s=5.0)
            except Exception as e:
                logger.warning(f"fleet: drained replica shutdown failed: {e!r}")
        return drained

    def shutdown(self, drain_timeout_s: Optional[float] = 10.0):
        """Router first (stop admitting), then the replicas (drain)."""
        if self.router is not None:
            self.router.shutdown()
            self.router = None
        for server in self.servers:
            try:
                server.shutdown(drain_timeout_s=drain_timeout_s)
            except Exception as e:
                logger.warning(f"fleet: replica shutdown failed: {e!r}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False


def launch_replicas(n: int, engine_factory: Callable[[], object], *,
                    tokenizer=None, scheduler_config=None, supervisor_policy=None,
                    host: str = "127.0.0.1") -> ReplicaFleet:
    """Start ``n`` in-process serving replicas on ephemeral ports.

    Each replica gets a fresh engine from ``engine_factory`` (which also
    serves as its supervisor's rebuild factory) and a private registry."""
    if n < 1:
        raise ValueError("n must be >= 1")
    replica_kw = dict(tokenizer=tokenizer, scheduler_config=scheduler_config,
                      supervisor_policy=supervisor_policy)
    servers: List[ServingServer] = []
    ports: List[int] = []
    try:
        for _ in range(n):
            server = ServingServer(
                engine_factory(), registry=MetricsRegistry(),
                engine_factory=engine_factory, **replica_kw)
            ports.append(server.start_in_thread(host=host))
            servers.append(server)
    except BaseException:
        for server in servers:
            server.shutdown(drain_timeout_s=1.0)
        raise
    return ReplicaFleet(servers, ports, host, engine_factory=engine_factory,
                        replica_kw=replica_kw)


def launch_fleet(n: int, engine_factory: Callable[[], object], *,
                 policy="least_loaded", router_registry: Optional[MetricsRegistry] = None,
                 poll_interval_s: float = 0.1, max_attempts: int = 3,
                 trace_sample_every: int = 1,
                 hedge_after_s: Optional[float] = None,
                 max_hedges_inflight: int = 4,
                 host: str = "127.0.0.1", **replica_kw) -> ReplicaFleet:
    """``launch_replicas`` + a started :class:`RouterServer` in front.

    Returns the fleet with ``.router`` / ``.router_port`` set; one initial
    synchronous poll sweep runs before the port is returned so the first
    request already routes on real health/load data."""
    from ...observability.tracer import SpanTracer

    fleet = launch_replicas(n, engine_factory, host=host, **replica_kw)
    try:
        # private tracer: in-process replicas share the global TRACER, and a
        # router recording into the same ring would double every stitched span
        router = RouterServer(fleet.endpoints(), policy=policy,
                              registry=router_registry or MetricsRegistry(),
                              poll_interval_s=poll_interval_s,
                              max_attempts=max_attempts,
                              trace_sample_every=trace_sample_every,
                              hedge_after_s=hedge_after_s,
                              max_hedges_inflight=max_hedges_inflight,
                              tracer=SpanTracer())
        router.pool.poll_once()
        fleet.router = router
        fleet.router_port = router.start_in_thread(host=host)
    except BaseException:
        fleet.shutdown(drain_timeout_s=1.0)
        raise
    return fleet
