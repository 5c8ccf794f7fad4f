"""Closed-loop fleet autoscaling: the policy loop over the elastic admin plane.

PR 10 made the fleet elastic (``POST /replicas`` / ``POST /replicas/drain`` /
``DELETE /replicas/{id}`` with zero-stream-loss drains) and PR 13 made it
observable (multi-window SLO burn rates on ``/fleet/slo``, per-replica health
and KV pressure on ``/replicas``). This module closes the loop: a control
thread that watches those signals and *drives* the admin plane, so a traffic
surge grows the fleet and a dead replica is replaced before a human notices.

The loop is deliberately an **external HTTP client** of the router — it runs
in-process for tests/bench (:class:`InProcessProvisioner`) or as a standalone
operator daemon (``python -m paddlenlp_tpu_torch.tools.autoscaler`` +
:class:`SubprocessProvisioner`)
against a production router, with identical decision logic.

**Decision ladder, one evaluation per tick** (every decision is a
flight-recorder event and a ``paddlenlp_router_autoscaler_*`` metric):

1. **Replace** — a DOWN, non-draining replica is force-removed (its streams
   are already failing over through the router's ordinary paths) and a
   replacement is owed. Availability repair ignores hysteresis and cooldowns.
2. **Scale up** — sustained overload (mean ``kv_utilization`` / mean engine
   queue depth over the live replicas, or the shortest-window SLO burn rate,
   past their thresholds for ``hysteresis_up`` consecutive ticks, outside the
   up-cooldown) adds ``<= max_step_up`` replicas, bounded by
   ``max_replicas``.
3. **Hold + brownout handoff** — overload at the max envelope cannot scale;
   the loop records ``scale.hold{max_envelope}`` and pushes a brownout floor
   to every live replica (``POST /admin/brownout``, the drain-propagation
   channel) so the fleet degrades selectively — shed best-effort, keep
   interactive TTFT — instead of timing out uniformly. Pushes repeat each
   tick to refresh the replica-side TTL; the floor lifts itself when the
   overload (and the pushes) stop.
4. **Scale down** — sustained calm for ``hysteresis_down`` ticks outside the
   down-cooldown drains the least-loaded replica(s) (zero stream loss — the
   admin plane's drain machinery). The drain is finalized on LATER ticks
   (removed once the pool reports it drained, force-removed past the
   deadline, then returned to the provisioner) so the control thread never
   blocks on an in-flight stream — a replica dying mid-drain is still
   replaced promptly.

**Chaos safety.** Every provision attempt runs through the
``router.provision`` fault point. A failed provision (or a provision whose
admin-plane join fails — the orphan replica is torn back down) leaves a
*deficit* the loop retries with exponential backoff on later ticks, so a
tombstoned (force-removed DOWN) replica is never silently left unreplaced
and a flapping provider cannot hot-loop the provider API.

**Concurrency model.** All decision state (streaks, cooldown stamps, the
provisioning deficit) is confined to the control thread — tests drive
:meth:`Autoscaler.evaluate_once` directly from their own single thread
instead. ``_stop`` is a ``threading.Event`` (self-synchronized).

A copy of ``paddlenlp_tpu/serving/router/autoscaler.py``; the
:class:`InProcessProvisioner` builds the port's ``ServingServer``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from ...observability.flight_recorder import RECORDER
from ...utils.faults import FaultPoint
from ...utils.log import logger
from ..metrics import MetricsRegistry
from .metrics import AutoscalerMetrics
from .pool import DOWN
from .pool import push_brownout as push_brownout_to_replica

__all__ = ["Autoscaler", "AutoscalerPolicy", "FleetObservation",
           "ReplicaObservation", "ProvisionedReplica", "ReplicaProvisioner",
           "InProcessProvisioner", "SubprocessProvisioner", "RouterAdminClient"]

_F_PROVISION = FaultPoint("router.provision")


# --------------------------------------------------------------------- policy
@dataclasses.dataclass
class AutoscalerPolicy:
    """Envelope, thresholds and damping for the control loop.

    Scale-up triggers on ANY overload signal (mean KV utilization, mean
    engine queue depth, shortest-window SLO burn); scale-down requires ALL
    signals calm. ``hysteresis_*`` are consecutive-tick requirements,
    ``cooldown_*`` wall-clock spacing between actions in the same direction —
    together they keep an oscillating signal from flapping the fleet."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_kv_utilization: float = 0.85
    scale_up_queue_depth: float = 4.0
    scale_up_burn_rate: float = 10.0
    scale_down_kv_utilization: float = 0.30
    scale_down_queue_depth: float = 0.5
    hysteresis_up: int = 2
    hysteresis_down: int = 5
    cooldown_up_s: float = 10.0
    cooldown_down_s: float = 30.0
    max_step_up: int = 2
    max_step_down: int = 1
    drain_deadline_s: float = 30.0
    provision_backoff_base_s: float = 0.5
    provision_backoff_max_s: float = 30.0
    # brownout handoff while pinned at the max envelope (0 disables)
    brownout_push_level: int = 1
    brownout_push_ttl_s: float = 30.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}/{self.max_replicas}")
        if self.hysteresis_up < 1 or self.hysteresis_down < 1:
            raise ValueError("hysteresis_up/down must be >= 1")
        if self.max_step_up < 1 or self.max_step_down < 1:
            raise ValueError("max_step_up/down must be >= 1")


# --------------------------------------------------------------------- signals
@dataclasses.dataclass
class ReplicaObservation:
    """One replica row folded out of ``GET /replicas``."""

    id: str
    state: str = "healthy"
    draining: bool = False
    drained: bool = False  # drain complete — safe to remove
    kv_utilization: float = 0.0
    queue_depth: float = 0.0
    host: str = ""
    port: int = 0


@dataclasses.dataclass
class FleetObservation:
    """One control-loop input: the replica set + the fast-window burn rates
    (tests construct these directly; :meth:`Autoscaler.observe` scrapes
    them)."""

    replicas: List[ReplicaObservation] = dataclasses.field(default_factory=list)
    availability_burn: float = 0.0
    ttft_burn: float = 0.0


# ----------------------------------------------------------------- admin client
class RouterAdminClient:
    """Thin HTTP client over the router's admin + fleet planes (stdlib only,
    swappable in tests)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s

    def _request(self, method: str, path: str, payload: Optional[dict] = None,
                 host: Optional[str] = None, port: Optional[int] = None
                 ) -> Tuple[int, dict]:
        conn = http.client.HTTPConnection(host or self.host, port or self.port,
                                          timeout=self.timeout_s)
        try:
            body = json.dumps(payload).encode() if payload is not None else None
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            doc = {}
        return resp.status, doc

    def list_replicas(self) -> dict:
        status, doc = self._request("GET", "/replicas")
        if status != 200:
            raise RuntimeError(f"GET /replicas: HTTP {status}")
        return doc

    def slo(self) -> dict:
        status, doc = self._request("GET", "/fleet/slo")
        if status != 200:
            raise RuntimeError(f"GET /fleet/slo: HTTP {status}")
        return doc

    def add_replica(self, host: str, port: int) -> dict:
        status, doc = self._request("POST", "/replicas",
                                    {"host": host, "port": port})
        if status != 200:
            raise RuntimeError(f"POST /replicas {host}:{port}: HTTP {status} {doc}")
        return doc

    def drain_replica(self, replica_id: str, deadline_s: float) -> dict:
        status, doc = self._request("POST", "/replicas/drain",
                                    {"id": replica_id, "deadline_s": deadline_s})
        if status != 200:
            raise RuntimeError(f"POST /replicas/drain {replica_id}: HTTP {status}")
        return doc

    def remove_replica(self, replica_id: str, force: bool = False) -> dict:
        from urllib.parse import quote

        path = f"/replicas/{quote(replica_id, safe='')}" + ("?force=1" if force else "")
        status, doc = self._request("DELETE", path)
        if status != 200:
            raise RuntimeError(f"DELETE {path}: HTTP {status} {doc}")
        return doc

    def push_brownout(self, host: str, port: int, level: int,
                      reason: str = "slo_fast_burn",
                      ttl_s: Optional[float] = None) -> bool:
        """Direct-to-replica brownout push (best effort, never raises)."""
        return push_brownout_to_replica(host, port, level, reason=reason,
                                        ttl_s=ttl_s, timeout_s=self.timeout_s)


# ----------------------------------------------------------------- provisioners
@dataclasses.dataclass
class ProvisionedReplica:
    host: str
    port: int


class ReplicaProvisioner:
    """Pluggable replica lifecycle provider. ``provision`` starts a replica
    server and returns its endpoint (the autoscaler joins it to the router);
    ``deprovision`` tears one down after the autoscaler removed it from the
    pool (unknown endpoints must be a no-op — the initial fleet was not
    provisioned here). ``close`` releases everything at shutdown."""

    def provision(self) -> ProvisionedReplica:
        raise NotImplementedError

    def deprovision(self, host: str, port: int):
        raise NotImplementedError

    def close(self):
        pass


class InProcessProvisioner(ReplicaProvisioner):
    """In-process replicas for tests and the CPU bench: each provision is a
    fresh ``ServingServer`` (own registry, own engine from
    ``engine_factory``) started on an ephemeral port in this process."""

    def __init__(self, engine_factory, host: str = "127.0.0.1",
                 replica_kw: Optional[dict] = None):
        self.engine_factory = engine_factory
        self.host = host
        self.replica_kw = dict(replica_kw or {})
        self.servers: Dict[Tuple[str, int], object] = {}

    def provision(self) -> ProvisionedReplica:
        from ..api import ServingServer

        server = ServingServer(
            self.engine_factory(), registry=MetricsRegistry(),
            engine_factory=self.engine_factory, **self.replica_kw)
        port = server.start_in_thread(host=self.host)
        self.servers[(self.host, port)] = server
        return ProvisionedReplica(self.host, port)

    def deprovision(self, host: str, port: int):
        server = self.servers.pop((host, port), None)
        if server is None:
            return
        try:
            server.shutdown(drain_timeout_s=5.0)
        except Exception as e:
            logger.warning(f"provisioner: shutdown of {host}:{port} failed: {e!r}")

    def close(self):
        for (host, port) in list(self.servers):
            self.deprovision(host, port)


class SubprocessProvisioner(ReplicaProvisioner):
    """Real-use provisioner: each replica is a subprocess launched from a
    command template (``{port}`` substituted with a fresh ephemeral port,
    ``{host}`` with the bind host), e.g.::

        python -m my_serving_entrypoint --host {host} --port {port}

    ``provision`` blocks until the replica's ``/health`` answers (bounded by
    ``ready_timeout_s``); ``deprovision`` terminates the subprocess."""

    def __init__(self, command: str, host: str = "127.0.0.1",
                 ready_timeout_s: float = 60.0):
        if "{port}" not in command:
            raise ValueError("command template must contain a {port} placeholder")
        self.command = command
        self.host = host
        self.ready_timeout_s = ready_timeout_s
        self.procs: Dict[Tuple[str, int], object] = {}

    @staticmethod
    def _free_port(host: str) -> int:
        import socket

        with socket.socket() as s:
            s.bind((host, 0))
            return s.getsockname()[1]

    def _wait_ready(self, host: str, port: int):
        deadline = time.time() + self.ready_timeout_s
        while time.time() < deadline:
            try:
                conn = http.client.HTTPConnection(host, port, timeout=2)
                try:
                    conn.request("GET", "/health")
                    conn.getresponse().read()
                finally:
                    conn.close()
                return
            except OSError:
                time.sleep(0.25)
        raise TimeoutError(
            f"replica on {host}:{port} not healthy within {self.ready_timeout_s}s")

    def provision(self) -> ProvisionedReplica:
        import shlex
        import subprocess

        port = self._free_port(self.host)
        cmd = [a.format(host=self.host, port=port)
               for a in shlex.split(self.command)]
        proc = subprocess.Popen(cmd)
        try:
            self._wait_ready(self.host, port)
        except BaseException:
            proc.terminate()
            raise
        self.procs[(self.host, port)] = proc
        return ProvisionedReplica(self.host, port)

    def deprovision(self, host: str, port: int):
        proc = self.procs.pop((host, port), None)
        if proc is None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except Exception:
            proc.kill()

    def close(self):
        for (host, port) in list(self.procs):
            self.deprovision(host, port)


# ----------------------------------------------------------------- control loop
class Autoscaler:
    """The SLO-driven control loop (see module docstring). ``router`` is the
    ``(host, port)`` of the router's HTTP plane (or a ready
    :class:`RouterAdminClient` — tests pass a stub)."""

    def __init__(self, router, provisioner: ReplicaProvisioner,
                 policy: Optional[AutoscalerPolicy] = None,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 2.0):
        if isinstance(router, (tuple, list)):
            self.admin = RouterAdminClient(router[0], int(router[1]))
        else:
            self.admin = router
        self.provisioner = provisioner
        self.policy = policy or AutoscalerPolicy()
        self.interval_s = interval_s
        self.metrics = AutoscalerMetrics(registry)
        self.metrics.target_envelope.set(self.policy.min_replicas, bound="min")
        self.metrics.target_envelope.set(self.policy.max_replicas, bound="max")
        # decision state — control-thread confined (tests drive evaluate_once
        # from their own single thread instead)
        self._over_streak = 0
        self._under_streak = 0
        self._last_up_t = -1e18
        self._last_down_t = -1e18
        self._deficit = 0  # replicas owed (replacements + failed provisions)
        # scale-down drains in flight: id -> {deadline_t, host, port}. Drains
        # are finalized on LATER ticks (remove once drained, force at the
        # deadline) so the control thread never blocks waiting on a stream —
        # a DOWN replica during a slow drain is still replaced promptly
        self._pending_drains: Dict[str, dict] = {}
        self._provision_backoff_s = 0.0
        self._provision_retry_t = -1e18
        self._last_hold_reason: Optional[str] = None
        # decision journal for bench/tests: (t, action, detail), bounded
        self.events: List[Tuple[float, str, dict]] = []
        self._events_cap = 512
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                self.evaluate_once()
            except Exception as e:  # one bad tick must not kill the loop
                logger.warning(f"autoscaler: evaluation failed: {e!r}")
            self._stop.wait(timeout=self.interval_s)

    # ------------------------------------------------------------- observation
    def observe(self) -> FleetObservation:
        """Scrape the router's ``/replicas`` + ``/fleet/slo`` planes into one
        observation. Polling ``/fleet/slo`` also *feeds* the router's SLO
        tracker — the control loop doubles as its scrape cadence."""
        doc = self.admin.list_replicas()
        replicas = []
        for row in doc.get("replicas", []):
            replicas.append(ReplicaObservation(
                id=str(row.get("id")),
                state=str(row.get("state", "healthy")),
                draining=bool(row.get("draining")),
                drained=bool((row.get("drain") or {}).get("drained")),
                kv_utilization=float(row.get("kv_utilization") or 0.0),
                queue_depth=float(row.get("queue_depth") or 0.0),
                host=str(row.get("host", "")),
                port=int(row.get("port") or 0)))
        availability_burn = ttft_burn = 0.0
        try:
            slo = self.admin.slo()
            windows = slo.get("windows") or {}
            if windows:
                shortest = windows[min(windows, key=lambda w: int(w.rstrip("s")))]
                availability_burn = float(shortest.get("availability_burn_rate", 0.0))
                ttft_burn = float(shortest.get("ttft_burn_rate", 0.0))
        except Exception as e:
            # partial signal beats no control loop: KV/queue pressure still
            # drives decisions while the SLO plane is unreachable
            logger.warning(f"autoscaler: /fleet/slo scrape failed: {e!r}")
        return FleetObservation(replicas=replicas,
                                availability_burn=availability_burn,
                                ttft_burn=ttft_burn)

    # ------------------------------------------------------------- decisions
    def evaluate_once(self, now: Optional[float] = None,
                      observation: Optional[FleetObservation] = None) -> dict:
        """One control-loop tick. Returns a summary of what was decided —
        the bench folds these into its JSON line, tests assert on them."""
        now = time.time() if now is None else now
        p = self.policy
        obs = self.observe() if observation is None else observation
        actions: List[Tuple[str, dict]] = []

        # 0 ------------------------------------------------ finalize pending drains
        self._advance_drains(obs, now, actions)

        live = [r for r in obs.replicas if not r.draining]
        down = [r for r in live if r.state == DOWN]
        healthy = [r for r in live if r.state != DOWN]

        # 1 ------------------------------------------------ replace DOWN replicas
        for dead in down:
            try:
                self.admin.remove_replica(dead.id, force=True)
            except Exception as e:
                logger.warning(f"autoscaler: removing DOWN {dead.id} failed: {e!r}")
                continue
            # the dead server (if this provisioner owns it) is returned now;
            # the REPLACEMENT is owed via the deficit, which retries with
            # backoff — a tombstoned replica is never silently forgotten
            try:
                self.provisioner.deprovision(dead.host, dead.port)
            except Exception as e:
                logger.warning(f"autoscaler: deprovision of {dead.id} failed: {e!r}")
            self._deficit += 1
            self._note("replace", {"replica": dead.id}, now, actions)
            RECORDER.record("scale.replace", replica=dead.id)
            self.metrics.decisions.inc(action="replace")
            logger.warning(f"autoscaler: replacing DOWN replica {dead.id}")

        # 2 ------------------------------------------------ min-envelope repair
        if len(healthy) + self._deficit < p.min_replicas:
            self._deficit = p.min_replicas - len(healthy)

        # 3 ------------------------------------------------ overload/underload signals
        n = len(healthy)
        kv = sum(r.kv_utilization for r in healthy) / n if n else 0.0
        queue = sum(r.queue_depth for r in healthy) / n if n else 0.0
        burn = max(obs.availability_burn, obs.ttft_burn)
        overloaded = (kv >= p.scale_up_kv_utilization
                      or queue >= p.scale_up_queue_depth
                      or burn >= p.scale_up_burn_rate)
        # underload reads only the LEADING signals (kv/queue pressure): the
        # burn rate is windowed memory of the incident — an already-calm
        # fleet would otherwise hold surge capacity until the short window
        # rolled past, long after hysteresis + cooldown said it was safe
        underloaded = (kv <= p.scale_down_kv_utilization
                       and queue <= p.scale_down_queue_depth)
        self._over_streak = self._over_streak + 1 if overloaded else 0
        self._under_streak = self._under_streak + 1 if underloaded else 0

        if overloaded and self._deficit == 0:
            if self._over_streak < p.hysteresis_up:
                self._hold("hysteresis", now, actions)
            elif now - self._last_up_t < p.cooldown_up_s:
                self._hold("cooldown", now, actions)
            elif n >= p.max_replicas:
                # scaling cannot help: hand off to the brownout ladder so the
                # fleet sheds best-effort work instead of timing out everyone
                self._hold("max_envelope", now, actions)
                self._push_brownout(healthy, now, actions)
            else:
                step = min(p.max_step_up, p.max_replicas - n)
                self._deficit += step
                self._last_up_t = now
                self._over_streak = 0
                self._last_hold_reason = None
                self._note("up", {"added": step, "target": n + step}, now, actions)
                RECORDER.record("scale.up", added=step, replicas=n + step)
                self.metrics.decisions.inc(action="up")
                logger.warning(
                    f"autoscaler: scaling up +{step} (kv={kv:.2f} queue={queue:.1f} "
                    f"burn={burn:.1f}) -> {n + step}")
        elif (underloaded and self._deficit == 0 and n > p.min_replicas):
            if self._under_streak < p.hysteresis_down:
                self._hold("hysteresis", now, actions)
            elif now - self._last_down_t < p.cooldown_down_s:
                self._hold("cooldown", now, actions)
            else:
                step = min(p.max_step_down, n - p.min_replicas)
                victims = sorted(
                    healthy, key=lambda r: (r.kv_utilization + r.queue_depth, r.id))
                removed = 0
                for victim in victims[:step]:
                    if self._start_drain_one(victim, now):
                        removed += 1
                if removed:
                    self._last_down_t = now
                    self._under_streak = 0
                    self._last_hold_reason = None
                    self._note("down", {"removed": removed, "target": n - removed},
                               now, actions)
                    RECORDER.record("scale.down", removed=removed,
                                    replicas=n - removed)
                    self.metrics.decisions.inc(action="down")
                    logger.warning(f"autoscaler: scaled down -{removed} -> {n - removed}")
        elif not overloaded and not underloaded:
            # inside the comfort band: clear the hold-episode dedup so the
            # next held episode records again
            self._last_hold_reason = None
        if n <= p.min_replicas and underloaded:
            self._hold("min_envelope", now, actions)

        # 4 ------------------------------------------------ settle the deficit
        joined = 0
        if self._deficit > 0:
            if now < self._provision_retry_t:
                self._hold("provision_backoff", now, actions)
            else:
                while self._deficit > 0 and n + joined < p.max_replicas:
                    if not self._provision_one(now, actions):
                        break
                    joined += 1

        self.metrics.replicas.set(n + joined)
        return {
            "t": now, "replicas": n + joined, "deficit": self._deficit,
            "kv_utilization": kv, "queue_depth": queue, "burn": burn,
            "overloaded": overloaded, "underloaded": underloaded,
            "actions": actions,
        }

    # ------------------------------------------------------------- helpers
    def _note(self, action: str, detail: dict, now: float,
              actions: Optional[List] = None):
        if actions is not None:
            actions.append((action, detail))
        self.events.append((now, action, detail))
        del self.events[:-self._events_cap]

    def _hold(self, reason: str, now: float, actions: List):
        """Record one suppressed-action episode (deduped on consecutive same
        reason so a long cooldown is one event, not one per tick)."""
        actions.append(("hold", {"reason": reason}))
        if self._last_hold_reason == reason:
            return
        self._last_hold_reason = reason
        self.events.append((now, "hold", {"reason": reason}))
        del self.events[:-self._events_cap]
        RECORDER.record("scale.hold", reason=reason)
        self.metrics.decisions.inc(action="hold")

    def _push_brownout(self, healthy: List[ReplicaObservation], now: float,
                       actions: List):
        """Max-envelope brownout handoff: push the floor to every live
        replica, refreshing its TTL each tick the condition persists."""
        level = self.policy.brownout_push_level
        if not level:
            return
        pushed = 0
        for r in healthy:
            if r.host and r.port and self.admin.push_brownout(
                    r.host, r.port, level, reason="slo_fast_burn",
                    ttl_s=self.policy.brownout_push_ttl_s):
                pushed += 1
        if pushed:
            self.metrics.brownout_pushes.inc(pushed)
            actions.append(("brownout_push", {"replicas": pushed, "level": level}))

    def _provision_one(self, now: float, actions: Optional[List] = None) -> bool:
        """Provision + join one replica. On any failure the deficit stays and
        the next attempt backs off exponentially; a replica that provisioned
        but failed to JOIN is torn back down (no orphans)."""
        try:
            _F_PROVISION.fire(deficit=self._deficit)
            rep = self.provisioner.provision()
        except Exception as e:
            self._provision_failed(now, f"provision: {e!r}")
            return False
        try:
            self.admin.add_replica(rep.host, rep.port)
        except Exception as e:
            try:
                self.provisioner.deprovision(rep.host, rep.port)
            except Exception:
                pass
            self._provision_failed(now, f"join {rep.host}:{rep.port}: {e!r}")
            return False
        self._deficit -= 1
        self._provision_backoff_s = 0.0
        self._note("provisioned", {"replica": f"{rep.host}:{rep.port}"}, now,
                   actions)
        logger.warning(f"autoscaler: provisioned replica {rep.host}:{rep.port} "
                       f"(deficit {self._deficit})")
        return True

    def _provision_failed(self, now: float, detail: str):
        self.metrics.provision_failures.inc()
        base = self.policy.provision_backoff_base_s
        self._provision_backoff_s = min(
            max(self._provision_backoff_s * 2, base),
            self.policy.provision_backoff_max_s)
        self._provision_retry_t = now + self._provision_backoff_s
        logger.warning(
            f"autoscaler: provision failed ({detail}); retrying in "
            f"{self._provision_backoff_s:.2f}s (deficit {self._deficit})")

    def _start_drain_one(self, victim: ReplicaObservation, now: float) -> bool:
        """Begin one scale-down drain (zero stream loss: the admin plane's
        drain machinery owns in-flight streams). Finalized by
        :meth:`_advance_drains` on later ticks — never blocks this one."""
        p = self.policy
        try:
            self.admin.drain_replica(victim.id, deadline_s=p.drain_deadline_s)
        except Exception as e:
            logger.warning(f"autoscaler: drain of {victim.id} failed: {e!r}")
            return False
        self._pending_drains[victim.id] = {
            # small grace past the router's own deadline: its drain enforcer
            # (pre-token eviction) gets to act before we force-remove
            "deadline_t": now + p.drain_deadline_s + 10.0,
            "host": victim.host, "port": victim.port,
        }
        return True

    def _advance_drains(self, obs: FleetObservation, now: float, actions: List):
        """Finalize pending scale-down drains: remove a victim once the pool
        reports it drained (or it vanished), force-remove at the deadline;
        a failed removal stays pending and retries next tick."""
        for rid, info in list(self._pending_drains.items()):
            row = next((r for r in obs.replicas if r.id == rid), None)
            drained = row is None or row.drained
            if not drained and now < info["deadline_t"]:
                continue
            try:
                self.admin.remove_replica(rid, force=not drained)
            except Exception as e:
                logger.warning(f"autoscaler: removal of {rid} failed: {e!r}")
                continue
            del self._pending_drains[rid]
            try:
                self.provisioner.deprovision(info["host"], info["port"])
            except Exception as e:
                logger.warning(f"autoscaler: deprovision of {rid} failed: {e!r}")
            self._note("drained", {"replica": rid, "forced": not drained},
                       now, actions)
