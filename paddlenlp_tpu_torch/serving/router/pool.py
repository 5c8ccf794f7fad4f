"""Replica registry + background health poller for the router front tier.

Each replica is a ``ServingServer`` (or anything speaking its HTTP surface);
the pool learns replica health the same way an external prober would — by
polling ``GET /health`` (scheduler/engine stats; 503 while the replica's
engine-loop supervisor reports DEGRADED or the scheduler is draining) and
scraping ``GET /metrics`` for ``paddlenlp_serving_kv_utilization`` — so the
router needs no privileged in-process hooks and works unchanged against
out-of-process replicas.

**State machine** (per replica)::

    HEALTHY ──probe 503 (degraded/draining)──▶ DEGRADED
    HEALTHY/DEGRADED ──unreachable × down_after──▶ DOWN
    DOWN ──probe ok──▶ RECOVERING ──ok × recovery_polls──▶ HEALTHY
    RECOVERING ──probe fails──▶ back toward DOWN

A single unreachable probe demotes to DEGRADED (the replica may just be
GC-pausing); ``down_after`` consecutive failures mean DOWN — the policy layer
stops offering the replica entirely. Recovery is probational: a replica coming
back from DOWN serves traffic at RECOVERING priority until ``recovery_polls``
consecutive clean probes promote it, so a flapping replica cannot oscillate
straight back into preferred rotation.

The proxy feeds forwarding observations back through
:meth:`ReplicaPool.note_forward_failure` / :meth:`ReplicaPool.note_degraded`
so a mid-stream incident demotes the replica immediately instead of waiting a
poll interval.

**Live membership.** The replica set is no longer fixed at launch:
:meth:`ReplicaPool.add` registers a replica at runtime, :meth:`start_drain`
flips one to *draining* (the policy layer stops offering it; in-flight
streams finish), and :meth:`remove` takes a drained (or DOWN, or ``force``)
replica out, leaving a tombstone :meth:`drain_status` reports as
``removed``. Drain progress is driven from the poll sweep
(:meth:`_check_drains`): the owning router supplies ``drain_live`` (its own
open-forward count per replica — authoritative for router-fronted traffic)
and ``on_drain_deadline`` (called once when a drain outlives its deadline so
the router can fail the stuck token-less streams over). All three mutation
paths run through the ``router.membership`` fault point *before* touching
state, so an injected failure leaves the set exactly as it was.

**Concurrency model.** Three kinds of thread touch the pool: the poller
(``_run``/``poll_once``/``_check_drains``), HTTP proxy threads
(``snapshots``/``get``/``note_*``), and whoever mutates membership
(``add``/``start_drain``/``remove`` — admin-plane HTTP threads). The replica
list, id map and removal tombstones are guarded by ``_lock`` (``#
guarded-by:`` annotations, enforced by ``tools/analyze``); per-``Replica``
fields are written ONLY under that same pool lock (``_apply`` for health
fields, ``start_drain``/``_check_drains`` for the drain fields — including
``drain_expired_notified``, whose locked check-and-set is what makes the
deadline hook fire exactly once), and read by other threads only through
:meth:`Replica.snapshot`, which ``snapshots()`` calls under the lock. The
exceptions are ``Replica.polls``/``_offset_samples``: normally
poller-confined, but ``poll_once`` may also be driven by admin/launcher
threads — both fields tolerate the rare concurrent sweep (a lost ``polls``
increment only jitters the kv-scrape cadence; deque appends are atomic).

A copy of ``paddlenlp_tpu/serving/router/pool.py``.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ...observability.tracer import TRACER
from ...utils.faults import FaultPoint
from ...utils.log import logger
from .metrics import RouterMetrics

__all__ = ["HEALTHY", "DEGRADED", "DOWN", "RECOVERING", "DRAINING", "DRAINED",
           "REMOVED", "Replica", "ReplicaSnapshot", "ProbeResult", "ReplicaPool",
           "DrainPendingError", "push_brownout"]

HEALTHY = "healthy"
DEGRADED = "degraded"
DOWN = "down"
RECOVERING = "recovering"
# drain lifecycle strings (drain_status / admin plane; `draining` is a flag
# ORTHOGONAL to the health state — a draining replica still health-polls)
DRAINING = "draining"
DRAINED = "drained"
REMOVED = "removed"

_F_HEALTH_POLL = FaultPoint("router.health_poll")
_F_MEMBERSHIP = FaultPoint("router.membership")


class DrainPendingError(RuntimeError):
    """remove() refused: the replica has not finished draining (HTTP 409)."""

KV_UTILIZATION_METRIC = "paddlenlp_serving_kv_utilization"


def push_brownout(host: str, port: int, level: int,
                  reason: str = "slo_fast_burn",
                  ttl_s: Optional[float] = None,
                  timeout_s: float = 10.0) -> bool:
    """POST a brownout floor to one replica's ``/admin/brownout`` (best
    effort: False on any transport/HTTP failure, never raises). The ONE
    client for this route — the router's SLO fast-burn hook and the
    autoscaler's max-envelope handoff both go through here."""
    payload = {"level": int(level), "reason": reason}
    if ttl_s is not None:
        payload["ttl_s"] = float(ttl_s)
    try:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("POST", "/admin/brownout",
                         body=json.dumps(payload).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
        finally:
            conn.close()
        return resp.status == 200
    except (OSError, http.client.HTTPException, ValueError) as e:
        logger.debug(f"brownout push to {host}:{port} failed: {e!r}")
        return False


@dataclasses.dataclass
class ProbeResult:
    """Outcome of one health probe. ``reachable`` separates a live replica
    shedding load (503 degraded/draining — still owns its queue) from one
    that cannot be talked to at all (connect/timeout — may be gone)."""

    reachable: bool
    status: Optional[str] = None  # the /health "status" field
    inflight: int = 0
    queue_depth: int = 0
    kv_utilization: Optional[float] = None
    retry_after_s: Optional[float] = None
    brownout_level: int = 0  # the replica's overload-brownout ladder level
    # the base-weight version the replica reports on /health (rollout gate +
    # version-skew failover guard); None when the probe could not read one
    weights_version: Optional[str] = None
    error: Optional[str] = None
    # clock-sync piggyback: the replica's tracer-timeline "now" plus the
    # probe's RTT — one offset estimate per probe (NTP-style midpoint)
    clock_offset_s: Optional[float] = None
    rtt_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ReplicaSnapshot:
    """Immutable point-in-time view the routing policy consumes."""

    id: str
    host: str
    port: int
    state: str
    inflight: int
    queue_depth: int
    kv_utilization: float
    retry_after_s: Optional[float]
    consecutive_failures: int
    last_poll_t: Optional[float]
    clock_offset_s: Optional[float] = None  # replica tracer time - router tracer time
    draining: bool = False  # membership: no NEW requests; in-flight finish
    drained: bool = False  # drain complete — safe to remove
    # the replica's overload-brownout level (0 normal .. 3 clamp): >= 2 means
    # the replica asked the fleet to stop racing hedge shadows against it
    brownout_level: int = 0
    # last /health-reported base-weight version (None until first probe):
    # the policy's skew guard and the rollout's rejoin gate both read this
    weights_version: Optional[str] = None

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Replica:
    """Mutable pool-side record for one replica (poller-thread writes, HTTP
    threads read only through :meth:`snapshot` under the pool lock)."""

    def __init__(self, replica_id: str, host: str, port: int):
        self.id = replica_id
        self.host = host
        self.port = port
        # optimistic start: a replica is offered traffic until the first probe
        # says otherwise — the common launch order is "replicas up, then
        # router", and starting DOWN would 503 every request for one interval
        self.state = HEALTHY
        self.inflight = 0
        self.queue_depth = 0
        self.kv_utilization = 0.0
        self.retry_after_s: Optional[float] = None
        self.brownout_level = 0
        self.weights_version: Optional[str] = None
        self.consecutive_failures = 0
        self.recovery_streak = 0
        self.last_poll_t: Optional[float] = None
        self.last_error: Optional[str] = None
        self.polls = 0  # probe count (drives the kv-scrape cadence)
        # drain lifecycle (written under the pool lock; see module docstring)
        self.draining = False
        self.drained = False
        self.drain_deadline_t: Optional[float] = None
        self.drain_expired_notified = False  # poller-thread confined
        # clock skew vs the router, for cross-tier trace stitching: each probe
        # yields (rtt, offset); the lowest-RTT sample in the window wins (the
        # midpoint assumption — request and response legs symmetric — is most
        # credible when the network round trip was fastest)
        self._offset_samples: deque = deque(maxlen=8)
        self.clock_offset_s: Optional[float] = None

    def note_offset(self, rtt_s: float, offset_s: float):
        self._offset_samples.append((rtt_s, offset_s))
        self.clock_offset_s = min(self._offset_samples)[1]

    def snapshot(self) -> ReplicaSnapshot:
        return ReplicaSnapshot(
            id=self.id, host=self.host, port=self.port, state=self.state,
            inflight=self.inflight, queue_depth=self.queue_depth,
            kv_utilization=self.kv_utilization, retry_after_s=self.retry_after_s,
            consecutive_failures=self.consecutive_failures, last_poll_t=self.last_poll_t,
            clock_offset_s=self.clock_offset_s, draining=self.draining,
            drained=self.drained, brownout_level=self.brownout_level,
            weights_version=self.weights_version)


class ReplicaPool:
    """Owns the replica set and the background poller thread."""

    def __init__(self, metrics: Optional[RouterMetrics] = None,
                 poll_interval_s: float = 1.0, probe_timeout_s: float = 2.0,
                 down_after: int = 3, recovery_polls: int = 2,
                 kv_scrape_every: int = 5, tracer=None):
        if down_after < 1:
            raise ValueError("down_after must be >= 1")
        if recovery_polls < 1:
            raise ValueError("recovery_polls must be >= 1")
        if kv_scrape_every < 1:
            raise ValueError("kv_scrape_every must be >= 1")
        self.metrics = metrics
        # clock-offset probes must read the SAME timeline stitching shifts
        # onto: the owning router's tracer (launch_fleet gives it a private
        # one whose epoch anchor differs from the global TRACER's)
        self.tracer = tracer if tracer is not None else TRACER
        self.poll_interval_s = poll_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.down_after = down_after
        self.recovery_polls = recovery_polls
        self.kv_scrape_every = kv_scrape_every
        self._lock = threading.Lock()
        self._replicas: List[Replica] = []  # guarded-by: _lock
        self._by_id: Dict[str, Replica] = {}  # guarded-by: _lock
        self._removed: Dict[str, Dict] = {}  # guarded-by: _lock
        # bounded: an autoscaler cycling replicas on ephemeral ports mints a
        # fresh id per scale-down — without a cap the tombstones (and every
        # GET /replicas response) would grow for the router's whole lifetime
        self._removed_cap = 256
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # membership hooks the owning router wires up: drain_live(replica_id)
        # -> the router's own open-forward count (authoritative for drain
        # completion — probe inflight is the fallback for a poolside-only
        # deployment); on_drain_deadline(replica_id) fires ONCE when a drain
        # outlives its deadline (the router fails stuck streams over)
        self.drain_live: Optional[Callable[[str], int]] = None
        self.on_drain_deadline: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------- membership
    def add(self, host: str, port: int, replica_id: Optional[str] = None) -> Replica:
        rid = replica_id or f"{host}:{port}"
        _F_MEMBERSHIP.fire(op="add", replica=rid)
        with self._lock:
            if rid in self._by_id:
                raise ValueError(f"replica {rid!r} already registered")
            replica = Replica(rid, host, port)
            self._replicas.append(replica)
            self._by_id[rid] = replica
            # re-adding a previously-removed id revives it: drop the tombstone
            self._removed.pop(rid, None)
        if self.metrics is not None:
            self.metrics.replica_healthy.set(1.0, replica=rid)
        self.tracer.instant("membership", cat="router", op="add", replica=rid)
        return replica

    def start_drain(self, replica_id: str, deadline_s: float = 30.0) -> Dict:
        """Flip a replica to draining: the policy layer stops offering it,
        in-flight streams finish, and once the router reports zero live
        forwards the poll sweep marks it ``drained`` (removable). Past
        ``deadline_s`` the ``on_drain_deadline`` hook fires once so the owner
        can fail stuck token-less streams over. Idempotent: re-draining an
        already-draining replica only tightens/extends the deadline."""
        _F_MEMBERSHIP.fire(op="drain", replica=replica_id)
        with self._lock:
            replica = self._by_id.get(replica_id)
            if replica is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            replica.draining = True
            replica.drained = False
            replica.drain_deadline_t = time.time() + max(float(deadline_s), 0.0)
            replica.drain_expired_notified = False
        logger.warning(f"router: replica {replica_id} draining "
                       f"(deadline {deadline_s:.1f}s)")
        self.tracer.instant("membership", cat="router", op="drain",
                            replica=replica_id, deadline_s=deadline_s)
        return self.drain_status(replica_id)

    def cancel_drain(self, replica_id: str) -> Dict:
        """Undo :meth:`start_drain` — the rejoin half of a rolling weight
        rollout (drain, swap, un-drain) for a replica that is NOT leaving the
        fleet. Clears the whole drain lifecycle so the policy layer offers it
        again; idempotent on a replica that was never draining."""
        _F_MEMBERSHIP.fire(op="undrain", replica=replica_id)
        with self._lock:
            replica = self._by_id.get(replica_id)
            if replica is None:
                raise KeyError(f"unknown replica {replica_id!r}")
            replica.draining = False
            replica.drained = False
            replica.drain_deadline_t = None
            replica.drain_expired_notified = False
        logger.warning(f"router: replica {replica_id} drain cancelled (rejoining)")
        self.tracer.instant("membership", cat="router", op="undrain",
                            replica=replica_id)
        return self.drain_status(replica_id)

    def remove(self, replica_id: str, force: bool = False) -> Dict:
        """Take a replica out of the pool. Refused (:class:`DrainPendingError`)
        unless it finished draining, is DOWN, or ``force`` — live streams on a
        force-removed replica keep relaying (the router holds its own upstream
        connections) but lose failover-by-exclusion bookkeeping. Leaves a
        tombstone ``drain_status`` reports as ``removed``; idempotent on an
        already-removed id."""
        _F_MEMBERSHIP.fire(op="remove", replica=replica_id)
        with self._lock:
            replica = self._by_id.get(replica_id)
            if replica is None:
                if replica_id in self._removed:
                    return dict(self._removed[replica_id])
                raise KeyError(f"unknown replica {replica_id!r}")
            if not (force or replica.drained or replica.state == DOWN):
                raise DrainPendingError(
                    f"replica {replica_id!r} is not drained "
                    f"(draining={replica.draining}, state={replica.state}); "
                    "drain it first or pass force")
            self._replicas.remove(replica)
            del self._by_id[replica_id]
            tomb = {"id": replica_id, "state": REMOVED, "removed_t": time.time(),
                    "was_drained": replica.drained, "forced": bool(force)}
            self._removed[replica_id] = tomb
            while len(self._removed) > self._removed_cap:  # oldest-first trim
                self._removed.pop(next(iter(self._removed)))
        if self.metrics is not None:
            # drop, don't zero: a pinned replica_healthy{removed-id}=0 series
            # would alert as "unhealthy replica" forever and leak one series
            # per scale-down under autoscaler churn
            self.metrics.replica_healthy.remove_series(replica=replica_id)
        logger.warning(f"router: replica {replica_id} removed from the pool"
                       + (" (forced)" if force else ""))
        self.tracer.instant("membership", cat="router", op="remove",
                            replica=replica_id, forced=force)
        return dict(tomb)

    def removed(self) -> List[Dict]:
        """Removal tombstones (admin-plane listing)."""
        with self._lock:
            return [dict(t) for t in self._removed.values()]

    def is_draining(self, replica_id: str) -> bool:
        with self._lock:
            replica = self._by_id.get(replica_id)
            return replica is not None and replica.draining

    def drain_status(self, replica_id: str) -> Optional[Dict]:
        """Drain lifecycle view of one replica: ``draining`` → ``drained`` →
        ``removed`` (tombstone), or the plain health state when no drain is in
        progress. None for ids the pool has never seen."""
        with self._lock:
            if replica_id in self._removed:
                return dict(self._removed[replica_id])
            replica = self._by_id.get(replica_id)
            if replica is None:
                return None
            if replica.draining:
                state = DRAINED if replica.drained else DRAINING
            else:
                state = replica.state
            return {
                "id": replica_id, "state": state, "draining": replica.draining,
                "drained": replica.drained,
                "deadline_in_s": None if replica.drain_deadline_t is None
                else replica.drain_deadline_t - time.time(),
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicas)

    def get(self, replica_id: str) -> Optional[Replica]:
        with self._lock:
            return self._by_id.get(replica_id)

    def snapshots(self) -> List[ReplicaSnapshot]:
        with self._lock:
            return [r.snapshot() for r in self._replicas]

    # ------------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="router-health-poller",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, join_timeout_s: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
            self._thread = None

    def _run(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # the poller must outlive any single probe
                logger.warning(f"router: health-poll sweep failed: {e!r}")
            self._stop.wait(timeout=self.poll_interval_s)

    # ------------------------------------------------------------- polling
    def poll_once(self):
        """One synchronous sweep over every replica (tests call this directly
        for deterministic state-machine coverage)."""
        with self._lock:
            replicas = list(self._replicas)
        for replica in replicas:
            try:
                result = self._probe(replica)
            except Exception as e:
                # connect refused, timeout, injected router.health_poll fault,
                # junk body — all the same to the state machine: unreachable
                result = ProbeResult(reachable=False, error=repr(e))
            self._apply(replica, result)
        self._check_drains()

    def probe_one(self, replica_id: str):
        """Probe a single replica synchronously (the admin plane's
        join-before-serve check) — unlike :meth:`poll_once` this does not
        sweep drains, so an HTTP thread can call it without racing the
        poller's drain bookkeeping."""
        replica = self.get(replica_id)
        if replica is None:
            return
        try:
            result = self._probe(replica)
        except Exception as e:
            result = ProbeResult(reachable=False, error=repr(e))
        self._apply(replica, result)

    def _check_drains(self):
        """Advance every in-progress drain: mark it ``drained`` when the owner
        reports zero live forwards (probe inflight as the fallback), and fire
        the deadline hook once when it has outlived its deadline. Runs on the
        poller thread (or inside a manual ``poll_once``)."""
        with self._lock:
            draining = [r for r in self._replicas if r.draining and not r.drained]
        now = time.time()
        for replica in draining:
            live = None
            if self.drain_live is not None:
                try:
                    live = int(self.drain_live(replica.id))
                except Exception as e:
                    logger.warning(f"router: drain_live({replica.id}) failed: {e!r}")
            if live is None:
                # poolside fallback: the replica's own /health inflight — an
                # unreachable replica reads 0 (its streams are breaking anyway
                # and will fail over through the normal forward path)
                live = replica.inflight if replica.state != DOWN else 0
            if live == 0:
                with self._lock:
                    replica.drained = True
                logger.warning(f"router: replica {replica.id} drained "
                               "(no live streams); safe to remove")
                self.tracer.instant("membership", cat="router", op="drained",
                                    replica=replica.id)
            elif (replica.drain_deadline_t is not None
                  and now >= replica.drain_deadline_t):
                # check-and-set under the pool lock: poll_once may be driven
                # by the poller AND by admin/launcher threads, and the
                # deadline hook must fire exactly once per drain
                with self._lock:
                    if replica.drain_expired_notified or not replica.draining:
                        continue
                    replica.drain_expired_notified = True
                logger.warning(
                    f"router: drain of {replica.id} outlived its deadline with "
                    f"{live} live stream(s); failing stuck streams over")
                self.tracer.instant("membership", cat="router", op="drain_expired",
                                    replica=replica.id, live=live)
                if self.on_drain_deadline is not None:
                    try:
                        self.on_drain_deadline(replica.id)
                    except Exception as e:
                        logger.warning(
                            f"router: drain-deadline hook for {replica.id} failed: {e!r}")

    def _probe(self, replica: Replica) -> ProbeResult:
        """GET /health (+ /metrics kv_utilization) of one replica. Raises on
        transport failure; the caller folds that into ProbeResult."""
        _F_HEALTH_POLL.fire(replica=replica.id)
        conn = http.client.HTTPConnection(replica.host, replica.port,
                                          timeout=self.probe_timeout_s)
        t0 = self.tracer.now()
        try:
            conn.request("GET", "/health")
            resp = conn.getresponse()
            retry_after = resp.getheader("Retry-After")
            body = json.loads(resp.read() or b"{}")
        finally:
            conn.close()
        t1 = self.tracer.now()
        sched = body.get("scheduler") or {}
        engine = body.get("engine") or {}
        brownout = body.get("brownout")
        result = ProbeResult(
            reachable=True,
            status=body.get("status"),
            inflight=int(sched.get("inflight", 0)),
            queue_depth=int(engine.get("queue_depth", 0)),
            retry_after_s=float(retry_after) if retry_after else None,
            brownout_level=int(brownout) if isinstance(brownout, (int, float)) else 0,
            weights_version=(str(body["weights_version"])
                             if body.get("weights_version") is not None else None),
        )
        # clock-offset estimate for trace stitching: the replica stamped its
        # tracer-timeline "now" somewhere inside [t0, t1]; assume the midpoint
        remote_now = body.get("now")
        if isinstance(remote_now, (int, float)):
            result.rtt_s = t1 - t0
            result.clock_offset_s = float(remote_now) - (t0 + t1) / 2.0
        # kv_utilization rides on the replica's Prometheus plane (pull gauge
        # sampled at scrape). Scraping + parsing the full exposition per poll
        # would dominate a fast poll interval, so it runs every Nth probe —
        # KV pressure moves on decode timescales, not poll timescales. A
        # failed scrape keeps the last observation rather than failing the
        # whole probe.
        if replica.polls % self.kv_scrape_every == 0:
            try:
                result.kv_utilization = self._scrape_kv_utilization(replica)
            except Exception as e:
                logger.debug(f"router: kv scrape of {replica.id} failed: {e!r}")
        replica.polls += 1
        return result

    def _scrape_kv_utilization(self, replica: Replica) -> Optional[float]:
        conn = http.client.HTTPConnection(replica.host, replica.port,
                                          timeout=self.probe_timeout_s)
        try:
            conn.request("GET", "/metrics")
            resp = conn.getresponse()
            text = resp.read().decode()
        finally:
            conn.close()
        if resp.status != 200:
            return None
        from ...observability.prometheus import parse_prometheus_text

        fam = parse_prometheus_text(text).get(KV_UTILIZATION_METRIC)
        if fam is None:
            return None
        v = fam.value()
        return None if v is None or v != v else float(v)  # NaN-safe

    # ------------------------------------------------------------- transitions
    def _apply(self, replica: Replica, result: ProbeResult, probed: bool = True):
        """Fold one observation into the replica's state machine. ``probed``
        distinguishes a real prober visit (stamps ``last_poll_t``, counts in
        ``health_polls_total``) from proxy forward feedback (state transition
        only — phantom probe bookkeeping would lie to operators)."""
        with self._lock:
            prev = replica.state
            if probed:
                replica.last_poll_t = time.time()
            replica.last_error = result.error
            if result.reachable and result.status == "ok":
                replica.consecutive_failures = 0
                replica.retry_after_s = None
                if prev in (DOWN, RECOVERING):
                    replica.recovery_streak += 1
                    replica.state = (HEALTHY if replica.recovery_streak >= self.recovery_polls
                                     else RECOVERING)
                else:
                    replica.state = HEALTHY
                outcome = "ok"
            elif result.reachable:
                # alive but shedding (degraded/draining): not a reachability
                # failure — it still owns its in-flight work
                replica.consecutive_failures = 0
                replica.recovery_streak = 0
                replica.state = DEGRADED
                replica.retry_after_s = result.retry_after_s
                outcome = "degraded"
            else:
                replica.consecutive_failures += 1
                replica.recovery_streak = 0
                replica.state = (DOWN if replica.consecutive_failures >= self.down_after
                                 else DEGRADED)
                # an unreachable replica's last Retry-After hint is stale — a
                # dead replica must not inflate retry_after_hint() forever
                replica.retry_after_s = None
                outcome = "error"
            if result.reachable:
                replica.inflight = result.inflight
                replica.queue_depth = result.queue_depth
                replica.brownout_level = result.brownout_level
                # proxy-feedback observations carry no version; keep the last
                # probed one rather than forgetting it
                if result.weights_version is not None:
                    replica.weights_version = result.weights_version
                if result.kv_utilization is not None:
                    replica.kv_utilization = result.kv_utilization
                if result.clock_offset_s is not None and result.rtt_s is not None:
                    replica.note_offset(result.rtt_s, result.clock_offset_s)
            new = replica.state
        if self.metrics is not None:
            self.metrics.replica_healthy.set(1.0 if new == HEALTHY else 0.0,
                                             replica=replica.id)
            if probed:
                self.metrics.health_polls.inc(replica=replica.id, outcome=outcome)
        if new != prev:
            logger.warning(f"router: replica {replica.id} {prev} -> {new}"
                           + (f" ({result.error})" if result.error else ""))
            self.tracer.instant("replica_state", cat="router", replica=replica.id,
                                prev=prev, state=new, error=result.error)

    # ------------------------------------------------------------- proxy feedback
    def note_forward_failure(self, replica_id: str):
        """A forward attempt hit a transport failure or a replica-side request
        failure — demote now instead of waiting for the next poll."""
        replica = self.get(replica_id)
        if replica is not None:
            self._apply(replica, ProbeResult(reachable=False, error="forward failure"),
                        probed=False)

    def note_degraded(self, replica_id: str, retry_after_s: Optional[float] = None):
        """A forward attempt got the replica's 503 circuit breaker."""
        replica = self.get(replica_id)
        if replica is not None:
            self._apply(replica, ProbeResult(reachable=True, status="degraded",
                                             inflight=replica.inflight,
                                             queue_depth=replica.queue_depth,
                                             retry_after_s=retry_after_s,
                                             brownout_level=replica.brownout_level),
                        probed=False)

    def clock_offset(self, replica_id: str) -> float:
        """Best current clock-offset estimate (replica tracer time minus router
        tracer time) for a replica; 0.0 before any estimate exists."""
        replica = self.get(replica_id)
        if replica is None or replica.clock_offset_s is None:
            return 0.0
        return replica.clock_offset_s

    def retry_after_hint(self) -> float:
        """Largest replica-reported Retry-After (>=1s floor) — what the router
        tells clients when every candidate is unavailable."""
        hints = [s.retry_after_s for s in self.snapshots() if s.retry_after_s]
        return max([1.0] + [float(h) for h in hints])
