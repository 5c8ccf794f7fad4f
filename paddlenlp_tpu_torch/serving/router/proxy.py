"""HTTP front tier: health-aware forwarding with cross-replica failover.

``RouterServer`` sits in front of N ``ServingServer`` replicas and owns three
concerns the replicas cannot solve alone:

- **placement** — every request gets an ordered candidate list from the
  routing policy (least-loaded or prefix-affinity) over live pool snapshots;
- **re-routing** — a replica 429 (window full) / 503 (draining or its engine
  supervisor's circuit breaker) or a connect failure moves the request to the
  next candidate *before anything reaches the client*
  (``paddlenlp_router_rerouted_total``);
- **failover** — when a replica fails a request it had already accepted
  (transport drop mid-stream, or an in-band ``finish_reason="engine_error"``
  terminal), the router splits on whether the client has seen tokens:

  - **no tokens emitted** → the request is transparently resubmitted to the
    next healthy replica with the failed one excluded (bounded by
    ``max_attempts``; the client's SSE connection and the router-side timing
    anchors are preserved — the stream just pauses), counted in
    ``paddlenlp_router_failovers_total``;
  - **mid-stream** → regenerating would re-emit divergent tokens, so the
    stream finishes **in-band** with ``finish_reason="replica_error"`` and a
    usage block covering what was actually relayed — exactly the engine-loop
    supervisor's ``engine_error`` contract, one level up.

Upstream completion ids are rewritten to the router's own ``rtr-N`` ids so a
failover is invisible to the client; ``POST /v1/abort`` is routed back to
whichever replica currently owns the stream. The router's own observability
plane (``/metrics``, ``/health``, ``/debug/trace``) rides on the shared
registry/tracer machinery.

**Elastic membership (admin plane).** ``GET/POST /replicas``, ``POST
/replicas/drain`` and ``DELETE /replicas/{id}`` mutate the fleet live: a
joined replica is probed before it serves, a draining replica stops
receiving new requests while its in-flight streams finish (the router's own
open-forward count is the completion signal; a drain that outlives its
deadline fails the stuck token-less streams over via the ordinary pre-token
resubmit path — the client's SSE connection never notices), and removal is
refused with 409 until the drain lands. Membership mutations run through the
``router.membership`` fault point before any state changes.

**Request hedging.** With ``hedge_after_s`` set, a request whose primary
forward produced no first event (stream) or response (batch) inside the
budget races a shadow forward on the next ring candidate: both legs feed a
shared queue, nothing reaches the client until one leg produces a usable
event, the winner relays and the loser is aborted (socket close +
``/v1/abort`` for streams with a known upstream id; batch losers are freed by
their failed response write). Bounded by ``max_hedges_inflight``; counted in
``paddlenlp_router_hedges_total{outcome}``.
Deterministic (greedy / fixed-seed) sampling hedges token-exactly; hedging
free-running sampled requests serves whichever stream wins (see the README
for when not to hedge).

**Fleet observability.** The router is where per-process planes become one:

- every forward carries a traceparent-style header (trace id + parent span id
  + sampled flag), and the replica adopts the ``rtr-N`` id instead of minting
  its own — ``GET /debug/trace?trace=rtr-N`` then fetches the owning replica's
  spans and stitches them with the router's into one multi-process Chrome
  trace, correcting clock skew with the offset the health poller estimates
  from probe-RTT midpoints;
- the 1-in-N trace sampling decision (``trace_sample_every``) is made ONCE
  here, by deterministic hash of the trace id, and propagated in the header —
  unsampled requests take the tracer's no-op path in every tier;
- ``GET /fleet/metrics`` merges the replicas' expositions (re-labeled
  ``{replica="..."}``), and ``GET /fleet/slo`` computes multi-window
  availability + TTFT burn rates over the federated counters
  (``observability/slo.py``), exposed as ``paddlenlp_slo_*`` on the router's
  own ``/metrics``.

A copy of ``paddlenlp_tpu/serving/router/proxy.py``: stdlib host code that
touches no tensor. Every body, code, header, metric, event and span name is
the JAX router's.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import http.client
import itertools
import json
import math
import os
import queue
import socket
import threading
import time
from collections import OrderedDict
from http.server import ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, quote, unquote, urlsplit

from ...observability.exporter import route_observability
from ...observability.flight_recorder import RECORDER
from ...observability.goodput import WASTE_KINDS
from ...observability.postmortem import PostmortemDumper, handle_postmortem_request
from ...observability.slo import (
    DEFAULT_WINDOWS_S,
    SLOInputs,
    SLOObjectives,
    SLOTracker,
    slo_inputs_from_families,
)
from ...observability.usage import merge_aggregates
from ...observability.tracer import (
    TRACEPARENT_HEADER,
    TRACER,
    SpanTracer,
    format_traceparent,
    merge_chrome_traces,
    trace_sampled,
    use_trace,
)
from ...utils.faults import FaultPoint, InjectedFault
from ...utils.log import logger
from ..httputil import JsonRequestHandler
from ..metrics import REGISTRY, MetricsRegistry
from ...observability.prometheus import parse_prometheus_text
from .metrics import RouterMetrics, federate_families
from .policy import resolve_policy
from .pool import (
    DEGRADED,
    DOWN,
    HEALTHY,
    RECOVERING,
    DrainPendingError,
    ReplicaPool,
    ReplicaSnapshot,
)
from .pool import push_brownout as pool_push_brownout

__all__ = ["RouterServer"]

MAX_BODY_BYTES = 8 << 20

_F_FORWARD = FaultPoint("router.forward")

# fires at the top of each per-replica rollout step (before the drain): an
# injected fault must abort the whole rollout, roll swapped replicas back,
# and leave every replica serving traffic
_F_ROLLOUT = FaultPoint("router.rollout")


class _RolloutFailure(RuntimeError):
    """One replica's rollout step failed. ``reason`` draws from the
    ``rollout.abort`` closed enum (event_catalog.EVENT_REASONS)."""

    def __init__(self, reason: str, detail: str, replica: Optional[str] = None):
        super().__init__(detail)
        self.reason = reason
        self.replica = replica

#: transport-level failures on the upstream leg; InjectedFault rides along so
#: the router.forward fault point is handled exactly like a real socket error
_UPSTREAM_ERRORS = (OSError, http.client.HTTPException, InjectedFault)


def _force_close(conn, resp=None):
    """Tear down an upstream leg from ANOTHER thread. A plain ``close()``
    only drops the fd — a reader blocked in ``recv`` stays blocked;
    ``shutdown()`` is what actually wakes it with an error. The socket may
    live on the connection (keep-alive) or — after ``getresponse()`` on a
    will-close SSE response — only on the response's reader, so both are
    tried."""
    socks = [getattr(conn, "sock", None)] if conn is not None else []
    if resp is not None:
        raw = getattr(getattr(resp, "fp", None), "raw", None)
        socks.append(getattr(raw, "_sock", None))
    for sock in socks:
        if sock is None:
            continue
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    for obj in (resp, conn):
        if obj is None:
            continue
        try:
            obj.close()
        except Exception:
            pass


def _read_sse_events(resp):
    """Parse one upstream SSE leg into ``("event", dict)`` / ``("done", None)``
    / ``("broke", err|None)`` items. "broke" covers transport errors AND a
    close without ``[DONE]`` (a crash, not a completion); the iterator always
    ends with a non-"event" item. ValueError joins the transport errors here
    because the connection may be closed under the reader on purpose (drain
    eviction, hedge-loser teardown)."""
    while True:
        try:
            line = resp.readline()
        except _UPSTREAM_ERRORS + (ValueError, AttributeError) as e:
            # ValueError/AttributeError: the response was closed UNDER the
            # reader (concurrent teardown races http.client's own close)
            yield ("broke", e)
            return
        if not line:
            yield ("broke", None)
            return
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        data = line[len(b"data: "):]
        if data == b"[DONE]":
            yield ("done", None)
            return
        try:
            ev = json.loads(data)
        except ValueError:
            continue
        yield ("event", ev)


@dataclasses.dataclass
class _Disposition:
    """How one upstream failure maps onto the router's attempt vocabulary."""

    outcome: str  # "reroute" | "failover" | "relay"
    replica_fault: bool = False  # demote the replica (skipped while draining)
    is_degraded: bool = False  # the replica said 503: note_degraded
    degraded_retry_after: Optional[str] = None  # raw Retry-After header, if any
    status: Optional[int] = None  # relay: verbatim status ...
    raw: bytes = b""  # ... and body

    def retry_after_s(self) -> Optional[float]:
        # RFC 7231 also allows an HTTP-date here; a non-numeric value from a
        # proxy in front of the replica degrades to "no hint", never a crash
        # on the relay path
        try:
            return float(self.degraded_retry_after) if self.degraded_retry_after else None
        except (TypeError, ValueError):
            return None


def _is_request_level_503(raw) -> bool:
    """True when a 503 body says the replica rejected THIS request's class
    (brownout shed / deadline-unmet), not that the replica itself is
    draining/degraded. Unparseable bodies count as replica-level (the
    conservative reading)."""
    try:
        etype = json.loads(raw or b"").get("error", {}).get("type")
    except (ValueError, AttributeError):
        return False
    return etype in ("overloaded_shed", "deadline_unmet")


def _classify_upstream_failure(kind: str, payload) -> _Disposition:
    """THE single upstream-failure → disposition mapper.

    Every way a replica can fail the router — batch or stream, plain or
    hedged leg — funnels through here with one of four failure kinds:

    - ``connect_failed``: transport error before/at the response (payload =
      the exception). Replica fault → re-route, demote (unless draining).
    - ``status``: non-200 HTTP status (payload = ``(status, raw_body,
      retry_after_header)``). 429/503 are *backpressure*, not fault →
      re-route and (503) mark degraded; ≥500 means accepted-then-failed →
      failover; anything else is the replica judging the REQUEST itself bad
      (400/413) → relay verbatim, another replica would say the same.
    - ``engine_error``: in-band supervisor give-up or an unparseable body.
      Accepted-then-failed → failover, and a replica fault for dead-leg
      accounting.
    - ``broke``: transport drop / close without ``[DONE]``. Same disposition
      as ``engine_error``.

    The *application* differs by context — an attempt's outcome switch
    already demotes on "failover" (:meth:`RouterServer._apply_failure`), a
    dead hedge leg never reaches that switch so it applies the
    ``replica_fault`` flag itself (:meth:`RouterServer._note_dead_leg`) —
    but the classification is written exactly once."""
    if kind == "connect_failed":
        return _Disposition("reroute", replica_fault=True)
    if kind == "status":
        status, raw, retry_after = payload
        if status in (429, 503):
            # per-REQUEST rejections (brownout shed of this priority class,
            # deadline-unmet on arrival) come from a healthy replica doing
            # its job — re-route in case another replica isn't browned out,
            # but never mark the replica degraded: a fleet-wide brownout
            # must not flap every healthy replica to DEGRADED
            return _Disposition(
                "reroute",
                is_degraded=status == 503 and not _is_request_level_503(raw),
                degraded_retry_after=retry_after)
        if status >= 500:
            return _Disposition("failover", replica_fault=True, status=status)
        return _Disposition("relay", status=status, raw=raw or b"")
    # engine_error / broke: the replica accepted the request, then failed it
    # before anything usable was relayed
    return _Disposition("failover", replica_fault=True)


class _RelayState:
    """Per-request relay bookkeeping shared across forward attempts. One
    instance per client request, written only by that request's handler
    thread. The drain enforcer (poller thread) additionally READS
    ``replica_id``/``tokens_relayed`` and closes ``upstream_conn`` to break a
    stuck read on a past-deadline draining replica — closing a socket that
    just finished or was replaced is a benign no-op, so these cross-thread
    touches need no lock."""

    __slots__ = ("rid", "stream", "headers_sent", "tokens_relayed", "arrival_t",
                 "attempts", "finished", "sampled", "replica_id", "upstream_conn",
                 "upstream_resp", "upstream_cid", "weights_version",
                 "upstream_path")

    def __init__(self, rid: str, stream: bool, sampled: bool = True,
                 upstream_path: str = "/v1/completions"):
        self.rid = rid
        self.stream = stream
        # which replica endpoint every forward attempt of this request hits
        # (/v1/completions, or /v1/chat/completions for chat requests — the
        # replica re-renders the conversation itself, so failover resubmits
        # the original chat body unchanged)
        self.upstream_path = upstream_path
        self.headers_sent = False
        self.tokens_relayed = 0
        self.arrival_t = time.perf_counter()  # original timing anchor
        self.attempts = 0
        self.finished = False  # a finish_reason chunk was relayed to the client
        self.sampled = sampled  # head-based trace sampling decision
        self.replica_id: Optional[str] = None  # replica of the current attempt
        self.upstream_conn = None  # live upstream HTTPConnection (drain eviction)
        self.upstream_resp = None  # its HTTPResponse (owns the socket once read)
        self.upstream_cid: Optional[str] = None  # upstream cmpl-N id once seen
        # base-weight version of the pinned replica at attempt start: a
        # mid-stream death during a fleet rollout terminates as version_skew
        # (not replica_error) when the stream's version is no longer served
        self.weights_version: Optional[str] = None


class RouterServer:
    """Multi-replica front tier over the replica pool + routing policy."""

    def __init__(self, replicas=(), pool: Optional[ReplicaPool] = None,
                 policy="least_loaded", registry: Optional[MetricsRegistry] = None,
                 max_attempts: int = 3, max_body_bytes: int = MAX_BODY_BYTES,
                 poll_interval_s: float = 1.0, probe_timeout_s: float = 2.0,
                 upstream_timeout_s: float = 600.0,
                 trace_sample_every: int = 1,
                 tracer: Optional[SpanTracer] = None,
                 slo_objectives: Optional[SLOObjectives] = None,
                 slo_windows_s: Sequence[float] = DEFAULT_WINDOWS_S,
                 scrape_timeout_s: float = 5.0,
                 hedge_after_s: Optional[float] = None,
                 max_hedges_inflight: int = 4,
                 brownout_push_level: Optional[int] = 1):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if trace_sample_every < 1:
            raise ValueError("trace_sample_every must be >= 1")
        if hedge_after_s is not None and hedge_after_s <= 0:
            raise ValueError("hedge_after_s must be > 0 (None disables hedging)")
        if max_hedges_inflight < 0:
            raise ValueError("max_hedges_inflight must be >= 0")
        self.registry = registry or REGISTRY
        # a private tracer keeps router spans out of in-process replicas' rings
        # (the launcher passes one); a dedicated router process uses the global
        self.tracer = tracer if tracer is not None else TRACER
        self.trace_sample_every = trace_sample_every
        self.scrape_timeout_s = scrape_timeout_s
        self.metrics = RouterMetrics(self.registry)
        self.slo = SLOTracker(objectives=slo_objectives, windows_s=slo_windows_s,
                              registry=self.registry)
        # router-tier black box: drain-deadline evictions and SLO fast burns
        # auto-dump a bundle (opt-in via PDNLP_TPU_POSTMORTEM_DIR); on demand
        # via POST /debug/postmortem. The process-wide flight recorder is
        # shared with in-process replicas, so a router bundle already joins
        # both tiers' decision events on the trace id.
        self.postmortem = PostmortemDumper(
            registry=self.registry, tracer=self.tracer, tier="router",
            health_fn=self._postmortem_health, config_fn=self._postmortem_config)
        self.slo.on_fast_burn = self._on_fast_burn
        self.pool = pool if pool is not None else ReplicaPool(
            metrics=self.metrics, poll_interval_s=poll_interval_s,
            probe_timeout_s=probe_timeout_s, tracer=self.tracer)
        if self.pool.metrics is None:
            self.pool.metrics = self.metrics
        for spec in replicas:
            self.pool.add(spec[0], int(spec[1]), *spec[2:3])
        self.policy = resolve_policy(policy)
        self.max_attempts = max_attempts
        self.max_body_bytes = max_body_bytes
        self.upstream_timeout_s = upstream_timeout_s
        # hedging: after hedge_after_s with no first token, race a shadow
        # request on the next candidate (None = off); the cap bounds how many
        # shadows the router may have open at once fleet-wide
        self.hedge_after_s = hedge_after_s
        self.max_hedges_inflight = max_hedges_inflight
        # SLO fast burn -> replica brownout push: the same best-effort
        # propagation channel drains use (None disables). Rate-limited so a
        # sustained burn costs one push per window, not one per scrape.
        self.brownout_push_level = brownout_push_level
        self._brownout_push_lock = threading.Lock()
        self._last_brownout_push_t = 0.0  # guarded-by: _brownout_push_lock
        self._hedge_lock = threading.Lock()
        self._hedges_inflight = 0  # guarded-by: _hedge_lock
        self._ids = itertools.count()
        self._live: Dict[str, Tuple[str, str]] = {}  # rid -> (replica_id, upstream cid)
        self._live_lock = threading.Lock()
        # relay states with an attempt in flight (drain-deadline eviction
        # walks this to find token-less streams on the draining replica)
        self._active: set = set()  # guarded-by: _live_lock
        # membership hooks: drain completion tracks the router's own open
        # forwards; the deadline hook fails stuck token-less streams over
        self.pool.drain_live = self._open_forwards_on
        self.pool.on_drain_deadline = self._drain_deadline_failover
        # trace id -> owning replica, SURVIVING request finish (stitching a
        # trace is most useful after the request completed); bounded LRU
        self._trace_owner: "OrderedDict[str, str]" = OrderedDict()
        self._trace_owner_cap = 1024
        # router-side in-flight per replica: the poller's inflight reading is
        # up to a poll interval stale, so a burst arriving between polls would
        # all see the same "least-loaded" replica — forwards the router itself
        # has open are folded into the score instead
        self._forward_inflight: Dict[str, int] = {}
        self._inflight_lock = threading.Lock()
        # rolling weight rollout: one at a time fleet-wide; the state doc is
        # what GET /admin/weights/rollout (and /replicas) report
        self._rollout_lock = threading.Lock()
        self._rollout: Optional[Dict] = None  # guarded-by: _rollout_lock
        self._rollout_thread: Optional[threading.Thread] = None
        self._httpd: Optional[ThreadingHTTPServer] = None

    # ------------------------------------------------------------- routing
    def _candidates(self, prompt, exclude: set, state: _RelayState,
                    adapter_id: Optional[str] = None,
                    conversation: Optional[str] = None) -> List[ReplicaSnapshot]:
        """One routing decision: snapshot the pool, let the policy order it.
        Re-run per attempt so health transitions observed mid-request (a
        candidate marked DOWN by the poller) are honored immediately.
        ``adapter_id`` feeds adapter affinity and ``conversation`` feeds
        conversation stickiness (forwarded only when present, and dropped
        for policies predating the kwargs)."""
        t0 = time.perf_counter()
        with self.tracer.span("route", cat="router", trace=state.rid,
                              attempt=state.attempts, excluded=len(exclude)) as sp:
            snaps = self._adjusted_snapshots()
            kw = {}
            if adapter_id is not None:
                kw["adapter_id"] = adapter_id
            if conversation is not None:
                kw["conversation"] = conversation
            try:
                candidates = self.policy.select(snaps, prompt=prompt,
                                                exclude=frozenset(exclude), **kw)
            except TypeError:
                if not kw:
                    raise
                # custom policy without the affinity kwargs: route on prompt only
                candidates = self.policy.select(snaps, prompt=prompt,
                                                exclude=frozenset(exclude))
            sp.set(candidates=[c.id for c in candidates[:4]])
        self.metrics.route_decision.observe(time.perf_counter() - t0)
        return candidates

    def _adjusted_snapshots(self) -> List[ReplicaSnapshot]:
        with self._inflight_lock:
            fly = {k: v for k, v in self._forward_inflight.items() if v > 0}
        if not fly:
            return self.pool.snapshots()
        return [dataclasses.replace(s, inflight=s.inflight + fly.get(s.id, 0))
                for s in self.pool.snapshots()]

    def _inflight_delta(self, replica_id: str, delta: int):
        with self._inflight_lock:
            cur = self._forward_inflight.get(replica_id)
            if cur is None and delta < 0:
                # the replica was force-removed (entry popped) while this
                # forward was still open: recreating the key at a negative
                # value would poison the drain-completion signal for a
                # re-added id of the same name
                return
            self._forward_inflight[replica_id] = max((cur or 0) + delta, 0)

    def _open_forwards_on(self, replica_id: str) -> int:
        """Forwards the router currently has open against one replica — the
        pool's drain-completion signal (covers streams from accept to finish,
        including legs that have not produced an event yet)."""
        with self._inflight_lock:
            return self._forward_inflight.get(replica_id, 0)

    # ------------------------------------------------------------- drain eviction
    def _drain_deadline_failover(self, replica_id: str):
        """A drain outlived its deadline: break every TOKEN-LESS stream still
        pinned to the draining replica so its relay takes the ordinary
        pre-token resubmit path onto a surviving candidate (the client's SSE
        connection never notices). Streams that already relayed tokens are
        actively progressing and are left to finish — regenerating them
        elsewhere would diverge the stream. Runs on the pool's poller thread."""
        with self._live_lock:
            victims = [(st, st.upstream_conn, st.upstream_resp, st.upstream_cid)
                       for st in self._active
                       if st.replica_id == replica_id and st.tokens_relayed == 0]
        evicted = 0
        for st, conn, resp, cid in victims:
            if st.replica_id != replica_id or st.tokens_relayed != 0:
                # the relay moved on between the snapshot and now — failed
                # over to a survivor, or relayed its first token (the abort
                # call for an earlier victim can take seconds): a token-
                # bearing stream is exactly what the drain promises to leave
                # alone, and a failed-over one owns a new leg we must not break
                continue
            # relay read breaks -> pre-token failover
            _force_close(conn, resp)
            if cid is not None:
                # also free the replica-side slot/KV promptly (a queued
                # request would otherwise only notice on its first write).
                # Off-thread: this runs on the pool's POLLER thread, and a
                # wedged replica — the usual reason a deadline fired — would
                # otherwise stall every health probe for the abort timeout
                replica = self.pool.get(replica_id)
                if replica is not None:
                    threading.Thread(
                        target=self._abort_replica_request,
                        args=(replica.host, replica.port, cid),
                        daemon=True, name=f"drain-abort-{st.rid}").start()
            evicted += 1
            RECORDER.record("router.drain_evict", trace=st.rid, replica=replica_id)
            self.tracer.instant("membership", cat="router", op="drain_evict",
                                trace=st.rid, replica=replica_id)
        if evicted:
            # a drain that had to break streams is an incident worth a black
            # box (rate-limited; opt-in via PDNLP_TPU_POSTMORTEM_DIR)
            self.postmortem.dump("drain_evict", detail={
                "replica": replica_id, "evicted_streams": evicted})

    def _abort_replica_request(self, host: str, port: int, upstream_cid: str) -> bool:
        """POST /v1/abort for one upstream completion id (best effort)."""
        try:
            conn = http.client.HTTPConnection(host, port, timeout=10)
            try:
                conn.request("POST", "/v1/abort",
                             body=json.dumps({"id": upstream_cid}).encode(),
                             headers={"Content-Type": "application/json"})
                body = json.loads(conn.getresponse().read() or b"{}")
            finally:
                conn.close()
            return bool(body.get("cancelled"))
        except _UPSTREAM_ERRORS + (ValueError,) as e:
            logger.debug(f"router: upstream abort of {upstream_cid} failed: {e!r}")
            return False

    # ------------------------------------------------------------- hedge slots
    def _try_start_hedge(self) -> bool:
        with self._hedge_lock:
            if self._hedges_inflight >= self.max_hedges_inflight:
                return False
            self._hedges_inflight += 1
            return True

    def _release_hedge(self):
        with self._hedge_lock:
            self._hedges_inflight -= 1

    def _finish(self, state: _RelayState, replica_id: str, outcome: str):
        self.metrics.requests.inc(replica=replica_id, outcome=outcome)
        # NOT named "request": that name is the engine loop's per-request
        # timeline span, and /debug/trace consumers select by name
        self.tracer.add_span("router_request", self.tracer.epoch_time(state.arrival_t),
                             time.perf_counter() - state.arrival_t, cat="router",
                             trace=state.rid, replica=replica_id, outcome=outcome,
                             attempts=state.attempts, tokens=state.tokens_relayed)
        if replica_id != "none":
            self._note_owner(state.rid, replica_id)
        with self._live_lock:
            self._live.pop(state.rid, None)

    def _note_owner(self, rid: str, replica_id: str):
        with self._live_lock:
            self._trace_owner[rid] = replica_id
            self._trace_owner.move_to_end(rid)
            while len(self._trace_owner) > self._trace_owner_cap:
                self._trace_owner.popitem(last=False)

    def _track(self, state: _RelayState, replica_id: str, upstream_cid: str):
        with self._live_lock:
            self._live[state.rid] = (replica_id, upstream_cid)
        self._note_owner(state.rid, replica_id)

    # ------------------------------------------------------------- abort
    def abort(self, rid: str) -> bool:
        """Route a client abort to whichever replica owns the stream now."""
        with self._live_lock:
            owner = self._live.get(rid)
        if owner is None:
            return False
        replica_id, upstream_cid = owner
        replica = self.pool.get(replica_id)
        if replica is None:
            return False
        ok = self._abort_replica_request(replica.host, replica.port, upstream_cid)
        if not ok:
            logger.warning(f"router: abort of {rid} on {replica_id} failed")
        return ok

    # ------------------------------------------------------------- http plumbing
    def _make_httpd(self, host: str, port: int) -> ThreadingHTTPServer:
        router = self

        class Handler(JsonRequestHandler):
            log_prefix = "router"

            @property
            def max_body_bytes(self):  # live read: the cap is router-tunable
                return router.max_body_bytes

            def do_GET(self):
                try:
                    parts = urlsplit(self.path)
                    stitch_trace = None
                    if parts.path == "/debug/trace":
                        query = parse_qs(parts.query)
                        # a since_ts cursor means an incremental scrape of the
                        # router's own ring (route_observability contract) —
                        # only plain ?trace= requests pay for a two-tier stitch
                        if "since_ts" not in query:
                            stitch_trace = query.get("trace", [None])[0]
                    if stitch_trace is not None:
                        # two-tier stitch when the owning replica is known;
                        # falls back to the router-only timeline otherwise
                        doc = router.stitched_trace(stitch_trace)
                        self._send_raw(200, json.dumps(doc).encode(), "application/json")
                        return
                    if parts.path == "/fleet/metrics":
                        text, _skipped = router.fleet_metrics()
                        self._send_raw(200, text.encode(),
                                       "text/plain; version=0.0.4; charset=utf-8")
                        return
                    if parts.path == "/fleet/slo":
                        self._send_json(200, router.fleet_slo())
                        return
                    if parts.path == "/debug/efficiency":
                        self._send_json(200, router.fleet_efficiency())
                        return
                    if parts.path == "/fleet/usage":
                        self._send_json(200, router.fleet_usage())
                        return
                    if parts.path == "/replicas":
                        self._send_json(200, router.admin_list_replicas())
                        return
                    if parts.path == "/admin/weights/rollout":
                        self._send_json(200, {"rollout": router.rollout_status()})
                        return
                    routed = route_observability(self.path, router.registry, router.tracer)
                    if routed is not None:
                        self._send_raw(routed[0], routed[2], routed[1])
                    elif self.path == "/health":
                        status, code = router.health_status()
                        self._send_json(code, {
                            "status": status,
                            "policy": getattr(router.policy, "name", type(router.policy).__name__),
                            "replicas": [s.to_dict() for s in router.pool.snapshots()],
                        })
                    else:
                        self._send_error_json(404, f"no route {self.path}", "not_found")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("router: client disconnected during GET")

            def do_POST(self):
                try:
                    if self.path == "/v1/completions":
                        payload = self._read_body()
                        if payload is not None:
                            router._handle_completion(self, payload)
                    elif self.path == "/v1/chat/completions":
                        payload = self._read_body()
                        if payload is not None:
                            router._handle_completion(self, payload, chat=True)
                    elif self.path == "/v1/abort":
                        payload = self._read_body()
                        if payload is not None:
                            ok = router.abort(str(payload.get("id", "")))
                            self._send_json(200, {"id": payload.get("id"), "cancelled": ok})
                    elif self.path == "/replicas":
                        payload = self._read_body()
                        if payload is not None:
                            code, doc = router.admin_add_replica(payload)
                            self._send_json(code, doc)
                    elif self.path == "/replicas/drain":
                        payload = self._read_body()
                        if payload is not None:
                            code, doc = router.admin_drain_replica(payload)
                            self._send_json(code, doc)
                    elif self.path == "/admin/adapters":
                        payload = self._read_body()
                        if payload is not None:
                            code, doc = router.admin_adapters_fleet(payload)
                            self._send_json(code, doc)
                    elif self.path == "/admin/weights/rollout":
                        payload = self._read_body()
                        if payload is not None:
                            code, doc = router.admin_weights_rollout(payload)
                            self._send_json(code, doc)
                    elif self.path.split("?", 1)[0] == "/debug/postmortem":
                        # drain any request body first (keep-alive hygiene)
                        n = int(self.headers.get("Content-Length") or 0)
                        if n:
                            self.rfile.read(n)
                        routed = handle_postmortem_request(self.path, router.postmortem)
                        self._send_raw(routed[0], routed[2], routed[1])
                    else:
                        self._send_error_json(404, f"no route {self.path}", "not_found")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("router: client disconnected during POST")
                except Exception as e:
                    # includes an injected router.membership fault: the admin
                    # mutation fired BEFORE any state change, so a clean 500
                    # here means the pool is exactly as it was
                    logger.warning(f"router: error on {self.path}: {e!r}")
                    try:
                        self._send_error_json(500, str(e), "internal_error")
                    except (BrokenPipeError, ConnectionResetError):
                        pass

            def do_DELETE(self):
                try:
                    parts = urlsplit(self.path)
                    if parts.path.startswith("/replicas/"):
                        rid = unquote(parts.path[len("/replicas/"):])
                        force = parse_qs(parts.query).get("force", ["0"])[0] \
                            in ("1", "true")
                        code, doc = router.admin_remove_replica(rid, force=force)
                        self._send_json(code, doc)
                    else:
                        self._send_error_json(404, f"no route {self.path}", "not_found")
                except (BrokenPipeError, ConnectionResetError):
                    logger.debug("router: client disconnected during DELETE")
                except Exception as e:
                    logger.warning(f"router: error on {self.path}: {e!r}")
                    try:
                        self._send_error_json(500, str(e), "internal_error")
                    except (BrokenPipeError, ConnectionResetError):
                        pass

        httpd = ThreadingHTTPServer((host, port), Handler)
        httpd.daemon_threads = True
        return httpd

    # ------------------------------------------------------------- admin plane
    def admin_list_replicas(self) -> Dict:
        """Live membership view: every pooled replica's snapshot + drain
        status + the router's own open forwards, plus removal tombstones."""
        replicas = []
        for snap in self.pool.snapshots():
            doc = snap.to_dict()
            doc["drain"] = self.pool.drain_status(snap.id)
            doc["open_forwards"] = self._open_forwards_on(snap.id)
            replicas.append(doc)
        return {"replicas": replicas, "removed": self.pool.removed(),
                # mixed-version visibility: per-replica weights_version above,
                # plus the rollout (if any) responsible for the mix
                "rollout": self.rollout_status()}

    def admin_add_replica(self, payload: dict) -> Tuple[int, Dict]:
        """POST /replicas {"host", "port", "id"?}: join a replica to the pool.
        One synchronous poll sweep runs before the 200 so the first routing
        decision already sees the newcomer's real health/load."""
        host, port = payload.get("host"), payload.get("port")
        if not host or not port:
            return 400, {"error": {"message": "host and port are required",
                                   "type": "invalid_request", "code": 400}}
        try:
            port = int(port)
        except (TypeError, ValueError):
            # validated BEFORE pool.add so a malformed port cannot masquerade
            # as the duplicate-id 409 (an autoscaler treats 409 as "present")
            return 400, {"error": {"message": f"port must be an integer, got {port!r}",
                                   "type": "invalid_request", "code": 400}}
        try:
            replica = self.pool.add(str(host), port,
                                    str(payload["id"]) if payload.get("id") else None)
        except ValueError as e:
            return 409, {"error": {"message": str(e),
                                   "type": "already_registered", "code": 409}}
        self.metrics.membership_changes.inc(op="add")
        self.pool.probe_one(replica.id)
        return 200, {"replica": replica.snapshot().to_dict()}

    def admin_drain_replica(self, payload: dict) -> Tuple[int, Dict]:
        """POST /replicas/drain {"id", "deadline_s"?}: stop offering the
        replica new requests; in-flight streams finish (token-less ones are
        failed over once the deadline expires). DELETE completes the exit."""
        rid = str(payload.get("id", ""))
        try:
            deadline_s = float(payload.get("deadline_s", 30.0))
            if not math.isfinite(deadline_s):
                # json.loads admits NaN/Infinity, and a NaN deadline never
                # compares past due — the drain would be un-completable
                raise ValueError
        except (TypeError, ValueError):
            return 400, {"error": {
                "message": f"deadline_s must be a finite number, got {payload.get('deadline_s')!r}",
                "type": "invalid_request", "code": 400}}
        try:
            status = self.pool.start_drain(rid, deadline_s=deadline_s)
        except KeyError:
            return 404, {"error": {"message": f"unknown replica {rid!r}",
                                   "type": "unknown_replica", "code": 404}}
        self.metrics.membership_changes.inc(op="drain")
        # replica-side propagation: tell the ServingServer itself so DIRECT
        # traffic (clients bypassing the router) also sees 503 + Retry-After.
        # Best-effort off-thread — a wedged replica must not stall the admin
        # plane, and the router-side drain is already in force either way
        replica = self.pool.get(rid)
        if replica is not None:
            threading.Thread(
                target=self._propagate_drain,
                args=(replica.host, replica.port, deadline_s),
                daemon=True, name=f"drain-propagate-{rid}").start()
        return 200, {"drain": status}

    def _propagate_drain(self, host: str, port: int, deadline_s: float) -> bool:
        """POST /admin/drain on the draining replica (best effort)."""
        try:
            conn = http.client.HTTPConnection(host, port, timeout=10)
            try:
                conn.request("POST", "/admin/drain",
                             body=json.dumps({"retry_after_s": deadline_s}).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
            finally:
                conn.close()
            return resp.status == 200
        except _UPSTREAM_ERRORS + (ValueError,) as e:
            logger.debug(f"router: drain propagation to {host}:{port} failed: {e!r}")
            return False

    def admin_remove_replica(self, rid: str, force: bool = False) -> Tuple[int, Dict]:
        """DELETE /replicas/{id}[?force=1]: take a drained (or DOWN) replica
        out of the pool; 409 while its drain is still in progress."""
        try:
            tomb = self.pool.remove(rid, force=force)
        except KeyError:
            return 404, {"error": {"message": f"unknown replica {rid!r}",
                                   "type": "unknown_replica", "code": 404}}
        except DrainPendingError as e:
            return 409, {"error": {"message": str(e),
                                   "type": "drain_pending", "code": 409}}
        self.metrics.membership_changes.inc(op="remove")
        with self._inflight_lock:
            # drop the (zero, by drain-completion) accounting entry — one
            # leaked key per scale-down would accumulate under churn
            self._forward_inflight.pop(rid, None)
        return 200, {"replica": tomb}

    def health_status(self) -> Tuple[str, int]:
        states = {s.state for s in self.pool.snapshots()}
        if states & {HEALTHY, RECOVERING}:
            return "ok", 200
        if DEGRADED in states:
            # still routable — the breaker may lift between poll and forward
            return "degraded", 200
        return "unhealthy", 503

    # ------------------------------------------------------------- fleet planes
    def _scrape_replica(self, snap: ReplicaSnapshot, path: str) -> str:
        conn = http.client.HTTPConnection(snap.host, snap.port,
                                          timeout=self.scrape_timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            text = resp.read().decode()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{snap.id}{path}: HTTP {resp.status}")
        return text

    def fleet_families(self) -> Tuple[Dict[str, Dict], List[str]]:
        """Scrape + parse every non-DOWN replica's ``/metrics``. Returns
        ``({replica_id: parsed families}, [skipped ids])`` — a dead,
        unreachable, or unparseable replica shrinks the merge, it never fails
        it (partial fleet data beats no fleet data during exactly the
        incidents you scrape during). Scrapes run concurrently: one wedged
        replica that the poller hasn't demoted yet costs the whole merge one
        scrape timeout, not a timeout per bad replica."""
        out: Dict[str, Dict] = {}
        skipped: List[str] = []

        def scrape(snap):
            return snap.id, parse_prometheus_text(
                self._scrape_replica(snap, "/metrics"))

        live = []
        for snap in self.pool.snapshots():
            if snap.state == DOWN:
                skipped.append(snap.id)
            else:
                live.append(snap)
        if not live:
            return out, skipped
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(live))) as pool:
            futures = {pool.submit(scrape, s): s for s in live}
            for fut in concurrent.futures.as_completed(futures):
                snap = futures[fut]
                try:
                    rid, fams = fut.result()
                    out[rid] = fams
                except Exception as e:
                    logger.warning(f"router: fleet scrape of {snap.id} failed: {e!r}")
                    self.metrics.fleet_scrape_errors.inc(replica=snap.id)
                    skipped.append(snap.id)
        return out, skipped

    def fleet_metrics(self) -> Tuple[str, List[str]]:
        """Federated exposition: every replica's samples under one scrape,
        re-labeled ``{replica="..."}``."""
        parsed, skipped = self.fleet_families()
        return federate_families(parsed), skipped

    def fleet_slo(self) -> Dict:
        """Scrape → fold → burn rates. Each call is one SLO observation; the
        tracker's history turns successive scrapes into windowed rates."""
        parsed, skipped = self.fleet_families()
        inputs = SLOInputs()
        for fams in parsed.values():
            inputs = inputs + slo_inputs_from_families(fams, self.slo.objectives)
        now = time.time()
        self.slo.observe(inputs, now=now)
        report = self.slo.report(now=now)
        report["replicas"] = sorted(parsed)
        report["skipped"] = skipped
        stages = self._fold_stage_series(parsed)
        if stages:
            # disaggregated replicas: TTFT and inter-token latency come from
            # different pools — surface both pressures in the SLO view so an
            # operator sees WHICH stage is burning budget
            report["stages"] = stages
        goodput = self._fold_goodput_series(parsed)
        if goodput:
            # per-replica device efficiency in the same fleet view the
            # autoscaler and on-call dashboards already scrape: an SLO burn
            # with a healthy goodput is a capacity problem; one with a
            # collapsing goodput is a padding/retrace/waste problem
            report["goodput"] = goodput
        return report

    @staticmethod
    def _fold_goodput_series(parsed: Dict[str, Dict]) -> Dict:
        """Fleet fold of the goodput-ledger counters each replica exports:
        per-replica useful/fed ratio + the fleet-wide waste decomposition.
        Empty when no replica exposes the ledger series (mixed-version
        fleets degrade to the old report shape)."""
        per_replica: Dict[str, Dict] = {}
        fleet_fed = fleet_useful = 0.0
        wasted: Dict[str, float] = {}
        for rid, fams in parsed.items():
            fed_fam = fams.get("paddlenlp_serving_fed_tokens_total")
            if fed_fam is None:
                continue
            fed = fed_fam.value() or 0.0
            useful_fam = fams.get("paddlenlp_serving_useful_tokens_total")
            useful = (useful_fam.value() or 0.0) if useful_fam is not None else 0.0
            per_replica[rid] = {
                "fed_tokens": fed,
                "useful_tokens": useful,
                "goodput_ratio": round(useful / fed, 6) if fed else 1.0,
            }
            fleet_fed += fed
            fleet_useful += useful
            waste_fam = fams.get("paddlenlp_serving_wasted_tokens_total")
            if waste_fam is not None:
                for (_sample, labels), v in waste_fam.samples.items():
                    kind = dict(labels).get("kind")
                    if kind:
                        wasted[kind] = wasted.get(kind, 0.0) + v
        if not per_replica:
            return {}
        return {
            "replicas": per_replica,
            "fleet": {
                "fed_tokens": fleet_fed,
                "useful_tokens": fleet_useful,
                "goodput_ratio": round(fleet_useful / fleet_fed, 6) if fleet_fed else 1.0,
                "wasted_tokens": {k: wasted[k] for k in sorted(wasted)},
            },
        }

    def fleet_efficiency(self) -> Dict:
        """Router-tier ``GET /debug/efficiency``: every live replica's
        efficiency doc plus a fed-token-weighted fleet goodput summary. A
        replica that fails the scrape is listed in ``skipped`` — the fold
        degrades, it never 500s (the /fleet/metrics contract)."""
        docs: Dict[str, Dict] = {}
        skipped: List[str] = []
        for snap in self.pool.snapshots():
            if snap.state == DOWN:
                skipped.append(snap.id)
                continue
            try:
                docs[snap.id] = json.loads(
                    self._scrape_replica(snap, "/debug/efficiency"))
            except Exception as e:
                logger.warning(
                    f"router: efficiency scrape of {snap.id} failed: {e!r}")
                skipped.append(snap.id)
        fed = useful = 0
        wasted: Dict[str, int] = {}
        for doc in docs.values():
            totals = ((doc.get("ledger") or {}).get("totals")) or {}
            fed += totals.get("fed", 0)
            useful += totals.get("useful", 0)
            for kind in WASTE_KINDS:
                if totals.get(kind):
                    wasted[kind] = wasted.get(kind, 0) + totals[kind]
        return {
            "tier": "router",
            "replicas": docs,
            "skipped": skipped,
            "fleet": {
                "fed_tokens": fed,
                "useful_tokens": useful,
                "goodput_ratio": round(useful / fed, 6) if fed else 1.0,
                "wasted_tokens": wasted,
            },
        }

    def fleet_usage(self) -> Dict:
        """Router-tier ``GET /fleet/usage``: every live replica's rolling
        usage aggregate plus a fleet sum per tenant/adapter. Same degrade
        contract as the other fleet planes: a failed scrape lands the replica
        in ``skipped`` and shrinks the fold — never a 500. NOTE this is the
        *rolling* (per-replica-lifetime) view: a request that failed over
        mid-stream may appear on two replicas; the offline
        ``tools/usage_report.py`` merge over the durable ledgers dedups by
        record id and is the billing-authoritative number."""
        docs: Dict[str, Dict] = {}
        skipped: List[str] = []
        for snap in self.pool.snapshots():
            if snap.state == DOWN:
                skipped.append(snap.id)
                continue
            try:
                docs[snap.id] = json.loads(
                    self._scrape_replica(snap, "/debug/usage"))
            except Exception as e:
                logger.warning(
                    f"router: usage scrape of {snap.id} failed: {e!r}")
                skipped.append(snap.id)
        return {
            "tier": "router",
            "replicas": docs,
            "skipped": skipped,
            "fleet": merge_aggregates(docs.values()),
        }

    def admin_adapters_fleet(self, payload: dict) -> Tuple[int, Dict]:
        """POST /admin/adapters at the router: fan the adapter op (load /
        unload / list) out to every live replica so one call changes the
        whole fleet's adapter catalog. Best-effort per replica (the
        drain-propagation contract): a DOWN replica is skipped, a failed or
        rejected propagation is reported per replica — the call itself
        always answers 200 with the outcome map, because partial application
        is the *expected* steady state under churn (a replica that missed
        the load will 404 per request and the client retries elsewhere)."""
        results: Dict[str, Dict] = {}
        skipped: List[str] = []

        def push(snap):
            conn = http.client.HTTPConnection(snap.host, snap.port, timeout=10)
            try:
                conn.request("POST", "/admin/adapters",
                             body=json.dumps(payload).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read().decode()
            finally:
                conn.close()
            try:
                doc = json.loads(body)
            except ValueError:
                doc = {"raw": body[:512]}
            return resp.status, doc

        live = []
        for snap in self.pool.snapshots():
            if snap.state == DOWN:
                skipped.append(snap.id)
            else:
                live.append(snap)
        if live:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(8, len(live))) as pool:
                futures = {pool.submit(push, s): s for s in live}
                for fut in concurrent.futures.as_completed(futures):
                    snap = futures[fut]
                    try:
                        status, doc = fut.result()
                        results[snap.id] = {"status": status,
                                            "ok": status == 200,
                                            "response": doc}
                    except Exception as e:
                        logger.warning(
                            f"router: adapter op on {snap.id} failed: {e!r}")
                        results[snap.id] = {"status": None, "ok": False,
                                            "error": repr(e)}
        ok = sorted(r for r, d in results.items() if d["ok"])
        failed = sorted(r for r, d in results.items() if not d["ok"])
        return 200, {"op": payload.get("op", "list"), "replicas": results,
                     "skipped": skipped, "ok": ok, "failed": failed}

    # ------------------------------------------------------------- weight rollout
    def rollout_status(self) -> Optional[Dict]:
        """Point-in-time copy of the current/last rollout's state doc (None
        before the first rollout). Served on GET /admin/weights/rollout and
        embedded in GET /replicas for mixed-version-fleet visibility."""
        with self._rollout_lock:
            return dict(self._rollout) if self._rollout is not None else None

    def _rollout_set(self, **kw):
        with self._rollout_lock:
            if self._rollout is not None:
                self._rollout.update(kw)

    def _rollout_append(self, key: str, value):
        with self._rollout_lock:
            if self._rollout is not None:
                self._rollout[key].append(value)

    def admin_weights_rollout(self, payload: dict) -> Tuple[int, Dict]:
        """POST /admin/weights/rollout: rolling fleet weight update, one
        replica at a time — drain → swap (replica-side validate + canary +
        all-or-nothing install) → un-drain → health-gated rejoin → next. The
        first failure aborts the whole rollout and rolls already-swapped
        replicas back (see :meth:`_abort_rollout`). ::

            {"ckpt_dir": str, "version"?, "rollback_ckpt_dir"?,
             "canary_digest"?, "mode"?: "finish_old"|"pause_resume",
             "drain_deadline_s"?, "rejoin_timeout_s"?, "swap_timeout_s"?,
             "wait"?: bool}

        Asynchronous by default (poll GET /admin/weights/rollout);
        ``wait=true`` blocks until the rollout lands or aborts (409)."""
        ckpt_dir = payload.get("ckpt_dir")
        if not ckpt_dir or not isinstance(ckpt_dir, str):
            return 400, {"error": {"message": "missing required field 'ckpt_dir'",
                                   "type": "invalid_request", "code": 400}}
        version = str(payload.get("version")
                      or os.path.basename(os.path.normpath(ckpt_dir)))
        try:
            plan = {
                "version": version,
                "ckpt_dir": ckpt_dir,
                "rollback_ckpt_dir": payload.get("rollback_ckpt_dir"),
                "canary_digest": payload.get("canary_digest"),
                "mode": payload.get("mode"),
                "drain_deadline_s": float(payload.get("drain_deadline_s", 30.0)),
                "rejoin_timeout_s": float(payload.get("rejoin_timeout_s", 30.0)),
                "swap_timeout_s": float(payload.get("swap_timeout_s", 120.0)),
            }
        except (TypeError, ValueError) as e:
            return 400, {"error": {"message": f"bad rollout parameter: {e}",
                                   "type": "invalid_request", "code": 400}}
        # target set fixed at submission: live, non-draining replicas in
        # snapshot order (a replica joining mid-rollout is NOT picked up —
        # it should be provisioned from the new checkpoint anyway)
        targets = [s for s in self.pool.snapshots()
                   if s.state != DOWN and not s.draining]
        if not targets:
            return 409, {"error": {"message": "no live replica to roll out to",
                                   "type": "rollout_refused", "code": 409}}
        state = {
            "version": version, "ckpt_dir": ckpt_dir,
            "rollback_ckpt_dir": plan["rollback_ckpt_dir"],
            "status": "running", "replicas": [s.id for s in targets],
            "completed": [], "skipped": [], "rolled_back": [],
            "rollback_failed": [], "rollback_skipped": False,
            "current": None, "abort_reason": None, "error": None,
            "wall_s": None,
        }
        with self._rollout_lock:
            if self._rollout is not None and self._rollout.get("status") == "running":
                return 409, {"error": {
                    "message": f"a rollout to {self._rollout['version']!r} is "
                               "already running",
                    "type": "rollout_in_progress", "code": 409}}
            self._rollout = state
        if payload.get("wait"):
            self._run_rollout(state, plan, targets)
            final = self.rollout_status()
            return (200 if final["status"] == "done" else 409), {"rollout": final}
        t = threading.Thread(target=self._run_rollout,
                             args=(state, plan, targets),
                             daemon=True, name="weights-rollout")
        self._rollout_thread = t
        t.start()
        return 200, {"rollout": self.rollout_status()}

    def _post_replica_json(self, host: str, port: int, path: str, doc: dict,
                           timeout_s: float = 30.0) -> Tuple[int, Dict]:
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        try:
            conn.request("POST", path, body=json.dumps(doc).encode(),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
        finally:
            conn.close()
        try:
            body = json.loads(raw or b"{}")
        except ValueError:
            body = {"raw": raw[:512].decode("utf-8", "replace")}
        return resp.status, body

    def _undrain_replica(self, rid: str):
        """Rejoin plumbing: clear the router-side drain AND reopen the
        replica's own admission gate (drain propagation's mirror image)."""
        try:
            self.pool.cancel_drain(rid)
        except KeyError:
            return
        replica = self.pool.get(rid)
        if replica is not None:
            try:
                self._post_replica_json(replica.host, replica.port,
                                        "/admin/drain", {"undo": True},
                                        timeout_s=10.0)
            except _UPSTREAM_ERRORS + (ValueError,) as e:
                logger.warning(f"router: undrain propagation to {rid} failed: {e!r}")

    def _rollout_step(self, snap: ReplicaSnapshot, plan: Dict) -> Dict:
        """Drain → swap → un-drain → health-gated rejoin for ONE replica.
        Raises :class:`_RolloutFailure` on any failure; the caller owns the
        fleet-level abort. The replica side is all-or-nothing (validated
        checkpoint, quiesced install, canary, rollback-on-failure), so a
        raise here means this replica still serves its OLD weights."""
        rid, version = snap.id, plan["version"]
        try:
            _F_ROLLOUT.fire(replica=rid)
        except InjectedFault as e:
            raise _RolloutFailure("swap_failed",
                                  f"injected rollout fault on {rid}: {e!r}",
                                  replica=rid)
        replica = self.pool.get(rid)
        if replica is None:
            raise _RolloutFailure("swap_failed",
                                  f"replica {rid} left the pool mid-rollout",
                                  replica=rid)
        # drain both tiers synchronously (we are on the rollout thread): the
        # policy stops offering the replica, direct traffic 503s, in-flight
        # streams finish — the swap then quiesces an already-quiet engine
        self.pool.start_drain(rid, deadline_s=plan["drain_deadline_s"])
        self._propagate_drain(replica.host, replica.port, plan["drain_deadline_s"])
        deadline = time.time() + plan["drain_deadline_s"] + 10.0
        while not (self.pool.drain_status(rid) or {}).get("drained"):
            if time.time() >= deadline:
                raise _RolloutFailure(
                    "drain_timeout",
                    f"{rid} still has live streams past its drain deadline",
                    replica=rid)
            time.sleep(0.05)
        body = {"ckpt_dir": plan["ckpt_dir"], "version": version,
                "timeout_s": plan["swap_timeout_s"]}
        if plan["canary_digest"] is not None:
            body["canary_digest"] = plan["canary_digest"]
        if plan["mode"] is not None:
            body["mode"] = plan["mode"]
        try:
            status, doc = self._post_replica_json(
                replica.host, replica.port, "/admin/weights", body,
                timeout_s=plan["swap_timeout_s"] + 30.0)
        except _UPSTREAM_ERRORS + (ValueError,) as e:
            raise _RolloutFailure("swap_failed",
                                  f"swap POST to {rid} failed: {e!r}",
                                  replica=rid)
        if status != 200 or not doc.get("ok"):
            raise _RolloutFailure(
                "swap_failed",
                f"{rid} refused/failed the swap (HTTP {status}): "
                f"{json.dumps(doc)[:512]}",
                replica=rid)
        self._undrain_replica(rid)
        # rejoin gate: back in rotation only once /health is good AND reports
        # the target version — a replica that silently reverted (process
        # restart onto old weights) must not count as converged
        deadline = time.time() + plan["rejoin_timeout_s"]
        while True:
            self.pool.probe_one(rid)
            replica = self.pool.get(rid)
            cur = replica.snapshot() if replica is not None else None
            if (cur is not None and cur.state in (HEALTHY, RECOVERING)
                    and cur.weights_version == version):
                break
            if time.time() >= deadline:
                raise _RolloutFailure(
                    "rejoin_timeout",
                    f"{rid} did not rejoin healthy on {version!r} "
                    f"(state={cur.state if cur else None}, "
                    f"weights_version={cur.weights_version if cur else None})",
                    replica=rid)
            time.sleep(0.05)
        return doc

    def _run_rollout(self, state: Dict, plan: Dict, targets: List[ReplicaSnapshot]):
        """The rollout thread body: replicas one at a time, abort-and-rollback
        on the first failure. ``state`` is the live status doc (shared with
        :meth:`rollout_status` under the rollout lock)."""
        version, t0 = plan["version"], time.time()
        RECORDER.record("rollout.start", version=version, replicas=len(targets))
        logger.warning(f"router: weight rollout to {version!r} starting "
                       f"({len(targets)} replica(s))")
        swapped: List[Tuple[str, Optional[str]]] = []  # (rid, pre-swap version)
        try:
            for snap in targets:
                if snap.weights_version == version:
                    self._rollout_append("skipped", snap.id)
                    continue
                self._rollout_set(current=snap.id)
                step_t0 = time.time()
                doc = self._rollout_step(snap, plan)
                swapped.append((snap.id, snap.weights_version))
                if plan["canary_digest"] is None:
                    # the first swapped replica becomes the canary reference:
                    # every later replica must reproduce its probe output
                    # bit-for-bit or roll back
                    plan["canary_digest"] = doc.get("canary_digest")
                self._rollout_append("completed", snap.id)
                RECORDER.record("rollout.replica", replica=snap.id,
                                wall_s=round(time.time() - step_t0, 3))
        except _RolloutFailure as e:
            self._abort_rollout(state, plan, e, swapped)
            return
        wall_s = round(time.time() - t0, 3)
        self._rollout_set(status="done", current=None, wall_s=wall_s)
        RECORDER.record("rollout.done", version=version, wall_s=wall_s)
        logger.warning(f"router: weight rollout to {version!r} done in {wall_s}s")

    def _abort_rollout(self, state: Dict, plan: Dict, failure: "_RolloutFailure",
                       swapped: List[Tuple[str, Optional[str]]]):
        """First failure aborts the WHOLE rollout: the failed replica is
        un-drained (the replica-side swap is all-or-nothing, so it still
        serves its old weights), and every already-swapped replica is rolled
        back via ``rollback_ckpt_dir`` — a replica releases its retained old
        params the moment its canary passes, so fleet-level rollback must
        reload the old bytes from disk. Without a ``rollback_ckpt_dir`` the
        swapped replicas stay on the new version (reported as
        ``rollback_skipped``) — a mixed fleet the operator must resolve."""
        version, reason, failed = plan["version"], failure.reason, failure.replica
        logger.warning(
            f"router: rollout to {version!r} aborted at {failed} ({reason}): "
            f"{failure} — rolling back {len(swapped)} swapped replica(s)")
        RECORDER.record("rollout.abort", reason=reason, replica=failed,
                        version=version)
        if failed is not None:
            self._undrain_replica(failed)
        rolled_back: List[str] = []
        rollback_failed: List[str] = []
        if swapped and plan.get("rollback_ckpt_dir"):
            # newest swap first: converge the fleet back from the rollout's
            # leading edge (no drain needed — the replica-side swap quiesces)
            for rid, prev_version in reversed(swapped):
                replica = self.pool.get(rid)
                body = {"ckpt_dir": plan["rollback_ckpt_dir"]}
                if prev_version is not None:
                    body["version"] = prev_version
                status, doc = None, {}
                if replica is not None:
                    try:
                        status, doc = self._post_replica_json(
                            replica.host, replica.port, "/admin/weights", body,
                            timeout_s=plan["swap_timeout_s"] + 30.0)
                    except _UPSTREAM_ERRORS + (ValueError,) as e:
                        doc = {"error": repr(e)}
                if status == 200 and doc.get("ok"):
                    rolled_back.append(rid)
                else:
                    logger.warning(f"router: rollback of {rid} failed: "
                                   f"{json.dumps(doc)[:256]}")
                    rollback_failed.append(rid)
            if rollback_failed:
                RECORDER.record("rollout.abort", reason="rollback_failed",
                                version=version, replicas=len(rollback_failed))
        elif swapped:
            self._rollout_set(rollback_skipped=True)
            logger.warning(
                "router: no rollback_ckpt_dir — already-swapped replicas "
                f"{[r for r, _ in swapped]} stay on {version!r}")
        self._rollout_set(status="aborted", current=None, abort_reason=reason,
                          error=str(failure), rolled_back=rolled_back,
                          rollback_failed=rollback_failed)
        self.postmortem.dump("rollout_abort", detail={
            "version": version, "reason": reason, "failed_replica": failed,
            "error": str(failure), "rolled_back": rolled_back,
            "rollback_failed": rollback_failed,
            "completed": list(state.get("completed", []))})

    @staticmethod
    def _fold_stage_series(parsed: Dict[str, Dict]) -> Dict:
        """Fleet fold of the per-stage gauges disaggregated replicas expose
        (`paddlenlp_serving_stage_kv_utilization` / `_stage_queue_depth`):
        worst + mean per stage across replicas. Empty for uniform fleets."""
        folds = {"kv_utilization": "paddlenlp_serving_stage_kv_utilization",
                 "queue_depth": "paddlenlp_serving_stage_queue_depth"}
        out: Dict[str, Dict] = {}
        for key, fam_name in folds.items():
            per_stage: Dict[str, list] = {}
            for fams in parsed.values():
                fam = fams.get(fam_name)
                if fam is None:
                    continue
                for (_sample, labels), v in fam.samples.items():
                    stage = dict(labels).get("stage")
                    if stage:
                        per_stage.setdefault(stage, []).append(v)
            for stage, vals in per_stage.items():
                doc = out.setdefault(stage, {})
                doc[f"{key}_max"] = max(vals)
                doc[f"{key}_mean"] = sum(vals) / len(vals)
        return {k: out[k] for k in sorted(out)}

    # ------------------------------------------------------------- postmortem
    def _postmortem_health(self) -> Dict:
        """Router-tier bundle health: pool snapshots + drain status + the
        router's own open forwards — the placement facts behind the decision
        events in the trail."""
        return {
            "policy": getattr(self.policy, "name", type(self.policy).__name__),
            "replicas": self.admin_list_replicas()["replicas"],
            "hedges_inflight": self._hedges_inflight,  # lock-ok: point-in-time snapshot for a diagnostic dump
        }

    def _postmortem_config(self) -> Dict:
        return {
            "max_attempts": self.max_attempts,
            "hedge_after_s": self.hedge_after_s,
            "max_hedges_inflight": self.max_hedges_inflight,
            "trace_sample_every": self.trace_sample_every,
            "upstream_timeout_s": self.upstream_timeout_s,
            "slo_objectives": dataclasses.asdict(self.slo.objectives),
        }

    def _on_fast_burn(self, kind: str, burn_rate: float, window: str):
        """SLO fast-burn trigger (wired into the tracker at construction): a
        shortest-window burn past the page-now threshold snapshots the fleet
        state that produced it — and pushes a brownout floor to the replicas,
        so the fleet starts degrading selectively (shed best-effort first)
        instead of timing out uniformly while the autoscaler catches up. The
        dumper rate-limits, so a sustained burn costs one bundle per window,
        not one per /fleet/slo scrape."""
        self.postmortem.dump("slo_fast_burn", detail={
            "kind": kind, "burn_rate": burn_rate, "window": window})
        if self.brownout_push_level:
            self.push_brownout(self.brownout_push_level, reason="slo_fast_burn")

    def push_brownout(self, level: int, reason: str = "slo_fast_burn",
                      min_interval_s: float = 10.0) -> bool:
        """Push a brownout floor to every live replica (best-effort,
        off-thread — the same propagation channel drains use). Returns False
        when suppressed by the rate limit."""
        now = time.time()
        with self._brownout_push_lock:
            if now - self._last_brownout_push_t < min_interval_s:
                return False
            self._last_brownout_push_t = now
        targets = [(s.host, s.port) for s in self.pool.snapshots()
                   if s.state != DOWN and not s.draining]
        logger.warning(
            f"router: pushing brownout level {level} ({reason}) to "
            f"{len(targets)} replica(s)")
        for host, port in targets:
            # pool.push_brownout is the shared /admin/brownout client (the
            # autoscaler's max-envelope handoff uses the same one)
            threading.Thread(
                target=pool_push_brownout, args=(host, port, level),
                kwargs={"reason": reason}, daemon=True,
                name=f"brownout-push-{host}:{port}").start()
        return True

    # ------------------------------------------------------------- trace stitch
    def stitched_trace(self, trace_id: str) -> Dict:
        """One request's two-tier timeline: the router's spans plus the owning
        replica's, clock-skew-corrected onto the router's timeline and merged
        into a single multi-process Chrome trace. Falls back to the
        router-only view when the owner is unknown/unreachable (the stitch
        degrades, it never 500s)."""
        router_events = self.tracer.chrome_trace(
            self.tracer.snapshot(trace=trace_id))["traceEvents"]
        tiers = [{"name": "router", "events": router_events,
                  "offset_s": 0.0, "dropped": self.tracer.dropped}]
        with self._live_lock:
            owner_id = self._trace_owner.get(trace_id)
        owner = self.pool.get(owner_id) if owner_id is not None else None
        stitch_error = None
        if owner is not None:
            try:
                raw = self._scrape_replica(
                    owner.snapshot(), f"/debug/trace?trace={quote(trace_id)}")
                doc = json.loads(raw)
                tiers.append({
                    "name": owner_id,
                    "events": doc.get("traceEvents", []),
                    "offset_s": self.pool.clock_offset(owner_id),
                    "dropped": doc.get("otherData", {}).get("dropped_spans", 0),
                })
            except Exception as e:
                logger.warning(f"router: trace fetch from {owner_id} failed: {e!r}")
                stitch_error = repr(e)
        merged = merge_chrome_traces(tiers)
        merged["otherData"]["trace"] = trace_id
        merged["otherData"]["replica"] = owner_id
        if stitch_error is not None:
            merged["otherData"]["stitch_error"] = stitch_error
        return merged

    # ------------------------------------------------------------- forwarding
    def _handle_completion(self, handler, payload: dict, chat: bool = False):
        rid = f"rtr-{next(self._ids)}"
        # the head-based sampling decision: made once here, pinned on the
        # router's tracer, and propagated to the replica in the traceparent
        # header — every tier then agrees without re-deciding
        sampled = trace_sampled(rid, self.trace_sample_every)
        if self.trace_sample_every > 1:
            self.tracer.mark_trace(rid, sampled)
        state = _RelayState(rid, bool(payload.get("stream")), sampled=sampled,
                            upstream_path="/v1/chat/completions" if chat
                            else "/v1/completions")
        prompt = payload.get("prompt")
        if chat and prompt is None:
            # chat has no top-level prompt; the first message's content is the
            # shared conversation head — exactly the span prefix affinity
            # should co-locate when no conversation key pins harder
            msgs = payload.get("messages")
            if isinstance(msgs, list) and msgs and isinstance(msgs[0], dict):
                prompt = msgs[0].get("content")
        adapter_id = payload.get("adapter_id")
        adapter_id = str(adapter_id) if adapter_id is not None else None
        conversation = payload.get("conversation")
        conversation = str(conversation) if conversation is not None else None
        body = json.dumps(payload).encode()
        exclude: set = set()

        with use_trace(rid):
            self._relay_attempts(handler, state, payload, prompt, body, exclude,
                                 adapter_id=adapter_id, conversation=conversation)

    def _relay_attempts(self, handler, state: _RelayState, payload: dict,
                        prompt, body: bytes, exclude: set,
                        adapter_id: Optional[str] = None,
                        conversation: Optional[str] = None):
        while state.attempts < self.max_attempts:
            candidates = self._candidates(prompt, exclude, state, adapter_id,
                                          conversation)
            if not candidates:
                break
            cand = candidates[0]
            state.attempts += 1
            # hedging applies to token-less attempts (streams that relayed
            # nothing yet; batch requests always, nothing reaches the client
            # before the whole body) with somewhere to hedge TO. A browned-out
            # fleet (level >= 2 on either leg) suppresses the race: a hedge is
            # deliberate extra load, exactly what the brownout ladder is
            # shedding. Counted once per REQUEST at candidate selection
            # (whether or not the race would have fired) — unlike "capped",
            # which counts at hedge-fire time
            hedge_cand = candidates[1] if (
                self.hedge_after_s is not None
                and state.tokens_relayed == 0 and len(candidates) > 1) else None
            if hedge_cand is not None and max(cand.brownout_level,
                                              hedge_cand.brownout_level) >= 2:
                hedge_cand = None
                if state.attempts == 1:
                    self.metrics.hedges.inc(outcome="brownout")
            state.replica_id = cand.id
            state.weights_version = cand.weights_version
            # a fresh attempt must not inherit the previous replica's
            # completion id: replicas mint cmpl-N independently, and a stale
            # cid paired with the NEW replica would abort a stranger's request
            state.upstream_cid = None
            with self._live_lock:
                self._active.add(state)
            try:
                if hedge_cand is not None:
                    # the hedged attempt owns both legs' inflight accounting
                    # and may re-attribute the attempt to the hedge replica
                    hedged = (self._attempt_stream_hedged if state.stream
                              else self._attempt_batch_hedged)
                    outcome, cand = hedged(
                        handler, state, cand, hedge_cand, body, exclude)
                else:
                    self._inflight_delta(cand.id, +1)
                    try:
                        if state.stream:
                            outcome = self._attempt_stream(handler, state, cand, body)
                        else:
                            outcome = self._attempt_batch(handler, state, cand, body)
                    finally:
                        self._inflight_delta(cand.id, -1)
            finally:
                with self._live_lock:
                    self._active.discard(state)
            if outcome == "done":
                return
            if outcome == "reroute":
                # nothing relayed; 429/503/connect failure — next candidate
                exclude.add(cand.id)
                self.metrics.rerouted.inc()
                RECORDER.record("router.reroute", trace=state.rid,
                                replica=cand.id, attempt=state.attempts)
                self.tracer.instant("reroute", cat="router", trace=state.rid,
                                    replica=cand.id)
                continue
            if outcome == "failover":
                # accepted then failed pre-token: transparent resubmission. A
                # drain-evicted stream takes this same path, but its replica
                # is leaving on purpose — demoting it would lie to the pool
                exclude.add(cand.id)
                if not self.pool.is_draining(cand.id):
                    self.pool.note_forward_failure(cand.id)
                self.metrics.failovers.inc()
                RECORDER.record("router.failover", trace=state.rid,
                                replica=cand.id, attempt=state.attempts)
                self.tracer.add_span("failover", self.tracer.epoch_time(state.arrival_t),
                                     time.perf_counter() - state.arrival_t, cat="router",
                                     trace=state.rid, replica=cand.id,
                                     attempt=state.attempts)
                continue
            if outcome == "midstream_failed":
                self._terminate_midstream(handler, state, cand, payload)
                return
            if outcome == "client_gone":
                self._finish(state, cand.id, "client_gone")
                return

        # candidates/attempts exhausted
        self._reject_exhausted(handler, state, payload)

    def _reject_exhausted(self, handler, state: _RelayState, payload: dict):
        retry_after = max(1, int(round(self.pool.retry_after_hint())))
        if state.headers_sent:
            # SSE already open: a status line now would corrupt the stream —
            # same in-band contract as a mid-stream replica failure
            self._terminate_midstream(handler, state, None, payload)
            return
        self._finish(state, "none", "rejected")
        try:
            handler._send_error_json(
                503, "no replica available for this request; retry shortly",
                "no_replica_available", headers={"Retry-After": retry_after})
        except (BrokenPipeError, ConnectionResetError):
            pass

    def _forward_headers(self, state: _RelayState) -> Dict[str, str]:
        """Per-forward headers: the traceparent contract. The parent span id
        names the router's request span (``<rid>@router``) so the replica's
        stitched spans can point back at the tier that placed them."""
        return {
            "Content-Type": "application/json",
            TRACEPARENT_HEADER: format_traceparent(
                state.rid, f"{state.rid}@router", state.sampled),
        }

    # ------------------------------------------------------------- failure plane
    def _apply_failure(self, handler, state: _RelayState, cand: ReplicaSnapshot,
                       failure: Tuple) -> str:
        """Apply one classified upstream failure in *attempt* context and
        return the outcome for the caller's switch. Demotion on "failover"
        is deliberately left to that switch (it owns exclusion + the
        failover span); only re-route-class replica faults demote here."""
        kind, payload = failure
        d = _classify_upstream_failure(kind, payload)
        if kind == "connect_failed":
            logger.warning(f"router: forward to {cand.id} failed: {payload!r}")
        elif d.status is not None and d.outcome == "failover":
            logger.warning(f"router: {cand.id} answered {d.status}")
        if d.is_degraded:
            self.pool.note_degraded(cand.id, retry_after_s=d.retry_after_s())
        if d.outcome == "reroute":
            # a drain-deadline eviction lands here too — a deliberately
            # leaving replica must not be demoted as if it had failed
            if d.replica_fault and not self.pool.is_draining(cand.id):
                self.pool.note_forward_failure(cand.id)
            return "reroute"
        if d.outcome == "failover":
            return "failover"
        # relay: the replica judged the request itself bad (400/413) — relay
        # verbatim, another replica would say the same … unless SSE headers
        # already went out, in which case a status line would corrupt the
        # stream and the only move left is trying elsewhere
        if state.headers_sent:
            return "failover"
        self._finish(state, cand.id, "error")
        self._relay_raw(handler, d.status, d.raw)
        return "done"

    # ------------------------------------------------------------- batch leg
    def _attempt_batch(self, handler, state: _RelayState, cand: ReplicaSnapshot,
                       body: bytes) -> str:
        conn = http.client.HTTPConnection(cand.host, cand.port,
                                          timeout=self.upstream_timeout_s)
        # registered for drain eviction like the stream leg: nothing has been
        # relayed until the whole body arrives, so a forced close simply
        # re-routes the request to a survivor
        state.upstream_conn = conn
        try:
            try:
                _F_FORWARD.fire(replica=cand.id)
                conn.request("POST", state.upstream_path, body=body,
                             headers=self._forward_headers(state))
                resp = conn.getresponse()
                state.upstream_resp = resp
                raw = resp.read()
            except _UPSTREAM_ERRORS as e:
                return self._apply_failure(handler, state, cand, ("connect_failed", e))
            if resp.status != 200:
                return self._apply_failure(handler, state, cand, (
                    "status", (resp.status, raw, resp.getheader("Retry-After"))))
            try:
                doc = json.loads(raw)
                finish = (doc.get("choices") or [{}])[0].get("finish_reason")
            except (ValueError, AttributeError, IndexError):
                doc, finish = None, None
            if doc is None or finish == "engine_error":
                # the replica accepted then failed it (or returned junk);
                # nothing reached the client — resubmit elsewhere
                return self._apply_failure(handler, state, cand, ("engine_error", None))
            doc["id"] = state.rid
            doc["replica"] = cand.id
            self._finish(state, cand.id, "ok")
            self._relay_raw(handler, 200, json.dumps(doc).encode())
            return "done"
        finally:
            state.upstream_conn = None
            state.upstream_resp = None
            try:
                conn.close()
            except Exception:
                pass  # may race the drain enforcer's forced close

    def _relay_raw(self, handler, status: int, raw: bytes):
        try:
            handler._send_raw(status, raw, "application/json")
        except (BrokenPipeError, ConnectionResetError):
            logger.debug("router: client disconnected before response relay")

    # ------------------------------------------------------------- stream leg
    def _attempt_stream(self, handler, state: _RelayState, cand: ReplicaSnapshot,
                        body: bytes) -> str:
        conn = http.client.HTTPConnection(cand.host, cand.port,
                                          timeout=self.upstream_timeout_s)
        # published for the drain enforcer: a past-deadline drain closes this
        # connection to break the relay read into a pre-token failover
        state.upstream_conn = conn
        try:
            try:
                _F_FORWARD.fire(replica=cand.id)
                conn.request("POST", state.upstream_path, body=body,
                             headers=self._forward_headers(state))
                resp = conn.getresponse()
                state.upstream_resp = resp
            except _UPSTREAM_ERRORS as e:
                return self._apply_failure(handler, state, cand, ("connect_failed", e))
            if resp.status != 200:
                raw = resp.read()
                return self._apply_failure(handler, state, cand, (
                    "status", (resp.status, raw, resp.getheader("Retry-After"))))
            return self._relay_sse(handler, state, cand, _read_sse_events(resp))
        finally:
            state.upstream_conn = None
            state.upstream_resp = None
            try:
                conn.close()
            except Exception:
                # closing a connection the drain enforcer already tore down
                # can trip http.client's own (unsynchronized) close path
                pass

    def _relay_sse(self, handler, state: _RelayState, cand: ReplicaSnapshot,
                   events) -> str:
        """Relay one upstream SSE leg, already parsed into
        ``("event"|"done"|"broke", payload)`` items (:func:`_read_sse_events`
        for a plain leg, the committed-leg queue for a hedged one). Returns
        done / failover / midstream_failed / client_gone."""
        if not state.headers_sent:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            handler.end_headers()
            state.headers_sent = True

        def close_out() -> str:
            # terminal bookkeeping BEFORE the final client write: the moment
            # the client sees [DONE], every router-side counter/span must
            # already reflect this request — a client asserting on /metrics
            # right after its stream closes must never observe the old value.
            # A client that vanishes on this very last write already received
            # the entire stream, so "ok"/"error" (not client_gone) stands.
            self._finish(state, cand.id, "ok" if state.finished else "error")
            try:
                handler.wfile.write(b"data: [DONE]\n\n")
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass
            return "done"

        for kind, payload in events:
            if kind == "done":
                # the terminal chunk was already relayed on a previous item
                return close_out()
            if kind == "broke" or payload.get("object") == "error":
                # transport drop / close without [DONE] / upstream's in-band
                # internal error — all the same disposition
                if kind == "broke" and payload is not None:
                    logger.warning(f"router: stream from {cand.id} broke: {payload!r}")
                if state.finished:
                    # the client already has its terminal chunk; only [DONE]
                    # was lost — close out the stream ourselves
                    return close_out()
                return "failover" if state.tokens_relayed == 0 else "midstream_failed"
            ev = payload
            upstream_cid = ev.get("id")
            if upstream_cid:
                state.upstream_cid = str(upstream_cid)
                self._track(state, cand.id, str(upstream_cid))
            choice = (ev.get("choices") or [{}])[0]
            finish = choice.get("finish_reason")
            if finish == "engine_error":
                # the replica's supervisor gave up on this request: pre-token
                # it is ours to retry elsewhere, mid-stream it becomes the
                # router-level replica_error terminal
                return "failover" if state.tokens_relayed == 0 else "midstream_failed"
            ev["id"] = state.rid
            if finish:
                ev["replica"] = cand.id
            try:
                handler.wfile.write(f"data: {json.dumps(ev)}\n\n".encode())
                handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                logger.debug(f"router: client left stream {state.rid}; aborting upstream")
                self._abort_upstream(state, cand)
                return "client_gone"
            if finish:
                state.finished = True
            elif "token" in choice:
                state.tokens_relayed += 1
        # iterator exhausted without a terminal item (defensive)
        return "failover" if state.tokens_relayed == 0 else "midstream_failed"

    # ------------------------------------------------------------- hedged leg
    def _attempt_stream_hedged(self, handler, state: _RelayState,
                               cand: ReplicaSnapshot, hedge_cand: ReplicaSnapshot,
                               body: bytes, exclude: set):
        """One hedged stream attempt. The primary forward starts immediately;
        when no leg has produced a first event within ``hedge_after_s`` a
        shadow forward races it on ``hedge_cand`` (bounded by the
        in-flight-hedge cap). Each leg's reader thread parses its SSE stream
        into a shared queue; the first leg to produce a *usable* event (a
        token or a clean terminal — not an engine_error) is **committed** and
        relays through the ordinary SSE path, and the loser is torn down
        (socket closed + ``/v1/abort`` when its upstream id is known). Nothing
        reaches the client before commit, so a losing leg is invisible.

        Returns ``(outcome, replica)`` — ``replica`` is the leg the outcome
        belongs to, so the caller's exclusion/health bookkeeping follows the
        replica that actually failed or served.

        NOTE: :meth:`_attempt_batch_hedged` is this method's batch twin —
        same race scaffolding over whole responses instead of SSE events; the
        two are kept in deliberate lockstep, change both or neither."""
        # bounded: the committed leg's reader is paced by how fast the client
        # drains (TCP backpressure all the way to the replica) instead of
        # buffering a whole generation in router memory for a slow client
        q: "queue.Queue" = queue.Queue(maxsize=64)
        legs = {0: cand, 1: hedge_cand}
        conns: Dict[int, object] = {}
        resps: Dict[int, object] = {}
        cids: Dict[int, Optional[str]] = {0: None, 1: None}
        abandoned: Dict[int, bool] = {}

        def put_item(leg: int, kind: str, payload) -> bool:
            """Bounded put with liveness: blocks while the queue is full
            (backpressure) but re-checks abandonment each second so a
            torn-down loser's reader exits instead of wedging on a queue
            nobody will drain."""
            while not abandoned.get(leg):
                try:
                    q.put((leg, kind, payload), timeout=1.0)
                    return True
                except queue.Full:
                    continue
            return False

        def reader(leg: int, snap: ReplicaSnapshot):
            conn = http.client.HTTPConnection(snap.host, snap.port,
                                              timeout=self.upstream_timeout_s)
            conns[leg] = conn
            if leg == 0:
                # published pre-commit so a drain-deadline eviction of the
                # (token-less, primary-pinned) stream can break this leg too;
                # the commit re-points these at the winning leg
                state.upstream_conn = conn
            try:
                try:
                    _F_FORWARD.fire(replica=snap.id)
                    conn.request("POST", state.upstream_path, body=body,
                                 headers=self._forward_headers(state))
                    resp = conn.getresponse()
                    resps[leg] = resp
                    if leg == 0:
                        state.upstream_resp = resp
                except _UPSTREAM_ERRORS as e:
                    put_item(leg, "connect_failed", e)
                    return
                if resp.status != 200:
                    try:
                        raw = resp.read()
                    except _UPSTREAM_ERRORS:
                        raw = b""
                    put_item(leg, "status",
                             (resp.status, raw, resp.getheader("Retry-After")))
                    return
                for kind, payload in _read_sse_events(resp):
                    if not put_item(leg, kind, payload):
                        return  # loser: closing the conn frees the replica
                    if kind != "event":
                        return
            finally:
                conn.close()

        self._inflight_delta(cand.id, +1)
        hedge_started = False
        hedge_capped = False
        hedge_fired_t = 0.0  # perf_counter at shadow launch (hedge_race phase)
        committed: Optional[int] = None
        first_item = None  # the committing ("event", ev) item
        failures: Dict[int, Tuple[str, object]] = {}
        threading.Thread(target=reader, args=(0, cand), daemon=True,
                         name=f"hedge-primary-{state.rid}").start()
        hedge_deadline = time.perf_counter() + float(self.hedge_after_s)
        try:
            while committed is None:
                deciding = not hedge_started and not hedge_capped
                timeout = (max(hedge_deadline - time.perf_counter(), 0.001)
                           if deciding else self.upstream_timeout_s)
                try:
                    leg, kind, payload = q.get(timeout=timeout)
                except queue.Empty:
                    if deciding and time.perf_counter() >= hedge_deadline:
                        # latency budget blown with no first event: hedge
                        if self._try_start_hedge():
                            hedge_started = True
                            hedge_fired_t = time.perf_counter()
                            RECORDER.record("router.hedge_fire", trace=state.rid,
                                            replica=hedge_cand.id)
                            self.tracer.instant("hedge", cat="router",
                                                trace=state.rid, outcome="fired",
                                                replica=hedge_cand.id)
                            self._inflight_delta(hedge_cand.id, +1)
                            threading.Thread(
                                target=reader, args=(1, hedge_cand), daemon=True,
                                name=f"hedge-shadow-{state.rid}").start()
                        else:
                            hedge_capped = True
                            self.metrics.hedges.inc(outcome="capped")
                            self.tracer.instant("hedge", cat="router",
                                                trace=state.rid, outcome="capped")
                        continue
                    if deciding:
                        continue  # spurious early wake
                    # silence past the upstream timeout: every racing leg is
                    # wedged — treat them as broken AND tear them down like
                    # hedge losers, or their readers would stay blocked for
                    # another full upstream timeout while both replicas keep
                    # generating the orphaned request
                    for wedged in (0, 1) if hedge_started else (0,):
                        failures.setdefault(wedged, ("broke", None))
                        abandoned[wedged] = True
                        _force_close(conns.get(wedged), resps.get(wedged))
                    break
                if kind == "event":
                    ev = payload
                    if ev.get("id"):
                        cids[leg] = str(ev["id"])
                    choice = (ev.get("choices") or [{}])[0]
                    if ev.get("object") == "error" \
                            or choice.get("finish_reason") == "engine_error":
                        failures[leg] = ("engine_error", None)
                    else:
                        committed = leg
                        first_item = ("event", ev)
                        break
                else:
                    failures[leg] = (kind, payload)
                if 0 in failures and not hedge_started:
                    # primary failed inside the hedge budget: nothing to race —
                    # the ordinary candidate walk owns the resubmission
                    return (self._apply_failure(handler, state, cand,
                                                failures[0]), cand)
                if 0 in failures and 1 in failures:
                    break
                # one leg died but the other is still racing: keep waiting

            if committed is None:
                # every started leg is dead; attribute the attempt to the
                # primary, book the shadow's failure separately
                if hedge_started:
                    self.metrics.hedges.inc(outcome="failed")
                    self.tracer.instant("hedge", cat="router", trace=state.rid,
                                        outcome="failed")
                    if 1 in failures:
                        self._note_dead_leg(hedge_cand, failures[1], exclude)
                return (self._apply_failure(
                    handler, state, cand, failures.get(0, ("broke", None))), cand)

            committed_cand = legs[committed]
            loser = 1 - committed
            if loser == 0 or hedge_started:  # the loser leg actually ran
                if loser in failures:
                    self._note_dead_leg(legs[loser], failures[loser], exclude)
                else:
                    # still racing: tear it down — the closed socket stops its
                    # reader, the explicit abort frees replica-side slot/KV
                    # (a leg with no event yet has no id to abort by; the
                    # replica notices the disconnect on its first write)
                    abandoned[loser] = True
                    RECORDER.record("router.hedge_abort", trace=state.rid,
                                    replica=legs[loser].id)
                    _force_close(conns.get(loser), resps.get(loser))
                    if cids[loser] is not None:
                        self._abort_replica_request(
                            legs[loser].host, legs[loser].port, cids[loser])
            if hedge_started:
                label = "hedge_won" if committed == 1 else "primary_won"
                self.metrics.hedges.inc(outcome=label)
                RECORDER.record("router.hedge_commit", trace=state.rid,
                                replica=committed_cand.id, outcome=label)
                # the hedge-race phase: time between firing the shadow and the
                # first usable event — the latency the race bought (or not)
                self.metrics.latency_attribution.observe(
                    time.perf_counter() - hedge_fired_t, phase="hedge_race")
                self.tracer.instant("hedge", cat="router", trace=state.rid,
                                    outcome=label, replica=committed_cand.id)
            state.replica_id = committed_cand.id
            state.upstream_conn = conns.get(committed)
            state.upstream_resp = resps.get(committed)

            def committed_events():
                yield first_item
                while True:
                    try:
                        lg, kind, payload = q.get(timeout=self.upstream_timeout_s)
                    except queue.Empty:
                        yield ("broke", None)
                        return
                    if lg != committed:
                        continue
                    yield (kind, payload)
                    if kind != "event":
                        return

            return (self._relay_sse(handler, state, committed_cand,
                                    committed_events()), committed_cand)
        finally:
            # whatever happened, no reader may stay blocked on the queue once
            # nobody drains it (put_item re-checks this within a second)
            abandoned[0] = abandoned[1] = True
            state.upstream_conn = None
            state.upstream_resp = None
            self._inflight_delta(cand.id, -1)
            if hedge_started:
                self._inflight_delta(hedge_cand.id, -1)
                self._release_hedge()

    def _attempt_batch_hedged(self, handler, state: _RelayState,
                              cand: ReplicaSnapshot, hedge_cand: ReplicaSnapshot,
                              body: bytes, exclude: set):
        """One hedged *batch* attempt — the same loser-abort race as the
        stream path, over whole responses instead of SSE events. The primary
        forward starts immediately; if no leg has produced its response
        within ``hedge_after_s`` a shadow races it on ``hedge_cand`` (bounded
        by the same in-flight cap, counted in the same
        ``hedges_total{outcome}``). The first leg to return a *usable* 200
        (parseable, not an in-band ``engine_error``) is committed and relayed
        under the router's id; the loser's socket is force-closed — a batch
        loser has no upstream id to abort by until its body arrives, which is
        exactly what we are not waiting for, so the replica frees the request
        when its final write hits the dead connection.

        Returns ``(outcome, replica)`` like the stream twin
        (:meth:`_attempt_stream_hedged`) — the race scaffolding is kept in
        deliberate lockstep with it; change both or neither."""
        q: "queue.Queue" = queue.Queue()  # ≤1 item per leg: no bound needed
        legs = {0: cand, 1: hedge_cand}
        conns: Dict[int, object] = {}
        resps: Dict[int, object] = {}

        def reader(leg: int, snap: ReplicaSnapshot):
            conn = http.client.HTTPConnection(snap.host, snap.port,
                                              timeout=self.upstream_timeout_s)
            conns[leg] = conn
            if leg == 0:
                # published pre-commit for drain-deadline eviction, exactly
                # like the stream primary
                state.upstream_conn = conn
            try:
                try:
                    _F_FORWARD.fire(replica=snap.id)
                    conn.request("POST", state.upstream_path, body=body,
                                 headers=self._forward_headers(state))
                    resp = conn.getresponse()
                    resps[leg] = resp
                    if leg == 0:
                        state.upstream_resp = resp
                    raw = resp.read()
                except _UPSTREAM_ERRORS as e:
                    q.put((leg, "connect_failed", e))
                    return
                q.put((leg, "response",
                       (resp.status, raw, resp.getheader("Retry-After"))))
            finally:
                conn.close()

        self._inflight_delta(cand.id, +1)
        hedge_started = False
        hedge_capped = False
        hedge_fired_t = 0.0  # perf_counter at shadow launch (hedge_race phase)
        committed = None  # (leg, parsed response doc)
        failures: Dict[int, Tuple[str, object]] = {}
        threading.Thread(target=reader, args=(0, cand), daemon=True,
                         name=f"hedge-batch-primary-{state.rid}").start()
        hedge_deadline = time.perf_counter() + float(self.hedge_after_s)
        try:
            while committed is None:
                deciding = not hedge_started and not hedge_capped
                timeout = (max(hedge_deadline - time.perf_counter(), 0.001)
                           if deciding else self.upstream_timeout_s)
                try:
                    leg, kind, payload = q.get(timeout=timeout)
                except queue.Empty:
                    if deciding and time.perf_counter() >= hedge_deadline:
                        if self._try_start_hedge():
                            hedge_started = True
                            hedge_fired_t = time.perf_counter()
                            RECORDER.record("router.hedge_fire", trace=state.rid,
                                            replica=hedge_cand.id)
                            self.tracer.instant("hedge", cat="router",
                                                trace=state.rid, outcome="fired",
                                                replica=hedge_cand.id)
                            self._inflight_delta(hedge_cand.id, +1)
                            threading.Thread(
                                target=reader, args=(1, hedge_cand), daemon=True,
                                name=f"hedge-batch-shadow-{state.rid}").start()
                        else:
                            hedge_capped = True
                            self.metrics.hedges.inc(outcome="capped")
                            self.tracer.instant("hedge", cat="router",
                                                trace=state.rid, outcome="capped")
                        continue
                    if deciding:
                        continue  # spurious early wake
                    # silence past the upstream timeout: every racing leg is
                    # wedged — tear them down so the replicas notice
                    for wedged in (0, 1) if hedge_started else (0,):
                        failures.setdefault(wedged, ("broke", None))
                        _force_close(conns.get(wedged), resps.get(wedged))
                    break
                if kind == "response":
                    status, raw, retry_after = payload
                    if status == 200:
                        try:
                            doc = json.loads(raw)
                            finish = (doc.get("choices") or [{}])[0].get("finish_reason")
                        except (ValueError, AttributeError, IndexError):
                            doc, finish = None, None
                        if doc is not None and finish != "engine_error":
                            committed = (leg, doc)
                            break
                        failures[leg] = ("engine_error", None)
                    else:
                        failures[leg] = ("status", (status, raw, retry_after))
                else:
                    failures[leg] = (kind, payload)
                if 0 in failures and not hedge_started:
                    # primary failed inside the hedge budget: nothing to race
                    return (self._apply_failure(handler, state, cand,
                                                failures[0]), cand)
                if 0 in failures and 1 in failures:
                    break

            if committed is None:
                if hedge_started:
                    self.metrics.hedges.inc(outcome="failed")
                    self.tracer.instant("hedge", cat="router", trace=state.rid,
                                        outcome="failed")
                    if 1 in failures:
                        self._note_dead_leg(hedge_cand, failures[1], exclude)
                return (self._apply_failure(
                    handler, state, cand, failures.get(0, ("broke", None))), cand)

            win_leg, doc = committed
            committed_cand = legs[win_leg]
            loser = 1 - win_leg
            if loser == 0 or hedge_started:  # the loser leg actually ran
                if loser in failures:
                    self._note_dead_leg(legs[loser], failures[loser], exclude)
                else:
                    # still generating: closing its socket is the abort — the
                    # replica frees slot + KV when its response write fails
                    RECORDER.record("router.hedge_abort", trace=state.rid,
                                    replica=legs[loser].id)
                    _force_close(conns.get(loser), resps.get(loser))
            if hedge_started:
                label = "hedge_won" if win_leg == 1 else "primary_won"
                self.metrics.hedges.inc(outcome=label)
                RECORDER.record("router.hedge_commit", trace=state.rid,
                                replica=committed_cand.id, outcome=label)
                self.metrics.latency_attribution.observe(
                    time.perf_counter() - hedge_fired_t, phase="hedge_race")
                self.tracer.instant("hedge", cat="router", trace=state.rid,
                                    outcome=label, replica=committed_cand.id)
            state.replica_id = committed_cand.id
            doc["id"] = state.rid
            doc["replica"] = committed_cand.id
            self._finish(state, committed_cand.id, "ok")
            self._relay_raw(handler, 200, json.dumps(doc).encode())
            return ("done", committed_cand)
        finally:
            state.upstream_conn = None
            state.upstream_resp = None
            self._inflight_delta(cand.id, -1)
            if hedge_started:
                self._inflight_delta(hedge_cand.id, -1)
                self._release_hedge()

    def _note_dead_leg(self, cand: ReplicaSnapshot, failure: Tuple, exclude: set):
        """Health/metrics bookkeeping for a hedged leg that died while the
        OTHER leg carried the request: same classification as every attempt
        (:func:`_classify_upstream_failure`), dead-leg application — the
        outcome switch never sees this leg, so exclusion, the re-route/
        failover counters and the replica-fault demotion apply here."""
        kind, payload = failure
        d = _classify_upstream_failure(kind, payload)
        exclude.add(cand.id)
        if d.is_degraded:
            self.pool.note_degraded(cand.id, retry_after_s=d.retry_after_s())
        if d.replica_fault and not self.pool.is_draining(cand.id):
            self.pool.note_forward_failure(cand.id)
        if d.outcome == "reroute":
            self.metrics.rerouted.inc()
        else:
            self.metrics.failovers.inc()

    def _abort_upstream(self, state: _RelayState, cand: ReplicaSnapshot):
        with self._live_lock:
            owner = self._live.get(state.rid)
        if owner is not None and owner[0] == cand.id:
            self.abort(state.rid)

    def _midstream_disposition(self, state: _RelayState,
                               cand: Optional[ReplicaSnapshot]) -> str:
        """The router-level disposition for a stream that died AFTER tokens
        were relayed. Continuing it elsewhere would re-emit divergent tokens,
        so it always terminates in-band — the split is only over *why*:

        - ``replica_error``: the replica failed; the fleet still serves the
          version this stream was generating under (an ordinary retry
          regenerates equivalently).
        - ``version_skew``: a fleet weight rollout moved the surviving
          candidates (or the pinned replica itself) to a DIFFERENT weights
          version than the one the relayed tokens came from — a silent resume
          would splice two models' outputs into one stream. The refusal is
          recorded (``router.version_skew``) so a rollout postmortem shows
          which streams it cost."""
        if state.tokens_relayed == 0 or state.weights_version is None:
            return "replica_error"
        versions = {s.weights_version for s in self.pool.snapshots()
                    if s.state != DOWN and s.weights_version is not None}
        if versions and state.weights_version not in versions:
            RECORDER.record("router.version_skew", trace=state.rid,
                            replica=state.replica_id,
                            version=state.weights_version)
            self.metrics.version_skew_terminations.inc()
            return "version_skew"
        return "replica_error"

    def _terminate_midstream(self, handler, state: _RelayState,
                             cand: Optional[ReplicaSnapshot], payload: dict):
        """In-band terminal for a stream whose replica died after tokens were
        relayed (PR 3's engine_error contract, one level up): final chunk with
        ``finish_reason="replica_error"`` (``"version_skew"`` when a weight
        rollout made resumption impossible — see
        :meth:`_midstream_disposition`) + usage covering what the client
        actually received, then [DONE] — never a mid-stream connection reset."""
        replica_id = cand.id if cand is not None else "none"
        if cand is not None:
            self.pool.note_forward_failure(cand.id)
        finish_reason = self._midstream_disposition(state, cand)
        prompt = payload.get("prompt")
        self._finish(state, replica_id, finish_reason)
        try:
            usage = {"completion_tokens": state.tokens_relayed}
            if isinstance(prompt, (list, tuple)):
                # for a string prompt the router cannot know the token count
                # (no tokenizer); omit rather than emit a null the client's
                # usage accounting would trip over
                usage["prompt_tokens"] = len(prompt)
                usage["total_tokens"] = len(prompt) + state.tokens_relayed
            final = {"id": state.rid, "object": "text_completion.chunk",
                     "replica": replica_id,
                     "choices": [{"index": 0, "finish_reason": finish_reason}],
                     "usage": usage}
            handler.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
            handler.wfile.write(b"data: [DONE]\n\n")
            handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass

    # ------------------------------------------------------------- lifecycle
    def start_in_thread(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start poller + HTTP without blocking; returns the bound port."""
        self.pool.start()
        self._httpd = self._make_httpd(host, port)
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="router-http")
        t.start()
        bound = self._httpd.server_address[1]
        logger.info(f"router on {host}:{bound} fronting {len(self.pool)} replicas "
                    f"(policy={getattr(self.policy, 'name', '?')})")
        return bound

    def run(self, host: str = "0.0.0.0", port: int = 8010):
        self.pool.start()
        self._httpd = self._make_httpd(host, port)
        logger.info(f"router on {host}:{port} fronting {len(self.pool)} replicas")
        try:
            self._httpd.serve_forever()
        finally:
            self.shutdown()

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
        self.pool.stop()
