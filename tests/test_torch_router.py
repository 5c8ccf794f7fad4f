"""The port's router tier against the JAX package's, over scriptable stub
replicas: no engine, so the file runs in seconds.

One fleet of stdlib stub replicas serves a JAX ``RouterServer`` and then a
port ``RouterServer`` under the same script (each side gets its own registry,
tracer, flight recorder and fault registry, as each package has its own). The
two runs must agree on everything apart from ids and times: the policies'
orders, ``HashRing`` placements, the pool's state sequence, reroute and
failover on 429, 503 and a refused connection, the mid-stream
``replica_error`` terminal, hedge events, the admin plane's codes and bodies,
``/health``, the federated ``/fleet/metrics`` text, ``/fleet/slo``,
``/fleet/usage`` and the fleet ``/debug/efficiency``, the fast-burn brownout
push, the rollout orchestrator's outcome and abort, the stitched two-tier
trace, the router's own counters and the flight recorder's events in order.
``parse_prometheus_text``, ``histogram_quantile``, ``lint_exposition`` and the
``SLOTracker`` burn rates are held to the JAX modules on the same inputs.
Every HTTP call and every wait has a timeout.
"""

import dataclasses
import http.client
import importlib
import json
import random
import re
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import pytest

import paddlenlp_tpu.observability.prometheus as j_prom
import paddlenlp_tpu.observability.slo as j_slo
import paddlenlp_tpu.serving.router as j_router
import paddlenlp_tpu_torch.observability.prometheus as p_prom
import paddlenlp_tpu_torch.observability.slo as p_slo
import paddlenlp_tpu_torch.serving.router as p_router
from paddlenlp_tpu.observability.flight_recorder import RECORDER as J_RECORDER
from paddlenlp_tpu.observability.tracer import SpanTracer as JSpanTracer
from paddlenlp_tpu.serving.metrics import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.utils.faults import FAULTS as J_FAULTS
from paddlenlp_tpu_torch.observability.flight_recorder import RECORDER
from paddlenlp_tpu_torch.observability.tracer import SpanTracer
from paddlenlp_tpu_torch.serving.metrics import MetricsRegistry
from paddlenlp_tpu_torch.utils.faults import FAULTS

TIMEOUT = 30  # seconds for any one HTTP exchange or wait

SIDES = {
    "jax": types.SimpleNamespace(router=j_router, registry=JMetricsRegistry, tracer=JSpanTracer,
                                 recorder=J_RECORDER, faults=J_FAULTS, prom=j_prom, slo=j_slo),
    "torch": types.SimpleNamespace(router=p_router, registry=MetricsRegistry, tracer=SpanTracer,
                                   recorder=RECORDER, faults=FAULTS, prom=p_prom, slo=p_slo),
}

# values that are times, durations or sequence numbers: equal in kind, not in value
TIMEY = {"t", "ts", "dur", "tid", "seq", "last_poll_t", "now", "wall_s", "clock_offset_s", "rtt_s",
         "deadline_in_s", "removed_t", "age_s", "elapsed_s"}


def scrub(obj):
    if isinstance(obj, dict):
        return {k: ("<t>" if k in TIMEY and isinstance(v, (int, float)) else scrub(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [scrub(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"Thread-\d+", "Thread-N", obj)
    return obj


@pytest.fixture(autouse=True)
def _clean_globals():
    for side in SIDES.values():
        side.faults.reset()
    yield
    for side in SIDES.values():
        side.faults.reset()


REQS = "paddlenlp_serving_requests_total"
TTFT = "paddlenlp_serving_ttft_seconds"


def exposition(kv=0.25, stop=95.0, engine_error=5.0, ttft_fast=80.0, ttft_count=100.0, fed=None):
    lines = ["# HELP paddlenlp_serving_kv_utilization KV blocks in use",
             "# TYPE paddlenlp_serving_kv_utilization gauge",
             f"paddlenlp_serving_kv_utilization {kv}",
             f"# HELP {REQS} Finished requests by terminal state", f"# TYPE {REQS} counter",
             f'{REQS}{{status="stop"}} {stop}', f'{REQS}{{status="engine_error"}} {engine_error}',
             f"# HELP {TTFT} Arrival to first token", f"# TYPE {TTFT} histogram",
             f'{TTFT}_bucket{{le="0.1"}} {ttft_fast}', f'{TTFT}_bucket{{le="1.0"}} {ttft_fast}',
             f'{TTFT}_bucket{{le="+Inf"}} {ttft_count}', f"{TTFT}_count {ttft_count}", f"{TTFT}_sum 9.5"]
    if fed is not None:
        lines += ["# HELP paddlenlp_serving_fed_tokens_total Tokens fed",
                  "# TYPE paddlenlp_serving_fed_tokens_total counter",
                  f"paddlenlp_serving_fed_tokens_total {fed}",
                  "# HELP paddlenlp_serving_useful_tokens_total Useful tokens",
                  "# TYPE paddlenlp_serving_useful_tokens_total counter",
                  f"paddlenlp_serving_useful_tokens_total {fed * 0.75}",
                  "# HELP paddlenlp_serving_wasted_tokens_total Wasted tokens",
                  "# TYPE paddlenlp_serving_wasted_tokens_total counter",
                  f'paddlenlp_serving_wasted_tokens_total{{kind="padding"}} {fed * 0.25}',
                  "# HELP paddlenlp_serving_stage_queue_depth Stage queue",
                  "# TYPE paddlenlp_serving_stage_queue_depth gauge",
                  f'paddlenlp_serving_stage_queue_depth{{stage="decode"}} {fed / 100}']
    return "\n".join(lines) + "\n"


class Stub:
    """A scriptable replica speaking the ``ServingServer`` surface the router
    uses: /health, /metrics, /debug/trace, /debug/efficiency, /debug/usage,
    /v1/completions (SSE and batch), /v1/abort and the admin routes it
    propagates to (/admin/drain, /admin/brownout, /admin/weights,
    /admin/adapters). :meth:`reset` sets the script and clears the log."""

    def __init__(self, name):
        self.name = name
        self._active = 0
        self._lock = threading.Lock()
        self.reset()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _raw(self, code, body, ctype="application/json", headers=None):
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    for k, v in (headers or {}).items():
                        self.send_header(k, str(v))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # the router tore this leg down on purpose (hedge loser)

            def _json(self, code, doc, headers=None):
                self._raw(code, json.dumps(doc).encode(), headers=headers)

            def handle_one_request(self):
                with stub._lock:
                    stub._active += 1
                try:
                    super().handle_one_request()
                finally:
                    with stub._lock:
                        stub._active -= 1

            def do_GET(self):
                parts = urlsplit(self.path)
                if parts.path == "/health":
                    doc = {"status": stub.health, "scheduler": {"inflight": stub.inflight},
                           "engine": {"queue_depth": stub.queue}, "weights_version": stub.version,
                           "brownout": stub.brownout_level}
                    if stub.now_fn is not None:
                        doc["now"] = stub.now_fn()
                    self._json(200 if stub.health == "ok" else 503, doc,
                               headers=None if stub.health == "ok" else {"Retry-After": 3})
                elif parts.path == "/metrics":
                    self._raw(200, stub.exposition.encode(), "text/plain; version=0.0.4")
                elif parts.path == "/debug/trace":
                    trace = parse_qs(parts.query).get("trace", [""])[0]
                    events = [{"name": n, "ph": "X", "ts": 1000.0 + 10 * i, "dur": 5.0, "pid": 1, "tid": 7,
                               "cat": "serving", "args": {"trace": trace}}
                              for i, n in enumerate(("request", "queue", "prefill", "decode"))]
                    self._json(200, {"traceEvents": events, "otherData": {"dropped_spans": 2}})
                elif parts.path == "/debug/efficiency":
                    self._json(200, {"tier": "replica", "ledger": {"totals": stub.ledger}})
                elif parts.path == "/debug/usage":
                    self._json(200, stub.usage)
                else:
                    self._json(404, {"error": "no route"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                stub.log.append((self.path, payload))
                if self.path == "/v1/abort":
                    self._json(200, {"id": payload.get("id"), "cancelled": True})
                elif self.path == "/admin/drain":
                    self._json(200, {"draining": not payload.get("undo")})
                elif self.path == "/admin/brownout":
                    stub.brownout_level = payload.get("level", 0)
                    self._json(200, {"level": stub.brownout_level})
                elif self.path == "/admin/adapters":
                    self._json(200 if stub.swap_ok else 400, {"op": payload.get("op"), "adapters": ["base"]})
                elif self.path == "/admin/weights":
                    if not stub.swap_ok:
                        self._json(409, {"ok": False, "error": "canary mismatch"})
                        return
                    stub.version = payload.get("version", stub.version)
                    self._json(200, {"ok": True, "version": stub.version, "canary_digest": "d1g3st"})
                elif self.path in ("/v1/completions", "/v1/chat/completions"):
                    stub.headers.append(self.headers.get("X-Pdnlp-Traceparent"))
                    self._completion(payload)
                else:
                    self._json(404, {"error": "no route"})

            def _completion(self, payload):
                if "prompt" not in payload:
                    self._json(400, {"error": {"message": "missing required field 'prompt'",
                                               "type": "invalid_request"}})
                    return
                cid = f"cmpl-{next(stub._ids)}"
                mode = stub.mode
                if mode == "reject429":
                    self._json(429, {"error": {"message": "full", "type": "rate_limit_exceeded"}})
                    return
                if mode == "reject503":
                    self._json(503, {"error": {"message": "recovering", "type": "engine_recovering"}},
                               headers={"Retry-After": 7})
                    return
                if mode == "fail500":
                    self._json(500, {"error": {"message": "boom", "type": "internal_error"}})
                    return
                toks = stub.tokens[: int(payload.get("max_tokens", 16))]
                if not payload.get("stream"):
                    if mode in ("engine_error_pre", "engine_error_mid"):
                        self._json(200, {"id": cid, "object": "text_completion",
                                         "choices": [{"index": 0, "finish_reason": "engine_error", "token_ids": []}]})
                        return
                    time.sleep(stub.delay_s * len(toks))
                    self._json(200, {"id": cid, "object": "text_completion",
                                     "choices": [{"index": 0, "finish_reason": "length", "token_ids": toks}],
                                     "usage": {"prompt_tokens": len(payload["prompt"]),
                                               "completion_tokens": len(toks)}})
                    return
                try:
                    self._stream(cid, payload, mode, toks)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _stream(self, cid, payload, mode, toks):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Connection", "close")
                self.end_headers()

                def chunk(obj):
                    self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                    self.wfile.flush()

                def tokens(ts):
                    for t in ts:
                        time.sleep(stub.delay_s)
                        chunk({"id": cid, "object": "text_completion.chunk",
                               "choices": [{"index": 0, "token": t, "finish_reason": None}]})

                if mode == "engine_error_pre":
                    chunk({"id": cid, "object": "text_completion.chunk",
                           "choices": [{"index": 0, "finish_reason": "engine_error"}]})
                    self.wfile.write(b"data: [DONE]\n\n")
                    return
                if mode in ("engine_error_mid", "die_midstream"):
                    tokens(toks[:2])
                    if mode == "die_midstream":
                        self.connection.close()  # a crash, not a completion
                        return
                    chunk({"id": cid, "object": "text_completion.chunk",
                           "choices": [{"index": 0, "finish_reason": "engine_error"}]})
                    self.wfile.write(b"data: [DONE]\n\n")
                    return
                tokens(toks)
                chunk({"id": cid, "object": "text_completion.chunk",
                       "choices": [{"index": 0, "finish_reason": "length"}],
                       "usage": {"prompt_tokens": len(payload["prompt"]), "completion_tokens": len(toks)}})
                self.wfile.write(b"data: [DONE]\n\n")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        self.port = self._httpd.server_address[1]

    def reset(self, mode="ok", tokens=(7, 8, 9), health="ok", kv=0.25, delay_s=0.0, exposition_kw=None,
              version="v0", swap_ok=True, now_fn=None, inflight=0, queue=0):
        self.mode, self.tokens, self.health, self.delay_s = mode, list(tokens), health, delay_s
        self.exposition = exposition(kv=kv, **(exposition_kw or {}))
        self.version, self.swap_ok, self.now_fn = version, swap_ok, now_fn
        self.inflight, self.queue, self.brownout_level = inflight, queue, 0
        self.ledger = {"fed": 100, "useful": 75, "padding": 25}
        self.usage = {"records": 2, "totals": {"prompt_tokens": 10, "completion_tokens": 6},
                      "tenants": {"t0": {"requests": 2, "completion_tokens": 6}}, "adapters": {}}
        self._ids = iter(range(10_000))
        self.log = []  # (path, payload) of every POST
        self.headers = []  # traceparent of every completion

    def quiesce(self):
        deadline = time.time() + TIMEOUT
        while self._active and time.time() < deadline:
            time.sleep(0.01)
        assert not self._active, f"stub {self.name} still busy"

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


@pytest.fixture(scope="module")
def stubs():
    made = {n: Stub(n) for n in ("a", "b", "c")}
    yield made
    for s in made.values():
        s.stop()


def http_call(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        headers = {k: v for k, v in resp.getheaders() if k in ("Retry-After", "Content-Type")}
        return resp.status, headers, (json.loads(raw) if "json" in ctype and raw else raw.decode())
    finally:
        conn.close()


def sse(port, payload, path="/v1/completions"):
    """The parsed ``data:`` chunks of one streamed completion, up to [DONE]."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(dict(payload, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, json.loads(resp.read() or b"{}")
        chunks = []
        for line in resp:
            line = line.strip()
            if line == b"data: [DONE]":
                chunks.append("[DONE]")
                break
            if line.startswith(b"data: "):
                chunks.append(json.loads(line[6:]))
        return resp.status, chunks
    finally:
        conn.close()


def router_counters(side, router, skip=()):
    """The router's own exposition without its latency observations: every
    counter and gauge sample, and the histograms' counts (but the families in
    ``skip``, whose counts follow the poller's clock)."""
    fams = side.prom.parse_prometheus_text(router.registry.expose())
    out = {}
    for name, fam in sorted(fams.items()):
        for (sample, labels), v in sorted(fam.samples.items()):
            if (fam.type == "histogram" and not sample.endswith("_count")) or name in skip:
                continue
            out[f"{sample}{dict(labels)}"] = v
    return out


def run_side(side, stubs, script, names=("a", "b"), extra=(), stub_kw=None, skip=(), **router_kw):
    """Reset the stubs, start ``side``'s router over them, run ``script`` and
    return what it observed plus the router's counters, the stubs' logs and
    the flight recorder's events of the run."""
    for n, s in stubs.items():
        s.reset(**(stub_kw or {}).get(n, {}))
    mark = side.recorder.snapshot()[-1].seq if len(side.recorder) else 0
    router = side.router.RouterServer(
        [("127.0.0.1", stubs[n].port, n) for n in names] + list(extra), registry=side.registry(),
        tracer=side.tracer(), **dict(dict(poll_interval_s=30.0), **router_kw))
    port = router.start_in_thread()
    try:
        deadline = time.time() + TIMEOUT
        while any(s.last_poll_t is None for s in router.pool.snapshots()) and time.time() < deadline:
            time.sleep(0.005)
        observed = script(side, router, port)
    finally:
        router.shutdown()
        for s in stubs.values():
            s.quiesce()
    events = [dict(e.to_dict()) for e in side.recorder.snapshot(since_seq=mark)]
    return scrub({"observed": observed, "counters": router_counters(side, router, skip),
                  "stub_posts": {n: s.log for n, s in stubs.items()},
                  "traceparents": {n: s.headers for n, s in stubs.items()},
                  "events": [e for e in events if e["name"].startswith(("router.", "rollout.", "scale."))]})


def both(stubs, script, **kw):
    got = {name: run_side(side, stubs, script, **kw) for name, side in SIDES.items()}
    assert got["jax"] == got["torch"], _first_difference(got["jax"], got["torch"])
    return got["torch"]


def _first_difference(a, b, path="$"):
    if type(a) is not type(b):
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}.{k}: only on one side ({a.get(k)!r} / {b.get(k)!r})"
            if a[k] != b[k]:
                return _first_difference(a[k], b[k], f"{path}.{k}")
    if isinstance(a, list) and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return _first_difference(x, y, f"{path}[{i}]")
    return f"{path}: {a!r} != {b!r}"


# ----------------------------------------------------------------- policies
def _snap(side, rid, state="healthy", inflight=0, queue=0, kv=0.0, draining=False, version=None):
    return side.router.ReplicaSnapshot(id=rid, host="127.0.0.1", port=0, state=state, inflight=inflight,
                                       queue_depth=queue, kv_utilization=kv, retry_after_s=None,
                                       consecutive_failures=0, last_poll_t=None, draining=draining,
                                       weights_version=version)


def _fleets(side):
    s = lambda *a, **k: _snap(side, *a, **k)  # noqa: E731
    return [
        [s("a", inflight=4), s("b", inflight=1, queue=1), s("c", kv=0.9)],
        [s("a", state="down"), s("b", state="degraded"), s("c", inflight=50), s("d", state="recovering")],
        [s(f"r{i}", inflight=i % 3, kv=0.1 * i) for i in range(6)],
        [s("a", inflight=40), s("b"), s("c"), s("d", draining=True)],
        [s("a", version="v1"), s("b", version="v2", inflight=3), s("c", state="recovering", version="v1")],
    ]


PROMPTS = [None, [1, 2, 3, 4, 5], list(range(40)), list(range(3, 40)), "a system prompt, then the question",
           [9] * 20, [5, 6, 7]]


@pytest.mark.parametrize("policy", ["least_loaded", "prefix_affinity", "prefix_affinity_spill"])
def test_policy_orders_equal(policy):
    def orders(side):
        if policy == "least_loaded":
            pol = side.router.resolve_policy("least_loaded")
        else:
            spill = 2.0 if policy.endswith("spill") else None
            pol = side.router.PrefixAffinityPolicy(prefix_tokens=4, vnodes=32, spill_load_score=spill)
        out = []
        for fleet in _fleets(side):
            out.append([side.router.load_score(x) for x in fleet])
            for prompt in PROMPTS:
                for exclude in (frozenset(), frozenset({"b"}), frozenset({"a", "r2"})):
                    out.append([c.id for c in pol.select(fleet, prompt=prompt, exclude=exclude)])
            if policy != "least_loaded":
                out.append([c.id for c in pol.select(fleet, prompt=[1, 2, 3, 4], adapter_id="lora-7")])
                out.append([c.id for c in pol.select(fleet, prompt=[1, 2], conversation="conv-3")])
        return out, getattr(pol, "name", None)

    j, p = orders(SIDES["jax"]), orders(SIDES["torch"])
    assert j == p
    assert len({tuple(o) for o in j[0] if isinstance(o, list) and o and isinstance(o[0], str)}) > 1


def test_hash_ring_places_1000_keys_equally():
    ids = [f"127.0.0.1:{8000 + i}" for i in range(5)]
    keys = [f"prefix-{k}" for k in range(1000)]
    placements = {}
    for name, side in SIDES.items():
        ring = side.router.HashRing(ids, vnodes=64)
        smaller = side.router.HashRing(ids[:4], vnodes=64)
        placements[name] = ([ring.ordered(k) for k in keys], [smaller.ordered(k)[0] for k in keys])
    assert placements["jax"] == placements["torch"]
    full, smaller = placements["torch"]
    assert {o[0] for o in full} == set(ids) and all(sorted(o) == sorted(ids) for o in full)
    moved = sum(a[0] != b for a, b in zip(full, smaller) if a[0] != ids[4])
    assert moved == 0  # only the removed node's keys move


def test_pool_state_sequence_equal():
    def run(side):
        R = side.router
        ok = R.ProbeResult(reachable=True, status="ok", inflight=3, queue_depth=2, kv_utilization=0.5,
                           weights_version="v1")
        shed = R.ProbeResult(reachable=True, status="degraded", retry_after_s=4.0, brownout_level=2)
        boom = ConnectionRefusedError("boom")
        script = [ok, shed, ok, boom, boom, boom, ok, boom, ok, ok, ok, shed, boom, ok, ok]
        pool = R.ReplicaPool(metrics=R.RouterMetrics(side.registry()), down_after=3, recovery_polls=2)
        pool.add("127.0.0.1", 1, "r0")
        seq = iter(script)

        def fake_probe(_replica):
            item = next(seq)
            if isinstance(item, Exception):
                raise item
            return item

        pool._probe = fake_probe
        out = []
        for _ in script:
            pool.poll_once()
            s = pool.snapshots()[0]
            out.append((s.state, s.consecutive_failures, s.retry_after_s, s.inflight, s.kv_utilization,
                        s.brownout_level, s.weights_version, pool.metrics.replica_healthy.value(replica="r0"),
                        pool.retry_after_hint()))
        pool.note_forward_failure("r0")
        out.append(pool.snapshots()[0].state)
        pool.note_degraded("r0", retry_after_s=2.5)
        out.append((pool.snapshots()[0].state, pool.snapshots()[0].retry_after_s))
        out.append(scrub(pool.start_drain("r0", deadline_s=5)))
        out.append(scrub(pool.cancel_drain("r0")))
        side.faults.arm("router.health_poll", nth=1)
        pool._probe = R.ReplicaPool._probe.__get__(pool)
        pool.poll_once()
        out.append((side.faults.fired("router.health_poll"), pool.snapshots()[0].state))
        return out

    j, p = run(SIDES["jax"]), run(SIDES["torch"])
    assert j == p
    states = [row[0] for row in p[:15]]
    assert {"healthy", "degraded", "down", "recovering"} <= set(states)


# ----------------------------------------------------------------- proxy
def _complete(port, stream, prompt=(1, 2, 3), **kw):
    payload = dict(prompt=list(prompt), max_tokens=3, **kw)
    if stream:
        return sse(port, payload)
    status, headers, body = http_call(port, "POST", "/v1/completions", payload)
    return status, headers, body


def _pool_view(router):
    return [(s.id, s.state, s.retry_after_s) for s in router.pool.snapshots()]


@pytest.mark.parametrize("stream", [False, True], ids=["batch", "sse"])
@pytest.mark.parametrize("case", ["429", "503", "connect_refused", "engine_error_pre", "fail500", "all_down",
                                  "bad_request"])
def test_reroute_and_failover_equal(stubs, case, stream):
    """``a`` is the least-loaded candidate and fails the way ``case`` says;
    the request lands on ``b`` (or is relayed, or rejected when nothing is
    left) the same way through both routers."""
    stub_kw = {"a": dict(kv=0.1), "b": dict(kv=0.2)}
    extra = ()
    if case == "429":
        stub_kw["a"]["mode"] = "reject429"
    elif case == "503":
        stub_kw["a"]["mode"] = "reject503"
    elif case == "engine_error_pre":
        stub_kw["a"]["mode"] = "engine_error_pre"
    elif case == "fail500":
        stub_kw["a"]["mode"] = "fail500"
    elif case == "all_down":
        stub_kw = {"a": dict(mode="reject503"), "b": dict(mode="reject429")}
    elif case == "connect_refused":
        extra = [("127.0.0.1", 1, "dead")]

    def script(side, router, port):
        if case == "connect_refused":
            # the poller believes the dead replica healthy and idle: the
            # refusal shows only when the request is forwarded
            router.pool._probe = lambda r, real=router.pool._probe: (
                side.router.ProbeResult(reachable=True, status="ok", kv_utilization=0.0)
                if r.id == "dead" else real(r))
            router.pool.poll_once()
        before = _pool_view(router)
        if case == "bad_request":
            out = http_call(port, "POST", "/v1/completions", {"max_tokens": 3, "stream": stream})
        else:
            out = _complete(port, stream)
        return {"before": before, "response": out, "after": _pool_view(router)}

    got = both(stubs, script, extra=extra, stub_kw=stub_kw)
    resp = got["observed"]["response"]
    if case == "all_down":
        assert resp[0] == 503
    elif case == "bad_request":
        assert resp[0] == 400
    else:
        assert resp[0] == 200


@pytest.mark.parametrize("mode", ["die_midstream", "engine_error_mid"])
def test_midstream_replica_error_terminal_equal(stubs, mode):
    def script(side, router, port):
        return {"stream": _complete(port, True), "batch": _complete(port, False), "pool": _pool_view(router)}

    got = both(stubs, script, stub_kw={"a": dict(mode=mode, kv=0.1), "b": dict(kv=0.2)})
    chunks = got["observed"]["stream"][1]
    assert [c["choices"][0].get("token") for c in chunks[:2]] == [7, 8]
    assert chunks[2]["choices"][0]["finish_reason"] == "replica_error" and chunks[-1] == "[DONE]"
    assert got["observed"]["batch"][0] == 200  # a batch failure resubmits: nothing reached the client


@pytest.mark.parametrize("stream", [True, False], ids=["sse", "batch"])
@pytest.mark.parametrize("case", ["hedge_wins", "primary_wins", "capped"])
def test_hedge_events_equal(stubs, case, stream):
    """The primary ``a`` is slow; past ``hedge_after_s`` a shadow races it on
    ``b``. ``primary_wins``: the shadow is slower still. ``capped``: no hedge
    slot is free."""
    slow, slower = 0.25, 0.5
    stub_kw = {"a": dict(kv=0.1, delay_s=slow), "b": dict(kv=0.2)}
    if case == "primary_wins":
        stub_kw["b"]["delay_s"] = slower
    kw = dict(hedge_after_s=0.05, max_hedges_inflight=0 if case == "capped" else 4)

    def script(side, router, port):
        out = {"response": _complete(port, stream)}
        deadline = time.time() + TIMEOUT
        while router._hedges_inflight and time.time() < deadline:
            time.sleep(0.01)  # the losing leg gives its hedge slot back when it ends
        out["hedge_slots_returned"] = router._hedges_inflight == 0
        return out

    got = both(stubs, script, stub_kw=stub_kw, **kw)
    names = [e["name"] for e in got["events"]]
    assert ("router.hedge_fire" in names) == (case != "capped")


# ----------------------------------------------------------------- admin plane
def test_admin_plane_codes_and_bodies_equal(stubs):
    c = stubs["c"]

    def script(side, router, port):
        out = []
        call = lambda *a: out.append(http_call(port, *a))  # noqa: E731
        call("GET", "/replicas")
        call("POST", "/replicas", {})
        call("POST", "/replicas", {"host": "127.0.0.1", "port": "x"})
        call("POST", "/replicas", {"host": "127.0.0.1", "port": c.port, "id": "c"})
        call("POST", "/replicas", {"host": "127.0.0.1", "port": c.port, "id": "c"})
        call("POST", "/replicas/drain", {"id": "zz"})
        call("POST", "/replicas/drain", {"id": "c", "deadline_s": "NaN"})
        call("POST", "/replicas/drain", {"id": "c", "deadline_s": 5})
        deadline = time.time() + TIMEOUT
        while not any(p == "/admin/drain" for p, _ in c.log) and time.time() < deadline:
            time.sleep(0.01)
        call("DELETE", "/replicas/c")  # 409: the sweep has not seen it drained
        router.pool.poll_once()
        call("GET", "/replicas")
        call("DELETE", "/replicas/c")
        call("DELETE", "/replicas/zz")
        call("DELETE", "/replicas/b?force=1")
        side.faults.arm("router.membership", nth=1)
        call("POST", "/replicas", {"host": "127.0.0.1", "port": c.port, "id": "c2"})
        call("GET", "/replicas")
        call("GET", "/no/such/route")
        return out

    got = both(stubs, script)
    assert [o[0] for o in got["observed"]] == [200, 400, 400, 200, 409, 404, 400, 200, 409, 200, 200, 404,
                                                200, 500, 200, 404]


# ----------------------------------------------------------------- planes
def test_health_and_fleet_planes_equal(stubs):
    """``/health``, ``/fleet/metrics``, ``/fleet/slo`` (twice, with the
    fast-burn brownout push it triggers), ``/fleet/usage``, the fleet
    ``/debug/efficiency``, the fleet adapter push and the router's own
    ``/metrics``; ``c`` is DOWN and skipped by every fold."""
    stub_kw = {"a": dict(exposition_kw=dict(stop=90.0, engine_error=10.0, ttft_fast=50.0, fed=400.0)),
               "b": dict(kv=0.5, exposition_kw=dict(fed=100.0))}
    extra = [("127.0.0.1", 1, "c")]

    def script(side, router, port):
        for _ in range(3):
            router.pool.poll_once()  # c: unreachable three times -> DOWN
        out = {"health": http_call(port, "GET", "/health"), "fleet_metrics": http_call(port, "GET", "/fleet/metrics")}
        out["slo"] = [http_call(port, "GET", "/fleet/slo") for _ in range(2)]
        deadline = time.time() + TIMEOUT
        while (sum(p == "/admin/brownout" for s in stubs.values() for p, _ in s.log) < 2
               and time.time() < deadline):
            time.sleep(0.01)
        out["usage"] = http_call(port, "GET", "/fleet/usage")
        out["efficiency"] = http_call(port, "GET", "/debug/efficiency")
        out["adapters"] = http_call(port, "POST", "/admin/adapters", {"op": "list"})
        out["router_metrics_families"] = sorted(side.prom.parse_prometheus_text(
            http_call(port, "GET", "/metrics")[2]))
        out["lint_router"] = side.prom.lint_exposition(router.registry.expose())
        texts = {n: stubs[n].exposition for n in ("a", "b")}
        out["lint_federation"] = side.router.lint_federation(texts)
        out["federate"] = side.router.federate_expositions(texts)
        return out

    got = both(stubs, script, extra=extra, stub_kw=stub_kw, slo_windows_s=(60.0, 3600.0))
    obs = got["observed"]
    assert obs["health"][0] == 200 and obs["slo"][0][2]["skipped"] == ["c"]
    assert obs["lint_federation"] == [] and obs["lint_router"] == []
    assert sorted(p for p, _ in got["stub_posts"]["a"]) == ["/admin/adapters", "/admin/brownout"]


@pytest.mark.parametrize("join_first", [False, True], ids=["lift_races_the_push", "lift_after_the_push"])
def test_fast_burn_push_races_an_unjoined_lift(stubs, monkeypatch, join_first):
    """The router's fast-burn brownout push runs on daemon threads
    (``RouterServer.push_brownout``). An operator's lift pushed while one is
    still on its way is undone when it lands: the replica ends floored at
    level 1. Joining the router's push threads before the lift leaves it at
    0. The same in both routers (the race behind the JAX package's
    ``TestMaxEnvelopeBrownoutHandoff`` flake; the push is held 0.2 s here,
    a loaded CPU holds it by chance)."""
    stub_kw = {"a": dict(exposition_kw=dict(stop=50.0, engine_error=50.0))}
    for side in SIDES.values():
        proxy = importlib.import_module(side.router.__name__ + ".proxy")

        def held(host, port, level, _real=proxy.pool_push_brownout, **kw):
            time.sleep(0.2)
            return _real(host, port, level, **kw)

        monkeypatch.setattr(proxy, "pool_push_brownout", held)

    def push_threads():
        return [t for t in threading.enumerate() if t.name.startswith("brownout-push-")]

    def script(side, router, port):
        pool = importlib.import_module(side.router.__name__ + ".pool")
        assert http_call(port, "GET", "/fleet/slo")[0] == 200  # 50% engine_error: a fast burn
        if join_first:
            for t in push_threads():
                t.join(TIMEOUT)
        lifted = pool.push_brownout("127.0.0.1", stubs["a"].port, 0, reason="slo_fast_burn")
        for t in push_threads():
            t.join(TIMEOUT)
        return {"lifted": lifted, "final_level": stubs["a"].brownout_level,
                "pushes": [pl["level"] for path, pl in stubs["a"].log if path == "/admin/brownout"]}

    got = both(stubs, script, names=("a",), stub_kw=stub_kw)
    assert got["observed"]["lifted"] is True
    assert got["observed"]["pushes"] == ([1, 0] if join_first else [0, 1])
    assert got["observed"]["final_level"] == (0 if join_first else 1)


@pytest.mark.parametrize("case", ["done", "abort_rolled_back", "abort_no_rollback", "injected_fault",
                                  "bad_request"])
def test_rollout_outcome_and_abort_equal(stubs, case):
    stub_kw = {"a": dict(kv=0.1), "b": dict(kv=0.2)}
    body = {"ckpt_dir": "/ckpt/v1", "wait": True, "drain_deadline_s": 5, "rejoin_timeout_s": 10}
    if case.startswith("abort"):
        stub_kw["b"]["swap_ok"] = False
    if case == "abort_rolled_back":
        body["rollback_ckpt_dir"] = "/ckpt/v0"
    if case == "bad_request":
        body = {"wait": True}

    def script(side, router, port):
        if case == "injected_fault":
            side.faults.arm("router.rollout", nth=2)
        out = {"rollout": http_call(port, "POST", "/admin/weights/rollout", body),
               "status": http_call(port, "GET", "/admin/weights/rollout")}
        # a rolled-back replica's version reaches the pool with the next probe
        deadline = time.time() + TIMEOUT
        while (any(x.weights_version != stubs[x.id].version or x.draining for x in router.pool.snapshots())
               and time.time() < deadline):
            time.sleep(0.01)
        out["versions"] = [(x.id, x.weights_version, x.draining) for x in router.pool.snapshots()]
        return out

    got = both(stubs, script, stub_kw=stub_kw, poll_interval_s=0.05,
               skip=("paddlenlp_router_health_polls_total",))
    code = got["observed"]["rollout"][0]
    assert code == {"done": 200, "bad_request": 400}.get(case, 409)


def test_stitched_trace_equal(stubs):
    """Router spans plus the owning replica's, moved onto the router's
    timeline by the skew the poller estimated (the stub's clock runs 5 s
    ahead of the router's tracer)."""
    def script(side, router, port):
        for s in stubs.values():
            s.now_fn = lambda tr=router.tracer: tr.now() + 5.0
        for _ in range(3):
            router.pool.poll_once()
        status, _h, body = _complete(port, False)
        doc = http_call(port, "GET", f"/debug/trace?trace={body['id']}")[2]
        offset = router.pool.clock_offset(body["replica"])
        replica_ts = [e["ts"] for e in doc["traceEvents"] if e.get("pid") == 2 and e.get("ph") == "X"]
        return {"status": status, "trace": doc, "offset_ok": 4.9 < offset < 5.1,
                "shifted": [round(ts + offset * 1e6, 0) for ts in replica_ts],
                "since_ts": http_call(port, "GET", "/debug/trace?since_ts=banana")[0],
                "router_only": http_call(port, "GET", "/debug/trace?trace=rtr-999")[2]}

    got = both(stubs, script, stub_kw={"a": dict(kv=0.1), "b": dict(kv=0.2)})
    obs = got["observed"]
    assert obs["offset_ok"] and obs["shifted"] == [1000.0, 1010.0, 1020.0, 1030.0]
    names = {e["name"] for e in obs["trace"]["traceEvents"]}
    assert {"route", "router_request", "request", "prefill"} <= names
    assert got["traceparents"]["a"] == ["rtr-0;parent=rtr-0@router;sampled=1"]


# ----------------------------------------------------------------- prometheus and SLO
TEXTS = [
    exposition(),
    exposition(kv=0.9, fed=250.0),
    '# HELP x_total a\n# TYPE x_total counter\nx_total{a="q\\"uote",b="back\\\\slash"} 3\nx_total{a="nl\\n"} NaN\n',
    "# TYPE h histogram\nh_bucket{le=\"0.5\"} 3\nh_bucket{le=\"0.25\"} 5\nh_bucket{le=\"+Inf\"} 4\nh_count 4\n",
    "# HELP bad-name x\n# TYPE bad-name gauge\nbad-name 1\nno_type_metric 2\n",
    "# HELP g x\n# TYPE g gauge\ng +Inf\ng{l=\"1\"} -Inf\n",
]


@pytest.mark.parametrize("idx", range(len(TEXTS)))
def test_prometheus_parse_quantile_and_lint_equal(idx):
    def run(prom):
        text = TEXTS[idx]
        try:
            fams = prom.parse_prometheus_text(text)
        except ValueError as e:
            return repr(e), prom.lint_exposition(text)
        parsed = {n: (f.type, f.help, sorted((s, tuple(l), repr(v)) for (s, l), v in f.samples.items()))
                  for n, f in fams.items()}
        quantiles = {n: [repr(prom.histogram_quantile(f, q)) for q in (0.0, 0.5, 0.9, 0.99, 1.0)]
                     for n, f in fams.items() if f.type == "histogram"}
        return parsed, quantiles, prom.lint_exposition(text)

    assert run(j_prom) == run(p_prom)


def test_slo_burn_rates_equal_under_an_injected_clock():
    rng = random.Random(3)
    seq, total, errors, ttft, viol = [], 0.0, 0.0, 0.0, 0.0
    for i in range(40):
        n = rng.randint(0, 20)
        total += n
        errors += rng.randint(0, n // 4) if i % 7 == 3 else 0
        ttft += n
        viol += rng.randint(0, n // 3) if i % 5 == 1 else 0
        seq.append((1000.0 + 30.0 * i, (total, errors, ttft, viol)))
    seq.insert(20, (1000.0 + 30.0 * 19.5, (1.0, 0.0, 1.0, 0.0)))  # one scrape blip: dropped
    seq += [(3000.0, (2.0, 0.0, 2.0, 0.0)), (3030.0, (3.0, 1.0, 3.0, 1.0))]  # a confirmed counter reset

    def run(slo, Reg):
        burns = []
        tracker = slo.SLOTracker(objectives=slo.SLOObjectives(availability=0.99, ttft_threshold_s=0.5),
                                 windows_s=(60.0, 300.0, 3600.0), registry=Reg())
        tracker.on_fast_burn = lambda kind, rate, window: burns.append((kind, round(rate, 9), window))
        reports = []
        for now, (t, e, c, v) in seq:
            tracker.observe(slo.SLOInputs(total=t, errors=e, ttft_count=c, ttft_violations=v), now=now)
            reports.append(tracker.report(now=now))
        return reports, burns, tracker.registry.expose()

    j, p = run(j_slo, JMetricsRegistry), run(p_slo, MetricsRegistry)
    assert j == p
    assert j[1], "the sequence must cross the fast-burn line at least once"


def test_slo_inputs_from_families_equal():
    texts = [exposition(), exposition(stop=10.0, engine_error=0.0, ttft_fast=3.0, ttft_count=10.0),
             exposition() + 'paddlenlp_serving_requests_total{status="capacity"} 4\n']
    for text in texts:
        got = []
        for prom, slo in ((j_prom, j_slo), (p_prom, p_slo)):
            fams = prom.parse_prometheus_text(text)
            got.append([slo.slo_inputs_from_families(fams, slo.SLOObjectives(ttft_threshold_s=t))
                        for t in (0.1, 0.5, 1.0, 5.0)])
        assert [dataclasses.asdict(x) for x in got[0]] == [dataclasses.asdict(x) for x in got[1]]
