"""Two tiny port replicas behind the port's router, two tiny JAX replicas
behind the JAX router, on the same weights (the port's model is built with
``from_jax_params``).

- token ids through both routers are equal, and equal to the engine's own
  ``generate``, for batch and SSE requests;
- an injected ``engine.step`` fault on the replica a shared prefix pins ends
  the same way through both: the token-less stream fails over token-exact,
  the mid-stream one ends in ``replica_error`` after the same tokens, a batch
  request during the window answers 200, and the replica comes back HEALTHY;
- a drain with streams in flight loses nothing;
- the same ``FleetObservation`` sequence gives the same ``AutoscalerPolicy``
  decisions, and one in-process scale-up brings a third replica up HEALTHY;
- ``tools/rollout.py`` rolls the port's fleet to new weights and back;
- at the max envelope the autoscaler holds and hands off to a brownout floor
  that sheds best-effort traffic only (the port's counterpart of
  ``tests/robustness/test_autoscaler_chaos.py::TestMaxEnvelopeBrownoutHandoff``).

Every HTTP call and every wait has a timeout; torch runs on one intra-op
thread.
"""

import http.client
import json
import os
import subprocess
import sys
import threading
import time
import types

import jax
import pytest
import torch

import paddlenlp_tpu.serving.router as j_router
import paddlenlp_tpu_torch.serving.router as p_router
from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.serving import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.serving import SchedulerConfig as JSchedulerConfig
from paddlenlp_tpu.serving import SupervisorPolicy as JSupervisorPolicy
from paddlenlp_tpu.trainer.unified_checkpoint import save_unified_checkpoint
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.utils.faults import FAULTS as J_FAULTS
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.serving import MetricsRegistry, SchedulerConfig, SupervisorPolicy
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.utils.faults import FAULTS

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
ENG_KW = dict(max_batch_size=4, block_size=4, num_blocks=128, max_blocks_per_seq=32, decode_steps=4)
TIMEOUT = 60  # seconds for any one HTTP exchange or wait
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = [5, 6, 7]  # prefix_tokens=3: every PREFIX + tail prompt pins to one replica
PROMPTS = [PREFIX + [40, 41], [9, 10, 11, 12, 13, 14], [60, 61, 62], list(range(20, 36))]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    J_FAULTS.reset()
    FAULTS.reset()
    yield
    J_FAULTS.reset()
    FAULTS.reset()


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


def _side(name, models):
    jm, pm = models
    if name == "jax":
        return types.SimpleNamespace(
            name=name, router=j_router, faults=J_FAULTS, registry=JMetricsRegistry,
            factory=lambda: JEngine(jm, **ENG_KW),
            replica_kw=dict(scheduler_config=JSchedulerConfig(max_inflight=16, default_timeout_s=TIMEOUT),
                            supervisor_policy=JSupervisorPolicy(max_retries=0, backoff_base_s=0.05,
                                                                backoff_max_s=0.5)))
    return types.SimpleNamespace(
        name=name, router=p_router, faults=FAULTS, registry=MetricsRegistry,
        factory=lambda: InferenceEngine(pm, **ENG_KW),
        replica_kw=dict(scheduler_config=SchedulerConfig(max_inflight=16, default_timeout_s=TIMEOUT),
                        supervisor_policy=SupervisorPolicy(max_retries=0, backoff_base_s=0.05, backoff_max_s=0.5)))


@pytest.fixture(scope="module")
def fleets(models):
    """One two-replica fleet per package behind its own router, for the
    whole module; every test leaves them as it found them."""
    made = {}
    try:
        for name in ("jax", "torch"):
            side = _side(name, models)
            side.fleet = side.router.launch_fleet(
                2, side.factory, policy=side.router.PrefixAffinityPolicy(prefix_tokens=3), poll_interval_s=0.05,
                **side.replica_kw)
            made[name] = side
        yield made
    finally:
        for side in made.values():
            side.fleet.shutdown(drain_timeout_s=10)


def call(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, dict(resp.getheaders()), json.loads(raw) if "json" in ctype and raw else raw.decode()
    finally:
        conn.close()


def stream(port, payload, on_token=None):
    """(status, tokens, finish_reason, replica) of one SSE completion;
    ``on_token(n)`` runs after the n-th token arrived."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(dict(payload, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        tokens, finish, replica = [], None, None
        for line in resp:
            line = line.strip()
            if line == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            choice = json.loads(line[6:])["choices"][0]
            if choice.get("finish_reason"):
                finish, replica = choice["finish_reason"], json.loads(line[6:]).get("replica")
            elif "token" in choice:
                tokens.append(choice["token"])
                if on_token is not None:
                    on_token(len(tokens))
        return resp.status, tokens, finish, replica
    finally:
        conn.close()


def index_of(side, rid):
    return [f"127.0.0.1:{p}" for p in side.fleet.ports].index(rid)


def pinned_replica(side, prompt):
    return side.router.PrefixAffinityPolicy(prefix_tokens=3).select(
        side.fleet.router.pool.snapshots(), prompt=prompt)[0].id


def server_of(side, rid):
    return side.fleet.servers[index_of(side, rid)]


def wait_for(cond, what, timeout=TIMEOUT):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def wait_healthy(side):
    wait_for(lambda: all(s.state == "healthy" and not s.draining for s in side.fleet.router.pool.snapshots()),
             f"{side.name} fleet healthy")


class HeldLoop:
    """Hold a replica's engine loop after each step that left a request with
    output, until :meth:`release`: what the test does next then lands after
    exactly that many tokens, whatever the machine's load."""

    def __init__(self, server):
        self.engine = server.loop.engine
        self.released = threading.Event()
        self.held = threading.Event()
        real = self.engine.step

        def step():
            out = real()
            if any(r is not None and r.output_ids for r in self.engine.slots):
                self.held.set()
                assert self.released.wait(TIMEOUT), "the held loop was never released"
            return out

        self.engine.step = step

    def release(self):
        self.released.set()
        del self.engine.step


# ----------------------------------------------------------------- tokens
@pytest.mark.parametrize("mode", ["batch", "sse"])
def test_tokens_equal_through_both_routers_and_generate(fleets, models, mode):
    solo = InferenceEngine(models[1], **ENG_KW).generate([list(p) for p in PROMPTS],
                                                         SamplingParams(max_new_tokens=9))
    got = {}
    for name, side in fleets.items():
        wait_healthy(side)
        out = []
        for p in PROMPTS:
            if mode == "batch":
                status, _h, body = call(side.fleet.router_port, "POST", "/v1/completions",
                                        {"prompt": p, "max_tokens": 9})
                out.append((status, body["choices"][0]["token_ids"], body["choices"][0]["finish_reason"],
                            body["id"].startswith("rtr-"), index_of(side, body["replica"]) in (0, 1)))
            else:
                status, toks, finish, replica = stream(side.fleet.router_port, {"prompt": p, "max_tokens": 9})
                out.append((status, toks, finish, True, index_of(side, replica) in (0, 1)))
        got[name] = out
    assert got["jax"] == got["torch"]
    assert [o[1] for o in got["torch"]] == [list(s) for s in solo]
    assert all(o[0] == 200 and o[2] == "length" for o in got["torch"])


def test_sampled_tokens_equal_through_both_routers(fleets):
    payload = {"prompt": [40, 41, 42, 43, 44], "max_tokens": 8, "do_sample": True, "temperature": 0.8,
               "top_p": 0.9, "seed": 7}
    got = {name: call(side.fleet.router_port, "POST", "/v1/completions", payload)[2]["choices"][0]["token_ids"]
           for name, side in fleets.items()}
    assert got["jax"] == got["torch"] and len(got["torch"]) == 8


# ----------------------------------------------------------------- failover
def _failover_run(side):
    """The pinned replica fails one step before a fresh stream's first token
    (it fails over), then one step after a stream's first step (it ends
    ``replica_error``); a batch request during the window answers 200."""
    router, port = side.fleet.router, side.fleet.router_port
    wait_healthy(side)
    pinned = pinned_replica(side, PREFIX + [0])
    other = next(s.id for s in router.pool.snapshots() if s.id != pinned)
    out = {}
    side.faults.arm("engine.step", nth=1)
    status, toks, finish, replica = stream(port, {"prompt": PREFIX + [40], "max_tokens": 12})
    out["pre_token"] = (status, toks, finish, replica == other, side.faults.fired("engine.step"))
    out["failovers"] = router.metrics.failovers.value()
    wait_healthy(side)

    held = HeldLoop(server_of(side, pinned))
    first = threading.Event()
    result = {}
    t = threading.Thread(target=lambda: result.update(mid=stream(
        port, {"prompt": PREFIX + [41], "max_tokens": 24}, on_token=lambda n: first.set())))
    t.start()
    assert held.held.wait(TIMEOUT) and first.wait(TIMEOUT)
    side.faults.arm("engine.step", nth=1)
    side.faults.arm("engine.rebuild", nth=1)  # the first rebuild fails too: a wider window
    held.release()
    t.join(TIMEOUT)
    assert not t.is_alive()
    status, toks, finish, replica = result["mid"]
    out["mid_stream"] = (status, toks, finish, replica == pinned)
    wait_for(lambda: {s.id: s.state for s in router.pool.snapshots()}[pinned] != "healthy"
             or side.faults.fired("engine.rebuild"), "the pinned replica's fault")
    status, _h, body = call(port, "POST", "/v1/completions", {"prompt": PREFIX + [90], "max_tokens": 4})
    out["batch_in_window"] = (status, body["choices"][0]["token_ids"])
    wait_healthy(side)
    status, _h, body = call(port, "POST", "/v1/completions", {"prompt": PREFIX + [91], "max_tokens": 4})
    out["after"] = (status, body["choices"][0]["token_ids"], body["replica"] == pinned)
    out["replica_error_on_pinned"] = router.metrics.requests.value(replica=pinned, outcome="replica_error")
    return out


def test_injected_engine_fault_fails_over_the_same_way(fleets, models):
    got = {name: _failover_run(side) for name, side in fleets.items()}
    assert got["jax"] == got["torch"]
    o = got["torch"]
    eng = InferenceEngine(models[1], **ENG_KW)
    solo = eng.generate([PREFIX + [40], PREFIX + [41], PREFIX + [90], PREFIX + [91]],
                        SamplingParams(max_new_tokens=24))
    assert o["pre_token"] == (200, solo[0][:12], "length", True, 1)
    status, toks, finish, on_pinned = o["mid_stream"]
    assert status == 200 and finish == "replica_error" and on_pinned
    assert 1 <= len(toks) < 24 and toks == solo[1][:len(toks)]
    assert o["batch_in_window"] == (200, solo[2][:4])
    assert o["after"] == (200, solo[3][:4], True)


# ----------------------------------------------------------------- drain
def _drain_run(side):
    router, port = side.fleet.router, side.fleet.router_port
    wait_healthy(side)
    pinned = pinned_replica(side, PREFIX + [0])
    held = HeldLoop(server_of(side, pinned))
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.update({i: stream(
        port, {"prompt": PREFIX + [50 + i], "max_tokens": 16})})) for i in range(2)]
    for t in threads:
        t.start()
    wait_for(lambda: router._open_forwards_on(pinned) == 2, "two streams forwarded to the pinned replica")
    assert held.held.wait(TIMEOUT)
    code, _h, doc = call(port, "POST", "/replicas/drain", {"id": pinned, "deadline_s": 30})
    drain = (code, doc["drain"]["state"], doc["drain"]["draining"])
    status, _h, body = call(port, "POST", "/v1/completions", {"prompt": PREFIX + [70], "max_tokens": 4})
    during = (status, body["replica"] != pinned, body["choices"][0]["token_ids"])
    held.release()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    wait_for(lambda: (router.pool.drain_status(pinned) or {}).get("drained"), "the drain to complete")
    listed = {r["id"]: r for r in call(port, "GET", "/replicas")[2]["replicas"]}
    after = (listed[pinned]["drain"]["state"], listed[pinned]["open_forwards"])
    router.pool.cancel_drain(pinned)  # back into rotation for the next test
    server = server_of(side, pinned)
    assert call(server_port(side, pinned), "POST", "/admin/drain", {"undo": True})[0] == 200
    del server
    return {"drain": drain, "during": during, "after": after,
            "streams": [(results[i][0], results[i][1], results[i][2], results[i][3] == pinned) for i in range(2)]}


def server_port(side, rid):
    return side.fleet.ports[index_of(side, rid)]


def test_drain_with_streams_in_flight_loses_nothing(fleets, models):
    got = {name: _drain_run(side) for name, side in fleets.items()}
    assert got["jax"] == got["torch"]
    o = got["torch"]
    solo = InferenceEngine(models[1], **ENG_KW).generate([PREFIX + [50], PREFIX + [51], PREFIX + [70]],
                                                         SamplingParams(max_new_tokens=16))
    assert o["drain"] == (200, "draining", True)
    assert o["during"] == (200, True, solo[2][:4])
    assert o["after"] == ("drained", 0)
    assert o["streams"] == [(200, solo[0], "length", True), (200, solo[1], "length", True)]


# ----------------------------------------------------------------- autoscaler
class StubAdmin:
    def __init__(self):
        self.calls = []

    def list_replicas(self):
        return {"replicas": []}

    def slo(self):
        return {"windows": {}}

    def add_replica(self, host, port):
        self.calls.append(("add", host, port))
        return {"replica": {"id": f"{host}:{port}"}}

    def drain_replica(self, replica_id, deadline_s):
        self.calls.append(("drain", replica_id, deadline_s))
        return {"drain": {"id": replica_id}}

    def remove_replica(self, replica_id, force=False):
        self.calls.append(("remove", replica_id, force))
        return {"replica": {"id": replica_id}}

    def push_brownout(self, host, port, level, reason="slo_fast_burn", ttl_s=None):
        self.calls.append(("brownout", host, port, level, reason, ttl_s))
        return True


class StubProvisioner:
    def __init__(self, R, fail_first=0):
        self.R, self.n, self.fail_first, self.calls = R, 0, fail_first, []

    def provision(self):
        self.n += 1
        if self.n <= self.fail_first:
            raise RuntimeError("no capacity")
        self.calls.append(("provision", self.n))
        return self.R.ProvisionedReplica("10.0.0.9", 9000 + self.n)

    def deprovision(self, host, port):
        self.calls.append(("deprovision", host, port))

    def close(self):
        pass


def _observations(R):
    rep = lambda i, **kw: R.ReplicaObservation(id=f"r{i}", host="10.0.0.1", port=8000 + i, **kw)  # noqa: E731
    hot = [rep(0, kv_utilization=0.95, queue_depth=6.0), rep(1, kv_utilization=0.9, queue_depth=5.0)]
    calm = [rep(0, kv_utilization=0.1), rep(1, kv_utilization=0.05)]
    return ([R.FleetObservation(replicas=hot)] * 3 + [R.FleetObservation(replicas=calm, ttft_burn=30.0)]
            + [R.FleetObservation(replicas=calm)] * 7
            + [R.FleetObservation(replicas=[rep(0, state="down"), rep(1)])]
            + [R.FleetObservation(replicas=[rep(0, draining=True, drained=True), rep(1)])]
            + [R.FleetObservation(replicas=hot + [rep(2, kv_utilization=0.99, queue_depth=9.0),
                                                  rep(3, kv_utilization=0.99, queue_depth=9.0)])] * 3)


def test_autoscaler_decisions_equal_on_one_observation_sequence():
    def run(R, faults, Reg):
        admin, prov, registry = StubAdmin(), StubProvisioner(R, fail_first=1), Reg()
        scaler = R.Autoscaler(admin, prov, policy=R.AutoscalerPolicy(
            min_replicas=2, max_replicas=4, hysteresis_up=2, hysteresis_down=3, cooldown_up_s=10.0,
            cooldown_down_s=20.0, max_step_up=2, provision_backoff_base_s=1.0), registry=registry)
        summaries = []
        for i, obs in enumerate(_observations(R)):
            if i == 12:
                faults.arm("router.provision", nth=1)
            summaries.append(scaler.evaluate_once(now=1000.0 + 5.0 * i, observation=obs))
        return summaries, admin.calls, prov.calls, [(a, d) for _t, a, d in scaler.events], registry.expose()

    j = run(j_router, J_FAULTS, JMetricsRegistry)
    p = run(p_router, FAULTS, MetricsRegistry)
    assert json.loads(json.dumps(j, default=str)) == json.loads(json.dumps(p, default=str))
    actions = {a[0] for s in p[0] for a in s["actions"]}
    assert {"up", "hold", "replace", "provisioned"} <= actions, actions


def _scale_up_run(side):
    router, port = side.fleet.router, side.fleet.router_port
    wait_healthy(side)
    prov = side.router.InProcessProvisioner(side.factory, replica_kw=side.replica_kw)
    scaler = side.router.Autoscaler(("127.0.0.1", port), prov, registry=side.registry(),
                                    policy=side.router.AutoscalerPolicy(min_replicas=2, max_replicas=3,
                                                                        hysteresis_up=1, max_step_up=1))
    try:
        obs = scaler.observe()
        obs.ttft_burn = 50.0  # a forced fast burn
        t0 = time.perf_counter()
        summary = scaler.evaluate_once(observation=obs)
        (host, new_port), = list(prov.servers)
        new_id = f"{host}:{new_port}"
        wait_for(lambda: {s.id: s.state for s in router.pool.snapshots()}.get(new_id) == "healthy",
                 "the new replica to probe HEALTHY")
        healthy_s = time.perf_counter() - t0
        status, _h, body = call(port, "POST", "/v1/completions", {"prompt": [77, 78, 79], "max_tokens": 5})
        listed = call(port, "GET", "/replicas")[2]["replicas"]
        out = {"actions": [a[0] for a in summary["actions"]], "replicas": len(listed),
               "new_state": next(r["state"] for r in listed if r["id"] == new_id),
               "completion": (status, body["choices"][0]["token_ids"]), "healthy_in_time": healthy_s < TIMEOUT}
        assert call(port, "POST", "/replicas/drain", {"id": new_id, "deadline_s": 5})[0] == 200
        wait_for(lambda: (router.pool.drain_status(new_id) or {}).get("drained"), "the new replica to drain")
        assert call(port, "DELETE", f"/replicas/{new_id}")[0] == 200
        return out
    finally:
        prov.close()


def test_in_process_scale_up_brings_a_third_replica_up_healthy(fleets):
    got = {name: _scale_up_run(side) for name, side in fleets.items()}
    assert got["jax"] == got["torch"]
    assert got["torch"]["replicas"] == 3 and got["torch"]["new_state"] == "healthy"
    assert "up" in got["torch"]["actions"]
    assert all(len(fleets[n].fleet.router.pool) == 2 for n in fleets)


# ----------------------------------------------------------------- rollout tool
def test_rollout_tool_drives_the_port_router(fleets, tmp_path):
    side = fleets["torch"]
    port = side.fleet.router_port
    wait_healthy(side)
    for name, seed in (("v1", 1), ("v0", 0)):
        save_unified_checkpoint(str(tmp_path / name),
                                JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=seed), None)
    before = call(port, "POST", "/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 6})[2]
    lines = {}
    for version in ("v1", "v0"):
        out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "rollout.py"), "--router",
                              f"127.0.0.1:{port}", "--ckpt-dir", str(tmp_path / version), "--poll-interval", "0.05",
                              "--drain-deadline", "10", "--rejoin-timeout", "30", "--swap-timeout", "60"],
                             capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stdout + out.stderr
        lines[version] = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
        versions = {r["weights_version"] for r in call(port, "GET", "/replicas")[2]["replicas"]}
        assert versions == {version}
        if version == "v1":
            moved = call(port, "POST", "/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 6})[2]
    after = call(port, "POST", "/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 6})[2]
    for version in ("v1", "v0"):
        assert [x["event"] for x in lines[version]] == ["submitted", "replica_done", "replica_done", "terminal"]
        assert lines[version][-1]["status"] == "done" and lines[version][-1]["version"] == version
    assert moved["choices"][0]["token_ids"] != before["choices"][0]["token_ids"]
    assert after["choices"][0]["token_ids"] == before["choices"][0]["token_ids"]


# ----------------------------------------------------------------- brownout handoff
def test_max_envelope_hold_hands_off_to_brownout(fleets):
    """At the max envelope an overloaded fleet cannot grow: the autoscaler
    records the hold and pushes a brownout floor; best-effort sheds with a
    clean 503 + Retry-After while interactive traffic completes; a level-0
    push lifts the floor. The router's own fast-burn push (off-thread, from
    the ``/fleet/slo`` scrapes of the autoscaler's ticks) is joined before
    the lift, so it cannot land after it."""
    side = fleets["torch"]
    router, port = side.fleet.router, side.fleet.router_port
    wait_healthy(side)
    scaler = side.router.Autoscaler(("127.0.0.1", port), side.router.InProcessProvisioner(side.factory),
                                    policy=side.router.AutoscalerPolicy(
                                        min_replicas=1, max_replicas=2, hysteresis_up=1, scale_up_queue_depth=0.0,
                                        brownout_push_level=1, brownout_push_ttl_s=60.0),
                                    registry=MetricsRegistry())
    scaler.admin.timeout_s = TIMEOUT
    servers = side.fleet.servers
    try:
        summary = scaler.evaluate_once()
        assert summary["overloaded"] is True
        assert ("hold", {"reason": "max_envelope"}) in summary["actions"]
        pushed = [a for a in summary["actions"] if a[0] == "brownout_push"]
        assert pushed and pushed[0][1]["replicas"] == 2
        assert scaler.metrics.brownout_pushes.value() == 2.0
        assert len(router.pool) == 2
        status, headers, doc = call(port, "POST", "/v1/completions",
                                    {"prompt": [5, 6, 7], "max_tokens": 4, "priority": "best_effort"})
        assert status == 503, doc
        assert doc["error"]["type"] in ("overloaded_shed", "no_replica_available")
        assert int(headers.get("Retry-After", "1")) >= 1
        status, _h, doc = call(port, "POST", "/v1/completions",
                               {"prompt": [5, 6, 7], "max_tokens": 4, "priority": "interactive"})
        assert status == 200 and len(doc["choices"][0]["token_ids"]) == 4, doc
        assert all(s.scheduler.brownout.level >= 1 for s in servers)
        scaler.evaluate_once()
        assert scaler.metrics.brownout_pushes.value() == 4.0
    finally:
        # the router pushes its fast-burn floor on daemon threads: let every
        # such push land before lifting, or one can re-floor the fleet after
        for t in [t for t in threading.enumerate() if t.name.startswith("brownout-push-")]:
            t.join(TIMEOUT)
        for p in side.fleet.ports:
            assert scaler.admin.push_brownout("127.0.0.1", p, 0, reason="slo_fast_burn")
    assert all(s.scheduler.brownout.level == 0 for s in servers)
    status, _h, doc = call(port, "POST", "/v1/completions",
                           {"prompt": [5, 6, 7], "max_tokens": 4, "priority": "best_effort"})
    assert status == 200, doc
