"""The port's HTTP serving stack against the JAX package's, on one tiny model.

One JAX ``ServingServer`` and one port ``ServingServer`` (each with its own
``MetricsRegistry``) serve the same model (the port's built with
``from_jax_params``). A scripted run sends both the same requests one at a
time (completion, SSE, two chat turns, an abort, the 400/404/413 errors,
then a drain and its 503) and is compared exactly: token ids, finish
reasons and response bodies apart from ids and times; the ``/metrics``
families and label sets, the request and token counters; the ``/health``
keys; the ``/debug/efficiency`` ledger totals; the flight recorder's events
in order; the tracer's span names. An ``engine.step`` fault then takes both
supervisors through the same rebuild and requeue. Every HTTP call and every
wait has a timeout, so a hung loop fails the test instead of the suite.
"""

import contextlib
import http.client
import json
import re
import threading
import time

import jax
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.observability.flight_recorder import RECORDER as J_RECORDER
from paddlenlp_tpu.observability.tracer import TRACER as J_TRACER
from paddlenlp_tpu.serving import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.serving import SchedulerConfig as JSchedulerConfig
from paddlenlp_tpu.serving import EngineLoop as JEngineLoop
from paddlenlp_tpu.serving import ServingServer as JServingServer
from paddlenlp_tpu.serving import SupervisorPolicy as JSupervisorPolicy
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.utils.faults import FAULTS as J_FAULTS
from paddlenlp_tpu_torch.experimental import InferenceEngine
from paddlenlp_tpu_torch.observability.exporter import PROFILE_CAPTURE
from paddlenlp_tpu_torch.observability.flight_recorder import RECORDER
from paddlenlp_tpu_torch.observability.span_catalog import SPAN_CATALOG
from paddlenlp_tpu_torch.observability.tracer import TRACER
from paddlenlp_tpu_torch.serving import EngineLoop, MetricsRegistry, SchedulerConfig, ServingServer, SupervisorPolicy
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.utils.faults import FAULTS

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
ENG_KW = dict(max_batch_size=4, block_size=4, num_blocks=128, max_blocks_per_seq=32, decode_steps=4)
MAX_BODY = 4096
TIMEOUT = 60  # seconds for any one HTTP exchange or wait

PROMPT_A = list(range(5, 17))
PROMPT_B = [40, 41, 42, 43, 44, 45, 46]
SAMPLED = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7)


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def servers(models):
    jm, pm = models
    kw = dict(max_body_bytes=MAX_BODY)
    js = JServingServer(JEngine(jm, **ENG_KW), registry=JMetricsRegistry(),
                        scheduler_config=JSchedulerConfig(max_inflight=8, default_timeout_s=TIMEOUT),
                        supervisor_policy=JSupervisorPolicy(backoff_base_s=0.01), **kw)
    ps = ServingServer(InferenceEngine(pm, **ENG_KW), registry=MetricsRegistry(),
                       scheduler_config=SchedulerConfig(max_inflight=8, default_timeout_s=TIMEOUT),
                       supervisor_policy=SupervisorPolicy(backoff_base_s=0.01), **kw)
    ports = (js.start_in_thread(), ps.start_in_thread())
    try:
        yield (js, ps), ports
    finally:
        J_FAULTS.reset()
        FAULTS.reset()
        for srv in (js, ps):
            srv.shutdown(drain_timeout_s=10)
        assert not js.loop.running and not ps.loop.running


def request(port, method, path, payload=None, raw=None):
    """One HTTP exchange: (status, headers, parsed JSON body or raw bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        body = raw if raw is not None else (None if payload is None else json.dumps(payload))
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, dict(resp.getheaders()), json.loads(data) if "json" in ctype and data else data
    finally:
        conn.close()


def stream(port, path, payload, on_first=None):
    """SSE request: the list of parsed ``data:`` chunks up to ``[DONE]``;
    ``on_first`` runs once the first token chunk arrived."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(dict(payload, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        chunks = []
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            if line == b"data: [DONE]":
                return chunks
            chunks.append(json.loads(line[6:]))
            if on_first is not None and any("token" in c or "token" in c.get("delta", {})
                                            for c in chunks[-1].get("choices", [])):
                on_first(chunks[-1]["id"])
                on_first = None
        raise AssertionError("stream closed without [DONE]")
    finally:
        conn.close()


def scrub(doc):
    """A response body without what differs between two runs: ids and times."""
    if isinstance(doc, dict):
        return {k: (None if k in ("timing",) else scrub(v)) for k, v in doc.items() if k != "id"}
    if isinstance(doc, list):
        return [scrub(v) for v in doc]
    return doc


def metric_families(text):
    """{family: {label-set key: value}} from a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            out.setdefault(line.split()[2], {})
        elif line and not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            name, _, labels = name_labels.partition("{")
            fam = next((f for f in out if name == f or re.fullmatch(re.escape(f) + r"_(bucket|sum|count|total)", name)),
                       name)
            keys = tuple(sorted(re.findall(r'(\w+)="', labels)))
            out.setdefault(fam, {})[(name, labels.rstrip("}"), keys)] = float(value)
    return out


@contextlib.contextmanager
def held_after_first_step(srv, released):
    """Hold the loop after each engine step that left a request with output
    until ``released`` is set: a mid-stream abort then lands after exactly
    one step's tokens, whatever the machine's load."""
    eng = srv.loop.engine
    real_step = eng.step

    def step():
        out = real_step()
        if any(r is not None and r.output_ids for r in eng.slots):
            assert released.wait(TIMEOUT), "the abort never arrived"
        return out

    eng.step = step
    try:
        yield
    finally:
        del eng.step


def run_script(srv, port):
    """The scripted session against one server; returns what it saw."""
    seen = {}
    seen["completion"] = request(port, "POST", "/v1/completions", {"prompt": PROMPT_A, "max_tokens": 9})[2]
    seen["sampled"] = request(port, "POST", "/v1/completions", dict(prompt=PROMPT_B, max_tokens=6, **SAMPLED))[2]
    seen["sse"] = stream(port, "/v1/completions", {"prompt": PROMPT_B, "max_tokens": 7})
    turn1 = [{"role": "user", "content": PROMPT_A}]
    seen["chat1"] = request(port, "POST", "/v1/chat/completions", {"messages": turn1, "max_tokens": 5})[2]
    reply = seen["chat1"]["choices"][0]["message"]["token_ids"]
    turn2 = turn1 + [{"role": "assistant", "content": reply}, {"role": "user", "content": [50, 51, 52]}]
    seen["chat2"] = stream(port, "/v1/chat/completions", {"messages": turn2, "max_tokens": 5})
    cancelled, released = {}, threading.Event()

    def abort(cid):
        cancelled.update(request(port, "POST", "/v1/abort", {"id": cid})[2])
        released.set()

    with held_after_first_step(srv, released):
        seen["aborted"] = stream(port, "/v1/completions", {"prompt": [60, 61, 62, 63], "max_tokens": 100},
                                 on_first=abort)
    seen["abort_reply"] = cancelled
    seen["err_missing"] = request(port, "POST", "/v1/completions", {"max_tokens": 4})[:3:2]
    seen["err_vocab"] = request(port, "POST", "/v1/completions", {"prompt": [1, 999], "max_tokens": 4})[:3:2]
    seen["err_route"] = request(port, "GET", "/v1/nothing")[:3:2]
    seen["err_big"] = request(port, "POST", "/v1/completions", raw=json.dumps({"prompt": [1] * MAX_BODY}))[0]
    seen["metrics"] = request(port, "GET", "/metrics")[2].decode()
    seen["health"] = request(port, "GET", "/health")
    seen["efficiency"] = request(port, "GET", "/debug/efficiency")[2]
    seen["requests"] = request(port, "GET", "/debug/requests")[2]
    seen["drain"] = request(port, "POST", "/admin/drain", {"retry_after_s": 3})[2]
    seen["drained"] = request(port, "POST", "/v1/completions", {"prompt": PROMPT_A, "max_tokens": 2})
    seen["health_draining"] = request(port, "GET", "/health")[:2]
    seen["undrain"] = request(port, "POST", "/admin/drain", {"undo": True})[2]
    return seen


@pytest.fixture(scope="module")
def scripted(servers):
    """Both servers through the same script, each with its own recorder and
    tracer cleared first; the JAX side runs first, then the port."""
    (js, ps), (jport, pport) = servers
    out = {}
    for key, srv, port, recorder, tracer in (("jax", js, jport, J_RECORDER, J_TRACER),
                                             ("port", ps, pport, RECORDER, TRACER)):
        recorder.clear()
        tracer.clear()
        seen = run_script(srv, port)
        seen["events"] = [e["name"] for e in recorder.to_dicts(recorder.snapshot())]
        seen["spans"] = {s.name for s in tracer.snapshot()}
        seen["trace_doc"] = request(port, "GET", "/debug/trace")[2]
        out[key] = seen
    return out


def test_completions_match(scripted):
    j, p = scripted["jax"], scripted["port"]
    for key in ("completion", "sampled", "chat1"):
        assert p[key]["choices"][0]["finish_reason"] == "length"
        assert scrub(p[key]) == scrub(j[key]), key
    assert len(p["completion"]["choices"][0]["token_ids"]) == 9


def test_sse_streams_match(scripted):
    j, p = scripted["jax"], scripted["port"]
    for key in ("sse", "chat2"):
        assert scrub(p[key]) == scrub(j[key]), key
        assert len({c["id"] for c in p[key]}) == 1
        assert p[key][-1]["choices"][0]["finish_reason"] == "length"
    toks = [c["choices"][0]["token"] for c in p["sse"][:-1]]
    assert len(toks) == 7


def test_chat_second_turn_reuses_the_first(scripted):
    p = scripted["port"]
    usage = p["chat2"][-1]["usage"]
    turn1_len = p["chat1"]["usage"]["prompt_tokens"] + p["chat1"]["usage"]["completion_tokens"]
    # turn 1's prompt and all but its last (never fed) token are cached KV,
    # whole blocks of 4 only
    assert usage["cached_tokens"] == (turn1_len - 1) // 4 * 4
    assert usage["cached_tokens"] == scripted["jax"]["chat2"][-1]["usage"]["cached_tokens"]


def test_abort_mid_stream(scripted):
    j, p = scripted["jax"], scripted["port"]
    assert p["abort_reply"] == {"id": p["abort_reply"]["id"], "cancelled": True}
    assert p["aborted"][-1]["choices"][0]["finish_reason"] == "abort"
    assert j["aborted"][-1]["choices"][0]["finish_reason"] == "abort"
    # the abort landed after the first step: its prefill token and one
    # decode call's 4 tokens
    assert len(p["aborted"]) - 1 == 5 == len(j["aborted"]) - 1


def test_error_statuses_match(scripted):
    j, p = scripted["jax"], scripted["port"]
    assert p["err_missing"][0] == 400 and p["err_vocab"][0] == 400
    assert p["err_route"][0] == 404 and p["err_big"] == 413
    for key in ("err_missing", "err_vocab", "err_route", "err_big"):
        assert p[key] == j[key], key


def test_drain_answers_503_with_retry_after(scripted):
    j, p = scripted["jax"], scripted["port"]
    status, headers, body = p["drained"]
    assert status == 503 and headers["Retry-After"] == "3" and body["error"]["type"] == "shutting_down"
    assert (status, headers["Retry-After"], body) == (j["drained"][0], j["drained"][1]["Retry-After"], j["drained"][2])
    assert p["health_draining"][0] == 503 == j["health_draining"][0]
    assert p["drain"] == j["drain"] and p["undrain"] == j["undrain"] == {"draining": False}


def test_metrics_families_and_counters_match(scripted):
    jf, pf = metric_families(scripted["jax"]["metrics"]), metric_families(scripted["port"]["metrics"])
    assert set(pf) == set(jf)
    # the compile families: JAX compiles its step programs, eager PyTorch
    # compiles nothing, so the port registers them and exposes no series
    compile_fams = ("paddlenlp_serving_compiles_total", "paddlenlp_serving_compile_seconds_total")
    assert not pf["paddlenlp_serving_compiles_total"] and jf["paddlenlp_serving_compiles_total"]
    for fam in set(jf) - set(compile_fams):
        assert {k[:3:2] for k in pf[fam]} == {k[:3:2] for k in jf[fam]}, fam
    for fam in ("paddlenlp_serving_requests_total", "paddlenlp_serving_tokens_generated_total",
                "paddlenlp_serving_prefix_cache_hits_total", "paddlenlp_serving_prefix_cache_cached_tokens_total",
                "paddlenlp_serving_usage_tokens_total", "paddlenlp_serving_usage_records_total",
                "paddlenlp_serving_fed_tokens_total", "paddlenlp_serving_useful_tokens_total"):
        assert pf[fam] == jf[fam], fam
    done = {k[1]: v for k, v in pf["paddlenlp_serving_requests_total"].items()}
    assert sum(v for k, v in done.items() if 'status="length"' in k) == 5
    assert sum(v for k, v in done.items() if 'status="abort"' in k) == 1
    received = sum(len(scripted["port"][k]["choices"][0].get("token_ids", []) or
                       scripted["port"][k]["choices"][0].get("message", {}).get("token_ids", []))
                   for k in ("completion", "sampled", "chat1"))
    received += sum(len(scripted["port"][k]) - 1 for k in ("sse", "aborted")) + len(scripted["port"]["chat2"]) - 2
    assert sum(pf["paddlenlp_serving_tokens_generated_total"].values()) == received


def test_health_keys_match(scripted):
    (js, jh, jb), (ps, ph, pb) = scripted["jax"]["health"], scripted["port"]["health"]
    assert ps == js == 200 and pb["status"] == "ok"
    assert set(pb) == set(jb)
    assert set(pb["engine"]) == set(jb["engine"]) and set(pb["scheduler"]) == set(jb["scheduler"])
    assert pb["weights_version"] == jb["weights_version"] == "v0"


def test_efficiency_totals_match(scripted):
    j, p = scripted["jax"]["efficiency"], scripted["port"]["efficiency"]
    assert p["ledger"]["totals"] == j["ledger"]["totals"]
    assert p["ledger"]["rework_by"] == j["ledger"]["rework_by"]
    t = p["ledger"]["totals"]
    assert t["fed"] == t["useful"] + t["padding"] + t["spec_rejected"] + t["rework"]
    assert sum(p["ledger"]["rework_by"].values()) == t["rework"]
    assert sum(p["ledger"]["padding_by"].values()) == t["padding"]


def test_usage_on_debug_requests_match(scripted):
    j, p = scripted["jax"]["requests"]["recent"], scripted["port"]["requests"]["recent"]
    keys = ("prompt_tokens", "cached_tokens", "completion_tokens", "useful_tokens")
    assert [(r["finish_reason"], r["output_tokens"], {k: r["usage"][k] for k in keys}) for r in p] == \
        [(r["finish_reason"], r["output_tokens"], {k: r["usage"][k] for k in keys}) for r in j]


def test_flight_recorder_events_match(scripted):
    p = scripted["port"]["events"]
    assert p == scripted["jax"]["events"]
    assert {"admit.accept", "sched.reject"} <= set(p)


def test_span_names_match_and_are_catalogued(scripted):
    p = scripted["port"]["spans"]
    assert p == scripted["jax"]["spans"]
    assert {"admission", "prefix_cache", "prefill", "decode", "kv_alloc", "kv_free", "request", "queue"} <= p
    names = {e["name"] for e in scripted["port"]["trace_doc"]["traceEvents"] if e.get("ph") in ("X", "i")}
    assert names and names <= set(SPAN_CATALOG)


def test_loop_thread_leaves_ordinary_tensors(servers, scripted):
    """The loop steps the engine under ``torch.inference_mode()``; the
    engine's long-lived tensors must stay ordinary ones, or a caller on
    another thread could no longer update them in place."""
    eng = servers[0][1].loop.engine
    assert torch.is_inference_mode_enabled() is False
    assert not eng.backend.counts.is_inference() and not eng.pool.kv.is_inference()
    eng.backend.reset_counts()  # an in-place update outside inference mode


def test_engine_step_fault_rebuild_and_requeue_match(servers, scripted):
    """An ``engine.step`` fault on the second step of a lone request: both
    supervisors triage it into the requeue stash, rebuild the engine in
    place, resubmit it with its streamed tokens folded into the prompt and
    finish it token-exact, booking the re-prefill as requeue_refill rework."""
    (js, ps), (jport, pport) = servers
    results = []
    for srv, port, faults in ((js, jport, J_FAULTS), (ps, pport, FAULTS)):
        before = request(port, "GET", "/debug/efficiency")[2]["ledger"]
        clean = request(port, "POST", "/v1/completions", {"prompt": PROMPT_B, "max_tokens": 10})[2]
        faults.arm("engine.step", nth=2)
        try:
            faulted = request(port, "POST", "/v1/completions", {"prompt": PROMPT_B, "max_tokens": 10})[2]
            assert faults.fired("engine.step") == 1
        finally:
            faults.reset()
        after = request(port, "GET", "/debug/efficiency")[2]["ledger"]
        metrics = metric_families(request(port, "GET", "/metrics")[2].decode())
        deadline = time.time() + TIMEOUT
        while srv.loop.state != "running" and time.time() < deadline:
            time.sleep(0.01)
        results.append(dict(
            clean=clean["choices"][0]["token_ids"], faulted=faulted["choices"][0],
            restarts=sum(metrics["paddlenlp_serving_engine_restarts_total"].values()),
            retries=sum(metrics["paddlenlp_serving_request_retries_total"].values()),
            rework={k: after["rework_by"].get(k, 0) - before["rework_by"].get(k, 0) for k in after["rework_by"]},
            state=srv.loop.state))
    j, p = results
    assert p["faulted"]["token_ids"] == p["clean"] and p["faulted"]["finish_reason"] == "length"
    assert p["restarts"] == 1 and p["retries"] == 1 and p["state"] == "running"
    assert p["rework"]["requeue_refill"] > 0
    assert p == j


def test_poisoned_device_context_is_not_rebuilt():
    """A CUDA error that poisons the context (here raised by a stand-in step
    on the CPU) fails the in-flight request, leaves the loop DEGRADED and
    answers 503, without a rebuild: retrying on the same context cannot
    succeed."""
    pm = LlamaForCausalLM.init_random(LlamaConfig(**MODEL_KW), seed=0, device="cpu", dtype=torch.float32)
    eng = InferenceEngine(pm, **ENG_KW)
    real_step = eng.step

    def poisoned_step():
        if eng.slots[0] is not None and len(eng.slots[0].output_ids) >= 5:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real_step()

    eng.step = poisoned_step
    srv = ServingServer(eng, registry=MetricsRegistry(), supervisor_policy=SupervisorPolicy(backoff_base_s=0.01),
                        scheduler_config=SchedulerConfig(default_timeout_s=TIMEOUT))
    port = srv.start_in_thread()
    try:
        status, _, body = request(port, "POST", "/v1/completions", {"prompt": PROMPT_A, "max_tokens": 12})
        assert status == 200 and body["choices"][0]["finish_reason"] == "engine_error"
        assert len(body["choices"][0]["token_ids"]) == 5
        assert srv.loop.state == "degraded" and "illegal memory access" in srv.loop.device_error
        status, headers, body = request(port, "POST", "/v1/completions", {"prompt": PROMPT_A, "max_tokens": 2})
        assert status == 503 and body["error"]["type"] == "engine_recovering" and "Retry-After" in headers
        assert request(port, "GET", "/health")[0] == 503
        metrics = metric_families(request(port, "GET", "/metrics")[2].decode())
        assert sum(metrics["paddlenlp_serving_engine_restarts_total"].values()) == 0
    finally:
        srv.shutdown(drain_timeout_s=5)


def test_usage_seal_failure_on_stop(models):
    """A divergence from the reference, kept on purpose: when sealing the
    usage ledger fails at stop, the JAX loop's ``logger.warning(...,
    exc_info=True)`` raises TypeError (its logger takes no keywords) out of
    ``stop()``; the port logs the failure and reports the loop stopped."""
    jm, pm = models
    outcomes = []
    for loop in (JEngineLoop(JEngine(jm, **ENG_KW), registry=JMetricsRegistry()),
                 EngineLoop(InferenceEngine(pm, **ENG_KW), registry=MetricsRegistry())):
        loop.start()

        def broken_close():
            raise OSError("disk full")

        loop.usage.close = broken_close
        try:
            outcomes.append(loop.stop(timeout=TIMEOUT))
        except TypeError as e:
            outcomes.append(type(e).__name__)
        assert not loop.running
    assert outcomes == ["TypeError", True]


def test_run_on_loop_runs_on_the_loop_thread(servers, scripted):
    """``run_on_loop`` runs a callable on the loop thread and hands back its
    result or its exception; a loop that is not running refuses it."""
    loop = servers[0][1].loop
    assert loop.run_on_loop(lambda: threading.current_thread().name, timeout_s=TIMEOUT) == "engine-loop"
    with pytest.raises(ZeroDivisionError):
        loop.run_on_loop(lambda: 1 / 0, timeout_s=TIMEOUT)
    with pytest.raises(RuntimeError, match="not running"):
        EngineLoop(loop.engine, registry=MetricsRegistry()).run_on_loop(lambda: None)


def test_profile_records_the_loop_thread(servers, scripted, tmp_path, monkeypatch):
    """``/debug/profile`` starts and stops ``torch.profiler`` on the loop
    thread, between two steps: a capture taken while a stream runs holds the
    loop's ``engine_step`` ranges and their ops, and the stream's tokens are
    those of the same request alone. It runs on the port alone, after the
    tests that compare the two servers' ledgers."""
    srv, port = servers[0][1], servers[1][1]
    monkeypatch.setattr(PROFILE_CAPTURE, "base_dir", str(tmp_path))
    body = {"prompt": PROMPT_A, "max_tokens": 100}
    want = request(port, "POST", "/v1/completions", body)[2]["choices"][0]["token_ids"]
    eng = srv.loop.engine
    real_step = eng.step

    def slow_step():  # ~25 steps of >= 20 ms: the loop steps through the whole window
        time.sleep(0.02)
        return real_step()

    prof = {}
    profiler = threading.Thread(target=lambda: prof.update(r=request(port, "POST", "/debug/profile?seconds=0.3")))
    eng.step = slow_step
    try:
        chunks = stream(port, "/v1/completions", body, on_first=lambda _cid: profiler.start())
    finally:
        del eng.step
    profiler.join(TIMEOUT)
    assert not profiler.is_alive() and prof["r"][0] == 200
    assert [c["choices"][0]["token"] for c in chunks if "token" in c["choices"][0]] == want
    with open(f"{prof['r'][2]['path']}/trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"engine_step", "aten::mm"} <= names
