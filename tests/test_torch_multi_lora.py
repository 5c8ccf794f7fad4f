"""The port's multi-LoRA serving and tenant KV shares against the JAX package's.

Both packages serve the same tiny model (the port's built with
``from_jax_params``) and registries holding the same three adapters, scaled
so that each one steers the greedy tokens. Held exactly, token for token:

- a mixed batch (three adapters and a base-model row), greedy and sampled
  with penalties, equals the JAX engine's streams and the port's solo run of
  each request; so do the chunked-prefill (8-token chunks) and
  prefix-cache-off engines;
- the prefix cache is salted by adapter: the same prompt under two adapters
  and the base model never hits across them, and the ``BlockManager`` state
  equals the JAX engine's;
- admission gates: a tenant over its ``kv_block_share`` is deferred while
  another tenant admits, and adapter-pool pressure defers a request until a
  slot frees (no slot leaked), with the JAX engine's recorder events,
  registry stats and streams;
- over HTTP, one JAX and one port ``ServingServer`` run the same script:
  ``/admin/adapters`` list / load from an exported file / unload, an unknown
  adapter, JSON and SSE completions on adapters, the ``max_inflight`` (429)
  and ``kv_block_share`` quotas; bodies, codes and the ``/metrics`` families
  and tenant/adapter counters agree;
- the ``engine.adapter_load`` fault quarantines only its request on the port
  server, leaves the loop running (not a device fault) and leaks no slot.

The module builds one JAX engine (its programs compile once), which the
HTTP cases serve from at the end, as the port's engine does.
"""

import contextlib
import http.client
import json
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.observability.flight_recorder import RECORDER as J_RECORDER
from paddlenlp_tpu.serving import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.serving import SchedulerConfig as JSchedulerConfig
from paddlenlp_tpu.serving import ServingServer as JServingServer
from paddlenlp_tpu.serving.tenancy import AdapterRegistry as JAdapterRegistry
from paddlenlp_tpu.serving.tenancy import TenantQuotas as JTenantQuotas
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.observability.flight_recorder import RECORDER
from paddlenlp_tpu_torch.serving import MetricsRegistry, SchedulerConfig, ServingServer
from paddlenlp_tpu_torch.serving.engine_loop import is_device_fault
from paddlenlp_tpu_torch.serving.tenancy import AdapterRegistry, TenantQuotas, adapter_dims_from_config
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.utils.faults import FAULTS, InjectedFault
from paddlenlp_tpu_torch.utils.safetensors_io import save_file

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
ENG_KW = dict(max_batch_size=4, block_size=4, num_blocks=128, max_blocks_per_seq=32, decode_steps=4)
ADAPTER_IDS = ("ad-a", "ad-b", "ad-c")
#: 0.02-scale random adapters barely move a tiny model's argmax; at this
#: scaling each one steers the greedy stream away from the base model's
SCALING = 40.0
GEN = 8
#: three adapters and a base-model row; 12-token prompts split into 8-token chunks
JOBS = [([3 + j, 7, 11, 2, 9, 4, 8, 6, 5, 10, 12, 13 + j], aid) for j, aid in enumerate([*ADAPTER_IDS, None])]
SAMPLINGS = {"greedy": dict(max_new_tokens=GEN),
             "sampled_penalties": dict(max_new_tokens=GEN, do_sample=True, temperature=0.8, top_p=0.9, top_k=8,
                                       seed=7, repetition_penalty=1.2, presence_penalty=0.1,
                                       frequency_penalty=0.1)}
TIMEOUT = 120  # seconds for any one HTTP exchange or wait


def adapter_source(cfg, idx, rank=4):
    rng = np.random.default_rng(1000 + idx)
    return {proj: {"A": rng.standard_normal((cfg.num_hidden_layers, d_in, rank)).astype(np.float32) * 0.02,
                   "B": rng.standard_normal((cfg.num_hidden_layers, rank, d_out)).astype(np.float32) * 0.02}
            for proj, (d_in, d_out) in adapter_dims_from_config(cfg).items()}


def make_registry(cls, cfg, ids=ADAPTER_IDS, pool_slots=4):
    reg = cls(config=cfg, max_rank=4, pool_slots=pool_slots)
    for i, aid in enumerate(ids):
        reg.add(aid, adapter_source(cfg, i), scaling=SCALING)
    return reg


def run_jobs(eng, jobs, sampling, tenants=None):
    """Submit every job, then drain: the rows decode batched together."""
    sp = (JSamplingParams if isinstance(eng, JEngine) else SamplingParams)(**sampling)
    ids = [eng.add_request(list(p), sp, adapter_id=aid, **({} if tenants is None else {"tenant": tenants[i]}))
           for i, (p, aid) in enumerate(jobs)]
    done = {}
    while eng.has_work():
        for req in eng.step():
            done[req.req_id] = req
    return [list(map(int, done[i].output_ids)) for i in ids]


def mgr_state(m):
    return dict(free=list(m.free), tables={k: list(v) for k, v in m.tables.items()}, lengths=dict(m.lengths),
                ref=dict(m.ref), index=dict(m._index), block_hash=dict(m._block_hash), lru=list(m._lru),
                counters=(m.cache_hits, m.cached_tokens_total, m.evictions, m.num_free, m.num_cached_blocks))


def assert_no_slot_leak(reg):
    st = reg.stats()
    assert st["pinned"] == 0 and st["free_slots"] + st["resident"] == st["pool_slots"], st


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while this module runs:
    under the suite's parallel workers a thread pool's wake-ups cost more
    than the ops (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def engines(models):
    """(JAX engine, port engine), monolithic prefill, over fresh registries:
    the one JAX engine of the module (its programs compile once), which the
    HTTP cases at the end serve from."""
    jm, pm = models
    return (JEngine(jm, adapter_registry=make_registry(JAdapterRegistry, jm.config), **ENG_KW),
            InferenceEngine(pm, adapter_registry=make_registry(AdapterRegistry, pm.config), **ENG_KW))


@pytest.fixture(scope="module")
def jax_streams(engines):
    """The JAX engine's streams of JOBS per sampling, computed once."""
    cache = {}

    def get(sampling):
        if sampling not in cache:
            cache[sampling] = run_jobs(engines[0], JOBS, SAMPLINGS[sampling])
        return cache[sampling]

    return get


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_mixed_batch_matches_jax_and_solo(models, engines, jax_streams, sampling):
    want = jax_streams(sampling)
    got = run_jobs(engines[1], JOBS, SAMPLINGS[sampling])
    assert got == want
    pm = models[1]
    for job, stream in zip(JOBS, got):
        solo = InferenceEngine(pm, adapter_registry=make_registry(AdapterRegistry, pm.config), **ENG_KW)
        assert run_jobs(solo, [job], SAMPLINGS[sampling]) == [stream], job[1]
    if sampling == "greedy":
        assert len({tuple(s) for s in got}) == len(JOBS), "an adapter served the base model's tokens"


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("cell", [dict(prefill_chunk_tokens=8),
                                  dict(prefill_chunk_tokens=8, enable_prefix_cache=False)],
                         ids=["chunked", "chunked_nocache"])
def test_chunked_and_cache_off_cells_match(models, jax_streams, cell, sampling):
    """The port's chunked engines against the JAX engine's monolithic
    streams (the JAX package holds its own chunked cell to those,
    ``tests/serving/test_multi_lora.py``)."""
    pm = models[1]
    eng = InferenceEngine(pm, adapter_registry=make_registry(AdapterRegistry, pm.config), **ENG_KW, **cell)
    assert run_jobs(eng, JOBS, SAMPLINGS[sampling]) == jax_streams(sampling)


def test_prefix_cache_salted_by_adapter(engines):
    """Same prompt: ad-a, base, ad-b, then ad-a again. Only the last run hits
    the cache (on ad-a's own blocks), and the allocator's state equals the
    JAX engine's after every run."""
    je, pe = engines
    prompt = list(range(30, 42))  # 3 full blocks, a prompt no earlier case served
    hits = {}
    for eng in (je, pe):
        h0, seen = eng.mgr.cache_hits, []
        for aid in ("ad-a", None, "ad-b", "ad-a"):
            out = run_jobs(eng, [(prompt, aid)], SAMPLINGS["greedy"])[0]
            seen.append((aid, eng.mgr.cache_hits - h0, out))
        hits[type(eng).__module__.split(".")[0]] = seen
    assert hits["paddlenlp_tpu_torch"] == hits["paddlenlp_tpu"]
    seen = hits["paddlenlp_tpu_torch"]
    assert [h for _a, h, _o in seen] == [0, 0, 0, 1]
    assert seen[3][2] == seen[0][2] and len({tuple(o) for _a, _h, o in seen[:3]}) == 3
    assert mgr_state(pe.mgr) == mgr_state(je.mgr)


def test_speculative_verify_with_adapters_equals_plain_decode(models):
    """n-gram speculation over a mixed batch: the verify forward carries
    each row's adapter (one GEMM a position, the delta too), so greedy
    streams equal the plain decode's with the same adapters."""
    pm = models[1]
    jobs = [([5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6], aid) for aid in ("ad-a", "ad-b", None)]
    outs, spec = [], None
    for use_speculative in (True, False):
        eng = InferenceEngine(pm, adapter_registry=make_registry(AdapterRegistry, pm.config),
                              use_speculative=use_speculative, **ENG_KW)
        outs.append(run_jobs(eng, jobs, dict(max_new_tokens=10)))
        spec = spec or eng.spec_stats
    assert outs[0] == outs[1] and spec["verify_steps"] > 0 and spec["drafted"] > 0


def _events(recorder, names):
    return [(e["name"], e.get("reason")) for e in recorder.to_dicts(recorder.snapshot()) if e["name"] in names]


def test_tenant_kv_share_defers_only_the_capped_tenant(engines):
    """kv_block_share 0.08 of 127 blocks caps "capped" at 10: its running
    request holds 4+ blocks, so its second (8 more) is deferred while the
    request behind it from another tenant admits in the same step; the
    deferred one admits once the first finishes, first in line."""
    jobs = [(list(range(3, 15)), "ad-a"), (list(range(20, 48)), "ad-b"), (list(range(50, 58)), None)]
    tenants = ["capped", "capped", "other"]
    seen = []
    for eng, recorder, quotas in ((engines[0], J_RECORDER, JTenantQuotas), (engines[1], RECORDER, TenantQuotas)):
        eng.tenant_quotas = quotas({"capped": {"kv_block_share": 0.08}})
        recorder.clear()
        try:
            sp = (JSamplingParams if isinstance(eng, JEngine) else SamplingParams)(max_new_tokens=16)
            # the first capped request runs, then the other two arrive
            ids = [eng.add_request(*jobs[0][:1], sp, adapter_id=jobs[0][1], tenant=tenants[0])]
            done = {r.req_id: r for r in eng.step()}
            ids += [eng.add_request(p, sp, adapter_id=a, tenant=t) for (p, a), t in zip(jobs[1:], tenants[1:])]
            done.update((r.req_id, r) for r in eng.step())
            admitted = sorted(r.req_id - ids[0] for r in eng.slots if r is not None)
            waiting = [r.req_id - ids[0] for r in eng.waiting]
            while eng.has_work():
                done.update((r.req_id, r) for r in eng.step())
            streams = [list(map(int, done[i].output_ids)) for i in ids]
            stats = eng.stats()["tenancy"]
        finally:
            eng.tenant_quotas = None
        seen.append((admitted, waiting, _events(recorder, ("admit.defer", "admit.accept")), streams,
                     stats["quotas"], stats["adapters"]))
    assert seen[1] == seen[0]
    admitted, waiting, events, _s, quotas, _a = seen[1]
    assert admitted == [0, 2] and waiting == [1]
    assert ("admit.defer", "tenant_kv_share") in events and quotas["tenants"]["capped"]["kv_block_share"] == 0.08


def test_adapter_pool_pressure_defers_and_leaks_nothing(models):
    """Two pool slots, three adapters and a base row in one batch: the third
    adapter waits (admit.defer reason=adapter_pressure) until a slot's
    request finishes and releases it, then loads into the LRU-evicted slot;
    every stream equals its solo run and no slot leaks (the JAX package's
    pressure case is ``tests/robustness/test_adapter_chaos.py``)."""
    pm = models[1]
    reg = make_registry(AdapterRegistry, pm.config, pool_slots=2)
    RECORDER.clear()
    jobs = [JOBS[0], JOBS[1], (JOBS[2][0], "ad-c"), JOBS[3]]
    streams = run_jobs(InferenceEngine(pm, adapter_registry=reg, **ENG_KW), jobs, dict(max_new_tokens=GEN))
    assert ("admit.defer", "adapter_pressure") in _events(RECORDER, ("admit.defer",))
    assert_no_slot_leak(reg)
    assert reg.stats()["evictions"] >= 1 and "ad-c" in reg.resident()
    for job, stream in zip(jobs, streams):
        solo = InferenceEngine(pm, adapter_registry=make_registry(AdapterRegistry, pm.config), **ENG_KW)
        assert run_jobs(solo, [job], dict(max_new_tokens=GEN)) == [stream], job[1]


# ----------------------------------------------------------------- over HTTP
def request(port, method, path, payload=None):
    """One HTTP exchange: (status, parsed JSON body or raw bytes)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if "json" in resp.getheader("Content-Type", "") and data else data
    finally:
        conn.close()


class Stream(threading.Thread):
    """One SSE completion: its tokens and finish reason; ``first_token`` is
    set once a token arrived."""

    def __init__(self, port, payload):
        super().__init__(daemon=True)
        self.port, self.payload = port, dict(payload, stream=True)
        self.tokens, self.finish, self.error, self.status = [], None, None, None
        self.first_token = threading.Event()

    def run(self):
        try:
            conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
            conn.request("POST", "/v1/completions", body=json.dumps(self.payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            self.status = resp.status
            for line in resp:
                line = line.strip()
                if line == b"data: [DONE]":
                    break
                if not line.startswith(b"data: "):
                    continue
                c = json.loads(line[6:])["choices"][0]
                if c.get("finish_reason"):
                    self.finish = c["finish_reason"]
                if "token" in c:
                    self.tokens.append(c["token"])
                    self.first_token.set()
            conn.close()
        except Exception as e:  # surfaced by the main thread's asserts
            self.error = e
        finally:
            self.first_token.set()

    def result(self):
        self.join(TIMEOUT)
        assert not self.is_alive() and self.error is None, self.error
        return self.status, self.tokens, self.finish


def scrub(doc):
    """A response body without what differs between two runs: ids and times."""
    if isinstance(doc, dict):
        return {k: (None if k == "timing" else scrub(v)) for k, v in doc.items() if k not in ("id", "digest")}
    if isinstance(doc, list):
        return [scrub(v) for v in doc]
    return doc


def metric_families(text):
    """{family: {(sample name, labels)}} from a Prometheus exposition."""
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            out.setdefault(line.split()[2], {})
        elif line and not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            name, _, labels = name_labels.partition("{")
            fam = next((f for f in out if name == f or re.fullmatch(re.escape(f) + r"_(bucket|sum|count|total)", name)),
                       name)
            out.setdefault(fam, {})[(name, labels.rstrip("}"))] = float(value)
    return out


@contextlib.contextmanager
def slow_steps(srv, seconds):
    """Every engine step of ``srv`` takes at least ``seconds``: the long
    streams stay in flight while the quota checks run."""
    eng = srv.loop.engine
    real_step = eng.step

    def step():
        time.sleep(seconds)
        return real_step()

    eng.step = step
    try:
        yield
    finally:
        del eng.step


def wait_for(cond, what):
    deadline = time.time() + TIMEOUT
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.005)


def run_script(srv, port, recorder, adapter_file):
    seen = {"list": request(port, "POST", "/admin/adapters", {"op": "list"}),
            "unknown": request(port, "POST", "/v1/completions",
                               {"prompt": [5, 6, 7], "max_tokens": 2, "adapter_id": "nope"}),
            "load": request(port, "POST", "/admin/adapters",
                            {"op": "load", "adapter_id": "ad-new", "path": adapter_file}),
            "json": request(port, "POST", "/v1/completions",
                            {"prompt": [5, 6, 7, 8], "max_tokens": 8, "adapter_id": "ad-new", "tenant": "acme"}),
            "sse": Stream(port, {"prompt": [9, 10, 11], "max_tokens": 8, "adapter_id": "ad-b",
                                 "tenant": "globex"})}
    seen["sse"].start()
    seen["sse"] = seen["sse"].result()
    seen["unload"] = request(port, "POST", "/admin/adapters", {"op": "unload", "adapter_id": "ad-new"})
    seen["unload_again"] = request(port, "POST", "/admin/adapters", {"op": "unload", "adapter_id": "ad-new"})
    recorder.clear()
    with slow_steps(srv, 0.03):
        # two long streams: "capped" (kv_block_share) and "acme" (max_inflight 1)
        longs = [Stream(port, {"prompt": list(range(3, 15)), "max_tokens": 100, "adapter_id": "ad-a",
                               "tenant": "capped"}),
                 Stream(port, {"prompt": [40, 41, 42], "max_tokens": 100, "tenant": "acme"})]
        for s in longs:
            s.start()
        for s in longs:
            assert s.first_token.wait(TIMEOUT)
        capped2 = Stream(port, {"prompt": list(range(20, 48)), "max_tokens": 4, "tenant": "capped"})
        capped2.start()
        wait_for(lambda: ("admit.defer", "tenant_kv_share") in _events(recorder, ("admit.defer",)),
                 "the second capped request was never deferred")
        seen["acme_over_quota"] = request(port, "POST", "/v1/completions",
                                          {"prompt": [8, 9], "max_tokens": 2, "tenant": "acme"})
        seen["globex_meanwhile"] = request(port, "POST", "/v1/completions",
                                           {"prompt": [8, 9], "max_tokens": 2, "tenant": "globex"})
        seen["capped_waits"] = capped2.is_alive() and all(s.is_alive() for s in longs)
    seen["longs"] = [s.result() for s in longs]
    seen["capped2"] = capped2.result()
    seen["metrics"] = request(port, "GET", "/metrics")[1].decode()
    seen["health"] = request(port, "GET", "/health")
    return seen


@pytest.fixture(scope="module")
def servers(models, engines, tmp_path_factory):
    """(JAX server, port server) over the module's engines, with tenant
    quotas set on both engines and servers, their ports, and the scripted
    run of each."""
    jm, pm = models
    path = str(tmp_path_factory.mktemp("adapters") / "ad-new.safetensors")
    src = adapter_source(pm.config, 9)
    save_file({f"{proj}.lora_{part}": w[part] for proj, w in src.items() for part in ("A", "B")}, path,
              metadata={"format": "np", "scaling": str(SCALING)})
    quotas = {"acme": {"max_inflight": 1}, "capped": {"kv_block_share": 0.08}}
    sched = dict(max_inflight=8, default_timeout_s=TIMEOUT)
    je, pe = engines
    je.tenant_quotas, pe.tenant_quotas = JTenantQuotas(quotas), TenantQuotas(quotas)
    js = JServingServer(je, registry=JMetricsRegistry(), scheduler_config=JSchedulerConfig(**sched),
                        tenant_quotas=JTenantQuotas(quotas))
    ps = ServingServer(pe, registry=MetricsRegistry(), scheduler_config=SchedulerConfig(**sched),
                       tenant_quotas=TenantQuotas(quotas))
    ports = (js.start_in_thread(), ps.start_in_thread())
    try:
        scripted = {key: run_script(srv, port, recorder, path)
                    for key, srv, port, recorder in (("jax", js, ports[0], J_RECORDER), ("port", ps, ports[1], RECORDER))}
        yield (js, ps), ports, scripted
    finally:
        FAULTS.reset()
        for srv in (js, ps):
            srv.shutdown(drain_timeout_s=10)


def test_http_bodies_and_codes_match(servers):
    j, p = servers[2]["jax"], servers[2]["port"]
    for key in ("list", "unknown", "load", "json", "unload", "unload_again", "acme_over_quota",
                "globex_meanwhile"):
        assert p[key][0] == j[key][0] and scrub(p[key][1]) == scrub(j[key][1]), key
    assert [p[k] for k in ("sse", "longs", "capped2", "capped_waits")] == \
        [j[k] for k in ("sse", "longs", "capped2", "capped_waits")]
    assert p["list"][1]["adapters"] == sorted(ADAPTER_IDS)
    # the door check answers before anything is admitted, naming the registered ids
    assert p["unknown"][0] == 400 and p["unknown"][1]["error"]["type"] == "invalid_request"
    assert "unknown adapter_id 'nope'" in p["unknown"][1]["error"]["message"]
    assert "ad-a" in p["unknown"][1]["error"]["message"]
    assert p["load"][0] == 200 and "ad-new" in p["load"][1]["adapters"] and p["load"][1]["digest"]
    assert p["unload"][0] == 200 and p["unload_again"][0] == 404
    assert p["acme_over_quota"][0] == 429 and p["acme_over_quota"][1]["error"]["type"] == "rate_limit_exceeded"
    assert p["globex_meanwhile"][0] == 200 and p["capped_waits"]
    assert [s[0] for s in p["longs"] + [p["capped2"]]] == [200] * 3


def test_http_adapter_streams_equal_in_process(models, servers):
    """The hot-loaded adapter's JSON completion and the SSE stream on ad-b are
    the tokens of an in-process port engine with the same adapters."""
    pm = models[1]
    reg = make_registry(AdapterRegistry, pm.config)
    reg.add("ad-new", adapter_source(pm.config, 9), scaling=SCALING)
    eng = InferenceEngine(pm, adapter_registry=reg, **ENG_KW)
    want = run_jobs(eng, [([5, 6, 7, 8], "ad-new"), ([9, 10, 11], "ad-b")], dict(max_new_tokens=8))
    p = servers[2]["port"]
    assert [p["json"][1]["choices"][0]["token_ids"], p["sse"][1]] == want


def test_http_metrics_and_health_match(servers):
    j, p = servers[2]["jax"], servers[2]["port"]
    jf, pf = metric_families(j["metrics"]), metric_families(p["metrics"])
    assert set(pf) == set(jf)
    compile_fams = ("paddlenlp_serving_compiles_total", "paddlenlp_serving_compile_seconds_total")
    for fam in set(jf) - set(compile_fams):
        assert set(pf[fam]) == set(jf[fam]), fam
    for fam in ("paddlenlp_serving_requests_total", "paddlenlp_serving_requests_shed_total",
                "paddlenlp_serving_tokens_generated_total", "paddlenlp_serving_usage_tokens_total",
                "paddlenlp_serving_usage_records_total"):
        assert pf[fam] == jf[fam], fam
    text = p["metrics"]
    assert 'paddlenlp_serving_requests_shed_total{reason="tenant_quota",priority="interactive",tenant="acme"}' in text
    assert any('adapter="ad-new"' in k[1] for k in pf["paddlenlp_serving_usage_tokens_total"])
    assert p["health"][0] == j["health"][0] == 200
    jt, pt = j["health"][1]["engine"]["tenancy"], p["health"][1]["engine"]["tenancy"]
    assert set(pt) == set(jt) == {"tenants", "adapters", "quotas"} and pt["quotas"] == jt["quotas"]
    assert pt["adapters"] == jt["adapters"] and pt["tenants"] == jt["tenants"]


def test_adapter_load_fault_quarantines_only_its_request(models, servers):
    """A poisoned hot-load of a non-resident adapter ends only the request
    that asked for it (engine_error, max_retries 0); a stream on a resident
    adapter and a base-model stream decode on, token-exact; the slot is not
    leaked, the loop stays running (an injected load fault is no device
    fault) and the same request then loads and finishes token-exact."""
    pm = models[1]
    srv, port = servers[0][1], servers[1][1]
    src = adapter_source(pm.config, 11)
    assert request(port, "POST", "/admin/adapters", {"op": "load", "adapter_id": "ad-x", "weights": {
        proj: {part: w[part].tolist() for part in ("A", "B")} for proj, w in src.items()},
        "scaling": SCALING})[0] == 200
    n = 24
    bystanders = [Stream(port, {"prompt": [5, 6, 7], "max_tokens": n, "adapter_id": "ad-b", "tenant": "globex"}),
                  Stream(port, {"prompt": [8, 9, 10], "max_tokens": n, "tenant": "base"})]
    with slow_steps(srv, 0.02):
        for s in bystanders:
            s.start()
        for s in bystanders:
            assert s.first_token.wait(TIMEOUT)
        FAULTS.arm("engine.adapter_load", nth=1)
        try:
            victim = Stream(port, {"prompt": [11, 12, 13], "max_tokens": n, "adapter_id": "ad-x", "tenant": "acme",
                                   "max_retries": 0})
            victim.start()
            status, tokens, finish = victim.result()
            assert FAULTS.fired("engine.adapter_load") == 1
        finally:
            FAULTS.reset()
    assert status == 200 and finish == "engine_error" and len(tokens) < n
    for s in bystanders:
        assert s.result()[1:] == (s.tokens, "length") and len(s.tokens) == n
    assert srv.loop.state == "running" and not is_device_fault(InjectedFault("engine.adapter_load", 1))
    text = request(port, "GET", "/metrics")[1].decode()
    assert 'paddlenlp_serving_requests_total{status="engine_error",priority="interactive",tenant="acme"}' in text
    assert re.search(r"paddlenlp_serving_slot_quarantines_total [1-9]", text)
    assert not re.search(r"paddlenlp_serving_engine_restarts_total [1-9]", text)
    retry = Stream(port, {"prompt": [11, 12, 13], "max_tokens": n, "adapter_id": "ad-x", "tenant": "acme"})
    retry.start()
    assert retry.result()[0] == 200 and retry.finish == "length"
    reg = make_registry(AdapterRegistry, pm.config)
    reg.add("ad-x", src, scaling=SCALING)
    want = run_jobs(InferenceEngine(pm, adapter_registry=reg, **ENG_KW),
                    [([11, 12, 13], "ad-x"), ([5, 6, 7], "ad-b")], dict(max_new_tokens=n))
    assert [retry.tokens, bystanders[0].tokens] == want
    assert_no_slot_leak(srv.loop.engine.adapter_registry)
