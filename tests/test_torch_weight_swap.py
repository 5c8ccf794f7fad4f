"""Live weight hot-swap (``POST /admin/weights``): the port's server against
the JAX package's.

A committed checkpoint is written by the JAX package's own save path
(``save_unified_checkpoint``). One JAX and one port server, both serving the
seed-0 weights, go through the same script: a torn (uncommitted) checkpoint
and a dimension mismatch answer 409 with the engine untouched; a swap whose
canary digest cannot match rolls back; the real swap installs the new
weights with the same canary digest on both; afterwards the streams match
and no prefix block from before the swap serves a request. A port-only test
holds the paged model's per-layer views to ``sync_params``.
"""

import http.client
import json
import shutil

import jax
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.serving import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.serving import SchedulerConfig as JSchedulerConfig
from paddlenlp_tpu.serving import ServingServer as JServingServer
from paddlenlp_tpu.trainer.unified_checkpoint import save_unified_checkpoint
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.serving import MetricsRegistry, SchedulerConfig, ServingServer
from paddlenlp_tpu_torch.serving.engine_loop import CANARY_PROMPT_IDS, canary_digest
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
ENG_KW = dict(max_batch_size=4, block_size=4, num_blocks=128, max_blocks_per_seq=32, decode_steps=4)
TIMEOUT = 60
SHARED = list(range(5, 17))  # 3 full blocks: registered in the prefix cache by the first request
OTHER = [40, 41, 42, 43, 44, 45, 46]


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    cfg = JLlamaConfig(use_scan_layers=True, **MODEL_KW)
    save_unified_checkpoint(str(root / "v1"), JLlama.from_config(cfg, seed=1), None)
    shutil.copytree(root / "v1", root / "torn")
    (root / "torn" / "commit.json").unlink()
    narrow = JLlamaConfig(use_scan_layers=True, **dict(MODEL_KW, hidden_size=32, intermediate_size=64))
    save_unified_checkpoint(str(root / "narrow"), JLlama.from_config(narrow, seed=0), None)
    return root


def post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=json.dumps(payload), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if resp.getheader("Content-Type", "").endswith("json") else data.decode()
    finally:
        conn.close()


def sse_tokens(port, prompt, max_tokens):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps({"prompt": prompt, "max_tokens": max_tokens,
                                                                 "stream": True}))
        resp = conn.getresponse()
        toks, final = [], None
        for line in resp:
            line = line.strip()
            if line == b"data: [DONE]":
                return toks, final
            if line.startswith(b"data: "):
                c = json.loads(line[6:])["choices"][0]
                if "token" in c:
                    toks.append(c["token"])
                else:
                    final = c["finish_reason"]
        raise AssertionError("stream closed without [DONE]")
    finally:
        conn.close()


def scrub(doc):
    return {k: v for k, v in doc.items() if k != "wall_s"}


def run_script(srv, port, ckpts):
    seen = {}
    complete = lambda prompt, n=6: post(port, "/v1/completions", {"prompt": prompt, "max_tokens": n})[1]  # noqa: E731
    seen["pre_shared"] = complete(SHARED)
    seen["pre_other"] = complete(OTHER)
    params0 = srv.loop.engine.model.params
    for key, payload in (("torn", {"ckpt_dir": str(ckpts / "torn")}),
                         ("narrow", {"ckpt_dir": str(ckpts / "narrow")}),
                         ("missing", {"version": "v9"}),
                         ("canary_mismatch", {"ckpt_dir": str(ckpts / "v1"), "version": "v1",
                                              "canary_digest": "0" * 64, "timeout_s": TIMEOUT})):
        status, body = post(port, "/admin/weights", payload)
        seen[key] = (status, scrub(body), srv.loop.engine.model.params is params0, srv.loop.weights_version)
    seen["after_rollback"] = complete(OTHER)
    seen["swap"] = post(port, "/admin/weights", {"ckpt_dir": str(ckpts / "v1"), "version": "v1",
                                                 "timeout_s": TIMEOUT})
    seen["swapped_params"] = srv.loop.engine.model.params is not params0
    seen["post_shared"] = complete(SHARED)
    seen["post_other_sse"] = sse_tokens(port, OTHER, 8)
    seen["health_version"] = get(port, "/health")[1]["weights_version"]
    seen["weights_info"] = sorted(line for line in get(port, "/metrics")[1].splitlines()
                                  if line.startswith("paddlenlp_serving_weights_info"))
    return seen


@pytest.fixture(scope="module")
def swapped(ckpts):
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    js = JServingServer(JEngine(jm, **ENG_KW), registry=JMetricsRegistry(),
                        scheduler_config=JSchedulerConfig(default_timeout_s=TIMEOUT))
    ps = ServingServer(InferenceEngine(pm, **ENG_KW), registry=MetricsRegistry(),
                       scheduler_config=SchedulerConfig(default_timeout_s=TIMEOUT))
    try:
        out = {}
        for key, srv in (("jax", js), ("port", ps)):
            out[key] = run_script(srv, srv.start_in_thread(), ckpts)
        yield out
    finally:
        for srv in (js, ps):
            srv.shutdown(drain_timeout_s=10)
        assert not js.loop.running and not ps.loop.running


def test_swap_installs_with_the_same_canary_digest(swapped):
    j, p = swapped["jax"], swapped["port"]
    (pstat, pbody), (jstat, jbody) = p["swap"], j["swap"]
    assert pstat == 200 == jstat and pbody["ok"] is True
    assert pbody["canary_digest"] == jbody["canary_digest"]
    assert scrub(pbody) == scrub(jbody)
    assert p["swapped_params"] and p["health_version"] == "v1" == j["health_version"]
    assert p["weights_info"] == j["weights_info"] and len(p["weights_info"]) == 1
    assert p["weights_info"][0].startswith('paddlenlp_serving_weights_info{version="v1"} 1')


def test_streams_after_the_swap_match(swapped):
    j, p = swapped["jax"], swapped["port"]
    for key in ("post_shared", "post_other_sse"):
        assert p[key] == j[key] if key.endswith("sse") else \
            (p[key]["choices"], p[key]["usage"]) == (j[key]["choices"], j[key]["usage"])
    assert p["post_other_sse"][1] == "length" and len(p["post_other_sse"][0]) == 8
    # the new weights change the stream
    assert p["post_shared"]["choices"][0]["token_ids"] != p["pre_shared"]["choices"][0]["token_ids"]


def test_pre_swap_prefix_blocks_never_serve_after_the_swap(swapped):
    p = swapped["port"]
    assert p["pre_shared"]["usage"]["cached_tokens"] == 0
    assert p["after_rollback"]["usage"]["cached_tokens"] == 0  # the rollback cleared the cache too
    assert p["post_shared"]["usage"]["cached_tokens"] == 0
    assert swapped["jax"]["post_shared"]["usage"]["cached_tokens"] == 0


def test_post_swap_stream_matches_a_fresh_engine_on_the_checkpoint(swapped, ckpts):
    fresh = InferenceEngine(LlamaForCausalLM.from_pretrained(str(ckpts / "v1"), device="cpu", dtype=torch.float32),
                            **ENG_KW)
    want = fresh.generate([SHARED], SamplingParams(max_new_tokens=6))[0]
    assert swapped["port"]["post_shared"]["choices"][0]["token_ids"] == want
    assert swapped["port"]["swap"][1]["canary_digest"] == canary_digest(
        fresh.generate([list(CANARY_PROMPT_IDS)], SamplingParams(max_new_tokens=64))[0])


@pytest.mark.parametrize("key", ["torn", "narrow", "missing"])
def test_conflicts_leave_the_engine_untouched(swapped, key):
    j, p = swapped["jax"], swapped["port"]
    status, body, untouched, version = p[key]
    assert status == (400 if key == "missing" else 409) and untouched and version == "v0"
    assert p[key] == j[key]


def test_canary_mismatch_rolls_back(swapped):
    j, p = swapped["jax"], swapped["port"]
    status, body, untouched, version = p["canary_mismatch"]
    assert status == 409 and body["rolled_back"] is True and body["reason"] == "canary_mismatch"
    assert untouched and version == "v0"
    assert p["canary_mismatch"] == j["canary_mismatch"]
    # after the rollback the replica serves the old weights, token for token
    assert p["after_rollback"]["choices"] == p["pre_other"]["choices"]


def test_paged_layers_follow_sync_params():
    """``sync_params`` must rebuild ``PagedInferenceModel._layers``: the
    per-layer views cached at construction would otherwise keep serving the
    old tree's layers (only the embedding, final norm and head are read from
    ``model.params`` on every call)."""
    old = LlamaForCausalLM.init_random(LlamaConfig(**MODEL_KW), seed=0, device="cpu", dtype=torch.float32)
    new = LlamaForCausalLM.init_random(LlamaConfig(**MODEL_KW), seed=1, device="cpu", dtype=torch.float32)
    sp = SamplingParams(max_new_tokens=8)
    eng = InferenceEngine(old, **ENG_KW)
    before = eng.generate([SHARED], sp)[0]
    eng.sync_params(new.params)
    eng.clear_prefix_cache()
    assert eng.infer._layers[0]["self_attn"]["q_proj"]["kernel"].data_ptr() == \
        new.params["model"]["layers"]["self_attn"]["q_proj"]["kernel"][0].data_ptr()
    got = eng.generate([SHARED], sp)[0]
    want = InferenceEngine(new, **ENG_KW).generate([SHARED], sp)[0]
    assert got == want != before
