"""The port's predictor and its HTTP servers against the JAX package.

The fixture of ``tests/llm/test_predictor.py`` (a tiny LLaMA and a
``WordLevel`` tokenizer saved by the JAX package) goes through
``create_predictor`` of both packages, loaded from disk (fp32, on the CPU),
and the port is held to the JAX package exactly:

- ``EagerPredictor`` (``generate``) and ``BlockPredictor`` (the paged engine)
  texts, and the block predictor's ``stream_predict`` pieces;
- ``flask_server``'s ``POST /generate`` JSON and SSE bodies and ``/health``;
- ``serve_v1``: ``/v1/completions`` on a **string** prompt and
  ``/v1/chat/completions`` on messages (through the predictor's tokenizer),
  bodies equal but for ids and times;
- the unknown mode's error; ``mesh_shape``/``disagg_stages`` raise naming
  ROADMAP Queue 1 item 12b; ``lora_path``, ``weight_quantize_algo`` and
  ``cachekv_int8_type`` reach the engine.
One JAX predictor of each mode serves the whole file.
"""

import json
import os
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import PretrainedTokenizer as JTokenizer
from paddlenlp_tpu_torch.llm.predict import flask_server, predictor
from paddlenlp_tpu_torch.serving import api as port_api

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "llm", "predict"))
TEXTS = ["alpha beta gamma", "delta epsilon", "zeta eta theta alpha alpha"]


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("PDNLP_TPU_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    d = tmp_path_factory.mktemp("predict-model")
    cfg = JLlamaConfig(vocab_size=32, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=128,
                       eos_token_id=2, pad_token_id=0)
    JLlama.from_config(cfg, seed=0).save_pretrained(str(d))
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for i, w in enumerate("alpha beta gamma delta epsilon zeta eta theta".split()):
        vocab[w] = i + 4
    t = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = Whitespace()
    JTokenizer(tokenizer_object=t, pad_token="<pad>", bos_token="<s>", eos_token="</s>",
               unk_token="<unk>").save_pretrained(str(d))
    return str(d)


def _kw(model_dir, **kw):
    defaults = dict(model_name_or_path=model_dir, dtype="float32", max_length=8, batch_size=2,
                    decode_strategy="greedy_search", num_kv_blocks=64, block_size=4, max_blocks_per_seq=16)
    defaults.update(kw)
    return defaults


@pytest.fixture(scope="module")
def pair(model_dir):
    """{mode: (JAX predictor, port predictor)}."""
    import predictor as jpredictor  # llm/predict/predictor.py of the JAX package

    out = {}
    for mode in ("eager", "block"):
        out[mode] = (jpredictor.create_predictor(jpredictor.PredictorArgument(**_kw(model_dir, mode=mode))),
                     predictor.create_predictor(predictor.PredictorArgument(**_kw(model_dir, mode=mode)),
                                                device="cpu"))
    return out


def test_argument_fields_match_jax():
    import dataclasses

    import predictor as jpredictor

    want = {f.name: f.default for f in dataclasses.fields(jpredictor.PredictorArgument)}
    got = {f.name: f.default for f in dataclasses.fields(predictor.PredictorArgument)}
    assert got == want


@pytest.mark.parametrize("mode", ["eager", "block"])
def test_predict_texts_match_jax(pair, mode):
    j, p = pair[mode]
    assert p.model.param_dtype == torch.float32 and p.model.device.type == "cpu"
    got, want = p.predict(TEXTS[:2]), j.predict(TEXTS[:2])
    assert got == want and all(isinstance(t, str) for t in got)
    assert p.predict(TEXTS[2:]) == j.predict(TEXTS[2:])


def test_eager_and_block_agree(pair):
    assert pair["eager"][1].predict(TEXTS[:2]) == pair["block"][1].predict(TEXTS[:2])


def test_stream_predict_matches_jax(pair):
    j, p = pair["block"]
    for text in TEXTS:
        pieces = list(p.stream_predict(text))
        assert pieces == list(j.stream_predict(text))
        assert "".join(pieces) == p.predict([text])[0]


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def _post(port, path, payload, raw=False):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _legacy_script(port):
    out = {}
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=30) as r:
        out["health"] = (r.status, r.read().decode())
    for i, text in enumerate(TEXTS):
        out[f"json{i}"] = _post(port, "/generate", {"src": text})
        out[f"sse{i}"] = _post(port, "/generate", {"src": text, "stream": True})
    out["short"] = _post(port, "/generate", {"src": TEXTS[0], "max_length": 3})
    out["bad"] = _post(port, "/generate", {"text": "no src"})
    return out


def test_legacy_http_bodies_match_jax(pair):
    import flask_server as jflask  # llm/predict/flask_server.py of the JAX package

    bodies = {}
    for who, mod, pred in (("jax", jflask, pair["block"][0]), ("port", flask_server, pair["block"][1])):
        max_length = pred.args.max_length
        server = _serve(mod.make_handler(pred, threading.Lock()))
        try:
            bodies[who] = _legacy_script(server.server_address[1])
        finally:
            server.shutdown()
            pred.args.max_length = max_length
    assert bodies["port"] == bodies["jax"]
    got = bodies["port"]
    assert got["bad"][0] == 400 and got["health"] == (200, '{"status": "ok"}')
    pieces = [json.loads(line[6:])["token"] for line in got["sse0"][1].splitlines()
              if line.startswith("data:") and "[DONE]" not in line]
    assert "".join(pieces) == json.loads(got["json0"][1])["output"] == pair["block"][1].predict(TEXTS[:1])[0]


def _scrub(doc):
    if isinstance(doc, dict):
        return {k: _scrub(v) for k, v in doc.items() if k not in ("id", "created", "timing", "system_fingerprint")}
    if isinstance(doc, list):
        return [_scrub(v) for v in doc]
    return doc


def test_serve_v1_string_prompts_match_jax(pair, monkeypatch):
    """``serve_v1`` (``ServingServer.run`` swapped for ``start_in_thread`` on
    an ephemeral port): string prompts and chat messages reach the engine
    through the predictor's tokenizer."""
    import flask_server as jflask
    from paddlenlp_tpu.serving import api as jax_api

    bodies = {}
    for who, mod, api, pred in (("jax", jflask, jax_api, pair["block"][0]),
                                ("port", flask_server, port_api, pair["block"][1])):
        servers = []

        def run(self, host="0.0.0.0", port=8011):
            servers.append((self, self.start_in_thread(host="127.0.0.1", port=0)))

        monkeypatch.setattr(api.ServingServer, "run", run)
        mod.serve_v1(pred, port=0)
        srv, port = servers[0]
        try:
            out = {}
            for i, text in enumerate(TEXTS):
                status, body = _post(port, "/v1/completions", {"prompt": text, "max_tokens": 6})
                out[f"text{i}"] = (status, _scrub(json.loads(body)))
            status, body = _post(port, "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "alpha beta"}], "max_tokens": 4})
            out["chat"] = (status, _scrub(json.loads(body)))
            bodies[who] = out
        finally:
            srv.shutdown(drain_timeout_s=10)
    assert bodies["port"] == bodies["jax"]
    p = pair["block"][1]
    status, body = bodies["port"]["text0"]
    want = p.engine.generate([p.tokenizer.encode(TEXTS[0])], type(p._sampling)(max_new_tokens=6))[0]
    assert status == 200 and body["choices"][0]["token_ids"] == want
    assert bodies["port"]["chat"][0] == 200


def test_serve_v1_releases_the_engine_after_shutdown(model_dir, monkeypatch):
    """After ``serve_v1``'s server shuts down and its caller lets go of the
    predictor, nothing holds the engine (or the model's weights): the
    server's metrics live in a registry of its own, not in the process-wide
    one, whose pull gauges would keep the engine alive."""
    import gc
    import weakref

    pred = predictor.create_predictor(predictor.PredictorArgument(**_kw(model_dir, mode="block")), device="cpu")
    servers = []
    monkeypatch.setattr(port_api.ServingServer, "run", lambda self, host="0.0.0.0", port=8011: servers.append(
        (self, self.start_in_thread(host="127.0.0.1", port=0))))
    flask_server.serve_v1(pred, port=0)
    srv, port = servers.pop()
    assert srv.registry is not port_api.REGISTRY
    status, _ = _post(port, "/v1/completions", {"prompt": TEXTS[0], "max_tokens": 2})
    assert status == 200
    srv.shutdown(drain_timeout_s=10)
    engine = weakref.ref(pred.engine)
    del pred, srv
    gc.collect()
    assert engine() is None


def test_v1_needs_the_block_predictor(pair):
    with pytest.raises(ValueError, match="--mode block"):
        flask_server.serve_v1(pair["eager"][1], port=0)


def test_errors_match_jax(model_dir):
    import predictor as jpredictor

    for who, mod, kw in (("jax", jpredictor, {}), ("port", predictor, {"device": "cpu"})):
        with pytest.raises(ValueError, match="unknown predictor mode 'static'"):
            mod.create_predictor(mod.PredictorArgument(**_kw(model_dir, mode="static")), **kw)
        with pytest.raises(ValueError, match="--mesh_shape must be"):
            mod.create_predictor(mod.PredictorArgument(**_kw(model_dir, mesh_shape="0,2")), **kw)
        with pytest.raises(ValueError, match="cachekv_int8_type='static' unsupported"):
            mod.create_predictor(mod.PredictorArgument(**_kw(model_dir, cachekv_int8_type="static")), **kw)
    for field, value in (("mesh_shape", "1,2"), ("disagg_stages", "1,1")):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12b"):
            predictor.create_predictor(predictor.PredictorArgument(**_kw(model_dir, **{field: value})), device="cpu")


def test_engine_options_reach_the_engine(model_dir, pair, tmp_path):
    from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel
    from paddlenlp_tpu_torch.quantization import QuantizedModel

    p = predictor.create_predictor(predictor.PredictorArgument(**_kw(
        model_dir, cachekv_int8_type="dynamic", weight_quantize_algo="wint8", prefill_chunk_tokens=4,
        enable_prefix_cache=False, speculate_method="ngram")), device="cpu")
    assert isinstance(p.model, QuantizedModel) and p.engine.pool.kv.dtype == torch.int8
    assert not p.engine.enable_prefix_cache and p.engine.prefill_chunk_tokens == 4 and p.engine.use_speculative
    assert all(isinstance(t, str) for t in p.predict(TEXTS[:2]))
    # lora_path merges the adapter into the base weights
    base = pair["block"][1].model
    lora = LoRAModel(base, LoRAConfig(r=2, lora_alpha=4, target_modules=[".*q_proj.*"]))
    lora.save_pretrained(str(tmp_path / "adapter"))
    merged = predictor.create_predictor(predictor.PredictorArgument(**_kw(model_dir, lora_path=str(
        tmp_path / "adapter"))), device="cpu").model
    ids = torch.tensor([[4, 5, 6, 7]])
    torch.testing.assert_close(merged(ids), lora.merge_and_unload()(ids), rtol=0, atol=0)


def test_main_writes_outputs(model_dir, tmp_path, pair):
    data = tmp_path / "in.jsonl"
    data.write_text("".join(json.dumps({"src": t}) + "\n" for t in TEXTS))
    out = tmp_path / "out.jsonl"
    args = _kw(model_dir, data_file=str(data), output_file=str(out))
    predictor.main([x for k, v in args.items() for x in (f"--{k}", str(v))], device="cpu")
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["src"] for r in rows] == TEXTS
    assert [r["output"] for r in rows] == pair["block"][1].predict(TEXTS[:2]) + pair["block"][1].predict(TEXTS[2:])
    stats = predictor.benchmark(pair["block"][1], TEXTS, warmup=0, iters=1)
    assert set(stats) == {"output_tokens_per_second", "latency_s"} and np.isfinite(stats["latency_s"])
