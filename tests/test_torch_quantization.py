"""The port's quantization package and quantized serving against the JAX package's.

Both packages hold the same tiny Qwen2 model (the JAX tests' tiny config,
``tests/utils/test_quantization_depth.py``: 2 layers, hidden 64, FFN 112, GQA
4/2, vocab 96, stacked layout; Qwen2 adds q/k/v biases, so the bias order of
the a8w8 and weight-only products matters), the port's built with
``from_jax_params``. Held bit for bit:

- ``quantize_params`` for wint8, wint4, fp8 and a8w8, the skip rules and
  ``quant_target_modules``; int4 packing and unpacking; fp8 codes over a grid
  of ties and values near +-448; ``dequantize_leaf``; ``int8_linear`` with
  dynamic and static scales, a bias, fp32 and bf16 outputs; ``fold_act_scales``;
  ``memory_footprint``;
- engine token streams over the same quantized tree, greedy and seeded
  sampling, for each algorithm: wint8 under n-gram speculation, wint4 with
  chunked prefill, fp8 over an int8 KV pool, a8w8 with a LoRA adapter on one
  row;
- over HTTP, one JAX and one port ``ServingServer`` over the a8w8 engines:
  JSON bodies and SSE streams.

Within a stated tolerance (two fp32 forwards, differing in summation order):
``collect_act_scales`` (rel 1e-5) and ``QuantizedModel``'s dense logits
(see ``test_quantized_model_dense_logits``).
"""

import http.client
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.quantization import QuantizationConfig as JQuantizationConfig
from paddlenlp_tpu.quantization import QuantizedModel as JQuantizedModel
from paddlenlp_tpu.quantization import a8w8 as ja8w8
from paddlenlp_tpu.quantization import quantization_utils as jqu
from paddlenlp_tpu.serving import MetricsRegistry as JMetricsRegistry
from paddlenlp_tpu.serving import SchedulerConfig as JSchedulerConfig
from paddlenlp_tpu.serving import ServingServer as JServingServer
from paddlenlp_tpu.serving.tenancy import AdapterRegistry as JAdapterRegistry
from paddlenlp_tpu.transformers import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers import Qwen2ForCausalLM as JQwen2
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.quantization import QuantizationConfig, QuantizedModel
from paddlenlp_tpu_torch.quantization import a8w8, quantization_utils
from paddlenlp_tpu_torch.serving import MetricsRegistry, SchedulerConfig, ServingServer
from paddlenlp_tpu_torch.serving.tenancy import AdapterRegistry, adapter_dims_from_config
from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, tensor_from_numpy

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
ENG_KW = dict(max_batch_size=4, block_size=4, num_blocks=128, max_blocks_per_seq=32, decode_steps=4)
ALGOS = ("wint8", "wint4", "fp8", "a8w8")
PROMPTS = [[3, 7, 11, 2, 9, 4, 8, 6, 5, 10, 12, 13], [5, 6, 7], list(range(20, 41))]
GEN = 16
SAMPLINGS = {"greedy": dict(max_new_tokens=GEN),
             "sampled": dict(max_new_tokens=GEN, do_sample=True, temperature=0.8, top_p=0.9, top_k=8, seed=7,
                             repetition_penalty=1.2)}
#: the engine configuration each algorithm's streams run on (one JAX engine
#: each: its programs compile once): between them they cover n-gram
#: speculation, chunked prefill, an int8 KV pool and a LoRA adapter over an
#: a8w8 base. Calibrated a8w8 is held by its tree and its dense logits.
CELLS = {"wint8": dict(use_speculative=True, spec_draft_len=3, spec_ngram=2), "wint4": dict(prefill_chunk_tokens=16),
         "fp8": dict(kv_cache_quant="int8"), "a8w8": dict(adapter=True)}
FACADES = (*CELLS, "a8w8_calibrated")
#: one calibration batch of two prompts (the JAX observer runs eagerly: a
#: batch costs seconds)
CALIB = [{"input_ids": np.asarray([[3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
                                   [40, 2, 33, 17, 9, 61, 5, 88, 20, 7, 1, 90]], np.int32)}]
TIMEOUT = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while this module runs
    (under the suite's parallel workers a thread pool's wake-ups cost more
    than the ops); restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JQwen2.from_config(JQwen2Config(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = Qwen2ForCausalLM.from_jax_params(Qwen2Config(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def act_scales(models):
    """(JAX, port) calibrated scales over the same calibration batch."""
    jm, pm = models
    return ja8w8.collect_act_scales(jm, [{"input_ids": jax.numpy.asarray(b["input_ids"])} for b in CALIB]), \
        a8w8.collect_act_scales(pm, CALIB)


@pytest.fixture(scope="module")
def quantized(models, act_scales):
    """{cell: (JAX QuantizedModel, port QuantizedModel)}; the calibrated a8w8
    pair folds the JAX package's scales into both."""
    jm, pm = models
    out = {}
    for cell in FACADES:
        algo = cell.split("_")[0]
        scales = act_scales[0] if cell == "a8w8_calibrated" else None
        out[cell] = (JQuantizedModel(jm, JQuantizationConfig(weight_quantize_algo=algo), act_scales=scales),
                     QuantizedModel(pm, QuantizationConfig(weight_quantize_algo=algo), act_scales=scales))
    return out


def adapter_source(cfg, rank=4):
    rng = np.random.default_rng(1000)
    return {proj: {"A": rng.standard_normal((cfg.num_hidden_layers, d_in, rank)).astype(np.float32) * 0.02,
                   "B": rng.standard_normal((cfg.num_hidden_layers, rank, d_out)).astype(np.float32) * 0.02}
            for proj, (d_in, d_out) in adapter_dims_from_config(cfg).items()}


def make_engine(cls, qm, cell):
    kw = dict(CELLS[cell])
    if kw.pop("adapter", False):
        reg = (JAdapterRegistry if cls is JEngine else AdapterRegistry)(config=qm.config, max_rank=4, pool_slots=2)
        reg.add("ad", adapter_source(qm.config), scaling=40.0)
        kw["adapter_registry"] = reg
    return cls(qm, **ENG_KW, **kw)


@pytest.fixture(scope="module")
def engines(quantized):
    return {cell: (make_engine(JEngine, quantized[cell][0], cell),
                   make_engine(InferenceEngine, quantized[cell][1], cell)) for cell in CELLS}


def bits(x) -> np.ndarray:
    """The raw bits of a JAX/numpy array or a torch tensor, as unsigned ints
    of its width (bf16 and fp8 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        return x.view(view).numpy().view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[x.element_size()])
    a = np.ascontiguousarray(np.asarray(x))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def assert_trees_bitwise(jtree, ptree):
    jf, pf = jflatten(jtree), flatten_params(ptree)
    assert sorted(jf) == sorted(pf)
    for k, jv in jf.items():
        assert tuple(pf[k].shape) == tuple(np.shape(jv)), k
        assert str(np.asarray(jv).dtype) == str(pf[k].dtype).removeprefix("torch."), k
        np.testing.assert_array_equal(bits(pf[k]), bits(jv), err_msg=k)


# ----------------------------------------------------------------------------- the trees
@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_params_bitwise(models, quantized, algo):
    """The quantized tree of each algorithm equals the JAX package's, bit for
    bit; the facade's byte count too. The carried JAX tree (``ml_dtypes`` fp8
    included) is the port's, leaf for leaf."""
    jq, pq = quantized[algo]
    assert_trees_bitwise(jq.params, pq.params)
    assert pq.memory_footprint() == jq.memory_footprint()
    carried = {k: tensor_from_numpy(v) for k, v in jflatten(jax.device_get(jq.params)).items()}
    for k, v in flatten_params(pq.params).items():
        assert carried[k].dtype == v.dtype, k
        np.testing.assert_array_equal(bits(carried[k]), bits(v), err_msg=k)
    if algo == "a8w8":  # the layout _int_mm takes on CUDA: each layer slice column-major
        q = pq.params["model"]["layers"]["mlp"]["up_proj"]["qweight"]
        assert q[0].stride() == (1, q.shape[1])


@pytest.mark.parametrize("targets", [[r"mlp/(gate|up)_proj"], [r"lm_head", r"o_proj"], [r"nothing_matches"]])
def test_quant_target_modules_and_skip_rules(models, targets):
    """``quant_target_modules`` overrides the default skips (lm_head
    quantizes when named); no match leaves the tree unchanged."""
    jm, pm = models
    for algo in ("wint4", "fp8"):
        jcfg = JQuantizationConfig(weight_quantize_algo=algo, quant_target_modules=targets)
        pcfg = QuantizationConfig(weight_quantize_algo=algo, quant_target_modules=targets)
        assert_trees_bitwise(jqu.quantize_params(jm.params, jcfg), quantization_utils.quantize_params(pm.params, pcfg))


def test_int4_packing_and_unpacking():
    """Codes at every int4 value, odd and even rows, through the packer, the
    unpacker and ``dequantize_leaf``, against the JAX package's."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    w[:, 0, :] = 7.0 / 7.0 * np.abs(w).max(axis=1)  # absmax on row 0: code 7 there
    jq, js = jqu._quantize_array(w, 4)
    pq, ps = quantization_utils._quantize_array(torch.from_numpy(w), 4)
    np.testing.assert_array_equal(bits(pq), bits(jq))
    np.testing.assert_array_equal(bits(ps), bits(js))
    codes = quantization_utils._unpack_int4(pq)
    want = np.clip(np.round(w / np.maximum(js[:, None, :], 1e-12)), -8, 7).astype(np.int8)
    np.testing.assert_array_equal(codes.numpy(), want)
    assert set(np.unique(want)) >= {-7, 7}
    every = torch.arange(-8, 8, dtype=torch.int8).repeat(2).reshape(32, 1)
    packed = ((every[0::2].int() & 0xF) | ((every[1::2].int() & 0xF) << 4)).to(torch.uint8).view(torch.int8)
    assert torch.equal(quantization_utils._unpack_int4(packed), every)


def test_fp8_codes_grid():
    """Every finite e4m3 value, the midpoints between neighbours (ties) and one
    fp32 ulp either side, up to +-464: the port's cast gives the JAX
    package's ``ml_dtypes`` codes. Beyond 464 the two differ (saturation vs
    NaN), where no quantized weight lands: |w / scale| <= 448 (1 + 2**-22)."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    fin = np.unique(codes[np.isfinite(codes)])
    mids = ((fin[:-1].astype(np.float64) + fin[1:]) / 2).astype(np.float32)
    grid = np.concatenate([fin, mids, np.nextafter(mids, np.float32(np.inf)), np.nextafter(mids, np.float32(-np.inf)),
                           np.float32([448.0, 448.00003, -448.00003, 460.0, 464.0, -464.0])]).astype(np.float32)
    assert (np.abs(grid) <= 464).all()
    want = grid.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(grid).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    # columns whose absmax is exactly +-448 * scale, through the quantizer
    w = np.random.default_rng(4).standard_normal((64, 40)).astype(np.float32)
    jq, js = jqu._quantize_array_fp8(w)
    pq, ps = quantization_utils._quantize_array_fp8(torch.from_numpy(w))
    np.testing.assert_array_equal(bits(pq), bits(jq))
    np.testing.assert_array_equal(bits(ps), bits(js))
    assert (np.abs(np.asarray(jq).astype(np.float32)).max(axis=0) == 448).all()


@pytest.mark.parametrize("algo", ["wint8", "wint4", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_leaf_bitwise(quantized, algo, dtype):
    jq, pq = quantized[algo]
    bits_ = pq.quantization_config.bits
    for name in ("q_proj", "down_proj"):
        block = "self_attn" if name == "q_proj" else "mlp"
        jp = jq.params["model"]["layers"][block][name]
        pp = pq.params["model"]["layers"][block][name]
        want = jqu.dequantize_leaf(jp["qweight"], jp["scales"], bits_, getattr(jax.numpy, dtype))
        got = quantization_utils.dequantize_leaf(pp["qweight"], pp["scales"], bits_, getattr(torch, dtype))
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)


@pytest.mark.parametrize("algo", ["wint4", "fp8"])
def test_dequantize_tree_bitwise(quantized, algo):
    """Every ``{qweight, scales}`` group of a tree back to a ``kernel``."""
    jq, pq = quantized[algo]
    bits_ = pq.quantization_config.bits
    assert_trees_bitwise(jqu._dequantize_tree(jq.params, bits_, jax.numpy.float32),
                         quantization_utils._dequantize_tree(pq.params, bits_, torch.float32))


@pytest.mark.parametrize("scale", ["dynamic", "static"])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_int8_linear_bitwise(scale, out):
    """Activations of 1, 8 and 17 rows (a decode row, the engine's decode
    batch, past the CUDA padding) and [2, 5] rows, with a bias."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 40)).astype(np.float32) * 0.2
    jq, js = jqu._quantize_array(w, 8)
    bias = rng.standard_normal(40).astype(np.float32)
    for shape in ((1, 64), (8, 64), (17, 64), (2, 5, 64)):
        x = rng.standard_normal(shape).astype(np.float32) * 3
        act = 0.021 if scale == "static" else None
        want = ja8w8.int8_linear(jax.numpy.asarray(x), jax.numpy.asarray(jq), jax.numpy.asarray(js),
                                 bias=jax.numpy.asarray(bias), act_scale=act, out_dtype=getattr(jax.numpy, out))
        got = a8w8.int8_linear(torch.from_numpy(x), torch.from_numpy(np.asarray(jq)), torch.from_numpy(js),
                               bias=torch.from_numpy(bias), act_scale=act, out_dtype=getattr(torch, out))
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=str(shape))


def test_collect_and_fold_act_scales(models, act_scales, quantized):
    """Calibrated scales: the same keys (unrolled kernel paths, the head
    included) within rel 1e-5 (two fp32 forwards); folded into ``[L]``
    ``act_scale`` leaves bit for bit; a projection with a layer missing
    stays dynamic, as in the JAX package."""
    jscales, pscales = act_scales
    assert sorted(pscales) == sorted(jscales) and "lm_head/kernel" in pscales
    assert "model/layers_1/self_attn/q_proj/kernel" in pscales
    for k, v in jscales.items():
        assert abs(pscales[k] - v) <= 1e-5 * abs(v), k
    jq, pq = quantized["a8w8_calibrated"]
    assert_trees_bitwise(jq.params, pq.params)
    assert tuple(pq.params["model"]["layers"]["mlp"]["up_proj"]["act_scale"].shape) == (2,)
    partial = {k: v for k, v in jscales.items() if "layers_1/mlp/up_proj" not in k}
    jpart = ja8w8.fold_act_scales(jqu.quantize_params(models[0].params, JQuantizationConfig("a8w8")), partial)
    ppart = a8w8.fold_act_scales(quantization_utils.quantize_params(models[1].params, QuantizationConfig("a8w8")),
                                 partial)
    assert_trees_bitwise(jpart, ppart)
    assert "act_scale" not in ppart["model"]["layers"]["mlp"]["up_proj"]


@pytest.mark.parametrize("cell", FACADES)
def test_quantized_model_dense_logits(models, quantized, cell):
    """``QuantizedModel.__call__`` against the JAX facade's dense forward, fp32
    on both sides, to 1e-5 of the logits' largest magnitude (two summation
    orders; a8w8's activation codes are equal here: no activation of these
    inputs lies within the two forwards' difference of a rounding midpoint).

    The JAX side runs the facade's eager ``apply``: its jitted ``__call__``
    reuses the base model's jit cache, so a second facade whose tree has the
    first one's shapes and dtypes (a8w8 after wint8) computes the first one's
    function (ROADMAP Queue 3). The port's facade has no such cache: its a8w8
    logits after wint8 are the paged model's."""
    jq, pq = quantized[cell]
    ids = np.asarray([[3, 7, 11, 2, 9, 4, 8, 6, 5, 10, 12, 13, 40, 41]], np.int32)
    want = np.asarray(jq.apply(jq.params, input_ids=jax.numpy.asarray(ids)).logits)
    got = pq(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).all()


# ----------------------------------------------------------------------------- serving
def run(eng, sampling, adapter=None):
    """Every prompt submitted at once (row 0 on ``adapter`` when given), then
    drained: the rows decode batched together."""
    sp = (JSamplingParams if isinstance(eng, JEngine) else SamplingParams)(**SAMPLINGS[sampling])
    eng.reset()
    ids = [eng.add_request(list(p), sp, adapter_id=adapter if i == 0 else None) for i, p in enumerate(PROMPTS)]
    done = {}
    while eng.has_work():
        for req in eng.step():
            done[req.req_id] = req
    return [list(map(int, done[i].output_ids)) for i in ids]


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
@pytest.mark.parametrize("cell", list(CELLS))
def test_engine_streams_match_jax(engines, cell, sampling):
    jeng, peng = engines[cell]
    adapter = "ad" if CELLS[cell].get("adapter") else None
    want = run(jeng, sampling, adapter)
    got = run(peng, sampling, adapter)
    assert got == want
    assert all(len(s) == SAMPLINGS[sampling]["max_new_tokens"] for s in got)
    if adapter is not None and sampling == "greedy":  # the adapter steers its row
        assert got[0] != run(peng, sampling, None)[0]
    if CELLS[cell].get("use_speculative") and sampling == "greedy":
        assert peng.spec_stats == jeng.spec_stats and peng.spec_stats["verify_steps"] > 0


def test_sync_params_installs_a_quantized_tree(models):
    """A weight swap of a quantized tree into a port engine over a facade:
    its streams become those of a fresh engine over the swapped-in facade,
    the per-layer views rebound."""
    pm = models[1]
    other = Qwen2ForCausalLM.init_random(pm.config, seed=5, device="cpu", dtype=torch.float32)
    cfg = QuantizationConfig(weight_quantize_algo="wint8")
    qa, qb = QuantizedModel(pm, cfg), QuantizedModel(other, cfg)
    eng = InferenceEngine(qa, **ENG_KW)
    before = run(eng, "greedy")
    eng.sync_params(qb.params)
    eng.clear_prefix_cache()
    assert eng.model.params is qb.params
    assert run(eng, "greedy") == run(InferenceEngine(qb, **ENG_KW), "greedy") != before


# ----------------------------------------------------------------------------- HTTP
def request(port, method, path, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read()
        if payload is not None and payload.get("stream"):
            chunks = [json.loads(line[6:]) for line in body.split(b"\n") if line.startswith(b"data: {")]
            return resp.status, [c["choices"][0] for c in chunks]
        return resp.status, json.loads(body)
    finally:
        conn.close()


def scrub(doc):
    """A response body without what differs between two runs: ids and times."""
    if isinstance(doc, dict):
        return {k: (None if k == "timing" else scrub(v)) for k, v in doc.items() if k not in ("id", "created")}
    if isinstance(doc, (list, tuple)):
        return [scrub(v) for v in doc]
    return doc


def test_http_bodies_and_streams_match_jax(engines):
    """JSON (greedy and seeded) and SSE completions from a JAX and a port
    ``ServingServer`` over the a8w8 engines, the port's equal to the JAX
    one's and to the port engine's in-process stream."""
    jeng, peng = engines["a8w8"]
    payloads = [{"prompt": PROMPTS[0], "max_tokens": 8},
                {"prompt": PROMPTS[2], "max_tokens": 8, "do_sample": True, "temperature": 0.8, "seed": 3},
                {"prompt": PROMPTS[1], "max_tokens": 8, "stream": True}]
    seen = {}
    for key, eng, srv_cls, reg, sched in (("jax", jeng, JServingServer, JMetricsRegistry, JSchedulerConfig),
                                          ("port", peng, ServingServer, MetricsRegistry, SchedulerConfig)):
        eng.reset()
        srv = srv_cls(eng, registry=reg(), scheduler_config=sched(max_inflight=8, default_timeout_s=TIMEOUT))
        port = srv.start_in_thread()
        try:
            seen[key] = [request(port, "POST", "/v1/completions", p) for p in payloads]
        finally:
            srv.shutdown(drain_timeout_s=10)
    assert [s for s, _ in seen["port"]] == [200, 200, 200]
    for got, want in zip(scrub(seen["port"]), scrub(seen["jax"])):
        assert got == want, (got, want)
    peng.reset()
    want = peng.generate([PROMPTS[0]], SamplingParams(max_new_tokens=8))[0]
    assert seen["port"][0][1]["choices"][0]["token_ids"] == want
