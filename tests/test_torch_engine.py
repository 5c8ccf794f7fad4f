"""The port's serving engine against the JAX package's, on one tiny model.

Both engines serve the same model (the port's built with ``from_jax_params``
from the JAX params, as in ``tests/experimental/test_paged_inference.py``)
and must emit identical greedy and seeded streams: a batch of two, staggered
arrivals, prefix-cache hits with a copy-on-write tail, chunked prefill (the
token-flattened launch, which both pick off the TPU/GPU kernel), preemption
in a 10-block pool, and int8 and fp8 KV pools. The goodput ledger books the same
totals. One engine pair per configuration is shared by the module and reset
between tests, so each configuration is compiled once on the JAX side.
"""

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
BASE = dict(max_batch_size=4, block_size=4, num_blocks=64, max_blocks_per_seq=16)
CONFIGS = {
    "base": BASE,
    "chunked": dict(BASE, prefill_chunk_tokens=8),
    "preempt": dict(max_batch_size=2, block_size=4, num_blocks=10, max_blocks_per_seq=32),
    "int8": dict(BASE, block_size=8, kv_cache_quant="int8"),
    "fp8": dict(BASE, block_size=8, kv_cache_quant="fp8"),
}
PREFIX = list(range(5, 21))  # 4 full blocks of 4


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def engines(models):
    jm, pm = models
    return {name: (JEngine(jm, **kw), InferenceEngine(pm, **kw)) for name, kw in CONFIGS.items()}


@pytest.fixture
def pair(engines, request):
    jeng, peng = engines[request.param]
    jeng.reset()
    peng.reset()
    return jeng, peng


def _generate_both(pair, prompts, **sampling):
    jeng, peng = pair
    want = jeng.generate(prompts, JSamplingParams(**sampling))
    got = peng.generate(prompts, SamplingParams(**sampling))
    return got, want


def test_port_engine_defaults():
    pm = LlamaForCausalLM.init_random(LlamaConfig(**MODEL_KW), seed=0, device="cpu", dtype=torch.float32)
    eng = InferenceEngine(pm, **BASE)
    assert eng.infer.dtype == torch.float32 and eng.pool.kv.dtype == torch.float32
    assert not eng.infer.use_paged_kernel  # the plain path on the CPU


@pytest.mark.parametrize("pair", ["base"], indirect=True)
def test_batch_of_two(pair):
    got, want = _generate_both(pair, [[5, 6, 7], [40, 41, 42, 43, 44, 45]], max_new_tokens=8)
    assert got == want


@pytest.mark.parametrize("pair", ["base"], indirect=True)
def test_staggered_arrivals(pair):
    outs = []
    for eng, sp in zip(pair, (JSamplingParams, SamplingParams)):
        eng.add_request([5, 6, 7, 8], sp(max_new_tokens=8))
        done = eng.step() + eng.step()
        eng.add_request([30, 31, 32], sp(max_new_tokens=4))  # arrives mid-flight
        while eng.has_work():
            done += eng.step()
        outs.append(sorted((r.req_id, list(r.output_ids)) for r in done))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("pair", ["base", "chunked"], indirect=True)
def test_priority_admission_order(pair):
    """Six requests contend for four slots; interactive ones overtake queued
    batch ones, and both engines admit and finish in the same order."""
    outs = []
    for eng, sp in zip(pair, (JSamplingParams, SamplingParams)):
        for i, prio in enumerate(["batch"] * 4 + ["best_effort", "interactive"]):
            eng.add_request(list(range(10 + 3 * i, 14 + 3 * i)), sp(max_new_tokens=5 + i), priority=prio)
        order = []
        while eng.has_work():
            order += [(r.req_id, list(r.output_ids)) for r in eng.step()]
        outs.append(order)
    assert outs[1] == outs[0]


@pytest.mark.parametrize("pair", ["base"], indirect=True)
def test_abort_release_and_cache_clear(pair):
    """abort (waiting and running), release_request and clear_prefix_cache
    leave both engines' allocators and outputs equal."""
    results = []
    for eng, sp in zip(pair, (JSamplingParams, SamplingParams)):
        ids = [eng.add_request(PREFIX + [60 + i], sp(max_new_tokens=12)) for i in range(6)]
        eng.step()
        aborted = [eng.abort(ids[0]), eng.abort(ids[5]), eng.abort(999)]
        released = [eng.release_request(ids[1]), eng.release_request(ids[1])]
        done = []
        while eng.has_work():
            done += eng.step()
        cached = eng.mgr.num_cached_blocks
        eng.clear_prefix_cache()
        results.append(([None if r is None else (r.req_id, r.finish_reason) for r in aborted], released,
                        sorted((r.req_id, list(r.output_ids)) for r in done), cached, eng.mgr.num_free,
                        eng.mgr.num_cached_blocks, eng.stats()["prefix_cache"]["hits"]))
    assert results[1] == results[0]
    assert results[0][3] > 0 and results[0][5] == 0


@pytest.mark.parametrize("pair", ["base", "chunked"], indirect=True)
def test_prefix_cache_hit_and_cow_tail(pair):
    """A shared 4-block prefix, then the exact prefix again (full cover: the
    tail block is copied on write and its last token re-prefilled)."""
    for prompt in (PREFIX + [60, 61], PREFIX + [70, 71, 72], PREFIX):
        got, want = _generate_both(pair, [prompt], max_new_tokens=6)
        assert got == want
    jeng, peng = pair
    assert peng.mgr.cache_hits == jeng.mgr.cache_hits >= 2
    assert peng.mgr.cached_tokens_total == jeng.mgr.cached_tokens_total


@pytest.mark.parametrize("pair", ["base", "chunked"], indirect=True)
def test_seeded_sampling(pair):
    prompts = [[5, 6, 7], list(range(30, 55))]
    for kw in (dict(do_sample=True, top_p=0.9, temperature=0.8, seed=7),
               dict(do_sample=True, top_k=5, seed=3, repetition_penalty=1.3, presence_penalty=0.4)):
        got, want = _generate_both(pair, prompts, max_new_tokens=10, **kw)
        assert got == want


@pytest.mark.parametrize("pair", ["chunked"], indirect=True)
def test_chunked_prefill_flat_launch(pair):
    """Long prompts split into 8-token chunks interleaved with decodes; off
    the kernel both engines pick the token-flattened mixed launch."""
    got, want = _generate_both(pair, [list(range(3, 40)), [5, 6, 7], list(range(50, 70))], max_new_tokens=10)
    assert got == want
    jeng, peng = pair
    assert peng.chunk_stats == jeng.chunk_stats and peng.chunk_stats["chunks"] > 0
    assert any(k[0] == "mixed_flat" for k in peng.ledger.shape_buckets)
    assert peng.ledger.shape_buckets == jeng.ledger.shape_buckets


@pytest.mark.parametrize("pair", ["preempt"], indirect=True)
def test_preemption_recompute(pair):
    """9 usable blocks: two sequences growing to 19 tokens (5 blocks each)
    collide, one is preempted and recomputed, and both streams still match."""
    got, want = _generate_both(pair, [[5, 6, 7], [40, 41, 42]], max_new_tokens=16)
    assert got == want
    jeng, peng = pair
    assert peng.num_preemptions == jeng.num_preemptions > 0


@pytest.mark.parametrize("pair", ["int8"], indirect=True)
def test_int8_kv_pool(pair):
    got, want = _generate_both(pair, [[5, 6, 7, 8, 9], [40, 41, 42]], max_new_tokens=8)
    assert got == want


@pytest.mark.parametrize("pair", ["int8", "fp8"], indirect=True)
def test_quantized_kv_pool_state(pair):
    """Token-exact streams over an int8 or fp8 pool, and the pool's quantized
    bytes equal to the JAX engine's. The scales are each token's K/V row
    maximum over 127 or 448, and K/V come out of fp32 GEMMs of two libraries:
    equal to fp32 rounding, 1e-6 of the largest scale."""
    got, want = _generate_both(pair, [[5, 6, 7, 8, 9], [40, 41, 42], list(range(60, 75))], max_new_tokens=8)
    assert got == want
    jeng, peng = pair
    jkv, pkv = np.asarray(jeng.pool.kv), peng.pool.kv
    if pkv.dtype == torch.float8_e4m3fn:
        jkv, pkv = jkv.view(np.uint8), pkv.view(torch.uint8)
    assert np.array_equal(pkv.numpy(), jkv)
    jscale = np.asarray(jeng.pool.scale)
    np.testing.assert_allclose(peng.pool.scale.numpy(), jscale, rtol=0, atol=1e-6 * np.abs(jscale).max())


@pytest.mark.parametrize("pair", ["base", "chunked", "preempt"], indirect=True)
def test_efficiency_ledger_totals(pair):
    jeng, peng = pair
    j0, p0 = dict(jeng.ledger.totals), dict(peng.ledger.totals)
    got, want = _generate_both(pair, [PREFIX + [70, 71], [5, 6, 7], list(range(30, 45))], max_new_tokens=9)
    assert got == want
    delta = lambda led, t0: {k: led.totals[k] - t0[k] for k in t0}  # noqa: E731
    assert delta(peng.ledger, p0) == delta(jeng.ledger, j0)
    assert peng.ledger.verify_conservation()
    doc = peng.efficiency()
    assert doc["ledger"]["totals"] == peng.ledger.totals and doc["mfu"] is None  # no peak FLOPs on the CPU


def test_paged_logits_match_dense(models):
    """Prefill then decode through the port's paged path gives the port's
    dense forward logits (fp32, atol 1e-4), on both attention paths."""
    _, pm = models
    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool

    seq = [int(x) for x in np.random.default_rng(0).integers(0, 96, 21)]
    dense = pm(torch.tensor([seq]))[0]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    for kernel_path in (False, True):  # True: the kernel's wrapper, i.e. its plain version on the CPU
        infer = PagedInferenceModel(pm, block_size=4, num_blocks=9, max_blocks_per_seq=8, dtype=torch.float32,
                                    use_paged_kernel=kernel_path)
        pool = init_paged_pool(pm.config, 9, 4, dtype=torch.float32, device="cpu")
        tables = torch.arange(1, 9, dtype=torch.int32)[None]
        T = 13
        rows = [infer._forward(pool, i32([seq[:T]]), tables, torch.arange(T)[None], torch.arange(32)[None] < T,
                               i32([0]), i32([T - 1]), q_lens=i32([T]))]
        for pos in range(T, len(seq)):
            rows.append(infer._forward(pool, i32([[seq[pos]]]), tables, i32([[pos]]), torch.arange(32)[None] <= pos,
                                       i32([pos]), i32([0])))
        torch.testing.assert_close(torch.cat(rows), dense[T - 1:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("option", [dict(mesh_shape=(1, 2)), dict(disagg_stages=(1, 1)),
                                    dict(mesh_shape=(1, 2), adapter_registry=object()),
                                    dict(disagg_stages=(1, 1), tenant_quotas={})])
def test_options_outside_the_slice_raise(models, option):
    # multi-LoRA and tenant quotas are ported; with a mesh they still refuse
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        InferenceEngine(models[1], **BASE, **option)
