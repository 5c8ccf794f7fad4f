"""The port's speculative decoding against the JAX package's, on one tiny model.

Both engines serve the same weights (the port's built with
``from_jax_params``). Every case of ``tests/experimental/test_spec_decode.py``
runs on a JAX engine and a port engine and the two must agree exactly: the
streams, ``spec_stats`` and the goodput ledger's records. The proposers'
numpy code (n-gram lookup, the draft's argmax or draw, rejection sampling)
runs on the same seeds in both, so sampled streams agree too. The module
shares one engine pair (and one more with a 14-block pool for preemption)
whose proposer each case switches, so JAX compiles the target's programs
once; ``spec_stats`` and ledger totals are compared as deltas.

Also held here: ``PagedInferenceModel.verify`` (argmax exact, fp32 logits to
rel 1e-4, the paged tolerance of ``PERF.md`` §2, and the pool it writes), the
draft model's rows against the JAX draft's masked forward,
``_accept_rejection`` bit for bit on identical inputs, and brownout level 2
switching speculation off in the port's ``ServingServer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.experimental.paged_cache import init_paged_pool as jinit_paged_pool
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512, eos_token_id=None, pad_token_id=0)
# a DIFFERENT (smaller) model than the target: its drafts are not always accepted
DRAFT_KW = dict(vocab_size=96, hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                num_key_value_heads=2, max_position_embeddings=512, eos_token_id=None, pad_token_id=0)
ENGINE_KW = dict(max_batch_size=2, block_size=4, num_blocks=128, max_blocks_per_seq=32)
PROMPTS = [[5, 6, 7, 8, 9, 5, 6, 7], [40, 41, 42, 43]]
REJECTION = dict(do_sample=True, temperature=0.9, top_k=0, top_p=1.0)


def _pair(jcfg_kw, seed):
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **jcfg_kw), seed=seed)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**jcfg_kw), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def models():
    return _pair(MODEL_KW, 0)


@pytest.fixture(scope="module")
def drafts():
    return _pair(DRAFT_KW, 7)


@pytest.fixture(scope="module")
def engines(models):
    """"main" and "preempt" -> (JAX engine, port engine), built on first use.
    The cases switch speculation and the proposer on the shared main pair
    (``_propose``): the target's programs compile once on the JAX side."""
    jm, pm = models
    kws = {"main": ENGINE_KW, "preempt": dict(max_batch_size=2, block_size=4, num_blocks=14, max_blocks_per_seq=16)}
    built = {}

    def get(name):
        if name not in built:
            built[name] = (JEngine(jm, **kws[name]), InferenceEngine(pm, **kws[name]))
        return built[name]

    return get


def _propose(pair, spec=False, draft=None, k=4):
    """Switch a pair to plain decode (spec False), the n-gram proposer (spec
    True) or a draft model (``draft`` = (JAX model, port model)), with the
    constructor's own rule: a draft model turns speculation on."""
    for i, eng in enumerate(pair):
        eng.draft_model = None if draft is None else draft[i]
        eng.use_speculative = spec or draft is not None
        eng.spec_draft_len = k
    return pair


def _run(pair, prompts, **sampling):
    """Generate on both engines; returns ((port outs, port stats delta, port
    ledger delta), (the same for JAX))."""
    out = []
    for eng, sp in zip(reversed(pair), (SamplingParams, JSamplingParams)):
        s0, l0 = dict(eng.spec_stats), dict(eng.ledger.totals)
        outs = [list(map(int, o)) for o in eng.generate(prompts, sp(**sampling))]
        out.append((outs, {k: eng.spec_stats[k] - s0[k] for k in s0},
                    {k: eng.ledger.totals[k] - l0[k] for k in l0}))
    return out


def _same(pair, prompts, **sampling):
    got, want = _run(pair, prompts, **sampling)
    assert got == want
    assert pair[1].ledger.verify_conservation()
    return got


def test_verify_against_jax(engines):
    """verify on a batch with an inactive row (all-zero table, start 0),
    through the main engines' paged models (so JAX compiles the program the
    engine runs, once): the argmax exact, fp32 logits to rel 1e-4, and the
    pool it writes (every fed position, drafts included; the inactive row
    into block 0) equal to the JAX package's: the same positions written,
    the values to fp32 rounding (the K/V are fp32 projections computed by
    two libraries)."""
    jeng, peng = engines("main")
    jinfer, pinfer = jeng.infer, peng.infer
    jpool = jinit_paged_pool(jinfer.config, ENGINE_KW["num_blocks"], ENGINE_KW["block_size"], dtype=jnp.float32)
    ppool = init_paged_pool(pinfer.config, ENGINE_KW["num_blocks"], ENGINE_KW["block_size"], dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(0)
    tables = np.zeros((2, ENGINE_KW["max_blocks_per_seq"]), np.int32)
    tables[0, :5] = [1, 2, 3, 4, 5]  # row 1 inactive
    start = np.zeros(2, np.int32)
    for step in range(3):
        tokens = rng.integers(1, 96, (2, 5)).astype(np.int32)
        tokens[1] = 0
        ja, jl, jpool = jinfer.verify(jeng.model.params, jpool, jnp.asarray(tokens), jnp.asarray(tables),
                                      jnp.asarray(start))
        pa, pl = pinfer.verify(ppool, torch.from_numpy(tokens), torch.from_numpy(tables), torch.from_numpy(start))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        jl = np.asarray(jl)
        assert pl.dtype == torch.float32 and pl.shape == jl.shape
        assert np.abs(pl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
        jkv, pkv = np.asarray(jpool.kv), ppool.kv.numpy()
        np.testing.assert_array_equal(pkv != 0, jkv != 0)
        np.testing.assert_allclose(pkv, jkv, rtol=0, atol=1e-5 * np.abs(jkv).max())
        assert np.abs(pkv[:, :, 0]).max() > 0  # the inactive row wrote into block 0, as in JAX
        # greedy acceptance never asks for the logits
        assert pinfer.verify(ppool, torch.from_numpy(tokens), torch.from_numpy(tables), torch.from_numpy(start),
                             need_logits=False)[1] is None
        start[0] += 1 + step  # accept a few positions and go on


def test_greedy_bit_identical(engines):
    """Speculation never changes greedy outputs."""
    base = _same(_propose(engines("main")), PROMPTS, max_new_tokens=24)
    spec = _same(_propose(engines("main"), spec=True), PROMPTS, max_new_tokens=24)
    assert spec[0] == base[0]
    assert spec[1]["verify_steps"] > 0


def test_repetitive_prompt_speedup(engines):
    """The n-gram proposer pushes a repetitive prompt to >= 1.5 tokens a
    verify forward, with the same stats as the JAX engine's (4 drafts a
    step, the module's verify shape; the JAX test drafts 8)."""
    outs, stats, ledger = _same(_propose(engines("main"), spec=True), [[30] * 12], max_new_tokens=40)
    assert len(outs[0]) == 40
    assert stats["verify_steps"] > 0 and stats["tokens_emitted"] / stats["verify_steps"] >= 1.5, stats
    assert ledger["spec_rejected"] == stats["drafted"] - stats["accepted"]
    assert outs[0] == _same(_propose(engines("main")), [[30] * 12], max_new_tokens=40)[0][0]


def test_sampling_requests_fall_back(engines):
    """A top-k sampler is outside both acceptance modes: the n-gram engine
    decodes as usual and matches the plain engine."""
    sp = dict(max_new_tokens=12, do_sample=True, seed=3, top_k=8)
    spec = _same(_propose(engines("main"), spec=True), [[5, 6, 7, 8]], **sp)
    assert spec[1]["verify_steps"] == 0
    assert spec[0] == _same(_propose(engines("main")), [[5, 6, 7, 8]], **sp)[0]


def test_preemption_under_pressure(engines):
    """The K+1 reservation preempts and recovers like decode when blocks run
    out (13 usable blocks)."""
    prompts = [[5, 6, 7, 8, 5, 6, 7, 8], [40, 41, 42, 43, 40, 41, 42, 43]]
    pair = _propose(engines("preempt"), spec=True)
    p0 = [eng.num_preemptions for eng in pair]
    outs = _same(pair, prompts, max_new_tokens=12)
    assert pair[1].num_preemptions - p0[1] == pair[0].num_preemptions - p0[0]
    assert outs[0] == _same(_propose(engines("main")), prompts, max_new_tokens=12)[0]


def test_draft_rows_match_the_jax_masked_forward(drafts):
    """The proposer's draft rows (a causal forward through the flash
    dispatcher, no padding mask) equal the rows the JAX engine reads from
    its draft's masked forward over the same right-padded buffer (fp32,
    rel 1e-4)."""
    jd, pd = drafts
    L = 64
    lens = np.array([13, 40, 1], np.int32)
    rng = np.random.default_rng(1)
    ids = np.zeros((3, L), np.int32)
    for j, n in enumerate(lens):
        ids[j, :n] = rng.integers(1, 96, n)
    eng = InferenceEngine.__new__(InferenceEngine)
    eng.draft_model = pd
    got = eng._draft_rows(ids, lens - 1)
    mask = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
    out = jd(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    want = np.asarray(jnp.take_along_axis(out.logits, jnp.asarray(lens - 1)[:, None, None], axis=1)[:, 0],
                      dtype=np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_greedy_bit_identical_with_draft_model(engines, drafts):
    base = _same(_propose(engines("main")), PROMPTS, max_new_tokens=16)
    spec = _same(_propose(engines("main"), draft=drafts), PROMPTS, max_new_tokens=16)
    assert spec[0] == base[0]
    assert spec[1]["verify_steps"] > 0


def test_self_draft_accepts_everything_greedy(engines, models):
    """The target drafting for itself: its greedy drafts match the verify
    argmax (>= 0.95, as in the JAX test: near-ties between the draft's and
    the verify's forward may split)."""
    outs, s, _ = _same(_propose(engines("main"), draft=models), [[5, 6, 7, 8]], max_new_tokens=12)
    assert len(outs[0]) == 12
    assert s["drafted"] > 0 and s["accepted"] / s["drafted"] >= 0.95, s


def test_rejection_sampling_self_draft_full_acceptance(engines, models):
    """Sampling with draft == target: p == q up to rounding, so every draft
    is accepted (>= 0.95) and the stream is the JAX engine's."""
    outs, s, _ = _same(_propose(engines("main"), draft=models), [[5, 6, 7, 8]], max_new_tokens=12, **REJECTION)
    assert len(outs[0]) == 12
    assert s["drafted"] > 0 and s["accepted"] / s["drafted"] >= 0.95, s


def test_rejection_sampling_different_draft_runs(engines, drafts):
    outs, s, ledger = _same(_propose(engines("main"), draft=drafts), [[5, 6, 7, 8], [40, 41, 42, 43]],
                            max_new_tokens=16, **REJECTION)
    assert all(len(o) == 16 for o in outs)
    assert s["verify_steps"] > 0 and s["drafted"] >= s["accepted"], s
    assert ledger["spec_rejected"] == s["drafted"] - s["accepted"]


def test_topk_sampling_falls_back(engines, drafts):
    outs, s, _ = _same(_propose(engines("main"), draft=drafts), [[5, 6, 7, 8]], max_new_tokens=8, do_sample=True,
                       top_k=5)
    assert len(outs[0]) == 8 and s["verify_steps"] == 0


def test_accept_rejection_bitwise(models):
    """``_accept_rejection`` draws the same tokens as the reference from the
    same logits, draft probabilities and seeds, accepted prefix and
    correction or bonus token alike."""
    jm, pm = models
    rng = np.random.default_rng(5)
    V, K = 96, 4
    for trial in range(8):
        logits = (rng.standard_normal((K + 1, V)) * 3).astype(np.float32)
        q = rng.dirichlet(np.ones(V), K).astype(np.float32)
        d = np.asarray([int(rng.choice(V, p=q[t])) for t in range(K)], np.int32)
        got = []
        for Engine, Sp, m in ((JEngine, JSamplingParams, jm), (InferenceEngine, SamplingParams, pm)):
            eng = Engine.__new__(Engine)
            eng._spec_seed, eng._spec_rngs = 11, {}
            eng.spec_stats = {"verify_steps": 0, "tokens_emitted": 0, "drafted": 0, "accepted": 0}
            req = type("Req", (), {})()
            req.req_id, req.spec_accepted = trial, 0
            req.sampling = Sp(do_sample=True, temperature=0.9, seed=trial)
            got.append((eng._accept_rejection(0, req, d, logits, q if trial % 2 else None),
                        eng.spec_stats["accepted"], req.spec_accepted))
        assert got[1] == got[0]


def test_brownout_level_2_turns_speculation_off(models):
    """The port's ServingServer switches speculation off at brownout level 2
    and back on when the floor lifts."""
    from paddlenlp_tpu_torch.serving import MetricsRegistry, ServingServer

    eng = InferenceEngine(models[1], **ENGINE_KW, use_speculative=True)
    server = ServingServer(eng, registry=MetricsRegistry())
    try:
        levels = []
        for level in (2, 3, 1, 0):
            server.push_brownout({"level": level, "ttl_s": 60})
            levels.append((server.scheduler.brownout.level, eng.use_speculative))
        assert levels == [(2, False), (3, False), (1, True), (0, True)]
    finally:
        server.shutdown(drain_timeout_s=5)
