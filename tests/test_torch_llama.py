"""The port's LLaMA/Qwen2 model: HF checkpoint loading and the dense forward.

- HF safetensors (torch ``[out, in]`` layout, HF keys) load through the key
  map and the stacked transpose, and the dense forward reproduces the torch
  logits stored in ``tests/transformers/golden`` (atol 1e-4; fp32 on both
  sides, so only op ordering differs).
- ``from_jax_params`` of the JAX package's scanned params gives the JAX
  ``LlamaForCausalLM`` logits (atol 1e-4) for a LLaMA config and a Qwen2
  config with q/k/v biases and a 7-way GQA fold, and with rope scaling.
- The cached forward over a left-padded batch (prefill, then 3 steps over a
  ``KVCache``) gives the JAX module's logits and cache contents, and the
  training forward with a padding mask the JAX loss and gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.ops.rope import rope_frequencies as jax_rope_frequencies
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers import Qwen2ForCausalLM as JQwen2
from paddlenlp_tpu_torch.ops.rope import rope_frequencies
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "transformers", "golden")
ATOL = 1e-4
IDS = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]], np.int64)

ROPE_SCALINGS = [
    None,
    {"rope_type": "linear", "factor": 2.0},
    {"type": "dynamic", "factor": 4.0},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
     "original_max_position_embeddings": 64},
    {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32},
]


@pytest.mark.parametrize("name", ["llama_tiny", "llama_gqa_tiny"])
def test_hf_checkpoint_matches_golden_logits(name):
    fixture = os.path.join(GOLDEN, name)
    data = np.load(os.path.join(fixture, "golden_logits.npz"))
    model = LlamaForCausalLM.from_pretrained(fixture, device="cpu")
    got = model(torch.from_numpy(data["input_ids"])).numpy()
    np.testing.assert_allclose(got, data["logits"], atol=ATOL, rtol=0)


def _jax_and_port(jcls, pcls, jcfg_cls, pcfg_cls, seed, **kw):
    jm = jcls.from_config(jcfg_cls(use_scan_layers=True, **kw), seed=seed)
    rng = np.random.default_rng(seed)
    # biases init to zero in JAX: randomize every leaf a little so a dropped
    # bias or a mis-stacked layer shows up in the logits
    jm.params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.02 * rng.standard_normal(x.shape), x.dtype),
                             jm.params)
    pm = pcls.from_jax_params(pcfg_cls(**kw), jax.device_get(jm.params), device="cpu")
    return jm, pm


def _logits_both(jm, pm, ids=IDS):
    want = np.asarray(jm(input_ids=jnp.asarray(ids, jnp.int32)).logits)
    got = pm(torch.from_numpy(ids)).numpy()
    return got, want


def test_llama_from_jax_params():
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    got, want = _logits_both(*_jax_and_port(JLlama, LlamaForCausalLM, JLlamaConfig, LlamaConfig, 0, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_qwen2_biases_and_group7_from_jax_params():
    kw = dict(vocab_size=160, hidden_size=112, intermediate_size=96, num_hidden_layers=2, num_attention_heads=7,
              num_key_value_heads=1, head_dim=16, rope_theta=1e6, max_position_embeddings=64)
    jm, pm = _jax_and_port(JQwen2, Qwen2ForCausalLM, JQwen2Config, Qwen2Config, 1, **kw)
    layers = pm.params["model"]["layers"]["self_attn"]
    assert {"q_proj", "k_proj", "v_proj"} <= {k for k in layers if "bias" in layers[k]}
    assert "bias" not in layers["o_proj"]
    got, want = _logits_both(jm, pm)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_qwen2_hf_checkpoint_roundtrip(tmp_path):
    """A checkpoint the JAX package writes (HF keys, torch layout, per-layer
    tensors) loads into the port with the same logits as from_jax_params."""
    kw = dict(vocab_size=160, hidden_size=112, intermediate_size=96, num_hidden_layers=3, num_attention_heads=7,
              num_key_value_heads=1, head_dim=16, max_position_embeddings=64)
    jm, pm = _jax_and_port(JQwen2, Qwen2ForCausalLM, JQwen2Config, Qwen2Config, 2, **kw)
    jm.save_pretrained(str(tmp_path))
    loaded = Qwen2ForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    ids = torch.from_numpy(IDS)
    torch.testing.assert_close(loaded(ids), pm(ids), atol=1e-6, rtol=0)


@pytest.mark.parametrize("scaling", ROPE_SCALINGS)
def test_rope_frequencies_match(scaling):
    for head_dim, base in ((16, 10000.0), (128, 1e6)):
        np.testing.assert_array_equal(rope_frequencies(head_dim, base, scaling),
                                      jax_rope_frequencies(head_dim, base, scaling))


def test_rope_scaled_forward_from_jax_params():
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64, rope_scaling=ROPE_SCALINGS[3])
    got, want = _logits_both(*_jax_and_port(JLlama, LlamaForCausalLM, JLlamaConfig, LlamaConfig, 3, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ----------------------------------------------------------------------------- cached and masked forwards
PAD_IDS = np.asarray([[0, 0, 0, 3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5, 8, 9, 7, 9]], np.int64)
PAD_MASK = np.asarray([[0, 0, 0, 1, 1, 1, 1, 1, 1], [1] * 9], np.int64)


def test_cached_call_matches_jax_cache():
    """The cached dense forward over a left-padded batch (generate's prefill
    with ``clip(cumsum(mask) - 1, 0)`` positions, then 3 one-token steps over
    a 12-slot cache) equals the JAX module applied with a ``KVCache``: the
    logits of every call and the cache's keys and values after each."""
    from paddlenlp_tpu.transformers.cache_utils import init_cache as jax_init_cache
    from paddlenlp_tpu_torch.transformers.cache_utils import init_cache

    kw = dict(vocab_size=160, hidden_size=112, intermediate_size=96, num_hidden_layers=2, num_attention_heads=7,
              num_key_value_heads=1, head_dim=16, rope_theta=1e6, max_position_embeddings=64)
    jm, pm = _jax_and_port(JQwen2, Qwen2ForCausalLM, JQwen2Config, Qwen2Config, 4, **kw)
    B, T0, S = PAD_IDS.shape[0], PAD_IDS.shape[1], 12
    mask = np.concatenate([PAD_MASK, np.ones((B, S - T0), np.int64)], axis=1)
    steps = np.asarray([[7, 8, 9], [10, 11, 12]], np.int64)
    apply = jax.jit(lambda p, ids, m, pos, kv: jm.module.apply({"params": p}, input_ids=ids, attention_mask=m,
                                                             position_ids=pos, cache=kv, deterministic=True))
    jkv = jax_init_cache(jm.config, B, S, dtype=jnp.float32)
    kv = init_cache(pm.config, B, S, dtype=torch.float32, device="cpu")
    pos = np.maximum(np.cumsum(PAD_MASK, axis=1) - 1, 0)
    feeds = [(PAD_IDS, pos)] + [(steps[:, i:i + 1], PAD_MASK.sum(1, keepdims=True) + i) for i in range(3)]
    for ids, p in feeds:
        out = apply(jm.params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32), jnp.asarray(p, jnp.int32),
                    jkv)
        jkv = out.past_key_values
        got, kv = pm(torch.from_numpy(ids), attention_mask=torch.from_numpy(mask), position_ids=torch.from_numpy(p),
                     cache=kv)
        np.testing.assert_allclose(got.numpy(), np.asarray(out.logits), atol=ATOL, rtol=0)
        assert kv.offset == int(jkv.offset)
        np.testing.assert_allclose(kv.keys.numpy(), np.asarray(jkv.keys), atol=1e-5, rtol=0)
        np.testing.assert_allclose(kv.values.numpy(), np.asarray(jkv.values), atol=1e-5, rtol=0)


def test_masked_training_forward_matches_jax():
    """The training forward with a padding mask: the loss within atol 1e-5
    and every gradient leaf within 1e-4 of its largest element against
    ``jax.value_and_grad`` of the JAX module's masked forward."""
    from paddlenlp_tpu.ops.cross_entropy import causal_lm_loss as jax_causal_lm_loss
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
    jm, pm = _jax_and_port(JLlama, LlamaForCausalLM, JLlamaConfig, LlamaConfig, 5, **kw)
    labels = np.where(PAD_MASK > 0, (PAD_IDS * 7 + 3) % 128, -100)

    def loss_fn(p):
        logits = jm.module.apply({"params": p}, input_ids=jnp.asarray(PAD_IDS, jnp.int32),
                                 attention_mask=jnp.asarray(PAD_MASK, jnp.int32), deterministic=True).logits
        return jax_causal_lm_loss(logits, jnp.asarray(labels, jnp.int32), shift=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jm.params)
    leaves = flatten_params(pm.params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = causal_lm_loss(pm.forward(torch.from_numpy(PAD_IDS), attention_mask=torch.from_numpy(PAD_MASK)),
                          torch.from_numpy(labels), shift=True)
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten

    for path, g in jflatten(jax.device_get(want_grads)).items():
        g = np.asarray(g)
        np.testing.assert_allclose(leaves[path].grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0, err_msg=path)
