"""The port's training forward and backward against the JAX package's.

At fp32, the same parameters (the JAX model's scanned tree, every leaf
perturbed from a seed so a dropped bias or a mis-stacked layer shows) and the
same token ids go through ``jax.value_and_grad`` of the JAX model's causal-LM
loss (``causal_lm_loss(..., shift=True)``, as ``Trainer.compute_loss``) and
through the port's ``LlamaForCausalLM.forward`` + ``causal_lm_loss`` +
``backward``. Configs: the tiny LLaMA of ``tests/trainer/test_trainer.py`` and
a tiny Qwen2 (q/k/v biases, tied head, a 3-way GQA fold). Tolerances: the loss
within atol 1e-5; every gradient leaf within 1e-4 of its largest element
(fp32, summation order only). Recompute off and each of the eight
recompute granularities give the same numbers (``offload_attn`` keeps its
saved tensors in plain host memory on the CPU); an unknown one raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.ops.cross_entropy import causal_lm_loss as jax_causal_lm_loss
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers import Qwen2ForCausalLM as JQwen2
from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss, cross_entropy_with_ignore
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.transformers.llama.modeling import RECOMPUTE_GRANULARITIES

LOSS_ATOL = 1e-5
GRAD_REL = 1e-4

LLAMA = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)
QWEN2 = dict(vocab_size=96, hidden_size=96, intermediate_size=80, num_hidden_layers=2, num_attention_heads=6,
             num_key_value_heads=2, head_dim=16, rope_theta=1e6, tie_word_embeddings=True,
             max_position_embeddings=64)
MODELS = {"llama": (JLlama, LlamaForCausalLM, JLlamaConfig, LlamaConfig, LLAMA),
          "qwen2": (JQwen2, Qwen2ForCausalLM, JQwen2Config, Qwen2Config, QWEN2)}


def _batch(vocab, seed=0, B=2, T=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels[0, :3] = -100  # ignored positions
    return ids, labels


@pytest.fixture(scope="module", params=list(MODELS))
def jax_reference(request):
    jcls, pcls, jcfg_cls, pcfg_cls, kw = MODELS[request.param]
    jm = jcls.from_config(jcfg_cls(use_scan_layers=True, **kw), seed=0)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.02 * rng.standard_normal(x.shape), x.dtype),
                          jm.params)
    ids, labels = _batch(kw["vocab_size"])

    def loss_fn(p):
        logits = jm.module.apply({"params": p}, input_ids=jnp.asarray(ids), deterministic=True).logits
        return jax_causal_lm_loss(logits, jnp.asarray(labels), shift=True)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    flat = {k: np.asarray(v) for k, v in flatten_params(jax.device_get(grads)).items()}
    return request.param, jax.device_get(params), ids, labels, float(loss), flat


def _port_loss_and_grads(name, params, ids, labels, **cfg_kw):
    _jcls, pcls, _jcfg, pcfg_cls, kw = MODELS[name]
    model = pcls.from_jax_params(pcfg_cls(**kw, **cfg_kw), params, device="cpu")
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    logits = model.forward(torch.from_numpy(ids))
    loss = causal_lm_loss(logits, torch.from_numpy(labels), shift=True)
    loss.backward()
    return loss.item(), {k: t.grad.numpy() for k, t in leaves.items()}


@pytest.mark.parametrize("recompute", (None,) + RECOMPUTE_GRANULARITIES)
def test_loss_and_grads_match_jax(jax_reference, recompute):
    name, params, ids, labels, want_loss, want_grads = jax_reference
    cfg_kw = {} if recompute is None else dict(recompute=True, recompute_granularity=recompute)
    loss, grads = _port_loss_and_grads(name, params, ids, labels, **cfg_kw)
    assert abs(loss - want_loss) <= LOSS_ATOL, (loss, want_loss)
    assert set(grads) == set(want_grads)
    for path, want in want_grads.items():
        err = np.abs(grads[path] - want).max()
        assert err <= GRAD_REL * np.abs(want).max(), (path, err, np.abs(want).max())


@pytest.mark.parametrize("granularity", RECOMPUTE_GRANULARITIES)
def test_recompute_modes_agree_exactly_in_loss(granularity):
    _jcls, pcls, _jcfg, pcfg_cls, kw = MODELS["qwen2"]
    ids, labels = _batch(kw["vocab_size"], seed=3)
    losses, grads = [], []
    for cfg_kw in ({}, dict(recompute=True, recompute_granularity=granularity)):
        model = pcls.init_random(pcfg_cls(**kw, **cfg_kw), seed=0, device="cpu", dtype=torch.float32)
        params = flatten_params(model.params)
        for p in params.values():
            p.requires_grad_(True)
        loss = causal_lm_loss(model.forward(torch.from_numpy(ids)), torch.from_numpy(labels), shift=True)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in params.items()})
    assert losses[0] == losses[1]
    # what the backward saves or recomputes reaches only the gradients
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


def test_unknown_recompute_granularity_raises():
    _jcls, pcls, _jcfg, pcfg_cls, kw = MODELS["llama"]
    model = pcls.init_random(pcfg_cls(**kw, recompute=True, recompute_granularity="save_everything"), seed=0,
                             device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="save_everything"):
        model.forward(torch.zeros(1, 8, dtype=torch.long))


def test_bf16_compute_over_fp32_masters():
    """compute_dtype bf16: logits in bf16, grads land on the fp32 masters and
    stay close to the fp32 run (bf16 rounding, loose bound)."""
    _jcls, pcls, _jcfg, pcfg_cls, kw = MODELS["qwen2"]
    ids, labels = _batch(kw["vocab_size"], seed=4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = pcls.init_random(pcfg_cls(**kw), seed=0, device="cpu", dtype=torch.float32)
        model.compute_dtype = dtype
        logits = model.forward(torch.from_numpy(ids))
        assert logits.dtype == dtype
        out[dtype] = causal_lm_loss(logits, torch.from_numpy(labels), shift=True).item()
    assert abs(out[torch.bfloat16] - out[torch.float32]) < 2e-2 * out[torch.float32]


def test_cross_entropy_matches_jax():
    from paddlenlp_tpu.ops.cross_entropy import cross_entropy_with_ignore as jax_ce

    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[1, 2:5] = -100
    want, n_want = jax_ce(jnp.asarray(logits), jnp.asarray(labels))
    got, n_got = cross_entropy_with_ignore(torch.from_numpy(logits), torch.from_numpy(labels))
    assert int(n_got) == int(n_want) == 18
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
