"""The unrolled layer tree (``use_scan_layers=False``: ``model/layers_{i}``)
of the port's LLaMA graph against the JAX package and the scanned tree.

For llama and qwen2 (as the JAX ``use_scan_layers=False`` tests,
``tests/transformers/test_llama.py:206-249``): a JAX model built unrolled
loads through ``from_jax_params`` with the JAX logits; the same weights in
the scanned tree (loaded from the unrolled model's HF checkpoint) give the
same logits and every gradient leaf bit for bit, layer by layer, and the same
``model.safetensors`` tensors under the same HF keys; greedy ``generate``
ids are the scanned model's; the JAX package's own save of the unrolled
model has the port's bytes and loads into the port's unrolled tree bit for
bit. The paged engine refuses an unrolled tree with the
JAX engine's ``ValueError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers import Qwen2ForCausalLM as JQwen2
from paddlenlp_tpu_torch.experimental import InferenceEngine
from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM, Qwen2Config, Qwen2ForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.utils.safetensors_io import load_file

torch.set_num_threads(1)

TINY = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64, eos_token_id=None, pad_token_id=0)
FAMILIES = {"llama": (JLlama, JLlamaConfig, LlamaForCausalLM, LlamaConfig),
            "qwen2": (JQwen2, JQwen2Config, Qwen2ForCausalLM, Qwen2Config)}


def _grads(model, ids, labels):
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = causal_lm_loss(model.forward(ids), labels, shift=True)
    loss.backward()
    grads = {k: t.grad for k, t in leaves.items()}
    for t in leaves.values():
        t.requires_grad_(False)
        t.grad = None
    return loss.item(), grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_unrolled_tree_matches_jax_and_the_scanned_tree(family, tmp_path):
    jcls, jcfg_cls, pcls, pcfg_cls = FAMILIES[family]
    jm = jcls.from_config(jcfg_cls(use_scan_layers=False, **TINY), seed=0)
    rng = np.random.default_rng(1)
    jm.params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape), x.dtype),
                             jm.params)
    unrolled = pcls.from_jax_params(pcfg_cls(use_scan_layers=False, **TINY), jax.device_get(jm.params), device="cpu")
    assert "layers_2" in unrolled.params["model"] and "layers" not in unrolled.params["model"]
    ids = np.random.default_rng(2).integers(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    want = np.asarray(jm(input_ids=jnp.asarray(ids)).logits)
    tid = torch.from_numpy(ids).long()
    got = unrolled(tid)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)

    # the same weights in the scanned tree, through the HF layout both trees share
    unrolled.save_pretrained(str(tmp_path / "unrolled"))
    scan = pcls.from_pretrained(str(tmp_path / "unrolled"), device="cpu", use_scan_layers=True)
    assert "layers" in scan.params["model"]
    assert torch.equal(scan(tid), got)
    with torch.no_grad():
        assert torch.equal(scan.forward(tid), unrolled.forward(tid))
    labels = torch.from_numpy(np.roll(ids, 1, axis=1)).long()
    loss_s, grads_s = _grads(scan, tid, labels)
    loss_u, grads_u = _grads(unrolled, tid, labels)
    assert loss_s == loss_u
    for path, g in grads_u.items():
        if "/layers_" in path:
            i, rest = path.split("/layers_")[1].split("/", 1)
            g_s = grads_s[f"model/layers/{rest}"][int(i)]
        else:
            g_s = grads_s[path]
        assert torch.equal(g, g_s), path
    scan.save_pretrained(str(tmp_path / "scanned"))
    saved = [load_file(str(tmp_path / d / "model.safetensors")) for d in ("scanned", "unrolled")]
    assert sorted(saved[0]) == sorted(saved[1])  # one key a layer in both; the trees order them differently
    assert all(np.array_equal(saved[0][k], saved[1][k]) for k in saved[0])
    prompts = np.array([[5, 6, 7, 8], [40, 41, 42, 43]], np.int32)
    assert unrolled.generate(prompts, max_new_tokens=5)[0].tolist() == \
        scan.generate(prompts, max_new_tokens=5)[0].tolist()

    # the JAX package's save of its unrolled model: the port's bytes, and it loads back bit for bit
    jm.save_pretrained(str(tmp_path / "jax"))
    assert (tmp_path / "jax" / "model.safetensors").read_bytes() == \
        (tmp_path / "unrolled" / "model.safetensors").read_bytes()
    again = pcls.from_pretrained(str(tmp_path / "jax"), device="cpu", use_scan_layers=False)
    for path, t in flatten_params(unrolled.params).items():
        assert torch.equal(flatten_params(again.params)[path], t), path


def test_paged_engine_refuses_an_unrolled_tree():
    model = LlamaForCausalLM.init_random(LlamaConfig(use_scan_layers=False, **TINY), seed=0, device="cpu",
                                         dtype=torch.float32)
    with pytest.raises(ValueError, match="scanned-layer param layout"):
        InferenceEngine(model, max_batch_size=2, block_size=4, num_blocks=16, max_blocks_per_seq=8)
