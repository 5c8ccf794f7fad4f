"""The port's DeepSeek-V2 (MLA, the grouped MoE, dense first layers) against the JAX package.

- MLA alone: the port's attention hook (``attn_rope``, ``attn_qkv``,
  ``attn_scale``, ``attn_output``) through the dispatcher against the JAX
  ``DeepseekV2Attention`` on the same weights and input, with
  ``q_lora_rank`` None and 24 and with YaRN: out to rel 1e-5, and the
  gradients of ``sum(out * r)`` to 1e-4 of each leaf's largest element.
- The MoE block alone (``deepseek_moe``) against the JAX ``DeepseekV2MoE``:
  greedy and ``group_limited_greedy``, ``norm_topk_prob`` on and off (and K 1,
  where it does not apply), ``routed_scaling_factor`` != 1, ``seq_aux`` on
  and off, shared experts on and off, a router tie: out and aux to rel 1e-5,
  the gradients of ``sum(out * r) + aux`` to 1e-4 of each leaf's largest;
  the per-expert loop the card holds the block to computes the same.
- The tiny model of ``tests/transformers/test_modeling_common.py``
  (unrolled: layer 0 dense, layer 1 grouped MoE) and a homogeneous scanned
  one, every leaf perturbed from a seed: logits and aux, the Trainer's loss
  (LM + aux) and every gradient against ``jax.value_and_grad``, the 8
  recompute granularities bit for bit with no recompute, greedy ``generate``
  ids equal to JAX's; the name mappings equal to JAX ``_get_name_mappings``;
  an HF-layout checkpoint written here (per-expert keys) loading to JAX's
  logits; ``save_pretrained`` byte for byte with JAX's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.ops.cross_entropy import causal_lm_loss as jax_causal_lm_loss
from paddlenlp_tpu.transformers import DeepseekV2Config as JDeepseekV2Config
from paddlenlp_tpu.transformers import DeepseekV2ForCausalLM as JDeepseekV2
from paddlenlp_tpu.transformers import DeepseekV2Model as JDeepseekV2Model
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.deepseek_v2.modeling import DeepseekV2Attention as JAttention
from paddlenlp_tpu.transformers.deepseek_v2.modeling import DeepseekV2MoE as JMoE
from paddlenlp_tpu.utils.safetensors_io import save_file as jsave_file
from paddlenlp_tpu_torch.experimental import InferenceEngine
from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
from paddlenlp_tpu_torch.ops.flash_attention import dot_product_attention
from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
from paddlenlp_tpu_torch.transformers import AutoModel, DeepseekV2Config, DeepseekV2ForCausalLM, DeepseekV2Model
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params
from paddlenlp_tpu_torch.transformers.deepseek_v2.modeling import deepseek_moe, deepseek_moe_loop
from paddlenlp_tpu_torch.transformers.llama.modeling import RECOMPUTE_GRANULARITIES

torch.set_num_threads(1)

REL = 1e-5
GRAD_REL = 1e-4
YARN = {"type": "yarn", "factor": 2.0, "original_max_position_embeddings": 32, "mscale": 0.707,
        "mscale_all_dim": 0.707, "beta_fast": 32, "beta_slow": 1}
# tests/transformers/test_modeling_common.py:94-104 (its TINY: hidden 64, 2 layers, 4 heads)
TINY = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64,
            initializer_range=0.02, intermediate_size=112, moe_intermediate_size=48, q_lora_rank=24,
            kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=16, n_routed_experts=4,
            n_shared_experts=1, num_experts_per_tok=2, topk_method="group_limited_greedy", n_group=2, topk_group=1,
            first_k_dense_replace=1, routed_scaling_factor=1.0, norm_topk_prob=True, rope_scaling=YARN,
            eos_token_id=None, pad_token_id=0)
#: the two layouts: unrolled with a dense first layer, and a homogeneous scanned stack
MODELS = {"unrolled": dict(TINY), "scanned": dict(TINY, first_k_dense_replace=0, use_scan_layers=True,
                                                  topk_method="greedy", routed_scaling_factor=2.0, seq_aux=False)}


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


def _torch_leaves(params):
    return {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jflatten(params).items()}


def _io(tree):
    """A hook's (proj, leaf) over a nested dict of tensors."""
    def get(path):
        node = tree
        for k in path.split("/"):
            node = node[k]
        return node

    def proj(name, x):
        p = get(name)
        y = x @ p["kernel"]
        return y + p["bias"] if "bias" in p else y

    return proj, get


# ----------------------------------------------------------------------------- MLA alone
MLA_CASES = {"q_lora_none": dict(q_lora_rank=None, rope_scaling=None),
             "q_lora_24": dict(q_lora_rank=24, rope_scaling=None),
             "q_lora_24_yarn": dict(q_lora_rank=24, rope_scaling=YARN)}


@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_matches_jax(case):
    kw = dict(TINY, initializer_range=0.2, **MLA_CASES[case])
    jcfg, cfg = JDeepseekV2Config(**kw), DeepseekV2Config(**kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    r = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    module = JAttention(jcfg)
    params = jax.device_get(module.init(jax.random.key(0), jnp.asarray(x))["params"])

    def jax_loss(p, x):
        out, _ = module.apply({"params": p}, x)
        return jnp.sum(out * r), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    model = DeepseekV2ForCausalLM(cfg, {})
    leaves = _torch_leaves(params)
    assert {k: tuple(v.shape) for k, v in leaves.items()} == model.attn_param_shapes(cfg)
    xt = torch.tensor(x, requires_grad=True)
    proj, leaf = _io(unflatten_params(leaves))
    cos, sin = model.attn_rope(torch.arange(9)[None].expand(2, 9), "cpu")
    q, k, v = model.attn_qkv(xt, proj, leaf, cos, sin)
    assert q.shape[-1] == k.shape[-1] == v.shape[-1] == cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    out = proj("o_proj", model.attn_output(dot_product_attention(q, k, v, scale=model.attn_scale())))
    torch.sum(out * torch.from_numpy(r)).backward()
    _close(out.detach(), want, REL, "out")
    for path, g in jflatten(want_grads[0]).items():
        _close(leaves[path].grad, g, GRAD_REL, path)
    _close(xt.grad, want_grads[1], GRAD_REL, "x")


# ----------------------------------------------------------------------------- the MoE block alone
#: (topk_method, norm_topk_prob, routed_scaling_factor, seq_aux, n_shared_experts, top-k, tie)
MOE_CASES = {
    "greedy": ("greedy", False, 1.0, True, 2, 2, None),
    "greedy_norm_scaled": ("greedy", True, 2.5, True, 1, 3, None),
    "group_limited": ("group_limited_greedy", True, 1.0, True, 2, 2, None),
    "group_limited_batch_aux_unshared": ("group_limited_greedy", False, 16.0, False, None, 3, None),
    "k1_norm_batch_aux": ("greedy", True, 1.0, False, 1, 1, None),
    "tie_two_experts": ("greedy", True, 1.0, True, 1, 2, "two"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_jax(case):
    method, norm, scaling, seq_aux, shared, k, tie = MOE_CASES[case]
    kw = dict(TINY, hidden_size=16, moe_intermediate_size=24, n_routed_experts=8, n_group=4, topk_group=2,
              topk_method=method, norm_topk_prob=norm, routed_scaling_factor=scaling, seq_aux=seq_aux,
              n_shared_experts=shared, num_experts_per_tok=k, initializer_range=0.3, aux_loss_alpha=0.1)
    jcfg, cfg = JDeepseekV2Config(**kw), DeepseekV2Config(**kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    module = JMoE(jcfg)
    params = jax.device_get(module.init(jax.random.key(0), jnp.asarray(x))["params"])
    gate = np.array(params["gate"]["kernel"])
    if tie == "two":  # experts 1 and 2 tie on every token; the lower index wins where only one is kept
        gate[:, 2] = gate[:, 1]
    params["gate"]["kernel"] = gate

    def jax_loss(p, x):
        out, aux = module.apply({"params": p}, x)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (want_out, want_aux)), want_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    leaves = _torch_leaves(params)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = deepseek_moe(cfg, xt, *_io(unflatten_params(leaves)))
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    _close(out.detach(), want_out, REL, "out")
    assert abs(aux.item() - float(want_aux)) <= REL * abs(float(want_aux)), (aux.item(), float(want_aux))
    for path, g in jflatten(want_grads[0]).items():
        _close(leaves[path].grad, g, GRAD_REL, path)
    _close(xt.grad, want_grads[1], GRAD_REL, "x")
    if tie is None:  # the per-expert loop the card holds the block to computes the same
        flat = {p: torch.from_numpy(np.array(v)) for p, v in jflatten(params).items()}
        loop, loop_aux = deepseek_moe_loop(cfg, torch.from_numpy(x), flat)
        _close(loop, want_out, REL, "loop")
        assert abs(loop_aux.item() - float(want_aux)) <= REL * abs(float(want_aux))


# ----------------------------------------------------------------------------- the model, tiny
def _batch(vocab, seed=0, B=2, T=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


@pytest.fixture(scope="module", params=list(MODELS))
def reference(request):
    kw = MODELS[request.param]
    jm = JDeepseekV2.from_config(JDeepseekV2Config(**kw), seed=0)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape), x.dtype),
                          jm.params)
    ids, labels = _batch(kw["vocab_size"])

    def loss_fn(p):
        out = jm.module.apply({"params": p}, input_ids=jnp.asarray(ids), deterministic=True)
        return jax_causal_lm_loss(out.logits, jnp.asarray(labels), shift=True) + out.aux_loss, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pm = DeepseekV2ForCausalLM.from_jax_params(DeepseekV2Config(**kw), jax.device_get(params), device="cpu")
    jm.params = params
    return dict(layout=request.param, kw=kw, ids=ids, labels=labels, loss=float(loss), logits=np.asarray(out.logits),
                aux=float(out.aux_loss), pm=pm, jm=jm,
                grads={k: np.asarray(v) for k, v in jflatten(jax.device_get(grads)).items()})


def test_logits_and_aux_match_jax(reference):
    ref = reference
    pm = ref["pm"]
    assert ("layers" in pm.params["model"]) == (ref["layout"] == "scanned")
    ids = torch.from_numpy(ref["ids"]).long()
    _close(pm(ids), ref["logits"], REL, "plain call")
    with torch.no_grad():
        logits, aux = pm.forward(ids, return_aux=True)
    _close(logits, ref["logits"], REL, "forward")
    assert abs(aux.item() - ref["aux"]) <= REL * abs(ref["aux"]), (aux.item(), ref["aux"])
    with pytest.raises(NotImplementedError, match="generate"):  # the paged engine serves no MoE, as in JAX
        InferenceEngine(pm, max_batch_size=2, block_size=4, num_blocks=16, max_blocks_per_seq=8)


def test_trainer_loss_and_grads_match_jax(reference, tmp_path):
    ref = reference
    pm = ref["pm"]
    trainer = Trainer(model=pm, args=TrainingArguments(output_dir=str(tmp_path), save_strategy="no"))
    leaves = flatten_params(pm.params)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss = trainer.compute_loss({"input_ids": torch.from_numpy(ref["ids"]).long(),
                                     "labels": torch.from_numpy(ref["labels"]).long()})
        loss.backward()
        assert abs(loss.item() - ref["loss"]) <= REL * abs(ref["loss"]), (loss.item(), ref["loss"])
        assert set(ref["grads"]) == set(leaves)
        for path, want in ref["grads"].items():
            _close(leaves[path].grad, want, GRAD_REL, path)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None


def _port_grads(layout, **cfg_kw):
    model = DeepseekV2ForCausalLM.init_random(DeepseekV2Config(**MODELS[layout], **cfg_kw), seed=0, device="cpu",
                                              dtype=torch.float32)
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    ids, labels = _batch(model.config.vocab_size, seed=2)
    logits, aux = model.forward(torch.from_numpy(ids).long(), return_aux=True)
    loss = causal_lm_loss(logits, torch.from_numpy(labels).long(), shift=True) + aux
    loss.backward()
    return loss.item(), {k: t.grad for k, t in leaves.items()}


@pytest.mark.parametrize("granularity", RECOMPUTE_GRANULARITIES)
@pytest.mark.parametrize("layout", list(MODELS))
def test_recompute_granularities_give_the_same_bits(layout, granularity):
    loss0, grads0 = _port_grads(layout)
    loss1, grads1 = _port_grads(layout, recompute=True, recompute_granularity=granularity)
    assert loss0 == loss1
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_generate_greedy_ids_match_jax(reference):
    ref = reference
    prompts = np.array([[5, 6, 7, 8, 9, 10], [40, 41, 42, 43, 44, 45]], np.int32)
    want, _ = ref["jm"].generate(jnp.asarray(prompts), max_new_tokens=6)
    got, _ = ref["pm"].generate(prompts, max_new_tokens=6)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("layout", list(MODELS))
def test_name_mappings_equal_jax(layout):
    kw = MODELS[layout]
    jcfg, cfg = JDeepseekV2Config(**kw), DeepseekV2Config(**kw)
    jm = JDeepseekV2(jcfg)
    want = JDeepseekV2._get_name_mappings(jcfg, jflatten(jm.param_shapes))
    got = DeepseekV2ForCausalLM._get_name_mappings(cfg, DeepseekV2ForCausalLM.param_shapes(cfg))

    def key(m):
        names = m.source_names() if hasattr(m, "source_names") else [m.source_name]
        return m.target_name, tuple(names), m.action, tuple(getattr(m, "dims", None) or ())

    assert sorted(map(key, got)) == sorted(map(key, want))
    assert {k: tuple(v.shape) for k, v in jflatten(jm.param_shapes).items()} == DeepseekV2ForCausalLM.param_shapes(cfg)


def test_hf_checkpoint_loads_to_jax_logits_and_saves_byte_for_byte(tmp_path):
    """An HF-layout checkpoint (per-expert ``mlp.experts.{e}`` keys, MLA
    projections, ``[out, in]`` kernels) of the unrolled tiny model, written
    here from perturbed JAX weights, loads into the port with the JAX model's
    logits (and the backbone behind ``AutoModel`` with its hidden states),
    and both packages' ``save_pretrained`` write the same bytes."""
    kw = MODELS["unrolled"]
    jm = JDeepseekV2.from_config(JDeepseekV2Config(**kw), seed=0)
    jm.params = jax.tree.map(lambda x: x * 1.25, jm.params)
    tensors = {}
    for path, arr in jflatten(jax.device_get(jm.params)).items():
        arr = np.asarray(arr)
        tail = path.rsplit("/", 1)[-1]
        if "/mlp/" in path and "/shared_experts/" not in path and tail in ("gate_proj", "up_proj", "down_proj"):
            i = path.split("/layers_")[1].split("/")[0]
            for e in range(arr.shape[0]):
                tensors[f"model.layers.{i}.mlp.experts.{e}.{tail}.weight"] = np.ascontiguousarray(arr[e].T)
            continue
        key = path.replace("/layers_", "/layers.").replace("/", ".")
        key = key.replace(".kernel", ".weight").replace(".scale", ".weight").replace(".embedding", ".weight")
        tensors[key] = np.ascontiguousarray(arr.T) if path.endswith("/kernel") else arr
    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(dict(kw, model_type="deepseek_v2",
                                                    architectures=["DeepseekV2ForCausalLM"])))
    jsave_file(tensors, str(hf / "model.safetensors"), metadata={"format": "np"})
    ids, _ = _batch(kw["vocab_size"])
    ref = np.asarray(jm(input_ids=jnp.asarray(ids)).logits)
    pm = DeepseekV2ForCausalLM.from_pretrained(str(hf), device="cpu")
    jm = JDeepseekV2.from_pretrained(str(hf), dtype="float32", param_dtype="float32")
    want = np.asarray(jm(input_ids=jnp.asarray(ids)).logits)
    _close(want, ref, REL, "JAX from the HF checkpoint")
    _close(pm(torch.from_numpy(ids).long()), want, REL, "port from the HF checkpoint")
    jm.save_pretrained(str(tmp_path / "jax"))
    pm.save_pretrained(str(tmp_path / "port"))
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_backbone_matches_jax():
    """``DeepseekV2Model`` (``AutoModel``'s ``base``) from the JAX backbone's
    tree: its hidden states equal the JAX model's ``last_hidden_state``."""
    kw = MODELS["unrolled"]
    jm = JDeepseekV2Model.from_config(JDeepseekV2Config(**kw), seed=0)
    jm.params = jax.tree.map(lambda x: x * 1.25, jm.params)
    pm = DeepseekV2Model.from_jax_params(DeepseekV2Config(**kw), jax.device_get(jm.params), device="cpu")
    assert AutoModel._model_class("deepseek_v2") is DeepseekV2Model
    ids, _ = _batch(kw["vocab_size"])
    want = np.asarray(jm(input_ids=jnp.asarray(ids)).last_hidden_state)
    _close(pm(torch.from_numpy(ids).long()), want, REL, "backbone")
