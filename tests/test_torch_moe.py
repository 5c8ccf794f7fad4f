"""The port's MoE block and its families (mixtral, qwen2_moe) against the JAX package.

- ``moe_layers.moe_mlp`` against the JAX ``MoEMLP`` on the same weights and
  input: the dense dispatch, the sparse one with and without drops,
  ``norm_topk_prob`` on and off, the qwen2-moe shared expert, and router
  ties (the JAX top-k takes the lower expert index). Out and aux to rel
  1e-5 (fp32), and the gradients of ``sum(out * r) + aux`` against
  ``jax.value_and_grad`` to 1e-4 of each leaf's largest element.
- ``mixtral_tiny`` (the HF golden checkpoint): logits against
  ``golden_logits.npz`` at the JAX package's own gate
  (``tests/transformers/test_golden_parity.py``), ``save_pretrained`` byte
  for byte with the JAX package's save, and the name mappings equal to the
  JAX ``_get_name_mappings``.
- Tiny mixtral and qwen2_moe under both dispatches, every leaf perturbed
  from a seed: logits and aux against the JAX model's, and the Trainer's
  loss (LM + aux, ``Trainer.compute_loss``) and gradients against
  ``jax.value_and_grad`` of the JAX trainer's loss (``trainer.py:277-279``);
  the 8 recompute granularities' gradients equal to no recompute bit for
  bit; greedy ``generate`` ids equal to the JAX ``generate``'s (the cached
  forward runs the block).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.ops.cross_entropy import causal_lm_loss as jax_causal_lm_loss
from paddlenlp_tpu.transformers import MixtralConfig as JMixtralConfig
from paddlenlp_tpu.transformers import MixtralForCausalLM as JMixtral
from paddlenlp_tpu.transformers import Qwen2MoeConfig as JQwen2MoeConfig
from paddlenlp_tpu.transformers import Qwen2MoeForCausalLM as JQwen2Moe
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.moe_layers import MoEMLP as JMoEMLP
from paddlenlp_tpu_torch.experimental import InferenceEngine
from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
from paddlenlp_tpu_torch.transformers import MixtralConfig, MixtralForCausalLM, Qwen2MoeConfig, Qwen2MoeForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params
from paddlenlp_tpu_torch.transformers.llama.modeling import RECOMPUTE_GRANULARITIES
from paddlenlp_tpu_torch.transformers.moe_layers import moe_capacity, moe_mlp, moe_mlp_loop, route

torch.set_num_threads(1)

REL = 1e-5
GRAD_REL = 1e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "transformers", "golden", "mixtral_tiny")
TINY = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64, eos_token_id=None, pad_token_id=0)
FAMILIES = {
    "mixtral": (JMixtral, JMixtralConfig, MixtralForCausalLM, MixtralConfig,
                dict(num_local_experts=4, router_aux_loss_coef=0.05)),
    "qwen2_moe": (JQwen2Moe, JQwen2MoeConfig, Qwen2MoeForCausalLM, Qwen2MoeConfig,
                  dict(num_experts=4, moe_intermediate_size=24, shared_expert_intermediate_size=40,
                       router_aux_loss_coef=0.05)),
}


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-30), (what, err, np.abs(want).max())


# ----------------------------------------------------------------------------- the block alone
class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(dict(num_local_experts=4, num_experts_per_tok=2, hidden_size=16,
                                  moe_intermediate_size=24, initializer_range=0.3, router_aux_loss_coef=0.1), **kw)


#: (dispatch, capacity factor, norm_topk_prob, shared expert, router tie)
BLOCK_CASES = {
    "dense": ("dense", 2.0, True, 0, None),
    "dense_unnormed_shared": ("dense", 2.0, False, 20, None),
    "sparse_no_drops": ("sparse", 2.0, True, 0, None),
    "sparse_drops_shared": ("sparse", 0.5, True, 20, None),
    "sparse_drops_unnormed": ("sparse", 0.5, False, 0, None),
    "tie_two_experts": ("dense", 2.0, True, 0, "two"),
    "tie_all_sparse_drops": ("sparse", 0.75, True, 0, "all"),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_jax(case):
    dispatch, cf, norm, shared, tie = BLOCK_CASES[case]
    cfg = _Cfg(moe_dispatch=dispatch, moe_capacity_factor=cf, norm_topk_prob=norm,
               shared_expert_intermediate_size=shared)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    module = JMoEMLP(cfg)
    params = jax.device_get(module.init(jax.random.key(0), jnp.asarray(x))["params"])
    gate = np.array(params["gate"]["kernel"])
    if tie == "two":  # experts 1 and 2 tie on every token; the lower index wins where only one is kept
        gate[:, 2] = gate[:, 1]
    elif tie == "all":  # every expert ties: experts 0 and 1 take every token, and their buffers overflow
        gate[:] = gate[:, :1]
    params["gate"]["kernel"] = gate

    def jax_loss(p, x):
        out, aux = module.apply({"params": p}, x)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (want_out, want_aux)), want_grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jflatten(params).items()}
    tree = unflatten_params(leaves)
    xt = torch.tensor(x, requires_grad=True)

    def leaf(path):
        node = tree
        for k in path.split("/"):
            node = node[k]
        return node

    out, aux = moe_mlp(cfg, xt, lambda name, h: h @ tree[name]["kernel"], leaf)
    (torch.sum(out * torch.from_numpy(r)) + aux).backward()
    _close(out.detach(), want_out, REL, "out")
    assert abs(aux.item() - float(want_aux)) <= REL * abs(float(want_aux)), (aux.item(), float(want_aux))
    for path, g in jflatten(want_grads[0]).items():
        _close(leaves[path].grad, g, GRAD_REL, path)
    _close(xt.grad, want_grads[1], GRAD_REL, "x")

    # the case covers what its name says: drops, or none; ties broken to the lower index
    N, E, K = x.shape[0] * x.shape[1], cfg.num_local_experts, cfg.num_experts_per_tok
    _, _, idx = route(torch.from_numpy(x.reshape(N, -1)) @ torch.from_numpy(gate), K, norm)
    per_expert = torch.bincount(idx.reshape(-1), minlength=E)
    if dispatch == "sparse":
        dropped = int((per_expert - moe_capacity(N, E, K, cf)).clamp_min(0).sum())
        assert (dropped > 0) == ("drops" in case and "no_drops" not in case), dropped
    if not shared and tie is None and (dispatch == "dense" or "no_drops" in case):
        # the per-expert loop the card holds both dispatches to computes the same block
        experts = [torch.tensor(np.asarray(params[n])) for n in ("w1", "w3", "w2")]
        loop, loop_aux = moe_mlp_loop(cfg, torch.from_numpy(x), torch.from_numpy(gate), *experts)
        _close(loop, want_out, REL, "loop")
        assert abs(loop_aux.item() - float(want_aux)) <= REL * abs(float(want_aux))
    if tie == "all":
        assert idx.tolist() == [[0, 1]] * N
    elif tie == "two":  # where the tie sits at the k-th place, expert 1 is kept and 2 dropped
        has1, has2 = (idx == 1).any(1), (idx == 2).any(1)
        assert not (has2 & ~has1).any() and (has1 & ~has2).any()


# ----------------------------------------------------------------------------- mixtral_tiny, the HF checkpoint
def test_mixtral_tiny_golden_logits_and_save_byte_for_byte(tmp_path):
    data = np.load(os.path.join(GOLDEN, "golden_logits.npz"))
    pm = MixtralForCausalLM.from_pretrained(GOLDEN, device="cpu")
    got = pm(torch.from_numpy(data["input_ids"]).long()).numpy()
    np.testing.assert_allclose(got, data["logits"], atol=2e-4, rtol=2e-3)  # test_golden_parity.py's gate
    jm = JMixtral.from_pretrained(GOLDEN, use_scan_layers=True, dtype="float32", param_dtype="float32")
    jm.save_pretrained(str(tmp_path / "jax"))
    pm.save_pretrained(str(tmp_path / "port"))
    for f in ("model.safetensors", "config.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    # the HF keys are the golden file's, and the port loads its own save bit for bit
    again = MixtralForCausalLM.from_pretrained(str(tmp_path / "port"), device="cpu")
    for path, t in flatten_params(pm.params).items():
        assert torch.equal(flatten_params(again.params)[path], t), path


@pytest.mark.parametrize("family", list(FAMILIES))
def test_name_mappings_equal_jax(family):
    jcls, jcfg_cls, pcls, pcfg_cls, kw = FAMILIES[family]
    jcfg = jcfg_cls(use_scan_layers=True, **TINY, **kw)
    jm = jcls(jcfg)
    want = jcls._get_name_mappings(jcfg, jflatten(jm.param_shapes))
    cfg = pcfg_cls(**TINY, **kw)
    got = pcls._get_name_mappings(cfg, pcls.param_shapes(cfg))

    def key(m):
        names = m.source_names() if hasattr(m, "source_names") else [m.source_name]
        return m.target_name, tuple(names), m.action, tuple(getattr(m, "dims", None) or ())

    assert sorted(map(key, got)) == sorted(map(key, want))
    assert {k: tuple(v.shape) for k, v in jflatten(jm.param_shapes).items()} == pcls.param_shapes(cfg)


# ----------------------------------------------------------------------------- the families, tiny
def _batch(vocab, seed=0, B=2, T=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, T)).astype(np.int32)
    labels[0, :3] = -100
    return ids, labels


@pytest.fixture(scope="module", params=[(f, d) for f in FAMILIES for d in ("dense", "sparse")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def reference(request):
    family, dispatch = request.param
    jcls, jcfg_cls, pcls, pcfg_cls, kw = FAMILIES[family]
    # capacity 0.75: the sparse runs drop assignments
    cfg_kw = dict(TINY, moe_dispatch=dispatch, moe_capacity_factor=0.75, **kw)
    jm = jcls.from_config(jcfg_cls(use_scan_layers=True, **cfg_kw), seed=0)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: jnp.asarray(np.asarray(x) + 0.05 * rng.standard_normal(x.shape), x.dtype),
                          jm.params)
    ids, labels = _batch(cfg_kw["vocab_size"])

    def loss_fn(p):
        out = jm.module.apply({"params": p}, input_ids=jnp.asarray(ids), deterministic=True)
        return jax_causal_lm_loss(out.logits, jnp.asarray(labels), shift=True) + out.aux_loss, out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pm = pcls.from_jax_params(pcfg_cls(**cfg_kw), jax.device_get(params), device="cpu")
    jm.params = params
    return dict(family=family, cfg_kw=cfg_kw, params=jax.device_get(params), ids=ids, labels=labels, loss=float(loss),
                logits=np.asarray(out.logits), aux=float(out.aux_loss), pm=pm, jm=jm,
                grads={k: np.asarray(v) for k, v in jflatten(jax.device_get(grads)).items()})


def test_logits_and_aux_match_jax(reference):
    ref = reference
    pm = ref["pm"]
    ids = torch.from_numpy(ref["ids"]).long()
    _close(pm(ids), ref["logits"], REL, "plain call")
    with torch.no_grad():
        logits, aux = pm.forward(ids, return_aux=True)
    _close(logits, ref["logits"], REL, "forward")
    assert abs(aux.item() - ref["aux"]) <= REL * abs(ref["aux"]), (aux.item(), ref["aux"])
    with pytest.raises(NotImplementedError, match="generate"):
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


def _port_grads(family, **cfg_kw):
    _jcls, _jcfg, pcls, pcfg_cls, kw = FAMILIES[family]
    cfg = pcfg_cls(**TINY, **kw, moe_dispatch="sparse", moe_capacity_factor=0.75, **cfg_kw)
    model = pcls.init_random(cfg, seed=0, device="cpu", dtype=torch.float32)
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    ids, labels = _batch(cfg.vocab_size, seed=2)
    logits, aux = model.forward(torch.from_numpy(ids).long(), return_aux=True)
    loss = causal_lm_loss(logits, torch.from_numpy(labels).long(), shift=True) + aux
    loss.backward()
    return loss.item(), {k: t.grad for k, t in leaves.items()}


@pytest.mark.parametrize("granularity", RECOMPUTE_GRANULARITIES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_recompute_granularities_give_the_same_bits(family, granularity):
    loss0, grads0 = _port_grads(family)
    loss1, grads1 = _port_grads(family, recompute=True, recompute_granularity=granularity)
    assert loss0 == loss1
    assert all(torch.equal(grads0[k], grads1[k]) for k in grads0)


def test_generate_greedy_ids_match_jax(reference):
    ref = reference
    prompts = np.array([[5, 6, 7, 8, 9, 10], [40, 41, 42, 43, 44, 45]], np.int32)
    want, _ = ref["jm"].generate(jnp.asarray(prompts), max_new_tokens=6)
    got, _ = ref["pm"].generate(prompts, max_new_tokens=6)
    assert got.tolist() == np.asarray(want).tolist()
