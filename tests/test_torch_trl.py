"""The port's alignment trainers (``trl/``, ``llm/alignment/``) against the JAX package.

All fp32, on tiny LLaMA models built by the JAX package and carried across:

- ``DPOCriterion``: every ``loss_type`` (sigmoid, with label smoothing too,
  hinge, ipo, kto_pair, simpo, orpo) and its four metrics within 1e-6 of the
  JAX criterion on the same log-probabilities; ``sequence_logps`` within
  rel 1e-6.
- ``DPOTrainer``: sigmoid and simpo, 2 steps each against the JAX trainer
  (the JAX run spreads its batch over the suite's 8 virtual CPU devices, so
  the port gets ``per_device_train_batch_size`` x 8): losses rel 1e-5 (the
  sigmoid's first is ln 2: policy and reference are the same weights),
  trained leaves within 1e-4 of their largest element or 1e-5.
- ``LlamaForSequenceClassification`` and the Qwen2 one: logits under right
  padding within rel 1e-5; ``AutoModelForSequenceClassification`` loads a
  causal checkpoint with the ``score`` head initialized. ``RewardTrainer``:
  2 steps against the JAX trainer.
- PPO: ``token_logps`` and ``gae_advantages`` against the JAX functions;
  2 GRPO rounds scored by a reward model, the rollout tokens exact (the
  second from the updated policy), rewards, advantages, losses (1e-6 where
  the surrogate is ~0) and gradient norms within rel 1e-5; one value-model
  round (GAE, the value loss) the same way.

The entry points' ``main`` are in ``tests/test_torch_alignment_main.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.trainer import TrainingArguments as JArgs
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.llama.modeling import LlamaForSequenceClassification as JLlamaCls
from paddlenlp_tpu.transformers.qwen2 import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers.qwen2.modeling import Qwen2ForSequenceClassification as JQwen2Cls
from paddlenlp_tpu.trl import DPOCriterion as JDPOCriterion
from paddlenlp_tpu.trl import DPOTrainer as JDPOTrainer
from paddlenlp_tpu.trl import PPOConfig as JPPOConfig
from paddlenlp_tpu.trl import PPOTrainer as JPPOTrainer
from paddlenlp_tpu.trl import RewardTrainer as JRewardTrainer
from paddlenlp_tpu.trl import sequence_logps as jsequence_logps
from paddlenlp_tpu.trl.ppo_trainer import gae_advantages as jgae
from paddlenlp_tpu.trl.ppo_trainer import token_logps as jtoken_logps
from paddlenlp_tpu_torch.trainer import TrainingArguments
from paddlenlp_tpu_torch.transformers import (AutoModelForSequenceClassification, LlamaConfig, LlamaForCausalLM,
                                              LlamaForSequenceClassification, Qwen2Config,
                                              Qwen2ForSequenceClassification)
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.trl import DPOCriterion, DPOTrainer, PPOConfig, PPOTrainer, RewardTrainer, sequence_logps
from paddlenlp_tpu_torch.trl.ppo_trainer import gae_advantages, token_logps

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=2, pad_token_id=0)
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
REL = 1e-5
CRIT = 1e-6  # the criterion on the same log-probabilities
LEAF, PARAM_ATOL = 1e-4, 1e-5  # trained leaves (see tests/test_torch_peft_train.py)
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, logging_steps=1, seed=0, max_grad_norm=1.0)


def _np(flat):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v) for k, v in flat.items()}


def _steps(logs):
    return [h for h in logs if "grad_norm" in h]


def _close_leaves(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=max(LEAF * float(np.abs(w).max()), PARAM_ATOL),
                                   err_msg=k)


@functools.lru_cache(maxsize=None)
def _init_weights(jcls, jcfg_cls, seed, **cfg):
    """``jcls.from_config``'s random weights, drawn once a module (as host
    arrays): a JAX init compiles anew for every model it builds."""
    return jax.device_get(jcls.from_config(jcfg_cls(**MODEL_KW, **cfg), seed=seed).params)


def _jax_model(jcls, jcfg_cls, seed, **cfg):
    """A fresh ``jcls.from_config(jcfg_cls(...), seed=seed)``: its own model
    object over its own device copy of the module's weights for that seed."""
    weights = _init_weights(jcls, jcfg_cls, seed, **cfg)
    return jcls(jcfg_cls(**MODEL_KW, **cfg), params=jax.tree_util.tree_map(jnp.array, weights)), weights


def _causal(seed=0):
    jm, weights = _jax_model(JLlama, JLlamaConfig, seed)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), weights, device="cpu")
    return jm, pm


def _classifier(seed=1, num_labels=1, qwen=False):
    jcls, pcls = (JQwen2Cls, Qwen2ForSequenceClassification) if qwen else (JLlamaCls, LlamaForSequenceClassification)
    jm, weights = _jax_model(jcls, JQwen2Config if qwen else JLlamaConfig, seed, num_labels=num_labels)
    pcfg = (Qwen2Config if qwen else LlamaConfig)(num_labels=num_labels, **MODEL_KW)
    return jm, pcls.from_jax_params(pcfg, weights, device="cpu")


# ----------------------------------------------------------------------------- DPO criterion
def _logps(seed=0, B=6):
    rng = np.random.default_rng(seed)
    out = [(-rng.uniform(5, 40, B)).astype(np.float32) for _ in range(4)]
    lengths = [rng.integers(1, 30, B).astype(np.int32) for _ in range(2)]
    return out, lengths


@pytest.mark.parametrize("loss_type,smoothing", [("sigmoid", 0.0), ("sigmoid", 0.1), ("hinge", 0.0), ("ipo", 0.0),
                                                 ("kto_pair", 0.0), ("simpo", 0.0), ("orpo", 0.0)])
def test_dpo_criterion_matches_jax(loss_type, smoothing):
    logps, lengths = _logps()
    if loss_type == "orpo":  # average log-probs near 0, where the odds ratio is steep
        logps = [lp / 40 for lp in logps]
    jloss, jm = JDPOCriterion(beta=0.2, loss_type=loss_type, label_smoothing=smoothing)(
        *map(jnp.asarray, logps), *map(jnp.asarray, lengths))
    loss, m = DPOCriterion(beta=0.2, loss_type=loss_type, label_smoothing=smoothing)(
        *map(torch.from_numpy, logps), *map(torch.from_numpy, lengths))
    assert float(loss) == pytest.approx(float(jloss), rel=CRIT, abs=CRIT)
    assert sorted(m) == sorted(jm)
    for k in jm:
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=CRIT, abs=CRIT), k
    assert DPOCriterion(loss_type=loss_type).needs_reference == JDPOCriterion(loss_type=loss_type).needs_reference


def test_sequence_and_token_logps_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[:, :2] = -100
    np.testing.assert_allclose(sequence_logps(torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
                               np.asarray(jsequence_logps(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    got, valid = token_logps(torch.from_numpy(logits), torch.from_numpy(labels))
    want, jvalid = jtoken_logps(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))


def test_gae_advantages_match_jax():
    rng = np.random.default_rng(5)
    rewards = rng.standard_normal((4, 9)).astype(np.float32)
    values = rng.standard_normal((4, 9)).astype(np.float32)
    mask = (np.arange(9)[None] < rng.integers(2, 10, (4, 1))).astype(np.float32)
    mask[:, 0] = 0  # the prompt position
    got = gae_advantages(*(torch.from_numpy(x) for x in (rewards, values, mask)), 0.99, 0.95)
    want = jgae(*(jnp.asarray(x) for x in (rewards, values, mask)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------------- DPO trainer
def _pref_rows(n=32, T=12, seed=0):
    """Preference rows as ``load_preference_rows`` makes them: a shared
    prompt, -100 labels over it and the padding."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        prompt = rng.integers(3, MODEL_KW["vocab_size"], int(rng.integers(2, 6))).astype(np.int32)
        row = {}
        for side in ("chosen", "rejected"):
            resp = rng.integers(3, MODEL_KW["vocab_size"], int(rng.integers(2, T - len(prompt) + 1))).astype(np.int32)
            ids = np.concatenate([prompt, resp])
            pad = T - len(ids)
            row[f"{side}_input_ids"] = np.pad(ids, (0, pad))
            row[f"{side}_labels"] = np.pad(np.concatenate([np.full(len(prompt), -100, np.int32), resp]), (0, pad),
                                           constant_values=-100)
            row[f"{side}_attention_mask"] = (np.arange(T) < len(ids)).astype(np.int32)
        rows.append(row)
    return rows


def _pair(jcls, pcls, jmodel, pmodel, rows, out, max_steps, **kw):
    jinit = _np(jflatten(jax.device_get(jmodel.params)))
    jt = jcls(model=jmodel, train_dataset=rows, args=JArgs(output_dir=str(out / "jax"), max_steps=max_steps,
                                                            per_device_train_batch_size=1, **TRAIN), **kw)
    jt.train()
    pt = pcls(model=pmodel, train_dataset=rows, args=TrainingArguments(
        output_dir=str(out / "port"), max_steps=max_steps, per_device_train_batch_size=JAX_DEVICES, **TRAIN), **kw)
    pt.train()
    return jt, pt, jinit


def _check_pair(jt, pt, n_steps):
    j, p = _steps(jt.state.log_history), _steps(pt.state.log_history)
    assert len(j) == len(p) == n_steps
    for a, b in zip(p, j):
        assert a["loss"] == pytest.approx(b["loss"], rel=REL), (a, b)
    _close_leaves(_np(flatten_params(pt.model.params)), _np(jflatten(jax.device_get(jt.train_state.params))))


@pytest.mark.parametrize("loss_type", ["sigmoid", "simpo"])
def test_dpo_trainer_matches_jax(tmp_path, loss_type):
    rows = [{k: v for k, v in r.items() if "mask" not in k} for r in _pref_rows()]
    jm, pm = _causal()
    jt, pt, jinit = _pair(JDPOTrainer, DPOTrainer, jm, pm, rows, tmp_path, 2, loss_type=loss_type, beta=0.1)
    _check_pair(jt, pt, 2)
    if loss_type == "sigmoid":  # step 1: the policy is the reference
        assert _steps(pt.state.log_history)[0]["loss"] == pytest.approx(math.log(2), abs=1e-6)
        for k, v in flatten_params(pt.ref_params).items():  # the reference stayed frozen
            np.testing.assert_array_equal(v.numpy(), jinit[k], err_msg=k)
    else:
        assert pt.ref_params is None


# ----------------------------------------------------------------------------- sequence classification
@pytest.mark.parametrize("qwen", [False, True], ids=["llama", "qwen2"])
def test_sequence_classification_logits_match_jax(qwen):
    jm, pm = _classifier(num_labels=3, qwen=qwen)
    rows = _pref_rows(n=4, seed=7)
    ids = np.stack([r["chosen_input_ids"] for r in rows])
    mask = np.stack([r["chosen_attention_mask"] for r in rows])
    for m in (mask, None):
        want = np.asarray(jm(input_ids=jnp.asarray(ids), attention_mask=None if m is None else jnp.asarray(m)).logits)
        got = pm(torch.from_numpy(ids), attention_mask=None if m is None else torch.from_numpy(m)).numpy()
        assert got.shape == (4, 3)
        np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())


def test_auto_sequence_classification_loads_a_causal_checkpoint(tmp_path):
    jm, pm = _causal()
    pm.save_pretrained(str(tmp_path))
    cls = AutoModelForSequenceClassification.from_pretrained(str(tmp_path), device="cpu", num_labels=1)
    assert type(cls) is LlamaForSequenceClassification
    flat, causal = flatten_params(cls.params), flatten_params(pm.params)
    assert flat["score/kernel"].shape == (MODEL_KW["hidden_size"], 1) and "lm_head/kernel" not in flat
    for k, v in flat.items():
        if k != "score/kernel":
            assert torch.equal(v, causal[k]), k


def test_reward_trainer_matches_jax(tmp_path):
    jm, pm = _classifier()
    rows = [{k: v for k, v in r.items() if "labels" not in k} for r in _pref_rows()]
    jt, pt, _ = _pair(JRewardTrainer, RewardTrainer, jm, pm, rows, tmp_path, 2)
    _check_pair(jt, pt, 2)


# ----------------------------------------------------------------------------- PPO
def _prompts(n=4, seed=11):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(3, MODEL_KW["vocab_size"], int(rng.integers(4, 9))).astype(np.int32)}
            for _ in range(n)]


def _record(trainer, update_name, jax_side):
    """Wrap the trainer's rollout, score and update to keep each round's
    values."""
    rec = {"batch": [], "rewards": [], "adv": [], "loss": [], "grad_norm": [], "vloss": []}
    rollout, score, update = trainer.rollout, trainer._score, getattr(trainer, update_name)

    def _rollout(prompts):
        b = rollout(prompts)
        rec["batch"].append(b)
        return b

    def _score(*a):
        r = score(*a)
        rec["rewards"].append(np.asarray(r))
        return r

    def _update(*a):
        adv = a[-1]
        out = update(*a)
        rec["adv"].append(np.asarray(adv.detach() if isinstance(adv, torch.Tensor) else adv))
        metrics = out[1] if jax_side else out
        rec["loss"].append(float(metrics["loss"]))
        rec["grad_norm"].append(float(metrics["grad_norm"]))
        return out

    trainer.rollout, trainer._score = _rollout, _score
    setattr(trainer, update_name, _update)
    if getattr(trainer.ppo_config, "use_value_model", False):
        vupdate = trainer._value_update

        def _vupdate(*a):
            out = vupdate(*a)
            rec["vloss"].append(float(out[2] if jax_side else out))
            return out

        trainer._value_update = _vupdate
    return rec


def _ppo_pair(tmp_path, rounds, reward=None, **cfg):
    jm, pm = _causal()
    ppo = dict(num_rollouts_per_prompt=4, max_new_tokens=6, max_prompt_length=16, **cfg)
    kw = {}
    if reward == "model":
        jr, pr = _classifier()
        kw = dict(jax=dict(reward_model=jr), port=dict(reward_model=pr))
    else:
        fn = lambda ids, labels: float(np.mean(np.asarray(ids)[np.asarray(labels) != -100] % 3 == 0))  # noqa: E731
        kw = dict(jax=dict(reward_fn=fn), port=dict(reward_fn=fn))
    args = dict(max_steps=rounds, per_device_train_batch_size=2, learning_rate=1e-3, warmup_steps=0, seed=0)
    jt = JPPOTrainer(model=jm, train_dataset=_prompts(), ppo_config=JPPOConfig(**ppo),
                     args=JArgs(output_dir=str(tmp_path / "jax"), **args), **kw["jax"])
    pt = PPOTrainer(model=pm, train_dataset=_prompts(), ppo_config=PPOConfig(**ppo),
                    args=TrainingArguments(output_dir=str(tmp_path / "port"), **args), **kw["port"])
    if cfg.get("use_value_model"):  # jax.random's head bits: carry it across
        pt.value_params["value_head"]["kernel"].copy_(torch.from_numpy(
            np.array(jt.value_params["value_head"]["kernel"])))
    jrec, prec = _record(jt, "_ppo_update", True), _record(pt, "_ppo_update", False)
    jt.train()
    pt.train()
    return jt, pt, jrec, prec


def _check_rounds(jrec, prec, rounds):
    assert len(jrec["batch"]) == len(prec["batch"]) == rounds
    for r in range(rounds):
        for k in ("input_ids", "labels", "attention_mask"):
            assert np.array_equal(prec["batch"][r][k], jrec["batch"][r][k]), (r, k)
        np.testing.assert_allclose(prec["rewards"][r], jrec["rewards"][r], rtol=REL, atol=REL)
        np.testing.assert_allclose(prec["adv"][r], jrec["adv"][r], rtol=REL, atol=REL * np.abs(jrec["adv"][r]).max())
        # at ratio 1 the surrogate sums normalized advantages to ~0: its
        # rounding is that of a sum of O(1) terms; the gradient is not ~0
        assert prec["loss"][r] == pytest.approx(jrec["loss"][r], rel=REL, abs=1e-6)
        assert prec["grad_norm"][r] == pytest.approx(jrec["grad_norm"][r], rel=REL)


def test_ppo_grpo_rounds_match_jax(tmp_path):
    jt, pt, jrec, prec = _ppo_pair(tmp_path, 2, reward="model")
    _check_rounds(jrec, prec, 2)
    assert (jrec["batch"][0]["labels"] != -100).sum() > 0 and np.std(prec["rewards"][0]) > 0
    # round 2 rolled out the updated policy: the engine's logits are the live weights'
    assert pt._engine is not None and pt.state.global_step == 2
    _close_leaves(_np(flatten_params(pt.model.params)), _np(jflatten(jax.device_get(jt.train_state.params))))


def test_ppo_value_model_round_matches_jax(tmp_path):
    jt, pt, jrec, prec = _ppo_pair(tmp_path, 1, use_value_model=True)
    _check_rounds(jrec, prec, 1)
    assert prec["vloss"][0] == pytest.approx(jrec["vloss"][0], rel=REL)
    _close_leaves(_np(flatten_params(pt.value_params)), _np(jflatten(jax.device_get(jt.value_params))))
