"""The port's trainer, schedules, data and checkpoint writer against the JAX package.

- ``Trainer``: 4 steps at fp32 on the toy dataset of ``tests/trainer/test_trainer.py``
  from the same initial parameters, in two runs (warmup + a binding
  ``max_grad_norm`` + weight decay + 2-way accumulation; no warmup, a clip that
  does not bind, no decay, a cosine schedule): per-step loss and grad_norm
  within atol 1e-5 (they are logged rounded to 6 decimals), final parameters
  within atol 1e-5: fp32 summation order only, but Adam normalizes each
  element's step, so an element whose gradient sits near zero can move by a
  sizeable share of lr (1e-3) differently; the worst element seen was 2.3e-6.
  The JAX run spreads its batch over this suite's 8 virtual CPU devices; the
  port runs one device with the same global batch.
- The LR schedules against optax's at every step (rel 1e-6: float64 here,
  float32 there).
- ``GPTDataset`` samples bitwise against the JAX package's, and the label
  double shift that ``GPTDataset`` + ``compute_loss(shift=True)`` make, pinned.
- ``PdArgumentParser`` on ``llm/config/qwen2/pretrain_argument.json``: the same
  field values as the JAX parser.
- ``save_pretrained`` from the port -> the JAX ``from_pretrained``: bitwise.
- ``run_pretrain.main`` end to end on the CPU at a tiny size.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.data import build_train_valid_test_datasets as jax_build_datasets
from paddlenlp_tpu.trainer import PdArgumentParser as JaxParser
from paddlenlp_tpu.trainer import Trainer as JaxTrainer
from paddlenlp_tpu.trainer import TrainingArguments as JaxArgs
from paddlenlp_tpu.trainer.trainer_utils import get_scheduler as jax_get_scheduler
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.data import MMapIndexedDatasetBuilder, build_train_valid_test_datasets
from paddlenlp_tpu_torch.llm import run_pretrain
from paddlenlp_tpu_torch.ops.cross_entropy import cross_entropy_with_ignore
from paddlenlp_tpu_torch.trainer import PdArgumentParser, Trainer, TrainingArguments
from paddlenlp_tpu_torch.trainer.trainer_utils import get_scheduler
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM, Qwen2ForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_ATOL = 1e-5
PARAM_ATOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards


class ToyLMDataset:
    """tests/trainer/test_trainer.py's deterministic token sequences."""

    def __init__(self, n=64, seq_len=16, vocab=128, seed=0):
        rng = np.random.default_rng(seed)
        base = rng.integers(2, vocab, size=(8, seq_len))
        self.data = base[rng.integers(0, 8, size=n)]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        ids = self.data[i].astype(np.int32)
        return {"input_ids": ids, "labels": ids.copy()}


RUNS = {
    "warmup-clip-decay-accum2": dict(warmup_steps=1, max_grad_norm=0.5, weight_decay=0.1, accum=2,
                                     lr_scheduler_type="linear"),
    "noclip-cosine": dict(warmup_steps=0, max_grad_norm=1e3, weight_decay=0.0, accum=1,
                          lr_scheduler_type="cosine"),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_trainer_matches_jax_trainer(tmp_path, run):
    o = RUNS[run]
    common = dict(learning_rate=1e-3, min_learning_rate=1e-4, max_steps=4, logging_steps=1, save_strategy="no",
                  seed=0, warmup_steps=o["warmup_steps"], max_grad_norm=o["max_grad_norm"],
                  weight_decay=o["weight_decay"], gradient_accumulation_steps=o["accum"],
                  lr_scheduler_type=o["lr_scheduler_type"], per_device_eval_batch_size=2)
    jm = JLlama.from_config(JLlamaConfig(**TINY), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**TINY), jax.device_get(jm.params), device="cpu")
    jt = JaxTrainer(model=jm, args=JaxArgs(output_dir=str(tmp_path / "jax"), per_device_train_batch_size=2,
                                           **common), train_dataset=ToyLMDataset(), eval_dataset=ToyLMDataset(n=16))
    pt = Trainer(model=pm, args=TrainingArguments(output_dir=str(tmp_path / "port"),
                                                  per_device_train_batch_size=2 * JAX_DEVICES, **common),
                 train_dataset=ToyLMDataset(), eval_dataset=ToyLMDataset(n=16))
    jt.train()
    pt.train()
    jlogs = [h for h in jt.state.log_history if "grad_norm" in h]
    plogs = [h for h in pt.state.log_history if "grad_norm" in h]
    assert len(jlogs) == len(plogs) == 4
    for j, p in zip(jlogs, plogs):
        assert abs(j["loss"] - p["loss"]) <= STEP_ATOL, (j, p)
        assert abs(j["grad_norm"] - p["grad_norm"]) <= STEP_ATOL, (j, p)
        assert j["learning_rate"] == pytest.approx(p["learning_rate"], rel=1e-6)
    want = flatten_params(jax.device_get(jt.model.params))
    got = flatten_params(pm.params)
    for path, w in want.items():
        np.testing.assert_allclose(got[path].detach().numpy(), np.asarray(w), atol=PARAM_ATOL, rtol=0,
                                   err_msg=path)
    # evaluate(): the same mean loss over the eval set
    jeval = jt.evaluate()["eval_loss"]
    peval = pt.evaluate()["eval_loss"]
    assert abs(jeval - peval) <= STEP_ATOL


@pytest.mark.parametrize("name", ["linear", "cosine", "polynomial", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_match_optax(name, warmup):
    kw = dict(learning_rate=3e-4, num_warmup_steps=warmup, num_training_steps=20, min_lr=3e-5)
    want = jax_get_scheduler(name, **kw)
    got = get_scheduler(name, **kw)
    for step in range(25):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-12), step
    if warmup:
        assert got(0) == 0.0  # the first update under warmup has learning rate 0


def _corpus(prefix, n_docs=40, seed=0, vocab=151936):
    rng = np.random.default_rng(seed)
    b = MMapIndexedDatasetBuilder(prefix, dtype=np.int32)
    for _ in range(n_docs):
        b.add_document(rng.integers(0, vocab, rng.integers(5, 60)))
    b.finalize()


def test_gpt_dataset_bitwise_and_the_label_double_shift(tmp_path):
    prefix = str(tmp_path / "corpus")
    _corpus(prefix)
    kw = dict(seq_length=32, train_valid_test_num_samples=(12, 4, 0), splits_string="80,20,0", seed=7)
    ours = build_train_valid_test_datasets(prefix, cache_dir=str(tmp_path / "port-cache"), **kw)
    theirs = jax_build_datasets(prefix, cache_dir=str(tmp_path / "jax-cache"), **kw)
    for split in range(2):
        assert len(ours[split]) == len(theirs[split])
        for i in range(len(ours[split])):
            a, b = ours[split][i], theirs[split][i]
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (split, i, key)
    # the samples already hold next-token labels, and compute_loss shifts once
    # more (shift=True): position t is trained on token t + 2 (ROADMAP Queue 3)
    sample = ours[0][0]
    assert np.array_equal(sample["labels"][:-1], sample["input_ids"][1:])
    cfg = LlamaConfig(**{**TINY, "vocab_size": 151936, "hidden_size": 32, "intermediate_size": 32,
                         "num_attention_heads": 2, "num_key_value_heads": 1})
    model = LlamaForCausalLM.init_random(cfg, seed=0, device="cpu", dtype=torch.float32)
    trainer = Trainer(model=model, args=TrainingArguments(output_dir=str(tmp_path / "o"), save_strategy="no"))
    batch = {k: torch.from_numpy(np.stack([ours[0][i][k] for i in range(2)])) for k in sample}
    with torch.no_grad():
        loss = trainer.compute_loss(batch)
        logits = model.forward(batch["input_ids"])
    tokens = torch.cat([batch["input_ids"], batch["labels"][:, -1:]], dim=1)  # the T + 1 sampled tokens
    two_ahead, _ = cross_entropy_with_ignore(logits[:, :-1], tokens[:, 2:])
    one_ahead, _ = cross_entropy_with_ignore(logits, batch["labels"])
    assert loss.item() == two_ahead.item()
    assert loss.item() != one_ahead.item()


def _jax_run_pretrain():
    spec = importlib.util.spec_from_file_location("_jax_run_pretrain", os.path.join(REPO, "llm", "run_pretrain.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve their annotations through it
    spec.loader.exec_module(mod)
    return mod


def test_argparser_reads_the_qwen2_recipe_like_jax():
    path = os.path.join(REPO, "llm", "config", "qwen2", "pretrain_argument.json")
    jr = _jax_run_pretrain()
    want = JaxParser((jr.ModelArguments, jr.DataArguments, jr.PreTrainingArguments)).parse_json_file(path)
    got = PdArgumentParser((run_pretrain.ModelArguments, run_pretrain.DataArguments,
                            run_pretrain.PreTrainingArguments)).parse_json_file(path)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w), type(g).__name__
    assert got[2].sharding_stage == want[2].sharding_stage == 2
    # the recipe's 8-way layout is not part of the port yet
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12"):
        got[2].check_supported()


def test_save_pretrained_loads_bitwise_in_jax(tmp_path):
    model = LlamaForCausalLM.init_random(LlamaConfig(**TINY), seed=3, device="cpu", dtype=torch.float32)
    model.save_pretrained(str(tmp_path), max_shard_size=200_000)  # several shards + an index
    assert os.path.isfile(tmp_path / "model.safetensors.index.json")
    jm = JLlama.from_pretrained(str(tmp_path), dtype="float32", param_dtype="float32")
    want = flatten_params(model.params)
    got = flatten_params(jax.device_get(jm.params))
    assert set(got) == set(want)
    for path in want:
        assert np.array_equal(np.asarray(got[path]), want[path].numpy()), path
    again = LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    for path, t in flatten_params(again.params).items():
        assert torch.equal(t, want[path]), path


@pytest.mark.parametrize("change,item", [(dict(tensor_parallel_degree=2), 12), (dict(attention_dropout=0.1), 15)],
                         ids=["tp", "dropout"])
def test_trainer_options_outside_the_slice_raise(tmp_path, change, item):
    cfg = {k: v for k, v in change.items() if k == "attention_dropout"}
    model = LlamaForCausalLM.init_random(LlamaConfig(**TINY, **cfg), seed=0, device="cpu", dtype=torch.float32)
    args = dict(output_dir=str(tmp_path), max_steps=4, per_device_train_batch_size=8, save_strategy="no")
    args.update({k: v for k, v in change.items() if k not in cfg})
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}"):
        Trainer(model=model, args=TrainingArguments(**args), train_dataset=ToyLMDataset()).train()


def test_run_pretrain_main_on_cpu(tmp_path):
    """The slice end to end at a tiny size: JSON -> config dir -> corpus ->
    Trainer.train -> save_model, then the checkpoint loads."""
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.json").write_text(json.dumps(dict(
        model_type="qwen2", vocab_size=2048, hidden_size=32, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=1e6, tie_word_embeddings=True)))
    _corpus(str(tmp_path / "data" / "corpus"), n_docs=60, vocab=2048)
    args = dict(model_name_or_path=str(model_dir), input_dir=str(tmp_path / "data"), output_dir=str(tmp_path / "out"),
                max_seq_length=32, per_device_train_batch_size=2, gradient_accumulation_steps=2, max_steps=2,
                warmup_steps=1, learning_rate=1e-3, save_steps=100, logging_steps=1, do_train=True, bf16=True,
                dtype="bfloat16", recompute=True, recompute_granularity="save_qkv_attn", seed=1)
    (tmp_path / "args.json").write_text(json.dumps(args))
    trainer = run_pretrain.main([str(tmp_path / "args.json")], device="cpu")
    assert trainer.state.global_step == 2
    losses = [h["loss"] for h in trainer.state.log_history if "grad_norm" in h]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert trainer.model.compute_dtype == torch.bfloat16 and trainer.model.config.recompute
    saved = Qwen2ForCausalLM.from_pretrained(str(tmp_path / "out"), device="cpu")
    for path, t in flatten_params(saved.params).items():
        assert torch.equal(t, flatten_params(trainer.model.params)[path].detach()), path
