"""The port's alignment entry points against the JAX scripts.

``paddlenlp_tpu_torch.llm.alignment`` ``run_dpo``, ``run_rm`` and ``run_ppo``
``main`` beside ``llm/alignment/{dpo,rm,ppo}/run_*.py`` ``main`` on a tiny
local hub (a LLaMA saved by the JAX package, a ``WordLevel`` tokenizer, 24
preference rows through ``load_preference_rows``), fp32: the steps' losses
within rel 1e-5 and the trained weights within 1e-4 of their largest element
or 1e-5 (the JAX run spreads its batch over the suite's 8 virtual CPU
devices, so the port gets ``per_device_train_batch_size`` x 8, PPO's prompts
a round excepted). Each package initializes a reward model's ``score`` head
at load with its own generator, so ``run_rm`` is compared from the JAX run's
initialized classifier; ``run_ppo`` scores with the JAX ``run_rm``'s output.
"""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest

from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import PretrainedTokenizer as JTokenizer
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.llama.modeling import LlamaForSequenceClassification as JLlamaCls
from paddlenlp_tpu_torch.llm.alignment.dpo import run_dpo
from paddlenlp_tpu_torch.llm.alignment.ppo import run_ppo
from paddlenlp_tpu_torch.llm.alignment.rm import run_rm
from paddlenlp_tpu_torch.transformers import LlamaForSequenceClassification
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.trl import DPOTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
REL = 1e-5
LEAF, PARAM_ATOL = 1e-4, 1e-5  # trained leaves (see tests/test_torch_peft_train.py)


def _np(flat):
    return {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v) for k, v in flat.items()}


def _steps(logs):
    return [h for h in logs if "grad_norm" in h]


def _close_leaves(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=max(LEAF * float(np.abs(w).max()), PARAM_ATOL),
                                   err_msg=k)


def _check_pair(jt, pt, n_steps):
    j, p = _steps(jt.state.log_history), _steps(pt.state.log_history)
    assert len(j) == len(p) == n_steps
    for a, b in zip(p, j):
        assert a["loss"] == pytest.approx(b["loss"], rel=REL), (a, b)
    _close_leaves(_np(flatten_params(pt.model.params)), _np(jflatten(jax.device_get(jt.train_state.params))))


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("PDNLP_TPU_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def _load_jax_script(name, *parts):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(REPO, *parts))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve their annotations through it
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    root = tmp_path_factory.mktemp("hub")
    model_dir = root / "tiny-llama"
    cfg = JLlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64, eos_token_id=2,
                       pad_token_id=0)
    JLlama.from_config(cfg, seed=0).save_pretrained(str(model_dir))
    words = "a b c d e f g h i j k l m n o p".split()
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, **{w: i + 4 for i, w in enumerate(words)}}
    t = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = Whitespace()
    JTokenizer(tokenizer_object=t, pad_token="<pad>", bos_token="<s>", eos_token="</s>",
               unk_token="<unk>").save_pretrained(str(model_dir))
    data = root / "pref"
    data.mkdir()
    rng = np.random.default_rng(0)
    rows = [{"src": " ".join(rng.choice(words, int(rng.integers(2, 5)))),
             "chosen": " ".join(rng.choice(words, int(rng.integers(1, 5)))),
             "rejected": " ".join(rng.choice(words, int(rng.integers(1, 5))))} for _ in range(24)]
    (data / "train.json").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return {"root": root, "model": model_dir, "data": data}


def _run_both(hub, tmp_path, name, parts, port_main, args):
    jmain = _load_jax_script(name, *parts).main
    out = {}
    for who, batch in (("jax", 1), ("port", JAX_DEVICES if name != "run_ppo" else 1)):
        path = tmp_path / f"{who}.json"
        path.write_text(json.dumps(dict(args(who), output_dir=str(tmp_path / who), per_device_train_batch_size=batch)))
        if who == "jax":
            argv, sys.argv = sys.argv, [f"{name}.py", str(path)]
            try:
                out[who] = jmain()
            finally:
                sys.argv = argv
        else:
            out[who] = port_main([str(path)], device="cpu")
    return out


COMMON = dict(max_steps=2, logging_steps=1, save_strategy="no", do_train=True, dtype="float32", learning_rate=1e-3,
              warmup_steps=1, seed=0)


@pytest.fixture(scope="module")
def rm_dirs(hub, tmp_path_factory):
    d = tmp_path_factory.mktemp("rm")
    runs = _run_both(hub, d, "run_rm", ("llm", "alignment", "rm", "run_rm.py"), run_rm.main,
                     lambda who: dict(COMMON, model_name_or_path=str(hub["model"]),
                                      dataset_name_or_path=str(hub["data"]), max_length=12, max_prompt_length=6))
    return d, runs


def test_run_dpo_main_matches_jax(hub, tmp_path):
    runs = _run_both(hub, tmp_path, "run_dpo", ("llm", "alignment", "dpo", "run_dpo.py"), run_dpo.main,
                     lambda who: dict(COMMON, model_name_or_path=str(hub["model"]),
                                      dataset_name_or_path=str(hub["data"]), max_length=12, max_prompt_length=6))
    _check_pair(runs["jax"], runs["port"], 2)
    assert isinstance(runs["port"], DPOTrainer) and os.path.isfile(tmp_path / "port" / "model.safetensors")


def test_run_rm_main_matches_jax(rm_dirs):
    d, runs = rm_dirs
    # the score head is initialized at load in each package: the port carries JAX's over and reruns
    assert type(runs["port"].model) is LlamaForSequenceClassification
    assert os.path.isfile(d / "port" / "model.safetensors") and os.path.isfile(d / "jax" / "model.safetensors")
    j, p = _steps(runs["jax"].state.log_history), _steps(runs["port"].state.log_history)
    assert len(j) == len(p) == 2 and all(np.isfinite(h["loss"]) for h in p)


def test_run_rm_main_with_the_jax_head_matches_jax(hub, rm_dirs, tmp_path):
    """The JAX run's starting weights (its initialized head included) given
    to both mains: the same steps."""
    d, runs = rm_dirs
    start = tmp_path / "start"
    JLlamaCls.from_pretrained(str(hub["model"]), num_labels=1).save_pretrained(str(start))
    for f in ("tokenizer.json", "tokenizer_config.json"):
        (start / f).write_bytes((hub["model"] / f).read_bytes())
    runs = _run_both(hub, tmp_path, "run_rm", ("llm", "alignment", "rm", "run_rm.py"), run_rm.main,
                     lambda who: dict(COMMON, model_name_or_path=str(start), dataset_name_or_path=str(hub["data"]),
                                      max_length=12, max_prompt_length=6))
    _check_pair(runs["jax"], runs["port"], 2)


def test_run_ppo_main_matches_jax(hub, rm_dirs, tmp_path):
    d, _ = rm_dirs
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    (prompts / "train.json").write_text((hub["data"] / "train.json").read_text())
    runs = _run_both(hub, tmp_path, "run_ppo", ("llm", "alignment", "ppo", "run_ppo.py"), run_ppo.main,
                     lambda who: dict(COMMON, max_steps=1, model_name_or_path=str(hub["model"]),
                                      reward_model_name_or_path=str(d / "jax"), dataset_name_or_path=str(prompts),
                                      max_prompt_length=8, max_new_tokens=4, num_rollouts_per_prompt=2))
    _close_leaves(_np(flatten_params(runs["port"].model.params)),
                  _np(jflatten(jax.device_get(runs["jax"].train_state.params))))
    assert os.path.isfile(tmp_path / "port" / "model.safetensors")
