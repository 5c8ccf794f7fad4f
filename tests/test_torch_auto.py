"""The port's Auto classes and ``PretrainedModel`` against the JAX package.

- ``AutoConfig`` on the golden HF configs gives the JAX ``to_dict()``; the
  families ported since (``mixtral_tiny``, mistral and qwen2_moe configs)
  load as the JAX package loads them; the JAX registry's other families
  raise naming ROADMAP Queue 1 item 14e, and an unknown ``model_type``
  raises the JAX ``ValueError`` word for word.
- ``AutoModelForCausalLM.from_pretrained`` on the golden checkpoints: logits
  within atol 1e-4 of ``golden_logits.npz`` and of the JAX model's (fp32 on
  both sides: op order only).
- A sharded ``save_pretrained`` writes the JAX index and shard files byte for
  byte, and each package loads the other's bit for bit.
- A missing and an unexpected key are logged as the JAX package logs them,
  and ``generation_config.json`` loads.
- The keywords are pinned: ``dtype`` is the compute dtype and
  ``param_dtype`` the storage dtype, as in the JAX package.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.generation import GenerationConfig as JGenerationConfig
from paddlenlp_tpu.transformers import AutoConfig as JAutoConfig
from paddlenlp_tpu.transformers import AutoModelForCausalLM as JAuto
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.auto import configuration as jauto_cfg
from paddlenlp_tpu.transformers.auto import modeling as jauto_mod
from paddlenlp_tpu.transformers.model_utils import dtype_byte_size as j_dtype_byte_size
from paddlenlp_tpu.utils import log as jlog
from paddlenlp_tpu_torch.transformers import (AutoConfig, AutoModel, AutoModelForCausalLM, AutoModelForCausalLMPipe,
                                              AutoModelForSequenceClassification, LlamaConfig, LlamaForCausalLM,
                                              PretrainedModel, Qwen2Config, Qwen2ForCausalLM)
from paddlenlp_tpu_torch.transformers.auto import configuration as auto_cfg
from paddlenlp_tpu_torch.transformers.auto import modeling as auto_mod
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.transformers.model_utils import dtype_byte_size
from paddlenlp_tpu_torch.utils import log

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "transformers", "golden")
ATOL = 1e-4
TINY = dict(vocab_size=96, hidden_size=32, intermediate_size=48, num_hidden_layers=3, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64, eos_token_id=2, pad_token_id=0)


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("PDNLP_TPU_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.fixture(scope="module")
def jax_model():
    return JLlama.from_config(JLlamaConfig(use_scan_layers=True, **TINY), seed=0)


def test_registries_copy_the_jax_ones():
    jauto_cfg._populate()
    jauto_mod._populate_models()
    assert auto_cfg.JAX_MODEL_TYPES == tuple(jauto_cfg.CONFIG_MAPPING)
    assert auto_mod.JAX_MODEL_TASKS == {k: tuple(v) for k, v in jauto_mod._MODEL_MAPPING.items()}


@pytest.mark.parametrize("name", ["llama_tiny", "llama_gqa_tiny"])
def test_auto_config_matches_jax(name):
    fixture = os.path.join(GOLDEN, name)
    got, want = AutoConfig.from_pretrained(fixture), JAutoConfig.from_pretrained(fixture)
    assert type(got).__name__ == type(want).__name__ == "LlamaConfig"
    assert got.to_dict() == want.to_dict()
    assert got.to_json_string() == want.to_json_string()


#: config.json of families the JAX package has and the port does not, beside the goldens
UNPORTED = {"gemma": dict(model_type="gemma", **TINY)}


@pytest.mark.parametrize("name", ["gemma", "albert_tiny", "roberta_tiny"])
def test_other_families_raise_naming_14e(name, tmp_path):
    fixture = os.path.join(GOLDEN, name)
    if name in UNPORTED:
        (tmp_path / "config.json").write_text(json.dumps(UNPORTED[name]))
        fixture = str(tmp_path)
    JAutoConfig.from_pretrained(fixture)  # the JAX package has them
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14e"):
        AutoConfig.from_pretrained(fixture)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 14e"):
        AutoModelForCausalLM.from_pretrained(fixture, device="cpu")


#: the families ported after the golden Auto tests: a golden checkpoint or a config.json
PORTED = {"mixtral_tiny": None,
          "mistral": dict(model_type="mistral", sliding_window=5, **TINY),
          "qwen2_moe": dict(model_type="qwen2_moe", num_experts=4, moe_intermediate_size=24,
                            shared_expert_intermediate_size=40, **TINY),
          # MLA, a dense first layer, then the grouped MoE: the unrolled tree
          "deepseek_v2": dict(model_type="deepseek_v2", moe_intermediate_size=24, q_lora_rank=None, kv_lora_rank=16,
                              qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=16, n_routed_experts=4,
                              n_shared_experts=1, num_experts_per_tok=2, topk_method="group_limited_greedy",
                              n_group=2, topk_group=1, first_k_dense_replace=1,
                              **{k: v for k, v in TINY.items() if k != "num_key_value_heads"})}


@pytest.mark.parametrize("name", list(PORTED))
def test_ported_families_match_jax(name, tmp_path):
    """Each loads through the Auto classes into the family's class, with the
    JAX config's ``to_dict()`` and the JAX model's logits (fp32, atol 1e-4)."""
    if PORTED[name] is None:
        fixture = os.path.join(GOLDEN, name)
    else:
        (tmp_path / "config.json").write_text(json.dumps(PORTED[name]))
        jm = JAuto.from_config(JAutoConfig.from_pretrained(str(tmp_path)), seed=0)
        jm.save_pretrained(str(tmp_path))
        fixture = str(tmp_path)
    got, want = AutoConfig.from_pretrained(fixture), JAutoConfig.from_pretrained(fixture)
    assert type(got).__name__ == type(want).__name__ and got.to_dict() == want.to_dict()
    model = AutoModelForCausalLM.from_pretrained(fixture, device="cpu")
    jm = JAuto.from_pretrained(fixture, dtype="float32", param_dtype="float32")
    assert type(model).__name__ == type(jm).__name__ and model.num_parameters() == jm.num_parameters()
    ids = np.arange(3, 15, dtype=np.int32)[None] % got.vocab_size
    want_logits = np.asarray(jm(input_ids=jax.numpy.asarray(ids)).logits)
    np.testing.assert_allclose(model(torch.from_numpy(ids).long()).numpy(), want_logits, atol=ATOL, rtol=0)


def test_deepseek_v2_resolves_and_the_paged_engine_refuses_it(tmp_path):
    """``AutoConfig``, ``AutoModel`` (the backbone) and ``AutoModelForCausalLM``
    resolve ``deepseek_v2``; the paged engine refuses the model, as it
    refuses MoE (the JAX engine serves llama/qwen2/mistral only)."""
    from paddlenlp_tpu_torch.experimental import InferenceEngine

    (tmp_path / "config.json").write_text(json.dumps(PORTED["deepseek_v2"]))
    cfg = AutoConfig.from_pretrained(str(tmp_path))
    assert type(cfg).__name__ == "DeepseekV2Config" and cfg.use_scan_layers is False and cfg.head_dim == 16
    assert type(AutoModel.from_config(cfg, device="cpu")).__name__ == "DeepseekV2Model"
    model = AutoModelForCausalLM.from_config(cfg, device="cpu")
    assert type(model).__name__ == "DeepseekV2ForCausalLM" and "layers_0" in model.params["model"]
    with pytest.raises(NotImplementedError, match="generate"):
        InferenceEngine(model, max_batch_size=2, block_size=4, num_blocks=16, max_blocks_per_seq=8)


def test_unknown_model_type_and_tasks(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "nosuch", "architectures": ["NoSuchLM"]}))
    with pytest.raises(ValueError) as got:
        AutoConfig.from_pretrained(str(tmp_path))
    with pytest.raises(ValueError) as want:
        JAutoConfig.from_pretrained(str(tmp_path))
    assert str(got.value) == str(want.value)
    # no model_type: the architectures hint, as in the JAX package
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["Qwen2ForCausalLM"], "hidden_size": 32}))
    assert type(AutoConfig.from_pretrained(str(tmp_path))).__name__ == "Qwen2Config"
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["MistralForCausalLM"]}))
    got, want = AutoConfig.from_pretrained(str(tmp_path)), JAutoConfig.from_pretrained(str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == "MistralConfig" and got.to_dict() == want.to_dict()
    (tmp_path / "config.json").write_text(json.dumps({"architectures": ["GemmaForCausalLM"]}))
    with pytest.raises(NotImplementedError, match="item 14e"):
        AutoConfig.from_pretrained(str(tmp_path))
    cfg = LlamaConfig(**TINY)
    with pytest.raises(NotImplementedError, match="item 14e"):
        AutoModel.from_config(cfg, device="cpu")
    # the classifier is ported for llama and qwen2 (its parity is in tests/test_torch_trl.py)
    assert type(AutoModelForSequenceClassification.from_config(cfg, device="cpu")).__name__ == \
        "LlamaForSequenceClassification"
    with pytest.raises(NotImplementedError, match="items 15 and 12b"):
        AutoModelForCausalLMPipe.from_config(cfg)
    with pytest.raises(FileNotFoundError) as got:
        AutoConfig.from_pretrained("no/such-model")
    with pytest.raises(FileNotFoundError) as want:
        JAutoConfig.from_pretrained("no/such-model")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["llama_tiny", "llama_gqa_tiny"])
def test_auto_model_logits_match_golden_and_jax(name):
    fixture = os.path.join(GOLDEN, name)
    data = np.load(os.path.join(fixture, "golden_logits.npz"))
    model = AutoModelForCausalLM.from_pretrained(fixture, device="cpu")
    assert type(model) is LlamaForCausalLM and isinstance(model, PretrainedModel)
    got = model(torch.from_numpy(data["input_ids"])).numpy()
    np.testing.assert_allclose(got, data["logits"], atol=ATOL, rtol=0)
    jm = JAuto.from_pretrained(fixture, dtype="float32", param_dtype="float32")
    want = np.asarray(jm(input_ids=jax.numpy.asarray(data["input_ids"], jax.numpy.int32)).logits)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert model.num_parameters() == jm.num_parameters()


def test_qwen2_through_auto(tmp_path, jax_model):
    cfg = Qwen2Config(**TINY)
    model = AutoModelForCausalLM.from_config(cfg, seed=3, device="cpu")
    assert type(model) is Qwen2ForCausalLM and model.param_dtype == torch.float32
    model.save_pretrained(str(tmp_path))
    again = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert type(again) is Qwen2ForCausalLM
    for path, t in flatten_params(model.params).items():
        assert torch.equal(flatten_params(again.params)[path], t), path


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d)) if f.startswith("model")}


def test_sharded_save_matches_jax_byte_for_byte_and_cross_loads(tmp_path, jax_model):
    jm = jax_model
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**TINY), jax.device_get(jm.params), device="cpu")
    shard = 12_000
    jm.save_pretrained(str(tmp_path / "jax"), max_shard_size=shard)
    pm.save_pretrained(str(tmp_path / "port"), max_shard_size=shard)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert "model.safetensors.index.json" in got and len(got) > 3
    assert got.keys() == want.keys()
    for f in got:
        assert got[f] == want[f], f
    # each package loads the other's shards bit for bit
    from_jax = LlamaForCausalLM.from_pretrained(str(tmp_path / "jax"), device="cpu")
    for path, t in flatten_params(pm.params).items():
        assert torch.equal(flatten_params(from_jax.params)[path], t), path
    from_port = JLlama.from_pretrained(str(tmp_path / "port"), dtype="float32", param_dtype="float32")
    for path, leaf in flatten_params(jax.device_get(from_port.params)).items():
        assert np.array_equal(np.asarray(leaf), flatten_params(pm.params)[path].numpy()), path


def _capture_warnings(monkeypatch, logger):
    seen = []
    monkeypatch.setattr(logger, "warning", lambda msg, *a: seen.append(msg))
    return seen


def test_missing_and_unexpected_keys_are_logged_like_jax(tmp_path, monkeypatch, jax_model):
    from safetensors.numpy import load_file, save_file

    jax_model.save_pretrained(str(tmp_path))
    tensors = load_file(str(tmp_path / "model.safetensors"))
    del tensors["lm_head.weight"], tensors["model.layers.1.mlp.up_proj.weight"]
    tensors["extra.bias"] = np.zeros(3, np.float32)
    save_file(tensors, str(tmp_path / "model.safetensors"), metadata={"format": "np"})
    got, want = _capture_warnings(monkeypatch, log.logger), _capture_warnings(monkeypatch, jlog.logger)
    pm = LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    JLlama.from_pretrained(str(tmp_path))
    assert got == want and len(got) == 2, (got, want)
    # lm_head is initialized silently (_keys_to_ignore_on_load_missing), as in the JAX package
    assert "initializing missing params from scratch: ['model/layers/mlp/up_proj/kernel']" in got[0]
    assert "unexpected checkpoint keys ignored: ['extra.bias']" in got[1]
    assert pm.params["lm_head"]["kernel"].shape == (TINY["hidden_size"], TINY["vocab_size"])
    # the leaves the checkpoint has load as written
    assert np.array_equal(pm.params["model"]["embed_tokens"]["embedding"].numpy(),
                          tensors["model.embed_tokens.weight"])


def test_shape_mismatch_raises_like_jax(tmp_path, jax_model):
    jax_model.save_pretrained(str(tmp_path))
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["intermediate_size"] = 40
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    with pytest.raises(ValueError) as got:
        LlamaForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(ValueError) as want:
        JLlama.from_pretrained(str(tmp_path))
    assert str(got.value) == str(want.value)


def test_generation_config_loads(tmp_path, jax_model):
    jax_model.generation_config = JGenerationConfig(max_new_tokens=7, eos_token_id=2, do_sample=True,
                                                    temperature=0.5, top_k=3)
    try:
        jax_model.save_pretrained(str(tmp_path))
    finally:
        jax_model.generation_config = None
    pm = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    g = pm.generation_config
    assert (g.max_new_tokens, g.eos_token_id, g.do_sample, g.temperature, g.top_k) == (7, 2, True, 0.5, 3)
    pm.save_pretrained(str(tmp_path / "again"))
    assert json.loads((tmp_path / "again" / "generation_config.json").read_text())["max_new_tokens"] == 7


def test_dtype_keywords_are_pinned(tmp_path, jax_model):
    """``dtype`` = compute, ``param_dtype`` = storage, in both packages;
    both default to the checkpoint's ``config.dtype``."""
    jax_model.save_pretrained(str(tmp_path))
    pm = AutoModelForCausalLM.from_pretrained(str(tmp_path), dtype="bfloat16", param_dtype="float32", device="cpu")
    jm = JAuto.from_pretrained(str(tmp_path), dtype="bfloat16", param_dtype="float32")
    assert (pm.compute_dtype, pm.param_dtype) == (torch.bfloat16, torch.float32)
    assert (str(jm.dtype), str(jm.param_dtype)) == ("bfloat16", "float32")
    assert all(t.dtype == torch.float32 for t in flatten_params(pm.params).values())
    assert all(str(x.dtype) == "float32" for x in jax.tree.leaves(jm.params))
    ids = torch.arange(1, 9)[None]
    assert pm.forward(ids).dtype == torch.bfloat16
    pm = AutoModelForCausalLM.from_pretrained(str(tmp_path), dtype="float32", param_dtype="bfloat16", device="cpu")
    jm = JAuto.from_pretrained(str(tmp_path), dtype="float32", param_dtype="bfloat16")
    assert (pm.compute_dtype, pm.param_dtype) == (torch.float32, torch.bfloat16)
    assert (str(jm.dtype), str(jm.param_dtype)) == ("float32", "bfloat16")
    assert pm.forward(ids).dtype == torch.float32
    pm = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")  # config.json says float32
    assert (pm.compute_dtype, pm.param_dtype) == (torch.float32, torch.float32)
    pm = AutoModelForCausalLM.from_config(LlamaConfig(**TINY), dtype="bfloat16", param_dtype="bfloat16",
                                          device="cpu")
    assert (pm.compute_dtype, pm.param_dtype) == (torch.bfloat16, torch.bfloat16)
    for name in ("float32", "bfloat16", "float16", "int8"):
        assert dtype_byte_size(name) == j_dtype_byte_size(name), name
    with pytest.raises(ValueError, match="unknown dtype"):
        dtype_byte_size("float128x")
