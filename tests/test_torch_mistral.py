"""The dense forward's sliding window, and ``mistral``, against the JAX package.

- A tiny Qwen2 with ``use_sliding_window=True``, ``sliding_window=4`` and
  ``max_window_layers=2`` (the window on every layer), carried into the port
  with ``from_jax_params``: the plain ``__call__`` (no cache, no mask) at a
  prompt of 12 tokens, longer than the window, within 1e-5 of the JAX
  model's logits, as are the masked and training forwards; a window wider
  than the prompt leaves the plain call's bits as they are without one.
- The paged engines take no window, in either package
  (``paddlenlp_tpu/experimental/inference_model.py``): both engines give one
  greedy stream, and both packages' ``generate`` (the windowed dense
  forward) another. The streams are pinned.
- ``mistral`` (window 4 of a 12-token prompt): the causal LM's plain,
  masked and training logits, the backbone's hidden states (``AutoModel``)
  and the classifier's logits against the JAX models', the engine's streams
  equal to the JAX engine's, and the Auto classes' picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental import InferenceEngine as JEngine
from paddlenlp_tpu.experimental import SamplingParams as JSamplingParams
from paddlenlp_tpu.transformers import MistralConfig as JMistralConfig
from paddlenlp_tpu.transformers import MistralForCausalLM as JMistral
from paddlenlp_tpu.transformers import MistralModel as JMistralModel
from paddlenlp_tpu.transformers import Qwen2Config as JQwen2Config
from paddlenlp_tpu.transformers import Qwen2ForCausalLM as JQwen2
from paddlenlp_tpu.transformers.mistral import MistralForSequenceClassification as JMistralCls
from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.transformers import (AutoConfig, AutoModel, AutoModelForCausalLM, MistralConfig,
                                              MistralForCausalLM, MistralForSequenceClassification, MistralModel,
                                              Qwen2Config, Qwen2ForCausalLM)

torch.set_num_threads(1)

ATOL = 1e-5
TINY = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
WINDOWED_QWEN2 = dict(TINY, use_sliding_window=True, sliding_window=4, max_window_layers=2)
ENGINE = dict(max_batch_size=4, block_size=4, num_blocks=64, max_blocks_per_seq=16)
PROMPT = list(range(5, 17))  # 12 tokens: three windows
ENGINE_STREAM = [80, 35, 92, 83, 9, 0, 36, 66]  # the paged engines: no window
GENERATE_STREAM = [81, 66, 66, 28, 5, 45, 0, 22]  # the dense forward: the window


def _ids(rows=(PROMPT,)):
    return np.asarray(rows, np.int32)


@pytest.fixture(scope="module")
def windowed_qwen2():
    jm = JQwen2.from_config(JQwen2Config(use_scan_layers=True, **WINDOWED_QWEN2), seed=0)
    pm = Qwen2ForCausalLM.from_jax_params(Qwen2Config(**WINDOWED_QWEN2), jax.device_get(jm.params), device="cpu")
    assert pm.config.sliding_window == 4
    return jm, pm


def test_plain_call_applies_the_window(windowed_qwen2):
    jm, pm = windowed_qwen2
    ids = _ids()
    want = np.asarray(jm(input_ids=jnp.asarray(ids)).logits)
    np.testing.assert_allclose(pm(torch.from_numpy(ids).long()).numpy(), want, atol=ATOL, rtol=0)
    mask = torch.ones(ids.shape, dtype=torch.long)
    np.testing.assert_allclose(pm(torch.from_numpy(ids).long(), attention_mask=mask).numpy(), want, atol=ATOL,
                               rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(pm.forward(torch.from_numpy(ids).long()).numpy(), want, atol=ATOL, rtol=0)
    # the window is what moves the logits: without it they sit far from the JAX model's
    unwindowed = Qwen2ForCausalLM(Qwen2Config(**TINY), pm.params)
    plain = unwindowed(torch.from_numpy(ids).long())
    assert np.abs(plain.numpy() - want).max() > 0.1
    # a window wider than the prompt masks nothing: the bits of the call without one
    wide = Qwen2ForCausalLM(Qwen2Config(**dict(WINDOWED_QWEN2, sliding_window=len(PROMPT))), pm.params)
    assert torch.equal(wide(torch.from_numpy(ids).long()), plain)


def test_engines_take_no_window_generate_does(windowed_qwen2):
    jm, pm = windowed_qwen2
    assert JEngine(jm, **ENGINE).generate([PROMPT], JSamplingParams(max_new_tokens=8)) == [ENGINE_STREAM]
    assert InferenceEngine(pm, **ENGINE).generate([PROMPT], SamplingParams(max_new_tokens=8)) == [ENGINE_STREAM]
    want, _ = jm.generate(jnp.asarray(_ids()), max_new_tokens=8)
    got, _ = pm.generate(_ids(), max_new_tokens=8)
    assert np.asarray(want).tolist() == got.tolist() == [GENERATE_STREAM]


# ----------------------------------------------------------------------------- mistral
MISTRAL = dict(TINY, sliding_window=4)


@pytest.fixture(scope="module")
def mistral():
    jm = JMistral.from_config(JMistralConfig(use_scan_layers=True, **MISTRAL), seed=1)
    pm = MistralForCausalLM.from_jax_params(MistralConfig(**MISTRAL), jax.device_get(jm.params), device="cpu")
    return jm, pm


def test_mistral_logits_match_jax(mistral):
    jm, pm = mistral
    ids = _ids([PROMPT, PROMPT[::-1]])
    mask = np.ones(ids.shape, np.int32)
    mask[1, :3] = 0  # a left-padded row
    want = np.asarray(jm(input_ids=jnp.asarray(ids)).logits)
    want_masked = np.asarray(jm(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).logits)
    t = torch.from_numpy(ids).long()
    np.testing.assert_allclose(pm(t).numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pm(t, attention_mask=torch.from_numpy(mask)).numpy(), want_masked, atol=ATOL, rtol=0)
    with torch.no_grad():
        np.testing.assert_allclose(pm.forward(t).numpy(), want, atol=ATOL, rtol=0)
    assert np.abs(want_masked[1] - want[1]).max() > 0.01  # the mask reaches the last rows: inside their window


def test_mistral_engine_streams_match_jax(mistral):
    jm, pm = mistral
    prompts = [PROMPT, [40, 41, 42, 43, 44, 45], PROMPT[3:]]
    want = JEngine(jm, **ENGINE).generate(prompts, JSamplingParams(max_new_tokens=8))
    got = InferenceEngine(pm, **ENGINE).generate(prompts, SamplingParams(max_new_tokens=8))
    assert got == want


def test_mistral_auto_classes_backbone_and_classifier(mistral, tmp_path):
    jm, pm = mistral
    cfg = MistralConfig(**MISTRAL)
    assert type(AutoModelForCausalLM.from_config(cfg, device="cpu")) is MistralForCausalLM
    pm.save_pretrained(str(tmp_path))
    assert type(AutoConfig.from_pretrained(str(tmp_path))) is MistralConfig
    again = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert type(again) is MistralForCausalLM and again.config.sliding_window == 4
    ids = _ids([PROMPT])
    # the backbone (AutoModel's base task): the causal model's trunk at the root of its tree
    jbase = JMistralModel.from_config(JMistralConfig(use_scan_layers=True, **MISTRAL), seed=2)
    base = AutoModel.from_config(cfg, device="cpu")
    assert type(base) is MistralModel and set(base.params) == {"embed_tokens", "layers", "norm"}
    base = MistralModel.from_jax_params(cfg, jax.device_get(jbase.params), device="cpu")
    want = np.asarray(jbase(input_ids=jnp.asarray(ids)).last_hidden_state)
    np.testing.assert_allclose(base(torch.from_numpy(ids).long()).numpy(), want, atol=ATOL, rtol=0)
    # the classifier (the JAX module has it; its registry does not)
    ccfg = dict(MISTRAL, num_labels=3)
    jcls = JMistralCls.from_config(JMistralConfig(use_scan_layers=True, **ccfg), seed=3)
    pcls = MistralForSequenceClassification.from_jax_params(MistralConfig(**ccfg), jax.device_get(jcls.params),
                                                            device="cpu")
    want = np.asarray(jcls(input_ids=jnp.asarray(ids)).logits)
    np.testing.assert_allclose(pcls(torch.from_numpy(ids).long()).numpy(), want, atol=ATOL, rtol=0)
