"""The port's ``Trainer.compress`` exports, GPTQ and the NF4 format against the JAX package's.

Both trainers hold the same tiny LLaMA (the JAX tests' tiny config,
``tests/utils/test_quantization_depth.py``, stacked layout; the port's built
with ``from_jax_params``) and the same dataset. Held bit for bit:

- ``model_quant.safetensors`` of ``ptq`` (int8 and int4), ``a8w8`` and
  ``embedding_quant``: the same file, byte for byte; the fp reference
  ``model.safetensors`` tensor for tensor; the pruned exports of ``prune`` and
  ``prune_depth`` with their patched configs; ``dequantize_embedding``;
- ``gptq_quantize`` (a numpy copy) and ``nf4_quantize`` / ``nf4_dequantize``.

Within a stated tolerance (two fp32 forwards, differing in summation order):
``act_scales.json`` and ``collect_hessians`` (rel 1e-5); ``apply_gptq`` and
the GPTQ-calibrated export (the compensation amplifies the Hessians'
differences; see ``test_gptq_calibration_and_export``); the QAT finetune (the
adapted weights; their export is then held bit for bit to the JAX package's
quantization of the port's weights).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.quantization import QuantizationConfig as JQuantizationConfig
from paddlenlp_tpu.quantization import gptq as jgptq
from paddlenlp_tpu.quantization import qlora as jqlora
from paddlenlp_tpu.quantization import quantize_params as jquantize_params
from paddlenlp_tpu.trainer import Trainer as JTrainer
from paddlenlp_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlenlp_tpu.trainer.trainer_compress import dequantize_embedding as jdequantize_embedding
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.utils.safetensors_io import load_file
from paddlenlp_tpu_torch.quantization import gptq, qlora
from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
from paddlenlp_tpu_torch.trainer.trainer_compress import dequantize_embedding
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64)
ROWS = [np.random.default_rng(i).integers(3, 96, 12).astype(np.int32) for i in range(6)]


class DS:
    def __len__(self):
        return len(ROWS)

    def __getitem__(self, i):
        return {"input_ids": ROWS[i], "labels": ROWS[i].copy()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while this module runs;
    restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    jm = JLlama.from_config(JLlamaConfig(use_scan_layers=True, **MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    out = tmp_path_factory.mktemp("compress")
    return (JTrainer(model=jm, args=JTrainingArguments(output_dir=str(out / "jax")), train_dataset=DS()),
            Trainer(model=pm, args=TrainingArguments(output_dir=str(out / "port")), train_dataset=DS()))


def both(trainers, strategy, **kw):
    """(JAX export dir, port export dir) of one strategy."""
    return tuple(t.compress(strategy=strategy, **kw) for t in trainers)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_tensors(jdir, pdir, name="model.safetensors"):
    want, got = load_file(os.path.join(jdir, name)), load_file(os.path.join(pdir, name))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def config_of(d):
    with open(os.path.join(d, "config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("bits", [8, 4])
def test_ptq_export_bitwise(trainers, bits):
    jdir, pdir = both(trainers, "ptq", bits=bits)
    assert read(os.path.join(pdir, "model_quant.safetensors")) == read(os.path.join(jdir, "model_quant.safetensors"))
    assert_same_tensors(jdir, pdir)
    for key in ("num_hidden_layers", "intermediate_size", "hidden_size", "vocab_size"):
        assert config_of(pdir)[key] == config_of(jdir)[key]


def test_a8w8_export(trainers):
    """The int8 tree byte for byte; the calibration table's keys (unrolled
    kernel paths, the head included) equal and its values within rel 1e-5."""
    jdir, pdir = both(trainers, "a8w8", n_calib_batches=2)
    assert read(os.path.join(pdir, "model_quant.safetensors")) == read(os.path.join(jdir, "model_quant.safetensors"))
    assert_same_tensors(jdir, pdir)
    want = json.load(open(os.path.join(jdir, "act_scales.json")))
    got = json.load(open(os.path.join(pdir, "act_scales.json")))
    assert sorted(got) == sorted(want) and len(got) == 2 * 7 + 1
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), k


def test_embedding_quant_export_bitwise(trainers):
    jdir, pdir = both(trainers, "embedding_quant")
    assert read(os.path.join(pdir, "model_quant.safetensors")) == read(os.path.join(jdir, "model_quant.safetensors"))
    t = load_file(os.path.join(pdir, "model_quant.safetensors"))
    q, s = t["model/embed_tokens/qembedding"], t["model/embed_tokens/embed_scales"]
    want = np.asarray(jdequantize_embedding(jnp.asarray(q), jnp.asarray(s)))
    got = dequantize_embedding(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("strategy,kw,key,value", [("prune", dict(width_mult=0.5), "intermediate_size", 56),
                                                   ("prune_depth", dict(depth_mult=0.5), "num_hidden_layers", 1)])
def test_prune_exports_bitwise(trainers, strategy, kw, key, value):
    """The pruned weights tensor for tensor, the patched config, and the
    export loads back in the port; the live model keeps its config."""
    jdir, pdir = both(trainers, strategy, **kw)
    assert_same_tensors(jdir, pdir)
    assert config_of(pdir)[key] == config_of(jdir)[key] == value
    assert getattr(trainers[1].model.config, key) != value
    pruned = LlamaForCausalLM.from_pretrained(pdir, device="cpu")
    logits = pruned(torch.tensor([[5, 6, 7]]))
    assert logits.shape == (1, 3, 96) and torch.isfinite(logits).all()


def test_gptq_quantize_bitwise():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 8)) @ rng.normal(size=(8, 48)) + 0.1 * rng.normal(size=(256, 48))
    W = rng.normal(size=(48, 24)).astype(np.float32)
    H = (X.T @ X).astype(np.float32)
    for bits, group in ((4, -1), (8, 16)):
        for a, b in zip(gptq.gptq_quantize(W, H, bits, group), jgptq.gptq_quantize(W, H, bits, group)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_gptq_calibration_and_export(trainers):
    """``collect_hessians`` within rel 1e-5 of the JAX package's (two fp32
    forwards), per unrolled kernel path; the GPTQ-calibrated export as
    ``assert_quantized_export`` holds it (its weights within 1e-4 of the
    largest: the compensation divides by the inverse Hessian's diagonal,
    which amplifies the Hessians' last-bit differences), and the model's own
    weights untouched."""
    jt, pt = trainers
    match = lambda p: "mlp" in p  # noqa: E731
    batches = [{"input_ids": ROWS[i][None]} for i in range(2)]
    jh = jgptq.collect_hessians(jt.model, [{"input_ids": jnp.asarray(b["input_ids"])} for b in batches], match=match)
    ph = gptq.collect_hessians(pt.model, batches, match=match)
    assert sorted(ph) == sorted(jh) and len(ph) == 2 * 3
    for k, v in jh.items():
        np.testing.assert_allclose(ph[k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max(), err_msg=k)
    before = {k: v.clone() for k, v in flatten_params(pt.model.params).items()}
    jdir, pdir = both(trainers, "ptq", bits=8, use_gptq=True, n_calib_batches=2, match=match)
    weights = assert_quantized_export(jdir, pdir, "weight_only_int8")
    assert all(torch.equal(v, before[k]) for k, v in flatten_params(pt.model.params).items())  # no write-back
    assert not torch.equal(weights.params["model"]["layers"]["mlp"]["up_proj"]["kernel"],
                           before["model/layers/mlp/up_proj/kernel"])  # GPTQ rewrote the mlp


def assert_quantized_export(jdir, pdir, algo):
    """An export whose fp weights went through a calibrated or trained
    transform: the port's ``model.safetensors`` within 1e-4 of the largest
    weight of the JAX package's, and its ``model_quant.safetensors`` the JAX
    package's ``quantize_params`` of those weights, byte for byte, in the
    JAX export's key order."""
    want, got = load_file(os.path.join(jdir, "model.safetensors")), load_file(os.path.join(pdir, "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4 * np.abs(want[k]).max(), err_msg=k)
    weights = LlamaForCausalLM.from_pretrained(pdir, device="cpu")
    ref = jquantize_params({k: v.numpy() for k, v in flatten_params(weights.params).items()},
                           JQuantizationConfig(weight_quantize_algo=algo))
    got_q = load_file(os.path.join(pdir, "model_quant.safetensors"))
    assert list(got_q) == list(load_file(os.path.join(jdir, "model_quant.safetensors")))
    want_q = {k: np.asarray(v) for k, v in jflatten(ref).items()}
    assert sorted(got_q) == sorted(want_q)
    for k in want_q:
        assert got_q[k].dtype == want_q[k].dtype, k
        np.testing.assert_array_equal(got_q[k], want_q[k], err_msg=k)
    return weights


def test_qat_finetune_and_export(trainers):
    """Four fake-quant AdamW steps at the default learning rate (decay 1e-4
    on every leaf): the export held as ``assert_quantized_export`` holds it,
    the adapted weights within 1e-6 of the largest weight of the JAX
    package's (Adam's first step is about ``lr * sign(g)``; at a learning rate
    of 1e-3 that turns fp32 noise in near-zero gradients into 1e-5 of
    relative difference, and fake-quant codes then flip), and the live
    model unchanged."""
    jt, pt = trainers
    before = {k: v.clone() for k, v in flatten_params(pt.model.params).items()}
    jdir, pdir = both(trainers, "qat", n_qat_steps=4)
    adapted = assert_quantized_export(jdir, pdir, "weight_only_int8")
    want = load_file(os.path.join(jdir, "model.safetensors"))
    got = load_file(os.path.join(pdir, "model.safetensors"))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6 * np.abs(want[k]).max(), err_msg=k)
    moved = max((v - before[k]).abs().max().item() for k, v in flatten_params(adapted.params).items())
    assert moved > 2e-5  # four steps of ~1e-5
    for k, v in flatten_params(pt.model.params).items():
        assert torch.equal(v, before[k]), k


def test_unknown_strategy_raises(trainers):
    with pytest.raises(ValueError, match="unknown compression strategy"):
        trainers[1].compress(strategy="distill")


@pytest.mark.parametrize("shape,double", [((96, 64), True), ((33, 7), False), ((5, 300, 3), True)])
def test_nf4_bitwise(shape, double):
    """``nf4_quantize`` (a numpy copy) and ``nf4_dequantize`` (torch), to fp32
    and bf16, equal the JAX package's bit for bit; ragged shapes included."""
    w = np.random.default_rng(1).normal(0, 0.05, shape).astype(np.float32)
    state, jstate = qlora.nf4_quantize(w, double_quant=double), jqlora.nf4_quantize(w, double_quant=double)
    assert sorted(state) == sorted(jstate)
    for k in state:
        np.testing.assert_array_equal(state[k], jstate[k], err_msg=k)
    for dtype in ("float32", "bfloat16"):
        got = qlora.nf4_dequantize(state, getattr(torch, dtype), device="cpu")
        want = np.asarray(jqlora.nf4_dequantize(jstate, getattr(jnp, dtype)))
        assert tuple(got.shape) == shape
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
