"""The port's ``generate`` against the JAX package's.

The tiny LLaMA of ``tests/generation/test_generate.py`` (2 layers, GQA 4 over
2, vocab 96) is built in the JAX package and carried into the port with
``from_jax_params``; every case of that file then runs through both
packages on the same prompts and seeds: greedy, a left-padded batch, the
EOS stop, ``trunc_input=False``, seeded sampling with temperature, top-k and
top-p, the three penalties (under left padding too), ``no_repeat_ngram_size``,
``min_new_tokens``, beam, group beam and batched beams. Ids must be equal
exactly and beam scores within rel 1e-5 (fp32 on both sides; the two
log-softmaxes differ in summation order only). The JAX outputs are computed
once per case in a module fixture (each distinct shape and processor set is
one JAX compile).

Also held: the streamer's ``put`` sequence; ``GenerationConfig`` files
across the packages and through ``from_pretrained`` of an HF checkpoint;
``QuantizedModel`` (wint8, a8w8) and ``LoRAModel`` ``generate`` against
fresh JAX facades, and after a plain ``generate`` of the same shape on the
same base model (the order in which the JAX facades reuse the base model's
cached decode function: ROADMAP Queue 3); ``Seq2SeqTrainer.evaluate`` with
``compute_metrics`` against the JAX trainer's; encoder-decoder ``generate``
still raising, naming its item.
"""

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.generation import GenerationConfig as JGenerationConfig
from paddlenlp_tpu.peft import LoRAConfig as JLoRAConfig
from paddlenlp_tpu.peft import LoRAModel as JLoRAModel
from paddlenlp_tpu.quantization import QuantizationConfig as JQuantizationConfig
from paddlenlp_tpu.quantization import QuantizedModel as JQuantizedModel
from paddlenlp_tpu.trainer import Seq2SeqTrainer as JSeq2SeqTrainer
from paddlenlp_tpu.trainer import TrainingArguments as JTrainingArguments
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.conversion_utils import unflatten_params as junflatten
from paddlenlp_tpu_torch.generation import GenerationConfig, TopKLogitsWarper, TopPLogitsWarper
from paddlenlp_tpu_torch.generation.logits_process import MinLengthLogitsProcessor, _valid_counts
from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel
from paddlenlp_tpu_torch.quantization import QuantizationConfig, QuantizedModel
from paddlenlp_tpu_torch.trainer import Seq2SeqTrainer, TrainingArguments
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

torch.set_num_threads(1)

MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128, eos_token_id=2, pad_token_id=0)
SCORE_RTOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "transformers", "golden")

P4 = [[5, 6, 7, 8]]
P3 = [[5, 6, 7]]
BATCH = [[0, 0, 5, 6, 7], [11, 12, 13, 14, 15]]
BATCH_MASK = [[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]]
PENALTIES = dict(frequency_penalty=0.5, repetition_penalty=1.3, presence_penalty=0.3)
SAMPLING = dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9)

#: name -> (prompt, attention mask or None, generate kwargs); each JAX compile once
CASES = {
    "greedy": (P4, None, dict(max_new_tokens=6, do_sample=False)),
    "left_pad": (BATCH, BATCH_MASK, dict(max_new_tokens=4, do_sample=False)),
    "sampled": (BATCH, BATCH_MASK, dict(max_new_tokens=8, seed=13, **SAMPLING)),
    "penalties_left_pad": (BATCH, BATCH_MASK, dict(max_new_tokens=4, do_sample=False, **PENALTIES)),
    "no_repeat_ngram": (P3, None, dict(max_new_tokens=16, do_sample=False, no_repeat_ngram_size=2,
                                       eos_token_id=None)),
    "group_beam": (P3, None, dict(max_new_tokens=5, num_beams=4, num_beam_groups=2, diversity_penalty=1.0,
                                  decode_strategy="group_beam_search", eos_token_id=None)),
    "batched_beams": ([[5, 6, 7], [40, 41, 42]], None, dict(max_new_tokens=5, num_beams=3, eos_token_id=None)),
}
# cases whose eos id is a token the greedy stream emits (so the stop is exercised)
EOS_CASES = {
    "eos_stop": (P4, None, dict(max_new_tokens=12, do_sample=False)),
    "min_new_tokens": (P4, None, dict(max_new_tokens=8, do_sample=False, min_new_tokens=4)),
    "beam_eos_frozen": (P4, None, dict(max_new_tokens=10, num_beams=2)),
}


class Recorder:
    """A streamer that keeps every ``put`` and the ``end``."""

    def __init__(self):
        self.events = []

    def put(self, value):
        self.events.append(np.asarray(value).tolist())

    def end(self):
        self.events.append("end")


def _jgen(jm, prompt, mask, kw, **extra):
    out = jm.generate(jnp.asarray(prompt, jnp.int32), attention_mask=None if mask is None else jnp.asarray(mask),
                      **kw, **extra)
    return np.asarray(out[0]), None if out[1] is None else np.asarray(out[1])


def _pgen(pm, prompt, mask, kw, **extra):
    out = pm.generate(np.asarray(prompt), attention_mask=None if mask is None else np.asarray(mask), **kw, **extra)
    return out[0].numpy(), None if out[1] is None else out[1].numpy()


@pytest.fixture(scope="module")
def models():
    jm = JLlama.from_config(JLlamaConfig(**MODEL_KW), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), jax.device_get(jm.params), device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def eos_id(models):
    """The second token of the greedy stream of P4: an eos the decode meets."""
    return int(_pgen(models[1], P4, None, CASES["greedy"][2])[0][0, 1])


@pytest.fixture(scope="module")
def jax_outputs(models, eos_id):
    jm = models[0]  # its cached decode functions serve the trainer and the stale-order test too
    out = {name: _jgen(jm, p, m, kw) for name, (p, m, kw) in CASES.items()}
    out.update({name: _jgen(jm, p, m, kw, eos_token_id=eos_id) for name, (p, m, kw) in EOS_CASES.items()})
    rec = Recorder()
    out["streamer"] = _jgen(jm, P4, None, CASES["greedy"][2], streamer=rec) + (rec.events,)
    out["untruncated"] = _jgen(jm, P4, None, CASES["greedy"][2], trunc_input=False)
    out["sampled_seed3"] = _jgen(jm, *CASES["sampled"][:2], dict(CASES["sampled"][2], seed=3))
    return out


def _fresh(jm):
    """The JAX model with an empty decode-function cache (its params shared)."""
    fresh = copy.copy(jm)
    fresh._decode_cache = {}
    return fresh


# ----------------------------------------------------------------------------- decode against JAX
@pytest.mark.parametrize("name", list(CASES) + list(EOS_CASES))
def test_generate_matches_jax(models, jax_outputs, eos_id, name):
    prompt, mask, kw = CASES[name] if name in CASES else EOS_CASES[name]
    extra = {} if name in CASES else dict(eos_token_id=eos_id)
    got_ids, got_scores = _pgen(models[1], prompt, mask, kw, **extra)
    want_ids, want_scores = jax_outputs[name]
    np.testing.assert_array_equal(got_ids, want_ids)
    if want_scores is None:
        assert got_scores is None
    else:
        np.testing.assert_allclose(got_scores, want_scores, rtol=SCORE_RTOL, atol=0)


def test_greedy_matches_manual_loop(models):
    """The cached decode equals re-running the whole sequence each step."""
    pm = models[1]
    out, _ = _pgen(pm, P4, None, CASES["greedy"][2])
    ids = torch.tensor(P4)
    for _ in range(6):
        nxt = int(pm(ids)[0, -1].argmax())
        ids = torch.cat([ids, torch.tensor([[nxt]])], dim=1)
        if nxt == 2:
            break
    manual = ids[0, 4:].numpy()
    np.testing.assert_array_equal(out[0, :len(manual)], manual)


def test_left_padded_row_equals_the_row_alone(models, jax_outputs):
    """Pad slots feed neither attention nor the penalty counts."""
    for case, kw in (("left_pad", {}), ("penalties_left_pad", PENALTIES)):
        single, _ = _pgen(models[1], P3, None, dict(max_new_tokens=4, do_sample=False, **kw))
        np.testing.assert_array_equal(jax_outputs[case][0][0], single[0])


def test_eos_stops_the_row_and_pads(models, jax_outputs, eos_id):
    toks = jax_outputs["eos_stop"][0][0]
    assert toks[1] == eos_id and (toks[2:] == 0).all()
    beam = jax_outputs["beam_eos_frozen"][0][0]
    if eos_id in beam:
        i = int(np.argmax(beam == eos_id))
        assert (beam[i + 1:] == 0).all()
    # min_new_tokens holds the eos back for 4 new tokens
    assert eos_id not in jax_outputs["min_new_tokens"][0][0, :4]


def test_trunc_input_false(models, jax_outputs):
    got, _ = _pgen(models[1], P4, None, CASES["greedy"][2], trunc_input=False)
    np.testing.assert_array_equal(got, jax_outputs["untruncated"][0])
    np.testing.assert_array_equal(got[0, :4], P4[0])
    assert got.shape == (1, 10)


def test_sampling_seeds_and_top_k1(models, jax_outputs):
    pm = models[1]
    prompt, mask, kw = CASES["sampled"]
    got3, _ = _pgen(pm, prompt, mask, dict(kw, seed=3))
    np.testing.assert_array_equal(got3, jax_outputs["sampled_seed3"][0])
    assert not np.array_equal(got3, jax_outputs["sampled"][0])  # the seed matters
    again, _ = _pgen(pm, prompt, mask, dict(kw, seed=3))
    np.testing.assert_array_equal(again, got3)
    k1, _ = _pgen(pm, BATCH, BATCH_MASK, dict(max_new_tokens=4, do_sample=True, top_k=1, seed=3))
    np.testing.assert_array_equal(k1, jax_outputs["left_pad"][0])


def test_no_repeat_ngram_bans_repeats(jax_outputs):
    full = np.concatenate([np.asarray(P3[0]), jax_outputs["no_repeat_ngram"][0][0]])
    bigrams = [(a, b) for a, b in zip(full[:-1], full[1:]) if 0 not in (a, b)]
    assert len(bigrams) == len(set(bigrams))


def test_beam_matches_naive_beam_and_beats_greedy(models, jax_outputs):
    """Beam-3 equals a re-forward-everything beam and the JAX batch's row of
    the same prompt (rows are independent); its sequence log-prob is at least
    the greedy sequence's."""
    pm = models[1]
    beams = [(list(P3[0]), 0.0)]
    for _ in range(5):
        cand = []
        for ids, sc in beams:
            logp = torch.log_softmax(pm(torch.tensor([ids]))[0, -1].float(), dim=-1).numpy()
            for t in np.argsort(logp)[::-1][:4]:
                cand.append((ids + [int(t)], sc + float(logp[t])))
        cand.sort(key=lambda x: -x[1])
        beams = cand[:3]
    out, scores = _pgen(pm, P3, None, dict(max_new_tokens=5, num_beams=3, eos_token_id=None))
    np.testing.assert_array_equal(out[0], beams[0][0][3:])
    np.testing.assert_allclose(scores[0], beams[0][1] / 5.0, rtol=SCORE_RTOL)
    greedy, _ = _pgen(pm, P3, None, dict(max_new_tokens=5, do_sample=False, eos_token_id=None))

    def seq_logp(gen):
        ids = np.concatenate([np.asarray(P3[0]), gen])
        lp = torch.log_softmax(pm(torch.from_numpy(ids[None, :-1]))[0].float(), dim=-1).numpy()
        return sum(lp[2 + i, t] for i, t in enumerate(gen))

    assert seq_logp(out[0]) >= seq_logp(greedy[0]) - 1e-4
    np.testing.assert_array_equal(jax_outputs["batched_beams"][0][0], out[0])
    np.testing.assert_allclose(jax_outputs["batched_beams"][1][0], scores[0], rtol=SCORE_RTOL)


def test_streamer_put_sequence(models, jax_outputs):
    rec = Recorder()
    _pgen(models[1], P4, None, CASES["greedy"][2], streamer=rec)
    assert rec.events == jax_outputs["streamer"][2]
    assert rec.events[0] == P4 and rec.events[-1] == "end" and len(rec.events) == 1 + 6 + 1


def test_warpers_and_processors():
    logits = torch.tensor([[1.0, 3.0, 2.0, 0.5]])
    out = TopKLogitsWarper(2)(None, logits, 0)
    assert out[0, 1] == 3.0 and out[0, 2] == 2.0 and out[0, 0] < -1e8 and out[0, 3] < -1e8
    tied = torch.tensor([[1.0, 2.0, 2.0, 2.0, 0.0]])  # the kth value sits in a tie: all of it stays
    np.testing.assert_array_equal(TopKLogitsWarper(2)(None, tied, 0).numpy(), [[-1e9, 2, 2, 2, -1e9]])
    out = TopPLogitsWarper(0.5)(None, torch.log(torch.tensor([[0.5, 0.3, 0.1, 0.1]])), 0)
    assert out[0, 0] > -1e8 and out[0, 2] < -1e8 and out[0, 3] < -1e8
    out = MinLengthLogitsProcessor(4, [2, 5], prompt_len=0)(torch.zeros(1, 8, dtype=torch.long), torch.zeros(1, 8), 1)
    assert out[0, 2] < -1e8 and out[0, 5] < -1e8 and out[0, 3] == 0.0
    counts = _valid_counts(torch.tensor([[8, 1, 1, 3]]), 4, 8)  # 8 == vocab_size: the left-pad sentinel
    assert int(counts[0, 1]) == 2 and int(counts.sum()) == 3


# ----------------------------------------------------------------------------- configs
def test_generation_config_files_cross_packages(tmp_path):
    g = GenerationConfig(max_new_tokens=32, do_sample=True, top_p=0.9, eos_token_id=2)
    g.save_pretrained(str(tmp_path / "port"))
    jg = JGenerationConfig.from_pretrained(str(tmp_path / "port"))
    assert jg.to_dict() == g.to_dict()
    jg.save_pretrained(str(tmp_path / "jax"))
    with open(tmp_path / "port" / "generation_config.json") as a, open(tmp_path / "jax" / "generation_config.json") as b:
        assert a.read() == b.read()
    assert GenerationConfig.from_pretrained(str(tmp_path / "jax")).max_new_tokens == 32
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        GenerationConfig.from_pretrained("Qwen/Qwen2-7B")


def test_from_pretrained_reads_and_writes_the_generation_config(tmp_path):
    src = tmp_path / "ckpt"
    shutil.copytree(os.path.join(GOLDEN, "llama_gqa_tiny"), src)
    with open(src / "generation_config.json", "w") as f:
        json.dump({"max_new_tokens": 3, "pad_token_id": 0, "eos_token_id": None, "repetition_penalty": 1.2}, f)
    pm = LlamaForCausalLM.from_pretrained(str(src), device="cpu")
    assert pm.generation_config.max_new_tokens == 3 and pm.generation_config.repetition_penalty == 1.2
    out, _ = pm.generate([[3, 4, 5]])
    assert out.shape == (1, 3)  # the file's max_new_tokens, not the default 20
    pm.save_pretrained(str(tmp_path / "saved"))
    assert GenerationConfig.from_pretrained(str(tmp_path / "saved")).to_dict() == pm.generation_config.to_dict()
    jm = JLlama.from_pretrained(str(src))
    assert jm.generation_config.to_dict() == pm.generation_config.to_dict()


def test_encoder_decoder_generate_names_its_item(models):
    pm = copy.copy(models[1])
    pm.config = copy.copy(pm.config)
    pm.config.is_encoder_decoder = True
    with pytest.raises(NotImplementedError, match="item 14e"):
        pm.generate(P3)


# ----------------------------------------------------------------------------- facades
def _trained_lora(jm, pm):
    """JAX and port LoRA facades (r=2) with the same seeded non-zero B."""
    jl = JLoRAModel(jm, JLoRAConfig(r=2))
    pl = LoRAModel(pm, LoRAConfig(r=2))
    rng = np.random.default_rng(5)
    jflat, pflat = dict(jflatten(jl.params)), dict(flatten_params(pl.params))
    for p in sorted(jflat):
        if p.endswith("lora_B"):
            b = rng.standard_normal(tuple(jflat[p].shape)).astype(np.float32) * 0.5
            jflat[p], pflat[p] = jnp.asarray(b), torch.from_numpy(b)
    jl.params, pl.params = junflatten(jflat), unflatten_params(pflat)
    return jl, pl


@pytest.fixture(scope="module")
def facades(models):
    jm, pm = models
    out = {}
    for algo in ("wint8", "a8w8"):
        out[algo] = (JQuantizedModel(_fresh(jm), JQuantizationConfig(weight_quantize_algo=algo)),
                     QuantizedModel(pm, QuantizationConfig(weight_quantize_algo=algo)))
    out["lora"] = _trained_lora(_fresh(jm), pm)
    return out


@pytest.mark.parametrize("facade", ["wint8", "a8w8", "lora"])
def test_facade_generate_matches_fresh_jax_facade(facades, facade):
    jf, pf = facades[facade]
    prompt, mask, kw = CASES["left_pad"]
    want, _ = _jgen(jf, prompt, mask, kw)
    got, _ = _pgen(pf, prompt, mask, kw)
    np.testing.assert_array_equal(got, want)


def test_facade_after_a_plain_generate_of_the_same_shape(models, facades, jax_outputs):
    """A JAX facade whose base model already ran a plain ``generate`` of the
    same shape reuses that cached decode function, which closes over the
    plain module: the LoRA facade then returns the base model's tokens and
    the wint8 facade raises (ROADMAP Queue 3). The port's facades compute
    their own functions whatever ran before."""
    jm, pm = models
    prompt, mask, kw = CASES["left_pad"]
    base = jax_outputs["left_pad"][0]  # jm ran this plain generate in the fixture
    jl, pl = _trained_lora(jm, pm)
    stale, _ = _jgen(jl, prompt, mask, kw)
    fresh_lora, _ = _jgen(facades["lora"][0], prompt, mask, kw)
    assert not np.array_equal(fresh_lora, base)
    np.testing.assert_array_equal(stale, base)  # the reference fault
    _pgen(pm, prompt, mask, kw)
    np.testing.assert_array_equal(_pgen(pl, prompt, mask, kw)[0], fresh_lora)
    with pytest.raises(Exception, match="Could not find parameter"):
        _jgen(JQuantizedModel(jm, JQuantizationConfig(weight_quantize_algo="wint8")), prompt, mask, kw)
    fresh_wint8, _ = _jgen(facades["wint8"][0], prompt, mask, kw)
    np.testing.assert_array_equal(_pgen(QuantizedModel(pm, QuantizationConfig(weight_quantize_algo="wint8")),
                                        prompt, mask, kw)[0], fresh_wint8)


# ----------------------------------------------------------------------------- Seq2SeqTrainer
class PromptSet:
    """Right-padded prompts with labels: what an eval collator hands over."""

    def __init__(self):
        rng = np.random.default_rng(3)
        self.rows = []
        for n in (3, 5, 4, 5):
            ids = np.zeros(5, np.int32)
            ids[:n] = rng.integers(3, 96, n)
            mask = (np.arange(5) < n).astype(np.int32)
            self.rows.append({"input_ids": ids, "attention_mask": mask, "labels": rng.integers(3, 96, 4).astype(np.int32)})

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _overlap(pred):
    preds, labels = np.asarray(pred.predictions), np.asarray(pred.label_ids)
    return {"token_overlap": float((preds[:, :4] == labels).mean()), "first_token": float(preds[:, 0].sum())}


def test_seq2seq_trainer_evaluate_matches_jax(models, jax_outputs, tmp_path):
    jm, pm = models
    gen = {"max_new_tokens": 4, "do_sample": False}
    jt = JSeq2SeqTrainer(model=jm, args=JTrainingArguments(output_dir=str(tmp_path / "j"),
                                                                   per_device_eval_batch_size=2),
                         eval_dataset=PromptSet(), compute_metrics=_overlap, gen_kwargs=gen)
    pt = Seq2SeqTrainer(model=pm, args=TrainingArguments(output_dir=str(tmp_path / "p"), per_device_eval_batch_size=2),
                        eval_dataset=PromptSet(), compute_metrics=_overlap, gen_kwargs=gen)
    want, got = jt.evaluate(), pt.evaluate()
    for key in ("eval_token_overlap", "eval_first_token"):
        assert got[key] == want[key], key
    out = pt.generate_and_score(PromptSet())
    np.testing.assert_array_equal(np.asarray(out.predictions), np.asarray(jt.generate_and_score(PromptSet()).predictions))
