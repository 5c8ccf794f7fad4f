"""The port's SFT path, datasets, corpus tool and tokenizer-aware pretraining against the JAX package.

- ``datasets``: ``greedy_pack``, both zero-padding datasets and
  ``load_dataset`` (json, jsonl, csv, tsv, txt, split inference, the map,
  filter and shuffle transforms) equal the JAX ones bit for bit; the padding
  tail is the segment ``len(pack) + 1``.
- ``run_finetune.main`` on the fixture of
  ``tests/llm/test_entrypoints.py::TestRunFinetune`` (a tiny LLaMA saved by
  the JAX package, a ``WordLevel`` tokenizer, here with a ChatML template and
  ``messages`` rows beside the ``src``/``tgt`` ones), through both packages,
  with zero padding on and off: every step's loss and grad norm within rel
  1e-5 (fp32; the JAX run spreads its batch over this suite's 8 virtual CPU
  devices, so the port gets ``per_device_train_batch_size`` x 8), the eval
  loss too, and the saved weights load back. ``lora`` and ``prefix_tuning``
  train the adapters or the prefix alone and save only them (their parity
  with the JAX ``main`` is in ``tests/test_torch_peft_train.py``).
- ``llm/tools/preprocess_data``: the ``.bin``/``.idx`` files equal the JAX
  tool's byte for byte, including a vocabulary over 65,535 (uint32 tokens).
- ``run_pretrain`` with ``tokenizer_name_or_path``: the tokenizer loads and
  ``save_model`` writes it beside the weights.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from paddlenlp_tpu.data import MMapIndexedDatasetBuilder as JBuilder
from paddlenlp_tpu.datasets import dataset as jds
from paddlenlp_tpu.datasets import zero_padding_dataset as jzp
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers import PretrainedTokenizer as JTokenizer
from paddlenlp_tpu_torch.datasets import dataset as ds
from paddlenlp_tpu_torch.datasets import zero_padding_dataset as zp
from paddlenlp_tpu_torch.llm import run_finetune, run_pretrain
from paddlenlp_tpu_torch.llm.tools import preprocess_data
from paddlenlp_tpu_torch.transformers import AutoModelForCausalLM, AutoTokenizer
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
CHATML = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}<|im_end|>\n{% endfor %}"
          "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")


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


def _wordlevel(words, chat_template=None):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: i + 4 for i, w in enumerate(words)})
    t = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = Whitespace()
    tok = JTokenizer(tokenizer_object=t, pad_token="<pad>", bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                     chat_template=chat_template)
    if chat_template:
        tok.add_special_tokens({"additional_special_tokens": ["<|im_start|>", "<|im_end|>"]})
    return tok


@pytest.fixture(scope="module")
def hub(tmp_path_factory):
    """tests/llm/test_entrypoints.py's tiny hub, with a chat template and
    ``messages`` rows."""
    root = tmp_path_factory.mktemp("hub")
    model_dir = root / "tiny-llama"
    cfg = JLlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                       num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=64,
                       eos_token_id=2, pad_token_id=0)
    JLlama.from_config(cfg, seed=0).save_pretrained(str(model_dir))
    _wordlevel("a b c d e f g h i j k l m n o p user assistant".split(), CHATML).save_pretrained(str(model_dir))
    data_dir = root / "sft"
    data_dir.mkdir()
    rows = [{"src": "a b c", "tgt": "d e"}, {"src": "f g", "tgt": "h i j"},
            {"messages": [{"role": "user", "content": "k l"}, {"role": "assistant", "content": "m n o"}]}] * 22
    with open(data_dir / "train.json", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    with open(data_dir / "dev.json", "w") as f:
        for r in rows[:6]:
            f.write(json.dumps(r) + "\n")
    return {"root": root, "model": model_dir, "sft": data_dir}


# ----------------------------------------------------------------------------- datasets
def _examples(seed, n=40, max_len=20):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(1, max_len))
        ids = rng.integers(4, 60, k).astype(np.int32)
        labels = np.where(rng.random(k) < 0.3, -100, ids).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels})
    return out


def _same_packs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


class _Tok:
    pad_token_id = 7


@pytest.mark.parametrize("max_length", [16, 32, 57])
def test_zero_padding_packs_bit_for_bit(max_length):
    ex = _examples(max_length)
    _same_packs(zp.greedy_pack(ex, max_length, pad_id=5), jzp.greedy_pack(ex, max_length, pad_id=5))
    _same_packs(list(zp.ZeroPaddingMapDataset(ex, _Tok(), max_length)),
                list(jzp.ZeroPaddingMapDataset(ex, _Tok(), max_length)))
    _same_packs(list(zp.ZeroPaddingIterableDataset(ex, _Tok(), max_length)),
                list(jzp.ZeroPaddingIterableDataset(ex, _Tok(), max_length)))
    padded = 0
    for p in zp.greedy_pack(ex, max_length):
        assert all(len(p[k]) == max_length for k in p)
        u = np.unique(p["segment_ids"])
        if len(u) > 1 and u[-1] != u[-2] + 1:
            # the padding tail: segment len(pack) + 1, after examples 0 .. len(pack) - 1
            assert u[-1] == len(u) and np.array_equal(u[:-1], np.arange(len(u) - 1))
            padded += 1
        else:
            assert np.array_equal(u, np.arange(len(u)))
    assert padded


def _write_splits(d):
    d.mkdir()
    rows = [{"text": f"row {i}", "label": str(i % 3)} for i in range(9)]
    with open(d / "train.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    (d / "dev.json").write_text(json.dumps(rows[:4]))
    (d / "test.tsv").write_text("text\tlabel\n" + "".join(f"{r['text']}\t{r['label']}\n" for r in rows[:3]))
    (d / "extra.csv").write_text("text,label\n" + "".join(f"{r['text']},{r['label']}\n" for r in rows[:2]))
    (d / "notes.txt").write_text("first line\n\nsecond line\n")


def test_load_dataset_bit_for_bit(tmp_path):
    d = tmp_path / "corpus"
    _write_splits(d)
    for call in (lambda m: m.load_dataset(str(d), splits=["train", "validation", "test"]),
                 lambda m: m.load_dataset(str(d), splits="dev"),
                 lambda m: m.load_dataset(str(d / "extra.csv")),
                 lambda m: m.load_dataset(str(d / "notes.txt"), splits=["train"]),
                 lambda m: m.load_dataset("x", data_files={"train": str(d / "train.jsonl"),
                                                           "test": str(d / "test.tsv")}, splits=["train", "test"])):
        got, want = call(ds), call(jds)
        got, want = (got, want) if isinstance(got, list) else ([got], [want])
        assert [list(g) for g in got] == [list(w) for w in want]
    got = ds.load_dataset(str(d), splits="train").map(lambda r: {**r, "n": len(r["text"])}, lazy=True)
    want = jds.load_dataset(str(d), splits="train").map(lambda r: {**r, "n": len(r["text"])}, lazy=True)
    assert list(got.filter(lambda r: r["label"] != "1").shuffle(seed=3)) == list(
        want.filter(lambda r: r["label"] != "1").shuffle(seed=3))
    it, jit = (m.IterDataset(lambda: iter(range(10))).map(lambda x: x * 3).filter(lambda x: x % 2) for m in (ds, jds))
    assert list(it) == list(jit)
    with pytest.raises(FileNotFoundError) as got:
        ds.load_dataset(str(d), splits="validation_extra")
    with pytest.raises(FileNotFoundError) as want:
        jds.load_dataset(str(d), splits="validation_extra")
    assert str(got.value) == str(want.value)


def test_registered_builders():
    @ds.register_dataset("_port_toy")
    def build(split, name=None, **kw):
        return [{"split": split, "i": i} for i in range(3)]

    try:
        train, test = ds.load_dataset("_port_toy", splits=["train", "test"])
        assert list(test) == [{"split": "test", "i": i} for i in range(3)] and len(train) == 3
        assert "_port_toy" not in jds.DATASET_REGISTRY
    finally:
        ds.DATASET_REGISTRY.pop("_port_toy")


# ----------------------------------------------------------------------------- run_finetune
def _sft_args(hub, out, zero_padding, batch):
    return {
        "model_name_or_path": str(hub["model"]), "dataset_name_or_path": str(hub["sft"]), "output_dir": str(out),
        "max_length": 32, "src_length": 16, "per_device_train_batch_size": batch, "per_device_eval_batch_size": batch,
        "max_steps": 3, "logging_steps": 1, "save_strategy": "no", "do_train": True, "do_eval": True,
        "dtype": "float32", "zero_padding": zero_padding, "learning_rate": 1e-3, "warmup_steps": 1, "seed": 0,
    }


@pytest.fixture(scope="module")
def sft_runs(hub, tmp_path_factory):
    """One JAX and one port run for zero padding on and off."""
    jr = _load_jax_script("run_finetune", "llm", "run_finetune.py")
    out = {}
    for zero_padding in (True, False):
        d = tmp_path_factory.mktemp(f"sft-{zero_padding}")
        runs = {}
        for who, batch in (("jax", 1), ("port", JAX_DEVICES)):
            path = d / f"{who}.json"
            path.write_text(json.dumps(_sft_args(hub, d / who, zero_padding, batch)))
            if who == "jax":
                argv = sys.argv
                sys.argv = ["run_finetune.py", str(path)]
                try:
                    trainer = jr.main()
                finally:
                    sys.argv = argv
            else:
                trainer = run_finetune.main([str(path)], device="cpu")
            runs[who] = dict(trainer=trainer, logs=list(trainer.state.log_history), out=d / who,
                             eval=trainer.evaluate()["eval_loss"])
        out[zero_padding] = runs
    return out


@pytest.mark.parametrize("zero_padding", [True, False], ids=["zero-padding", "padded"])
def test_sft_steps_match_jax(sft_runs, zero_padding):
    j, p = sft_runs[zero_padding]["jax"], sft_runs[zero_padding]["port"]
    jsteps = [h for h in j["logs"] if "grad_norm" in h]
    psteps = [h for h in p["logs"] if "grad_norm" in h]
    assert len(jsteps) == len(psteps) == 3
    for a, b in zip(psteps, jsteps):
        assert a["loss"] == pytest.approx(b["loss"], rel=REL), (a, b)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=REL), (a, b)
        assert a["learning_rate"] == pytest.approx(b["learning_rate"], rel=1e-6)
    assert p["eval"] == pytest.approx(j["eval"], rel=REL)
    assert p["trainer"].model.compute_dtype == torch.float32


def test_sft_rows_pack_with_segments(sft_runs, hub):
    trainer = sft_runs[True]["port"]["trainer"]
    row = trainer.train_dataset[0]
    assert set(row) == {"input_ids", "labels", "segment_ids", "position_ids"}
    segs = row["segment_ids"]
    assert len(np.unique(segs)) >= 3 and segs[-1] == len(np.unique(segs))  # >= 2 examples + the padding tail
    # the messages rows went through the chat template
    tok = AutoTokenizer.from_pretrained(str(hub["model"]))
    text = tok.decode(row["input_ids"], skip_special_tokens=False)
    assert "<|im_start|>" in text and "<|im_end|>" in text


@pytest.mark.parametrize("zero_padding", [True, False], ids=["zero-padding", "padded"])
def test_sft_save_model_loads_back(sft_runs, zero_padding):
    p = sft_runs[zero_padding]["port"]
    saved = AutoModelForCausalLM.from_pretrained(str(p["out"]), param_dtype="float32", device="cpu")
    for path, t in flatten_params(p["trainer"].model.params).items():
        assert torch.equal(flatten_params(saved.params)[path], t.detach()), path
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (p["out"] / name).read_bytes() == (sft_runs[zero_padding]["jax"]["out"] / name).read_bytes()


@pytest.mark.parametrize("flag", ["lora", "prefix_tuning"])
def test_peft_flags_raise_naming_14c(hub, tmp_path, flag):
    """Queue 1 item 14c is ported: the flags no longer raise; the run trains
    the adapters or the prefix alone and saves only them."""
    args = dict(_sft_args(hub, tmp_path / "out", False, 8), max_steps=2, do_eval=False, **{flag: True})
    (tmp_path / "a.json").write_text(json.dumps(args))
    trainer = run_finetune.main([str(tmp_path / "a.json")], device="cpu")
    name = {"lora": "LoRAModel", "prefix_tuning": "PrefixModelForCausalLM"}[flag]
    assert type(trainer.model).__name__ == name and trainer.state.global_step == 2
    saved = {"lora": "lora_model.safetensors", "prefix_tuning": "prefix_model.safetensors"}[flag]
    assert os.path.isfile(tmp_path / "out" / saved) and not os.path.isfile(tmp_path / "out" / "model.safetensors")
    assert all(k.startswith("inner_states/train/") for k in trainer.optimizer.state_dict())


# ----------------------------------------------------------------------------- preprocess_data and run_pretrain
@pytest.mark.parametrize("vocab", [20, 70_000], ids=["uint16", "uint32"])
def test_preprocess_data_byte_for_byte(tmp_path, vocab):
    words = [f"w{i}" for i in range(vocab)]
    tok_dir = tmp_path / "tok"
    _wordlevel(words).save_pretrained(str(tok_dir))
    rng = np.random.default_rng(vocab)
    corpus = tmp_path / "raw.jsonl"
    with open(corpus, "w") as f:
        for _ in range(12):
            f.write(json.dumps({"text": " ".join(rng.choice(words, int(rng.integers(1, 30))))}) + "\n")
        f.write(json.dumps({"text": ""}) + "\n")
    jtool = _load_jax_script("preprocess_data", "llm", "tools", "preprocess_data.py")
    common = ["--input", str(corpus), "--tokenizer_name_or_path", str(tok_dir), "--append_eos"]
    argv = sys.argv
    sys.argv = ["preprocess_data.py", *common, "--output_prefix", str(tmp_path / "jax" / "data")]
    try:
        jtool.main()
    finally:
        sys.argv = argv
    preprocess_data.main([*common, "--output_prefix", str(tmp_path / "port" / "data")])
    for ext in (".bin", ".idx"):
        got, want = (tmp_path / "port" / f"data{ext}").read_bytes(), (tmp_path / "jax" / f"data{ext}").read_bytes()
        assert got == want, ext
    itemsize = 4 if vocab > 65535 else 2
    ids = np.frombuffer((tmp_path / "port" / "data.bin").read_bytes(), dtype=np.uint32 if itemsize == 4 else np.uint16)
    assert ids.max() > (65535 if vocab > 65535 else 0)


def test_run_pretrain_loads_and_saves_the_tokenizer(hub, tmp_path):
    builder = JBuilder(str(tmp_path / "data" / "corpus"), dtype=np.int32)
    rng = np.random.default_rng(0)
    for _ in range(40):
        builder.add_document(rng.integers(4, 20, int(rng.integers(20, 60))))
    builder.finalize()
    args = dict(model_name_or_path=str(hub["model"]), tokenizer_name_or_path=str(hub["model"]),
                input_dir=str(tmp_path / "data"), output_dir=str(tmp_path / "out"), max_seq_length=16,
                per_device_train_batch_size=2, max_steps=2, save_steps=100, do_train=True, dtype="float32")
    (tmp_path / "args.json").write_text(json.dumps(args))
    trainer = run_pretrain.main([str(tmp_path / "args.json")], device="cpu")
    assert trainer.state.global_step == 2 and trainer.tokenizer is not None
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (tmp_path / "out" / name).read_bytes() == (hub["model"] / name).read_bytes(), name
    # not from scratch: the tokenizer comes from the model directory itself
    args.update(tokenizer_name_or_path=None, from_scratch=False, output_dir=str(tmp_path / "out2"), max_steps=1)
    (tmp_path / "args.json").write_text(json.dumps(args))
    trainer = run_pretrain.main([str(tmp_path / "args.json")], device="cpu")
    assert trainer.tokenizer.chat_template == CHATML and os.path.isfile(tmp_path / "out2" / "tokenizer.json")
