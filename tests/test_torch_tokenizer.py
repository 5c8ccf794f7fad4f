"""The port's tokenizer, SentencePiece converter and downloader against the JAX package.

Each case builds its tokenizers inside the test (a ``WordLevel`` one, as
``tests/transformers/test_tokenizer.py`` does, and SentencePiece models
hand-encoded with the proto2 writer of ``tests/transformers/test_spm_converter.py``)
and holds the port to the JAX package exactly: ids, masks, padding on either
side, truncation, ``return_tensors="np"``, decode with and without
``skip_special_tokens``, chat-template text, added tokens, the converted
``tokenizer.json`` text and merges, the saved files byte for byte, and each
package loading the other's files. The hub is never asked: the JAX
resolver runs with ``PDNLP_TPU_OFFLINE=1``.
"""

import os
import struct
import sys

import numpy as np
import pytest

from paddlenlp_tpu.transformers import PretrainedTokenizer as JTokenizer
from paddlenlp_tpu.transformers.convert_slow_tokenizer import _extract_bpe_merges as j_merges
from paddlenlp_tpu.transformers.convert_slow_tokenizer import convert_spm_to_fast as j_convert
from paddlenlp_tpu.transformers.convert_slow_tokenizer import parse_spm_model as j_parse
from paddlenlp_tpu.utils import downloader as j_downloader
from paddlenlp_tpu_torch.transformers import AutoTokenizer, PretrainedTokenizer
from paddlenlp_tpu_torch.transformers.convert_slow_tokenizer import (_extract_bpe_merges, convert_spm_to_fast,
                                                                     parse_spm_model)
from paddlenlp_tpu_torch.utils import downloader

CHATML = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}<|im_end|>\n{% endfor %}"
          "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
WORDS = "the quick brown fox jumps over lazy dog hello world how are you".split()


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("PDNLP_TPU_OFFLINE", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def varint(n):
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        out += bytes([b | (0x80 if n else 0)])
        if not n:
            return out


def field(no, wt, payload):
    if wt == 0:
        return varint(no << 3 | 0) + varint(payload)
    return varint(no << 3 | 2) + varint(len(payload)) + payload


def piece(p, score, t=1):
    body = field(1, 2, p.encode()) + varint(2 << 3 | 5) + struct.pack("<f", score) + field(3, 0, t)
    return field(1, 2, body)


UNIGRAM = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -3.0, 1), ("▁hello", -1.0, 1),
           ("▁world", -1.5, 1), ("h", -4.0, 1), ("e", -4.0, 1), ("l", -4.0, 1), ("o", -4.0, 1), ("w", -4.0, 1),
           ("r", -4.0, 1), ("d", -4.0, 1)]
BPE = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3), ("▁", -1.0, 1), ("h", -2.0, 1), ("e", -2.0, 1),
       ("l", -2.0, 1), ("o", -2.0, 1), ("w", -2.0, 1), ("r", -2.0, 1), ("d", -2.0, 1), ("he", -0.5, 1),
       ("ll", -0.6, 1), ("hell", -0.3, 1), ("hello", -0.1, 1), ("▁hello", -0.05, 1), ("wo", -0.7, 1),
       ("rl", -0.8, 1), ("world", -0.2, 1), ("▁world", -0.06, 1), ("el", -0.6, 1)]


def spm_bytes(pieces, bpe):
    proto = b"".join(piece(p, s, t) for p, s, t in pieces)
    proto += field(2, 2, field(3, 0, 2 if bpe else 1) + field(40, 0, 0) + field(41, 0, 1) + field(42, 0, 2)
                   + field(43, 0, 2**64 - 1))
    proto += field(3, 2, field(3, 0, 1))
    return proto


def wordlevel(cls):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({w: i + 4 for i, w in enumerate(WORDS)})
    t = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = Whitespace()
    return cls(tokenizer_object=t, pad_token="<pad>", bos_token="<s>", eos_token="</s>", unk_token="<unk>",
               chat_template=CHATML)


def spm_dir(tmp_path, kind):
    d = tmp_path / kind
    d.mkdir()
    (d / "tokenizer.model").write_bytes(spm_bytes(BPE if kind == "bpe" else UNIGRAM, kind == "bpe"))
    return d


def pair(tmp_path, kind):
    """(JAX tokenizer, port tokenizer) built the same way."""
    if kind == "wordlevel":
        return wordlevel(JTokenizer), wordlevel(PretrainedTokenizer)
    d = spm_dir(tmp_path, kind)
    return (JTokenizer.from_pretrained(str(d), pad_token="<unk>", eos_token="</s>", bos_token="<s>"),
            PretrainedTokenizer.from_pretrained(str(d), pad_token="<unk>", eos_token="</s>", bos_token="<s>"))


TEXTS = {"wordlevel": ["the quick brown fox", "hello world", "how are you the zebra dog", "lazy"],
         "unigram": ["hello world", "hello", "world hello hello", "held low"],
         "bpe": ["hello world", "hello", "world hello hello", "held low"]}
CALLS = {
    "plain": dict(),
    "right-pad": dict(padding=True),
    "left-pad": dict(padding=True, padding_side="left"),
    "max-length": dict(padding="max_length", max_length=9),
    "truncate": dict(truncation=True, max_length=3),
    "np-left": dict(padding=True, padding_side="left", return_tensors="np", return_token_type_ids=True),
    "no-specials": dict(add_special_tokens=False, padding=True),
    "offsets": dict(return_offsets_mapping=True),
}


def as_plain(enc):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in enc.items()}


@pytest.mark.parametrize("call", list(CALLS))
@pytest.mark.parametrize("kind", ["wordlevel", "unigram", "bpe"])
def test_encode_matches_jax(tmp_path, kind, call):
    jt, pt = pair(tmp_path, kind)
    kw = CALLS[call]
    for texts in (TEXTS[kind], TEXTS[kind][0]):
        got, want = pt(texts, **kw), jt(texts, **kw)
        assert set(got) == set(want)
        assert as_plain(got) == as_plain(want), (kind, call)
        if kw.get("return_tensors") == "np":
            assert all(isinstance(v, np.ndarray) and v.dtype == want[k].dtype for k, v in got.items())
    assert pt.encode(TEXTS[kind][2]) == jt.encode(TEXTS[kind][2])
    assert pt.tokenize(TEXTS[kind][2]) == jt.tokenize(TEXTS[kind][2])


@pytest.mark.parametrize("kind", ["wordlevel", "unigram", "bpe"])
def test_decode_and_vocab_match_jax(tmp_path, kind):
    jt, pt = pair(tmp_path, kind)
    ids = jt(TEXTS[kind], padding=True)["input_ids"]
    for skip in (True, False):
        assert pt.batch_decode(ids, skip_special_tokens=skip) == jt.batch_decode(ids, skip_special_tokens=skip)
        assert pt.decode(np.asarray(ids[0]), skip_special_tokens=skip) == jt.decode(ids[0], skip_special_tokens=skip)
    assert (pt.vocab_size, len(pt), pt.get_vocab()) == (jt.vocab_size, len(jt), jt.get_vocab())
    for attr in ("pad_token_id", "eos_token_id", "bos_token_id", "unk_token_id", "cls_token_id", "sep_token_id",
                 "mask_token_id"):
        assert getattr(pt, attr) == getattr(jt, attr), attr
    toks = pt.convert_ids_to_tokens(ids[0])
    assert toks == jt.convert_ids_to_tokens(ids[0]) and pt.convert_ids_to_tokens(3) == jt.convert_ids_to_tokens(3)
    assert pt.convert_tokens_to_ids(toks) == jt.convert_tokens_to_ids(toks)


def test_added_tokens_match_jax(tmp_path):
    jt, pt = pair(tmp_path, "wordlevel")
    counts = [(t.add_special_tokens({"sep_token": "<sep>", "additional_special_tokens": ["<|im_start|>",
                                                                                        "<|im_end|>"]}),
               t.add_tokens(["newword", "zebra"]), t.add_tokens("quick")) for t in (jt, pt)]
    assert counts[0] == counts[1] and counts[1][:2] == (3, 2)
    text = "<|im_start|>the zebra<sep>newword<|im_end|>"
    assert pt(text)["input_ids"] == jt(text)["input_ids"]
    assert pt.sep_token_id == jt.sep_token_id == 17
    ids = pt(text)["input_ids"]
    assert pt.decode(ids) == jt.decode(ids) and pt.decode(ids, skip_special_tokens=False) == jt.decode(
        ids, skip_special_tokens=False)


def test_chat_template_matches_jax(tmp_path):
    jt, pt = pair(tmp_path, "wordlevel")
    conv = [{"role": "system", "content": "the lazy dog"}, {"role": "user", "content": "hello world"},
            {"role": "assistant", "content": "how are you"}, {"role": "user", "content": "quick fox"}]
    for gen in (True, False):
        assert pt.apply_chat_template(conv, add_generation_prompt=gen) == jt.apply_chat_template(
            conv, add_generation_prompt=gen)
        assert as_plain(pt.apply_chat_template(conv, tokenize=True, add_generation_prompt=gen)) == as_plain(
            jt.apply_chat_template(conv, tokenize=True, add_generation_prompt=gen))
    bare = PretrainedTokenizer(tokenizer_object=pt._tokenizer)
    with pytest.raises(ValueError, match="chat_template"):
        bare.apply_chat_template(conv)


@pytest.mark.parametrize("kind", ["unigram", "bpe"])
def test_spm_conversion_matches_jax(tmp_path, kind):
    data = spm_bytes(BPE if kind == "bpe" else UNIGRAM, kind == "bpe")
    assert vars(parse_spm_model(data)) == vars(j_parse(data))
    path = tmp_path / "tokenizer.model"
    path.write_bytes(data)
    for kw in (dict(), dict(add_bos=False, add_eos=True), dict(add_bos=True, add_eos=True)):
        assert convert_spm_to_fast(str(path), **kw).to_str() == j_convert(str(path), **kw).to_str()
    if kind == "bpe":
        m = parse_spm_model(data)
        vocab = {p: i for i, (p, _, _) in enumerate(m.pieces)}
        scores = {p: s for p, s, _ in m.pieces}
        merges = _extract_bpe_merges(vocab, scores)
        assert merges == j_merges(vocab, scores) and len(merges) > 5


@pytest.mark.parametrize("spm_name", ["spiece.model", "tokenizer.model", "sentencepiece.bpe.model"])
def test_spm_only_checkpoints_load_like_jax(tmp_path, spm_name):
    """``from_pretrained``'s SentencePiece-only branch: the template by file
    name, ``tokenizer_config.json`` overrides and grafted language codes."""
    import json

    for i, cfg in enumerate((None, {"add_bos_token": True, "add_eos_token": True},
                             {"additional_special_tokens": ["en_XX", {"content": "ro_RO"}]})):
        d = tmp_path / f"{i}"
        d.mkdir()
        (d / spm_name).write_bytes(spm_bytes(UNIGRAM, False))
        if cfg:
            (d / "tokenizer_config.json").write_text(json.dumps(cfg))
        jt, pt = JTokenizer.from_pretrained(str(d)), PretrainedTokenizer.from_pretrained(str(d))
        assert pt._tokenizer.to_str() == jt._tokenizer.to_str()
        assert pt("hello world en_XX ro_RO")["input_ids"] == jt("hello world en_XX ro_RO")["input_ids"]


@pytest.mark.parametrize("kind", ["wordlevel", "unigram", "bpe"])
def test_saved_files_equal_and_cross_load(tmp_path, kind):
    jt, pt = pair(tmp_path, kind)
    jt.save_pretrained(str(tmp_path / "jax"))
    pt.save_pretrained(str(tmp_path / "port"))
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    from_jax = AutoTokenizer.from_pretrained(str(tmp_path / "jax"), padding_side="left")
    from_port = JTokenizer.from_pretrained(str(tmp_path / "port"), padding_side="left")
    texts = TEXTS[kind]
    assert as_plain(from_jax(texts, padding=True)) == as_plain(from_port(texts, padding=True)) == as_plain(
        jt(texts, padding=True, padding_side="left"))
    assert from_jax.chat_template == from_port.chat_template == pt.chat_template
    assert from_jax.padding_side == "left"


def test_no_tokenizers_package_raises_at_construction(monkeypatch):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    with pytest.raises(ImportError):
        PretrainedTokenizer(tokenizer_file="tokenizer.json")


def test_downloader_matches_jax(tmp_path, monkeypatch):
    for mod in (downloader, j_downloader):
        monkeypatch.setattr(mod, "MODEL_HOME", str(tmp_path / "home"))
    (tmp_path / "local").mkdir()
    (tmp_path / "local" / "config.json").write_text("{}")
    cached = tmp_path / "home" / "org" / "model"
    cached.mkdir(parents=True)
    (cached / "config.json").write_text("{}")
    for name in (str(tmp_path / "local"), "org/model", str(tmp_path / "local" / "config.json")):
        assert downloader.resolve_file(name, "config.json") == j_downloader.resolve_file(name, "config.json")
    for name in (str(tmp_path / "local"), "org/model"):
        assert downloader.resolve_model_dir(name) == j_downloader.resolve_model_dir(name)
    for call in (lambda m: m.resolve_file("no/such-model", "config.json"),
                 lambda m: m.resolve_model_dir("no/such-model"),
                 lambda m: m.resolve_file(str(tmp_path / "local"), "tokenizer.json")):
        with pytest.raises(FileNotFoundError) as got:
            call(downloader)
        with pytest.raises(FileNotFoundError) as want:
            call(j_downloader)
        assert str(got.value) == str(want.value)
    assert downloader.resolve_file("no/such-model", "x.json", required=False) is None
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        downloader.get_path_from_url("https://example.invalid/model.bin", str(tmp_path / "dl"))
    os.makedirs(tmp_path / "dl")
    (tmp_path / "dl" / "model.bin").write_bytes(b"x")
    assert downloader.get_path_from_url("https://example.invalid/model.bin", str(tmp_path / "dl")) == str(
        tmp_path / "dl" / "model.bin")
