"""PEFT training in the port (LoRA, prefix tuning, VeRA) against the JAX package.

One JAX ``Trainer`` run and one port run for each case, on the same tiny
LLaMA, the same adapters and the same rows (fp32; the JAX run spreads its
batch over this suite's 8 virtual CPU devices, so the port gets
``per_device_train_batch_size`` x 8):

- LoRA, on the scanned (stacked ``[L, in, r]``) layout and on the unrolled
  one (its per-layer adapters stacked for the port): 3 steps' losses within
  rel 1e-5, the trained adapters within 1e-4 of their largest element (or
  the 1e-5 of ``tests/test_torch_checkpoint.py``, whichever is larger), and
  every base leaf bit for bit unchanged in both packages. ``grad_norm``: the
  JAX step reports the norm over every leaf, the frozen ones included; the
  port's is the norm over the adapters alone, the one the clip uses (pinned
  at step 1 against ``jax.grad``; ROADMAP Queue 3).
- The ``save_steps=2`` checkpoint: the same files, optimizer keys (optax's
  ``multi_transform`` paths) in the same order and a JAX checkpoint re-saved
  by the port byte for byte. The JAX package writes the facade's initial
  adapters there (its ``save_pretrained`` ignores the trainer's ``params``);
  the port writes the live ones, which equal the JAX run's in-memory
  adapters of step 2 (ROADMAP Queue 3). The port resumes from it bit for
  bit; the JAX package's loader cannot (an ``AttributeError``, pinned).
- ``run_finetune`` with ``lora`` and with ``prefix_tuning`` against the JAX
  ``main``: losses rel 1e-5, and the saved adapters load in each package.
- Prefix tuning: logits with and without a padding mask within rel 1e-5,
  2 steps, save and load both ways. VeRA: the seeded init bit for bit,
  2 steps, save and load both ways.
"""

import filecmp
import functools
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.peft import LoRAConfig as JLoRAConfig
from paddlenlp_tpu.peft import LoRAModel as JLoRAModel
from paddlenlp_tpu.peft import PrefixConfig as JPrefixConfig
from paddlenlp_tpu.peft import PrefixModelForCausalLM as JPrefix
from paddlenlp_tpu.peft import VeRAConfig as JVeRAConfig
from paddlenlp_tpu.peft import VeRAModel as JVeRAModel
from paddlenlp_tpu.trainer import Trainer as JTrainer
from paddlenlp_tpu.trainer import TrainingArguments as JArgs
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu.transformers.conversion_utils import flatten_params as jflatten
from paddlenlp_tpu.transformers.conversion_utils import unflatten_params as junflatten
from paddlenlp_tpu_torch.llm import run_finetune
from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel, PrefixConfig, PrefixModelForCausalLM, VeRAConfig, VeRAModel
from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
from paddlenlp_tpu_torch.trainer import unified_checkpoint as uc
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params
from paddlenlp_tpu_torch.utils.safetensors_io import SafeFile, save_file

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(vocab_size=96, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256, eos_token_id=None, pad_token_id=0)
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
REL = 1e-5  # losses and logits (fp32)
LEAF = 1e-4  # trained leaves, of their largest element ...
#: ... or this, whichever is larger: tests/test_torch_checkpoint.py's gate on
#: trained parameters. Adam divides each step by the root of its second
#: moment, so the fp32 rounding of a near-zero gradient (the gradients agree
#: to ~6e-7 of their largest) moves that element's step by up to ~1e-3 of the
#: learning rate, and B starts at 0: its largest element is a few steps' size.
PARAM_ATOL = 1e-5
TRAIN = dict(learning_rate=1e-2, warmup_steps=1, logging_steps=1, seed=0, max_grad_norm=1.0)


def _rows(n=64, T=16, seed=0, padded=False):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        ids = rng.integers(1, MODEL_KW["vocab_size"], T).astype(np.int32)
        row = {"input_ids": ids, "labels": ids.copy()}
        if padded:
            keep = int(rng.integers(T // 2, T + 1))
            mask = (np.arange(T) < keep).astype(np.int32)
            row = {"input_ids": np.where(mask == 1, ids, 0).astype(np.int32),
                   "labels": np.where(mask == 1, ids, -100).astype(np.int32), "attention_mask": mask}
        rows.append(row)
    return rows


def _stack(flat):
    """An unrolled flat tree (``layers_<i>`` paths) in the scanned layout."""
    out, groups = {}, {}
    for p, v in flat.items():
        m = re.search(r"/layers_(\d+)/", p)
        if m:
            groups.setdefault(p.replace(m.group(0), "/layers/"), {})[int(m.group(1))] = np.asarray(v)
        else:
            out[p] = np.asarray(v)
    out.update({p: np.stack([d[i] for i in sorted(d)]) for p, d in groups.items()})
    return out


def _np(flat):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v) for k, v in flat.items()}


def _close_leaf(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=0, atol=max(LEAF * float(np.abs(want).max()), PARAM_ATOL),
                               err_msg=err_msg)


def _steps(logs):
    return [h for h in logs if "grad_norm" in h]


@functools.lru_cache(maxsize=None)
def _base_weights(scan):
    """The JAX model's random weights, drawn once a module (as host arrays):
    a JAX init compiles anew for every model it builds."""
    return jax.device_get(JLlama.from_config(JLlamaConfig(use_scan_layers=scan, **MODEL_KW), seed=0).params)


def _base_model(scan=True):
    """A fresh JAX model (its own device copy of the module's weights) and the
    port model over the same weights."""
    weights = _base_weights(scan)
    jm = JLlama(JLlamaConfig(use_scan_layers=scan, **MODEL_KW), params=jax.tree_util.tree_map(jnp.array, weights))
    flat = _stack(jflatten(weights))
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**MODEL_KW), unflatten_params(flat), device="cpu")
    return jm, pm


class _CapturingJTrainer(JTrainer):
    """Keeps the live parameters of each checkpoint save."""

    def _save_checkpoint(self):
        self.saved_params = _np(jflatten(jax.device_get(self.train_state.params)))
        super()._save_checkpoint()


def _run_pair(jfacade, pfacade, rows, out, max_steps, jtrainer_cls=JTrainer, **kw):
    """A JAX and a port Trainer over the same rows; the port's frozen leaves
    are copied before the run."""
    mask = flatten_params(pfacade.trainable_mask())
    frozen = {k: v.clone() for k, v in flatten_params(pfacade.params).items() if not mask[k]}
    jinit = _np(jflatten(jax.device_get(jfacade.params)))
    jt = jtrainer_cls(model=jfacade, train_dataset=rows,
                      args=JArgs(output_dir=str(out / "jax"), max_steps=max_steps, per_device_train_batch_size=1,
                                 **TRAIN, **kw))
    jt.train()
    pt = Trainer(model=pfacade, train_dataset=rows,
                 args=TrainingArguments(output_dir=str(out / "port"), max_steps=max_steps,
                                        per_device_train_batch_size=JAX_DEVICES, **TRAIN, **kw))
    pt.train()
    return dict(jt=jt, pt=pt, jinit=jinit, frozen=frozen, out=out)


def _check_steps_and_leaves(run, trainable, stack=lambda f: f):
    j, p = _steps(run["jt"].state.log_history), _steps(run["pt"].state.log_history)
    assert len(j) == len(p) > 0
    for a, b in zip(p, j):
        assert a["loss"] == pytest.approx(b["loss"], rel=REL), (a, b)
        assert a["learning_rate"] == pytest.approx(b["learning_rate"], rel=1e-6)
    jfinal = stack(_np(jflatten(jax.device_get(run["jt"].train_state.params))))
    jinit = stack(run["jinit"])
    pfinal = _np(flatten_params(run["pt"].model.params))
    assert set(pfinal) == set(jfinal)
    moved = 0
    for path, want in jfinal.items():
        if trainable(path):
            _close_leaf(pfinal[path], want, path)
            moved += not np.array_equal(want, jinit[path])
        else:  # frozen: bit for bit in both packages
            assert np.array_equal(want, jinit[path]), path
            assert torch.equal(flatten_params(run["pt"].model.params)[path], run["frozen"][path]), path
    assert moved


def _is_lora(p):
    return "/lora_" in p


# ----------------------------------------------------------------------------- LoRA through the Trainer
@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    runs = {}
    for layout in ("stacked", "unrolled"):
        jm, pm = _base_model(scan=layout == "stacked")
        jl = JLoRAModel(jm, JLoRAConfig(r=4, lora_alpha=8))
        if layout == "stacked":
            pl = LoRAModel(pm, LoRAConfig(r=4, lora_alpha=8))
        else:  # the JAX per-layer adapters, stacked
            adapters = {k: torch.from_numpy(v) for k, v in _stack(_np(jflatten(jax.device_get(jl.params)))).items()
                        if _is_lora(k)}
            pl = LoRAModel(pm, LoRAConfig(r=4, lora_alpha=8),
                           params=unflatten_params({**flatten_params(pm.params), **adapters}))
        save = dict(save_steps=2) if layout == "stacked" else {}
        runs[layout] = _run_pair(jl, pl, _rows(), tmp_path_factory.mktemp(f"lora-{layout}"), 3,
                                 jtrainer_cls=_CapturingJTrainer, **save)
    return runs


@pytest.mark.parametrize("layout", ["stacked", "unrolled"])
def test_lora_steps_match_jax(lora_runs, layout):
    run = lora_runs[layout]
    _check_steps_and_leaves(run, _is_lora, stack=_stack if layout == "unrolled" else (lambda f: f))
    assert len(_steps(run["pt"].state.log_history)) == 3
    assert sorted(run["pt"].optimizer.mu) == sorted(k for k in flatten_params(run["pt"].model.params) if _is_lora(k))


def test_lora_grad_norm_counts_the_trainable_leaves_only(lora_runs):
    """The pinned departure: JAX's step-1 ``grad_norm`` is the norm over every
    leaf; the port's is the norm over the adapters alone."""
    run = lora_runs["stacked"]
    pt, jt = run["pt"], run["jt"]
    dl = pt.get_train_dataloader()
    dl.set_epoch(0)
    batch = {k: jnp.asarray(v) for k, v in next(iter(dl)).items()}
    init = junflatten({k: jnp.asarray(v) for k, v in run["jinit"].items()})
    grads = jflatten(jax.grad(lambda p: jt.compute_loss(p, batch))(init))
    norm_all = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum() for g in grads.values())))
    norm_lora = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum() for k, g in grads.items()
                                  if _is_lora(k))))
    jstep, pstep = _steps(jt.state.log_history)[0], _steps(pt.state.log_history)[0]
    assert jstep["grad_norm"] == pytest.approx(norm_all, rel=REL)
    assert pstep["grad_norm"] == pytest.approx(norm_lora, rel=REL)
    assert norm_lora < 0.5 * norm_all  # B = 0 at step 1: only B's gradient is non-zero among the adapters


def test_lora_checkpoint_matches_jax(lora_runs, tmp_path):
    run = lora_runs["stacked"]
    jdir, pdir = run["out"] / "jax" / "checkpoint-2", run["out"] / "port" / "checkpoint-2"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    assert filecmp.cmp(jdir / "lora_config.json", pdir / "lora_config.json", shallow=False)
    with SafeFile(str(jdir / "optimizer.safetensors")) as j, SafeFile(str(pdir / "optimizer.safetensors")) as p:
        assert list(j.keys()) == list(p.keys())
        assert list(p.keys())[0].startswith("inner_states/train/inner_state/1/0/")
        for k in j.keys():
            _close_leaf(p.get_torch(k).numpy(), j.get_torch(k).numpy(), k)
    jfile, pfile = LoRAModel.saved_leaves(str(jdir)), LoRAModel.saved_leaves(str(pdir))
    assert list(jfile) == list(pfile)
    for k in jfile:
        # the JAX file holds the initial adapters; the port's the live ones of step 2
        assert np.array_equal(jfile[k].numpy(), run["jinit"][k]), k
        _close_leaf(pfile[k].numpy(), run["jt"].saved_params[k], k)
    # a JAX checkpoint re-saved by the port: byte for byte
    pl = LoRAModel(_base_model()[1], LoRAConfig(r=4, lora_alpha=8))
    t = Trainer(model=pl, train_dataset=_rows(), args=TrainingArguments(
        output_dir=str(tmp_path), max_steps=3, per_device_train_batch_size=JAX_DEVICES, **TRAIN))
    t.create_optimizer_and_scheduler(3)
    state = uc.load_unified_checkpoint(str(jdir), model=pl, optimizer=t.optimizer)
    assert state.global_step == 2 and t.optimizer.count == 2
    dst = tmp_path / "checkpoint-2"
    uc.save_unified_checkpoint(str(dst), model=pl, optimizer=t.optimizer, trainer_state=state)
    for name in ("lora_model.safetensors", "optimizer.safetensors", "lora_config.json"):
        assert filecmp.cmp(jdir / name, dst / name, shallow=False), name
    # the JAX package cannot resume it: its loader reads the facade as a
    # model (``model.param_dtype``, then ``type(model).from_pretrained``
    # with a model's keywords; ROADMAP Queue 3)
    from paddlenlp_tpu.trainer.unified_checkpoint import load_unified_checkpoint as jax_load

    with pytest.raises(AttributeError, match="param_dtype"):
        jax_load(str(jdir), model=run["jt"].model, train_state=run["jt"].train_state)


def test_lora_resumes_bit_for_bit(lora_runs, tmp_path):
    run = lora_runs["stacked"]
    pl = LoRAModel(_base_model()[1], LoRAConfig(r=4, lora_alpha=8))
    t = Trainer(model=pl, train_dataset=_rows(), args=TrainingArguments(
        output_dir=str(tmp_path), max_steps=3, per_device_train_batch_size=JAX_DEVICES, **TRAIN))
    t.train(resume_from_checkpoint=str(run["out"] / "port" / "checkpoint-2"))
    straight = flatten_params(run["pt"].model.params)
    for k, v in flatten_params(pl.params).items():
        assert torch.equal(v, straight[k]), k
    assert _steps(t.state.log_history)[-1]["loss"] == _steps(run["pt"].state.log_history)[-1]["loss"]
    # a checkpoint without the adapters is refused
    empty = tmp_path / "empty"
    LoRAConfig(r=4, lora_alpha=8).save_pretrained(str(empty))
    save_file({}, str(empty / "lora_model.safetensors"), metadata={"format": "np"})
    with pytest.raises(ValueError, match="lacks"):
        uc.load_unified_checkpoint(str(empty), model=pl)


def test_lora_trainable_counts_match_jax():
    jm, pm = _base_model()
    jl = JLoRAModel(jm, JLoRAConfig(r=4, lora_alpha=8))
    pl = LoRAModel(pm, LoRAConfig(r=4, lora_alpha=8))
    flat = jflatten(jax.device_get(jl.params))
    want = (sum(int(np.prod(v.shape)) for k, v in flat.items() if "/lora_" in k),
            sum(int(np.prod(v.shape)) for v in flat.values()))
    assert pl.print_trainable_parameters() == want
    assert flatten_params(pl.mark_only_lora_as_trainable()) == {k: bool(v) for k, v in
                                                                jflatten(jl.mark_only_lora_as_trainable()).items()}


@pytest.mark.parametrize("kind", ["lora", "prefix", "vera"])
def test_facade_num_parameters_counts_the_given_tree(kind):
    """Each facade counts its own tree as the JAX facade does, and the tree
    it is given where there is one (the JAX prefix facade ignores it)."""
    jm, pm = _base_model()
    jcls, pcls = {"lora": (JLoRAModel, LoRAModel), "prefix": (JPrefix, PrefixModelForCausalLM),
                  "vera": (JVeRAModel, VeRAModel)}[kind]
    jf, pf = jcls(jm), pcls(pm)
    assert pf.num_parameters() == jf.num_parameters()
    assert pf.num_parameters(pm.params) == pm.num_parameters() < pf.num_parameters()


# ----------------------------------------------------------------------------- prefix tuning
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
def test_prefix_logits_match_jax(masked):
    jm, pm = _base_model()
    jp, pp = JPrefix(jm, JPrefixConfig(num_prefix_tokens=5)), PrefixModelForCausalLM(pm, PrefixConfig(5))
    np.testing.assert_array_equal(pp.params["prefix_kv"].numpy(), np.asarray(jp.params["prefix_kv"]))
    rows = _rows(n=3, T=12, seed=4, padded=True)
    ids = np.stack([r["input_ids"] for r in rows])
    mask = np.stack([r["attention_mask"] for r in rows]) if masked else None
    want = np.asarray(jp(input_ids=jnp.asarray(ids),
                         attention_mask=None if mask is None else jnp.asarray(mask)).logits)
    got = pp(torch.from_numpy(ids), attention_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    assert got.shape == (3, 12, MODEL_KW["vocab_size"])


@pytest.fixture(scope="module")
def prefix_run(tmp_path_factory):
    jm, pm = _base_model()
    return _run_pair(JPrefix(jm, JPrefixConfig(num_prefix_tokens=5)), PrefixModelForCausalLM(pm, PrefixConfig(5)),
                     _rows(padded=True), tmp_path_factory.mktemp("prefix"), 2)


def test_prefix_steps_match_jax(prefix_run):
    _check_steps_and_leaves(prefix_run, lambda p: p.startswith("prefix_kv"))
    counts = prefix_run["pt"].model.print_trainable_parameters()
    assert counts == (2 * 2 * 5 * 2 * 16, prefix_run["pt"].model.model.num_parameters() + 2 * 2 * 5 * 2 * 16)


def test_prefix_save_and_load_cross_both_ways(prefix_run, tmp_path):
    pp, jp = prefix_run["pt"].model, prefix_run["jt"].model
    pp.save_pretrained(str(tmp_path / "port"))
    jp.save_pretrained(str(tmp_path / "jax"))
    assert filecmp.cmp(tmp_path / "port" / "prefix_config.json", tmp_path / "jax" / "prefix_config.json",
                       shallow=False)
    jm, pm = _base_model()
    back = JPrefix.from_pretrained(jm, str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.params["prefix_kv"]), pp.params["prefix_kv"].detach().numpy())
    here = PrefixModelForCausalLM.from_pretrained(pm, str(tmp_path / "jax"))
    np.testing.assert_array_equal(here.params["prefix_kv"].numpy(), np.asarray(jp.params["prefix_kv"]))


# ----------------------------------------------------------------------------- VeRA
def test_vera_init_matches_jax():
    jm, pm = _base_model()
    jv, pv = JVeRAModel(jm, JVeRAConfig(r=4, seed=3)), VeRAModel(pm, VeRAConfig(r=4, seed=3))
    want, got = _np(jflatten(jax.device_get(jv.params))), _np(flatten_params(pv.params))
    assert sorted(got) == sorted(want) and any(k.startswith("vera_shared/") for k in got)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert flatten_params(pv.trainable_mask()) == {k: bool(v) for k, v in jflatten(jv.trainable_mask()).items()}
    flat = jflatten(jax.device_get(jv.params))
    assert pv.print_trainable_parameters() == (
        sum(int(np.prod(v.shape)) for k, v in flat.items() if "/vera_d" in k or "/vera_b" in k),
        sum(int(np.prod(v.shape)) for v in flat.values()))


@pytest.fixture(scope="module")
def vera_run(tmp_path_factory):
    jm, pm = _base_model()
    return _run_pair(JVeRAModel(jm, JVeRAConfig(r=4)), VeRAModel(pm, VeRAConfig(r=4)), _rows(),
                     tmp_path_factory.mktemp("vera"), 2)


def test_vera_steps_match_jax(vera_run):
    _check_steps_and_leaves(vera_run, lambda p: "/vera_d" in p or "/vera_b" in p)
    ids = torch.from_numpy(_rows(n=2, seed=9)[0]["input_ids"][None])
    pv, jv = vera_run["pt"].model, vera_run["jt"].model
    np.testing.assert_allclose(pv(ids).numpy(), np.asarray(jv(input_ids=jnp.asarray(ids.numpy())).logits),
                               rtol=1e-4, atol=1e-4)


def test_vera_save_and_load_cross_both_ways(vera_run, tmp_path):
    pv, jv = vera_run["pt"].model, vera_run["jt"].model
    pv.save_pretrained(str(tmp_path / "port"))
    jv.save_pretrained(str(tmp_path / "jax"))
    assert filecmp.cmp(tmp_path / "port" / "vera_config.json", tmp_path / "jax" / "vera_config.json", shallow=False)
    assert list(VeRAModel.saved_leaves(str(tmp_path / "port"))) == list(VeRAModel.saved_leaves(str(tmp_path / "jax")))
    jm, pm = _base_model()
    back = _np(jflatten(jax.device_get(JVeRAModel.from_pretrained(jm, str(tmp_path / "port")).params)))
    for k, v in _np(flatten_params(pv.params)).items():
        assert np.array_equal(back[k], v), k
    here = _np(flatten_params(VeRAModel.from_pretrained(pm, str(tmp_path / "jax")).params))
    for k, v in _np(jflatten(jax.device_get(jv.params))).items():
        assert np.array_equal(here[k], v), k


# ----------------------------------------------------------------------------- run_finetune --lora / --prefix_tuning
def _load_jax_finetune():
    import importlib.util

    spec = importlib.util.spec_from_file_location("_jax_run_finetune_peft", os.path.join(REPO, "llm",
                                                                                       "run_finetune.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _finetune_hub(root):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from paddlenlp_tpu.transformers import PretrainedTokenizer as JTokenizer

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
    data = root / "sft"
    data.mkdir()
    rows = [{"src": "a b c", "tgt": "d e"}, {"src": "f g", "tgt": "h i j k"}, {"src": "l", "tgt": "m n o p a"}] * 16
    (data / "train.json").write_text("".join(json.dumps(r) + "\n" for r in rows))
    return model_dir, data


@pytest.fixture(scope="module")
def peft_finetune_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("peft-hub")
    model_dir, data = _finetune_hub(root)
    jr = _load_jax_finetune()
    runs = {}
    for flag in ("lora", "prefix_tuning"):
        runs[flag] = {}
        for who, batch in (("jax", 1), ("port", JAX_DEVICES)):
            args = dict(model_name_or_path=str(model_dir), dataset_name_or_path=str(data),
                        output_dir=str(root / flag / who), max_length=16, src_length=8, zero_padding=False,
                        per_device_train_batch_size=batch, max_steps=3, logging_steps=1, save_strategy="no",
                        do_train=True, dtype="float32", learning_rate=3e-3, warmup_steps=1, seed=0, lora_rank=4,
                        num_prefix_tokens=4, **{flag: True})
            path = root / f"{flag}-{who}.json"
            path.write_text(json.dumps(args))
            if who == "jax":
                argv, sys.argv = sys.argv, ["run_finetune.py", str(path)]
                try:
                    trainer = jr.main()
                finally:
                    sys.argv = argv
            else:
                trainer = run_finetune.main([str(path)], device="cpu")
            runs[flag][who] = dict(trainer=trainer, out=root / flag / who)
    return runs


@pytest.mark.parametrize("flag", ["lora", "prefix_tuning"])
def test_run_finetune_peft_matches_jax(peft_finetune_runs, flag):
    j, p = peft_finetune_runs[flag]["jax"], peft_finetune_runs[flag]["port"]
    jsteps, psteps = _steps(j["trainer"].state.log_history), _steps(p["trainer"].state.log_history)
    assert len(jsteps) == len(psteps) == 3
    for a, b in zip(psteps, jsteps):
        assert a["loss"] == pytest.approx(b["loss"], rel=REL), (a, b)
    facade = {"lora": (LoRAModel, JLoRAModel), "prefix_tuning": (PrefixModelForCausalLM, JPrefix)}[flag]
    assert isinstance(p["trainer"].model, facade[0]) and isinstance(j["trainer"].model, facade[1])
    assert sorted(os.listdir(p["out"])) == sorted(os.listdir(j["out"]))
    saved, jsaved = facade[0].saved_leaves(str(p["out"])), facade[0].saved_leaves(str(j["out"]))
    assert list(saved) == list(jsaved)
    for k in saved:
        _close_leaf(saved[k].numpy(), jsaved[k].numpy(), k)
    # each package loads the other's adapter directory
    from paddlenlp_tpu.transformers import AutoModelForCausalLM as JAuto

    from paddlenlp_tpu_torch.transformers import AutoModelForCausalLM

    model_dir = str(p["trainer"].args.output_dir).replace(f"{flag}/port", "tiny-llama")
    jback = facade[1].from_pretrained(JAuto.from_pretrained(model_dir), str(p["out"]))
    pback = facade[0].from_pretrained(AutoModelForCausalLM.from_pretrained(model_dir, device="cpu"), str(j["out"]))
    jflat, pflat = _np(jflatten(jax.device_get(jback.params))), _np(flatten_params(pback.params))
    for k in saved:
        assert np.array_equal(jflat[k], saved[k].numpy()), k
        assert np.array_equal(pflat[k], jsaved[k].numpy()), k
