"""The port's unified checkpoints against the JAX package's, both ways.

One JAX trainer run (the tiny LLaMA of ``tests/trainer/test_trainer.py``, 4
steps at fp32, ``save_steps`` 2: a binding clip, weight decay, warmup) is
shared by the module. Against it:

- the JAX ``checkpoint-2`` loaded by the port and saved again gives the same
  bytes in ``model.safetensors`` and ``optimizer.safetensors``, and the same
  ``trainer_state.json`` as JSON;
- the port resumes the JAX ``checkpoint-2`` and its steps 3-4 (loss, grad
  norm) and final parameters match the JAX straight run within atol 1e-5
  (fp32 summation order only, as ``test_torch_trainer.py``);
- the JAX ``load_unified_checkpoint`` of the port's ``checkpoint-4`` gives the
  port's parameters, moments and counts bit for bit.

Port only: 4 straight steps equal 2 + save + resume + 2 bit for bit (the
resumed run saving asynchronously, its ``checkpoint-4`` files byte-equal to
the straight run's), rotation at ``save_total_limit`` 2, and the chaos cases
of ``tests/robustness/test_checkpoint_atomic.py`` on the port's functions.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.trainer import Trainer as JaxTrainer
from paddlenlp_tpu.trainer import TrainingArguments as JaxArgs
from paddlenlp_tpu.trainer.unified_checkpoint import _flatten_opt_state as jax_flatten_opt_state
from paddlenlp_tpu.trainer.unified_checkpoint import load_unified_checkpoint as jax_load
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.trainer import Trainer, TrainerState, TrainingArguments
from paddlenlp_tpu_torch.trainer import unified_checkpoint as uc
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM
from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params
from paddlenlp_tpu_torch.utils.faults import FAULTS, InjectedFault

STEP_ATOL = 1e-5
PARAM_ATOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
ARGS = dict(learning_rate=1e-3, max_steps=4, save_steps=2, logging_steps=1, warmup_steps=1, max_grad_norm=0.5,
            weight_decay=0.1, seed=0)
PAYLOAD = ("model.safetensors", "optimizer.safetensors")


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny ops on one intra-op thread while this module runs:
    under the suite's parallel workers a thread pool's wake-ups cost more
    than the ops (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(trainer):
    return [h for h in trainer.state.log_history if "grad_norm" in h]


def _port_trainer(out, seed=0, **kw):
    """A port trainer on the CPU with the JAX run's global batch, from random
    weights drawn from ``seed``."""
    model = LlamaForCausalLM.init_random(LlamaConfig(**TINY), seed=seed, device="cpu", dtype=torch.float32)
    args = TrainingArguments(output_dir=str(out), per_device_train_batch_size=2 * JAX_DEVICES, **{**ARGS, **kw})
    return Trainer(model=model, args=args, train_dataset=ToyLMDataset())


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    jm = JLlama.from_config(JLlamaConfig(**TINY), seed=0)
    jt = JaxTrainer(model=jm, args=JaxArgs(output_dir=str(out), per_device_train_batch_size=2, **ARGS),
                    train_dataset=ToyLMDataset())
    jt.train()
    return dict(out=out, trainer=jt, steps=_steps(jt),
                final=flatten_params(jax.device_get(jt.model.params)))


@pytest.fixture(scope="module")
def port_resume(jax_run, tmp_path_factory):
    """The port resuming the JAX checkpoint-2 (from other random weights,
    which the checkpoint overwrites) and saving its own checkpoint-4."""
    pt = _port_trainer(tmp_path_factory.mktemp("port"), seed=7)
    pt.train(resume_from_checkpoint=str(jax_run["out"] / "checkpoint-2"))
    return pt


def test_jax_checkpoint_resaved_by_the_port_is_byte_equal(jax_run, tmp_path):
    src = jax_run["out"] / "checkpoint-2"
    pt = _port_trainer(tmp_path / "run", seed=3)
    pt.create_optimizer_and_scheduler(ARGS["max_steps"])
    state = uc.load_unified_checkpoint(str(src), model=pt.model, optimizer=pt.optimizer)
    assert state.global_step == 2 and pt.optimizer.count == 2
    dst = tmp_path / "checkpoint-2"
    uc.save_unified_checkpoint(str(dst), model=pt.model, optimizer=pt.optimizer, trainer_state=state)
    assert uc.validate_checkpoint(str(dst)) is None
    for name in PAYLOAD:
        assert filecmp.cmp(src / name, dst / name, shallow=False), name
    assert json.loads((dst / "trainer_state.json").read_text()) == json.loads((src / "trainer_state.json").read_text())


def test_port_resumes_a_jax_checkpoint_like_the_jax_straight_run(jax_run, port_resume):
    got = _steps(port_resume)
    want = jax_run["steps"]
    assert [h["global_step"] for h in got] == [1, 2, 3, 4]  # 1-2 came with the checkpoint's log
    for j, p in zip(want[2:], got[2:]):
        assert abs(j["loss"] - p["loss"]) <= STEP_ATOL, (j, p)
        assert abs(j["grad_norm"] - p["grad_norm"]) <= STEP_ATOL, (j, p)
        assert j["learning_rate"] == pytest.approx(p["learning_rate"], rel=1e-6)
    got_params = flatten_params(port_resume.model.params)
    for path, w in jax_run["final"].items():
        np.testing.assert_allclose(got_params[path].detach().numpy(), np.asarray(w), atol=PARAM_ATOL, rtol=0,
                                   err_msg=path)
    assert port_resume.optimizer.count == 4 and port_resume.state.global_step == 4


def test_jax_loads_a_port_checkpoint_bit_for_bit(jax_run, port_resume):
    ckpt = os.path.join(port_resume.args.output_dir, "checkpoint-4")
    assert uc.is_committed(ckpt)
    jt = jax_run["trainer"]
    state, trainer_state = jax_load(ckpt, model=jt.model, train_state=jt.train_state)
    assert trainer_state.global_step == 4 and int(np.asarray(state.step)) == 4
    want = flatten_params(port_resume.model.params)
    got = flatten_params(jax.device_get(state.params))
    assert set(got) == set(want)
    for path in want:
        assert np.array_equal(np.asarray(got[path]), want[path].detach().numpy()), path
    want_opt = port_resume.optimizer.state_dict()
    got_opt = jax_flatten_opt_state(jax.device_get(state.opt_state))
    assert set(got_opt) == set(want_opt)
    for key, w in want_opt.items():
        assert np.array_equal(np.asarray(got_opt[key]), w.numpy()), key


def test_resume_continues_bit_for_bit(tmp_path):
    straight = _port_trainer(tmp_path / "straight")
    straight.train()
    resumed = _port_trainer(tmp_path / "resumed", seed=11, async_save=True)
    resumed.train(resume_from_checkpoint=str(tmp_path / "straight" / "checkpoint-2"))
    keys = ("global_step", "loss", "grad_norm", "learning_rate")
    assert [[h[k] for k in keys] for h in _steps(resumed)] == [[h[k] for k in keys] for h in _steps(straight)]
    a, b = flatten_params(straight.model.params), flatten_params(resumed.model.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for name in PAYLOAD:
        assert filecmp.cmp(tmp_path / "straight" / "checkpoint-4" / name,
                           tmp_path / "resumed" / "checkpoint-4" / name, shallow=False), name
    assert uc._pending_saves == []  # train() joined and reaped the writer


def test_resume_refuses_a_checkpoint_that_lacks_a_leaf(tmp_path):
    """A tied-embedding checkpoint has no ``lm_head``: restoring it into an
    untied model of the same dimensions raises, and leaves the model as it
    was, where ``from_pretrained`` alone would initialize the head."""
    tied = LlamaForCausalLM.init_random(LlamaConfig(tie_word_embeddings=True, **TINY), seed=1, device="cpu",
                                        dtype=torch.float32)
    uc.save_unified_checkpoint(str(tmp_path / "tied"), tied)
    model = LlamaForCausalLM.init_random(LlamaConfig(**TINY), seed=0, device="cpu", dtype=torch.float32)
    before = {k: t.clone() for k, t in flatten_params(model.params).items()}
    with pytest.raises(ValueError, match=r"lacks \['lm_head/kernel'\]"):
        uc.load_unified_checkpoint(str(tmp_path / "tied"), model)
    assert all(torch.equal(before[k], t) for k, t in flatten_params(model.params).items())
    assert "lm_head" in LlamaForCausalLM.from_pretrained(str(tmp_path / "tied"), config=model.config,
                                                         device="cpu").params


def test_async_mid_run_checkpoint_resumes_bit_for_bit(tmp_path):
    """checkpoint-2's async writer is held back (a 1 s delay at its first
    shard) while steps 3-4 train: the checkpoint must still record step 2's
    trainer state, and resuming it must repeat the straight run's steps 3-6."""
    FAULTS.arm("ckpt.write_shard", action="delay", nth=1, delay_s=1.0)
    straight = _port_trainer(tmp_path / "straight", max_steps=6, async_save=True)
    straight.train()
    assert FAULTS.fired("ckpt.write_shard") == 1
    ckpt2 = tmp_path / "straight" / "checkpoint-2"
    state = json.loads((ckpt2 / "trainer_state.json").read_text())
    assert state["global_step"] == 2 and [h["global_step"] for h in state["log_history"]] == [1, 2]
    resumed = _port_trainer(tmp_path / "resumed", seed=11, max_steps=6)
    resumed.train(resume_from_checkpoint=str(ckpt2))
    keys = ("global_step", "loss", "grad_norm", "learning_rate")
    assert [[h[k] for k in keys] for h in _steps(resumed)] == [[h[k] for k in keys] for h in _steps(straight)]
    a, b = flatten_params(straight.model.params), flatten_params(resumed.model.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for name in PAYLOAD:
        assert filecmp.cmp(tmp_path / "straight" / "checkpoint-6" / name,
                           tmp_path / "resumed" / "checkpoint-6" / name, shallow=False), name


def test_rotation_keeps_the_last_two(tmp_path):
    pt = _port_trainer(tmp_path, max_steps=6, save_total_limit=2)
    pt.train()
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint")) == ["checkpoint-4", "checkpoint-6"]
    assert uc.get_last_committed_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-6")


def test_resume_true_finds_the_newest_committed_checkpoint(tmp_path):
    pt = _port_trainer(tmp_path, max_steps=2)
    pt.train()
    again = _port_trainer(tmp_path, seed=5, max_steps=4, resume_from_checkpoint=True)
    again.train()
    assert again.state.global_step == 4 and again.optimizer.count == 4
    assert [h["global_step"] for h in _steps(again)] == [1, 2, 3, 4]


# ----------------------------------------------------------------------------- chaos
@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    yield
    FAULTS.reset()


def _save(tmp_path, step, **kw):
    pt = _port_trainer(tmp_path / "scratch", seed=step)
    pt.create_optimizer_and_scheduler(8)
    pt.optimizer.count = step
    ckpt = str(tmp_path / f"checkpoint-{step}")
    uc.save_unified_checkpoint(ckpt, model=pt.model, optimizer=pt.optimizer,
                               trainer_state=TrainerState(global_step=step), **kw)
    return ckpt, pt


def _flip_last_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 1)
        byte = f.read(1)
        f.seek(size - 1)
        f.write(bytes([byte[0] ^ 0xFF]))


def _chaos_write_shard(tmp_path):
    _save(tmp_path, 2)
    FAULTS.arm("ckpt.write_shard", action="partial", nth=1)
    with pytest.raises(InjectedFault):
        _save(tmp_path, 4)
    final = str(tmp_path / "checkpoint-4")
    assert not os.path.isdir(final) and os.path.isdir(final + ".tmp")
    assert not os.path.isfile(os.path.join(final + ".tmp", uc.COMMIT_MANIFEST))
    fallback = uc.get_last_committed_checkpoint(str(tmp_path))
    assert fallback == str(tmp_path / "checkpoint-2")
    _, pt = _save(tmp_path / "other", 6)
    assert uc.load_unified_checkpoint(fallback, pt.model, pt.optimizer).global_step == 2
    assert pt.optimizer.count == 2
    assert uc.rotate_checkpoints(str(tmp_path), limit=1) == []  # the fallback is never reaped


def _chaos_commit(tmp_path):
    _save(tmp_path, 2)
    hook = []
    FAULTS.arm("ckpt.commit")
    with pytest.raises(InjectedFault):
        _save(tmp_path, 4, after_commit=lambda: hook.append(True))
    assert hook == []  # never rotate on behalf of a save that died
    assert not os.path.isdir(tmp_path / "checkpoint-4")
    assert uc.get_last_committed_checkpoint(str(tmp_path)).endswith("checkpoint-2")
    FAULTS.reset()
    ckpt, _ = _save(tmp_path, 4)  # the next save reclaims the stale staging dir
    assert uc.is_committed(ckpt) and not os.path.isdir(ckpt + ".tmp")


def _chaos_torn_dir_skipped(tmp_path):
    _save(tmp_path, 2)
    ckpt4, pt = _save(tmp_path, 4)
    opt = os.path.join(ckpt4, "optimizer.safetensors")
    with open(opt, "r+b") as f:
        f.truncate(os.path.getsize(opt) // 2)
    assert "size mismatch" in uc.validate_checkpoint(ckpt4)
    with pytest.raises(uc.CorruptCheckpointError):
        uc.load_unified_checkpoint(ckpt4, pt.model, pt.optimizer)
    assert uc.get_last_committed_checkpoint(str(tmp_path)).endswith("checkpoint-2")
    assert uc.get_last_legacy_checkpoint(str(tmp_path)) is None  # a torn committed dir is not legacy


def _chaos_hash_mismatch(tmp_path):
    _save(tmp_path, 2)
    ckpt4, pt = _save(tmp_path, 4)
    _flip_last_byte(os.path.join(ckpt4, "optimizer.safetensors"))
    assert "content hash mismatch" in uc.validate_checkpoint(ckpt4)
    assert uc.validate_checkpoint(ckpt4, verify_hashes=False) is None  # sizes alone still pass
    with pytest.raises(uc.CorruptCheckpointError):
        uc.load_unified_checkpoint(ckpt4, pt.model, pt.optimizer)
    assert uc.get_last_committed_checkpoint(str(tmp_path)).endswith("checkpoint-2")


def _chaos_best_guard(tmp_path):
    for step in (2, 4, 6):
        _save(tmp_path, step)
    rel_best = os.path.relpath(str(tmp_path / "checkpoint-2"))
    deleted = uc.rotate_checkpoints(str(tmp_path), limit=1, best_model_checkpoint=rel_best)
    assert os.path.isdir(tmp_path / "checkpoint-2")
    assert [os.path.basename(d) for d in deleted] == ["checkpoint-4"]


def _chaos_async_failure_reaped(tmp_path):
    FAULTS.arm("ckpt.write_shard", nth=1)
    _save(tmp_path, 4, async_save=True)
    assert uc.join_pending_saves(timeout=60.0) == 0
    assert uc._pending_saves == []
    assert not os.path.isdir(tmp_path / "checkpoint-4")
    assert uc.get_last_committed_checkpoint(str(tmp_path)) is None


def _chaos_async_commits_and_rotates(tmp_path):
    for step in (2, 4):
        _save(tmp_path, step)
    ckpt6, _ = _save(tmp_path, 6, async_save=True,
                     after_commit=lambda: uc.rotate_checkpoints(str(tmp_path), limit=2))
    assert uc.join_pending_saves(timeout=60.0) == 0
    assert uc.is_committed(ckpt6)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-")) == ["checkpoint-4", "checkpoint-6"]


def _chaos_legacy_load_warns(tmp_path, monkeypatch):
    ckpt, pt = _save(tmp_path, 2)
    os.unlink(os.path.join(ckpt, uc.COMMIT_MANIFEST))
    warnings = []
    monkeypatch.setattr(uc.logger, "warning", lambda msg, *a, **k: warnings.append(str(msg)))
    assert uc.load_unified_checkpoint(ckpt, pt.model, pt.optimizer).global_step == 2
    assert any("legacy" in w for w in warnings)
    assert uc.get_last_committed_checkpoint(str(tmp_path)) is None
    assert uc.get_last_legacy_checkpoint(str(tmp_path)) == ckpt


CHAOS = {"fault_at_write_shard": _chaos_write_shard, "fault_at_commit": _chaos_commit,
         "torn_dir_skipped": _chaos_torn_dir_skipped, "hash_mismatch_raises": _chaos_hash_mismatch,
         "best_guard": _chaos_best_guard, "async_failure_reaped": _chaos_async_failure_reaped,
         "async_commits_and_rotates": _chaos_async_commits_and_rotates,
         "legacy_load_warns": _chaos_legacy_load_warns}


@pytest.mark.parametrize("case", list(CHAOS))
def test_checkpoint_chaos(tmp_path, monkeypatch, case):
    fn = CHAOS[case]
    fn(tmp_path, monkeypatch) if case == "legacy_load_warns" else fn(tmp_path)
    assert uc.join_pending_saves(timeout=60.0) == 0
