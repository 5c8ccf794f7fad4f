"""The port's trainer extras against the JAX trainer's: ``skip_data_intervals``,
``evaluate`` with ``compute_metrics``, ``predict``, the metrics exporter on
``metrics_port``, ``report_to=["jsonl"]``, and (port only) the profiler window.

One JAX run and one port run share the module: the tiny LLaMA of
``tests/trainer/test_trainer.py`` from the same initial parameters at fp32,
4 steps with data steps 2-3 skipped, the exporter on an ephemeral port
scraped when training begins and after the last step, a JSONL report, and
``evaluate``/``predict`` with ``compute_metrics`` before training. Losses,
grad norms, logits and metrics within atol 1e-5 (fp32 summation order only,
as ``test_torch_trainer.py``); counters, families, keys and data steps exact.
"""

import json
import os
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paddlenlp_tpu.serving.metrics import MetricsRegistry as JaxRegistry
from paddlenlp_tpu.trainer import Trainer as JaxTrainer
from paddlenlp_tpu.trainer import TrainerCallback as JaxCallback
from paddlenlp_tpu.trainer import TrainingArguments as JaxArgs
from paddlenlp_tpu.trainer.integrations import MetricsCallback as JaxMetricsCallback
from paddlenlp_tpu.trainer.integrations import register_training_metrics as jax_register
from paddlenlp_tpu.transformers import LlamaConfig as JLlamaConfig
from paddlenlp_tpu.transformers import LlamaForCausalLM as JLlama
from paddlenlp_tpu_torch.serving.metrics import MetricsRegistry
from paddlenlp_tpu_torch.trainer import Trainer, TrainerCallback, TrainingArguments
from paddlenlp_tpu_torch.trainer.integrations import MetricsCallback, register_training_metrics
from paddlenlp_tpu_torch.transformers import LlamaConfig, LlamaForCausalLM

ATOL = 1e-5
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
JAX_DEVICES = 8  # tests/conftest.py's virtual CPU devices: the JAX trainer's data shards
ARGS = dict(learning_rate=1e-3, max_steps=4, logging_steps=1, warmup_steps=1, max_grad_norm=0.5, seed=0,
            save_strategy="no", skip_data_intervals=[[2, 3]], metrics_port=0, report_to=["jsonl"])
COUNTERS = ("train_steps_total", "train_tokens_total")


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


def compute_metrics(p):
    """Next-token accuracy of the logits' argmax and their mean."""
    hit = np.argmax(p.predictions[:, :-1], axis=-1) == p.label_ids[:, 1:]
    return {"accuracy": float(hit.mean()), "mean_logit": float(np.mean(p.predictions))}


def _scraper(base, metrics_cls, out):
    """A callback reading the trainer's exporter (the first ``metrics_cls``
    callback's port) at train begin and after the last step's log."""
    class Scrape(base):
        trainer = None

        def _scrape(self, when):
            port = next(cb.port for cb in self.trainer.callback_handler.callbacks if isinstance(cb, metrics_cls))
            get = lambda path: urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30).read()  # noqa: E731
            out[when] = dict(metrics=get("/metrics").decode(), health=json.loads(get("/health")))

        def on_train_begin(self, args, state, control, **kw):
            self._scrape("begin")

        def on_log(self, args, state, control, logs=None, **kw):
            if state.global_step == args.max_steps and "grad_norm" in (logs or {}):
                self._scrape("end")

    return Scrape()


def _run(trainer, scrape):
    scrape.trainer = trainer
    trainer.add_callback(scrape)
    ev = trainer.evaluate()
    pred = trainer.predict(ToyLMDataset(n=24, seed=2))
    trainer.train()
    return ev, pred


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm = JLlama.from_config(JLlamaConfig(**TINY), seed=0)
    pm = LlamaForCausalLM.from_jax_params(LlamaConfig(**TINY), jax.device_get(jm.params), device="cpu")
    out = {}
    for name, trainer_cls, args_cls, model, batch, extra, cb_base, metrics_cls in (
            ("jax", JaxTrainer, JaxArgs, jm, 2, {}, JaxCallback, JaxMetricsCallback),
            ("port", Trainer, TrainingArguments, pm, 2 * JAX_DEVICES,
             dict(profiler_options=f"batch_range=[1,3];profile_path={tmp_path_factory.mktemp('prof')}"),
             TrainerCallback, MetricsCallback)):
        scraped = {}
        args = args_cls(output_dir=str(tmp_path_factory.mktemp(name)), per_device_train_batch_size=batch,
                        per_device_eval_batch_size=batch, **ARGS, **extra)
        trainer = trainer_cls(model=model, args=args, train_dataset=ToyLMDataset(),
                              eval_dataset=ToyLMDataset(n=24, seed=1), compute_metrics=compute_metrics)
        ev, pred = _run(trainer, _scraper(cb_base, metrics_cls, scraped))
        out[name] = dict(trainer=trainer, eval=ev, pred=pred, scraped=scraped)
    return out


def _steps(trainer):
    return [h for h in trainer.state.log_history if "grad_norm" in h]


def test_skip_data_intervals_logs_match(runs):
    jt, pt = runs["jax"]["trainer"], runs["port"]["trainer"]
    j, p = _steps(jt), _steps(pt)
    assert [h["global_step"] for h in j] == [h["global_step"] for h in p] == [1, 2, 3, 4]
    for a, b in zip(j, p):
        assert abs(a["loss"] - b["loss"]) <= ATOL, (a, b)
        assert abs(a["grad_norm"] - b["grad_norm"]) <= ATOL, (a, b)
    for key in ("global_step", "data_step", "consumed_samples"):
        assert getattr(jt.state, key) == getattr(pt.state, key), key
    assert pt.state.data_step == 6  # data steps 2 and 3 consumed untrained


def test_evaluate_and_predict_with_compute_metrics_match(runs):
    je, pe = runs["jax"]["eval"], runs["port"]["eval"]
    for key in ("eval_loss", "eval_accuracy", "eval_mean_logit"):
        assert abs(je[key] - pe[key]) <= ATOL, (key, je[key], pe[key])
    jp, pp = runs["jax"]["pred"], runs["port"]["pred"]
    assert pp.predictions.shape == jp.predictions.shape == (24, 16, TINY["vocab_size"])
    np.testing.assert_allclose(pp.predictions, np.asarray(jp.predictions, np.float32), atol=ATOL, rtol=0)
    assert np.array_equal(pp.label_ids, jp.label_ids)
    assert pp.metrics.keys() == jp.metrics.keys() == {"test_accuracy", "test_mean_logit"}
    for key in jp.metrics:
        assert abs(pp.metrics[key] - jp.metrics[key]) <= ATOL, key


def _families(text):
    """{name: (kind, help)} of a Prometheus exposition."""
    kinds = dict(ln.split()[2:4] for ln in text.splitlines() if ln.startswith("# TYPE "))
    helps = {ln.split()[2]: ln.split(" ", 3)[3] for ln in text.splitlines() if ln.startswith("# HELP ")}
    return {n: (k, helps.get(n)) for n, k in kinds.items()}


def _value(text, name):
    return float(next(ln.split()[1] for ln in text.splitlines() if ln.startswith(name + " ")))


def test_metrics_exporter_serves_the_jax_families_and_counters(runs):
    catalog = set(jax_register(JaxRegistry()))
    assert set(register_training_metrics(MetricsRegistry())) == catalog
    jax_s, port_s = runs["jax"]["scraped"], runs["port"]["scraped"]
    want = {n: f for n, f in _families(jax_s["end"]["metrics"]).items()
            if n.startswith(("train_", "ckpt_", "jax_jit_"))}
    got = _families(port_s["end"]["metrics"])
    assert len(want) == len(catalog)
    assert {n: got.get(n) for n in want} == want
    for name in COUNTERS:
        deltas = [_value(s["end"]["metrics"], name) - _value(s["begin"]["metrics"], name) for s in (jax_s, port_s)]
        assert deltas[0] == deltas[1] > 0, (name, deltas)
    assert port_s["end"]["health"].keys() == jax_s["end"]["health"].keys()
    port_loss = _value(port_s["end"]["metrics"], "train_loss")
    assert abs(port_loss - _value(jax_s["end"]["metrics"], "train_loss")) <= ATOL


def test_jsonl_report_writes_the_same_keys(runs):
    keys = {}
    for name in ("jax", "port"):
        with open(os.path.join(runs[name]["trainer"].args.output_dir, "metrics.jsonl")) as f:
            keys[name] = [sorted(json.loads(line)) for line in f]
    assert len(keys["port"]) == 4  # one line a step's log
    assert keys["port"] == keys["jax"]


def test_profiler_window_writes_its_trace_and_spans(runs):
    path = runs["port"]["trainer"].args.profiler_options.split("profile_path=")[1]
    assert sorted(os.listdir(path)) == ["span_timeline.json", "spans.jsonl", "trace.json"]
    with open(os.path.join(path, "trace.json")) as f:
        trace = json.load(f)
    assert any(e.get("name", "").startswith("aten::mm") for e in trace["traceEvents"])
    with open(os.path.join(path, "span_timeline.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"profiler_window_start", "train_step"} <= names
    with open(os.path.join(path, "spans.jsonl")) as f:
        spans = [json.loads(line) for line in f if line.strip()]
    assert [s["args"]["step"] for s in spans if s["name"] == "train_step"] == [2, 3]
