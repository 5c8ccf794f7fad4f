"""Logging integrations (reference: paddlenlp/trainer/integrations.py —
``VisualDLCallback`` :78, ``TensorBoardCallback`` :162, ``WandbCallback``;
selected via ``report_to``).

Port of ``paddlenlp_tpu/trainer/integrations.py``. Zero-dependency core: a
JSONL metrics writer that any dashboard can tail; TensorBoard/W&B writers
attach when their packages exist (a one-time warning and a no-op otherwise).

``MetricsCallback`` is the training half of the shared observability plane: it
publishes step time / tokens-per-sec / MFU / loss / lr into the same
``MetricsRegistry`` the serving runtime exposes, and (opt-in via
``TrainingArguments.metrics_port``) starts a background HTTP ``/metrics`` +
``/health`` + ``/debug/trace`` exporter so training jobs are scrapeable like
serving replicas. The JAX package's compile families
(``jax_jit_compile_total``, ``jax_jit_compile_seconds_total``) stay in the
catalog and read 0: eager PyTorch compiles nothing.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Optional

from ..serving.metrics import REGISTRY, MetricsRegistry
from ..utils.env import device_peak_flops
from ..utils.import_utils import is_package_available
from ..utils.log import logger
from .trainer_callback import TrainerCallback

__all__ = [
    "JsonlLoggerCallback",
    "MetricsCallback",
    "TensorBoardCallback",
    "WandbCallback",
    "get_reporting_callbacks",
    "note_checkpoint_commit",
    "register_training_metrics",
]

# epoch time of the last committed checkpoint in this process — stamped by
# unified_checkpoint._commit_checkpoint (on the writer thread for async
# saves, i.e. at the actual rename, not at save *submission*)
_LAST_COMMIT_T: Optional[float] = None


def note_checkpoint_commit(step: Optional[int] = None, t: Optional[float] = None):
    """Record that a checkpoint commit landed (feeds
    ``ckpt_last_commit_age_seconds``). Stdlib-only so the checkpoint writer
    can call it without the metrics plane being up."""
    global _LAST_COMMIT_T
    _LAST_COMMIT_T = time.time() if t is None else float(t)


def _ckpt_commit_age_seconds() -> float:
    """NaN before the first commit — a scraper alerting on this gauge must
    distinguish 'never saved' from 'saved just now', and 0 would lie."""
    if _LAST_COMMIT_T is None:
        return float("nan")
    return max(0.0, time.time() - _LAST_COMMIT_T)


def register_training_metrics(registry: MetricsRegistry) -> dict:
    """Create (idempotently) the training metric catalog in ``registry``.

    Names and help text are the JAX package's: stable API."""
    return {
        "step_seconds": registry.histogram(
            "train_step_seconds", "Wall time per optimizer step"),
        "tokens_per_second": registry.gauge(
            "train_tokens_per_second", "Token throughput of the last step"),
        "steps": registry.counter(
            "train_steps_total", "Optimizer steps completed"),
        "tokens": registry.counter(
            "train_tokens_total", "Tokens consumed by training"),
        "loss": registry.gauge(
            "train_loss", "Last logged training loss (interval mean)"),
        "learning_rate": registry.gauge(
            "train_learning_rate", "Current learning rate"),
        "grad_norm": registry.gauge(
            "train_grad_norm", "Last logged global gradient norm"),
        "mfu": registry.gauge(
            "train_mfu", "Estimated model FLOPs utilization of the last step (0-1)"),
        "compiles": registry.counter(
            "jax_jit_compile_total", "XLA backend compilations observed"),
        "compile_seconds": registry.counter(
            "jax_jit_compile_seconds_total", "Seconds spent in XLA backend compilation"),
        "epoch": registry.gauge(
            "train_epoch", "Fractional training epoch"),
        "ckpt_age": _ckpt_age_gauge(registry),
    }


def _ckpt_age_gauge(registry: MetricsRegistry):
    """Pull-mode gauge: seconds since the last committed checkpoint (the
    async-save health signal — a growing age means the writer is wedged or
    every save is dying before its rename)."""
    g = registry.gauge(
        "ckpt_last_commit_age_seconds",
        "Seconds since the last committed checkpoint (NaN before the first commit)")
    g.set_function(_ckpt_commit_age_seconds)
    return g


class MetricsCallback(TrainerCallback):
    """Publish training step metrics into the shared ``MetricsRegistry``.

    Per step: ``train_step_seconds`` (histogram), ``train_tokens_per_second``,
    ``train_steps_total``/``train_tokens_total``, and ``train_mfu`` when the
    model reports FLOPs. Per log event: loss / learning rate / grad norm.
    Always on (registry writes are lock-protected dict updates — noise next to
    a train step); the HTTP exporter only starts when
    ``TrainingArguments.metrics_port`` is set (0 = ephemeral port, for tests;
    the bound port lands in ``self.port``).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else REGISTRY
        self.metrics = register_training_metrics(self.registry)
        self.port: Optional[int] = None
        self._exporter = None
        self._t0: Optional[float] = None
        self._model = None
        self._flops_cache: dict = {}  # seq_len -> flops per token

    def _flops_per_token(self, seq_len: Optional[int]) -> Optional[float]:
        """Per-token model flops at the step's sequence length (the quadratic
        attention term scales with seq_len; evaluating at length 1 would drop
        it and understate MFU for long sequences)."""
        if self._model is None or not hasattr(self._model, "get_model_flops"):
            return None
        key = seq_len or 1
        if key not in self._flops_cache:
            try:
                self._flops_cache[key] = float(self._model.get_model_flops(1, key)) / key
            except Exception:
                self._flops_cache[key] = None
        return self._flops_cache[key]

    # ------------------------------------------------------------- lifecycle
    def on_train_begin(self, args, state, control, model=None, **kwargs):
        self._model = model
        self._flops_cache = {}
        port = getattr(args, "metrics_port", None)
        if port is not None and self._exporter is None:
            from ..observability.exporter import ObservabilityExporter

            try:
                self._exporter = ObservabilityExporter(registry=self.registry)
                self.port = self._exporter.start(
                    host=getattr(args, "metrics_host", "127.0.0.1"), port=port)
            except OSError as e:  # EADDRINUSE etc.: observability never kills training
                logger.warning(f"metrics exporter failed to bind port {port}: {e!r}; "
                               "continuing without the HTTP plane")
                self._exporter = None
                self.port = None

    def on_train_end(self, args, state, control, **kwargs):
        if self._exporter is not None:
            self._exporter.shutdown()
            self._exporter = None
            self.port = None

    # ------------------------------------------------------------- per step
    def on_step_begin(self, args, state, control, **kwargs):
        self._t0 = time.perf_counter()

    def on_step_end(self, args, state, control, step_tokens: Optional[int] = None,
                    seq_len: Optional[int] = None, **kwargs):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        m = self.metrics
        m["step_seconds"].observe(dt)
        m["steps"].inc()
        if state.epoch is not None:
            m["epoch"].set(state.epoch)
        if step_tokens:
            m["tokens"].inc(step_tokens)
            tps = step_tokens / max(dt, 1e-9)
            m["tokens_per_second"].set(tps)
            flops_per_token = self._flops_per_token(seq_len)
            peak = device_peak_flops()
            if flops_per_token and math.isfinite(peak) and peak > 0:
                m["mfu"].set(flops_per_token * tps / peak)  # one device

    # ------------------------------------------------------------- per log
    def on_log(self, args, state, control, logs=None, **kwargs):
        if not logs:
            return
        m = self.metrics
        if "loss" in logs:
            m["loss"].set(float(logs["loss"]))
        if "learning_rate" in logs:
            m["learning_rate"].set(float(logs["learning_rate"]))
        if "grad_norm" in logs:
            m["grad_norm"].set(float(logs["grad_norm"]))


class JsonlLoggerCallback(TrainerCallback):
    """Appends one JSON object per log event to <output_dir>/metrics.jsonl."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._fh = None

    def _ensure(self, args):
        if self._fh is None:
            path = self._path or os.path.join(args.output_dir, "metrics.jsonl")
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
        return self._fh

    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs is None or not state.is_world_process_zero:
            return
        fh = self._ensure(args)
        fh.write(json.dumps({"ts": time.time(), "step": state.global_step, **logs}, default=str) + "\n")
        fh.flush()

    def on_train_end(self, args, state, control, **kwargs):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TensorBoardCallback(TrainerCallback):
    """Scalar writer over tensorboardX/torch.utils.tensorboard when available."""

    def __init__(self, log_dir: Optional[str] = None):
        self._log_dir = log_dir
        self._writer = None

    def _ensure(self, args):
        if self._writer is None:
            writer_cls = None
            if is_package_available("tensorboardX"):
                from tensorboardX import SummaryWriter as writer_cls  # noqa: N813
            elif is_package_available("torch.utils.tensorboard"):
                from torch.utils.tensorboard import SummaryWriter as writer_cls  # noqa: N813
            if writer_cls is None:
                logger.warning_once("tensorboard writer unavailable; install tensorboardX")
                return None
            self._writer = writer_cls(self._log_dir or os.path.join(args.output_dir, "runs"))
        return self._writer

    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs is None or not state.is_world_process_zero:
            return
        writer = self._ensure(args)
        if writer is None:
            return
        for k, v in logs.items():
            if isinstance(v, (int, float)):
                writer.add_scalar(k, v, state.global_step)
        writer.flush()

    def on_train_end(self, args, state, control, **kwargs):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class WandbCallback(TrainerCallback):
    """Weights & Biases reporter (reference integrations.py WandbCallback).
    Run config from TrainingArguments; project/name via WANDB_PROJECT/WANDB_NAME
    env vars (the wandb convention). No-op with a one-time warning when the
    wandb package is absent."""

    def __init__(self):
        self._run = None
        self._unavailable = False

    def _ensure(self, args):
        if self._run is not None or self._unavailable:
            return self._run
        if not is_package_available("wandb"):
            logger.warning_once("report_to=wandb but the wandb package is not installed; skipping")
            self._unavailable = True
            return None
        import wandb

        self._run = wandb.init(
            project=os.environ.get("WANDB_PROJECT", "paddlenlp_tpu_torch"),
            name=os.environ.get("WANDB_NAME") or None,
            dir=args.output_dir,
            config={k: v for k, v in vars(args).items()
                    if isinstance(v, (int, float, str, bool, type(None)))},
            resume="allow",
        )
        return self._run

    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs is None or not state.is_world_process_zero:
            return
        run = self._ensure(args)
        if run is None:
            return
        run.log({k: v for k, v in logs.items() if isinstance(v, (int, float))},
                step=state.global_step)

    def on_train_end(self, args, state, control, **kwargs):
        if self._run is not None:
            self._run.finish()
            self._run = None


def get_reporting_callbacks(report_to) -> list:
    """Map TrainingArguments.report_to names to callback instances."""
    if not report_to:
        return []
    if isinstance(report_to, str):
        report_to = [report_to]
    out = []
    for name in report_to:
        if name in ("jsonl", "json", "all"):
            out.append(JsonlLoggerCallback())
        if name in ("tensorboard", "visualdl", "all"):
            out.append(TensorBoardCallback())
        if name in ("wandb", "all"):
            out.append(WandbCallback())
        if name == "none":
            continue
    return out
