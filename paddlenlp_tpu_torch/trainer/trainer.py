"""``Trainer`` — HF-style training loop on one device.

Port of ``paddlenlp_tpu/trainer/trainer.py``: the optimizer (:125-170), the
train step (:346-377), the loop (:557-736) with its resume, data skip,
``skip_data_intervals``, profiler window and checkpoint saves, ``evaluate``
and ``predict`` (:786-914), and the checkpoint plumbing (:916-972). Where the
JAX trainer jits one step over a sharded mesh, this one runs eagerly on the
device that holds the model's parameters (``model.device``: the card, unless
the model was built with ``device="cpu"``), with explicit generators for every
random draw.

The optimizer is ``ops.optimizer.AdamW``, with optax's semantics. Gradient
accumulation sums the micro-batch grads and divides by their count; the
reported loss is the mean of the micro losses and ``grad_norm`` the global
norm before clipping.

Checkpoints (``save_steps``, ``resume_from_checkpoint``) are the JAX
package's unified checkpoints, file for file (``unified_checkpoint.py``). A
resumed run restores the parameters and the optimizer's moments and count in
place, skips the batches the checkpoint's step consumed, and continues bit
for bit as the run that saved it would have.

PEFT models (``LoRAModel``, ``PrefixModelForCausalLM``, ``VeRAModel``) carry a
``trainable_mask``: as under the JAX trainer's ``optax.multi_transform``
(:164-167), only the trainable leaves get optimizer state, clipping and
updates; the frozen ones are left bit for bit. Only the trainable leaves take
gradients here, so ``grad_norm`` is their norm, the one the clip uses (the JAX
step reports the norm over every leaf, frozen ones included; ROADMAP Queue 3).

What the JAX trainer does and this one does not yet raises
``NotImplementedError`` naming the ROADMAP item: the parallel degrees
(``TrainingArguments.check_supported``) and dropout.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability.tracer import TRACER
from ..ops.cross_entropy import causal_lm_loss
from ..ops.optimizer import AdamW, global_norm
from ..transformers.conversion_utils import flatten_params
from ..utils.log import logger
from .integrations import MetricsCallback, get_reporting_callbacks
from .trainer_callback import CallbackHandler, DefaultFlowCallback, ProgressCallback, TrainerControl, TrainerState
from .timer import Timers
from .trainer_utils import (PREFIX_CHECKPOINT_DIR, EvalPrediction, IntervalStrategy, PredictionOutput, TrainOutput,
                            get_scheduler, has_length, set_seed, speed_metrics)
from .training_args import TrainingArguments

__all__ = ["AdamW", "Trainer"]

DEFAULT_CALLBACKS = [DefaultFlowCallback, ProgressCallback]

_TRAINING_LEFT = "ROADMAP Queue 1 item 15"


class Trainer:
    def __init__(
        self,
        model=None,
        criterion: Optional[Callable] = None,
        args: Optional[TrainingArguments] = None,
        data_collator: Optional[Callable] = None,
        train_dataset=None,
        eval_dataset=None,
        tokenizer=None,
        compute_metrics: Optional[Callable] = None,
        callbacks: Optional[List] = None,
        optimizers: Tuple = (None, None),
        preprocess_logits_for_metrics: Optional[Callable] = None,
    ):
        if args is None:
            args = TrainingArguments(output_dir="tmp_trainer")
        args.check_supported()
        cfg = model.config
        if any(getattr(cfg, a, 0.0) for a in ("attention_dropout", "hidden_dropout", "resid_pdrop", "embd_pdrop",
                                              "attn_pdrop", "hidden_dropout_prob",
                                              "attention_probs_dropout_prob")):
            raise NotImplementedError(f"dropout > 0 is not part of the port's trainer yet ({_TRAINING_LEFT})")
        self.args = args
        self.model = model
        self.criterion = criterion
        self.data_collator = data_collator if data_collator is not None else _default_collator
        self.train_dataset = train_dataset
        self.eval_dataset = eval_dataset
        self.tokenizer = tokenizer
        self.compute_metrics = compute_metrics
        self.preprocess_logits_for_metrics = preprocess_logits_for_metrics
        self.optimizer, self.lr_scheduler = optimizers
        self.state = TrainerState()
        self.control = TrainerControl()
        self.device = model.device
        self._profiler = None
        # MetricsCallback feeds the shared metrics plane (serving.metrics.REGISTRY)
        # on every run; its HTTP exporter only starts when args.metrics_port is set
        callbacks = DEFAULT_CALLBACKS + [MetricsCallback] + get_reporting_callbacks(args.report_to) + (callbacks or [])
        self.callback_handler = CallbackHandler(callbacks, self.model, self.tokenizer)
        self.timers = Timers()
        set_seed(args.seed)
        self.control = self.callback_handler.on_init_end(self.args, self.state, self.control)

    # ------------------------------------------------------------------ setup
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's leaves by flat name (the same tensors, not copies)."""
        return flatten_params(self.model.params)

    @property
    def trainable_params(self) -> Dict[str, torch.Tensor]:
        """The leaves the optimizer updates by flat name: those the model's
        ``trainable_mask`` marks, or every leaf of a model without one."""
        params = self.params
        if not hasattr(self.model, "trainable_mask"):
            return params
        mask = flatten_params(self.model.trainable_mask())
        return {k: v for k, v in params.items() if mask[k]}

    def create_optimizer_and_scheduler(self, num_training_steps: int):
        args = self.args
        if self.lr_scheduler is None:
            self.lr_scheduler = get_scheduler(args.lr_scheduler_type, args.learning_rate,
                                              args.get_warmup_steps(num_training_steps), num_training_steps,
                                              min_lr=args.min_learning_rate)
        if self.optimizer is None:
            self.optimizer = AdamW(self.trainable_params, self.lr_scheduler, b1=args.adam_beta1, b2=args.adam_beta2,
                                   eps=args.adam_epsilon, weight_decay=args.weight_decay,
                                   max_grad_norm=args.max_grad_norm, masked=hasattr(self.model, "trainable_mask"))
        return self.optimizer

    # ------------------------------------------------------------------ loss and step
    def compute_loss(self, inputs: Dict[str, torch.Tensor], params: Optional[dict] = None) -> torch.Tensor:
        """Override point. ``labels`` follow the HF convention (unshifted; the
        causal shift happens here, as in the JAX trainer). ``params``
        (default: the model's) is the tree the forward reads. An MoE model's
        load-balancing loss (pre-weighted by its coefficient) adds to the
        loss, as in the JAX trainer (``trainer.py:277-279``)."""
        inputs = dict(inputs)
        labels = inputs.pop("labels", None)
        if labels is None:
            raise ValueError("training requires `labels` in inputs (or override compute_loss)")
        aux = None
        if getattr(self.model, "returns_aux_loss", False):
            logits, aux = self.model.forward(**inputs, params=params, return_aux=True)
        else:
            logits = self.model.forward(**inputs, params=params)
        if self.criterion is not None:
            loss = self.criterion(logits, labels)
        else:
            loss = causal_lm_loss(logits, labels, shift=True)
        return loss if aux is None else loss + aux

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(v)).to(self.device) for k, v in batch.items()}

    def training_step(self, host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One optimizer update over ``host_batch`` (the global batch, split into
        ``gradient_accumulation_steps`` micro-batches of consecutive rows).
        Returns ``{"loss", "grad_norm"}`` as device scalars."""
        accum = self.args.gradient_accumulation_steps
        batch = self._to_device(host_batch)
        rows = next(iter(batch.values())).shape[0]
        if rows % accum:
            raise ValueError(f"global batch {rows} is not divisible by gradient_accumulation_steps={accum}")
        micro = rows // accum
        params = self.trainable_params
        for k, p in self.params.items():
            p.requires_grad_(k in params)
            p.grad = None
        loss = None
        for i in range(accum):
            micro_loss = self.compute_loss({k: v[i * micro:(i + 1) * micro] for k, v in batch.items()})
            micro_loss.backward()
            loss = micro_loss.detach() if loss is None else loss + micro_loss.detach()
        grads = {k: p.grad for k, p in params.items()}
        if accum > 1:
            for g in grads.values():
                g.div_(accum)
            loss = loss / accum
        grad_norm = global_norm(grads.values())
        self.optimizer.step(params, grads, grad_norm)
        for p in params.values():
            p.grad = None
        return {"loss": loss, "grad_norm": grad_norm}

    # ------------------------------------------------------------------ data
    def get_train_dataloader(self):
        from ..data.dataloader import DataLoader

        args = self.args
        return DataLoader(self.train_dataset, batch_size=args.global_train_batch_size, collate_fn=self.data_collator,
                          shuffle=True, drop_last=args.dataloader_drop_last, seed=args.data_seed)

    def get_eval_dataloader(self, eval_dataset=None):
        from ..data.dataloader import DataLoader

        dataset = eval_dataset if eval_dataset is not None else self.eval_dataset
        return DataLoader(dataset, batch_size=self.args.global_eval_batch_size, collate_fn=self.data_collator,
                          shuffle=False, drop_last=False)

    # ------------------------------------------------------------------ main loop
    def train(self, resume_from_checkpoint: Optional[str] = None, **kwargs):
        args = self.args
        train_dataloader = self.get_train_dataloader()
        if has_length(train_dataloader):
            steps_per_epoch = len(train_dataloader)
            if steps_per_epoch == 0:
                raise ValueError(f"dataset yields 0 batches: {len(self.train_dataset)} samples < global batch "
                                 f"{args.global_train_batch_size} with drop_last; reduce batch size")
            if args.max_steps > 0:
                max_steps = args.max_steps
                num_train_epochs = math.ceil(max_steps / steps_per_epoch)
            else:
                max_steps = int(steps_per_epoch * args.num_train_epochs)
                num_train_epochs = math.ceil(args.num_train_epochs)
        else:
            if args.max_steps <= 0:
                raise ValueError("max_steps must be set for sized-less datasets")
            max_steps = steps_per_epoch = args.max_steps
            num_train_epochs = 1

        self.create_optimizer_and_scheduler(max_steps)

        # ---- resume ----
        if resume_from_checkpoint is None:
            resume_from_checkpoint = args.resume_from_checkpoint
        if resume_from_checkpoint is True:
            # auto-discovery goes through the commit protocol: the newest
            # *committed* checkpoint wins, torn dirs from a crashed save are
            # skipped (get_last_checkpoint would happily hand one back)
            from .unified_checkpoint import get_last_committed_checkpoint, get_last_legacy_checkpoint

            resume_from_checkpoint = get_last_committed_checkpoint(args.output_dir)
            if resume_from_checkpoint is None:
                # no committed checkpoint: fall back to the newest MANIFEST-LESS
                # dir (written by a pre-protocol trainer, loadable via the
                # legacy path). Dirs whose manifest fails validation are torn
                # saves and are never resumed from.
                resume_from_checkpoint = get_last_legacy_checkpoint(args.output_dir)
                if resume_from_checkpoint:
                    logger.warning(f"resume: no committed checkpoint under {args.output_dir}; "
                                   f"falling back to legacy (pre-commit-protocol) {resume_from_checkpoint}")
        if resume_from_checkpoint:
            self._load_checkpoint(resume_from_checkpoint)
        self.state.max_steps = max_steps
        self.state.num_train_epochs = num_train_epochs
        self.state.is_world_process_zero = True
        self.callback_handler.train_dataloader = train_dataloader
        self.callback_handler.optimizer = self.optimizer
        self.callback_handler.lr_scheduler = self.lr_scheduler

        logger.info("***** Running training *****")
        logger.info(f"  Num examples = {len(self.train_dataset) if has_length(self.train_dataset) else 'unknown'}")
        logger.info(f"  Num epochs = {num_train_epochs}, total steps = {max_steps}")
        logger.info(f"  Global batch size = {args.global_train_batch_size} "
                    f"(batch {args.per_device_train_batch_size} x accum {args.gradient_accumulation_steps})")
        logger.info(f"  Model parameters = {self.model.num_parameters():,} on {self.device}")

        self.control = self.callback_handler.on_train_begin(args, self.state, self.control)
        self._interval_losses = []  # device scalars; read at logging time
        last_metrics = None
        train_start = time.time()
        tokens_seen = 0
        epoch = self.state.global_step // max(steps_per_epoch, 1)
        while self.state.global_step < max_steps and not self.control.should_training_stop:
            self.control = self.callback_handler.on_epoch_begin(args, self.state, self.control)
            steps_to_skip = 0
            if self.state.global_step > 0 and not args.ignore_data_skip:
                steps_to_skip = self.state.global_step % steps_per_epoch
            train_dataloader.set_epoch(epoch)
            self.timers("read-data").start()
            for host_batch in train_dataloader:
                if steps_to_skip > 0:
                    steps_to_skip -= 1
                    continue
                self.state.data_step += 1
                if args.skip_data_intervals and any(
                        lo <= self.state.data_step <= hi for lo, hi in args.skip_data_intervals):
                    # hop over loss-spiking data regions (reference
                    # skip_data_intervals, training_args.py:882): the interval
                    # is in DATA steps — those batches are consumed untrained
                    self.state.consumed_samples += args.global_train_batch_size
                    continue
                step_t0 = time.perf_counter()
                self.control = self.callback_handler.on_step_begin(args, self.state, self.control)
                self.timers("read-data").stop()
                self.timers("forward-backward-optimizer").start()
                metrics = self.training_step(host_batch)
                will_log = (args.logging_strategy == IntervalStrategy.STEPS
                            and (self.state.global_step + 1) % args.logging_steps == 0)
                self.timers("forward-backward-optimizer").stop(block_on=metrics["loss"] if will_log else None)
                last_metrics = metrics
                self._interval_losses.append(metrics["loss"])
                self.state.global_step += 1
                self.state.epoch = self.state.global_step / steps_per_epoch
                self.state.consumed_samples += args.global_train_batch_size
                step_tokens, seq_len = 0, None
                if "input_ids" in host_batch:
                    shape = np.asarray(host_batch["input_ids"]).shape
                    step_tokens, seq_len = int(np.prod(shape)), int(shape[-1])
                    tokens_seen += step_tokens
                self.control = self.callback_handler.on_step_end(args, self.state, self.control,
                                                                 step_tokens=step_tokens, seq_len=seq_len)
                TRACER.add_span("train_step", TRACER.epoch_time(step_t0), time.perf_counter() - step_t0,
                                cat="trainer", trace="train", step=self.state.global_step, tokens=step_tokens)
                if args.profiler_options:
                    # torch.profiler over the configured step window, started
                    # and stopped on this thread (reference add_profiler_step),
                    # after the step's callbacks and span: starting or stopping
                    # the window (which writes the trace) is no step's time
                    if self._profiler is None:
                        from ..utils.profiler import ProfilerOptions, ProfilerStepper

                        self._profiler = ProfilerStepper(ProfilerOptions.parse(args.profiler_options))
                    self._profiler.step(self.state.global_step)
                self._maybe_log_save_evaluate(last_metrics, train_start, tokens_seen)
                if self.control.should_training_stop or self.state.global_step >= max_steps:
                    break
                self.timers("read-data").start()
            t_rd = self.timers("read-data")
            if t_rd._started is not None:
                t_rd.stop()
            epoch += 1
            self.control = self.callback_handler.on_epoch_end(args, self.state, self.control)
            self._maybe_log_save_evaluate(last_metrics, train_start, tokens_seen)
            if not has_length(train_dataloader):
                break

        final_loss = float(last_metrics["loss"]) if last_metrics is not None else float("nan")
        metrics = speed_metrics("train", train_start, num_samples=self.state.consumed_samples,
                                num_steps=self.state.global_step, num_tokens=tokens_seen,
                                model_flops=self._total_flops(tokens_seen))
        metrics["train_loss"] = final_loss
        if self._profiler is not None:
            # flush an open trace even when training ended inside the window
            self._profiler.close()
            self._profiler = None
        # trainer exit: a live async-save thread must land (and be reaped)
        # before train() returns — callers may rotate, rsync, or exit the
        # process the moment this function hands back control
        from .unified_checkpoint import join_pending_saves

        join_pending_saves(timeout=None)
        self.control = self.callback_handler.on_train_end(args, self.state, self.control)
        return TrainOutput(self.state.global_step, final_loss, metrics)

    def _total_flops(self, tokens_seen: int) -> Optional[float]:
        if tokens_seen and hasattr(self.model, "get_model_flops"):
            return self.model.get_model_flops(1, 1) * tokens_seen
        return None

    def _maybe_log_save_evaluate(self, metrics, train_start, tokens_seen):
        args = self.args
        if self.control.should_log and metrics is not None:
            interval = [float(x) for x in self._interval_losses] or [float(metrics["loss"])]
            self._interval_losses = []
            logs = {
                "loss": round(float(np.mean(interval)), 6),
                "grad_norm": round(float(metrics["grad_norm"]), 6),
                "learning_rate": float(self.lr_scheduler(max(self.state.global_step - 1, 0))),
                "global_step": self.state.global_step,
            }
            logs.update(speed_metrics("interval", train_start, num_steps=self.state.global_step,
                                      num_tokens=tokens_seen, model_flops=self._total_flops(tokens_seen)))
            self.state.log_history.append(logs)
            self.timers.log(["read-data", "forward-backward-optimizer"], normalizer=max(len(interval), 1))
            self.control = self.callback_handler.on_log(args, self.state, self.control, logs=logs)
        if self.control.should_evaluate:
            with TRACER.span("evaluate", cat="trainer", trace="train", step=self.state.global_step):
                metrics_out = self.evaluate()
            self.control = self.callback_handler.on_evaluate(args, self.state, self.control, metrics=metrics_out)
        if self.control.should_save:
            with TRACER.span("checkpoint", cat="trainer", trace="train", step=self.state.global_step):
                self._save_checkpoint()
            self.control = self.callback_handler.on_save(args, self.state, self.control)

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def _eval_step(self, host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The JAX trainer's eval step (:379): logits, and the loss when the
        batch has labels."""
        inputs = self._to_device(host_batch)
        labels = inputs.pop("labels", None)
        logits = self.model.forward(**inputs)
        if labels is None:
            return {"logits": logits}
        loss = self.criterion(logits, labels) if self.criterion is not None else \
            causal_lm_loss(logits, labels, shift=True)
        return {"loss": loss, "logits": logits}

    def _host_logits(self, logits, host_batch, n_batches: int) -> np.ndarray:
        """``preprocess_logits_for_metrics`` if given; otherwise, when holding
        the full eval's logits would exceed ``eval_logits_host_bytes_limit`` of
        host RAM, refuse loudly (or reduce them to argmax ids with the
        explicit ``eval_reduce_logits_to_argmax``) (JAX :836-870)."""
        if self.preprocess_logits_for_metrics is not None:
            labels = host_batch.get("labels")
            logits = self.preprocess_logits_for_metrics(
                logits, None if labels is None else torch.as_tensor(np.asarray(labels)).to(self.device))
        else:
            limit = getattr(self.args, "eval_logits_host_bytes_limit", 2 << 30)
            if logits.ndim == 3 and limit and logits.numel() * 4 * n_batches > limit:
                need_gb = logits.numel() * 4 * n_batches / 1e9
                if getattr(self.args, "eval_reduce_logits_to_argmax", False):
                    logger.warning_once(
                        f"accumulating eval logits would need ~{need_gb:.1f} GB host RAM "
                        f"(> eval_logits_host_bytes_limit={limit}); reducing to argmax token ids "
                        "on device (eval_reduce_logits_to_argmax=True)")
                    logits = torch.argmax(logits, dim=-1)
                else:
                    raise ValueError(
                        f"accumulating eval logits would need ~{need_gb:.1f} GB host RAM "
                        f"(> eval_logits_host_bytes_limit={limit}). Pass preprocess_logits_for_metrics "
                        "to reduce them yourself, raise eval_logits_host_bytes_limit, or set "
                        "eval_reduce_logits_to_argmax=True to accept [B, T] argmax ids.")
        logits = logits.detach().cpu()
        return (logits.float() if logits.dtype == torch.bfloat16 else logits).numpy()

    def evaluate(self, eval_dataset=None, ignore_keys=None, metric_key_prefix: str = "eval") -> Dict[str, float]:
        """Mean loss (and perplexity) over the eval set, no gradient; with
        ``compute_metrics``, its metrics over every batch's logits (JAX :786)."""
        dataloader = self.get_eval_dataloader(eval_dataset)
        start = time.time()
        losses, n_batches = [], 0
        all_logits, all_labels = [], []
        run_metrics = self.compute_metrics is not None
        for host_batch in dataloader:
            out = self._eval_step(host_batch)
            if "loss" in out:
                losses.append(float(out["loss"]))
            if run_metrics:
                all_logits.append(self._host_logits(out["logits"], host_batch, len(dataloader)))
                if "labels" in host_batch:
                    all_labels.append(np.asarray(host_batch["labels"]))
            n_batches += 1
        metrics = {}
        if losses:
            metrics[f"{metric_key_prefix}_loss"] = float(np.mean(losses))
            try:
                metrics[f"{metric_key_prefix}_ppl"] = float(np.exp(np.mean(losses)))
            except OverflowError:
                pass
        if run_metrics and all_logits:
            preds = np.concatenate(all_logits, axis=0)
            labels = np.concatenate(all_labels, axis=0) if all_labels else None
            extra = self.compute_metrics(EvalPrediction(predictions=preds, label_ids=labels))
            metrics.update({f"{metric_key_prefix}_{k}" if not k.startswith(metric_key_prefix) else k: v
                            for k, v in extra.items()})
        metrics.update(speed_metrics(metric_key_prefix, start, num_steps=n_batches))
        self.state.log_history.append(dict(metrics))
        return metrics

    def predict(self, test_dataset, ignore_keys=None, metric_key_prefix: str = "test") -> PredictionOutput:
        """Logits (or what ``preprocess_logits_for_metrics`` makes of them) and
        labels over ``test_dataset``, with ``compute_metrics`` (JAX :881)."""
        dataloader = self.get_eval_dataloader(test_dataset)
        logits_all, labels_all = [], []
        for host_batch in dataloader:
            out = self._eval_step(host_batch)
            logits_all.append(self._host_logits(out["logits"], host_batch, len(dataloader)))
            if "labels" in host_batch:
                labels_all.append(np.asarray(host_batch["labels"]))
        preds = np.concatenate(logits_all, axis=0) if logits_all else None
        labels = np.concatenate(labels_all, axis=0) if labels_all else None
        metrics = {}
        if self.compute_metrics is not None and preds is not None and labels is not None:
            metrics = {f"{metric_key_prefix}_{k}": v for k, v in
                       self.compute_metrics(EvalPrediction(predictions=preds, label_ids=labels)).items()}
        return PredictionOutput(predictions=preds, label_ids=labels, metrics=metrics)

    def compress(self, strategy: str = "ptq", output_dir: Optional[str] = None, **kwargs):
        """Post-training compression (reference ``Trainer.compress``,
        ``trainer_compress.py``): PTQ weight-only (optionally GPTQ-calibrated),
        a8w8 with calibrated activation scales, QAT, embedding quantization,
        and width or depth pruning; exports a checkpoint directory."""
        from .trainer_compress import compress as _compress

        return _compress(self, strategy=strategy, output_dir=output_dir, **kwargs)

    # ------------------------------------------------------------------ save
    def save_model(self, output_dir: Optional[str] = None):
        """The current weights in the HF layout (``model.save_pretrained``)."""
        self.model.save_pretrained(output_dir or self.args.output_dir)
        if self.tokenizer is not None and hasattr(self.tokenizer, "save_pretrained"):
            self.tokenizer.save_pretrained(output_dir or self.args.output_dir)

    # ------------------------------------------------------------------ checkpoint
    def _save_checkpoint(self):
        from .unified_checkpoint import join_pending_saves, rotate_checkpoints, save_unified_checkpoint

        args = self.args
        # one async writer at a time: joining here reaps finished threads and
        # keeps the new save from racing a previous in-flight one
        join_pending_saves(timeout=None)
        ckpt_dir = os.path.join(args.output_dir, f"{PREFIX_CHECKPOINT_DIR}-{self.state.global_step}")
        # rotation runs on the writer thread right after the commit rename
        # lands — an async save stays async and rotation always sees the new
        # checkpoint as committed
        best = self.state.best_model_checkpoint
        save_unified_checkpoint(
            ckpt_dir, model=self.model, optimizer=self.optimizer, trainer_state=self.state, tokenizer=self.tokenizer,
            async_save=args.async_save,
            after_commit=lambda: rotate_checkpoints(args.output_dir, args.save_total_limit,
                                                    best_model_checkpoint=best))

    def _load_checkpoint(self, ckpt_dir: str):
        from .unified_checkpoint import load_unified_checkpoint

        logger.info(f"resuming from checkpoint {ckpt_dir}")
        trainer_state = load_unified_checkpoint(ckpt_dir, model=self.model, optimizer=self.optimizer)
        if trainer_state is not None:
            self.state = trainer_state

    def _rotate_checkpoints(self):
        """Manual rotation entry point (saves rotate themselves post-commit)."""
        from .unified_checkpoint import join_pending_saves, rotate_checkpoints

        # an in-flight async save must land before we decide what is stale:
        # with async_save the newest checkpoint may still be a staging dir
        join_pending_saves(timeout=None)
        rotate_checkpoints(self.args.output_dir, self.args.save_total_limit,
                           best_model_checkpoint=self.state.best_model_checkpoint)

    def log(self, logs: Dict[str, float]):
        self.state.log_history.append(logs)
        self.control = self.callback_handler.on_log(self.args, self.state, self.control, logs=logs)

    def add_callback(self, callback):
        self.callback_handler.add_callback(callback)

    def pop_callback(self, callback):
        return self.callback_handler.pop_callback(callback)

    def remove_callback(self, callback):
        self.callback_handler.remove_callback(callback)


def _default_collator(features: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(f[k]) for f in features]) for k in features[0]}
