"""``Trainer`` — HF-style training loop on one device.

Port of ``paddlenlp_tpu/trainer/trainer.py``: the optimizer (:125-170), the
train step (:346-377), the loop (:557-736), ``evaluate`` (:786, loss only)
and ``save_model`` (:944). Where the JAX trainer jits one step over a sharded
mesh, this one runs eagerly on the device that holds the model's parameters
(``model.device``: the card, unless the model was built with
``device="cpu"``), with explicit generators for every random draw.

The optimizer is optax's, not torch's defaults: ``clip_by_global_norm``
scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``; AdamW keeps
``eps`` outside the square root, decays every leaf except biases, norms and
scales (:138-148), and update k (counting from 0) takes ``schedule(k)``.
Gradient accumulation sums the micro-batch grads and divides by their count;
the reported loss is the mean of the micro losses and ``grad_norm`` the global
norm before clipping.

What the JAX trainer does and this one does not yet raises
``NotImplementedError`` naming the ROADMAP item (``TrainingArguments.check_supported``
and below): checkpoint save at ``save_steps`` and resume, ``report_to`` and the
metrics callback, the profiler, ``predict``, PEFT masks,
``skip_data_intervals``, dropout.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.cross_entropy import causal_lm_loss
from ..transformers.conversion_utils import flatten_params
from ..utils.log import logger
from .trainer_callback import CallbackHandler, DefaultFlowCallback, ProgressCallback, TrainerControl, TrainerState
from .timer import Timers
from .trainer_utils import IntervalStrategy, TrainOutput, get_scheduler, has_length, set_seed, speed_metrics
from .training_args import TrainingArguments

__all__ = ["AdamW", "Trainer"]

DEFAULT_CALLBACKS = [DefaultFlowCallback, ProgressCallback]

_TRAINING_LEFT = "ROADMAP Queue 1 item 15"


def _decays(name: str) -> bool:
    """The JAX trainer's weight-decay mask (:138-148)."""
    return not (name.endswith("bias") or "norm" in name.lower() or name.endswith("scale"))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1, b2,
    eps, weight_decay, mask))`` over a flat ``{name: tensor}`` dict, updated in
    place. The moments live beside the parameters, in fp32. ``decays(name)``
    is the weight-decay mask (default: the JAX trainer's)."""

    def __init__(self, params: Dict[str, torch.Tensor], schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0, max_grad_norm: float = 0.0,
                 decays: Callable[[str], bool] = _decays):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decays = decays
        self.max_grad_norm = max_grad_norm
        self.mu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.count = 0  # updates applied so far (optax's shared step count)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             g_norm: Optional[torch.Tensor] = None):
        if self.max_grad_norm and self.max_grad_norm > 0:
            g_norm = global_norm(grads.values()) if g_norm is None else g_norm
            keep = g_norm < self.max_grad_norm
            grads = {k: torch.where(keep, g, g / g_norm * self.max_grad_norm) for k, g in grads.items()}
        lr = float(self.schedule(self.count))
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        for k, p in params.items():
            g = grads[k].float()
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).add_(g.square(), alpha=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay > 0 and self.decays(k):
                update = update + self.weight_decay * p
            p.add_(update.to(p.dtype), alpha=-lr)


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
        if compute_metrics is not None or preprocess_logits_for_metrics is not None:
            raise NotImplementedError(f"compute_metrics: evaluate() reports the loss only ({_TRAINING_LEFT})")
        if hasattr(model, "trainable_mask"):
            raise NotImplementedError("PEFT trainable masks are not part of the port yet (ROADMAP Queue 1 item 14)")
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
        self.optimizer, self.lr_scheduler = optimizers
        self.state = TrainerState()
        self.control = TrainerControl()
        self.device = model.device
        self.callback_handler = CallbackHandler(DEFAULT_CALLBACKS + (callbacks or []), self.model, self.tokenizer)
        self.timers = Timers()
        set_seed(args.seed)
        self.control = self.callback_handler.on_init_end(self.args, self.state, self.control)

    # ------------------------------------------------------------------ setup
    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The model's leaves by flat name (the same tensors, not copies)."""
        return flatten_params(self.model.params)

    def create_optimizer_and_scheduler(self, num_training_steps: int):
        args = self.args
        if self.lr_scheduler is None:
            self.lr_scheduler = get_scheduler(args.lr_scheduler_type, args.learning_rate,
                                              args.get_warmup_steps(num_training_steps), num_training_steps,
                                              min_lr=args.min_learning_rate)
        if self.optimizer is None:
            self.optimizer = AdamW(self.params, self.lr_scheduler, b1=args.adam_beta1, b2=args.adam_beta2,
                                   eps=args.adam_epsilon, weight_decay=args.weight_decay,
                                   max_grad_norm=args.max_grad_norm)
        return self.optimizer

    # ------------------------------------------------------------------ loss and step
    def compute_loss(self, inputs: Dict[str, torch.Tensor], params: Optional[dict] = None) -> torch.Tensor:
        """Override point. ``labels`` follow the HF convention (unshifted; the
        causal shift happens here, as in the JAX trainer). ``params``
        (default: the model's) is the tree the forward reads."""
        inputs = dict(inputs)
        labels = inputs.pop("labels", None)
        if labels is None:
            raise ValueError("training requires `labels` in inputs (or override compute_loss)")
        logits = self.model.forward(**inputs, params=params)
        if self.criterion is not None:
            return self.criterion(logits, labels)
        return causal_lm_loss(logits, labels, shift=True)

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
        params = self.params
        for p in params.values():
            p.requires_grad_(True)
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
        if resume_from_checkpoint not in (None, False):
            raise NotImplementedError(f"resume_from_checkpoint: unified checkpoints are not part of the port "
                                      f"yet ({_TRAINING_LEFT})")
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
        saves = args.save_strategy == IntervalStrategy.EPOCH or (
            args.save_strategy == IntervalStrategy.STEPS and 0 < args.save_steps <= max_steps)
        if saves:
            raise NotImplementedError(f"checkpoint saves during training (save_strategy={args.save_strategy.value}, "
                                      f"save_steps={args.save_steps} <= {max_steps} steps) are not part of the port "
                                      f"yet ({_TRAINING_LEFT}); save_model() writes the final weights")

        self.create_optimizer_and_scheduler(max_steps)
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
        epoch = 0
        while self.state.global_step < max_steps and not self.control.should_training_stop:
            self.control = self.callback_handler.on_epoch_begin(args, self.state, self.control)
            train_dataloader.set_epoch(epoch)
            self.timers("read-data").start()
            for host_batch in train_dataloader:
                self.state.data_step += 1
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
                self._maybe_log_evaluate(last_metrics, train_start, tokens_seen)
                if self.control.should_training_stop or self.state.global_step >= max_steps:
                    break
                self.timers("read-data").start()
            t_rd = self.timers("read-data")
            if t_rd._started is not None:
                t_rd.stop()
            epoch += 1
            self.control = self.callback_handler.on_epoch_end(args, self.state, self.control)
            self._maybe_log_evaluate(last_metrics, train_start, tokens_seen)
            if not has_length(train_dataloader):
                break

        final_loss = float(last_metrics["loss"]) if last_metrics is not None else float("nan")
        metrics = speed_metrics("train", train_start, num_samples=self.state.consumed_samples,
                                num_steps=self.state.global_step, num_tokens=tokens_seen,
                                model_flops=self._total_flops(tokens_seen))
        metrics["train_loss"] = final_loss
        self.control = self.callback_handler.on_train_end(args, self.state, self.control)
        return TrainOutput(self.state.global_step, final_loss, metrics)

    def _total_flops(self, tokens_seen: int) -> Optional[float]:
        if tokens_seen and hasattr(self.model, "get_model_flops"):
            return self.model.get_model_flops(1, 1) * tokens_seen
        return None

    def _maybe_log_evaluate(self, metrics, train_start, tokens_seen):
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
            metrics_out = self.evaluate()
            self.control = self.callback_handler.on_evaluate(args, self.state, self.control, metrics=metrics_out)

    # ------------------------------------------------------------------ eval
    @torch.no_grad()
    def evaluate(self, eval_dataset=None, ignore_keys=None, metric_key_prefix: str = "eval") -> Dict[str, float]:
        """Mean loss (and perplexity) over the eval set, no gradient."""
        dataloader = self.get_eval_dataloader(eval_dataset)
        start = time.time()
        losses, n_batches = [], 0
        for host_batch in dataloader:
            losses.append(float(self.compute_loss(self._to_device(host_batch))))
            n_batches += 1
        metrics = {}
        if losses:
            metrics[f"{metric_key_prefix}_loss"] = float(np.mean(losses))
            try:
                metrics[f"{metric_key_prefix}_ppl"] = float(np.exp(np.mean(losses)))
            except OverflowError:
                pass
        metrics.update(speed_metrics(metric_key_prefix, start, num_steps=n_batches))
        self.state.log_history.append(dict(metrics))
        return metrics

    def predict(self, test_dataset, ignore_keys=None, metric_key_prefix: str = "test"):
        raise NotImplementedError(f"Trainer.predict is not part of the port yet ({_TRAINING_LEFT})")

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
