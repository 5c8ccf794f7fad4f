"""Callback system (reference: paddlenlp/trainer/trainer_callback.py —
``TrainerState`` :47, ``TrainerControl`` :118, ``TrainerCallback`` :167,
``CallbackHandler`` :301, ``DefaultFlowCallback`` :432, ``ProgressCallback``,
``EarlyStoppingCallback``).

A copy of ``paddlenlp_tpu/trainer/trainer_callback.py``."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils.fileio import atomic_write
from ..utils.log import logger
from .trainer_utils import IntervalStrategy

__all__ = [
    "TrainerState",
    "TrainerControl",
    "TrainerCallback",
    "CallbackHandler",
    "DefaultFlowCallback",
    "ProgressCallback",
    "PrinterCallback",
    "EarlyStoppingCallback",
]


@dataclasses.dataclass
class TrainerState:
    epoch: Optional[float] = None
    global_step: int = 0
    max_steps: int = 0
    num_train_epochs: int = 0
    log_history: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    best_metric: Optional[float] = None
    best_model_checkpoint: Optional[str] = None
    is_world_process_zero: bool = True
    consumed_samples: int = 0
    data_step: int = 0  # yielded-batch counter (skip_data_intervals indexing; resume-safe)
    trial_params: Optional[Dict[str, Any]] = None

    def to_json_string(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True, default=str)

    def save_to_json(self, json_path: str):
        # tmp+rename: a crash mid-dump must leave the previous state file
        # intact, never a truncated JSON that load_from_json chokes on
        with atomic_write(json_path) as f:
            f.write(self.to_json_string())

    @classmethod
    def load_from_json(cls, json_path: str) -> "TrainerState":
        with open(json_path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


@dataclasses.dataclass
class TrainerControl:
    should_training_stop: bool = False
    should_epoch_stop: bool = False
    should_save: bool = False
    should_evaluate: bool = False
    should_log: bool = False

    def _new_training(self):
        self.should_training_stop = False

    def _new_epoch(self):
        self.should_epoch_stop = False

    def _new_step(self):
        self.should_save = False
        self.should_evaluate = False
        self.should_log = False


class TrainerCallback:
    def on_init_end(self, args, state, control, **kwargs):
        pass

    def on_train_begin(self, args, state, control, **kwargs):
        pass

    def on_train_end(self, args, state, control, **kwargs):
        pass

    def on_epoch_begin(self, args, state, control, **kwargs):
        pass

    def on_epoch_end(self, args, state, control, **kwargs):
        pass

    def on_step_begin(self, args, state, control, **kwargs):
        pass

    def on_step_end(self, args, state, control, **kwargs):
        pass

    def on_substep_end(self, args, state, control, **kwargs):
        pass

    def on_evaluate(self, args, state, control, **kwargs):
        pass

    def on_predict(self, args, state, control, **kwargs):
        pass

    def on_save(self, args, state, control, **kwargs):
        pass

    def on_log(self, args, state, control, **kwargs):
        pass

    def on_prediction_step(self, args, state, control, **kwargs):
        pass


class CallbackHandler(TrainerCallback):
    def __init__(self, callbacks, model, tokenizer, optimizer=None, lr_scheduler=None):
        self.callbacks = []
        for cb in callbacks:
            self.add_callback(cb)
        self.model = model
        self.tokenizer = tokenizer
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.train_dataloader = None
        self.eval_dataloader = None

    def add_callback(self, callback):
        cb = callback() if isinstance(callback, type) else callback
        if cb.__class__ in {c.__class__ for c in self.callbacks}:
            logger.warning(f"duplicate callback {cb.__class__.__name__} added")
        self.callbacks.append(cb)

    def pop_callback(self, callback):
        for cb in self.callbacks:
            if cb == callback or cb.__class__ == callback:
                self.callbacks.remove(cb)
                return cb
        return None

    def remove_callback(self, callback):
        self.pop_callback(callback)

    @property
    def callback_list(self) -> str:
        return "\n".join(cb.__class__.__name__ for cb in self.callbacks)

    def call_event(self, event: str, args, state, control, **kwargs):
        for cb in self.callbacks:
            result = getattr(cb, event)(
                args,
                state,
                control,
                model=self.model,
                tokenizer=self.tokenizer,
                optimizer=self.optimizer,
                lr_scheduler=self.lr_scheduler,
                train_dataloader=self.train_dataloader,
                eval_dataloader=self.eval_dataloader,
                **kwargs,
            )
            if result is not None:
                control = result
        return control

    def on_init_end(self, args, state, control):
        return self.call_event("on_init_end", args, state, control)

    def on_train_begin(self, args, state, control):
        control._new_training()
        return self.call_event("on_train_begin", args, state, control)

    def on_train_end(self, args, state, control):
        return self.call_event("on_train_end", args, state, control)

    def on_epoch_begin(self, args, state, control):
        control._new_epoch()
        return self.call_event("on_epoch_begin", args, state, control)

    def on_epoch_end(self, args, state, control):
        return self.call_event("on_epoch_end", args, state, control)

    def on_step_begin(self, args, state, control, **kwargs):
        control._new_step()
        return self.call_event("on_step_begin", args, state, control, **kwargs)

    def on_step_end(self, args, state, control, **kwargs):
        # kwargs carry per-step observables (e.g. ``step_tokens``) for
        # metrics/reporting callbacks
        return self.call_event("on_step_end", args, state, control, **kwargs)

    def on_substep_end(self, args, state, control):
        return self.call_event("on_substep_end", args, state, control)

    def on_evaluate(self, args, state, control, metrics=None):
        control.should_evaluate = False
        return self.call_event("on_evaluate", args, state, control, metrics=metrics)

    def on_save(self, args, state, control):
        control.should_save = False
        return self.call_event("on_save", args, state, control)

    def on_log(self, args, state, control, logs=None):
        control.should_log = False
        return self.call_event("on_log", args, state, control, logs=logs)

    def on_prediction_step(self, args, state, control):
        return self.call_event("on_prediction_step", args, state, control)


class DefaultFlowCallback(TrainerCallback):
    """Sets log/eval/save flags per the interval strategies (reference :432)."""

    def on_step_end(self, args, state, control, **kwargs):
        if state.global_step == 1 and args.logging_first_step:
            control.should_log = True
        if args.logging_strategy == IntervalStrategy.STEPS and state.global_step % args.logging_steps == 0:
            control.should_log = True
        if args.evaluation_strategy == IntervalStrategy.STEPS and state.global_step % args.eval_steps == 0:
            control.should_evaluate = True
        if (
            args.save_strategy == IntervalStrategy.STEPS
            and args.save_steps > 0
            and state.global_step % args.save_steps == 0
        ):
            control.should_save = True
        if state.global_step >= state.max_steps:
            control.should_training_stop = True
        return control

    def on_epoch_end(self, args, state, control, **kwargs):
        if args.logging_strategy == IntervalStrategy.EPOCH:
            control.should_log = True
        if args.evaluation_strategy == IntervalStrategy.EPOCH:
            control.should_evaluate = True
        if args.save_strategy == IntervalStrategy.EPOCH:
            control.should_save = True
        return control


class ProgressCallback(TrainerCallback):
    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs is not None and state.is_world_process_zero:
            logs = dict(logs)
            logs.pop("total_flos", None)
            logger.info(f"step {state.global_step}/{state.max_steps} - " + json.dumps(logs, default=str))


class PrinterCallback(TrainerCallback):
    def on_log(self, args, state, control, logs=None, **kwargs):
        if logs is not None and state.is_world_process_zero:
            print(logs, flush=True)


class EarlyStoppingCallback(TrainerCallback):
    def __init__(self, early_stopping_patience: int = 1, early_stopping_threshold: float = 0.0):
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_threshold = early_stopping_threshold
        self.early_stopping_patience_counter = 0

    def on_evaluate(self, args, state, control, metrics=None, **kwargs):
        metric_to_check = args.metric_for_best_model
        if not metric_to_check:
            return control
        if not metric_to_check.startswith("eval_"):
            metric_to_check = f"eval_{metric_to_check}"
        metric_value = (metrics or {}).get(metric_to_check)
        if metric_value is None:
            logger.warning(f"early stopping requires {metric_to_check}, not found in metrics")
            return control
        operator = np.greater if args.greater_is_better else np.less
        if state.best_metric is None or (
            operator(metric_value, state.best_metric)
            and abs(metric_value - state.best_metric) > self.early_stopping_threshold
        ):
            self.early_stopping_patience_counter = 0
            state.best_metric = metric_value  # this callback owns best-metric tracking
        else:
            self.early_stopping_patience_counter += 1
        if self.early_stopping_patience_counter >= self.early_stopping_patience:
            control.should_training_stop = True
        return control
