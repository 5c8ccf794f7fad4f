"""Trainer utilities: enums, seeding, LR schedules, speed metrics, checkpoint discovery.

Port of ``paddlenlp_tpu/trainer/trainer_utils.py``. The LR schedules are
plain functions of the update count with optax's semantics (``get_scheduler``
:98): ``linear_schedule`` and ``polynomial_schedule`` clip the count to the
transition, ``cosine_decay_schedule`` decays to ``alpha * init``,
``join_schedules`` hands over at each boundary with the count restarted,
and update k (counting from 0) uses ``schedule(k)``, so the first update
under warmup has learning rate 0.
"""

from __future__ import annotations

import math
import os
import random
import re
import time
from enum import Enum
from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = [
    "EvalPrediction",
    "IntervalStrategy",
    "PredictionOutput",
    "SchedulerType",
    "TrainOutput",
    "set_seed",
    "get_scheduler",
    "speed_metrics",
    "get_last_checkpoint",
    "has_length",
    "copy_aliased_params",
    "PREFIX_CHECKPOINT_DIR",
]

PREFIX_CHECKPOINT_DIR = "checkpoint"
_re_checkpoint = re.compile(r"^" + PREFIX_CHECKPOINT_DIR + r"-(\d+)$")

Schedule = Callable[[int], float]


class EvalPrediction:
    def __init__(self, predictions, label_ids):
        self.predictions = predictions
        self.label_ids = label_ids


class PredictionOutput:
    def __init__(self, predictions, label_ids, metrics):
        self.predictions = predictions
        self.label_ids = label_ids
        self.metrics = metrics


class ExplicitEnum(str, Enum):
    @classmethod
    def _missing_(cls, value):
        raise ValueError(f"{value} is not a valid {cls.__name__}: pick one of {list(cls._value2member_map_)}")


class IntervalStrategy(ExplicitEnum):
    NO = "no"
    STEPS = "steps"
    EPOCH = "epoch"


class SchedulerType(ExplicitEnum):
    LINEAR = "linear"
    COSINE = "cosine"
    CONSTANT = "constant"
    CONSTANT_WITH_WARMUP = "constant_with_warmup"
    POLYNOMIAL = "polynomial"


class TrainOutput:
    def __init__(self, global_step: int, training_loss: float, metrics: Dict[str, float]):
        self.global_step = global_step
        self.training_loss = training_loss
        self.metrics = metrics


def set_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


# ---------------------------------------------------------------- schedules (optax semantics)
def polynomial_schedule(init_value: float, end_value: float, power: float, transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = min(max(count - transition_begin, 0), transition_steps)
        return (init_value - end_value) * ((1 - c / transition_steps) ** power) + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps, transition_begin)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def get_scheduler(name, learning_rate: float, num_warmup_steps: int, num_training_steps: int,
                  min_lr: float = 0.0, power: float = 1.0) -> Schedule:
    """The LR schedule as a function of the update count (``trainer_utils.py:98``)."""
    name = SchedulerType(name) if not isinstance(name, SchedulerType) else name
    warmup = linear_schedule(0.0, learning_rate, max(num_warmup_steps, 1))
    decay_steps = max(num_training_steps - num_warmup_steps, 1)
    if name == SchedulerType.LINEAR:
        decay = linear_schedule(learning_rate, min_lr, decay_steps)
    elif name == SchedulerType.COSINE:
        decay = cosine_decay_schedule(learning_rate, decay_steps, alpha=min_lr / max(learning_rate, 1e-12))
    elif name == SchedulerType.POLYNOMIAL:
        decay = polynomial_schedule(learning_rate, min_lr, power, decay_steps)
    elif name in (SchedulerType.CONSTANT, SchedulerType.CONSTANT_WITH_WARMUP):
        decay = constant_schedule(learning_rate)
    else:
        raise ValueError(f"unknown scheduler {name}")
    if num_warmup_steps > 0:
        return join_schedules([warmup, decay], [num_warmup_steps])
    return decay


# ---------------------------------------------------------------- metrics, checkpoints
def speed_metrics(split: str, start_time: float, num_samples: Optional[int] = None,
                  num_steps: Optional[int] = None, num_tokens: Optional[int] = None,
                  model_flops: Optional[float] = None) -> Dict[str, float]:
    """Throughput metrics incl. ``*_tokens_per_second_per_device`` and the
    hardware TFLOP/s; the model-flops utilization only where the card's peak
    is known (``utils/env.device_peak_flops``)."""
    import torch

    from ..utils.env import device_peak_flops

    runtime = time.time() - start_time
    result = {f"{split}_runtime": round(runtime, 4)}
    if runtime == 0:
        return result
    n_dev = max(torch.cuda.device_count(), 1)
    if num_samples is not None:
        result[f"{split}_samples_per_second"] = round(num_samples / runtime, 3)
    if num_steps is not None:
        result[f"{split}_steps_per_second"] = round(num_steps / runtime, 3)
    if num_tokens is not None:
        result[f"{split}_tokens_per_second"] = round(num_tokens / runtime, 2)
        result[f"{split}_tokens_per_second_per_device"] = round(num_tokens / runtime / n_dev, 2)
    if model_flops is not None:
        result[f"{split}_hardware_tflops_per_device"] = round(model_flops / runtime / n_dev / 1e12, 2)
        peak = device_peak_flops()
        if math.isfinite(peak) and peak > 0:
            result[f"{split}_model_flops_utilization"] = round(model_flops / runtime / n_dev / peak, 4)
    return result


def get_last_checkpoint(folder: str) -> Optional[str]:
    """Newest ``checkpoint-<step>`` subdir (reference trainer_utils.py:259)."""
    if not os.path.isdir(folder):
        return None
    checkpoints = [d for d in os.listdir(folder) if _re_checkpoint.match(d) and os.path.isdir(os.path.join(folder, d))]
    if not checkpoints:
        return None
    return os.path.join(folder, max(checkpoints, key=lambda d: int(_re_checkpoint.match(d).group(1))))


def has_length(dataset) -> bool:
    try:
        return len(dataset) is not None
    except TypeError:
        return False


def copy_aliased_params(params, policy_params):
    """``params`` with a detached copy of each leaf whose storage a leaf of
    ``policy_params`` shares (JAX ``trainer_utils.py:179``): the optimizer
    updates the policy's leaves in place, so a frozen reference (DPO, PPO)
    that shares them must own its copy, while a distinct model's leaves are
    kept as they are (no second copy on the card)."""
    from ..transformers.conversion_utils import flatten_params, unflatten_params

    policy = {t.untyped_storage().data_ptr() for t in flatten_params(policy_params).values()}
    return unflatten_params({k: (v.detach().clone() if v.untyped_storage().data_ptr() in policy else v)
                             for k, v in flatten_params(params).items()})
