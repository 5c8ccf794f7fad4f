"""Optimizers of the port over flat ``{name: tensor}`` dicts (plain tensor
code): the trainer's optax-semantics ``AdamW``, layer-wise decay ``adamwdl``
and the parameter ``ema``."""

from .adamw import AdamW, global_norm  # noqa: F401
from .adamwdl import adamwdl, layerwise_lr_decay_mask  # noqa: F401
from .ema import ExponentialMovingAverage, ema  # noqa: F401
