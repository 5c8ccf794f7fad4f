"""Exponential moving average of parameters.

Port of ``paddlenlp_tpu/ops/optimizer/ema.py``: ``ema()`` returns the
(init, update) pair of a functional state transform, and
``ExponentialMovingAverage`` is the stateful facade (update / apply /
restore). Parameters are dicts of tensors, flat or nested.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["EMAState", "ema", "ExponentialMovingAverage"]


class EMAState(NamedTuple):
    shadow: Any
    count: int


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def ema(decay: float = 0.999, debias: bool = True):
    """Returns (init_fn, update_fn): shadow = decay * shadow + (1 - decay) * params,
    with ``decay`` capped at (1 + count) / (10 + count) when ``debias``. The
    decay is a float32 scalar, as in the JAX transform."""

    def init(params) -> EMAState:
        return EMAState(shadow=_map(lambda p: p.detach().clone(), params), count=0)

    @torch.no_grad()
    def update(params, state: EMAState) -> EMAState:
        count = state.count + 1
        d = torch.tensor(decay, dtype=torch.float32)
        if debias:
            d = torch.minimum(d, torch.tensor(1.0 + count, dtype=torch.float32)
                              / torch.tensor(10.0 + count, dtype=torch.float32))
        one_minus = 1.0 - d

        def step(s, p):
            return s * d.to(s.device) + p.to(s.dtype) * one_minus.to(s.device)

        return EMAState(shadow=_map(step, state.shadow, params), count=count)

    return init, update


class ExponentialMovingAverage:
    def __init__(self, params, decay: float = 0.999, debias: bool = True):
        self._init, self._update = ema(decay, debias)
        self.state = self._init(params)
        self._backup = None

    def update(self, params):
        self.state = self._update(params, self.state)

    def apply(self, params):
        """Return the EMA params (callers swap them in for eval)."""
        self._backup = params
        return self.state.shadow

    def restore(self):
        params, self._backup = self._backup, None
        return params
