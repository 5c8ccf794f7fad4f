"""Stopping criteria (a port of ``paddlenlp_tpu/generation/stopping_criteria.py``).

Each is a predicate over ``(ids_buf, cur_len)``; the decode loop's own stops
are ``max_length`` and every row having finished.
"""

from __future__ import annotations

import time

import torch

__all__ = ["StoppingCriteria", "StoppingCriteriaList", "MaxLengthCriteria", "MaxTimeCriteria"]


class StoppingCriteria:
    def __call__(self, ids_buf, cur_len, **kwargs) -> bool:
        raise NotImplementedError


class StoppingCriteriaList(list):
    def __call__(self, ids_buf, cur_len, **kwargs):
        done = torch.tensor(False)
        for crit in self:
            done = torch.logical_or(done, torch.as_tensor(crit(ids_buf, cur_len, **kwargs)))
        return done

    @property
    def max_length(self):
        for c in self:
            if isinstance(c, MaxLengthCriteria):
                return c.max_length
        return None


class MaxLengthCriteria(StoppingCriteria):
    def __init__(self, max_length: int):
        self.max_length = max_length

    def __call__(self, ids_buf, cur_len, **kwargs):
        return torch.as_tensor(cur_len >= self.max_length)


class MaxTimeCriteria(StoppingCriteria):
    """Host wall-clock bound."""

    def __init__(self, max_time: float):
        self.max_time = max_time
        self.start = time.time()

    def __call__(self, ids_buf, cur_len, **kwargs):
        return torch.tensor(time.time() - self.start > self.max_time)
