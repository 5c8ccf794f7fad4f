"""Step-phase timers (reference: paddlenlp/trainer/plugins/timer.py —
Megatron-style ``Timers`` :96, ``RuntimeTimer`` :70; wired as
``self.timers("forward-backward")`` around trainer phases).

Port of ``paddlenlp_tpu/trainer/timer.py``. The card runs asynchronously: a
timer stop given ``block_on`` (a tensor) synchronizes its CUDA device first,
so the phase measures device work, not the enqueue. The JAX package also
lands every stop as a span in its tracer; the tracer is not part of the port
yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

__all__ = ["Timers", "RuntimeTimer"]


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self._elapsed = 0.0
        self._started: Optional[float] = None
        self.count = 0

    def start(self):
        if self._started is not None:
            raise RuntimeError(f"timer {self.name} already started")
        self._started = time.perf_counter()

    def stop(self, block_on=None):
        if self._started is None:
            raise RuntimeError(f"timer {self.name} not started")
        device = getattr(block_on, "device", None)
        if device is not None and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        self._elapsed += time.perf_counter() - self._started
        self._started = None
        self.count += 1

    def elapsed(self, reset: bool = True) -> float:
        out = self._elapsed
        if reset:
            self._elapsed = 0.0
            self.count = 0
        return out


class Timers:
    """timers("name").start()/.stop(); log(names) prints per-interval ms."""

    def __init__(self):
        self._timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self._timers:
            self._timers[name] = _Timer(name)
        return self._timers[name]

    def log(self, names=None, normalizer: float = 1.0, reset: bool = True) -> str:
        names = names or list(self._timers)
        parts = []
        for n in names:
            if n in self._timers:
                t = self._timers[n]
                parts.append(f"{n}: {1000.0 * t.elapsed(reset) / max(normalizer, 1e-9):.2f}ms")
        line = " | ".join(parts)
        if line:
            from ..utils.log import logger

            logger.info(f"[timers] {line}")
        return line


class RuntimeTimer:
    """Single wall-clock phase timer with a label (reference :70)."""

    def __init__(self, name: str):
        self._timer = _Timer(name)
        self._timer.start()

    def start(self, name: str):
        self._timer = _Timer(name)
        self._timer.start()

    def get_runtime(self) -> str:
        elapsed = time.perf_counter() - self._timer._started
        return f"{self._timer.name}: {elapsed:.2f}s"
