"""Step-windowed device profiling.

Port of ``paddlenlp_tpu/utils/profiler.py`` (reference ``ProfilerOptions``
:28, ``add_profiler_step`` :88, driven by the ``--profiler_options`` launch
flag). The window drives ``torch.profiler`` over the host's ops and, on a
machine with a CUDA device, every kernel the process launches, and writes:

- ``<profile_path>/trace.json``: the profiler's Chrome trace;
- ``<profile_path>/span_timeline.json`` and ``spans.jsonl``: every
  observability-tracer span recorded inside the window (the host-side span
  timeline, as the JAX package writes it).

``torch.profiler`` records the host ops of the thread that starts it, so the
window starts and stops on the thread that calls :meth:`ProfilerStepper.step`:
the trainer calls it on its own thread, between two steps.

Options string: ``key=value`` pairs separated by ``;``, e.g.
``batch_range=[10,20];profile_path=./profile_out`` — the trace covers steps
[start, end) of ``batch_range``: it starts when step ``start`` has completed
and stops when step ``end`` has.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from ..observability.tracer import TRACER
from .log import logger

__all__ = ["ProfilerOptions", "ProfilerStepper", "add_profiler_step"]


@dataclasses.dataclass
class ProfilerOptions:
    batch_range: Tuple[int, int] = (10, 12)
    profile_path: str = "profile_out"

    @classmethod
    def parse(cls, options: str) -> "ProfilerOptions":
        out = cls()
        for item in (options or "").split(";"):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"profiler option {item!r} is not key=value")
            k, v = (s.strip() for s in item.split("=", 1))
            if k == "batch_range":
                nums = [int(x) for x in v.strip("[]() ").replace(",", " ").split()]
                if len(nums) != 2 or nums[0] < 0 or nums[1] <= nums[0]:
                    raise ValueError(f"batch_range must be [start, end) with end>start>=0, got {v!r}")
                out.batch_range = (nums[0], nums[1])
            elif k == "profile_path":
                out.profile_path = v
            else:
                logger.warning(f"ignoring unknown profiler option {k!r}")
        return out


class ProfilerStepper:
    """Call ``step(global_step)`` once per train step; traces the configured
    window exactly once."""

    def __init__(self, options: ProfilerOptions, tracer=TRACER):
        self.options = options
        self.tracer = tracer
        self._prof = None
        self._done = False
        self._window_t0: Optional[float] = None

    def step(self, global_step: int):
        start, end = self.options.batch_range
        if self._done:
            return
        if self._prof is None and start <= global_step < end:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            # anchored-timeline cursor (snapshot since_ts compares span.ts,
            # which is perf-anchored — a wall-clock step must not empty the window)
            self._window_t0 = self.tracer.now()
            self.tracer.instant("profiler_window_start", cat="profiler", trace="train", step=global_step)
            logger.info(f"profiler: tracing steps [{global_step}, {end}) -> {self.options.profile_path}")
        elif self._prof is not None and global_step >= end:
            self._stop(global_step)

    def _stop(self, global_step: Optional[int] = None):
        self.tracer.instant("profiler_window_stop", cat="profiler", trace="train", step=global_step)
        prof, self._prof = self._prof, None
        prof.stop()
        self._done = True
        os.makedirs(self.options.profile_path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.options.profile_path, "trace.json"))
        self._dump_spans()
        logger.info(f"profiler: trace written to {self.options.profile_path}")

    def _dump_spans(self):
        """Write the window's host-side span timeline next to the device trace
        (same step range — filtered by the window's start timestamp)."""
        try:
            spans = self.tracer.snapshot(since_ts=self._window_t0)
            path = os.path.join(self.options.profile_path, "span_timeline.json")
            self.tracer.write_chrome_trace(path, spans)
            with open(os.path.join(self.options.profile_path, "spans.jsonl"), "w") as f:
                f.write(self.tracer.to_jsonl(spans) + "\n")
            logger.info(f"profiler: {len(spans)} host spans -> {path}")
        except Exception as e:  # span dump must never fail the run
            logger.warning(f"profiler: span timeline dump failed: {e!r}")

    def close(self):
        if self._prof is not None:
            self._stop()


_GLOBAL: Optional[ProfilerStepper] = None


def add_profiler_step(options: Optional[str], global_step: int):
    """Stateless entry mirroring the reference's add_profiler_step: feed the
    step counter; start/stop happen at the window edges."""
    global _GLOBAL
    if not options:
        return
    if _GLOBAL is None:
        _GLOBAL = ProfilerStepper(ProfilerOptions.parse(options))
    _GLOBAL.step(global_step)
