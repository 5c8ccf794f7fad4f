"""Device facts for throughput metrics.

The port's counterpart of ``paddlenlp_tpu/utils/env.py`` ``device_peak_flops``,
keyed on CUDA device names instead of TPU kinds, and the name of a model
directory's generation config (``GENERATION_CONFIG_NAME``, ``:40``)."""

from __future__ import annotations

from typing import Optional

__all__ = ["GENERATION_CONFIG_NAME", "device_peak_flops"]

GENERATION_CONFIG_NAME = "generation_config.json"

#: per-device peak dense FLOPs (bf16) by CUDA device-name substring (matched
#: case-insensitively; NVIDIA's data sheet, SXM part, dense). Off-table
#: devices read NaN: an unknown denominator must not fake an MFU.
_PEAK_FLOPS_BY_KIND = (
    ("h100", 989e12),
)


def device_peak_flops(device_kind: Optional[str] = None) -> float:
    """Peak per-device FLOPs for the current (or named) CUDA device; NaN when
    unknown or when there is no CUDA device."""
    if device_kind is None:
        import torch

        if not torch.cuda.is_available():
            return float("nan")
        device_kind = torch.cuda.get_device_name()
    kind = str(device_kind).lower()
    for sub, peak in _PEAK_FLOPS_BY_KIND:
        if sub in kind:
            return peak
    return float("nan")
