"""Cache directory, artifact file names and device facts.

The port's counterpart of ``paddlenlp_tpu/utils/env.py``: ``MODEL_HOME``
(``PDNLP_TPU_HOME``, default ``~/.paddlenlp_tpu``), the canonical artifact
names (``:38-44``) and ``device_peak_flops``, keyed on CUDA device names
instead of TPU kinds."""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["MODEL_HOME", "DATA_HOME", "PDNLP_TPU_HOME", "CONFIG_NAME", "GENERATION_CONFIG_NAME",
           "SAFE_WEIGHTS_NAME", "SAFE_WEIGHTS_INDEX_NAME", "TOKENIZER_CONFIG_NAME", "CHAT_TEMPLATE_NAME",
           "device_peak_flops"]

PDNLP_TPU_HOME = os.environ.get("PDNLP_TPU_HOME") or os.path.join(os.path.expanduser("~"), ".paddlenlp_tpu")
MODEL_HOME = os.path.join(PDNLP_TPU_HOME, "models")
DATA_HOME = os.path.join(PDNLP_TPU_HOME, "datasets")

CONFIG_NAME = "config.json"
GENERATION_CONFIG_NAME = "generation_config.json"
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
TOKENIZER_CONFIG_NAME = "tokenizer_config.json"
CHAT_TEMPLATE_NAME = "chat_template.json"

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
