"""Quantization configuration.

A copy of ``paddlenlp_tpu/quantization/quantization_config.py:1-42`` (which
imports no JAX; the port keeps its own copy)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["QuantizationConfig"]

SUPPORTED_ALGOS = ("weight_only_int8", "wint8", "weight_only_int4", "wint4", "a8w8",
                   "fp8", "weight_only_fp8")


@dataclasses.dataclass
class QuantizationConfig:
    weight_quantize_algo: Optional[str] = None  # wint8 | wint4 | fp8 | a8w8
    quant_round_type: int = 0
    llm_int8_threshold: float = 6.0
    # param-path regexes to quantize; None -> all 2D+ kernels except embeddings/lm_head
    quant_target_modules: Optional[List[str]] = None

    def __post_init__(self):
        if self.weight_quantize_algo is not None and self.weight_quantize_algo not in SUPPORTED_ALGOS:
            raise ValueError(
                f"weight_quantize_algo={self.weight_quantize_algo!r} unsupported; pick from {SUPPORTED_ALGOS}"
            )

    @property
    def bits(self) -> int:
        return 4 if self.weight_quantize_algo in ("weight_only_int4", "wint4") else 8

    @property
    def is_weight_quantize(self) -> bool:
        return self.weight_quantize_algo is not None

    @property
    def is_activation_quantize(self) -> bool:
        return self.weight_quantize_algo == "a8w8"

    @property
    def is_fp8(self) -> bool:
        return self.weight_quantize_algo in ("fp8", "weight_only_fp8")
