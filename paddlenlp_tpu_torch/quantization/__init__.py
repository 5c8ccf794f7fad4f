"""Quantization of the PyTorch port: weight-only int8/int4/fp8, a8w8
(int8 activations x int8 weights), GPTQ and the QLoRA NF4 format.

PyTorch port of ``paddlenlp_tpu/quantization/``. The trees it produces are
the JAX package's, leaf for leaf and bit for bit, so a quantized checkpoint,
an ``act_scales.json`` or a GPTQ result written by either package loads in
the other.
"""

from .quantization_config import QuantizationConfig  # noqa: F401
from .quantization_utils import QuantizedModel, dequantize_leaf, linear, quantize_params  # noqa: F401
from .gptq import apply_gptq, collect_hessians, gptq_quantize  # noqa: F401
from .qlora import NF4_CODE, nf4_dequantize, nf4_quantize  # noqa: F401
from .a8w8 import collect_act_scales, fold_act_scales, int8_linear  # noqa: F401
