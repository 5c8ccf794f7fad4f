"""Weight-only quantization (int8, packed int4, fp8) and the ``QuantizedModel``
facade.

PyTorch port of ``paddlenlp_tpu/quantization/quantization_utils.py``. As in
the JAX package there is no module surgery: :func:`quantize_params` replaces
each targeted ``kernel`` leaf with ``{qweight, scales}`` (symmetric absmax per
output channel and per leading layer slice), and the forwards dispatch each
projection on the leaves they find (:func:`linear`):

- no ``qweight``: ``x @ kernel`` (+ bias);
- a8w8: ``int8_linear`` (int8 activations x int8 weights, bias added in fp32);
- weight-only: ``x @ dequantize_leaf(...)`` (+ bias, after the cast).

The dense forward (``LlamaForCausalLM.__call__``) and the paged serving
forward (``PagedInferenceModel._mm``) both call :func:`linear`, so a
``QuantizedModel`` computes one function in every entry point.

The trees are the JAX package's bit for bit: fp32 scales, IEEE fp32
division (a divisor on the tensor's own device: CUDA divides by a host scalar
through its reciprocal), round half to even, and the int4 nibbles packed along
the contraction axis. :func:`quantize_params` runs on the leaf's device one
layer slice at a time, so Qwen2-7B quantizes on the card in seconds.

The port keeps one layer layout, stacked ``[L, in, out]``, and its dense
forward walks the layers eagerly: calibration sees each layer's inputs
directly, so the JAX package's ``unrolled_twin`` has no counterpart. Scales
and Hessians are keyed by the JAX package's unrolled paths
(``model/layers_3/self_attn/q_proj/kernel``) all the same, so their files
load in either package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from ..transformers.conversion_utils import flatten_params, unflatten_params
from ..utils.log import logger
from .a8w8 import device_const, fold_act_scales, int8_linear
from .quantization_config import QuantizationConfig

__all__ = ["DEFAULT_SKIP", "QuantizedModel", "dequantize_leaf", "linear", "quantize_params"]

DEFAULT_SKIP = [r"embed", r"lm_head", r"norm", r"score", r"wte", r"wpe"]

FP8_MAX = 448.0  # float8_e4m3fn finite max


def _quantize_array(w: torch.Tensor, bits: int):
    """Symmetric absmax quantization, per output channel and per leading
    (layer) slice: only the contraction axis (-2) is reduced. int4 packs two
    nibbles a byte along axis -2 (row 2i low, row 2i+1 high). Returns
    (int8 codes, fp32 scales [lead..., out])."""
    w = w.float()
    qmax = 127 if bits == 8 else 7
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scales = absmax / device_const(w, qmax)
    q = torch.clamp(torch.round(w / torch.clamp_min(scales, 1e-12)), -qmax - 1, qmax).to(torch.int8)
    if bits == 4:
        if q.shape[-2] % 2 != 0:
            raise ValueError(f"int4 packing needs an even dim, got {tuple(q.shape)}")
        lo = q[..., 0::2, :].to(torch.int32) & 0x0F
        hi = (q[..., 1::2, :].to(torch.int32) & 0x0F) << 4
        # the byte's bits as int8: numpy's int8 shift wraps the same way
        q = (lo | hi).to(torch.uint8).view(torch.int8)
    return q, scales.squeeze(-2)


def _quantize_array_fp8(w: torch.Tensor):
    """Per-output-channel (and per layer slice) scaled cast to float8_e4m3fn.
    |w / scale| <= 448 * (1 + 2**-22), where the cast agrees with the JAX
    package's ``ml_dtypes`` one (they part only beyond 464: saturation here,
    NaN there)."""
    w = w.float()
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scales = absmax / device_const(w, FP8_MAX)
    q = (w / torch.clamp_min(scales, 1e-12)).to(torch.float8_e4m3fn)
    return q, scales.squeeze(-2)


def _by_slice(w: torch.Tensor, fn, column_major: bool = False):
    """``fn`` over each ``[in, out]`` slice of a ``[lead..., in, out]`` leaf,
    written into preallocated outputs (the fp32 temporaries stay one slice's
    size). ``column_major`` stores each slice of the codes transposed in
    memory: the same values, strides ``(1, in)``."""
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    q = s = None
    for i in range(flat.shape[0]):
        qi, si = fn(flat[i])
        if q is None:
            shape = (flat.shape[0],) + (tuple(qi.shape[::-1]) if column_major else tuple(qi.shape))
            q = torch.empty(shape, dtype=qi.dtype, device=qi.device)
            s = torch.empty((flat.shape[0],) + tuple(si.shape), dtype=si.dtype, device=si.device)
        q[i] = qi.T if column_major else qi
        s[i] = si
    if column_major:
        q = q.transpose(-1, -2)
    lead = tuple(w.shape[:-2])
    return q.reshape(lead + tuple(q.shape[-2:])), s.reshape(lead + tuple(s.shape[-1:]))


def _unpack_int4(qweight: torch.Tensor) -> torch.Tensor:
    """Packed int4 ``[..., in/2, out]`` -> sign-extended int8 ``[..., in, out]``."""
    lo = (qweight & 0x0F).to(torch.int8)
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = ((qweight >> 4) & 0x0F).to(torch.int8)
    hi = torch.where(hi > 7, hi - 16, hi)
    return torch.stack([lo, hi], dim=-2).reshape(qweight.shape[:-2] + (qweight.shape[-2] * 2, qweight.shape[-1]))


def dequantize_leaf(qweight: torch.Tensor, scales: torch.Tensor, bits: int, dtype=torch.bfloat16) -> torch.Tensor:
    """``qweight`` (int8, packed int4 or float8_e4m3fn) times its per-channel
    scales, in fp32, cast to ``dtype``."""
    q = _unpack_int4(qweight) if bits == 4 and qweight.dtype == torch.int8 else qweight
    return (q.float() * scales.float()[..., None, :]).to(dtype)


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor, dtype: torch.dtype,
           config: Optional[QuantizationConfig] = None) -> torch.Tensor:
    """One projection ``x @ W (+ bias)`` over the leaves of its module ``p``,
    dispatched as the JAX package's ``_mm``
    (``paddlenlp_tpu/experimental/inference_model.py:148-165``): the kernel in
    ``dtype``; a8w8 through ``int8_linear`` with the bias added inside it in
    fp32; weight-only through the dequantized kernel, the bias added after
    the cast."""
    if "qweight" not in p:
        y = x @ p["kernel"].to(dtype)
    elif config is not None and config.is_activation_quantize:
        return int8_linear(x, p["qweight"], p["scales"], bias=p.get("bias"), act_scale=p.get("act_scale"),
                           out_dtype=dtype)
    else:
        bits = config.bits if config is not None else 8
        with torch.profiler.record_function("dequantize_leaf"):  # its device ms in a profile
            w = dequantize_leaf(p["qweight"], p["scales"], bits, dtype)
        y = x @ w
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


@torch.no_grad()
def quantize_params(params: dict, config: QuantizationConfig) -> dict:
    """kernel leaves -> ``{qweight, scales}`` groups on the leaves' device.
    a8w8 stores each layer slice of ``qweight`` column-major (the same values;
    the layout ``torch._int_mm`` takes on CUDA, where a row-major int8 operand
    is refused or ~5x slower)."""
    bits = config.bits
    targets = config.quant_target_modules
    skip_res = [re.compile(p) for p in DEFAULT_SKIP]
    target_res = [re.compile(p) for p in targets] if targets else None
    out: Dict[str, Any] = {}
    n_quant = 0
    for path, leaf in flatten_params(params).items():
        is_kernel = path.endswith("/kernel") and getattr(leaf, "ndim", 0) >= 2
        wanted = is_kernel and not any(p.search(path) for p in skip_res)
        if target_res is not None:
            wanted = is_kernel and any(p.search(path) for p in target_res)
        if not wanted:
            out[path] = leaf
            continue
        fn = _quantize_array_fp8 if config.is_fp8 else (lambda w: _quantize_array(w, bits))
        q, scales = _by_slice(leaf, fn, column_major=config.is_activation_quantize)
        prefix = path.rsplit("/", 1)[0]
        out[prefix + "/qweight"] = q
        out[prefix + "/scales"] = scales
        n_quant += 1
    if n_quant == 0:
        logger.warning("quantize_params: no kernels matched; params unchanged")
    else:
        kind = "float8_e4m3" if config.is_fp8 else f"int{bits}"
        logger.info(f"quantized {n_quant} kernels to {kind} (weight-only)")
    return unflatten_params(out)


def _dequantize_tree(params: dict, bits: int, dtype) -> dict:
    """Every ``{qweight, scales}`` group back to a ``kernel`` in ``dtype``."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        if "qweight" in out and "scales" in out:
            out["kernel"] = dequantize_leaf(out.pop("qweight"), out.pop("scales"), bits, dtype)
        return out

    return walk(params)


class QuantizedModel:
    """Facade holding the quantized params of a port ``LlamaForCausalLM`` (or
    ``Qwen2ForCausalLM``); the engine and the server take it as their model.
    It keeps the base model, and with it the bf16 weights, alive, as the JAX
    facade does (``paddlenlp_tpu/quantization/quantization_utils.py:184``)."""

    def __init__(self, model, config: Optional[QuantizationConfig] = None, act_scales=None):
        self.model = model
        self.quantization_config = config or QuantizationConfig(weight_quantize_algo="wint8")
        self.config = model.config
        self.params = quantize_params(model.params, self.quantization_config)
        if self.quantization_config.is_activation_quantize and act_scales:
            self.params = fold_act_scales(self.params, act_scales)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    def __call__(self, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The base model's dense forward over the quantized leaves (each
        projection through :func:`linear`): logits [B, T, V]."""
        return self.apply(self.params, input_ids, dtype=dtype)

    def apply(self, params: dict, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.model(input_ids, dtype=dtype, params=params, quantization_config=self.quantization_config)

    def generate(self, *args, **kwargs):
        """The base model's ``generate`` over the quantized leaves (every
        projection through :func:`linear`), JAX ``:213-220``. The facade's
        tree and config are passed as arguments, so no earlier call of the
        base model or of another facade changes what it computes."""
        kwargs.setdefault("params", self.params)
        return self.model.generate(*args, quantization_config=self.quantization_config, **kwargs)

    def memory_footprint(self) -> int:
        """Bytes of the quantized tree's leaves (the facade's base model not
        counted)."""
        return int(sum(t.numel() * t.element_size() for t in flatten_params(self.params).values()))
