"""A8W8: int8 activations x int8 weights.

PyTorch port of ``paddlenlp_tpu/quantization/a8w8.py``. The int8 product is
``torch._int_mm`` (int8 x int8 -> int32, exact), with the dequant rescale on
its output:

    y = (x_q @ w_q) * a_scale * w_scale (+ bias, in fp32)

- weights: symmetric per-out-channel int8 (``quantize_params``), each layer
  slice stored column-major, the layout ``_int_mm`` takes on CUDA;
- activations: symmetric per-token dynamic scales by default, or a calibrated
  per-tensor static scale from :func:`collect_act_scales` (absmax over
  calibration batches), folded into ``act_scale`` leaves of shape ``[L]`` by
  :func:`fold_act_scales`.

On CUDA ``_int_mm`` refuses M <= 16 rows, and K or N that are not multiples of
8. The rows are padded with zeros to 17: the integer sums are exact, so the
padding changes no bit of the real rows. A K or N it refuses raises: there is
no floating-point fallback. The JAX package's ``a8w8_interceptor`` has no
counterpart: the forwards dispatch each projection through
``quantization_utils.linear``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..transformers.conversion_utils import flatten_params, resolve_stacked_key, unflatten_params
from ..utils.log import logger

__all__ = ["collect_act_scales", "fold_act_scales", "int8_linear", "int8_matmul"]

#: rows ``torch._int_mm`` needs on CUDA (it refuses M <= 16)
CUDA_MIN_ROWS = 17


def device_const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d fp32 tensor on ``x``'s device, filled there (no
    host copy): a divisor there divides in IEEE fp32, where a Python scalar
    divisor on CUDA multiplies by its rounded reciprocal, which is not the
    same function."""
    return torch.full((), value, dtype=torch.float32, device=x.device)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``a`` [M, K] x int8 ``b`` [K, N] -> int32 [M, N], exact. On CUDA
    fewer than 17 rows are zero-padded to 17 (the padded rows are dropped)."""
    M = a.shape[0]
    if a.is_cuda and M < CUDA_MIN_ROWS:
        a = torch.nn.functional.pad(a, (0, 0, 0, CUDA_MIN_ROWS - M))
    return torch._int_mm(a, b)[:M]


def int8_linear(
    x: torch.Tensor,  # [..., in] activations (bf16/fp32)
    qweight: torch.Tensor,  # [in, out] int8
    w_scales: torch.Tensor,  # [out] fp32 per-out-channel
    bias: Optional[torch.Tensor] = None,
    act_scale=None,  # scalar static scale (calibrated)
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """int8 x int8 -> int32 product with the dequant rescale, in the JAX
    package's order: ``y.float() * a_scale * w_scales``, then ``+ bias``,
    then the cast."""
    with torch.profiler.record_function("quantize_activations"):  # its device ms in a profile
        x32 = x.float()
        if act_scale is None:
            a_scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / device_const(x32, 127.0), 1e-8)
        else:
            a_scale = torch.clamp_min(torch.as_tensor(act_scale, dtype=torch.float32, device=x.device), 1e-8)
        x_q = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
    lead = x_q.shape[:-1]
    y = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), qweight).reshape(lead + (qweight.shape[-1],))
    y = y.float() * a_scale * w_scales.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _kernel_paths(model, match=None):
    """The unrolled ``.../kernel`` paths of every projection the dense forward
    observes (the JAX package's unrolled tree: every kernel of rank >= 2,
    the head included when it is not tied), filtered by ``match``."""
    L = model.config.num_hidden_layers
    paths = []
    for path, leaf in flatten_params(model.params).items():
        if not path.endswith("/kernel") or leaf.dim() < 2:
            continue
        if "/layers/" in path:
            paths += [path.replace("/layers/", f"/layers_{i}/", 1) for i in range(L)]
        else:
            paths.append(path)
    return {p for p in paths if match is None or match(p)}


def _ids(batch) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch["input_ids"]))


@torch.no_grad()
def collect_act_scales(model, batches: List[Dict], match=None) -> Dict[str, float]:
    """Calibration pass: per-projection per-tensor activation absmax / 127
    (the PTQ observer), over the dense forward of each batch
    (``{"input_ids": [B, T]}``). Keys are unrolled kernel paths
    (``model/layers_0/self_attn/q_proj/kernel``, ``lm_head/kernel``)."""
    targets = _kernel_paths(model, match)
    amax: Dict[str, torch.Tensor] = {}

    def observe(path, x):
        if path in targets:
            m = x.float().abs().amax()
            amax[path] = m if path not in amax else torch.maximum(amax[path], m)

    for batch in batches:
        model(_ids(batch).to(model.device), observer=observe)
    return {p: float(m) / 127.0 for p, m in amax.items()}


def fold_act_scales(params: dict, act_scales: Dict[str, float]) -> dict:
    """Calibrated per-tensor activation scales (unrolled ``.../kernel`` keys)
    -> ``act_scale`` leaves inside each quantized module: a stacked ``[L]``
    fp32 leaf where every layer has a scale; a projection some layer lacks
    stays on dynamic per-token scales."""
    flat = dict(flatten_params(params))
    adds: Dict[str, torch.Tensor] = {}
    stacked: Dict[str, Dict[tuple, float]] = {}
    for key, val in act_scales.items():
        if not key.endswith("/kernel"):
            continue
        qkey = key[: -len("/kernel")] + "/qweight"
        if qkey in flat:
            adds[key[: -len("/kernel")] + "/act_scale"] = torch.tensor(val, dtype=torch.float32,
                                                                       device=flat[qkey].device)
            continue
        hit = resolve_stacked_key(qkey, flat)
        if hit is not None:
            skey, idxs = hit
            stacked.setdefault(skey, {})[idxs] = val
    for skey, items in stacked.items():
        lead = tuple(flat[skey].shape[:-2])
        arr = np.zeros(lead, np.float32)
        mask = np.zeros(lead, bool)
        for idxs, val in items.items():
            arr[idxs] = val
            mask[idxs] = True
        if not mask.all():
            logger.warning(
                f"act scales cover {int(mask.sum())}/{mask.size} slices of {skey}; "
                "leaving that projection on dynamic per-token scales"
            )
            continue
        adds[skey[: -len("/qweight")] + "/act_scale"] = torch.from_numpy(arr).to(flat[skey].device)
    flat.update(adds)
    return unflatten_params(flat)

