"""GPTQ post-training quantization.

PyTorch port of ``paddlenlp_tpu/quantization/gptq.py``:

- :func:`gptq_quantize`: the OBQ/GPTQ algorithm, column by column absmax
  quantization of W with Cholesky-based error compensation from the
  calibration Hessian H = X^T X (Frantar et al.). Pure numpy, a copy of the
  JAX package's (it runs offline on the host).
- :func:`collect_hessians` / :func:`apply_gptq`: the calibration flow. The
  dense forward's observer hook hands over every targeted projection's input,
  each layer's on its own, and the per-kernel Hessians (keyed by the JAX
  package's unrolled paths) accumulate on the model's device; the rewrite
  quantizes each layer slice of a stacked ``[L, in, out]`` kernel with its
  own layer's Hessian and writes it back in place. GPTQ chooses the values;
  ``quantize_params`` chooses the storage.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..transformers.conversion_utils import flatten_params, resolve_stacked_key, unflatten_params
from ..utils.log import logger
from .a8w8 import _ids, _kernel_paths

__all__ = ["gptq_quantize", "collect_hessians", "apply_gptq"]


def gptq_quantize(
    w: np.ndarray,  # [in, out] (contraction axis first)
    hessian: np.ndarray,  # [in, in] = X^T X from calibration
    bits: int = 4,
    group_size: int = -1,  # scale granularity along the in axis (-1: per-column)
    percdamp: float = 0.01,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (w_q dequantized, int codes). Error from quantizing input-row i is
    propagated into the not-yet-quantized rows via the inverse-Hessian column."""
    w = np.asarray(w, np.float64).copy()
    n_in, n_out = w.shape
    H = np.asarray(hessian, np.float64).copy()
    dead = np.diag(H) == 0
    H[dead, dead] = 1.0
    w[dead, :] = 0.0
    damp = percdamp * np.mean(np.diag(H))
    H[np.diag_indices(n_in)] += damp
    # upper-triangular factor U with inv(H) = U^T U (the rows U[i, i:] carry the
    # compensation coefficients; a lower factor would zero them out)
    Hinv = np.linalg.cholesky(np.linalg.inv(H)).T

    qmax = 2 ** (bits - 1) - 1
    codes = np.zeros_like(w, dtype=np.int8)
    scales = np.zeros((1 if group_size == -1 else -(-n_in // group_size), n_out), np.float64)
    if group_size == -1:
        scales[0] = np.abs(w).max(axis=0) / qmax
    for i in range(n_in):
        g = 0 if group_size == -1 else i // group_size
        if group_size != -1 and i % group_size == 0:
            end = min(i + group_size, n_in)
            scales[g] = np.abs(w[i:end]).max(axis=0) / qmax
        s = np.maximum(scales[g], 1e-12)
        q = np.clip(np.round(w[i] / s), -qmax - 1, qmax)
        codes[i] = q.astype(np.int8)
        dq = q * s
        err = (w[i] - dq) / Hinv[i, i]
        if i + 1 < n_in:
            w[i + 1:] -= np.outer(Hinv[i, i + 1:], err)
        w[i] = dq
    return w.astype(np.float32), codes


@torch.no_grad()
def collect_hessians(model, batches: List[Dict], target_suffix: str = "/kernel",
                     match=None) -> Dict[str, np.ndarray]:
    """Run calibration batches (``{"input_ids": [B, T]}``) through the dense
    forward, accumulating H = sum_i x_i x_i^T in fp32 per matched projection
    (keyed by unrolled kernel path)."""
    targets = {p for p in _kernel_paths(model, match) if p.endswith(target_suffix)}
    hessians: Dict[str, torch.Tensor] = {}

    def observe(path, x):
        if path in targets:
            x = x.float().reshape(-1, x.shape[-1])
            h = x.T @ x
            hessians[path] = h if path not in hessians else hessians[path] + h

    for batch in batches:
        model(_ids(batch).to(model.device), observer=observe)
    return {p: h.cpu().numpy() for p, h in hessians.items()}


def apply_gptq(model, batches: List[Dict], bits: int = 4, group_size: int = -1, match=None) -> dict:
    """GPTQ-calibrate and rewrite: the model's params tree with every matched
    kernel replaced by its GPTQ-dequantized values (pass it to
    ``quantize_params`` for int storage), each layer slice of a stacked
    kernel quantized with its own layer's Hessian."""
    hessians = collect_hessians(model, batches, match=match)
    flat = dict(flatten_params(model.params))
    pending: Dict[str, np.ndarray] = {}  # stacked path -> mutable fp32 host copy
    n = 0
    for path, H in hessians.items():
        hit = resolve_stacked_key(path, flat) if path not in flat else None
        if hit is None:
            w = flat[path].float().cpu().numpy()
            flat[path] = torch.from_numpy(gptq_quantize(w, H, bits, group_size)[0]).to(flat[path].device,
                                                                                         flat[path].dtype)
        else:
            key, idxs = hit
            if key not in pending:  # a copy: numpy() of a CPU fp32 tensor shares its memory
                pending[key] = flat[key].float().cpu().numpy().copy()
            pending[key][idxs] = gptq_quantize(pending[key][idxs], H, bits, group_size)[0]
        n += 1
    for key, arr in pending.items():
        flat[key] = torch.from_numpy(arr).to(flat[key].device, flat[key].dtype)
    logger.info(f"GPTQ: rewrote {n} kernels at {bits} bits (group_size={group_size})")
    return unflatten_params(flat)
