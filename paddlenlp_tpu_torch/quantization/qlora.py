"""QLoRA weight format: NF4 blockwise quantization with double quantization.

PyTorch port of ``paddlenlp_tpu/quantization/qlora.py``: weights flatten to
blocks of ``block_size``; each block stores absmax-normalized values snapped
to the 16-level NF4 codebook; double quantization compresses the per-block
fp32 absmax scales to int8 over scale-blocks of 256. :func:`nf4_quantize` is
the JAX package's numpy (a copy: it runs offline on the host);
:func:`nf4_dequantize` rebuilds the weights with torch ops on ``device``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["NF4_CODE", "nf4_quantize", "nf4_dequantize"]

# bitsandbytes NF4 codebook (quantiles of N(0,1), normalized to [-1, 1])
NF4_CODE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
], dtype=np.float32)


def nf4_quantize(w: np.ndarray, block_size: int = 64, double_quant: bool = True) -> Dict[str, np.ndarray]:
    """Returns {codes(uint8, two nibbles per byte), absmax(..), shape} blocks."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(-1)
    pad = (-len(flat)) % block_size
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block_size)
    absmax = np.abs(blocks).max(axis=1)
    normed = blocks / np.maximum(absmax[:, None], 1e-12)
    idx = np.abs(normed[..., None] - NF4_CODE[None, None, :]).argmin(axis=-1).astype(np.uint8)
    flat_idx = idx.reshape(-1)
    if len(flat_idx) % 2:  # odd nibble count: pad so the two packing lanes align
        flat_idx = np.concatenate([flat_idx, np.zeros(1, np.uint8)])
    codes = (flat_idx[0::2] | (flat_idx[1::2] << 4)).astype(np.uint8)
    out = {"codes": codes, "shape": np.asarray(w.shape, np.int64), "block_size": np.asarray(block_size)}
    if double_quant:
        # absmax scales -> int8 over scale-blocks of 256 with one fp32 scale each
        sb = 256
        spad = (-len(absmax)) % sb
        a = np.concatenate([absmax, np.zeros(spad, np.float32)]) if spad else absmax
        a = a.reshape(-1, sb)
        offset = a.mean()
        centered = a - offset
        s2 = np.abs(centered).max(axis=1) / 127.0
        q = np.clip(np.round(centered / np.maximum(s2[:, None], 1e-12)), -128, 127).astype(np.int8)
        out.update(absmax_q=q.reshape(-1)[: len(absmax)], absmax_scales=s2.astype(np.float32),
                   absmax_offset=np.asarray(offset, np.float32), absmax_len=np.asarray(len(absmax)))
    else:
        out["absmax"] = absmax.astype(np.float32)
    return out


def nf4_dequantize(state: Dict[str, np.ndarray], dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """The weights of an :func:`nf4_quantize` state, in ``dtype`` on ``device``."""
    codes = torch.from_numpy(np.asarray(state["codes"])).to(device)
    lo = (codes & 0x0F).long()
    hi = ((codes >> 4) & 0x0F).long()
    idx = torch.stack([lo, hi], dim=-1).reshape(-1)
    vals = torch.from_numpy(NF4_CODE).to(device)[idx]
    block_size = int(np.asarray(state["block_size"]))
    if "absmax" in state:
        absmax = torch.from_numpy(np.asarray(state["absmax"])).to(device)
    else:
        n = int(np.asarray(state["absmax_len"]))
        q = torch.from_numpy(np.asarray(state["absmax_q"])).to(device, torch.float32)
        sb = 256
        scales = torch.from_numpy(np.asarray(state["absmax_scales"])).to(device).repeat_interleave(sb)[:n]
        absmax = q * scales + torch.from_numpy(np.asarray(state["absmax_offset"])).to(device)
    vals = vals.reshape(-1, block_size) * absmax[:, None]
    shape = tuple(int(x) for x in np.asarray(state["shape"]))
    n_el = int(np.prod(shape))
    return vals.reshape(-1)[:n_el].reshape(shape).to(dtype)
