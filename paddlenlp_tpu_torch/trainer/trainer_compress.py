"""Post-training compression behind ``Trainer.compress()``.

PyTorch port of ``paddlenlp_tpu/trainer/trainer_compress.py`` for the
LLaMA-family models (the port's only family; the JAX package's BERT-style
encoder cases wait for ROADMAP Queue 1 item 14):

- ``ptq``: weight-only int8/int4, optionally GPTQ-calibrated on batches of
  the eval (or train) dataset;
- ``a8w8``: int8 weights plus per-tensor activation scales calibrated by the
  dense forward's observer (``act_scales.json``);
- ``qat``: a few steps of fake-quant finetuning (a straight-through
  estimator, ``w + (qdq(w) - w).detach()``) under optax's ``adamw`` (decay
  1e-4 on every leaf), then the PTQ export;
- ``embedding_quant``: int8 per-row embedding tables;
- ``prune`` / ``prune_depth``: ffn width pruning by the down projection's
  row norms, and evenly spaced depth pruning, each with a patched config.

Every export is the JAX package's: ``model.safetensors`` + ``config.json``
through ``save_pretrained`` (the fp reference, or the pruned model), and
``model_quant.safetensors`` with the same keys, in the same order, holding
the same bits. The offline numpy transforms (embedding quantization, the
pruning choices) are the JAX package's numpy, so their results are too.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from ..quantization import QuantizationConfig, quantize_params
from ..quantization.a8w8 import collect_act_scales, device_const
from ..quantization.gptq import apply_gptq
from ..quantization.quantization_utils import DEFAULT_SKIP
from ..transformers.conversion_utils import flatten_params, sorted_tree, unflatten_params
from ..utils.log import logger
from ..utils.safetensors_io import save_file
from .trainer import AdamW

__all__ = ["compress", "dequantize_embedding"]


def compress(trainer, strategy: str = "ptq", output_dir: Optional[str] = None, **kwargs):
    """Entry point of ``Trainer.compress()``; see the module docstring."""
    output_dir = output_dir or os.path.join(trainer.args.output_dir, f"compress_{strategy}")
    if strategy == "ptq":
        return _ptq(trainer, output_dir, **kwargs)
    if strategy == "prune":
        return _prune_width(trainer, output_dir, **kwargs)
    if strategy == "prune_depth":
        return _prune_depth(trainer, output_dir, **kwargs)
    if strategy == "a8w8":
        return _a8w8(trainer, output_dir, **kwargs)
    if strategy == "qat":
        return _qat(trainer, output_dir, **kwargs)
    if strategy == "embedding_quant":
        return _embedding_quant(trainer, output_dir, **kwargs)
    raise ValueError(f"unknown compression strategy {strategy!r} "
                     "(ptq | prune | prune_depth | a8w8 | qat | embedding_quant)")


def _params(trainer) -> dict:
    """The model's tree in the JAX package's key order, which the exports'
    key order follows."""
    return sorted_tree(trainer.model.params)


def _calib_batches(trainer, n: int, what: str):
    dataset = trainer.eval_dataset or trainer.train_dataset
    if dataset is None:
        raise ValueError(f"{what} calibration needs an eval or train dataset")
    return [{"input_ids": np.asarray(dataset[i]["input_ids"])[None]} for i in range(min(n, len(dataset)))]


def _ptq(trainer, output_dir: str, bits: int = 8, use_gptq: bool = False, n_calib_batches: int = 4, match=None):
    model = trainer.model
    params = _params(trainer)
    if use_gptq:
        params = sorted_tree(apply_gptq(model, _calib_batches(trainer, n_calib_batches, "GPTQ"), bits=bits,
                                        match=match))
    _ptq_export(trainer, params, output_dir, bits)
    logger.info(f"PTQ({'gptq+' if use_gptq else ''}wint{bits}) exported to {output_dir}")
    return output_dir


def _a8w8(trainer, output_dir: str, n_calib_batches: int = 4, match=None, static_act_scales: bool = True):
    """Activation+weight int8 export: calibrated per-tensor activation absmax
    observers, int8 weights, both saved with the scale table."""
    model = trainer.model
    params = _params(trainer)
    act_scales = None
    if static_act_scales:
        act_scales = collect_act_scales(model, _calib_batches(trainer, n_calib_batches, "a8w8"), match=match)
    qparams = quantize_params(params, QuantizationConfig(weight_quantize_algo="a8w8"))
    model.save_pretrained(output_dir, params=params)  # fp reference
    _save_q(qparams, output_dir)
    if act_scales is not None:
        with open(os.path.join(output_dir, "act_scales.json"), "w") as f:
            json.dump(act_scales, f)
    logger.info(f"a8w8 exported to {output_dir} ({'static' if act_scales else 'dynamic'} activation scales)")
    return output_dir


def _save_q(qparams: dict, output_dir: str):
    tensors = {k: v.detach().cpu().contiguous() for k, v in flatten_params(qparams).items()}
    save_file(tensors, os.path.join(output_dir, "model_quant.safetensors"), metadata={"format": "np"})


def _qat(trainer, output_dir: str, bits: int = 8, n_qat_steps: int = 32, learning_rate: float = 1e-5, match=None):
    """Quantization-aware finetune: targeted kernels pass through fake quant
    (quantize -> dequantize) in the forward with a straight-through
    estimator, so gradients reach the fp weights while the loss sees the
    int8/int4 rounding; the adapted weights are then PTQ-exported. The
    model's own weights stay as they were."""
    dataset = trainer.train_dataset
    if dataset is None:
        raise ValueError("QAT needs a train dataset")
    skip_res = [re.compile(p) for p in DEFAULT_SKIP]
    target_res = [re.compile(p) for p in match] if match else None
    qmax = 127 if bits == 8 else 7

    def wanted(path, leaf):
        is_kernel = path.endswith("/kernel") and leaf.dim() >= 2
        if target_res is not None:
            return is_kernel and any(p.search(path) for p in target_res)
        return is_kernel and not any(p.search(path) for p in skip_res)

    flat = {k: v.detach().clone().requires_grad_(True) for k, v in flatten_params(_params(trainer)).items()}
    targets = {k for k, v in flat.items() if wanted(k, v)}

    def fake_quant_tree():
        out = {}
        for path, leaf in flat.items():
            if path in targets:
                with torch.no_grad():
                    scales = torch.clamp_min(leaf.abs().amax(dim=-2, keepdim=True) / device_const(leaf, qmax), 1e-12)
                    qdq = torch.clamp(torch.round(leaf / scales), -qmax - 1, qmax) * scales
                leaf = leaf + (qdq - leaf).detach()  # straight-through
            out[path] = leaf
        return unflatten_params(out)

    # optax.adamw(learning_rate): b1 0.9, b2 0.999, eps 1e-8, decay 1e-4 on every leaf
    opt = AdamW(flat, lambda step: learning_rate, weight_decay=1e-4, decays=lambda name: True)
    first = last = None
    for i in range(n_qat_steps):
        row = dataset[i % len(dataset)]
        batch = {k: torch.as_tensor(np.asarray(v)[None]).to(trainer.device) for k, v in row.items()
                 if k in ("input_ids", "labels", "attention_mask")}
        loss = trainer.compute_loss(batch, params=fake_quant_tree())
        loss.backward()
        opt.step(flat, {k: v.grad for k, v in flat.items()})
        for v in flat.values():
            v.grad = None
        last = float(loss.detach())
        first = last if first is None else first
    logger.info(f"QAT: {n_qat_steps} fake-quant steps, loss {first:.4f} -> {last:.4f}")
    return _ptq_export(trainer, unflatten_params({k: v.detach() for k, v in flat.items()}), output_dir, bits)


def _ptq_export(trainer, params, output_dir: str, bits: int):
    algo = "weight_only_int8" if bits == 8 else "weight_only_int4"
    qparams = quantize_params(params, QuantizationConfig(weight_quantize_algo=algo))
    trainer.model.save_pretrained(output_dir, params=params)
    _save_q(qparams, output_dir)
    return output_dir


def _embedding_quant(trainer, output_dir: str):
    """int8 per-row (per-token) quantization of the embedding tables: rows are
    what a lookup reads, so per-row scales keep dequantization one multiply."""
    model = trainer.model
    params = _params(trainer)
    flat = dict(flatten_params(params))
    n = 0
    for path in list(flat):
        if not path.endswith("/embedding"):
            continue
        w = flat[path].detach().float().cpu().numpy()
        absmax = np.abs(w).max(axis=-1, keepdims=True)  # per row
        scales = np.maximum(absmax / 127.0, 1e-12).astype(np.float32)
        q = np.clip(np.round(w / scales), -128, 127).astype(np.int8)
        prefix = path.rsplit("/", 1)[0]
        del flat[path]
        flat[prefix + "/qembedding"] = torch.from_numpy(q)
        flat[prefix + "/embed_scales"] = torch.from_numpy(scales[..., 0])
        n += 1
    if n == 0:
        raise ValueError("no embedding tables found")
    model.save_pretrained(output_dir, params=params)  # loadable fp reference
    _save_q(unflatten_params(flat), output_dir)
    logger.info(f"embedding-quantized {n} tables to int8 per-row; exported {output_dir}")
    return output_dir


def dequantize_embedding(qembedding: torch.Tensor, embed_scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``_embedding_quant`` (load-side helper)."""
    return (qembedding.float() * embed_scales.float()[..., None]).to(dtype)


def _save_pruned(model, output_dir: str, params: dict, **config_changes):
    """Export ``params`` under a patched copy of the config; the live model
    keeps its own params and config."""
    pruned_cfg = copy.deepcopy(model.config)
    for k, v in config_changes.items():
        setattr(pruned_cfg, k, v)
    orig_cfg = model.config
    model.config = pruned_cfg
    try:
        model.save_pretrained(output_dir, params=params)
    finally:
        model.config = orig_cfg


def _prune_depth(trainer, output_dir: str, depth_mult: float = 0.5):
    """Keep ``round(L * depth_mult)`` layers evenly spaced across depth (the
    dynabert depth schedule) of the stacked ``model/layers`` params."""
    model = trainer.model
    L = model.config.num_hidden_layers
    new_l = max(int(round(L * depth_mult)), 1)
    keep = np.unique(np.linspace(0, L - 1, new_l).round().astype(int))
    new_l = len(keep)
    idx = None
    out = {}
    n_sliced = 0
    for path, leaf in flatten_params(_params(trainer)).items():
        if "/layers/" in path and leaf.dim() >= 1 and leaf.shape[0] == L:
            idx = torch.from_numpy(keep).to(leaf.device) if idx is None else idx
            leaf = leaf.index_select(0, idx)
            n_sliced += 1
        out[path] = leaf
    if n_sliced == 0:
        raise ValueError(f"no per-layer params found to prune (L={L})")
    _save_pruned(model, output_dir, unflatten_params(out), num_hidden_layers=new_l)
    logger.info(f"depth-pruned {L} -> {new_l} layers (kept {list(keep)}); exported {output_dir}")
    return output_dir


def _prune_width(trainer, output_dir: str, width_mult: float = 0.75):
    """Keep the top ``width_mult`` of the ffn columns by the L2 norm of the
    down projection's rows (the dynabert importance proxy), per layer."""
    model = trainer.model
    flat = dict(flatten_params(_params(trainer)))
    new_f = int(model.config.intermediate_size * width_mult)
    prefixes = sorted({p.rsplit("/", 2)[0] for p in flat if p.endswith("down_proj/kernel")})
    if not prefixes:
        raise ValueError("no prunable ffn kernels found (expected llama-style gate/up/down)")
    for prefix in prefixes:
        key = f"{prefix}/down_proj/kernel"
        down = flat[key].detach().float().cpu().numpy()  # [L, F, D]
        imp = np.linalg.norm(down, axis=-1)  # [L, F]
        keep = np.sort(np.argsort(-imp, axis=-1)[:, :new_f], axis=-1)
        idx = torch.from_numpy(keep).to(flat[key].device)
        flat[key] = torch.take_along_dim(flat[key], idx[..., None], dim=-2)
        for name in ("gate_proj", "up_proj"):
            k = f"{prefix}/{name}/kernel"  # [L, D, F]
            flat[k] = torch.take_along_dim(flat[k], idx[:, None, :], dim=-1)
    _save_pruned(model, output_dir, unflatten_params(flat), intermediate_size=new_f)
    logger.info(f"width-pruned {len(prefixes)} ffn stacks to {new_f} ({width_mult:.0%}); exported {output_dir}")
    return output_dir
