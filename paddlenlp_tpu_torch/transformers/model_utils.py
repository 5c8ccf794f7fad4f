"""``PretrainedModel`` — the model-library backbone of the port.

Port of ``paddlenlp_tpu/transformers/model_utils.py:59-337`` (reference
``paddlenlp/transformers/model_utils.py``: ``PretrainedModel`` :921,
``from_pretrained`` :2161, ``save_pretrained`` :2469). A model holds its
``config`` and its parameters as a nested dict of tensors in the JAX
package's layout (``params``; a subclass gives the flat ``path -> shape``
table, :meth:`param_shapes`), so both packages hold the same tree.

- weights are stored and loaded as safetensors with HF keys (the mechanical
  name mapping of ``conversion_utils``), one file or shards with a
  ``model.safetensors.index.json``;
- ``from_pretrained`` takes the JAX keywords: ``dtype`` is the **compute**
  dtype (the training forward's ``compute_dtype``) and ``param_dtype`` the
  **storage** dtype of the parameters; both default to the checkpoint's
  ``config.dtype``, else float32 (``:187-189``). ``device`` (default
  ``"cuda"``) is the port's own keyword: where the parameters live;
- a leaf the checkpoint lacks is initialized and logged, keys the model does
  not read are warned about, and a ``generation_config.json`` beside the
  weights is loaded (``:224-236``, ``:372``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple, Type, Union

import torch

from ..generation.configuration_utils import GenerationConfig
from ..generation.utils import GenerationMixin
from ..utils.downloader import resolve_model_dir
from ..utils.env import GENERATION_CONFIG_NAME, SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME
from ..utils.log import logger
from ..utils.safetensors_io import SafeFile, save_file, shard_checkpoint
from .configuration_utils import PretrainedConfig
from .conversion_utils import (StackedLayerMapping, auto_name_mappings, flatten_params, tensor_from_numpy,
                               unflatten_params)

__all__ = ["PretrainedModel", "dtype_byte_size"]

_DTYPE_ALIASES = {"float32": torch.float32, "fp32": torch.float32, "bfloat16": torch.bfloat16,
                  "bf16": torch.bfloat16, "float16": torch.float16, "fp16": torch.float16}


def _canonical_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype or a name (``"bfloat16"``, ``"bf16"``,
    ``"torch.float32"``, ``"int8"``); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).removeprefix("torch.")
    found = _DTYPE_ALIASES.get(name, getattr(torch, name, None))
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return found


def dtype_byte_size(dtype) -> int:
    return _canonical_dtype(dtype).itemsize


class PretrainedModel(GenerationMixin):
    config_class: Type[PretrainedConfig] = PretrainedConfig
    base_model_prefix: str = "model"
    main_input_name: str = "input_ids"
    # keys present in checkpoints but not params (or vice versa) to silence warnings
    _keys_to_ignore_on_load_missing: List[str] = []
    _keys_to_ignore_on_load_unexpected: List[str] = []

    def __init__(self, config: PretrainedConfig, params: dict):
        self.config = config
        self.params = params
        #: the default decoding settings of ``generate`` (``generation_config.json``)
        self.generation_config: Optional[GenerationConfig] = None
        #: dtype the training forward computes in (the JAX module's ``dtype``);
        #: None computes in the parameters' dtype
        self.compute_dtype: Optional[torch.dtype] = None

    # ------------------------------------------------------------------ layout
    @staticmethod
    def param_shapes(config) -> Dict[str, Tuple[int, ...]]:
        """Flat ``path -> shape`` of the parameter tree."""
        raise NotImplementedError

    @classmethod
    def _check_config(cls, config):
        """Raise for a configuration the subclass cannot run."""

    @classmethod
    def _get_name_mappings(cls, config, flat_shapes):
        return auto_name_mappings(flat_shapes)

    @classmethod
    def _from_flat(cls, config, flat: Dict[str, torch.Tensor]) -> "PretrainedModel":
        cls._check_config(config)
        shapes = cls.param_shapes(config)
        if set(flat) != set(shapes):
            raise ValueError(f"parameter tree mismatch: missing {sorted(set(shapes) - set(flat))}, "
                             f"unexpected {sorted(set(flat) - set(shapes))}")
        for path, shape in shapes.items():
            if tuple(flat[path].shape) != shape:
                raise ValueError(f"shape mismatch for {path}: got {tuple(flat[path].shape)}, want {shape}")
        return cls(config, unflatten_params(flat))

    @staticmethod
    def _init_leaves(config, shapes: Dict[str, Tuple[int, ...]], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
        """Random leaves drawn on ``device`` from a seeded ``torch.Generator``,
        in ``shapes``' order: norms are ones, every other leaf is
        N(0, initializer_range)."""
        gen = torch.Generator(device=device).manual_seed(seed)
        std = float(getattr(config, "initializer_range", 0.02))
        flat = {}
        for path, shape in shapes.items():
            if path.endswith("/scale"):
                flat[path] = torch.ones(shape, dtype=dtype, device=device)
            else:
                flat[path] = torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)
        return flat

    # ------------------------------------------------------------------ constructors
    @classmethod
    def init_random(cls, config, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> "PretrainedModel":
        """Random weights drawn on ``device`` from ``seed`` (``_init_leaves``)."""
        return cls._from_flat(config, cls._init_leaves(config, cls.param_shapes(config), seed, device, dtype))

    @classmethod
    def from_jax_params(cls, config, params, device="cuda", dtype=None) -> "PretrainedModel":
        """From the JAX package's param tree (numpy leaves or anything
        ``np.asarray`` accepts)."""
        flat = {}
        for path, leaf in flatten_params(params).items():
            t = tensor_from_numpy(leaf)
            flat[path] = t.to(device=device, dtype=dtype or t.dtype)
        return cls._from_flat(config, flat)

    @classmethod
    def from_config(cls, config, *, dtype=torch.float32, param_dtype=torch.float32, seed: int = 0, device="cuda",
                    **kwargs) -> "PretrainedModel":
        """Random weights from ``seed`` in ``param_dtype``, computing in
        ``dtype``; ``kwargs`` update the config first."""
        config.update(kwargs)
        model = cls.init_random(config, seed=seed, device=device, dtype=_canonical_dtype(param_dtype))
        model.compute_dtype = _canonical_dtype(dtype)
        return model

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: Union[str, os.PathLike],
        *,
        config: Optional[PretrainedConfig] = None,
        dtype=None,
        param_dtype=None,
        device="cuda",
        strict: bool = False,
        **kwargs,
    ) -> "PretrainedModel":
        """Resolve a local directory (or the ``MODEL_HOME`` cache), read its
        config and safetensors (HF keys, ``[out, in]`` Linear weights; one
        file, or shards through the index), map the names and place the
        parameters on ``device`` in ``param_dtype``. Missing leaves are
        initialized and logged, unless ``strict``: then a checkpoint that
        lacks any leaf raises ValueError (a resume or a weight swap must not
        go on with random leaves)."""
        model_dir = resolve_model_dir(pretrained_model_name_or_path)
        if config is None:
            config = cls.config_class.from_pretrained(model_dir, **kwargs)
        else:
            config.update(kwargs)
        cls._check_config(config)
        ckpt_dtype = _canonical_dtype(config.dtype) if getattr(config, "dtype", None) else None
        dtype = _canonical_dtype(dtype) or ckpt_dtype or torch.float32
        param_dtype = _canonical_dtype(param_dtype) or ckpt_dtype or torch.float32

        shapes = cls.param_shapes(config)
        mappings = {m.target_name: m for m in cls._get_name_mappings(config, shapes)}
        open_files = [SafeFile(f) for f in _resolve_weight_files(model_dir)]
        try:
            key_to_file = {k: sf for sf in open_files for k in sf.keys()}

            def get_source(key):
                sf = key_to_file.get(key)
                return sf.get_torch(key) if sf is not None else None

            flat: Dict[str, torch.Tensor] = {}
            missing: List[str] = []
            fallback_sources: set = set()
            # in the JAX package's order: its trees flatten by sorted path
            for path, shape in sorted(shapes.items(), key=lambda kv: kv[0].split("/")):
                m = mappings.get(path)
                t = m.apply_stack(get_source) if m is not None else get_source(path)
                if t is None:
                    # second chance via the mechanical mapping: a model whose HF
                    # layout fuses tensors still loads the split auto-derived keys
                    fallback = auto_name_mappings({path: shape})[0]
                    t = fallback.apply_stack(get_source)
                    if t is not None:
                        fallback_sources.update(_source_names(fallback))
                if t is None:
                    missing.append(path)
                    continue
                if tuple(t.shape) != tuple(shape):
                    raise ValueError(f"shape mismatch for {path}: ckpt {tuple(t.shape)} vs model {tuple(shape)}")
                flat[path] = (t.to(param_dtype) if t.is_floating_point() else t).to(device)
            expected_sources = set(fallback_sources)
            for m in mappings.values():
                expected_sources.update(_source_names(m))
            unexpected = [k for k in key_to_file if k not in expected_sources]
        finally:
            for sf in open_files:
                sf.close()
        if missing and strict:
            raise ValueError(f"checkpoint under {model_dir} lacks {missing}")
        if missing:
            missing_fatal = [k for k in missing if not _matches_any(k, cls._keys_to_ignore_on_load_missing)]
            if missing_fatal:
                logger.warning(f"{cls.__name__}: initializing missing params from scratch: {missing_fatal[:8]}"
                               + ("..." if len(missing_fatal) > 8 else ""))
            # init ONLY the missing leaves
            flat.update(cls._init_leaves(config, {k: shapes[k] for k in missing}, 0, device, param_dtype))
        if unexpected:
            unexpected = [k for k in unexpected if not _matches_any(k, cls._keys_to_ignore_on_load_unexpected)]
            if unexpected:
                logger.warning(f"{cls.__name__}: unexpected checkpoint keys ignored: {unexpected[:8]}"
                               + ("..." if len(unexpected) > 8 else ""))
        model = cls._from_flat(config, {k: flat[k] for k in shapes})
        model.compute_dtype = dtype
        _maybe_load_generation_config(model, model_dir)
        return model

    # ------------------------------------------------------------------ saving
    def save_pretrained(self, save_directory: str, max_shard_size: int = 5 * 1024**3, params: Optional[dict] = None):
        """Write ``config.json`` and the HF layout (HF keys, ``[out, in]``
        Linear weights, one key per layer), sharded at ``max_shard_size``
        bytes with an index, in the parameters' dtype (``model_utils.py:285``),
        and the ``generation_config`` when there is one. Keys come in the JAX
        package's order (its trees flatten by sorted path), so both packages
        write the same bytes for the same tree."""
        os.makedirs(save_directory, exist_ok=True)
        params = self.params if params is None else params
        flat = dict(sorted(flatten_params(params).items(), key=lambda kv: kv[0].split("/")))
        self.config.dtype = str(next(iter(flat.values())).dtype).removeprefix("torch.")
        self.config.architectures = [type(self).__name__]
        self.config.save_pretrained(save_directory)
        if self.generation_config is not None:
            self.generation_config.save_pretrained(save_directory)
        tensors: Dict[str, torch.Tensor] = {}
        mappings = {m.target_name: m for m in self._get_name_mappings(self.config,
                                                                      {k: tuple(v.shape) for k, v in flat.items()})}
        with torch.no_grad():
            for path, leaf in flat.items():  # the tree's order, whatever order the family lists its mappings in
                mapping, leaf = mappings[path], leaf.detach().cpu()
                if isinstance(mapping, StackedLayerMapping):
                    tensors.update(mapping.reverse_unstack(leaf))
                else:
                    tensors[mapping.source_name] = mapping.reverse(leaf)
        shards, index = shard_checkpoint(tensors, max_shard_size, SAFE_WEIGHTS_NAME)
        for fname, shard in shards:
            save_file(shard, os.path.join(save_directory, fname), metadata={"format": "np"})
        if index is not None:
            with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
                json.dump(index, f, indent=2)
        logger.info(f"model saved to {save_directory}")

    # ------------------------------------------------------------------ misc
    @property
    def device(self) -> torch.device:
        return next(iter(flatten_params(self.params).values())).device

    @property
    def param_dtype(self) -> torch.dtype:
        """The parameters' storage dtype (the JAX model's ``param_dtype``)."""
        return next(iter(flatten_params(self.params).values())).dtype

    def num_parameters(self, params: Optional[dict] = None) -> int:
        params = self.params if params is None else params
        return int(sum(t.numel() for t in flatten_params(params).values()))

    def get_model_flops(self, batch_size: int, seq_length: int) -> float:
        """Training FLOPs per step ~ 6 * N * tokens (+ attention term)
        (``model_utils.py:315``; a family may override it)."""
        flops = 6.0 * self.num_parameters() * batch_size * seq_length
        cfg = self.config
        if hasattr(cfg, "num_hidden_layers") and hasattr(cfg, "hidden_size"):
            flops += 12.0 * cfg.num_hidden_layers * cfg.hidden_size * (seq_length**2) * batch_size
        return flops

    def get_hardware_flops(self, batch_size: int, seq_length: int) -> float:
        return self.get_model_flops(batch_size, seq_length)


def _source_names(mapping) -> List[str]:
    return mapping.source_names() if isinstance(mapping, StackedLayerMapping) else [mapping.source_name]


def _matches_any(key: str, patterns: List[str]) -> bool:
    return any(re.search(p, key) for p in patterns)


def _resolve_weight_files(model_dir: str) -> List[str]:
    index_path = os.path.join(model_dir, SAFE_WEIGHTS_INDEX_NAME)
    if os.path.isfile(index_path):
        with open(index_path) as f:
            index = json.load(f)
        files = sorted(set(index["weight_map"].values()))
        return [os.path.join(model_dir, f) for f in files]
    single = os.path.join(model_dir, SAFE_WEIGHTS_NAME)
    if os.path.isfile(single):
        return [single]
    # any *.safetensors in dir (HF multi-file without index is unusual but possible)
    cands = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    if cands:
        return [os.path.join(model_dir, f) for f in cands]
    raise FileNotFoundError(f"no safetensors weights found under {model_dir}")


def _maybe_load_generation_config(model: PretrainedModel, model_dir: str):
    path = os.path.join(model_dir, GENERATION_CONFIG_NAME)
    if os.path.isfile(path):
        try:
            model.generation_config = GenerationConfig.from_pretrained(model_dir)
        except (OSError, ValueError, TypeError) as e:
            logger.debug(f"generation config load failed: {e}")
