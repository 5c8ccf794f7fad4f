"""Model configuration.

PyTorch port of ``paddlenlp_tpu/transformers/configuration_utils.py``:
``PretrainedConfig`` with ``attribute_map`` legacy-key translation, built from a
dict or a local ``config.json`` (a directory, a file, or a name under the
``MODEL_HOME`` cache: ``utils/downloader.py``), and the trainer-arg bridge
``LlmMetaConfig``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, Tuple

from ..utils.downloader import resolve_file
from ..utils.env import CONFIG_NAME
from ..utils.log import logger

__all__ = ["PretrainedConfig", "LlmMetaConfig", "attribute_map", "CONFIG_NAME"]


def attribute_map(config: "PretrainedConfig", kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Rewrite legacy kwarg keys to standard ones (reference: configuration_utils.py:96)."""
    for old, new in config.attribute_map.items():
        if old in kwargs:
            if new in kwargs:
                raise ValueError(f"can't set both `{old}` (legacy) and `{new}`")
            kwargs[new] = kwargs.pop(old)
    return kwargs


class PretrainedConfig:
    model_type: str = ""
    attribute_map: Dict[str, str] = {}

    def __init__(self, **kwargs):
        kwargs = attribute_map(self, kwargs)
        # common, model-agnostic fields
        self.return_dict = kwargs.pop("return_dict", True)
        self.output_hidden_states = kwargs.pop("output_hidden_states", False)
        self.output_attentions = kwargs.pop("output_attentions", False)
        self.use_cache = kwargs.pop("use_cache", False)
        self.dtype = kwargs.pop("dtype", kwargs.pop("torch_dtype", None))
        self.tie_word_embeddings = kwargs.pop("tie_word_embeddings", False)
        self.pad_token_id = kwargs.pop("pad_token_id", None)
        self.bos_token_id = kwargs.pop("bos_token_id", None)
        self.eos_token_id = kwargs.pop("eos_token_id", None)
        self.sep_token_id = kwargs.pop("sep_token_id", None)
        self.cls_token_id = kwargs.pop("cls_token_id", None)
        self.mask_token_id = kwargs.pop("mask_token_id", None)
        self.unk_token_id = kwargs.pop("unk_token_id", None)
        id2label = kwargs.get("id2label")
        self.num_labels = kwargs.pop("num_labels", len(id2label) if id2label else 2)
        self.classifier_dropout = kwargs.pop("classifier_dropout", None)
        self.is_encoder_decoder = kwargs.pop("is_encoder_decoder", False)
        self.is_decoder = kwargs.pop("is_decoder", False)
        self.architectures = kwargs.pop("architectures", None)
        # runtime / parallel flags set by the trainer (defaults here so model
        # code can read them unconditionally)
        self.tensor_parallel_degree = kwargs.pop("tensor_parallel_degree", 1)
        self.sep_parallel_degree = kwargs.pop("sep_parallel_degree", 1)
        self.context_parallel_degree = kwargs.pop("context_parallel_degree", 1)
        self.pipeline_parallel_degree = kwargs.pop("pipeline_parallel_degree", 1)
        self.sequence_parallel = kwargs.pop("sequence_parallel", False)
        self.tensor_parallel_output = kwargs.pop("tensor_parallel_output", True)
        self.use_flash_attention = kwargs.pop("use_flash_attention", True)
        self.recompute = kwargs.pop("recompute", False)
        self.recompute_granularity = kwargs.pop("recompute_granularity", "full")
        self.no_recompute_layers = kwargs.pop("no_recompute_layers", [])
        self.use_scan_layers = kwargs.pop("use_scan_layers", True)
        for key, value in kwargs.items():
            try:
                setattr(self, key, value)
            except AttributeError as err:
                logger.error(f"can't set {key} = {value} on {self.__class__.__name__}")
                raise err

    # --- attribute_map passthrough on attribute access ------------------------------
    def __setattr__(self, key, value):
        if key != "attribute_map" and key in super().__getattribute__("attribute_map"):
            key = self.attribute_map[key]
        super().__setattr__(key, value)

    def __getattr__(self, key):
        # only called when normal lookup fails
        if key != "attribute_map":
            amap = self.__class__.attribute_map
            if key in amap:
                return getattr(self, amap[key])
        raise AttributeError(f"{self.__class__.__name__} has no attribute {key!r}")

    # --- serialization --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out = copy.deepcopy(self.__dict__)
        out["model_type"] = self.model_type
        return out

    def to_json_string(self) -> str:
        d = self.to_dict()
        return json.dumps({k: v for k, v in sorted(d.items()) if not k.startswith("_")}, indent=2, default=str) + "\n"

    def save_pretrained(self, save_directory: str):
        os.makedirs(save_directory, exist_ok=True)
        with open(os.path.join(save_directory, CONFIG_NAME), "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any], **kwargs) -> "PretrainedConfig":
        config_dict = dict(config_dict)
        config_dict.pop("model_type", None)
        config_dict.update(kwargs)
        return cls(**config_dict)

    @classmethod
    def get_config_dict(cls, pretrained_model_name_or_path, **kwargs) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Read ``config.json`` from a local directory, the file itself, or
        the ``MODEL_HOME`` cache."""
        path = resolve_file(pretrained_model_name_or_path, CONFIG_NAME)
        with open(path) as f:
            return json.load(f), kwargs

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> "PretrainedConfig":
        config_dict, kwargs = cls.get_config_dict(pretrained_model_name_or_path, **kwargs)
        if cls.model_type and config_dict.get("model_type") and config_dict["model_type"] != cls.model_type:
            logger.warning(
                f"loading a {config_dict['model_type']} config into {cls.__name__} (model_type={cls.model_type})"
            )
        return cls.from_dict(config_dict, **kwargs)

    def update(self, mapping: Dict[str, Any]):
        for k, v in mapping.items():
            setattr(self, k, v)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __eq__(self, other):
        return isinstance(other, PretrainedConfig) and self.to_dict() == other.to_dict()

    def __repr__(self):
        return f"{self.__class__.__name__} {self.to_json_string()}"


@dataclasses.dataclass
class _MetaAttr:
    name: str
    dtype: type
    default: Any
    doc: str


class LlmMetaConfig:
    """Trainer-arg -> model-config bridge (a copy of the JAX package's
    ``configuration_utils.py:153``): ``set_llm_config`` copies each declared
    attr from a ``TrainingArguments`` onto a ``PretrainedConfig``."""

    attrs = [
        _MetaAttr("tensor_parallel_degree", int, 1, "tp mesh axis degree"),
        _MetaAttr("sep_parallel_degree", int, 1, "ulysses segment-parallel degree"),
        _MetaAttr("context_parallel_degree", int, 1, "ring-attention context-parallel degree"),
        _MetaAttr("pipeline_parallel_degree", int, 1, "pipeline stages"),
        _MetaAttr("sequence_parallel", bool, False, "megatron sequence parallel inside tp group"),
        _MetaAttr("tensor_parallel_output", bool, True, "keep logits tp-sharded for fused loss"),
        _MetaAttr("use_flash_attention", bool, True, "use fused flash attention"),
        _MetaAttr("recompute", bool, False, "activation rematerialization"),
        _MetaAttr("recompute_granularity", str, "full",
                  "full|full_attn|core_attn|save_core_attn|save_qkv_attn|save_attn_mlp|save_dots|offload_attn"),
        _MetaAttr("no_recompute_layers", list, None, "layer indices excluded from remat"),
        _MetaAttr("use_scan_layers", bool, True, "stacked [L] decoder params"),
    ]

    @classmethod
    def set_llm_config(cls, config: PretrainedConfig, args) -> None:
        for attr in cls.attrs:
            value = getattr(args, attr.name, attr.default)
            if value is None:
                value = attr.default
            setattr(config, attr.name, value)
