"""AutoConfig (reference: paddlenlp/transformers/auto/configuration.py).

Port of ``paddlenlp_tpu/transformers/auto/configuration.py:14-104``.
``CONFIG_MAPPING`` holds the families the port has (``llama``, ``qwen2``,
``mistral``, ``mixtral``, ``qwen2_moe``, ``deepseek_v2``).
``JAX_MODEL_TYPES`` is the JAX registry's ``model_type`` list, in its order:
a ``config.json`` of one of the other types raises ``NotImplementedError``
naming ROADMAP Queue 1 item 14e, and a type that neither registry knows
raises the JAX package's ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Type

from ..configuration_utils import PretrainedConfig

__all__ = ["AutoConfig", "CONFIG_MAPPING", "JAX_MODEL_TYPES", "register_config"]

CONFIG_MAPPING: Dict[str, Type[PretrainedConfig]] = {}

#: every model_type the JAX package's AutoConfig registers, in its order
JAX_MODEL_TYPES = (
    "llama", "gpt", "qwen2", "mistral", "gemma", "bert", "ernie", "mixtral", "qwen2_moe", "baichuan", "bloom", "opt",
    "qwen", "chatglm_v2", "t5", "bart", "deepseek_v2", "mamba", "rw", "chatglm", "yuan", "jamba", "albert", "electra",
    "roberta", "mt5", "mbart", "pegasus", "clip", "chinese_clip", "blip", "ernie_vil", "distilbert", "nezha", "mpnet",
    "deberta-v2", "gptj", "codegen", "roformer", "tinybert", "ppminilm", "minigpt4", "fnet", "ernie_m",
    "megatron-bert", "layoutlm", "rembert", "squeezebert", "gpt2",
)

FAMILIES_LEFT = "ROADMAP Queue 1 item 14e"


def register_config(model_type: str, config_class: Type[PretrainedConfig]):
    CONFIG_MAPPING[model_type] = config_class


def _populate():
    if CONFIG_MAPPING:
        return
    from ..deepseek_v2.configuration import DeepseekV2Config
    from ..llama.configuration import LlamaConfig
    from ..mistral.configuration import MistralConfig
    from ..mixtral.configuration import MixtralConfig
    from ..qwen2.configuration import Qwen2Config
    from ..qwen2_moe.configuration import Qwen2MoeConfig

    for cfg in (LlamaConfig, Qwen2Config, MistralConfig, MixtralConfig, Qwen2MoeConfig, DeepseekV2Config):
        register_config(cfg.model_type, cfg)


def not_ported(model_type: str) -> NotImplementedError:
    return NotImplementedError(f"model_type {model_type!r} is not part of the port yet ({FAMILIES_LEFT}); "
                               f"the port has {sorted(CONFIG_MAPPING)}")


class AutoConfig:
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> PretrainedConfig:
        _populate()
        config_dict, kwargs = PretrainedConfig.get_config_dict(pretrained_model_name_or_path, **kwargs)
        model_type = config_dict.get("model_type")
        if model_type in CONFIG_MAPPING:
            return CONFIG_MAPPING[model_type].from_dict(config_dict, **kwargs)
        if model_type in JAX_MODEL_TYPES:
            raise not_ported(model_type)
        # fall back: architectures hint, over the JAX registry's order
        for arch in config_dict.get("architectures") or []:
            for mt in dict.fromkeys(JAX_MODEL_TYPES + tuple(CONFIG_MAPPING)):
                if arch.lower().startswith(mt.replace("_", "")):
                    if mt not in CONFIG_MAPPING:
                        raise not_ported(mt)
                    return CONFIG_MAPPING[mt].from_dict(config_dict, **kwargs)
        known = sorted(set(JAX_MODEL_TYPES) | set(CONFIG_MAPPING))
        raise ValueError(f"unrecognized model_type {model_type!r}; known: {known}")

    @staticmethod
    def register(model_type: str, config_class):
        register_config(model_type, config_class)
