"""Auto model classes (reference: paddlenlp/transformers/auto/modeling.py).

Port of ``paddlenlp_tpu/transformers/auto/modeling.py:25-295``. The port
registers the tasks its families have: ``causal_lm`` and
``sequence_classification`` for ``llama`` and ``qwen2``
(``AutoModelForCausalLM``, ``AutoModelForSequenceClassification``), the
tasks the JAX registry gives ``mistral`` and ``deepseek_v2`` (``base``, the
backbone behind ``AutoModel``, and ``causal_lm``) and ``causal_lm`` for
``mixtral`` and ``qwen2_moe``. ``JAX_MODEL_TASKS`` is the JAX
registry's tasks by ``model_type``: a family or task it has and the port does
not (the backbone-only ``base`` models behind ``AutoModel``, the classifiers,
every other family) raises ``NotImplementedError`` naming ROADMAP Queue 1
item 14e; one neither registry has raises the JAX package's ``ValueError``.
``AutoModelForCausalLMPipe`` is the JAX package's pipeline-parallel alias: it
raises naming items 15 and 12b.

``from_pretrained`` and ``from_config`` take the JAX keywords: ``dtype`` is
the compute dtype and ``param_dtype`` the storage dtype of the parameters;
``device`` (default ``"cuda"``) is the port's own.
"""

from __future__ import annotations

from typing import Dict

from .configuration import AutoConfig, _populate, FAMILIES_LEFT

__all__ = [
    "AutoModel",
    "AutoModelForCausalLM",
    "AutoModelForSequenceClassification",
    "AutoModelForTokenClassification",
    "AutoModelForMaskedLM",
    "AutoModelForSeq2SeqLM",
    "AutoModelForConditionalGeneration",
    "AutoModelForCausalLMPipe",
    "JAX_MODEL_TASKS",
]

_MODEL_MAPPING: Dict[str, Dict[str, type]] = {}

_BERT_TASKS = ("base", "masked_lm", "sequence_classification", "token_classification")
_DECODER_TASKS = ("base", "causal_lm")
_SEQ2SEQ_TASKS = ("base", "seq2seq_lm")

#: the tasks the JAX package's registry has for each model_type
JAX_MODEL_TASKS = {
    "llama": ("base", "causal_lm", "sequence_classification"), "gpt": _DECODER_TASKS, "gpt2": _DECODER_TASKS,
    "chatglm_v2": _DECODER_TASKS, "baichuan": _DECODER_TASKS, "bloom": _DECODER_TASKS, "opt": _DECODER_TASKS,
    "qwen": _DECODER_TASKS, "qwen2": ("base", "causal_lm", "sequence_classification"), "mistral": _DECODER_TASKS,
    "gemma": _DECODER_TASKS, "bert": _BERT_TASKS, "ernie": _BERT_TASKS, "roberta": _BERT_TASKS,
    "electra": ("base", "sequence_classification", "token_classification"), "albert": _BERT_TASKS,
    "mixtral": ("causal_lm",), "qwen2_moe": ("causal_lm",), "deepseek_v2": _DECODER_TASKS, "mamba": _DECODER_TASKS,
    "rw": _DECODER_TASKS, "falcon": _DECODER_TASKS, "chatglm": _DECODER_TASKS, "yuan": _DECODER_TASKS,
    "jamba": _DECODER_TASKS, "t5": _SEQ2SEQ_TASKS, "bart": _SEQ2SEQ_TASKS, "mt5": _SEQ2SEQ_TASKS,
    "mbart": _SEQ2SEQ_TASKS, "pegasus": _SEQ2SEQ_TASKS, "clip": ("base",), "chinese_clip": ("base",),
    "blip": ("base",), "ernie_vil": ("base",), "minigpt4": ("base",),
    "distilbert": ("base", "masked_lm", "sequence_classification"), "nezha": _BERT_TASKS,
    "mpnet": ("base", "masked_lm", "sequence_classification"), "gptj": _DECODER_TASKS, "codegen": _DECODER_TASKS,
    "roformer": ("base", "masked_lm", "sequence_classification"), "tinybert": ("base", "sequence_classification"),
    "ppminilm": ("base", "sequence_classification"), "fnet": ("base", "masked_lm", "sequence_classification"),
    "squeezebert": ("base", "masked_lm", "sequence_classification"),
    "rembert": ("base", "masked_lm", "sequence_classification"),
    "layoutlm": ("base", "masked_lm", "token_classification"),
    "megatron-bert": ("base", "masked_lm", "sequence_classification"),
    "ernie_m": ("base", "sequence_classification", "token_classification"), "deberta-v2": _BERT_TASKS,
}


def register_model(model_type: str, task: str, model_class: type):
    _MODEL_MAPPING.setdefault(model_type, {})[task] = model_class


def _populate_models():
    if _MODEL_MAPPING:
        return
    _populate()
    from ..deepseek_v2 import modeling as deepseek_v2
    from ..llama import modeling as llama
    from ..mistral import modeling as mistral
    from ..mixtral import modeling as mixtral
    from ..qwen2 import modeling as qwen2
    from ..qwen2_moe import modeling as qwen2_moe

    register_model("llama", "causal_lm", llama.LlamaForCausalLM)
    register_model("qwen2", "causal_lm", qwen2.Qwen2ForCausalLM)
    register_model("llama", "sequence_classification", llama.LlamaForSequenceClassification)
    register_model("qwen2", "sequence_classification", qwen2.Qwen2ForSequenceClassification)
    register_model("mistral", "base", mistral.MistralModel)
    register_model("mistral", "causal_lm", mistral.MistralForCausalLM)
    register_model("mixtral", "causal_lm", mixtral.MixtralForCausalLM)
    register_model("qwen2_moe", "causal_lm", qwen2_moe.Qwen2MoeForCausalLM)
    register_model("deepseek_v2", "base", deepseek_v2.DeepseekV2Model)
    register_model("deepseek_v2", "causal_lm", deepseek_v2.DeepseekV2ForCausalLM)


class _AutoBase:
    task = "base"

    @classmethod
    def _model_class(cls, model_type):
        _populate_models()
        task_map = _MODEL_MAPPING.get(model_type)
        if task_map and cls.task in task_map:
            return task_map[cls.task]
        if cls.task in JAX_MODEL_TASKS.get(model_type, ()):
            have = sorted(f"{mt}/{t}" for mt, tasks in _MODEL_MAPPING.items() for t in tasks)
            raise NotImplementedError(f"the {cls.task} model of model_type={model_type!r} is not part of the port "
                                      f"yet ({FAMILIES_LEFT}); the port has {have}")
        raise ValueError(f"no {cls.task} model registered for model_type={model_type!r}")

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, config=None, **kwargs):
        if config is None:
            config = AutoConfig.from_pretrained(pretrained_model_name_or_path)
        model_class = cls._model_class(config.model_type)
        return model_class.from_pretrained(pretrained_model_name_or_path, config=config, **kwargs)

    @classmethod
    def from_config(cls, config, **kwargs):
        return cls._model_class(config.model_type).from_config(config, **kwargs)


class AutoModel(_AutoBase):
    task = "base"


class AutoModelForCausalLM(_AutoBase):
    task = "causal_lm"


class AutoModelForSequenceClassification(_AutoBase):
    task = "sequence_classification"


class AutoModelForTokenClassification(_AutoBase):
    task = "token_classification"


class AutoModelForMaskedLM(_AutoBase):
    task = "masked_lm"


class AutoModelForSeq2SeqLM(_AutoBase):
    task = "seq2seq_lm"


class AutoModelForConditionalGeneration(_AutoBase):
    task = "seq2seq_lm"


class AutoModelForCausalLMPipe:
    """The JAX package's alias of ``AutoModelForCausalLM`` for pipeline runs:
    the port has no pipeline or mesh axis yet."""

    @classmethod
    def _refuse(cls):
        raise NotImplementedError("AutoModelForCausalLMPipe: pipeline parallelism is not part of the port yet "
                                  "(ROADMAP Queue 1 items 15 and 12b); use AutoModelForCausalLM on one card")

    @classmethod
    def from_pretrained(cls, *args, **kwargs):
        cls._refuse()

    @classmethod
    def from_config(cls, *args, **kwargs):
        cls._refuse()
