"""Causal-LM pretraining entry point.

Port of ``llm/run_pretrain.py``: JSON/CLI config -> model config ->
``LlmMetaConfig`` bridge -> model -> mmap GPT dataset -> ``Trainer`` (unified
checkpoints at ``save_steps``) -> ``save_model``. ``resume_from_checkpoint``
(a checkpoint directory, or ``true`` for the newest committed one under
``output_dir``; without it, the newest ``checkpoint-*`` under ``output_dir``
unless ``overwrite_output_dir``) resumes the run (JAX :118-122). Launch on
the card with

    python -m paddlenlp_tpu_torch.llm.run_pretrain args.json

``model_name_or_path`` is a local directory (or a name under the
``MODEL_HOME`` cache) holding a ``config.json``, read through ``AutoConfig``
(there is no hub download); ``from_scratch`` draws random weights from
``seed`` (``AutoModelForCausalLM.from_config``), otherwise the directory's
safetensors are loaded (``from_pretrained``). The weights are fp32 masters;
``dtype`` is the compute dtype. A tokenizer is loaded whenever
``tokenizer_name_or_path`` names one or the run is not from scratch (JAX
:84-87), and ``save_model`` writes it beside the weights; the corpus itself
is already tokenized (``llm/tools/preprocess_data.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..data import build_train_valid_test_datasets
from ..trainer import PdArgumentParser, Trainer, TrainingArguments, get_last_checkpoint
from ..transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer, LlmMetaConfig
from ..utils.log import logger

__all__ = ["DataArguments", "ModelArguments", "PreTrainingArguments", "main"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class ModelArguments:
    model_name_or_path: str = field(default="__internal_testing__/tiny-random-llama")
    tokenizer_name_or_path: Optional[str] = None
    dtype: str = "bfloat16"
    from_scratch: bool = field(default=True, metadata={"help": "init weights instead of loading"})
    num_hidden_layers: Optional[int] = None
    vocab_size: Optional[int] = None


@dataclass
class DataArguments:
    input_dir: str = field(default="data", metadata={"help": "dir or prefix of .bin/.idx corpus"})
    data_prefix: Optional[List[str]] = field(default=None, metadata={"help": "[w1, prefix1, w2, prefix2...]"})
    split: str = "949,50,1"
    max_seq_length: int = 2048
    data_cache_dir: Optional[str] = None


@dataclass
class PreTrainingArguments(TrainingArguments):
    min_learning_rate: float = 1e-5
    decay_steps: int = 0


def create_pretrained_dataset(data_args: DataArguments, training_args: TrainingArguments):
    """reference run_pretrain.py:193."""
    train_samples = training_args.max_steps * training_args.global_train_batch_size
    eval_steps = max(training_args.eval_steps, 1)
    eval_samples = (
        (training_args.max_steps // eval_steps + 1) * training_args.global_eval_batch_size
        if training_args.evaluation_strategy != "no"
        else training_args.global_eval_batch_size
    )
    prefix = data_args.data_prefix or _resolve_prefix(data_args.input_dir)
    return build_train_valid_test_datasets(
        prefix,
        seq_length=data_args.max_seq_length,
        train_valid_test_num_samples=(train_samples, eval_samples, 0),
        splits_string=data_args.split,
        seed=training_args.seed,
        cache_dir=data_args.data_cache_dir,
    )


def _resolve_prefix(input_dir: str) -> str:
    if os.path.isfile(input_dir + ".bin"):
        return input_dir
    if os.path.isdir(input_dir):
        bins = [f[:-4] for f in os.listdir(input_dir) if f.endswith(".bin")]
        if len(bins) == 1:
            return os.path.join(input_dir, bins[0])
        if bins:
            raise ValueError(f"multiple corpora in {input_dir}; pass data_prefix with weights")
    raise FileNotFoundError(f"no .bin/.idx corpus found at {input_dir}")


def main(argv: Optional[List[str]] = None, device="cuda", callbacks: Optional[list] = None) -> Trainer:
    """Train as ``argv`` (a JSON file or CLI flags) says; returns the trainer.
    ``callbacks`` are added to the trainer's."""
    parser = PdArgumentParser((ModelArguments, DataArguments, PreTrainingArguments))
    model_args, data_args, training_args = parser.parse_args_into_dataclasses(argv)
    if model_args.dtype not in _DTYPES:
        raise ValueError(f"dtype {model_args.dtype!r} not in {list(_DTYPES)}")

    tokenizer = None
    if model_args.tokenizer_name_or_path or not model_args.from_scratch:
        tokenizer = AutoTokenizer.from_pretrained(model_args.tokenizer_name_or_path or model_args.model_name_or_path)

    config = AutoConfig.from_pretrained(model_args.model_name_or_path)
    LlmMetaConfig.set_llm_config(config, training_args)
    if model_args.num_hidden_layers is not None:
        config.num_hidden_layers = model_args.num_hidden_layers
    if model_args.vocab_size is not None:
        config.vocab_size = model_args.vocab_size
    config.use_cache = False

    if model_args.from_scratch:
        model = AutoModelForCausalLM.from_config(config, dtype=model_args.dtype, param_dtype="float32",
                                                 seed=training_args.seed, device=device)
    else:
        model = AutoModelForCausalLM.from_pretrained(model_args.model_name_or_path, config=config,
                                                     dtype=model_args.dtype, param_dtype="float32", device=device)
    logger.info(f"model: {type(model).__name__} ({model.num_parameters():,} params) on {model.device}")

    train_ds, valid_ds, _ = create_pretrained_dataset(data_args, training_args)
    trainer = Trainer(model=model, args=training_args, train_dataset=train_ds, eval_dataset=valid_ds,
                      tokenizer=tokenizer, callbacks=callbacks)
    checkpoint = training_args.resume_from_checkpoint
    if checkpoint is None and not training_args.overwrite_output_dir:
        checkpoint = get_last_checkpoint(training_args.output_dir)
    if training_args.do_train:
        result = trainer.train(resume_from_checkpoint=checkpoint)
        trainer.save_model()
        logger.info(f"training done: {result.metrics}")
    if training_args.do_eval:
        logger.info(f"eval: {trainer.evaluate()}")
    return trainer


if __name__ == "__main__":
    main()
