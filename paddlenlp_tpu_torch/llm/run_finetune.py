"""Supervised fine-tuning (SFT) entry point.

Port of ``llm/run_finetune.py``: chat-template or ``src``/``tgt``
tokenization with the prompt masked out of the loss, ZeroPadding packing
(``datasets.ZeroPaddingMapDataset``: its ``segment_ids`` and per-segment
``position_ids`` go to the flash kernels, which mask attention to each
segment) or padded batches (``DataCollatorForSeq2Seq``, whose
``attention_mask`` takes the dense attention path), then the ``Trainer`` and
``save_model``. Launch on the card with

    python -m paddlenlp_tpu_torch.llm.run_finetune sft_argument.json

``model_name_or_path`` is a local directory (or a name under the
``MODEL_HOME`` cache) with the config, the safetensors and the tokenizer,
loaded through ``AutoConfig``, ``AutoModelForCausalLM`` (fp32 master
weights, ``dtype`` the compute dtype) and ``AutoTokenizer``. ``lora``
wraps the model in ``peft.LoRAModel`` (``lora_rank``, ``lora_alpha``,
``lora_target_modules``, ``rslora``) and ``prefix_tuning`` in
``peft.PrefixModelForCausalLM`` (``num_prefix_tokens``): the trainer then
trains the adapters or the prefix alone, and ``save_model`` writes only
them. ``lora`` wins when both are set, as in the JAX package.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..data import DataCollatorForSeq2Seq
from ..datasets import ZeroPaddingMapDataset
from ..trainer import PdArgumentParser, Trainer, TrainingArguments
from ..transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer, LlmMetaConfig
from ..utils.log import logger

__all__ = ["DataArguments", "ListDataset", "ModelArguments", "load_sft_dataset", "main"]


@dataclass
class ModelArguments:
    model_name_or_path: str = "facebook/llama-7b"
    dtype: str = "bfloat16"
    # PEFT (reference run_finetune.py:437; peft/lora/lora_config.py)
    lora: bool = False
    lora_rank: int = 8
    lora_alpha: int = 16
    lora_dropout: float = 0.0
    lora_target_modules: Optional[List[str]] = None
    rslora: bool = False
    prefix_tuning: bool = False
    num_prefix_tokens: int = 64


@dataclass
class DataArguments:
    dataset_name_or_path: str = field(default="data", metadata={"help": "dir with train.json/dev.json (jsonl)"})
    max_length: int = 2048
    src_length: int = 1024
    zero_padding: bool = True
    eval_with_do_generation: bool = False


def load_sft_dataset(path: str, tokenizer, data_args: DataArguments):
    """jsonl rows {src,tgt} or {messages:[...]} -> token dicts with masked prompts
    (reference llm/utils/data.py tokenization)."""
    examples = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "messages" in row:
                text = tokenizer.apply_chat_template(row["messages"], add_generation_prompt=False)
                ids = tokenizer.encode(text)[: data_args.max_length]
                labels = list(ids)
            else:
                src = tokenizer.encode(str(row.get("src", row.get("instruction", ""))))[: data_args.src_length]
                tgt = tokenizer.encode(str(row.get("tgt", row.get("output", ""))))
                eos = tokenizer.eos_token_id
                tgt = (tgt + ([eos] if eos is not None else []))[: data_args.max_length - len(src)]
                ids = src + tgt
                labels = [-100] * len(src) + list(tgt)  # prompt tokens excluded from loss
            examples.append({
                "input_ids": np.asarray(ids, dtype=np.int32),
                "labels": np.asarray(labels, dtype=np.int32),
            })
    return examples


class ListDataset:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def main(argv: Optional[List[str]] = None, device="cuda", callbacks: Optional[list] = None) -> Trainer:
    """Fine-tune as ``argv`` (a JSON file or CLI flags) says; returns the
    trainer. ``callbacks`` are added to the trainer's."""
    parser = PdArgumentParser((ModelArguments, DataArguments, TrainingArguments))
    model_args, data_args, training_args = parser.parse_args_into_dataclasses(argv)

    tokenizer = AutoTokenizer.from_pretrained(model_args.model_name_or_path)
    config = AutoConfig.from_pretrained(model_args.model_name_or_path)
    LlmMetaConfig.set_llm_config(config, training_args)
    model = AutoModelForCausalLM.from_pretrained(
        model_args.model_name_or_path, config=config, dtype=model_args.dtype, param_dtype="float32", device=device
    )
    if model_args.lora:
        from ..peft import LoRAConfig, LoRAModel

        lora_config = LoRAConfig(r=model_args.lora_rank, lora_alpha=model_args.lora_alpha,
                                 lora_dropout=model_args.lora_dropout, target_modules=model_args.lora_target_modules,
                                 rslora=model_args.rslora)
        model = LoRAModel(model, lora_config)
        model.mark_only_lora_as_trainable()
        model.print_trainable_parameters()
    elif model_args.prefix_tuning:
        from ..peft import PrefixConfig, PrefixModelForCausalLM

        model = PrefixModelForCausalLM(model, PrefixConfig(num_prefix_tokens=model_args.num_prefix_tokens))

    train_rows = load_sft_dataset(os.path.join(data_args.dataset_name_or_path, "train.json"), tokenizer, data_args)
    dev_path = os.path.join(data_args.dataset_name_or_path, "dev.json")
    eval_rows = load_sft_dataset(dev_path, tokenizer, data_args) if os.path.isfile(dev_path) else None

    if data_args.zero_padding:
        train_ds = ZeroPaddingMapDataset(ListDataset(train_rows), tokenizer, data_args.max_length)
        eval_ds = ZeroPaddingMapDataset(ListDataset(eval_rows), tokenizer, data_args.max_length) if eval_rows else None
        collator = None  # packed rows are already fixed-length
    else:
        train_ds, eval_ds = ListDataset(train_rows), ListDataset(eval_rows) if eval_rows else None
        collator = DataCollatorForSeq2Seq(tokenizer, pad_to_multiple_of=8)

    trainer = Trainer(
        model=model,
        args=training_args,
        train_dataset=train_ds,
        eval_dataset=eval_ds,
        tokenizer=tokenizer,
        data_collator=collator,
        callbacks=callbacks,
    )
    if training_args.do_train:
        result = trainer.train(resume_from_checkpoint=training_args.resume_from_checkpoint)
        trainer.save_model()
        logger.info(f"finetune done: {result.metrics}")
    if training_args.do_eval and eval_ds is not None:
        logger.info(f"eval: {trainer.evaluate()}")
    return trainer


if __name__ == "__main__":
    main()
