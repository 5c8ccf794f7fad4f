"""DPO alignment entry point.

Port of ``llm/alignment/dpo/run_dpo.py`` with the same dataclasses and
flags. Data: jsonl rows ``{"src": prompt, "chosen": ..., "rejected": ...}``
under ``dataset_name_or_path`` (``train.json``, optionally ``dev.json``).
Launch on the card with

    python -m paddlenlp_tpu_torch.llm.alignment.dpo.run_dpo dpo_argument.json
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

from ....trainer import PdArgumentParser, TrainingArguments
from ....transformers import AutoConfig, AutoModelForCausalLM, AutoTokenizer, LlmMetaConfig
from ....trl import DPOCriterion, DPOTrainer
from ....utils.log import logger
from ..data_utils import ListDataset, load_preference_rows

__all__ = ["DPOArguments", "ModelArguments", "main"]


@dataclass
class ModelArguments:
    model_name_or_path: str = "facebook/llama-7b"
    ref_model_name_or_path: Optional[str] = None
    dtype: str = "bfloat16"


@dataclass
class DPOArguments:
    dataset_name_or_path: str = "data"
    max_length: int = 1024
    max_prompt_length: int = 512
    beta: float = 0.1
    loss_type: str = "sigmoid"
    label_smoothing: float = 0.0
    simpo_gamma: float = 0.5
    sft_loss_ratio: float = 0.0


def main(argv: Optional[List[str]] = None, device="cuda") -> DPOTrainer:
    """Train as ``argv`` (a JSON file or CLI flags) says; returns the trainer."""
    parser = PdArgumentParser((ModelArguments, DPOArguments, TrainingArguments))
    model_args, dpo_args, training_args = parser.parse_args_into_dataclasses(argv)

    tokenizer = AutoTokenizer.from_pretrained(model_args.model_name_or_path)
    config = AutoConfig.from_pretrained(model_args.model_name_or_path)
    LlmMetaConfig.set_llm_config(config, training_args)
    model = AutoModelForCausalLM.from_pretrained(model_args.model_name_or_path, config=config,
                                                 dtype=model_args.dtype, param_dtype="float32", device=device)
    ref_model = None
    if model_args.ref_model_name_or_path:
        ref_model = AutoModelForCausalLM.from_pretrained(model_args.ref_model_name_or_path, dtype=model_args.dtype,
                                                         param_dtype="float32", device=device)

    rows = load_preference_rows(os.path.join(dpo_args.dataset_name_or_path, "train.json"), tokenizer,
                                dpo_args.max_length, dpo_args.max_prompt_length, mode="dpo")
    eval_dataset = None
    dev_path = os.path.join(dpo_args.dataset_name_or_path, "dev.json")
    if os.path.isfile(dev_path):
        eval_dataset = ListDataset(load_preference_rows(dev_path, tokenizer, dpo_args.max_length,
                                                        dpo_args.max_prompt_length, mode="dpo"))
    elif training_args.do_eval or training_args.evaluation_strategy != "no":
        logger.warning(f"no dev.json under {dpo_args.dataset_name_or_path}; disabling evaluation")
        training_args.do_eval = False
        training_args.evaluation_strategy = "no"
    criterion = DPOCriterion(beta=dpo_args.beta, loss_type=dpo_args.loss_type,
                             label_smoothing=dpo_args.label_smoothing, simpo_gamma=dpo_args.simpo_gamma,
                             sft_loss_ratio=dpo_args.sft_loss_ratio)
    trainer = DPOTrainer(model=model, ref_model=ref_model, dpo_criterion=criterion, args=training_args,
                         train_dataset=ListDataset(rows), eval_dataset=eval_dataset, tokenizer=tokenizer)
    if training_args.do_train:
        result = trainer.train(resume_from_checkpoint=training_args.resume_from_checkpoint)
        trainer.save_model()
        logger.info(f"dpo done: {result.metrics}")
    return trainer


if __name__ == "__main__":
    main()
