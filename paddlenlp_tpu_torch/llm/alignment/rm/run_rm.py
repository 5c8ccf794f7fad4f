"""Reward-model training entry point.

Port of ``llm/alignment/rm/run_rm.py`` with the same dataclasses and flags.
Data: the DPO preference rows; the model is the checkpoint's family as a
sequence classifier (``num_labels=1``) trained with the pairwise
Bradley-Terry loss. Launch on the card with

    python -m paddlenlp_tpu_torch.llm.alignment.rm.run_rm rm_argument.json
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

from ....trainer import PdArgumentParser, TrainingArguments
from ....transformers import AutoConfig, AutoModelForSequenceClassification, AutoTokenizer, LlmMetaConfig
from ....trl import RewardTrainer
from ....utils.log import logger
from ..data_utils import ListDataset, load_preference_rows

__all__ = ["ModelArguments", "RMArguments", "main"]


@dataclass
class ModelArguments:
    model_name_or_path: str = "facebook/llama-7b"
    dtype: str = "bfloat16"


@dataclass
class RMArguments:
    dataset_name_or_path: str = "data"
    max_length: int = 1024
    max_prompt_length: int = 512


def main(argv: Optional[List[str]] = None, device="cuda") -> RewardTrainer:
    """Train as ``argv`` (a JSON file or CLI flags) says; returns the trainer."""
    parser = PdArgumentParser((ModelArguments, RMArguments, TrainingArguments))
    model_args, rm_args, training_args = parser.parse_args_into_dataclasses(argv)

    tokenizer = AutoTokenizer.from_pretrained(model_args.model_name_or_path)
    config = AutoConfig.from_pretrained(model_args.model_name_or_path)
    config.num_labels = 1
    LlmMetaConfig.set_llm_config(config, training_args)
    model = AutoModelForSequenceClassification.from_pretrained(model_args.model_name_or_path, config=config,
                                                               dtype=model_args.dtype, param_dtype="float32",
                                                               device=device)
    rows = load_preference_rows(os.path.join(rm_args.dataset_name_or_path, "train.json"), tokenizer,
                                rm_args.max_length, rm_args.max_prompt_length, mode="rm")
    trainer = RewardTrainer(model=model, args=training_args, train_dataset=ListDataset(rows), tokenizer=tokenizer)
    if training_args.do_train:
        result = trainer.train(resume_from_checkpoint=training_args.resume_from_checkpoint)
        trainer.save_model()
        logger.info(f"rm done: {result.metrics}")
    return trainer


if __name__ == "__main__":
    main()
