"""PPO alignment entry point.

Port of ``llm/alignment/ppo/run_ppo.py`` with the same dataclasses and
flags. Data: jsonl rows ``{"src": prompt}``; the reward comes from a trained
reward-model checkpoint (``run_rm``), and ``use_value_model`` trains a value
model from the policy's trunk. Launch on the card with

    python -m paddlenlp_tpu_torch.llm.alignment.ppo.run_ppo ppo_argument.json
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ....trainer import PdArgumentParser, TrainingArguments
from ....transformers import (AutoConfig, AutoModelForCausalLM, AutoModelForSequenceClassification, AutoTokenizer,
                             LlmMetaConfig)
from ....trl import PPOConfig, PPOTrainer
from ....utils.log import logger
from ..data_utils import ListDataset

__all__ = ["ModelArguments", "PPOArguments", "load_prompt_dataset", "main"]


@dataclass
class ModelArguments:
    model_name_or_path: str = "facebook/llama-7b"
    reward_model_name_or_path: Optional[str] = None
    ref_model_name_or_path: Optional[str] = None
    dtype: str = "bfloat16"


@dataclass
class PPOArguments:
    dataset_name_or_path: str = "data"
    max_prompt_length: int = 512
    max_new_tokens: int = 128
    num_rollouts_per_prompt: int = 4
    temperature: float = 1.0
    top_p: float = 1.0
    clip_ratio: float = 0.2
    kl_coef: float = 0.05
    ppo_epochs: int = 1
    entropy_coef: float = 0.0
    use_value_model: bool = field(
        default=False,
        metadata={"help": "train a value model with GAE (the reference quartet) "
                          "instead of the group-relative baseline"})
    gamma: float = 1.0
    gae_lambda: float = 0.95
    value_lr: float = 1e-5


def load_prompt_dataset(path: str, tokenizer, ppo_args: PPOArguments):
    rows = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            r = json.loads(line)
            ids = tokenizer.encode(str(r["src"]))[: ppo_args.max_prompt_length]
            rows.append({"input_ids": np.asarray(ids, np.int32)})
    return rows


def main(argv: Optional[List[str]] = None, device="cuda") -> PPOTrainer:
    """Train as ``argv`` (a JSON file or CLI flags) says; returns the trainer."""
    parser = PdArgumentParser((ModelArguments, PPOArguments, TrainingArguments))
    model_args, ppo_args, training_args = parser.parse_args_into_dataclasses(argv)

    tokenizer = AutoTokenizer.from_pretrained(model_args.model_name_or_path)
    config = AutoConfig.from_pretrained(model_args.model_name_or_path)
    LlmMetaConfig.set_llm_config(config, training_args)
    model = AutoModelForCausalLM.from_pretrained(model_args.model_name_or_path, config=config,
                                                 dtype=model_args.dtype, param_dtype="float32", device=device)
    ref_model = None
    if model_args.ref_model_name_or_path:
        ref_model = AutoModelForCausalLM.from_pretrained(model_args.ref_model_name_or_path, config=config,
                                                         dtype=model_args.dtype, param_dtype="float32", device=device)
    if not model_args.reward_model_name_or_path:
        raise ValueError("run_ppo.py requires --reward_model_name_or_path (train one with run_rm.py)")
    reward_model = AutoModelForSequenceClassification.from_pretrained(
        model_args.reward_model_name_or_path, dtype=model_args.dtype, param_dtype="float32", device=device)

    rows = load_prompt_dataset(os.path.join(ppo_args.dataset_name_or_path, "train.json"), tokenizer, ppo_args)
    ppo_config = PPOConfig(
        num_rollouts_per_prompt=ppo_args.num_rollouts_per_prompt, max_new_tokens=ppo_args.max_new_tokens,
        max_prompt_length=ppo_args.max_prompt_length, temperature=ppo_args.temperature, top_p=ppo_args.top_p,
        clip_ratio=ppo_args.clip_ratio, kl_coef=ppo_args.kl_coef, ppo_epochs=ppo_args.ppo_epochs,
        entropy_coef=ppo_args.entropy_coef, use_value_model=ppo_args.use_value_model, gamma=ppo_args.gamma,
        gae_lambda=ppo_args.gae_lambda, value_lr=ppo_args.value_lr)
    trainer = PPOTrainer(model=model, ref_model=ref_model, reward_model=reward_model, args=training_args,
                         train_dataset=ListDataset(rows), tokenizer=tokenizer, ppo_config=ppo_config)
    if training_args.do_train:
        result = trainer.train(resume_from_checkpoint=training_args.resume_from_checkpoint)
        trainer.save_model()
        logger.info(f"ppo done: {result.metrics}")
    return trainer


if __name__ == "__main__":
    main()
