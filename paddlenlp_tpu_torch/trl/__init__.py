"""Alignment trainers of the PyTorch port: DPO and its loss family, the
reward model and PPO (the exports of ``paddlenlp_tpu/trl/``)."""

from .dpo_criterion import DPOCriterion, sequence_logps  # noqa: F401
from .dpo_trainer import DPOTrainer  # noqa: F401
from .reward_trainer import RewardTrainer  # noqa: F401
from .ppo_trainer import PPOConfig, PPOTrainer  # noqa: F401
