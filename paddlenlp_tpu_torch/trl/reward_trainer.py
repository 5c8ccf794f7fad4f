"""Reward-model trainer.

Port of ``paddlenlp_tpu/trl/reward_trainer.py``: the pairwise Bradley-Terry
loss ``-log sigmoid(r_chosen - r_rejected)`` over a sequence-classification
head (``num_labels=1``); chosen and rejected rows go through one forward,
with their padding masks when the batch has them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..trainer.trainer import Trainer

__all__ = ["RewardTrainer"]


class RewardTrainer(Trainer):
    def compute_loss(self, inputs: Dict[str, torch.Tensor], params: Optional[dict] = None) -> torch.Tensor:
        chosen, rejected = inputs["chosen_input_ids"], inputs["rejected_input_ids"]
        ids = torch.cat([chosen, rejected], dim=0)
        mask = None
        if inputs.get("chosen_attention_mask") is not None:
            mask = torch.cat([inputs["chosen_attention_mask"], inputs["rejected_attention_mask"]], dim=0)
        rewards = self.model.forward(ids, params=params, attention_mask=mask)[..., 0].float()
        B = chosen.shape[0]
        return -F.logsigmoid(rewards[:B] - rewards[B:]).mean()
