"""DPO trainer.

Port of ``paddlenlp_tpu/trl/dpo_trainer.py``. Batches carry
``chosen_input_ids``/``chosen_labels``/``rejected_input_ids``/``rejected_labels``
(prompt positions masked with -100). Chosen and rejected rows are
concatenated on the batch axis for one forward over ``ids[:, :-1]`` (no
padding mask: the flash kernels run it), the reference forward runs without
a gradient over a frozen copy of the policy's weights (or over a distinct
``ref_model``'s), and the criterion of ``loss_type`` scores them; orpo and
``sft_loss_ratio`` add the SFT anchor on the chosen responses.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..trainer.trainer import Trainer
from ..trainer.trainer_utils import copy_aliased_params
from ..utils.log import logger
from .dpo_criterion import DPOCriterion, sequence_logps

__all__ = ["DPOTrainer"]


class DPOTrainer(Trainer):
    def __init__(self, model=None, ref_model=None, dpo_criterion: Optional[DPOCriterion] = None,
                 beta: float = 0.1, loss_type: str = "sigmoid", **kwargs):
        self.dpo_criterion = dpo_criterion or DPOCriterion(beta=beta, loss_type=loss_type)
        super().__init__(model=model, **kwargs)
        self.ref_params = None
        if self.dpo_criterion.needs_reference:
            src = ref_model.params if ref_model is not None else model.params
            # the optimizer updates the policy's leaves in place: a reference
            # that shares them must be a copy; a distinct ref_model is kept
            self.ref_params = copy_aliased_params(src, model.params)
            if ref_model is None:
                logger.info("DPO: using a frozen copy of the policy as the reference model")

    def compute_loss(self, inputs: Dict[str, torch.Tensor], params: Optional[dict] = None) -> torch.Tensor:
        chosen_labels, rejected_labels = inputs["chosen_labels"], inputs["rejected_labels"]
        ids = torch.cat([inputs["chosen_input_ids"], inputs["rejected_input_ids"]], dim=0)
        labels = torch.cat([chosen_labels, rejected_labels], dim=0)[:, 1:]  # labels[t]: the target of logits[t]
        B = chosen_labels.shape[0]
        logps = sequence_logps(self.model.forward(ids[:, :-1], params=params), labels)
        policy_chosen, policy_rejected = logps[:B], logps[B:]
        ref_chosen = ref_rejected = None
        if self.ref_params is not None:
            with torch.no_grad():
                ref = sequence_logps(self.model.forward(ids[:, :-1], params=self.ref_params), labels)
            ref_chosen, ref_rejected = ref[:B], ref[B:]
        chosen_len = (chosen_labels[:, 1:] != -100).sum(dim=-1)
        rejected_len = (rejected_labels[:, 1:] != -100).sum(dim=-1)
        loss, _ = self.dpo_criterion(policy_chosen, policy_rejected, ref_chosen, ref_rejected, chosen_len,
                                     rejected_len)
        if self.dpo_criterion.loss_type == "orpo" or self.dpo_criterion.sft_loss_ratio > 0:
            sft = -(policy_chosen / torch.clamp(chosen_len, min=1)).mean()
            loss = loss + (self.dpo_criterion.sft_loss_ratio or 1.0) * sft
        return loss
