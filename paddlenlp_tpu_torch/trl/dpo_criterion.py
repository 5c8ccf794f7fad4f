"""Preference-optimization losses.

Port of ``paddlenlp_tpu/trl/dpo_criterion.py``: the DPO family selected by
``loss_type`` (sigmoid, hinge, ipo, kto_pair, simpo, orpo), pure functions
of per-sequence log-probabilities in fp32, with the same metrics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["DPOCriterion", "sequence_logps", "token_logps"]


def token_logps(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token log p(label) (JAX ``ppo_trainer.token_logps``): logits
    [B, T, V], labels [B, T] already aligned (``labels[t]`` is the target of
    ``logits[t]``); the log-softmax in fp32. Returns (logps [B, T] zeroed
    where invalid, the valid mask [B, T])."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = logp.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, tok, torch.zeros_like(tok)), valid


def sequence_logps(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Sum of log p(label) over the valid positions of each row."""
    return token_logps(logits, labels, ignore_index)[0].sum(dim=-1)


class DPOCriterion:
    """loss_type: sigmoid (DPO) | hinge | ipo | simpo | orpo | kto_pair."""

    def __init__(self, beta: float = 0.1, loss_type: str = "sigmoid", label_smoothing: float = 0.0,
                 simpo_gamma: float = 0.5, sft_loss_ratio: float = 0.0):
        self.beta = beta
        self.loss_type = loss_type
        self.label_smoothing = label_smoothing
        self.simpo_gamma = simpo_gamma
        self.sft_loss_ratio = sft_loss_ratio

    @property
    def needs_reference(self) -> bool:
        return self.loss_type not in ("simpo", "orpo")

    def __call__(self, policy_chosen_logps: torch.Tensor, policy_rejected_logps: torch.Tensor,
                 reference_chosen_logps: Optional[torch.Tensor] = None,
                 reference_rejected_logps: Optional[torch.Tensor] = None,
                 chosen_lengths: Optional[torch.Tensor] = None,
                 rejected_lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
        """(mean loss, metrics: the rewards' means, accuracy and margin)."""
        beta = self.beta
        if self.loss_type in ("sigmoid", "hinge", "ipo", "kto_pair"):
            assert reference_chosen_logps is not None, f"{self.loss_type} needs a reference model"
            chosen_rewards = beta * (policy_chosen_logps - reference_chosen_logps)
            rejected_rewards = beta * (policy_rejected_logps - reference_rejected_logps)
            margin = chosen_rewards - rejected_rewards
            if self.loss_type == "sigmoid":
                loss = (-F.logsigmoid(margin) * (1 - self.label_smoothing)
                        - F.logsigmoid(-margin) * self.label_smoothing)
            elif self.loss_type == "hinge":
                loss = torch.relu(1.0 - margin)
            elif self.loss_type == "ipo":
                loss = (margin / beta - 1.0 / (2.0 * beta)) ** 2
            else:  # kto_pair: KL baselines E[policy - reference], clipped at 0
                chosen_kl = torch.clamp((policy_chosen_logps - reference_chosen_logps).mean(), min=0.0)
                rejected_kl = torch.clamp((policy_rejected_logps - reference_rejected_logps).mean(), min=0.0)
                loss = torch.cat([
                    1.0 - torch.sigmoid(beta * ((policy_chosen_logps - reference_chosen_logps) - rejected_kl)),
                    1.0 - torch.sigmoid(beta * (chosen_kl - (policy_rejected_logps - reference_rejected_logps))),
                ])
        elif self.loss_type == "simpo":  # length-normalized, reference-free
            assert chosen_lengths is not None
            pc = policy_chosen_logps / torch.clamp(chosen_lengths, min=1)
            pr = policy_rejected_logps / torch.clamp(rejected_lengths, min=1)
            margin = beta * (pc - pr) - self.simpo_gamma
            loss = -F.logsigmoid(margin)
            chosen_rewards, rejected_rewards = beta * pc, beta * pr
        elif self.loss_type == "orpo":  # odds-ratio penalty (the trainer adds the SFT part)
            assert chosen_lengths is not None
            pc = policy_chosen_logps / torch.clamp(chosen_lengths, min=1)
            pr = policy_rejected_logps / torch.clamp(rejected_lengths, min=1)
            log_odds = (pc - pr) - (torch.log1p(-torch.clamp(torch.exp(pc), max=1 - 1e-6))
                                    - torch.log1p(-torch.clamp(torch.exp(pr), max=1 - 1e-6)))
            loss = -F.logsigmoid(beta * log_odds)
            chosen_rewards, rejected_rewards = pc, pr
        else:
            raise ValueError(f"unknown dpo loss_type {self.loss_type}")

        metrics = {
            "rewards_chosen": chosen_rewards.mean(),
            "rewards_rejected": rejected_rewards.mean(),
            "rewards_accuracy": (chosen_rewards > rejected_rewards).float().mean(),
            "rewards_margin": (chosen_rewards - rejected_rewards).mean(),
        }
        return loss.mean(), metrics
