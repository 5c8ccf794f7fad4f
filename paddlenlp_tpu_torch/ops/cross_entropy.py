"""Cross-entropy losses for LM pretraining.

Port of ``paddlenlp_tpu/ops/cross_entropy.py`` (``cross_entropy_with_ignore``
:23, ``causal_lm_loss`` :86): token-mean CE over non-ignored labels with fp32
accumulation. ``fused_linear_cross_entropy`` (:40) serves only the pipelined
loss and is not part of the port yet (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["IGNORE_INDEX", "causal_lm_loss", "cross_entropy_with_ignore"]

IGNORE_INDEX = -100


def cross_entropy_with_ignore(logits: torch.Tensor, labels: torch.Tensor,
                              ignore_index: int = IGNORE_INDEX) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE of ``logits`` [..., V] against ``labels`` [...] over the
    labels that are not ``ignore_index``, in fp32. Returns (loss, n_valid)."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    token_loss = torch.where(valid, lse - picked, torch.zeros_like(lse))
    n_valid = valid.sum()
    return token_loss.sum() / torch.clamp_min(n_valid, 1), n_valid


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = IGNORE_INDEX,
                   shift: bool = False) -> torch.Tensor:
    """CE of logits [B, T, V] against labels [B, T]; ``shift`` drops the last
    logit and the first label (labels given unshifted)."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    return cross_entropy_with_ignore(logits, labels, ignore_index)[0]
