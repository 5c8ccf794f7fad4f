"""Cross-entropy losses for LM pretraining.

Port of ``paddlenlp_tpu/ops/cross_entropy.py`` (``cross_entropy_with_ignore``
:23, ``fused_linear_cross_entropy`` :40, ``causal_lm_loss`` :86): token-mean
CE over non-ignored labels with fp32 accumulation.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["IGNORE_INDEX", "causal_lm_loss", "cross_entropy_with_ignore", "fused_linear_cross_entropy"]

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


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """Sum of the token CE of ``hidden @ weight`` over ``chunk`` tokens at a
    time. The forward keeps each token's log-sum-exp; the backward recomputes
    one chunk's logits, turns them into ``softmax - onehot`` in place and
    multiplies back, so neither holds more than one chunk's [B, chunk, V]
    fp32 logits. As in the JAX ``jax.checkpoint`` of each chunk, the head
    product and the hidden gradient run in ``hidden``'s dtype (the weight
    cast to it). Each chunk's weight gradient is taken in fp32 from the fp32
    softmax and added up in fp32: the JAX op rounds it to ``hidden``'s dtype
    a chunk, and at bf16 those 16 roundings of [2, 4096] tokens put the head
    gradient twice the bf16 gate away from the full-logits loss's."""

    @staticmethod
    def forward(ctx, hidden, weight, labels, ignore_index: int, chunk: int):
        T = hidden.shape[1]
        w = weight.to(hidden.dtype)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        lse = torch.empty(labels.shape, dtype=torch.float32, device=hidden.device)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s in range(0, T, chunk):
            logits = (hidden[:, s:s + chunk] @ w).float()
            lse[:, s:s + chunk] = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, safe[:, s:s + chunk, None])[..., 0]
            del logits
            token_loss = lse[:, s:s + chunk] - picked
            total = total + torch.where(valid[:, s:s + chunk], token_loss, torch.zeros_like(token_loss)).sum()
        n_valid = valid.sum()
        ctx.save_for_backward(hidden, weight, safe, valid, lse, n_valid)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(n_valid)
        return total / torch.clamp_min(n_valid, 1), n_valid

    @staticmethod
    def backward(ctx, g_loss, _g_n):
        hidden, weight, safe, valid, lse, n_valid = ctx.saved_tensors
        chunk, T, D = ctx.chunk, hidden.shape[1], hidden.shape[2]
        w = weight.to(hidden.dtype)
        scale = g_loss / torch.clamp_min(n_valid, 1)
        dh = torch.empty_like(hidden)
        dw = torch.zeros(weight.shape, dtype=torch.float32, device=weight.device)
        for s in range(0, T, chunk):
            h = hidden[:, s:s + chunk]
            p = (h @ w).float()
            p.sub_(lse[:, s:s + chunk, None]).exp_()
            p.scatter_add_(-1, safe[:, s:s + chunk, None], torch.full_like(p[..., :1], -1.0))
            p.mul_(valid[:, s:s + chunk, None] * scale)
            dh[:, s:s + chunk] = p.to(hidden.dtype) @ w.T
            dw += h.reshape(-1, D).float().T @ p.reshape(-1, p.shape[-1])
            del p
        return dh, dw.to(weight.dtype), None, None, None


def fused_linear_cross_entropy(hidden: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                               ignore_index: int = IGNORE_INDEX, chunk: int = 512
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-mean CE of ``hidden @ weight`` (hidden [B, T, D], the head
    ``weight`` [D, V], ``labels`` [B, T] aligned with ``hidden``) over the
    labels that are not ``ignore_index``, without the [B, T, V] logits: the
    forward and the backward each hold one chunk of ``chunk`` tokens' fp32
    logits at a time. Returns (loss, n_valid)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _FusedLinearCrossEntropy.apply(hidden, weight, labels, ignore_index, chunk)
