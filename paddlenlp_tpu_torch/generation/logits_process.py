"""Logits processors and warpers on torch tensors.

PyTorch port of ``paddlenlp_tpu/generation/logits_process.py``. Each is
``(ids_buf, logits, cur_len) -> logits``: ``ids_buf`` is the decode loop's
[B, max_len] buffer (the prefix below ``cur_len`` is valid; left-pad prompt
slots hold the out-of-range sentinel ``V``), ``logits`` [B, V] float32 and
``cur_len`` the loop's int position. The arithmetic is the JAX package's
step for step, so a processed row picks the JAX token: divisors are fp32
tensors on the logits' device (a Python scalar divisor on CUDA multiplies by
its rounded reciprocal), and top-k/top-p cut at values from a stable sort,
as ``lax.top_k`` and ``jnp.sort`` do.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import plain_softmax

__all__ = [
    "LogitsProcessor",
    "LogitsProcessorList",
    "MinLengthLogitsProcessor",
    "RepetitionPenaltyLogitsProcessor",
    "PresencePenaltyLogitsProcessor",
    "FrequencyPenaltyLogitsProcessor",
    "NoRepeatNGramLogitsProcessor",
    "ForcedBOSTokenLogitsProcessor",
    "ForcedEOSTokenLogitsProcessor",
    "TemperatureLogitsWarper",
    "TopKLogitsWarper",
    "TopPLogitsWarper",
]

NEG_INF = -1e9


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of x's dtype on x's device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


class LogitsProcessor:
    def __call__(self, ids_buf, logits, cur_len):
        raise NotImplementedError


class LogitsProcessorList(list):
    def __call__(self, ids_buf, logits, cur_len):
        for proc in self:
            logits = proc(ids_buf, logits, cur_len)
        return logits


def _valid_counts(ids_buf: torch.Tensor, cur_len, vocab_size: int) -> torch.Tensor:
    """[B, vocab] int32 counts of each token in the valid prefix. Ids out of
    ``[0, vocab)`` (the left-pad sentinel) count nowhere, as ``one_hot`` maps
    them to zero rows in the JAX package (``:47-58``)."""
    B, L = ids_buf.shape
    valid = torch.arange(L, device=ids_buf.device)[None, :] < cur_len
    idx = torch.where(valid & (ids_buf >= 0) & (ids_buf < vocab_size), ids_buf.long(), vocab_size)
    counts = torch.zeros(B, vocab_size + 1, dtype=torch.int32, device=ids_buf.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:, :vocab_size]


class MinLengthLogitsProcessor(LogitsProcessor):
    def __init__(self, min_length: int, eos_token_id, prompt_len: int = 0):
        self.min_length = min_length
        ids = eos_token_id if isinstance(eos_token_id, (list, tuple)) else [eos_token_id]
        self.eos_token_ids = tuple(int(i) for i in ids)
        self.prompt_len = prompt_len

    def __call__(self, ids_buf, logits, cur_len):
        if (cur_len - self.prompt_len) >= self.min_length:
            return logits
        eos_mask = torch.zeros_like(logits)
        for eos in self.eos_token_ids:
            eos_mask[:, eos] = NEG_INF
        return logits + eos_mask


class RepetitionPenaltyLogitsProcessor(LogitsProcessor):
    """CTRL-style: divide positive / multiply negative logits of seen tokens."""

    def __init__(self, penalty: float):
        self.penalty = penalty

    def __call__(self, ids_buf, logits, cur_len):
        seen = _valid_counts(ids_buf, cur_len, logits.shape[-1]) > 0
        p = _const(logits, self.penalty)
        penalized = torch.where(logits > 0, logits / p, logits * p)
        return torch.where(seen, penalized, logits)


class PresencePenaltyLogitsProcessor(LogitsProcessor):
    def __init__(self, penalty: float):
        self.penalty = penalty

    def __call__(self, ids_buf, logits, cur_len):
        seen = _valid_counts(ids_buf, cur_len, logits.shape[-1]) > 0
        return logits - seen.to(logits.dtype) * _const(logits, self.penalty)


class FrequencyPenaltyLogitsProcessor(LogitsProcessor):
    def __init__(self, penalty: float):
        self.penalty = penalty

    def __call__(self, ids_buf, logits, cur_len):
        counts = _valid_counts(ids_buf, cur_len, logits.shape[-1])
        return logits - counts.to(logits.dtype) * _const(logits, self.penalty)


class NoRepeatNGramLogitsProcessor(LogitsProcessor):
    """Ban tokens that would complete an n-gram already in the valid prefix."""

    def __init__(self, ngram_size: int):
        self.n = ngram_size

    def __call__(self, ids_buf, logits, cur_len):
        n = self.n
        B, L = ids_buf.shape
        V = logits.shape[-1]
        if n <= 1 or L < n or cur_len - (n - 1) < 0:
            return logits
        cur_suffix = ids_buf[:, cur_len - (n - 1):cur_len]  # [B, n-1], the (n-1)-gram ending at cur_len-1
        windows = ids_buf.unfold(1, n - 1, 1)[:, :L - n + 1]  # [B, L-n+1, n-1]: every historical (n-1)-gram
        next_tokens = ids_buf[:, n - 1:]  # [B, L-n+1]: the token after each
        match = (windows == cur_suffix[:, None, :]).all(dim=-1)
        # only n-grams fully inside the valid prefix count
        match = match & ((torch.arange(L - n + 1, device=ids_buf.device) + n - 1) < cur_len)[None, :]
        idx = torch.where((next_tokens >= 0) & (next_tokens < V), next_tokens.long(), V)
        hits = torch.zeros(B, V + 1, dtype=torch.int32, device=logits.device)
        hits.scatter_add_(1, idx, match.to(torch.int32))
        return torch.where(hits[:, :V] > 0, logits + NEG_INF, logits)


class ForcedBOSTokenLogitsProcessor(LogitsProcessor):
    def __init__(self, bos_token_id: int):
        self.bos_token_id = bos_token_id

    def __call__(self, ids_buf, logits, cur_len):
        if cur_len != 1:
            return logits
        forced = torch.full_like(logits, NEG_INF)
        forced[:, self.bos_token_id] = 0.0
        return forced


class ForcedEOSTokenLogitsProcessor(LogitsProcessor):
    def __init__(self, max_length: int, eos_token_id: int):
        self.max_length = max_length
        self.eos_token_id = eos_token_id

    def __call__(self, ids_buf, logits, cur_len):
        if cur_len != self.max_length - 1:
            return logits
        forced = torch.full_like(logits, NEG_INF)
        forced[:, self.eos_token_id] = 0.0
        return forced


class TemperatureLogitsWarper(LogitsProcessor):
    def __init__(self, temperature: float):
        self.temperature = temperature

    def __call__(self, ids_buf, logits, cur_len):
        return logits / _const(logits, self.temperature)


class TopKLogitsWarper(LogitsProcessor):
    def __init__(self, top_k: int):
        self.top_k = top_k

    def __call__(self, ids_buf, logits, cur_len):
        k = min(self.top_k, logits.shape[-1])
        kth = torch.sort(logits, dim=-1, descending=True, stable=True).values[..., k - 1:k]
        return torch.where(logits < kth, NEG_INF, logits)


class TopPLogitsWarper(LogitsProcessor):
    def __init__(self, top_p: float):
        self.top_p = top_p

    def __call__(self, ids_buf, logits, cur_len):
        sorted_logits = torch.sort(logits, dim=-1, descending=True, stable=True).values
        probs = plain_softmax(sorted_logits)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative probability >= top_p (the top-1 always)
        keep = (cum - probs) < self.top_p
        kth = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        return torch.where(logits < kth, NEG_INF, logits)
