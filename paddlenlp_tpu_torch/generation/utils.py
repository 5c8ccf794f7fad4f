"""``GenerationMixin``: greedy, sampled, beam and group-beam decoding over a
static KV cache.

PyTorch port of ``paddlenlp_tpu/generation/utils.py``. The JAX package runs
each decode as one jitted ``lax.while_loop`` over a [B, max_length] token
buffer and a static-shape cache. The port runs the same steps eagerly: one
prefill forward over the (left-padded) prompts, then one forward a position
over the cache (``transformers/cache_utils.KVCache``, written in place), with
the buffer, the finished flags and the beams on the device. The loop syncs
with the host once a step, to read whether every row has finished (the
``while_loop``'s condition); rows that finished emit pad, so the ids are what
the JAX loop returns. ``last_generate_stats`` keeps the steps and host syncs
of the last call.

Sampling draws JAX's tokens: ``key = jax.random.key(seed)``, then each step
``key, sub = split(key)`` and ``categorical(sub, logits)`` over [B, V], from
threefry in integer ops (``utils/prng.py``). Beam search keeps the JAX flat
[B*K] state: finished beams are frozen (their one candidate is pad at an
unchanged score), groups subtract ``diversity_penalty`` times the tokens the
earlier groups chose this step, the cache is reordered by one gather on its
batch axis, and the best beam is picked by length-penalized score. The
top-k over a group's [gk*V] candidates is a stable sort, which takes the
lower index on ties as ``lax.top_k`` does.

The model supplies ``config``, ``params``, ``generation_config``, ``device``
and ``_gen_forward(params, input_ids, attention_mask, position_ids, cache,
quantization_config) -> (logits [B, T, V], cache)``; the hooks
``_gen_position_ids`` and ``_init_decode_cache`` are the JAX package's.
Encoder-decoder decoding waits for the T5/BART families (ROADMAP Queue 1
item 14e).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import prng
from ..utils.log import logger
from .configuration_utils import GenerationConfig
from .logits_process import (
    FrequencyPenaltyLogitsProcessor,
    LogitsProcessorList,
    MinLengthLogitsProcessor,
    NoRepeatNGramLogitsProcessor,
    PresencePenaltyLogitsProcessor,
    RepetitionPenaltyLogitsProcessor,
    TemperatureLogitsWarper,
    TopKLogitsWarper,
    TopPLogitsWarper,
    _const,
)

__all__ = ["GenerationMixin"]

NEG = -1.0e9  # a beam's "minus infinity" (the JAX package's)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``'s arithmetic: (x - max) - log(sum(exp(x - max)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _as_ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


class GenerationMixin:
    """Mixed into the port's causal LMs (``LlamaForCausalLM``)."""

    #: {"steps": decode forwards after the prefill, "host_syncs": loop-condition reads} of the last call
    last_generate_stats: Optional[dict] = None

    def get_logits_processors(self, generation_config: GenerationConfig, prompt_len: int) -> LogitsProcessorList:
        g = generation_config
        procs = LogitsProcessorList()
        if g.min_new_tokens or g.min_length:
            min_new = g.min_new_tokens if g.min_new_tokens else g.min_length
            if g.eos_token_id is not None:
                procs.append(MinLengthLogitsProcessor(min_new, g.eos_token_id, prompt_len))
        if g.repetition_penalty and g.repetition_penalty != 1.0:
            procs.append(RepetitionPenaltyLogitsProcessor(g.repetition_penalty))
        if g.presence_penalty:
            procs.append(PresencePenaltyLogitsProcessor(g.presence_penalty))
        if g.frequency_penalty:
            procs.append(FrequencyPenaltyLogitsProcessor(g.frequency_penalty))
        if g.no_repeat_ngram_size:
            procs.append(NoRepeatNGramLogitsProcessor(g.no_repeat_ngram_size))
        return procs

    def get_logits_warpers(self, generation_config: GenerationConfig) -> LogitsProcessorList:
        g = generation_config
        warpers = LogitsProcessorList()
        if g.temperature is not None and g.temperature != 1.0:
            warpers.append(TemperatureLogitsWarper(g.temperature))
        if g.top_k is not None and g.top_k > 0:
            warpers.append(TopKLogitsWarper(g.top_k))
        if g.top_p is not None and g.top_p < 1.0:
            warpers.append(TopPLogitsWarper(g.top_p))
        return warpers

    def _resolve_generation_config(self, kwargs) -> GenerationConfig:
        base = self.generation_config or GenerationConfig.from_model_config(self.config)
        g = GenerationConfig(**base.to_dict())
        g.update(**kwargs)
        if g.pad_token_id is None:
            g.pad_token_id = getattr(self.config, "pad_token_id", None) or 0
        if g.eos_token_id is None:
            g.eos_token_id = getattr(self.config, "eos_token_id", None)
        if g.decode_strategy == "sampling":
            g.do_sample = True
        return g

    # ------------------------------------------------------------------ hooks
    def _gen_position_ids(self, pos, prompt_mask, *, prefill: bool):
        """Model hook: the loop's position ids ``pos`` ([B, T] at the
        prefill, [B, 1] a step: the count of real tokens before the current
        one) in the model's position scheme; ``prompt_mask`` [B, T0] is the
        prompt's attention mask. Default: identity."""
        return pos

    def _init_decode_cache(self, batch_size: int, max_length: int, params=None):
        """The decode cache: a ``KVCache`` in bf16 for a bf16 forward, else
        fp32 (``paddlenlp_tpu/generation/utils.py:98-104``)."""
        from ..transformers.cache_utils import init_cache

        dtype = torch.bfloat16 if self._forward_dtype(params) == torch.bfloat16 else torch.float32
        return init_cache(self.config, batch_size, max_length, dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ entry point
    @torch.no_grad()
    def generate(self, input_ids, attention_mask=None, generation_config: Optional[GenerationConfig] = None,
                 params=None, seed: int = 0, streamer=None, logits_processors: Optional[LogitsProcessorList] = None,
                 quantization_config=None, **kwargs):
        """Returns (sequences, scores) on the model's device: the generated ids
        ([B, new_tokens] with ``trunc_input``, else the prompt too, padded to
        ``max_length`` with pad ids) and, for beam search, the best beams'
        length-penalized log-probs (None for greedy and sampling).
        ``max_new_tokens`` counts new tokens, and so does ``max_length`` (the
        reference's semantics). ``params`` (default ``self.params``) and
        ``quantization_config`` are what the model's forward reads: the
        quantized and LoRA facades pass their own."""
        if generation_config is not None:
            kwargs = {**generation_config.to_dict(), **kwargs}
        g = self._resolve_generation_config(kwargs)
        params = params if params is not None else self.params
        input_ids = _as_ids(input_ids, self.device)
        B, T0 = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((B, T0), dtype=torch.long, device=self.device)
        else:
            attention_mask = _as_ids(attention_mask, self.device)

        if getattr(self.config, "is_encoder_decoder", False):
            return self._generate_seq2seq(params, input_ids, attention_mask, g, seed, streamer, logits_processors)

        if bool((attention_mask[:, -1] == 0).any()):
            logger.warning_once(
                "right-padded prompts detected in generate(); use tokenizer padding_side='left' for batched decode"
            )

        if g.max_new_tokens is not None:
            max_length = T0 + int(g.max_new_tokens)
        else:
            max_length = T0 + int(g.max_length)  # reference semantics: max_length counts new tokens
        procs = self.get_logits_processors(g, T0)
        if logits_processors:
            procs.extend(logits_processors)
        warpers = self.get_logits_warpers(g) if g.do_sample else LogitsProcessorList()

        eos_ids = tuple(g.eos_token_id) if isinstance(g.eos_token_id, (list, tuple)) else (
            (g.eos_token_id,) if g.eos_token_id is not None else ()
        )

        def forward(ids, mask, pos, cache):
            return self._gen_forward(params, ids, mask, pos, cache, quantization_config)

        if streamer is not None:
            streamer.put(input_ids.cpu().numpy())
        use_beams = (g.num_beams or 1) > 1 or g.decode_strategy in ("beam_search", "group_beam_search")
        if use_beams:
            if g.do_sample:
                logger.warning_once(
                    "num_beams>1 runs deterministic beam search; do_sample/temperature/"
                    "top_k/top_p are ignored (stochastic beam sampling is not implemented)"
                )
            num_groups = g.num_beam_groups if g.decode_strategy == "group_beam_search" or g.num_beam_groups > 1 else 1
            ids_buf, scores = self._beam_decode(
                forward, params, input_ids, attention_mask,
                max_length=max_length, pad_id=int(g.pad_token_id), eos_ids=eos_ids,
                num_beams=max(g.num_beams, num_groups), num_groups=num_groups,
                length_penalty=float(g.length_penalty if g.length_penalty is not None else 1.0),
                diversity_penalty=float(getattr(g, "diversity_penalty", 0.0) or 0.0), procs=procs)
        else:
            ids_buf = self._decode(forward, params, input_ids, attention_mask, max_length=max_length,
                                   do_sample=bool(g.do_sample), pad_id=int(g.pad_token_id), eos_ids=eos_ids,
                                   procs=procs, warpers=warpers, seed=seed)
            scores = None
        if streamer is not None:
            cols = ids_buf.cpu().numpy()
            for t in range(T0, max_length):
                streamer.put(cols[:, t])
            streamer.end()
        if g.trunc_input:
            return ids_buf[:, T0:], scores
        return ids_buf, scores

    def _generate_seq2seq(self, params, input_ids, attention_mask, g, seed, streamer, extra_procs):
        raise NotImplementedError("generate: encoder-decoder decoding is not part of the PyTorch port yet: "
                                  "ROADMAP Queue 1 item 14e (the T5 and BART families)")

    # ------------------------------------------------------------------ decode loops
    def _prefill(self, forward, params, input_ids, attention_mask, max_length, pad_id):
        """The buffers, and the prompt's forward over a fresh cache with
        ``clip(cumsum(mask) - 1, 0)`` positions: (ids_buf, pad_mask, cache,
        last logits [B, V] fp32)."""
        B, T0 = input_ids.shape
        ids_buf = torch.full((B, max_length), pad_id, dtype=torch.long, device=input_ids.device)
        ids_buf[:, :T0] = input_ids
        pad_mask = torch.cat([attention_mask, torch.ones((B, max_length - T0), dtype=attention_mask.dtype,
                                                         device=attention_mask.device)], dim=1)
        cache = self._init_decode_cache(B, max_length, params)
        prompt_pos = torch.clamp_min(torch.cumsum(attention_mask, dim=1) - 1, 0)
        prompt_pos = self._gen_position_ids(prompt_pos, attention_mask, prefill=True)
        logits, cache = forward(input_ids, pad_mask, prompt_pos, cache)
        return ids_buf, pad_mask, cache, logits[:, -1].float()

    def _step_positions(self, attention_mask, pad_mask, cur_len):
        """[B, 1]: the count of real tokens before position ``cur_len - 1``
        (the prompt's, then one a generated position)."""
        T0 = attention_mask.shape[1]
        pos = attention_mask.sum(dim=1) + (cur_len - 1 - T0)
        return self._gen_position_ids(pos[:, None], pad_mask[:, :T0], prefill=False)

    def _decode(self, forward, params, input_ids, attention_mask, *, max_length, do_sample, pad_id, eos_ids, procs,
                warpers, seed):
        """Greedy / sampled decode (``_get_decode_fn``, :479-566)."""
        B, T0 = input_ids.shape
        ids_buf, pad_mask, cache, logits = self._prefill(forward, params, input_ids, attention_mask, max_length,
                                                         pad_id)
        finished = torch.zeros((B,), dtype=torch.bool, device=ids_buf.device)
        eos = torch.tensor(list(eos_ids), dtype=torch.long, device=ids_buf.device)
        key = prng.key(seed, device=ids_buf.device)

        def sample_token(logits, cur_len, key, finished):
            # left-pad prompt slots must not feed repetition/ngram processors:
            # they read as the out-of-range sentinel V
            proc_ids = torch.where(pad_mask > 0, ids_buf, logits.shape[-1])
            logits = procs(proc_ids, logits, cur_len)
            if do_sample:
                logits = warpers(proc_ids, logits, cur_len)
                key, sub = prng.split(key)
                nxt = prng.categorical(sub, logits)
            else:
                nxt = logits.argmax(dim=-1)
            nxt = torch.where(finished, pad_id, nxt)
            return nxt, key, finished | torch.isin(nxt, eos)

        nxt, key, finished = sample_token(logits, T0, key, finished)
        ids_buf[:, T0] = nxt
        cur_len, steps, syncs = T0 + 1, 0, 0
        while cur_len < max_length:
            syncs += 1
            if bool(finished.all()):
                break
            pos = self._step_positions(attention_mask, pad_mask, cur_len)
            logits, cache = forward(ids_buf[:, cur_len - 1:cur_len], pad_mask, pos, cache)
            nxt, key, finished = sample_token(logits[:, -1].float(), cur_len, key, finished)
            ids_buf[:, cur_len] = nxt
            cur_len += 1
            steps += 1
        self.last_generate_stats = dict(steps=steps, host_syncs=syncs, cache_bytes=cache.nbytes)
        return ids_buf

    def _beam_decode(self, forward, params, input_ids, attention_mask, *, max_length, pad_id, eos_ids, num_beams,
                     num_groups, length_penalty, diversity_penalty, procs):
        """Beam / group-beam search over flat [B*K] state
        (``_get_beam_decode_fn``, :325-477); returns (ids [B, max_length] of
        each row's best beam, its length-penalized score [B])."""
        K, G = num_beams, num_groups
        if K % G != 0:
            raise ValueError(f"num_beams {K} must be divisible by num_beam_groups {G}")
        gk = K // G
        B, T0 = input_ids.shape
        BK = B * K
        dev = input_ids.device
        rep_mask = attention_mask.repeat_interleave(K, dim=0)
        ids_buf, pad_mask, cache, logits = self._prefill(forward, params, input_ids.repeat_interleave(K, dim=0),
                                                         rep_mask, max_length, pad_id)
        V = logits.shape[-1]
        # beam 0 of each group starts live; the rest at NEG (identical prompts)
        scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
        scores[:, ::gk] = 0.0
        finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
        lengths = torch.zeros((B, K), dtype=torch.int32, device=dev)  # generated-token counts
        eos = torch.tensor(list(eos_ids) or [-1], dtype=torch.long, device=dev)
        rows0 = torch.arange(B, device=dev)[:, None] * K
        pad_only = torch.full((B, gk, V), NEG, dtype=torch.float32, device=dev)
        pad_only[:, :, pad_id] = 0.0

        def select(logits, scores, finished, lengths, cur_len):
            proc_ids = torch.where(pad_mask > 0, ids_buf, V)
            logits = procs(proc_ids, logits, cur_len)
            logp = _log_softmax(logits).reshape(B, K, V)
            beams, toks, new_scores, new_fin, new_len = [], [], [], [], []
            counts = torch.zeros((B, V), dtype=torch.float32, device=dev)
            div = _const(logp, diversity_penalty)
            for g in range(G):
                sl = slice(g * gk, (g + 1) * gk)
                base = scores[:, sl]
                cand = base[:, :, None] + (logp[:, sl] - div * counts[:, None, :])  # [B, gk, V]
                # finished beams: one pad candidate at an unchanged score
                cand = torch.where(finished[:, sl, None], pad_only + base[:, :, None], cand)
                top = torch.sort(cand.reshape(B, gk * V), dim=1, descending=True, stable=True)
                top_v, top_i = top.values[:, :gk], top.indices[:, :gk]
                b_idx = top_i // V + g * gk  # global beam index within K
                t_idx = top_i % V
                sel_fin = torch.gather(finished, 1, b_idx)
                sel_len = torch.gather(lengths, 1, b_idx)
                beams.append(b_idx)
                toks.append(t_idx)
                new_scores.append(top_v)
                new_fin.append(sel_fin | (torch.isin(t_idx, eos) & ~sel_fin))
                new_len.append(torch.where(sel_fin, sel_len, sel_len + 1))
                if G > 1:
                    counts = counts.scatter_add(1, t_idx, torch.ones_like(t_idx, dtype=torch.float32))
            return (torch.cat(beams, 1), torch.cat(toks, 1), torch.cat(new_scores, 1), torch.cat(new_fin, 1),
                    torch.cat(new_len, 1))

        def apply_step(logits, cache, cur_len, scores, finished, lengths):
            nonlocal ids_buf
            beam_idx, tok, scores, finished, lengths = select(logits, scores, finished, lengths, cur_len)
            rows = (rows0 + beam_idx).reshape(-1)
            ids_buf = ids_buf[rows]
            ids_buf[:, cur_len] = tok.reshape(BK)
            return cache.reorder(rows), scores, finished, lengths

        cache, scores, finished, lengths = apply_step(logits, cache, T0, scores, finished, lengths)
        cur_len, steps, syncs = T0 + 1, 0, 0
        while cur_len < max_length:
            syncs += 1
            if bool(finished.all()):
                break
            pos = self._step_positions(rep_mask, pad_mask, cur_len)
            logits, cache = forward(ids_buf[:, cur_len - 1:cur_len], pad_mask, pos, cache)
            cache, scores, finished, lengths = apply_step(logits[:, -1].float(), cache, cur_len, scores, finished,
                                                          lengths)
            cur_len += 1
            steps += 1
        self.last_generate_stats = dict(steps=steps, host_syncs=syncs, cache_bytes=cache.nbytes)
        # length-penalized final selection (reference BeamHypotheses.add)
        norm = scores / torch.clamp_min(lengths.float(), 1.0) ** length_penalty
        best = norm.argmax(dim=1)
        rows = torch.arange(B, device=dev) * K + best
        return ids_buf[rows], torch.gather(norm, 1, best[:, None])[:, 0]
