"""Paged-attention inference forward for llama-family models.

PyTorch port of ``paddlenlp_tpu/experimental/inference_model.py``: a serving
forward that reuses the model's scanned ``[L]`` parameters and runs its own
loop over the layers against the paged KV pool. Where the JAX package traced
one jit per entry point and scanned the layers with ``lax.scan``, the port
runs eagerly: a Python loop over layers writing into the pool in place. The
multi-step decode keeps tokens, done flags and penalty counts on the device
for all ``decode_steps`` iterations; the caller syncs once per call.

Attention takes one of two paths, chosen by ``use_paged_kernel`` (default: on
for a CUDA device): the CUDA ragged paged-attention kernel reading the pool
through the block tables, or the plain path that gathers each sequence's
blocks and attends in fp32 (the JAX package's XLA path, used on the CPU).

``sample_tokens`` reproduces the JAX sampler exactly, including its random
draws: ``jax.random.categorical(fold_in(key(seed), position), row)`` is
rebuilt from threefry2x32 in integer ops (the partitionable bit layout and the
"low" Gumbel mode of ``jax.random``), so a seeded request samples the same
tokens in both packages.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.paged_attention import ragged_paged_attention
from ..ops.rope import apply_rotary_pos_emb, rope_frequencies, rope_tables
from ..transformers.llama.modeling import layer_params, rms_norm
from .paged_cache import PagedKVPool, gather_kv, write_kv_block

__all__ = ["PagedInferenceModel", "sample_tokens"]

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values; the
    counterpart of ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _U32
    x2 = (x2 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _U32
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _U32
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _U32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _U32
    return x1, x2


def _uniform_rows(seeds, positions, V: int) -> torch.Tensor:
    """Row b: ``jax.random.uniform(fold_in(key(seeds[b]), positions[b]), (V,),
    minval=tiny, maxval=1.)`` in float32 (threefry, partitionable layout)."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    # key(seed) = (0, seed); fold_in hashes the count pair (0, data) under it
    k1, k2 = _threefry2x32(zero, seeds.long() & _U32, zero, positions.long() & _U32)
    counts = torch.arange(V, device=seeds.device, dtype=torch.int64)[None, :]
    b1, b2 = _threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(counts), counts)
    bits = b1 ^ b2
    # 23 random mantissa bits under exponent 0 give [1, 2); minus 1
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    return torch.clamp_min(floats + tiny, tiny)


def _gumbel_rows(seeds, positions, V: int) -> torch.Tensor:
    """Row b: ``jax.random.gumbel(fold_in(key(seeds[b]), positions[b]), (V,))``
    in float32 ("low" mode)."""
    return -torch.log(-torch.log(_uniform_rows(seeds, positions, V)))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    *,
    positions: torch.Tensor,  # [B] absolute position of the token being sampled
    seeds: torch.Tensor,  # [B] int32 per-slot seeds
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B] int32 (<=0: off)
    top_p: torch.Tensor,  # [B]
    do_sample: torch.Tensor,  # [B] bool
    counts: Optional[torch.Tensor] = None,  # [B, V] token counts (prompt+generated)
    repetition_penalty: Optional[torch.Tensor] = None,  # [B]
    presence_penalty: Optional[torch.Tensor] = None,  # [B]
    frequency_penalty: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """On-device sampling: penalties + temperature + top-k/top-p + draw, the
    same arithmetic as the JAX package's ``sample_tokens``. One stable [B, V]
    sort serves top-k and top-p; randomness is keyed on (seed, absolute
    position), so a preempted-and-recomputed sequence resamples identical
    tokens. Returns int32 ids [B]."""
    B, V = logits.shape
    logits = logits.float()
    if counts is not None:
        seen = counts > 0
        rp = repetition_penalty[:, None]
        logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
        logits = logits - seen.float() * presence_penalty[:, None]
        logits = logits - counts.float() * frequency_penalty[:, None]
    greedy = logits.argmax(dim=-1)

    warped = logits / torch.clamp_min(temperature, 1e-6)[:, None]
    order = torch.sort(-warped, dim=-1, stable=True).indices  # jnp.argsort is stable
    sorted_logits = torch.gather(warped, 1, order)
    ranks = torch.arange(V, device=logits.device)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    # top-k first, RENORMALIZE, then the nucleus cutoff over the renormalized
    # distribution
    keep_k = torch.where(top_k[:, None] > 0, ranks < top_k[:, None], True)
    probs = _softmax(torch.where(keep_k, sorted_logits, neg_inf))
    csum = torch.cumsum(probs, dim=-1)
    keep = keep_k & ((csum - probs) < top_p[:, None])
    keep |= ranks == 0  # top-1 always kept
    masked = torch.where(keep, sorted_logits, neg_inf)
    picked = (_gumbel_rows(seeds, positions, V) + masked).argmax(dim=-1)
    sampled = torch.gather(order, 1, picked[:, None])[:, 0]
    return torch.where(do_sample, sampled, greedy).to(torch.int32)


def _count_tokens(ids: torch.Tensor, valid: torch.Tensor, V: int) -> torch.Tensor:
    """[n, V] int32 counts of ``ids`` [n, T] where ``valid``; out-of-vocab ids
    count nothing (JAX's one_hot gives them zero rows)."""
    w = (valid & (ids >= 0) & (ids < V)).to(torch.int32)
    out = torch.zeros(ids.shape[0], V, dtype=torch.int32, device=ids.device)
    return out.scatter_add_(1, ids.long().clamp(0, V - 1), w)


class PagedInferenceModel:
    """Prefill / decode / mixed steps over (params, paged pool). Llama-family
    only (llama/qwen2: config-driven biases + GQA + rope)."""

    def __init__(self, model, block_size: int = 16, num_blocks: int = 512, max_blocks_per_seq: int = 64,
                 dtype=torch.bfloat16, decode_steps: int = 8, eos_ids=(), use_paged_kernel=None):
        if getattr(model, "quantization_config", None) is not None:
            raise NotImplementedError(
                "quantized weights (a8w8, weight-only) are not part of the port yet: "
                "ROADMAP Queue 1 item 11")
        self.model = model
        self.config = model.config
        self.device = model.device
        self.dtype = dtype
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_blocks_per_seq = max_blocks_per_seq
        self.decode_steps = decode_steps
        # the CUDA kernel on the card; the plain gather path on the CPU
        self.use_paged_kernel = self.device.type == "cuda" if use_paged_kernel is None else use_paged_kernel
        # [-1] sentinel when no eos: never matches a sampled id
        self.eos_arr = torch.tensor(sorted(eos_ids) or [-1], dtype=torch.int32, device=self.device)
        cfg = self.config
        self.eps = cfg.rms_norm_eps
        self.n_heads = cfg.num_attention_heads
        self.n_kv = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        self.inv_freq = torch.from_numpy(rope_frequencies(self.head_dim, cfg.rope_theta, cfg.rope_scaling)) \
            .to(self.device)
        self.bind_params()

    def bind_params(self):
        """Per-layer views of ``model.params``; called again after a weight
        swap rebinds the tree (the embedding, final norm and head are read
        from ``model.params`` on every call)."""
        layers = self.model.params["model"]["layers"]
        self._layers = [layer_params(layers, i) for i in range(self.config.num_hidden_layers)]

    def _mm(self, p, x):
        y = x @ p["kernel"].to(self.dtype)
        if "bias" in p:
            y = y + p["bias"].to(self.dtype)
        return y

    # ------------------------------------------------------------------ forward core
    def _attend(self, q, k, v, q_positions, kv_len_mask):
        """q [B,T,N,H]; k/v [B,S,K,H]; causal by absolute position + length mask."""
        B, T, N, H = q.shape
        S = k.shape[1]
        if self.n_kv != N:
            k = k.repeat_interleave(N // self.n_kv, dim=2)
            v = v.repeat_interleave(N // self.n_kv, dim=2)
        logits = torch.einsum("btnh,bsnh->bnts", q.float(), k.float()) * (H**-0.5)
        kv_pos = torch.arange(S, device=q.device)[None, :]
        mask = (kv_pos[:, None, :] <= q_positions[:, :, None]) & kv_len_mask[:, None, :]
        logits = torch.where(mask[:, None], logits, torch.full_like(logits, -1e30))
        out = torch.einsum("bnts,bsnh->btnh", torch.softmax(logits, dim=-1), v.float())
        return out.to(q.dtype)

    def _layer(self, h, i, pool: PagedKVPool, block_tables, q_positions, kv_len_mask, write_pos, q_lens):
        """Decoder layer ``i``: writes this step's K/V into the pool's layer
        ``i`` in place and returns the new hidden states."""
        lp = self._layers[i]
        B, T, _ = h.shape
        x = rms_norm(h, lp["input_layernorm"]["scale"], self.eps)
        attn = lp["self_attn"]
        q = self._mm(attn["q_proj"], x).reshape(B, T, self.n_heads, self.head_dim)
        k = self._mm(attn["k_proj"], x).reshape(B, T, self.n_kv, self.head_dim)
        v = self._mm(attn["v_proj"], x).reshape(B, T, self.n_kv, self.head_dim)
        cos, sin = rope_tables(q_positions, self.inv_freq)
        q, k = apply_rotary_pos_emb(q, k, cos, sin)

        pool_layer = pool.kv[i]
        scale_layer = None if pool.scale is None else pool.scale[i]
        write_kv_block(pool_layer, k, v, block_tables, write_pos, scale_layer)
        if self.use_paged_kernel:
            # one launch covers the whole ragged batch: decode rows (q_lens=1),
            # prefill chunks (q_lens up to T) and inactive padding (q_lens=0)
            attn_out = ragged_paged_attention(
                q, pool_layer[0], pool_layer[1], block_tables,
                q_positions[:, 0].to(torch.int32).contiguous(), q_lens.to(torch.int32),
                k_scale=None if scale_layer is None else scale_layer[0],
                v_scale=None if scale_layer is None else scale_layer[1],
            )
        else:
            k_all, v_all = gather_kv(pool_layer, block_tables, scale_layer)
            attn_out = self._attend(q, k_all, v_all, q_positions, kv_len_mask)
        h = h + self._mm(attn["o_proj"], attn_out.reshape(B, T, self.n_heads * self.head_dim))

        x = rms_norm(h, lp["post_attention_layernorm"]["scale"], self.eps)
        mlp = lp["mlp"]
        act = F.silu(self._mm(mlp["gate_proj"], x)) * self._mm(mlp["up_proj"], x)
        return h + self._mm(mlp["down_proj"], act)

    @torch.no_grad()
    def _forward(self, pool: PagedKVPool, input_ids, block_tables, q_positions, kv_len_mask, write_pos,
                 last_pos, q_lens=None):
        """input_ids [B,T]; writes the fed tokens' K/V into ``pool`` and
        returns the logits at ``last_pos`` [B,V] (``last_pos=None``: [B,T,V]).
        ``q_lens`` [B] = valid new tokens per row (default T everywhere); only
        the kernel reads it, the plain path masks padded rows by position."""
        B, T = input_ids.shape
        if q_lens is None:
            q_lens = torch.full((B,), T, dtype=torch.int32, device=input_ids.device)
        block_tables = block_tables.to(torch.int32).contiguous()
        m = self.model.params["model"]
        embed = m["embed_tokens"]["embedding"]
        V = embed.shape[0]
        # out-of-range ids wrap then clamp, as JAX's indexing does: outside
        # input must never index past the table on the device
        ids = torch.where(input_ids < 0, input_ids + V, input_ids).clamp(0, V - 1)
        h = embed[ids.long()].to(self.dtype)
        if getattr(self.config, "scale_embeddings", False):
            h = h * torch.tensor(self.config.hidden_size**0.5, dtype=h.dtype)
        for i in range(len(self._layers)):
            h = self._layer(h, i, pool, block_tables, q_positions, kv_len_mask, write_pos, q_lens)
        h = rms_norm(h, m["norm"]["scale"], self.eps)
        last = h if last_pos is None else h[torch.arange(B, device=h.device), last_pos.long()]
        if "lm_head" in self.model.params:
            return last @ self.model.params["lm_head"]["kernel"].to(self.dtype)
        return last @ embed.T.to(self.dtype)

    # ------------------------------------------------------------------ entry points
    @torch.no_grad()
    def prefill(self, pool, input_ids, block_tables, suffix_lens, cached_lens, cached_counts, samp):
        """Batched prefill of [n, T_pad] SUFFIX sequences; samples the first
        token on device. Row j holds prompt tokens ``[cached_lens[j]:]``;
        attention reads the cached span from the shared blocks in
        ``block_tables`` and new KV is written from ``cached_lens[j]`` on.
        ``cached_counts`` [n, V] are the penalty counts of the cached span.

        Returns (tokens [n], counts [n, V] incl. prompt + sampled token)."""
        n, T = input_ids.shape
        dev = input_ids.device
        ar = torch.arange(T, device=dev)
        positions = cached_lens[:, None] + ar[None, :]
        total_lens = cached_lens + suffix_lens
        S = block_tables.shape[1] * self.block_size
        kv_len_mask = torch.arange(S, device=dev)[None, :] < total_lens[:, None]
        logits = self._forward(pool, input_ids, block_tables, positions, kv_len_mask, cached_lens,
                               torch.clamp_min(suffix_lens - 1, 0),  # last VALID token
                               q_lens=suffix_lens)
        V = cached_counts.shape[-1]
        counts = cached_counts + _count_tokens(input_ids, ar[None, :] < suffix_lens[:, None], V)
        tokens = sample_tokens(logits, positions=total_lens, counts=counts, **samp)
        return tokens, counts + F.one_hot(tokens.long(), V).to(torch.int32)

    @torch.no_grad()
    def mixed_step(self, pool, input_ids, block_tables, q_lens, q_start, counts, count_fed, emit, samp):
        """One ragged mixed prefill/decode step: row j feeds ``q_lens[j]`` new
        tokens from absolute position ``q_start[j]`` (a prefill chunk, a decode
        token, or nothing). Every row samples at ``q_start + q_lens``; the
        caller keeps the token only where ``emit`` is set. Rows with
        ``count_fed`` add their fed tokens to the running penalty counts; rows
        with ``emit`` add the sampled token.

        Returns (tokens [B], counts' [B, V])."""
        n, T = input_ids.shape
        dev = input_ids.device
        ar = torch.arange(T, device=dev)
        positions = q_start[:, None] + ar[None, :]
        S = block_tables.shape[1] * self.block_size
        kv_len_mask = torch.arange(S, device=dev)[None, :] < (q_start + q_lens)[:, None]
        logits = self._forward(pool, input_ids, block_tables, positions, kv_len_mask, q_start,
                               torch.clamp_min(q_lens - 1, 0), q_lens=q_lens)
        V = counts.shape[-1]
        fed = _count_tokens(input_ids, ar[None, :] < q_lens[:, None], V)
        counts = counts + fed * count_fed.to(torch.int32)[:, None]
        tokens = sample_tokens(logits, positions=q_start + q_lens, counts=counts, **samp)
        counts = counts + F.one_hot(tokens.long(), V).to(torch.int32) * emit.to(torch.int32)[:, None]
        return tokens, counts

    @torch.no_grad()
    def mixed_step_flat(self, pool, chunk_ids, chunk_tables, chunk_qlens, chunk_start, chunk_slots,
                        chunk_emit, dec_tokens, dec_tables, dec_start, dec_slots, dec_live, counts, samp):
        """Token-flattened ragged mixed step (the plain-path layout): prefill
        chunks keep their [C, T] matrix and decode rows collapse to [D, 1], so
        cost scales with the tokens fed. Rows map to engine slots through
        ``chunk_slots``/``dec_slots``; the slot-indexed penalty counts are
        updated by index-add. Dead padding rows write only into the sentinel
        block and add zeros.

        Returns (tokens [C + D] in segment order, counts')."""
        C, T = chunk_ids.shape
        dev = chunk_ids.device
        ar = torch.arange(T, device=dev)
        S = chunk_tables.shape[1] * self.block_size
        s_ar = torch.arange(S, device=dev)[None, :]
        logits_c = self._forward(pool, chunk_ids, chunk_tables, chunk_start[:, None] + ar[None, :],
                                 s_ar < (chunk_start + chunk_qlens)[:, None], chunk_start,
                                 torch.clamp_min(chunk_qlens - 1, 0), q_lens=chunk_qlens)
        D = dec_tokens.shape[0]
        logits_d = self._forward(pool, dec_tokens[:, None], dec_tables, dec_start[:, None],
                                 s_ar <= dec_start[:, None], dec_start,
                                 torch.zeros(D, dtype=torch.int32, device=dev),
                                 q_lens=dec_live.to(torch.int32))
        V = counts.shape[-1]
        counts = counts.index_add(0, chunk_slots.long(),
                                  _count_tokens(chunk_ids, ar[None, :] < chunk_qlens[:, None], V))
        rows = torch.cat([chunk_slots, dec_slots]).long()
        tokens = sample_tokens(torch.cat([logits_c, logits_d], dim=0),
                               positions=torch.cat([chunk_start + chunk_qlens, dec_start + 1]),
                               counts=counts[rows], **samp)
        emit_all = torch.cat([chunk_emit, dec_live]).to(torch.int32)
        counts = counts.index_add(0, rows, F.one_hot(tokens.long(), V).to(torch.int32) * emit_all[:, None])
        return tokens, counts

    @torch.no_grad()
    def decode(self, pool, tokens, block_tables, context_lens, done0, remaining, counts, samp):
        """Multi-step decode: advance every slot up to ``decode_steps`` tokens
        with sampling, penalties, eos and length stops on the device; the
        caller reads the ids and flags once. Finished rows freeze: ctx stops
        advancing and their KV slot is rewritten in place, never read again.

        Returns (tokens [steps, B], valid [steps, B], done, ctx, counts)."""
        B = tokens.shape[0]
        dev = tokens.device
        S = block_tables.shape[1] * self.block_size
        s_ar = torch.arange(S, device=dev)[None, :]
        V = counts.shape[-1]
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        tok, ctx, done, n_out = tokens, context_lens, done0, zeros
        toks, valid = [], []
        for _ in range(self.decode_steps):
            logits = self._forward(pool, tok[:, None], block_tables, ctx[:, None], s_ar <= ctx[:, None],
                                   ctx, zeros)
            nxt = sample_tokens(logits, positions=ctx + 1, counts=counts, **samp)
            emit = ~done
            hit_eos = (nxt[:, None] == self.eos_arr[None, :]).any(dim=-1)
            newly_done = emit & (hit_eos | (n_out + 1 >= remaining))
            nxt = torch.where(done, tok, nxt)
            counts = counts + F.one_hot(nxt.long(), V).to(counts.dtype) * emit.to(counts.dtype)[:, None]
            ctx = torch.where(done, ctx, ctx + 1)
            n_out = n_out + emit.to(torch.int32)
            done = done | newly_done
            tok = nxt
            toks.append(nxt)
            valid.append(emit)
        return torch.stack(toks), torch.stack(valid), done, ctx, counts
