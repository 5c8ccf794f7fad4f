"""Paged-attention inference forward for llama-family models.

PyTorch port of ``paddlenlp_tpu/experimental/inference_model.py``: a serving
forward that reuses the model's scanned ``[L]`` parameters and runs its own
loop over the layers against the paged KV pool. Where the JAX package traced
one jit per entry point and scanned the layers with ``lax.scan``, the port
runs eagerly: a Python loop over layers writing into the pool in place. The
multi-step decode keeps tokens, done flags and penalty counts on the device
for all ``decode_steps`` iterations; the caller syncs once per call. The
speculative ``verify`` is one forward over ``[B, K + 1]`` rows, the third row
class the ragged kernel serves beside prefill chunks and decode rows.

Attention takes one of two paths, chosen by ``use_paged_kernel`` (default: on
for a CUDA device): the CUDA ragged paged-attention kernel reading the pool
through the block tables, or the plain path that gathers each sequence's
blocks and attends in fp32 (the JAX package's XLA path, used on the CPU).

Multi-LoRA: every entry point takes the adapter pool's device copy (``lora``,
``{proj: {"A": [L, P, d_in, r], "B": [L, P, r, d_out]}}``, slot 0 the
identity zeros, scaling folded into B) and ``adapter_idx`` [B], each row's
slot. The rows' slices are gathered once a call (:func:`gather_lora`) and
each of the seven projections adds its row's delta
``(x_f32 @ A[idx]) @ B[idx]``, a batched product per row in fp32 cast to the
projection's dtype: a row's result depends on no other row. ``adapter_idx``
None (every row on the identity slot) skips the delta, which would add zeros.

``sample_tokens`` reproduces the JAX sampler exactly, including its random
draws: ``jax.random.categorical(fold_in(key(seed), position), row)`` is
rebuilt from threefry2x32 in integer ops (``utils/prng.py``: the partitionable
bit layout and the "low" Gumbel mode of ``jax.random``), so a seeded request
samples the same tokens in both packages.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import plain_softmax
from ..ops.paged_attention import ragged_paged_attention
from ..ops.rope import apply_rotary_pos_emb, rope_frequencies, rope_tables
from ..quantization.quantization_utils import linear
from ..transformers.llama.modeling import layer_params, rms_norm
from ..utils import prng
from .paged_cache import PagedKVPool, gather_kv, kv_slots, write_kv_block

__all__ = ["PagedInferenceModel", "gather_lora", "sample_tokens"]

def _uniform_rows(seeds, positions, V: int) -> torch.Tensor:
    """Row b: ``jax.random.uniform(fold_in(key(seeds[b]), positions[b]), (V,),
    minval=tiny, maxval=1.)`` in float32 (threefry, partitionable layout)."""
    zero = torch.zeros_like(seeds, dtype=torch.int64)
    k = prng.fold_in((zero, seeds.long() & prng.U32), positions)  # key(seed) = (0, seed)
    return prng.uniform(k, (V,), minval=prng.TINY, maxval=1.0)


def _gumbel_rows(seeds, positions, V: int) -> torch.Tensor:
    """Row b: ``jax.random.gumbel(fold_in(key(seeds[b]), positions[b]), (V,))``
    in float32 ("low" mode)."""
    return -torch.log(-torch.log(_uniform_rows(seeds, positions, V)))


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
    probs = plain_softmax(torch.where(keep_k, sorted_logits, neg_inf))
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


def gather_lora(lora, adapter_idx):
    """Each layer's adapter weights for each row: ``[{proj: (A [B, d_in, r],
    B [B, r, d_out])}]`` a layer, gathered from the device pool ``lora`` at the
    rows' slots ``adapter_idx`` [B]; None when either is None. Gathered once a
    call: the decode's sub-steps and verify's positions reuse the rows."""
    if lora is None or adapter_idx is None:
        return None
    idx = adapter_idx.long()
    L = next(iter(lora.values()))["A"].shape[0]
    return [{proj: (w["A"][i].index_select(0, idx), w["B"][i].index_select(0, idx)) for proj, w in lora.items()}
            for i in range(L)]


class PagedInferenceModel:
    """Prefill / decode / mixed steps over (params, paged pool). Llama-family
    only (llama/qwen2/mistral: config-driven biases + GQA + rope; as the JAX
    engine, it takes no sliding window, no MoE block and only the scanned
    layer tree)."""

    def __init__(self, model, block_size: int = 16, num_blocks: int = 512, max_blocks_per_seq: int = 64,
                 dtype=torch.bfloat16, decode_steps: int = 8, eos_ids=(), use_paged_kernel=None):
        if getattr(model, "returns_aux_loss", False):
            raise NotImplementedError(f"PagedInferenceModel serves dense llama/qwen2/mistral models, as the JAX "
                                      f"engine; {type(model).__name__} decodes with model.generate")
        if "layers" not in model.params.get("model", {}):  # the JAX engine's check (inference_model.py:98-99)
            raise ValueError("PagedInferenceModel requires the scanned-layer param layout (use_scan_layers)")
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
        # serving a QuantizedModel: its params carry qweight/scales (and a8w8
        # act_scale) leaves, stacked [L, ...]; _mm dispatches per projection
        self.quant_cfg = getattr(model, "quantization_config", None)
        self.bind_params()

    def bind_params(self):
        """Per-layer views of ``model.params``; called again after a weight
        swap rebinds the tree (the embedding, final norm and head are read
        from ``model.params`` on every call)."""
        layers = self.model.params["model"]["layers"]
        self._layers = [layer_params(layers, i) for i in range(self.config.num_hidden_layers)]

    def _mm(self, p, x, per_position: bool = False, lora=None, per_row: bool = False):
        """x [B, T, D] @ kernel (+ bias) through ``quantization.linear`` (over
        quantized leaves: a8w8's int8 product, or the dequantized weight-only
        kernel), plus the rows' LoRA delta when
        ``lora`` = (A [B, D, r], B [B, r, D_out]) fp32: ``(x_f32 @ A) @ B``
        per row, cast to the product's dtype (``_lora_mm`` of the JAX
        package). ``per_position``: one GEMM for each position t over the B
        rows, the delta's products included, so that every row meets the
        GEMMs the decode's [B, 1] step runs (cuBLAS picks its kernel, and with
        it the summation order, by the row count M). ``per_row``: the delta's
        products one row at a time, as a batch of one; cuBLAS picks the
        batched product's kernel, and with it the summation order over D, by
        the batch count, so a prefill row's delta would otherwise depend on
        how many rows share its launch."""
        if per_position and x.shape[1] > 1:
            return torch.cat([self._mm(p, x[:, t: t + 1].contiguous(), lora=lora) for t in range(x.shape[1])],
                             dim=1)
        y = linear(p, x, self.dtype, self.quant_cfg)
        if lora is not None:
            a, b = lora[0].float(), lora[1].float()
            xf = x.float()
            if per_row and x.shape[0] > 1:
                delta = torch.cat([torch.bmm(torch.bmm(xf[j: j + 1], a[j: j + 1]), b[j: j + 1])
                                   for j in range(x.shape[0])])
            else:
                delta = torch.bmm(torch.bmm(xf, a), b)
            y = y + delta.to(y.dtype)
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

    def _shared(self, pool: PagedKVPool, block_tables, q_positions, write_pos, q_lens, T):
        """What every layer of one forward reads alike, computed once a
        forward: the rope tables, the new tokens' places in the pool
        (:func:`kv_slots`), and the kernel's int32 row starts and lengths."""
        return dict(rope=rope_tables(q_positions, self.inv_freq),
                    slots=kv_slots(block_tables, write_pos, T, pool.kv.shape[-2]),
                    q_start=q_positions[:, 0].to(torch.int32).contiguous(), q_lens=q_lens.to(torch.int32))

    def _layer(self, h, i, pool: PagedKVPool, block_tables, q_positions, kv_len_mask, write_pos, q_lens,
               per_position=False, lora_rows=None, per_row=False, shared=None):
        """Decoder layer ``i``: writes this step's K/V into the pool's layer
        ``i`` in place and returns the new hidden states. ``lora_rows``: this
        layer's entry of :func:`gather_lora`; ``shared``: :meth:`_shared` of
        the forward (computed here when None)."""
        if shared is None:
            shared = self._shared(pool, block_tables, q_positions, write_pos, q_lens, h.shape[1])
        lp = self._layers[i]
        B, T, _ = h.shape
        rows = lora_rows or {}
        attn, mlp = lp["self_attn"], lp["mlp"]
        mm = lambda mod, name, x: self._mm(mod[name], x, per_position, rows.get(name), per_row)  # noqa: E731
        x = rms_norm(h, lp["input_layernorm"]["scale"], self.eps)
        q = mm(attn, "q_proj", x).reshape(B, T, self.n_heads, self.head_dim)
        k = mm(attn, "k_proj", x).reshape(B, T, self.n_kv, self.head_dim)
        v = mm(attn, "v_proj", x).reshape(B, T, self.n_kv, self.head_dim)
        q, k = apply_rotary_pos_emb(q, k, *shared["rope"])

        pool_layer = pool.kv[i]
        scale_layer = None if pool.scale is None else pool.scale[i]
        write_kv_block(pool_layer, k, v, block_tables, write_pos, scale_layer, slots=shared["slots"])
        if self.use_paged_kernel:
            # one launch covers the whole ragged batch: decode rows (q_lens=1),
            # prefill chunks (q_lens up to T) and inactive padding (q_lens=0)
            attn_out = ragged_paged_attention(
                q, pool_layer[0], pool_layer[1], block_tables, shared["q_start"], shared["q_lens"],
                k_scale=None if scale_layer is None else scale_layer[0],
                v_scale=None if scale_layer is None else scale_layer[1],
            )
        else:
            k_all, v_all = gather_kv(pool_layer, block_tables, scale_layer)
            attn_out = self._attend(q, k_all, v_all, q_positions, kv_len_mask)
        h = h + mm(attn, "o_proj", attn_out.reshape(B, T, self.n_heads * self.head_dim))

        x = rms_norm(h, lp["post_attention_layernorm"]["scale"], self.eps)
        act = F.silu(mm(mlp, "gate_proj", x)) * mm(mlp, "up_proj", x)
        return h + mm(mlp, "down_proj", act)

    @torch.no_grad()
    def _forward(self, pool: PagedKVPool, input_ids, block_tables, q_positions, kv_len_mask, write_pos,
                 last_pos, q_lens=None, per_position=False, lora_rows=None, per_row=False):
        """input_ids [B,T]; writes the fed tokens' K/V into ``pool`` and
        returns the logits at ``last_pos`` [B,V] (``last_pos=None``: [B,T,V]).
        ``q_lens`` [B] = valid new tokens per row (default T everywhere); only
        the kernel reads it, the plain path masks padded rows by position.
        ``per_position`` runs every projection as one GEMM a position (see
        :meth:`_mm`). ``lora_rows``: the rows' adapter weights
        (:func:`gather_lora`), None for none; ``per_row`` computes their
        deltas one row at a time (see :meth:`_mm`)."""
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
        shared = self._shared(pool, block_tables, q_positions, write_pos, q_lens, T)
        for i in range(len(self._layers)):
            h = self._layer(h, i, pool, block_tables, q_positions, kv_len_mask, write_pos, q_lens, per_position,
                            None if lora_rows is None else lora_rows[i], per_row, shared)
        h = rms_norm(h, m["norm"]["scale"], self.eps)
        last = h if last_pos is None else h[torch.arange(B, device=h.device), last_pos.long()]
        head = self.model.params["lm_head"]["kernel"] if "lm_head" in self.model.params else embed.T
        if last.dim() == 3:
            return self._mm({"kernel": head}, last, per_position)
        return last @ head.to(self.dtype)

    # ------------------------------------------------------------------ entry points
    @torch.no_grad()
    def prefill(self, pool, input_ids, block_tables, suffix_lens, cached_lens, cached_counts, samp, lora=None,
                adapter_idx=None):
        """Batched prefill of [n, T_pad] SUFFIX sequences; samples the first
        token on device. Row j holds prompt tokens ``[cached_lens[j]:]``;
        attention reads the cached span from the shared blocks in
        ``block_tables`` and new KV is written from ``cached_lens[j]`` on.
        ``cached_counts`` [n, V] are the penalty counts of the cached span.

        The rows' LoRA deltas are computed one row at a time (``per_row``):
        the prefill's row count is the bucket of the admitted group, so a
        batched product's summation order would depend on who else arrived.

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
                               q_lens=suffix_lens, lora_rows=gather_lora(lora, adapter_idx), per_row=True)
        V = cached_counts.shape[-1]
        counts = cached_counts + _count_tokens(input_ids, ar[None, :] < suffix_lens[:, None], V)
        tokens = sample_tokens(logits, positions=total_lens, counts=counts, **samp)
        return tokens, counts + F.one_hot(tokens.long(), V).to(torch.int32)

    @torch.no_grad()
    def mixed_step(self, pool, input_ids, block_tables, q_lens, q_start, counts, count_fed, emit, samp, lora=None,
                   adapter_idx=None):
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
                               torch.clamp_min(q_lens - 1, 0), q_lens=q_lens,
                               lora_rows=gather_lora(lora, adapter_idx))
        V = counts.shape[-1]
        fed = _count_tokens(input_ids, ar[None, :] < q_lens[:, None], V)
        counts = counts + fed * count_fed.to(torch.int32)[:, None]
        tokens = sample_tokens(logits, positions=q_start + q_lens, counts=counts, **samp)
        counts = counts + F.one_hot(tokens.long(), V).to(torch.int32) * emit.to(torch.int32)[:, None]
        return tokens, counts

    @torch.no_grad()
    def mixed_step_flat(self, pool, chunk_ids, chunk_tables, chunk_qlens, chunk_start, chunk_slots,
                        chunk_emit, dec_tokens, dec_tables, dec_start, dec_slots, dec_live, counts, samp,
                        lora=None, chunk_adapter=None, dec_adapter=None):
        """Token-flattened ragged mixed step (the plain-path layout): prefill
        chunks keep their [C, T] matrix and decode rows collapse to [D, 1], so
        cost scales with the tokens fed. Rows map to engine slots through
        ``chunk_slots``/``dec_slots``; the slot-indexed penalty counts are
        updated by index-add. Dead padding rows write only into the sentinel
        block and add zeros. Each segment has its rows' adapter slots
        (``chunk_adapter``/``dec_adapter``).

        Returns (tokens [C + D] in segment order, counts')."""
        C, T = chunk_ids.shape
        dev = chunk_ids.device
        ar = torch.arange(T, device=dev)
        S = chunk_tables.shape[1] * self.block_size
        s_ar = torch.arange(S, device=dev)[None, :]
        logits_c = self._forward(pool, chunk_ids, chunk_tables, chunk_start[:, None] + ar[None, :],
                                 s_ar < (chunk_start + chunk_qlens)[:, None], chunk_start,
                                 torch.clamp_min(chunk_qlens - 1, 0), q_lens=chunk_qlens,
                                 lora_rows=gather_lora(lora, chunk_adapter))
        D = dec_tokens.shape[0]
        logits_d = self._forward(pool, dec_tokens[:, None], dec_tables, dec_start[:, None],
                                 s_ar <= dec_start[:, None], dec_start,
                                 torch.zeros(D, dtype=torch.int32, device=dev),
                                 q_lens=dec_live.to(torch.int32), lora_rows=gather_lora(lora, dec_adapter))
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
    def decode(self, pool, tokens, block_tables, context_lens, done0, remaining, counts, samp, lora=None,
               adapter_idx=None):
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
        lora_rows = gather_lora(lora, adapter_idx)
        for _ in range(self.decode_steps):
            logits = self._forward(pool, tok[:, None], block_tables, ctx[:, None], s_ar <= ctx[:, None],
                                   ctx, zeros, lora_rows=lora_rows)
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

    @torch.no_grad()
    def verify(self, pool, tokens, block_tables, start_pos, need_logits: bool = True, lora=None,
               adapter_idx=None):
        """Speculative-decoding verify: one forward over ``[last_token, d_1..d_K]``
        (``_verify_impl`` of the JAX package). tokens [B, K+1] (the last
        accepted token then the drafts, 0-padded); start_pos [B] the absolute
        position of tokens[:, 0]. K/V is written for every fed position,
        drafts past a row's real draft length included: rejected positions
        need no rollback, they are masked by position until a later step
        overwrites them. Returns (argmax [B, K+1] int32, logits [B, K+1, V]
        fp32 or None): position i scores the token after tokens[:, i]. Greedy
        acceptance reads only the argmax, so ``need_logits=False`` never
        materializes the fp32 logits.

        Every projection runs as one [B, D] GEMM a position (its LoRA delta
        too), the shape of the decode's: each row then takes the decode's summation order, and the
        tokens greedy speculation emits are the ones the plain decode emits,
        bit for bit. One [B(K+1), D] GEMM would read the weights once instead
        of K+1 times, but cuBLAS picks another kernel for it: on an H100 at
        Qwen2-7B's widths in bf16 that moved the logits by up to 0.2 and
        flipped the argmax of one row in eight."""
        B, T = tokens.shape
        dev = tokens.device
        positions = start_pos[:, None] + torch.arange(T, device=dev)[None, :]
        S = block_tables.shape[1] * self.block_size
        kv_len_mask = torch.arange(S, device=dev)[None, :] <= (start_pos[:, None] + T - 1)
        logits = self._forward(pool, tokens, block_tables, positions, kv_len_mask, start_pos, None,
                               per_position=True, lora_rows=gather_lora(lora, adapter_idx))
        argmax = logits.argmax(dim=-1).to(torch.int32)
        return argmax, (logits.float() if need_logits else None)
