"""The port's ragged paged attention (its plain version, which the CPU runs)
against the JAX package's Pallas kernel in interpret mode.

Tolerance: atol 2e-5 in fp32, the tolerance of the JAX package's own kernel
tests (``tests/experimental/test_paged_inference.py``): the two compute the
same masked softmax in fp32 and differ only in summation order (online softmax
over blocks in the kernel, one softmax over the gathered row in the port).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.experimental.paged_cache import quantize_kv as jax_quantize_kv
from paddlenlp_tpu.ops.pallas.paged_attention import paged_decode_attention as jax_decode
from paddlenlp_tpu.ops.pallas.paged_attention import ragged_paged_attention as jax_ragged
from paddlenlp_tpu_torch.ops import paged_attention as pa
from torch_tf32 import mm_tf32

ATOL = 2e-5


def _inputs(seed, B, T, N, K, H, nb, bs, mb, tables=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, N, H)).astype(np.float32)
    pk = rng.standard_normal((nb, K, bs, H)).astype(np.float32)
    pv = rng.standard_normal((nb, K, bs, H)).astype(np.float32)
    if tables is None:
        tables = rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb)
    return q, pk, pv, np.asarray(tables, np.int32)


def _t(a):
    """numpy (incl. ml_dtypes float8) -> torch, bit for bit."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _compare(q, pk, pv, tables, q_start, q_lens, k_scale=None, v_scale=None):
    q_start, q_lens = np.asarray(q_start, np.int32), np.asarray(q_lens, np.int32)
    want = np.asarray(jax_ragged(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
                                 jnp.asarray(q_start), jnp.asarray(q_lens), interpret=True,
                                 k_scale=None if k_scale is None else jnp.asarray(k_scale),
                                 v_scale=None if v_scale is None else jnp.asarray(v_scale)))
    got = pa.ragged_paged_attention_ref(_t(q), _t(pk), _t(pv), _t(tables), _t(q_start), _t(q_lens),
                                        k_scale=None if k_scale is None else _t(k_scale),
                                        v_scale=None if v_scale is None else _t(v_scale)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


def test_mixed_chunk_decode_dead_rows():
    """A mid-prompt chunk, a decode row (q_lens=1) and an inactive row
    (q_lens=0) in one call; dead rows are exact zeros."""
    args = _inputs(2, B=3, T=8, N=4, K=2, H=64, nb=16, bs=8, mb=5)
    got = _compare(*args, q_start=[9, 22, 0], q_lens=[8, 1, 0])
    assert np.all(got[2] == 0.0)
    assert np.all(got[1, 1:] == 0.0)


def test_chunk_on_block_boundary():
    """q_start on an exact block boundary: the chunk's first kv block is fully
    visible, later in-chunk positions unmask one column at a time."""
    args = _inputs(3, B=1, T=8, N=2, K=2, H=64, nb=10, bs=8, mb=4, tables=[[3, 7, 1, 5]])
    _compare(*args, q_start=[8], q_lens=[8])


def test_group6_head128_ppo_fold():
    """PPO's rollout fold (Qwen2-1.5B's attention: 6 query heads per kv head,
    head_dim 128, block 16): a chunk at 126, decode rows at contexts 130-290
    and a dead row."""
    q, pk, pv, tables, q_start, q_lens = (x.numpy() for x in _ppo_batch(12, torch.float32))
    got = _compare(q, pk, pv, tables, q_start, q_lens)
    assert np.all(got[4] == 0.0) and np.all(got[1:4, 1:] == 0.0)


def test_group7_head128_bs16():
    """Qwen2-7B's attention geometry at a tiny size: 7 query heads per kv head
    (a fold that is not a power of two), head_dim 128, block 16."""
    args = _inputs(4, B=3, T=5, N=14, K=2, H=128, nb=16, bs=16, mb=5)
    got = _compare(*args, q_start=[3, 40, 16], q_lens=[5, 1, 0])
    assert np.all(got[2] == 0.0) and np.all(got[1, 1:] == 0.0)


@pytest.mark.parametrize("qdtype", [jnp.int8, jnp.float8_e4m3fn])
def test_quantized_pool_scales(qdtype):
    """int8 / fp8 pools with per-token-per-head scales, dequantized in fp32."""
    q, pk, pv, tables = _inputs(5, B=2, T=3, N=4, K=2, H=64, nb=12, bs=8, mb=4)
    pk_q, pk_s = jax_quantize_kv(jnp.asarray(pk), qdtype)
    pv_q, pv_s = jax_quantize_kv(jnp.asarray(pv), qdtype)
    _compare(q, np.asarray(pk_q), np.asarray(pv_q), tables, [7, 20], [3, 1],
             k_scale=np.asarray(pk_s), v_scale=np.asarray(pv_s))


def test_decode_wrapper():
    q, pk, pv, tables = _inputs(6, B=2, T=1, N=4, K=2, H=64, nb=12, bs=8, mb=4)
    ctx = np.asarray([7, 22], np.int32)
    want = np.asarray(jax_decode(jnp.asarray(q[:, 0]), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
                                 jnp.asarray(ctx), interpret=True))
    got = pa.paged_decode_attention(_t(q[:, 0]), _t(pk), _t(pv), _t(tables), _t(ctx))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ragged = pa.ragged_paged_attention(_t(q), _t(pk), _t(pv), _t(tables), _t(ctx),
                                       torch.ones(2, dtype=torch.int32))[:, 0]
    torch.testing.assert_close(got, ragged, atol=0, rtol=0)


def test_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper is the plain version, and launches nothing."""
    q, pk, pv, tables = _inputs(7, B=2, T=4, N=4, K=2, H=64, nb=12, bs=8, mb=4)
    args = (_t(q), _t(pk), _t(pv), _t(tables), _t(np.asarray([0, 9], np.int32)), _t(np.asarray([4, 2], np.int32)))
    before = pa.LAUNCHES
    got = pa.ragged_paged_attention(*args)
    assert pa.LAUNCHES == before
    torch.testing.assert_close(got, pa.ragged_paged_attention_ref(*args), atol=0, rtol=0)


# ----------------------------------------------------------------- the Hopper route's arithmetic
def _bf16(x, parts):
    """x through bf16 operands: one rounding, or the sum of a bf16 high part
    and the bf16 rounding of what it left out (``parts=2``); ``parts=0``
    leaves x unrounded."""
    if parts == 0:
        return x
    hi = x.bfloat16().float()
    return hi if parts == 1 else hi + (x - hi).bfloat16().float()


def _sm90_emulation(q, pk, pv, tables, q_start, q_lens, parts, part_len, p_parts=2, tile=64,
                    k_scale=None, v_scale=None):
    """``paged_attention_sm90.cu`` step by step in torch: every (sequence, kv
    head) folds its query heads into rows t * group + g; each kv partition
    walks its 64-position tiles up to its rows' highest live position with an
    online softmax in fp32 (exp2 of scores times scale * log2(e)), P in
    ``p_parts`` bf16 operands of P.V and the row sum of fp32 P, and keeps
    (max, sum, unnormalised rows); the partitions then merge in fp32 in
    partition order. Products accumulate in fp32, as the tensor cores do.
    A quantized pool (``k_scale``/``v_scale`` given) is read as its raw
    values, widened exactly; S's column c is multiplied by its K scale before
    the mask, P's column c by its V scale before the bf16 split, and the row
    sum stays over P."""
    B, T, N, H = q.shape
    _nb, K, bs, _ = pk.shape
    group, cap = N // K, tables.shape[1] * bs
    sl2 = H**-0.5 * math.log2(math.e)
    out = torch.zeros(B, T, N, H)
    for b in range(B):
        qlen = min(int(q_lens[b]), T)
        if qlen == 0:
            continue
        blocks = tables[b].long()
        for kh in range(K):
            k = pk[blocks, kh].reshape(cap, H).float()
            v = pv[blocks, kh].reshape(cap, H).float()
            ones = torch.ones(cap)
            ks = ones if k_scale is None else k_scale[blocks, kh].reshape(cap)
            vs = ones if v_scale is None else v_scale[blocks, kh].reshape(cap)
            rows = q[b, :qlen, kh * group:(kh + 1) * group].reshape(qlen * group, H).float()
            lim = torch.clamp_max(int(q_start[b]) + torch.arange(qlen).repeat_interleave(group), cap - 1)
            hi = int(lim.max())
            ms, ls, os_ = [], [], []
            for p in range(parts):
                if p * part_len > hi:
                    break
                m = torch.full((len(rows),), pa.NEG_INF)
                l = torch.zeros(len(rows))
                o = torch.zeros(len(rows), H)
                for c0 in range(p * part_len, min((p + 1) * part_len, hi + 1), tile):
                    s = (rows @ k[c0:c0 + tile].T) * ks[c0:c0 + tile]
                    s = torch.where(torch.arange(c0, c0 + tile)[None, :] <= lim[:, None], s,
                                    torch.full_like(s, pa.NEG_INF))
                    mn = torch.maximum(m, s.amax(-1))
                    mu = torch.where(mn == pa.NEG_INF, torch.zeros_like(mn), mn * sl2)
                    a = torch.exp2(m * sl2 - mu)
                    pr = torch.exp2(s * sl2 - mu[:, None])
                    l = l * a + pr.sum(-1)
                    o = o * a[:, None] + _bf16(pr * vs[c0:c0 + tile], p_parts) @ v[c0:c0 + tile]
                    m = mn
                ms.append(torch.where(m == pa.NEG_INF, m, m * sl2))
                ls.append(l)
                os_.append(o)
            mu = torch.stack(ms).amax(0)
            acc, den = torch.zeros(len(rows), H), torch.zeros(len(rows))
            for m, l, o in zip(ms, ls, os_):  # in partition order
                w = torch.exp2(m - mu)
                den = den + w * l
                acc = acc + w[:, None] * o
            res = acc / torch.clamp_min(den, 1e-37)[:, None]
            out[b, :qlen, kh * group:(kh + 1) * group] = res.reshape(qlen, group, H)
    return out


def _serving_batch(seed, dtype):
    """Qwen2-7B's fold at a small width: group 7 (14 query heads over 2 kv
    heads), head_dim 128, block 16, tables of 2,048 positions; decode rows at
    contexts 256, 1,024 and 2,048, a 6-token chunk at 2,000, a dead row."""
    q, pk, pv, tables = _inputs(seed, B=5, T=6, N=14, K=2, H=128, nb=641, bs=16, mb=128)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    return (t(q), t(pk), t(pv), torch.from_numpy(tables), torch.tensor([255, 1023, 2047, 2000, 7], dtype=torch.int32),
            torch.tensor([1, 1, 1, 6, 0], dtype=torch.int32))


def _ppo_batch(seed, dtype):
    """PPO's rollout fold at a small batch: group 6 (12 query heads over 2 kv
    heads, Qwen2-1.5B's), head_dim 128, block 16, tables of 304 positions; a
    4-token chunk at 126, decode rows at contexts 130, 200 and 290, a dead
    row."""
    q, pk, pv, tables = _inputs(seed, B=5, T=4, N=12, K=2, H=128, nb=96, bs=16, mb=19)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)  # noqa: E731
    return (t(q), t(pk), t(pv), torch.from_numpy(tables), torch.tensor([126, 129, 199, 289, 5], dtype=torch.int32),
            torch.tensor([4, 1, 1, 1, 0], dtype=torch.int32))


def test_sm90_roundings_and_partitions_fit_the_chip_gate():
    """The Hopper route's arithmetic (kv partitions from ``kv_partitions`` at
    this launch's shape, P in two bf16 parts, the fp32 merge in partition
    order) against the plain version under ``chip_smoke.py``'s elementwise
    gate for bf16 outputs; dead rows exact zeros. One bf16 part of P is
    printed beside."""
    import chip_smoke

    q, pk, pv, tables, q_start, q_lens = _serving_batch(8, torch.bfloat16)
    parts, part_len = pa.kv_partitions(5, 6, 14, 2, 128, 16)
    assert parts > 1  # this decode-heavy launch takes the split walk
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens).float()
    rtol, atol = chip_smoke.KERNEL_TOL["bfloat16"]
    worst = {}
    for p_parts in (2, 1):
        got = _sm90_emulation(q, pk, pv, tables, q_start, q_lens, parts, part_len, p_parts).bfloat16().float()
        worst[p_parts] = ((got - want).abs() / (rtol * want.abs() + atol)).max().item()
        if p_parts == 2:
            assert torch.all(got[4] == 0) and torch.all(got[:3, 1:] == 0)
    print("paged sm90 worst over the gate:", {f"P in {k} bf16 parts": round(w, 3) for k, w in worst.items()})
    assert worst[2] <= 1.0


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_sm90_quantized_scale_fold_fits_the_chip_gate(quant):
    """The Hopper route over an int8 or fp8 pool: the raw values through the
    bf16 wgmmas, K scales on S's columns, V scales in P before its two-part
    bf16 split, the row sum over P, at this launch's kv partitions, against
    the plain version (which dequantizes K and V in fp32) under
    ``chip_smoke.py``'s elementwise gate for bf16 outputs; dead rows exact
    zeros."""
    import chip_smoke

    from paddlenlp_tpu_torch.experimental.paged_cache import quantize_kv

    q, pk, pv, tables, q_start, q_lens = _serving_batch(10, torch.bfloat16)
    qdtype = torch.int8 if quant == "int8" else torch.float8_e4m3fn
    (pk, ks), (pv, vs) = quantize_kv(pk, qdtype), quantize_kv(pv, qdtype)
    parts, part_len = pa.kv_partitions(5, 6, 14, 2, 128, 16)
    assert parts > 1
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs).float()
    got = _sm90_emulation(q, pk, pv, tables, q_start, q_lens, parts, part_len, k_scale=ks,
                          v_scale=vs).bfloat16().float()
    rtol, atol = chip_smoke.KERNEL_TOL["bfloat16"]
    worst = ((got - want).abs() / (rtol * want.abs() + atol)).max().item()
    print(f"paged sm90 over {quant}: worst over the gate {worst:.3f}")
    assert worst <= 1.0
    assert torch.all(got[4] == 0) and torch.all(got[:3, 1:] == 0)


@pytest.mark.parametrize("q_dtype,kv_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "sm90"), (torch.bfloat16, torch.int8, "sm90_quant"),
    (torch.bfloat16, torch.float8_e4m3fn, "sm90_quant"), (torch.float32, torch.float32, "sm90_f32"),
    (torch.float32, torch.bfloat16, "sm90_f32"), (torch.float32, torch.int8, "sm90_f32"),
    (torch.float32, torch.float8_e4m3fn, "sm90_f32"), (torch.bfloat16, torch.float32, "sm90_f32")])
def test_kernel_route(q_dtype, kv_dtype, route):
    """bf16 queries over a bf16, int8 or fp8 pool take the bf16 wgmma kernel;
    fp32 queries, or an fp32 pool, the fp32 route (3xTF32 products, the
    precise check)."""
    assert pa.kernel_route(q_dtype, kv_dtype) == route


# ----------------------------------------------------------------- the fp32 route's arithmetic
def _sm90_f32_emulation(q, pk, pv, tables, q_start, q_lens, parts, part_len, passes=3, k_scale=None, v_scale=None):
    """The fp32 route of ``paged_attention_sm90.cu`` step by step in torch, in
    fp32: per (sequence, kv head), tiles of 128 folded rows; each kv
    partition walks its 64-position tiles up to the tile's highest live
    position with S = Q K^T and O += P V from TF32 operands
    (:func:`torch_tf32.mm_tf32`); a tile with 16 or fewer live rows runs its first 16
    rows on eight warps of 8 columns each, every warp with its own online
    softmax (exp2 of scores times scale * log2(e)), combined in warp order
    (a warp that saw nothing of a row adds nothing); otherwise one softmax a
    row over the whole tile. The partitions then merge in partition order
    over each row's live ones. A quantized pool is read as its raw values:
    S's column c times its K scale before the mask, P's column c times its V
    scale before the split, the row sum over P."""
    B, T, N, H = q.shape
    _nb, K, bs, _ = pk.shape
    group, cap, rows_total = N // K, tables.shape[1] * bs, T * (N // K)
    padded = -(-cap // 64) * 64
    sl2 = H**-0.5 * math.log2(math.e)
    neg = pa.NEG_INF
    out = torch.zeros(B, T, N, H)
    for b in range(B):
        qlen = min(int(q_lens[b]), T)
        blocks = tables[b].long()
        tq = torch.arange(rows_total) // group
        lim = torch.where(tq < qlen, torch.clamp_max(int(q_start[b]) + tq, cap - 1), torch.full_like(tq, -1))

        def walked(pool, sc, kh):  # [padded, H] fp32 raw values and [padded] scales (1 for a float pool)
            x = torch.zeros(padded, H)
            x[:cap] = pool[blocks, kh].reshape(cap, H).float()
            s = torch.ones(padded)
            if sc is not None:
                s[:cap] = sc[blocks, kh].reshape(cap)
            return x, s

        for kh in range(K):
            (k, ks), (v, vs) = walked(pk, k_scale, kh), walked(pv, v_scale, kh)
            rows_q = q[b, :, kh * group:(kh + 1) * group].reshape(rows_total, H).float()
            res = torch.zeros(rows_total, H)
            for row0 in range(0, rows_total, 128):
                lim_t = lim[row0:row0 + 128]
                hi = int(lim_t.max())
                if hi < 0:
                    continue
                cw = 8 if int((lim_t >= 0).sum()) <= 16 else 1
                n, nc = (16, 8) if cw == 8 else (len(lim_t), 64)
                rows, lrow = rows_q[row0:row0 + n], lim_t[:n]
                n = len(rows)
                ms, ls, os_ = [], [], []
                for p in range(parts):
                    if p * part_len > hi:
                        break
                    m, l, o = torch.full((n, cw), neg), torch.zeros(n, cw), torch.zeros(n, cw, H)
                    for c0 in range(p * part_len, min((p + 1) * part_len, hi + 1), 64):
                        s = mm_tf32(rows, k[c0:c0 + 64].T, passes) * ks[c0:c0 + 64]
                        s = torch.where(torch.arange(c0, c0 + 64)[None, :] <= lrow[:, None], s, torch.full_like(s, neg))
                        s = s.reshape(n, cw, nc)
                        mn = torch.maximum(m, s.amax(-1))
                        mu = torch.where(mn == neg, torch.zeros_like(mn), mn * sl2)
                        a = torch.exp2(m * sl2 - mu)
                        pr = torch.exp2(s * sl2 - mu[..., None])
                        l = l * a + pr.sum(-1)
                        pv_ = (pr * vs[c0:c0 + 64].reshape(cw, nc)).transpose(0, 1)  # [cw, n, nc]
                        o = o * a[..., None] + mm_tf32(pv_, v[c0:c0 + 64].reshape(cw, nc, H), passes).transpose(0, 1)
                        m = mn
                    mu = m.amax(-1)  # the block's combine of its warps, in warp order
                    w = torch.where(m == neg, torch.zeros_like(m), torch.exp2(m * sl2 - (mu * sl2)[:, None]))
                    den, acc = torch.zeros(n), torch.zeros(n, H)
                    for c in range(cw):
                        den = den + w[:, c] * l[:, c]
                        acc = acc + w[:, c, None] * o[:, c]
                    ms.append(torch.where(mu == neg, mu, mu * sl2))
                    ls.append(den)
                    os_.append(acc)
                if parts == 1:
                    got = os_[0] / torch.clamp_min(ls[0], 1e-37)[:, None]
                else:  # in partition order over the partitions each row's positions reach
                    live = torch.clamp(torch.div(lrow, part_len, rounding_mode="floor") + 1, 0, parts)
                    mu = torch.full((n,), neg)
                    for i, mp in enumerate(ms):
                        mu = torch.where(i < live, torch.maximum(mu, mp), mu)
                    den, acc = torch.zeros(n), torch.zeros(n, H)
                    for i, (mp, lp, op) in enumerate(zip(ms, ls, os_)):
                        w = torch.where(i < live, torch.exp2(mp - mu), torch.zeros_like(mu))
                        den = den + w * lp
                        acc = acc + w[:, None] * op
                    got = acc / torch.clamp_min(den, 1e-37)[:, None]
                res[row0:row0 + n] = got
            out[b, :, kh * group:(kh + 1) * group] = res.reshape(T, group, H)
    return out


@pytest.mark.parametrize("pool", ["fp32", "int8", "fp8", "bf16 q"])
@pytest.mark.parametrize("fold", ["qwen2_7b", "ppo"])
def test_sm90_f32_3xtf32_fits_the_chip_gate(fold, pool):
    """The fp32 route's arithmetic (3xTF32 products, 64-position tiles,
    eight-warp column split on decode rows, the partitions of
    ``kv_partitions`` at this launch's shape merged in order) against the
    plain version under ``chip_smoke.py``'s fp32 gate (|err| <= 1e-4), at
    Qwen2-7B's fold (group 7) and PPO's (group 6), over an fp32, int8 or fp8
    pool and for bf16 queries over an fp32 pool (held in fp32 before the
    output's bf16 rounding); dead rows exact zeros. Over an fp32 pool one
    TF32 pass is printed beside it, not gated."""
    import chip_smoke

    from paddlenlp_tpu_torch.experimental.paged_cache import quantize_kv

    batch = _serving_batch if fold == "qwen2_7b" else _ppo_batch
    q, pk, pv, tables, q_start, q_lens = batch(11, torch.float32)
    ks = vs = None
    if pool == "bf16 q":
        q = q.bfloat16().float()  # the kernel reads bf16 q exactly as these fp32 values
    elif pool != "fp32":
        qdtype = torch.int8 if pool == "int8" else torch.float8_e4m3fn
        (pk, ks), (pv, vs) = quantize_kv(pk, qdtype), quantize_kv(pv, qdtype)
    B, T, N, H = q.shape
    parts, part_len = pa.kv_partitions(B, T, N, pk.shape[1], tables.shape[1], pk.shape[2], route="sm90_f32")
    assert parts > 1  # these decode-heavy launches take the split walk
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    rtol, atol = chip_smoke.KERNEL_TOL["float32"]
    worst = {}
    for passes in (3, 1) if pool == "fp32" else (3,):
        got = _sm90_f32_emulation(q, pk, pv, tables, q_start, q_lens, parts, part_len, passes, k_scale=ks,
                                  v_scale=vs)
        worst[passes] = ((got - want).abs() / (rtol * want.abs() + atol)).max().item()
        if passes == 3:
            for b, qlen in enumerate(q_lens.tolist()):
                assert torch.all(got[b, qlen:] == 0), b
    print(f"paged sm90_f32 {fold} over {pool}: worst over the fp32 gate",
          {f"{k} TF32 pass{'es' if k > 1 else ''}": round(w, 4) for k, w in worst.items()})
    assert worst[3] <= 1.0


@pytest.mark.parametrize("parts", range(1, 9))
def test_sm90_partition_merge_is_exact(parts):
    """The partitions' merge alone: fp32 inputs and P unrounded, split into 1
    to 8 partitions, equal the plain version to 1e-6."""
    q, pk, pv, tables, q_start, q_lens = _serving_batch(9, torch.float32)
    part_len = -(-2048 // (parts * 64)) * 64
    got = _sm90_emulation(q, pk, pv, tables, q_start, q_lens, -(-2048 // part_len), part_len, p_parts=0)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_kv_partitions():
    """Engine decode (8 rows x 4 kv heads, tables of 4,096 positions) splits
    into partitions that leave >= 2 live blocks on each of 132 SMs at contexts
    256-2,112; prefill chunks fill the grid and take one partition; every
    split covers the tables' capacity in whole 64-position tiles."""
    parts, part_len = pa.kv_partitions(8, 1, 28, 4, 256, 16)
    assert (parts, part_len) == (32, 128)
    contexts = np.linspace(256, 2112, 8).astype(int)
    live = sum(-(-int(c) // part_len) for c in contexts) * 4
    assert live >= 2 * 132, live
    assert pa.kv_partitions(8, 512, 28, 4, 256, 16) == (1, 4096)
    assert pa.kv_partitions(2, 2048, 28, 4, 256, 16) == (1, 4096)
    rng = np.random.default_rng(0)
    for _ in range(200):
        B, T, K = (int(x) for x in rng.integers(1, 9, 3))
        N, mb, bs = K * int(rng.integers(1, 8)), int(rng.integers(1, 300)), int(rng.integers(1, 65))
        parts, part_len = pa.kv_partitions(B, T, N, K, mb, bs)
        assert part_len % 64 == 0 and parts >= 1 and parts * part_len >= mb * bs > (parts - 1) * part_len
        tiles = -(-T * (N // K) // 64) * K * B
        assert parts == 1 or tiles * parts <= 8 * 132 + tiles, (B, T, N, K, mb, bs, parts)


def test_kv_partitions_f32_route():
    """The fp32 route's blocks hold 128 folded rows, one resident an SM: a
    decode launch (PPO's 8 rows x 2 kv heads, Qwen2-7B's 8 x 4, tables of
    4,096 positions) splits into about four blocks an SM, where the bf16
    routes' rule (64-row blocks, two an SM) gave twice the partitions, and
    PPO's prefill [8, 256, 12, 128] (192 blocks) fills the SMs and takes
    one partition."""
    assert pa.kv_partitions(8, 1, 12, 2, 256, 16, route="sm90_f32") == (32, 128)
    assert pa.kv_partitions(8, 1, 28, 4, 256, 16, route="sm90_f32") == (16, 256)
    assert pa.kv_partitions(8, 256, 12, 2, 256, 16, route="sm90_f32") == (1, 4096)
    assert pa.kv_partitions(8, 1, 12, 2, 256, 16) == (64, 64)
    assert pa.kv_partitions(8, 1, 28, 4, 256, 16) == (32, 128)
    for route, (rows, per_sm) in pa.ROUTE_BLOCKS.items():
        for B, T, N, K in ((8, 1, 12, 2), (8, 5, 28, 4), (1, 1, 8, 8), (3, 40, 14, 2)):
            parts, part_len = pa.kv_partitions(B, T, N, K, 256, 16, route=route)
            tiles = -(-T * (N // K) // rows) * K * B
            assert parts * part_len >= 4096 > (parts - 1) * part_len and part_len % 64 == 0
            assert parts == 1 or tiles * parts <= 4 * per_sm * 132 + tiles, (route, B, T, N, K, parts)
