"""The port's flash attention against the JAX package's Pallas kernels.

The same numpy inputs (from a seed) go through the Pallas kernels in
interpret mode (``flash_attention(..., interpret=True)``, ``_flash_fwd`` for
the logsumexp, ``jax.vjp`` for the gradients) and through the port's plain
versions (``flash_attention_fwd_ref``/``flash_attention_bwd_ref``) and its
``torch.autograd.Function`` on the CPU. Tolerances are the JAX kernel tests'
own (``tests/ops/test_pallas_flash.py``): atol 2e-5 on the forward (fp32,
summation order only), atol 5e-4 / rtol 1e-3 on the gradients.

The dispatcher's masked and cached calls (a padding mask, ``q_offset``,
``T != S``) run its XLA-path counterpart, held against the JAX dispatcher's
``jax.nn.dot_product_attention`` path: fp32 within atol 2e-6 (summation
order), bf16 bit for bit (bf16 products are exact in fp32, and the bf16
roundings of the probabilities and the output absorb the summation order),
gradients against ``jax.grad`` within 1e-5 of their largest element; fully
masked rows stay finite.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlenlp_tpu.ops.pallas.flash_attention import _flash_fwd
from paddlenlp_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from paddlenlp_tpu_torch.ops import flash_attention as fa
from torch_tf32 import mm_tf32, tf32_trunc

FWD_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3

# (B, T, N, K, H, causal, window, segments): causal and full; GQA groups 1, 2, 3;
# T = 200 (partial edge blocks) and 384 with 128-blocks (several blocks); segments;
# a window; head_dim 64, and 192 (DeepSeek-V2's MLA: qk_nope 128 + qk_rope 64)
CASES = [
    (1, 200, 2, 2, 64, True, None, False),
    (1, 200, 4, 2, 64, False, None, False),
    (1, 384, 6, 2, 32, True, None, False),
    (2, 128, 3, 1, 64, True, None, True),
    (1, 384, 4, 4, 32, True, 100, False),
    (1, 200, 4, 2, 64, True, 64, True),
    (1, 200, 2, 2, 192, True, None, True),
]
IDS = ["causal-g1-T200", "full-g2-T200", "causal-g3-T384", "segments-g3", "window-T384", "window-segments-T200",
       "segments-g1-H192"]


def _inputs(B, T, N, K, H, segments, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, N, H), dtype=np.float32)
    k = rng.standard_normal((B, T, K, H), dtype=np.float32)
    v = rng.standard_normal((B, T, K, H), dtype=np.float32)
    do = rng.standard_normal((B, T, N, H), dtype=np.float32)
    seg = None
    if segments:  # three packed documents per row, boundaries off the 128-blocks
        seg = np.zeros((B, T), np.int32)
        seg[:, T // 3:] = 1
        seg[:, (2 * T) // 3 + 5:] = 2
    return q, k, v, do, seg


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@functools.lru_cache(maxsize=None)
def _pallas(B, T, N, K, H, causal, window, segments):
    """The Pallas kernels in interpret mode on one case's inputs, in one jit:
    (out, lse) of ``_flash_fwd`` and (dq, dk, dv) of ``jax.vjp`` of
    ``flash_attention``."""
    q, k, v, do, seg = _inputs(B, T, N, K, H, segments)

    def run(q_, k_, v_, seg_, do_):
        fwd = _flash_fwd(q_, k_, v_, seg_, H**-0.5, causal, window, 128, 128, True)
        _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, seg_, None, causal, window, 128, 128, True), q_, k_, v_)
        return fwd, vjp(do_)

    return jax.device_get(jax.jit(run)(_j(q), _j(k), _j(v), _j(seg), _j(do)))


@pytest.mark.parametrize("B,T,N,K,H,causal,window,segments", CASES, ids=IDS)
def test_forward_matches_pallas(B, T, N, K, H, causal, window, segments):
    q, k, v, _do, seg = _inputs(B, T, N, K, H, segments)
    (want_out, want_lse), _ = _pallas(B, T, N, K, H, causal, window, segments)
    got_out, got_lse = fa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(seg), causal=causal, window=window)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse).reshape(B, N, T), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("B,T,N,K,H,causal,window,segments", CASES, ids=IDS)
def test_backward_matches_pallas_vjp(B, T, N, K, H, causal, window, segments):
    q, k, v, do, seg = _inputs(B, T, N, K, H, segments)
    _, want = _pallas(B, T, N, K, H, causal, window, segments)
    out, lse = fa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(seg), causal=causal, window=window)
    delta = fa._delta(out, _t(do))
    got = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(do), lse, delta, _t(seg), causal=causal,
                                     window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    # the dq and dk/dv wrappers take the plain version for CPU tensors
    dq = fa.flash_attention_bwd_dq(_t(q), _t(k), _t(v), _t(do), lse, delta, _t(seg), causal=causal, window=window)
    dk, dv = fa.flash_attention_bwd_dkv(_t(q), _t(k), _t(v), _t(do), lse, delta, _t(seg), causal=causal,
                                        window=window)
    for g, w in zip((dq, dk, dv), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_autograd_function_matches_plain_versions():
    q, k, v, do, seg = _inputs(2, 96, 6, 2, 64, True, seed=1)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    launches = dict(fa.LAUNCHES)
    out = fa.flash_attention(qt, kt, vt, _t(seg), window=40)
    out.backward(_t(do))
    ref_out, lse = fa.flash_attention_fwd_ref(_t(q), _t(k), _t(v), _t(seg), window=40)
    ref = fa.flash_attention_bwd_ref(_t(q), _t(k), _t(v), _t(do), lse, fa._delta(ref_out, _t(do)), _t(seg),
                                     window=40)
    torch.testing.assert_close(out.detach(), ref_out, atol=0, rtol=0)
    for t, r in zip((qt, kt, vt), ref):
        torch.testing.assert_close(t.grad, r, atol=0, rtol=0)
    assert fa.LAUNCHES == launches  # the plain versions launch no kernel


def test_gradcheck_float64():
    # fast mode (random projections of the Jacobian) on a tiny GQA shape: the
    # full Jacobian's hundreds of tiny forwards crawl under a loaded test run
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
               for s in ((1, 6, 4, 4), (1, 6, 2, 4), (1, 6, 2, 4)))
    seg = torch.tensor([[0, 0, 0, 1, 1, 1]], dtype=torch.int32)
    assert torch.autograd.gradcheck(lambda a, b, c: fa.flash_attention(a, b, c, seg, window=2), (q, k, v),
                                    fast_mode=True)
    assert torch.autograd.gradcheck(lambda a, b, c: fa.flash_attention(a, b, c, causal=False), (q, k, v),
                                    fast_mode=True)


def test_rejects_like_the_pallas_kernel():
    q = torch.zeros(1, 8, 2, 64)
    kv = torch.zeros(1, 12, 2, 64)
    with pytest.raises(ValueError, match="T == S"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="causal=True"):
        fa.flash_attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="fold"):
        fa.flash_attention(torch.zeros(1, 8, 3, 64), q, q)


@pytest.mark.parametrize("option,item", [(dict(bias=torch.zeros(1, 1, 8, 8)), "14e"), (dict(use_alibi=True), "14e"),
                                         (dict(dropout_rate=0.1), "15"), (dict(positions=torch.arange(8)), "15"),
                                         (dict(causal=False), "14e")],
                         ids=["bias", "alibi", "dropout", "positions", "non-causal"])
def test_dispatcher_options_outside_the_slice_raise(option, item):
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 item {item}\\b"):
        fa.dot_product_attention(q, q, q, **option)


def test_dispatcher_segments_and_window():
    q, k, v, _do, seg = _inputs(1, 128, 4, 2, 32, True, seed=3)
    got = fa.dot_product_attention(_t(q), _t(k), _t(v), segment_ids=_t(seg).long(), window=50)
    want = jax_flash(_j(q), _j(k), _j(v), _j(seg), None, True, 50, 128, 128, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_chip_smoke_flash_check_catches_mutations(monkeypatch):
    """``chip_smoke.py``'s elementwise check (``flash_worst``) passes the plain
    version against itself and fails a kernel whose causal mask is shifted by
    one position or whose backward drops delta, at the training path's head
    layout in bf16 (a dry run of the card's check on the CPU)."""
    import chip_smoke

    rng = np.random.default_rng(6)
    q, do = (torch.from_numpy(rng.standard_normal((1, 256, 12, 128), dtype=np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 256, 2, 128), dtype=np.float32)).bfloat16() for _ in range(2))
    out, lse = fa.flash_attention_fwd_ref(q, k, v)
    grads = fa.flash_attention_bwd_ref(q, k, v, do, lse, fa._delta(out, do))
    want = dict(out=out, lse=lse, dq=grads[0], dk=grads[1], dv=grads[2])
    clean = chip_smoke.flash_worst(torch, want, want, "bfloat16")
    assert max(e["worst"] for e in clean.values()) == 0.0

    visible = fa._visible
    for shift in (1, -1):
        monkeypatch.setattr(fa, "_visible", lambda T, S, causal, window, seg, dev, s=shift: visible(
            T, S, False, None, seg, dev) & (torch.arange(S)[None, :] <= torch.arange(T)[:, None] + s)[None])
        m_out, m_lse = fa.flash_attention_fwd_ref(q, k, v)
        worst = chip_smoke.flash_worst(torch, dict(out=m_out, lse=m_lse), dict(out=out, lse=lse), "bfloat16")
        assert worst["out"]["worst"] > 1 and worst["lse"]["worst"] > 1, (shift, worst)
    monkeypatch.setattr(fa, "_visible", visible)
    no_delta = fa.flash_attention_bwd_ref(q, k, v, do, lse, torch.zeros(1, 12, 256))
    worst = chip_smoke.flash_worst(torch, dict(dq=no_delta[0], dk=no_delta[1]), dict(dq=grads[0], dk=grads[1]),
                                   "bfloat16")
    assert worst["dq"]["worst"] > 1 and worst["dk"]["worst"] > 1, worst


def _bf16(x, parts):
    """x through bf16 operands: one rounding, or (``parts=2``) the sum of a
    bf16 high part and the bf16 rounding of what it left out."""
    hi = x.bfloat16().float()
    return hi if parts == 1 else hi + (x - hi).bfloat16().float()


def _bf16_kernel_emulation(q, k, v, do, lse, delta, seg, window, parts, block_kv=128):
    """The Hopper bf16 kernels' roundings, step by step in torch: the forward's
    online softmax over 128-column kv tiles with P as ``parts`` bf16 operands
    of P.V (the row sum keeps fp32 P); dk/dv with P^T and dS^T (from fp32 P^T)
    as ``parts`` bf16 operands of their products; dq with dS (from fp32 P) as
    ``parts`` bf16 operands of dS.K. Products of bf16 operands accumulate in
    fp32, as the tensor cores do."""
    B, T, N, H = q.shape
    K = k.shape[2]
    g = N // K
    scale = H**-0.5
    s, valid = fa._scores(q, k, seg, scale, True, window)  # [B, K, g, T, S] fp32
    vf, dof = v.float(), do.float().reshape(B, T, K, g, H)
    m = torch.full(s.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, K, g, T, H)
    for c0 in range(0, T, block_kv):
        st, vt = s[..., c0:c0 + block_kv], valid[..., c0:c0 + block_kv]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.where(vt, torch.exp(st - m_new), torch.zeros_like(st))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgts,bskh->bkgth", _bf16(p, parts), vf[:, c0:c0 + block_kv])
        m = m_new
    l = l.clamp_min(1e-37)
    out = (acc / l).permute(0, 3, 1, 2, 4).reshape(B, T, N, H).bfloat16()
    lse_k = (m + torch.log(l))[..., 0].reshape(B, N, T)
    p = torch.where(valid, torch.exp(s - lse.reshape(B, K, g, T)[..., None]), torch.zeros_like(s))
    dp = torch.einsum("btkgh,bskh->bkgts", dof, vf)
    ds = p * (dp - delta.reshape(B, K, g, T)[..., None]) * scale
    dv = torch.einsum("bkgts,btkgh->bskh", _bf16(p, parts), dof).bfloat16()
    dk = torch.einsum("bkgts,btkgh->bskh", _bf16(ds, parts), q.float().reshape(B, T, K, g, H)).bfloat16()
    dq = torch.einsum("bkgts,bskh->btkgh", _bf16(ds, parts), k.float()).reshape(B, T, N, H).bfloat16()
    return dict(out=out, lse=lse_k, dq=dq, dk=dk, dv=dv)


@pytest.mark.parametrize("segments,window,heads", [(False, None, (12, 2, 128)), (True, 100, (12, 2, 128)),
                                                   (False, None, (16, 16, 192))],
                         ids=["causal", "segments+window", "lite-h192"])
def test_bf16_tensor_core_roundings_fit_the_chip_gate(segments, window, heads):
    """The Hopper kernels' bf16 operands stay inside the card's elementwise
    gate against the fp32 plain versions: ``2**-7 |ref| + 1e-3 max|ref|`` per
    element, the ``flash_worst`` rule of ``chip_smoke.py``, at the training
    path's heads (group 6, head_dim 128) and at DeepSeek-V2-Lite's (16 heads,
    group 1, head_dim 192, whose forward walks 64-column kv tiles), T 256.
    The kernels give P, P^T and dS^T as two bf16 parts each (high and
    residual): one rounding exceeds the gate on dk and dv and leaves out
    close to it (printed beside). dq takes dS as two parts too, and is held
    to the same gate."""
    import chip_smoke

    N, K, H = heads
    rng = np.random.default_rng(7)
    q, do = (torch.from_numpy(rng.standard_normal((1, 256, N, H), dtype=np.float32)).bfloat16() for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 256, K, H), dtype=np.float32)).bfloat16() for _ in range(2))
    seg = None
    if segments:
        seg = torch.zeros(1, 256, dtype=torch.int32)
        seg[:, 90:] = 1
        seg[:, 181:] = 2
    out, lse = fa.flash_attention_fwd_ref(q, k, v, seg, window=window)
    delta = fa._delta(out, do)
    dq, dk, dv = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, seg, window=window)
    want = dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv)
    worst = {}
    for parts in (2, 1):
        got = _bf16_kernel_emulation(q, k, v, do, lse, delta, seg, window, parts, block_kv=64 if H == 192 else 128)
        worst[parts] = chip_smoke.flash_worst(torch, got, want, "bfloat16")
        print(f"bf16 parts {parts}:", {name: round(e["worst"], 3) for name, e in worst[parts].items()})
    for name, e in worst[2].items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)


def _score_mm(mm, a, b):
    """A score product a [.., T, H] @ b [.., H, S] of the fp32 kernels: over
    all H dims at head_dim 64 and 128; at 192 each warp of a pair sums its
    96 dims, and the pair adds the two partial tiles."""
    if a.shape[-1] == 192:
        return mm(a[..., :96], b[..., :96, :]) + mm(a[..., 96:], b[..., 96:, :])
    return mm(a, b)


def _f32_bwd_emulation(q, k, v, do, lse, delta, seg, causal, window, passes, sms):
    """The fp32 backward of ``flash_attention_sm90_f32.cu`` step by step in
    torch: every operand of the five products split as the kernels split it
    (:func:`torch_tf32.mm_tf32`, hi rounded to TF32, lo read as TF32 by
    truncation) or one TF32 pass (``passes=1``); p = exp2(s scale log2 e -
    lse log2 e), dS = p (dP - delta) scale. dq sums over 16-row kv steps in
    order, a fresh product a step; dk/dv walk each 64-row kv tile's (query
    head, 16-row query tile) pairs in order (``dkv_walk``), cut into parts of
    ``dkv_split``'s chunk on a card of ``sms`` multiprocessors, each part's
    sum taken step by step and the parts added in order. At head_dim 192
    the score products' inner sums are taken in two halves of 96 dims (the
    two warps of a pair), which are then added (``_score_mm``). (What the
    tensor core does inside one ``mma`` is not emulated.)"""
    B, T, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    g = N // K
    scale, log2e = H**-0.5, 1.4426950408889634

    def mm(a, b):
        return mm_tf32(a, b, passes, lo=tf32_trunc)

    qf, dof = (x.reshape(B, T, K, g, H).permute(0, 2, 3, 1, 4) for x in (q, do))  # [B, K, g, T, H]
    kf, vf = (x.permute(0, 2, 1, 3)[:, :, None] for x in (k, v))  # [B, K, 1, S, H]
    valid = fa._visible(T, S, causal, window, seg, q.device)[:, None, None]
    s = _score_mm(mm, qf, kf.transpose(-1, -2))
    p = torch.where(valid, torch.exp2(s * (scale * log2e) - lse.reshape(B, K, g, T, 1) * log2e),
                    torch.zeros_like(s))
    ds = p * (_score_mm(mm, dof, vf.transpose(-1, -2)) - delta.reshape(B, K, g, T, 1)) * scale
    dq = torch.zeros(B, K, g, T, H)
    for c0 in range(0, S, 16):
        dq = dq + mm(ds[..., c0:c0 + 16], kf[..., c0:c0 + 16, :])
    chunk, _slots = fa.dkv_split(B, T, S, N, K, causal, window, sms)
    dk, dv = torch.zeros(B, K, S, H), torch.zeros(B, K, S, H)
    for tile in range(-(-S // 64)):
        cols = slice(64 * tile, 64 * tile + 64)
        lo, count = fa.dkv_walk(T, S, causal, window, tile)
        steps = [(gi, lo + i) for gi in range(g) for i in range(count)]
        for p0 in range(0, len(steps), chunk):
            part_k, part_v = torch.zeros_like(dk[:, :, cols]), torch.zeros_like(dv[:, :, cols])
            for gi, qt in steps[p0:p0 + chunk]:
                rows = slice(16 * qt, 16 * qt + 16)
                part_v = part_v + mm(p[:, :, gi, rows, cols].transpose(-1, -2), dof[:, :, gi, rows])
                part_k = part_k + mm(ds[:, :, gi, rows, cols].transpose(-1, -2), qf[:, :, gi, rows])
            dk[:, :, cols] = dk[:, :, cols] + part_k
            dv[:, :, cols] = dv[:, :, cols] + part_v
    return dict(dq=dq.permute(0, 3, 1, 2, 4).reshape(B, T, N, H), dk=dk.transpose(1, 2), dv=dv.transpose(1, 2))


def _f32_fwd_emulation(q, k, v, seg, causal, window, passes):
    """The fp32 forward of ``flash_attention_sm90_f32.cu`` step by step in
    torch: S = Q K^T and each step's P V with their operands split as the
    kernel splits them (:func:`torch_tf32.mm_tf32`, hi rounded to TF32, lo
    read as TF32 by truncation) or one TF32 pass (``passes=1``); the scores
    in log2 units (s scale log2 e), invisible ones at NEG_INF; 16-column kv
    steps in order, each taking the new row max m, rescaling l and O by
    exp2(m_old - m), and adding p = exp2(s - m) and a fresh product P V to
    them. out = O / max(l, 1e-37), lse = m ln 2 + log(max(l, 1e-37)), with
    NEG_INF for m on a row that sees no key. At head_dim 192, S's inner sum
    in two halves added (``_score_mm``). (The kernel's per-lane partial
    sums of l, and what the tensor core does inside one ``mma``, are not
    emulated.)"""
    B, T, N, H = q.shape
    S, K = k.shape[1], k.shape[2]
    g = N // K
    scale, log2e = H**-0.5, 1.4426950408889634

    def mm(a, b):
        return mm_tf32(a, b, passes, lo=tf32_trunc)

    qf = q.reshape(B, T, K, g, H).permute(0, 2, 3, 1, 4)  # [B, K, g, T, H]
    kf, vf = (x.permute(0, 2, 1, 3)[:, :, None] for x in (k, v))  # [B, K, 1, S, H]
    valid = fa._visible(T, S, causal, window, seg, q.device)[:, None, None]
    s = torch.where(valid, _score_mm(mm, qf, kf.transpose(-1, -2)) * (scale * log2e), torch.tensor(fa.NEG_INF))
    m = torch.full((B, K, g, T, 1), fa.NEG_INF)
    l, o = torch.zeros(B, K, g, T, 1), torch.zeros(B, K, g, T, H)
    for c0 in range(0, S, 16):
        m_new = torch.maximum(m, s[..., c0:c0 + 16].amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(valid[..., c0:c0 + 16], torch.exp2(s[..., c0:c0 + 16] - m_new), torch.tensor(0.0))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + mm(p, vf[..., c0:c0 + 16, :])
        m = m_new
    d = l.clamp_min(1e-37)
    lse = torch.where(l > 0, m * np.log(2.0), torch.tensor(fa.NEG_INF)) + torch.log(d)
    return dict(out=(o / d).permute(0, 3, 1, 2, 4).reshape(B, T, N, H), lse=lse.reshape(B, N, T))


@pytest.fixture
def one_thread():
    """torch on one intra-op thread: the emulation's hundreds of small
    products ran ~20x slower on the pool under the suite's parallel workers
    (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (causal, window, segments, (N, K, H)): group 3 at head_dim 64, and group 4
# at DeepSeek-V2's 192, causal with segments
F32_EMULATION_CASES = [(True, None, False, (6, 2, 64)), (True, 120, True, (6, 2, 64)), (False, None, True, (6, 2, 64)),
                       (True, None, True, (4, 1, 192))]
F32_EMULATION_IDS = ["causal", "window+segments", "full+segments", "h192-segments"]


@pytest.mark.parametrize("causal,window,segments,heads", F32_EMULATION_CASES, ids=F32_EMULATION_IDS)
def test_f32_tensor_core_products_fit_the_chip_gate(causal, window, segments, heads, one_thread):
    """The fp32 dq and dk/dv kernels' arithmetic (3xTF32 products in the
    kernels' tile order, dk/dv's walks cut into parts as on a 2-multiprocessor
    card, so that T 200's tiles split; at head_dim 192 the score products'
    inner sums in two halves) against the plain backward under
    ``chip_smoke.py``'s fp32 gate (1e-4 of each tensor's largest element,
    ``flash_worst``) at group 3, head_dim 64, and at group 4, head_dim 192,
    T 200 (no multiple of 64): in with the headroom printed, while one TF32
    pass misses it."""
    import chip_smoke

    N, K, H = heads
    q, k, v, do, seg = (_t(x) for x in _inputs(1, 200, N, K, H, segments, seed=8))
    out, lse = fa.flash_attention_fwd_ref(q, k, v, seg, causal=causal, window=window)
    delta = fa._delta(out, do)
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, seg, causal=causal,
                                                                     window=window)))
    assert fa.dkv_split(1, 200, 200, N, K, causal, window, 2)[1] > 0  # some tile's walk is cut in parts
    worst = {}
    for passes in (3, 1):
        got = _f32_bwd_emulation(q, k, v, do, lse, delta, seg, causal, window, passes, sms=2)
        worst[passes] = chip_smoke.flash_worst(torch, got, want, "float32")
        print(f"fp32 backward H {H}, {passes} TF32 pass(es):",
              {n: round(e["worst"], 4) for n, e in worst[passes].items()})
    for name, e in worst[3].items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)
    assert max(e["worst"] for e in worst[1].values()) > 1.0, worst[1]


@pytest.mark.parametrize("causal,window,segments,heads", F32_EMULATION_CASES, ids=F32_EMULATION_IDS)
def test_f32_forward_tensor_core_products_fit_the_chip_gate(causal, window, segments, heads, one_thread):
    """The fp32 forward kernel's arithmetic (3xTF32 products, the online
    softmax over 16-column kv steps in order, at head_dim 192 S's inner sum
    in two halves: ``_f32_fwd_emulation``) against the plain forward under
    ``chip_smoke.py``'s fp32 gate (1e-4 of each tensor's largest element,
    ``flash_worst``) on the backward test's cases (group 3, head_dim 64, and
    group 4, head_dim 192, T 200): out and lse in with the headroom printed,
    while one TF32 pass misses it."""
    import chip_smoke

    N, K, H = heads
    q, k, v, _do, seg = (_t(x) for x in _inputs(1, 200, N, K, H, segments, seed=8))
    out, lse = fa.flash_attention_fwd_ref(q, k, v, seg, causal=causal, window=window)
    worst = {}
    for passes in (3, 1):
        got = _f32_fwd_emulation(q, k, v, seg, causal, window, passes)
        worst[passes] = chip_smoke.flash_worst(torch, got, dict(out=out, lse=lse), "float32")
        print(f"fp32 forward H {H}, {passes} TF32 pass(es):",
              {n: round(e["worst"], 4) for n, e in worst[passes].items()})
    for name, e in worst[3].items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)
    assert max(e["worst"] for e in worst[1].values()) > 1.0, worst[1]


def test_cuda_routes_take_head_dims_64_128_and_192():
    """The operand check of the CUDA wrappers alone (no card needed): both
    routes (bf16 and fp32 operands) take head_dim 64, 128 and 192, and both
    refuse 96 and 256 with ``ValueError`` naming the head dims they take."""
    assert fa.HEAD_DIMS == {"sm90": (64, 128, 192), "sm90_f32": (64, 128, 192)}
    for dtype in (torch.bfloat16, torch.float32):
        for H in (64, 128, 192):
            q, k = torch.zeros(1, 8, 2, H, dtype=dtype), torch.zeros(1, 8, 2, H, dtype=dtype)
            for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                fa._check_cuda_operands(name, {"q": q, "k": k, "v": k}, q, k, None)
        for H in (96, 256):
            q = torch.zeros(1, 8, 2, H, dtype=dtype)
            with pytest.raises(ValueError, match=r"head_dim must be one of \(64, 128, 192\)"):
                fa._check_cuda_operands("flash_attention_fwd", {"q": q, "k": q, "v": q}, q, q, None)


def test_dkv_split_fills_the_card_and_sizes_the_workspace():
    """``dkv_split`` at the fp32 check's shape (q [2, 2048, 12, 128] over k/v
    [2, 2048, 2, 128], causal) on 132 multiprocessors: the walks' parts make
    about three waves of two blocks an SM (the 128 kv tiles alone make half
    of one), the causal mask's longest walk (tile 0: 6 heads x 128 query
    tiles) the most cut, and the workspace slots count the parts of the tiles
    cut in more than one."""
    B, T, N, K = 2, 2048, 12, 2
    chunk, slots = fa.dkv_split(B, T, T, N, K, True, None, 132)
    walks = [fa.dkv_walk(T, T, True, None, t) for t in range(T // 64)]
    assert walks[0] == (0, 128) and walks[-1] == (124, 4)
    parts = [max(1, -(-(N // K) * n // chunk)) for _, n in walks]
    assert 2 * 132 * 2 <= B * K * sum(parts) <= 2 * 132 * 4, (chunk, parts)
    assert parts[0] == max(parts) > 1 and slots == sum(p for p in parts if p > 1)
    # a window bounds the walk: a window of 1 walks the diagonal's 4 query tiles
    assert fa.dkv_walk(T, T, True, 512, 0) == (0, 36) and fa.dkv_walk(T, T, True, 1, 5) == (20, 4)
    # full attention walks every query tile, also past S
    assert fa.dkv_walk(100, 300, False, None, 4) == (0, 7)


# ----------------------------------------------------------------------------- the XLA path
# (B, T, S, N, K, H, q_offset, left pads per row, window): a left-padded prefill
# (5 fully masked query rows), a cache prefill (T < S), a decode step over a
# cache, an offset without a mask, and a window with padding
DENSE_CASES = [(2, 24, 24, 4, 2, 16, 0, (5, 0), None), (2, 12, 20, 4, 2, 16, 0, (3, 0), None),
               (2, 1, 20, 6, 2, 16, 13, (3, 0), None), (1, 4, 16, 4, 4, 16, 9, None, None),
               (2, 24, 24, 4, 2, 16, 0, (2, 7), 6)]
DENSE_IDS = ["left-pad", "cache-prefill", "cache-step", "offset", "pad-window"]
DENSE_ATOL = 2e-6  # fp32: summation order only


def _dense_inputs(B, T, S, N, K, H, pads, dtype, seed=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, N, H), dtype=np.float32)
    k = rng.standard_normal((B, S, K, H), dtype=np.float32)
    v = rng.standard_normal((B, S, K, H), dtype=np.float32)
    do = rng.standard_normal((B, T, N, H), dtype=np.float32)
    mask = None
    if pads is not None:
        mask = np.ones((B, S), np.int32)
        for b, n in enumerate(pads):
            mask[b, :n] = 0
    to_j = (lambda x: jnp.asarray(x, jnp.bfloat16)) if dtype == "bfloat16" else jnp.asarray
    to_t = (lambda x: torch.from_numpy(x).bfloat16()) if dtype == "bfloat16" else torch.from_numpy
    return (q, k, v, do, mask), to_j, to_t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,N,K,H,q_offset,pads,window", DENSE_CASES, ids=DENSE_IDS)
def test_dispatcher_xla_path_matches_jax(B, T, S, N, K, H, q_offset, pads, window, dtype):
    """Masked and cached calls against the JAX dispatcher's XLA path
    (``jax.nn.dot_product_attention``), with no kernel launched."""
    from paddlenlp_tpu.ops.flash_attention import dot_product_attention as jax_dpa

    (q, k, v, _do, mask), to_j, to_t = _dense_inputs(B, T, S, N, K, H, pads, dtype)
    want = jax_dpa(to_j(q), to_j(k), to_j(v), attention_mask=None if mask is None else jnp.asarray(mask),
                   q_offset=q_offset, window=window, use_pallas=False)
    launches = dict(fa.LAUNCHES)
    got = fa.dot_product_attention(to_t(q), to_t(k), to_t(v), attention_mask=None if mask is None else _t(mask),
                                   q_offset=q_offset, window=window)
    assert fa.LAUNCHES == launches and got.dtype == to_t(q).dtype
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=DENSE_ATOL, rtol=0)
    else:  # exact products in fp32, then the bf16 roundings absorb the summation order
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,T,S,N,K,H,q_offset,pads,window", [DENSE_CASES[0], DENSE_CASES[2]],
                         ids=["left-pad", "cache-step"])
def test_dispatcher_xla_path_gradients_match_jax(B, T, S, N, K, H, q_offset, pads, window):
    from paddlenlp_tpu.ops.flash_attention import dot_product_attention as jax_dpa

    (q, k, v, do, mask), _, _ = _dense_inputs(B, T, S, N, K, H, pads, "float32", seed=5)

    def jloss(q_, k_, v_):
        out = jax_dpa(q_, k_, v_, attention_mask=jnp.asarray(mask), q_offset=q_offset, use_pallas=False)
        return (out * jnp.asarray(do)).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fa.dot_product_attention(qt, kt, vt, attention_mask=_t(mask), q_offset=q_offset)
    out.backward(_t(do))
    for name, t, w in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_attend_uniformly_and_stay_finite(dtype):
    """A left-pad query row sees no key: like XLA's it attends uniformly over
    all S positions (``-0.7 * finfo.max`` logits, not -inf), so it comes out
    finite, and the next layer's V at that pad position cannot poison real
    rows through 0 * NaN."""
    (q, k, v, _do, mask), _, to_t = _dense_inputs(2, 24, 24, 4, 2, 16, (5, 0), dtype)
    out = fa.dot_product_attention(to_t(q), to_t(k), to_t(v), attention_mask=_t(mask)).float()
    assert torch.isfinite(out).all()
    vt = to_t(v).float().repeat_interleave(2, dim=2)  # [B, S, N, H]
    want = vt[0].mean(dim=0)  # [N, H]: uniform over all 24 positions
    for t in range(5):
        torch.testing.assert_close(out[0, t], want.to(to_t(q).dtype).float(), atol=1e-2 if dtype == "bfloat16" else 1e-6,
                                   rtol=0)


def test_eligible_calls_keep_the_flash_path():
    """No mask, no offset and T == S: the flash kernels' path, bit for bit
    (its plain version on the CPU); a mask of ones takes the XLA path and
    agrees to summation order."""
    q, k, v, _do, _seg = _inputs(1, 64, 4, 2, 32, False, seed=7)
    got = fa.dot_product_attention(_t(q), _t(k), _t(v))
    torch.testing.assert_close(got, fa.flash_attention(_t(q), _t(k), _t(v)), atol=0, rtol=0)
    ones = fa.dot_product_attention(_t(q), _t(k), _t(v), attention_mask=torch.ones(1, 64, dtype=torch.int32))
    torch.testing.assert_close(ones, got, atol=FWD_ATOL, rtol=0)
