"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and is
marked ``cuda``; without CUDA they skip. This file imports neither JAX nor the
JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
from paddlenlp_tpu_torch.ops import flash_attention as fa
from paddlenlp_tpu_torch.ops import paged_attention as pa
from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, q_dtype, kv_dtype, H, bs, group, K=2, seed=0):
    """A ragged batch: a chunk starting mid-block, a chunk starting on a block
    boundary, a decode row, a dead row."""
    from paddlenlp_tpu_torch.experimental.paged_cache import quantize_kv

    rng = np.random.default_rng(seed)
    B, T, mb = 4, 13, 9
    N = K * group
    nb = B * mb + 1
    q = torch.from_numpy(rng.standard_normal((B, T, N, H), dtype=np.float32)).to(dev, q_dtype)
    pk = torch.from_numpy(rng.standard_normal((nb, K, bs, H), dtype=np.float32)).to(dev)
    pv = torch.from_numpy(rng.standard_normal((nb, K, bs, H), dtype=np.float32)).to(dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb).astype(np.int32)).to(dev)
    cap = mb * bs
    q_start = torch.tensor([3, bs, cap - 1, 0], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([T, min(T, cap - bs), 1, 0], dtype=torch.int32, device=dev)
    ks = vs = None
    if kv_dtype in (torch.int8, torch.float8_e4m3fn):
        pk, ks = quantize_kv(pk, kv_dtype)
        pv, vs = quantize_kv(pv, kv_dtype)
    else:
        pk, pv = pk.to(kv_dtype), pv.to(kv_dtype)
    return q, pk, pv, tables, q_start, q_lens, ks, vs


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.int8), (torch.bfloat16, torch.float8_e4m3fn), (torch.float32, torch.int8)])
@pytest.mark.parametrize("H,bs,group", [(128, 16, 7), (64, 8, 1), (128, 64, 3), (64, 33, 2)])
def test_kernel_matches_plain(dev, q_dtype, kv_dtype, H, bs, group):
    """bf16 queries over a bf16, int8 or fp8 pool take the Hopper kernel
    (``LAUNCHES_SM90``; the quantized pools also ``LAUNCHES_SM90_QUANT``),
    fp32 queries the SIMT one."""
    args = _case(dev, q_dtype, kv_dtype, H, bs, group)
    q, pk, pv, tables, q_start, q_lens, ks, vs = args
    sm90, quant = pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT
    got = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_SM90 - sm90 == int(q_dtype == torch.bfloat16)
    assert pa.LAUNCHES_SM90_QUANT - quant == int(q_dtype == torch.bfloat16 and ks is not None)
    # fp32 output: summation order only; bf16 output: two roundings of fp32
    # values that differ in summation order, at most one ulp (2**-7 * |x|) apart
    atol, rtol = (2e-5, 0.0) if q_dtype == torch.float32 else (1e-3, 2**-7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.all(got[3] == 0)  # dead row: exact zeros
    assert torch.all(got[2, 1:] == 0)  # decode row padding: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_wrapper_and_launch_count(dev, dtype):
    q, pk, pv, tables, q_start, _q_lens, _, _ = _case(dev, dtype, dtype, 128, 16, 7)
    before, sm90 = pa.LAUNCHES, pa.LAUNCHES_SM90
    a = pa.paged_decode_attention(q[:, 0].contiguous(), pk, pv, tables, q_start)
    b = pa.ragged_paged_attention(q[:, :1].contiguous(), pk, pv, tables, q_start,
                                  torch.ones(4, dtype=torch.int32, device=dev))[:, 0]
    assert pa.LAUNCHES == before + 2
    assert pa.LAUNCHES_SM90 == sm90 + (2 if dtype == torch.bfloat16 else 0)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=["bf16", "int8"])
def test_two_threads_launch_and_count_exactly(dev, kv_dtype):
    """Two threads of one process launch the Hopper kernel at once, as two
    in-process replicas' engine loops do behind the router: every launch is
    counted on its route and each gives the single-thread bits."""
    import threading

    q, pk, pv, tables, q_start, q_lens, ks, vs = _case(dev, torch.bfloat16, kv_dtype, 128, 16, 7)
    want = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    before, sm90, quant = pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT
    per_thread, start, mismatches, errors = 200, threading.Barrier(2), [], []

    def run():
        try:
            start.wait(timeout=60)
            outs = [pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
                    for _ in range(per_thread)]
            torch.cuda.synchronize()
            mismatches.extend(i for i, o in enumerate(outs) if not torch.equal(o, want))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert not mismatches
    assert pa.LAUNCHES - before == pa.LAUNCHES_SM90 - sm90 == 2 * per_thread
    assert pa.LAUNCHES_SM90_QUANT - quant == (2 * per_thread if ks is not None else 0)


POOLS ={"bf16": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("split", [True, False], ids=["kv-partitions", "one-partition"])
@pytest.mark.parametrize("H,bs,group", [(128, 16, 7), (64, 8, 1), (128, 64, 3), (64, 33, 2)])
def test_paged_sm90_route_matches_plain(dev, monkeypatch, H, bs, group, split, pool):
    """The Hopper kernel over a bf16, int8 or fp8 pool with its kv walk split
    (the partitions of ``kv_partitions``: this small grid splits) and whole
    (one partition, as a full grid takes): the ragged batch of ``_case`` plus
    a decode row whose context ends on a partition boundary, a decode row one
    past it and a q_lens 0 row; dead rows exact zeros, two launches the same
    bits."""
    q, pk, pv, tables, q_start, q_lens, ks, vs = _case(dev, torch.bfloat16, POOLS[pool], H, bs, group)
    B, T, N, _ = q.shape
    mb = tables.shape[1]
    parts, part_len = pa.kv_partitions(B + 3, T, N, N // group, mb, bs, pa._sm_count(dev.index or 0))
    assert parts > 1
    if not split:
        monkeypatch.setattr(pa, "kv_partitions", lambda *a, **kw: (1, -(-mb * bs // 64) * 64))
    more = torch.tensor([[part_len - 1, 1], [part_len, 1], [5, 0]], dtype=torch.int32, device=dev)
    q = torch.cat([q, torch.randn(3, T, N, H, device=dev, generator=torch.Generator(dev).manual_seed(1)).bfloat16()])
    tables = torch.cat([tables, tables[:3].flip(1)])
    q_start, q_lens = torch.cat([q_start, more[:, 0]]), torch.cat([q_lens, more[:, 1]])
    sm90, quant = pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT
    got = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    again = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_SM90 == sm90 + 2
    assert pa.LAUNCHES_SM90_QUANT == quant + (2 if pool != "bf16" else 0)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3, rtol=2**-7)
    assert torch.equal(got, again)
    for b, qlen in enumerate(q_lens.tolist()):
        assert torch.all(got[b, qlen:] == 0), b


@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("fault", ["entry returns an error", "pointer not 16-byte aligned"])
def test_paged_sm90_failed_launch_raises(dev, monkeypatch, fault, pool):
    """A refused launch on the Hopper route, over a bf16, int8 or fp8 pool,
    raises RuntimeError naming its entry: no counter moves, and neither the
    SIMT kernel nor the plain version runs in its place."""
    q, pk, pv, tables, q_start, q_lens, ks, vs = _case(dev, torch.bfloat16, POOLS[pool], 128, 16, 7)
    route = pa.kernel_route(q.dtype, pk.dtype)
    real = pa._kernel_fn

    def entry(r):  # only the route's own entry is ever asked for
        assert r == route, f"the {r} entry asked for in place of {route}"
        return (lambda *args: 700) if fault == "entry returns an error" else real(r)

    monkeypatch.setattr(pa, "_kernel_fn", entry)
    if fault == "pointer not 16-byte aligned":  # a contiguous view 2 bytes past a 16-byte boundary
        off = 2 // pk.element_size()
        buf = torch.empty(pk.numel() + off, dtype=pk.dtype, device=dev)
        buf[off:].view(pk.shape).copy_(pk)
        pk = buf[off:].view(pk.shape)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(pa, "ragged_paged_attention_ref", plain)
    before, sm90, quant = pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT
    symbol = "_sm90_quant" if pool != "bf16" else "_sm90\\)"
    with pytest.raises(RuntimeError, match=symbol):
        pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT) == (before, sm90, quant)


def test_wrapper_rejects_bad_operands(dev):
    q, pk, pv, tables, q_start, q_lens, _, _ = _case(dev, torch.bfloat16, torch.bfloat16, 128, 16, 7)
    launches = pa.LAUNCHES
    bad = [
        dict(q=q.half()),
        dict(q=q[:, :, :, :96].contiguous(), pool_k=pk[..., :96].contiguous(), pool_v=pv[..., :96].contiguous()),
        dict(q=q.transpose(1, 2)),
        dict(block_tables=tables.long()),
        dict(q_start=q_start.cpu()),
        dict(pool_k=pk.to(torch.int8), pool_v=pv.to(torch.int8)),
        dict(pool_v=pv.float()),
    ]
    base = dict(q=q, pool_k=pk, pool_v=pv, block_tables=tables, q_start=q_start, q_lens=q_lens)
    for change in bad:
        with pytest.raises((TypeError, ValueError)):
            pa.ragged_paged_attention(**{**base, **change})
    assert pa.LAUNCHES == launches


@pytest.mark.parametrize("quant", [None, "int8"])
def test_engine_kernel_path_matches_plain_path(dev, quant):
    """Greedy streams through the kernel against the plain gather path, for
    monolithic and chunked prefill, in fp32 on the card. Over an fp32 pool
    they are equal. Over an int8 pool (the SIMT kernel's quantized read) the
    two paths are two functions, as in the JAX package: the kernel
    dequantizes K and V in fp32, the gather path rounds them to bf16. So a
    stream may leave the other, but only at a near tie: at the first
    divergence the kernel path's fp32 logits over the common prefix put the
    two tokens within the bf16 gate ``2**-7 * |logit| + 1e-3`` of each
    other (the gather path's rounding of K and V is a bf16 rounding)."""
    import chip_smoke

    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool

    cfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    prompts = [list(range(3, 40)), [5, 6, 7], list(range(50, 70))]
    outs = {}
    for kernel in (True, False):
        for chunk in (None, 8):
            eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64,
                                  max_blocks_per_seq=8, prefill_chunk_tokens=chunk, kv_cache_quant=quant)
            eng.infer.use_paged_kernel = kernel
            pa.LAUNCHES = 0
            outs[kernel, chunk] = eng.generate(prompts, SamplingParams(max_new_tokens=12))
            assert (pa.LAUNCHES > 0) == kernel
    for chunk in (None, 8):
        if quant is None:
            assert outs[True, chunk] == outs[False, chunk]
            continue
        for prompt, got, want in zip(prompts, outs[True, chunk], outs[False, chunk]):
            j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
            if j is None:
                assert got == want
                continue
            row = chip_smoke.paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt + want[:j],
                                          torch.float32, 0, quant=quant)[0][-1]
            la, lb = row[got[j]].item(), row[want[j]].item()
            assert abs(la - lb) <= 2**-7 * max(abs(la), abs(lb)) + 1e-3, (chunk, j, la, lb)


# ----------------------------------------------------------------- flash attention
def _flash_case(dev, dtype, B, T, N, K, H, segments, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, N, H), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, H), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    seg = None
    if segments:  # packed documents with boundaries off the 64-row tiles
        seg = torch.zeros(B, T, dtype=torch.int32)
        seg[:, T // 3:] = 1
        seg[:, T // 2 + 7:] = 2
        seg = seg.to(dev)
    return q, k, v, do, seg


def _close(got, want, dtype):
    # fp32: summation order only; bf16: two roundings of fp32 values, at most
    # one ulp (2**-7 * |x|) apart, plus fp32 noise scaled to the tensor
    if dtype == torch.float32:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4, rtol=1e-4)
    else:
        atol = 1e-3 * max(want.float().abs().max().item(), 1.0)
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=2**-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,N,K,H,causal,window,segments", [
    (200, 6, 1, 128, True, None, False),   # group 6, T not a multiple of the tile
    (256, 4, 2, 64, True, None, False),    # group 2, H 64
    (129, 7, 1, 64, False, None, False),   # group 7, full attention
    (333, 2, 2, 128, True, 100, True),     # group 1, window + segments
    (1024, 12, 2, 128, True, None, False),  # the training path's heads, group 6, at a smaller T
    (300, 12, 2, 128, False, None, False),  # full attention, T not a multiple of 128
])
def test_flash_kernels_match_plain(dev, dtype, T, N, K, H, causal, window, segments):
    """bf16 runs the forward, dq and dk/dv through the Hopper kernels
    (``LAUNCHES_SM90``), fp32 through the SIMT kernels."""
    q, k, v, do, seg = _flash_case(dev, dtype, 2, T, N, K, H, segments)
    sm90 = dict(fa.LAUNCHES_SM90)
    out, lse = fa.flash_attention_fwd(q, k, v, seg, causal=causal, window=window)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, seg, causal=causal, window=window)
    torch.cuda.synchronize()
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    delta = fa._delta(ref_out, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, seg, causal=causal, window=window)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, seg, causal=causal, window=window)
    want = fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta, seg, causal=causal, window=window)
    torch.cuda.synchronize()
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == w.shape, name
        _close(got, w, dtype)
    moved = 1 if dtype == torch.bfloat16 else 0
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == {"fwd": moved, "bwd_dq": moved, "bwd_dkv": moved}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flash_autograd_counts_launches(dev, dtype):
    """``LAUNCHES`` counts each kernel once on either route; ``LAUNCHES_SM90``
    moves by one forward, one dq and one dk/dv for bf16 and stays for fp32."""
    q, k, v, do, _ = _flash_case(dev, dtype, 1, 100, 4, 2, 128, False)
    q.requires_grad_(True)
    before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    fa.flash_attention(q, k.requires_grad_(True), v.requires_grad_(True)).backward(do)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    moved = 1 if dtype == torch.bfloat16 else 0
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == {"fwd": moved, "bwd_dq": moved, "bwd_dkv": moved}


@pytest.mark.parametrize("fault", ["entry returns an error", "pointer not 16-byte aligned"])
def test_flash_sm90_failed_launch_raises(dev, monkeypatch, fault):
    """A refused launch on the Hopper route raises RuntimeError: neither
    counter moves, and neither the SIMT kernel nor the plain version runs in
    its place."""
    q, k, v, do, _ = _flash_case(dev, torch.bfloat16, 1, 128, 4, 2, 128, False)
    if fault == "entry returns an error":
        real = fa._kernel_fn
        monkeypatch.setattr(fa, "_kernel_fn", lambda stem, symbol, n_ptr, n_int: (
            (lambda *args: 700) if stem == "flash_attention_sm90" else real(stem, symbol, n_ptr, n_int)))
    else:  # a contiguous view 2 bytes into its buffer: libcuda refuses its tensor map
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        buf[1:].view(q.shape).copy_(q)
        q = buf[1:].view(q.shape)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(fa, "flash_attention_fwd_ref", plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", plain)
    before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    with pytest.raises(RuntimeError, match="_sm90"):
        fa.flash_attention_fwd(q, k, v)
    lse = torch.zeros(1, 4, 128, device=dev)
    with pytest.raises(RuntimeError, match="_sm90"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, lse)
    with pytest.raises(RuntimeError, match="_sm90"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before and fa.LAUNCHES_SM90 == sm90


@pytest.mark.parametrize("T", [1024, 4096])
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_flash_sm90_gate_headroom_over_seeds(dev, seed, T):
    """The Hopper forward, dq and dk/dv against the plain versions under
    ``chip_smoke.py``'s elementwise gate, on its ``main`` inputs (q [2, T, 12,
    128] over k/v [2, T, 2, 128], causal) from seeds other than its own. Prints
    each worst element over its bound."""
    import chip_smoke

    q, k, v, do, _ = chip_smoke.flash_case(torch, "bfloat16", T, False, seed)
    out, lse = fa.flash_attention_fwd(q, k, v)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v)
    delta = fa._delta(ref_out, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta)
    ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta)
    worst = chip_smoke.flash_worst(torch, dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv),
                                   dict(out=ref_out, lse=ref_lse, dq=ref_dq, dk=ref_dk, dv=ref_dv), "bfloat16")
    print(json.dumps(dict(seed=seed, T=T, worst={name: e["worst"] for name, e in worst.items()})))
    for name, e in worst.items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chip_smoke_train_grad_other_seeds(dev, seed):
    """``chip_smoke.py``'s ``train_grad`` phase (Qwen2-1.5B widths, 2 layers;
    fp32 and bf16 compute, kernels vs plain, the bf16-vs-fp32 control) from
    seeds other than its own: its bounds hold, and it prints its readings."""
    import chip_smoke
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers.llama import modeling

    chip_smoke.phase_train_grad(torch, fa, modeling, Qwen2Config, Qwen2ForCausalLM, causal_lm_loss, seed)


def test_flash_wrapper_rejects_bad_operands(dev):
    q, k, v, _, _ = _flash_case(dev, torch.bfloat16, 1, 64, 4, 2, 128, False)
    before = dict(fa.LAUNCHES)
    for args in [(q.half(), k.half(), v.half()), (q[..., :96].contiguous(), k[..., :96].contiguous(),
                                                 v[..., :96].contiguous()),
                 (q.transpose(1, 2), k, v), (q, k.float(), v)]:
        with pytest.raises((TypeError, ValueError)):
            fa.flash_attention_fwd(*args)
    assert fa.LAUNCHES == before


def test_train_step_through_kernels_equals_plain(dev):
    """At fp32, the loss and every gradient leaf of a Trainer micro-step
    through the kernels equal those through the plain versions (the CPU
    path): loss rel 1e-5, each leaf within 1e-4 of its largest element. A
    full step then launches each kernel once per layer and micro-batch, on
    the SIMT route in fp32 and on the Hopper route in bf16."""
    cfg = Qwen2Config(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, head_dim=64, tie_word_embeddings=True,
                      recompute=True, recompute_granularity="save_qkv_attn")
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 256, (4, 96)).astype(np.int32)}
    batch["labels"] = batch["input_ids"].copy()
    args = TrainingArguments(output_dir="unused", per_device_train_batch_size=2, gradient_accumulation_steps=2,
                             learning_rate=1e-3, max_steps=1, save_strategy="no", weight_decay=0.01)
    results = {}
    for device in ("cpu", dev):
        model = Qwen2ForCausalLM.init_random(cfg, seed=0, device="cpu", dtype=torch.float32)
        model.params = _to(model.params, device)
        trainer = Trainer(model=model, args=args)
        for leaf in trainer.params.values():
            leaf.requires_grad_(True)
        loss = trainer.compute_loss(trainer._to_device(batch))
        loss.backward()
        results[str(device)] = (loss.item(), {k: t.grad.cpu() for k, t in trainer.params.items()})
        if device != "cpu":
            trainer.create_optimizer_and_scheduler(1)
            before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
            trainer.training_step(batch)
            assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
            assert fa.LAUNCHES_SM90 == sm90  # fp32: the SIMT kernels
            # bf16 compute (run_pretrain's `dtype`): all three take the Hopper route
            model.compute_dtype = torch.bfloat16
            before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
            trainer.training_step(batch)
            assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
            assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results["cpu"], results[str(dev)]
    assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
    for name in g_cpu:
        scale = g_cpu[name].abs().max().item()
        assert (g_gpu[name] - g_cpu[name]).abs().max().item() <= 1e-4 * scale, name


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ----------------------------------------------------------------- speculative decode and the host KV tier
def test_verify_rows_through_the_hopper_kernel(dev):
    """Verify rows (8 rows of K + 1 = 5 query tokens, the spec phase's
    shape at a narrow width) through the Hopper paged kernel against the
    plain version, elementwise within 2**-7 * |plain| + 1e-3."""
    rng = np.random.default_rng(3)
    B, T, N, K, H, bs, mb = 8, 5, 14, 2, 128, 16, 16
    nb = B * mb + 1
    q = torch.from_numpy(rng.standard_normal((B, T, N, H), dtype=np.float32)).to(dev, torch.bfloat16)
    pk, pv = (torch.from_numpy(rng.standard_normal((nb, K, bs, H), dtype=np.float32)).to(dev, torch.bfloat16)
              for _ in range(2))
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb).astype(np.int32)).to(dev)
    q_start = torch.tensor([0, 15, 16, 100, 200, 255 - T, 31, 64], dtype=torch.int32, device=dev)
    q_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    sm90 = pa.LAUNCHES_SM90
    out = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens)
    assert pa.LAUNCHES_SM90 == sm90 + 1
    ref = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens)
    assert ((out.float() - ref.float()).abs() <= 2**-7 * ref.float().abs() + 1e-3).all()


def test_speculative_engine_kernel_path_matches_plain_path(dev):
    """n-gram speculation on the card: in fp32 the verify forward through the
    kernel gives the plain gather path's greedy streams; in bf16 its
    launches all take the Hopper route and its streams equal those of the
    plain decode without speculation, bit for bit."""
    cfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    prompts = [[5, 6, 7, 8, 9, 5, 6, 7, 8, 9, 5, 6], [30] * 12]
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=dtype)
        for kernel in (True, False):
            eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                                  dtype=dtype, use_speculative=True)
            eng.infer.use_paged_kernel = kernel
            pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
            outs[dtype, kernel] = eng.generate(prompts, SamplingParams(max_new_tokens=24))
            assert eng.spec_stats["verify_steps"] > 0
            if kernel:
                assert pa.LAUNCHES > 0 and (pa.LAUNCHES_SM90 == pa.LAUNCHES) == (dtype == torch.bfloat16)
        eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64, max_blocks_per_seq=8, dtype=dtype)
        outs[dtype, "plain decode"] = eng.generate(prompts, SamplingParams(max_new_tokens=24))
    assert outs[torch.float32, True] == outs[torch.float32, False]
    assert outs[torch.bfloat16, True] == outs[torch.bfloat16, "plain decode"]


def test_draft_forward_takes_the_hopper_flash_route(dev):
    """A bf16 draft model at head_dim 64 proposes through the Hopper flash
    forward: one launch per layer and draft step, none on the SIMT route."""
    cfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    dcfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=1,
                       num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    draft = Qwen2ForCausalLM.init_random(dcfg, seed=1, device=dev, dtype=torch.bfloat16)
    eng = InferenceEngine(model, max_batch_size=2, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                          draft_model=draft, spec_draft_len=4)
    before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    out = eng.generate([[5, 6, 7, 8], [40, 41, 42]], SamplingParams(max_new_tokens=10))
    assert [len(o) for o in out] == [10, 10]
    fwd, fwd90 = fa.LAUNCHES["fwd"] - before["fwd"], fa.LAUNCHES_SM90["fwd"] - sm90["fwd"]
    assert fwd == fwd90 == eng.spec_stats["verify_steps"] * 4 * dcfg.num_hidden_layers > 0


def test_host_tier_round_trip_on_the_card(dev):
    """Spill to pinned host memory on the side stream and promote back: the
    promoted blocks hold the spilled bytes and the stream after the promote
    equals a never-evicting engine's."""
    cfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    prefix = list(range(5, 69))  # 4 blocks of 16
    kw = dict(max_batch_size=2, block_size=16, max_blocks_per_seq=16)
    eng = InferenceEngine(model, num_blocks=9, host_kv_blocks=32, **kw)
    eng.generate([prefix + [70, 71]], SamplingParams(max_new_tokens=4))
    blocks = [eng.mgr._index[h] for h in eng.mgr._chain_hashes(prefix, 4)]
    spilled = eng.pool.kv[:, :, blocks].clone()
    eng.generate([[72 + i % 50 for i in range(120)]], SamplingParams(max_new_tokens=4))  # evicts the prefix
    tier = eng._host_tier
    assert tier.stats["spills"] >= 4
    assert all(plane.is_pinned() for plane in tier.planes)
    got = eng.generate([prefix + [80, 81]], SamplingParams(max_new_tokens=8))[0]
    assert tier.stats["promoted_blocks"] >= 4
    promoted = [eng.mgr._index[h] for h in eng.mgr._chain_hashes(prefix, 4)]
    assert torch.equal(eng.pool.kv[:, :, promoted], spilled)
    ref = InferenceEngine(model, num_blocks=64, enable_prefix_cache=False, **kw)
    assert got == ref.generate([prefix + [80, 81]], SamplingParams(max_new_tokens=8))[0]


# ----------------------------------------------------------------- multi-LoRA
LORA_CFG = dict(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2, num_attention_heads=7,
                num_key_value_heads=1, head_dim=64, eos_token_id=None)
LORA_JOBS = [(list(range(3, 40)), "ad-0"), ([5, 6, 7], "ad-1"), (list(range(50, 70)), "ad-2"), ([9, 8, 7, 6], None)]


def _lora_registry(cfg, ids=("ad-0", "ad-1", "ad-2"), pool_slots=4, seed=0):
    """Random rank-8 adapters on all seven projections, strong enough to
    steer the greedy tokens."""
    from paddlenlp_tpu_torch.serving.tenancy import AdapterRegistry, adapter_dims_from_config

    reg = AdapterRegistry(cfg, max_rank=8, pool_slots=pool_slots)
    rng = np.random.default_rng(seed)
    L = cfg.num_hidden_layers
    for aid in ids:
        reg.add(aid, {proj: {"A": (rng.standard_normal((L, d_in, 8)) / np.sqrt(d_in)).astype(np.float32),
                             "B": (rng.standard_normal((L, 8, d_out)) * 0.2).astype(np.float32)}
                      for proj, (d_in, d_out) in adapter_dims_from_config(cfg).items()})
    return reg


def _run_jobs(eng, jobs, n):
    ids = [eng.add_request(p, SamplingParams(max_new_tokens=n), adapter_id=a) for p, a in jobs]
    done = {}
    while eng.has_work():
        done.update((r.req_id, r) for r in eng.step())
    return [done[i].output_ids for i in ids]


def test_lora_engine_kernel_path_matches_plain_path(dev):
    """A batch mixing three adapters and a base row: in fp32 the kernel path
    (the SIMT kernel) gives the plain gather path's greedy streams, for
    monolithic and chunked prefill; in bf16 every paged launch takes the
    Hopper route and the adapters steer (four different streams)."""
    cfg = Qwen2Config(**LORA_CFG)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=dtype)
        for kernel in (True, False):
            for chunk in (None, 8):
                eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                                      dtype=dtype, prefill_chunk_tokens=chunk, adapter_registry=_lora_registry(cfg))
                eng.infer.use_paged_kernel = kernel
                pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
                outs[dtype, kernel, chunk] = _run_jobs(eng, LORA_JOBS, 12)
                assert (pa.LAUNCHES > 0) == kernel
                assert pa.LAUNCHES_SM90 == (pa.LAUNCHES if dtype == torch.bfloat16 else 0)
    for chunk in (None, 8):
        assert outs[torch.float32, True, chunk] == outs[torch.float32, False, chunk]
    assert len({tuple(s) for s in outs[torch.bfloat16, True, None]}) == len(LORA_JOBS)


def test_lora_rows_are_independent_at_a_fixed_shape(dev):
    """One bf16 [8, 1] decode forward through the Hopper route, twice over
    the same pool: row 0 keeps its adapter, rows 1-7 change theirs. Row 0's
    logits are equal bit for bit; every other row's change."""
    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.backend import SingleDeviceBackend
    from paddlenlp_tpu_torch.experimental.inference_model import gather_lora
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool

    cfg = Qwen2Config(**LORA_CFG)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    reg = _lora_registry(cfg, ids=("ad-0", "ad-1", "ad-2", "ad-3"))
    slots = [reg.acquire(a) for a in ("ad-0", "ad-1", "ad-2", "ad-3")]
    backend = SingleDeviceBackend(model, max_batch_size=8, block_size=16, num_blocks=8, max_blocks_per_seq=4,
                                  dtype=torch.bfloat16, decode_steps=1, eos_ids=set(), adapter_registry=reg)
    lora = backend._lora_tree()
    infer = PagedInferenceModel(model, block_size=16, num_blocks=8 * 3 + 1, max_blocks_per_seq=3, dtype=torch.bfloat16)
    pool = init_paged_pool(cfg, 8 * 3 + 1, 16, dtype=torch.bfloat16, device=dev)
    B, T, S = 8, 40, 48
    tables = torch.arange(1, B * 3 + 1, dtype=torch.int32, device=dev).reshape(B, 3)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (B, T)).astype(np.int32)).to(dev)
    first = [slots[j % 4] for j in range(B)]
    infer._forward(pool, ids, tables, torch.arange(T, device=dev)[None].expand(B, T),
                   torch.arange(S, device=dev)[None] < T, i32([0] * B), i32([T - 1] * B), q_lens=i32([T] * B),
                   lora_rows=gather_lora(lora, i32(first)))
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    outs = [infer._forward(pool, ids[:, -1:], tables, i32([[T]] * B), torch.arange(S, device=dev)[None] <= T,
                           i32([T] * B), i32([0] * B), lora_rows=gather_lora(lora, i32(table)))
            for table in (first, [first[0]] + [slots[(j + 1) % 4] for j in range(1, B)])]
    assert pa.LAUNCHES == pa.LAUNCHES_SM90 == 2 * cfg.num_hidden_layers
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(not torch.equal(outs[0][j], outs[1][j]) for j in range(1, B))


def test_lora_device_pool_follows_the_host_pool(dev):
    """Loads, evictions, removals and re-adds over a 2-slot pool: after each,
    the backend's device copy (refreshed slot by slot) equals the host pool
    bit for bit."""
    from paddlenlp_tpu_torch.experimental.backend import SingleDeviceBackend

    cfg = Qwen2Config(**LORA_CFG)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    reg = _lora_registry(cfg, ids=("ad-0", "ad-1", "ad-2", "ad-3"), pool_slots=2)
    backend = SingleDeviceBackend(model, max_batch_size=2, block_size=16, num_blocks=8, max_blocks_per_seq=4,
                                  dtype=torch.bfloat16, decode_steps=1, eos_ids=set(), adapter_registry=reg)
    spare = _lora_registry(cfg, ids=("ad-4",), seed=9)

    def same():
        dev_pool = backend._lora_tree()
        return all(torch.equal(dev_pool[p][k].cpu(), torch.from_numpy(a)) for p, w in reg._pool.items()
                   for k, a in w.items())

    ops = [lambda: reg.acquire("ad-0"), lambda: reg.acquire("ad-1"), lambda: reg.release("ad-0"),
           lambda: reg.acquire("ad-2"), lambda: reg.release("ad-1"), lambda: reg.acquire("ad-3"),
           lambda: reg.release("ad-2"), lambda: reg.release("ad-3"), lambda: reg.remove("ad-3"),
           lambda: reg.add("ad-3", spare.weights_of("ad-4")), lambda: reg.acquire("ad-3"),
           lambda: reg.acquire("ad-0"), lambda: reg.reset_refs()]
    assert same()
    for op in ops:
        op()
        assert same(), op
    assert reg.stats()["evictions"] >= 3


# ----------------------------------------------------------------- quantized weights
@pytest.mark.parametrize("M", [1, 8, 17, 64])
def test_int8_linear_on_the_card_equals_cpu(dev, M):
    """``torch._int_mm`` refuses M <= 16 on CUDA: 1 and 8 rows are padded to
    17, and the integer sums are exact, so the card's result equals the CPU's
    bit for bit at every M, dynamic and static scales, fp32 and bf16 out."""
    from paddlenlp_tpu_torch.quantization import a8w8, quantization_utils

    rng = np.random.default_rng(M)
    w = torch.from_numpy(rng.standard_normal((448, 256)).astype(np.float32) * 0.05)
    q, s = quantization_utils._quantize_array(w, 8)
    q = q.t().contiguous().t()  # the a8w8 layout: column-major
    x = torch.from_numpy(rng.standard_normal((M, 448)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    for out in (torch.float32, torch.bfloat16):
        for act in (None, 0.03):
            want = a8w8.int8_linear(x.to(out), q, s, bias=bias, act_scale=act, out_dtype=out)
            got = a8w8.int8_linear(x.to(dev, out), q.to(dev), s.to(dev), bias=bias.to(dev), act_scale=act,
                                   out_dtype=out)
            assert got.dtype == out and got.shape == (M, 256)
            assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), (out, act)


def test_int8_matmul_refuses_shapes_loudly(dev):
    """A K or N that is not a multiple of 8 raises; there is no fallback."""
    from paddlenlp_tpu_torch.quantization import a8w8

    a = torch.ones(8, 60, dtype=torch.int8, device=dev)
    b = torch.ones(60, 64, dtype=torch.int8, device=dev).t().contiguous().t()
    with pytest.raises(RuntimeError, match="multiple of 8"):
        a8w8.int8_matmul(a, b)


def test_quantize_params_on_the_card_equals_cpu(dev):
    """Every algorithm's tree quantized on the card equals the CPU's bit for
    bit (IEEE division by a device constant, round half to even, the int4
    nibbles, the e4m3 cast), and so do the dequantized kernels."""
    from paddlenlp_tpu_torch.quantization import QuantizationConfig, dequantize_leaf, quantize_params
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

    cfg = Qwen2Config(**LORA_CFG)
    model = Qwen2ForCausalLM.init_random(cfg, seed=3, device="cpu", dtype=torch.bfloat16)
    on_card = unflatten_params({k: v.to(dev) for k, v in flatten_params(model.params).items()})
    for algo in ("wint8", "wint4", "fp8", "a8w8"):
        qcfg = QuantizationConfig(weight_quantize_algo=algo)
        want = flatten_params(quantize_params(model.params, qcfg))
        got = flatten_params(quantize_params(on_card, qcfg))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            g = got[k].cpu()
            assert g.dtype == v.dtype and g.stride() == v.stride(), (algo, k)
            assert torch.equal(g.contiguous().view(torch.uint8), v.contiguous().view(torch.uint8)), (algo, k)
            if k.endswith("/qweight"):
                s = k[: -len("qweight")] + "scales"
                assert torch.equal(dequantize_leaf(got[k], got[s], qcfg.bits, torch.bfloat16).cpu().view(torch.int16),
                                   dequantize_leaf(v, want[s], qcfg.bits, torch.bfloat16).view(torch.int16))


@pytest.mark.parametrize("algo", ["wint8", "a8w8"])
def test_quantized_engine_kernel_path_matches_plain_path(dev, algo):
    """A ``QuantizedModel`` served in fp32: the kernel path (the SIMT kernel)
    against the plain gather path, greedy, monolithic and chunked: streams
    equal; and the paged logits against the facade's dense forward at the
    fp32 gate (rel 1e-4) over single-token sequences, whose attention is
    exact on both (``chip_smoke.single_token_logits``), and for wint8 also
    over a prompt and 8 decode steps. a8w8 rounds each activation to an int8
    code, so over a longer context the two attentions' fp32 summation orders
    can move a code across a rounding midpoint and its logits by more than
    the gate (``chip_smoke.py``'s ``wquant`` phase prints that error at
    Qwen2-7B)."""
    import chip_smoke

    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool
    from paddlenlp_tpu_torch.quantization import QuantizationConfig, QuantizedModel

    cfg = Qwen2Config(**LORA_CFG)
    base = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    model = QuantizedModel(base, QuantizationConfig(weight_quantize_algo=algo))
    prompts = [list(range(3, 40)), [5, 6, 7], list(range(50, 70))]
    outs = {}
    for kernel in (True, False):
        for chunk in (None, 8):
            eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64, max_blocks_per_seq=8,
                                  prefill_chunk_tokens=chunk, dtype=torch.float32)
            eng.infer.use_paged_kernel = kernel
            pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
            outs[kernel, chunk] = eng.generate(prompts, SamplingParams(max_new_tokens=12))
            assert (pa.LAUNCHES > 0) == kernel and pa.LAUNCHES_SM90 == 0
    for chunk in (None, 8):
        assert outs[True, chunk] == outs[False, chunk], chunk
    single = [3, 5, 9, 17, 33, 65, 100, 127]
    paged = chip_smoke.single_token_logits(torch, model, PagedInferenceModel, init_paged_pool, single, torch.float32)
    dense = model(torch.tensor(single, device=dev)[:, None], dtype=torch.float32)[:, 0]
    assert (paged - dense).abs().max().item() <= 1e-4 * dense.abs().max().item()
    if algo == "wint8":
        paged, fed = chip_smoke.paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompts[0],
                                             torch.float32, 8)
        dense = model(torch.tensor([fed], device=dev), dtype=torch.float32)[0, len(prompts[0]) - 1:]
        assert (paged - dense).abs().max().item() <= 1e-4 * dense.abs().max().item()


# ----------------------------------------------------------------- checkpoints, resume and recompute
class _Tokens:
    """32 rows of 96 random token ids (labels = ids)."""

    def __init__(self, vocab=256, seed=0):
        self.ids = np.random.default_rng(seed).integers(0, vocab, (32, 96)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "labels": self.ids[i].copy()}


_SMALL = dict(vocab_size=256, hidden_size=256, intermediate_size=384, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, head_dim=64, tie_word_embeddings=True, recompute=True,
              recompute_granularity="save_qkv_attn")


def _card_trainer(dev, out, seed=0, **kw):
    model = Qwen2ForCausalLM.init_random(Qwen2Config(**_SMALL), seed=seed, device=dev, dtype=torch.float32)
    model.compute_dtype = torch.bfloat16
    args = TrainingArguments(output_dir=str(out), per_device_train_batch_size=4, gradient_accumulation_steps=2,
                             learning_rate=1e-3, warmup_steps=1, max_steps=4, save_steps=2, logging_steps=1,
                             weight_decay=0.01, seed=0, **kw)
    return Trainer(model=model, args=args, train_dataset=_Tokens())


def test_resume_on_the_card_continues_bit_for_bit(dev, tmp_path):
    """bf16 compute over fp32 masters through the Hopper flash kernels: 4
    straight steps and 2 + resume (from other random weights) + 2 give the
    same losses, grad norms and final parameters, bit for bit; the resumed
    run's async checkpoint-4 holds the same model and optimizer bytes."""
    import filecmp

    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    straight = _card_trainer(dev, tmp_path / "straight")
    straight.train()
    resumed = _card_trainer(dev, tmp_path / "resumed", seed=1, async_save=True)
    resumed.train(resume_from_checkpoint=str(tmp_path / "straight" / "checkpoint-2"))
    keys = ("global_step", "loss", "grad_norm", "learning_rate")
    logs = [[[h[k] for k in keys] for h in t.state.log_history if "grad_norm" in h] for t in (straight, resumed)]
    assert logs[0] == logs[1] and len(logs[0]) == 4
    a, b = flatten_params(straight.model.params), flatten_params(resumed.model.params)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for name in ("model.safetensors", "optimizer.safetensors"):
        assert filecmp.cmp(tmp_path / "straight" / "checkpoint-4" / name,
                           tmp_path / "resumed" / "checkpoint-4" / name, shallow=False), name


def test_async_save_from_card_tensors(dev, tmp_path):
    """The async save copies the card's parameters and moments to the host
    before it returns: updating them in place right after does not reach the
    checkpoint, which loads back bit for bit."""
    from paddlenlp_tpu_torch.trainer import TrainerState
    from paddlenlp_tpu_torch.trainer import unified_checkpoint as uc
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    trainer = _card_trainer(dev, tmp_path / "run")
    trainer.create_optimizer_and_scheduler(4)
    trainer.training_step({k: np.stack([_Tokens()[i][k] for i in range(8)]) for k in ("input_ids", "labels")})
    want = {k: t.detach().cpu().clone() for k, t in flatten_params(trainer.model.params).items()}
    want_mu = {k: t.cpu().clone() for k, t in trainer.optimizer.mu.items()}
    ckpt = str(tmp_path / "checkpoint-1")
    uc.save_unified_checkpoint(ckpt, model=trainer.model, optimizer=trainer.optimizer,
                               trainer_state=TrainerState(global_step=1), async_save=True)
    with torch.no_grad():
        for t in flatten_params(trainer.model.params).values():
            t.add_(1.0)
        for t in trainer.optimizer.mu.values():
            t.add_(1.0)
    assert uc.join_pending_saves(timeout=120.0) == 0
    assert uc.validate_checkpoint(ckpt) is None
    other = _card_trainer(dev, tmp_path / "other", seed=5)
    other.create_optimizer_and_scheduler(4)
    assert uc.load_unified_checkpoint(ckpt, other.model, other.optimizer).global_step == 1
    got = flatten_params(other.model.params)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)
    assert all(torch.equal(other.optimizer.mu[k].cpu(), want_mu[k]) for k in want_mu)
    assert other.optimizer.count == 1


def test_offload_attn_on_the_card(dev):
    """``offload_attn`` keeps q/k/v and the attention output in pinned host
    memory: the same loss and gradients, bit for bit, as ``save_qkv_attn``,
    with the flash kernels on the Hopper route."""
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    ids = torch.from_numpy(_Tokens().ids[:4]).to(dev)
    out = {}
    for granularity in ("save_qkv_attn", "offload_attn"):
        cfg = Qwen2Config(**{**_SMALL, "recompute_granularity": granularity})
        model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
        model.compute_dtype = torch.bfloat16
        leaves = flatten_params(model.params)
        for t in leaves.values():
            t.requires_grad_(True)
        sm90 = dict(fa.LAUNCHES_SM90)
        loss = causal_lm_loss(model.forward(ids), ids, shift=True)
        loss.backward()
        torch.cuda.synchronize()
        assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}
        out[granularity] = (loss.item(), {k: t.grad.cpu() for k, t in leaves.items()})
    (want_loss, want), (got_loss, got) = out["save_qkv_attn"], out["offload_attn"]
    assert got_loss == want_loss
    assert all(torch.equal(got[k], want[k]) for k in want)


# ----------------------------------------------------------------------------- generate
def _bf16_gate_first_divergence(model32, prompt, got, want):
    """None when the streams agree; else the first divergence's two tokens'
    fp32 margin against the bf16 gate ``2**-7 * |logit| + 1e-3``."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return None
    row = model32(torch.tensor([list(prompt) + list(want[:j])]), dtype=torch.float32)[0, -1]
    la, lb = row[got[j]].item(), row[want[j]].item()
    return abs(la - lb) <= 2**-7 * max(abs(la), abs(lb)) + 1e-3


def test_generate_on_the_card_matches_cpu(dev):
    """Greedy ``generate`` of a small bf16 Qwen2 over a left-padded batch on
    the card equals the same call on the CPU, or parts only where the two
    tokens' fp32 margin is within the bf16 gate; one host sync a step."""
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

    cfg = Qwen2Config(vocab_size=512, hidden_size=256, intermediate_size=384, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512, eos_token_id=None,
                      pad_token_id=0)
    cpu = Qwen2ForCausalLM.init_random(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
    card = Qwen2ForCausalLM(cfg, unflatten_params({k: v.to(dev) for k, v in flatten_params(cpu.params).items()}))
    rng = np.random.default_rng(0)
    lens = (40, 64, 17)
    ids = np.zeros((3, 64), np.int64)
    mask = np.zeros((3, 64), np.int64)
    for b, n in enumerate(lens):
        ids[b, -n:] = rng.integers(1, 512, n)
        mask[b, -n:] = 1
    got, _ = card.generate(ids, attention_mask=mask, max_new_tokens=24)
    assert got.is_cuda and card.last_generate_stats["host_syncs"] == 23
    want, _ = cpu.generate(ids, attention_mask=mask, max_new_tokens=24)
    cpu32 = Qwen2ForCausalLM(cfg, unflatten_params({k: v.float() for k, v in flatten_params(cpu.params).items()}))
    for b, n in enumerate(lens):
        ok = _bf16_gate_first_divergence(cpu32, ids[b, -n:], got[b].tolist(), want[b].tolist())
        assert ok is None or ok, f"row {b} parts outside the bf16 gate"


def test_threefry_bits_on_the_card_equal_cpu(dev):
    from paddlenlp_tpu_torch.experimental.inference_model import _uniform_rows
    from paddlenlp_tpu_torch.utils import prng

    for seed in (0, 7, 2**31 - 1):
        key_c, key_g = prng.key(seed), prng.key(seed, device=dev)
        for shape in ((2, 152064), (8, 1000)):
            key_c, sub_c = prng.split(key_c)
            key_g, sub_g = prng.split(key_g)
            assert [int(t) for t in sub_g] == [int(t) for t in sub_c]
            assert torch.equal(prng.random_bits(sub_g, shape).cpu(), prng.random_bits(sub_c, shape))
    seeds = torch.tensor([0, 1, 12345], dtype=torch.int32)
    pos = torch.tensor([0, 5, 65535], dtype=torch.int32)
    got = _uniform_rows(seeds.to(dev), pos.to(dev), 4099).cpu()
    assert torch.equal(got.view(torch.int32), _uniform_rows(seeds, pos, 4099).view(torch.int32))


def test_dense_attention_fully_masked_rows_on_the_card(dev):
    """The dispatcher's XLA-path counterpart on the card, bf16 and fp32, with
    left-pad query rows that see no key: finite everywhere, and within the
    bf16 gate (fp32: 1e-5) of the same call on the CPU."""
    rng = np.random.default_rng(1)
    B, T, S, N, K, H = 2, 48, 48, 28, 4, 128
    mask = torch.ones(B, S, dtype=torch.int64)
    mask[0, :9] = 0
    for dtype, (atol, rtol) in ((torch.bfloat16, (1e-3, 2**-7)), (torch.float32, (1e-5, 0.0))):
        q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
                   for s in ((B, T, N, H), (B, S, K, H), (B, S, K, H)))
        launches = dict(fa.LAUNCHES)
        got = fa.dot_product_attention(q.to(dev), k.to(dev), v.to(dev), attention_mask=mask.to(dev))
        assert fa.LAUNCHES == launches and torch.isfinite(got).all()
        want = fa.dot_product_attention(q, k, v, attention_mask=mask)
        torch.testing.assert_close(got.cpu().float(), want.float(), atol=atol, rtol=rtol)
