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
    """bf16 queries over a bf16, int8 or fp8 pool take the bf16 wgmma kernel
    (``LAUNCHES_SM90``; the quantized pools also ``LAUNCHES_SM90_QUANT``),
    fp32 queries the fp32 route (``LAUNCHES_SM90_F32``)."""
    args = _case(dev, q_dtype, kv_dtype, H, bs, group)
    q, pk, pv, tables, q_start, q_lens, ks, vs = args
    sm90, quant, f32 = pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT, pa.LAUNCHES_SM90_F32
    got = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_SM90 - sm90 == int(q_dtype == torch.bfloat16)
    assert pa.LAUNCHES_SM90_QUANT - quant == int(q_dtype == torch.bfloat16 and ks is not None)
    assert pa.LAUNCHES_SM90_F32 - f32 == int(q_dtype == torch.float32)
    # fp32 output: summation order and the 3xTF32 products (~2**-22 of each
    # product) only; bf16 output: two roundings of fp32 values that differ in
    # summation order, at most one ulp (2**-7 * |x|) apart
    atol, rtol = (2e-5, 0.0) if q_dtype == torch.float32 else (1e-3, 2**-7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.all(got[3] == 0)  # dead row: exact zeros
    assert torch.all(got[2, 1:] == 0)  # decode row padding: exact zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_decode_wrapper_and_launch_count(dev, dtype):
    q, pk, pv, tables, q_start, _q_lens, _, _ = _case(dev, dtype, dtype, 128, 16, 7)
    before, sm90, f32 = pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_F32
    a = pa.paged_decode_attention(q[:, 0].contiguous(), pk, pv, tables, q_start)
    b = pa.ragged_paged_attention(q[:, :1].contiguous(), pk, pv, tables, q_start,
                                  torch.ones(4, dtype=torch.int32, device=dev))[:, 0]
    assert pa.LAUNCHES == before + 2
    assert pa.LAUNCHES_SM90 == sm90 + (2 if dtype == torch.bfloat16 else 0)
    assert pa.LAUNCHES_SM90_F32 == f32 + (2 if dtype == torch.float32 else 0)
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
    raises RuntimeError naming its entry: no counter moves, and neither
    another route nor the plain version runs in its place."""
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


F32_POOLS = {"fp32": (torch.float32, torch.float32), "bf16": (torch.float32, torch.bfloat16),
             "int8": (torch.float32, torch.int8), "fp8": (torch.float32, torch.float8_e4m3fn),
             "bf16 q over fp32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("pool", list(F32_POOLS))
@pytest.mark.parametrize("split", [True, False], ids=["kv-partitions", "one-partition"])
@pytest.mark.parametrize("H,bs,group", [(128, 16, 7), (64, 8, 1), (128, 64, 3), (64, 33, 2)])
def test_paged_sm90_f32_route_matches_plain(dev, monkeypatch, H, bs, group, split, pool):
    """The fp32 route (3xTF32 ``mma.sync``) with fp32 queries over an fp32,
    bf16, int8 or fp8 pool and with bf16 queries over an fp32 pool, its kv
    walk split and whole: the ragged batch of ``_case`` plus a decode row
    whose context ends on a partition boundary, a decode row one past it and
    a q_lens 0 row; fp32 outputs within 1e-4 of the plain version (bf16
    outputs within the bf16 gate), dead rows exact zeros, two launches the
    same bits, every launch counted on the route."""
    q_dtype, kv_dtype = F32_POOLS[pool]
    q, pk, pv, tables, q_start, q_lens, ks, vs = _case(dev, q_dtype, kv_dtype, H, bs, group)
    B, T, N, _ = q.shape
    mb = tables.shape[1]
    parts, part_len = pa.kv_partitions(B + 3, T, N, N // group, mb, bs, pa._sm_count(dev.index or 0),
                                       route="sm90_f32")
    assert parts > 1
    if not split:
        monkeypatch.setattr(pa, "kv_partitions", lambda *a, **kw: (1, -(-mb * bs // 64) * 64))
    more = torch.tensor([[part_len - 1, 1], [part_len, 1], [5, 0]], dtype=torch.int32, device=dev)
    extra = torch.randn(3, T, N, H, device=dev, generator=torch.Generator(dev).manual_seed(1)).to(q_dtype)
    q = torch.cat([q, extra])
    tables = torch.cat([tables, tables[:3].flip(1)])
    q_start, q_lens = torch.cat([q_start, more[:, 0]]), torch.cat([q_lens, more[:, 1]])
    before, sm90, f32 = pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_F32
    got = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    again = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES - before, pa.LAUNCHES_SM90 - sm90, pa.LAUNCHES_SM90_F32 - f32) == (2, 0, 2)
    assert got.dtype == q_dtype
    atol, rtol = (1e-4, 0.0) if q_dtype == torch.float32 else (1e-3, 2**-7)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    assert torch.equal(got, again)
    for b, qlen in enumerate(q_lens.tolist()):
        assert torch.all(got[b, qlen:] == 0), b


@pytest.mark.parametrize("split", [True, False], ids=["kv-partitions", "one-partition"])
@pytest.mark.parametrize("H,bs,group", [(128, 16, 7), (64, 8, 1), (128, 64, 3), (64, 33, 2)])
def test_paged_sm90_f32_one_key_rows_are_exact(dev, monkeypatch, H, bs, group, split):
    """fp32 rows that see one key (single-token sequences: P = 1) come out
    of the fp32 route as that key's V bit for bit, as the plain version's
    fp32 arithmetic gives them: V is split in three exact TF32 parts."""
    q, pk, pv, tables, _q_start, _q_lens, _, _ = _case(dev, torch.float32, torch.float32, H, bs, group)
    B, T, N, _ = q.shape
    mb = tables.shape[1]
    if not split:
        monkeypatch.setattr(pa, "kv_partitions", lambda *a, **kw: (1, -(-mb * bs // 64) * 64))
    zeros, ones = torch.zeros(B, dtype=torch.int32, device=dev), torch.ones(B, dtype=torch.int32, device=dev)
    got = pa.ragged_paged_attention(q, pk, pv, tables, zeros, ones)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, zeros, ones)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    first = pv[tables[:, 0].long(), :, 0]  # [B, K, H]: position 0 of each sequence
    assert torch.equal(got[:, 0], first.repeat_interleave(group, dim=1))


@pytest.mark.parametrize("split", [True, False], ids=["kv-partitions", "one-partition"])
@pytest.mark.parametrize("pool", ["fp32", "int8"])
def test_paged_sm90_f32_long_table_matches_plain(dev, monkeypatch, pool, split):
    """Tables of 12,000 one-position blocks: in one partition a block walks
    them all and reads its table entries from the table itself (more than
    the 2,048 it stages in shared memory, which at 12,000 would pass the
    card's 227 KB a block); split, each partition stages its own. A
    40-token chunk at position 11,000 (group 4: rows split over the warps),
    a decode row at the tables' end and one at 3,000, within 1e-4 of the
    plain version, two launches the same bits."""
    from paddlenlp_tpu_torch.experimental.paged_cache import quantize_kv

    rng = np.random.default_rng(3)
    B, T, K, group, H, bs, mb = 3, 40, 2, 4, 128, 1, 12000
    N, nb = K * group, B * mb + 1
    q = torch.from_numpy(rng.standard_normal((B, T, N, H), dtype=np.float32)).to(dev)
    pk = torch.from_numpy(rng.standard_normal((nb, K, bs, H), dtype=np.float32)).to(dev)
    pv = torch.from_numpy(rng.standard_normal((nb, K, bs, H), dtype=np.float32)).to(dev)
    tables = torch.from_numpy(rng.permutation(np.arange(1, nb))[: B * mb].reshape(B, mb).astype(np.int32)).to(dev)
    q_start = torch.tensor([11000, mb - 1, 3000], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([T, 1, 1], dtype=torch.int32, device=dev)
    ks = vs = None
    if pool == "int8":
        (pk, ks), (pv, vs) = quantize_kv(pk, torch.int8), quantize_kv(pv, torch.int8)
    parts, _ = pa.kv_partitions(B, T, N, K, mb, bs, pa._sm_count(dev.index or 0), route="sm90_f32")
    assert parts > 1
    if not split:
        monkeypatch.setattr(pa, "kv_partitions", lambda *a, **kw: (1, -(-mb * bs // 64) * 64))
    f32 = pa.LAUNCHES_SM90_F32
    got = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    again = pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    want = pa.ragged_paged_attention_ref(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_SM90_F32 - f32 == 2
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0.0)
    assert torch.equal(got, again)
    assert torch.all(got[1:, 1:] == 0)


@pytest.mark.parametrize("pool", ["fp32", "int8"])
@pytest.mark.parametrize("fault", ["entry returns an error", "pointer not 16-byte aligned"])
def test_paged_sm90_f32_failed_launch_raises(dev, monkeypatch, fault, pool):
    """A refused launch on the fp32 route raises RuntimeError naming its
    entry: no counter moves, and neither another route nor the plain version
    runs in its place."""
    q, pk, pv, tables, q_start, q_lens, ks, vs = _case(dev, torch.float32, F32_POOLS[pool][1], 128, 16, 7)
    real = pa._kernel_fn

    def entry(r):  # only the route's own entry is ever asked for
        assert r == "sm90_f32", f"the {r} entry asked for in place of sm90_f32"
        return (lambda *args: 700) if fault == "entry returns an error" else real(r)

    monkeypatch.setattr(pa, "_kernel_fn", entry)
    if fault == "pointer not 16-byte aligned":  # a contiguous view 4 bytes past a 16-byte boundary
        off = 4 // pk.element_size()
        buf = torch.empty(pk.numel() + off, dtype=pk.dtype, device=dev)
        buf[off:].view(pk.shape).copy_(pk)
        pk = buf[off:].view(pk.shape)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(pa, "ragged_paged_attention_ref", plain)
    counts = lambda: (pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT, pa.LAUNCHES_SM90_F32)  # noqa: E731
    before = counts()
    with pytest.raises(RuntimeError, match="_sm90_f32\\)"):
        pa.ragged_paged_attention(q, pk, pv, tables, q_start, q_lens, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert counts() == before


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
    they are equal. Over an int8 pool (the kernel's quantized read) the
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


def test_engine_computes_in_bf16_by_default_on_the_card(dev):
    """The engine's ``dtype=None`` is bf16 on a CUDA model (fp32 on the CPU),
    where the JAX engine's default is fp32 (a port-only departure, ROADMAP
    Queue 3): the default engine's paged launches take the bf16 route, an
    engine asked for fp32 takes the fp32 entry."""
    cfg = Qwen2Config(vocab_size=128, hidden_size=448, intermediate_size=256, num_hidden_layers=2,
                      num_attention_heads=7, num_key_value_heads=1, head_dim=64, eos_token_id=None)
    model = Qwen2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    for dtype, want in ((None, torch.bfloat16), (torch.float32, torch.float32)):
        eng = InferenceEngine(model, max_batch_size=2, block_size=16, num_blocks=16, max_blocks_per_seq=4, dtype=dtype)
        assert eng.infer.dtype == want
        pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_F32 = 0
        eng.generate([[5, 6, 7]], SamplingParams(max_new_tokens=2))
        assert pa.LAUNCHES > 0
        assert (pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_F32) == ((pa.LAUNCHES, 0) if want == torch.bfloat16 else (0, pa.LAUNCHES))


# ----------------------------------------------------------------- flash attention
def _flash_case(dev, dtype, B, T, N, K, H, segments, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, T, N, H), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, K, H), dtype=np.float32)).to(dev, dtype) for _ in range(2))
    seg = None
    if segments == "packed":  # a zero-padding row: examples 0-3, then the padding tail's own segment 5
        seg = torch.full((B, T), 5, dtype=torch.int32)
        for i, (a, b) in enumerate(zip((0, 461, 950, 1403), (461, 950, 1403, 1900))):
            seg[:, a * T // 2048:b * T // 2048] = i
        seg = seg.to(dev)
    elif segments:  # packed documents with boundaries off the 64-row tiles
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
    (2048, 12, 2, 128, True, None, "packed"),  # packed SFT rows at their launch shape: causal, no window
    (1024, 12, 2, 128, True, None, False),  # the training path's heads, group 6, at a smaller T
    (300, 12, 2, 128, False, None, False),  # full attention, T not a multiple of 128
    (4095, 12, 2, 128, True, None, False),  # DPO's forward over ids[:, :-1] of 4096-token rows
])
def test_flash_kernels_match_plain(dev, dtype, T, N, K, H, causal, window, segments):
    """bf16 runs the forward, dq and dk/dv through the Hopper kernels
    (``LAUNCHES_SM90``); fp32 runs all three through the 3xTF32 Hopper
    kernels (``LAUNCHES_SM90_F32``)."""
    _flash_matches_plain(dev, dtype, T, N, K, H, causal, window, segments)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T,N,K,H,causal,window,segments", [
    (333, 2, 2, 192, True, 100, True),     # group 1, window + segments: DeepSeek-V2's MLA head dim
    (4095, 16, 16, 192, True, None, False),  # DeepSeek-V2-Lite's 16 heads, T not a multiple of the tile
    (200, 6, 1, 192, False, None, False),  # group 6, full attention
])
def test_flash_kernels_match_plain_at_head_dim_192(dev, dtype, T, N, K, H, causal, window, segments):
    """Head_dim 192 (q and k at qk_nope 128 + qk_rope 64, v padded up to
    them): bf16 runs the three Hopper kernels' ``<192>`` tile plans
    (``LAUNCHES_SM90``), fp32 the 3xTF32 kernels' ``<192>`` plans, the head
    dim split over warp pairs (``LAUNCHES_SM90_F32``)."""
    _flash_matches_plain(dev, dtype, T, N, K, H, causal, window, segments)


def test_flash_f32_route_refuses_head_dims_96_and_256(dev):
    """The fp32 route is built for head_dim 64, 128 and 192: each wrapper
    refuses 96 and 256 with ``ValueError``, and nothing launches or runs in
    its place."""
    before = dict(fa.LAUNCHES)
    for H in (96, 256):
        q, k, v, do, _ = _flash_case(dev, torch.float32, 1, 64, 2, 2, H, False)
        lse = torch.zeros(1, 2, 64, device=dev)
        for call in (lambda: fa.flash_attention_fwd(q, k, v),
                     lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, lse),
                     lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse)):
            with pytest.raises(ValueError, match="head_dim"):
                call()
    assert fa.LAUNCHES == before


def _flash_matches_plain(dev, dtype, T, N, K, H, causal, window, segments):
    q, k, v, do, seg = _flash_case(dev, dtype, 2, T, N, K, H, segments)
    sm90, f32 = dict(fa.LAUNCHES_SM90), dict(fa.LAUNCHES_SM90_F32)
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
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == _route_moves(dtype, "sm90")
    assert {n: fa.LAUNCHES_SM90_F32[n] - f32[n] for n in f32} == _route_moves(dtype, "sm90_f32")


def _route_moves(dtype, route):
    """One launch of each kernel: how far the ``route`` counter moves."""
    return {w: int(fa.kernel_route(dtype, w) == route) for w in ("fwd", "bwd_dq", "bwd_dkv")}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_flash_autograd_counts_launches(dev, dtype):
    """``LAUNCHES`` counts each kernel once on every route; ``LAUNCHES_SM90``
    moves by one forward, one dq and one dk/dv for bf16 and stays for fp32;
    ``LAUNCHES_SM90_F32`` moves by one of each for fp32 and stays for bf16."""
    q, k, v, do, _ = _flash_case(dev, dtype, 1, 100, 4, 2, 128, False)
    q.requires_grad_(True)
    before, sm90, f32 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90), dict(fa.LAUNCHES_SM90_F32)
    fa.flash_attention(q, k.requires_grad_(True), v.requires_grad_(True)).backward(do)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == _route_moves(dtype, "sm90")
    assert {n: fa.LAUNCHES_SM90_F32[n] - f32[n] for n in f32} == _route_moves(dtype, "sm90_f32")
    assert _route_moves(torch.float32, "sm90_f32") == {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1}


# (T, N, K, H, causal, window, segments): GQA 12/2 and 4/4, H 128 and 64,
# causal and full, a window, segments, T 100, 2048 and 4095, and a window of
# 0 (no row sees a key: every gradient must come out exactly zero)
F32_CASES = [(100, 12, 2, 128, True, None, False), (100, 4, 4, 64, False, None, False),
             (2048, 12, 2, 128, True, None, False), (2048, 4, 4, 64, True, 256, True),
             (2048, 12, 2, 128, False, None, True), (4095, 12, 2, 128, True, None, False),
             (4095, 4, 4, 64, True, 1000, False), (1000, 12, 2, 128, True, 0, False)]


@pytest.mark.parametrize("T,N,K,H,causal,window,segments", F32_CASES)
def test_flash_f32_backward_matches_plain_and_repeats(dev, T, N, K, H, causal, window, segments):
    """The fp32 dq and dk/dv (3xTF32 ``mma.sync``) against the plain
    backward under ``chip_smoke.py``'s fp32 gate (each element within 1e-4 of
    its tensor's largest, ``flash_worst``; printed), finite, and the same
    bits from a second launch (no atomics; dk/dv's split walks merged in
    order)."""
    import chip_smoke

    q, k, v, do, seg = _flash_case(dev, torch.float32, 2, T, N, K, H, segments)
    opts = dict(segment_ids=seg, causal=causal, window=window)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa._delta(out, do)
    f32 = dict(fa.LAUNCHES_SM90_F32)
    got = dict(dq=fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts))
    got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts)
    again = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts),
             *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts))
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, **opts)))
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES_SM90_F32[n] - f32[n] for n in f32} == {"fwd": 0, "bwd_dq": 2, "bwd_dkv": 2}
    worst = chip_smoke.flash_worst(torch, got, want, "float32")
    print(json.dumps(dict(T=T, N=N, K=K, H=H, causal=causal, window=window, segments=segments,
                          worst={n: e["worst"] for n, e in worst.items()})))
    for name, e in worst.items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)
    for name, a in zip(("dq", "dk", "dv"), again):
        assert torch.equal(got[name], a), name
    if window == 0:
        for name, g in got.items():
            assert torch.count_nonzero(g) == 0, name


@pytest.mark.parametrize("T,N,K,H,causal,window,segments", F32_CASES)
def test_flash_f32_forward_matches_plain_and_repeats(dev, T, N, K, H, causal, window, segments):
    """The fp32 forward (3xTF32 ``mma.sync``, online softmax) against the
    plain forward under ``chip_smoke.py``'s fp32 gate (each element of out
    and lse within 1e-4 of its tensor's largest, ``flash_worst``; printed),
    finite, the same bits from a second launch, one ``LAUNCHES_SM90_F32``
    forward a launch, and at a window of 0 (no row sees a key) out exactly 0
    with the plain version's lse."""
    import chip_smoke

    q, k, v, _do, seg = _flash_case(dev, torch.float32, 2, T, N, K, H, segments)
    opts = dict(segment_ids=seg, causal=causal, window=window)
    f32 = dict(fa.LAUNCHES_SM90_F32)
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, **opts)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES_SM90_F32[n] - f32[n] for n in f32} == {"fwd": 2, "bwd_dq": 0, "bwd_dkv": 0}
    worst = chip_smoke.flash_worst(torch, dict(out=out, lse=lse), dict(out=ref_out, lse=ref_lse), "float32")
    print(json.dumps(dict(T=T, N=N, K=K, H=H, causal=causal, window=window, segments=segments,
                          worst={n: e["worst"] for n, e in worst.items()})))
    for name, e in worst.items():
        assert e["finite"] and e["worst"] <= 1.0, (name, e)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    if window == 0:
        assert torch.count_nonzero(out) == 0
        assert torch.equal(lse, ref_lse)


@pytest.mark.parametrize("fault", ["entry returns an error", "pointer not 16-byte aligned"])
def test_flash_f32_failed_launch_raises(dev, monkeypatch, fault):
    """A refused launch on the fp32 Hopper route (the forward, dq or dk/dv)
    raises RuntimeError naming the entry: no counter moves, and neither
    another kernel nor the plain version runs in its place."""
    q, k, v, do, _ = _flash_case(dev, torch.float32, 1, 128, 4, 2, 128, False)
    if fault == "entry returns an error":
        real = fa._kernel_fn
        monkeypatch.setattr(fa, "_kernel_fn", lambda stem, symbol, n_ptr, n_int: (
            (lambda *args: 700) if stem == "flash_attention_sm90_f32" else real(stem, symbol, n_ptr, n_int)))
    else:  # a contiguous view 4 bytes into its buffer: the kernels' 16-byte copies refuse it
        buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
        buf[1:].view(q.shape).copy_(q)
        q = buf[1:].view(q.shape)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran in place of the kernel")

    monkeypatch.setattr(fa, "flash_attention_fwd_ref", plain)
    monkeypatch.setattr(fa, "flash_attention_bwd_ref", plain)
    lse = torch.zeros(1, 4, 128, device=dev)
    before, sm90, f32 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90), dict(fa.LAUNCHES_SM90_F32)
    with pytest.raises(RuntimeError, match="pdnlp_flash_fwd_sm90_f32"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="pdnlp_flash_bwd_dq_sm90_f32"):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, lse)
    with pytest.raises(RuntimeError, match="pdnlp_flash_bwd_dkv_sm90_f32"):
        fa.flash_attention_bwd_dkv(q, k, v, do, lse, lse)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before and fa.LAUNCHES_SM90 == sm90 and fa.LAUNCHES_SM90_F32 == f32


@pytest.mark.parametrize("fault", ["entry returns an error", "pointer not 16-byte aligned"])
def test_flash_sm90_failed_launch_raises(dev, monkeypatch, fault):
    """A refused launch on the Hopper route raises RuntimeError: neither
    counter moves, and neither another route's kernel nor the plain version
    runs in its place."""
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
    full step then launches each kernel once per layer and micro-batch: in
    fp32 all three on the fp32 Hopper route, in bf16 all three on the bf16
    Hopper route."""
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
            before, sm90, f32 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90), dict(fa.LAUNCHES_SM90_F32)
            trainer.training_step(batch)
            assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
            assert fa.LAUNCHES_SM90 == sm90  # fp32: all three on the 3xTF32 kernels
            assert {n: fa.LAUNCHES_SM90_F32[n] - f32[n] for n in f32} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
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


def test_deepseek_bf16_step_takes_the_sm90_route_at_head_dim_192(dev):
    """A tiny DeepSeek-V2 (MLA at head_dim 128 + 64, v padded to 192; layer 0
    dense, layer 1 MoE) under bf16 compute: a Trainer step of 2 micro-batches
    launches each flash kernel once a layer and micro-batch, all on the bf16
    Hopper route at head_dim 192, with a finite loss and gradients; the
    micro-step's loss through the kernels sits within bf16 rounding (rel 1e-3)
    of the same step through the plain versions on the card."""
    from paddlenlp_tpu_torch.transformers import DeepseekV2Config, DeepseekV2ForCausalLM
    from paddlenlp_tpu_torch.transformers.llama import modeling

    cfg = DeepseekV2Config(vocab_size=256, hidden_size=256, intermediate_size=384, moe_intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=64, q_lora_rank=None,
                           qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=4,
                           n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1)
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 256, (4, 96)).astype(np.int32)}
    batch["labels"] = batch["input_ids"].copy()
    args = TrainingArguments(output_dir="unused", per_device_train_batch_size=2, gradient_accumulation_steps=2,
                             learning_rate=1e-3, max_steps=1, save_strategy="no")
    model = DeepseekV2ForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    model.compute_dtype = torch.bfloat16
    trainer = Trainer(model=model, args=args)
    losses = {}
    for plain in (False, True):
        kernel_attention = modeling.dot_product_attention
        if plain:
            modeling.dot_product_attention = _PlainAttention()
        try:
            with torch.no_grad():
                losses[plain] = trainer.compute_loss(trainer._to_device(batch)).item()
        finally:
            modeling.dot_product_attention = kernel_attention
    assert abs(losses[False] - losses[True]) <= 1e-3 * abs(losses[True]), losses
    trainer.create_optimizer_and_scheduler(1)
    before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    out = trainer.training_step(batch)
    torch.cuda.synchronize()
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == {"fwd": 4, "bwd_dq": 4, "bwd_dkv": 4}
    assert np.isfinite(out["loss"].item()) and np.isfinite(out["grad_norm"].item()) and out["grad_norm"].item() > 0


def test_deepseek_fp32_step_takes_the_sm90_f32_route_at_head_dim_192(dev):
    """The same tiny DeepSeek-V2 computing in fp32 (the Trainer's default):
    one forward and backward through the kernels launches each flash kernel
    once a layer, all on the fp32 Hopper route at head_dim 192, and its loss
    and every gradient leaf equal the same step through the plain versions
    on the card at the fp32 gates (loss rel 1e-5, each leaf's worst element
    within 1e-4 of its largest), the routing replayed from the plain step's
    (``chip_smoke.PinnedRouting``)."""
    import chip_smoke as cs
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers import DeepseekV2Config, DeepseekV2ForCausalLM, moe_layers
    from paddlenlp_tpu_torch.transformers.llama import modeling

    cfg = DeepseekV2Config(vocab_size=256, hidden_size=256, intermediate_size=384, moe_intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4, kv_lora_rank=64, q_lora_rank=None,
                           qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=4,
                           n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 96))).to(dev)
    recorded = cs.PinnedRouting(moe_layers)
    with recorded:
        plain = cs._grad_step(torch, fa, modeling, cfg, DeepseekV2ForCausalLM, causal_lm_loss, ids, 0, "float32",
                              True)
    with cs.PinnedRouting(moe_layers, replay=recorded):
        kern = cs._grad_step(torch, fa, modeling, cfg, DeepseekV2ForCausalLM, causal_lm_loss, ids, 0, "float32",
                             False)
    each = {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}
    assert plain[2] == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    assert kern[2] == kern[4] == each and kern[3] == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}, kern[2:]
    errs = cs._step_errors(kern, plain)
    assert np.isfinite(kern[0]) and errs["loss_rel_err"] <= 1e-5, errs
    assert errs["leaf_max"]["rel_err"] <= 1e-4, errs


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
    forward: one launch per layer and draft step, every one on the bf16
    Hopper route."""
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
    (the fp32 route) gives the plain gather path's greedy streams, for
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
                pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_F32 = 0
                outs[dtype, kernel, chunk] = _run_jobs(eng, LORA_JOBS, 12)
                assert (pa.LAUNCHES > 0) == kernel
                assert pa.LAUNCHES_SM90 == (pa.LAUNCHES if dtype == torch.bfloat16 else 0)
                assert pa.LAUNCHES_SM90_F32 == (pa.LAUNCHES if dtype == torch.float32 else 0)
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
    """A ``QuantizedModel`` served in fp32: the kernel path (the fp32 route)
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
            pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_F32 = 0
            outs[kernel, chunk] = eng.generate(prompts, SamplingParams(max_new_tokens=12))
            assert (pa.LAUNCHES > 0) == kernel and pa.LAUNCHES_SM90 == 0 and pa.LAUNCHES_SM90_F32 == pa.LAUNCHES
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


# ----------------------------------------------------------------- the predictor and packed SFT rows
class _IdCodec:
    """A tokenizer stand-in (``w<id>`` words, one space between them): the
    predictor's host code needs no ``tokenizers`` here."""

    padding_side, chat_template, eos_token_id, pad_token_id = "right", None, 2, 0

    def encode(self, text, **kw):
        return [int(w[1:]) for w in text.split()]

    def decode(self, ids, skip_special_tokens=True, **kw):
        return " ".join(f"w{int(i)}" for i in ids if not (skip_special_tokens and int(i) in (0, 2)))


def test_block_predictor_takes_the_hopper_route(dev):
    """``create_predictor(mode="block")`` over a bf16 model on the card: its
    texts are the decode of ``InferenceEngine.generate`` with the same
    settings, and every paged launch takes the Hopper route."""
    from paddlenlp_tpu_torch.llm.predict import predictor as P

    model = Qwen2ForCausalLM.init_random(Qwen2Config(**dict(_SMALL, eos_token_id=2)), seed=0, device=dev,
                                         dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 256, n).tolist() for n in (40, 97, 130, 5)]
    tok = _IdCodec()
    args = P.PredictorArgument(model_name_or_path="(in memory)", mode="block", dtype="bfloat16", batch_size=4,
                               max_length=12, decode_strategy="greedy_search", block_size=16, num_kv_blocks=64,
                               max_blocks_per_seq=16)
    pred = P.create_predictor(args, model=model, tokenizer=tok)
    assert pred.engine.infer.use_paged_kernel
    before, sm90 = pa.LAUNCHES, pa.LAUNCHES_SM90
    got = pred.predict([tok.decode(p) for p in prompts])
    torch.cuda.synchronize()
    assert pa.LAUNCHES - before > 0 and pa.LAUNCHES_SM90 - sm90 == pa.LAUNCHES - before
    eng = InferenceEngine(model, max_batch_size=4, block_size=16, num_blocks=64, max_blocks_per_seq=16,
                          dtype=torch.bfloat16)
    want = [tok.decode(x) for x in eng.generate(prompts, SamplingParams(max_new_tokens=12))]
    assert got == want


def test_packed_sft_rows_take_the_hopper_flash_route(dev):
    """Zero-padding rows (``segment_ids`` of >= 2 examples and a padding
    tail, per-segment ``position_ids``) through a bf16-compute training step
    on the card: one launch of each flash kernel a layer and micro-batch,
    all on the Hopper route, and a finite loss."""
    from paddlenlp_tpu_torch.datasets import ZeroPaddingMapDataset

    rng = np.random.default_rng(0)
    examples = []
    for _ in range(24):
        ids = rng.integers(3, 256, int(rng.integers(20, 60))).astype(np.int32)
        examples.append({"input_ids": ids, "labels": np.where(np.arange(len(ids)) < 8, -100, ids)})
    rows = ZeroPaddingMapDataset(examples, max_length=128)
    assert all(len(np.unique(rows[i]["segment_ids"])) >= 3 for i in range(4))  # the rows the step takes
    model = Qwen2ForCausalLM.init_random(Qwen2Config(**_SMALL), seed=0, device=dev, dtype=torch.float32)
    model.compute_dtype = torch.bfloat16
    args = TrainingArguments(output_dir="unused", per_device_train_batch_size=4, gradient_accumulation_steps=2,
                             learning_rate=1e-3, max_steps=1, save_strategy="no")
    trainer = Trainer(model=model, args=args, train_dataset=rows)
    trainer.create_optimizer_and_scheduler(1)
    batch = {k: np.stack([rows[i][k] for i in range(4)]) for k in rows[0]}
    before, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    out = trainer.training_step(batch)
    torch.cuda.synchronize()
    want = {"fwd": 2 * 2, "bwd_dq": 2 * 2, "bwd_dkv": 2 * 2}  # 2 layers x 2 micro-batches (save_qkv_attn)
    assert {n: fa.LAUNCHES[n] - before[n] for n in before} == want
    assert {n: fa.LAUNCHES_SM90[n] - sm90[n] for n in sm90} == want
    assert np.isfinite(out["loss"].item())


# ----------------------------------------------------------------------------- PEFT and alignment steps
class _PlainAttention:
    """The flash call through the plain versions on the card (fwd_ref and
    bwd_ref): the reference a step through the kernels is held against."""

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            out, lse = fa.flash_attention_fwd_ref(q, k, v, scale=scale)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.contiguous()
            return fa.flash_attention_bwd_ref(q, k, v, do, lse, fa._delta(out, do), scale=ctx.scale) + (None,)

    def __call__(self, q, k, v, attention_mask=None, segment_ids=None, window=None, scale=None):
        assert attention_mask is None and segment_ids is None and window is None
        return self._Fn.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale)


#: Qwen2-1.5B's widths, cut to 2 layers
_WIDE = dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=2, num_attention_heads=12,
             num_key_value_heads=2, tie_word_embeddings=True, rope_theta=1000000.0, rms_norm_eps=1e-6)


def _kernels_vs_plain(step, leaves):
    """``step()`` -> loss, once through the kernels and once through the
    plain versions; the loss within rel 1e-5 and each of ``leaves``'s
    gradients within 1e-4 of its largest element; the kernel run's launches."""
    from paddlenlp_tpu_torch.transformers.llama import modeling

    out = {}
    for plain in (False, True):
        for t in leaves.values():
            t.grad = None
        before = dict(fa.LAUNCHES)
        kernel_attention = modeling.dot_product_attention
        if plain:
            modeling.dot_product_attention = _PlainAttention()
        try:
            loss = step()
            loss.backward()
        finally:
            modeling.dot_product_attention = kernel_attention
        torch.cuda.synchronize()
        out[plain] = (loss.item(), {k: t.grad.clone() for k, t in leaves.items()},
                      {n: fa.LAUNCHES[n] - before[n] for n in before})
    (got, g_got, launches), (want, g_want, none) = out[False], out[True]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for name in g_want:
        scale = g_want[name].abs().max().item()
        assert scale > 0 and (g_got[name] - g_want[name]).abs().max().item() <= 1e-4 * scale, name
    assert sum(none.values()) == 0
    return launches


def test_lora_step_through_kernels_equals_plain(dev):
    """A LoRA forward and backward at fp32 over Qwen2-1.5B's widths (2
    layers), rows without a padding mask (the flash kernels' fp32 routes),
    against the plain attention: the loss and the adapters' gradients."""
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    model = Qwen2ForCausalLM.init_random(Qwen2Config(**_WIDE), seed=0, device=dev, dtype=torch.float32)
    lm = LoRAModel(model, LoRAConfig(r=8, lora_alpha=16))
    g = torch.Generator(device=dev).manual_seed(1)
    adapters = {k: v for k, v in flatten_params(lm.params).items() if "/lora_" in k}
    with torch.no_grad():
        for k, v in adapters.items():
            if k.endswith("lora_B"):
                v.normal_(0.0, 0.01, generator=g)  # a trained B: A's gradient is not zero
    for v in adapters.values():
        v.requires_grad_(True)
    ids = torch.randint(0, _WIDE["vocab_size"], (2, 512), generator=g, device=dev)
    launches = _kernels_vs_plain(lambda: causal_lm_loss(lm.forward(ids), ids, shift=True), adapters)
    assert launches == {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}


def test_dpo_step_through_kernels_equals_plain(dev):
    """A DPO loss (sigmoid; the policy and its frozen reference through one
    forward each over ids[:, :-1]) and its gradient at fp32 over Qwen2-1.5B's
    widths (2 layers) at T = 1023 (no multiple of a tile), against the plain
    attention; step 1's loss is ln 2."""
    from paddlenlp_tpu_torch.trl import DPOTrainer

    model = Qwen2ForCausalLM.init_random(Qwen2Config(**_WIDE), seed=0, device=dev, dtype=torch.float32)
    trainer = DPOTrainer(model=model, args=TrainingArguments(output_dir="unused", per_device_train_batch_size=1,
                                                             max_steps=1, save_strategy="no"))
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {}
    for side in ("chosen", "rejected"):
        ids = torch.randint(0, _WIDE["vocab_size"], (1, 1024), generator=g, device=dev)
        labels = ids.clone()
        labels[:, :300] = -100  # the prompt
        batch.update({f"{side}_input_ids": ids, f"{side}_labels": labels})
    leaves = trainer.params
    for t in leaves.values():
        t.requires_grad_(True)
    launches = _kernels_vs_plain(lambda: trainer.compute_loss(batch), leaves)
    # policy and reference forwards, then the policy's backward: 2 layers each
    assert launches == {"fwd": 4, "bwd_dq": 2, "bwd_dkv": 2}
    with torch.no_grad():
        assert abs(trainer.compute_loss(batch).item() - float(np.log(2))) <= 1e-6


class _MoECfg:
    def __init__(self, **kw):
        self.__dict__.update(dict(num_local_experts=8, num_experts_per_tok=2, hidden_size=512,
                                  moe_intermediate_size=1024, router_aux_loss_coef=0.02, norm_topk_prob=True,
                                  moe_capacity_factor=4.0), **kw)  # capacity E / K: no drops


def _moe_inputs(dev, cfg, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    E, D, F = cfg.num_local_experts, cfg.hidden_size, cfg.moe_intermediate_size
    x = torch.randn(2, 512, D, generator=g, device=dev).to(dtype)
    leaves = {"gate/kernel": torch.randn(D, E, generator=g, device=dev) * 0.05,
              "w1": (torch.randn(E, D, F, generator=g, device=dev) * 0.05).to(dtype),
              "w3": (torch.randn(E, D, F, generator=g, device=dev) * 0.05).to(dtype),
              "w2": (torch.randn(E, F, D, generator=g, device=dev) * 0.05).to(dtype)}
    return x, leaves


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_layer_on_the_card_matches_the_plain_loop(dev, dispatch):
    """fp32 on the card: each dispatch against the per-expert loop
    (``moe_mlp_loop``) within 1e-4 of the output's largest element, the aux
    loss within rel 1e-5."""
    from paddlenlp_tpu_torch.transformers.moe_layers import moe_mlp, moe_mlp_loop

    cfg = _MoECfg(moe_dispatch=dispatch)
    x, leaves = _moe_inputs(dev, cfg, torch.float32)
    out, aux = moe_mlp(cfg, x, None, leaves.__getitem__)
    want, want_aux = moe_mlp_loop(cfg, x, leaves["gate/kernel"], leaves["w1"], leaves["w3"], leaves["w2"])
    assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert abs(aux.item() - want_aux.item()) <= 1e-5 * abs(want_aux.item())


def test_moe_sparse_matches_dense_on_the_card(dev):
    """bf16, at a capacity that drops nothing: the sparse dispatch within one
    bf16 rounding (2**-7) of the dense on the norm. The two round their
    weighted expert rows in different orders, and where a token's two rows
    cancel one rounding of a summand exceeds the sum: no elementwise gate."""
    from paddlenlp_tpu_torch.transformers.moe_layers import moe_mlp

    x, leaves = _moe_inputs(dev, _MoECfg(), torch.bfloat16)
    dense, aux_d = moe_mlp(_MoECfg(moe_dispatch="dense"), x, None, leaves.__getitem__)
    sparse, aux_s = moe_mlp(_MoECfg(moe_dispatch="sparse"), x, None, leaves.__getitem__)
    w = dense.float()
    assert ((sparse.float() - w).norm() / w.norm()).item() <= 2**-7
    assert torch.equal(aux_d, aux_s)  # one routing


@pytest.mark.parametrize("dispatch", ["dense", "sparse"])
def test_moe_two_launches_give_the_same_bits(dev, dispatch):
    """bf16 forward and backward twice (a capacity that drops half the
    assignments for sparse): the output, aux and every gradient bit for bit."""
    from paddlenlp_tpu_torch.transformers.moe_layers import moe_mlp

    cfg = _MoECfg(moe_dispatch=dispatch, moe_capacity_factor=0.5)
    x, leaves = _moe_inputs(dev, cfg, torch.bfloat16)
    runs = []
    for _ in range(2):
        xs = x.clone().requires_grad_(True)
        ls = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        out, aux = moe_mlp(cfg, xs, None, ls.__getitem__)
        (out.float().square().mean() + aux).backward()
        runs.append([out, aux, xs.grad] + [ls[k].grad for k in sorted(ls)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_mixtral_step_through_kernels_equals_plain(dev):
    """A Mixtral ``Trainer.compute_loss`` (LM + aux) and its gradient at fp32,
    2 layers, 8 query heads over 2 (Mixtral's group of 4), H 128, 8 experts,
    T = 512, through the flash kernels against the plain attention."""
    from paddlenlp_tpu_torch.transformers import MixtralConfig, MixtralForCausalLM

    cfg = MixtralConfig(vocab_size=4096, hidden_size=1024, intermediate_size=1536, num_hidden_layers=2,
                        num_attention_heads=8, num_key_value_heads=2)
    model = MixtralForCausalLM.init_random(cfg, seed=0, device=dev, dtype=torch.float32)
    trainer = Trainer(model=model, args=TrainingArguments(output_dir="unused", save_strategy="no"))
    g = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (2, 512), generator=g, device=dev)
    leaves = trainer.params
    for t in leaves.values():
        t.requires_grad_(True)
    launches = _kernels_vs_plain(lambda: trainer.compute_loss({"input_ids": ids, "labels": ids}), leaves)
    assert launches == {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}
    with torch.no_grad():
        _, aux = model.forward(ids, return_aux=True)
    assert aux.item() > 0
