"""Smoke run of the PyTorch/CUDA port (``paddlenlp_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py [--seed 0]

It builds the port's kernels from ``paddlenlp_tpu_torch/csrc`` (one ``nvcc``
per source, started together) and runs these phases, each printing one JSON
line; any failed check exits non-zero:

1. device  -- the card's name and power limit (refuses to run without CUDA);
2. build   -- ``nvcc`` for each kernel source, with its registers and spills;

Serving, the paged engine at Qwen2-7B width and depth:

3. kernel  -- the ragged paged-attention kernels against their plain PyTorch
              version at Qwen2-7B attention shapes (28 query heads over 4 KV
              heads, head_dim 128, block 16): one ragged batch of 512-token
              prefill chunks, decode rows at contexts up to 4096 and a dead
              row, with bf16 queries over bf16, int8 and fp8 pools and with
              fp32 queries over an fp32 pool; the monolithic-prefill shape,
              2048 query tokens at contexts up to 2048; and the engine's
              decode call, 8 rows of one token at contexts 256-2112. bf16 over
              bf16 takes the Hopper kernel (``paged_attention_sm90.cu``, split
              kv walk in decode), the rest the SIMT kernel
              (``paged_attention.cu``), and each case checks its route; the
              Hopper cases give bitwise equal results over two launches;
              times against the card's bound, the plain version and
              ``scaled_dot_product_attention``;
4. engine  -- ``InferenceEngine`` serving 8 requests on Qwen2-7B at its
              published widths and depth with random bf16 weights from
              ``--seed``, once with monolithic prefill and once with 512-token
              chunks, every attention launch on the Hopper route;
5. profile -- ``torch.profiler`` over one steady decode call of the engine
              (its launches on the Hopper route too);
6. logits  -- one 1024-token request through prefill and 16 decode steps on
              the kernel path (fp32: the SIMT kernel; bf16: the Hopper one)
              against the dense forward over the same tokens;

Training, ``run_pretrain`` at Qwen2-1.5B width and depth:

7. flash_kernel -- the flash-attention forward, dq and dk/dv kernels against
              their plain versions, elementwise, at the training path's shape
              (q [2, 4096, 12, 128] bf16 over k/v [2, 4096, 2, 128], causal),
              in fp32, with segments and a window, and at T = 4095; bf16 takes
              all three through the Hopper tensor-core kernels
              (``flash_attention_sm90.cu``), fp32 through the SIMT kernels
              (``flash_attention.cu``), and each case checks its route; the
              bf16 dq gives bitwise equal results over two launches; times
              against the bound, the plain versions and
              ``scaled_dot_product_attention``;
8. train_grad -- Qwen2-1.5B widths, 2 layers: the loss and every gradient
              leaf through the kernels against the attention through the
              plain versions, in fp32 (the SIMT kernels) and at bf16 compute
              (the Hopper kernels), with the bf16-vs-fp32 control;
9. train   -- ``paddlenlp_tpu_torch.llm.run_pretrain.main`` on the repo's
              Qwen2 recipe (``llm/config/qwen2/pretrain_argument.json``) cut
              to one card and 4 steps (each cut printed under ``reduced``),
              Qwen2-1.5B at full width and depth with random weights and a
              Markov-chain corpus from ``--seed``; per-step loss, grad norm,
              time, tokens/s, MFU and peak memory; the forward, dq and dk/dv
              launches all on the Hopper route; the saved checkpoint loads
              back bit for bit;
10. train_profile -- ``torch.profiler`` over one more training step;
11. kernels -- every kernel with its launches on the serving and training
              runs, each on its own route, and its check.

The last three lines are the ``nvidia-smi`` name/power line, the kernels JSON
object (eight rows: the paged kernel, the flash forward, dq and dk/dv, each on
the Hopper and on the SIMT route) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

# Qwen/Qwen2-7B config.json (https://huggingface.co/Qwen/Qwen2-7B/blob/main/config.json)
QWEN2_7B = dict(
    vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
    num_attention_heads=28, num_key_value_heads=4, max_position_embeddings=131072,
    rms_norm_eps=1e-6, rope_theta=1000000.0, hidden_act="silu", initializer_range=0.02,
    tie_word_embeddings=False, use_sliding_window=False, sliding_window=131072, max_window_layers=28,
    bos_token_id=151643, eos_token_id=151643,
)

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
              "float32": 67e12}  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)

# kernel vs plain version, elementwise: |err| <= RTOL * |ref| + ATOL. A bf16
# output is one rounding of an fp32 value; the two fp32 values differ only in
# summation order, so they round at most one bf16 ulp apart (<= 2**-7 * |x|);
# ATOL takes the fp32 differences near zero. It scales with |out|, which
# shrinks to ~sqrt(e / context) on long rows, so a misread block there fails.
KERNEL_TOL = {"bfloat16": (2**-7, 1e-3),
              "float32": (0.0, 1e-4)}  # summation order only
LOGITS_REL_TOL = 1e-4  # fp32 paged vs fp32 dense: summation order only


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def pct(values, q):
    s = sorted(values)
    return s[min(int(q * len(s)), len(s) - 1)] if s else float("nan")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------------- kernel
# (query tokens per row, q_start, q_lens) of the three launch shapes the engine gives the kernel
BATCHES = {
    # chunked/mixed step: 3 chunks of 512 (contexts 512/1024/2048), 4 decodes
    # (contexts 256/1024/2048/4096), 1 dead row
    "ragged": (512, [0, 512, 1536, 255, 1023, 2047, 4095, 0], [512, 512, 512, 1, 1, 1, 1, 0]),
    # monolithic prefill of 2048 tokens, and a 1024-token suffix after a cached 1024-token prefix
    "prefill": (2048, [0, 1024], [2048, 1024]),
    # the decode call: 8 rows of one token at contexts 256-2112 (prompts of
    # 256-2048 tokens and up to 64 new ones), the launch the engine makes most
    "decode": (1, [255, 511, 767, 1023, 1279, 1535, 1791, 2111], [1] * 8),
}
# (batch, query dtype, pool) of every case the kernel phase checks: bf16
# queries over a bf16 pool, the main path's types, take the Hopper kernel
CASES = [("ragged", "bfloat16", "bf16"), ("ragged", "bfloat16", "int8"), ("ragged", "bfloat16", "fp8"),
         ("ragged", "float32", "fp32"), ("prefill", "bfloat16", "bf16"), ("decode", "bfloat16", "bf16")]


def kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed):
    """Unit-normal q/K/V at Qwen2-7B attention shapes over a shuffled pool."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    N, K, H, bs = 28, 4, 128, 16
    T, q_start, q_lens = BATCHES[batch]
    B = len(q_start)
    mb = 4096 // bs
    nb = B * mb + 1
    q = torch.randn(B, T, N, H, generator=g, device=DEVICE).to(getattr(torch, q_dtype))
    pk = torch.randn(nb, K, bs, H, generator=g, device=DEVICE)
    pv = torch.randn(nb, K, bs, H, generator=g, device=DEVICE)
    perm = torch.randperm(nb - 1, generator=g, device=DEVICE) + 1
    tables = perm[: B * mb].reshape(B, mb).to(torch.int32).contiguous()
    ks = vs = None
    if kv == "bf16":
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
    elif kv != "fp32":
        qd = torch.int8 if kv == "int8" else torch.float8_e4m3fn
        pk, ks = quantize_kv(pk, qd)
        pv, vs = quantize_kv(pv, qd)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    return dict(q=q, pool_k=pk, pool_v=pv, block_tables=tables, q_start=i32(q_start), q_lens=i32(q_lens),
                k_scale=ks, v_scale=vs)


def kernel_bound(args):
    """Least time the card could take: every needed input byte read once and
    the output written once over HBM bandwidth, or the attention flops this
    batch's causal masks need at the card's peak for q's type -- the larger."""
    q = args["q"]
    B, T, N, H = q.shape
    _nb, K, bs, _ = args["pool_k"].shape
    mb = args["block_tables"].shape[1]
    kv_item = args["pool_k"].element_size()
    live_tokens = sum(args["q_lens"].tolist())
    # live query rows in, every output row out (dead rows are written as zeros)
    nbytes = (live_tokens * N * H + q.numel()) * q.element_size() + sum(
        t.numel() * t.element_size() for t in (args["block_tables"], args["q_start"], args["q_lens"]))
    flops = 0
    for start, qlen in zip(args["q_start"].tolist(), args["q_lens"].tolist()):
        if qlen == 0:
            continue
        blocks = min((start + qlen - 1) // bs + 1, mb)
        per_block = K * bs * (2 * H * kv_item + (8 if args["k_scale"] is not None else 0))
        nbytes += blocks * per_block
        ctx = sum(start + t + 1 for t in range(qlen))  # kv positions each live query sees
        flops += 4 * N * H * ctx  # q.k and p.v, 2 flops per multiply-add
    peak = PEAK_FLOPS[str(q.dtype).removeprefix("torch.")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_cuda(torch, fn, iters, flush):
    """Mean ms per call with CUDA events, the L2 flushed before each call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def phase_kernel(torch, pa, quantize_kv, seed):
    import torch.nn.functional as F

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    cases = []
    for batch, q_dtype, kv in CASES:
        args = kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed)
        route = "sm90" if (q_dtype, kv) == ("bfloat16", "bf16") else "simt"
        sm90_before = pa.LAUNCHES_SM90
        out = pa.ragged_paged_attention(**args)
        sm90 = pa.LAUNCHES_SM90 - sm90_before
        again = pa.ragged_paged_attention(**args)
        ref = pa.ragged_paged_attention_ref(**args)
        torch.cuda.synchronize()
        name = f"{batch} q {q_dtype} pool {kv}"
        check(sm90 == (route == "sm90"), f"kernel {name}: a {route} case took the Hopper route {sm90} times")
        # no atomics on the Hopper route: the same inputs give the same bits
        check(route == "simt" or torch.equal(out, again), f"kernel {name}: two launches differ")
        rtol, atol = KERNEL_TOL[q_dtype]
        err = (out.float() - ref.float()).abs()
        worst = (err / (rtol * ref.float().abs() + atol)).max().item()  # <= 1 passes
        check(torch.isfinite(out.float()).all().item(), f"kernel {name}: non-finite output")
        check(worst <= 1.0, f"kernel {name}: |kernel - plain| exceeds {rtol}*|plain| + {atol} "
                            f"(worst element at {worst:.3g}x its bound)")
        for b, qlen in enumerate(args["q_lens"].tolist()):
            check(bool((out[b, qlen:] == 0).all()), f"kernel {name}: dead rows of sequence {b} are not exact zeros")
        ms = time_cuda(torch, lambda: pa.ragged_paged_attention(**args), 20, flush)
        plain_ms = time_cuda(torch, lambda: pa.ragged_paged_attention_ref(**args), 3, flush)
        # the yardstick: one library call on K/V gathered (and dequantized) beforehand
        B, T, N, H = args["q"].shape
        _nb, K, bs, _ = args["pool_k"].shape
        S = args["block_tables"].shape[1] * bs
        tab = args["block_tables"].long()

        def gathered(pool, sc):
            x = pool[tab].float()
            if sc is not None:
                x = x * sc[tab]
            return x.to(args["q"].dtype).permute(0, 2, 1, 3, 4).reshape(B, K, S, H).contiguous()

        kg, vg = gathered(args["pool_k"], args["k_scale"]), gathered(args["pool_v"], args["v_scale"])
        qh = args["q"].transpose(1, 2).contiguous()
        pos = args["q_start"].long()[:, None] + torch.arange(T, device=DEVICE)[None, :]
        mask = (torch.arange(S, device=DEVICE)[None, None, :] <= pos[:, :, None])[:, None]
        library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=True), 20, flush)
        bound_ms, bound_by = kernel_bound(args)
        case = dict(batch=batch, q=q_dtype, pool=kv, route=route, max_abs_err=err.max().item(), rtol=rtol, atol=atol,
                    worst_err_over_tol=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    shapes=dict(q=list(args["q"].shape), pool=list(args["pool_k"].shape)))
        emit(dict(phase="kernel", **case))
        cases.append(case)
        del args, out, again, ref, err, kg, vg, mask
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------------- engine
def traffic(np, vocab, seed):
    """8 requests, prompts of 256-2048 tokens; 4 share a 1024-token prefix;
    64 new tokens each; 2 of them seeded samplers (temperature 0.8, top-p 0.9)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 1024)
    shared = [np.concatenate([prefix, rng.integers(0, vocab, n)]) for n in (256, 512, 1024, 128)]
    other = [rng.integers(0, vocab, n) for n in (256, 640, 896, 1792)]
    prompts = [shared[0], other[0], shared[1], other[1], shared[2], other[2], shared[3], other[3]]
    sampled = {2, 5}
    return prompts, sampled


def phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, seed, chunk):
    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    eng = InferenceEngine(model, max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256,
                          prefill_chunk_tokens=chunk)
    check(eng.infer.use_paged_kernel, "the engine on CUDA must run the kernel path")

    def sp(i):
        if i in sampled:
            return SamplingParams(max_new_tokens=64, do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
        return SamplingParams(max_new_tokens=64)

    # the launches by shape: one query token a row (the decode call) or more
    # (prefills, chunks and mixed steps), counted on the way into the wrapper
    model_module = sys.modules[type(eng.infer).__module__]
    wrapper = model_module.ragged_paged_attention
    by_shape = {"decode": 0, "prefill_or_mixed": 0}

    def counted(q, *args, **kwargs):
        by_shape["decode" if q.shape[1] == 1 else "prefill_or_mixed"] += 1
        return wrapper(q, *args, **kwargs)

    done = []
    torch.cuda.synchronize()
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    model_module.ragged_paged_attention = counted
    try:
        t0 = time.perf_counter()
        # wave 1: one request with the shared prefix finishes and registers its
        # blocks; wave 2: the other 7 arrive together and 3 of them hit the cache
        eng.add_request(prompts[0], sp(0))
        while eng.has_work():
            done += eng.step()
        for i in range(1, 8):
            eng.add_request(prompts[i], sp(i))
        while eng.has_work():
            done += eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        model_module.ragged_paged_attention = wrapper
    launches, sm90 = pa.LAUNCHES, pa.LAUNCHES_SM90
    check(sum(by_shape.values()) == launches, f"engine: {by_shape} counted, {launches} launched")
    check(len(done) == 8, f"engine: {len(done)} of 8 requests finished")
    out_tokens = sum(len(r.output_ids) for r in done)
    vocab = model.config.vocab_size
    for r in done:
        check(r.finish_reason in ("length", "stop"), f"engine: request {r.req_id} ended {r.finish_reason}")
        check(r.finish_reason == "stop" or len(r.output_ids) == 64, f"engine: request {r.req_id} short")
        check(all(0 <= t < vocab for t in r.output_ids), f"engine: request {r.req_id} emitted out-of-vocab ids")
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [r.decode_time / (len(r.output_ids) - 1) * 1e3 for r in done if len(r.output_ids) > 1]
    stats = eng.stats()
    check(launches > 0, "engine: the kernel was never launched")
    check(sm90 == launches, f"engine: {sm90} of {launches} launches on the Hopper route")
    check(stats["prefix_cache"]["hits"] > 0, "engine: no prefix-cache hit")
    check(eng.ledger.verify_conservation(), "engine: goodput ledger conservation broken")
    res = dict(phase="engine", prefill="chunked" if chunk else "monolithic", chunk_tokens=chunk or 0,
               requests=len(done), output_tokens=out_tokens, wall_s=wall, tokens_per_s=out_tokens / wall,
               ttft_ms_p50=pct(ttft, 0.5), ttft_ms_p99=pct(ttft, 0.99), tpot_ms_p50=pct(tpot, 0.5),
               tpot_ms_p99=pct(tpot, 0.99), kernel_launches=launches, sm90_launches=sm90, launches_by_shape=by_shape,
               forwards=launches // model.config.num_hidden_layers, engine_steps=eng.ledger.steps,
               prefix_cache_hits=stats["prefix_cache"]["hits"],
               prefix_cached_tokens=stats["prefix_cache"]["cached_tokens"],
               ledger=eng.ledger.snapshot()["totals"], conservation=True,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(res)
    del eng
    torch.cuda.empty_cache()
    return res


def phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed):
    """Where one steady-state decode call goes (8 requests, ``decode_steps``
    sub-steps): ``torch.profiler`` over the engine step after admission,
    device time by kernel and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts, _ = traffic(np, model.config.vocab_size, seed)
    eng = InferenceEngine(model, max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=1 + 2 * eng.decode_steps))
    eng.step()  # admission: prefill + the first decode call
    torch.cuda.synchronize()
    # the profiled call's attention launches read, per layer and sub-step,
    # every live row's KV blocks up to its current position once
    cfg, bs = model.config, 16
    fed = [r.total_len - 1 for r in eng.slots if r is not None]
    kv_bytes = [sum(((p + s) // bs + 1) * bs for p in fed) * cfg.num_key_value_heads * cfg.head_dim * 2 * 2
                for s in range(eng.decode_steps)]
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(pa.LAUNCHES_SM90 == pa.LAUNCHES > 0,
          f"profile: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} launches on the Hopper route")
    # kernels and copies only: host ops and annotation ranges carry the
    # device time of the kernels they launched as well
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    # both routes' kernels, and the Hopper route's merge of kv partitions
    attn = [e for e in events if "paged_attention" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    attn_launches = sum(e.count for e in attn if "merge" not in e.key)
    res = dict(phase="profile", step="decode call, 8 rows x %d sub-steps" % eng.decode_steps,
               wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
               attention_kernel_ms=attn_ms, attention_launches=attn_launches, sm90_launches=pa.LAUNCHES_SM90,
               attention_launch_ms=attn_ms / max(attn_launches, 1),
               attention_launch_bound_ms=sum(kv_bytes) / len(kv_bytes) / HBM_BYTES_PER_S * 1e3,
               context_tokens=fed,
               top_device_ms=[[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top])
    emit(res)
    del eng
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- logits
def paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, dtype, n_decode, feed=None):
    """Prefill ``prompt`` then ``n_decode`` decode steps through the paged
    forward on the kernel path, feeding the greedy token (or ``feed[i]`` when
    given); returns (logits [1 + n_decode, V] fp32, fed token ids)."""
    bs = 16
    n_blocks = (len(prompt) + n_decode) // bs + 2
    infer = PagedInferenceModel(model, block_size=bs, num_blocks=n_blocks + 1, max_blocks_per_seq=n_blocks,
                                dtype=dtype)
    check(infer.use_paged_kernel, "logits: the paged model on CUDA must run the kernel path")
    pool = init_paged_pool(model.config, n_blocks + 1, bs, dtype=dtype, device=DEVICE)
    tables = torch.arange(1, n_blocks + 1, dtype=torch.int32, device=DEVICE)[None]
    S = n_blocks * bs
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    T = len(prompt)
    ids = torch.tensor([prompt], dtype=torch.int32, device=DEVICE)
    rows = [infer._forward(pool, ids, tables, torch.arange(T, device=DEVICE)[None],
                           torch.arange(S, device=DEVICE)[None] < T, i32([0]), i32([T - 1]),
                           q_lens=i32([T])).float()]
    fed = list(prompt)
    for step in range(n_decode):
        pos = T + step
        tok = int(rows[-1].argmax(dim=-1)) if feed is None else feed[pos]
        fed.append(tok)
        rows.append(infer._forward(pool, i32([[tok]]), tables, i32([[pos]]),
                                   torch.arange(S, device=DEVICE)[None] <= pos, i32([pos]), i32([0])).float())
    del pool
    return torch.cat(rows, dim=0), fed


def phase_logits(torch, np, model, pa, PagedInferenceModel, init_paged_pool, seed):
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, model.config.vocab_size, 1024).tolist()
    n_decode = 16
    launches = {}
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    got32, fed = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, torch.float32, n_decode)
    launches["float32"] = dict(kernels=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
    # the bf16 run is fed the fp32 run's tokens: its own greedy choices may
    # flip on a near-tie and then condition later positions on other inputs
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    got16, _ = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, torch.bfloat16, n_decode,
                            feed=fed)
    launches["bfloat16"] = dict(kernels=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
    # the dense reference: fp32 layer by layer from the same (bf16) weights
    ref = model(torch.tensor([fed], device=DEVICE), dtype=torch.float32)[0]
    ref = ref[len(prompt) - 1: len(prompt) + n_decode]
    scale = ref.abs().max().item()
    err32 = (got32 - ref).abs().max().item()
    err16 = (got16 - ref).abs().max().item()
    cos16 = torch.nn.functional.cosine_similarity(got16, ref, dim=-1).min().item()
    top1_16 = (got16.argmax(-1) == ref.argmax(-1)).float().mean().item()
    res = dict(phase="logits", positions=n_decode + 1, prompt_tokens=len(prompt), ref_max_abs=scale,
               fp32_max_abs_err=err32, fp32_rel_err=err32 / scale, fp32_rel_tol=LOGITS_REL_TOL,
               bf16_max_abs_err=err16, bf16_rel_err=err16 / scale, bf16_min_cosine=cos16,
               bf16_top1_agree=top1_16, launches=launches)
    emit(res)
    per_run = (1 + n_decode) * model.config.num_hidden_layers
    check(launches == {"float32": dict(kernels=per_run, sm90=0), "bfloat16": dict(kernels=per_run, sm90=per_run)},
          f"logits: launches {launches}, want {per_run} a run, the fp32 run's on SIMT and the bf16 run's on the "
          "Hopper route")
    check(torch.isfinite(got32).all().item() and torch.isfinite(got16).all().item(), "logits: non-finite")
    check(err32 / scale <= LOGITS_REL_TOL, f"logits: fp32 paged vs dense rel err {err32 / scale} > {LOGITS_REL_TOL}")
    check(cos16 >= 0.99, f"logits: bf16 paged vs fp32 dense min cosine {cos16} < 0.99")
    return res


# ----------------------------------------------------------------------------- flash attention
# Qwen/Qwen2-1.5B config.json (https://huggingface.co/Qwen/Qwen2-1.5B/blob/main/config.json)
QWEN2_1_5B = dict(
    model_type="qwen2", vocab_size=151936, hidden_size=1536, intermediate_size=8960, num_hidden_layers=28,
    num_attention_heads=12, num_key_value_heads=2, max_position_embeddings=131072, rms_norm_eps=1e-6,
    rope_theta=1000000.0, hidden_act="silu", initializer_range=0.02, tie_word_embeddings=True,
    use_sliding_window=False, sliding_window=131072, max_window_layers=28, bos_token_id=151643,
    eos_token_id=151643,
)
RECIPE = "llm/config/qwen2/pretrain_argument.json"

# (name, dtype, T, segments, window) of every case the flash phase checks; the
# first is the training path's launch shape: q [2, T, 12, 128] over k/v
# [2, T, 2, 128] (Qwen2-1.5B attention, micro-batch 2 x 4096), causal
FLASH_CASES = [("main", "bfloat16", 4096, False, None), ("fp32", "float32", 2048, False, None),
               ("segments+window", "bfloat16", 2048, True, 512), ("tail", "bfloat16", 4095, False, None)]


def flash_case(torch, dtype, T, segments, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, N, K, H = 2, 12, 2, 128
    q, do = (torch.randn(B, T, N, H, generator=g, device=DEVICE).to(getattr(torch, dtype)) for _ in range(2))
    k, v = (torch.randn(B, T, K, H, generator=g, device=DEVICE).to(getattr(torch, dtype)) for _ in range(2))
    seg = None
    if segments:  # three packed documents a row, boundaries off the 64-row tiles
        seg = torch.zeros(B, T, dtype=torch.int32, device=DEVICE)
        seg[:, T // 3 + 5:] = 1
        seg[:, (2 * T) // 3 + 11:] = 2
    return q, k, v, do, seg


def flash_worst(torch, got, want, dtype):
    """Worst element of |got - want| over its bound, per tensor (<= 1 passes).
    bf16 outputs: one bf16 ulp of the value (2**-7 |want|), plus fp32 noise of
    1e-3 scaled to the tensor's largest element (gradients run from ~1e-6 to
    ~1); fp32 outputs and lse: summation order only, 1e-4 of the tensor's
    largest element (at least 1e-4)."""
    out = {}
    for name in want:
        w, x = want[name].float(), got[name].float()
        big = max(w.abs().max().item(), 1.0)
        if name == "lse" or dtype == "float32":
            bound = torch.full_like(w, 1e-4 * big)
        else:
            bound = 2**-7 * w.abs() + 1e-3 * big
        err = (x - w).abs()
        out[name] = dict(max_abs_err=err.max().item(), worst=(err / bound).max().item(),
                         finite=bool(torch.isfinite(x).all().item()))
    return out


def flash_bound(torch, fa, q, k, seg, window, what):
    """Least time of one launch: the bytes it must move (each input read once,
    each output written once) over HBM bandwidth, or its matmul flops on the
    visible (row, col) pairs of this input at the card's peak for q's type --
    the larger. Forward: q.k and p.v; dq: q.k, dO.v and ds.k; dk/dv: q.k,
    dO.v, p^T.dO and ds^T.q (2 flops a multiply-add)."""
    B, T, N, H = q.shape
    K = k.shape[2]
    pairs = fa._visible(T, T, True, window, seg, q.device).sum().item() * (B if seg is None else 1)
    item = q.element_size()
    qn, kn, rows = B * T * N * H, B * T * K * H, B * N * T
    matmuls, nbytes = {
        "fwd": (2, (qn + 2 * kn + qn) * item + rows * 4),
        "bwd_dq": (3, (qn + 2 * kn + qn + qn) * item + 2 * rows * 4),
        "bwd_dkv": (4, (qn + 2 * kn + qn + 2 * kn) * item + 2 * rows * 4),
    }[what]
    if seg is not None:
        nbytes += seg.numel() * 4
    flops = matmuls * 2 * N * H * pairs
    peak = PEAK_FLOPS[str(q.dtype).removeprefix("torch.")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_flash_kernel(torch, fa, seed):
    """The three flash kernels against their plain versions, elementwise, at
    the training path's shape and three more; times against the bound, the
    plain versions and scaled_dot_product_attention."""
    import torch.nn.functional as F

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    cases = []
    for name, dtype, T, segments, window in FLASH_CASES:
        q, k, v, do, seg = flash_case(torch, dtype, T, segments, seed)
        opts = dict(segment_ids=seg, causal=True, window=window)
        sm90_before = dict(fa.LAUNCHES_SM90)
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
        delta = fa._delta(ref_out, do)  # both backward versions read the same saved tensors
        dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **opts)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, **opts)
        # bf16: all three on the Hopper route; fp32: the SIMT kernels
        route = "sm90" if dtype == "bfloat16" else "simt"
        sm90 = {w: fa.LAUNCHES_SM90[w] - sm90_before[w] for w in sm90_before}
        dq_again = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **opts)
        ref = fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta, **opts)
        torch.cuda.synchronize()
        want_sm90 = int(route == "sm90")
        check(sm90 == {"fwd": want_sm90, "bwd_dq": want_sm90, "bwd_dkv": want_sm90},
              f"flash {name}: {route} case took the Hopper route {sm90} times")
        # each block owns its rows of dq: no atomics, the same bits twice
        check(route == "simt" or torch.equal(dq, dq_again), f"flash {name}: two dq launches differ")
        del dq_again
        errs = flash_worst(torch, dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv),
                           dict(out=ref_out, lse=ref_lse, dq=ref[0], dk=ref[1], dv=ref[2]), dtype)
        del out, lse, dq, dk, dv, ref
        for t, e in errs.items():
            check(e["finite"], f"flash {name}: non-finite {t}")
            check(e["worst"] <= 1.0, f"flash {name}: {t} exceeds its bound (worst element at {e['worst']:.3g}x)")
        ms = dict(fwd=time_cuda(torch, lambda: fa.flash_attention_fwd(q, k, v, **opts), 10, flush),
                  bwd_dq=time_cuda(torch, lambda: fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **opts),
                                   10, flush),
                  bwd_dkv=time_cuda(torch, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, **opts),
                                    10, flush))
        # the plain backward, like the library's, computes dq, dk and dv in one call
        plain_fwd = time_cuda(torch, lambda: fa.flash_attention_fwd_ref(q, k, v, **opts), 2, flush)
        plain_bwd = time_cuda(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta, **opts),
                              2, flush)
        bounds = {what: flash_bound(torch, fa, q, k, seg, window, what) for what in ms}
        library = dict(fwd=None, bwd=None)
        if seg is None and window is None:  # the yardstick: one library call, never on the path
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
            doh = do.transpose(1, 2).contiguous()
            with torch.no_grad():
                library["fwd"] = time_cuda(torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True), 20, flush)
            # its backward alone: one graph, run again and again without the forward
            lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
            library["bwd"] = time_cuda(torch, lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                                          retain_graph=True), 20, flush)
            del qh, kh, vh, doh, lib_out
        case = dict(case=name, dtype=dtype, route=route, q=list(q.shape), kv=list(k.shape), segments=segments,
                    window=window, errors=errs, worst_err_over_tol=max(e["worst"] for e in errs.values()), ms=ms,
                    plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
                    bound_ms={w: b[0] for w, b in bounds.items()}, bound_by={w: b[1] for w, b in bounds.items()},
                    library_fwd_ms=library["fwd"], library_bwd_ms=library["bwd"])
        emit(dict(phase="flash_kernel", **case))
        cases.append(case)
        del q, k, v, do, seg, ref_out, ref_lse, delta
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return cases


# ----------------------------------------------------------------------------- training
class _PlainFlash:
    """The flash call through the plain versions on the card (fwd_ref, bwd_ref):
    the reference the kernels are held against in ``train_grad``."""

    def __init__(self, torch, fa):
        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v):
                out, lse = fa.flash_attention_fwd_ref(q, k, v)
                ctx.save_for_backward(q, k, v, out, lse)
                return out

            @staticmethod
            def backward(ctx, do):
                q, k, v, out, lse = ctx.saved_tensors
                do = do.contiguous()
                return fa.flash_attention_bwd_ref(q, k, v, do, lse, fa._delta(out, do))

        self.fn = Fn

    def __call__(self, q, k, v, segment_ids=None, window=None):
        assert segment_ids is None and window is None
        return self.fn.apply(q.contiguous(), k.contiguous(), v.contiguous())


# bf16 compute, model level: the loss and every gradient leaf through the
# kernels against the same step through the plain versions, both in bf16 (a
# leaf's error is |got - want| / |want| over the whole leaf; "all" over every
# leaf at once). Two bf16 runs that differ in any rounding drift apart by a
# good share of bf16's own error, so the leaf bounds sit between the
# kernels' readings (leaf <= 0.0101, all 0.0082) and the bf16-vs-fp32
# control's (leaf >= 0.0201, all >= 0.0190) over seeds 0-3 on an H100
# (PERF.md), and each run checks that its control still falls outside them.
# The loss moves ~1e-5 under any change of rounding (kernels 5e-6-1.7e-5,
# control 1.2e-5-5.8e-5): its bound only catches gross errors.
BF16_STEP_TOL = dict(loss_rel=1e-4, leaf_rel=1.4e-2, all_rel=1.2e-2)


def _grad_step(torch, fa, modeling, cfg, Qwen2ForCausalLM, causal_lm_loss, ids, seed, dtype, plain):
    """One forward and backward of a fresh model (fp32 master weights, compute
    in ``dtype``) with the attention through the kernels or, if ``plain``,
    the plain versions: (loss, {leaf: grad}, launches, Hopper-route launches)."""
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    model = Qwen2ForCausalLM.init_random(cfg, seed=seed, device=DEVICE, dtype=torch.float32)
    model.compute_dtype = getattr(torch, dtype)
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    before, sm90_before = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    kernel_attention = modeling.dot_product_attention
    if plain:
        modeling.dot_product_attention = _PlainFlash(torch, fa)
    try:
        loss = causal_lm_loss(model.forward(ids), ids, shift=True)
        loss.backward()
    finally:
        modeling.dot_product_attention = kernel_attention
    torch.cuda.synchronize()
    return (loss.item(), {k: t.grad for k, t in leaves.items()}, {n: fa.LAUNCHES[n] - before[n] for n in before},
            {n: fa.LAUNCHES_SM90[n] - sm90_before[n] for n in sm90_before})


def _step_errors(got, want):
    """How far step ``got`` is from step ``want``: the loss's relative error;
    each leaf's worst element over its largest (``leaf_max``, the fp32 gate's
    measure) and its error norm over its norm (``leaf``); and the error norm
    of every leaf at once over their norm (``all``)."""
    leaf_max, leaf, diff2, norm2 = {}, {}, 0.0, 0.0
    for k, w in want[1].items():
        d = got[1][k] - w
        leaf_max[k] = (d.abs().max() / w.abs().max().clamp_min(1e-30)).item()
        dn, wn = d.double().norm().item(), w.double().norm().item()
        leaf[k] = dn / max(wn, 1e-30)
        diff2, norm2 = diff2 + dn**2, norm2 + wn**2
    worst = lambda r: dict(worst_leaf=max(r, key=r.get), rel_err=max(r.values()))  # noqa: E731
    return dict(loss_rel_err=abs(got[0] - want[0]) / abs(want[0]), leaf_max=worst(leaf_max), leaf=worst(leaf),
                all_rel_err=(diff2 / norm2)**0.5)


def phase_train_grad(torch, fa, modeling, Qwen2Config, Qwen2ForCausalLM, causal_lm_loss, seed):
    """Qwen2-1.5B widths, 2 layers, micro-batch 2 x 1024, save_qkv_attn
    recompute: the loss and every gradient leaf through the kernels against the
    same step with the attention through the plain versions, in fp32 (the SIMT
    kernels, to summation order) and at bf16 compute (the training path's
    route, to ``BF16_STEP_TOL``, which the bf16-vs-fp32 control must exceed)."""
    cfg = Qwen2Config(**{**QWEN2_1_5B, "num_hidden_layers": 2, "recompute": True,
                         "recompute_granularity": "save_qkv_attn"})
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (2, 1024), generator=g, device=DEVICE)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for plain in (False, True):
            runs[dtype, plain] = _grad_step(torch, fa, modeling, cfg, Qwen2ForCausalLM, causal_lm_loss, ids, seed,
                                            dtype, plain)
            torch.cuda.empty_cache()
    fp32 = _step_errors(runs["float32", False], runs["float32", True])
    bf16 = _step_errors(runs["bfloat16", False], runs["bfloat16", True])
    control = _step_errors(runs["bfloat16", True], runs["float32", True])
    launches = {dtype: dict(kernels=runs[dtype, False][2], kernels_sm90=runs[dtype, False][3],
                            plain=runs[dtype, True][2]) for dtype in ("float32", "bfloat16")}
    res = dict(phase="train_grad", config="Qwen/Qwen2-1.5B widths, 2 layers", tokens=list(ids.shape), seed=seed,
               loss={f"{dtype}_{'plain' if plain else 'kernels'}": r[0] for (dtype, plain), r in runs.items()},
               grad_leaves=len(runs["float32", True][1]),
               fp32=dict(fp32, loss_rel_tol=1e-5, leaf_max_rel_tol=1e-4),
               bf16=dict(bf16, tol=BF16_STEP_TOL), bf16_vs_fp32_control=control, launches=launches)
    emit(res)
    del runs
    torch.cuda.empty_cache()
    one_each = {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}
    for dtype, want_sm90 in (("float32", 0), ("bfloat16", 2)):
        n = launches[dtype]
        check(n["kernels"] == one_each, f"train_grad {dtype}: kernel launches {n['kernels']}")
        check(n["kernels_sm90"] == {"fwd": want_sm90, "bwd_dq": want_sm90, "bwd_dkv": want_sm90},
              f"train_grad {dtype}: Hopper-route launches {n['kernels_sm90']}")
        check(n["plain"] == {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}, f"train_grad {dtype}: the plain run launched")
    check(fp32["loss_rel_err"] <= 1e-5, f"train_grad fp32: loss rel err {fp32['loss_rel_err']} > 1e-5")
    check(fp32["leaf_max"]["rel_err"] <= 1e-4, f"train_grad fp32: {fp32['leaf_max']} > 1e-4")
    check(bf16["loss_rel_err"] <= BF16_STEP_TOL["loss_rel"],
          f"train_grad bf16: kernels vs plain loss rel err {bf16['loss_rel_err']} > {BF16_STEP_TOL['loss_rel']}")
    for key, got, ctl in (("leaf_rel", bf16["leaf"]["rel_err"], control["leaf"]["rel_err"]),
                          ("all_rel", bf16["all_rel_err"], control["all_rel_err"])):
        tol = BF16_STEP_TOL[key]
        check(got <= tol, f"train_grad bf16: kernels vs plain {key} {got} > {tol}")
        check(ctl > tol, f"train_grad: the bf16-vs-fp32 control's {key} {ctl} is inside {tol}: "
                         "the bound would not tell the kernels from bf16 rounding")
    return res


def markov_corpus(np, prefix, vocab, seed, MMapIndexedDatasetBuilder, n_docs=512):
    """Documents from a Markov chain over a 64-token alphabet (each token has 4
    successors), written as int32: Qwen2 ids reach 151935, past the builder's
    uint16 default. Returns the token count."""
    rng = np.random.default_rng(seed)
    alphabet = rng.choice(vocab, 64, replace=False)
    succ = rng.integers(0, 64, (64, 4))
    builder = MMapIndexedDatasetBuilder(prefix, dtype=np.int32)
    total = 0
    for _ in range(n_docs):
        n = int(rng.integers(256, 768))
        picks = rng.integers(0, 4, n)
        state = int(rng.integers(0, 64))
        doc = np.empty(n, np.int64)
        for i in range(n):
            doc[i] = state
            state = int(succ[state, picks[i]])
        builder.add_document(alphabet[doc])
        total += n
    builder.finalize()
    return total


def phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder, workdir, seed):
    """``run_pretrain.main`` on the repo's Qwen2 recipe cut to one card and 4
    steps, at Qwen2-1.5B's published widths and full depth."""
    import os

    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    with open(RECIPE) as f:
        recipe = json.load(f)
    model_dir, data_dir, out_dir = (os.path.join(workdir, d) for d in ("model", "data", "out"))
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(QWEN2_1_5B, f)
    corpus_tokens = markov_corpus(np, os.path.join(data_dir, "corpus"), QWEN2_1_5B["vocab_size"], seed,
                                  MMapIndexedDatasetBuilder)
    cuts = dict(model_name_or_path=model_dir, tokenizer_name_or_path=None, input_dir=data_dir, output_dir=out_dir,
                tensor_parallel_degree=1, sharding_parallel_degree=1, pipeline_parallel_degree=1, sharding="",
                gradient_accumulation_steps=2, max_steps=4, warmup_steps=1, do_eval=False, save_steps=5000,
                seed=seed)
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items()
               if k not in ("model_name_or_path", "input_dir", "output_dir", "seed") and recipe.get(k) != v}
    reduced["model"] = "Qwen/Qwen2-1.5B config.json (recipe: Qwen/Qwen2-7B), random weights from --seed"
    reduced["data"] = f"{corpus_tokens} tokens of a 64-token Markov chain, int32, from --seed"
    args = {**recipe, **cuts}
    args_path = os.path.join(workdir, "pretrain_argument.json")
    with open(args_path, "w") as f:
        json.dump(args, f)

    steps = []

    class StepRecorder(TrainerCallback):
        def on_step_begin(self, *a, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()

        def on_step_end(self, *a, **kw):
            torch.cuda.synchronize()
            steps.append(dict(step_s=time.perf_counter() - self.t0,
                              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, tokens=kw.get("step_tokens")))

        def on_log(self, args, state, control, logs=None, **kw):
            if logs and "grad_norm" in logs:
                steps[-1].update(loss=logs["loss"], grad_norm=logs["grad_norm"], lr=logs["learning_rate"])

    for counts in (fa.LAUNCHES, fa.LAUNCHES_SM90):
        for name in counts:
            counts[name] = 0
    t0 = time.perf_counter()
    trainer = run_pretrain.main([args_path], device=DEVICE, callbacks=[StepRecorder()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)

    model = trainer.model
    cfg = model.config
    accum, n_steps = args["gradient_accumulation_steps"], args["max_steps"]
    step_flops = model.get_model_flops(args["per_device_train_batch_size"] * accum, args["max_seq_length"])
    for i, s in enumerate(steps):
        s.update(step=i + 1, tokens_per_s=s["tokens"] / s["step_s"],
                 mfu=step_flops / s["step_s"] / PEAK_FLOPS["bfloat16"])
        emit(dict(phase="train_step", **s))
    losses = [s.get("loss", float("nan")) for s in steps]
    check(len(steps) == n_steps, f"train: {len(steps)} of {n_steps} steps ran")
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall ({losses})")
    per_run = cfg.num_hidden_layers * accum * n_steps
    check(launches == {"fwd": per_run, "bwd_dq": per_run, "bwd_dkv": per_run},
          f"train: flash launches {launches}, want {per_run} of each (28 a micro-step)")
    check(sm90 == launches, f"train: Hopper-route launches {sm90}, want all {launches}")

    # the checkpoint save_model wrote loads back bit for bit
    t_load = time.perf_counter()
    saved = type(model).from_pretrained(out_dir, device=DEVICE, dtype=torch.float32)
    trained = flatten_params(model.params)
    loaded = flatten_params(saved.params)
    check(loaded.keys() == trained.keys() and all(torch.equal(loaded[k], trained[k].detach()) for k in trained),
          "train: the saved checkpoint does not load back bit for bit")
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".safetensors"))
    del saved, loaded, trained
    torch.cuda.empty_cache()
    steady = steps[1:] or steps
    res = dict(phase="train", entry="paddlenlp_tpu_torch.llm.run_pretrain.main", recipe=RECIPE, reduced=reduced,
               params=model.num_parameters(), layers=cfg.num_hidden_layers, micro_batch=[2, args["max_seq_length"]],
               accum=accum, steps=n_steps, wall_s=wall, losses=losses, grad_norms=[s.get("grad_norm") for s in steps],
               step_s_steady=sum(s["step_s"] for s in steady) / len(steady),
               tokens_per_s_steady=sum(s["tokens"] for s in steady) / sum(s["step_s"] for s in steady),
               mfu_steady=step_flops * len(steady) / sum(s["step_s"] for s in steady) / PEAK_FLOPS["bfloat16"],
               mfu_flops="get_model_flops(4, 4096) a step (6 N tokens + attention) over 989 TFLOP/s",
               peak_mem_gb=max(s["peak_mem_gb"] for s in steps), kernel_launches=launches, sm90_launches=sm90,
               checkpoint=dict(files=files, load_check_s=time.perf_counter() - t_load, bitwise=True))
    emit(res)
    return trainer, res


def phase_train_profile(torch, trainer):
    """One training step (2 micro-batches x 28 layers) under torch.profiler:
    the device's busy and idle share and its time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = next(iter(trainer.get_train_dataloader()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.training_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    # the first group whose name a kernel's contains takes it: the Hopper ones first
    groups = {"flash_fwd_sm90": "flash_fwd_kernel_sm90", "flash_bwd_dq_sm90": "flash_bwd_dq_kernel_sm90",
              "flash_bwd_dkv_sm90": "flash_bwd_dkv_kernel_sm90", "flash_fwd": "flash_fwd_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel", "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
    by_group = {g: 0.0 for g in list(groups) + ["gemm", "other"]}
    launches = {g: 0 for g in groups}
    for e in events:
        ms = e.self_device_time_total / 1e3
        group = next((g for g, key in groups.items() if key in e.key), None)
        if group is not None:
            launches[group] += e.count
        elif re.search(r"gemm|nvjet|cutlass|xmma|sm90_", e.key, re.I):
            group = "gemm"
        else:
            group = "other"
        by_group[group] += ms
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    res = dict(phase="train_profile", step="1 optimizer step: 2 micro-batches of 2 x 4096, 28 layers", wall_ms=wall_ms,
               device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms, device_ms_by_group=by_group,
               flash_launches=launches,
               top_device_ms=[[e.key[:90], e.self_device_time_total / 1e3, e.count] for e in top])
    emit(res)
    return res


# ----------------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights, the traffic and the corpus")
    args = ap.parse_args(argv)

    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from paddlenlp_tpu_torch.data import MMapIndexedDatasetBuilder
        from paddlenlp_tpu_torch.experimental import InferenceEngine, PagedInferenceModel, SamplingParams
        from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool, quantize_kv
        from paddlenlp_tpu_torch.llm import run_pretrain
        from paddlenlp_tpu_torch.ops import _build
        from paddlenlp_tpu_torch.ops import flash_attention as fa
        from paddlenlp_tpu_torch.ops import paged_attention as pa
        from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
        from paddlenlp_tpu_torch.trainer import TrainerCallback
        from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM
        from paddlenlp_tpu_torch.transformers.llama import modeling
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda))

    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        builds = dict(zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)))
    for stem, b in builds.items():
        log = b["log"]  # the ptxas report; None when a cached library has no saved log
        emit(dict(phase="build", source=_build.SOURCES[stem], seconds=b["seconds"], cached=b["cached"],
                  registers=None if log is None else sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)}),
                  spills=None if log is None else any(
                      "0 bytes spill stores, 0 bytes spill loads" not in ln
                      for ln in log.splitlines() if "spill stores" in ln)))
    fresh = builds["flash_attention_sm90"]
    check(fresh["cached"] or fresh["seconds"] < 60, f"build: flash_attention_sm90.cu took {fresh['seconds']:.0f} s")

    # ---- serving: the paged engine at Qwen2-7B width and depth
    cases = phase_kernel(torch, pa, quantize_kv, args.seed)

    cfg = Qwen2Config(**QWEN2_7B)
    t0 = time.perf_counter()
    model = Qwen2ForCausalLM.init_random(cfg, seed=args.seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    emit(dict(phase="model", config="Qwen/Qwen2-7B", layers=cfg.num_hidden_layers, params=model.num_parameters(),
              init_s=time.perf_counter() - t0))

    mono = phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed, None)
    chunked = phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed, 512)
    phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed)

    logits = phase_logits(torch, np, model, pa, PagedInferenceModel, init_paged_pool, args.seed)
    del model
    torch.cuda.empty_cache()

    # ---- training: run_pretrain at Qwen2-1.5B width and depth
    flash = phase_flash_kernel(torch, fa, args.seed)
    grad = phase_train_grad(torch, fa, modeling, Qwen2Config, Qwen2ForCausalLM, causal_lm_loss, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        trainer, train = phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder,
                                     workdir, args.seed)
        phase_train_profile(torch, trainer)
    del trainer
    torch.cuda.empty_cache()

    # paged rows: the Hopper kernel (bf16 over bf16, the main path: times at
    # the decode call, the launch the engine makes most) and the SIMT kernel
    # (the other pools: times at the fp32 case). Launches are the engine
    # runs' on each route: the main path never takes the SIMT kernel, which
    # the fp32 logits run checks
    by_batch = {(c["batch"], c["q"], c["pool"]): c for c in cases}
    kernels, checks = [], []
    for route, timed_case, name, source in (
            ("sm90", ("decode", "bfloat16", "bf16"), "ragged_paged_attention_sm90", "paged_attention_sm90.cu"),
            ("simt", ("ragged", "float32", "fp32"), "ragged_paged_attention", "paged_attention.cu")):
        timed = by_batch[timed_case]
        checked = [c for c in cases if c["route"] == route]
        sm90 = mono["sm90_launches"] + chunked["sm90_launches"]
        launches = sm90 if route == "sm90" else mono["kernel_launches"] + chunked["kernel_launches"] - sm90
        kernels.append(dict(
            name=name, route="cuda", source=f"paddlenlp_tpu_torch/csrc/{source}",
            replaces="paddlenlp_tpu/ops/pallas/paged_attention.py:56", launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in checked), ms=timed["ms"], plain_ms=timed["plain_ms"],
            bound_ms=timed["bound_ms"], bound_by=timed["bound_by"], library_ms=timed["library_ms"]))
        checks.append(dict(check="pass", cases=len(checked), timed_case=" ".join(timed_case), launched_by="engine",
                           launches_by_shape={k: mono["launches_by_shape"][k] + chunked["launches_by_shape"][k]
                                              for k in mono["launches_by_shape"]} if route == "sm90" else None,
                           check_launches=None if route == "sm90" else logits["launches"]["float32"]["kernels"],
                           worst_err_over_tol=max(c["worst_err_over_tol"] for c in checked)))
    # flash rows: the Hopper kernels (bf16, the main path: times at its shape)
    # and the SIMT kernels (fp32: times from the fp32 case). Launches are the
    # train run's on each route: the main path never takes the SIMT kernels,
    # which the fp32 train_grad step checks
    by_case = {c["case"]: c for c in flash}
    outputs = {"fwd": ("out", "lse"), "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}
    rows = [("fwd", "sm90", 81, "flash_attention_fwd_sm90"), ("fwd", "simt", 81, "flash_attention_fwd"),
            ("bwd_dq", "sm90", 187, "flash_attention_bwd_dq_sm90"), ("bwd_dq", "simt", 187, "flash_attention_bwd_dq"),
            ("bwd_dkv", "sm90", 227, "flash_attention_bwd_dkv_sm90"),
            ("bwd_dkv", "simt", 227, "flash_attention_bwd_dkv")]
    for what, route, line, name in rows:
        timed = by_case["main" if route == "sm90" else "fp32"]
        checked = [c for c in flash if c["route"] == route]
        sm90 = train["sm90_launches"].get(what, 0)
        launches = sm90 if route == "sm90" else train["kernel_launches"][what] - sm90
        check_launches = None if route == "sm90" else grad["launches"]["float32"]["kernels"][what]
        kernels.append(dict(
            name=name, route="cuda",
            source="paddlenlp_tpu_torch/csrc/flash_attention" + ("_sm90.cu" if route == "sm90" else ".cu"),
            replaces=f"paddlenlp_tpu/ops/pallas/flash_attention.py:{line}", launches=launches,
            max_abs_err=max(c["errors"][o]["max_abs_err"] for c in checked for o in outputs[what]),
            ms=timed["ms"][what],
            # the plain and the library backward each compute dq, dk and dv in one call
            plain_ms=timed["plain_fwd_ms"] if what == "fwd" else timed["plain_bwd_ms"],
            bound_ms=timed["bound_ms"][what], bound_by=timed["bound_by"][what],
            library_ms=timed["library_fwd_ms"] if what == "fwd" else timed["library_bwd_ms"]))
        checks.append(dict(check="pass", cases=len(checked), timed_case=timed["case"], launched_by="train",
                           check_launches=check_launches,
                           worst_err_over_tol=max(c["errors"][o]["worst"] for c in checked for o in outputs[what])))
    emit(dict(phase="kernels", kernels=[dict(k, **c) for k, c in zip(kernels, checks)]))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
