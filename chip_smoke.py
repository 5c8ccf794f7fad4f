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
              fp32 queries over fp32 and int8 pools; the monolithic-prefill
              shape, 2048 query tokens at contexts up to 2048, over bf16 and
              int8 pools; the engine's decode call, 8 rows of one token at
              contexts 256-2112, over bf16, int8 and fp8 pools; and the
              speculative verify, 8 rows of 5 tokens. bf16 queries take the
              Hopper kernel (``paged_attention_sm90.cu``, split kv walk in
              decode; its quantized entry for int8 and fp8 pools), fp32
              queries the SIMT kernel (``paged_attention.cu``), and each case
              checks its route; the Hopper cases give bitwise equal results
              over two launches; times against the card's bound, the plain
              version and ``scaled_dot_product_attention``;
4. engine  -- ``InferenceEngine`` serving 8 requests on Qwen2-7B at its
              published widths and depth with random bf16 weights from
              ``--seed``, once with monolithic prefill and once with 512-token
              chunks, every attention launch on the Hopper route;
5. profile -- ``torch.profiler`` over one steady decode call of the engine
              (its launches on the Hopper route too);
6. logits  -- one 1024-token request through prefill and 16 decode steps on
              the kernel path (fp32: the SIMT kernel; bf16: the Hopper one)
              against the dense forward over the same tokens;
7. serve   -- ``paddlenlp_tpu_torch.serving.ServingServer`` over the same
              model on 127.0.0.1: greedy streams over HTTP (non-streaming
              and SSE) equal to ``InferenceEngine.generate``; the engine
              phase's 8 requests from 8 client threads at once (4 SSE) with
              client-side TTFT/TPOT beside the engine's own, a two-turn chat
              whose second turn reuses the first's KV, an abort mid-stream;
              ``/metrics``, ``/health``, ``/debug/efficiency``,
              ``/debug/trace`` and a ``/debug/profile`` capture holding the
              paged kernel; two in-process weight swaps with their canary
              digests and a refused uncommitted checkpoint; every paged
              launch on the Hopper route;
8. router  -- two replicas of that server (one engine each over the one
              model) behind ``paddlenlp_tpu_torch.serving.router.RouterServer``
              with prefix affinity, launched by ``launch_fleet``: 4 greedy
              prompts through the router (JSON and SSE) equal to each sent
              alone to the replica the response names; the engine phase's 8
              requests from 8 clients at once against their solo runs (a
              divergence only within twice the bf16 distance), client
              TTFT/TPOT, the split across replicas, the TTFT split into the
              router hop, the engine and the way back, single-request TTFT
              through the router minus direct, tokens/s beside ``serve``'s,
              and the burst again with one replica drained and with the
              interpreter's thread switch interval at 1 ms;
              an injected ``engine.step`` fault on the replica a shared
              prefix pins (mid-stream streams end ``replica_error``, a
              token-less one fails over token-exact, a POST in the window
              answers 200, the replica returns HEALTHY); ``POST
              /replicas/drain`` with two streams in flight (both finish); one
              autoscaler tick under a forced fast burn provisions a third
              replica that probes HEALTHY; ``lint_federation`` of the
              replicas' ``/metrics``, ``/fleet/slo``, ``/fleet/usage``,
              ``/debug/efficiency`` and a stitched two-tier ``/debug/trace``;
              every paged launch on the Hopper route;
9. spec    -- speculative decoding on the same model and engine settings:
              (a) the n-gram proposer (4 drafts, 2-grams) on 8 greedy
              requests of 512-960 extractive tokens (a random 128-token
              segment repeated), 64 new tokens each, against the same
              engine without speculation; (b) a Qwen2-0.5B draft model at
              its published widths (vocabulary cut to the target's) on 4
              requests of 256-512 tokens, 32 new tokens, greedy and
              sampled (temperature 0.9, rejection sampling); (c) the engine
              phase's mix with speculation on, which falls back to the
              plain decode while its two samplers run. Random weights do
              not continue a prompt's text, so the n-gram runs may find
              nothing to draft and keep to the plain decode. Greedy streams
              equal those without speculation (a first divergence passes
              only within the bf16 gate, printed with its fp32 margin);
              emitted = accepted + one a live row a verify step; the ledger
              conserved; every verify launch on the Hopper paged kernel and
              every draft forward on the Hopper flash kernel; the draft's
              attention launch (q [4, L, 14, 64]) against its plain version;
10. host_tier -- the host KV tier: a 256-block pool over a 512-block tier
              against a 2048-block pool that never evicts (and the small
              pool without the tier): turn 1 of 1024 tokens, a flood that
              evicts it, turn 2 on turn 1 and its output, twice; turn 2 promotes
              >= 60 blocks, holds the spilled bytes and streams the
              never-evicting engine's tokens; D2H and H2D rates, turn-2
              TTFT against a cold re-prefill; then the same as a chat over
              HTTP, whose turn 2 counts the promoted span as cached;
11. kv_quant -- the engine phase's 8 requests on the same model over an int8
              pool (monolithic and 512-token chunked prefill) and an fp8
              pool (monolithic), every paged launch on the Hopper kernel's
              quantized entry; prefix-cache hits, the ledger conserved; the
              kernel path's logits against the plain gather path's over
              int8 and fp8 pools (min cosine >= 0.99), and each one's
              distance from the fp32 logits; greedy streams against those
              of the same engine on the plain gather path (a divergence
              passes only where the two tokens' fp32 margin is within
              twice that distance; the bf16 gate is printed beside it);
              TTFT/TPOT, tokens/s, peak memory, pool bytes and the
              agreement with a bf16 pool's streams, printed; one profiled
              decode call's paged-attention device ms;
12. lora   -- multi-LoRA on the same model and engine settings: an
              ``AdapterRegistry`` (max rank 16, 4 pool slots, fp32; the pool's
              bytes printed) with three random adapters (ranks 16, 16, 8) and
              one a ``LoRAModel`` exported to a file; the engine phase's 8
              prompts (two rows on each random adapter, two on the base
              model), greedy and seeded sampling, against each request alone
              (a first divergence passes only within the bf16 gate, the
              sampled one on its sampling scores); one [8, 1] decode forward
              twice with other adapters on rows 1-7: row 0 bit for bit; five
              different greedy streams of one prompt on each adapter and the
              base model; the ``LoRAModel``'s adapter against
              ``merge_and_unload()`` (min cosine >= 0.99); five adapters over
              four slots with one pinned (evictions, ``adapter_pressure``
              deferral, no slot leaked); over HTTP ``/admin/adapters``, JSON
              and SSE completions on an adapter equal to in-process ones, an
              unknown adapter, a tenant over its KV share deferred while
              another admits, tenant and adapter ``/metrics`` labels;
              TTFT/TPOT and tokens/s with adapters and on the base model,
              profiled decode calls of each, the device pool's re-place
              times; every paged launch on the Hopper route;
13. wquant -- quantized weights on the same model and engine settings
              (``quantization.QuantizedModel``: wint8, wint4, fp8, and a8w8
              with dynamic and with calibrated activation scales), one facade
              at a time: layer 0's slice of every projection quantized and
              dequantized on the card and on the CPU, and a8w8's
              ``int8_linear`` (``torch._int_mm``) at 8 and 2048 rows, bit for
              bit; the wint8 and a8w8 facades in fp32 through the paged model
              (SIMT kernel) against their dense forward at rel 1e-4; the
              engine phase's 8 requests (32 new tokens) on each facade and on
              the bf16 model with TTFT/TPOT, tokens/s, ``memory_footprint()``
              against the bytes the shapes give, allocated memory and the
              logits' cosine and top-1 agreement with the bf16 model's; one
              profiled decode call on the bf16 model, wint8 and a8w8 (the
              dequant, the GEMMs, attention, the idle share); greedy HTTP
              streams over the a8w8 engine equal to ``generate``; every paged
              launch on the Hopper route; the wint8 facade's
              ``QuantizedModel.generate`` on 2 greedy prompts against its
              engine's streams (a divergence only within twice the bf16
              distance);
14. generate -- ``generate`` (the dense forward over a static KV cache,
              attention on the dispatcher's XLA-path counterpart: no kernel)
              on the same bf16 model: the engine phase's 8 prompts
              left-padded into one [8, 2048] batch, 64 new tokens, each row
              against the engine's greedy stream (a divergence only within
              twice the bf16 distance from fp32 at that position; the bf16
              gate's verdict printed) and a second run bit for bit, with prefill ms,
              TPOT p50/p99, tokens/s, host syncs a token, peak memory and the
              cache's bytes; seeded sampling (temperature 0.9, top-k 50,
              top-p 0.9) twice equal, top-k 1 equal to greedy but at a tie of
              the largest bf16 logit, the threefry
              bits equal on the card and the CPU; beam (4) and group beam
              (4 in 2 groups, diversity 1.0) on 2 prompts of 512 tokens,
              twice equal, each score against a teacher-forced re-score of
              its sequence;

Training, ``run_pretrain`` at Qwen2-1.5B width and depth:

15. flash_kernel -- the flash-attention forward, dq and dk/dv kernels against
              their plain versions, elementwise, at the training path's shape
              (q [2, 4096, 12, 128] bf16 over k/v [2, 4096, 2, 128], causal),
              in fp32, with segments and a window, and at T = 4095; bf16 takes
              all three through the Hopper tensor-core kernels
              (``flash_attention_sm90.cu``), fp32 through the SIMT kernels
              (``flash_attention.cu``), and each case checks its route; the
              bf16 dq gives bitwise equal results over two launches; times
              against the bound, the plain versions and
              ``scaled_dot_product_attention``;
16. train_grad -- Qwen2-1.5B widths, 2 layers: the loss and every gradient
              leaf through the kernels against the attention through the
              plain versions, in fp32 (the SIMT kernels) and at bf16 compute
              (the Hopper kernels), with the bf16-vs-fp32 control;
17. train  -- ``paddlenlp_tpu_torch.llm.run_pretrain.main`` on the repo's
              Qwen2 recipe (``llm/config/qwen2/pretrain_argument.json``) cut
              to one card and 4 steps (each cut printed under ``reduced``),
              Qwen2-1.5B at full width and depth with random weights and a
              Markov-chain corpus from ``--seed``, with the metrics exporter
              on an ephemeral port and a ``profiler_options`` window over
              steps 3-4; per-step loss, grad norm, time, tokens/s, MFU and
              peak memory; the forward, dq and dk/dv launches all on the
              Hopper route; ``/metrics`` after the last step (4 steps, the
              tokens, ``train_mfu`` within 10% of the phase's MFU of that
              step, the steady MFU beside it); the
              window's Chrome trace holds the three Hopper flash kernels; the
              saved checkpoint loads back bit for bit;
18. train_profile -- ``torch.profiler`` over one more training step;
19. train_resume -- the recipe's checkpointing (``save_steps`` cut to 2,
              ``save_total_limit`` 2) through ``run_pretrain.main`` at
              Qwen2-1.5B widths and 12 layers (``RESUME_LAYERS``: the run keeps
              its disk writes under 45 GiB): a straight run
              saves committed checkpoint-2 and -4 (each validated with its
              hashes; save, hash and step times); a second run resumes
              checkpoint-2 into a fresh directory from other weights and saves
              checkpoint-4 asynchronously: steps 3-4 and the final fp32
              parameters equal the straight run's bit for bit, the two
              checkpoint-4s' model and optimizer files hash alike; load
              GB/s, the loop's stall against the writer thread's time;
20. train_recompute -- one optimizer step (2 micro-batches of 2 x 4096) under
              each of the 8 recompute granularities at full depth: wall s,
              peak memory and flash launches each; the losses equal;
21. fused_ce -- ``fused_linear_cross_entropy`` against ``causal_lm_loss`` on
              full logits at the step's head (hidden [2, 4096, 1536] bf16,
              the tied 1536 x 151936 head): the loss and both gradients
              within the bf16 gate, the peak memory of each;
22. kernels -- every kernel with its launches on the serving runs (the two
              engine runs, the serve, router, spec, host_tier, lora and wquant
              phases;
              the kv_quant phase for the quantized entry) and the training runs
              (train, train_resume, train_recompute, and the spec phase's draft
              forwards), each on its own route, and its check.

The last three lines are the ``nvidia-smi`` name/power line, the kernels JSON
object (nine rows: the paged kernel, the flash forward, dq and dk/dv, each on
the Hopper and on the SIMT route, and the paged kernel's Hopper route over a
quantized pool) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
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
    # the speculative verify: 8 rows of K + 1 = 5 tokens (the last accepted
    # one and 4 drafts) at the spec phase's contexts (prompts of 512-960
    # tokens, ~32 tokens into their 64 new ones)
    "verify": (5, [543, 607, 671, 735, 799, 863, 927, 991], [5] * 8),
}
# (batch, query dtype, pool) of every case the kernel phase checks: bf16
# queries, the main path's, take the Hopper kernel (over an int8 or fp8 pool
# its quantized entry), fp32 queries the SIMT kernel
CASES = [("ragged", "bfloat16", "bf16"), ("ragged", "bfloat16", "int8"), ("ragged", "bfloat16", "fp8"),
         ("ragged", "float32", "fp32"), ("ragged", "float32", "int8"), ("prefill", "bfloat16", "bf16"),
         ("prefill", "bfloat16", "int8"), ("decode", "bfloat16", "bf16"), ("decode", "bfloat16", "int8"),
         ("decode", "bfloat16", "fp8"), ("verify", "bfloat16", "bf16")]


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
        route = pa.kernel_route(args["q"].dtype, args["pool_k"].dtype)
        before = (pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT)
        out = pa.ragged_paged_attention(**args)
        moved = tuple(n - b for n, b in zip((pa.LAUNCHES, pa.LAUNCHES_SM90, pa.LAUNCHES_SM90_QUANT), before))
        again = pa.ragged_paged_attention(**args)
        ref = pa.ragged_paged_attention_ref(**args)
        torch.cuda.synchronize()
        name = f"{batch} q {q_dtype} pool {kv}"
        want = (1, int(route != "simt"), int(route == "sm90_quant"))
        check(moved == want, f"kernel {name}: launches, Hopper, quantized Hopper moved by {moved}, "
                             f"want {want} on the {route} route")
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


def phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, seed, chunk, streams=None):
    """``streams``, when given, receives each prompt's output ids."""
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
    if streams is not None:
        streams.update({r.req_id: list(r.output_ids) for r in done})  # req i serves prompt i
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


def phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed, quant=None):
    """Where one steady-state decode call goes (8 requests, ``decode_steps``
    sub-steps): ``torch.profiler`` over the engine step after admission,
    device time by kernel and the device's idle share of the step; over a
    bf16 pool, or an int8 / fp8 one (``quant``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts, _ = traffic(np, model.config.vocab_size, seed)
    eng = InferenceEngine(model, **SERVE_ENGINE, kv_cache_quant=quant)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=1 + 2 * eng.decode_steps))
    eng.step()  # admission: prefill + the first decode call
    torch.cuda.synchronize()
    # the profiled call's attention launches read, per layer and sub-step,
    # every live row's KV blocks up to its current position once (K and V:
    # H values a position and kv head, and a quantized pool's fp32 scale)
    cfg, bs = model.config, 16
    fed = [r.total_len - 1 for r in eng.slots if r is not None]
    per_pos = 2 * (cfg.head_dim * eng.pool.kv.element_size() + (4 if quant else 0))
    kv_bytes = [sum(((p + s) // bs + 1) * bs for p in fed) * cfg.num_key_value_heads * per_pos
                for s in range(eng.decode_steps)]
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    route = pa.LAUNCHES_SM90_QUANT if quant else pa.LAUNCHES_SM90
    check(route == pa.LAUNCHES > 0 and (quant or pa.LAUNCHES_SM90_QUANT == 0),
          f"profile: {route} of {pa.LAUNCHES} launches on the Hopper route ({quant or 'bf16'} pool)")
    # kernels and copies only: host ops and annotation ranges carry the
    # device time of the kernels they launched as well
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    # both routes' kernels, and the Hopper route's merge of kv partitions
    attn = [e for e in events if "paged_attention" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3
    attn_launches = sum(e.count for e in attn if "merge" not in e.key)
    res = dict(phase="profile", step="decode call, 8 rows x %d sub-steps" % eng.decode_steps, kv_cache_quant=quant,
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
def paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, dtype, n_decode, feed=None, quant=None,
                 kernel=True, lora=None, adapter=0):
    """Prefill ``prompt`` then ``n_decode`` decode steps through the paged
    forward, over a fresh pool (int8 / fp8 with ``quant``), on the kernel path
    or, with ``kernel=False``, on the plain gather path, feeding the greedy
    token (or ``feed[i]`` when given), with the LoRA delta of pool slot
    ``adapter`` of the device adapter pool ``lora`` when given; returns
    (logits [1 + n_decode, V] fp32, fed token ids)."""
    from paddlenlp_tpu_torch.experimental.inference_model import gather_lora

    bs = 16
    n_blocks = (len(prompt) + n_decode) // bs + 2
    infer = PagedInferenceModel(model, block_size=bs, num_blocks=n_blocks + 1, max_blocks_per_seq=n_blocks,
                                dtype=dtype)
    check(infer.use_paged_kernel, "logits: the paged model on CUDA must run the kernel path")
    infer.use_paged_kernel = kernel  # the plain path only where the caller asks for it
    pool = init_paged_pool(model.config, n_blocks + 1, bs, dtype=dtype, quant=quant, device=DEVICE)
    tables = torch.arange(1, n_blocks + 1, dtype=torch.int32, device=DEVICE)[None]
    S = n_blocks * bs
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    T = len(prompt)
    ids = torch.tensor([prompt], dtype=torch.int32, device=DEVICE)
    rows_lora = gather_lora(lora, i32([adapter]))
    rows = [infer._forward(pool, ids, tables, torch.arange(T, device=DEVICE)[None],
                           torch.arange(S, device=DEVICE)[None] < T, i32([0]), i32([T - 1]),
                           q_lens=i32([T]), lora_rows=rows_lora).float()]
    fed = list(prompt)
    for step in range(n_decode):
        pos = T + step
        tok = int(rows[-1].argmax(dim=-1)) if feed is None else feed[pos]
        fed.append(tok)
        rows.append(infer._forward(pool, i32([[tok]]), tables, i32([[pos]]),
                                   torch.arange(S, device=DEVICE)[None] <= pos, i32([pos]), i32([0]),
                                   lora_rows=rows_lora).float())
    del pool
    return torch.cat(rows, dim=0), fed


def single_token_logits(torch, model, PagedInferenceModel, init_paged_pool, tokens, dtype):
    """Each of ``tokens`` as a sequence of its own, all prefilled by one paged
    forward ([B, 1], a block each, on the kernel path): logits [B, V] fp32.
    A query over a single key gets that key's value exactly on every route
    (the kernel's online softmax: p = exp(0) = 1, l = 1; the dense softmax:
    1 and 0s), so the attention adds no summation-order difference."""
    bs, B = 16, len(tokens)
    infer = PagedInferenceModel(model, block_size=bs, num_blocks=B + 1, max_blocks_per_seq=1, dtype=dtype)
    check(infer.use_paged_kernel, "logits: the paged model on CUDA must run the kernel path")
    pool = init_paged_pool(model.config, B + 1, bs, dtype=dtype, device=DEVICE)
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=DEVICE)
    out = infer._forward(pool, torch.tensor(tokens, dtype=torch.int32, device=DEVICE)[:, None],
                         torch.arange(1, B + 1, dtype=torch.int32, device=DEVICE)[:, None], zeros,
                         (torch.arange(bs, device=DEVICE) < 1)[None].expand(B, bs), zeros[:, 0], zeros[:, 0],
                         q_lens=torch.ones(B, dtype=torch.int32, device=DEVICE)).float()
    del pool
    return out


def paged_layer_errors(torch, modeling, model, PagedInferenceModel, init_paged_pool, prompt):
    """Each paged layer (kernel path, fp32) fed the dense forward's input to
    that layer over ``prompt``: per layer, the largest |paged - dense| of its
    output over the dense output's largest magnitude, and the number of
    positions whose row differs by more than ``LOGITS_REL_TOL`` of that. The
    dense inputs are read by recording ``modeling.rms_norm``'s (two a layer,
    then the final norm)."""
    T, bs = len(prompt), 16
    nb = -(-T // bs)
    seen, norm = [], modeling.rms_norm
    modeling.rms_norm = lambda h, scale, eps: (seen.append(h), norm(h, scale, eps))[1]
    try:
        model(torch.tensor([prompt], device=DEVICE), dtype=torch.float32)
    finally:
        modeling.rms_norm = norm
    hs = seen[0::2]
    infer = PagedInferenceModel(model, block_size=bs, num_blocks=nb + 1, max_blocks_per_seq=nb, dtype=torch.float32)
    pool = init_paged_pool(model.config, nb + 1, bs, dtype=torch.float32, device=DEVICE)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device=DEVICE)[None]
    pos, mask = torch.arange(T, device=DEVICE)[None], torch.arange(nb * bs, device=DEVICE)[None] < T
    err, over = [], []
    with torch.no_grad():
        for i in range(len(hs) - 1):
            diff = (infer._layer(hs[i], i, pool, tables, pos, mask, i32([0]), i32([T])) - hs[i + 1]).abs()[0]
            big = hs[i + 1].abs().max()
            err.append((diff.max() / big).item())
            over.append(int((diff.max(dim=-1).values > LOGITS_REL_TOL * big).sum()))
    del pool, hs, seen
    return dict(positions=T, rel_err=err, positions_over_tol=over)


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


# ----------------------------------------------------------------------------- serve
def http_call(port, method, path, payload=None, timeout=600):
    """One HTTP exchange with the server: (status, body bytes)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if payload is None else json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_json(port, method, path, payload=None, timeout=600):
    status, body = http_call(port, method, path, payload, timeout)
    return status, json.loads(body)


def http_stream(port, path, payload, on_token=None, timeout=600):
    """SSE request; returns (token ids, finish reason, final usage, arrival
    time of each token, ``time.time()``, the clock the engine stamps).
    ``on_token(completion id)`` runs after the first token arrived."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(dict(payload, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        check(resp.status == 200, f"serve: stream answered {resp.status}")
        toks, times, finish, usage = [], [], None, None
        for line in resp:
            line = line.strip()
            if line == b"data: [DONE]":
                return toks, finish, usage, times
            if not line.startswith(b"data: "):
                continue
            chunk = json.loads(line[6:])
            choice = chunk["choices"][0]
            tok = choice.get("token", choice.get("delta", {}).get("token"))
            if tok is not None:
                toks.append(tok)
                times.append(time.time())
                if on_token is not None:
                    on_token(chunk["id"])
                    on_token = None
            if choice.get("finish_reason") is not None:
                finish, usage = choice["finish_reason"], chunk.get("usage")
        raise AssertionError("serve: stream closed without [DONE]")
    finally:
        conn.close()


def phase_serve(torch, np, model, pa, InferenceEngine, SamplingParams, serving, seed):
    """``ServingServer`` over ``InferenceEngine`` at Qwen2-7B on 127.0.0.1:
    (a) parity of greedy streams with ``InferenceEngine.generate``; (b) the
    engine phase's 8-request mix from 8 client threads at once (4 SSE), a
    two-turn chat and an abort mid-stream, timed on the client and in the
    engine; (c) the scrapes; (d) two in-process weight swaps and a refused
    one; (e) every paged launch on the Hopper route."""
    from paddlenlp_tpu_torch.observability.span_catalog import SPAN_CATALOG
    from paddlenlp_tpu_torch.serving.engine_loop import CANARY_PROMPT_IDS, canary_digest

    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    vocab = model.config.vocab_size
    eng = InferenceEngine(model, max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256)
    check(eng.infer.use_paged_kernel, "serve: the engine on CUDA must run the kernel path")
    greedy = [i for i in range(len(prompts)) if i not in sampled][1:3]
    torch.cuda.synchronize()
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    # references on the main thread, before the loop starts: each prompt
    # alone on a cleared prefix cache, the launches the server will make
    want = {}
    for i in greedy:
        eng.clear_prefix_cache()
        want[i] = eng.generate([prompts[i]], SamplingParams(max_new_tokens=64))[0]
    eng.clear_prefix_cache()
    digest_v1 = canary_digest(eng.generate([list(CANARY_PROMPT_IDS)])[0])
    eng.clear_prefix_cache()

    server = serving.ServingServer(eng, registry=serving.MetricsRegistry(),
                                   scheduler_config=serving.SchedulerConfig(max_inflight=32, default_timeout_s=600))
    port = server.start_in_thread()
    res = dict(phase="serve", config="Qwen/Qwen2-7B", server="paddlenlp_tpu_torch.serving.ServingServer",
               engine=dict(max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256))
    try:
        # (a) parity: non-streaming then SSE, each alone on a cleared cache
        # (the loop is idle between requests, so clearing from here is safe)
        parity = {}
        for i in greedy:
            server.loop.engine.clear_prefix_cache()
            status, body = http_json(port, "POST", "/v1/completions", {"prompt": prompts[i].tolist(), "max_tokens": 64})
            check(status == 200, f"serve: parity request answered {status}")
            server.loop.engine.clear_prefix_cache()
            toks, finish, _, _ = http_stream(port, "/v1/completions", {"prompt": prompts[i].tolist(), "max_tokens": 64})
            parity[i] = body["choices"][0]["token_ids"] == want[i] and toks == want[i]
        res["parity"] = dict(prompts=[len(prompts[i]) for i in greedy], equal=parity)
        check(all(parity.values()), f"serve: HTTP greedy streams differ from InferenceEngine.generate: {parity}")

        # (b) load: the engine phase's mix from 8 client threads at once
        def body_of(i):
            b = {"prompt": prompts[i].tolist(), "max_tokens": 64}
            if i in sampled:
                b.update(do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
            return b

        results = [None] * len(prompts)

        def client(i):
            t0 = time.time()
            if i % 2:
                toks, finish, _, times = http_stream(port, "/v1/completions", body_of(i))
                results[i] = dict(sse=True, tokens=toks, finish=finish, t0=t0, times=times, end=time.time())
            else:
                status, body = http_json(port, "POST", "/v1/completions", body_of(i))
                check(status == 200, f"serve: request {i} answered {status}")
                results[i] = dict(sse=False, tokens=body["choices"][0]["token_ids"],
                                  finish=body["choices"][0]["finish_reason"], t0=t0, end=time.time())

        # when the scheduler admitted each request (prompt lengths are
        # unique): splits the client's wait into HTTP, the loop's command
        # queue and the engine
        admitted_t = {}
        real_submit = server.scheduler.submit

        def timed_submit(ids, *args, **kwargs):
            admitted_t[len(ids)] = time.time()
            return real_submit(ids, *args, **kwargs)

        server.scheduler.submit = timed_submit

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        load_wall = time.perf_counter() - t_load
        server.scheduler.submit = real_submit
        check(all(not t.is_alive() for t in threads) and all(results), "serve: a client never finished")
        for i, r in enumerate(results):
            check(r["finish"] in ("length", "stop"), f"serve: request {i} ended {r['finish']}")
            check(r["finish"] == "stop" or len(r["tokens"]) == 64, f"serve: request {i} short")
            check(all(0 <= t < vocab for t in r["tokens"]), f"serve: request {i} emitted out-of-vocab ids")
        recent = {r["prompt_len"]: r for r in http_json(port, "GET", "/debug/requests")[1]["recent"]}
        engine_side = [recent[len(p)] for p in prompts]
        sse = [r for r in results if r["sse"]]
        c_ttft = [(r["times"][0] - r["t0"]) * 1e3 for r in sse]
        c_tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3 for r in sse if len(r["times"]) > 1]
        e_ttft = [e["ttft_s"] * 1e3 for e in engine_side]
        e_tpot = [e["decode_time_s"] / (e["output_tokens"] - 1) * 1e3 for e in engine_side]
        e_ttft_sse = [e_ttft[i] for i, r in enumerate(results) if r["sse"]]
        # the client's time to first token, split: HTTP request to the
        # scheduler's admission, admission to the engine's arrival stamp (the
        # loop's command queue: a step in flight), the engine's TTFT, and
        # the token's way back to an SSE client
        http_in = [(admitted_t[len(p)] - r["t0"]) * 1e3 for p, r in zip(prompts, results)]
        loop_queue = [(e["arrival_t"] - admitted_t[len(p)]) * 1e3 for p, e in zip(prompts, engine_side)]
        delivery = [(r["times"][0] - e["arrival_t"] - e["ttft_s"]) * 1e3
                    for r, e in zip(results, engine_side) if r["sse"]]
        n_out = sum(len(r["tokens"]) for r in results)
        res["load"] = dict(
            requests=len(results), sse=len(sse), output_tokens=n_out, wall_s=load_wall,
            tokens_per_s=n_out / load_wall,
            client_ttft_ms_p50=pct(c_ttft, 0.5), client_ttft_ms_p99=pct(c_ttft, 0.99),
            client_tpot_ms_p50=pct(c_tpot, 0.5), client_tpot_ms_p99=pct(c_tpot, 0.99),
            client_e2e_ms_p50=pct([(r["end"] - r["t0"]) * 1e3 for r in results], 0.5),
            engine_e2e_ms_p50=pct([(e["finish_t"] - e["arrival_t"]) * 1e3 for e in engine_side], 0.5),
            engine_ttft_ms_p50=pct(e_ttft, 0.5), engine_ttft_ms_p99=pct(e_ttft, 0.99),
            engine_tpot_ms_p50=pct(e_tpot, 0.5), engine_tpot_ms_p99=pct(e_tpot, 0.99),
            sse_ttft_gap_ms=[c - e for c, e in zip(c_ttft, e_ttft_sse)],
            ttft_split_ms_p50=dict(http_to_scheduler=pct(http_in, 0.5), loop_command_queue=pct(loop_queue, 0.5),
                                   engine_ttft=pct(e_ttft, 0.5), sse_delivery=pct(delivery, 0.5)),
            ttft_split_ms_max=dict(http_to_scheduler=max(http_in), loop_command_queue=max(loop_queue),
                                   sse_delivery=max(delivery)),
            engine_queue_ms=[(e["queue_wait_s"] or 0.0) * 1e3 for e in engine_side])

        # a two-turn chat: turn 2's prompt starts with turn 1's prompt and reply
        rng = np.random.default_rng(seed + 2)
        user1 = rng.integers(8, vocab, 300).tolist()
        status, chat1 = http_json(port, "POST", "/v1/chat/completions",
                                  {"messages": [{"role": "user", "content": user1}], "max_tokens": 32})
        check(status == 200 and chat1["choices"][0]["finish_reason"] == "length", f"serve: chat turn 1 {status}")
        reply = chat1["choices"][0]["message"]["token_ids"]
        turn2 = [{"role": "user", "content": user1}, {"role": "assistant", "content": reply},
                 {"role": "user", "content": rng.integers(8, vocab, 40).tolist()}]
        toks2, finish2, usage2, _ = http_stream(port, "/v1/chat/completions", {"messages": turn2, "max_tokens": 32})
        turn1_len = chat1["usage"]["prompt_tokens"] + chat1["usage"]["completion_tokens"]
        check(finish2 == "length" and len(toks2) == 32, f"serve: chat turn 2 ended {finish2}")
        # every full block of turn 1's prompt and reply (all but the reply's
        # last token, which was sampled and never fed) is cached
        res["chat"] = dict(turn1_tokens=turn1_len, turn2_prompt=usage2["prompt_tokens"],
                           turn2_cached=usage2["cached_tokens"])
        check(usage2["cached_tokens"] == (turn1_len - 1) // 16 * 16,
              f"serve: chat turn 2 cached {usage2['cached_tokens']} of turn 1's {turn1_len} tokens")

        # an abort mid-stream: its blocks must come back
        cancelled = {}
        toks_a, finish_a, _, _ = http_stream(
            port, "/v1/completions", {"prompt": prompts[1].tolist(), "max_tokens": 64},
            on_token=lambda cid: cancelled.update(http_json(port, "POST", "/v1/abort", {"id": cid})[1]))
        check(cancelled.get("cancelled") is True and finish_a == "abort", f"serve: abort {cancelled} {finish_a}")
        deadline = time.time() + 60
        while server.loop.pending_count() and time.time() < deadline:
            time.sleep(0.01)
        mgr = server.loop.engine.mgr
        res["abort"] = dict(tokens_before_abort=len(toks_a), tables_left=len(mgr.tables),
                            free_blocks=mgr.num_free, total_blocks=mgr.total_usable_blocks)
        check(not mgr.tables and mgr.num_free == mgr.total_usable_blocks, f"serve: blocks leaked: {res['abort']}")

        # (c) scrapes
        metrics = http_call(port, "GET", "/metrics")[1].decode()

        def counter(name):
            return sum(float(line.rsplit(" ", 1)[1]) for line in metrics.splitlines()
                       if line.startswith(name + "{") or line.startswith(name + " "))

        n_requests = 2 * len(greedy) + len(results) + 2 + 1
        received = 2 * sum(len(want[i]) for i in greedy) + n_out + len(reply) + len(toks2) + len(toks_a)
        res["scrapes"] = dict(requests_total=counter("paddlenlp_serving_requests_total"), requests_sent=n_requests,
                              tokens_total=counter("paddlenlp_serving_tokens_generated_total"),
                              tokens_received=received)
        check(res["scrapes"]["requests_total"] == n_requests and res["scrapes"]["tokens_total"] == received,
              f"serve: /metrics counters disagree with the clients: {res['scrapes']}")
        status, health = http_json(port, "GET", "/health")
        check(status == 200 and health["status"] == "ok", f"serve: /health answered {status}")
        eff = http_json(port, "GET", "/debug/efficiency")[1]["ledger"]
        tot = eff["totals"]
        conserved = tot["fed"] == tot["useful"] + tot["padding"] + tot["spec_rejected"] + tot["rework"] \
            and sum(eff["rework_by"].values()) == tot["rework"] and sum(eff["padding_by"].values()) == tot["padding"]
        check(conserved, f"serve: /debug/efficiency conservation broken: {eff}")
        trace = json.loads(http_call(port, "GET", "/debug/trace")[1])
        span_names = {e["name"] for e in trace["traceEvents"] if e.get("ph") in ("X", "i")}
        check(span_names and span_names <= set(SPAN_CATALOG),
              f"serve: spans outside the catalog: {sorted(span_names - set(SPAN_CATALOG))}")
        # a 1 s device profile taken from an HTTP thread while two requests run
        prof_out = {}

        def profile():
            prof_out["status"], prof_out["body"] = http_call(port, "POST", "/debug/profile?seconds=1")

        prof_thread = threading.Thread(target=profile)
        busy = [threading.Thread(target=http_json, args=(port, "POST", "/v1/completions",
                                                         {"prompt": prompts[j].tolist(), "max_tokens": 64}))
                for j in (3, 5)]
        for t in busy:
            t.start()
        time.sleep(0.3)
        prof_thread.start()
        for t in busy + [prof_thread]:
            t.join(timeout=600)
        check(prof_out.get("status") == 200, f"serve: /debug/profile answered {prof_out}")
        prof_path = json.loads(prof_out["body"])["path"]
        with open(f"{prof_path}/trace.json") as f:
            prof_events = json.load(f)["traceEvents"]
        paged = [e for e in prof_events if e.get("cat") == "kernel" and "paged_attention" in e.get("name", "")]
        res["scrapes"].update(health=health["status"], conservation=conserved, ledger=tot,
                              trace_spans=sorted(span_names), profile_events=len(prof_events),
                              profile_paged_kernels=len(paged),
                              profile_engine_steps=sum(1 for e in prof_events if e.get("name") == "engine_step"))
        check(paged, "serve: the /debug/profile trace holds no paged-attention kernel")

        # (d) in-process weight swaps: a tree that shares every tensor but a
        # final norm scaled per channel (0.5 to 1.5), then the original back
        params = model.params
        scale = params["model"]["norm"]["scale"]
        ramp = torch.linspace(0.5, 1.5, scale.numel(), device=scale.device, dtype=scale.dtype)
        swapped = dict(params, model=dict(params["model"], norm={"scale": scale * ramp}))
        r2 = server.loop.request_weight_swap(swapped, "v2", canary_prompt_ids=CANARY_PROMPT_IDS, timeout_s=600)
        r1 = server.loop.request_weight_swap(params, "v1", canary_prompt_ids=CANARY_PROMPT_IDS, timeout_s=600)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_uncommitted_") as bad_dir:
            status, refused = http_json(port, "POST", "/admin/weights", {"ckpt_dir": bad_dir})
        res["swap"] = dict(v1_digest=digest_v1, v2=dict(ok=r2["ok"], digest=r2["canary_digest"], wall_s=r2["wall_s"]),
                           back_to_v1=dict(ok=r1["ok"], digest=r1["canary_digest"], wall_s=r1["wall_s"]),
                           uncommitted_status=status, uncommitted_error=refused["error"]["type"],
                           weights_version=server.loop.weights_version)
        check(r2["ok"] and r2["canary_digest"] != digest_v1, f"serve: the v2 swap {r2}")
        check(r1["ok"] and r1["canary_digest"] == digest_v1, f"serve: swapping v1 back {r1} vs {digest_v1}")
        check(status == 409 and model.params is params and server.loop.weights_version == "v1",
              f"serve: an uncommitted checkpoint answered {status}")
    finally:
        server.shutdown(drain_timeout_s=120)
    check(not server.loop.running, "serve: the loop did not stop")
    torch.cuda.synchronize()
    # (e) every paged launch of the phase on the Hopper route
    res.update(kernel_launches=pa.LAUNCHES, sm90_launches=pa.LAUNCHES_SM90,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit(res)
    check(pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
          f"serve: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} launches on the Hopper route")
    del server, eng
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- router
ROUTER_PARITY_NEW = 32  # new tokens of a parity request
ROUTER_SUPERVISOR = dict(max_retries=0, backoff_base_s=2.0, backoff_max_s=4.0)


def fleet_stream(port, payload, on_token=None, timeout=600):
    """An SSE completion through a router or a replica: a dict of the
    status, the completion id, the token ids, the finish reason, the replica
    the terminal chunk names, the client's send time and each token's
    arrival time. ``on_token(n)`` runs after the n-th token."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        out = dict(status=None, id=None, tokens=[], finish=None, replica=None, t0=time.time(), times=[])
        conn.request("POST", "/v1/completions", body=json.dumps(dict(payload, stream=True)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["status"] = resp.status
        if resp.status != 200:
            return out
        for line in resp:
            line = line.strip()
            if line == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            chunk = json.loads(line[6:])
            out["id"] = chunk.get("id", out["id"])
            choice = chunk["choices"][0]
            if choice.get("finish_reason") is not None:
                out["finish"], out["replica"] = choice["finish_reason"], chunk.get("replica")
            elif choice.get("token") is not None:
                out["tokens"].append(choice["token"])
                out["times"].append(time.time())
                if on_token is not None:
                    on_token(len(out["tokens"]))
        return out
    finally:
        conn.close()


def phase_router(torch, np, model, pa, InferenceEngine, SamplingParams, serving, seed, serve_res):
    """Two Qwen2-7B replicas (``ServingServer`` each, one engine each over the
    phase's one model) behind the port's ``RouterServer`` on 127.0.0.1, with
    prefix affinity: (a) greedy parity through the router against the named
    replica alone; (b) the engine phase's 8 requests from 8 clients at once
    against their solo runs, client TTFT/TPOT, the split across replicas, the
    router's share of TTFT and aggregate tokens/s, then the same burst with
    one replica drained and with the interpreter's switch interval at 1 ms;
    (c) an injected ``engine.step`` fault on the replica a shared prefix
    pins; (d) a drain with streams in flight, then one autoscaler tick that
    provisions a third replica; (e) the fleet planes; (f) every paged launch
    on the Hopper route."""
    from paddlenlp_tpu_torch.experimental.inference_model import _gumbel_rows
    from paddlenlp_tpu_torch.serving import router as rt
    from paddlenlp_tpu_torch.utils.faults import FAULTS

    t_phase = time.perf_counter()
    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    vocab = model.config.vocab_size
    engines = []

    def factory():
        eng = InferenceEngine(model, **SERVE_ENGINE)
        check(eng.backend.device.type == DEVICE and eng.infer.use_paged_kernel,
              f"router: a replica's engine is on {eng.backend.device}, kernel path {eng.infer.use_paged_kernel}")
        engines.append(eng.backend.device.type)
        return eng

    def body_of(i, new=64):
        b = {"prompt": prompts[i].tolist(), "max_tokens": new}
        if i in sampled:
            b.update(do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
        return b

    replica_kw = dict(scheduler_config=serving.SchedulerConfig(max_inflight=32, default_timeout_s=600),
                      supervisor_policy=serving.SupervisorPolicy(**ROUTER_SUPERVISOR))
    FAULTS.reset()
    torch.cuda.synchronize()
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    fleet = rt.launch_fleet(2, factory, policy=rt.PrefixAffinityPolicy(), poll_interval_s=0.05, **replica_kw)
    router, rport = fleet.router, fleet.router_port
    ids = [fleet.replica_id(i) for i in range(2)]
    port_of = dict(zip(ids, fleet.ports))
    res = dict(phase="router", config="Qwen/Qwen2-7B", replicas=2, policy="prefix_affinity",
               router="paddlenlp_tpu_torch.serving.router.RouterServer", engine=SERVE_ENGINE,
               supervisor=ROUTER_SUPERVISOR)
    prov = None

    def clear_caches():
        for s in fleet.servers:
            s.loop.run_on_loop(s.loop.engine.clear_prefix_cache)

    def state_of(rid):
        return {s.id: s.state for s in router.pool.snapshots()}.get(rid)

    def wait(cond, what, timeout=120):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if cond():
                return
            time.sleep(0.01)
        check(False, f"router: timed out waiting for {what}")

    def burst(what="burst"):
        """The engine phase's 8 requests from 8 clients at once through the
        router (odd ones SSE) on cleared caches: (results, wall s)."""
        clear_caches()
        results = [None] * len(prompts)

        def client(i):
            if i % 2:
                results[i] = dict(fleet_stream(rport, body_of(i)), sse=True, end=time.time())
            else:
                t0 = time.time()
                status, body = http_json(rport, "POST", "/v1/completions", body_of(i))
                results[i] = dict(sse=False, status=status, tokens=body["choices"][0]["token_ids"],
                                  finish=body["choices"][0]["finish_reason"], replica=body["replica"],
                                  id=body["id"], t0=t0, end=time.time())

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_load
        check(all(not t.is_alive() for t in threads) and all(results), f"router: a {what} client never finished")
        for i, r in enumerate(results):
            check(r["status"] == 200 and r["finish"] in ("length", "stop"),
                  f"router: {what} request {i} {r['status']} ended {r['finish']}")
            check(all(0 <= t < vocab for t in r["tokens"]), f"router: {what} request {i} emitted out-of-vocab ids")
        return results, wall

    def burst_summary(results, wall):
        sse = [r for r in results if r["sse"]]
        n = sum(len(r["tokens"]) for r in results)
        return dict(tokens_per_s=n / wall, wall_s=wall,
                    client_ttft_ms_p50=pct([(r["times"][0] - r["t0"]) * 1e3 for r in sse], 0.5),
                    client_tpot_ms_p50=pct([(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3
                                            for r in sse if len(r["times"]) > 1], 0.5),
                    split_across_replicas={str(ids.index(rid)): sum(r["replica"] == rid for r in results)
                                           for rid in ids})

    try:
        # (a) parity: greedy prompts one at a time through the router, each
        # against the same prompt sent alone to the replica the response names
        greedy = [i for i in range(len(prompts)) if i not in sampled][:4]
        parity, solo = {}, {}
        for i in greedy:
            clear_caches()
            status, body = http_json(rport, "POST", "/v1/completions", body_of(i, ROUTER_PARITY_NEW))
            check(status == 200, f"router: parity request {i} answered {status}")
            rid = body["replica"]
            clear_caches()
            _, direct = http_json(port_of[rid], "POST", "/v1/completions", body_of(i, ROUTER_PARITY_NEW))
            clear_caches()
            s = fleet_stream(rport, body_of(i, ROUTER_PARITY_NEW))
            if s["replica"] == rid:
                s_direct = direct["choices"][0]["token_ids"]
            else:
                clear_caches()
                s_direct = fleet_stream(port_of[s["replica"]], body_of(i, ROUTER_PARITY_NEW))["tokens"]
            parity[i] = dict(replica=ids.index(rid), sse_replica=ids.index(s["replica"]),
                             batch_equal=body["choices"][0]["token_ids"] == direct["choices"][0]["token_ids"],
                             sse_equal=s["status"] == 200 and s["tokens"] == s_direct)
        res["parity"] = dict(new_tokens=ROUTER_PARITY_NEW, prompts=[len(prompts[i]) for i in greedy], by_prompt=parity)
        check(all(p["batch_equal"] and p["sse_equal"] for p in parity.values()),
              f"router: streams through the router differ from the replica alone: {parity}")

        # (b) burst: the engine phase's 8 requests from 8 clients at once (4
        # SSE), each against the same request alone and directly on a replica
        for i in range(len(prompts)):
            clear_caches()
            _, body = http_json(fleet.ports[i % 2], "POST", "/v1/completions", body_of(i))
            solo[i] = body["choices"][0]["token_ids"]
        span_mark = router.tracer.now()
        results, load_wall = burst()

        def gumbel(i):
            return lambda pos: 0.8 * _gumbel_rows(torch.tensor([10 + i], device=DEVICE),
                                                  torch.tensor([pos], device=DEVICE), vocab)[0]

        diverged = {}
        for i, r in enumerate(results):
            d = depth_divergence(torch, model, prompts[i], r["tokens"], solo[i],
                                 noise=gumbel(i) if i in sampled else None)
            if d is not None:
                diverged[i] = d
        # the router's spans of the burst and each replica's own record of it
        spans = [s for s in router.tracer.snapshot(since_ts=span_mark) if s.dur is not None]
        route_ms = {}
        arrival = {}
        for s in spans:
            if s.name == "route":
                route_ms[s.trace] = route_ms.get(s.trace, 0.0) + s.dur * 1e3
            elif s.name == "router_request":
                arrival[s.trace] = s.ts
        recent = {}
        for rid in ids:
            for rec in http_json(port_of[rid], "GET", "/debug/requests")[1]["recent"]:
                recent[rec["trace"]] = rec
        sse = [r for r in results if r["sse"]]  # the router's id of a request is its trace on both tiers
        c_ttft = [(r["times"][0] - r["t0"]) * 1e3 for r in sse]
        c_tpot = [(r["times"][-1] - r["times"][0]) / (len(r["times"]) - 1) * 1e3 for r in sse if len(r["times"]) > 1]
        split = dict(client_to_router=[], router_to_engine=[], route_decision=[], engine_ttft=[], delivery=[])
        for r in sse:
            rec = recent[r["id"]]
            split["client_to_router"].append((arrival[r["id"]] - r["t0"]) * 1e3)
            split["router_to_engine"].append((rec["arrival_t"] - arrival[r["id"]]) * 1e3)
            split["route_decision"].append(route_ms.get(r["id"], 0.0))
            split["engine_ttft"].append(rec["ttft_s"] * 1e3)
            split["delivery"].append((r["times"][0] - rec["arrival_t"] - rec["ttft_s"]) * 1e3)
        n_out = sum(len(r["tokens"]) for r in results)
        router_share = [(a + d) / c for a, d, c in zip(split["router_to_engine"], split["delivery"], c_ttft)]
        res["burst"] = dict(
            requests=len(results), sse=len(sse), output_tokens=n_out, wall_s=load_wall, tokens_per_s=n_out / load_wall,
            serve_tokens_per_s=serve_res["load"]["tokens_per_s"],
            tokens_per_s_ratio=n_out / load_wall / serve_res["load"]["tokens_per_s"],
            equal_to_solo=len(results) - len(diverged), of=len(results), diverged=diverged,
            split_across_replicas={str(ids.index(rid)): sum(r["replica"] == rid for r in results) for rid in ids},
            client_ttft_ms_p50=pct(c_ttft, 0.5), client_ttft_ms_p99=pct(c_ttft, 0.99),
            client_tpot_ms_p50=pct(c_tpot, 0.5), client_tpot_ms_p99=pct(c_tpot, 0.99),
            ttft_split_ms_p50={k: pct(v, 0.5) for k, v in split.items()},
            ttft_split_ms_max={k: max(v) for k, v in split.items()},
            router_and_hops_share_of_client_ttft_p50=pct(router_share, 0.5))
        for i, d in diverged.items():
            check(d["within_depth_gate"], f"router: burst request {i} leaves its solo stream at {d['position']} "
                                          f"outside twice the bf16 distance: {d}")

        # the same burst behind the same router with one replica (the other
        # drained): against ``serve``'s number it prices the router, against
        # the two-replica burst the second engine loop in the process
        check(http_json(rport, "POST", "/replicas/drain", {"id": ids[1], "deadline_s": 600})[0] == 200,
              "router: draining replica 1 for the one-replica burst")
        one = burst_summary(*burst("one-replica burst"))
        router.pool.cancel_drain(ids[1])
        http_json(port_of[ids[1]], "POST", "/admin/drain", {"undo": True})
        wait(lambda: state_of(ids[1]) == "healthy", "replica 1 to rejoin")
        # and the two-replica burst with the interpreter's thread switch
        # interval at 1 ms (from 5): the two loops' host work shares one GIL
        switch = sys.getswitchinterval()
        sys.setswitchinterval(0.001)
        try:
            fast_switch = burst_summary(*burst("1 ms switch burst"))
        finally:
            sys.setswitchinterval(switch)
        res["burst"].update(one_replica=one, switch_interval_1ms=fast_switch, default_switch_interval_s=switch)

        # single-request TTFT through the router minus direct: 8 alternating
        # pairs on a 256-token prompt, each on cold caches
        short = int(np.argmin([len(p) for p in prompts]))
        pin = router.policy.select(router.pool.snapshots(), prompt=prompts[short].tolist())[0].id
        through, direct_ttft = [], []
        for k in range(16):
            clear_caches()
            via_router = k % 2 == 0
            s = fleet_stream(rport if via_router else port_of[pin], {"prompt": prompts[short].tolist(),
                                                                      "max_tokens": 2})
            check(s["status"] == 200 and len(s["times"]) == 2, f"router: TTFT probe answered {s['status']}")
            (through if via_router else direct_ttft).append((s["times"][0] - s["t0"]) * 1e3)
        res["single_ttft_ms"] = dict(router_p50=pct(through, 0.5), direct_p50=pct(direct_ttft, 0.5),
                                     router_minus_direct_p50=pct([a - b for a, b in zip(through, direct_ttft)], 0.5),
                                     prompt_tokens=len(prompts[short]))

        # (c) failover: two streams on the shared prefix are mid-stream on the
        # replica it pins when that replica's next step fails (and its first
        # rebuild too); a third, sent as the fault is armed, has no token yet
        shared = [i for i in range(len(prompts)) if len(prompts[i]) > 1024 and i not in sampled]
        pinned = router.policy.select(router.pool.snapshots(), prompt=prompts[shared[0]].tolist())[0].id
        other = next(r for r in ids if r != pinned)
        clear_caches()
        tail = {"prompt": prompts[shared[2]].tolist(), "max_tokens": 16}
        want_tail = http_json(port_of[other], "POST", "/v1/completions", tail)[1]["choices"][0]["token_ids"]
        clear_caches()
        fo = {}
        started = [threading.Event(), threading.Event()]

        def mid(k):
            fo[k] = fleet_stream(rport, {"prompt": prompts[shared[k]].tolist(), "max_tokens": 64},
                                 on_token=lambda n: started[k].set())

        mids = [threading.Thread(target=mid, args=(k,)) for k in range(2)]
        for t in mids:
            t.start()
        for e in started:
            check(e.wait(120), "router: a failover stream never started")
        FAULTS.arm("engine.step", nth=1)
        FAULTS.arm("engine.rebuild", nth=1)
        t_fault = time.perf_counter()
        late = fleet_stream(rport, tail)
        for t in mids:
            t.join(timeout=600)
        wait(lambda: state_of(pinned) != "healthy" or FAULTS.fired("engine.rebuild"), "the pinned replica's fault")
        in_window = state_of(pinned)
        status_w, body_w = http_json(rport, "POST", "/v1/completions",
                                     {"prompt": prompts[1].tolist(), "max_tokens": 4})
        wait(lambda: state_of(pinned) == "healthy", "the pinned replica to return HEALTHY", timeout=180)
        res["failover"] = dict(
            pinned=ids.index(pinned), fired=FAULTS.fired("engine.step"), rebuild_failed=FAULTS.fired("engine.rebuild"),
            mid_stream=[dict(status=fo[k]["status"], tokens=len(fo[k]["tokens"]), finish=fo[k]["finish"],
                             replica=ids.index(fo[k]["replica"]) if fo[k]["replica"] in ids else None)
                        for k in range(2)],
            token_less=dict(status=late["status"], tokens=len(late["tokens"]), finish=late["finish"],
                            equal=late["tokens"] == want_tail,
                            replica=ids.index(late["replica"]) if late["replica"] in ids else None),
            window_state=in_window, window_post=dict(status=status_w, replica=ids.index(body_w.get("replica", pinned))
                                                      if status_w == 200 else None),
            healthy_again_s=time.perf_counter() - t_fault,
            failovers=router.metrics.failovers.value(), rerouted=router.metrics.rerouted.value())
        FAULTS.reset()
        for k in range(2):
            check(fo[k]["status"] == 200 and fo[k]["finish"] == "replica_error" and 1 <= len(fo[k]["tokens"]) < 64,
                  f"router: mid-stream failover stream {k}: {res['failover']['mid_stream'][k]}")
        check(late["status"] == 200 and late["finish"] == "length" and late["tokens"] == want_tail
              and late["replica"] == other,
              f"router: the token-less stream did not fail over token-exact: {res['failover']['token_less']}")
        check(in_window != "healthy" and status_w == 200,
              f"router: the POST in the window answered {status_w} (pinned replica {in_window})")

        # (d) drain a replica with two streams in flight: both finish whole
        clear_caches()
        drained = {}
        first = [threading.Event(), threading.Event()]

        def drained_stream(k):
            drained[k] = fleet_stream(rport, {"prompt": prompts[shared[k]].tolist(), "max_tokens": 64},
                                      on_token=lambda n: first[k].set())

        dts = [threading.Thread(target=drained_stream, args=(k,)) for k in range(2)]
        for t in dts:
            t.start()
        for e in first:
            check(e.wait(120), "router: a stream to drain never started")
        victim = pinned
        status_d, drain_doc = http_json(rport, "POST", "/replicas/drain", {"id": victim, "deadline_s": 120})
        open_at_drain = router._open_forwards_on(victim)
        status_n, body_n = http_json(rport, "POST", "/v1/completions",
                                     {"prompt": prompts[shared[3]].tolist(), "max_tokens": 4})
        for t in dts:
            t.join(timeout=600)
        wait(lambda: (router.pool.drain_status(victim) or {}).get("drained"), "the drain to complete")
        router.pool.cancel_drain(victim)
        http_json(port_of[victim], "POST", "/admin/drain", {"undo": True})
        wait(lambda: state_of(victim) == "healthy", "the drained replica to rejoin")
        res["drain"] = dict(status=status_d, state=drain_doc["drain"]["state"], open_forwards=open_at_drain,
                            streams=[dict(status=drained[k]["status"], tokens=len(drained[k]["tokens"]),
                                          finish=drained[k]["finish"]) for k in range(2)],
                            new_request=dict(status=status_n, on_other=body_n.get("replica") == other))
        check(status_d == 200 and open_at_drain == 2, f"router: drain with {open_at_drain} streams: {drain_doc}")
        check(all(drained[k]["status"] == 200 and drained[k]["finish"] == "length"
                  and len(drained[k]["tokens"]) == 64 for k in range(2)),
              f"router: a stream was lost in the drain: {res['drain']['streams']}")
        check(status_n == 200 and body_n.get("replica") == other, "router: a new request went to the draining replica")

        # one autoscaler tick under a forced fast burn provisions a third replica
        prov = rt.InProcessProvisioner(factory, replica_kw=replica_kw)
        scaler = rt.Autoscaler(("127.0.0.1", rport), prov, registry=serving.MetricsRegistry(),
                               policy=rt.AutoscalerPolicy(min_replicas=2, max_replicas=3, hysteresis_up=1,
                                                          max_step_up=1))
        obs = scaler.observe()
        obs.ttft_burn = 100.0
        t_up = time.perf_counter()
        summary = scaler.evaluate_once(observation=obs)
        new = [f"{h}:{p}" for h, p in prov.servers]
        check(len(new) == 1, f"router: the autoscaler provisioned {len(new)} replicas: {summary}")
        wait(lambda: state_of(new[0]) == "healthy", "the third replica to probe HEALTHY")
        up_s = time.perf_counter() - t_up
        status_3, _ = http_json(int(new[0].rsplit(":", 1)[1]), "POST", "/v1/completions",
                                {"prompt": prompts[1].tolist(), "max_tokens": 4})
        res["scale_up"] = dict(actions=[a[0] for a in summary["actions"]], replicas=len(router.pool),
                               time_to_healthy_s=up_s, direct_status=status_3)
        check(len(router.pool) == 3 and status_3 == 200, f"router: scale-up: {res['scale_up']}")
        http_json(rport, "POST", "/replicas/drain", {"id": new[0], "deadline_s": 30})
        wait(lambda: (router.pool.drain_status(new[0]) or {}).get("drained"), "the third replica to drain")
        check(http_json(rport, "DELETE", f"/replicas/{new[0]}")[0] == 200, "router: removing the third replica")
        prov.close()
        prov = None

        # (e) the fleet planes
        texts = {rid: http_call(port_of[rid], "GET", "/metrics")[1].decode() for rid in ids}
        lint = rt.lint_federation(texts)
        status_f, fed = http_call(rport, "GET", "/fleet/metrics")
        slo = http_json(rport, "GET", "/fleet/slo")[1]
        usage = http_json(rport, "GET", "/fleet/usage")[1]
        eff = http_json(rport, "GET", "/debug/efficiency")[1]
        status_t, traced = http_json(rport, "POST", "/v1/completions", {"prompt": prompts[3].tolist(), "max_tokens": 4})
        trace_id = traced["id"]
        stitched = http_json(rport, "GET", f"/debug/trace?trace={trace_id}")[1]
        lanes = {e.get("pid") for e in stitched["traceEvents"] if e.get("ph") == "X"}
        res["planes"] = dict(lint_federation=lint, federated_bytes=len(fed), replicas_in_slo=len(slo["replicas"]),
                             slo_windows=sorted(slo["windows"]), usage_records=usage["fleet"]["records"],
                             fleet_goodput=eff["fleet"]["goodput_ratio"], stitched_trace=trace_id,
                             stitched_lanes=len(lanes), stitched_events=len(stitched["traceEvents"]),
                             stitched_names=sorted({e["name"] for e in stitched["traceEvents"] if e.get("ph") == "X"}))
        check(lint == [] and status_f == 200, f"router: lint_federation: {lint}")
        check(len(slo["replicas"]) == 2 and not slo["skipped"], f"router: /fleet/slo folded {slo['replicas']}")
        check(len(lanes) == 2 and "route" in res["planes"]["stitched_names"],
              f"router: the stitched trace of {trace_id} holds {res['planes']['stitched_names']}")
    finally:
        FAULTS.reset()
        if prov is not None:
            prov.close()
        fleet.shutdown(drain_timeout_s=120)
    torch.cuda.synchronize()
    # (f) every paged launch of the phase on the Hopper route
    res.update(kernel_launches=pa.LAUNCHES, sm90_launches=pa.LAUNCHES_SM90, engines_built=len(engines),
               engine_devices=sorted(set(engines)), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               wall_s=time.perf_counter() - t_phase)
    emit(res)
    check(set(engines) == {DEVICE}, f"router: replica engines on {sorted(set(engines))}")
    check(pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
          f"router: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} launches on the Hopper route")
    del fleet
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- spec
# Qwen/Qwen2-0.5B config.json (https://huggingface.co/Qwen/Qwen2-0.5B/blob/main/config.json): the draft model
QWEN2_0_5B = dict(
    vocab_size=151936, hidden_size=896, intermediate_size=4864, num_hidden_layers=24,
    num_attention_heads=14, num_key_value_heads=2, max_position_embeddings=131072,
    rms_norm_eps=1e-6, rope_theta=1000000.0, hidden_act="silu", initializer_range=0.02,
    tie_word_embeddings=True, use_sliding_window=False, sliding_window=131072, max_window_layers=24,
    bos_token_id=151643, eos_token_id=151643,
)
SPEC_K = 4  # spec_draft_len of every speculative run
SERVE_ENGINE = dict(max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256)


def divergence(torch, model, prompt, got, want, fp32_logits=None, noise=None):
    """None when two greedy streams are equal. Otherwise their first
    divergent position, with the two tokens' fp32 logits there from the
    plain dense forward over the common prefix (or ``fp32_logits(ids)``, the
    last position's fp32 logits of the function the streams compute, where
    it is not the dense one), their margin and the bf16 gate
    ``2**-7 * |logit| + 1e-3``: a bf16 verify over [8, 5] rows and a
    decode over [8, 1] rows run GEMMs of different M, so a near-tie may take
    the other token. Only a divergence within the gate passes. For sampled
    streams ``noise(position)`` is what the sampler adds to the logits there
    (temperature x its Gumbel draw): the margin is then the two tokens'
    sampling scores'."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        check(len(got) == len(want), f"streams of {len(got)} and {len(want)} tokens share every position")
        return None
    ids = [int(t) for t in prompt] + list(want[:j])
    row = model(torch.tensor([ids], device=DEVICE), dtype=torch.float32)[0, -1] if fp32_logits is None \
        else fp32_logits(ids)
    la, lb = row[got[j]].item(), row[want[j]].item()
    na = nb = 0.0
    if noise is not None:
        n = noise(len(ids))
        na, nb = n[got[j]].item(), n[want[j]].item()
    margin, gate = abs(la + na - lb - nb), 2**-7 * max(abs(la), abs(lb)) + 1e-3
    del row
    return dict(position=j, tokens=[got[j], want[j]], logits=[la, lb], margin=margin, gate=gate,
                within_gate=margin <= gate)


def serve_waves(torch, eng, prompts, sp_of, waves, adapter_of=None):
    """Serve ``prompts`` on ``eng``, wave after wave (each wave runs to
    completion), request i on adapter ``adapter_of(i)`` when given; returns
    ({prompt index: Request}, wall s)."""
    index, done = {}, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wave in waves:
        for i in wave:
            index[eng.add_request(prompts[i], sp_of(i), adapter_id=None if adapter_of is None else adapter_of(i))] = i
        while eng.has_work():
            for r in eng.step():
                done[index[r.req_id]] = r
    torch.cuda.synchronize()
    return done, time.perf_counter() - t0


def latency(done, wall):
    ttft = [r.ttft * 1e3 for r in done.values()]
    tpot = [r.decode_time / (len(r.output_ids) - 1) * 1e3 for r in done.values() if len(r.output_ids) > 1]
    n = sum(len(r.output_ids) for r in done.values())
    return dict(requests=len(done), output_tokens=n, wall_s=wall, tokens_per_s=n / wall,
                ttft_ms_p50=pct(ttft, 0.5), ttft_ms_p99=pct(ttft, 0.99),
                tpot_ms_p50=pct(tpot, 0.5), tpot_ms_p99=pct(tpot, 0.99))


class SpecProbe:
    """Counts a speculative engine's work, without changing it: the verify
    forwards (device ms by CUDA events; the call syncs anyway) and the rows
    they carry, the draft forwards and their buffer lengths, every paged
    launch of verify's shape and whether it took the Hopper route, and
    whether a verify ran with a sampled request in the batch."""

    def __init__(self, torch, eng, pa):
        self.verify_ms, self.draft_ms, self.draft_buckets = [], [], []
        self.live_rows = self.verify_launches = self.verify_sm90 = self.sampled_verifies = 0
        real_verify, real_draft, real_spec = eng.backend.verify, eng._draft_rows, eng._decode_spec
        infer_module = sys.modules[type(eng.infer).__module__]
        self._restore = [(eng.backend, "verify", real_verify), (eng, "_draft_rows", real_draft),
                         (eng, "_decode_spec", real_spec),
                         (infer_module, "ragged_paged_attention", infer_module.ragged_paged_attention)]

        def timed(fn, into, *args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            into.append(start.elapsed_time(end))
            return out

        def verify(tokens, tables, start, need_logits):
            self.live_rows += int((tables[:, 0] != 0).sum())
            return timed(real_verify, self.verify_ms, tokens, tables, start, need_logits=need_logits)

        def draft(ids, pos):
            self.draft_buckets.append(int(ids.shape[1]))
            return timed(real_draft, self.draft_ms, ids, pos)

        def spec(finished, drafts, qprobs=None, mode="greedy"):
            self.sampled_verifies += any(r is not None and r.sampling.do_sample for r in eng.slots) \
                and mode == "greedy"
            return real_spec(finished, drafts, qprobs, mode)

        kernel = infer_module.ragged_paged_attention

        def counted(q, *args, **kwargs):
            if q.shape[1] != SPEC_K + 1:
                return kernel(q, *args, **kwargs)
            before = pa.LAUNCHES_SM90
            out = kernel(q, *args, **kwargs)
            self.verify_launches += 1
            self.verify_sm90 += pa.LAUNCHES_SM90 - before
            return out

        eng.backend.verify, eng._draft_rows, eng._decode_spec = verify, draft, spec
        infer_module.ragged_paged_attention = counted

    def close(self):
        for obj, name, fn in self._restore:
            setattr(obj, name, fn)


def spec_run(torch, pa, fa, model, eng, prompts, sp_of, waves):
    """Serve ``prompts`` on a speculative engine with every kernel count set
    to 0 just before and read just after; check the engine's bookkeeping."""
    probe = SpecProbe(torch, eng, pa)
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    for counts in (fa.LAUNCHES, fa.LAUNCHES_SM90):
        counts["fwd"] = 0
    try:
        done, wall = serve_waves(torch, eng, prompts, sp_of, waves)
    finally:
        probe.close()
    s = dict(eng.spec_stats)
    layers = model.config.num_hidden_layers
    # tokens a verify forward emits, over its whole batch and a row
    out = dict(latency(done, wall), spec_stats=s, tokens_per_verify=s["tokens_emitted"] / max(s["verify_steps"], 1),
               verify_row_steps=probe.live_rows, tokens_per_row_verify=s["tokens_emitted"] / max(probe.live_rows, 1),
               acceptance_rate=s["accepted"] / max(s["drafted"], 1),
               verify_ms_per_step=sum(probe.verify_ms) / max(len(probe.verify_ms), 1),
               paged_launches=pa.LAUNCHES, paged_sm90_launches=pa.LAUNCHES_SM90,
               verify_launches=probe.verify_launches, verify_sm90_launches=probe.verify_sm90,
               flash_fwd_launches=fa.LAUNCHES["fwd"], flash_fwd_sm90_launches=fa.LAUNCHES_SM90["fwd"],
               ledger=eng.ledger.snapshot()["totals"])
    if probe.draft_ms:
        out.update(draft_forwards=len(probe.draft_ms), draft_buckets=sorted(set(probe.draft_buckets)),
                   draft_ms_per_forward=sum(probe.draft_ms) / len(probe.draft_ms),
                   draft_ms_per_step=sum(probe.draft_ms) / max(s["verify_steps"], 1))
    for i, r in done.items():
        check(r.finish_reason in ("length", "stop"), f"spec: request {i} ended {r.finish_reason}")
        check(r.finish_reason == "stop" or len(r.output_ids) == r.sampling.max_new_tokens, f"spec: request {i} short")
    check(eng.ledger.verify_conservation(), "spec: goodput ledger conservation broken")
    t = out["ledger"]
    check(t["fed"] == t["useful"] + t["padding"] + t["spec_rejected"] + t["rework"],
          f"spec: fed != useful + padding + spec_rejected + rework: {t}")
    check(s["drafted"] >= s["accepted"], f"spec: accepted more than drafted: {s}")
    check(t["spec_rejected"] == s["drafted"] - s["accepted"], f"spec: ledger spec_rejected {t} vs {s}")
    # each verify step emits its accepted drafts plus one token a live row
    # (no draft runs past a request's budget); a stop id ends a row early
    stopped = any(r.finish_reason == "stop" for r in done.values())
    check(s["tokens_emitted"] == s["accepted"] + probe.live_rows
          or (stopped and s["tokens_emitted"] < s["accepted"] + probe.live_rows),
          f"spec: {s['tokens_emitted']} tokens emitted, {s['accepted']} accepted + {probe.live_rows} row-steps")
    check(probe.sampled_verifies == 0, f"spec: {probe.sampled_verifies} greedy verifies with a sampler in the batch")
    check(probe.verify_launches == s["verify_steps"] * layers and probe.verify_sm90 == probe.verify_launches,
          f"spec: {probe.verify_sm90} of {probe.verify_launches} verify launches on the Hopper route "
          f"({s['verify_steps']} verify steps x {layers} layers)")
    check(pa.LAUNCHES_SM90 == pa.LAUNCHES, f"spec: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches on the "
          "Hopper route")
    check(fa.LAUNCHES_SM90["fwd"] == fa.LAUNCHES["fwd"],
          f"spec: {fa.LAUNCHES_SM90['fwd']} of {fa.LAUNCHES['fwd']} flash forwards on the Hopper route")
    if probe.draft_ms:
        per = eng.draft_model.config.num_hidden_layers
        check(fa.LAUNCHES["fwd"] == len(probe.draft_ms) * per,
              f"spec: {fa.LAUNCHES['fwd']} flash forwards for {len(probe.draft_ms)} draft forwards x {per} layers")
    return done, out


def compare_greedy(torch, model, prompts, got, want, greedy, what):
    """Greedy streams with speculation against those without: equal, or a
    first divergence within the bf16 gate (printed)."""
    diverged = {}
    for i in greedy:
        d = divergence(torch, model, prompts[i], got[i], want[i])
        if d is not None:
            diverged[i] = d
            check(d["within_gate"], f"spec {what}: request {i} diverges at {d['position']} outside the bf16 gate: {d}")
    return dict(equal=sum(1 for i in greedy if i not in diverged), of=len(greedy), diverged=diverged)


def spec_step_device_ms(torch, model, draft, InferenceEngine, SamplingParams, prompts):
    """Device time of one speculative step by part: ``torch.profiler`` over
    two steps of a draft-model engine past admission, each part's kernels
    read off its ``record_function`` range (``spec_propose``: the draft's
    forwards; ``spec_verify``: the verify forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = InferenceEngine(model, **SERVE_ENGINE, draft_model=draft, spec_draft_len=SPEC_K)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=16))
    eng.step()  # admission: the prefill and a first speculative step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    out = dict(steps=2, wall_ms_per_step=wall_ms)
    for e in prof.key_averages():
        if e.key in ("spec_propose", "spec_verify") and e.device_type == DeviceType.CPU:
            out[e.key] = e.device_time_total / 1e3 / 2
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    out["all_kernels"] = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
    del eng
    return out


def verify_vs_decode(torch, np, model, seed):
    """Row 0 of a [8, 5] verify forward against a [8, 1] decode forward over
    the same pool (8 rows after 300-559-token prompts), with the verify's
    projections one GEMM a position (the engine's layout) and one GEMM over
    all 40 rows: bitwise equal, largest logit difference, argmaxes equal."""
    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.paged_cache import PagedKVPool, init_paged_pool

    B, mb, bs = 8, 48, 16
    infer = PagedInferenceModel(model, bs, B * mb + 1, mb, dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 7)
    lens = [300 + 37 * i for i in range(B)]
    tables = torch.arange(1, B * mb + 1, dtype=torch.int32, device=DEVICE).reshape(B, mb)
    S = mb * bs
    s_ar = torch.arange(S, device=DEVICE)[None]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    pool = init_paged_pool(model.config, B * mb + 1, bs, dtype=torch.bfloat16, device=DEVICE)
    last = []
    for i, n in enumerate(lens):
        ids = torch.tensor(rng.integers(8, model.config.vocab_size, (1, n)), dtype=torch.int32, device=DEVICE)
        logits = infer._forward(pool, ids, tables[i: i + 1], torch.arange(n, device=DEVICE)[None], s_ar < n,
                                i32([0]), i32([n - 1]), q_lens=i32([n]))
        last.append(int(logits.argmax()))
    start, tok = i32(lens), i32(last)
    decode = infer._forward(PagedKVPool(kv=pool.kv.clone()), tok[:, None], tables, start[:, None],
                            s_ar <= start[:, None], start, torch.zeros(B, dtype=torch.int32, device=DEVICE)).float()
    drafts = torch.tensor(rng.integers(8, model.config.vocab_size, (B, 4)), dtype=torch.int32, device=DEVICE)
    out = {}
    for layout, per_position in (("one_gemm_a_position", True), ("one_gemm", False)):
        verify = infer._forward(PagedKVPool(kv=pool.kv.clone()), torch.cat([tok[:, None], drafts], 1), tables,
                                start[:, None] + torch.arange(5, device=DEVICE)[None], s_ar <= start[:, None] + 4,
                                start, None, per_position=per_position)[:, 0].float()
        out[layout] = dict(bitwise=bool(torch.equal(verify, decode)), max_abs=(verify - decode).abs().max().item(),
                           argmax_equal=int((verify.argmax(-1) == decode.argmax(-1)).sum().item()), rows=B)
    del pool, decode, verify
    torch.cuda.empty_cache()
    return out


def draft_flash_case(torch, fa, L, seed):
    """The draft's attention launch, q [4, L, 14, 64] bf16 over k/v
    [4, L, 2, 64] causal, through the Hopper flash forward against its plain
    version; times against the bound, the plain version and SDPA."""
    import torch.nn.functional as F

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B, N, K, H = 4, QWEN2_0_5B["num_attention_heads"], QWEN2_0_5B["num_key_value_heads"], 64
    q = torch.randn(B, L, N, H, generator=g, device=DEVICE).to(torch.bfloat16)
    k, v = (torch.randn(B, L, K, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    sm90 = fa.LAUNCHES_SM90["fwd"]
    out, lse = fa.flash_attention_fwd(q, k, v)
    check(fa.LAUNCHES_SM90["fwd"] == sm90 + 1, "draft flash: the bf16 forward did not take the Hopper route")
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v)
    errs = flash_worst(torch, dict(out=out, lse=lse), dict(out=ref_out, lse=ref_lse), "bfloat16")
    for t, e in errs.items():
        check(e["finite"] and e["worst"] <= 1.0, f"draft flash: {t} exceeds its bound: {e}")
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = time_cuda(torch, lambda: fa.flash_attention_fwd(q, k, v), 20, flush)
    plain_ms = time_cuda(torch, lambda: fa.flash_attention_fwd_ref(q, k, v), 3, flush)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with torch.no_grad():
        library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                                             enable_gqa=True), 20, flush)
    bound_ms, bound_by = flash_bound(torch, fa, q, k, None, None, "fwd")
    del flush, q, k, v, out, lse, ref_out, ref_lse, qh, kh, vh
    torch.cuda.empty_cache()
    return dict(q=[B, L, N, H], kv=[B, L, K, H], errors=errs, worst_err_over_tol=max(e["worst"] for e in errs.values()),
                max_abs_err=max(e["max_abs_err"] for e in errs.values()), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_spec(torch, np, model, pa, fa, InferenceEngine, SamplingParams, Qwen2ForCausalLM, Qwen2Config,
               mono_streams, seed):
    """Speculative decoding on the Qwen2-7B engine: (a) the n-gram proposer
    on 8 extractive prompts, greedy, against the same engine settings
    without speculation; (b) a Qwen2-0.5B draft model, greedy and sampled;
    (c) the engine phase's mix (2 seeded top-p samplers among 8) with
    speculation on, against the engine phase's streams."""
    vocab = model.config.vocab_size
    res = dict(phase="spec", config="Qwen/Qwen2-7B", engine=SERVE_ENGINE, spec_draft_len=SPEC_K)
    launches = dict(paged=0, paged_sm90=0, flash_fwd=0, flash_fwd_sm90=0)

    def tally(out):
        for key, field in (("paged", "paged_launches"), ("paged_sm90", "paged_sm90_launches"),
                           ("flash_fwd", "flash_fwd_launches"), ("flash_fwd_sm90", "flash_fwd_sm90_launches")):
            launches[key] += out[field]

    # (a) n-gram, greedy: prompts of 512-960 tokens, each a random 128-token
    # segment repeated; 64 new tokens each. Random weights do not continue
    # the segment, so the proposer may find no n-gram to draft from: the
    # engine then keeps to the plain decode, which this run reports
    rng = np.random.default_rng(seed + 4)
    prompts = [np.tile(rng.integers(8, vocab, 128), 8)[: 512 + 64 * i] for i in range(8)]
    greedy = lambda i: SamplingParams(max_new_tokens=64)  # noqa: E731
    plain_done, plain_wall = serve_waves(torch, InferenceEngine(model, **SERVE_ENGINE), prompts, greedy, [range(8)])
    eng = InferenceEngine(model, **SERVE_ENGINE, use_speculative=True, spec_draft_len=SPEC_K, spec_ngram=2)
    done, ngram = spec_run(torch, pa, fa, model, eng, prompts, greedy, [range(8)])
    del eng
    tally(ngram)
    ngram["without_spec"] = latency(plain_done, plain_wall)
    # where the proposer could have drafted: positions of the plain streams
    # whose last 2 tokens occurred earlier in prompt + stream
    hits = 0
    for i, r in plain_done.items():
        hist = [int(t) for t in prompts[i]] + list(r.output_ids)
        seen = {tuple(hist[j: j + 2]) for j in range(len(prompts[i]) - 1)}
        for j in range(len(prompts[i]), len(hist)):
            hits += tuple(hist[j - 1: j + 1]) in seen
            seen.add(tuple(hist[j - 1: j + 1]))
    ngram["plain_positions_with_an_earlier_2gram"] = hits
    ngram["greedy_vs_without"] = compare_greedy(
        torch, model, prompts, {i: r.output_ids for i, r in done.items()},
        {i: r.output_ids for i, r in plain_done.items()}, range(8), "ngram")
    res["ngram"] = dict(ngram, prompt_tokens=[len(p) for p in prompts], spec_ngram=2)
    torch.cuda.empty_cache()

    # (b) a Qwen2-0.5B draft: 4 requests of 256-512 prompt tokens, 32 new
    # tokens, greedy and then sampled
    dcfg = Qwen2Config(**dict(QWEN2_0_5B, vocab_size=vocab))
    draft = Qwen2ForCausalLM.init_random(dcfg, seed=seed + 1, device=DEVICE, dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 5)
    d_prompts = [rng.integers(8, vocab, n) for n in (256, 320, 448, 512)]
    short = lambda i: SamplingParams(max_new_tokens=32)  # noqa: E731
    sampled = lambda i: SamplingParams(max_new_tokens=32, do_sample=True, temperature=0.9, top_k=0, top_p=1.0,  # noqa: E731
                                       seed=20 + i)
    plain_done, plain_wall = serve_waves(torch, InferenceEngine(model, **SERVE_ENGINE), d_prompts, short, [range(4)])
    runs = {}
    for mode, sp_of in (("greedy", short), ("sampled", sampled)):
        eng = InferenceEngine(model, **SERVE_ENGINE, draft_model=draft, spec_draft_len=SPEC_K)
        runs[mode] = spec_run(torch, pa, fa, model, eng, d_prompts, sp_of, [range(4)])
        del eng
        tally(runs[mode][1])
        check(runs[mode][1]["spec_stats"]["verify_steps"] > 0, f"spec draft {mode}: no verify step ran")
    draft_model = dict(config="Qwen/Qwen2-0.5B", params=draft.num_parameters(),
                       reduced=dict(vocab_size=dict(published=QWEN2_0_5B["vocab_size"], run=vocab,
                                                    why="the target's (Qwen2-7B) vocabulary, so that rejection "
                                                        "sampling's p - q shares one support")),
                       without_spec=latency(plain_done, plain_wall), prompt_tokens=[len(p) for p in d_prompts])
    draft_model["greedy"] = dict(runs["greedy"][1], greedy_vs_without=compare_greedy(
        torch, model, d_prompts, {i: r.output_ids for i, r in runs["greedy"][0].items()},
        {i: r.output_ids for i, r in plain_done.items()}, range(4), "draft greedy"))
    draft_model["sampled"] = dict(runs["sampled"][1], temperature=0.9, top_k=0, top_p=1.0)
    buckets = runs["greedy"][1]["draft_buckets"] + runs["sampled"][1]["draft_buckets"]
    L = max(set(buckets), key=buckets.count)
    draft_model["device_ms_per_step"] = spec_step_device_ms(torch, model, draft, InferenceEngine, SamplingParams,
                                                            d_prompts)
    del draft
    torch.cuda.empty_cache()
    draft_model["flash_kernel"] = draft_flash_case(torch, fa, L, seed)
    res["draft_model"] = draft_model

    # (c) the engine phase's mix with speculation on: it falls back to the
    # plain decode while a sampler is in the batch; streams equal the engine
    # phase's (samplers exactly, greedy ones up to the bf16 gate)
    mix, samplers = traffic(np, vocab, seed)

    def mix_sp(i):
        if i in samplers:
            return SamplingParams(max_new_tokens=64, do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
        return SamplingParams(max_new_tokens=64)

    eng = InferenceEngine(model, **SERVE_ENGINE, use_speculative=True, spec_draft_len=SPEC_K)
    done, mixed = spec_run(torch, pa, fa, model, eng, mix, mix_sp, [[0], range(1, 8)])
    del eng
    tally(mixed)
    got = {i: r.output_ids for i, r in done.items()}
    for i in samplers:
        check(got[i] == mono_streams[i], f"spec mix: sampled request {i} differs from the engine phase's stream")
    mixed["streams_vs_engine_phase"] = dict(
        samplers_equal=len(samplers),
        greedy=compare_greedy(torch, model, mix, got, mono_streams, [i for i in range(8) if i not in samplers], "mix"))
    res["engine_mix"] = mixed
    res["verify_layout"] = verify_vs_decode(torch, np, model, seed)
    res["launches"] = launches
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(res)
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- host tier
def host_conversation(torch, np, eng, turn1, flood, more, sp, bs):
    """Turn 1, a flood that evicts it (on a small pool), turn 2 on turn 1 and
    its output; the host tier's checks where the engine has one."""
    tier = eng._host_tier
    done1, _ = serve_waves(torch, eng, [turn1], lambda i: sp, [[0]])
    out1 = done1[0].output_ids
    history = np.concatenate([turn1, np.asarray(out1[:-1], np.int32)])  # the last token was never fed
    hashes = eng.mgr._chain_hashes(history, len(history) // bs)
    turn1_blocks = eng.pool.kv[:, :, [eng.mgr._index[h] for h in hashes]].clone() if tier is not None else None
    t0 = time.perf_counter()
    for p in flood:
        eng.add_request(p, sp)
    while eng.has_work():
        eng.step()
    flood_s = time.perf_counter() - t0
    left = sum(h in eng.mgr._index for h in hashes)
    promoted0 = tier.stats["promoted_blocks"] if tier is not None else 0
    turn2 = np.concatenate([turn1, np.asarray(out1, np.int32), more])
    eng.add_request(turn2, sp)
    finished = []
    while eng.has_work():
        finished += eng.step()
    r2 = finished[0]
    torch.cuda.synchronize()
    run = dict(turn1=out1, turn2=r2.output_ids, turn2_ttft_ms=r2.ttft * 1e3, turn2_cached_tokens=r2.cached_tokens,
               turn2_prompt_tokens=len(turn2), flood_s=flood_s, history_blocks=len(hashes),
               history_blocks_left_after_flood=left)
    if tier is not None:
        run["promoted_blocks"] = tier.stats["promoted_blocks"] - promoted0
        check(run["promoted_blocks"] >= 60, f"host_tier: turn 2 promoted {run['promoted_blocks']} blocks (< 60)")
        now = eng.pool.kv[:, :, [eng.mgr._index[h] for h in hashes]]
        check(torch.equal(now, turn1_blocks), "host_tier: promoted blocks differ from the bytes spilled")
        check(not (set(eng.mgr._index) & set(tier._entries)), "host_tier: a hash resident in both tiers")
        del now, turn1_blocks
    mgr = eng.mgr
    check(not mgr.tables and len(mgr.free) + len(mgr._lru) == mgr.total_usable_blocks, "host_tier: blocks leaked")
    return run


def phase_host_tier(torch, np, model, pa, InferenceEngine, SamplingParams, serving, seed):
    """The host KV tier at Qwen2-7B: a 256-block pool over a 512-block tier
    against a 2048-block pool that never evicts and the small pool without
    the tier. Turn 1 (1024 tokens, 32 new), a flood of 4 unrelated
    1024-token prompts that evicts every turn-1 block, then turn 2 (turn 1,
    its output and 40 more tokens): twice on each engine with other tokens,
    since the process's first host<->device copies pay a one-time set-up
    that later ones do not. Then the same two turns as a
    chat over HTTP through ``ServingServer`` on the small pool with the tier."""
    vocab, bs = model.config.vocab_size, 16
    rng = np.random.default_rng(seed + 6)
    convs = [(rng.integers(8, vocab, 1024), [rng.integers(8, vocab, 1024) for _ in range(4)],
              rng.integers(8, vocab, 40)) for _ in range(2)]
    small = dict(SERVE_ENGINE, num_blocks=256)
    configs = {"host_tier": dict(small, host_kv_blocks=512), "never_evicts": SERVE_ENGINE, "cold": small}
    sp = SamplingParams(max_new_tokens=32)
    res = dict(phase="host_tier", config="Qwen/Qwen2-7B", engines=configs)
    runs, copies = {}, {"d2h": [], "h2d": []}
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    for name, kw in configs.items():
        eng = InferenceEngine(model, **kw)
        tier = eng._host_tier
        if tier is not None:
            cfg = model.config  # at Qwen2-7B in bf16: 28 * 2 * 4 * 16 * 128 * 2 bytes = 0.875 MiB a block
            want = cfg.num_hidden_layers * 2 * cfg.num_key_value_heads * bs * cfg.head_dim * eng.pool.kv.element_size()
            check(tier.block_bytes == want, f"host_tier: {tier.block_bytes} bytes a block, want {want}")
        runs[name] = [host_conversation(torch, np, eng, *conv, sp, bs) for conv in convs]
        if name != "never_evicts":
            left = [r["history_blocks_left_after_flood"] for r in runs[name]]
            check(not any(left), f"host_tier {name}: the flood left {left} of turn 1's blocks resident")
        if tier is not None:
            # the tier's copies, each timed on the side stream from its start to its end
            for kind, nbytes, start, end in eng.backend._copies.timings:
                copies[kind].append((start, end, nbytes))
            res["tier"] = tier.snapshot()
        del eng
        torch.cuda.empty_cache()
    for c in range(len(convs)):
        check(runs["host_tier"][c]["turn1"] == runs["never_evicts"][c]["turn1"], "host_tier: turn 1 streams differ")
        check(runs["host_tier"][c]["turn2"] == runs["never_evicts"][c]["turn2"],
              "host_tier: turn 2 after a promote differs from the never-evicting engine's")
    res["launches"] = dict(paged=pa.LAUNCHES, paged_sm90=pa.LAUNCHES_SM90)
    check(pa.LAUNCHES_SM90 == pa.LAUNCHES > 0, f"host_tier: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches "
                                                 "on the Hopper route")
    for way in ("d2h", "h2d"):
        ms = sum(start.elapsed_time(done) for start, done, _n in copies[way])
        nbytes = sum(n for _s, _d, n in copies[way])
        res[way] = dict(copies=len(copies[way]), bytes=nbytes, ms=ms, gb_per_s=nbytes / ms / 1e6 if ms else None)
    res["runs"] = {k: [{f: v for f, v in r.items() if f not in ("turn1", "turn2")} for r in rs]
                   for k, rs in runs.items()}
    res["turn2_ttft_ms"] = {when: {k: rs[c]["turn2_ttft_ms"] for k, rs in runs.items()}
                            for c, when in enumerate(("first_conversation", "second_conversation"))}
    res["turn2_equal_never_evicts"] = True

    # the two turns as a chat over HTTP, on the small pool with the tier
    turn1, flood, more = convs[0]
    eng = InferenceEngine(model, **configs["host_tier"])
    server = serving.ServingServer(eng, registry=serving.MetricsRegistry(),
                                   scheduler_config=serving.SchedulerConfig(max_inflight=32, default_timeout_s=600))
    port = server.start_in_thread()
    try:
        status, chat1 = http_json(port, "POST", "/v1/chat/completions",
                                  {"messages": [{"role": "user", "content": turn1.tolist()}], "max_tokens": 32})
        check(status == 200 and chat1["choices"][0]["finish_reason"] == "length", f"host_tier: chat turn 1 {status}")
        reply = chat1["choices"][0]["message"]["token_ids"]
        threads = [threading.Thread(target=http_json, args=(port, "POST", "/v1/completions",
                                                            {"prompt": p.tolist(), "max_tokens": 32}))
                   for p in flood]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(all(not t.is_alive() for t in threads), "host_tier: a flood client never finished")
        turn2 = [{"role": "user", "content": turn1.tolist()}, {"role": "assistant", "content": reply},
                 {"role": "user", "content": more.tolist()}]
        toks2, finish2, usage2, _ = http_stream(port, "/v1/chat/completions", {"messages": turn2, "max_tokens": 32})
        check(finish2 == "length" and len(toks2) == 32, f"host_tier: chat turn 2 ended {finish2}")
        turn1_len = chat1["usage"]["prompt_tokens"] + chat1["usage"]["completion_tokens"]
        row = next(r for r in http_json(port, "GET", "/debug/requests")[1]["recent"]
                   if r["prompt_len"] == usage2["prompt_tokens"])
        metrics = http_call(port, "GET", "/metrics")[1].decode()
        promotes = sum(float(ln.rsplit(" ", 1)[1]) for ln in metrics.splitlines()
                       if ln.startswith("paddlenlp_serving_kv_host_promotes_total"))
        res["chat"] = dict(turn1_tokens=turn1_len, turn2_prompt=usage2["prompt_tokens"],
                           turn2_cached=usage2["cached_tokens"], promote_wait_ms=row["attribution"]["promote_wait"] * 1e3,
                           attribution_ms={k: v * 1e3 for k, v in row["attribution"].items()},
                           kv_host_promotes_total=promotes)
        # every full block of turn 1 (all but the reply's last token, sampled
        # and never fed) comes back from the host tier
        check(usage2["cached_tokens"] == (turn1_len - 1) // bs * bs,
              f"host_tier: chat turn 2 cached {usage2['cached_tokens']} of turn 1's {turn1_len} tokens")
        check(promotes >= (turn1_len - 1) // bs, f"host_tier: /metrics counts {promotes} promoted blocks")
        check(row["attribution"]["promote_wait"] > 0, "host_tier: no promote_wait in turn 2's attribution")
    finally:
        server.shutdown(drain_timeout_s=120)
    check(not server.loop.running, "host_tier: the loop did not stop")
    mgr = server.loop.engine.mgr
    check(not mgr.tables and mgr.num_free == mgr.total_usable_blocks, "host_tier: chat blocks leaked")
    res["launches_chat"] = dict(paged=pa.LAUNCHES - res["launches"]["paged"],
                                paged_sm90=pa.LAUNCHES_SM90 - res["launches"]["paged_sm90"])
    res["launches"] = dict(paged=pa.LAUNCHES, paged_sm90=pa.LAUNCHES_SM90)
    check(pa.LAUNCHES_SM90 == pa.LAUNCHES, f"host_tier: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches on the "
                                           "Hopper route")
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    emit(res)
    del server, eng
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- quantized KV pool
# (kv_cache_quant, prefill_chunk_tokens) of the kv_quant phase's engine runs
KV_QUANT_RUNS = [("int8", None), ("int8", 512), ("fp8", None)]


def phase_kv_quant(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                   bf16_profile, seed):
    """The engine over an int8 or fp8 pool at Qwen2-7B (``kv_cache_quant``,
    the reference's ``cachekv_int8``).

    (a) Logits: one 1024-token request and 16 decode steps, in bf16 on the
    kernel path, in bf16 on the plain gather path (which the caller turns on
    here to compare) fed the same tokens, and in fp32 on the kernel path
    (the SIMT kernel, the precise check), each over a fresh pool of the same
    kind; the two bf16 paths at min cosine >= 0.99, and the largest
    distance of each from the fp32 logits, ``e_kernel`` and ``e_plain``.

    (b) The engine phase's 8 requests and waves on ``SERVE_ENGINE``, on the
    kernel path (every paged launch on the Hopper kernel's quantized entry)
    and on the plain gather path. The two paths are two functions, as in the
    JAX package: the kernel dequantizes K and V in fp32, the gather path
    rounds them to bf16, and on random weights the logits of the 152,064
    tokens lie within a few tenths of each other. A greedy stream may
    therefore leave the other path's at a near tie. At the first divergence
    the two tokens' logits come from the fp32 kernel path over the common
    prefix; each bf16 path's pick is ``e`` from the fp32 logits at most, so
    the fp32 margin between the two picks is at most ``2 * max(e_kernel,
    e_plain)`` (the gate, from this run's (a)); the bf16 rounding gate
    ``2**-7 * |logit| + 1e-3`` is printed beside it. The same engine over a
    bf16 pool serves the same requests first, for the time and memory
    beside the quantized runs' and the streams they are held to, printed:
    quantization changes the function.

    (c) One profiled decode call over an int8 pool against the bf16 one."""
    t_phase = time.perf_counter()
    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    vocab = model.config.vocab_size
    res = dict(phase="kv_quant", config="Qwen/Qwen2-7B", engine=SERVE_ENGINE, logits={}, runs=[])
    total = dict(paged=0, sm90_quant=0)

    def logits(ids, quant, dtype, n_decode=0, feed=None, kernel=True):
        return paged_logits(torch, model, PagedInferenceModel, init_paged_pool, ids, dtype, n_decode, feed=feed,
                            quant=quant, kernel=kernel)

    # (a) the logits of the three paths over the same tokens
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, vocab, 1024).tolist()
    for quant in ("int8", "fp8"):
        pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
        got, fed = logits(prompt, quant, torch.bfloat16, 16)
        launches = dict(paged=pa.LAUNCHES, sm90_quant=pa.LAUNCHES_SM90_QUANT)
        plain, _ = logits(prompt, quant, torch.bfloat16, 16, feed=fed, kernel=False)
        launches["plain_path"] = pa.LAUNCHES - launches["paged"]
        precise, _ = logits(prompt, quant, torch.float32, 16, feed=fed)
        res["logits"][quant] = dict(positions=got.shape[0], finite=torch.isfinite(got).all().item(),
                                    min_cosine=torch.nn.functional.cosine_similarity(got, plain, dim=-1).min().item(),
                                    max_abs_err=(got - plain).abs().max().item(),
                                    plain_max_abs=plain.abs().max().item(),
                                    top1_agree=(got.argmax(-1) == plain.argmax(-1)).float().mean().item(),
                                    e_kernel=(got - precise).abs().max().item(),
                                    e_plain=(plain - precise).abs().max().item(),
                                    top1_agree_fp32={k: (x.argmax(-1) == precise.argmax(-1)).float().mean().item()
                                                     for k, x in (("kernel", got), ("plain", plain))},
                                    launches=launches)
        for k in total:
            total[k] += launches[k]
        del got, plain, precise

    def sp(i):
        if i in sampled:
            return SamplingParams(max_new_tokens=64, do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
        return SamplingParams(max_new_tokens=64)

    def serve(quant, chunk, kernel=True):
        eng = InferenceEngine(model, **SERVE_ENGINE, kv_cache_quant=quant, prefill_chunk_tokens=chunk)
        check(eng.infer.use_paged_kernel, "kv_quant: the engine on CUDA must run the kernel path")
        eng.infer.use_paged_kernel = kernel
        torch.cuda.reset_peak_memory_stats()
        pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
        done, wall = serve_waves(torch, eng, prompts, sp, [[0], range(1, len(prompts))])
        launches = dict(paged=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90, sm90_quant=pa.LAUNCHES_SM90_QUANT)
        stats = eng.stats()["prefix_cache"]
        what = f"kv_quant {quant or 'bf16'} {'chunked' if chunk else 'monolithic'} {'kernel' if kernel else 'plain'}"
        check(len(done) == len(prompts), f"{what}: {len(done)} of {len(prompts)} requests finished")
        for i, r in done.items():
            check(r.finish_reason in ("length", "stop"), f"{what}: request {i} ended {r.finish_reason}")
            check(r.finish_reason == "stop" or len(r.output_ids) == 64, f"{what}: request {i} short")
            check(all(0 <= t < vocab for t in r.output_ids), f"{what}: request {i} emitted out-of-vocab ids")
        check(stats["hits"] > 0, f"{what}: no prefix-cache hit")
        check(eng.ledger.verify_conservation(), f"{what}: goodput ledger conservation broken")
        if kernel:
            on_route = launches["sm90_quant"] if quant else launches["sm90"] - launches["sm90_quant"]
            check(launches["paged"] > 0 and on_route == launches["sm90"] == launches["paged"],
                  f"{what}: {launches} -- every paged launch must take the Hopper kernel's "
                  f"{'quantized' if quant else 'bf16'} entry")
        else:
            check(launches["paged"] == 0, f"{what}: the plain path launched {launches}")
        pool_bytes = sum(t.numel() * t.element_size() for t in (eng.pool.kv, eng.pool.scale) if t is not None)
        run = dict(latency(done, wall), launches=launches, prefix_cache_hits=stats["hits"],
                   prefix_cached_tokens=stats["cached_tokens"], ledger=eng.ledger.snapshot()["totals"],
                   conservation=True, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, pool_bytes=pool_bytes)
        del eng
        torch.cuda.empty_cache()
        return {i: list(r.output_ids) for i, r in done.items()}, run

    # (b) the engine runs; the fp32 logits of a common prefix are shared by runs that reach it
    bf16_streams, res["bf16_pool"] = serve(None, None)
    fp32_rows = {}
    for quant, chunk in KV_QUANT_RUNS:
        streams, run = serve(quant, chunk)
        for k in total:
            total[k] += run["launches"][k]
        plain, plain_run = serve(quant, chunk, False)

        def fp32_logits(ids, quant=quant):
            key = (quant, tuple(ids))
            if key not in fp32_rows:
                fp32_rows[key] = logits(ids, quant, torch.float32)[0][-1]
            return fp32_rows[key]

        e = res["logits"][quant]
        gate = 2 * max(e["e_kernel"], e["e_plain"])
        diverged = {}
        for i in greedy:
            d = divergence(torch, model, prompts[i], streams[i], plain[i], fp32_logits)
            if d is not None:
                d.update(within_bf16_gate=d.pop("within_gate"), bf16_gate=d.pop("gate"), gate=gate,
                         within_gate=d["margin"] <= gate)
                diverged[i] = d
        # quantization changes the function: agreement with the bf16 pool, printed
        agree = {i: next((j for j, (a, b) in enumerate(zip(streams[i], bf16_streams[i])) if a != b),
                         len(streams[i])) for i in streams}
        res["runs"].append(dict(
            kv_cache_quant=quant, prefill="chunked" if chunk else "monolithic", chunk_tokens=chunk or 0,
            kernel=run, plain=plain_run,
            greedy_vs_plain=dict(equal=len(greedy) - len(diverged), of=len(greedy), gate=gate, diverged=diverged),
            sampled_equal_plain=sum(streams[i] == plain[i] for i in sampled),
            tokens_equal_bf16_pool_before_first_difference=agree))
    del fp32_rows
    res["launches"] = total
    # (c)
    prof = phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed, quant="int8")
    res["decode_profile"] = {f"{pool}_{k}": p[k] for pool, p in (("int8", prof), ("bf16", bf16_profile))
                             for k in ("attention_kernel_ms", "attention_launches", "attention_launch_ms",
                                       "attention_launch_bound_ms", "device_ms", "wall_ms")}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    # the gates, once everything above is printed
    for quant, lg in res["logits"].items():
        per_run = lg["positions"] * model.config.num_hidden_layers
        check(lg["launches"] == dict(paged=per_run, sm90_quant=per_run, plain_path=0),
              f"kv_quant logits {quant}: launches {lg['launches']}, want {per_run} on the quantized Hopper entry "
              "and none on the plain path")
        check(lg["finite"], f"kv_quant logits {quant}: non-finite")
        check(lg["min_cosine"] >= 0.99, f"kv_quant logits {quant}: kernel vs plain path min cosine "
                                        f"{lg['min_cosine']} < 0.99")
    for run in res["runs"]:
        for i, d in run["greedy_vs_plain"]["diverged"].items():
            check(d["within_gate"], f"kv_quant {run['kv_cache_quant']} {run['prefill']}: request {i} leaves the "
                                    f"plain path's stream at {d['position']}, an fp32 margin outside "
                                    f"2 max(e_kernel, e_plain): {d}")
    return res


# ----------------------------------------------------------------------------- lora
LORA_RANK = 16  # the pool's max_rank; one random adapter has rank 8
LORA_POOL_SLOTS = 4
LORA_NEW = 32  # new tokens a request of the mixed batch
LORA_MIX = ("ad-0", "ad-1", "ad-2", None) * 2  # the adapter of request i of the engine phase's traffic


class uncounted:
    """Leaves the paged kernel's launch counts as they were: launches made
    to check a result are not the main path's."""

    def __init__(self, pa):
        self.pa = pa

    def __enter__(self):
        self.saved = (self.pa.LAUNCHES, self.pa.LAUNCHES_SM90, self.pa.LAUNCHES_SM90_QUANT)

    def __exit__(self, *exc):
        self.pa.LAUNCHES, self.pa.LAUNCHES_SM90, self.pa.LAUNCHES_SM90_QUANT = self.saved


def lora_weights(torch, cfg, dims, seed, rank, b_std):
    """One random adapter on all seven projections, drawn on the card:
    A ~ N(0, 1)/sqrt(d_in) (LoRA's init) and B ~ N(0, b_std^2)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    L = cfg.num_hidden_layers
    out = {}
    for proj, (d_in, d_out) in dims.items():
        a = torch.randn((L, d_in, rank), generator=gen, device=DEVICE) / math.sqrt(d_in)
        b = torch.randn((L, rank, d_out), generator=gen, device=DEVICE) * b_std
        out[proj] = {"A": a.cpu().numpy(), "B": b.cpu().numpy()}
    return out


def lora_profile(torch, np, model, pa, InferenceEngine, SamplingParams, reg, seed, adapters):
    """``torch.profiler`` over one steady decode call of the engine phase's 8
    requests (each on ``adapters[i]``): device ms, idle share, the paged
    kernel's ms, and the device ms of the ops only the LoRA delta runs
    (``aten::bmm``, ``aten::index_select``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts, _ = traffic(np, model.config.vocab_size, seed)
    eng = InferenceEngine(model, adapter_registry=reg, **SERVE_ENGINE)
    for i, p in enumerate(prompts):
        eng.add_request(p, SamplingParams(max_new_tokens=1 + 2 * eng.decode_steps), adapter_id=adapters[i])
    eng.step()  # admission: prefill + the first decode call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    attn_ms = sum(e.self_device_time_total for e in kernels if "paged_attention" in e.key) / 1e3
    ops = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    op_ms = {k: (ops[k].device_time_total / 1e3 if k in ops else 0.0, ops[k].count if k in ops else 0)
             for k in ("aten::bmm", "aten::index_select")}
    del eng
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
                attention_kernel_ms=attn_ms, bmm_ms=op_ms["aten::bmm"][0], bmm_calls=op_ms["aten::bmm"][1],
                gather_ms=op_ms["aten::index_select"][0], gather_calls=op_ms["aten::index_select"][1],
                kernel_launches=sum(e.count for e in kernels))


def lora_rows_independent(torch, np, cfg, infer, init_paged_pool, lora_dev, slots, rng):
    """Step (2) of the lora phase: 8 rows of 256 tokens prefilled over a
    fresh pool, then one [8, 1] decode forward twice, row 0 on the same
    adapter slot both times and rows 1-7 on other ones the second time."""
    from paddlenlp_tpu_torch.experimental.inference_model import gather_lora

    B, T, bs = 8, 256, 16
    nb = (T + 1) // bs + 1
    pool = init_paged_pool(cfg, B * nb + 1, bs, dtype=torch.bfloat16, device=DEVICE)
    tables = torch.arange(1, B * nb + 1, dtype=torch.int32, device=DEVICE).reshape(B, nb)
    S = nb * bs
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=DEVICE)  # noqa: E731
    ids = torch.tensor(rng.integers(0, cfg.vocab_size, (B, T)), dtype=torch.int32, device=DEVICE)
    first = [slots[j % len(slots)] for j in range(B)]
    infer._forward(pool, ids, tables, torch.arange(T, device=DEVICE)[None].expand(B, T),
                   torch.arange(S, device=DEVICE)[None] < T, i32([0] * B), i32([T - 1] * B), q_lens=i32([T] * B),
                   lora_rows=gather_lora(lora_dev, i32(first)))
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)), dtype=torch.int32, device=DEVICE)
    outs = [infer._forward(pool, tok, tables, i32([[T]] * B), torch.arange(S, device=DEVICE)[None] <= T,
                           i32([T] * B), i32([0] * B), lora_rows=gather_lora(lora_dev, i32(table))).float()
            for table in (first, [first[0]] + [slots[(j + 1) % len(slots)] for j in range(1, B)])]
    return dict(shape=[B, 1], row0_bitwise=bool(torch.equal(outs[0][0], outs[1][0])),
                others_changed=int(sum(not torch.equal(outs[0][j], outs[1][j]) for j in range(1, B))))


def phase_lora(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
               serving, LoRAModel, LoRAConfig, tenancy, seed):
    """Multi-LoRA serving at Qwen2-7B: an ``AdapterRegistry`` (max rank 16,
    4 pool slots, fp32) holding three random adapters (ranks 16, 16, 8) and
    one exported by a ``LoRAModel`` over the same model, on the engine
    settings of the serve phase (8 slots, block 16, 2048 blocks, 8 decode
    steps a call). (1) The engine phase's 8 prompts, two on each random
    adapter and two on the base model, greedy and then seeded sampling,
    against each request alone on an engine of its own; (2) one [8, 1]
    decode forward twice over the same pool, row 0 on the same adapter and
    the other rows on others: row 0's logits bit for bit; (3) one prompt on
    each adapter and on the base model: five different greedy streams; (4)
    a 1024-token request's logits and 16 decode steps through the
    ``LoRAModel``'s adapter against the model of ``merge_and_unload()``
    without one; (5) five adapters over four slots with one pinned by a long
    request; (6) the same over HTTP through ``ServingServer``:
    ``/admin/adapters`` load / list / unload, JSON and SSE completions on an
    adapter, an unknown adapter, a tenant over its ``kv_block_share``
    deferred while another admits, tenant- and adapter-labelled
    ``/metrics``; (7) the mix's TTFT/TPOT and tokens/s with adapters and on
    the base model, a profiled decode call of each, and the device pool's
    re-place times. Every paged launch takes the Hopper route."""
    import copy
    import os

    from paddlenlp_tpu_torch.experimental.inference_model import _gumbel_rows
    from paddlenlp_tpu_torch.observability.flight_recorder import RECORDER
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    t_phase = time.perf_counter()
    cfg = model.config
    vocab, L = cfg.vocab_size, cfg.num_hidden_layers
    dims = tenancy.adapter_dims_from_config(cfg)
    res = dict(phase="lora", config="Qwen/Qwen2-7B", engine=dict(SERVE_ENGINE), max_rank=LORA_RANK,
               pool_slots=LORA_POOL_SLOTS)
    torch.cuda.synchronize()
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0

    # ---- set-up: three random adapters and one from a LoRAModel, exported to a file
    t0 = time.perf_counter()
    reg = tenancy.AdapterRegistry(cfg, max_rank=LORA_RANK, pool_slots=LORA_POOL_SLOTS)
    for i, rank in enumerate((16, 16, 8)):
        reg.add(f"ad-{i}", lora_weights(torch, cfg, dims, seed + 200 + i, rank, 0.05))
    lm = LoRAModel(copy.copy(model), LoRAConfig(r=LORA_RANK, lora_alpha=2 * LORA_RANK))  # scaling 2
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 210)
    with torch.no_grad():
        for leaf in [v for k, v in flatten_params(lm.params).items() if k.endswith("lora_B")]:
            leaf.normal_(0.0, 0.025, generator=gen)  # a trained adapter's B is not zero
    workdir = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    exported = os.path.join(workdir, "lora.safetensors")
    lm.export_adapter(exported)
    reg.add("lora", exported)
    pool_bytes = sum(a.nbytes for w in reg._pool.values() for a in w.values())
    want_bytes = (LORA_POOL_SLOTS + 1) * L * LORA_RANK * sum(d_in + d_out for d_in, d_out in dims.values()) * 4
    res["setup"] = dict(adapters=reg.ids(), ranks={a: reg._store[a].rank for a in reg.ids()},
                        pool_bytes=pool_bytes, exported_bytes=os.path.getsize(exported),
                        seconds=time.perf_counter() - t0)
    check(pool_bytes == want_bytes, f"lora: adapter pool of {pool_bytes} bytes, want {want_bytes}")

    prompts, _ = traffic(np, vocab, seed)
    greedy_sp = lambda i: SamplingParams(max_new_tokens=LORA_NEW)  # noqa: E731
    temp = 0.8
    sampled_sp = lambda i: SamplingParams(max_new_tokens=LORA_NEW, do_sample=True, temperature=temp,  # noqa: E731
                                          seed=20 + i)

    def fresh(**kw):
        eng = InferenceEngine(model, adapter_registry=reg, **dict(SERVE_ENGINE, **kw))
        check(eng.infer.use_paged_kernel, "lora: the engine on CUDA must run the kernel path")
        return eng

    def fp32_of(adapter_id):
        """The fp32 logits of the function a stream on ``adapter_id`` computes:
        the paged fp32 forward with the adapter's delta (SIMT kernel)."""
        slot = 0 if adapter_id is None else reg.slot_of(adapter_id)

        def logits(ids):
            with uncounted(pa):
                return paged_logits(torch, model, PagedInferenceModel, init_paged_pool, ids, torch.float32, 0,
                                    lora=probe.backend._lora_tree(), adapter=slot)[0][0]
        return logits

    def gumbel(sp):
        return lambda pos: sp.temperature * _gumbel_rows(torch.tensor([sp.seed], device=DEVICE),
                                                          torch.tensor([pos], device=DEVICE), vocab)[0]

    # ---- (1) the mix, greedy and sampled, against each request alone
    mix = {}
    gates = []  # the stream gates, checked once everything is printed
    solo_eng = fresh()
    probe = solo_eng  # whose backend holds the device pool the fp32 references read
    for kind, sp_of in (("greedy", greedy_sp), ("sampled", sampled_sp)):
        eng = fresh()
        done, wall = serve_waves(torch, eng, prompts, sp_of, [range(8)], adapter_of=LORA_MIX.__getitem__)
        check(eng.ledger.verify_conservation(), f"lora {kind}: goodput ledger conservation broken")
        del eng
        solo = {}
        for i in range(8):
            solo_eng.clear_prefix_cache()
            solo[i] = serve_waves(torch, solo_eng, prompts, sp_of, [[i]], adapter_of=LORA_MIX.__getitem__)[0][i]
        # every reference registered: the fp32 forwards below need each adapter resident
        for aid in ("ad-0", "ad-1", "ad-2"):
            reg.acquire(aid)
        diverged = {}
        for i in range(8):
            d = divergence(torch, model, prompts[i], done[i].output_ids, solo[i].output_ids,
                           fp32_logits=fp32_of(LORA_MIX[i]),
                           noise=gumbel(sp_of(i)) if kind == "sampled" else None)
            if d is not None:
                diverged[i] = d
        for aid in ("ad-0", "ad-1", "ad-2"):
            reg.release(aid)
        mix[kind] = dict(latency(done, wall), equal=8 - len(diverged), of=8, diverged=diverged,
                         finish=sorted({r.finish_reason for r in done.values()}))
        for i, r in done.items():
            check(r.finish_reason in ("length", "stop"), f"lora {kind}: request {i} ended {r.finish_reason}")
            check(all(0 <= t < vocab for t in r.output_ids), f"lora {kind}: request {i} emitted out-of-vocab ids")
        gates += [(d["within_gate"], f"lora {kind}: request {i} ({LORA_MIX[i]}) leaves its solo stream at "
                                     f"{d['position']} outside the bf16 gate: {d}") for i, d in diverged.items()]
    base_eng = fresh()
    done, wall = serve_waves(torch, base_eng, prompts, greedy_sp, [range(8)])
    mix["base_greedy"] = latency(done, wall)
    del base_eng
    res["mix"] = mix

    # ---- (2) row independence at a fixed [8, 1] shape
    infer, backend = solo_eng.infer, solo_eng.backend
    for aid in ("ad-0", "ad-1", "ad-2", "lora"):
        reg.acquire(aid)
    slots = [reg.slot_of(a) for a in ("ad-0", "ad-1", "ad-2", "lora")]
    lora_dev = backend._lora_tree()
    rng = np.random.default_rng(seed + 220)
    with uncounted(pa):  # a check's launches, not the main path's
        res["row_independence"] = lora_rows_independent(torch, np, cfg, infer, init_paged_pool, lora_dev, slots, rng)
    check(res["row_independence"]["row0_bitwise"], "lora: row 0's logits changed with the other rows' adapters")
    check(res["row_independence"]["others_changed"] == 7, "lora: another adapter left a row's logits as they were")

    # ---- (3) steering: one prompt on each adapter and on the base model
    steer_prompt = prompts[1]
    ads = ("ad-0", "ad-1", "ad-2", "lora", None)
    eng = fresh()
    done, _ = serve_waves(torch, eng, [steer_prompt] * 5, lambda i: SamplingParams(max_new_tokens=16), [range(5)],
                          adapter_of=ads.__getitem__)
    del eng
    streams = [tuple(done[i].output_ids) for i in range(5)]
    res["steering"] = dict(adapters=[a or "base" for a in ads], distinct_streams=len(set(streams)),
                           first_tokens=[s[0] for s in streams])
    check(len(set(streams)) == 5, f"lora: {len(set(streams))} distinct greedy streams of 5 adapters incl. base")

    # ---- (4) the LoRAModel's adapter against merge_and_unload()'s model
    prompt = rng.integers(0, vocab, 1024).tolist()
    with uncounted(pa):
        got, fed = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, torch.bfloat16, 16,
                                lora=lora_dev, adapter=reg.slot_of("lora"))
        merged = lm.merge_and_unload()
        ref, _ = paged_logits(torch, merged, PagedInferenceModel, init_paged_pool, prompt, torch.bfloat16, 16,
                              feed=fed)
    del merged, lm
    torch.cuda.empty_cache()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
    res["merged"] = dict(positions=17, min_cosine=cos, max_abs_diff=(got - ref).abs().max().item(),
                         ref_max_abs=ref.abs().max().item(),
                         top1_agree=(got.argmax(-1) == ref.argmax(-1)).float().mean().item())
    check(torch.isfinite(got).all().item() and torch.isfinite(ref).all().item(), "lora merged: non-finite logits")
    check(cos >= 0.99, f"lora merged: unmerged vs merged min cosine {cos} < 0.99")

    # ---- (7, part) the device pool's re-place times: all slots, then one slot after a load
    for aid in ("ad-0", "ad-1", "ad-2", "lora"):
        reg.release(aid)
    torch.cuda.synchronize()
    backend._lora_dev = backend._lora_version = None
    t0 = time.perf_counter()
    backend._lora_tree()
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    reg.add("ad-3", lora_weights(torch, cfg, dims, seed + 203, 16, 0.05))
    reg.acquire("ad-3")  # evicts the LRU adapter: one slot written
    t0 = time.perf_counter()
    backend._lora_tree()
    torch.cuda.synchronize()
    slot_ms = (time.perf_counter() - t0) * 1e3
    reg.release("ad-3")
    equal = all(torch.equal(t.cpu(), torch.from_numpy(reg._pool[p][k])) for p, w in backend._lora_dev.items()
                for k, t in w.items())
    res["replace"] = dict(full_pool_ms=full_ms, one_slot_ms=slot_ms, full_pool_bytes=pool_bytes,
                          slot_bytes=pool_bytes // (LORA_POOL_SLOTS + 1), device_equals_host=equal)
    check(equal, "lora: the device adapter pool differs from the host pool")
    del solo_eng, backend, infer, lora_dev

    # ---- (5) pool pressure: five adapters over four slots, ad-0 pinned by a long request
    RECORDER.clear()
    ev0 = reg.stats()["evictions"]
    eng = fresh()
    pinned_sp = lambda i: SamplingParams(max_new_tokens=96 if i == 1 else 16)  # noqa: E731
    press = {1: "ad-0", 3: "ad-1", 5: "ad-2", 7: "lora", 2: "ad-3"}
    done, _ = serve_waves(torch, eng, prompts, pinned_sp, [list(press)], adapter_of=press.__getitem__)
    del eng
    defers = [e.get("reason") for e in RECORDER.to_dicts(RECORDER.snapshot()) if e["name"] == "admit.defer"]
    solo_eng = fresh()
    want = serve_waves(torch, solo_eng, prompts, pinned_sp, [[1]], adapter_of=press.__getitem__)[0][1]
    probe = solo_eng
    reg.acquire("ad-0")
    d = divergence(torch, model, prompts[1], done[1].output_ids, want.output_ids, fp32_logits=fp32_of("ad-0"))
    reg.release("ad-0")
    del solo_eng
    st = reg.stats()
    res["pressure"] = dict(adapters=len(press), pool_slots=LORA_POOL_SLOTS, evictions=st["evictions"] - ev0,
                           defer_reasons=sorted(set(defers)), pinned_tokens=len(done[1].output_ids),
                           pinned_equal_solo=d is None, pinned_divergence=d, stats=st)
    check("adapter_pressure" in defers, f"lora pressure: no admit.defer reason=adapter_pressure ({defers})")
    check(st["evictions"] > ev0, "lora pressure: no eviction")
    check(st["pinned"] == 0 and st["free_slots"] + st["resident"] == st["pool_slots"], f"lora pressure: slot leak {st}")
    gates.append((d is None or d["within_gate"], f"lora pressure: the pinned stream leaves its solo stream: {d}"))
    check(all(r.finish_reason == "length" for r in done.values()), "lora pressure: a request did not finish")

    # ---- (6) over HTTP
    res["http"] = lora_http(torch, np, model, InferenceEngine, SamplingParams, serving, tenancy, reg, exported,
                            RECORDER)

    # ---- (7) profiles of one decode call, with adapters and on the base model
    res["profile"] = {"adapters": lora_profile(torch, np, model, pa, InferenceEngine, SamplingParams, reg, seed,
                                               LORA_MIX),
                      "base": lora_profile(torch, np, model, pa, InferenceEngine, SamplingParams, reg, seed,
                                           (None,) * 8)}
    pf = res["profile"]
    res["profile"]["delta_device_ms"] = pf["adapters"]["device_ms"] - pf["base"]["device_ms"]
    res["launches"] = dict(paged=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
    res["sm90_launches"] = pa.LAUNCHES_SM90
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    shutil.rmtree(workdir, ignore_errors=True)
    check(pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
          f"lora: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches on the Hopper route")
    for ok, msg in gates:
        check(ok, msg)
    return res


def lora_http(torch, np, model, InferenceEngine, SamplingParams, serving, tenancy, reg, exported, recorder):
    """(6) of the lora phase: ``ServingServer`` over an engine with the
    registry, tenant "capped" held to 5% of the KV blocks."""
    vocab = model.config.vocab_size
    rng = np.random.default_rng(7)
    p_json, p_sse = rng.integers(0, vocab, 384).tolist(), rng.integers(0, vocab, 320).tolist()
    # in-process references on an engine of their own, each prompt alone
    ref = InferenceEngine(model, adapter_registry=reg, **SERVE_ENGINE)
    want = serve_waves(torch, ref, [p_json, p_sse], lambda i: SamplingParams(max_new_tokens=16), [[0], [1]],
                       adapter_of=lambda i: "lora")[0]
    del ref
    quotas = tenancy.TenantQuotas({"capped": {"kv_block_share": 0.05}})
    eng = InferenceEngine(model, adapter_registry=reg, tenant_quotas=quotas, **SERVE_ENGINE)
    server = serving.ServingServer(eng, registry=serving.MetricsRegistry(), tenant_quotas=quotas,
                                   scheduler_config=serving.SchedulerConfig(max_inflight=32, default_timeout_s=600))
    port = server.start_in_thread()
    out = {}
    try:
        status, doc = http_json(port, "POST", "/admin/adapters",
                                {"op": "load", "adapter_id": "lora-http", "path": exported})
        check(status == 200 and "lora-http" in doc["adapters"], f"lora http: load answered {status} {doc}")
        out["load"] = dict(status=status, same_digest=doc["digest"] == reg.digest_of("lora"))
        check(out["load"]["same_digest"], "lora http: the loaded file's digest differs from the in-process add's")
        status, doc = http_json(port, "POST", "/admin/adapters", {"op": "list"})
        out["list"] = dict(status=status, adapters=doc["adapters"], stats=doc["stats"])
        status, body = http_json(port, "POST", "/v1/completions",
                                 {"prompt": p_json, "max_tokens": 16, "adapter_id": "lora-http", "tenant": "acme"})
        check(status == 200, f"lora http: JSON completion answered {status}")
        toks, finish, _, _ = http_stream(port, "/v1/completions", {"prompt": p_sse, "max_tokens": 16,
                                                                  "adapter_id": "lora-http", "tenant": "globex"})
        out["equal_in_process"] = dict(json=body["choices"][0]["token_ids"] == want[0].output_ids,
                                       sse=toks == want[1].output_ids)
        check(all(out["equal_in_process"].values()), f"lora http: streams differ from in-process: {out}")
        status, doc = http_json(port, "POST", "/v1/completions",
                                {"prompt": p_json[:8], "max_tokens": 2, "adapter_id": "nope"})
        out["unknown"] = dict(status=status, type=doc["error"]["type"])
        check(status == 400 and "nope" in doc["error"]["message"], f"lora http: unknown adapter answered {status}")

        # tenant "capped": a running 1024-token request holds 65 of its 102
        # blocks, so a second one (63 more) waits while tenant "other" admits
        cap = quotas.kv_block_cap("capped", eng.mgr.total_usable_blocks)
        recorder.clear()
        started, results = threading.Event(), {}

        def long_stream():
            results["long"] = http_stream(port, "/v1/completions",
                                          {"prompt": rng_long, "max_tokens": 128, "adapter_id": "ad-1",
                                           "tenant": "capped"}, on_token=lambda _cid: started.set())

        def second():
            results["second"] = http_json(port, "POST", "/v1/completions",
                                          {"prompt": rng_second, "max_tokens": 8, "tenant": "capped"})

        rng_long, rng_second = rng.integers(0, vocab, 1024).tolist(), rng.integers(0, vocab, 1000).tolist()
        threads = [threading.Thread(target=long_stream), threading.Thread(target=second)]
        threads[0].start()
        check(started.wait(600), "lora http: the long stream never started")
        threads[1].start()
        deadline = time.time() + 120
        while not any(e["name"] == "admit.defer" and e.get("reason") == "tenant_kv_share"
                      for e in recorder.to_dicts(recorder.snapshot())):
            check(time.time() < deadline, "lora http: the second capped request was never deferred")
            time.sleep(0.01)
        status, _ = http_json(port, "POST", "/v1/completions",
                              {"prompt": rng.integers(0, vocab, 512).tolist(), "max_tokens": 8, "tenant": "other"})
        for t in threads:
            t.join(600)
        accepts = [e["prompt_len"] for e in recorder.to_dicts(recorder.snapshot()) if e["name"] == "admit.accept"]
        out["kv_share"] = dict(cap_blocks=cap, other_status=status, long_tokens=len(results["long"][0]),
                               second_status=results["second"][0], admit_order=accepts)
        check(status == 200 and results["second"][0] == 200 and len(results["long"][0]) == 128,
              f"lora http: kv share run {out['kv_share']}")
        check(accepts.index(512) < accepts.index(1000),
              f"lora http: tenant other did not admit while capped waited: {accepts}")

        text = http_call(port, "GET", "/metrics")[1].decode()
        out["metrics"] = dict(
            tenants=sorted(set(re.findall(r'paddlenlp_serving_requests_total\{[^}]*tenant="([^"]+)"', text))),
            adapters=sorted(set(re.findall(r'paddlenlp_serving_usage_tokens_total\{[^}]*adapter="([^"]+)"', text))))
        check({"acme", "globex", "capped", "other"} <= set(out["metrics"]["tenants"])
              and "lora-http" in out["metrics"]["adapters"], f"lora http: /metrics labels {out['metrics']}")
        status, doc = http_json(port, "POST", "/admin/adapters", {"op": "unload", "adapter_id": "lora-http"})
        out["unload"] = dict(status=status, adapters=doc["adapters"])
        check(status == 200 and "lora-http" not in doc["adapters"], f"lora http: unload answered {status}")
    finally:
        server.shutdown(drain_timeout_s=30)
    st = reg.stats()
    check(st["pinned"] == 0 and st["free_slots"] + st["resident"] == st["pool_slots"], f"lora http: slot leak {st}")
    return out


# ----------------------------------------------------------------------------- wquant
WQUANT_RUNS = ("wint8", "wint4", "fp8", "a8w8", "a8w8_calibrated")
WQUANT_NEW = 32  # new tokens a request of the engine mix
PROJECTIONS = ("self_attn/q_proj", "self_attn/k_proj", "self_attn/v_proj", "self_attn/o_proj", "mlp/gate_proj",
               "mlp/up_proj", "mlp/down_proj")


def same_bits(torch, a, b):
    """Two tensors of one dtype and shape hold the same bits (on any devices)."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def wquant_weight_bytes(model, algo):
    """The bytes a facade's tree must hold, from the base model's shapes:
    each stacked projection kernel [L, in, out] at one byte an element (half
    a byte at wint4) plus fp32 scales [L, out], [L] fp32 activation scales
    at calibrated a8w8, and every other leaf as it is."""
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    total = 0
    for path, t in flatten_params(model.params).items():
        if path.endswith("/kernel") and "/layers/" in path:
            L, d_in, d_out = t.shape
            total += L * d_in * d_out // (2 if algo == "wint4" else 1) + L * d_out * 4
            total += L * 4 if algo == "a8w8_calibrated" else 0
        else:
            total += t.numel() * t.element_size()
    return total


def wquant_card_vs_cpu(torch, model, quantization, seed):
    """(1) of the wquant phase: layer 0's slice of each projection quantized
    on the card and on the CPU (wint8, wint4, fp8), dequantized to bf16 on
    each, and a8w8's ``int8_linear`` at 8 rows (padded to 17 on the card)
    and 2048 rows with the layer's bias: every pair bit for bit."""
    from paddlenlp_tpu_torch.quantization.a8w8 import int8_linear

    QC, qp, deq = quantization.QuantizationConfig, quantization.quantize_params, quantization.dequantize_leaf
    layers = model.params["model"]["layers"]
    g = torch.Generator(device=DEVICE).manual_seed(seed + 300)
    out = {}
    for proj in PROJECTIONS:
        block, name = proj.split("/")
        leaves = layers[block][name]
        w = leaves["kernel"][0]
        bias = leaves["bias"][0] if "bias" in leaves else None
        row = {}
        for algo in ("wint8", "wint4", "fp8"):
            cfg = QC(weight_quantize_algo=algo)
            card, cpu = qp({"p": {"kernel": w}}, cfg)["p"], qp({"p": {"kernel": w.cpu()}}, cfg)["p"]
            row[algo] = dict(
                codes=same_bits(torch, card["qweight"], cpu["qweight"]),
                scales=same_bits(torch, card["scales"], cpu["scales"]),
                dequantized=same_bits(torch, deq(card["qweight"], card["scales"], cfg.bits, torch.bfloat16),
                                      deq(cpu["qweight"], cpu["scales"], cfg.bits, torch.bfloat16)))
        q = qp({"p": {"kernel": w}}, QC(weight_quantize_algo="a8w8"))["p"]
        for m in (8, 2048):
            x = torch.randn((m, w.shape[0]), generator=g, device=DEVICE).to(torch.bfloat16)
            card = int8_linear(x, q["qweight"], q["scales"], bias=bias, out_dtype=torch.bfloat16)
            cpu = int8_linear(x.cpu(), q["qweight"].cpu(), q["scales"].cpu(),
                              bias=None if bias is None else bias.cpu(), out_dtype=torch.bfloat16)
            row[f"int8_linear_m{m}"] = same_bits(torch, card, cpu)
        out[proj] = row
    return out


def wquant_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed):
    """``torch.profiler`` over one steady decode call of the engine phase's 8
    requests on ``model`` (a ``QuantizedModel`` or the bf16 base): device
    ms, idle share, and the device ms of the paged kernel, the dequant
    (``dequantize_leaf``), a8w8's activation quantization
    (``quantize_activations``) and the GEMMs (``aten::mm``, ``aten::_int_mm``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts, _ = traffic(np, model.config.vocab_size, seed)
    eng = InferenceEngine(model, **SERVE_ENGINE)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_new_tokens=1 + 2 * eng.decode_steps))
    eng.step()  # admission: prefill + the first decode call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = {e.key: e for e in avg if e.device_type == DeviceType.CPU}
    op = {k: (ops[k].device_time_total / 1e3 if k in ops else 0.0, ops[k].count if k in ops else 0)
          for k in ("dequantize_leaf", "quantize_activations", "aten::mm", "aten::_int_mm")}
    del eng
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
                attention_kernel_ms=sum(e.self_device_time_total for e in kernels if "paged_attention" in e.key) / 1e3,
                dequant_ms=op["dequantize_leaf"][0], dequant_calls=op["dequantize_leaf"][1],
                act_quant_ms=op["quantize_activations"][0], bf16_gemm_ms=op["aten::mm"][0],
                bf16_gemm_calls=op["aten::mm"][1], int8_gemm_ms=op["aten::_int_mm"][0],
                int8_gemm_calls=op["aten::_int_mm"][1], kernel_launches=sum(e.count for e in kernels))


def wquant_http(eng, serving, SamplingParams, prompts, greedy):
    """(5) of the wquant phase: ``ServingServer`` over the a8w8 engine; two
    greedy prompts, JSON and SSE, each alone on a cleared prefix cache, equal
    to the engine's ``generate`` of the same prompt."""
    want = {}
    for i in greedy:
        eng.clear_prefix_cache()
        want[i] = eng.generate([prompts[i]], SamplingParams(max_new_tokens=WQUANT_NEW))[0]
    eng.clear_prefix_cache()
    server = serving.ServingServer(eng, registry=serving.MetricsRegistry(),
                                   scheduler_config=serving.SchedulerConfig(max_inflight=8, default_timeout_s=600))
    port = server.start_in_thread()
    equal = {}
    try:
        for i in greedy:
            server.loop.engine.clear_prefix_cache()
            status, body = http_json(port, "POST", "/v1/completions",
                                     {"prompt": prompts[i].tolist(), "max_tokens": WQUANT_NEW})
            check(status == 200, f"wquant http: request answered {status}")
            server.loop.engine.clear_prefix_cache()
            toks, _, _, _ = http_stream(port, "/v1/completions", {"prompt": prompts[i].tolist(),
                                                                   "max_tokens": WQUANT_NEW})
            equal[i] = dict(json=body["choices"][0]["token_ids"] == want[i], sse=toks == want[i],
                            tokens=len(want[i]))
    finally:
        server.shutdown(drain_timeout_s=30)
    return dict(prompts=[len(prompts[i]) for i in greedy], equal=equal)


def wquant_generate(torch, np, qm, prompts, done, which):
    """(6) of the wquant phase: ``QuantizedModel.generate`` over prompts
    ``which``, left-padded, ``WQUANT_NEW`` new tokens, against the same
    facade's engine greedy streams (``done``): equal, or parted only where
    the two tokens' fp32 margin under the facade's function is within twice
    its bf16 distance (``depth_divergence``)."""
    ids, mask = left_pad(np, [prompts[i] for i in which])
    out, _, timing = timed_generate(torch, qm, ids, attention_mask=mask, max_new_tokens=WQUANT_NEW)
    eos = qm.config.eos_token_id
    diverged = {}
    for r, i in enumerate(which):
        d = depth_divergence(torch, None, prompts[i], upto_eos(out[r].tolist(), eos), list(done[i].output_ids),
                             fp32_logits=lambda seq: qm(torch.tensor([seq], device=DEVICE), dtype=torch.float32)[0, -1],
                             bf16_logits=lambda seq: qm(torch.tensor([seq], device=DEVICE))[0, -1])
        if d is not None:
            diverged[i] = d
    return dict(prompts=list(which), batch=list(ids.shape), equal_to_engine=len(which) - len(diverged),
                of=len(which), diverged=diverged, **timing)


def phase_wquant(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                 serving, quantization, modeling, seed):
    """Quantized weights at Qwen2-7B (``quantization.QuantizedModel``: wint8,
    wint4, fp8, a8w8 with dynamic and with calibrated activation scales),
    one facade at a time over the bf16 model, freed before the next:

    (1) layer 0's slice of every projection quantized and dequantized on the
    card and on the CPU, and a8w8's ``int8_linear`` at 8 and 2048 rows: bit
    for bit;
    (2) the wint8 and a8w8 facades in fp32 through the paged model on the
    SIMT route against the facade's dense forward, rel 1e-4 (the logits
    phase's gate): eight single-token sequences, whose attention is exact on
    both (``single_token_logits``), for both; a 1024-token prompt and 16
    decode steps for wint8. a8w8 rounds each activation to an int8 code, so
    over a long context the two attentions' fp32 summation orders move
    codes across rounding midpoints; its long-prompt error and each layer's
    error fed the dense layer input (``paged_layer_errors``) are printed,
    not gated;
    (3) the engine phase's 8 requests (32 new tokens, monolithic prefill) on
    each facade and on the bf16 model: TTFT/TPOT p50, tokens/s,
    ``memory_footprint()`` against the bytes the shapes give,
    ``torch.cuda.memory_allocated()``, every paged launch on the Hopper
    route, and the logits of a 1024-token prompt and 16 decode steps fed
    the bf16 model's tokens against the bf16 model's (cosine, top-1);
    (4) one profiled decode call on the bf16 model, wint8 and a8w8: the
    dequant's, the GEMMs' and attention's device ms, the idle share;
    (5) ``ServingServer`` over the a8w8 engine: greedy JSON and SSE streams
    equal to ``generate``;
    (6) the wint8 facade's dense ``generate`` on 2 of the greedy prompts
    (``wquant_generate``) against its engine's streams.

    Quality against bf16 is printed, not gated (random weights)."""
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    t_phase = time.perf_counter()
    QC, QM = quantization.QuantizationConfig, quantization.QuantizedModel
    vocab = model.config.vocab_size
    prompts, sampled = traffic(np, vocab, seed)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    rng = np.random.default_rng(seed + 3)
    probe = rng.integers(0, vocab, 1024).tolist()
    res = dict(phase="wquant", config="Qwen/Qwen2-7B", engine=dict(SERVE_ENGINE), new_tokens=WQUANT_NEW,
               base_bytes=sum(t.numel() * t.element_size() for t in flatten_params(model.params).values()))
    gates = []

    def sp(i):
        if i in sampled:
            return SamplingParams(max_new_tokens=WQUANT_NEW, do_sample=True, temperature=0.8, top_p=0.9, seed=10 + i)
        return SamplingParams(max_new_tokens=WQUANT_NEW)

    # ---- (1) card vs CPU
    t0 = time.perf_counter()
    res["card_vs_cpu"] = wquant_card_vs_cpu(torch, model, quantization, seed)
    res["card_vs_cpu_s"] = time.perf_counter() - t0
    for proj, row in res["card_vs_cpu"].items():
        for what, ok in row.items():
            gates.append((all(ok.values()) if isinstance(ok, dict) else ok,
                          f"wquant card vs cpu: {proj} {what} differs: {ok}"))

    # ---- calibration: two prompts through the bf16 dense forward
    calib = [{"input_ids": rng.integers(0, vocab, (1, n))} for n in (256, 512)]
    t0 = time.perf_counter()
    act_scales = quantization.collect_act_scales(model, calib)
    res["calibration"] = dict(prompts=[256, 512], scales=len(act_scales), seconds=time.perf_counter() - t0)

    def facade(run):
        algo = run.split("_")[0]
        return QM(model, QC(weight_quantize_algo=algo), act_scales=act_scales if run == "a8w8_calibrated" else None)

    # ---- (2) the dispatch in fp32
    single = probe[:8]
    res["fp32_dispatch"] = {}
    for run in ("wint8", "a8w8"):
        qm = facade(run)
        with uncounted(pa):
            pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
            got, fed = paged_logits(torch, qm, PagedInferenceModel, init_paged_pool, probe, torch.float32, 16)
            one = single_token_logits(torch, qm, PagedInferenceModel, init_paged_pool, single, torch.float32)
            simt = pa.LAUNCHES - pa.LAUNCHES_SM90
            layers = paged_layer_errors(torch, modeling, qm, PagedInferenceModel, init_paged_pool, probe)
        ref = qm(torch.tensor([fed], device=DEVICE), dtype=torch.float32)[0, len(probe) - 1:]
        ref_one = qm(torch.tensor(single, device=DEVICE)[:, None], dtype=torch.float32)[:, 0]
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        err_one = (one - ref_one).abs().max().item() / ref_one.abs().max().item()
        res["fp32_dispatch"][run] = dict(
            positions=got.shape[0], rel_err=err, rel_tol=LOGITS_REL_TOL, gated=run == "wint8",
            single_token=dict(sequences=len(single), rel_err=err_one), layer_by_layer=layers, simt_launches=simt)
        gates.append((err_one <= LOGITS_REL_TOL,
                      f"wquant fp32 dispatch {run}: single-token paged vs dense rel err {err_one} > {LOGITS_REL_TOL}"))
        if run == "wint8":
            gates.append((err <= LOGITS_REL_TOL,
                           f"wquant fp32 dispatch {run}: paged vs dense rel err {err} > {LOGITS_REL_TOL}"))
        gates.append((simt == (got.shape[0] + 1) * model.config.num_hidden_layers,
                      f"wquant fp32 dispatch {run}: {simt} SIMT launches"))
        del qm, got, ref, one, ref_one
        torch.cuda.empty_cache()

    # ---- (3)-(5): the engine mix on the bf16 model and each facade
    with uncounted(pa):
        bf16_logits, bf16_fed = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, probe,
                                             torch.bfloat16, 16)
    total = dict(paged=0, sm90=0)
    res["runs"], res["profile"] = {}, {}
    for run in ("bf16",) + WQUANT_RUNS:
        what = f"wquant {run}"
        torch.cuda.synchronize()
        qm = model if run == "bf16" else facade(run)
        footprint = res["base_bytes"] if run == "bf16" else qm.memory_footprint()
        want_bytes = res["base_bytes"] if run == "bf16" else wquant_weight_bytes(model, run)
        eng = InferenceEngine(qm, **SERVE_ENGINE)
        check(eng.infer.use_paged_kernel, "wquant: the engine on CUDA must run the kernel path")
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
        done, wall = serve_waves(torch, eng, prompts, sp, [[0], range(1, len(prompts))])
        engine_launches = dict(paged=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
        with uncounted(pa):
            pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
            got, _ = paged_logits(torch, qm, PagedInferenceModel, init_paged_pool, probe, torch.bfloat16, 16,
                                  feed=bf16_fed)
            logit_launches = dict(paged=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
        out = dict(latency(done, wall), engine_launches=engine_launches, memory_footprint=footprint,
                   expected_bytes=want_bytes, footprint_share_of_bf16=footprint / res["base_bytes"],
                   memory_allocated=allocated, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   ledger_conserved=eng.ledger.verify_conservation(),
                   logits_vs_bf16=dict(min_cosine=torch.nn.functional.cosine_similarity(got, bf16_logits, dim=-1)
                                       .min().item(),
                                       top1_agree=(got.argmax(-1) == bf16_logits.argmax(-1)).float().mean().item(),
                                       max_abs_diff=(got - bf16_logits).abs().max().item(),
                                       launches=logit_launches))
        gates.append((len(done) == len(prompts) and all(
            r.finish_reason in ("length", "stop") and all(0 <= t < vocab for t in r.output_ids)
            for r in done.values()), f"{what}: requests did not all finish in-vocab"))
        gates.append((logit_launches["sm90"] == logit_launches["paged"] > 0,
                      f"{what}: logits launches {logit_launches} -- every paged launch must take the Hopper route"))
        gates.append((footprint == want_bytes, f"{what}: memory_footprint {footprint}, the shapes give {want_bytes}"))
        gates.append((out["ledger_conserved"], f"{what}: goodput ledger conservation broken"))
        gates.append((torch.isfinite(got).all().item(), f"{what}: non-finite logits"))
        if run == "wint8":
            with uncounted(pa):
                launched = pa.LAUNCHES
                res["generate"] = wquant_generate(torch, np, qm, prompts, done, greedy[1:3])
                gates.append((pa.LAUNCHES == launched, "wquant generate: a paged kernel launched"))
            for i, d in res["generate"]["diverged"].items():
                gates.append((d["within_depth_gate"], f"wquant generate: prompt {i} parts from the engine outside "
                                                      f"twice the bf16 distance: {d}"))
        if run == "a8w8":
            res["http"] = wquant_http(eng, serving, SamplingParams, prompts, greedy[:2])
            for i, eq in res["http"]["equal"].items():
                gates.append((eq["json"] and eq["sse"], f"wquant http: prompt {i} differs from generate: {eq}"))
        del eng, got
        torch.cuda.empty_cache()
        if run in ("bf16", "wint8", "a8w8"):
            res["profile"][run] = wquant_profile(torch, np, qm, pa, InferenceEngine, SamplingParams, seed)
        # the phase's launches: the engine runs, the HTTP requests and the profiled calls
        out["launches"] = dict(paged=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
        out["sm90_share"] = pa.LAUNCHES_SM90 / max(pa.LAUNCHES, 1)
        for k in total:
            total[k] += out["launches"][k]
        gates.append((pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
                      f"{what}: {out['launches']} -- every paged launch must take the Hopper route"))
        res["runs"][run] = out
        del qm
        torch.cuda.empty_cache()
    res["launches"] = total
    res["sm90_launches"] = total["sm90"]
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    for ok, msg in gates:
        check(ok, msg)
    return res


# ----------------------------------------------------------------------------- generate
GEN_NEW = 64  # new tokens of the greedy batch: the engine phase's
GEN_SHORT = 32  # new tokens of the sampled, beam and wint8 runs


def left_pad(np, prompts, pad_id=0):
    """[B, longest] ids and attention mask, each prompt at the right edge."""
    T = max(len(p) for p in prompts)
    ids = np.full((len(prompts), T), pad_id, np.int64)
    mask = np.zeros((len(prompts), T), np.int64)
    for b, p in enumerate(prompts):
        ids[b, T - len(p):] = p
        mask[b, T - len(p):] = 1
    return ids, mask


def upto_eos(row, eos):
    """A generated row cut after its first eos: where the engine's stream
    ends (``generate`` pads the rest)."""
    row = [int(t) for t in row]
    return row[:row.index(eos) + 1] if eos in row else row


TOP_K_DISTANCE = 20  # the fp32 top tokens over which a bf16 path's distance from fp32 is read


def bf16_distance(torch, fp32_row, bf16_row):
    """A bf16 path's distance from fp32 at one position: the largest
    |logit| difference over the fp32 top ``TOP_K_DISTANCE`` tokens."""
    top = fp32_row.topk(TOP_K_DISTANCE).indices
    return (bf16_row.float()[top] - fp32_row[top]).abs().max().item()


def depth_divergence(torch, model, prompt, got, want, fp32_logits=None, bf16_logits=None, noise=None):
    """``divergence`` of two greedy streams computed by two different bf16
    paths at full depth, with a second gate beside its bf16 gate. After 28
    layers every bf16 path's logits sit 0.1-0.25 from the fp32 ones over
    the top tokens (the plain dense forward, the cached one, ``generate``'s
    batch and the engine alike: ``PERF.md`` §6), an order above one
    rounding, so near-ties split two such paths outside ``2**-7 * |l| +
    1e-3``. The second gate measures the bf16 distance D at the divergent
    position (``bf16_distance`` of the bf16 dense forward, or of
    ``bf16_logits(ids)``, from the fp32 one) and passes a margin within
    2 * D: two paths each within D of fp32 can rank that pair either way.
    For sampled streams ``noise`` is ``divergence``'s: the margin is then the
    two tokens' sampling scores', which carry the same logit error."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return divergence(torch, model, prompt, got, want)
    ids = [int(t) for t in prompt] + list(want[:j])
    l32 = model(torch.tensor([ids], device=DEVICE), dtype=torch.float32)[0, -1] if fp32_logits is None \
        else fp32_logits(ids)
    lbf = model(torch.tensor([ids], device=DEVICE))[0, -1] if bf16_logits is None else bf16_logits(ids)
    d = divergence(torch, model, prompt, got, want, fp32_logits=lambda _ids: l32, noise=noise)
    dist = bf16_distance(torch, l32, lbf)
    d.update(bf16_distance=dist, depth_gate=2 * dist, within_depth_gate=d["margin"] <= 2 * dist)
    del l32, lbf
    return d


class MaxTies:
    """A logits processor that keeps, for every step, which tokens share each
    row's largest logit, and leaves the logits as they are."""

    def __init__(self):
        self.tied = []

    def __call__(self, ids_buf, logits, cur_len):
        self.tied.append(logits == logits.amax(dim=-1, keepdim=True))
        return logits


def top1_split(greedy, k1, ties):
    """Rows where top-k 1 sampling parts from greedy, each with its first
    divergent position and whether the split is a tie: greedy's argmax takes
    the lowest of the tokens sharing the largest logit, top-k 1 keeps all of
    them and its draw picks one. Bf16 logits round to 2**-5 near 5, so
    over 152,064 tokens the top two often share a value."""
    out = {}
    for r, (g, k) in enumerate(zip(greedy.tolist(), k1.tolist())):
        j = next((i for i, (a, b) in enumerate(zip(g, k)) if a != b), None)
        if j is not None:
            tied = ties.tied[j][r]
            out[r] = dict(position=j, tokens=[g[j], k[j]], tied=int(tied.sum()),
                          is_tie=bool(tied.sum() > 1 and tied[g[j]] and tied[k[j]]))
    return out


def timed_generate(torch, model, *args, **kwargs):
    """``model.generate`` with the entry time of each forward: (ids, scores,
    timing). The loop reads its finished flags once a step, before the
    step's forward, so the time between two entries is one step's; the
    prefill's is from the call to the first step's entry."""
    base = getattr(model, "model", model)  # a facade generates through its base model
    inner = base._gen_forward
    stamps = []

    def stamped(*a, **k):
        stamps.append(time.perf_counter())
        return inner(*a, **k)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base._gen_forward = stamped
    t0 = time.perf_counter()
    try:
        ids, scores = model.generate(*args, **kwargs)
        torch.cuda.synchronize()
    finally:
        del base._gen_forward
    t1 = time.perf_counter()
    steps = [b - a for a, b in zip(stamps[1:], stamps[2:] + [t1])]
    stats = base.last_generate_stats
    B, new = ids.shape
    return ids, scores, dict(
        wall_s=t1 - t0, prefill_ms=((stamps[1] if len(stamps) > 1 else t1) - t0) * 1e3, decode_steps=len(steps),
        tpot_ms_p50=pct(steps, 0.5) * 1e3, tpot_ms_p99=pct(steps, 0.99) * 1e3, tokens_per_s=B * new / (t1 - t0),
        host_syncs=stats["host_syncs"], host_syncs_per_token=stats["host_syncs"] / new,
        cache_bytes=stats["cache_bytes"], peak_alloc_gb=torch.cuda.max_memory_allocated() / 1e9)


def mean_logp(torch, model, prompt, gen, eos):
    """The mean log-prob of ``gen`` (up to its first eos: a beam's length)
    after ``prompt``, teacher-forced through one bf16 dense forward, and the
    tolerance a beam score summed on the cached decode path gets against it.
    A beam's tokens are top tokens of its path, so at each position each
    bf16 path's log-prob of its token sits within D + |dLSE| of the fp32 one,
    D the ``bf16_distance`` and dLSE the log-sum-exp's shift, both read here
    from the dense pass against an fp32 pass: the two paths within twice
    that, averaged over the tokens."""
    gen = upto_eos(gen, eos)
    ids = torch.tensor([list(prompt) + gen], device=DEVICE)
    sl = slice(len(prompt) - 1, ids.shape[1] - 1)
    tok = torch.tensor(gen, device=DEVICE)[:, None]
    lbf = model(ids)[0, sl].float()
    l32 = model(ids, dtype=torch.float32)[0, sl]
    lp = torch.log_softmax(lbf, dim=-1).gather(1, tok)[:, 0]
    dist = torch.tensor([bf16_distance(torch, l32[t], lbf[t]) for t in range(len(gen))])
    dlse = (torch.logsumexp(lbf, dim=-1) - torch.logsumexp(l32, dim=-1)).abs().cpu()
    return lp.mean().item(), (2 * (dist + dlse)).mean().item()


def phase_generate(torch, np, model, pa, fa, InferenceEngine, SamplingParams, mono_streams, seed, engine=None):
    """``generate`` on the bf16 Qwen2-7B (the dense forward over a static KV
    cache; its attention the dispatcher's XLA-path counterpart, no kernel):

    (a) greedy: the engine phase's 8 prompts (256-2048 tokens) left-padded
    into one [8, 2048] batch, 64 new tokens, the engine's eos: each row
    equals the engine's greedy stream of that prompt (the engine phase's for
    its 6 greedy requests, an engine run here for the 2 it sampled), or
    parts only where the fp32 margin is within twice the bf16 distance at
    that position (``depth_divergence``; the bf16 gate's verdict printed
    beside it); a second run equal bit
    for bit; prefill ms, TPOT p50/p99, tokens/s, host syncs a token, peak
    allocated memory and the cache's bytes (gated against the shapes); no
    paged or flash kernel launched;
    (b) sampled: 2 prompts (256 and 640 tokens), temperature 0.9, top-k 50,
    top-p 0.9, seed 7, 32 new tokens: the same seed twice equal; top-k 1
    equal to greedy up to a position where several tokens share the row's
    largest bf16 logit (``top1_split``); the threefry bits of the 32 step
    keys and of a [2, 152064] draw equal on the card and on the CPU;
    (c) beam: 2 prompts of 512 tokens, 32 new tokens, ``num_beams=4`` and 4
    beams in 2 groups with ``diversity_penalty=1.0``: two runs equal bit for
    bit; each plain beam score within ``mean_logp``'s tolerance of the
    returned sequence's teacher-forced mean log-prob (a group-beam score,
    which carries the diversity penalties, at most that plus the
    tolerance); beam and greedy mean log-probs printed. ``engine``, the
    engine phase's result, puts its TPOT beside (a)'s."""
    from paddlenlp_tpu_torch.utils import prng

    t_phase = time.perf_counter()
    cfg = model.config
    vocab, eos = cfg.vocab_size, cfg.eos_token_id
    prompts, sampled = traffic(np, vocab, seed)
    res = dict(phase="generate", config="Qwen/Qwen2-7B", entry="Qwen2ForCausalLM.generate", dtype="bfloat16",
               loop="eager; one host sync a step (the finished flags)")
    gates = []

    # the engine's greedy streams of the 8 prompts
    want = {i: list(s) for i, s in mono_streams.items() if i not in sampled}
    eng = InferenceEngine(model, **SERVE_ENGINE)
    for i in sorted(sampled):
        eng.clear_prefix_cache()
        want[i] = list(eng.generate([prompts[i]], SamplingParams(max_new_tokens=GEN_NEW))[0])
    del eng
    torch.cuda.empty_cache()

    # ---- (a) greedy over the left-padded batch
    ids, mask = left_pad(np, prompts)
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = 0
    reset_counts(fa)
    out, _, timing = timed_generate(torch, model, ids, attention_mask=mask, max_new_tokens=GEN_NEW)
    launches = dict(paged=pa.LAUNCHES, flash=sum(fa.LAUNCHES.values()))
    again, _, timing2 = timed_generate(torch, model, ids, attention_mask=mask, max_new_tokens=GEN_NEW)
    L, K, H = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    cache_bytes = 2 * L * ids.shape[0] * (ids.shape[1] + GEN_NEW) * K * H * 2  # K and V, bf16
    diverged = {}
    for i in range(len(prompts)):
        d = depth_divergence(torch, model, prompts[i], upto_eos(out[i].tolist(), eos), want[i])
        if d is not None:
            diverged[i] = d
            gates.append((d["within_depth_gate"], f"generate greedy: row {i} parts from the engine outside twice "
                                                  f"the bf16 distance: {d}"))
    res["greedy"] = dict(batch=list(ids.shape), new_tokens=GEN_NEW, prompt_lens=[len(p) for p in prompts],
                         equal_to_engine=len(prompts) - len(diverged), of=len(prompts),
                         within_bf16_gate=sum(d["within_gate"] for d in diverged.values()), diverged=diverged,
                         second_run_equal=bool(torch.equal(out, again)), launches=launches,
                         cache_bytes_from_shapes=cache_bytes, **timing,
                         engine_tpot_ms=None if engine is None else dict(p50=engine["tpot_ms_p50"],
                                                                         p99=engine["tpot_ms_p99"]),
                         second_run=dict(prefill_ms=timing2["prefill_ms"], tpot_ms_p50=timing2["tpot_ms_p50"],
                                         tpot_ms_p99=timing2["tpot_ms_p99"]))
    gates.append((res["greedy"]["second_run_equal"], "generate greedy: a second run differs"))
    gates.append((timing["cache_bytes"] == cache_bytes,
                  f"generate greedy: cache of {timing['cache_bytes']} bytes, the shapes give {cache_bytes}"))
    gates.append((launches == dict(paged=0, flash=0), f"generate greedy: kernels launched {launches}"))
    del out, again
    torch.cuda.empty_cache()

    # ---- (b) sampled
    sids, smask = left_pad(np, [prompts[1], prompts[3]])
    kw = dict(max_new_tokens=GEN_SHORT, do_sample=True, temperature=0.9, top_k=50, top_p=0.9, seed=7)
    a, _, stiming = timed_generate(torch, model, sids, attention_mask=smask, **kw)
    b, _ = model.generate(sids, attention_mask=smask, **kw)
    ties = MaxTies()
    greedy, _ = model.generate(sids, attention_mask=smask, max_new_tokens=GEN_SHORT, logits_processors=[ties])
    k1, _ = model.generate(sids, attention_mask=smask, max_new_tokens=GEN_SHORT, do_sample=True, top_k=1, seed=7)
    split = top1_split(greedy, k1, ties)
    del ties
    key_g, key_c = prng.key(7, device=DEVICE), prng.key(7)
    keys_equal, draw_equal = True, None
    for step in range(GEN_SHORT):
        key_g, sub_g = prng.split(key_g)
        key_c, sub_c = prng.split(key_c)
        keys_equal &= [int(t) for t in sub_g + key_g] == [int(t) for t in sub_c + key_c]
        if step == 0:
            draw_equal = bool(torch.equal(prng.random_bits(sub_g, (2, vocab)).cpu(), prng.random_bits(sub_c, (2, vocab))))
    res["sampled"] = dict(batch=list(sids.shape), new_tokens=GEN_SHORT, settings=kw, same_seed_equal=bool(torch.equal(a, b)),
                          top_k1_equals_greedy=bool(torch.equal(k1, greedy)), top_k1_split=split,
                          top_k1_parts_only_at_ties=all(v["is_tie"] for v in split.values()),
                          step_keys_equal=keys_equal,
                          draw_bits_equal=draw_equal, differs_from_greedy=not bool(torch.equal(a, greedy)), **stiming)
    for what in ("same_seed_equal", "top_k1_parts_only_at_ties", "step_keys_equal", "draw_bits_equal"):
        gates.append((res["sampled"][what], f"generate sampled: {what} is false"))
    del a, b, greedy, k1

    # ---- (c) beam and group beam
    bprompts = [prompts[3][:512], prompts[5][:512]]
    bids = np.stack(bprompts)
    res["beam"] = dict(batch=list(bids.shape), new_tokens=GEN_SHORT)
    greedy, _ = model.generate(bids, max_new_tokens=GEN_SHORT)
    for name, bkw in (("beam", dict(num_beams=4)),
                      ("group_beam", dict(num_beams=4, num_beam_groups=2, diversity_penalty=1.0))):
        seqs, scores, btiming = timed_generate(torch, model, bids, max_new_tokens=GEN_SHORT, **bkw)
        seqs2, scores2 = model.generate(bids, max_new_tokens=GEN_SHORT, **bkw)
        rows = []
        for r in range(len(bprompts)):
            rescored, tol = mean_logp(torch, model, bprompts[r], seqs[r].tolist(), eos)
            greedy_lp, _ = mean_logp(torch, model, bprompts[r], greedy[r].tolist(), eos)
            score = scores[r].item()
            ok = abs(score - rescored) <= tol if name == "beam" else score <= rescored + tol
            rows.append(dict(score=score, rescored=rescored, diff=score - rescored, tol=tol, within=ok,
                             greedy_mean_logp=greedy_lp, beam_minus_greedy=rescored - greedy_lp))
            gates.append((ok, f"generate {name}: row {r} score {score} against its re-score {rescored} (tol {tol})"))
        equal = bool(torch.equal(seqs, seqs2) and torch.equal(scores, scores2))
        gates.append((equal, f"generate {name}: a second run differs"))
        res["beam"][name] = dict(settings=bkw, second_run_equal=equal, rows=rows, **btiming)
    del greedy, seqs, seqs2
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    for ok, msg in gates:
        check(ok, msg)
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

    def __call__(self, q, k, v, attention_mask=None, segment_ids=None, window=None):
        assert attention_mask is None and segment_ids is None and window is None
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


class patched:
    """Replaces ``owner.name`` by ``make(original)`` inside the block: how the
    training phases read what the trainer computes (the unrounded loss and
    grad norm of each step, the trainer itself) without a hook in the port."""

    def __init__(self, owner, name, make):
        self.owner, self.name, self.make = owner, name, make

    def __enter__(self):
        self.raw = vars(self.owner).get(self.name)  # None: inherited, not the owner's own
        setattr(self.owner, self.name, self.make(getattr(self.owner, self.name)))
        return self

    def __exit__(self, *exc):
        if self.raw is None:
            delattr(self.owner, self.name)
        else:
            setattr(self.owner, self.name, self.raw)


def step_spy(steps_out, trainers_out):
    """A ``Trainer.training_step`` that records each step's loss and grad norm
    (Python floats of the fp32 device scalars: every bit) and its trainer."""
    def make(original):
        def training_step(self, batch):
            out = original(self, batch)
            if not trainers_out or trainers_out[-1] is not self:
                trainers_out.append(self)
            steps_out.append((out["loss"].item(), out["grad_norm"].item()))
            return out
        return training_step
    return make


def pretrain_args(workdir, recipe, seed, **cuts):
    """The recipe with ``cuts`` applied, written to a JSON file for
    ``run_pretrain.main``; returns (path, args)."""
    import os

    args = {**recipe, **cuts, "seed": seed}
    path = os.path.join(workdir, f"pretrain_argument_{os.path.basename(cuts['output_dir'])}.json")
    with open(path, "w") as f:
        json.dump(args, f)
    return path, args


def checkpoint_report(ckpt, validate_checkpoint):
    """A committed checkpoint's bytes, files, hashes (from its manifest) and
    a full re-read with hashes (``validate_checkpoint``)."""
    import os

    with open(os.path.join(ckpt, "commit.json")) as f:
        manifest = json.load(f)
    t0 = time.perf_counter()
    reason = validate_checkpoint(ckpt, verify_hashes=True)
    hash_s = time.perf_counter() - t0
    nbytes = sum(manifest["files"].values())
    return dict(dir=os.path.basename(ckpt), bytes=nbytes, files=manifest["files"], sha256=manifest["sha256"],
                validate=reason, validate_hash_s=hash_s, validate_gb_per_s=nbytes / hash_s / 1e9)


def payload_hashes(report):
    """sha256 of the model and optimizer files (not config.json, whose dtype
    field is the same, nor trainer_state.json, whose log holds timings)."""
    return {f: h for f, h in report["sha256"].items() if f.startswith(("model", "optimizer"))}


class StepRecorder:
    """Per step: device-synchronized step time and peak memory, and the loop
    time from one step's start to the next (which holds a save); per log: the
    rounded loss, grad norm and lr; per save: its wall time; the last step's
    ``/metrics`` scrape from the trainer's exporter."""

    def __init__(self, torch, TrainerCallback, trainers, scrape_at=None):
        recorder = self
        self.steps, self.saves, self.scrape = [], [], None
        self.loop_t = []

        class Callback(TrainerCallback):
            def on_step_begin(self, *a, **kw):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                recorder.t0 = time.perf_counter()
                recorder.loop_t.append(recorder.t0)

            def on_step_end(self, args, state, control, **kw):
                torch.cuda.synchronize()
                recorder.steps.append(dict(step=state.global_step, step_s=time.perf_counter() - recorder.t0,
                                           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                                           tokens=kw.get("step_tokens")))

            def on_log(self, args, state, control, logs=None, **kw):
                if logs and "grad_norm" in logs:
                    recorder.steps[-1].update(loss=logs["loss"], grad_norm=logs["grad_norm"],
                                              lr=logs["learning_rate"])
                recorder.t_log = time.perf_counter()
                if scrape_at is not None and state.global_step == scrape_at:
                    from paddlenlp_tpu_torch.trainer.integrations import MetricsCallback

                    port = next(cb.port for cb in trainers[-1].callback_handler.callbacks
                                if isinstance(cb, MetricsCallback))
                    recorder.scrape = dict(port=port, metrics=http_call(port, "GET", "/metrics")[1].decode(),
                                           health=http_json(port, "GET", "/health")[1])

            def on_save(self, args, state, control, **kw):
                recorder.saves.append(dict(step=state.global_step, save_s=time.perf_counter() - recorder.t_log))

            def on_train_end(self, *a, **kw):
                torch.cuda.synchronize()
                recorder.loop_t.append(time.perf_counter())

        self.callback = Callback()

    def loop_s(self):
        """Time from each step's start to the next step's (the last: to the
        end of training), save included."""
        return [b - a for a, b in zip(self.loop_t, self.loop_t[1:])]


def prom_value(text, name):
    m = re.search(rf"^{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else None


def trace_kernels(path, names):
    """Launches of each kernel in a ``torch.profiler`` Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {n: sum(1 for e in events if e.get("cat") == "kernel" and n in e.get("name", "")) for n in names}


HOPPER_FLASH = ("flash_fwd_kernel_sm90", "flash_bwd_dq_kernel_sm90", "flash_bwd_dkv_kernel_sm90")


def reset_counts(fa):
    for counts in (fa.LAUNCHES, fa.LAUNCHES_SM90):
        for name in counts:
            counts[name] = 0


def phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder, workdir, seed):
    """``run_pretrain.main`` on the repo's Qwen2 recipe cut to one card and 4
    steps, at Qwen2-1.5B's published widths and full depth, with the metrics
    exporter on an ephemeral port and a profiler window over steps 3-4."""
    import os

    from paddlenlp_tpu_torch.trainer import Trainer
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    with open(RECIPE) as f:
        recipe = json.load(f)
    model_dir, data_dir, out_dir = (os.path.join(workdir, d) for d in ("model", "data", "out"))
    profile_dir = os.path.join(workdir, "profile")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(QWEN2_1_5B, f)
    corpus_tokens = markov_corpus(np, os.path.join(data_dir, "corpus"), QWEN2_1_5B["vocab_size"], seed,
                                  MMapIndexedDatasetBuilder)
    cuts = dict(model_name_or_path=model_dir, tokenizer_name_or_path=None, input_dir=data_dir, output_dir=out_dir,
                tensor_parallel_degree=1, sharding_parallel_degree=1, pipeline_parallel_degree=1, sharding="",
                gradient_accumulation_steps=2, max_steps=4, warmup_steps=1, do_eval=False, save_steps=5000,
                metrics_port=0, profiler_options=f"batch_range=[2,4];profile_path={profile_dir}")
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items()
               if k not in ("model_name_or_path", "input_dir", "output_dir", "metrics_port", "profiler_options")
               and recipe.get(k) != v}
    reduced["model"] = "Qwen/Qwen2-1.5B config.json (recipe: Qwen/Qwen2-7B), random weights from --seed"
    reduced["data"] = f"{corpus_tokens} tokens of a 64-token Markov chain, int32, from --seed"
    args_path, args = pretrain_args(workdir, recipe, seed, **cuts)

    trainers = []
    rec = StepRecorder(torch, TrainerCallback, trainers, scrape_at=args["max_steps"])
    reset_counts(fa)
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy([], trainers)):
        trainer = run_pretrain.main([args_path], device=DEVICE, callbacks=[rec.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    trainers.clear()

    model = trainer.model
    cfg = model.config
    accum, n_steps = args["gradient_accumulation_steps"], args["max_steps"]
    step_flops = model.get_model_flops(args["per_device_train_batch_size"] * accum, args["max_seq_length"])
    steps = rec.steps
    for s in steps:
        s.update(tokens_per_s=s["tokens"] / s["step_s"], mfu=step_flops / s["step_s"] / PEAK_FLOPS["bfloat16"],
                 profiled=s["step"] in (3, 4))
        emit(dict(phase="train_step", **s))
    losses = [s.get("loss", float("nan")) for s in steps]
    check(len(steps) == n_steps, f"train: {len(steps)} of {n_steps} steps ran")
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall ({losses})")
    per_run = cfg.num_hidden_layers * accum * n_steps
    check(launches == {"fwd": per_run, "bwd_dq": per_run, "bwd_dkv": per_run},
          f"train: flash launches {launches}, want {per_run} of each (28 a micro-step)")
    check(sm90 == launches, f"train: Hopper-route launches {sm90}, want all {launches}")
    steady = steps[1:] or steps
    mfu_steady = step_flops * len(steady) / sum(s["step_s"] for s in steady) / PEAK_FLOPS["bfloat16"]

    # the metrics plane, scraped over HTTP after the last step
    scrape = rec.scrape
    check(scrape is not None, "train: no /metrics scrape")
    metrics = {n: prom_value(scrape["metrics"], n) for n in
               ("train_steps_total", "train_tokens_total", "train_mfu", "train_loss", "ckpt_last_commit_age_seconds")}
    want_tokens = sum(s["tokens"] for s in steps)
    check(metrics["train_steps_total"] == n_steps, f"train: /metrics train_steps_total {metrics['train_steps_total']}")
    check(metrics["train_tokens_total"] == want_tokens,
          f"train: /metrics train_tokens_total {metrics['train_tokens_total']}, want {want_tokens}")
    # the gauge holds the last step's MFU; the profiler window slows steps 3-4
    # (15-36% on an H100), so it is held to the phase's own MFU of that step
    last_mfu = steps[-1]["mfu"]
    check(abs(metrics["train_mfu"] - last_mfu) <= 0.1 * last_mfu,
          f"train: /metrics train_mfu {metrics['train_mfu']} not within 10% of step {n_steps}'s MFU {last_mfu} "
          f"(steady MFU {mfu_steady})")

    # the profiler window: a Chrome trace holding the three Hopper flash kernels, and the span files
    profile = dict(files=sorted(os.listdir(profile_dir)),
                   kernels=trace_kernels(os.path.join(profile_dir, "trace.json"), HOPPER_FLASH),
                   trace_bytes=os.path.getsize(os.path.join(profile_dir, "trace.json")))
    check({"trace.json", "span_timeline.json", "spans.jsonl"} <= set(profile["files"]),
          f"train: profile files {profile['files']}")
    check(all(n > 0 for n in profile["kernels"].values()), f"train: the profile window lacks {profile['kernels']}")

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
    res = dict(phase="train", entry="paddlenlp_tpu_torch.llm.run_pretrain.main", recipe=RECIPE, reduced=reduced,
               params=model.num_parameters(), layers=cfg.num_hidden_layers, micro_batch=[2, args["max_seq_length"]],
               accum=accum, steps=n_steps, wall_s=wall, losses=losses, grad_norms=[s.get("grad_norm") for s in steps],
               step_s_steady=sum(s["step_s"] for s in steady) / len(steady),
               tokens_per_s_steady=sum(s["tokens"] for s in steady) / sum(s["step_s"] for s in steady),
               mfu_steady=mfu_steady,
               mfu_flops="get_model_flops(4, 4096) a step (6 N tokens + attention) over 989 TFLOP/s",
               peak_mem_gb=max(s["peak_mem_gb"] for s in steps), kernel_launches=launches, sm90_launches=sm90,
               metrics=metrics, health=scrape["health"], profile=profile,
               checkpoint=dict(files=files, load_check_s=time.perf_counter() - t_load, bitwise=True))
    emit(res)
    return trainer, res, dict(recipe=recipe, cuts=cuts)


# The smoke run budgets at most 45 GiB of writes to local disk (deleted files
# count). Three checkpoints and two final saves of Qwen2-1.5B
# with fp32 AdamW state write 67.9 GB (12 bytes a parameter a checkpoint, 4
# a final save), so the resume pair runs at this depth: 44 bytes a parameter
# over 794,949,120 parameters, 35.0 GB, beside the train run's 6.2 GB.
RESUME_LAYERS = 12


def phase_train_resume(torch, fa, run_pretrain, TrainerCallback, Qwen2ForCausalLM, workdir, seed, base):
    """The recipe's checkpointing (``save_steps`` 2, ``save_total_limit`` 2)
    through ``run_pretrain.main`` at Qwen2-1.5B widths and ``RESUME_LAYERS``
    layers: a straight 4-step run saves committed checkpoint-2 and -4; a
    second run resumes checkpoint-2 into a fresh output directory from a
    model built with another seed and saves checkpoint-4 asynchronously. Its
    steps 3-4 and final fp32 parameters equal the straight run's bit for bit,
    and its checkpoint-4's model and optimizer files hash as the sync one's."""
    import gc
    import os
    import shutil

    from paddlenlp_tpu_torch.trainer import Trainer
    from paddlenlp_tpu_torch.trainer import unified_checkpoint as uc
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    free_bytes = shutil.disk_usage(workdir).free
    emit(dict(phase="train_resume_disk", workdir_free_bytes=free_bytes))
    straight_dir, resumed_dir = (os.path.join(workdir, d) for d in ("out_ckpt", "out_resume"))
    cuts = dict(base["cuts"], num_hidden_layers=RESUME_LAYERS, save_steps=2, metrics_port=None,
                profiler_options=None)

    # the straight run: checkpoints at save_steps
    exact, trainers = [], []
    rec = StepRecorder(torch, TrainerCallback, trainers)
    path, args = pretrain_args(workdir, base["recipe"], seed, **dict(cuts, output_dir=straight_dir))
    reset_counts(fa)
    with patched(Trainer, "training_step", step_spy(exact, trainers)):
        trainer = run_pretrain.main([path], device=DEVICE, callbacks=[rec.callback])
    torch.cuda.synchronize()
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    trainers.clear()
    n_params = trainer.model.num_parameters()
    final = {k: t.detach().cpu() for k, t in flatten_params(trainer.model.params).items()}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    saved_at = {s["step"]: s["save_s"] for s in rec.saves}
    loop = rec.loop_s()
    ckpts = {}
    for step in (2, 4):
        r = checkpoint_report(os.path.join(straight_dir, f"checkpoint-{step}"), uc.validate_checkpoint)
        r.update(save_s=saved_at.get(step), save_gb_per_s=r["bytes"] / saved_at[step] / 1e9)
        ckpts[step] = r
        emit(dict(phase="train_checkpoint", **{k: v for k, v in r.items() if k != "sha256"}))
        check(r["validate"] is None, f"train_resume: checkpoint-{step} does not validate: {r['validate']}")
    check(sorted(d for d in os.listdir(straight_dir) if d.startswith("checkpoint")) == ["checkpoint-2", "checkpoint-4"],
          f"train_resume: checkpoints under the output dir: {os.listdir(straight_dir)}")
    sync_ckpt4 = payload_hashes(ckpts[4])
    # at most two checkpoints on disk at once: the sync checkpoint-4's hashes are kept
    shutil.rmtree(os.path.join(straight_dir, "checkpoint-4"))

    # the resumed run, from other weights
    resumed_exact, timings = [], {}
    resumed_rec = StepRecorder(torch, TrainerCallback, trainers)
    path, args = pretrain_args(workdir, base["recipe"], seed, **dict(
        cuts, output_dir=resumed_dir, async_save=True,
        resume_from_checkpoint=os.path.join(straight_dir, "checkpoint-2")))

    def timed(key):
        def make(original):
            def fn(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return original(*a, **kw)
                finally:
                    timings[key] = time.perf_counter() - t0
            return fn
        return make

    def other_seed(original):
        return lambda config, seed=0, **kw: original(config, seed=seed + 1, **kw)

    reset_counts(fa)
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(resumed_exact, trainers)), \
            patched(Trainer, "_load_checkpoint", timed("load_s")), \
            patched(Trainer, "_save_checkpoint", timed("save_stall_s")), \
            patched(uc, "_writer_main", timed("writer_s")), \
            patched(Qwen2ForCausalLM, "init_random", other_seed):
        trainer = run_pretrain.main([path], device=DEVICE, callbacks=[resumed_rec.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for n in launches:
        launches[n] += fa.LAUNCHES[n]
        sm90[n] += fa.LAUNCHES_SM90[n]
    trainers.clear()

    got = flatten_params(trainer.model.params)
    unequal = [k for k, t in got.items() if not torch.equal(t.detach().cpu(), final[k])]
    ckpt = checkpoint_report(os.path.join(resumed_dir, "checkpoint-4"), uc.validate_checkpoint)
    load_bytes = sum(ckpts[2]["files"].values())
    res = dict(phase="train_resume", entry="paddlenlp_tpu_torch.llm.run_pretrain.main",
               config=f"Qwen/Qwen2-1.5B widths, {RESUME_LAYERS} of 28 layers", params=n_params,
               reduced=dict(num_hidden_layers=dict(published=28, run=RESUME_LAYERS),
                            save_steps=dict(recipe=base["recipe"]["save_steps"], run=2)),
               workdir_free_bytes=free_bytes, checkpoint_bytes_by_shape=dict(model_fp32=4 * n_params,
                                                                             adamw_moments=8 * n_params),
               straight=dict(exact_loss_grad_norm=exact, step_s=[s["step_s"] for s in rec.steps], loop_s=loop,
                             saves={k: dict(bytes=r["bytes"], save_s=r["save_s"], save_gb_per_s=r["save_gb_per_s"],
                                            validate_hash_s=r["validate_hash_s"],
                                            validate_gb_per_s=r["validate_gb_per_s"]) for k, r in ckpts.items()},
                             saving_vs_plain_step_s=dict(
                                 saving=[loop[i] for i, s in enumerate(rec.steps) if s["step"] in saved_at],
                                 plain=[loop[i] for i, s in enumerate(rec.steps) if s["step"] not in saved_at])),
               resumed=dict(model_seed=seed + 1, wall_s=wall, steps=[s["step"] for s in resumed_rec.steps],
                            exact_loss_grad_norm=resumed_exact, load_s=timings.get("load_s"), load_bytes=load_bytes,
                            load_gb_per_s=load_bytes / timings["load_s"] / 1e9,
                            async_save=dict(loop_stall_s=timings.get("save_stall_s"), writer_s=timings.get("writer_s"),
                                            bytes=ckpt["bytes"],
                                            writer_gb_per_s=ckpt["bytes"] / timings["writer_s"] / 1e9,
                                            validate=ckpt["validate"], validate_hash_s=ckpt["validate_hash_s"])),
               params_bitwise=not unequal, unequal_leaves=unequal[:8], async_equals_sync=payload_hashes(ckpt) == sync_ckpt4,
               kernel_launches=launches, sm90_launches=sm90)
    emit(res)
    per_run = RESUME_LAYERS * args["gradient_accumulation_steps"] * (4 + 2)
    check(len(exact) == 4 and resumed_exact == exact[2:],
          f"train_resume: resumed steps 3-4 {resumed_exact} != the straight run's {exact[2:]}")
    check(not unequal, f"train_resume: final parameters differ from the straight run's in {unequal[:8]}")
    check(ckpt["validate"] is None, f"train_resume: async checkpoint-4 does not validate: {ckpt['validate']}")
    check(payload_hashes(ckpt) == sync_ckpt4,
          f"train_resume: async checkpoint-4 files {payload_hashes(ckpt)} != sync {sync_ckpt4}")
    check(launches == {"fwd": per_run, "bwd_dq": per_run, "bwd_dkv": per_run} and sm90 == launches,
          f"train_resume: flash launches {launches}, Hopper route {sm90}, want {per_run} of each")
    return trainer, res


def grad_max_recorder(torch, step, out):
    """An optimizer ``step`` that first appends to ``out`` each gradient
    leaf's largest magnitude along its first axis (a layer of a stacked
    leaf, a row of the embedding), on the host."""
    def recording_step(params, grads, grad_norm):
        out.append(torch.cat([g.detach().abs().reshape(len(g), -1).amax(1) for g in grads.values()]).cpu())
        return step(params, grads, grad_norm)
    return recording_step


def phase_train_recompute(torch, fa, Qwen2Config, Qwen2ForCausalLM, Trainer, TrainingArguments, batch, workdir,
                          seed):
    """One optimizer step (the recipe's micro-batch 2 x 4096, 2 micro-batches)
    under each of the 8 recompute granularities at Qwen2-1.5B's full depth,
    from the same random weights: the loss, the gradients' global norm and
    each gradient leaf's largest magnitude a layer bit for bit equal."""
    import gc

    from paddlenlp_tpu_torch.transformers.llama.modeling import RECOMPUTE_GRANULARITIES

    with open(RECIPE) as f:
        recipe = json.load(f)
    runs, leaf_maxes = [], []  # leaf_maxes: one row of grad_max_recorder's a granularity
    reset_counts(fa)
    for granularity in RECOMPUTE_GRANULARITIES:
        cfg = Qwen2Config(**{**QWEN2_1_5B, "recompute": True, "recompute_granularity": granularity})
        model = Qwen2ForCausalLM.init_random(cfg, seed=seed, device=DEVICE, dtype=torch.float32)
        model.compute_dtype = torch.bfloat16
        args = TrainingArguments(output_dir=workdir, per_device_train_batch_size=2, gradient_accumulation_steps=2,
                                 learning_rate=recipe["learning_rate"], weight_decay=recipe["weight_decay"],
                                 max_grad_norm=recipe["max_grad_norm"], warmup_steps=1, max_steps=1,
                                 save_strategy="no", seed=seed)
        trainer = Trainer(model=model, args=args)
        trainer.create_optimizer_and_scheduler(1)
        trainer.optimizer.step = grad_max_recorder(torch, trainer.optimizer.step, leaf_maxes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, before90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
        t0 = time.perf_counter()
        out = trainer.training_step(batch)
        torch.cuda.synchronize()
        runs.append(dict(granularity=granularity, step_s=time.perf_counter() - t0,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, loss=out["loss"].item(),
                         grad_norm=out["grad_norm"].item(),
                         flash_launches={n: fa.LAUNCHES[n] - before[n] for n in before},
                         sm90_launches={n: fa.LAUNCHES_SM90[n] - before90[n] for n in before90}))
        del trainer.optimizer.step  # the recorder holds the optimizer, and its moments, alive
        del trainer, model, out
        gc.collect()
        torch.cuda.empty_cache()
    losses = {r["loss"] for r in runs}
    grad_norms = {r["grad_norm"] for r in runs}
    # what the backward saves or recomputes cannot move the loss, a forward
    # value; it reaches the gradients, held here by their global norm and
    # each leaf's largest magnitude a layer
    leaves_unequal = [r["granularity"] for r, m in zip(runs, leaf_maxes) if not torch.equal(m, leaf_maxes[0])]
    res = dict(phase="train_recompute", config="Qwen/Qwen2-1.5B, full depth, bf16 compute over fp32 masters",
               step="1 optimizer step: 2 micro-batches of 2 x 4096", runs=runs, losses_equal=len(losses) == 1,
               grad_norms_equal=len(grad_norms) == 1, grad_leaf_max_abs_unequal=leaves_unequal,
               kernel_launches=dict(fa.LAUNCHES), sm90_launches=dict(fa.LAUNCHES_SM90))
    emit(res)
    check(len(losses) == 1, f"train_recompute: losses differ across granularities: {[r['loss'] for r in runs]}")
    check(len(grad_norms) == 1,
          f"train_recompute: grad norms differ across granularities: {[r['grad_norm'] for r in runs]}")
    check(not leaves_unequal, f"train_recompute: a leaf's largest |gradient| a layer differs from the full "
                              f"granularity's under {leaves_unequal}")
    check(all(r["sm90_launches"] == r["flash_launches"] for r in runs),
          "train_recompute: a flash launch left the Hopper route")
    return res


FUSED_CE_TOKENS = (2, 4096)  # the recipe's micro-batch


def phase_fused_ce(torch, seed):
    """``fused_linear_cross_entropy`` against ``causal_lm_loss`` on the full
    logits, at the training step's head: hidden [2, 4096, 1536] bf16 against
    the tied 1536 x 151936 head (fp32 master, bf16 product). The loss and both
    gradients within the bf16 gate; the peak allocated bytes of each."""
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss, fused_linear_cross_entropy

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    (B, T), D, V = FUSED_CE_TOKENS, QWEN2_1_5B["hidden_size"], QWEN2_1_5B["vocab_size"]
    hidden0 = torch.randn(B, T, D, generator=g, device=DEVICE).to(torch.bfloat16)
    weight0 = torch.randn(D, V, generator=g, device=DEVICE) * 0.02
    labels = torch.randint(0, V, (B, T), generator=g, device=DEVICE)
    labels[0, :100] = -100
    out = {}
    for name in ("full_logits", "fused"):
        hidden, weight = hidden0.clone().requires_grad_(True), weight0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "fused":
            loss = fused_linear_cross_entropy(hidden, weight, labels)[0]
        else:
            loss = causal_lm_loss(hidden @ weight.to(hidden.dtype), labels)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = dict(loss=loss.item(), dhidden=hidden.grad, dweight=weight.grad, s=time.perf_counter() - t0,
                         peak_bytes_over_inputs=torch.cuda.max_memory_allocated() - base)
        del loss, hidden, weight
    want, got = out["full_logits"], out["fused"]
    errors = {}
    for key in ("dhidden", "dweight"):
        w, x = want[key].float(), got[key].float()
        bound = 2**-7 * w.abs() + 1e-3 * w.abs().max()
        errors[key] = dict(max_abs_err=(x - w).abs().max().item(), worst=((x - w).abs() / bound).max().item())
    loss_worst = abs(got["loss"] - want["loss"]) / (2**-7 * abs(want["loss"]) + 1e-3)
    res = dict(phase="fused_ce", hidden=[B, T, D], head=[D, V], chunk=512,
               loss=dict(full_logits=want["loss"], fused=got["loss"], worst=loss_worst), grads=errors,
               peak_bytes_over_inputs={k: v["peak_bytes_over_inputs"] for k, v in out.items()},
               wall_s={k: v["s"] for k, v in out.items()},
               gate="|got - want| <= 2**-7 |want| + 1e-3 (x the largest |want| for gradients)")
    emit(res)
    del out, want, got
    torch.cuda.empty_cache()
    check(loss_worst <= 1 and all(e["worst"] <= 1 for e in errors.values()),
          f"fused_ce: outside the bf16 gate: loss {loss_worst}, grads {errors}")
    return res


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


def run_training_phases(torch, np, fa, seed):
    """The run_pretrain phases in order: ``train`` and ``train_profile``,
    ``train_resume``, ``train_recompute`` and ``fused_ce``. Returns the
    results of ``train``, ``train_resume`` and ``train_recompute``, whose
    flash launches the kernels line counts."""
    from paddlenlp_tpu_torch.data import MMapIndexedDatasetBuilder
    from paddlenlp_tpu_torch.llm import run_pretrain
    from paddlenlp_tpu_torch.trainer import Trainer, TrainerCallback, TrainingArguments
    from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        trainer, train, base = phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder,
                                           workdir, seed)
        batch = next(iter(trainer.get_train_dataloader()))
        phase_train_profile(torch, trainer)
        # two 1.5B trainers with fp32 moments do not fit beside the activations
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        trainer, resume = phase_train_resume(torch, fa, run_pretrain, TrainerCallback, Qwen2ForCausalLM, workdir,
                                             seed, base)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        recompute = phase_train_recompute(torch, fa, Qwen2Config, Qwen2ForCausalLM, Trainer, TrainingArguments,
                                          batch, workdir, seed)
    phase_fused_ce(torch, seed)
    return train, resume, recompute


# ----------------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights, the traffic and the corpus")
    args = ap.parse_args(argv)
    # a crash in native code prints every thread's Python stack to stderr
    faulthandler.enable(all_threads=True)

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    try:
        from paddlenlp_tpu_torch import serving
        from paddlenlp_tpu_torch.experimental import InferenceEngine, PagedInferenceModel, SamplingParams
        from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool, quantize_kv
        from paddlenlp_tpu_torch.ops import _build
        from paddlenlp_tpu_torch.ops import flash_attention as fa
        from paddlenlp_tpu_torch.ops import paged_attention as pa
        from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
        from paddlenlp_tpu_torch.peft import LoRAConfig, LoRAModel
        from paddlenlp_tpu_torch import quantization
        from paddlenlp_tpu_torch.serving import tenancy
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

    mono_streams = {}
    mono = phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed, None, mono_streams)
    chunked = phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed, 512)
    prof16 = phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed)

    logits = phase_logits(torch, np, model, pa, PagedInferenceModel, init_paged_pool, args.seed)
    serve = phase_serve(torch, np, model, pa, InferenceEngine, SamplingParams, serving, args.seed)
    router = phase_router(torch, np, model, pa, InferenceEngine, SamplingParams, serving, args.seed, serve)
    spec = phase_spec(torch, np, model, pa, fa, InferenceEngine, SamplingParams, Qwen2ForCausalLM, Qwen2Config,
                      mono_streams, args.seed)
    host = phase_host_tier(torch, np, model, pa, InferenceEngine, SamplingParams, serving, args.seed)
    kvq = phase_kv_quant(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                         prof16, args.seed)
    lora = phase_lora(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                      serving, LoRAModel, LoRAConfig, tenancy, args.seed)
    wquant = phase_wquant(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                          serving, quantization, modeling, args.seed)
    phase_generate(torch, np, model, pa, fa, InferenceEngine, SamplingParams, mono_streams, args.seed, engine=mono)
    del model
    torch.cuda.empty_cache()

    # ---- training: run_pretrain at Qwen2-1.5B width and depth
    flash = phase_flash_kernel(torch, fa, args.seed)
    grad = phase_train_grad(torch, fa, modeling, Qwen2Config, Qwen2ForCausalLM, causal_lm_loss, args.seed)
    train, resume, recompute = run_training_phases(torch, np, fa, args.seed)

    # paged rows: the Hopper kernel (bf16 over bf16, the main path: times at
    # the decode call, the launch the engine makes most), the SIMT kernel
    # (fp32 queries: times at the fp32 case) and the Hopper kernel's quantized
    # entry (bf16 over int8 and fp8: times at the int8 decode call). Launches
    # of the first two are the engine runs', the serve, router, spec,
    # host_tier, lora and wquant phases' on each route: the main path never takes the SIMT kernel, which
    # the fp32 logits run checks; the quantized entry's are the kv_quant
    # phase's, whose launches all took it
    by_batch = {(c["batch"], c["q"], c["pool"]): c for c in cases}
    kernels, checks = [], []
    sm90 = (mono["sm90_launches"] + chunked["sm90_launches"] + serve["sm90_launches"] + router["sm90_launches"]
            + spec["launches"]["paged_sm90"] + host["launches"]["paged_sm90"] + lora["launches"]["sm90"]
            + wquant["launches"]["sm90"])
    simt = (mono["kernel_launches"] + chunked["kernel_launches"] + serve["kernel_launches"]
            + router["kernel_launches"] + spec["launches"]["paged"] + host["launches"]["paged"] + lora["launches"]["paged"]
            + wquant["launches"]["paged"] - sm90 + kvq["launches"]["paged"] - kvq["launches"]["sm90_quant"])
    for route, timed_case, name, launches in (
            ("sm90", ("decode", "bfloat16", "bf16"), "ragged_paged_attention_sm90", sm90),
            ("simt", ("ragged", "float32", "fp32"), "ragged_paged_attention", simt),
            ("sm90_quant", ("decode", "bfloat16", "int8"), "ragged_paged_attention_sm90_quant",
             kvq["launches"]["sm90_quant"])):
        timed = by_batch[timed_case]
        checked = [c for c in cases if c["route"] == route]
        source = "paged_attention.cu" if route == "simt" else "paged_attention_sm90.cu"
        kernels.append(dict(
            name=name, route="cuda", source=f"paddlenlp_tpu_torch/csrc/{source}",
            replaces="paddlenlp_tpu/ops/pallas/paged_attention.py:56", launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in checked), ms=timed["ms"], plain_ms=timed["plain_ms"],
            bound_ms=timed["bound_ms"], bound_by=timed["bound_by"], library_ms=timed["library_ms"]))
        info = dict(check="pass", cases=len(checked), timed_case=" ".join(timed_case),
                    worst_err_over_tol=max(c["worst_err_over_tol"] for c in checked))
        if route == "sm90":
            info.update(launched_by="engine, serve, router, spec, host_tier, lora, wquant",
                        serve_launches=serve["sm90_launches"], router_launches=router["sm90_launches"],
                        spec_launches=spec["launches"]["paged_sm90"],
                        host_tier_launches=host["launches"]["paged_sm90"], lora_launches=lora["launches"]["sm90"],
                        wquant_launches=wquant["launches"]["sm90"],
                        launches_by_shape={k: mono["launches_by_shape"][k] + chunked["launches_by_shape"][k]
                                           for k in mono["launches_by_shape"]})
        elif route == "simt":
            info.update(launched_by="engine, serve, router, spec, host_tier, kv_quant, lora, wquant",
                        check_launches=logits["launches"]["float32"]["kernels"])
        else:
            fp8 = by_batch[("decode", "bfloat16", "fp8")]
            info.update(launched_by="kv_quant", fp8_decode_ms=fp8["ms"], fp8_decode_library_ms=fp8["library_ms"])
        checks.append(info)
    # flash rows: the Hopper kernels (bf16, the main path: times at its shape)
    # and the SIMT kernels (fp32: times from the fp32 case). Launches are the
    # train, train_resume and train_recompute runs' on each route, and for the
    # forward the spec phase's draft forwards too: the main path never takes
    # the SIMT kernels, which the fp32 train_grad step checks
    by_case = {c["case"]: c for c in flash}
    outputs = {"fwd": ("out", "lse"), "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}
    rows = [("fwd", "sm90", 81, "flash_attention_fwd_sm90"), ("fwd", "simt", 81, "flash_attention_fwd"),
            ("bwd_dq", "sm90", 187, "flash_attention_bwd_dq_sm90"), ("bwd_dq", "simt", 187, "flash_attention_bwd_dq"),
            ("bwd_dkv", "sm90", 227, "flash_attention_bwd_dkv_sm90"),
            ("bwd_dkv", "simt", 227, "flash_attention_bwd_dkv")]
    for what, route, line, name in rows:
        timed = by_case["main" if route == "sm90" else "fp32"]
        checked = [c for c in flash if c["route"] == route]
        runs = (train, resume, recompute)
        sm90 = sum(r["sm90_launches"][what] for r in runs)
        launches = sm90 if route == "sm90" else sum(r["kernel_launches"][what] for r in runs) - sm90
        if what == "fwd":
            draft90 = spec["launches"]["flash_fwd_sm90"]
            launches += draft90 if route == "sm90" else spec["launches"]["flash_fwd"] - draft90
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
        checks.append(dict(check="pass", cases=len(checked), timed_case=timed["case"],
                           launched_by="train, train_resume, train_recompute" + (", spec (draft)" if what == "fwd"
                                                                                  else ""),
                           train_launches=train["sm90_launches"][what], resume_launches=resume["sm90_launches"][what],
                           recompute_launches=recompute["sm90_launches"][what],
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
