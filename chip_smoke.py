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
              row, with bf16 queries over bf16, int8 and fp8 pools, with
              fp32 queries over fp32, int8 and fp8 pools and with bf16
              queries over an fp32 pool; the monolithic-prefill shape, 2048
              query tokens at contexts up to 2048, over bf16 and int8 pools
              and in fp32; the engine's decode call, 8 rows of one token at
              contexts 256-2112, over bf16, int8 and fp8 pools and in fp32;
              the speculative verify, 8 rows of 5 tokens, in bf16 and fp32;
              and PPO's rollout launches at Qwen2-1.5B's fold (12 query heads
              over 2), the prefill [8, 256] and a decode at contexts 162-288,
              in fp32. All take ``paged_attention_sm90.cu``: bf16 queries over
              a bf16, int8 or fp8 pool its wgmma entries (split kv walk in
              decode; the quantized entry for int8 and fp8 pools), fp32
              queries or an fp32 pool its fp32 entry (3xTF32 mma.sync), and
              each case checks its route; every case gives bitwise equal
              results over two launches; times against the card's bound (the
              fp32 entry's at the TF32 rate of its products, and at the fp32
              rate beside it), the plain version and
              ``scaled_dot_product_attention``;
4. engine  -- ``InferenceEngine`` serving 8 requests on Qwen2-7B at its
              published widths and depth with random bf16 weights from
              ``--seed``, once with monolithic prefill and once with 512-token
              chunks, every attention launch on the Hopper route;
5. profile -- ``torch.profiler`` over one steady decode call of the engine
              (its launches on the Hopper route too);
6. logits  -- one 1024-token request through prefill and 16 decode steps on
              the kernel path (fp32: the fp32 entry; bf16: the wgmma one)
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
              (the fp32 paged entry) against their dense forward at rel 1e-4; the
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
15. predict -- ``llm.predict.predictor`` and ``flask_server`` on the same
              model, with a tokenizer spanning Qwen2's ids (a ``WordLevel``
              one of ``w<id>`` words with Qwen2's special tokens and a ChatML
              template, through the port's ``PretrainedTokenizer``; the run
              fails at its start where ``tokenizers`` does not import): the
              block predictor (8 rows, the engine phase's settings, 64 new
              tokens, greedy) on the engine phase's 8 prompts as text, its
              texts the decode of ``InferenceEngine.generate``'s ids bit for
              bit and its streams against the engine phase's (a divergence
              only within the bf16 gates); ``stream_predict`` pieces joining
              to ``predict``'s text; the eager predictor (2 prompts of 256
              tokens, 16 new) against ``model.generate``; ``/generate`` JSON
              and SSE bodies; ``serve_v1`` answering a string prompt with the
              engine's ids; TTFT/TPOT and tokens/s; every paged launch on the
              Hopper route;

The MoE family, at Mixtral-8x7B's published widths (random bf16 weights from
``--seed``). These phases launch only the flash kernels, so they run first,
right after the build line of the two flash sources and while
``paged_attention_sm90.cu``, the longest build, finishes (a ``moe_done`` line
with the memory they leave allocated); the serving phases follow:

16. mixtral -- ``MixtralForCausalLM.generate`` at 16 of the 32 layers (the
              dense dispatch), greedy over [4, 1024] + 32: prefill ms, TPOT,
              tokens/s and peak memory, no kernel launched; its routing
              recorded and replayed in the checks (top-k flips on a rounding
              change): the ids against the argmax of the uncached dense path
              along the stream, parting only within twice the bf16 distance
              from the fp32 forward, and the cached prefill's logits within
              twice the uncached bf16 forward's distance from fp32; one MoE
              layer over 4096 tokens at full width: fp32 dense and sparse
              against the per-expert loop (1e-4 of the largest element, the
              aux loss rel 1e-5), bf16 sparse against dense within one bf16
              rounding on the norm, two launches bit for bit (the sparse
              backward too), each dispatch timed; the flash kernels at the
              step's attention shape (q [1, 4096, 32, 128] over k/v
              [1, 4096, 8, 128]); at 2 layers, under each dispatch, one
              [1, 4096] step's loss (LM + aux) and every gradient leaf through
              the kernels against the plain attention (``MIXTRAL_STEP_TOL``,
              routing pinned to the plain step's; the bf16-vs-fp32 control
              outside it), then two ``Trainer`` steps of 2 accumulated
              [1, 4096] micro-batches: step time, tokens/s, MFU, peak memory,
              every flash launch on the Hopper route;
16b. deepseek -- DeepSeek-V2-Lite at its published widths (MLA at head_dim
              192, 64 routed experts top 6 and 2 shared, layer 0 dense):
              ``generate`` at all 27 layers, greedy over [4, 1024] + 32,
              checked as mixtral's (routing pinned; ids against the uncached
              argmax, the cached prefill's logits); one MoE layer over 4096
              tokens in fp32 against the per-expert loop with the shared
              experts (1e-4 of the largest element, aux rel 1e-5), bf16 twice
              bit for bit, timed; the three flash kernels at head_dim 192
              (q/k/v [1, 4096, 16, 192] causal, and T 4095 with segments),
              bf16 and fp32 (the 3xTF32 kernels, the head dim split over warp
              pairs), against their plain versions, timed beside their
              bounds and SDPA; at 3 layers (layer 0 dense, 1-2 MoE) one
              [1, 4096] step through the kernels against the plain attention
              (``DEEPSEEK_STEP_TOL``, routing pinned, the bf16-vs-fp32 control
              outside it; the Hopper launches {fwd, dq, dk/dv: 3 each}), and
              the same step in fp32 through the kernels against the plain
              fp32 step (loss rel 1e-5, each leaf within 1e-4 of its largest;
              3 launches each on the fp32 route), then two ``Trainer`` steps
              of 2 accumulated [1, 4096] micro-batches at bf16 compute and
              two at the Trainer's default fp32 compute (``bf16=False``, its
              flash launches all on the fp32 route);

Training, ``run_pretrain`` and ``run_finetune`` at Qwen2-1.5B width and depth:

17. flash_kernel -- the flash-attention forward, dq and dk/dv kernels against
              their plain versions, elementwise, at the training path's shape
              (q [2, 4096, 12, 128] bf16 over k/v [2, 4096, 2, 128], causal),
              with segments and a window, and at T = 4095, each in bf16 and in
              fp32; bf16 takes all three through the Hopper tensor-core
              kernels (``flash_attention_sm90.cu``, route ``sm90``), fp32 all
              three through the 3xTF32 tensor-core kernels
              (``flash_attention_sm90_f32.cu``, route ``sm90_f32``), and each
              case checks its routes; the forward, dq and dk/dv give bitwise
              equal results over two launches; times against the bound, the
              plain versions and ``scaled_dot_product_attention``;
18. train_grad -- Qwen2-1.5B widths, 2 layers: the loss and every gradient
              leaf through the kernels against the attention through the
              plain versions, in fp32 (the 3xTF32 forward, dq and dk/dv) and
              at bf16 compute (the Hopper bf16 kernels), with the
              bf16-vs-fp32 control;
19. train  -- ``paddlenlp_tpu_torch.llm.run_pretrain.main`` on the repo's
              Qwen2 recipe (``llm/config/qwen2/pretrain_argument.json``) cut
              to one card and 4 steps (each cut printed under ``reduced``),
              Qwen2-1.5B at full width and depth with random weights and a
              Markov-chain corpus from ``--seed``, the predict phase's
              tokenizer as ``tokenizer_name_or_path``, with the metrics exporter
              on an ephemeral port and a ``profiler_options`` window over
              steps 3-4; per-step loss, grad norm, time, tokens/s, MFU and
              peak memory; the forward, dq and dk/dv launches all on the
              Hopper route; ``/metrics`` after the last step (4 steps, the
              tokens, ``train_mfu`` within 10% of the phase's MFU of that
              step, the steady MFU beside it); the
              window's Chrome trace holds the three Hopper flash kernels; the
              saved checkpoint (and the tokenizer beside it) loads back bit
              for bit;
20. train_profile -- ``torch.profiler`` over one more training step;
21. train_resume -- the recipe's checkpointing (``save_steps`` cut to 2,
              ``save_total_limit`` 2) through ``run_pretrain.main`` at
              Qwen2-1.5B widths and 4 layers (``RESUME_LAYERS``: the run keeps
              its disk writes under 45 GiB and its time under 1,200 s): a
              straight run
              saves committed checkpoint-2 and -4 (each validated with its
              hashes; save, hash and step times); a second run resumes
              checkpoint-2 into a fresh directory from other weights and saves
              checkpoint-4 asynchronously: steps 3-4 and the final fp32
              parameters equal the straight run's bit for bit, the two
              checkpoint-4s' model and optimizer files hash alike; load
              GB/s, the loop's stall against the writer thread's time;
22. train_recompute -- one optimizer step (2 micro-batches of 2 x 4096) under
              each of the 8 recompute granularities at full depth: wall s,
              peak memory and flash launches each; the losses equal;
23. finetune -- ``paddlenlp_tpu_torch.llm.run_finetune.main`` on the repo's
              SFT recipe (``llm/config/qwen2/sft_argument.json``) cut to one
              card (no tp2, no stage2, 4 steps, no saves between, one
              evaluate; each cut printed under ``reduced``), from the train
              phase's saved model and tokenizer through ``AutoConfig``,
              ``AutoModelForCausalLM`` and ``AutoTokenizer`` at full width and
              depth (fp32 masters, bf16 compute), zero padding, recompute,
              1 x 2048 x 4 micro-batches, lr 3e-5: 96 rows of ``src``/``tgt``
              and ``messages`` over the corpus's chain packed 4 to a row with
              a padding segment; finite falling losses; the three flash
              kernels' launches as the path implies (28 a micro-step, the
              forward again under ``full`` recompute, one forward a layer
              for the evaluate), all on the Hopper route; the saved model
              loads back through ``AutoModelForCausalLM`` bit for bit;
24. finetune_predict -- ``create_predictor(mode="block")`` on the SFT output
              directory alone (weights, config and tokenizer from disk), 4
              prompts, 32 new tokens, greedy: the ids equal an engine's over
              the trainer's final weights cast to bf16; every paged launch on
              the Hopper route;
PEFT and alignment at Qwen2-1.5B width and depth, each from the train
phase's saved model and tokenizer, each freeing its models:

25. finetune_lora -- ``run_finetune.main`` with ``lora`` on the repo's
              recipe (``llm/config/qwen2/lora_argument.json``) cut to one
              card (no stage2, accumulation 1, 3 steps, warmup 1, no saves
              or evaluations between; rank 8, lr 3e-4, recompute, padded
              batches kept): 4 rows of 1.9k-2k tokens a step with a padding
              mask (the dense attention path, as in the JAX package: no
              flash launch); every base leaf bit for bit unchanged, the
              adapters moved, the trainable count the JAX formula's, the
              adapter directory loads back bit for bit; the trained adapter
              exported to an ``AdapterRegistry`` serves one greedy request of
              32 tokens through the bf16 engine (Hopper paged kernel) that
              matches ``LoRAModel.generate`` within the depth gate;
26. finetune_prefix -- the same cut with ``prefix_tuning`` (64 tokens), 2
              steps: base leaves unchanged, ``prefix_kv`` moved;
27. vera   -- ``VeRAModel`` (rank 64 on q/k/v/o) through ``Trainer``, 2
              steps on the finetune phase's packed rows: the flash kernels,
              all on the Hopper route; base leaves and shared bases unchanged;
28. dpo    -- ``DPOTrainer`` on ``dpo_argument.json`` cut to one card (1 x
              accumulation 2, 3 steps; max_length 4096, prompt 2048, sigmoid,
              beta 0.1, lr 1e-6), rows from ``load_preference_rows``: step 1's
              loss ln 2 within 1e-4, every flash launch (policy, recompute,
              frozen reference at [2, 4095, 12, 128]) on the Hopper route, the
              three kernels against their plain versions at T = 4095;
29. rm     -- ``RewardTrainer`` over ``Qwen2ForSequenceClassification`` of the
              train phase's directory, 2 steps at max_length 1024;
30. ppo    -- ``PPOTrainer`` in GRPO mode for 2 rounds (the rm phase's reward
              model; 2 prompts of 128-256 tokens x 4 rollouts x 32 new
              tokens through one fp32 engine): every paged launch on the
              fp32 route (``sm90_f32``), the paged kernel's device ms in one
              profiled rollout round beside the round's wall; in round 2 the engine's paged model over the
              updated weights against their dense fp32 forward at rel 1e-4;
31. fused_ce -- ``fused_linear_cross_entropy`` against ``causal_lm_loss`` on
              full logits at the step's head (hidden [2, 4096, 1536] bf16,
              the tied 1536 x 151936 head): the loss and both gradients
              within the bf16 gate, the peak memory of each;
32. kernels -- every kernel with its launches on the serving runs (the two
              engine runs, the serve, router, spec, host_tier, lora, wquant,
              predict and finetune_predict phases and the finetune_lora
              phase's served adapter; the kv_quant phase for the quantized
              entry; the ppo phase's fp32 rollouts for the fp32 entry) and the
              training runs (train, train_resume, train_recompute, finetune,
              vera, dpo, the mixtral and deepseek phases' Trainer steps, and
              the spec phase's draft forwards; the fp32 route's, the deepseek
              phase's fp32 Trainer steps), each on its own route, and its
              check;
33. disk   -- the bytes this process wrote (``/proc/self/io``), checked
              against the 45 GiB a run may write, and the run's seconds.

The last three lines are the ``nvidia-smi`` name/power line, the kernels JSON
object (nine rows: the paged kernel on its bf16, quantized-pool and fp32
entries; the flash forward, dq and dk/dv on the bf16 Hopper route and on
the fp32 Hopper route) and
``{"ok": true, "device": {...}}``.
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
              "float32": 67e12,  # H100 SXM fp32 outside the tensor cores (NVIDIA data sheet)
              "tf32": 495e12}  # H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet)

# kernel vs plain version, elementwise: |err| <= RTOL * |ref| + ATOL. A bf16
# output is one rounding of an fp32 value; the two fp32 values differ only in
# summation order, so they round at most one bf16 ulp apart (<= 2**-7 * |x|);
# ATOL takes the fp32 differences near zero. It scales with |out|, which
# shrinks to ~sqrt(e / context) on long rows, so a misread block there fails.
KERNEL_TOL = {"bfloat16": (2**-7, 1e-3),
              "float32": (0.0, 1e-4)}  # summation order only
LOGITS_REL_TOL = 1e-4  # fp32 paged vs fp32 dense: summation order only


def emit(obj):
    """One JSON line; ``t``: the run's seconds when it was printed (from the
    import, as on the disk line), so each phase's share of the run shows."""
    print(json.dumps(dict(obj, t=round(time.perf_counter() - T_START, 1))), flush=True)


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
# (query heads, kv heads, head_dim, block size, table positions) of the two
# attention folds the kernel phase takes: Qwen2-7B serving, and PPO's
# rollouts of Qwen2-1.5B (its engine's tables hold 256 blocks of 16)
FOLDS = {"qwen2_7b": (28, 4, 128, 16, 4096), "ppo": (12, 2, 128, 16, 4096)}
# (query tokens per row, q_start, q_lens) of the launch shapes the engine gives the kernel
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
    # PPO's rollout round (the ppo phase's fold): 2 prompts of 130 and 256
    # tokens, 4 rollouts each, prefilled, then decoded at the 31st new token
    "ppo_prefill": (256, [0] * 8, [130] * 4 + [256] * 4),
    "ppo_decode": (1, [161] * 4 + [287] * 4, [1] * 8),
}
# (batch, query dtype, pool) of every case the kernel phase checks: bf16
# queries over a bf16, int8 or fp8 pool, the main path's, take the wgmma
# entries (over an int8 or fp8 pool the quantized one), fp32 queries or an
# fp32 pool the fp32 entry
CASES = [("ragged", "bfloat16", "bf16"), ("ragged", "bfloat16", "int8"), ("ragged", "bfloat16", "fp8"),
         ("ragged", "float32", "fp32"), ("ragged", "float32", "int8"), ("ragged", "float32", "fp8"),
         ("ragged", "bfloat16", "fp32"), ("prefill", "bfloat16", "bf16"), ("prefill", "bfloat16", "int8"),
         ("prefill", "float32", "fp32"), ("decode", "bfloat16", "bf16"), ("decode", "bfloat16", "int8"),
         ("decode", "bfloat16", "fp8"), ("decode", "float32", "fp32"), ("verify", "bfloat16", "bf16"),
         ("verify", "float32", "fp32"), ("ppo_prefill", "float32", "fp32"), ("ppo_decode", "float32", "fp32")]


def kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed):
    """Unit-normal q/K/V at the batch's fold (``FOLDS``: Qwen2-7B's, or
    PPO's for the ``ppo_`` batches) over a shuffled pool."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    N, K, H, bs, cap = FOLDS["ppo" if batch.startswith("ppo") else "qwen2_7b"]
    T, q_start, q_lens = BATCHES[batch]
    B = len(q_start)
    mb = cap // bs
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


def f32_route_products(args):
    """TF32 products a product of S = Q K^T and of O += P V takes at fp32
    accuracy on the fp32 entry (3xTF32): three for two fp32 operands, two
    where one operand is a TF32 value (bf16 queries; a bf16, int8 or fp8
    pool's values)."""
    pool_exact, q_exact = args["pool_k"].element_size() < 4, args["q"].element_size() < 4
    return 2 if (q_exact or pool_exact) else 3, 2 if pool_exact else 3


def kernel_bound(args, rate=None):
    """Least time the card could take: every needed input byte read once and
    the output written once over HBM bandwidth, or the attention flops this
    batch's causal masks need at the card's peak for q's type -- the larger.
    ``rate`` "tf32": the fp32 entry's instructions, the TF32 tensor-core peak
    with each product taken as many times as ``f32_route_products`` says;
    "float32": the fp32 peak outside the tensor cores, the rate of fp32
    arithmetic on the CUDA cores, given beside the TF32 one."""
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
    if rate == "tf32":
        n_s, n_pv = f32_route_products(args)
        t_ops = flops / 2 * (n_s + n_pv) / PEAK_FLOPS["tf32"] * 1e3
    else:
        t_ops = flops / PEAK_FLOPS[rate or str(q.dtype).removeprefix("torch.")] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# the paged kernel's launch counters: every route, the bf16 wgmma entries,
# their quantized-pool entry, the fp32 entry
LAUNCH_COUNTERS = ("LAUNCHES", "LAUNCHES_SM90", "LAUNCHES_SM90_QUANT", "LAUNCHES_SM90_F32")


def launch_counts(pa):
    return tuple(getattr(pa, name) for name in LAUNCH_COUNTERS)


#: names the profiler's own aggregation leaves out (``_filter_name`` of
#: ``torch.autograd.profiler_util``): memory records and its own range calls
PROFILER_SKIP = ("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                 "profiler::_record_function_enter_new", "profiler::_record_function_exit", "aten::is_leaf",
                 "aten::output_nr", "aten::_version")


def profile_sums(torch, prof, ranges=()):
    """A finished ``torch.profiler`` run summed from its raw Kineto events:
    ``(kernels, inside)``. ``kernels``: the device's kernels and copies
    (annotation ranges left out) by name, ``{name: [device ms, count]}``,
    the ``self_device_time_total`` and ``count`` of ``prof.key_averages()``;
    ``inside``: for each host op or ``record_function`` range named in
    ``ranges``, the device ms of the kernels launched inside it (each kernel
    belongs to the innermost host op that launched it: the event's
    ``linked_correlation_id``) and its count, key_averages'
    ``device_time_total``. key_averages builds a Python object for every event
    first: ~10 s for one decode call at Qwen2-7B with host ops recorded."""
    import bisect

    from torch.autograd import DeviceType

    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() not in PROFILER_SKIP and not getattr(e, "is_hidden_event", lambda: False)()]
    kernels, launched, names = {}, {}, {}
    for e in events:
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ms = (e.end_ns() - e.start_ns()) / 1e6
            raw = e.name()
            name = names.get(raw) or names.setdefault(raw, torch._C._demangle(raw))
            row = kernels.setdefault(name, [0.0, 0])
            row[0] += ms
            row[1] += 1
            launched[e.linked_correlation_id()] = launched.get(e.linked_correlation_id(), 0.0) + ms
    inside = {name: [0.0, 0] for name in ranges}
    if ranges:
        # the host ops by thread in start order, with the running sum of the device ms each launched
        ops = {}
        host = [e for e in events if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0
                and not e.is_async() and e.start_thread_id() == e.end_thread_id()]
        for e in sorted(host, key=lambda e: e.start_ns()):
            starts, sums = ops.setdefault(e.start_thread_id(), ([], [0.0]))
            starts.append(e.start_ns())
            sums.append(sums[-1] + launched.get(e.correlation_id(), 0.0))
        for e in host:
            if e.name() in inside:
                starts, sums = ops[e.start_thread_id()]
                lo, hi = bisect.bisect_left(starts, e.start_ns()), bisect.bisect_right(starts, e.end_ns())
                inside[e.name()][0] += sums[hi] - sums[lo]
                inside[e.name()][1] += 1
    return kernels, inside


def rollout_profile(torch, prof, wall_s, calls):
    """A rollout round traced under ``torch.profiler`` (device activity only):
    its wall and device ms, the device's idle share, the paged-attention
    kernels' device ms (their merges included) and launches beside the
    wrapper's ``calls``, and each paged kernel's [ms, count]."""
    kernels, _ = profile_sums(torch, prof)
    attn = {k: v for k, v in kernels.items() if "paged_attention" in k}
    device_ms = sum(ms for ms, _n in kernels.values())
    paged_ms = sum(ms for ms, _n in attn.values())
    return dict(wall_ms=wall_s * 1e3, device_ms=device_ms, device_idle_share=1 - device_ms / wall_s / 1e3,
                paged_attention_ms=paged_ms, paged_attention_share_of_wall=paged_ms / wall_s / 1e3,
                paged_attention_launches=sum(n for k, (_ms, n) in attn.items() if "merge" not in k),
                paged_kernel_calls=calls, paged_kernels={k[:80]: v for k, v in attn.items()})


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


def paged_error(torch, args, out, ref, q_dtype, name):
    """``out`` of the paged kernel against ``ref``, its plain version on the
    same ``args``: finite, within ``KERNEL_TOL`` elementwise, dead rows exact
    zeros; returns (max |err|, worst err over its bound, rtol, atol)."""
    rtol, atol = KERNEL_TOL[q_dtype]
    err = (out.float() - ref.float()).abs()
    worst = (err / (rtol * ref.float().abs() + atol)).max().item()  # <= 1 passes
    check(torch.isfinite(out.float()).all().item(), f"kernel {name}: non-finite output")
    check(worst <= 1.0, f"kernel {name}: |kernel - plain| exceeds {rtol}*|plain| + {atol} "
                        f"(worst element at {worst:.3g}x its bound)")
    for b, qlen in enumerate(args["q_lens"].tolist()):
        check(bool((out[b, qlen:] == 0).all()), f"kernel {name}: dead rows of sequence {b} are not exact zeros")
    return err.max().item(), worst, rtol, atol


def phase_kernel(torch, pa, quantize_kv, seed):
    import torch.nn.functional as F

    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    cases = []
    for batch, q_dtype, kv in CASES:
        args = kernel_case(torch, quantize_kv, batch, q_dtype, kv, seed)
        route = pa.kernel_route(args["q"].dtype, args["pool_k"].dtype)
        before = launch_counts(pa)
        out = pa.ragged_paged_attention(**args)
        moved = tuple(n - b for n, b in zip(launch_counts(pa), before))
        again = pa.ragged_paged_attention(**args)
        ref = pa.ragged_paged_attention_ref(**args)
        torch.cuda.synchronize()
        name = f"{batch} q {q_dtype} pool {kv}"
        want = (1, int(route in ("sm90", "sm90_quant")), int(route == "sm90_quant"), int(route == "sm90_f32"))
        check(moved == want, f"kernel {name}: launches, wgmma, quantized wgmma, fp32 entry moved by {moved}, "
                             f"want {want} on the {route} route")
        # no atomics on any route: the same inputs give the same bits
        check(torch.equal(out, again), f"kernel {name}: two launches differ")
        max_err, worst, rtol, atol = paged_error(torch, args, out, ref, q_dtype, name)
        ms = time_cuda(torch, lambda: pa.ragged_paged_attention(**args), 20, flush)
        plain_ms = time_cuda(torch, lambda: pa.ragged_paged_attention_ref(**args), 3, flush)
        # the yardstick: one library call on K/V gathered (and dequantized)
        # beforehand, in q's type, or in fp32 over an fp32 pool (bf16 q over
        # an fp32 pool: the function reads the pool's fp32 values)
        B, T, N, H = args["q"].shape
        _nb, K, bs, _ = args["pool_k"].shape
        S = args["block_tables"].shape[1] * bs
        tab = args["block_tables"].long()
        lib_dtype = torch.float32 if args["pool_k"].dtype == torch.float32 else args["q"].dtype

        def gathered(pool, sc):
            x = pool[tab].float()
            if sc is not None:
                x = x * sc[tab]
            return x.to(lib_dtype).permute(0, 2, 1, 3, 4).reshape(B, K, S, H).contiguous()

        kg, vg = gathered(args["pool_k"], args["k_scale"]), gathered(args["pool_v"], args["v_scale"])
        qh = args["q"].to(lib_dtype).transpose(1, 2).contiguous()
        pos = args["q_start"].long()[:, None] + torch.arange(T, device=DEVICE)[None, :]
        mask = (torch.arange(S, device=DEVICE)[None, None, :] <= pos[:, :, None])[:, None]
        library_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=True), 20, flush)
        bound_ms, bound_by = kernel_bound(args, "tf32" if route == "sm90_f32" else None)
        case = dict(batch=batch, q=q_dtype, pool=kv, route=route, max_abs_err=max_err, rtol=rtol, atol=atol,
                    worst_err_over_tol=worst, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                    shapes=dict(q=list(args["q"].shape), pool=list(args["pool_k"].shape)))
        if route == "sm90_f32":  # the old yardstick beside it: the fp32 rate outside the tensor cores
            case["bound_fp32_rate_ms"], case["bound_fp32_rate_by"] = kernel_bound(args, "float32")
            case["tf32_products"] = list(f32_route_products(args))
        check(bound_ms / ms <= 1.0, f"kernel {name}: {ms} ms is under its bound {bound_ms} ms: the bound is wrong")
        emit(dict(phase="kernel", **case))
        cases.append(case)
        del args, out, again, ref, kg, vg, mask
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
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               pool_bytes=eng.pool.kv.numel() * eng.pool.kv.element_size())
    emit(res)
    del eng
    torch.cuda.empty_cache()
    return res


def phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed, quant=None):
    """Where one steady-state decode call goes (8 requests, ``decode_steps``
    sub-steps): ``torch.profiler`` over the engine step after admission,
    device time by kernel and the device's idle share of the step; over a
    bf16 pool, or an int8 / fp8 one (``quant``)."""
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
    kernels, _ = profile_sums(torch, prof)
    device_ms = sum(ms for ms, _n in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    # both routes' kernels, and the Hopper route's merge of kv partitions
    attn = {k: v for k, v in kernels.items() if "paged_attention" in k}
    attn_ms = sum(ms for ms, _n in attn.values())
    attn_launches = sum(n for k, (_ms, n) in attn.items() if "merge" not in k)
    res = dict(phase="profile", step="decode call, 8 rows x %d sub-steps" % eng.decode_steps, kv_cache_quant=quant,
               wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
               attention_kernel_ms=attn_ms, attention_launches=attn_launches, sm90_launches=pa.LAUNCHES_SM90,
               attention_launch_ms=attn_ms / max(attn_launches, 1),
               attention_launch_bound_ms=sum(kv_bytes) / len(kv_bytes) / HBM_BYTES_PER_S * 1e3,
               context_tokens=fed, top_device_ms=[[k[:90], ms, n] for k, (ms, n) in top])
    emit(res)
    del eng
    torch.cuda.empty_cache()
    return res


# ----------------------------------------------------------------------------- logits
def paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, dtype, n_decode, feed=None, quant=None,
                 kernel=True, lora=None, adapter=0, infer=None):
    """Prefill ``prompt`` then ``n_decode`` decode steps through the paged
    forward, over a fresh pool (int8 / fp8 with ``quant``), on the kernel path
    or, with ``kernel=False``, on the plain gather path, feeding the greedy
    token (or ``feed[i]`` when given), with the LoRA delta of pool slot
    ``adapter`` of the device adapter pool ``lora`` when given, through
    ``infer`` (an engine's own paged model) when given; returns
    (logits [1 + n_decode, V] fp32, fed token ids)."""
    from paddlenlp_tpu_torch.experimental.inference_model import gather_lora

    bs = 16
    n_blocks = (len(prompt) + n_decode) // bs + 2
    if infer is None:
        infer = PagedInferenceModel(model, block_size=bs, num_blocks=n_blocks + 1, max_blocks_per_seq=n_blocks,
                                    dtype=dtype)
        check(infer.use_paged_kernel, "logits: the paged model on CUDA must run the kernel path")
        infer.use_paged_kernel = kernel  # the plain path only where the caller asks for it
    check(infer.use_paged_kernel == kernel, f"logits: the paged model's kernel path is {infer.use_paged_kernel}")
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
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_F32 = 0
    got32, fed = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, torch.float32, n_decode)
    launches["float32"] = dict(kernels=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90, sm90_f32=pa.LAUNCHES_SM90_F32)
    # the bf16 run is fed the fp32 run's tokens: its own greedy choices may
    # flip on a near-tie and then condition later positions on other inputs
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_F32 = 0
    got16, _ = paged_logits(torch, model, PagedInferenceModel, init_paged_pool, prompt, torch.bfloat16, n_decode,
                            feed=fed)
    launches["bfloat16"] = dict(kernels=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90, sm90_f32=pa.LAUNCHES_SM90_F32)
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
    check(launches == {"float32": dict(kernels=per_run, sm90=0, sm90_f32=per_run),
                       "bfloat16": dict(kernels=per_run, sm90=per_run, sm90_f32=0)},
          f"logits: launches {launches}, want {per_run} a run, the fp32 run's on the fp32 entry and the bf16 "
          "run's on the wgmma one")
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
    # the references, for the router phase: each greedy prompt alone, 64 new
    # tokens, equal to the server's JSON and SSE streams (the parity gate)
    res["solo_streams"] = {i: list(want[i]) for i in greedy}
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
        # SSE), each against the same request alone and directly on a replica;
        # the serve phase's solo streams stand for those of its two prompts
        # (the same engine settings, and its gate holds them equal to a
        # server's)
        solo.update(serve_res["solo_streams"])
        for i in range(len(prompts)):
            if i in solo:
                continue
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
    kernels, inside = profile_sums(torch, prof, ("spec_propose", "spec_verify"))
    out.update({k: ms / 2 for k, (ms, n) in inside.items() if n})
    out["all_kernels"] = sum(ms for ms, _n in kernels.values()) / 2
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
                   bf16_profile, bf16_engine, bf16_streams, seed):
    """The engine over an int8 or fp8 pool at Qwen2-7B (``kv_cache_quant``,
    the reference's ``cachekv_int8``).

    (a) Logits: one 1024-token request and 16 decode steps, in bf16 on the
    kernel path, in bf16 on the plain gather path (which the caller turns on
    here to compare) fed the same tokens, and in fp32 on the kernel path
    (the fp32 entry, the precise check), each over a fresh pool of the same
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
    ``2**-7 * |logit| + 1e-3`` is printed beside it. The engine phase's
    monolithic run (``bf16_engine``, ``bf16_streams``) is the same engine
    over a bf16 pool on the same requests: its time and memory stand beside
    the quantized runs', and the streams they are held to, printed:
    quantization changes the function.

    (c) One profiled decode call over an int8 pool against the bf16 one."""
    t_phase = time.perf_counter()
    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    vocab = model.config.vocab_size
    res = dict(phase="kv_quant", config="Qwen/Qwen2-7B", engine=SERVE_ENGINE, logits={}, runs=[])
    total = dict(paged=0, sm90_quant=0)
    reference = {}  # the fp32 references' launches, by counter: all on the fp32 entry

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
        with uncounted(pa, reference):
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
        what = f"kv_quant {quant} {'chunked' if chunk else 'monolithic'} {'kernel' if kernel else 'plain'}"
        check(len(done) == len(prompts), f"{what}: {len(done)} of {len(prompts)} requests finished")
        for i, r in done.items():
            check(r.finish_reason in ("length", "stop"), f"{what}: request {i} ended {r.finish_reason}")
            check(r.finish_reason == "stop" or len(r.output_ids) == 64, f"{what}: request {i} short")
            check(all(0 <= t < vocab for t in r.output_ids), f"{what}: request {i} emitted out-of-vocab ids")
        check(stats["hits"] > 0, f"{what}: no prefix-cache hit")
        check(eng.ledger.verify_conservation(), f"{what}: goodput ledger conservation broken")
        if kernel:
            check(launches["paged"] > 0 and launches["sm90_quant"] == launches["sm90"] == launches["paged"],
                  f"{what}: {launches} -- every paged launch must take the Hopper kernel's quantized entry")
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
    res["bf16_pool"] = dict({k: bf16_engine[k] for k in ("requests", "output_tokens", "wall_s", "tokens_per_s",
                                                          "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50", "tpot_ms_p99",
                                                          "peak_mem_gb", "pool_bytes")},
                            run="the engine phase's monolithic run")
    fp32_rows = {}
    for quant, chunk in KV_QUANT_RUNS:
        streams, run = serve(quant, chunk)
        for k in total:
            total[k] += run["launches"][k]
        plain, plain_run = serve(quant, chunk, False)

        def fp32_logits(ids, quant=quant):
            key = (quant, tuple(ids))
            if key not in fp32_rows:
                with uncounted(pa, reference):
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
    res["fp32_reference_launches"] = reference
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
    check(reference["LAUNCHES"] > 0 and reference["LAUNCHES_SM90_F32"] == reference["LAUNCHES"],
          f"kv_quant: the fp32 references' paged launches {reference}, want all on the fp32 entry")
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
    to check a result are not the main path's. ``made``, when given, adds up
    the launches made inside, by counter (``LAUNCH_COUNTERS``)."""

    def __init__(self, pa, made=None):
        self.pa, self.made = pa, made

    def __enter__(self):
        self.saved = launch_counts(self.pa)

    def __exit__(self, *exc):
        if self.made is not None:
            for name, now, was in zip(LAUNCH_COUNTERS, launch_counts(self.pa), self.saved):
                self.made[name] = self.made.get(name, 0) + now - was
        for name, was in zip(LAUNCH_COUNTERS, self.saved):
            setattr(self.pa, name, was)


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
    kernels, op_ms = profile_sums(torch, prof, ("aten::bmm", "aten::index_select"))
    device_ms = sum(ms for ms, _n in kernels.values())
    attn_ms = sum(ms for k, (ms, _n) in kernels.items() if "paged_attention" in k)
    del eng
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
                attention_kernel_ms=attn_ms, bmm_ms=op_ms["aten::bmm"][0], bmm_calls=op_ms["aten::bmm"][1],
                gather_ms=op_ms["aten::index_select"][0], gather_calls=op_ms["aten::index_select"][1],
                kernel_launches=sum(n for _ms, n in kernels.values()))


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

    reference = {}  # the fp32 references' paged launches, by counter: all on the fp32 entry

    def fp32_of(adapter_id):
        """The fp32 logits of the function a stream on ``adapter_id`` computes:
        the paged fp32 forward with the adapter's delta (the fp32 entry)."""
        slot = 0 if adapter_id is None else reg.slot_of(adapter_id)

        def logits(ids):
            with uncounted(pa, reference):
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
    res["fp32_reference_launches"] = reference
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    shutil.rmtree(workdir, ignore_errors=True)
    check(pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
          f"lora: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches on the Hopper route")
    check(reference.get("LAUNCHES_SM90_F32", 0) == reference.get("LAUNCHES", 0),
          f"lora: the fp32 references' paged launches {reference}, want all on the fp32 entry")
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
    kernels, op = profile_sums(torch, prof, ("dequantize_leaf", "quantize_activations", "aten::mm", "aten::_int_mm"))
    device_ms = sum(ms for ms, _n in kernels.values())
    del eng
    torch.cuda.empty_cache()
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms,
                attention_kernel_ms=sum(ms for k, (ms, _n) in kernels.items() if "paged_attention" in k),
                dequant_ms=op["dequantize_leaf"][0], dequant_calls=op["dequantize_leaf"][1],
                act_quant_ms=op["quantize_activations"][0], bf16_gemm_ms=op["aten::mm"][0],
                bf16_gemm_calls=op["aten::mm"][1], int8_gemm_ms=op["aten::_int_mm"][0],
                int8_gemm_calls=op["aten::_int_mm"][1], kernel_launches=sum(n for _ms, n in kernels.values()))


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
    fp32 entry against the facade's dense forward, rel 1e-4 (the logits
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
            pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = pa.LAUNCHES_SM90_F32 = 0
            got, fed = paged_logits(torch, qm, PagedInferenceModel, init_paged_pool, probe, torch.float32, 16)
            one = single_token_logits(torch, qm, PagedInferenceModel, init_paged_pool, single, torch.float32)
            f32, paged = pa.LAUNCHES_SM90_F32, pa.LAUNCHES
            layers = paged_layer_errors(torch, modeling, qm, PagedInferenceModel, init_paged_pool, probe)
        ref = qm(torch.tensor([fed], device=DEVICE), dtype=torch.float32)[0, len(probe) - 1:]
        ref_one = qm(torch.tensor(single, device=DEVICE)[:, None], dtype=torch.float32)[:, 0]
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        err_one = (one - ref_one).abs().max().item() / ref_one.abs().max().item()
        res["fp32_dispatch"][run] = dict(
            positions=got.shape[0], rel_err=err, rel_tol=LOGITS_REL_TOL, gated=run == "wint8",
            single_token=dict(sequences=len(single), rel_err=err_one), layer_by_layer=layers, f32_launches=f32)
        gates.append((err_one <= LOGITS_REL_TOL,
                      f"wquant fp32 dispatch {run}: single-token paged vs dense rel err {err_one} > {LOGITS_REL_TOL}"))
        if run == "wint8":
            gates.append((err <= LOGITS_REL_TOL,
                           f"wquant fp32 dispatch {run}: paged vs dense rel err {err} > {LOGITS_REL_TOL}"))
        gates.append((f32 == paged == (got.shape[0] + 1) * model.config.num_hidden_layers,
                      f"wquant fp32 dispatch {run}: {f32} of {paged} paged launches on the fp32 entry"))
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


# ----------------------------------------------------------------------------- tokenizer and predictor
# Qwen2's special tokens at their published ids (Qwen/Qwen2-7B tokenizer_config.json), after one word
# for each regular id: w0 ... w151642
QWEN2_SPECIALS = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645}
WORDS = 151643
CHATML = ("{% for m in messages %}<|im_start|>{{ m['role'] }}\n{{ m['content'] }}<|im_end|>\n{% endfor %}"
          "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")
TOKENIZER = "tokenizers WordLevel: w<id> words and Qwen2's special tokens, a ChatML template"


def tokenizer_libs():
    """The versions of ``tokenizers`` and ``jinja2``, None where one does not import."""
    import importlib

    out = {}
    for name in ("tokenizers", "jinja2"):
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "unknown")
        except ImportError:
            out[name] = None
    return out


def check_tokenizer_libs(libs):
    """Emit the ``tokenizer_libs`` line; fail where ``tokenizers`` does not
    import (the port's ``PretrainedTokenizer`` needs it)."""
    emit(dict(phase="tokenizer_libs", tokenizers=libs["tokenizers"], jinja2=libs["jinja2"], tokenizer=TOKENIZER))
    check(libs["tokenizers"] is not None, "tokenizer_libs: the tokenizers package does not import")


def make_tokenizer(path):
    """A tokenizer spanning Qwen2's 151,936 ids, saved under ``path`` with
    ``save_pretrained``: a ``WordLevel`` one (``w<id>`` words, Qwen2's
    special tokens at their ids, a ChatML template) through the port's
    ``PretrainedTokenizer``."""
    from tokenizers import AddedToken, Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import WhitespaceSplit

    from paddlenlp_tpu_torch.transformers import PretrainedTokenizer

    vocab = {f"w{i}": i for i in range(WORDS)}
    vocab.update(QWEN2_SPECIALS)
    t = Tokenizer(WordLevel(vocab, unk_token="<|endoftext|>"))
    t.pre_tokenizer = WhitespaceSplit()
    t.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in QWEN2_SPECIALS])
    tok = PretrainedTokenizer(tokenizer_object=t, eos_token="<|endoftext|>", pad_token="<|endoftext|>",
                              chat_template=CHATML)
    tok.save_pretrained(path)
    check(tok.encode("w0 w151642 <|im_start|>") == [0, 151642, 151644], "tokenizer: the ids of a probe text")
    return tok


def as_text(tok, ids):
    """Prompt ids as the tokenizer's text; ids past its last one (Qwen2-7B's
    embedding has 152,064 rows, the tokenizer 151,646 ids) fold into the
    words, and the count of folded ids is returned beside the text."""
    ids = [int(i) for i in ids]
    folded = [i if i < WORDS + len(QWEN2_SPECIALS) else i % WORDS for i in ids]
    return tok.decode(folded, skip_special_tokens=False), sum(a != b for a, b in zip(ids, folded))


PREDICT_NEW = 64  # new tokens of the block predictor: the engine phase's
EAGER_NEW = 16


def phase_predict(torch, np, model, pa, InferenceEngine, SamplingParams, tok, mono_streams, seed):
    """``llm.predict.predictor`` and ``flask_server`` over the bf16 Qwen2-7B:

    (a) ``create_predictor(mode="block")`` (8 rows, prompts to 2048 tokens,
    64 new, greedy, block 16, 2048 blocks, 256 a sequence: the engine
    phase's settings) on the engine phase's 8 prompts as text: its texts
    equal the tokenizer's decode of ``InferenceEngine.generate`` with the
    same settings over the same ids, bit for bit; against the engine phase's
    monolithic greedy streams (same prompts, other batching), equal or
    parting only within the bf16 gate or twice the bf16 distance
    (``depth_divergence``);
    TTFT, TPOT and tokens/s of the predictor's run;
    (b) ``stream_predict`` on 2 prompts, each alone on a cleared prefix
    cache: the pieces join to ``predict`` of that prompt alone;
    (c) ``create_predictor(mode="eager")`` on 2 prompts of 256 tokens, 16 new:
    its texts equal the decode of ``model.generate``'s ids;
    (d) ``flask_server.make_handler`` on an ephemeral port: ``/generate``
    JSON and SSE bodies equal (b)'s; ``serve_v1`` answers a string prompt on
    ``/v1/completions`` with the engine's ids;
    (e) every paged launch of the block predictor on the Hopper route."""
    from http.server import ThreadingHTTPServer

    from paddlenlp_tpu_torch.llm.predict import flask_server
    from paddlenlp_tpu_torch.llm.predict import predictor as P
    from paddlenlp_tpu_torch.serving import api

    t_phase = time.perf_counter()
    prompts, sampled = traffic(np, model.config.vocab_size, seed)
    rendered = [as_text(tok, p) for p in prompts]
    texts = [t for t, _ in rendered]
    ids = [tok.encode(t) for t in texts]
    check(all(len(a) == len(p) for a, p in zip(ids, prompts)), "predict: a prompt's text does not encode back")
    settings = dict(batch_size=8, src_length=2048, max_length=PREDICT_NEW, decode_strategy="greedy_search",
                    block_size=16, num_kv_blocks=2048, max_blocks_per_seq=256)
    args = P.PredictorArgument(model_name_or_path="(in memory)", mode="block", dtype="bfloat16", **settings)
    pred = P.create_predictor(args, model=model, tokenizer=tok)
    check(pred.engine.infer.use_paged_kernel, "predict: the predictor's engine must run the kernel path")
    res = dict(phase="predict", config="Qwen/Qwen2-7B", tokenizer=TOKENIZER, entry="paddlenlp_tpu_torch.llm.predict",
               settings=settings, folded_prompt_ids=[f for _, f in rendered])

    # (a) the predictor's batch, its requests recorded as the engine finishes them
    done, outs = [], []

    def recording(step):
        def fn():
            out = step()
            done.extend(out)
            return out
        return fn

    def keep_ids(generate):
        def fn(*a, **kw):
            out = generate(*a, **kw)
            outs.append(out)
            return out
        return fn

    torch.cuda.synchronize()
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    t0 = time.perf_counter()
    with patched(pred.engine, "step", recording), patched(pred.engine, "generate", keep_ids):
        got = pred.predict(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = pa.LAUNCHES, pa.LAUNCHES_SM90
    out_tokens = sum(len(r.output_ids) for r in done)
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [r.decode_time / (len(r.output_ids) - 1) * 1e3 for r in done if len(r.output_ids) > 1]
    res["batch"] = dict(requests=len(done), output_tokens=out_tokens, wall_s=wall, tokens_per_s=out_tokens / wall,
                        ttft_ms_p50=pct(ttft, 0.5), ttft_ms_p99=pct(ttft, 0.99), tpot_ms_p50=pct(tpot, 0.5),
                        tpot_ms_p99=pct(tpot, 0.99), measured_on=torch.cuda.get_device_name(0))
    with uncounted(pa):  # the reference: an engine with the predictor's settings
        ref_eng = InferenceEngine(model, max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256,
                                  dtype=torch.bfloat16)
        want_ids = ref_eng.generate(ids, SamplingParams(max_new_tokens=PREDICT_NEW))
        del ref_eng
    want = [tok.decode(x, skip_special_tokens=True) for x in want_ids]
    res["batch"]["text_equal_engine"] = [g == w for g, w in zip(got, want)]
    res["batch"]["ids_equal_engine"] = outs[0] == want_ids
    check(got == want, f"predict: texts differ from the engine's decode: {res['batch']['text_equal_engine']}")
    check(outs[0] == want_ids, "predict: the predictor's ids differ from InferenceEngine.generate's")
    vs_mono = {}
    for i in range(len(prompts)):
        if i in sampled or rendered[i][1]:
            continue  # a sampled request, or a prompt the text changed: other settings
        d = depth_divergence(torch, model, prompts[i], outs[0][i], mono_streams[i])
        vs_mono[i] = d
        check(d is None or d["within_gate"] or d["within_depth_gate"],
              f"predict: request {i} parts from the engine phase's stream outside the bf16 gates: {d}")
    res["vs_engine_phase"] = dict(compared=sorted(vs_mono), equal=[i for i, d in vs_mono.items() if d is None],
                                  diverged={i: d for i, d in vs_mono.items() if d is not None})

    # (b) stream_predict, each prompt alone on a cleared prefix cache
    singles = {}
    for i in (1, 3):
        pred.engine.clear_prefix_cache()
        ts = [time.perf_counter()]
        pieces = []
        for p in pred.stream_predict(texts[i]):
            pieces.append(p)
            ts.append(time.perf_counter())
        pred.engine.clear_prefix_cache()
        single = pred.predict([texts[i]])[0]
        singles[i] = dict(pieces=pieces, text=single)
        check("".join(pieces) == single, f"predict: stream_predict pieces of prompt {i} do not join to predict's")
    res["stream"] = {i: dict(pieces=len(s["pieces"]), chars=len(s["text"]), joined_equal=True)
                     for i, s in singles.items()}

    # (d) the HTTP servers: the legacy handler, then serve_v1 (ServingServer)
    server = ThreadingHTTPServer(("127.0.0.1", 0), flask_server.make_handler(pred, threading.Lock()))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]
    http = {}
    try:
        check(http_json(port, "GET", "/health")[1] == {"status": "ok"}, "predict: /health")
        for i, s in singles.items():
            pred.engine.clear_prefix_cache()
            status, body = http_json(port, "POST", "/generate", {"src": texts[i]})
            pred.engine.clear_prefix_cache()
            sse_status, raw = http_call(port, "POST", "/generate", {"src": texts[i], "stream": True})
            lines = [ln for ln in raw.decode().splitlines() if ln]
            pieces = [json.loads(ln[6:])["token"] for ln in lines if ln.startswith("data:") and "[DONE]" not in ln]
            http[i] = dict(json_equal=status == 200 and body["output"] == s["text"],
                           sse_equal=sse_status == 200 and pieces == s["pieces"] and lines[-1] == "data: [DONE]")
            check(http[i]["json_equal"] and http[i]["sse_equal"], f"predict: /generate bodies of prompt {i}: {http[i]}")
    finally:
        server.shutdown()
        server.server_close()
    servers = []
    with patched(api.ServingServer, "run", lambda original: lambda self, host="0.0.0.0", port=8011: servers.append(
            (self, self.start_in_thread(host="127.0.0.1", port=0)))):
        flask_server.serve_v1(pred, port=0)
    v1, v1_port = servers[0]
    try:
        i = 1
        pred.engine.clear_prefix_cache()
        status, body = http_json(v1_port, "POST", "/v1/completions", {"prompt": texts[i], "max_tokens": PREDICT_NEW})
        with uncounted(pa):
            alone = InferenceEngine(model, max_batch_size=8, block_size=16, num_blocks=2048, max_blocks_per_seq=256,
                                    dtype=torch.bfloat16)
            want_v1 = alone.generate([ids[i]], SamplingParams(max_new_tokens=PREDICT_NEW))[0]
            del alone
        http["v1_string_prompt"] = dict(status=status, ids_equal=status == 200 and
                                        body["choices"][0]["token_ids"] == want_v1,
                                        text_equal=status == 200 and body["choices"][0]["text"] == singles[i]["text"])
        check(http["v1_string_prompt"]["ids_equal"], f"predict: serve_v1 string prompt: {http['v1_string_prompt']}")
    finally:
        v1.shutdown(drain_timeout_s=60)
    torch.cuda.synchronize()
    res["http"] = http
    res["kernel_launches"], res["sm90_launches"] = pa.LAUNCHES, pa.LAUNCHES_SM90
    res["batch_launches"] = dict(kernel=launches, sm90=sm90)
    check(pa.LAUNCHES > 0 and pa.LAUNCHES_SM90 == pa.LAUNCHES,
          f"predict: {pa.LAUNCHES_SM90} of {pa.LAUNCHES} paged launches on the Hopper route")
    del pred
    torch.cuda.empty_cache()

    # (c) the eager predictor: model.generate, no kernel
    eprompts = [p[:256] for p in prompts[1:3]]
    etexts = [as_text(tok, p)[0] for p in eprompts]
    eids = np.asarray([tok.encode(t) for t in etexts])
    eargs = P.PredictorArgument(model_name_or_path="(in memory)", mode="eager", dtype="bfloat16", src_length=2048,
                                max_length=EAGER_NEW, decode_strategy="greedy_search")
    eager = P.create_predictor(eargs, model=model, tokenizer=tok)
    t0 = time.perf_counter()
    etext = eager.predict(etexts)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    gen, _ = model.generate(torch.as_tensor(eids, device=DEVICE), max_new_tokens=EAGER_NEW)
    ewant = [tok.decode(r.tolist(), skip_special_tokens=True) for r in gen.cpu()]
    res["eager"] = dict(prompts=[len(p) for p in eprompts], new_tokens=EAGER_NEW, wall_s=eager_s,
                        text_equal=[a == b for a, b in zip(etext, ewant)])
    check(etext == ewant, f"predict: the eager predictor's texts differ from model.generate's: {res['eager']}")
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
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
               ("segments+window", "bfloat16", 2048, True, 512), ("tail", "bfloat16", 4095, False, None),
               ("fp32 segments+window", "float32", 2048, True, 512), ("fp32 tail", "float32", 4095, False, None)]


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


def flash_bound(torch, fa, q, k, seg, window, what, rate=None):
    """Least time of one launch: the bytes it must move (each input read once,
    each output written once) over HBM bandwidth, or its matmul flops on the
    visible (row, col) pairs of this input at the card's peak for q's type
    (``rate`` "tf32": at the TF32 tensor-core peak with each product taken
    three times, the fp32 dq and dk/dv kernels' 3xTF32) -- the larger.
    Forward: q.k and p.v; dq: q.k, dO.v and ds.k; dk/dv: q.k, dO.v, p^T.dO
    and ds^T.q (2 flops a multiply-add)."""
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
    flops = matmuls * 2 * N * H * pairs * (3 if rate == "tf32" else 1)
    peak = PEAK_FLOPS[rate or str(q.dtype).removeprefix("torch.")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_check(torch, fa, name, q, k, v, do, seg, window, flush):
    """One case of the three flash kernels: each against its plain version,
    elementwise (``flash_worst``), then timed against its bound, the plain
    versions and, without segments or a window, scaled_dot_product_attention.
    These launches are checks: they run outside every main-path count."""
    import torch.nn.functional as F

    dtype = str(q.dtype).removeprefix("torch.")
    opts = dict(segment_ids=seg, causal=True, window=window)
    # bf16: all three on the bf16 Hopper route; fp32: all three on the 3xTF32
    # tensor-core kernels
    routes = {w: fa.kernel_route(q.dtype, w) for w in ("fwd", "bwd_dq", "bwd_dkv")}
    counters = {"sm90": fa.LAUNCHES_SM90, "sm90_f32": fa.LAUNCHES_SM90_F32}
    before = {r: dict(c) for r, c in counters.items()}
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa._delta(ref_out, do)  # both backward versions read the same saved tensors
    dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **opts)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, **opts)
    moved = {r: {w: c[w] - before[r][w] for w in c} for r, c in counters.items()}
    again = (fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta, **opts),
             *fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta, **opts),
             *fa.flash_attention_fwd(q, k, v, **opts))
    ref = fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta, **opts)
    torch.cuda.synchronize()
    for r in counters:
        want = {w: int(routes[w] == r) for w in routes}
        check(moved[r] == want, f"flash {name}: routes {routes}, but the {r} route took {moved[r]} launches")
    # no atomics: each block owns its rows of out, lse and dq; dk/dv sum in a fixed order
    check(torch.equal(dq, again[0]), f"flash {name}: two dq launches differ")
    check(torch.equal(dk, again[1]) and torch.equal(dv, again[2]), f"flash {name}: two dk/dv launches differ")
    check(torch.equal(out, again[3]) and torch.equal(lse, again[4]),
          f"flash {name}: two forward launches differ in out or lse")
    del again
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
    bounds = {what: flash_bound(torch, fa, q, k, seg, window, what, "tf32" if routes[what] == "sm90_f32" else None)
              for what in ms}
    fp32_rate = {what: flash_bound(torch, fa, q, k, seg, window, what)[0] for what in ms
                 if routes[what] == "sm90_f32"}
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
    case = dict(case=name, dtype=dtype, routes=routes, q=list(q.shape), kv=list(k.shape), segments=seg is not None,
                window=window, errors=errs, worst_err_over_tol=max(e["worst"] for e in errs.values()), ms=ms,
                plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
                bound_ms={w: b[0] for w, b in bounds.items()}, bound_by={w: b[1] for w, b in bounds.items()},
                bound_fp32_rate_ms=fp32_rate, library_fwd_ms=library["fwd"], library_bwd_ms=library["bwd"])
    emit(dict(phase="flash_kernel", **case))
    return case


def phase_flash_kernel(torch, fa, seed):
    """The three flash kernels against their plain versions, elementwise, at
    the training path's shape and three more (``flash_check``)."""
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    cases = []
    for name, dtype, T, segments, window in FLASH_CASES:
        q, k, v, do, seg = flash_case(torch, dtype, T, segments, seed)
        cases.append(flash_check(torch, fa, name, q, k, v, do, seg, window, flush))
        del q, k, v, do, seg
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

        self.fn = Fn

    def __call__(self, q, k, v, attention_mask=None, segment_ids=None, window=None, scale=None):
        assert attention_mask is None and segment_ids is None and window is None
        return self.fn.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale)


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
# The same bounds for the mixtral phase's step (2 layers of Mixtral-8x7B's
# widths, [1, 4096], routing pinned to the plain step's), placed between the
# kernels' readings and the control's over seeds 0-3 and both dispatches on
# an H100 (``tools/chip_smoke_mixtral.py --calibrate``; PERF.md): both
# readings sit ~1.3x above the Qwen2 step's at [2, 1024] and at [1, 4096].
MIXTRAL_STEP_TOL = dict(loss_rel=1e-4, leaf_rel=2.0e-2, all_rel=1.9e-2)


def _grad_step(torch, fa, modeling, cfg, model_cls, causal_lm_loss, ids, seed, dtype, plain):
    """One forward and backward of a fresh ``model_cls`` (fp32 master weights,
    compute in ``dtype``) with the attention through the kernels or, if
    ``plain``, the plain versions: (loss, {leaf: grad}, launches, bf16
    Hopper-route launches, fp32 Hopper-route launches). An MoE model's loss
    is the LM loss plus its load-balancing loss, as ``Trainer.compute_loss``
    has it."""
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    model = model_cls.init_random(cfg, seed=seed, device=DEVICE, dtype=torch.float32)
    model.compute_dtype = getattr(torch, dtype)
    leaves = flatten_params(model.params)
    for t in leaves.values():
        t.requires_grad_(True)
    before, sm90_before, f32_before = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90), dict(fa.LAUNCHES_SM90_F32)
    kernel_attention = modeling.dot_product_attention
    if plain:
        modeling.dot_product_attention = _PlainFlash(torch, fa)
    try:
        if model.returns_aux_loss:
            logits, aux = model.forward(ids, return_aux=True)
            loss = causal_lm_loss(logits, ids, shift=True) + aux
        else:
            loss = causal_lm_loss(model.forward(ids), ids, shift=True)
        loss.backward()
    finally:
        modeling.dot_product_attention = kernel_attention
    torch.cuda.synchronize()
    return (loss.item(), {k: t.grad for k, t in leaves.items()}, {n: fa.LAUNCHES[n] - before[n] for n in before},
            {n: fa.LAUNCHES_SM90[n] - sm90_before[n] for n in sm90_before},
            {n: fa.LAUNCHES_SM90_F32[n] - f32_before[n] for n in f32_before})


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
    same step with the attention through the plain versions, in fp32 (the
    3xTF32 forward, dq and dk/dv, to summation order) and at bf16
    compute (the training path's route, to ``BF16_STEP_TOL``, which the
    bf16-vs-fp32 control must exceed)."""
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
                            kernels_sm90_f32=runs[dtype, False][4], plain=runs[dtype, True][2])
                for dtype in ("float32", "bfloat16")}
    res = dict(phase="train_grad", config="Qwen/Qwen2-1.5B widths, 2 layers", tokens=list(ids.shape), seed=seed,
               loss={f"{dtype}_{'plain' if plain else 'kernels'}": r[0] for (dtype, plain), r in runs.items()},
               grad_leaves=len(runs["float32", True][1]),
               fp32=dict(fp32, loss_rel_tol=1e-5, leaf_max_rel_tol=1e-4),
               bf16=dict(bf16, tol=BF16_STEP_TOL), bf16_vs_fp32_control=control, launches=launches)
    emit(res)
    del runs
    torch.cuda.empty_cache()
    one_each, none = {"fwd": 2, "bwd_dq": 2, "bwd_dkv": 2}, {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
    # fp32: all three on the fp32 Hopper route; bf16: all three on the bf16 one
    for dtype, want_sm90, want_f32 in (("float32", none, one_each), ("bfloat16", one_each, none)):
        n = launches[dtype]
        check(n["kernels"] == one_each, f"train_grad {dtype}: kernel launches {n['kernels']}")
        check(n["kernels_sm90"] == want_sm90, f"train_grad {dtype}: bf16 Hopper-route launches {n['kernels_sm90']}")
        check(n["kernels_sm90_f32"] == want_f32,
              f"train_grad {dtype}: fp32 Hopper-route launches {n['kernels_sm90_f32']}")
        check(n["plain"] == none, f"train_grad {dtype}: the plain run launched")
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


def markov_chain(rng, vocab):
    """A Markov chain over a 64-token alphabet of ``vocab``: (alphabet ids,
    [64, 4] successor indices)."""
    return rng.choice(vocab, 64, replace=False), rng.integers(0, 64, (64, 4))


def markov_corpus(np, prefix, vocab, seed, MMapIndexedDatasetBuilder, n_docs=512):
    """Documents from a Markov chain over a 64-token alphabet (each token has 4
    successors), written as int32: Qwen2 ids reach 151935, past the builder's
    uint16 default. Returns the token count."""
    rng = np.random.default_rng(seed)
    alphabet, succ = markov_chain(rng, vocab)
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
    for counts in (fa.LAUNCHES, fa.LAUNCHES_SM90, fa.LAUNCHES_SM90_F32):
        for name in counts:
            counts[name] = 0


def phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder, workdir, seed, tok_dir):
    """``run_pretrain.main`` on the repo's Qwen2 recipe cut to one card and 4
    steps, at Qwen2-1.5B's published widths and full depth, with the metrics
    exporter on an ephemeral port and a profiler window over steps 3-4; the
    tokenizer saved under ``tok_dir`` is the recipe's ``tokenizer_name_or_path``,
    so ``save_model`` writes it beside the weights."""
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
    cuts = dict(model_name_or_path=model_dir, tokenizer_name_or_path=tok_dir, input_dir=data_dir, output_dir=out_dir,
                tensor_parallel_degree=1, sharding_parallel_degree=1, pipeline_parallel_degree=1, sharding="",
                gradient_accumulation_steps=2, max_steps=4, warmup_steps=1, do_eval=False, save_steps=5000,
                metrics_port=0, profiler_options=f"batch_range=[2,4];profile_path={profile_dir}")
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items()
               if k not in ("model_name_or_path", "tokenizer_name_or_path", "input_dir", "output_dir", "metrics_port",
                            "profiler_options")
               and recipe.get(k) != v}
    reduced["model"] = "Qwen/Qwen2-1.5B config.json (recipe: Qwen/Qwen2-7B), random weights from --seed"
    reduced["tokenizer"] = f"{TOKENIZER}, over Qwen2's ids (recipe: Qwen/Qwen2-7B's)"
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
    check(trainer.tokenizer is not None, "train: run_pretrain did not load the tokenizer")
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
    saved = type(model).from_pretrained(out_dir, device=DEVICE, param_dtype=torch.float32)
    trained = flatten_params(model.params)
    loaded = flatten_params(saved.params)
    check(loaded.keys() == trained.keys() and all(torch.equal(loaded[k], trained[k].detach()) for k in trained),
          "train: the saved checkpoint does not load back bit for bit")
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".safetensors"))
    tok_files = sorted(f for f in os.listdir(out_dir) if f.startswith("tokenizer"))
    check(tok_files, f"train: save_model wrote no tokenizer under the output dir: {os.listdir(out_dir)}")
    del saved, loaded, trained
    torch.cuda.empty_cache()
    res = dict(phase="train", entry="paddlenlp_tpu_torch.llm.run_pretrain.main", recipe=RECIPE, reduced=reduced,
               tokenizer=dict(kind=TOKENIZER, saved=tok_files),
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
# a final save), so the resume pair runs at a cut depth: at 10 layers 44
# bytes a parameter over 701,353,472 parameters, 30.9 GB, beside the train
# run's and the SFT run's final saves of 6.2 GB each, came to 43.3 GB (40.3
# GiB); at 12 layers (35.0 GB) the SFT save would bring the run to 47.4 GB.
# Since the deepseek phase it runs at 6 layers (514 M parameters, ~22.6 GB),
# for the run's time: 1,137-1,425 s at 10 layers on different hosts against
# its 1,200 s limit, and at 4 (420 M, ~18.5 GB) since the deepseek phase's
# fp32 step and Trainer steps (PERF.md §4).
RESUME_LAYERS = 4


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


SFT_RECIPE = "llm/config/qwen2/sft_argument.json"
SFT_ROWS = 96  # examples of the SFT set: 24 packed rows of 2048 tokens, >= the 16 that 4 steps take
SFT_DEV_ROWS = 8


def markov_text(np, rng, alphabet, succ, n):
    """A walk of ``n`` steps over the pretraining corpus's Markov chain, as words."""
    state = int(rng.integers(0, len(alphabet)))
    out = []
    for pick in rng.integers(0, succ.shape[1], n):
        out.append(f"w{alphabet[state]}")
        state = int(succ[state, pick])
    return " ".join(out)


def sft_data(np, data_dir, seed, n_rows, n_dev):
    """``train.json`` and ``dev.json`` of ``src``/``tgt`` rows (a prompt and
    its continuation, walks of the pretraining corpus's chain over the ids
    the tokenizer has words for), every fourth a ``messages`` row (a user
    turn and an assistant turn) for the chat template. Every example is
    410-508 tokens long with its eos or the template's 6 tokens, so each pack
    of 2048 holds exactly 4 examples and a padding tail of >= 16 tokens
    (``n_rows`` and ``n_dev`` are multiples of 4). Returns the row counts."""
    import os

    alphabet, succ = markov_chain(np.random.default_rng(seed), QWEN2_1_5B["vocab_size"])
    alphabet = np.where(alphabet < WORDS, alphabet, alphabet % WORDS)  # ids the tokenizer has words for
    rng = np.random.default_rng(seed + 1)
    os.makedirs(data_dir, exist_ok=True)
    kinds = {"src_tgt": 0, "messages": 0}
    for name, n in (("train.json", n_rows), ("dev.json", n_dev)):
        with open(os.path.join(data_dir, name), "w") as f:
            for r in range(n):
                messages = r % 4 == 3
                words = int(rng.integers(410, 509)) - (6 if messages else 1)
                n_src = int(rng.integers(words // 4, 3 * words // 4))
                src = markov_text(np, rng, alphabet, succ, n_src)
                tgt = markov_text(np, rng, alphabet, succ, words - n_src)
                if messages:
                    row = {"messages": [{"role": "user", "content": src}, {"role": "assistant", "content": tgt}]}
                else:
                    row = {"src": src, "tgt": tgt}
                kinds["messages" if messages else "src_tgt"] += name == "train.json"
                f.write(json.dumps(row) + "\n")
    return kinds


def phase_finetune(torch, np, fa, run_finetune, TrainerCallback, Qwen2ForCausalLM, AutoModelForCausalLM, workdir,
                   seed, model_dir):
    """``run_finetune.main`` on the repo's Qwen2 SFT recipe cut to one card,
    from the ``train`` phase's saved model and tokenizer (``model_dir``)
    through ``AutoConfig``/``AutoModelForCausalLM``/``AutoTokenizer`` at
    Qwen2-1.5B's full width and depth (fp32 masters, bf16 compute), zero
    padding on: 4 steps of 1 x 2048 x 4 micro-batches, every row packed from
    >= 2 examples with a padding segment; finite falling losses; each flash
    kernel's launches as the path implies, all on the Hopper route; the
    three kernels against their plain versions on the first packed row's
    segments at the launch shape (``flash_check``); the
    ``save_model`` output loads back through ``AutoModelForCausalLM``
    bit for bit."""
    import os

    from paddlenlp_tpu_torch.trainer import Trainer
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

    t_phase = time.perf_counter()
    with open(SFT_RECIPE) as f:
        recipe = json.load(f)
    data_dir, out_dir = os.path.join(workdir, "sft_data"), os.path.join(workdir, "sft_out")
    kinds = sft_data(np, data_dir, seed, SFT_ROWS, SFT_DEV_ROWS)
    cuts = dict(model_name_or_path=model_dir, dataset_name_or_path=data_dir, output_dir=out_dir,
                tensor_parallel_degree=1, sharding="", max_steps=4, warmup_steps=1, save_strategy="no",
                evaluation_strategy="no", seed=seed)
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items()
               if k not in ("model_name_or_path", "dataset_name_or_path", "output_dir", "seed")
               and recipe.get(k) != v}
    reduced["model"] = ("Qwen/Qwen2-1.5B config.json (recipe: Qwen/Qwen2-7B; full fine-tuning of 7B holds ~122 GB "
                        "of fp32 state), the train phase's weights")
    reduced["data"] = (f"{SFT_ROWS} rows ({kinds}) and a {SFT_DEV_ROWS}-row dev.json over the pretraining corpus's "
                       "chain, from --seed")
    reduced["eval"] = "one evaluate() after training (recipe: at every epoch)"
    args = {**recipe, **cuts}
    path = os.path.join(workdir, "sft_argument.json")
    with open(path, "w") as f:
        json.dump(args, f)

    steps, trainers = [], []
    rec = StepRecorder(torch, TrainerCallback, trainers)
    reset_counts(fa)
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(steps, trainers)):
        trainer = run_finetune.main([path], device=DEVICE, callbacks=[rec.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    trainers.clear()
    model = trainer.model
    cfg = model.config
    check(type(model) is Qwen2ForCausalLM and model.param_dtype == torch.float32
          and model.compute_dtype == torch.bfloat16, "finetune: not an fp32-master, bf16-compute Qwen2ForCausalLM")
    rows = [trainer.train_dataset[i] for i in range(len(trainer.train_dataset))]
    segments = [int(len(np.unique(r["segment_ids"]))) for r in rows]
    padded = [bool(r["segment_ids"][-1] == len(np.unique(r["segment_ids"]))) for r in rows]
    check(all(s == 5 for s in segments) and all(padded),
          f"finetune: a packed row lacks 2 examples or a padding segment: segments {segments}, padded {padded}")
    losses = [s[0] for s in steps]
    check(len(steps) == 4 and all(math.isfinite(x) for x in losses), f"finetune: losses {losses}")
    check(losses[-1] < losses[0], f"finetune: the loss did not fall ({losses})")
    accum = args["gradient_accumulation_steps"]
    micro = accum * len(steps)
    n_eval = math.ceil(len(trainer.eval_dataset) / trainer.args.global_eval_batch_size)
    # recompute "full" runs each layer's forward again in the backward; the
    # closing evaluate() runs one forward a batch, under no_grad
    L = cfg.num_hidden_layers
    want = {"fwd": L * micro * (2 if cfg.recompute and cfg.recompute_granularity == "full" else 1) + L * n_eval,
            "bwd_dq": L * micro, "bwd_dkv": L * micro}
    check(launches == want, f"finetune: flash launches {launches}, want {want} (28 a micro-step and kernel)")
    check(sm90 == launches, f"finetune: Hopper-route launches {sm90}, want all {launches}")
    # the first packed row's segments (its examples and the padding tail)
    # through the three kernels against their plain versions, at the launch
    # shape: q [1, T, 12, 128] over k/v [1, T, 2, 128] bf16, causal, no window
    seg = torch.as_tensor(np.asarray(rows[0]["segment_ids"], np.int32), device=DEVICE)[None]
    T, N, K = seg.shape[1], cfg.num_attention_heads, cfg.num_key_value_heads
    H = cfg.hidden_size // N
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q, do = (torch.randn(1, T, N, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, T, K, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    packed = flash_check(torch, fa, "sft packed row", q, k, v, do, seg, None, flush)
    del q, k, v, do, seg, flush

    # the save_model output loads back through the Auto classes
    t_load = time.perf_counter()
    saved = AutoModelForCausalLM.from_pretrained(out_dir, param_dtype="float32", device=DEVICE)
    trained = flatten_params(model.params)
    loaded = flatten_params(saved.params)
    check(loaded.keys() == trained.keys() and all(torch.equal(loaded[k], trained[k].detach()) for k in trained),
          "finetune: the saved model does not load back bit for bit")
    load_s = time.perf_counter() - t_load
    del saved, loaded
    torch.cuda.empty_cache()
    final_bf16 = {k: t.detach().to(torch.bfloat16) for k, t in trained.items()}
    del trained
    tokens = [s["tokens"] for s in rec.steps]
    res = dict(phase="finetune", entry="paddlenlp_tpu_torch.llm.run_finetune.main", recipe=SFT_RECIPE,
               tokenizer=TOKENIZER, reduced=reduced, params=model.num_parameters(), layers=L,
               micro_batch=[1, args["max_length"]], accum=accum, steps=len(steps), wall_s=wall,
               losses=losses, grad_norms=[s[1] for s in steps], step_s=[s["step_s"] for s in rec.steps],
               tokens=tokens, packed_rows=len(rows), segments_per_row=dict(min=min(segments), max=max(segments)),
               recompute=dict(on=cfg.recompute, granularity=cfg.recompute_granularity),
               eval_loss=next((h["eval_loss"] for h in trainer.state.log_history if "eval_loss" in h), None),
               peak_mem_gb=max(s["peak_mem_gb"] for s in rec.steps), kernel_launches=launches, sm90_launches=sm90,
               flash_case=packed,
               checkpoint=dict(files=sorted(os.listdir(out_dir)), load_check_s=load_s, bitwise=True),
               seconds=time.perf_counter() - t_phase, measured_on=torch.cuda.get_device_name(0))
    emit(res)
    config = model.config
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return res, out_dir, Qwen2ForCausalLM(config, unflatten_params(final_bf16))


FT_PREDICT_NEW = 32


def phase_finetune_predict(torch, pa, InferenceEngine, SamplingParams, out_dir, reference):
    """The user's path after SFT: ``create_predictor(mode="block",
    model_name_or_path=<the SFT output>)``, which loads the weights (bf16),
    the config and the tokenizer from disk, on 4 prompts of the SFT set's
    chain, 32 new tokens greedily: the ids equal an ``InferenceEngine`` over
    the trainer's own final weights cast to bf16 (``reference``), and every
    paged launch takes the Hopper route."""
    import os

    from paddlenlp_tpu_torch.llm.predict import predictor as P

    t_phase = time.perf_counter()
    with open(os.path.join(os.path.dirname(out_dir), "sft_data", "dev.json")) as f:
        rows = [json.loads(line) for line in f][:4]
    texts = [r["src"] if "src" in r else r["messages"][0]["content"] for r in rows]
    settings = dict(batch_size=4, src_length=1024, max_length=FT_PREDICT_NEW, decode_strategy="greedy_search",
                    block_size=16, num_kv_blocks=512, max_blocks_per_seq=128)
    outs = []

    def keep_ids(generate):
        def fn(*a, **kw):
            outs.append(generate(*a, **kw))
            return outs[-1]
        return fn

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = P.create_predictor(P.PredictorArgument(model_name_or_path=out_dir, mode="block", dtype="bfloat16",
                                                  **settings), device=DEVICE)
    load_s = time.perf_counter() - t0
    check(pred.model.param_dtype == torch.bfloat16 and pred.engine.infer.use_paged_kernel,
          "finetune_predict: the predictor's model is not bf16 on the kernel path")
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    t0 = time.perf_counter()
    with patched(pred.engine, "generate", keep_ids):
        got = pred.predict(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = pa.LAUNCHES, pa.LAUNCHES_SM90
    ids = [pred.tokenizer.encode(t)[-settings["src_length"]:] for t in texts]
    del pred
    torch.cuda.empty_cache()
    with uncounted(pa):
        eng = InferenceEngine(reference, max_batch_size=4, block_size=16, num_blocks=512, max_blocks_per_seq=128,
                              dtype=torch.bfloat16)
        want = eng.generate(ids, SamplingParams(max_new_tokens=FT_PREDICT_NEW))
        del eng
    out_tokens = sum(len(x) for x in outs[0])
    res = dict(phase="finetune_predict", entry="paddlenlp_tpu_torch.llm.predict.predictor.create_predictor",
               model_dir="the finetune phase's save_model output (config, safetensors, tokenizer)", tokenizer=TOKENIZER,
               settings=settings, prompts=[len(x) for x in ids], load_s=load_s, wall_s=wall,
               tokens_per_s=out_tokens / wall, ids_equal=outs[0] == want, texts=len(got),
               kernel_launches=launches, sm90_launches=sm90, seconds=time.perf_counter() - t_phase,
               measured_on=torch.cuda.get_device_name(0))
    emit(res)
    check(outs[0] == want, "finetune_predict: ids differ from an engine over the trainer's final weights in bf16")
    check(launches > 0 and sm90 == launches, f"finetune_predict: {sm90} of {launches} paged launches on Hopper")
    return res


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
    from torch.profiler import ProfilerActivity, profile

    batch = next(iter(trainer.get_train_dataloader()))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.training_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, _ = profile_sums(torch, prof)
    device_ms = sum(ms for ms, _n in kernels.values())
    # the first group whose name a kernel's contains takes it: the Hopper ones first
    groups = {"flash_fwd_sm90": "flash_fwd_kernel_sm90", "flash_bwd_dq_sm90": "flash_bwd_dq_kernel_sm90",
              "flash_bwd_dkv_sm90": "flash_bwd_dkv_kernel_sm90", "flash_fwd": "flash_fwd_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel", "flash_bwd_dkv": "flash_bwd_dkv_kernel"}
    by_group = {g: 0.0 for g in list(groups) + ["gemm", "other"]}
    launches = {g: 0 for g in groups}
    for name, (ms, count) in kernels.items():
        group = next((g for g, key in groups.items() if key in name), None)
        if group is not None:
            launches[group] += count
        elif re.search(r"gemm|nvjet|cutlass|xmma|sm90_", name, re.I):
            group = "gemm"
        else:
            group = "other"
        by_group[group] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    res = dict(phase="train_profile", step="1 optimizer step: 2 micro-batches of 2 x 4096, 28 layers", wall_ms=wall_ms,
               device_ms=device_ms, device_idle_share=1 - device_ms / wall_ms, device_ms_by_group=by_group,
               flash_launches=launches,
               top_device_ms=[[k[:90], ms, n] for k, (ms, n) in top])
    emit(res)
    return res


# ----------------------------------------------------------------------------- PEFT and alignment
LORA_RECIPE = "llm/config/qwen2/lora_argument.json"
DPO_RECIPE = "llm/config/qwen2/dpo_argument.json"
PEFT_ROWS = 12  # src/tgt rows of 1.9k-2k tokens: the 3 LoRA steps of 4 rows take them all
DPO_ROWS = 8  # preference pairs padded to 4096: 3 steps of 1 x 2 take 6
RM_ROWS = 4  # pairs padded to 1024: 2 steps of 2
PPO_ROUNDS = 2
PPO_PROMPTS = 2  # prompts a round, each rolled out 4 times


def align_text(np, seed, rows, spans, path):
    """``rows`` jsonl rows over the pretraining corpus's chain, one field a
    span: ``spans`` maps a field to its (lo, hi) word counts."""
    alphabet, succ = markov_chain(np.random.default_rng(seed), QWEN2_1_5B["vocab_size"])
    alphabet = np.where(alphabet < WORDS, alphabet, alphabet % WORDS)
    rng = np.random.default_rng(seed + 7)
    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps({k: markov_text(np, rng, alphabet, succ, int(rng.integers(lo, hi)))
                                for k, (lo, hi) in spans.items()}) + "\n")


class FrozenLeaves:
    """A trainer callback that copies the frozen leaves of the model it trains
    (its ``trainable_mask``'s False leaves, on the card) when training
    begins; ``unchanged()`` compares them after, bit for bit."""

    def __init__(self, torch, TrainerCallback, where):
        keeper = self
        self.saved, self.where = {}, where

        class Callback(TrainerCallback):
            def on_train_begin(self, args, state, control, model=None, **kw):
                from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

                mask = flatten_params(model.trainable_mask())
                keeper.saved = {k: v.detach().clone() for k, v in flatten_params(model.params).items()
                                if not mask[k]}
                keeper.trainable = {k: v.detach().clone() for k, v in flatten_params(model.params).items()
                                    if mask[k]}

        self.callback = Callback()

    def check(self, torch, model):
        from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

        live = flatten_params(model.params)
        same = all(torch.equal(live[k], v) for k, v in self.saved.items())
        moved = sum(not torch.equal(live[k].detach(), v) for k, v in self.trainable.items())
        check(len(self.saved) > 0 and same, f"{self.where}: a frozen leaf changed")
        check(moved == len(self.trainable), f"{self.where}: {len(self.trainable) - moved} trainable leaves did "
                                            "not move")
        n = len(self.saved)
        self.saved = self.trainable = {}
        return dict(frozen_leaves=n, frozen_bitwise=same, trainable_leaves=moved)


def lora_trainable_count(cfg, r):
    """The JAX ``print_trainable_parameters`` count of rank-``r`` adapters on
    all seven projections: r * (in + out) a kernel and layer."""
    D, I, K = cfg.hidden_size, cfg.intermediate_size, cfg.num_key_value_heads * (cfg.hidden_size //
                                                                                 cfg.num_attention_heads)
    dims = [(D, D), (D, K), (D, K), (D, D), (D, I), (D, I), (I, D)]
    return cfg.num_hidden_layers * r * sum(a + b for a, b in dims)


def peft_finetune(torch, np, fa, run_finetune, TrainerCallback, workdir, seed, base_dir, flag, steps, out_name):
    """``run_finetune.main`` on the LoRA recipe cut to one card with ``flag``
    (``lora`` or ``prefix_tuning``) set: (trainer, step losses, frozen-leaf
    report, reduced, args, wall s, flash launches)."""
    import os

    with open(LORA_RECIPE) as f:
        recipe = json.load(f)
    data_dir = os.path.join(workdir, "peft_data")
    if not os.path.isdir(data_dir):
        os.makedirs(data_dir)
        align_text(np, seed + 31, PEFT_ROWS, {"src": (1030, 1100), "tgt": (960, 1100)},
                   os.path.join(data_dir, "train.json"))
    cuts = dict(model_name_or_path=base_dir, dataset_name_or_path=data_dir, output_dir=os.path.join(workdir, out_name),
                sharding="", gradient_accumulation_steps=1, max_steps=steps, warmup_steps=1, save_strategy="no",
                evaluation_strategy="no", do_eval=False, seed=seed, lora=flag == "lora",
                prefix_tuning=flag == "prefix_tuning")
    if flag == "prefix_tuning":
        cuts["num_prefix_tokens"] = 64
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items()
               if k not in ("model_name_or_path", "dataset_name_or_path", "output_dir", "seed")
               and recipe.get(k) != v}
    reduced["model"] = ("Qwen/Qwen2-1.5B config.json (recipe: Qwen/Qwen2-7B: a 7B base written to disk would be "
                        "15.2 GB, past the run's writes), the train phase's weights")
    reduced["data"] = f"{PEFT_ROWS} src/tgt rows of 1.9k-2k tokens over the pretraining corpus's chain, from --seed"
    args = {**recipe, **cuts}
    path = os.path.join(workdir, f"{out_name}.json")
    with open(path, "w") as f:
        json.dump(args, f)
    from paddlenlp_tpu_torch.trainer import Trainer

    losses, trainers = [], []
    frozen = FrozenLeaves(torch, TrainerCallback, flag)
    reset_counts(fa)
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(losses, trainers)):
        trainer = run_finetune.main([path], device=DEVICE, callbacks=[frozen.callback])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    trainers.clear()
    check(len(losses) == steps and all(math.isfinite(x[0]) for x in losses), f"{flag}: losses {losses}")
    # a padding mask takes the dense attention path, as in the JAX package: no flash launch
    check(sum(launches.values()) == 0, f"{flag}: flash launches {launches} on a padded batch")
    return trainer, losses, frozen.check(torch, trainer.model), reduced, args, wall, launches


def phase_finetune_lora(torch, np, fa, pa, run_finetune, TrainerCallback, InferenceEngine, SamplingParams, tenancy,
                        Qwen2ForCausalLM, workdir, seed, base_dir):
    """``run_finetune.main`` with ``lora`` on ``llm/config/qwen2/lora_argument.json``
    cut to one card (no stage2, accumulation 1, 3 steps, warmup 1, no saves or
    evaluations between; rank 8, lr 3e-4, recompute, ``zero_padding: false``
    kept), micro-batches of 4 rows of 1.9k-2k tokens with a padding mask (the
    dense attention path: no flash launch, as in the JAX package): every base
    leaf bit for bit unchanged, the adapters moved, the trainable count the
    JAX formula's, the adapter directory loads back bit for bit, and the
    trained adapter, exported to the serving format and added to an
    ``AdapterRegistry``, serves one greedy request of 32 tokens through the
    bf16 engine (Hopper paged kernel, counted) that matches
    ``LoRAModel.generate`` (fp32) within the depth-divergence gate."""
    import os

    from paddlenlp_tpu_torch.peft import LoRAModel
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params, unflatten_params

    t_phase = time.perf_counter()
    trainer, losses, frozen, reduced, args, wall, flash = peft_finetune(
        torch, np, fa, run_finetune, TrainerCallback, workdir, seed, base_dir, "lora", 3, "lora_out")
    lm = trainer.model
    cfg = lm.config
    check(type(lm) is LoRAModel, f"lora: run_finetune trained a {type(lm).__name__}")
    trainable, total = lm.print_trainable_parameters()
    want = lora_trainable_count(cfg, args["lora_rank"])
    check(trainable == want and total == lm.model.num_parameters() + want,
          f"lora: {trainable:,} of {total:,} trainable, want {want:,} (the JAX formula)")
    out_dir = args["output_dir"]
    saved = LoRAModel.saved_leaves(out_dir)
    live = {k: v for k, v in flatten_params(lm.params).items() if "/lora_" in k}
    check(saved.keys() == live.keys() and all(torch.equal(saved[k].to(DEVICE), live[k].detach()) for k in live),
          "lora: the adapter directory does not load back bit for bit")

    # the trained adapter through the serving path: export -> registry -> the bf16 engine
    exported = os.path.join(workdir, "lora_adapter.safetensors")
    lm.export_adapter(exported)
    reg = tenancy.AdapterRegistry(cfg, max_rank=args["lora_rank"], pool_slots=1)
    reg.add("sft", exported)
    base_bf16 = Qwen2ForCausalLM(cfg, unflatten_params({k: v.detach().to(torch.bfloat16)
                                                        for k, v in flatten_params(lm.model.params).items()}))
    with open(os.path.join(args["dataset_name_or_path"], "train.json")) as f:
        prompt = trainer.tokenizer.encode(json.loads(f.readline())["src"])[:512]
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    eng = InferenceEngine(base_bf16, adapter_registry=reg, max_batch_size=1, block_size=16, num_blocks=64,
                          max_blocks_per_seq=40, dtype=torch.bfloat16)
    rid = eng.add_request(prompt, SamplingParams(max_new_tokens=FT_PREDICT_NEW), adapter_id="sft")
    done = {}
    while eng.has_work():
        for r in eng.step():
            done[r.req_id] = list(r.output_ids)
    got = done[rid]
    torch.cuda.synchronize()
    serve = dict(launches=pa.LAUNCHES, sm90=pa.LAUNCHES_SM90)
    del eng, reg, base_bf16
    torch.cuda.empty_cache()
    with torch.no_grad():
        want_ids, _ = lm.generate(torch.tensor([prompt], device=DEVICE), max_new_tokens=FT_PREDICT_NEW)
    want = upto_eos(want_ids[0].tolist(), cfg.eos_token_id)
    merged = Qwen2ForCausalLM(cfg, lm.merged_params())
    with uncounted(pa):
        d = depth_divergence(torch, merged, prompt, upto_eos(got, cfg.eos_token_id), want,
                             bf16_logits=lambda ids: merged(torch.tensor([ids], device=DEVICE),
                                                           dtype=torch.bfloat16)[0, -1])
    del merged
    check(d is None or d["within_depth_gate"], f"lora: the served adapter's stream parts from LoRAModel.generate "
                                               f"outside the depth gate: {d}")
    check(serve["launches"] > 0 and serve["sm90"] == serve["launches"],
          f"lora: {serve['sm90']} of {serve['launches']} paged launches of the served adapter on Hopper")
    res = dict(phase="finetune_lora", entry="paddlenlp_tpu_torch.llm.run_finetune.main (lora)", recipe=LORA_RECIPE,
               reduced=reduced, rank=args["lora_rank"], lr=args["learning_rate"],
               micro_batch=[args["per_device_train_batch_size"], args["max_length"]], steps=len(losses),
               losses=[x[0] for x in losses], grad_norms=[x[1] for x in losses], wall_s=wall,
               step_s=wall / max(len(losses), 1), trainable=trainable, total=total, frozen=frozen,
               flash_launches=flash, adapter_files=sorted(os.listdir(out_dir)),
               adapter_bytes=os.path.getsize(os.path.join(out_dir, "lora_model.safetensors")),
               served=dict(prompt=len(prompt), new=len(got), equal=d is None, divergence=d,
                           paged_launches=serve["launches"], sm90_launches=serve["sm90"]),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=time.perf_counter() - t_phase)
    emit(res)
    del trainer, lm
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_finetune_prefix(torch, np, fa, run_finetune, TrainerCallback, workdir, seed, base_dir):
    """``run_finetune.main`` with ``prefix_tuning`` (64 virtual tokens) on the
    same cut, 2 steps: every base leaf bit for bit unchanged, ``prefix_kv``
    moved; the prefix's keys and values ahead of every layer's in bf16 (the
    cache dtype under bf16 compute) through the dense path."""
    import os

    from paddlenlp_tpu_torch.peft import PrefixModelForCausalLM

    t_phase = time.perf_counter()
    trainer, losses, frozen, reduced, args, wall, flash = peft_finetune(
        torch, np, fa, run_finetune, TrainerCallback, workdir, seed, base_dir, "prefix_tuning", 2, "prefix_out")
    pm = trainer.model
    check(type(pm) is PrefixModelForCausalLM, f"prefix: run_finetune trained a {type(pm).__name__}")
    n, total = pm.print_trainable_parameters()
    cfg = pm.config
    want = cfg.num_hidden_layers * 2 * args["num_prefix_tokens"] * cfg.num_key_value_heads * \
        (cfg.hidden_size // cfg.num_attention_heads)
    check(n == want, f"prefix: {n:,} trainable, want {want:,}")
    out_dir = args["output_dir"]
    saved = PrefixModelForCausalLM.saved_leaves(out_dir)["prefix_kv"]
    check(torch.equal(saved.to(DEVICE), pm.params["prefix_kv"].detach()), "prefix: the saved prefix differs")
    res = dict(phase="finetune_prefix", entry="paddlenlp_tpu_torch.llm.run_finetune.main (prefix_tuning)",
               recipe=LORA_RECIPE, reduced=dict(reduced, peft="prefix_tuning, 64 tokens, in place of lora"),
               num_prefix_tokens=args["num_prefix_tokens"], steps=len(losses), losses=[x[0] for x in losses],
               grad_norms=[x[1] for x in losses], wall_s=wall, step_s=wall / max(len(losses), 1), trainable=n,
               total=total, frozen=frozen, flash_launches=flash, adapter_files=sorted(os.listdir(out_dir)),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=time.perf_counter() - t_phase)
    emit(res)
    del trainer, pm
    gc.collect()
    torch.cuda.empty_cache()
    return res


VERA_STEPS = 2


def phase_vera(torch, np, fa, run_finetune, TrainerCallback, AutoModelForCausalLM, AutoTokenizer, workdir, seed,
               base_dir):
    """``VeRAModel`` (rank 64 on q/k/v/o, the JAX defaults) over the train
    phase's model through ``Trainer`` (VeRA has no ``run_finetune`` flag in
    the JAX package), 2 steps on the finetune phase's packed SFT rows
    (zero padding: the flash kernels): base leaves and shared bases bit for
    bit unchanged, the vectors moved, every flash launch on the Hopper route."""
    import os

    from paddlenlp_tpu_torch.datasets import ZeroPaddingMapDataset
    from paddlenlp_tpu_torch.peft import VeRAConfig, VeRAModel
    from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    t_phase = time.perf_counter()
    tok = AutoTokenizer.from_pretrained(base_dir)
    data_args = run_finetune.DataArguments(max_length=2048, src_length=1024)
    rows = run_finetune.load_sft_dataset(os.path.join(workdir, "sft_data", "train.json"), tok, data_args)
    ds = ZeroPaddingMapDataset(run_finetune.ListDataset(rows), tok, data_args.max_length)
    model = AutoModelForCausalLM.from_pretrained(base_dir, dtype="bfloat16", param_dtype="float32", device=DEVICE)
    model.config.recompute = True
    model.config.recompute_granularity = "full"
    vm = VeRAModel(model, VeRAConfig())
    trainable, total = vm.print_trainable_parameters()
    losses, trainers = [], []
    frozen = FrozenLeaves(torch, TrainerCallback, "vera")
    args = TrainingArguments(output_dir=os.path.join(workdir, "vera_out"), per_device_train_batch_size=1,
                             max_steps=VERA_STEPS, learning_rate=1e-3, warmup_steps=0, logging_steps=1,
                             save_strategy="no", seed=seed)
    reset_counts(fa)
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(losses, trainers)):
        trainer = Trainer(model=vm, args=args, train_dataset=ds, callbacks=[frozen.callback])
        trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    trainers.clear()
    L = model.config.num_hidden_layers
    want = {"fwd": 2 * L * VERA_STEPS, "bwd_dq": L * VERA_STEPS, "bwd_dkv": L * VERA_STEPS}
    check(launches == want, f"vera: flash launches {launches}, want {want} (full recompute: the forward twice)")
    check(sm90 == launches, f"vera: Hopper-route launches {sm90}, want all {launches}")
    check(len(losses) == VERA_STEPS and all(math.isfinite(x[0]) for x in losses), f"vera: losses {losses}")
    report = frozen.check(torch, vm)
    mask = flatten_params(vm.trainable_mask())
    check(any(k.startswith("vera_shared/") and not on for k, on in mask.items()),
          "vera: no shared basis among the frozen leaves")
    res = dict(phase="vera", entry="paddlenlp_tpu_torch.peft.VeRAModel + trainer.Trainer", r=vm.vera_config.r,
               targets="q/k/v/o_proj (VeRAConfig defaults)", rows=len(ds), steps=len(losses),
               losses=[x[0] for x in losses], grad_norms=[x[1] for x in losses], wall_s=wall,
               step_s=wall / VERA_STEPS, trainable=trainable, total=total, frozen=report, kernel_launches=launches,
               sm90_launches=sm90, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               reduced=dict(model="Qwen2-1.5B, the train phase's weights", steps=VERA_STEPS,
                            data="the finetune phase's packed SFT rows (1 x 2048)"),
               seconds=time.perf_counter() - t_phase)
    emit(res)
    del trainer, vm, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


DPO_STEPS = 3


def phase_dpo(torch, np, fa, AutoModelForCausalLM, AutoTokenizer, workdir, seed, base_dir):
    """``DPOTrainer`` over ``AutoModelForCausalLM`` of the train phase's
    directory (fp32 masters, bf16 compute), its rows from
    ``load_preference_rows`` (``dpo`` mode), on ``dpo_argument.json`` cut to
    one card (no tp2 x sharding4, 1 x accumulation 2, 3 steps, no save;
    max_length 4096, prompt 2048, sigmoid, beta 0.1, lr 1e-6, recompute
    kept): step 1's loss is ln 2 within 1e-4 (policy and frozen reference are
    the same weights), every policy leaf moved while the reference stayed bit
    for bit (in storage of its own), the policy, reference and recomputed
    forwards and both
    backward kernels at [2, 4095, 12, 128] all on the Hopper flash route, and
    the three kernels against their plain versions at that shape
    (``flash_check``: T = 4095 is no multiple of a tile)."""
    import os

    from paddlenlp_tpu_torch.llm.alignment.data_utils import ListDataset, load_preference_rows
    from paddlenlp_tpu_torch.trainer import TrainingArguments
    from paddlenlp_tpu_torch.trl import DPOCriterion, DPOTrainer

    t_phase = time.perf_counter()
    with open(DPO_RECIPE) as f:
        recipe = json.load(f)
    data = os.path.join(workdir, "dpo_train.json")
    align_text(np, seed + 41, DPO_ROWS, {"src": (1900, 2100), "chosen": (1500, 2100), "rejected": (1500, 2100)},
               data)
    tok = AutoTokenizer.from_pretrained(base_dir)
    rows = load_preference_rows(data, tok, recipe["max_length"], recipe["max_prompt_length"], mode="dpo")
    model = AutoModelForCausalLM.from_pretrained(base_dir, dtype="bfloat16", param_dtype="float32", device=DEVICE)
    model.config.recompute = bool(recipe["recompute"])
    model.config.recompute_granularity = "full"
    cuts = dict(gradient_accumulation_steps=2, max_steps=DPO_STEPS, save_strategy="no", evaluation_strategy="no",
                do_eval=False, tensor_parallel_degree=1, sharding_parallel_degree=1, sharding="")
    keep = ("per_device_train_batch_size", "learning_rate", "warmup_steps", "logging_steps", "bf16")
    args = TrainingArguments(output_dir=os.path.join(workdir, "dpo_out"),
                             **{k: recipe[k] for k in keep if k in recipe}, **{**cuts, "seed": seed})
    reduced = {k: dict(recipe=recipe.get(k), run=v) for k, v in cuts.items() if recipe.get(k) != v}
    reduced["model"] = ("Qwen/Qwen2-1.5B (recipe: Qwen/Qwen2-7B: full-parameter DPO at 7B holds ~122 GB of fp32 "
                        "state), the train phase's weights; its own frozen copy as the reference")
    reduced["data"] = f"{DPO_ROWS} preference pairs over the pretraining corpus's chain, from --seed"
    losses, trainers = [], []
    from paddlenlp_tpu_torch.trainer import Trainer
    from paddlenlp_tpu_torch.transformers.conversion_utils import flatten_params

    before = {k: v.detach().clone() for k, v in flatten_params(model.params).items()}
    reset_counts(fa)

    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(losses, trainers)):
        trainer = DPOTrainer(model=model, dpo_criterion=DPOCriterion(beta=recipe["beta"],
                                                                      loss_type=recipe["loss_type"]),
                             args=args, train_dataset=ListDataset(rows), tokenizer=tok)
        trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, sm90 = dict(fa.LAUNCHES), dict(fa.LAUNCHES_SM90)
    trainers.clear()
    L = model.config.num_hidden_layers
    micro = DPO_STEPS * args.gradient_accumulation_steps
    # policy forward, its recompute under "full", the reference forward: 3 a micro-step and layer
    want = {"fwd": 3 * L * micro, "bwd_dq": L * micro, "bwd_dkv": L * micro}
    check(launches == want, f"dpo: flash launches {launches}, want {want}")
    check(sm90 == launches, f"dpo: Hopper-route launches {sm90}, want all {launches}")
    first = losses[0][0] if losses else float("nan")
    check(len(losses) == DPO_STEPS and all(math.isfinite(x[0]) for x in losses), f"dpo: losses {losses}")
    check(abs(first - math.log(2)) <= 1e-4, f"dpo: step 1's loss {first} is not ln 2 within 1e-4")
    live, ref = flatten_params(model.params), flatten_params(trainer.ref_params)
    check(sorted(ref) == sorted(before), "dpo: the reference's leaves are not the policy's")
    ref_same = [k for k in before if torch.equal(ref[k], before[k])]
    policy_moved = [k for k in before if not torch.equal(live[k].detach(), before[k])]
    shared = [k for k in before if ref[k].data_ptr() == live[k].data_ptr()]
    check(len(ref_same) == len(before) and not shared,
          f"dpo: {len(before) - len(ref_same)} reference leaves changed, {len(shared)} alias the policy's")
    check(len(policy_moved) == len(before), f"dpo: {len(before) - len(policy_moved)} policy leaves did not move")
    del trainer, before, live, ref
    gc.collect()
    torch.cuda.empty_cache()
    # the three kernels at the DPO forward's shape: q [2, 4095, 12, 128] over k/v [2, 4095, 2, 128]
    cfg = model.config
    T, N, K = rows[0]["chosen_input_ids"].shape[0] - 1, cfg.num_attention_heads, cfg.num_key_value_heads
    H = cfg.hidden_size // N
    del model
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator(device=DEVICE).manual_seed(seed + 43)
    q, do = (torch.randn(2, T, N, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(2, T, K, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    case = flash_check(torch, fa, "dpo T=4095", q, k, v, do, None, None, flush)
    del q, k, v, do, flush
    res = dict(phase="dpo", entry="paddlenlp_tpu_torch.trl.DPOTrainer", recipe=DPO_RECIPE, reduced=reduced,
               loss_type=recipe["loss_type"], beta=recipe["beta"], lr=args.learning_rate,
               rows=[2 * args.per_device_train_batch_size, T], accum=args.gradient_accumulation_steps,
               steps=len(losses), losses=[x[0] for x in losses], grad_norms=[x[1] for x in losses],
               first_minus_ln2=first - math.log(2), leaves=len(ref_same), ref_bitwise=True,
               policy_leaves_moved=len(policy_moved), wall_s=wall, step_s=wall / DPO_STEPS,
               kernel_launches=launches, sm90_launches=sm90, flash_case=case,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=time.perf_counter() - t_phase)
    emit(res)
    torch.cuda.empty_cache()
    return res


RM_STEPS = 2


def phase_rm(torch, np, AutoModelForSequenceClassification, AutoTokenizer, workdir, seed, base_dir):
    """``RewardTrainer`` over ``Qwen2ForSequenceClassification`` of the train
    phase's directory (``AutoModelForSequenceClassification``, ``num_labels``
    1: the causal checkpoint's ``score`` head initialized, its ``lm_head``
    left unread), 2 steps of 2 pairs at max_length 1024 with padding masks
    (the dense attention path); returns the trained classifier for PPO."""
    import os

    from paddlenlp_tpu_torch.llm.alignment.data_utils import ListDataset, load_preference_rows
    from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
    from paddlenlp_tpu_torch.transformers import Qwen2ForSequenceClassification
    from paddlenlp_tpu_torch.trl import RewardTrainer

    t_phase = time.perf_counter()
    data = os.path.join(workdir, "rm_train.json")
    align_text(np, seed + 51, RM_ROWS, {"src": (300, 500), "chosen": (200, 520), "rejected": (200, 520)}, data)
    tok = AutoTokenizer.from_pretrained(base_dir)
    rows = load_preference_rows(data, tok, 1024, 512, mode="rm")
    model = AutoModelForSequenceClassification.from_pretrained(base_dir, dtype="bfloat16", param_dtype="float32",
                                                               device=DEVICE, num_labels=1)
    check(type(model) is Qwen2ForSequenceClassification, f"rm: Auto gave a {type(model).__name__}")
    args = TrainingArguments(output_dir=os.path.join(workdir, "rm_out"), per_device_train_batch_size=2,
                             max_steps=RM_STEPS, learning_rate=1e-5, warmup_steps=0, logging_steps=1,
                             save_strategy="no", seed=seed)
    losses, trainers = [], []
    t0 = time.perf_counter()
    with patched(Trainer, "training_step", step_spy(losses, trainers)):
        trainer = RewardTrainer(model=model, args=args, train_dataset=ListDataset(rows), tokenizer=tok)
        trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainers.clear()
    check(len(losses) == RM_STEPS and all(math.isfinite(x[0]) for x in losses), f"rm: losses {losses}")
    with torch.no_grad():
        ids = torch.as_tensor(np.stack([r["chosen_input_ids"] for r in rows[:2]]), device=DEVICE)
        mask = torch.as_tensor(np.stack([r["chosen_attention_mask"] for r in rows[:2]]), device=DEVICE)
        scores = model(ids, attention_mask=mask).float()
    check(tuple(scores.shape) == (2, 1) and bool(torch.isfinite(scores).all()), f"rm: scores {scores}")
    res = dict(phase="rm", entry="paddlenlp_tpu_torch.trl.RewardTrainer", model=type(model).__name__,
               rows=[2 * args.per_device_train_batch_size, 1024], steps=len(losses), losses=[x[0] for x in losses],
               grad_norms=[x[1] for x in losses], wall_s=wall, step_s=wall / RM_STEPS,
               scores=scores[:, 0].tolist(), peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               reduced=dict(model="Qwen2-1.5B, the train phase's weights", steps=RM_STEPS, max_length=1024,
                            data=f"{RM_ROWS} preference pairs over the corpus's chain, from --seed"),
               seconds=time.perf_counter() - t_phase)
    emit(res)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res, model


PPO_NEW = 32


def phase_ppo(torch, np, pa, PagedInferenceModel, init_paged_pool, AutoModelForCausalLM, AutoTokenizer, workdir,
              seed, base_dir, reward_model):
    """``PPOTrainer`` in GRPO mode for 2 rounds: the policy and its frozen
    reference from the train phase's directory, the rm phase's classifier as
    the reward model; 2 prompts of 128-256 tokens a round, 4 rollouts each,
    32 new tokens, through one fp32 ``InferenceEngine`` (every paged launch
    on the fp32 entry, counted); in round 2 the engine's own paged model
    over one prompt (prefill and 4 decode steps) against a dense fp32
    forward of the updated policy at rel 1e-4: the rollout reads the live
    weights, which moved from the pre-update ones by far more. Round 1's
    first prefill and first decode launch are copied as the engine gives
    them to the kernel (q [8, T, 12, 128] fp32 over the fp32 pool) and the
    kernel is held against its plain version on them (``kernel_cases``,
    among the fp32 row's checked cases). Round 2's rollout runs under
    ``torch.profiler``: the paged kernel's device ms (its merges included)
    and every kernel's, beside the round's wall (``rollout_profile``)."""
    import os

    from paddlenlp_tpu_torch.trl import PPOConfig, PPOTrainer
    from paddlenlp_tpu_torch.trainer import TrainingArguments

    t_phase = time.perf_counter()
    tok = AutoTokenizer.from_pretrained(base_dir)
    data = os.path.join(workdir, "ppo_prompts.json")
    align_text(np, seed + 61, PPO_ROUNDS * PPO_PROMPTS, {"src": (128, 257)}, data)
    with open(data) as f:
        prompts = [{"input_ids": np.asarray(tok.encode(json.loads(line)["src"])[:256], np.int32)} for line in f]
    policy = AutoModelForCausalLM.from_pretrained(base_dir, dtype="bfloat16", param_dtype="float32", device=DEVICE)
    cfg = PPOConfig(num_rollouts_per_prompt=4, max_new_tokens=PPO_NEW, max_prompt_length=256)
    args = TrainingArguments(output_dir=os.path.join(workdir, "ppo_out"), per_device_train_batch_size=PPO_PROMPTS,
                             max_steps=PPO_ROUNDS, learning_rate=2e-5, warmup_steps=0, save_strategy="no",
                             seed=seed)
    trainer = PPOTrainer(model=policy, reward_model=reward_model, args=args, train_dataset=prompts, ppo_config=cfg)
    probe = [int(t) for t in prompts[PPO_PROMPTS]["input_ids"][:128]]
    with torch.no_grad():
        before = policy(torch.tensor([probe], device=DEVICE), dtype=torch.float32)[0, -1]
    rounds, live, profiled = [], {}, {}
    rollout, score, update = trainer.rollout, trainer._score, trainer._ppo_update

    def _rollout(batch_prompts):
        from torch.profiler import ProfilerActivity, profile

        if rounds:  # round 2: the engine's paged model over the updated weights
            with uncounted(pa), torch.no_grad():
                got, fed = paged_logits(torch, policy, PagedInferenceModel, init_paged_pool, probe, torch.float32, 4,
                                        infer=trainer._engine.infer)
                # the dense forward's rows at the prompt's last position and the 4 fed tokens
                want = policy(torch.tensor([fed], device=DEVICE), dtype=torch.float32)[0, len(probe) - 1:]
                live.update(rel_err=((got - want).abs().max() / want.abs().max()).item(),
                            moved=((want[0] - before).abs().max() / before.abs().max()).item())
        if not rounds:
            t0 = time.perf_counter()
            out = rollout(batch_prompts)
            torch.cuda.synchronize()
            rounds.append(dict(rollout_s=time.perf_counter() - t0, rows=list(out["input_ids"].shape),
                               new_tokens=int((out["labels"] != -100).sum())))
            return out
        # the device's activity only: recording the eager decode's ~50,000
        # host ops as well took ~45 s to gather after the round
        launched0 = pa.LAUNCHES
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = rollout(batch_prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rounds.append(dict(rollout_s=wall, rows=list(out["input_ids"].shape),
                           new_tokens=int((out["labels"] != -100).sum())))
        profiled.update(round=2, **rollout_profile(torch, prof, wall, pa.LAUNCHES - launched0))
        return out

    def _score(*a):
        r = score(*a)
        rounds[-1]["reward_mean"] = float(np.mean(r))
        return r

    def _update(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(*a)
        torch.cuda.synchronize()
        rounds[-1].update(update_s=time.perf_counter() - t0, loss=float(out["loss"]),
                          grad_norm=float(out["grad_norm"]))
        return out

    model_module = sys.modules[PagedInferenceModel.__module__]
    wrapper = model_module.ragged_paged_attention
    launched = {}

    def captured(q, pool_k, pool_v, block_tables, q_start, q_lens, **kw):
        shape = "decode" if q.shape[1] == 1 else "prefill"
        if shape not in launched:
            launched[shape] = dict(q=q.clone(), pool_k=pool_k.clone(), pool_v=pool_v.clone(),
                                   block_tables=block_tables.clone(), q_start=q_start.clone(),
                                   q_lens=q_lens.clone(), **kw)
        return wrapper(q, pool_k, pool_v, block_tables, q_start, q_lens, **kw)

    trainer.rollout, trainer._score, trainer._ppo_update = _rollout, _score, _update
    pa.LAUNCHES = pa.LAUNCHES_SM90 = pa.LAUNCHES_SM90_QUANT = pa.LAUNCHES_SM90_F32 = 0
    model_module.ragged_paged_attention = captured
    t0 = time.perf_counter()
    try:
        trainer.train()
        torch.cuda.synchronize()
    finally:
        model_module.ragged_paged_attention = wrapper
    wall = time.perf_counter() - t0
    launches, f32 = pa.LAUNCHES, pa.LAUNCHES_SM90_F32
    kernel_cases = []
    check(sorted(launched) == ["decode", "prefill"], f"ppo: the rollouts launched {sorted(launched)}")
    with uncounted(pa):
        for shape, inp in launched.items():
            name = f"ppo {shape} q float32 pool fp32"
            route = pa.kernel_route(inp["q"].dtype, inp["pool_k"].dtype)
            check(route == "sm90_f32", f"kernel {name}: on the {route} route")
            out = pa.ragged_paged_attention(**inp)
            again = pa.ragged_paged_attention(**inp)
            ref = pa.ragged_paged_attention_ref(**inp)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"kernel {name}: two launches differ")
            max_err, worst, rtol, atol = paged_error(torch, inp, out, ref, "float32", name)
            kernel_cases.append(dict(batch=f"ppo_rollout_{shape}", q="float32", pool="fp32", route=route,
                                     max_abs_err=max_err,
                                     rtol=rtol, atol=atol, worst_err_over_tol=worst,
                                     q_lens=inp["q_lens"].tolist(),
                                     contexts=(inp["q_start"] + inp["q_lens"]).tolist(),
                                     shapes=dict(q=list(inp["q"].shape), pool=list(inp["pool_k"].shape))))
            del out, again, ref
    del launched
    check(len(rounds) == PPO_ROUNDS and all(math.isfinite(r["loss"]) and math.isfinite(r["reward_mean"])
                                            for r in rounds), f"ppo: rounds {rounds}")
    check(launches > 0 and f32 == launches, f"ppo: {f32} of {launches} paged launches on the fp32 entry")
    # the trace may miss a kernel at the window's edge (923 of 924 in one run)
    check(profiled.get("paged_attention_launches", 0) > 0, f"ppo: the profiled round's trace holds no paged kernel "
                                                           f"({profiled})")
    check(live.get("rel_err", 1.0) <= LOGITS_REL_TOL, f"ppo: round 2's paged logits against the updated policy's "
                                                      f"dense ones: {live}")
    check(live["moved"] > 10 * live["rel_err"], f"ppo: round 1's update moved the logits too little to tell: {live}")
    res = dict(phase="ppo", entry="paddlenlp_tpu_torch.trl.PPOTrainer (GRPO)", rounds=rounds, wall_s=wall,
               prompts_a_round=PPO_PROMPTS, rollouts_a_prompt=cfg.num_rollouts_per_prompt, new_tokens=PPO_NEW,
               engine=dict(trainer._engine_kwargs, dtype="float32"), paged_launches=launches,
               f32_launches=f32, rollout_profile=profiled, kernel_cases=kernel_cases, live_weights=live,
               lr=args.learning_rate,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               reduced=dict(model="Qwen2-1.5B policy, reference and reward model (the train and rm phases')",
                            rounds=PPO_ROUNDS, prompts=f"{PPO_PROMPTS} a round of 128-256 tokens",
                            value_model="off (GRPO); the value-model mode runs in the CPU tests"),
               seconds=time.perf_counter() - t_phase)
    emit(res)
    del trainer, policy
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_alignment_phases(torch, np, fa, pa, seed, workdir, base_dir):
    """The PEFT and alignment phases in order, each from the train phase's
    saved model and tokenizer (``base_dir``), each freeing its models:
    ``finetune_lora``, ``finetune_prefix``, ``vera``, ``dpo``, ``rm`` and
    ``ppo``. Returns their results by phase."""
    from paddlenlp_tpu_torch.experimental import InferenceEngine, PagedInferenceModel, SamplingParams
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool
    from paddlenlp_tpu_torch.llm import run_finetune
    from paddlenlp_tpu_torch.serving import tenancy
    from paddlenlp_tpu_torch.trainer import TrainerCallback
    from paddlenlp_tpu_torch.transformers import (AutoModelForCausalLM, AutoModelForSequenceClassification,
                                                  AutoTokenizer, Qwen2ForCausalLM)

    out = {}
    torch.cuda.reset_peak_memory_stats()
    out["finetune_lora"] = phase_finetune_lora(torch, np, fa, pa, run_finetune, TrainerCallback, InferenceEngine,
                                               SamplingParams, tenancy, Qwen2ForCausalLM, workdir, seed, base_dir)
    torch.cuda.reset_peak_memory_stats()
    out["finetune_prefix"] = phase_finetune_prefix(torch, np, fa, run_finetune, TrainerCallback, workdir, seed,
                                                   base_dir)
    torch.cuda.reset_peak_memory_stats()
    out["vera"] = phase_vera(torch, np, fa, run_finetune, TrainerCallback, AutoModelForCausalLM, AutoTokenizer,
                             workdir, seed, base_dir)
    torch.cuda.reset_peak_memory_stats()
    out["dpo"] = phase_dpo(torch, np, fa, AutoModelForCausalLM, AutoTokenizer, workdir, seed, base_dir)
    torch.cuda.reset_peak_memory_stats()
    out["rm"], reward_model = phase_rm(torch, np, AutoModelForSequenceClassification, AutoTokenizer, workdir, seed,
                                       base_dir)
    torch.cuda.reset_peak_memory_stats()
    out["ppo"] = phase_ppo(torch, np, pa, PagedInferenceModel, init_paged_pool, AutoModelForCausalLM, AutoTokenizer,
                           workdir, seed, base_dir, reward_model)
    del reward_model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_training_phases(torch, np, fa, seed, tok_dir=None):
    """The training phases in order: ``train`` and ``train_profile``,
    ``train_resume``, ``train_recompute``, ``finetune``, ``finetune_predict``
    then the PEFT and alignment phases (``run_alignment_phases``) and
    ``fused_ce``. ``tok_dir`` is the saved tokenizer the ``train`` phase
    names (made here when None). Returns the results of ``train``,
    ``train_resume``, ``train_recompute``, ``finetune``,
    ``finetune_predict`` and the alignment phases (by phase), whose launches
    the kernels line counts."""
    import os

    from paddlenlp_tpu_torch.data import MMapIndexedDatasetBuilder
    from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
    from paddlenlp_tpu_torch.llm import run_finetune, run_pretrain
    from paddlenlp_tpu_torch.ops import paged_attention as pa
    from paddlenlp_tpu_torch.trainer import Trainer, TrainerCallback, TrainingArguments
    from paddlenlp_tpu_torch.transformers import AutoModelForCausalLM, Qwen2Config, Qwen2ForCausalLM

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        if tok_dir is None:
            tok_dir = os.path.join(workdir, "tokenizer")
            make_tokenizer(tok_dir)
        trainer, train, base = phase_train(torch, np, fa, run_pretrain, TrainerCallback, MMapIndexedDatasetBuilder,
                                           workdir, seed, tok_dir)
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
        # the resume pair's checkpoints are spent: free the disk they hold before the SFT save
        for d in ("out_ckpt", "out_resume"):
            shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)
        finetune, sft_dir, reference = phase_finetune(torch, np, fa, run_finetune, TrainerCallback, Qwen2ForCausalLM,
                                                      AutoModelForCausalLM, workdir, seed,
                                                      os.path.join(workdir, "out"))
        ft_predict = phase_finetune_predict(torch, pa, InferenceEngine, SamplingParams, sft_dir, reference)
        del reference
        gc.collect()
        torch.cuda.empty_cache()
        align = run_alignment_phases(torch, np, fa, pa, seed, workdir, os.path.join(workdir, "out"))
    phase_fused_ce(torch, seed)
    return train, resume, recompute, finetune, ft_predict, align


# ----------------------------------------------------------------------------- the MoE family: Mixtral
# mistralai/Mixtral-8x7B-v0.1 config.json (https://huggingface.co/mistralai/Mixtral-8x7B-v0.1/blob/main/config.json)
MIXTRAL_8X7B = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6, hidden_act="silu",
    initializer_range=0.02, num_local_experts=8, num_experts_per_tok=2, router_aux_loss_coef=0.02,
    sliding_window=None, tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)
MIXTRAL_GEN_LAYERS = 16  # 23.5B parameters, 47 GB in bf16: the whole 46.7B model does not fit the card
MIXTRAL_GEN = (4, 1024, 32)  # generate: rows, prompt tokens, new tokens
MIXTRAL_TRAIN_LAYERS = 2  # 3.17B parameters: fp32 masters, gradients and two AdamW moments come to ~51 GB
MIXTRAL_MICRO = (1, 4096)  # the Trainer step's micro-batch; 2 accumulated


def moe_generate(torch, fa, pa, cfg, model_cls, seed, gen, name):
    """``generate`` of an MoE model (``cfg``, random bf16 weights): greedy
    over ``gen`` = (rows, prompt tokens, new tokens), no kernel launched (the
    dense path's attention is the XLA-path counterpart). Its routing is recorded
    (``PinnedRouting``) and replayed in the checks, which run the dense path
    uncached over the stream it fed (an all-ones mask: generate's attention
    arithmetic) in bf16 and in fp32: top-k is discontinuous, and a rounding
    change of a router's input sends a near-tied token to another expert,
    which no rounding gate covers (the flipped share is printed, with the
    distances of the unpinned bf16 forward). Checks: (a) each row's greedy
    ids against the bf16 argmax along the stream, parting only where the two
    tokens' fp32 margin is within twice the bf16 distance there
    (``depth_divergence``'s gate; ``divergence``'s bf16 gate printed beside
    it); (b) the cached prefill's logits at each row's last prompt position
    within twice the uncached bf16 forward's distance from the fp32 one."""
    from paddlenlp_tpu_torch.transformers import moe_layers
    from paddlenlp_tpu_torch.transformers.cache_utils import init_cache

    t0 = time.perf_counter()
    model = model_cls.init_random(cfg, seed=seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, T, new = gen
    L, K = routed_layers(cfg), cfg.num_experts_per_tok  # L: the layers that route
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ids = torch.randint(3, cfg.vocab_size, (B, T), generator=g, device=DEVICE)
    pa.LAUNCHES = pa.LAUNCHES_SM90 = 0
    reset_counts(fa)
    routed = PinnedRouting(moe_layers)
    with routed:
        out, _, timing = timed_generate(torch, model, ids.cpu().numpy(), max_new_tokens=new)
    launches = dict(paged=pa.LAUNCHES, flash=sum(fa.LAUNCHES.values()))
    gates = [(launches == dict(paged=0, flash=0), f"{name} generate: kernels launched {launches}"),
             (len(routed.choices) == L * new, f"{name} generate: {len(routed.choices)} routings, want the prefill's "
                                              f"and {new - 1} decode steps' {L * new}")]
    # generate's routing laid over the tokens it fed: the prompt, then the first new - 1 generated tokens
    fed = PinnedRouting(moe_layers)
    fed.choices = [torch.cat([routed.choices[l].reshape(B, T, K)] + [routed.choices[L * s + l].reshape(B, 1, K)
                                                                    for s in range(1, new)], 1).reshape(-1, K)
                   for l in range(L)]
    stream = torch.cat([ids, out[:, :new - 1].to(DEVICE)], dim=1)
    ones = torch.ones_like(stream)
    with torch.no_grad():
        with PinnedRouting(moe_layers, replay=fed):
            lbf = model(stream, attention_mask=ones)[:, T - 1:]
        with PinnedRouting(moe_layers, replay=fed):
            l32 = model(stream, dtype=torch.float32, attention_mask=ones)[:, T - 1:]
        own = PinnedRouting(moe_layers)
        with own:
            lown = model(stream, attention_mask=ones)[:, T - 1:]
        prefill = PinnedRouting(moe_layers)
        prefill.choices = routed.choices[:L]
        with PinnedRouting(moe_layers, replay=prefill):
            cached = model(ids, cache=init_cache(cfg, B, T, dtype=torch.bfloat16, device=DEVICE))[0][:, -1]
    argmax, own_argmax = lbf.argmax(-1).tolist(), lown.argmax(-1).tolist()
    rows = {}
    for r in range(B):
        got = upto_eos(out[r].tolist(), cfg.eos_token_id)
        want = argmax[r][:len(got)]
        j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
        row = dict(tokens=len(got), equal=j is None,
                   own_routing_equal=own_argmax[r][:len(got)] == got,
                   own_routing_distance=bf16_distance(torch, l32[r, 0], lown[r, 0]))
        if j is not None:
            la, lb = l32[r, j, got[j]].item(), l32[r, j, want[j]].item()
            dist = bf16_distance(torch, l32[r, j], lbf[r, j])
            margin, gate = abs(la - lb), 2**-7 * max(abs(la), abs(lb)) + 1e-3
            row["divergence"] = dict(position=j, tokens=[got[j], want[j]], logits=[la, lb], margin=margin, gate=gate,
                                     within_gate=margin <= gate, bf16_distance=dist, depth_gate=2 * dist,
                                     within_depth_gate=margin <= 2 * dist)
            gates.append((margin <= 2 * dist, f"{name} generate: row {r} parts from the uncached argmax outside "
                                              f"twice the bf16 distance: {row['divergence']}"))
        plain_d, cached_d = bf16_distance(torch, l32[r, 0], lbf[r, 0]), bf16_distance(torch, l32[r, 0], cached[r])
        row.update(plain_bf16_distance=plain_d, cached_bf16_distance=cached_d,
                   same_top1=bool(cached[r].argmax() == l32[r, 0].argmax()))
        gates.append((cached_d <= 2 * plain_d, f"{name} generate: row {r}'s cached bf16 logits sit {cached_d} from "
                                               f"fp32, past twice the uncached bf16 distance {plain_d}"))
        rows[r] = row
    flipped = own.flips(fed)
    del model, cached, l32, lbf, lown, out, stream, routed, fed, own, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_hidden_layers, routed_layers=L, params=cfg_params(model_cls, cfg), init_s=init_s,
                batch=[B, T], new_tokens=new, dispatch=getattr(cfg, "moe_dispatch", "dense"), launches=launches,
                rows=rows, equal_rows=sum(v["equal"] for v in rows.values()), own_routing_flipped_choices=flipped,
                **timing), gates


def cfg_params(model_cls, cfg):
    return int(sum(math.prod(s) for s in model_cls.param_shapes(cfg).values()))


def routed_layers(cfg):
    """How many layers of ``cfg`` route tokens (each makes one top-k
    choice a forward): every layer of a Mixtral, DeepSeek-V2's MoE layers."""
    if getattr(cfg, "model_type", "") == "deepseek_v2":
        from paddlenlp_tpu_torch.transformers.deepseek_v2.modeling import moe_at

        return sum(moe_at(cfg, i) for i in range(cfg.num_hidden_layers))
    return cfg.num_hidden_layers


def moe_bf16_distance(got, want):
    """Two bf16 MoE outputs that round their products in different orders
    (the sparse dispatch rounds each weighted expert row before the sum over
    its top-k, the dense one sums the weighted rows in fp32): the error's
    norm over the output's norm (``rel_err``; one bf16 rounding is 2**-7),
    and the largest element's error beside it. Elementwise gates do not hold
    here: where a token's two expert rows cancel, one rounding of a summand
    is far larger than the sum."""
    d, w = (got.float() - want.float()), want.float()
    return dict(rel_err=(d.norm() / w.norm()).item(), max_abs_err=d.abs().max().item(),
                max_abs_want=w.abs().max().item())


def mixtral_layer(torch, MixtralConfig, seed):
    """One MoE layer at Mixtral-8x7B's widths (4096 -> 8 x 14336, top 2) over
    4096 tokens: fp32 dense and sparse (capacity E/K: no drop) against the
    per-expert loop within 1e-4 of the largest element (the summation order),
    the aux loss within rel 1e-5; bf16 sparse against bf16 dense within one
    bf16 rounding on the norm (``moe_bf16_distance``); each
    bf16 dispatch's forward, and the sparse one's backward at the default
    capacity, twice bit for bit; each dispatch's forward and the loop timed."""
    from paddlenlp_tpu_torch.transformers.moe_layers import moe_mlp, moe_mlp_loop

    E, K = MIXTRAL_8X7B["num_local_experts"], MIXTRAL_8X7B["num_experts_per_tok"]
    D, F = MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["intermediate_size"]
    cfgs = {(d, cf): MixtralConfig(**MIXTRAL_8X7B, moe_dispatch=d, moe_capacity_factor=cf)
            for d in ("dense", "sparse") for cf in (E / K, 2.0)}
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    std = MIXTRAL_8X7B["initializer_range"]
    x32 = torch.randn(1, MIXTRAL_MICRO[1], D, generator=g, device=DEVICE)
    leaves32 = {"gate/kernel": torch.randn(D, E, generator=g, device=DEVICE) * std,
                "w1": torch.randn(E, D, F, generator=g, device=DEVICE) * std,
                "w3": torch.randn(E, D, F, generator=g, device=DEVICE) * std,
                "w2": torch.randn(E, F, D, generator=g, device=DEVICE) * std}
    res, gates = dict(tokens=MIXTRAL_MICRO[1], experts=E, top_k=K, hidden=D, intermediate=F), []
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    with torch.no_grad():
        loop, loop_aux = moe_mlp_loop(cfgs["dense", 2.0], x32, leaves32["gate/kernel"], leaves32["w1"],
                                      leaves32["w3"], leaves32["w2"])
        res["fp32"] = dict(loop_ms=time_cuda(torch, lambda: moe_mlp_loop(
            cfgs["dense", 2.0], x32, leaves32["gate/kernel"], leaves32["w1"], leaves32["w3"], leaves32["w2"]),
            2, flush))
        for d in ("dense", "sparse"):
            out, aux = moe_mlp(cfgs[d, E / K], x32, None, leaves32.__getitem__)
            err = (out - loop).abs().max().item() / loop.abs().max().item()
            aux_rel = abs(aux.item() - loop_aux.item()) / abs(loop_aux.item())
            res["fp32"][d] = dict(rel_err=err, aux=aux.item(), loop_aux=loop_aux.item(), aux_rel_err=aux_rel,
                                  ms=time_cuda(torch, lambda: moe_mlp(cfgs[d, E / K], x32, None, leaves32.__getitem__),
                                               2, flush))
            gates.append((err <= 1e-4, f"mixtral layer fp32 {d}: {err} of the loop's largest element > 1e-4"))
            gates.append((aux_rel <= 1e-5, f"mixtral layer fp32 {d}: aux rel err {aux_rel} > 1e-5"))
            del out
        del loop
        x = x32.to(torch.bfloat16)
        leaves = {k: v if k == "gate/kernel" else v.to(torch.bfloat16) for k, v in leaves32.items()}
        del x32, leaves32
        torch.cuda.empty_cache()
        outs = {d: [moe_mlp(cfgs[d, E / K], x, None, leaves.__getitem__)[0] for _ in range(2)]
                for d in ("dense", "sparse")}
        worst = moe_bf16_distance(outs["sparse"][0], outs["dense"][0])
        res["bf16"] = dict(sparse_vs_dense=worst, same_bits={d: bool(torch.equal(*o)) for d, o in outs.items()},
                           ms={d: time_cuda(torch, lambda: moe_mlp(cfgs[d, cf], x, None, leaves.__getitem__), 5,
                                            flush) for d, cf in (("dense", 2.0), ("sparse", 2.0))})
        gates.append((worst["rel_err"] <= 2**-7, f"mixtral layer bf16: sparse parts from dense past one bf16 "
                                                 f"rounding ({worst})"))
        for d, same in res["bf16"]["same_bits"].items():
            gates.append((same, f"mixtral layer bf16 {d}: two launches differ"))
        del outs
    grads = []
    for _ in range(2):
        xs = x.clone().requires_grad_(True)
        ls = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
        out, aux = moe_mlp(cfgs["sparse", 2.0], xs, None, ls.__getitem__)
        (out.float().square().mean() + aux).backward()
        grads.append([out.detach(), xs.grad] + [ls[k].grad for k in sorted(ls)])
        del xs, ls, out, aux
    res["bf16"]["sparse_backward_same_bits"] = all(torch.equal(a, b) for a, b in zip(*grads))
    gates.append((res["bf16"]["sparse_backward_same_bits"], "mixtral layer bf16 sparse: two backwards differ"))
    del grads, x, leaves, flush
    gc.collect()
    torch.cuda.empty_cache()
    return res, gates


class PinnedRouting:
    """Every MoE layer's top-k choice (``moe_layers.route``: Mixtral's and
    DeepSeek-V2's routers), recorded in
    the order a forward makes them, or replayed from a recording: the
    replaying forward keeps its own router probabilities and takes the
    recorded experts, so a step that differs from another by rounding
    routes each token as the other did. ``flips(other)`` is the share of
    (layer, token) choices that differ from another recording."""

    def __init__(self, moe_layers, replay=None):
        self.moe_layers, self.replay, self.choices = moe_layers, replay, []

    def __enter__(self):
        route = self.orig = self.moe_layers.route

        def pinned(router_logits, top_k, norm_topk_prob, groups=None):
            probs, topk_probs, idx = route(router_logits, top_k, norm_topk_prob, groups=groups)
            if self.replay is not None:
                idx = self.replay.choices[len(self.choices)]
                topk_probs = probs.gather(1, idx)
                if norm_topk_prob:
                    topk_probs = topk_probs / topk_probs.sum(-1, keepdim=True).clamp_min(1e-9)
            self.choices.append(idx)
            return probs, topk_probs, idx

        self.moe_layers.route = pinned
        return self

    def __exit__(self, *exc):
        self.moe_layers.route = self.orig

    def flips(self, other):
        """The share of (layer, token) expert sets that differ from ``other``'s."""
        pairs = [(a.sort(dim=-1).values, b.sort(dim=-1).values) for a, b in zip(self.choices, other.choices)]
        return sum((a != b).any(-1).sum().item() for a, b in pairs) / sum(len(a) for a, _ in pairs)


def moe_train(torch, fa, modeling, causal_lm_loss, configs, model_cls, Trainer, TrainingArguments, seed, micro, tol,
              name, fp32_kernels=False):
    """An MoE model at a cut depth, bf16 compute over fp32 masters, for each
    of ``configs`` (name -> config: Mixtral's two dispatches, DeepSeek-V2's
    one): (a) the loss (LM + aux) and every gradient leaf of one
    ``micro`` forward and backward through the flash kernels against the
    same step with the plain attention, to ``tol`` (the
    ``BF16_STEP_TOL`` verdict printed beside it), with the
    bf16-vs-fp32 control outside it (``_grad_step``, as ``train_grad``),
    the routing of the kernel and fp32 steps pinned to the plain step's
    (``PinnedRouting``): top-k is discontinuous, and a rounding-level
    change of a router's input flips near-tied tokens to other experts,
    which moves whole rows of their gradients; the kernel step with its own
    routing is printed beside it, with the share of choices that flipped;
    (b) two ``Trainer`` steps of 2 accumulated ``micro`` micro-batches, the
    flash launches of the steps counted (all on the Hopper route), the
    second step's time, tokens/s, MFU (``get_model_flops``: every expert's
    parameters, the work of the dense dispatch) and the peak memory. With
    ``fp32_kernels`` (DeepSeek-V2, whose head_dim 192 only it reaches in
    fp32), also (a) the fp32 step through the kernels against the plain fp32
    step, routing replayed, at ``train_grad``'s fp32 gates (loss rel 1e-5,
    each leaf's worst element within 1e-4 of its largest), every launch on
    the fp32 route, and (b) two ``Trainer`` steps at the Trainer's default,
    ``bf16=False``: the model computes in fp32, every flash launch on the
    fp32 route, MFU over the fp32 peak (its GEMMs run in fp32: TF32 off)."""
    from paddlenlp_tpu_torch.transformers import moe_layers

    res, gates, launches, sm90, f32_route = {}, [], {}, {}, {}
    vocab = next(iter(configs.values())).vocab_size
    g = torch.Generator(device=DEVICE).manual_seed(seed + 2)
    ids = torch.randint(0, vocab, micro, generator=g, device=DEVICE)
    batch = {"input_ids": torch.randint(0, vocab, (2 * micro[0], micro[1]), generator=g, device=DEVICE).cpu().numpy()}
    batch["labels"] = batch["input_ids"]
    workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    for dispatch, cfg in configs.items():
        layers = cfg.num_hidden_layers

        def step(dtype, plain, routing):
            with routing:
                out = _grad_step(torch, fa, modeling, cfg, model_cls, causal_lm_loss, ids, seed, dtype, plain)
            gc.collect()  # a finished step's model sits in a reference cycle: free it before the next one
            torch.cuda.empty_cache()
            return out

        recorded = PinnedRouting(moe_layers)
        ref = step("bfloat16", True, recorded)
        free = PinnedRouting(moe_layers)
        kern = step("bfloat16", False, free)
        bf16_free = _step_errors(kern, ref)
        losses = dict(bf16_kernels_own_routing=kern[0], bf16_plain=ref[0])
        del kern
        kern = step("bfloat16", False, PinnedRouting(moe_layers, replay=recorded))
        bf16 = _step_errors(kern, ref)
        check_launches = dict(kernels=kern[2], kernels_sm90=kern[3])
        losses["bf16_kernels"] = kern[0]
        del kern
        f32 = step("float32", True, PinnedRouting(moe_layers, replay=recorded))
        control = _step_errors(ref, f32)
        losses["fp32_plain"] = f32[0]
        del ref
        fp32 = None
        if fp32_kernels:  # the fp32 step through the kernels, against the plain fp32 step
            kern = step("float32", False, PinnedRouting(moe_layers, replay=recorded))
            fp32 = dict(_step_errors(kern, f32), loss_rel_tol=1e-5, leaf_max_rel_tol=1e-4,
                        launches=dict(kernels=kern[2], kernels_sm90=kern[3], kernels_sm90_f32=kern[4]))
            losses["fp32_kernels"] = kern[0]
            del kern
            gates.append((fp32["loss_rel_err"] <= 1e-5,
                          f"{name} train {dispatch} fp32: kernels vs plain loss rel err {fp32['loss_rel_err']} > 1e-5"))
            gates.append((fp32["leaf_max"]["rel_err"] <= 1e-4,
                          f"{name} train {dispatch} fp32: kernels vs plain {fp32['leaf_max']} > 1e-4"))
            each, none = {"fwd": layers, "bwd_dq": layers, "bwd_dkv": layers}, {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0}
            gates.append((fp32["launches"]["kernels_sm90_f32"] == fp32["launches"]["kernels"] == each
                          and fp32["launches"]["kernels_sm90"] == none,
                          f"{name} train {dispatch} fp32: the checked step's launches {fp32['launches']}, want "
                          f"{each} on the fp32 route"))
        del f32
        gates.append((bf16["loss_rel_err"] <= tol["loss_rel"],
                      f"{name} train {dispatch}: kernels vs plain loss rel err {bf16['loss_rel_err']}"))
        for key, got, ctl in (("leaf_rel", bf16["leaf"]["rel_err"], control["leaf"]["rel_err"]),
                              ("all_rel", bf16["all_rel_err"], control["all_rel_err"])):
            gates.append((got <= tol[key], f"{name} train {dispatch}: kernels vs plain {key} {got} > {tol[key]}"))
            gates.append((ctl > tol[key], f"{name} train {dispatch}: the bf16-vs-fp32 control's {key} {ctl} is "
                                          f"inside {tol[key]}: the bound would not tell the kernels from bf16 "
                                          f"rounding"))
        want = {"fwd": layers, "bwd_dq": layers, "bwd_dkv": layers}
        gates.append((check_launches["kernels_sm90"] == want,
                      f"{name} train {dispatch}: the checked step's Hopper launches {check_launches}, want {want}"))

        def trainer_steps(compute):
            """Two optimizer steps of 2 accumulated micro-batches, the model
            computing in ``compute`` (bf16 over fp32 masters, or the Trainer's
            default: fp32, ``bf16=False``): the steps, the launches of each
            route, the model's aux loss after them."""
            model = model_cls.init_random(cfg, seed=seed, device=DEVICE, dtype=torch.float32)
            if compute == "bfloat16":
                model.compute_dtype = torch.bfloat16
            args = TrainingArguments(output_dir=workdir, per_device_train_batch_size=micro[0],
                                     gradient_accumulation_steps=2, learning_rate=1e-5, warmup_steps=1, max_steps=2,
                                     save_strategy="no", seed=seed)  # bf16 unset (False): the model computes in its compute_dtype
            trainer = Trainer(model=model, args=args)
            trainer.create_optimizer_and_scheduler(2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(fa)
            steps = []
            for _ in range(2):
                t0 = time.perf_counter()
                out = trainer.training_step(batch)
                torch.cuda.synchronize()
                steps.append(dict(step_s=time.perf_counter() - t0, loss=out["loss"].item(),
                                  grad_norm=out["grad_norm"].item()))
            counts = dict(kernels=dict(fa.LAUNCHES), sm90=dict(fa.LAUNCHES_SM90), sm90_f32=dict(fa.LAUNCHES_SM90_F32))
            peak = torch.cuda.max_memory_allocated() / 1e9
            with torch.no_grad():
                aux = model.forward(torch.from_numpy(batch["input_ids"][:1]).to(DEVICE), return_aux=True)[1].item()
            flops = model.get_model_flops(2 * micro[0], micro[1])
            del trainer, model, out
            gc.collect()
            torch.cuda.empty_cache()
            step_s = steps[-1]["step_s"]
            # the peak of the GEMMs' type: bf16 tensor cores, or fp32 outside them (TF32 is off)
            mfu_peak = "bfloat16" if compute == "bfloat16" else "float32"
            return dict(steps=steps, aux_after=aux, step_s=step_s, tokens_per_s=2 * micro[0] * micro[1] / step_s,
                        mfu=flops / step_s / PEAK_FLOPS[mfu_peak],
                        mfu_peak=f"{mfu_peak} {PEAK_FLOPS[mfu_peak] / 1e12:g} TFLOP/s", peak_mem_gb=peak), counts

        res[dispatch] = dict(
            grad_check=dict(bf16=dict(bf16, tol=tol,
                                      within_bf16_step_tol=bf16["leaf"]["rel_err"] <= BF16_STEP_TOL["leaf_rel"]
                                      and bf16["all_rel_err"] <= BF16_STEP_TOL["all_rel"]),
                            bf16_vs_fp32_control=control, losses=losses,
                            launches=check_launches, routing="pinned to the plain bf16 step's",
                            own_routing=dict(bf16=bf16_free, flipped_choices=free.flips(recorded))))
        if fp32_kernels:
            res[dispatch]["grad_check"]["fp32"] = fp32
        want = {"fwd": 4 * layers, "bwd_dq": 4 * layers, "bwd_dkv": 4 * layers}
        # bf16 compute on the bf16 route; with fp32_kernels, the Trainer's default fp32 on the fp32 route
        for compute, route in (("bfloat16", "sm90"), ("float32", "sm90_f32"))[:1 + fp32_kernels]:
            trained, counts = trainer_steps(compute)
            what = f"{name} train {dispatch}{' fp32' if compute == 'float32' else ''}"
            for n in counts["kernels"]:
                launches[n] = launches.get(n, 0) + counts["kernels"][n]
                for total, key in ((sm90, "sm90"), (f32_route, "sm90_f32")):
                    total[n] = total.get(n, 0) + counts[key][n]
            run = dict(**trained, flash_launches=counts["kernels"], **{f"{route}_launches": counts[route]})
            if compute == "bfloat16":
                res[dispatch].update(run)
            else:
                res[dispatch]["fp32_trainer"] = run
            gates.append((counts[route] == counts["kernels"] == want,
                          f"{what}: Trainer launches {counts['kernels']}, {route} route {counts[route]}, "
                          f"want {want}"))
            gates.append((all(math.isfinite(s["loss"]) for s in trained["steps"]) and trained["aux_after"] > 0,
                          f"{what}: steps {trained['steps']}, aux {trained['aux_after']}"))
    shutil.rmtree(workdir, ignore_errors=True)
    res.update(kernel_launches=launches, sm90_launches=sm90, sm90_f32_launches=f32_route)
    return res, gates


def mixtral_flash_case(torch, fa, seed):
    """The three flash kernels at the Trainer step's attention shape, q
    [1, 4096, 32, 128] over k/v [1, 4096, 8, 128] (a group of 4), causal,
    against their plain versions (``flash_check``)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    B, T = MIXTRAL_MICRO
    N, K = MIXTRAL_8X7B["num_attention_heads"], MIXTRAL_8X7B["num_key_value_heads"]
    H = MIXTRAL_8X7B["hidden_size"] // N
    q, do = (torch.randn(B, T, N, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, T, K, H, generator=g, device=DEVICE).to(torch.bfloat16) for _ in range(2))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    case = flash_check(torch, fa, "mixtral", q, k, v, do, None, None, flush)
    del q, k, v, do, flush
    torch.cuda.empty_cache()
    return case


def phase_mixtral(torch, fa, pa, modeling, seed):
    """Mixtral-8x7B at its published widths, depth cut (``PERF.md`` §4):
    ``generate`` at 16 layers (``mixtral_generate``), one MoE layer at full
    width (``mixtral_layer``), the flash kernels at the step's attention
    shape (``mixtral_flash_case``) and the Trainer step at 2 layers under
    each dispatch (``mixtral_train``)."""
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
    from paddlenlp_tpu_torch.transformers import MixtralConfig, MixtralForCausalLM

    t_phase = time.perf_counter()
    res = dict(config="mistralai/Mixtral-8x7B-v0.1 widths, random bf16 weights from --seed")
    gates = []

    def part(name, fn, *args):  # one JSON line a part, with the memory it leaves allocated
        out, more = fn(*args)
        gates.extend(more)
        emit(dict(phase=f"mixtral_{name}", **out, allocated_gb_after=torch.cuda.memory_allocated() / 1e9))
        return out

    gen_cfg = MixtralConfig(**{**MIXTRAL_8X7B, "num_hidden_layers": MIXTRAL_GEN_LAYERS})
    res["generate"] = part("generate", moe_generate, torch, fa, pa, gen_cfg, MixtralForCausalLM, seed, MIXTRAL_GEN,
                           "mixtral")
    res["layer"] = part("layer", mixtral_layer, torch, MixtralConfig, seed)
    res["flash_case"] = mixtral_flash_case(torch, fa, seed)
    train_cfgs = {d: MixtralConfig(**{**MIXTRAL_8X7B, "num_hidden_layers": MIXTRAL_TRAIN_LAYERS, "moe_dispatch": d})
                  for d in ("dense", "sparse")}
    res["train"] = part("train", moe_train, torch, fa, modeling, causal_lm_loss, train_cfgs, MixtralForCausalLM,
                        Trainer, TrainingArguments, seed, MIXTRAL_MICRO, MIXTRAL_STEP_TOL, "mixtral")
    res["seconds"] = time.perf_counter() - t_phase
    failed = [msg for ok, msg in gates if not ok]
    emit(dict(phase="mixtral", config=res["config"], seconds=res["seconds"], budget_s=75, gates=len(gates),
              failed=failed))
    for ok, msg in gates:
        check(ok, msg)
    return res


# ----------------------------------------------------------------------------- MLA and the grouped MoE: DeepSeek-V2
# deepseek-ai/DeepSeek-V2-Lite config.json (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json)
DEEPSEEK_V2_LITE = dict(
    vocab_size=102400, hidden_size=2048, intermediate_size=10944, moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, num_key_value_heads=16, kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
    first_k_dense_replace=1, moe_layer_freq=1, topk_method="greedy", n_group=1, topk_group=1, norm_topk_prob=False,
    routed_scaling_factor=1.0, scoring_func="softmax", aux_loss_alpha=0.001, seq_aux=True, hidden_act="silu",
    max_position_embeddings=163840, initializer_range=0.02, rms_norm_eps=1e-6, rope_theta=10000.0,
    rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096, beta_fast=32, beta_slow=1,
                      mscale=0.707, mscale_all_dim=0.707),
    attention_bias=False, tie_word_embeddings=False, bos_token_id=100000, eos_token_id=100001,
)
DEEPSEEK_GEN = (4, 1024, 32)  # generate at all 27 layers (15.7B parameters, 31.4 GB in bf16): rows, prompt, new
DEEPSEEK_TRAIN_LAYERS = 3  # layer 0 dense, 1-2 MoE: 1.67B parameters, ~27 GB of fp32 masters, grads and moments
DEEPSEEK_MICRO = (1, 4096)  # the Trainer step's micro-batch; 2 accumulated
# The bounds of the deepseek step's check (3 layers, [1, 4096], routing
# pinned to the plain step's), placed as MIXTRAL_STEP_TOL between the
# kernels' readings (leaf 0.0123-0.0127, all 0.0093-0.0094) and the
# bf16-vs-fp32 control's (leaf 0.0252-0.0257, all 0.0154-0.0156) over seeds
# 0-3 on an H100 (``tools/chip_smoke_deepseek.py --calibrate``; PERF.md).
# Both losses move <= 2e-5: the loss bound only catches gross errors.
DEEPSEEK_STEP_TOL = dict(loss_rel=1e-4, leaf_rel=1.9e-2, all_rel=1.2e-2)


def deepseek_layer(torch, DeepseekV2Config, seed):
    """One MoE layer at DeepSeek-V2-Lite's widths (2048 -> 64 x 1408, top 6,
    2 shared experts) over 4096 tokens: fp32 ``deepseek_moe`` against the
    per-expert loop with the shared experts and ``routed_scaling_factor``
    (``deepseek_moe_loop``) within 1e-4 of the largest element, the aux loss
    within rel 1e-5; bf16 twice bit for bit; the block and the loop timed."""
    from paddlenlp_tpu_torch.transformers.deepseek_v2.modeling import deepseek_moe, deepseek_moe_loop

    cfg = DeepseekV2Config(**DEEPSEEK_V2_LITE)
    E, K, D, F = cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.hidden_size, cfg.moe_intermediate_size
    Fs = F * cfg.n_shared_experts
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    std = cfg.initializer_range

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=DEVICE) * std

    x32 = torch.randn(1, DEEPSEEK_MICRO[1], D, generator=g, device=DEVICE)
    leaves32 = {"gate/kernel": randn(D, E), "gate_proj": randn(E, D, F), "up_proj": randn(E, D, F),
                "down_proj": randn(E, F, D), "shared_experts/gate_proj/kernel": randn(D, Fs),
                "shared_experts/up_proj/kernel": randn(D, Fs), "shared_experts/down_proj/kernel": randn(Fs, D)}

    def block(x, leaves):
        return deepseek_moe(cfg, x, lambda name, h: h @ leaves[name + "/kernel"].to(h.dtype), leaves.__getitem__)

    res = dict(tokens=DEEPSEEK_MICRO[1], experts=E, top_k=K, shared=cfg.n_shared_experts, hidden=D, intermediate=F)
    gates = []
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    with torch.no_grad():
        loop, loop_aux = deepseek_moe_loop(cfg, x32, leaves32)
        out, aux = block(x32, leaves32)
        err = (out - loop).abs().max().item() / loop.abs().max().item()
        aux_rel = abs(aux.item() - loop_aux.item()) / abs(loop_aux.item())
        res["fp32"] = dict(rel_err=err, aux=aux.item(), loop_aux=loop_aux.item(), aux_rel_err=aux_rel,
                           ms=time_cuda(torch, lambda: block(x32, leaves32), 2, flush),
                           loop_ms=time_cuda(torch, lambda: deepseek_moe_loop(cfg, x32, leaves32), 2, flush))
        gates.append((err <= 1e-4, f"deepseek layer fp32: {err} of the loop's largest element > 1e-4"))
        gates.append((aux_rel <= 1e-5, f"deepseek layer fp32: aux rel err {aux_rel} > 1e-5"))
        del out, loop
        x = x32.to(torch.bfloat16)
        leaves = {k: v if k == "gate/kernel" else v.to(torch.bfloat16) for k, v in leaves32.items()}
        del x32, leaves32
        torch.cuda.empty_cache()
        outs = [block(x, leaves)[0] for _ in range(2)]
        res["bf16"] = dict(same_bits=bool(torch.equal(*outs)), ms=time_cuda(torch, lambda: block(x, leaves), 5, flush))
        gates.append((res["bf16"]["same_bits"], "deepseek layer bf16: two launches differ"))
        del outs, x, leaves, flush
    gc.collect()
    torch.cuda.empty_cache()
    return res, gates


def deepseek_flash_case(torch, fa, seed):
    """The three flash kernels at head_dim 192, the Trainer step's attention
    shape: q/k/v [1, 4096, 16, 192] (MLA: qk_nope 128 + qk_rope 64, v padded
    up to them), causal, and at T 4095 with three packed segments, in bf16
    (the Hopper route) and in fp32 (the 3xTF32 route, the Trainer's default
    compute), against their plain versions (``flash_check``)."""
    g = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    N = DEEPSEEK_V2_LITE["num_attention_heads"]
    H = DEEPSEEK_V2_LITE["qk_nope_head_dim"] + DEEPSEEK_V2_LITE["qk_rope_head_dim"]
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    cases = []
    for dtype, prefix in ((torch.bfloat16, "deepseek"), (torch.float32, "deepseek fp32")):
        for suffix, T, segments in (("", DEEPSEEK_MICRO[1], False), (" tail segments", 4095, True)):
            q, k, v, do = (torch.randn(1, T, N, H, generator=g, device=DEVICE).to(dtype) for _ in range(4))
            seg = None
            if segments:  # three packed documents, boundaries off the 64-row tiles
                seg = torch.zeros(1, T, dtype=torch.int32, device=DEVICE)
                seg[:, T // 3 + 5:] = 1
                seg[:, (2 * T) // 3 + 11:] = 2
            cases.append(flash_check(torch, fa, prefix + suffix, q, k, v, do, seg, None, flush))
            del q, k, v, do, seg
    del flush
    torch.cuda.empty_cache()
    return cases


def phase_deepseek(torch, fa, pa, modeling, seed):
    """DeepSeek-V2-Lite at its published widths (``PERF.md`` §4):
    ``generate`` at all 27 layers (``moe_generate``), one MoE layer at full
    width (``deepseek_layer``), the bf16 and fp32 flash kernels at head_dim
    192 (``deepseek_flash_case``) and the Trainer step at 3 layers, at bf16
    compute and at the Trainer's default fp32 (``moe_train``)."""
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.trainer import Trainer, TrainingArguments
    from paddlenlp_tpu_torch.transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    t_phase = time.perf_counter()
    res = dict(config="deepseek-ai/DeepSeek-V2-Lite widths, random bf16 weights from --seed")
    gates = []

    def part(name, fn, *args):  # one JSON line a part, with the memory it leaves allocated
        out, more = fn(*args)
        gates.extend(more)
        emit(dict(phase=f"deepseek_{name}", **out, allocated_gb_after=torch.cuda.memory_allocated() / 1e9))
        return out

    cfg = DeepseekV2Config(**DEEPSEEK_V2_LITE)
    res["generate"] = part("generate", moe_generate, torch, fa, pa, cfg, DeepseekV2ForCausalLM, seed, DEEPSEEK_GEN,
                           "deepseek")
    res["layer"] = part("layer", deepseek_layer, torch, DeepseekV2Config, seed)
    res["flash_cases"] = deepseek_flash_case(torch, fa, seed)
    train_cfg = DeepseekV2Config(**{**DEEPSEEK_V2_LITE, "num_hidden_layers": DEEPSEEK_TRAIN_LAYERS})
    res["train"] = part("train", moe_train, torch, fa, modeling, causal_lm_loss, {"dense": train_cfg},
                        DeepseekV2ForCausalLM, Trainer, TrainingArguments, seed, DEEPSEEK_MICRO, DEEPSEEK_STEP_TOL,
                        "deepseek", True)  # and the fp32 step and Trainer
    res["seconds"] = time.perf_counter() - t_phase
    failed = [msg for ok, msg in gates if not ok]
    emit(dict(phase="deepseek", config=res["config"], seconds=res["seconds"], budget_s=40, gates=len(gates),
              failed=failed))
    for ok, msg in gates:
        check(ok, msg)
    return res


def disk_writes():
    """This process's bytes written (``/proc/self/io``): ``wchar`` passed to
    write calls (files, pipes and sockets: the checkpoints are nearly all of
    it), ``write_bytes`` that reached the block layer and
    ``cancelled_write_bytes`` of files deleted before writeback (both 0 on a
    file system that does not account them); None off Linux."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return None
    return {k: int(io[k]) for k in ("write_bytes", "cancelled_write_bytes", "wchar") if k in io}


# ----------------------------------------------------------------------------- main
T_START = time.perf_counter()  # the run's seconds on the disk line count from the import


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

    # one nvcc per source, all started together, before the device and
    # tokenizer lines. The MoE phases launch only the flash kernels: they run
    # once those are built, while the paged library, the longest build, finishes
    pool = ThreadPoolExecutor(len(_build.SOURCES))
    builds = {stem: pool.submit(_build.build, stem) for stem in _build.SOURCES}

    smi = nvidia_smi()
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda))
    check_tokenizer_libs(tokenizer_libs())

    def built(stem):
        b = builds[stem].result()
        log = b["log"]  # the ptxas report; None when a cached library has no saved log
        emit(dict(phase="build", source=_build.SOURCES[stem], seconds=b["seconds"], cached=b["cached"],
                  registers=None if log is None else sorted({int(r) for r in re.findall(r"Used (\d+) registers", log)}),
                  spills=None if log is None else any(
                      "0 bytes spill stores, 0 bytes spill loads" not in ln
                      for ln in log.splitlines() if "spill stores" in ln)))
        return b

    fresh = built("flash_attention_sm90")
    check(fresh["cached"] or fresh["seconds"] < 60, f"build: flash_attention_sm90.cu took {fresh['seconds']:.0f} s")
    built("flash_attention_sm90_f32")

    # ---- the MoE family: Mixtral-8x7B's widths, generate at 16 layers and a Trainer step at 2
    mixtral = phase_mixtral(torch, fa, pa, modeling, args.seed)
    # ---- MLA and the grouped MoE: DeepSeek-V2-Lite, generate at all 27 layers and a Trainer step at 3
    deepseek = phase_deepseek(torch, fa, pa, modeling, args.seed)
    emit(dict(phase="moe_done", allocated_gb=torch.cuda.memory_allocated() / 1e9))

    # ---- serving: the paged engine at Qwen2-7B width and depth
    built("paged_attention_sm90")
    pool.shutdown()
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
                         prof16, mono, mono_streams, args.seed)
    lora = phase_lora(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                      serving, LoRAModel, LoRAConfig, tenancy, args.seed)
    wquant = phase_wquant(torch, np, model, pa, InferenceEngine, SamplingParams, PagedInferenceModel, init_paged_pool,
                          serving, quantization, modeling, args.seed)
    phase_generate(torch, np, model, pa, fa, InferenceEngine, SamplingParams, mono_streams, args.seed, engine=mono)
    tok_home = tempfile.mkdtemp(prefix="chip_smoke_tokenizer_")
    tok = make_tokenizer(tok_home)
    predict = phase_predict(torch, np, model, pa, InferenceEngine, SamplingParams, tok, mono_streams, args.seed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit(dict(phase="serving_done", allocated_gb=torch.cuda.memory_allocated() / 1e9))

    # ---- training: run_pretrain, then run_finetune and its predictor, at Qwen2-1.5B width and depth
    flash = phase_flash_kernel(torch, fa, args.seed)
    grad = phase_train_grad(torch, fa, modeling, Qwen2Config, Qwen2ForCausalLM, causal_lm_loss, args.seed)
    train, resume, recompute, finetune, ft_predict, align = run_training_phases(torch, np, fa, args.seed, tok_home)
    shutil.rmtree(tok_home, ignore_errors=True)

    # paged rows: the wgmma entry (bf16 over bf16, the main path: times at
    # the decode call, the launch the engine makes most), the fp32 entry
    # (fp32 queries or pools: times at the ragged fp32 case) and the wgmma
    # quantized entry (bf16 over int8 and fp8: times at the int8 decode call).
    # Launches of the first are the engine runs', the serve, router, spec,
    # host_tier, lora, wquant, predict, finetune_predict and finetune_lora
    # (the trained adapter served) phases'; the fp32 entry's are the ppo
    # phase's fp32 rollouts (none of the serving phases'), whose first
    # prefill and decode launches count among its checked cases (the fp32
    # logits run and the fp32 references check it too); the quantized
    # entry's are the kv_quant phase's, whose launches all took it
    cases = cases + align["ppo"]["kernel_cases"]  # the fp32 entry on PPO's own launches
    by_batch = {(c["batch"], c["q"], c["pool"]): c for c in cases}
    kernels, checks = [], []
    served = align["finetune_lora"]["served"]
    sm90 = (mono["sm90_launches"] + chunked["sm90_launches"] + serve["sm90_launches"] + router["sm90_launches"]
            + spec["launches"]["paged_sm90"] + host["launches"]["paged_sm90"] + lora["launches"]["sm90"]
            + wquant["launches"]["sm90"] + predict["sm90_launches"] + ft_predict["sm90_launches"]
            + served["sm90_launches"])
    f32 = (mono["kernel_launches"] + chunked["kernel_launches"] + serve["kernel_launches"]
           + router["kernel_launches"] + spec["launches"]["paged"] + host["launches"]["paged"]
           + lora["launches"]["paged"] + wquant["launches"]["paged"] + predict["kernel_launches"] + ft_predict["kernel_launches"]
           + served["paged_launches"] - sm90 + kvq["launches"]["paged"] - kvq["launches"]["sm90_quant"]
           + align["ppo"]["f32_launches"])
    for route, timed_case, name, launches in (
            ("sm90", ("decode", "bfloat16", "bf16"), "ragged_paged_attention_sm90", sm90),
            ("sm90_f32", ("ragged", "float32", "fp32"), "ragged_paged_attention_sm90_f32", f32),
            ("sm90_quant", ("decode", "bfloat16", "int8"), "ragged_paged_attention_sm90_quant",
             kvq["launches"]["sm90_quant"])):
        timed = by_batch[timed_case]
        checked = [c for c in cases if c["route"] == route]
        # the fp32 entry's row: its fp32 outputs (bf16 queries over an fp32 pool give bf16 ones, in the check)
        held = [c for c in checked if route != "sm90_f32" or c["q"] == "float32"]
        kernels.append(dict(
            name=name, route="cuda", source="paddlenlp_tpu_torch/csrc/paged_attention_sm90.cu",
            replaces="paddlenlp_tpu/ops/pallas/paged_attention.py:56", launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in held), ms=timed["ms"], plain_ms=timed["plain_ms"],
            bound_ms=timed["bound_ms"], bound_by=timed["bound_by"], library_ms=timed["library_ms"]))
        info = dict(check="pass", cases=len(checked), timed_case=" ".join(timed_case),
                    worst_err_over_tol=max(c["worst_err_over_tol"] for c in checked))
        if route == "sm90":
            info.update(launched_by="engine, serve, router, spec, host_tier, lora, wquant, predict, finetune_predict, "
                                    "finetune_lora (the trained adapter served)",
                        predict_launches=predict["sm90_launches"], finetune_predict_launches=ft_predict["sm90_launches"],
                        finetune_lora_launches=served["sm90_launches"],
                        serve_launches=serve["sm90_launches"], router_launches=router["sm90_launches"],
                        spec_launches=spec["launches"]["paged_sm90"],
                        host_tier_launches=host["launches"]["paged_sm90"], lora_launches=lora["launches"]["sm90"],
                        wquant_launches=wquant["launches"]["sm90"],
                        launches_by_shape={k: mono["launches_by_shape"][k] + chunked["launches_by_shape"][k]
                                           for k in mono["launches_by_shape"]})
        elif route == "sm90_f32":
            info.update(launched_by="ppo (fp32 rollouts)", ppo_launches=align["ppo"]["f32_launches"],
                        ppo_cases={c["batch"]: c["worst_err_over_tol"] for c in align["ppo"]["kernel_cases"]},
                        ppo_round_paged_ms=align["ppo"]["rollout_profile"]["paged_attention_ms"],
                        ppo_round_wall_ms=align["ppo"]["rollout_profile"]["wall_ms"],
                        check_launches=logits["launches"]["float32"]["kernels"],
                        bound_fp32_rate_ms=timed["bound_fp32_rate_ms"],
                        bf16_q_max_abs_err=max([c["max_abs_err"] for c in checked if c["q"] != "float32"] or [0.0]),
                        times={f"{c['batch']} {c['q']} {c['pool']}": c["ms"] for c in checked if "ms" in c})
        else:
            fp8 = by_batch[("decode", "bfloat16", "fp8")]
            info.update(launched_by="kv_quant", fp8_decode_ms=fp8["ms"], fp8_decode_library_ms=fp8["library_ms"])
        checks.append(info)
    # flash rows: the bf16 Hopper kernels (the main path: times at its shape)
    # and the fp32 forward, dq and dk/dv's 3xTF32 kernels (times from the fp32
    # case; their bound at a third of the TF32 rate, the fp32 rate's beside
    # it; at head_dim 192 from the deepseek fp32 case). Launches are the
    # train, train_resume, train_recompute, finetune, vera, dpo, mixtral and
    # deepseek runs' on each route, and for the forward the spec phase's
    # draft forwards too: the fp32 route's are the deepseek phase's fp32
    # Trainer steps at head_dim 192 (the train_grad and deepseek fp32 steps
    # check it: check_launches). The finetune phase's packed-row case, the
    # dpo phase's T = 4095 case and the mixtral and deepseek phases' cases
    # count among the checked cases
    flash.append(finetune["flash_case"])
    flash.append(align["dpo"]["flash_case"])
    flash.append(mixtral["flash_case"])
    flash.extend(deepseek["flash_cases"])
    by_case = {c["case"]: c for c in flash}
    outputs = {"fwd": ("out", "lse"), "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}
    sources = {"sm90": "flash_attention_sm90.cu", "sm90_f32": "flash_attention_sm90_f32.cu"}
    rows = [("fwd", "sm90", 81, "flash_attention_fwd_sm90"), ("fwd", "sm90_f32", 81, "flash_attention_fwd_sm90_f32"),
            ("bwd_dq", "sm90", 187, "flash_attention_bwd_dq_sm90"),
            ("bwd_dq", "sm90_f32", 187, "flash_attention_bwd_dq_sm90_f32"),
            ("bwd_dkv", "sm90", 227, "flash_attention_bwd_dkv_sm90"),
            ("bwd_dkv", "sm90_f32", 227, "flash_attention_bwd_dkv_sm90_f32")]
    for what, route, line, name in rows:
        timed = by_case["main" if route == "sm90" else "fp32"]
        checked = [c for c in flash if c["routes"][what] == route]
        if route == "sm90":
            runs = (train, resume, recompute, finetune, align["vera"], align["dpo"], mixtral["train"],
                    deepseek["train"])
            launches = sum(r["sm90_launches"][what] for r in runs)
            if what == "fwd":
                launches += spec["launches"]["flash_fwd_sm90"]
        else:
            launches = deepseek["train"]["sm90_f32_launches"][what]
        kernels.append(dict(
            name=name, route="cuda", source="paddlenlp_tpu_torch/csrc/" + sources[route],
            replaces=f"paddlenlp_tpu/ops/pallas/flash_attention.py:{line}", launches=launches,
            max_abs_err=max(c["errors"][o]["max_abs_err"] for c in checked for o in outputs[what]),
            ms=timed["ms"][what],
            # the plain and the library backward each compute dq, dk and dv in one call
            plain_ms=timed["plain_fwd_ms"] if what == "fwd" else timed["plain_bwd_ms"],
            bound_ms=timed["bound_ms"][what], bound_by=timed["bound_by"][what],
            library_ms=timed["library_fwd_ms"] if what == "fwd" else timed["library_bwd_ms"]))
        info = dict(check="pass", cases=len(checked), timed_case=timed["case"],
                    worst_err_over_tol=max(c["errors"][o]["worst"] for c in checked for o in outputs[what]))
        if route == "sm90":
            h192 = by_case["deepseek"]
            info.update(launched_by="train, train_resume, train_recompute, finetune, vera, dpo, mixtral, deepseek"
                                    + (", spec (draft)" if what == "fwd" else ""),
                        train_launches=train["sm90_launches"][what], resume_launches=resume["sm90_launches"][what],
                        recompute_launches=recompute["sm90_launches"][what],
                        finetune_launches=finetune["sm90_launches"][what],
                        vera_launches=align["vera"]["sm90_launches"][what],
                        dpo_launches=align["dpo"]["sm90_launches"][what],
                        mixtral_launches=mixtral["train"]["sm90_launches"][what],
                        deepseek_launches=deepseek["train"]["sm90_launches"][what],
                        # head_dim 192 (the <192> tile plan), at DeepSeek-V2-Lite's step shape
                        h192=dict(case=h192["case"], q=h192["q"], ms=h192["ms"][what],
                                  plain_ms=h192["plain_fwd_ms"] if what == "fwd" else h192["plain_bwd_ms"],
                                  bound_ms=h192["bound_ms"][what], bound_by=h192["bound_by"][what],
                                  library_ms=h192["library_fwd_ms"] if what == "fwd" else h192["library_bwd_ms"],
                                  max_abs_err=max(c["errors"][o]["max_abs_err"] for c in deepseek["flash_cases"]
                                                  if c["dtype"] == "bfloat16" for o in outputs[what])))
        else:
            fp32_step = grad["launches"]["float32"]
            ds_step = deepseek["train"]["dense"]["grad_check"]["fp32"]["launches"]
            h192 = by_case["deepseek fp32"]
            info.update(launched_by="deepseek (its fp32 Trainer steps, head_dim 192)",
                        deepseek_launches=deepseek["train"]["sm90_f32_launches"][what],
                        check_launches=fp32_step["kernels"][what] + ds_step["kernels"][what],
                        check_launches_on_route=fp32_step["kernels_sm90_f32"][what] + ds_step["kernels_sm90_f32"][what],
                        times={c["case"]: c["ms"][what] for c in checked if "ms" in c},
                        bound_fp32_rate_ms=timed["bound_fp32_rate_ms"][what],
                        # head_dim 192 (the <192> plan: the head dim split over warp pairs)
                        h192=dict(case=h192["case"], q=h192["q"], ms=h192["ms"][what],
                                  plain_ms=h192["plain_fwd_ms"] if what == "fwd" else h192["plain_bwd_ms"],
                                  bound_ms=h192["bound_ms"][what], bound_by=h192["bound_by"][what],
                                  bound_fp32_rate_ms=h192["bound_fp32_rate_ms"][what],
                                  library_ms=h192["library_fwd_ms"] if what == "fwd" else h192["library_bwd_ms"],
                                  max_abs_err=max(c["errors"][o]["max_abs_err"] for c in deepseek["flash_cases"]
                                                  if c["dtype"] == "float32" for o in outputs[what])))
            if what != "fwd":
                info.update(bwd_dq_plus_dkv_ms=timed["ms"]["bwd_dq"] + timed["ms"]["bwd_dkv"])
        checks.append(info)
    emit(dict(phase="kernels", kernels=[dict(k, **c) for k, c in zip(kernels, checks)]))
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    check(not idle, f"kernels: {idle} launched no time on the main path")
    writes = disk_writes()
    emit(dict(phase="disk", **(writes or {}), limit_bytes=45 * 2**30, seconds=time.perf_counter() - T_START))
    check(writes is None or max(writes.values()) <= 45 * 2**30, f"disk: {writes} past the 45 GiB a run may write")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
