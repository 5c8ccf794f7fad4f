"""The ``generate`` phase of ``chip_smoke.py`` alone, on one CUDA card.

Builds the paged-attention sources (the engine's reference streams run the
paged kernel), makes the serving phases' Qwen2-7B from ``--seed``, runs the
``engine`` phase for its greedy streams, then ``phase_generate`` and the
wint8 facade's ``wquant_generate`` against its own engine, with the same
checks, printing their JSON lines: a shorter run for work on ``generate``.
With ``--paths`` it runs instead the diagnostic behind
``chip_smoke.depth_divergence``'s gate: the last-position logits of four
prompts of the engine mix by four bf16 paths (the plain dense forward, the
cached dense forward, ``generate``'s left-padded [8, 2048] prefill and the
paged engine's prefill) against the fp32 dense forward, each path's
distance from it (over the fp32 top-20 tokens, over all tokens, mean) and
its pick. From the root of a checkout:

    python3 tools/chip_smoke_generate.py [--seed 0] [--paths]
"""

import argparse
import faulthandler
import os
import sys
import time


def bf16_paths(torch, np, cs, model, seed, which=(0, 1, 2, 7)):
    """One JSON line: for each prompt of ``which``, the fp32 dense forward's
    top-2 logits and pick, and each bf16 path's pick and distance from it."""
    from paddlenlp_tpu_torch.experimental import PagedInferenceModel
    from paddlenlp_tpu_torch.experimental.paged_cache import init_paged_pool
    from paddlenlp_tpu_torch.transformers.cache_utils import init_cache

    dev = cs.DEVICE
    prompts, _sampled = cs.traffic(np, model.config.vocab_size, seed)
    ids, mask = cs.left_pad(np, prompts)
    B, T0 = ids.shape
    m = torch.tensor(mask, device=dev)
    kv = init_cache(model.config, B, T0 + cs.GEN_NEW, dtype=torch.bfloat16, device=dev)
    full = torch.cat([m, torch.ones(B, cs.GEN_NEW, dtype=m.dtype, device=dev)], dim=1)
    batch, _ = model(torch.tensor(ids, device=dev), attention_mask=full,
                     position_ids=torch.clamp_min(torch.cumsum(m, dim=1) - 1, 0), cache=kv)
    batch = batch[:, -1].float()
    del kv
    rows = []
    for i in which:
        p = [int(t) for t in prompts[i]]
        t = torch.tensor([p], device=dev)
        l32 = model(t, dtype=torch.float32)[0, -1]
        kv = init_cache(model.config, 1, len(p), dtype=torch.bfloat16, device=dev)
        cached, _ = model(t, attention_mask=torch.ones_like(t), cache=kv)
        engine, _ = cs.paged_logits(torch, model, PagedInferenceModel, init_paged_pool, p, torch.bfloat16, 0)
        top = l32.topk(cs.TOP_K_DISTANCE).indices
        row = dict(prompt=i, tokens=len(p), fp32_pick=int(l32.argmax()), fp32_top2=l32.topk(2).values.tolist())
        for name, lb in (("plain", model(t)[0, -1]), ("cached", cached[0, -1]), ("generate_batch", batch[i]),
                         ("engine", engine[0])):
            lb = lb.float()
            row[name] = dict(pick=int(lb.argmax()), top20_distance=(lb[top] - l32[top]).abs().max().item(),
                             max_distance=(lb - l32).abs().max().item(), mean_distance=(lb - l32).abs().mean().item())
        rows.append(row)
    cs.emit(dict(phase="bf16_paths", config="Qwen/Qwen2-7B", rows=rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", action="store_true", help="the bf16 paths' distances from fp32 instead of the phase")
    args = ap.parse_args(argv)
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_generate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddlenlp_tpu_torch import quantization
    from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa
    from paddlenlp_tpu_torch.ops import paged_attention as pa
    from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi())
    cs.emit(dict(phase="build", source=_build.SOURCES["paged_attention_sm90"],
                 seconds=_build.build("paged_attention_sm90")["seconds"]))
    t0 = time.perf_counter()
    model = Qwen2ForCausalLM.init_random(Qwen2Config(**cs.QWEN2_7B), seed=args.seed, device=cs.DEVICE,
                                         dtype=torch.bfloat16)
    if args.paths:
        bf16_paths(torch, np, cs, model, args.seed)
        cs.emit(dict(phase="done", seconds=time.perf_counter() - t0))
        return 0
    mono = {}
    engine = cs.phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, args.seed, None, mono)
    cs.phase_generate(torch, np, model, pa, fa, InferenceEngine, SamplingParams, mono, args.seed, engine=engine)
    prompts, sampled = cs.traffic(np, model.config.vocab_size, args.seed)
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    qm = quantization.QuantizedModel(model, quantization.QuantizationConfig(weight_quantize_algo="wint8"))
    eng = InferenceEngine(qm, **cs.SERVE_ENGINE)
    done, _wall = cs.serve_waves(torch, eng, prompts, lambda i: SamplingParams(max_new_tokens=cs.WQUANT_NEW),
                                 [[0], range(1, len(prompts))])
    del eng
    out = cs.wquant_generate(torch, np, qm, prompts, done, greedy[1:3])
    cs.emit(dict(phase="wquant_generate", **out))
    for i, d in out["diverged"].items():
        cs.check(d["within_depth_gate"], f"wquant generate: prompt {i} parts outside twice the bf16 distance: {d}")
    cs.emit(dict(phase="done", seconds=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
