"""The ``deepseek`` phase of ``chip_smoke.py`` alone, on one CUDA card.

Builds both flash sources, ``flash_attention_sm90.cu`` (bf16) and
``flash_attention_sm90_f32.cu`` (fp32), one ``nvcc`` each, started together
(printing each ``<192>`` instantiation's registers and spills from its
``-Xptxas -v`` log), and runs ``chip_smoke.phase_deepseek`` (``generate`` at
all 27 of DeepSeek-V2-Lite's layers, one MoE layer at full width, the bf16
and fp32 flash kernels at head_dim 192, the Trainer step at 3 layers at
bf16 compute and at the default fp32, with the fp32 step checked against
the plain one) with the same checks, printing its JSON lines: a shorter
run for work on DeepSeek-V2. With ``--calibrate`` it runs, before the phase, the readings
behind ``chip_smoke.DEEPSEEK_STEP_TOL``: the step's kernels-vs-plain and
bf16-vs-fp32 distances (routing pinned to the plain step's) for seeds 0-3.
From the root of a checkout:

    python3 tools/chip_smoke_deepseek.py [--seed 0] [--calibrate]
"""

import argparse
import faulthandler
import gc
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

FLASH = ("flash_attention_sm90", "flash_attention_sm90_f32")


def usage_192(log):
    """{kernel<192>: [registers, spill stores, spill loads]} from a ptxas report."""
    usage, entry = {}, None
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_(?:fwd|bwd)\w+?)ILi(\d+)E", line)
        if m:
            entry = f"{m.group(1)}<{m.group(2)}>" if m.group(2) == "192" else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            usage[entry] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            usage[entry] = [int(m.group(1))] + usage.get(entry, [0, 0])[-2:]
    return usage


def calibrate(torch, cs, fa, modeling):
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers import DeepseekV2Config, DeepseekV2ForCausalLM, moe_layers

    cfg = DeepseekV2Config(**{**cs.DEEPSEEK_V2_LITE, "num_hidden_layers": cs.DEEPSEEK_TRAIN_LAYERS})

    def step(ids, seed, dtype, plain, routing):
        with routing:
            out = cs._grad_step(torch, fa, modeling, cfg, DeepseekV2ForCausalLM, causal_lm_loss, ids, seed, dtype,
                                plain)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    for seed in range(4):
        g = torch.Generator(device=cs.DEVICE).manual_seed(seed + 2)
        ids = torch.randint(0, cfg.vocab_size, cs.DEEPSEEK_MICRO, generator=g, device=cs.DEVICE)
        rec = cs.PinnedRouting(moe_layers)
        ref = step(ids, seed, "bfloat16", True, rec)
        kern = step(ids, seed, "bfloat16", False, cs.PinnedRouting(moe_layers, rec))
        e = cs._step_errors(kern, ref)
        del kern
        f32 = step(ids, seed, "float32", True, cs.PinnedRouting(moe_layers, rec))
        c = cs._step_errors(ref, f32)
        del ref, f32
        cs.emit(dict(phase="calibrate", config=f"DeepSeek-V2-Lite widths, {cfg.num_hidden_layers} layers", seed=seed,
                     tokens=list(ids.shape), loss=e["loss_rel_err"], leaf=e["leaf"]["rel_err"], all=e["all_rel_err"],
                     control_loss=c["loss_rel_err"], control_leaf=c["leaf"]["rel_err"],
                     control_all=c["all_rel_err"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate", action="store_true", help="first, the step check's readings over seeds 0-3")
    args = ap.parse_args(argv)
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_deepseek: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa
    from paddlenlp_tpu_torch.ops import paged_attention as pa
    from paddlenlp_tpu_torch.transformers.llama import modeling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    with ThreadPoolExecutor(len(FLASH)) as pool:
        builds = dict(zip(FLASH, pool.map(_build.build, FLASH)))
    for stem, build in builds.items():
        usage = usage_192(build["log"])  # kernel<192> -> (registers, spill stores, spill loads)
        cs.emit(dict(phase="build", source=_build.SOURCES[stem], seconds=build["seconds"], cached=build["cached"],
                     registers_spill_stores_loads=usage, spills=any(u[1] or u[2] for u in usage.values())))
    if args.calibrate:  # first: the phase stops at a failed gate
        calibrate(torch, cs, fa, modeling)
    cs.phase_deepseek(torch, fa, pa, modeling, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
