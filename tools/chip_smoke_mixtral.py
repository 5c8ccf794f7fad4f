"""The ``mixtral`` phase of ``chip_smoke.py`` alone, on one CUDA card.

Builds ``flash_attention_sm90.cu`` and runs ``chip_smoke.phase_mixtral``
(``generate`` at 16 of Mixtral-8x7B's layers, one MoE layer at full width,
the flash kernels at the step's attention shape, the Trainer step at 2
layers under each dispatch) with the same checks, printing its JSON lines:
a shorter run for work on the MoE family. With ``--calibrate`` it runs
instead the readings behind ``chip_smoke.MIXTRAL_STEP_TOL``: the mixtral
step's kernels-vs-plain and bf16-vs-fp32 distances (routing pinned to the
plain step's) for seeds 0-3 under each dispatch, and the Qwen2-1.5B step of
``train_grad`` (2 layers) at its [2, 1024] and at [1, 4096] beside them.
From the root of a checkout:

    python3 tools/chip_smoke_mixtral.py [--seed 0] [--calibrate]
"""

import argparse
import faulthandler
import gc
import os
import sys


def calibrate(torch, cs, fa, modeling):
    from paddlenlp_tpu_torch.ops.cross_entropy import causal_lm_loss
    from paddlenlp_tpu_torch.transformers import (MixtralConfig, MixtralForCausalLM, Qwen2Config, Qwen2ForCausalLM,
                                                  moe_layers)

    def step(cfg, model_cls, ids, seed, dtype, plain, routing=None):
        with routing or cs.PinnedRouting(moe_layers):
            out = cs._grad_step(torch, fa, modeling, cfg, model_cls, causal_lm_loss, ids, seed, dtype, plain)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    def reading(**kw):
        e, c = kw.pop("kernels"), kw.pop("control")
        cs.emit(dict(kw, loss=e["loss_rel_err"], leaf=e["leaf"]["rel_err"], all=e["all_rel_err"],
                     control_loss=c["loss_rel_err"], control_leaf=c["leaf"]["rel_err"],
                     control_all=c["all_rel_err"]))

    for seed in range(4):
        for dispatch in ("dense", "sparse"):
            cfg = MixtralConfig(**{**cs.MIXTRAL_8X7B, "num_hidden_layers": cs.MIXTRAL_TRAIN_LAYERS,
                                   "moe_dispatch": dispatch})
            g = torch.Generator(device=cs.DEVICE).manual_seed(seed + 2)
            ids = torch.randint(0, cfg.vocab_size, cs.MIXTRAL_MICRO, generator=g, device=cs.DEVICE)
            rec = cs.PinnedRouting(moe_layers)
            ref = step(cfg, MixtralForCausalLM, ids, seed, "bfloat16", True, rec)
            kern = step(cfg, MixtralForCausalLM, ids, seed, "bfloat16", False, cs.PinnedRouting(moe_layers, rec))
            kernels = cs._step_errors(kern, ref)
            del kern
            f32 = step(cfg, MixtralForCausalLM, ids, seed, "float32", True, cs.PinnedRouting(moe_layers, rec))
            reading(phase="calibrate", config="Mixtral-8x7B widths, 2 layers", dispatch=dispatch, seed=seed,
                    tokens=list(ids.shape), kernels=kernels, control=cs._step_errors(ref, f32))
            del ref, f32
    for shape in ((2, 1024), (1, 4096)):
        cfg = Qwen2Config(**{**cs.QWEN2_1_5B, "num_hidden_layers": 2})
        g = torch.Generator(device=cs.DEVICE).manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, shape, generator=g, device=cs.DEVICE)
        ref = step(cfg, Qwen2ForCausalLM, ids, 0, "bfloat16", True)
        kern = step(cfg, Qwen2ForCausalLM, ids, 0, "bfloat16", False)
        kernels = cs._step_errors(kern, ref)
        del kern
        f32 = step(cfg, Qwen2ForCausalLM, ids, 0, "float32", True)
        reading(phase="calibrate", config="Qwen2-1.5B widths, 2 layers", seed=0, tokens=list(shape),
                kernels=kernels, control=cs._step_errors(ref, f32))
        del ref, f32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate", action="store_true",
                    help="the step check's readings over seeds 0-3 instead of the phase")
    args = ap.parse_args(argv)
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, os.getcwd())

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_mixtral: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa
    from paddlenlp_tpu_torch.ops import paged_attention as pa
    from paddlenlp_tpu_torch.transformers.llama import modeling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    build = _build.build("flash_attention_sm90")
    cs.emit(dict(phase="build", source=_build.SOURCES["flash_attention_sm90"], seconds=build["seconds"],
                 cached=build["cached"]))
    if args.calibrate:
        calibrate(torch, cs, fa, modeling)
    else:
        cs.phase_mixtral(torch, fa, pa, modeling, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
