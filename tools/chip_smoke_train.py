"""The training phases of ``chip_smoke.py`` alone, on one CUDA card.

Builds the kernel sources (one ``nvcc`` each, started together) and runs
``chip_smoke``'s ``run_training_phases`` (``train``, ``train_profile``,
``train_resume``, ``train_recompute``, ``finetune``, ``finetune_predict``,
the PEFT and alignment phases, ``fused_ce``) with the same checks, printing
their JSON lines: a shorter run for work on the training path. With
``--alignment-only`` it runs only ``run_alignment_phases`` (``finetune_lora``,
``finetune_prefix``, ``vera``, ``dpo``, ``rm``, ``ppo``) from a Qwen2-1.5B
with random weights from ``--seed``, saved with the tokenizer, and the
finetune phase's SFT rows. From the root of a checkout:

    python3 tools/chip_smoke_train.py [--seed 0] [--alignment-only]
"""

import argparse
import faulthandler
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alignment-only", action="store_true", help="only the PEFT and alignment phases")
    args = ap.parse_args(argv)
    faulthandler.enable(all_threads=True)
    sys.path.insert(0, os.getcwd())

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke_train: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    from concurrent.futures import ThreadPoolExecutor

    print(cs.nvidia_smi())
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:
        for stem, b in zip(_build.SOURCES, pool.map(_build.build, _build.SOURCES)):
            cs.emit(dict(phase="build", source=_build.SOURCES[stem], seconds=b["seconds"]))
    cs.check_tokenizer_libs(cs.tokenizer_libs())
    t0 = time.perf_counter()
    if args.alignment_only:
        import tempfile

        from paddlenlp_tpu_torch.ops import paged_attention as pa
        from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM

        with tempfile.TemporaryDirectory(prefix="chip_smoke_align_") as workdir:
            base = os.path.join(workdir, "out")
            model = Qwen2ForCausalLM.from_config(Qwen2Config(**cs.QWEN2_1_5B), seed=args.seed, device=cs.DEVICE)
            model.save_pretrained(base)
            del model
            cs.make_tokenizer(base)
            cs.sft_data(np, os.path.join(workdir, "sft_data"), args.seed, cs.SFT_ROWS, cs.SFT_DEV_ROWS)
            cs.run_alignment_phases(torch, np, fa, pa, args.seed, workdir, base)
    else:
        cs.run_training_phases(torch, np, fa, args.seed)
    cs.emit(dict(phase="done", seconds=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
