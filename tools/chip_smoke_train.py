"""The training phases of ``chip_smoke.py`` alone, on one CUDA card.

Builds the kernel sources (one ``nvcc`` each, started together) and runs
``chip_smoke``'s ``run_training_phases`` (``train``, ``train_profile``,
``train_resume``, ``train_recompute``, ``finetune``, ``finetune_predict``,
``fused_ce``) with the same checks, printing their JSON lines: a shorter run
for work on the training path. From the root of a checkout:

    python3 tools/chip_smoke_train.py [--seed 0]
"""

import argparse
import faulthandler
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    cs.run_training_phases(torch, np, fa, args.seed)
    cs.emit(dict(phase="done", seconds=time.perf_counter() - t0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
