"""Time the paged engine's serving mix of one or more checkouts on one CUDA card, in turns.

From the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/engine_compare.py [--root DIR ...] [--rounds 2] [--seed 0]

Each root (default: this checkout) runs in a subprocess of its own, which
imports that root's ``paddlenlp_tpu_torch`` and ``chip_smoke``, builds its
paged-attention library, draws Qwen2-7B at its published widths and depth
(random bf16 weights from ``--seed``) and runs ``chip_smoke.phase_engine``'s
mix twice (8 requests of 256-2048 tokens, 64 new tokens each, monolithic
prefill; the first run warms up) and one profiled decode call
(``chip_smoke.phase_profile``). It prints the second mix's wall, tokens/s
and TPOT p50, the decode call's wall and device ms, and a digest of the
mix's streams: two roots that serve the same function print the same
digest. The roots run in turns, ``--rounds`` times over (A, B, B, A for two
roots and two rounds), one JSON line each; the card's name and power limit
come first. Compare two commits by giving the parent's ``git archive`` as the
first root and this checkout as the second.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(root, seed):
    """One root's readings (in the subprocess that imported it)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddlenlp_tpu_torch.experimental import InferenceEngine, SamplingParams
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import paged_attention as pa
    from paddlenlp_tpu_torch.transformers import Qwen2Config, Qwen2ForCausalLM

    build = _build.build("paged_attention_sm90")
    model = Qwen2ForCausalLM.init_random(Qwen2Config(**cs.QWEN2_7B), seed=seed, device="cuda",
                                         dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        streams = {}
        runs.append(cs.phase_engine(torch, np, model, pa, InferenceEngine, SamplingParams, seed, None, streams))
    prof = cs.phase_profile(torch, np, model, pa, InferenceEngine, SamplingParams, seed)
    digest = hashlib.sha256(json.dumps(sorted(streams.items())).encode()).hexdigest()[:16]
    last = runs[-1]
    return dict(root=root, build_s=build["seconds"], mix_wall_s=last["wall_s"], tokens_per_s=last["tokens_per_s"],
                tpot_ms_p50=last["tpot_ms_p50"], warm_up_wall_s=runs[0]["wall_s"],
                decode_call_wall_ms=prof["wall_ms"], decode_call_device_ms=prof["device_ms"], streams=digest)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout to run (repeat; default: this one)")
    ap.add_argument("--rounds", type=int, default=2, help="turns over the roots; odd turns run them in reverse")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the subprocess of one root
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one, args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("engine_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.nvidia_smi(), flush=True)
    roots = [os.path.abspath(r) for r in args.root or [HERE]]
    for turn in range(args.rounds):
        for root in roots if turn % 2 == 0 else roots[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--seed", str(args.seed)]
            proc = subprocess.run(cmd, cwd=root, stdout=subprocess.PIPE, text=True)
            if proc.returncode != 0:
                print(f"engine_compare: {root} failed (exit {proc.returncode})", file=sys.stderr)
                return proc.returncode
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(turn=turn, **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
