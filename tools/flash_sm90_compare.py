"""Time the bf16 Hopper flash kernels built from several sources, in turns.

Each ``--source`` is a version of ``paddlenlp_tpu_torch/csrc/flash_attention_sm90.cu``
(default: the checkout's own). Every source is built with ``nvcc`` into a
library of its own (the flags of ``ops/_build.py``), its ptxas registers and
spills are printed, and the three kernels of each are checked against the
plain versions on the shape's inputs (``chip_smoke.flash_worst``) and timed
with CUDA events, the L2 flushed before each launch, the sources taking turns
(A, B, B, A for two) ``--rounds`` times. One JSON line a source and round.
From the root of a checkout, on a CUDA card:

    python3 tools/flash_sm90_compare.py --source old.cu --source paddlenlp_tpu_torch/csrc/flash_attention_sm90.cu \\
        [--shape 1,4096,16,16,192] [--rounds 2]
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys


def build(source, out_dir):
    from paddlenlp_tpu_torch.ops import _build

    text = open(source, "rb").read()
    lib = os.path.join(out_dir, f"libflash-{hashlib.sha256(text).hexdigest()[:12]}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", lib, source]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    usage, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_\w+_sm90)ILi(\d+)E", line)
        if m:
            entry = f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry:
            usage.setdefault(entry, {})["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            usage.setdefault(entry, {})["registers"] = int(m.group(1))
    return ctypes.CDLL(lib), usage


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", help="a version of flash_attention_sm90.cu (repeatable)")
    ap.add_argument("--shape", default="1,4096,16,16,192", help="B,T,N,K,H of q [B,T,N,H] over k/v [B,T,K,H]")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("flash_sm90_compare: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa

    sources = args.source or ["paddlenlp_tpu_torch/csrc/flash_attention_sm90.cu"]
    out_dir = os.path.join(str(_build.BUILD_DIR), "compare")  # beside the port's own builds, ignored by git
    os.makedirs(out_dir, exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    libs = {}
    for src in sources:
        libs[src], usage = build(src, out_dir)
        print(json.dumps(dict(source=src, ptxas=usage)), flush=True)
    B, T, N, K, H = (int(x) for x in args.shape.split(","))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    q, do = (torch.randn(B, T, N, H, generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(B, T, K, H, generator=g, device="cuda").bfloat16() for _ in range(2))
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v)
    delta = fa._delta(ref_out, do)
    want = dict(out=ref_out, lse=ref_lse, **dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(
        q, k, v, do, ref_lse, delta))))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    real = fa._kernel_fn
    order = sources + sources[::-1]
    for rnd in range(args.rounds):
        for src in order:
            lib = libs[src]

            def kernel_fn(stem, symbol, n_ptr, n_int, lib=lib):
                fn = getattr(lib, symbol) if stem == "flash_attention_sm90" else real(stem, symbol, n_ptr, n_int)
                fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                return fn

            fa._kernel_fn = kernel_fn
            try:
                out, lse = fa.flash_attention_fwd(q, k, v)
                dq = fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta)
                dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta)
                torch.cuda.synchronize()
                worst = cs.flash_worst(torch, dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv), want, "bfloat16")
                ms = dict(fwd=cs.time_cuda(torch, lambda: fa.flash_attention_fwd(q, k, v), 10, flush),
                          bwd_dq=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dq(q, k, v, do, ref_lse, delta),
                                              10, flush),
                          bwd_dkv=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, ref_lse, delta),
                                               10, flush))
            finally:
                fa._kernel_fn = real
            print(json.dumps(dict(round=rnd, source=src, shape=[B, T, N, K, H], ms=ms,
                                  worst={n: e["worst"] for n, e in worst.items()},
                                  finite=all(e["finite"] for e in worst.values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
