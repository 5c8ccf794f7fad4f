"""Check and time the fp32 flash kernels (forward, dq, dk/dv) of one or more checkouts on one CUDA card, in turns.

From the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/flash_f32_compare.py [--root DIR ...] [--rounds 1] [--seed 0] [--no-time] [--head-dim 192]

Each root (default: this checkout) runs in a subprocess of its own, which
imports that root's ``paddlenlp_tpu_torch``, builds its kernels (the build
log's register, shared-memory and spill lines of its fp32 source are
printed, the forward's among them) and holds its fp32
``flash_attention_fwd`` against its plain forward and its
``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkv`` against its plain
backward on a set of small cases (H 64 and 128, GQA, causal and full, a
window, segments, T not a multiple of 64, a fully masked window) and on the
fp32 cases of this checkout's ``chip_smoke.FLASH_CASES``: each output's
worst element over ``chip_smoke.flash_worst``'s fp32 bound (1e-4 of the
tensor's largest, <= 1 passes) and whether two launches give the same bits.
Unless ``--no-time``, it then times the forward, dq and dk/dv at the
``FLASH_CASES`` fp32 cases (CUDA events over 10 calls, the L2 flushed before
each: ``chip_smoke.time_cuda``) beside their bounds
(``chip_smoke.flash_bound`` at a third of the TF32 rate and at the fp32
rate), the plain forward and backward and, without segments or a window,
the library's fp32 forward and backward (``scaled_dot_product_attention``'s
forward under ``no_grad``, its backward through one kept graph). The roots run
in turns, ``--rounds`` times over (A, B, B, A for two roots and two rounds),
each printing one JSON line; the card's name and power limit come first.
Compare two commits by giving the parent's ``git archive`` as the first root
and this checkout as the second. With ``--head-dim 192`` the small cases and
the timed ones are at head_dim 192 (the ``<192>`` plans, the head dim split
over warp pairs): the timed ones at DeepSeek-V2-Lite's step shape, q/k/v
[1, 4096, 16, 192] causal, and T 4095 with segments (``chip_smoke``'s
``deepseek fp32`` cases), so design variants (roots with an edited
``flash_attention_sm90_f32.cu``) time in turns in one call.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, B, T, N, K, H, causal, window, segments)
SMALL = [("causal H128 g6 T100", 2, 100, 12, 2, 128, True, None, False),
         ("full H64 g1 T100", 2, 100, 4, 4, 64, False, None, False),
         ("causal H64 g1 T333 window+seg", 1, 333, 4, 4, 64, True, 100, True),
         ("full H128 g6 T300 seg", 1, 300, 12, 2, 128, False, None, True),
         ("causal H128 g6 T1000 window 0 (no row sees a key)", 1, 1000, 12, 2, 128, True, 0, False)]
SMALL_192 = [("causal H192 g1 T333 window+seg", 1, 333, 2, 2, 192, True, 100, True),
             ("full H192 g6 T200", 2, 200, 6, 1, 192, False, None, False),
             ("causal H192 g16 T100", 1, 100, 16, 1, 192, True, None, False),
             ("causal H192 g1 T1000 window 0 (no row sees a key)", 1, 1000, 4, 4, 192, True, 0, False)]
# (name, B, T, N, K, H, segments): the timed cases at head_dim 192, causal, no window
TIMED_192 = [("deepseek fp32", 1, 4096, 16, 16, 192, False), ("deepseek fp32 tail segments", 1, 4095, 16, 16, 192, True)]


def load_chip_smoke():
    """This checkout's ``chip_smoke`` (the cases, the bound, the timer),
    whichever root's package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _inputs(torch, B, T, N, K, H, segments, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, T, N, H, generator=g, device="cuda") for _ in range(2))
    k, v = (torch.randn(B, T, K, H, generator=g, device="cuda") for _ in range(2))
    seg = None
    if segments:
        seg = torch.zeros(B, T, dtype=torch.int32, device="cuda")
        seg[:, T // 3 + 5:] = 1
        seg[:, (2 * T) // 3 + 11:] = 2
    return q, k, v, do, seg


def check_case(torch, cs, fa, q, k, v, do, seg, causal, window):
    """out and lse against the plain forward, dq, dk, dv against the plain
    backward (from the plain forward's lse): worst over the fp32 bound, and
    the bits of a second launch."""
    opts = dict(segment_ids=seg, causal=causal, window=window)
    got_out, got_lse = fa.flash_attention_fwd(q, k, v, **opts)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, **opts)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa._delta(out, do)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts)
    dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts)
    dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts)
    ref = fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, **opts)
    torch.cuda.synchronize()
    worst = cs.flash_worst(torch, dict(out=got_out, lse=got_lse, dq=dq, dk=dk, dv=dv),
                           dict(out=out, lse=lse, dq=ref[0], dk=ref[1], dv=ref[2]), "float32")
    return dict(worst={n: e["worst"] for n, e in worst.items()}, finite=all(e["finite"] for e in worst.values()),
                max_abs_err={n: e["max_abs_err"] for n, e in worst.items()},
                out_zero_rows=int((got_out == 0).all(dim=-1).sum().item()),
                repeat_bits=bool(torch.equal(got_out, out2) and torch.equal(got_lse, lse2) and torch.equal(dq, dq2)
                                 and torch.equal(dk, dk2) and torch.equal(dv, dv2))), lse, delta


def timed_cases(torch, cs, head_dim, seed):
    """(name, window, q, k, v, do, seg) of each timed case: the fp32 cases of
    ``chip_smoke.FLASH_CASES`` at head_dim 128, ``TIMED_192`` at 192."""
    if head_dim == 128:
        for name, dtype, T, segments, window in cs.FLASH_CASES:
            if dtype == "float32":
                yield (name, window, *cs.flash_case(torch, dtype, T, segments, seed))
    else:
        for name, B, T, N, K, H, segments in TIMED_192:
            yield (name, None, *_inputs(torch, B, T, N, K, H, segments, seed))


def run_one(root, seed, timed, head_dim=128):
    """The checks and times on ``root``'s package: one JSON object."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import torch.nn.functional as F

    from paddlenlp_tpu_torch.ops import _build
    from paddlenlp_tpu_torch.ops import flash_attention as fa

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    builds = {}
    for stem in _build.SOURCES:
        b = _build.build(stem)
        builds[stem] = dict(seconds=b["seconds"])
        if stem == "flash_attention_sm90_f32":  # the fp32 kernels' source
            builds[stem]["ptxas"] = [ln.strip() for ln in (b["log"] or "").splitlines()
                                     if re.search(r"registers|spill|Compiling entry", ln)]
    checks = []
    for name, B, T, N, K, H, causal, window, segments in SMALL if head_dim == 128 else SMALL_192:
        q, k, v, do, seg = _inputs(torch, B, T, N, K, H, segments, seed)
        res, _lse, _delta = check_case(torch, cs, fa, q, k, v, do, seg, causal, window)
        checks.append(dict(case=name, **res))
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    times = []
    for name, window, q, k, v, do, seg in timed_cases(torch, cs, head_dim, seed):
        res, lse, delta = check_case(torch, cs, fa, q, k, v, do, seg, True, window)
        checks.append(dict(case=name, **res))
        if not timed:
            continue
        opts = dict(segment_ids=seg, causal=True, window=window)
        row = dict(case=name, q=list(q.shape), kv=list(k.shape),
                   fwd_ms=cs.time_cuda(torch, lambda: fa.flash_attention_fwd(q, k, v, **opts), 10, flush),
                   plain_fwd_ms=cs.time_cuda(torch, lambda: fa.flash_attention_fwd_ref(q, k, v, **opts), 2, flush),
                   library_fwd_ms=None,
                   bwd_dq_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts),
                                          10, flush),
                   bwd_dkv_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                                                     **opts), 10, flush),
                   plain_bwd_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                                                                       **opts), 2, flush),
                   library_bwd_ms=None)
        if seg is None and window is None:
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
            doh = do.transpose(1, 2).contiguous()
            with torch.no_grad():
                row["library_fwd_ms"] = cs.time_cuda(torch, lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True), 10, flush)
            lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True, enable_gqa=True)
            row["library_bwd_ms"] = cs.time_cuda(torch, lambda: torch.autograd.grad(lib_out, (qh, kh, vh), doh,
                                                                                    retain_graph=True), 10, flush)
            del qh, kh, vh, doh, lib_out
        for key, rate in (("bound_tf32_ms", "tf32"), ("bound_fp32_ms", None)):  # 3xTF32, and fp32 CUDA cores
            row[key] = {w: cs.flash_bound(torch, fa, q, k, seg, window, w, rate)[0]
                        for w in ("fwd", "bwd_dq", "bwd_dkv")}
        times.append(row)
        del q, k, v, do, seg, lse, delta
        torch.cuda.empty_cache()
    del flush
    return dict(root=os.path.abspath(root), package=os.path.dirname(os.path.dirname(fa.__file__)), builds=builds,
                checks=checks, worst=max(max(c["worst"].values()) for c in checks),
                all_repeat=all(c["repeat_bits"] for c in checks), times=times, seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="a checkout to run (repeat; default: this one)")
    ap.add_argument("--rounds", type=int, default=1, help="turns over the roots; odd turns run them in reverse")
    ap.add_argument("--no-time", action="store_true", help="only build and check")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--head-dim", type=int, choices=(128, 192), default=128,
                    help="the head dim of the small and timed cases (192: DeepSeek-V2-Lite's step shape)")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the subprocess of one root
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one, args.seed, not args.no_time, args.head_dim)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = load_chip_smoke()
    print(cs.nvidia_smi(), flush=True)
    roots = args.root or [HERE]
    for turn in range(args.rounds):
        for root in roots if turn % 2 == 0 else roots[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", root, "--seed", str(args.seed),
                   "--head-dim", str(args.head_dim)]
            cmd += ["--no-time"] if args.no_time else []
            proc = subprocess.run(cmd, cwd=HERE, stdout=subprocess.PIPE, text=True)
            if proc.returncode != 0:
                print(f"flash_f32_compare: {root} failed (exit {proc.returncode})", file=sys.stderr)
                return proc.returncode
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(dict(turn=turn, **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
