"""Build variants of the fp32 flash kernels' CUDA source and time them on one CUDA card, in turns.

From the root of a checkout, on a machine with one CUDA card and ``nvcc``:

    python3 tools/flash_f32_variants.py [--variant NAME ...] [--rounds 2] [--seed 0]

Each variant is ``paddlenlp_tpu_torch/csrc/flash_attention_sm90_f32.cu``
with the text edits listed in ``VARIANTS`` below (``base``: none), built
with the package's ``nvcc`` flags into ``paddlenlp_tpu_torch/_build/variants/``
(all builds at once). The ptxas register and spill lines of each are printed.
Every variant then runs through the package's own wrappers
(``flash_attention_fwd``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv``, their C entries taken from the variant's
library) on ``chip_smoke.FLASH_CASES``'s fp32 case: out and lse against the
plain forward and the gradients against the plain backward under the fp32
gate (``chip_smoke.flash_worst``, <= 1 passes), the bits of a second
launch, and the forward's, dq's and dk/dv's mean ms over 10 calls with the
L2 flushed before each (``chip_smoke.time_cuda``). The variants take turns, ``--rounds`` times over
(odd rounds in reverse). One JSON line a variant and round; the card's name
and power limit first. With ``--split``, the package's own dk/dv is then
timed at T 2048 and 4095 for each (waves, least chunk) of ``SPLITS`` in
place of ``ops.flash_attention``'s ``_WAVES`` and ``_MIN_CHUNK`` (how
``dkv_split`` cuts the kv tiles' walks), in turns, each held to the gate.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_COLS32 = ("constexpr int FWD_COLS = 16;", "constexpr int FWD_COLS = 32;")
_LAZY = ("""#pragma unroll
    for (int i = 0; i < H / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e / 2];""",
         """    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < H / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e / 2];
    }""")

# the forward's S = Q K^T in eight accumulator chains of 12 mma (``scores``: four of 24)
_CHAINS8 = [("""// acc (16 x H) += P X at fp32 accuracy""", """template <int H>
__device__ __forceinline__ void scores8(float (&d)[2][4], const float* a, const float* b, int a_row0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float e[4][2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) e[c][j][i] = 0.f;
  const int sw = swz(g), c4 = ((t ^ sw) & 3) * 4, b1 = sw >> 2;
  const int off[2] = {16 * b1 + c4, 16 * (1 ^ b1) + c4};
  const float* ar = a + (a_row0 + g) * H;
  const float* br = b + g * H;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const int o = 16 * (kk & ~1) + off[kk & 1], c = 2 * (kk & 1);
    const float4 xa = *reinterpret_cast<const float4*>(ar + o);
    const float4 xb = *reinterpret_cast<const float4*>(ar + 8 * H + o);
    uint32_t ah[2][4], al[2][4];
    split(xa.x, ah[0][0], al[0][0]);
    split(xb.x, ah[0][1], al[0][1]);
    split(xa.y, ah[0][2], al[0][2]);
    split(xb.y, ah[0][3], al[0][3]);
    split(xa.z, ah[1][0], al[1][0]);
    split(xb.z, ah[1][1], al[1][1]);
    split(xa.w, ah[1][2], al[1][2]);
    split(xb.w, ah[1][3], al[1][3]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 y = *reinterpret_cast<const float4*>(br + 8 * j * H + o);
      uint32_t bh[4], bl[4];
      split(y.x, bh[0], bl[0]);
      split(y.y, bh[1], bl[1]);
      split(y.z, bh[2], bl[2]);
      split(y.w, bh[3], bl[3]);
      mma3(e[c][j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma3(e[c + 1][j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = (e[0][j][i] + e[1][j][i]) + (e[2][j][i] + e[3][j][i]);
}

// acc (16 x H) += P X at fp32 accuracy"""),
            ("""    for (int u = 0; u < U; ++u) scores<H, H / 16>(s[u], q_s, st + u * STEP * H, 16 * warp);  // S = Q K^T""",
             """    for (int u = 0; u < U; ++u) scores8<H>(s[u], q_s, st + u * STEP * H, 16 * warp);  // S = Q K^T""")]

# name -> [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    # every tile read's swizzle computed where it reads (an XOR, an add and a shift a read)
    "xor": [("""__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }""",
             """__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }
template <int H>
__device__ __forceinline__ int at(int r, int d) { return r * H + (((d >> 2) ^ swz(r)) << 2) + (d & 3); }"""),
            ("""    const float4 xa = *reinterpret_cast<const float4*>(ar + o);
    const float4 xb = *reinterpret_cast<const float4*>(ar + 8 * H + o);""",
             """    const float4 xa = *reinterpret_cast<const float4*>(a + at<H>(a_row0 + g, 16 * kk + 4 * t));
    const float4 xb = *reinterpret_cast<const float4*>(a + at<H>(a_row0 + g + 8, 16 * kk + 4 * t));"""),
            ("""      const float4 y = *reinterpret_cast<const float4*>(br + 8 * j * H + o);""",
             """      const float4 y = *reinterpret_cast<const float4*>(b + at<H>(8 * j + g, 16 * kk + 4 * t));"""),
            ("""      split(x[8 * j * H + 8 * (i & ~3) + off[0][i & 3]], bh0, bl0);
      split(x[8 * j * H + 8 * (i & ~3) + off[1][i & 3]], bh1, bl1);""",
             """      split(x[at<H>(8 * j + 2 * t, 8 * i + g)], bh0, bl0);
      split(x[at<H>(8 * j + 2 * t + 1, 8 * i + g)], bh1, bl1);""")],
    # dk/dv: the dims loop fully unrolled
    "dkv_unroll_full": [("""    scores<H, 2>(p, k_s, st, 16 * warp);""", """    scores<H, H / 16>(p, k_s, st, 16 * warp);"""),
                        ("""    scores<H, 2>(ds, v_s, st + L::STEP_F, 16 * warp);""",
                         """    scores<H, H / 16>(ds, v_s, st + L::STEP_F, 16 * warp);""")],
    # split: hi by truncation (one integer instruction, not two)
    "trunc": [("""  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;""", """  hi = __float_as_uint(x) & 0xffffe000u;""")],
    # split: hi by cvt.rna.tf32.f32
    "cvt": [("""  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;""",
             """  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));""")],
    # a third stage in the ring (115 KB a block: two still fit an SM)
    "stages3": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    # the forward: 32 kv columns a step (one max, one rescale of O for two 16-column products)
    "fwd_cols32": [_COLS32],
    # the forward: O rescaled only when some row of the warp has a new max
    "fwd_lazy": [_LAZY],
    "fwd_cols32_lazy": [_COLS32, _LAZY],
    "fwd_chains8": _CHAINS8,
    "fwd_chains8_lazy": _CHAINS8 + [_LAZY],
}

# (waves, least chunk) of ``dkv_split`` that --split times
SPLITS = [(1, 32), (2, 32), (3, 32), (6, 32), (12, 32), (3, 16), (3, 64), (3, 128)]

def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def build(name, edits):
    """The variant's library path and its ptxas register and spill lines."""
    from paddlenlp_tpu_torch.ops import _build

    src = (_build.CSRC / _build.SOURCES["flash_attention_sm90_f32"]).read_text()
    for old, new in edits:
        if old not in src:
            raise ValueError(f"variant {name}: its edit does not apply")
        src = src.replace(old, new)
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    return str(so), [ln.strip() for ln in proc.stdout.splitlines() if re.search(r"registers|spill|entry", ln)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", help="a variant to run (repeat; default: all)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split", action="store_true", help="also time dk/dv at each of SPLITS")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_f32_variants: no CUDA device", file=sys.stderr)
        return 2
    from paddlenlp_tpu_torch.ops import flash_attention as fa

    cs = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    names = args.variant or list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build(n, VARIANTS[n]), names)))
    for name in names:
        print(json.dumps(dict(variant=name, ptxas=built[name][1])), flush=True)
    libs = {name: ctypes.CDLL(built[name][0]) for name in names}
    real = fa._kernel_fn

    def kernel_fn(lib):
        def fn(stem, symbol, n_ptr, n_int):
            if stem != "flash_attention_sm90_f32":
                return real(stem, symbol, n_ptr, n_int)
            f = getattr(lib, symbol)
            f.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_float, ctypes.c_void_p]
            f.restype = ctypes.c_int
            return f
        return fn

    case = next(c for c in cs.FLASH_CASES if c[1] == "float32")
    q, k, v, do, seg = cs.flash_case(torch, "float32", case[2], case[3], args.seed)
    opts = dict(segment_ids=seg, causal=True, window=case[4])
    out, lse = fa.flash_attention_fwd_ref(q, k, v, **opts)
    delta = fa._delta(out, do)
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_ref(q, k, v, do, lse, delta, **opts)))
    want["out"], want["lse"] = out, lse
    flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for turn in range(args.rounds):
        for name in names if turn % 2 == 0 else names[::-1]:
            fa._kernel_fn = kernel_fn(libs[name])
            try:
                got = dict(dq=fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts))
                got["dk"], got["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts)
                got["out"], got["lse"] = fa.flash_attention_fwd(q, k, v, **opts)
                again = dict(dq=fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **opts))
                again["dk"], again["dv"] = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **opts)
                again["out"], again["lse"] = fa.flash_attention_fwd(q, k, v, **opts)
                torch.cuda.synchronize()
                worst = cs.flash_worst(torch, got, want, "float32")
                row = dict(turn=turn, variant=name, case=case[0],
                           worst={n: e["worst"] for n, e in worst.items()},
                           repeat_bits=all(torch.equal(got[n], again[n]) for n in got),
                           fwd_ms=cs.time_cuda(torch, lambda: fa.flash_attention_fwd(q, k, v, **opts), 10, flush),
                           bwd_dq_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dq(
                               q, k, v, do, lse, delta, **opts), 10, flush),
                           bwd_dkv_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dkv(
                               q, k, v, do, lse, delta, **opts), 10, flush))
            finally:
                fa._kernel_fn = real
            print(json.dumps(row), flush=True)
    if args.split:
        split_sweep(torch, cs, fa, args.rounds, args.seed, flush)
    return 0


def split_sweep(torch, cs, fa, rounds, seed, flush):
    """dk/dv at T 2048 and 4095 for each of SPLITS, in turns."""
    default = (fa._WAVES, fa._MIN_CHUNK)
    for T in (2048, 4095):
        q, k, v, do, _ = cs.flash_case(torch, "float32", T, False, seed)
        out, lse = fa.flash_attention_fwd_ref(q, k, v)
        delta = fa._delta(out, do)
        want = dict(zip(("dk", "dv"), fa.flash_attention_bwd_ref(q, k, v, do, lse, delta)[1:]))
        B, _T, N, _H = q.shape
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        for turn in range(rounds):
            for waves, least in SPLITS if turn % 2 == 0 else SPLITS[::-1]:
                fa._WAVES, fa._MIN_CHUNK = waves, least
                try:
                    got = dict(zip(("dk", "dv"), fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)))
                    torch.cuda.synchronize()
                    worst = cs.flash_worst(torch, got, want, "float32")
                    chunk, slots = fa.dkv_split(B, T, T, N, k.shape[2], True, None, sms)
                    row = dict(turn=turn, T=T, waves=waves, least_chunk=least, chunk=chunk, slots=slots,
                               worst={n: e["worst"] for n, e in worst.items()},
                               bwd_dkv_ms=cs.time_cuda(torch, lambda: fa.flash_attention_bwd_dkv(
                                   q, k, v, do, lse, delta), 10, flush))
                finally:
                    fa._WAVES, fa._MIN_CHUNK = default
                print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, delta, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
