// Ragged paged attention on Hopper tensor cores (sm_90a), CUDA C++ with a
// plain C entry for each route: bf16 queries over a bf16 pool, bf16 queries
// over an int8 or fp8-e4m3 pool, and fp32 queries or an fp32 pool (the fp32
// route, 3xTF32 products; its note is at its kernel below).
//
// Replaces the Pallas TPU kernel paddlenlp_tpu/ops/pallas/paged_attention.py
// `_kernel` (:56), launched at :159 by `ragged_paged_attention` (:105). The
// function of every route: query token t of sequence b sits at position
// q_start[b] + t and sees kv positions <= q_start[b] + t of its block table;
// rows t >= q_lens[b], and every row of a q_lens == 0 sequence, are exact
// zeros; GQA folds query head n = kh * group + g of token t into row
// t * group + g of kv head kh; NEG_INF = -1e30 masking, the online softmax in
// fp32 (exp2, scale * log2(e) folded into one FMA), the finalizer divides by
// max(l, 1e-37).
//
// Layouts: q, out [B, T, N, H] bf16 (the fp32 route: fp32, or bf16 over an
// fp32 pool); pool_k, pool_v [nb, K, bs, H] bf16, int8 or fp8-e4m3 (the fp32
// route also fp32; any bs in 1..64), the quantized ones with k_scale,
// v_scale [nb, K, bs, 1] fp32 (position p's K row is k_scale[p] * kq[p], as
// the Pallas kernel dequantizes at :83-85); tables [B, mb], q_start, q_lens
// [B] int32; H 64 or 128.
//
// What bounds the bf16 routes on an H100:
// - Decode (q_lens 1) is bound by bytes, the K and V it reads, and by too few
//   blocks: one block per (64 folded rows, kv head, sequence) gives 32 blocks
//   at the engine's 8 rows x 4 kv heads, a quarter of the 132 SMs. So the kv
//   walk is split: one block per (row tile, kv partition, kv head, sequence);
//   the caller picks the partition length (ops/paged_attention.py
//   `kv_partitions`) so that a decode launch keeps about two live blocks on
//   every SM. Each partition writes its rows' (max, sum, unnormalised output)
//   in fp32; the merge kernel below combines them in partition order, so the
//   result is deterministic, with no atomics. Blocks whose partition starts
//   past the tile's highest live position exit at once and write nothing.
//   A launch whose grid already fills the card (prefill chunks) uses one
//   partition, writes the output itself and skips the merge.
// - Prefill is bound by operations: S = Q K^T and O += P V are bf16 `wgmma`
//   with fp32 accumulators. A tile of 64 folded rows is one warpgroup's M; a
//   decode tile has `group` live rows of 64, which wastes tensor-core lanes
//   but not bytes, and bytes bound it. P is the A operand from registers in
//   two bf16 parts (the rounding and the rounding of its residual), as in
//   flash_attention_sm90.cu, where one rounding left the output at 0.72-0.96
//   of the card's elementwise gate; V is the B operand MN-major.
// - Several pool blocks in flight: each 64-position K and V tile is gathered
//   row by row through the block table with 16-byte `cp.async` (any bs,
//   33 included), through a 3-stage ring (two blocks an SM at H 128).
//   Positions past the tile's highest live one are zero-filled and their
//   table entries never read; the per-element mask runs only on tiles that
//   are not wholly visible. A bf16 pool lands straight in the
//   128-byte-swizzled layout that wgmma reads.
// - A quantized pool halves the bytes: its stages hold the raw 1-byte rows
//   (half a bf16 stage) and the tile's 64 K and 64 V scales. Each landed
//   stage is widened into one bf16 K and one bf16 V tile in the swizzled
//   layout; the widening is exact (|int8| <= 127 and every e4m3 value are
//   bf16 values), so the same wgmmas run on the quantized values. The scales
//   are folded, never multiplied into K or V: S's column c is multiplied by
//   k_scale[c] before the mask and the softmax, and P's column c by
//   v_scale[c] before its two-part bf16 split, so O += (P v_scale) Vq while
//   the row sum l stays over P; the reference's q . (kq ks) up to fp32
//   rounding. Q is never quantized (the reference keeps it in bf16).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;  // folded query rows of a block: one warpgroup's wgmma M
constexpr int KV_TILE = 64;  // kv positions of a tile
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int MAX_BS = 64;
constexpr int MERGE_ROWS = 4;  // output rows of a merge block, one a warp

struct Shape {
  int T, N, K, bs, mb, parts, part_len;  // part_len: kv positions of a partition, a multiple of KV_TILE
  float scale;
  int q_bf16;  // the fp32 route: q and out bf16 (over an fp32 pool), else fp32; the bf16 routes ignore it
};

// ------------------------------------------------------------------ PTX
// this thread's shared-memory writes, made visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows
// 128 bytes apart, 8-row groups 1024 bytes apart (SBO). MN-major operands:
// the next 64 columns are the next panel (LBO = panel bytes), the next 8
// k-rows 1024 bytes on (SBO).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo_bytes) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving register reads and writes across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// (x0, x1) = hi + lo, each a bf16 pair: hi the rounding, lo the rounding of the rest
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// ------------------------------------------------------------------ attention
// A bf16 pool: the Q tile, then rings of STAGES K and V tiles that wgmma
// reads. A quantized pool: the Q tile, one K and one V bf16 tile that wgmma
// reads, then a ring of STAGES raw stages, each the 64 K rows and 64 V rows
// of H bytes and the 64 K and 64 V scales.
template <int H, typename KVT>
struct Smem {
  static constexpr bool QUANT = !std::is_same<KVT, __nv_bfloat16>::value;
  static constexpr int TILE = 64 * H * 2;  // bytes of a 64-row tile: H / 64 panels of 64 rows x 128 bytes
  static constexpr int RAW = KV_TILE * H;  // bytes of a 1-byte tile, rows H bytes apart
  static constexpr int RAW_STAGE = 2 * RAW + 2 * KV_TILE * 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + TILE;
  static constexpr size_t v = k + (QUANT ? 1 : STAGES) * TILE;
  static constexpr size_t raw = v + (QUANT ? 1 : STAGES) * TILE;
  static constexpr size_t bytes = raw + (QUANT ? STAGES * RAW_STAGE : 0) + 1024;  // + alignment slack
};

// Row `row` (0..63) of a 64-row tile of H bf16 columns, 16-byte chunk c, at
// the 128-byte swizzle that TMA's SWIZZLE_128B writes and wgmma reads: panel
// c / 8, chunk c % 8 of the row stored at chunk (c % 8) ^ (row % 8).
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int row, int c) {
  return tile + (c / 8) * (64 * 128) + row * 128 + (((c % 8) ^ (row % 8)) << 4);
}

// K and V of kv positions kv0 .. kv0 + 63 into one stage, gathered row by
// row through the block table; positions past `hi` are zeros and their
// table entries are never read.
template <int H>
__device__ __forceinline__ void load_kv(uint32_t k_t, uint32_t v_t, const __nv_bfloat16* __restrict__ pool_k,
                                        const __nv_bfloat16* __restrict__ pool_v, const int* __restrict__ table,
                                        const Shape& sh, int kh, int kv0, int hi) {
  constexpr int CHUNKS = H / 8;  // 16-byte chunks of a row
  constexpr int ROWS_A_PASS = THREADS / CHUNKS;
  const int c = threadIdx.x % CHUNKS;
#pragma unroll
  for (int u = 0; u < KV_TILE / ROWS_A_PASS; ++u) {
    const int r = threadIdx.x / CHUNKS + u * ROWS_A_PASS, pos = kv0 + r;
    const bool live = pos <= hi;
    size_t off = 0;
    if (live) off = ((static_cast<size_t>(table[pos / sh.bs]) * sh.K + kh) * sh.bs + pos % sh.bs) * H + c * 8;
    cp_async_16(swizzled(k_t, r, c), pool_k + off, live);
    cp_async_16(swizzled(v_t, r, c), pool_v + off, live);
  }
}

// K and V bytes of kv positions kv0 .. kv0 + 63, and their scales, into one
// raw stage, gathered row by row through the block table (16-byte chunks, 4
// of a row at H 64, 8 at H 128); positions past `hi` are zeros, scales
// included, and their table entries are never read.
template <int H, typename KVT>
__device__ __forceinline__ void load_kv_raw(uint32_t st, const KVT* __restrict__ pool_k,
                                            const KVT* __restrict__ pool_v, const float* __restrict__ k_scale,
                                            const float* __restrict__ v_scale, const int* __restrict__ table,
                                            const Shape& sh, int kh, int kv0, int hi) {
  constexpr int CHUNKS = H / 16;
  constexpr int ROWS_A_PASS = THREADS / CHUNKS;
  const uint8_t* pk = reinterpret_cast<const uint8_t*>(pool_k);
  const uint8_t* pv = reinterpret_cast<const uint8_t*>(pool_v);
  const int c = threadIdx.x % CHUNKS;
#pragma unroll
  for (int u = 0; u < KV_TILE / ROWS_A_PASS; ++u) {
    const int r = threadIdx.x / CHUNKS + u * ROWS_A_PASS, pos = kv0 + r;
    const bool live = pos <= hi;
    size_t off = 0;
    if (live) off = ((static_cast<size_t>(table[pos / sh.bs]) * sh.K + kh) * sh.bs + pos % sh.bs) * H + c * 16;
    cp_async_16(st + r * H + c * 16, pk + off, live);
    cp_async_16(st + (KV_TILE + r) * H + c * 16, pv + off, live);
  }
  // threads 0-63 the K scale of row t, threads 64-127 the V scale of row t - 64
  const int r = threadIdx.x % KV_TILE, pos = kv0 + r;
  const bool live = pos <= hi;
  size_t off = 0;
  if (live) off = (static_cast<size_t>(table[pos / sh.bs]) * sh.K + kh) * sh.bs + pos % sh.bs;
  cp_async_4(st + 2 * KV_TILE * H + threadIdx.x * 4, (threadIdx.x < KV_TILE ? k_scale : v_scale) + off, live);
}

// two 1-byte pool values (the low 16 bits of w, the first in the low byte)
// as a bf16 pair, exactly
template <typename KVT>
__device__ __forceinline__ uint32_t widen2(uint32_t w);

template <>
__device__ __forceinline__ uint32_t widen2<int8_t>(uint32_t w) {  // |x| <= 127: 7 bits of bf16's 8
  const __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(static_cast<int8_t>(w & 0xff)),
                                                  static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t widen2<__nv_fp8_e4m3>(uint32_t w) {  // 3 mantissa bits, 2^-9 .. 448
  const __half2 hf(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xffff), __NV_E4M3));
  const float2 f = __half22float2(hf);
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A landed raw stage's K and V rows widened into the bf16 K and V tiles that
// wgmma reads: raw chunk c of row r (16 values) becomes bf16 chunks 2c and
// 2c + 1 of the swizzled row.
template <int H, typename KVT>
__device__ __forceinline__ void widen_kv(const uint8_t* raw, uint8_t* k_t, uint8_t* v_t) {
  constexpr int CHUNKS = H / 16;
#pragma unroll
  for (int u = 0; u < 2 * KV_TILE * CHUNKS / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS, t = i / (KV_TILE * CHUNKS), r = (i / CHUNKS) % KV_TILE, c = i % CHUNKS;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + (t * KV_TILE + r) * H + c * 16);
    uint8_t* tile = t ? v_t : k_t;
    *reinterpret_cast<uint4*>(tile + swizzled(0, r, 2 * c)) =
        make_uint4(widen2<KVT>(w.x), widen2<KVT>(w.x >> 16), widen2<KVT>(w.y), widen2<KVT>(w.y >> 16));
    *reinterpret_cast<uint4*>(tile + swizzled(0, r, 2 * c + 1)) =
        make_uint4(widen2<KVT>(w.z), widen2<KVT>(w.z >> 16), widen2<KVT>(w.w), widen2<KVT>(w.w >> 16));
  }
}

// s[4 j + e] and s[4 j + 2 + e] (rows r, r + 8; column 8 j + cq + e) times
// the column's scale
__device__ __forceinline__ void scale_columns(float (&s)[KV_TILE / 2], const float* col_scale, int cq) {
#pragma unroll
  for (int j = 0; j < KV_TILE / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sc = col_scale[8 * j + cq + e];
      s[4 * j + e] *= sc;
      s[4 * j + 2 + e] *= sc;
    }
}

template <int H, typename KVT>
__global__ void __launch_bounds__(THREADS, 2)
    paged_attention_kernel_sm90(const __nv_bfloat16* __restrict__ q, const KVT* __restrict__ pool_k,
                                const KVT* __restrict__ pool_v, const float* __restrict__ k_scale,
                                const float* __restrict__ v_scale, const int* __restrict__ tables,
                                const int* __restrict__ q_start, const int* __restrict__ q_lens,
                                __nv_bfloat16* __restrict__ out, float* __restrict__ part_o,
                                float* __restrict__ part_ml, Shape sh) {
  using L = Smem<H, KVT>;
  constexpr bool QUANT = L::QUANT;
  constexpr int CHUNKS = H / 8;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const uint32_t q_s = smem_u32(smem + L::q), k_s = smem_u32(smem + L::k), v_s = smem_u32(smem + L::v);

  const int group = sh.N / sh.K, rows_total = sh.T * group;
  const int n_tiles = (rows_total + ROWS - 1) / ROWS;
  // the last row tile first: under the causal mask it walks the most kv tiles
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / sh.parts, part = blockIdx.x % sh.parts;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int row0 = tile * ROWS;
  const int start = q_start[b], qlen = min(q_lens[b], sh.T);
  const int cap = sh.mb * sh.bs;
  const int t_first = row0 / group, t_last = (min(row0 + ROWS, rows_total) - 1) / group;
  // the highest kv position a live row of this tile sees (-1: none live)
  const int hi = t_first < qlen ? min(start + min(t_last, qlen - 1), cap - 1) : -1;
  const int j_lo = part * (sh.part_len / KV_TILE);
  const int j_hi = (min((part + 1) * sh.part_len, hi + 1) + KV_TILE - 1) / KV_TILE;
  const int n_kv = max(j_hi - j_lo, 0);
  if (sh.parts > 1 && n_kv == 0) return;  // nothing to merge from this partition
  const int* table = tables + static_cast<size_t>(b) * sh.mb;

  // this thread's rows r and r + 8 of the tile, their last visible position
  // (-1: a dead row) and columns 8 j + cq + {0, 1} of each score tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + r + 8 * h;
    lim[h] = fr < rows_total && fr / group < qlen ? min(start + fr / group, cap - 1) : -1;
  }
  // a tile is wholly visible to every row when all 64 rows are live and the
  // first row sees its last position
  const bool rows_live = row0 + ROWS <= rows_total && (row0 + ROWS - 1) / group < qlen;

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // m: the row max of S, before the softmax scale
  const float sl2 = sh.scale * LOG2E;

  if (n_kv > 0) {
    // the Q tile, folded rows gathered from their heads (dead rows zero), with kv tile 0
    for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
      const int rr = i / CHUNKS, c = i % CHUNKS, fr = row0 + rr;
      const bool live = fr < rows_total && fr / group < qlen;
      const size_t off = live ? ((static_cast<size_t>(b) * sh.T + fr / group) * sh.N + kh * group + fr % group) * H +
                                    c * 8
                              : 0;
      cp_async_16(swizzled(q_s, rr, c), q + off, live);
    }
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_kv) {
        if constexpr (QUANT)
          load_kv_raw<H>(smem_u32(smem + L::raw + s * L::RAW_STAGE), pool_k, pool_v, k_scale, v_scale, table, sh,
                         kh, (j_lo + s) * KV_TILE, hi);
        else
          load_kv<H>(k_s + s * L::TILE, v_s + s * L::TILE, pool_k, pool_v, table, sh, kh, (j_lo + s) * KV_TILE, hi);
      }
      cp_async_commit();
    }

    for (int it = 0; it < n_kv; ++it) {
      const int stage = it % STAGES, kv0 = (j_lo + it) * KV_TILE;
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile it have landed
      fence_async_shared();
      __syncthreads();  // everyone's have; and every reader of tile it - 1's stage is done
      {
        const int nx = it + STAGES - 1;
        if (nx < n_kv) {
          if constexpr (QUANT)
            load_kv_raw<H>(smem_u32(smem + L::raw + (nx % STAGES) * L::RAW_STAGE), pool_k, pool_v, k_scale, v_scale,
                           table, sh, kh, (j_lo + nx) * KV_TILE, hi);
          else
            load_kv<H>(k_s + (nx % STAGES) * L::TILE, v_s + (nx % STAGES) * L::TILE, pool_k, pool_v, table, sh, kh,
                       (j_lo + nx) * KV_TILE, hi);
        }
        cp_async_commit();
      }
      // a quantized pool: the landed stage widened into the one K and V tile
      // (every reader of the previous tile is past the barrier above), and
      // its scales: K's 64, then V's 64
      const uint8_t* raw = smem + L::raw + stage * L::RAW_STAGE;
      const float* col_scale = reinterpret_cast<const float*>(raw + 2 * L::RAW);
      if constexpr (QUANT) {
        widen_kv<H, KVT>(raw, smem + L::k, smem + L::v);
        fence_async_shared();
        __syncthreads();
      }
      const int kv_stage = QUANT ? 0 : stage;

      float s[KV_TILE / 2];  // S = Q K^T, 64 x 64: rows r / r + 8, columns 8 j + cq + {0, 1}
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = (kk / 4) * 64 * 128 + (kk % 4) * 32;  // 16 columns = 32 bytes into a panel
        wgmma_ss64(s, desc(smem + L::q + off, 16), desc(smem + L::k + kv_stage * L::TILE + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      if constexpr (QUANT) scale_columns(s, col_scale, cq);  // S[r, c] = k_scale[c] (q_r . kq_c)

      if (!(rows_live && kv0 + KV_TILE - 1 <= min(start + t_first, cap - 1))) {
#pragma unroll
        for (int j = 0; j < KV_TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = kv0 + 8 * j + cq + e;
            if (pos > lim[0]) s[4 * j + e] = NEG_INF;
            if (pos > lim[1]) s[4 * j + 2 + e] = NEG_INF;
          }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < KV_TILE / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // p = exp2(s sl2 - m sl2); a row that has seen nothing yet subtracts 0,
      // so its NEG_INF entries give p = 0
      const float mu0 = mn0 == NEG_INF ? 0.f : mn0 * sl2, mu1 = mn1 == NEG_INF ? 0.f : mn1 * sl2;
      const float a0 = exp2f(m0 * sl2 - mu0), a1 = exp2f(m1 * sl2 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < KV_TILE / 8; ++j) {
        s[4 * j] = exp2f(fmaf(s[4 * j], sl2, -mu0));
        s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, -mu0));
        s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, -mu1));
        s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, -mu1));
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * a0 + ps0;  // this thread's share of the row sum; the 4 lanes add up at the end
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      if constexpr (QUANT) scale_columns(s, col_scale + KV_TILE, cq);  // O += (P v_scale) Vq; l is of P
      // P as the A operand in two bf16 parts (high, residual): k-chunk kk is
      // the accumulator's columns 16 kk .. 16 kk + 15; the row sum above is of fp32 P
      uint32_t p_hi[KV_TILE / 16][4], p_lo[KV_TILE / 16][4];
#pragma unroll
      for (int kk = 0; kk < KV_TILE / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p_hi[kk][i], p_lo[kk][i]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KV_TILE / 16; ++kk) {  // O += P V, V [kv, H] MN-major: 16 kv rows = 2048 bytes
        const uint8_t* v_k = smem + L::v + kv_stage * L::TILE + kk * 16 * 128;
        wgmma_rs<H>(o, p_hi[kk], desc(v_k, 64 * 128));
        wgmma_rs<H>(o, p_lo[kk], desc(v_k, 64 * 128));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    cp_async_wait<0>();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = row0 + r + 8 * h;
    if (fr >= rows_total) continue;
    const float l = h ? l1 : l0, m = h ? m1 : m0;
    if (sh.parts == 1) {  // every row of the tile: dead rows kept l == 0 and o == 0, exact zeros
      const float d = fmaxf(l, 1e-37f);
      const size_t orow = (static_cast<size_t>(b) * sh.T + fr / group) * sh.N + kh * group + fr % group;
      __nv_bfloat16* op = out + orow * H + cq;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / d, o[4 * j + 2 * h + 1] / d);
    } else if (lim[h] >= 0) {  // live rows: (m scale log2(e), l, o) of this partition, unnormalised
      const size_t prow = ((static_cast<size_t>(b) * sh.K + kh) * sh.parts + part) * rows_total + fr;
      float* po = part_o + prow * H + cq;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<float2*>(po + 8 * j) = make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) = make_float2(m == NEG_INF ? NEG_INF : m * sl2, l);
    }
  }
}

// ------------------------------------------------------------------ merge
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// One warp an output row (b, t, n): the partitions the row's live positions
// reach, combined in partition order (deterministic); dead rows exact zeros.
// OT: the output's type, bf16 or (the fp32 route) fp32.
template <int H, typename OT>
__global__ void __launch_bounds__(MERGE_ROWS * 32)
    paged_attention_merge_sm90(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                               const int* __restrict__ q_start, const int* __restrict__ q_lens, OT* __restrict__ out,
                               int B, Shape sh) {
  constexpr int PER_LANE = H / 32;  // 4 or 2 adjacent columns a lane
  const int w = blockIdx.x * MERGE_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (w >= B * sh.T * sh.N) return;
  const int n = w % sh.N, t = (w / sh.N) % sh.T, b = w / (sh.N * sh.T);
  const int group = sh.N / sh.K, kh = n / group, fr = t * group + n % group, rows_total = sh.T * group;
  float acc[PER_LANE];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) acc[i] = 0.f;
  float l = 0.f;
  if (t < q_lens[b]) {
    const int hi = min(q_start[b] + t, sh.mb * sh.bs - 1);
    const int live = min(hi / sh.part_len + 1, sh.parts);
    const size_t base = (static_cast<size_t>(b) * sh.K + kh) * sh.parts * rows_total + fr;
    float mu = NEG_INF;
    for (int p = 0; p < live; ++p) mu = fmaxf(mu, part_ml[(base + static_cast<size_t>(p) * rows_total) * 2]);
    for (int p = 0; p < live; ++p) {
      const size_t prow = base + static_cast<size_t>(p) * rows_total;
      const float2 ml = *reinterpret_cast<const float2*>(part_ml + prow * 2);
      const float wgt = exp2f(ml.x - mu);
      l += wgt * ml.y;
      const float* po = part_o + prow * H + lane * PER_LANE;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) acc[i] += wgt * po[i];
    }
  }
  const float d = fmaxf(l, 1e-37f);
  OT* op = out + static_cast<size_t>(w) * H + lane * PER_LANE;
#pragma unroll
  for (int i = 0; i < PER_LANE; i += 2) store2(op + i, acc[i] / d, acc[i + 1] / d);
}

// ------------------------------------------------------------------ fp32 route
// fp32 queries over an fp32, bf16, int8 or fp8-e4m3 pool, and bf16 queries
// over an fp32 pool: the engines that compute in fp32 (PPO's rollouts, an
// engine or predictor built with fp32 dtype) and the fp32 references the
// card checks the bf16 paths against. Gate: |kernel - plain| <= 1e-4.
//
// What bounds it on an H100: prefill chunks by operations, decode by the
// bytes of fp32 K and V (twice bf16's). The design:
// - Products on the tensor cores at fp32 accuracy, 3xTF32: each operand x is
//   split in registers into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
//   (the rounding done as two integer instructions) and a product is
//   a_lo b_hi + a_hi b_lo + a_hi b_hi into an fp32 accumulator (a_lo b_lo,
//   ~2^-22 of it, dropped) with mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32:
//   S = Q K^T and O += P V. In O += P V, V is split in three exact parts
//   (four mmas): a row with one visible key (P = 1, a single-token
//   sequence) then gets V back bit for bit, as fp32 arithmetic does, which
//   the fp32 single-token checks (chip_smoke.single_token_logits) rest on;
//   with V in two parts an a8w8 model's fp32 streams left the plain path's
//   at the second token. A value that TF32 holds exactly has no lo part and
//   its products are skipped: bf16, int8 and e4m3 pool values (the scales
//   are folded, as below), so over those pools both products take two
//   mmas. mma.sync, not wgmma: wgmma reads B from shared memory, so a split
//   K and V would need hi and lo copies there, doubling a ring already twice
//   bf16's size (a 64 x 128 fp32 tile is 32 KB); mma.sync takes B fragments
//   in registers, where the split costs five instructions. One TF32 pass
//   (~2^-11 a product) misses the 1e-4 gate
//   (tests/test_torch_paged_attention.py prints by how far).
// - Fragments need no shuffles. The k index of both products is a sum index,
//   so lanes may take any permutation of it as long as A and B agree: in S,
//   k-steps 2 kk and 2 kk + 1 read head dims 16 kk + 4 t + {0, 1} and
//   {2, 3}, so each lane's K values (and Q values) are 4 adjacent words, one
//   16-byte shared load; in O += P V, lane (g, t)'s accumulator columns
//   8 j + 2 t and 8 j + 2 t + 1 of S are its A operand for kv rows 8 j + 2 t
//   and 8 j + 2 t + 1 as they are. The Q tile lands in shared memory once
//   a block, fp32 (in registers it pushed the walk past 255 registers and
//   spilled), and is split as each tile reads it.
// - A 64-position kv tile, gathered row by row through the block table
//   (its entries read into shared memory once, ahead of the walk, up to
//   2,048 of them: a longer walk reads them from L2) with 16-byte
//   `cp.async` into a ring of 2 stages (fp32 at H 128: 64 KB a stage) or 4
//   (the narrower pools, and H 64); every stage is in flight before the
//   walk waits for its first, so a decode block's two tiles load together
//   and the next tiles load while this one computes. The pool lands raw (4,
//   2 or 1 bytes a value) in a layout whose 16-byte chunks are XOR-swizzled
//   by row so that each lane's K and V reads hit distinct banks; a value is
//   widened to fp32 as it is read. An int8 or
//   fp8 pool brings the tile's 64 K and 64 V scales; S's column c is
//   multiplied by k_scale[c] before the mask and P's column c by v_scale[c]
//   before its split, while the row sum stays over P.
// - Eight warps, 128 folded rows a block. When more than 16 rows of the tile
//   are live (prefill chunks), warp w takes rows 16 w .. 16 w + 15 and all 64
//   columns of each kv tile, and skips tiles past its rows' last visible
//   position (dead warps skip all). When 16 or fewer are (decode, and the
//   decode rows of a ragged launch), all eight warps take those 16 rows and
//   8 columns each of every tile, so a decode row's walk runs on every
//   warp's tensor core, not one. Each warp keeps its rows' online softmax
//   (m, l, O); the block stashes them in shared memory and combines the
//   warps in a fixed order. With the kv walk split (`kv_partitions` at this
//   route's 128-row blocks, one resident an SM) the block writes its
//   partition's (m, l, O) and paged_attention_merge_sm90 combines the
//   partitions in order: no atomics, two launches give the same bits.
constexpr int F32_WARPS = 8;
constexpr int F32_THREADS = F32_WARPS * 32;
constexpr int F32_ROWS = 16 * F32_WARPS;  // folded query rows of a block
// table entries a block reads into shared memory (8 KB); a walk over more
// (one partition over a long table) reads them where they are, through L2
constexpr int F32_TBL_SMEM = 2048;

template <int H, typename KVT>
struct F32Tile {
  static constexpr int SZ = sizeof(KVT);
  static constexpr int RB = H * SZ;    // bytes of a pool row
  static constexpr int CPR = RB / 16;  // its 16-byte chunks
  static constexpr bool QUANT = std::is_same<KVT, int8_t>::value || std::is_same<KVT, __nv_fp8_e4m3>::value;
  static constexpr bool EXACT = !std::is_same<KVT, float>::value;  // the pool's values are TF32 values: no lo part
  static constexpr int TILE = KV_TILE * RB;  // K (or V) of a stage
  static constexpr int STAGE = 2 * TILE + (QUANT ? 2 * KV_TILE * 4 : 0);  // K, V, then K's and V's scales
  static constexpr int STAGES = 4 * STAGE <= 128 * 1024 ? 4 : 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int LD = H + 8;  // floats of a stash row: the pad spreads a warp's float2 stores over the banks
  static constexpr int STASH = (F32_ROWS * LD + 2 * F32_ROWS + 2 * F32_ROWS) * 4;  // O, m, l, then each row's max, sum
  static constexpr int RING_OR_STASH = RING > STASH ? RING : STASH;
  static constexpr int Q = F32_ROWS * H * 4;  // the Q tile, fp32
  static constexpr int bytes = RING_OR_STASH + Q;  // the table's entries follow
  // K is read 4 values a lane (4 SZ bytes), a warp's lanes on 8 rows; V one
  // value a lane, on rows 2 t and 2 t + 1: swizzles that keep a read's lanes
  // on distinct banks (row bytes a multiple of 128: H 128, or fp32 and bf16)
  __device__ static int k_chunk(int r, int c) { return c ^ (((r & (8 / SZ - 1)) * SZ) & (CPR - 1)); }
  __device__ static int v_chunk(int r, int c) { return c ^ ((((r >> 1) & 3) * 2) & (CPR - 1)); }
  __device__ static int k_at(int r, int d) {  // byte of K row r, dim d (a multiple of 4)
    return r * RB + k_chunk(r, d * SZ / 16) * 16 + d * SZ % 16;
  }
  __device__ static int v_at(int r, int d) { return r * RB + v_chunk(r, d * SZ / 16) * 16 + d * SZ % 16; }
  // Q row r (fp32), dims d .. d + 3 (d a multiple of 4): read as K is
  __device__ static int q_at(int r, int d) { return r * H * 4 + ((d / 4) ^ ((r & 1) * 4)) * 16; }
};

// cvt.rna.tf32.f32 of a finite x (to nearest, ties away from zero), with the
// low 13 bits cleared, as the subtraction below needs: two integer
// instructions
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo up to |x| 2^-22: hi its TF32 rounding, lo the TF32 rounding of
// the rest, as the registers mma reads
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x = hi + mid + lo exactly: hi and mid TF32 roundings, lo the 2 or 3 bits
// left (a TF32 value)
__device__ __forceinline__ void split3_tf32(float x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = tf32_rna(x);
  const float r = x - __uint_as_float(hi);
  mid = tf32_rna(r);
  lo = __float_as_uint(r - __uint_as_float(mid));
}

// S += Q K^T at fp32 accuracy from a's (hi, lo) and b's values (b0, b1):
// a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first; an exact b
// (B_EXACT) has no lo part
template <bool B_EXACT>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], float b0,
                                           float b1) {
  if constexpr (B_EXACT) {
    mma_tf32(d, al, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(d, ah, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma_tf32(d, al, h0, h1);
    mma_tf32(d, ah, l0, l1);
    mma_tf32(d, ah, h0, h1);
  }
}

// O += P V from p's (hi, lo) and v's values (v0, v1): v in three exact parts,
// p_hi v_lo + p_hi v_mid + p_lo v_hi + p_hi v_hi (p_lo (v_mid + v_lo), ~2^-22,
// dropped), so that a row whose P is a TF32 value (one visible key: P = 1)
// gets V back bit for bit, as fp32 arithmetic does; an exact v has one part
template <bool B_EXACT>
__device__ __forceinline__ void mma_pv(float (&d)[4], const uint32_t (&ph)[4], const uint32_t (&pl)[4], float v0,
                                       float v1) {
  if constexpr (B_EXACT) {
    mma_tf32(d, pl, __float_as_uint(v0), __float_as_uint(v1));
    mma_tf32(d, ph, __float_as_uint(v0), __float_as_uint(v1));
  } else {
    uint32_t h0, m0, l0, h1, m1, l1;
    split3_tf32(v0, h0, m0, l0);
    split3_tf32(v1, h1, m1, l1);
    mma_tf32(d, ph, l0, l1);
    mma_tf32(d, ph, m0, m1);
    mma_tf32(d, pl, h0, h1);
    mma_tf32(d, ph, h0, h1);
  }
}

// 4 adjacent pool values (16, 8 or 4 bytes of shared memory) as fp32
__device__ __forceinline__ float4 widen4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u), __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float4(static_cast<float>(static_cast<int8_t>(w)), static_cast<float>(static_cast<int8_t>(w >> 8)),
                     static_cast<float>(static_cast<int8_t>(w >> 16)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}
__device__ __forceinline__ float4 widen4(const __nv_fp8_e4m3* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  const __half2 lo(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xffff), __NV_E4M3));
  const __half2 hi(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3));
  const float2 a = __half22float2(lo), b = __half22float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float widen1(const float* p) { return *p; }
__device__ __forceinline__ float widen1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float widen1(const int8_t* p) { return static_cast<float>(*p); }
__device__ __forceinline__ float widen1(const __nv_fp8_e4m3* p) { return static_cast<float>(*p); }

// table entry e_lo + i of a block: staged in shared memory (tbl), or read
// from the table row itself (gtbl, when set); gtbl is block-uniform
__device__ __forceinline__ int f32_entry(const int* tbl, const int* gtbl, int i) {
  return gtbl != nullptr ? __ldg(gtbl + i) : tbl[i];
}

// pos / bs for 0 <= pos < 2^31 and bs <= 64 without a division:
// (pos * ceil(2^40 / bs)) >> 40 is exact there (its error is under pos 2^-40)
__device__ __forceinline__ int div_bs(int pos, unsigned long long bs_magic) {
  return static_cast<int>((static_cast<unsigned long long>(pos) * bs_magic) >> 40);
}

// K and V rows of kv positions kv0 .. kv0 + 63 into stage `st`, raw, through
// the block's table entries (entry e_lo first: `f32_entry`); positions past
// `hi` are zeros (scales included) and their entries never read
template <int H, typename KVT>
__device__ __forceinline__ void f32_load(uint8_t* st, const KVT* __restrict__ pool_k, const KVT* __restrict__ pool_v,
                                         const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                                         const int* tbl, const int* gtbl, int e_lo, unsigned long long bs_magic,
                                         const Shape& sh, int kh, int kv0, int hi) {
  using L = F32Tile<H, KVT>;
  const uint8_t* pk = reinterpret_cast<const uint8_t*>(pool_k);
  const uint8_t* pv = reinterpret_cast<const uint8_t*>(pool_v);
  const uint32_t k_t = smem_u32(st), v_t = k_t + L::TILE;
#pragma unroll
  for (int u = 0; u < KV_TILE * L::CPR / F32_THREADS; ++u) {
    const int i = threadIdx.x + u * F32_THREADS, r = i / L::CPR, c = i % L::CPR, pos = kv0 + r;
    const bool live = pos <= hi;
    size_t off = 0;
    if (live) {
      const int e = div_bs(pos, bs_magic);
      off = ((static_cast<size_t>(f32_entry(tbl, gtbl, e - e_lo)) * sh.K + kh) * sh.bs + (pos - e * sh.bs)) * L::RB +
            c * 16;
    }
    cp_async_16(k_t + r * L::RB + L::k_chunk(r, c) * 16, pk + off, live);
    cp_async_16(v_t + r * L::RB + L::v_chunk(r, c) * 16, pv + off, live);
  }
  if constexpr (L::QUANT) {  // threads 0-63 the K scale of row t, threads 64-127 the V scale of row t - 64
    if (threadIdx.x < 2 * KV_TILE) {
      const int r = threadIdx.x % KV_TILE, pos = kv0 + r;
      const bool live = pos <= hi;
      size_t off = 0;
      if (live) {
        const int e = div_bs(pos, bs_magic);
        off = (static_cast<size_t>(f32_entry(tbl, gtbl, e - e_lo)) * sh.K + kh) * sh.bs + (pos - e * sh.bs);
      }
      cp_async_4(k_t + 2 * L::TILE + threadIdx.x * 4, (threadIdx.x < KV_TILE ? k_scale : v_scale) + off, live);
    }
  }
}

// What a block walks: its rows and the kv tiles of its partition
struct F32Walk {
  int b, kh, row0, rows_total, group, start, qlen, cap, j_lo, n_kv, hi, e_lo;
  const int* gtbl;  // the table row from entry e_lo when the entries are not staged, else nullptr
  unsigned long long bs_magic;  // ceil(2^40 / bs), for div_bs
};

// The kv walk with CW warps on each row (CW = 1: the warps split the rows;
// CW = 8: the warps split each tile's columns over the first 16 rows), then
// each warp's (m, l, O) stashed in shared memory: stash row 16 w + r
template <int H, typename KVT, int CW>
__device__ __forceinline__ void f32_walk(const void* __restrict__ q, const KVT* __restrict__ pool_k,
                                         const KVT* __restrict__ pool_v, const float* __restrict__ k_scale,
                                         const float* __restrict__ v_scale, const int* tbl, uint8_t* smem,
                                         const Shape& sh, const F32Walk& wk) {
  using L = F32Tile<H, KVT>;
  constexpr bool EXACT = L::EXACT;
  constexpr int RW = F32_WARPS / CW, NC = KV_TILE / CW, NJ = NC / 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % RW, c0 = (warp / RW) * NC;  // the warp's row group, its first column of a tile
  const int wr0 = wk.row0 + 16 * rg;
  // rows g and g + 8 of the warp: their last visible position (-1: dead)
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int fr = wr0 + g + 8 * h;
    lim[h] = fr < wk.rows_total && fr / wk.group < wk.qlen ? min(wk.start + fr / wk.group, wk.cap - 1) : -1;
  }
  int whi = max(lim[0], lim[1]);  // the last position any row of the warp sees
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o));

  // the Q tile's first 16 RW rows into shared memory, fp32 (dead rows
  // zero): with the first kv tile's copies, or stored before its barrier
  const uint32_t q_s = smem_u32(smem + L::RING_OR_STASH);
  if (wk.n_kv > 0) {
    for (int i = threadIdx.x; i < 16 * RW * (H / 4); i += F32_THREADS) {
      const int r = i / (H / 4), d = (i % (H / 4)) * 4, fr = wk.row0 + r;
      const bool live = fr < wk.rows_total && fr / wk.group < wk.qlen;
      const size_t off =
          live ? ((static_cast<size_t>(wk.b) * sh.T + fr / wk.group) * sh.N + wk.kh * wk.group + fr % wk.group) * H + d
               : 0;
      if (!sh.q_bf16)
        cp_async_16(q_s + L::q_at(r, d), static_cast<const float*>(q) + off, live);
      else
        *reinterpret_cast<float4*>(smem + L::RING_OR_STASH + L::q_at(r, d)) =
            live ? widen4(static_cast<const __nv_bfloat16*>(q) + off) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const uint8_t* q_t = smem + L::RING_OR_STASH;

  float o[H / 8][4];
#pragma unroll
  for (int i = 0; i < H / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // m: the row max of S, before the softmax scale
  const float sl2 = sh.scale * LOG2E;

#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < wk.n_kv)
      f32_load<H>(smem + s * L::STAGE, pool_k, pool_v, k_scale, v_scale, tbl, wk.gtbl, wk.e_lo, wk.bs_magic, sh, wk.kh,
                  (wk.j_lo + s) * KV_TILE, wk.hi);
    cp_async_commit();
  }
  for (int it = 0; it < wk.n_kv; ++it) {
    const int kv0 = (wk.j_lo + it) * KV_TILE;
    __syncthreads();  // every reader of tile it - 1 is done: its stage takes tile it + STAGES - 1, now
    {
      const int nx = it + L::STAGES - 1;
      if (nx < wk.n_kv)
        f32_load<H>(smem + (nx % L::STAGES) * L::STAGE, pool_k, pool_v, k_scale, v_scale, tbl, wk.gtbl, wk.e_lo,
                    wk.bs_magic, sh, wk.kh, (wk.j_lo + nx) * KV_TILE, wk.hi);
      cp_async_commit();
    }
    cp_async_wait<L::STAGES - 1>();  // this thread's copies of tile it (and of Q) have landed
    __syncthreads();                 // everyone's have
    if (kv0 + c0 > whi) continue;  // warp-uniform: no row of the warp sees its columns of this tile
    const uint8_t* kt = smem + (it % L::STAGES) * L::STAGE;
    const uint8_t* vt = kt + L::TILE;
    const float* col_scale = reinterpret_cast<const float*>(kt + 2 * L::TILE);

    float s[NJ][4];  // S: rows g, g + 8 ([e / 2]); columns c0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      uint32_t ah[2][4], al[2][4];  // k-steps 2 kk (dims + 0, + 1) and 2 kk + 1 (dims + 2, + 3)
      const float4 qa = *reinterpret_cast<const float4*>(q_t + L::q_at(16 * rg + g, 16 * kk + 4 * t));
      const float4 qb = *reinterpret_cast<const float4*>(q_t + L::q_at(16 * rg + g + 8, 16 * kk + 4 * t));
      split_tf32(qa.x, ah[0][0], al[0][0]);
      split_tf32(qb.x, ah[0][1], al[0][1]);
      split_tf32(qa.y, ah[0][2], al[0][2]);
      split_tf32(qb.y, ah[0][3], al[0][3]);
      split_tf32(qa.z, ah[1][0], al[1][0]);
      split_tf32(qb.z, ah[1][1], al[1][1]);
      split_tf32(qa.w, ah[1][2], al[1][2]);
      split_tf32(qb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = c0 + 8 * j + g;
        const float4 kv = widen4(reinterpret_cast<const KVT*>(kt + L::k_at(n, 16 * kk + 4 * t)));
        mma_3xtf32<EXACT>(s[j], ah[0], al[0], kv.x, kv.y);
        mma_3xtf32<EXACT>(s[j], ah[1], al[1], kv.z, kv.w);
      }
    }
    if constexpr (L::QUANT) {  // S[r, c] = k_scale[c] (q_r . kq_c)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= col_scale[c0 + 8 * j + 2 * t + e % 2];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kv0 + c0 + 8 * j + 2 * t + e % 2 > lim[e / 2]) s[j][e] = NEG_INF;

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float a[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      // p = exp2(s sl2 - m sl2); a row that has seen nothing yet subtracts 0,
      // so its NEG_INF entries give p = 0. s sl2 is rounded before the
      // subtraction (no fma), so the row's max gives exp2(0) = 1 exactly
      mu[h] = mn == NEG_INF ? 0.f : mn * sl2;
      a[h] = exp2f(__fmul_rn(m[h], sl2) - mu[h]);
      m[h] = mn;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(__fmul_rn(s[j][e], sl2) - mu[e / 2]);
        ps[e / 2] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * a[h] + ps[h];  // this lane's share of the row sum
#pragma unroll
    for (int i = 0; i < H / 8; ++i) {
      o[i][0] *= a[0];
      o[i][1] *= a[0];
      o[i][2] *= a[1];
      o[i][3] *= a[1];
    }
    if constexpr (L::QUANT) {  // O += (P v_scale) Vq; l is of P
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= col_scale[KV_TILE + c0 + 8 * j + 2 * t + e % 2];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // O += P V over kv rows c0 + 8 j .. + 7: lane (g, t)'s k are rows 2 t, 2 t + 1
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const int r0 = c0 + 8 * j + 2 * t;
#pragma unroll
      for (int i = 0; i < H / 8; ++i) {
        const float v0 = widen1(reinterpret_cast<const KVT*>(vt + L::v_at(r0, 8 * i + g)));
        const float v1 = widen1(reinterpret_cast<const KVT*>(vt + L::v_at(r0 + 1, 8 * i + g)));
        mma_pv<EXACT>(o[i], ph, pl, v0, v1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: the stash takes its place

  float* st_o = reinterpret_cast<float*>(smem);
  float* st_m = st_o + F32_ROWS * L::LD;
  float* st_l = st_m + F32_ROWS;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int sr = 16 * warp + g + 8 * h;
    if (t == 0) {
      st_m[sr] = m[h];
      st_l[sr] = l[h];
    }
    if (m[h] != NEG_INF) {  // a row that saw nothing contributes nothing: its O is not read
#pragma unroll
      for (int i = 0; i < H / 8; ++i)
        *reinterpret_cast<float2*>(st_o + sr * L::LD + 8 * i + 2 * t) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
    }
  }
}

template <int H, typename KVT>
__global__ void __launch_bounds__(F32_THREADS, 1)
    paged_attention_kernel_f32(const void* __restrict__ q, const KVT* __restrict__ pool_k,
                               const KVT* __restrict__ pool_v, const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale, const int* __restrict__ tables,
                               const int* __restrict__ q_start, const int* __restrict__ q_lens, void* __restrict__ out,
                               float* __restrict__ part_o, float* __restrict__ part_ml, Shape sh) {
  using L = F32Tile<H, KVT>;
  extern __shared__ __align__(16) uint8_t f32_smem[];
  uint8_t* smem = f32_smem;

  const int group = sh.N / sh.K, rows_total = sh.T * group;
  const int n_tiles = (rows_total + F32_ROWS - 1) / F32_ROWS;
  // the last row tile first: under the causal mask it walks the most kv tiles
  const int tile = n_tiles - 1 - static_cast<int>(blockIdx.x) / sh.parts, part = blockIdx.x % sh.parts;
  F32Walk wk;
  wk.b = blockIdx.z;
  wk.kh = blockIdx.y;
  wk.row0 = tile * F32_ROWS;
  wk.rows_total = rows_total;
  wk.group = group;
  wk.start = q_start[wk.b];
  wk.qlen = min(q_lens[wk.b], sh.T);
  wk.cap = sh.mb * sh.bs;
  const int t_first = wk.row0 / group, t_last = (min(wk.row0 + F32_ROWS, rows_total) - 1) / group;
  // the highest kv position a live row of this tile sees (-1: none live)
  wk.hi = t_first < wk.qlen ? min(wk.start + min(t_last, wk.qlen - 1), wk.cap - 1) : -1;
  wk.j_lo = part * (sh.part_len / KV_TILE);
  const int j_hi = (min((part + 1) * sh.part_len, wk.hi + 1) + KV_TILE - 1) / KV_TILE;
  wk.n_kv = max(j_hi - wk.j_lo, 0);
  if (sh.parts > 1 && wk.n_kv == 0) return;  // nothing to merge from this partition
  // the table entries of the positions the walk reads, once (up to
  // F32_TBL_SMEM of them; past that the walk reads the table row itself)
  wk.e_lo = wk.j_lo * KV_TILE / sh.bs;
  wk.bs_magic = ((1ull << 40) + sh.bs - 1) / sh.bs;
  const int e_n = wk.n_kv > 0 ? (min(j_hi * KV_TILE, wk.hi + 1) - 1) / sh.bs - wk.e_lo + 1 : 0;
  int* tbl = reinterpret_cast<int*>(smem + L::bytes);
  const int* row = tables + static_cast<size_t>(wk.b) * sh.mb + wk.e_lo;
  wk.gtbl = e_n <= F32_TBL_SMEM ? nullptr : row;
  if (wk.gtbl == nullptr)
    for (int i = threadIdx.x; i < e_n; i += F32_THREADS) tbl[i] = row[i];
  __syncthreads();

  const int live_rows = min(max(min(wk.qlen * group, rows_total) - wk.row0, 0), F32_ROWS);
  const bool cols = live_rows <= 16;  // the warps split the columns of the first 16 rows
  if (cols)
    f32_walk<H, KVT, F32_WARPS>(q, pool_k, pool_v, k_scale, v_scale, tbl, smem, sh, wk);
  else
    f32_walk<H, KVT, 1>(q, pool_k, pool_v, k_scale, v_scale, tbl, smem, sh, wk);
  __syncthreads();

  // combine the warps' stashed rows in warp order: tile row r is stash row
  // 16 (c rw + r / 16) + r % 16 of column group c (rw row groups)
  const float* st_o = reinterpret_cast<const float*>(smem);
  float* st_m = const_cast<float*>(st_o) + F32_ROWS * L::LD;
  const float* st_l = st_m + F32_ROWS;
  float* row_m = st_m + 2 * F32_ROWS;
  float* row_l = row_m + F32_ROWS;
  const int cw = cols ? F32_WARPS : 1, rw = F32_WARPS / cw, rows_c = 16 * rw;
  const float sl2 = sh.scale * LOG2E;
  for (int r = threadIdx.x; r < F32_ROWS; r += F32_THREADS) {
    float mu = NEG_INF, sum = 0.f;
    if (r < rows_c) {
      for (int c = 0; c < cw; ++c) mu = fmaxf(mu, st_m[16 * (c * rw + r / 16) + r % 16]);
      for (int c = 0; c < cw; ++c) {  // each warp's weight replaces its max
        const int sr = 16 * (c * rw + r / 16) + r % 16;
        const float mc = st_m[sr];
        const float w = mc == NEG_INF ? 0.f : exp2f(mc * sl2 - mu * sl2);
        st_m[sr] = w;
        sum += w * st_l[sr];
      }
    }
    row_m[r] = mu;
    row_l[r] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < F32_ROWS * (H / 4); i += F32_THREADS) {
    const int r = i / (H / 4), d = (i % (H / 4)) * 4, fr = wk.row0 + r;
    if (fr >= rows_total) break;  // rows run in order: the rest of this thread's are past the end too
    const bool live = fr / group < wk.qlen;
    if (sh.parts > 1 && !live) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_c) {
      for (int c = 0; c < cw; ++c) {
        const int sr = 16 * (c * rw + r / 16) + r % 16;
        const float w = st_m[sr];
        if (w != 0.f) {  // a warp that saw nothing of the row stashed no O
          const float4 x = *reinterpret_cast<const float4*>(st_o + sr * L::LD + d);
          acc.x += w * x.x;
          acc.y += w * x.y;
          acc.z += w * x.z;
          acc.w += w * x.w;
        }
      }
    }
    if (sh.parts == 1) {  // every row: dead rows have l == 0 and O == 0, exact zeros
      const float den = fmaxf(row_l[r], 1e-37f);
      const size_t orow = (static_cast<size_t>(wk.b) * sh.T + fr / group) * sh.N + wk.kh * group + fr % group;
      if (sh.q_bf16) {
        __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out) + orow * H + d;
        store2(op, acc.x / den, acc.y / den);
        store2(op + 2, acc.z / den, acc.w / den);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + orow * H + d) =
            make_float4(acc.x / den, acc.y / den, acc.z / den, acc.w / den);
      }
    } else {  // live rows: (m scale log2(e), l, O) of this partition, unnormalised
      const size_t prow = ((static_cast<size_t>(wk.b) * sh.K + wk.kh) * sh.parts + part) * rows_total + fr;
      *reinterpret_cast<float4*>(part_o + prow * H + d) = acc;
      if (d == 0)
        *reinterpret_cast<float2*>(part_ml + prow * 2) =
            make_float2(row_m[r] == NEG_INF ? NEG_INF : row_m[r] * sl2, row_l[r]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <int H, typename KVT>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* k_scale, const void* v_scale,
                   const void* tables, const void* q_start, const void* q_lens, void* out, void* part_o,
                   void* part_ml, int B, const Shape& sh, cudaStream_t s) {
  auto kernel = paged_attention_kernel_sm90<H, KVT>;
  // above 48 KB only as opted-in dynamic shared memory: set once per
  // instantiation and device, not on every launch
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Smem<H, KVT>::bytes));
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int tiles = (sh.T * (sh.N / sh.K) + ROWS - 1) / ROWS;
  dim3 grid(tiles * sh.parts, sh.K, B);
  kernel<<<grid, THREADS, Smem<H, KVT>::bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KVT*>(pool_k), static_cast<const KVT*>(pool_v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(q_start), static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.parts == 1) return err;
  const int rows = B * sh.T * sh.N;
  paged_attention_merge_sm90<H, __nv_bfloat16><<<(rows + MERGE_ROWS - 1) / MERGE_ROWS, MERGE_ROWS * 32, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml), static_cast<const int*>(q_start),
      static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out), B, sh);
  return cudaGetLastError();
}

template <int H, typename KVT>
cudaError_t launch_f32(const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
                       const void* v_scale, const void* tables, const void* q_start, const void* q_lens, void* out,
                       void* part_o, void* part_ml, int B, const Shape& sh, cudaStream_t s) {
  auto kernel = paged_attention_kernel_f32<H, KVT>;
  // the table entries a block stages: one partition's positions, or the
  // whole row, up to F32_TBL_SMEM (a block that reads more stages none)
  const int entries = min(min(sh.mb, (sh.part_len - 1) / sh.bs + 2), F32_TBL_SMEM);
  const size_t bytes = F32Tile<H, KVT>::bytes + static_cast<size_t>(entries) * 4;
  // opt in once per instantiation and device to all the shared memory a
  // block may have (at most ~200 KB is asked for)
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int tiles = (sh.T * (sh.N / sh.K) + F32_ROWS - 1) / F32_ROWS;
  dim3 grid(tiles * sh.parts, sh.K, B);
  kernel<<<grid, F32_THREADS, bytes, s>>>(q, static_cast<const KVT*>(pool_k), static_cast<const KVT*>(pool_v),
                                           static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                                           static_cast<const int*>(tables), static_cast<const int*>(q_start),
                                           static_cast<const int*>(q_lens), out, static_cast<float*>(part_o),
                                           static_cast<float*>(part_ml), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess || sh.parts == 1) return err;
  const int rows = B * sh.T * sh.N, merge_blocks = (rows + MERGE_ROWS - 1) / MERGE_ROWS;
  const float* po = static_cast<const float*>(part_o);
  const float* pm = static_cast<const float*>(part_ml);
  if (sh.q_bf16)
    paged_attention_merge_sm90<H, __nv_bfloat16><<<merge_blocks, MERGE_ROWS * 32, 0, s>>>(
        po, pm, static_cast<const int*>(q_start), static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out),
        B, sh);
  else
    paged_attention_merge_sm90<H, float><<<merge_blocks, MERGE_ROWS * 32, 0, s>>>(
        po, pm, static_cast<const int*>(q_start), static_cast<const int*>(q_lens), static_cast<float*>(out), B, sh);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch_f32(int kv_dtype, const void* q, const void* pool_k, const void* pool_v, const void* k_scale,
                         const void* v_scale, const void* tables, const void* q_start, const void* q_lens, void* out,
                         void* part_o, void* part_ml, int B, const Shape& sh, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch_f32<H, float>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                  part_ml, B, sh, s);
    case 1:
      return launch_f32<H, __nv_bfloat16>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                          part_ml, B, sh, s);
    case 2:
      return launch_f32<H, int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                   part_ml, B, sh, s);
    default:
      return launch_f32<H, __nv_fp8_e4m3>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                          part_ml, B, sh, s);
  }
}

// The checks both entries make; cudaSuccess when the launch may go ahead.
cudaError_t check_args(const void* q, const void* pool_k, const void* pool_v, void* out, void* part_o, void* part_ml,
                       int B, int T, int N, int K, int H, int bs, int mb, int parts, int part_len) {
  if (bs < 1 || bs > MAX_BS || K < 1 || N % K != 0 || (H != 64 && H != 128) || mb < 1 || B > 65535 || K > 65535 ||
      parts < 1 || part_len < KV_TILE || part_len % KV_TILE != 0 ||
      static_cast<long long>(parts) * part_len < static_cast<long long>(mb) * bs ||
      static_cast<long long>((T * (N / K) + ROWS - 1) / ROWS) * parts > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(pool_k) || !aligned16(pool_v) || !aligned16(out) ||
      (parts > 1 && (part_o == nullptr || part_ml == nullptr || !aligned16(part_o) || !aligned16(part_ml))))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// q [B, T, N, H] bf16; pool_k/pool_v [nb, K, bs, H] bf16; tables [B, mb],
// q_start/q_lens [B] int32; out [B, T, N, H] bf16. `parts` kv partitions of
// `part_len` positions (a multiple of 64, parts * part_len >= mb * bs); with
// parts > 1, part_o [B, K, parts, T * N / K, H] and part_ml [B, K, parts,
// T * N / K, 2] fp32 are the partitions' scratch (no initial value). Launches
// on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for an
// unsupported H, block size or geometry, or a pointer that is not 16-byte
// aligned).
extern "C" int pdnlp_ragged_paged_attention_sm90(const void* q, const void* pool_k, const void* pool_v,
                                                 const void* tables, const void* q_start, const void* q_lens,
                                                 void* out, void* part_o, void* part_ml, int B, int T, int N, int K,
                                                 int H, int bs, int mb, int parts, int part_len, float scale,
                                                 void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const cudaError_t bad = check_args(q, pool_k, pool_v, out, part_o, part_ml, B, T, N, K, H, bs, mb, parts, part_len);
  if (bad != cudaSuccess) return bad;
  const Shape sh{T, N, K, bs, mb, parts, part_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64 ? launch<64, __nv_bfloat16>(q, pool_k, pool_v, nullptr, nullptr, tables, q_start, q_lens, out,
                                             part_o, part_ml, B, sh, s)
                 : launch<128, __nv_bfloat16>(q, pool_k, pool_v, nullptr, nullptr, tables, q_start, q_lens, out,
                                              part_o, part_ml, B, sh, s);
}

// The same over a quantized pool: pool_k/pool_v [nb, K, bs, H] int8
// (kv_dtype 2) or fp8-e4m3 (kv_dtype 3), k_scale/v_scale [nb, K, bs, 1] fp32
// (4-byte aligned); the other arguments and the return as above.
extern "C" int pdnlp_ragged_paged_attention_sm90_quant(const void* q, const void* pool_k, const void* pool_v,
                                                       const void* k_scale, const void* v_scale, const void* tables,
                                                       const void* q_start, const void* q_lens, void* out,
                                                       void* part_o, void* part_ml, int B, int T, int N, int K,
                                                       int H, int bs, int mb, int parts, int part_len, int kv_dtype,
                                                       float scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const cudaError_t bad = check_args(q, pool_k, pool_v, out, part_o, part_ml, B, T, N, K, H, bs, mb, parts, part_len);
  if (bad != cudaSuccess) return bad;
  if ((kv_dtype != 2 && kv_dtype != 3) || k_scale == nullptr || v_scale == nullptr ||
      reinterpret_cast<uintptr_t>(k_scale) % 4 != 0 || reinterpret_cast<uintptr_t>(v_scale) % 4 != 0)
    return cudaErrorInvalidValue;
  const Shape sh{T, N, K, bs, mb, parts, part_len, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 2)
    return H == 64 ? launch<64, int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                        part_ml, B, sh, s)
                   : launch<128, int8_t>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out, part_o,
                                         part_ml, B, sh, s);
  return H == 64 ? launch<64, __nv_fp8_e4m3>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out,
                                             part_o, part_ml, B, sh, s)
                 : launch<128, __nv_fp8_e4m3>(q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out,
                                              part_o, part_ml, B, sh, s);
}

// The fp32 route: q [B, T, N, H] fp32 (q_dtype 0) over a pool of kv_dtype 0
// (fp32), 1 (bf16), 2 (int8) or 3 (fp8-e4m3), or bf16 (q_dtype 1) over an
// fp32 pool; out in q's type; k_scale/v_scale [nb, K, bs, 1] fp32 (4-byte
// aligned) for kv_dtype 2 and 3, else unread; the other arguments and the
// return as above.
extern "C" int pdnlp_ragged_paged_attention_sm90_f32(const void* q, const void* pool_k, const void* pool_v,
                                                     const void* k_scale, const void* v_scale, const void* tables,
                                                     const void* q_start, const void* q_lens, void* out, void* part_o,
                                                     void* part_ml, int B, int T, int N, int K, int H, int bs, int mb,
                                                     int parts, int part_len, int q_dtype, int kv_dtype, float scale,
                                                     void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  const cudaError_t bad = check_args(q, pool_k, pool_v, out, part_o, part_ml, B, T, N, K, H, bs, mb, parts, part_len);
  if (bad != cudaSuccess) return bad;
  if ((q_dtype != 0 && q_dtype != 1) || kv_dtype < 0 || kv_dtype > 3 || (q_dtype == 1 && kv_dtype != 0))
    return cudaErrorInvalidValue;
  if (kv_dtype >= 2 && (k_scale == nullptr || v_scale == nullptr || reinterpret_cast<uintptr_t>(k_scale) % 4 != 0 ||
                        reinterpret_cast<uintptr_t>(v_scale) % 4 != 0))
    return cudaErrorInvalidValue;
  const Shape sh{T, N, K, bs, mb, parts, part_len, scale, q_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64 ? dispatch_f32<64>(kv_dtype, q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out,
                                    part_o, part_ml, B, sh, s)
                 : dispatch_f32<128>(kv_dtype, q, pool_k, pool_v, k_scale, v_scale, tables, q_start, q_lens, out,
                                     part_o, part_ml, B, sh, s);
}
