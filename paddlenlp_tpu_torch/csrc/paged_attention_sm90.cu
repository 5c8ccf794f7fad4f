// Ragged paged attention on Hopper tensor cores (sm_90a), bf16 queries over a
// bf16, int8 or fp8-e4m3 pool, CUDA C++ with a plain C entry for each pool
// kind.
//
// Replaces, for the serving path's types, the Pallas TPU kernel
// paddlenlp_tpu/ops/pallas/paged_attention.py `_kernel` (:56), launched at
// :159 by `ragged_paged_attention` (:105). Same function as the SIMT kernel of
// paged_attention.cu, which stays the route for fp32 queries or pools (the
// precise check): query token t of sequence b sits at position
// q_start[b] + t and sees kv positions <= q_start[b] + t of its block table;
// rows t >= q_lens[b], and every row of a q_lens == 0 sequence, are exact
// zeros; GQA folds query head n = kh * group + g of token t into row
// t * group + g of kv head kh; NEG_INF = -1e30 masking, the online softmax in
// fp32 (exp2, scale * log2(e) folded into one FMA), the finalizer divides by
// max(l, 1e-37).
//
// Layouts: q, out [B, T, N, H] bf16; pool_k, pool_v [nb, K, bs, H] bf16,
// int8 or fp8-e4m3 (any bs in 1..64), the quantized ones with k_scale,
// v_scale [nb, K, bs, 1] fp32 (position p's K row is k_scale[p] * kq[p], as
// the Pallas kernel dequantizes at :83-85); tables [B, mb], q_start, q_lens
// [B] int32; H 64 or 128.
//
// What bounds it on an H100:
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

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;  // folded query rows of a block: one warpgroup's wgmma M
constexpr int KV_TILE = 64;  // kv positions of a tile
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int MAX_BS = 64;
constexpr int MAX_DEVICES = 64;
constexpr int MERGE_ROWS = 4;  // output rows of a merge block, one a warp

struct Shape {
  int T, N, K, bs, mb, parts, part_len;  // part_len: kv positions of a partition, a multiple of KV_TILE
  float scale;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; valid == false writes zeros and reads nothing
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// 4 bytes global -> shared, asynchronous, the same zero fill
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
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
// One warp an output row (b, t, n): the partitions the row's live positions
// reach, combined in partition order (deterministic); dead rows exact zeros.
template <int H>
__global__ void __launch_bounds__(MERGE_ROWS * 32)
    paged_attention_merge_sm90(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                               const int* __restrict__ q_start, const int* __restrict__ q_lens,
                               __nv_bfloat16* __restrict__ out, int B, Shape sh) {
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
  __nv_bfloat16* op = out + static_cast<size_t>(w) * H + lane * PER_LANE;
#pragma unroll
  for (int i = 0; i < PER_LANE; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(op + i) = __floats2bfloat162_rn(acc[i] / d, acc[i + 1] / d);
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
  paged_attention_merge_sm90<H><<<(rows + MERGE_ROWS - 1) / MERGE_ROWS, MERGE_ROWS * 32, 0, s>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml), static_cast<const int*>(q_start),
      static_cast<const int*>(q_lens), static_cast<__nv_bfloat16*>(out), B, sh);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
