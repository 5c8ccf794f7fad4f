// Flash attention for fp32 operands on Hopper tensor cores (sm_90a), CUDA C++
// with plain C entries: the forward, dq, and dk/dv with the merge of its
// partial sums.
//
// Routes (ops/flash_attention.py `kernel_route`): bf16 operands, the training
// path's, take the three kernels of flash_attention_sm90.cu (wgmma); fp32
// operands take this file's three. fp32 operands are a model computing in
// fp32 and the fp32 checks (1e-4 elementwise, loss rel 1e-5, gradient leaves
// 1e-4), which bf16 operands cannot meet.
//
// Replaces, for fp32 operands, the Pallas TPU kernels `_fa_kernel`
// (paddlenlp_tpu/ops/pallas/flash_attention.py:81, launched at :157 by
// `_flash_fwd` :131), `_bwd_dq_kernel` (:187, launched at :293 by
// `_flash_bwd` :272) and `_bwd_dkv_kernel` (:227, launched at :317). Same
// function as theirs and as flash_attention_sm90.cu's bf16 kernels: causal or
// full attention, an optional window (causal only), packed segment ids, GQA
// (query head n reads kv head n / (N / K)); NEG_INF = -1e30 masking with
// invisible entries forced to p = 0. The forward's softmax is online; it
// stores out = acc / max(l, 1e-37) and lse = m + log(max(l, 1e-37)) as a
// natural log (NEG_INF + log(1e-37) on a row that sees no key, whose out is
// 0), which the backward reads. The backward: p = exp(s scale - lse),
// ds = p (dP - delta) scale; dq = ds K, and dk = ds^T Q, dv = p^T dO summed
// over each kv head's whole query group. Rows past T or S are zero-filled on
// load (their lse and delta too), so no padding row reaches a sum, and are
// never stored.
//
// Layouts: q, out, dO, dq [B, T, N, H]; k, v, dk, dv [B, S, K, H] (fp32,
// 16-byte aligned); lse, delta [B, N, T] fp32; seg [B, T] int32 (or null);
// H 64, 128 or 192 (DeepSeek-V2's MLA: q and k at 128 + 64, v padded up to
// them). Gate against the plain versions: |kernel - plain| <= 1e-4 of the
// tensor's largest element.
//
// What bounds it on an H100: operations. At q [2, 2048, 12, 128] over k/v
// [2, 2048, 2, 128], causal, the forward's two products need 0.156 ms, dq's
// three 0.234 ms and dk/dv's four 0.313 ms at a third of the 495 TFLOP/s TF32
// rate (three TF32 products a product), 0.385, 0.577 and 0.770 ms at the 67
// TFLOP/s of fp32 CUDA cores. Design:
// - Products on the tensor cores at fp32 accuracy, 3xTF32: each operand x is
//   split in registers into hi = x rounded to TF32 (to nearest, two integer
//   instructions) and lo = x - hi, whose low 13 bits the tensor core ignores
//   (a truncation, |error| < 2^-21 |x|); a product is a_lo b_hi + a_hi b_lo +
//   a_hi b_hi into fp32 accumulators with mma.sync.m16n8k8.row.col.f32.tf32.
//   tf32.f32 (a_lo b_lo, ~2^-22 of it, dropped). One TF32 pass (~2^-11 a
//   product) misses the 1e-4 gate, in the forward as in the backward
//   (tests/test_torch_flash_attention.py emulates both). mma.sync, not wgmma:
//   wgmma reads B from shared memory, so a split operand would need hi and lo
//   copies there (a 64 x 128 fp32 tile is already 32 KB); mma.sync takes its
//   fragments from registers.
// - One shape for all three kernels. A block keeps 64 rows of one or two
//   tensors in shared memory (the forward: Q of its query rows; dq: Q and dO;
//   dk/dv: K and V of its kv rows), one warp to 16 of them, and streams
//   16-row tiles of the others (the forward and dq: K and V; dk/dv: Q and dO,
//   with their lse, delta and segment ids) through a 2-stage `cp.async` ring
//   of 16-byte copies, zero-filled past T or S. Each warp computes its 16 x 16
//   scores with its resident rows as the mma's M: S = Q K^T in the forward,
//   S = Q K^T and dP = dO V^T in dq, S^T = K Q^T and dP^T = V dO^T in dk/dv,
//   so P (the forward), dS (dq) or P^T and dS^T (dk/dv) come out in the
//   accumulator layout and serve as the A fragments of O += P V, of
//   dq += dS K, or of dv += P^T dO and dk += dS^T Q, as they are: the k index
//   of those products is a sum index, and lanes may take any permutation of
//   it as long as A and B agree (lane (g, t) holds columns 2t, 2t + 1 of each
//   8, and reads rows 2t, 2t + 1 of the streamed tile as B). No shuffles and
//   no transpose through shared memory, but for the forward's row max and sum
//   over the four lanes of a row. A step's accumulating product sums into a
//   fresh fragment that an fp32 add then adds to the running sum: the tensor
//   core's own accumulation is less exact than an fp32 add and its errors do
//   not average out, so with every mma into the running dk/dv sums the error
//   grew faster than the walk, to 0.48 of the gate at T 4095 (0.055 with the
//   fresh fragments).
// - Tiles are fp32 rows with 16-byte chunks XOR-swizzled by row (`swz`) so
//   that both ways a warp reads a tile hit 32 distinct banks: float4 rows
//   (the score products' A and B) and single columns (the B of the
//   accumulating products, rows 2t and 2t + 1 of column 8i + g). The reads
//   fold the swizzle into a few offsets a lane.
// - 128 threads a block, at most 255 registers a thread (dk/dv's dK and dV
//   sums take 128 of them at H 128, the forward's O 64), no spill, and two
//   blocks an SM (96 KB of shared memory a block for the backward, 64 KB for
//   the forward). Tiles that no row can see are never loaded (the
//   `_block_runs` skip, :71, at 16-row steps), and a warp skips the steps
//   none of its rows can see.
// - The forward: one block per (64 query rows, head, batch), the last query
//   tile first (under the causal mask it walks the most kv tiles). Its online
//   softmax runs in the accumulator layout, in exp2 with scale log2(e) folded
//   into the scores: lane (g, t) holds rows g and g + 8, their running max m
//   (the same in the four lanes of a row, two `__shfl_xor_sync` a step) and
//   a partial sum l of its own columns, rescaled with the row and summed over
//   the four lanes once at the end. Each step rescales O by exp2(m_old -
//   m_new), then O += P V.
// - dq: one block per (64 query rows, head, batch), the last query tile
//   first; it owns its rows of dq, so no atomics.
// - dk/dv: one block per 64-row kv tile walks the (query head, 16-row query
//   tile) pairs of the kv head's group in order. The walk of a tile is cut
//   into parts of `chunk` steps (chosen by the caller so that the launch
//   fills about three waves of two blocks an SM: the causal mask makes the
//   first kv tile's walk the longest, ~32x the last's at T 2048, and its 128
//   tiles would fill half a wave); a tile of one part writes dk and dv
//   itself, one of several writes fp32 partial sums to a workspace that
//   flash_bwd_dkv_merge_f32 adds in part order. No float atomics: two
//   launches on one card give the same bits.
// - H 192 (`Plan`): one warp's output sums at 16 rows x 192 columns would be
//   96 floats a lane (192 for dk/dv's two), past what 255 registers hold
//   beside the fragments. So the head dim is split over warp pairs: 8 warps a
//   block, the two warps of a pair own the same 16 resident rows (the tile
//   stays 64 rows) and each owns 96 of the output columns, whose sums
//   (acc[12][4]) are fewer than H 128's. Each score product's inner sum over
//   192 dims is split the same way: each warp of the pair sums its 96 dims
//   (with the H 64/128 fragments and order), writes its partial 16 x 16 tile
//   to shared memory (1 KB a warp a product), waits on a named barrier of the
//   pair's 64 threads, and adds its partner's (a + b is b + a in fp32: both
//   warps hold the same bits). Both then apply the mask and the softmax (or
//   dS) to the whole tile, and each multiplies by its own 96 columns of V, K,
//   Q or dO. No product is computed twice. One block an SM (the backward's
//   tiles take ~160 KB of shared memory), the same 8 warps an SM as H 128's
//   two blocks, at most 255 registers a thread.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;     // the merge kernel's
constexpr int RES = 64;          // resident rows of a block, 16 a warp (a warp pair at H 192)
constexpr int STEP = 16;         // rows of a streamed tile
constexpr int STAGES = 2;
constexpr int FWD_COLS = 16;     // kv columns of one forward step (one online-softmax update), 16 or 32

// The warps of head dim H's kernels: at H 64 and 128 a warp owns 16 resident
// rows and all H columns (4 warps, two blocks an SM); at H 192 a pair of warps
// owns 16 rows, each warp DW = 96 of the columns and of a score product's
// inner dims (8 warps, one block an SM)
template <int H>
struct Plan {
  static constexpr int PAIR = H > 128 ? 2 : 1;  // warps that share 16 resident rows
  static constexpr int DW = H / PAIR;           // columns of a warp
  static constexpr int WARPS = 4 * PAIR;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MIN_BLOCKS = PAIR == 1 ? 2 : 1;
  // shared floats of one partial score tile a warp (16 x 16), per product slot
  static constexpr int XCH = PAIR == 1 ? 0 : WARPS * 256;
};

struct Geometry {
  int B, T, S, N, K, causal, window;  // window < 0: none (causal only)
  float scale;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// The dk/dv walk of kv tile `tile` (rows 64 tile ..): each query head of the
// group walks its 16-row query tiles lo .. lo + per_head - 1 (those that can
// see the kv tile); `parts` pieces of at most `chunk` steps. Mirrored by
// ops/flash_attention.py `dkv_split`, which sizes the workspace.
struct DkvWalk {
  int lo, per_head, total, parts;
};

__host__ __device__ __forceinline__ DkvWalk dkv_walk(const Geometry& g, int tile, int chunk) {
  const int n_qs = cdiv(g.T, STEP), kv0 = tile * RES;
  int lo = 0, hi = n_qs;
  if (g.causal) {
    lo = kv0 / STEP;  // query rows before kv0 see none of the tile
    if (g.window >= 0) {
      const int last = imin(kv0 + RES, g.S) - 1 + g.window - 1;  // the last query row that sees the tile
      hi = last < 0 ? 0 : imin(n_qs, last / STEP + 1);
    }
  }
  DkvWalk w;
  w.lo = lo;
  w.per_head = imax(hi - lo, 0);
  w.total = (g.N / g.K) * w.per_head;
  w.parts = imax(1, cdiv(w.total, chunk));
  return w;
}

// ------------------------------------------------------------------ TF32
// x = hi + lo: hi x rounded to TF32 (to nearest, ties away from zero, low 13
// bits cleared), lo the rest as fp32, of which mma reads the TF32 part
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b at fp32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// ------------------------------------------------------------------ tiles
// Row r of a tile holds its 16-byte chunk c at chunk c ^ swz(r). A warp's
// float4 reads (rows g and g + 1 for each quarter of the warp, chunks 4 kk +
// t) and its column reads (rows 2 t + e, column 8 i + g: chunk 2 i + g / 4)
// then land on 32 distinct banks. The reads below fold the swizzle into a
// few per-lane offsets, so that every read of their unrolled loops is an
// immediate offset from one (the XOR, add and shift at each read took dq 8%
// and dk/dv 17% longer, and spilled dk/dv: tools/flash_f32_variants.py).
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }

// `rows` rows of H fp32 values from `src` (row i at src + (row0 + i) stride)
// into a swizzled tile; rows at or past `limit` are zeros
template <int H>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0, int limit,
                                          size_t stride, int rows) {
  const uint32_t base = smem_u32(dst);
  for (int i = threadIdx.x; i < rows * (H / 4); i += Plan<H>::THREADS) {
    const int r = i / (H / 4), c = i % (H / 4), row = row0 + r;
    const bool live = row < limit;
    cp_async_16(base + (r * H + ((c ^ swz(r)) << 2)) * 4, live ? src + row * stride + c * 4 : src, live);
  }
}

// d[j] (16 x 8, j < 2) = A B^T over D dims (H, or a warp's half at H 192,
// with a and b offset to it; rows are H floats) at fp32 accuracy: A the 16
// rows a_row0 .. of the resident tile a (a_row0 a multiple of 8), B the 16
// rows of the streamed tile b. Lane (g, t) gets rows g and g + 8, columns 8 j + 2 t and
// 8 j + 2 t + 1. k-steps 2 kk and 2 kk + 1 read dims 16 kk + 4 t + {0, 1} and
// {2, 3}: one float4 a row; they sum into two accumulators (four independent
// mma chains a warp, not two), added at the end. The kk loop is unrolled
// UNROLL times.
template <int H, int UNROLL, int D = H>
__device__ __forceinline__ void scores(float (&d)[2][4], const float* a, const float* b, int a_row0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float e[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] = e[j][i] = 0.f;
  // every row read has swz(g): chunk 4 kk + t of it sits at 16 (kk & ~1) + off[kk & 1]
  const int sw = swz(g), c4 = ((t ^ sw) & 3) * 4, b1 = sw >> 2;
  const int off[2] = {16 * b1 + c4, 16 * (1 ^ b1) + c4};
  const float* ar = a + (a_row0 + g) * H;
  const float* br = b + g * H;
#pragma unroll UNROLL
  for (int kk = 0; kk < D / 16; ++kk) {
    const int o = 16 * (kk & ~1) + off[kk & 1];
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
      mma3(d[j], ah[0], al[0], bh[0], bh[1], bl[0], bl[1]);
      mma3(e[j], ah[1], al[1], bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] += e[j][i];
}

// acc (16 x D) += P X at fp32 accuracy (D = H, or a warp's half at H 192
// with x offset to it): P (16 x 16) in the accumulator layout
// of `scores` (lane (g, t): rows g, g + 8, columns 8 j + 2 t + {0, 1}), X the
// 16 rows of the streamed tile x. k-step j sums over x's rows 8 j .. 8 j + 7,
// lane (g, t) taking rows 8 j + 2 t and 8 j + 2 t + 1: its P columns as they
// are, and x's column 8 i + g on those rows. The step's product sums into a
// fresh fragment, added to acc by an fp32 add (the tensor core's own
// accumulation then never sees the running sum: see the header).
template <int H, int D = H>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4], const float (&p)[2][4], const float* x) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // row 2 t + e, column 8 c + g sits at off[e][c]; column 8 i + g of row
  // 8 j + 2 t + e at 8 j H + 8 (i & ~3) + off[e][i & 3]
  int off[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int c = 0; c < 4; ++c) off[e][c] = (2 * t + e) * H + g + 8 * (c ^ t ^ (2 * e));
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split(p[j][0], ah[j][0], al[j][0]);
    split(p[j][2], ah[j][1], al[j][1]);
    split(p[j][1], ah[j][2], al[j][2]);
    split(p[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split(x[8 * j * H + 8 * (i & ~3) + off[0][i & 3]], bh0, bl0);
      split(x[8 * j * H + 8 * (i & ~3) + off[1][i & 3]], bh1, bl1);
      mma3(d, ah[j], al[j], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += d[e];
  }
}

// H 192: the pair's sum of a score tile whose inner sum each warp of the
// pair took half of. The warp writes its partial tile to its place in `xch`
// (one product slot: a float4 a lane, twice, so a warp's writes and reads hit
// 32 banks), waits for its partner on the pair's named barrier (1 + pair: 0
// is __syncthreads'), and adds the partner's. The slot is written again only
// after the next __syncthreads of the step loop.
__device__ __forceinline__ void pair_sum(float (&d)[2][4], float* xch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float4* mine = reinterpret_cast<float4*>(xch + warp * 256) + lane;
  mine[0] = make_float4(d[0][0], d[0][1], d[0][2], d[0][3]);
  mine[32] = make_float4(d[1][0], d[1][1], d[1][2], d[1][3]);
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp / 2) : "memory");
  const float4* other = reinterpret_cast<const float4*>(xch + (warp ^ 1) * 256) + lane;
  const float4 a = other[0], b = other[32];
  d[0][0] += a.x;
  d[0][1] += a.y;
  d[0][2] += a.z;
  d[0][3] += a.w;
  d[1][0] += b.x;
  d[1][1] += b.y;
  d[1][2] += b.z;
  d[1][3] += b.w;
}

__device__ __forceinline__ bool visible(const Geometry& g, int row, int col) {
  bool ok = row < g.T && col < g.S;
  if (g.causal) ok = ok && col <= row;
  if (g.window >= 0) ok = ok && col > row - g.window;
  return ok;
}

template <int H>
struct Smem {
  static constexpr int RES_F = RES * H;    // floats of a resident tile
  static constexpr int STEP_F = STEP * H;  // floats of a streamed tile
  // a stage: two streamed tiles, then 16 values each of up to three row vectors
  static constexpr int STAGE = 2 * STEP_F + 3 * STEP;
  // after the ring, at H 192: the pairs' exchange, one slot for each of a step's two score products
  static constexpr size_t bytes = (2 * RES_F + STAGES * STAGE + 2 * Plan<H>::XCH) * sizeof(float);
};

// The forward's: one resident tile (Q), and a stage of COLS rows of K, then
// of V, then their segment ids; at H 192 the exchange, a slot a 16-column tile
template <int H, int COLS>
struct FwdSmem {
  static constexpr int STAGE = 2 * COLS * H + COLS;
  static constexpr size_t bytes = (RES * H + STAGES * STAGE + COLS / STEP * Plan<H>::XCH) * sizeof(float);
};

// K and V rows r0 .. r0 + ROWS - 1 of kv head kh (zeros past S) into a stage:
// K's rows, V's at st + ROWS H, their segment ids at st + 2 ROWS H (the
// forward and dq). Row 16 u + r of a tile has row r's swizzle: each 16 rows
// are a tile as `scores` and `accumulate` read it.
template <int H, int ROWS>
__device__ __forceinline__ void kv_load(float* st, const float* k_b, const float* v_b, const int* seg_b,
                                        const Geometry& g, int r0) {
  const size_t stride = static_cast<size_t>(g.K) * H;
  load_rows<H>(st, k_b, r0, g.S, stride, ROWS);
  load_rows<H>(st + ROWS * H, v_b, r0, g.S, stride, ROWS);
  if (seg_b != nullptr && threadIdx.x < ROWS) {
    const int row = r0 + threadIdx.x;
    cp_async_4(smem_u32(st + 2 * ROWS * H + threadIdx.x), row < g.S ? seg_b + row : seg_b, row < g.S);
  }
}

// ------------------------------------------------------------------ forward
// out, lse of 64 query rows of one head: S = Q K^T over COLS kv columns a
// step (COLS / 16 tiles of 16), masked, the online softmax in the
// accumulator layout, O = O alpha + P V (at H 192 each warp of a pair its
// 96 columns of O, after the pair's sum of S)
template <int H, int COLS>
__global__ void __launch_bounds__(Plan<H>::THREADS, Plan<H>::MIN_BLOCKS)
    flash_fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const int* __restrict__ seg, float* __restrict__ out, float* __restrict__ lse, Geometry g) {
  using L = FwdSmem<H, COLS>;
  using P = Plan<H>;
  constexpr int U = COLS / STEP;  // 16-column tiles of a step
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* ring = q_s + RES * H;
  float* xch = ring + STAGES * L::STAGE;  // H 192: the pairs' exchange
  // rows 16 rw .. of the block, columns DW hf .. of the head
  const int warp = threadIdx.x / 32, rw = warp / P::PAIR, hf = warp % P::PAIR;
  const int lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  // the last query tile first: under the causal mask it walks the most kv tiles
  const int q0 = (cdiv(g.T, RES) - 1 - static_cast<int>(blockIdx.x)) * RES;
  const int n = blockIdx.y, b = blockIdx.z, kh = n / (g.N / g.K);

  const size_t q_off = (static_cast<size_t>(b) * g.T * g.N + n) * H, q_stride = static_cast<size_t>(g.N) * H;
  load_rows<H>(q_s, q + q_off, q0, g.T, q_stride, RES);  // committed with the first stage

  // this lane's rows 16 rw + gr + 8 h and their segment ids
  int row[2], sq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * rw + gr + 8 * h;
    sq[h] = seg != nullptr && row[h] < g.T ? seg[static_cast<size_t>(b) * g.T + row[h]] : 0;
  }
  // the kv steps any row of the block sees
  const int q_last = min(q0 + RES, g.T) - 1;
  int s_lo = 0, s_hi = cdiv(g.S, COLS);
  if (g.causal) {
    s_hi = min(s_hi, q_last / COLS + 1);
    if (g.window >= 0) s_lo = max(0, q0 - g.window + 1) / COLS;
  }
  const int n_steps = max(s_hi - s_lo, 0);
  const int w0 = q0 + 16 * rw, w1 = min(w0 + 15, g.T - 1);  // the warp's first and last live row

  const size_t kv_off = (static_cast<size_t>(b) * g.S * g.K + kh) * H;
  const int* seg_b = seg != nullptr ? seg + static_cast<size_t>(b) * g.T : nullptr;
  float acc[P::DW / 8][4];
#pragma unroll
  for (int i = 0; i < P::DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows g, g + 8: the running max (log2 units, the same in the row's four
  // lanes) and this lane's part of the running sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const float sl2 = g.scale * LOG2E;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) kv_load<H, COLS>(ring + s * L::STAGE, k + kv_off, v + kv_off, seg_b, g, (s_lo + s) * COLS);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();  // every reader of step it - 1 is done: its stage takes step it + STAGES - 1
    {
      const int nx = it + STAGES - 1;
      if (nx < n_steps)
        kv_load<H, COLS>(ring + (nx % STAGES) * L::STAGE, k + kv_off, v + kv_off, seg_b, g, (s_lo + nx) * COLS);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();  // this thread's copies of step it (and of Q) have landed
    __syncthreads();              // everyone's have
    const int c0 = (s_lo + it) * COLS;
    // warp-uniform (pair-uniform): none of the warp's rows sees a column of this step
    if (w0 >= g.T || (g.causal && c0 > w1) || (g.window >= 0 && c0 + COLS - 1 <= w0 - g.window)) continue;
    const float* st = ring + (it % STAGES) * L::STAGE;
    const int* sk = reinterpret_cast<const int*>(st + 2 * COLS * H);
    float s[U][2][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // S = Q K^T
      scores<H, P::DW / 16, P::DW>(s[u], q_s + P::DW * hf, st + u * STEP * H + P::DW * hf, 16 * rw);
      if (P::PAIR > 1) pair_sum(s[u], xch + u * P::XCH);
    }
    // scores in log2 units, invisible ones at NEG_INF (bit 8 u + 4 j + e of vis)
    uint32_t vis = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, c = 16 * u + 8 * j + 2 * t + e % 2;
          const bool ok = visible(g, row[h], c0 + c) && (seg == nullptr || sq[h] == sk[c]);
          vis |= static_cast<uint32_t>(ok) << (8 * u + 4 * j + e);
          s[u][j][e] = ok ? s[u][j][e] * sl2 : NEG_INF;
          mx[h] = fmaxf(mx[h], s[u][j][e]);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);  // 1 while the row has seen nothing (NEG_INF - NEG_INF)
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (vis >> (8 * u + 4 * j + e)) & 1u ? exp2f(s[u][j][e] - m[e / 2]) : 0.f;
          s[u][j][e] = p;
          l[e / 2] += p;
        }
#pragma unroll
    for (int i = 0; i < P::DW / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= alpha[e / 2];
#pragma unroll
    for (int u = 0; u < U; ++u) accumulate<H, P::DW>(acc, s[u], st + COLS * H + u * STEP * H + P::DW * hf);  // O += P V
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (row[h] >= g.T) continue;
    const float d = fmaxf(l[h], 1e-37f);
    float* o = out + (static_cast<size_t>(b) * g.T + row[h]) * g.N * H + static_cast<size_t>(n) * H + P::DW * hf;
#pragma unroll
    for (int i = 0; i < P::DW / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i + 2 * t) = make_float2(acc[i][2 * h] / d, acc[i][2 * h + 1] / d);
    // a row that saw a key has l >= 1 (its max's own term); one that saw none keeps NEG_INF
    if (t == 0 && hf == 0)
      lse[(static_cast<size_t>(b) * g.N + n) * g.T + row[h]] = (l[h] > 0.f ? m[h] * LN2 : NEG_INF) + logf(d);
  }
}

// ------------------------------------------------------------------ dq

template <int H>
__global__ void __launch_bounds__(Plan<H>::THREADS, Plan<H>::MIN_BLOCKS)
    flash_bwd_dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, const int* __restrict__ seg, float* __restrict__ dq,
                            Geometry g) {
  using L = Smem<H>;
  using P = Plan<H>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + L::RES_F;
  float* ring = do_s + L::RES_F;
  float* xch = ring + STAGES * L::STAGE;  // H 192: the pairs' exchange
  // rows 16 rw .. of the block, columns DW hf .. of the head
  const int warp = threadIdx.x / 32, rw = warp / P::PAIR, hf = warp % P::PAIR;
  const int lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  // the last query tile first: under the causal mask it walks the most kv tiles
  const int q0 = (cdiv(g.T, RES) - 1 - static_cast<int>(blockIdx.x)) * RES;
  const int n = blockIdx.y, b = blockIdx.z, kh = n / (g.N / g.K);

  const size_t q_off = (static_cast<size_t>(b) * g.T * g.N + n) * H, q_stride = static_cast<size_t>(g.N) * H;
  load_rows<H>(q_s, q + q_off, q0, g.T, q_stride, RES);
  load_rows<H>(do_s, dout + q_off, q0, g.T, q_stride, RES);  // committed with the first stage

  // this lane's rows 16 rw + gr + 8 h: lse (times log2 e), delta, segment id
  int row[2], sq[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + 16 * rw + gr + 8 * h;
    const bool live = row[h] < g.T;
    const size_t i = (static_cast<size_t>(b) * g.N + n) * g.T + row[h];
    lse2[h] = live ? lse[i] * LOG2E : 0.f;
    dl[h] = live ? delta[i] : 0.f;
    sq[h] = seg != nullptr && live ? seg[static_cast<size_t>(b) * g.T + row[h]] : 0;
  }
  // the kv tiles any row of the block sees
  const int q_last = min(q0 + RES, g.T) - 1;
  int s_lo = 0, s_hi = cdiv(g.S, STEP);
  if (g.causal) {
    s_hi = min(s_hi, q_last / STEP + 1);
    if (g.window >= 0) s_lo = max(0, q0 - g.window + 1) / STEP;
  }
  const int n_steps = max(s_hi - s_lo, 0);
  const int w0 = q0 + 16 * rw, w1 = min(w0 + 15, g.T - 1);  // the warp's first and last live row

  const size_t kv_off = (static_cast<size_t>(b) * g.S * g.K + kh) * H;
  const int* seg_b = seg != nullptr ? seg + static_cast<size_t>(b) * g.T : nullptr;
  float acc[P::DW / 8][4];
#pragma unroll
  for (int i = 0; i < P::DW / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const float sl2 = g.scale * LOG2E;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) kv_load<H, STEP>(ring + s * L::STAGE, k + kv_off, v + kv_off, seg_b, g, (s_lo + s) * STEP);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();  // every reader of step it - 1 is done: its stage takes step it + STAGES - 1
    {
      const int nx = it + STAGES - 1;
      if (nx < n_steps)
        kv_load<H, STEP>(ring + (nx % STAGES) * L::STAGE, k + kv_off, v + kv_off, seg_b, g, (s_lo + nx) * STEP);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();  // this thread's copies of step it (and of Q, dO) have landed
    __syncthreads();              // everyone's have
    const int c0 = (s_lo + it) * STEP;
    // warp-uniform (pair-uniform): none of the warp's rows sees a column of this step
    if (w0 >= g.T || (g.causal && c0 > w1) || (g.window >= 0 && c0 + STEP - 1 <= w0 - g.window)) continue;
    const float* st = ring + (it % STAGES) * L::STAGE;
    const int* sk = reinterpret_cast<const int*>(st + 2 * L::STEP_F);
    float s[2][4], dp[2][4];
    scores<H, P::DW / 16, P::DW>(s, q_s + P::DW * hf, st + P::DW * hf, 16 * rw);                // S = Q K^T
    scores<H, P::DW / 16, P::DW>(dp, do_s + P::DW * hf, st + L::STEP_F + P::DW * hf, 16 * rw);  // dP = dO V^T
    if (P::PAIR > 1) {
      pair_sum(s, xch);
      pair_sum(dp, xch + P::XCH);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, c = 8 * j + 2 * t + e % 2;
        const bool vis = visible(g, row[h], c0 + c) && (seg == nullptr || sq[h] == sk[c]);
        const float p = vis ? exp2f(fmaf(s[j][e], sl2, -lse2[h])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[h]) * g.scale;  // dS
      }
    accumulate<H, P::DW>(acc, s, st + P::DW * hf);  // dq += dS K
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= g.T) continue;
    float* o = dq + (static_cast<size_t>(b) * g.T + row[h]) * g.N * H + static_cast<size_t>(n) * H + P::DW * hf;
#pragma unroll
    for (int i = 0; i < P::DW / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i + 2 * t) = make_float2(acc[i][2 * h], acc[i][2 * h + 1]);
  }
}

// ------------------------------------------------------------------ dk, dv
// The workspace slot of part 0 of kv tile `tile`: the parts of the tiles
// before it that were split (every lane of the calling warp gets the sum)
__device__ __forceinline__ int slot_of(const Geometry& g, int tile, int chunk) {
  int sum = 0;
  for (int u = threadIdx.x % 32; u < tile; u += 32) {
    const int p = dkv_walk(g, u, chunk).parts;
    sum += p > 1 ? p : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// workspace floats of one (slot, batch, kv head): dk's 64 rows, then dv's
template <int H>
__device__ __forceinline__ size_t ws_at(const Geometry& g, int slot, int b, int kh) {
  return ((static_cast<size_t>(slot) * g.B + b) * g.K + kh) * 2 * RES * H;
}

// Step s of a dk/dv walk: Q and dO rows of query head kh * group + s /
// per_head, query tile lo + s % per_head, with their lse, delta and segment
// ids (zeros past T)
template <int H>
__device__ __forceinline__ void dkv_load(float* st, const float* __restrict__ q, const float* __restrict__ dout,
                                         const float* __restrict__ lse, const float* __restrict__ delta,
                                         const int* __restrict__ seg, const Geometry& g, const DkvWalk& w, int b,
                                         int kh, int s) {
  using L = Smem<H>;
  const int n = kh * (g.N / g.K) + s / w.per_head, r0 = (w.lo + s % w.per_head) * STEP;
  const size_t q_off = (static_cast<size_t>(b) * g.T * g.N + n) * H, stride = static_cast<size_t>(g.N) * H;
  load_rows<H>(st, q + q_off, r0, g.T, stride, STEP);
  load_rows<H>(st + L::STEP_F, dout + q_off, r0, g.T, stride, STEP);
  if (threadIdx.x < 3 * STEP) {  // lse, delta, segment ids of the 16 rows (zeros past T, or without ids)
    const int which = threadIdx.x / STEP, row = r0 + threadIdx.x % STEP;
    const bool live = row < g.T && (which < 2 || seg != nullptr);
    const void* src = lse;
    if (live) {
      const size_t i = (static_cast<size_t>(b) * g.N + n) * g.T + row;
      src = which == 0 ? static_cast<const void*>(lse + i)
            : which == 1 ? static_cast<const void*>(delta + i)
                         : static_cast<const void*>(seg + static_cast<size_t>(b) * g.T + row);
    }
    cp_async_4(smem_u32(st + 2 * L::STEP_F + threadIdx.x), src, live);
  }
}

template <int H>
__global__ void __launch_bounds__(Plan<H>::THREADS, Plan<H>::MIN_BLOCKS)
    flash_bwd_dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, const int* __restrict__ seg, float* __restrict__ dk,
                             float* __restrict__ dv, float* __restrict__ ws, Geometry g, int chunk) {
  using L = Smem<H>;
  using P = Plan<H>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + L::RES_F;
  float* ring = v_s + L::RES_F;
  float* xch = ring + STAGES * L::STAGE;  // H 192: the pairs' exchange
  // kv rows 16 rw .. of the tile, columns DW hf .. of the head
  const int warp = threadIdx.x / 32, rw = warp / P::PAIR, hf = warp % P::PAIR;
  const int lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  // kv tiles slowest: under the causal mask tile 0's parts, the fullest, start first
  const int tile = blockIdx.z, part = blockIdx.x, kh = blockIdx.y % g.K, b = blockIdx.y / g.K;
  const DkvWalk w = dkv_walk(g, tile, chunk);
  if (part >= w.parts) return;
  const int s_begin = part * chunk, n_steps = min(w.total - s_begin, chunk);
  const int kv0 = tile * RES;

  const size_t kv_off = (static_cast<size_t>(b) * g.S * g.K + kh) * H, kv_stride = static_cast<size_t>(g.K) * H;
  load_rows<H>(k_s, k + kv_off, kv0, g.S, kv_stride, RES);
  load_rows<H>(v_s, v + kv_off, kv0, g.S, kv_stride, RES);  // committed with the first stage

  // this lane's kv rows 16 rw + gr + 8 h and their segment ids
  int col[2], sk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    col[h] = kv0 + 16 * rw + gr + 8 * h;
    sk[h] = seg != nullptr && col[h] < g.S ? seg[static_cast<size_t>(b) * g.T + col[h]] : 0;
  }
  const int c_lo = kv0 + 16 * rw, c_hi = c_lo + 15;  // the warp's kv rows
  float dk_acc[P::DW / 8][4], dv_acc[P::DW / 8][4];
#pragma unroll
  for (int i = 0; i < P::DW / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;
  const float sl2 = g.scale * LOG2E;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) dkv_load<H>(ring + s * L::STAGE, q, dout, lse, delta, seg, g, w, b, kh, s_begin + s);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();  // every reader of step it - 1 is done: its stage takes step it + STAGES - 1
    {
      const int nx = it + STAGES - 1;
      if (nx < n_steps)
        dkv_load<H>(ring + (nx % STAGES) * L::STAGE, q, dout, lse, delta, seg, g, w, b, kh, s_begin + nx);
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int q0 = (w.lo + (s_begin + it) % w.per_head) * STEP;
    // warp-uniform (pair-uniform): none of the warp's kv rows is seen by a query row of this step
    if (c_lo >= g.S || (g.causal && q0 + STEP - 1 < c_lo) || (g.window >= 0 && q0 > c_hi + g.window - 1)) continue;
    const float* st = ring + (it % STAGES) * L::STAGE;
    const float* lse_s = st + 2 * L::STEP_F;
    const float* dl_s = lse_s + STEP;
    const int* sq_s = reinterpret_cast<const int*>(dl_s + STEP);
    // P^T, then dv += P^T dO before dP^T is computed: the two score tiles are
    // not live at once beside the dk and dv sums (128 registers at H 128)
    // (the dims loop unrolled twice: fully, beside the dk and dv sums' 128
    // registers at H 128, it spilled and ran ~3% slower)
    float p[2][4];
    scores<H, 2, P::DW>(p, k_s + P::DW * hf, st + P::DW * hf, 16 * rw);  // S^T = K Q^T
    if (P::PAIR > 1) pair_sum(p, xch);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, r = 8 * j + 2 * t + e % 2;
        const bool vis = visible(g, q0 + r, col[h]) && (seg == nullptr || sq_s[r] == sk[h]);
        p[j][e] = vis ? exp2f(fmaf(p[j][e], sl2, -lse_s[r] * LOG2E)) : 0.f;
      }
    accumulate<H, P::DW>(dv_acc, p, st + L::STEP_F + P::DW * hf);  // dv += P^T dO
    float ds[2][4];
    scores<H, 2, P::DW>(ds, v_s + P::DW * hf, st + L::STEP_F + P::DW * hf, 16 * rw);  // dP^T = V dO^T
    if (P::PAIR > 1) pair_sum(ds, xch + P::XCH);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl_s[8 * j + 2 * t + e % 2]) * g.scale;  // dS^T
    accumulate<H, P::DW>(dk_acc, ds, st + P::DW * hf);  // dk += dS^T Q
  }
  cp_async_wait<0>();

  if (w.parts == 1) {  // the whole walk: dk and dv themselves
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (col[h] >= g.S) continue;
      const size_t off = (static_cast<size_t>(b) * g.S + col[h]) * g.K * H + static_cast<size_t>(kh) * H + P::DW * hf;
#pragma unroll
      for (int i = 0; i < P::DW / 8; ++i) {
        *reinterpret_cast<float2*>(dk + off + 8 * i + 2 * t) = make_float2(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * i + 2 * t) = make_float2(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
      }
    }
    return;
  }
  float* part_k = ws + ws_at<H>(g, slot_of(g, tile, chunk) + part, b, kh) + P::DW * hf;
  float* part_v = part_k + RES * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * rw + gr + 8 * h;
#pragma unroll
    for (int i = 0; i < P::DW / 8; ++i) {
      *reinterpret_cast<float2*>(part_k + r * H + 8 * i + 2 * t) = make_float2(dk_acc[i][2 * h], dk_acc[i][2 * h + 1]);
      *reinterpret_cast<float2*>(part_v + r * H + 8 * i + 2 * t) = make_float2(dv_acc[i][2 * h], dv_acc[i][2 * h + 1]);
    }
  }
}

// dk and dv of a kv tile whose walk was split: its parts' sums, in part order
template <int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_merge_f32(const float* __restrict__ ws, float* __restrict__ dk, float* __restrict__ dv, Geometry g,
                            int chunk) {
  const int tile = blockIdx.x, kh = blockIdx.y % g.K, b = blockIdx.y / g.K;
  const int parts = dkv_walk(g, tile, chunk).parts;
  if (parts == 1) return;  // the dk/dv kernel wrote this tile
  const int slot = slot_of(g, tile, chunk);
  for (int i = threadIdx.x; i < 2 * RES * H / 4; i += THREADS) {
    const int which = i / (RES * H / 4), e = i % (RES * H / 4), r = e / (H / 4), c = e % (H / 4);
    const int row = tile * RES + r;
    if (row >= g.S) continue;
    const size_t at_part = static_cast<size_t>(which) * RES * H + r * H + c * 4;
    float4 sum = *reinterpret_cast<const float4*>(ws + ws_at<H>(g, slot, b, kh) + at_part);
    for (int p = 1; p < parts; ++p) {
      const float4 x = *reinterpret_cast<const float4*>(ws + ws_at<H>(g, slot + p, b, kh) + at_part);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    float* dst = (which == 0 ? dk : dv) + (static_cast<size_t>(b) * g.S + row) * g.K * H +
                 static_cast<size_t>(kh) * H + c * 4;
    *reinterpret_cast<float4*>(dst) = sum;
  }
}

// ------------------------------------------------------------------ launch
template <int H>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
                       const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  using L = FwdSmem<H, FWD_COLS>;
  auto kernel = flash_fwd_kernel_f32<H, FWD_COLS>;
  cudaError_t err = opt_in(kernel, L::bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(cdiv(g.T, RES), g.N, g.B), Plan<H>::THREADS, L::bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(seg), static_cast<float*>(out), static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* seg, void* dq, const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dq_kernel_f32<H>;
  cudaError_t err = opt_in(kernel, Smem<H>::bytes, done);
  if (err != cudaSuccess) return err;
  dim3 grid(cdiv(g.T, RES), g.N, g.B);
  kernel<<<grid, Plan<H>::THREADS, Smem<H>::bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<float*>(dq), g);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* seg, void* dk, void* dv, void* ws, const Geometry& g, int chunk,
                       int max_parts, bool merge, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dkv_kernel_f32<H>;
  cudaError_t err = opt_in(kernel, Smem<H>::bytes, done);
  if (err != cudaSuccess) return err;
  const int n_tiles = cdiv(g.S, RES);
  kernel<<<dim3(max_parts, g.K * g.B, n_tiles), Plan<H>::THREADS, Smem<H>::bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(ws), g,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return err;
  flash_bwd_dkv_merge_f32<H><<<dim3(n_tiles, g.K * g.B), THREADS, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(dk), static_cast<float*>(dv), g, chunk);
  return cudaGetLastError();
}

// The checks of the three entries and the geometry they launch; `o` is dO
// for the backward, out for the forward. A window past T + S is clamped to it
// (it hides nothing then)
cudaError_t check_args(const void* q, const void* k, const void* v, const void* o, int B, int T, int S, int N,
                       int K, int H, int causal, int window, int dtype, float scale, Geometry* g) {
  if (B < 0 || T < 0 || S < 0 || K < 1 || N % K != 0 || (H != 64 && H != 128 && H != 192) || dtype != 0 || B > 65535 ||
      N > 65535 || (window >= 0 && !causal))
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) return cudaErrorInvalidValue;
  *g = Geometry{B, T, S, N, K, causal ? 1 : 0, window < 0 ? -1 : imin(window, T + S), scale};
  return cudaSuccess;
}

}  // namespace

// out [B, T, N, H] fp32 (16-byte aligned, as q, k and v), lse [B, N, T]
// fp32; H 64, 128 or 192. dtype must be 0 (fp32); window < 0: none (causal
// only); seg may be null. Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype, head_dim or geometry, or
// a misaligned pointer).
extern "C" int pdnlp_flash_fwd_sm90_f32(const void* q, const void* k, const void* v, const void* seg, void* out,
                                        void* lse, int B, int T, int S, int N, int K, int H, int causal, int window,
                                        int dtype, float scale, void* stream) {
  Geometry g;
  const cudaError_t bad = check_args(q, k, v, out, B, T, S, N, K, H, causal, window, dtype, scale, &g);
  if (bad != cudaSuccess) return bad;
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64    ? launch_fwd<64>(q, k, v, seg, out, lse, g, s)
         : H == 128 ? launch_fwd<128>(q, k, v, seg, out, lse, g, s)
                    : launch_fwd<192>(q, k, v, seg, out, lse, g, s);
}

// dq [B, T, N, H] fp32 (16-byte aligned, as q, k, v and dO). dtype must be 0
// (fp32); the rest as the forward's entry.
extern "C" int pdnlp_flash_bwd_dq_sm90_f32(const void* q, const void* k, const void* v, const void* dout,
                                           const void* lse, const void* delta, const void* seg, void* dq, int B,
                                           int T, int S, int N, int K, int H, int causal, int window, int dtype,
                                           float scale, void* stream) {
  Geometry g;
  const cudaError_t bad = check_args(q, k, v, dout, B, T, S, N, K, H, causal, window, dtype, scale, &g);
  if (bad != cudaSuccess) return bad;
  if (!aligned16(dq)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64    ? launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, g, s)
         : H == 128 ? launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, g, s)
                    : launch_dq<192>(q, k, v, dout, lse, delta, seg, dq, g, s);
}

// dk, dv [B, S, K, H] fp32, each kv tile's walk cut into parts of `chunk`
// steps; ws holds `slots` x [B, K, 2, 64, H] fp32 partial sums, one slot a
// part of each tile cut in more than one (ops/flash_attention.py
// `dkv_split` gives chunk and slots; the entry recomputes slots and refuses a
// mismatch). The rest as the dq entry.
extern "C" int pdnlp_flash_bwd_dkv_sm90_f32(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                                            void* ws, int B, int T, int S, int N, int K, int H, int causal, int window,
                                            int dtype, int chunk, int slots, float scale, void* stream) {
  Geometry g;
  const cudaError_t bad = check_args(q, k, v, dout, B, T, S, N, K, H, causal, window, dtype, scale, &g);
  if (bad != cudaSuccess) return bad;
  if (!aligned16(dk) || !aligned16(dv) || chunk < 1 || static_cast<long long>(K) * B > 65535)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || K == 0) return cudaSuccess;
  int max_parts = 1, need = 0;
  for (int tile = 0; tile < cdiv(S, RES); ++tile) {
    const int p = dkv_walk(g, tile, chunk).parts;
    max_parts = imax(max_parts, p);
    need += p > 1 ? p : 0;
  }
  if (need != slots || (need > 0 && (ws == nullptr || !aligned16(ws)))) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool merge = need > 0;
  return H == 64    ? launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, ws, g, chunk, max_parts, merge, s)
         : H == 128 ? launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, ws, g, chunk, max_parts, merge, s)
                    : launch_dkv<192>(q, k, v, dout, lse, delta, seg, dk, dv, ws, g, chunk, max_parts, merge, s);
}
