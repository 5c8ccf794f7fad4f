// Ragged paged attention for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Route: fp32 queries or fp32 pools, including fp32 queries over int8 / fp8
// pools; bf16 queries over a bf16, int8 or fp8 pool, the serving path's
// types, go to the tensor-core kernel of paged_attention_sm90.cu. fp32 stays
// here on purpose: its fp32 products are what the fp32 logits gate (rel 1e-4)
// holds to.
//
// Replaces the Pallas TPU kernel paddlenlp_tpu/ops/pallas/paged_attention.py
// `_kernel` (:56), launched by `ragged_paged_attention` (:105). One launch
// computes attention for a ragged batch read from the paged KV pool through
// block tables: query token t of sequence b sits at absolute position
// q_start[b] + t and sees kv positions <= q_start[b] + t; rows with
// t >= q_lens[b] (and every row of a q_lens == 0 sequence) come out as exact
// zeros. GQA folds query head n = kh * group + g of token t into row
// t * group + g of kv head kh. The softmax is online in fp32 with the TPU
// kernel's NEG_INF = -1e30 masking and max(l, 1e-37) finalisation; int8 and
// fp8-e4m3 pools are dequantized in fp32 with per-token-per-head scales.
//
// What bounds it on an H100: the bytes of KV it reads. A decode row does
// 4 * H flops per KV element pair it loads (far below the ~295 flop/byte
// ridge of bf16), and a prefill chunk re-reads the same KV blocks for every
// tile of 64 folded query rows. Design: one thread block per (tile of <= 64
// folded query rows, kv head, sequence). It reads its own block-table row,
// q_start and q_lens, and walks KV blocks j = 0 .. (highest live position of
// its tile) / bs, so blocks no live row can see are never read (the TPU
// kernel's @pl.when skip, per tile). Each step stages one [bs, H] K and V
// tile in shared memory as fp32 (dequantized where the pool is quantized);
// each warp owns 8 query rows, interleaved so that a decode tile's few rows
// (one per query head of the group) run on different warps, and keeps their
// (m, l, acc) in registers, with lane c scoring KV column c against a
// broadcast query row. Simple: the KV tile is loaded once per block and
// shared by its 64 rows, with no tensor cores, asynchronous copies or split
// kv walk; the serving path's bf16 queries have those in
// paged_attention_sm90.cu.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 64;  // folded query rows per thread block
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = ROWS / WARPS;
constexpr int MAX_BS = 64;  // a lane scores columns lane and lane + 32
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }
template <>
__device__ __forceinline__ float to_f32<int8_t>(int8_t x) { return static_cast<float>(x); }
template <>
__device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

constexpr size_t smem_bytes(int H, int bs) {
  return (static_cast<size_t>(ROWS) * H + static_cast<size_t>(bs) * (H + 1) + static_cast<size_t>(bs) * H) *
         sizeof(float);
}

template <typename QT, typename KVT, int H, bool SCALED>
__global__ void __launch_bounds__(WARPS * 32)
    ragged_paged_attention_kernel(const QT* __restrict__ q, const KVT* __restrict__ pool_k,
                                  const KVT* __restrict__ pool_v, const int* __restrict__ tables,
                                  const int* __restrict__ q_start, const int* __restrict__ q_lens,
                                  const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                                  QT* __restrict__ out, int T, int N, int K, int bs, int mb, float scale) {
  constexpr int HPL = H / 32;  // head dims per lane in the output accumulator
  extern __shared__ float smem[];
  float* q_s = smem;                // [ROWS][H]
  float* k_s = q_s + ROWS * H;      // [bs][H + 1]: padded so lanes reading column c hit distinct banks
  float* v_s = k_s + bs * (H + 1);  // [bs][H]

  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = N / K;
  const int row0 = blockIdx.x * ROWS;
  const int n_rows = min(ROWS, T * group - row0);
  const int start = q_start[b];
  const int qlen = q_lens[b];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < n_rows * H; i += blockDim.x) {
    const int r = i / H, d = i % H;
    const int t = (row0 + r) / group, g = (row0 + r) % group;
    q_s[i] = to_f32(q[((static_cast<size_t>(b) * T + t) * N + kh * group + g) * H + d]);
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][HPL];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < HPL; ++i) acc[rr][i] = 0.f;
  }

  const int t_first = row0 / group;
  if (qlen > 0 && t_first < qlen) {
    // highest live query position of this tile: later KV blocks are masked for every row
    const int hi = start + min((row0 + n_rows - 1) / group, qlen - 1);
    const int n_blocks = min(hi / bs + 1, mb);
    for (int j = 0; j < n_blocks; ++j) {
      const size_t base = (static_cast<size_t>(tables[static_cast<size_t>(b) * mb + j]) * K + kh) * bs;
      __syncthreads();  // the previous tile's readers are done (and q_s is loaded)
      for (int i = threadIdx.x; i < bs * H; i += blockDim.x) {
        const int c = i / H, d = i % H;
        float kv = to_f32(pool_k[base * H + i]);
        float vv = to_f32(pool_v[base * H + i]);
        if (SCALED) {
          kv *= k_scale[base + c];
          vv *= v_scale[base + c];
        }
        k_s[c * (H + 1) + d] = kv;
        v_s[i] = vv;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = rr * WARPS + warp;  // interleaved: a decode tile's few rows land on different warps
        if (r < n_rows) {  // warp-uniform
          const int t = (row0 + r) / group;
          const float* qr = q_s + r * H;
          const float* k0 = k_s + lane * (H + 1);
          const float* k1 = k_s + (lane + 32) * (H + 1);
          float dot0 = 0.f, dot1 = 0.f;
          // four partial sums per column break the dependent-FMA chain
          if (lane + 32 < bs) {
            float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
            for (int d = 0; d < H; d += 4) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float qd = qr[d + u];
                a[u] += qd * k0[d + u];
                c[u] += qd * k1[d + u];
              }
            }
            dot0 = (a[0] + a[1]) + (a[2] + a[3]);
            dot1 = (c[0] + c[1]) + (c[2] + c[3]);
          } else if (lane < bs) {
            float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
            for (int d = 0; d < H; d += 4) {
#pragma unroll
              for (int u = 0; u < 4; ++u) a[u] += qr[d + u] * k0[d + u];
            }
            dot0 = (a[0] + a[1]) + (a[2] + a[3]);
          }
          const int pos0 = j * bs + lane;
          const bool valid0 = lane < bs && pos0 <= start + t && t < qlen;
          const bool valid1 = lane + 32 < bs && pos0 + 32 <= start + t && t < qlen;
          const float s0 = valid0 ? dot0 * scale : NEG_INF;
          const float s1 = valid1 ? dot1 * scale : NEG_INF;
          const float m_new = fmaxf(m[rr], warp_max(fmaxf(s0, s1)));
          const float p0 = valid0 ? expf(s0 - m_new) : 0.f;
          const float p1 = valid1 ? expf(s1 - m_new) : 0.f;
          const float alpha = expf(m[rr] - m_new);
          l[rr] = alpha * l[rr] + warp_sum(p0 + p1);
#pragma unroll
          for (int i = 0; i < HPL; ++i) acc[rr][i] *= alpha;
          for (int c = 0; c < bs; ++c) {
            const float pc = __shfl_sync(FULL, c < 32 ? p0 : p1, c & 31);
            const float* vr = v_s + c * H + lane;
#pragma unroll
            for (int i = 0; i < HPL; ++i) acc[rr][i] += pc * vr[32 * i];
          }
          m[rr] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = rr * WARPS + warp;
    if (r < n_rows) {
      const int t = (row0 + r) / group, g = (row0 + r) % group;
      QT* o = out + ((static_cast<size_t>(b) * T + t) * N + kh * group + g) * H + lane;
      // dead rows kept l == 0 and acc == 0: exact zeros
      const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
      for (int i = 0; i < HPL; ++i) o[32 * i] = from_f32<QT>(acc[rr][i] / denom);
    }
  }
}

template <typename QT, typename KVT, int H, bool SCALED>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v, const void* tables, const void* q_start,
                   const void* q_lens, const void* k_scale, const void* v_scale, void* out, int B, int T, int N,
                   int K, int bs, int mb, float scale, cudaStream_t stream) {
  auto kernel = ragged_paged_attention_kernel<QT, KVT, H, SCALED>;
  // above 48 KB only as opted-in dynamic shared memory: set once per
  // instantiation and device, not on every launch
  static std::atomic<bool> opted_in[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(H, MAX_BS));
    if (err != cudaSuccess) return err;
    opted_in[dev].store(true, std::memory_order_release);
  }
  const int rows = T * (N / K);
  dim3 grid((rows + ROWS - 1) / ROWS, K, B);
  kernel<<<grid, WARPS * 32, smem_bytes(H, bs), stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(pool_k), static_cast<const KVT*>(pool_v),
      static_cast<const int*>(tables), static_cast<const int*>(q_start), static_cast<const int*>(q_lens),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), static_cast<QT*>(out), T, N, K, bs,
      mb, scale);
  return cudaGetLastError();
}

template <typename QT, int H>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* pool_k, const void* pool_v, const void* tables,
                        const void* q_start, const void* q_lens, const void* k_scale, const void* v_scale,
                        void* out, int B, int T, int N, int K, int bs, int mb, float scale, cudaStream_t s) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {  // bf16 over bf16, int8, fp8: the sm90 source
    if (kv_dtype != 0) return cudaErrorInvalidValue;
    return launch<QT, float, H, false>(q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T, N,
                                       K, bs, mb, scale, s);
  } else {
    switch (kv_dtype) {
      case 0:
        return launch<QT, float, H, false>(q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T,
                                           N, K, bs, mb, scale, s);
      case 1:
        return launch<QT, __nv_bfloat16, H, false>(q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale,
                                                   out, B, T, N, K, bs, mb, scale, s);
      case 2:
        return launch<QT, int8_t, H, true>(q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T,
                                           N, K, bs, mb, scale, s);
      case 3:
        return launch<QT, __nv_fp8_e4m3, H, true>(q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale,
                                                  out, B, T, N, K, bs, mb, scale, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename QT>
cudaError_t dispatch_h(int H, int kv_dtype, const void* q, const void* pool_k, const void* pool_v,
                       const void* tables, const void* q_start, const void* q_lens, const void* k_scale,
                       const void* v_scale, void* out, int B, int T, int N, int K, int bs, int mb, float scale,
                       cudaStream_t s) {
  if (H == 64)
    return dispatch_kv<QT, 64>(kv_dtype, q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T,
                               N, K, bs, mb, scale, s);
  if (H == 128)
    return dispatch_kv<QT, 128>(kv_dtype, q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T,
                                N, K, bs, mb, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, T, N, H] (q_dtype 0 = fp32, 1 = bf16); pool_k/pool_v [nb, K, bs, H]
// (kv_dtype 0 = fp32, 1 = bf16, 2 = int8, 3 = fp8-e4m3; 2 and 3 read the fp32
// scales k_scale/v_scale [nb, K, bs, 1]); tables [B, mb], q_start/q_lens [B]
// int32; out [B, T, N, H] in q's dtype. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype or H,
// bf16 q over a bf16, int8 or fp8 pool included: those pairs run
// paged_attention_sm90.cu).
extern "C" int pdnlp_ragged_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                                            const void* tables, const void* q_start, const void* q_lens,
                                            const void* k_scale, const void* v_scale, void* out, int B, int T,
                                            int N, int K, int H, int bs, int mb, int q_dtype, int kv_dtype,
                                            float scale, void* stream) {
  if (B <= 0 || T <= 0) return cudaSuccess;
  if (bs < 1 || bs > MAX_BS || K < 1 || N % K != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return dispatch_h<float>(H, kv_dtype, q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale, out, B, T,
                             N, K, bs, mb, scale, s);
  if (q_dtype == 1)
    return dispatch_h<__nv_bfloat16>(H, kv_dtype, q, pool_k, pool_v, tables, q_start, q_lens, k_scale, v_scale,
                                     out, B, T, N, K, bs, mb, scale, s);
  return cudaErrorInvalidValue;
}
