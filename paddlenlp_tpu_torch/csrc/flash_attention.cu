// Flash attention forward for fp32 operands on CUDA cores (sm_90a), CUDA C++
// with a plain C entry.
//
// Routes (ops/flash_attention.py `kernel_route`): bf16 operands, the training
// path's, take all three kernels of flash_attention_sm90.cu (wgmma); fp32
// operands take this forward and the 3xTF32 tensor-core dq and dk/dv of
// flash_attention_sm90_f32.cu. fp32 operands are a model computing in fp32
// and the fp32 checks (1e-4 elementwise, loss rel 1e-5, gradient leaves 1e-4),
// which bf16 operands cannot meet.
//
// Replaces, for fp32 operands, the Pallas TPU kernel `_fa_kernel` of
// paddlenlp_tpu/ops/pallas/flash_attention.py (:81, launched by `_flash_fwd`
// :131). Same function: causal or full attention with an optional sliding
// window (causal only) and packed-batch segment ids; GQA reads kv head
// n / (N / K) with no repeat; the softmax is online in fp32 with NEG_INF =
// -1e30 masking, invisible entries forced to p = 0 (exp(NEG_INF - NEG_INF) =
// 1 on a fully masked row), the finalizer divides by max(l, 1e-37) and stores
// lse = m + log(max(l, 1e-37)), which the backward reads.
//
// Layouts: q, out [B, T, N, H]; k, v [B, S, K, H]; lse [B, N, T] fp32; seg
// [B, T] int32 (or null).
//
// What bounds it on an H100: operations (0.385 ms at the 67 TFLOP/s fp32 rate
// for q [2, 2048, 12, 128] over k/v [2, 2048, 2, 128], causal). Design,
// simple and right first: 64 x 64 tiles staged in shared memory as fp32 (rows
// padded to H + 1 so that lanes reading a column hit distinct banks); 256
// threads as 16 x 16, each owning a 4 x 4 block of every 64 x 64 score tile
// and a 4 x (H / 16) block of the 64 x H accumulator, rows strided by 16.
// Products are fp32 FMAs on CUDA cores with two shared loads per 4 FMAs; the
// kv loop of a query tile stops at the last tile it can see and starts at the
// window's first (the TPU kernel's `_block_runs` skip, :71). Every global load
// past T or S is bound-checked and zero-filled.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;  // query rows and kv columns of one tile
constexpr int THREADS = 256;
constexpr int SP = TILE + 1;  // padded row of a score tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Geometry {
  int T, S, N, K, causal, window;  // window < 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const Geometry& g, int row, int col, const int* sq, const int* sk, int r,
                                        int c) {
  bool ok = row < g.T && col < g.S;
  if (g.causal) ok = ok && col <= row;
  if (g.window >= 0) ok = ok && col > row - g.window;
  if (sq != nullptr) ok = ok && sq[r] == sk[c];
  return ok;
}

// TILE rows of H values, row stride `stride` elements, from row `row0`; rows
// at or past `limit` are zero-filled. dst is [TILE][H + 1] fp32.
template <typename IT, int H>
__device__ __forceinline__ void load_tile(float* dst, const IT* __restrict__ src, int row0, int limit, int stride) {
  for (int i = threadIdx.x; i < TILE * H; i += THREADS) {
    const int r = i / H, d = i % H;
    const int row = row0 + r;
    dst[r * (H + 1) + d] = row < limit ? to_f32(src[static_cast<size_t>(row) * stride + d]) : 0.f;
  }
}

// s[i][j] += sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over the padded tiles
template <int H>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < H; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * (H + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * (H + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_c p[row(i)][c] * x[c][tx + 16 j], row(i) = ty + 16 i
template <int H>
__device__ __forceinline__ void tile_acc(float (&acc)[4][H / 16], const float* p, const float* x, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < TILE; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * SP + c];
#pragma unroll
    for (int j = 0; j < H / 16; ++j) {
      const float xv = x[c * (H + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * xv;
    }
  }
}

template <int H>
constexpr size_t fwd_smem() {
  // q, k, v tiles; the p tile; m, l, alpha; two segment rows
  return (3 * TILE * (H + 1) + TILE * SP + 3 * TILE) * sizeof(float) + 2 * TILE * sizeof(int);
}

// ------------------------------------------------------------------ forward
template <typename IT, int H>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const IT* __restrict__ q, const IT* __restrict__ k, const IT* __restrict__ v,
                     const int* __restrict__ seg, IT* __restrict__ out, float* __restrict__ lse, Geometry g) {
  constexpr int HP = H + 1, HJ = H / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + TILE * HP;
  float* v_s = k_s + TILE * HP;
  float* p_s = v_s + TILE * HP;
  float* m_s = p_s + TILE * SP;
  float* l_s = m_s + TILE;
  float* a_s = l_s + TILE;
  int* sq_s = reinterpret_cast<int*>(a_s + TILE);
  int* sk_s = sq_s + TILE;

  const int q0 = blockIdx.x * TILE, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (g.N / g.K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int* sq = seg != nullptr ? sq_s : nullptr;

  load_tile<IT, H>(q_s, q + (static_cast<size_t>(b) * g.T * g.N + n) * H, q0, g.T, g.N * H);
  if (tid < TILE) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
    sq_s[tid] = (seg != nullptr && q0 + tid < g.T) ? seg[static_cast<size_t>(b) * g.T + q0 + tid] : 0;
  }
  float acc[4][HJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HJ; ++j) acc[i][j] = 0.f;

  int j_lo = 0, j_hi = (g.S + TILE - 1) / TILE;
  if (g.causal) {
    j_hi = min(j_hi, (min(q0 + TILE, g.T) - 1) / TILE + 1);
    if (g.window >= 0) j_lo = max(0, q0 - g.window + 1) / TILE;
  }
  const IT* k_b = k + (static_cast<size_t>(b) * g.S * g.K + kh) * H;
  const IT* v_b = v + (static_cast<size_t>(b) * g.S * g.K + kh) * H;
  for (int jt = j_lo; jt < j_hi; ++jt) {
    const int k0 = jt * TILE;
    __syncthreads();  // the previous tile's readers are done
    load_tile<IT, H>(k_s, k_b, k0, g.S, g.K * H);
    load_tile<IT, H>(v_s, v_b, k0, g.S, g.K * H);
    if (tid < TILE) sk_s[tid] = (seg != nullptr && k0 + tid < g.S) ? seg[static_cast<size_t>(b) * g.T + k0 + tid] : 0;
    __syncthreads();

    float s[4][4] = {};
    tile_dot<H>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        p_s[r * SP + c] = visible(g, q0 + r, k0 + c, sq, sk_s, r, c) ? s[i][j] * g.scale : NEG_INF;
      }
    __syncthreads();

    {  // online softmax: four lanes per row, sixteen columns each
      const int r = tid >> 2, c0 = (tid & 3) * 16;
      float* pr = p_s + r * SP + c0;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = visible(g, q0 + r, k0 + c0 + c, sq, sk_s, r, c0 + c) ? expf(pr[c] - m_new) : 0.f;
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if ((tid & 3) == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < HJ; ++j) acc[i][j] *= alpha;
    }
    tile_acc<H>(acc, p_s, v_s, ty, tx);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row < g.T) {
      const float l = fmaxf(l_s[r], 1e-37f);
      IT* o = out + (static_cast<size_t>(b) * g.T + row) * g.N * H + static_cast<size_t>(n) * H;
#pragma unroll
      for (int j = 0; j < HJ; ++j) o[tx + 16 * j] = from_f32<IT>(acc[i][j] / l);
    }
  }
  if (tid < TILE && q0 + tid < g.T)
    lse[(static_cast<size_t>(b) * g.N + n) * g.T + q0 + tid] = m_s[tid] + logf(fmaxf(l_s[tid], 1e-37f));
}

// ------------------------------------------------------------------ launch
template <typename IT, int H>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse, int B,
                       const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_fwd_kernel<IT, H>;
  cudaError_t err = opt_in(kernel, fwd_smem<H>(), done);
  if (err != cudaSuccess) return err;
  dim3 grid((g.T + TILE - 1) / TILE, g.N, B);
  kernel<<<grid, THREADS, fwd_smem<H>(), s>>>(static_cast<const IT*>(q), static_cast<const IT*>(k),
                                              static_cast<const IT*>(v), static_cast<const int*>(seg),
                                              static_cast<IT*>(out), static_cast<float*>(lse), g);
  return cudaGetLastError();
}

bool bad_geometry(int B, int T, int S, int N, int K, int H, int dtype) {
  return B < 0 || T < 0 || S < 0 || K < 1 || N % K != 0 || (H != 64 && H != 128) || (dtype != 0 && dtype != 1) ||
         B > 65535 || N > 65535;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for an unsupported dtype, head_dim or geometry). dtype must be 0 (fp32: q,
// k, v and out); window < 0: none; seg may be null.
extern "C" int pdnlp_flash_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
                               int B, int T, int S, int N, int K, int H, int causal, int window, int dtype,
                               float scale, void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype) || dtype != 0) return cudaErrorInvalidValue;  // bf16: the sm90 source
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64 ? launch_fwd<float, 64>(q, k, v, seg, out, lse, B, g, s)
                 : launch_fwd<float, 128>(q, k, v, seg, out, lse, B, g, s);
}
