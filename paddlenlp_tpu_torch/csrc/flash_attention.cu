// Flash attention for training on Hopper (sm_90a), CUDA C++ with plain C entries:
// the forward, the dq backward and the dk/dv backward on CUDA cores.
//
// Routes: all three kernels here take fp32 operands only; bf16 ones, the
// training path's, go to the tensor-core kernels of flash_attention_sm90.cu.
// The fp32 route stays here on purpose: the fp32 gates (1e-4 elementwise,
// loss rel 1e-5, gradient leaves 1e-4) need fp32 products, which bf16 or TF32
// operands cannot give, so this is the precise check.
//
// Replaces the Pallas TPU kernels of paddlenlp_tpu/ops/pallas/flash_attention.py:
// `_fa_kernel` (:81, launched by `_flash_fwd` :131), `_bwd_dq_kernel` (:187) and
// `_bwd_dkv_kernel` (:227, both launched by `_flash_bwd` :272). Same function:
// causal or full attention with an optional sliding window (causal only) and
// packed-batch segment ids; GQA reads kv head n / (N / K) with no repeat; the
// softmax is online in fp32 with NEG_INF = -1e30 masking, invisible entries
// forced to p = 0 (exp(NEG_INF - NEG_INF) = 1 on a fully masked row), the
// finalizer divides by max(l, 1e-37) and stores lse = m + log(max(l, 1e-37)).
// The backward recomputes p = exp(s - lse) and takes delta = rowsum(dO * O)
// from the caller; dk/dv accumulate in fp32 per kv head over its whole query
// group inside one thread block, so there are no atomics and no group sum.
//
// Layouts: q, out, dO, dq [B, T, N, H]; k, v, dk, dv [B, S, K, H]; lse, delta
// [B, N, T] fp32; seg [B, T] int32 (or null). Inputs all of one type; out and
// dq in q's type, dk and dv cast to k's type on store.
//
// What bounds it on an H100: operations. At the training path's shape (q
// [2, 4096, 12, 128] bf16, causal) the forward does ~1.0e11 flops on ~60 MB,
// far above the ~295 flop/byte ridge of bf16. Design, simple and right first:
// 64 x 64 tiles staged in shared memory as fp32 (rows padded to H + 1 so that
// lanes reading a column hit distinct banks); 256 threads as 16 x 16, each
// owning a 4 x 4 block of every 64 x 64 score tile and a 4 x (H / 16) block of
// every 64 x H accumulator, rows strided by 16. Products are fp32 FMAs on CUDA
// cores with two shared loads per 4 FMAs; the kv loop of a query tile stops at
// the last tile it can see and starts at the window's first (the TPU kernel's
// `_block_runs` skip, :71), and the dk/dv loop walks only the query tiles
// that see its kv tile. Every global load past T or S is bound-checked and
// zero-filled, so no padding row's lse, delta or dO reaches a sum.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;  // query rows and kv columns of one tile
constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
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

// acc[i][j] += sum_c p[row(i)][c] * x[c][tx + 16 j], row(i) = ty + 16 i; with
// TRANSPOSED, p is read as p[c][row(i)] (acc += p^T x)
template <int H, bool TRANSPOSED>
__device__ __forceinline__ void tile_acc(float (&acc)[4][H / 16], const float* p, const float* x, int ty, int tx) {
#pragma unroll 2
  for (int c = 0; c < TILE; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = TRANSPOSED ? p[c * SP + ty + 16 * i] : p[(ty + 16 * i) * SP + c];
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

template <int H>
constexpr size_t bwd_smem() {
  // four [TILE][H+1] tiles; two score tiles; lse, delta; two segment rows
  return (4 * TILE * (H + 1) + 2 * TILE * SP + 2 * TILE) * sizeof(float) + 2 * TILE * sizeof(int);
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
    tile_acc<H, false>(acc, p_s, v_s, ty, tx);
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

// ------------------------------------------------------------------ backward: dq
template <typename IT, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const IT* __restrict__ q, const IT* __restrict__ k, const IT* __restrict__ v,
                        const IT* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg, IT* __restrict__ dq, Geometry g) {
  constexpr int HP = H + 1, HJ = H / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + TILE * HP;
  float* k_s = do_s + TILE * HP;
  float* v_s = k_s + TILE * HP;
  float* ds_s = v_s + TILE * HP;
  float* lse_s = ds_s + 2 * TILE * SP;  // the second score tile is unused here
  float* dl_s = lse_s + TILE;
  int* sq_s = reinterpret_cast<int*>(dl_s + TILE);
  int* sk_s = sq_s + TILE;

  const int q0 = blockIdx.x * TILE, n = blockIdx.y, b = blockIdx.z;
  const int kh = n / (g.N / g.K);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int* sq = seg != nullptr ? sq_s : nullptr;

  const size_t q_off = (static_cast<size_t>(b) * g.T * g.N + n) * H;
  load_tile<IT, H>(q_s, q + q_off, q0, g.T, g.N * H);
  load_tile<IT, H>(do_s, dout + q_off, q0, g.T, g.N * H);
  if (tid < TILE) {
    const bool live = q0 + tid < g.T;  // padding rows: zero lse and delta, never garbage
    const size_t i = (static_cast<size_t>(b) * g.N + n) * g.T + q0 + tid;
    lse_s[tid] = live ? lse[i] : 0.f;
    dl_s[tid] = live ? delta[i] : 0.f;
    sq_s[tid] = (seg != nullptr && live) ? seg[static_cast<size_t>(b) * g.T + q0 + tid] : 0;
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
    __syncthreads();
    load_tile<IT, H>(k_s, k_b, k0, g.S, g.K * H);
    load_tile<IT, H>(v_s, v_b, k0, g.S, g.K * H);
    if (tid < TILE) sk_s[tid] = (seg != nullptr && k0 + tid < g.S) ? seg[static_cast<size_t>(b) * g.T + k0 + tid] : 0;
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<H>(s, q_s, k_s, ty, tx);
    tile_dot<H>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float p = visible(g, q0 + r, k0 + c, sq, sk_s, r, c) ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
        ds_s[r * SP + c] = p * (dp[i][j] - dl_s[r]) * g.scale;
      }
    __syncthreads();
    tile_acc<H, false>(acc, ds_s, k_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < g.T) {
      IT* o = dq + (static_cast<size_t>(b) * g.T + row) * g.N * H + static_cast<size_t>(n) * H;
#pragma unroll
      for (int j = 0; j < HJ; ++j) o[tx + 16 * j] = from_f32<IT>(acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------ backward: dk, dv
template <typename IT, int H>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const IT* __restrict__ q, const IT* __restrict__ k, const IT* __restrict__ v,
                         const IT* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, IT* __restrict__ dk, IT* __restrict__ dv, Geometry g) {
  constexpr int HP = H + 1, HJ = H / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + TILE * HP;
  float* q_s = v_s + TILE * HP;
  float* do_s = q_s + TILE * HP;
  float* p_s = do_s + TILE * HP;
  float* ds_s = p_s + TILE * SP;
  float* lse_s = ds_s + TILE * SP;
  float* dl_s = lse_s + TILE;
  int* sq_s = reinterpret_cast<int*>(dl_s + TILE);
  int* sk_s = sq_s + TILE;

  const int k0 = blockIdx.x * TILE, kh = blockIdx.y, b = blockIdx.z;
  const int group = g.N / g.K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int* sq = seg != nullptr ? sq_s : nullptr;

  const size_t kv_off = (static_cast<size_t>(b) * g.S * g.K + kh) * H;
  load_tile<IT, H>(k_s, k + kv_off, k0, g.S, g.K * H);
  load_tile<IT, H>(v_s, v + kv_off, k0, g.S, g.K * H);
  if (tid < TILE) sk_s[tid] = (seg != nullptr && k0 + tid < g.S) ? seg[static_cast<size_t>(b) * g.T + k0 + tid] : 0;

  // dk and dv rows c = ty + 16 i (kv positions), columns tx + 16 j
  float dk_acc[4][HJ], dv_acc[4][HJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_q = (g.T + TILE - 1) / TILE;
  int i_lo = 0, i_hi = n_q;
  if (g.causal) {
    i_lo = k0 / TILE;  // rows before k0 see none of this tile
    if (g.window >= 0) i_hi = min(n_q, (k0 + TILE - 1 + g.window - 1) / TILE + 1);
  }
  for (int gi = 0; gi < group; ++gi) {
    const int n = kh * group + gi;
    const size_t q_off = (static_cast<size_t>(b) * g.T * g.N + n) * H;
    for (int it = i_lo; it < i_hi; ++it) {
      const int q0 = it * TILE;
      __syncthreads();  // the previous query tile's readers are done
      load_tile<IT, H>(q_s, q + q_off, q0, g.T, g.N * H);
      load_tile<IT, H>(do_s, dout + q_off, q0, g.T, g.N * H);
      if (tid < TILE) {
        const bool live = q0 + tid < g.T;  // padding rows: zero lse and delta, never garbage
        const size_t i = (static_cast<size_t>(b) * g.N + n) * g.T + q0 + tid;
        lse_s[tid] = live ? lse[i] : 0.f;
        dl_s[tid] = live ? delta[i] : 0.f;
        sq_s[tid] = (seg != nullptr && live) ? seg[static_cast<size_t>(b) * g.T + q0 + tid] : 0;
      }
      __syncthreads();

      // query rows r = ty + 16 i against kv columns c = tx + 16 j
      float s[4][4] = {}, dp[4][4] = {};
      tile_dot<H>(s, q_s, k_s, ty, tx);
      tile_dot<H>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const float p = visible(g, q0 + r, k0 + c, sq, sk_s, r, c) ? expf(s[i][j] * g.scale - lse_s[r]) : 0.f;
          p_s[r * SP + c] = p;
          ds_s[r * SP + c] = p * (dp[i][j] - dl_s[r]) * g.scale;
        }
      __syncthreads();
      tile_acc<H, true>(dv_acc, p_s, do_s, ty, tx);  // dv += p^T dO
      tile_acc<H, true>(dk_acc, ds_s, q_s, ty, tx);  // dk += ds^T q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = k0 + ty + 16 * i;
    if (col < g.S) {
      const size_t off = (static_cast<size_t>(b) * g.S + col) * g.K * H + static_cast<size_t>(kh) * H;
#pragma unroll
      for (int j = 0; j < HJ; ++j) {
        dk[off + tx + 16 * j] = from_f32<IT>(dk_acc[i][j]);
        dv[off + tx + 16 * j] = from_f32<IT>(dv_acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
// Above 48 KB, shared memory is only available opted in: set once per kernel
// instantiation and device, not on every launch.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    done[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

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

template <typename IT, int H>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* seg, void* dq, int B, const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dq_kernel<IT, H>;
  cudaError_t err = opt_in(kernel, bwd_smem<H>(), done);
  if (err != cudaSuccess) return err;
  dim3 grid((g.T + TILE - 1) / TILE, g.N, B);
  kernel<<<grid, THREADS, bwd_smem<H>(), s>>>(
      static_cast<const IT*>(q), static_cast<const IT*>(k), static_cast<const IT*>(v),
      static_cast<const IT*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<IT*>(dq), g);
  return cudaGetLastError();
}

template <typename IT, int H>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* seg, void* dk, void* dv, int B, const Geometry& g,
                       cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dkv_kernel<IT, H>;
  cudaError_t err = opt_in(kernel, bwd_smem<H>(), done);
  if (err != cudaSuccess) return err;
  dim3 grid((g.S + TILE - 1) / TILE, g.K, B);
  kernel<<<grid, THREADS, bwd_smem<H>(), s>>>(
      static_cast<const IT*>(q), static_cast<const IT*>(k), static_cast<const IT*>(v),
      static_cast<const IT*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<IT*>(dk), static_cast<IT*>(dv), g);
  return cudaGetLastError();
}

bool bad_geometry(int B, int T, int S, int N, int K, int H, int dtype) {
  return B < 0 || T < 0 || S < 0 || K < 1 || N % K != 0 || (H != 64 && H != 128) || (dtype != 0 && dtype != 1) ||
         B > 65535 || N > 65535;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype, head_dim or geometry).
// dtype must be 0 (fp32: q, k, v, dO and the outputs); window < 0: none; seg
// may be null.
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

extern "C" int pdnlp_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* seg, void* dq, int B, int T, int S, int N, int K,
                                  int H, int causal, int window, int dtype, float scale, void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype) || dtype != 0) return cudaErrorInvalidValue;  // bf16: the sm90 source
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64 ? launch_dq<float, 64>(q, k, v, dout, lse, delta, seg, dq, B, g, s)
                 : launch_dq<float, 128>(q, k, v, dout, lse, delta, seg, dq, B, g, s);
}

extern "C" int pdnlp_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                   const void* delta, const void* seg, void* dk, void* dv, int B, int T, int S,
                                   int N, int K, int H, int causal, int window, int dtype, float scale,
                                   void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype) || dtype != 0) return cudaErrorInvalidValue;  // bf16: the sm90 source
  if (B == 0 || S == 0 || K == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return H == 64 ? launch_dkv<float, 64>(q, k, v, dout, lse, delta, seg, dk, dv, B, g, s)
                 : launch_dkv<float, 128>(q, k, v, dout, lse, delta, seg, dk, dv, B, g, s);
}
