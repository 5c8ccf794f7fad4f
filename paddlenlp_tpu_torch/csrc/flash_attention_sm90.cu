// Flash attention for training on Hopper tensor cores (sm_90a), bf16, CUDA C++
// with plain C entries: the forward, the dq backward and the dk/dv backward.
//
// Replaces, for bf16 operands, the Pallas TPU kernels of
// paddlenlp_tpu/ops/pallas/flash_attention.py: `_fa_kernel` (:81, launched at
// :157 by `_flash_fwd` :131), `_bwd_dq_kernel` (:187, launched at :293 by
// `_flash_bwd` :272) and `_bwd_dkv_kernel` (:227, launched at :317). Same
// function as the 3xTF32 kernels of flash_attention_sm90_f32.cu, which are
// the route for fp32 operands: the fp32 gates (1e-4 elementwise, loss rel
// 1e-5, gradient leaves 1e-4) cannot hold with bf16 operands in the
// products, so the fp32 path is the precise check and this file is the main
// path. Causal or full attention, an optional window (causal only), packed
// segment ids, GQA (query head n reads kv head n / (N / K)); NEG_INF = -1e30
// masking with invisible entries forced to p = 0; the forward divides by
// max(l, 1e-37) and stores lse = m + log(max(l, 1e-37)) as a natural log
// (the softmax runs in exp2 with scale * log2(e) folded into one FMA; m is
// the unscaled row max, so lse takes m * scale); dq and dk/dv recompute
// p = exp(s - lse) and ds = p (dP - delta) scale; dk/dv sum over each kv
// head's whole query group inside one block, with no atomics.
//
// Layouts: q, out, dO, dq [B, T, N, H] bf16; k, v, dk, dv [B, S, K, H] bf16; lse,
// delta [B, N, T] fp32; seg [B, T] int32 (or null); H 64, 128 or 192 (192:
// DeepSeek-V2's MLA, q and k at qk_nope 128 + qk_rope 64, v padded up to them).
//
// What bounds it on an H100: operations. At the training path's shape (q
// [2, 4096, 12, 128] over k/v [2, 4096, 2, 128], causal) the forward needs
// 0.104 ms, dq 0.156 ms and dk/dv 0.209 ms at the 989 TFLOP/s bf16 peak; at
// DeepSeek-V2-Lite's (q/k/v [1, 4096, 16, 192]) B N H is the same 3072, and
// so are the bounds.
// Design:
// - bf16 tiles arrive by TMA (a 4-D tensor map over [B, T, heads, H], so rows
//   past T inside one batch are zero-filled by the hardware) into a ring of
//   shared-memory stages with one mbarrier pair (full, empty) per stage; a
//   producer warp keeps the ring filled while the consumer warpgroups compute.
//   Tiles are 64-column panels with the 128-byte swizzle that wgmma reads.
// - Products are `wgmma` bf16 -> fp32. S = Q K^T and, in dk/dv, S^T = K Q^T
//   and dP^T = V dO^T, and in dq dP = dO V^T, take both operands from shared
//   memory, K-major. P, P^T, dS^T and dS become bf16 in registers and are the
//   A operand from registers; V, dO, Q and (in dq) K are the B operand
//   MN-major (the transpose bit), so nothing goes back to shared memory for a
//   transpose. P, P^T, dS^T and dS go in as two
//   bf16 parts (the rounding and the rounding of its residual, two products
//   each): one rounding exceeds the card's elementwise gate on dk and dv and
//   leaves out within a few percent of it (tests/test_torch_flash_attention.py
//   emulates both on the CPU).
// - All three kernels run two consumer warpgroups at 240 registers a thread,
//   taken with `setmaxnreg` from the producer warpgroup, which keeps 24.
//   The two take turns (named barriers) to start the first products of each
//   step, so they run out of phase: one's exp and rounding overlap the
//   other's products.
// - Forward: one block per (128 query rows, head, batch), two consumer
//   warpgroups of 64 rows, 128-row kv tiles, online softmax in registers
//   (row max and sum over the 4 lanes that share a row); the per-element mask
//   runs only on tiles that are not wholly visible, and tiles that are wholly
//   invisible are never loaded (`_block_runs`, :71). Query tiles launch from
//   the last to the first, so the causal mask's long tiles start first.
// - dk/dv: one block per 64-row kv tile with K and V resident; Q and dO tiles
//   of every query head of the group stream through a 4-stage ring with their
//   lse, delta and segment ids. Two consumer warpgroups take alternate
//   tiles, each summing its own dK and dV; at the end the second hands its fp32 sums to the first
//   through shared memory, a fixed order with no atomics. Schedule: the group
//   loop stays inside the block (deterministic); the kv tile is the slowest
//   grid dimension, so under the causal mask the blocks of tile 0, which walk
//   group x n_q query tiles, start first and the short ones fill the tail.
// - dq: the forward's shape. One block per (128 query rows, head, batch), the
//   last query tile first; Q and dO resident (loaded once by TMA), each row's
//   lse * log2(e), delta and segment id in the registers of the threads that
//   own it; 64-row K and V tiles stream through a 4-stage ring, tiles wholly
//   invisible never loaded. Each warpgroup runs S and dP for its 64 rows, the
//   mask only on tiles that are not wholly visible, dS in registers, and
//   dq += dS K; one bf16 store a row at the end: no atomics, deterministic.
// - Rows at or past T never reach a sum: their loads are zero, their lse and
//   delta 0, and they are never stored.
// - H 192 (`<192>`: three 64-column panels a row, `wgmma` m64n192k16 for the
//   products over H). The H 128 tile plans would not fit the 227 KB of shared
//   memory a block may take (forward 240 KB, dq 288, dk/dv 240) nor, in
//   dk/dv, the 240 registers a thread (dK and dV sums of 96 each beside S^T's
//   and dP^T's 32). So: the forward takes 64-row kv tiles in 3 stages (192
//   KB; O 96 + S 32 registers); dq a 2-stage ring (192 KB); dk/dv a 3-stage
//   ring (192 KB) with the outputs split between the warpgroups instead of
//   the items (`DkvSmem::SPLIT`): on every item warpgroup 0 computes S^T and
//   P^T and sums dV = P^T dO, and hands its fp32 P^T through shared memory
//   (16 KB, two named barriers) to warpgroup 1, which computes dP^T, dS^T
//   and sums dK = dS^T Q; each stores its own sums. Each warpgroup holds one
//   96-register sum, and no `<192>` instantiation spills. A first version
//   had warpgroup 1 compute S^T again instead of the hand-off (5 product sets
//   for 4, three of them on warpgroup 1): 1.04-1.05 ms against the hand-off's
//   0.71-0.77 at q/k/v [1, 4096, 16, 192], in turns in one call
//   (tools/flash_sm90_compare.py). The H 64 and 128 plans are unchanged.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_DEVICES = 64;
constexpr int PANEL = 64;  // bf16 columns of one 128-byte swizzled panel

struct Geometry {
  int T, S, N, K, causal, window;  // window < 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const Geometry& g, int row, int col) {
  bool ok = row < g.T && col < g.S;
  if (g.causal) ok = ok && col <= row;
  if (g.window >= 0) ok = ok && col > row - g.window;
  return ok;
}

// every (row, col) of rows [r0, r1] x cols [c0, c1] visible, segments aside
__device__ __forceinline__ bool all_visible(const Geometry& g, int r0, int r1, int c0, int c1) {
  bool ok = r1 < g.T && c1 < g.S;
  if (g.causal) ok = ok && c1 <= r0;
  if (g.window >= 0) ok = ok && c0 > r1 - g.window;
  return ok;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// one 64-column panel of `rows` rows: box {64, 1, rows, 1} at (col, head, row, batch)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int head, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

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

// The two consumer warpgroups take turns to start their first products of a
// step (item u, alternating owners): the owner of u > 0 waits on its named
// barrier (1 or 2) until the owner of u - 1 has started them and passed the
// turn.
// The warpgroups then run out of phase, one's exp and rounding overlapping
// the other's products, instead of contending for the tensor cores at once.
__device__ __forceinline__ void turn_wait(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory"); }
__device__ __forceinline__ void turn_pass(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory"); }

// a value the compiler cannot see through: recomputed from it where used
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("mov.b64 %0, %0;\n" : "+l"(x));
  return x;
}

// keeps the compiler from moving register reads and writes across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate);
// D[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);


template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
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

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

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

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
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

// ------------------------------------------------------------------ forward
constexpr int FWD_BQ = 128;  // query rows of a block: two consumer warpgroups of 64
constexpr int FWD_THREADS = 384;  // warpgroups 0-1 consume, warp 8 of warpgroup 2 produces
constexpr int SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may opt in to

// The tile plan by head dim. H 64 and 128: 128-row kv tiles, 2 stages. H 192:
// the same would take Q 48 KB + 2 x (K 48 + V 48) = 240 KB, over the limit, so
// 64-row kv tiles in 3 stages (192 KB); S is then 32 registers beside O's 96.
template <int H>
struct FwdSmem {
  static constexpr int BKV = H == 192 ? 64 : 128;  // kv rows of a tile
  static constexpr int STAGES = H == 192 ? 3 : 2;
  static constexpr int TILE_Q = FWD_BQ * H * 2, TILE_KV = BKV * H * 2;  // bytes, multiples of 1024
  static constexpr size_t q = 0;
  static constexpr size_t k = q + TILE_Q;
  static constexpr size_t v = k + STAGES * TILE_KV;
  static constexpr size_t seg = v + STAGES * TILE_KV;  // kv segment ids of each stage
  static constexpr size_t bar = seg + STAGES * BKV * 4;  // q_full, full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "the forward's tiles fit in shared memory");
};

template <int H>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ seg,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse, Geometry g) {
  using L = FwdSmem<H>;
  constexpr int FWD_BKV = L::BKV, FWD_STAGES = L::STAGES;
  constexpr int PANELS = H / PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_s = smem + L::q;
  uint8_t* k_s = smem + L::k;
  uint8_t* v_s = smem + L::v;
  int* seg_s = reinterpret_cast<int*>(smem + L::seg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FWD_STAGES;

  // the last query tile first: under the causal mask it walks the most kv tiles
  const int n = blockIdx.x, b = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * FWD_BQ;
  const int kh = n / (g.N / g.K);
  int j_lo = 0, j_hi = (g.S + FWD_BKV - 1) / FWD_BKV;
  if (g.causal) {
    j_hi = min(j_hi, (min(q0 + FWD_BQ, g.T) - 1) / FWD_BKV + 1);
    if (g.window >= 0) j_lo = max(0, q0 - g.window + 1) / FWD_BKV;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; lane 0 also expects the TMA bytes
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {  // ---- producer warpgroup: gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8) return;
    // warp 8: Q once, then K, V and kv segment ids through the ring
    if (lane == 0) {
      mbar_arrive_tx(q_full, L::TILE_Q);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) tma_load(q_s + p * FWD_BQ * 128, &tm_q, q_full, p * PANEL, n, q0, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int jt = j_lo; jt < j_hi; ++jt) {
      mbar_wait(&empty[stage], phase ^ 1);
      const int k0 = jt * FWD_BKV;
      if (seg != nullptr) {
        int* sk = seg_s + stage * FWD_BKV;
        for (int i = lane; i < FWD_BKV; i += 32) sk[i] = k0 + i < g.S ? seg[static_cast<size_t>(b) * g.T + k0 + i] : -1;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], 2 * L::TILE_KV);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(k_s + stage * L::TILE_KV + p * FWD_BKV * 128, &tm_k, &full[stage], p * PANEL, kh, k0, b);
          tma_load(v_s + stage * L::TILE_KV + p * FWD_BKV * 128, &tm_v, &full[stage], p * PANEL, kh, k0, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == FWD_STAGES) stage = 0, phase ^= 1;
    }
  } else {  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;
    const int r = 16 * (warp % 4) + lane / 4;  // this thread's rows r and r + 8 of the 64
    const int row0 = q0 + wg * 64 + r, row1 = row0 + 8;
    const int wr0 = q0 + wg * 64, wr1 = wr0 + 63;
    const int cq = 2 * (lane % 4);  // this thread's first column in each group of 8
    int sq0 = 0, sq1 = 0;
    if (seg != nullptr) {
      sq0 = row0 < g.T ? seg[static_cast<size_t>(b) * g.T + row0] : -2;
      sq1 = row1 < g.T ? seg[static_cast<size_t>(b) * g.T + row1] : -2;
    }
    const float sl2 = g.scale * LOG2E;
    float o[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // m: the row max of the unscaled q.k
    const uint8_t* q_wg = q_s + wg * 64 * 128;
    mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int jt = j_lo; jt < j_hi; ++jt) {
      const int k0 = jt * FWD_BKV;
      mbar_wait(&full[stage], phase);
      const uint8_t* k_t = k_s + stage * L::TILE_KV;
      const uint8_t* v_t = v_s + stage * L::TILE_KV;

      float s[FWD_BKV / 2];  // S = Q K^T, 64 x FWD_BKV: rows r / r + 8, columns 8 j + cq + {0, 1}
      const int u = 2 * (jt - j_lo) + wg;  // turns alternate over the 2 (j_hi - j_lo) steps
      if (u > 0) turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = (kk % 4) * 32;  // 16 columns = 32 bytes into a panel
        wgmma_ss<FWD_BKV>(s, desc(q_wg + (kk / 4) * FWD_BQ * 128 + off, 16),
                          desc(k_t + (kk / 4) * FWD_BKV * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
      if (u + 1 < 2 * (j_hi - j_lo)) turn_pass(wg);
      wgmma_wait_all();
      fence_regs(s);

      if (seg != nullptr || !all_visible(g, wr0, wr1, k0, k0 + FWD_BKV - 1)) {
        const int* sk = seg_s + stage * FWD_BKV;
#pragma unroll
        for (int j = 0; j < FWD_BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + cq + e, col = k0 + c;
            bool v0 = visible(g, row0, col), v1 = visible(g, row1, col);
            if (seg != nullptr) {
              const int skc = sk[c];
              v0 = v0 && sq0 == skc;
              v1 = v1 && sq1 == skc;
            }
            if (!v0) s[4 * j + e] = NEG_INF;
            if (!v1) s[4 * j + 2 + e] = NEG_INF;
          }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < FWD_BKV / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // p = exp2(s sl2 - m sl2), one FMA and one exp2 an element; a row that has
      // seen nothing yet subtracts 0, so its NEG_INF entries give p = 0
      const float mu0 = mn0 == NEG_INF ? 0.f : mn0 * sl2, mu1 = mn1 == NEG_INF ? 0.f : mn1 * sl2;
      const float a0 = exp2f(m0 * sl2 - mu0), a1 = exp2f(m1 * sl2 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < FWD_BKV / 8; ++j) {
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
      // P as the A operand in two bf16 parts (high, residual): k-chunk kk is
      // the accumulator's columns 16 kk .. 16 kk + 15. One rounding of P
      // leaves out within a few percent of the card's gate (the CPU emulation
      // test), and the row sum above is of fp32 P.
      uint32_t p_hi[FWD_BKV / 16][4], p_lo[FWD_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < FWD_BKV / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], p_hi[kk][i], p_lo[kk][i]);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BKV / 16; ++kk) {  // O += P V, V [kv, H] MN-major: 16 kv rows = 2048 bytes
        wgmma_rs<H>(o, p_hi[kk], desc(v_t + kk * 16 * 128, FWD_BKV * 128));
        wgmma_rs<H>(o, p_lo[kk], desc(v_t + kk * 16 * 128, FWD_BKV * 128));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[stage]);
      if (++stage == FWD_STAGES) stage = 0, phase ^= 1;
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
    if (row0 < g.T) {
      __nv_bfloat16* op = out + (static_cast<size_t>(b) * g.T + row0) * g.N * H + static_cast<size_t>(n) * H + cq;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (lane % 4 == 0)
        lse[(static_cast<size_t>(b) * g.N + n) * g.T + row0] = (m0 == NEG_INF ? NEG_INF : m0 * g.scale) + logf(d0);
    }
    if (row1 < g.T) {
      __nv_bfloat16* op = out + (static_cast<size_t>(b) * g.T + row1) * g.N * H + static_cast<size_t>(n) * H + cq;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      if (lane % 4 == 0)
        lse[(static_cast<size_t>(b) * g.N + n) * g.T + row1] = (m1 == NEG_INF ? NEG_INF : m1 * g.scale) + logf(d1);
    }
  }
}

// ------------------------------------------------------------------ backward: dk, dv
constexpr int DKV_BKV = 64;  // kv rows of a block, shared by both consumer warpgroups
constexpr int DKV_BQ = 64;  // query rows of a streamed tile
constexpr int DKV_THREADS = 384;  // warpgroups 0-1 consume, warp 8 of warpgroup 2 produces

// H 64 and 128: the warpgroups take alternate items, each summing its own dK
// and dV (H registers a thread), in a 4-stage ring (even: warpgroup w
// consumes the stages of parity w). H 192: dK and dV would take 192 registers
// a thread beside S^T's and dP^T's 64, past the 240 there are, and the H 128
// ring, 48 + 4 x 48 = 240 KB, is over the shared-memory limit. So the
// warpgroups split the outputs instead (SPLIT): both take every item;
// warpgroup 0 computes S^T and P^T, sums dV = P^T dO and hands P^T to
// warpgroup 1 (`pt`), which computes dP^T and dS^T and sums dK = dS^T Q,
// each over 96 registers, in a 3-stage ring (192 KB + 16 KB of P^T); each
// stores its own sums.
template <int H>
struct DkvSmem {
  static constexpr bool SPLIT = H == 192;
  static constexpr int STAGES = SPLIT ? 3 : 4;
  static constexpr int TILE = 64 * H * 2;  // bytes of a 64-row tile, a multiple of 1024
  static constexpr int ROWV = DKV_BQ * 12;  // lse * log2(e), delta, segment id of a query tile's rows
  static constexpr size_t k = 0;
  static constexpr size_t v = k + TILE;
  static constexpr size_t q = v + TILE;  // the stages' Q tiles, then their dO tiles; at the end,
  static constexpr size_t dout = q + STAGES * TILE;  // warpgroup 1's fp32 dk and dv for warpgroup 0
  static constexpr size_t rowv = dout + STAGES * TILE;
  static constexpr size_t segk = rowv + STAGES * ROWV;
  static constexpr size_t pt = segk + DKV_BKV * 4;  // SPLIT: an item's fp32 P^T, warpgroup 0 to 1
  static constexpr size_t bar = pt + (SPLIT ? DKV_BKV * DKV_BQ * 4 : 0);  // kv_full, full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SPLIT || STAGES % 2 == 0, "alternate items: each warpgroup owns the stages of one parity");
  static_assert(SPLIT || 2 * STAGES * TILE >= 2 * DKV_BKV * H * 4, "the exchange of fp32 dk, dv fits the stages");
  static_assert(bytes <= SMEM_LIMIT, "dk/dv's tiles fit in shared memory");
};

// named barrier 3 over the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 3, 256;\n" ::: "memory"); }
// SPLIT dk/dv: named barrier 4, an item's P^T written by warpgroup 0 (pass)
// for warpgroup 1 (wait); 5, read by warpgroup 1 (pass), so warpgroup 0 may
// write the next (wait)
__device__ __forceinline__ void pt_ready_pass() { asm volatile("bar.arrive 4, 256;\n" ::: "memory"); }
__device__ __forceinline__ void pt_ready_wait() { asm volatile("bar.sync 4, 256;\n" ::: "memory"); }
__device__ __forceinline__ void pt_consumed_pass() { asm volatile("bar.arrive 5, 256;\n" ::: "memory"); }
__device__ __forceinline__ void pt_consumed_wait() { asm volatile("bar.sync 5, 256;\n" ::: "memory"); }

template <int H>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              const int* __restrict__ seg, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, Geometry g) {
  using L = DkvSmem<H>;
  constexpr int PANELS = H / PANEL, DKV_STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* k_s = smem + L::k;
  uint8_t* v_s = smem + L::v;
  uint8_t* q_s = smem + L::q;
  uint8_t* do_s = smem + L::dout;
  uint8_t* rowv_s = smem + L::rowv;
  int* segk_s = reinterpret_cast<int*>(smem + L::segk);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;

  // the kv tile is the slowest grid dimension: tile 0's blocks, the longest
  // under the causal mask, are scheduled first
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * DKV_BKV;
  const int group = g.N / g.K;
  const int n_q = (g.T + DKV_BQ - 1) / DKV_BQ;
  int i_lo = 0, i_hi = n_q;
  if (g.causal) {
    i_lo = k0 / DKV_BQ;  // rows before k0 see none of this tile
    if (g.window >= 0) i_hi = min(n_q, (k0 + DKV_BKV - 1 + g.window - 1) / DKV_BQ + 1);
  }
  // items u = (it - i_lo) * group + gi walk every query tile of every head of
  // the group; warpgroup w takes the items u = w mod 2
  const int items = max(i_hi - i_lo, 0) * group;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 32);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], L::SPLIT ? 256 : 128);  // the warpgroups that consume the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {  // ---- producer warpgroup: gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8) return;
    // warp 8: K, V once; then the items through the ring
    for (int i = lane; i < DKV_BKV; i += 32)
      segk_s[i] = (seg != nullptr && k0 + i < g.S) ? seg[static_cast<size_t>(b) * g.T + k0 + i] : -1;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * L::TILE);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load(k_s + p * DKV_BKV * 128, &tm_k, kv_full, p * PANEL, kh, k0, b);
        tma_load(v_s + p * DKV_BKV * 128, &tm_v, kv_full, p * PANEL, kh, k0, b);
      }
    } else {
      mbar_arrive(kv_full);
    }
    for (int u = 0; u < items; ++u) {
      const int stage = u % DKV_STAGES, n = kh * group + u % group, q0 = (i_lo + u / group) * DKV_BQ;
      mbar_wait(&empty[stage], ((u / DKV_STAGES) & 1) ^ 1);
      float* lse2 = reinterpret_cast<float*>(rowv_s + stage * L::ROWV);
      float* dl = lse2 + DKV_BQ;
      int* sq = reinterpret_cast<int*>(dl + DKV_BQ);
      for (int i = lane; i < DKV_BQ; i += 32) {
        const int t = q0 + i;
        const bool live = t < g.T;  // padding rows: zero lse and delta, never garbage
        const size_t idx = (static_cast<size_t>(b) * g.N + n) * g.T + t;
        lse2[i] = live ? lse[idx] * LOG2E : 0.f;
        dl[i] = live ? delta[idx] : 0.f;
        sq[i] = (seg != nullptr && live) ? seg[static_cast<size_t>(b) * g.T + t] : -2;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], 2 * L::TILE);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(q_s + stage * L::TILE + p * DKV_BQ * 128, &tm_q, &full[stage], p * PANEL, n, q0, b);
          tma_load(do_s + stage * L::TILE + p * DKV_BQ * 128, &tm_do, &full[stage], p * PANEL, n, q0, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
    }
  } else if constexpr (L::SPLIT) {  // ---- consumer warpgroup wg: kv rows k0 + r, k0 + r + 8, every item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, tid = threadIdx.x % 128;
    const int r = 16 * (warp % 4) + lane / 4;
    const int c0 = k0 + r, c1 = c0 + 8;
    const int cq = 2 * (lane % 4);
    const float sl2 = g.scale * LOG2E;
    float acc[H / 2];  // warpgroup 0: dV, warpgroup 1: dK
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    // P^T of the current item, from warpgroup 0 to warpgroup 1: element i of
    // thread tid at [i][tid] (the same fragment layout in both warpgroups)
    float* pt = reinterpret_cast<float*>(smem + L::pt);
    mbar_wait(kv_full, 0);
    const int sk0 = segk_s[r], sk1 = segk_s[r + 8];
    const uint64_t k_base = desc(k_s, 16), v_base = desc(v_s, 16), q_base = desc(q_s, 16), do_base = desc(do_s, 16);
    constexpr uint64_t MN_MAJOR = static_cast<uint64_t>(DKV_BQ * 128 / 16 - 1) << 16;

    for (int u = 0; u < items; ++u) {
      const int stage = u % DKV_STAGES, q0 = (i_lo + u / group) * DKV_BQ;
      mbar_wait(&full[stage], (u / DKV_STAGES) & 1);
      const float* lse2 = reinterpret_cast<const float*>(rowv_s + stage * L::ROWV);
      const float* dl = lse2 + DKV_BQ;
      const int* sq = reinterpret_cast<const int*>(dl + DKV_BQ);
      const uint64_t q_d = opaque(q_base) + stage * (L::TILE >> 4), do_d = opaque(do_base) + stage * (L::TILE >> 4);
      // warpgroup 0: S^T = K Q^T, then P^T; warpgroup 1: dP^T = V dO^T, then
      // dS^T = P^T (dP^T - delta) scale with warpgroup 0's P^T
      const uint64_t a_d = wg == 0 ? opaque(k_base) : opaque(v_base), b_d = wg == 0 ? q_d : do_d;
      float st[DKV_BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = ((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss<DKV_BQ>(st, a_d + off, b_d + off, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      if (wg == 0) {
        const bool all_vis = seg == nullptr && all_visible(g, q0, q0 + DKV_BQ - 1, k0, k0 + DKV_BKV - 1);
#pragma unroll
        for (int j = 0; j < DKV_BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + cq + e, tq = q0 + col;
            const float l2 = lse2[col];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              float p = exp2f(st[i] * sl2 - l2);
              if (!all_vis) {
                const bool vis = visible(g, tq, h ? c1 : c0) && (seg == nullptr || sq[col] == (h ? sk1 : sk0));
                if (!vis) p = 0.f;
              }
              st[i] = p;
            }
          }
        if (u > 0) pt_consumed_wait();  // warpgroup 1 has read the previous item's P^T
#pragma unroll
        for (int i = 0; i < DKV_BQ / 2; ++i) pt[i * 128 + tid] = st[i];
        pt_ready_pass();
      } else {
        pt_ready_wait();
#pragma unroll
        for (int j = 0; j < DKV_BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dlt = dl[8 * j + cq + e];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              st[i] = pt[i * 128 + tid] * (st[i] - dlt) * g.scale;
            }
          }
        if (u + 1 < items) pt_consumed_pass();
      }
      // acc += A B: A = P^T or dS^T in two bf16 parts (high, residual), B = dO
      // or Q [query, H] MN-major, 16 query rows = 2048 bytes
      uint32_t a_hi[DKV_BQ / 16][4], a_lo[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1], a_hi[kk][i], a_lo[kk][i]);
      const uint64_t m_d = (wg == 0 ? do_d : q_d) + MN_MAJOR;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
        wgmma_rs<H>(acc, a_hi[kk], m_d + kk * (2048 >> 4));
        wgmma_rs<H>(acc, a_lo[kk], m_d + kk * (2048 >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
    }

    // each warpgroup stores its own sums: dV from warpgroup 0, dK from 1
    __nv_bfloat16* dst = wg == 0 ? dv : dk;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = h ? c1 : c0;
      if (c < g.S) {
        const size_t off = (static_cast<size_t>(b) * g.S + c) * g.K * H + static_cast<size_t>(kh) * H + cq;
#pragma unroll
        for (int j = 0; j < H / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + off + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {  // ---- consumer warpgroup wg: kv rows k0 + r and k0 + r + 8, items u = wg mod 2
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4, tid = threadIdx.x % 128;
    const int r = 16 * (warp % 4) + lane / 4;
    const int c0 = k0 + r, c1 = c0 + 8;
    const int cq = 2 * (lane % 4);  // this thread's first query column in each group of 8
    const float sl2 = g.scale * LOG2E;
    float dk_acc[H / 2], dv_acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);
    const int sk0 = segk_s[r], sk1 = segk_s[r + 8];
    // K-major descriptors of K, V and stage 0's Q, dO; the MN-major ones of Q
    // and dO differ in LBO alone (16 bytes -> a panel), an add to its field
    const uint64_t k_base = desc(k_s, 16), v_base = desc(v_s, 16), q_base = desc(q_s, 16), do_base = desc(do_s, 16);
    constexpr uint64_t MN_MAJOR = static_cast<uint64_t>(DKV_BQ * 128 / 16 - 1) << 16;

    for (int u = wg; u < items; u += 2) {
      const int stage = u % DKV_STAGES, q0 = (i_lo + u / group) * DKV_BQ;
      mbar_wait(&full[stage], (u / DKV_STAGES) & 1);
      const float* lse2 = reinterpret_cast<const float*>(rowv_s + stage * L::ROWV);
      const float* dl = lse2 + DKV_BQ;
      const int* sq = reinterpret_cast<const int*>(dl + DKV_BQ);

      // S^T = K Q^T and dP^T = V dO^T, 64 kv rows x 64 query columns; the
      // descriptors come from opaque bases each step, so the compiler keeps
      // four 64-bit values live across the loop, not one per k-slice (at 240
      // registers a thread, those spill)
      const uint64_t k_d = opaque(k_base), v_d = opaque(v_base);
      const uint64_t q_d = opaque(q_base) + stage * (L::TILE >> 4), do_d = opaque(do_base) + stage * (L::TILE >> 4);
      float st[DKV_BQ / 2], dpt[DKV_BQ / 2];
      if (u > 0) turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = ((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss<DKV_BQ>(st, k_d + off, q_d + off, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = ((kk / 4) * 64 * 128 + (kk % 4) * 32) >> 4;
        wgmma_ss<DKV_BQ>(dpt, v_d + off, do_d + off, kk > 0);
      }
      wgmma_commit();
      if (u + 1 < items) turn_pass(wg);
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta) scale, column-wise lse and delta
      const bool all_vis = seg == nullptr && all_visible(g, q0, q0 + DKV_BQ - 1, k0, k0 + DKV_BKV - 1);
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + cq + e, t = q0 + col;
          const float l2 = lse2[col], dlt = dl[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2f(st[i] * sl2 - l2);
            if (!all_vis) {
              const bool vis = visible(g, t, h ? c1 : c0) && (seg == nullptr || sq[col] == (h ? sk1 : sk0));
              if (!vis) p = 0.f;
            }
            st[i] = p;
            dpt[i] = p * (dpt[i] - dlt) * g.scale;
          }
        }
      // dV += P^T dO, then dK += dS^T Q: dO and Q [query, H] MN-major, 16
      // query rows = 2048 bytes. P^T and dS^T go in as two bf16 parts each
      // (high, residual): one bf16 rounding of them exceeds the card's gate on
      // dk and dv (the CPU emulation test). dS^T's parts are made while P^T's
      // products run.
      uint32_t p_hi[DKV_BQ / 16][4], p_lo[DKV_BQ / 16][4], d_hi[DKV_BQ / 16][4], d_lo[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1], p_hi[kk][i], p_lo[kk][i]);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
        wgmma_rs<H>(dv_acc, p_hi[kk], do_d + MN_MAJOR + kk * (2048 >> 4));
        wgmma_rs<H>(dv_acc, p_lo[kk], do_d + MN_MAJOR + kk * (2048 >> 4));
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1], d_hi[kk][i], d_lo[kk][i]);
      wgmma_fence();  // the A registers just written
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
        wgmma_rs<H>(dk_acc, d_hi[kk], q_d + MN_MAJOR + kk * (2048 >> 4));
        wgmma_rs<H>(dk_acc, d_lo[kk], q_d + MN_MAJOR + kk * (2048 >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[stage]);
    }

    // warpgroup 1 hands its sums to warpgroup 0 through the (drained) stages,
    // element i of thread tid at [i][tid]: a fixed order, no atomics
    float* xchg = reinterpret_cast<float*>(q_s);
    consumers_sync();  // every item consumed: the stages are free
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < H / 2; ++i) {
        xchg[i * 128 + tid] = dk_acc[i];
        xchg[(H / 2 + i) * 128 + tid] = dv_acc[i];
      }
    }
    consumers_sync();
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < H / 2; ++i) {
        dk_acc[i] += xchg[i * 128 + tid];
        dv_acc[i] += xchg[(H / 2 + i) * 128 + tid];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h ? c1 : c0;
        if (c < g.S) {
          const size_t off = (static_cast<size_t>(b) * g.S + c) * g.K * H + static_cast<size_t>(kh) * H + cq;
#pragma unroll
          for (int j = 0; j < H / 8; ++j) {
            *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
                __floats2bfloat162_rn(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
                __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ backward: dq
constexpr int DQ_BQ = 128;  // query rows of a block: two consumer warpgroups of 64
constexpr int DQ_BKV = 64;  // kv rows of a tile: S, dP and dS of 64 columns fit beside the dq sums
constexpr int DQ_THREADS = 384;  // warpgroups 0-1 consume, warp 8 of warpgroup 2 produces

// H 64 and 128: a 4-stage ring. H 192: Q 48 + dO 48 + 4 x (K 24 + V 24) =
// 288 KB is over the limit; 2 stages take 192 KB.
template <int H>
struct DqSmem {
  static constexpr int STAGES = H == 192 ? 2 : 4;
  static constexpr int TILE_Q = DQ_BQ * H * 2, TILE_KV = DQ_BKV * H * 2;  // bytes, multiples of 1024
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + TILE_Q;
  static constexpr size_t k = dout + TILE_Q;
  static constexpr size_t v = k + STAGES * TILE_KV;
  static constexpr size_t seg = v + STAGES * TILE_KV;  // kv segment ids of each stage
  static constexpr size_t bar = seg + STAGES * DQ_BKV * 4;  // q_full, full[STAGES], empty[STAGES]
  static constexpr size_t bytes = bar + (1 + 2 * STAGES) * 8 + 1024;  // + alignment slack
  static_assert(bytes <= SMEM_LIMIT, "dq's tiles fit in shared memory");
};

template <int H>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             const int* __restrict__ seg, __nv_bfloat16* __restrict__ dq, Geometry g) {
  using L = DqSmem<H>;
  constexpr int DQ_STAGES = L::STAGES;
  constexpr int PANELS = H / PANEL;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* q_s = smem + L::q;
  uint8_t* do_s = smem + L::dout;
  uint8_t* k_s = smem + L::k;
  uint8_t* v_s = smem + L::v;
  int* seg_s = reinterpret_cast<int*>(smem + L::seg);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + DQ_STAGES;

  // the last query tile first: under the causal mask it walks the most kv tiles
  const int n = blockIdx.x, b = blockIdx.y, q0 = (gridDim.z - 1 - blockIdx.z) * DQ_BQ;
  const int kh = n / (g.N / g.K);
  int j_lo = 0, j_hi = (g.S + DQ_BKV - 1) / DQ_BKV;
  if (g.causal) {
    j_hi = min(j_hi, (min(q0 + DQ_BQ, g.T) - 1) / DQ_BKV + 1);
    if (g.window >= 0) j_lo = max(0, q0 - g.window + 1) / DQ_BKV;
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes; lane 0 also expects the TMA bytes
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {  // ---- producer warpgroup: gives its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 8) return;
    // warp 8: Q and dO once, then K, V and kv segment ids through the ring
    if (lane == 0) {
      mbar_arrive_tx(q_full, 2 * L::TILE_Q);
#pragma unroll
      for (int p = 0; p < PANELS; ++p) {
        tma_load(q_s + p * DQ_BQ * 128, &tm_q, q_full, p * PANEL, n, q0, b);
        tma_load(do_s + p * DQ_BQ * 128, &tm_do, q_full, p * PANEL, n, q0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int jt = j_lo; jt < j_hi; ++jt) {
      mbar_wait(&empty[stage], phase ^ 1);
      const int k0 = jt * DQ_BKV;
      if (seg != nullptr) {
        int* sk = seg_s + stage * DQ_BKV;
        for (int i = lane; i < DQ_BKV; i += 32) sk[i] = k0 + i < g.S ? seg[static_cast<size_t>(b) * g.T + k0 + i] : -1;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[stage], 2 * L::TILE_KV);
#pragma unroll
        for (int p = 0; p < PANELS; ++p) {
          tma_load(k_s + stage * L::TILE_KV + p * DQ_BKV * 128, &tm_k, &full[stage], p * PANEL, kh, k0, b);
          tma_load(v_s + stage * L::TILE_KV + p * DQ_BKV * 128, &tm_v, &full[stage], p * PANEL, kh, k0, b);
        }
      } else {
        mbar_arrive(&full[stage]);
      }
      if (++stage == DQ_STAGES) stage = 0, phase ^= 1;
    }
  } else {  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp / 4;
    const int r = 16 * (warp % 4) + lane / 4;  // this thread's rows r and r + 8 of the 64
    const int row0 = q0 + wg * 64 + r, row1 = row0 + 8;
    const int wr0 = q0 + wg * 64, wr1 = wr0 + 63;
    const int cq = 2 * (lane % 4);  // this thread's first column in each group of 8
    // each row's segment id, lse * log2(e) and delta, kept with it; rows past
    // T read none (their Q and dO are zero-filled, their p masked, their dq
    // never stored)
    int sq0 = -2, sq1 = -2;
    float l2_0 = 0.f, l2_1 = 0.f, dl0 = 0.f, dl1 = 0.f;
    const size_t rows = (static_cast<size_t>(b) * g.N + n) * g.T;
    if (row0 < g.T) {
      l2_0 = lse[rows + row0] * LOG2E;
      dl0 = delta[rows + row0];
      if (seg != nullptr) sq0 = seg[static_cast<size_t>(b) * g.T + row0];
    }
    if (row1 < g.T) {
      l2_1 = lse[rows + row1] * LOG2E;
      dl1 = delta[rows + row1];
      if (seg != nullptr) sq1 = seg[static_cast<size_t>(b) * g.T + row1];
    }
    const float sl2 = g.scale * LOG2E;
    float acc[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) acc[i] = 0.f;
    const uint8_t* q_wg = q_s + wg * 64 * 128;
    const uint8_t* do_wg = do_s + wg * 64 * 128;
    mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int jt = j_lo; jt < j_hi; ++jt) {
      const int k0 = jt * DQ_BKV;
      mbar_wait(&full[stage], phase);
      const uint8_t* k_t = k_s + stage * L::TILE_KV;
      const uint8_t* v_t = v_s + stage * L::TILE_KV;

      // S = Q K^T and dP = dO V^T, 64 x 64 each: rows r / r + 8, columns 8 j + cq + {0, 1}
      float s[DQ_BKV / 2], dp[DQ_BKV / 2];
      const int u = 2 * (jt - j_lo) + wg;  // turns alternate over the 2 (j_hi - j_lo) steps
      if (u > 0) turn_wait(wg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = (kk % 4) * 32;  // 16 columns = 32 bytes into a panel
        wgmma_ss<DQ_BKV>(s, desc(q_wg + (kk / 4) * DQ_BQ * 128 + off, 16),
                         desc(k_t + (kk / 4) * DQ_BKV * 128 + off, 16), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_ss<DQ_BKV>(dp, desc(do_wg + (kk / 4) * DQ_BQ * 128 + off, 16),
                         desc(v_t + (kk / 4) * DQ_BKV * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
      if (u + 1 < 2 * (j_hi - j_lo)) turn_pass(wg);
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP - delta) scale, into dp
      const bool all_vis = seg == nullptr && all_visible(g, wr0, wr1, k0, k0 + DQ_BKV - 1);
      const int* sk = seg_s + stage * DQ_BKV;
#pragma unroll
      for (int j = 0; j < DQ_BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e, col = k0 + c;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            float p = exp2f(fmaf(s[i], sl2, -(h ? l2_1 : l2_0)));
            if (!all_vis) {
              const bool vis = visible(g, h ? row1 : row0, col) && (seg == nullptr || sk[c] == (h ? sq1 : sq0));
              if (!vis) p = 0.f;
            }
            dp[i] = p * (dp[i] - (h ? dl1 : dl0)) * g.scale;
          }
        }
      // dq += dS K: dS is the A operand from registers in two bf16 parts
      // (high, residual), as P and dS^T in dk/dv; K [kv, H] is the B operand
      // MN-major, 16 kv rows = 2048 bytes
      uint32_t d_hi[DQ_BKV / 16][4], d_lo[DQ_BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1], d_hi[kk][i], d_lo[kk][i]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BKV / 16; ++kk) {
        wgmma_rs<H>(acc, d_hi[kk], desc(k_t + kk * 16 * 128, DQ_BKV * 128));
        wgmma_rs<H>(acc, d_lo[kk], desc(k_t + kk * 16 * 128, DQ_BKV * 128));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[stage]);
      if (++stage == DQ_STAGES) stage = 0, phase ^= 1;
    }

    // one bf16 store of each row this block owns: no atomics
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
      if (row < g.T) {
        __nv_bfloat16* op = dq + (static_cast<size_t>(b) * g.T + row) * g.N * H + static_cast<size_t>(n) * H + cq;
#pragma unroll
        for (int j = 0; j < H / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: taken from the libcuda that the
// CUDA runtime has already loaded, so the build links nothing beyond it
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// [B, rows, heads, H] bf16 as a 4-D map (innermost first), 64-column boxes of
// `box_rows` rows of one head and batch, 128-byte swizzle; reads past `rows`
// are zero-filled
bool make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int H, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(H) * 2, static_cast<cuuint64_t>(heads) * H * 2,
                                 static_cast<cuuint64_t>(rows) * heads * H * 2};
  const cuuint32_t box[4] = {PANEL, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

template <int H>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse, int B,
                       const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_fwd_kernel_sm90<H>;
  cudaError_t err = opt_in(kernel, FwdSmem<H>::bytes, done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, g.T, g.N, H, FWD_BQ) || !make_map(&tk, k, B, g.S, g.K, H, FwdSmem<H>::BKV) ||
      !make_map(&tv, v, B, g.S, g.K, H, FwdSmem<H>::BKV))
    return cudaErrorInvalidValue;
  dim3 grid(g.N, B, (g.T + FWD_BQ - 1) / FWD_BQ);
  kernel<<<grid, FWD_THREADS, FwdSmem<H>::bytes, s>>>(tq, tk, tv, static_cast<const int*>(seg),
                                                      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, const void* seg, void* dk, void* dv, int B, const Geometry& g,
                       cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dkv_kernel_sm90<H>;
  cudaError_t err = opt_in(kernel, DkvSmem<H>::bytes, done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, g.T, g.N, H, DKV_BQ) || !make_map(&tk, k, B, g.S, g.K, H, DKV_BKV) ||
      !make_map(&tv, v, B, g.S, g.K, H, DKV_BKV) || !make_map(&tdo, dout, B, g.T, g.N, H, DKV_BQ))
    return cudaErrorInvalidValue;
  dim3 grid(g.K, B, (g.S + DKV_BKV - 1) / DKV_BKV);
  kernel<<<grid, DKV_THREADS, DkvSmem<H>::bytes, s>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(seg), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), g);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, const void* seg, void* dq, int B, const Geometry& g, cudaStream_t s) {
  static std::atomic<bool> done[MAX_DEVICES];
  auto kernel = flash_bwd_dq_kernel_sm90<H>;
  cudaError_t err = opt_in(kernel, DqSmem<H>::bytes, done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, B, g.T, g.N, H, DQ_BQ) || !make_map(&tk, k, B, g.S, g.K, H, DQ_BKV) ||
      !make_map(&tv, v, B, g.S, g.K, H, DQ_BKV) || !make_map(&tdo, dout, B, g.T, g.N, H, DQ_BQ))
    return cudaErrorInvalidValue;
  dim3 grid(g.N, B, (g.T + DQ_BQ - 1) / DQ_BQ);
  kernel<<<grid, DQ_THREADS, DqSmem<H>::bytes, s>>>(tq, tk, tv, tdo, static_cast<const float*>(lse),
                                                    static_cast<const float*>(delta), static_cast<const int*>(seg),
                                                    static_cast<__nv_bfloat16*>(dq), g);
  return cudaGetLastError();
}

bool bad_geometry(int B, int T, int S, int N, int K, int H, int dtype) {
  return B < 0 || T < 0 || S < 0 || K < 1 || N % K != 0 || (H != 64 && H != 128 && H != 192) || dtype != 1 ||
         B > 65535 ||
         N > 65535 || T > 65535 * FWD_BQ || S > 65535 * DKV_BKV;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported dtype, head_dim or geometry, a
// pointer that is not 16-byte aligned, or a tensor map libcuda refuses).
// The arguments are those of flash_attention_sm90_f32.cu's entries (dq and
// dk/dv without its workspace and split); dtype must be 1
// (bf16); window < 0: none; seg may be null.
extern "C" int pdnlp_flash_fwd_sm90(const void* q, const void* k, const void* v, const void* seg, void* out,
                                    void* lse, int B, int T, int S, int N, int K, int H, int causal, int window,
                                    int dtype, float scale, void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch_fwd<64>(q, k, v, seg, out, lse, B, g, s);
  if (H == 128) return launch_fwd<128>(q, k, v, seg, out, lse, B, g, s);
  return launch_fwd<192>(q, k, v, seg, out, lse, B, g, s);
}

extern "C" int pdnlp_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                                       const void* lse, const void* delta, const void* seg, void* dq, int B, int T,
                                       int S, int N, int K, int H, int causal, int window, int dtype, float scale,
                                       void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || T == 0 || N == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, B, g, s);
  if (H == 128) return launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, B, g, s);
  return launch_dq<192>(q, k, v, dout, lse, delta, seg, dq, B, g, s);
}

extern "C" int pdnlp_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, const void* seg, void* dk, void* dv,
                                        int B, int T, int S, int N, int K, int H, int causal, int window, int dtype,
                                        float scale, void* stream) {
  if (bad_geometry(B, T, S, N, K, H, dtype)) return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || K == 0) return cudaSuccess;
  const Geometry g{T, S, N, K, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64) return launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, B, g, s);
  if (H == 128) return launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, B, g, s);
  return launch_dkv<192>(q, k, v, dout, lse, delta, seg, dk, dv, B, g, s);
}
