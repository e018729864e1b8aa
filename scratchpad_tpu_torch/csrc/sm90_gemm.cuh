// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels,
// and the mainloop of its two mixed-input GEMMs.
//
// The helpers (swizzled shared-memory layout, wgmma descriptors and
// products, cp.async, mbarriers, the exact int8 -> bf16 converter) are the
// extend kernel's (paged_extend_attention.cu), which includes this header.
//
// The GEMM mainloop (sm90_gemm_kernel) serves w4a16_matmul.cu (4-bit codes
// with a zero point and a scale per group) and delta_matmul.cu (int8 delta
// codes with a scale per column). Each multiplies bf16 activations x [M, K]
// by integer codes that are exact in bf16, on the bf16 tensor cores:
//   - A CTA owns a tile of BM tokens x BN outputs and a range of K in
//     64-deep blocks (all of K, or one split of it). Tiles (GemmTile):
//     BM 128 x BN 128 for prefill, BM 64 x BN 256 or 64 x 64 for decode.
//   - One producer warpgroup fills a ring of up to ten stages: thread 0
//     loads the x block with TMA as 128-byte-swizzled rows, wgmma's K-major
//     A operand as they land; every thread copies its share of the block's
//     raw codes (with their scales and zeros) with 16-byte cp.async. Each
//     stage completes an mbarrier (the TMA's bytes, and
//     cp.async.mbarrier.arrive).
//   - One or two consumer warpgroups. Each converts the codes of the B
//     columns it reads, exactly, into a bf16 tile of a second ring of two
//     stages, in the layout wgmma reads as B: K-major for W4's [N, K/2]
//     rows, MN-major (transposed) for the delta's [In, Out] panel; then
//     fence.proxy.async and a named barrier. It converts block t + 1 while
//     its wgmma.m64nNk16.f32.bf16.bf16 of block t (both operands in shared
//     memory, N 128 or 64) runs. (Converting in the producer warpgroup,
//     beside the copies, left the loads and conversion alone slower than
//     the whole kernel is now.)
//   - Each block's f32 products fold into a running f32 sum (Op::fold): at
//     the end of each W4 group, times the group's scale, and after each
//     64-deep delta block (summed in one accumulator over K 8192, the delta
//     failed the gate in one check of eight mixed slots). No scale touches a
//     code before the product; the delta's column scale comes in the
//     epilogue. A consumer waits for its own products at the end of each
//     block. In the 64 x 256 tile the two warpgroups read different B
//     columns and run
//     apart, so one folds while the other's products run; in the 128 x 128
//     tile they share the B tile and meet at its barrier every block, so a
//     fold (once a group) holds both for its 32 to 64 multiply-adds a
//     thread; a one-warpgroup tile (64 x 64) leaves the overlap to the CTAs
//     beside it.
//   - Split K: the CTAs of one output tile write their f32 partials to a
//     workspace; the last to arrive (a counter it then resets) adds them in
//     split order, so two calls give the same bits, and writes the tile.
//     The wrapper computes the plan (tile configuration, splits) and keeps
//     the workspace (ops/quant/w4_matmul.py::gemm_plan); the C entry builds
//     x's tensor map at each call.
// SPTPU_GEMM_CUT=1 builds a timing cut: every block is loaded and
// converted, no product is taken and nothing is written.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SPTPU_GEMM_CUT
#define SPTPU_GEMM_CUT 0
#endif

namespace {

// byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled block
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // ok false: the 16 bytes are zero-filled and nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrives once this thread's cp.async copies so far have landed
__device__ __forceinline__ void mbar_arrive_copies(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();  // a lost arrival fails the launch instead of hanging it
  }
}
// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers an asynchronous wgmma reads or writes until after its wait
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major and B K-major (TB 0) or
// MN-major (TB 1) in shared memory
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB)
      : "memory");
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1)
      : "memory");
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                              uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));  // lo in the low half
}

// four 8-bit codes (one word, code k in byte k) as two bf16x2 words, exactly.
// int8: byte u = x + 128 under the exponent of 2^23 is the float 2^23 + u,
// so one subtraction gives x, whose bf16 is the float's high half.
__device__ __forceinline__ void codes_to_bf16(uint32_t word, int8_t, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.f);
  lo = __byte_perm(f[0], f[1], 0x7632);
  hi = __byte_perm(f[2], f[3], 0x7632);
}
// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A K-major and B K-major (TB 0) or
// MN-major (TB 1) in shared memory
template <int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB)
      : "memory");
}


__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool ok) {
  // ok false: the 8 bytes are zero-filled and nothing is read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the 2D box of `map` at (c0 inner, c1) into shared dst, completing
// its bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// named barrier 1 over the first N threads of the CTA
template <int N>
__device__ __forceinline__ void sync_first() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ the GEMM mainloop

constexpr int kKB = 64;               // k of one block: one 128-byte swizzled bf16 row
constexpr int kCopiers = 128;         // the producer warpgroup's threads
constexpr int kGemmProducerRegs = 56;   // setmaxnreg split of 168 x 384: 128 x 56 + 256 x 224
constexpr int kGemmConsumerRegs = 224;
constexpr int kCounterSlots = 4096;  // split-K counters (i32) at the head of the workspace

// NC consumer warpgroups, WM of them along M (64 rows each), each covering
// NW output columns
template <int NC_, int WM_, int NW_>
struct GemmTile {
  static constexpr int NC = NC_, WM = WM_, WN = NC_ / WM_, NW = NW_;
  static constexpr int BM = 64 * WM, BN = NW * WN;
  static constexpr int kConsumers = 128 * NC, kThreads = kConsumers + 128;
  static constexpr int NACC = NW / 2;  // f32 accumulators a thread holds for m64 x NW
};

// Shared memory, byte offsets from a 1024-aligned base: the raw ring
// [kStages][x block BM x 128 B, then Op's raw bytes], the bf16 B ring
// [2][BN x 128 B], the mbarriers and the split-K flag. kStages: the deepest
// ring up to 10 that keeps one CTA of two consumer warpgroups, or two CTAs
// of one, on an SM.
constexpr int gemm_smem_bytes(int stages, int raw, int w) {  // with room to align the base
  return stages * raw + 2 * w + 8 * 2 * stages + 16 + 1024;
}
// the deepest raw ring, up to 10 stages, that fits the limit
constexpr int gemm_stages(int raw, int w, int limit) {
  int stages = 10;
  while (stages > 3 && gemm_smem_bytes(stages, raw, w) > limit) --stages;
  return stages;
}
template <class T, class Op>
struct GemmSmem {
  static constexpr int kX = T::BM * 128;
  static constexpr int kRaw = (kX + Op::kRawBytes + 1023) / 1024 * 1024;
  static constexpr int kW = T::BN * 128;
  static constexpr int kLimit = T::NC == 2 ? 232448 : 115712;
  static constexpr int kStages = gemm_stages(kRaw, kW, kLimit);
  static constexpr int kWRing = kStages * kRaw;
  static constexpr int kBars = kWRing + 2 * kW;  // u64 empty[kStages], landed[kStages]
  static constexpr int kFlag = kBars + 8 * 2 * kStages;
  static constexpr size_t kDynamic = gemm_smem_bytes(kStages, kRaw, kW);
};

struct GemmArgs {  // x: read through a tensor map (x_tensor_map)
  const __nv_bfloat16* x;
  int ld_x, M, K;
  int n_tiles, k_blocks, splits;
  uint8_t* ws;  // i32 counters [kCounterSlots], zero between launches, then f32 partials
};

template <int NW, int TB, int NACC>
__device__ __forceinline__ void gemm_mma(float (&d)[NACC], uint64_t da, uint64_t db, int accumulate) {
  if constexpr (NW == 128) wgmma_ss_n128<TB>(d, da, db, accumulate);
  else wgmma_ss_n64<TB>(d, da, db, accumulate);
}

// grid (n_tiles x splits, m_tiles, Op slots). Op (see w4a16_matmul.cu,
// delta_matmul.cu): kRawBytes, kTB; start (may end the CTA: uniform),
// issue (the block's copies beyond x), convert (raw codes -> bf16 B tile),
// b_desc, group_start / group_end (by block), fold, store; with kFold16
// also step_starts / step_ends (by 16-deep step).
template <class Op, int NC, int WM, int NW, bool kFold16>
__global__ void __launch_bounds__(GemmTile<NC, WM, NW>::kThreads, NC == 2 ? 1 : 2)
sm90_gemm_kernel(const Op op_in, const GemmArgs a, const __grid_constant__ CUtensorMap xmap) {
  using T = GemmTile<NC, WM, NW>;
  using S = GemmSmem<T, Op>;
  static_assert(Op::kBN == T::BN, "the op's tile width");
  constexpr int BM = T::BM, NACC = T::NACC, kConsumers = T::kConsumers;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* sm = smem_raw + pad;  // 1024-aligned, generic address
  const uint32_t sb = raw + pad;  // the same, shared-window address

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % a.n_tiles, split = blockIdx.x / a.n_tiles;
  const int m_base = blockIdx.y * BM, n_base = n_tile * T::BN;
  Op op = op_in;
  if (!op.start(blockIdx.z, m_base, a.M, BM, tid, T::kThreads)) return;
  const int kb0 = (int)((long long)split * a.k_blocks / a.splits);
  const int n_kb = (int)((long long)(split + 1) * a.k_blocks / a.splits) - kb0;

  const uint32_t bars = sb + S::kBars;
  auto empty_raw = [&](int i) { return bars + 8 * i; };
  auto landed = [&](int i) { return bars + 8 * (S::kStages + i); };
  if (tid == 0) {
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(empty_raw(i), 4 * NC);  // one arrival a consumer warp
      // one a producer thread as its copies land, and the x load's
      mbar_init(landed(i), kCopiers + 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup copies block t into raw stage t % kStages once
    // the consumers released the block that held it: thread 0 the x block
    // with TMA, every thread its share of the codes with cp.async, arriving
    // on landed[stage] as they complete (cp.async.mbarrier.arrive).
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGemmProducerRegs));
    const int p = tid - kConsumers;
    for (int t = 0; t < n_kb; ++t) {
      const int st = t % S::kStages;
      mbar_wait(empty_raw(st), ((t / S::kStages) & 1) ^ 1);
      const int kb = kb0 + t;
      const uint32_t dst = sb + st * S::kRaw;
      if (p == 0) {
        mbar_expect_tx(landed(st), BM * 128);
        tma_load_2d(dst, &xmap, kb * kKB, m_base, landed(st));
      }
      op.issue(dst + S::kX, kb, n_base, p);
      mbar_arrive_copies(landed(st));
    }
    cp_async_wait_all();
    return;
  }

  if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGemmConsumerRegs));
  // this thread's accumulators: d[4c + 2i + e] is row row0 + 8i, column
  // 8c + 2q4 + e of its warpgroup's 64 x NW
  const int wg = tid >> 7, wm = wg / T::WN, wn = wg % T::WN;
  const int lane = tid & 31, q4 = lane & 3;
  const int row0 = 16 * ((tid & 127) >> 5) + (lane >> 2);
  float acc[NACC], tot[NACC];  // the products since the last fold; the running sum
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = tot[i] = 0.f;

  // The consumers convert: a warpgroup converts the B columns it reads, [wn
  // NW, wn NW + NW); where two warpgroups read one B tile (WM 2), each
  // converts half of it and the two meet at a named barrier. Block t + 1 is
  // converted while block t's products run, into the other B stage.
  auto convert = [&](int t) {
    mbar_wait(landed(t % S::kStages), (t / S::kStages) & 1);
    op.template convert<NW / WM>(sm + (t % S::kStages) * S::kRaw + S::kX,
                                 sm + S::kWRing + (t & 1) * S::kW,
                                 wn * NW + (WM == 2 ? wm * (NW / 2) : 0), tid & 127);
    fence_async_shared();
  };
  auto sync_b = [&]() {  // the warpgroups of one B tile
    if constexpr (WM == 2) asm volatile("bar.sync 3, 256;\n" ::: "memory");
    else asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  };
  if (n_kb > 0) convert(0);
  sync_b();

  // Every wgmma is issued whatever the branch (a wgmma under a branch the
  // compiler cannot prove uniform is serialized); only the folds branch.
  for (int t = 0; t < n_kb; ++t) {
    const int st = t % S::kStages, kb = kb0 + t;
#if SPTPU_GEMM_CUT != 1
    const uint32_t xa = sb + st * S::kRaw + wm * 64 * 128;
    const uint32_t wb = sb + S::kWRing + (t & 1) * S::kW;
    const uint8_t* rawp = sm + st * S::kRaw + S::kX;
    if constexpr (!kFold16) {  // a group is whole blocks: fold after a block
      const int first = t == 0 || op.group_start(kb);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk)
        gemm_mma<NW, Op::kTB>(acc, desc(xa + kk * 32, 16, 1024), op.b_desc(wb, wn * NW, kk),
                              kk > 0 || !first);
      wgmma_commit();
      if (t + 1 < n_kb) convert(t + 1);
      wgmma_wait<0>();
      keep(acc);
      if (t == n_kb - 1 || op.group_end(kb)) op.fold(acc, tot, rawp, kKB / 16 - 1, wn * NW + 2 * q4);
    } else {  // groups end inside blocks: fold after a 16-deep step
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
        const int j = kb * (kKB / 16) + kk;
        wgmma_fence();
        gemm_mma<NW, Op::kTB>(acc, desc(xa + kk * 32, 16, 1024), op.b_desc(wb, wn * NW, kk),
                              !((t == 0 && kk == 0) || op.step_starts(j)));
        wgmma_commit();
        if (kk == 0 && t + 1 < n_kb) convert(t + 1);
        wgmma_wait<0>();
        keep(acc);
        if ((t == n_kb - 1 && kk == kKB / 16 - 1) || op.step_ends(j))
          op.fold(acc, tot, rawp, kk, wn * NW + 2 * q4);
      }
    }
#else
    if (t + 1 < n_kb) convert(t + 1);
#endif
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_raw(st));  // this warp is done with block t's stage
    sync_b();  // block t + 1 converted, block t's B read: the stages swap
  }
#if SPTPU_GEMM_CUT != 1

  auto finish = [&](float (&v)[NACC]) {
    if (a.splits > 1) {
      // this split's partial, element-major so that a warp's stores are
      // contiguous; the last CTA of the tile sums all of them in split order
      constexpr int E4 = NACC / 4;
      int* counters = reinterpret_cast<int*>(a.ws);
      float4* part = reinterpret_cast<float4*>(a.ws + kCounterSlots * 4);
      const int slot_tile = (blockIdx.z * gridDim.y + blockIdx.y) * a.n_tiles + n_tile;
      float4* base = part + (size_t)slot_tile * a.splits * E4 * kConsumers;
      float4* mine = base + (size_t)split * E4 * kConsumers;
#pragma unroll
      for (int e = 0; e < E4; ++e)
        __stcg(mine + e * kConsumers + tid, make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]));
      __threadfence();
      sync_first<kConsumers>();
      int* last = reinterpret_cast<int*>(sm + S::kFlag);
      if (tid == 0) *last = atomicAdd(counters + slot_tile, 1) == a.splits - 1;
      sync_first<kConsumers>();
      if (!*last) return;
      __threadfence();
#pragma unroll
      for (int e = 0; e < E4; ++e) {
        const float4 f = __ldcg(base + e * kConsumers + tid);
        v[4 * e] = f.x, v[4 * e + 1] = f.y, v[4 * e + 2] = f.z, v[4 * e + 3] = f.w;
      }
      for (int i = 1; i < a.splits; i += 2) {  // two splits' loads in flight
        float4 f[2][E4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < E4; ++e)
            f[h][e] = i + h < a.splits ? __ldcg(base + ((size_t)(i + h) * E4 + e) * kConsumers + tid)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < E4; ++e)
            if (i + h < a.splits)
              v[4 * e] += f[h][e].x, v[4 * e + 1] += f[h][e].y, v[4 * e + 2] += f[h][e].z,
                  v[4 * e + 3] += f[h][e].w;
      }
      if (tid == 0) counters[slot_tile] = 0;  // ready for the next launch
    }
    op.store(v, m_base + wm * 64 + row0, n_base + wn * NW + 2 * q4, a.M);
  };
  finish(tot);
#endif
}

// the tensor map of x [M, K] (row stride ld_x) in boxes of 64 columns x
// box_rows rows, 128-byte swizzled as wgmma reads A; rows past M and
// columns past K load as zeros
inline cudaError_t x_tensor_map(CUtensorMap* map, const GemmArgs& a, int box_rows) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;  // looked up at run time: no link to libcuda
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)a.K, (cuuint64_t)a.M};
  const cuuint64_t strides[1] = {(cuuint64_t)a.ld_x * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kKB, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(a.x),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// launch one instantiation; returns the launch's cudaError_t
template <class Op, int NC, int WM, int NW, bool kFold16>
cudaError_t run_gemm(const Op& op, const GemmArgs& a, int m_tiles, int slots, cudaStream_t st) {
  using T = GemmTile<NC, WM, NW>;
  constexpr size_t bytes = GemmSmem<T, Op>::kDynamic;
  CUtensorMap xmap;
  cudaError_t err = x_tensor_map(&xmap, a, T::BM);
  if (err != cudaSuccess) return err;
  auto kernel = sm90_gemm_kernel<Op, NC, WM, NW, kFold16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_tiles * a.splits, m_tiles, slots), T::kThreads, bytes, st>>>(op, a, xmap);
  return cudaGetLastError();
}

}  // namespace
