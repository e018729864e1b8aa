// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels,
// and the mainloop of its three mixed-input GEMMs.
//
// The helpers (swizzled shared-memory layout, wgmma descriptors and
// products, cp.async, mbarriers, the exact int8 and e4m3 -> bf16
// converters) are the extend kernel's (paged_extend_attention.cu), which
// includes this header, as the decode kernel (paged_decode_attention.cu)
// does for cp.async and the converters.
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
//   - W4A8's prefill (w4a8_matmul.cu, an Op whose Acc is int32_t) runs the
//     same mainloop on the s8 tensor cores: x is int8, so a block is 128
//     deep (one 128-byte row, as a bf16 block is); the codes become an s8
//     B tile of c - z and wgmma.m64n128k32.s32.s8.s8 sums them exactly in
//     i32, folded into f32 with the group's scale (the same four 32-byte
//     steps a block). W4A8's decode kernel is its own (weights as wgmma's
//     register A operand), on this header's helpers and splitk_sum.
//   - Groups that end inside a 32-byte step (kSplit ops: a group of at
//     least one step that is no multiple of it, GPT-OSS's 120 and 100): a
//     step that holds a group edge is issued twice, on two B slices the
//     consumers convert: the main tile's slice holds the codes before the
//     edge (with the first group's zero point, the others 0), a second
//     tile's the codes from it (with the next group's). The first group is
//     folded between the two issues; the second issue starts the next
//     group's sum. Nothing changes in the layout and no byte is added: at
//     g 120 one 16-deep step in 15 is issued twice, three 32-deep ones in 15.
// SPTPU_GEMM_CUT=1 builds a timing cut: every block is loaded and
// converted, no product is taken and nothing is written.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
template <int N>
__device__ __forceinline__ void keep(int32_t (&r)[N]) {
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
// lo + hi of a bf16x2 word, in f32
__device__ __forceinline__ float bf16x2_sum(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return f.x + f.y;
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
// the same for four e4m3 codes: through f16, where every e4m3 value is exact
__device__ __forceinline__ void codes_to_bf16(uint32_t word, __nv_fp8_e4m3, uint32_t& lo, uint32_t& hi) {
  const __half2_raw h0 = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word & 0xFFFFu), __NV_E4M3);
  const __half2_raw h1 = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(h0));
  const float2 b = __half22float2(__half2(h1));
  lo = pack_bf16(a.x, a.y);
  hi = pack_bf16(b.x, b.y);
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


// D[64 x 128] (s32) (+)= A[64 x 32] B[32 x 128], s8, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss_s8_n128(int32_t (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// D[64 x 8] (s32) (+)= A[64 x 32] B[32 x 8], s8: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_s8_n8(int32_t (&d)[4], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// D[64 x 16] (s32) (+)= A[64 x 32] B[32 x 16], s8: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_s8_n16(int32_t (&d)[8], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// D[64 x 32] (s32) (+)= A[64 x 32] B[32 x 32], s8: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_s8_n32(int32_t (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// D[64 x 64] (s32) (+)= A[64 x 32] B[32 x 64], s8: A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_s8_n64(int32_t (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
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

// An Op whose groups may end inside a 32-byte step (kSplit: W4 and W4A8 at
// groups that are no multiple of a step, see the header's comment): a B
// stage holds two tiles, the second for the codes from the edge of each
// step that holds one.
template <class Op, class = void>
struct OpSplit {
  static constexpr bool value = false;
};
template <class Op>
struct OpSplit<Op, std::void_t<decltype(Op::kSplit)>> {
  static constexpr bool value = Op::kSplit;
};
template <class Op>
constexpr bool kOpSplit = OpSplit<Op>::value;

// Shared memory, byte offsets from a 1024-aligned base: the raw ring
// [kStages][x block BM x 128 B, then Op's raw bytes], the bf16 B ring
// [2][BN x 128 B, and a second such tile for kSplit], the mbarriers and the
// split-K flag. kStages: the deepest ring up to 10 that keeps one CTA of two
// consumer warpgroups, or two CTAs of one, on an SM.
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
  static constexpr int kWTile = T::BN * 128;
  static constexpr int kW = kWTile * (kOpSplit<Op> ? 2 : 1);
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
template <int NW, int TB, int NACC>
__device__ __forceinline__ void gemm_mma(int32_t (&d)[NACC], uint64_t da, uint64_t db, int accumulate) {
  static_assert(NW == 128 && TB == 0, "the s8 products: m64n128k32, both operands K-major");
  wgmma_ss_s8_n128(d, da, db, accumulate);
}

// An Op's accumulator: float (bf16 products) unless it names another
// (W4A8's int32_t: s8 x s8 products, 128-deep blocks of int8 x)
template <class Op, class = void>
struct OpAcc {
  using type = float;
};
template <class Op>
struct OpAcc<Op, std::void_t<typename Op::Acc>> {
  using type = typename Op::Acc;
};
template <class Op>
constexpr bool kOpS8 = std::is_same_v<typename OpAcc<Op>::type, int32_t>;

// An Op whose zero points may leave a rest (kRest: W4A16, see
// w4a16_matmul.cu): the warpgroups that fold a B tile scan its zeros over
// the CTA's K range (scan_rest) while block 0 loads, and OR what they found
// at a barrier before the first conversion; the mainloop is instantiated
// twice, and only a CTA whose tile has a rest runs the one that converts
// with the zeros clamped and sums x over each block (or 16-deep step) for
// the fold, which then adds the rest.
template <class Op, class = void>
struct OpRest {
  static constexpr bool value = false;
};
template <class Op>
struct OpRest<Op, std::void_t<decltype(Op::kRest)>> {
  static constexpr bool value = Op::kRest;
};
template <class Op>
constexpr bool kOpRest = OpRest<Op>::value;

// named barrier `id` over n threads that also returns the OR of v across them
__device__ __forceinline__ bool bar_or(int id, int n, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)v), "r"(id), "r"(n)
      : "memory");
  return r != 0;
}

// the zero point z of the W4 layout (bf16, as the JAX package holds it),
// rounded and clamped to [0, 16] (the zero itself for every group that
// spans 0), and what that left out: r = clamped - z in f32, exact (z is an
// integral bf16, the clamp an integer: no second rounding of the zero)
__device__ __forceinline__ float zero_clamped(__nv_bfloat16 z) {
  return fminf(fmaxf(rintf(__bfloat162float(z)), 0.f), 16.f);
}
__device__ __forceinline__ float zero_rest(__nv_bfloat16 z) {
  return zero_clamped(z) - __bfloat162float(z);
}

// bytes [0, n) of a word kept (n in 0..4), or its bf16 halves [0, n) (n in 0..2)
__device__ __forceinline__ uint32_t low_bytes(int n) {
  return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// Split K: this CTA's partial v [NACC] (thread tid of kConsumers) goes to
// the workspace, element-major so that a warp's stores are contiguous; the
// last CTA of the tile to arrive (a counter it then resets) loads every
// split's partial, kInFlight splits' loads at a time, and adds them in
// split order into v, so two calls give the same bits. Returns whether this
// CTA holds the sum. last: a shared int; named barrier 1 over the first
// kConsumers threads.
template <int NACC, int kConsumers, int kInFlight = 2>
__device__ __forceinline__ bool splitk_sum(float (&v)[NACC], const GemmArgs& a, int slot_tile,
                                           int split, int tid, int* last) {
  constexpr int E4 = NACC / 4;
  int* counters = reinterpret_cast<int*>(a.ws);
  float4* part = reinterpret_cast<float4*>(a.ws + kCounterSlots * 4);
  float4* base = part + (size_t)slot_tile * a.splits * E4 * kConsumers;
  float4* mine = base + (size_t)split * E4 * kConsumers;
#pragma unroll
  for (int e = 0; e < E4; ++e)
    __stcg(mine + e * kConsumers + tid, make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]));
  __threadfence();
  sync_first<kConsumers>();
  if (tid == 0) *last = atomicAdd(counters + slot_tile, 1) == a.splits - 1;
  sync_first<kConsumers>();
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int e = 0; e < E4; ++e) {
    const float4 f = __ldcg(base + e * kConsumers + tid);
    v[4 * e] = f.x, v[4 * e + 1] = f.y, v[4 * e + 2] = f.z, v[4 * e + 3] = f.w;
  }
  for (int i = 1; i < a.splits; i += kInFlight) {
    float4 f[kInFlight][E4];
#pragma unroll
    for (int h = 0; h < kInFlight; ++h)
#pragma unroll
      for (int e = 0; e < E4; ++e)
        f[h][e] = i + h < a.splits ? __ldcg(base + ((size_t)(i + h) * E4 + e) * kConsumers + tid)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int h = 0; h < kInFlight; ++h)
#pragma unroll
      for (int e = 0; e < E4; ++e)
        if (i + h < a.splits)
          v[4 * e] += f[h][e].x, v[4 * e + 1] += f[h][e].y, v[4 * e + 2] += f[h][e].z,
              v[4 * e + 3] += f[h][e].w;
  }
  if (tid == 0) counters[slot_tile] = 0;  // ready for the next launch
  return true;
}

// grid (n_tiles x splits, m_tiles, Op slots). Op (see w4a16_matmul.cu,
// delta_matmul.cu): kRawBytes, kTB; start (may end the CTA: uniform),
// issue (the block's copies beyond x), convert (raw codes -> bf16 B tile),
// b_desc, group_start / group_end (by block), fold, store; with kFold16
// also block_offset (the offset of a block's first k inside its group, g
// the group) and step_starts / step_ends (of the block's 32-byte step kk,
// 16 bf16 or 32 int8 deep, from that offset); kSplit ops split a step that
// holds a group edge (g - offset where offset + step > g). An Op with Acc
// int32_t takes int8 x and an s8 B tile (kOpS8).
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
        tma_load_2d(dst, &xmap, kb * (kOpS8<Op> ? 2 * kKB : kKB), m_base, landed(st));
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
  typename OpAcc<Op>::type acc[NACC];  // the products since the last fold
  float tot[NACC];                      // the running sum
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0, tot[i] = 0.f;

  // kOpRest: whether the zeros of the columns this warpgroup folds leave a
  // rest in the CTA's K range: this thread's share of the scan, ORed over
  // the B tile's warpgroups before the first conversion (the scan's loads
  // and block 0's copies are in flight together), so uniform
  bool rest = false;
  if constexpr (kOpRest<Op>) {
    if (n_kb > 0)
      rest = op.scan_rest(n_base + wn * NW, NW, kb0, n_kb, WM == 2 ? tid : (tid & 127), WM == 2 ? 256 : 128);
    rest = bar_or(WM == 2 ? 3 : 3 + wg, WM == 2 ? 256 : 128, rest);
  }
  auto sync_b = [&]() {  // the warpgroups of one B tile
    if constexpr (WM == 2) asm volatile("bar.sync 3, 256;\n" ::: "memory");
    else asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  };
  // kOpRest: rows row0 and row0 + 8's sums of x over the current group's
  // blocks (or steps) since its last fold, f32, summed from the x tile's
  // bf16 by the quad (lane q4 a quarter of the columns); of step kk, the
  // k in [lo, hi) of its 16 only (the two pieces of a split step)
  [[maybe_unused]] float xs[2] = {0.f, 0.f};
  auto add_x_sums = [&](const uint8_t* xt, int kk, int lo = 0, int hi = 16) {  // kk < 0: the whole block
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      float v = 0.f;
      if (kk < 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 c = *reinterpret_cast<const uint4*>(xt + swz(r, 2 * q4 + h));
          v += bf16x2_sum(c.x) + bf16x2_sum(c.y) + bf16x2_sum(c.z) + bf16x2_sum(c.w);
        }
      } else {
        uint2 c = *reinterpret_cast<const uint2*>(xt + swz(r, 2 * kk + (q4 >> 1)) + 8 * (q4 & 1));
        if (lo > 0 || hi < 16) {  // this lane's four k: 4 q4 .. 4 q4 + 3
          const int k0 = 4 * q4;
          const uint32_t keep0 = low_bytes(2 * (min(hi, k0 + 2) - k0)) & ~low_bytes(2 * (lo - k0));
          const uint32_t keep1 = low_bytes(2 * (min(hi, k0 + 4) - k0 - 2)) & ~low_bytes(2 * (lo - k0 - 2));
          c.x &= keep0, c.y &= keep1;
        }
        v = bf16x2_sum(c.x) + bf16x2_sum(c.y);
      }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      xs[i] += v;
    }
  };

  // The mainloop, instantiated for a tile with a zero rest (kR: kOpRest ops
  // only) and without one, so that a tile without a rest runs no rest code.
  // The consumers convert: a warpgroup converts the B columns it reads, [wn
  // NW, wn NW + NW); where two warpgroups read one B tile (WM 2), each
  // converts half of it and the two meet at a named barrier. Block t + 1 is
  // converted while block t's products run, into the other B stage.
  // Every wgmma is issued whatever the branch (a wgmma under a branch the
  // compiler cannot prove uniform is serialized); only the folds branch,
  // and a split step's second issue, whose condition (the k step and the
  // group) is the same in every thread.
  auto mainloop = [&](auto rest_tag) {
    constexpr bool kR = decltype(rest_tag)::value;
    auto convert = [&](int t) {
      mbar_wait(landed(t % S::kStages), (t / S::kStages) & 1);
      uint8_t* raw_t = sm + (t % S::kStages) * S::kRaw + S::kX;
      uint8_t* w_t = sm + S::kWRing + (t & 1) * S::kW;
      const int n_lo = wn * NW + (WM == 2 ? wm * (NW / 2) : 0);
      int r0 = 0;  // kSplit: the offset of the block's first k inside its group
      if constexpr (kOpSplit<Op>) r0 = op.block_offset(kb0 + t);
      if constexpr (kOpRest<Op>) op.template convert<NW / WM, kR>(raw_t, w_t, n_lo, tid & 127, r0);
      else if constexpr (kOpS8<Op>) op.template convert<NW / WM>(raw_t, w_t, n_lo, tid & 127, r0);
      else op.template convert<NW / WM>(raw_t, w_t, n_lo, tid & 127);
      fence_async_shared();
    };
    // the fold of step kk (32-byte step j of K): piece 0 the whole step, 1
    // and 2 a split step's codes before and from its group edge
    auto fold = [&](const uint8_t* rawp, int kk, int j, int piece) {
      if constexpr (kOpS8<Op>)  // W4A8 also takes its rows and its warpgroup
        op.fold(acc, tot, rawp, kk, wn * NW + 2 * q4, j, m_base + wm * 64 + row0, wn, piece);
      else if constexpr (kOpRest<Op>)
        op.template fold<kR>(acc, tot, rawp, kk, wn * NW + 2 * q4, j, xs, piece);
      else
        op.fold(acc, tot, rawp, kk, wn * NW + 2 * q4);
    };
    if (n_kb > 0) convert(0);
    sync_b();
    for (int t = 0; t < n_kb; ++t) {
      const int st = t % S::kStages, kb = kb0 + t;
#if SPTPU_GEMM_CUT != 1
      const uint32_t xa = sb + st * S::kRaw + wm * 64 * 128;
      const uint32_t wb = sb + S::kWRing + (t & 1) * S::kW;
      const uint8_t* rawp = sm + st * S::kRaw + S::kX;
      [[maybe_unused]] const uint8_t* xt = sm + st * S::kRaw + wm * 64 * 128;
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
        if constexpr (kR) add_x_sums(xt, -1);
        if (t == n_kb - 1 || op.group_end(kb)) fold(rawp, kKB / 16 - 1, kb * (kKB / 16) + kKB / 16 - 1, 0);
      } else {  // groups end inside blocks: fold after the 32-byte step that ends one
        // rr: the offset of step kk's first k inside its group (0..g-1),
        // carried from step to step, so that the step rules need no
        // division. A split step's second issue stands apart from the
        // fold's branch (nested in it, the split instantiations spilled
        // about 1.5 KB a thread).
        constexpr int kStepK = kOpS8<Op> ? 32 : 16;  // k of a 32-byte step
        int rr = op.block_offset(kb);
#pragma unroll
        for (int kk = 0; kk < kKB / 16; ++kk) {
          const int j = kb * (kKB / 16) + kk;
          wgmma_fence();
          gemm_mma<NW, Op::kTB>(acc, desc(xa + kk * 32, 16, 1024), op.b_desc(wb, wn * NW, kk),
                                !((t == 0 && kk == 0) || op.step_starts(kk, rr)));
          wgmma_commit();
          if (kk == 0 && t + 1 < n_kb) convert(t + 1);
          wgmma_wait<0>();
          keep(acc);
          int cut = 0;  // the offset of a group edge inside the step
          if constexpr (kOpSplit<Op>) cut = rr + kStepK > op.g ? op.g - rr : 0;
          const bool end = (t == n_kb - 1 && kk == kKB / 16 - 1) || op.step_ends(kk, rr);
          if constexpr (kR) add_x_sums(xt, kk, 0, cut ? cut : 16);
          if (cut || end) fold(rawp, kk, j, cut ? 1 : 0);
          if constexpr (kOpSplit<Op>) {
            if (cut) {  // the codes from the edge: the next group's sum starts
              wgmma_fence();
              gemm_mma<NW, Op::kTB>(acc, desc(xa + kk * 32, 16, 1024), op.b_desc(wb + S::kWTile, wn * NW, kk),
                                    0);
              wgmma_commit();
              wgmma_wait<0>();
              keep(acc);
              if constexpr (kR) add_x_sums(xt, kk, cut, 16);
              if (end) fold(rawp, kk, j, 2);
            }
          }
          rr += kStepK;
          if (rr >= op.g) rr -= op.g;
        }
      }
#else
      if (t + 1 < n_kb) convert(t + 1);
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_raw(st));  // this warp is done with block t's stage
      sync_b();  // block t + 1 converted, block t's B read: the stages swap
    }
  };
  if constexpr (kOpRest<Op>) {
    if (rest) mainloop(std::true_type{});
    else mainloop(std::false_type{});
  } else {
    mainloop(std::false_type{});
  }
#if SPTPU_GEMM_CUT != 1

  auto finish = [&](float (&v)[NACC]) {
    if (a.splits > 1) {
      const int slot_tile = (blockIdx.z * gridDim.y + blockIdx.y) * a.n_tiles + n_tile;
      if (!splitk_sum<NACC, kConsumers>(v, a, slot_tile, split, tid, reinterpret_cast<int*>(sm + S::kFlag)))
        return;
    }
    op.store(v, m_base + wm * 64 + row0, n_base + wn * NW + 2 * q4, a.M);
  };
  finish(tot);
#endif
}

// a 2D tensor map: `dims` {inner, outer} elements of `type` with the outer
// dimension's stride `stride` bytes, boxes of `box` elements, swizzled
// `swizzle`; what lies outside `dims` loads as zeros
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                                 const cuuint64_t (&dims)[2], cuuint64_t stride,
                                 const cuuint32_t (&box)[2], CUtensorMapSwizzle swizzle) {
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
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the tensor map of x [M, K] (row stride ld_x) in boxes of one 128-byte row
// (64 bf16, or 128 int8 where s8) x box_rows rows, 128-byte swizzled as
// wgmma reads A; rows past M and columns past K load as zeros
inline cudaError_t x_tensor_map(CUtensorMap* map, const GemmArgs& a, int box_rows, bool s8 = false) {
  const int bytes = s8 ? 1 : 2;
  return tensor_map_2d(map, s8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x,
                       {(cuuint64_t)a.K, (cuuint64_t)a.M}, (cuuint64_t)a.ld_x * bytes,
                       {(cuuint32_t)(128 / bytes), (cuuint32_t)box_rows}, CU_TENSOR_MAP_SWIZZLE_128B);
}

// launch one instantiation; returns the launch's cudaError_t
template <class Op, int NC, int WM, int NW, bool kFold16>
cudaError_t run_gemm(const Op& op, const GemmArgs& a, int m_tiles, int slots, cudaStream_t st) {
  using T = GemmTile<NC, WM, NW>;
  constexpr size_t bytes = GemmSmem<T, Op>::kDynamic;
  CUtensorMap xmap;
  cudaError_t err = x_tensor_map(&xmap, a, T::BM, kOpS8<Op>);
  if (err != cudaSuccess) return err;
  auto kernel = sm90_gemm_kernel<Op, NC, WM, NW, kFold16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_tiles * a.splits, m_tiles, slots), T::kThreads, bytes, st>>>(op, a, xmap);
  return cudaGetLastError();
}

}  // namespace
