// W4A8 GEMM for Hopper (sm_90a): per-token int8 activations times 4-bit
// group-quantized weights on the s8 tensor cores (wgmma), and the row
// quantizer that feeds it.
//
// Replaces three pieces of scratchpad_tpu/ops/quant/pallas_w4.py:
//   _w4a8_kernel_q4 (:363)  W4A8 over 4-bit-native storage, g % 32 == 0:
//                           w4a8_matmul below
//   _w4a8_kernel    (:139)  W4A8 over u8 half planes, any g dividing In/2:
//                           w4a8_matmul below for every group of 32 or more
//                           (GPT-OSS's 120 and 100: split steps, below),
//                           w4a8_matmul_mma for the smaller ones
//   the activation quantization of _w4_q4_call (:452-461), done outside the
//   Pallas kernel by XLA: w4_quantize_rows below
//
// What it computes, with x8/ax from w4_quantize_rows and the port's packed
// layout (scratchpad_tpu_torch/ops/quant/w4_matmul.py: q [N, Kp/2], s and z
// [G, N], c = nibble - 8 the signed code, z the zero point in bf16 as the
// JAX package holds it):
//   y[m, n] = bf16( ax[m] * sum_g s[g, n] * (D_g[m, n] + gsum[m, g] * r[g, n]) ),
//   D_g = sum_{k in g} x8[m, k] * (nibble[k, n] - zc[g, n])   (exact in i32)
// with zc = z clamped to [0, 16] (rounded) and r = zc - z in f32. c - (z -
// 8) = nibble - z, so this is the JAX package's x8 . c + gsum * (-(z - 8) s)
// group by group (z - 8 in f32, as its to_4bit takes it). The quantizers and checkpoint
// imports of the port give integral zero points, in [0, 16] wherever a
// group's weights span 0 (AWQ and GPTQ v2 0..15, GPTQ v1 1..16,
// quantize_stacked 0..15): there r = 0, nibble - zc lies in [-16, 15], an
// exact s8 the tensor cores take, and |D| <= 127 * 16 * k over k codes. So
// the zero is folded into the code and gsum is read
// only for a group whose zero r does not vanish (quantize_stacked gives a
// group of one sign a zero outside [0, 15], a constant one of -5e7), at the
// fold that ends the group: once a group, at its last step. The steps past
// K that fill a block (zeros, by the TMA's and cp.async's fill) end no
// group, and add no rest. The i32 sum is folded into f32, times the
// group's scale, at each group's end, and at a split's end; where g % 128
// == 0 or g > 2,048 (kSpanFree) also every 128 k, elsewhere a group's sum
// stays below 2^22 (fold points: after k step j where 32 (j + 1) % g == 0,
// or (j + 1) % 4 == 0 on those groups), converted exactly (|D| < 2^22: the
// float 1.5 * 2^23 + D, one subtraction, no I2F): tot = fma(f32(D) [+ gsum
// * r], s, tot); the
// splits' f32 sums are added in split order, times ax, and rounded to bf16
// once.
//
// What bounds it: at decode (M <= 64) bytes, the 4-bit weights (In*Out/2 B)
// read once; at prefill (M in the thousands) the int8 operations, 2*M*In*Out
// at 1,979 TOPS. The design:
//   - Prefill (M > 64): sm90_gemm.cuh's mainloop with W4A8Op, CTA tile 128
//     tokens x 128 outputs. x8 by TMA (128-byte rows of 128 int8, 128-byte
//     swizzle), the packed codes and the block's s and z rows by cp.async
//     into a ring; the two consumer warpgroups (64 tokens each) convert half
//     of the codes each into one s8 B tile [128][128 B] of c - z (a 4-byte
//     word of packed codes -> two s8x4 words: mask, shift, one xor with 0x88
//     gives nibble + 128, minus the zero byte, byte_perm into k order, xor
//     0x80) while their wgmma.m64n128k32.s32.s8.s8 of the previous block
//     runs. The conversion (integer instructions, at half the rate of the
//     float ones) and the fold (at g 128 once a block: 64 values, an
//     integer add, a float add and a multiply-add each) bound it, not the
//     products: a B tile shared by 128 tokens halves the conversion a
//     product against a 64 x 256 tile of two warpgroups with their own B
//     columns, which ran gate_up at M 8192 in 1.65 against 1.40 ms on one
//     H100 (PERF.md).
//   - Decode (M <= 64): swap-AB, w4a8_decode_kernel. The converted codes
//     are wgmma's register A operand (64 output columns a warpgroup, K
//     major), x8 the B operand in shared memory (N = the token tile, M
//     rounded up to 8, 16, 32 or 64, or two tiles of 32), so no B tile is
//     written. One producer thread loads each 64-deep block by TMA: x8
//     (64-byte swizzle), the codes [64][32 B] (32-byte swizzle: a thread's
//     four 32-bit reads of a block hit distinct banks), and the two s and
//     z rows of its k steps. K is split across CTAs so that the launch
//     fills the card; the last CTA of a tile adds the partials in split
//     order (sm90_gemm.cuh's splitk_sum).
//   - A group of 32 or more that is no multiple of 32 (GPT-OSS's 120 and
//     100) cuts 32-deep steps: at g 120 three in 15, at g 100 seven in 25.
//     Such a step is issued twice (split), each issue with one group's
//     codes and the other's zeroed, the first group folded between the two:
//     at prefill on two s8 B slices (sm90_gemm.cuh's kSplit), at decode on
//     two register A fragments, the mask an AND on the converted codes. The
//     s and z rows of a block then also name the group at its end.
//     Groups below 32 (a step would hold two edges) run the mma.sync kernel
//     (w4a8_matmul_mma), routed there by the wrapper's plan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_gemm.cuh"

namespace {

// ---------------------------------------------------------------- quantizer
//
// x8 = clip(rint(x / ax), -127, 127) with ax = amax / 127 (1 for a row of
// zeros), IEEE division and round half to even, as torch.round and
// jnp.round; x8 is written with a row stride Kp (zeros past K), gsum[m, g]
// as the exact integer sum of each group. Each row is read once: a team of T
// threads (whole warps) holds it in registers, V vectors of VW bf16 a thread
// (VW 16: two 16-byte loads and one 16-byte store of x8; VW 2 where In % 8
// or g < 16), reduces amax with warp shuffles (and one shared word a warp),
// quantizes from the registers, and sums each group: where a group is a
// power-of-two run of whole lanes (g 128 over 16-element vectors: 8 lanes),
// with shuffles, its first lane storing it; otherwise each vector's codes
// go to the groups it touches (a group ends inside a vector at most once),
// the lanes of a warp that share a group adding theirs with one redux and
// its first lane adding that to the group's shared counter, one store a
// group. Small M: one row a CTA of at most kQuantThreads, a vector or two a
// thread; large M: four vectors a thread and several rows a CTA.

constexpr int kQuantThreads = 256;
constexpr int kQuantSmallRows = 256;  // up to this M: one row a CTA

// lanes with equal key >= 0 add v into group_sum[key], one atomic a group
__device__ __forceinline__ void warp_group_add(int* group_sum, int key, int v, int lane) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int sum = __reduce_add_sync(peers, v);
  if (key >= 0 && lane == __ffs(peers) - 1) atomicAdd(group_sum + key, sum);
}

// the T threads of team `team` (a CTA of one team, one warp, or one of a few)
__device__ __forceinline__ void team_sync(int team, int T) {
  if (T == (int)blockDim.x) __syncthreads();
  else if (T == 32) __syncwarp();
  else asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(T) : "memory");
}

// one output element: bf16, or f32 where y_f32 (a tensor-parallel rank's
// row-parallel partial product, which the group sums in f32 before its one
// rounding to bf16)
__device__ __forceinline__ void put_y(void* y, int y_f32, size_t i, float v) {
  if (y_f32)
    static_cast<float*>(y)[i] = v;
  else
    static_cast<__nv_bfloat16*>(y)[i] = __float2bfloat16(v);
}

template <int VW, int V>
__global__ void __launch_bounds__(1024)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, int ld_x, int Kp, int g,
                     int T, int8_t* __restrict__ x8, float* __restrict__ ax_out,
                     float* __restrict__ gsum, const float* __restrict__ amax_in) {
  extern __shared__ int quant_smem[];  // per team: [G] group sums, [T / 32] warp maxima
  const int G = K / g;
  const int team = threadIdx.x / T, t = threadIdx.x - team * T, lane = threadIdx.x & 31;
  const int m = blockIdx.x * (blockDim.x / T) + team;
  const bool row = m < M;
  int* group_sum = quant_smem + team * (G + T / 32);
  float* warp_max = reinterpret_cast<float*>(group_sum + G);
  // lanes a group, where a group is a power-of-two run of whole lanes
  const int run = g % VW == 0 && g / VW <= 32 && !((g / VW) & (g / VW - 1)) ? g / VW : 0;
  if (!run)
    for (int i = t; i < G; i += T) group_sum[i] = 0;

  const __nv_bfloat16* xr = x + (size_t)(row ? m : 0) * ld_x;
  uint32_t raw[V][VW / 2];  // the row's bf16 pairs, zeros past K
  float amax = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int k0 = (v * T + t) * VW;
    if constexpr (VW == 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // K % 8 == 0: a half is all in or all out
        const uint4 w = row && k0 + 8 * h < K ? *reinterpret_cast<const uint4*>(xr + k0 + 8 * h)
                                              : make_uint4(0u, 0u, 0u, 0u);
        raw[v][4 * h] = w.x, raw[v][4 * h + 1] = w.y, raw[v][4 * h + 2] = w.z, raw[v][4 * h + 3] = w.w;
      }
    } else {
      raw[v][0] = row && k0 < K ? *reinterpret_cast<const uint32_t*>(xr + k0) : 0u;
    }
#pragma unroll
    for (int i = 0; i < VW / 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[v][i]));
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  // a given row maximum (the whole row's, where x is a slice of it) skips
  // the team's reduction; the barrier still orders the zeroed group sums
  if (amax_in == nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) warp_max[t >> 5] = amax;
  }
  team_sync(team, T);  // the warp maxima, and the zeroed group sums
  if (amax_in != nullptr) amax = row ? amax_in[m] : 0.f;
  else
    for (int w = 0; w < T / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float ax = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);

#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int k0 = (v * T + t) * VW;
    int qv[VW];
#pragma unroll
    for (int i = 0; i < VW / 2; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[v][i]));
      qv[2 * i] = (int)fminf(fmaxf(rintf(__fdiv_rn(f.x, ax)), -127.f), 127.f);
      qv[2 * i + 1] = (int)fminf(fmaxf(rintf(__fdiv_rn(f.y, ax)), -127.f), 127.f);
    }
    if (row && k0 < Kp) {
      if constexpr (VW == 16) {
        uint32_t b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          b[i] = (qv[4 * i] & 0xFF) | (qv[4 * i + 1] & 0xFF) << 8 | (qv[4 * i + 2] & 0xFF) << 16 |
                 (uint32_t)(qv[4 * i + 3] & 0xFF) << 24;
        *reinterpret_cast<uint4*>(x8 + (size_t)m * Kp + k0) = make_uint4(b[0], b[1], b[2], b[3]);
      } else {
        *reinterpret_cast<uint16_t*>(x8 + (size_t)m * Kp + k0) =
            (uint16_t)((qv[0] & 0xFF) | (qv[1] & 0xFF) << 8);
      }
    }
    if (run) {
      int sum = 0;
#pragma unroll
      for (int e = 0; e < VW; ++e) sum += qv[e];  // zeros past K
      for (int off = 1; off < run; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (row && k0 < K && t % run == 0) gsum[(size_t)m * G + k0 / g] = (float)sum;
      continue;
    }
    // the part in the group of the vector's first element, and the rest
    // (the next group's) where a group ends inside the vector
    const int glo = k0 / g, edge = min((glo + 1) * g, K);
    int lo = 0, hi = 0;
    bool has_hi = false;
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      const int k = k0 + e;
      if (k < edge) lo += qv[e];
      else if (k < K) hi += qv[e], has_hi = true;
    }
    warp_group_add(group_sum, row && k0 < K ? glo : -1, lo, lane);
    if (__any_sync(0xffffffffu, row && has_hi)) warp_group_add(group_sum, row && has_hi ? glo + 1 : -1, hi, lane);
  }
  if (row && t == 0) ax_out[m] = ax;
  if (run) return;
  team_sync(team, T);
  if (row)
    for (int i = t; i < G; i += T) gsum[(size_t)m * G + i] = (float)group_sum[i];
}

template <int VW, int V>
cudaError_t launch_quantize(dim3 grid, int threads, size_t smem, cudaStream_t st,
                            const __nv_bfloat16* x, int M, int K, int ld_x, int Kp, int g, int T,
                            int8_t* x8, float* ax, float* gsum, const float* amax) {
  auto kernel = quantize_rows_kernel<VW, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, st>>>(x, M, K, ld_x, Kp, g, T, x8, ax, gsum, amax);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- codes -> s8

// One word of packed codes (byte j: code 2j in the low nibble, 2j + 1 in
// the high one, each nibble ^ 8) and the column's zero point zero (0..16)
// in every byte of zb -> its eight codes c - z = nibble - zero as s8, k
// order: codes 0..3 in `first`, 4..7 in `second`. nibble + 128 minus zero
// lies in [112, 143], so the subtraction borrows across no byte; xor 0x80
// takes 128 off each byte.
__device__ __forceinline__ void w4_word_to_s8(uint32_t w, uint32_t zb, uint32_t& first, uint32_t& second) {
  const uint32_t lo = ((w & 0x0F0F0F0Fu) ^ 0x88888888u) - zb;         // codes 0, 2, 4, 6
  const uint32_t hi = (((w >> 4) & 0x0F0F0F0Fu) ^ 0x88888888u) - zb;  // codes 1, 3, 5, 7
  first = __byte_perm(lo, hi, 0x5140) ^ 0x80808080u;
  second = __byte_perm(lo, hi, 0x7362) ^ 0x80808080u;
}

// zero_clamped and zero_rest (sm90_gemm.cuh): the zero point clamped into
// the code range, and the rest it leaves
// the clamped zero point in every byte
__device__ __forceinline__ uint32_t zero_bytes(__nv_bfloat16 z) {
  return (uint32_t)zero_clamped(z) * 0x01010101u;
}

// an i32 sum below 2^22 in magnitude as f32, exactly: the float 1.5 * 2^23
// + v, less 1.5 * 2^23
__device__ __forceinline__ float i2f(int32_t v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}
// the widest group whose i32 sum stays below 2^22 (|x8 (c - z)| <= 127 x
// 16 a k: 127 x 16 x 2048 = 4,161,536): a group-end fold alone keeps such a
// group exact, so the kFold16 paths fold every 128 k only for wider ones
constexpr int kSpanFree = 2048;

// ---------------------------------------------------------------- prefill

// The W4A8 op of sm90_gemm_kernel (M > 64). Raw stage: the codes [BN][64 B]
// (128 codes of a column; 16-byte chunk kk of row r at chunk kk ^ ((r >> 1)
// & 3), so that eight rows' chunk kk fill the banks once), then s and z
// [SR][BN] bf16 each: the rows of the
// groups of the block's four 32-deep steps (SR 4), with the group at the
// block's end where a group edge may fall inside a step (SR 5, kSplit), or
// the one group of the block (SR 1: g % 128 == 0, a fold a block); then a
// flag a converting warp (two warpgroups of four), set where one of its
// columns' zeros leaves a rest r (the fold then reads gsum; the 128 x 128
// tile's warpgroups each convert half of the columns both fold, so a fold
// reads all eight).
template <int BN, int SR, bool SPLIT = false>
struct W4A8Op {
  using Acc = int32_t;
  static constexpr bool kSplit = SPLIT;  // a group edge may fall inside a 32-deep step
  static_assert(!SPLIT || SR == 5, "a split step reads the next step's group");
  static constexpr int kBN = BN;
  static constexpr int kTB = 0;  // B K-major: a column's 128 codes in one swizzled row
  static constexpr int kCodes = BN * 64;
  static constexpr int kRow = BN * 2;  // one row of s or z
  static constexpr int kFlags = kCodes + 2 * SR * kRow;
  static constexpr int kRawBytes = kFlags + 8 * 4;
  const uint8_t* q;
  const __nv_bfloat16* s;
  const __nv_bfloat16* z;
  const float* ax;
  const float* gsum;
  void* y;  // bf16, or f32 where y_f32
  int M, N, N_st, Kp, g, ld_sz, G, K, y_f32;

  __device__ bool start(int, int, int, int, int, int) const { return true; }
  __device__ void issue(uint32_t dst, int kb, int n_base, int p) const {
    const int row_bytes = Kp / 2;
    for (int i = p; i < BN * 4; i += kCopiers) {
      const int r = i >> 2, kk = i & 3, n = n_base + r, off = kb * 64 + kk * 16;
      const bool ok = n < N_st && off < row_bytes;
      cp_async16(dst + r * 64 + ((kk ^ ((r >> 1) & 3)) << 4), q + (ok ? (size_t)n * row_bytes + off : 0), ok);
    }
    for (int i = p; i < 2 * SR * (BN / 8); i += kCopiers) {  // s rows, then z rows
      const int row = i / (BN / 8), c = i % (BN / 8), n = n_base + c * 8;
      const int gi = min((kb * 128 + 32 * (row % SR)) / g, G - 1);
      const bool ok = n < N_st;
      const __nv_bfloat16* src = (row < SR ? s : z) + (ok ? (size_t)gi * ld_sz + n : 0);
      cp_async16(dst + kCodes + row * kRow + c * 16, src, ok);
    }
  }
  // codes of the NCOL columns from n_lo -> the s8 B tile [BN][128 B], row n
  // holding nibble - zc of k = 0..127 of block kb; thread q of the 128 that
  // share them takes one row's CPT 16-byte chunks (32 codes of a 32-deep
  // step each: all four for NCOL 128, two for 64), its zero points once,
  // loads first. kSplit: a step that holds a group edge keeps its codes
  // before the edge here (the others 0) and puts those from it, minus the
  // next group's zero, into the second tile (w + BN * 128; the others 0);
  // r0 is the offset of the block's first k inside its group.
  template <int NCOL>
  __device__ void convert(const uint8_t* raw, uint8_t* w, int n_lo, int q, int r0) const {
    constexpr int CPT = NCOL * 4 / 128;
    const __nv_bfloat16* zr = reinterpret_cast<const __nv_bfloat16*>(raw + kCodes + SR * kRow);
    const int row = n_lo + q % NCOL, k0 = q / NCOL * CPT;
    uint4 c16[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int kk = k0 + i;
      c16[i] = *reinterpret_cast<const uint4*>(raw + row * 64 + ((kk ^ ((row >> 1) & 3)) << 4));
    }
    bool rest = false;
    auto zero_of = [&](int r) {  // row r's zero point in every byte, and its rest flagged
      const __nv_bfloat16 zv = zr[r * BN + row];
      const float zc = zero_clamped(zv);
      rest |= zc != __bfloat162float(zv);
      return (uint32_t)zc * 0x01010101u;
    };
    uint32_t zb[SR < CPT ? SR : CPT];
#pragma unroll
    for (int i = 0; i < (SR < CPT ? SR : CPT); ++i) zb[i] = zero_of((k0 + i) % SR);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int kk = k0 + i;
      const uint32_t z8 = zb[SR < CPT ? i % SR : i];
      uint32_t o[8];
      w4_word_to_s8(c16[i].x, z8, o[0], o[1]);
      w4_word_to_s8(c16[i].y, z8, o[2], o[3]);
      w4_word_to_s8(c16[i].z, z8, o[4], o[5]);
      w4_word_to_s8(c16[i].w, z8, o[6], o[7]);
      if constexpr (kSplit) {
        int rr = r0 + 32 * kk;
        while (rr >= g) rr -= g;
        const int cut = rr + 32 > g ? g - rr : 0;
        if (cut) {
          const uint32_t z8h = zero_of(kk + 1);
          uint32_t oh[8];
          w4_word_to_s8(c16[i].x, z8h, oh[0], oh[1]);
          w4_word_to_s8(c16[i].y, z8h, oh[2], oh[3]);
          w4_word_to_s8(c16[i].z, z8h, oh[4], oh[5]);
          w4_word_to_s8(c16[i].w, z8h, oh[6], oh[7]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {  // codes 4e .. 4e + 3: the bytes before the edge
            const uint32_t m = low_bytes(cut - 4 * e);
            o[e] &= m, oh[e] &= ~m;
          }
          *reinterpret_cast<uint4*>(w + BN * 128 + swz(row, 2 * kk)) = make_uint4(oh[0], oh[1], oh[2], oh[3]);
          *reinterpret_cast<uint4*>(w + BN * 128 + swz(row, 2 * kk + 1)) = make_uint4(oh[4], oh[5], oh[6], oh[7]);
        }
      }
      *reinterpret_cast<uint4*>(w + swz(row, 2 * kk)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(w + swz(row, 2 * kk + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
    }
    rest = __any_sync(0xffffffffu, rest);
    if ((q & 31) == 0)
      reinterpret_cast<int*>(const_cast<uint8_t*>(raw) + kFlags)[n_lo / NCOL * 4 + (q >> 5)] = rest;
  }
  __device__ uint64_t b_desc(uint32_t wb, int n0, int kk) const {
    return desc(wb + n0 * 128 + kk * 32, 16, 1024);
  }
  // g % 128 == 0: a fold every block
  __device__ bool group_start(int) const { return true; }
  __device__ bool group_end(int) const { return true; }
  // otherwise after every 32-deep step that ends a group (or a 128-deep
  // span, for a group wider than kSpanFree)
  // the offset of block kb's first k inside its group; whether the block's
  // 32-deep step kk, whose first k lies at offset rr, starts or ends a
  // group, or a 128-deep span where a group's i32 sum could pass 2^22 (g >
  // kSpanFree) (g >= 32: at most one edge a step; w4_matmul.py's step_cut
  // is g - rr where rr + 32 > g)
  __device__ int block_offset(int kb) const { return kb * 128 % g; }
  __device__ bool step_starts(int kk, int rr) const { return rr == 0 || (g > kSpanFree && kk == 0); }
  __device__ bool step_ends(int kk, int rr) const { return rr + 32 == g || (g > kSpanFree && kk == 3); }
  // tot += f32(acc) * s of the group of step kk (32-deep step j of K),
  // column by column; at the end of a group whose converting warps flagged
  // a zero rest, (f32(acc) + gsum * r) * s, at a step inside K only (the
  // zero-filled steps of the last block would add the last group's rest
  // again). Rows m0 and m0 + 8, warpgroup wn. piece 1: the codes before a
  // split step's edge, whose group ends there; 2: those from it, whose
  // group is the next step's (row kk + 1) and goes on.
  template <int NACC>
  __device__ void fold(const int32_t (&acc)[NACC], float (&tot)[NACC], const uint8_t* raw, int kk,
                       int col, int j, int m0, int wn, int piece) const {
    const __nv_bfloat16* sr =
        reinterpret_cast<const __nv_bfloat16*>(raw + kCodes + (kk % SR + (piece == 2)) * kRow) + col;
    const int4 f0 = reinterpret_cast<const int4*>(raw + kFlags)[0];
    const int4 f1 = reinterpret_cast<const int4*>(raw + kFlags)[1];
    if ((f0.x | f0.y | f0.z | f0.w | f1.x | f1.y | f1.z | f1.w) &&
        (piece == 1 || (piece == 0 && 32 * (j + 1) % g == 0)) && 32 * j < K) {
      const __nv_bfloat16* zr = sr + SR * kRow / 2;
      const int gi = min(32 * j / g, G - 1);
      const float gs0 = m0 < M ? gsum[(size_t)m0 * G + gi] : 0.f;
      const float gs1 = m0 + 8 < M ? gsum[(size_t)(m0 + 8) * G + gi] : 0.f;
#pragma unroll
      for (int c = 0; c < NACC / 4; ++c) {
        const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + 8 * c));
        const float r0 = zero_rest(zr[8 * c]), r1 = zero_rest(zr[8 * c + 1]);
        tot[4 * c] += fmaf(gs0, r0, i2f(acc[4 * c])) * sv.x;
        tot[4 * c + 1] += fmaf(gs0, r1, i2f(acc[4 * c + 1])) * sv.y;
        tot[4 * c + 2] += fmaf(gs1, r0, i2f(acc[4 * c + 2])) * sv.x;
        tot[4 * c + 3] += fmaf(gs1, r1, i2f(acc[4 * c + 3])) * sv.y;
      }
      return;
    }
#pragma unroll
    for (int c = 0; c < NACC / 4; ++c) {
      const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + 8 * c));
      tot[4 * c] += i2f(acc[4 * c]) * sv.x;
      tot[4 * c + 1] += i2f(acc[4 * c + 1]) * sv.y;
      tot[4 * c + 2] += i2f(acc[4 * c + 2]) * sv.x;
      tot[4 * c + 3] += i2f(acc[4 * c + 3]) * sv.y;
    }
  }
  template <int NACC>
  __device__ void store(const float (&v)[NACC], int m0, int n0, int M) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * i;
      if (m >= M) continue;
      const float a = ax[m];
#pragma unroll
      for (int c = 0; c < NACC / 4; ++c) {
        const int n = n0 + 8 * c;
        if (n >= N) continue;
        const size_t i0 = (size_t)m * N + n;
        const float v0 = v[4 * c + 2 * i] * a, v1 = v[4 * c + 2 * i + 1] * a;
        if (n + 1 < N && !(N & 1) && !y_f32) {
          auto* p = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(y) + i0);
          *p = __floats2bfloat162_rn(v0, v1);
        } else {
          put_y(y, y_f32, i0, v0);
          if (n + 1 < N) put_y(y, y_f32, i0 + 1, v1);
        }
      }
    }
  }
};

// ---------------------------------------------------------------- decode

constexpr int kDecodeKB = 64;  // k of a decode block: two 32-deep steps
constexpr int kDecodeStages = 8;

// Shared memory of the decode kernel, byte offsets from a 1024-aligned
// base: kDecodeStages stages of [x8 NT x 64 B | codes BN x 32 B | s rows
// R x BN bf16 | z rows R x BN bf16], then the mbarriers and the split-K
// flag. R: the groups at the starts of the block's two 32-deep steps, and
// at its end where a group edge may fall inside a step (kSplit: 3).
template <int NT, bool kSplit>
struct DecodeSmem {
  static constexpr int BN = 64;
  static constexpr int R = kSplit ? 3 : 2;
  static constexpr int kX = NT * 64;
  static constexpr int kCodes = BN * 32;
  static constexpr int kRow = BN * 2;
  static constexpr int kBytes = kX + kCodes + 2 * R * kRow;  // what the TMA loads a stage
  static constexpr int kStage = (kBytes + 1023) / 1024 * 1024;
  static constexpr int kBars = kDecodeStages * kStage;  // u64 empty[stages], landed[stages]
  static constexpr int kFlag = kBars + 16 * kDecodeStages;
  static constexpr size_t kDynamic = kFlag + 16 + 1024;
};

struct DecodeArgs {
  const float* ax;
  const float* gsum;
  void* y;  // bf16, or f32 where y_f32
  int N, g, G, y_f32;
};

// wgmma descriptor of a K-major operand in 64-byte-swizzled rows of 64 B
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

template <int NT>
__device__ __forceinline__ void wgmma_rs_s8(int32_t (&d)[NT / 2], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {
  if constexpr (NT == 8) wgmma_rs_s8_n8(d, a, db, accumulate);
  else if constexpr (NT == 16) wgmma_rs_s8_n16(d, a, db, accumulate);
  else if constexpr (NT == 32) wgmma_rs_s8_n32(d, a, db, accumulate);
  else wgmma_rs_s8_n64(d, a, db, accumulate);
}

// grid (n_tiles x splits, m_tiles): a CTA owns 64 output columns, NT
// tokens and the 64-deep k blocks of its split. Threads: one consumer
// warpgroup, then one producer warp, of which one thread loads. SPAN: the
// 32-deep steps between folds, 4 where g % 128 == 0 (known at compile
// time); 1 for the other groups, folding after a step by the general rule.
// kSplit (SPAN 1, a group of 32 or more that is no multiple of 32): a step
// that holds a group edge is issued twice, on A fragments that keep the
// codes before the edge (with the first group's zero point) and from it
// (with the next group's), the rest of each ANDed to 0; the first group
// is folded between the two.
// The kernel is bound by its instructions a byte of codes (the fold alone
// is 3 a byte at 64 tokens), not by its loads or its products: it keeps
// them few, and registers few enough for three CTAs an SM, so it sums
// split K one split's partial at a time. (Two warpgroups sharing each x8
// tile over 128 columns ran the head no faster.)
template <int NT, int SPAN, bool kSplit>
__global__ void __launch_bounds__(160, 3)
w4a8_decode_kernel(const DecodeArgs d, const GemmArgs a, const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap smap,
                   const __grid_constant__ CUtensorMap zmap) {
  static_assert(!kSplit || SPAN == 1, "a split step folds inside a block");
  using S = DecodeSmem<NT, kSplit>;
  constexpr int kConsumers = 128, NACC = NT / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* sm = smem_raw + pad;
  const uint32_t sb = raw + pad;

  const int tid = threadIdx.x;
  const int n_tile = blockIdx.x % a.n_tiles, split = blockIdx.x / a.n_tiles;
  const int n_base = n_tile * S::BN, m_base = blockIdx.y * NT;
  const int kb0 = (int)((long long)split * a.k_blocks / a.splits);
  const int n_kb = (int)((long long)(split + 1) * a.k_blocks / a.splits) - kb0;
  const uint32_t bars = sb + S::kBars;
  auto empty = [&](int i) { return bars + 8 * i; };
  auto landed = [&](int i) { return bars + 8 * (kDecodeStages + i); };
  if (tid == 0) {
    for (int i = 0; i < kDecodeStages; ++i) {
      mbar_init(empty(i), 4);  // one arrival a consumer warp
      mbar_init(landed(i), 1);      // the producer's, with the TMA bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      for (int t = 0; t < n_kb; ++t) {
        const int st = t % kDecodeStages, kb = kb0 + t;
        mbar_wait(empty(st), ((t / kDecodeStages) & 1) ^ 1);
        const uint32_t dst = sb + st * S::kStage;
        mbar_expect_tx(landed(st), S::kBytes);
        tma_load_2d(dst, &xmap, kb * kDecodeKB, m_base, landed(st));
        tma_load_2d(dst + S::kX, &qmap, kb * (kDecodeKB / 2), n_base, landed(st));
#pragma unroll
        for (int i = 0; i < S::R; ++i) {
          const int gi = min((kb * kDecodeKB + 32 * i) / d.g, d.G - 1);
          tma_load_2d(dst + S::kX + S::kCodes + i * S::kRow, &smap, n_base, gi, landed(st));
          tma_load_2d(dst + S::kX + S::kCodes + (S::R + i) * S::kRow, &zmap, n_base, gi, landed(st));
        }
      }
    }
    return;
  }

  // this thread's A rows (output columns, local) r0 and r0 + 8; its
  // accumulators: acc[4c + 2i + e] is column r0 + 8i, token 8c + 2 q4 + e
  const int lane = tid & 31, q4 = lane & 3;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  int32_t acc[NACC];
  float tot[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0, tot[i] = 0.f;

  // block t's A fragments, steps 0 and 1: {a0, a1, a2, a3} = rows (r0, r0 +
  // 8) at k 4 q4 .. + 3, then at k 16 + 4 q4 .. + 3 of the step. Piece q4
  // (2 bytes: 4 codes) of the 8-byte chunks 2 kk and 2 kk + 1 of a row:
  // the chunks lie in 16-byte chunk kk, swizzled by the TMA's 32-byte mode.
  // Both steps of a block lie in one group where SPAN is 4: one zero point
  // a row then. kSplit: h holds the codes from a split step's edge (with
  // the next group's zero point), a those before it.
  struct Frags {
    uint32_t a[2][4];
    uint32_t h[kSplit ? 2 : 1][4];
  };
  const uint32_t half = (q4 & 1) ? 0x7632 : 0x5410;
  auto frags = [&](int t) {
    Frags f;
    const int st = t % kDecodeStages;
    mbar_wait(landed(st), (t / kDecodeStages) & 1);
    const uint8_t* codes = sm + st * S::kStage + S::kX;
    const __nv_bfloat16* zr = reinterpret_cast<const __nv_bfloat16*>(codes + S::kCodes + S::R * S::kRow);
    int cut[2] = {0, 0};  // the offset (1..31) of a group edge inside step kk, or 0
    if constexpr (kSplit) {
      int rr = (kb0 + t) * kDecodeKB % d.g;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        cut[kk] = rr + 32 > d.g ? d.g - rr : 0;
        rr += 32;
        if (rr >= d.g) rr -= d.g;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      uint32_t zb[S::R];
      zb[0] = zero_bytes(zr[r]);
#pragma unroll
      for (int m = 1; m < S::R; ++m) zb[m] = SPAN == 1 ? zero_bytes(zr[m * S::BN + r]) : zb[0];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint8_t* ck = codes + r * 32 + ((kk ^ ((r >> 2) & 1)) << 4) + 4 * (q4 >> 1);
        const uint32_t u = __byte_perm(*reinterpret_cast<const uint32_t*>(ck),
                                       *reinterpret_cast<const uint32_t*>(ck + 8), half);
        w4_word_to_s8(u, zb[kk], f.a[kk][i], f.a[kk][2 + i]);
        if constexpr (kSplit) {
          if (cut[kk]) {  // this thread's codes: 4 q4 .. + 3 and 16 + 4 q4 .. + 3 of the step
            w4_word_to_s8(u, zb[kk + 1], f.h[kk][i], f.h[kk][2 + i]);
            const uint32_t m0 = low_bytes(cut[kk] - 4 * q4), m1 = low_bytes(cut[kk] - 16 - 4 * q4);
            f.a[kk][i] &= m0, f.a[kk][2 + i] &= m1;
            f.h[kk][i] &= ~m0, f.h[kk][2 + i] &= ~m1;
          }
        }
      }
    }
    return f;
  };
  // tot += f32(acc) * s of the group of step kk (32-deep step j), for the
  // thread's two columns; where the step ends the group inside K and a
  // column's zero leaves a rest r, (f32(acc) + gsum * r) * s. piece 1: the
  // codes before a split step's edge, whose group ends there; 2: those from
  // it, whose group is the next step's (row kk + 1) and goes on.
  auto fold = [&](int st, int kk, int j, int piece) {
    const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(sm + st * S::kStage + S::kX + S::kCodes +
                                                                     (kk + (piece == 2)) * S::kRow);
    const __nv_bfloat16* zr = sr + S::R * S::BN;
    const float s0 = __bfloat162float(sr[r0]), s1 = __bfloat162float(sr[r0 + 8]);
    const float z0 = zero_rest(zr[r0]), z1 = zero_rest(zr[r0 + 8]);
    if ((z0 != 0.f || z1 != 0.f) && (piece == 1 || (piece == 0 && 32 * (j + 1) % d.g == 0)) && 32 * j < a.K) {
      const int gi = min(32 * j / d.g, d.G - 1);
#pragma unroll
      for (int c = 0; c < NACC / 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m_base + 8 * c + 2 * q4 + e;
          const float gs = m < a.M ? d.gsum[(size_t)m * d.G + gi] : 0.f;
          tot[4 * c + e] += fmaf(gs, z0, i2f(acc[4 * c + e])) * s0;
          tot[4 * c + 2 + e] += fmaf(gs, z1, i2f(acc[4 * c + 2 + e])) * s1;
        }
      return;
    }
#pragma unroll
    for (int c = 0; c < NACC / 4; ++c) {
      tot[4 * c] += i2f(acc[4 * c]) * s0;
      tot[4 * c + 1] += i2f(acc[4 * c + 1]) * s0;
      tot[4 * c + 2] += i2f(acc[4 * c + 2]) * s1;
      tot[4 * c + 3] += i2f(acc[4 * c + 3]) * s1;
    }
  };

#if SPTPU_GEMM_CUT == 1
  // the timing cut (sm90_gemm.cuh's): every block loaded and converted, no
  // product taken, nothing written
  uint32_t sink = 0;
  for (int t = 0; t < n_kb; ++t) {
    const Frags f = frags(t);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sink ^= f.a[kk][i];
        if constexpr (kSplit) sink ^= f.h[kk][i];
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(t % kDecodeStages));
  }
  if (sink == 0x12345678u) put_y(d.y, d.y_f32, 0, 0.f);  // keeps the conversion
  return;
#endif
  // Every wgmma is issued whatever the branch; only the folds branch, and
  // a split step's second issue, whose condition (the step and the group)
  // is the same in every thread. Block t + 1 converts while block t's
  // products run. SPAN 4: no fold inside a block, whose two steps are
  // issued back to back and waited for once; SPAN 1: a wait, and where the
  // rule says so a fold, after each step (the step rules from the offset
  // of the step inside its group, carried from step to step).
  Frags cur;
  if (n_kb > 0) cur = frags(0);
  for (int t = 0; t < n_kb; ++t) {
    const int st = t % kDecodeStages, kb = kb0 + t;
    const uint32_t xb = sb + st * S::kStage;
    Frags nxt;
    if constexpr (SPAN > 1) {
      const int j = 2 * kb + 1;  // the block's second 32-deep step
      wgmma_fence();
      wgmma_rs_s8<NT>(acc, cur.a[0], desc64(xb), !(t == 0 || (j - 1) % SPAN == 0));
      wgmma_rs_s8<NT>(acc, cur.a[1], desc64(xb + 32), 1);
      wgmma_commit();
      if (t + 1 < n_kb) nxt = frags(t + 1);
      wgmma_wait<0>();
      keep(acc);
      keep(cur.a[0]);
      keep(cur.a[1]);
      if (t == n_kb - 1 || (j + 1) % SPAN == 0) fold(st, 1, j, 0);
    } else {
      int rr = kb * kDecodeKB % d.g;  // the offset of step kk's first k inside its group
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int j = 2 * kb + kk;  // the 32-deep step
        const bool span = d.g > kSpanFree;  // a fold every 128 k
        const bool restart = (t == 0 && kk == 0) || rr == 0 || (span && j % 4 == 0);
        wgmma_fence();
        wgmma_rs_s8<NT>(acc, cur.a[kk], desc64(xb + kk * 32), !restart);
        wgmma_commit();
        if (kk == 0 && t + 1 < n_kb) nxt = frags(t + 1);
        wgmma_wait<0>();
        keep(acc);
        keep(cur.a[kk]);
        const int cut = kSplit && rr + 32 > d.g ? d.g - rr : 0;
        const bool end = (t == n_kb - 1 && kk == 1) || rr + 32 == d.g || (span && (j + 1) % 4 == 0);
        if (cut || end) fold(st, kk, j, cut ? 1 : 0);
        if constexpr (kSplit) {
          if (cut) {  // the codes from the edge: the next group's sum starts
            wgmma_fence();
            wgmma_rs_s8<NT>(acc, cur.h[kk], desc64(xb + kk * 32), 0);
            wgmma_commit();
            wgmma_wait<0>();
            keep(acc);
            keep(cur.h[kk]);
            if (end) fold(st, kk, j, 2);
          }
        }
        rr += 32;
        if (rr >= d.g) rr -= d.g;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));  // this warp is done with block t's stage
    cur = nxt;
  }

  if (a.splits > 1 &&
      !splitk_sum<NACC, kConsumers, 1>(tot, a, blockIdx.y * a.n_tiles + n_tile, split, tid,
                                       reinterpret_cast<int*>(sm + S::kFlag)))
    return;
#pragma unroll
  for (int c = 0; c < NACC / 4; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m_base + 8 * c + 2 * q4 + (e & 1), n = n_base + r0 + 8 * (e >> 1);
      if (m < a.M && n < d.N) put_y(d.y, d.y_f32, (size_t)m * d.N + n, tot[4 * c + e] * d.ax[m]);
    }
}

template <int NT, int SPAN, bool kSplit>
cudaError_t launch_decode(const DecodeArgs& d, const GemmArgs& a, const void* q, const void* s,
                          const void* z, int ld_sz, int Kp, cudaStream_t st) {
  using S = DecodeSmem<NT, kSplit>;
  CUtensorMap xmap, qmap, smap, zmap;
  cudaError_t err = tensor_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.x, {(cuuint64_t)a.K, (cuuint64_t)a.M},
                                  (cuuint64_t)a.ld_x, {(cuuint32_t)kDecodeKB, (cuuint32_t)NT},
                                  CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, {(cuuint64_t)(Kp / 2), (cuuint64_t)ld_sz},
                        (cuuint64_t)(Kp / 2), {(cuuint32_t)(kDecodeKB / 2), (cuuint32_t)S::BN},
                        CU_TENSOR_MAP_SWIZZLE_32B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&smap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, s, {(cuuint64_t)ld_sz, (cuuint64_t)d.G},
                        (cuuint64_t)ld_sz * 2, {(cuuint32_t)S::BN, 1u}, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = tensor_map_2d(&zmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, z, {(cuuint64_t)ld_sz, (cuuint64_t)d.G},
                        (cuuint64_t)ld_sz * 2, {(cuuint32_t)S::BN, 1u}, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto kernel = w4a8_decode_kernel<NT, SPAN, kSplit>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kDynamic);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.n_tiles * a.splits, (a.M + NT - 1) / NT), 160, S::kDynamic, st>>>(d, a, xmap, qmap, smap, zmap);
  return cudaGetLastError();
}

template <int SPAN, bool kSplit>
cudaError_t launch_decode_nt(int rows, const DecodeArgs& d, const GemmArgs& a, const void* q, const void* s,
                             const void* z, int ld_sz, int Kp, cudaStream_t st) {
  if (rows == 8) return launch_decode<8, SPAN, kSplit>(d, a, q, s, z, ld_sz, Kp, st);
  if (rows == 16) return launch_decode<16, SPAN, kSplit>(d, a, q, s, z, ld_sz, Kp, st);
  if (rows == 32) return launch_decode<32, SPAN, kSplit>(d, a, q, s, z, ld_sz, Kp, st);
  if (rows == 64) return launch_decode<64, SPAN, kSplit>(d, a, q, s, z, ld_sz, Kp, st);
  return cudaErrorInvalidValue;
}

// the prefill: 128 x 128 tiles, two warpgroups along M sharing the B tile
cudaError_t launch_prefill(const uint8_t* q, const __nv_bfloat16* s, const __nv_bfloat16* z, const float* ax,
                           const float* gsum, void* y, int y_f32, int M, int N, int K, int Kp, int g, int ld_sz,
                           const __nv_bfloat16* x8, uint8_t* ws, int splits, cudaStream_t st) {
  using T = GemmTile<2, 2, 128>;
  const GemmArgs a{x8, Kp, M, K, (N + T::BN - 1) / T::BN, (K + 127) / 128, splits, ws};
  const int m_tiles = (M + T::BM - 1) / T::BM;
  if (g % 128 == 0)
    return run_gemm<W4A8Op<T::BN, 1>, 2, 2, 128, false>(
        {q, s, z, ax, gsum, y, M, N, ld_sz, Kp, g, ld_sz, K / g, K, y_f32}, a, m_tiles, 1, st);
  // a group that cuts no step keeps SR 4 and one B tile, and at decode the
  // kernel without split steps: the split instantiations ran such groups
  // (64, 32) 1.05x to 1.33x slower on an H100 (tools/gemm_ab.py --groups)
  if (g % 32 == 0)
    return run_gemm<W4A8Op<T::BN, 4>, 2, 2, 128, true>(
        {q, s, z, ax, gsum, y, M, N, ld_sz, Kp, g, ld_sz, K / g, K, y_f32}, a, m_tiles, 1, st);
  return run_gemm<W4A8Op<T::BN, 5, true>, 2, 2, 128, true>(
      {q, s, z, ax, gsum, y, M, N, ld_sz, Kp, g, ld_sz, K / g, K, y_f32}, a, m_tiles, 1, st);
}

// ---------------------------------------------------------------- the mma.sync kernel
//
// The first W4A8 kernel, kept for the groups below 32, which a 32-deep
// step holds more than one edge of: the JAX
// package's group-factored form on mma.sync.m16n8k32 (s8 x s8 -> s32),
//   y[m, n] = ax[m] * ( sum_g s[g,n] * (sum_{k in g} x8[m,k] * c[k,n])_i32
//                     + sum_g gsum[m,g] * (-(z[g,n] - 8) * s[g,n]) ),
// each group's integer dot exact in an i32 accumulator (|x8 * c| <= 127 *
// 8), folded into f32 with its scale at the group's end, the zero
// correction summed apart and added before the ax scale. A 32-wide k step
// that crosses a group edge is split into pieces, each with the
// activations outside its group masked to zero. B fragments are unpacked
// from nibbles in registers, A fragments read straight from the int8 rows.
// M <= 64: a CTA owns a 16-column strip and all M rows, its 4 warps split
// the groups four ways and reduce through shared memory; M > 64: a CTA owns
// 64 x 64 outputs, its warps 16 columns each over the whole of In.

namespace mma_sync {

constexpr int kWarps = 4;
constexpr int kNT = 2;  // n8 tiles per warp: 16 output columns
constexpr int kKStep = 32;

// 4 codes (16 bits, code k in bits 4k..4k+3, 4-bit two's complement) -> 4
// sign-extended int8 in one register, code k in byte k.
__device__ __forceinline__ uint32_t unpack4(uint32_t v) {
  const uint32_t r = (v & 0xFu) | ((v & 0xF0u) << 4) | ((v & 0xF00u) << 8) | ((v & 0xF000u) << 12);
  return __vsub4(r ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// keep the bytes of v whose k-step columns c0 + i lie in [lo, hi)
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, int c0, int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (c0 + i >= lo && c0 + i < hi) m |= 0xFFu << (8 * i);
  return v & m;
}

template <int MT>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[kNT][2];
};

// Fragments of k-step k0. A (m16n8k32, row): reg 0/2 row gid, reg 1/3 row
// gid + 8; columns tig*4..+3 (reg 0/1) and 16 + tig*4..+3 (reg 2/3). B
// (col): column gid, k rows tig*4..+3 (reg 0) and 16 + tig*4..+3 (reg 1),
// that is two bytes of the packed column each.
template <int MT>
__device__ __forceinline__ void load_frags(Frags<MT>& f, const int8_t* __restrict__ x8,
                                           const uint8_t* __restrict__ q, int M, int N,
                                           int Kp, int m_base, int n_base, int gid, int tig,
                                           int k0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m_base + mt * 16 + gid, r1 = r0 + 8;
    const int8_t* p0 = x8 + (size_t)r0 * Kp + k0 + tig * 4;
    const int8_t* p1 = x8 + (size_t)r1 * Kp + k0 + tig * 4;
    f.a[mt][0] = r0 < M ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    f.a[mt][1] = r1 < M ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    f.a[mt][2] = r0 < M ? *reinterpret_cast<const uint32_t*>(p0 + 16) : 0u;
    f.a[mt][3] = r1 < M ? *reinterpret_cast<const uint32_t*>(p1 + 16) : 0u;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n_base + nt * 8 + gid;
    if (n < N) {
      const uint8_t* p = q + (size_t)n * (Kp / 2) + k0 / 2 + tig * 2;
      f.b[nt][0] = unpack4(*reinterpret_cast<const uint16_t*>(p));
      f.b[nt][1] = unpack4(*reinterpret_cast<const uint16_t*>(p + 8));
    } else {
      f.b[nt][0] = f.b[nt][1] = 0u;
    }
  }
}

// One CTA of 4 warps. SPLITK: the CTA owns columns [16*by, +16) and all M
// (<= 64) rows, warp w the groups [G*w/4, G*(w+1)/4). Otherwise the CTA owns
// rows [64*bx, +64) and columns [64*by, +64), warp w 16 of them over all
// groups.
template <int MT, bool SPLITK>
__global__ void __launch_bounds__(kWarps * 32)
w4a8_gemm_kernel(const int8_t* __restrict__ x8, const float* __restrict__ ax,
                 const float* __restrict__ gsum, const uint8_t* __restrict__ q,
                 const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ z,
                 void* __restrict__ y, int y_f32, int M, int N, int K, int Kp, int g,
                 int ld_sz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int G = K / g;
  const int m_base = blockIdx.x * MT * 16;
  const int n_base = SPLITK ? blockIdx.y * kNT * 8 : (blockIdx.y * kWarps + warp) * kNT * 8;
  const int kb = SPLITK ? (G * warp / kWarps) * g : 0;
  const int ke = SPLITK ? (G * (warp + 1) / kWarps) * g : K;

  int32_t ci[MT][kNT][4];
  float acc[MT][kNT][4], acz[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) ci[mt][nt][i] = 0, acc[mt][nt][i] = 0.f, acz[mt][nt][i] = 0.f;

  if (kb < ke) {
    int k0 = kb / kKStep * kKStep;
    Frags<MT> cur, nxt;
    load_frags<MT>(cur, x8, q, M, N, Kp, m_base, n_base, gid, tig, k0);
    for (; k0 < ke; k0 += kKStep) {
      const bool more = k0 + kKStep < ke;
      if (more) load_frags<MT>(nxt, x8, q, M, N, Kp, m_base, n_base, gid, tig, k0 + kKStep);
      const int kend = min(k0 + kKStep, ke);
      int k = max(k0, kb);
      while (k < kend) {  // the pieces of this k-step, one per group
        const int grp = k / g;
        const int gend = min((grp + 1) * g, kend);
        if (k == k0 && gend == k0 + kKStep) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) mma_s8(ci[mt][nt], cur.a[mt], cur.b[nt]);
        } else {
          const int lo = k - k0, hi = gend - k0;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t am[4];
            am[0] = keep_bytes(cur.a[mt][0], tig * 4, lo, hi);
            am[1] = keep_bytes(cur.a[mt][1], tig * 4, lo, hi);
            am[2] = keep_bytes(cur.a[mt][2], 16 + tig * 4, lo, hi);
            am[3] = keep_bytes(cur.a[mt][3], 16 + tig * 4, lo, hi);
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) mma_s8(ci[mt][nt], am, cur.b[nt]);
          }
        }
        if (gend == (grp + 1) * g) {  // the group ends: fold it into f32
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = n_base + nt * 8 + tig * 2 + j;
              float sv = 0.f, zs = 0.f;
              if (n < N) {  // the zero of the signed codes, z - 8, in f32
                sv = __bfloat162float(s[(size_t)grp * ld_sz + n]);
                zs = -((__bfloat162float(z[(size_t)grp * ld_sz + n]) - 8.f) * sv);
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int m = m_base + mt * 16 + gid + 8 * h;
                  const float gs = m < M ? gsum[(size_t)m * G + grp] : 0.f;
                  acc[mt][nt][2 * h + j] += (float)ci[mt][nt][2 * h + j] * sv;
                  acz[mt][nt][2 * h + j] += gs * zs;
                  ci[mt][nt][2 * h + j] = 0;
                }
            }
        }
        k = gend;
      }
      if (more) cur = nxt;
    }
  }

  if constexpr (SPLITK) {  // warps 1..3 hand their sums to warp 0
    __shared__ float part[kWarps - 1][2][MT * kNT * 4][32];
    if (warp > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            part[warp - 1][0][(mt * kNT + nt) * 4 + i][lane] = acc[mt][nt][i];
            part[warp - 1][1][(mt * kNT + nt) * 4 + i][lane] = acz[mt][nt][i];
          }
    }
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][nt][i] += part[w][0][(mt * kNT + nt) * 4 + i][lane];
            acz[mt][nt][i] += part[w][1][(mt * kNT + nt) * 4 + i][lane];
          }
  }

  // C fragment: c0/c1 row gid, c2/c3 row gid + 8; columns tig*2 + (i & 1)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + mt * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float a = ax[m];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n_base + nt * 8 + tig * 2 + j;
          if (n < N)
            put_y(y, y_f32, (size_t)m * N + n, (acc[mt][nt][2 * h + j] + acz[mt][nt][2 * h + j]) * a);
        }
    }
}

template <int MT, bool SPLITK>
cudaError_t launch_gemm(dim3 grid, cudaStream_t st, const int8_t* x8, const float* ax,
                        const float* gsum, const uint8_t* q, const __nv_bfloat16* s,
                        const __nv_bfloat16* z, void* y, int y_f32, int M, int N, int K, int Kp,
                        int g, int ld_sz) {
  w4a8_gemm_kernel<MT, SPLITK><<<grid, kWarps * 32, 0, st>>>(x8, ax, gsum, q, s, z, y, y_f32, M, N, K,
                                                              Kp, g, ld_sz);
  return cudaGetLastError();
}

}  // namespace mma_sync
}  // namespace

// x bf16 [M, K] (row stride ld_x) -> x8 s8 [M, Kp], ax f32 [M], gsum f32
// [M, K/g]. amax: null, or f32 [M] row maxima to quantize with instead of
// x's own (a tensor-parallel rank's slice of a row whose maximum was taken
// over the group). Returns the launch's cudaError_t (cudaErrorInvalidValue
// for a row the registers cannot hold: Kp above 131,072).
extern "C" int w4_quantize_rows(const void* x, int M, int K, int ld_x, int Kp, int g, void* x8,
                                void* ax, void* gsum, const void* amax, void* stream) {
  if (M == 0) return 0;
  if (g <= 0 || K % g || Kp % 32 || Kp < K) return cudaErrorInvalidValue;
  const bool wide = K % 8 == 0 && ld_x % 8 == 0 && g >= 16;
  const int VW = wide ? 16 : 2, slots = Kp / VW, max_v = wide ? 8 : 64;
  const bool small = M <= kQuantSmallRows;
  int V = small ? 1 : 4, T = 0;
  for (;; V *= 2) {  // small M: at most kQuantThreads a row where V allows
    T = ((slots + V - 1) / V + 31) / 32 * 32;
    if ((T <= (small ? kQuantThreads : 1024)) || V >= max_v) break;
  }
  if (T > 1024) return cudaErrorInvalidValue;
  const int G = K / g;
  int R = small ? 1 : std::max(1, kQuantThreads / T);
  auto smem_of = [&](int r) { return (size_t)r * (G + T / 32) * sizeof(int); };
  while (R > 1 && smem_of(R) > 227 * 1024) --R;
  if (smem_of(R) > 227 * 1024) return cudaErrorInvalidValue;
  const dim3 grid((M + R - 1) / R);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xx = (const __nv_bfloat16*)x;
  auto* q8 = (int8_t*)x8;
  auto* a = (float*)ax;
  auto* gs = (float*)gsum;
  const auto* given = (const float*)amax;
#define SPTPU_QUANT(VW_, V_) \
  if (VW == VW_ && V == V_)  \
    return launch_quantize<VW_, V_>(grid, R * T, smem_of(R), st, xx, M, K, ld_x, Kp, g, T, q8, a, gs, given);
  SPTPU_QUANT(16, 1) SPTPU_QUANT(16, 2) SPTPU_QUANT(16, 4) SPTPU_QUANT(16, 8)
  SPTPU_QUANT(2, 1) SPTPU_QUANT(2, 2) SPTPU_QUANT(2, 4) SPTPU_QUANT(2, 8) SPTPU_QUANT(2, 16)
  SPTPU_QUANT(2, 32) SPTPU_QUANT(2, 64)
#undef SPTPU_QUANT
  return cudaErrorInvalidValue;
}

// y bf16 [M, N] (f32 where y_f32) = the W4A8 product of x8 s8 [M, Kp] and
// ax f32 [M] with the packed weight q [ld_sz >= N, Kp/2] and s, z bf16
// [K/g, ld_sz], on the plan of ops/quant/w4_matmul.py::w4a8_plan: config 0
// (M > 64: 128 x 128 tiles of the sm90_gemm.cuh mainloop, 128-deep blocks) or 3 (M <= 64: the
// swap-AB decode kernel, 64 columns and `rows` tokens (8, 16, 32, 64) a
// CTA, 64-deep blocks), K split `splits` ways; workspace: the split-K
// counters (zero) and partials.
// g >= 32 and ld_sz % 8 == 0, or cudaErrorInvalidValue
// (w4a8_matmul_mma takes the other groups). gsum f32 [M, K/g] is read only
// for a group whose zero point leaves a rest (see above). Returns the
// launch's cudaError_t.
extern "C" int w4a8_matmul(const void* x8, const void* ax, const void* gsum, const void* q, const void* s,
                           const void* z, void* y, int M, int N, int K, int Kp, int g, int ld_sz,
                           void* stream, void* workspace, int config, int splits, int rows, int y_f32) {
  if (M == 0 || N == 0) return 0;
  if (g < 32 || K % g || ld_sz % 8 || Kp % 32 || splits < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  auto* ws = (uint8_t*)workspace;
  const auto* xp = (const __nv_bfloat16*)x8;  // GemmArgs' x; the tensor maps read int8
  const auto* a8 = (const float*)ax;
  const auto* gs = (const float*)gsum;
  if (config == 0) return launch_prefill(qq, ss, zz, a8, gs, y, y_f32, M, N, K, Kp, g, ld_sz, xp, ws, splits, st);
  if (config != 3 || M > 64) return cudaErrorInvalidValue;
  const GemmArgs a{xp, Kp, M, K, (N + 63) / 64, (K + kDecodeKB - 1) / kDecodeKB, splits, ws};
  const DecodeArgs d{a8, gs, y, N, g, K / g, y_f32};
  if (g % 128 == 0) return launch_decode_nt<4, false>(rows, d, a, qq, ss, zz, ld_sz, Kp, st);
  if (g % 32 == 0) return launch_decode_nt<1, false>(rows, d, a, qq, ss, zz, ld_sz, Kp, st);  // see launch_prefill
  return launch_decode_nt<1, true>(rows, d, a, qq, ss, zz, ld_sz, Kp, st);
}

// The mma.sync.m16n8k32 kernel (any group that divides K): what w4a8_matmul
// computes, for the groups it does not take (g < 32), reading gsum.
extern "C" int w4a8_matmul_mma(const void* x8, const void* ax, const void* gsum, const void* q,
                               const void* s, const void* z, void* y, int M, int N, int K, int Kp,
                               int g, int ld_sz, void* stream, int y_f32) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* a8 = (const int8_t*)x8;
  const auto* a = (const float*)ax;
  const auto* gs = (const float*)gsum;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  using namespace mma_sync;
  if (M <= 64) {
    const dim3 grid(1, (N + kNT * 8 - 1) / (kNT * 8));
    if (M <= 16) return launch_gemm<1, true>(grid, st, a8, a, gs, qq, ss, zz, y, y_f32, M, N, K, Kp, g, ld_sz);
    if (M <= 32) return launch_gemm<2, true>(grid, st, a8, a, gs, qq, ss, zz, y, y_f32, M, N, K, Kp, g, ld_sz);
    return launch_gemm<4, true>(grid, st, a8, a, gs, qq, ss, zz, y, y_f32, M, N, K, Kp, g, ld_sz);
  }
  const dim3 grid((M + 63) / 64, (N + kWarps * kNT * 8 - 1) / (kWarps * kNT * 8));
  return launch_gemm<4, false>(grid, st, a8, a, gs, qq, ss, zz, y, y_f32, M, N, K, Kp, g, ld_sz);
}
