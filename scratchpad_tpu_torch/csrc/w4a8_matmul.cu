// W4A8 GEMM for Hopper (sm_90a): per-token int8 activations times 4-bit
// group-quantized weights on the s8 tensor cores, and the row quantizer that
// feeds it.
//
// Replaces three pieces of scratchpad_tpu/ops/quant/pallas_w4.py:
//   _w4a8_kernel_q4 (:363)  W4A8 over 4-bit-native storage, g % 32 == 0
//   _w4a8_kernel    (:139)  W4A8 over u8 half planes, any g dividing In/2
//   the activation quantization of _w4_q4_call (:452-461), done outside the
//   Pallas kernel by XLA
// The TPU needed two GEMM kernels only because Mosaic could not tile group
// slices that are not multiples of 32. Here one kernel takes every group size
// that divides In: a 32-wide k-step that crosses a group edge is split into
// pieces, each with the activations outside its group masked to zero.
//
// What it computes, with x8/ax/gsum from w4_quantize_rows and the port's
// packed layout (scratchpad_tpu_torch/ops/quant/w4_matmul.py):
//   y[m, n] = ax[m] * ( sum_g s[g,n] * (sum_{k in g} x8[m,k] * c[k,n])_i32
//                     + sum_g gsum[m,g] * (-z[g,n] * s[g,n]) )
// where c = nibble - 8 is the signed code and z holds the zero point minus 8
// (the same value as the unsigned form: 8 * gsum cancels). Each group's
// integer dot is exact in an i32 accumulator (|x8 * c| <= 127 * 8), folded
// into f32 with its scale at the group's end; the zero correction is summed
// apart and added before the ax scale, the epilogue order of _w4a8_kernel_q4.
// y is bf16 [M, N].
//
// What bounds it: at decode (M <= 64) bytes, the 4-bit weights (In*Out/2 B)
// read once; at prefill (M in the thousands) the int8 operations, 2*M*In*Out
// at 1,979 TOPS. The design:
//   - mma.sync.m16n8k32 s8 x s8 -> s32; B fragments unpacked from nibbles in
//     registers (mask, shift, per-byte sign extension), A fragments read
//     straight from the int8 rows (their row stride Kp is a multiple of 32);
//   - M <= 64 (decode): a CTA owns a 16-column strip and all M rows, and its
//     4 warps split the groups of In four ways, reducing through shared
//     memory at the end: this gives In/32/4 serial k-steps per warp and
//     Out/16 CTAs, enough to cover the card at the small projections;
//   - M > 64 (prefill): a CTA owns 64 x 64 outputs, its warps 16 columns
//     each over the whole of In; M-tiles run fastest in the grid so that
//     neighbouring CTAs share weight columns in L2;
//   - each warp loads the next k-step's fragments before computing the
//     current one.
// Not done yet (later work): wgmma, TMA and a shared-memory ring, a
// pre-shuffled weight layout for 16-byte loads, a GEMV-shaped split-K decode
// path across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kNT = 2;  // n8 tiles per warp: 16 output columns
constexpr int kKStep = 32;
constexpr int kQuantThreads = 256;

// ---------------------------------------------------------------- quantizer

// One CTA per row: amax, then x8 = clip(rint(x / ax), -127, 127) with
// ax = amax / 127 (1 for a row of zeros), IEEE division and round half to
// even, as torch.round and jnp.round; x8 is written with a row stride Kp
// (zeros past K), gsum[m, g] as the exact integer sum of each group.
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x, int K, int ld_x, int Kp, int g,
                     int8_t* __restrict__ x8, float* __restrict__ ax_out,
                     float* __restrict__ gsum) {
  extern __shared__ int group_sum[];  // [G]
  __shared__ float warp_max[kQuantThreads / 32];
  const int m = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int G = K / g;
  const __nv_bfloat16* xr = x + (size_t)m * ld_x;
  for (int i = threadIdx.x; i < G; i += blockDim.x) group_sum[i] = 0;

  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(__bfloat162float(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (lane == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float ax = amax == 0.f ? 1.f : __fdiv_rn(amax, 127.f);

  int8_t* out = x8 + (size_t)m * Kp;
  // Kp and blockDim are multiples of 32: a warp's lanes run the loop together
  for (int k = threadIdx.x; k < Kp; k += blockDim.x) {
    int v = 0;
    if (k < K) {
      const float r = rintf(__fdiv_rn(__bfloat162float(xr[k]), ax));
      v = (int)fminf(fmaxf(r, -127.f), 127.f);
    }
    out[k] = (int8_t)v;
    const int kw = k - lane;  // the warp's first k
    if (kw + 31 < K && kw / g == (kw + 31) / g) {
      const int s = __reduce_add_sync(0xffffffffu, v);
      if (lane == 0) atomicAdd(&group_sum[kw / g], s);
    } else if (k < K) {
      atomicAdd(&group_sum[k / g], v);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) ax_out[m] = ax;
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    gsum[(size_t)m * G + i] = (float)group_sum[i];
}

// ---------------------------------------------------------------- GEMM

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
                 __nv_bfloat16* __restrict__ y, int M, int N, int K, int Kp, int g,
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
              if (n < N) {
                sv = __bfloat162float(s[(size_t)grp * ld_sz + n]);
                zs = -(__bfloat162float(z[(size_t)grp * ld_sz + n]) * sv);
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
            y[(size_t)m * N + n] =
                __float2bfloat16((acc[mt][nt][2 * h + j] + acz[mt][nt][2 * h + j]) * a);
        }
    }
}

template <int MT, bool SPLITK>
cudaError_t launch_gemm(dim3 grid, cudaStream_t st, const int8_t* x8, const float* ax,
                        const float* gsum, const uint8_t* q, const __nv_bfloat16* s,
                        const __nv_bfloat16* z, __nv_bfloat16* y, int M, int N, int K, int Kp,
                        int g, int ld_sz) {
  w4a8_gemm_kernel<MT, SPLITK><<<grid, kWarps * 32, 0, st>>>(x8, ax, gsum, q, s, z, y, M, N, K,
                                                              Kp, g, ld_sz);
  return cudaGetLastError();
}

}  // namespace

// x bf16 [M, K] (row stride ld_x) -> x8 s8 [M, Kp], ax f32 [M], gsum f32
// [M, K/g]. Returns the launch's cudaError_t.
extern "C" int w4_quantize_rows(const void* x, int M, int K, int ld_x, int Kp, int g, void* x8,
                                void* ax, void* gsum, void* stream) {
  if (M == 0) return 0;
  const int smem = (K / g) * (int)sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        quantize_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  quantize_rows_kernel<<<M, kQuantThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, K, ld_x, Kp, g, (int8_t*)x8, (float*)ax, (float*)gsum);
  return cudaGetLastError();
}

// y bf16 [M, N] = W4A8 product over the packed weight q [>= N, Kp/2] with
// s, z bf16 [K/g, ld_sz]. Returns the launch's cudaError_t.
extern "C" int w4a8_matmul(const void* x8, const void* ax, const void* gsum, const void* q,
                           const void* s, const void* z, void* y, int M, int N, int K, int Kp,
                           int g, int ld_sz, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* a8 = (const int8_t*)x8;
  const auto* a = (const float*)ax;
  const auto* gs = (const float*)gsum;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  auto* out = (__nv_bfloat16*)y;
  if (M <= 64) {
    const dim3 grid(1, (N + kNT * 8 - 1) / (kNT * 8));
    if (M <= 16) return launch_gemm<1, true>(grid, st, a8, a, gs, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    if (M <= 32) return launch_gemm<2, true>(grid, st, a8, a, gs, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    return launch_gemm<4, true>(grid, st, a8, a, gs, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
  }
  const dim3 grid((M + 63) / 64, (N + kWarps * kNT * 8 - 1) / (kWarps * kNT * 8));
  return launch_gemm<4, false>(grid, st, a8, a, gs, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
}
