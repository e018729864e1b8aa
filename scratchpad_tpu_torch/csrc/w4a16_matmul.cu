// W4A16 GEMM for Hopper (sm_90a): bf16 activations times 4-bit
// group-quantized weights on the bf16 tensor cores, f32 accumulation.
//
// Replaces two kernels of scratchpad_tpu/ops/quant/pallas_w4.py:
//   _w4_kernel_q4 (:394)  W4A16 over 4-bit-native storage, g % 32 == 0
//   _w4_kernel    (:27)   W4A16 over u8 half planes, any g dividing In/2
// As in w4a8_matmul.cu, one kernel takes every group size that divides In: a
// 16-wide k-step that crosses a group edge is split into pieces, each with
// the activations outside its group masked to zero.
//
// What it computes, over the port's packed layout
// (scratchpad_tpu_torch/ops/quant/w4_matmul.py), in the group-factored form
// of _w4_kernel_q4:
//   y[m, n] = sum_g s[g,n] * (sum_{k in g} x[m,k] * c[k,n])
//           - sum_g xg_sum[m,g] * (z[g,n] * s[g,n])
// with c = nibble - 8 the signed code, z the zero point minus 8, and
// xg_sum[m, g] the f32 sum of the group's bf16 activations, summed in this
// kernel from the A fragments it already holds (each lane sums its part of a
// row, the four lanes of a quad then add theirs). Codes are exact in bf16,
// so each product is exact and the tensor cores accumulate in f32; a group's
// f32 sum is folded with its scale at the group's end, the zero correction
// summed apart and subtracted last. y is bf16 [M, N].
//
// What bounds it: at decode (M <= 64) bytes, the 4-bit weights read once; at
// prefill the bf16 operations, 2*M*In*Out at 989 TFLOP/s. The work split is
// w4a8_matmul.cu's: mma.sync.m16n8k16 bf16; for M <= 64 a CTA owns a
// 16-column strip and its 4 warps split the groups of In, reducing through
// shared memory; for M > 64 a CTA owns 64 x 64 outputs; each warp loads the
// next k-step's fragments before computing the current one.
// Not done yet (later work): wgmma, TMA, a shared-memory ring, a pre-shuffled
// weight layout for wide loads, a split-K decode path across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kNT = 2;  // n8 tiles per warp: 16 output columns
constexpr int kKStep = 16;

// one packed byte (code k in the low nibble, k + 1 in the high one, 4-bit
// two's complement) -> the two codes as bf16, code k in the low half
__device__ __forceinline__ uint32_t unpack2(uint32_t v) {
  const int lo = (int)((v & 0xFu) ^ 8u) - 8;
  const int hi = (int)(((v >> 4) & 0xFu) ^ 8u) - 8;
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// keep the bf16 halves of v whose k-step columns c0, c0 + 1 lie in [lo, hi)
__device__ __forceinline__ uint32_t keep_halves(uint32_t v, int c0, int lo, int hi) {
  uint32_t m = 0;
  if (c0 >= lo && c0 < hi) m |= 0xFFFFu;
  if (c0 + 1 >= lo && c0 + 1 < hi) m |= 0xFFFF0000u;
  return v & m;
}

__device__ __forceinline__ float pair_sum(uint32_t v) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return __low2float(h) + __high2float(h);
}

template <int MT>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[kNT][2];
};

// Fragments of k-step k0. A (m16n8k16, row): reg 0/2 row gid, reg 1/3 row
// gid + 8; columns tig*2, +1 (reg 0/1) and 8 + tig*2, +1 (reg 2/3). B (col):
// column gid, k rows tig*2, +1 (reg 0) and 8 + tig*2, +1 (reg 1), one packed
// byte each.
template <int MT>
__device__ __forceinline__ void load_frags(Frags<MT>& f, const __nv_bfloat16* __restrict__ x,
                                           int ld_x, const uint8_t* __restrict__ q, int M, int N,
                                           int K, int Kp, int m_base, int n_base, int gid,
                                           int tig, int k0) {
  const int c0 = k0 + tig * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m_base + mt * 16 + gid, r1 = r0 + 8;
    const __nv_bfloat16* p0 = x + (size_t)r0 * ld_x + c0;
    const __nv_bfloat16* p1 = x + (size_t)r1 * ld_x + c0;
    f.a[mt][0] = r0 < M && c0 < K ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    f.a[mt][1] = r1 < M && c0 < K ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    f.a[mt][2] = r0 < M && c0 + 8 < K ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
    f.a[mt][3] = r1 < M && c0 + 8 < K ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n_base + nt * 8 + gid;
    if (n < N) {
      const uint8_t* p = q + (size_t)n * (Kp / 2) + k0 / 2 + tig;
      f.b[nt][0] = unpack2(p[0]);
      f.b[nt][1] = unpack2(p[4]);
    } else {
      f.b[nt][0] = f.b[nt][1] = 0u;
    }
  }
}

// The CTA and warp split of w4a8_gemm_kernel (see w4a8_matmul.cu).
template <int MT, bool SPLITK>
__global__ void __launch_bounds__(kWarps * 32)
w4a16_gemm_kernel(const __nv_bfloat16* __restrict__ x, int ld_x, const uint8_t* __restrict__ q,
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

  float pg[MT][kNT][4], acc[MT][kNT][4], acz[MT][kNT][4];
  float xs[MT][2];  // this lane's part of the current group's row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    xs[mt][0] = xs[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) pg[mt][nt][i] = 0.f, acc[mt][nt][i] = 0.f, acz[mt][nt][i] = 0.f;
  }

  if (kb < ke) {
    int k0 = kb / kKStep * kKStep;
    Frags<MT> cur, nxt;
    load_frags<MT>(cur, x, ld_x, q, M, N, K, Kp, m_base, n_base, gid, tig, k0);
    for (; k0 < ke; k0 += kKStep) {
      const bool more = k0 + kKStep < ke;
      if (more) load_frags<MT>(nxt, x, ld_x, q, M, N, K, Kp, m_base, n_base, gid, tig, k0 + kKStep);
      const int kend = min(k0 + kKStep, ke);
      int k = max(k0, kb);
      while (k < kend) {  // the pieces of this k-step, one per group
        const int grp = k / g;
        const int gend = min((grp + 1) * g, kend);
        const bool full = k == k0 && gend == k0 + kKStep;
        const int lo = k - k0, hi = gend - k0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t am[4];
          if (full) {
            am[0] = cur.a[mt][0], am[1] = cur.a[mt][1], am[2] = cur.a[mt][2], am[3] = cur.a[mt][3];
          } else {
            am[0] = keep_halves(cur.a[mt][0], tig * 2, lo, hi);
            am[1] = keep_halves(cur.a[mt][1], tig * 2, lo, hi);
            am[2] = keep_halves(cur.a[mt][2], 8 + tig * 2, lo, hi);
            am[3] = keep_halves(cur.a[mt][3], 8 + tig * 2, lo, hi);
          }
          xs[mt][0] += pair_sum(am[0]) + pair_sum(am[2]);
          xs[mt][1] += pair_sum(am[1]) + pair_sum(am[3]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mma_bf16(pg[mt][nt], am, cur.b[nt]);
        }
        if (gend == (grp + 1) * g) {  // the group ends: fold it
          float rs[MT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = xs[mt][h];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              rs[mt][h] = v;
              xs[mt][h] = 0.f;
            }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = n_base + nt * 8 + tig * 2 + j;
              float sv = 0.f, zs = 0.f;
              if (n < N) {
                sv = __bfloat162float(s[(size_t)grp * ld_sz + n]);
                zs = __bfloat162float(z[(size_t)grp * ld_sz + n]) * sv;
              }
#pragma unroll
              for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  acc[mt][nt][2 * h + j] += pg[mt][nt][2 * h + j] * sv;
                  acz[mt][nt][2 * h + j] += rs[mt][h] * zs;
                  pg[mt][nt][2 * h + j] = 0.f;
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

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + mt * 16 + gid + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n_base + nt * 8 + tig * 2 + j;
          if (n < N)
            y[(size_t)m * N + n] = __float2bfloat16(acc[mt][nt][2 * h + j] - acz[mt][nt][2 * h + j]);
        }
    }
}

template <int MT, bool SPLITK>
cudaError_t launch_gemm(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, int ld_x,
                        const uint8_t* q, const __nv_bfloat16* s, const __nv_bfloat16* z,
                        __nv_bfloat16* y, int M, int N, int K, int Kp, int g, int ld_sz) {
  w4a16_gemm_kernel<MT, SPLITK><<<grid, kWarps * 32, 0, st>>>(x, ld_x, q, s, z, y, M, N, K, Kp,
                                                               g, ld_sz);
  return cudaGetLastError();
}

}  // namespace

// y bf16 [M, N] = x bf16 [M, K] (row stride ld_x) times the packed weight q
// [>= N, Kp/2] with s, z bf16 [K/g, ld_sz]. Returns the launch's cudaError_t.
extern "C" int w4a16_matmul(const void* x, const void* q, const void* s, const void* z, void* y,
                            int M, int N, int K, int ld_x, int Kp, int g, int ld_sz,
                            void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xx = (const __nv_bfloat16*)x;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  auto* out = (__nv_bfloat16*)y;
  if (M <= 64) {
    const dim3 grid(1, (N + kNT * 8 - 1) / (kNT * 8));
    if (M <= 16) return launch_gemm<1, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    if (M <= 32) return launch_gemm<2, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    return launch_gemm<4, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
  }
  const dim3 grid((M + 63) / 64, (N + kWarps * kNT * 8 - 1) / (kWarps * kNT * 8));
  return launch_gemm<4, false>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
}
