// W4A16 GEMM for Hopper (sm_90a): bf16 activations times 4-bit
// group-quantized weights on the bf16 tensor cores (wgmma), f32 sums.
//
// Replaces two kernels of scratchpad_tpu/ops/quant/pallas_w4.py:
//   _w4_kernel_q4 (:394)  W4A16 over 4-bit-native storage, g % 32 == 0
//   _w4_kernel    (:27)   W4A16 over u8 half planes, any g dividing In/2
//
// What it computes, over the port's packed layout
// (scratchpad_tpu_torch/ops/quant/w4_matmul.py: q [N, Kp/2], s and z [G, N]):
//   y[m, n] = bf16( sum_g s[g, n] * sum_{k in g} x[m, k] * (c[k, n] - z[g, n]) )
// with c = nibble - 8 the signed code and z the zero point minus 8. Every
// quantizer and checkpoint import the port has gives an integral zero, so
// c - z is an integer in [-16, 15]: exact in bf16. The inner sums run on
// the tensor cores in f32 and each group's sum is folded with its scale in
// f32; no scale touches a code before the product (a weight rounded to bf16
// as (c - z) * s reads about 150x the kernel-vs-plain gate, see
// tests/test_torch_gemm_tiles.py). The kernel's sum differs from the plain
// version's group-factored form (w4a16_matmul_plain, _w4_kernel_q4's
// order) only in the order of its f32 additions.
//
// What bounds it: at decode (M <= 64) the bytes, the codes read once; at
// prefill the bf16 operations, 2 * M * In * Out at 989 TFLOP/s. The design
// is sm90_gemm.cuh's mainloop: x by TMA and each 64-deep block of the codes
// by cp.async into a ring; the consumer warpgroups convert a block exactly
// while the previous one's products run, two codes a lop3: 0x4300 | nibble
// is bf16 128 + nibble, and one bf16x2 subtraction of 136 + z gives c - z.
// Prefill tiles are 128 x 128; decode tiles 64 x 256 (the head) or 64 x 64,
// with K split across CTAs where the columns alone give fewer CTAs than
// SMs, reduced in one launch. A group that is whole 64-deep blocks (g % 64
// == 0: every Llama-family width) folds once a group; g % 16 == 0 otherwise
// folds after its 16-deep step. Groups that cut a 16-deep step (GPT-OSS's
// 120, 100) run the mma.sync kernel, w4a16_matmul_mma below.
// Not done yet (later work): decode is bound by x read again for every
// column tile (L2 to SM) and the split-K reduction, not by the codes' bytes:
// weights as the register A operand (swap-AB, no bf16 B tile), x shared
// across a cluster (a two-CTA TMA multicast ran slower: the pair waits on
// each other's releases), TMA for the codes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

// four k-consecutive codes pairs of one packed word (code 2j in the low
// nibble of byte j, 2j + 1 in its high one; nibble ^ 8) minus the zero, as
// bf16x2 (code 2j in the low half): exact
__device__ __forceinline__ void w4_word_to_bf16(uint32_t w, uint32_t sub, uint32_t (&o)[4]) {
  const uint32_t h = w >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of w (code 2j low) to the low half, byte j of h (code 2j + 1
    // low) to the high half; nibble ^ 8 is the unsigned c + 8, under the
    // bf16 exponent of 128 (one lop3)
    const uint32_t v = ((__byte_perm(w, h, 0x4400 + 0x1111 * j) & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
    __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                               *reinterpret_cast<const __nv_bfloat162*>(&sub));
    o[j] = bits(r);
  }
}

// The W4 op of sm90_gemm_kernel. Raw stage: the codes [BN][32 B] (64 codes
// of a column), then s and z [SR][BN] bf16 each: the rows of the groups of
// the block's four 16-deep steps (SR 4), or the one group of the block
// where a group is whole blocks (SR 1: g % 64 == 0).
template <int BN, int SR>
struct W4Op {
  static constexpr int kBN = BN;
  static constexpr int kTB = 0;  // B K-major: a column's 64 codes in one swizzled row
  static constexpr int kCodes = BN * 32;
  static constexpr int kRow = BN * 2;  // one row of s or z
  static constexpr int kRawBytes = kCodes + 2 * SR * kRow;
  const uint8_t* q;
  const __nv_bfloat16* s;
  const __nv_bfloat16* z;
  __nv_bfloat16* y;
  int N, N_st, Kp, g, ld_sz, G;

  __device__ bool start(int, int, int, int, int, int) const { return true; }
  __device__ void issue(uint32_t dst, int kb, int n_base, int p) const {
    const int row_bytes = Kp / 2;
    for (int i = p; i < BN * 2; i += kCopiers) {
      const int n = n_base + (i >> 1), off = kb * 32 + (i & 1) * 16;
      const bool ok = n < N_st && off < row_bytes;
      cp_async16(dst + i * 16, q + (ok ? (size_t)n * row_bytes + off : 0), ok);
    }
    for (int i = p; i < 2 * SR * (BN / 8); i += kCopiers) {  // s rows, then z rows
      const int row = i / (BN / 8), c = i % (BN / 8), n = n_base + c * 8;
      const int gi = min((kb * kKB + 16 * (row % SR)) / g, G - 1);
      const bool ok = n < N_st;
      const __nv_bfloat16* src = (row < SR ? s : z) + (ok ? (size_t)gi * ld_sz + n : 0);
      cp_async16(dst + kCodes + row * kRow + c * 16, src, ok);
    }
  }
  // codes of the NCOL columns from n_lo -> the bf16 B tile [BN][128 B], row
  // n holding c - z of k = 0..63; thread q of the 128 that share them. A
  // unit is a column's 16 codes of one 16-deep step: loads first, then the
  // conversions.
  template <int NCOL>
  __device__ void convert(const uint8_t* raw, uint8_t* w, int n_lo, int q) const {
    constexpr int U = NCOL * 4 / 128;
    const __nv_bfloat16* zr = reinterpret_cast<const __nv_bfloat16*>(raw + kCodes + SR * kRow);
    uint2 c8[U];
    __nv_bfloat16 zv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = q + 128 * i, row = n_lo + (u >> 2), kk = u & 3;
      c8[i] = *reinterpret_cast<const uint2*>(raw + row * 32 + kk * 8);
      zv[i] = zr[(kk % SR) * BN + row];
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = q + 128 * i, row = n_lo + (u >> 2), kk = u & 3;
      const uint32_t sub = bits(__float2bfloat162_rn(136.f + __bfloat162float(zv[i])));
      uint32_t o[4];
      w4_word_to_bf16(c8[i].x, sub, o);
      *reinterpret_cast<uint4*>(w + swz(row, 2 * kk)) = make_uint4(o[0], o[1], o[2], o[3]);
      w4_word_to_bf16(c8[i].y, sub, o);
      *reinterpret_cast<uint4*>(w + swz(row, 2 * kk + 1)) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  __device__ uint64_t b_desc(uint32_t wb, int n0, int kk) const {
    return desc(wb + n0 * 128 + kk * 32, 16, 1024);
  }
  __device__ bool group_start(int kb) const { return kb % (g / kKB) == 0; }
  __device__ bool group_end(int kb) const { return (kb + 1) % (g / kKB) == 0; }
  __device__ bool step_starts(int j) const { return 16 * j % g == 0; }
  __device__ bool step_ends(int j) const { return 16 * (j + 1) % g == 0; }
  // tot += acc * s of the group of step kk, column by column, in f32
  template <int NACC>
  __device__ void fold(const float (&acc)[NACC], float (&tot)[NACC], const uint8_t* raw, int kk,
                       int col) const {
    const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(raw + kCodes + (kk % SR) * kRow) + col;
#pragma unroll
    for (int c = 0; c < NACC / 4; ++c) {
      const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + 8 * c));
      tot[4 * c] += acc[4 * c] * sv.x;
      tot[4 * c + 1] += acc[4 * c + 1] * sv.y;
      tot[4 * c + 2] += acc[4 * c + 2] * sv.x;
      tot[4 * c + 3] += acc[4 * c + 3] * sv.y;
    }
  }
  template <int NACC>
  __device__ void store(const float (&v)[NACC], int m0, int n0, int M) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * i;
      if (m >= M) continue;
#pragma unroll
      for (int c = 0; c < NACC / 4; ++c) {
        const int n = n0 + 8 * c;
        if (n >= N) continue;
        __nv_bfloat16* p = y + (size_t)m * N + n;
        if (n + 1 < N && !(N & 1)) {
          *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[4 * c + 2 * i], v[4 * c + 2 * i + 1]);
        } else {
          p[0] = __float2bfloat16(v[4 * c + 2 * i]);
          if (n + 1 < N) p[1] = __float2bfloat16(v[4 * c + 2 * i + 1]);
        }
      }
    }
  }
};

template <int NC, int WM, int NW>
cudaError_t launch_w4(const __nv_bfloat16* x, const uint8_t* q, const __nv_bfloat16* s,
                      const __nv_bfloat16* z, __nv_bfloat16* y, int M, int N, int K, int ld_x,
                      int Kp, int g, int ld_sz, uint8_t* ws, int splits, cudaStream_t st) {
  using T = GemmTile<NC, WM, NW>;
  const GemmArgs a{x, ld_x, M, K, (N + T::BN - 1) / T::BN, (K + kKB - 1) / kKB, splits, ws};
  const int m_tiles = (M + T::BM - 1) / T::BM;
  if (g % kKB == 0)
    return run_gemm<W4Op<T::BN, 1>, NC, WM, NW, false>({q, s, z, y, N, ld_sz, Kp, g, ld_sz, K / g},
                                                         a, m_tiles, 1, st);
  return run_gemm<W4Op<T::BN, 4>, NC, WM, NW, true>({q, s, z, y, N, ld_sz, Kp, g, ld_sz, K / g}, a,
                                                      m_tiles, 1, st);
}

}  // namespace

// y bf16 [M, N] = x bf16 [M, K] (row stride ld_x) times the packed weight q
// [ld_sz >= N, Kp/2] with s, z bf16 [K/g, ld_sz], on the tile configuration
// (0: 128 x 128, 1: 64 x 256, 2: 64 x 64) and K split that
// ops/quant/w4_matmul.py::gemm_plan gives; workspace: its split-K counters
// (zero) and partials. g % 16 == 0, ld_sz % 8 == 0 and ld_x % 8 == 0, or
// cudaErrorInvalidValue (w4a16_matmul_mma takes the other groups). Returns
// the launch's cudaError_t.
extern "C" int w4a16_matmul(const void* x, const void* q, const void* s, const void* z, void* y,
                            int M, int N, int K, int ld_x, int Kp, int g, int ld_sz,
                            void* stream, void* workspace, int config, int splits) {
  if (M == 0 || N == 0) return 0;
  if (g <= 0 || g % 16 || K % g || ld_sz % 8 || ld_x % 8 || splits < 1)
    return cudaErrorInvalidValue;
  const auto* xx = (const __nv_bfloat16*)x;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  auto* out = (__nv_bfloat16*)y;
  auto* ws = (uint8_t*)workspace;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (config) {
    case 0:
      return launch_w4<2, 2, 128>(xx, qq, ss, zz, out, M, N, K, ld_x, Kp, g, ld_sz, ws, splits, st);
    case 1:
      return launch_w4<2, 1, 128>(xx, qq, ss, zz, out, M, N, K, ld_x, Kp, g, ld_sz, ws, splits, st);
    case 2:
      return launch_w4<1, 1, 64>(xx, qq, ss, zz, out, M, N, K, ld_x, Kp, g, ld_sz, ws, splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- the mma.sync kernel
//
// The group-factored form of _w4_kernel_q4 on mma.sync.m16n8k16 (see
// w4a8_matmul.cu for the work split), for any group that divides In: a
// 16-wide k-step that crosses a group edge is split into pieces, each with
// the activations outside its group masked to zero.
//   y[m, n] = sum_g s[g,n] * (sum_{k in g} x[m,k] * c[k,n])
//           - sum_g xg_sum[m,g] * (z[g,n] * s[g,n])
// with xg_sum[m, g] the f32 sum of the group's bf16 activations.

namespace {
namespace mma_sync {

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
w4a16_mma_kernel(const __nv_bfloat16* __restrict__ x, int ld_x, const uint8_t* __restrict__ q,
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
  w4a16_mma_kernel<MT, SPLITK><<<grid, kWarps * 32, 0, st>>>(x, ld_x, q, s, z, y, M, N, K, Kp,
                                                               g, ld_sz);
  return cudaGetLastError();
}

}  // namespace mma_sync
}  // namespace

// The mma.sync.m16n8k16 kernel (any group that divides K): what
// w4a16_matmul does, for the groups it does not take (g % 16 != 0).
extern "C" int w4a16_matmul_mma(const void* x, const void* q, const void* s, const void* z,
                                void* y, int M, int N, int K, int ld_x, int Kp, int g, int ld_sz,
                                void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xx = (const __nv_bfloat16*)x;
  const auto* qq = (const uint8_t*)q;
  const auto* ss = (const __nv_bfloat16*)s;
  const auto* zz = (const __nv_bfloat16*)z;
  auto* out = (__nv_bfloat16*)y;
  if (M <= 64) {
    const dim3 grid(1, (N + mma_sync::kNT * 8 - 1) / (mma_sync::kNT * 8));
    if (M <= 16) return mma_sync::launch_gemm<1, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    if (M <= 32) return mma_sync::launch_gemm<2, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
    return mma_sync::launch_gemm<4, true>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
  }
  constexpr int kCols = mma_sync::kWarps * mma_sync::kNT * 8;
  const dim3 grid((M + 63) / 64, (N + kCols - 1) / kCols);
  return mma_sync::launch_gemm<4, false>(grid, st, xx, ld_x, qq, ss, zz, out, M, N, K, Kp, g, ld_sz);
}
