// Grouped int8 delta-adapter matmul for Hopper (sm_90a): every toppings slot
// of a batch in one launch, bf16 activations times int8 weight deltas on the
// bf16 tensor cores (wgmma), f32 sums, added in place to the slot's rows.
//
// Replaces scratchpad_tpu/ops/ldmm.py::_delta_kernel (:51, launched :121 by
// delta_matmul :72). The JAX package launches it once per active slot and
// projection (toppings/manager.py:306-319), each launch writing its slot's
// rows and zeros for every other row, which it then adds. This kernel covers
// every slot in one launch per projection. For each token t whose slot j >= 1
// holds a pool adapter aid = active[j] with has_delta[aid] != 0:
//   out[t, n] = bf16(f32(out[t, n])
//                    + (sum_k x[t, k] * dq[aid, layer, k, n]) * ds[aid, layer, n]
//                      * scaling[aid])
// Rows of slot 0 and of LoRA-only slots are not written: they stay bit for
// bit what they were. The JAX function rounds each slot's product to bf16 and
// adds it in bf16; this kernel rounds once, and applies the adapter's scaling
// in the f32 epilogue rather than to x. Every scale is applied in f32 after
// the product: a delta rounded to bf16 as dq * ds reads about 250x the
// kernel-vs-plain gate (tests/test_torch_gemm_tiles.py).
//
// Each row belongs to one slot, so no two tiles write one element and no
// atomics touch the output. The slot table, the delta flags, the scalings
// and each row's slot are read on the device, so the launch never waits on
// the host. A CTA whose slot has no delta, or none of whose rows belongs to
// its slot, exits at once (the JAX kernel's tile_any skip).
//
// What bounds it: at decode the bytes, the int8 panel dq[aid, layer] of every
// active delta slot read once (4.2 MB for 2048 -> 2048); at a prefill chunk
// the bf16 operations, 2 * rows * In * Out at 989 TFLOP/s. The design is
// sm90_gemm.cuh's mainloop, as w4a16_matmul.cu's: x by TMA and each 64 x BN
// block of the panel by cp.async into a ring; the consumer warpgroups
// convert it to bf16 exactly (the float 2^23 + u, one subtraction: the
// extend kernel's int8 converter), in the MN-major layout wgmma reads
// through its transpose bit. Each 64-deep block's f32 sum is added to a
// running f32 sum (one sum kept in the tensor cores' accumulator over K 8192
// failed the gate in a check of eight mixed slots); the column scale and the
// scaling come in the epilogue. Decode K-splits reach at least an SM's worth
// of CTAs per delta slot where the workspace allows, reduced in one launch.
// Not done yet (later work): a CTA for each slot, active or not (the idle
// ones exit at once, after reading the slot table); the rows of other slots
// in the A tile (a decode tile computes all 64 rows and keeps its slot's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

// The delta op of sm90_gemm_kernel. Raw stage: the panel block [64 k][BN]
// int8. B tile: [BN / 64 column blocks][64 k][128 B], MN-major.
template <int BN>
struct DeltaOp {
  static constexpr int kBN = BN;
  static constexpr int kTB = 1;
  static constexpr int kRawBytes = kKB * BN;
  const int8_t* dq;
  const float* ds;
  const int* active;
  const int* has_delta;
  const float* scaling;
  const int* token_slot;
  __nv_bfloat16* out;
  int In, Out, N, L, layer;
  // this CTA's slot, set by start
  const int8_t* w;
  const float* dsp;
  float sc;
  int j;

  // block z serves slot j = z + 1; false (for the whole CTA) when its slot
  // has no delta or none of the tile's rows is the slot's
  __device__ bool start(int z, int m_base, int M, int BM, int tid, int threads) {
    j = z + 1;
    const int aid = active[j];
    if (aid <= 0 || aid >= N || has_delta[aid] == 0) return false;  // zero adapter or LoRA only
    int mine = 0;
    for (int r = tid; r < BM; r += threads) {
      const int m = m_base + r;
      mine |= m < M && token_slot[m] == j;
    }
    if (!__syncthreads_or(mine)) return false;
    const size_t panel = (size_t)aid * L + layer;
    w = dq + panel * In * Out;
    dsp = ds + panel * Out;
    sc = scaling[aid];
    return true;
  }
  __device__ void issue(uint32_t dst, int kb, int n_base, int p) const {
    if (Out % 16 == 0) {
      for (int i = p; i < kKB * BN / 16; i += kCopiers) {
        const int k = kb * kKB + i / (BN / 16), n = n_base + i % (BN / 16) * 16;
        const bool ok = k < In && n < Out;
        cp_async16(dst + i * 16, w + (ok ? (size_t)k * Out + n : 0), ok);
      }
    } else {  // rows 8-byte aligned only
      for (int i = p; i < kKB * BN / 8; i += kCopiers) {
        const int k = kb * kKB + i / (BN / 8), n = n_base + i % (BN / 8) * 8;
        const bool ok = k < In && n < Out;
        cp_async8(dst + i * 8, w + (ok ? (size_t)k * Out + n : 0), ok);
      }
    }
  }
  // the panel block's NCOL columns from n_lo -> bf16, row k of column block
  // b at [b][k][128 B]; thread q of the 128 that share them. A unit is 16
  // codes of a row: loads first, then the conversions.
  template <int NCOL>
  __device__ void convert(const uint8_t* raw, uint8_t* wt, int n_lo, int q) const {
    constexpr int P = NCOL / 16, U = kKB * P / 128;
    uint4 r[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = q + 128 * i;
      r[i] = *reinterpret_cast<const uint4*>(raw + (u / P) * BN + n_lo + (u % P) * 16);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int u = q + 128 * i, k = u / P, c16 = n_lo / 16 + u % P;
      uint32_t o[8];
      codes_to_bf16(r[i].x, int8_t(), o[0], o[1]);
      codes_to_bf16(r[i].y, int8_t(), o[2], o[3]);
      codes_to_bf16(r[i].z, int8_t(), o[4], o[5]);
      codes_to_bf16(r[i].w, int8_t(), o[6], o[7]);
      uint8_t* dst = wt + (c16 >> 2) * (kKB * 128);
      const int ch = 2 * (c16 & 3);
      *reinterpret_cast<uint4*>(dst + swz(k, ch)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + swz(k, ch + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
  __device__ uint64_t b_desc(uint32_t wb, int n0, int kk) const {
    return desc(wb + (n0 / 64) * (kKB * 128) + kk * 16 * 128, kKB * 128, 1024);
  }
  // a "group" is one block: its f32 sum is added to the running sum after it
  __device__ bool group_start(int) const { return true; }
  __device__ bool group_end(int) const { return true; }
  template <int NACC>
  __device__ void fold(const float (&acc)[NACC], float (&tot)[NACC], const uint8_t*, int, int) const {
#pragma unroll
    for (int i = 0; i < NACC; ++i) tot[i] += acc[i];
  }
  // out += v * ds * scaling on this slot's rows (Out is even: pairs)
  template <int NACC>
  __device__ void store(const float (&v)[NACC], int m0, int n0, int M) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + 8 * i;
      if (m >= M || token_slot[m] != j) continue;  // another slot's row
#pragma unroll
      for (int c = 0; c < NACC / 4; ++c) {
        const int n = n0 + 8 * c;
        if (n >= Out) continue;
        auto* p = reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * Out + n);
        const float2 o = __bfloat1622float2(*p);
        *p = __floats2bfloat162_rn(o.x + v[4 * c + 2 * i] * dsp[n] * sc,
                                   o.y + v[4 * c + 2 * i + 1] * dsp[n + 1] * sc);
      }
    }
  }
};

template <int NC, int WM, int NW>
cudaError_t launch_cfg(const void* x, void* out, const void* dq, const void* ds, const void* active,
                       const void* has_delta, const void* scaling, const void* token_slot,
                       int T, int In, int Out, int N, int L, int S, int layer, uint8_t* ws,
                       int splits, cudaStream_t st) {
  using Tl = GemmTile<NC, WM, NW>;
  const DeltaOp<Tl::BN> op{
      (const int8_t*)dq, (const float*)ds, (const int*)active, (const int*)has_delta,
      (const float*)scaling, (const int*)token_slot, (__nv_bfloat16*)out, In, Out, N, L, layer,
      nullptr, nullptr, 0.f, 0};
  const GemmArgs a{(const __nv_bfloat16*)x, In, T, In, (Out + Tl::BN - 1) / Tl::BN,
                   (In + kKB - 1) / kKB, splits, ws};
  return run_gemm<DeltaOp<Tl::BN>, NC, WM, NW, false>(op, a, (T + Tl::BM - 1) / Tl::BM, S - 1, st);
}

}  // namespace

// out bf16 [T, Out] += each delta slot's product, in place (see above).
// x bf16 [T, In] (In a multiple of 16), dq int8 [N, L, In, Out] (Out a
// multiple of 8), ds f32 [N, L, Out], active i32 [S], has_delta i32 [N],
// scaling f32 [N], token_slot i32 [T]; the tile configuration (0: 128 x 128,
// 1: 64 x 256, 2: 64 x 64), K split and workspace of
// ops/quant/w4_matmul.py::gemm_plan with S - 1 slots. Returns the launch's
// cudaError_t.
extern "C" int delta_matmul_grouped(const void* x, void* out, const void* dq, const void* ds,
                                    const void* active, const void* has_delta,
                                    const void* scaling, const void* token_slot, int T, int In,
                                    int Out, int N, int L, int S, int layer, void* stream,
                                    void* workspace, int config, int splits) {
  if (T == 0 || Out == 0 || S < 2) return 0;
  if (In % 16 || Out % 8 || splits < 1) return cudaErrorInvalidValue;
  auto* ws = (uint8_t*)workspace;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (config) {
    case 0:
      return launch_cfg<2, 2, 128>(x, out, dq, ds, active, has_delta, scaling, token_slot, T, In,
                                   Out, N, L, S, layer, ws, splits, st);
    case 1:
      return launch_cfg<2, 1, 128>(x, out, dq, ds, active, has_delta, scaling, token_slot, T, In,
                                   Out, N, L, S, layer, ws, splits, st);
    case 2:
      return launch_cfg<1, 1, 64>(x, out, dq, ds, active, has_delta, scaling, token_slot, T, In,
                                  Out, N, L, S, layer, ws, splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}
