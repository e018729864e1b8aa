// Grouped int8 delta-adapter matmul for Hopper (sm_90a): every toppings slot
// of a batch in one launch, bf16 activations times int8 weight deltas on the
// bf16 tensor cores, f32 accumulation, added in place to the slot's rows.
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
// in the f32 epilogue rather than to x.
//
// Each row belongs to one slot, so no two blocks write one element and no
// atomics are needed. The slot table, the delta flags, the scalings and each
// row's slot are read on the device, so the launch never waits on the host.
//
// What bounds it: at decode the bytes, the int8 panel dq[aid, layer] of every
// active delta slot read once (4.2 MB for 2048 -> 2048); at a prefill chunk
// the bf16 operations, 2 * rows * In * Out at 989 TFLOP/s. The work split is
// w4a16_matmul.cu's: mma.sync.m16n8k16 bf16 with each int8 code converted to
// bf16 in registers (exact), the mma accumulator folded into an f32 sum
// every 8 k-steps; for T <= 64 a CTA owns a 16-column strip and its 4 warps
// split In, reducing through shared memory; for T > 64 a CTA owns 64 x 64
// outputs. A block whose slot has no delta, or none of whose rows
// belongs to its slot, exits at once (the JAX kernel's tile_any skip).
// Not done yet (later work): staging the weight panel through shared memory
// with 16-byte loads (each lane reads single bytes), wgmma, TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kNT = 2;  // n8 tiles per warp: 16 output columns
constexpr int kKStep = 16;
// k-steps summed in the mma accumulator before it is folded into a plain
// f32 sum (the W4 kernels fold once a group, 8 k-steps at group 128)
constexpr int kFold = 8;

// two int8 codes -> bf16x2 (exact), the first in the low half
__device__ __forceinline__ uint32_t i8_pair(int8_t lo, int8_t hi) {
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

template <int MT>
struct Frags {
  uint32_t a[MT][4];
  uint32_t b[kNT][2];
};

// Fragments of k-step k0. A (m16n8k16, row): reg 0/2 row gid, reg 1/3 row
// gid + 8; columns tig*2, +1 (reg 0/1) and 8 + tig*2, +1 (reg 2/3). B (col):
// column gid, k rows tig*2, +1 (reg 0) and 8 + tig*2, +1 (reg 1); the panel
// w [In, Out] keeps a column's codes Out bytes apart.
template <int MT>
__device__ __forceinline__ void load_frags(Frags<MT>& f, const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ w, int T, int In, int Out,
                                           int m_base, int n_base, int gid, int tig, int k0) {
  const int c0 = k0 + tig * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m_base + mt * 16 + gid, r1 = r0 + 8;
    const __nv_bfloat16* p0 = x + (size_t)r0 * In + c0;
    const __nv_bfloat16* p1 = x + (size_t)r1 * In + c0;
    f.a[mt][0] = r0 < T ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
    f.a[mt][1] = r1 < T ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
    f.a[mt][2] = r0 < T ? *reinterpret_cast<const uint32_t*>(p0 + 8) : 0u;
    f.a[mt][3] = r1 < T ? *reinterpret_cast<const uint32_t*>(p1 + 8) : 0u;
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int n = n_base + nt * 8 + gid;
    if (n < Out) {
      const int8_t* p = w + (size_t)c0 * Out + n;
      f.b[nt][0] = i8_pair(p[0], p[Out]);
      f.b[nt][1] = i8_pair(p[(size_t)8 * Out], p[(size_t)9 * Out]);
    } else {
      f.b[nt][0] = f.b[nt][1] = 0u;
    }
  }
}

// grid (column strips, row tiles, S - 1): block z serves slot j = z + 1
template <int MT, bool SPLITK>
__global__ void __launch_bounds__(kWarps * 32)
delta_grouped_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                     const int8_t* __restrict__ dq, const float* __restrict__ ds,
                     const int* __restrict__ active, const int* __restrict__ has_delta,
                     const float* __restrict__ scaling, const int* __restrict__ token_slot,
                     int T, int In, int Out, int N, int L, int layer) {
  const int j = blockIdx.z + 1;
  const int aid = active[j];
  if (aid <= 0 || aid >= N || has_delta[aid] == 0) return;  // zero adapter or LoRA only
  const int m_base = blockIdx.y * MT * 16;
  int mine = 0;
  for (int r = threadIdx.x; r < MT * 16; r += kWarps * 32) {
    const int m = m_base + r;
    mine |= m < T && token_slot[m] == j;
  }
  if (!__syncthreads_or(mine)) return;  // no row of this tile is slot j's

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_base = SPLITK ? blockIdx.x * kNT * 8 : (blockIdx.x * kWarps + warp) * kNT * 8;
  const int steps = In / kKStep;
  const int kb = SPLITK ? steps * warp / kWarps * kKStep : 0;
  const int ke = SPLITK ? steps * (warp + 1) / kWarps * kKStep : In;
  const size_t panel = (size_t)aid * L + layer;
  const int8_t* w = dq + panel * In * Out;

  float acc[MT][kNT][4], chunk[MT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = chunk[mt][nt][i] = 0.f;

  if (kb < ke && n_base < Out) {
    Frags<MT> cur, nxt;
    load_frags<MT>(cur, x, w, T, In, Out, m_base, n_base, gid, tig, kb);
    int in_chunk = 0;
    for (int k0 = kb; k0 < ke; k0 += kKStep) {
      const bool more = k0 + kKStep < ke;
      if (more) load_frags<MT>(nxt, x, w, T, In, Out, m_base, n_base, gid, tig, k0 + kKStep);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(chunk[mt][nt], cur.a[mt], cur.b[nt]);
      if (++in_chunk == kFold || !more) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] += chunk[mt][nt][i], chunk[mt][nt][i] = 0.f;
        in_chunk = 0;
      }
      if (more) cur = nxt;
    }
  }

  if constexpr (SPLITK) {  // warps 1..3 hand their sums to warp 0
    __shared__ float part[kWarps - 1][MT * kNT * 4][32];
    if (warp > 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[warp - 1][(mt * kNT + nt) * 4 + i][lane] = acc[mt][nt][i];
    }
    __syncthreads();
    if (warp > 0) return;
#pragma unroll
    for (int v = 0; v < kWarps - 1; ++v)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[v][(mt * kNT + nt) * 4 + i][lane];
  }

  const float* s = ds + panel * Out;
  const float sc = scaling[aid];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + mt * 16 + gid + 8 * h;
      if (m >= T || token_slot[m] != j) continue;  // another slot's row
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = n_base + nt * 8 + tig * 2 + jj;
          if (n < Out) {
            const size_t o = (size_t)m * Out + n;
            out[o] = __float2bfloat16(__bfloat162float(out[o]) + acc[mt][nt][2 * h + jj] * s[n] * sc);
          }
        }
    }
}

template <int MT, bool SPLITK>
cudaError_t launch(dim3 grid, cudaStream_t st, const __nv_bfloat16* x, __nv_bfloat16* out,
                   const int8_t* dq, const float* ds, const int* active, const int* has_delta,
                   const float* scaling, const int* token_slot, int T, int In, int Out, int N,
                   int L, int layer) {
  delta_grouped_kernel<MT, SPLITK><<<grid, kWarps * 32, 0, st>>>(
      x, out, dq, ds, active, has_delta, scaling, token_slot, T, In, Out, N, L, layer);
  return cudaGetLastError();
}

}  // namespace

// out bf16 [T, Out] += each delta slot's product, in place (see above).
// x bf16 [T, In] (In a multiple of 16), dq int8 [N, L, In, Out], ds f32
// [N, L, Out], active i32 [S], has_delta i32 [N], scaling f32 [N],
// token_slot i32 [T]. Returns the launch's cudaError_t.
extern "C" int delta_matmul_grouped(const void* x, void* out, const void* dq, const void* ds,
                                    const void* active, const void* has_delta,
                                    const void* scaling, const void* token_slot, int T, int In,
                                    int Out, int N, int L, int S, int layer, void* stream) {
  if (T == 0 || Out == 0 || S < 2) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* xx = (const __nv_bfloat16*)x;
  auto* oo = (__nv_bfloat16*)out;
  const auto* qq = (const int8_t*)dq;
  const auto* ss = (const float*)ds;
  const auto* aa = (const int*)active;
  const auto* hh = (const int*)has_delta;
  const auto* sc = (const float*)scaling;
  const auto* ts = (const int*)token_slot;
  if (T <= 64) {
    const dim3 grid((Out + kNT * 8 - 1) / (kNT * 8), 1, S - 1);
    if (T <= 16) return launch<1, true>(grid, st, xx, oo, qq, ss, aa, hh, sc, ts, T, In, Out, N, L, layer);
    if (T <= 32) return launch<2, true>(grid, st, xx, oo, qq, ss, aa, hh, sc, ts, T, In, Out, N, L, layer);
    return launch<4, true>(grid, st, xx, oo, qq, ss, aa, hh, sc, ts, T, In, Out, N, L, layer);
  }
  const dim3 grid((Out + kWarps * kNT * 8 - 1) / (kWarps * kNT * 8), (T + 63) / 64, S - 1);
  return launch<4, false>(grid, st, xx, oo, qq, ss, aa, hh, sc, ts, T, In, Out, N, L, layer);
}
