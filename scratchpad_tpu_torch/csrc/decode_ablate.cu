// The decode ablation probe for Hopper (sm_90a): a paged flash-decode cut
// after one of five stages, returning the JAX probe's statistic and each
// stage's own work.
//
// Replaces the TPU kernel tools/profiling/_ablate.py::make_kernel (:11,
// launched :106). That kernel exists to time the stages of a paged decode:
// every mode streams the same chunks of pages, and stops computing after
//   dma_only      the copies into fast memory (plus one element a chunk)
//   reshape_only  a read of every element of the chunk
//   sdot_only     the scores s = q . K
//   no_pv         the mask and the online softmax (m, l)
//   full          the PV product as well.
//
// What it computes, for sequence b (see ops/attention/decode_ablate.py's
// decode_ablate_plain, which defines it element for element):
//   - the pool is interleaved, kv [pages, ps, 2 Hkv, Dp]: lane block 2k is
//     K of kv head k, block 2k + 1 its V; query head h reads kv head h / G;
//   - chunks of CP pages: nchunks = max(ceil(len / (CP ps)), 1), and a chunk
//     reads all CP page-table entries; rows past len are read and, from
//     no_pv on, masked to -1e30 (m starts at -1e30, so a row with len 0
//     runs one chunk of masked scores and ends with l = CP ps);
//   - s[h, j] = q[h] . K[j] in f32 with no sm_scale; per chunk m_new =
//     max(m, max_j s), alpha = exp(m - m_new), p = exp(s - m_new), l = l
//     alpha + sum p, acc = acc alpha + bf16(p) . V;
//   - out[b, h, :] = bf16((m + l) + acc00), broadcast over the row, where
//     acc00 is the JAX kernel's acc[0, 0]: element 0 of head 0's PV taken
//     over all lanes, that is bf16(p[0]) . K_0[:, 0] in full, the sum of
//     that column in reshape_only, the one element a chunk in dma_only, 0
//     in sdot_only and no_pv;
//   - aux[b, h, :] = (m, l, checksum) in f32, the stage's own work, which
//     `out` hides under m = -1e30 in the first three modes and under head
//     0's K column in full. Checksums: dma_only the element kv[page 0 of
//     each chunk, row 0, block 2k, 0] summed over chunks; reshape_only the
//     sum of |x| over every element of kv head k's K and V blocks in the
//     live chunks; sdot_only the sum of |s| over their rows (l holds the
//     signed sum, as JAX's l does); no_pv 0; full sum_d |acc[h, d]|, the
//     head's real PV over its own V. The magnitudes keep a checksum from
//     cancelling to near 0, where its f32 rounding would exceed a tolerance
//     relative to its value.
//
// Design. A TPU core walks the grid in order, so the Pallas kernel
// prefetches the next sequence's first chunk during the current one's last
// (_ablate.py:33-36, 48-57). CTAs run in parallel on the GPU, so that
// cross-sequence pipeline has no counterpart: each CTA (b, k) walks its own
// sequence with a ring of kRing tiles in shared memory fed by cp.async, a
// tile being one page of kv head k's K or V block (ps x Dp bf16). Tiles come
// in the order each chunk needs them, K pages then V pages, so the copies of
// a chunk's V and of the next chunk's K run under the scores and the PV. The
// softmax of a chunk needs all its scores, which wait in shared memory
// [G][CP ps] until the chunk's last K page is scored; one warp scores a row
// for the G query heads of the kv head. A second small kernel writes `out`,
// since acc00 comes from kv head 0's CTA and the heads of a row lie in
// different CTAs.
//
// What bounds it: bytes. Each chunk streams CP ps 2 Hkv Dp 2 B a sequence
// against about 4 Hq Dp flops a row. A simple kernel first: the scores use
// one warp shuffle reduction per row and head, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRing = 16;  // tiles in flight per CTA
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 227 * 1024;

enum Mode : int { kDmaOnly = 0, kReshapeOnly = 1, kSdotOnly = 2, kNoPv = 3, kFull = 4 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a + b * c with two roundings, as the plain version computes it
__device__ __forceinline__ float mul_add(float a, float b, float c) {
  return __fadd_rn(a, __fmul_rn(b, c));
}

template <int DP, int G, int MODE>
__global__ void __launch_bounds__(kThreads)
decode_ablate_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kv,
                     const int* __restrict__ page_table,
                     const int* __restrict__ seq_lens,
                     float* __restrict__ aux,
                     float* __restrict__ acc00_out,
                     int num_kv_heads, int max_pages, int page_size, int chunk_pages) {
  static_assert(DP == 64 || DP == 128, "Dp must be 64 or 128");
  static_assert(kThreads % DP == 0, "the PV splits a tile's rows over kThreads / DP threads");
  constexpr int EPL = DP / 32;           // elements of a row per lane
  constexpr int kPieces = DP * 2 / 16;   // 16-byte copies per row
  constexpr int RS = kThreads / DP;      // row splits of the PV
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hq = num_kv_heads * G;
  const int CP = chunk_pages;
  const int chunk = CP * page_size;
  const int len = seq_lens[b];
  const int nchunks = max((len + chunk - 1) / chunk, 1);
  // a table too narrow for this row's chunks: NaN statistics, nothing read
  const bool fits = nchunks * CP <= max_pages;
  const int ntiles = fits ? nchunks * 2 * CP : 0;
  const int tile_elems = page_size * DP;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // [G][chunk] scores, then bf16(p); at the end, full's [G][kThreads] partial sums
  float* sbuf = reinterpret_cast<float*>(ring + kRing * tile_elems);
  float* kcol = sbuf + G * max(chunk, kThreads);  // [chunk] K_0[:, 0] of the chunk
  __shared__ float m_s[G], l_s[G], alpha_s[G], csum_s[G];
  __shared__ float red[kWarps][G];
  __shared__ float acc00_s;

  const int* pt = page_table + (size_t)b * max_pages;
  const size_t row_stride = (size_t)2 * num_kv_heads * DP;

  // tile t of this CTA: chunk t / 2CP; its K pages, then its V pages
  auto issue = [&](int t) {
    const int c = t / (2 * CP);
    const int w = t % (2 * CP);
    const int kind = w / CP;
    const int j = w % CP;
    const size_t page = (size_t)pt[c * CP + j];
    const __nv_bfloat16* src = kv + page * page_size * row_stride + (size_t)(2 * k + kind) * DP;
    __nv_bfloat16* dst = ring + (t % kRing) * tile_elems;
    for (int i = tid; i < page_size * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int piece = i % kPieces;
      cp_async16(dst + r * DP + piece * 8, src + r * row_stride + piece * 8);
    }
  };

  float qv[G][EPL];
  if constexpr (MODE >= kSdotOnly) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        qv[g][e] = __bfloat162float(q[((size_t)b * hq + (size_t)k * G + g) * DP + lane * EPL + e]);
      }
    }
  }
  if (tid < G) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;
    csum_s[tid] = 0.f;
  }
  if (tid == 0) acc00_s = 0.f;
  float own = 0.f;  // dma_only: thread 0's elements; reshape_only: this thread's sum of |x|
  float col0 = 0.f;  // reshape_only, thread 0 of kv head 0: the sum of K_0[:, 0]
  const int d = tid % DP;
  const int rs = tid / DP;
  float acc[G], pv[G];  // full: this thread's (head, d) accumulators over its rows
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = pv[g] = 0.f;
  __syncthreads();

#pragma unroll 1
  for (int t = 0; t < kRing; ++t) {
    if (t < ntiles) issue(t);
    cp_async_commit();  // empty groups keep the count uniform
  }

#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kRing - 1>();  // this thread's copies of tile t have landed
    __syncthreads();             // and everyone's
    const __nv_bfloat16* tile = ring + (t % kRing) * tile_elems;
    const int c = t / (2 * CP);
    const int w = t % (2 * CP);
    const bool is_k = w < CP;
    const int j = w % CP;
    if (is_k) {
      if constexpr (MODE == kDmaOnly) {
        if (j == 0 && tid == 0) own += __bfloat162float(tile[0]);
      } else if constexpr (MODE == kReshapeOnly) {
        for (int i = tid; i < tile_elems; i += kThreads) own += fabsf(__bfloat162float(tile[i]));
        if (k == 0 && tid == 0) {
          for (int r = 0; r < page_size; ++r) col0 += __bfloat162float(tile[r * DP]);
        }
      } else {
        for (int r = warp; r < page_size; r += kWarps) {
          float kx[EPL];
#pragma unroll
          for (int e = 0; e < EPL; ++e) kx[e] = __bfloat162float(tile[r * DP + lane * EPL + e]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) s += qv[g][e] * kx[e];  // exact products
            s = warp_sum(s);
            if (lane == 0) sbuf[g * chunk + j * page_size + r] = s;
          }
          if constexpr (MODE == kFull) {
            if (k == 0 && lane == 0) kcol[j * page_size + r] = kx[0];
          }
        }
      }
    } else {
      if constexpr (MODE == kReshapeOnly) {
        for (int i = tid; i < tile_elems; i += kThreads) own += fabsf(__bfloat162float(tile[i]));
      } else if constexpr (MODE == kFull) {
        for (int r = rs; r < page_size; r += RS) {
          const float v = __bfloat162float(tile[r * DP + d]);
#pragma unroll
          for (int g = 0; g < G; ++g) pv[g] += sbuf[g * chunk + j * page_size + r] * v;
        }
        if (j == CP - 1) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            acc[g] = mul_add(pv[g], acc[g], alpha_s[g]);
            pv[g] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // the slot is free
    if (t + kRing < ntiles) issue(t + kRing);
    cp_async_commit();

    if constexpr (MODE >= kSdotOnly) {
      if (is_k && j == CP - 1) {
        // the chunk's scores are all in sbuf: its statistics, one warp a head
        const int base = c * chunk;
        for (int g = warp; g < G; g += kWarps) {
          float* sg = sbuf + g * chunk;
          if constexpr (MODE == kSdotOnly) {
            float all = 0.f, mag = 0.f;
            for (int i = lane; i < chunk; i += 32) {
              all += sg[i];
              mag += fabsf(sg[i]);
            }
            all = warp_sum(all);
            mag = warp_sum(mag);
            if (lane == 0) {
              l_s[g] += all;
              csum_s[g] += mag;
            }
          } else {
            float mx = kNeg;
            for (int i = lane; i < chunk; i += 32) mx = fmaxf(mx, base + i < len ? sg[i] : kNeg);
            mx = warp_max(mx);
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, mx);
            const float alpha = expf(m_old - m_new);
            float psum = 0.f, k00 = 0.f;
            for (int i = lane; i < chunk; i += 32) {
              const float p = expf((base + i < len ? sg[i] : kNeg) - m_new);
              psum += p;
              if constexpr (MODE == kFull) {
                const float pq = __bfloat162float(__float2bfloat16(p));
                sg[i] = pq;
                if (k == 0 && g == 0) k00 += pq * kcol[i];
              }
            }
            psum = warp_sum(psum);
            k00 = warp_sum(k00);
            if (lane == 0) {
              l_s[g] = mul_add(psum, l_s[g], alpha);
              m_s[g] = m_new;
              alpha_s[g] = alpha;
              if (MODE == kFull && k == 0 && g == 0) acc00_s = mul_add(k00, acc00_s, alpha);
            }
          }
        }
        __syncthreads();  // alpha and bf16(p) for the chunk's V pages
      }
    }
  }
  cp_async_wait<0>();

  // checksums that span the CTA: reshape_only's sum of |x|, full's sum_d
  // |acc[d]| once the row splits of each acc[d] are added up
  if constexpr (MODE == kReshapeOnly || MODE == kFull) {
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = own;
    if constexpr (MODE == kFull) {
      __syncthreads();  // sbuf is free: [g][rs * DP + d] = [g][tid]
#pragma unroll
      for (int g = 0; g < G; ++g) sbuf[g * kThreads + tid] = acc[g];
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
        if (rs == 0) {
          for (int r = 0; r < RS; ++r) a += sbuf[g * kThreads + r * DP + d];
        }
        part[g] = fabsf(a);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float v = warp_sum(part[g]);
      if (lane == 0) red[warp][g] = v;
    }
    __syncthreads();
    if (tid < G) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[w][tid];
      csum_s[tid] = v;
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float nan = __int_as_float(0x7fc00000);
    for (int g = 0; g < G; ++g) {
      float m = kNeg, l = 0.f, cs = 0.f;
      if constexpr (MODE == kDmaOnly) cs = own;
      if constexpr (MODE == kReshapeOnly || MODE == kFull) cs = csum_s[g];
      if constexpr (MODE == kSdotOnly) {
        l = l_s[g];
        cs = csum_s[g];
      }
      if constexpr (MODE >= kNoPv) {
        m = m_s[g];
        l = l_s[g];
      }
      float* a = aux + ((size_t)b * hq + (size_t)k * G + g) * 3;
      a[0] = fits ? m : nan;
      a[1] = fits ? l : nan;
      a[2] = fits ? cs : nan;
    }
    if (k == 0) {
      float a00 = 0.f;
      if constexpr (MODE == kDmaOnly) a00 = own;
      if constexpr (MODE == kReshapeOnly) a00 = col0;
      if constexpr (MODE == kFull) a00 = acc00_s;
      acc00_out[b] = fits ? a00 : nan;
    }
  }
}

// out[b, h, :] = bf16((m + l) + acc00[b]), the JAX probe's statistic
template <int DP>
__global__ void __launch_bounds__(kThreads)
decode_ablate_stat_kernel(const float* __restrict__ aux, const float* __restrict__ acc00,
                          __nv_bfloat16* __restrict__ out, int hq) {
  const int b = blockIdx.x;
  const float a00 = acc00[b];
  for (int i = threadIdx.x; i < hq * DP; i += kThreads) {
    const float* a = aux + ((size_t)b * hq + i / DP) * 3;
    out[(size_t)b * hq * DP + i] = __float2bfloat16(__fadd_rn(__fadd_rn(a[0], a[1]), a00));
  }
}

template <int DP, int G, int MODE>
cudaError_t launch_mode(dim3 grid, size_t smem, cudaStream_t st, const __nv_bfloat16* q,
                        const __nv_bfloat16* kv, const int* pt, const int* lens, float* aux,
                        float* acc00, int hkv, int max_pages, int page_size, int chunk_pages) {
  auto* kern = decode_ablate_kernel<DP, G, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(q, kv, pt, lens, aux, acc00, hkv, max_pages, page_size,
                                     chunk_pages);
  return cudaGetLastError();
}

template <int DP, int G>
cudaError_t launch_g(int mode, dim3 grid, size_t smem, cudaStream_t st, const __nv_bfloat16* q,
                     const __nv_bfloat16* kv, const int* pt, const int* lens, float* aux,
                     float* acc00, int hkv, int max_pages, int page_size, int chunk_pages) {
  switch (mode) {
    case kDmaOnly:
      return launch_mode<DP, G, kDmaOnly>(grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,
                                          max_pages, page_size, chunk_pages);
    case kReshapeOnly:
      return launch_mode<DP, G, kReshapeOnly>(grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,
                                              max_pages, page_size, chunk_pages);
    case kSdotOnly:
      return launch_mode<DP, G, kSdotOnly>(grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,
                                           max_pages, page_size, chunk_pages);
    case kNoPv:
      return launch_mode<DP, G, kNoPv>(grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,
                                       max_pages, page_size, chunk_pages);
    case kFull:
      return launch_mode<DP, G, kFull>(grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,
                                       max_pages, page_size, chunk_pages);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_dp(int G, int mode, dim3 grid, size_t smem, cudaStream_t st,
                      const __nv_bfloat16* q, const __nv_bfloat16* kv, const int* pt,
                      const int* lens, float* aux, float* acc00, __nv_bfloat16* out, int hkv,
                      int max_pages, int page_size, int chunk_pages) {
  cudaError_t err;
#define SPT_ABLATE_CASE(GG)                                                                \
  case GG:                                                                                 \
    err = launch_g<DP, GG>(mode, grid, smem, st, q, kv, pt, lens, aux, acc00, hkv,         \
                           max_pages, page_size, chunk_pages);                             \
    break;
  switch (G) {
    SPT_ABLATE_CASE(1)
    SPT_ABLATE_CASE(2)
    SPT_ABLATE_CASE(3)
    SPT_ABLATE_CASE(4)
    SPT_ABLATE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPT_ABLATE_CASE
  if (err != cudaSuccess) return err;
  decode_ablate_stat_kernel<DP><<<grid.x, kThreads, 0, st>>>(aux, acc00, out, hkv * G);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a CTA needs (bytes), or 0 where it exceeds the card's 227 KB.
extern "C" int decode_ablate_smem_bytes(int num_q_heads, int num_kv_heads, int dp,
                                        int page_size, int chunk_pages) {
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads) return 0;
  const int G = num_q_heads / num_kv_heads;
  const size_t chunk = (size_t)chunk_pages * page_size;
  const size_t bytes = (size_t)kRing * page_size * dp * 2 +
                       (G * (chunk > kThreads ? chunk : kThreads) + chunk) * 4;
  // the static arrays (m, l, alpha, checksums, the reduction) stay under 1 KB
  return bytes + 1024 <= (size_t)kMaxSmem ? static_cast<int>(bytes) : 0;
}

// q [B, Hq, Dp] bf16; kv [pages, page_size, 2 Hkv, Dp] bf16 (K of kv head k in
// lane block 2k, its V in 2k + 1); page_table i32 [B, max_pages]; seq_lens i32
// [B]; mode 0..4 (dma_only, reshape_only, sdot_only, no_pv, full); G = Hq /
// Hkv in {1, 2, 3, 4, 8}, Dp 64 or 128. Writes out
// [B, Hq, Dp] bf16, aux [B, Hq, 3] f32 and acc00 [B] f32 (scratch). Returns a
// cudaError_t (0 = launched).
extern "C" int decode_ablate(const void* q, const void* kv, const void* page_table,
                             const void* seq_lens, void* out, void* aux, void* acc00, int batch,
                             int num_q_heads, int num_kv_heads, int dp, int max_pages,
                             int page_size, int chunk_pages, int mode, void* stream) {
  if (batch == 0) return 0;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads || page_size <= 0 || chunk_pages <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = decode_ablate_smem_bytes(num_q_heads, num_kv_heads, dp, page_size, chunk_pages);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int G = num_q_heads / num_kv_heads;
  const dim3 grid(batch, num_kv_heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kvp = static_cast<const __nv_bfloat16*>(kv);
  const auto* ptp = static_cast<const int*>(page_table);
  const auto* lp = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* ap = static_cast<float*>(aux);
  auto* a00 = static_cast<float*>(acc00);
  cudaError_t err;
  switch (dp) {
    case 64:
      err = launch_dp<64>(G, mode, grid, smem, st, qp, kvp, ptp, lp, ap, a00, op, num_kv_heads,
                          max_pages, page_size, chunk_pages);
      break;
    case 128:
      err = launch_dp<128>(G, mode, grid, smem, st, qp, kvp, ptp, lp, ap, a00, op, num_kv_heads,
                           max_pages, page_size, chunk_pages);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
