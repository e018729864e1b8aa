// Paged ragged causal extend (prefill) attention for Hopper (sm_90a): bf16
// q and out over bf16 pages, or over int8 / fp8 (e4m3) pages with
// per-(token, head) bf16 scales; f32 accumulation.
//
// Replaces the TPU kernel the JAX package runs for every prefill and
// chunked-prefill step: the bundled Pallas
// jax.experimental.pallas.ops.tpu.ragged_paged_attention, launched by
// scratchpad_tpu/ops/attention/ragged_backend.py::_ragged_call. For int8 /
// fp8 pools the JAX package first dequantizes the batch's pages into a bf16
// scratch pool (ragged_backend.py::dequant_pages, attention_ragged_quant),
// because the bundled kernel has no per-row scales. This kernel reads the
// codes and scales itself and dequantizes each K/V element in f32 as it
// stages the tile into shared memory: no scratch pool, and the pages move
// at 1 B per element plus 2 B per (token, head) instead of being read once
// in 8 bits and then written and read again in bf16.
//
// What it computes: the batch is a flat ragged run of T query tokens;
// sequence s owns tokens [cu_q_lens[s], cu_q_lens[s+1]) and has kv_lens[s]
// cached tokens (its new tokens included, written before this call). Its
// query i sits at the tail of the cache and attends kv positions
// [0, kv_lens[s] - q_len_s + i]: causal, aligned to the tail, which also
// covers a chunk that follows a cached radix prefix. Query head h*G+g reads
// kv head h. Tokens past cu_q_lens[B] (batch padding) are written as zeros.
//
// Soft cap and static sliding window (the bundled kernel's soft_cap and
// sliding_window, ragged_backend.py:98-99; xla_backend.py:477-478), runtime
// arguments uniform over the launch, 0 meaning none: the score is
// cap * tanh(s / cap), and the query at position p attends p - W < j <= p.
//
// What bounds it: operations at the main path's prefill shapes. A chunk of
// n new tokens over a cache of c tokens costs about 4 * Hq * D * n * (c +
// n/2) flops against (n * Hq + 2 * (c + n) * Hkv) * D * 2 B moved, so above a
// few hundred tokens it is far past the card's ~295 flop/byte ridge.
// This first version is simple and right rather than fast: tiled flash
// attention on CUDA cores, not tensor cores.
//   - A CTA takes one tile of bq = 64 / G query tokens of ONE sequence times
//     the G query heads of ONE kv head: 64 (token, head) rows, so every K/V
//     tile it loads serves all G heads. Grid (tiles, Hkv); the wrapper builds
//     the tile -> sequence map (tile_seq, tile_cum) on the device.
//   - K/V tiles of 64 tokens go through shared memory (K transposed, rows
//     padded by one float against bank conflicts); each of the 128 threads
//     owns a 4 x 8 block of the 64 x 64 score tile and 4 rows x D/8 columns
//     of the output, with online softmax state in f32 registers.
//   - The KV loop stops at the tile's last causal position, so a tile never
//     reads the cache past what its queries may see, and with a window it
//     starts at the KV tile that holds its first query's first live position;
//     each row masks its own window edge inside (it may fall inside a tile
//     and inside a page). A tile of bq queries under a window W thus reads
//     about W + bq keys, whatever the cache's length.
// Not done yet (later work): wgmma / mma.sync tensor-core products,
// cp.async or TMA double buffering, vector loads.

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // (query token, head-in-group) rows per CTA
constexpr int kBK = 64;    // kv tokens per tile
constexpr int kThreads = 128;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kRows * (D + 1) + D * (kBK + 1) + kBK * D + kRows * (kBK + 1));
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// CodeT: __nv_bfloat16 (bf16 pages, no scales), int8_t or __nv_fp8_e4m3
// (8-bit pages with k_scale / v_scale [pages, page_size, Hkv] bf16)
template <int D, typename CodeT>
__global__ void __launch_bounds__(kThreads)
paged_extend_kernel(const __nv_bfloat16* __restrict__ q,
                    const CodeT* __restrict__ k_cache,
                    const CodeT* __restrict__ v_cache,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ cu_q_lens,
                    const int* __restrict__ tile_seq,
                    const int* __restrict__ tile_cum,
                    __nv_bfloat16* __restrict__ out, int num_seqs, int num_tokens,
                    int num_kv_heads, int G, int max_pages, int page_size,
                    float sm_scale, float logit_cap, int window) {
  constexpr int DC = D / 8;  // output columns per thread
  constexpr bool kQuant = !std::is_same_v<CodeT, __nv_bfloat16>;
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kRows][D + 1]
  float* Ks = Qs + kRows * (D + 1);     // [D][kBK + 1], transposed
  float* Vs = Ks + D * (kBK + 1);       // [kBK][D]
  float* Ps = Vs + kBK * D;             // [kRows][kBK + 1]

  const int tid = threadIdx.x;
  const int tr = tid >> 3;  // row group: rows tr + 16 * r
  const int tc = tid & 7;   // column group: cols tc + 8 * c
  const int h = blockIdx.y;
  const int tile = blockIdx.x;
  const int hq = num_kv_heads * G;
  const int bq = kRows / G;  // query tokens per tile
  const int s = tile_seq[tile];

  if (s >= num_seqs) {
    // tiles past the real sequences zero the padding tokens
    const int first_pad_tile = num_seqs > 0 ? tile_cum[num_seqs - 1] : 0;
    const int t0 = cu_q_lens[num_seqs] + (tile - first_pad_tile) * bq;
    for (int i = tid; i < bq * G * D; i += kThreads) {
      const int tok = t0 + i / (G * D);
      if (tok < num_tokens)
        out[((size_t)tok * hq + (size_t)h * G) * D + i % (G * D)] = __float2bfloat16(0.f);
    }
    return;
  }

  const int q_start = cu_q_lens[s];
  const int q_len = cu_q_lens[s + 1] - q_start;
  const int tiles_s = (q_len + bq - 1) / bq;
  const int i0 = (tile - (tile_cum[s] - tiles_s)) * bq;  // first query of this tile
  const int n_q = min(bq, q_len - i0);
  const int n_rows = n_q * G;
  const int kv_len = kv_lens[s];
  const int ctx = kv_len - q_len;  // cached tokens before this chunk
  const int kv_end = min(kv_len, ctx + i0 + n_q);  // exclusive bound of kv reads

  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float val = 0.f;
    if (r < n_rows) {
      const int tok = q_start + i0 + r / G;
      val = __bfloat162float(q[((size_t)tok * hq + (size_t)h * G + r % G) * D + d]) * sm_scale;
    }
    Qs[r * (D + 1) + d] = val;
  }

  // the kv positions [lo, lim] each of this thread's rows may attend
  int lo[4], lim[4];
  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = tr + 16 * r;
    lim[r] = row < n_rows ? ctx + i0 + row / G : -1;
    lo[r] = window > 0 ? lim[r] - window + 1 : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[r][c] = 0.f;
  }

  const int* pt = page_table + (size_t)s * max_pages;
  const size_t row_stride = (size_t)num_kv_heads * D;

  // the first kv tile any row of this tile may see: the first query's window
  const int kv_begin = window > 0 ? max(ctx + i0 - window + 1, 0) / kBK * kBK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx % D;
      const int pos = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kv_end) {
        const size_t row = (size_t)pt[pos / page_size] * page_size + pos % page_size;
        const size_t off = row * row_stride + (size_t)h * D + d;
        kx = to_float(k_cache[off]);
        vx = to_float(v_cache[off]);
        if constexpr (kQuant) {  // code * its (token, head) scale
          const size_t srow = row * num_kv_heads + h;
          kx *= __bfloat162float(k_scale[srow]);
          vx *= __bfloat162float(v_scale[srow]);
        }
      }
      Ks[d * (kBK + 1) + j] = kx;
      Vs[j * D + d] = vx;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) sc[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[r] = Qs[(tr + 16 * r) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < 8; ++c) kb[c] = Ks[d * (kBK + 1) + tc + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) sc[r][c] += qa[r] * kb[c];
    }

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int pos = k0 + tc + 8 * c;
        if (logit_cap > 0.f) sc[r][c] = logit_cap * tanhf(sc[r][c] / logit_cap);
        if (pos > lim[r] || pos < lo[r]) sc[r][c] = -INFINITY;
        mt = fmaxf(mt, sc[r][c]);
      }
      mt = group8_max(mt);
      const float m_new = fmaxf(m[r], mt);
      alpha[r] = m_new == -INFINITY ? 1.f : __expf(m[r] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float p = sc[r][c] == -INFINITY ? 0.f : __expf(sc[r][c] - m_new);
        sc[r][c] = p;
        rs += p;
      }
      rs = group8_sum(rs);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) Ps[(tr + 16 * r) * (kBK + 1) + tc + 8 * c] = sc[r][c];
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) o[r][c] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[4], vb[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = Ps[(tr + 16 * r) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vb[c] = Vs[j * D + tc + 8 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) o[r][c] += pa[r] * vb[c];
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = tr + 16 * r;
    if (row < n_rows) {
      const int tok = q_start + i0 + row / G;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* dst = out + ((size_t)tok * hq + (size_t)h * G + row % G) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) dst[tc + 8 * c] = __float2bfloat16(o[r][c] * inv);
    }
  }
}

template <int D, typename CodeT>
cudaError_t launch_for_d(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const CodeT* k,
                         const CodeT* v, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                         const int* pt, const int* kv_lens, const int* cu_q,
                         const int* tile_seq, const int* tile_cum, __nv_bfloat16* out,
                         int num_seqs, int num_tokens, int hkv, int G, int max_pages,
                         int page_size, float sm_scale, float logit_cap, int window) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(paged_extend_kernel<D, CodeT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  paged_extend_kernel<D, CodeT><<<grid, kThreads, bytes, st>>>(
      q, k, v, ks, vs, pt, kv_lens, cu_q, tile_seq, tile_cum, out, num_seqs, num_tokens, hkv,
      G, max_pages, page_size, sm_scale, logit_cap, window);
  return cudaGetLastError();
}

template <typename CodeT>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* page_table, const void* kv_lens,
           const void* cu_q_lens, const void* tile_seq, const void* tile_cum, void* out,
           int num_tiles, int num_seqs, int num_tokens, int num_q_heads, int num_kv_heads,
           int head_dim, int max_pages, int page_size, float sm_scale, float logit_cap,
           int window, void* stream) {
  if (num_tiles == 0 || num_tokens == 0) return 0;
  if (logit_cap < 0.f || window < 0) return cudaErrorInvalidValue;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) return cudaErrorInvalidValue;
  const int G = num_q_heads / num_kv_heads;
  if (G > kRows) return cudaErrorInvalidValue;
  const dim3 grid(num_tiles, num_kv_heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const CodeT*>(k_cache);
  const auto* vp = static_cast<const CodeT*>(v_cache);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* ptp = static_cast<const int*>(page_table);
  const auto* klp = static_cast<const int*>(kv_lens);
  const auto* cqp = static_cast<const int*>(cu_q_lens);
  const auto* tsp = static_cast<const int*>(tile_seq);
  const auto* tcp = static_cast<const int*>(tile_cum);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = launch_for_d<32>(grid, st, qp, kp, vp, ksp, vsp, ptp, klp, cqp, tsp, tcp, op,
                             num_seqs, num_tokens, num_kv_heads, G, max_pages, page_size,
                             sm_scale, logit_cap, window);
      break;
    case 64:
      err = launch_for_d<64>(grid, st, qp, kp, vp, ksp, vsp, ptp, klp, cqp, tsp, tcp, op,
                             num_seqs, num_tokens, num_kv_heads, G, max_pages, page_size,
                             sm_scale, logit_cap, window);
      break;
    case 128:
      err = launch_for_d<128>(grid, st, qp, kp, vp, ksp, vsp, ptp, klp, cqp, tsp, tcp, op,
                              num_seqs, num_tokens, num_kv_heads, G, max_pages, page_size,
                              sm_scale, logit_cap, window);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// Query tokens of one sequence per CTA tile for G query heads per kv head;
// the wrapper sizes its tile map with it.
extern "C" int paged_extend_tokens_per_tile(int group) {
  return group > 0 && group <= kRows ? kRows / group : 0;
}

// q [T, Hq, D] bf16; k_cache, v_cache [pages, page_size, Hkv, D] bf16;
// page_table i32 [B, max_pages]; kv_lens i32 [B]; cu_q_lens i32 [B + 1];
// tile_seq i32 [num_tiles] (sequence of each tile, B for padding tiles);
// tile_cum i32 [B] (inclusive prefix sum of tiles per sequence);
// out [T, Hq, D] bf16; logit_cap > 0 caps the scores (0: no cap); window > 0
// keeps the last window positions up to each query's own (0: all). Returns
// a cudaError_t (0 = launched).
extern "C" int paged_extend_attention(const void* q, const void* k_cache, const void* v_cache,
                                      const void* page_table, const void* kv_lens,
                                      const void* cu_q_lens, const void* tile_seq,
                                      const void* tile_cum, void* out, int num_tiles,
                                      int num_seqs, int num_tokens, int num_q_heads,
                                      int num_kv_heads, int head_dim, int max_pages,
                                      int page_size, float sm_scale, float logit_cap,
                                      int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, page_table, kv_lens,
                               cu_q_lens, tile_seq, tile_cum, out, num_tiles, num_seqs,
                               num_tokens, num_q_heads, num_kv_heads, head_dim, max_pages,
                               page_size, sm_scale, logit_cap, window, stream);
}

// As paged_extend_attention over 8-bit pages: k_cache, v_cache of int8
// (code_type 0) or fp8 e4m3 (code_type 1) codes; k_scale, v_scale
// [pages, page_size, Hkv] bf16.
extern "C" int paged_extend_attention_quant(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* page_table, const void* kv_lens, const void* cu_q_lens,
    const void* tile_seq, const void* tile_cum, void* out, int num_tiles, int num_seqs,
    int num_tokens, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
    int page_size, int code_type, float sm_scale, float logit_cap, int window, void* stream) {
  switch (code_type) {
    case 0:
      return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens,
                            cu_q_lens, tile_seq, tile_cum, out, num_tiles, num_seqs,
                            num_tokens, num_q_heads, num_kv_heads, head_dim, max_pages,
                            page_size, sm_scale, logit_cap, window, stream);
    case 1:
      return launch<__nv_fp8_e4m3>(q, k_cache, v_cache, k_scale, v_scale, page_table, kv_lens,
                                   cu_q_lens, tile_seq, tile_cum, out, num_tiles, num_seqs,
                                   num_tokens, num_q_heads, num_kv_heads, head_dim, max_pages,
                                   page_size, sm_scale, logit_cap, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
