// Paged GQA decode attention for Hopper (sm_90a): bf16 KV, or int8 / fp8
// (e4m3) KV with per-(token, head) bf16 scales; f32 accumulation.
//
// Replaces three TPU kernels:
//   scratchpad_tpu/ops/attention/gqa_decode.py, both branches of each (bf16
//   pages, and quantized=True):
//     _gqa_decode_kernel          (per-sequence flash-decode, chunks of 16 pages)
//     _gqa_decode_grouped_kernel  (several short sequences per grid step)
//   scratchpad_tpu/ops/attention/pallas_decode.py (bf16 pages only):
//     _decode_kernel              (one request per grid step, 8-page chunks)
// A TPU core walks its grid in order, so the JAX package needs a second
// kernel to amortise per-step cost over short sequences, and its third one
// differs from the first only in how it schedules page DMAs. On the GPU the
// grid of CTAs runs the sequences in parallel, so this one kernel covers all
// three.
//
// What it computes, for sequence b and kv head h with G = Hq / Hkv:
//   out[b, h*G+g, :] = sum_j softmax_j(sm_scale * q[b, h*G+g] . k_j) v_j
// over the seq_lens[b] cached tokens j of sequence b, found through
// page_table[b, j / page_size]. Rows with seq_lens[b] == 0 (batch padding)
// are written as exact zeros.
//
// Soft cap and static sliding window (gqa_decode.py:171-172, 395-396;
// pallas_decode.py:100-107), runtime arguments uniform over the launch, 0
// meaning none: the score is cap * tanh(s / cap), and only the last W tokens
// (L - W <= j < L) are live. The token loop starts at max(L - W, 0), so a
// window reads W tokens, not L; the Pallas kernels walk from chunk 0 (or
// skip whole chunks below the window) and mask.
//
// Layout: k_cache / v_cache are one layer of the pool, [pages, page_size,
// Hkv, D] row-major; slot s = page * page_size + offset is row s. 8-bit
// pages carry k_scale / v_scale [pages, page_size, Hkv] bf16: element d of
// head h at slot s is code[s, h, d] * scale[s, h].
//
// 8-bit pages (the quantized branch, gqa_decode.py:371-405): the scales
// factor out of the dots, as in the Pallas kernel, so no element is
// dequantized on its own:
//   s = (q . k_code) * s_k,   p' = p * s_v,   acc += p' * v_code
// with the softmax denominator summing p. The Pallas kernel rounds p' to
// bf16 before its PV dot; here p' stays f32. e4m3 codes convert through
// cuda_fp8.h; sub-normal codes never reach the pool (the writer flushes
// them, plain_backend.quantize_rows).
//
// What bounds it: bytes. Every live K and V row is read once, 2 * len * Hkv
// * D * 2 B per sequence for bf16 pages, 2 * len * Hkv * (D + 2) B for 8-bit
// ones, against 4 * len * Hq * D flops: about G flops per byte, far under
// the card's ~295 flop/byte ridge. The design therefore aims at loading each
// K/V element once and keeping many loads in flight:
//   - grid (B, Hkv): the G query heads of a kv head share one CTA, so a K/V
//     row is loaded once for all of them;
//   - 4 warps take tokens round robin, kUnroll tokens at a time, all of
//     their row loads issued before any arithmetic;
//   - each lane owns D/32 contiguous elements of a row, so a warp reads one
//     row as one coalesced 64-256 B access (32-128 B of 8-bit codes; a
//     row's two scales are one broadcast load per warp);
//   - scores reduce with warp shuffles, each warp keeps its own online
//     softmax state in f32, and the warps merge through shared memory.
// Not done yet (later work): a split over the KV axis for small B at long
// context (at B = 1 only Hkv CTAs run), wider vector loads, tensor cores.

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 4;

template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&x)[EPL]) {
  if constexpr (EPL == 1) {
    x[0] = __bfloat162float(p[0]);
  } else if constexpr (EPL == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    x[0] = __low2float(v);
    x[1] = __high2float(v);
  } else {
    static_assert(EPL == 4, "head_dim must be 32, 64 or 128");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    x[0] = __low2float(a);
    x[1] = __high2float(a);
    x[2] = __low2float(b);
    x[3] = __high2float(b);
  }
}

__device__ __forceinline__ float fp8_to_float(uint32_t byte) {
  __nv_fp8_e4m3 c;
  c.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(c);
}

// EPL consecutive 8-bit codes, read as one 1-4 byte access
template <int EPL, typename CodeT>
__device__ __forceinline__ void load_codes(const CodeT* p, float (&x)[EPL]) {
  static_assert(EPL == 1 || EPL == 2 || EPL == 4, "head_dim must be 32, 64 or 128");
  uint32_t raw;
  if constexpr (EPL == 4) {
    raw = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (EPL == 2) {
    raw = *reinterpret_cast<const uint16_t*>(p);
  } else {
    raw = *reinterpret_cast<const uint8_t*>(p);
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const uint32_t byte = (raw >> (8 * e)) & 0xFFu;
    if constexpr (std::is_same_v<CodeT, int8_t>) {
      x[e] = static_cast<float>(static_cast<int8_t>(byte));
    } else {
      x[e] = fp8_to_float(byte);
    }
  }
}

template <int EPL, typename CodeT>
__device__ __forceinline__ void load_kv_row(const CodeT* p, float (&x)[EPL]) {
  if constexpr (std::is_same_v<CodeT, __nv_bfloat16>) {
    load_row<EPL>(p, x);
  } else {
    load_codes<EPL>(p, x);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// CodeT: __nv_bfloat16 (bf16 pages, no scales), int8_t or __nv_fp8_e4m3
// (8-bit pages with k_scale / v_scale)
template <int D, int G, typename CodeT>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const CodeT* __restrict__ k_cache,
                    const CodeT* __restrict__ v_cache,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out, int num_kv_heads,
                    int max_pages, int page_size, float sm_scale, float logit_cap,
                    int window) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  constexpr bool kQuant = !std::is_same_v<CodeT, __nv_bfloat16>;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hq = num_kv_heads * G;
  const int len = seq_lens[b];
  __nv_bfloat16* o = out + ((size_t)b * hq + (size_t)h * G) * D;
  if (len <= 0) {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) o[i] = __float2bfloat16(0.f);
    return;
  }

  float qv[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<EPL>(q + ((size_t)b * hq + (size_t)h * G + g) * D + lane * EPL, qv[g]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[g][e] *= sm_scale;
  }

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const int* pt = page_table + (size_t)b * max_pages;
  const size_t row_stride = (size_t)num_kv_heads * D;
  const size_t head_off = (size_t)h * D + lane * EPL;

  // the window's first token; the softmax over [first, len) is the masked
  // softmax over [0, len)
  const int first = (window > 0 && len > window) ? len - window : 0;
  for (int t0 = first + warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float kx[kUnroll][EPL], vx[kUnroll][EPL];
    float sk[kUnroll], sv[kUnroll];  // the rows' scales (8-bit pages)
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const size_t row = (size_t)pt[t / page_size] * page_size + t % page_size;
        load_kv_row<EPL>(k_cache + row * row_stride + head_off, kx[u]);
        load_kv_row<EPL>(v_cache + row * row_stride + head_off, vx[u]);
        if constexpr (kQuant) {
          sk[u] = __bfloat162float(k_scale[row * num_kv_heads + h]);
          sv[u] = __bfloat162float(v_scale[row * num_kv_heads + h]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < len) {  // uniform across the warp
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s += qv[g][e] * kx[u][e];
          s = warp_sum(s);
          if constexpr (kQuant) s *= sk[u];
          if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);  // uniform branch
          const float m_new = fmaxf(m[g], s);
          const float alpha = __expf(m[g] - m_new);
          const float p = __expf(s - m_new);
          l[g] = l[g] * alpha + p;
          float pv = p;  // p' = p * s_v weighs the raw V codes
          if constexpr (kQuant) pv *= sv[u];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + pv * vx[u][e];
          m[g] = m_new;
        }
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = __expf(sm_m[w][g] - mx);  // 0 for a warp that saw no token
      den += sm_l[w][g] * sc;
      num += sm_acc[w][g][d] * sc;
    }
    o[i] = __float2bfloat16(num / den);
  }
}

template <int D, typename CodeT>
cudaError_t launch_for_d(int G, dim3 grid, cudaStream_t st, const __nv_bfloat16* q,
                         const CodeT* k, const CodeT* v, const __nv_bfloat16* ks,
                         const __nv_bfloat16* vs, const int* pt, const int* lens,
                         __nv_bfloat16* out, int hkv, int max_pages, int page_size,
                         float sm_scale, float logit_cap, int window) {
  const dim3 block(kWarps * 32);
#define SPT_DECODE_CASE(GG)                                                               \
  case GG:                                                                                \
    paged_decode_kernel<D, GG, CodeT><<<grid, block, 0, st>>>(                           \
        q, k, v, ks, vs, pt, lens, out, hkv, max_pages, page_size, sm_scale, logit_cap,   \
        window);                                                                          \
    break;
  switch (G) {
    SPT_DECODE_CASE(1)
    SPT_DECODE_CASE(2)
    SPT_DECODE_CASE(3)
    SPT_DECODE_CASE(4)
    SPT_DECODE_CASE(5)
    SPT_DECODE_CASE(6)
    SPT_DECODE_CASE(7)
    SPT_DECODE_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef SPT_DECODE_CASE
  return cudaGetLastError();
}

template <typename CodeT>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* page_table, const void* seq_lens, void* out,
           int batch, int num_q_heads, int num_kv_heads, int head_dim, int max_pages,
           int page_size, float sm_scale, float logit_cap, int window, void* stream) {
  if (batch == 0) return 0;
  if (logit_cap < 0.f || window < 0) return cudaErrorInvalidValue;
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads != 0) return cudaErrorInvalidValue;
  const int G = num_q_heads / num_kv_heads;
  const dim3 grid(batch, num_kv_heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const CodeT*>(k_cache);
  const auto* vp = static_cast<const CodeT*>(v_cache);
  const auto* ksp = static_cast<const __nv_bfloat16*>(k_scale);
  const auto* vsp = static_cast<const __nv_bfloat16*>(v_scale);
  const auto* ptp = static_cast<const int*>(page_table);
  const auto* lp = static_cast<const int*>(seq_lens);
  auto* op = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (head_dim) {
    case 32:
      err = launch_for_d<32>(G, grid, st, qp, kp, vp, ksp, vsp, ptp, lp, op, num_kv_heads,
                             max_pages, page_size, sm_scale, logit_cap, window);
      break;
    case 64:
      err = launch_for_d<64>(G, grid, st, qp, kp, vp, ksp, vsp, ptp, lp, op, num_kv_heads,
                             max_pages, page_size, sm_scale, logit_cap, window);
      break;
    case 128:
      err = launch_for_d<128>(G, grid, st, qp, kp, vp, ksp, vsp, ptp, lp, op, num_kv_heads,
                              max_pages, page_size, sm_scale, logit_cap, window);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// q [B, Hq, D] bf16; k_cache, v_cache [pages, page_size, Hkv, D] bf16;
// page_table i32 [B, max_pages]; seq_lens i32 [B]; out [B, Hq, D] bf16;
// logit_cap > 0 caps the scores (0: no cap); window > 0 keeps the last
// window tokens (0: all). Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* page_table,
                                      const void* seq_lens, void* out, int batch,
                                      int num_q_heads, int num_kv_heads, int head_dim,
                                      int max_pages, int page_size, float sm_scale,
                                      float logit_cap, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, page_table, seq_lens,
                               out, batch, num_q_heads, num_kv_heads, head_dim, max_pages,
                               page_size, sm_scale, logit_cap, window, stream);
}

// As paged_decode_attention over 8-bit pages: k_cache, v_cache [pages,
// page_size, Hkv, D] of int8 (code_type 0) or fp8 e4m3 (code_type 1) codes;
// k_scale, v_scale [pages, page_size, Hkv] bf16.
extern "C" int paged_decode_attention_quant(const void* q, const void* k_cache,
                                            const void* v_cache, const void* k_scale,
                                            const void* v_scale, const void* page_table,
                                            const void* seq_lens, void* out, int batch,
                                            int num_q_heads, int num_kv_heads, int head_dim,
                                            int max_pages, int page_size, int code_type,
                                            float sm_scale, float logit_cap, int window,
                                            void* stream) {
  switch (code_type) {
    case 0:
      return launch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, page_table, seq_lens, out,
                            batch, num_q_heads, num_kv_heads, head_dim, max_pages, page_size,
                            sm_scale, logit_cap, window, stream);
    case 1:
      return launch<__nv_fp8_e4m3>(q, k_cache, v_cache, k_scale, v_scale, page_table,
                                   seq_lens, out, batch, num_q_heads, num_kv_heads, head_dim,
                                   max_pages, page_size, sm_scale, logit_cap, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
