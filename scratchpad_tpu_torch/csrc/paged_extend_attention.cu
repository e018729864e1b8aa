// Paged ragged causal extend (prefill) attention for Hopper (sm_90a): bf16
// q and out over bf16 pages, or over int8 / fp8 (e4m3) pages with
// per-(token, head) bf16 scales; both products on the tensor cores (wgmma),
// f32 accumulation.
//
// Replaces the TPU kernel the JAX package runs for every prefill and
// chunked-prefill step: the bundled Pallas
// jax.experimental.pallas.ops.tpu.ragged_paged_attention, launched by
// scratchpad_tpu/ops/attention/ragged_backend.py::_ragged_call. For int8 /
// fp8 pools the JAX package first dequantizes the batch's pages into a bf16
// scratch pool (ragged_backend.py::dequant_pages, attention_ragged_quant),
// because the bundled kernel has no per-row scales. This kernel reads the
// codes and scales itself: no scratch pool, and the pages move at 1 B per
// element plus 2 B per (token, head).
//
// What it computes: the batch is a flat ragged run of T query tokens;
// sequence s owns tokens [cu_q_lens[s], cu_q_lens[s+1]) and has kv_lens[s]
// cached tokens (its new tokens included, written before this call). Its
// query i sits at the tail of the cache and attends kv positions
// [0, kv_lens[s] - q_len_s + i]: causal, aligned to the tail, which also
// covers a chunk that follows a cached radix prefix. Query head h*G+g reads
// kv head h. Tokens past cu_q_lens[B] (batch padding) are written as zeros.
// Soft cap and static sliding window (the bundled kernel's soft_cap and
// sliding_window, ragged_backend.py:98-99; xla_backend.py:477-478), runtime
// arguments uniform over the launch, 0 meaning none: the score is
// cap * tanh(s / cap), and the query at position p attends p - W < j <= p.
//
// What bounds it: operations at the main path's prefill shapes. A chunk of
// n new tokens over a cache of c tokens costs about 4 * Hq * D * n * (c +
// n/2) flops against (n * Hq + 2 * (c + n) * Hkv) * D * 2 B moved, so above a
// few hundred tokens it is far past the card's ~295 flop/byte ridge. The
// design is flash attention on the tensor cores:
//   - A CTA takes one tile of bq = 128 / G query tokens of ONE sequence
//     times the G query heads of ONE kv head: 128 (token, head) rows in two
//     warpgroups of 64 (one wgmma M tile each), so every K/V tile it loads
//     serves all G heads and both warpgroups. Grid (tiles, Hkv), walked from
//     the last tile so that the tiles with the most KV start first; the
//     wrapper builds the tile -> sequence map (tile_seq, tile_cum).
//   - Warp specialised: a producer warpgroup (56 registers a thread, by
//     setmaxnreg) fills a ring of four K/V stages in shared memory with
//     cp.async in 16-byte pieces and hands each to the two compute
//     warpgroups (224 registers) through full / empty mbarriers, so loads
//     run ahead of the math and the compute warpgroups never wait for each
//     other. The stages are 128-byte-swizzled rows that are the wgmma
//     operands as they land: K [64 tokens][D] is the K-major B of S = QK^T,
//     V [64 tokens][D] the MN-major (transposed) B of O += PV. Q is loaded
//     once, in bf16, unscaled; sm_scale (times log2 e) is applied to the f32
//     scores. head_dim 32 is padded to 64 with zero columns.
//   - S = QK^T: wgmma m64n64k16, A and B from shared memory. O += PV: wgmma
//     m64n{64,128}k16 with A = P from registers: the S accumulator's layout
//     is the A fragment's. One bf16 rounding of P costs up to 12x the
//     kernel-vs-plain gate (tests/test_torch_extend_tiles.py), so P is split
//     into P_hi = bf16(P) and P_lo = bf16(P - P_hi), two products over the
//     same V tile; the row sum l is taken from the unrounded f32 P. On
//     8-bit pages a third term, bf16(P - P_hi - P_lo), brings P to f32
//     accuracy: those engines quantize each new K/V row on their kernel and
//     plain paths alike, which turns the two-term split's 2^-17 into code
//     flips, and the 3B W4A8 engine's argmax gate failed on one row.
//   - 8-bit pages: the codes land at 1 B per element in a ring of their
//     own, and the producer converts them to the bf16 operand stages (int8
//     and e4m3 are exact in bf16) with the tile's 64 K and 64 V scales
//     beside them; score column j is multiplied by its K scale in f32, and
//     the V scale is folded into P (P' = p * s_v) before the split.
//   - On bf16 pages a compute warpgroup pipelines across tiles: it issues
//     S_t = Q K_t and the previous tile's O += P V together, and runs tile
//     t's softmax while that PV is on the tensor cores.
//   - The KV loop stops at the tile's last causal position and, under a
//     window, starts at the KV tile that holds its first query's first live
//     position; a thread masks only a tile that crosses its rows' causal or
//     window edge, each row by its own bounds.
//   - The epilogue normalises by l (rows with l == 0 are exact zeros),
//     rounds to bf16 and stores 16 bytes a thread through shared memory.
// Not done yet (later work): TMA loads, 128-token KV tiles, more than one
// CTA on an SM for the short prefill chunks.

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

// Stage cuts, for timing only (the output is then not attention): 1 stops
// each kv tile once it has landed (bf16 pages) or been converted (8-bit
// pages); 4 skips the copies (bf16 pages: after the first ring's worth of
// tiles), so the rest computes on stale stages; 0 is the kernel.
// tools/extend_stages.py times them.
#ifndef SPTPU_EXTEND_CUT
#define SPTPU_EXTEND_CUT 0
#endif
namespace {

constexpr int kRows = 128;       // (query token, head-in-group) rows per CTA
constexpr int kBK = 64;          // kv tokens per tile
constexpr int kConsumers = 256;  // two warpgroups of 64 rows compute
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup loads
constexpr int kCodeAhead = 4;  // 8-bit pages: code tiles in flight ahead of conversion
constexpr int kCodeRing = kCodeAhead + 1;
constexpr int kBlock = 64;       // bf16 elements in one 128-byte swizzled row
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, byte offsets from a 1024-aligned base (the 128-byte
// swizzle repeats every 1024 bytes). A bf16 tile of R rows is NB column
// blocks of [R][128 B].
template <int D, bool kQuant>
struct Smem {
  static constexpr int DP = D < kBlock ? kBlock : D;  // padded head_dim
  static constexpr int NB = DP / kBlock;
  static constexpr int kQBlock = kRows * 128;
  static constexpr int kTBlock = kBK * 128;
  static constexpr int kTile = NB * kTBlock;  // one bf16 K or V tile
  // the ring of bf16 K and V operand tiles [kRing][NB][64][128 B] each: four
  // stages, or three beside the 8-bit pages' own ring of codes
  static constexpr int kRing = kQuant ? 3 : 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + NB * kQBlock;
  static constexpr int kV = kK + kRing * kTile;
  // 8-bit pages: the ring's f32 scales [kRing][K, V][64], and the codes'
  // own ring [kCodeRing][K, V][64][D] with their scales [kCodeRing][K, V][64]
  static constexpr int kCodeTile = kBK * D;
  static constexpr int kScales = kV + kRing * kTile;
  static constexpr int kCodes = kScales + (kQuant ? kRing * 2 * kBK * 4 : 0);
  static constexpr int kCodeScales = kCodes + (kQuant ? kCodeRing * 2 * kCodeTile : 0);
  static constexpr int kBars = kCodeScales + (kQuant ? kCodeRing * 2 * kBK * 4 : 0);
  static constexpr int kBytes = kBars + 2 * kRing * 8;  // u64 full[kRing], empty[kRing]
  static constexpr size_t kDynamic = kBytes + 1024;  // room to align the base
};

template <int D, bool kQuant>
constexpr size_t smem_bytes() { return Smem<D, kQuant>::kDynamic; }

// the compute warpgroups only (the producer warp does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}
__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// e4m3: through f16, where every e4m3 value is exact
__device__ __forceinline__ void codes_to_bf16(uint32_t word, __nv_fp8_e4m3, uint32_t& lo, uint32_t& hi) {
  const __half2_raw h0 = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word & 0xFFFFu), __NV_E4M3);
  const __half2_raw h1 = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(word >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(h0));
  const float2 b = __half22float2(__half2(h1));
  lo = pack_bf16(a.x, a.y);
  hi = pack_bf16(b.x, b.y);
}

// CodeT: __nv_bfloat16 (bf16 pages, no scales), int8_t or __nv_fp8_e4m3
// (8-bit pages with k_scale / v_scale [pages, page_size, Hkv] bf16)
template <int D, typename CodeT>
__global__ void __launch_bounds__(kThreads, 1)
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
  constexpr bool kQuant = !std::is_same_v<CodeT, __nv_bfloat16>;
  using S = Smem<D, kQuant>;
  constexpr int kRing = S::kRing;
  // P in bf16 terms: hi + lo, and on 8-bit pages a third, the rest of P to
  // f32 accuracy (see the notes above); setmaxnreg's split of the 64,512
  // registers the launch holds (168 x 384): 128 x 56 + 256 x 224
  constexpr int kPTerms = kQuant ? 3 : 2;
  // The third term's registers do not fit beside the previous tile's P, so
  // on 8-bit pages a tile's PV runs after its own softmax, not across the
  // next tile's (those kernels are bound by the producer's conversion).
  constexpr bool kPipelined = kPTerms == 2;
  constexpr int kProducerRegs = 56;
  constexpr int kConsumerRegs = 224;
  constexpr int DP = S::DP;
  constexpr int NO = DP / 2;  // O accumulator floats a thread (m64 x DP)
  constexpr int CPR = D / 8;  // 16-byte chunks of a bf16 row of D

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* sm = smem_raw + pad;  // 1024-aligned, generic address
  const uint32_t sb = raw + pad;  // the same, shared-window address

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the tiles with the most KV first
  const int hq = num_kv_heads * G;
  const int bq = kRows / G;  // query tokens per tile
  const int s = tile_seq[tile];

  if (s >= num_seqs) {
    // tiles past the real sequences zero the padding tokens
    const int first_pad_tile = num_seqs > 0 ? tile_cum[num_seqs - 1] : 0;
    const int t0 = cu_q_lens[num_seqs] + (tile - first_pad_tile) * bq;
    const int per_tok = G * CPR;
    for (int i = tid; i < bq * per_tok; i += kThreads) {
      const int tok = t0 + i / per_tok;
      if (tok < num_tokens)
        *reinterpret_cast<uint4*>(out + ((size_t)tok * hq + (size_t)h * G) * D +
                                  (i % per_tok) * 8) = make_uint4(0, 0, 0, 0);
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
  // the first kv tile any row of this tile may see: the first query's window
  const int kv_begin = window > 0 ? max(ctx + i0 - window + 1, 0) / kBK * kBK : 0;
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;

  if constexpr (D < DP) {  // the padding columns stay zero throughout
    for (int i = tid; i < S::kBars / 16; i += kThreads)
      reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  }

  // Q, once: row r is token r / G, head r % G; rows past n_rows are zero
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int r = i / CPR;
    const int c = i % CPR;
    const bool ok = r < n_rows;
    const int tok = q_start + i0 + (ok ? r / G : 0);
    const __nv_bfloat16* src = q + ((size_t)tok * hq + (size_t)h * G + (ok ? r % G : 0)) * D + c * 8;
    cp_async16(sb + S::kQ + (c / 8) * S::kQBlock + swz(r, c % 8), src, ok);
  }

  cp_async_commit();
  const uint32_t bars = sb + S::kBars;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kRing + st); };
  if (tid == 0) {
    for (int st = 0; st < kRing; ++st) {
      mbar_init(full(st), 128);  // one arrival a producer thread
      mbar_init(empty(st), kConsumers / 32);  // one arrival a compute warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait<0>();  // Q
  fence_async_shared();
  __syncthreads();

  const int* pt = page_table + (size_t)s * max_pages;
  const size_t row_stride = (size_t)num_kv_heads * D;
  auto pool_row = [&](int t, int j) -> int {  // -1: past kv_end (or no tile t)
    const int pos = kv_begin + t * kBK + j;
    return t < n_tiles && pos < kv_end ? pt[pos / page_size] * page_size + pos % page_size : -1;
  };

  if (tid >= kConsumers) {
    // The producer warpgroup fills the ring: thread p copies 16-byte piece
    // p + 128 n of the tile's K and of its V (token (p + 128 n) / CH),
    // zero-filling positions past kv_end, and arrives on full[stage] once
    // the stage holds the tile. Each of its warps reads the next tile's 64
    // pool rows (lane l: tokens l and l + 32) while this tile's copies are
    // issued, and hands them round with shuffles. It waits on empty[stage]
    // before it writes the stage again.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kConsumers;
    const int lane = p & 31;
    if constexpr (!kQuant) {  // bf16 pages: copied straight into the ring
      constexpr int CH = CPR;  // 16-byte pieces of a K or V row
      constexpr int NP = kBK * CH / 128;
      int rr[2] = {pool_row(0, lane), pool_row(0, lane + 32)};
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kRing;
        mbar_wait(empty(st), ((t / kRing) & 1) ^ 1);
        const int r0 = rr[0], r1 = rr[1];
        rr[0] = pool_row(t + 1, lane);
        rr[1] = pool_row(t + 1, lane + 32);
        if (SPTPU_EXTEND_CUT == 4 && t >= kRing) {  // timing cut: no copies
          mbar_arrive(full(st));
          continue;
        }
#pragma unroll 2
        for (int n = 0; n < NP; ++n) {
          const int i = p + 128 * n;
          const int j = i / CH;
          const int c = i % CH;
          // the warp's 32 pieces lie in 32 / CH tokens on the same side of 32
          const int r = __shfl_sync(0xffffffffu, ((p & ~31) + 128 * n) / CH < 32 ? r0 : r1, j % 32);
          const bool ok = r >= 0;
          const size_t row = ok ? (size_t)r : 0;
          const size_t off = row * row_stride + (size_t)h * D + c * 8;
          const uint32_t o = st * S::kTile + (c / 8) * S::kTBlock + swz(j, c % 8);
          cp_async16(sb + S::kK + o, k_cache + off, ok);
          cp_async16(sb + S::kV + o, v_cache + off, ok);
        }
        mbar_arrive_copies(full(st));
      }
    } else {
      // 8-bit pages: the codes of tile t + kCodeAhead land in the code ring
      // while tile t converts to the bf16 operand ring (int8 and e4m3 are
      // exact in bf16). Thread p also carries K's (p < 64) or V's scale of
      // token p % 64, loaded with its codes and stored one iteration later.
      // A tile's copies are issued after the previous tile's proxy fence,
      // which would otherwise wait for them.
      constexpr int CH = D / 16;  // 16-byte pieces of a code row
      constexpr int NP = kBK * CH / 128;
      constexpr int NC = 2 * kBK * CH / 128;  // 16-code pieces a thread converts
      float* cscl = reinterpret_cast<float*>(sm + S::kCodeScales);
      auto issue = [&](int u, int r0, int r1) {
        const int cs = u % kCodeRing;
#pragma unroll 2
        for (int n = 0; n < NP; ++n) {
          const int i = p + 128 * n;
          const int j = i / CH;
          const int c = i % CH;
          const int r = __shfl_sync(0xffffffffu, ((p & ~31) + 128 * n) / CH < 32 ? r0 : r1, j % 32);
          const bool ok = r >= 0 && SPTPU_EXTEND_CUT != 4;
          const size_t off = (r >= 0 ? (size_t)r : 0) * row_stride + (size_t)h * D + c * 16;
          const uint32_t o = S::kCodes + 2 * cs * S::kCodeTile + j * D + c * 16;
          cp_async16(sb + o, k_cache + off, ok);
          cp_async16(sb + o + S::kCodeTile, v_cache + off, ok);
        }
        cp_async_commit();
      };
      auto scale_of = [&](int r0, int r1) -> float {
        const int r = (p >> 5) & 1 ? r1 : r0;
        return r < 0 ? 0.f
                     : __bfloat162float((p < kBK ? k_scale : v_scale)[(size_t)r * num_kv_heads + h]);
      };
      float held = 0.f;  // the scale of the last tile issued
      for (int u = 0; u < kCodeAhead; ++u) {
        const int r0 = pool_row(u, lane), r1 = pool_row(u, lane + 32);
        issue(u, r0, r1);
        if (u > 0) cscl[((u - 1) % kCodeRing) * 2 * kBK + p] = held;
        held = scale_of(r0, r1);
      }
      int rr[2] = {pool_row(kCodeAhead, lane), pool_row(kCodeAhead, lane + 32)};
      for (int t = 0; t < n_tiles; ++t) {
        cp_async_wait<kCodeAhead - 1>();  // this thread's codes of tile t
        asm volatile("bar.sync 2, 128;\n" ::: "memory");  // everyone's; tile t - 1 converted
        const int st = t % kRing;
        const int cs = t % kCodeRing;
        mbar_wait(empty(st), ((t / kRing) & 1) ^ 1);
        const uint8_t* codes = sm + S::kCodes + 2 * cs * S::kCodeTile;
#pragma unroll 2
        for (int n = 0; n < NC; ++n) {
          const int i = p + 128 * n;
          const int which = i / (kBK * CH);  // 0: K, 1: V
          const int j = (i % (kBK * CH)) / CH;
          const int c = i % CH;
          const uint4 raw16 =
              *reinterpret_cast<const uint4*>(codes + which * S::kCodeTile + j * D + c * 16);
          uint32_t w[8];
          codes_to_bf16(raw16.x, CodeT(), w[0], w[1]);
          codes_to_bf16(raw16.y, CodeT(), w[2], w[3]);
          codes_to_bf16(raw16.z, CodeT(), w[4], w[5]);
          codes_to_bf16(raw16.w, CodeT(), w[6], w[7]);
          uint8_t* dst = sm + (which ? S::kV : S::kK) + st * S::kTile + (2 * c / 8) * S::kTBlock;
          *reinterpret_cast<uint4*>(dst + swz(j, (2 * c) % 8)) = make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(dst + swz(j, (2 * c + 1) % 8)) = make_uint4(w[4], w[5], w[6], w[7]);
        }
        reinterpret_cast<float*>(sm + S::kScales)[st * 2 * kBK + p] = cscl[cs * 2 * kBK + p];
        fence_async_shared();
        mbar_arrive(full(st));
        // the codes of tile u = t + kCodeAhead into tile t - 1's code stage
        const int u = t + kCodeAhead;
        cscl[((u - 1) % kCodeRing) * 2 * kBK + p] = held;
        if (u < n_tiles) {
          issue(u, rr[0], rr[1]);
          held = scale_of(rr[0], rr[1]);
          rr[0] = pool_row(u + 1, lane);
          rr[1] = pool_row(u + 1, lane + 32);
        } else {
          cp_async_commit();
        }
      }
    }
    cp_async_wait<0>();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // this thread's two rows of its warpgroup's 64: the kv positions [lo, lim]
  // each may attend (lim -1: no row)
  const int wg = tid / 128;
  const int lane = tid & 31;
  const int q4 = lane & 3;
  const int row0 = 64 * wg + 16 * ((tid & 127) / 32) + lane / 4;
  int lim[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    lim[i] = row < n_rows ? ctx + i0 + row / G : -1;
    lo[i] = window > 0 ? lim[i] - window + 1 : 0;
  }
  // a kv tile inside both rows' bounds needs no mask
  const int thr_hi = min(lim[0], lim[1]);
  const int thr_lo = max(lo[0], lo[1]);

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's share of the row sum
  // the score's factor into log2 units (the capped score is already in them)
  const float mul = logit_cap > 0.f ? 1.f : sm_scale * kLog2e;
  const float cap_in = logit_cap > 0.f ? sm_scale / logit_cap : 0.f;
  const float cap_log2 = logit_cap * kLog2e;
  // Software pipeline (bf16 pages), one warpgroup: iteration t issues S_t =
  // Q K_t and the previous tile's O += P V, and runs tile t's softmax while
  // that PV is on the tensor cores. P of the previous tile waits in ph / pl
  // over V at pv; before the first tile P is zero over tile 0's V. Every
  // warpgroup runs
  // every tile (the masks zero what its rows do not see): a wgmma under a
  // branch the compiler cannot prove uniform is serialized.
  uint32_t ph[16], pl[16], pr[kPTerms == 3 ? 16 : 1];
#pragma unroll
  for (int i = 0; i < 16; ++i) ph[i] = pl[i] = 0u;
#pragma unroll
  for (int i = 0; i < (kPTerms == 3 ? 16 : 1); ++i) pr[i] = 0u;
  uint32_t pv = sb + S::kV;
  auto issue_pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t vd = desc(pv + kk * 16 * 128, S::kTBlock, 1024);
      if constexpr (DP == 128) {
        wgmma_rs_n128(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], vd);
        wgmma_rs_n128(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], vd);
        if constexpr (kPTerms == 3)
          wgmma_rs_n128(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3], vd);
      } else {
        wgmma_rs_n64(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], vd);
        wgmma_rs_n64(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], vd);
        if constexpr (kPTerms == 3)
          wgmma_rs_n64(o, pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3], vd);
      }
    }
    wgmma_commit();
  };
  auto pv_done = [&]() {  // after the wait that covers issue_pv's group
    keep(o);
    keep(ph);
    keep(pl);
    if constexpr (kPTerms == 3) keep(pr);
  };

  auto release = [&](int st) {  // this warp is done with ring stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = kv_begin + t * kBK;
    const int st = t % kRing;
    mbar_wait(full(st), (t / kRing) & 1);  // tile t landed
    const int ob = st;  // the bf16 operand buffer of tile t
    fence_async_shared();
#if SPTPU_EXTEND_CUT == 1  // timing cut: the loads alone
    release(st);
    continue;
#endif
    const uint32_t kt = sb + S::kK + ob * S::kTile;
    const float* sks = reinterpret_cast<const float*>(sm + S::kScales) + ob * 2 * kBK;
    const float* svs = sks + kBK;

    // S = Q K^T over this warpgroup's 64 rows
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t qa = sb + S::kQ + (kk / 4) * S::kQBlock + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t kb = kt + (kk / 4) * S::kTBlock + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc(qa, 16, 1024), desc(kb, 16, 1024), kk > 0);
    }
    wgmma_commit();
    if constexpr (kPipelined) {
      issue_pv();
      wgmma_wait<1>();  // S_t done; the PV may still run
    } else {
      wgmma_wait<0>();
    }
    keep(sc);

    // sc[4c + 2i + e] is row row0 + 8i, column 8c + 2q4 + e. Each step is
    // a loop of its own under a branch uniform over the tile, so that the
    // unrolled element code has no branches.
    if constexpr (kQuant) {
#pragma unroll
      for (int n = 0; n < 32; ++n) sc[n] *= sks[8 * (n / 4) + 2 * q4 + (n & 1)];
    }
    if (logit_cap > 0.f) {  // cap * tanh(s / cap), in log2 units
#pragma unroll
      for (int n = 0; n < 32; ++n) sc[n] = cap_log2 * tanhf(sc[n] * cap_in);
    }
    if (k0 + kBK - 1 > thr_hi || (window > 0 && k0 < thr_lo)) {  // an edge crosses the tile
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        const int pos = k0 + 8 * (n / 4) + 2 * q4 + (n & 1);
        const int i = (n >> 1) & 1;
        sc[n] = pos > lim[i] || pos < lo[i] ? -INFINITY : sc[n];
      }
    }
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 32; ++n) mt[(n >> 1) & 1] = fmaxf(mt[(n >> 1) & 1], sc[n]);
    float mu[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m[i], mt[i] * mul);
      mu[i] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing live yet
      alpha[i] = ex2(m[i] - mu[i]);
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(sc[4 * c + 2 * i + e], mul, -mu[i]));
          rs[i] += p;
          sc[4 * c + 2 * i + e] = kQuant ? p * svs[8 * c + 2 * q4 + e] : p;
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
    if constexpr (kPipelined) {
      wgmma_wait<0>();  // the previous tile's PV
      pv_done();
      if (t > 0) release((t - 1) % kRing);  // K and V of tile t - 1 consumed
    }
    if (alpha[0] != 1.f || alpha[1] != 1.f) {  // a row's max moved
#pragma unroll
      for (int c = 0; c < DP / 8; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * c + 2 * i] *= alpha[i];
          o[4 * c + 2 * i + 1] *= alpha[i];
        }
    }
    // P (8-bit: P * s_v) as bf16 hi + lo (8-bit pages: + the rest); the A
    // fragment of k-step kk is registers 4kk..4kk+3
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a = sc[4 * c + 2 * i], b = sc[4 * c + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
        const float2 hf = __bfloat1622float2(hi);
        ph[2 * c + i] = bits(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(a - hf.x, b - hf.y);
        const float2 lf = __bfloat1622float2(lo);
        pl[2 * c + i] = bits(lo);
        if constexpr (kPTerms == 3) pr[2 * c + i] = pack_bf16(a - hf.x - lf.x, b - hf.y - lf.y);
      }
    pv = sb + S::kV + ob * S::kTile;
    if constexpr (!kPipelined) {  // this tile's PV now, then its stage is free
      wgmma_fence();
      issue_pv();
      wgmma_wait<0>();
      pv_done();
      release(st);
    }
  }
  if constexpr (kPipelined) {
    wgmma_fence();
    issue_pv();
    wgmma_wait<0>();
    pv_done();
  }

  // the row sums over the quad, then O / l through shared memory (Q's
  // space: each warpgroup writes only its own rows) to 16-byte stores
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  consumers_sync();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < DP / 8; ++c) {
      const int col = 8 * c + 2 * q4;
      const uint32_t off = S::kQ + (col / 64) * S::kQBlock + swz(row, (col % 64) / 8) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(sm + off) =
          pack_bf16(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
    }
  }
  consumers_sync();
  for (int i = tid; i < n_rows * CPR; i += kConsumers) {
    const int r = i / CPR;
    const int c = i % CPR;
    const uint4 v = *reinterpret_cast<const uint4*>(sm + S::kQ + (c / 8) * S::kQBlock + swz(r, c % 8));
    const int tok = q_start + i0 + r / G;
    *reinterpret_cast<uint4*>(out + ((size_t)tok * hq + (size_t)h * G + r % G) * D + c * 8) = v;
  }
}

template <int D, typename CodeT>
cudaError_t launch_for_d(dim3 grid, cudaStream_t st, const __nv_bfloat16* q, const CodeT* k,
                         const CodeT* v, const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                         const int* pt, const int* kv_lens, const int* cu_q,
                         const int* tile_seq, const int* tile_cum, __nv_bfloat16* out,
                         int num_seqs, int num_tokens, int hkv, int G, int max_pages,
                         int page_size, float sm_scale, float logit_cap, int window) {
  constexpr size_t bytes = smem_bytes<D, !std::is_same_v<CodeT, __nv_bfloat16>>();
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
