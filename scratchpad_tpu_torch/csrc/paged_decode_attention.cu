// Paged GQA decode attention for Hopper (sm_90a): bf16 KV, or int8 / fp8
// (e4m3) KV with per-(token, head) bf16 scales; scores and PV on the
// tensor cores (mma.sync), f32 accumulation.
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
// (L - W <= j < L) are live; the kernel reads only those.
//
// Chunked attention (gqa_decode.py's chunk_size, mask_start :166-168;
// Llama-4's rope layers), a runtime argument uniform over the launch, 0
// meaning none: a row of length L attends only the chunk that holds its
// query, tokens (L - 1) / C * C <= j < L, and the kernel reads only those,
// as first_chunk (:175-181) skips the chunks below. A split whose pages lie
// wholly below that start holds no live token and writes the empty partial
// that the merge ignores, as under a window. A launch with both a window and
// a chunk is refused (the JAX mask_start lets the chunk win; no model passes
// both).
//
// Attention sinks (gqa_decode.py's with_sinks, :128-133, 421-425 and
// :493-496, 637-641; GPT-OSS), a nullable f32 [Hq] argument: query head
// h*G+g's sink is a logit that joins the softmax's denominator and carries
// no value, out = sum_j e^(s_j) v_j / (e^(sink) + sum_j e^(s_j)). The
// kernel's running max m is in log2 units with sm_scale (and the cap)
// folded into the scores, so the raw sink takes log2 e alone. It joins
// once: at the CTA's own normalisation where the row is not split, else at
// the merge of the splits, never in a split's partial l; the max it is
// weighed against includes it, so a sink far above every score stays
// finite. A row with seq_len == 0 then has num 0 and den 1: exact zeros.
//
// Layout: k_cache / v_cache are one layer of the pool, [pages, page_size,
// Hkv, D] row-major; slot s = page * page_size + offset is row s. 8-bit
// pages carry k_scale / v_scale [pages, page_size, Hkv] bf16: element d of
// head h at slot s is code[s, h, d] * scale[s, h]. The scales factor out of
// the dots, as in the Pallas kernel's quantized branch (gqa_decode.py:
// 371-405): the K scale multiplies the f32 score, the V scale p (p' = p *
// s_v); the softmax denominator sums p. The codes are exact in bf16.
//
// What bounds it: bytes. Every live K and V row is read once, 2 * len * Hkv
// * D * 2 B per sequence for bf16 pages, 2 * len * Hkv * (D + 2) B for 8-bit
// ones, against 4 * len * Hq * D flops: about G flops per byte, far under
// the card's ~295 flop/byte ridge. The design keeps many row loads in
// flight, loads each once, and leaves the per-token arithmetic to the
// tensor cores:
//   - Grid (splits, Hkv, B): a CTA takes the G query heads of one kv head of
//     one row, so each K/V row it loads serves all G heads, over one split
//     of the row's pages. A page of one kv head is page_size rows of D
//     elements strided by Hkv * D: a CTA that took all heads of a row would
//     load whole contiguous pages, but at B 64 the 64 rows would fill half
//     the card and need a split even so, and its warps would meet on every
//     page; (row, kv head) gives B * Hkv independent CTAs.
//   - The split (ops/attention/gqa_decode.py::decode_plan, from the page
//     table's width on the host, never from seq_lens): where B * Hkv leaves
//     the card short of CTAs (B 1 gives 8 of 132 SMs), each row's pages are
//     cut into ranges of split_pages pages, one CTA each. A CTA writes its
//     partial (m, l in log2 units, unnormalised O, f32) to the workspace;
//     the last CTA of its (row, head) to arrive (a counter it then resets,
//     as sm90_gemm.cuh's splitk_sum) merges the partials in split order, so
//     two calls give the same bits and a layer is one launch. A CTA whose
//     range holds no live token (past seq_len, or below the window or the
//     chunk's start) writes
//     m = -inf, l = 0, O = 0, which the merge weighs by 0.
//   - Four warps a CTA, each its own pipeline: warp w takes the 16-token
//     slices w, w + 4, ... of the CTA's range and keeps a ring of 3 slices
//     (4 of 8-bit pages at D 128) in shared memory, filled by cp.async (16 bytes a
//     lane: the K and V rows of a slice, zero-filled past seq_len) and
//     waited for with cp.async.wait_group, so two or three slices a warp, 8
//     to 24 KB, load while it computes one (about 100 KB in flight an SM at
//     the 1B's shape). A warp reads the page-table entries of its first
//     slices in one round trip, then each later slice's one slice ahead of
//     its copies, so no copy waits for one. No barrier joins the warps until
//     the end.
//   - S = q K^T per slice on mma.sync.m16n8k16: the G query heads are A's
//     rows (rows G..15 zero), the slice's tokens B's columns (two n8 tiles),
//     head_dim its depth; K's rows come from shared memory by ldmatrix. q
//     stays bf16; sm_scale (times log2 e) multiplies the f32 score, the K
//     scale first on 8-bit pages. Then one max, one rescale and one row sum
//     per slice and head: an online softmax in log2 units (ex2), masked by
//     arithmetic past seq_len.
//   - O += P V on the same instruction: A is P (rows: heads, depth: tokens),
//     B is V through ldmatrix.trans. A single bf16 rounding of P misses the
//     kernel-vs-plain gate (tests/test_torch_decode_tiles.py), so P goes in
//     as P_hi = bf16(P) in A's rows 0..7 and P_lo = bf16(P - P_hi) in rows
//     8..15, the rows the heads leave free: one product, and the two halves
//     of O are added at the end. On 8-bit pages (P' = p * s_v) a third term,
//     bf16(P' - P_hi - P_lo), brings P' to f32 accuracy, as in the extend
//     kernel: those engines quantize each new K/V row on both paths.
//   - 8-bit pages: the codes land at 1 B per element in the warp's ring and
//     the warp converts its slice to bf16 tiles (int8 and e4m3 are exact in
//     bf16) before the products; the slice's 16 K and 16 V scales are loaded
//     by lanes 0-31 with the copies and kept in shared memory.
//   - The warps' states merge in warp order through shared memory, and a
//     CTA without a split writes out = O / l in bf16 (0 where l == 0).
// Shared memory: the ring, 4 x 3 x 2 x 16 x D x 2 B (48 KB at D 64, 96 KB at
// D 128; 8-bit pages 42 and 98 KB with their bf16 tiles and scales): four
// CTAs an SM at D 64, two at D 128, as the registers allow too.
//
// head_dim 256 (Gemma): the same code at D 256. A slice of one head is 8 KB
// of K and 8 KB of V, so the ring takes 192 KB and one CTA (four warps) an
// SM, with up to 128 KB of loads in flight an SM, past what the card's
// latency needs. A thread's O fragments are 32 n8 tiles (128 f32
// registers) beside q's 32 A registers; the merge state ([kMaxG][D] f32,
// 8 KB) still fits a warp's region, and a split's partial is G (D + 2)
// floats, which decode_plan's 8 MB workspace holds at any plan of
// SPLIT_TARGET CTAs. The window is per call (Gemma's local and global
// layers alternate launches), as at every head_dim. 8-bit pages at D 256
// (Gemma on int8 or fp8 KV): a warp holds a ring of three slices of codes
// (24 KB), their scales (384 B) and the two bf16 tiles a slice converts to
// (16 KB), 41,344 B; 165,376 B a CTA, one CTA an SM as with bf16 pages. The
// third P term and the scale multiplies push D 256's 255 registers further:
// ptxas -v spills 64 bytes a thread at G 2 to 7 (68 at G 8, 112 stored and
// 136 loaded at G 1), int8 and e4m3 alike, against 20 to 32 of bf16 pages
// at D 256 in the same build.
//
// Stage cuts, for the decode ablation tool (tools/decode_ablate.py). Built
// with -DSPTPU_DECODE_STAGE=1, 2 or 3, a warp's slice stops after
//   1  its K and V rows landed and read (the fragments the products take),
//   2  that and S = q K^T,
//   3  that, the cap and the online softmax (m, l);
// with 5, it runs the whole kernel and carries the cuts' V sum as well.
// `out` holds a checksum of that work over the row's n live tokens t, so
// that no stage is optimised away (gqa_decode.py's
// paged_decode_attention_stage_plain defines it):
//   1  out[g][d] = sum_t (|K[t][d]| + |V[t][d]|)
//   2  out[g][d] = sum_t |s_g(t)| + sum_t |V[t][d]|
//   3  out[g][d] = |m_g| + (sum_t |V[t][d]|) / l_g
//   5  out[g][d] = decode[g][d] + (sum_t |V[t][d]|) / n
// the warps merging by sums (in 3, m and l by the softmax merge); zero-filled
// rows past seq_len add nothing to a sum. Stage 4, the default, is the full
// kernel: the production build, whose code the cuts leave as it is. Stage 5
// less stage 4 is what the V sum itself costs. A cut instantiates only what
// the tool launches: bf16 pages, G 3 and 4, D 64 and 128, one split; its
// 8-bit entry point refuses.

#include <cmath>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

#ifndef SPTPU_DECODE_STAGE
#define SPTPU_DECODE_STAGE 4
#endif

namespace {

constexpr int kStage = SPTPU_DECODE_STAGE;
static_assert(kStage >= 1 && kStage <= 5, "SPTPU_DECODE_STAGE must be 1 to 5");

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlice = 16;  // tokens a warp takes at a time
// slices in a warp's ring: 3 (bf16 pages: four CTAs an SM at D 64, two at
// D 128, by shared memory), and 4 of 8-bit pages at D 128, whose slices are
// half the bytes, at the same two CTAs an SM (at D 64 a fourth slice cost
// 1 % to 6 % on the card: a CTA an SM fewer)
template <int D, bool kQuant>
constexpr int ring_depth() {
  return kQuant && D == 128 ? 4 : 3;
}
constexpr int kMaxG = 8;
constexpr int kMaxSplits = 128;
constexpr int kDecodeCounterSlots = 8192;  // split counters (i32) at the workspace's head
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float abs_sum(uint32_t v) {  // |lo| + |hi| of a bf16x2
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return fabsf(f.x) + fabsf(f.y);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a bf16 tile of
// kSlice rows of D elements, swizzled so that ldmatrix's eight rows of one
// chunk fall in eight different bank groups
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  constexpr int CPR = D / 8;
  if constexpr (CPR == 4) return row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
  else return row * (CPR * 16) + ((chunk ^ (row & 7)) << 4);
}

// A warp's shared memory, in bytes: the ring [kRing][K, V] of bf16 tiles
// (bf16 pages) or of codes (8-bit pages; then also the ring's scales
// [kRing][K 16, V 16] f32 and the bf16 K and V tiles a slice converts to).
// After its loop the warp's region holds its state for the CTA's merge:
// O [kMaxG][D], m [kMaxG], l [kMaxG] f32 and the cuts' sums [D + D + kMaxG].
template <int D, bool kQuant>
struct WarpSmem {
  static constexpr int kRing = ring_depth<D, kQuant>();
  static constexpr int kTile = kSlice * D * 2;  // one bf16 K or V tile
  static constexpr int kCodeTile = kSlice * D;
  static constexpr int kRingBytes = kRing * 2 * (kQuant ? kCodeTile : kTile);
  static constexpr int kScales = kRingBytes;
  static constexpr int kOps = kScales + (kQuant ? kRing * 2 * kSlice * 4 : 0);
  static constexpr int kBytes = kOps + (kQuant ? 2 * kTile : 0);
  static constexpr int kMergeBytes = (kMaxG * D + 2 * kMaxG + 2 * D + kMaxG) * 4;
  static_assert(kBytes >= kMergeBytes, "a warp's region holds its merge state");
  static_assert(kBytes % 16 == 0, "16-byte aligned regions");
};

template <int D, bool kQuant>
constexpr int cta_smem() {
  return kWarps * WarpSmem<D, kQuant>::kBytes;
}

struct DecodeArgs {
  const __nv_bfloat16* q;
  const void* k_cache;
  const void* v_cache;
  const __nv_bfloat16* k_scale;
  const __nv_bfloat16* v_scale;
  const int* page_table;
  const int* seq_lens;
  __nv_bfloat16* out;
  uint8_t* ws;  // i32 counters [kDecodeCounterSlots], zero between launches, then f32 partials
  const float* sinks;  // [Hq] sink logits, or nullptr
  int num_kv_heads, max_pages, page_size, splits, split_pages, window, chunk;
  float sm_scale, logit_cap;
};

// CodeT: __nv_bfloat16 (bf16 pages, no scales), int8_t or __nv_fp8_e4m3
// (8-bit pages with k_scale / v_scale)
template <int D, int G, typename CodeT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const DecodeArgs a) {
  constexpr bool kQuant = !std::is_same_v<CodeT, __nv_bfloat16>;
  using W = WarpSmem<D, kQuant>;
  constexpr int KS = D / 16;     // k steps of S; n8 tile pairs of O
  constexpr int NT = D / 8;      // n8 tiles of O
  constexpr int CPR = D / 8;     // 16-byte chunks of a bf16 row
  constexpr int CCPR = D / 16;   // 16-byte chunks of a code row
  constexpr int kPTerms = kQuant ? 3 : 2;
  constexpr int kRing = W::kRing;
  static_assert(kWarps * W::kBytes >= kMaxSplits * 2 * kMaxG * 4, "the split merge's m and l fit the ring");

  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int hq = a.num_kv_heads * G;
  const int len = a.seq_lens[b];
  const int ps = a.page_size;

  // the CTA's live tokens [lo, hi): its split's pages, from the first token
  // of the query's chunk or of the window on
  const int first = a.chunk > 0 ? max(len - 1, 0) / a.chunk * a.chunk
                    : (a.window > 0 && len > a.window) ? len - a.window : 0;
  const int span = a.split_pages * ps;
  const int lo = max(split * span, first);
  const int hi = min(split * span + span, len);
  const int n_slices = hi > lo ? (hi - lo + kSlice - 1) / kSlice : 0;
  const int nw = n_slices > warp ? (n_slices - warp + kWarps - 1) / kWarps : 0;

  uint8_t* wsm = smem + warp * W::kBytes;  // this warp's region
  const uint32_t wsb = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));

  // q as A fragments: row gid (head gid of the group; zero past G), k
  // steps of 16 along D
  uint32_t qa[KS][2];
  {
    const __nv_bfloat16* qrow = a.q + ((size_t)b * hq + (size_t)h * G + (gid < G ? gid : 0)) * D;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qa[ks][0] = gid < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 2 * tig) : 0u;
      qa[ks][1] = gid < G ? *reinterpret_cast<const uint32_t*>(qrow + 16 * ks + 8 + 2 * tig) : 0u;
    }
  }

  const int* pt = a.page_table + (size_t)b * a.max_pages;
  const size_t row_stride = (size_t)a.num_kv_heads * D;
  const CodeT* kc = static_cast<const CodeT*>(a.k_cache);
  const CodeT* vc = static_cast<const CodeT*>(a.v_cache);
  auto tok0 = [&](int u) { return lo + kSlice * (kWarps * u + warp); };

  // Lane l reads the page-table entry of token l % 16 of a slice, and the
  // slot it gives (-1 past hi) reaches the lanes that copy that token's
  // rows by a shuffle: the first kRing - 1 slices' entries in one round
  // trip (two slices a load: lanes 0-15 and 16-31), then each later slice's
  // one slice ahead of its copies.
  auto page_of = [&](int u, int& page, int& off) {
    const int t = tok0(u) + (lane & 15);
    off = t % ps;
    page = (u < nw && t < hi) ? pt[t / ps] : -1;
  };
  auto slot_of = [&](int page, int off) { return page >= 0 ? page * ps + off : -1; };
  // 8-bit pages: lane r < 16 carries the K scale of token r, lane 16 + r
  // its V scale, loaded with the copies and stored one slice later
  __nv_bfloat16 held_scale = __float2bfloat16(0.f);
  float* scales = reinterpret_cast<float*>(wsm + W::kScales);

  // the copies of slice u, whose token r's slot lane base + r holds; each
  // lane copies the same 16-byte chunk of kSlice * 16 / 32 rows
  auto issue = [&](int u, int slot, int base) {
    if constexpr (kQuant) {
      if (u > 0) scales[((u - 1) % kRing) * 2 * kSlice + lane] = __bfloat162float(held_scale);
    }
    if (u < nw) {
      const int st = u % kRing;
      constexpr int CH = kQuant ? CCPR : CPR;  // 16-byte chunks of a row
      constexpr int RPI = 32 / CH;             // rows one warp-wide copy covers
      const int c = lane % CH, row0 = lane / CH;
      const uint32_t kt = wsb + st * 2 * (kQuant ? W::kCodeTile : W::kTile);
      const uint32_t vt = kt + (kQuant ? W::kCodeTile : W::kTile);
      const CodeT* kh = kc + (size_t)h * D + c * (16 / sizeof(CodeT));
      const CodeT* vh = vc + (size_t)h * D + c * (16 / sizeof(CodeT));
#pragma unroll
      for (int n = 0; n < kSlice / RPI; ++n) {
        const int row = row0 + RPI * n;
        const int r = __shfl_sync(0xffffffffu, slot, base + row);
        const bool ok = r >= 0;
        const size_t off = (ok ? (size_t)r : 0) * row_stride;
        const uint32_t dst = kQuant ? row * D + c * 16 : tile_off<D>(row, c);
        cp_async16(kt + dst, kh + off, ok);
        cp_async16(vt + dst, vh + off, ok);
      }
      if constexpr (kQuant) {
        const int mine = __shfl_sync(0xffffffffu, slot, base + (lane & 15));
        const __nv_bfloat16* sp = lane < 16 ? a.k_scale : a.v_scale;
        held_scale = mine >= 0 ? sp[(size_t)mine * a.num_kv_heads + h] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  // this thread's softmax state: row gid (head gid), its share of l
  float m = -INFINITY, l = 0.f;
  float o[NT][4];  // O fragments: rows gid (P_hi, P_r), gid + 8 (P_lo)
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // the stage cuts' sums: K (by k step), V (by n8 tile), |s| of row gid
  [[maybe_unused]] float ksum[KS][4] = {};
  [[maybe_unused]] float vsum[NT] = {};
  [[maybe_unused]] float ssum = 0.f;
  const float mul = a.logit_cap > 0.f ? 1.f : a.sm_scale * kLog2e;
  const float cap_in = a.logit_cap > 0.f ? a.sm_scale / a.logit_cap : 0.f;
  const float cap_log2 = a.logit_cap * kLog2e;

  // ldmatrix lanes: K (x4: tokens 0-7 | 8-15 by lane bit 4, chunk halves
  // by bit 3) and V (.trans: tokens by bit 3, chunks by bit 4)
  const int krow = (lane & 7) + ((lane >> 4) << 3), khalf = (lane >> 3) & 1;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3), vhalf = lane >> 4;

  auto v_fragments = [&](uint32_t vt, int pp, uint32_t (&vb)[4]) {
    ldsm_x4_t(vt + tile_off<D>(vrow, 2 * pp + vhalf), vb);
  };
  auto sum_v = [&](const uint32_t (&vb)[4], int pp) {
    vsum[2 * pp] += abs_sum(vb[0]) + abs_sum(vb[1]);
    vsum[2 * pp + 1] += abs_sum(vb[2]) + abs_sum(vb[3]);
  };

  auto compute = [&](int st, int t0) {
    uint32_t kt, vt;
    const float* sc = scales + st * 2 * kSlice;
    if constexpr (!kQuant) {
      kt = wsb + st * 2 * W::kTile;
      vt = kt + W::kTile;
    } else {
      // the slice's codes to the bf16 tiles, exactly
      const uint8_t* codes = wsm + st * 2 * W::kCodeTile;
      uint8_t* ops = wsm + W::kOps;
#pragma unroll
      for (int i = lane; i < 2 * kSlice * CCPR; i += 32) {
        const int which = i / (kSlice * CCPR);  // 0: K, 1: V
        const int row = (i % (kSlice * CCPR)) / CCPR, c = i % CCPR;
        const uint4 raw16 = *reinterpret_cast<const uint4*>(codes + which * W::kCodeTile + row * D + c * 16);
        uint32_t w[8];
        codes_to_bf16(raw16.x, CodeT(), w[0], w[1]);
        codes_to_bf16(raw16.y, CodeT(), w[2], w[3]);
        codes_to_bf16(raw16.z, CodeT(), w[4], w[5]);
        codes_to_bf16(raw16.w, CodeT(), w[6], w[7]);
        uint8_t* dst = ops + which * W::kTile;
        *reinterpret_cast<uint4*>(dst + tile_off<D>(row, 2 * c)) = make_uint4(w[0], w[1], w[2], w[3]);
        *reinterpret_cast<uint4*>(dst + tile_off<D>(row, 2 * c + 1)) = make_uint4(w[4], w[5], w[6], w[7]);
      }
      __syncwarp();
      kt = wsb + W::kOps;
      vt = kt + W::kTile;
    }

    // S = q K^T: s[j] holds row gid, tokens 8j + 2 tig (+1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kb[4];
      ldsm_x4(kt + tile_off<D>(krow, 2 * ks + khalf), kb);
      if constexpr (kStage == 1) {
        ksum[ks][0] += abs_sum(kb[0] & 0xFFFFu) + abs_sum(kb[2] & 0xFFFFu);
        ksum[ks][1] += abs_sum(kb[0] & 0xFFFF0000u) + abs_sum(kb[2] & 0xFFFF0000u);
        ksum[ks][2] += abs_sum(kb[1] & 0xFFFFu) + abs_sum(kb[3] & 0xFFFFu);
        ksum[ks][3] += abs_sum(kb[1] & 0xFFFF0000u) + abs_sum(kb[3] & 0xFFFF0000u);
      } else {
        mma16816(s[0], qa[ks][0], 0u, qa[ks][1], 0u, kb[0], kb[1]);
        mma16816(s[1], qa[ks][0], 0u, qa[ks][1], 0u, kb[2], kb[3]);
      }
    }
    if constexpr (kStage <= 3) {  // a cut: the V rows' sum, and the cut's own state
#pragma unroll
      for (int pp = 0; pp < KS; ++pp) {
        uint32_t vb[4];
        v_fragments(vt, pp, vb);
        sum_v(vb, pp);
      }
      if constexpr (kStage == 1) return;
    }

    // the scores in log2 units, -inf past seq_len
    float t[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * tig + e;
        float x = s[j][e];
        if constexpr (kQuant) x *= sc[col];
        if constexpr (kStage == 2) ssum += fabsf(x * a.sm_scale);
        const float y = a.logit_cap > 0.f ? cap_log2 * tanhf(x * cap_in) : x * mul;
        t[j][e] = t0 + col < hi ? y : -INFINITY;
      }
    if constexpr (kStage == 2) return;
    float tmax = fmaxf(fmaxf(t[0][0], t[0][1]), fmaxf(t[1][0], t[1][1]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float mu = m_new == -INFINITY ? 0.f : m_new;  // nothing live yet
    const float alpha = ex2(m - mu);
    m = m_new;
    float p[2][2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) p[j][e] = ex2(t[j][e] - mu);
    l = l * alpha + ((p[0][0] + p[0][1]) + (p[1][0] + p[1][1]));
    if constexpr (kStage == 3) return;

    if (alpha != 1.f) {
#pragma unroll
      for (int n = 0; n < NT; ++n) o[n][0] *= alpha, o[n][1] *= alpha, o[n][2] *= alpha, o[n][3] *= alpha;
    }
    // P (8-bit: P' = p s_v) in bf16 terms; A fragments: hi in rows gid,
    // lo in rows gid + 8, tokens 2 tig (+1) | 8 + 2 tig (+1)
    uint32_t ph[2], pl[2], pr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float x0 = p[j][0], x1 = p[j][1];
      if constexpr (kQuant) {
        x0 *= sc[kSlice + 8 * j + 2 * tig];
        x1 *= sc[kSlice + 8 * j + 2 * tig + 1];
      }
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hv);
      ph[j] = bits(hv);
      const __nv_bfloat162 lv = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      const float2 lf = __bfloat1622float2(lv);
      pl[j] = bits(lv);
      pr[j] = kPTerms == 3 ? pack_bf16(x0 - hf.x - lf.x, x1 - hf.y - lf.y) : 0u;
    }
#pragma unroll
    for (int pp = 0; pp < KS; ++pp) {
      uint32_t vb[4];
      v_fragments(vt, pp, vb);
      mma16816(o[2 * pp], ph[0], pl[0], ph[1], pl[1], vb[0], vb[1]);
      mma16816(o[2 * pp + 1], ph[0], pl[0], ph[1], pl[1], vb[2], vb[3]);
      if constexpr (kPTerms == 3) {
        mma16816(o[2 * pp], pr[0], 0u, pr[1], 0u, vb[0], vb[1]);
        mma16816(o[2 * pp + 1], pr[0], 0u, pr[1], 0u, vb[2], vb[3]);
      }
      if constexpr (kStage == 5) sum_v(vb, pp);
    }
  };

  {
    constexpr int kLoads = kRing / 2;  // two slices a load: covers kRing - 1
    int page[kLoads], off[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) page_of(2 * k + (lane >> 4), page[k], off[k]);
#pragma unroll
    for (int u = 0; u < kRing - 1; ++u) issue(u, slot_of(page[u / 2], off[u / 2]), 16 * (u & 1));
  }
  int held_page, held_off;  // the next slice's, one slice ahead
  page_of(kRing - 1, held_page, held_off);
  for (int i = 0; i < nw; ++i) {
    issue(i + kRing - 1, slot_of(held_page, held_off), 0);
    page_of(i + kRing, held_page, held_off);
    cp_async_wait<kRing - 1>();  // slice i landed
    __syncwarp();
    compute(i % kRing, tok0(i));
    __syncwarp();  // slice i read: its stage may be written again
  }
  cp_async_wait<0>();
  __syncwarp();

  // this warp's state to its region: O rows (hi + lo halves added), m, l
  // and the cuts' sums, reduced over the lanes that share them
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* mo = reinterpret_cast<float*>(wsm);  // O [kMaxG][D]
  float* mm = mo + kMaxG * D;                 // m [kMaxG]
  float* ml = mm + kMaxG;                     // l [kMaxG]
  float* mk = ml + kMaxG;                     // the K sums [D]
  float* mv = mk + D;                         // the V sums [D]
  [[maybe_unused]] float* ms = mv + D;        // the |s| sums [kMaxG]
  if (gid < G) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(mo + gid * D + 8 * n + 2 * tig) = make_float2(o[n][0] + o[n][2], o[n][1] + o[n][3]);
    if (tig == 0) {
      mm[gid] = kStage == 2 ? 0.f : m;
      ml[gid] = l;
    }
  }
  if constexpr (kStage != 4) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = ksum[ks][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        ksum[ks][e] = v;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float v = vsum[n];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      vsum[n] = v;
    }
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 2);
    if (gid == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mk[16 * ks + 2 * tig] = ksum[ks][0];
        mk[16 * ks + 2 * tig + 1] = ksum[ks][1];
        mk[16 * ks + 8 + 2 * tig] = ksum[ks][2];
        mk[16 * ks + 9 + 2 * tig] = ksum[ks][3];
      }
    }
    if (tig == 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n) mv[8 * n + gid] = vsum[n];
      if (gid < G) ms[gid] = ssum;
    }
  }
  __syncthreads();

  // the warps' states merged in warp order: element (g, d) of the CTA's
  // numerator, and each head's max and denominator
  auto region = [&](int w) { return reinterpret_cast<const float*>(smem + w * W::kBytes); };
  // head g's sink in the scores' log2 units (-inf: none)
  auto sink_log2 = [&](int g) {
    return a.sinks != nullptr ? a.sinks[h * G + g] * kLog2e : -INFINITY;
  };
  auto head_max = [&](int g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, region(w)[kMaxG * D + g]);
    return mx;
  };
  __nv_bfloat16* orow = a.out + ((size_t)b * hq + (size_t)h * G) * D;
  if constexpr (kStage != 4 && kStage != 5) {  // a cut's checksum (one split)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float vs = 0.f, val;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) vs += region(w)[kMaxG * D + 2 * kMaxG + D + d];
      if constexpr (kStage == 1) {
        float ksm = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ksm += region(w)[kMaxG * D + 2 * kMaxG + d];
        val = ksm + vs;
      } else if constexpr (kStage == 2) {
        float ss = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ss += region(w)[kMaxG * D + 2 * kMaxG + 2 * D + g];
        val = ss + vs;
      } else {
        const float mx = head_max(g);
        const float mu = mx == -INFINITY ? 0.f : mx;
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) den += region(w)[kMaxG * D + kMaxG + g] * ex2(region(w)[kMaxG * D + g] - mu);
        val = den > 0.f ? fabsf(mx) / kLog2e + vs / den : 0.f;
      }
      orow[i] = __float2bfloat16(val);
    }
    return;
  } else {
    const bool split_run = a.splits > 1;
    const size_t pair = (size_t)b * a.num_kv_heads + h;
    float* part = reinterpret_cast<float*>(a.ws + kDecodeCounterSlots * 4);
    constexpr int kPart = G * D + 2 * G;  // a partial: O [G][D], m [G], l [G]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float mx = head_max(g);
      // the sink joins here where the row is one CTA's, else at the merge
      const float sink = split_run ? -INFINITY : sink_log2(g);
      const float top = fmaxf(mx, sink);
      const float mu = top == -INFINITY ? 0.f : top;
      float den = ex2(sink - mu), num = 0.f;  // ex2(-inf) = 0: no sink
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* r = region(w);
        const float wt = ex2(r[kMaxG * D + g] - mu);  // 0 for a warp that saw no token
        den += r[kMaxG * D + kMaxG + g] * wt;
        num += wt == 0.f ? 0.f : r[g * D + d] * wt;
      }
      if (split_run) {
        float* mine = part + (pair * a.splits + split) * kPart;
        __stcg(mine + i, num);
        if (d == 0) {
          __stcg(mine + G * D + g, mx);
          __stcg(mine + G * D + G + g, den);
        }
      } else {
        float val = den > 0.f ? num / den : 0.f;
        if constexpr (kStage == 5) {
          float vs = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) vs += region(w)[kMaxG * D + 2 * kMaxG + D + d];
          if (len > first) val += vs / static_cast<float>(len - first);
        }
        orow[i] = __float2bfloat16(val);
      }
    }
    if (!split_run) return;

    // the last CTA of (b, h) to arrive merges the splits in split order
    __shared__ int last;
    __threadfence();
    __syncthreads();
    int* counters = reinterpret_cast<int*>(a.ws);
    if (tid == 0) last = atomicAdd(counters + pair, 1) == a.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* base = part + pair * a.splits * kPart;
    // every split's m and l into shared memory (the ring, free now) in one
    // round trip, then each head's max, the splits' weights (in place of
    // m) and the denominator
    float* ml_s = reinterpret_cast<float*>(smem);  // [kMaxSplits][m G, l G]
    __shared__ float den_s[kMaxG];
    for (int e = tid; e < a.splits * 2 * G; e += kThreads)
      ml_s[e] = __ldcg(base + (e / (2 * G)) * kPart + G * D + e % (2 * G));
    __syncthreads();
    if (tid < G) {
      float mx = -INFINITY;
      for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, ml_s[s * 2 * G + tid]);
      const float sink = sink_log2(tid);  // once, here: no partial holds it
      const float top = fmaxf(mx, sink);
      const float mu = top == -INFINITY ? 0.f : top;
      float den = ex2(sink - mu);
      for (int s = 0; s < a.splits; ++s) {
        const float wt = ex2(ml_s[s * 2 * G + tid] - mu);
        ml_s[s * 2 * G + tid] = wt;
        den += ml_s[s * 2 * G + G + tid] * wt;
      }
      den_s[tid] = den;
    }
    __syncthreads();
    // the numerators in split order, eight splits' loads in flight
    constexpr int kBatch = 8;
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      float num = 0.f;
      for (int s0 = 0; s0 < a.splits; s0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = s0 + u < a.splits ? __ldcg(base + (s0 + u) * kPart + i) : 0.f;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float wt = s0 + u < a.splits ? ml_s[(s0 + u) * 2 * G + g] : 0.f;
          num += wt == 0.f ? 0.f : v[u] * wt;
        }
      }
      orow[i] = __float2bfloat16(den_s[g] > 0.f ? num / den_s[g] : 0.f);
    }
    if (tid == 0) counters[pair] = 0;  // ready for the next launch
  }
}

template <int D, int G, typename CodeT>
cudaError_t launch_dg(const DecodeArgs& a, dim3 grid, cudaStream_t st) {
  constexpr int bytes = cta_smem<D, !std::is_same_v<CodeT, __nv_bfloat16>>();
  const cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<D, G, CodeT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<D, G, CodeT><<<grid, kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D, typename CodeT>
cudaError_t launch_for_d(int G, const DecodeArgs& a, dim3 grid, cudaStream_t st) {
  switch (G) {
#if SPTPU_DECODE_STAGE == 4
    case 1: return launch_dg<D, 1, CodeT>(a, grid, st);
    case 2: return launch_dg<D, 2, CodeT>(a, grid, st);
    case 3: return launch_dg<D, 3, CodeT>(a, grid, st);
    case 4: return launch_dg<D, 4, CodeT>(a, grid, st);
    case 5: return launch_dg<D, 5, CodeT>(a, grid, st);
    case 6: return launch_dg<D, 6, CodeT>(a, grid, st);
    case 7: return launch_dg<D, 7, CodeT>(a, grid, st);
    case 8: return launch_dg<D, 8, CodeT>(a, grid, st);
#else
    case 3: return launch_dg<D, 3, CodeT>(a, grid, st);
    case 4: return launch_dg<D, 4, CodeT>(a, grid, st);
#endif
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename CodeT>
int launch(DecodeArgs a, int batch, int num_q_heads, int head_dim, void* stream) {
  if (batch == 0) return 0;
  if (a.logit_cap < 0.f || a.window < 0 || a.chunk < 0 || a.page_size <= 0) return cudaErrorInvalidValue;
  if (a.window > 0 && a.chunk > 0) return cudaErrorInvalidValue;  // one mask or the other
  if (a.num_kv_heads <= 0 || num_q_heads % a.num_kv_heads != 0) return cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits || a.split_pages < 1 ||
      (long long)a.splits * a.split_pages < a.max_pages)
    return cudaErrorInvalidValue;
  if (a.splits > 1 && ((long long)batch * a.num_kv_heads > kDecodeCounterSlots || a.ws == nullptr))
    return cudaErrorInvalidValue;
  if (kStage != 4 && (a.splits != 1 || a.sinks != nullptr))
    return cudaErrorInvalidValue;  // a cut runs one split, without sinks
  const int G = num_q_heads / a.num_kv_heads;
  const dim3 grid(a.splits, a.num_kv_heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
#if SPTPU_DECODE_STAGE == 4
    case 32: return static_cast<int>(launch_for_d<32, CodeT>(G, a, grid, st));
#endif
    case 64: return static_cast<int>(launch_for_d<64, CodeT>(G, a, grid, st));
    case 128: return static_cast<int>(launch_for_d<128, CodeT>(G, a, grid, st));
#if SPTPU_DECODE_STAGE == 4
    case 256: return static_cast<int>(launch_for_d<256, CodeT>(G, a, grid, st));
#endif
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [B, Hq, D] bf16; k_cache, v_cache [pages, page_size, Hkv, D] bf16;
// page_table i32 [B, max_pages]; seq_lens i32 [B]; out [B, Hq, D] bf16;
// logit_cap > 0 caps the scores (0: no cap); window > 0 keeps the last
// window tokens (0: all); chunk > 0 keeps the tokens of the query's chunk
// of that many (0: all; not with a window); sinks f32 [Hq] sink logits, or
// null (see the
// notes above). The plan (gqa_decode.py::decode_plan): each row's pages in
// `splits` ranges of `split_pages` (splits * split_pages >= max_pages);
// with splits > 1, workspace holds the split counters (zero) and the
// partials. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_cache,
                                      const void* v_cache, const void* page_table,
                                      const void* seq_lens, void* out, int batch,
                                      int num_q_heads, int num_kv_heads, int head_dim,
                                      int max_pages, int page_size, float sm_scale,
                                      float logit_cap, int window, int chunk,
                                      const void* sinks, int splits, int split_pages,
                                      void* workspace, void* stream) {
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache, nullptr, nullptr,
                     static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
                     static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(workspace),
                     static_cast<const float*>(sinks), num_kv_heads, max_pages, page_size,
                     splits, split_pages, window, chunk, sm_scale, logit_cap};
  return launch<__nv_bfloat16>(a, batch, num_q_heads, head_dim, stream);
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
                                            int chunk, const void* sinks, int splits, int split_pages,
                                            void* workspace, void* stream) {
#if SPTPU_DECODE_STAGE != 4
  return static_cast<int>(cudaErrorNotSupported);  // a stage cut: bf16 pages only
#else
  const DecodeArgs a{static_cast<const __nv_bfloat16*>(q), k_cache, v_cache,
                     static_cast<const __nv_bfloat16*>(k_scale),
                     static_cast<const __nv_bfloat16*>(v_scale),
                     static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
                     static_cast<__nv_bfloat16*>(out), static_cast<uint8_t*>(workspace),
                     static_cast<const float*>(sinks), num_kv_heads, max_pages, page_size,
                     splits, split_pages, window, chunk, sm_scale, logit_cap};
  switch (code_type) {
    case 0: return launch<int8_t>(a, batch, num_q_heads, head_dim, stream);
    case 1: return launch<__nv_fp8_e4m3>(a, batch, num_q_heads, head_dim, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
}
