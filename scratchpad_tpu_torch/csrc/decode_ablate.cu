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
// What bounds it: bytes. Each chunk streams CP ps 2 Hkv Dp 2 B a sequence
// (128 KB a (row, kv head) at the probe's shape) against about 4 Hq Dp
// flops a row. The copies keep the card's memory busy from the first CTA
// to the last; on the card, what then held the kernel back was the
// consumer warps' instructions a tile, so the consumers are kept lean:
//   - Grid (B, Hkv), 160 threads: four consumer warps and one producer
//     warp. A TPU core walks the grid in order, so the Pallas kernel
//     prefetches the next sequence's first chunk during the current one's
//     last (_ablate.py:33-36, 48-57); CTAs run in parallel here, so each
//     CTA (b, k) streams its own sequence. Shared memory stays near 41 KB
//     (G 4, Dp 128, page 16) and registers at 96 a thread or fewer, so four
//     CTAs fit an SM and the probe's 512 CTAs run in one wave of 528 slots.
//   - Copies: the producer warp walks the CTA's tiles, a tile being one
//     page of kv head k's K or V block (ps rows of Dp bf16, 4 KB at the
//     probe's shape), and fills a ring of kStages tiles, one TMA request a
//     tile (a 3D tensor map over kv viewed as [pages ps, 2 Hkv Dp / 64,
//     64], box {64, Dp / 64, ps}, 128-byte swizzled: see tile_off), whose
//     bytes complete the slot's `full` mbarrier. A consumer warp waits on
//     that barrier and frees the slot by one arrival on its `empty`
//     mbarrier; no CTA-wide barrier is taken per tile. The ring holds 32 KB
//     in flight a CTA, 128 KB an SM; a deeper ring gained nothing.
//   - Order: a chunk's K pages, then its V pages. The softmax of a chunk
//     needs the chunk's max over all its scores, and the PV needs that
//     softmax (p is rounded to bf16 after the chunk's max is taken,
//     _ablate.py:75); a ring that held a whole chunk's K and V pages (128
//     KB) would leave one CTA an SM. So V follows K, and the ring's copies
//     of a chunk's V pages (and of the next chunk's K pages) run under the
//     scores and the softmax. The loops walk (chunk, K or V, page) with the
//     slot and its parity carried along: no division a tile.
//   - Scores on CUDA cores, in the order of decode_ablate.py's lane_dot,
//     which makes m exact: one warp a row; lane l sums its Dp / 32 products
//     in turn, then the lanes combine in a butterfly, halves first. The G
//     heads' butterflies share their shuffles (a transposed butterfly: at
//     each of the first log2 G levels a lane keeps half its heads' values
//     and sends the other half to its partner): at G 4 a row takes 6
//     shuffles instead of 20. Each sum pairs the same two values as
//     lane_dot's tree. A warp scores its rows of a page (4 at page 16)
//     together, so that their trees' shuffles overlap.
//   - The chunk's statistics once its last K page is scored: the consumer
//     warps meet on a named barrier (the producer runs on), one warp a head
//     takes the masked max, alpha, p, l and bf16(p), and they meet again.
//   - PV on the tensor cores: mma.sync.m16n8k16 on the transposed product,
//     acc^T[d][h] += V^T[d][rows] bf16(p)^T[rows][h]: A is V by
//     ldmatrix.trans (16 head dims, depth a page's 16 rows), B bf16(p) (the
//     G heads as its 8 columns, the rest zero), f32 sums. With the heads as
//     A's 16 rows, 12 of them would be padding at G 4 and every page would
//     take twice the mma. bf16(p) and bf16 V make every product exact; only
//     the order of f32 additions differs from the plain version, within
//     aux_tolerance. Warp w holds d in [w Dp / 4, (w + 1) Dp / 4) of every
//     head; the accumulators are rescaled by alpha at each chunk's start.
//   - One launch a call: each CTA writes its heads' aux (and kv head 0's
//     CTA acc00); the last CTA of a row to arrive (a counter it then
//     resets, as paged_decode_attention.cu's split merge does) writes the
//     row's `out` from them. The result is the same bits every call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = 8;                 // ring tiles a CTA
constexpr int kMinBlocks = 4;              // CTAs an SM: registers <= 96 a thread
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kStaticSmem = 1024;  // mbarriers and per-head state, with room to spare
constexpr int kAlign = 1024;       // the TMA's 128-byte swizzle repeats every 1024 bytes

enum Mode : int { kDmaOnly = 0, kReshapeOnly = 1, kSdotOnly = 2, kNoPv = 3, kFull = 4 };

// byte offsets of the dynamic shared memory from a 1024-aligned base: the
// ring [kStages] of tiles (ps rows of Dp bf16 as the TMA swizzles them,
// each slot 1024-aligned); no_pv and full: the chunk's scores [G][CP ps]
// f32; full: bf16(p) [G][ph] (ph = pbuf_head(ps, CP): CP pages padded to
// a multiple of 16 rows with zeros, the PV's depth, and 8 more elements, so
// that a fragment's 8 heads fall in different banks) and K_0[:, 0] of the
// chunk [CP ps] f32 (kv head 0's CTA). `total` holds the room to align the
// base.
struct Layout {
  long long tile, stage, sbuf, pbuf, kcol, total;
};

__host__ __device__ inline int pbuf_head(int ps, int CP) { return CP * ((ps + 15) / 16 * 16) + 8; }

__host__ __device__ inline Layout layout(int dp, int G, int mode, int ps, int CP) {
  Layout L;
  const long long chunk = (long long)CP * ps;
  L.tile = (long long)ps * dp * 2;
  L.stage = (L.tile + kAlign - 1) / kAlign * kAlign;
  L.sbuf = kStages * L.stage;
  L.pbuf = L.sbuf + (mode >= kNoPv ? G * chunk * 4 : 0);
  L.kcol = L.pbuf + (mode == kFull ? (long long)G * pbuf_head(ps, CP) * 2 : 0);
  L.total = L.kcol + (mode == kFull ? chunk * 4 : 0) + kAlign;
  return L;
}

// byte offset of 16-byte chunk c (of Dp / 8) of row r in a tile. The tile
// is the TMA box {64, Dp / 64, ps} with the 128-byte swizzle: row r's
// 128-byte segment u = r Dp / 64 + c / 8 holds chunk c % 8 at (c % 8) ^
// (u % 8), so the eight rows of an ldmatrix fall in eight (Dp 64) or four
// (Dp 128) bank groups and a row's 32 lanes in all 32 banks.
template <int DP>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  const uint32_t u = r * (DP / 64) + (c >> 3);
  return u * 128 + (((c & 7) ^ (u & 7)) << 4);
}
// byte offset of lane l's Dp / 32 elements of row r (Dp / 32 l onwards)
template <int DP>
__device__ __forceinline__ uint32_t lane_off(int r, int lane) {
  constexpr int EPL = DP / 32;
  return tile_off<DP>(r, lane * EPL / 8) + (lane * EPL % 8) * 2;
}
// a lane's Dp / 32 elements of a row, from their first byte, in f32
template <int DP>
__device__ __forceinline__ void load_row(const unsigned char* src, float (&kx)[DP / 32]) {
  if constexpr (DP == 128) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    kx[0] = lo.x, kx[1] = lo.y, kx[2] = hi.x, kx[3] = hi.y;
  } else {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    kx[0] = f.x, kx[1] = f.y;
  }
}
// this lane's sum of |x| over its elements of the rows w + 4 i of a tile,
// lo[i % 2] + 2 Dp r bytes in (see the consumers' lo); where `first`, also
// each row's first element (the lane is lane 0) into col
template <int DP>
__device__ __forceinline__ float abs_sum_rows(const unsigned char* tile, const uint32_t (&lo)[2],
                                              int w, int ps, bool first, float& col) {
  float own = 0.f;
  for (int r = w, i = 0; r < ps; r += kConsumerWarps, ++i) {
    const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(tile + ((i & 1) ? lo[1] : lo[0]) + r * DP * 2);
    if (first) col += __bfloat162float(x[0]);
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) own += fabsf(__bfloat162float(x[e]));
  }
  return own;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also expects `bytes` of asynchronous copies this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();  // a lost arrival fails the launch instead of hanging it
  }
}
// TMA: the 3D box of `map` at (c0 inner, c1, c2) into shared dst,
// completing its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}
// named barrier 1 over the consumer warps; the producer never takes it
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
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

// NG (a power of two) heads' lane sums reduced across the warp in lane_dot's
// tree: level i pairs lane L with L ^ (16 >> i). At the first log2 NG
// levels a lane keeps the sums of half its heads, the upper half where its
// bit (16 >> i) is set, and sends its partner the other half; the levels
// left are a plain butterfly. Returns the row's score for the lane's head,
// lane >> (5 - log2 NG).
template <int NG>
__device__ __forceinline__ float head_tree(float (&v)[NG], int lane) {
#pragma unroll
  for (int n = NG, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[n / 2 + i];
      const float keep = up ? v[n / 2 + i] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float x = v[0];
#pragma unroll
  for (int off = 16 / NG; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  const __nv_bfloat16* q;
  const int* page_table;
  const int* seq_lens;
  __nv_bfloat16* out;
  float* aux;
  float* acc00;  // [B] f32 scratch
  int* counters;  // [B] i32, zero between launches
  int hkv, max_pages, page_size, chunk_pages;
};

template <int DP, int G, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_ablate_kernel(const Args a, const __grid_constant__ CUtensorMap kv_map) {
  static_assert(DP == 64 || DP == 128, "Dp must be 64 or 128");
  static_assert(G >= 1 && G <= 8, "G must be 1 to 8");
  constexpr int EPL = DP / 32;                            // elements of a row per lane
  constexpr int NG = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8;  // heads of the score tree
  constexpr int LOG_NG = NG == 1 ? 0 : NG == 2 ? 1 : NG == 4 ? 2 : 3;
  constexpr int MTW = DP / 16 / kConsumerWarps;          // PV m16 tiles (of head dims) a warp
  constexpr int RU = NG >= 8 ? 2 : 4;                     // rows a warp scores at once
  const int b = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int hq = a.hkv * G;
  const int ps = a.page_size;
  const int CP = a.chunk_pages;
  const int chunk = CP * ps;
  const int ps16 = (ps + 15) / 16 * 16;
  const int ph = pbuf_head(ps, CP);
  const int len = a.seq_lens[b];
  const int nchunks = max((len + chunk - 1) / chunk, 1);
  // a table too narrow for this row's chunks: NaN statistics, nothing read
  const bool fits = (long long)nchunks * CP <= a.max_pages;
  const int nch = fits ? nchunks : 0;  // chunks streamed
  const Layout L = layout(DP, G, MODE, ps, CP);
  const uint32_t stage_b = static_cast<uint32_t>(L.stage);

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  // per-head state, 8 wide (a PV fragment's heads), so that the PV reads
  // alpha of heads 2 tig and 2 tig + 1 with no test against G
  __shared__ __align__(16) float m_s[8], l_s[8], alpha_s[8];
  __shared__ __align__(16) float red[kConsumerWarps][2][8];
  __shared__ float acc00_s;
  __shared__ int last_s;
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + kAlign - 1) & ~(kAlign - 1)) - raw);  // 1024-aligned
  float* sbuf = reinterpret_cast<float*>(smem + L.sbuf);
  __nv_bfloat16* pbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.pbuf);
  float* kcol = reinterpret_cast<float*>(smem + L.kcol);
  const uint32_t ring = smem_u32(smem);  // the tiles' slots

  // the producer's first page-table entries and the tensor map, fetched
  // while the barriers are set up
  const int* pt = a.page_table + (size_t)b * a.max_pages;
  int pages = 0;  // producer lane i: the page-table entry of page j0 + i of the half
  if (warp == kConsumerWarps && nch > 0) {
    pages = lane < CP ? pt[lane] : 0;
    if (lane == 0) asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kv_map)) : "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    acc00_s = 0.f;
  }
  if (tid < 8) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
    alpha_s[tid] = 1.f;  // heads past G keep 1
  }
  if constexpr (MODE == kFull) {  // the pad rows of bf16(p) stay 0
    for (int i = tid; i < G * ph; i += kThreads) pbuf[i] = __float2bfloat16(0.f);
  }
  __syncthreads();

  float own = 0.f;   // dma_only: thread 0's elements; reshape_only: this thread's sum of |x|
  float col0 = 0.f;  // reshape_only, lane 0 of kv head 0: its warp's rows of K_0[:, 0], summed

  if (warp == kConsumerWarps) {
    // the producer, one lane: each chunk's K pages, then its V pages, in
    // turn into the ring's slots; slot s's fill of parity `phase` waits for
    // the consumers' release of its fill before
    int s = 0;
    uint32_t phase = 0;
    bool wrapped = false;
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
#pragma unroll 1
      for (int w = 0; w < 2 * CP; ++w) {
        const int kind = w >= CP;
        const int j = kind ? w - CP : w;
        if ((j & 31) == 0 && (c | w) != 0) pages = j + lane < CP ? pt[c * CP + j + lane] : 0;
        const int page = __shfl_sync(0xffffffffu, pages, j & 31);
        if (lane == 0) {
          if (wrapped) mbar_wait(smem_u32(&empty_bar[s]), phase ^ 1);
          const uint32_t bar = smem_u32(&full_bar[s]);
          mbar_expect_tx(bar, static_cast<uint32_t>(L.tile));
          tma_load_3d(ring + s * stage_b, &kv_map, 0, (2 * k + kind) * (DP / 64), page * ps, bar);
        }
        if (++s == kStages) s = 0, phase ^= 1, wrapped = true;
      }
    }
  } else {
    // the consumers
    [[maybe_unused]] float qv[G][EPL];
    if constexpr (MODE >= kSdotOnly) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          qv[g][e] = __bfloat162float(a.q[((size_t)b * hq + (size_t)k * G + g) * DP + lane * EPL + e]);
    }
    // the byte offset of this lane's elements of row r = w + 4 i of a tile is
    // lo[i % 2] + 2 Dp r: the swizzle of those rows repeats every two
    const uint32_t lo[2] = {lane_off<DP>(warp, lane) - warp * DP * 2,
                            lane_off<DP>(warp + kConsumerWarps, lane) - (warp + kConsumerWarps) * DP * 2};
    [[maybe_unused]] const int head = lane >> (5 - LOG_NG);  // the score tree's head of this lane
    [[maybe_unused]] const bool writer = (lane & ((32 >> LOG_NG) - 1)) == 0 && head < G;
    [[maybe_unused]] float sl = 0.f, sa = 0.f;  // sdot_only: the lane's head's sum of s and of |s|
    // the PV's mma fragments: C[d][h] += V^T[d][rows] p^T[rows][h]; lane
    // (gid, tig) holds head dims gid, gid + 8 of each m16 tile for heads
    // 2 tig, 2 tig + 1; ldmatrix.trans lanes: rows 0-7 | 8-15 by lane bit 4,
    // 8-dim chunks by bit 3
    [[maybe_unused]] const int gid = lane >> 2, tig = lane & 3;
    [[maybe_unused]] const int vrow = (lane & 7) + ((lane >> 4) << 3), vhalf = (lane >> 3) & 1;
    [[maybe_unused]] float acc[MTW][4];
#pragma unroll
    for (int n = 0; n < MTW; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    int s = 0;           // the slot of the next tile
    uint32_t phase = 0;  // the parity of its fill
#pragma unroll 1
    for (int c = 0; c < nch; ++c)
#pragma unroll 1
    for (int w = 0; w < 2 * CP; ++w) {  // the chunk's K pages, then its V pages
      const bool is_k = w < CP;
      const int j = is_k ? w : w - CP;
      mbar_wait(smem_u32(&full_bar[s]), phase);
      const unsigned char* tile = smem + s * stage_b;
      if (is_k) {
        if constexpr (MODE == kDmaOnly) {
          if (j == 0 && tid == 0) own += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile));
        } else if constexpr (MODE == kReshapeOnly) {
          own += abs_sum_rows<DP>(tile, lo, warp, ps, k == 0 && lane == 0, col0);
        } else {
          // this warp's rows w, w + 4, ... of the page, RU at once so that
          // their trees' shuffles overlap
          for (int r0 = warp; r0 < ps; r0 += RU * kConsumerWarps) {
            float v[RU][NG], k0[RU];
#pragma unroll
            for (int u = 0; u < RU; ++u) {  // row r0 + 4 u, or r0 past the page
              const int r = r0 + u * kConsumerWarps;
              float kx[EPL];
              load_row<DP>(tile + (r < ps ? lo[u & 1] + r * DP * 2 : lo[0] + r0 * DP * 2), kx);
              k0[u] = kx[0];
#pragma unroll
              for (int g = 0; g < NG; ++g) {
                float x = 0.f;
                if (g < G) {
                  const float* qg = qv[g < G ? g : 0];
                  x = __fmul_rn(qg[0], kx[0]);  // products of bf16 values are exact
#pragma unroll
                  for (int e = 1; e < EPL; ++e) x = fmaf(qg[e], kx[e], x);
                }
                v[u][g] = x;
              }
            }
            float sc[RU];
#pragma unroll
            for (int u = 0; u < RU; ++u) sc[u] = head_tree<NG>(v[u], lane);
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              const int r = r0 + u * kConsumerWarps;
              if (r < ps) {
                if constexpr (MODE == kSdotOnly) {
                  sl += sc[u];
                  sa += fabsf(sc[u]);
                } else {
                  if (writer) sbuf[head * chunk + j * ps + r] = sc[u];
                  if constexpr (MODE == kFull) {
                    if (k == 0 && lane == 0) kcol[j * ps + r] = k0[u];
                  }
                }
              }
            }
          }
        }
      } else {
        if constexpr (MODE == kReshapeOnly) {
          own += abs_sum_rows<DP>(tile, lo, warp, ps, false, col0);
        } else if constexpr (MODE == kFull) {
          // acc[d][h] += V[rows, d]^T bf16(p)[h, rows]^T, 16 rows a step: A
          // is V by ldmatrix.trans, B bf16(p) of heads gid (0 past G)
          const __nv_bfloat16* pj = pbuf + (size_t)gid * ph + j * ps16;
          for (int k0 = 0; k0 < ps; k0 += 16) {
            uint32_t pb0 = 0u, pb1 = 0u;
            if (gid < G) {
              pb0 = *reinterpret_cast<const uint32_t*>(pj + k0 + 2 * tig);
              pb1 = *reinterpret_cast<const uint32_t*>(pj + k0 + 8 + 2 * tig);
            }
            const int row = min(k0 + vrow, ps - 1);  // rows past the page meet p = 0
            const uint32_t base = ring + s * stage_b;
#pragma unroll
            for (int n = 0; n < MTW; ++n) {
              uint32_t va[4];
              ldsm_x4_t(base + tile_off<DP>(row, (warp * MTW + n) * 2 + vhalf), va);
              mma16816(acc[n], va[0], va[1], va[2], va[3], pb0, pb1);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[s]));  // the slot is free

      if constexpr (MODE >= kNoPv) {
        if (is_k && j == CP - 1) {
          consumers_sync();  // the chunk's scores are all in sbuf
          const int base = c * chunk;
          for (int g = warp; g < G; g += kConsumerWarps) {
            const float* sg = sbuf + g * chunk;
            float mx = kNeg;
#pragma unroll 4
            for (int i = lane; i < chunk; i += 32) mx = fmaxf(mx, base + i < len ? sg[i] : kNeg);
            mx = warp_max(mx);
            const float m_old = m_s[g];
            const float m_new = fmaxf(m_old, mx);
            const float alpha = expf(m_old - m_new);
            float psum = 0.f, k00 = 0.f;
#pragma unroll 4
            for (int i = lane; i < chunk; i += 32) {
              const float p = expf((base + i < len ? sg[i] : kNeg) - m_new);
              psum += p;
              if constexpr (MODE == kFull) {
                const __nv_bfloat16 pq = __float2bfloat16(p);
                pbuf[(size_t)g * ph + (ps == ps16 ? i : (i / ps) * ps16 + i % ps)] = pq;
                if (k == 0 && g == 0) k00 += __bfloat162float(pq) * kcol[i];
              }
            }
            psum = warp_sum(psum);
            if constexpr (MODE == kFull) k00 = warp_sum(k00);
            if (lane == 0) {
              l_s[g] = mul_add(psum, l_s[g], alpha);
              m_s[g] = m_new;
              alpha_s[g] = alpha;
              if (MODE == kFull && k == 0 && g == 0) acc00_s = mul_add(k00, acc00_s, alpha);
            }
          }
          consumers_sync();  // alpha and bf16(p) for the chunk's V pages
          if constexpr (MODE == kFull) {
            const float a0 = alpha_s[2 * tig], a1 = alpha_s[2 * tig + 1];
#pragma unroll
            for (int n = 0; n < MTW; ++n) acc[n][0] *= a0, acc[n][1] *= a1, acc[n][2] *= a0, acc[n][3] *= a1;
          }
        }
      }
      if (++s == kStages) s = 0, phase ^= 1;
    }

    // each warp's share of the checksums that span the CTA
    if constexpr (MODE == kReshapeOnly) {
      const float v = warp_sum(own);
      if (lane == 0) red[warp][0][0] = v, red[warp][1][0] = col0;
    } else if constexpr (MODE == kSdotOnly) {
      if (writer) {
        red[warp][0][head] = sl;
        red[warp][1][head] = sa;
      }
    } else if constexpr (MODE == kFull) {
      // sum_d |acc[d][h]| over this warp's d for heads 2 tig, 2 tig + 1: the
      // lane's dims (gid, gid + 8 of each m16 tile), then the lanes of its tig
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int n = 0; n < MTW; ++n) {
        v0 += fabsf(acc[n][0]) + fabsf(acc[n][2]);
        v1 += fabsf(acc[n][1]) + fabsf(acc[n][3]);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
      }
      if (gid == 0 && 2 * tig < G) red[warp][0][2 * tig] = v0;
      if (gid == 0 && 2 * tig + 1 < G) red[warp][0][2 * tig + 1] = v1;
    }
  }
  __syncthreads();

  if (tid == 0) {
    const float nan = __int_as_float(0x7fc00000);
    for (int g = 0; g < G; ++g) {
      float m = kNeg, l = 0.f, cs = 0.f;
      if constexpr (MODE == kDmaOnly) cs = own;
      if constexpr (MODE == kReshapeOnly || MODE == kFull) {
        const int i = MODE == kReshapeOnly ? 0 : g;
        cs = ((red[0][0][i] + red[1][0][i]) + red[2][0][i]) + red[3][0][i];
      }
      if constexpr (MODE == kSdotOnly) {
        l = ((red[0][0][g] + red[1][0][g]) + red[2][0][g]) + red[3][0][g];
        cs = ((red[0][1][g] + red[1][1][g]) + red[2][1][g]) + red[3][1][g];
      }
      if constexpr (MODE >= kNoPv) {
        m = m_s[g];
        l = l_s[g];
      }
      float* ap = a.aux + ((size_t)b * hq + (size_t)k * G + g) * 3;
      ap[0] = fits ? m : nan;
      ap[1] = fits ? l : nan;
      ap[2] = fits ? cs : nan;
    }
    if (k == 0) {
      float a00 = 0.f;
      if constexpr (MODE == kDmaOnly) a00 = own;
      if constexpr (MODE == kReshapeOnly) a00 = ((red[0][1][0] + red[1][1][0]) + red[2][1][0]) + red[3][1][0];
      if constexpr (MODE == kFull) a00 = acc00_s;
      a.acc00[b] = fits ? a00 : nan;
    }
    // the last CTA of the row to arrive writes out[b] = bf16((m + l) + acc00)
    __threadfence();
    last_s = atomicAdd(a.counters + b, 1) == a.hkv - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // the row's m + l into the ring (free: every tile was consumed), one
  // round trip, then its `out`
  float* ml = reinterpret_cast<float*>(smem);
  const float a00 = __ldcg(a.acc00 + b);
  for (int h = tid; h < hq; h += kThreads) {
    const float* ap = a.aux + ((size_t)b * hq + h) * 3;
    ml[h] = __fadd_rn(__ldcg(ap), __ldcg(ap + 1));
  }
  __syncthreads();
  constexpr int VPR = DP / 8;  // 16-byte stores a head
  for (int i = tid; i < hq * VPR; i += kThreads) {
    const __nv_bfloat16 v = __float2bfloat16(__fadd_rn(ml[i / VPR], a00));
    const __nv_bfloat162 v2 = __halves2bfloat162(v, v);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(&v2);
    reinterpret_cast<uint4*>(a.out + (size_t)b * hq * DP)[i] = make_uint4(w, w, w, w);
  }
  if (tid == 0) a.counters[b] = 0;  // ready for the next launch
}

template <int DP, int G, int MODE>
cudaError_t launch_mode(const Args& a, const CUtensorMap& map, dim3 grid, size_t smem,
                        cudaStream_t st) {
  auto* kern = decode_ablate_kernel<DP, G, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, st>>>(a, map);
  return cudaGetLastError();
}

template <int DP, int G>
cudaError_t launch_g(int mode, const Args& a, const CUtensorMap& map, dim3 grid, size_t smem,
                     cudaStream_t st) {
  switch (mode) {
    case kDmaOnly:
      return launch_mode<DP, G, kDmaOnly>(a, map, grid, smem, st);
    case kReshapeOnly:
      return launch_mode<DP, G, kReshapeOnly>(a, map, grid, smem, st);
    case kSdotOnly:
      return launch_mode<DP, G, kSdotOnly>(a, map, grid, smem, st);
    case kNoPv:
      return launch_mode<DP, G, kNoPv>(a, map, grid, smem, st);
    case kFull:
      return launch_mode<DP, G, kFull>(a, map, grid, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_dp(int G, int mode, const Args& a, const CUtensorMap& map, dim3 grid,
                      size_t smem, cudaStream_t st) {
  switch (G) {
    case 1:
      return launch_g<DP, 1>(mode, a, map, grid, smem, st);
    case 2:
      return launch_g<DP, 2>(mode, a, map, grid, smem, st);
    case 3:
      return launch_g<DP, 3>(mode, a, map, grid, smem, st);
    case 4:
      return launch_g<DP, 4>(mode, a, map, grid, smem, st);
    case 8:
      return launch_g<DP, 8>(mode, a, map, grid, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// the tensor map of the pool kv [pages, ps, 2 Hkv, Dp] viewed as [pages ps,
// 2 Hkv Dp / 64, 64] bf16, in boxes {64, Dp / 64, ps}: one page of one lane
// block (K or V of one kv head), 128-byte swizzled
cudaError_t kv_tensor_map(CUtensorMap* map, const void* kv, long long pages, int hkv, int dp,
                          int ps) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;  // looked up at run time: no link to libcuda
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {64, (cuuint64_t)(2 * hkv * dp / 64), (cuuint64_t)(pages * ps)};
  const cuuint64_t strides[2] = {128, (cuuint64_t)(2 * hkv * dp * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)(dp / 64), (cuuint32_t)ps};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(kv), dims,
                            strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory a CTA of `mode` needs (bytes), or 0 where the
// kernel does not take the shape: a page of more than 256 rows (a TMA box's
// limit), a row whose Hq f32 do not fit the ring (the tail's m + l), or
// more than the card's 227 KB beside the static arrays.
extern "C" int decode_ablate_smem_bytes(int num_q_heads, int num_kv_heads, int dp, int page_size,
                                        int chunk_pages, int mode) {
  if (num_kv_heads <= 0 || num_q_heads % num_kv_heads || page_size <= 0 || page_size > 256 ||
      chunk_pages <= 0 || mode < kDmaOnly || mode > kFull)
    return 0;
  const Layout L = layout(dp, num_q_heads / num_kv_heads, mode, page_size, chunk_pages);
  if ((long long)num_q_heads * 4 > kStages * L.stage) return 0;
  return L.total + kStaticSmem <= kMaxSmem ? static_cast<int>(L.total) : 0;
}

// q [B, Hq, Dp] bf16; kv [num_pages, page_size, 2 Hkv, Dp] bf16, 16-byte
// aligned (K of kv head k in lane block 2k, its V in 2k + 1); page_table i32
// [B, max_pages], entries below num_pages; seq_lens i32
// [B]; mode 0..4 (dma_only, reshape_only, sdot_only, no_pv, full); G = Hq /
// Hkv in {1, 2, 3, 4, 8}, Dp 64 or 128. Writes out [B, Hq, Dp] bf16, aux
// [B, Hq, 3] f32 and acc00 [B] f32 (scratch); counters [B] i32 must be zero
// and are left zero. Returns a cudaError_t (0 = launched).
extern "C" int decode_ablate(const void* q, const void* kv, const void* page_table,
                             const void* seq_lens, void* out, void* aux, void* acc00,
                             void* counters, int batch, int num_q_heads, int num_kv_heads, int dp,
                             long long num_pages, int max_pages, int page_size, int chunk_pages,
                             int mode, void* stream) {
  if (batch == 0) return 0;
  const int smem = decode_ablate_smem_bytes(num_q_heads, num_kv_heads, dp, page_size, chunk_pages, mode);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.page_table = static_cast<const int*>(page_table);
  a.seq_lens = static_cast<const int*>(seq_lens);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.aux = static_cast<float*>(aux);
  a.acc00 = static_cast<float*>(acc00);
  a.counters = static_cast<int*>(counters);
  a.hkv = num_kv_heads;
  a.max_pages = max_pages;
  a.page_size = page_size;
  a.chunk_pages = chunk_pages;
  const int G = num_q_heads / num_kv_heads;
  const dim3 grid(batch, num_kv_heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dp != 64 && dp != 128) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const cudaError_t err = kv_tensor_map(&map, kv, num_pages, num_kv_heads, dp, page_size);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dp == 64 ? launch_dp<64>(G, mode, a, map, grid, smem, st)
                                   : launch_dp<128>(G, mode, a, map, grid, smem, st));
}
