// Split-K decode attention for Hopper (sm_90a), dense and paged caches,
// with a plain C interface. One launch per call.
//
// Replaces two TPU kernels: `_decode_kernel` / `decode_attention_fwd` in
// src/repro/kernels/decode_attention.py (a contiguous cache [b, S, kvh,
// d]) and `_paged_decode_kernel` / `paged_decode_attention_fwd` in
// src/repro/kernels/paged_attention.py (pages [nb, bs, kvh, d] reached
// through block_tables [b, nblk]). One query token per row, q [b, h, d];
// row i attends to its positions < lengths[i], scores and (acc, m, l) in
// f32, output in q's dtype. A row whose length is 0 gets 0, as the TPU
// kernels give (their only step never runs).
//
// Bound: memory. The call must read the K and V rows of every filled
// position once: at the serving path's decode step (b=8, h=24, kvh=2,
// d=128, bf16, lengths up to 576) that is at most 4.7 MB, ~1.4 us at
// 3.35 TB/s, and 4 flops per position and head-dim element. At b=8 and
// kvh=2 there are only 16 (row, kv head) pairs for 132 SMs, so what
// sets the time is how many copies are in flight on how many SMs, and
// the fixed cost of a launch and of the merge.
//
// Design: the Pallas kernels run the position axis as a sequential grid
// axis carrying (acc, m, l) in VMEM. Here the positions are split into
// chunks run by separate blocks (row, kv head, split), each reducing its
// chunk for all g = h/kvh <= 16 query heads of the kv head. The last
// block of a (row, kv head) to finish merges the splits' partials and
// writes out: every block stores its partial (acc, m, l) in f32 scratch
// and counts itself in on a per-(row, kv head) counter with one
// acquire-release atomicAdd; the block that sees the count complete
// copies the partials back from L2 into shared memory with cp.async (all
// in flight at once), M = max m_s, o = sum acc_s 2^(m_s-M) / sum l_s
// 2^(m_s-M), and resets the counter to 0 for the next call. A row with
// one split writes out directly. Splits that start at or past the
// length exit at once (the count expects only the splits that hold a
// position).
//
// bf16 entry: the g query heads are one m16 A fragment (rows >= g zero),
// staged once in bf16 and kept in registers. Each of the 4 warps walks
// its own 16-position sub-tiles of the block's chunk (warp w takes
// sub-tiles w, w+4, ...) through a private 3-stage ring of bf16 K and V
// tiles in shared memory, filled by cp.async 16-byte copies: two
// sub-tiles are in flight while one is computed, with no block-wide
// barrier in the loop. QK^T and PV run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators), the online softmax on the fragments in
// base 2; the warps' states are merged through shared memory at the end.
// The paged entry looks the page up once per page and sub-tile: the lane
// of a page's first position reads block_tables[row, pos / bs] and the
// other lanes take it by shuffle, not once per staged element.
//
// f32 entry: f32 arithmetic on the f32 cores (no TF32): 4 warps of 4
// query heads, lane j scores position j of a 32-position tile staged in
// shared memory as f32 (online_softmax.cuh), the same split-and-merge.
//
// Positions >= lengths[row] are masked: the tail of a partly filled
// last page, the scratch page 0 that inactive rows point at (length 1,
// so they read its slot 0 and stay finite), and a dense cache's ragged
// tail (S need not be a multiple of the tile; the TPU kernel pads its
// cache view to a block multiple). Block-table entries must name pages
// of the pool: the kernel reads them unchecked. Calls that share the
// counters must be ordered (one stream).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper_mma.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;                // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;                // g = h / kvh <= 16
constexpr float kNegInf = -1e30f;

// Where position `pos` of row `row`, kv head `kh`, lives. The bf16
// kernel asks in two steps, so that the block-table read of a sub-tile
// is in flight long before its copies are issued: page_of (each lane of
// a warp, for the sub-tile's positions p0 + (lane & 15)), then
// sub_tile_offset with what page_of returned.
struct DenseCache {
  int S, kvh, d;
  __device__ __forceinline__ long long offset(long long row, int pos,
                                              int kh) const {
    return ((row * S + pos) * kvh + kh) * static_cast<long long>(d);
  }
  __device__ __forceinline__ int page_of(long long, int, int) const {
    return 0;
  }
  __device__ __forceinline__ long long sub_tile_offset(long long row, int p0,
                                                       int kh, int lane,
                                                       int) const {
    return offset(row, p0 + (lane & 15), kh);
  }
};

struct PagedCache {
  const int* block_tables;   // [b, nblk]
  int bs, nblk, kvh, d;
  __device__ __forceinline__ long long offset(long long row, int pos,
                                              int kh) const {
    const long long page = block_tables[row * nblk + pos / bs];
    return ((page * bs + pos % bs) * kvh + kh) * static_cast<long long>(d);
  }
  // One table read per page of the sub-tile, by the lane of the page's
  // first position in it (the others return 0). Every column < nblk is
  // inside the table, so this may run before the row's length is known;
  // a page past the length is never copied from.
  __device__ __forceinline__ int page_of(long long row, int p0,
                                         int lane) const {
    const int pos = p0 + (lane & 15);
    if (lane < 16 && pos < nblk * bs && ((lane & 15) == 0 || pos % bs == 0))
      return block_tables[row * nblk + pos / bs];
    return 0;
  }
  // The other lanes of the page take it by shuffle.
  __device__ __forceinline__ long long sub_tile_offset(long long, int p0,
                                                       int kh, int lane,
                                                       int page) const {
    const int i = lane & 15;
    const int slot = (p0 + i) % bs;
    page = __shfl_sync(hop::kFull, page, max(0, i - slot));
    return ((static_cast<long long>(page) * bs + slot) * kvh + kh) *
           static_cast<long long>(d);
  }
};

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  uint2 u;
  u.x = hop::pack_bf16x2(x.x, x.y);
  u.y = hop::pack_bf16x2(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// Out-of-range splits exit; split 0 of a row of length 0 writes zeros.
// Returns whether the block has work.
template <typename T>
__device__ __forceinline__ bool split_has_work(int split, int active,
                                               T* orow, int n) {
  if (split < active) return true;
  if (split == 0)
    for (int i = threadIdx.x; i < n; i += blockDim.x) orow[i] = T(0.f);
  return false;
}

// Floats of one split's partial: acc [g, d], then (m, l) for up to
// kMaxGroup rows (so every partial starts 16-byte aligned).
__host__ __device__ constexpr int ml_floats() { return 2 * kMaxGroup; }

// Called by every thread of a block after it stored its partial: the
// last of the pair's `active` split blocks merges them into orow [g, d].
// part_acc: [pairs * nsplit, g, d]; part_ml: [pairs * nsplit, kMaxGroup,
// 2] (m, l), m in base 2 (kBase2) or e. The partials come back from L2
// by cp.async into `stage` (stage_floats of the block's shared memory,
// free by now), as many splits at a time as fit, so their loads are in
// flight together; each thread then merges its elements (at most
// kMaxGroup * 128 / 4 / 128 = 4) with a running maximum.
template <typename T, bool kBase2>
__device__ void merge_if_last(const float* part_acc, const float* part_ml,
                              int* counters, T* orow, long long pair,
                              int nsplit, int active, int g, int d,
                              float* stage, int stage_floats) {
  constexpr int kEl = kMaxGroup * attn::kMaxD / 4 / kThreads;
  __shared__ int s_last;
  __syncthreads();                     // every store of the partial issued
  if (threadIdx.x == 0)
    s_last = hop::atomic_add_acq_rel(counters + pair, 1) == active - 1;
  __syncthreads();
  if (!s_last) return;
  const int gd = g * d, d4 = d >> 2;
  const int per = gd + ml_floats();
  const int batch = max(1, min(active, stage_floats / per));
  float* sml = stage + batch * gd;
  float mx[kEl], sum[kEl];
  float4 o[kEl];
#pragma unroll
  for (int e = 0; e < kEl; ++e) {
    mx[e] = kNegInf;
    sum[e] = 0.f;
    o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int s0 = 0; s0 < active; s0 += batch) {
    const int nb = min(batch, active - s0);
    const float* acc_src = part_acc + (pair * nsplit + s0) * gd;
    const float* ml_src = part_ml + (pair * nsplit + s0) * ml_floats();
    for (int i = threadIdx.x; i < nb * gd / 4; i += kThreads)
      hop::cp_async16(stage + 4 * i, acc_src + 4 * i, 16);
    for (int i = threadIdx.x; i < nb * ml_floats() / 4; i += kThreads)
      hop::cp_async16(sml + 4 * i, ml_src + 4 * i, 16);
    hop::cp_async_commit();
    hop::cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEl; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      if (idx >= g * d4) continue;
      const int r = idx / d4, c = (idx - r * d4) * 4;
      for (int sp = 0; sp < nb; ++sp) {
        const float m_s = sml[sp * ml_floats() + 2 * r];
        const float l_s = sml[sp * ml_floats() + 2 * r + 1];
        const float4 a =
            *reinterpret_cast<const float4*>(stage + sp * gd + r * d + c);
        const float m_new = fmaxf(mx[e], m_s);
        const float f_old = kBase2 ? exp2f(mx[e] - m_new) : expf(mx[e] - m_new);
        const float f = kBase2 ? exp2f(m_s - m_new) : expf(m_s - m_new);
        mx[e] = m_new;
        sum[e] = sum[e] * f_old + l_s * f;
        o[e].x = o[e].x * f_old + a.x * f;
        o[e].y = o[e].y * f_old + a.y * f;
        o[e].z = o[e].z * f_old + a.z * f;
        o[e].w = o[e].w * f_old + a.w * f;
      }
    }
    __syncthreads();                   // the stage is free for the next
  }
#pragma unroll
  for (int e = 0; e < kEl; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    if (idx >= g * d4) continue;
    const int r = idx / d4, c = (idx - r * d4) * 4;
    const float inv = 1.f / fmaxf(sum[e], 1e-30f);
    store4(orow + r * d + c, make_float4(o[e].x * inv, o[e].y * inv,
                                         o[e].z * inv, o[e].w * inv));
  }
  if (threadIdx.x == 0) counters[pair] = 0;    // ready for the next call
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, a cp.async ring per warp
// ---------------------------------------------------------------------------

constexpr int kSub = 16;          // positions per warp sub-tile
constexpr int kStages = 3;        // sub-tiles per warp ring

template <int KD>
constexpr size_t bf16_smem_bytes() {   // q tile + each warp's K/V ring
  return sizeof(bf16) * hop::row_stride(KD) *
         (kSub + kWarps * kStages * 2 * kSub);
}

template <int KD, typename Cache>
__global__ void __launch_bounds__(kThreads, 2)
decode_split_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const int* __restrict__ lengths, Cache cache,
                         float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int* counters,
                         bf16* __restrict__ out, int S, int h, int kvh,
                         int d, int chunk, int nsplit, float scale_log2) {
  constexpr int kS = hop::row_stride(KD);
  constexpr int kChunks = 2 * KD;             // 16-byte chunks per row
  constexpr int kNB = 2 * KD;                 // 8-column blocks of o
  constexpr int kOS = 16 * KD + 8;            // f32 row stride, merge
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* rings = qs + kSub * kS;
  __shared__ float s_m[kWarps][16], s_l[kWarps][16];
  __shared__ float s_rm[16], s_rl[16];

  const int split = static_cast<int>(blockIdx.x % nsplit);
  const long long pair = blockIdx.x / nsplit;       // row * kvh + kh
  const int kh = static_cast<int>(pair % kvh);
  const long long row = pair / kvh;
  const int g = h / kvh;
  const int start = split * chunk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int dc = d >> 3;

  // In flight with the length's load: q's copy and the pages of the
  // warp's first kStages sub-tiles (they need no length).
  const bf16* qg = q + pair * g * d;
  for (int idx = tid; idx < kSub * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = r < g && c < dc;
    hop::cp_async16(qs + r * kS + c * 8, ok ? qg + r * d + c * 8 : qg,
                    ok ? 16 : 0);
  }
  hop::cp_async_commit();
  auto sub_p0 = [&](int i) { return start + (warp + i * kWarps) * kSub; };
  int page[kStages];
#pragma unroll
  for (int i = 0; i < kStages; ++i)
    page[i] = cache.page_of(row, sub_p0(i), lane);

  const int len = min(lengths[row], S);
  const int active = len > 0 ? (len + chunk - 1) / chunk : 0;
  bf16* orow = out + pair * g * d;
  if (!split_has_work(split, active, orow, g * d)) {
    hop::cp_async_wait<0>();
    return;
  }
  const int end = min(start + chunk, len);
  const int n_sub = (end - start + kSub - 1) / kSub;
  const int mine = warp < n_sub ? (n_sub - warp + kWarps - 1) / kWarps : 0;
  bf16* ring = rings + warp * kStages * 2 * kSub * kS;
  // the warp's i-th sub-tile (positions sub_p0(i) ...) from page `pg`
  // into ring slot i % kStages: K rows then V rows
  auto load_sub = [&](int i, int pg) {
    const int p0 = sub_p0(i);
    const long long off = cache.sub_tile_offset(row, p0, kh, lane, pg);
    const int valid = p0 + (lane & 15) < end;
    bf16* ks = ring + (i % kStages) * 2 * kSub * kS;
    bf16* vs = ks + kSub * kS;
#pragma unroll
    for (int j = 0; j < KD; ++j) {            // kSub * kChunks / 32
      const int idx = lane + 32 * j;
      const int r = idx / kChunks, c = idx - r * kChunks;
      const long long ro = __shfl_sync(hop::kFull, off, r);
      const bool ok = __shfl_sync(hop::kFull, valid, r) && c < dc;
      hop::cp_async16(ks + r * kS + c * 8, ok ? k + ro + c * 8 : k,
                      ok ? 16 : 0);
      hop::cp_async16(vs + r * kS + c * 8, ok ? v + ro + c * 8 : v,
                      ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) load_sub(i, page[i]);
    hop::cp_async_commit();
  }
  int next_page = page[kStages - 1];          // of sub-tile kStages - 1
  hop::cp_async_wait<kStages - 1>();          // q (the oldest group)
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    hop::ldsm_x4(qa[kk], qs + (lane & 15) * kS + kk * 16 + ((lane >> 4) << 3));

  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) {
      // the page read for the sub-tile after runs during this one's math
      const int pg = next_page;
      next_page = cache.page_of(row, sub_p0(i + kStages), lane);
      load_sub(i + kStages - 1, pg);
    }
    hop::cp_async_commit();
    hop::cp_async_wait<kStages - 1>();        // sub-tile i has landed
    __syncwarp();
    const int p0 = sub_p0(i);
    const bf16* ks = ring + (i % kStages) * 2 * kSub * kS;
    const bf16* vs = ks + kSub * kS;

    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t b[4];
      hop::ldsm_x4(b, ks + ((lane & 7) + ((lane >> 4) << 3)) * kS + kk * 16 +
                          (((lane >> 3) & 1) << 3));
      hop::mma_bf16(sc[0], qa[kk], b[0], b[1]);
      hop::mma_bf16(sc[1], qa[kk], b[2], b[3]);
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + nb * 8 + 2 * t + (e & 1);
        sc[nb][e] = pos < end ? sc[nb][e] * scale_log2 : kNegInf;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {             // rows gq (e 0, 1), gq+8
      const float mx = fmaxf(fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
                             fmaxf(sc[1][2 * r], sc[1][2 * r + 1]));
      const float m_new = fmaxf(m[r], hop::quad_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        sc[nb][2 * r] = exp2f(sc[nb][2 * r] - m_new);
        sc[nb][2 * r + 1] = exp2f(sc[nb][2 * r + 1] - m_new);
        sum += sc[nb][2 * r] + sc[nb][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        acc[nb][2 * r] *= alpha;
        acc[nb][2 * r + 1] *= alpha;
      }
    }
    const uint32_t pa[4] = {hop::pack_bf16x2(sc[0][0], sc[0][1]),
                            hop::pack_bf16x2(sc[0][2], sc[0][3]),
                            hop::pack_bf16x2(sc[1][0], sc[1][1]),
                            hop::pack_bf16x2(sc[1][2], sc[1][3])};
#pragma unroll
    for (int np = 0; np < KD; ++np) {
      uint32_t b[4];
      hop::ldsm_x4_t(b, vs + (lane & 15) * kS + np * 16 + ((lane >> 4) << 3));
      hop::mma_bf16(acc[2 * np], pa, b[0], b[1]);
      hop::mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
    }
    __syncwarp();                             // slot free for a refill
  }

  // merge the 4 warps' states through shared memory (over the rings)
  hop::cp_async_wait<0>();
  l[0] = hop::quad_sum(l[0]);
  l[1] = hop::quad_sum(l[1]);
  if (t == 0) {
    s_m[warp][gq] = m[0];
    s_m[warp][gq + 8] = m[1];
    s_l[warp][gq] = l[0];
    s_l[warp][gq + 8] = l[1];
  }
  __syncthreads();                            // every ring is consumed
  float* ob = reinterpret_cast<float*>(rings);        // [warp][16][kOS]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row16 = gq + 8 * r;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][row16]);
    const float f = exp2f(m[r] - mx);
    float* orow16 = ob + (warp * 16 + row16) * kOS;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      *reinterpret_cast<float2*>(orow16 + nb * 8 + 2 * t) =
          make_float2(acc[nb][2 * r] * f, acc[nb][2 * r + 1] * f);
  }
  if (tid < 16) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][tid]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += s_l[w][tid] * exp2f(s_m[w][tid] - mx);
    s_rm[tid] = mx;
    s_rl[tid] = sum;
  }
  __syncthreads();

  const long long part = pair * nsplit + split;
  float* pacc = part_acc + part * g * d;
  const int d4 = d >> 2;
  for (int idx = tid; idx < g * d4; idx += kThreads) {
    const int r = idx / d4, c = (idx - r * d4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 a =
          *reinterpret_cast<const float4*>(ob + (w * 16 + r) * kOS + c);
      o.x += a.x;
      o.y += a.y;
      o.z += a.z;
      o.w += a.w;
    }
    if (active == 1) {                        // the only split: write out
      const float inv = 1.f / fmaxf(s_rl[r], 1e-30f);
      store4(orow + r * d + c,
             make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
    } else {
      store4(pacc + r * d + c, o);
    }
  }
  if (active == 1) return;
  if (tid < g) {
    part_ml[part * ml_floats() + 2 * tid] = s_rm[tid];
    part_ml[part * ml_floats() + 2 * tid + 1] = s_rl[tid];
  }
  merge_if_last<bf16, true>(
      part_acc, part_ml, counters, orow, pair, nsplit, active, g, d,
      reinterpret_cast<float*>(rings),
      static_cast<int>(kWarps * kStages * 2 * kSub * kS * sizeof(bf16) /
                       sizeof(float)));
}

// ---------------------------------------------------------------------------
// f32: f32 FMAs on the f32 cores, the tile step of online_softmax.cuh
// ---------------------------------------------------------------------------

namespace f32 {

using namespace attn;

constexpr int kRows = 4;                     // query heads per warp
constexpr size_t kSmemBytes = sizeof(float) * (kMaxGroup * kQStride +
                                               kTile * kKStride +
                                               kTile * kVStride);

template <typename Cache>
__global__ void __launch_bounds__(kThreads)
decode_split_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ lengths, Cache cache,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int* counters,
                        float* __restrict__ out, int S, int h, int kvh,
                        int d, int chunk, int nsplit, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kMaxGroup * kQStride;
  float* vs = ks + kTile * kKStride;

  const int split = static_cast<int>(blockIdx.x % nsplit);
  const long long pair = blockIdx.x / nsplit;
  const int kh = static_cast<int>(pair % kvh);
  const long long row = pair / kvh;
  const int g = h / kvh;
  const int len = min(lengths[row], S);
  const int active = len > 0 ? (len + chunk - 1) / chunk : 0;
  float* orow = out + pair * g * d;
  if (!split_has_work(split, active, orow, g * d)) return;
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int idx = tid; idx < kMaxGroup * kQStride; idx += kThreads) {
    const int r = idx / kQStride, c = idx - r * kQStride;
    qs[idx] = (r < g && c < d) ? q[(pair * g + r) * d + c] : 0.f;
  }

  RowState<kRows> st;
  st.init();
  const float* qw = qs + warp * kRows * kQStride;
  for (int t0 = start; t0 < end; t0 += kTile) {
    __syncthreads();            // q is staged / the previous tile consumed
    for (int idx = tid; idx < kTile * kMaxD; idx += kThreads) {
      const int j = idx / kMaxD, c = idx - j * kMaxD;
      const int pos = t0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (c < d && pos < end) {
        const long long off = cache.offset(row, pos, kh) + c;
        kv_k = k[off];
        kv_v = v[off];
      }
      ks[j * kKStride + c] = kv_k;
      vs[j * kVStride + c] = kv_v;
    }
    __syncthreads();
    tile_update<kRows>(
        qw, ks, vs, d, scale, [&](int, int j) { return t0 + j < end; }, st);
  }

  const long long part = pair * nsplit + split;
  float* acc_out = part_acc + part * g * d;
  float* ml_out = part_ml + part * ml_floats();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int gr = warp * kRows + r;
    if (gr >= g) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < d) acc_out[gr * d + c] = st.acc[r][i];
    }
    if (lane == 0) {
      ml_out[2 * gr] = st.m[r];
      ml_out[2 * gr + 1] = st.l[r];
    }
  }
  merge_if_last<float, false>(part_acc, part_ml, counters, orow, pair,
                              nsplit, active, g, d, qs,
                              static_cast<int>(kSmemBytes / sizeof(float)));
}

}  // namespace f32

template <int KD, typename Cache>
int launch_bf16(const void* q, const void* k, const void* v,
                const void* lengths, Cache cache, void* out, void* part_acc,
                void* part_ml, void* counters, long long blocks, int S,
                int h, int kvh, int d, int chunk, int nsplit, float scale,
                cudaStream_t stream) {
  constexpr size_t kSmem = bf16_smem_bytes<KD>();
  const cudaError_t err =
      hop::allow_smem<decode_split_bf16_kernel<KD, Cache>>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_bf16_kernel<KD, Cache>
      <<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const int*>(lengths),
          cache, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
          static_cast<int*>(counters), static_cast<bf16*>(out), S, h, kvh, d,
          chunk, nsplit, scale * hop::kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Cache>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           Cache cache, void* out, void* part_acc, void* part_ml,
           void* counters, int b, int S, int h, int kvh, int d, int chunk,
           int nsplit, float scale, void* stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || h / kvh > kMaxGroup || d <= 0 ||
      d > attn::kMaxD || d % (kBf16 ? 8 : 4) != 0 || S <= 0 || chunk <= 0 ||
      nsplit <= 0 ||
      static_cast<long long>(chunk) * nsplit < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(b) * kvh * nsplit;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kBf16) {
    if (d <= 32)
      return launch_bf16<2>(q, k, v, lengths, cache, out, part_acc, part_ml,
                            counters, blocks, S, h, kvh, d, chunk, nsplit,
                            scale, st);
    if (d <= 64)
      return launch_bf16<4>(q, k, v, lengths, cache, out, part_acc, part_ml,
                            counters, blocks, S, h, kvh, d, chunk, nsplit,
                            scale, st);
    if (d <= 80)
      return launch_bf16<5>(q, k, v, lengths, cache, out, part_acc, part_ml,
                            counters, blocks, S, h, kvh, d, chunk, nsplit,
                            scale, st);
    return launch_bf16<8>(q, k, v, lengths, cache, out, part_acc, part_ml,
                          counters, blocks, S, h, kvh, d, chunk, nsplit,
                          scale, st);
  } else {
    f32::decode_split_f32_kernel<Cache>
        <<<static_cast<unsigned>(blocks), kThreads, f32::kSmemBytes, st>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const int*>(lengths),
            cache, static_cast<float*>(part_acc),
            static_cast<float*>(part_ml), static_cast<int*>(counters),
            static_cast<float*>(out), S, h, kvh, d, chunk, nsplit, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, void* part_acc,
                 void* part_ml, void* counters, int b, int S, int h, int kvh,
                 int d, int chunk, int nsplit, float scale, void* stream) {
  return launch<T>(q, k, v, lengths, DenseCache{S, kvh, d}, out, part_acc,
                   part_ml, counters, b, S, h, kvh, d, chunk, nsplit, scale,
                   stream);
}

template <typename T>
int launch_paged(const void* q, const void* k, const void* v,
                 const void* block_tables, const void* lengths, void* out,
                 void* part_acc, void* part_ml, void* counters, int b, int bs,
                 int nblk, int h, int kvh, int d, int chunk, int nsplit,
                 float scale, void* stream) {
  if (bs <= 0 || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedCache cache{static_cast<const int*>(block_tables), bs, nblk,
                         kvh, d};
  return launch<T>(q, k, v, lengths, cache, out, part_acc, part_ml, counters,
                   b, bs * nblk, h, kvh, d, chunk, nsplit, scale, stream);
}

}  // namespace

extern "C" {

// q, out: [b, h, d]; k, v: [b, S, kvh, d]; lengths: [b] int32; all
// contiguous. Scratch: part_acc b*kvh*nsplit*(h/kvh)*d f32, part_ml
// b*kvh*nsplit*32 f32, and counters: b*kvh int32, all 0 on entry
// (they are 0 again on exit). Split sp covers positions [sp*chunk,
// (sp+1)*chunk); chunk*nsplit >= S. h/kvh <= 16, d <= 128,
// d % 4 == 0 (f32) or d % 8 == 0 with 16-byte aligned q, k, v, out
// (bf16). Returns cudaGetLastError() after the launch (0 on success).
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* part_acc,
                         void* part_ml, void* counters, int b, int S, int h,
                         int kvh, int d, int chunk, int nsplit, float scale,
                         void* stream) {
  return launch_dense<float>(q, k, v, lengths, out, part_acc, part_ml,
                             counters, b, S, h, kvh, d, chunk, nsplit, scale,
                             stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, void* part_acc,
                          void* part_ml, void* counters, int b, int S, int h,
                          int kvh, int d, int chunk, int nsplit, float scale,
                          void* stream) {
  return launch_dense<__nv_bfloat16>(q, k, v, lengths, out, part_acc,
                                     part_ml, counters, b, S, h, kvh, d,
                                     chunk, nsplit, scale, stream);
}

// As decode_attention_* with the cache in pages k, v: [nb, bs, kvh, d]
// and block_tables: [b, nblk] int32 (position p of row i is slot p % bs
// of page block_tables[i, p / bs]); S = nblk * bs.
int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* block_tables, const void* lengths,
                               void* out, void* part_acc, void* part_ml,
                               void* counters, int b, int bs, int nblk, int h,
                               int kvh, int d, int chunk, int nsplit,
                               float scale, void* stream) {
  return launch_paged<float>(q, k, v, block_tables, lengths, out, part_acc,
                             part_ml, counters, b, bs, nblk, h, kvh, d, chunk,
                             nsplit, scale, stream);
}

int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* block_tables,
                                const void* lengths, void* out,
                                void* part_acc, void* part_ml,
                                void* counters, int b, int bs, int nblk,
                                int h, int kvh, int d, int chunk, int nsplit,
                                float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(q, k, v, block_tables, lengths, out,
                                     part_acc, part_ml, counters, b, bs,
                                     nblk, h, kvh, d, chunk, nsplit, scale,
                                     stream);
}

}  // extern "C"
