// Split-K decode attention for Hopper (sm_90a), dense and paged caches,
// with a plain C interface.
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
// 3.35 TB/s, and 4 flops per position and head-dim element, far under
// the f32 rate. So a decode step's 30 calls are set by launches and by
// how many SMs the few (row, kv head) pairs can keep busy.
//
// Design: the Pallas kernels run the position axis as a sequential grid
// axis carrying (acc, m, l) in VMEM. At b=8 and kvh=2 there are only 16
// (row, kv head) pairs for 132 SMs, so here the positions are split into
// chunks run by separate blocks (pass 1: block (row, kv head, split)
// reduces its chunk for all g = h/kvh query heads of the kv head into a
// partial (acc, m, l) in f32 scratch), and pass 2 combines the splits
// per (row, head): M = max m_s, o = sum acc_s e^(m_s-M) / sum l_s
// e^(m_s-M). The TPU kernel's scalar prefetch of the block table becomes
// a plain load: each element of a staged tile looks up its page as
// block_tables[row, pos / bs]. Positions >= lengths[row] are masked:
// the tail of a partly filled last page, the scratch page 0 that
// inactive rows point at (length 1, so they read its slot 0 and stay
// finite), and a dense cache's ragged tail (S need not be a multiple of
// the tile; the TPU kernel pads its cache view to a block multiple).
// Splits that start at or past the length exit at once after writing an
// empty partial. Block-table entries must name pages of the pool: the
// kernel reads them unchecked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "online_softmax.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;
constexpr int kRows = 4;                     // query heads per warp
constexpr int kMaxGroup = kWarps * kRows;    // g = h / kvh <= 16
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemBytes = sizeof(float) * (kMaxGroup * kQStride +
                                               kTile * kKStride +
                                               kTile * kVStride);

// Where position `pos` of row `row`, kv head `kh`, lives.
struct DenseCache {
  int S, kvh, d;
  __device__ __forceinline__ long long offset(long long row, int pos,
                                              int kh) const {
    return ((row * S + pos) * kvh + kh) * static_cast<long long>(d);
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
};

// part_acc: [b*kvh*nsplit, g, d]; part_ml: [b*kvh*nsplit, g, 2] (m, l).
template <typename T, typename Cache>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    Cache cache, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int S, int h, int kvh,
                    int d, int chunk, int nsplit, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kMaxGroup * kQStride;
  float* vs = ks + kTile * kKStride;

  const long long part = blockIdx.x;
  const int split = static_cast<int>(part % nsplit);
  const int kh = static_cast<int>((part / nsplit) % kvh);
  const long long row = part / nsplit / kvh;
  const int g = h / kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int len = min(lengths[row], S);
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  float* acc_out = part_acc + part * g * d;
  float* ml_out = part_ml + part * g * 2;
  if (start >= end) {                      // nothing to attend to here
    for (int idx = tid; idx < g * d; idx += kThreads) acc_out[idx] = 0.f;
    for (int r = tid; r < g; r += kThreads) {
      ml_out[2 * r] = kNegInf;
      ml_out[2 * r + 1] = 0.f;
    }
    return;
  }

  for (int idx = tid; idx < kMaxGroup * kQStride; idx += kThreads) {
    const int r = idx / kQStride, c = idx - r * kQStride;
    qs[idx] = (r < g && c < d)
                  ? to_f32(q[(row * h + kh * g + r) * static_cast<long long>(d) + c])
                  : 0.f;
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
        kv_k = to_f32(k[off]);
        kv_v = to_f32(v[off]);
      }
      ks[j * kKStride + c] = kv_k;
      vs[j * kVStride + c] = kv_v;
    }
    __syncthreads();
    tile_update<kRows>(
        qw, ks, vs, d, scale, [&](int, int j) { return t0 + j < end; }, st);
  }

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
}

// One block per (row, head): combine the head's nsplit partials.
template <typename T>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, T* __restrict__ out,
                      int h, int kvh, int d, int nsplit) {
  const long long bi = blockIdx.x / h;
  const int head = static_cast<int>(blockIdx.x % h);
  const int g = h / kvh;
  const int kh = head / g, gr = head % g;
  const long long part0 = (bi * kvh + kh) * nsplit;
  float m_max = kNegInf;
  for (int sp = 0; sp < nsplit; ++sp)
    m_max = fmaxf(m_max, part_ml[((part0 + sp) * g + gr) * 2]);
  float l_sum = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) {
    const float* ml = part_ml + ((part0 + sp) * g + gr) * 2;
    l_sum += ml[1] * expf(ml[0] - m_max);
  }
  const float inv = 1.f / fmaxf(l_sum, 1e-30f);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float o = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const long long p = (part0 + sp) * g + gr;
      o += part_acc[p * d + c] * expf(part_ml[p * 2] - m_max);
    }
    store(out + (bi * h + head) * d + c, o * inv);
  }
}

template <typename T, typename Cache>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           Cache cache, void* out, void* part_acc, void* part_ml, int b,
           int S, int h, int kvh, int d, int chunk, int nsplit, float scale,
           void* stream) {
  if (b <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || h / kvh > kMaxGroup || d <= 0 ||
      d > kMaxD || d % 4 != 0 || S <= 0 || chunk <= 0 || nsplit <= 0 ||
      static_cast<long long>(chunk) * nsplit < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long parts = static_cast<long long>(b) * kvh * nsplit;
  const long long heads = static_cast<long long>(b) * h;
  if (parts > 0x7fffffffLL || heads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_split_kernel<T, Cache><<<static_cast<unsigned>(parts), kThreads,
                                  kSmemBytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths), cache,
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), S, h, kvh,
      d, chunk, nsplit, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<static_cast<unsigned>(heads), 128, 0, st>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), h, kvh, d, nsplit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dense(const void* q, const void* k, const void* v,
                 const void* lengths, void* out, void* part_acc,
                 void* part_ml, int b, int S, int h, int kvh, int d,
                 int chunk, int nsplit, float scale, void* stream) {
  return launch<T>(q, k, v, lengths, DenseCache{S, kvh, d}, out, part_acc,
                   part_ml, b, S, h, kvh, d, chunk, nsplit, scale, stream);
}

template <typename T>
int launch_paged(const void* q, const void* k, const void* v,
                 const void* block_tables, const void* lengths, void* out,
                 void* part_acc, void* part_ml, int b, int bs, int nblk,
                 int h, int kvh, int d, int chunk, int nsplit, float scale,
                 void* stream) {
  if (bs <= 0 || nblk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const PagedCache cache{static_cast<const int*>(block_tables), bs, nblk,
                         kvh, d};
  return launch<T>(q, k, v, lengths, cache, out, part_acc, part_ml, b,
                   bs * nblk, h, kvh, d, chunk, nsplit, scale, stream);
}

}  // namespace

extern "C" {

// q, out: [b, h, d]; k, v: [b, S, kvh, d]; lengths: [b] int32; all
// contiguous. part_acc: b*kvh*nsplit*(h/kvh)*d f32 and part_ml:
// b*kvh*nsplit*(h/kvh)*2 f32 of scratch. Split sp covers positions
// [sp*chunk, (sp+1)*chunk); chunk*nsplit >= S. h/kvh <= 16, d % 4 == 0,
// d <= 128. Returns cudaGetLastError() after the launches (0 on
// success).
int decode_attention_f32(const void* q, const void* k, const void* v,
                         const void* lengths, void* out, void* part_acc,
                         void* part_ml, int b, int S, int h, int kvh, int d,
                         int chunk, int nsplit, float scale, void* stream) {
  return launch_dense<float>(q, k, v, lengths, out, part_acc, part_ml, b, S,
                             h, kvh, d, chunk, nsplit, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          const void* lengths, void* out, void* part_acc,
                          void* part_ml, int b, int S, int h, int kvh, int d,
                          int chunk, int nsplit, float scale, void* stream) {
  return launch_dense<__nv_bfloat16>(q, k, v, lengths, out, part_acc,
                                     part_ml, b, S, h, kvh, d, chunk, nsplit,
                                     scale, stream);
}

// As decode_attention_* with the cache in pages k, v: [nb, bs, kvh, d]
// and block_tables: [b, nblk] int32 (position p of row i is slot p % bs
// of page block_tables[i, p / bs]); S = nblk * bs.
int paged_decode_attention_f32(const void* q, const void* k, const void* v,
                               const void* block_tables, const void* lengths,
                               void* out, void* part_acc, void* part_ml,
                               int b, int bs, int nblk, int h, int kvh, int d,
                               int chunk, int nsplit, float scale,
                               void* stream) {
  return launch_paged<float>(q, k, v, block_tables, lengths, out, part_acc,
                             part_ml, b, bs, nblk, h, kvh, d, chunk, nsplit,
                             scale, stream);
}

int paged_decode_attention_bf16(const void* q, const void* k, const void* v,
                                const void* block_tables,
                                const void* lengths, void* out,
                                void* part_acc, void* part_ml, int b, int bs,
                                int nblk, int h, int kvh, int d, int chunk,
                                int nsplit, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(q, k, v, block_tables, lengths, out,
                                     part_acc, part_ml, b, bs, nblk, h, kvh,
                                     d, chunk, nsplit, scale, stream);
}

}  // extern "C"
