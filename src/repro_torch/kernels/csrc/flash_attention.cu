// Causal GQA flash attention forward for Hopper (sm_90a), with a plain C
// interface. Returns o and the row log-sum-exp.
//
// Replaces the TPU kernel `_flash_kernel` / `flash_attention_fwd` in
// src/repro/kernels/flash_attention.py. q [b, s, h, d]; k, v [b, skv,
// kvh, d]; query head `head` reads kv head head / (h / kvh). Scores and
// the online-softmax state (acc, m, l) are f32; o is stored in q's dtype
// and lse = m + log(l) [b, h, s] in f32 (what the JAX package's
// `attention_flash._flash_fwd_impl` returns beside o).
//
// Bound: at the serving path's prefill (b=1, s=512, h=24, kvh=2, d=128,
// bf16) the call reads q, k, v once and writes o and lse: about 6.8 MB,
// ~2.0 us at 3.35 TB/s; the causal half of QK^T and PV is ~1.6 GFLOP,
// ~1.6 us at 989 TFLOP/s on the tensor cores. So the bound is the bytes,
// with the operations close behind; on the f32 cores (67 TFLOP/s) the
// same operations would take ~24 us.
//
// bf16 entry, FA2-style: one block of 4 warps owns one (batch, head,
// 64-row query tile); each warp owns 16 query rows and keeps them as
// ldmatrix-loaded A fragments in registers for the whole kv loop. K and
// V tiles of 64 rows stay bf16 in shared memory, filled by cp.async
// 16-byte copies and double-buffered (tile j+1 is in flight while tile
// j is computed); rows padded by 16 bytes keep ldmatrix (K) and
// ldmatrix.trans (V) free of bank conflicts. S = Q K^T and O += P V run
// on the tensor cores (mma.sync m16n8k16, f32 accumulators); the online
// softmax works on the accumulator fragments in base 2 (scores scaled by
// log2 e), each row's max and sum two quad shuffles. P is rounded to
// bf16 and repacked from C into A fragments in registers: the one place
// where bf16 rounding enters beyond the inputs (the reference keeps p in
// f32; l sums the f32 p). o is staged through shared memory for 16-byte
// stores. Shared memory: 5 tiles of 64 x (16 ceil(d/16) + 8) bf16, 87 KB
// at d=128, so two blocks fit on an SM.
//
// Head dims: every multiple of 8 up to 128, and 160 (Zamba2's shared
// attention, 32 heads over the 5,120-wide concatenated input). At d=160
// the tiles take 105 KB, and two blocks still fit on an SM (210 KB of
// its 228), but 10 Q fragments beside 20 accumulator blocks would pass
// the 255 registers a thread may hold there: that instance reloads the
// warp's Q fragments from shared memory (ldmatrix) at every kv tile
// instead of keeping them in registers.
//
// f32 entry: f32 arithmetic on the f32 cores (no TF32): 8 warps of 8 rows,
// lane j scores kv row j of a 32-row tile staged in shared memory as f32
// (online_softmax.cuh).
//
// Both: kv tiles wholly above the causal diagonal are never loaded, as
// the reference's `pl.when` skips them, and the mask is applied only on
// the tiles that cross the diagonal or the ragged end. Ragged lengths:
// the reference halves its tiles until they divide s; here query rows
// >= s are not stored, kv rows >= skv are zero-filled and masked, and a
// head dim that is not a multiple of 16 is zero-padded in shared memory.
// Blocks are numbered longest query tile first (under the causal mask
// the last tile of every head is the longest).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper_mma.cuh"
#include "online_softmax.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Query tile of block `blk` when blocks are numbered longest tile first:
// (query tile, batch * h + head).
__device__ __forceinline__ void block_tile(int n_qt, int& qt, int& bh) {
  const int heads = static_cast<int>(gridDim.x) / n_qt;
  qt = n_qt - 1 - static_cast<int>(blockIdx.x) / heads;
  bh = static_cast<int>(blockIdx.x) % heads;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, cp.async double buffering
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows per block: 4 warps x 16
constexpr int kBK = 64;          // kv rows per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <int KD>
constexpr size_t bf16_smem_bytes() {          // Q, 2 K and 2 V tiles
  return sizeof(bf16) * 5 * 64 * hop::row_stride(KD);
}

// Copy rows [0, 64) of a slab (row stride `ld` elements) into a tile of
// row stride row_stride(KD): rows >= n and columns >= d are zero-filled.
// d % 8 == 0; `src` must be a valid address even where nothing is read.
template <int KD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int n, int d) {
  constexpr int kChunks = 2 * KD;               // 16-byte chunks per row
  constexpr int kS = hop::row_stride(KD);
  const int dc = d >> 3;
#pragma unroll
  for (int i = 0; i < KD; ++i) {                // 64 * kChunks / 128
    const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = idx / kChunks, c = idx - r * kChunks;
    const bool ok = r < n && c < dc;
    hop::cp_async16(dst + r * kS + c * 8, ok ? src + r * ld + c * 8 : src,
                    ok ? 16 : 0);
  }
}

// The one head dim above 128 the bf16 entry takes.
constexpr int kWideD = 160;

template <int KD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int s, int skv, int h,
                      int kvh, int d, int causal, float scale_log2,
                      int n_qt) {
  constexpr int kS = hop::row_stride(KD);
  constexpr int kNB = 2 * KD;                   // 8-column blocks of o
  // Q fragments in registers for the whole kv loop up to d=128; from
  // shared memory at every tile above it (see the header)
  constexpr bool kQInRegs = KD <= 8;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* kbuf = qs + kBQ * kS;                   // two K tiles
  bf16* vbuf = kbuf + 2 * kBK * kS;             // two V tiles

  int qt, bh;
  block_tile(n_qt, qt, bh);
  const int head = bh % h;
  const long long bi = bh / h;
  const int kh = head / (h / kvh);
  const int q0 = qt * kBQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + warp * 16 + g;         // rows row_a, row_a + 8
  const long long kv_ld = static_cast<long long>(kvh) * d;
  const bf16* kb = k + (bi * skv * kvh + kh) * static_cast<long long>(d);
  const bf16* vb = v + (bi * skv * kvh + kh) * static_cast<long long>(d);
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int n_kv = (kv_end + kBK - 1) / kBK;

  load_tile<KD>(qs, q + ((bi * s + q0) * h + head) * static_cast<long long>(d),
                static_cast<long long>(h) * d, s - q0, d);
  load_tile<KD>(kbuf, kb, kv_ld, skv, d);
  load_tile<KD>(vbuf, vb, kv_ld, skv, d);
  hop::cp_async_commit();

  uint32_t qa[kQInRegs ? KD : 1][4];
  float acc[kNB][4];
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kv; ++j) {
    const int kv0 = j * kBK;
    if (j + 1 < n_kv) {                         // next tile in flight
      const int nxt = kv0 + kBK;
      bf16* kd = kbuf + ((j + 1) & 1) * kBK * kS;
      bf16* vd = vbuf + ((j + 1) & 1) * kBK * kS;
      load_tile<KD>(kd, kb + nxt * kv_ld, kv_ld, skv - nxt, d);
      load_tile<KD>(vd, vb + nxt * kv_ld, kv_ld, skv - nxt, d);
    }
    hop::cp_async_commit();
    hop::cp_async_wait<1>();                    // tile j has landed
    __syncthreads();
    if constexpr (kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          hop::ldsm_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kS + kk * 16 +
                                   ((lane >> 4) << 3));
      }
    }
    const bf16* kt = kbuf + (j & 1) * kBK * kS;
    const bf16* vt = vbuf + (j & 1) * kBK * kS;

    float sc[8][4];                             // S: 16 rows x 64 kv
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      } else {
        hop::ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * kS + kk * 16 +
                            ((lane >> 4) << 3));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        hop::ldsm_x4(b, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS +
                            kk * 16 + (((lane >> 3) & 1) << 3));
        hop::mma_bf16(sc[2 * np], a, b[0], b[1]);
        hop::mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
      }
    }

    const bool edge = kv0 + kBK > skv ||
                      (causal && kv0 + kBK - 1 > q0 + warp * 16);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nb][e] * scale_log2;
        if (edge) {
          const int kj = kv0 + nb * 8 + 2 * t + (e & 1);
          const int qi = row_a + (e >> 1) * 8;
          if (kj >= skv || (causal && kj > qi)) x = kNegInf;
        }
        sc[nb][e] = x;
      }
    }

    // online softmax on the fragments: thread rows g (e 0, 1), g+8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        mx = fmaxf(mx, fmaxf(sc[nb][2 * r], sc[nb][2 * r + 1]));
      const float m_new = fmaxf(m[r], hop::quad_max(mx));
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
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

    // O += P V: P's C fragments are the A fragments of 16 kv rows
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          hop::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
          hop::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
          hop::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          hop::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < KD; ++np) {
        uint32_t b[4];
        hop::ldsm_x4_t(b, vt + (kk * 16 + (lane & 15)) * kS + np * 16 +
                              ((lane >> 4) << 3));
        hop::mma_bf16(acc[2 * np], pa, b[0], b[1]);
        hop::mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();                            // tile j's buffers are free
  }

  // epilogue: o / l through this warp's (consumed) Q rows, 16-byte stores
  l[0] = hop::quad_sum(l[0]);
  l[1] = hop::quad_sum(l[1]);
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  bf16* ow = qs + warp * 16 * kS;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) {
    const int c = nb * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(ow + g * kS + c) =
        hop::pack_bf16x2(acc[nb][0] * inv0, acc[nb][1] * inv0);
    *reinterpret_cast<uint32_t*>(ow + (g + 8) * kS + c) =
        hop::pack_bf16x2(acc[nb][2] * inv1, acc[nb][3] * inv1);
  }
  __syncwarp();
  const int dc = d >> 3;
  for (int idx = lane; idx < 16 * dc; idx += 32) {
    const int r = idx / dc, c = idx - r * dc;
    const int qi = q0 + warp * 16 + r;
    if (qi < s)
      *reinterpret_cast<uint4*>(o + ((bi * s + qi) * h + head) *
                                        static_cast<long long>(d) + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * kS + c * 8);
  }
  if (t == 0) {
    float* lrow = lse + (bi * h + head) * s;
    if (row_a < s)
      lrow[row_a] = (m[0] + log2f(fmaxf(l[0], 1e-30f))) * hop::kLn2;
    if (row_a + 8 < s)
      lrow[row_a + 8] = (m[1] + log2f(fmaxf(l[1], 1e-30f))) * hop::kLn2;
  }
}

template <int KD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int s, int skv, int h, int kvh, int d,
                int causal, float scale, void* stream) {
  constexpr size_t kSmem = bf16_smem_bytes<KD>();
  cudaError_t err = hop::allow_smem<flash_fwd_bf16_kernel<KD>>(kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(b) * h * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_bf16_kernel<KD><<<static_cast<unsigned>(blocks), kThreads, kSmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), s, skv, h, kvh, d, causal,
      scale * hop::kLog2e, n_qt);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: f32 FMAs on the f32 cores, the tile step of online_softmax.cuh
// ---------------------------------------------------------------------------

namespace f32 {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kRows = 8;                   // query rows per warp
constexpr int kBQ = kWarps * kRows;        // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kQStride + kTile * kKStride + kTile * kVStride);

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int s, int skv, int h, int kvh,
                     int d, int causal, float scale, int n_qt) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kQStride;
  float* vs = ks + kTile * kKStride;

  int qt, bh;
  block_tile(n_qt, qt, bh);
  const int head = bh % h;
  const long long bi = bh / h;
  const int kh = head / (h / kvh);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int idx = tid; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int qi = q0 + r;
    qs[r * kQStride + c] = qi < s ? q[((bi * s + qi) * h + head) * d + c] : 0.f;
  }

  RowState<kRows> st;
  st.init();
  const float* qw = qs + warp * kRows * kQStride;
  const int row0 = q0 + warp * kRows;
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kTile) {
    __syncthreads();            // the previous tile is consumed
    for (int idx = tid; idx < kTile * kMaxD; idx += kThreads) {
      const int j = idx / kMaxD, c = idx - j * kMaxD;
      const int kj = kv0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (c < d && kj < skv) {
        const long long off = ((bi * skv + kj) * kvh + kh) * d + c;
        kv_k = k[off];
        kv_v = v[off];
      }
      ks[j * kKStride + c] = kv_k;
      vs[j * kVStride + c] = kv_v;
    }
    __syncthreads();
    tile_update<kRows>(
        qw, ks, vs, d, scale,
        [&](int r, int j) {
          const int kj = kv0 + j;
          return kj < skv && (!causal || kj <= row0 + r);
        },
        st);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = row0 + r;
    if (qi >= s) continue;
    const float l = fmaxf(st.l[r], 1e-30f);
    float* orow = o + ((bi * s + qi) * h + head) * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < d) orow[c] = st.acc[r][i] / l;
    }
    if (lane == 0) lse[(bi * h + head) * s + qi] = st.m[r] + logf(l);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int s, int skv, int h, int kvh, int d, int causal,
           float scale, void* stream) {
  cudaError_t err = hop::allow_smem<flash_fwd_f32_kernel>(kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(b) * h * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_f32_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), s, skv, h, kvh, d, causal, scale, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

bool bad_shape(int skv, int h, int kvh, int d, int d_multiple,
               bool wide = false) {
  return skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 ||
         (d > attn::kMaxD && !(wide && d == kWideD)) || d % d_multiple != 0;
}

}  // namespace

extern "C" {

// q, o: [b, s, h, d]; k, v: [b, skv, kvh, d]; lse: [b, h, s] f32; all
// contiguous f32. h % kvh == 0, d % 4 == 0, d <= 128. causal masks kv
// position j > query position i (both counted from 0). Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int s, int skv, int h, int kvh,
                        int d, int causal, float scale, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (bad_shape(skv, h, kvh, d, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  return f32::launch(q, k, v, o, lse, b, s, skv, h, kvh, d, causal, scale,
                     stream);
}

// As flash_attention_f32 with q, k, v and o in bf16 (lse stays f32),
// d % 8 == 0 and d <= 128 or d == 160, and q, k, v, o 16-byte aligned
// (cp.async and vector stores).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int b, int s, int skv, int h,
                         int kvh, int d, int causal, float scale,
                         void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (bad_shape(skv, h, kvh, d, 8, true))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 32)
    return launch_bf16<2>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal,
                          scale, stream);
  if (d <= 64)
    return launch_bf16<4>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal,
                          scale, stream);
  if (d <= 80)
    return launch_bf16<5>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal,
                          scale, stream);
  if (d <= 128)
    return launch_bf16<8>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal,
                          scale, stream);
  return launch_bf16<kWideD / 16>(q, k, v, o, lse, b, s, skv, h, kvh, d,
                                  causal, scale, stream);
}

}  // extern "C"
