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
// with the operations close behind. This kernel does its FMAs on the
// f32 cores (67 TFLOP/s peak, ~24 us for the same work), so the f32
// operations, not the bytes, limit it: a simple kernel that is right
// comes first, the tensor cores (mma/wgmma) are a later step.
//
// Design: the Pallas kernel runs its kv axis as a sequential grid axis
// with (acc, m, l) in VMEM scratch. Here one block owns one (batch,
// head, 64-row query tile) and loops over 32-row kv tiles staged in
// shared memory, up to the causal diagonal: tiles wholly above it are
// never loaded, as the reference's `pl.when` skips them. Each of the 8
// warps owns 8 query rows; lane j scores kv row j (online_softmax.cuh).
// Ragged lengths: the reference halves its tiles until they divide s
// (s=24 ran at bq=8, s=500 at bq=4); here the tail tiles are masked
// (query rows >= s are not stored, kv rows >= skv are masked), so every
// length runs at full tile size. Query tiles are numbered from the last
// (the longest under the causal mask) so the longest blocks start first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "online_softmax.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 8;
constexpr int kRows = 8;                   // query rows per warp
constexpr int kBQ = kWarps * kRows;        // query rows per block
constexpr int kThreads = kWarps * 32;
constexpr size_t kSmemBytes =
    sizeof(float) * (kBQ * kQStride + kTile * kKStride + kTile * kVStride);

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s, int skv, int h, int kvh,
                 int d, int causal, float scale, int n_qt) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * kQStride;
  float* vs = ks + kTile * kKStride;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int bh = static_cast<int>(blockIdx.x / n_qt);
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
    qs[r * kQStride + c] =
        qi < s ? to_f32(q[((bi * s + qi) * h + head) * d + c]) : 0.f;
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
        kv_k = to_f32(k[off]);
        kv_v = to_f32(v[off]);
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
    T* orow = o + ((bi * s + qi) * h + head) * d;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store(orow + c, st.acc[r][i] / l);
    }
    if (lane == 0) lse[(bi * h + head) * s + qi] = st.m[r] + logf(l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int s, int skv, int h, int kvh, int d, int causal,
           float scale, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (skv <= 0 || kvh <= 0 || h % kvh != 0 || d <= 0 || d > kMaxD ||
      d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;     // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int n_qt = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(b) * h * n_qt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s, skv, h, kvh, d, causal, scale, n_qt);
  return static_cast<int>(cudaGetLastError());
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
  return launch<float>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal, scale,
                       stream);
}

// As flash_attention_f32 with q, k, v and o in bf16 (lse stays f32).
int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int b, int s, int skv, int h,
                         int kvh, int d, int causal, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, b, s, skv, h, kvh, d, causal,
                               scale, stream);
}

}  // extern "C"
