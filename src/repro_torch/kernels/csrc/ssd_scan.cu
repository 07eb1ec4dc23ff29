// Chunked SSD scan (the gated linear recurrence shared by Mamba2 and
// mLSTM) for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_ssd_kernel` / `ssd_scan_fwd` in
// src/repro/kernels/ssd_scan.py. For every (batch, head):
//
//     H_t = exp(a_t) H_{t-1} + k_t^T v_t,      y_t = q_t . H_t
//
// q, k [b, nh, S, dk] and v [b, nh, S, dv] (f32 or bf16, one dtype),
// log_a [b, nh, S] f32 (<= 0), h0 [b, nh, dk, dv] f32. Returns y [b, nh,
// S, dv] in v's dtype and h_final [b, nh, dk, dv] in f32. Per chunk of C
// steps, with cum_i = a_1 + ... + a_i inside the chunk:
//
//     y_i  = sum_{j<=i} (q_i.k_j) exp(min(cum_i - cum_j, 0)) v_j
//            + exp(cum_i) q_i . H
//     H'   = exp(cum_C) H + sum_j exp(cum_C - cum_j) k_j^T v_j
//
// which is what the Pallas kernel computes per chunk (and the JAX
// package's `chunked_linear_scan`): the causal mask selects before the
// exp, so exp(cum_i - cum_j) for j > i (which overflows at Mamba's decay
// rates: dt*A reaches about -55 a step) is never multiplied by 0.
//
// Bound: at zamba2-2.7b's prefill (b=1, S=512, nh=80, dk=dv=64, bf16, q
// and k one [S, 64] matrix broadcast over the heads) the call must move
// about 13.4 MB (v and y 5.24 MB each, h0 and h_final 1.31 MB each, B, C
// and log_a 0.3 MB): ~4.0 us at 3.35 TB/s. The reference's chunked
// operations (chunk 256) are ~3.4 GFLOP, ~3.4 us on the bf16 tensor
// cores. At xlstm-350m's (nh=4, dk=512, dv=513) ~16.8 MB, ~5.0 us, and
// ~3.2 GFLOP. So the bound is the bytes. This kernel does its products
// on the f32 cores (67 TFLOP/s peak) from shared memory, so operations
// and shared-memory traffic, not the bytes, limit it: a simple kernel
// that is right comes first; mma/wgmma and TMA are later work.
//
// Design: the Pallas grid (b*nh, nchunks) runs its chunk axis in order
// and carries H [dk, dv] in VMEM. Blocks run in no order here, so one
// block owns one (batch, head, 32-column tile of dv) and walks all the
// chunks in a loop, H's tile [dk, 32] in shared memory (f32). The
// columns of H evolve independently (H[:, c] needs only v[:, c]), so the
// column tiles of a head are independent blocks: xlstm's dv = 513 (v
// carries mLSTM's appended ones column) gives 17 tiles per head, the
// last with one live column, masked; its H [512, 513] f32 (~1 MB a head)
// would not fit in 227 KB, its tile [512, 32] (64 KB) does. q and k are
// staged per chunk in pieces of 32 rows of dk, so dk does not bound the
// staging buffers. The chunk is 32 steps (one warp's scan of the
// decays); a ragged tail is masked with a = 0 and k = q = v = 0, so
// padded steps leave H exact. q, k, v and log_a come with their batch,
// head and time strides (the last axis contiguous), so Mamba2's B and C,
// broadcast over 80 heads with a head stride of 0, go in without a copy.
// Each thread owns a strided 2x2 tile (rows r, r+16; columns c, c+16) of
// the chunk's [32 x 32] products, which keeps its shared-memory reads of
// padded rows free of bank conflicts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kC = 32;          // chunk length (time steps)
constexpr int kTV = 32;         // columns of H (and of v, y) per block
constexpr int kP = 32;          // rows of dk staged per piece
constexpr int kThreads = 256;
constexpr int kQS = kP + 4;     // padded row strides, in floats
constexpr int kVS = kTV + 4;
constexpr int kGS = kC + 4;
constexpr int kMaxDk = 1024;

struct Layout {                 // batch, head and time strides (elements)
  long long q[3], k[3], v[3], a[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int dk) {
  return sizeof(float) * (static_cast<size_t>(dk) * kTV + 2 * kC * kQS +
                          kC * kVS + kC * kGS + kC);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ log_a,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_out, Layout st, int nh, int s, int dk,
                int dv) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);   // [dk][kTV]
  float* qs = hs + dk * kTV;                     // [kC][kQS]
  float* ks = qs + kC * kQS;                     // [kC][kQS]
  float* vs = ks + kC * kQS;                     // [kC][kVS]
  float* gs = vs + kC * kVS;                     // [kC][kGS]
  float* cum = gs + kC * kGS;                    // [kC]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c0 = blockIdx.x * kTV;
  const int head = blockIdx.y;
  const long long bi = blockIdx.z;
  const long long bh = bi * nh + head;
  const T* qb = q + bi * st.q[0] + head * st.q[1];
  const T* kb = k + bi * st.k[0] + head * st.k[1];
  const T* vb = v + bi * st.v[0] + head * st.v[1];
  const float* ab = log_a + bi * st.a[0] + head * st.a[1];
  const float* h0b = h0 + bh * dk * dv;
  float* hob = h_out + bh * dk * dv;
  T* yb = y + bh * s * dv;

  for (int idx = tid; idx < dk * kTV; idx += kThreads) {
    const int d = idx / kTV, c = idx - d * kTV;
    hs[idx] = c0 + c < dv ? h0b[static_cast<long long>(d) * dv + c0 + c]
                          : 0.f;
  }
  // this thread's strided 2x2 tile: rows r, r+16 and columns c, c+16 of
  // the [kC x kC] and [kC x kTV] products (and of the [kP x kTV] piece
  // of H in the update)
  const int r = tid >> 4;
  const int c = tid & 15;

  for (int t0 = 0; t0 < s; t0 += kC) {
    const int len = min(kC, s - t0);
    __syncthreads();            // the previous chunk is consumed
    if (tid < 32) {             // one warp scans the chunk's decays
      float x = lane < len ? ab[(t0 + lane) * st.a[2]] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      cum[lane] = x;
    }
    for (int idx = tid; idx < kC * kTV; idx += kThreads) {
      const int j = idx / kTV, cc = idx - j * kTV;
      vs[j * kVS + cc] =
          j < len && c0 + cc < dv
              ? to_f32(vb[(t0 + j) * st.v[2] + c0 + cc]) : 0.f;
    }

    // q k^T and q . H over dk, in pieces of kP rows
    float g[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float qh[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int p0 = 0; p0 < dk; p0 += kP) {
      __syncthreads();          // the previous piece is consumed
      for (int idx = tid; idx < kC * kP; idx += kThreads) {
        const int j = idx / kP, d = idx - j * kP;
        const bool ok = j < len && p0 + d < dk;
        const long long t = t0 + j;
        qs[j * kQS + d] = ok ? to_f32(qb[t * st.q[2] + p0 + d]) : 0.f;
        ks[j * kQS + d] = ok ? to_f32(kb[t * st.k[2] + p0 + d]) : 0.f;
      }
      __syncthreads();
      const int pd = min(kP, dk - p0);           // a multiple of 4
      for (int d = 0; d < pd; d += 4) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + r * kQS + d);
        const float4 qb4 =
            *reinterpret_cast<const float4*>(qs + (r + 16) * kQS + d);
        const float4 ka = *reinterpret_cast<const float4*>(ks + c * kQS + d);
        const float4 kb4 =
            *reinterpret_cast<const float4*>(ks + (c + 16) * kQS + d);
        g[0][0] += qa.x * ka.x + qa.y * ka.y + qa.z * ka.z + qa.w * ka.w;
        g[0][1] += qa.x * kb4.x + qa.y * kb4.y + qa.z * kb4.z + qa.w * kb4.w;
        g[1][0] += qb4.x * ka.x + qb4.y * ka.y + qb4.z * ka.z + qb4.w * ka.w;
        g[1][1] += qb4.x * kb4.x + qb4.y * kb4.y + qb4.z * kb4.z +
                   qb4.w * kb4.w;
        const float* hrow = hs + (p0 + d) * kTV;
        const float qa_[4] = {qa.x, qa.y, qa.z, qa.w};
        const float qb_[4] = {qb4.x, qb4.y, qb4.z, qb4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h_lo = hrow[e * kTV + c];
          const float h_hi = hrow[e * kTV + c + 16];
          qh[0][0] += qa_[e] * h_lo;
          qh[0][1] += qa_[e] * h_hi;
          qh[1][0] += qb_[e] * h_lo;
          qh[1][1] += qb_[e] * h_hi;
        }
      }
    }

    // the decay gate under the causal mask; y = G v + exp(cum) q.H
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = r + 16 * a, j = c + 16 * b;
        const float gate =
            j <= i ? expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
        gs[i * kGS + j] = g[a][b] * gate;
      }
    }
    __syncthreads();
    float out[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float e = expf(cum[r + 16 * a]);
      out[a][0] = qh[a][0] * e;
      out[a][1] = qh[a][1] * e;
    }
    for (int j = 0; j < kC; ++j) {
      const float g0 = gs[r * kGS + j], g1 = gs[(r + 16) * kGS + j];
      const float v0 = vs[j * kVS + c], v1 = vs[j * kVS + c + 16];
      out[0][0] += g0 * v0;
      out[0][1] += g0 * v1;
      out[1][0] += g1 * v0;
      out[1][1] += g1 * v1;
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int i = r + 16 * a;
      if (i >= len) continue;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int col = c0 + c + 16 * b;
        if (col < dv)
          store(yb + static_cast<long long>(t0 + i) * dv + col, out[a][b]);
      }
    }

    // H' = exp(total) H + (k * w)^T v, w_j = exp(total - cum_j), in
    // pieces of kP rows of dk (k is staged again, scaled by w)
    const float total = cum[kC - 1];
    const float decay = expf(total);
    for (int p0 = 0; p0 < dk; p0 += kP) {
      __syncthreads();          // ks is free
      for (int idx = tid; idx < kC * kP; idx += kThreads) {
        const int j = idx / kP, d = idx - j * kP;
        const bool ok = j < len && p0 + d < dk;
        ks[j * kQS + d] =
            ok ? to_f32(kb[(t0 + j) * st.k[2] + p0 + d]) *
                     expf(total - cum[j])
               : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int dd = r + 16 * a;
        if (p0 + dd >= dk) continue;
        float acc0 = 0.f, acc1 = 0.f;
        for (int j = 0; j < kC; ++j) {
          const float kw = ks[j * kQS + dd];
          acc0 += kw * vs[j * kVS + c];
          acc1 += kw * vs[j * kVS + c + 16];
        }
        float* hrow = hs + (p0 + dd) * kTV;
        hrow[c] = hrow[c] * decay + acc0;
        hrow[c + 16] = hrow[c + 16] * decay + acc1;
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < dk * kTV; idx += kThreads) {
    const int d = idx / kTV, cc = idx - d * kTV;
    if (c0 + cc < dv) hob[static_cast<long long>(d) * dv + c0 + cc] = hs[idx];
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* log_a,
           const void* h0, void* y, void* h_out, const long long* strides,
           int b, int nh, int s, int dk, int dv, void* stream) {
  if (b <= 0 || nh <= 0 || dv <= 0) return 0;
  if (s < 0 || dk <= 0 || dk > kMaxDk || dk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;     // one attribute call per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kMaxDk)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  if (nh > 65535 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Layout st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.a[i] = strides[9 + i];
  }
  const dim3 grid((dv + kTV - 1) / kTV, nh, b);
  ssd_scan_kernel<T><<<grid, kThreads, smem_bytes(dk),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), st, nh, s, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k: [b, nh, S, dk]; v: [b, nh, S, dv]; log_a: [b, nh, S] f32, each
// with the last axis contiguous and its batch, head and time strides (in
// elements) in `strides` (a host array of 12: q, k, v, log_a, each as
// batch, head, time; a stride may be 0). h0, h_out: contiguous [b, nh,
// dk, dv] f32; y: contiguous [b, nh, S, dv]. dk % 4 == 0, dk <= 1024.
// All tensors f32. Returns cudaGetLastError() after the launch (0 on
// success).
int ssd_scan_f32(const void* q, const void* k, const void* v,
                 const void* log_a, const void* h0, void* y, void* h_out,
                 const long long* strides, int b, int nh, int s, int dk,
                 int dv, void* stream) {
  return launch<float>(q, k, v, log_a, h0, y, h_out, strides, b, nh, s, dk,
                       dv, stream);
}

// As ssd_scan_f32 with q, k, v and y in bf16 (log_a, h0, h_out f32).
int ssd_scan_bf16(const void* q, const void* k, const void* v,
                  const void* log_a, const void* h0, void* y, void* h_out,
                  const long long* strides, int b, int nh, int s, int dk,
                  int dv, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, log_a, h0, y, h_out, strides, b, nh,
                               s, dk, dv, stream);
}

}  // extern "C"
