// One tile step of the flash (online-softmax) recurrence in f32 on the
// f32 cores, shared by the f32 entries of flash_attention.cu and
// decode_attention.cu (their bf16 entries use hopper_mma.cuh).
//
// A warp owns R query rows. For a tile of kTile (= 32) key/value rows
// staged in shared memory, lane j scores key row j against each of the R
// query rows (f32 FMAs over d), the warp reduces the tile's maximum and
// sum with shuffles, and each lane then adds p_j * v_j into its slice of
// the output: dims lane, lane+32, lane+64, lane+96 (so d <= 128).
// The state (m, l, acc) is kept in f32 registers, exactly the recurrence
// of the TPU kernels:
//   m' = max(m, max_j s_j);  p_j = exp(s_j - m');  alpha = exp(m - m')
//   l' = l * alpha + sum_j p_j;  acc' = acc * alpha + sum_j p_j v_j
// Masked positions get s = -1e30 (the TPU kernels' NEG_INF) and p = 0.
#pragma once

#include <cuda_runtime.h>

namespace attn {

constexpr int kTile = 32;             // key/value rows per tile: one per lane
constexpr int kMaxD = 128;            // head dim: 4 output dims per lane
constexpr int kQStride = kMaxD;       // floats per staged query row
constexpr int kKStride = kMaxD + 4;   // padded key row: float4 reads by 32
                                      // lanes of 32 rows hit every bank once
                                      // per quarter-warp
constexpr int kVStride = kMaxD;       // value rows: lanes read neighbours
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int R>
struct RowState {
  float m[R];
  float l[R];
  float acc[R][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    }
  }
};

// qw: the warp's R query rows (stride kQStride); ks, vs: the tile's key
// and value rows (strides kKStride, kVStride); d % 4 == 0, d <= kMaxD.
// valid(r, j) says whether query row r may attend to tile row j.
template <int R, typename Valid>
__device__ __forceinline__ void tile_update(const float* __restrict__ qw,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            int d, float scale, Valid valid,
                                            RowState<R>& st) {
  const int lane = threadIdx.x & 31;
  float sc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) sc[r] = 0.f;
  const float* kr = ks + lane * kKStride;
#pragma unroll 4
  for (int c = 0; c < d; c += 4) {
    const float4 kc = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + r * kQStride + c);
      sc[r] = fmaf(qv.x, kc.x, sc[r]);
      sc[r] = fmaf(qv.y, kc.y, sc[r]);
      sc[r] = fmaf(qv.z, kc.z, sc[r]);
      sc[r] = fmaf(qv.w, kc.w, sc[r]);
    }
  }
  float p[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = valid(r, lane);
    const float s = ok ? sc[r] * scale : kNegInf;
    const float m_new = fmaxf(st.m[r], warp_max(s));
    p[r] = ok ? expf(s - m_new) : 0.f;
    const float alpha = expf(st.m[r] - m_new);
    st.l[r] = st.l[r] * alpha + warp_sum(p[r]);
    st.m[r] = m_new;
#pragma unroll
    for (int i = 0; i < 4; ++i) st.acc[r][i] *= alpha;
  }
#pragma unroll 8
  for (int j = 0; j < kTile; ++j) {
    float vj[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vj[i] = vs[j * kVStride + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
      for (int i = 0; i < 4; ++i) st.acc[r][i] = fmaf(pj, vj[i], st.acc[r][i]);
    }
  }
}

}  // namespace attn
