// Masked MAR group mean for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_group_mean_kernel` / `group_mean_fwd` in
// src/repro/kernels/group_mean.py. For x [G, M, D] and mask [G, M] every
// slot of group g receives sum_i x[g,i,:] * mask[g,i] / sum_i mask[g,i],
// summed in f32 and stored in x's dtype; a group whose mask sums to 0
// keeps its own values.
//
// Bound: memory. The kernel reads x once and writes y once, so it moves
// 2*G*M*D*itemsize bytes (plus G*M*4 of mask) and does ~2 flops per
// element read: at the main path's shapes (G=9, M=3, D up to 98304, f32)
// one MAR round over theta and momentum moves about 43.6 MB, about 13 us
// at 3.35 TB/s. The four small leaves (D=128, 2560, 20 and their
// momentum) are launch-bound, and a step makes 8 leaves x 3 rounds = 24
// launches.
//
// Design: one block owns one group g and a tile of blockDim.x columns, so
// a column's whole sum lives in one thread and needs no atomics. The
// block loads mask[g, :M] once into shared memory. Neighbouring threads
// take neighbouring columns, so every row's loads and stores coalesce.
// The ragged tail tile is masked by `col < D` instead of shrinking the
// tile to a divisor of D as the TPU kernel did, so D=20 and D=1 run at
// full tile width. Blocks are numbered over a 1-D grid (group-major), so
// neither G nor the tile count meets the 65535 limit of gridDim.y.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_mean_kernel(const T* __restrict__ x, const float* __restrict__ mask,
                  T* __restrict__ y, int M, long long D,
                  long long tiles) {
  extern __shared__ float smask[];
  const long long g = blockIdx.x / tiles;
  const long long col = (blockIdx.x % tiles) * kThreads + threadIdx.x;
  for (int i = threadIdx.x; i < M; i += kThreads) smask[i] = mask[g * M + i];
  __syncthreads();
  if (col >= D) return;

  const T* xg = x + g * M * D + col;
  T* yg = y + g * M * D + col;
  float num = 0.f, den = 0.f;
  for (int i = 0; i < M; ++i) {
    num += to_f32(xg[i * D]) * smask[i];
    den += smask[i];
  }
  if (den > 0.f) {
    T mean;
    from_f32(num / fmaxf(den, 1.f), &mean);
    for (int i = 0; i < M; ++i) yg[i * D] = mean;
  } else {
    for (int i = 0; i < M; ++i) yg[i * D] = xg[i * D];
  }
}

template <typename T>
int launch(const void* x, const void* mask, void* y, int G, int M,
           long long D, void* stream) {
  const long long tiles = (D + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(G) * tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  group_mean_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                         M * sizeof(float),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask),
      static_cast<T*>(y), M, D, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: [G, M, D] contiguous f32; mask: [G, M] contiguous f32.
// Returns cudaGetLastError() after the launch (0 on success).
int group_mean_f32(const void* x, const void* mask, void* y, int G, int M,
                   long long D, void* stream) {
  return launch<float>(x, mask, y, G, M, D, stream);
}

// As group_mean_f32 with x and y in bf16 (the mask stays f32).
int group_mean_bf16(const void* x, const void* mask, void* y, int G, int M,
                    long long D, void* stream) {
  return launch<__nv_bfloat16>(x, mask, y, G, M, D, stream);
}

}  // extern "C"
