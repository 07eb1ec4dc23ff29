// Masked MAR group mean for Hopper (sm_90a), with a plain C interface:
// one launch per MAR round over a table of leaves.
//
// Replaces the TPU kernel `_group_mean_kernel` / `group_mean_fwd` in
// src/repro/kernels/group_mean.py, and with it the gather / scatter
// around it in the reference's `_kernel_round`
// (src/repro/core/mar_allreduce.py). For round r the caller's `order`
// lists the grid's slots by group: slot j of group g holds peer
// p = order[g*m + j], and a slot with p >= n is virtual (a zero row with
// mask 0). Every real peer of group g receives
// sum_j x[p_j,:] * mask[p_j] / max(sum_j mask[p_j], 1), summed in f32 in
// slot order and stored in the leaf's dtype; in a group whose mask sums
// to 0 each real peer keeps its own row, bit for bit. Virtual slots are
// never read or written.
//
// Bound: memory. Each leaf [n, d] is read once and written once, so a
// round moves 2*n*sum(d)*itemsize bytes (plus n*4 of mask and m*8 of
// order per block, from L2) for ~2 flops per element read. The main
// path's round (N=27, theta and momentum of the 768->128->20 MLP, 8 f32
// leaves, 101,012 values a peer) moves 43.64 MB: 13.03 us at 3.35 TB/s.
// The reference's route moved about three times that: it gathered every
// leaf into group order (x[order]) and scattered the result back
// ([inv]), and made one launch per leaf.
//
// Design:
// - A block owns one (leaf, group, column tile). Blocks run over a flat
//   1-D grid; `first_block` in the leaf table is the prefix of the
//   leaves' block counts (groups x tiles), and a block finds its leaf by
//   a scan of that prefix, at most kMaxLeaves uniform loads from the
//   parameter bank.
// - The block reads its group's m entries of `order` and of `mask`
//   itself into shared memory, so no gathered copy of x, of the mask or
//   of the indices is ever made. A thread owns 16 bytes of columns
//   (4 f32 or 8 bf16) and loops over the m slots: neighbouring threads
//   take neighbouring 16-byte words of each row, so every row's loads
//   and stores coalesce. A column's whole sum lives in one thread, so no
//   atomics.
// - 16-byte loads and stores where the leaf's d is a multiple of the
//   vector (4 f32, 8 bf16) and both base addresses are 16-byte aligned;
//   any other leaf (d = 1, an odd width, an offset view) takes the
//   scalar path over the same tile, one column per thread per pass.
// - The same multiply-add over slots 0..m-1, then one divide by
//   max(den, 1), as the gathered kernel did, so f32 results are bit-equal
//   to its route; a virtual slot adds 0 * 0 as its zero row did.
//
// Trouble spots:
// - The struct layout. The table is passed by value as the kernel's
//   parameter (__grid_constant__: no host-to-device copy, no extra
//   launch), and the Python side fills a ctypes mirror of it. A mismatch
//   would be silent, so group_mean_round_layout() reports sizeof and
//   every field's offset, and the wrapper checks them when it loads the
//   library. kMaxLeaves x sizeof(Leaf) = 32 x 32 = 1,024 bytes, and the
//   whole Round is 1,056 bytes, well under the 4 KB of kernel
//   parameters that every CUDA 12 toolkit allows.
// - Group sizes up to kMaxM. A block keeps its m mask values and rows in
//   dynamic shared memory (8 bytes a slot), not in a register array;
//   above 48 KB the launcher raises the kernel's dynamic shared memory
//   limit first.
// - The host side of a round. The caller fills one table per (dtype,
//   <= kMaxLeaves leaves) batch; the block prefix is computed here in C,
//   not in Python.
// - bf16 leaves round the mean once, at the store.
//
// The [G, M, D] entries (group_mean_f32 / _bf16) are the same kernel
// with one leaf [G*M, D], identity order (order == nullptr) and the
// [G, M] mask read as [G*M].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;
constexpr int kMaxM = 12288;        // 96 KB of slots in shared memory

struct Leaf {
  const void* x;                    // [n, d] contiguous input rows
  void* y;                          // [n, d] contiguous output rows
  long long d;
  long long first_block;            // set by the launcher
};

struct Round {
  Leaf leaf[kMaxLeaves];
  const long long* order;           // [groups * m] slots by group; null:
                                    // identity
  const float* mask;                // [n]
  int n;                            // real rows of every leaf
  int m;                            // group size
  int groups;
  int n_leaves;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

template <typename T>
__host__ __device__ constexpr long long tile_cols() {
  return kThreads * Vec<T>::kN;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[8]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(p) = t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_mean_round_kernel(const __grid_constant__ Round a) {
  constexpr int V = Vec<T>::kN;
  extern __shared__ float smem[];
  float* smask = smem;                                  // [m]
  int* srow = reinterpret_cast<int*>(smem + a.m);       // [m], -1: virtual

  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < a.n_leaves && b >= a.leaf[l + 1].first_block) ++l;
  const long long d = a.leaf[l].d;
  const long long tiles = (d + tile_cols<T>() - 1) / tile_cols<T>();
  const long long local = b - a.leaf[l].first_block;
  const long long g = local / tiles;
  const long long col0 = (local % tiles) * tile_cols<T>();

  for (int i = threadIdx.x; i < a.m; i += kThreads) {
    const long long s = g * a.m + i;
    const long long p = a.order ? a.order[s] : s;
    const bool real = p >= 0 && p < a.n;
    srow[i] = real ? static_cast<int>(p) : -1;
    smask[i] = real ? a.mask[p] : 0.f;
  }
  __syncthreads();
  float den = 0.f;
  for (int i = 0; i < a.m; ++i) den += smask[i];
  const float scale = fmaxf(den, 1.f);

  const T* __restrict__ x = static_cast<const T*>(a.leaf[l].x);
  T* __restrict__ y = static_cast<T*>(a.leaf[l].y);
  const bool vec = d % V == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y))
       & 15) == 0;

  if (vec) {
    const long long c = col0 + static_cast<long long>(threadIdx.x) * V;
    if (c >= d) return;
    if (den > 0.f) {
      float num[V];
#pragma unroll
      for (int k = 0; k < V; ++k) num[k] = 0.f;
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        float v[V];
        if (r >= 0) {
          load16(x + r * d + c, v);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = 0.f;
        }
        const float mk = smask[i];
#pragma unroll
        for (int k = 0; k < V; ++k) num[k] += v[k] * mk;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) num[k] = num[k] / scale;
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        if (r >= 0) store16(y + r * d + c, num);
      }
    } else {
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        if (r >= 0) {
          *reinterpret_cast<uint4*>(y + r * d + c) =
              __ldg(reinterpret_cast<const uint4*>(x + r * d + c));
        }
      }
    }
    return;
  }

  for (int k = 0; k < V; ++k) {
    const long long c = col0 + static_cast<long long>(k) * kThreads +
                        threadIdx.x;
    if (c >= d) return;
    if (den > 0.f) {
      float num = 0.f;
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        const float v = r >= 0 ? to_f32(x[r * d + c]) : 0.f;
        num += v * smask[i];
      }
      const float mean = num / scale;
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        if (r >= 0) from_f32(mean, y + r * d + c);
      }
    } else {
      for (int i = 0; i < a.m; ++i) {
        const int r = srow[i];
        if (r >= 0) y[r * d + c] = x[r * d + c];
      }
    }
  }
}

template <typename T>
int launch(Round* a, void* stream) {
  if (a->n_leaves < 1 || a->n_leaves > kMaxLeaves || a->m < 1 ||
      a->m > kMaxM || a->groups < 0 || a->n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = 0;
  for (int l = 0; l < a->n_leaves; ++l) {
    a->leaf[l].first_block = blocks;
    const long long tiles = (a->leaf[l].d + tile_cols<T>() - 1) /
                            tile_cols<T>();
    blocks += tiles * a->groups;
  }
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(a->m) * (sizeof(float) +
                                                   sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_mean_round_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  group_mean_round_kernel<T><<<static_cast<unsigned>(blocks), kThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gmd(const void* x, const void* mask, void* y, int G, int M,
               long long D, void* stream) {
  Round a = {};
  a.leaf[0].x = x;
  a.leaf[0].y = y;
  a.leaf[0].d = D;
  a.order = nullptr;
  a.mask = static_cast<const float*>(mask);
  a.n = G * M;
  a.m = M;
  a.groups = G;
  a.n_leaves = 1;
  return launch<T>(&a, stream);
}

}  // namespace

extern "C" {

// One MAR round over up to kMaxLeaves leaves of one dtype. `args` points
// at a Round with leaf[l].x / .y / .d and order, mask, n, m, groups,
// n_leaves filled by the caller; first_block is filled here.
// (A void* and not a Round*: a C entry whose signature names a type of
// this file's unnamed namespace would not be exported.) Returns
// cudaGetLastError() after the launch (0 on success).
int group_mean_round_f32(void* args, void* stream) {
  return launch<float>(static_cast<Round*>(args), stream);
}

int group_mean_round_bf16(void* args, void* stream) {
  return launch<__nv_bfloat16>(static_cast<Round*>(args), stream);
}

// The table's layout as this compiler laid it out, for the wrapper to
// hold its ctypes mirror against: kMaxLeaves, kMaxM, sizeof(Leaf), the
// offsets of x, y, d, first_block, sizeof(Round), the offsets of leaf,
// order, mask, n, m, groups, n_leaves. Writes at most `len`
// values and returns how many there are.
int group_mean_round_layout(long long* out, int len) {
  const long long v[] = {
      kMaxLeaves, kMaxM,
      static_cast<long long>(sizeof(Leaf)),
      static_cast<long long>(offsetof(Leaf, x)),
      static_cast<long long>(offsetof(Leaf, y)),
      static_cast<long long>(offsetof(Leaf, d)),
      static_cast<long long>(offsetof(Leaf, first_block)),
      static_cast<long long>(sizeof(Round)),
      static_cast<long long>(offsetof(Round, leaf)),
      static_cast<long long>(offsetof(Round, order)),
      static_cast<long long>(offsetof(Round, mask)),
      static_cast<long long>(offsetof(Round, n)),
      static_cast<long long>(offsetof(Round, m)),
      static_cast<long long>(offsetof(Round, groups)),
      static_cast<long long>(offsetof(Round, n_leaves))};
  const int count = static_cast<int>(sizeof(v) / sizeof(v[0]));
  for (int i = 0; i < count && i < len; ++i) out[i] = v[i];
  return count;
}

// x, y: [G, M, D] contiguous f32; mask: [G, M] contiguous f32. The round
// kernel with one leaf and identity order.
int group_mean_f32(const void* x, const void* mask, void* y, int G, int M,
                   long long D, void* stream) {
  return launch_gmd<float>(x, mask, y, G, M, D, stream);
}

// As group_mean_f32 with x and y in bf16 (the mask stays f32).
int group_mean_bf16(const void* x, const void* mask, void* y, int G, int M,
                    long long D, void* stream) {
  return launch_gmd<__nv_bfloat16>(x, mask, y, G, M, D, stream);
}

}  // extern "C"
