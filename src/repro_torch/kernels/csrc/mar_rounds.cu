// Every MAR round of the device backend over one leaf, in one in-place
// pass, for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: the JAX package's device backend
// (`_grid_reshape_mean` in src/repro/core/mar_allreduce.py) is a jnp
// reshape mean that XLA fuses. The port's plain route for it
// (`core/mar_allreduce._grid_reshape_mean` over column blocks) runs about
// ten kernels a block and a round, 40-50 bytes of traffic an element,
// through PyTorch's generic strided kernels; this kernel takes its place
// on the card wherever the sum is f32 and the leaf has 2 or 4 peers.
//
// What it computes. The leaf x is [P, D] (P peers, their rows laid out
// row major over the grid), the mask [P] holds 0/1 in f32, and round r
// splits the peers into groups (`group[r][p]`: bit q set when peer q is
// in p's group). In round r every group's masked mean is
//   mean = (sum over members q, ascending, from +0, of x[q] * mask[q])
//          / max(den, 1),          den = the members' mask sum, in f32,
// and member q receives mean * (1 - empty) + x[q] * empty (empty: den is
// 0, so a group whose every member dropped keeps its own rows), rounded
// to the leaf's dtype (RN-even for bf16) before the next round. That is
// the plain route's `finalize_masked_mean` and `.to(x.dtype)`, operation
// for operation: every product, sum and quotient is an explicit _rn
// intrinsic, so the compiler contracts nothing into an FMA (a quotient by
// a power of two, the usual count, is the product by its exact
// reciprocal: the same exact value, rounded once). On groups of
// two the plain route's reduction adds the same two numbers, so the
// result is the plain route's, bit for bit; on larger groups PyTorch's
// reduction may add in another order, k - 1 roundings of the f32 sum.
//
// Bound: memory. Every element is read once and written once however
// many rounds run: 2 * P * D * itemsize bytes a leaf. musicgen-medium's
// state of 4 peers (1,818,381,312 parameters, theta bf16, m f32) is
// 87.28 GB a step: 26.05 ms at 3.35 TB/s. A pass per round would double
// it.
//
// Design:
// - A thread owns one 16-byte column vector (4 f32, 8 bf16) of every
//   peer: P independent 16-byte loads, all rounds in registers, P stores
//   back in place. No thread reads another thread's columns, so writing
//   in place is race-free. Neighbouring threads take neighbouring vectors,
//   so every row's loads and stores coalesce; the cache hints stream
//   (nothing is read twice).
// - P is a template parameter, so the peers' values are registers
//   indexed at compile time. It is built for the peer counts the device
//   backend runs on one card: 4 (the (2, 2) and (4,) grids of the
//   training step) and 2 (a rank's own peers on a mesh). The wrapper
//   routes any other count to the plain route. The groups are data: bit
//   masks in the kernel's parameters, the same for every thread, so the
//   member tests are uniform branches and one instantiation serves every
//   grid of P peers.
// - A grid-stride loop over at most kBlocksPerSm blocks an SM.
// - A leaf whose rows are not 16-byte aligned (D not a multiple of the
//   vector, or an offset base) takes the same kernel's scalar loop, one
//   column a thread, with the same arithmetic.
// - The mask is read on the device, P floats a thread: no host sync.
//   The kernel allocates nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxPeers = 4;        // the largest instantiation
constexpr int kMaxRounds = 8;
static_assert(kMaxPeers <= 16, "a group is a 16-bit mask of peers");

struct Rounds {
  unsigned short group[kMaxRounds][kMaxPeers];  // bit q: q in p's group
  int n;                                        // rounds, in order
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int kN = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int kN = 8; };

__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, int V> struct Io;

template <> struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[4]) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2],
                                                     v[3]));
  }
};

template <> struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  // v holds values already rounded to bf16, so the packing is exact
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 t;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    __stcs(reinterpret_cast<uint4*>(p), t);
  }
};

template <> struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p,
                                              float (&v)[1]) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void store(float* p,
                                               const float (&v)[1]) {
    __stcs(p, v[0]);
  }
};

template <> struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// The rounds over one column vector of every peer, in registers. Each
// group is reduced once, by its first member p; its members are p and
// later peers, so they add in ascending order.
template <typename T, int P, int V>
__device__ __forceinline__ void run_rounds(float (&x)[P][V],
                                           const float (&mk)[P],
                                           const Rounds& r) {
  for (int k = 0; k < r.n; ++k) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const unsigned g = r.group[k][p];
      if (g & ((1u << p) - 1u)) continue;     // not the group's first
      float num[V];
#pragma unroll
      for (int c = 0; c < V; ++c) num[c] = 0.f;
      float den = 0.f;
#pragma unroll
      for (int q = p; q < P; ++q) {
        if (!((g >> q) & 1u)) continue;
        den = __fadd_rn(den, mk[q]);
#pragma unroll
        for (int c = 0; c < V; ++c) {
          num[c] = __fadd_rn(num[c], __fmul_rn(x[q][c], mk[q]));
        }
      }
      const float scale = fmaxf(den, 1.f);
      if ((__float_as_uint(scale) & 0x7fffffu) == 0u) {
        // a power of two: times its reciprocal, which is exact, rounds
        // the same exact quotient once, as the division does
        const float inv = __fdiv_rn(1.f, scale);
#pragma unroll
        for (int c = 0; c < V; ++c) num[c] = __fmul_rn(num[c], inv);
      } else {
#pragma unroll
        for (int c = 0; c < V; ++c) num[c] = __fdiv_rn(num[c], scale);
      }
      // mean * (1 - empty) + own * empty; a product by 1 is exact
#pragma unroll
      for (int q = p; q < P; ++q) {
        if (!((g >> q) & 1u)) continue;
#pragma unroll
        for (int c = 0; c < V; ++c) {
          x[q][c] = round_to(den == 0.f
                                 ? __fadd_rn(__fmul_rn(num[c], 0.f), x[q][c])
                                 : __fadd_rn(num[c], __fmul_rn(x[q][c], 0.f)),
                             T());
        }
      }
    }
  }
}

// The columns [0, nvec * V) as nvec 16-byte vectors, then the columns
// [nvec * V, d) one at a time (all of them where nvec is 0).
template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
mar_rounds_inplace_kernel(T* __restrict__ x, const float* __restrict__ mask,
                          long long d, long long nvec,
                          const __grid_constant__ Rounds r) {
  constexpr int V = Vec<T>::kN;
  float mk[P];
#pragma unroll
  for (int p = 0; p < P; ++p) mk[p] = __ldg(mask + p);
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c = first; c < nvec; c += stride) {
    float v[P][V];
#pragma unroll
    for (int p = 0; p < P; ++p) Io<T, V>::load(x + p * d + c * V, v[p]);
    run_rounds<T, P, V>(v, mk, r);
#pragma unroll
    for (int p = 0; p < P; ++p) Io<T, V>::store(x + p * d + c * V, v[p]);
  }
  for (long long c = nvec * V + first; c < d; c += stride) {
    float v[P][1];
#pragma unroll
    for (int p = 0; p < P; ++p) Io<T, 1>::load(x + p * d + c, v[p]);
    run_rounds<T, P, 1>(v, mk, r);
#pragma unroll
    for (int p = 0; p < P; ++p) Io<T, 1>::store(x + p * d + c, v[p]);
  }
}

template <typename T>
int launch(void* x, const void* mask, long long d, int p,
           const unsigned short* group, int n_rounds, void* stream) {
  constexpr int V = Vec<T>::kN;
  if ((p != 2 && p != 4) || n_rounds < 0 || n_rounds > kMaxRounds ||
      d < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0 || n_rounds == 0) return 0;
  Rounds r = {};
  for (int k = 0; k < n_rounds; ++k) {
    for (int q = 0; q < p; ++q) r.group[k][q] = group[k * p + q];
  }
  r.n = n_rounds;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = d % V == 0 &&
                       (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const long long nvec = aligned ? d / V : 0;
  long long blocks = ((aligned ? nvec : d) + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm) {
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  }
  T* xt = static_cast<T*>(x);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (p == 2) {
    mar_rounds_inplace_kernel<T, 2><<<grid, kThreads, 0, s>>>(xt, m, d, nvec,
                                                               r);
  } else {
    mar_rounds_inplace_kernel<T, 4><<<grid, kThreads, 0, s>>>(xt, m, d, nvec,
                                                               r);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rounds over one leaf, in place. x: [p, d] contiguous, p 2 or 4;
// mask: [p] contiguous f32 on the same device; group: n_rounds rows of p
// bit masks (row k, entry q: peer q's group in round k). Returns
// cudaGetLastError() after the launch (0 on success); nothing is
// launched for d = 0 or n_rounds = 0.
int mar_rounds_f32(void* x, const void* mask, long long d, int p,
                   const unsigned short* group, int n_rounds, void* stream) {
  return launch<float>(x, mask, d, p, group, n_rounds, stream);
}

// As mar_rounds_f32 for a bf16 leaf (the mask stays f32).
int mar_rounds_bf16(void* x, const void* mask, long long d, int p,
                    const unsigned short* group, int n_rounds,
                    void* stream) {
  return launch<__nv_bfloat16>(x, mask, d, p, group, n_rounds, stream);
}

}  // extern "C"
