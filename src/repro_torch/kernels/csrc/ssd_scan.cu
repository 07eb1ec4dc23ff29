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
// ~3.2 GFLOP. So the bound is the bytes.
//
// bf16 entry: one block owns one (batch, head, TV-column tile of H): the
// columns of H evolve independently (H[:, c] needs only v[:, c]), so the
// column tiles of a head are independent blocks. TV is 32 at dk <= 64
// (zamba2: 2 x 80 = 160 blocks, two an SM) and 16 above (xlstm: 33 x 4 =
// 132 blocks, one wave; the last tile holds one live column). The block
// walks the chunks of 64 steps in order: four compute warps own 16 rows
// of a chunk each, and a fifth warp only copies (warp specialisation).
// All four products run on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulators; hopper_mma.cuh):
//   - S = q k^T, the bf16 inputs as they are, all 64 columns in every
//     warp: warp 3 (the chunk's last rows) needs them all and sets the
//     chunk's pace, and skipping the tiles above the other warps'
//     diagonal only split their code into branches the compiler could
//     not interleave (slower on the card, as was handing the causal
//     tiles out evenly through shared memory: the kernel is bound by
//     instruction latency, not by the tensor cores);
//   - G = S o gate, rounded to bf16 and repacked from C into A fragments
//     in registers, as flash does with P; y = G v + exp(cum) q.H;
//   - q.H with H (f32) split into bf16 hi + lo, two products: ~16
//     mantissa bits of H;
//   - H' = exp(total) H + k^T (w o v), w_j = exp(total - cum_j): A = k^T
//     by ldmatrix.trans of the k tile, B = w o v, rounded to bf16 once
//     (in registers, from v's B fragments), the sum in f32.
// The decays are scanned in base 2 (two warp scans and a carry, by every
// compute warp into its own row of shared memory) and every exponential
// is one ex2.approx.ftz.
// H's tile [dk, TV] lives in shared memory in f32; warp w owns rows
// 16w..16w+15 of every 64-row piece of dk, so only it reads and writes
// them. Beside it, the bf16 hi/lo copy that q.H reads is double-buffered
// by chunk parity (chunk c reads one, writes the other), so the compute
// warps meet once a chunk (a named barrier) and never between a q.H and
// an update.
// q and k stream through shared memory in pieces of [64 steps x 64 of
// dk] (a stage), in a ring of 3 slots that the copy warp fills by
// cp.async 16-byte copies (log_a rides with a chunk's first piece, 4-byte
// copies), two stages ahead; an mbarrier per slot says it is full (the
// copies' own arrive-on), another that the four compute warps are done
// with it. So no compute warp waits on a copy it issued or on a block
// barrier per stage. At dk = 64 a stage is a chunk; at dk = 512 a chunk
// is 8 stages. Shared memory: 3 x 18.3 KB ring, H 10-48 KB, hi/lo 20-96
// KB, v 6-10 KB: 98 KB at zamba2 (two blocks an SM), 206 KB at xlstm.
//
// Trouble spots:
//   1. Misaligned v and y rows: xlstm's dv = 513 (mLSTM's appended ones
//      column) puts odd rows of v and y at odd element offsets, so no
//      16- or 4-byte copy can start there. v is not padded (another
//      launch, 4 MB more a layer): each compute thread loads its share of
//      the next chunk's v tile into registers while the current chunk
//      computes (bf16 pairs when v's base and strides are even, as at
//      zamba2; else one element at a time, kept unpacked until the
//      store, so the loads stay in flight) and stores it to shared
//      memory at the chunk's end. y and h_final are stored from the
//      accumulators in pairs when dv is even, else element by element;
//      h0 comes in by 4-byte copies.
//   2. q and k come in two layouts: zamba2's are one [S, 64] matrix
//      broadcast over 80 heads (head stride 0), xlstm's a transposed
//      view (time stride 2,048, head stride 512). 16-byte copies need
//      bases 16-byte aligned, the batch, head and time strides and dk
//      multiples of 8 elements; the wrapper's check_layout requires
//      exactly that, and the launch refuses anything else.
//   3. Registers: a compute warp holds its 16 x 64 scores, a 16 x TV
//      accumulator, the chunk's w o v B fragments (64 x TV) and the next
//      chunk's v share; at TV = 32 the kernel is bounded to two blocks an
//      SM (204 registers). See chip_smoke.py's ptxas line.
// A ragged S is masked: padded steps get a = 0 and q = k = v = 0, so they
// leave H exact; dk is zero-padded to a multiple of 64, dv's last tile
// masked.
//
// f32 entry (unchanged arithmetic, the f32 cores, no TF32): one block
// owns one (batch, head, 32-column tile of H) and walks 32-step chunks,
// H's tile [dk, 32] f32 in shared memory; q and k are staged per chunk
// in pieces of 32 rows of dk; each thread owns a strided 2x2 tile (rows
// r, r+16; columns c, c+16) of the chunk's [32 x 32] products.
//
// Both entries take q, k, v and log_a with their batch, head and time
// strides (the last axis contiguous), so Mamba2's B and C, broadcast over
// 80 heads with a head stride of 0, go in without a copy.
//
// The bf16 backward (ssd_bwd_bf16, kernels ssd_bwd_*) is described at its
// namespace, `bwd`, below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper_mma.cuh"

namespace {

struct Layout {                 // batch, head and time strides (elements)
  long long q[3], k[3], v[3], a[3];
};

// ---------------------------------------------------------------------------
// bf16: tensor cores, a copy warp and a cp.async ring
// ---------------------------------------------------------------------------

namespace bf {

using bf16 = __nv_bfloat16;

constexpr int kC = 64;                       // chunk length (time steps)
constexpr int kP = 64;                       // rows of dk per piece
constexpr int kWarps = 4;                    // compute warps, 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kBlock = kThreads + 32;        // and one copy warp
constexpr int kStages = 3;                   // ring of q/k pieces
constexpr int kQS = hop::row_stride(4);      // 72: q/k piece row stride
constexpr int kSlot = 2 * kC * kQS * 2 + kC * 4;   // bytes: q, k, log_a
constexpr int kMaxDk = 512;

// Row stride (elements) of H, its hi/lo copy and the v tile: 16 bytes of
// padding keep ldmatrix rows and the fragments' float2 accesses free of
// bank conflicts at TV = 16 and 32.
template <int TV>
__host__ __device__ constexpr int hs() { return TV + 8; }

template <int TV>
constexpr size_t smem_bytes(int dkp) {
  return static_cast<size_t>(kStages) * kSlot +
         static_cast<size_t>(dkp) * hs<TV>() * (4 * 2 + 4) +  // hi/lo x2, H
         2 * kC * hs<TV>() * 2 + kWarps * kC * 4 +            // v x2, cum
         2 * kStages * 8;                                     // mbarriers
}

// mbarriers of the q/k ring (shared memory, CTA scope).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(
                   hop::smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          hop::smem_addr(bar))
      : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   hop::smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared.b64 done, [%0], %1;\n"
      " @!done bra WAIT;\n}\n" ::"r"(hop::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The compute warps meet (the copy warp does not take part).
__device__ __forceinline__ void sync_compute_warps() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// 2^x on the special-function unit, subnormal results flushed to 0 (they
// are below what a bf16 product can carry).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A bf16 pair scaled by (wa, wb), rounded to bf16 again.
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float wa,
                                                 float wb) {
  const float2 f = unpack_bf16x2(x);
  return hop::pack_bf16x2(f.x * wa, f.y * wb);
}

struct Args {
  const bf16* q;                // this (batch, head)'s bases
  const bf16* k;
  const bf16* v;
  const float* a;
  long long qt, kt, vt, at;     // time strides
  int s, dk, dv, c0, n_pieces;
};

// The copy warp's cp.async copies of one stage, piece p of chunk c, into
// ring slot `slot`: q and k [64 steps x 64 of dk], rows lane / 8 + 4 i (i
// < 16), 16 bytes a lane each, and with a chunk's first piece the
// chunk's log_a. Rows past S and columns past dk are zero-filled.
__device__ __forceinline__ void issue_stage(char* ring, const Args& g, int c,
                                            int p, int slot, int lane) {
  const int t0 = c * kC, len = min(kC, g.s - t0), d0 = p * kP;
  bf16* qs = reinterpret_cast<bf16*>(ring + slot * kSlot);
  bf16* ks = qs + kC * kQS;
  const int r0 = lane >> 3, cc = (lane & 7) << 3;
  const bool col_ok = d0 + cc < g.dk;
  const bf16* qr = g.q + (t0 + r0) * g.qt + d0 + cc;
  const bf16* kr = g.k + (t0 + r0) * g.kt + d0 + cc;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = r0 + 4 * i;
    const bool ok = col_ok && r < len;
    hop::cp_async16(qs + r * kQS + cc, ok ? qr + 4 * i * g.qt : g.q,
                    ok ? 16 : 0);
    hop::cp_async16(ks + r * kQS + cc, ok ? kr + 4 * i * g.kt : g.k,
                    ok ? 16 : 0);
  }
  if (p == 0) {
    float* as = reinterpret_cast<float*>(ks + kC * kQS);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      hop::cp_async4(as + j, j < len ? g.a + (t0 + j) * g.at : g.a,
                     j < len ? 4 : 0);
    }
  }
}

// The next stage to issue: its chunk, piece and ring slot.
struct NextStage {
  int c = 0, p = 0, slot = 0, n = 0;            // n: stages issued so far
  __device__ __forceinline__ void advance(int n_pieces) {
    ++n;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    if (++p == n_pieces) {
      p = 0;
      ++c;
    }
  }
};

// Registers that hold this thread's share of a v tile [64 x TV]: TV/4
// bf16 pairs, or with PAIRS false TV/2 single elements, kept apart until
// they are stored (packing them would wait for the loads right away).
template <int TV, bool PAIRS>
__host__ __device__ constexpr int v_regs() { return PAIRS ? TV / 4 : TV / 2; }

// Start loading this thread's share of chunk c's v tile (zeros past S and
// dv): pair i is row (tid + 128 i) / (TV/2), columns 2 ((tid + 128 i) %
// (TV/2)) and the next. PAIRS: v's base and strides are even, so a pair
// is one 4-byte load.
template <int TV, bool PAIRS>
__device__ __forceinline__ void load_v(uint32_t (&vr)[v_regs<TV, PAIRS>()],
                                       const Args& g, int c) {
  const int t0 = c * kC, len = min(kC, g.s - t0);
  const unsigned short* vb = reinterpret_cast<const unsigned short*>(g.v);
#pragma unroll
  for (int i = 0; i < TV / 4; ++i) {
    const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = idx / (TV / 2), col = g.c0 + 2 * (idx % (TV / 2));
    const unsigned short* p = vb + (t0 + r) * g.vt + col;
    if (PAIRS) {
      vr[i] = r < len && col + 1 < g.dv
                  ? __ldg(reinterpret_cast<const unsigned int*>(p))
                  : (r < len && col < g.dv ? __ldg(p) : 0u);
    } else {
      vr[2 * i] = r < len && col < g.dv ? __ldg(p) : 0u;
      vr[2 * i + 1] = r < len && col + 1 < g.dv ? __ldg(p + 1) : 0u;
    }
  }
}

template <int TV, bool PAIRS>
__device__ __forceinline__ void store_v(
    bf16* vs, const uint32_t (&vr)[v_regs<TV, PAIRS>()]) {
#pragma unroll
  for (int i = 0; i < TV / 4; ++i) {
    const int idx = static_cast<int>(threadIdx.x) + i * kThreads;
    const int r = idx / (TV / 2), col = 2 * (idx % (TV / 2));
    *reinterpret_cast<uint32_t*>(vs + r * hs<TV>() + col) =
        PAIRS ? vr[i] : vr[2 * i] | (vr[2 * i + 1] << 16);
  }
}

template <int TV, bool PAIRS>
__global__ void __launch_bounds__(kBlock, TV == 32 && PAIRS ? 2 : 1)
ssd_scan_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ log_a,
                     const float* __restrict__ h0, bf16* __restrict__ y,
                     float* __restrict__ h_out, Layout st, int nh, int s,
                     int dk, int dv) {
  constexpr int NT = TV / 8;                    // n-tiles of 8 columns
  constexpr int HS = hs<TV>();
  extern __shared__ float4 smem4[];
  const int dkp = (dk + kP - 1) / kP * kP;
  char* ring = reinterpret_cast<char*>(smem4);
  bf16* hilo = reinterpret_cast<bf16*>(ring + kStages * kSlot);
  float* hf = reinterpret_cast<float*>(hilo + 4 * dkp * HS);    // [dkp][HS]
  bf16* vbuf = reinterpret_cast<bf16*>(hf + dkp * HS);          // [2][64][HS]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* cum = reinterpret_cast<float*>(vbuf + 2 * kC * HS) + warp * kC;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<float*>(vbuf + 2 * kC * HS) + kWarps * kC);
  uint64_t* empty = full + kStages;             // [kStages] each

  const int head = blockIdx.y;
  const long long bi = blockIdx.z;
  const long long bh = bi * nh + head;
  Args ar;
  ar.q = q + bi * st.q[0] + head * st.q[1];
  ar.k = k + bi * st.k[0] + head * st.k[1];
  ar.v = v + bi * st.v[0] + head * st.v[1];
  ar.a = log_a + bi * st.a[0] + head * st.a[1];
  ar.qt = st.q[2];
  ar.kt = st.k[2];
  ar.vt = st.v[2];
  ar.at = st.a[2];
  ar.s = s;
  ar.dk = dk;
  ar.dv = dv;
  ar.c0 = blockIdx.x * TV;
  ar.n_pieces = dkp / kP;
  const int n_chunks = (s + kC - 1) / kC;
  const int n_stages = n_chunks * ar.n_pieces;
  const float* h0b = h0 + bh * dk * dv;
  float* hob = h_out + bh * dk * dv;
  bf16* yb = y + bh * s * dv;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 32);                  // the copy warp's lanes
      mbar_init(empty + i, kWarps);             // one arrival a warp
    }
  }
  __syncthreads();
  if (warp == kWarps) {                         // the copy warp
    NextStage nx;
    while (nx.n < n_stages) {
      mbar_wait(empty + nx.slot, ((nx.n / kStages) & 1) ^ 1);
      issue_stage(ring, ar, nx.c, nx.p, nx.slot, lane);
      mbar_arrive_copies(full + nx.slot);
      nx.advance(ar.n_pieces);
    }
    hop::cp_async_wait<0>();
    return;
  }

  // h0 into H (f32): each warp copies the rows it owns (16 of every
  // 64-row piece; lane l row l / 2, columns from (l % 2) TV / 2 on), 4
  // bytes at a time (h0's rows need not be 16-byte aligned: xlstm's have
  // 513 floats), all in flight at once; meanwhile chunk 0's v tile. Each
  // lane splits its own elements into hi/lo for chunk 0.
  const int hr = warp * 16 + (lane >> 1), hc = (lane & 1) * (TV / 2);
  for (int p = 0; p < ar.n_pieces; ++p) {
    const int d = p * kP + hr;
#pragma unroll
    for (int e = 0; e < TV / 2; ++e) {
      const bool ok = d < dk && ar.c0 + hc + e < dv;
      hop::cp_async4(hf + d * HS + hc + e,
                     ok ? h0b + static_cast<long long>(d) * dv + ar.c0 + hc + e
                        : h0b,
                     ok ? 4 : 0);
    }
  }
  hop::cp_async_commit();
  uint32_t vr[v_regs<TV, PAIRS>()];
  if (n_chunks > 0) {
    load_v<TV, PAIRS>(vr, ar, 0);
    store_v<TV, PAIRS>(vbuf, vr);
  }
  hop::cp_async_wait<0>();                      // this lane's h0 copies
  for (int p = 0; p < ar.n_pieces; ++p) {
    const int d = p * kP + hr;
#pragma unroll
    for (int e = 0; e < TV / 2; ++e) {
      const float x = hf[d * HS + hc + e];
      const bf16 hi = __float2bfloat16(x);
      hilo[d * HS + hc + e] = hi;
      hilo[(dkp + d) * HS + hc + e] =
          __float2bfloat16(x - __bfloat162float(hi));
      if (n_chunks == 0 && d < dk && ar.c0 + hc + e < dv)   // S = 0
        hob[static_cast<long long>(d) * dv + ar.c0 + hc + e] = x;
    }
  }

  const int i0 = warp * 16 + g;                 // this thread's chunk rows
  int slot = 0, round = 0;                      // of the stage in hand
  for (int c = 0; c < n_chunks; ++c) {
    // every warp is done with chunk c - 1: H's hi/lo copy and the v tile
    // it wrote are in place, and the ones it read are free
    sync_compute_warps();
    const int t0 = c * kC;
    const int len = min(kC, s - t0);
    const bf16* vcur = vbuf + (c & 1) * kC * HS;
    const bf16* hcur = hilo + (c & 1) * 2 * dkp * HS;     // hi; lo + dkp
    bf16* hnext = hilo + ((c + 1) & 1) * 2 * dkp * HS;
    float sc[8][4];
    float acc[NT][4];
    uint32_t vw[4][NT][2];
    float decay = 1.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    for (int p = 0; p < ar.n_pieces; ++p) {
      mbar_wait(full + slot, round & 1);        // this stage has landed
      const bf16* qs = reinterpret_cast<const bf16*>(ring + slot * kSlot);
      const bf16* ks = qs + kC * kQS;

      // S += q k^T and acc += q . (H_hi + H_lo) over this piece of dk
      const bf16* hi = hcur + p * kP * HS;
      const bf16* lo = hi + dkp * HS;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t qa[4];
        hop::ldsm_x4(qa, qs + (warp * 16 + (lane & 15)) * kQS + kk * 16 +
                             ((lane >> 4) << 3));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          hop::ldsm_x4(b, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                   kQS +
                              kk * 16 + (((lane >> 3) & 1) << 3));
          hop::mma_bf16(sc[2 * np], qa, b[0], b[1]);
          hop::mma_bf16(sc[2 * np + 1], qa, b[2], b[3]);
        }
#pragma unroll
        for (int nq = 0; nq < NT / 2; ++nq) {
          uint32_t bh[4], bl[4];
          const int off = (kk * 16 + (lane & 15)) * HS + nq * 16 +
                          ((lane >> 4) << 3);
          hop::ldsm_x4_t(bh, hi + off);
          hop::ldsm_x4_t(bl, lo + off);
          hop::mma_bf16(acc[2 * nq], qa, bh[0], bh[1]);
          hop::mma_bf16(acc[2 * nq + 1], qa, bh[2], bh[3]);
          hop::mma_bf16(acc[2 * nq], qa, bl[0], bl[1]);
          hop::mma_bf16(acc[2 * nq + 1], qa, bl[2], bl[3]);
        }
      }

      if (p == 0) {                             // while the products run
        if (c + 1 < n_chunks) load_v<TV, PAIRS>(vr, ar, c + 1);
        // the chunk's decay scan in base 2, by every warp into its own
        // cum row
        const float* as = reinterpret_cast<const float*>(ks + kC * kQS);
        float x0 = as[lane] * hop::kLog2e, x1 = as[32 + lane] * hop::kLog2e;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float u0 = __shfl_up_sync(hop::kFull, x0, off);
          const float u1 = __shfl_up_sync(hop::kFull, x1, off);
          if (lane >= off) {
            x0 += u0;
            x1 += u1;
          }
        }
        x1 += __shfl_sync(hop::kFull, x0, 31);
        cum[lane] = x0;
        cum[32 + lane] = x1;
        __syncwarp();
        const float total = __shfl_sync(hop::kFull, x1, 31);
        decay = ex2(total);
        // B fragments of w o v: j = 16 kk + 2t (+1) in b0, +8 (+9) in b1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int j = kk * 16 + 2 * t;
          const float w0 = ex2(total - cum[j]);
          const float w1 = ex2(total - cum[j + 1]);
          const float w8 = ex2(total - cum[j + 8]);
          const float w9 = ex2(total - cum[j + 9]);
#pragma unroll
          for (int nq = 0; nq < NT / 2; ++nq) {
            uint32_t b[4];
            hop::ldsm_x4_t(b, vcur + (kk * 16 + (lane & 15)) * HS + nq * 16 +
                                  ((lane >> 4) << 3));
            vw[kk][2 * nq][0] = scale_bf16x2(b[0], w0, w1);
            vw[kk][2 * nq][1] = scale_bf16x2(b[1], w8, w9);
            vw[kk][2 * nq + 1][0] = scale_bf16x2(b[2], w0, w1);
            vw[kk][2 * nq + 1][1] = scale_bf16x2(b[3], w8, w9);
          }
        }
      }

      // H' = decay H + k^T (w o v) on this warp's 16 rows of the piece;
      // then its hi/lo copy for the next chunk, or after the last chunk
      // h_final
      {
        const int d = p * kP + warp * 16 + g;
        float* h0r = hf + d * HS;
        float* h1r = h0r + 8 * HS;
        float hu[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 x0 = *reinterpret_cast<const float2*>(h0r + nt * 8 + 2 * t);
          const float2 x1 = *reinterpret_cast<const float2*>(h1r + nt * 8 + 2 * t);
          hu[nt][0] = x0.x * decay;
          hu[nt][1] = x0.y * decay;
          hu[nt][2] = x1.x * decay;
          hu[nt][3] = x1.y * decay;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t ka[4];                       // k^T: rows d, columns j
          hop::ldsm_x4_t(ka, ks + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                      kQS +
                                 warp * 16 + (((lane >> 3) & 1) << 3));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            hop::mma_bf16(hu[nt], ka, vw[kk][nt][0], vw[kk][nt][1]);
        }
        if (c + 1 < n_chunks) {
          bf16* n0 = hnext + d * HS;
          bf16* n1 = n0 + 8 * HS;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = nt * 8 + 2 * t;
            *reinterpret_cast<float2*>(h0r + col) =
                make_float2(hu[nt][0], hu[nt][1]);
            *reinterpret_cast<float2*>(h1r + col) =
                make_float2(hu[nt][2], hu[nt][3]);
            const uint32_t a0 = hop::pack_bf16x2(hu[nt][0], hu[nt][1]);
            const uint32_t a1 = hop::pack_bf16x2(hu[nt][2], hu[nt][3]);
            const float2 f0 = unpack_bf16x2(a0), f1 = unpack_bf16x2(a1);
            *reinterpret_cast<uint32_t*>(n0 + col) = a0;
            *reinterpret_cast<uint32_t*>(n1 + col) = a1;
            *reinterpret_cast<uint32_t*>(n0 + dkp * HS + col) =
                hop::pack_bf16x2(hu[nt][0] - f0.x, hu[nt][1] - f0.y);
            *reinterpret_cast<uint32_t*>(n1 + dkp * HS + col) =
                hop::pack_bf16x2(hu[nt][2] - f1.x, hu[nt][3] - f1.y);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (d + 8 * r >= dk) continue;
            float* hr = hob + static_cast<long long>(d + 8 * r) * dv;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int col = ar.c0 + nt * 8 + 2 * t;
              const float x0 = hu[nt][2 * r], x1 = hu[nt][2 * r + 1];
              if ((dv & 1) == 0 && col + 1 < dv) {
                *reinterpret_cast<float2*>(hr + col) = make_float2(x0, x1);
              } else {
                if (col < dv) hr[col] = x0;
                if (col + 1 < dv) hr[col + 1] = x1;
              }
            }
          }
        }
      }
      __syncwarp();                             // the slot is read
      if (lane == 0) mbar_arrive(empty + slot);
      if (++slot == kStages) {
        slot = 0;
        ++round;
      }
    }

    // the decay gate under the causal mask; y = exp(cum) q.H + G v
    const float ci0 = cum[i0], ci1 = cum[i0 + 8];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nb * 8 + 2 * t + (e & 1);
        const int i = i0 + (e >> 1) * 8;
        const float ci = (e >> 1) ? ci1 : ci0;
        sc[nb][e] = j <= i ? sc[nb][e] * ex2(fminf(ci - cum[j], 0.f)) : 0.f;
      }
    }
    {
      const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          hop::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]),
          hop::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]),
          hop::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          hop::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nq = 0; nq < NT / 2; ++nq) {
        uint32_t b[4];
        hop::ldsm_x4_t(b, vcur + (kk * 16 + (lane & 15)) * HS + nq * 16 +
                              ((lane >> 4) << 3));
        hop::mma_bf16(acc[2 * nq], pa, b[0], b[1]);
        hop::mma_bf16(acc[2 * nq + 1], pa, b[2], b[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      if (i >= len) continue;
      bf16* yr = yb + static_cast<long long>(t0 + i) * dv;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = ar.c0 + nt * 8 + 2 * t;
        const float x0 = acc[nt][2 * r], x1 = acc[nt][2 * r + 1];
        if ((dv & 1) == 0 && col + 1 < dv) {
          *reinterpret_cast<uint32_t*>(yr + col) = hop::pack_bf16x2(x0, x1);
        } else {
          if (col < dv) yr[col] = __float2bfloat16(x0);
          if (col + 1 < dv) yr[col + 1] = __float2bfloat16(x1);
        }
      }
    }
    // the next chunk's v tile (its buffer was last read in chunk c - 1)
    if (c + 1 < n_chunks)
      store_v<TV, PAIRS>(vbuf + ((c + 1) & 1) * kC * HS, vr);
  }

}

// The largest dk_pad each tile width is launched with: 32 columns only
// at dk <= 64 (one piece), 16 above.
template <int TV>
constexpr int max_dkp() { return TV == 32 ? kP : kMaxDk; }

template <int TV, bool PAIRS>
int launch(const void* q, const void* k, const void* v, const void* log_a,
           const void* h0, void* y, void* h_out, const Layout& st, int b,
           int nh, int s, int dk, int dv, void* stream) {
  const int dkp = (dk + kP - 1) / kP * kP;
  if (dkp > max_dkp<TV>()) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = hop::allow_smem<ssd_scan_bf16_kernel<TV, PAIRS>>(
      smem_bytes<TV>(max_dkp<TV>()));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dv + TV - 1) / TV, nh, b);
  ssd_scan_bf16_kernel<TV, PAIRS><<<grid, kBlock, smem_bytes<TV>(dkp),
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<bf16*>(y),
      static_cast<float*>(h_out), st, nh, s, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bf

// ---------------------------------------------------------------------------
// f32: f32 FMAs on the f32 cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kC = 32;          // chunk length (time steps)
constexpr int kTV = 32;         // columns of H (and of v, y) per block
constexpr int kP = 32;          // rows of dk staged per piece
constexpr int kThreads = 256;
constexpr int kQS = kP + 4;     // padded row strides, in floats
constexpr int kVS = kTV + 4;
constexpr int kGS = kC + 4;
constexpr int kMaxDk = 1024;

size_t smem_bytes(int dk) {
  return sizeof(float) * (static_cast<size_t>(dk) * kTV + 2 * kC * kQS +
                          kC * kVS + kC * kGS + kC);
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ log_a,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, Layout st, int nh, int s,
                    int dk, int dv) {
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
  const float* qb = q + bi * st.q[0] + head * st.q[1];
  const float* kb = k + bi * st.k[0] + head * st.k[1];
  const float* vb = v + bi * st.v[0] + head * st.v[1];
  const float* ab = log_a + bi * st.a[0] + head * st.a[1];
  const float* h0b = h0 + bh * dk * dv;
  float* hob = h_out + bh * dk * dv;
  float* yb = y + bh * s * dv;

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
          j < len && c0 + cc < dv ? vb[(t0 + j) * st.v[2] + c0 + cc] : 0.f;
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
        qs[j * kQS + d] = ok ? qb[t * st.q[2] + p0 + d] : 0.f;
        ks[j * kQS + d] = ok ? kb[t * st.k[2] + p0 + d] : 0.f;
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
        if (col < dv) yb[static_cast<long long>(t0 + i) * dv + col] = out[a][b];
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
            ok ? kb[(t0 + j) * st.k[2] + p0 + d] * expf(total - cum[j])
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

int launch(const void* q, const void* k, const void* v, const void* log_a,
           const void* h0, void* y, void* h_out, const Layout& st, int b,
           int nh, int s, int dk, int dv, void* stream) {
  if (dk > kMaxDk || dk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      hop::allow_smem<ssd_scan_f32_kernel>(smem_bytes(kMaxDk));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((dv + kTV - 1) / kTV, nh, b);
  ssd_scan_f32_kernel<<<grid, kThreads, smem_bytes(dk),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_a),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_out), st, nh, s, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 backward: the states, then each chunk's gradients
// ---------------------------------------------------------------------------
//
// Replaces no TPU kernel: the Pallas scan has no backward, and the JAX
// package trains through the VJP of its jnp chunked_linear_scan, whose
// plain PyTorch port (ref.ssd_scan_bwd) took ~1,400 launches and 12.8 ms
// of device time a call at the published Zamba2's training call (b 1, S
// 4,096, 80 heads, dk = dv = 64, bf16, B and C at head stride 0). The
// kernels' names start with ssd_bwd_ and hold no ssd_scan_: the
// forward's roofline reads that stem.
//
// Bound at that call: ~215 MB (v, dy, dq, dk, dv per head; B and C
// once; log_a, dlog_a, h0 in f32), 64.1 us, against the chunked VJP's
// FLOPs (per chunk 3 c^2 dk + 2 c^2 dv + 5 c dk dv multiply-adds) on the
// bf16 tensor cores: 26.8 GFLOP, 27.1 us, at this kernel's 64-step
// chunks. So the bytes. (ssd_scan_bwd_roofline counts the FLOPs at the
// forward's 256-step chunks, 67.1 GFLOP and 67.9 us: a bound ~6% above
// this one.)
//
// Design: two launches a call.
//   1. ssd_bwd_states_kernel: the only sequential part, the state over
//      the chunks of 64 steps. Half the blocks walk forward from h0 and
//      store H at each chunk's start; the other half walk back from
//      dh_final and store dH at each chunk's end. Both are one product
//      a chunk (x^T (u o z), u the decay weights) on the tensor cores,
//      the state in f32 registers; the stored states are bf16 hi + lo
//      (the same 4 bytes as f32, ready for the next products): 2 x 42
//      MB at the call above.
//   2. ssd_bwd_chunk_kernel: one block per (chunk, head, batch row),
//      5,120 at the call above, every one independent: q k^T, dy v^T,
//      the gated products for dq, dk and dv, the ones against H and dH,
//      and dlog_a from the chunk alone (see the kernel).
// Precision: the bf16 inputs go into the products as they are; every
// f32 operand (H, dH, the decay-weighted terms, dP o gate and S o gate)
// enters as bf16 hi + lo, ~16 mantissa bits, with f32 accumulators, so
// each gradient is at f32's level before its own rounding (at the call
// above dq, dk, dv within one bf16 ulp of the plain VJP's in every
// head). Decays are scanned in base 2, the causal mask selecting before
// each exponential, as in the forward.
// Trouble spots:
//   1. dlog_a: the sum over the whole sequence of q . dq - k . dk pairs
//      large terms of opposite sign (the i = j products, the decay
//      weights against h_final . dh_final) that the hi/lo products round
//      differently, which left dlog_a ~1e-4 of its peak off where the
//      decay is fast. Taken from the chunk alone instead, no term
//      enters twice.
//   2. Registers: the chunk kernel holds a 16 x 64 f32 product, its
//      bf16 hi/lo fragments and a 16 x 64 accumulator a warp; k q^T is
//      computed again for dv rather than kept, and the kernel runs two
//      blocks an SM (at three it spilled).
//   3. Layouts: q, k, v and dy come in with their strides (B and C at
//      head stride 0; v and dy as the model's transposed views) through
//      16-byte cp.async copies, so the wrapper copies only what those
//      cannot read.
//   4. Stores: the states pass writes its 2 x 42 MB from C fragments,
//      4 bytes a lane in eight rows; that took half its time (253 of
//      487 us a call), so each warp stages its rows in shared memory
//      and stores 16 bytes a lane (158 us).

namespace bwd {

using bf16 = __nv_bfloat16;
using bf::ex2;
using bf::unpack_bf16x2;

constexpr int kC = 64;                       // chunk length (time steps)
constexpr int kWarps = 4;                    // 16 rows of a chunk each
constexpr int kThreads = 32 * kWarps;
constexpr int kTV = 32;                      // state columns a states block
constexpr int kStages = 3;                   // the states pass's chunk ring
constexpr int kMaxD = 64;                    // dk and dv, each

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dy;               // null: a zero cotangent
  const float* a;
  const float* h0;
  const float* dh;              // null: a zero cotangent
  bf16* gq;                     // [b, nh, S, dk], contiguous
  bf16* gk;
  bf16* gv;                     // [b, nh, S, dv]
  float* gla;                   // [b, nh, S]
  float* gh0;                   // [b, nh, dk, dv]; null: not wanted
  bf16* hs;                     // [b, nh, nc, 2, DKP, DVP]: H at each
  bf16* dhs;                    // chunk's start, dH at its end; hi, lo
  long long sq[3], sk[3], sv[3], sy[3], sa[3];
  int nh, s, dk, dv, nc;
};

// The f32 pair (p0, p1) as bf16 hi plus bf16 lo, the part hi leaves out:
// ~16 mantissa bits, for an f32 operand of a bf16 product.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = hop::pack_bf16x2(p0, p1);
  const float2 h = unpack_bf16x2(hi);
  lo = hop::pack_bf16x2(p0 - h.x, p1 - h.y);
}

// The chunk's decays scanned in base 2 by one warp, from `as` [64] into
// its own `cum` row; returns the chunk's total.
__device__ __forceinline__ float chunk_scan(const float* as, float* cum,
                                            int lane) {
  float x0 = as[lane] * hop::kLog2e, x1 = as[32 + lane] * hop::kLog2e;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u0 = __shfl_up_sync(hop::kFull, x0, off);
    const float u1 = __shfl_up_sync(hop::kFull, x1, off);
    if (lane >= off) {
      x0 += u0;
      x1 += u1;
    }
  }
  x1 += __shfl_sync(hop::kFull, x0, 31);
  cum[lane] = x0;
  cum[32 + lane] = x1;
  __syncwarp();
  return __shfl_sync(hop::kFull, x1, 31);
}

// cp.async copies of a [64 x W] bf16 tile (rows `rs` elements apart, `w`
// valid columns, `len` valid rows; null `src`: zeros) into shared memory
// rows `ss` apart. `any` is a valid address for the zero-filling copies.
template <int W>
__device__ __forceinline__ void copy_tile(bf16* dst, int ss, const bf16* src,
                                          long long rs, int len, int w,
                                          const void* any, int tid) {
  constexpr int kSeg = W / 8;
#pragma unroll
  for (int i = 0; i < kC * kSeg / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / kSeg, col = (idx % kSeg) * 8;
    const bool ok = src != nullptr && r < len && col < w;
    hop::cp_async16(dst + r * ss + col, ok ? src + r * rs + col : any,
                    ok ? 16 : 0);
  }
}

// Row stride (elements) of a warp's staging rows: the state's 16 rows
// of one m-tile, hi then lo, on their way to 16-byte stores.
constexpr int kSS = kTV + 8;

template <int DKP>
constexpr size_t states_smem() {
  return sizeof(bf16) * (kStages * kC * ((DKP + 8) + (kTV + 8)) +
                         kWarps * 2 * 16 * kSS) +
         sizeof(float) * (kStages * kC + kWarps * kC);
}

// Pass 1. Blocks [0, DVP / kTV) walk the chunks forward from h0, storing
// H at each chunk's start, H' = exp(total) H + k^T (w o v); the other
// half walk them backward from dh_final, storing dH at each chunk's end,
// dH = exp(total) dH' + q^T (e o dy), e_i = exp(cum_i). One block per
// (kTV columns of the state, head, batch row); warp w keeps rows 16 w +
// 64 m of the state tile in registers (C fragments) and stores them
// through its own staging rows in shared memory, 16 bytes a lane (4-byte
// stores straight from the fragments took half the pass's time).
template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_states_kernel(const Args g) {
  constexpr int XS = DKP + 8, ZS = kTV + 8, NT = kTV / 8, MT = DKP / 64;
  constexpr int kTiles = DVP / kTV;
  extern __shared__ float4 smem4[];
  bf16* xs = reinterpret_cast<bf16*>(smem4);            // [kStages][64][XS]
  bf16* zs = xs + kStages * kC * XS;                    // [kStages][64][ZS]
  bf16* stage = zs + kStages * kC * ZS;                 // [kWarps][2][16][kSS]
  float* as = reinterpret_cast<float*>(stage + kWarps * 2 * 16 * kSS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  float* cum = as + kStages * kC + warp * kC;
  bf16* ws = stage + warp * 2 * 16 * kSS;
  const bool fwd = static_cast<int>(blockIdx.x) < kTiles;
  const int tile = fwd ? blockIdx.x : blockIdx.x - kTiles;
  const int c0 = tile * kTV, head = blockIdx.y;
  const long long bi = blockIdx.z, bh = bi * g.nh + head;
  const long long dkv = static_cast<long long>(g.dk) * g.dv;
  const bf16* x = fwd ? g.k + bi * g.sk[0] + head * g.sk[1]
                      : g.q + bi * g.sq[0] + head * g.sq[1];
  const long long xt = fwd ? g.sk[2] : g.sq[2];
  const bf16* z = fwd ? g.v + bi * g.sv[0] + head * g.sv[1] + c0
                      : (g.dy ? g.dy + bi * g.sy[0] + head * g.sy[1] + c0
                              : nullptr);
  const long long zt = fwd ? g.sv[2] : g.sy[2];
  const float* a = g.a + bi * g.sa[0] + head * g.sa[1];
  const float* init = fwd ? g.h0 + bh * dkv : (g.dh ? g.dh + bh * dkv
                                                    : nullptr);
  bf16* out = (fwd ? g.hs : g.dhs) + bh * g.nc * 2 * DKP * DVP;

  float st[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * m + 16 * warp + gr + 8 * (e >> 1);
        const int col = c0 + nt * 8 + 2 * t + (e & 1);
        st[m][nt][e] = init != nullptr && d < g.dk && col < g.dv
                           ? init[static_cast<long long>(d) * g.dv + col]
                           : 0.f;
      }

  auto issue = [&](int n) {                     // chunk n of the walk
    if (n < g.nc) {
      const int c = fwd ? n : g.nc - 1 - n;
      const int t0 = c * kC, len = min(kC, g.s - t0), slot = n % kStages;
      copy_tile<DKP>(xs + slot * kC * XS, XS, x + t0 * xt, xt, len, g.dk,
                     g.q, tid);
      copy_tile<kTV>(zs + slot * kC * ZS, ZS, z ? z + t0 * zt : nullptr, zt,
                     len, g.dv - c0, g.q, tid);
      if (tid < kC) {
        const bool ok = tid < len;
        hop::cp_async4(as + slot * kC + tid, ok ? a + (t0 + tid) * g.sa[2] : a,
                       ok ? 4 : 0);
      }
    }
    hop::cp_async_commit();
  };

  for (int n = 0; n < kStages - 1; ++n) issue(n);
  for (int n = 0; n < g.nc; ++n) {
    const int c = fwd ? n : g.nc - 1 - n;
    hop::cp_async_wait<kStages - 2>();          // chunk n has landed
    __syncthreads();                            // and chunk n - 1 is read
    issue(n + kStages - 1);
    const int slot = n % kStages;
    const bf16* xsl = xs + slot * kC * XS;
    const bf16* zsl = zs + slot * kC * ZS;

    // the state before this chunk's update, as bf16 hi and lo: this
    // warp's rows into its staging rows, then out 16 bytes a lane
    bf16* o = out + static_cast<long long>(c) * 2 * DKP * DVP;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split2(st[m][nt][2 * r], st[m][nt][2 * r + 1], hi, lo);
          const int off = (gr + 8 * r) * kSS + nt * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ws + off) = hi;
          *reinterpret_cast<uint32_t*>(ws + 16 * kSS + off) = lo;
        }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2 * 16 * (kTV / 8) / 32; ++i) {
        const int idx = lane + 32 * i;
        const int row = idx / (kTV / 8), piece = idx % (kTV / 8);
        const int half = row >> 4, d = 64 * m + 16 * warp + (row & 15);
        *reinterpret_cast<uint4*>(o + (half * DKP + d) * DVP + c0 +
                                  piece * 8) =
            *reinterpret_cast<const uint4*>(ws + row * kSS + piece * 8);
      }
      __syncwarp();
    }

    if (fwd && n + 1 == g.nc) break;            // h_final is not needed
    const float total = chunk_scan(as + slot * kC, cum, lane);
    const float decay = ex2(total);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][nt][e] *= decay;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // B = u o z, u = w (forward) or e (backward), in hi and lo; rows j
      // = 16 kk + 2t (+1) in b0, + 8 (+9) in b1
      const int j = kk * 16 + 2 * t;
      float u[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cj = cum[j + (e & 1) + 8 * (e >> 1)];
        u[e] = fwd ? ex2(total - cj) : ex2(cj);
      }
      uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
      for (int nq = 0; nq < NT / 2; ++nq) {
        uint32_t b[4];
        hop::ldsm_x4_t(b, zsl + (kk * 16 + (lane & 15)) * ZS + nq * 16 +
                              ((lane >> 4) << 3));
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 f = unpack_bf16x2(b[h]);
          const int hf = h & 1;                 // b0 or b1 of its n-tile
          split2(f.x * u[2 * hf], f.y * u[2 * hf + 1],
                 bhi[2 * nq + (h >> 1)][hf], blo[2 * nq + (h >> 1)][hf]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t ax[4];                         // x^T: rows d, columns j
        hop::ldsm_x4_t(ax, xsl + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     XS +
                               64 * m + warp * 16 +
                               (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          hop::mma_bf16(st[m][nt], ax, bhi[nt][0], bhi[nt][1]);
          hop::mma_bf16(st[m][nt], ax, blo[nt][0], blo[nt][1]);
        }
      }
    }
  }
  hop::cp_async_wait<0>();

  if (!fwd && g.gh0 != nullptr) {               // dh0 = dH at the start
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * m + 16 * warp + gr + 8 * (e >> 1);
          const int col = c0 + nt * 8 + 2 * t + (e & 1);
          if (d < g.dk && col < g.dv)
            g.gh0[bh * dkv + static_cast<long long>(d) * g.dv + col] =
                st[m][nt][e];
        }
  }
}

template <int DKP, int DVP>
constexpr size_t chunk_smem() {
  return sizeof(bf16) * (2 * kC * (DKP + 8) + 2 * kC * (DVP + 8) +
                         4 * DKP * (DVP + 8)) +
         sizeof(float) * (kC + kWarps * kC + 2 * kC + kWarps);
}

// C fragments [16 x 64] (8 n-tiles) rounded to bf16 hi and lo A
// fragments of the next product, k-steps of 16 columns.
__device__ __forceinline__ void to_a_hilo(const float (&c)[8][4],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split2(c[2 * kk][0], c[2 * kk][1], hi[kk][0], lo[kk][0]);
    split2(c[2 * kk][2], c[2 * kk][3], hi[kk][1], lo[kk][1]);
    split2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// acc[16 x 64] += rows `a` ([16 x 16 NKK], row stride sa) times the
// rows of `b` ([64 x 16 NKK], row stride sb) transposed, a b^T; with
// HILO, + a b2^T as well (b and b2 an f32 operand's hi and lo).
template <int NKK, bool HILO = false>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* a,
                                        int sa, const bf16* b, int sb,
                                        int lane, const bf16* b2 = nullptr) {
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    uint32_t fa[4];
    hop::ldsm_x4(fa, a + (lane & 15) * sa + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * sb +
                      kk * 16 + (((lane >> 3) & 1) << 3);
      uint32_t fb[4];
      hop::ldsm_x4(fb, b + off);
      hop::mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      hop::mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
      if (HILO) {
        hop::ldsm_x4(fb, b2 + off);
        hop::mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
        hop::mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// acc[16 x 64] += A (4 k-steps of A fragments, hi and lo) times `b`
// ([64 x 64] row-major, row stride bs): the k index is b's row.
__device__ __forceinline__ void mma_frag_b(float (&acc)[8][4],
                                           const uint32_t (&hi)[4][4],
                                           const uint32_t (&lo)[4][4],
                                           const bf16* b, int bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nq = 0; nq < 4; ++nq) {
      uint32_t fb[4];
      hop::ldsm_x4_t(fb, b + (kk * 16 + (lane & 15)) * bs + nq * 16 +
                             ((lane >> 4) << 3));
      hop::mma_bf16(acc[2 * nq], hi[kk], fb[0], fb[1]);
      hop::mma_bf16(acc[2 * nq + 1], hi[kk], fb[2], fb[3]);
      hop::mma_bf16(acc[2 * nq], lo[kk], fb[0], fb[1]);
      hop::mma_bf16(acc[2 * nq + 1], lo[kk], fb[2], fb[3]);
    }
  }
}

// acc[16 x 64] += rows `a` ([16 x 16 NKK]) times the state tile columns
// [64 x 64] of `bh` + `bl` (hi and lo, [16 NKK x 64] row-major): the k
// index is the state's row.
template <int NKK>
__device__ __forceinline__ void mma_a_state(float (&acc)[8][4],
                                            const bf16* a, int sa,
                                            const bf16* bh, const bf16* bl,
                                            int bs, int lane) {
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
    uint32_t fa[4];
    hop::ldsm_x4(fa, a + (lane & 15) * sa + kk * 16 + ((lane >> 4) << 3));
#pragma unroll
    for (int nq = 0; nq < 4; ++nq) {
      uint32_t fh[4], fl[4];
      const int off = (kk * 16 + (lane & 15)) * bs + nq * 16 +
                      ((lane >> 4) << 3);
      hop::ldsm_x4_t(fh, bh + off);
      hop::ldsm_x4_t(fl, bl + off);
      hop::mma_bf16(acc[2 * nq], fa, fh[0], fh[1]);
      hop::mma_bf16(acc[2 * nq + 1], fa, fh[2], fh[3]);
      hop::mma_bf16(acc[2 * nq], fa, fl[0], fl[1]);
      hop::mma_bf16(acc[2 * nq + 1], fa, fl[2], fl[3]);
    }
  }
}

// acc's two rows of this thread's C fragments scaled by s0 and s1.
__device__ __forceinline__ void scale_rows(float (&acc)[8][4], float s0,
                                           float s1) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] *= s0;
    acc[nt][1] *= s0;
    acc[nt][2] *= s1;
    acc[nt][3] *= s1;
  }
}

// dot[r] += acc's row r . the matching row of `x` (the [16 x 64] tile of
// acc's rows and columns, row stride xs), this thread's share.
__device__ __forceinline__ void row_dot(const float (&acc)[8][4],
                                        const bf16* x, int xs, int lane,
                                        float (&dot)[2]) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 x0 = unpack_bf16x2(
        *reinterpret_cast<const uint32_t*>(x + gr * xs + nt * 8 + 2 * t));
    const float2 x1 = unpack_bf16x2(*reinterpret_cast<const uint32_t*>(
        x + (gr + 8) * xs + nt * 8 + 2 * t));
    dot[0] += acc[nt][0] * x0.x + acc[nt][1] * x0.y;
    dot[1] += acc[nt][2] * x1.x + acc[nt][3] * x1.y;
  }
}

// Rows i0, i0 + 8 of acc (columns c0 + ...) into out ([len x n], row
// stride n) in bf16, where they lie inside.
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[8][4],
                                           int i0, int len, int c0, int n,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= len) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = c0 + nt * 8 + 2 * t;
      if (col < n)
        *reinterpret_cast<uint32_t*>(out + static_cast<long long>(i) * n +
                                     col) =
            hop::pack_bf16x2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
  }
}

// Pass 2. One block per (chunk, head, batch row); warp w owns the
// chunk's rows 16 w .. 16 w + 15, as query steps i (dq) and then as key
// steps j (dk, dv). With S = q k^T, dP = dy v^T, gate_ij = exp(cum_i -
// cum_j) for j <= i (0 above), H the chunk's starting state, dH its end
// cotangent, e_i = exp(cum_i), w_j = exp(total - cum_j):
//   dq = (dP o gate) k + e o (dy H^T)
//   dk = (dP o gate)^T q + w o (v dH^T)
//   dv = (S o gate)^T dy + w o (k dH)
// and dlog_a, from this chunk alone (its a_l reach the rest of the
// sequence only through H' = exp(total) H + ..., so exp(total) <H, dH>
// carries all of it):
//   dlog_a_l = sum_{i >= l > j} M_ij + sum_{i >= l} e_i (q_i H) . dy_i
//              + sum_{j < l} w_j (k_j dH) . v_j + exp(total) <H, dH>
// with M = S o gate o dP. The first sum is the suffix sum over i >= l of
// M's row sums less its column sums, both without the diagonal; so no
// term enters twice with opposite signs by two routes, as the sum of
// q . dq - k . dk over the whole sequence would (the i = j products and
// the w terms, large where the decay is fast and dlog_a near 0). Every
// product on the tensor cores: the bf16 inputs as they are; the f32
// operands (dP o gate, S o gate, H and dH) as bf16 hi + lo.
template <int DKP, int DVP>
__global__ void __launch_bounds__(kThreads, DKP + DVP <= 128 ? 2 : 1)
ssd_bwd_chunk_kernel(const Args g) {
  constexpr int QS = DKP + 8, VS = DVP + 8, NK = DKP / 16, NV = DVP / 16;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);            // [64][QS]
  bf16* ks = qs + kC * QS;                              // [64][QS]
  bf16* vs = ks + kC * QS;                              // [64][VS]
  bf16* ys = vs + kC * VS;                              // [64][VS]
  bf16* hh = ys + kC * VS;                              // [DKP][VS]: H hi,
  bf16* hl = hh + DKP * VS;                             //   H lo,
  bf16* dhh = hl + DKP * VS;                            //   dH hi,
  bf16* dhl = dhh + DKP * VS;                           //   dH lo
  float* as = reinterpret_cast<float*>(dhl + DKP * VS);  // [64] log_a
  float* rows = as + kC + kWarps * kC;          // [64] i-side, [64] w terms
  float* red = rows + 2 * kC;                   // [kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  float* cum = as + kC + warp * kC;
  const int c = blockIdx.x, head = blockIdx.y;
  const long long bi = blockIdx.z, bh = bi * g.nh + head;
  const int t0 = c * kC, len = min(kC, g.s - t0);

  copy_tile<DKP>(qs, QS, g.q + bi * g.sq[0] + head * g.sq[1] + t0 * g.sq[2],
                 g.sq[2], len, g.dk, g.q, tid);
  copy_tile<DKP>(ks, QS, g.k + bi * g.sk[0] + head * g.sk[1] + t0 * g.sk[2],
                 g.sk[2], len, g.dk, g.q, tid);
  copy_tile<DVP>(vs, VS, g.v + bi * g.sv[0] + head * g.sv[1] + t0 * g.sv[2],
                 g.sv[2], len, g.dv, g.q, tid);
  copy_tile<DVP>(ys, VS,
                 g.dy ? g.dy + bi * g.sy[0] + head * g.sy[1] + t0 * g.sy[2]
                      : nullptr,
                 g.sy[2], len, g.dv, g.q, tid);
  if (tid < kC) {
    const float* a = g.a + bi * g.sa[0] + head * g.sa[1];
    const bool ok = tid < len;
    hop::cp_async4(as + tid, ok ? a + (t0 + tid) * g.sa[2] : a, ok ? 4 : 0);
  }
  hop::cp_async_commit();
  {                                             // H and dH: [2][DKP][DVP]
    const long long off = (bh * g.nc + c) * 2 * DKP * DVP;
    constexpr int kSeg = DVP / 8;
#pragma unroll
    for (int i = 0; i < 2 * DKP * kSeg / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kSeg, col = (idx % kSeg) * 8;
      hop::cp_async16(hh + r * VS + col, g.hs + off + r * DVP + col, 16);
      hop::cp_async16(dhh + r * VS + col, g.dhs + off + r * DVP + col, 16);
    }
  }
  hop::cp_async_commit();
  hop::cp_async_wait<1>();                      // q, k, v, dy, log_a
  __syncthreads();

  const float total = chunk_scan(as, cum, lane);
  const int i0 = warp * 16 + gr;                // this thread's two rows
  const float c_0 = cum[i0], c_1 = cum[i0 + 8];
  uint32_t hi[4][4], lo[4][4];
  // M's row sums less its column sums (diagonal left out), then the
  // i-side and w terms of dlog_a, for this thread's two rows
  float msum[2] = {0.f, 0.f}, side[2] = {0.f, 0.f}, wside[2] = {0.f, 0.f};

  // --- rows as queries i: dq ---
  {
    float sc[8][4] = {}, dp[8][4] = {};
    mma_abt<NK>(sc, qs + warp * 16 * QS, QS, ks, QS, lane);   // q k^T
    mma_abt<NV>(dp, ys + warp * 16 * VS, VS, vs, VS, lane);   // dy v^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nb * 8 + 2 * t + (e & 1), i = i0 + 8 * (e >> 1);
        const float gate =
            j <= i ? ex2(fminf((e >> 1 ? c_1 : c_0) - cum[j], 0.f)) : 0.f;
        if (j < i) msum[e >> 1] += sc[nb][e] * gate * dp[nb][e];
        dp[nb][e] *= gate;
      }
    to_a_hilo(dp, hi, lo);
  }
  hop::cp_async_wait<0>();                      // H and dH
  __syncthreads();
  const float e_0 = ex2(c_0), e_1 = ex2(c_1);
  for (int ot = 0; ot < DKP / 64; ++ot) {
    float acc[8][4] = {};
    mma_abt<NV, true>(acc, ys + warp * 16 * VS, VS, hh + ot * 64 * VS, VS,
                      lane, hl + ot * 64 * VS);                 // dy H^T
    scale_rows(acc, e_0, e_1);
    row_dot(acc, qs + warp * 16 * QS + ot * 64, QS, lane, side);
    mma_frag_b(acc, hi, lo, ks + ot * 64, QS, lane);           // += dP' k
    store_rows(g.gq + (bh * g.s + t0) * g.dk, acc, i0, len, ot * 64, g.dk,
               lane);
  }

  // --- rows as keys j: dk, then dv ---
  {
    float st[8][4] = {}, dpt[8][4] = {};
    mma_abt<NK>(st, ks + warp * 16 * QS, QS, qs, QS, lane);    // k q^T
    mma_abt<NV>(dpt, vs + warp * 16 * VS, VS, ys, VS, lane);   // v dy^T
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nb * 8 + 2 * t + (e & 1), j = i0 + 8 * (e >> 1);
        const float gate =
            i >= j ? ex2(fminf(cum[i] - (e >> 1 ? c_1 : c_0), 0.f)) : 0.f;
        if (i > j) msum[e >> 1] -= st[nb][e] * gate * dpt[nb][e];
        dpt[nb][e] *= gate;
      }
    to_a_hilo(dpt, hi, lo);
  }
  const float w_0 = ex2(total - c_0), w_1 = ex2(total - c_1);
  for (int ot = 0; ot < DKP / 64; ++ot) {
    float acc[8][4] = {};
    mma_abt<NV, true>(acc, vs + warp * 16 * VS, VS, dhh + ot * 64 * VS, VS,
                      lane, dhl + ot * 64 * VS);                // v dH^T
    scale_rows(acc, w_0, w_1);
    row_dot(acc, ks + warp * 16 * QS + ot * 64, QS, lane, wside);
    mma_frag_b(acc, hi, lo, qs + ot * 64, QS, lane);           // += dP'^T q
    store_rows(g.gk + (bh * g.s + t0) * g.dk, acc, i0, len, ot * 64, g.dk,
               lane);
  }
  {                                             // k q^T again, gated
    float st[8][4] = {};
    mma_abt<NK>(st, ks + warp * 16 * QS, QS, qs, QS, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nb * 8 + 2 * t + (e & 1), j = i0 + 8 * (e >> 1);
        st[nb][e] *= i >= j ? ex2(fminf(cum[i] - (e >> 1 ? c_1 : c_0), 0.f))
                            : 0.f;
      }
    to_a_hilo(st, hi, lo);
  }
  for (int ot = 0; ot < DVP / 64; ++ot) {
    float acc[8][4] = {};
    mma_a_state<NK>(acc, ks + warp * 16 * QS, QS, dhh + ot * 64, dhl + ot * 64,
                    VS, lane);                                 // k dH
    scale_rows(acc, w_0, w_1);
    mma_frag_b(acc, hi, lo, ys + ot * 64, VS, lane);           // += G^T dy
    store_rows(g.gv + (bh * g.s + t0) * g.dv, acc, i0, len, ot * 64, g.dv,
               lane);
  }

  // --- dlog_a ---
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float x = hop::quad_sum(msum[r] + side[r]);
    const float y = hop::quad_sum(wside[r]);
    if (t == 0) {
      rows[i0 + 8 * r] = x;
      rows[kC + i0 + 8 * r] = y;
    }
  }
  float p = 0.f;                                // <H, dH>, this thread's
  for (int idx = tid; idx < DKP * DVP / 2; idx += kThreads) {
    const int d = idx / (DVP / 2), col = 2 * (idx % (DVP / 2));
    const int o = d * VS + col;
    auto at = [o](const bf16* x) {
      return unpack_bf16x2(*reinterpret_cast<const uint32_t*>(x + o));
    };
    const float2 h0 = at(hh), h1 = at(hl), d0 = at(dhh), d1 = at(dhl);
    p += (h0.x + h1.x) * (d0.x + d1.x) + (h0.y + h1.y) * (d0.y + d1.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    p += __shfl_xor_sync(hop::kFull, p, off);
  if (lane == 0) red[warp] = p;
  __syncthreads();
  if (warp == 0) {
    const float carry = ex2(total) * (red[0] + red[1] + red[2] + red[3]);
    // suffix sums of the i-side over l = lane, 32 + lane; exclusive
    // prefix sums of the w terms
    float x0 = rows[lane], x1 = rows[32 + lane];
    float y0 = rows[kC + lane], y1 = rows[kC + 32 + lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u0 = __shfl_down_sync(hop::kFull, x0, off);
      const float u1 = __shfl_down_sync(hop::kFull, x1, off);
      const float v0 = __shfl_up_sync(hop::kFull, y0, off);
      const float v1 = __shfl_up_sync(hop::kFull, y1, off);
      if (lane + off < 32) {
        x0 += u0;
        x1 += u1;
      }
      if (lane >= off) {
        y0 += v0;
        y1 += v1;
      }
    }
    x0 += __shfl_sync(hop::kFull, x1, 0);
    y1 += __shfl_sync(hop::kFull, y0, 31);
    y0 -= rows[kC + lane];                      // exclusive
    y1 -= rows[kC + 32 + lane];
    float* out = g.gla + bh * g.s + t0;
    if (lane < len) out[lane] = x0 + y0 + carry;
    if (32 + lane < len) out[32 + lane] = x1 + y1 + carry;
  }
}

template <int DKP, int DVP>
int launch(const Args& g, int b, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      hop::allow_smem<ssd_bwd_states_kernel<DKP, DVP>>(states_smem<DKP>());
  if (err == cudaSuccess)
    err = hop::allow_smem<ssd_bwd_chunk_kernel<DKP, DVP>>(
        chunk_smem<DKP, DVP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_states_kernel<DKP, DVP>
      <<<dim3(2 * (DVP / kTV), g.nh, b), kThreads, states_smem<DKP>(), st>>>(
          g);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.nc == 0) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<DKP, DVP>
      <<<dim3(g.nc, g.nh, b), kThreads, chunk_smem<DKP, DVP>(), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

// 0 when the call has something to do and its shape is one the entries
// take (-1: nothing to do), else an error code.
int prepare(const long long* strides, int b, int nh, int s, int dk, int dv,
            Layout& st) {
  if (b <= 0 || nh <= 0 || dv <= 0) return -1;
  if (s < 0 || dk <= 0 || nh > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.a[i] = strides[9 + i];
  }
  return 0;
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
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
  Layout st;
  const int bad = prepare(strides, b, nh, s, dk, dv, st);
  if (bad) return bad < 0 ? 0 : bad;
  return f32::launch(q, k, v, log_a, h0, y, h_out, st, b, nh, s, dk, dv,
                     stream);
}

// As ssd_scan_f32 with q, k, v and y in bf16 (log_a, h0, h_out f32),
// dk % 8 == 0, dk <= 512, q and k 16-byte aligned with batch, head and
// time strides that are multiples of 8 (16-byte copies); v and y take
// any alignment.
int ssd_scan_bf16(const void* q, const void* k, const void* v,
                  const void* log_a, const void* h0, void* y, void* h_out,
                  const long long* strides, int b, int nh, int s, int dk,
                  int dv, void* stream) {
  Layout st;
  const int bad = prepare(strides, b, nh, s, dk, dv, st);
  if (bad) return bad < 0 ? 0 : bad;
  bool ok = dk % 8 == 0 && dk <= bf::kMaxDk && aligned(q, 16) &&
            aligned(k, 16);
  for (int i = 0; i < 3; ++i) ok = ok && st.q[i] % 8 == 0 && st.k[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bool pairs = aligned(v, 4) && st.v[0] % 2 == 0 &&
                     st.v[1] % 2 == 0 && st.v[2] % 2 == 0;
  const bool wide = dk <= bf::kP;               // 32-column tiles
  auto run = wide ? (pairs ? bf::launch<32, true> : bf::launch<32, false>)
                  : (pairs ? bf::launch<16, true> : bf::launch<16, false>);
  return run(q, k, v, log_a, h0, y, h_out, st, b, nh, s, dk, dv, stream);
}

// The bf16 scan's backward: (q, k, v, log_a, h0) as ssd_scan_bf16 takes
// them, dy [b, nh, S, dv] bf16 with its own batch, head and time strides
// (strides: q, k, v, dy, log_a, each as batch, head, time; 15 in all),
// dh_final [b, nh, dk, dv] f32 contiguous; dy or dh may be null (a zero
// cotangent). Writes dq, dk [b, nh, S, dk] and dv [b, nh, S, dv] in bf16,
// dlog_a [b, nh, S] and, unless gh0 is null, dh0 [b, nh, dk, dv] in f32,
// all contiguous. `states` holds 2 b nh ceil(S / 64) 2 64 64 bf16 (dk
// and dv padded to 64). dk, dv multiples of 8 up to 64 (the Mamba2
// scans'; the kernel is built for that one tiling, <64, 64>); q, k, v
// and dy 16-byte aligned, their batch, head and time
// strides multiples of 8. Two launches (one when S = 0); returns
// cudaGetLastError() after the last (0 on success).
int ssd_bwd_bf16(const void* q, const void* k, const void* v, const void* dy,
                 const void* log_a, const void* h0, const void* dh, void* gq,
                 void* gk, void* gv, void* gla, void* gh0, void* states,
                 const long long* strides, int b, int nh, int s, int dk,
                 int dv, void* stream) {
  using bwd::bf16;
  if (b <= 0 || nh <= 0) return 0;
  bool ok = s >= 0 && nh <= 65535 && b <= 65535 && dk > 0 && dv > 0 &&
            dk % 8 == 0 && dv % 8 == 0 && dk <= bwd::kMaxD &&
            dv <= bwd::kMaxD && aligned(q, 16) && aligned(k, 16) &&
            aligned(v, 16) && aligned(dy, 16);
  for (int i = 0; i < 12; ++i) ok = ok && strides[i] % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  bwd::Args g;
  g.q = static_cast<const bf16*>(q);
  g.k = static_cast<const bf16*>(k);
  g.v = static_cast<const bf16*>(v);
  g.dy = static_cast<const bf16*>(dy);
  g.a = static_cast<const float*>(log_a);
  g.h0 = static_cast<const float*>(h0);
  g.dh = static_cast<const float*>(dh);
  g.gq = static_cast<bf16*>(gq);
  g.gk = static_cast<bf16*>(gk);
  g.gv = static_cast<bf16*>(gv);
  g.gla = static_cast<float*>(gla);
  g.gh0 = static_cast<float*>(gh0);
  g.nc = (s + bwd::kC - 1) / bwd::kC;
  for (int i = 0; i < 3; ++i) {
    g.sq[i] = strides[i];
    g.sk[i] = strides[3 + i];
    g.sv[i] = strides[6 + i];
    g.sy[i] = strides[9 + i];
    g.sa[i] = strides[12 + i];
  }
  g.nh = nh;
  g.s = s;
  g.dk = dk;
  g.dv = dv;
  g.hs = static_cast<bf16*>(states);
  g.dhs = g.hs + static_cast<long long>(b) * nh * g.nc * 2 * bwd::kMaxD *
                     bwd::kMaxD;
  return bwd::launch<bwd::kMaxD, bwd::kMaxD>(g, b, stream);
}

}  // extern "C"
