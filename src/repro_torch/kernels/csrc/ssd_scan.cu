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

}  // extern "C"
