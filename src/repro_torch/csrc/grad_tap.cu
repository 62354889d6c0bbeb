// grad_tap for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `grad_tap` of src/repro/kernels/grassmann.py
// (def line 406, pallas_call line 429): the grad-fused backward epilogue
//   dW  = x^T dy                (m, n)  written once, in the parameter dtype
//   A   = S^T dW                (r, n)  fp32
//   gsq = sum_i dW[i, :]^2      (n,)    fp32
// from x (b, m) and dy (b, n), any float dtype, and the basis S (m, r)
// fp32.  Every sum is fp32; A and gsq come from the fp32 dW, never from the
// rounded copy that is written out.
//
// Design.  The TPU grid is (n/bn, m/bm) and sums A and gsq over its
// sequential minor m axis into one output block, with full-b panels of x
// and dy resident in VMEM.  CUDA blocks run in no order, so the sum over m
// is the design problem.  Two changes remove it:
//
//  * A is reassociated: S^T (x^T dy) = (x S)^T dy.  P = x S (b, r) is formed
//    first (contraction over m); the A tiles are then plain product tiles
//    A[:, j] = P^T dy[:, j] whose contraction runs over b, not over m.  No
//    CTA needs another's dW, and at b < m the products shrink: 2 b r (m + n)
//    operations instead of 2 r m n (at b = 1024, m = 4096 a quarter).
//  * gsq is summed in two fixed-order stages: each dW tile CTA writes the
//    128 column sums of squares of its fp32 tile to a (m/128, n) partial
//    buffer; the last CTA of a column block to finish (an atomic ticket per
//    column block, after a __threadfence) adds that column block's partials
//    in m order.  The result does not depend on which CTA came last.
//
// Bound on this card.  At (m, n, b, r) = (4096, 11008, 1024, 1024) the
// function needs 2 b m n = 92 GFLOP for dW and 2 b r (m + n) = 32 GFLOP for
// P and A: bound by operations, not by the ~180 MB of operands and outputs
// (0.05 ms).  Two routes, by the dtype of x and dy:
//
// bf16 x and dy (the training path): tensor cores (hopper_mma.cuh's
//   Engine: 128 x 128 output tiles, two consumer warpgroups, a producer
//   warpgroup, a fresh wgmma accumulator per k-tile flushed into fp32
//   totals).  Three products, each a contraction over the leading axis of
//   two row-major operands:
//   - P^T = S^T x^T (r, b): S split into three exact bf16 terms (the
//     `split_bf16_kernel` pre-pass), 3 passes; x^T is x staged K-major.  The
//     epilogue splits each fp32 entry of P again and writes the three bf16
//     terms as (3, b, r_pad), the M-major operand of the A tiles;
//   - dW = x^T dy (m, n): bf16 x bf16 is exact, 1 pass over 128-deep
//     k-tiles; x M-major, dy N-major.  The epilogue stores dW (strided, so
//     the swapped orientation of a transposed leaf writes the leaf's own
//     layout) and the gsq partials from the fp32 totals;
//   - A = P^T dy (r, n): 3 passes over P's terms.
//   The P tiles, (r/128) x (b/128) = 64 at b = r = 1024, would fill half
//   the SMs alone, and a dW tile is a twelfth of a P tile's work, so both
//   share one persistent launch (one CTA per SM, one ring: a P stage and a
//   dW stage are both 64 KB) whose CTAs take tiles from a counter in device
//   memory, P tiles first: the CTAs that run P tiles take fewer dW tiles.
//   The A tiles follow in a second persistent launch.  x and dy come by TMA
//   where they have a tensor map (unit column stride, 16-byte aligned base
//   and row stride), otherwise by the producer warpgroup's element loads
//   into the same layouts.
// fp32 x and dy: CUDA cores (tile_gemm.cuh), not exact in bf16: one CTA
//   per 128 x 128 tile of P (first kernel), then per tile of dW or A (one
//   grid), each walking its whole contraction in 8 x 8 fp32 register tiles.
//
// Scratch.  The caller allocates grad_tap_scratch_bytes(b, m, n, r, dtype)
// bytes and passes them in; the launch carves P (fp32, or S's and P's bf16
// terms), the gsq partials and the column-block tickets out of them and
// zeroes the tickets itself, so only this file knows the tile edge.

#include "hopper_mma.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tile;

__device__ __forceinline__ void zero(float acc[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
}

// P (b, r) = x (b, m) S (m, r), fp32, contiguous.
__global__ void __launch_bounds__(kThreads, 2)
xs_kernel(const float* __restrict__ x, const float* __restrict__ S, float* __restrict__ P, int b,
          int m, int r, long long xsb, long long xsm) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int t0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  zero(acc);
  // left: element (k = i, row = t) is x[t, i]; right: (k = i, row = c) is S[i, c]
  gemm(StridedTile<float>{x, xsm, xsb, t0, b, m}, StridedTile<float>{S, r, 1, c0, r, m}, m, as,
       bs, acc);
  const int row = t0 + row_of_thread();
  const int col = c0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= b) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < r) P[(size_t)(row + i) * r + col + j] = acc[i][j];
  }
}

// dW tiles (blockIdx.y < m_tiles) and A tiles (the rest) of one column block.
template <typename TD>
__global__ void __launch_bounds__(kThreads, 2)
tap_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ P,
           TD* __restrict__ dW, float* __restrict__ A, float* __restrict__ gsq,
           float* __restrict__ part, unsigned* __restrict__ tickets, int b, int m, int n, int r,
           long long xsb, long long xsm, long long dysb, long long dysn, long long dwsm,
           long long dwsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  __shared__ float red[kBM / kTM][kBN];
  __shared__ bool last;
  const int m_tiles = (m + kBM - 1) / kBM;
  const int j0 = blockIdx.x * kBN;
  const bool is_dw = blockIdx.y < m_tiles;
  const int i0 = (is_dw ? blockIdx.y : blockIdx.y - m_tiles) * kBM;
  const StridedTile<float> right{dy, dysb, dysn, j0, n, b};  // (k = t, row = j) is dy[t, j]

  float acc[kTM][kTN];
  zero(acc);
  const int row = i0 + row_of_thread();
  const int col = j0 + col_of_thread();
  if (!is_dw) {
    // A[c, j] = sum_t P[t, c] dy[t, j]
    gemm(StridedTile<float>{P, r, 1, i0, r, b}, right, b, as, bs, acc);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (row + i >= r) break;
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (col + j < n) A[(size_t)(row + i) * n + col + j] = acc[i][j];
    }
    return;
  }

  // dW[i, j] = sum_t x[t, i] dy[t, j]; rows past m are zero (masked loads)
  gemm(StridedTile<float>{x, xsb, xsm, i0, m, b}, right, b, as, bs, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= m) break;
    TD* out = dW + (long long)(row + i) * dwsm;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < n) out[(long long)(col + j) * dwsn] = from_f32<TD>(acc[i][j]);
  }
  // this tile's column sums of squares of the fp32 dW
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) sq = fmaf(acc[i][j], acc[i][j], sq);
    red[ty][col_of_thread() + j] = sq;
  }
  __syncthreads();
  if (threadIdx.x < kBN && j0 + threadIdx.x < n) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kBM / kTM; ++g) s += red[g][threadIdx.x];
    part[(size_t)blockIdx.y * n + j0 + threadIdx.x] = s;
  }
  // the last dW tile of this column block adds the partials in m order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[blockIdx.x], 1u) == (unsigned)(m_tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x < kBN && j0 + threadIdx.x < n) {
    float s = 0.f;
    for (int t = 0; t < m_tiles; ++t) s += __ldcg(&part[(size_t)t * n + j0 + threadIdx.x]);
    gsq[j0 + threadIdx.x] = s;
  }
}

// The scratch layout, each part at a 256-byte boundary.  fp32 route: P
// (b, r) fp32; bf16 route: S's terms (3, m, r_pad) and P's (3, b, r_pad)
// bf16.  Then the gsq partials (m_tiles, n) fp32 and the tickets (n_tiles,)
// uint32.
struct Scratch {
  size_t s_split, p, part, tickets, bytes;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

Scratch scratch_layout(int b, int m, int n, int r, int dtype) {
  Scratch s;
  const size_t r_pad = hopper::split_r_pad(r);
  s.s_split = 0;
  s.p = dtype ? align256(2 * hopper::kSplitTerms * (size_t)m * r_pad) : 0;
  s.part = s.p + align256(dtype ? 2 * hopper::kSplitTerms * (size_t)b * r_pad
                                : sizeof(float) * (size_t)b * r);
  s.tickets = s.part + align256(sizeof(float) * (size_t)((m + kBM - 1) / kBM) * n);
  // the bf16 route's tile counter, then the tickets
  s.bytes = s.tickets + align256(sizeof(unsigned) * (size_t)(1 + (n + kBN - 1) / kBN));
  return s;
}

template <typename TD>
cudaError_t launch(const void* x, const void* dy, const float* S, void* dW, float* tap,
                   char* scratch, int stages, int b, int m, int n, int r, long long xsb,
                   long long xsm, long long dysb, long long dysn, long long dwsm, long long dwsn,
                   cudaStream_t stream) {
  const float* xt = static_cast<const float*>(x);
  const Scratch lay = scratch_layout(b, m, n, r, 0);
  float* P = reinterpret_cast<float*>(scratch + lay.p);
  if ((stages & 1) && b > 0 && r > 0) {
    const dim3 grid((r + kBN - 1) / kBN, (b + kBM - 1) / kBM);
    xs_kernel<<<grid, kThreads, 0, stream>>>(xt, S, P, b, m, r, xsb, xsm);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 2)) return cudaSuccess;
  unsigned* tickets = reinterpret_cast<unsigned*>(scratch + lay.tickets);
  cudaError_t err =
      cudaMemsetAsync(tickets, 0, sizeof(unsigned) * ((n + kBN - 1) / kBN), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM + (r + kBM - 1) / kBM);
  tap_kernel<TD><<<grid, kThreads, 0, stream>>>(
      xt, static_cast<const float*>(dy), P, static_cast<TD*>(dW), tap, tap + (size_t)r * n,
      reinterpret_cast<float*>(scratch + lay.part), tickets, b, m, n, r, xsb, xsm, dysb, dysn,
      dwsm, dwsn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 x and dy: the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// lo.x, mid.x, hi.x: three terms of S (or P) against one of x (or dy)
constexpr unsigned kSplitPasses = pass(0, 2, 0) | pass(1, 1, 0) | pass(2, 0, 0);
// P^T = S^T x^T: S's terms M-major (TMA), x K-major; 64-deep k-tiles of
// 64 KB.  dW = x^T dy: x M-major, dy N-major, one exact pass; 128-deep
// k-tiles, so a stage is 64 KB too and both share one ring of 3 stages.
// kAll: every producer thread arrives (one of x, dy by element loads).
template <bool kTmaX, bool kAll>
using PEngine = Engine<3, 1, false, true, true, kTmaX, kSplitPasses, 3, 64, kAll>;
template <bool kTmaX, bool kTmaDy, bool kAll>
using DwEngine = Engine<1, 1, false, false, kTmaX, kTmaDy, pass(0, 0, 0), 1, 128, kAll>;
// A = P^T dy: P's terms M-major (TMA), dy N-major
template <bool kTmaDy>
using AEngine = Engine<3, 1, false, false, true, kTmaDy, kSplitPasses, 3>;

// TMA boxes: s, p (64, 64); x_k (64, 128) K-major; x_m, dy (64, 128) for
// the 128-deep dW tiles; dy_a (64, 64) for the A tiles
struct Maps {
  CUtensorMap s, p, x_k, x_m, dy, dy_a;
};

// The operands of one call.  x: element (t, i) at x[t * xsb + i * xsm];
// dy: (t, j) at dy[t * dysb + j * dysn].
struct TapArgs {
  const unsigned short* x;
  const unsigned short* dy;
  long long xsb, xsm, dysb, dysn;
  int b, m, n, r, r_pad;
};

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Launch 1, persistent: the P tiles ((r tile, b tile), num_p of them) and
// then, with the dW half, the dW tiles ((m tile, n tile)), handed out in
// that order by a tile counter in device memory, so the P tiles start
// first and the CTAs that run them take fewer dW tiles.  The producer
// warpgroup takes a CTA's next tile and writes its index into the slot of
// its first stage (a negative index ends the CTA); the consumers read it
// once that stage is full.  A P tile writes P's three bf16 terms; a dW
// tile writes dW and its gsq partials, and the last dW tile of a column
// block adds them.
template <bool kTmaX, bool kTmaDy>
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
tap_p_dw_kernel(const __grid_constant__ Maps maps, TapArgs a, __nv_bfloat16* __restrict__ p_split,
                void* dW, int dw_dtype, long long dwsm, long long dwsn, float* __restrict__ gsq,
                float* __restrict__ part, unsigned* __restrict__ tickets,
                unsigned* __restrict__ counter, int num_p, int num_tiles) {
  constexpr bool kAll = !kTmaX || !kTmaDy;
  using PE = PEngine<kTmaX, kAll>;
  using DE = DwEngine<kTmaX, kTmaDy, kAll>;
  static_assert(PE::kStage == DE::kStage && PE::kStages == DE::kStages, "one ring");
  constexpr int kStages = PE::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[4 * hopper::kEngConsumers][hopper::kEngN];  // per warp
  __shared__ int slot[kStages];
  __shared__ int next[2];
  __shared__ int last;
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int r_tiles = (a.r + hopper::kEngM - 1) / hopper::kEngM;
  const int m_tiles = (a.m + hopper::kEngM - 1) / hopper::kEngM;
  const int num_k_p = (a.m + PE::kDepth - 1) / PE::kDepth;
  // at least one k-tile: with b = 0 it stages zeros and the tile writes 0
  const int num_k_dw = a.b > 0 ? (a.b + DE::kDepth - 1) / DE::kDepth : 1;

  if (tid == 0) PE::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;  // k-tiles through the ring so far

  if (wgi == hopper::kEngConsumers) {
    const int pt = tid - 128 * hopper::kEngConsumers;
    if (!kAll && pt != 0) return;
    for (int c = 0;; ++c) {
      if (pt == 0) next[c & 1] = c == 0 ? blockIdx.x : gridDim.x + atomicAdd(counter, 1u);
      if (kAll) producers_sync();
      const int t = next[c & 1];
      const int s = it % kStages;
      if (pt == 0) {
        hopper::mbar_wait(sm.empty + 8 * s, ((it / kStages) & 1) ^ 1);
        slot[s] = t < num_tiles ? t : -1;
      }
      if (t >= num_tiles) {  // the end: an empty stage whose slot says so
        if (pt == 0) hopper::mbar_expect_tx(sm.full + 8 * s, 0);
        if (kAll) hopper::mbar_arrive(sm.full + 8 * s);
        return;
      }
      if (t < num_p) {
        const int r0 = (t % r_tiles) * hopper::kEngM;
        const int t0 = (t / r_tiles) * hopper::kEngN;
        // x^T: element (k = i, x = t) at x[t * xsb + i * xsm]
        const Operand s_op{&maps.s, 0, nullptr, 0, 0, 0, 0};
        const Operand x_op{&maps.x_k, 0, a.x, a.xsm, a.xsb, a.m, a.b};
        PE::produce(sm.smem, sm.base, sm.full, sm.empty, s_op, x_op, r0, t0, num_k_p, pt, it);
      } else {
        const int dt = t - num_p;
        // x: element (k = t, x = i); dy: (k = t, x = j)
        const Operand x_op{&maps.x_m, 0, a.x, a.xsb, a.xsm, a.b, a.m};
        const Operand dy_op{&maps.dy, 0, a.dy, a.dysb, a.dysn, a.b, a.n};
        DE::produce(sm.smem, sm.base, sm.full, sm.empty, x_op, dy_op,
                    (dt % m_tiles) * hopper::kEngM, (dt / m_tiles) * hopper::kEngN, num_k_dw,
                    pt, it);
      }
    }
  }

  const int lane = tid % 32;
  const int warp = tid / 32;  // 0..7 over both consumer warpgroups
  for (;;) {
    const int s = it % kStages;
    hopper::mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
    const int t = slot[s];
    if (t < 0) return;
    float total[64];
    if (t < num_p) {
      const int r0 = (t % r_tiles) * hopper::kEngM;
      const int t0 = (t / r_tiles) * hopper::kEngN;
      PE::consume(total, sm.base, sm.full, sm.empty, num_k_p, wgi, it);
      // P^T[c, t] -> the terms of P[t, c] at (term, t, c) of (3, b, r_pad)
      const long long plane = (long long)a.b * a.r_pad;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int c = r0 + 64 * wgi + hopper::frag_row(i, tid);
        const int tk = t0 + hopper::frag_col(i, tid);
        if (c >= a.r_pad || tk >= a.b) continue;
        __nv_bfloat16 hi, mid, lo;
        hopper::split3(total[i], hi, mid, lo);
        const long long o = (long long)tk * a.r_pad + c;
        p_split[o] = hi;
        p_split[o + plane] = mid;
        p_split[o + 2 * plane] = lo;
      }
      continue;
    }
    const int dt = t - num_p;
    const int mt = dt % m_tiles;  // consecutive tiles share dy's column block
    const int nt = dt / m_tiles;
    const int i0 = mt * hopper::kEngM;
    const int j0 = nt * hopper::kEngN;
    DE::consume(total, sm.base, sm.full, sm.empty, num_k_dw, wgi, it);
    const int row0 = i0 + 64 * wgi;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
      const int gi = row0 + hopper::frag_row(i, tid);
      const int gj = j0 + hopper::frag_col(i, tid);
      if (gi >= a.m || gj >= a.n) continue;
      const long long at = gi * dwsm + gj * dwsn;
      if (gj + 1 < a.n)
        hopper::store_pair(dW, dw_dtype, at, dwsn, total[i], total[i + 1]);
      else
        hopper::store_float(dW, dw_dtype, at, total[i]);
    }
    // this tile's column sums of squares of the fp32 dW (rows past m are
    // 0): per thread its two rows of each of its 32 columns, then the 8
    // lanes that share a column, then the 8 warps in shared memory, all in
    // a fixed order
#pragma unroll
    for (int q = 0; q < 16; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sq = total[4 * q + e] * total[4 * q + e] +
                   total[4 * q + 2 + e] * total[4 * q + 2 + e];
        sq += __shfl_xor_sync(0xffffffffu, sq, 4);
        sq += __shfl_xor_sync(0xffffffffu, sq, 8);
        sq += __shfl_xor_sync(0xffffffffu, sq, 16);
        if (lane < 4) red[warp][8 * q + 2 * lane + e] = sq;
      }
    }
    hopper::consumers_sync();
    if (tid < hopper::kEngN && j0 + tid < a.n) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4 * hopper::kEngConsumers; ++w) sum += red[w][tid];
      part[(size_t)mt * a.n + j0 + tid] = sum;
    }
    // the last dW tile of this column block adds the partials in m order
    __threadfence();
    hopper::consumers_sync();
    if (tid == 0) last = atomicAdd(&tickets[nt], 1u) == (unsigned)(m_tiles - 1);
    hopper::consumers_sync();
    if (last) {
      __threadfence();
      if (tid < hopper::kEngN && j0 + tid < a.n) {
        float sum = 0.f;
        for (int k = 0; k < m_tiles; ++k) sum += __ldcg(&part[(size_t)k * a.n + j0 + tid]);
        gsq[j0 + tid] = sum;
      }
    }
  }
}

// Launch 2, persistent: the A tiles ((r tile, n tile), r tile fastest),
// A = P^T dy from P's terms; CTA blockIdx.x walks tiles blockIdx.x,
// + gridDim.x, ...
template <bool kTmaDy>
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
tap_a_kernel(const __grid_constant__ Maps maps, TapArgs a, float* __restrict__ A) {
  using AE = AEngine<kTmaDy>;
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int r_tiles = (a.r + hopper::kEngM - 1) / hopper::kEngM;
  const int num_tiles = r_tiles * ((a.n + hopper::kEngN - 1) / hopper::kEngN);
  const int num_k = (a.b + AE::kDepth - 1) / AE::kDepth;
  if (tid == 0) AE::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int r0 = (t % r_tiles) * hopper::kEngM;
    const int j0 = (t / r_tiles) * hopper::kEngN;
    if (wgi == hopper::kEngConsumers) {
      const Operand p_op{&maps.p, 0, nullptr, 0, 0, 0, 0};
      const Operand dy_op{&maps.dy_a, 0, a.dy, a.dysb, a.dysn, a.b, a.n};
      AE::produce(sm.smem, sm.base, sm.full, sm.empty, p_op, dy_op, r0, j0, num_k,
                  tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    float total[64];
    AE::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    const int row0 = r0 + 64 * wgi;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int c = row0 + hopper::frag_row(i, tid);
      const int j = j0 + hopper::frag_col(i, tid);
      if (c >= a.r || j >= a.n) continue;
      if (j + 1 < a.n)
        hopper::store_pair(A, 0, (long long)c * a.n + j, 1, total[i], total[i + 1]);
      else
        A[(size_t)c * a.n + j] = total[i];
    }
  }
}

// a 2-D row-major bf16 map over (d0 contiguous, d1) with a box (64, box1)
bool map2(CUtensorMap* map, const void* p, uint64_t d0, uint64_t d1, long long row_elems,
          uint32_t box1) {
  const uint64_t s1 = d1 == 1 ? (2ull * d0 + 15) / 16 * 16 : 2ull * row_elems;
  return hopper::make_map(map, p, d0, d1, 1, s1, (s1 * d1 + 15) / 16 * 16, box1);
}

// TMA needs a unit inner stride, a 16-byte aligned base and row stride
bool tma_ok(const void* p, long long inner, long long row, int rows) {
  return p != nullptr && inner == 1 && (uintptr_t)p % 16 == 0 &&
         (rows == 1 || hopper::tma_stride_ok(2 * row));
}

template <bool kTmaX, bool kTmaDy>
cudaError_t launch_wgmma(const Maps& maps, const TapArgs& a, __nv_bfloat16* p_split, void* dW,
                         int dw_dtype, long long dwsm, long long dwsn, float* tap, float* part,
                         unsigned* tickets, unsigned* counter, int stages, cudaStream_t stream) {
  const int r_tiles = (a.r + hopper::kEngM - 1) / hopper::kEngM;
  const long long num_p =
      (stages & 1) ? (long long)r_tiles * ((a.b + hopper::kEngN - 1) / hopper::kEngN) : 0;
  const long long num_dw = (stages & 2) ? (long long)((a.m + hopper::kEngM - 1) / hopper::kEngM) *
                                              ((a.n + hopper::kEngN - 1) / hopper::kEngN)
                                        : 0;
  const long long num_tiles = num_p + num_dw;
  if (num_tiles > 0x7fffffffll - 2 * hopper::num_sms()) return cudaErrorInvalidValue;
  if (num_tiles > 0) {
    auto k1 = tap_p_dw_kernel<kTmaX, kTmaDy>;
    cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)hopper::kEngSmem);
    if (err != cudaSuccess) return err;
    const int grid = (int)(num_tiles < hopper::num_sms() ? num_tiles : hopper::num_sms());
    k1<<<grid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(
        maps, a, p_split, dW, dw_dtype, dwsm, dwsn, tap + (size_t)a.r * a.n, part, tickets,
        counter, (int)num_p, (int)num_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 2) || a.r == 0) return cudaSuccess;
  if (a.b == 0)  // A is a sum over no tokens
    return cudaMemsetAsync(tap, 0, sizeof(float) * (size_t)a.r * a.n, stream);
  auto k2 = tap_a_kernel<kTmaDy>;
  cudaError_t err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  const long long num_a = (long long)r_tiles * ((a.n + hopper::kEngN - 1) / hopper::kEngN);
  const int grid = (int)(num_a < hopper::num_sms() ? num_a : hopper::num_sms());
  k2<<<grid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(maps, a, tap);
  return cudaGetLastError();
}

// Routes reported to the caller.
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLoads = 2 };

cudaError_t launch_bf16(const void* x, const void* dy, const float* S, void* dW, float* tap,
                        char* scratch, int out_dtype, int stages, int b, int m, int n, int r,
                        long long xsb, long long xsm, long long dysb, long long dysn,
                        long long dwsm, long long dwsn, int* route, cudaStream_t stream) {
  const Scratch lay = scratch_layout(b, m, n, r, 1);
  TapArgs a{static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(dy), xsb,
            xsm, dysb, dysn, b, m, n, r, hopper::split_r_pad(r)};
  const bool tma_x = b > 0 && tma_ok(x, xsm, xsb, b);
  const bool tma_dy = b > 0 && tma_ok(dy, dysn, dysb, b);
  *route = (tma_x && tma_dy) ? kWgmmaTma : kWgmmaLoads;
  __nv_bfloat16* s_split = reinterpret_cast<__nv_bfloat16*>(scratch + lay.s_split);
  __nv_bfloat16* p_split = reinterpret_cast<__nv_bfloat16*>(scratch + lay.p);
  // the tile counter, then the column-block tickets
  cudaError_t err = cudaMemsetAsync(scratch + lay.tickets, 0,
                                    sizeof(unsigned) * (1 + (n + kBN - 1) / kBN), stream);
  if (err != cudaSuccess) return err;
  if (stages & 1) {
    err = hopper::split_bf16(S, s_split, 1, m, r, stream);
    if (err != cudaSuccess) return err;
  }
  // an empty extent (r = 0, b = 0) maps a dummy one that no k-tile reads
  const uint64_t rp = a.r_pad ? a.r_pad : 64, bb = b ? b : 1;
  Maps maps;
  if (!hopper::make_map(&maps.s, s_split, rp, m, hopper::kSplitTerms, 2ull * rp, 2ull * rp * m,
                        64) ||
      !hopper::make_map(&maps.p, p_split, rp, bb, hopper::kSplitTerms, 2ull * rp, 2ull * rp * bb,
                        64))
    return cudaErrorInvalidValue;
  maps.x_k = maps.x_m = maps.dy = maps.dy_a = maps.s;  // unused by element loads
  if (tma_x && !(map2(&maps.x_k, x, m, b, xsb, 128) && map2(&maps.x_m, x, m, b, xsb, 128)))
    return cudaErrorInvalidValue;
  if (tma_dy && !(map2(&maps.dy, dy, n, b, dysb, 128) && map2(&maps.dy_a, dy, n, b, dysb, 64)))
    return cudaErrorInvalidValue;
  float* part = reinterpret_cast<float*>(scratch + lay.part);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + lay.tickets);
#define REPRO_TAP_WG(TX, TDY)                                                                   \
  return launch_wgmma<TX, TDY>(maps, a, p_split, dW, out_dtype, dwsm, dwsn, tap, part,          \
                               counter + 1, counter, stages, stream)
  if (tma_x && tma_dy) REPRO_TAP_WG(true, true);
  if (tma_x) REPRO_TAP_WG(true, false);
  if (tma_dy) REPRO_TAP_WG(false, true);
  REPRO_TAP_WG(false, false);
#undef REPRO_TAP_WG
}

}  // namespace wg

}  // namespace

extern "C" {

// Bytes of scratch grad_tap_launch needs at these sizes, for x/dy of
// `dtype` (0 = float32, 1 = bfloat16).
long long grad_tap_scratch_bytes(int b, int m, int n, int r, int dtype) {
  return (long long)scratch_layout(b, m, n, r, dtype).bytes;
}

// x (b, m) with element strides (xsb, xsm) and dy (b, n) with (dysb, dysn),
// both of `dtype` (0 = float32, 1 = bfloat16); S (m, r) fp32 contiguous;
// dW (m, n) of `out_dtype` with element strides (dwsm, dwsn); tap the
// (r + 1, n) fp32 contiguous panel [A; gsq]; scratch grad_tap_scratch_bytes
// bytes.  `stages` 3 runs the whole function on `stream`; 1 runs only
// P = x S, so it can be timed apart (bf16: S's split and the P tiles).
// Writes the route taken to *route (0 CUDA cores, 1 wgmma with TMA for x
// and dy, 2 wgmma with element loads for one of them).  Returns the first
// launch error.
int grad_tap_launch(const void* x, const void* dy, const float* S, void* dW, float* tap,
                    void* scratch, int dtype, int out_dtype, int stages, int b, int m, int n,
                    int r, long long xsb, long long xsm, long long dysb, long long dysn,
                    long long dwsm, long long dwsn, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = wg::kCudaCores;
  if (n == 0) return cudaSuccess;
  if (m == 0)  // no rows: A and the norms are sums of nothing
    return (stages & 2) ? cudaMemsetAsync(tap, 0, sizeof(float) * (size_t)(r + 1) * n, s)
                        : cudaSuccess;
  if ((m + kBM - 1) / kBM + (r + kBM - 1) / kBM > 65535 || (b + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if ((dtype != 0 && dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  if (dtype == 1)
    return wg::launch_bf16(x, dy, S, dW, tap, sc, out_dtype, stages, b, m, n, r, xsb, xsm, dysb,
                           dysn, dwsm, dwsn, route, s);
  if (out_dtype == 0)
    return launch<float>(x, dy, S, dW, tap, sc, stages, b, m, n, r, xsb, xsm, dysb, dysn, dwsm,
                         dwsn, s);
  return launch<__nv_bfloat16>(x, dy, S, dW, tap, sc, stages, b, m, n, r, xsb, xsm, dysb, dysn,
                               dwsm, dwsn, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
