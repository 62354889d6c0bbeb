// The tracking step's front end for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `project_tangent_colnorms` of
// src/repro/kernels/grassmann.py (def line 347, pallas_call line 367; body
// `_project_tangent_colnorms_kernel`, line 314):
//
//     A   = S^T G                  (r, n)
//     gsq = ||G_:,j||^2            (n)
//     T   = -2 W + 2 S (S^T W)     (m, r),  W = G A^T
//
// with G (m, n) bf16 or fp32 read in place through strides, S (m, r) fp32.
// S^T W = (S^T G) A^T = A A^T exactly, so T is the tangent of Eq. 4 and
// differs from the project_colnorms + tangent composite only in the order
// of its sums.
//
// The TPU sweeps G's column blocks on a sequential grid axis and keeps full-m
// panels of S, one (m, bn) G block and the (m, r) accumulator W in VMEM.
// The Hopper problem: W alone is m * r * 4 bytes (4 MB at llama-1b's m 2048,
// r 512) against 227 KB of shared memory per CTA, and CTAs run in no order.
//
// Layout: one thread-block cluster per (matrix, 128-column block of r).  Its
// CTAs split m: rank k owns rows [128 k, 128 k + 128), so the cluster holds
// the whole m extent, and each CTA keeps its 128 x 128 slice of the W block
// in registers for the whole sweep over n.  Per 128-column block j of G:
//
//   1. each CTA stages its (128 rows x 128 cols) G tile in shared memory once
//      and, in the clusters of the first r block, sums its column squares;
//   2. each CTA forms its partial A^k = S[rows_k, c]^T G[rows_k, j];
//   3. after a cluster barrier, rank k adds rows [k s, k s + s) of the A tile
//      over the cluster's ranks, in rank order, by distributed shared memory
//      (s = 128 / ranks), and writes them to A (and rank 0 the norms to gsq);
//   4. after a second barrier, each CTA adds G[rows_k, j] A[c, j]^T to its W
//      slice, the G tile again from shared memory: G is read from device
//      memory once per r block, as project_colnorms reads it.
//
// After the sweep comes the tail, T = -2 W + S (2 C) with C = S^T W: for
// fp32 G in the same launch (`tail`: each (r block t) tile of S^T W formed
// the same way, partials per rank reduced in rank order into a scratch
// panel C, then each CTA's rows of T), for bf16 G on the engine after it
// (below).  Every sum has a fixed order: the result is deterministic, with
// no atomics.
//
// The m-limit.  A cluster holds at most kMaxCluster = 16 CTAs on the H100
// (a non-portable size; 8 is the portable one), and each CTA holds 128 rows
// of W, so one launch takes m <= 16 * 128 = 2048 (`tangent_front_max_m`).
// Taller matrices take the project_colnorms + tangent composite, as the
// dispatch in kernels/ops.py does (llama-7b's m = 4096).  The limit comes
// from the register tile and the cluster size, not from the TPU's VMEM
// (whose cap, MAX_FUSED_TANGENT_M, is also 2048 by another reckoning).
// An H100 holds 7 such clusters of 16 at once (112 of 132 SMs; PERF.md),
// so a layer stack runs in waves of 7 clusters.
//
// Bound on this card (H100 80GB HBM3, 700 W power limit): 4 m n r + 4 m
// r^2 operations against ~2 m n bytes of bf16 G: at llama-1b (m 2048, n
// 5461, r 512) ~25 GFLOP over ~42 MB per matrix, bound by operations.  The C entry picks the route by G's dtype,
// never as a fallback:
//
// bf16 G (the llama-1b tracking step, 9 launches): the sweep on the bf16
//   tensor cores (`front_wgmma_kernel`).  G is exact in one bf16 term; S
//   comes split in three exact bf16 terms (hopper_mma.cuh `split_bf16`, a
//   pre-pass into a scratch of at most kScratchBudget bytes, a chunk of the
//   stack at a time), and A, fp32 once summed over the ranks, is split
//   again per n-tile.  Every bf16 x bf16 product is exact in fp32 and no
//   term product is dropped: steps 2 and 4 each run 3 passes (S's or A's
//   three terms against G's one).  Step 2 sums one 128-row slice (3 x 128
//   products) in one wgmma accumulator, and the ranks' slices add in fp32;
//   step 4 starts a fresh accumulator per 128-column n-tile and adds it into
//   the fp32 W in registers (grassmann_project.cu: one accumulator over all
//   of a long sum rounds too coarsely).  Two warpgroups, each 64 rows of the
//   128 x 128 products (m64n128k16 wgmma); no producer warpgroup.  Shared
//   memory, 227 KB of 227: S_k's three terms (96 KB, loaded once by TMA,
//   M-major for step 2), the G tile (32 KB, by TMA where G has a tensor map,
//   else by element loads: llama-1b's w_gate / w_up rows are 10,922 bytes),
//   and one 96 KB region that holds the fp32 partial for steps 2-3 and then
//   A's three terms (K-major) for step 4.  The G tile serves both products
//   in one layout: rows of i with 64 j's a box is step 2's N-major B and
//   step 4's K-major A (a transposed view: rows of j, i's in the box, the
//   other two transpose bits).  Step 3 writes A to device memory and every
//   rank reads the reduced tile back (L2) after the second barrier, so the
//   partial and A's terms may share memory.  What is left per n-tile is a
//   serial chain: two cluster barriers, the L2 round trip of A, and the
//   next G tile's load, which waits for step 4 (no room for a second G
//   buffer).
//   The tail (S^T W, then T: 2 x 1.07 GFLOP a matrix at llama-1b) runs on
//   the engine after the sweep, in the same C call: each CTA writes its W
//   slice (fp32) to the scratch, `split_bf16` splits W, `stw_wgmma_kernel`
//   forms 2C = 2 S^T W over m (S's and W's terms, both fp32 split exactly:
//   the 6 products of order >= 2^-16, fused_update.cu's set) as 2C's three
//   terms, and `front_t_wgmma_kernel` forms T = S (2C) - 2 W (6 products).
//   In the cluster, the CUDA-core tail held every cluster's 16 SMs for
//   ~0.2 ms (PERF.md, H100 80GB HBM3 at 700 W); on the engine it runs on
//   every SM, outside the cluster waves.  Even so the project_colnorms +
//   tangent composite is faster at llama-1b's shapes on that card; the
//   dispatch follows the JAX package's all the same.
//
// fp32 G (an fp32 model): `front_kernel`, all on the CUDA cores: each CTA
//   keeps its W slice as the 8 x 8 per-thread fp32 tile of tile_gemm.cuh,
//   stages the G tile widened to fp32, and every staged product fetches
//   its next step into registers during this one (Panel).  ~139 KB of
//   shared memory.

#include <cooperative_groups.h>

#include "hopper_mma.cuh"
#include "tile_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tile;

constexpr int kMaxCluster = 16;           // CTAs per cluster (non-portable on sm_90)
constexpr int kMaxM = kMaxCluster * kBM;  // rows one launch takes

struct __align__(16) FrontSmem {
  float g[kBM][kLd];      // this rank's G tile (rows i, cols j); after the sweep its W slice
  float part[kBM][kBN];   // this rank's partial A^k or (S^T W)^k tile, read by the cluster
  float as[kBK][kLd];     // staging of the left operand
  float bs[kBK][kLd];     // staging of the right operand
  float sq[kBN];          // this rank's partial column norms
};

// A (K x R) fp32 operand in device memory as a strided view: element (k,
// row) of a tile at p[k * sk + row * sr], scaled by `scale` (1 or an exact
// 2).  fetch() loads this thread's share of the (kBK x 128) step at k0
// into registers and put() stages it, so the next step's loads are in flight
// while this step's products run (one CTA per SM leaves no other CTA to hide
// them).  kFresh: data written earlier in this launch by other CTAs, read
// past L1 (__ldcg).
template <bool kFresh>
struct Panel {
  static constexpr int kPer = kBK * kBM / kThreads;  // 4 elements per thread
  const float* p;
  long long sk, sr;
  int row0, R, K;
  float scale;

  __device__ __forceinline__ void where(int e, int& k, int& row) const {
    const int t = threadIdx.x;
    if (sr == 1) {  // rows contiguous: 128 threads span one k
      row = t % kBM;
      k = t / kBM + e * (kThreads / kBM);
    } else {        // k contiguous (or neither): 8 threads span the k extent
      k = t % kBK;
      row = t / kBK + e * (kThreads / kBK);
    }
  }
  __device__ __forceinline__ void fetch(int k0, float v[kPer]) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int k, row;
      where(e, k, row);
      const int gk = k0 + k, gr = row0 + row;
      const float* q = p + gk * sk + gr * sr;
      v[e] = (gk < K && gr < R) ? scale * (kFresh ? __ldcg(q) : *q) : 0.f;
    }
  }
  __device__ __forceinline__ void put(const float v[kPer], Smem* dst) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int k, row;
      where(e, k, row);
      dst[k][row] = v[e];
    }
  }
};

// The G tile in shared memory as the left operand of G A^T: element (k, i)
// is g[i][k0 + k].
struct GTransposed {
  static constexpr int kPer = kBK * kBM / kThreads;
  const float (*g)[kLd];

  __device__ __forceinline__ void fetch(int k0, float v[kPer]) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      v[e] = g[threadIdx.x / kBK + e * (kThreads / kBK)][k0 + threadIdx.x % kBK];
  }
  __device__ __forceinline__ void put(const float v[kPer], Smem* dst) const {
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      dst[threadIdx.x % kBK][threadIdx.x / kBK + e * (kThreads / kBK)] = v[e];
  }
};

// acc += sum over k < K of left[k][.] x right[k][.], both operands staged
// per kBK step, the next step fetched during this one's products.
template <typename L, typename R>
__device__ __forceinline__ void gemm_pipelined(const L& left, const R& right, int K, Smem* as,
                                               Smem* bs, float acc[kTM][kTN]) {
  float va[L::kPer], vb[R::kPer];
  left.fetch(0, va);
  right.fetch(0, vb);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    left.put(va, as);
    right.put(vb, bs);
    __syncthreads();
    if (k0 + kBK < K) {
      left.fetch(k0 + kBK, va);
      right.fetch(k0 + kBK, vb);
    }
    mma_step(as, bs, acc);
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float acc[kTM][kTN]) {
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
}

// This rank's fp32 G tile, rows [i0, i0 + mr) x cols [j0, j0 + nn), zero beyond.
__device__ __forceinline__ void load_g_tile(const float* G, long long gsm, long long gsn, int i0,
                                            int mr, int j0, int nn, float (*g)[kLd]) {
  const int t = threadIdx.x;
  if (gsn == 1) {  // row-major G: threads along j
    const int j = t % kBN;
    for (int i = t / kBN; i < kBM; i += kThreads / kBN)
      g[i][j] = (i < mr && j < nn) ? G[(long long)(i0 + i) * gsm + j0 + j] : 0.f;
  } else {  // a transposed view: threads along i
    const int i = t % kBM;
    for (int j = t / kBM; j < kBN; j += kThreads / kBM)
      g[i][j] = (i < mr && j < nn)
                    ? G[(long long)(i0 + i) * gsm + (long long)(j0 + j) * gsn]
                    : 0.f;
  }
}

template <int kRow>
__device__ __forceinline__ void store_tile(const float acc[kTM][kTN], float (*dst)[kRow]) {
  const int row = row_of_thread(), col = col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) dst[row + i][col + j] = acc[i][j];
}

// acc += S[rows, t0 : t0 + 128]^T X, X the (mr x 128) panel in sm.g: the
// partial over this rank's rows of an (S^T X) tile.
__device__ __forceinline__ void rank_partial(FrontSmem& sm, const float* Srows, int r, int t0,
                                             int mr, float acc[kTM][kTN]) {
  const Panel<false> left{Srows, r, 1, t0, r, mr, 1.f};  // (k = i, row = c) is S[i, c]
  float v[Panel<false>::kPer];
  left.fetch(0, v);
  for (int k0 = 0; k0 < mr; k0 += kBK) {
    left.put(v, sm.as);
    __syncthreads();
    if (k0 + kBK < mr) left.fetch(k0 + kBK, v);
    mma_step(sm.as, &sm.g[k0], acc);  // the right operand is the panel itself
    __syncthreads();
  }
}

// Sum rows [lo, hi) of the cluster's `part` tiles over ranks 0 .. ranks-1, in
// that order, and hand each total to `put(row, col, value)`.
// The loads from all ranks are issued before the first add.
__device__ __forceinline__ float sum_over_ranks(cg::cluster_group& cluster, float* local,
                                                int ranks) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < ranks ? *cluster.map_shared_rank(local, q) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < ranks) s += v[q];
  return s;
}

template <typename Put>
__device__ __forceinline__ void reduce_slice(cg::cluster_group& cluster, FrontSmem& sm,
                                             int ranks, int lo, int hi, Put put) {
  for (int e = threadIdx.x; e < (hi - lo) * kBN; e += kThreads) {
    const int row = lo + e / kBN, col = e % kBN;
    put(row, col, sum_over_ranks(cluster, &sm.part[row][col], ranks));
  }
}

// After the sweep, with this rank's W slice (rows i, columns c of the r
// block, fp32) in sm.g: the panel C = (S^T W)[:, c block] (partials per rank
// over this rank's rows, reduced in rank order into device memory), then
// this rank's rows of T = -2 W + S (2 C).  Every rank of the cluster calls it.
__device__ void tail(cg::cluster_group& cluster, FrontSmem& sm, const float* Srows, float* Cb,
                     float* Trows, int r, int c0, int mr, int ranks, int lo, int hi) {
  for (int t0 = 0; t0 < r; t0 += kBM) {
    float a[kTM][kTN];
    zero(a);
    rank_partial(sm, Srows, r, t0, mr, a);
    store_tile(a, sm.part);
    cluster.sync();
    reduce_slice(cluster, sm, ranks, lo, hi, [&](int c, int j, float v) {
      if (t0 + c < r) Cb[(size_t)(t0 + c) * kBN + j] = v;
    });
    __threadfence();
    cluster.sync();  // the panel's rows t visible; `part` free again
  }

  // T[rows_k, c-block] = -2 W + S (2 C); no rank reads another's memory now
  float acc[kTM][kTN];
  const int row = row_of_thread(), col = col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = -2.f * sm.g[row + i][col + j];
  __syncthreads();
  // left (k = c', row = i) is S[i0 + i, c']; right (k = c', row = c) is 2 C[c', c]
  gemm_pipelined(Panel<false>{Srows, 1, r, 0, mr, r, 1.f},
                 Panel<true>{Cb, kBN, 1, 0, min(kBN, r - c0), r, 2.f}, r, sm.as, sm.bs, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= mr) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (c0 + col + j < r) Trows[(size_t)(row + i) * r + c0 + col + j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// fp32 G: CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
front_kernel(const float* __restrict__ S, const float* __restrict__ G, float* A, float* gsq,
             float* T, float* C, int m, int n, int r, long long gsb, long long gsm,
             long long gsn, int z0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FrontSmem& sm = *reinterpret_cast<FrontSmem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int b = z0 + blockIdx.z;
  const int c0 = blockIdx.y * kBN;  // this cluster's columns of W and T
  const int i0 = rank * kBM;        // this CTA's rows
  const int mr = min(kBM, m - i0);
  const bool norms = blockIdx.y == 0;
  const float* Srows = S + ((size_t)b * m + i0) * r;
  const float* Gb = G + b * gsb;
  float* Ab = A + (size_t)b * r * n;
  float* Cb = C + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * r * kBN;  // (r, 128) panel
  const int slice = (kBM + ranks - 1) / ranks;  // rows of a reduced tile per rank
  const int lo = min(kBM, rank * slice), hi = min(kBM, lo + slice);

  float w[kTM][kTN];  // W[i0 + i, c0 + c], held across the sweep
  zero(w);
  for (int j0 = 0; j0 < n; j0 += kBN) {
    const int nn = min(kBN, n - j0);
    load_g_tile(Gb, gsm, gsn, i0, mr, j0, nn, sm.g);
    __syncthreads();
    if (norms && threadIdx.x < kBN) {
      float s = 0.f;
      for (int i = 0; i < kBM; ++i) s = fmaf(sm.g[i][threadIdx.x], sm.g[i][threadIdx.x], s);
      sm.sq[threadIdx.x] = s;
    }
    float a[kTM][kTN];
    zero(a);
    rank_partial(sm, Srows, r, c0, mr, a);  // A^k[c, j] over this rank's rows
    store_tile(a, sm.part);
    cluster.sync();
    reduce_slice(cluster, sm, ranks, lo, hi, [&](int c, int j, float v) {
      if (c0 + c < r && j < nn) Ab[(size_t)(c0 + c) * n + j0 + j] = v;
    });
    if (norms && rank == 0 && (int)threadIdx.x < nn)
      gsq[(size_t)b * n + j0 + threadIdx.x] =
          sum_over_ranks(cluster, &sm.sq[threadIdx.x], ranks);
    __threadfence();
    cluster.sync();  // A's columns j visible to the cluster; `part` and `sq` free again
    // W[rows_k, c] += G[rows_k, j] A[c, j]^T: (k = j, row = i) from the G tile,
    // (k = j, row = c) from the A just written
    gemm_pipelined(GTransposed{sm.g}, Panel<true>{Ab + j0, 1, n, c0, r, nn, 1.f}, nn, sm.as,
                   sm.bs, w);
  }
  store_tile(w, sm.g);
  __syncthreads();
  tail(cluster, sm, Srows, Cb, T + ((size_t)b * m + i0) * r, r, c0, mr, ranks, lo, hi);
}

// ---------------------------------------------------------------------------
// bf16 G: the sweep on wgmma
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kThreads = 256;               // two warpgroups; the tail's 256 threads
constexpr int kBox = 128 * 128;             // 128 rows of 128 bytes: one 64-wide swizzled box
constexpr int kTerm = 2 * kBox;             // one 128 x 128 bf16 operand (two boxes)
constexpr int kSOff = 0;                    // S_k's three terms (boxes of 64 c, rows i)
constexpr int kGOff = 3 * kTerm;            // the G tile
constexpr int kPQOff = kGOff + kTerm;       // the fp32 partial, then A's three terms
constexpr int kPLd = 132;                   // padded fp32 row of the partial
constexpr int kSqOff = kPQOff + 3 * kTerm;  // this rank's column-norm partials
constexpr int kBarOff = kSqOff + 4 * 128;   // two mbarriers
constexpr size_t kSmem = 1024 + kBarOff + 16;  // + the 1024-byte alignment of the base
constexpr int kLoadBatch = 32;              // element loads in flight per thread

static_assert(kThreads == tile::kThreads, "the tail runs on the same threads");
static_assert(128 * kPLd * 4 <= 3 * kTerm, "the partial fits A's terms' region");
static_assert(kSmem <= 232448, "one CTA per SM");

// Stage G[rows i0 .., cols j0 ..] of matrix b: kTrans (a transposed view)
// as boxes of 64 i's with rows j, else boxes of 64 j's with rows i.  TMA
// (thread 0, completes on bar) or element loads by every thread (zero past
// mr rows and nn columns; the caller syncs).
template <bool kTrans, bool kTma>
__device__ __forceinline__ void stage_g(const CUtensorMap* g_map, const unsigned short* Gb,
                                        long long gsm, long long gsn, unsigned char* smem,
                                        uint32_t base, uint32_t bar, int b, int i0, int mr,
                                        int j0, int nn) {
  const int tid = threadIdx.x;
  if (kTma) {
    if (tid == 0) {
      hopper::mbar_expect_tx(bar, kTerm);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (kTrans)
          hopper::tma_load(base + kGOff + h * kBox, g_map, bar, i0 + 64 * h, j0, b);
        else
          hopper::tma_load(base + kGOff + h * kBox, g_map, bar, j0 + 64 * h, i0, b);
      }
    }
    return;
  }
  auto at = [&](int idx, int& i, int& j) -> uint32_t {
    if (kTrans) {  // i contiguous in memory and in the box
      j = idx / 128;
      i = idx % 128;
      return (i / 64) * kBox + hopper::swizzle(j * 128 + (i % 64) * 2);
    }
    i = idx / 128;
    j = idx % 128;
    return (j / 64) * kBox + hopper::swizzle(i * 128 + (j % 64) * 2);
  };
#pragma unroll 1
  for (int e0 = 0; e0 < 128 * 128; e0 += kThreads * kLoadBatch) {
    unsigned short v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      int i, j;
      at(e0 + u * kThreads + tid, i, j);
      v[u] = (i < mr && j < nn) ? Gb[(long long)(i0 + i) * gsm + (long long)(j0 + j) * gsn]
                                : (unsigned short)0;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      int i, j;
      *reinterpret_cast<unsigned short*>(smem + kGOff + at(e0 + u * kThreads + tid, i, j)) = v[u];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
}

// Grid (ranks, r blocks, chunk) in clusters of (ranks, 1, 1): matrix z0 +
// blockIdx.z of the stack; S's terms of the chunk at planes 3 blockIdx.z of
// s_map; G by g_map (plane: the stack's matrix) when kTma.
template <bool kTrans, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
front_wgmma_kernel(const __grid_constant__ CUtensorMap s_map,
                   const __grid_constant__ CUtensorMap g_map, const unsigned short* __restrict__ G,
                   float* A, float* gsq, float* __restrict__ W, int m, int n, int r, long long gsb,
                   long long gsm, long long gsn, int z0) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // swizzle atoms: 1024-aligned
  const uint32_t base = hopper::smem_addr(smem);
  float(*part)[kPLd] = reinterpret_cast<float(*)[kPLd]>(smem + kPQOff);
  float* sq = reinterpret_cast<float*>(smem + kSqOff);
  const uint32_t bar_s = base + kBarOff, bar_g = bar_s + 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int bz = blockIdx.z;  // the matrix in this chunk
  const int b = z0 + bz;      // ... and in the stack
  const int c0 = blockIdx.y * 128;
  const int i0 = rank * 128;
  const int mr = min(128, m - i0);
  const bool norms = blockIdx.y == 0;
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const unsigned short* Gb = G + b * gsb;
  float* Ab = A + (size_t)b * r * n;
  const int slice = (128 + ranks - 1) / ranks;  // rows of a reduced tile per rank
  const int lo = min(128, rank * slice), hi = min(128, lo + slice);

  if (tid == 0) {
    hopper::mbar_init(bar_s, 1);
    hopper::mbar_init(bar_g, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {  // S_k's terms: boxes (64 c, 128 i) at (c0 + 64 h, i0)
    hopper::mbar_expect_tx(bar_s, 3 * kTerm);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hopper::tma_load(base + kSOff + t * kTerm + h * kBox, &s_map, bar_s, c0 + 64 * h, i0,
                         3 * bz + t);
  }
  if (n > 0) stage_g<kTrans, kTma>(&g_map, Gb, gsm, gsn, smem, base, bar_g, b, i0, mr, 0,
                                   min(128, n));
  if (!kTma) __syncthreads();
  hopper::mbar_wait(bar_s, 0);

  float w[64];  // W[i0 + 64 wgi + frag_row, c0 + frag_col], held across the sweep
#pragma unroll
  for (int i = 0; i < 64; ++i) w[i] = 0.f;
  float acc[64];
  for (int jt = 0, j0 = 0; j0 < n; ++jt, j0 += 128) {
    const int nn = min(128, n - j0);
    if (kTma) hopper::mbar_wait(bar_g, jt & 1);

    // 2. A^k (c 128 x j 128) = S_k^T G_k over this rank's 128 rows; warpgroup
    //    wgi owns c rows [64 wgi, 64 wgi + 64): S_lo, S_mid, S_hi against G
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // 16 rows of i a step
        const uint64_t da =
            hopper::desc(base + kSOff + (2 - p) * kTerm + wgi * kBox + kk * 2048, kBox, 1024);
        if (kTrans)  // G K-major: rows j, 64 i's a box
          hopper::wgmma_128<0, 1>(
              acc, da, hopper::desc(base + kGOff + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024),
              p != 0 || kk != 0);
        else  // G N-major: boxes of 64 j's, rows i
          hopper::wgmma_128<1, 1>(acc, da, hopper::desc(base + kGOff + kk * 2048, kBox, 1024),
                                  p != 0 || kk != 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // 1. while the tensor cores run: column tid's squares over this rank's rows
    float nsq = 0.f;
    if (norms && tid < 128) {
      if (kTrans) {  // row tid of each box: 8 chunks of 8 i's
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const uint4 q = *reinterpret_cast<const uint4*>(smem + kGOff + h * kBox + tid * 128 +
                                                            ((c ^ (tid & 7)) << 4));
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p2[e]);
              nsq = fmaf(f.x, f.x, nsq);
              nsq = fmaf(f.y, f.y, nsq);
            }
          }
      } else {  // column tid % 64 of box tid / 64, rows 0..127
        const unsigned char* box = smem + kGOff + (tid / 64) * kBox;
#pragma unroll 8
        for (int i = 0; i < 128; ++i) {
          const float g = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              box + hopper::swizzle(i * 128 + (tid % 64) * 2)));
          nsq = fmaf(g, g, nsq);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hopper::fence_operands(acc);
    if (norms && tid < 128) sq[tid] = nsq;
#pragma unroll
    for (int i = 0; i < 64; i += 2)
      *reinterpret_cast<float2*>(&part[64 * wgi + hopper::frag_row(i, tid)]
                                      [hopper::frag_col(i, tid)]) =
          make_float2(acc[i], acc[i + 1]);
    cluster.sync();

    // 3. rows [lo, hi) of the A tile summed over the ranks in rank order
    for (int e = tid; e < (hi - lo) * 128; e += kThreads) {
      const int row = lo + e / 128, col = e % 128;
      const float v = sum_over_ranks(cluster, &part[row][col], ranks);
      if (c0 + row < r && col < nn) Ab[(size_t)(c0 + row) * n + j0 + col] = v;
    }
    if (norms && rank == 0 && tid < nn)
      gsq[(size_t)b * n + j0 + tid] = sum_over_ranks(cluster, &sq[tid], ranks);
    __threadfence();
    cluster.sync();  // A's tile in device memory; no rank reads `part` or `sq` now

    // A's tile back (L2), split in three terms over the partial's memory:
    // K-major rows c, 64 j's a box
#pragma unroll 1
    for (int e0 = 0; e0 < 128 * 128; e0 += kThreads * 16) {
      float x[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * kThreads + tid, c = e / 128, j = e % 128;
        x[u] = (c0 + c < r && j < nn) ? __ldcg(Ab + (size_t)(c0 + c) * n + j0 + j) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int e = e0 + u * kThreads + tid, c = e / 128, j = e % 128;
        __nv_bfloat16 t3[3];
        hopper::split3(x[u], t3[0], t3[1], t3[2]);
        const uint32_t off = kPQOff + (j / 64) * kBox + hopper::swizzle(c * 128 + (j % 64) * 2);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          *reinterpret_cast<__nv_bfloat16*>(smem + off + t * kTerm) = t3[t];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    __syncthreads();

    // 4. W_k (i 128 x c 128) += G_k A^T over this n-tile, a fresh
    //    accumulator added into w; warpgroup wgi owns rows i [64 wgi, +64)
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // 16 columns j a step
        const uint64_t db = hopper::desc(
            base + kPQOff + (2 - p) * kTerm + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024);
        if (kTrans)  // G M-major: box wgi of 64 i's, rows j
          hopper::wgmma_128<0, 1>(
              acc, hopper::desc(base + kGOff + wgi * kBox + kk * 2048, kBox, 1024), db,
              p != 0 || kk != 0);
        else  // G K-major: the warpgroup's 64 rows i, 64 j's a box
          hopper::wgmma_128<0, 0>(
              acc,
              hopper::desc(base + kGOff + (kk / 4) * kBox + wgi * 8192 + (kk % 4) * 32, 16, 1024),
              db, p != 0 || kk != 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hopper::fence_operands(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) w[i] += acc[i];
    __syncthreads();  // the G tile and A's terms are free
    if (j0 + 128 < n) {
      stage_g<kTrans, kTma>(&g_map, Gb, gsm, gsn, smem, base, bar_g, b, i0, mr, j0 + 128,
                            min(128, n - j0 - 128));
      if (!kTma) __syncthreads();
    }
  }

  // this rank's W slice to the chunk's (m, r) scratch: the tail runs on the
  // engine after the sweep (no rank reads another's memory after the last
  // cluster barrier)
  float* Wb = W + ((size_t)bz * m + i0) * r;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = 64 * wgi + hopper::frag_row(i, tid), col = c0 + hopper::frag_col(i, tid);
    if (row >= mr || col >= r) continue;
    if (col + 1 < r)
      hopper::store_pair(Wb, 0, (long long)row * r + col, 1, w[i], w[i + 1]);
    else
      Wb[(size_t)row * r + col] = w[i];
  }
}

// The tail on the engine, over a chunk of matrices (matrix z's terms at
// plane 3 z of each map): C = S^T W, 6 products of S's and W's terms
// (both fp32, split exactly), written as 2C's three bf16 terms; then T =
// -2 W + S (2C), 6 products of S's and 2C's terms.
using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi: the 6 products >= 2^-16
constexpr unsigned kSixPasses = pass(0, 2, 0) | pass(1, 0, 2) | pass(2, 1, 1) | pass(3, 1, 0) |
                                pass(4, 0, 1) | pass(5, 0, 0);
// S^T W: element (k = i, x = c) of S and of W, rows of i with 64 c's a box
using StwEngine = Engine<3, 3, false, false, true, true, kSixPasses, 6>;
// S (2C): S's rows i and 2C's rows c, each of 64 contiguous c''s (K-major)
using ScEngine = Engine<3, 3, true, true, true, true, kSixPasses, 6>;

// Persistent tiles (z, ct, ct') of 2C = 2 S^T W -> c_split (chunk, 3, r,
// r_pad); columns r .. r_pad come out 0 (S's and W's split pads them).
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
stw_wgmma_kernel(const __grid_constant__ CUtensorMap s_mn, const __grid_constant__ CUtensorMap w_mn,
                 __nv_bfloat16* __restrict__ c_split, int m, int r, int r_pad, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int tiles = (r + hopper::kEngM - 1) / hopper::kEngM;
  const long long num_tiles = (long long)tiles * tiles * chunk;
  const int num_k = (m + StwEngine::kDepth - 1) / StwEngine::kDepth;
  if (tid == 0) StwEngine::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int tj = (int)(t % tiles);
    const int ti = (int)(t / tiles % tiles);
    const int z = (int)(t / ((long long)tiles * tiles));
    if (wgi == hopper::kEngConsumers) {
      const Operand a{&s_mn, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      const Operand b{&w_mn, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      StwEngine::produce(sm.smem, sm.base, sm.full, sm.empty, a, b, ti * hopper::kEngM,
                         tj * hopper::kEngN, num_k, tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    float total[64];
    StwEngine::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    const long long plane = (long long)r * r_pad;
    __nv_bfloat16* out = c_split + (long long)z * hopper::kSplitTerms * plane;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int ci = ti * hopper::kEngM + 64 * wgi + hopper::frag_row(i, tid);
      const int cj = tj * hopper::kEngN + hopper::frag_col(i, tid);
      if (ci >= r || cj >= r_pad) continue;
      __nv_bfloat16 hi, mid, lo;
      hopper::split3(2.f * total[i], hi, mid, lo);
      const long long o = (long long)ci * r_pad + cj;
      out[o] = hi;
      out[o + plane] = mid;
      out[o + 2 * plane] = lo;
    }
  }
}

// Persistent tiles (z, i tile, c tile) of T = -2 W + S (2C) for matrices
// z0 .. z0 + chunk - 1 of the stack; W the chunk's (m, r) fp32 scratch.
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
front_t_wgmma_kernel(const __grid_constant__ CUtensorMap s_k, const __grid_constant__ CUtensorMap c_k,
                     const float* __restrict__ W, float* __restrict__ T, int m, int r, int z0,
                     int chunk) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  const int r_tiles = (r + hopper::kEngN - 1) / hopper::kEngN;
  const long long num_tiles = (long long)m_tiles * r_tiles * chunk;
  const int num_k = (r + ScEngine::kDepth - 1) / ScEngine::kDepth;
  if (tid == 0) ScEngine::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int rt = (int)(t % r_tiles);
    const int mt = (int)(t / r_tiles % m_tiles);
    const int z = (int)(t / ((long long)r_tiles * m_tiles));
    const int i0 = mt * hopper::kEngM, c0 = rt * hopper::kEngN;
    if (wgi == hopper::kEngConsumers) {
      const Operand a{&s_k, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      const Operand b{&c_k, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      ScEngine::produce(sm.smem, sm.base, sm.full, sm.empty, a, b, i0, c0, num_k,
                        tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    float total[64];
    ScEngine::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    const float* Wz = W + (size_t)z * m * r;
    float* Tz = T + (size_t)(z0 + z) * m * r;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
      const int gi = i0 + 64 * wgi + hopper::frag_row(i, tid);
      const int gj = c0 + hopper::frag_col(i, tid);
      if (gi >= m || gj >= r) continue;
      const long long at = (long long)gi * r + gj;
      if (gj + 1 < r) {
        const float2 w = hopper::load_pair(Wz, 0, at, 1);
        hopper::store_pair(Tz, 0, at, 1, total[i] - 2.f * w.x, total[i + 1] - 2.f * w.y);
      } else {
        Tz[at] = total[i] - 2.f * Wz[at];
      }
    }
  }
}

}  // namespace wg

constexpr long long kScratchBudget = 256ll << 20;

long long align256(long long v) { return (v + 255) / 256 * 256; }

// The scratch of one launch, per matrix of a chunk.  fp32 G: the panel C
// (fp32 (ceil(r / 128), r, 128)).  bf16 G: S's terms (3, m, r_pad), W (m,
// r) fp32, W's terms (3, m, r_pad) and 2C's (3, r, r_pad).
struct Layout {
  int chunk, r_pad;
  long long part[4];  // bytes per matrix of each part
  long long bytes;

  char* at(char* scratch, int k) const {
    for (int i = 0; i < k; ++i) scratch += align256(chunk * part[i]);
    return scratch;
  }
};

Layout layout(int batch, int m, int r, int dtype) {
  Layout l;
  l.r_pad = hopper::split_r_pad(r);
  const long long terms = 2ll * hopper::kSplitTerms * l.r_pad;
  if (dtype == 1) {
    l.part[0] = terms * m;
    l.part[1] = (long long)sizeof(float) * m * r;
    l.part[2] = terms * m;
    l.part[3] = terms * r;
  } else {
    l.part[0] = (long long)sizeof(float) * ((r + kBN - 1) / kBN) * r * kBN;
    l.part[1] = l.part[2] = l.part[3] = 0;
  }
  const long long per = l.part[0] + l.part[1] + l.part[2] + l.part[3];
  long long c = per > 0 ? kScratchBudget / per : batch;
  c = c < 1 ? 1 : (c > batch ? batch : c);
  l.chunk = (int)c;
  l.bytes = 0;
  for (int i = 0; i < 4; ++i) l.bytes += align256(l.chunk * l.part[i]);
  return l;
}

// The launch of one cluster of ceil(m / 128) CTAs per (matrix, r block),
// and how many such clusters the card holds at once.
template <typename Kernel>
struct FrontLaunch {
  Kernel kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  cudaError_t init(int smem, int chunk, int m, int r, cudaStream_t stream) {
    const int ranks = (m + kBM - 1) / kBM;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (ranks > 8) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cfg.gridDim = dim3(ranks, (r + kBN - 1) / kBN, chunk);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaSuccess;
  }

  cudaError_t active_clusters(int* clusters) {
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }

  // the card holds at least one cluster, or the launch cannot run
  cudaError_t check() {
    int clusters = 0;
    const cudaError_t err = active_clusters(&clusters);
    if (err != cudaSuccess) return err;
    return clusters < 1 ? cudaErrorLaunchOutOfResources : cudaSuccess;
  }
};

template <typename Kernel>
FrontLaunch<Kernel> front_launch(Kernel kernel) {
  FrontLaunch<Kernel> fl;
  fl.kernel = kernel;
  return fl;
}

cudaError_t launch_fp32(const float* S, const void* G, float* A, float* gsq, float* T,
                        char* scratch, int batch, int m, int n, int r, long long gsb,
                        long long gsm, long long gsn, cudaStream_t stream) {
  const Layout l = layout(batch, m, r, 0);
  auto fl = front_launch(front_kernel);
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    cudaError_t err = fl.init((int)sizeof(FrontSmem), chunk, m, r, stream);
    if (err == cudaSuccess) err = fl.check();
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&fl.cfg, front_kernel, S, static_cast<const float*>(G), A, gsq, T,
                               reinterpret_cast<float*>(scratch), m, n, r, gsb, gsm, gsn, z0);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// Routes reported to the caller.
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLoads = 2, kTransposed = 4 };

template <bool kTrans, bool kTma>
cudaError_t launch_wgmma(const CUtensorMap& s_map, const CUtensorMap& g_map, const void* G,
                         float* A, float* gsq, float* W, int chunk, int m, int n, int r,
                         long long gsb, long long gsm, long long gsn, int z0,
                         cudaStream_t stream) {
  auto kernel = wg::front_wgmma_kernel<kTrans, kTma>;
  auto fl = front_launch(kernel);
  cudaError_t err = fl.init((int)wg::kSmem, chunk, m, r, stream);
  if (err == cudaSuccess) err = fl.check();
  if (err != cudaSuccess) return err;
  const unsigned short* g = static_cast<const unsigned short*>(G);
  void* args[] = {const_cast<CUtensorMap*>(&s_map), const_cast<CUtensorMap*>(&g_map),
                  &g, &A, &gsq, &W, &m, &n, &r, &gsb, &gsm, &gsn, &z0};
  return cudaLaunchKernelExC(&fl.cfg, reinterpret_cast<const void*>(kernel), args);
}

// A persistent engine launch of `tiles` tiles, one CTA per SM at most.
template <typename Kernel, typename... Args>
cudaError_t launch_engine(Kernel kernel, long long tiles, cudaStream_t stream, const Args&... args) {
  if (tiles == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  const int grid = (int)(tiles < hopper::num_sms() ? tiles : hopper::num_sms());
  kernel<<<grid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(args...);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const float* S, const void* G, float* A, float* gsq, float* T,
                        char* scratch, int batch, int m, int n, int r, long long gsb,
                        long long gsm, long long gsn, int* route, cudaStream_t stream) {
  // boxes of 64 i's (rows j) for a transposed view, else of 64 j's (rows i)
  const bool trans = gsm == 1 && gsn != 1;
  const bool tma = ((uintptr_t)G % 16 == 0) &&
                   (trans ? hopper::tma_stride_ok(2 * gsn)
                          : gsn == 1 && hopper::tma_stride_ok(2 * gsm)) &&
                   (batch == 1 || hopper::tma_stride_ok(2 * gsb));
  *route = (tma ? kWgmmaTma : kWgmmaLoads) | (trans ? kTransposed : 0);
  const Layout l = layout(batch, m, r, 1);
  const int r_pad = l.r_pad;
  char* s_split = l.at(scratch, 0);
  float* W = reinterpret_cast<float*>(l.at(scratch, 1));
  char* w_split = l.at(scratch, 2);
  char* c_split = l.at(scratch, 3);
  CUtensorMap g_map;
  if (tma) {
    const uint64_t d0 = trans ? m : n, d1 = trans ? n : m;
    const uint64_t s1 = 2ull * (trans ? gsn : gsm);
    const uint64_t s2 = batch == 1 ? (s1 * d1 + 15) / 16 * 16 : 2ull * gsb;
    if (!hopper::make_map(&g_map, G, d0, d1, batch, s1, s2, 128)) return cudaErrorInvalidValue;
  }
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    cudaError_t err = hopper::split_bf16(S + (size_t)z0 * m * r, s_split, chunk, m, r, stream);
    if (err != cudaSuccess) return err;
    // S's terms M-major for step 2: (r_pad, m, 3 chunk), boxes of 64 c x 128 rows
    CUtensorMap s_map;
    if (!hopper::make_map(&s_map, s_split, r_pad, m, 3ull * chunk, 2ull * r_pad,
                          2ull * r_pad * m, 128))
      return cudaErrorInvalidValue;
    if (!tma) g_map = s_map;  // unused by element loads
#define REPRO_FRONT_WG(TR, TM) \
  err = launch_wgmma<TR, TM>(s_map, g_map, G, A, gsq, W, chunk, m, n, r, gsb, gsm, gsn, z0, stream)
    if (trans && tma)
      REPRO_FRONT_WG(true, true);
    else if (trans)
      REPRO_FRONT_WG(true, false);
    else if (tma)
      REPRO_FRONT_WG(false, true);
    else
      REPRO_FRONT_WG(false, false);
#undef REPRO_FRONT_WG
    if (err != cudaSuccess) return err;
    // the tail: W's terms, then 2C = 2 S^T W, then T = -2 W + S (2C)
    err = hopper::split_bf16(W, w_split, chunk, m, r, stream);
    if (err != cudaSuccess) return err;
    CUtensorMap s_mn, w_mn, c_k;  // S, W M-major (boxes 64 x 64); 2C K-major
    if (!hopper::make_map(&s_mn, s_split, r_pad, m, 3ull * chunk, 2ull * r_pad,
                          2ull * r_pad * m, 64) ||
        !hopper::make_map(&w_mn, w_split, r_pad, m, 3ull * chunk, 2ull * r_pad,
                          2ull * r_pad * m, 64) ||
        !hopper::make_map(&c_k, c_split, r_pad, r, 3ull * chunk, 2ull * r_pad,
                          2ull * r_pad * r, 128))
      return cudaErrorInvalidValue;
    const long long r_tiles = (r + hopper::kEngN - 1) / hopper::kEngN;
    const long long m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
    err = launch_engine(wg::stw_wgmma_kernel, r_tiles * r_tiles * chunk, stream, s_mn, w_mn,
                        reinterpret_cast<__nv_bfloat16*>(c_split), m, r, r_pad, chunk);
    if (err != cudaSuccess) return err;
    err = launch_engine(wg::front_t_wgmma_kernel, m_tiles * r_tiles * chunk, stream, s_map, c_k,
                        static_cast<const float*>(W), T, m, r, z0, chunk);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The tallest m one launch takes.
int tangent_front_max_m() { return kMaxM; }

// How many clusters of an m-row launch (bf16 G, the wgmma route) the card
// holds at once, or -1 on an error.
int tangent_front_active_clusters(int m) {
  auto fl = front_launch(wg::front_wgmma_kernel<false, true>);
  int clusters = 0;
  if (m < 1 || m > kMaxM || fl.init((int)wg::kSmem, 1, m, kBN, nullptr) != cudaSuccess ||
      fl.active_clusters(&clusters) != cudaSuccess)
    return -1;
  return clusters;
}

// Bytes of scratch tangent_front_launch needs at these sizes for G of
// `dtype` (0 = float32, 1 = bfloat16).
long long tangent_front_scratch_bytes(int batch, int m, int n, int r, int dtype) {
  (void)n;
  return layout(batch, m, r, dtype).bytes;
}

// S (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; A (batch, r, n), gsq
// (batch, n) and T (batch, m, r) fp32 contiguous; scratch
// tangent_front_scratch_bytes bytes.  m <= tangent_front_max_m().  Writes
// the route taken to *route (0 CUDA cores, 1 wgmma with G by TMA, 2 wgmma
// with G by element loads; + 4 for a transposed view).  Launches on
// `stream` and returns the first launch error.
int tangent_front_launch(const float* S, const void* G, float* A, float* gsq, float* T,
                         void* scratch, int dtype, int batch, int m, int n, int r, long long gsb,
                         long long gsm, long long gsn, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = kCudaCores;
  if (batch == 0 || m == 0 || r == 0) return cudaSuccess;
  if (m > kMaxM || batch > 65535 || r > 65535 * kBN) return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  if (dtype == 0) return launch_fp32(S, G, A, gsq, T, sc, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 1)
    return launch_bf16(S, G, A, gsq, T, sc, batch, m, n, r, gsb, gsm, gsn, route, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
