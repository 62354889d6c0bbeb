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
// Design: one thread-block cluster per (matrix, 128-column block of r).  Its
// CTAs split m: rank k owns rows [128 k, 128 k + 128), so the cluster holds
// the whole m extent, and each CTA keeps its 128 x 128 slice of the W block
// in registers (the 8 x 8 per-thread accumulator of tile_gemm.cuh) for the
// whole sweep over n.  Per 128-column block j of G:
//
//   1. each CTA stages its (128 rows x 128 cols) G tile in shared memory once
//      (widened to fp32) and, in the clusters of the first r block, sums its
//      column squares;
//   2. each CTA forms its partial A^k = S[rows_k, c]^T G[rows_k, j] from that
//      tile and leaves it in shared memory;
//   3. after a cluster barrier, rank k adds rows [k s, k s + s) of the A tile
//      over the cluster's ranks, in rank order, by distributed shared memory
//      (s = 128 / ranks), and writes them to A (and rank 0 the norms to gsq);
//   4. after a second barrier, each CTA adds G[rows_k, j] A[c, j]^T to its W
//      slice, the G tile again from shared memory: G is read from device
//      memory once per r block, as project_colnorms reads it.
//
// After the sweep, each (r block t) tile of S^T W is formed the same way
// (partials per rank, reduced in rank order into a scratch panel C), and
// each CTA writes its rows of T = -2 W + S (2 C).  Every sum has a fixed
// order: the result is deterministic, with no atomics.
//
// The m-limit.  A cluster holds at most kMaxCluster = 16 CTAs on the H100
// (a non-portable size; 8 is the portable one), and each CTA holds 128 rows
// of W, so one launch takes m <= 16 * 128 = 2048 (`tangent_front_max_m`).
// Taller matrices take the project_colnorms + tangent composite, as the
// dispatch in kernels/ops.py does (llama-7b's m = 4096).  The limit comes
// from the register tile and the cluster size, not from the TPU's VMEM
// (whose cap, MAX_FUSED_TANGENT_M, is also 2048 by another reckoning).
// Shared memory per CTA: the G / W tile, the partial tile, two staging
// buffers and the norm partials, ~139 KB, so one CTA per SM.
//
// Bound on this card.  4 m n r + 4 m r^2 fp32 flops against ~2 m n bytes
// of bf16 G: at llama-1b (m 2048, n 5461, r 512) ~25 GFLOP over ~42 MB per
// matrix, bound by fp32 operations (~600 flop/byte vs the card's 20).
// CUDA cores only, no tensor cores.  With one CTA per SM no second CTA
// hides a step's global loads, so every staged product fetches its next
// step into registers during this one (Panel); the cluster sums issue all
// ranks' loads before the first add.  What is left: an H100 holds 7 such
// clusters of 16 at once (112 of 132 SMs, timed by chip_smoke.py; PERF.md),
// so a layer stack runs in waves of 7 clusters.

#include <cooperative_groups.h>

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

// This rank's G tile, rows [i0, i0 + mr) x cols [j0, j0 + nn), zero beyond.
template <typename TG>
__device__ __forceinline__ void load_g_tile(const TG* G, long long gsm, long long gsn, int i0,
                                            int mr, int j0, int nn, float (*g)[kLd]) {
  const int t = threadIdx.x;
  if (gsn == 1) {  // row-major G: threads along j
    const int j = t % kBN;
    for (int i = t / kBN; i < kBM; i += kThreads / kBN)
      g[i][j] = (i < mr && j < nn) ? to_f32(G[(long long)(i0 + i) * gsm + j0 + j]) : 0.f;
  } else {  // a transposed view: threads along i
    const int i = t % kBM;
    for (int j = t / kBM; j < kBN; j += kThreads / kBM)
      g[i][j] = (i < mr && j < nn)
                    ? to_f32(G[(long long)(i0 + i) * gsm + (long long)(j0 + j) * gsn])
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

template <typename TG>
__global__ void __launch_bounds__(kThreads, 1)
front_kernel(const float* __restrict__ S, const TG* __restrict__ G, float* A, float* gsq,
             float* T, float* C, int m, int n, int r, long long gsb, long long gsm,
             long long gsn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FrontSmem& sm = *reinterpret_cast<FrontSmem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * kBN;  // this cluster's columns of W and T
  const int i0 = rank * kBM;        // this CTA's rows
  const int mr = min(kBM, m - i0);
  const bool norms = blockIdx.y == 0;
  const float* Sb = S + (size_t)b * m * r;
  const float* Srows = Sb + (size_t)i0 * r;
  const TG* Gb = G + b * gsb;
  float* Ab = A + (size_t)b * r * n;
  float* Cb = C + ((size_t)b * gridDim.y + blockIdx.y) * r * kBN;  // (r, 128) panel
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

  // (S^T W)[:, c-block] into the panel C, one 128-row tile t at a time;
  // this rank's W slice goes to shared memory as the right operand
  store_tile(w, sm.g);
  __syncthreads();
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
  float* Tb = T + (size_t)b * m * r;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= mr) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (c0 + col + j < r) Tb[(size_t)(i0 + row + i) * r + c0 + col + j] = acc[i][j];
  }
}

// The launch of one cluster of ceil(m / 128) CTAs per (matrix, r block),
// and how many such clusters the card holds at once.
struct FrontLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];

  template <typename TG>
  cudaError_t init(int batch, int m, int r, cudaStream_t stream) {
    const int ranks = (m + kBM - 1) / kBM;
    const int smem = (int)sizeof(FrontSmem);
    cudaError_t err = cudaFuncSetAttribute(front_kernel<TG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (ranks > 8) {
      err = cudaFuncSetAttribute(front_kernel<TG>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cfg.gridDim = dim3(ranks, (r + kBN - 1) / kBN, batch);
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

  template <typename TG>
  cudaError_t active_clusters(int* clusters) {
    return cudaOccupancyMaxActiveClusters(clusters, front_kernel<TG>, &cfg);
  }
};

template <typename TG>
cudaError_t launch(const float* S, const void* G, float* A, float* gsq, float* T, float* C,
                   int batch, int m, int n, int r, long long gsb, long long gsm, long long gsn,
                   cudaStream_t stream) {
  FrontLaunch fl;
  cudaError_t err = fl.init<TG>(batch, m, r, stream);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = fl.active_clusters<TG>(&clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // the card cannot hold one cluster
  err = cudaLaunchKernelEx(&fl.cfg, front_kernel<TG>, S, static_cast<const TG*>(G), A, gsq, T,
                           C, m, n, r, gsb, gsm, gsn);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The tallest m one launch takes.
int tangent_front_max_m() { return kMaxM; }

// How many clusters of an m-row launch (bf16 G) the card holds at once, or
// -1 on an error.
int tangent_front_active_clusters(int m) {
  FrontLaunch fl;
  int clusters = 0;
  if (m < 1 || m > kMaxM || fl.init<__nv_bfloat16>(1, m, kBN, nullptr) != cudaSuccess ||
      fl.active_clusters<__nv_bfloat16>(&clusters) != cudaSuccess)
    return -1;
  return clusters;
}

// Bytes of the scratch panel C (fp32 (batch, ceil(r / 128), r, 128)).
long long tangent_front_scratch_bytes(int batch, int m, int n, int r) {
  (void)m;
  (void)n;
  return (long long)sizeof(float) * batch * ((r + kBN - 1) / kBN) * r * kBN;
}

// S (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; A (batch, r, n), gsq
// (batch, n) and T (batch, m, r) fp32 contiguous; C the scratch of
// tangent_front_scratch_bytes.  m <= tangent_front_max_m().  Launches on
// `stream` and returns the launch's error.
int tangent_front_launch(const float* S, const void* G, float* A, float* gsq, float* T,
                         float* C, int dtype, int batch, int m, int n, int r, long long gsb,
                         long long gsm, long long gsn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m == 0 || r == 0) return cudaSuccess;
  if (m > kMaxM || batch > 65535 || r > 65535 * kBN) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(S, G, A, gsq, T, C, batch, m, n, r, gsb, gsm, gsn, s);
    case 1:
      return launch<__nv_bfloat16>(S, G, A, gsq, T, C, batch, m, n, r, gsb, gsm, gsn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
