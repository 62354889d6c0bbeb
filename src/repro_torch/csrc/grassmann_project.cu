// project and project_colnorms for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/grassmann.py:
//   project           (def line 117, pallas_call line 130): A = S^T G
//   project_colnorms  (def line 274, pallas_call line 290): A and ||G_:,j||^2
// One source serves both: `project` is `project_colnorms` without its norm
// row, selected by the compile-time switch kNorms.
//
// Design.  The TPU walks m on a sequential grid axis and accumulates the
// (r, bn) output block in VMEM.  Here A^T = G^T S is an fp32 GEMM of shape
// (n, m) x (m, r): one CTA owns one (128 r-rows x 128 n-columns) tile of A
// and loops over all of m itself (tile_gemm.cuh), staging S and G slices in
// shared memory and widening G (bf16 or fp32) to fp32 on load.  With the
// norm switch on, the launch has one more row of CTAs, each of which sums
// g^2 down 128 columns of G and does nothing else, so the GEMM CTAs keep
// a loop free of the norm work (folded into the first r-tile's GEMM loop,
// the norms made the launch 1.47x as long as `project`'s on an H100 at
// 700 W, timed by chip_smoke.py; PERF.md).  The extra read of G is one
// more pass on top of the r / 128 passes the GEMM tiles make through L2
// anyway.  Grid z is the matrix index, so one launch covers a whole layer
// stack.  G is a strided view (batch, row and column strides), so the
// transposed canonical view of w_down or embed is read in place; S and A
// are contiguous.
//
// Bound on this card.  At the paper's llama-7b rank (r = 1024, m = 4096),
// 2 r m n flops against ~2 m n bytes of a bf16 G is ~1000 flop/byte, far
// above the H100's fp32 balance (67 TFLOP/s / 3.35 TB/s = 20 flop/byte): the
// kernel is bound by fp32 operations, not by the gradient stream (the
// "memory-bound at r << m" premise of the TPU docstring does not hold at
// r = 1024).  This first version is a plain register-tiled SGEMM without
// double buffering or tensor cores; TF32 / split-bf16 wgmma is later work.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

// sum_i G[i, j]^2 for the 128 columns from j0: two row groups of 128
// threads, one column per thread, added in shared memory at the end.
template <typename TG>
__device__ void column_norms(const TG* __restrict__ G, long long gsm, long long gsn, int m, int n,
                             int j0, float* __restrict__ gsq) {
  __shared__ float red[kThreads / kBN][kBN];
  const int c = threadIdx.x % kBN;
  const int grp = threadIdx.x / kBN;
  float sq = 0.f;
  if (j0 + c < n) {
    const TG* col = G + (long long)(j0 + c) * gsn;
    for (int i = grp; i < m; i += kThreads / kBN) {
      const float g = to_f32(col[i * gsm]);
      sq = fmaf(g, g, sq);
    }
  }
  red[grp][c] = sq;
  __syncthreads();
  if (grp == 0 && j0 + c < n) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kThreads / kBN; ++g) total += red[g][c];
    gsq[j0 + c] = total;
  }
}

template <typename TG, bool kNorms>
__global__ void __launch_bounds__(kThreads, 2)
project_kernel(const float* __restrict__ S, const TG* __restrict__ G, float* __restrict__ A,
               float* __restrict__ gsq, int m, int n, int r, long long gsb, long long gsm,
               long long gsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kBN;
  if (kNorms && blockIdx.y == gridDim.y - 1) {  // the norm row of CTAs
    column_norms(G + b * gsb, gsm, gsn, m, n, j0, gsq + (size_t)b * n);
    return;
  }
  const int r0 = blockIdx.y * kBM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // left operand S^T: element (k = i, row = c) is S[i, c]; right operand G:
  // element (k = i, row = j) is G[i, j]
  gemm(StridedTile<float>{S + (size_t)b * m * r, r, 1, r0, r, m},
       StridedTile<TG>{G + b * gsb, gsm, gsn, j0, n, m}, m, as, bs, acc);

  float* out = A + (size_t)b * r * n;
  const int row = r0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= r) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < n) out[(size_t)(row + i) * n + col + j] = acc[i][j];
  }
}

template <typename TG, bool kNorms>
cudaError_t launch(const float* S, const void* G, float* A, float* gsq, int batch, int m, int n,
                   int r, long long gsb, long long gsm, long long gsn, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (r + kBM - 1) / kBM + (kNorms ? 1 : 0), batch);
  project_kernel<TG, kNorms><<<grid, kThreads, 0, stream>>>(
      S, static_cast<const TG*>(G), A, gsq, m, n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// S (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; A (batch, r, n) fp32
// contiguous; gsq (batch, n) fp32 or NULL when norms == 0.  Launches on
// `stream` and returns the launch's error.
int grassmann_project_launch(const float* S, const void* G, float* A, float* gsq, int dtype,
                             int norms, int batch, int m, int n, int r, long long gsb,
                             long long gsm, long long gsn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || n == 0 || r == 0) return cudaSuccess;
  if (batch > 65535 || r > 65534 * kBM) return cudaErrorInvalidValue;
  if (dtype == 0 && norms) return launch<float, true>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 0) return launch<float, false>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 1 && norms)
    return launch<__nv_bfloat16, true>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 1) return launch<__nv_bfloat16, false>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
