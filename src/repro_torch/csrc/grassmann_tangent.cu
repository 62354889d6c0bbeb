// Grassmann tangent for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `tangent` of src/repro/kernels/grassmann.py
// (def line 192, pallas_call line 206; body `_tangent_kernel`, line 174):
//
//     T = -2 G A^T + 2 S C,   C = A A^T (r x r, formed before the launch)
//
// with G (m, n) bf16 or fp32, A (r, n), S (m, r) -> T (m, r) fp32.  The
// (m, n) residual G - S A is never formed.
//
// Design.  The TPU accumulates over n on a sequential grid axis, seeding its
// output block with 2 S C on the first step.  Here one CTA owns one
// (128 m-rows x 128 r-columns) tile of T and runs two contractions in turn
// (tile_gemm.cuh): first W = sum_j G[i, j] A[c, j] over all n, then it
// scales W by -2 (exact) and accumulates S (2C) over r on top, with 2C
// formed by the wrapper (a power-of-two scale, so 2 (S C) and S (2C) round
// alike).  Grid z is the matrix index.  G is a strided view, so a transposed
// canonical gradient is read in place; A, S and C are contiguous.
//
// Bound on this card.  2 r m n + 2 m r^2 fp32 flops against ~2 m n bytes of
// bf16 G: at r = 1024 this is bound by fp32 operations (~1000 flop/byte vs
// the card's 20).  Plain register-tiled SGEMM, no tensor cores yet.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

template <typename TG>
__global__ void __launch_bounds__(kThreads, 2)
tangent_kernel(const TG* __restrict__ G, const float* __restrict__ A,
               const float* __restrict__ S, const float* __restrict__ C2, float* __restrict__ T,
               int m, int n, int r, long long gsb, long long gsm, long long gsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // W = G A^T: left (k = j, row = i) is G[i, j]; right (k = j, row = c) is A[c, j]
  gemm(StridedTile<TG>{G + b * gsb, gsn, gsm, i0, m, n},
       StridedTile<float>{A + (size_t)b * r * n, 1, n, c0, r, n}, n, as, bs, acc);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] *= -2.f;
  // + S (2C): left (k, row = i) is S[i, k]; right (k, row = c) is C2[k, c]
  gemm(StridedTile<float>{S + (size_t)b * m * r, 1, r, i0, m, r},
       StridedTile<float>{C2 + (size_t)b * r * r, r, 1, c0, r, r}, r, as, bs, acc);

  float* out = T + (size_t)b * m * r;
  const int row = i0 + row_of_thread();
  const int col = c0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < r) out[(size_t)(row + i) * r + col + j] = acc[i][j];
  }
}

template <typename TG>
cudaError_t launch(const void* G, const float* A, const float* S, const float* C2, float* T,
                   int batch, int m, int n, int r, long long gsb, long long gsm, long long gsn,
                   cudaStream_t stream) {
  const dim3 grid((r + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  tangent_kernel<TG><<<grid, kThreads, 0, stream>>>(static_cast<const TG*>(G), A, S, C2, T, m,
                                                    n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// G (batch, m, n) with element strides (gsb, gsm, gsn), dtype 0 = float32,
// 1 = bfloat16; A (batch, r, n), S (batch, m, r), C2 = 2 A A^T (batch, r, r)
// and T (batch, m, r), all fp32 contiguous.  Launches on `stream` and
// returns the launch's error.
int grassmann_tangent_launch(const void* G, const float* A, const float* S, const float* C2,
                             float* T, int dtype, int batch, int m, int n, int r, long long gsb,
                             long long gsm, long long gsn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m == 0 || r == 0) return cudaSuccess;
  if (batch > 65535 || m > 65535 * kBM) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(G, A, S, C2, T, batch, m, n, r, gsb, gsm, gsn, s);
    case 1:
      return launch<__nv_bfloat16>(G, A, S, C2, T, batch, m, n, r, gsb, gsm, gsn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
