// backproject and recovery for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/grassmann.py, the
// building blocks of the optimizer's unfused schedule
// (core/lowrank_adam.py, lowrank_adam_step with lr=None):
//   backproject  (def line 149, pallas_call line 161): Ghat = S X
//   recovery     (def line 230, pallas_call line 245): Lam = (G - S Gt) * phi
// with S (m, r), X and Gt (r, n), phi (n,), G (m, n) bf16 or fp32 read in
// place through strides; both write an (m, n) fp32 result.  One source
// serves both: `recovery` is `backproject` of Gt with the residual and the
// column scale in the epilogue, selected by the compile-time switch
// kRecovery.
//
// Design.  Each TPU grid cell forms one (bm, r) x (r, bn) product in one
// step; nothing is summed across cells, so the port is a plain tiled
// product: one CTA per (128 m-rows x 128 n-columns) output tile walks the
// whole of r (tile_gemm.cuh), staging S and X / Gt slices in shared memory.
// The recovery epilogue reads G at the tile's elements, widened to fp32,
// and writes (g - s) * phi_j, in the TPU kernel's order of operations.  The
// (m, n) residual never exists apart from the output.  Grid z is the matrix
// index, so one launch covers a layer stack; any shape, ragged tiles masked.
//
// Bound on this card.  2 m n r fp32 flops against 4 m n bytes written (and,
// for recovery, ~2-4 m n read): at llama-1b's (2048, 5461, r 512) ~11.5
// GFLOP over ~60-80 MB per matrix, bound by fp32 operations (~190 flop/byte
// vs the card's 20).  Plain register-tiled SGEMM, no tensor cores.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

template <typename TG, bool kRecovery>
__global__ void __launch_bounds__(kThreads, 2)
backproject_kernel(const float* __restrict__ S, const float* __restrict__ X,
                   const TG* __restrict__ G, const float* __restrict__ phi,
                   float* __restrict__ out, int m, int n, int r, long long gsb, long long gsm,
                   long long gsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // left (k = c, row = i) is S[i, c]; right (k = c, row = j) is X[c, j]
  gemm(StridedTile<float>{S + (size_t)b * m * r, 1, r, i0, m, r},
       StridedTile<float>{X + (size_t)b * r * n, n, 1, j0, n, r}, r, as, bs, acc);

  float* o = out + (size_t)b * m * n;
  const int row = i0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gi = row + i;
    if (gi >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gj = col + j;
      if (gj >= n) break;
      float v = acc[i][j];
      if (kRecovery)
        v = (to_f32(G[b * gsb + gi * gsm + gj * gsn]) - v) * phi[(size_t)b * n + gj];
      o[(size_t)gi * n + gj] = v;
    }
  }
}

template <typename TG, bool kRecovery>
cudaError_t launch(const float* S, const float* X, const void* G, const float* phi, float* out,
                   int batch, int m, int n, int r, long long gsb, long long gsm, long long gsn,
                   cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  backproject_kernel<TG, kRecovery><<<grid, kThreads, 0, stream>>>(
      S, X, static_cast<const TG*>(G), phi, out, m, n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// S (batch, m, r) and X (batch, r, n) fp32 contiguous; out (batch, m, n)
// fp32 contiguous.  recovery == 0: out = S X (G, phi unused, may be NULL).
// recovery == 1: out = (G - S X) * phi[None, :], with X = Gt, phi (batch, n)
// fp32 contiguous and G (batch, m, n) with element strides (gsb, gsm, gsn),
// dtype 0 = float32, 1 = bfloat16.  Launches on `stream` and returns the
// launch's error.
int grassmann_backproject_launch(const float* S, const float* X, const void* G,
                                 const float* phi, float* out, int dtype, int recovery,
                                 int batch, int m, int n, int r, long long gsb, long long gsm,
                                 long long gsn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  if (batch > 65535 || m > 65535 * kBM) return cudaErrorInvalidValue;
  if (!recovery) return launch<float, false>(S, X, G, phi, out, batch, m, n, r, 0, 0, 0, s);
  switch (dtype) {
    case 0:
      return launch<float, true>(S, X, G, phi, out, batch, m, n, r, gsb, gsm, gsn, s);
    case 1:
      return launch<__nv_bfloat16, true>(S, X, G, phi, out, batch, m, n, r, gsb, gsm, gsn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
