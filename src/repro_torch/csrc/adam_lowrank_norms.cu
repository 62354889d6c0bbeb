// Low-rank Adam moments, direction and column norms for Hopper (sm_90a),
// plain C entry for ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/grassmann.py:
// `adam_lowrank_norms` (def line 696, pallas_call line 725; body
// `_adam_norms_kernel`, line 672) and `adam_lowrank` (def line 634,
// pallas_call line 657; body `_adam_kernel`, line 620), which is the same
// pass without the two column-norm outputs: one kernel template, its
// norms switched off at compile time (`kNorms`), serves both, chosen by
// the entry from whether it is given norm outputs.  On (r, n)
// fp32 states, per element:
//
//     M' = b1 M + (1 - b1) Gt
//     V' = b2 V + (1 - b2) Gt^2
//     Gto = (M' bc1) / (sqrt(V' bc2) + eps)
//
// and per column j the squared norms sum_r Gt^2 and sum_r Gto^2, which feed
// the recovery scale phi (Eq. 11) and the O(n) Eq. 12 clip.  bc1 and bc2 are
// 1 / (1 - beta^t) with t = step + 1, computed in fp32 by the wrapper as the
// reference does (grassmann.py:713-717).
//
// Design.  The TPU sums the norm rows over r on a sequential grid axis.
// Here one CTA owns 32 columns of one matrix and all of r: its 256 threads
// are 8 row groups of one warp each, a warp reads 32 consecutive columns of
// a row (128 bytes, coalesced), each thread keeps its two column partial
// sums in registers over r / 8 rows, and the 8 partials of each column are
// added in shared memory at the end.  Grid y is the matrix index.
//
// Without the norms the CTA is the same: each thread walks its column over
// r / 8 rows and the shared-memory sums are compiled out.
//
// Bound on this card.  ~14 flops per element against 24 bytes moved (three
// fp32 reads, three fp32 writes): bound by memory, 24 r n bytes / 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kCols = 32;
constexpr int kGroups = 8;
constexpr int kThreads = kCols * kGroups;

template <bool kNorms>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ Gt, const float* __restrict__ M,
            const float* __restrict__ V, float* __restrict__ M1, float* __restrict__ V1,
            float* __restrict__ Gto, float* __restrict__ gtsq, float* __restrict__ gtosq, int r,
            int n, float b1, float omb1, float b2, float omb2, float bc1, float bc2, float eps) {
  __shared__ float red[2][kGroups][kCols];
  const int lane = threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + lane;
  const size_t base = (size_t)blockIdx.y * r * n;
  float s1 = 0.f, s2 = 0.f;
  if (col < n) {
    for (int row = grp; row < r; row += kGroups) {
      const size_t idx = base + (size_t)row * n + col;
      const float g = Gt[idx];
      const float m1 = b1 * M[idx] + omb1 * g;
      const float v1 = b2 * V[idx] + omb2 * g * g;
      const float o = (m1 * bc1) / (sqrtf(v1 * bc2) + eps);
      M1[idx] = m1;
      V1[idx] = v1;
      Gto[idx] = o;
      if constexpr (kNorms) {
        s1 = fmaf(g, g, s1);
        s2 = fmaf(o, o, s2);
      }
    }
  }
  if constexpr (!kNorms) return;
  red[0][grp][lane] = s1;
  red[1][grp][lane] = s2;
  __syncthreads();
  if (grp == 0 && col < n) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      t1 += red[0][g][lane];
      t2 += red[1][g][lane];
    }
    gtsq[(size_t)blockIdx.y * n + col] = t1;
    gtosq[(size_t)blockIdx.y * n + col] = t2;
  }
}

}  // namespace

extern "C" {

// Gt, M, V, M1, V1, Gto: (batch, r, n) fp32 contiguous; gtsq, gtosq:
// (batch, n) fp32, or both null for no norms (`adam_lowrank`).  b1/b2 are
// beta1/beta2, omb1/omb2 are 1 - beta (each rounded once to fp32 by the
// caller), bc1/bc2 the bias-correction reciprocals (1 when bias correction
// is off).  Launches on `stream` and returns the launch's error.
int adam_lowrank_norms_launch(const float* Gt, const float* M, const float* V, float* M1,
                              float* V1, float* Gto, float* gtsq, float* gtosq, int batch, int r,
                              int n, float b1, float omb1, float b2, float omb2, float bc1,
                              float bc2, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || n == 0) return cudaSuccess;
  if (batch > 65535 || (gtsq == nullptr) != (gtosq == nullptr)) return cudaErrorInvalidValue;
  const dim3 grid((n + kCols - 1) / kCols, batch);
  if (gtsq != nullptr)
    adam_kernel<true><<<grid, kThreads, 0, s>>>(Gt, M, V, M1, V1, Gto, gtsq, gtosq, r, n, b1,
                                                omb1, b2, omb2, bc1, bc2, eps);
  else
    adam_kernel<false><<<grid, kThreads, 0, s>>>(Gt, M, V, M1, V1, Gto, nullptr, nullptr, r, n,
                                                 b1, omb1, b2, omb2, bc1, bc2, eps);
  return cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
