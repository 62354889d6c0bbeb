// The gram schedule's cross-row statistics for Hopper (sm_90a), plain C
// entry for ctypes.
//
// Replaces the Pallas TPU kernel `tangent_gram` of
// src/repro/kernels/grassmann.py (def line 479, pallas_call line 505; body
// `_tangent_gram_kernel`, line 450):
//
//     TtG = T^T G (r, n),  StT = S^T T,  TtT = T^T T,  StS = S^T S (r, r)
//
// with S, T (m, r) fp32 and G (m, n) bf16 or fp32, all outputs fp32.  These
// are the sums over rows that the gram tracking schedule needs after the
// tangent (core/subspace.py `_track_gram_schedule`): every one contracts
// over m, so row shards can add them with one collective.
//
// Design.  The TPU sums T^T G over a sequential m grid axis and adds the
// three Grams only on its first column sweep (j == 0), so that later column
// blocks do not add them again.  CUDA blocks run in no order, so here every
// CTA owns one 128 x 128 output tile, of T^T G or of one of the three Grams,
// and walks the whole m extent itself (tile_gemm.cuh): no sum crosses CTAs,
// no Gram is added once per column block, and the result does not depend on
// the schedule (deterministic, no atomics).  T^T T and S^T S are symmetric:
// only their tiles on and above the diagonal are computed, and an
// off-diagonal tile is stored twice, as itself and mirrored, so both
// triangles hold the same bits.  Grid x enumerates the tiles: first the
// ceil(r/128) x ceil(n/128) tiles of T^T G, then the ceil(r/128)^2 tiles of
// S^T T, then the ceil(r/128) (ceil(r/128) + 1) / 2 upper tiles of T^T T and
// of S^T S; grid z is the matrix index.  G is a strided view (a transposed
// canonical gradient is read in place); S and T are contiguous.  Ragged
// tiles are masked by the loader, so any (m, n, r) works.
//
// Bound on this card.  2 m r n + 2 m r^2 + 2 m r (r + 1) fp32 flops (the
// two symmetric Grams need only their upper triangles) against ~2 m n bytes
// of bf16 G (+ 8 m r of S and T): at r = 1024 bound by fp32 operations (the
// card does ~20 fp32 flops per byte it reads, this needs ~1000).  Plain
// register-tiled SGEMM on CUDA cores, as the other tracking kernels.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

__device__ __forceinline__ void store_tile(float* out, int rows, int cols, int ld, int i0, int j0,
                                           const float acc[kTM][kTN]) {
  const int row = i0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= rows) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < cols) out[(size_t)(row + i) * ld + col + j] = acc[i][j];
  }
}

// the tile at (i0, j0) of a symmetric (r, r) output, written at (j0, i0)
__device__ __forceinline__ void store_tile_mirrored(float* out, int r, int i0, int j0,
                                                    const float acc[kTM][kTN]) {
  const int row = i0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    if (col + j >= r) break;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      if (row + i < r) out[(size_t)(col + j) * r + row + i] = acc[i][j];
  }
}

template <typename TG>
__global__ void __launch_bounds__(kThreads, 2)
tangent_gram_kernel(const float* __restrict__ S, const float* __restrict__ T,
                    const TG* __restrict__ G, float* __restrict__ TtG, float* __restrict__ StT,
                    float* __restrict__ TtT, float* __restrict__ StS, int m, int n, int r,
                    long long gsb, long long gsm, long long gsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int tiles_r = (r + kBM - 1) / kBM;
  const int tiles_n = (n + kBN - 1) / kBN;
  const float* Sb = S + (size_t)b * m * r;
  const float* Tb = T + (size_t)b * m * r;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  int t = blockIdx.x;
  if (t < tiles_r * tiles_n) {
    // T^T G: left (k = i, row = c) is T[i, c]; right (k = i, row = j) is G[i, j]
    const int c0 = (t / tiles_n) * kBM;
    const int j0 = (t % tiles_n) * kBN;
    gemm(StridedTile<float>{Tb, r, 1, c0, r, m},
         StridedTile<TG>{G + b * gsb, gsm, gsn, j0, n, m}, m, as, bs, acc);
    store_tile(TtG + (size_t)b * r * n, r, n, n, c0, j0, acc);
    return;
  }
  // a Gram X^T Y: left (k = i, row = a) is X[i, a]; right (k = i, row = c)
  // is Y[i, c]
  t -= tiles_r * tiles_n;
  int which, a, c;  // 0 S^T T (every tile), 1 T^T T, 2 S^T S (tiles a <= c)
  if (t < tiles_r * tiles_r) {
    which = 0;
    a = t / tiles_r;
    c = t % tiles_r;
  } else {
    t -= tiles_r * tiles_r;
    const int upper = tiles_r * (tiles_r + 1) / 2;
    which = 1 + t / upper;
    t %= upper;
    for (a = 0; t >= tiles_r - a; ++a) t -= tiles_r - a;
    c = a + t;
  }
  const int a0 = a * kBM;
  const int c0 = c * kBN;
  const float* X = which == 1 ? Tb : Sb;
  const float* Y = which == 2 ? Sb : Tb;
  float* out = (which == 0 ? StT : which == 1 ? TtT : StS) + (size_t)b * r * r;
  gemm(StridedTile<float>{X, r, 1, a0, r, m}, StridedTile<float>{Y, r, 1, c0, r, m}, m, as, bs,
       acc);
  store_tile(out, r, r, r, a0, c0, acc);
  if (which != 0 && a != c) store_tile_mirrored(out, r, a0, c0, acc);
}

template <typename TG>
cudaError_t launch(const float* S, const float* T, const void* G, float* TtG, float* StT,
                   float* TtT, float* StS, int batch, int m, int n, int r, long long gsb,
                   long long gsm, long long gsn, cudaStream_t stream) {
  const long long tiles_r = (r + kBM - 1) / kBM;
  const long long tiles =
      tiles_r * ((n + kBN - 1) / kBN) + tiles_r * tiles_r + tiles_r * (tiles_r + 1);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, batch);
  tangent_gram_kernel<TG><<<grid, kThreads, 0, stream>>>(
      S, T, static_cast<const TG*>(G), TtG, StT, TtT, StS, m, n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// S, T (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; TtG (batch, r, n) and
// StT, TtT, StS (batch, r, r) fp32 contiguous.  Launches on `stream` and
// returns the launch's error.
int grassmann_tangent_gram_launch(const float* S, const float* T, const void* G, float* TtG,
                                  float* StT, float* TtT, float* StS, int dtype, int batch, int m,
                                  int n, int r, long long gsb, long long gsm, long long gsn,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || r == 0) return cudaSuccess;
  if (batch > 65535) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(S, T, G, TtG, StT, TtT, StS, batch, m, n, r, gsb, gsm, gsn, s);
    case 1:
      return launch<__nv_bfloat16>(S, T, G, TtG, StT, TtT, StS, batch, m, n, r, gsb, gsm, gsn, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
