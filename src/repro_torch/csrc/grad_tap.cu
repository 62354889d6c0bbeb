// grad_tap for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `grad_tap` of src/repro/kernels/grassmann.py
// (def line 406, pallas_call line 429): the grad-fused backward epilogue
//   dW  = x^T dy                (m, n)  written once, in the parameter dtype
//   A   = S^T dW                (r, n)  fp32
//   gsq = sum_i dW[i, :]^2      (n,)    fp32
// from x (b, m) and dy (b, n), any float dtype widened per tile, and the
// basis S (m, r) fp32.  Every sum is fp32; A and gsq come from the fp32 dW,
// never from the rounded copy that is written out.
//
// Design.  The TPU grid is (n/bn, m/bm) and sums A and gsq over its
// sequential minor m axis into one output block, with full-b panels of x
// and dy resident in VMEM.  CUDA blocks run in no order, so the sum over m
// is the design problem.  Two changes remove it:
//
//  * A is reassociated: S^T (x^T dy) = (x S)^T dy.  A first kernel forms
//    P = x S (b, r) in fp32 (contraction over m, one CTA per 128 x 128 tile
//    of P); the A tiles of the second kernel are then plain GEMM tiles
//    A[:, j] = P^T dy[:, j] whose contraction runs over b, not over m.  No
//    CTA needs another's dW, and at b < m the products shrink: 2 b r (m + n)
//    operations instead of 2 r m n (at b = 1024, m = 4096 a quarter).
//  * gsq is summed in two fixed-order stages: each dW tile CTA writes the
//    128 column sums of squares of its fp32 tile to a (m/128, n) partial
//    buffer; the last CTA of a column block to finish (an atomic ticket per
//    column block, after a __threadfence) adds that column block's partials
//    in m order.  The result does not depend on which CTA came last.
//
// The second kernel's grid is (n/128, m/128 + r/128): row y < m/128 is a dW
// tile, the rest are A tiles.  Every tile is one CTA of tile_gemm.cuh (one
// 128 x 128 output tile, the whole contraction walked in the CTA, 8 x 8
// fp32 register tiles per thread), so there is no limit on b: the token
// extent is streamed through shared memory 8 at a time (the TPU's
// MAX_GRAD_TAP_B = 2048 was a VMEM limit).  x, dy and dW are strided views:
// the swapped orientation of a transposed leaf (w_down) writes dW straight
// into the leaf's own layout.
//
// Bound on this card.  At (m, n, b, r) = (4096, 11008, 1024, 1024) with
// bf16 x and dy the function needs 2 b m n = 92 GFLOP for dW, whose bf16 x
// bf16 products are exact in fp32 and run at the 989 TFLOP/s of the bf16
// tensor cores (0.09 ms), and 2 b r (m + n) + 2 m n = 32 GFLOP of fp32 for
// P, A and the norms (0.47 ms at 67 TFLOP/s): bound by operations at about
// 0.57 ms, not by the ~180 MB of operands and outputs (0.05 ms).  This
// kernel runs everything on CUDA cores in fp32, dW included, so it sits
// far above that bound; bf16 tensor cores for dW are the next step.
//
// Scratch.  The caller allocates grad_tap_scratch_bytes(b, m, n, r) bytes
// and passes them in; the kernel carves P, the gsq partials and the
// column-block tickets out of them and zeroes the tickets itself, so only
// this file knows the tile edge.

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
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
xs_kernel(const T* __restrict__ x, const float* __restrict__ S, float* __restrict__ P, int b,
          int m, int r, long long xsb, long long xsm) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int t0 = blockIdx.y * kBM;
  const int c0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
  zero(acc);
  // left: element (k = i, row = t) is x[t, i]; right: (k = i, row = c) is S[i, c]
  gemm(StridedTile<T>{x, xsm, xsb, t0, b, m}, StridedTile<float>{S, r, 1, c0, r, m}, m, as, bs,
       acc);
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
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads, 2)
tap_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ P,
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
  const StridedTile<T> right{dy, dysb, dysn, j0, n, b};  // (k = t, row = j) is dy[t, j]

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
  gemm(StridedTile<T>{x, xsb, xsm, i0, m, b}, right, b, as, bs, acc);
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

// The scratch layout: P (b, r) fp32, then the gsq partials (m_tiles, n)
// fp32, then the tickets (n_tiles,) uint32, each at a 256-byte boundary.
struct Scratch {
  size_t p, part, tickets, bytes;
};

size_t align256(size_t v) { return (v + 255) / 256 * 256; }

Scratch scratch_layout(int b, int m, int n, int r) {
  Scratch s;
  s.p = 0;
  s.part = align256(sizeof(float) * (size_t)b * r);
  s.tickets = s.part + align256(sizeof(float) * (size_t)((m + kBM - 1) / kBM) * n);
  s.bytes = s.tickets + align256(sizeof(unsigned) * (size_t)((n + kBN - 1) / kBN));
  return s;
}

template <typename T, typename TD>
cudaError_t launch(const void* x, const void* dy, const float* S, void* dW, float* tap,
                   char* scratch, int stages, int b, int m, int n, int r, long long xsb,
                   long long xsm, long long dysb, long long dysn, long long dwsm, long long dwsn,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const Scratch lay = scratch_layout(b, m, n, r);
  float* P = reinterpret_cast<float*>(scratch + lay.p);
  if ((stages & 1) && b > 0 && r > 0) {
    const dim3 grid((r + kBN - 1) / kBN, (b + kBM - 1) / kBM);
    xs_kernel<T><<<grid, kThreads, 0, stream>>>(xt, S, P, b, m, r, xsb, xsm);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (!(stages & 2)) return cudaSuccess;
  unsigned* tickets = reinterpret_cast<unsigned*>(scratch + lay.tickets);
  cudaError_t err =
      cudaMemsetAsync(tickets, 0, sizeof(unsigned) * ((n + kBN - 1) / kBN), stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM + (r + kBM - 1) / kBM);
  tap_kernel<T, TD><<<grid, kThreads, 0, stream>>>(
      xt, static_cast<const T*>(dy), P, static_cast<TD*>(dW), tap, tap + (size_t)r * n,
      reinterpret_cast<float*>(scratch + lay.part), tickets, b, m, n, r, xsb, xsm, dysb, dysn,
      dwsm, dwsn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch grad_tap_launch needs at these sizes.
long long grad_tap_scratch_bytes(int b, int m, int n, int r) {
  return (long long)scratch_layout(b, m, n, r).bytes;
}

// x (b, m) with element strides (xsb, xsm) and dy (b, n) with (dysb, dysn),
// both of `dtype` (0 = float32, 1 = bfloat16); S (m, r) fp32 contiguous;
// dW (m, n) of `out_dtype` with element strides (dwsm, dwsn); tap the
// (r + 1, n) fp32 contiguous panel [A; gsq]; scratch grad_tap_scratch_bytes
// bytes.  `stages` 3 runs both kernels on `stream` (P = x S, then the
// tiles); 1 runs only the first, so it can be timed apart.  Returns the
// first launch error.
int grad_tap_launch(const void* x, const void* dy, const float* S, void* dW, float* tap,
                    void* scratch, int dtype, int out_dtype, int stages, int b, int m, int n,
                    int r, long long xsb, long long xsm, long long dysb, long long dysn,
                    long long dwsm, long long dwsn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (m == 0)  // no rows: A and the norms are sums of nothing
    return (stages & 2) ? cudaMemsetAsync(tap, 0, sizeof(float) * (size_t)(r + 1) * n, s)
                        : cudaSuccess;
  if ((m + kBM - 1) / kBM + (r + kBM - 1) / kBM > 65535 || (b + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
#define REPRO_TAP(T, TD)                                                                   \
  return launch<T, TD>(x, dy, S, dW, tap, sc, stages, b, m, n, r, xsb, xsm, dysb, dysn, \
                       dwsm, dwsn, s)
  if (dtype == 0 && out_dtype == 0) REPRO_TAP(float, float);
  if (dtype == 0 && out_dtype == 1) REPRO_TAP(float, __nv_bfloat16);
  if (dtype == 1 && out_dtype == 0) REPRO_TAP(__nv_bfloat16, float);
  if (dtype == 1 && out_dtype == 1) REPRO_TAP(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_TAP
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
