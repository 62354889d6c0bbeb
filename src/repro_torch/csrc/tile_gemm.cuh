// Shared fp32 tile machinery of the optimizer kernels (sm_90a), on CUDA cores.
//
// The Pallas kernels of src/repro/kernels/grassmann.py each sum over a
// sequential minor grid axis into their output block.  CUDA blocks run in no
// order, so here one CTA owns one (kBM x kBN) output tile and walks the whole
// contraction extent K itself: per step it stages a (kBK x kBM) slice of the
// left operand and a (kBK x kBN) slice of the right operand in shared memory
// (widened to fp32 on load, zero outside the matrix, so any ragged shape
// works), and its 256 threads each accumulate an 8 x 8 sub-tile of fp32
// outer products in registers.  No tensor cores: the sums stay plain fp32.
//
// Operands are strided views: element (k, row) of a tile lives at
// p[k * sk + row * sr].  Loads walk the tile along whichever index is
// contiguous in memory, so the same loader reads a row-major gradient and
// the transposed view of one (a canonical w_down) with coalesced loads.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace tile {

constexpr int kBM = 128;             // output tile rows (left operand rows)
constexpr int kBN = 128;             // output tile cols (right operand rows)
constexpr int kBK = 8;               // contraction step staged per iteration
constexpr int kThreads = 256;        // 16 x 16 threads, 8 x 8 outputs each
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kLd = kBM + 4;         // padded smem row: a column of 8 k's hits 8 banks

static_assert(kBM == kBN, "one smem row length serves both operands");
static_assert(kThreads == (kBM / kTM) * (kBN / kTN), "one 8 x 8 sub-tile per thread");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

typedef float Smem[kLd];

// A (K x R) operand as a strided view; stages the tile at (k0, row0).
template <typename T>
struct StridedTile {
  const T* p;
  long long sk, sr;
  int row0, R, K;

  __device__ __forceinline__ void operator()(int k0, Smem* dst) const {
    const int t = threadIdx.x;
    constexpr int kPer = kBK * kBM / kThreads;  // 4 elements per thread
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      int k, row;
      if (sr == 1) {  // rows contiguous: 128 threads span one k
        row = t % kBM;
        k = t / kBM + e * (kThreads / kBM);
      } else {        // k contiguous (or neither): 8 threads span the k extent
        k = t % kBK;
        row = t / kBK + e * (kThreads / kBK);
      }
      const int gk = k0 + k, gr = row0 + row;
      dst[k][row] = (gk < K && gr < R) ? to_f32(p[gk * sk + gr * sr]) : 0.f;
    }
  }
};

// acc[i][j] += sum_k a[k][ty*8+i] * b[k][tx*8+j] over one staged step.
__device__ __forceinline__ void mma_step(const Smem* a, const Smem* b, float acc[kTM][kTN]) {
  const int tx = threadIdx.x % (kBN / kTN);
  const int ty = threadIdx.x / (kBN / kTN);
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    float ra[kTM], rb[kTN];
    const float4 a0 = *reinterpret_cast<const float4*>(&a[k][ty * kTM]);
    const float4 a1 = *reinterpret_cast<const float4*>(&a[k][ty * kTM + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&b[k][tx * kTN]);
    const float4 b1 = *reinterpret_cast<const float4*>(&b[k][tx * kTN + 4]);
    ra[0] = a0.x; ra[1] = a0.y; ra[2] = a0.z; ra[3] = a0.w;
    ra[4] = a1.x; ra[5] = a1.y; ra[6] = a1.z; ra[7] = a1.w;
    rb[0] = b0.x; rb[1] = b0.y; rb[2] = b0.z; rb[3] = b0.w;
    rb[4] = b1.x; rb[5] = b1.y; rb[6] = b1.z; rb[7] = b1.w;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
  }
}

// The whole contraction of one output tile: stage, sync, accumulate, sync.
template <typename LA, typename LB>
__device__ __forceinline__ void gemm(const LA& la, const LB& lb, int K, Smem* as, Smem* bs,
                                     float acc[kTM][kTN]) {
  for (int k0 = 0; k0 < K; k0 += kBK) {
    la(k0, as);
    lb(k0, bs);
    __syncthreads();
    mma_step(as, bs, acc);
    __syncthreads();  // the next step overwrites the staged tiles
  }
}

// This thread's first output row (left side) and column (right side).
__device__ __forceinline__ int row_of_thread() { return (threadIdx.x / (kBN / kTN)) * kTM; }
__device__ __forceinline__ int col_of_thread() { return (threadIdx.x % (kBN / kTN)) * kTN; }

}  // namespace tile
