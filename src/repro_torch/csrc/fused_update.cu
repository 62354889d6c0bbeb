// Fused low-rank update epilogue for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `fused_update` of
// src/repro/kernels/grassmann.py (def line 558, pallas_call line 610; body
// `_fused_update_kernel`, line 522), all four variants (recovery x decay):
//
//     upd = -coef * (S Gto + (G - S Gt) * phi * clip)  [- wd * param]
//
// written once, in the parameter dtype.  The no-recovery variant
// (upd = -coef * S Gto) never reads G, Gt or phi.
//
// Design.  The TPU forms two (bm, r) x (r, bn) products per tile, S Gto and
// S Gt.  Both have the left factor S, so here they are one product with the
// right factor D = Gto - (phi * clip) Gt formed while its (r, 128) slice is
// staged in shared memory:
//
//     S Gto + (G - S Gt) phi clip  =  S D + G phi clip
//
// which halves the fp32 operations; the rounding error is of the same order
// (each term of the right side is one the TPU form also rounds).  One CTA
// owns one (128 m-rows x 128 n-columns) output tile (tile_gemm.cuh) and
// loops over r; the epilogue adds G * phi * clip, scales by -coef, subtracts
// wd * param and narrows to the parameter dtype.  coef, clip and wd are
// per-matrix scalars read from a (batch, 3) array in device memory: under a
// batched launch each matrix of a layer stack has its own Eq. 12 clip.  G,
// the parameter and the output are strided views, so a transposed canonical
// leaf (w_down, embed) is read and written in place, in the parameter's own
// layout; S, Gt, Gto and phi are contiguous.
//
// Bound on this card.  2 r m n fp32 flops (as computed here) against ~6 m n
// bytes (bf16 G and param read, bf16 update written): ~340 flop/byte at
// r = 1024, bound by fp32 operations.  Plain register-tiled SGEMM, no tensor
// cores yet.

#include "tile_gemm.cuh"

namespace {

using namespace tile;

// Right operand D[k, j] = Gto[k, j] - phic[j] * Gt[k, j] (or Gto alone);
// Gto and Gt are contiguous (r, n), so rows (j) are contiguous.
template <bool kRecovery>
struct DirectionTile {
  const float* gto;
  const float* gt;
  float phic;  // phi[j] * clip of this thread's staged column j
  int j0, n, r;

  __device__ __forceinline__ void operator()(int k0, Smem* dst) const {
    const int t = threadIdx.x;
    const int j = t % kBN;
    constexpr int kPer = kBK * kBN / kThreads;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int k = t / kBN + e * (kThreads / kBN);
      const int gk = k0 + k, gj = j0 + j;
      float v = 0.f;
      if (gk < r && gj < n) {
        const size_t idx = (size_t)gk * n + gj;
        v = gto[idx];
        if (kRecovery) v -= phic * gt[idx];
      }
      dst[k][j] = v;
    }
  }
};

template <typename TG, typename TO, bool kRecovery, bool kDecay>
__global__ void __launch_bounds__(kThreads, 2)
fused_update_kernel(const float* __restrict__ S, const float* __restrict__ Gto,
                    const float* __restrict__ Gt, const float* __restrict__ phi,
                    const float* __restrict__ scalars, const TG* __restrict__ G, long long gsb,
                    long long gsm, long long gsn, const TO* __restrict__ P, long long psb,
                    long long psm, long long psn, TO* __restrict__ out, long long osb,
                    long long osm, long long osn, int m, int n, int r) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBN;
  const float coef = scalars[3 * b];
  const float clip = scalars[3 * b + 1];
  const float wd = scalars[3 * b + 2];
  const float* phi_b = kRecovery ? phi + (size_t)b * n : nullptr;

  float phic = 0.f;
  if (kRecovery) {
    const int j = j0 + (int)threadIdx.x % kBN;
    if (j < n) phic = phi_b[j] * clip;
  }
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // left (k, row = i) is S[i, k]; right is D
  gemm(StridedTile<float>{S + (size_t)b * m * r, 1, r, i0, m, r},
       DirectionTile<kRecovery>{Gto + (size_t)b * r * n,
                                kRecovery ? Gt + (size_t)b * r * n : nullptr, phic, j0, n, r},
       r, as, bs, acc);

  const int row = i0 + row_of_thread();
  const int col = j0 + col_of_thread();
  float pc[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j)
    pc[j] = (kRecovery && col + j < n) ? phi_b[col + j] * clip : 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gi = row + i;
    if (gi >= m) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gj = col + j;
      if (gj >= n) break;
      float v = acc[i][j];
      if (kRecovery) v = fmaf(to_f32(G[b * gsb + gi * gsm + gj * gsn]), pc[j], v);
      float u = -coef * v;
      if (kDecay) u -= wd * to_f32(P[b * psb + gi * psm + gj * psn]);
      out[b * osb + gi * osm + gj * osn] = from_f32<TO>(u);
    }
  }
}

template <typename TG, typename TO, bool kRecovery, bool kDecay>
cudaError_t launch(const float* S, const float* Gto, const float* Gt, const float* phi,
                   const float* scalars, const void* G, const long long* gs, const void* P,
                   const long long* ps, void* out, const long long* os, int batch, int m, int n,
                   int r, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch);
  fused_update_kernel<TG, TO, kRecovery, kDecay><<<grid, kThreads, 0, stream>>>(
      S, Gto, Gt, phi, scalars, static_cast<const TG*>(G), gs[0], gs[1], gs[2],
      static_cast<const TO*>(P), ps[0], ps[1], ps[2], static_cast<TO*>(out), os[0], os[1], os[2],
      m, n, r);
  return cudaGetLastError();
}

template <typename TG, typename TO>
cudaError_t by_variant(int recovery, int decay, const float* S, const float* Gto, const float* Gt,
                       const float* phi, const float* scalars, const void* G, const long long* gs,
                       const void* P, const long long* ps, void* out, const long long* os,
                       int batch, int m, int n, int r, cudaStream_t s) {
  if (recovery && decay)
    return launch<TG, TO, true, true>(S, Gto, Gt, phi, scalars, G, gs, P, ps, out, os, batch, m,
                                      n, r, s);
  if (recovery)
    return launch<TG, TO, true, false>(S, Gto, Gt, phi, scalars, G, gs, P, ps, out, os, batch,
                                       m, n, r, s);
  if (decay)
    return launch<TG, TO, false, true>(S, Gto, Gt, phi, scalars, G, gs, P, ps, out, os, batch,
                                       m, n, r, s);
  return launch<TG, TO, false, false>(S, Gto, Gt, phi, scalars, G, gs, P, ps, out, os, batch, m,
                                      n, r, s);
}

}  // namespace

extern "C" {

// S (batch, m, r), Gto (batch, r, n), and with recovery Gt (batch, r, n) and
// phi (batch, n): fp32 contiguous.  scalars (batch, 3) fp32: coef, clip, wd.
// G (recovery only) and P (decay only) are strided views with element
// strides gs[3] / ps[3]; out has strides os[3].  g_dtype / o_dtype:
// 0 = float32, 1 = bfloat16 (P has the output's dtype).  Unused pointers may
// be NULL.  Launches on `stream` and returns the launch's error.
int fused_update_launch(const float* S, const float* Gto, const float* Gt, const float* phi,
                        const float* scalars, const void* G, const long long* gs, const void* P,
                        const long long* ps, void* out, const long long* os, int g_dtype,
                        int o_dtype, int recovery, int decay, int batch, int m, int n, int r,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  if (batch > 65535 || m > 65535 * kBM) return cudaErrorInvalidValue;
  if ((g_dtype != 0 && g_dtype != 1) || (o_dtype != 0 && o_dtype != 1))
    return cudaErrorInvalidValue;
  if (g_dtype == 0 && o_dtype == 0)
    return by_variant<float, float>(recovery, decay, S, Gto, Gt, phi, scalars, G, gs, P, ps, out,
                                    os, batch, m, n, r, s);
  if (g_dtype == 0)
    return by_variant<float, __nv_bfloat16>(recovery, decay, S, Gto, Gt, phi, scalars, G, gs, P,
                                            ps, out, os, batch, m, n, r, s);
  if (o_dtype == 0)
    return by_variant<__nv_bfloat16, float>(recovery, decay, S, Gto, Gt, phi, scalars, G, gs, P,
                                            ps, out, os, batch, m, n, r, s);
  return by_variant<__nv_bfloat16, __nv_bfloat16>(recovery, decay, S, Gto, Gt, phi, scalars, G,
                                                  gs, P, ps, out, os, batch, m, n, r, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
