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
// right factor D = Gto - (phi * clip) Gt:
//
//     S Gto + (G - S Gt) phi clip  =  S D + G phi clip
//
// Bound on this card.  At r = 1024 the product (2 r m n operations against
// ~6 m n bytes of bf16 G, param and update) is far above the H100's
// flop/byte balance: bound by operations.  Its first design summed it in
// fp32 on CUDA cores (67 TFLOP/s) and left the bf16 tensor cores (989
// TFLOP/s) idle.  Both factors are fp32, so each is split into three bf16
// terms (S = S_hi + S_mid + S_lo, D likewise; exact, hopper_mma.cuh
// `split3`), and the tensor cores run the 6 of the 9 term products whose
// order is >= 2^-16 of |S||D|: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi
// (smallest first).  Each bf16 x bf16 product is exact in fp32; the three
// dropped products are each <= 2^-24 of |S||D|, and the tensor cores'
// accumulation rounds at one 64-deep k-tile of the 6 passes, flushed into
// an fp32 total.  The result is more accurate than an fp32 GEMM, for every
// G and output dtype, so there is one route (`wgmma-tma`); the CUDA-core
// kernel is gone.
//
// Where the split comes from.  Per chunk of matrices, two memory-bound
// pre-passes write S's terms as (chunk, 3, m, r_pad) bf16 (hopper_mma.cuh
// `split_bf16_kernel`: rows of r, the K-major operand) and D's as (chunk,
// 3, r, n_pad) (`split_direction_kernel`, which forms D = Gto - (phi clip)
// Gt from fp32 on the way: the N-major operand); the main kernel reads both
// by TMA.  The chunk holds as many matrices of the stack as fit
// kScratchBudget bytes of scratch (2 of llama-7b's w_gate stack, 92.8 MB
// each), so the scratch stays at most 256 MiB whatever the stack.  Forming
// D in the producer warpgroup instead would double its loads per stage
// (fp32 Gto and Gt) on top of the split, and grassmann_project.cu's
// element-load producer already runs at a third of its TMA producer's rate.
//
// Main kernel: hopper_mma.cuh's Engine over 128 x 128 output tiles, two
// consumer warpgroups and a TMA producer, a 2-stage ring of 96 KB (3 terms
// of S and 3 of D per 64-deep k-tile).  It is persistent: one CTA per SM
// walks the chunk's tiles in bands of 8 row tiles (within a band the row
// tiles fastest, so the resident CTAs read 8 row blocks of S and a few
// column blocks of D), and its producer fills the next tile's stages while
// the consumers run the epilogue.  The epilogue adds G * phi * clip,
// scales by -coef, subtracts wd * param and narrows to the parameter
// dtype through masked strided stores (two adjacent columns at once where
// they are contiguous), so a transposed canonical leaf (w_down, embed) is
// read and written in place, in the parameter's own layout.  coef, clip
// and wd are per-matrix scalars read from a (batch, 3) array in device
// memory: under a batched launch each matrix of a layer stack has its own
// Eq. 12 clip.

#include "hopper_mma.cuh"

namespace {

using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (terms 0 hi, 1 mid, 2 lo)
constexpr unsigned kPasses = pass(0, 2, 0) | pass(1, 0, 2) | pass(2, 1, 1) | pass(3, 1, 0) |
                             pass(4, 0, 1) | pass(5, 0, 0);
// A = S's terms (K-major), B = D's terms (N-major), both by TMA: 2 stages
// of 96 KB
using UpdateEngine = Engine<3, 3, true, false, true, true, kPasses, 6>;

constexpr long long kScratchBudget = 256ll << 20;
// m tiles of a band of the tile order: 8 ran 1.5% faster than one band
// over all of m, and no slower than 4 or 16 (PERF.md)
constexpr int kBand = 8;
constexpr int kNPad = 8;  // D's rows pad to 16 bytes (a TMA stride)

long long align256(long long v) { return (v + 255) / 256 * 256; }

struct Layout {
  int r_pad, n_pad, chunk;
  long long s_bytes, d_bytes;  // per matrix
  long long bytes;
};

Layout layout(int batch, int m, int n, int r) {
  Layout l;
  l.r_pad = hopper::split_r_pad(r);
  l.n_pad = (n + kNPad - 1) / kNPad * kNPad;
  l.s_bytes = 2ll * hopper::kSplitTerms * m * l.r_pad;
  l.d_bytes = 2ll * hopper::kSplitTerms * r * l.n_pad;
  const long long per = l.s_bytes + l.d_bytes;
  long long c = per > 0 ? kScratchBudget / per : batch;
  c = c < 1 ? 1 : (c > batch ? batch : c);
  l.chunk = (int)c;
  // room for the maps of an empty operand (r = 0) too
  l.bytes = align256(l.chunk * l.s_bytes) + align256(l.chunk * l.d_bytes) + 32768;
  return l;
}

// D[b, k, j] = Gto[b, k, j] - (phi[b, j] * clip[b]) * Gt[b, k, j] (or Gto
// alone) -> (chunk, 3, r, n_pad) bf16, for the chunk's matrices from z0.
// Each operation rounds on its own (no contraction), so the terms are bit
// for bit those of ref.split_direction_ref.
__global__ void split_direction_kernel(const float* __restrict__ Gto, const float* __restrict__ Gt,
                                       const float* __restrict__ phi,
                                       const float* __restrict__ scalars,
                                       __nv_bfloat16* __restrict__ out, int r, int n, int n_pad,
                                       int z0, int recovery) {
  const int z = blockIdx.y;
  const int b = z0 + z;
  const long long rn = (long long)r * n;
  const float clip = scalars[3 * b + 1];
  const float* gto = Gto + b * rn;
  const float* gt = recovery ? Gt + b * rn : nullptr;
  const long long plane = (long long)r * n_pad;
  __nv_bfloat16* o = out + (long long)z * hopper::kSplitTerms * plane;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < rn;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / n);
    const int j = (int)(i - (long long)k * n);
    float d = gto[i];
    if (recovery) d = __fsub_rn(d, __fmul_rn(__fmul_rn(phi[(long long)b * n + j], clip), gt[i]));
    __nv_bfloat16 hi, mid, lo;
    hopper::split3(d, hi, mid, lo);
    const long long at = (long long)k * n_pad + j;
    o[at] = hi;
    o[at + plane] = mid;
    o[at + 2 * plane] = lo;
  }
}

cudaError_t split_direction(const float* Gto, const float* Gt, const float* phi,
                            const float* scalars, void* out, int chunk, int r, int n, int n_pad,
                            int z0, int recovery, cudaStream_t stream) {
  const long long rn = (long long)r * n;
  if (rn == 0 || chunk == 0) return cudaSuccess;
  long long blocks = (rn + 255) / 256;
  const long long cap = (132 * 16 + chunk - 1) / chunk;
  blocks = blocks < cap ? blocks : cap;
  split_direction_kernel<<<dim3((unsigned)blocks, chunk), 256, 0, stream>>>(
      Gto, Gt, phi, scalars, static_cast<__nv_bfloat16*>(out), r, n, n_pad, z0, recovery);
  return cudaGetLastError();
}

// Persistent: CTA blockIdx.x walks tiles blockIdx.x, + gridDim.x, ... of
// the chunk's m_tiles x n_tiles x chunk tiles in bands of kBand m tiles;
// its producer fills the next tile's stages while its consumers run the
// last one's epilogue.
// Matrix z0 + z's terms are at planes 3 z of both maps.
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
fused_update_wgmma_kernel(const __grid_constant__ CUtensorMap s_map,
                          const __grid_constant__ CUtensorMap d_map, const float* __restrict__ phi,
                          const float* __restrict__ scalars, const void* G, long long gsb,
                          long long gsm, long long gsn, const void* P, long long psb,
                          long long psm, long long psn, void* out, long long osb, long long osm,
                          long long osn, int m, int n, int r, int z0, int chunk, int g_dtype,
                          int o_dtype, int recovery, int decay) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  const int n_tiles = (n + hopper::kEngN - 1) / hopper::kEngN;
  const long long num_tiles = (long long)m_tiles * n_tiles * chunk;
  const int num_k = (r + UpdateEngine::kDepth - 1) / UpdateEngine::kDepth;

  if (tid == 0) UpdateEngine::init(sm.full, sm.empty);
  __syncthreads();

  int it = 0;  // k-tiles through the ring so far
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    // bands of kBand m tiles: a band's m tiles fastest, then its column
    // blocks, so the resident CTAs read kBand row blocks of S and a few
    // column blocks of D
    const long long per_z = (long long)m_tiles * n_tiles;
    const int z = (int)(t / per_z);
    const long long in_z = t - z * per_z;
    const int band = (int)(in_z / ((long long)kBand * n_tiles));
    const int rows = min(kBand, m_tiles - band * kBand);
    const int in_band = (int)(in_z - (long long)band * kBand * n_tiles);
    const int i0 = (band * kBand + in_band % rows) * hopper::kEngM;
    const int j0 = (in_band / rows) * hopper::kEngN;
    if (wgi == hopper::kEngConsumers) {
      const Operand a{&s_map, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      const Operand d{&d_map, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      UpdateEngine::produce(sm.smem, sm.base, sm.full, sm.empty, a, d, i0, j0, num_k,
                            tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    float total[64];
    UpdateEngine::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);

    const int b = z0 + z;
    const float coef = scalars[3 * b];
    const float clip = scalars[3 * b + 1];
    const float wd = scalars[3 * b + 2];
    const int row0 = i0 + 64 * wgi;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
      const int gi = row0 + hopper::frag_row(i, tid);
      const int gj = j0 + hopper::frag_col(i, tid);
      if (gi >= m || gj >= n) continue;
      const bool two = gj + 1 < n;
      float u0 = -coef * total[i], u1 = -coef * total[i + 1];
      if (recovery) {
        const float* ph = phi + (long long)b * n + gj;
        const long long at = b * gsb + gi * gsm + gj * gsn;
        const float2 g = two ? hopper::load_pair(G, g_dtype, at, gsn)
                             : make_float2(hopper::load_float(G, g_dtype, at), 0.f);
        u0 = -coef * fmaf(g.x, ph[0] * clip, total[i]);
        if (two) u1 = -coef * fmaf(g.y, ph[1] * clip, total[i + 1]);
      }
      if (decay) {
        const long long at = b * psb + gi * psm + gj * psn;
        const float2 q = two ? hopper::load_pair(P, o_dtype, at, psn)
                             : make_float2(hopper::load_float(P, o_dtype, at), 0.f);
        u0 -= wd * q.x;
        u1 -= wd * q.y;
      }
      const long long at = b * osb + gi * osm + gj * osn;
      if (two)
        hopper::store_pair(out, o_dtype, at, osn, u0, u1);
      else
        hopper::store_float(out, o_dtype, at, u0);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of scratch fused_update_launch needs at these sizes.
long long fused_update_scratch_bytes(int batch, int m, int n, int r) {
  return layout(batch, m, n, r).bytes;
}

// S (batch, m, r), Gto (batch, r, n), and with recovery Gt (batch, r, n) and
// phi (batch, n): fp32 contiguous.  scalars (batch, 3) fp32: coef, clip, wd.
// G (recovery only) and P (decay only) are strided views with element
// strides gs[3] / ps[3]; out has strides os[3].  g_dtype / o_dtype:
// 0 = float32, 1 = bfloat16 (P has the output's dtype).  Unused pointers may
// be NULL.  scratch: fused_update_scratch_bytes bytes.  Writes the route
// taken to *route (1: wgmma, TMA producer).  Launches on `stream` and
// returns the first launch error.
int fused_update_launch(const float* S, const float* Gto, const float* Gt, const float* phi,
                        const float* scalars, const void* G, const long long* gs, const void* P,
                        const long long* ps, void* out, const long long* os, void* scratch,
                        int g_dtype, int o_dtype, int recovery, int decay, int batch, int m, int n,
                        int r, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = 1;
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  const long long n_tiles = (n + hopper::kEngN - 1) / hopper::kEngN;
  if (batch > 65535) return cudaErrorInvalidValue;
  if ((g_dtype != 0 && g_dtype != 1) || (o_dtype != 0 && o_dtype != 1))
    return cudaErrorInvalidValue;
  const Layout l = layout(batch, m, n, r);
  char* s_split = static_cast<char*>(scratch);
  char* d_split = s_split + align256(l.chunk * l.s_bytes);
  auto kernel = fused_update_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  // r = 0 maps a dummy extent that no k-tile reads
  const uint64_t rp = l.r_pad ? l.r_pad : 64, rr = r ? r : 1;
  const long long m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    err = hopper::split_bf16(S + (size_t)z0 * m * r, s_split, chunk, m, r, s);
    if (err != cudaSuccess) return err;
    err = split_direction(Gto, Gt, phi, scalars, d_split, chunk, r, n, l.n_pad, z0, recovery, s);
    if (err != cudaSuccess) return err;
    CUtensorMap s_map, d_map;
    // S's terms K-major: (r_pad, m, 3 chunk), boxes of 64 k x 128 rows;
    // D's terms N-major: (n, r, 3 chunk), rows n_pad apart, boxes of 64 x 64
    if (!hopper::make_map(&s_map, s_split, rp, m, 3ull * chunk, 2ull * rp, 2ull * rp * m, 128) ||
        !hopper::make_map(&d_map, d_split, n, rr, 3ull * chunk, 2ull * l.n_pad,
                          2ull * l.n_pad * rr, 64))
      return cudaErrorInvalidValue;
    const long long tiles = m_tiles * n_tiles * chunk;
    const int grid = (int)(tiles < hopper::num_sms() ? tiles : hopper::num_sms());
    kernel<<<grid, hopper::kEngThreads, hopper::kEngSmem, s>>>(
        s_map, d_map, phi, scalars, G, gs[0], gs[1], gs[2], P, ps[0], ps[1], ps[2], out, os[0],
        os[1], os[2], m, n, r, z0, chunk, g_dtype, o_dtype, recovery, decay);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The split of the direction alone (the second pre-pass, for the check
// against ref.split_direction_ref): Gto, Gt, phi, scalars as above -> out
// (batch, 3, r, n) bf16.
int fused_update_split_direction_launch(const float* Gto, const float* Gt, const float* phi,
                                        const float* scalars, void* out, int recovery, int batch,
                                        int r, int n, void* stream) {
  if (batch > 65535) return cudaErrorInvalidValue;
  return split_direction(Gto, Gt, phi, scalars, out, batch, r, n, n, 0, recovery,
                         static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
