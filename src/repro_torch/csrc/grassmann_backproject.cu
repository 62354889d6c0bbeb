// backproject and recovery for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/grassmann.py, the
// building blocks of the optimizer's unfused schedule
// (core/lowrank_adam.py, lowrank_adam_step with lr=None):
//   backproject  (def line 149, pallas_call line 161): Ghat = S X
//   recovery     (def line 230, pallas_call line 245): Lam = (G - S Gt) * phi
// with S (m, r), X and Gt (r, n), phi (n,), G (m, n) bf16 or fp32 read in
// place through strides; both write an (m, n) fp32 result.  Grid z (or a
// persistent walk over the stack) is the matrix index, so one launch
// covers a layer stack; any shape, ragged tiles masked.
//
// Bound on this card.  2 m n r operations against 4 m n bytes written
// (and, for recovery, 2-4 m n read): at llama-1b's (2048, 5461, r 512)
// ~11.5 GFLOP over ~60-80 MB per matrix, far above the card's flop/byte
// balance: bound by operations.
//
// Design: both on the bf16 tensor cores (route `wgmma-tma`, every G
// dtype), one main loop with two epilogues.  Each TPU grid cell forms one
// (bm, r) x (r, bn) product; nothing is summed across cells.  Here S
// (K-major: rows of r) and X or Gt (N-major: rows of n) are fp32 factors,
// the orientation of fused_update.cu's S D, so the same split-product
// engine (hopper_mma.cuh `Engine`) runs it: per chunk of the stack
// (scratch <= 256 MiB) two memory-bound pre-passes split S into (chunk, 3,
// m, r_pad) and X into (chunk, 3, r, n_pad) exact bf16 terms
// (`split_bf16_kernel`), then one persistent launch walks the chunk's 128 x
// 128 output tiles (bands of 8 row tiles), its producer warpgroup feeding
// both operands' three terms by TMA into a 2-stage ring while two consumer
// warpgroups run the 6 term products of order >= 2^-16 of |S||X| (lo.hi,
// hi.lo, mid.mid, mid.hi, hi.mid, hi.hi) per 64-deep k-tile into a fresh
// accumulator, flushed into fp32 totals.  Each bf16 x bf16 product is exact
// in fp32 and the three dropped products are each <= 2^-24 of |S||X|, so
// the product is as accurate as an fp32 GEMM (tests/test_torch_split.py).
// 6 passes at 989 TFLOP/s bound either at 0.139 ms at llama-1b's shape x 2,
// against 0.342 ms for the fp32 CUDA cores.
//
// The epilogues (template flag kRecovery): backproject stores the fp32
// totals; recovery reads G at the tile's elements through its strides
// (two adjacent columns in one 4- or 8-byte load where they are adjacent
// in memory; a transposed canonical view, gsm = 1, takes two scalar
// loads, neighbouring lanes on neighbouring rows, as in fused_update.cu),
// widens it to fp32 and writes (g - total) * phi_j, in the TPU kernel's
// order of operations.  G enters only there, so the product and its
// route are the same for fp32 and bf16 G, and the (m, n) residual never
// exists apart from the output.  The consumers run that epilogue with the
// tensor cores idle (the 2-stage ring lets the producer run only two
// k-tiles ahead), so each tile first asks L2 for its block of G, one
// 128-byte line per consumer thread, while its products run; that made
// the call measurably shorter on the H100, where reading the G values
// into registers before the stores, or prefetching into L1, did not
// (PERF.md).

#include "hopper_mma.cuh"

namespace {

using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi (terms 0 hi, 1 mid, 2 lo)
constexpr unsigned kPasses = pass(0, 2, 0) | pass(1, 0, 2) | pass(2, 1, 1) | pass(3, 1, 0) |
                             pass(4, 0, 1) | pass(5, 0, 0);
// A = S's terms (K-major), B = X's terms (N-major), both by TMA: 2 stages
// of 96 KB
using BackEngine = Engine<3, 3, true, false, true, true, kPasses, 6>;

constexpr long long kScratchBudget = 256ll << 20;
constexpr int kBand = 8;  // m tiles of a band of the tile order, as fused_update.cu

long long align256(long long v) { return (v + 255) / 256 * 256; }

struct Layout {
  int r_pad, n_pad, chunk;
  long long s_bytes, x_bytes;  // per matrix
  long long bytes;
};

Layout layout(int batch, int m, int n, int r) {
  Layout l;
  l.r_pad = hopper::split_r_pad(r);
  l.n_pad = hopper::split_r_pad(n);
  l.s_bytes = 2ll * hopper::kSplitTerms * m * l.r_pad;
  l.x_bytes = 2ll * hopper::kSplitTerms * r * l.n_pad;
  const long long per = l.s_bytes + l.x_bytes;
  long long c = per > 0 ? kScratchBudget / per : batch;
  c = c < 1 ? 1 : (c > batch ? batch : c);
  l.chunk = (int)c;
  // room for the maps of an empty operand (r = 0) too
  l.bytes = align256(l.chunk * l.s_bytes) + align256(l.chunk * l.x_bytes) + 32768;
  return l;
}

// recovery's epilogue operands: G (element (i, j) of matrix b at
// G[b gsb + i gsm + j gsn], fp32 or bf16 by g_dtype) and phi (batch, n).
struct Residual {
  const void* G;
  const float* phi;
  long long gsb, gsm, gsn;
  int g_dtype;
};

// Persistent: CTA blockIdx.x walks tiles blockIdx.x, + gridDim.x, ... of
// the chunk's m_tiles x n_tiles x chunk tiles in bands of kBand m tiles.
// Matrix z0 + z's terms are at planes 3 z of both maps.  kRecovery: out =
// (G - S X) * phi, else out = S X.
template <bool kRecovery>
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
backproject_wgmma_kernel(const __grid_constant__ CUtensorMap s_map,
                         const __grid_constant__ CUtensorMap x_map, float* __restrict__ out,
                         Residual res, int m, int n, int r, int z0, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  const int n_tiles = (n + hopper::kEngN - 1) / hopper::kEngN;
  const long long num_tiles = (long long)m_tiles * n_tiles * chunk;
  const int num_k = (r + BackEngine::kDepth - 1) / BackEngine::kDepth;

  if (tid == 0) BackEngine::init(sm.full, sm.empty);
  __syncthreads();

  int it = 0;  // k-tiles through the ring so far
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
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
      const Operand x{&x_map, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      BackEngine::produce(sm.smem, sm.base, sm.full, sm.empty, a, x, i0, j0, num_k,
                          tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    const long long b = z0 + z;
    if (kRecovery) {  // bring the tile's G into L2 while its products run
      const int a = tid & 127, c = 64 * (tid >> 7);  // 64 elements: 128-byte lines
      const bool along = res.gsn == 1;                // G's rows contiguous
      const int gi = i0 + (along ? a : c), gj = j0 + (along ? c : a);
      if (gi < m && gj < n) {
        const char* p = static_cast<const char*>(res.G) +
                        (b * res.gsb + gi * res.gsm + gj * res.gsn) * (res.g_dtype ? 2 : 4);
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
        if (!res.g_dtype) asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p + 128));
      }
    }
    float total[64];
    BackEngine::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);

    float* o = out + b * m * n;
    const int row0 = i0 + 64 * wgi;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
      const int gi = row0 + hopper::frag_row(i, tid);
      const int gj = j0 + hopper::frag_col(i, tid);
      if (gi >= m || gj >= n) continue;
      const bool two = gj + 1 < n;
      float v0 = total[i], v1 = total[i + 1];
      if (kRecovery) {
        const long long at = b * res.gsb + gi * res.gsm + gj * res.gsn;
        const float2 g = two ? hopper::load_pair(res.G, res.g_dtype, at, res.gsn)
                             : make_float2(hopper::load_float(res.G, res.g_dtype, at), 0.f);
        const float* ph = res.phi + b * n + gj;
        v0 = (g.x - v0) * ph[0];
        if (two) v1 = (g.y - v1) * ph[1];
      }
      const long long at = (long long)gi * n + gj;
      if (two)
        hopper::store_pair(o, 0, at, 1, v0, v1);
      else
        o[at] = v0;
    }
  }
}

// Splits, maps and launches per chunk of the stack: out = S X, or (G - S X)
// phi with kRecovery.
template <bool kRecovery>
cudaError_t launch(const float* S, const float* X, float* out, void* scratch, const Residual& res,
                   int batch, int m, int n, int r, cudaStream_t s) {
  if (batch == 0 || m == 0 || n == 0) return cudaSuccess;
  const Layout l = layout(batch, m, n, r);
  char* s_split = static_cast<char*>(scratch);
  char* x_split = s_split + align256(l.chunk * l.s_bytes);
  auto kernel = backproject_wgmma_kernel<kRecovery>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  // r = 0 maps a dummy extent that no k-tile reads
  const uint64_t rp = l.r_pad ? l.r_pad : 64, rr = r ? r : 1;
  const long long m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  const long long n_tiles = (n + hopper::kEngN - 1) / hopper::kEngN;
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    err = hopper::split_bf16(S + (size_t)z0 * m * r, s_split, chunk, m, r, s);
    if (err != cudaSuccess) return err;
    err = hopper::split_bf16(X + (size_t)z0 * r * n, x_split, chunk, r, n, s);
    if (err != cudaSuccess) return err;
    CUtensorMap s_map, x_map;
    // S's terms K-major: (r_pad, m, 3 chunk), boxes of 64 k x 128 rows;
    // X's terms N-major: (n, r, 3 chunk), rows n_pad apart, boxes of 64 x 64
    if (!hopper::make_map(&s_map, s_split, rp, m, 3ull * chunk, 2ull * rp, 2ull * rp * m, 128) ||
        !hopper::make_map(&x_map, x_split, n, rr, 3ull * chunk, 2ull * l.n_pad,
                          2ull * l.n_pad * rr, 64))
      return cudaErrorInvalidValue;
    const long long tiles = m_tiles * n_tiles * chunk;
    const int grid = (int)(tiles < hopper::num_sms() ? tiles : hopper::num_sms());
    kernel<<<grid, hopper::kEngThreads, hopper::kEngSmem, s>>>(s_map, x_map, out, res, m, n, r,
                                                               z0, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Bytes of scratch backproject_wgmma_launch and grassmann_recovery_launch
// need at these sizes.
long long backproject_scratch_bytes(int batch, int m, int n, int r) {
  return layout(batch, m, n, r).bytes;
}

// out = S X: S (batch, m, r), X (batch, r, n) and out (batch, m, n), fp32
// contiguous; scratch: backproject_scratch_bytes bytes.  Writes the route
// taken to *route (1: wgmma, TMA producer).  Launches on `stream` and
// returns the first launch error.
int backproject_wgmma_launch(const float* S, const float* X, float* out, void* scratch, int batch,
                             int m, int n, int r, int* route, void* stream) {
  *route = 1;
  return launch<false>(S, X, out, scratch, Residual{nullptr, nullptr, 0, 0, 0, 0}, batch, m, n,
                       r, static_cast<cudaStream_t>(stream));
}

// recovery: out = (G - S Gt) * phi[None, :], S (batch, m, r), Gt (batch, r,
// n) and phi (batch, n) fp32 contiguous, G (batch, m, n) with element
// strides (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; out (batch, m,
// n) fp32 contiguous; scratch: backproject_scratch_bytes bytes.  Writes the
// route taken to *route (1: wgmma, TMA producer, for either dtype).
// Launches on `stream` and returns the first launch error.
int grassmann_recovery_launch(const float* S, const float* Gt, const void* G, const float* phi,
                              float* out, void* scratch, int dtype, int batch, int m, int n,
                              int r, long long gsb, long long gsm, long long gsn, int* route,
                              void* stream) {
  *route = 1;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return launch<true>(S, Gt, out, scratch, Residual{G, phi, gsb, gsm, gsn, dtype}, batch, m, n, r,
                      static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
