// Grassmann tangent for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `tangent` of src/repro/kernels/grassmann.py
// (def line 192, pallas_call line 206; body `_tangent_kernel`, line 174):
//
//     T = -2 G A^T + 2 S C,   C = A A^T (r x r)
//
// with G (m, n) bf16 or fp32, A (r, n), S (m, r) -> T (m, r) fp32.  The
// (m, n) residual G - S A is never formed.  The TPU accumulates over n on a
// sequential grid axis, seeding its output block with 2 S C on the first
// step; its wrapper forms C outside the kernel.  Here one CTA owns one (128
// m-rows x 128 r-columns) tile of T and runs both contractions itself, so
// no sum crosses CTAs and T is deterministic.  G is a strided view, so a
// transposed canonical gradient (w_down, wo) is read in place; A and S are
// contiguous.  The C entry picks the route by G's dtype, never as a
// fallback:
//
// bf16 G (the llama-7b tracking step, 9 launches; the composite front end
//   past m = 2048): bf16 tensor cores (hopper_mma.cuh's Engine).
//   Bound on this card (H100 80GB HBM3, 700 W power limit): 2 r m n + 2
//   r^2 n + 2 m r^2 operations against ~2 m n bytes of G, far above the
//   H100's flop/byte balance at r = 1024, so bound by operations; fp32
//   CUDA cores (67 TFLOP/s) left the bf16 tensor cores (989 TFLOP/s) idle.  At (4096, 11008, r 1024) the passes below
//   are 3 x 92.4 + 6 x 8.6 GFLOP a matrix for T and 6 x 11.6 for C's upper
//   triangle (r (r + 1) n): for 2 matrices 0.80 ms at 989 TFLOP/s.
//   Accuracy: G is exact in one bf16 term.  A, S and 2C are fp32; each is
//   split in three exact bf16 terms (x = hi + mid + lo, hopper_mma.cuh
//   `split3`).  Every bf16 x bf16 product is exact in fp32, so the passes
//   that run decide the error:
//   - W = G A^T: 3 passes, G x A_lo, A_mid, A_hi: exact products, nothing
//     dropped;
//   - C = A A^T and S (2C): the 6 of the 9 term products of order >=
//     2^-16 of |A||A| (|S||2C|): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
//     hi.hi, as fused_update.cu; the dropped mid.lo, lo.mid, lo.lo are
//     each <= 2^-24;
//   - per 64-deep k-tile the passes start a fresh wgmma accumulator, which
//     is then added into an fp32 total (grassmann_project.cu: one
//     accumulator over all of K rounded too coarsely for phase 15's 1e-4;
//     T's two terms cancel).
//   tests/test_torch_split.py emulates these pass sets against fp64.
//   Three kernels per chunk of the stack (the chunk holds as many matrices
//   as fit kScratchBudget bytes of split terms: 2 of llama-7b's w_gate
//   stack, ~99 MB each; a whole 32-matrix stack would take 3.2 GB):
//   1. `split_bf16_kernel` (hopper_mma.cuh) writes A's terms as (chunk, 3,
//      r, n_pad) and S's as (chunk, 3, m, r_pad): memory-bound pre-passes;
//   2. `gram_wgmma_kernel`: 2C = 2 A A^T from A's terms, 6 passes, the
//      upper 128 x 128 tiles only (C is symmetric), each written with its
//      mirror as 2C's three bf16 terms (chunk, 3, r, r_pad);
//   3. `tangent_wgmma_kernel`: persistent 128 x 128 tiles of T, two
//      Engines over one ring (96 KB slots, 2 stages): W = G A^T over n (G
//      one term, K-major where its rows are contiguous, MN-major for a
//      transposed view; by TMA where G has a tensor map, else by the
//      producer warpgroup's element loads; A's terms K-major by TMA), the
//      total scaled by -2 (exact), then S (2C) over r added on (6 passes,
//      both K-major by TMA).  The producer fills the second contraction's
//      and the next tile's stages while the consumers finish the first.
//   The fp32 torch.matmul that formed C before took 0.61 of this call's
//   time at the 7b shape (PERF.md; the same card), more than the fifth
//   that moves C onto the tensor cores.
//
// fp32 G (an fp32 model): CUDA cores (tile_gemm.cuh), as project and
//   grad_tap keep theirs: fp32 G is not exact in bf16.  One CTA per tile,
//   W = G A^T over all of n, scaled by -2, then S (2C) over r, with 2C
//   formed by the wrapper (a power-of-two scale, so 2 (S C) and S (2C)
//   round alike).

#include "hopper_mma.cuh"
#include "tile_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 G: CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(tile::kThreads, 2)
tangent_kernel(const float* __restrict__ G, const float* __restrict__ A,
               const float* __restrict__ S, const float* __restrict__ C2, float* __restrict__ T,
               int m, int n, int r, long long gsb, long long gsm, long long gsn) {
  using namespace tile;
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
  gemm(StridedTile<float>{G + b * gsb, gsn, gsm, i0, m, n},
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

// ---------------------------------------------------------------------------
// bf16 G: wgmma over A, S and 2C split into three bf16 terms
// ---------------------------------------------------------------------------

namespace wg {

using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// G x A_lo, A_mid, A_hi (terms 0 hi, 1 mid, 2 lo; smallest first)
constexpr unsigned kGPasses = pass(0, 0, 2) | pass(1, 0, 1) | pass(2, 0, 0);
// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi: the 6 products >= 2^-16
constexpr unsigned kSixPasses = pass(0, 2, 0) | pass(1, 0, 2) | pass(2, 1, 1) | pass(3, 1, 0) |
                                pass(4, 0, 1) | pass(5, 0, 0);
constexpr int kSlot = 6 * 16384;  // a 6-term stage (3 + 3 terms of 128 x 64): 96 KB
// W = G A^T: G (1 term; K-major kKG, TMA kTmaG) x A's 3 terms (K-major, TMA)
template <bool kKG, bool kTmaG>
using GEngine = Engine<1, 3, kKG, true, kTmaG, true, kGPasses, 3, 64, !kTmaG, kSlot>;
// S (2C): S's and 2C's terms, both K-major by TMA; the same slots and
// arrivals as the G engine of its kernel
template <bool kAll>
using SEngine = Engine<3, 3, true, true, true, true, kSixPasses, 6, 64, kAll, kSlot>;
// C = A A^T tiles: A's terms against A's terms, both K-major by TMA
using CEngine = Engine<3, 3, true, true, true, true, kSixPasses, 6>;

constexpr long long kScratchBudget = 256ll << 20;

long long align256(long long v) { return (v + 255) / 256 * 256; }

struct Layout {
  int n_pad, r_pad, chunk;
  long long a_bytes, s_bytes, c_bytes;  // per matrix
  long long bytes;
};

Layout layout(int batch, int m, int n, int r) {
  Layout l;
  l.n_pad = hopper::split_r_pad(n);
  l.r_pad = hopper::split_r_pad(r);
  l.a_bytes = 2ll * hopper::kSplitTerms * r * l.n_pad;
  l.s_bytes = 2ll * hopper::kSplitTerms * m * l.r_pad;
  l.c_bytes = 2ll * hopper::kSplitTerms * r * l.r_pad;
  const long long per = l.a_bytes + l.s_bytes + l.c_bytes;
  long long c = per > 0 ? kScratchBudget / per : batch;
  c = c < 1 ? 1 : (c > batch ? batch : c);
  l.chunk = (int)c;
  l.bytes = align256(l.chunk * l.a_bytes) + align256(l.chunk * l.s_bytes) +
            align256(l.chunk * l.c_bytes);
  return l;
}

// Tensor maps of one chunk: G (the whole stack, when it has one) and the
// split terms of A, S and 2C (matrix z's first term at plane 3 z).
struct Maps {
  CUtensorMap g, a, s, c;
};

// Upper tile u (0 .. R(R+1)/2 - 1) of an R x R tile grid -> (ti, tj), ti <= tj.
__device__ __forceinline__ void upper_tile(int u, int tiles, int& ti, int& tj) {
  ti = 0;
  while (u >= tiles - ti) {
    u -= tiles - ti;
    ++ti;
  }
  tj = ti + u;
}

// Persistent: the chunk's upper tiles of 2C = 2 A A^T, each written as its
// three bf16 terms, with its mirror, into c_split (chunk, 3, r, r_pad).
// Totals of rows or columns past r are 0 (A's rows there are TMA's zero
// fill), so the padding columns r .. r_pad come out 0.
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
gram_wgmma_kernel(const __grid_constant__ CUtensorMap a_map, __nv_bfloat16* __restrict__ c_split,
                  int n, int r, int r_pad, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int tiles = (r + hopper::kEngM - 1) / hopper::kEngM;
  const int upper = tiles * (tiles + 1) / 2;
  const long long num_tiles = (long long)upper * chunk;
  const int num_k = (n + CEngine::kDepth - 1) / CEngine::kDepth;
  if (tid == 0) CEngine::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int z = (int)(t / upper);
    int ti, tj;
    upper_tile((int)(t - (long long)z * upper), tiles, ti, tj);
    if (wgi == hopper::kEngConsumers) {
      const Operand a{&a_map, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      CEngine::produce(sm.smem, sm.base, sm.full, sm.empty, a, a, ti * hopper::kEngM,
                       tj * hopper::kEngN, num_k, tid - 128 * hopper::kEngConsumers, it);
      continue;
    }
    float total[64];
    CEngine::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    const long long plane = (long long)r * r_pad;
    __nv_bfloat16* out = c_split + (long long)z * hopper::kSplitTerms * plane;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int ci = ti * hopper::kEngM + 64 * wgi + hopper::frag_row(i, tid);
      const int cj = tj * hopper::kEngN + hopper::frag_col(i, tid);
      __nv_bfloat16 hi, mid, lo;
      hopper::split3(2.f * total[i], hi, mid, lo);
      if (ci < r && cj < r_pad) {
        const long long o = (long long)ci * r_pad + cj;
        out[o] = hi;
        out[o + plane] = mid;
        out[o + 2 * plane] = lo;
      }
      if (ti != tj && cj < r && ci < r_pad) {
        const long long o = (long long)cj * r_pad + ci;
        out[o] = hi;
        out[o + plane] = mid;
        out[o + 2 * plane] = lo;
      }
    }
  }
}

// Persistent: the chunk's tiles of T (r tile fastest, so consecutive CTAs
// share a row block of G), matrices z0 .. z0 + chunk - 1 of the stack.
// G: element (k = j, x = i) at G[(z0 + z) gsb + i gsm + j gsn].
template <bool kKG, bool kTmaG>
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
tangent_wgmma_kernel(const __grid_constant__ Maps maps, const unsigned short* __restrict__ G,
                     long long gsb, long long gsm, long long gsn, float* __restrict__ T, int m,
                     int n, int r, int z0, int chunk) {
  using GE = GEngine<kKG, kTmaG>;
  using SE = SEngine<!kTmaG>;
  static_assert(GE::kStages == SE::kStages && GE::kSlot == SE::kSlot, "one ring");
  extern __shared__ unsigned char smem_raw[];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int m_tiles = (m + hopper::kEngM - 1) / hopper::kEngM;
  const int r_tiles = (r + hopper::kEngN - 1) / hopper::kEngN;
  const long long num_tiles = (long long)m_tiles * r_tiles * chunk;
  const int num_k1 = (n + GE::kDepth - 1) / GE::kDepth;
  const int num_k2 = (r + SE::kDepth - 1) / SE::kDepth;
  if (tid == 0) GE::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;  // k-tiles through the ring so far
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const int rt = (int)(t % r_tiles);
    const long long rest = t / r_tiles;
    const int mt = (int)(rest % m_tiles);
    const int z = (int)(rest / m_tiles);
    const int i0 = mt * hopper::kEngM;
    const int c0 = rt * hopper::kEngN;
    if (wgi == hopper::kEngConsumers) {
      const int pt = tid - 128 * hopper::kEngConsumers;
      const Operand g{&maps.g, z0 + z, G + (z0 + z) * gsb, gsn, gsm, n, m};
      const Operand a{&maps.a, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      GE::produce(sm.smem, sm.base, sm.full, sm.empty, g, a, i0, c0, num_k1, pt, it);
      const Operand s{&maps.s, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      const Operand c{&maps.c, hopper::kSplitTerms * z, nullptr, 0, 0, 0, 0};
      SE::produce(sm.smem, sm.base, sm.full, sm.empty, s, c, i0, c0, num_k2, pt, it);
      continue;
    }
    float total[64];
    GE::consume(total, sm.base, sm.full, sm.empty, num_k1, wgi, it);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] *= -2.f;
    SE::consume(total, sm.base, sm.full, sm.empty, num_k2, wgi, it, false);
    float* out = T + (long long)(z0 + z) * m * r;
    const int row0 = i0 + 64 * wgi;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
      const int gi = row0 + hopper::frag_row(i, tid);
      const int gj = c0 + hopper::frag_col(i, tid);
      if (gi >= m || gj >= r) continue;
      const long long at = (long long)gi * r + gj;
      if (gj + 1 < r)
        hopper::store_pair(out, 0, at, 1, total[i], total[i + 1]);
      else
        out[at] = total[i];
    }
  }
}

// Routes reported to the caller.
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLoads = 2, kMNMajor = 4 };

template <bool kKG, bool kTmaG>
cudaError_t launch_tiles(const Maps& maps, const void* G, long long gsb, long long gsm,
                         long long gsn, float* T, int m, int n, int r, int z0, int chunk,
                         cudaStream_t stream) {
  auto kernel = tangent_wgmma_kernel<kKG, kTmaG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((m + hopper::kEngM - 1) / hopper::kEngM) *
                          ((r + hopper::kEngN - 1) / hopper::kEngN) * chunk;
  const int grid = (int)(tiles < hopper::num_sms() ? tiles : hopper::num_sms());
  kernel<<<grid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(
      maps, static_cast<const unsigned short*>(G), gsb, gsm, gsn, T, m, n, r, z0, chunk);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* G, const float* A, const float* S, float* T, void* scratch,
                        int batch, int m, int n, int r, long long gsb, long long gsm,
                        long long gsn, int* route, cudaStream_t stream) {
  // K-major G where its rows (j) are contiguous; MN-major for a transposed
  // view (columns contiguous); TMA where G has a tensor map
  const bool kmajor = gsn == 1 || gsm != 1;
  const bool tma = ((uintptr_t)G % 16 == 0) &&
                   (kmajor ? gsn == 1 && hopper::tma_stride_ok(2 * gsm)
                           : gsm == 1 && hopper::tma_stride_ok(2 * gsn)) &&
                   (batch == 1 || hopper::tma_stride_ok(2 * gsb));
  *route = (tma ? kWgmmaTma : kWgmmaLoads) | (kmajor ? 0 : kMNMajor);
  if (n == 0)  // W = 0 and C = 0
    return cudaMemsetAsync(T, 0, sizeof(float) * (size_t)batch * m * r, stream);
  const Layout l = layout(batch, m, n, r);
  char* a_split = static_cast<char*>(scratch);
  char* s_split = a_split + align256(l.chunk * l.a_bytes);
  char* c_split = s_split + align256(l.chunk * l.s_bytes);
  auto gram = gram_wgmma_kernel;
  cudaError_t err = cudaFuncSetAttribute(gram, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  Maps maps;
  if (tma) {
    const uint64_t d0 = kmajor ? n : m, d1 = kmajor ? m : n;
    const uint64_t s1 = 2ull * (kmajor ? gsm : gsn);
    const uint64_t s2 = batch == 1 ? (s1 * d1 + 15) / 16 * 16 : 2ull * gsb;
    // K-major: (64 k, 128 rows) boxes; MN-major: (64 rows, 64 k) boxes
    if (!hopper::make_map(&maps.g, G, d0, d1, batch, s1, s2, kmajor ? 128 : 64))
      return cudaErrorInvalidValue;
  }
  const int tiles = (r + hopper::kEngM - 1) / hopper::kEngM;
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    // A's terms (chunk, 3, r, n_pad) and S's (chunk, 3, m, r_pad)
    err = hopper::split_bf16(A + (size_t)z0 * r * n, a_split, chunk, r, n, stream);
    if (err != cudaSuccess) return err;
    err = hopper::split_bf16(S + (size_t)z0 * m * r, s_split, chunk, m, r, stream);
    if (err != cudaSuccess) return err;
    // all K-major, (64 k, 128 rows) boxes
    if (!hopper::make_map(&maps.a, a_split, l.n_pad, r, 3ull * chunk, 2ull * l.n_pad,
                          2ull * l.n_pad * r, 128) ||
        !hopper::make_map(&maps.s, s_split, l.r_pad, m, 3ull * chunk, 2ull * l.r_pad,
                          2ull * l.r_pad * m, 128) ||
        !hopper::make_map(&maps.c, c_split, l.r_pad, r, 3ull * chunk, 2ull * l.r_pad,
                          2ull * l.r_pad * r, 128))
      return cudaErrorInvalidValue;
    if (!tma) maps.g = maps.a;  // unused by the element-load producer
    const long long gtiles = (long long)tiles * (tiles + 1) / 2 * chunk;
    const int ggrid = (int)(gtiles < hopper::num_sms() ? gtiles : hopper::num_sms());
    gram<<<ggrid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(
        maps.a, reinterpret_cast<__nv_bfloat16*>(c_split), n, r, l.r_pad, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (kmajor && tma)
      err = launch_tiles<true, true>(maps, G, gsb, gsm, gsn, T, m, n, r, z0, chunk, stream);
    else if (kmajor)
      err = launch_tiles<true, false>(maps, G, gsb, gsm, gsn, T, m, n, r, z0, chunk, stream);
    else if (tma)
      err = launch_tiles<false, true>(maps, G, gsb, gsm, gsn, T, m, n, r, z0, chunk, stream);
    else
      err = launch_tiles<false, false>(maps, G, gsb, gsm, gsn, T, m, n, r, z0, chunk, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wg

}  // namespace

extern "C" {

// Bytes of scratch grassmann_tangent_launch needs at these sizes for G of
// `dtype` (0 = float32: none; 1 = bfloat16: the split terms of a chunk).
long long grassmann_tangent_scratch_bytes(int batch, int m, int n, int r, int dtype) {
  return dtype == 1 ? wg::layout(batch, m, n, r).bytes : 0;
}

// G (batch, m, n) with element strides (gsb, gsm, gsn), dtype 0 = float32,
// 1 = bfloat16; A (batch, r, n), S (batch, m, r) and T (batch, m, r), all
// fp32 contiguous.  C2 = 2 A A^T (batch, r, r) fp32 for dtype 0 (NULL for
// dtype 1, which forms it on the tensor cores); scratch
// grassmann_tangent_scratch_bytes bytes.  Writes the route taken to *route
// (0 CUDA cores, 1 wgmma with the TMA producer, 2 wgmma with element loads;
// + 4 when G is staged MN-major).  Launches on `stream` and returns the
// first launch error.
int grassmann_tangent_launch(const void* G, const float* A, const float* S, const float* C2,
                             float* T, void* scratch, int dtype, int batch, int m, int n, int r,
                             long long gsb, long long gsm, long long gsn, int* route,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = wg::kCudaCores;
  if (batch == 0 || m == 0 || r == 0) return cudaSuccess;
  if (batch > 65535 || m > 65535 * tile::kBM) return cudaErrorInvalidValue;
  if (dtype == 0) {
    const dim3 grid((r + tile::kBN - 1) / tile::kBN, (m + tile::kBM - 1) / tile::kBM, batch);
    tangent_kernel<<<grid, tile::kThreads, 0, s>>>(static_cast<const float*>(G), A, S, C2, T, m,
                                                   n, r, gsb, gsm, gsn);
    return cudaGetLastError();
  }
  if (dtype == 1)
    return wg::launch_bf16(G, A, S, T, scratch, batch, m, n, r, gsb, gsm, gsn, route, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
