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
// Ownership.  The TPU sums T^T G over a sequential m grid axis and adds the
// three Grams only on its first column sweep (j == 0), so that later column
// blocks do not add them again.  CUDA blocks run in no order, so here every
// 128 x 128 output tile, of T^T G or of one of the three Grams, is owned by
// one CTA that walks the whole m extent itself: no sum crosses CTAs, no
// Gram is added once per column block, no atomics touch an output, and
// the result does not depend on the schedule (a second launch gives the
// same bits).  T^T T and S^T S are symmetric: only their tiles on and above
// the diagonal are computed, an off-diagonal tile is stored as itself and
// mirrored, and a diagonal tile stores its upper triangle and that
// triangle's mirror, so both triangles hold the same bits.  Ragged tiles
// are masked (TMA's zero fill, masked loads and stores): any (m, n, r).
//
// Bound on this card.  2 m r n + 2 m r^2 + 2 m r (r + 1) operations (the
// two symmetric Grams need only their upper triangles) against ~2 m n bytes
// of bf16 G (+ 8 m r of S and T): bound by operations at r = 1024.  The
// fp32 CUDA cores (67 TFLOP/s) bound it at 3.27 ms at llama-7b's (4096,
// 11008, r 1024) x 2, which the first design reached to 42%.
//
// Design: the bf16 tensor cores (hopper_mma.cuh's split-product `Engine`).
// S and T are fp32 whatever G is, so per chunk of the stack (scratch <= 256
// MiB) two memory-bound pre-passes split each into (chunk, 3, m, r_pad)
// exact bf16 terms (`split_bf16_kernel`).  Every product contracts over m,
// the rows of both operands, so both are staged MN-major (rows of 64 k's,
// the 128 outputs contiguous in 64-wide boxes):
//  - Gram tiles: X's three terms against Y's three, the 6 term products of
//    order >= 2^-16 of |X||Y| (the front end's S^T W,
//    grassmann_tangent_front.cu), for every G dtype;
//  - T^T G tiles with bf16 G: T's three terms against G's one exact term,
//    3 passes (grad_tap.cu's A = P^T dy with T in P's place); every bf16 x
//    bf16 product is exact in fp32, so only the fp32 sums round.  G is
//    staged MN-major by TMA where its rows are whole 16-byte words (route
//    `wgmma-tma`, the llama-7b shapes), K-major by TMA for a transposed
//    view (gsm = 1: w_down, embed; `wgmma-tma-kmajor`), and by the
//    producer warpgroup's element loads into the same layouts elsewhere
//    (rows of n = 5461 bf16, a base off 16 bytes; `wgmma-loads[-kmajor]`).
// Per 64-deep k-tile the passes start a fresh wgmma accumulator, which is
// flushed into fp32 totals: the tensor cores round at a k-tile's partial
// sum, and the dropped products are each <= 2^-24 of |X||Y|, so every
// output is as accurate as an fp32 GEMM (tests/test_torch_split.py).
//
// One persistent launch per chunk runs both kinds of tile: the two engines
// share one ring (96 KB slots, 2 stages; a T^T G stage is 64 KB), and CTAs
// take tiles from a counter in device memory, Gram tiles first (each is
// about twice a T^T G tile's work, so none runs alone at the end), then the
// T^T G tiles, r tile fastest (consecutive tiles share G's column block,
// read once from device memory; T's terms stay in L2).  At llama-7b x 2:
// 272 Gram tiles and 1376 T^T G tiles, ~12.5 waves of 132 SMs, no split
// over m needed.  The counter decides only which CTA takes a tile, never
// the order of a sum.
//
// fp32 G (on no card path): the T^T G tiles keep the CUDA cores
// (tile_gemm.cuh, a register-tiled fp32 SGEMM, one CTA per tile), as the
// fp32 routes of project, tangent and grad_tap do: fp32 G is not exact in
// one bf16 term.  Its Grams run on the engine as above (route
// `cuda-cores-ttg`).

#include "hopper_mma.cuh"
#include "tile_gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 G: T^T G on the CUDA cores
// ---------------------------------------------------------------------------

// One CTA per (r tile, n tile) of T^T G, grid z the matrix.
__global__ void __launch_bounds__(tile::kThreads, 2)
ttg_kernel(const float* __restrict__ T, const float* __restrict__ G, float* __restrict__ TtG,
           int m, int n, int r, long long gsb, long long gsm, long long gsn) {
  using namespace tile;
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int tiles_n = (n + kBN - 1) / kBN;
  const int c0 = (blockIdx.x / tiles_n) * kBM;
  const int j0 = (blockIdx.x % tiles_n) * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // left (k = i, row = c) is T[i, c]; right (k = i, row = j) is G[i, j]
  gemm(StridedTile<float>{T + (size_t)b * m * r, r, 1, c0, r, m},
       StridedTile<float>{G + b * gsb, gsm, gsn, j0, n, m}, m, as, bs, acc);
  float* out = TtG + (size_t)b * r * n;
  const int row = c0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= r) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < n) out[(size_t)(row + i) * n + col + j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// The engine: the Gram tiles, and T^T G with bf16 G
// ---------------------------------------------------------------------------

namespace wg {

using hopper::Engine;
using hopper::Operand;
using hopper::pass;

// T's lo, mid, hi against G's one term (terms 0 hi, 1 mid, 2 lo)
constexpr unsigned kTgPasses = pass(0, 2, 0) | pass(1, 1, 0) | pass(2, 0, 0);
// lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi: the 6 products >= 2^-16
constexpr unsigned kSixPasses = pass(0, 2, 0) | pass(1, 0, 2) | pass(2, 1, 1) | pass(3, 1, 0) |
                                pass(4, 0, 1) | pass(5, 0, 0);
constexpr int kSlot = 6 * 16384;  // a Gram stage (3 + 3 terms of 128 x 64): 96 KB
// T^T G: T's terms MN-major by TMA; G one term, K-major (kKG) or MN-major,
// by TMA (kTmaG) or element loads
template <bool kKG, bool kTmaG>
using TgEngine = Engine<3, 1, false, kKG, true, kTmaG, kTgPasses, 3, 64, !kTmaG, kSlot>;
// X^T Y: both operands' terms MN-major by TMA; the same slots and arrivals
// as the T^T G engine of its kernel
template <bool kAll>
using GramEngine = Engine<3, 3, false, false, true, true, kSixPasses, 6, 64, kAll, kSlot>;

// S's and T's terms (matrix z's first at plane 3 z; MN-major, 64 x 64
// boxes) and G (the whole stack, plane z0 + z, where it has a map).
struct Maps {
  CUtensorMap s, t, g;
};

// The operands and outputs of one chunk: G's element (i, j) of matrix b at
// G[b gsb + i gsm + j gsn]; outputs contiguous fp32.
struct Args {
  const unsigned short* G;
  long long gsb, gsm, gsn;
  float *TtG, *StT, *TtT, *StS;
  int m, n, r, z0;
};

// A tile of the chunk: kind 0 T^T G, 1 S^T T, 2 T^T T, 3 S^T S; matrix z;
// its first output row i0 and column j0.  Tiles 0 .. num_gram - 1 are the
// Grams (per matrix: every S^T T tile, then the upper tiles of T^T T and of
// S^T S), the rest T^T G (per matrix, r tile fastest).
struct Tile {
  int kind, z, i0, j0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_r, int tiles_n, int num_gram) {
  Tile x;
  if (t < num_gram) {
    const int upper = tiles_r * (tiles_r + 1) / 2;
    const int per = tiles_r * tiles_r + 2 * upper;
    x.z = t / per;
    int u = t - x.z * per;
    int a, c;
    if (u < tiles_r * tiles_r) {
      x.kind = 1;
      a = u / tiles_r;
      c = u % tiles_r;
    } else {
      u -= tiles_r * tiles_r;
      x.kind = 2 + u / upper;
      u %= upper;
      for (a = 0; u >= tiles_r - a; ++a) u -= tiles_r - a;
      c = a + u;
    }
    x.i0 = a * hopper::kEngM;
    x.j0 = c * hopper::kEngN;
    return x;
  }
  t -= num_gram;
  const int per = tiles_r * tiles_n;
  x.kind = 0;
  x.z = t / per;
  const int u = t - x.z * per;
  x.i0 = (u % tiles_r) * hopper::kEngM;
  x.j0 = (u / tiles_r) * hopper::kEngN;
  return x;
}

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// Persistent, one CTA per SM: the chunk's num_tiles tiles, handed out by a
// tile counter in device memory (zeroed before the launch).  The producer
// warpgroup takes a CTA's next tile and writes its index into the slot of
// that tile's first stage (-1 ends the CTA); the consumers read it once
// that stage is full.
template <bool kKG, bool kTmaG>
__global__ void __launch_bounds__(hopper::kEngThreads, 1)
tangent_gram_wgmma_kernel(const __grid_constant__ Maps maps, Args a,
                          unsigned* __restrict__ counter, int num_gram, int num_tiles) {
  constexpr bool kAll = !kTmaG;
  using TE = TgEngine<kKG, kTmaG>;
  using GE = GramEngine<kAll>;
  static_assert(TE::kStages == GE::kStages && TE::kSlot == GE::kSlot, "one ring");
  constexpr int kStages = GE::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int slot[kStages];
  __shared__ int next[2];
  const hopper::EngineSmem sm = hopper::engine_smem(smem_raw);
  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const int tiles_r = (a.r + hopper::kEngM - 1) / hopper::kEngM;
  const int tiles_n = (a.n + hopper::kEngN - 1) / hopper::kEngN;
  const int num_k = (a.m + GE::kDepth - 1) / GE::kDepth;

  if (tid == 0) GE::init(sm.full, sm.empty);
  __syncthreads();
  int it = 0;  // k-tiles through the ring so far

  if (wgi == hopper::kEngConsumers) {
    const int pt = tid - 128 * hopper::kEngConsumers;
    if (!kAll && pt != 0) return;
    for (int c = 0;; ++c) {
      if (pt == 0) next[c & 1] = c == 0 ? blockIdx.x : gridDim.x + atomicAdd(counter, 1u);
      if (kAll) producers_sync();
      const int t = next[c & 1];
      const int s = it % kStages;
      if (pt == 0) {
        hopper::mbar_wait(sm.empty + 8 * s, ((it / kStages) & 1) ^ 1);
        slot[s] = t < num_tiles ? t : -1;
      }
      if (t >= num_tiles) {  // the end: an empty stage whose slot says so
        if (pt == 0) hopper::mbar_expect_tx(sm.full + 8 * s, 0);
        if (kAll) hopper::mbar_arrive(sm.full + 8 * s);
        return;
      }
      const Tile x = tile_of(t, tiles_r, tiles_n, num_gram);
      const int plane = hopper::kSplitTerms * x.z;
      if (x.kind == 0) {
        const long long b = a.z0 + x.z;
        const Operand t_op{&maps.t, plane, nullptr, 0, 0, 0, 0};
        // G: element (k = i, x = j)
        const Operand g_op{&maps.g, (int)b, a.G + b * a.gsb, a.gsm, a.gsn, a.m, a.n};
        TE::produce(sm.smem, sm.base, sm.full, sm.empty, t_op, g_op, x.i0, x.j0, num_k, pt, it);
      } else {
        // X^T Y: X = S (S^T T, S^T S) or T (T^T T); Y = T (S^T T, T^T T) or S
        const Operand x_op{x.kind == 2 ? &maps.t : &maps.s, plane, nullptr, 0, 0, 0, 0};
        const Operand y_op{x.kind == 3 ? &maps.s : &maps.t, plane, nullptr, 0, 0, 0, 0};
        GE::produce(sm.smem, sm.base, sm.full, sm.empty, x_op, y_op, x.i0, x.j0, num_k, pt, it);
      }
    }
  }

  for (;;) {
    const int s = it % kStages;
    hopper::mbar_wait(sm.full + 8 * s, (it / kStages) & 1);
    const int t = slot[s];
    if (t < 0) return;
    const Tile x = tile_of(t, tiles_r, tiles_n, num_gram);
    float total[64];
    if (x.kind == 0)
      TE::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    else
      GE::consume(total, sm.base, sm.full, sm.empty, num_k, wgi, it);
    const long long b = a.z0 + x.z;
    const int row0 = x.i0 + 64 * wgi;
    if (x.kind <= 1) {  // T^T G (r, n) or S^T T (r, r): the tile as it is
      const int cols = x.kind == 0 ? a.n : a.r;
      float* o = (x.kind == 0 ? a.TtG : a.StT) + b * a.r * cols;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {  // columns gj, gj + 1 of one row
        const int gi = row0 + hopper::frag_row(i, tid);
        const int gj = x.j0 + hopper::frag_col(i, tid);
        if (gi >= a.r || gj >= cols) continue;
        const long long at = (long long)gi * cols + gj;
        if (gj + 1 < cols)
          hopper::store_pair(o, 0, at, 1, total[i], total[i + 1]);
        else
          o[at] = total[i];
      }
      continue;
    }
    // T^T T or S^T S: the tile and its mirror; on the diagonal tile its
    // upper triangle and that triangle's mirror
    float* o = (x.kind == 2 ? a.TtT : a.StS) + b * a.r * a.r;
    const bool diagonal = x.i0 == x.j0;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int gi = row0 + hopper::frag_row(i, tid);
      const int gj = x.j0 + hopper::frag_col(i, tid);
      if (gi >= a.r || gj >= a.r || (diagonal && gi > gj)) continue;
      o[(long long)gi * a.r + gj] = total[i];
      o[(long long)gj * a.r + gi] = total[i];
    }
  }
}

constexpr long long kScratchBudget = 256ll << 20;

long long align256(long long v) { return (v + 255) / 256 * 256; }

// The scratch: S's terms and T's terms of a chunk, (chunk, 3, m, r_pad)
// bf16 each, then the tile counter.
struct Layout {
  int r_pad, chunk;
  long long split_bytes;  // one matrix's terms of S (or of T)
  long long bytes;
};

Layout layout(int batch, int m, int r) {
  Layout l;
  l.r_pad = hopper::split_r_pad(r);
  l.split_bytes = 2ll * hopper::kSplitTerms * m * l.r_pad;
  const long long per = 2 * l.split_bytes;
  long long c = per > 0 ? kScratchBudget / per : batch;
  c = c < 1 ? 1 : (c > batch ? batch : c);
  l.chunk = (int)c;
  l.bytes = 2 * align256(l.chunk * l.split_bytes) + 256;
  return l;
}

// Routes reported to the caller (kCudaCores: fp32 G's T^T G tiles).
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLoads = 2, kKMajor = 4 };

template <bool kKG, bool kTmaG>
cudaError_t launch_tiles(const Maps& maps, const Args& a, unsigned* counter, int num_gram,
                         int num_tiles, cudaStream_t stream) {
  auto kernel = tangent_gram_wgmma_kernel<kKG, kTmaG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)hopper::kEngSmem);
  if (err != cudaSuccess) return err;
  const int grid = num_tiles < hopper::num_sms() ? num_tiles : hopper::num_sms();
  kernel<<<grid, hopper::kEngThreads, hopper::kEngSmem, stream>>>(maps, a, counter, num_gram,
                                                                  num_tiles);
  return cudaGetLastError();
}

cudaError_t launch(const float* S, const float* T, const void* G, float* TtG, float* StT,
                   float* TtT, float* StS, char* scratch, int dtype, int batch, int m, int n,
                   int r, long long gsb, long long gsm, long long gsn, int* route,
                   cudaStream_t stream) {
  // bf16 G: K-major for a transposed view (rows contiguous), else MN-major;
  // TMA where G has a tensor map
  const bool kmajor = gsm == 1 && gsn != 1;
  const bool tma = dtype == 1 && n > 0 && ((uintptr_t)G % 16 == 0) &&
                   (kmajor ? hopper::tma_stride_ok(2 * gsn)
                           : gsn == 1 && hopper::tma_stride_ok(2 * gsm)) &&
                   (batch == 1 || hopper::tma_stride_ok(2 * gsb));
  *route = dtype == 0 ? kCudaCores : (tma ? kWgmmaTma : kWgmmaLoads) | (kmajor ? kKMajor : 0);
  if (m == 0) {  // sums over no rows
    const size_t gram = sizeof(float) * (size_t)batch * r * r;
    cudaError_t err = cudaMemsetAsync(TtG, 0, sizeof(float) * (size_t)batch * r * n, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(StT, 0, gram, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(TtT, 0, gram, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(StS, 0, gram, stream);
    return err;
  }
  const long long tiles_r = (r + hopper::kEngM - 1) / hopper::kEngM;
  const long long tiles_n = (n + hopper::kEngN - 1) / hopper::kEngN;
  if (dtype == 0 && n > 0) {
    if (batch > 65535 || tiles_r * tiles_n > 0x7fffffffLL) return cudaErrorInvalidValue;
    const dim3 grid((unsigned)(tiles_r * tiles_n), 1, batch);
    ttg_kernel<<<grid, tile::kThreads, 0, stream>>>(T, static_cast<const float*>(G), TtG, m, n,
                                                    r, gsb, gsm, gsn);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const Layout l = layout(batch, m, r);
  char* s_split = scratch;
  char* t_split = s_split + align256(l.chunk * l.split_bytes);
  unsigned* counter = reinterpret_cast<unsigned*>(t_split + align256(l.chunk * l.split_bytes));
  const long long per_gram = tiles_r * tiles_r + tiles_r * (tiles_r + 1);
  const long long per_ttg = dtype == 1 ? tiles_r * tiles_n : 0;
  if ((per_gram + per_ttg) * l.chunk > 0x7fffffffLL - 2 * hopper::num_sms())
    return cudaErrorInvalidValue;
  Maps maps;
  if (tma) {
    const uint64_t d0 = kmajor ? m : n, d1 = kmajor ? n : m;
    const uint64_t s1 = 2ull * (kmajor ? gsn : gsm);
    const uint64_t s2 = batch == 1 ? (s1 * d1 + 15) / 16 * 16 : 2ull * gsb;
    // K-major: (64 k, 128 columns) boxes; MN-major: (64 columns, 64 k)
    if (!hopper::make_map(&maps.g, G, d0, d1, batch, s1, s2, kmajor ? 128 : 64))
      return cudaErrorInvalidValue;
  }
  for (int z0 = 0; z0 < batch; z0 += l.chunk) {
    const int chunk = batch - z0 < l.chunk ? batch - z0 : l.chunk;
    cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
    err = hopper::split_bf16(S + (size_t)z0 * m * r, s_split, chunk, m, r, stream);
    if (err != cudaSuccess) return err;
    err = hopper::split_bf16(T + (size_t)z0 * m * r, t_split, chunk, m, r, stream);
    if (err != cudaSuccess) return err;
    // (r_pad, m, 3 chunk), boxes of 64 columns x 64 rows
    if (!hopper::make_map(&maps.s, s_split, l.r_pad, m, 3ull * chunk, 2ull * l.r_pad,
                          2ull * l.r_pad * m, 64) ||
        !hopper::make_map(&maps.t, t_split, l.r_pad, m, 3ull * chunk, 2ull * l.r_pad,
                          2ull * l.r_pad * m, 64))
      return cudaErrorInvalidValue;
    if (!tma) maps.g = maps.s;  // unused by element loads and by fp32 G
    const Args a{static_cast<const unsigned short*>(G), gsb, gsm, gsn, TtG, StT, TtT, StS, m, n,
                 r, z0};
    const int num_gram = (int)(per_gram * chunk);
    const int num_tiles = (int)((per_gram + per_ttg) * chunk);
    if (dtype == 0 || (!kmajor && tma))
      err = launch_tiles<false, true>(maps, a, counter, num_gram, num_tiles, stream);
    else if (kmajor && tma)
      err = launch_tiles<true, true>(maps, a, counter, num_gram, num_tiles, stream);
    else if (kmajor)
      err = launch_tiles<true, false>(maps, a, counter, num_gram, num_tiles, stream);
    else
      err = launch_tiles<false, false>(maps, a, counter, num_gram, num_tiles, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace wg

}  // namespace

extern "C" {

// Bytes of scratch grassmann_tangent_gram_launch needs at these sizes.
long long grassmann_tangent_gram_scratch_bytes(int batch, int m, int r) {
  return wg::layout(batch, m, r).bytes;
}

// S, T (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; TtG (batch, r, n) and
// StT, TtT, StS (batch, r, r) fp32 contiguous; scratch
// grassmann_tangent_gram_scratch_bytes bytes.  Writes the route taken to
// *route (0: T^T G on the CUDA cores, fp32 G; 1: wgmma with G by TMA, 2:
// by element loads; + 4 when G is staged K-major, a transposed view).  The
// Grams run on the tensor cores for either dtype.  Launches on `stream`
// and returns the first launch error.
int grassmann_tangent_gram_launch(const float* S, const float* T, const void* G, float* TtG,
                                  float* StT, float* TtT, float* StS, void* scratch, int dtype,
                                  int batch, int m, int n, int r, long long gsb, long long gsm,
                                  long long gsn, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = wg::kCudaCores;
  if (batch == 0 || r == 0) return cudaSuccess;
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  return wg::launch(S, T, G, TtG, StT, TtT, StS, static_cast<char*>(scratch), dtype, batch, m, n,
                    r, gsb, gsm, gsn, route, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
