// project and project_colnorms for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces two Pallas TPU kernels of src/repro/kernels/grassmann.py:
//   project           (def line 117, pallas_call line 130): A = S^T G
//   project_colnorms  (def line 274, pallas_call line 290): A and ||G_:,j||^2
// One source serves both: `project` is `project_colnorms` without its
// norms, selected by the compile-time switch kNorms.  The TPU walks m on a
// sequential grid axis and accumulates the (r, bn) output block in VMEM;
// here one CTA owns one output tile and walks all of m itself, so no sum
// crosses CTAs and the output is deterministic.  Grid z is the matrix
// index, so one launch covers a whole layer stack.  G is a strided view
// (batch, row and column strides): the transposed canonical view of w_down
// or embed is read in place.  S and A are contiguous fp32.  The C entry
// picks the route by G's dtype, never as a fallback:
//
// bf16 G (the training path at llama-7b and llama-1b): tensor cores.
//   Bound on this card: at r = 1024 the product is far above the H100's
//   flop/byte balance (2 r m n flops against ~2 m n bytes of G), so it is
//   bound by operations, and fp32 CUDA cores (67 TFLOP/s) leave the bf16
//   tensor cores (989 TFLOP/s) idle.  G in bf16 is exact in bf16, so only
//   S needs care: a pre-split kernel writes S = S_hi + S_mid + S_lo as three
//   bf16 arrays, each the rounding of what the terms before it left (three
//   8-bit significands cover fp32's 24, so the split is exact for
//   orthonormal S), into a (batch, 3, m, r_pad) scratch with r padded to a
//   multiple of 64 with zeros.  Every bf16 x bf16 product is exact in fp32;
//   the only new error is the tensor cores' fp32 accumulation.  Main loop:
//   A_tile = sum_k S_k^T G by `wgmma.mma_async.m64n128k16.f32.bf16.bf16`,
//   three passes per staged 64-row slice of m sharing one G tile.  A CTA
//   owns a 128 x 128 tile of A (two consumer warpgroups of 64 rows) and a
//   producer warpgroup fills a 3-stage ring of (3 S tiles + 1 G tile) =
//   64 KB stages guarded by mbarriers.  Per 64-row k-tile the 12 wgmma
//   steps start a fresh accumulator, which is then added into an fp32
//   total in registers.  One accumulator over all of m, the first design,
//   rounded at the whole sum's size: 1.4e-5 of the largest entry at
//   llama-7b's shapes, which Adam's 1/sqrt(V) carried past the unfused
//   step's 1e-4 budget.  Accumulator and total (128 registers) fit the 168
//   a thread of 384 may hold at this tile, not at 128 x 256 (ptxas spilled
//   there, setmaxnreg or not).  The S tiles always come by TMA (128-byte
//   swizzle, M-major for wgmma's A operand).  G comes by TMA where its
//   tensor map exists (16-byte aligned base and non-unit strides): N-major
//   when its columns are contiguous, K-major (the other wgmma transpose
//   bit) when its rows are (gsm == 1, the transposed views).  Otherwise --
//   llama-1b's w_gate and w_up, rows of 5461 bf16 = 10,922 bytes -- the
//   producer warpgroup stages G by element loads into the same swizzled
//   layout.  The epilogue writes A through a masked store (ragged r and
//   n).  With the norm switch on, the first consumer warpgroup of the
//   first r tile also sums g^2 down its 128 columns, one column per
//   thread, from each G tile already in shared memory while that stage's
//   wgmmas run: no second read of G.  (A row of norm-only CTAs, one per
//   column tile, each held an SM's whole shared memory while it streamed
//   its columns of G: slower than summing the staged tiles.)
//
// fp32 G (an fp32 model): CUDA cores (tile_gemm.cuh), not exact in bf16.
//   A^T = G^T S as a register-tiled fp32 GEMM: one CTA per 128 x 128 tile
//   of A, S and G slices staged in shared memory, G widened on load; the
//   norm switch adds one row of CTAs that sum g^2 down 128 columns each.

#include "hopper_mma.cuh"
#include "tile_gemm.cuh"

namespace {

using namespace tile;

// ---------------------------------------------------------------------------
// fp32 G: CUDA cores
// ---------------------------------------------------------------------------

// sum_i G[i, j]^2 for the 128 columns from j0: two row groups of 128
// threads, one column per thread, added in shared memory at the end.
template <typename TG>
__device__ void column_norms(const TG* __restrict__ G, long long gsm, long long gsn, int m, int n,
                             int j0, float* __restrict__ gsq) {
  __shared__ float red[kThreads / kBN][kBN];
  const int c = threadIdx.x % kBN;
  const int grp = threadIdx.x / kBN;
  float sq = 0.f;
  if (j0 + c < n) {
    const TG* col = G + (long long)(j0 + c) * gsn;
    for (int i = grp; i < m; i += kThreads / kBN) {
      const float g = to_f32(col[i * gsm]);
      sq = fmaf(g, g, sq);
    }
  }
  red[grp][c] = sq;
  __syncthreads();
  if (grp == 0 && j0 + c < n) {
    float total = 0.f;
#pragma unroll
    for (int g = 0; g < kThreads / kBN; ++g) total += red[g][c];
    gsq[j0 + c] = total;
  }
}

template <typename TG, bool kNorms>
__global__ void __launch_bounds__(kThreads, 2)
project_kernel(const float* __restrict__ S, const TG* __restrict__ G, float* __restrict__ A,
               float* __restrict__ gsq, int m, int n, int r, long long gsb, long long gsm,
               long long gsn) {
  __shared__ __align__(16) float as[kBK][kLd];
  __shared__ __align__(16) float bs[kBK][kLd];
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * kBN;
  if (kNorms && blockIdx.y == gridDim.y - 1) {  // the norm row of CTAs
    column_norms(G + b * gsb, gsm, gsn, m, n, j0, gsq + (size_t)b * n);
    return;
  }
  const int r0 = blockIdx.y * kBM;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // left operand S^T: element (k = i, row = c) is S[i, c]; right operand G:
  // element (k = i, row = j) is G[i, j]
  gemm(StridedTile<float>{S + (size_t)b * m * r, r, 1, r0, r, m},
       StridedTile<TG>{G + b * gsb, gsm, gsn, j0, n, m}, m, as, bs, acc);

  float* out = A + (size_t)b * r * n;
  const int row = r0 + row_of_thread();
  const int col = j0 + col_of_thread();
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (row + i >= r) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (col + j < n) out[(size_t)(row + i) * n + col + j] = acc[i][j];
  }
}

template <typename TG, bool kNorms>
cudaError_t launch_cuda_cores(const float* S, const void* G, float* A, float* gsq, int batch,
                              int m, int n, int r, long long gsb, long long gsm, long long gsn,
                              cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (r + kBM - 1) / kBM + (kNorms ? 1 : 0), batch);
  project_kernel<TG, kNorms><<<grid, kThreads, 0, stream>>>(
      S, static_cast<const TG*>(G), A, gsq, m, n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 G: wgmma on S split into three bf16 terms
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kTerms = kSplitTerms;             // S_hi, S_mid, S_lo
constexpr int kBM = 128;                        // rows of A (r) per CTA
constexpr int kBN = 128;                        // columns of A (n) per CTA
constexpr int kBK = 64;                         // rows of S and G (m) per stage
constexpr int kStages = 3;
constexpr int kConsumers = 2;                   // warpgroups of 64 rows of A
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kBox = kBK * 64 * 2;              // 64 rows of 128 bytes: one TMA box
constexpr int kABytes = kTerms * (kBM / 64) * kBox;
constexpr int kBBytes = kBK * kBN * 2;
constexpr int kStageBytes = kABytes + kBBytes;  // 64 KB
constexpr int kRPad = kSplitRPad;               // r of the split scratch pads to this
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 1024 + 64;
constexpr int kLoadBatch = 32;                  // element loads in flight per producer thread


static_assert(kBN % 64 == 0 && kBK == 64, "a stage is whole 128-byte swizzle rows");
static_assert(kSmemBytes <= 232448, "one CTA per SM");
static_assert(kBN == 128, "one m64n128 accumulator per consumer warpgroup");

// Grid (r tiles, n tiles, batch).  kKMajorB: G is staged K-major (rows of
// m contiguous); kTmaB: G comes by TMA, else by element loads of the
// producer warpgroup; kNorms: the CTAs of the first r tile also sum g^2
// down their 128 columns from the staged G tiles (one column per thread of
// the first consumer warpgroup, while the stage's wgmmas run).
template <bool kKMajorB, bool kTmaB, bool kNorms>
__global__ void __launch_bounds__(kThreads, 1)
project_wgmma_kernel(const __grid_constant__ CUtensorMap s_map,
                     const __grid_constant__ CUtensorMap g_map, const __nv_bfloat16* __restrict__ G,
                     float* __restrict__ A, float* __restrict__ gsq, int m, int n, int r,
                     long long gsb, long long gsm, long long gsn) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // swizzle atoms: 1024-aligned
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kStages * kStageBytes;  // kStages mbarriers, then kStages more
  const uint32_t empty = full + 8 * kStages;

  const int b = blockIdx.z;
  const int j0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kBM;
  const int num_k = (m + kBK - 1) / kBK;
  const int wgi = tid / 128;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kTmaB ? 1 : 1 + 128);
      mbar_init(empty + 8 * s, 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == kConsumers) {
    // ---- producer warpgroup ----
    const int pt = tid - 128 * kConsumers;
    if (kTmaB && pt != 0) return;
    const __nv_bfloat16* Gb = G + b * gsb;
    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const uint32_t stage = base + s * kStageBytes;
      const uint32_t bstage = stage + kABytes;
      mbar_wait(empty + 8 * s, parity ^ 1);
      const int k0 = kt * kBK;
      if (pt == 0) {
        mbar_expect_tx(full + 8 * s, kTmaB ? kStageBytes : kABytes);
        for (int t = 0; t < kTerms; ++t)
          for (int h = 0; h < kBM / 64; ++h)
            tma_load(stage + (t * (kBM / 64) + h) * kBox, &s_map, full + 8 * s, r0 + 64 * h, k0,
                     b * kTerms + t);
        if (kTmaB) {
          if (kKMajorB) {
            tma_load(bstage, &g_map, full + 8 * s, k0, j0, b);
          } else {
            for (int nb = 0; nb < kBN / 64; ++nb)
              tma_load(bstage + nb * kBox, &g_map, full + 8 * s, j0 + 64 * nb, k0, b);
          }
        }
      }
      if (!kTmaB) {
        unsigned char* bs = smem + s * kStageBytes + kABytes;
        // element idx of the stage: (k, j) and its byte in the staged tile
        auto at = [&](int idx, int& k, int& j) -> uint32_t {
          if (kKMajorB) {  // row j of 64 k's: 128 bytes
            j = idx / kBK;
            k = idx % kBK;
            return swizzle(j * 128 + k * 2);
          }
          k = idx / kBN;  // 64-column boxes of kBK rows of 128 bytes
          j = idx % kBN;
          return (j / 64) * kBox + swizzle(k * 128 + (j % 64) * 2);
        };
#pragma unroll 1
        for (int i0 = 0; i0 < kBK * kBN; i0 += 128 * kLoadBatch) {
          unsigned short v[kLoadBatch];
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            int k, j;
            at(i0 + u * 128 + pt, k, j);
            const bool in = k0 + k < m && j0 + j < n;
            v[u] = in ? reinterpret_cast<const unsigned short*>(
                            Gb)[(long long)(k0 + k) * gsm + (long long)(j0 + j) * gsn]
                      : (unsigned short)0;
          }
#pragma unroll
          for (int u = 0; u < kLoadBatch; ++u) {
            int k, j;
            *reinterpret_cast<unsigned short*>(bs + at(i0 + u * 128 + pt, k, j)) = v[u];
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroups: rows r0 + 64 * wgi .. + 63 of A ----
    // Per k-tile, the 12 wgmma steps (3 terms x 4 slices of 16 rows, the
    // small terms first) start a fresh accumulator, which is then added into
    // an fp32 total: the tensor cores' accumulation rounds at one k-tile's
    // partial sum, never at the whole sum's size.
    float total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;
    float acc[64];
    // the first warpgroup of the first r tile also sums g^2 down column
    // j0 + tid of each staged G tile
    const bool norms = kNorms && blockIdx.x == 0 && tid < kBN;
    float nsq = 0.f;

    for (int kt = 0; kt < num_k; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      const uint32_t stage = base + s * kStageBytes;
      const uint32_t bstage = stage + kABytes;
      {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int t = kTerms - 1; t >= 0; --t) {  // smallest term first
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            // 16 rows of m: two 8-row swizzle atoms (SBO 1024) of the M-major S tile
            const uint64_t da =
                desc(stage + (t * (kBM / 64) + wgi) * kBox + kk * 2048, kBox, 1024);
            const int accumulate = t != kTerms - 1 || kk != 0;
            if (kKMajorB) {  // 128 rows of n, 8-row atoms; k advances 32 bytes in the row
              wgmma_128<0>(acc, da, desc(bstage + kk * 32, 16, 1024), accumulate);
            } else {         // two 64-column boxes (LBO) of rows of m (SBO per 8 rows)
              wgmma_128<1>(acc, da, desc(bstage + kk * 2048, kBox, 1024), accumulate);
            }
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (norms) {  // while the tensor cores run: this thread's column of G
          const unsigned char* bs = smem + s * kStageBytes + kABytes;
          if (kKMajorB) {  // row tid of the tile: 8 chunks of 8 k's
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const uint4 w =
                  *reinterpret_cast<const uint4*>(bs + tid * 128 + ((c ^ (tid & 7)) << 4));
              const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(p2[i]);
                nsq = fmaf(f.x, f.x, nsq);
                nsq = fmaf(f.y, f.y, nsq);
              }
            }
          } else {  // column tid % 64 of box tid / 64, rows 0..kBK-1
            const unsigned char* box = bs + (tid / 64) * kBox;
#pragma unroll 8
            for (int k = 0; k < kBK; ++k) {
              const float g = __bfloat162float(
                  *reinterpret_cast<const __nv_bfloat16*>(box + swizzle(k * 128 + (tid % 64) * 2)));
              nsq = fmaf(g, g, nsq);
            }
          }
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operands(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) total[i] += acc[i];
      }
      mbar_arrive(empty + 8 * s);
    }

    if (norms && j0 + tid < n) gsq[(size_t)b * n + j0 + tid] = nsq;

    // masked store of the 64 x 128 total (wgmma's m64nN fragment)
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int row0 = r0 + 64 * wgi + 16 * warp + lane / 4;
    float* out = A + (size_t)b * r * n;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row0 + ((i & 2) ? 8 : 0);
      const int col = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      if (row < r && col < n) out[(size_t)row * n + col] = total[i];
    }
  }
}

template <bool kK, bool kTma, bool kNorms>
cudaError_t launch_kernel(const CUtensorMap& s_map, const CUtensorMap& g_map, const void* G,
                          float* A, float* gsq, int batch, int m, int n, int r, long long gsb,
                          long long gsm, long long gsn, cudaStream_t stream) {
  auto kernel = project_wgmma_kernel<kK, kTma, kNorms>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((r + kBM - 1) / kBM, (n + kBN - 1) / kBN, batch);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(s_map, g_map,
                                                 static_cast<const __nv_bfloat16*>(G), A, gsq, m,
                                                 n, r, gsb, gsm, gsn);
  return cudaGetLastError();
}

template <bool kNorms>
cudaError_t dispatch(bool kmajor, bool tma, const CUtensorMap& s_map, const CUtensorMap& g_map,
                         const void* G, float* A, float* gsq, int batch, int m, int n, int r,
                         long long gsb, long long gsm, long long gsn, cudaStream_t stream) {
  if (kmajor && tma)
    return launch_kernel<true, true, kNorms>(s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm,
                                             gsn, stream);
  if (kmajor)
    return launch_kernel<true, false, kNorms>(s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm,
                                              gsn, stream);
  if (tma)
    return launch_kernel<false, true, kNorms>(s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm,
                                              gsn, stream);
  return launch_kernel<false, false, kNorms>(s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm,
                                             gsn, stream);
}

// Routes reported to the caller.
enum Route { kCudaCores = 0, kWgmmaTma = 1, kWgmmaLoads = 2, kKMajor = 4 };

cudaError_t launch_bf16(const float* S, const void* G, float* A, float* gsq, void* scratch,
                        int norms, int batch, int m, int n, int r, long long gsb, long long gsm,
                        long long gsn, int* route, cudaStream_t stream) {
  const bool kmajor = gsm == 1 && gsn != 1;
  const bool tma = ((uintptr_t)G % 16 == 0) && (kmajor ? gsm == 1 && tma_stride_ok(2 * gsn)
                                                       : gsn == 1 && tma_stride_ok(2 * gsm)) &&
                   (batch == 1 || tma_stride_ok(2 * gsb));
  *route = (tma ? kWgmmaTma : kWgmmaLoads) | (kmajor ? kKMajor : 0);
  if (m == 0) {  // an empty sum: A = 0, norms 0
    cudaError_t err = cudaMemsetAsync(A, 0, sizeof(float) * (size_t)batch * r * n, stream);
    if (err == cudaSuccess && norms)
      err = cudaMemsetAsync(gsq, 0, sizeof(float) * (size_t)batch * n, stream);
    return err;
  }
  cudaError_t err = split_bf16(S, scratch, batch, m, r, stream);
  if (err != cudaSuccess) return err;
  const int r_pad = (r + kRPad - 1) / kRPad * kRPad;
  CUtensorMap s_map, g_map;
  if (!make_map(&s_map, scratch, r_pad, m, (uint64_t)batch * kTerms, 2ull * r_pad,
                2ull * r_pad * m, 64))
    return cudaErrorInvalidValue;
  g_map = s_map;  // unused by the element-load producer
  if (tma) {
    const uint64_t d0 = kmajor ? m : n, d1 = kmajor ? n : m;
    const uint64_t s1 = 2ull * (kmajor ? gsn : gsm);
    const uint64_t s2 = batch == 1 ? (s1 * d1 + 15) / 16 * 16 : 2ull * gsb;
    if (!make_map(&g_map, G, d0, d1, batch, s1, s2, kmajor ? kBN : kBK))
      return cudaErrorInvalidValue;
  }
  if (norms)
    return dispatch<true>(kmajor, tma, s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm, gsn,
                              stream);
  return dispatch<false>(kmajor, tma, s_map, g_map, G, A, gsq, batch, m, n, r, gsb, gsm, gsn,
                             stream);
}

}  // namespace wg

}  // namespace

extern "C" {

// S (batch, m, r) fp32 contiguous; G (batch, m, n) with element strides
// (gsb, gsm, gsn), dtype 0 = float32, 1 = bfloat16; A (batch, r, n) fp32
// contiguous; gsq (batch, n) fp32 or NULL when norms == 0; scratch (batch,
// 3, m, grassmann_project_r_pad(r)) bf16 for dtype 1 (unused for dtype 0).
// Writes the route taken to *route (0 CUDA cores, 1 wgmma with the TMA
// producer, 2 wgmma with the element-load producer; + 4 when G is staged
// K-major).  Launches on `stream` and returns the first launch error.
int grassmann_project_launch(const float* S, const void* G, float* A, float* gsq, void* scratch,
                             int dtype, int norms, int batch, int m, int n, int r, long long gsb,
                             long long gsm, long long gsn, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = wg::kCudaCores;
  if (batch == 0 || n == 0 || r == 0) return cudaSuccess;
  if (batch > 65535 || r > 65534 * kBM || n > 65535 * wg::kBN) return cudaErrorInvalidValue;
  if (dtype == 0 && norms)
    return launch_cuda_cores<float, true>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 0)
    return launch_cuda_cores<float, false>(S, G, A, gsq, batch, m, n, r, gsb, gsm, gsn, s);
  if (dtype == 1)
    return wg::launch_bf16(S, G, A, gsq, scratch, norms, batch, m, n, r, gsb, gsm, gsn, route, s);
  return cudaErrorInvalidValue;
}

// The padded r of the split scratch.
int grassmann_project_r_pad(int r) { return (r + wg::kRPad - 1) / wg::kRPad * wg::kRPad; }

// S (batch, m, r) fp32 -> out (batch, 3, m, r_pad) bf16, the split alone
// (the first kernel of a bf16 launch).
int grassmann_split_bf16_launch(const float* S, void* out, int batch, int m, int r,
                                void* stream) {
  if (batch == 0 || m == 0) return cudaSuccess;
  return hopper::split_bf16(S, out, batch, m, r, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
