// Hopper (sm_90a) machinery shared by the port's tensor-core kernels.
//
// Two parts:
//
// 1. The helpers: shared-memory addresses, mbarriers, TMA loads and
//    tensor maps (3-D and 4-D, 128-byte swizzle), wgmma descriptors, the
//    m64n128k16 bf16 wgmma, flash_attention.cu's m64n64k16 (both operands
//    in shared memory) and m64nNk16 with A in registers, and the exact
//    three-term bf16 split of an fp32 matrix (x = hi + mid + lo, each term
//    the round-to-nearest bf16 of what the terms before it left; three
//    8-bit significands hold fp32's 24).  grassmann_project.cu,
//    grassmann_tangent.cu, grassmann_tangent_front.cu, grassmann_backproject.cu,
//    grassmann_tangent_gram.cu, fused_update.cu, grad_tap.cu and
//    flash_attention.cu include them.
//
// 2. The split-product tile engine (`Engine`), the main loop of
//    fused_update.cu, grad_tap.cu, grassmann_tangent.cu,
//    grassmann_tangent_front.cu's tail, grassmann_backproject.cu and
//    grassmann_tangent_gram.cu: one CTA owns a
//    128 x 128 fp32 output tile C = sum over K of A (128 x K) B (K x 128),
//    where A and B each come as 1 or 3 bf16 terms and a compile-time list
//    of term pairs ("passes") says which products of terms enter the sum.
//    Two consumer warpgroups own 64 rows of C each; a producer warpgroup
//    fills a ring of stages (all the terms of A and B for one k-tile, 64
//    or 128 deep) by TMA, or, for a one-term operand without a tensor map,
//    by element loads into the same swizzled layout.  The ring position runs on across tiles, so a
//    persistent CTA's producer fills its next tile's stages while the
//    consumers finish the last.  Per k-tile the passes start a fresh wgmma
//    accumulator, which is then added into an fp32 total in registers, so
//    the tensor cores round at one k-tile's partial sum, never at the whole
//    sum's size (grassmann_project.cu found one accumulator over all of K
//    too coarse).  Each operand is staged MN-major (rows of 64 k's apart,
//    the 128 outputs contiguous in 64-wide boxes) or K-major (128 rows of
//    64 contiguous k's), the two wgmma transpose bits.  Two engines whose
//    stages differ share one ring through a common slot size, and a second
//    contraction may add onto the first's totals (grassmann_tangent.cu:
//    G A^T, then S (2C)).  The caller writes the epilogue from the totals;
//    `frag_row` / `frag_col` give each total's place in the tile.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// 1. Helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// A wait that never completes (a copy that never lands) traps after ~2^32
// clocks (about two seconds) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)1 << 62);
}

// byte offset of a 128-byte swizzled row layout (TMA's SWIZZLE_128B)
__device__ __forceinline__ uint32_t swizzle(uint32_t off) { return off ^ (((off >> 7) & 7) << 4); }

#define HOPPER_WG_F8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) = A (64 x 16) * B (16 x 128) [+ d if accumulate],
// both bf16 in shared memory; kTransB = 1 for an N-major B, 0 for a K-major
// B; kTransA = 1 for an M-major A, 0 for a K-major A.
template <int kTransB, int kTransA = 1>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : HOPPER_WG_F8(0), HOPPER_WG_F8(8), HOPPER_WG_F8(16), HOPPER_WG_F8(24), HOPPER_WG_F8(32),
        HOPPER_WG_F8(40), HOPPER_WG_F8(48), HOPPER_WG_F8(56)
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 64, fp32) = A (64 x 16) * B (16 x 64) [+ d], both bf16 in shared
// memory and K-major (flash_attention.cu's S = Q K^T).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_WG_F8(0), HOPPER_WG_F8(8), HOPPER_WG_F8(16), HOPPER_WG_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, fp32; its first N / 2 registers) += A (64 x 16) * B (16 x N),
// N = 16, 32, 48 or 64: A bf16 in registers (wgmma's A fragment: four
// words of two bf16 each), B bf16 in shared memory, N-major (the transpose
// bit) -- flash_attention.cu's O += P V with V's rows of hd contiguous.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64, "N of 16, 32, 48 or 64");
  if constexpr (N == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HOPPER_WG_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HOPPER_WG_F8(0), HOPPER_WG_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : HOPPER_WG_F8(0), HOPPER_WG_F8(8), HOPPER_WG_F8(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_WG_F8(0), HOPPER_WG_F8(8), HOPPER_WG_F8(16), HOPPER_WG_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
}
#undef HOPPER_WG_F8

template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x = hi + mid + lo: each term the round-to-nearest bf16 of what the terms
// before it left.  Exact for x in bf16's normal range (a lo term below it
// loses at most 2^-133 absolute).
__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float rest = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(rest);
  lo = __float2bfloat16_rn(rest - __bfloat162float(mid));
}

constexpr int kSplitTerms = 3;   // S_hi, S_mid, S_lo
constexpr int kSplitRPad = 64;   // r of a split S pads to this (wgmma's M)

__host__ __device__ constexpr int split_r_pad(int r) {
  return (r + kSplitRPad - 1) / kSplitRPad * kSplitRPad;
}

// S (batch, m, r) fp32 -> (batch, 3, m, r_pad) bf16: hi, mid, lo; columns
// past r 0.
__global__ void split_bf16_kernel(const float* __restrict__ S, __nv_bfloat16* __restrict__ out,
                                  int m, int r, int r_pad, long long total) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / r_pad;  // b * m + k
    const int c = (int)(i - row * r_pad);
    const long long b = row / m;
    const float x = c < r ? S[row * r + c] : 0.f;
    __nv_bfloat16 hi, mid, lo;
    split3(x, hi, mid, lo);
    const long long plane = (long long)m * r_pad;
    const long long o = (b * kSplitTerms) * plane + (row - b * m) * r_pad + c;
    out[o] = hi;
    out[o + plane] = mid;
    out[o + 2 * plane] = lo;
  }
}

inline cudaError_t split_bf16(const float* S, void* out, int batch, int m, int r,
                              cudaStream_t stream) {
  const int r_pad = split_r_pad(r);
  const long long total = (long long)batch * m * r_pad;
  if (total == 0) return cudaSuccess;
  const long long blocks = (total + 255) / 256;
  split_bf16_kernel<<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, stream>>>(
      S, static_cast<__nv_bfloat16*>(out), m, r, r_pad, total);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime: the library links no libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 map (d0 contiguous) with a 128-byte swizzled box (64, box1, 1).
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t stride1, uint64_t stride2, uint32_t box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {stride1, stride2};
  const cuuint32_t box[3] = {64, box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-D bf16 map (d[0] contiguous; strides[i] the bytes between steps of
// d[i + 1]) with a 128-byte swizzled box (64, box[1], box[2], box[3]);
// elements past the dims read as zero.
inline bool make_map_4d(CUtensorMap* map, const void* ptr, const uint64_t (&d)[4],
                        const uint64_t (&strides)[3], const uint32_t (&box)[4]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {d[0], d[1], d[2], d[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, st, bx, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool tma_stride_ok(long long bytes) {
  return bytes > 0 && bytes % 16 == 0 && bytes < (1LL << 40);
}

// SMs of the current device: the grid of a persistent launch.
inline int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// ---------------------------------------------------------------------------
// 2. The split-product tile engine
// ---------------------------------------------------------------------------

constexpr int kEngM = 128;                      // rows of C per CTA
constexpr int kEngN = 128;                      // columns of C per CTA
constexpr int kEngConsumers = 2;                // warpgroups of 64 rows of C
constexpr int kEngThreads = 128 * (kEngConsumers + 1);  // + the producer warpgroup
constexpr int kEngRing = 192 * 1024;            // the stages' bytes
constexpr int kEngMaxStages = 8;
constexpr size_t kEngSmem = (size_t)kEngRing + 1024 + 16 * kEngMaxStages;
constexpr int kEngLoadBatch = 32;               // element loads in flight per producer thread

static_assert(kEngSmem <= 232448 - 4096, "one CTA per SM, with room for a small static array");

// Term pair p of a pass list: (A term, B term) in bits 4p .. 4p + 3.
__host__ __device__ constexpr unsigned pass(int p, int a_term, int b_term) {
  return (unsigned)(a_term | (b_term << 2)) << (4 * p);
}

// Where one operand comes from.  TMA: `map` with this matrix's first term
// at plane `plane` (its third coordinate); an MN-major map has dims
// (outputs, k, planes) and a (64, kK) box, a K-major one (k, outputs,
// planes) and a (64, 128) box.  Element loads (one term only): element
// (k, x) at p[k * sk + x * sx], zero past (k_ext, x_ext).
struct Operand {
  const CUtensorMap* map;
  int plane;
  const unsigned short* p;
  long long sk, sx;
  int k_ext, x_ext;
};

// The row (of the warpgroup's 64) and column (of 128) of total[i] in this
// thread (wgmma's m64nN fragment).
__device__ __forceinline__ int frag_row(int i, int tid) {
  return 16 * ((tid % 128) / 32) + (tid % 32) / 4 + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int i, int tid) {
  return 8 * (i / 4) + 2 * (tid % 4) + (i & 1);
}

// Consumer-only barrier (the producer warpgroup leaves early).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kEngConsumers) : "memory");
}

// kTA / kTB: terms of A and B; kKA / kKB: K-major staging; kTmaA / kTmaB:
// TMA, else element loads; kPasses term pairs in kPassCode, smallest first;
// kK: the depth of a k-tile (64; 128 where both operands are MN-major).
// kArriveAll: every producer thread arrives on a stage's full barrier
// (needed by element loads; two engines that share one ring in a kernel
// set it alike).  kSlotBytes: the ring's slot per stage, 0 for the
// engine's own stage; two engines whose stages differ share one ring by
// giving both the larger stage as their slot (same slots, same count).
template <int kTA, int kTB, bool kKA, bool kKB, bool kTmaA, bool kTmaB, unsigned kPassCode,
          int kPasses, int kK = 64, bool kArriveAll = !kTmaA || !kTmaB, int kSlotBytes = 0>
struct Engine {
  static constexpr int kDepth = kK;
  static constexpr int kBox = kK * 128;   // one 64-wide MN box of kK rows of 128 bytes
  static constexpr int kTerm = 2 * kBox;  // one 128 x kK bf16 operand term
  static constexpr int kStageA = kTA * kTerm;
  static constexpr int kStageB = kTB * kTerm;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kSlot = kSlotBytes ? kSlotBytes : kStage;
  static constexpr int kStages =
      kEngRing / kSlot < kEngMaxStages ? kEngRing / kSlot : kEngMaxStages;
  static_assert(kSlot >= kStage && kSlot % 1024 == 0, "a slot holds a stage, 1024-aligned");
  static constexpr uint32_t kTx = (kTmaA ? kStageA : 0) + (kTmaB ? kStageB : 0);
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert((kTmaA || kTA == 1) && (kTmaB || kTB == 1), "element loads stage one term");
  static_assert(kArriveAll || (kTmaA && kTmaB), "element loads arrive from every thread");
  static_assert(kK == 64 || (kK == 128 && !kKA && !kKB), "K-major rows are 128 bytes");

  // by one thread, before the CTA's __syncthreads
  __device__ static void init(uint32_t full, uint32_t empty) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, kArriveAll ? 1 + 128 : 1);
      mbar_init(empty + 8 * s, 128 * kEngConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  template <int kT, bool kKMaj>
  __device__ static void tma_operand(uint32_t dst, const Operand& op, uint32_t bar, int k0,
                                     int x0) {
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (kKMaj) {
        tma_load(dst + t * kTerm, op.map, bar, k0, x0, op.plane + t);
      } else {
        tma_load(dst + t * kTerm, op.map, bar, x0, k0, op.plane + t);
        tma_load(dst + t * kTerm + kBox, op.map, bar, x0 + 64, k0, op.plane + t);
      }
    }
  }

  // one term by the 128 producer threads, into the layout TMA would write
  template <bool kKMaj>
  __device__ static void load_operand(unsigned char* dst, const Operand& op, int k0, int x0,
                                      int pt) {
    auto at = [&](int idx, int& k, int& x) -> uint32_t {
      if (kKMaj) {  // row x of 64 k's: 128 bytes
        x = idx / kK;
        k = idx % kK;
        return swizzle(x * 128 + k * 2);
      }
      k = idx / kEngN;  // 64-column boxes of kK rows of 128 bytes
      x = idx % kEngN;
      return (x / 64) * kBox + swizzle(k * 128 + (x % 64) * 2);
    };
#pragma unroll 1
    for (int i0 = 0; i0 < kK * kEngN; i0 += 128 * kEngLoadBatch) {
      unsigned short v[kEngLoadBatch];
#pragma unroll
      for (int u = 0; u < kEngLoadBatch; ++u) {
        int k, x;
        at(i0 + u * 128 + pt, k, x);
        const bool in = k0 + k < op.k_ext && x0 + x < op.x_ext;
        v[u] = in ? op.p[(long long)(k0 + k) * op.sk + (long long)(x0 + x) * op.sx]
                  : (unsigned short)0;
      }
#pragma unroll
      for (int u = 0; u < kEngLoadBatch; ++u) {
        int k, x;
        *reinterpret_cast<unsigned short*>(dst + at(i0 + u * 128 + pt, k, x)) = v[u];
      }
    }
  }

  // The producer warpgroup (pt = its thread 0..127) for one tile: A's rows
  // from xa, B's columns from xb, num_k k-tiles.  `it` counts the k-tiles
  // the CTA has staged so far (the ring position), so a CTA that walks
  // several tiles fills the next tile's stages while its consumers finish
  // the last one.
  __device__ static void produce(unsigned char* smem, uint32_t base, uint32_t full,
                                 uint32_t empty, const Operand& a, const Operand& b, int xa,
                                 int xb, int num_k, int pt, int& it) {
    if (!kArriveAll && pt != 0) return;
    for (int kt = 0; kt < num_k; ++kt, ++it) {
      const int s = it % kStages;
      const uint32_t stage = base + s * kSlot;
      mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
      const int k0 = kt * kK;
      if (pt == 0) {
        mbar_expect_tx(full + 8 * s, kTx);
        if (kTmaA) tma_operand<kTA, kKA>(stage, a, full + 8 * s, k0, xa);
        if (kTmaB) tma_operand<kTB, kKB>(stage + kStageA, b, full + 8 * s, k0, xb);
      }
      if (kArriveAll) {
        if (!kTmaA) load_operand<kKA>(smem + s * kSlot, a, k0, xa, pt);
        if (!kTmaB) load_operand<kKB>(smem + s * kSlot + kStageA, b, k0, xb, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        mbar_arrive(full + 8 * s);
      }
    }
  }

  // A consumer warpgroup (wgi 0 or 1): its 64 rows of one tile of C as
  // fp32 totals (added to `total` as it stands when `zero` is false: a
  // second contraction into the same tile); `it` as in produce.
  __device__ static void consume(float (&total)[64], uint32_t base, uint32_t full,
                                 uint32_t empty, int num_k, int wgi, int& it, bool zero = true) {
    if (zero) {
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] = 0.f;
    }
    float acc[64];
    for (int kt = 0; kt < num_k; ++kt, ++it) {
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      // the warpgroup's 64 rows of A: box wgi (MN-major) or rows 64 wgi on
      // (K-major, 128-byte rows: the same offset at kK = 64)
      const uint32_t sa = base + s * kSlot + wgi * kBox;
      const uint32_t sb = base + s * kSlot + kStageA;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int ta = (kPassCode >> (4 * p)) & 3;
        const int tb = (kPassCode >> (4 * p + 2)) & 3;
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk) {
          // K-major: 8-row atoms (SBO 1024), k advances 32 bytes in the row;
          // MN-major: 64-wide boxes (LBO) of k rows, 16 rows per step
          const uint64_t da = kKA ? desc(sa + ta * kTerm + kk * 32, 16, 1024)
                                  : desc(sa + ta * kTerm + kk * 2048, kBox, 1024);
          const uint64_t db = kKB ? desc(sb + tb * kTerm + kk * 32, 16, 1024)
                                  : desc(sb + tb * kTerm + kk * 2048, kBox, 1024);
          wgmma_128<kKB ? 0 : 1, kKA ? 0 : 1>(acc, da, db, p != 0 || kk != 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
      mbar_arrive(empty + 8 * s);
    }
  }
};

// The engine's shared memory: 1024-aligned ring, then the full and empty
// mbarriers.
struct EngineSmem {
  unsigned char* smem;
  uint32_t base, full, empty;
};

__device__ __forceinline__ EngineSmem engine_smem(unsigned char* raw_ptr) {
  const uint32_t raw = smem_addr(raw_ptr);
  EngineSmem e;
  e.smem = raw_ptr + (((raw + 1023) & ~1023u) - raw);  // swizzle atoms: 1024-aligned
  e.base = smem_addr(e.smem);
  e.full = e.base + kEngRing;
  e.empty = e.full + 8 * kEngMaxStages;
  return e;
}

// Elements i and i + step of a bf16 (dtype 1) or fp32 (dtype 0) array:
// one 4- or 8-byte access where the two are adjacent and aligned, else two.
__device__ __forceinline__ float2 load_pair(const void* p, int dtype, long long i,
                                            long long step) {
  if (dtype) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + i;
    if (step == 1 && (reinterpret_cast<uintptr_t>(q) & 3) == 0)
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(q));
    return make_float2(__bfloat162float(q[0]), __bfloat162float(q[step]));
  }
  const float* q = static_cast<const float*>(p) + i;
  if (step == 1 && (reinterpret_cast<uintptr_t>(q) & 7) == 0)
    return *reinterpret_cast<const float2*>(q);
  return make_float2(q[0], q[step]);
}
__device__ __forceinline__ void store_pair(void* p, int dtype, long long i, long long step,
                                           float v0, float v1) {
  if (dtype) {
    __nv_bfloat16* q = static_cast<__nv_bfloat16*>(p) + i;
    if (step == 1 && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
      *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(v0, v1);
    } else {
      q[0] = __float2bfloat16(v0);
      q[step] = __float2bfloat16(v1);
    }
    return;
  }
  float* q = static_cast<float*>(p) + i;
  if (step == 1 && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
    *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
  } else {
    q[0] = v0;
    q[step] = v1;
  }
}

// One float of a bf16 (dtype 1) or fp32 (dtype 0) array.
__device__ __forceinline__ float load_float(const void* p, int dtype, long long i) {
  return dtype ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
               : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_float(void* p, int dtype, long long i, float v) {
  if (dtype)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

}  // namespace hopper
