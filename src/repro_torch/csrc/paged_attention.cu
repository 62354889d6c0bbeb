// Paged-attention decode kernel for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `paged_attention` of
// src/repro/kernels/paged_attention.py (pallas_call at line 128, kernel body
// lines 45-84).  Same function, re-thought for the GPU rather than copied:
//
//   * One CTA per (KV head h, sequence b).  The TPU walked the table words
//     on a sequential grid axis with the softmax state in VMEM scratch;
//     here the loop over gathered positions runs inside the CTA and the
//     state (running max m, normaliser l, the (G, hd) accumulator) lives in
//     shared memory, all fp32.
//   * The TPU read the block table by scalar prefetch inside the BlockSpec
//     index map.  Here each CTA reads its own table words and computes the
//     pool offsets itself.  Positions are staged kTile at a time: position p
//     lives in table word p / bs at offset p % bs, so any block size works
//     and only words j < ceil(len / bs) are ever read (the TPU's
//     `pl.when(j * bs < length)`).  K and V rows go through shared memory
//     and are widened to fp32 there: with 16-byte loads where a row is a
//     whole number of 16-byte words (hd % 4 in fp32, hd % 8 in bf16) and the
//     arrays are 16-byte aligned, else one element per load (llama-1b's
//     hd 85), so any hd up to 256 works.
//   * GQA: query head h*G + g belongs to KV head h, so the G query rows of
//     one CTA are contiguous in q and in the output, and each K/V row is
//     read from device memory once for all G heads.
//   * Positions at or past `length` are never loaded; a lane of length 0
//     runs no step and writes acc / max(l, 1e-30) = exactly 0.
//   * A table word outside [0, nb) or a length past W * bs is not read:
//     that lane's output is NaN, so a broken table is loud, not silent.
//
// Bound on this card: decode attention is memory-bound.  Each CTA must read
// its sequence's `length` K and V rows of hd values once (plus q, the table
// words and the output, which are small); at G query heads per KV head it
// does about 4 * G flops per K/V element read, far below the H100's
// flop/byte balance.  So the least time is the owned K/V bytes over
// 3.35 TB/s.  This first version aims only at being right: one CTA per
// (b, h) leaves the card half idle at small batch, and the loads are
// synchronous.  Split-K across CTAs, TMA and an asynchronous copy ring are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // positions staged per step: one per lane in the softmax
constexpr float kNegInf = -1e30f;

static_assert(kTile == 32, "the softmax step maps one position to one lane");

// 16-byte vector loads of T widened to fp32, and the narrowing store.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static float one(const float* src) { return *src; }
  __device__ static float store(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static float one(const __nv_bfloat16* src) { return __bfloat162float(*src); }
  __device__ static __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
};

// kVec elements of a row widened to fp32: one 16-byte load (kWide) or one
// element.
template <typename T, bool kWide>
struct RowIo {
  static constexpr int kVec = kWide ? Io<T>::kVec : 1;
  __device__ static void load(const T* src, float* dst) {
    if constexpr (kWide) {
      Io<T>::load(src, dst);
    } else {
      dst[0] = Io<T>::one(src);
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

size_t smem_bytes(int G, int hd) {
  // q and acc (G, hd); K and V tiles (kTile, hd); p (G, kTile); m, l, corr (G)
  return sizeof(float) * ((size_t)2 * G * hd + (size_t)2 * kTile * hd +
                          (size_t)G * kTile + (size_t)3 * G);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out, int Hkv,
                       int G, int hd, int bs, int W, int nb, float scale) {
  using Row = RowIo<T, kWide>;
  constexpr int kVec = Row::kVec;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hdv = hd / kVec;

  extern __shared__ float smem[];
  float* q_s = smem;                // (G, hd)
  float* acc_s = q_s + G * hd;      // (G, hd)
  float* k_s = acc_s + G * hd;      // (kTile, hd)
  float* v_s = k_s + kTile * hd;    // (kTile, hd)
  float* p_s = v_s + kTile * hd;    // (G, kTile): logits, then probabilities
  float* m_s = p_s + G * kTile;     // (G) running max
  float* l_s = m_s + G;             // (G) running normaliser
  float* c_s = l_s + G;             // (G) this step's rescale of acc
  __shared__ int bad;

  const size_t q_row0 = (size_t)b * Hkv * G + (size_t)h * G;  // first query head
  const T* q_src = q + q_row0 * hd;
  for (int i = tid; i < G * hdv; i += kThreads) Row::load(q_src + i * kVec, q_s + i * kVec);
  for (int i = tid; i < G * hd; i += kThreads) acc_s[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  const int length = max(lengths[b], 0);
  if (tid == 0) bad = length > W * bs;
  __syncthreads();
  const int n = bad ? 0 : length;

  const int* table = tables + (size_t)b * W;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int rows = min(kTile, n - t0);

    // stage K/V rows t0 .. t0+rows-1 of the gathered sequence
    for (int i = tid; i < rows * hdv; i += kThreads) {
      const int r = i / hdv;
      const int c = (i - r * hdv) * kVec;
      const int p = t0 + r;
      const int blk = table[p / bs];
      float* kd = k_s + r * hd + c;
      float* vd = v_s + r * hd + c;
      if (blk < 0 || blk >= nb) {
        bad = 1;
#pragma unroll
        for (int e = 0; e < kVec; ++e) kd[e] = vd[e] = 0.f;
        continue;
      }
      const size_t off = (((size_t)blk * bs + p % bs) * Hkv + h) * hd + c;
      Row::load(k_pool + off, kd);
      Row::load(v_pool + off, vd);
    }
    __syncthreads();

    // logits (G, rows): one warp per staged row, lanes split hd
    for (int r = warp; r < rows; r += kWarps) {
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        for (int d = lane; d < hd; d += 32) s += q_s[g * hd + d] * k_s[r * hd + d];
        s = warp_sum(s);
        if (lane == 0) p_s[g * kTile + r] = s * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per staged row
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < rows ? p_s[g * kTile + lane] : kNegInf;
      const float m_prev = m_s[g];
      // rows >= 1, so m_new is a real logit and no exp sees -inf - -inf
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float pr = lane < rows ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(pr);
      p_s[g * kTile + lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    for (int i = tid; i < G * hd; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      float a = acc_s[i] * c_s[g];
      for (int r = 0; r < rows; ++r) a += p_s[g * kTile + r] * v_s[r * hd + d];
      acc_s[i] = a;
    }
    __syncthreads();  // the next step overwrites the K/V tiles and p
  }

  T* o = out + q_row0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    const float val = bad ? NAN : acc_s[i] / fmaxf(l_s[i / hd], 1e-30f);
    o[i] = Io<T>::store(val);
  }
}

template <typename T, bool kWide>
cudaError_t launch_rows(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                        const int* lengths, void* out, int B, int Hkv, int G, int hd, int bs,
                        int W, int nb, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_attention_kernel<T, kWide>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(Hkv, B);
  paged_attention_kernel<T, kWide><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), Hkv, G, hd, bs, W, nb, scale);
  return cudaGetLastError();
}

// 16-byte loads where every row starts on a 16-byte word, else scalar ones.
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* lengths, void* out, int B, int Hkv, int G, int hd, int bs, int W,
                   int nb, float scale, cudaStream_t stream) {
  const bool wide = hd % Io<T>::kVec == 0 &&
                    ((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool) % 16 == 0;
  if (wide)
    return launch_rows<T, true>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, hd, bs, W,
                                nb, scale, stream);
  return launch_rows<T, false>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, hd, bs, W,
                               nb, scale, stream);
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for G query heads per KV head at head dim hd.
size_t paged_attention_smem_bytes(int G, int hd) { return smem_bytes(G, hd); }

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q (B, Hkv*G, hd); pools
// (nb, bs, Hkv, hd); tables (B, W) int32; lengths (B,) int32; out like q.
// All contiguous, hd <= 256 (checked by the Python wrapper).  Launches on
// `stream`; returns the launch's error.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const int* tables, const int* lengths, void* out, int dtype, int B,
                           int Hkv, int G, int hd, int bs, int W, int nb, float scale,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hkv == 0) return cudaSuccess;
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, hd, bs, W, nb,
                           scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, B, Hkv, G, hd, bs,
                                   W, nb, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
