// Flash attention (forward) for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (def line 85, pallas_call line 109;
// body `_kernel`, line 38), with its semantics:
//
//   * q (B, S, Hq, hd), k and v (B, T, Hkv, hd), out (B, S, Hq, hd) in q's
//     dtype; query head h reads KV head h / (Hq / Hkv) (GQA, MQA);
//   * logits = (q . k) / sqrt(hd); with a softcap c, c tanh(logits / c),
//     applied before masking;
//   * masks with both positions counted from 0 (top-left aligned when
//     S != T): causal k <= q, window k > q - window (also without causal);
//     a masked logit is -1e30, not -inf, and the running max starts at
//     -1e30, so a row that no key may see averages all T values, as the
//     TPU kernel's does;
//   * everything in fp32, P included: the TPU kernel widens v to fp32
//     before `p.astype(v.dtype)`, so P V is an fp32 product (unlike the jnp
//     `blocked_attention`, which rounds P to v's dtype).
//
// Design.  The TPU walks KV blocks on a sequential grid axis with the
// softmax statistics and the accumulator in VMEM scratch.  Here one CTA of
// 256 threads owns (batch b, query head h, 64 query rows) and loops over
// 64-key tiles of K and V itself:
//
//   * the Q tile is staged once in shared memory, widened to fp32; each K
//     tile, then each V tile, is staged through one shared buffer (rows of
//     hd, padded to a multiple of 64 with zeros), with 16-byte loads where a
//     row is a whole number of 16-byte words and the arrays are aligned,
//     else one element per load (llama-1b's hd 85, stablelm-12b's 160 in
//     bf16 is whole words);
//   * thread (ty, tx) of a 16 x 16 grid computes the 4 x 4 logits of query
//     rows 4 ty .. 4 ty + 3 and keys tx + 16 j, in fp32 on CUDA cores (4-wide
//     shared loads along hd); the 16 threads of a row are one half-warp, so
//     the row max and sum are shuffles;
//   * the running max and sum of each row and its 64 x hd accumulator stay
//     in registers (4 rows x 4 hd/64 columns per thread); P goes through
//     shared memory (key-major) to the P V product;
//   * KV tiles wholly outside the causal / window band of all the CTA's
//     rows are not visited (skipping them changes nothing: a fully masked
//     tile's weights are multiplied by exp(-1e30 - m) = 0 at the next real
//     logit).  A CTA holding a row that no key may see (window > 0, q >=
//     T - 1 + window) visits every tile, so that row gets the TPU's mean;
//   * keys at or past T are not keys (weight exactly 0) and query rows past
//     S are not stored: any S and T work (the TPU's S % bq is a tiling
//     limit).
//
// Bound on this card.  4 hd flops per visible (query, key) pair against
// (Q + K + V + O) bytes read and written once: at llama-7b's prefill shape
// (S = T = 2048, causal, hd 128) ~350 flops per byte, so even at the bf16
// tensor cores' 989 TFLOP/s the work is bound by operations.  This first
// version runs the products in fp32 on CUDA cores (67 TFLOP/s): exact in
// its products, ~15x off the tensor-core bound by construction.  mma/wgmma
// for Q K^T (bf16 products are exact in fp32) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16: thread (ty, tx) owns rows 4 ty .. 4 ty + 3
constexpr int kLdP = kBQ + 4; // P^T row: 16-byte aligned, rows 4 banks apart
constexpr float kMasked = -1e30f;

static_assert(kBQ == 64 && kBK == 64 && kThreads == 256, "the 16 x 16 x (4 x 4) map");

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
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

// Stage rows row0 .. row0 + 63 of a (rows, hd) operand whose row i starts at
// src + i * stride, widened to fp32, into dst[r * ld + d]; rows at or past
// `limit` and the columns hd .. ld - 5 are zero.
template <typename T, bool kWide>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, size_t stride,
                                           int row0, int limit, int hd, int hdp) {
  constexpr int kVec = kWide ? Io<T>::kVec : 1;
  const int hdv = hd / kVec;
  for (int i = threadIdx.x; i < 64 * hdv; i += kThreads) {
    const int r = i / hdv;
    const int c = (i - r * hdv) * kVec;
    float* d = dst + r * ld + c;
    if (row0 + r < limit) {
      const T* s = src + (size_t)(row0 + r) * stride + c;
      if constexpr (kWide) {
        Io<T>::load(s, d);
      } else {
        d[0] = Io<T>::one(s);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = 0.f;
    }
  }
  const int pad = hdp - hd;
  for (int i = threadIdx.x; i < 64 * pad; i += kThreads) {
    const int r = i / pad;
    dst[r * ld + hd + (i - r * pad)] = 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int padded_hd(int nj) { return 64 * nj; }

size_t smem_bytes(int nj) {
  // Q tile and the K/V buffer (64, hdp + 4); P^T (64, 68)
  return sizeof(float) * ((size_t)2 * 64 * (padded_hd(nj) + 4) + (size_t)kBK * kLdP);
}

// kNj: hd padded to 64 kNj (<= 256).  Four accumulator columns of each 64
// belong to one thread: 16 kNj accumulators, so kNj <= 2 fits two CTAs an SM.
template <typename T, int kNj, bool kWide>
__global__ void __launch_bounds__(kThreads, kNj <= 2 ? 2 : 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int S, int Tk, int Hq, int Hkv, int hd, int causal,
                       int window, float softcap, float scale) {
  constexpr int kHdp = padded_hd(kNj);
  constexpr int kLd = kHdp + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                // (64 query rows, kLd)
  float* kv_s = q_s + 64 * kLd;     // (64 keys, kLd): K, then V
  float* p_s = kv_s + 64 * kLd;     // (64 keys, kLdP): P^T

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t q_stride = (size_t)Hq * hd;   // between sequence positions
  const size_t kv_stride = (size_t)Hkv * hd;
  const T* qb = q + ((size_t)b * S * Hq + h) * hd;
  const T* kb = k + ((size_t)b * Tk * Hkv + hk) * hd;
  const T* vb = v + ((size_t)b * Tk * Hkv + hk) * hd;

  // the KV tiles this CTA visits
  const int q_last = min(q0 + kBQ, S) - 1;
  int k_lo = 0, k_hi = Tk;
  if (causal) k_hi = min(Tk, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  if (window > 0 && q_last >= Tk - 1 + window) {  // a row no key may see
    k_lo = 0;
    k_hi = Tk;
  }

  stage_rows<T, kWide>(q_s, kLd, qb, q_stride, q0, S, hd, kHdp);

  float m[4], l[4], acc[4][4 * kNj];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kNj; ++c) acc[i][c] = 0.f;
  }
  const int hd4 = (hd + 3) / 4;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's P V is done with kv_s and p_s
    stage_rows<T, kWide>(kv_s, kLd, kb, kv_stride, k0, Tk, hd, kHdp);
    __syncthreads();

    // logits of rows 4 ty + i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d4 = 0; d4 < hd4; ++d4) {
      float4 qa[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&q_s[(ty * 4 + i) * kLd + d4 * 4]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kc[j] = *reinterpret_cast<const float4*>(&kv_s[(tx + 16 * j) * kLd + d4 * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kc[j].x, a);
          a = fmaf(qa[i].y, kc[j].y, a);
          a = fmaf(qa[i].z, kc[j].z, a);
          a = fmaf(qa[i].w, kc[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, softcap, mask; online softmax per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const bool visible = (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        x = visible ? x : kMasked;
        x = kpos < Tk ? x : -INFINITY;  // not a key: weight exactly 0
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        psum += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kNj; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&p_s[(tx + 16 * j) * kLdP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every K read done, P complete
    stage_rows<T, kWide>(kv_s, kLd, vb, kv_stride, k0, Tk, hd, kHdp);
    __syncthreads();

    // acc[i][4 jj + c] += sum_key P[row i][key] V[key][64 jj + 4 tx + c]
    const int keys = min(kBK, Tk - k0);
    for (int key = 0; key < keys; ++key) {
      const float4 p = *reinterpret_cast<const float4*>(&p_s[key * kLdP + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < kNj; ++jj) {
        const float4 vv = *reinterpret_cast<const float4*>(&kv_s[key * kLd + jj * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pr[i], vv.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pr[i], vv.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pr[i], vv.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pr[i], vv.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }

  T* ob = out + ((size_t)b * S * Hq + h) * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) break;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = ob + (size_t)qpos * q_stride;
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = jj * 64 + tx * 4 + c;
        if (col < hd) row[col] = Io<T>::store(acc[i][jj * 4 + c] / den);
      }
  }
}

template <typename T, int kNj, bool kWide>
cudaError_t launch_nj(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                      int Hq, int Hkv, int hd, int causal, int window, float softcap, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(kNj);
  const cudaError_t err =
      cudaFuncSetAttribute(flash_attention_kernel<T, kNj, kWide>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<T, kNj, kWide><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), S, Tk,
                                           Hq, Hkv, hd, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, bool kWide>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* out, int B, int S,
                        int Tk, int Hq, int Hkv, int hd, int causal, int window, float softcap,
                        float scale, cudaStream_t stream) {
  switch ((hd + 63) / 64) {
    case 1:
      return launch_nj<T, 1, kWide>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                                    scale, stream);
    case 2:
      return launch_nj<T, 2, kWide>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                                    scale, stream);
    case 3:
      return launch_nj<T, 3, kWide>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                                    scale, stream);
    case 4:
      return launch_nj<T, 4, kWide>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                                    scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte loads where every row starts on a 16-byte word, else scalar ones.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                   int Hq, int Hkv, int hd, int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  const bool wide =
      hd % Io<T>::kVec == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (wide)
    return launch_wide<T, true>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                                scale, stream);
  return launch_wide<T, false>(q, k, v, out, B, S, Tk, Hq, Hkv, hd, causal, window, softcap,
                               scale, stream);
}

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16.  q (B, S, Hq, hd), k and v (B, T, Hkv,
// hd), out like q, all contiguous; 1 <= hd <= 256, Hq a multiple of Hkv,
// T >= 1 (checked by the Python wrapper).  window 0 and softcap 0 are off.
// Launches on `stream`; returns the launch's error.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int B, int S, int T, int Hq, int Hkv, int hd, int causal, int window,
                           float softcap, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || S == 0 || Hq == 0) return cudaSuccess;
  if (B > 65535 || Hq > 65535 || T < 1 || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, B, S, T, Hq, Hkv, hd, causal, window, softcap, scale, s);
    case 1:
      return launch<__nv_bfloat16>(q, k, v, out, B, S, T, Hq, Hkv, hd, causal, window, softcap,
                                   scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
