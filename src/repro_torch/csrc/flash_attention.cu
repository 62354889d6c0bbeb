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
//   * P V is an fp32 product: the TPU kernel widens v to fp32 before
//     `p.astype(v.dtype)` (unlike the jnp `blocked_attention`, which rounds
//     P to v's dtype, as SDPA does).
//
// Two routes, chosen by dtype (the wrapper reports which):
//
// bf16 q/k/v: `wgmma`, warp-specialised.  One CTA owns (batch b, query head
// h, 128 query rows; 64 for hd > 128) and walks 64-key tiles of K and V.
//
//   * A producer warpgroup loads the Q tile once and K and V tiles into a
//     ring of 2-4 stages (Q, K, V as 128-byte swizzled rows of 64 hd
//     columns; columns past hd and keys past T read as zero): by TMA over
//     4-D maps (hd, heads, positions, batch) where a row of hd is a whole
//     number of 16-byte words and the bases are 16-byte aligned, else by
//     element loads into the same layout (llama-1b's hd 85).
//   * Two consumer warpgroups own 64 query rows each (wgmma's M; one
//     warpgroup for hd > 128, whose 64 x hd fp32 accumulator takes 128
//     registers a thread).  S = Q K^T is one bf16 wgmma pass (m64n64k16,
//     both operands K-major, hd rounded up to 16 deep): each bf16 product is
//     exact in fp32.
//   * The online softmax runs on the accumulator in registers, in the log2
//     domain (scale and log2 e folded into one multiply; `ex2.approx`, 2
//     ulp): row max and sum are quad shuffles; the running sum stays a
//     per-thread partial until the end.  The softcap's tanh is (e^2x - 1) /
//     (e^2x + 1) on the special-function unit, within 2.5e-7 of tanh (not
//     tanh.approx, whose 2^-11 times the cap of 50 breaks the budget;
//     tanhf branches, and ran slower).  Every shape is a compile-time
//     constant (the template's chunk count and last chunk width), so the
//     wgmma issue has no branches: a version that read the last chunk's
//     width and the depth of Q K^T at run time ran slower.  Tiles wholly outside a warpgroup's
//     causal / window band are skipped (exact: their weights would be
//     multiplied by exp(-1e30 - m) = 0), unless a row of the warpgroup
//     sees no key; only diagonal and ragged tiles are masked.
//   * O += P V keeps P's fp32 accuracy: P is split in registers into two
//     bf16 terms (hi = bf16(p), mid = bf16(p - hi); what is left is at most
//     2^-17 of p, far inside one bf16 ulp of the output), and each term is
//     wgmma's A operand straight from registers (the accumulator's layout is
//     the A fragment's), against V from shared memory, N-major (the
//     transpose bit), N = hd rounded up to 16 (64-wide pieces and a last
//     one of 16-64).  tests/test_torch_split.py reckons the terms against
//     fp64: one term breaks the bf16 budget by ~70x, two hold it.
//   * Order of work: grid x is the query head (heads that share a KV head
//     are neighbouring CTAs, so K and V are re-read from L2), grid y the
//     query tile, heaviest first under a causal mask.
//
// fp32 q/k/v: the first design, on CUDA cores.  One CTA of 256 threads owns
// (b, h, 64 query rows) and loops over 64-key tiles: Q staged once in
// shared memory, each K tile, then each V tile, through one buffer (16-byte
// loads where rows are whole 16-byte words, else one element per load);
// thread (ty, tx) of a 16 x 16 grid computes 4 x 4 logits, the row max and
// sum are half-warp shuffles, the 64 x hd accumulator stays in registers
// and P goes through shared memory to P V.  Tile skipping and the
// treatment of keys past T and rows past S are as above.
//
// Bound on this card.  4 hd flops per visible (query, key) pair against
// (Q + K + V + O) bytes read and written once: at llama-7b's prefill shape
// (S = T = 2048, causal, hd 128) ~350 flops per byte, bound by operations
// even at the bf16 tensor cores' 989 TFLOP/s (0.139 ms).  The bf16 route
// runs Q K^T once and P V twice (P's two terms): its own bound is 1.5x
// that (0.209 ms); the exp, and the tanh under a softcap, per logit run on
// the special-function units beside it.  The fp32 route is ~15x off the
// tensor-core bound by construction (67 TFLOP/s on CUDA cores).

#include "hopper_mma.cuh"

#include <math.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// bf16 route: wgmma
// ---------------------------------------------------------------------------

namespace wg {

using hopper::desc;
using hopper::mbar_arrive;
using hopper::mbar_wait;

constexpr int kBK = 64;                // keys per tile
constexpr int kChunk = 64 * 128;       // 64 rows of one 64-wide hd chunk, bf16
constexpr int kSmemMax = 232448;
constexpr int kLoadBatch = 16;         // element loads in flight per producer thread
constexpr float kLog2e = 1.4426950408889634f;

// kChunks: hd in 64-wide chunks (1-4).
template <int kChunks>
struct Cfg {
  static constexpr int kCons = kChunks <= 2 ? 2 : 1;  // consumer warpgroups
  static constexpr int kBQ = 64 * kCons;              // query rows per CTA
  static constexpr int kThreads = 128 * (kCons + 1);
  static constexpr int kQBytes = kChunks * kBQ * 128;
  static constexpr int kKV = kChunks * kChunk;        // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kFit = (kSmemMax - 1024 - 256 - kQBytes) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStage + 256;
  static_assert(kStages >= 2 && kSmem <= kSmemMax, "Q and a ring of two stages fit");
};

struct Params {
  const unsigned short* q;
  const unsigned short* k;
  const unsigned short* v;
  __nv_bfloat16* out;
  int S, T, Hq, Hkv, hd, causal, window, n_qt;
  int tma;            // the producer's route: TMA, else element loads
  float scale_log2e;  // scale log2(e), no softcap
  float cap_scale;    // scale / softcap
  float cap_log2e;    // softcap log2(e); 0: no softcap
};

// rows row0 .. row0 + rows - 1 of a (positions, hd) operand whose row i
// starts at src + i * stride, into kChunks regions of `rows` swizzled
// 128-byte rows (TMA's layout); rows at or past `limit` and columns at or
// past hd are zero.  By the 128 producer threads (pt).
template <int kChunks>
__device__ void load_rows(unsigned char* dst, const unsigned short* src, long long stride,
                          int rows, int row0, int limit, int hd, int pt) {
  constexpr int kW = kChunks * 64;
  auto at = [&](int idx, int& r, int& c) -> uint32_t {
    r = idx / kW;
    c = idx % kW;
    return (c / 64) * rows * 128 + hopper::swizzle(r * 128 + (c % 64) * 2);
  };
#pragma unroll 1
  for (int i0 = 0; i0 < rows * kW; i0 += 128 * kLoadBatch) {
    unsigned short x[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      int r, c;
      at(i0 + u * 128 + pt, r, c);
      x[u] = r < rows && row0 + r < limit && c < hd ? src[(long long)(row0 + r) * stride + c]
                                                    : (unsigned short)0;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      int r, c;
      const uint32_t off = at(i0 + u * 128 + pt, r, c);
      if (r < rows) *reinterpret_cast<unsigned short*>(dst + off) = x[u];
    }
  }
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// O += P V for one 16-key step: the A fragment `a` (one term of P) against
// V's 16 rows at vb: each full 64-wide hd chunk, then the last, kLast wide.
template <int kChunks, int kLast>
__device__ __forceinline__ void pv_step(float (&o)[kChunks][32], const uint32_t (&a)[4],
                                        uint32_t vb) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint64_t db = desc(vb + c * kChunk, kChunk, 1024);
    if (c < kChunks - 1)
      hopper::wgmma_rs<64>(o[c], a, db, 1);
    else
      hopper::wgmma_rs<kLast>(o[c], a, db, 1);
  }
}

// O += P V for one tile: P's two terms (A fragments per 16-key step, the
// smaller term first) against V's 64 rows at vb.
template <int kChunks, int kLast>
__device__ __forceinline__ void pv(float (&o)[kChunks][32], const uint32_t (&hi)[16],
                                   const uint32_t (&mid)[16], uint32_t vb) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    const uint32_t a_mid[4] = {mid[4 * ks], mid[4 * ks + 1], mid[4 * ks + 2], mid[4 * ks + 3]};
    const uint32_t a_hi[4] = {hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2], hi[4 * ks + 3]};
    pv_step<kChunks, kLast>(o, a_mid, vb + ks * 2048);
    pv_step<kChunks, kLast>(o, a_hi, vb + ks * 2048);
  }
}

// S = Q K^T for one tile into sc: kQk 16-deep steps over the hd chunks of
// this warpgroup's Q rows at qa (chunks kBQ rows apart) and K at kb.
template <int kQk, int kBQ>
__device__ __forceinline__ void qk(float (&sc)[32], uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < kQk; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns of a 128-byte row
    hopper::wgmma_ss_n64(sc, desc(qa + (kk / 4) * kBQ * 128 + off, 16, 1024),
                         desc(kb + (kk / 4) * kChunk + off, 16, 1024), kk > 0);
  }
}

// After the wait for P V: o and P's terms stay where the tensor cores
// left and read them.
template <int kChunks>
__device__ __forceinline__ void fence_pv(float (&o)[kChunks][32], uint32_t (&hi)[16],
                                         uint32_t (&mid)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) asm volatile("" : "+r"(hi[j]), "+r"(mid[j])::"memory");
#pragma unroll
  for (int c = 0; c < kChunks; ++c) hopper::fence_operands(o[c]);
}

// 2^x on the special-function unit (2 ulp; 0 for -inf and far below)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(x) = (e^2x - 1) / (e^2x + 1) on the special-function unit (|x|
// clamped to 10, where tanh is 1 in fp32): within 2.5e-7 of tanh, one
// MUFU ex2 and one reciprocal, no branch (tanhf takes a polynomial below
// |x| = 0.55, so a warp runs both of its paths).
__device__ __forceinline__ float tanh_ex2(float x) {
  const float t = ex2(fminf(fmaxf(x, -10.f), 10.f) * (2.f * kLog2e));
  return __fdividef(t - 1.f, t + 1.f);
}

// A thread's two rows (r0, r1 = r0 + 8) of the online softmax.
struct Rows {
  int r0, r1, col;        // col + 8 (i / 4) + (i & 1): accumulator entry i's key
  float m0, m1, l0, l1;   // running max (log2 domain), this thread's share of the sums
};

// The logits of one tile (keys k0 ..) -> P = 2^(s - m) in sc, the running
// max and sums updated; returns the old sums' corrections.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[32], const Params& p, int k0, int q0w,
                                               Rows& w) {
  // scale (and softcap) into the log2 domain, then the masks
  const bool interior = (!p.causal || k0 + kBK - 1 <= q0w) &&
                        (p.window <= 0 || k0 > q0w + 63 - p.window) && k0 + kBK <= p.T;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = p.cap_log2e != 0.f ? tanh_ex2(sc[i] * p.cap_scale) * p.cap_log2e
                                 : sc[i] * p.scale_log2e;
    if (!interior) {
      const int key = k0 + 8 * (i / 4) + w.col + (i & 1);
      const int row = (i & 2) ? w.r1 : w.r0;
      const bool visible = (!p.causal || key <= row) && (p.window <= 0 || key > row - p.window);
      x = visible ? x : kMasked;
      x = key < p.T ? x : -INFINITY;  // not a key: weight exactly 0
    }
    sc[i] = x;
    if (i & 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  const float mn0 = fmaxf(w.m0, mx0), mn1 = fmaxf(w.m1, mx1);
  const float2 corr = make_float2(ex2(w.m0 - mn0), ex2(w.m1 - mn1));
  w.m0 = mn0;
  w.m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = ex2(sc[i] - ((i & 2) ? mn1 : mn0));
    if (i & 2)
      ps1 += sc[i];
    else
      ps0 += sc[i];
  }
  w.l0 = w.l0 * corr.x + ps0;
  w.l1 = w.l1 * corr.y + ps1;
  return corr;
}

// O *= the corrections; P (in sc) -> hi + mid (+ at most 2^-17 p), both
// bf16, as wgmma A fragments: accumulator entries 8 j .. 8 j + 7 are keys
// 16 j .. 16 j + 15
template <int kChunks>
__device__ __forceinline__ void rescale_split(float (&o)[kChunks][32], const float (&sc)[32],
                                              float2 corr, uint32_t (&hi)[16],
                                              uint32_t (&mid)[16]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? corr.y : corr.x;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(sc[2 * j], sc[2 * j + 1]);
    const float2 hf = __bfloat1622float2(h2);
    hi[j] = bf16x2_bits(h2);
    mid[j] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * j] - hf.x, sc[2 * j + 1] - hf.y));
  }
}

#define WG_FENCE() asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory")
#define WG_COMMIT() asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory")
#define WG_WAIT(n) asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory")

// kChunks: hd in 64-wide chunks; kLast: the last chunk's width rounded up
// to 16 (hd = 64 (kChunks - 1) + kLast, rounded).
template <int kChunks, int kLast>
__global__ void __launch_bounds__(Cfg<kChunks>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Params p) {
  using C = Cfg<kChunks>;
  constexpr int kQk = (kChunks - 1) * 4 + kLast / 16;  // 16-deep steps of Q K^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);  // swizzle atoms
  const uint32_t q_s = hopper::smem_addr(smem);
  const uint32_t ring = q_s + C::kQBytes;
  const uint32_t q_full = ring + C::kStages * C::kStage;
  const uint32_t full = q_full + 8;
  const uint32_t empty = full + 8 * C::kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int q0 = (p.causal ? p.n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y) * C::kBQ;
  const int hk = h / (p.Hq / p.Hkv);
  // the KV tiles this CTA visits, as the fp32 route
  const int q_last = min(q0 + C::kBQ, p.S) - 1;
  int k_lo = 0, k_hi = p.T;
  if (p.causal) k_hi = min(p.T, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  if (p.window > 0 && q_last >= p.T - 1 + p.window) {  // a row no key may see
    k_lo = 0;
    k_hi = p.T;
  }
  const int k_first = k_lo / kBK * kBK;
  const int n_tiles = (k_hi - k_first + kBK - 1) / kBK;

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  if (tid == 0) {
    hopper::mbar_init(q_full, p.tma ? 1 : 128);
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(full + 8 * s, p.tma ? 1 : 128);
      hopper::mbar_init(empty + 8 * s, 128 * C::kCons);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == C::kCons) {  // the producer warpgroup
    const int pt = tid - 128 * C::kCons;
    if (p.tma) {
      if (pt != 0) return;
      hopper::mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_load_4d(q_s + c * C::kBQ * 128, &q_map, q_full, 64 * c, h, q0, b);
    } else {
      load_rows<kChunks>(smem, p.q + ((long long)b * p.S * p.Hq + h) * p.hd,
                         (long long)p.Hq * p.hd, C::kBQ, q0, p.S, p.hd, pt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(q_full);
    }
    const long long kv0 = ((long long)b * p.T * p.Hkv + hk) * p.hd;
    const long long kv_stride = (long long)p.Hkv * p.hd;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::kStages;
      const uint32_t stage = ring + s * C::kStage;
      const int key0 = k_first + t * kBK;
      mbar_wait(empty + 8 * s, ((t / C::kStages) & 1) ^ 1);
      if (p.tma) {
        hopper::mbar_expect_tx(full + 8 * s, C::kStage);
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(stage + c * kChunk, &k_map, full + 8 * s, 64 * c, hk, key0, b);
          hopper::tma_load_4d(stage + C::kKV + c * kChunk, &v_map, full + 8 * s, 64 * c, hk,
                              key0, b);
        }
      } else {
        unsigned char* st = smem + C::kQBytes + s * C::kStage;
        load_rows<kChunks>(st, p.k + kv0, kv_stride, kBK, key0, p.T, p.hd, pt);
        load_rows<kChunks>(st + C::kKV, p.v + kv0, kv_stride, kBK, key0, p.T, p.hd, pt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // a consumer warpgroup: query rows q0w .. q0w + 63; this thread's rows r0
  // and r1 = r0 + 8 (wgmma's accumulator layout)
  const int lane = tid % 32;
  const int q0w = q0 + 64 * wgi;
  Rows w;
  w.r0 = q0w + 16 * ((tid % 128) / 32) + lane / 4;
  w.r1 = w.r0 + 8;
  w.col = 2 * (lane % 4);
  w.m0 = w.m1 = kMasked;
  w.l0 = w.l1 = 0.f;
  const int qlast_w = min(q0w + 63, p.S - 1);
  const bool active = q0w < p.S;
  const bool blind = p.window > 0 && qlast_w >= p.T - 1 + p.window;  // a row sees no key
  const uint32_t qa = q_s + wgi * 64 * 128;
  // the tiles this warpgroup computes, [t_lo, t_hi): the others lie wholly
  // outside its band (exact to skip: their weights would be multiplied by
  // exp(-1e30 - m) = 0), unless one of its rows sees no key
  int t_lo = 0, t_hi = active ? n_tiles : 0;
  if (active && !blind) {
    if (p.causal) t_hi = min(n_tiles, (qlast_w - k_first) / kBK + 1);
    const int x = q0w - p.window - (kBK - 1) - k_first;
    if (p.window > 0 && x >= 0) t_lo = x / kBK + 1;
  }
  auto stage_of = [&](int t) { return ring + (t % C::kStages) * C::kStage; };
  auto wait_full = [&](int t) {
    mbar_wait(full + 8 * (t % C::kStages), (t / C::kStages) & 1);
  };
  auto release = [&](int t) { mbar_arrive(empty + 8 * (t % C::kStages)); };

  float o[kChunks][32];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  uint32_t hi[16], mid[16];
  float sc[32];

  mbar_wait(q_full, 0);
  int t = 0;
  for (; t < t_lo && t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }
  for (; t < t_hi; ++t) {
    wait_full(t);
    WG_FENCE();
    qk<kQk, C::kBQ>(sc, qa, stage_of(t));
    WG_COMMIT();
    WG_WAIT(0);
    hopper::fence_operands(sc);
    rescale_split(o, sc, softmax_tile(sc, p, k_first + t * kBK, q0w, w), hi, mid);
    WG_FENCE();
    pv<kChunks, kLast>(o, hi, mid, stage_of(t) + C::kKV);
    WG_COMMIT();
    WG_WAIT(0);
    fence_pv(o, hi, mid);
    release(t);
  }
  for (; t < n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  // the row sums over the quad; O / l in bf16
  float l0 = w.l0, l1 = w.l1;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const long long row_stride = (long long)p.Hq * p.hd;
  __nv_bfloat16* ob = p.out + ((long long)b * p.S * p.Hq + h) * p.hd;
  const bool pairs = (p.hd & 1) == 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = (i & 2) ? w.r1 : w.r0;
      const int cc = 64 * c + 8 * (i / 4) + w.col;
      if (row >= p.S || cc >= p.hd) continue;
      const float den = (i & 2) ? den1 : den0;
      __nv_bfloat16* dst = ob + row * row_stride + cc;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[c][i] / den, o[c][i + 1] / den);
      } else {
        dst[0] = __float2bfloat16(o[c][i] / den);
        if (cc + 1 < p.hd) dst[1] = __float2bfloat16(o[c][i + 1] / den);
      }
    }
}

#undef WG_FENCE
#undef WG_COMMIT
#undef WG_WAIT

template <int kChunks, int kLast>
cudaError_t launch_shape(const CUtensorMap* maps, const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<kChunks>;
  auto kernel = flash_wgmma_kernel<kChunks, kLast>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.n_qt, B);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <int kChunks>
cudaError_t launch_chunks(const CUtensorMap* maps, const Params& p, int B, int last,
                          cudaStream_t stream) {
  switch (last) {
    case 16:
      return launch_shape<kChunks, 16>(maps, p, B, stream);
    case 32:
      return launch_shape<kChunks, 32>(maps, p, B, stream);
    case 48:
      return launch_shape<kChunks, 48>(maps, p, B, stream);
    case 64:
      return launch_shape<kChunks, 64>(maps, p, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// route 1: TMA producer; 2: element loads
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int T,
                   int Hq, int Hkv, int hd, int causal, int window, float softcap, float scale,
                   int* route, cudaStream_t stream) {
  const int chunks = (hd + 63) / 64;
  const int last = (hd - 64 * (chunks - 1) + 15) / 16 * 16;
  Params p;
  p.q = static_cast<const unsigned short*>(q);
  p.k = static_cast<const unsigned short*>(k);
  p.v = static_cast<const unsigned short*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.hd = hd;
  p.causal = causal;
  p.window = window;
  const int bq = chunks <= 2 ? Cfg<2>::kBQ : Cfg<4>::kBQ;
  p.n_qt = (S + bq - 1) / bq;
  if (p.n_qt > 65535) return cudaErrorInvalidValue;
  p.scale_log2e = scale * kLog2e;
  p.cap_scale = softcap != 0.f ? scale / softcap : 0.f;
  p.cap_log2e = softcap * kLog2e;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  p.tma = hd % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  if (p.tma) {
    const uint64_t e = 2;  // bytes of a bf16
    const uint64_t qd[4] = {(uint64_t)hd, (uint64_t)Hq, (uint64_t)S, (uint64_t)B};
    const uint64_t qs[3] = {e * hd, e * hd * Hq, e * hd * Hq * S};
    const uint32_t qbox[4] = {64, 1, (uint32_t)bq, 1};
    const uint64_t kd[4] = {(uint64_t)hd, (uint64_t)Hkv, (uint64_t)T, (uint64_t)B};
    const uint64_t ks[3] = {e * hd, e * hd * Hkv, e * hd * Hkv * T};
    const uint32_t kbox[4] = {64, 1, kBK, 1};
    if (!hopper::make_map_4d(&maps[0], q, qd, qs, qbox) ||
        !hopper::make_map_4d(&maps[1], k, kd, ks, kbox) ||
        !hopper::make_map_4d(&maps[2], v, kd, ks, kbox))
      return cudaErrorInvalidValue;
  }
  *route = p.tma ? 1 : 2;
  switch (chunks) {
    case 1:
      return launch_chunks<1>(maps, p, B, last, stream);
    case 2:
      return launch_chunks<2>(maps, p, B, last, stream);
    case 3:
      return launch_chunks<3>(maps, p, B, last, stream);
    case 4:
      return launch_chunks<4>(maps, p, B, last, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace

extern "C" {

// dtype 0 = float32, 1 = bfloat16.  q (B, S, Hq, hd), k and v (B, T, Hkv,
// hd), out like q, all contiguous; 1 <= hd <= 256, Hq a multiple of Hkv,
// T >= 1 (checked by the Python wrapper).  window 0 and softcap 0 are off.
// Writes the route taken to *route (0: CUDA cores, fp32; 1: wgmma, TMA
// producer; 2: wgmma, element loads).  Launches on `stream`; returns the
// launch's error.
int flash_attention_launch(const void* q, const void* k, const void* v, void* out, int dtype,
                           int B, int S, int T, int Hq, int Hkv, int hd, int causal, int window,
                           float softcap, float scale, int* route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *route = dtype == 0 ? 0 : 1;
  if (B == 0 || S == 0 || Hq == 0) return cudaSuccess;
  if (B > 65535 || Hq > 65535 || T < 1 || Hkv < 1 || Hq % Hkv || hd < 1 || hd > 256)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, out, B, S, T, Hq, Hkv, hd, causal, window, softcap, scale, s);
    case 1:
      return wg::launch(q, k, v, out, B, S, T, Hq, Hkv, hd, causal, window, softcap, scale, route,
                        s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
