// Paged-attention decode kernel for Hopper (sm_90a), plain C entry for ctypes.
//
// Replaces the Pallas TPU kernel `paged_attention` of
// src/repro/kernels/paged_attention.py (pallas_call at line 128, kernel body
// lines 45-84).  Same function, re-thought for the GPU rather than copied.
//
// Bound on this card.  Decode attention is memory-bound: every K and V row
// of a sequence's `length` positions is read once, and each K/V element
// meets 2 * G flops (G query heads per KV head), far below the H100's ~295
// flop/byte balance even at stablelm's G = 4.  Tensor cores would buy
// nothing, so the sums stay fp32 on CUDA cores; the least time is the owned
// K/V bytes over 3.35 TB/s, and the design is about keeping enough of
// those bytes in flight.
//
// Design (split-K over positions, an asynchronous copy ring):
//   * Grid (split s, KV head h x head group, sequence b).  A CTA owns the
//     contiguous table words [s * wps, (s + 1) * wps) (wps = ceil(W /
//     splits)) and walks their positions below `length`; a CTA whose range
//     starts at or past `length` writes an empty partial and exits.  The
//     split count comes from the caller (the wrapper picks it from W * bs
//     and B * Hkv alone): `lengths` is never read on the host.
//   * The TPU walked the table words on a sequential grid axis with the
//     softmax state in VMEM scratch.  Here each CTA streams its positions
//     through a ring of kStages shared-memory stages of kTile positions, K
//     and V kept in their storage dtype and widened in registers.  Where a
//     row is a whole number of 16-byte words (hd % 4 in fp32, hd % 8 in
//     bf16) and the pools are 16-byte aligned, the ring is filled by
//     cp.async, kStages - 1 stages ahead of the compute; otherwise
//     (llama-1b's hd 85) the same ring is filled by element loads in the
//     same kernel, the rows zero-padded to a 16-byte word.  Any hd up to
//     256 works.
//   * Logits: 8 lanes share one K row, each widening its 16-byte chunks
//     c, c + 8, ... of it, so one logit is a 3-step shuffle.  The online softmax keeps a running max m and normaliser l
//     per query head; the (G, hd) accumulator lives in registers, each
//     thread owning fixed 16-byte chunks of it (row groups of threads split
//     a stage's rows when G * hd is small, and add up at the end).  Per
//     stage: one barrier after the copy lands, one after the logits, one
//     after the softmax.
//   * Partials and merge: each split writes fp32 (m, l, acc); a second
//     kernel, launched from the same C entry, merges them by log-sum-exp in
//     split order, so the output does not depend on the schedule.  With one
//     split the first kernel writes the output itself and the merge is not
//     launched.
//   * GQA: query head h*G + g belongs to KV head h, so the query rows of
//     one CTA are contiguous, and each K/V row is read once for all of them
//     (G * hd <= 4096 per CTA; a larger G is cut into head groups).
//   * Positions at or past `length` are never loaded; a lane of length 0
//     writes acc / max(l, 1e-30) = exactly 0 (an all-empty merge too).
//   * A table word outside [0, nb) or a length past W * bs is never read:
//     the split that meets it writes a NaN max, and the merge gives NaN for
//     that lane, so a broken table is loud, not silent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // positions per ring stage
constexpr int kStages = 4;         // ring depth: kStages - 1 stages in flight
constexpr int kRowLanes = 8;       // lanes that share one K row in the logits
constexpr int kRegFloats = 32;     // widened K values a lane holds (hd <= 256)
constexpr int kGroupElems = 4096;  // query heads x hd_pad one CTA takes
constexpr float kNegInf = -1e30f;

static_assert(kWarps * (32 / kRowLanes) == kTile, "one pass of the logits covers a stage");
static_assert(kTile <= 16, "the softmax step reduces over 16 lanes");

// kVec elements of T make one 16-byte word.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kVec = 4;
  __device__ static void widen(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void widen(const __nv_bfloat16* src, float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ static float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 from_float(float x) { return __float2bfloat16(x); }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sums and maxima over the 8 lanes of a row (logits) or 16 lanes (softmax).
template <int kWidth>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
template <int kWidth>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

int round_up(int x, int k) { return (x + k - 1) / k * k; }

// Query heads one CTA takes at row length hd_pad.
int head_group(int G, int hd_pad) { return G < kGroupElems / hd_pad ? G : kGroupElems / hd_pad; }

template <typename T>
size_t smem_bytes(int G, int hd) {
  constexpr int kVec = Word<T>::kVec;
  const int hd_pad = round_up(hd, kVec);
  const int Gg = head_group(G, hd_pad);
  const size_t ring = (size_t)kStages * 2 * kTile * hd_pad * sizeof(T);
  const size_t red = (size_t)kThreads * kVec * sizeof(float);  // row-group sums, after the ring
  // ring (or the row-group sums); q (Gg, hd_pad); p (Gg, kTile); m, l, corr (Gg)
  return (ring > red ? ring : red) +
         sizeof(float) * ((size_t)Gg * hd_pad + (size_t)Gg * kTile + (size_t)3 * Gg);
}

// kPairs: 16-byte output chunks a thread owns (1 when G * hd_pad <=
// kThreads * kVec, else kRegFloats / kVec).
template <typename T, bool kWide, int kPairs>
__global__ void __launch_bounds__(kThreads, kPairs == 1 ? 8 : 4)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_m,
                       float* __restrict__ part_l, int Hkv, int G, int Gg, int hd, int bs, int W,
                       int nb, int splits, float scale) {
  constexpr int kVec = Word<T>::kVec;
  constexpr int kMaxChunks = kRegFloats / kVec;  // 16-byte chunks per lane, per row
  static_assert(kPairs == 1 || kPairs == kMaxChunks, "one or all of a lane's chunks");
  const int hd_pad = (hd + kVec - 1) / kVec * kVec;
  const int C = hd_pad / kVec;                   // chunks per row
  const int s = blockIdx.x;
  const int n_groups = (G + Gg - 1) / Gg;
  const int h = blockIdx.y / n_groups;
  const int g0 = (blockIdx.y - h * n_groups) * Gg;
  const int gcount = min(Gg, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t ring_bytes = (size_t)kStages * 2 * kTile * hd_pad * sizeof(T);
  const size_t red_bytes = (size_t)kThreads * kVec * sizeof(float);
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);  // reused once the ring is drained
  float* q_s = reinterpret_cast<float*>(smem_raw + (ring_bytes > red_bytes ? ring_bytes : red_bytes));
  float* p_s = q_s + Gg * hd_pad;  // (Gg, kTile): logits, then probabilities
  float* m_s = p_s + Gg * kTile;   // (Gg) running max
  float* l_s = m_s + Gg;           // (Gg) running normaliser
  float* c_s = l_s + Gg;           // (Gg) this stage's rescale of acc
  __shared__ int bad;

  // this split's positions [p0, p1)
  const int wps = (W + splits - 1) / splits;
  const int length = max(lengths[b], 0);
  const bool bad_length = length > W * bs;
  const int p0 = s * wps * bs;
  const int p1 = bad_length ? p0 : min(length, min(W, (s + 1) * wps) * bs);
  const int n = max(p1 - p0, 0);
  const int n_stages = (n + kTile - 1) / kTile;
  const int* table = tables + (size_t)b * W;
  const size_t q_row0 = (size_t)b * Hkv * G + (size_t)h * G + g0;  // first query head

  if (tid == 0) bad = bad_length;
  if (n > 0) {
    for (int i = tid; i < gcount * hd_pad; i += kThreads) {
      const int g = i / hd_pad;
      const int d = i - g * hd_pad;
      q_s[i] = d < hd ? Word<T>::to_float(q[(q_row0 + g) * hd + d]) : 0.f;
    }
  }
  for (int g = tid; g < gcount; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();  // `bad` is set before any loader may raise it

  // stage `st` of this split into ring slot st % kStages
  auto load_stage = [&](int st) {
    if (st >= n_stages) return;
    const int pos0 = p0 + st * kTile;
    const int rows = min(kTile, p1 - pos0);
    T* ks = ring + (size_t)(st % kStages) * 2 * kTile * hd_pad;
    T* vs = ks + kTile * hd_pad;
    if constexpr (kWide) {
      for (int i = tid; i < rows * C; i += kThreads) {
        const int r = i / C;
        const int c = i - r * C;
        const int p = pos0 + r;
        const int blk = table[p / bs];
        if (blk < 0 || blk >= nb) {
          bad = 1;
          continue;
        }
        const size_t off = (((size_t)blk * bs + p % bs) * Hkv + h) * hd + c * kVec;
        cp_async16(ks + r * hd_pad + c * kVec, k_pool + off);
        cp_async16(vs + r * hd_pad + c * kVec, v_pool + off);
      }
    } else {
      for (int i = tid; i < rows * hd_pad; i += kThreads) {
        const int r = i / hd_pad;
        const int d = i - r * hd_pad;
        const int p = pos0 + r;
        const int blk = table[p / bs];
        T kv = Word<T>::from_float(0.f), vv = Word<T>::from_float(0.f);
        if (blk < 0 || blk >= nb) {
          bad = 1;
        } else if (d < hd) {
          const size_t off = (((size_t)blk * bs + p % bs) * Hkv + h) * hd + d;
          kv = k_pool[off];
          vv = v_pool[off];
        }
        ks[r * hd_pad + d] = kv;
        vs[r * hd_pad + d] = vv;
      }
    }
  };

  // accumulator ownership: pair = (head g, 16-byte chunk c) of the output
  const int P = gcount * C;
  const int RG = P <= kThreads ? kThreads / P : 1;  // row groups
  const int my_rg = P <= kThreads ? tid / P : 0;
  auto pair_of = [&](int k) -> int {
    if (P <= kThreads) return (k == 0 && my_rg < RG) ? tid % P : -1;
    const int pr = tid + k * kThreads;
    return pr < P ? pr : -1;
  };
  float acc[kPairs][kVec];
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[k][e] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    load_stage(st);
    cp_async_commit();
  }

  const int row_in_stage = warp * (32 / kRowLanes) + lane / kRowLanes;
  const int sub = lane % kRowLanes;
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed; stage st - 1's slot and p are free
    load_stage(st + kStages - 1);
    cp_async_commit();

    const int rows = min(kTile, p1 - (p0 + st * kTile));
    const T* ks = ring + (size_t)(st % kStages) * 2 * kTile * hd_pad;
    const T* vs = ks + kTile * hd_pad;

    // logits: 8 lanes per row, each a 16-byte chunk c, c + 8, ... of it
    {
      const int r = row_in_stage;
      for (int g = 0; g < gcount; ++g) {
        const float* qg = q_s + g * hd_pad;
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxChunks; ++j) {
          const int c = sub + j * kRowLanes;
          if (r < rows && c < C) {
            float kv[kVec];
            Word<T>::widen(ks + r * hd_pad + c * kVec, kv);
#pragma unroll
            for (int e = 0; e < kVec; ++e) dot = fmaf(qg[c * kVec + e], kv[e], dot);
          }
        }
        dot = group_sum<kRowLanes>(dot);
        if (sub == 0 && r < rows) p_s[g * kTile + r] = dot * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per staged row
    for (int g = warp; g < gcount; g += kWarps) {
      const bool live = lane < rows;
      const float sc = live ? p_s[g * kTile + lane] : kNegInf;
      const float m_prev = m_s[g];
      // rows >= 1, so m_new is a real logit and no exp sees -inf - -inf
      const float m_new = fmaxf(m_prev, group_max<kTile>(sc));
      const float pr = live ? expf(sc - m_new) : 0.f;
      const float psum = group_sum<kTile>(pr);
      if (lane < kTile) p_s[g * kTile + lane] = pr;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this thread's row group
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pr = pair_of(k);
      if (pr < 0) continue;
      const int g = pr / C;
      const int c = pr - g * C;
      const float corr = c_s[g];
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[k][e] *= corr;
      for (int r = my_rg; r < rows; r += RG) {
        const float w = p_s[g * kTile + r];
        float v[kVec];
        Word<T>::widen(vs + r * hd_pad + c * kVec, v);
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[k][e] = fmaf(w, v[e], acc[k][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained and `bad` is final

  // write (g, d) of this CTA: the output itself (one split) or the partial
  auto emit = [&](int g, int d, float a) {
    if (d >= hd) return;
    const size_t row = q_row0 + g;  // (b, h*G + g0 + g)
    if (splits == 1) {
      const float val = bad ? NAN : a / fmaxf(l_s[g], 1e-30f);
      out[row * hd + d] = Word<T>::from_float(val);
    } else {
      part_acc[(row * splits + s) * hd + d] = a;
    }
  };
  if (RG > 1) {
    const int pr = pair_of(0);
    if (pr >= 0) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) red[(my_rg * P + pr) * kVec + e] = acc[0][e];
    }
    __syncthreads();
    for (int i = tid; i < P * kVec; i += kThreads) {
      float a = 0.f;
      for (int rg = 0; rg < RG; ++rg) a += red[rg * P * kVec + i];
      const int pr2 = i / kVec;
      const int g = pr2 / C;
      emit(g, (pr2 - g * C) * kVec + (i - pr2 * kVec), a);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pr = pair_of(k);
      if (pr < 0) continue;
      const int g = pr / C;
      const int c = pr - g * C;
#pragma unroll
      for (int e = 0; e < kVec; ++e) emit(g, c * kVec + e, acc[k][e]);
    }
  }
  if (splits > 1) {
    for (int g = tid; g < gcount; g += kThreads) {
      const size_t i = (q_row0 + g) * splits + s;
      part_m[i] = bad ? NAN : m_s[g];
      part_l[i] = l_s[g];
    }
  }
}

// One CTA per (sequence, query head): the splits' partials merged by
// log-sum-exp in split order.  A NaN max (a broken table word or length)
// makes the lane NaN; all-empty splits give 0 / 1e-30 = 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_m,
             const float* __restrict__ part_l, T* __restrict__ out, int hd, int splits) {
  const size_t row = blockIdx.x;
  const float* m = part_m + row * splits;
  const float* l = part_l + row * splits;
  float M = kNegInf;
  bool bad = false;
  for (int s = 0; s < splits; ++s) {
    if (isnan(m[s])) bad = true;
    else M = fmaxf(M, m[s]);
  }
  float L = 0.f;
  for (int s = 0; s < splits; ++s) L += bad ? 0.f : l[s] * expf(m[s] - M);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < splits && !bad; ++s)
      o = fmaf(part_acc[(row * splits + s) * hd + d], expf(m[s] - M), o);
    out[row * hd + d] = Word<T>::from_float(bad ? NAN : o / fmaxf(L, 1e-30f));
  }
}

// The kernel instance for these shapes: wide rows or not, one or all chunks.
template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, const int*, const int*, T*, float*, float*,
                        float*, int, int, int, int, int, int, int, int, float);

template <typename T>
Kernel<T> pick(bool wide, int G, int hd) {
  constexpr int kVec = Word<T>::kVec;
  constexpr int kAll = kRegFloats / kVec;
  const int hd_pad = round_up(hd, kVec);
  const bool one = head_group(G, hd_pad) * (hd_pad / kVec) <= kThreads;
  if (wide) return one ? paged_attention_kernel<T, true, 1> : paged_attention_kernel<T, true, kAll>;
  return one ? paged_attention_kernel<T, false, 1> : paged_attention_kernel<T, false, kAll>;
}

template <typename T>
cudaError_t launch_rows(Kernel<T> kernel, const void* q, const void* k_pool, const void* v_pool,
                        const int* tables, const int* lengths, void* out, float* partials, int B,
                        int Hkv, int G, int hd, int bs, int W, int nb, int splits, float scale,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int Gg = head_group(G, round_up(hd, Word<T>::kVec));
  const int n_groups = (G + Gg - 1) / Gg;
  const size_t rows = (size_t)B * Hkv * G;
  float* part_acc = partials;
  float* part_m = splits > 1 ? partials + rows * splits * hd : nullptr;
  float* part_l = splits > 1 ? part_m + rows * splits : nullptr;
  const dim3 grid(splits, Hkv * n_groups, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lengths, static_cast<T*>(out), part_acc, part_m, part_l, Hkv, G, Gg, hd, bs, W, nb,
      splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  merge_kernel<T><<<(unsigned)rows, kThreads, 0, stream>>>(part_acc, part_m, part_l,
                                                           static_cast<T*>(out), hd, splits);
  return cudaGetLastError();
}

// cp.async where every row starts on a 16-byte word, else element loads.
template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                   const int* lengths, void* out, float* partials, int B, int Hkv, int G, int hd,
                   int bs, int W, int nb, int splits, float scale, cudaStream_t stream) {
  const bool wide =
      hd % Word<T>::kVec == 0 && ((uintptr_t)k_pool | (uintptr_t)v_pool) % 16 == 0;
  return launch_rows<T>(pick<T>(wide, G, hd), q, k_pool, v_pool, tables, lengths, out, partials,
                        B, Hkv, G, hd, bs, W, nb, splits, scale, stream);
}

// CTAs of the kernel resident on the whole card at once (0 on an error).
template <typename T>
int capacity(int G, int hd) {
  const Kernel<T> kernel = pick<T>(hd % Word<T>::kVec == 0, G, hd);
  const size_t smem = smem_bytes<T>(G, hd);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return per_sm * sms;
}

}  // namespace

extern "C" {

// CTAs resident on the current device at once for these shapes (dtype 0
// = float32, 1 = bfloat16; the wrapper's split count fills it); 0 on an
// error.
int paged_attention_capacity(int G, int hd, int dtype) {
  return dtype == 0 ? capacity<float>(G, hd) : capacity<__nv_bfloat16>(G, hd);
}

// dtype: 0 = float32, 1 = bfloat16.  Shapes: q (B, Hkv*G, hd); pools
// (nb, bs, Hkv, hd); tables (B, W) int32; lengths (B,) int32; out like q;
// partials fp32 of B*Hkv*G*splits*(hd + 2) floats when splits > 1 (else
// unused).  All contiguous, hd <= 256, splits >= 1 (checked by the Python
// wrapper).  Launches on `stream` (the merge kernel after the split kernel
// when splits > 1); returns the first launch error.
int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                           const int* tables, const int* lengths, void* out, float* partials,
                           int dtype, int B, int Hkv, int G, int hd, int bs, int W, int nb,
                           int splits, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || Hkv == 0 || G == 0) return cudaSuccess;
  if (splits < 1 || splits > 65535 || (splits > 1 && partials == nullptr))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float>(q, k_pool, v_pool, tables, lengths, out, partials, B, Hkv, G, hd, bs,
                           W, nb, splits, scale, st);
    case 1:
      return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, partials, B, Hkv, G,
                                   hd, bs, W, nb, splits, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
