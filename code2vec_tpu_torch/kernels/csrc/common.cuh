// Helpers shared by the code2vec Hopper kernels (one shared library per
// .cu file, each bound from Python with ctypes; see kernels/build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define C2V_EXPORT extern "C" __attribute__((visibility("default")))

namespace c2v {

constexpr unsigned kFullMask = 0xffffffffu;
// Index of an empty top-k slot; reported as 0, the reference's sentinel
// index (code2vec_tpu/ops/topk.py blockwise_matmul_top_k init).
constexpr int kEmptyIndex = 0x7fffffff;

// Round an f32 to the nearest bf16 (ties to even) and widen it back: the
// reference's `.astype(bfloat16)` before a product with f32 accumulation.
// The product of two bf16 values is exact in f32, so an f32 FMA over
// rounded operands matches the reference's bf16 x bf16 -> f32 contraction
// up to summation order.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The order `lax.top_k` sorts by: NaN above everything, then by value
// descending, and equal values by ascending index.
__device__ __forceinline__ bool topk_before(float va, int ia, float vb,
                                            int ib) {
  const bool na = isnan(va), nb = isnan(vb);
  if (na || nb) return (na && nb) ? ia < ib : na;
  if (va != vb) return va > vb;
  return ia < ib;
}

// Insert (v, i) into a sorted top-k list of length k <= 64 held in shared
// memory (best first), if it beats the list's last entry. The whole warp
// calls it with the same (v, i): each lane owns entries lane and lane+32,
// the insertion point is a ballot count (the entries before (v, i) are a
// prefix), and the tail moves down one place by warp shuffles.
__device__ __forceinline__ void warp_topk_insert(float* lv, int* li, int k,
                                                 float v, int i, int lane) {
  const int j0 = lane, j1 = lane + 32;
  float a0 = -INFINITY, a1 = -INFINITY;
  int i0 = kEmptyIndex, i1 = kEmptyIndex;
  if (j0 < k) a0 = lv[j0], i0 = li[j0];
  if (j1 < k) a1 = lv[j1], i1 = li[j1];
  const int pos =
      __popc(__ballot_sync(kFullMask, j0 < k && topk_before(a0, i0, v, i))) +
      __popc(__ballot_sync(kFullMask, j1 < k && topk_before(a1, i1, v, i)));
  float p0 = __shfl_up_sync(kFullMask, a0, 1);
  int q0 = __shfl_up_sync(kFullMask, i0, 1);
  float p1 = __shfl_up_sync(kFullMask, a1, 1);
  int q1 = __shfl_up_sync(kFullMask, i1, 1);
  const float last0 = __shfl_sync(kFullMask, a0, 31);
  const int last_i0 = __shfl_sync(kFullMask, i0, 31);
  if (lane == 0) p1 = last0, q1 = last_i0;
  __syncwarp();  // every lane has read the list before any lane writes
  if (j0 < k && j0 >= pos) {
    lv[j0] = j0 == pos ? v : p0;
    li[j0] = j0 == pos ? i : q0;
  }
  if (j1 < k && j1 >= pos) {
    lv[j1] = j1 == pos ? v : p1;
    li[j1] = j1 == pos ? i : q1;
  }
  __syncwarp();
}

// Fold one streaming-logsumexp partial (m2, s2) into (m, s): the
// reference's `_fold_lse` (code2vec_tpu/ops/topk.py:59), where a partial
// with a non-finite max contributes nothing. Inputs are finite or -inf.
__device__ __forceinline__ void lse_combine(float& m, float& s, float m2,
                                            float s2) {
  const float nm = fmaxf(m, m2);
  const float safe = isfinite(nm) ? nm : 0.f;
  const float a = isfinite(m) ? s * expf(m - safe) : 0.f;
  const float b = isfinite(m2) ? s2 * expf(m2 - safe) : 0.f;
  m = nm;
  s = a + b;
}

__device__ __forceinline__ void warp_lse_reduce(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFullMask, m, off);
    const float s2 = __shfl_xor_sync(kFullMask, s, off);
    lse_combine(m, s, m2, s2);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

// Dropout's random bits: Philox4x32-10 (Salmon et al., SC'11), a
// counter-based generator. The key is the 64-bit seed; the counter is
// (group, step), where an element's group is its flat index / 4 and the
// element takes word index % 4 of the group's output. So any kernel can
// redraw any element's bit from (seed, step, index) without storing a
// mask.
__device__ __forceinline__ uint4 philox4x32_10(uint64_t group,
                                               uint64_t step,
                                               uint64_t seed) {
  uint32_t c0 = static_cast<uint32_t>(group);
  uint32_t c1 = static_cast<uint32_t>(group >> 32);
  uint32_t c2 = static_cast<uint32_t>(step);
  uint32_t c3 = static_cast<uint32_t>(step >> 32);
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0, c1 = lo1, c2 = n2, c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// How a kernel learns which context elements dropout keeps.
//   mode 0: no dropout (keep everything, no scaling);
//   mode 1: Philox bits keyed by (seed, step), kept iff bits >> 8 <
//           threshold (= keep * 2^24); `mask`, when not null, receives the
//           drawn mask (one byte per element);
//   mode 2: the caller's mask (one byte per element, nonzero = kept).
struct Dropout {
  int mode;
  uint32_t threshold;
  float keep;  // the keep rate, exact in bf16 (the reference's bf16(keep))
  uint64_t seed, step;
  uint8_t* mask;
};

// The keep bits of the four elements [4 * group, 4 * group + 4).
__device__ __forceinline__ void dropout_keep4(const Dropout& d,
                                              uint64_t group, bool k[4]) {
  if (d.mode == 0) {
    k[0] = k[1] = k[2] = k[3] = true;
  } else if (d.mode == 2) {
    const uchar4 m = *reinterpret_cast<const uchar4*>(d.mask + 4 * group);
    k[0] = m.x, k[1] = m.y, k[2] = m.z, k[3] = m.w;
  } else {
    const uint4 r = philox4x32_10(group, d.step, d.seed);
    k[0] = (r.x >> 8) < d.threshold, k[1] = (r.y >> 8) < d.threshold;
    k[2] = (r.z >> 8) < d.threshold, k[3] = (r.w >> 8) < d.threshold;
  }
}

}  // namespace c2v
