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

}  // namespace c2v
