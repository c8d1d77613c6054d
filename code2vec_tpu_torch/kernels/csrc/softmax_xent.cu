// K7 softmax_xent: the train loss and its gradient over the logits.
//
// Replaces code2vec_tpu/training/step.py _loss_from_logits (:170-175),
// which is optax.softmax_cross_entropy_with_integer_labels times `valid`,
// summed and divided by the batch size B, together with its gradient
// under jax.grad. Per row b of the (B, V) f32 logits x, with columns at or
// past `n_real` taken as -inf (the padded target rows of
// models/code2vec.py:207-210, absent at tp=1):
//   lse      = max + log(sum exp(x - max))
//   ce[b]    = (lse - x[label]) * valid[b]
//   g[b, v]  = (exp(x[v] - max) / sum - [v == label]) * valid[b] / B
//   loss     = sum_b ce[b] / B
// The gradient is written as two bf16 planes hi = bf16(g) and
// lo = bf16(g - hi) (a (2, B, V) tensor): the operands of the classifier's
// two backward products on the bf16 tensor cores (models/code2vec.py),
// which then carry g to about 2^-17 relative, as the reference's f32 g
// times the bf16 operands, rounded after the product.
// A label outside [0, n_real) gives a NaN loss and no one-hot term, as the
// reference's FILL_OR_DROP gather and scatter do.
//
// What bounds it on an H100: bytes. At the train shape (1024 x 261,246)
// it must read 1.07 GB of logits and write 1.07 GB of gradient (two bf16
// planes).
// Design: one CTA per row, walking it in pairs where the width is even
// (8-byte loads, paired stores; single elements otherwise), four units
// in flight a thread; pass 1 keeps an online (max, sum-exp) per thread
// and merges them with warp shuffles; pass 2 reads the row again (partly
// from L2) and writes the gradient. A one-CTA second launch adds the
// rows' terms in a fixed order. Reading the row once would need the row
// held on chip (1 MB, more than an SM's shared memory) or a split over
// CTAs with a merge, later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

constexpr int kUnroll = 4;  // units in flight per thread

// Online (max, sum-exp) over the row: one element.
__device__ __forceinline__ void online_add(float& m, float& s, float xj) {
  if (xj == -INFINITY) return;
  if (xj > m) {
    s = (m == -INFINITY ? 0.f : s * expf(m - xj)) + 1.f;
    m = xj;
  } else {
    s += expf(xj - m);  // NaN stays NaN
  }
}

// Writes the gradient of elements j (and j + 1 when kW == 2) of the
// flattened (b, v) gradient: hi to the first plane, lo to the second,
// `plane` elements on.
template <int kW>
__device__ __forceinline__ void store_grad(__nv_bfloat16* grad,
                                           int64_t plane, int64_t at,
                                           const float* g) {
  if constexpr (kW == 2) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(g[0], g[1]);
    const float2 h = __bfloat1622float2(hi);
    *reinterpret_cast<__nv_bfloat162*>(grad + at) = hi;
    *reinterpret_cast<__nv_bfloat162*>(grad + plane + at) =
        __floats2bfloat162_rn(g[0] - h.x, g[1] - h.y);
  } else {
    const __nv_bfloat16 hi = __float2bfloat16_rn(g[0]);
    grad[at] = hi;
    grad[plane + at] = __float2bfloat16_rn(g[0] - __bfloat162float(hi));
  }
}

template <int kW>
__device__ __forceinline__ void load_unit(const float* x, int64_t p,
                                          float* out) {
  if constexpr (kW == 2) {
    const float2 f = reinterpret_cast<const float2*>(x)[p];
    out[0] = f.x, out[1] = f.y;
  } else {
    out[0] = x[p];
  }
}

// The row is walked in units of kW elements: pairs (8-byte loads, paired
// stores) where v is even, so that every row starts 8-byte aligned, and
// single elements otherwise; kUnroll units in flight a thread.
template <int kW>
__global__ void __launch_bounds__(kThreads)
softmax_xent_rows(const float* logits, int64_t v, int64_t n_real,
                  const int* labels, const float* valid, float inv_b,
                  __nv_bfloat16* grad, float* ce) {
  __shared__ float red_m[kWarps], red_s[kWarps];
  const int64_t b = blockIdx.x;
  const float* x = logits + b * v;
  const int64_t units = v / kW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float m = -INFINITY, s = 0.f;
  for (int64_t p0 = tid; p0 < units; p0 += kUnroll * kThreads) {
    float xx[kUnroll][kW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * kThreads;
      if (p < units) {
        load_unit<kW>(x, p, xx[u]);
      } else {
#pragma unroll
        for (int w = 0; w < kW; ++w) xx[u][w] = -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int w = 0; w < kW; ++w)
        if (kW * (p0 + u * kThreads) + w < n_real)
          online_add(m, s, xx[u][w]);
  }
  c2v::warp_lse_reduce(m, s);
  if (lane == 0) red_m[warp] = m, red_s[warp] = s;
  __syncthreads();
  m = red_m[0], s = red_s[0];
  for (int i = 1; i < kWarps; ++i) c2v::lse_combine(m, s, red_m[i], red_s[i]);

  const int label = labels[b];
  const bool in_range = label >= 0 && label < n_real;
  const float scale = valid[b] * inv_b;
  const int64_t plane = static_cast<int64_t>(gridDim.x) * v;
  for (int64_t p0 = tid; p0 < units; p0 += kUnroll * kThreads) {
    float xx[kUnroll][kW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * kThreads;
      if (p < units) load_unit<kW>(x, p, xx[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = kW * (p0 + u * kThreads);
      if (j >= v) break;
      float g[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        g[w] = 0.f;
        if (j + w < n_real) {
          g[w] = (expf(xx[u][w] - m) / s) * scale;
          if (j + w == label) g[w] = g[w] - scale;
        }
      }
      store_grad<kW>(grad, plane, b * v + j, g);
    }
  }
  if (tid == 0) {
    const float lse = m + logf(s);
    ce[b] = (in_range ? lse - x[label] : nanf("")) * valid[b];
  }
}


__global__ void sum_rows(const float* ce, int b, float* loss) {
  __shared__ float red[kWarps];
  float s = 0.f;
  for (int i = threadIdx.x; i < b; i += kThreads) s += ce[i];
  s = c2v::warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += red[i];
    *loss = t / static_cast<float>(b);
  }
}

}  // namespace

// logits: f32 (b, v); labels: int32 (b,); valid: f32 (b,). Outputs: grad
// bf16 (2, b, v) hi/lo planes; ce f32 (b,) scratch; loss f32 ().
// Returns a cudaError_t.
C2V_EXPORT int c2v_softmax_xent(const float* logits, int b, int64_t v,
                                int64_t n_real, const int* labels,
                                const float* valid, void* grad, float* ce,
                                float* loss, void* stream) {
  if (b <= 0 || v <= 0 || n_real <= 0 || n_real > v)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_b = 1.f / static_cast<float>(b);
  auto* g = static_cast<__nv_bfloat16*>(grad);
  if (v % 2 == 0)
    softmax_xent_rows<2><<<b, kThreads, 0, s>>>(logits, v, n_real, labels,
                                                valid, inv_b, g, ce);
  else
    softmax_xent_rows<1><<<b, kThreads, 0, s>>>(logits, v, n_real, labels,
                                                valid, inv_b, g, ce);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows<<<1, kThreads, 0, s>>>(ce, b, loss);
  return cudaGetLastError();
}
