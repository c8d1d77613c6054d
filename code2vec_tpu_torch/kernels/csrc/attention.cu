// K2 masked_attention: masked single-query attention over the contexts.
//
// Replaces code2vec_tpu/ops/attention.py masked_single_query_attention
// (:28-69) with axis_name=None: scores T.a in f32 with `a` rounded to
// bf16, -inf on invalid contexts, a max-stabilised softmax whose
// all-invalid rows are pinned to zero weights (:54-58), then the code
// vector sum(bf16(attn) * T) in f32 (:65).
//
// What bounds it on an H100: bytes. It reads the (B, M, 384) bf16 contexts
// twice (scores, then the weighted sum) and does 4 flops per element, far
// below the card's ratio of ~295 flops per byte. Design: one CTA per batch
// row keeps the row's scores in shared memory, so the softmax never
// leaves the SM; the second pass over the row's contexts (150 KB at
// M=200) is served from L2. Both passes use vector loads (16 bytes per
// lane for the scores, two columns per thread for the sum). Reading the
// contexts once would need fusing this into K1's epilogue, later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ float block_reduce(float x, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? c2v::warp_max(x) : c2v::warp_sum(x);
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

__global__ void __launch_bounds__(kThreads)
masked_attention_kernel(const __nv_bfloat16* t, const float* attn_param,
                        const float* mask, int m, int d, float* cv,
                        float* attn) {
  extern __shared__ __align__(16) float sm[];
  float* scores = sm;      // (m,)
  float* a = sm + m;       // (d,) bf16-rounded query
  float* red = a + d;      // (kWarps,)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* row = t + static_cast<int64_t>(b) * m * d;

  for (int i = tid; i < d; i += kThreads) a[i] = c2v::bf16_round(attn_param[i]);
  __syncthreads();

  for (int j = warp; j < m; j += kWarps) {
    const __nv_bfloat16* tj = row + static_cast<int64_t>(j) * d;
    float acc = 0.f;
    for (int i = lane * 8; i < d; i += 256) {  // 8 values per 16-byte load
      const uint4 raw = *reinterpret_cast<const uint4*>(tj + i);
      const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(t2[q]);
        acc += f.x * a[i + 2 * q] + f.y * a[i + 2 * q + 1];
      }
    }
    acc = c2v::warp_sum(acc);
    if (lane == 0)
      scores[j] = mask[static_cast<int64_t>(b) * m + j] > 0.f ? acc : -INFINITY;
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < m; j += kThreads) mx = fmaxf(mx, scores[j]);
  mx = block_reduce(mx, red, true);
  const float safe = isfinite(mx) ? mx : 0.f;
  float sum = 0.f;
  for (int j = tid; j < m; j += kThreads) {
    const float e = expf(scores[j] - safe);
    scores[j] = e;
    sum += e;
  }
  const float denom = fmaxf(block_reduce(sum, red, false), 1e-30f);
  for (int j = tid; j < m; j += kThreads) {
    const float w = scores[j] / denom;
    attn[static_cast<int64_t>(b) * m + j] = w;
    scores[j] = c2v::bf16_round(w);
  }
  __syncthreads();

  for (int i = tid * 2; i < d; i += kThreads * 2) {  // two columns each
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<
          const __nv_bfloat162*>(row + static_cast<int64_t>(j) * d + i));
      acc0 += scores[j] * f.x;
      acc1 += scores[j] * f.y;
    }
    cv[static_cast<int64_t>(b) * d + i] = acc0;
    cv[static_cast<int64_t>(b) * d + i + 1] = acc1;
  }
}

}  // namespace

// t: bf16 (b, m, d); attn_param: f32 (d,); mask: f32 (b, m).
// cv: f32 (b, d); attn: f32 (b, m). Returns a cudaError_t.
C2V_EXPORT int c2v_masked_attention(const void* t, const float* attn_param,
                                    const float* mask, int b, int m, int d,
                                    float* cv, float* attn, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (static_cast<size_t>(m) + d + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  masked_attention_kernel<<<b, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), attn_param, mask, m, d, cv, attn);
  return cudaGetLastError();
}
