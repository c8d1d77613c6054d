// K6 attention_backward: the backward of K2 (masked single-query
// attention) with respect to the contexts T and the query a.
//
// Replaces the autodiff of code2vec_tpu/ops/attention.py
// masked_single_query_attention (:28-69, axis_name=None) inside jax.grad
// of the dense train step (code2vec_tpu/training/step.py:177-199). With w
// the forward's f32 softmax weights, dcv the code vector's cotangent and
// mask the valid contexts, per batch row:
//   fs[m]  = bf16(dcv . T[m])                          cotangent of bf16(w)
//   ds[m]  = mask[m] ? w[m] (fs[m] - sum_j w[j] fs[j]) : 0   softmax rule
//   dT[m]  = bf16(bf16(bf16(w[m]) dcv) + bf16(ds[m] bf16(a)))
//   da     = bf16(sum_{b,m} ds[m] T[m])                 then f32
// Rows whose contexts are all masked have w = 0 and give 0, as the
// reference's safe_max and maximum(denom, 1e-30) do (the clamp's own
// gradient path is zero whenever a context is valid).
//
// Rounding points, as `jax.make_jaxpr(jax.grad(loss))` of the bf16 model
// shows them (each a convert_element_type to bf16):
//   - the cotangent of attention.astype(bf16): dot(dcv, T) -> bf16;
//   - the two cotangents of the bf16 T: dcv x bf16(w) -> bf16 and
//     ds x bf16(a) -> bf16, added in bf16 (f32 sum, rounded);
//   - the cotangent of a.astype(bf16): dot(ds, T) over (B, M) -> bf16.
// The reference writes the softmax rule as unnorm (fs / denom -
// sum(fs unnorm) / denom^2); the kernel's w (fs - sum w fs) is the same
// value up to f32 rounding.
//
// What bounds it on an H100: bytes. It reads T (B, M, 384 bf16) and writes
// dT of the same size, a few flops per element. Design: one CTA per batch
// row keeps dcv, bf16(a), the scores' cotangents and ds in shared memory;
// pass 1 (one warp per context, 16-byte loads) forms fs, a block
// reduction forms sum w fs, and pass 2 (two columns per thread, walking
// the contexts) writes dT and the row's share of da, read from L2 the
// second time. A second launch adds the rows' da shares in a fixed order
// and rounds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = c2v::warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < kWarps; ++i) r += red[i];
  return r;
}

__global__ void __launch_bounds__(kThreads)
attention_backward_kernel(const __nv_bfloat16* t, const float* attn_param,
                          const float* mask, const float* attn,
                          const float* dcv, int m, int d, __nv_bfloat16* dt,
                          float* da_rows) {
  extern __shared__ __align__(16) float sm[];
  float* ds = sm;          // (m,) fs, then ds
  float* g = ds + m;       // (d,) dcv
  float* a = g + d;        // (d,) bf16-rounded query
  float* red = a + d;      // (kWarps,)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t rb = static_cast<int64_t>(b);
  const __nv_bfloat16* row = t + rb * m * d;
  __nv_bfloat16* drow = dt + rb * m * d;

  for (int i = tid; i < d; i += kThreads) {
    g[i] = dcv[rb * d + i];
    a[i] = c2v::bf16_round(attn_param[i]);
  }
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
        acc += f.x * g[i + 2 * q] + f.y * g[i + 2 * q + 1];
      }
    }
    acc = c2v::warp_sum(acc);
    if (lane == 0) ds[j] = c2v::bf16_round(acc);
  }
  __syncthreads();

  float part = 0.f;
  for (int j = tid; j < m; j += kThreads) part += attn[rb * m + j] * ds[j];
  const float wfs = block_sum(part, red);
  for (int j = tid; j < m; j += kThreads) {
    const float w = attn[rb * m + j];
    ds[j] = mask[rb * m + j] > 0.f ? w * (ds[j] - wfs) : 0.f;
  }
  __syncthreads();

  for (int i = tid * 2; i < d; i += kThreads * 2) {  // two columns each
    float da0 = 0.f, da1 = 0.f;
    const float g0 = g[i], g1 = g[i + 1], a0 = a[i], a1 = a[i + 1];
    for (int j = 0; j < m; ++j) {
      const int64_t off = static_cast<int64_t>(j) * d + i;
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(row + off));
      const float wb = c2v::bf16_round(attn[rb * m + j]);
      const float s = ds[j];
      da0 += s * f.x;
      da1 += s * f.y;
      const float x0 = c2v::bf16_round(wb * g0) + c2v::bf16_round(s * a0);
      const float x1 = c2v::bf16_round(wb * g1) + c2v::bf16_round(s * a1);
      *reinterpret_cast<__nv_bfloat162*>(drow + off) =
          __floats2bfloat162_rn(x0, x1);
    }
    da_rows[rb * d + i] = da0;
    da_rows[rb * d + i + 1] = da1;
  }
}

__global__ void rows_sum_bf16(const float* rows, int b, int d, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d) return;
  float s = 0.f;
  for (int r = 0; r < b; ++r) s += rows[static_cast<int64_t>(r) * d + i];
  out[i] = c2v::bf16_round(s);
}

}  // namespace

// t: bf16 (b, m, d); attn_param: f32 (d,); mask, attn: f32 (b, m); dcv:
// f32 (b, d). Outputs: dt bf16 (b, m, d); da f32 (d,), through the scratch
// da_rows f32 (b, d). Returns a cudaError_t.
C2V_EXPORT int c2v_attention_backward(const void* t, const float* attn_param,
                                      const float* mask, const float* attn,
                                      const float* dcv, int b, int m, int d,
                                      void* dt, float* da_rows, float* da,
                                      void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(m) + 2 * d + kWarps);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_backward_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  attention_backward_kernel<<<b, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(t), attn_param, mask, attn, dcv, m, d,
      static_cast<__nv_bfloat16*>(dt), da_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rows_sum_bf16<<<(d + 127) / 128, 128, 0, s>>>(da_rows, b, d, da);
  return cudaGetLastError();
}
