// K16 cp_attention and K17 cp_attention_backward: masked single-query
// attention with the contexts split over the `ctx` axis, and its
// backward, each a few phases around the collectives that
// ops/attention.py runs between them.
//
// K16 replaces code2vec_tpu/ops/attention.py masked_single_query_attention
// with `axis_name` set (:52, :60, :67); K17 its autodiff in the manual
// train step. A rank holds contexts [c M/cp, (c + 1) M/cp) of every row:
// t (B, m) x D bf16 (tanh(ctx @ W)), the query a (D,), the mask (B, m).
//   scores   s = t . bf16(a) (f32), -inf where the mask is 0; the rank's
//            max                                       -> all-reduce MAX
//   exp      u = exp(s - M), M = 0 where the global max is not finite
//            (an all-invalid row, ops/attention.py:54-58); the rank's
//            sum of u                                  -> all-reduce SUM
//   combine  w = u / max(S, 1e-30); the rank's part of the code vector
//            sum_m bf16(w) t (f32)                     -> all-reduce SUM
// The backward, from the code vector's cotangent g (B, D) f32 and the
// forward's weights w, at the rounding points of jax.grad of the
// reference (those of K6, csrc/attention_backward.cu):
//   fs       fs = bf16(g . t) (f32), and the rank's sum_m w fs
//                                                      -> all-reduce SUM
//            (the cotangent of the denominator, which the reference's
//            psum transposes into a sum over ctx)
//   dt       ds = w (fs - sum w fs) on valid contexts (0 elsewhere);
//            dt = bf16(bf16(bf16(w) g) + bf16(ds bf16(a))); each row's
//            sum_m ds t (f32), then in a second launch da = bf16 of the
//            rows' sum in row order: the rank's part of d a, which the
//            step reduces over data and ctx.
// Every sum runs in a fixed order, so ranks that hold the same inputs
// (the model ranks of a (data, ctx) cell) get the same bits.
//
// What bounds them on an H100: bytes. Each reads the (B, M/cp, 384) bf16
// activations: the forward twice (scores, combine), the backward twice
// (fs, dt) and writes dt once.
// Design, simple first: a CTA per row for the scores, exp and fs phases
// (a warp per context, the lanes over D); a CTA per (row, 128 columns of
// D) for combine and dt, a thread per column walking the contexts, the
// row's weights first staged in shared memory by the CTA.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;  // columns of D a combine / dt CTA owns

template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? c2v::warp_max(x) : c2v::warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// g . t[row, j] over D: the lanes of a warp over the columns, then a
// warp sum; `q` is f32 (the rounded query, or g).
__device__ __forceinline__ float warp_dot(const __nv_bfloat16* t,
                                          const float* q, int d, int lane) {
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) acc += __bfloat162float(t[k]) * q[k];
  return c2v::warp_sum(acc);
}

// scores (b, m) f32, lmax (b,) f32.
__global__ void __launch_bounds__(kThreads)
cp_scores_kernel(const __nv_bfloat16* __restrict__ t,
                 const float* __restrict__ a, const float* __restrict__ mask,
                 int m, int d, float* __restrict__ scores,
                 float* __restrict__ lmax) {
  extern __shared__ float q[];  // d: bf16(a)
  __shared__ float red[kWarps];
  const int row = blockIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < d; k += kThreads) q[k] = c2v::bf16_round(a[k]);
  __syncthreads();
  float mx = -INFINITY;
  for (int j = warp; j < m; j += kWarps) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    const float s = warp_dot(t + e * d, q, d, lane);
    const float v = mask[e] > 0.f ? s : -INFINITY;
    if (lane == 0) scores[e] = v;
    mx = fmaxf(mx, v);
  }
  mx = block_reduce<true>(mx, red);
  if (threadIdx.x == 0) lmax[row] = mx;
}

// unnorm (b, m) f32, ldenom (b,) f32.
__global__ void __launch_bounds__(kThreads)
cp_exp_kernel(const float* __restrict__ scores,
              const float* __restrict__ gmax, int m,
              float* __restrict__ unnorm, float* __restrict__ ldenom) {
  __shared__ float red[kWarps];
  const int row = blockIdx.x;
  const float mx = gmax[row];
  const float safe = isfinite(mx) ? mx : 0.f;
  float s = 0.f;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    const float u = expf(scores[e] - safe);
    unnorm[e] = u;
    s += u;
  }
  s = block_reduce<false>(s, red);
  if (threadIdx.x == 0) ldenom[row] = s;
}

// cv (b, d) f32: this rank's part; attn (b, m) f32 (written by the CTAs
// of the first column block).
__global__ void __launch_bounds__(kCols)
cp_combine_kernel(const __nv_bfloat16* __restrict__ t,
                  const float* __restrict__ unnorm,
                  const float* __restrict__ gdenom, int m, int d,
                  float* __restrict__ cv, float* __restrict__ attn) {
  extern __shared__ float w[];  // m: bf16(weight)
  const int row = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const float den = fmaxf(gdenom[row], 1e-30f);
  for (int j = threadIdx.x; j < m; j += kCols) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    const float a = unnorm[e] / den;
    if (blockIdx.y == 0) attn[e] = a;
    w[j] = c2v::bf16_round(a);
  }
  __syncthreads();
  if (col >= d) return;
  const __nv_bfloat16* tr = t + static_cast<int64_t>(row) * m * d + col;
  float acc = 0.f;
  for (int j = 0; j < m; ++j)
    acc += w[j] * __bfloat162float(tr[static_cast<int64_t>(j) * d]);
  cv[static_cast<int64_t>(row) * d + col] = acc;
}

// fs (b, m) f32, wfs (b,) f32.
__global__ void __launch_bounds__(kThreads)
cp_fs_kernel(const __nv_bfloat16* __restrict__ t,
             const float* __restrict__ attn, const float* __restrict__ g,
             int m, int d, float* __restrict__ fs,
             float* __restrict__ wfs) {
  extern __shared__ float q[];  // d: g of this row
  __shared__ float part[kWarps];
  const int row = blockIdx.x, lane = threadIdx.x & 31,
            warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < d; k += kThreads)
    q[k] = g[static_cast<int64_t>(row) * d + k];
  __syncthreads();
  // each warp sums w fs over its contexts in order; then the warps' sums
  // in order (a fixed order for a given m)
  float acc = 0.f;
  for (int j = warp; j < m; j += kWarps) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    const float f = c2v::bf16_round(warp_dot(t + e * d, q, d, lane));
    if (lane == 0) fs[e] = f;
    acc += attn[e] * f;
  }
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = part[0];
    for (int w = 1; w < kWarps; ++w) s += part[w];
    wfs[row] = s;
  }
}

// dt (b, m, d) bf16; da_rows (b, d) f32.
__global__ void __launch_bounds__(kCols)
cp_dt_kernel(const __nv_bfloat16* __restrict__ t,
             const float* __restrict__ a, const float* __restrict__ mask,
             const float* __restrict__ attn, const float* __restrict__ fs,
             const float* __restrict__ wfs, const float* __restrict__ g,
             int m, int d, __nv_bfloat16* __restrict__ dt,
             float* __restrict__ da_rows) {
  extern __shared__ float sh[];  // m: ds, then m: bf16(w)
  float* ds = sh;
  float* w = sh + m;
  const int row = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const float total = wfs[row];
  for (int j = threadIdx.x; j < m; j += kCols) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    ds[j] = mask[e] > 0.f ? attn[e] * (fs[e] - total) : 0.f;
    w[j] = c2v::bf16_round(attn[e]);
  }
  __syncthreads();
  if (col >= d) return;
  const float gc = g[static_cast<int64_t>(row) * d + col];
  const float ac = c2v::bf16_round(a[col]);
  const int64_t base = static_cast<int64_t>(row) * m * d + col;
  float acc = 0.f;
  for (int j = 0; j < m; ++j) {
    const int64_t e = base + static_cast<int64_t>(j) * d;
    const float v = c2v::bf16_round(w[j] * gc) + c2v::bf16_round(ds[j] * ac);
    dt[e] = __float2bfloat16_rn(v);
    acc += ds[j] * __bfloat162float(t[e]);
  }
  da_rows[static_cast<int64_t>(row) * d + col] = acc;
}

// da (d,) f32: bf16 of the rows' sum, in row order.
__global__ void __launch_bounds__(kCols)
cp_da_kernel(const float* __restrict__ da_rows, int b, int d,
             float* __restrict__ da) {
  const int col = blockIdx.x * kCols + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int r = 0; r < b; ++r) acc += da_rows[static_cast<int64_t>(r) * d + col];
  da[col] = c2v::bf16_round(acc);
}

}  // namespace

// t bf16 (b, m, d); a f32 (d,); mask f32 (b, m); scores f32 (b, m);
// lmax f32 (b,). Returns a cudaError_t.
C2V_EXPORT int c2v_cp_attention_scores(const void* t, const float* a,
                                       const float* mask, int b, int m,
                                       int d, float* scores, float* lmax,
                                       void* stream) {
  if (b <= 0 || m <= 0 || d <= 0) return cudaErrorInvalidValue;
  cp_scores_kernel<<<b, kThreads, d * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), a, mask, m, d, scores, lmax);
  return cudaGetLastError();
}

// scores f32 (b, m); gmax f32 (b,); unnorm f32 (b, m); ldenom f32 (b,).
C2V_EXPORT int c2v_cp_attention_exp(const float* scores, const float* gmax,
                                    int b, int m, float* unnorm,
                                    float* ldenom, void* stream) {
  if (b <= 0 || m <= 0) return cudaErrorInvalidValue;
  cp_exp_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, gmax, m, unnorm, ldenom);
  return cudaGetLastError();
}

// t bf16 (b, m, d); unnorm f32 (b, m); gdenom f32 (b,); cv f32 (b, d);
// attn f32 (b, m).
C2V_EXPORT int c2v_cp_attention_combine(const void* t, const float* unnorm,
                                        const float* gdenom, int b, int m,
                                        int d, float* cv, float* attn,
                                        void* stream) {
  if (b <= 0 || m <= 0 || d <= 0) return cudaErrorInvalidValue;
  const dim3 grid(b, (d + kCols - 1) / kCols);
  cp_combine_kernel<<<grid, kCols, m * sizeof(float),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), unnorm, gdenom, m, d, cv, attn);
  return cudaGetLastError();
}

// t bf16 (b, m, d); attn f32 (b, m); g f32 (b, d); fs f32 (b, m); wfs f32
// (b,).
C2V_EXPORT int c2v_cp_attention_backward_fs(const void* t, const float* attn,
                                            const float* g, int b, int m,
                                            int d, float* fs, float* wfs,
                                            void* stream) {
  if (b <= 0 || m <= 0 || d <= 0) return cudaErrorInvalidValue;
  cp_fs_kernel<<<b, kThreads, d * sizeof(float),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), attn, g, m, d, fs, wfs);
  return cudaGetLastError();
}

// t bf16 (b, m, d); a f32 (d,); mask, attn, fs f32 (b, m); wfs f32 (b,)
// summed over ctx; g f32 (b, d); dt bf16 (b, m, d); da_rows f32 (b, d)
// scratch; da f32 (d,).
C2V_EXPORT int c2v_cp_attention_backward_dt(
    const void* t, const float* a, const float* mask, const float* attn,
    const float* fs, const float* wfs, const float* g, int b, int m, int d,
    void* dt, float* da_rows, float* da, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(b, (d + kCols - 1) / kCols);
  cp_dt_kernel<<<grid, kCols, 2 * m * sizeof(float), s>>>(
      static_cast<const __nv_bfloat16*>(t), a, mask, attn, fs, wfs, g, m, d,
      static_cast<__nv_bfloat16*>(dt), da_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cp_da_kernel<<<(d + kCols - 1) / kCols, kCols, 0, s>>>(da_rows, b, d, da);
  return cudaGetLastError();
}
