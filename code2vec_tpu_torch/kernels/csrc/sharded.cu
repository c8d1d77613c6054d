// K14 shard_gather / shard_scatter_add / shard_local_ids and K15
// tp_softmax_xent: the tensor-parallel device functions of the parallel
// train and eval steps, around the collectives that kernels/sharded.py's
// callers (ops/sharded.py, training/step.py) run between them.
//
// K14 replaces code2vec_tpu/ops/sharded.py tp_embedding_lookup (:32-47)
// before its psum, the transpose of that gather in the dense step (a
// scatter-add into the row shard), and the sparse step's `to_local`
// (code2vec_tpu/training/step.py:453-459). A rank holds rows
// [offset, offset + rows_local) of a table; a global id outside them
// gathers zeros, scatters nothing and maps to the dropped id rows_local.
//
// K15 replaces tp_softmax_ce (:59-84) and tp_log_softmax_at_topk
// (:87-94), split around the collectives over `model`, and the gradient
// of tp_softmax_ce. Over a rank's (B, n_cols) slice of the logits (row
// stride ld), with its first n_valid columns real target rows:
//   max pass:   m[b] = max_v x[b, v]                  -> all-reduce MAX
//   sum pass:   s[b] = sum_v exp(x[b, v] - M[b]), and the label's logit
//               where the label lies in this slice (0 elsewhere)
//                                                     -> all-reduce SUM
//   grad pass:  g[b, v] = (exp(x - M) / S - [v == label]) * valid[b] / N
//               as two bf16 planes hi = bf16(g), lo = bf16(g - hi), as K7
//               writes them (csrc/softmax_xent.cu), zero past n_valid.
// Train mode: the columns past n_valid (padded target rows) are -inf, as
// the reference's _mask_padded_target_cols (step.py:328-336). Floor mode
// (the eval step, step.py:585): a non-finite logit is -1e30, and so is
// every padded column, exactly where the reference substitutes. A
// non-finite global max is taken as 0 inside exp (no row has one at the
// flagship shapes). N is the global batch.
//
// What bounds them on an H100: bytes. K14's gather reads the gathered
// rows once and writes the (N, d) f32 rows once; its scatter reads the
// rows and adds them into the shard (f32 atomics: the shard's rows sum
// in an order that changes from run to run, as K5's dense mode does);
// K15 reads the (B, V/tp) logits in each pass (3 reads in train, 2 in
// eval) and writes the bf16 planes once.
// Design, simple first: K14 a warp per id (the lanes over the row, 16
// bytes a lane where the row allows); K15 a CTA of 512 threads per row,
// the threads striding over the columns, the row's max and sum reduced
// in a fixed order (warp shuffles, then the warps' results in order), so
// every rank of a group sees the same bits from the same inputs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ------------------------------------------------------------------ K14

__global__ void __launch_bounds__(kThreads)
shard_gather_kernel(const float* __restrict__ table, int64_t rows_local,
                    int d, const int* __restrict__ ids, int64_t n,
                    int64_t offset, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t local = static_cast<int64_t>(ids[i]) - offset;
  const bool in = local >= 0 && local < rows_local;
  float* dst = out + i * d;
  if ((d & 3) == 0) {
    const float4* src =
        reinterpret_cast<const float4*>(table + (in ? local : 0) * d);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int j = lane; j < d / 4; j += 32)
      dst4[j] = in ? __ldg(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const float* src = table + (in ? local : 0) * d;
    for (int j = lane; j < d; j += 32) dst[j] = in ? __ldg(src + j) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
shard_scatter_add_kernel(float* __restrict__ grad, int64_t rows_local,
                         int d, const int* __restrict__ ids, int64_t n,
                         int64_t offset, const T* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;
  const int64_t local = static_cast<int64_t>(ids[i]) - offset;
  if (local < 0 || local >= rows_local) return;
  float* g = grad + local * d;
  const T* r = rows + i * d;
  for (int j = lane; j < d; j += 32) atomicAdd(g + j, to_f32(r[j]));
}

__global__ void __launch_bounds__(kThreads)
shard_local_ids_kernel(const int* __restrict__ ids, int64_t n,
                       int64_t offset, int64_t rows_local,
                       int* __restrict__ out) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t local = static_cast<int64_t>(ids[i]) - offset;
    out[i] = static_cast<int>(local >= 0 && local < rows_local ? local
                                                               : rows_local);
  }
}

// ------------------------------------------------------------------ K15

// Column v's value as the passes see it (see the header).
__device__ __forceinline__ float xent_value(float x, int64_t v,
                                            int64_t n_valid, int floor) {
  if (v >= n_valid) return floor ? -1e30f : -INFINITY;
  if (floor && !isfinite(x)) return -1e30f;
  return x;
}

// The CTA's reduction of one value per thread, in a fixed order; every
// thread gets the result. `red` holds kRowWarps floats.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? c2v::warp_max(x) : c2v::warp_sum(x);
  __syncthreads();  // `red` may still be read by an earlier reduction
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kRowWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

__global__ void __launch_bounds__(kRowThreads)
tp_xent_max_kernel(const float* __restrict__ logits, int64_t ld,
                   int64_t n_cols, int64_t n_valid, int floor,
                   float* __restrict__ out) {
  __shared__ float red[kRowWarps];
  const int64_t row = blockIdx.x;
  const float* x = logits + row * ld;
  float m = -INFINITY;
  for (int64_t v = threadIdx.x; v < n_cols; v += kRowThreads)
    m = fmaxf(m, xent_value(__ldg(x + v), v, n_valid, floor));
  m = block_reduce<true>(m, red);
  if (threadIdx.x == 0) out[row] = m;
}

// out: (2, b) f32: the sums, then the label logits.
__global__ void __launch_bounds__(kRowThreads)
tp_xent_sum_kernel(const float* __restrict__ logits, int64_t ld, int b,
                   int64_t n_cols, int64_t n_valid, int floor,
                   const float* __restrict__ gmax,
                   const int* __restrict__ labels, int64_t offset,
                   float* __restrict__ out) {
  __shared__ float red[kRowWarps];
  const int64_t row = blockIdx.x;
  const float* x = logits + row * ld;
  const float mx = gmax[row];
  const float safe = isfinite(mx) ? mx : 0.f;
  float s = 0.f;
  for (int64_t v = threadIdx.x; v < n_cols; v += kRowThreads)
    s += expf(xent_value(__ldg(x + v), v, n_valid, floor) - safe);
  s = block_reduce<false>(s, red);
  if (threadIdx.x == 0) {
    out[row] = s;
    const int64_t lab = static_cast<int64_t>(labels[row]) - offset;
    out[b + row] = lab >= 0 && lab < n_cols
                       ? xent_value(x[lab], lab, n_valid, floor)
                       : 0.f;
  }
}

// planes: (2, b, ld) bf16, hi then lo.
__global__ void __launch_bounds__(kRowThreads)
tp_xent_grad_kernel(const float* __restrict__ logits, int64_t ld, int b,
                    int64_t n_valid, const float* __restrict__ gmax,
                    const float* __restrict__ gsum,
                    const int* __restrict__ labels,
                    const float* __restrict__ valid, int64_t offset,
                    float inv_count, __nv_bfloat16* __restrict__ planes) {
  const int64_t row = blockIdx.x;
  const float* x = logits + row * ld;
  const float mx = gmax[row];
  const float safe = isfinite(mx) ? mx : 0.f;
  const float sum = gsum[row];
  const float scale = valid[row] * inv_count;
  const int64_t lab = static_cast<int64_t>(labels[row]) - offset;
  __nv_bfloat16* hi = planes + row * ld;
  __nv_bfloat16* lo = planes + (static_cast<int64_t>(b) + row) * ld;
  for (int64_t v = threadIdx.x; v < ld; v += kRowThreads) {
    float g = 0.f;
    if (v < n_valid) {
      g = expf(__ldg(x + v) - safe) / sum * scale;
      if (v == lab) g -= scale;
    }
    const __nv_bfloat16 h = __float2bfloat16_rn(g);
    hi[v] = h;
    lo[v] = __float2bfloat16_rn(g - __bfloat162float(h));
  }
}

unsigned warp_blocks(int64_t n) {
  return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace

// table f32 (rows_local, d), 16-byte aligned where d % 4 == 0; ids int32
// (n,); out f32 (n, d). Returns a cudaError_t.
C2V_EXPORT int c2v_shard_gather(const float* table, int64_t rows_local,
                                int d, const int* ids, int64_t n,
                                int64_t offset, float* out, void* stream) {
  if (rows_local <= 0 || d <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  shard_gather_kernel<<<warp_blocks(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, rows_local, d, ids, n, offset, out);
  return cudaGetLastError();
}

// grad f32 (rows_local, d) += rows (n, d), f32 (bf16_rows 0) or bf16
// (1), at the in-range ids.
C2V_EXPORT int c2v_shard_scatter_add(float* grad, int64_t rows_local, int d,
                                     const int* ids, int64_t n,
                                     int64_t offset, const void* rows,
                                     int bf16_rows, void* stream) {
  if (rows_local <= 0 || d <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_rows)
    shard_scatter_add_kernel<<<warp_blocks(n), kThreads, 0, s>>>(
        grad, rows_local, d, ids, n, offset,
        static_cast<const __nv_bfloat16*>(rows));
  else
    shard_scatter_add_kernel<<<warp_blocks(n), kThreads, 0, s>>>(
        grad, rows_local, d, ids, n, offset,
        static_cast<const float*>(rows));
  return cudaGetLastError();
}

// out int32 (n,): ids - offset where in [0, rows_local), else rows_local.
C2V_EXPORT int c2v_shard_local_ids(const int* ids, int64_t n, int64_t offset,
                                   int64_t rows_local, int* out,
                                   void* stream) {
  if (rows_local <= 0 || n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < 4096 ? want : 4096);
  shard_local_ids_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      ids, n, offset, rows_local, out);
  return cudaGetLastError();
}

// logits f32 (b, ld), the first n_cols columns this rank's; out f32 (b,).
C2V_EXPORT int c2v_tp_xent_max(const float* logits, int b, int64_t ld,
                               int64_t n_cols, int64_t n_valid, int floor,
                               float* out, void* stream) {
  if (b <= 0 || n_cols <= 0 || ld < n_cols || n_valid < 0 ||
      n_valid > n_cols)
    return cudaErrorInvalidValue;
  tp_xent_max_kernel<<<b, kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      logits, ld, n_cols, n_valid, floor, out);
  return cudaGetLastError();
}

// gmax f32 (b,), labels int32 (b,) global; out f32 (2, b).
C2V_EXPORT int c2v_tp_xent_sum(const float* logits, int b, int64_t ld,
                               int64_t n_cols, int64_t n_valid, int floor,
                               const float* gmax, const int* labels,
                               int64_t offset, float* out, void* stream) {
  if (b <= 0 || n_cols <= 0 || ld < n_cols || n_valid < 0 ||
      n_valid > n_cols)
    return cudaErrorInvalidValue;
  tp_xent_sum_kernel<<<b, kRowThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      logits, ld, b, n_cols, n_valid, floor, gmax, labels, offset, out);
  return cudaGetLastError();
}

// gmax, gsum, valid f32 (b,); labels int32 (b,); planes bf16 (2, b, ld).
C2V_EXPORT int c2v_tp_xent_grad(const float* logits, int b, int64_t ld,
                                int64_t n_valid, const float* gmax,
                                const float* gsum, const int* labels,
                                const float* valid, int64_t offset,
                                float inv_count, void* planes,
                                void* stream) {
  if (b <= 0 || ld <= 0 || n_valid < 0 || n_valid > ld)
    return cudaErrorInvalidValue;
  tp_xent_grad_kernel<<<b, kRowThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      logits, ld, b, n_valid, gmax, gsum, labels, valid, offset, inv_count,
      static_cast<__nv_bfloat16*>(planes));
  return cudaGetLastError();
}
