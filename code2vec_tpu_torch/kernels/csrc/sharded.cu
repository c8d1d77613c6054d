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
// (:87-94), split around one collective over `model`, and the gradient
// of tp_softmax_ce. Over a rank's (B, n_cols) slice of the logits (row
// stride ld), with its first n_valid columns real target rows:
//   stats pass: lm[b] = max_v x[b, v], ls[b] = sum_v exp(x[b, v] - lm[b])
//               (computed online), and the label's logit where the label
//               lies in this slice (0 elsewhere)   -> all-gather, merged
//               in rank order (kernels/sharded.py merge_xent_stats) into
//               the row's global max M and sum S
//   grad pass:  g[b, v] = (exp(x - M) / S - [v == label]) * valid[b] / N
//               as two bf16 planes hi = bf16(g), lo = bf16(g - hi), as K7
//               writes them (csrc/softmax_xent.cu), zero past n_valid.
// Train mode: the columns past n_valid (padded target rows) are -inf, as
// the reference's _mask_padded_target_cols (step.py:328-336). Floor mode
// (the eval step, step.py:585): a non-finite logit is -1e30, and so is
// every padded column, exactly where the reference substitutes. Where a
// max is not finite, exp is taken against 0 instead (the reference's
// pinned max; no row has one at the flagship shapes), so a slice with
// nothing but -inf has lm -inf and ls 0. N is the global batch.
//
// What bounds them on an H100: bytes. K14's gather reads the gathered
// rows once and writes the (N, d) f32 rows once; its scatter reads the
// rows and adds them into the shard (f32 atomics: the shard's rows sum
// in an order that changes from run to run, as K5's dense mode does);
// K15's stats pass reads the (B, V/tp) logits once (535 MB at tp 2 of
// the flagship), the gradient pass reads them once more and writes the
// two bf16 planes once: 1.6 GB a train step, 0.48 ms at the memory rate.
// The max and sum cannot share the gradient's read, since the gradient
// needs the global ones that the collective delivers.
// Design: K14 a warp per id (the lanes over the row, 16 bytes a lane
// where the row allows). K15's stats pass is a CTA of 512 threads a row,
// its gradient pass four CTAs a row (an even share of the row's 16-byte
// units each, the CTAs in reverse row order, so that the rows the stats
// pass read last are still in L2). Both read the row's 16-byte-aligned
// interior by 16-byte loads, four a thread in flight (32 KB a CTA, two or
// more CTAs an SM), the up to 3 elements before and after it by plain
// loads (a row of 130,623 f32 starts 0, 4, 8 or 12 bytes off a 16-byte
// boundary, as K7's rows do). The stats pass keeps an online (max, sum)
// a thread: the max of 16 elements, one rescale, then each element's exp
// as one MUFU exp2 of (x - max) log2 e (the difference first, so x equal
// to a max of -1e30 gives exactly 1); the gradient pass takes scale / S
// once a row and writes hi and lo as 8-byte stores of four bf16. The
// padded columns past n_valid are never read: train mode gives them
// nothing, floor mode folds in their count at -1e30 at the end. Every
// reduction runs in a fixed order (warp butterflies, then the warps in
// order), so two calls, and the model ranks of a cell, give the same
// bits from the same inputs.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kUnroll = 4;       // 16-byte units in flight a thread
constexpr int kGradSlices = 4;   // gradient CTAs a row (wide rows)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFloor = -1e30f;  // the eval step's non-finite logit

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

// 2^t (the MUFU approximation: within ~2^-22 relative, subnormals kept)
__device__ __forceinline__ float exp2_approx(float t) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}

// The shift exp is taken against: the max, or 0 where it is not finite.
__device__ __forceinline__ float shift_of(float m) {
  return isfinite(m) ? m : 0.f;
}

// exp(x - sm), the difference taken first.
__device__ __forceinline__ float exp_at(float x, float sm) {
  return exp2_approx((x - sm) * kLog2e);
}

// (m, s), s the sum of exp(x - shift_of(m)) over some elements, folded
// with another such pair; a sum of 0 stays 0 and a NaN stays NaN.
__device__ __forceinline__ void fold(float& m, float& s, float m2,
                                     float s2) {
  const float nm = fmaxf(m, m2);
  const float sn = shift_of(nm);
  const float a = s == 0.f ? 0.f : s * exp_at(shift_of(m), sn);
  const float b = s2 == 0.f ? 0.f : s2 * exp_at(shift_of(m2), sn);
  m = nm;
  s = a + b;
}

// Folds n values (-inf where absent) into a thread's (m, s): their max,
// one rescale of s, then their exps.
template <int n>
__device__ __forceinline__ void fold_values(float& m, float& s,
                                            const float (&v)[n]) {
  float bm = m;
#pragma unroll
  for (int i = 0; i < n; ++i) bm = fmaxf(bm, v[i]);
  if (bm > m) {
    s = s == 0.f ? 0.f : s * exp_at(shift_of(m), shift_of(bm));
    m = bm;
  }
  const float sm = shift_of(m);
#pragma unroll
  for (int i = 0; i < n; ++i) s += exp_at(v[i], sm);
}

template <bool kFloorMode>
__device__ __forceinline__ float read_value(float x) {
  return kFloorMode && !isfinite(x) ? kFloor : x;
}

// The 16-byte-aligned interior of a row of n elements at x: the h
// elements before it, its 16-byte units, and the first column after it.
struct RowSplit {
  int64_t h, units, tail0;
};

__device__ __forceinline__ RowSplit split_row(const float* x, int64_t n) {
  RowSplit r;
  r.h = min(n, static_cast<int64_t>(
                   ((16 - (reinterpret_cast<uintptr_t>(x) & 15)) & 15) >> 2));
  r.units = (n - r.h) >> 2;
  r.tail0 = r.h + 4 * r.units;
  return r;
}

// The head or tail column (-1: none) thread `tid` reads by a plain load:
// threads 0-2 the head, threads 32-34 (another warp) the tail.
__device__ __forceinline__ int64_t edge_column(const RowSplit& r, int64_t n,
                                               int tid) {
  if (tid < r.h) return tid;
  if (tid >= 32 && tid < 35 && r.tail0 + tid - 32 < n)
    return r.tail0 + tid - 32;
  return -1;
}

// out: (3, b) f32: each row's lm, then ls, then the label's logit.
template <bool kFloorMode>
__global__ void __launch_bounds__(kRowThreads, 2)
tp_xent_stats_kernel(const float* __restrict__ logits, int64_t ld, int b,
                     int64_t n_cols, int64_t n_valid,
                     const int* __restrict__ labels, int64_t offset,
                     float* __restrict__ out) {
  __shared__ float red_m[kRowWarps], red_s[kRowWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* x = logits + row * ld;
  const RowSplit r = split_row(x, n_valid);
  const float4* x4 = reinterpret_cast<const float4*>(x + r.h);
  float m = -INFINITY, s = 0.f;
  const int64_t e = edge_column(r, n_valid, tid);
  if (e >= 0) {
    const float v[1] = {read_value<kFloorMode>(__ldg(x + e))};
    fold_values(m, s, v);
  }
  for (int64_t p0 = tid; p0 < r.units; p0 += kUnroll * kRowThreads) {
    float4 f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * kRowThreads;
      f[u] = p < r.units ? __ldg(x4 + p)
                         : make_float4(-INFINITY, -INFINITY, -INFINITY,
                                       -INFINITY);
    }
    float v[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = p0 + u * kRowThreads < r.units;
      v[4 * u] = in ? read_value<kFloorMode>(f[u].x) : -INFINITY;
      v[4 * u + 1] = in ? read_value<kFloorMode>(f[u].y) : -INFINITY;
      v[4 * u + 2] = in ? read_value<kFloorMode>(f[u].z) : -INFINITY;
      v[4 * u + 3] = in ? read_value<kFloorMode>(f[u].w) : -INFINITY;
    }
    fold_values(m, s, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    fold(m, s, __shfl_xor_sync(c2v::kFullMask, m, off),
         __shfl_xor_sync(c2v::kFullMask, s, off));
  if (lane == 0) red_m[warp] = m, red_s[warp] = s;
  __syncthreads();
  if (tid != 0) return;
  m = red_m[0], s = red_s[0];
  for (int w = 1; w < kRowWarps; ++w) fold(m, s, red_m[w], red_s[w]);
  if (kFloorMode && n_cols > n_valid)
    fold(m, s, kFloor, static_cast<float>(n_cols - n_valid));
  const int64_t lab = static_cast<int64_t>(labels[row]) - offset;
  float ll = 0.f;
  if (lab >= 0 && lab < n_cols)
    ll = lab < n_valid ? read_value<kFloorMode>(x[lab])
                       : (kFloorMode ? kFloor : -INFINITY);
  out[row] = m;
  out[b + row] = s;
  out[2 * static_cast<int64_t>(b) + row] = ll;
}

// Writes the gradient of elements j .. j + 3 of the flattened (b, ld)
// planes, `at` = b ld + j a multiple of 4 (hi 8-byte aligned); lo is
// `plane` elements on, aligned as plane % 4 says.
__device__ __forceinline__ void store_grad4(__nv_bfloat16* grad,
                                            int64_t plane, int64_t at,
                                            const float (&g)[4]) {
  uint32_t hi[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = c2v::hopper::pack2(g[2 * i], g[2 * i + 1]);
    lo[i] = c2v::hopper::pack2(g[2 * i] - c2v::hopper::lo_bf16(hi[i]),
                               g[2 * i + 1] - c2v::hopper::hi_bf16(hi[i]));
  }
  *reinterpret_cast<uint2*>(grad + at) = make_uint2(hi[0], hi[1]);
  __nv_bfloat16* l = grad + plane + at;
  if ((plane & 3) == 0) {
    *reinterpret_cast<uint2*>(l) = make_uint2(lo[0], lo[1]);
  } else if ((plane & 1) == 0) {
    reinterpret_cast<uint32_t*>(l)[0] = lo[0];
    reinterpret_cast<uint32_t*>(l)[1] = lo[1];
  } else {
    uint16_t* l16 = reinterpret_cast<uint16_t*>(l);
    l16[0] = static_cast<uint16_t>(lo[0]);
    l16[1] = static_cast<uint16_t>(lo[0] >> 16);
    l16[2] = static_cast<uint16_t>(lo[1]);
    l16[3] = static_cast<uint16_t>(lo[1] >> 16);
  }
}

// planes: (2, b, ld) bf16, hi then lo; logits 16-byte aligned, so that
// a 16-byte unit of a row maps to four aligned bf16 of each plane. CTA
// i takes row (b slices - 1 - i) / slices, slice (...) % slices.
__global__ void __launch_bounds__(kRowThreads, 2)
tp_xent_grad_kernel(const float* __restrict__ logits, int64_t ld, int b,
                    int slices, int64_t n_valid,
                    const float* __restrict__ gmax,
                    const float* __restrict__ gsum,
                    const int* __restrict__ labels,
                    const float* __restrict__ valid, int64_t offset,
                    float inv_count, __nv_bfloat16* __restrict__ planes) {
  const int tid = threadIdx.x;
  const int64_t cta = static_cast<int64_t>(gridDim.x) - 1 - blockIdx.x;
  const int64_t row = cta / slices;
  const int slice = static_cast<int>(cta % slices);
  const float* x = logits + row * ld;
  const RowSplit r = split_row(x, ld);
  const float4* x4 = reinterpret_cast<const float4*>(x + r.h);
  const float sm = shift_of(gmax[row]);
  const float scale = valid[row] * inv_count;
  const float mult = scale / gsum[row];
  const int64_t lab = static_cast<int64_t>(labels[row]) - offset;
  const int64_t plane = static_cast<int64_t>(b) * ld;
  const int64_t base = row * ld;
  const int64_t per = (r.units + slices - 1) / slices;
  const int64_t u_end = min(r.units, (slice + 1) * per);
  for (int64_t p0 = slice * per + tid; p0 < u_end;
       p0 += kUnroll * kRowThreads) {
    float4 f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * kRowThreads;
      if (p < u_end) f[u] = __ldg(x4 + p);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * kRowThreads;
      if (p >= u_end) break;
      const int64_t j = r.h + 4 * p;
      const float xs[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[q] = j + q < n_valid ? exp_at(xs[q], sm) * mult : 0.f;
      const int64_t lq = lab - j;
      if (lq >= 0 && lq < 4 && lab < n_valid) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q == lq) g[q] -= scale;
      }
      store_grad4(planes, plane, base + j, g);
    }
  }
  const int64_t e = slice == 0 ? edge_column(r, ld, tid) : -1;
  if (e >= 0) {
    float g = 0.f;
    if (e < n_valid) {
      g = exp_at(__ldg(x + e), sm) * mult;
      if (e == lab) g -= scale;
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(g);
    planes[base + e] = hi;
    planes[plane + base + e] =
        __float2bfloat16_rn(g - __bfloat162float(hi));
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


// logits f32 (b, ld), the first n_cols columns this rank's, of which the
// first n_valid are real; labels int32 (b,) global; out f32 (3, b).
C2V_EXPORT int c2v_tp_xent_stats(const float* logits, int b, int64_t ld,
                                 int64_t n_cols, int64_t n_valid, int floor,
                                 const int* labels, int64_t offset,
                                 float* out, void* stream) {
  if (b <= 0 || n_cols <= 0 || ld < n_cols || n_valid < 0 ||
      n_valid > n_cols || (reinterpret_cast<uintptr_t>(logits) & 3) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (floor)
    tp_xent_stats_kernel<true><<<b, kRowThreads, 0, s>>>(
        logits, ld, b, n_cols, n_valid, labels, offset, out);
  else
    tp_xent_stats_kernel<false><<<b, kRowThreads, 0, s>>>(
        logits, ld, b, n_cols, n_valid, labels, offset, out);
  return cudaGetLastError();
}

// logits f32 (b, ld), 16-byte aligned; gmax, gsum, valid f32 (b,);
// labels int32 (b,); planes bf16 (2, b, ld), 8-byte aligned.
C2V_EXPORT int c2v_tp_xent_grad(const float* logits, int b, int64_t ld,
                                int64_t n_valid, const float* gmax,
                                const float* gsum, const int* labels,
                                const float* valid, int64_t offset,
                                float inv_count, void* planes,
                                void* stream) {
  if (b <= 0 || ld <= 0 || n_valid < 0 || n_valid > ld ||
      (reinterpret_cast<uintptr_t>(logits) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(planes) & 7) != 0)
    return cudaErrorInvalidValue;
  // four CTAs a row where a row has enough 16-byte units for them
  const int slices = ld >= 4 * kUnroll * kRowThreads * 4 ? kGradSlices : 1;
  if (static_cast<int64_t>(b) * slices > 0x7fffffff)
    return cudaErrorInvalidValue;
  tp_xent_grad_kernel<<<static_cast<unsigned>(b * slices), kRowThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      logits, ld, b, slices, n_valid, gmax, gsum, labels, valid, offset,
      inv_count, static_cast<__nv_bfloat16*>(planes));
  return cudaGetLastError();
}
