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
//            lm = max s and ls = sum exp(s - lm)     -> all-gather, merged
//            in rank order (kernels/sharded.py merge_softmax_stats) into
//            the global max M and sum S; exp is taken against 0 where a
//            max is not finite (an all-invalid row, ops/attention.py:54-58)
//   combine  w = exp(s - M) / max(S, 1e-30), written in f32; the rank's
//            part of the code vector sum_m bf16(w) t (f32)
//                                                      -> all-reduce SUM
// The weights are rounded to bf16 before the weighted sum, as the
// reference rounds them, and they need the global M and S first: so T is
// read twice, once a phase (a flash-style single read would sum rescaled
// unrounded weights, another result).
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
// activations: the forward twice (scores, combine: 157 MB at cp 2 of the
// flagship, 0.047 ms at the memory rate), the backward twice (fs, dt) and
// writes dt once.
// K16's design: the row's T block (100 x 384 bf16 at cp 2, 76.8 KB) is
// contiguous, so both phases stream it by 16-byte loads, several in
// flight a thread, with no shared-memory staging: ~24 KB in flight a CTA
// at 3 CTAs an SM for the scores, ~12 KB a CTA at 4 an SM for the
// combine, where the card needs ~2-3 MB in flight in all. The scores
// phase is a CTA of 8 warps a row, a warp a context at a time (four
// contexts in flight), each lane a 16-byte chunk of the context and the
// matching 8 query values held in registers, then a warp sum; its last
// warp takes the row's max and sum from the scores in shared memory.
// The combine is a CTA a row, in reverse row order (the rows the scores
// phase read last are still in L2): the weights first (one exp and one
// division each), then 4 groups of D/8 threads, each thread 8 adjacent
// columns (one 16-byte chunk) over a quarter of the contexts in order,
// eight loads in flight, the groups' sums added in group order. Two
// designs with bulk (TMA) copies into shared memory measured slower on
// the H100 (PERF.md, row 12f): a CTA a row with its whole block in flight
// (two CTAs an SM), and persistent CTAs streaming the rows through an
// 8-slot ring from a producer warp. The scores phase already reads T
// faster than a torch.amax of T does.
// K17, simple first: a CTA per row for the fs phase (a warp per context,
// the lanes over D); a CTA per (row, 128 columns of D) for dt, a thread
// per column walking the contexts, the row's weights first staged in
// shared memory by the CTA.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;      // columns of D a dt CTA owns
constexpr int kGroups = 4;      // context groups of a combine CTA
constexpr int kCombineLoads = 8;  // 16-byte loads in flight a thread

__device__ __forceinline__ float shift_of(float m) {
  return isfinite(m) ? m : 0.f;
}

// acc += the 8 bf16 of `v` times q (in order).
__device__ __forceinline__ float dot8(const uint4& v, const float* q,
                                      float acc) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(c2v::hopper::lo_bf16(w[i]), q[2 * i], acc);
    acc = fmaf(c2v::hopper::hi_bf16(w[i]), q[2 * i + 1], acc);
  }
  return acc;
}

// g . t[row, j] over D: the lanes of a warp over the columns, then a
// warp sum; `q` is f32 (g).
__device__ __forceinline__ float warp_dot(const __nv_bfloat16* t,
                                          const float* q, int d, int lane) {
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) acc += __bfloat162float(t[k]) * q[k];
  return c2v::warp_sum(acc);
}

// scores (b, m) f32; stats (2, b) f32: the rows' lm, then ls. t's rows of
// d bf16 (d % 8 == 0) 16-byte aligned; kLC the 16-byte chunks of a
// context a lane takes (d / 8 <= 32 kLC).
template <int kLC>
__global__ void __launch_bounds__(kThreads, 3)
cp_scores_kernel(const __nv_bfloat16* __restrict__ t,
                 const float* __restrict__ a, const float* __restrict__ mask,
                 int b, int m, int d, float* __restrict__ scores,
                 float* __restrict__ stats) {
  extern __shared__ float sc[];  // m: the row's scores
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int c = d >> 3;
  float q[kLC][8];
#pragma unroll
  for (int i = 0; i < kLC; ++i) {
    const int k = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[i][e] = k < c ? c2v::bf16_round(__ldg(a + 8 * k + e)) : 0.f;
  }
  // contexts a warp has in flight: 4 for widths up to 512, 2 above
  constexpr int kScoreCtx = kLC <= 2 ? 4 : 2;
  const uint4* tr = reinterpret_cast<const uint4*>(t) +
                    static_cast<int64_t>(row) * m * c;
  const float* mr = mask + static_cast<int64_t>(row) * m;
  for (int j0 = warp; j0 < m; j0 += kWarps * kScoreCtx) {
    uint4 v[kScoreCtx][kLC];
    float mk[kScoreCtx];
#pragma unroll
    for (int u = 0; u < kScoreCtx; ++u) {
      const int j = j0 + u * kWarps;
      mk[u] = j < m ? __ldg(mr + j) : 0.f;
#pragma unroll
      for (int i = 0; i < kLC; ++i) {
        const int k = lane + 32 * i;
        v[u][i] = j < m && k < c
                      ? __ldg(tr + static_cast<int64_t>(j) * c + k)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kScoreCtx; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kLC; ++i) acc = dot8(v[u][i], q[i], acc);
      acc = c2v::warp_sum(acc);
      const int j = j0 + u * kWarps;
      if (lane == 0 && j < m) sc[j] = mk[u] > 0.f ? acc : -INFINITY;
    }
  }
  __syncthreads();
  for (int j = tid; j < m; j += kThreads)
    scores[static_cast<int64_t>(row) * m + j] = sc[j];
  if (warp != kWarps - 1) return;
  float mx = -INFINITY;
  for (int j = lane; j < m; j += 32) mx = fmaxf(mx, sc[j]);
  mx = c2v::warp_max(mx);
  const float sm = shift_of(mx);
  float s = 0.f;
  for (int j = lane; j < m; j += 32) s += expf(sc[j] - sm);
  s = c2v::warp_sum(s);
  if (lane == 0) {
    stats[row] = mx;
    stats[b + row] = s;
  }
}

// cv (b, d) f32: this rank's part; attn (b, m) f32. CTA i takes row
// b - 1 - i; kGroups * d / 8 threads.
__global__ void __launch_bounds__(kGroups * 128)
cp_combine_kernel(const __nv_bfloat16* __restrict__ t,
                  const float* __restrict__ scores,
                  const float* __restrict__ gmax,
                  const float* __restrict__ gsum, int b, int m, int d,
                  float* __restrict__ cv, float* __restrict__ attn) {
  extern __shared__ float sh[];  // m: bf16(w); (kGroups - 1) x d sums
  const int row = b - 1 - static_cast<int>(blockIdx.x);
  const int tid = threadIdx.x, c = d >> 3;
  const float sm = shift_of(gmax[row]);
  const float den = fmaxf(gsum[row], 1e-30f);
  for (int j = tid; j < m; j += blockDim.x) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    const float w = expf(scores[e] - sm) / den;
    attn[e] = w;
    sh[j] = c2v::bf16_round(w);
  }
  __syncthreads();
  const int g = tid / c, k = tid - g * c;
  const int per = (m + kGroups - 1) / kGroups;
  const int j0 = min(m, g * per), j1 = min(m, j0 + per);
  const uint4* tr = reinterpret_cast<const uint4*>(t) +
                    static_cast<int64_t>(row) * m * c + k;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = j0; j < j1; j += kCombineLoads) {
    uint4 v[kCombineLoads];
#pragma unroll
    for (int u = 0; u < kCombineLoads; ++u)
      if (j + u < j1) v[u] = __ldg(tr + static_cast<int64_t>(j + u) * c);
#pragma unroll
    for (int u = 0; u < kCombineLoads; ++u) {
      if (j + u >= j1) break;
      const float w = sh[j + u];
      const uint32_t x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[2 * i] = fmaf(w, c2v::hopper::lo_bf16(x[i]), acc[2 * i]);
        acc[2 * i + 1] = fmaf(w, c2v::hopper::hi_bf16(x[i]), acc[2 * i + 1]);
      }
    }
  }
  float* part = sh + m;  // [group - 1][element][chunk]
  if (g > 0) {
#pragma unroll
    for (int e = 0; e < 8; ++e) part[((g - 1) * 8 + e) * c + k] = acc[e];
  }
  __syncthreads();
  if (g > 0) return;
  for (int gg = 1; gg < kGroups; ++gg) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += part[((gg - 1) * 8 + e) * c + k];
  }
  float4* out = reinterpret_cast<float4*>(cv + static_cast<int64_t>(row) * d
                                          + 8 * k);
  out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
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

// t bf16 (b, m, d), d % 8 == 0 and d <= 1024, 16-byte aligned; a f32
// (d,); mask f32 (b, m); scores f32 (b, m); stats f32 (2, b). Returns a
// cudaError_t.
C2V_EXPORT int c2v_cp_attention_scores(const void* t, const float* a,
                                       const float* mask, int b, int m,
                                       int d, float* scores, float* stats,
                                       void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || d > 1024 ||
      (reinterpret_cast<uintptr_t>(t) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const __nv_bfloat16*>(t);
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  switch ((d / 8 + 31) / 32) {
    case 1:
      cp_scores_kernel<1><<<b, kThreads, smem, s>>>(tb, a, mask, b, m, d,
                                                    scores, stats);
      break;
    case 2:
      cp_scores_kernel<2><<<b, kThreads, smem, s>>>(tb, a, mask, b, m, d,
                                                    scores, stats);
      break;
    case 3:
      cp_scores_kernel<3><<<b, kThreads, smem, s>>>(tb, a, mask, b, m, d,
                                                    scores, stats);
      break;
    default:
      cp_scores_kernel<4><<<b, kThreads, smem, s>>>(tb, a, mask, b, m, d,
                                                    scores, stats);
  }
  return cudaGetLastError();
}

// t bf16 (b, m, d) as for the scores; scores f32 (b, m); gmax, gsum f32
// (b,) (the merged stats); cv f32 (b, d); attn f32 (b, m).
C2V_EXPORT int c2v_cp_attention_combine(const void* t, const float* scores,
                                        const float* gmax, const float* gsum,
                                        int b, int m, int d, float* cv,
                                        float* attn, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || d > 1024 ||
      (reinterpret_cast<uintptr_t>(t) & 15) != 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      (static_cast<size_t>(m) + (kGroups - 1) * static_cast<size_t>(d)) *
      sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cp_combine_kernel<<<b, kGroups * (d / 8), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(t), scores, gmax, gsum, b, m, d, cv,
      attn);
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
