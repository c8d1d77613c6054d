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
//            dt = bf16(bf16(bf16(w) g) + bf16(ds bf16(a))); the rank's
//            part of d a, sum over rows and contexts of ds t, rounded to
//            bf16, which the step reduces over data and ctx.
// dt does not depend on t, and only d a reads it: a row's
//   sum_m ds t = sum_m w (fs - c) t + (c - total) sum_m w t
// over its valid contexts, for total = sum w fs and any c. So the fs
// phase, which reads t for fs, also keeps each row's P = sum_m w (fs -
// c) t and Q = sum_m w t (f32, D wide) with c the fs of the row's first
// context, and the dt phase, after the all-reduce, writes dt and P + (c
// - total) Q without reading t again. The shift by c keeps the two
// terms at the size of fs's spread, as ds is, not of fs: where fs is the
// same on every context (one context a row, or every t of the row
// equal) P is exactly 0 and the row's d a is (c - total) Q, the sum of
// ds t up to f32 roundings of it, and not the difference of two sums
// that cancel.
// Every sum runs in a fixed order, so ranks that hold the same inputs
// (the model ranks of a (data, ctx) cell) get the same bits.
//
// What bounds them on an H100: bytes. The forward reads the (B, M/cp,
// 384) bf16 activations twice (scores, combine: 157 MB at cp 2 of the
// flagship, 0.047 ms at the memory rate); the backward reads them once
// (fs) and writes dt once (the same 157 MB).
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
// K17: the fs phase follows the scores phase (a CTA a row, a warp a
// context, a warp sum, g's values in registers), with 8-byte chunks (4
// columns) a lane, three a lane at width 384 so that no lane idles, and
// two contexts a warp read while the two before them are summed (two
// sets of registers; two CTAs an SM); each lane adds its chunks into P
// and Q while it holds them, its warp's contexts in order, each warp's
// P against the fs of its own first context (known before it adds any),
// then moved onto the row's c by (its fs - c) Q, and the warps' P and Q
// are added in warp order through shared memory. The dt
// phase is a CTA a row, 2 groups of D/8 threads (small CTAs: the 1,024
// rows fit the card in one wave), each thread 8 adjacent columns of
// every other context, by 16-byte stores, from the row's ds and bf16(w)
// in shared memory and its own g and a in registers; after its stores
// the CTA writes the row's P + (c - total) Q (so that they are still in L2
// for the next launch). A last launch adds those rows for d a over 48
// CTAs at width 384: a CTA a strip of 8 columns, each thread a column's
// every 128th row in order, then a fixed tree over the 128 sums.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDtGroups = 2;    // context groups of a dt CTA
constexpr int kDaCols = 8;      // columns of a da CTA
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

// acc += the 4 bf16 of `v` times q (in order).
__device__ __forceinline__ float dot4(const uint2& v, const float* q,
                                      float acc) {
  acc = fmaf(c2v::hopper::lo_bf16(v.x), q[0], acc);
  acc = fmaf(c2v::hopper::hi_bf16(v.x), q[1], acc);
  acc = fmaf(c2v::hopper::lo_bf16(v.y), q[2], acc);
  return fmaf(c2v::hopper::hi_bf16(v.y), q[3], acc);
}

// fs (b, m) f32, wfs (b,) f32; pq (2, b, d) f32: each row's P = sum_m w
// (fs - fs_0) t, then Q = sum_m w t, over its valid contexts. t as for the
// scores; kLC the 8-byte chunks (4 columns) of a context a lane takes
// (d / 4 <= 32 kLC: three at width 384, so no lane idles).
template <int kLC>
__global__ void __launch_bounds__(kThreads, kLC <= 3 ? 2 : 1)
cp_fs_kernel(const __nv_bfloat16* __restrict__ t,
             const float* __restrict__ attn, const float* __restrict__ mask,
             const float* __restrict__ g, int b, int m, int d,
             float* __restrict__ fs, float* __restrict__ wfs,
             float* __restrict__ pq) {
  extern __shared__ float part[];  // kWarps x d: the warps' P, then Q
  __shared__ float wpart[kWarps];
  __shared__ float c0;  // the fs of the row's first context
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int c = d >> 2;
  float q[kLC][4], sp[kLC][4], sq[kLC][4];
  const float* gr = g + static_cast<int64_t>(row) * d;
#pragma unroll
  for (int i = 0; i < kLC; ++i) {
    const int k = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[i][e] = k < c ? __ldg(gr + 4 * k + e) : 0.f;
      sp[i][e] = 0.f;
      sq[i][e] = 0.f;
    }
  }
  // contexts a warp reads at once; the next ones are loaded while these
  // are summed (two sets of registers)
  constexpr int kCtx = 2;
  const uint2* tr = reinterpret_cast<const uint2*>(t) +
                    static_cast<int64_t>(row) * m * c;
  const float* mr = mask + static_cast<int64_t>(row) * m;
  const float* ar = attn + static_cast<int64_t>(row) * m;
  float* fr = fs + static_cast<int64_t>(row) * m;
  uint2 v[kCtx][kLC];
  float w[kCtx], wv[kCtx];
  // the contexts j0 + u kWarps (u < kCtx) of this warp, zeros past m
  auto load = [&](int j0, uint2 (&vv)[kCtx][kLC], float (&ww)[kCtx],
                  float (&wm)[kCtx]) {
#pragma unroll
    for (int u = 0; u < kCtx; ++u) {
      const int j = j0 + u * kWarps;
      ww[u] = j < m ? __ldg(ar + j) : 0.f;
      wm[u] = j < m && __ldg(mr + j) > 0.f ? ww[u] : 0.f;
#pragma unroll
      for (int i = 0; i < kLC; ++i) {
        const int k = lane + 32 * i;
        vv[u][i] = j < m && k < c
                       ? __ldg(tr + static_cast<int64_t>(j) * c + k)
                       : make_uint2(0u, 0u);
      }
    }
  };
  float acc_w = 0.f;  // this warp's sum of w fs, its contexts in order
  float cw = 0.f;     // the fs of this warp's first context
  load(warp, v, w, wv);
  for (int j0 = warp; j0 < m; j0 += kWarps * kCtx) {
    uint2 vn[kCtx][kLC];
    float wn[kCtx], wvn[kCtx];
    load(j0 + kWarps * kCtx, vn, wn, wvn);
    float acc[kCtx];
#pragma unroll
    for (int u = 0; u < kCtx; ++u) {
      acc[u] = 0.f;
#pragma unroll
      for (int i = 0; i < kLC; ++i) acc[u] = dot4(v[u][i], q[i], acc[u]);
    }
    // the contexts' warp sums side by side, each an xor butterfly (every
    // lane ends with the same sum)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kCtx; ++u)
        acc[u] += __shfl_xor_sync(c2v::kFullMask, acc[u], off);
    }
#pragma unroll
    for (int u = 0; u < kCtx; ++u) {
      const int j = j0 + u * kWarps;
      if (j >= m) break;
      const float f = c2v::bf16_round(acc[u]);
      if (lane == 0) fr[j] = f;
      if (j == warp) cw = f;
      acc_w += w[u] * f;
      const float wf = __fmul_rn(wv[u], __fsub_rn(f, cw));
#pragma unroll
      for (int i = 0; i < kLC; ++i) {
        const float x[4] = {c2v::hopper::lo_bf16(v[u][i].x),
                            c2v::hopper::hi_bf16(v[u][i].x),
                            c2v::hopper::lo_bf16(v[u][i].y),
                            c2v::hopper::hi_bf16(v[u][i].y)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sp[i][e] = fmaf(wf, x[e], sp[i][e]);
          sq[i][e] = fmaf(wv[u], x[e], sq[i][e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kCtx; ++u) {
      w[u] = wn[u];
      wv[u] = wvn[u];
#pragma unroll
      for (int i = 0; i < kLC; ++i) v[u][i] = vn[u][i];
    }
  }
  if (lane == 0) wpart[warp] = acc_w;
  if (tid == 0) c0 = cw;
  __syncthreads();
  // this warp's P onto the row's first fs: + (cw - c0) Q
  const float shift = __fsub_rn(cw, c0);
#pragma unroll
  for (int i = 0; i < kLC; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sp[i][e] = fmaf(shift, sq[i][e], sp[i][e]);
  }
  // P, then Q: the warps' sums in warp order
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < kLC; ++i) {
      const int k = lane + 32 * i;
      if (k >= c) continue;
      float4* dst = reinterpret_cast<float4*>(part + warp * d + 4 * k);
      *dst = which == 0
                 ? make_float4(sp[i][0], sp[i][1], sp[i][2], sp[i][3])
                 : make_float4(sq[i][0], sq[i][1], sq[i][2], sq[i][3]);
    }
    __syncthreads();
    float* out = pq + (static_cast<int64_t>(which) * b + row) * d;
    for (int col = tid; col < d; col += kThreads) {
      float s = part[col];
      for (int w2 = 1; w2 < kWarps; ++w2) s += part[w2 * d + col];
      out[col] = s;
    }
    if (which == 0 && tid == 0) {
      float s = wpart[0];
      for (int w2 = 1; w2 < kWarps; ++w2) s += wpart[w2];
      wfs[row] = s;
    }
    __syncthreads();
  }
}

// dt (b, m, d) bf16; da_rows (b, d) f32: each row's P + (fs_0 - total)
// Q. A CTA a row of kDtGroups x d / 8 threads.
__global__ void __launch_bounds__(1024)
cp_dt_kernel(const float* __restrict__ a, const float* __restrict__ mask,
             const float* __restrict__ attn, const float* __restrict__ fs,
             const float* __restrict__ wfs, const float* __restrict__ g,
             const float* __restrict__ pq, int b, int m, int d,
             __nv_bfloat16* __restrict__ dt, float* __restrict__ da_rows) {
  extern __shared__ float sh[];  // m: ds, then m: bf16(w)
  float* ds = sh;
  float* w = sh + m;
  const int row = blockIdx.x, tid = threadIdx.x, c = d >> 3;
  const float total = wfs[row];
  const float shift = __fsub_rn(fs[static_cast<int64_t>(row) * m], total);
  for (int j = tid; j < m; j += blockDim.x) {
    const int64_t e = static_cast<int64_t>(row) * m + j;
    ds[j] = mask[e] > 0.f ? attn[e] * (fs[e] - total) : 0.f;
    w[j] = c2v::bf16_round(attn[e]);
  }
  // this thread's columns tid + i d / 4 of the row's P and Q, loaded now
  // and written as P + (fs_0 - total) Q after dT (still in L2 for the da
  // launch)
  constexpr int kPer = 8 / kDtGroups;  // a CTA has d / kPer threads
  const int64_t rd = static_cast<int64_t>(row) * d;
  const int64_t qd = static_cast<int64_t>(b) * d;
  float pv[kPer], qv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int col = tid + i * static_cast<int>(blockDim.x);
    pv[i] = __ldg(pq + rd + col);
    qv[i] = __ldg(pq + qd + rd + col);
  }
  __syncthreads();
  const int grp = tid / c, k = tid - grp * c;
  float gc[8], ac[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    gc[e] = __ldg(g + rd + 8 * k + e);
    ac[e] = c2v::bf16_round(__ldg(a + 8 * k + e));
  }
  uint4* out = reinterpret_cast<uint4*>(dt) +
               static_cast<int64_t>(row) * m * c + k;
#pragma unroll 4
  for (int j = grp; j < m; j += kDtGroups) {
    const float wj = w[j], dj = ds[j];
    uint32_t o[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      o[h] = c2v::hopper::pack2(
          c2v::bf16_round(wj * gc[2 * h]) + c2v::bf16_round(dj * ac[2 * h]),
          c2v::bf16_round(wj * gc[2 * h + 1]) +
              c2v::bf16_round(dj * ac[2 * h + 1]));
    out[static_cast<int64_t>(j) * c] = make_uint4(o[0], o[1], o[2], o[3]);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    da_rows[rd + tid + i * static_cast<int>(blockDim.x)] =
        fmaf(shift, qv[i], pv[i]);
}

// da (d,) f32: bf16 of the rows' sum of da_rows. A CTA of 1,024
// threads a strip of kDaCols columns, so that the few bytes a column
// spread over many SMs: thread (r, c) sums the strip's column c over
// rows r, r + R, ... in order (R = 1,024 / kDaCols, all its rows loaded
// at once), then the R sums of each column are added pairwise in a
// fixed tree.
__global__ void __launch_bounds__(1024)
cp_da_kernel(const float* __restrict__ da_rows, int b, int d,
             float* __restrict__ da) {
  constexpr int kRes = 1024 / kDaCols;  // rows' residues a CTA
  constexpr int kRows = 8;              // rows a thread loads at once
  __shared__ float part[1024];          // [residue][column of the strip]
  const int tid = threadIdx.x, cc = tid % kDaCols, r0 = tid / kDaCols;
  const int col = blockIdx.x * kDaCols + cc;
  float acc = 0.f;
  if (col < d) {
    for (int rb = r0; rb < b; rb += kRes * kRows) {
      float x[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = rb + kRes * u;
        x[u] = r < b ? __ldg(da_rows + static_cast<int64_t>(r) * d + col)
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) acc += x[u];
    }
  }
  part[tid] = acc;
  __syncthreads();
#pragma unroll
  for (int s = kRes / 2; s > 0; s >>= 1) {
    if (r0 < s) part[tid] += part[tid + s * kDaCols];
    __syncthreads();
  }
  if (r0 == 0 && col < d) da[col] = c2v::bf16_round(part[cc]);
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

// t bf16 (b, m, d) as for the scores; attn, mask f32 (b, m); g f32
// (b, d); fs f32 (b, m); wfs f32 (b,); pq f32 (2, b, d).
C2V_EXPORT int c2v_cp_attention_backward_fs(const void* t, const float* attn,
                                            const float* mask,
                                            const float* g, int b, int m,
                                            int d, float* fs, float* wfs,
                                            float* pq, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || d > 1024 ||
      (reinterpret_cast<uintptr_t>(t) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tb = static_cast<const __nv_bfloat16*>(t);
  const size_t smem = static_cast<size_t>(kWarps) * d * sizeof(float);
  switch ((d / 4 + 31) / 32) {
    case 1:
      cp_fs_kernel<1><<<b, kThreads, smem, s>>>(tb, attn, mask, g, b, m, d,
                                                fs, wfs, pq);
      break;
    case 2:
      cp_fs_kernel<2><<<b, kThreads, smem, s>>>(tb, attn, mask, g, b, m, d,
                                                fs, wfs, pq);
      break;
    case 3:
      cp_fs_kernel<3><<<b, kThreads, smem, s>>>(tb, attn, mask, g, b, m, d,
                                                fs, wfs, pq);
      break;
    case 4:
      cp_fs_kernel<4><<<b, kThreads, smem, s>>>(tb, attn, mask, g, b, m, d,
                                                fs, wfs, pq);
      break;
    default:
      cp_fs_kernel<8><<<b, kThreads, smem, s>>>(tb, attn, mask, g, b, m, d,
                                                fs, wfs, pq);
  }
  return cudaGetLastError();
}

// a f32 (d,); mask, attn, fs f32 (b, m); wfs f32 (b,) summed over ctx;
// g f32 (b, d); pq f32 (2, b, d) from the fs phase; d % 8 == 0, d <=
// 1024, 2 m floats of shared memory at most 48 KB; dt bf16 (b, m, d),
// 16-byte aligned; da_rows f32 (b, d) scratch; da f32 (d,).
C2V_EXPORT int c2v_cp_attention_backward_dt(
    const float* a, const float* mask, const float* attn, const float* fs,
    const float* wfs, const float* g, const float* pq, int b, int m, int d,
    void* dt, float* da_rows, float* da, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(m) * sizeof(float);
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || d > 1024 ||
      smem > 48 * 1024 || (reinterpret_cast<uintptr_t>(dt) & 15) != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cp_dt_kernel<<<b, kDtGroups * (d / 8), smem, s>>>(
      a, mask, attn, fs, wfs, g, pq, b, m, d,
      static_cast<__nv_bfloat16*>(dt), da_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cp_da_kernel<<<(d + kDaCols - 1) / kDaCols, 1024, 0, s>>>(da_rows, b, d,
                                                           da);
  return cudaGetLastError();
}
