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
// planes): 0.64 ms at the memory rate.
// Design: a thread-block cluster of C CTAs per row (C from
// kernels/softmax_xent.py `plan`: 16 at the flagship width, so a CTA's
// slice of the 1,044,984-byte row, ~65 KB, fits three CTAs of 256
// threads an SM; C 8, one 131 KB CTA an SM, ran 1.12 against 0.87 ms on
// the H100). Each CTA brings its slice in by bulk (TMA) copies of at most
// 32 KB, each completing on its own mbarrier, and takes the max of every
// piece as soon as it has arrived, while the later pieces are still in
// flight; then the slice's sum of exp(x - max) from shared memory. At ~1
// GB a call the work is also near the card's issue rate, so an element
// costs a few instructions: exp as one MUFU exp2 of an FMA (within
// ~2^-21 of expf), the gradient as that times scale / sum (one division
// a row), the n_real mask and the one-hot term tested per four elements.
// The slices are cut from the row's 16-byte-aligned interior (a row
// starts 0, 4, 8 or 12 bytes off a 16-byte boundary): rank 0 also takes
// the up to 3 elements before it, rank C - 1 the up to 3 after it, by
// plain loads. Each CTA posts its slice's (max, sum) to every rank
// through distributed shared memory; after one cluster barrier every CTA
// folds the posts in rank order 0..C-1, so all hold the same row
// logsumexp and reruns are bit-equal. Then each CTA writes its slice's
// gradient from shared memory: hi and lo as 8-byte stores of four bf16
// where the plane allows (else 4- or 2-byte ones), the head and tail by
// their threads. So the logits are read from device memory once (1.07 GB)
// and the gradient written once (1.07 GB); a device copy of the same
// bytes takes 0.71 ms on the H100 (PERF.md). Nothing is read from
// another CTA after the barrier, so no CTA waits for the others to leave.
// A row too wide for 16 CTAs' shared memory (above ~930K columns) takes
// `softmax_xent_rows` below, one CTA a row reading it twice (pairs of
// elements where the width is even, four units in flight a thread; the
// second read partly from L2). A one-CTA second launch adds the rows'
// terms in a fixed order.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

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


// ----------------------------------------------------------- cluster path

constexpr int kClusterThreads = 256;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kMaxCluster = 16;
constexpr uint32_t kPieceBytes = 32768;
constexpr int kPieceUnits = kPieceBytes / 16;
constexpr int kMaxPieces = 8;
constexpr float kLog2e = 1.4426950408889634f;
// shared memory: the pieces' mbarriers, the ranks' posts, the block
// reductions' slots, then the slice (16-byte units of four logits)
constexpr int kOffPost = kMaxPieces * 8;
constexpr int kOffRed = kOffPost + kMaxCluster * 2 * 4;
constexpr int kOffSlice = 256;
static_assert(kOffRed + kClusterWarps * 4 <= kOffSlice, "layout");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// 2^t (the MUFU approximation: within ~2^-22 relative, subnormals kept)
__device__ __forceinline__ float exp2_approx(float t) {
  float y;
  asm("ex2.approx.f32 %0, %1;" : "=f"(y) : "f"(t));
  return y;
}

// (m, s) += (m2, s2), where a NaN sum stays NaN (a NaN logit makes the
// row's gradient NaN, as the reference's sum does).
__device__ __forceinline__ void fold(float& m, float& s, float m2,
                                     float s2) {
  if (isnan(s) || isnan(s2)) {
    m = fmaxf(m, m2);
    s = __uint_as_float(0x7FC00000u);
    return;
  }
  c2v::lse_combine(m, s, m2, s2);
}

// The block's sum (or max) of x, every thread's result the same: warps
// in order. `red` holds kClusterWarps floats; the block barriers around
// it let the next reduction reuse it.
__device__ __forceinline__ float block_fold(float x, float* red, bool mx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = mx ? c2v::warp_max(x) : c2v::warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kClusterWarps; ++i)
    r = mx ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

// Writes the gradient of elements j .. j + 3 of the flattened (b, v)
// planes, `at` = b v + j a multiple of 4 (hi 8-byte aligned); lo is
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

// Cluster b handles row b; its CTA r owns the row's 16-byte units [r up,
// (r + 1) up) of the aligned interior, which starts h = (-b v) mod 4
// elements into the row (rank 0 also owns those h, rank C - 1 the tail
// past the interior). Per element: a max as each piece lands, one exp2
// for the slice's sum, one for the gradient (times scale / sum, the
// row's one division), with the n_real mask and the label's one-hot term
// tested once per four elements.
__global__ void __launch_bounds__(kClusterThreads, 3)
softmax_xent_cluster(const float* logits, int64_t v, int64_t n_real,
                     const int* labels, const float* valid, float inv_b,
                     __nv_bfloat16* grad, float* ce, int up) {
  extern __shared__ __align__(128) unsigned char smem[];
  cluster_arrive();  // every CTA of the cluster has started (waited below)
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / nc;
  const int tid = threadIdx.x;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* post = reinterpret_cast<float*>(smem + kOffPost);  // (rank, 2)
  float* red = reinterpret_cast<float*>(smem + kOffRed);
  const float4* slice = reinterpret_cast<const float4*>(smem + kOffSlice);
  const float* x = logits + b * v;
  const int64_t h = min(v, (4 - (b * v) % 4) % 4);
  const int64_t units = (v - h) / 4;
  const int64_t u0 = min(units, static_cast<int64_t>(r) * up);
  const int n = static_cast<int>(min(units, u0 + up) - u0);
  const int pieces = (n + kPieceUnits - 1) / kPieceUnits;
  const int64_t j0 = h + 4 * u0;  // the slice's first column
  if (tid == 0 && n > 0) {
    for (int p = 0; p < pieces; ++p) c2v::hopper::mbar_init(&bars[p], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int p = 0; p < pieces; ++p) {
      const int pu = min(kPieceUnits, n - p * kPieceUnits);
      c2v::hopper::mbar_arrive_tx(&bars[p], pu * 16);
      c2v::hopper::bulk_load(
          smem + kOffSlice + static_cast<size_t>(p) * kPieceBytes,
          x + j0 + 4LL * p * kPieceUnits, pu * 16, &bars[p]);
    }
  }
  // the head (threads 0-2 of rank 0) and tail (threads 4-6 of rank C - 1)
  int64_t ej = -1;
  if (r == 0 && tid < h) ej = tid;
  const int64_t tail0 = h + 4 * units;
  if (r == nc - 1 && tid >= 4 && tail0 + tid - 4 < v) ej = tail0 + tid - 4;
  const bool e_real = ej >= 0 && ej < n_real;
  const float ex = ej >= 0 ? x[ej] : 0.f;
  // the slice's units wholly before n_real
  const int64_t full_units =
      max(static_cast<int64_t>(0),
          min(static_cast<int64_t>(n), (n_real - j0) / 4));
  float m = e_real ? ex : -INFINITY;
  __syncthreads();  // the mbarriers are initialised
  for (int p = 0; p < pieces; ++p) {
    c2v::hopper::mbar_wait(&bars[p], 0);
    const int end = min(n, (p + 1) * kPieceUnits);
    for (int i = p * kPieceUnits + tid; i < end; i += kClusterThreads) {
      const float4 f = slice[i];
      if (i < full_units) {
        m = fmaxf(m, fmaxf(fmaxf(f.x, f.y), fmaxf(f.z, f.w)));
      } else {
        const int64_t j = j0 + 4LL * i;
        const float xs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < n_real) m = fmaxf(m, xs[q]);
      }
    }
  }
  m = block_fold(m, red, true);  // the slice's max (-inf: none)
  // its sum of exp(x - m), m pinned to 0 where it is not finite
  const float mb = (isfinite(m) ? m : 0.f) * kLog2e;
  float s = e_real ? exp2_approx(fmaf(ex, kLog2e, -mb)) : 0.f;
  for (int i = tid; i < n; i += kClusterThreads) {
    const float4 f = slice[i];
    const float xs[4] = {f.x, f.y, f.z, f.w};
    if (i < full_units) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s += exp2_approx(fmaf(xs[q], kLog2e, -mb));
    } else {
      const int64_t j = j0 + 4LL * i;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q < n_real) s += exp2_approx(fmaf(xs[q], kLog2e, -mb));
    }
  }
  s = block_fold(s, red, false);
  cluster_wait();
  if (tid < nc) {
    float* dst = cluster.map_shared_rank(post, tid);
    dst[2 * r] = m;
    dst[2 * r + 1] = s;
  }
  cluster_arrive();
  cluster_wait();
  float mx = -INFINITY, sum = 0.f;
  for (int q = 0; q < nc; ++q) fold(mx, sum, post[2 * q], post[2 * q + 1]);

  const int label = labels[b];
  const bool in_range = label >= 0 && label < n_real;
  const float scale = valid[b] * inv_b;
  const float mult = scale / sum;
  const float mxb = mx * kLog2e;
  const int64_t plane = static_cast<int64_t>(gridDim.x / nc) * v;
  for (int i = tid; i < n; i += kClusterThreads) {
    const float4 f = slice[i];
    const float xs[4] = {f.x, f.y, f.z, f.w};
    const int64_t j = j0 + 4LL * i;
    float g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = exp2_approx(fmaf(xs[q], kLog2e, -mxb)) * mult;
    if (i >= full_units) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j + q >= n_real) g[q] = 0.f;
    }
    const int64_t lq = in_range ? label - j : -1;
    if (lq >= 0 && lq < 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q == lq) g[q] -= scale;
    }
    store_grad4(grad, plane, b * v + j, g);
  }
  if (ej >= 0) {
    float g = 0.f;
    if (e_real) {
      g = exp2_approx(fmaf(ex, kLog2e, -mxb)) * mult;
      if (ej == label) g -= scale;
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(g);
    grad[b * v + ej] = hi;
    grad[plane + b * v + ej] = __float2bfloat16_rn(g - __bfloat162float(hi));
  }
  if (r == 0 && tid == 0) {
    const float lse = mx + logf(sum);
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

// The dynamic shared memory of a cluster CTA owning `up` 16-byte units,
// or -1 where its slice would take more than kMaxPieces bulk copies (the
// layout kernels/softmax_xent.py `plan` sizes the clusters by).
C2V_EXPORT int64_t c2v_softmax_xent_smem(int up) {
  if (up < 0 || (up + kPieceUnits - 1) / kPieceUnits > kMaxPieces) return -1;
  return kOffSlice + 16LL * up;
}

// logits: f32 (b, v), 16-byte aligned; labels: int32 (b,); valid: f32
// (b,). Outputs: grad bf16 (2, b, v) hi/lo planes; ce f32 (b,) scratch;
// loss f32 (). cluster: CTAs a row (1-16), each owning `up` 16-byte units
// of the row (cluster * up >= v / 4; kernels/softmax_xent.py `plan`), or 0
// for one CTA a row reading it twice. Returns a cudaError_t.
C2V_EXPORT int c2v_softmax_xent(const float* logits, int b, int64_t v,
                                int64_t n_real, const int* labels,
                                const float* valid, void* grad, float* ce,
                                float* loss, int cluster, int up,
                                void* stream) {
  if (b <= 0 || v <= 0 || n_real <= 0 || n_real > v || cluster < 0 ||
      cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float inv_b = 1.f / static_cast<float>(b);
  auto* g = static_cast<__nv_bfloat16*>(grad);
  cudaError_t err;
  if (cluster > 0) {
    const int64_t smem = c2v_softmax_xent_smem(up);
    if (smem < 0 || static_cast<int64_t>(cluster) * up < v / 4 ||
        static_cast<int64_t>(b) * cluster > 0x7fffffff ||
        (reinterpret_cast<uintptr_t>(logits) & 15) != 0)
      return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(softmax_xent_cluster,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (cluster > 8) {
      err = cudaFuncSetAttribute(
          softmax_xent_cluster,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(b * cluster));
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, softmax_xent_cluster, logits, v, n_real,
                             labels, valid, inv_b, g, ce, up);
    if (err != cudaSuccess) return err;
  } else if (v % 2 == 0) {
    softmax_xent_rows<2><<<b, kThreads, 0, s>>>(logits, v, n_real, labels,
                                                valid, inv_b, g, ce);
  } else {
    softmax_xent_rows<1><<<b, kThreads, 0, s>>>(logits, v, n_real, labels,
                                                valid, inv_b, g, ce);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows<<<1, kThreads, 0, s>>>(ce, b, loss);
  return cudaGetLastError();
}
