// K2 masked_attention: masked single-query attention over the contexts.
//
// Replaces code2vec_tpu/ops/attention.py masked_single_query_attention
// (:28-69) with axis_name=None: scores T.a in f32 with `a` rounded to
// bf16, -inf on invalid contexts, a max-stabilised softmax whose
// all-invalid rows are pinned to zero weights (:54-58), then the code
// vector sum(bf16(attn) * T) in f32 (:65).
//
// What bounds it on an H100: bytes. It needs the (B, M, 384) bf16
// contexts once and does 4 flops per element, far below the card's ratio
// of ~295 flops per byte. Design: a thread-block cluster of C CTAs per
// batch row (C from kernels/attention.py `plan`, so that B x C CTAs cover
// the SMs and a chunk takes at most a quarter of a block's shared memory,
// four CTAs an SM loading and computing in turn: C 8 at B 8, 4 at B 64
// and 1024). CTA r of the cluster owns contexts [r * chunk, (r + 1) *
// chunk) of its row and brings them into shared memory with bulk (TMA)
// copies under one mbarrier, so the contexts are read from device memory
// once; scores (a half-warp per context, 16-byte loads, the query in
// registers, the mask staged beside them) and the weighted sum run from
// shared memory.
// The softmax stays exact, in two exchanges through distributed shared
// memory: each CTA posts its chunk's max, every CTA takes the max over
// the cluster's ranks, posts its chunk's sum of exp(s - max), and every
// CTA sums the posts in rank order 0..C-1, so all of them divide by the
// same denominator and write the reference's normalised weights (an
// online, rescaled softmax would round bf16(attn) differently). Each CTA
// then posts its chunk's partial code vector and reduces a slice of the
// columns over the ranks in rank order, so reruns are bit-equal. Every
// CTA passes every cluster barrier, an empty chunk (M < C) included, and
// a last barrier keeps each CTA's shared memory alive until the others
// have read it. Where a chunk does not fit in shared memory (M in the
// thousands) the CTA reads its contexts from device memory instead
// (`staged` 0), twice, as the kernel before clusters did.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr uint32_t kCopyBytes = 32768;  // one bulk copy at most
// 8-value pieces of the query a lane holds in registers (widths up to
// 16 lanes x 8 x 4 = 512; wider rows read the rest from shared memory)
constexpr int kQueryRegs = 4;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// The shared-memory layout of one CTA (kernels/attention.py
// `smem_bytes` mirrors it): the mbarrier, the contexts (staged only), the
// bf16-rounded query, the chunk's mask and scores, the slices of partial
// code vectors the other ranks push here, the block reduction's slots and
// the ranks' posts (max, sum).
struct Layout {
  size_t ctx, a, mk, sc, inb, red, post, total;
  __host__ __device__ Layout(int chunk, int d, int staged) {
    ctx = 128;
    a = ctx + (staged ? static_cast<size_t>(chunk) * d * 2 : 0);
    mk = a + static_cast<size_t>(d) * 4;
    sc = mk + align16(static_cast<size_t>(chunk) * 4);
    inb = sc + align16(static_cast<size_t>(chunk) * 4);
    red = inb + align16((static_cast<size_t>(d) + 2 * kMaxCluster) * 4);
    post = red + align16(kWarps * 4);
    total = post + 2 * kMaxCluster * 4;
  }
};

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

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Cluster b handles batch row b; its CTA r owns contexts
// [r * chunk, (r + 1) * chunk). Two cluster barriers a row: after every
// rank has pushed its (max, sum) post to all ranks, and after every rank
// has pushed its partial code vector's slices to the ranks that own them;
// nothing is read from another CTA after the second, so no CTA waits for
// the others to leave.
__global__ void __launch_bounds__(kThreads, 4)
masked_attention_kernel(const __nv_bfloat16* t, const float* attn_param,
                        const float* mask, int m, int d, int chunk,
                        int staged, float* cv, float* attn) {
  extern __shared__ __align__(128) unsigned char smem[];
  cluster_arrive();  // every CTA of the cluster has started (waited below)
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nc;
  const int tid = threadIdx.x;
  const Layout L(chunk, d, staged);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* a = reinterpret_cast<float*>(smem + L.a);
  float* mk = reinterpret_cast<float*>(smem + L.mk);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* inb = reinterpret_cast<float*>(smem + L.inb);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* post = reinterpret_cast<float*>(smem + L.post);  // (rank, 2)
  const int j0 = min(m, r * chunk);
  const int n = min(m, j0 + chunk) - j0;
  const __nv_bfloat16* grow = t + (static_cast<int64_t>(b) * m + j0) * d;
  const float* mrow = mask + static_cast<int64_t>(b) * m + j0;
  const bool in_smem = staged && n > 0;

  if (tid == 0 && in_smem) {
    c2v::hopper::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t bytes = static_cast<uint32_t>(n) * d * 2;
    c2v::hopper::mbar_arrive_tx(bar, bytes);
    const unsigned char* src = reinterpret_cast<const unsigned char*>(grow);
    for (uint32_t off = 0; off < bytes; off += kCopyBytes)
      c2v::hopper::bulk_load(smem + L.ctx + off, src + off,
                             min(kCopyBytes, bytes - off), bar);
  }
  for (int i = tid; i < d; i += kThreads) a[i] = c2v::bf16_round(attn_param[i]);
  for (int j = tid; j < n; j += kThreads) mk[j] = mrow[j];
  __syncthreads();
  // a half-warp per context: lane hl's share of the query, in registers
  const int half = tid >> 4, hl = tid & 15;
  float areg[kQueryRegs][8];
#pragma unroll
  for (int u = 0; u < kQueryRegs; ++u)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = hl * 8 + 128 * u + q;
      areg[u][q] = i < d ? a[i] : 0.f;
    }
  if (in_smem) c2v::hopper::mbar_wait(bar, 0);
  const __nv_bfloat16* sctx =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.ctx);

  // scores, 8 values per 16-byte load; the contexts from shared memory
  // (staged) or device memory, in two copies of the loop so that the
  // staged one reads shared memory by its own instructions
  auto scores = [&](const __nv_bfloat16* ctx) {
    for (int jb = 0; jb < n; jb += kThreads / 16) {  // uniform over the CTA
      const int j = jb + half;
      float acc = 0.f;
      if (j < n) {
        const __nv_bfloat16* row = ctx + static_cast<int64_t>(j) * d;
#pragma unroll
        for (int u = 0; u < kQueryRegs; ++u) {
          const int i = hl * 8 + 128 * u;
          if (i < d) {
            const uint4 raw = *reinterpret_cast<const uint4*>(row + i);
            const __nv_bfloat162* t2 =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 f = __bfloat1622float2(t2[q]);
              acc += f.x * areg[u][2 * q] + f.y * areg[u][2 * q + 1];
            }
          }
        }
        for (int i = hl * 8 + 128 * kQueryRegs; i < d; i += 128) {  // d > 512
          const uint4 raw = *reinterpret_cast<const uint4*>(row + i);
          const __nv_bfloat162* t2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(t2[q]);
            acc += f.x * a[i + 2 * q] + f.y * a[i + 2 * q + 1];
          }
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        acc += __shfl_xor_sync(c2v::kFullMask, acc, off);
      if (j < n && hl == 0) sc[j] = mk[j] > 0.f ? acc : -INFINITY;
    }
  };
  if (in_smem)
    scores(sctx);
  else
    scores(grow);
  __syncthreads();

  // the chunk's max and its sum of exp(s - max), posted to every rank
  float mx = -INFINITY;
  for (int j = tid; j < n; j += kThreads) mx = fmaxf(mx, sc[j]);
  mx = block_reduce(mx, red, true);
  const float local = isfinite(mx) ? mx : 0.f;
  float sum = 0.f;
  for (int j = tid; j < n; j += kThreads) sum += expf(sc[j] - local);
  sum = block_reduce(sum, red, false);
  cluster_wait();
  if (tid < nc) {
    float* dst = cluster.map_shared_rank(post, tid);
    dst[2 * r] = mx;
    dst[2 * r + 1] = sum;
  }
  cluster_arrive();
  cluster_wait();
  // the row's max, and the denominator: the ranks' sums rescaled to it,
  // added in rank order (every CTA alike)
  float gmax = -INFINITY;
  for (int q = 0; q < nc; ++q) gmax = fmaxf(gmax, post[2 * q]);
  const float safe = isfinite(gmax) ? gmax : 0.f;
  float total = 0.f;
  for (int q = 0; q < nc; ++q) {
    const float mq = post[2 * q], sq = post[2 * q + 1];
    if (isnan(sq))
      total = sq;  // a NaN score: the row's weights are NaN, as the reference's
    else if (isfinite(mq))
      total += sq * expf(mq - safe);
  }
  const float denom = isnan(total) ? total : fmaxf(total, 1e-30f);
  for (int j = tid; j < n; j += kThreads) {
    const float w = expf(sc[j] - safe) / denom;
    attn[static_cast<int64_t>(b) * m + j0 + j] = w;
    sc[j] = c2v::bf16_round(w);
  }
  __syncthreads();

  // the chunk's partial code vector, two columns a thread (even and odd
  // contexts in separate sums, added at the end), each pair pushed to the
  // rank that owns its slice of the columns
  const int per = 2 * ((d + 2 * nc - 1) / (2 * nc));
  auto weighted = [&](const __nv_bfloat16* ctx) {
    for (int i = tid * 2; i < d; i += kThreads * 2) {
      float e0 = 0.f, e1 = 0.f, o0 = 0.f, o1 = 0.f;
      int j = 0;
#pragma unroll 2
      for (; j + 1 < n; j += 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(ctx + static_cast<int64_t>(j) * d + i));
        const float2 g = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(ctx + static_cast<int64_t>(j + 1) * d + i));
        e0 += sc[j] * f.x;
        e1 += sc[j] * f.y;
        o0 += sc[j + 1] * g.x;
        o1 += sc[j + 1] * g.y;
      }
      if (j < n) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(ctx + static_cast<int64_t>(j) * d + i));
        e0 += sc[j] * f.x;
        e1 += sc[j] * f.y;
      }
      const int q = i / per;
      float2* dst = reinterpret_cast<float2*>(
          cluster.map_shared_rank(inb, q) + r * per + (i - q * per));
      *dst = make_float2(e0 + o0, e1 + o1);
    }
  };
  if (in_smem)
    weighted(sctx);
  else
    weighted(grow);
  cluster_arrive();
  cluster_wait();
  // CTA r sums its slice of the columns over the ranks, in rank order
  const int c_lo = r * per, c_hi = min(d, c_lo + per);
  for (int i = c_lo + tid; i < c_hi; i += kThreads) {
    float s = inb[i - c_lo];
    for (int q = 1; q < nc; ++q) s += inb[q * per + (i - c_lo)];
    cv[static_cast<int64_t>(b) * d + i] = s;
  }
}

}  // namespace

// The dynamic shared memory of one CTA for a chunk of `chunk` contexts of
// width d, with the contexts staged (staged 1) or read from device memory
// (staged 0). kernels/attention.py `smem_bytes` computes the same.
C2V_EXPORT int64_t c2v_attention_smem(int chunk, int d, int staged) {
  return static_cast<int64_t>(Layout(chunk, d, staged).total);
}

// t: bf16 (b, m, d); attn_param: f32 (d,); mask: f32 (b, m).
// cv: f32 (b, d); attn: f32 (b, m). `cluster` CTAs per batch row (1 to 8),
// each owning `chunk` contexts (cluster * chunk >= m), staged in shared
// memory or not: kernels/attention.py `plan`. Returns a cudaError_t.
C2V_EXPORT int c2v_masked_attention(const void* t, const float* attn_param,
                                    const float* mask, int b, int m, int d,
                                    int cluster, int chunk, int staged,
                                    float* cv, float* attn, void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || cluster < 1 ||
      cluster > kMaxCluster || chunk < 1 ||
      static_cast<int64_t>(cluster) * chunk < m ||
      static_cast<int64_t>(b) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = Layout(chunk, d, staged).total;
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, masked_attention_kernel,
                           static_cast<const __nv_bfloat16*>(t), attn_param,
                           mask, m, d, chunk, staged, cv, attn);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
