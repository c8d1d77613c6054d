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
// value up to f32 rounding, as are its sums' orders (below).
//
// What bounds it on an H100: bytes. It reads T (B, M, 384 bf16) and writes
// dT of the same size, a few flops per element. Design, as K2's forward
// (csrc/attention.cu): a thread-block cluster of C CTAs per batch row (C
// from kernels/attention.py `backward_plan`), CTA r owning a chunk of the
// row's contexts, brought into shared memory by bulk (TMA) copies under
// one mbarrier, so T is read from device memory once. From there, fs (a
// half-warp per context, 16-byte loads, dcv in registers); the chunk's
// sum w fs posted to every rank through distributed shared memory and
// added in rank order; ds; dT written with 16-byte stores, a thread per 8
// columns of a context over the whole chunk (no idle lanes at any width
// that is a multiple of 8), never read back; the chunk's share of da from
// the staged rows (groups of contexts a thread per 8 columns, the groups
// added in order), pushed to the rank that owns the column slice and
// added there in rank order. A second launch, a programmatic dependent of
// the first, sums the rows' da in a fixed order with a CTA per 8 columns
// (32 runs of rows, then the runs in order) and rounds. Reruns are
// bit-equal. Where a chunk does not fit in shared memory (M in the
// thousands) the CTA reads its contexts from device memory instead
// (`staged` 0), twice.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr uint32_t kCopyBytes = 32768;  // one bulk copy at most
// 8-value pieces of dcv a lane holds in registers (widths up to 16 lanes
// x 8 x 4 = 512; wider rows read the rest from shared memory)
constexpr int kQueryRegs = 4;
constexpr int kSumRuns = 32;  // runs of rows a column's da sum takes


__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Groups of contexts the da share is split over: a thread per 8 columns
// of one group, as many groups as fill the CTA.
__host__ __device__ constexpr int da_groups(int d) {
  return d / 8 >= kThreads ? 1 : kThreads / (d / 8);
}

// The shared-memory layout of one CTA (kernels/attention.py
// `backward_smem_bytes` mirrors it): the mbarrier, the contexts (staged
// only), dcv, the bf16-rounded query, the chunk's weights, mask and fs
// (then ds), the groups' da shares, the column slices of da the other
// ranks push here, the block reduction's slots and the ranks' posts.
struct Layout {
  size_t ctx, g, a, w, mk, ds, part, inb, red, post, total;
  __host__ __device__ Layout(int chunk, int d, int staged) {
    ctx = 128;
    g = ctx + (staged ? static_cast<size_t>(chunk) * d * 2 : 0);
    a = g + static_cast<size_t>(d) * 4;
    w = a + static_cast<size_t>(d) * 4;
    mk = w + align16(static_cast<size_t>(chunk) * 4);
    ds = mk + align16(static_cast<size_t>(chunk) * 4);
    part = ds + align16(static_cast<size_t>(chunk) * 4);
    inb = part + static_cast<size_t>(da_groups(d)) * d * 4;
    red = inb + align16((static_cast<size_t>(d) + 2 * kMaxCluster) * 4);
    post = red + align16(kWarps * 4);
    total = post + kMaxCluster * 4;
  }
};

__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = c2v::warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r += red[i];
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* t2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 x = __bfloat1622float2(t2[q]);
    f[2 * q] = x.x;
    f[2 * q + 1] = x.y;
  }
}

// 8 floats of shared memory, 16-byte aligned, by two 16-byte reads.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  f[0] = x.x, f[1] = x.y, f[2] = x.z, f[3] = x.w;
  f[4] = y.x, f[5] = y.y, f[6] = y.z, f[7] = y.w;
}

// Cluster b handles batch row b; its CTA r owns contexts
// [r * chunk, (r + 1) * chunk). Two cluster barriers after the start: once
// every rank has posted its sum of w fs, and once every rank has pushed
// its da columns to their owners; nothing is read from another CTA after
// the second.
__global__ void __launch_bounds__(kThreads, 4)
attention_backward_kernel(const __nv_bfloat16* t, const float* attn_param,
                          const float* mask, const float* attn,
                          const float* dcv, int m, int d, int chunk,
                          int staged, __nv_bfloat16* dt, float* da_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  cluster_arrive();  // every CTA of the cluster has started (waited below)
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nc;
  const int tid = threadIdx.x;
  const Layout L(chunk, d, staged);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* g = reinterpret_cast<float*>(smem + L.g);
  float* a = reinterpret_cast<float*>(smem + L.a);
  float* w = reinterpret_cast<float*>(smem + L.w);
  float* mk = reinterpret_cast<float*>(smem + L.mk);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* inb = reinterpret_cast<float*>(smem + L.inb);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* post = reinterpret_cast<float*>(smem + L.post);
  const int j0 = min(m, r * chunk);
  const int n = min(m, j0 + chunk) - j0;
  const int64_t row0 = static_cast<int64_t>(b) * m + j0;
  const __nv_bfloat16* grow = t + row0 * d;
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
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = tid; i < d; i += kThreads) {
    g[i] = dcv[static_cast<int64_t>(b) * d + i];
    a[i] = c2v::bf16_round(attn_param[i]);
  }
  for (int j = tid; j < n; j += kThreads) {
    w[j] = attn[row0 + j];
    mk[j] = mask[row0 + j];
  }
  __syncthreads();
  // a half-warp per context: lane hl's share of dcv, in registers
  const int half = tid >> 4, hl = tid & 15;
  float greg[kQueryRegs][8];
#pragma unroll
  for (int u = 0; u < kQueryRegs; ++u)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = hl * 8 + 128 * u + q;
      greg[u][q] = i < d ? g[i] : 0.f;
    }
  if (in_smem) c2v::hopper::mbar_wait(bar, 0);
  const __nv_bfloat16* sctx =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.ctx);

  // fs, 8 values per 16-byte load; the contexts from shared memory
  // (staged) or device memory, in two copies of the loop so that the
  // staged one reads shared memory by its own instructions
  auto cotangents = [&](const __nv_bfloat16* ctx) {
    for (int jb = 0; jb < n; jb += kThreads / 16) {  // uniform over the CTA
      const int j = jb + half;
      float acc = 0.f;
      if (j < n) {
        const __nv_bfloat16* row = ctx + static_cast<int64_t>(j) * d;
#pragma unroll
        for (int u = 0; u < kQueryRegs; ++u) {
          const int i = hl * 8 + 128 * u;
          if (i < d) {
            float f[8];
            unpack8(*reinterpret_cast<const uint4*>(row + i), f);
#pragma unroll
            for (int q = 0; q < 8; ++q) acc += f[q] * greg[u][q];
          }
        }
        for (int i = hl * 8 + 128 * kQueryRegs; i < d; i += 128) {  // d > 512
          float f[8];
          unpack8(*reinterpret_cast<const uint4*>(row + i), f);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc += f[q] * g[i + q];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        acc += __shfl_xor_sync(c2v::kFullMask, acc, off);
      if (j < n && hl == 0) ds[j] = c2v::bf16_round(acc);
    }
  };
  if (in_smem)
    cotangents(sctx);
  else
    cotangents(grow);
  __syncthreads();

  // the chunk's sum of w fs, posted to every rank; the row's, in rank order
  float wfs = 0.f;
  for (int j = tid; j < n; j += kThreads) wfs += w[j] * ds[j];
  wfs = block_sum(wfs, red);
  cluster_wait();
  if (tid < nc) cluster.map_shared_rank(post, tid)[r] = wfs;
  cluster_arrive();
  cluster_wait();
  float total = 0.f;
  for (int q = 0; q < nc; ++q) total += post[q];
  for (int j = tid; j < n; j += kThreads)
    ds[j] = mk[j] > 0.f ? w[j] * (ds[j] - total) : 0.f;
  __syncthreads();

  // dT, 8 columns of one context a thread, 16-byte stores
  const int units = d / 8;
  __nv_bfloat16* drow = dt + row0 * d;
  for (int u = tid; u < n * units; u += kThreads) {
    const int j = u / units, i = (u - j * units) * 8;
    const float wb = c2v::bf16_round(w[j]), s = ds[j];
    float gv[8], av[8];  // 16-byte reads: no bank conflicts across lanes
    load8(g + i, gv);
    load8(a + i, av);
    __align__(16) __nv_bfloat162 h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x0 = c2v::bf16_round(wb * gv[2 * q]) +
                       c2v::bf16_round(s * av[2 * q]);
      const float x1 = c2v::bf16_round(wb * gv[2 * q + 1]) +
                       c2v::bf16_round(s * av[2 * q + 1]);
      h[q] = __floats2bfloat162_rn(x0, x1);
    }
    *reinterpret_cast<uint4*>(drow + static_cast<int64_t>(j) * d + i) =
        *reinterpret_cast<const uint4*>(h);
  }

  // the chunk's da share: group gr of `groups` takes contexts gr, gr +
  // groups, ..., a thread per 8 columns
  const int groups = da_groups(d);
  auto da_share = [&](const __nv_bfloat16* ctx) {
    for (int v = tid; v < groups * units; v += kThreads) {
      const int gr = v / units, i = (v - gr * units) * 8;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int j = gr; j < n; j += groups) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    ctx + static_cast<int64_t>(j) * d + i), f);
        const float s = ds[j];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[q] += s * f[q];
      }
      float* dst = part + gr * d + i;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  };
  if (in_smem)
    da_share(sctx);
  else
    da_share(grow);
  __syncthreads();
  // the groups added in order, each column pair pushed to the rank that
  // owns its slice
  const int per = 2 * ((d + 2 * nc - 1) / (2 * nc));
  for (int i = tid * 2; i < d; i += kThreads * 2) {
    float s0 = 0.f, s1 = 0.f;
    for (int gr = 0; gr < groups; ++gr) {
      s0 += part[gr * d + i];
      s1 += part[gr * d + i + 1];
    }
    const int q = i / per;
    *reinterpret_cast<float2*>(cluster.map_shared_rank(inb, q) + r * per +
                               (i - q * per)) = make_float2(s0, s1);
  }
  cluster_arrive();
  cluster_wait();
  // CTA r adds its slice of the columns over the ranks, in rank order
  const int c_lo = r * per, c_hi = min(d, c_lo + per);
  for (int i = c_lo + tid; i < c_hi; i += kThreads) {
    float s = inb[i - c_lo];
    for (int q = 1; q < nc; ++q) s += inb[q * per + (i - c_lo)];
    da_rows[static_cast<int64_t>(b) * d + i] = s;
  }
}

// da over the rows: a CTA per 8 columns; thread (run, column) adds its run
// of rows in order, then the runs are added in order and rounded to bf16.
__global__ void __launch_bounds__(kSumRuns * 8)
da_sum_kernel(const float* rows, int b, int d, float* out) {
  __shared__ float runs[kSumRuns][8];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int col = threadIdx.x & 7, run = threadIdx.x >> 3;
  const int i = blockIdx.x * 8 + col;
  const int per = (b + kSumRuns - 1) / kSumRuns;
  const int r0 = run * per, r1 = min(b, r0 + per);
  float s = 0.f;
  if (i < d)
    for (int q = r0; q < r1; ++q) s += rows[static_cast<int64_t>(q) * d + i];
  runs[run][col] = s;
  __syncthreads();
  if (run == 0 && i < d) {
    float total = 0.f;
    for (int q = 0; q < kSumRuns && q * per < b; ++q) total += runs[q][col];
    out[i] = c2v::bf16_round(total);
  }
}

}  // namespace

// The dynamic shared memory of one CTA for a chunk of `chunk` contexts of
// width d, staged (1) or read from device memory (0).
// kernels/attention.py `backward_smem_bytes` computes the same.
C2V_EXPORT int64_t c2v_attention_backward_smem(int chunk, int d,
                                               int staged) {
  return static_cast<int64_t>(Layout(chunk, d, staged).total);
}

// t: bf16 (b, m, d); attn_param: f32 (d,); mask, attn: f32 (b, m); dcv:
// f32 (b, d). `cluster` CTAs per batch row (1 to 8), each owning `chunk`
// contexts (cluster * chunk >= m), staged in shared memory or not:
// kernels/attention.py `backward_plan`. Outputs: dt bf16 (b, m, d); da
// f32 (d,), through the scratch da_rows f32 (b, d). Returns a
// cudaError_t.
C2V_EXPORT int c2v_attention_backward(const void* t, const float* attn_param,
                                      const float* mask, const float* attn,
                                      const float* dcv, int b, int m, int d,
                                      int cluster, int chunk, int staged,
                                      void* dt, float* da_rows, float* da,
                                      void* stream) {
  if (b <= 0 || m <= 0 || d <= 0 || d % 8 != 0 || cluster < 1 ||
      cluster > kMaxCluster || chunk < 1 ||
      static_cast<int64_t>(cluster) * chunk < m ||
      static_cast<int64_t>(b) * cluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = Layout(chunk, d, staged).total;
  cudaError_t err = cudaFuncSetAttribute(
      attention_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attention_backward_kernel,
                           static_cast<const __nv_bfloat16*>(t), attn_param,
                           mask, attn, dcv, m, d, chunk, staged,
                           static_cast<__nv_bfloat16*>(dt), da_rows);
  if (err != cudaSuccess) return err;
  // the rows' sum, as a programmatic dependent of the first launch
  cudaLaunchConfig_t sum = {};
  sum.gridDim = dim3(static_cast<unsigned>((d + 7) / 8));
  sum.blockDim = dim3(kSumRuns * 8);
  sum.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  sum.attrs = pdl;
  sum.numAttrs = 1;
  err = cudaLaunchKernelEx(&sum, da_sum_kernel,
                           static_cast<const float*>(da_rows), b, d, da);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
