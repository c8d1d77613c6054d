// Memory microbenchmarks, no part of any kernel of the port. The gather
// probe reads random 512-byte rows of an f32 (rows, 128) table, as K1
// (encoder.cu) gathers its token and path rows, at a chosen number of
// bytes in flight per SM; scripts/profile_torch_encoder_xent.py builds
// it (it is not in kernels/build.py SOURCES, so the port never does) and
// times it over the whole table and over its first 32 MB of rows. The
// row read-modify-write probe moves K12's row bytes alone, for
// scripts/profile_torch_sparse_adam_attention.py. The empty kernel is the
// device time of a launch that does nothing, for
// scripts/profile_torch_label_logits.py.
#include "common.cuh"

namespace {

// Each warp reads whole rows of 128 f32 (512 bytes, 16 a lane), kU rows
// at a time, the next rows' ids loaded before this batch's rows are
// consumed; 16 warps a CTA, one CTA per SM, so 8 KB x kU of rows in
// flight per SM.
template <int kU>
__global__ void __launch_bounds__(512, 1)
gather_probe_kernel(const float* table, const int* ids, int64_t n,
                    float* sink) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = blockIdx.x * 16LL + threadIdx.x / 32;
  const int64_t stride = gridDim.x * 16LL * kU;
  float acc = 0.f;
  int id[kU];
  int64_t base = warp * kU;
#pragma unroll
  for (int u = 0; u < kU; ++u)
    id[u] = base + u < n ? __ldg(ids + base + u) : -1;
  for (; base < n; base += stride) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      v[u] = id[u] >= 0 ? __ldg(reinterpret_cast<const float4*>(
                              table + static_cast<int64_t>(id[u]) * 128) +
                          lane)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const int64_t next = base + stride;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      id[u] = next + u < n ? __ldg(ids + next + u) : -1;
#pragma unroll
    for (int u = 0; u < kU; ++u) acc += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  if (acc == 1.2345e-30f) sink[0] = acc;  // keeps the loads
}

}  // namespace

// n ids into an f32 (rows, 128) table, `unroll` in {1, 2, 4, 8} rows a
// warp at a time (8 KB x unroll in flight per SM), one CTA per SM.
// Returns a cudaError_t.
C2V_EXPORT int c2v_gather_probe(const float* table, const int* ids,
                                int64_t n, int unroll, float* sink,
                                void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unroll) {
    case 1: gather_probe_kernel<1><<<sms, 512, 0, s>>>(table, ids, n, sink);
      break;
    case 2: gather_probe_kernel<2><<<sms, 512, 0, s>>>(table, ids, n, sink);
      break;
    case 4: gather_probe_kernel<4><<<sms, 512, 0, s>>>(table, ids, n, sink);
      break;
    case 8: gather_probe_kernel<8><<<sms, 512, 0, s>>>(table, ids, n, sink);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

namespace {

// K12's row traffic alone (csrc/sparse_adam.cu's segment pass without
// its sums): for each of n sorted row ids, a 512-byte f32 row of `table`
// and of `nu` and a 256-byte bf16 row of `mu` read and (write 1) written
// back, and one 256-byte bf16 gradient row read at position pos[i]; a
// warp per 32 ids, 4 at a time, every load of the 4 issued before any
// store, 4 warps a CTA.
__global__ void __launch_bounds__(128)
row_rmw_probe_kernel(float* table, __nv_bfloat16* mu, float* nu,
                     const __nv_bfloat16* grads, const int* ids,
                     const int* pos, int64_t n, int write, float* sink) {
  const int lane = threadIdx.x & 31;
  const int64_t i0 = (blockIdx.x * 4LL + threadIdx.x / 32) * 32;
  float acc = 0.f;
  for (int64_t j = i0; j < i0 + 32 && j < n; j += 4) {
    float4 p[4], v[4];
    uint2 m[4], g[4];
    int64_t o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      o[u] = -1;
      if (j + u < n) {
        o[u] = static_cast<int64_t>(ids[j + u]) * 128 + lane * 4;
        p[u] = *reinterpret_cast<const float4*>(table + o[u]);
        v[u] = *reinterpret_cast<const float4*>(nu + o[u]);
        m[u] = *reinterpret_cast<const uint2*>(mu + o[u]);
        g[u] = *reinterpret_cast<const uint2*>(
            grads + static_cast<int64_t>(pos[j + u]) * 128 + lane * 4);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (o[u] < 0) continue;
      const float x = __uint_as_float(g[u].x) * 0.f;
      if (write) {
        *reinterpret_cast<float4*>(table + o[u]) =
            make_float4(p[u].x + x, p[u].y, p[u].z, p[u].w);
        *reinterpret_cast<float4*>(nu + o[u]) = v[u];
        *reinterpret_cast<uint2*>(mu + o[u]) = m[u];
      } else {
        acc += p[u].x + v[u].x + __uint_as_float(m[u].x) + x;
      }
    }
  }
  if (acc == 1.2345e-30f) sink[0] = acc;  // keeps the loads
}

__global__ void empty_kernel() {}

}  // namespace

// One launch of a kernel that does nothing: `blocks` CTAs of `threads`
// threads. Returns a cudaError_t.
C2V_EXPORT int c2v_empty_kernel(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// n sorted row ids of 128-wide tables (f32 table and nu, bf16 mu), each
// with one bf16 gradient row at pos[i]: K12's row bytes, read only
// (write 0) or read and written back. Returns a cudaError_t.
C2V_EXPORT int c2v_row_rmw_probe(float* table, void* mu, float* nu,
                                 const void* grads, const int* ids,
                                 const int* pos, int64_t n, int write,
                                 float* sink, void* stream) {
  const int64_t blocks = (n + 127) / 128;
  if (n <= 0) return cudaSuccess;
  row_rmw_probe_kernel<<<static_cast<unsigned>(blocks), 128, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<__nv_bfloat16*>(mu), nu,
      static_cast<const __nv_bfloat16*>(grads), ids, pos, n, write, sink);
  return cudaGetLastError();
}
