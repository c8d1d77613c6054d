// K9 kmeans_assign and K10 kmeans_update: one Lloyd step of the coarse
// quantizer of the retrieval index and of the approximate-MIPS head.
//
// K9 replaces code2vec_tpu/retrieval/index.py `_assign_jax` (:117-122),
// run inside `train_kmeans.lloyd` (:96-111) and by `assign_lists` (:125):
// for every row x of (N, D) f32, argmin over the (C, D) f32 centroids of
// |c|^2 - 2 x.c, ties to the lowest centroid index (jnp.argmin).
// K10 replaces the update of `lloyd`: segment sums of the rows and counts
// by assignment, the mean, the old centroid kept where a cluster is
// empty, and (spherical k-means) the mean renormalised with a 1e-12
// guard.
//
// What bounds them on an H100. K9 is a product: 2 N C D operations (0.77
// TFLOP at 1M x 1000 x 384) over N D + C D floats, ~250 operations per
// byte, so it is bound by operations. They must be float32 FMAs, not
// TF32 or bf16: a rounding that moves the nearest centroid moves a row to
// another list, so the card's float32 rate (67 TFLOP/s) is the roof,
// 11.5 ms at that shape. Design: a classic register-tiled product, 128
// rows x 128 centroids per CTA pass, 16-deep slices of both staged in
// shared memory (k-major, so each thread reads float4s), each thread 8
// rows x 8 centroids in registers; the distance and the running argmin
// are folded in right after each centroid tile, so the (N, C) distances
// never exist, and a shuffle reduction across the 16 threads that share
// a row picks the winner with the lowest index among equals.
//
// K10 reads every row once (N D floats) and is bound by bytes. It must be
// deterministic: ten Lloyd steps feed each other, and f32 atomics would
// add each cluster's rows in a different order on every run, so the lists
// would drift apart run to run. Design: a stable counting sort of the row
// ids by assignment (per-tile histograms with integer atomics, a scan of
// each cluster's counts over the tiles, a scan of the cluster totals, and
// one warp per tile that places its rows in row order with
// __match_any_sync), then one CTA per centroid that sums its members in a
// fixed order: G groups of threads each sum a contiguous quarter of the
// member list in row order, float4 columns per thread, and the G partials
// are added in group order. Integer counts and fixed-order sums give the
// same bits on every run.
#include "common.cuh"

namespace {

// ------------------------------------------------------------------ K9

constexpr int kAssignBM = 128;  // rows per CTA
constexpr int kAssignBN = 128;  // centroids per tile
constexpr int kAssignBK = 16;   // depth per shared-memory slice
constexpr int kAssignThreads = 256;

// |c|^2 per centroid, one warp each, in f32.
__global__ void centroid_norms_kernel(const float* c, int n_cent, int d,
                                      float* norms) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_cent) return;
  const float* row = c + static_cast<int64_t>(warp) * d;
  float s = 0.f;
  for (int j = lane; j < d; j += 32) s = fmaf(row[j], row[j], s);
  s = c2v::warp_sum(s);
  if (lane == 0) norms[warp] = s;
}

// A [kAssignBK][rows] k-major slice of `src` (n_rows x d, row-major),
// zero past n_rows and past d. 16-byte loads when d % 4 == 0.
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int64_t row0, int64_t n_rows,
                                           int d, int k0, int tile_rows,
                                           int tid, int n_threads) {
  const int per_row = kAssignBK / 4;  // float4s per row of the slice
  for (int e = tid; e < tile_rows * per_row; e += n_threads) {
    const int r = e / per_row, q = (e - r * per_row) * 4;
    const int64_t row = row0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n_rows) {
      const float* p = src + row * d + k0 + q;
      if ((d & 3) == 0 && k0 + q + 4 <= d) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k0 + q + i < d) v[i] = p[i];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(q + i) * tile_rows + r] = v[i];
  }
}

__device__ __forceinline__ bool dist_before(float da, int ia, float db,
                                            int ib) {
  return da < db || (da == db && ia < ib);
}

__global__ void __launch_bounds__(kAssignThreads)
kmeans_assign_kernel(const float* x, int64_t n, int d, const float* c,
                     int n_cent, const float* norms, int* assign) {
  __shared__ __align__(16) float sx[kAssignBK * kAssignBM];
  __shared__ __align__(16) float sc[kAssignBK * kAssignBN];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kAssignBM;

  // rows ty*4 + 64*i + q, centroids tx*4 + 64*j + q (i, j < 2, q < 4):
  // consecutive threads read consecutive float4s of the centroid slice
  float best[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best[i] = INFINITY;
    best_i[i] = c2v::kEmptyIndex;
  }
  for (int c0 = 0; c0 < n_cent; c0 += kAssignBN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kAssignBK) {
      __syncthreads();  // the previous slice is consumed
      load_slice(sx, x, r0, n, d, k0, kAssignBM, tid, kAssignThreads);
      load_slice(sc, c, c0, n_cent, d, k0, kAssignBN, tid, kAssignThreads);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kAssignBK; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 av = *reinterpret_cast<const float4*>(
              sx + kk * kAssignBM + ty * 4 + 64 * h);
          const float4 bv = *reinterpret_cast<const float4*>(
              sc + kk * kAssignBN + tx * 4 + 64 * h);
          a[4 * h] = av.x, a[4 * h + 1] = av.y, a[4 * h + 2] = av.z,
          a[4 * h + 3] = av.w;
          b[4 * h] = bv.x, b[4 * h + 1] = bv.y, b[4 * h + 2] = bv.z,
          b[4 * h + 3] = bv.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // fold this tile's distances into the running argmin, centroids in
    // ascending order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = c0 + tx * 4 + 64 * (j >> 2) + (j & 3);
      if (ci >= n_cent) continue;
      const float cn = norms[ci];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dist = cn - 2.f * acc[i][j];
        if (dist_before(dist, ci, best[i], best_i[i])) {
          best[i] = dist;
          best_i[i] = ci;
        }
      }
    }
  }
  // the 16 threads of a row group are one half-warp
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bd = best[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(c2v::kFullMask, bd, off);
      const int oi = __shfl_xor_sync(c2v::kFullMask, bi, off);
      if (dist_before(od, oi, bd, bi)) bd = od, bi = oi;
    }
    const int64_t row = r0 + ty * 4 + 64 * (i >> 2) + (i & 3);
    // every distance NaN: jnp.argmin's answer for an all-NaN row is not
    // reproduced; index 0 stands in
    if (tx == 0 && row < n) assign[row] = bi == c2v::kEmptyIndex ? 0 : bi;
  }
}

// ----------------------------------------------------------------- K10

constexpr int kTileRows = 1024;  // rows per counting-sort tile
constexpr int kGroups = 4;       // member-list slices summed in parallel

// tile_pos[t][c] += rows of tile t assigned to c (tile_pos zeroed).
__global__ void tile_hist_kernel(const int* assign, int64_t n, int n_cent,
                                 int* tile_pos) {
  const int64_t t = blockIdx.x;
  const int64_t lo = t * kTileRows;
  for (int64_t r = lo + threadIdx.x; r < lo + kTileRows && r < n;
       r += blockDim.x) {
    const int a = assign[r];
    if (a >= 0 && a < n_cent) atomicAdd(tile_pos + t * n_cent + a, 1);
  }
}

// For each cluster: tile_pos[t][c] becomes the exclusive prefix of its
// counts over the tiles, and counts[c] the total.
__global__ void tile_scan_kernel(int* tile_pos, int64_t n_tiles, int n_cent,
                                 int* counts) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cent) return;
  int run = 0;
  for (int64_t t = 0; t < n_tiles; ++t) {
    const int v = tile_pos[t * n_cent + c];
    tile_pos[t * n_cent + c] = run;
    run += v;
  }
  counts[c] = run;
}

// offsets[0..n_cent] = exclusive prefix sum of counts (one CTA).
__global__ void __launch_bounds__(1024)
offsets_scan_kernel(const int* counts, int n_cent, int* offsets) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_cent; base += 1024) {
    const int c = base + tid;
    const int v = c < n_cent ? counts[c] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(c2v::kFullMask, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(c2v::kFullMask, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (c < n_cent) offsets[c] = before + incl - v;
    __syncthreads();
    if (tid == 0) carry += warp_sums[31];
    __syncthreads();
  }
  if (tid == 0) offsets[n_cent] = carry;
}

// One warp per tile places the tile's rows at their sorted positions in
// row order: members of one cluster in a 32-row chunk find each other
// with __match_any_sync and take consecutive slots after the cluster's
// cursor, which the chunk's leader then advances.
__global__ void __launch_bounds__(32)
scatter_rows_kernel(const int* assign, int64_t n, int n_cent,
                    const int* offsets, int* tile_pos, int* order) {
  const int64_t t = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int* cursor = tile_pos + t * n_cent;
  const int64_t lo = t * kTileRows;
  for (int64_t r0 = lo; r0 < lo + kTileRows && r0 < n; r0 += 32) {
    const int64_t r = r0 + lane;
    int a = r < n && r < lo + kTileRows ? assign[r] : -1;
    if (a >= n_cent) a = -1;
    const unsigned peers = __match_any_sync(c2v::kFullMask, a);
    int base = 0;
    if (a >= 0) base = cursor[a];
    __syncwarp();  // every lane has read its cursor before any moves
    if (a >= 0) {
      order[offsets[a] + base + __popc(peers & below)] = static_cast<int>(r);
      if ((peers & below) == 0) cursor[a] = base + __popc(peers);
    }
    __syncwarp();
  }
}

// One CTA of kGroups x d4 threads per centroid (d4 = d / 4 float4
// columns): group g sums the g-th contiguous slice of the member list in
// row order, the partials are added in group order, then the mean, the
// empty-cluster rule and the spherical renormalisation.
__global__ void centroid_sum_kernel(const float* x, int d,
                                    const float* old_c, const int* order,
                                    const int* offsets, int spherical,
                                    float* new_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* part = reinterpret_cast<float4*>(smem);  // [kGroups][d4]
  __shared__ float red[32];
  const int c = blockIdx.x;
  const int d4 = d / 4;
  const int tid = threadIdx.x, g = tid / d4, col = tid - g * d4;
  const int lo = offsets[c], cnt = offsets[c + 1] - offsets[c];
  if (g < kGroups) {
    const int s0 = lo + static_cast<int>(static_cast<int64_t>(cnt) * g /
                                         kGroups);
    const int s1 = lo + static_cast<int>(static_cast<int64_t>(cnt) *
                                         (g + 1) / kGroups);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int m = s0;
    for (; m + 4 <= s1; m += 4) {  // four loads in flight, added in order
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = reinterpret_cast<const float4*>(
            x + static_cast<int64_t>(order[m + u]) * d)[col];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc.x += v[u].x, acc.y += v[u].y, acc.z += v[u].z, acc.w += v[u].w;
      }
    }
    for (; m < s1; ++m) {
      const float4 v = reinterpret_cast<const float4*>(
          x + static_cast<int64_t>(order[m]) * d)[col];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
    part[g * d4 + col] = acc;
  }
  __syncthreads();
  float4 fresh = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g == 0) {
    float4 s = part[col];
#pragma unroll
    for (int h = 1; h < kGroups; ++h) {
      const float4 p = part[h * d4 + col];
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    const float den = fmaxf(static_cast<float>(cnt), 1.f);
    fresh = make_float4(s.x / den, s.y / den, s.z / den, s.w / den);
  }
  if (spherical) {  // |fresh| over the d4 threads of group 0, fixed order
    float sq = 0.f;
    if (g == 0)
      sq = fresh.x * fresh.x + fresh.y * fresh.y + fresh.z * fresh.z +
           fresh.w * fresh.w;
    sq = c2v::warp_sum(sq);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) red[warp] = sq;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < (blockDim.x + 31) / 32; ++w) t += red[w];
      red[0] = t;
    }
    __syncthreads();
    const float nrm = fmaxf(sqrtf(red[0]), 1e-12f);
    fresh = make_float4(fresh.x / nrm, fresh.y / nrm, fresh.z / nrm,
                        fresh.w / nrm);
  }
  if (g == 0) {
    float4* out = reinterpret_cast<float4*>(new_c + static_cast<int64_t>(c) * d);
    out[col] = cnt > 0 ? fresh
                       : reinterpret_cast<const float4*>(
                             old_c + static_cast<int64_t>(c) * d)[col];
  }
}

}  // namespace

C2V_EXPORT int c2v_kmeans_tile_rows() { return kTileRows; }

// x f32 (n, d), c f32 (n_cent, d), norms f32 (n_cent,) scratch; writes
// assign int32 (n,).
C2V_EXPORT int c2v_kmeans_assign(const float* x, int64_t n, int d,
                                 const float* c, int n_cent, float* norms,
                                 int* assign, void* stream) {
  if (n <= 0 || d <= 0 || n_cent <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  centroid_norms_kernel<<<(n_cent * 32 + 255) / 256, 256, 0, s>>>(
      c, n_cent, d, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (n + kAssignBM - 1) / kAssignBM;
  kmeans_assign_kernel<<<static_cast<unsigned>(blocks), kAssignThreads, 0,
                         s>>>(x, n, d, c, n_cent, norms, assign);
  return cudaGetLastError();
}

// x f32 (n, d), d % 4 == 0; assign int32 (n,) in [0, n_cent); old_c f32
// (n_cent, d). Scratch: tile_pos int32 (n_tiles, n_cent) zeroed, counts
// int32 (n_cent,), offsets int32 (n_cent + 1,), order int32 (n,). Writes
// new_c f32 (n_cent, d).
C2V_EXPORT int c2v_kmeans_update(const float* x, int64_t n, int d,
                                 const int* assign, const float* old_c,
                                 int n_cent, int spherical, int* tile_pos,
                                 int* counts, int* offsets, int* order,
                                 float* new_c, void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || d / 4 * kGroups > 1024 ||
      n_cent <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (n + kTileRows - 1) / kTileRows;
  tile_hist_kernel<<<static_cast<unsigned>(n_tiles), 256, 0, s>>>(
      assign, n, n_cent, tile_pos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scan_kernel<<<(n_cent + 255) / 256, 256, 0, s>>>(tile_pos, n_tiles,
                                                        n_cent, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  offsets_scan_kernel<<<1, 1024, 0, s>>>(counts, n_cent, offsets);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_rows_kernel<<<static_cast<unsigned>(n_tiles), 32, 0, s>>>(
      assign, n, n_cent, offsets, tile_pos, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int threads = kGroups * (d / 4);
  const size_t smem = sizeof(float4) * kGroups * (d / 4);
  centroid_sum_kernel<<<n_cent, threads, smem, s>>>(
      x, d, old_c, order, offsets, spherical, new_c);
  return cudaGetLastError();
}
