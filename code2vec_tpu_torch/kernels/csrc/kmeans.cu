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
// byte, so it is bound by operations. A rounding that moves the nearest
// centroid moves a row to another list, so the products must carry f32's
// precision: K9 runs 3xTF32 on the tensor cores (each operand split into
// tf32 hi = rna(x) and lo = rna(x - hi), the product hi.hi + hi.lo +
// lo.hi accumulated in f32: an error of ~2^-21 of |x||c|, the order of
// f32 rounding at D 384; plain TF32 or bf16 would not do). Its roof is
// three tf32 products at 495 TFLOP/s, 4.65 ms at that shape, against
// 11.5 ms for f32 FMAs at 67 TFLOP/s.
// Design: wgmma (m64n128k8, tf32) fed by bulk copies under a 4-stage
// mbarrier ring. A CTA owns 128 rows at a time (one per thread's two
// rows in each of two consumer warpgroups, 64 rows each) and walks the
// centroids in tiles of 128 (nlist 511 and 1000 leave dead padded
// columns, masked in the epilogue), each over 32-wide K blocks: a stage
// holds the tile's block of centroids, already split into hi and lo and
// laid out as wgmma's 128-byte-swizzled K-major B operand by a pre-pass
// (3 MB at nlist 1000, read from L2; one bulk copy), and the rows' block
// (one tensor (TMA) copy of 128 rows x 32 columns, 128-byte-swizzled: one
// bulk copy per 128-byte row left the copy engine, not the memory, to set
// the pace, ~4x slower). Where the rows are split:
// again for every centroid tile, in registers, as wgmma's A fragments
// (decode_tf32): the split is three instructions a value against 128
// centroids' worth of products, and keeping split rows in shared memory
// would cost twice the rows' bytes there for no fewer instructions. A
// stage goes back to the ring once the products that read its B have
// completed, one K block later. The epilogue folds |c|^2 - 2 acc into a
// running argmin per row in registers
// (centroids ascending, strict <), then across the four threads that
// share a row, so the (N, C) distances never exist.
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
#include "hopper.cuh"

namespace {

using namespace c2v::hopper;

// ------------------------------------------------------------------ K9

constexpr int kAssignRows = 128;  // rows of x per CTA tile (2 x 64)
constexpr int kCentTile = 128;    // centroids per tile (wgmma's N)
constexpr int kAssignStages = 4;
constexpr int kCBlock = kCentTile * 128;  // a tile's tf32 block (hi or lo)
constexpr int kXBlock = kAssignRows * 128;  // the rows' 32-column box
constexpr int kAssignStage = 2 * kCBlock + kXBlock;
constexpr int kAssignThreads = 2 * 128 + 32;

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

// The centroids as K9's B operand: for centroid tile ct and 32-wide K
// block kb, a [128][32] tf32 hi tile and then its lo tile, each
// 128-byte-swizzled and K-permuted as tf32_col says (16 KB each). Rows
// past n_cent and columns past d are zeros.
__global__ void centroid_tiles_kernel(const float* c, int n_cent, int d,
                                      int n_kb, int64_t chunks,
                                      uint8_t* tiles) {
  for (int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
       e < chunks; e += int64_t(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(e % 8);            // 16-byte chunk
    const int n = static_cast<int>(e / 8 % kCentTile);  // row of the tile
    const int64_t blk = e / (8 * kCentTile);            // ct * n_kb + kb
    const int kb = static_cast<int>(blk % n_kb);
    const int64_t cent = blk / n_kb * kCentTile + n;
    uint32_t h[4], l[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int col = 32 * kb + tf32_col(4 * j + t);
      const float x = cent < n_cent && col < d ? c[cent * d + col] : 0.f;
      h[t] = tf32_rna(x);
      l[t] = tf32_rna(x - __uint_as_float(h[t]));
    }
    uint8_t* dst = tiles + blk * 2 * kCBlock + n * 128 + ((j ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(dst + kCBlock) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__device__ __forceinline__ bool dist_before(float da, int ia, float db,
                                            int ib) {
  return da < db || (da == db && ia < ib);
}

// The assignment (module note): persistent CTAs over 128-row tiles of x;
// two consumer warpgroups (rows 64 g + [0, 64)), then the producer warp.
__global__ void __launch_bounds__(kAssignThreads, 1)
kmeans_assign_kernel(const __grid_constant__ CUtensorMap xmap, int64_t n,
                     int d, const uint8_t* tiles, int n_cent,
                     const float* norms, int* assign) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem +
                                               kAssignStages * kAssignStage);
  uint64_t* empty = full + kAssignStages;
  const int n_kb = (d + 31) / 32;
  const int n_ct = (n_cent + kCentTile - 1) / kCentTile;
  const int64_t n_xt = (n + kAssignRows - 1) / kAssignRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kAssignStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(c2v::kFullMask, tid / 128, 0);
  if (wg == 2) {  // producer: per x tile, per centroid tile, per K block
    const int lane = tid % 32;
    int64_t seq = 0;
    for (int64_t xt = blockIdx.x; xt < n_xt; xt += gridDim.x) {
      const int r0 = static_cast<int>(xt * kAssignRows);
      for (int ct = 0; ct < n_ct; ++ct)
        for (int kb = 0; kb < n_kb; ++kb, ++seq) {
          const int slot = static_cast<int>(seq % kAssignStages);
          if (seq >= kAssignStages)
            mbar_wait(&empty[slot], ((seq / kAssignStages) - 1) & 1);
          uint8_t* st = smem + slot * kAssignStage;
          if (lane == 0) {
            mbar_arrive_tx(&full[slot], 2 * kCBlock + kXBlock);
            bulk_load(st, tiles + (static_cast<int64_t>(ct) * n_kb + kb) *
                                      2 * kCBlock,
                      2 * kCBlock, &full[slot]);
            tma_load_2d(st + 2 * kCBlock, &xmap, 32 * kb, r0, &full[slot]);
          }
        }
    }
    return;
  }

  const int lane = tid % 32, warp = (tid % 128) / 32, q = lane % 4;
  const int row0 = 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
  const uint32_t sb = smem_u32(smem);
  float acc[64];
  uint32_t a0[4][4], l0[4][4], a1[4][4], l1[4][4];
  int64_t seq = 0;
  int prev = -1;  // the stage of the last K block whose products may run
  for (int64_t xt = blockIdx.x; xt < n_xt; xt += gridDim.x) {
    float best[2] = {INFINITY, INFINITY};
    int best_i[2] = {c2v::kEmptyIndex, c2v::kEmptyIndex};
    for (int ct = 0; ct < n_ct; ++ct) {
      auto unit = [&](int kb, uint32_t (&a)[4][4], uint32_t (&l)[4][4]) {
        const int slot = static_cast<int>(seq % kAssignStages);
        mbar_wait(&full[slot], (seq / kAssignStages) & 1);
        const uint8_t* st = smem + slot * kAssignStage;
        decode_tf32(st + 2 * kCBlock, row0, q, 32 * kb + 8 * q < d, a, l);
        wgmma_fence();
        const uint32_t bh = sb + slot * kAssignStage;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint64_t dh = desc(bh + s * 32, 16, 1024);
          const uint64_t dl = desc(bh + kCBlock + s * 32, 16, 1024);
          wgmma_tf32_rs(acc, a[s], dl, kb > 0 || s > 0);
          wgmma_tf32_rs(acc, l[s], dh, 1);
          wgmma_tf32_rs(acc, a[s], dh, 1);
        }
        wgmma_commit();
        // block kb - 1 is done: its registers are free, and its stage (B
        // is read from the stage by the products) goes back to the ring
        wgmma_wait<1>();
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = slot;
        ++seq;
      };
      for (int kb = 0; kb < n_kb; kb += 2) {
        unit(kb, a0, l0);
        if (kb + 1 < n_kb) unit(kb + 1, a1, l1);
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      prev = -1;
      // centroids ascending: thread columns 8 j + 2 q + h of the tile
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = ct * kCentTile + 8 * j + 2 * q + h;
          if (ci >= n_cent) continue;
          const float cn = __ldg(norms + ci);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float dist = cn - 2.f * acc[4 * j + 2 * r + h];
            if (dist < best[r]) best[r] = dist, best_i[r] = ci;
          }
        }
    }
    // the four threads of a row (lane % 4) hold its columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float bd = best[r];
      int bi = best_i[r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(c2v::kFullMask, bd, off);
        const int oi = __shfl_xor_sync(c2v::kFullMask, bi, off);
        if (dist_before(od, oi, bd, bi)) bd = od, bi = oi;
      }
      const int64_t row = xt * kAssignRows + row0 + 8 * r;
      // every distance NaN: jnp.argmin's answer for an all-NaN row is not
      // reproduced; index 0 stands in
      if (q == 0 && row < n) assign[row] = bi == c2v::kEmptyIndex ? 0 : bi;
    }
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

// Bytes of K9's centroid tiles for n_cent centroids of width d (the
// scratch kernels/kmeans.py allocates for c2v_kmeans_assign).
C2V_EXPORT int64_t c2v_kmeans_tile_bytes(int n_cent, int d) {
  const int64_t n_ct = (n_cent + kCentTile - 1) / kCentTile;
  return n_ct * ((d + 31) / 32) * 2 * kCBlock;
}

// x f32 (n, d), d % 4 == 0 (the tensor map's row stride is whole 16-byte
// units; the columns of a 32-wide K block past d come in as zeros, and
// the centroid tiles hold zeros there); c f32 (n_cent, d). Scratch: norms
// f32 (n_cent,), tiles (c2v_kmeans_tile_bytes). Writes assign int32 (n,).
// `sms`: CTAs at most (one per SM).
C2V_EXPORT int c2v_kmeans_assign(const float* x, int64_t n, int d,
                                 const float* c, int n_cent, float* norms,
                                 void* tiles, int sms, int* assign,
                                 void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || n_cent <= 0 || sms <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  centroid_norms_kernel<<<(n_cent * 32 + 255) / 256, 256, 0, s>>>(
      c, n_cent, d, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kb = (d + 31) / 32;
  const int64_t chunks = c2v_kmeans_tile_bytes(n_cent, d) / 32;
  centroid_tiles_kernel<<<static_cast<unsigned>((chunks + 255) / 256), 256,
                          0, s>>>(c, n_cent, d, n_kb, chunks,
                                  static_cast<uint8_t*>(tiles));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  CUtensorMap xmap;
  if ((err = c2v::hopper::f32_rows_map(&xmap, x, n, d, kAssignRows)) !=
      cudaSuccess)
    return err;
  const int smem = kAssignStages * (kAssignStage + 16) + 1024;
  err = cudaFuncSetAttribute(kmeans_assign_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int64_t n_xt = (n + kAssignRows - 1) / kAssignRows;
  const int grid = static_cast<int>(n_xt < sms ? n_xt : sms);
  kmeans_assign_kernel<<<grid, kAssignThreads, smem, s>>>(
      xmap, n, d, static_cast<const uint8_t*>(tiles), n_cent, norms, assign);
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
