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

// The stable sort of the row ids by assignment. One pass of a digit of
// up to 11 bits takes n_cent <= kMaxBins:
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kPerThread = 8;                     // rows a thread ranks
constexpr int kWarpRows = 32 * kPerThread;        // 256
constexpr int kSortTile = kSortThreads * kPerThread;  // 2,048 rows a CTA
constexpr int kMaxBins = 2048;
constexpr int kScanDigits = 8;   // clusters a scan CTA takes
constexpr int kScanStage = 4096;  // counts it stages, at most
// a larger n_cent takes the counting sort of 1,024-row tiles with a
// serial scan of each cluster's tile counts:
constexpr int kTileRows = 1024;
// The sums: a CTA streams its range of the sorted rows through a ring of
// kStages stages of at most kStageRows rows of one cluster.
constexpr int kStageRows = 8;
constexpr int kStages = 4;
constexpr int kMaxConsumerWarps = 8;  // d <= 1024: 256 float4 columns
constexpr int kCombineGroups = 4;
// a stage's flags: the first and last stage of a cluster's rows in the
// CTA's range, and where that segment's sum goes
enum { kFirst = 1, kLast = 2, kWhole = 4, kHead = 8 };

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(c2v::kFullMask, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// The exclusive prefix of v over the CTA's kSortThreads threads, and the
// total.
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t v,
                                                    uint32_t* red,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(v, lane);
  __syncthreads();  // red may still be read by a previous scan
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  uint32_t off = incl - v, all = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    if (w < warp) off += red[w];
    all += red[w];
  }
  *total = all;
  return off;
}

__device__ __forceinline__ int row_cluster(const int* assign, int64_t r,
                                           int64_t n, int n_cent) {
  const int a = r < n ? assign[r] : -1;
  return a >= 0 && a < n_cent ? a : -1;  // -1: no cluster, dropped
}

// (1) a CTA per tile of kSortTile rows: the tile's count of each cluster
// (lanes of a warp that share a cluster add once) in a row of `cs`
// (n_cent rounded up to 8) counts, and every cluster's total.
__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(const int* assign, int64_t n, int n_cent, int cs,
                 uint32_t* tile_hist, uint32_t* totals) {
  __shared__ uint32_t h[kMaxBins];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < cs; i += kSortThreads) h[i] = 0u;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kSortTile;
  int a[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    a[j] = row_cluster(assign, t0 + j * kSortThreads + tid, n, n_cent);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned peers = __match_any_sync(c2v::kFullMask, a[j]);
    if (a[j] >= 0 && (peers & below) == 0) atomicAdd(&h[a[j]], __popc(peers));
  }
  __syncthreads();
  uint32_t* th = tile_hist + static_cast<int64_t>(blockIdx.x) * cs;
  for (int i = tid; i < cs; i += kSortThreads) {
    th[i] = h[i];
    if (h[i] != 0u) atomicAdd(&totals[i], h[i]);
  }
}

// (2) a CTA per kScanDigits clusters: each (tile, cluster)'s first slot
// (the rows of lower clusters plus the cluster's rows in earlier tiles),
// in place of its count, and each cluster's first row. A tile's 8 counts
// are one 32-byte sector: read a sector a thread into shared memory,
// cluster-major, where they fit, and scanned there.
__global__ void __launch_bounds__(kSortThreads)
sort_scan_kernel(uint32_t* tile_hist, const uint32_t* totals, int64_t tiles,
                 int n_cent, int cs, int* offsets) {
  __shared__ uint32_t red[kSortWarps];
  __shared__ __align__(16) uint32_t cnt[kScanStage];
  const int tid = threadIdx.x, b0 = blockIdx.x * kScanDigits;
  uint32_t low = 0, total;
  for (int b = tid; b < b0; b += kSortThreads) low += totals[b];
  block_excl_scan(low, red, &total);
  low = total;
  const int nd = min(kScanDigits, n_cent - b0);
  if (tid == 0) {
    uint32_t first = low;
    for (int q = 0; q < nd; ++q) {
      offsets[b0 + q] = static_cast<int>(first);
      first += totals[b0 + q];
    }
    if (b0 + nd == n_cent) offsets[n_cent] = static_cast<int>(first);
  }
  const int64_t all = kScanDigits * tiles;
  const bool staged = all <= kScanStage;
  auto at = [&](int64_t e) { return (e % tiles) * cs + b0 + e / tiles; };
  if (staged)
    for (int64_t t = tid; t < tiles; t += kSortThreads) {
      const uint4* src = reinterpret_cast<const uint4*>(tile_hist + t * cs + b0);
      const uint4 x = src[0], y = src[1];
      const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) cnt[q * tiles + t] = v[q];
    }
  __syncthreads();
  // the (cluster, tile) counts cluster-major, a contiguous run a thread
  const int64_t per = (all + kSortThreads - 1) / kSortThreads;
  const int64_t e0 = tid * per, e1 = e0 + per < all ? e0 + per : all;
  uint32_t run = 0;
  for (int64_t e = e0; e < e1; ++e) run += staged ? cnt[e] : tile_hist[at(e)];
  uint32_t slot = low + block_excl_scan(run, red, &total);
  for (int64_t e = e0; e < e1; ++e) {
    const uint32_t c = staged ? cnt[e] : tile_hist[at(e)];
    if (staged)
      cnt[e] = slot;
    else
      tile_hist[at(e)] = slot;
    slot += c;
  }
  if (!staged) return;
  __syncthreads();
  for (int64_t t = tid; t < tiles; t += kSortThreads) {
    uint4* dst = reinterpret_cast<uint4*>(tile_hist + t * cs + b0);
    dst[0] = make_uint4(cnt[t], cnt[tiles + t], cnt[2 * tiles + t],
                        cnt[3 * tiles + t]);
    dst[1] = make_uint4(cnt[4 * tiles + t], cnt[5 * tiles + t],
                        cnt[6 * tiles + t], cnt[7 * tiles + t]);
  }
}

// (3) a CTA per tile ranks its rows by cluster, stably (a warp per 256
// rows in row order, __match_any_sync), and places their ids from (2)'s
// slots (the warps' counts: 8 x n_cent, up to 64 KB of shared memory).
__global__ void __launch_bounds__(kSortThreads)
sort_scatter_kernel(const int* assign, int64_t n, int n_cent, int cs,
                    const uint32_t* slots, int* order) {
  extern __shared__ __align__(16) uint32_t wcnt[];  // (kSortWarps, n_cent)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < kSortWarps * n_cent; i += kSortThreads) wcnt[i] = 0;
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t t0 = tile * kSortTile + warp * kWarpRows;
  int a[kPerThread];
  uint32_t rank[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    a[j] = row_cluster(assign, t0 + j * 32 + lane, n, n_cent);
  const unsigned below = (1u << lane) - 1u;
  uint32_t* mine = wcnt + warp * n_cent;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned peers = __match_any_sync(c2v::kFullMask, a[j]);
    rank[j] = a[j] >= 0 ? mine[a[j]] + __popc(peers & below) : 0;
    __syncwarp();
    if (a[j] >= 0 && (peers & below) == 0) mine[a[j]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int b = tid; b < n_cent; b += kSortThreads) {
    uint32_t r = slots[tile * cs + b];
    for (int w = 0; w < kSortWarps; ++w) {
      const uint32_t c = wcnt[w * n_cent + b];
      wcnt[w * n_cent + b] = r;
      r += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (a[j] >= 0)
      order[mine[a[j]] + rank[j]] = static_cast<int>(t0 + j * 32 + lane);
}

// The counting sort for n_cent > kMaxBins: tile_pos[t][c] += rows of
// 1,024-row tile t assigned to c (tile_pos zeroed).
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
                                 uint32_t* counts) {
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
offsets_scan_kernel(const uint32_t* counts, int n_cent, int* offsets) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < n_cent; base += 1024) {
    const int c = base + tid;
    const int v = c < n_cent ? static_cast<int>(counts[c]) : 0;
    const int incl = static_cast<int>(warp_incl_scan(v, lane));
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0)
      warp_sums[lane] =
          static_cast<int>(warp_incl_scan(warp_sums[lane], lane));
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

// The mean of a cluster's summed float4 column `s` (this thread's; `live`
// where the thread has one) over `cnt` rows, renormalised where
// `spherical` (the 1e-12 guard) over the `warps` warps whose threads hold
// the row's columns in order, their partial squares in `red`; every
// thread of those warps calls it. `bar`: a barrier over exactly those
// warps.
template <typename Bar>
__device__ __forceinline__ float4 cluster_mean(float4 s, bool live, int cnt,
                                               int spherical, float* red,
                                               int warps, Bar bar) {
  const float den = fmaxf(static_cast<float>(cnt), 1.f);
  float4 m = make_float4(s.x / den, s.y / den, s.z / den, s.w / den);
  if (!spherical) return m;
  float sq = live ? m.x * m.x + m.y * m.y + m.z * m.z + m.w * m.w : 0.f;
  sq = c2v::warp_sum(sq);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
  bar();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t += red[w];
  bar();  // red is read before it is written again
  const float nrm = fmaxf(sqrtf(t), 1e-12f);
  return make_float4(m.x / nrm, m.y / nrm, m.z / nrm, m.w / nrm);
}

// The first cluster c with offsets[c + 1] > r (offsets nondecreasing).
__device__ __forceinline__ int cluster_of(const int* offsets, int n_cent,
                                          int r) {
  int lo = 0, hi = n_cent - 1;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (offsets[mid + 1] > r)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

struct SumArgs {
  const float* x;
  int d, n_cent, spherical;
  const int* order;    // the row ids in stable cluster order
  const int* offsets;  // (n_cent + 1,) each cluster's first sorted row
  float* head;         // (grid, d) a range's first cluster's segment sum
  float* tail;         // (grid, d) its last cluster's, where another
  int* tail_of;        // (grid,) the cluster of a range's tail, or -1
  float* new_c;
};

// (4) the sums, a CTA a few per SM, each over its own contiguous range of
// ceil(rows / grid) sorted rows: the producer warp (the last) walks the
// range cluster by cluster and copies rows whole (bulk copies) into a
// ring of kStages stages, a stage at most kStageRows rows of one cluster;
// each consumer thread sums one float4 column over a cluster's rows in
// sorted (row) order. A cluster that lies in the range gets its mean
// here; one that crosses the range's start or end leaves its segment's
// sum in `head` (the range's first cluster) or `tail` (its last) for (5).
__global__ void __launch_bounds__(32 * (kMaxConsumerWarps + 1))
range_sum_kernel(SumArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ int meta[kStages][4];  // cluster (-1: no more), rows, flags, cnt
  __shared__ float red[kMaxConsumerWarps];
  const float4* ring4 = reinterpret_cast<const float4*>(ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cw = blockDim.x / 32 - 1;  // consumer warps
  const int d = a.d, d4 = d / 4;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == cw) {  // producer
    const int nv = a.offsets[a.n_cent];
    const int per = (nv + gridDim.x - 1) / gridDim.x;
    const int r0 = min(nv, static_cast<int>(blockIdx.x) * per);
    const int r1 = min(nv, r0 + per);
    const uint32_t row_bytes = static_cast<uint32_t>(d) * 4u;
    int seq = 0;
    int c = r0 < r1 ? cluster_of(a.offsets, a.n_cent, r0) : 0;
    int c_lo = a.offsets[c], c_hi = a.offsets[c + 1];
    int w0 = r0, ids = r0 < r1 ? a.order[r0 + min(lane, r1 - r0 - 1)] : 0;
    for (int r = r0; r < r1;) {
      while (c_hi <= r) {  // the next cluster with rows
        ++c;
        c_lo = c_hi;
        c_hi = a.offsets[c + 1];
      }
      const int end = min(c_hi, r1);
      const int nr = min(kStageRows, end - r);
      if (r + nr > w0 + 32) {  // the next 32 row ids, one a lane
        w0 = r;
        ids = a.order[r + min(lane, r1 - r - 1)];
      }
      const int id = __shfl_sync(c2v::kFullMask, ids, (r - w0 + lane) & 31);
      const int slot = seq % kStages;
      if (seq >= kStages) mbar_wait(&empty[slot], ((seq / kStages) - 1) & 1);
      if (lane == 0) {
        meta[slot][0] = c;
        meta[slot][1] = nr;
        meta[slot][2] = (r == max(c_lo, r0) ? kFirst : 0) |
                        (r + nr == end ? kLast : 0) |
                        (c_lo >= r0 && c_hi <= r1 ? kWhole : 0) |
                        (c_lo < r0 ? kHead : 0);
        meta[slot][3] = c_hi - c_lo;
        mbar_arrive_tx(&full[slot], nr * row_bytes);
      }
      __syncwarp();
      if (lane < nr)
        bulk_load(ring + (slot * kStageRows + lane) * row_bytes,
                  a.x + static_cast<int64_t>(id) * d, row_bytes, &full[slot]);
      r += nr;
      ++seq;
    }
    if (lane == 0)
      a.tail_of[blockIdx.x] = r0 < r1 && c_lo >= r0 && c_hi > r1 ? c : -1;
    const int slot = seq % kStages;
    if (seq >= kStages) mbar_wait(&empty[slot], ((seq / kStages) - 1) & 1);
    if (lane == 0) {
      meta[slot][0] = -1;
      mbar_arrive(&full[slot]);
    }
    return;
  }
  const bool live = tid < d4;
  const int nthreads = 32 * cw;
  auto bar = [nthreads]() {
    asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
  };
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int seq = 0;; ++seq) {
    const int slot = seq % kStages;
    mbar_wait(&full[slot], (seq / kStages) & 1);
    const int c = meta[slot][0];
    if (c < 0) break;
    const int nr = meta[slot][1], flags = meta[slot][2], cnt = meta[slot][3];
    if (flags & kFirst) acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      for (int r = 0; r < nr; ++r) {  // in row order
        const float4 v = ring4[(slot * kStageRows + r) * d4 + tid];
        acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
      }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (!(flags & kLast)) continue;
    if (flags & kWhole) {
      const float4 m =
          cluster_mean(acc, live, cnt, a.spherical, red, cw, bar);
      if (live)
        reinterpret_cast<float4*>(a.new_c + static_cast<int64_t>(c) * d)[tid] =
            m;
    } else if (live) {
      float* seg = (flags & kHead) ? a.head : a.tail;
      reinterpret_cast<float4*>(seg + static_cast<int64_t>(blockIdx.x) *
                                          d)[tid] = acc;
    }
  }
}

// (5) a CTA per range of (4): its share of the empty clusters keep their
// old centroids; the cluster that starts in the range and runs past it
// (its tail), if any, adds its segments' sums in range order (G groups
// of d4p threads each add a contiguous run of them, then the runs in
// group order), then the mean and the spherical renormalisation.
__global__ void __launch_bounds__(1024)
combine_kernel(const float* head, const float* tail, const int* tail_of,
               const int* offsets, int n_cent, const float* old_c, int d,
               int spherical, float* new_c) {
  extern __shared__ __align__(16) float4 part[];  // [groups][d4p]
  __shared__ float red[32];
  const int d4 = d / 4, d4p = (d4 + 31) / 32 * 32;
  const int groups = blockDim.x / d4p;
  const int tid = threadIdx.x, g = tid / d4p, col = tid - g * d4p;
  for (int e = blockIdx.x; e < n_cent; e += gridDim.x)
    if (offsets[e] == offsets[e + 1] && g == 0 && col < d4)
      reinterpret_cast<float4*>(new_c + static_cast<int64_t>(e) * d)[col] =
          reinterpret_cast<const float4*>(
              old_c + static_cast<int64_t>(e) * d)[col];
  const int c = tail_of[blockIdx.x];
  if (c < 0) return;
  const int lo = offsets[c], hi = offsets[c + 1];
  const int per = (offsets[n_cent] + gridDim.x - 1) / gridDim.x;
  const int i0 = lo / per, i1 = (hi - 1) / per;
  // segment j: range i0 + j's, the range's tail for j = 0 (where the
  // cluster starts) and its head after that
  const int m = i1 - i0 + 1;
  const int s0 = static_cast<int>(static_cast<int64_t>(m) * g / groups);
  const int s1 = static_cast<int>(static_cast<int64_t>(m) * (g + 1) / groups);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < d4) {
#pragma unroll 4
    for (int j = s0; j < s1; ++j) {
      const float* seg = j == 0 ? tail : head;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                  seg + static_cast<int64_t>(i0 + j) * d) +
                              col);
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
  }
  part[g * d4p + col] = acc;
  __syncthreads();
  if (g != 0) return;
  float4 s = part[col];
  for (int h = 1; h < groups; ++h) {
    const float4 p = part[h * d4p + col];
    s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
  }
  const int nthreads = d4p;
  auto bar = [nthreads]() {
    asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
  };
  const float4 mean =
      cluster_mean(s, col < d4, hi - lo, spherical, red, d4p / 32, bar);
  if (col < d4)
    reinterpret_cast<float4*>(new_c + static_cast<int64_t>(c) * d)[col] =
        mean;
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

// The sum launch's shape for width d: consumer warps, threads and ring
// bytes.
struct SumShape {
  int cw, threads, ring;
};

SumShape sum_shape(int d) {
  SumShape sh;
  sh.cw = (d / 4 + 31) / 32;
  sh.threads = 32 * (sh.cw + 1);
  sh.ring = kStages * kStageRows * d * 4;
  return sh;
}

cudaError_t allow_ring(const SumShape& sh) {
  return cudaFuncSetAttribute(range_sum_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              sh.ring);
}

// The scratch of c2v_kmeans_update, in 16-byte-aligned parts.
struct UpdateLayout {
  int64_t zeroed, totals, tile_hist, offsets, order, head, tail, tail_of,
      bytes;
  int64_t tiles;
  int cs;
  bool one_pass;
};

UpdateLayout update_layout(int64_t n, int d, int n_cent, int grid) {
  UpdateLayout l;
  l.one_pass = n_cent <= kMaxBins;
  l.tiles = l.one_pass ? (n + kSortTile - 1) / kSortTile
                       : (n + kTileRows - 1) / kTileRows;
  l.cs = l.one_pass ? (n_cent + 7) / 8 * 8 : n_cent;
  int64_t at = 0;
  auto part = [&](int64_t bytes) {
    const int64_t p = at;
    at += align16(bytes);
    return p;
  };
  // zeroed each call: the totals, and the counting sort's tile counts
  // where n_cent > kMaxBins
  l.totals = part(4 * int64_t{n_cent});
  l.tile_hist = part(4 * l.tiles * l.cs);
  l.zeroed = l.one_pass ? l.tile_hist : at;
  l.offsets = part(4 * (int64_t{n_cent} + 1));
  l.order = part(4 * n);
  l.head = part(4 * int64_t{grid} * d);
  l.tail = part(4 * int64_t{grid} * d);
  l.tail_of = part(4 * int64_t{grid});
  l.bytes = at;
  return l;
}

}  // namespace

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

// CTAs of K10's sum launch for width d on a card of `sms` SMs, every SM
// filled to its occupancy (each takes an equal range of the sorted rows;
// the order of a cluster's sums follows them); -1 on an error.
C2V_EXPORT int c2v_kmeans_update_grid(int d, int sms) {
  const SumShape sh = sum_shape(d);
  int per_sm = 0;
  if (d <= 0 || sms <= 0 || allow_ring(sh) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, range_sum_kernel, sh.threads, sh.ring) != cudaSuccess)
    return -1;
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Bytes of scratch c2v_kmeans_update takes (16-byte aligned) with `grid`
// sum CTAs (c2v_kmeans_update_grid).
C2V_EXPORT int64_t c2v_kmeans_update_scratch_bytes(int64_t n, int d,
                                                   int n_cent, int grid) {
  return update_layout(n, d, n_cent, grid).bytes;
}

// x f32 (n, d), 16-byte aligned, d % 4 == 0, d <= 1024; assign int32 (n,)
// in [0, n_cent) (others are dropped); old_c f32 (n_cent, d). grid: the
// sum CTAs, c2v_kmeans_update_grid(d, sms) (the caller keeps it a card).
// scratch: c2v_kmeans_update_scratch_bytes(n, d, n_cent, grid), 16-byte
// aligned. Writes new_c f32 (n_cent, d).
C2V_EXPORT int c2v_kmeans_update(const float* x, int64_t n, int d,
                                 const int* assign, const float* old_c,
                                 int n_cent, int spherical, int grid,
                                 void* scratch, float* new_c, void* stream) {
  if (n <= 0 || n >= (int64_t{1} << 31) || d <= 0 || d % 4 != 0 ||
      d / 4 > 32 * kMaxConsumerWarps || n_cent <= 0 || grid <= 0 ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SumShape sh = sum_shape(d);
  cudaError_t err = allow_ring(sh);
  if (err != cudaSuccess) return err;
  const UpdateLayout l = update_layout(n, d, n_cent, grid);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  auto i32 = [&](int64_t off) { return reinterpret_cast<int*>(base + off); };
  auto u32 = [&](int64_t off) {
    return reinterpret_cast<uint32_t*>(base + off);
  };
  auto f32 = [&](int64_t off) {
    return reinterpret_cast<float*>(base + off);
  };
  if ((err = cudaMemsetAsync(base, 0, l.zeroed, s)) != cudaSuccess)
    return err;
  const unsigned tiles = static_cast<unsigned>(l.tiles);
  if (l.one_pass) {
    sort_hist_kernel<<<tiles, kSortThreads, 0, s>>>(
        assign, n, n_cent, l.cs, u32(l.tile_hist), u32(l.totals));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    sort_scan_kernel<<<(n_cent + kScanDigits - 1) / kScanDigits,
                       kSortThreads, 0, s>>>(u32(l.tile_hist), u32(l.totals),
                                             l.tiles, n_cent, l.cs,
                                             i32(l.offsets));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const int smem = 4 * kSortWarps * n_cent;
    err = cudaFuncSetAttribute(sort_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    sort_scatter_kernel<<<tiles, kSortThreads, smem, s>>>(
        assign, n, n_cent, l.cs, u32(l.tile_hist), i32(l.order));
  } else {
    tile_hist_kernel<<<tiles, 256, 0, s>>>(assign, n, n_cent,
                                           i32(l.tile_hist));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    tile_scan_kernel<<<(n_cent + 255) / 256, 256, 0, s>>>(
        i32(l.tile_hist), l.tiles, n_cent, u32(l.totals));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    offsets_scan_kernel<<<1, 1024, 0, s>>>(u32(l.totals), n_cent,
                                           i32(l.offsets));
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    scatter_rows_kernel<<<tiles, 32, 0, s>>>(assign, n, n_cent,
                                             i32(l.offsets), i32(l.tile_hist),
                                             i32(l.order));
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  SumArgs args{x,           d,           n_cent,      spherical,
               i32(l.order), i32(l.offsets), f32(l.head), f32(l.tail),
               i32(l.tail_of), new_c};
  range_sum_kernel<<<grid, sh.threads, sh.ring, s>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int d4p = (d / 4 + 31) / 32 * 32;
  const int groups = kCombineGroups * d4p <= 1024 ? kCombineGroups
                                                  : 1024 / d4p;
  combine_kernel<<<grid, groups * d4p, sizeof(float4) * groups * d4p,
                   s>>>(f32(l.head), f32(l.tail), i32(l.tail_of),
                        i32(l.offsets), n_cent, old_c, d, spherical, new_c);
  return cudaGetLastError();
}
