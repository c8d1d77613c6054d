// K12 sparse_adam: duplicate combining and touched-rows (lazy) Adam for
// one embedding table, in place.
//
// Replaces code2vec_tpu/training/sparse_adam.py `combine_duplicate_rows`
// (:64-83) and `sparse_adam_rows` (:86-130), which the sparse train step
// (code2vec_tpu/training/step.py:198-269) runs on the token table (ids =
// the source then the target ids of the batch) and on the path table.
// Given n ids and n gradient rows (bf16, as K5's row mode writes them:
// f32(bf16 dctx) is the reference's row gradient, so no value changes),
// for every id u in [0, V) that occurs:
//   g      = the sum of u's rows, in f32, in position order
//   mu'    = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g g
//   delta  = (-lr (mu' / (1 - b1^t))) / (sqrt(nu' / (1 - b2^t)) + eps)
//   table += delta;  nu += (nu' - nu);
//   mu    += bf16(bf16(mu') - mu) for a bf16 mu (mu += (mu' - mu) in f32)
// with each operation rounded once, in that order (no FMA contraction):
// the plain version's and the reference's rounding points. Rows never
// named keep every bit; ids outside [0, V) are dropped.
//
// What bounds it on an H100: bytes. Each gradient row is read once
// (256 B at d 128 in bf16) and each touched table row read and written
// with its moments (f32 table, bf16 or f32 mu, f32 nu: 2,560 B at d 128
// with a bf16 mu); the least time counts that and nothing for untouched
// rows.
// Design, deterministic (two runs give the same bits):
//   (1) a stable LSD radix sort of the (id, position) pairs by id, 8-bit
//       digits (three passes for a 1.3M-row table): per pass, a 256-bin
//       histogram per tile of 512 pairs, a scan of each digit's counts
//       over the tiles (one block per digit), and one warp per tile that
//       scans the digit totals and places its pairs in position order
//       with __match_any_sync (the stable counting sort of K10,
//       csrc/kmeans.cu, with 256 keys);
//   (2) one warp per 64 sorted pairs: it walks them in order, adding each
//       row (8-byte loads, eight rows in flight) into f32 registers, and
//       applies the update to every segment of equal ids that starts and
//       ends inside its 64; a segment crossing a boundary leaves its
//       partial sums in scratch;
//   (3) one warp per 64 whose last segment runs on: it adds the following
//       partials in order (eight loaded at a time) and applies the update.
// A duplicate-heavy id (Zipf's head: tens of thousands of positions)
// is thus summed by many warps in parallel, in a fixed order. The sums
// differ from the plain version's position-order sum only for segments
// that cross a boundary, by the f32 order of the additions.
#include "common.cuh"

namespace {

constexpr int kTile = 512;       // pairs per radix tile
constexpr int kChunk = 64;       // sorted pairs per warp in (2)
constexpr int kMaxGroups = 4;    // d <= 4 * 128

// Rows in flight per warp in (2): eight rows of 128 columns, fewer of
// wider ones (registers).
template <int G>
struct BatchRows {
  static constexpr int value = G == 1 ? 8 : (G == 2 ? 4 : 2);
};

struct Scalars {
  float b1, b2, omb1, omb2, b1c, b2c, eps, neg_lr;
};

__device__ __forceinline__ int sort_key(const int* ids, int64_t i, int v) {
  const int id = ids[i];
  return (id >= 0 && id < v) ? id : v;  // out of range: sorts last
}

// (1a) per-tile digit histogram
__global__ void __launch_bounds__(256)
radix_hist_kernel(const int* ids, const int* keys_in, int64_t n, int v,
                  int shift, int* tile_hist) {
  __shared__ int hist[256];
  const int tid = threadIdx.x;
  hist[tid] = 0;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int j = tid; j < kTile; j += 256) {
    const int64_t i = t0 + j;
    if (i >= n) break;
    const int key = keys_in != nullptr ? keys_in[i] : sort_key(ids, i, v);
    atomicAdd(&hist[(key >> shift) & 255], 1);
  }
  __syncthreads();
  tile_hist[static_cast<int64_t>(blockIdx.x) * 256 + tid] = hist[tid];
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(c2v::kFullMask, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// (1b) one block per digit d: tile_hist[t][d] becomes the count of
// digit d in the tiles before t, and totals[d] the count in all of them.
// Each of the 256 threads scans a contiguous run of tiles.
__global__ void __launch_bounds__(256)
radix_scan_kernel(int* tile_hist, int n_tiles, int* totals) {
  __shared__ int warp_sums[8];
  const int d = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int per = (n_tiles + 255) / 256;
  const int t0 = tid * per, t1 = min(t0 + per, n_tiles);
  int sum = 0;
  for (int t = t0; t < t1; ++t) sum += tile_hist[t * 256 + d];
  const int incl = warp_incl_scan(sum, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int t = t0; t < t1; ++t) {
    const int c = tile_hist[t * 256 + d];
    tile_hist[t * 256 + d] = run;
    run += c;
  }
  if (tid == 255) totals[d] = run;
}

// (1c) one warp per tile places its pairs, in position order, from
// digit d's first slot: the totals of the digits below d, plus digit d's
// pairs in the tiles before this one.
__global__ void __launch_bounds__(32)
radix_place_kernel(const int* ids, const int* keys_in, const int* vals_in,
                   int64_t n, int v, int shift, const int* tile_off,
                   const int* totals, int* keys_out, int* vals_out) {
  __shared__ int cursor[256];
  const int lane = threadIdx.x;
  const int64_t tile = blockIdx.x;
  int c8[8], sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c8[j] = totals[lane * 8 + j];
    sum += c8[j];
  }
  int run = warp_incl_scan(sum, lane) - sum;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = lane * 8 + j;
    cursor[d] = run + tile_off[tile * 256 + d];
    run += c8[j];
  }
  __syncwarp();
  const unsigned lt = (1u << lane) - 1u;
  for (int c = 0; c < kTile; c += 32) {
    const int64_t i = tile * kTile + c + lane;
    const bool ok = i < n;
    int key = 0, val = 0, digit = 256 + lane;  // a lane past n: alone
    if (ok) {
      key = keys_in != nullptr ? keys_in[i] : sort_key(ids, i, v);
      val = vals_in != nullptr ? vals_in[i] : static_cast<int>(i);
      digit = (key >> shift) & 255;
    }
    const unsigned peers = __match_any_sync(c2v::kFullMask, digit);
    if (ok) {
      const int slot = cursor[digit] + __popc(peers & lt);
      keys_out[slot] = key;
      vals_out[slot] = val;
    }
    __syncwarp();
    if (ok && (peers & lt) == 0) cursor[digit] += __popc(peers);
    __syncwarp();
    if (tile * kTile + c + 32 >= n) break;
  }
}

// Lane's columns of one row: G groups of 4 columns at lane * 4 + 128 g.
template <int G>
__device__ __forceinline__ void load_row(const __nv_bfloat16* rows,
                                         int64_t pos, int lane,
                                         float (&acc)[G][4]) {
  const __nv_bfloat16* r = rows + pos * (128 * G) + lane * 4;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint2 u = *reinterpret_cast<const uint2*>(r + 128 * g);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    acc[g][0] = a.x, acc[g][1] = a.y, acc[g][2] = b.x, acc[g][3] = b.y;
  }
}

__device__ __forceinline__ float update_one(float& p, float m, float& nu,
                                            float g, const Scalars& s) {
  const float new_mu = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  const float new_nu =
      __fadd_rn(__fmul_rn(s.b2, nu), __fmul_rn(s.omb2, __fmul_rn(g, g)));
  const float mu_hat = __fdiv_rn(new_mu, s.b1c);
  const float nu_hat = __fdiv_rn(new_nu, s.b2c);
  const float delta = __fdiv_rn(__fmul_rn(s.neg_lr, mu_hat),
                                __fadd_rn(__fsqrt_rn(nu_hat), s.eps));
  p = __fadd_rn(p, delta);
  nu = __fadd_rn(nu, __fsub_rn(new_nu, nu));
  return new_mu;
}

// The update of row `id` with its summed gradient, by one warp.
template <int G>
__device__ __forceinline__ void update_row(float* table, void* mu,
                                           int mu_bf16, float* nu, int64_t id,
                                           int lane, const float (&acc)[G][4],
                                           const Scalars& s) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int64_t o = id * (128 * G) + lane * 4 + 128 * g;
    float4 p = *reinterpret_cast<float4*>(table + o);
    float4 v = *reinterpret_cast<float4*>(nu + o);
    float m[4];
    if (mu_bf16) {
      const uint2 u = *reinterpret_cast<const uint2*>(
          static_cast<__nv_bfloat16*>(mu) + o);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u.y));
      m[0] = a.x, m[1] = a.y, m[2] = b.x, m[3] = b.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<float*>(mu) + o);
      m[0] = f.x, m[1] = f.y, m[2] = f.z, m[3] = f.w;
    }
    float pv[4] = {p.x, p.y, p.z, p.w}, vv[4] = {v.x, v.y, v.z, v.w};
    float out_m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float new_mu = update_one(pv[q], m[q], vv[q], acc[g][q], s);
      out_m[q] = mu_bf16
          ? __fadd_rn(m[q], c2v::bf16_round(
                                __fsub_rn(c2v::bf16_round(new_mu), m[q])))
          : __fadd_rn(m[q], __fsub_rn(new_mu, m[q]));
    }
    *reinterpret_cast<float4*>(table + o) =
        make_float4(pv[0], pv[1], pv[2], pv[3]);
    *reinterpret_cast<float4*>(nu + o) =
        make_float4(vv[0], vv[1], vv[2], vv[3]);
    if (mu_bf16) {
      __align__(8) __nv_bfloat162 h[2] = {
          __floats2bfloat162_rn(out_m[0], out_m[1]),
          __floats2bfloat162_rn(out_m[2], out_m[3])};
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(mu) + o) =
          *reinterpret_cast<const uint2*>(h);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(mu) + o) =
          make_float4(out_m[0], out_m[1], out_m[2], out_m[3]);
    }
  }
}

template <int G>
__device__ __forceinline__ void store_acc(float* dst, int lane,
                                          const float (&acc)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
    *reinterpret_cast<float4*>(dst + lane * 4 + 128 * g) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
}

constexpr int kHasHead = 1, kHeadThrough = 2, kHasTail = 4;

// (2) one warp per kChunk sorted pairs
template <int G>
__global__ void __launch_bounds__(128)
segment_kernel(const int* keys, const int* vals, int64_t n, int v,
               const __nv_bfloat16* rows, float* table, void* mu,
               int mu_bf16, float* nu, Scalars s, float* part_head,
               float* part_tail, int* flags) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int64_t c0 = chunk * kChunk;
  if (c0 >= n) return;
  const int64_t c1 = c0 + kChunk < n ? c0 + kChunk : n;
  constexpr int d = 128 * G;
  constexpr int kBatch = BatchRows<G>::value;
  // the chunk's keys and positions in registers (lane, lane + 32), the
  // keys on either side of it
  int key_r[2], val_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t i = c0 + lane + 32 * h;
    key_r[h] = i < c1 ? keys[i] : v;
    val_r[h] = i < c1 ? vals[i] : 0;
  }
  const int key_before = c0 > 0 ? keys[c0 - 1] : -1;
  const int key_after = c1 < n ? keys[c1] : v;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
  int flag = 0;
  bool part_from_start = true;  // the current part began at c0
  const int len = static_cast<int>(c1 - c0);
  for (int jb = 0; jb < len; jb += kBatch) {
    float rb[kBatch][G][4];
    int kb[kBatch + 1];
#pragma unroll
    for (int u = 0; u <= kBatch; ++u) {
      const int j = jb + u;
      const int src = j & 31, h = j >> 5;
      const int k0 = __shfl_sync(c2v::kFullMask, key_r[0], src);
      const int k1 = __shfl_sync(c2v::kFullMask, key_r[1], src);
      kb[u] = j < len ? (h == 0 ? k0 : k1) : key_after;
    }
    // every row of the batch loaded before any is added
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u;
      const int src = j & 31, h = j >> 5;
      const int p0 = __shfl_sync(c2v::kFullMask, val_r[0], src);
      const int p1 = __shfl_sync(c2v::kFullMask, val_r[1], src);
      const int pos = h == 0 ? p0 : p1;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) rb[u][g][q] = 0.f;
      if (j < len && kb[u] < v) load_row<G>(rows, pos, lane, rb[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = jb + u;
      const int id = kb[u];
      if (j >= len || id >= v) break;  // sentinel ids sort last
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[g][q] = __fadd_rn(acc[g][q], rb[u][g][q]);
      if (j + 1 < len && kb[u + 1] == id) continue;  // goes on here
      const bool from_before = part_from_start && key_before == id;
      const bool to_after = j == len - 1 && key_after == id;
      if (!from_before && !to_after) {
        update_row<G>(table, mu, mu_bf16, nu, id, lane, acc, s);
      } else if (from_before) {
        store_acc<G>(part_head + chunk * d, lane, acc);
        flag |= kHasHead | (to_after ? kHeadThrough : 0);
      } else {
        store_acc<G>(part_tail + chunk * d, lane, acc);
        flag |= kHasTail;
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
      part_from_start = false;
    }
  }
  if (lane == 0) flags[chunk] = flag;
}

// (3) one warp per chunk whose last segment runs past it
template <int G>
__global__ void __launch_bounds__(128)
combine_kernel(const int* keys, int64_t n, float* table, void* mu,
               int mu_bf16, float* nu, Scalars s, const float* part_head,
               const float* part_tail, const int* flags, int64_t n_chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (chunk >= n_chunks || !(flags[chunk] & kHasTail)) return;
  constexpr int d = 128 * G;
  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float4 f = *reinterpret_cast<const float4*>(
        part_tail + chunk * d + lane * 4 + 128 * g);
    acc[g][0] = f.x, acc[g][1] = f.y, acc[g][2] = f.z, acc[g][3] = f.w;
  }
  const int64_t last = (chunk + 1) * kChunk - 1;
  const int id = keys[last < n ? last : n - 1];
  // the following chunks' head partials, in order, until one ends the
  // segment; kAhead of them loaded at a time (a Zipf head id spans
  // hundreds of chunks)
  constexpr int kAhead = 8;
  bool more = true;
  for (int64_t c0 = chunk + 1; more && c0 < n_chunks; c0 += kAhead) {
    int f[kAhead];
    float4 h[kAhead][G];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t c = c0 + u < n_chunks ? c0 + u : n_chunks - 1;
      f[u] = flags[c];
#pragma unroll
      for (int g = 0; g < G; ++g)
        h[u][g] = *reinterpret_cast<const float4*>(
            part_head + c * d + lane * 4 + 128 * g);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (!more || c0 + u >= n_chunks) break;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] = __fadd_rn(acc[g][0], h[u][g].x);
        acc[g][1] = __fadd_rn(acc[g][1], h[u][g].y);
        acc[g][2] = __fadd_rn(acc[g][2], h[u][g].z);
        acc[g][3] = __fadd_rn(acc[g][3], h[u][g].w);
      }
      more = (f[u] & kHeadThrough) != 0;
    }
  }
  update_row<G>(table, mu, mu_bf16, nu, id, lane, acc, s);
}

template <int G>
cudaError_t launch_rows(const int* keys, const int* vals, int64_t n, int v,
                        const void* rows, float* table, void* mu,
                        int mu_bf16, float* nu, const Scalars& s,
                        float* head, float* tail, int* flags,
                        cudaStream_t st) {
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  const unsigned blocks = static_cast<unsigned>((n_chunks + 3) / 4);
  segment_kernel<G><<<blocks, 128, 0, st>>>(
      keys, vals, n, v, static_cast<const __nv_bfloat16*>(rows), table, mu,
      mu_bf16, nu, s, head, tail, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<G><<<blocks, 128, 0, st>>>(keys, n, table, mu, mu_bf16, nu,
                                            s, head, tail, flags, n_chunks);
  return cudaGetLastError();
}

struct Scratch {
  int64_t keys[2], vals[2], hist, head, tail, flags, total;
};

__host__ inline int64_t align256(int64_t x) { return (x + 255) / 256 * 256; }

__host__ inline Scratch scratch_layout(int64_t n, int d) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  Scratch s;
  int64_t o = 0;
  for (int b = 0; b < 2; ++b) {
    s.keys[b] = o;
    o = align256(o + 4 * n);
    s.vals[b] = o;
    o = align256(o + 4 * n);
  }
  s.hist = o;
  o = align256(o + 4 * 256 * (n_tiles + 1));  // + the digit totals
  s.head = o;
  o = align256(o + 4 * n_chunks * d);
  s.tail = o;
  o = align256(o + 4 * n_chunks * d);
  s.flags = o;
  o = align256(o + 4 * n_chunks);
  s.total = o;
  return s;
}

}  // namespace

C2V_EXPORT int64_t c2v_sparse_adam_scratch_bytes(int64_t n, int d) {
  return scratch_layout(n, d).total;
}

// table f32 (v, d), mu (v, d) bf16 (mu_bf16 1) or f32, nu f32 (v, d), all
// updated in place; ids int32 (n,), rows bf16 (n, d); d % 128 == 0 and
// d <= 512. Scalars: b1, b2, 1 - b1, 1 - b2, the bias corrections 1 - b^t,
// eps and -lr, as f32. scratch: c2v_sparse_adam_scratch_bytes(n, d)
// bytes, 256-byte aligned. Returns a cudaError_t.
C2V_EXPORT int c2v_sparse_adam(float* table, void* mu, int mu_bf16,
                               float* nu, int v, int d, const int* ids,
                               const void* rows, int64_t n, float b1,
                               float b2, float omb1, float omb2, float b1c,
                               float b2c, float eps, float neg_lr,
                               void* scratch, void* stream) {
  if (v <= 0 || d <= 0 || d % 128 != 0 || d > 128 * kMaxGroups || n < 0 ||
      n >= 0x7fffffff || v >= 0x7fffffff)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch L = scratch_layout(n, d);
  char* base = static_cast<char*>(scratch);
  int* keys[2] = {reinterpret_cast<int*>(base + L.keys[0]),
                  reinterpret_cast<int*>(base + L.keys[1])};
  int* vals[2] = {reinterpret_cast<int*>(base + L.vals[0]),
                  reinterpret_cast<int*>(base + L.vals[1])};
  int* hist = reinterpret_cast<int*>(base + L.hist);
  int* totals = hist + 256 * ((n + kTile - 1) / kTile);
  float* head = reinterpret_cast<float*>(base + L.head);
  float* tail = reinterpret_cast<float*>(base + L.tail);
  int* flags = reinterpret_cast<int*>(base + L.flags);
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  int bits = 0;
  while ((int64_t(1) << bits) <= v) ++bits;  // keys lie in [0, v]
  const int passes = (bits + 7) / 8;
  const int* k_in = nullptr;
  const int* v_in = nullptr;
  int cur = 0;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    radix_hist_kernel<<<n_tiles, 256, 0, st>>>(ids, k_in, n, v, shift, hist);
    radix_scan_kernel<<<256, 256, 0, st>>>(hist, n_tiles, totals);
    radix_place_kernel<<<n_tiles, 32, 0, st>>>(ids, k_in, v_in, n, v, shift,
                                               hist, totals, keys[cur],
                                               vals[cur]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k_in = keys[cur];
    v_in = vals[cur];
    cur ^= 1;
  }
  const Scalars s{b1, b2, omb1, omb2, b1c, b2c, eps, neg_lr};
  switch (d / 128) {
    case 1:
      return launch_rows<1>(k_in, v_in, n, v, rows, table, mu, mu_bf16, nu,
                            s, head, tail, flags, st);
    case 2:
      return launch_rows<2>(k_in, v_in, n, v, rows, table, mu, mu_bf16, nu,
                            s, head, tail, flags, st);
    case 3:
      return launch_rows<3>(k_in, v_in, n, v, rows, table, mu, mu_bf16, nu,
                            s, head, tail, flags, st);
    default:
      return launch_rows<4>(k_in, v_in, n, v, rows, table, mu, mu_bf16, nu,
                            s, head, tail, flags, st);
  }
}
