// K12 sparse_adam: duplicate combining and touched-rows (lazy) Adam for
// one or two embedding tables of one width, in place, in one launch
// sequence.
//
// Replaces code2vec_tpu/training/sparse_adam.py `combine_duplicate_rows`
// (:64-83) and `sparse_adam_rows` (:86-130), which the sparse train step
// (code2vec_tpu/training/step.py:198-269) runs on the token table (ids =
// the source then the target ids of the batch) and on the path table.
// Given, per table, n ids and n gradient rows (bf16, as K5's row mode
// writes them: f32(bf16 dctx) is the reference's row gradient, so no value
// changes), for every id u in [0, V) that occurs:
//   g      = the sum of u's rows, in f32, in position order
//   mu'    = b1 mu + (1 - b1) g;  nu' = b2 nu + (1 - b2) g g
//   delta  = (-lr (mu' / (1 - b1^t))) / (sqrt(nu' / (1 - b2^t)) + eps)
//   table += delta;  nu += (nu' - nu);
//   mu    += bf16(bf16(mu') - mu) for a bf16 mu (mu += (mu' - mu) in f32)
// with each operation rounded once, in that order (no FMA contraction):
// the plain version's and the reference's rounding points. Rows never
// named keep every bit; ids outside [0, V) are dropped. A sum split across
// work units (an id with rows in three or more 32-pair chunks) may differ
// from the position-order sum by the f32 order of its additions; two runs
// give the same bits.
//
// What bounds it on an H100: bytes. Each id and gradient row is read once
// (256 B at d 128 in bf16) and each touched table row read and written
// with its moments (f32 table, bf16 or f32 mu, f32 nu: 2,560 B at d 128
// with a bf16 mu), nothing for untouched rows. The rows lie at random
// places: those bytes alone take ~0.55 ms for both flagship tables with
// uniform ids on the card (the row read-modify-write probe,
// csrc/gather_probe.cu; PERF.md), not the 0.46 ms the memory rate gives.
// Design, eight launches for two digit passes (chained by programmatic
// dependent launch they measured slower), none waiting on another CTA:
//   (1) zero the digit counts and counters;
//   (2) one read of the ids, a CTA per tile of 2,048 positions: the
//       tile's first-pass digit counts, and every pass's counts over all
//       keys (keys are the table's key offset plus the id; out-of-range
//       ids take the last key, one past every table, and sort last);
//   per digit pass of a stable LSD radix sort (two of 11 bits for up to
//   4M keys, as both flagship tables make), two launches:
//   (3) a CTA per 8 digits: each (tile, digit)'s first slot, the lower
//       digits' count plus the digit's count in the earlier tiles;
//   (4) a CTA per tile ranks its pairs by digit, stably, in shared
//       memory (a warp per 256 in position order, __match_any_sync) and
//       scatters them from those slots, counting for the next pass's
//       tiles where each lands;
//   (5) the segment pass: a warp per 32 sorted pairs updates, one at a
//       time, each id whose first pair lies in its chunk and whose last
//       lies in it or in the next chunk, its table, mu and nu rows loaded
//       with its first gradient row before the sum; rows are summed in
//       position order. Few registers (launch bounds of 8 CTAs an SM at
//       d 128), so 32 warps an SM keep the rows in flight: four ids a
//       warp, loaded together, ran slower at the occupancy their
//       registers left. An id that runs
//       into a third chunk leaves its partial sums, one a chunk, and its
//       first chunk enters a list;
//   (6) the combine pass: a CTA per listed id finds its last chunk (a
//       32-way search of the chunks' first keys), 16 warps sum contiguous
//       runs of the partials in order, and the runs' sums are added in
//       warp order before the update: parallel, in a fixed order.
#include "common.cuh"

namespace {

constexpr int kMaxTables = 2;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kPerThread = 8;                       // pairs a thread ranks
constexpr int kWarpPairs = 32 * kPerThread;         // 256
constexpr int kTile = kSortThreads * kPerThread;    // 2,048
constexpr int kMaxDigitBits = 11;
constexpr int kMinDigitBits = 8;
constexpr int kMaxBins = 1 << kMaxDigitBits;
constexpr int kMaxPasses = 4;
constexpr int kChunk = 32;        // sorted pairs a warp owns in (5)
constexpr int kSegWarps = 4;
constexpr int kScanBins = 8;      // digits a scan CTA takes
constexpr int kScanRegs = 16;     // counts a scan thread stages, at most
constexpr int kCounters = 4;      // the long list's length, padded to 16 B
constexpr int kListCounter = 0;

// The tables of one call: table k's ids are positions [n_base[k],
// n_base[k + 1]) of the sort and its id u is key key_base[k] + u;
// key_base[count] (one past every table) is the key of a dropped id.
struct Tables {
  float* table[kMaxTables];
  void* mu[kMaxTables];
  float* nu[kMaxTables];
  const int* ids[kMaxTables];
  const __nv_bfloat16* rows[kMaxTables];
  int64_t n_base[kMaxTables + 1];
  int key_base[kMaxTables + 1];
  int v[kMaxTables];
  int count;
};

struct Scalars {
  float b1, b2, omb1, omb2, b1c, b2c, eps, neg_lr;
};

// a[k] by selects over constant indices (a dynamic index into a kernel
// parameter would copy the parameters to local memory)
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int k) {
  T r = a[0];
#pragma unroll
  for (int j = 1; j < N; ++j)
    if (k == j) r = a[j];
  return r;
}

// The sort key of position i (the ids of the table that holds it).
__device__ __forceinline__ int make_key(const Tables& tb, int64_t i) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxTables; ++j)
    if (j < tb.count && i >= tb.n_base[j]) k = j;
  const int id = pick(tb.ids, k)[i - pick(tb.n_base, k)];
  return (id >= 0 && id < pick(tb.v, k)) ? pick(tb.key_base, k) + id
                                         : pick(tb.key_base, tb.count);
}

// The table that key `key` (not the dropped key) belongs to.
__device__ __forceinline__ int table_of(const Tables& tb, int key) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kMaxTables; ++j)
    if (j < tb.count && key >= tb.key_base[j]) k = j;
  return k;
}

// (1) zero `words` 32-bit words (a multiple of 4, 16-byte aligned)
__global__ void __launch_bounds__(256)
sort_zero_kernel(uint32_t* p, int64_t words) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
       i < words / 4; i += static_cast<int64_t>(gridDim.x) * 256)
    q[i] = make_uint4(0, 0, 0, 0);
}

// (2) a CTA per tile of kTile positions: the tile's first-pass digit
// counts, and every pass's counts over all keys
__global__ void __launch_bounds__(kSortThreads)
sort_hist_kernel(Tables tb, int64_t n, int passes, int digit_bits,
                 uint32_t* tile_hist, uint32_t* hist) {
  extern __shared__ uint32_t sh[];  // (passes, bins)
  const int bins = 1 << digit_bits, tid = threadIdx.x;
  for (int i = tid; i < passes * bins; i += kSortThreads) sh[i] = 0;
  __syncthreads();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int key[kPerThread];  // every id loaded before any is counted
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = t0 + j * kSortThreads + tid;
    key[j] = i < n ? make_key(tb, i) : -1;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (key[j] >= 0)
      for (int p = 0; p < passes; ++p)
        atomicAdd(&sh[p * bins + ((key[j] >> (p * digit_bits)) & (bins - 1))],
                  1u);
  __syncthreads();
  for (int b = tid; b < bins; b += kSortThreads)
    tile_hist[static_cast<int64_t>(blockIdx.x) * bins + b] = sh[b];
  for (int i = tid; i < passes * bins; i += kSortThreads)
    if (sh[i] != 0) atomicAdd(&hist[i], sh[i]);
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(c2v::kFullMask, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// The exclusive prefix of `x` over the CTA's threads, and the total.
__device__ __forceinline__ uint32_t block_excl_scan(uint32_t x, uint32_t* red,
                                                    uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t incl = warp_incl_scan(x, lane);
  __syncthreads();  // red may still be read by a previous scan
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  uint32_t off = incl - x, all = 0;
  for (int w = 0; w < kSortWarps; ++w) {
    if (w < warp) off += red[w];
    all += red[w];
  }
  *total = all;
  return off;
}

// (3) a CTA per kScanBins digits of one pass: each (tile, digit)'s first
// slot, the count of the lower digits over all keys plus the digit's
// count in the earlier tiles. A tile's kScanBins counts are one 32-byte
// sector: read a sector a thread into shared memory, digit-major, where
// they fit (up to kScanRegs x kSortThreads counts), then scanned there.
__global__ void __launch_bounds__(kSortThreads)
sort_scan_kernel(const uint32_t* tile_hist, const uint32_t* hist,
                 int64_t tiles, int bins, uint32_t* offsets) {
  static_assert(kScanBins == 8, "a tile's counts of a CTA: two uint4");
  __shared__ uint32_t red[kSortWarps];
  __shared__ __align__(16) uint32_t cnt[kScanRegs * kSortThreads];
  const int tid = threadIdx.x, b0 = blockIdx.x * kScanBins;
  uint32_t low = 0, total;
#pragma unroll
  for (int k = 0; k < kMaxBins / kSortThreads; ++k) {
    const int b = tid + k * kSortThreads;
    if (b < b0) low += hist[b];
  }
  block_excl_scan(low, red, &total);
  low = total;
  const int64_t all = kScanBins * tiles;
  const bool staged = all <= kScanRegs * kSortThreads;
  if (staged)
    for (int64_t t = tid; t < tiles; t += kSortThreads) {
      const uint4* src =
          reinterpret_cast<const uint4*>(tile_hist + t * bins + b0);
      const uint4 x = src[0], y = src[1];
      const uint32_t v[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) cnt[q * tiles + t] = v[q];
    }
  __syncthreads();
  // the (digit, tile) counts in digit-major order, a contiguous run a
  // thread
  const int64_t per = (all + kSortThreads - 1) / kSortThreads;
  const int64_t e0 = tid * per, e1 = e0 + per < all ? e0 + per : all;
  auto at = [&](int64_t e) { return (e % tiles) * bins + b0 + e / tiles; };
  uint32_t run = 0;
  for (int64_t e = e0; e < e1; ++e) run += staged ? cnt[e] : tile_hist[at(e)];
  uint32_t slot = low + block_excl_scan(run, red, &total);
  for (int64_t e = e0; e < e1; ++e) {
    offsets[at(e)] = slot;
    slot += staged ? cnt[e] : tile_hist[at(e)];
  }
}

struct PassArgs {
  const int* keys_in;  // null in the first pass: keys from the ids
  const int* vals_in;  // null in the first pass: the positions
  int* keys_out;
  int* vals_out;
  const uint32_t* offsets;  // (tiles, bins) from (3)
  uint32_t* next_hist;      // (tiles, bins) of the next pass, or null
  int shift, next_shift, bins;
};

// (4) one digit pass: a CTA per tile ranks its pairs by digit, stably,
// and places them from (3)'s slots; the next pass's tile counts, by the
// tile each pair lands in
__global__ void __launch_bounds__(kSortThreads)
sort_pass_kernel(Tables tb, int64_t n, PassArgs a) {
  extern __shared__ __align__(16) uint32_t wcnt[];  // (kSortWarps, bins)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bins = a.bins, per = bins / kSortThreads;
  for (int i = tid; i < kSortWarps * bins / 4; i += kSortThreads)
    reinterpret_cast<uint4*>(wcnt)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  const int64_t tile = blockIdx.x;
  const int64_t t0 = tile * kTile + warp * kWarpPairs;
  int key[kPerThread], val[kPerThread];
  uint32_t rank[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = t0 + j * 32 + lane;
    key[j] = -1;  // past n: no digit
    val[j] = 0;
    if (i < n) {
      key[j] = a.keys_in != nullptr ? a.keys_in[i] : make_key(tb, i);
      val[j] = a.vals_in != nullptr ? a.vals_in[i] : static_cast<int>(i);
    }
  }
  // a warp's pairs in position order (j, then lane): rank among its
  // earlier pairs of the same digit
  const unsigned lt = (1u << lane) - 1u;
  uint32_t* mine = wcnt + warp * bins;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int dg = key[j] >= 0 ? (key[j] >> a.shift) & (bins - 1) : -1;
    const unsigned peers = __match_any_sync(c2v::kFullMask, dg);
    rank[j] = dg >= 0 ? mine[dg] + __popc(peers & lt) : 0;
    __syncwarp();
    if (dg >= 0 && (peers & lt) == 0) mine[dg] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per digit: the tile's first slot, then each warp's
  uint32_t first[kMaxBins / kSortThreads];  // loaded at once
#pragma unroll
  for (int k = 0; k < kMaxBins / kSortThreads; ++k)
    if (k < per) first[k] = a.offsets[tile * bins + tid + k * kSortThreads];
#pragma unroll
  for (int k = 0; k < kMaxBins / kSortThreads; ++k) {
    if (k >= per) break;
    const int b = tid + k * kSortThreads;
    uint32_t r = first[k];
    for (int w = 0; w < kSortWarps; ++w) {
      const uint32_t c = wcnt[w * bins + b];
      wcnt[w * bins + b] = r;
      r += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (key[j] < 0) continue;
    const int dg = (key[j] >> a.shift) & (bins - 1);
    const uint32_t slot = mine[dg] + rank[j];
    a.keys_out[slot] = key[j];
    a.vals_out[slot] = val[j];
    if (a.next_hist != nullptr)
      atomicAdd(&a.next_hist[static_cast<int64_t>(slot / kTile) * bins +
                             ((key[j] >> a.next_shift) & (bins - 1))],
                1u);
  }
}

// Lane's columns of one bf16 row: G groups of 4 at lane * 4 + 128 g.
template <int G>
__device__ __forceinline__ void load_row(const __nv_bfloat16* row, int lane,
                                         float (&acc)[G][4]) {
  const __nv_bfloat16* r = row + lane * 4;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint2 u = *reinterpret_cast<const uint2*>(r + 128 * g);
    const float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 y = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    acc[g][0] = x.x, acc[g][1] = x.y, acc[g][2] = y.x, acc[g][3] = y.y;
  }
}

template <int G>
__device__ __forceinline__ void zero(float (&acc)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[g][q] = 0.f;
}

template <int G>
__device__ __forceinline__ void add(float (&acc)[G][4],
                                    const float (&x)[G][4]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[g][q] = __fadd_rn(acc[g][q], x[g][q]);
}

// One table row's parameters and moments, lane's columns: loaded before
// its gradient is complete, updated and stored after.
template <int G, bool kMuBf16>
struct RowState {
  float p[G][4], m[G][4], v[G][4];
  int k;      // the table
  int64_t o;  // lane's first value of the row

  __device__ __forceinline__ void load(const Tables& tb, int table, int row,
                                       int lane) {
    k = table;
    o = static_cast<int64_t>(row) * (128 * G) + lane * 4;
    const float* tp = pick(tb.table, k) + o;
    const float* np = pick(tb.nu, k) + o;
    const void* mp = pick(tb.mu, k);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(tp + 128 * g);
      const float4 y = *reinterpret_cast<const float4*>(np + 128 * g);
      p[g][0] = x.x, p[g][1] = x.y, p[g][2] = x.z, p[g][3] = x.w;
      v[g][0] = y.x, v[g][1] = y.y, v[g][2] = y.z, v[g][3] = y.w;
      if (kMuBf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(mp) + o + 128 * g);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        m[g][0] = a.x, m[g][1] = a.y, m[g][2] = b.x, m[g][3] = b.y;
      } else {
        const float4 f = *reinterpret_cast<const float4*>(
            static_cast<const float*>(mp) + o + 128 * g);
        m[g][0] = f.x, m[g][1] = f.y, m[g][2] = f.z, m[g][3] = f.w;
      }
    }
  }

  __device__ __forceinline__ void update(const Tables& tb,
                                         const float (&grad)[G][4],
                                         const Scalars& s) {
    float* tp = pick(tb.table, k) + o;
    float* np = pick(tb.nu, k) + o;
    void* mp = pick(tb.mu, k);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float out_m[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gq = grad[g][q], mq = m[g][q];
        const float new_mu =
            __fadd_rn(__fmul_rn(s.b1, mq), __fmul_rn(s.omb1, gq));
        const float new_nu = __fadd_rn(__fmul_rn(s.b2, v[g][q]),
                                       __fmul_rn(s.omb2, __fmul_rn(gq, gq)));
        const float mu_hat = __fdiv_rn(new_mu, s.b1c);
        const float nu_hat = __fdiv_rn(new_nu, s.b2c);
        const float delta = __fdiv_rn(__fmul_rn(s.neg_lr, mu_hat),
                                      __fadd_rn(__fsqrt_rn(nu_hat), s.eps));
        p[g][q] = __fadd_rn(p[g][q], delta);
        v[g][q] = __fadd_rn(v[g][q], __fsub_rn(new_nu, v[g][q]));
        out_m[q] = kMuBf16
            ? __fadd_rn(mq, c2v::bf16_round(
                                __fsub_rn(c2v::bf16_round(new_mu), mq)))
            : __fadd_rn(mq, __fsub_rn(new_mu, mq));
      }
      *reinterpret_cast<float4*>(tp + 128 * g) =
          make_float4(p[g][0], p[g][1], p[g][2], p[g][3]);
      *reinterpret_cast<float4*>(np + 128 * g) =
          make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
      if (kMuBf16) {
        __align__(8) __nv_bfloat162 h[2] = {
            __floats2bfloat162_rn(out_m[0], out_m[1]),
            __floats2bfloat162_rn(out_m[2], out_m[3])};
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(mp) + o +
                                  128 * g) =
            *reinterpret_cast<const uint2*>(h);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(mp) + o + 128 * g) =
            make_float4(out_m[0], out_m[1], out_m[2], out_m[3]);
      }
    }
  }
};

// Rows in flight a warp while it adds a segment's further rows, fewer at
// wider rows (registers).
template <int G>
struct Widths {
  static constexpr int rows = G <= 2 ? 4 : 2;
  // segment-pass CTAs an SM the registers must allow
  static constexpr int blocks = G == 1 ? 8 : (G == 2 ? 4 : 2);
  // warps summing a long segment's partials (kernels/sparse_adam.py
  // COMBINE_WARPS), and partials each keeps in flight
  static constexpr int combine = 16;
  static constexpr int combine_rows = G <= 2 ? 8 : 4;
};

// Adds, in order, the rows of sorted pairs [lo, hi) of the warp's window:
// index q < 32 is lane q's pair of this chunk, q >= 32 lane q - 32's of
// the next; all of table k.
template <int G>
__device__ __forceinline__ void add_rows(float (&acc)[G][4], int lo, int hi,
                                         int pos, int pos2,
                                         const Tables& tb, int k, int lane) {
  constexpr int R = Widths<G>::rows;
  const __nv_bfloat16* rows = pick(tb.rows, k);
  const int64_t nb = pick(tb.n_base, k);
  for (int j = lo; j < hi; j += R) {
    float rb[R][G][4];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int q = j + u;
      const int p0 = __shfl_sync(c2v::kFullMask, pos, q & 31);
      const int p1 = __shfl_sync(c2v::kFullMask, pos2, q & 31);
      if (q < hi)
        load_row<G>(rows + (static_cast<int64_t>(q < 32 ? p0 : p1) - nb) *
                               (128 * G),
                    lane, rb[u]);
      else
        zero<G>(rb[u]);
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (j + u < hi) add<G>(acc, rb[u]);
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

// (5) a warp per kChunk sorted pairs
template <int G, bool kMuBf16>
__global__ void __launch_bounds__(kSegWarps * 32, Widths<G>::blocks)
segment_kernel(const int* keys, const int* vals, int64_t n, Tables tb,
               Scalars s, float* head, float* tail, int* long_list,
               int* long_count) {
  constexpr int d = 128 * G;
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kSegWarps +
                    (threadIdx.x >> 5);
  const int64_t j0 = c * kChunk;
  if (j0 >= n) return;
  const int dead = pick(tb.key_base, tb.count);
  const int64_t i1 = j0 + lane, i2 = j0 + kChunk + lane;
  const int key = i1 < n ? keys[i1] : dead;
  const int pos = i1 < n ? vals[i1] : 0;
  const int key2 = i2 < n ? keys[i2] : dead;
  const int pos2 = i2 < n ? vals[i2] : 0;
  const int kb = j0 > 0 ? keys[j0 - 1] : -1;               // before the chunk
  const int kbb = j0 > kChunk ? keys[j0 - kChunk - 1] : -1;  // before the last
  const int k64 = j0 + 2 * kChunk < n ? keys[j0 + 2 * kChunk] : dead;
  const int up = __shfl_up_sync(c2v::kFullMask, key, 1);
  const bool st = lane == 0 ? key != kb : key != up;
  const bool live = key != dead;
  // lanes where a segment (or the dropped keys) begins, and the live ones
  const unsigned bounds = __ballot_sync(c2v::kFullMask, st || !live);
  unsigned own = __ballot_sync(c2v::kFullMask, st && live);
  const int key0 = __shfl_sync(c2v::kFullMask, key, 0);
  const int first2 = __shfl_sync(c2v::kFullMask, key2, 0);

  // the segment begun before this chunk: skipped where the previous
  // chunk's warp owns it (it began there and ends here), else this
  // chunk's part of it is a partial of a long segment
  if (!(own & 1u) && key0 != dead) {
    const int e = bounds ? __ffs(bounds) - 1 : kChunk;
    const bool ends_here = e < kChunk || first2 != key0;
    if (!(kbb != key0 && ends_here)) {
      float acc[G][4];
      zero<G>(acc);
      add_rows<G>(acc, 0, e, pos, pos2, tb, table_of(tb, key0), lane);
      store_acc<G>(head + c * d, lane, acc);
    }
  }
  // the last segment begun here, if it runs into the next chunk: owned
  // here when it ends there, else a long segment's first partial
  int last = -1, ext = 0;
  if (own) {
    last = 31 - __clz(own);
    const unsigned above = bounds & ~((2u << last) - 1u);
    const int key_last = __shfl_sync(c2v::kFullMask, key, last);
    if (above == 0 && first2 == key_last) {
      if (k64 == key_last) {
        float acc[G][4];
        zero<G>(acc);
        add_rows<G>(acc, last, kChunk, pos, pos2, tb, table_of(tb, key_last),
                    lane);
        store_acc<G>(tail + c * d, lane, acc);
        if (lane == 0) long_list[atomicAdd(long_count, 1)] =
            static_cast<int>(c);
        own &= ~(1u << last);
      } else {
        const unsigned diff =
            ~__ballot_sync(c2v::kFullMask, key2 == key_last);
        ext = diff ? __ffs(diff) - 1 : kChunk;
      }
    }
  }
  // the owned segments, one at a time: its table, mu and nu rows loaded
  // with its first gradient row, before any sum
  while (own) {
    const int sb = __ffs(own) - 1;
    own &= own - 1;
    const unsigned above = bounds & ~((2u << sb) - 1u);
    const int eb = above ? __ffs(above) - 1 : kChunk + (sb == last ? ext : 0);
    const int ku = __shfl_sync(c2v::kFullMask, key, sb);
    const int pu = __shfl_sync(c2v::kFullMask, pos, sb);
    const int k = table_of(tb, ku);
    RowState<G, kMuBf16> rs;
    rs.load(tb, k, ku - pick(tb.key_base, k), lane);
    float first[G][4], acc[G][4];
    load_row<G>(pick(tb.rows, k) +
                    (static_cast<int64_t>(pu) - pick(tb.n_base, k)) * d,
                lane, first);
    zero<G>(acc);
    add<G>(acc, first);
    add_rows<G>(acc, sb + 1, eb, pos, pos2, tb, k, lane);
    rs.update(tb, acc, s);
  }
}

// (6) a CTA per listed long segment
template <int G, bool kMuBf16>
__global__ void __launch_bounds__(Widths<G>::combine * 32)
combine_kernel(const int* keys, int64_t n, Tables tb, Scalars s,
               const float* head, const float* tail, const int* long_list,
               const int* long_count) {
  constexpr int d = 128 * G;
  constexpr int R = Widths<G>::combine_rows;
  constexpr int W = Widths<G>::combine;
  __shared__ __align__(16) float part[W][d];
  __shared__ long long last_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = *long_count;
  const int64_t n_chunks = (n + kChunk - 1) / kChunk;
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int64_t cs = long_list[i];
    const int key = keys[cs * kChunk + kChunk - 1];
    if (warp == 0) {
      // the last chunk whose first key is `key`: chunks cs + 1 .. ce
      // begin with it, chunk ce + 1 does not (cs + 2 <= ce)
      int64_t lo = cs + 2, hi = n_chunks - 1;
      auto below = [&](int64_t x) { return x < hi ? x : hi; };
      while (lo < hi) {
        const int64_t step = (hi - lo + 31) / 32;
        const int64_t probe = below(lo + (lane + 1) * step);
        const unsigned eq =
            __ballot_sync(c2v::kFullMask, keys[probe * kChunk] == key);
        if (eq == 0) {
          hi = lo + step - 1;
        } else {
          const int l = 31 - __clz(eq);
          const int64_t base = lo;
          lo = below(base + (l + 1) * step);
          if (l < 31) hi = below(base + (l + 2) * step - 1);
        }
      }
      if (lane == 0) last_sh = lo;
    }
    __syncthreads();
    const int64_t len = last_sh - cs + 1;  // the first partial, then heads
    const int64_t per = (len + W - 1) / W;
    const int64_t e0 = warp * per, e1 = e0 + per < len ? e0 + per : len;
    RowState<G, kMuBf16> rs;
    const int k = table_of(tb, key);
    if (warp == 0) rs.load(tb, k, key - pick(tb.key_base, k), lane);
    float acc[G][4];
    zero<G>(acc);
    for (int64_t e = e0; e < e1; e += R) {
      float x[R][G][4];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (e + u < e1) {
          const float* src =
              (e + u == 0 ? tail + cs * d : head + (cs + e + u) * d) +
              lane * 4;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 f = *reinterpret_cast<const float4*>(src + 128 * g);
            x[u][g][0] = f.x, x[u][g][1] = f.y, x[u][g][2] = f.z,
            x[u][g][3] = f.w;
          }
        } else {
          zero<G>(x[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u)
        if (e + u < e1) add<G>(acc, x[u]);
    }
    store_acc<G>(part[warp], lane, acc);
    __syncthreads();
    if (warp == 0) {
      zero<G>(acc);
      for (int w = 0; w < W && w * per < len; ++w) {
        float x[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 f =
              *reinterpret_cast<const float4*>(part[w] + lane * 4 + 128 * g);
          x[g][0] = f.x, x[g][1] = f.y, x[g][2] = f.z, x[g][3] = f.w;
        }
        add<G>(acc, x);
      }
      rs.update(tb, acc, s);
    }
    __syncthreads();
  }
}

// Launches (5) and (6) over the sorted pairs.
struct RowPasses {
  const int* keys;
  const int* vals;
  int64_t n;
  Tables tb;
  Scalars s;
  float* head;
  float* tail;
  int* list;
  int* count;
  cudaStream_t st;

  template <int G, bool kMuBf16>
  cudaError_t launch_mu() const {
    const int64_t n_chunks = (n + kChunk - 1) / kChunk;
    segment_kernel<G, kMuBf16>
        <<<static_cast<unsigned>((n_chunks + kSegWarps - 1) / kSegWarps),
           kSegWarps * 32, 0, st>>>(keys, vals, n, tb, s, head, tail, list,
                                    count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t grid = n_chunks < 512 ? n_chunks : 512;
    combine_kernel<G, kMuBf16>
        <<<static_cast<unsigned>(grid), Widths<G>::combine * 32, 0, st>>>(
            keys, n, tb, s, head, tail, list, count);
    return cudaGetLastError();
  }

  template <int G>
  cudaError_t launch(int mu_bf16) const {
    return mu_bf16 ? launch_mu<G, true>() : launch_mu<G, false>();
  }
};

// The sort's shape for keys in [0, keys]: the fewest digit passes of at
// most 11 bits, as even as they can be and at least 8 bits, its tiles
// and the segment pass's chunks.
struct Plan {
  int passes, digit_bits, bins;
  int64_t tiles, chunks;
  __host__ Plan(int64_t n, int64_t keys) {
    int bits = 1;
    while ((int64_t(1) << bits) <= keys) ++bits;
    passes = (bits + kMaxDigitBits - 1) / kMaxDigitBits;
    digit_bits = (bits + passes - 1) / passes;
    if (digit_bits < kMinDigitBits) digit_bits = kMinDigitBits;
    bins = 1 << digit_bits;
    tiles = (n + kTile - 1) / kTile;
    chunks = (n + kChunk - 1) / kChunk;
  }
};

__host__ inline int64_t align256(int64_t x) { return (x + 255) / 256 * 256; }

// The scratch of one call (kernels/sparse_adam.py `plan` mirrors it): the
// keys and positions twice (the passes alternate), the first pass's tile
// counts, then the region (1) zeroes: the digit counts over all keys, the
// counters and the later passes' tile counts; each pass's slots; the
// list of long segments and two partial rows a chunk.
struct Scratch {
  int64_t keys[2], vals[2], tile_hist, hist, counters, zero_end, offsets,
      list, head, tail, total;
  __host__ Scratch(const Plan& P, int64_t n, int d) {
    const int64_t table = 4 * P.tiles * P.bins;  // one pass's tile counts
    int64_t o = 0;
    for (int b = 0; b < 2; ++b) {
      keys[b] = o;
      o = align256(o + 4 * n);
      vals[b] = o;
      o = align256(o + 4 * n);
    }
    tile_hist = o;
    o = align256(o + table);
    hist = o;
    o += 4 * static_cast<int64_t>(P.passes) * P.bins;
    counters = o;
    o += 4 * kCounters + table * (P.passes - 1);
    zero_end = o = align256(o);
    offsets = o;
    o = align256(o + table);
    list = o;
    o = align256(o + 4 * P.chunks);
    head = o;
    o = align256(o + 4 * P.chunks * d);
    tail = o;
    total = o = align256(o + 4 * P.chunks * d);
  }
  // pass p's tile counts (p >= 1 lie in the zeroed region)
  __host__ int64_t pass_hist(const Plan& P, int p) const {
    return p == 0 ? tile_hist
                  : counters + 4 * kCounters + 4 * (p - 1) * P.tiles * P.bins;
  }
};

}  // namespace

// Bytes of scratch for n pairs of keys in [0, keys] at width d.
C2V_EXPORT int64_t c2v_sparse_adam_scratch_bytes(int64_t n, int64_t keys,
                                                 int d) {
  const Plan P(n, keys);
  return Scratch(P, n, d).total;
}

// The digit passes and digit width the sort takes for keys in [0, keys],
// as passes * 100 + digit bits.
C2V_EXPORT int c2v_sparse_adam_passes(int64_t keys) {
  const Plan P(1, keys);
  return P.passes * 100 + P.digit_bits;
}

// `count` tables of width d, each f32 (v[k], d) with mu (v[k], d) bf16
// (mu_bf16 1) or f32 and nu f32 (v[k], d), all updated in place; ids[k]
// int32 (n[k],), rows[k] bf16 (n[k], d). The arrays of pointers, widths
// and counts have `count` (1 or 2) entries. d % 128 == 0, d <= 512; the n[k]
// add to less than 2^30 and the v[k] to less than 2^31 - 1. Scalars: b1,
// b2, 1 - b1, 1 - b2, the bias corrections 1 - b^t, eps and -lr, as f32.
// scratch: c2v_sparse_adam_scratch_bytes(sum n, sum v, d) bytes,
// 256-byte aligned. Returns a cudaError_t.
C2V_EXPORT int c2v_sparse_adam(int count, float* const* tables,
                               void* const* mus, float* const* nus,
                               const int* v, const int* const* ids,
                               const void* const* rows, const int64_t* ns,
                               int d, int mu_bf16, float b1, float b2,
                               float omb1, float omb2, float b1c, float b2c,
                               float eps, float neg_lr, void* scratch,
                               void* stream) {
  if (count < 1 || count > kMaxTables || d <= 0 || d % 128 != 0 ||
      d > 128 * 4)
    return cudaErrorInvalidValue;
  Tables tb = {};
  int64_t n = 0, keys = 0;
  for (int k = 0; k < count; ++k) {
    if (v[k] <= 0 || ns[k] < 0) return cudaErrorInvalidValue;
    tb.table[k] = tables[k];
    tb.mu[k] = mus[k];
    tb.nu[k] = nus[k];
    tb.ids[k] = ids[k];
    tb.rows[k] = static_cast<const __nv_bfloat16*>(rows[k]);
    tb.v[k] = v[k];
    tb.n_base[k] = n;
    tb.key_base[k] = static_cast<int>(keys);
    n += ns[k];
    keys += v[k];
    if (n >= (int64_t(1) << 30) || keys >= 0x7fffffff)
      return cudaErrorInvalidValue;
  }
  tb.n_base[count] = n;
  tb.key_base[count] = static_cast<int>(keys);
  tb.count = count;
  if (n == 0) return cudaSuccess;
  const Plan P(n, keys);
  if (P.passes > kMaxPasses) return cudaErrorInvalidValue;
  const Scratch L(P, n, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  int* kbuf[2] = {reinterpret_cast<int*>(base + L.keys[0]),
                  reinterpret_cast<int*>(base + L.keys[1])};
  int* vbuf[2] = {reinterpret_cast<int*>(base + L.vals[0]),
                  reinterpret_cast<int*>(base + L.vals[1])};
  uint32_t* hist = reinterpret_cast<uint32_t*>(base + L.hist);
  uint32_t* offsets = reinterpret_cast<uint32_t*>(base + L.offsets);
  int* counters = reinterpret_cast<int*>(base + L.counters);
  const int64_t words = (L.zero_end - L.hist) / 4;
  const int64_t zgrid = (words / 4 + 255) / 256;
  sort_zero_kernel<<<static_cast<unsigned>(zgrid < 264 ? zgrid : 264), 256,
                     0, st>>>(hist, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sort_hist_kernel<<<static_cast<unsigned>(P.tiles), kSortThreads,
                     sizeof(uint32_t) * P.passes * P.bins, st>>>(
      tb, n, P.passes, P.digit_bits,
      reinterpret_cast<uint32_t*>(base + L.tile_hist), hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t pass_smem = sizeof(uint32_t) * kSortWarps * P.bins;
  err = cudaFuncSetAttribute(sort_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pass_smem));
  if (err != cudaSuccess) return err;
  const int* k_in = nullptr;
  const int* v_in = nullptr;
  for (int p = 0; p < P.passes; ++p) {
    const uint32_t* tile_hist =
        reinterpret_cast<const uint32_t*>(base + L.pass_hist(P, p));
    sort_scan_kernel<<<P.bins / kScanBins, kSortThreads, 0, st>>>(
        tile_hist, hist + p * P.bins, P.tiles, P.bins, offsets);
    PassArgs a;
    a.keys_in = k_in;
    a.vals_in = v_in;
    a.keys_out = kbuf[p & 1];
    a.vals_out = vbuf[p & 1];
    a.offsets = offsets;
    a.next_hist = p + 1 < P.passes ? reinterpret_cast<uint32_t*>(
                                         base + L.pass_hist(P, p + 1))
                                   : nullptr;
    a.shift = p * P.digit_bits;
    a.next_shift = (p + 1) * P.digit_bits;
    a.bins = P.bins;
    sort_pass_kernel<<<static_cast<unsigned>(P.tiles), kSortThreads,
                       pass_smem, st>>>(tb, n, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k_in = a.keys_out;
    v_in = a.vals_out;
  }
  const RowPasses rp{k_in, v_in, n, tb,
                     Scalars{b1, b2, omb1, omb2, b1c, b2c, eps, neg_lr},
                     reinterpret_cast<float*>(base + L.head),
                     reinterpret_cast<float*>(base + L.tail),
                     reinterpret_cast<int*>(base + L.list),
                     counters + kListCounter, st};
  switch (d / 128) {
    case 1: err = rp.launch<1>(mu_bf16); break;
    case 2: err = rp.launch<2>(mu_bf16); break;
    case 3: err = rp.launch<3>(mu_bf16); break;
    default: err = rp.launch<4>(mu_bf16);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
