// K3 blockwise_topk: top-k and logsumexp of bf16(cv) @ bf16(table).T, and
// in its float32 mode of cv @ table.T with f32 operands (3xTF32, below).
//
// Replaces code2vec_tpu/ops/topk.py blockwise_matmul_top_k (:99-179) with
// its merge `_merge_top_k` (:41-52) and streaming logsumexp `_fold_lse`
// (:55-69): logits accumulate in f32 from bf16 operands, the per-row
// dequant scale multiplies the f32 logits after the product, rows at or
// above `valid_rows` are dead, ties go to the lowest index (NaN ranks
// first, as lax.top_k orders it), and the logsumexp sees every live
// non-finite logit as -1e30 while the top-k merges the raw logits.
//
// Tables: f32, int8, fp8 e4m3 or e5m2 (the reference's fp8 view at load,
// code2vec_tpu/release/runtime.py:352) or packed int4 (ops/quant.py
// unpack_int4 on each block, topk.py:142-147), each quantized format with
// per-row f32 scales. Every int8, fp8 and int4 value is exact in bf16, so
// decoding straight into bf16 is the reference's decode-to-f32-then-cast,
// bit for bit.
//
// What bounds it on an H100: bytes at the serving batch (the int8 table is
// 100 MB against 12.8 GFLOP at B 64, ~130 flops per byte, under the card's
// ~295: one pass over the table, ~30 us; int4 halves it), bf16 operations
// at the evaluate batch (B 1024: 0.21 ms), and in the float32 mode bytes
// (1.54 GB at the index's 1M x 384) with 3xTF32's tensor work close
// behind (0.30 ms).
//
// Design (Hopper: wgmma fed by bulk copies under an mbarrier ring):
//   - Grid: persistent CTAs, one per SM; CTA (run, b-chunk) owns a
//     contiguous run of 64-row table tiles and N code vectors (N 8, 16
//     or 32, the batch rounded up, so a batch of 12 pays for 16; above
//     32, chunks of 32, or of 64 above a batch of 64 in the bf16 mode:
//     kernels/topk.py `plan`). The b-chunks of one run are neighbouring
//     CTAs, so a larger batch reads each tile from device memory about
//     once and from L2 for the others. N stops at 64 because each
//     warpgroup holds N / 2 accumulators, N / 2 (max, sumexp) and N / 4
//     thresholds a thread (ptxas caps a 288-thread block at 168
//     registers), and the code vectors take N D 2 bytes of shared memory
//     (x 8 in the float32 mode) beside the ring and the lists.
//   - A producer warp brings the tiles into a ring of 2 or 4 stages, half
//     of them for each consumer warpgroup's tiles (so each stage has one
//     consumer, and its mbarrier phases stay in step with it): a tile of
//     int8, fp8 or int4 rows is contiguous (int8 at D 384 is 24 KB) and
//     comes in one 1-D bulk copy; an f32 table comes in 64-wide K slices,
//     two tensor (TMA) copies of 32 columns each, 128-byte-swizzled
//     against bank conflicts (one copy per row would cost a copy per 256
//     bytes, and the copy engine, not the memory, would set the pace).
//   - Table rows are wgmma's M side (A, from registers): each thread reads
//     its rows' bytes from the stage and decodes them straight into the
//     A fragment (int8 and int4 by magic-number bit tricks, fp8 through
//     f32, f32 by a rounding convert), two register sets so one 64-wide
//     K block is decoded while the last one multiplies. The order of K
//     inside a block is permuted so that a thread's values are contiguous
//     in memory; the code vectors (B, bf16, 128-byte-swizzled K-major
//     shared memory, written once per CTA) carry the same permutation.
//   - Two consumer warpgroups take alternate tiles, each with its own
//     accumulators, lists and logits buffer, so one warpgroup's fold
//     overlaps the other's products.
//   - The fold works on the accumulators, branch-free over a thread's
//     columns: scale each row, set rows at or above `valid_rows` to -inf,
//     keep a running (max, sumexp) per code vector and thread, and mark
//     each logit that may beat its code vector's current k-th value (a
//     bit per logit; strictly, since a later row loses a tie, so a zero
//     code vector, as a padded batch row has, marks nothing once its
//     list is full). The rare candidates go to a
//     shared-memory queue, from which a warp per code vector inserts them
//     into its sorted list (warp_topk_insert). Only a tile with many (a
//     list's first tiles, or more than the queue holds) goes through
//     shared memory whole: there a warp per code vector sorts the tile's
//     candidates (a bitonic network over the warp) and merges them with
//     the list by rank.
//   - Each warpgroup writes its lists and (max, sumexp) as a partial; a
//     second launch merges the 2 x runs partials of each code vector.
//
// Float32 mode (the index's brute-force search,
// code2vec_tpu/retrieval/index.py `_search_brute` :306-317, f32 operands):
// the same skeleton on 3xTF32 wgmma (m64nNk8). Each f32 operand x is split
// into tf32 hi = rna(x) and lo = rna(x - hi); the product is
// hi.hi + hi.lo + lo.hi in f32, which carries ~22 bits of each product
// (an error ~2^-21 of |x||y|, near f32 rounding at D 384). The table rows
// are split in registers; the code vectors once, into hi and lo tiles in
// shared memory.
//
// Large-k mode (k above the 64 entries a list holds): the tiles' logits
// (raw, -inf past `valid_rows`) go from the accumulators to a (b, ld) f32
// score matrix instead of the lists, the merge launch folds the
// logsumexp alone, and K13 (csrc/select.cu) selects the top k.
#include "hopper.cuh"

namespace {

using namespace c2v::hopper;

constexpr int kMaxK = 64;
constexpr int kTileRows = 64;    // table rows per tile (wgmma's M)
constexpr int kWarpgroups = 2;   // consumers, alternate tiles
constexpr int kThreads = kWarpgroups * 128 + 32;
constexpr int kMaxStages = 4;
constexpr int kLogitLd = 68;     // floats per code vector in a logits buffer
constexpr int kF32Slice = 64;    // K values of an f32 table's stage
constexpr int kF32Box = kTileRows * 128;  // its 32-column TMA box, bytes
constexpr int kMergeMin = 12;    // candidates that take the sort-and-merge
constexpr int kQueue = 512;      // candidates a warpgroup queues per tile
constexpr float kLseFloor = -1e30f;   // a live non-finite logit's value
constexpr float kRunFloor = -3e38f;   // the running max before any logit
constexpr float kLog2e = 1.4426950408889634f;

// 2^x (flushes subnormal results to 0; ex2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One arrival on an mbarrier, issued only once `dep` is known. The
// count is computed from `dep` inside the asm: 2 where dep is all ones
// and `nonneg` < 0, else 1. Callers pass a `nonneg` that is never
// negative at run time, so the count is always 1, but no compiler pass
// sees that (the asm is opaque to the front end, and ptxas cannot know
// `nonneg`): the arrive waits for `dep`, and so for the loads it was
// computed from.
__device__ __forceinline__ void mbar_arrive_after(uint64_t* bar,
                                                  uint32_t dep,
                                                  int nonneg) {
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t.reg .b32 c;\n\t"
      "setp.eq.b32 p, %1, 0xFFFFFFFF;\n\t"
      "setp.lt.s32 q, %2, 0;\n\t"
      "and.pred p, p, q;\n\t"
      "selp.b32 c, 2, 1, p;\n\t"
      "mbarrier.arrive.shared::cta.b64 _, [%0], c;\n\t}" ::"r"(
          smem_u32(bar)),
      "r"(dep), "r"(nonneg)
      : "memory");
}

// Bytes of one table row as stored.
__host__ __device__ inline int row_bytes(int fmt, int d) {
  return fmt == c2v::kF32 ? 4 * d : fmt == c2v::kInt4 ? d / 2 : d;
}

struct Layout {
  int64_t b_lo, stage, stage_bytes, lists, logits, sort, queue, bars, total;
};

__host__ __device__ inline int64_t round_up(int64_t x, int64_t a) {
  return (x + a - 1) / a * a;
}

// Shared memory: the code vectors (bf16; f32 mode: tf32 hi, then lo), the
// ring's stages, each warpgroup's lists ([N][k] values, then indices) and
// logits buffer ([N][kLogitLd]), a 64-entry sort scratch per warp, each
// warpgroup's candidate queue (kQueue values, then packed columns and
// rows), the barriers and two queue counts per warpgroup.
// kernels/topk.py `plan` reads the total through c2v_topk_smem.
__host__ __device__ inline Layout layout(int fmt, bool f32, int d, int k,
                                         int n, int stages) {
  Layout s;
  const int64_t b_block = static_cast<int64_t>(n) * 128;
  const int64_t b_bytes =
      f32 ? 2 * round_up(d, 32) / 32 * b_block : round_up(d, 64) / 64 * b_block;
  s.b_lo = f32 ? b_bytes / 2 : 0;
  s.stage = round_up(b_bytes, 1024);
  s.stage_bytes =
      fmt == c2v::kF32
          ? 2 * kF32Box
          : round_up(static_cast<int64_t>(kTileRows) * row_bytes(fmt, d), 1024);
  s.lists = s.stage + stages * s.stage_bytes;
  s.logits = s.lists + static_cast<int64_t>(kWarpgroups) * n * k * 8;
  s.sort = s.logits + static_cast<int64_t>(kWarpgroups) * n * kLogitLd * 4;
  s.queue = s.sort + kWarpgroups * 4 * 64 * 8;
  s.bars = s.queue + kWarpgroups * kQueue * 8;
  s.total = s.bars + 2 * kMaxStages * 8 + 4 * kWarpgroups * 4 + 1024;
  return s;
}

// Two floats as a bf16 pair, low half first, when both are exact in bf16
// (the upper halves of their f32 bits).
__device__ __forceinline__ uint32_t upper_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

__device__ __forceinline__ uint32_t bf16_pair_rn(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Four int8 values (a word, lowest byte first) as two exact bf16 pairs:
// each byte, offset by 128, becomes the low mantissa byte of 2^23 + u,
// the f32 subtraction of 2^23 + 128 leaves the value, and its upper half
// is its bf16.
__device__ __forceinline__ void int8x4_bf16(uint32_t w, uint32_t& p01,
                                            uint32_t& p23) {
  w ^= 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(w, kMagic, 0x7540)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(w, kMagic, 0x7541)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(w, kMagic, 0x7542)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(w, kMagic, 0x7543)) - kBias;
  p01 = upper_halves(f0, f1);
  p23 = upper_halves(f2, f3);
}

// Nibbles j and j + 4 of a packed-int4 word as an exact bf16 pair: the
// nibble n (q + 8) is the low mantissa of bf16 128 + n, and one bf16 FMA
// takes off 136.
template <int J>
__device__ __forceinline__ uint32_t int4_pair(uint32_t w) {
  const uint32_t x = ((w >> (4 * J)) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(x), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// Which of a thread's 16 values (in memory order) k-step s uses as its
// element e (0, 1: A columns 2 (lane % 4) + {0, 1}; 2, 3: those + 8): the
// K permutation of a 64-wide block, bf16 mode. int4 pairs nibbles j and
// j + 4 of a word; the other formats take four neighbours.
__host__ __device__ inline int bf16_phys(int fmt, int s, int e) {
  if (fmt == c2v::kInt4) return 8 * (s / 2) + 2 * (s % 2) + e / 2 + 4 * (e % 2);
  return 4 * s + e;
}

// The memory column (within its 64-block) of logical K position k of that
// block: A's column 2 q + e' of k-step s, the B operand's row.
__host__ __device__ inline int bf16_col(int fmt, int k) {
  const int s = k / 16, pos = k % 16;
  const int q = (pos % 8) / 2, e = pos % 2 + 2 * (pos / 8);
  return 16 * q + bf16_phys(fmt, s, e);
}

// One 64-wide K block of this thread's two rows (r0, r1 = r0 + 8 of the
// tile) of an int8, fp8 or int4 table as bf16 A fragments a[s] for the
// block's four k-steps. `p0`, `p1` point at the rows' 16 values (memory
// order); `live` false gives zeros (K past d).
template <int kFmt>
__device__ __forceinline__ void decode_bf16(const unsigned char* p0,
                                            const unsigned char* p1,
                                            bool live, uint32_t (&a)[4][4]) {
  if (!live) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[s][i] = 0u;
    return;
  }
  const unsigned char* p[2] = {p0, p1};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kFmt == c2v::kInt8) {
      const uint4 w = *reinterpret_cast<const uint4*>(p[r]);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) int8x4_bf16(ws[s], a[s][r], a[s][2 + r]);
    } else if constexpr (kFmt == c2v::kInt4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p[r]);
      a[0][r] = int4_pair<0>(w.x);
      a[0][2 + r] = int4_pair<1>(w.x);
      a[1][r] = int4_pair<2>(w.x);
      a[1][2 + r] = int4_pair<3>(w.x);
      a[2][r] = int4_pair<0>(w.y);
      a[2][2 + r] = int4_pair<1>(w.y);
      a[3][r] = int4_pair<2>(w.y);
      a[3][2 + r] = int4_pair<3>(w.y);
    } else if constexpr (kFmt == c2v::kE4M3 || kFmt == c2v::kE5M2) {
      const uint4 w = *reinterpret_cast<const uint4*>(p[r]);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v[4];
        c2v::decode4<kFmt>(ws[s], v);
        a[s][r] = upper_halves(v[0], v[1]);
        a[s][2 + r] = upper_halves(v[2], v[3]);
      }
    }
  }
}

// The same for an f32 table, rounded to bf16 as the reference casts it:
// the thread's 16 values of each row are chunks j0 to j0 + 3 of a
// 128-byte-swizzled TMA box (`box`, 64 rows).
__device__ __forceinline__ void decode_bf16_box(const uint8_t* box, int r0,
                                                int j0, bool live,
                                                uint32_t (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live)
        x = *reinterpret_cast<const float4*>(box + swz(r0 + 8 * r, j0 + s));
      a[s][r] = bf16_pair_rn(x.x, x.y);
      a[s][2 + r] = bf16_pair_rn(x.z, x.w);
    }
}

// Sort 64 (value, index) entries over a warp into lax.top_k's order, best
// first: entry e lives in lane e % 32, slot e / 32 (bitonic network).
__device__ __forceinline__ void warp_sort64(float (&v)[2], int (&ix)[2],
                                            int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // the two slots of a lane; size 64, ascending
        if (c2v::topk_before(v[1], ix[1], v[0], ix[0])) {
          const float tv = v[0];
          const int ti = ix[0];
          v[0] = v[1], ix[0] = ix[1], v[1] = tv, ix[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = lane + 32 * h;
        const float ov = __shfl_xor_sync(c2v::kFullMask, v[h], stride);
        const int oi = __shfl_xor_sync(c2v::kFullMask, ix[h], stride);
        const bool up = (e & size) == 0, lower = (e & stride) == 0;
        const bool other_first = c2v::topk_before(ov, oi, v[h], ix[h]);
        const bool take = (lower == up) ? other_first
                                        : c2v::topk_before(v[h], ix[h], ov, oi);
        if (take) v[h] = ov, ix[h] = oi;
      }
    }
  }
}

// Fold one tile's logits of one code vector (`lg`, 64 values, rows t0 +
// m) into its sorted list (lv, li; k entries) with one warp: the rows
// that beat the list's last entry are inserted one by one, or, when many
// do, sorted (warp_sort64) and merged with the list by rank. `sv`, `si`:
// the warp's 64-entry scratch.
__device__ void fold_column(const float* lg, int64_t t0, int64_t live_end,
                            float* lv, int* li, int k, float* sv, int* si,
                            int lane) {
  float x[2];
  int vi[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t v = t0 + lane + 32 * h;
    live[h] = v < live_end;
    x[h] = live[h] ? lg[lane + 32 * h] : -INFINITY;
    vi[h] = static_cast<int>(v);
  }
  const float tail_v = lv[k - 1];
  const int tail_i = li[k - 1];
  bool cand[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cand[h] = live[h] && c2v::topk_before(x[h], vi[h], tail_v, tail_i);
  const int n = __popc(__ballot_sync(c2v::kFullMask, cand[0])) +
                __popc(__ballot_sync(c2v::kFullMask, cand[1]));
  if (n == 0) return;
  if (n < kMergeMin) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned ballot = __ballot_sync(
          c2v::kFullMask,
          live[h] && c2v::topk_before(x[h], vi[h], lv[k - 1], li[k - 1]));
      while (ballot) {
        const int src = __ffs(ballot) - 1;
        ballot &= ballot - 1;
        const float cx = __shfl_sync(c2v::kFullMask, x[h], src);
        const int ci = __shfl_sync(c2v::kFullMask, vi[h], src);
        c2v::warp_topk_insert(lv, li, k, cx, ci, lane);
      }
    }
    return;
  }
  // the candidates, sorted; the rest as empty entries
  float tv[2];
  int ti[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tv[h] = cand[h] ? x[h] : -INFINITY;
    ti[h] = cand[h] ? vi[h] : c2v::kEmptyIndex;
  }
  warp_sort64(tv, ti, lane);
  sv[lane] = tv[0], sv[lane + 32] = tv[1];
  si[lane] = ti[0], si[lane + 32] = ti[1];
  __syncwarp();
  // new place of list entry j: j + the sorted entries strictly before it;
  // of sorted entry e: e + the list entries before it or equal to it
  float lvv[2];
  int lii[2], lpos[2], tpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    lpos[h] = k;
    if (j < k) {
      lvv[h] = lv[j], lii[h] = li[j];
      int lo = 0, hi = 64;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (c2v::topk_before(sv[mid], si[mid], lvv[h], lii[h])) lo = mid + 1;
        else hi = mid;
      }
      lpos[h] = j + lo;
    }
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!c2v::topk_before(tv[h], ti[h], lv[mid], li[mid])) lo = mid + 1;
      else hi = mid;
    }
    tpos[h] = j + lo;
  }
  __syncwarp();  // every lane has read the list before any lane writes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lpos[h] < k) lv[lpos[h]] = lvv[h], li[lpos[h]] = lii[h];
    if (tpos[h] < k) lv[tpos[h]] = tv[h], li[tpos[h]] = ti[h];
  }
  __syncwarp();
}

// Which logits may enter a list whose last value is t, when their rows
// come after every row in the list (a warpgroup walks its tiles in
// ascending row order): ties go to the lower index, so x must beat t
// strictly, or be NaN above a number. That is one unordered compare per
// logit, !(x <= t), with two per-column masks laid over it once a tile:
// a list whose last value is -inf may hold empty entries, so any live
// logit may enter it (`cold_cols`), and a list whose last value is NaN
// takes no later row (`open_cols`). An equal x is no candidate: a zero
// code vector (a padded batch row) gives every row the same logit, which
// would otherwise queue the whole tile every time.

// Kernel parameters (an f32 table also as a tensor map).
struct Params {
  CUtensorMap tmap;
  const float* cv;
  int b_rows, d;
  const unsigned char* table;
  const float* scales;
  int64_t v_rows, valid_rows;
  int k, n_b_chunks, runs, stages;
  float* part_vals;
  int* part_idx;
  float* part_max;
  float* part_sum;
  float* scores;
  int64_t sld;
};

// The split-V partial pass. kFmt: the table's format; kF32: the float32
// mode (3xTF32; f32 tables); N: code vectors per CTA. 2 consumer
// warpgroups, then the producer warp.
template <int kFmt, bool kF32, int N>
__global__ void __launch_bounds__(kThreads, 1)
topk_partial_kernel(const __grid_constant__ Params P) {
  constexpr bool kScaled = kFmt != c2v::kF32;
  constexpr int NQ = N / 4;  // columns (code vectors) a thread holds
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int d = P.d, k = P.k;
  const Layout L = layout(kFmt, kF32, d, k, N, P.stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  int* counts = reinterpret_cast<int*>(empty + kMaxStages);
  const int tid = threadIdx.x;
  const int run = blockIdx.x / P.n_b_chunks;
  const int b0 = (blockIdx.x % P.n_b_chunks) * N;
  const int64_t n_tiles = (P.v_rows + kTileRows - 1) / kTileRows;
  const int64_t tile0 = n_tiles * run / P.runs;
  const int64_t my_tiles = n_tiles * (run + 1) / P.runs - tile0;
  const int rb = row_bytes(kFmt, d);
  // stages per tile: the whole tile, or (f32 tables) its 64-wide K slices
  const int spt = kFmt == c2v::kF32 ? (d + kF32Slice - 1) / kF32Slice : 1;
  const int S2 = P.stages / 2;  // stages of each warpgroup's half-ring
  if (tid == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the four warps of the tile's warpgroup
    }
    for (int i = 0; i < 2 * kWarpgroups; ++i) counts[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(c2v::kFullMask, tid / 128, 0);
  if (wg == kWarpgroups) {  // producer: the run's tiles, stage by stage
    const int lane = tid % 32;
    for (int64_t i = 0; i < my_tiles; ++i) {
      const int64_t t0 = (tile0 + i) * kTileRows;
      const int rows = static_cast<int>(
          P.v_rows - t0 < kTileRows ? P.v_rows - t0 : kTileRows);
      for (int sl = 0; sl < spt; ++sl) {
        // the stage's place in its warpgroup's half-ring
        const int64_t seq = i / kWarpgroups * spt + sl;
        const int slot = static_cast<int>(i % kWarpgroups) * S2 +
                         static_cast<int>(seq % S2);
        if (seq >= S2) mbar_wait(&empty[slot], ((seq / S2) - 1) & 1);
        uint8_t* st = smem + L.stage + slot * L.stage_bytes;
        if (kFmt != c2v::kF32) {
          if (lane == 0) {
            const uint32_t bytes = static_cast<uint32_t>(rows) * rb;
            mbar_arrive_tx(&full[slot], bytes);
            bulk_load(st, P.table + t0 * rb, bytes, &full[slot]);
          }
        } else if (lane == 0) {  // one or two 32-column boxes
          const int c0 = sl * kF32Slice;
          const bool two = c0 + 32 < d;
          mbar_arrive_tx(&full[slot], (two ? 2 : 1) * kF32Box);
          tma_load_2d(st, &P.tmap, c0, static_cast<int>(t0), &full[slot]);
          if (two)
            tma_load_2d(st + kF32Box, &P.tmap, c0 + 32, static_cast<int>(t0),
                        &full[slot]);
        }
      }
    }
    return;
  }

  // ---- consumers
  const int wtid = tid % 128, lane = tid % 32, warp = wtid / 32;
  const int q = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows r0, r0 + 8
  const int64_t live_end = P.valid_rows < P.v_rows ? P.valid_rows : P.v_rows;
  const uint32_t sb = smem_u32(smem);

  // the CTA's code vectors as the B operand, K permuted (module note)
  {
    const int per_block = kF32 ? 32 : 64, vals = kF32 ? 4 : 8;
    const int n_blocks = (d + per_block - 1) / per_block;
    const int chunks = n_blocks * N * 8;  // 16-byte chunks of one tile
    for (int e = tid; e < chunks; e += kWarpgroups * 128) {
      const int blk = e / (N * 8), rem = e % (N * 8), n = rem / 8, j = rem % 8;
      const int b = b0 + n;
      float x[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = 0.f;
      if (b < P.b_rows)
        for (int t = 0; t < vals; ++t) {
          const int lk = j * vals + t;
          const int col = blk * per_block +
                          (kF32 ? tf32_col(lk) : bf16_col(kFmt, lk));
          if (col < d) x[t] = P.cv[static_cast<int64_t>(b) * d + col];
        }
      uint8_t* dst = smem + blk * N * 128 + swz(n, j);
      if (kF32) {
        uint4 h, l;
        uint32_t* hp = &h.x;
        uint32_t* lp = &l.x;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          hp[t] = tf32_rna(x[t]);
          lp[t] = tf32_rna(x[t] - __uint_as_float(hp[t]));
        }
        *reinterpret_cast<uint4*>(dst) = h;
        *reinterpret_cast<uint4*>(dst + L.b_lo) = l;
      } else {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(bf16_pair_rn(x[0], x[1]), bf16_pair_rn(x[2], x[3]),
                       bf16_pair_rn(x[4], x[5]), bf16_pair_rn(x[6], x[7]));
      }
    }
  }
  float* lv = reinterpret_cast<float*>(smem + L.lists) + wg * N * k;
  int* li = reinterpret_cast<int*>(smem + L.lists) + kWarpgroups * N * k +
            wg * N * k;
  float* lg = reinterpret_cast<float*>(smem + L.logits) + wg * N * kLogitLd;
  float* sv = reinterpret_cast<float*>(smem + L.sort) + (wg * 4 + warp) * 128;
  int* si = reinterpret_cast<int*>(sv + 64);
  float* qv = reinterpret_cast<float*>(smem + L.queue) + wg * 2 * kQueue;
  int* qi = reinterpret_cast<int*>(qv + kQueue);
  for (int e = wtid; e < N * k; e += 128) {
    lv[e] = -INFINITY;
    li[e] = c2v::kEmptyIndex;
  }
  fence_async_smem();
  named_sync(1, kWarpgroups * 128);

  float acc[N / 2];
  float run_m[NQ], run_s[NQ], thr[NQ];
#pragma unroll
  for (int c = 0; c < NQ; ++c) run_m[c] = kRunFloor, run_s[c] = 0.f,
                               thr[c] = -INFINITY;
  // two bits per column this thread holds (its rows r0, r0 + 8): the
  // columns of real code vectors, and those whose list is not yet full
  uint32_t valid_cols = 0, cold_cols = 0, open_cols;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * j + h;
      if (b0 + 8 * j + 2 * q + h < P.b_rows) valid_cols |= 3u << (2 * c);
      cold_cols |= 3u << (2 * c);
    }
  open_cols = valid_cols;
  const int n_units = kF32 ? (d + 31) / 32 : (d + 63) / 64;
  const int ups = kF32 ? 2 : (kFmt == c2v::kF32 ? 1 : n_units);  // a stage's
  uint32_t a0[4][4], a1[4][4], l0[4][4], l1[4][4];

  for (int64_t i = wg; i < my_tiles; i += kWarpgroups) {
    const int64_t t0 = (tile0 + i) * kTileRows;
    const int64_t v0 = t0 + r0, v1 = v0 + 8;
    // the rows' scales, loaded before the products hide their latency
    float sc0 = 1.f, sc1 = 1.f;
    if (kScaled) {
      sc0 = v0 < P.v_rows ? __ldg(P.scales + v0) : 0.f;
      sc1 = v1 < P.v_rows ? __ldg(P.scales + v1) : 0.f;
    }
    // unit u: wait for its stage, decode, give the stage back after its
    // last unit, then the products. The stage goes back only once the
    // loads that read it have returned: every lane's decoded registers
    // feed the arrive (an OR over the warp, then mbar_arrive_after), so
    // it cannot issue before them. A plain arrive after the decode let a
    // refill overwrite rows a warp had not read yet: rows 8-15 and 24-31
    // of a tile came out wrong in up to 999 calls of 1,000
    // (scripts/repeat_topk_large_k.py). The units before a stage's last
    // one issued their products, so their registers had arrived.
    auto unit = [&](int u, uint32_t (&a)[4][4], uint32_t (&l)[4][4]) {
      const int sl = u / ups;
      const int64_t seq = i / kWarpgroups * spt + sl;
      const int slot = wg * S2 + static_cast<int>(seq % S2);
      if (u % ups == 0) mbar_wait(&full[slot], (seq / S2) & 1);
      const uint8_t* st = smem + L.stage + slot * L.stage_bytes;
      if constexpr (kF32) {
        const int box = u % ups;  // the stage's first or second box
        decode_tf32(st + box * kF32Box, r0, q,
                    sl * kF32Slice + 32 * box + 8 * q < d, a, l);
      } else if constexpr (kFmt == c2v::kF32) {
        decode_bf16_box(st + (q / 2) * kF32Box, r0, 4 * (q % 2),
                        sl * kF32Slice + 16 * q < d, a);
      } else {
        const int col = u * 64 + 16 * q;  // first value of the thread's 16
        const int off = kFmt == c2v::kInt4 ? col / 2 : col;
        decode_bf16<kFmt>(st + r0 * rb + off, st + (r0 + 8) * rb + off,
                          col < d, a);
      }
      if (u % ups == ups - 1 || u == n_units - 1) {
        uint32_t dep = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) dep |= a[s][e] | (kF32 ? l[s][e] : 0u);
        dep = __reduce_or_sync(c2v::kFullMask, dep);
        if (lane == 0) mbar_arrive_after(&empty[slot], dep, P.b_rows);
      }
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t bo = sb + u * N * 128 + s * 32;
        if constexpr (kF32) {
          const uint64_t bh = desc(bo, 16, 1024);
          const uint64_t bl = desc(bo + static_cast<uint32_t>(L.b_lo), 16, 1024);
          wgmma_tf32_rs(acc, a[s], bl, u > 0 || s > 0);
          wgmma_tf32_rs(acc, l[s], bh, 1);
          wgmma_tf32_rs(acc, a[s], bh, 1);
        } else {
          wgmma_bf16_rs(acc, a[s], desc(bo, 16, 1024), u > 0 || s > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // unit u - 1 is done: its registers are free
    };
    for (int u = 0; u < n_units; u += 2) {
      unit(u, a0, l0);
      if (u + 1 < n_units) unit(u + 1, a1, l1);
    }
    wgmma_wait<0>();

    // ---- the fold, on the accumulators
    const bool live0 = v0 < live_end, live1 = v1 < live_end;
    // this tile's queue count (the other parity's is reset below)
    const int par = wg * 2 + static_cast<int>(i / kWarpgroups % 2);
    // Branch-free over the columns: scale and mask, the streaming
    // logsumexp with the reference's nonfinite guard (the running max
    // starts finite, so no inf - inf), and a bit per logit that may beat
    // its list's last entry (the candidate note above Params).
    uint32_t cand = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * j + h;
        float x0 = acc[4 * j + h], x1 = acc[4 * j + 2 + h];
        if (kScaled) x0 *= sc0, x1 *= sc1;
        if (!live0) x0 = -INFINITY;
        if (!live1) x1 = -INFINITY;
        acc[4 * j + h] = x0, acc[4 * j + 2 + h] = x1;
        const float y0 = live0 ? (isfinite(x0) ? x0 : kLseFloor) : -INFINITY;
        const float y1 = live1 ? (isfinite(x1) ? x1 : kLseFloor) : -INFINITY;
        const float mt = fmaxf(fmaxf(y0, y1), run_m[c]);
        run_s[c] = run_s[c] * ex2((run_m[c] - mt) * kLog2e) +
                   ex2((y0 - mt) * kLog2e) + ex2((y1 - mt) * kLog2e);
        run_m[c] = mt;
        cand |= static_cast<uint32_t>(!(x0 <= thr[c])) << (2 * c);
        cand |= static_cast<uint32_t>(!(x1 <= thr[c])) << (2 * c + 1);
      }
    // live rows only: bit 2 c is row r0's, bit 2 c + 1 row r0 + 8's
    cand = (cand | cold_cols) & open_cols &
           ((live0 ? 0x55555555u : 0u) | (live1 ? 0xAAAAAAAAu : 0u));
    if (cand != 0 && P.scores == nullptr) {
      if (cand & cold_cols) {
        // a list not yet full: the whole tile goes through the logits
        // buffer
        atomicAdd(counts + par, kQueue + 1);
      } else {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (!((cand >> (2 * (2 * j + h) + r)) & 1u)) continue;
              const int slot = atomicAdd(counts + par, 1);
              if (slot < kQueue)
                qv[slot] = acc[4 * j + 2 * r + h],
                qi[slot] = (8 * j + 2 * q + h) << 6 | (r0 + 8 * r);
            }
      }
    }
    if (P.scores != nullptr) {  // large-k mode: every logit to the scores
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = b0 + 8 * j + 2 * q + h;
          if (b >= P.b_rows) continue;
          float* row = P.scores + static_cast<int64_t>(b) * P.sld;
          if (v0 < P.v_rows) row[v0] = acc[4 * j + h];
          if (v1 < P.v_rows) row[v1] = acc[4 * j + 2 + h];
        }
      continue;
    }
    // Two barriers: between them every thread reads this tile's count and
    // one resets the other parity's, which the next tile counts in.
    named_sync(2 + wg, 128);
    const int qn = *reinterpret_cast<volatile int*>(counts + par);
    if (wtid == 0) counts[par ^ 1] = 0;
    named_sync(2 + wg, 128);
    if (qn == 0) continue;
    if (qn <= kQueue) {
      // the queued candidates, each warp inserting its columns' (c % 4)
      for (int base = 0; base < qn; base += 32) {
        const int e = base + lane;
        float x = -INFINITY;
        int packed = 0;
        if (e < qn) x = qv[e], packed = qi[e];
        unsigned ballot = __ballot_sync(c2v::kFullMask,
                                        e < qn && ((packed >> 6) & 3) == warp);
        while (ballot) {
          const int src = __ffs(ballot) - 1;
          ballot &= ballot - 1;
          const float cx = __shfl_sync(c2v::kFullMask, x, src);
          const int cp = __shfl_sync(c2v::kFullMask, packed, src);
          const int ci = static_cast<int>(t0) + (cp & 63);
          float* clv = lv + (cp >> 6) * k;
          int* cli = li + (cp >> 6) * k;
          if (c2v::topk_before(cx, ci, clv[k - 1], cli[k - 1]))
            c2v::warp_topk_insert(clv, cli, k, cx, ci, lane);
        }
      }
    } else {
      // many candidates (a list's first tiles): the tile's logits through
      // the logits buffer, a warp per code vector
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* col = lg + (8 * j + 2 * q + h) * kLogitLd;
          col[r0] = acc[4 * j + h];
          col[r0 + 8] = acc[4 * j + 2 + h];
        }
      named_sync(2 + wg, 128);
      for (int c = warp; c < N && b0 + c < P.b_rows; c += 4)
        fold_column(lg + c * kLogitLd, t0, live_end, lv + c * k, li + c * k,
                    k, sv, si, lane);
    }
    named_sync(2 + wg, 128);
    cold_cols = 0;
    open_cols = valid_cols;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * j + h;
        thr[c] = lv[(8 * j + 2 * q + h) * k + k - 1];
        if (thr[c] == -INFINITY) cold_cols |= 3u << (2 * c);
        if (isnan(thr[c])) open_cols &= ~(3u << (2 * c));
      }
  }

  // ---- this warpgroup's partial: (max, sumexp) over its 32 threads per
  // code vector (lanes of one q in a warp, then the four warps), lists
  const int n_parts = kWarpgroups * P.runs;
  const int part = run * kWarpgroups + wg;
  named_sync(2 + wg, 128);  // the logits buffer is free
  float* red = lg;          // [warp][N] maxima, then [warp][N] sums
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * j + h;
      float m = run_m[c], s = run_s[c];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float m2 = __shfl_xor_sync(c2v::kFullMask, m, off);
        const float s2 = __shfl_xor_sync(c2v::kFullMask, s, off);
        c2v::lse_combine(m, s, m2, s2);
      }
      if (lane < 4) {
        red[warp * N + 8 * j + 2 * q + h] = m;
        red[4 * N + warp * N + 8 * j + 2 * q + h] = s;
      }
    }
  named_sync(2 + wg, 128);
  for (int c = wtid; c < N; c += 128) {
    if (b0 + c >= P.b_rows) continue;
    float m = red[c], s = red[4 * N + c];
    for (int w = 1; w < 4; ++w)
      c2v::lse_combine(m, s, red[w * N + c], red[4 * N + w * N + c]);
    if (s == 0.f) m = -INFINITY;  // no live row: the floor was never left
    const int64_t o = static_cast<int64_t>(b0 + c) * n_parts + part;
    P.part_max[o] = m;
    P.part_sum[o] = s;
  }
  for (int e = wtid; e < N * k; e += 128) {
    const int c = e / k, j = e % k;
    if (b0 + c >= P.b_rows) continue;
    const int64_t o = (static_cast<int64_t>(b0 + c) * n_parts + part) * k + j;
    P.part_vals[o] = lv[e];
    P.part_idx[o] = li[e];
  }
}

// One warp per code vector: copy its partial lists into shared memory
// (independent, coalesced loads), then merge them and their logsumexps.
__global__ void __launch_bounds__(32)
topk_merge_kernel(const float* part_vals, const int* part_idx,
                  const float* part_max, const float* part_sum,
                  int64_t n_chunks, int k, float* out_vals, int* out_idx,
                  float* out_lse) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t n = n_chunks * k;
  float* cand_v = reinterpret_cast<float*>(smem);
  int* cand_i = reinterpret_cast<int*>(cand_v + n);
  float* lv = reinterpret_cast<float*>(cand_i + n);
  int* li = reinterpret_cast<int*>(lv + kMaxK);
  const int b = blockIdx.x, lane = threadIdx.x;
  const float* pv = part_vals + b * n;
  const int* pi = part_idx + b * n;
  for (int64_t e = lane; e < n; e += 32) {
    cand_v[e] = pv[e];
    cand_i[e] = pi[e];
  }
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = c2v::kEmptyIndex;
  }
  float m = -INFINITY, s = 0.f;
  for (int64_t c = lane; c < n_chunks; c += 32)
    c2v::lse_combine(m, s, part_max[b * n_chunks + c],
                     part_sum[b * n_chunks + c]);
  c2v::warp_lse_reduce(m, s);
  __syncwarp();

  for (int64_t e0 = 0; e0 < n; e0 += 32) {
    const int64_t e = e0 + lane;
    float x = -INFINITY;
    int xi = c2v::kEmptyIndex;
    if (e < n) {
      x = cand_v[e];
      xi = cand_i[e];
    }
    unsigned ballot = __ballot_sync(
        c2v::kFullMask,
        xi != c2v::kEmptyIndex && c2v::topk_before(x, xi, lv[k - 1], li[k - 1]));
    while (ballot) {
      const int srcl = __ffs(ballot) - 1;
      ballot &= ballot - 1;
      const float cx = __shfl_sync(c2v::kFullMask, x, srcl);
      const int ci = __shfl_sync(c2v::kFullMask, xi, srcl);
      c2v::warp_topk_insert(lv, li, k, cx, ci, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    out_vals[static_cast<int64_t>(b) * k + j] = lv[j];
    out_idx[static_cast<int64_t>(b) * k + j] =
        li[j] == c2v::kEmptyIndex ? 0 : li[j];
  }
  if (lane == 0)
    out_lse[b] = isfinite(m) ? logf(fmaxf(s, 1e-30f)) + m : m;
}

// Whether the kernel takes a table of format `fmt` and width d: rows of
// whole 16-byte vectors, d a multiple of 16 (int4: 32), int8 and fp8 rows
// up to 512 wide, int4 up to 1024 (kernels/topk.py checks the same).
bool takes(int fmt, int d) {
  if (d <= 0 || d % 16 != 0) return false;
  switch (fmt) {
    case c2v::kF32: return true;
    case c2v::kInt8: case c2v::kE4M3: case c2v::kE5M2: return d <= 512;
    case c2v::kInt4: return d % 32 == 0 && d <= 1024;
    default: return false;
  }
}

template <int kFmt, bool kF32, int N>
cudaError_t launch_n(const Params& p, int grid, int64_t smem, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<kFmt, kF32, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  topk_partial_kernel<kFmt, kF32, N><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int kFmt, bool kF32>
cudaError_t launch_fmt(const Params& p, int n, int grid, int64_t smem,
                       cudaStream_t s) {
  switch (n) {
    case 8: return launch_n<kFmt, kF32, 8>(p, grid, smem, s);
    case 16: return launch_n<kFmt, kF32, 16>(p, grid, smem, s);
    case 32: return launch_n<kFmt, kF32, 32>(p, grid, smem, s);
    default:
      if constexpr (kF32) return cudaErrorInvalidValue;
      else return launch_n<kFmt, kF32, 64>(p, grid, smem, s);
  }
}

}  // namespace

// Dynamic shared memory of one partial-pass CTA (the layout's total), for
// kernels/topk.py `plan` to choose the N tile and the ring's depth.
C2V_EXPORT int64_t c2v_topk_smem(int fmt, int compute_f32, int d, int k,
                                 int n_tile, int stages) {
  return layout(fmt, compute_f32 != 0, d, k, n_tile, stages).total;
}

// cv: f32 (b, d). table of format `fmt` (c2v::TableFormat): f32 (v, d)
// with scales null, or int8, e4m3, e5m2 (v, d bytes) or int4 (v, d / 2
// bytes) with f32 (v,) scales. compute_f32: 0 rounds both operands to
// bf16, 1 multiplies the f32 operands by 3xTF32 (f32 tables only).
// Plan (kernels/topk.py `plan`): n_tile code vectors a CTA (8, 16, 32,
// 64; 32 at most in the float32 mode), `runs` runs of table tiles,
// `stages` ring stages (2 or 4); the grid is runs x ceil(b / n_tile)
// CTAs.
// Partials: (b, 2 runs, k) values/indices and (b, 2 runs) max/sumexp.
// Outputs: values f32 (b, k), indices int32 (b, k), lse f32 (b,).
// Large-k mode: `scores` f32 (b, scores_ld), scores_ld >= v, receives
// every logit and k is 0 (no lists, no values or indices; lse only).
C2V_EXPORT int c2v_blockwise_topk(const float* cv, int b, int d,
                                  const void* table, const float* scales,
                                  int fmt, int compute_f32, int64_t v,
                                  int64_t valid_rows, int k, int n_tile,
                                  int runs, int stages, float* part_vals,
                                  int* part_idx, float* part_max,
                                  float* part_sum, float* out_vals,
                                  int* out_idx, float* out_lse,
                                  float* scores, int64_t scores_ld,
                                  void* stream) {
  const bool f32 = compute_f32 != 0;
  if (b <= 0 || v <= 0 || k < 0 || k > kMaxK ||
      (k == 0) != (scores != nullptr) ||
      (scores != nullptr && scores_ld < v) || runs <= 0 ||
      (stages != 2 && stages != 4) || !takes(fmt, d) ||
      (f32 && fmt != c2v::kF32) ||
      !(n_tile == 8 || n_tile == 16 || n_tile == 32 ||
        (n_tile == 64 && !f32)))
    return cudaErrorInvalidValue;
  const int n_b = (b + n_tile - 1) / n_tile;
  const int64_t grid64 = static_cast<int64_t>(runs) * n_b;
  if (grid64 > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(grid64);
  Params p{{}, cv, b, d, static_cast<const unsigned char*>(table), scales,
           v, valid_rows, k, n_b, runs, stages, part_vals, part_idx,
           part_max, part_sum, scores, scores_ld};
  const int64_t smem = layout(fmt, f32, d, k, n_tile, stages).total;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fmt == c2v::kF32 &&
      (err = f32_rows_map(&p.tmap, static_cast<const float*>(table), v, d,
                          kTileRows)) != cudaSuccess)
    return err;
  if (f32) {
    err = launch_fmt<c2v::kF32, true>(p, n_tile, grid, smem, s);
  } else {
    switch (fmt) {
      case c2v::kF32: err = launch_fmt<c2v::kF32, false>(p, n_tile, grid, smem, s); break;
      case c2v::kInt8: err = launch_fmt<c2v::kInt8, false>(p, n_tile, grid, smem, s); break;
      case c2v::kE4M3: err = launch_fmt<c2v::kE4M3, false>(p, n_tile, grid, smem, s); break;
      case c2v::kE5M2: err = launch_fmt<c2v::kE5M2, false>(p, n_tile, grid, smem, s); break;
      default: err = launch_fmt<c2v::kInt4, false>(p, n_tile, grid, smem, s); break;
    }
  }
  if (err != cudaSuccess) return err;
  const int64_t n_parts = static_cast<int64_t>(kWarpgroups) * runs;
  const int64_t merge_smem = 8 * n_parts * k + 8 * kMaxK;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<b, 32, merge_smem, s>>>(part_vals, part_idx, part_max,
                                              part_sum, n_parts, k, out_vals,
                                              out_idx, out_lse);
  return cudaGetLastError();
}
