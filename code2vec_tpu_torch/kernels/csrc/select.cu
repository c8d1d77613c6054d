// K13 select_topk: the top k of each row of an f32 score matrix, for any
// k up to the row's length, ordered as `lax.top_k` orders them: NaN above
// everything, then by value descending, equal values by ascending
// position.
//
// The large-k mode of K3 (code2vec_tpu/ops/topk.py blockwise_matmul_top_k
// :99-179, and its float32 use in retrieval/index.py `_search_brute`
// :306) and of K11 (retrieval/index.py `_search_ivf` :319-349,
// retrieval/mips.py `MipsHead.topk_fn` :139-188): those kernels keep a
// list of at most 64 entries in shared memory, so for a larger k they
// write every candidate's f32 score (K3: each table row's logit; K11:
// each probed list's rows, at the reference's padded candidate
// positions) and this kernel selects from them. The reference's
// `lax.top_k` takes any k.
//
// What bounds it on an H100: bytes. The least time counts one read of the
// scores and one write of the k results per row. Design, an adaptive
// radix select on 11-bit digits (after AIR Top-k, Zhang et al., SC'23):
// a memset of the rows' counts, then three launches, a fourth where a
// slice is wider than its candidate buffer and a fifth for k > 1024.
//   Every element is ranked by a unique 64-bit key: its order-preserving
//   uint32 score key (a larger float has a larger key, every NaN the
//   largest, -0 taken as +0) above its inverted position, so the top k
//   are exactly the k largest keys and `lax.top_k`'s tie rule (equal
//   values by ascending position) needs no pass of its own, whichever
//   slice a tie falls in.
//   (1) hist: each row is cut into slices of whole 16-byte groups, a CTA
//       a (row, slice), as many as fill the card's resident CTAs in one
//       wave (a second, partial wave would leave SMs idle), for B 1 as
//       for B 64. A CTA counts its slice's first digits (the score key's
//       top 11 bits) in a shared-memory histogram, the lanes that share
//       lane 0's digit adding once, and adds its counts to the row's with
//       integer atomics. The row's last CTA to finish (a ticket) picks
//       the digit d0 at which the count from the top reaches k.
//   (2) filter: a second read of the slices. Keys whose first digit is
//       above d0 are winners, keys of digit d0 candidates (where d0's
//       whole bin is wanted, winners too); a CTA appends each to its
//       slice's own region (one shared atomic a warp: no CTA waits on a
//       global counter), keeping at most `cap` candidates, and leaves
//       the two counts (past `cap` the candidate count stops: the
//       slice overflowed).
//   (R) refine, only where a slice is wider than its buffer, a CTA a
//       (row, slice) again; a CTA of a row that did not overflow returns
//       at once. An overflowed row (few distinct values, one 11-bit bin)
//       is refined by all its CTAs together: digit passes over the
//       remaining 21 key bits and the position bits of its d0 keys, each
//       a read of the slices, their counts merged into the row's, the
//       row's last CTA picking the digit while the others wait for it
//       (the launch is cooperative, so a row's CTAs are all resident),
//       until the chosen digit's count is what is still wanted; then a
//       last read appends the d0 keys at or above that prefix to the
//       slices' winners.
//   (3) finish, a CTA a row (a programmatic dependent launch, launched
//       while the one before ends): the slices' winners gathered into the
//       row's list; for a row that did not overflow, the rest from the
//       buffered candidates alone, by the same digit passes, each a
//       shared-memory histogram and a pick, then the candidates at or
//       above the prefix appended. For k <= 1024 it then sorts the k
//       winners by key, descending (a bitonic network over registers,
//       shared memory and warp shuffles).
//   (4) sort, for k > 1024: a CTA a row sorts its k winners (bitonic, in
//       shared memory for k <= 16384, else in place in the winners'
//       scratch row).
// The small-width mode, rows of at most 128 columns (the merge of the tp
// x k candidates of a tensor-parallel top-k, ops/sharded.py tp_top_k),
// where the passes above are all overhead: one launch, a warp a row, its
// lane l holding candidates l, l + 32, l + 64 and l + 96 by their unique
// keys; a candidate's rank is the count of the row's keys above its own
// (every key passed round by warp shuffles), and one of rank r < k
// writes its value and position (or id) at slot r. No memset, no
// scratch, no atomic: exact, and the same on every run. Its merge entry
// reads the tp all-gathered (tp, B, k_local) values and ids in place,
// candidate j of rank part p at flat position p k_local + j (the
// reference's rank-major order, whose ties `lax.top_k` breaks by that
// position), and writes the ids themselves.
// Values are read back from the scores, so the output keeps each score's
// bits. The rows' counts are integers and the winners' keys unique, so
// the result is the same on every run, though the order in which CTAs
// append is not.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;    // a CTA of (1)-(3)
constexpr int kCtasPerSm = 3;    // resident on an SM (select.plan cuts a
                                 // row's slices to fill one such wave)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;       // 16-byte loads a thread has in flight
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr int kTopShift = 32 - kDigitBits;  // the first digit's shift
constexpr uint32_t kLowMask = (1u << kTopShift) - 1u;
constexpr int kFusedSort = 2 * kThreads;  // k up to this: sorted in (3)
constexpr int kSortThreads = 1024;
constexpr int kSortSmem = 16384;  // winners sorted in shared memory
// a row's state words, after its kBins first-digit counts
enum { kD0, kAbove0, kBin0, kTicket, kStateWords = 4 };
// (R)'s words of a row, after its kBins counts of a pass: its ticket, the
// passes done and the last pass's pick
enum { kRTicket, kRPasses, kRPick, kRefineWords = 8 };
constexpr int kMaxSlices = 1024;  // a row's slices, at most
constexpr int kRowWords = kBins + kStateWords;
constexpr int kRefineRow = kBins + kRefineWords;

__device__ __forceinline__ uint32_t score_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ u64 full_key(uint32_t key, int pos) {
  return (static_cast<u64>(key) << 32) |
         static_cast<u64>(~static_cast<uint32_t>(pos));
}

__device__ __forceinline__ uint32_t warp_incl_scan(uint32_t v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(c2v::kFullMask, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// One count of `digit` into the shared histogram `h` where `live`. The
// lanes that share lane 0's digit add once, by lane 0 (a row of few
// distinct values, or one bin, would otherwise serialise 32 lanes on one
// address); the others add their own, all in one atomic instruction.
// Every lane must call it.
__device__ __forceinline__ void count_digit(uint32_t* h, uint32_t digit,
                                            bool live, int lane) {
  const uint32_t tag = live ? digit : 0xffffffffu;
  const uint32_t lead = __shfl_sync(c2v::kFullMask, tag, 0);
  const unsigned same = __ballot_sync(c2v::kFullMask, tag == lead);
  const uint32_t add = lane == 0 ? __popc(same) : tag != lead;
  if (live && add != 0u) atomicAdd(&h[digit], add);
}

// Appends `v` where `take` to buf at slots counted by *counter, one
// atomic a warp; slots at or past `cap` are not written, and once the
// count is past `cap` it stops (it stays above cap). Every lane must call
// it.
__device__ __forceinline__ void warp_append(bool take, u64 v,
                                            uint32_t* counter, u64* buf,
                                            int lane, uint32_t cap) {
  const unsigned m = __ballot_sync(c2v::kFullMask, take);
  if (m == 0 || *static_cast<volatile uint32_t*>(counter) > cap) return;
  const int leader = __ffs(m) - 1;
  uint32_t base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(c2v::kFullMask, base, leader);
  const uint32_t slot = base + __popc(m & ((1u << lane) - 1u));
  if (take && slot < cap) buf[slot] = v;
}

// The digit d of the kBins counts h (a larger digit ranks higher) at
// which the count from the top reaches `want` (1 <= want <= the total):
// out = {d, the count of larger digits, h[d]}. A thread scans 4 digits.
__device__ void choose_digit(const uint32_t* h, uint32_t want,
                             uint32_t* red, uint32_t* out) {
  static_assert(kBins == 4 * kThreads, "four digits a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t c[4], sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = h[kBins - 1 - (4 * tid + j)];
    sum += c[j];
  }
  const uint32_t incl = warp_incl_scan(sum, lane);
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  uint32_t run = incl - sum;
  for (int w = 0; w < warp; ++w) run += red[w];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (run < want && want <= run + c[j]) {
      out[0] = kBins - 1 - (4 * tid + j);
      out[1] = run;
      out[2] = c[j];
    }
    run += c[j];
  }
  __syncthreads();
}

// f(live, key, pos) for every position of [lo, hi) of row x (lo a
// multiple of 4), kUnroll 16-byte loads a thread in flight; every thread
// of the CTA calls f the same number of times. Where `any` is given, a
// group of 4 goes to f only where any(live, key, pos) holds for one of
// the warp's 128 elements (their f would be a no-op otherwise).
template <typename F, typename A>
__device__ __forceinline__ void visit_row(const float* x, int lo, int hi,
                                          F&& f, A&& any) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const int lo4 = lo / 4, hi4 = (hi + 3) / 4;
  for (int b4 = lo4; b4 < hi4; b4 += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i4 = b4 + u * kThreads + threadIdx.x;
      v[u] = i4 < hi4 ? x4[i4] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i4 = b4 + u * kThreads + threadIdx.x;
      const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      uint32_t key[4];
      bool live[4], hit = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        key[q] = score_key(e[q]);
        live[q] = i4 < hi4 && 4 * i4 + q < hi;
        hit |= any(live[q], key[q], 4 * i4 + q);
      }
      if (!__any_sync(c2v::kFullMask, hit)) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) f(live[q], key[q], 4 * i4 + q);
    }
  }
}

template <typename F>
__device__ __forceinline__ void visit_row(const float* x, int lo, int hi,
                                          F&& f) {
  visit_row(x, lo, hi, f, [](bool, uint32_t, int) { return true; });
}

// True in every thread of the CTA that finishes the row last.
__device__ __forceinline__ bool last_of_row(uint32_t* ticket, bool* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1u) == gridDim.y - 1;
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

// (1) a CTA a (row, slice): the slice's first-digit counts into the
// row's; the row's last CTA picks d0
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
select_hist_kernel(const float* scores, int64_t ld, int n, int k, int slice,
                   uint32_t* state) {
  __shared__ uint32_t h[kBins];
  __shared__ uint32_t red[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t row = blockIdx.x;
  uint32_t* rs = state + row * kRowWords;
  for (int i = tid; i < kBins; i += kThreads) h[i] = 0u;
  __syncthreads();
  const int lo = blockIdx.y * slice, hi = min(lo + slice, n);
  visit_row(scores + row * ld, lo, hi, [&](bool live, uint32_t key, int) {
    count_digit(h, key >> kTopShift, live, lane);
  });
  __syncthreads();
  for (int i = tid; i < kBins; i += kThreads)
    if (h[i] != 0u) atomicAdd(&rs[i], h[i]);
  if (!last_of_row(&rs[kBins + kTicket], &last)) return;
  for (int i = tid; i < kBins; i += kThreads) h[i] = __ldcg(&rs[i]);
  __syncthreads();
  choose_digit(h, static_cast<uint32_t>(k), red, &rs[kBins + kD0]);
}

// The k winners (a row's scratch `win`, sort_len <= kFusedSort) sorted
// by key, descending, by the CTA of (3): a bitonic network over entries
// tid and tid + kThreads held in registers, a stage of stride kThreads
// within a thread, one of stride 32..kThreads/2 through the shared
// `buf`, one below 32 across a warp's lanes; then each value read back
// from the scores. sort_len >= 32, so whole warps hold entries or none.
__device__ void sort_winners(const u64* win, int k, int sort_len, u64* buf,
                             const float* x, float* out_vals, int* out_pos) {
  const int tid = threadIdx.x;
  const int per = sort_len > kThreads ? 2 : 1;
  const bool holds = tid < sort_len;
  u64 v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads;
    v[j] = j < per && i < k ? win[i] : 0ull;  // real keys are > 0
  }
  for (int size = 2; size <= sort_len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kThreads) {  // entries tid and tid + kThreads
        const bool up = (tid & size) == 0;
        if ((v[0] < v[1]) == up) {
          const u64 t = v[0];
          v[0] = v[1];
          v[1] = t;
        }
      } else if (stride >= 32) {
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (holds && j < per) buf[tid + j * kThreads] = v[j];
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = tid + j * kThreads;
          if (holds && j < per) {
            const u64 o = buf[i ^ stride];
            const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
            v[j] = keep_max ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
          }
        }
      } else if (holds) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = tid + j * kThreads;
          const u64 o = __shfl_xor_sync(c2v::kFullMask, v[j], stride);
          const bool keep_max = ((i & stride) == 0) == ((i & size) == 0);
          if (j < per)
            v[j] = keep_max ? (v[j] > o ? v[j] : o) : (v[j] < o ? v[j] : o);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads;
    if (j < per && i < k) {
      const int pos = static_cast<int>(~static_cast<uint32_t>(v[j]));
      out_pos[i] = pos;
      out_vals[i] = x[pos];
    }
  }
}

// The row state that (1) leaves for (2), (R) and (3).
struct RowPick {
  uint32_t d0, above0, bin0, want0;
  bool take_all;
};

__device__ __forceinline__ RowPick row_pick(const uint32_t* rs, int k) {
  RowPick p;
  p.d0 = rs[kD0];
  p.above0 = rs[kAbove0];
  p.bin0 = rs[kBin0];
  p.want0 = static_cast<uint32_t>(k) - p.above0;
  p.take_all = p.bin0 == p.want0;
  return p;
}

// Where a (row, slice) of (2) leaves its winners (wcap = min(k, slice)
// entries, all it can hold) and its candidates (`cap` entries, the rest
// counted but not kept).
struct SliceOut {
  u64* wins;      // (rows, slices, wcap)
  u64* cands;     // (rows, slices, cap)
  uint32_t* cnt;  // (rows, slices, 2): winners, candidates
  int slices, wcap, cap;
};

// (2) a CTA a (row, slice): the slice's winners and candidates, appended
// to its own regions by shared counters (no CTA waits on another's
// atomics), their counts left for (R) and (3) (a candidate count past
// `cap` stops there: the slice overflowed)
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
select_filter_kernel(const float* scores, int64_t ld, int n, int k,
                     int slice, const uint32_t* state, SliceOut o) {
  __shared__ uint32_t s_w, s_c;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t row = blockIdx.x;
  const int64_t at = row * o.slices + blockIdx.y;
  u64* win = o.wins + at * o.wcap;
  u64* cand = o.cands + at * o.cap;
  const uint32_t cap = static_cast<uint32_t>(o.cap);
  const RowPick p = row_pick(state + row * kRowWords + kBins, k);
  if (tid == 0) s_w = 0u, s_c = 0u;
  __syncthreads();
  const int lo = blockIdx.y * slice, hi = min(lo + slice, n);
  visit_row(
      scores + row * ld, lo, hi,
      [&](bool live, uint32_t key, int pos) {
        const uint32_t dg = key >> kTopShift;
        const u64 fk = full_key(key, pos);
        warp_append(live && (dg > p.d0 || (p.take_all && dg == p.d0)), fk,
                    &s_w, win, lane, ~0u);
        if (!p.take_all)  // uniform over the CTA
          warp_append(live && dg == p.d0, fk, &s_c, cand, lane, cap);
      },
      [&](bool live, uint32_t key, int) {
        return live && (key >> kTopShift) >= p.d0;
      });
  __syncthreads();
  if (tid == 0) {
    o.cnt[2 * at] = s_w;
    o.cnt[2 * at + 1] = s_c;
  }
}

// R, the key bits the passes after the first digit sort on: the key's low
// 21 bits above the position's inverted low pos_bits bits (unique among
// the keys of one first digit).
__device__ __forceinline__ u64 rest_key(uint32_t key, uint32_t inv_pos,
                                        int pos_bits) {
  const uint32_t pos_mask =
      pos_bits >= 32 ? 0xffffffffu : (1u << pos_bits) - 1u;
  return (static_cast<u64>(key & kLowMask) << pos_bits) | (inv_pos & pos_mask);
}

// The digit passes over R that (R) and (3) share: top, R's bits not yet
// fixed; prefix, those fixed; want, the keys still wanted at or above it.
struct Passes {
  int top;
  u64 prefix;
  uint32_t want;
  __device__ int width() const { return min(kDigitBits, top); }
  __device__ uint32_t digit(u64 r) const {
    return static_cast<uint32_t>(r >> (top - width())) &
           ((1u << width()) - 1u);
  }
  __device__ bool live(u64 r) const { return (r >> top) == prefix; }
  // after a pass picked {digit, count of larger digits, its count}: true
  // where the chosen digit's keys are all wanted (or R is used up)
  __device__ bool take(const uint32_t* pick) {
    const int w = width();
    prefix = (prefix << w) | pick[0];
    want -= pick[1];
    top -= w;
    return pick[2] == want || top == 0;
  }
};

// (R), by every CTA of a row whose candidates overflowed a slice's buffer
// (all resident: a cooperative launch, or one CTA a row): the row's d0
// keys refined by digit passes over R, each CTA reading its slice
// [lo, hi) of row x, the counts merged into the row's `rs` by integer
// atomics and each digit picked by the row's last CTA while the others
// wait for it; then the slice's d0 keys at or above the final prefix
// appended to its winners `win`, their count `*win_count` updated. h, red,
// pick, last and s_w are the CTA's shared words.
__device__ __forceinline__ void refine_row(
    const float* x, int lo, int hi, int pos_bits, const RowPick& p,
    uint32_t* rs, uint32_t* h, uint32_t* red, uint32_t* pick, bool* last,
    uint32_t* s_w, u64* win, uint32_t* win_count) {
  const int tid = threadIdx.x, lane = tid & 31;
  Passes ps{kTopShift + pos_bits, 0ull, p.want0};
  auto rest = [&](uint32_t key, int pos) {
    return rest_key(key, ~static_cast<uint32_t>(pos), pos_bits);
  };
  auto d0_key = [&](bool live, uint32_t key, int) {
    return live && (key >> kTopShift) == p.d0;
  };
  for (uint32_t pass = 0;; ++pass) {
    for (int i = tid; i < kBins; i += kThreads) h[i] = 0u;
    __syncthreads();
    visit_row(
        x, lo, hi,
        [&](bool live, uint32_t key, int pos) {
          const u64 r = rest(key, pos);
          count_digit(h, ps.digit(r), d0_key(live, key, pos) && ps.live(r),
                      lane);
        },
        d0_key);
    __syncthreads();
    for (int i = tid; i < kBins; i += kThreads)
      if (h[i] != 0u) atomicAdd(&rs[i], h[i]);
    if (last_of_row(&rs[kBins + kRTicket], last)) {
      // every CTA of the row has added its counts: pick, zero the counts
      // and the ticket for the next pass, then let the others go on
      for (int i = tid; i < kBins; i += kThreads) {
        h[i] = __ldcg(&rs[i]);
        rs[i] = 0u;
      }
      __syncthreads();
      choose_digit(h, ps.want, red, pick);
      if (tid == 0) {
        for (int j = 0; j < 3; ++j) rs[kBins + kRPick + j] = pick[j];
        rs[kBins + kRTicket] = 0u;
        __threadfence();
        atomicAdd(&rs[kBins + kRPasses], 1u);
      }
    } else if (tid == 0) {
      while (static_cast<const volatile uint32_t*>(rs)[kBins + kRPasses] <=
             pass) {
      }
      __threadfence();
      for (int j = 0; j < 3; ++j) pick[j] = __ldcg(&rs[kBins + kRPick + j]);
    }
    __syncthreads();
    if (ps.take(pick)) break;
  }
  if (tid == 0) *s_w = *win_count;
  __syncthreads();
  visit_row(
      x, lo, hi,
      [&](bool live, uint32_t key, int pos) {
        warp_append(
            d0_key(live, key, pos) && (rest(key, pos) >> ps.top) >= ps.prefix,
            full_key(key, pos), s_w, win, lane, ~0u);
      },
      d0_key);
  __syncthreads();
  if (tid == 0) *win_count = *s_w;
}

// (R) a CTA a (row, slice), launched where a slice is wider than its
// buffer: a row none of whose slices overflowed returns at once; the
// CTAs of any other refine it together (refine_row)
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
select_refine_kernel(const float* scores, int64_t ld, int n, int k,
                     int slice, int pos_bits, const uint32_t* state,
                     uint32_t* refine, SliceOut o) {
  __shared__ uint32_t h[kBins];
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t pick[3];
  __shared__ uint32_t s_w;
  __shared__ bool last;
  const int64_t row = blockIdx.x;
  bool over = false;
  for (int sl = threadIdx.x; sl < o.slices; sl += kThreads)
    over |= o.cnt[2 * (row * o.slices + sl) + 1] >
            static_cast<uint32_t>(o.cap);
  if (!__syncthreads_or(over)) return;
  const int64_t at = row * o.slices + blockIdx.y;
  const int lo = blockIdx.y * slice;
  refine_row(scores + row * ld, lo, min(lo + slice, n), pos_bits,
             row_pick(state + row * kRowWords + kBins, k),
             refine + row * kRefineRow, h, red, pick, &last, &s_w,
             o.wins + at * o.wcap, &o.cnt[2 * at]);
}

// The slice of a row's region list that holds its entry i, by the
// exclusive prefix `pre` of the slices' counts (pre[slices] the total).
__device__ __forceinline__ int slice_of(const uint32_t* pre, int slices,
                                        uint32_t i) {
  int lo = 0, hi = slices - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pre[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// (3) a CTA a row: the slices' winners gathered into the row's list (all
// k of them where (R) refined the row); for a row that did not overflow,
// the rest of the winners from the buffered candidates (keys of first
// digit d0) by digit passes over R; then, for k <= kFusedSort, the
// winners sorted
__global__ void __launch_bounds__(kThreads)
select_finish_kernel(const float* scores, int64_t ld, int k, int pos_bits,
                     int sort_len, const uint32_t* state, SliceOut o,
                     u64* wins, float* out_vals, int* out_pos) {
  __shared__ __align__(16) uint32_t h[kBins];  // also the sort's
  __shared__ uint32_t red[kWarps];
  __shared__ uint32_t pick[3];
  __shared__ uint32_t s_wins;
  __shared__ uint32_t wpre[kMaxSlices + 1], cpre[kMaxSlices + 1];
  // launched as a programmatic dependent: wait for the launch before
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* x = scores + row * ld;
  u64* win = wins + row * sort_len;
  const RowPick p = row_pick(state + row * kRowWords + kBins, k);
  // the slices' counts, scanned (two a thread at most); a candidate count
  // past the cap: the slice overflowed and (R) refined the row
  const uint32_t* cnt = o.cnt + row * o.slices * 2;
  uint32_t wc[2], cc[2], wsum = 0, csum = 0;
  bool over = false;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sl = 2 * tid + j;
    wc[j] = sl < o.slices ? cnt[2 * sl] : 0u;
    cc[j] = sl < o.slices ? cnt[2 * sl + 1] : 0u;
    over |= cc[j] > static_cast<uint32_t>(o.cap);
    wsum += wc[j];
    csum += cc[j];
  }
  const bool refined = __syncthreads_or(over);
  const uint32_t wi = warp_incl_scan(wsum, lane), ci = warp_incl_scan(csum, lane);
  if (lane == 31) h[warp] = wi, h[kWarps + warp] = ci;
  __syncthreads();
  uint32_t wx = wi - wsum, cx = ci - csum, wt = 0, ct = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) wx += h[w], cx += h[kWarps + w];
    wt += h[w];
    ct += h[kWarps + w];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int sl = 2 * tid + j;
    if (sl < o.slices) wpre[sl] = wx, cpre[sl] = cx;
    wx += wc[j];
    cx += cc[j];
  }
  if (tid == 0) wpre[o.slices] = wt, cpre[o.slices] = ct;
  __syncthreads();
  // the slices' winners, in the row's list
  const u64* swin = o.wins + row * o.slices * o.wcap;
  for (uint32_t i = tid; i < wt; i += kThreads) {
    const int sl = slice_of(wpre, o.slices, i);
    win[i] = swin[static_cast<int64_t>(sl) * o.wcap + (i - wpre[sl])];
  }
  if (!p.take_all && !refined) {
    const u64* scand = o.cands + row * o.slices * o.cap;
    const int n_cand = static_cast<int>(ct);
    auto visit = [&](auto&& f) {  // f(live, R, key) over every candidate
      for (int i0 = 0; i0 < n_cand; i0 += kThreads) {
        const int i = i0 + tid;
        u64 e = 0ull;
        if (i < n_cand) {
          const int sl = slice_of(cpre, o.slices, i);
          e = scand[static_cast<int64_t>(sl) * o.cap + (i - cpre[sl])];
        }
        f(i < n_cand,
          rest_key(static_cast<uint32_t>(e >> 32), static_cast<uint32_t>(e),
                   pos_bits),
          e);
      }
    };
    Passes ps{kTopShift + pos_bits, 0ull, p.want0};
    while (true) {
      __syncthreads();  // h may still be read
      for (int i = tid; i < kBins; i += kThreads) h[i] = 0u;
      __syncthreads();
      visit([&](bool live, u64 r, u64) {
        count_digit(h, ps.digit(r), live && ps.live(r), lane);
      });
      __syncthreads();
      choose_digit(h, ps.want, red, pick);
      if (ps.take(pick)) break;
    }
    if (tid == 0) s_wins = wt;
    __syncthreads();
    visit([&](bool live, u64 r, u64 fk) {
      warp_append(live && (r >> ps.top) >= ps.prefix, fk, &s_wins, win, lane,
                  ~0u);
    });
  }
  if (sort_len > kFusedSort) return;  // (4) sorts them
  __syncthreads();
  sort_winners(win, k, sort_len, reinterpret_cast<u64*>(h), x,
               out_vals + row * k, out_pos + row * k);
}

// (4) for k above kFusedSort, a CTA a row: its k winners sorted by key,
// descending; values read back from the scores
__global__ void __launch_bounds__(kSortThreads)
select_sort_kernel(const float* scores, int64_t ld, int k, int sort_len,
                   u64* wins, float* out_vals, int* out_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  u64* src = wins + row * sort_len;
  u64* buf =
      sort_len <= kSortSmem ? reinterpret_cast<u64*>(smem) : src;
  for (int i = tid; i < sort_len; i += kSortThreads)
    buf[i] = i < k ? src[i] : 0ull;  // real keys are > 0
  __syncthreads();
  for (int size = 2; size <= sort_len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < sort_len / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const u64 a = buf[lo], b = buf[hi];
        if ((a < b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const float* x = scores + row * ld;
  for (int j = tid; j < k; j += kSortThreads) {
    const int pos = static_cast<int>(~static_cast<uint32_t>(buf[j]));
    out_pos[row * k + j] = pos;
    out_vals[row * k + j] = x[pos];
  }
}

int64_t align16(int64_t b) { return (b + 15) / 16 * 16; }

// The scratch's parts, 16-byte aligned: the rows' counts and state, (R)'s
// counts and words where a slice is wider than its buffer, the slices'
// counts, winners and candidates, and the rows' winner lists.
struct SelectLayout {
  int64_t state, refine, cnt, swins, cands, wins, bytes;
};

SelectLayout select_layout(int rows, int slices, int slice, int k, int cap,
                           int sort_len) {
  SelectLayout l;
  int64_t at = 0;
  auto part = [&](int64_t bytes) {
    const int64_t p = at;
    at += align16(bytes);
    return p;
  };
  const int64_t rs = int64_t{rows} * slices;
  l.state = part(4 * int64_t{rows} * kRowWords);
  l.refine = part(cap < slice ? 4 * int64_t{rows} * kRefineRow : 0);
  l.cnt = part(8 * rs);
  l.swins = part(8 * rs * (k < slice ? k : slice));
  l.cands = part(8 * rs * cap);
  l.wins = part(8 * int64_t{rows} * sort_len);
  l.bytes = at;
  return l;
}

constexpr int kSmallMax = 128;     // columns of the small-width mode
constexpr int kSmallThreads = 256;  // 8 rows a CTA

// The small-width mode: out_vals f32 and out_pos int32 (rows, k). Row r's
// candidate c (c < n) lies at vals[(c / per) part_stride + r row_stride +
// c % per]; its position is ids at the same offset where ids is given,
// else c. A warp a row.
__global__ void __launch_bounds__(kSmallThreads)
select_small_kernel(const float* __restrict__ vals,
                    const int* __restrict__ ids, int rows,
                    int64_t row_stride, int64_t part_stride, int per, int n,
                    int k, float* __restrict__ out_vals,
                    int* __restrict__ out_pos) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kSmallThreads / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  u64 key[4];
  float v[4];
  int id[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = lane + 32 * s;
    key[s] = 0;  // below every candidate's key: counts for none
    if (c < n) {
      const int p = c / per;
      const int64_t off = p * part_stride + row * row_stride + (c - p * per);
      v[s] = vals[off];
      id[s] = ids != nullptr ? ids[off] : c;
      key[s] = full_key(score_key(v[s]), c);
    }
  }
  int rank[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s2 = 0; s2 < 4; ++s2) {
    if (32 * s2 >= n) break;
    for (int src = 0; src < 32; ++src) {
      const u64 other = __shfl_sync(c2v::kFullMask, key[s2], src);
#pragma unroll
      for (int s = 0; s < 4; ++s) rank[s] += other > key[s];
    }
  }
  const int64_t o = static_cast<int64_t>(row) * k;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (lane + 32 * s < n && rank[s] < k) {
      out_vals[o + rank[s]] = v[s];
      out_pos[o + rank[s]] = id[s];
    }
  }
}

}  // namespace

// Bytes of scratch c2v_select_topk takes for `rows` rows cut into
// `slices` slices of `slice` columns, top k, `cap` candidates kept a
// slice.
C2V_EXPORT int64_t c2v_select_scratch_bytes(int rows, int slices, int slice,
                                            int k, int cap, int sort_len) {
  return select_layout(rows, slices, slice, k, cap, sort_len).bytes;
}

// scores: f32 (rows, ld), 16-byte aligned, ld % 4 == 0; the first n
// columns of each row are the candidates. k in 1..n. The rows are cut
// into `slices` (at most 1024) slices of `slice` columns (a multiple of
// 4; the last may be short). cap: candidates a slice keeps (>= 1); where
// cap < slice, (R) runs, and with more than one slice a row all rows x
// slices CTAs must be resident at once (kCtasPerSm an SM: select.plan).
// pos_bits: the bits of n - 1 (at least 1). sort_len: the power of two
// >= k (>= 32). scratch: c2v_select_scratch_bytes(rows, slices, slice,
// k, cap, sort_len) bytes, 16-byte aligned. Writes out_vals f32 (rows, k) and
// out_pos int32 (rows, k). Returns a cudaError_t.
C2V_EXPORT int c2v_select_topk(const float* scores, int rows, int64_t ld,
                               int n, int k, int slices, int slice, int cap,
                               int pos_bits, int sort_len, void* scratch,
                               float* out_vals, int* out_pos, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || k > n || ld < n || ld % 4 != 0 ||
      slices <= 0 || slices > kMaxSlices || slice <= 0 || slice % 4 != 0 ||
      static_cast<int64_t>(slices) * slice < n ||
      static_cast<int64_t>(slices - 1) * slice >= n || cap <= 0 ||
      pos_bits < 1 || pos_bits > 31 || (n - 1) >> pos_bits != 0 ||
      sort_len < k || sort_len < 32 || (sort_len & (sort_len - 1)) != 0 ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wcap = k < slice ? k : slice;
  const SelectLayout l = select_layout(rows, slices, slice, k, cap, sort_len);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  uint32_t* state = reinterpret_cast<uint32_t*>(base + l.state);
  // (R)'s counts and words, where a slice's candidates can overflow
  uint32_t* refine =
      cap < slice ? reinterpret_cast<uint32_t*>(base + l.refine) : nullptr;
  u64* wins = reinterpret_cast<u64*>(base + l.wins);
  const SliceOut o{reinterpret_cast<u64*>(base + l.swins),
                   reinterpret_cast<u64*>(base + l.cands),
                   reinterpret_cast<uint32_t*>(base + l.cnt), slices, wcap,
                   cap};
  // zeroed: the rows' counts and state, and (R)'s after them
  cudaError_t err = cudaMemsetAsync(state, 0, l.cnt - l.state, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows, slices);
  select_hist_kernel<<<grid, kThreads, 0, s>>>(scores, ld, n, k, slice,
                                               state);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  select_filter_kernel<<<grid, kThreads, 0, s>>>(scores, ld, n, k, slice,
                                                 state, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (refine != nullptr) {  // a slice's candidates can overflow its buffer
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = slices > 1 ? 1 : 0;  // a row's CTAs wait on each other
    err = cudaLaunchKernelEx(&cfg, select_refine_kernel, scores, ld, n, k,
                             slice, pos_bits,
                             static_cast<const uint32_t*>(state), refine, o);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // the finish as a programmatic dependent of the launch before it: its
  // launch overlaps that one's end
  cudaLaunchConfig_t fin = {};
  fin.gridDim = dim3(rows);
  fin.blockDim = dim3(kThreads);
  fin.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  fin.attrs = pdl;
  fin.numAttrs = 1;
  err = cudaLaunchKernelEx(&fin, select_finish_kernel, scores, ld, k,
                           pos_bits, sort_len,
                           static_cast<const uint32_t*>(state), o, wins,
                           out_vals, out_pos);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (sort_len <= kFusedSort) return cudaSuccess;
  const int smem = sort_len <= kSortSmem ? 8 * sort_len : 0;
  err = cudaFuncSetAttribute(select_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  select_sort_kernel<<<rows, kSortThreads, smem, s>>>(scores, ld, k, sort_len,
                                                      wins, out_vals, out_pos);
  return cudaGetLastError();
}

// The small-width mode over scores f32 (rows, ld): the top k (1 <= k <=
// n <= 128) of each row's first n columns, their positions in out_pos.
// Returns a cudaError_t.
C2V_EXPORT int c2v_select_small(const float* scores, int rows, int64_t ld,
                                int n, int k, float* out_vals, int* out_pos,
                                void* stream) {
  if (rows <= 0 || n <= 0 || n > kSmallMax || k <= 0 || k > n || ld < n)
    return cudaErrorInvalidValue;
  select_small_kernel<<<(rows + kSmallThreads / 32 - 1) /
                            (kSmallThreads / 32),
                        kSmallThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      scores, nullptr, rows, ld, 0, n, n, k, out_vals, out_pos);
  return cudaGetLastError();
}

// The merge of tp x k_local candidates: values f32 and ids int32 (parts,
// rows, k_local) as the all-gather stacks them, parts x k_local <= 128;
// writes the top k (1 <= k <= parts x k_local) of each row, values and
// ids, in `lax.top_k`'s order over the rank-major candidates. Returns a
// cudaError_t.
C2V_EXPORT int c2v_select_merge(const float* values, const int* ids,
                                int parts, int rows, int k_local, int k,
                                float* out_vals, int* out_ids,
                                void* stream) {
  const int n = parts * k_local;
  if (parts <= 0 || rows <= 0 || k_local <= 0 || n > kSmallMax || k <= 0 ||
      k > n)
    return cudaErrorInvalidValue;
  select_small_kernel<<<(rows + kSmallThreads / 32 - 1) /
                            (kSmallThreads / 32),
                        kSmallThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      values, ids, rows, k_local, static_cast<int64_t>(rows) * k_local,
      k_local, n, k, out_vals, out_ids);
  return cudaGetLastError();
}
