// K11 ivf_search: the probe and candidate scan of an IVF index, with an
// instantiation of one kernel per row format:
//   (a) f32 rows: code2vec_tpu/retrieval/index.py `NeighborIndex._search_ivf`
//       (:319-349), an index over a store's vectors;
//   (b) int8, fp8 (e4m3 or e5m2) or packed int4 rows with per-row f32
//       scales: code2vec_tpu/retrieval/mips.py `MipsHead.topk_fn`
//       (:139-188), the approximate-MIPS prediction head over the
//       quantized target-name table, whose score is (cv . float(row)) *
//       scale in f32, in that order (mips.py:166-172); each value decodes
//       exactly in registers (common.cuh).
//
// Per query: score every centroid by inner product, take the top nprobe
// (ties to the lowest centroid index, NaN first, as lax.top_k), walk the
// probed lists in probe-rank order through `list_offsets` (the lists are
// contiguous, so no padded list matrix exists on the card), and keep the
// top k of the candidates with ties broken by candidate position (probe
// rank, then offset in the list): the order in which `lax.top_k` sees the
// reference's padded `cand` array. Identical methods have identical
// vectors, so exact ties are common in code search and the order matters.
// Slots past the candidates come out as position -1 (index) or global id
// 0 (MIPS), value -inf.
//
// What bounds it on an H100: bytes. Each row of the union of the probed
// lists must be read once (f32: 1,536 bytes at width 384, int8 and fp8:
// 384 + 4, int4: 192 + 4) for 2 D operations per query that probes it,
// well under the card's ~20 f32 operations per byte. At the batches the
// serving path runs (1 to 64 queries) the work is small and latency, not
// bytes, sets the time, so the design spreads one query over the card,
// keeps chunks in flight on every SM and reads each probed list once per
// batch. Three launches (kernels/ivf.py `plan` sizes them), each after the
// first a programmatic dependent of the one before (its CTAs are resident
// early and wait in griddepcontrol.wait):
//   (1) probe_kernel: CTAs over slices of 8 centroids (a warp each), each
//       holding a group of up to 64 queries in shared memory, so every
//       centroid is read once per group; scores to a (B, nlist) scratch.
//   (2) select_kernel, one CTA per query: the top nprobe centroids by a
//       total order on 64-bit keys (the value's order-preserving bits
//       above the inverted index: descending keys are lax.top_k's
//       order), sorted 64 at a time by bitonic networks in registers and
//       merged across the CTA's warps; above 64 probes, ranks by
//       counting. It writes where each query's partial lists start. The
//       last CTA of a group of 64 queries (an atomic ticket) groups the
//       group's probes by list: the first slot (query, rank) that probes a
//       list owns it, with a 64-bit mask of the group's queries that probe
//       it, and each of those queries' rank and partial lists are written
//       beside the owner.
//   (3) scan_kernel, one CTA per (owner slot, chunk of R rows of its list,
//       tile of 16 of its queries): the chunk (one contiguous byte span)
//       comes into shared memory by bulk copies under an mbarrier (the
//       aligned interior; the unaligned head and tail bytes, rows that are
//       not whole 16-byte units, by plain loads), is scored against the
//       tile's queries (staged beside it below 16 a tile; f32 sums, the
//       scale after; above two queries 16 partial sums a lane meet in one
//       halving exchange),
//       and each query's top k of the chunk is written, as sorted keys, to
//       its partial lists. Keys stay rank * max_len + offset, so a chunk's
//       list merges like a list's. A query's chunks arrive by an atomic
//       ticket; the CTA that completes a query merges it: the largest k-th
//       key of its partial lists and the k-th largest of their best keys
//       bound the result from below, so only the few keys above both are
//       sorted and merged (by the same key order), and keys map to store
//       positions or global ids. No float atomics: the result does not
//       depend on CTA order.
//
// Large-k mode (k above the 64 entries a list holds): launches (1) and
// (2) give the probe, then list_scores_kernel writes every probed row's
// score to a (b, ld) f32 matrix at its padded candidate position rank *
// max_len + offset (-inf past the list's end), K13 (csrc/select.cu)
// selects the top k positions, and map_kernel turns them into store
// positions or global ids, dead slots into -1 / 0.
#include "hopper.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 64;        // queries a group (one mask word)
constexpr int kMemberTile = 16;   // queries a scan pass scores at once
constexpr int kMaxChunk = 128;    // rows a scan CTA may own
constexpr uint32_t kCopyBytes = 32768;  // one bulk copy at most
// 4-element vectors a lane holds of one row: rows up to 32 * 4 * 4 = 512
// wide
constexpr int kMaxVec = 4;
constexpr int kScanHead = 3072;   // scan_kernel's smem before the scores
static_assert(kMemberTile == 16, "transpose_sum16 reduces 16 sums");

__host__ __device__ constexpr int64_t align_up(int64_t x, int64_t a) {
  return (x + a - 1) / a * a;
}

__host__ __device__ constexpr int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The chunks of R rows a list of `len` rows is scanned in: at least one,
// so that every probed list, an empty one too, reports to its queries.
__host__ __device__ constexpr int chunks_of_len(int64_t len, int r) {
  return static_cast<int>(max64(1, (len + r - 1) / r));
}

// A slot (query, probe rank) after grouping. The first slot that probes
// a list owns it; `mask` holds the group's queries that probe the list (a
// bit each). The list's queries are scored 16 (a tile) at a time, and the
// slot of the list's i-th query scans tile i: `nch` chunks of the list
// (0 where it scans none), `tile`, and its `owner`, beside which the
// queries' Members are written.
struct Slot {
  unsigned long long mask;
  int list, nch, tile, owner, pad[2];
};

// A query of an owner slot's list: the query, the list's probe rank for
// it, where the list's partial lists start among the query's, and the
// query's partial lists in all.
struct Member {
  int qb, rank, base, parts;
};

// ---------------------------------------------------------------- keys
// A candidate's 64-bit key: the score's order-preserving bits (NaN
// highest, -0 as +0) above the inverted index, so that descending keys are
// lax.top_k's order (NaN first, larger values first, ties to the lower
// index). Key 0 is an empty slot, below every real candidate.

__device__ __forceinline__ uint32_t ord_of(float v) {
  if (isnan(v)) return 0xFFFFFFFFu;
  if (v == 0.f) v = 0.f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t make_key(float v, int idx) {
  return (static_cast<uint64_t>(ord_of(v)) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ float key_value(uint64_t key) {
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  if (o == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

// Sort 64 keys held by a warp (element lane + 32 i in x[i]) descending:
// a bitonic network, partners within a lane at distance 32, by shuffles
// below.
__device__ __forceinline__ void sort64(uint64_t (&x)[2], int lane) {
#pragma unroll
  for (int s = 2; s <= 64; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      if (j == 32) {
        const uint64_t hi = kmax(x[0], x[1]), lo = kmin(x[0], x[1]);
        x[0] = hi;
        x[1] = lo;
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * i;
          const uint64_t y = __shfl_xor_sync(c2v::kFullMask, x[i], j);
          const bool desc = s == 64 || (e & s) == 0;
          const bool lower = (e & j) == 0;
          x[i] = desc == lower ? kmax(x[i], y) : kmin(x[i], y);
        }
      }
    }
  }
}

// a := the top 64 of a and b, both sorted descending, sorted descending:
// the elementwise max of a and reversed b is bitonic and holds the top
// 64; a bitonic merge sorts it.
__device__ __forceinline__ void merge64(uint64_t (&a)[2],
                                        const uint64_t (&b)[2], int lane) {
  const uint64_t r0 = __shfl_sync(c2v::kFullMask, b[1], 31 - lane);
  const uint64_t r1 = __shfl_sync(c2v::kFullMask, b[0], 31 - lane);
  a[0] = kmax(a[0], r0);
  a[1] = kmax(a[1], r1);
  const uint64_t hi = kmax(a[0], a[1]), lo = kmin(a[0], a[1]);
  a[0] = hi;
  a[1] = lo;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint64_t y = __shfl_xor_sync(c2v::kFullMask, a[i], j);
      a[i] = lower ? kmax(a[i], y) : kmin(a[i], y);
    }
  }
}

// Fold one batch of 64 keys into a warp's running top 64.
__device__ __forceinline__ void fold64(uint64_t (&run)[2], uint64_t (&x)[2],
                                       bool first, int lane) {
  sort64(x, lane);
  if (first) {
    run[0] = x[0];
    run[1] = x[1];
  } else {
    merge64(run, x, lane);
  }
}

// The CTA's top 64 into warp 0's `run`: a tree of merges through
// `lists` (4 x 64 keys). Every thread of the CTA calls it.
__device__ __forceinline__ void cta_top64(uint64_t (&run)[2],
                                          uint64_t* lists, int warp,
                                          int lane) {
#pragma unroll
  for (int step = kWarps / 2; step > 0; step >>= 1) {
    if (warp >= step && warp < 2 * step) {
      lists[(warp - step) * 64 + lane] = run[0];
      lists[(warp - step) * 64 + lane + 32] = run[1];
    }
    __syncthreads();
    if (warp < step) {
      const uint64_t b[2] = {lists[warp * 64 + lane],
                             lists[warp * 64 + lane + 32]};
      merge64(run, b, lane);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- rows

// The dot product of a row's vectors (lane's share, `v[i]` = vector
// lane + 32 i) with a query (shared memory, or device memory through
// the read-only cache).
template <bool kGlobal>
__device__ __forceinline__ float dot4(const float4 (&v)[kMaxVec],
                                      const float* sq, int d4, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int w = lane + 32 * i;
    if (w < d4) {
      const float4 x = kGlobal ? __ldg(reinterpret_cast<const float4*>(sq) + w)
                               : reinterpret_cast<const float4*>(sq)[w];
      s = fmaf(x.x, v[i].x, s);
      s = fmaf(x.y, v[i].y, s);
      s = fmaf(x.z, v[i].z, s);
      s = fmaf(x.w, v[i].w, s);
    }
  }
  return s;
}

template <int kFmt>
__host__ __device__ constexpr int row_bytes(int d) {
  return kFmt == c2v::kF32 ? 4 * d : kFmt == c2v::kInt4 ? d / 2 : d;
}

// One row's vectors (f32, or a quantized format decoded to f32 before
// its scale: a lane's 4 values are 4 bytes, or 2 of int4), every load
// issued before any is used. `rows` may point into shared memory.
template <int kFmt>
__device__ __forceinline__ void load_row(const void* rows, int64_t row,
                                         int d, int lane,
                                         float4 (&v)[kMaxVec]) {
  const int d4 = d / 4;
  if constexpr (kFmt == c2v::kInt8) {
    const int* r = reinterpret_cast<const int*>(
        static_cast<const int8_t*>(rows) + row * d);
    int packed[kMaxVec];
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
      packed[i] = lane + 32 * i < d4 ? r[lane + 32 * i] : 0;
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
      v[i] = make_float4(static_cast<float>(static_cast<int8_t>(packed[i])),
                         static_cast<float>(static_cast<int8_t>(packed[i] >> 8)),
                         static_cast<float>(static_cast<int8_t>(packed[i] >> 16)),
                         static_cast<float>(static_cast<int8_t>(packed[i] >> 24)));
  } else if constexpr (kFmt != c2v::kF32) {
    const unsigned char* base = static_cast<const unsigned char*>(rows);
    uint32_t packed[kMaxVec];
    if constexpr (kFmt == c2v::kInt4) {
      const uint16_t* r =
          reinterpret_cast<const uint16_t*>(base + row * (d / 2));
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i)
        packed[i] = lane + 32 * i < d4 ? r[lane + 32 * i] : 0x8888u;
    } else {
      const uint32_t* r = reinterpret_cast<const uint32_t*>(base + row * d);
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i)
        packed[i] = lane + 32 * i < d4 ? r[lane + 32 * i] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i) {
      float q[4];
      c2v::decode4<kFmt>(packed[i], q);
      v[i] = make_float4(q[0], q[1], q[2], q[3]);
    }
  } else {
    const float4* r = reinterpret_cast<const float4*>(
        static_cast<const float*>(rows) + row * d);
#pragma unroll
    for (int i = 0; i < kMaxVec; ++i)
      v[i] = lane + 32 * i < d4 ? r[lane + 32 * i]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ------------------------------------------------------ (1) the probe

// cscores[b][c] = q[b] . centroid[c]; blockIdx.x: 8 centroids (a warp
// each), blockIdx.y: a group of up to 64 queries held in shared memory.
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* q, int b, int d, const float* cent, int n_cent,
             float* cscores) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // (nq, d)
  asm volatile("griddepcontrol.launch_dependents;");
  const int b0 = blockIdx.y * kGroup, nq = min(kGroup, b - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* src =
      reinterpret_cast<const float4*>(q + static_cast<int64_t>(b0) * d);
  float4* dst = reinterpret_cast<float4*>(sq);
  for (int i = tid; i < nq * d / 4; i += kThreads) dst[i] = src[i];
  __syncthreads();
  const int c = blockIdx.x * kWarps + warp;
  if (c >= n_cent) return;
  float4 v[kMaxVec];
  load_row<c2v::kF32>(cent, c, d, lane, v);
  const int d4 = d / 4;
#pragma unroll 4
  for (int i = 0; i < nq; ++i) {
    const float s = c2v::warp_sum(dot4<false>(v, sq + i * d, d4, lane));
    if (lane == 0) cscores[static_cast<int64_t>(b0 + i) * n_cent + c] = s;
  }
}

// ------------------------------------------ (2) selection and grouping

// One CTA per query: probe[b][r] = the centroid of rank r; pstart[b][p]
// = the query's partial lists before rank p's (each probed list gives
// max(1, ceil(len / R)) chunks), pstart[b][nprobe] their count. With
// `build`, the last CTA of each group of 64 queries (counters[group])
// writes the group's slots and each owner's queries (members[slot][i], i
// the query's place among the mask's bits).
// `grouped` 0: every slot owns its list for its own query alone.
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* cscores, int b, int n_cent, int nprobe,
              const int64_t* offsets, int rows_per_chunk, int build,
              int grouped, int* probe, int* pstart, Slot* slots,
              Member* members, int* counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;");
  const int bq = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* sp = reinterpret_cast<int*>(smem);       // nprobe: the probe
  int* snch = sp + align_up(nprobe, 4);         // nprobe: chunks
  int* flag = snch + align_up(nprobe, 4);       // 4
  unsigned char* scratch = reinterpret_cast<unsigned char*>(flag + 4);
  const float* sc = cscores + static_cast<int64_t>(bq) * n_cent;

  if (nprobe <= kMaxK) {
    uint64_t* lists = reinterpret_cast<uint64_t*>(scratch);
    uint64_t run[2] = {0, 0};
    bool first = true;
    for (int t = warp; t * 64 < n_cent; t += kWarps) {
      uint64_t x[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int e = t * 64 + lane + 32 * i;
        x[i] = e < n_cent ? make_key(sc[e], e) : 0;
      }
      fold64(run, x, first, lane);
      first = false;
    }
    cta_top64(run, lists, warp, lane);
    if (warp == 0) {
      if (lane < nprobe) sp[lane] = key_index(run[0]);
      if (lane + 32 < nprobe) sp[lane + 32] = key_index(run[1]);
    }
  } else {  // any nprobe: rank = the number of centroids before it
    float* s = reinterpret_cast<float*>(scratch);
    for (int c = tid; c < n_cent; c += kThreads) s[c] = sc[c];
    __syncthreads();
    for (int c = tid; c < n_cent; c += kThreads) {
      const float v = s[c];
      int rank = 0;
      for (int j = 0; j < n_cent; ++j) rank += c2v::topk_before(s[j], j, v, c);
      if (rank < nprobe) sp[rank] = c;
    }
  }
  __syncthreads();
  for (int p = tid; p < nprobe; p += kThreads) {
    const int list = sp[p];
    probe[static_cast<int64_t>(bq) * nprobe + p] = list;
    snch[p] = chunks_of_len(offsets[list + 1] - offsets[list], rows_per_chunk);
  }
  __syncthreads();
  if (pstart != nullptr && tid == 0) {
    int* ps = pstart + static_cast<int64_t>(bq) * (nprobe + 1);
    int acc = 0;
    for (int p = 0; p < nprobe; ++p) {
      ps[p] = acc;
      acc += snch[p];
    }
    ps[nprobe] = acc;
  }
  if (!build) return;
  const int g = bq / kGroup, q0 = g * kGroup, nq = min(kGroup, b - q0);
  if (nq > 1) {  // the group's ticket: its last query groups the slots
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int last = atomicAdd(&counters[g], 1) == nq - 1;
      if (last) counters[g] = 0;  // every query of the group has arrived
      flag[0] = last;
    }
    __syncthreads();
    if (!flag[0]) return;
    __threadfence();
  }
  const int ns = nq * nprobe;
  const int64_t s0 = static_cast<int64_t>(q0) * nprobe;
  const bool by_list = grouped && nq > 1;
  auto list_of = [&](int s) {
    return nq == 1 ? sp[s] : __ldcg(probe + s0 + s);
  };
  auto chunks_of = [&](int list) {
    return chunks_of_len(offsets[list + 1] - offsets[list], rows_per_chunk);
  };
  int* own = reinterpret_cast<int*>(scratch);  // n_cent: a list's first slot
  unsigned long long* msk = reinterpret_cast<unsigned long long*>(
      scratch + align_up(static_cast<int64_t>(n_cent) * 4, 16));  // ns
  if (by_list) {
    for (int c = tid; c < n_cent; c += kThreads) own[c] = 0x7fffffff;
    for (int s = tid; s < ns; s += kThreads) msk[s] = 0ull;
    __syncthreads();
    for (int s = tid; s < ns; s += kThreads) atomicMin(&own[list_of(s)], s);
    __syncthreads();
    for (int s = tid; s < ns; s += kThreads)
      atomicOr(&msk[own[list_of(s)]], 1ull << (s / nprobe));
    __syncthreads();
  }
  // each slot's query, as a member of its list's owner
  __syncthreads();  // pstart of a group of one, written above
  for (int s = tid; s < ns; s += kThreads) {
    const int bit = s / nprobe, pr = s - bit * nprobe;
    const int o = by_list ? own[list_of(s)] : s;
    const int i = by_list ? __popcll(msk[o] & ((1ull << bit) - 1ull)) : 0;
    const int* ps = pstart + static_cast<int64_t>(q0 + bit) * (nprobe + 1);
    Member mem;
    mem.qb = q0 + bit;
    mem.rank = pr;
    mem.base = __ldcg(ps + pr);
    mem.parts = __ldcg(ps + nprobe);
    members[(s0 + o) * (b < kGroup ? b : kGroup) + i] = mem;
  }
  for (int s = tid; s < ns; s += kThreads) {
    const int list = list_of(s), bit = s / nprobe;
    const int o = by_list ? own[list] : s;
    const unsigned long long mask = by_list ? msk[o] : 1ull << bit;
    const int i = __popcll(mask & ((1ull << bit) - 1ull));
    const int tiles = (__popcll(mask) + kMemberTile - 1) / kMemberTile;
    Slot slot;
    slot.mask = mask;
    slot.list = list;
    slot.nch = i < tiles ? (nq == 1 ? snch[s] : chunks_of(list)) : 0;
    slot.tile = i;
    slot.owner = static_cast<int>(s0 + o);
    slots[s0 + s] = slot;
  }
}

// ------------------------------------------- (3) the scan and the merge

struct ScanArgs {
  const float* q_vecs;
  int d;
  const void* rows;
  const float* scales;
  const int64_t* offsets;
  int nprobe, max_len, k, rows_per_chunk, cpl, tile_cap, max_parts;
  int stage;              // the tile's queries staged in shared memory
  const Slot* slots;
  int* qcount;          // (b,): chunks of each query scanned, left zero
  const int* probe;
  const int* pstart;
  const Member* members;  // (slots, min(b, 64))
  int q;                  // members a slot may have: min(b, 64)
  uint64_t* part;
  const int* global_ids;
  float* out_vals;
  int* out_idx;
};

// A key written by another CTA of this launch, read from L2.
__device__ __forceinline__ uint64_t ldcg_key(const uint64_t* p) {
  return __ldcg(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint64_t warp_kmax(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = kmax(x, __shfl_xor_sync(c2v::kFullMask, x, off));
  return x;
}

// Fold the keys of a query's partial lists, batches t0, t0 + stride, ...
// of 64, into a warp's running top 64, skipping keys below `floor`: the
// largest k-th key of any partial list, below which no key can be among
// the top k (the list holding it has k keys at or above it). Loads run 4
// batches ahead of the sorting; a batch with no key left costs its loads.
__device__ __forceinline__ void fold_partials(uint64_t (&run)[2],
                                              const uint64_t* src,
                                              int64_t nkeys, int64_t t0,
                                              int64_t stride, uint64_t floor,
                                              int lane) {
  constexpr int kAhead = 4;
  bool first = true;
  for (int64_t tb = t0; tb * 64 < nkeys; tb += kAhead * stride) {
    uint64_t x[kAhead][2];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int64_t e = (tb + u * stride) * 64 + lane + 32 * i;
        x[u][i] = e < nkeys ? ldcg_key(src + e) : 0;
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      uint64_t y[2] = {x[u][0] >= floor ? x[u][0] : 0,
                       x[u][1] >= floor ? x[u][1] : 0};
      if (!__any_sync(c2v::kFullMask, (y[0] | y[1]) != 0)) continue;
      fold64(run, y, first, lane);
      first = false;
    }
  }
}

// The top k of query qb's merged keys (run, in warp `lane` order) to its
// outputs: values, and keys mapped to positions or global ids.
__device__ __forceinline__ void write_query(const ScanArgs& a, int qb,
                                            const uint64_t (&run)[2],
                                            int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = lane + 32 * i;
    if (j >= a.k) continue;
    const uint64_t key = run[i];
    const int64_t o = static_cast<int64_t>(qb) * a.k + j;
    if (key == 0) {
      a.out_vals[o] = -INFINITY;
      a.out_idx[o] = a.global_ids != nullptr ? 0 : -1;
      continue;
    }
    const int ck = key_index(key);
    const int rank = ck / a.max_len, off = ck - rank * a.max_len;
    const int list = a.probe[static_cast<int64_t>(qb) * a.nprobe + rank];
    const int64_t pos = a.offsets[list] + off;
    a.out_vals[o] = key_value(key);
    a.out_idx[o] = a.global_ids != nullptr ? a.global_ids[pos]
                                           : static_cast<int>(pos);
  }
}

// Query qb's partial lists: (their keys, the count of keys).
__device__ __forceinline__ const uint64_t* partials(const ScanArgs& a,
                                                    int qb, int* parts) {
  *parts = a.pstart[static_cast<int64_t>(qb) * (a.nprobe + 1) + a.nprobe];
  return a.part + static_cast<int64_t>(qb) * a.max_parts * a.k;
}

// The key at place k - 1 of a warp's sorted run (every lane gets it).
__device__ __forceinline__ uint64_t kth_key(const uint64_t (&run)[2],
                                            int k) {
  return __shfl_sync(c2v::kFullMask, k <= 32 ? run[0] : run[1], (k - 1) & 31);
}

// A query's merge. Two lower bounds on its k-th key skip most keys: the
// largest k-th key of a partial list, and the k-th largest of the
// partial lists' best keys (k distinct candidates reach it); then only
// the keys at or above the larger bound are sorted and merged. The CTA's
// warps split the keys and a tree of merges through `lists` joins them;
// `red` holds kWarps + 1 keys.
__device__ void merge_query_cta(const ScanArgs& a, int qb, uint64_t* lists,
                                uint64_t* red, int warp, int lane) {
  int parts;
  const uint64_t* src = partials(a, qb, &parts);
  uint64_t floor = 0;
  for (int j = threadIdx.x; j < parts; j += kThreads)
    floor = kmax(floor,
                 ldcg_key(src + (static_cast<int64_t>(j) + 1) * a.k - 1));
  floor = warp_kmax(floor);
  if (lane == 0) red[warp] = floor;
  uint64_t run[2] = {0, 0};
  bool first = true;
  for (int t = warp; t * 64 < parts; t += kWarps) {  // the best keys
    uint64_t x[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = t * 64 + lane + 32 * i;
      x[i] = e < parts ? ldcg_key(src + static_cast<int64_t>(e) * a.k) : 0;
    }
    fold64(run, x, first, lane);
    first = false;
  }
  cta_top64(run, lists, warp, lane);
  if (warp == 0) {
    const uint64_t f2 = kth_key(run, a.k);
    if (lane == 0) red[kWarps] = f2;
  }
  __syncthreads();
  floor = red[kWarps];
  for (int w = 0; w < kWarps; ++w) floor = kmax(floor, red[w]);
  run[0] = run[1] = 0;
  fold_partials(run, src, static_cast<int64_t>(parts) * a.k, warp, kWarps,
                floor, lane);
  cta_top64(run, lists, warp, lane);
  if (warp == 0) write_query(a, qb, run, lane);
  __syncthreads();
}

// Several queries done in one CTA (a tile of a shared list's): a warp a
// query, with the bounds of merge_query_cta.
__device__ void merge_query_warp(const ScanArgs& a, int qb, int lane) {
  int parts;
  const uint64_t* src = partials(a, qb, &parts);
  uint64_t floor = 0;
  for (int j = lane; j < parts; j += 32)
    floor = kmax(floor,
                 ldcg_key(src + (static_cast<int64_t>(j) + 1) * a.k - 1));
  floor = warp_kmax(floor);
  uint64_t run[2] = {0, 0};
  bool first = true;
  for (int t = 0; t * 64 < parts; ++t) {
    uint64_t x[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = t * 64 + lane + 32 * i;
      x[i] = e < parts ? ldcg_key(src + static_cast<int64_t>(e) * a.k) : 0;
    }
    fold64(run, x, first, lane);
    first = false;
  }
  floor = kmax(floor, kth_key(run, a.k));
  run[0] = run[1] = 0;
  fold_partials(run, src, static_cast<int64_t>(parts) * a.k, 0, 1, floor,
                lane);
  write_query(a, qb, run, lane);
}

// The partial dot products of a row with 16 staged queries (acc[i]:
// this lane's share with query i), reduced across the warp by halving
// exchanges (16 shuffles for 16 sums, not 5 each): afterwards lanes 2i
// and 2i + 1 hold the sum for query i.
__device__ __forceinline__ float transpose_sum16(float (&acc)[kMemberTile],
                                                 int lane) {
#pragma unroll
  for (int o = 16, half = kMemberTile / 2; o >= 2; o >>= 1, half >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? acc[i] : acc[i + half];
      const float keep = up ? acc[i + half] : acc[i];
      acc[i] = keep + __shfl_xor_sync(c2v::kFullMask, send, o);
    }
  }
  return acc[0] + __shfl_xor_sync(c2v::kFullMask, acc[0], 1);
}

// The tickets of a CTA's queries: each has had one more chunk scanned;
// a query whose chunks are all in is merged here, by the whole CTA (one
// query) or a warp each (several). Every thread calls it.
__device__ void arrive(const ScanArgs& a, int nm, const int* mb,
                       const int* mparts, int* mq, uint64_t* lists,
                       uint64_t* red, int warp, int lane) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x < nm) {
    const int qb = mb[threadIdx.x];
    if (atomicAdd(&a.qcount[qb], 1) + 1 == mparts[threadIdx.x]) {
      a.qcount[qb] = 0;  // every chunk of the query has arrived
      mq[atomicAdd(&mq[kMemberTile], 1)] = qb;
    }
  }
  __syncthreads();
  const int nmerge = mq[kMemberTile];
  if (nmerge == 0) return;
  __threadfence();
  if (nmerge == 1) {
    merge_query_cta(a, mq[0], lists, red, warp, lane);
  } else {
    for (int i = warp; i < nmerge; i += kWarps)
      merge_query_warp(a, mq[i], lane);
  }
}

// The chunk's scores (sc: query-major, R a query): rows a warp each, the
// queries from shared memory (staged) or the read-only cache (kGlobal).
template <int kFmt, bool kGlobal>
__device__ __forceinline__ void score_rows(const ScanArgs& a,
                                           const unsigned char* srows,
                                           const float* ssc, const float* sq,
                                           const int* mb, int nm, int n,
                                           float* sc, int warp, int lane) {
  const int d = a.d, d4 = d / 4, R = a.rows_per_chunk;
  auto query = [&](int i) {
    return kGlobal ? a.q_vecs + static_cast<int64_t>(mb[i]) * d : sq + i * d;
  };
  for (int jr = warp; jr < n; jr += kWarps) {
    float4 v[kMaxVec];
    load_row<kFmt>(srows, jr, d, lane, v);
    const float scale = kFmt != c2v::kF32 ? ssc[jr] : 1.f;
    if (nm <= 2) {
      for (int i = 0; i < nm; ++i) {
        float sdot = c2v::warp_sum(dot4<kGlobal>(v, query(i), d4, lane));
        if (kFmt != c2v::kF32) sdot *= scale;
        if (lane == 0) sc[i * R + jr] = sdot;
      }
    } else {  // above two queries, 16 at once
      float acc[kMemberTile];
#pragma unroll
      for (int i = 0; i < kMemberTile; ++i)
        acc[i] = i < nm ? dot4<kGlobal>(v, query(i), d4, lane) : 0.f;
      float sdot = transpose_sum16(acc, lane);
      if (kFmt != c2v::kF32) sdot *= scale;
      const int i = lane >> 1;
      if ((lane & 1) == 0 && i < nm) sc[i * R + jr] = sdot;
    }
  }
}

// blockIdx.x = slot * cpl + chunk: a chunk of R rows of the slot's list,
// staged by bulk copies (the aligned interior; the head and tail bytes by
// plain loads), scored against the list's queries of the slot's tile
// (kMemberTile queries, so a list that many queries probe is spread over
// the CTAs of its first queries' slots), each query's top k of the chunk
// written as sorted keys; then the tickets, and the merge of any query
// whose chunks are all in. A CTA with no work (past the list's chunks, or
// a slot that scans no tile) leaves after one load.
template <int kFmt>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int64_t bx = blockIdx.x;
  const int64_t s = bx / a.cpl;
  const int c = static_cast<int>(bx - s * a.cpl);
  const Slot slot = a.slots[s];
  if (c >= slot.nch) return;
  const int tile = slot.tile;
  const int nm = min(kMemberTile, __popcll(slot.mask) - tile * kMemberTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.rows_per_chunk, d = a.d, d4 = d / 4;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* mb = reinterpret_cast<int*>(smem + 64);  // the tile's queries
  int* mp = mb + kMemberTile;                   // their probe ranks
  int* mbase = mp + kMemberTile;                // their partial lists
  int* mparts = mbase + kMemberTile;            // their chunks in all
  int* mq = mparts + kMemberTile;               // queries to merge, count
  uint64_t* red = reinterpret_cast<uint64_t*>(smem + 392);  // kWarps + 1
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + 512);  // 4 x 64
  float* ssc = reinterpret_cast<float*>(smem + 2560);  // the chunk's scales
  float* sc = reinterpret_cast<float*>(smem + kScanHead);     // tile x R
  float* sq = sc + a.tile_cap * R;                  // tile x d, if staged
  unsigned char* span = smem + align_up(
      kScanHead + static_cast<int64_t>(a.tile_cap) *
                      (R + (a.stage ? d : 0)) * 4,
      128);

  const int64_t lo = a.offsets[slot.list];
  const int64_t len = a.offsets[slot.list + 1] - lo;
  const int r0 = c * R;
  const int n = static_cast<int>(
      max64(0, (len < static_cast<int64_t>(r0) + R ? len : r0 + R) - r0));
  const int64_t rb = row_bytes<kFmt>(d);
  const uintptr_t us = reinterpret_cast<uintptr_t>(a.rows) +
                       static_cast<uintptr_t>((lo + r0) * rb);
  const uintptr_t ue = us + static_cast<uintptr_t>(n * rb);
  const uintptr_t f16 = us & ~uintptr_t(15), a16 = (us + 15) & ~uintptr_t(15),
                  b16 = ue & ~uintptr_t(15);
  const int head = static_cast<int>(us - f16);  // row 0's offset in span
  if (tid == 0) {
    c2v::hopper::mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t bytes = a16 < b16 ? static_cast<uint32_t>(b16 - a16) : 0;
    c2v::hopper::mbar_arrive_tx(bar, bytes);
    for (uint32_t off = 0; off < bytes; off += kCopyBytes)
      c2v::hopper::bulk_load(span + (a16 - f16) + off,
                             reinterpret_cast<const void*>(a16 + off),
                             min(kCopyBytes, bytes - off), bar);
    mq[kMemberTile] = 0;
  }
  // the bytes outside the aligned interior, by plain loads
  const unsigned char* start = reinterpret_cast<const unsigned char*>(us);
  if (a16 < b16) {
    for (int i = tid; i < static_cast<int>(a16 - us); i += kThreads)
      span[head + i] = start[i];
    for (int i = tid; i < static_cast<int>(ue - b16); i += kThreads)
      span[(b16 - f16) + i] = reinterpret_cast<const unsigned char*>(b16)[i];
  } else {
    for (int i = tid; i < static_cast<int>(ue - us); i += kThreads)
      span[head + i] = start[i];
  }
  if (a.scales != nullptr && tid < n) ssc[tid] = a.scales[lo + r0 + tid];
  if (tid < nm) {
    const Member mem =
        a.members[static_cast<int64_t>(slot.owner) * a.q +
                  tile * kMemberTile + tid];
    mb[tid] = mem.qb;
    mp[tid] = mem.rank;
    mbase[tid] = mem.base;
    mparts[tid] = mem.parts;
  }
  __syncthreads();
  if (a.stage) {  // the tile's queries
    for (int e = tid; e < nm * d4; e += kThreads) {
      const int i = e / d4;
      reinterpret_cast<float4*>(sq)[e] = __ldg(
          reinterpret_cast<const float4*>(a.q_vecs +
                                          static_cast<int64_t>(mb[i]) * d) +
          (e - i * d4));
    }
    __syncthreads();
  }
  c2v::hopper::mbar_wait(bar, 0);
  const unsigned char* srows = span + head;

  if (a.stage)
    score_rows<kFmt, false>(a, srows, ssc, sq, mb, nm, n, sc, warp, lane);
  else
    score_rows<kFmt, true>(a, srows, ssc, sq, mb, nm, n, sc, warp, lane);
  __syncthreads();
  for (int i = warp; i < nm; i += kWarps) {
    const int key0 = mp[i] * a.max_len + r0;
    uint64_t run[2] = {0, 0};
    for (int t = 0; t * 64 < n; ++t) {
      uint64_t x[2];
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int e = t * 64 + lane + 32 * ii;
        x[ii] = e < n ? make_key(sc[i * R + e], key0 + e) : 0;
      }
      fold64(run, x, t == 0, lane);
    }
    uint64_t* dst =
        a.part + (static_cast<int64_t>(mb[i]) * a.max_parts + mbase[i] + c) *
                     a.k;
    if (lane < a.k) dst[lane] = run[0];
    if (lane + 32 < a.k) dst[lane + 32] = run[1];
  }
  arrive(a, nm, mb, mparts, mq, lists, red, warp, lane);
}

// ------------------------------------------------------ large-k mode

// (2') Large-k mode: every probed row's score at its padded candidate
// position, -inf past the end of its list.
template <int kFmt>
__global__ void __launch_bounds__(kThreads)
list_scores_kernel(const float* q, int d, const void* rows,
                   const float* scales, const int64_t* offsets,
                   const int* probe, int nprobe, int max_len, float* scores,
                   int64_t ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // d
  const int p = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < d; j += kThreads)
    sq[j] = q[static_cast<int64_t>(b) * d + j];
  __syncthreads();
  const int list = probe[static_cast<int64_t>(b) * nprobe + p];
  const int64_t lo = offsets[list], len = offsets[list + 1] - lo;
  float* out = scores + static_cast<int64_t>(b) * ld +
               static_cast<int64_t>(p) * max_len;
  for (int64_t off = len + tid; off < max_len; off += kThreads)
    out[off] = -INFINITY;
  const int d4 = d / 4;
  for (int64_t off = 2 * warp; off < len; off += 2 * kWarps) {
    const bool two = off + 1 < len;  // warp-uniform
    float4 va[kMaxVec], vb[kMaxVec];
    load_row<kFmt>(rows, lo + off, d, lane, va);
    if (two) load_row<kFmt>(rows, lo + off + 1, d, lane, vb);
    float sa = c2v::warp_sum(dot4<false>(va, sq, d4, lane));
    float sb = two ? c2v::warp_sum(dot4<false>(vb, sq, d4, lane)) : 0.f;
    if (kFmt != c2v::kF32) {
      sa *= scales[lo + off];
      if (two) sb *= scales[lo + off + 1];
    }
    if (lane == 0) {
      out[off] = sa;
      if (two) out[off + 1] = sb;
    }
  }
}

// (3') Large-k mode: K13's positions -> store positions or global ids;
// slots past the candidates (j >= k_sel) and dead slots -> -inf, -1 / 0.
__global__ void map_kernel(const float* sel_vals, const int* sel_pos,
                           int k_sel, const int64_t* offsets,
                           const int* probe, int nprobe, int max_len, int k,
                           const int* global_ids, float* out_vals,
                           int* out_idx, int b_rows) {
  const int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x;
  if (e >= static_cast<int64_t>(b_rows) * k) return;
  const int64_t b = e / k;
  const int j = static_cast<int>(e - b * k);
  const int dead_id = global_ids != nullptr ? 0 : -1;
  if (j >= k_sel) {
    out_vals[e] = -INFINITY;
    out_idx[e] = dead_id;
    return;
  }
  const int key = sel_pos[b * k_sel + j];
  const int rank = key / max_len, off = key - rank * max_len;
  const int list = probe[b * nprobe + rank];
  const int64_t lo = offsets[list];
  out_vals[e] = sel_vals[b * k_sel + j];
  if (off >= offsets[list + 1] - lo) {
    out_idx[e] = dead_id;
  } else {
    const int64_t pos = lo + off;
    out_idx[e] = global_ids != nullptr ? global_ids[pos]
                                       : static_cast<int>(pos);
  }
}

// ------------------------------------------------------------- host

bool bad_shape(int b, int d, int n_cent, int fmt, int nprobe, int max_len) {
  return b <= 0 || d <= 0 || d % 4 != 0 || d > 128 * kMaxVec || n_cent <= 0 ||
         fmt < c2v::kF32 || fmt > c2v::kInt4 || nprobe <= 0 ||
         nprobe > n_cent || max_len <= 0 ||
         static_cast<int64_t>(nprobe) * max_len > 0x7ffffffe;
}

int64_t select_smem(int b, int n_cent, int nprobe, int grouped) {
  const int64_t head = 4 * (2 * align_up(nprobe, 4) + 4);
  int64_t work = 4 * 64 * 8;  // the merge tree's lists
  if (nprobe > kMaxK) work = max64(work, static_cast<int64_t>(n_cent) * 4);
  if (grouped)
    work = max64(work, align_up(static_cast<int64_t>(n_cent) * 4, 16) +
                           static_cast<int64_t>(b < kGroup ? b : kGroup) *
                               nprobe * 8);
  return head + work;
}

// A scan CTA's: the header, the tile's scores and (below 16 queries a
// tile, b < 16) its queries, the chunk's span.
int64_t scan_smem(int fmt, int d, int rows_per_chunk, int tile_cap) {
  const int rb = fmt == c2v::kF32 ? 4 * d : fmt == c2v::kInt4 ? d / 2 : d;
  const int staged = tile_cap < kMemberTile ? d : 0;
  return align_up(kScanHead + static_cast<int64_t>(tile_cap) *
                                  (rows_per_chunk + staged) * 4,
                  128) +
         align_up(static_cast<int64_t>(rows_per_chunk) * rb, 16) + 16;
}

// Launch `kernel` on `grid` CTAs as a programmatic dependent of the
// stream's previous kernel: its CTAs may be resident before that kernel
// ends, and wait (griddepcontrol.wait) until its results are visible.
template <typename... KArgs, typename... Args>
cudaError_t launch_after(void (*kernel)(KArgs...), int64_t grid, size_t smem,
                         cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(grid));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

// Launches (1) and (2): probe, pstart and, with `build`, the slots.
cudaError_t probe_and_select(const float* q, int b, int d,
                             const float* centroids, int n_cent, int nprobe,
                             const int64_t* offsets, int rows_per_chunk,
                             int build, int grouped, float* cscores,
                             int* probe, int* pstart, Slot* slots,
                             Member* members, int* counters, cudaStream_t s) {
  const int groups = (b + kGroup - 1) / kGroup;
  const size_t probe_smem =
      static_cast<size_t>(b < kGroup ? b : kGroup) * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(probe_smem));
  if (err != cudaSuccess) return err;
  probe_kernel<<<dim3((n_cent + kWarps - 1) / kWarps, groups), kThreads,
                 probe_smem, s>>>(q, b, d, centroids, n_cent, cscores);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t sel_smem =
      static_cast<size_t>(select_smem(b, n_cent, nprobe, build && grouped));
  err = cudaFuncSetAttribute(select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sel_smem));
  if (err != cudaSuccess) return err;
  err = launch_after(select_kernel, b, sel_smem, s, cscores, b, n_cent,
                     nprobe, offsets, rows_per_chunk, build, grouped, probe,
                     pstart, slots, members, counters);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

C2V_EXPORT int c2v_ivf_max_k() { return kMaxK; }

// The dynamic shared memory of the selection (`grouped` as passed to
// c2v_ivf_search) and of a scan CTA owning `rows_per_chunk` rows of
// format `fmt` and width d: kernels/ivf.py `plan` computes the same.
C2V_EXPORT int64_t c2v_ivf_select_smem(int b, int n_cent, int nprobe,
                                       int grouped) {
  return select_smem(b, n_cent, nprobe, grouped);
}

C2V_EXPORT int64_t c2v_ivf_scan_smem(int fmt, int d, int rows_per_chunk,
                                     int tile_cap) {
  return scan_smem(fmt, d, rows_per_chunk, tile_cap);
}

// q f32 (b, d), d % 4 == 0; centroids f32 (n_cent, d); rows of format
// `fmt` (c2v::TableFormat): f32 (n, d) with scales null, or int8, e4m3,
// e5m2 (n, d bytes) or int4 (n, d / 2 bytes) with scales f32 (n,);
// offsets int64 (n_cent + 1,); global_ids int32 (n,) or null (positions
// out). The plan (kernels/ivf.py): rows_per_chunk R (1 to 128), grouped
// 0 / 1; cpl = max(1, ceil(max_len / R)) chunks a list at most, q =
// min(b, 64). Scratch: cscores f32 (b, n_cent), probe int32 (b, nprobe),
// pstart int32 (b, nprobe + 1), slots 32 bytes (b * nprobe), members 16
// bytes (b * nprobe, q), part uint64 (b, nprobe * cpl, k); counters
// int32 (ceil(b / 64) + b), zero on entry and left zero. Writes out_vals
// f32 (b, k), out_idx int32 (b, k).
C2V_EXPORT int c2v_ivf_search(const float* q, int b, int d,
                              const float* centroids, int n_cent,
                              const void* rows, const float* scales,
                              int fmt, const int64_t* offsets,
                              int max_len, const int* global_ids,
                              int nprobe, int k, int rows_per_chunk,
                              int grouped, float* cscores, int* probe,
                              int* pstart, void* slots, void* members,
                              void* part, int* counters, float* out_vals,
                              int* out_idx, void* stream) {
  if (bad_shape(b, d, n_cent, fmt, nprobe, max_len) || k <= 0 ||
      k > kMaxK || rows_per_chunk < 1 || rows_per_chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  const int64_t cpl = (max_len + rows_per_chunk - 1) / rows_per_chunk;
  const int64_t grid = static_cast<int64_t>(b) * nprobe * cpl;
  const int tile_cap = b < kMemberTile ? b : kMemberTile;
  if (grid > 0x7fffffff || static_cast<int64_t>(nprobe) * cpl > 0x7fffffff)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = (b + kGroup - 1) / kGroup;
  cudaError_t err = probe_and_select(
      q, b, d, centroids, n_cent, nprobe, offsets, rows_per_chunk, 1,
      grouped, cscores, probe, pstart, static_cast<Slot*>(slots),
      static_cast<Member*>(members), counters, s);
  if (err != cudaSuccess) return err;
  ScanArgs a;
  a.q_vecs = q;
  a.d = d;
  a.rows = rows;
  a.scales = scales;
  a.offsets = offsets;
  a.nprobe = nprobe;
  a.max_len = max_len;
  a.k = k;
  a.rows_per_chunk = rows_per_chunk;
  a.max_parts = static_cast<int>(nprobe * cpl);
  a.cpl = static_cast<int>(cpl);
  a.tile_cap = tile_cap;
  a.stage = tile_cap < kMemberTile;
  a.slots = static_cast<const Slot*>(slots);
  a.probe = probe;
  a.pstart = pstart;
  a.members = static_cast<const Member*>(members);
  a.q = b < kGroup ? b : kGroup;
  a.part = static_cast<uint64_t*>(part);
  a.qcount = counters + groups;
  a.global_ids = global_ids;
  a.out_vals = out_vals;
  a.out_idx = out_idx;
  const size_t smem =
      static_cast<size_t>(scan_smem(fmt, d, rows_per_chunk, tile_cap));
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    if ((e = launch_after(kernel, grid, smem, s, a)) != cudaSuccess)
      return e;
    return cudaGetLastError();
  };
  switch (fmt) {
    case c2v::kF32: err = run(scan_kernel<c2v::kF32>); break;
    case c2v::kInt8: err = run(scan_kernel<c2v::kInt8>); break;
    case c2v::kE4M3: err = run(scan_kernel<c2v::kE4M3>); break;
    case c2v::kE5M2: err = run(scan_kernel<c2v::kE5M2>); break;
    default: err = run(scan_kernel<c2v::kInt4>); break;
  }
  return err;
}

// Large-k mode, before K13: the probe (1, 2) and every probed row's score
// (2') into scores f32 (b, ld), ld >= nprobe * max_len. Arguments as in
// c2v_ivf_search; cscores f32 (b, n_cent) and probe int32 (b, nprobe)
// are scratch.
C2V_EXPORT int c2v_ivf_scores(const float* q, int b, int d,
                              const float* centroids, int n_cent,
                              const void* rows, const float* scales,
                              int fmt, const int64_t* offsets,
                              int max_len, int nprobe, float* cscores,
                              int* probe, float* scores, int64_t ld,
                              void* stream) {
  if (bad_shape(b, d, n_cent, fmt, nprobe, max_len) ||
      ld < static_cast<int64_t>(nprobe) * max_len)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = probe_and_select(
      q, b, d, centroids, n_cent, nprobe, offsets, max_len, 0, 0, cscores,
      probe, nullptr, nullptr, nullptr, nullptr, s);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(nprobe), static_cast<unsigned>(b));
  const size_t smem = sizeof(float) * d;
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, smem, s>>>(q, d, rows, scales, offsets, probe,
                                        nprobe, max_len, scores, ld);
  };
  switch (fmt) {
    case c2v::kF32: run(list_scores_kernel<c2v::kF32>); break;
    case c2v::kInt8: run(list_scores_kernel<c2v::kInt8>); break;
    case c2v::kE4M3: run(list_scores_kernel<c2v::kE4M3>); break;
    case c2v::kE5M2: run(list_scores_kernel<c2v::kE5M2>); break;
    default: run(list_scores_kernel<c2v::kInt4>); break;
  }
  return cudaGetLastError();
}

// Large-k mode, after K13: sel_vals f32 / sel_pos int32 (b, k_sel), the
// top k_sel padded candidate positions, -> out_vals f32 / out_idx int32
// (b, k), k >= k_sel.
C2V_EXPORT int c2v_ivf_map(const float* sel_vals, const int* sel_pos,
                           int b, int k_sel, const int64_t* offsets,
                           const int* probe, int nprobe, int max_len, int k,
                           const int* global_ids, float* out_vals,
                           int* out_idx, void* stream) {
  if (b <= 0 || k <= 0 || k_sel < 0 || k_sel > k || nprobe <= 0 ||
      max_len <= 0)
    return cudaErrorInvalidValue;
  const int64_t n = static_cast<int64_t>(b) * k;
  map_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      sel_vals, sel_pos, k_sel, offsets, probe, nprobe, max_len, k,
      global_ids, out_vals, out_idx, b);
  return cudaGetLastError();
}
