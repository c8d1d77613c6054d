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
// What bounds it on an H100: bytes. Each probed row is read once per
// query that probes it (f32: 1,536 bytes at width 384, int8 and fp8:
// 384 + 4, int4: 192 + 4) for
// 2 D operations, well under the card's ~20 f32 operations per byte; the
// least time counts every row of the union of the probed lists once.
// Design: three launches. (1) One CTA of 32 warps per query scores the
// centroids (one warp per centroid) into shared memory and ranks them by
// counting (rank = the number of centroids before it), so any nprobe up
// to nlist works without a sort. (2) One CTA per (probed list, query):
// the TPU version's sequential loop over candidates becomes independent
// CTAs. Each warp scores two rows at a time (lanes across the width, all
// of both rows' loads issued before the first product, a butterfly sum
// that leaves the same bits in every lane) and keeps its own top-k list
// in shared memory; the CTA then merges its warps' lists. (3) One warp
// per query merges the per-list partials by (value, candidate position)
// and maps positions to store rows or global ids. A scan is bound by the
// latency of its loads more than by their bytes, hence the loads in
// flight; reading each probed list once for all the queries that probe
// it is the next step.
//
// Large-k mode (k above the 64 entries a list holds): launch (2) becomes
// list_scores_kernel, which writes every probed row's score to a (b, ld)
// f32 matrix at its padded candidate position rank * max_len + offset
// (-inf past the list's end), K13 (csrc/select.cu) selects the top k
// positions, and map_kernel turns them into store positions or global
// ids, dead slots into -1 / 0.
#include "common.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kProbeThreads = 1024;
// 4-element vectors a lane holds of one row: rows up to 32 * 4 * 4 = 512
// wide
constexpr int kMaxVec = 4;

// The dot product of a row's vectors (lane's share, `v[i]` = vector
// lane + 32 i) with the query in shared memory.
__device__ __forceinline__ float dot4(const float4 (&v)[kMaxVec],
                                      const float* sq, int d4, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int w = lane + 32 * i;
    if (w < d4) {
      const float4 x = reinterpret_cast<const float4*>(sq)[w];
      s = fmaf(x.x, v[i].x, s);
      s = fmaf(x.y, v[i].y, s);
      s = fmaf(x.z, v[i].z, s);
      s = fmaf(x.w, v[i].w, s);
    }
  }
  return s;
}

// One row's vectors (f32, or a quantized format decoded to f32 before
// its scale: a lane's 4 values are 4 bytes, or 2 of int4), every load
// issued before any is used.
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

// (1) probe[b][r] = the centroid of rank r for query b.
__global__ void __launch_bounds__(kProbeThreads)
probe_kernel(const float* q, int d, const float* cent, int n_cent,
             int nprobe, int* probe) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // d
  float* sc = sq + d;                          // n_cent
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  for (int j = tid; j < d; j += kProbeThreads)
    sq[j] = q[static_cast<int64_t>(b) * d + j];
  __syncthreads();
  const int d4 = d / 4;
  for (int c = warp; c < n_cent; c += kProbeThreads / 32) {
    float4 v[kMaxVec];
    load_row<c2v::kF32>(cent, c, d, lane, v);
    const float s = c2v::warp_sum(dot4(v, sq, d4, lane));
    if (lane == 0) sc[c] = s;
  }
  __syncthreads();
  for (int c = tid; c < n_cent; c += kProbeThreads) {
    const float v = sc[c];
    int rank = 0;
    for (int j = 0; j < n_cent; ++j) rank += c2v::topk_before(sc[j], j, v, c);
    if (rank < nprobe) probe[static_cast<int64_t>(b) * nprobe + rank] = c;
  }
}

// (2) The top k of one probed list for one query. Candidates are keyed
// by rank * max_len + offset, so keys order like the reference's padded
// candidate positions.
template <int kFmt>
__global__ void __launch_bounds__(kThreads)
list_topk_kernel(const float* q, int d, const void* rows,
                 const float* scales, const int64_t* offsets,
                 const int* probe, int nprobe, int max_len, int k,
                 float* part_vals, int* part_keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);                  // d
  float* lv = sq + d;                                          // kWarps * k
  int* li = reinterpret_cast<int*>(lv + kWarps * k);           // kWarps * k
  const int p = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < d; j += kThreads)
    sq[j] = q[static_cast<int64_t>(b) * d + j];
  for (int e = tid; e < kWarps * k; e += kThreads) {
    lv[e] = -INFINITY;
    li[e] = c2v::kEmptyIndex;
  }
  __syncthreads();
  const int list = probe[static_cast<int64_t>(b) * nprobe + p];
  const int64_t lo = offsets[list], len = offsets[list + 1] - lo;
  float* wv = lv + warp * k;
  int* wi = li + warp * k;
  const int d4 = d / 4;
  for (int64_t off = 2 * warp; off < len; off += 2 * kWarps) {
    const bool two = off + 1 < len;  // warp-uniform
    float4 va[kMaxVec], vb[kMaxVec];
    load_row<kFmt>(rows, lo + off, d, lane, va);
    if (two) load_row<kFmt>(rows, lo + off + 1, d, lane, vb);
    float sa = c2v::warp_sum(dot4(va, sq, d4, lane));  // same bits in
    float sb = two ? c2v::warp_sum(dot4(vb, sq, d4, lane)) : 0.f;  // all
    if (kFmt != c2v::kF32) {
      sa *= scales[lo + off];
      if (two) sb *= scales[lo + off + 1];
    }
    const int key = p * max_len + static_cast<int>(off);
    if (c2v::topk_before(sa, key, wv[k - 1], wi[k - 1]))  // warp-uniform
      c2v::warp_topk_insert(wv, wi, k, sa, key, lane);
    if (two && c2v::topk_before(sb, key + 1, wv[k - 1], wi[k - 1]))
      c2v::warp_topk_insert(wv, wi, k, sb, key + 1, lane);
  }
  __syncthreads();
  if (warp == 0) {  // fold the other warps' lists into warp 0's
    for (int w = 1; w < kWarps; ++w) {
      for (int j0 = 0; j0 < k; j0 += 32) {
        const int j = j0 + lane;
        float x = -INFINITY;
        int xi = c2v::kEmptyIndex;
        if (j < k) x = lv[w * k + j], xi = li[w * k + j];
        unsigned ballot = __ballot_sync(
            c2v::kFullMask, xi != c2v::kEmptyIndex &&
                                c2v::topk_before(x, xi, lv[k - 1], li[k - 1]));
        while (ballot) {
          const int src = __ffs(ballot) - 1;
          ballot &= ballot - 1;
          const float cx = __shfl_sync(c2v::kFullMask, x, src);
          const int ci = __shfl_sync(c2v::kFullMask, xi, src);
          c2v::warp_topk_insert(lv, li, k, cx, ci, lane);
        }
      }
    }
    const int64_t o = (static_cast<int64_t>(b) * nprobe + p) * k;
    for (int j = lane; j < k; j += 32) {
      part_vals[o + j] = lv[j];
      part_keys[o + j] = li[j];
    }
  }
}

// (2') Large-k mode: every probed row's score at its padded candidate
// position, -inf past the end of its list.
template <int kFmt>
__global__ void __launch_bounds__(kThreads)
list_scores_kernel(const float* q, int d, const void* rows,
                   const float* scales, const int64_t* offsets,
                   const int* probe, int nprobe, int max_len, float* scores,
                   int64_t ld) {
  extern __shared__ __align__(16) unsigned char smem[];
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
    float sa = c2v::warp_sum(dot4(va, sq, d4, lane));
    float sb = two ? c2v::warp_sum(dot4(vb, sq, d4, lane)) : 0.f;
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

// (3) One warp per query: the top k of its nprobe partial lists, then
// keys -> positions (index) or global ids (MIPS).
__global__ void __launch_bounds__(32)
merge_kernel(const float* part_vals, const int* part_keys,
             const int64_t* offsets, const int* probe, int nprobe,
             int max_len, int k, const int* global_ids, float* out_vals,
             int* out_idx) {
  __shared__ float lv[kMaxK];
  __shared__ int li[kMaxK];
  const int b = blockIdx.x, lane = threadIdx.x;
  for (int j = lane; j < k; j += 32) {
    lv[j] = -INFINITY;
    li[j] = c2v::kEmptyIndex;
  }
  __syncwarp();
  const int64_t n = static_cast<int64_t>(nprobe) * k;
  const float* pv = part_vals + b * n;
  const int* pk = part_keys + b * n;
  for (int64_t e0 = 0; e0 < n; e0 += 32) {
    const int64_t e = e0 + lane;
    float x = -INFINITY;
    int xi = c2v::kEmptyIndex;
    if (e < n) x = pv[e], xi = pk[e];
    unsigned ballot = __ballot_sync(
        c2v::kFullMask,
        xi != c2v::kEmptyIndex && c2v::topk_before(x, xi, lv[k - 1], li[k - 1]));
    while (ballot) {
      const int src = __ffs(ballot) - 1;
      ballot &= ballot - 1;
      const float cx = __shfl_sync(c2v::kFullMask, x, src);
      const int ci = __shfl_sync(c2v::kFullMask, xi, src);
      c2v::warp_topk_insert(lv, li, k, cx, ci, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    const int key = li[j];
    const int64_t o = static_cast<int64_t>(b) * k + j;
    if (key == c2v::kEmptyIndex) {
      out_vals[o] = -INFINITY;
      out_idx[o] = global_ids != nullptr ? 0 : -1;
      continue;
    }
    const int rank = key / max_len, off = key - rank * max_len;
    const int list = probe[static_cast<int64_t>(b) * nprobe + rank];
    const int64_t pos = offsets[list] + off;
    out_vals[o] = lv[j];
    out_idx[o] = global_ids != nullptr ? global_ids[pos]
                                       : static_cast<int>(pos);
  }
}

}  // namespace

C2V_EXPORT int c2v_ivf_max_k() { return kMaxK; }

// q f32 (b, d), d % 4 == 0; centroids f32 (n_cent, d); rows of format
// `fmt` (c2v::TableFormat): f32 (n, d) with scales null, or int8, e4m3,
// e5m2 (n, d bytes) or int4 (n, d / 2 bytes) with scales f32 (n,);
// offsets int64 (n_cent + 1,); global_ids int32 (n,) or null (positions
// out).
// Scratch: probe int32 (b, nprobe), part_vals f32 / part_keys int32
// (b, nprobe, k). Writes out_vals f32 (b, k), out_idx int32 (b, k).
C2V_EXPORT int c2v_ivf_search(const float* q, int b, int d,
                              const float* centroids, int n_cent,
                              const void* rows, const float* scales,
                              int fmt, const int64_t* offsets,
                              int max_len, const int* global_ids,
                              int nprobe, int k, int* probe,
                              float* part_vals, int* part_keys,
                              float* out_vals, int* out_idx, void* stream) {
  if (b <= 0 || d <= 0 || d % 4 != 0 || d > 128 * kMaxVec || n_cent <= 0 ||
      fmt < c2v::kF32 || fmt > c2v::kInt4 || nprobe <= 0 ||
      nprobe > n_cent || k <= 0 || k > kMaxK || max_len <= 0 ||
      static_cast<int64_t>(nprobe) * max_len > 0x7ffffffe)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t probe_smem = sizeof(float) * (d + n_cent);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(probe_smem));
  if (err != cudaSuccess) return err;
  probe_kernel<<<b, kProbeThreads, probe_smem, s>>>(q, d, centroids, n_cent,
                                                    nprobe, probe);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(nprobe), static_cast<unsigned>(b));
  const size_t list_smem = sizeof(float) * d + 8 * kWarps * k;
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, list_smem, s>>>(q, d, rows, scales, offsets,
                                             probe, nprobe, max_len, k,
                                             part_vals, part_keys);
  };
  switch (fmt) {
    case c2v::kF32: run(list_topk_kernel<c2v::kF32>); break;
    case c2v::kInt8: run(list_topk_kernel<c2v::kInt8>); break;
    case c2v::kE4M3: run(list_topk_kernel<c2v::kE4M3>); break;
    case c2v::kE5M2: run(list_topk_kernel<c2v::kE5M2>); break;
    default: run(list_topk_kernel<c2v::kInt4>); break;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_kernel<<<b, 32, 0, s>>>(part_vals, part_keys, offsets, probe, nprobe,
                                max_len, k, global_ids, out_vals, out_idx);
  return cudaGetLastError();
}

// Large-k mode, before K13: the probe (1) and every probed row's score
// (2') into scores f32 (b, ld), ld >= nprobe * max_len. Arguments as in
// c2v_ivf_search.
C2V_EXPORT int c2v_ivf_scores(const float* q, int b, int d,
                              const float* centroids, int n_cent,
                              const void* rows, const float* scales,
                              int fmt, const int64_t* offsets,
                              int max_len, int nprobe, int* probe,
                              float* scores, int64_t ld, void* stream) {
  if (b <= 0 || d <= 0 || d % 4 != 0 || d > 128 * kMaxVec || n_cent <= 0 ||
      fmt < c2v::kF32 || fmt > c2v::kInt4 || nprobe <= 0 ||
      nprobe > n_cent || max_len <= 0 ||
      static_cast<int64_t>(nprobe) * max_len > 0x7ffffffe ||
      ld < static_cast<int64_t>(nprobe) * max_len)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t probe_smem = sizeof(float) * (d + n_cent);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(probe_smem));
  if (err != cudaSuccess) return err;
  probe_kernel<<<b, kProbeThreads, probe_smem, s>>>(q, d, centroids, n_cent,
                                                    nprobe, probe);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
