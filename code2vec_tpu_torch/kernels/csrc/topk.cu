// K3 blockwise_topk: top-k and logsumexp of bf16(cv) @ bf16(table).T, and
// in its float32 mode (topk_partial_f32_kernel, below) of cv @ table.T
// with f32 operands and f32 FMAs.
//
// Replaces code2vec_tpu/ops/topk.py blockwise_matmul_top_k (:99-179) with
// its merge `_merge_top_k` (:41-52) and streaming logsumexp `_fold_lse`
// (:55-69): logits accumulate in f32 from bf16 operands, the per-row
// dequant scale multiplies the f32 logits after the product, rows at or
// above `valid_rows` are dead, ties go to the lowest index (NaN ranks
// first, as lax.top_k orders it), and the logsumexp sees every live
// non-finite logit as -1e30 while the top-k merges the raw logits.
//
// What bounds it on an H100: bytes. At the serve shape the int8 table is
// 100 MB against 12.8 GFLOP, ~130 flops per byte, under the card's ~295,
// so the floor is one pass over the table (~30 us). Design: split-V. The
// TPU version walks the table in a sequential loop; here every CTA owns a
// contiguous chunk of table rows and streams it once in 64-row tiles,
// computing the logits of all (up to 64) code vectors per tile on the
// tensor cores (WMMA, bf16 in, f32 out) so each table byte is read once
// for the whole batch; the next int8 tile is already loading into
// registers meanwhile, and two CTAs share an SM. Each warp then folds its
// rows' logits into a running top-k list in shared memory (a ballot
// against the list's last entry keeps insertions rare once the list
// fills, and the warp inserts cooperatively, since splitting V multiplies
// the insertions) and a per-lane running (max, sumexp). A second launch
// merges the per-chunk partials. Every table row belongs to exactly one
// chunk, so no row is counted twice.
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTileB = 64;     // code vectors per CTA
constexpr int kTileV = 64;     // table rows per tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTileB / kWarps;
constexpr int kPad = 8;
constexpr int kMaxK = 64;
// 16-byte table vectors a thread holds in registers: a whole int8 tile of
// rows up to 512 wide, prefetched while the previous tile is processed.
constexpr int kPrefetch = 8;

struct Layout {
  int ld, ldl;
  int64_t a, t, scale, vals, idx, total;
};

// Shared memory: code vectors (bf16), the table tile (bf16; the f32
// logits of the tile overlay it once the product is done), the tile's
// scales, and each code vector's running top-k list.
__host__ __device__ inline Layout layout(int d, int k) {
  Layout s;
  s.ld = d + kPad;
  s.ldl = kTileV + 4;
  s.a = 0;
  s.t = s.a + 2LL * kTileB * s.ld;
  const int64_t t_bytes = 2LL * kTileV * s.ld, l_bytes = 4LL * kTileB * s.ldl;
  s.scale = s.t + (t_bytes > l_bytes ? t_bytes : l_bytes);
  s.vals = s.scale + 4LL * kTileV;
  s.idx = s.vals + 4LL * kTileB * k;
  s.total = s.idx + 4LL * kTileB * k;
  return s;
}

// Fold one tile's logits (kTileB code vectors x kTileV table rows, row
// stride ldl in `sl`) into each code vector's running top-k list and the
// lanes' running (max, sumexp); warp w owns code vectors w, w + 8, ...
template <bool kScaled>
__device__ __forceinline__ void fold_tile(
    const float* sl, int ldl, const float* sscale, int64_t t0, int64_t v_end,
    int64_t valid_rows, int b0, int b_rows, int k, float* svals, int* sidx,
    float (&run_m)[kRowsPerWarp], float (&run_s)[kRowsPerWarp], int warp,
    int lane) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (b0 + r >= b_rows) continue;  // warp-uniform
    float* lv = svals + r * k;
    int* li = sidx + r * k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h;
      const int64_t v = t0 + c;
      float x = -INFINITY;
      bool live = false;
      if (v < v_end) {
        x = sl[r * ldl + c];
        if (kScaled) x *= sscale[c];
        live = v < valid_rows;
        if (!live) x = -INFINITY;
        // streaming logsumexp with the reference's nonfinite guard
        const float y = (live && !isfinite(x)) ? -1e30f : x;
        if (y > run_m[i]) {
          run_s[i] = (isfinite(run_m[i]) ? run_s[i] * expf(run_m[i] - y)
                                         : 0.f) + 1.f;
          run_m[i] = y;
        } else if (isfinite(y)) {
          run_s[i] += expf(y - run_m[i]);
        }
      }
      const int vi = static_cast<int>(v);
      unsigned ballot = __ballot_sync(
          c2v::kFullMask, live && c2v::topk_before(x, vi, lv[k - 1], li[k - 1]));
      while (ballot) {
        const int srcl = __ffs(ballot) - 1;
        ballot &= ballot - 1;
        const float cx = __shfl_sync(c2v::kFullMask, x, srcl);
        const int ci = __shfl_sync(c2v::kFullMask, vi, srcl);
        c2v::warp_topk_insert(lv, li, k, cx, ci, lane);
      }
    }
  }
}

// A CTA's partial results: per code vector and chunk its (max, sumexp)
// and top-k list. Partials are laid out [code vector][chunk] so the merge
// reads one code vector's lists contiguously.
__device__ __forceinline__ void write_partials(
    float (&run_m)[kRowsPerWarp], float (&run_s)[kRowsPerWarp],
    const float* svals, const int* sidx, int b0, int b_rows, int k,
    int64_t chunk, int64_t n_chunks, float* part_vals, int* part_idx,
    float* part_max, float* part_sum, int tid, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + kWarps * i;
    if (b0 + r >= b_rows) continue;
    float m = run_m[i], s = run_s[i];
    c2v::warp_lse_reduce(m, s);
    if (lane == 0) {
      part_max[(b0 + r) * n_chunks + chunk] = m;
      part_sum[(b0 + r) * n_chunks + chunk] = s;
    }
  }
  for (int e = tid; e < kTileB * k; e += kThreads) {
    const int r = e / k, j = e - r * k;
    if (b0 + r >= b_rows) continue;
    const int64_t o = ((b0 + r) * n_chunks + chunk) * k + j;
    part_vals[o] = svals[e];
    part_idx[o] = sidx[e];
  }
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads, 2)
topk_partial_kernel(const float* cv, int b_rows, int d, const void* table,
                    const float* scales, int64_t v_rows, int64_t valid_rows,
                    int k, int64_t chunk_rows, int64_t n_chunks,
                    float* part_vals, int* part_idx, float* part_max,
                    float* part_sum) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(d, k);
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem + L.a);
  __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem + L.t);
  float* sl = reinterpret_cast<float*>(smem + L.t);  // after the product
  float* sscale = reinterpret_cast<float*>(smem + L.scale);
  float* svals = reinterpret_cast<float*>(smem + L.vals);
  int* sidx = reinterpret_cast<int*>(smem + L.idx);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t chunk = blockIdx.x;
  const int b0 = blockIdx.y * kTileB;
  const int64_t v_begin = chunk * chunk_rows;
  const int64_t v_end =
      v_begin + chunk_rows < v_rows ? v_begin + chunk_rows : v_rows;

  for (int e = tid; e < kTileB * d / 4; e += kThreads) {  // float4 loads
    const int r = e / (d / 4), c = (e - r * (d / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b0 + r < b_rows)
      x = *reinterpret_cast<const float4*>(
          cv + static_cast<int64_t>(b0 + r) * d + c);
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(sa + r * L.ld + c);
    dst[0] = __floats2bfloat162_rn(x.x, x.y);
    dst[1] = __floats2bfloat162_rn(x.z, x.w);
  }
  for (int e = tid; e < kTileB * k; e += kThreads) {
    svals[e] = -INFINITY;
    sidx[e] = c2v::kEmptyIndex;
  }
  float run_m[kRowsPerWarp], run_s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
  }

  // The table tile moves as raw 16-byte vectors: 16 int8 or 4 f32 values.
  const int64_t row_bytes = static_cast<int64_t>(d) * (kInt8 ? 1 : 4);
  const int vpr = static_cast<int>(row_bytes / 16);  // vectors per row
  const int nv = kTileV * vpr;
  const int passes = (nv + kPrefetch * kThreads - 1) / (kPrefetch * kThreads);
  const unsigned char* tbytes = static_cast<const unsigned char*>(table);
  int4 pre[kPrefetch];
  float pre_scale = 1.f;

  auto load_pass = [&](int64_t t0, int pass) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int e = (pass * kPrefetch + q) * kThreads + tid;
      int4 val = make_int4(0, 0, 0, 0);
      if (e < nv) {
        const int r = e / vpr, c = e - r * vpr;
        if (t0 + r < v_end)
          val = reinterpret_cast<const int4*>(tbytes + (t0 + r) * row_bytes)[c];
      }
      pre[q] = val;
    }
    if (pass == 0)
      pre_scale = (kInt8 && tid < kTileV && t0 + tid < v_end)
                      ? scales[t0 + tid] : 1.f;
  };
  auto store_pass = [&](int pass) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int e = (pass * kPrefetch + q) * kThreads + tid;
      if (e >= nv) continue;
      const int r = e / vpr, c = e - r * vpr;
      if (kInt8) {
        const int8_t* b8 = reinterpret_cast<const int8_t*>(&pre[q]);
        __align__(16) __nv_bfloat162 o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          o[i] = __floats2bfloat162_rn(static_cast<float>(b8[2 * i]),
                                       static_cast<float>(b8[2 * i + 1]));
        uint4* dst = reinterpret_cast<uint4*>(st + r * L.ld + c * 16);
        dst[0] = *reinterpret_cast<const uint4*>(&o[0]);
        dst[1] = *reinterpret_cast<const uint4*>(&o[4]);
      } else {
        const float* f = reinterpret_cast<const float*>(&pre[q]);
        __align__(8) __nv_bfloat162 o[2] = {__floats2bfloat162_rn(f[0], f[1]),
                                            __floats2bfloat162_rn(f[2], f[3])};
        *reinterpret_cast<uint2*>(st + r * L.ld + c * 4) =
            *reinterpret_cast<const uint2*>(o);
      }
    }
  };

  if (v_begin < v_end) load_pass(v_begin, 0);
  const int fr = warp >> 1;        // 16-row block of code vectors
  const int fc = (warp & 1) * 2;   // first of two 16-row blocks of table
  for (int64_t t0 = v_begin; t0 < v_end; t0 += kTileV) {
    __syncthreads();  // the previous tile's logits and scales are consumed
    store_pass(0);
    for (int p = 1; p < passes; ++p) {  // wide f32 rows: no overlap
      load_pass(t0, p);
      store_pass(p);
    }
    if (tid < kTileV) sscale[tid] = pre_scale;
    __syncthreads();
    if (t0 + kTileV < v_end) load_pass(t0 + kTileV, 0);  // next tile

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    for (int kk = 0; kk < d; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sa + fr * 16 * L.ld + kk, L.ld);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // table rows as the columns of B: element (kk, n) at st[n*ld + kk]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> bf;
        wmma::load_matrix_sync(bf, st + (fc + j) * 16 * L.ld + kk, L.ld);
        wmma::mma_sync(acc[j], a, bf, acc[j]);
      }
    }
    __syncthreads();  // every warp is done reading st; sl overlays it
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sl + fr * 16 * L.ldl + (fc + j) * 16, acc[j],
                              L.ldl, wmma::mem_row_major);
    __syncthreads();

    fold_tile<kInt8>(sl, L.ldl, sscale, t0, v_end, valid_rows, b0, b_rows, k,
                     svals, sidx, run_m, run_s, warp, lane);
  }
  __syncthreads();
  write_partials(run_m, run_s, svals, sidx, b0, b_rows, k, chunk, n_chunks,
                 part_vals, part_idx, part_max, part_sum, tid, warp, lane);
}

// The float32-compute mode: the same split-V partials, with the tile's
// logits as f32 FMAs of the f32 operands (no bf16 rounding, no TF32), the
// brute-force search of the retrieval index
// (code2vec_tpu/retrieval/index.py `_search_brute` :306-317 calls
// blockwise_matmul_top_k with its default compute_dtype=float32). Bound
// by operations at the index shape (64 queries x 1M rows x 384: 49 GFLOP
// of f32 FMAs over 1.54 GB). Each thread holds 4 code vectors x 4 table
// rows of the 64 x 64 tile in registers; 32-deep slices of both operands
// are staged k-major in shared memory, so each thread reads float4s.
constexpr int kF32BK = 32;

struct F32Layout {
  int ldl;
  int64_t a, t, l, vals, idx, total;
};

__host__ __device__ inline F32Layout f32_layout(int k) {
  F32Layout s;
  s.ldl = kTileV + 4;
  s.a = 0;
  s.t = s.a + 4LL * kF32BK * kTileB;
  s.l = s.t + 4LL * kF32BK * kTileV;
  s.vals = s.l + 4LL * kTileB * s.ldl;
  s.idx = s.vals + 4LL * kTileB * k;
  s.total = s.idx + 4LL * kTileB * k;
  return s;
}

// A [kF32BK][tile] k-major slice of rows [row0, row0 + tile) of `src`
// (row-major, width d, d % 4 == 0), zero past `row_end`.
__device__ __forceinline__ void f32_slice(float* dst, const float* src,
                                          int64_t row0, int64_t row_end,
                                          int d, int k0, int tile, int tid) {
  constexpr int per_row = kF32BK / 4;
  for (int e = tid; e < tile * per_row; e += kThreads) {
    const int r = e / per_row, q = (e - r * per_row) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < row_end && k0 + q < d)
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * d + k0 + q);
    dst[(q + 0) * tile + r] = x.x;
    dst[(q + 1) * tile + r] = x.y;
    dst[(q + 2) * tile + r] = x.z;
    dst[(q + 3) * tile + r] = x.w;
  }
}

__global__ void __launch_bounds__(kThreads)
topk_partial_f32_kernel(const float* cv, int b_rows, int d,
                        const float* table, int64_t v_rows,
                        int64_t valid_rows, int k, int64_t chunk_rows,
                        int64_t n_chunks, float* part_vals, int* part_idx,
                        float* part_max, float* part_sum) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Layout L = f32_layout(k);
  float* sa = reinterpret_cast<float*>(smem + L.a);
  float* st = reinterpret_cast<float*>(smem + L.t);
  float* sl = reinterpret_cast<float*>(smem + L.l);
  float* svals = reinterpret_cast<float*>(smem + L.vals);
  int* sidx = reinterpret_cast<int*>(smem + L.idx);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t chunk = blockIdx.x;
  const int b0 = blockIdx.y * kTileB;
  const int64_t v_begin = chunk * chunk_rows;
  const int64_t v_end =
      v_begin + chunk_rows < v_rows ? v_begin + chunk_rows : v_rows;
  for (int e = tid; e < kTileB * k; e += kThreads) {
    svals[e] = -INFINITY;
    sidx[e] = c2v::kEmptyIndex;
  }
  float run_m[kRowsPerWarp], run_s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
  }
  for (int64_t t0 = v_begin; t0 < v_end; t0 += kTileV) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += kF32BK) {
      __syncthreads();  // the previous slice (and tile's logits) consumed
      f32_slice(sa, cv, b0, b_rows, d, k0, kTileB, tid);
      f32_slice(st, table, t0, v_end, d, k0, kTileV, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kF32BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            sa + kk * kTileB + ty * 4);
        const float4 t = *reinterpret_cast<const float4*>(
            st + kk * kTileV + tx * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], tv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(sl + (ty * 4 + i) * L.ldl + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();
    fold_tile<false>(sl, L.ldl, nullptr, t0, v_end, valid_rows, b0, b_rows,
                     k, svals, sidx, run_m, run_s, warp, lane);
  }
  __syncthreads();
  write_partials(run_m, run_s, svals, sidx, b0, b_rows, k, chunk, n_chunks,
                 part_vals, part_idx, part_max, part_sum, tid, warp, lane);
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

}  // namespace

C2V_EXPORT int c2v_topk_max_k() { return kMaxK; }
C2V_EXPORT int c2v_topk_tile_rows() { return kTileV; }

C2V_EXPORT int64_t c2v_topk_smem(int d, int k) { return layout(d, k).total; }

// cv: f32 (b, d). table: int8 (v, d) with f32 (v,) scales, or f32 (v, d)
// with scales null. compute_f32: 0 rounds both operands to bf16 (tensor
// cores), 1 multiplies the f32 operands in f32 (f32 tables only).
// Partials: (b, n_chunks, k) values/indices and (b, n_chunks)
// max/sumexp, n_chunks = ceil(v / chunk_rows). Outputs: values f32
// (b, k), indices int32 (b, k), lse f32 (b,).
C2V_EXPORT int c2v_blockwise_topk(const float* cv, int b, int d,
                                  const void* table, const float* scales,
                                  int is_int8, int compute_f32, int64_t v,
                                  int64_t valid_rows, int k,
                                  int64_t chunk_rows, float* part_vals,
                                  int* part_idx, float* part_max,
                                  float* part_sum, float* out_vals,
                                  int* out_idx, float* out_lse,
                                  void* stream) {
  if (b <= 0 || v <= 0 || k <= 0 || k > kMaxK || d % 16 != 0 ||
      chunk_rows <= 0 || (is_int8 && d > 16 * kPrefetch * kThreads / kTileV) ||
      (compute_f32 && is_int8))
    return cudaErrorInvalidValue;
  const int64_t n_chunks = (v + chunk_rows - 1) / chunk_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  static_cast<unsigned>((b + kTileB - 1) / kTileB));
  cudaError_t err;
  if (compute_f32) {
    const int64_t smem = f32_layout(k).total;
    err = cudaFuncSetAttribute(topk_partial_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    topk_partial_f32_kernel<<<grid, kThreads, smem, s>>>(
        cv, b, d, static_cast<const float*>(table), v, valid_rows, k,
        chunk_rows, n_chunks, part_vals, part_idx, part_max, part_sum);
  } else if (is_int8) {
    const int64_t smem = layout(d, k).total;
    err = cudaFuncSetAttribute(topk_partial_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    topk_partial_kernel<true><<<grid, kThreads, smem, s>>>(
        cv, b, d, table, scales, v, valid_rows, k, chunk_rows, n_chunks,
        part_vals, part_idx, part_max, part_sum);
  } else {
    const int64_t smem = layout(d, k).total;
    err = cudaFuncSetAttribute(topk_partial_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    topk_partial_kernel<false><<<grid, kThreads, smem, s>>>(
        cv, b, d, table, scales, v, valid_rows, k, chunk_rows, n_chunks,
        part_vals, part_idx, part_max, part_sum);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t merge_smem = 8 * n_chunks * k + 8 * kMaxK;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(merge_smem));
  if (err != cudaSuccess) return err;
  topk_merge_kernel<<<b, 32, merge_smem, s>>>(part_vals, part_idx, part_max,
                                              part_sum, n_chunks, k, out_vals,
                                              out_idx, out_lse);
  return cudaGetLastError();
}
