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
// What bounds it on an H100: bytes. The scores are read once per radix
// pass (four) and once more to compact the winners; the least time counts
// one read of the scores and one write of the k results per row. Design:
// one CTA of 1024 threads per row.
//   (1) Radix select over order-preserving uint32 keys (a larger float
//       has a larger key, every NaN the largest, -0 taken as +0): four
//       passes of 8-bit digits, most significant first, each a
//       256-bin histogram in shared memory of the keys that share the
//       digits chosen so far; one warp then picks the digit where the
//       count from the top reaches k. After four passes the k-th largest
//       key T is known, and how many keys equal to T the top k holds.
//   (2) Compaction in position order: each thread takes 8 consecutive
//       elements, a block-wide scan of the (above T, equal to T) counts
//       gives every winner its slot, and the keys equal to T are taken
//       lowest positions first, which is the reference's tie rule.
//   (3) A bitonic sort of the k winners by (key, -position), descending,
//       in shared memory (k <= 16384), or in a global scratch row for a
//       larger k; values are read back from the scores, so the output
//       keeps each score's bits.
// Integer counts and a fixed scan make the result the same on every run.
// Scores are read with 16-byte loads: rows start 16-byte aligned (the
// row stride is a multiple of 4), eight loads per thread in flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;       // consecutive elements a thread compacts
constexpr int kSortSmem = 16384;    // winners sorted in shared memory

__device__ __forceinline__ uint32_t score_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(c2v::kFullMask, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const float* scores, int64_t ld, int n, int k, int sort_len,
              unsigned long long* global_buf, float* out_vals,
              int* out_pos) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned int hist[256];
  __shared__ int warp_tot[kWarps];
  __shared__ uint32_t s_prefix, s_mask;
  __shared__ int s_remaining, s_gt, s_eq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row = blockIdx.x;
  const float* x = scores + row * ld;
  unsigned long long* buf =
      sort_len <= kSortSmem ? reinterpret_cast<unsigned long long*>(smem)
                            : global_buf + row * sort_len;
  const int n4 = (n + 3) / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);

  // (1) radix select: the k-th largest key
  uint32_t prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0u;
    __syncthreads();
    for (int i0 = tid; i0 < n4; i0 += 2 * kThreads) {
      float4 v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n4 ? x4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * kThreads;
        const float e[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t key = score_key(e[q]);
          if (i < n4 && 4 * i + q < n && (key & mask) == prefix)
            atomicAdd(&hist[(key >> shift) & 255u], 1u);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned c[8];
      int sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - (lane * 8 + j)];
        sum += static_cast<int>(c[j]);
      }
      const int incl = warp_incl_scan(sum, lane);
      int run = incl - sum;
      if (run < remaining && remaining <= incl) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + static_cast<int>(c[j]) >= remaining) {
            const uint32_t digit = 255u - static_cast<uint32_t>(lane * 8 + j);
            s_prefix = prefix | (digit << shift);
            s_mask = mask | (255u << shift);
            s_remaining = remaining - run;
            break;
          }
          run += static_cast<int>(c[j]);
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    mask = s_mask;
    remaining = s_remaining;
  }
  const uint32_t t_key = prefix;
  const int need = remaining, above = k - need;

  // (2) compaction in position order
  if (tid == 0) s_gt = 0, s_eq = 0;
  for (int base = 0; base < n; base += kThreads * kPerThread) {
    const int i0 = base + tid * kPerThread;
    uint32_t keys[kPerThread];
    int gt = 0, eq = 0;
#pragma unroll
    for (int u = 0; u < kPerThread / 4; ++u) {
      const int i4 = i0 / 4 + u;
      const float4 v = i4 < n4 ? x4[i4] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = u * 4 + q;
        keys[j] = score_key(e[q]);
        const bool live = i0 + j < n;
        gt += live && keys[j] > t_key;
        eq += live && keys[j] == t_key;
      }
    }
    const int packed = gt | (eq << 16);  // each total <= 8192
    const int incl = warp_incl_scan(packed, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_tot[lane];
      warp_tot[lane] = warp_incl_scan(w, lane) - w;
    }
    __syncthreads();
    const int excl = warp_tot[warp] + incl - packed;
    int gt_at = s_gt + (excl & 0xffff), eq_at = s_eq + (excl >> 16);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (i0 + j >= n) break;
      const unsigned long long c =
          (static_cast<unsigned long long>(keys[j]) << 32) |
          static_cast<unsigned long long>(~static_cast<uint32_t>(i0 + j));
      if (keys[j] > t_key) {
        buf[gt_at++] = c;
      } else if (keys[j] == t_key) {
        if (eq_at < need) buf[above + eq_at] = c;
        ++eq_at;
      }
    }
    __syncthreads();  // every thread has read s_gt and s_eq
    if (tid == kThreads - 1) {
      s_gt += (excl + packed) & 0xffff;
      s_eq += (excl + packed) >> 16;
    }
    __syncthreads();
  }
  for (int i = k + tid; i < sort_len; i += kThreads) buf[i] = 0ull;
  __syncthreads();

  // (3) bitonic sort, descending
  for (int size = 2; size <= sort_len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < sort_len / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a < b) == up) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += kThreads) {
    const int pos = static_cast<int>(~static_cast<uint32_t>(buf[j]));
    out_pos[row * k + j] = pos;
    out_vals[row * k + j] = x[pos];
  }
}

}  // namespace

// Entries of a row's winners sorted in shared memory; a larger k sorts in
// a global scratch of (rows, sort_len) uint64.
C2V_EXPORT int c2v_select_smem_entries() { return kSortSmem; }

// scores: f32 (rows, ld), 16-byte aligned, ld % 4 == 0; the first n
// columns of each row are the candidates. k in 1..n. sort_len: the power
// of two >= k (>= 2). scratch: uint64 (rows, sort_len) when sort_len >
// c2v_select_smem_entries(), else ignored. Writes out_vals f32 (rows, k)
// and out_pos int32 (rows, k). Returns a cudaError_t.
C2V_EXPORT int c2v_select_topk(const float* scores, int rows, int64_t ld,
                               int n, int k, int sort_len, void* scratch,
                               float* out_vals, int* out_pos, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || k > n || ld < n || ld % 4 != 0 ||
      sort_len < k || sort_len < 2 || (sort_len & (sort_len - 1)) != 0 ||
      (sort_len > kSortSmem && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = sort_len <= kSortSmem ? 8 * sort_len : 0;
  cudaError_t err = cudaFuncSetAttribute(
      select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  select_kernel<<<rows, kThreads, smem, s>>>(
      scores, ld, n, k, sort_len,
      static_cast<unsigned long long*>(scratch), out_vals, out_pos);
  return cudaGetLastError();
}
