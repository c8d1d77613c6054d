// K1 context_encoder: gather + dequant + concat + bf16 cast + dropout +
// tanh(ctx @ W).
//
// Replaces code2vec_tpu/models/code2vec.py transform_contexts /
// transform_gathered (:128-177), as mirrored by the release step
// (code2vec_tpu/release/runtime.py:113-122) over ops/quant.py
// table_gather / dequant_gather / dequant_gather_int4 (:151-194), for
// tables stored as f32, int8, fp8 e4m3 or e5m2 (the reference's fp8 view
// at load, runtime.py:312-352), or packed int4. In train mode it applies the
// reference's dropout after the bf16 cast (:167-173):
// where(keep, bf16(x / bf16(keep)), 0), with the keep bits drawn by a
// Philox generator keyed by (seed, step) and each element's flat index in
// the (B, M, 3d) context (common.cuh), so the backward (K5,
// encoder_backward.cu) redraws them and no mask is stored. Tests inject a
// mask or have the kernel write out the one it drew. For the backward it
// can also write the residual bf16(tanh - bf16(tanh)), so that K5
// differentiates tanh at (nearly) its f32 value, as the reference does.
//
// What bounds it on an H100: bytes at the train shape (1024 x 200
// contexts, 384 -> 384: ~315 MB of random f32 rows, 157 MB of bf16 output
// and residual, 60 GFLOP), the product at the serve shape (64 x 200: 3.8
// GFLOP against ~5 MB of int8 rows). Random 512-byte row gathers reach
// ~2.7 TB/s on the H100 only with ~32 KB in flight per SM (~2.0 TB/s at
// 8 KB; csrc/gather_probe.cu, PERF.md), and in train mode the work is
// also near the card's issue rate (Philox, the dropout's division, tanh:
// ~65 instructions an element), so the design is about reading each row
// once, keeping bytes in flight, and keeping every warp issuing.
// Design: a persistent CTA per SM walks 64-context tiles. It owns all
// 384 output columns of a tile (wider codes: column groups of 384, each
// gathering again), so each context's three rows are gathered once. The
// context is built 64 columns (one K-chunk) at a time: 512 consumer
// threads each own two 4-value units of the chunk (a fixed column, two
// rows), load them with one vector load each (16 bytes of f32, 4 of int8
// or fp8, 2 of packed int4: any row width that is a multiple of 4 values,
// whole 16-byte units or not) two chunks ahead of their use, and convert
// a chunk (decode exactly, times the row's scale, bf16, dropout) into a
// 128-byte-swizzled K-major bf16 tile while the previous chunk's `wgmma`
// runs. Bytes in flight per SM: 512 threads x 2 units x 2 chunks x 16
// bytes = 32 KB of f32 rows (8 KB of int8 or fp8, 4 KB of int4). The
// four consumer warpgroups run m64n96k16 `wgmma` (f32 accumulators, 48 a
// thread) on the chunk's tile and their quarter of W's chunk, and at a
// tile's end stage the accumulators in shared memory; three epilogue
// warps take tanh in f32 and store bf16 rows (and in train mode the
// residual) in 16-byte units while the consumers gather the next tile.
// W is rounded to bf16 once per call by its own launch (`w_tiles`), laid
// out as K-major swizzled chunks of 64 K rows x 384 columns; the producer
// warp streams each chunk into a 2-stage ring by bulk (TMA) copies under
// mbarriers (288 KB from L2 per tile at 384 -> 384: 921 MB a train call,
// against 1.9 GB when every 128-column CTA cast W itself), and a tile
// ahead reads each tile's 3 x 64 ids, and the scales of their rows, into
// a two-tile ring, so the consumers' row loads wait on no dependent
// load. 20 warps (16 + 3 + 1) leave 96 registers a thread; a 21st warp
// on a scheduler would cap them at 80 and spill the train mode. The (B,
// M, 384) context never exists in device memory. Dropout and the
// residual are compiled only into the train instantiations, which read
// f32 and int8 tables.
#include "hopper.cuh"

namespace {

using namespace c2v::hopper;

constexpr int kTile = 64;                    // contexts per tile
constexpr int kChunk = 64;                   // context columns per K-chunk
constexpr int kWgCols = 96;                  // output columns a warpgroup
constexpr int kNwg = 4;                      // consumer warpgroups
constexpr int kCols = kNwg * kWgCols;        // output columns a CTA
constexpr int kConsumers = kNwg * 128;
constexpr int kEpiWarps = 3;                 // tanh and the stores
// + the epilogue warps and the producer warp: 20 warps, 5 on each of the
// SM's four schedulers, leave 96 registers a thread (a 21st warp: 80)
constexpr int kThreads = kConsumers + 32 * kEpiWarps + 32;
constexpr int kUnitsPerThread = kTile * kChunk / 4 / kConsumers;  // 2
constexpr int kABytes = kTile * kChunk * 2;  // one bf16 A tile
constexpr int kABufs = 3;
constexpr int kWBytes = kCols * kChunk * 2;  // one W chunk
constexpr int kWStages = 2;
constexpr int kAhead = 2;                    // chunks of loads in flight
constexpr int kIds = 3 * kTile;              // ids of a tile
constexpr int kAccLd = kCols + 8;            // staged f32 row (padded)

// The dynamic shared memory, from a 1024-byte-aligned base (the 128-byte
// swizzle repeats every 1024 bytes).
constexpr int kOffW = 0;
constexpr int kOffA = kOffW + kWStages * kWBytes;
constexpr int kOffAcc = kOffA + kABufs * kABytes;
constexpr int kOffIds = kOffAcc + kTile * kAccLd * 4;
constexpr int kOffScales = kOffIds + 2 * kIds * 4;
constexpr int kOffBars = kOffScales + 2 * kIds * 4;
constexpr int kSmem = kOffBars + 16 * 8 + 1024;  // + alignment slack

struct Args {
  const void* tok;
  const float* tok_scale;
  int64_t tok_rows;
  int tok_dim;
  const void* path;
  const float* path_scale;
  int64_t path_rows;
  int path_dim;
  const uint8_t* w_tiles;  // w_tiles' layout
  int d_out, nk, groups;
  const int* src;
  const int* pth;
  const int* tgt;
  int64_t n_ctx;
  __nv_bfloat16* out;
  __nv_bfloat16* out_lo;
  c2v::Dropout drop;
};

// W (f32, k_dim x d_out) rounded to bf16 as K-major chunks: chunk kc holds
// np_all rows (output columns, zero past d_out) of 64 K values (zero past
// k_dim), 128 bytes each, 128-byte-swizzled; column group g's 384 rows
// start at row 384 g.
__global__ void w_tiles(const float* w, int k_dim, int d_out, int nk,
                        int np_all, uint8_t* out) {
  const int64_t total = static_cast<int64_t>(nk) * 8 * np_all;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(e % np_all);
    const int j8 = static_cast<int>((e / np_all) % 8);
    const int kc = static_cast<int>(e / (8LL * np_all));
    const int k0 = kc * kChunk + j8 * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (k0 + i < k_dim && n < d_out)
                 ? w[static_cast<int64_t>(k0 + i) * d_out + n]
                 : 0.f;
    *reinterpret_cast<uint4*>(out + static_cast<int64_t>(kc) * np_all * 128 +
                              swz(n, j8)) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  }
}

// One chunk's units of a consumer thread, in flight: raw bits (an f32
// unit's 16 bytes; a quantized one's 4 or 2 bytes in x.x) and the row's
// scale.
struct Units {
  uint4 x[kUnitsPerThread];
  float s[kUnitsPerThread];
};

// The table, and the column within its row, of context column `col`.
__device__ __forceinline__ int segment(const Args& a, int col, int& off) {
  if (col < a.tok_dim) {
    off = col;
    return 0;
  }
  if (col < a.tok_dim + a.path_dim) {
    off = col - a.tok_dim;
    return 1;
  }
  off = col - a.tok_dim - a.path_dim;
  return 2;
}

// Issue the loads of chunk kc of work item `w` (ids and scales of its tile
// in `ids`, `scales`). Thread t owns the unit of columns 4 (t % 16) + [0,
// 4) of the chunk in rows t / 16 + 16 i. An id outside its table reads as
// a NaN row (jnp.take's fill); rows past n_ctx and columns past k_dim as
// zeros (not loaded).
template <int kFmt>
__device__ __forceinline__ void issue(Units& u, const Args& a, int w, int kc,
                                      const int* ids, const float* scales,
                                      int tid) {
  const int k_dim = 2 * a.tok_dim + a.path_dim;
  const int col = kc * kChunk + 4 * (tid & 15);
  const int64_t ctx0 = static_cast<int64_t>(w / a.groups) * kTile;
  int off = 0;
  const int seg = segment(a, col, off);
  const int dim = seg == 1 ? a.path_dim : a.tok_dim;
  const unsigned char* base =
      static_cast<const unsigned char*>(seg == 1 ? a.path : a.tok);
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    const int r = (tid >> 4) + i * (kConsumers / 16);
    u.x[i] = make_uint4(0, 0, 0, 0);
    u.s[i] = 1.f;
    if (ctx0 + r >= a.n_ctx || col >= k_dim) continue;
    const int id = ids[seg * kTile + r];
    if (id < 0) {
      if (kFmt == c2v::kF32)
        u.x[i] = make_uint4(0x7FC00000u, 0x7FC00000u, 0x7FC00000u,
                            0x7FC00000u);
      else
        u.s[i] = __uint_as_float(0x7FC00000u);
      continue;
    }
    if (kFmt == c2v::kF32) {
      u.x[i] = __ldg(reinterpret_cast<const uint4*>(
          base + (static_cast<int64_t>(id) * dim + off) * 4));
    } else if (kFmt == c2v::kInt4) {
      u.x[i].x = __ldg(reinterpret_cast<const unsigned short*>(
          base + static_cast<int64_t>(id) * (dim / 2) + off / 2));
      u.s[i] = scales[seg * kTile + r];
    } else {
      u.x[i].x = __ldg(reinterpret_cast<const unsigned int*>(
          base + static_cast<int64_t>(id) * dim + off));
      u.s[i] = scales[seg * kTile + r];
    }
  }
}

// Convert the units of chunk kc of work item `w` into the swizzled bf16
// A tile `abuf`: decode exactly, times the row's scale, then (train)
// dropout after the bf16 cast; `write_mask`: a drawn mask is written out
// (column group 0 only).
template <int kFmt, bool kTrain>
__device__ __forceinline__ void convert(const Units& u, const Args& a, int w,
                                        int kc, uint8_t* abuf, int tid,
                                        bool write_mask) {
  const int k_dim = 2 * a.tok_dim + a.path_dim;
  const int q = tid & 15;
  const int col = kc * kChunk + 4 * q;
  const int64_t ctx0 = static_cast<int64_t>(w / a.groups) * kTile;
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    const int r = (tid >> 4) + i * (kConsumers / 16);
    const int64_t ctx = ctx0 + r;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (ctx < a.n_ctx && col < k_dim) {
      if (kFmt == c2v::kF32) {
        v[0] = __uint_as_float(u.x[i].x), v[1] = __uint_as_float(u.x[i].y);
        v[2] = __uint_as_float(u.x[i].z), v[3] = __uint_as_float(u.x[i].w);
      } else {
        float d[4];
        c2v::decode4<kFmt>(u.x[i].x, d);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = d[e] * u.s[i];
      }
      if (kTrain && a.drop.mode != 0) {
        const uint64_t group = static_cast<uint64_t>(ctx * k_dim + col) >> 2;
        bool k[4];
        c2v::dropout_keep4(a.drop, group, k);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = k[e] ? c2v::bf16_round(c2v::bf16_round(v[e]) / a.drop.keep)
                      : 0.f;
        if (write_mask && a.drop.mode == 1 && a.drop.mask != nullptr)
          *reinterpret_cast<uchar4*>(a.drop.mask + 4 * group) =
              make_uchar4(k[0], k[1], k[2], k[3]);
      }
    }
    *reinterpret_cast<uint2*>(abuf + swz(r, q >> 1) + 8 * (q & 1)) =
        make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
}

// The loads of chunk c of this CTA's sequence into `u`, once its tile's
// ids have arrived; after the tile's last chunk each warp releases the
// ids' slot.
template <int kFmt>
__device__ __forceinline__ void load_chunk(Units& u, const Args& a, int c,
                                           int nk, const int* s_ids,
                                           const float* s_scales,
                                           uint64_t* ids_full,
                                           uint64_t* ids_empty, int tid) {
  const int j = c / nk, kc = c % nk;
  const int st = j & 1;
  if (kc == 0) mbar_wait(&ids_full[st], (j >> 1) & 1);
  issue<kFmt>(u, a, blockIdx.x + j * gridDim.x, kc, s_ids + st * kIds,
              s_scales + st * kIds, tid);
  if (kc == nk - 1) {
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(&ids_empty[st]);
  }
}

// A consumer warpgroup's accumulators into the f32 staging tile (rows of
// kAccLd floats: the float2 stores of a half-warp cover the 32 banks
// once). Thread (warp v of warpgroup wg, lane l) holds, for each 8-column
// group jj, columns 8 jj + 2 (l % 4) + {0, 1} of rows 16 v + l / 4 and +
// 8 of the tile.
__device__ __forceinline__ void stage_acc(const float (&acc)[kWgCols / 2],
                                          float* stage, int wg, int wtid,
                                          int lane) {
  const int r0 = (wtid / 32) * 16 + lane / 4;
  const int c0 = wg * kWgCols + 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < kWgCols / 8; ++jj)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stage + (r0 + 8 * h) * kAccLd + c0 +
                                 8 * jj) =
          make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
}

// The epilogue warps on work item w's staged tile: tanh in f32, stored as
// bf16 (and, with out_lo, the residual), eight columns of a row a thread
// at a time: one 16-byte store each.
template <bool kTrain>
__device__ __forceinline__ void epilogue_rows(const float* stage,
                                              const Args& a, int w, int et) {
  const int64_t row0 = static_cast<int64_t>(w / a.groups) * kTile;
  const int n0 = (w % a.groups) * kCols;
  for (int e = et; e < kTile * (kCols / 8); e += 32 * kEpiWarps) {
    const int r = e / (kCols / 8), c = 8 * (e % (kCols / 8));
    const int64_t row = row0 + r;
    if (row >= a.n_ctx || n0 + c >= a.d_out) continue;
    const float4 x0 = *reinterpret_cast<const float4*>(stage + r * kAccLd + c);
    const float4 x1 =
        *reinterpret_cast<const float4*>(stage + r * kAccLd + c + 4);
    const float t[8] = {tanhf(x0.x), tanhf(x0.y), tanhf(x0.z), tanhf(x0.w),
                        tanhf(x1.x), tanhf(x1.y), tanhf(x1.z), tanhf(x1.w)};
    uint32_t hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) hi[i] = pack2(t[2 * i], t[2 * i + 1]);
    const int64_t at = row * a.d_out + n0 + c;
    *reinterpret_cast<uint4*>(a.out + at) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    if (kTrain && a.out_lo != nullptr) {
      uint32_t lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lo[i] = pack2(t[2 * i] - lo_bf16(hi[i]), t[2 * i + 1] - hi_bf16(hi[i]));
      *reinterpret_cast<uint4*>(a.out_lo + at) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
}

template <int kFmt, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1)
context_encoder_kernel(Args a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem + kOffW;
  uint8_t* aring = smem + kOffA;
  float* stage = reinterpret_cast<float*>(smem + kOffAcc);
  int* s_ids = reinterpret_cast<int*>(smem + kOffIds);
  float* s_scales = reinterpret_cast<float*>(smem + kOffScales);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kOffBars);
  uint64_t* empty = full + kWStages;
  uint64_t* ids_full = empty + kWStages;
  uint64_t* ids_empty = ids_full + 2;
  uint64_t* acc_full = ids_empty + 2;
  uint64_t* acc_empty = acc_full + 1;
  const int tid = threadIdx.x;
  const int n_tiles = static_cast<int>((a.n_ctx + kTile - 1) / kTile);
  const int n_work = n_tiles * a.groups;
  const int items = static_cast<int>(blockIdx.x) < n_work
                        ? (n_work - 1 - static_cast<int>(blockIdx.x)) /
                                  static_cast<int>(gridDim.x) +
                              1
                        : 0;
  const int nk = a.nk;
  const int total = items * nk;
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kNwg);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ids_full[s], 32);
      mbar_init(&ids_empty[s], kConsumers / 32);
    }
    mbar_init(acc_full, kConsumers);
    mbar_init(acc_empty, 32 * kEpiWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = __shfl_sync(c2v::kFullMask, tid / 32, 0);
  const int lane = tid & 31;
  if (warp == kConsumers / 32 + kEpiWarps) {
    // producer: lane 0 issues the W copies. Item j + 1's ids, and the
    // scales of their rows, are read a tile ahead of the consumers' loads
    // in three steps beside item j's first W chunks (id loads issued;
    // ids stored and scale loads issued; scales stored), so that the
    // dependent loads land while lane 0 waits on the ring.
    constexpr int kPerLane = kIds / 32;
    const int np_all = a.groups * kCols;
    int id[kPerLane];
    float sc[kPerLane];
    auto ids_step = [&](int j, int step) {
      const int st = j & 1;
      const int64_t ctx0 =
          static_cast<int64_t>((blockIdx.x + j * gridDim.x) / a.groups) *
          kTile;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int t = lane + 32 * i, seg = t / kTile;
        const int64_t ctx = ctx0 + t % kTile;
        if (step == 0) {
          const int* ids = seg == 0 ? a.src : seg == 1 ? a.pth : a.tgt;
          id[i] = ctx < a.n_ctx ? __ldg(ids + ctx) : -1;
        } else if (step == 1) {
          const int64_t rows = seg == 1 ? a.path_rows : a.tok_rows;
          if (id[i] < 0 || id[i] >= rows) id[i] = -1;
          s_ids[st * kIds + t] = id[i];
          if (kFmt != c2v::kF32)
            sc[i] = id[i] >= 0 ? __ldg((seg == 1 ? a.path_scale
                                                 : a.tok_scale) + id[i])
                               : 1.f;
        } else if (kFmt != c2v::kF32) {
          s_scales[st * kIds + t] = sc[i];
        }
      }
      if (step == 2) mbar_arrive(&ids_full[st]);
    };
    if (items > 0)
      for (int step = 0; step < 3; ++step) ids_step(0, step);
    for (int j = 0; j < items; ++j) {
      const int w = blockIdx.x + j * gridDim.x;
      const bool next = j + 1 < items;
      if (next && j + 1 >= 2)
        mbar_wait(&ids_empty[(j + 1) & 1], (((j + 1) >> 1) - 1) & 1);
      for (int kc = 0; kc < max(nk, 3); ++kc) {
        if (lane == 0 && kc < nk) {
          const int c = j * nk + kc;
          const int s = c % kWStages;
          if (c >= kWStages) mbar_wait(&empty[s], (c / kWStages - 1) & 1);
          mbar_arrive_tx(&full[s], kWBytes);
          bulk_load(wring + s * kWBytes,
                    a.w_tiles + (static_cast<int64_t>(kc) * np_all +
                                 (w % a.groups) * kCols) *
                                    128,
                    kWBytes, &full[s]);
        }
        __syncwarp();
        if (next && kc < 3) ids_step(j + 1, kc);
      }
    }
    return;
  }
  if (warp >= kConsumers / 32) {  // epilogue: each item's staged tile
    for (int j = 0; j < items; ++j) {
      mbar_wait(acc_full, j & 1);
      epilogue_rows<kTrain>(stage, a, blockIdx.x + j * gridDim.x,
                            tid - kConsumers);
      mbar_arrive(acc_empty);
    }
    return;
  }

  // consumers
  const int wg = warp / 4, wtid = tid & 127;
  float acc[kWgCols / 2];
#pragma unroll
  for (int i = 0; i < kWgCols / 2; ++i) acc[i] = 0.f;
  Units sets[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    if (k < total)
      load_chunk<kFmt>(sets[k], a, k, nk, s_ids, s_scales, ids_full,
                       ids_empty, tid);

  int prev = -1;
  for (int c0 = 0; c0 < total; c0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int c = c0 + k;
      if (c >= total) break;
      const int j = c / nk, kc = c % nk;
      const int w = blockIdx.x + j * gridDim.x;
      uint8_t* abuf = aring + (c % kABufs) * kABytes;
      convert<kFmt, kTrain>(sets[k], a, w, kc, abuf, tid, w % a.groups == 0);
      fence_async_smem();
      named_sync(1, kConsumers);
      if (c + kAhead < total)
        load_chunk<kFmt>(sets[k], a, c + kAhead, nk, s_ids, s_scales,
                         ids_full, ids_empty, tid);
      const int s = c % kWStages;
      mbar_wait(&full[s], (c / kWStages) & 1);
      wgmma_fence();
      const uint32_t a0 = smem_u32(abuf);
      const uint32_t b0 = smem_u32(wring + s * kWBytes + wg * kWgCols * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_n96<0, 0>(acc, desc(a0 + kk * 32, 16, 1024),
                        desc(b0 + kk * 32, 16, 1024), kc > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1's products are done
      if (wtid == 0 && prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (kc == nk - 1) {
        wgmma_wait<0>();
        if (wtid == 0) mbar_arrive(&empty[prev]);
        prev = -1;
        // the epilogue warps have finished the previous item's tile
        if (j > 0) mbar_wait(acc_empty, (j - 1) & 1);
        stage_acc(acc, stage, wg, wtid, lane);
        mbar_arrive(acc_full);
      }
    }
  }
}

}  // namespace

// Dynamic shared memory of one K1 CTA (any width).
C2V_EXPORT int64_t c2v_context_encoder_smem() { return kSmem; }

// Bytes of the bf16 W tiles (`scratch` of c2v_context_encoder) for a
// context width k_dim and code width d_out.
C2V_EXPORT int64_t c2v_context_encoder_scratch(int k_dim, int d_out) {
  const int64_t nk = (k_dim + kChunk - 1) / kChunk;
  const int64_t groups = (d_out + kCols - 1) / kCols;
  return nk * groups * kCols * 128;
}

// tok/path: tables of format `fmt` (c2v::TableFormat): f32 (scales null),
// or int8, e4m3, e5m2 (rows x dim bytes) or int4 (rows x dim / 2 bytes)
// with f32 (rows,) scales; the train mode takes f32 and int8 only.
// w: f32 (k_dim, d_out) row-major. src/pth/tgt: int32 (n_ctx,). out: bf16
// (n_ctx, d_out); out_lo, when not null, bf16 (n_ctx, d_out) receives
// the residual tanh - out. Dropout (common.cuh c2v::Dropout): drop_mode
// 0/1/2, keep in (0, 1], seed/step for mode 1, mask (n_ctx, k_dim) bytes for
// mode 2 (read) or mode 1 (written when not null). scratch:
// c2v_context_encoder_scratch bytes, 1024-byte aligned. Two launches:
// w_tiles, then the encoder. Returns a cudaError_t (0 on success).
C2V_EXPORT int c2v_context_encoder(const void* tok, const float* tok_scale,
                                   int64_t tok_rows, int tok_dim,
                                   const void* path, const float* path_scale,
                                   int64_t path_rows, int path_dim,
                                   int fmt, const float* w, int d_out,
                                   const int* src, const int* pth,
                                   const int* tgt, int64_t n_ctx, void* out,
                                   void* out_lo, int drop_mode, float keep,
                                   uint64_t seed, uint64_t step, void* mask,
                                   void* scratch, void* stream) {
  const int k_dim = 2 * tok_dim + path_dim;
  if (k_dim % 16 != 0 || tok_dim % 4 != 0 || path_dim % 4 != 0 ||
      tok_dim <= 0 || path_dim <= 0 || d_out % 16 != 0 || d_out <= 0 ||
      n_ctx <= 0 || (n_ctx + kTile - 1) / kTile > (1LL << 30))
    return cudaErrorInvalidValue;
  if (drop_mode < 0 || drop_mode > 2 || !(keep > 0.f && keep <= 1.f) ||
      (drop_mode == 2 && mask == nullptr) ||
      (reinterpret_cast<uintptr_t>(scratch) & 1023) != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.tok = tok, a.tok_scale = tok_scale, a.tok_rows = tok_rows;
  a.tok_dim = tok_dim;
  a.path = path, a.path_scale = path_scale, a.path_rows = path_rows;
  a.path_dim = path_dim;
  a.w_tiles = static_cast<const uint8_t*>(scratch);
  a.d_out = d_out;
  a.nk = (k_dim + kChunk - 1) / kChunk;
  a.groups = (d_out + kCols - 1) / kCols;
  a.src = src, a.pth = pth, a.tgt = tgt, a.n_ctx = n_ctx;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.out_lo = static_cast<__nv_bfloat16*>(out_lo);
  a.drop.mode = drop_mode;
  a.drop.keep = keep;
  a.drop.threshold = static_cast<uint32_t>(
      fminf(roundf(keep * 16777216.f), 16777216.f));
  a.drop.seed = seed;
  a.drop.step = step;
  a.drop.mask = static_cast<uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np_all = a.groups * kCols;
  const int64_t tile_vals = static_cast<int64_t>(a.nk) * 8 * np_all;
  w_tiles<<<static_cast<unsigned>(
                 (tile_vals + 255) / 256 < 1024 ? (tile_vals + 255) / 256
                                                : 1024),
            256, 0, s>>>(w, k_dim, d_out, a.nk, np_all,
                         static_cast<uint8_t*>(scratch));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t n_work = (n_ctx + kTile - 1) / kTile * a.groups;
  const unsigned grid =
      static_cast<unsigned>(n_work < sms ? n_work : static_cast<int64_t>(sms));
  const bool train = drop_mode != 0 || out_lo != nullptr;
  auto run = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, kSmem, s>>>(a);
    return cudaSuccess;
  };
  switch (fmt) {
    case c2v::kF32:
      err = train ? run(context_encoder_kernel<c2v::kF32, true>)
                  : run(context_encoder_kernel<c2v::kF32, false>);
      break;
    case c2v::kInt8:
      err = train ? run(context_encoder_kernel<c2v::kInt8, true>)
                  : run(context_encoder_kernel<c2v::kInt8, false>);
      break;
    // serving only: training keeps f32 tables
    case c2v::kE4M3:
      err = train ? cudaErrorInvalidValue
                  : run(context_encoder_kernel<c2v::kE4M3, false>);
      break;
    case c2v::kE5M2:
      err = train ? cudaErrorInvalidValue
                  : run(context_encoder_kernel<c2v::kE5M2, false>);
      break;
    case c2v::kInt4:
      err = train ? cudaErrorInvalidValue
                  : run(context_encoder_kernel<c2v::kInt4, false>);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
