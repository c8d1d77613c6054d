// K5 encoder_backward: the backward of K1 (gather, concat, bf16 cast,
// dropout, tanh(ctx @ W)) for dense table gradients, or (row mode) for
// the gradients of the gathered rows.
//
// Replaces the autodiff of code2vec_tpu/models/code2vec.py
// transform_contexts / transform_gathered (:128-177) inside
// jax.grad of the dense train step (code2vec_tpu/training/step.py:177-199)
// and, in row mode, of the sparse one (:198-269, gradients with respect
// to the gathered rows of `apply_from_rows`). Given dT (the cotangent of
// K1's bf16 output) and K1's output T it computes, for every context row
// r of the (B*M) rows:
//   dpre[r]  = dT (1 - T) + dT (1 - T) T              f32, tanh's rule
//   dctx[r]  = bf16(dpre[r] @ bf16(W)^T)              the context cotangent
//   dctx[r]  = keep ? bf16(dctx / keep) : 0           dropout's backward
//   d_token[src[r]] += dctx[r, :td], d_path[pth[r]] += dctx[r, td:td+pd],
//   d_token[tgt[r]] += dctx[r, td+pd:]                f32 scatter-add
//   dW       = bf16(sum_r ctx[r]^T dpre[r])            f32 after the cast
// where ctx is the dropped-out bf16 context of the forward, re-gathered
// from the tables (never saved) with the dropout bits redrawn by the same
// Philox stream as K1 (common.cuh), or read from an injected mask.
//
// Rounding points, as `jax.make_jaxpr(jax.grad(loss))` of the bf16 model
// shows them (each a convert_element_type to bf16 and back to f32):
//   - dctx = dot(dpre f32, W bf16) -> bf16            (the cotangent of the
//     bf16 context), then divided by bf16(keep) in bf16 under dropout;
//   - dW = dot(dpre f32, ctx bf16) -> bf16 -> f32     (the cotangent of
//     W.astype(bf16));
//   - the table rows receive f32(dctx) through the f32 concat and gather.
// dpre is f32 in both products: the kernel splits it into two bf16 parts
// (hi = bf16(dpre), lo = bf16(dpre - hi)) and feeds both through one
// accumulation chain on the tensor cores, which carries 16 of f32's 24
// mantissa bits (a relative error near 2^-17, far under the bf16
// rounding that follows). The reference differentiates tanh at its f32
// value, before the cast to bf16. K1 saves that value as T + T_lo (T_lo
// = bf16(tanh - T), its train mode's residual output), and this kernel
// adds the two back in f32 (the bf16 T alone would move 1 - T^2 by up to
// 2^-8 relative, more near |T| = 1).
//
// Row mode: the epilogue writes each context row's dctx, split into its
// source, path and target parts, to bf16 row arrays instead of the
// scatter: g_tok (2, n_ctx, td) (sources, then targets: the reference's
// concat of the token ids) and g_path (n_ctx, pd). The reference's row
// gradient is f32(bf16 dctx) (the pre-dropout cast of
// `transform_gathered`), so bf16 storage changes no value and halves the
// bytes; nothing table-shaped is allocated or zeroed. dW is the same.
//
// What bounds it on an H100: bytes. At the train shape (204,800 context
// rows, 384 -> 384) dT, T and T_lo are 472 MB, the gathered f32 rows
// ~280 MB (their unique rows at uniform ids), the outputs 157 MB of bf16
// rows or, in dense mode, the 1.13 GB of zeroed table gradients and their
// atomics; the two products are 121 GFLOP (242 with dpre's hi and lo
// parts: 0.24 ms of bf16 tensor-core time, near the 0.27 ms byte bound).
// So the design writes nothing to device memory only to read it back
// but dpre's hi and lo parts (315 MB, once each way), re-gathers the
// context instead of saving it, and keeps W in L2. On an H100 the random
// 512-byte row gathers run well under the memory rate (PyTorch's
// index_select of the same rows too; PERF.md), so each context row is
// gathered and converted once.
//
// Design (four launches on the caller's stream):
//   0. W (f32) to bf16, laid out as pass A's shared-memory tiles; after
//      them a NaN row and a zero row for pass B.
//   A. dctx, one persistent CTA per SM over 64-row tiles of the context:
//      consumer warpgroup g owns context columns [128 g, 128 g + 128).
//      Per 64-wide chunk of dpre's columns the consumers read dT, T and
//      T_lo (16-byte loads into registers, issued one chunk ahead), form
//      dpre, and write its hi and lo parts to shared memory in the
//      128-byte-swizzled K-major layout that `wgmma` reads; one thread
//      stores both tiles to the dpre scratch with bulk (TMA) copies, as
//      32-row halves in the layout pass B reads as it is: dpre crosses
//      device memory once each way. A producer warp streams W's matching
//      chunk (k_dim x 64 bf16, from L2) into a 3-stage ring with bulk
//      copies under mbarriers. Each warpgroup runs m64n128k16 `wgmma`
//      over the chunk, hi and lo in one accumulation chain, one chunk in
//      flight while the next is formed. The epilogue goes through shared
//      memory (bf16 dctx, the dpre buffers reused), so that each warp
//      rounds, drops out and stores 128 consecutive columns of a row:
//      8-byte bf16 row stores, or 16-byte f32 vector atomics (their order
//      varies from run to run: sums of the same bf16-valued terms in
//      another order).
//   B. dW as a split-K product: CTA (row slice, 128-column block of the
//      context, all of d at the flagship width) accumulates its tile over
//      the slice's rows in 32-row chunks, two warpgroups of m64 x n384
//      each (two n192 `wgmma`s). A 3-stage ring under mbarriers holds
//      each chunk's f32 context rows, gathered by one bulk (TMA) copy
//      per row (an id outside its table copies the NaN row, jnp.take's
//      fill) and its dpre hi/lo tiles (two bulk copies); warp 0 refills
//      a stage as soon as both warpgroups' products have released it.
//      The warpgroups round and drop out the rows into a swizzled bf16
//      tile and run MN-major `wgmma` on it and the dpre tiles, one chunk
//      in flight while the next is converted. The three CTAs of a slice
//      are launched side by side, so each dpre tile comes from memory
//      once and from L2 for the other two. dpre is read from the scratch,
//      not formed again from dT, T and T_lo (472 MB against 315 MB, and
//      three raw tiles a stage): with its dpre loads taken out, pass B
//      ran no faster on the H100 (PERF.md).
//   C. dW = f32(bf16(sum of the slices)), the slices added in a fixed
//      order: dW is the same bit for bit from run to run.
#include "hopper.cuh"

namespace {

using namespace c2v::hopper;

constexpr int kTileRows = 64;   // context rows per tile of pass A
constexpr int kBlock = 8192;    // one [64][64] bf16 tile, 128-byte rows
constexpr int kWStages = 3;     // pass A's ring of W chunks
constexpr int kABufs = 3;       // pass A's dpre hi/lo tile buffers
constexpr int kChunkRows = 32;  // context rows per chunk of pass B
constexpr int kCBufs = 3;       // pass B's bf16 context tile buffers

struct Tables {
  const float* tok;
  const float* path;
  int64_t tok_rows, path_rows;
  int tok_dim, path_dim;
  const int* src;
  const int* pth;
  const int* tgt;
};

// Pass 0: W (f32, k_dim x d) to bf16 in pass A's tiles: d / 64 chunks of
// k_dim rows x 64 values, row n of chunk kc holding W[n, 64 kc + 64).
// After them, pass B's fill rows: 128 f32 NaN (what an id outside its
// table gathers, as jnp.take's fill), then 128 zeros (the padding rows
// past the last context row).
__global__ void w_tiles(const float* w, int k_dim, int d, uint8_t* out) {
  if (blockIdx.x == 0 && threadIdx.x < 128) {
    uint32_t* fill = reinterpret_cast<uint32_t*>(out + k_dim * d * 2);
    fill[threadIdx.x] = 0x7FC00000u;
    fill[128 + threadIdx.x] = 0;
  }
  const int per_row = d / 8;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < k_dim * per_row;
       i += gridDim.x * blockDim.x) {
    const int n = i / per_row, k0 = (i % per_row) * 8;
    const float* x = w + static_cast<int64_t>(n) * d + k0;
    const uint4 v = make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]),
                               pack2(x[4], x[5]), pack2(x[6], x[7]));
    *reinterpret_cast<uint4*>(out + static_cast<int64_t>(k0 / 64) * k_dim *
                                        128 +
                              swz(n, (k0 % 64) / 8)) = v;
  }
}

// dT, T and T_lo of a chunk (64 rows x 64 columns from column 64 kc of
// tile `tile`), G groups of eight values a thread: group gi = tid + i *
// threads is row gi / 8, columns 8 (gi % 8) + [0, 8). Rows past n_ctx
// read as zeros (dpre 0 there).
template <int G>
__device__ __forceinline__ void load_chunk(uint4 (&x)[G][3],
                                           const __nv_bfloat16* dt,
                                           const __nv_bfloat16* t,
                                           const __nv_bfloat16* t_lo, int d,
                                           int64_t n_ctx, int tile, int kc,
                                           int tid, int threads) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int gi = tid + i * threads;
    const int64_t row = static_cast<int64_t>(tile) * kTileRows + gi / 8;
    if (gi < 512 && row < n_ctx) {
      const int64_t off = row * d + kc * 64 + (gi % 8) * 8;
      x[i][0] = __ldg(reinterpret_cast<const uint4*>(dt + off));
      x[i][1] = __ldg(reinterpret_cast<const uint4*>(t + off));
      x[i][2] = __ldg(reinterpret_cast<const uint4*>(t_lo + off));
    } else {
      x[i][0] = x[i][1] = x[i][2] = make_uint4(0, 0, 0, 0);
    }
  }
}

// tanh's rule in f32 (no FMA contraction: the plain version's order) on
// two bf16 pairs' worth of dT, T, T_lo; dpre split into bf16 hi and lo.
__device__ __forceinline__ void tanh_rule2(uint32_t g, uint32_t t,
                                           uint32_t tl, uint32_t& hi,
                                           uint32_t& lo) {
  float p[2];
  const float gv[2] = {lo_bf16(g), hi_bf16(g)};
  const float tv[2] = {__fadd_rn(lo_bf16(t), lo_bf16(tl)),
                       __fadd_rn(hi_bf16(t), hi_bf16(tl))};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float gp = __fmul_rn(gv[i], __fsub_rn(1.f, tv[i]));
    p[i] = __fadd_rn(gp, __fmul_rn(gp, tv[i]));
  }
  hi = pack2(p[0], p[1]);
  lo = pack2(__fsub_rn(p[0], lo_bf16(hi)), __fsub_rn(p[1], hi_bf16(hi)));
}

// Pass A's dpre tile buffers, which the epilogue's [64][k_dim] bf16
// tile (rows padded by 16 bytes) overlays.
__host__ __device__ constexpr int abuf_bytes(int nwg) {
  return kABufs * 2 * kBlock > kTileRows * (nwg * 256 + 16)
             ? kABufs * 2 * kBlock
             : kTileRows * (nwg * 256 + 16);
}

// Pass A: dctx and the dpre tiles (module note). NWG consumer
// warpgroups (context columns [128 g, 128 g + 128) each), then one
// producer warp.
template <int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
dctx_pass(const __nv_bfloat16* dt, const __nv_bfloat16* t,
          const __nv_bfloat16* t_lo, int d, const uint8_t* w_tile,
          Tables tb, int64_t n_ctx, c2v::Dropout drop, uint8_t* hi_s,
          uint8_t* lo_s, float* d_tok, float* d_path, __nv_bfloat16* g_tok,
          __nv_bfloat16* g_path) {
  constexpr int kThreads = NWG * 128;
  constexpr int kDim = NWG * 128;            // context width
  constexpr int kWBytes = kDim * 128;        // one W chunk
  constexpr int G = (512 + kThreads - 1) / kThreads;
  constexpr int kEpiLd = kDim * 2 + 16;  // epilogue tile row, padded
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = smem;
  uint8_t* abuf = wring + kWStages * kWBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(abuf + abuf_bytes(NWG));
  uint64_t* empty = full + kWStages;
  const int n_tiles = static_cast<int>((n_ctx + kTileRows - 1) / kTileRows);
  const int nk = d / 64;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // roles by warpgroup, a value the compiler sees is warp-uniform
  const int wg = __shfl_sync(c2v::kFullMask, tid / 128, 0);
  if (wg == NWG) {  // producer: W's chunks, tile after tile
    if (tid == kThreads) {
      int c = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int kc = 0; kc < nk; ++kc, ++c) {
          const int s = c % kWStages;
          if (c >= kWStages) mbar_wait(&empty[s], (c / kWStages - 1) & 1);
          mbar_arrive_tx(&full[s], kWBytes);
          bulk_load(wring + s * kWBytes,
                    w_tile + static_cast<int64_t>(kc) * kWBytes, kWBytes,
                    &full[s]);
        }
    }
    return;
  }

  const int wtid = tid % 128, lane = tid % 32;
  const int k_dim = kDim;
  uint4 x[G][3];
  float acc[64];
  int c = 0, prev = -1;
  load_chunk<G>(x, dt, t, t_lo, d, n_ctx, blockIdx.x, 0, tid, kThreads);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int kc = 0; kc < nk; ++kc, ++c) {
      uint8_t* ahi = abuf + (c % kABufs) * 2 * kBlock;
      uint8_t* alo = ahi + kBlock;
      // dpre's hi and lo parts of the chunk, swizzled K-major
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int gi = tid + i * kThreads;
        if (gi < 512) {
          uint4 h, l;
          tanh_rule2(x[i][0].x, x[i][1].x, x[i][2].x, h.x, l.x);
          tanh_rule2(x[i][0].y, x[i][1].y, x[i][2].y, h.y, l.y);
          tanh_rule2(x[i][0].z, x[i][1].z, x[i][2].z, h.z, l.z);
          tanh_rule2(x[i][0].w, x[i][1].w, x[i][2].w, h.w, l.w);
          *reinterpret_cast<uint4*>(ahi + swz(gi / 8, gi % 8)) = h;
          *reinterpret_cast<uint4*>(alo + swz(gi / 8, gi % 8)) = l;
        }
      }
      // the next chunk's inputs, in flight through the products below
      const bool last = kc == nk - 1;
      const int next_tile = last ? tile + gridDim.x : tile;
      if (next_tile < n_tiles)
        load_chunk<G>(x, dt, t, t_lo, d, n_ctx, next_tile, last ? 0 : kc + 1,
                      tid, kThreads);
      fence_async_smem();
      if (tid == 0) bulk_wait_read<1>();  // the store of chunk c - 2 read
      named_sync(1, kThreads);
      if (tid == 0) {  // rows 0-31, then 32-63: pass B's 32-row chunks
        for (int h = 0; h < 2; ++h) {
          const int64_t off =
              ((static_cast<int64_t>(tile) * 2 + h) * nk + kc) * (kBlock / 2);
          bulk_store(hi_s + off, ahi + h * (kBlock / 2), kBlock / 2);
          bulk_store(lo_s + off, alo + h * (kBlock / 2), kBlock / 2);
        }
        bulk_commit();
      }
      const int s = c % kWStages;
      mbar_wait(&full[s], (c / kWStages) & 1);
      __syncwarp();
      wgmma_fence();
      const uint32_t a_hi = smem_u32(ahi), a_lo = smem_u32(alo);
      const uint32_t b = smem_u32(wring + s * kWBytes + wg * 128 * 128);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc(b + kk * 32, 16, 1024);
        wgmma_n128<0, 0>(acc, desc(a_hi + kk * 32, 16, 1024), db,
                         kc > 0 || kk > 0);
        wgmma_n128<0, 0>(acc, desc(a_lo + kk * 32, 16, 1024), db, 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // chunk c - 1's products are done
      if (wtid == 0 && prev >= 0) mbar_arrive(&empty[prev]);
      prev = s;
    }
    wgmma_wait<0>();
    if (wtid == 0) mbar_arrive(&empty[prev]);
    prev = -1;

    // Epilogue, through shared memory (the dpre buffers, free now):
    // first bf16(dctx) as a [64][k_dim] tile, then whole rows from it,
    // so that the stores and atomics of a warp cover 128 consecutive
    // columns of one row. The accumulator layout: thread (warp w, lane
    // l) holds, for each 8-column group j, columns 8 j + 2 (l % 4) +
    // {0, 1} of rows 16 w + l / 4 and + 8.
    if (tid == 0) bulk_wait_read<0>();  // the dpre stores left abuf
    named_sync(1, kThreads);           // and every warpgroup's products
    {
      const int r = (wtid / 32) * 16 + lane / 4;
      uint8_t* e = abuf + r * kEpiLd + (wg * 128 + 2 * (lane % 4)) * 2;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(e + 16 * j) =
            pack2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(e + 8 * kEpiLd + 16 * j) =
            pack2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_sync(1, kThreads);
    const int td = tb.tok_dim, pd = tb.path_dim;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int g = tid + i * kThreads;
      const int row = g / (kDim / 4), col = (g % (kDim / 4)) * 4;
      const int64_t ctx = static_cast<int64_t>(tile) * kTileRows + row;
      if (ctx >= n_ctx) continue;
      const uint2 h = *reinterpret_cast<const uint2*>(abuf + row * kEpiLd +
                                                      col * 2);
      float v[4] = {lo_bf16(h.x), hi_bf16(h.x), lo_bf16(h.y), hi_bf16(h.y)};
      if (drop.mode != 0) {
        bool k[4];
        c2v::dropout_keep4(
            drop, static_cast<uint64_t>(ctx * k_dim + col) >> 2, k);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = k[u] ? c2v::bf16_round(v[u] / drop.keep) : 0.f;
      }
      if (g_tok != nullptr) {  // row mode: bf16 rows, exact
        __nv_bfloat16* dst;
        if (col < td)
          dst = g_tok + ctx * td + col;
        else if (col < td + pd)
          dst = g_path + ctx * pd + (col - td);
        else
          dst = g_tok + (n_ctx + ctx) * td + (col - td - pd);
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
        continue;
      }
      float* table;
      int64_t id, rows;
      int tcol, dim;
      if (col < td) {
        table = d_tok, id = tb.src[ctx], rows = tb.tok_rows, tcol = col,
        dim = td;
      } else if (col < td + pd) {
        table = d_path, id = tb.pth[ctx], rows = tb.path_rows,
        tcol = col - td, dim = pd;
      } else {
        table = d_tok, id = tb.tgt[ctx], rows = tb.tok_rows,
        tcol = col - td - pd, dim = td;
      }
      if (id < 0 || id >= rows) continue;  // the scatter drops such ids
      // one 16-byte vector atomic (sm_90) for the four columns
      atomicAdd(reinterpret_cast<float4*>(table + id * dim + tcol),
                make_float4(v[0], v[1], v[2], v[3]));
    }
    named_sync(1, kThreads);  // the tile is read before abuf is reused
  }
  if (tid == 0) bulk_wait_all();
}

// Pass B's ring depth for a d tile of `blocks` 64-column blocks: as deep
// as the shared memory takes beside the context tile buffers.
__host__ __device__ constexpr int dw_stages(int blocks) {
  return blocks <= 3 ? 4 : 3;
}

// Pass B: dW's partial sums (module note). CTA (slice, block, dtile):
// context columns [128 block, + 128), d columns [kN dtile, + kN) with kN
// = 64 NB NT (all of d at the flagship width, so each context row is
// gathered and converted once), rows of chunks [c0, c1) of 32. Two
// warpgroups (context columns + [64 g, 64 g + 64), NT m64 x n(64 NB)
// accumulators each); warp 0 also refills the ring: lane r brings row r
// of a chunk, S - 1 chunks ahead of the products.
template <int NT, int NB>
__global__ void __launch_bounds__(256, 1)
dw_pass(const uint8_t* hi_s, const uint8_t* lo_s, const uint8_t* fill, int d,
        int k_dim, Tables tb, int64_t n_ctx, int64_t n_chunks, int slices,
        c2v::Dropout drop, float* partial) {
  constexpr int kRaw = kChunkRows * 128 * 4;       // f32 context rows
  constexpr int kHalf = kBlock / 2;                // [32][64] bf16 tile
  constexpr int kN = 64 * NB * NT;
  constexpr int kDpre = kN / 64 * kHalf;           // a chunk's hi (or lo)
  constexpr int kStage = kRaw + 2 * kDpre;
  constexpr int kS = dw_stages(NT * NB);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  uint8_t* cbuf = ring + kS * kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(cbuf + kCBufs * kBlock);
  uint64_t* empty = full + kS;
  const int n_blk = k_dim / 128, n_dt = d / kN;
  const int dtile = blockIdx.x % n_dt;
  const int blk = (blockIdx.x / n_dt) % n_blk;
  const int slice = blockIdx.x / (n_dt * n_blk);
  const int64_t c0 = n_chunks * slice / slices;
  const int64_t c1 = n_chunks * (slice + 1) / slices;
  const int nkd = d / 64;
  const int tid = threadIdx.x, lane = tid % 32, wtid = tid % 128;
  const int wg = __shfl_sync(c2v::kFullMask, tid / 128, 0);
  const bool producer = __shfl_sync(c2v::kFullMask, tid / 32, 0) == 0;
  if (tid == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);  // warp 0's, with the stage's bytes
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp 0's part: chunk q into its stage. The block's table parts; an
  // id outside its table copies the NaN row, a padding row zeros.
  const int td = tb.tok_dim, pd = tb.path_dim;
  const int start[4] = {0, td, td + pd, k_dim};
  const int b0 = blk * 128;
  int ids[3] = {0, 0, 0};  // row `lane` of the next chunk to bring
  auto load_ids = [&](int64_t q) {
    const int64_t row = q * kChunkRows + lane;
    if (q < c1 && row < n_ctx)
      ids[0] = tb.src[row], ids[1] = tb.pth[row], ids[2] = tb.tgt[row];
  };
  auto bring = [&](int64_t q) {
    const int s = static_cast<int>(q - c0) % kS;
    uint8_t* st = ring + s * kStage;
    const int row_id[3] = {ids[0], ids[1], ids[2]};
    load_ids(q + 1);
    if (lane == 0) {
      mbar_arrive_tx(&full[s], kRaw + 2 * kDpre);
      const int64_t off = (q * nkd + dtile * (kN / 64)) * kHalf;
      bulk_load(st + kRaw, hi_s + off, kDpre, &full[s]);
      bulk_load(st + kRaw + kDpre, lo_s + off, kDpre, &full[s]);
    }
    __syncwarp();  // the stage's bytes are expected before any lands
    const int64_t row = q * kChunkRows + lane;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int lo = max(start[p], b0), hi = min(start[p + 1], b0 + 128);
      if (lo >= hi) continue;
      const int64_t rows = p == 1 ? tb.path_rows : tb.tok_rows;
      const void* src = fill + 512;
      if (row < n_ctx)
        src = row_id[p] >= 0 && row_id[p] < rows
                  ? (p == 1 ? tb.path : tb.tok) +
                        static_cast<int64_t>(row_id[p]) * (p == 1 ? pd : td) +
                        (lo - start[p])
                  : static_cast<const void*>(fill);
      bulk_load(st + lane * 512 + (lo - b0) * 4, src, (hi - lo) * 4,
                &full[s]);
    }
  };
  if (producer) {
    load_ids(c0);
    for (int64_t q = c0; q < c1 && q < c0 + kS; ++q) bring(q);
  }

  float acc[NT][32 * NB];  // set by the first product (slices >= 1 chunk)
  for (int64_t q = c0; q < c1; ++q) {
    const int i = static_cast<int>(q - c0), s = i % kS;
    uint8_t* st = ring + s * kStage;
    uint8_t* cb = cbuf + (i % kCBufs) * kBlock;
    mbar_wait(&full[s], (i / kS) & 1);
    __syncwarp();
    // the chunk's context rows in bf16, dropped out, swizzled MN-major
    // (two [32][64] tiles): 512 groups of eight columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gi = tid + h * 256, r = gi / 16, j = gi % 16;
      const float* x = reinterpret_cast<const float*>(st) + r * 128 + j * 8;
      const float4 a = *reinterpret_cast<const float4*>(x);
      const float4 b = *reinterpret_cast<const float4*>(x + 4);
      float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const int64_t row = q * kChunkRows + r;
      if (drop.mode != 0 && row < n_ctx) {
        const uint64_t e = static_cast<uint64_t>(row * k_dim + blk * 128 +
                                                 j * 8) >> 2;
        bool k[8];
        c2v::dropout_keep4(drop, e, k);
        c2v::dropout_keep4(drop, e + 1, k + 4);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[u] = k[u] ? c2v::bf16_round(c2v::bf16_round(v[u]) / drop.keep)
                      : 0.f;
      }
      *reinterpret_cast<uint4*>(cb + (j / 8) * kHalf + swz(r, j % 8)) =
          make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                     pack2(v[4], v[5]), pack2(v[6], v[7]));
    }
    fence_async_smem();
    __syncthreads();
    wgmma_fence();
    const uint32_t a = smem_u32(cb + wg * kHalf);
    const uint32_t bh = smem_u32(st + kRaw), bl = bh + kDpre;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t da = desc(a + kk * 2048, kHalf, 1024);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t o = nt * NB * kHalf + kk * 2048;
        const uint64_t dh = desc(bh + o, kHalf, 1024);
        const uint64_t dl = desc(bl + o, kHalf, 1024);
        if constexpr (NB == 3) {
          wgmma_n192<1, 1>(acc[nt], da, dh, i > 0 || kk > 0);
          wgmma_n192<1, 1>(acc[nt], da, dl, 1);
        } else {
          wgmma_n128<1, 1>(acc[nt], da, dh, i > 0 || kk > 0);
          wgmma_n128<1, 1>(acc[nt], da, dl, 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // chunk i - 1's products are done
    if (i > 0) {
      const int sp = (i - 1) % kS;
      if (wtid == 0) mbar_arrive(&empty[sp]);
      // warp 0 refills chunk i - 1's stage, once both warpgroups let it go
      if (producer && q - 1 + kS < c1) {
        mbar_wait(&empty[sp], ((i - 1) / kS) & 1);
        bring(q - 1 + kS);
      }
    }
  }
  wgmma_wait<0>();
  // the accumulator layout of pass A's epilogue: row m of the tile is
  // context column blk * 128 + 64 wg + m, column n is d column kN dtile + n
  const int m = (wtid / 32) * 16 + lane / 4;
  float* out = partial +
               (static_cast<int64_t>(slice) * k_dim + blk * 128 + wg * 64 + m) *
                   d +
               dtile * kN + 2 * (lane % 4);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 8 * NB; ++j) {
      float* o = out + nt * 64 * NB + 8 * j;
      *reinterpret_cast<float2*>(o) =
          make_float2(acc[nt][4 * j], acc[nt][4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * static_cast<int64_t>(d)) =
          make_float2(acc[nt][4 * j + 2], acc[nt][4 * j + 3]);
    }
}

// Pass C: dW = f32(bf16(sum of the slices)), the slices added in order.
__global__ void dw_reduce(const float* partial, int slices, int64_t n,
                          float* dw) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += partial[k * n + i];
    dw[i] = c2v::bf16_round(s);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Pass B's d tile, 64 NB NT columns: all 384 of the flagship width
// (NT 2 x NB 3), else 256 or 128.
int dw_tile(int d) { return d % 384 == 0 ? 384 : d % 256 == 0 ? 256 : 128; }

template <int NWG>
cudaError_t launch_dctx(const void* dt, const void* t, const void* t_lo,
                        int d, const uint8_t* w_tile, const Tables& tb,
                        int64_t n_ctx, const c2v::Dropout& drop,
                        uint8_t* hi_s, uint8_t* lo_s, float* d_tok,
                        float* d_path, void* g_tok, void* g_path,
                        cudaStream_t s) {
  const int smem = kWStages * NWG * 128 * 128 + abuf_bytes(NWG) +
                   2 * kWStages * 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dctx_pass<NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (n_ctx + kTileRows - 1) / kTileRows;
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  dctx_pass<NWG><<<grid, NWG * 128 + 32, smem, s>>>(
      static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(t),
      static_cast<const __nv_bfloat16*>(t_lo), d, w_tile, tb, n_ctx, drop,
      hi_s, lo_s, d_tok, d_path, static_cast<__nv_bfloat16*>(g_tok),
      static_cast<__nv_bfloat16*>(g_path));
  return cudaGetLastError();
}

template <int NT, int NB>
cudaError_t launch_dw(const uint8_t* hi_s, const uint8_t* lo_s,
                      const uint8_t* fill, int d, int k_dim,
                      const Tables& tb, int64_t n_ctx,
                      int64_t n_chunks, int slices, const c2v::Dropout& drop,
                      float* partial, cudaStream_t s) {
  const int smem = dw_stages(NT * NB) * (kChunkRows * 512 + NT * NB * kBlock) +
                   kCBufs * kBlock + 2 * dw_stages(NT * NB) * 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      dw_pass<NT, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = slices * (k_dim / 128) * (d / (64 * NB * NT));
  dw_pass<NT, NB><<<grid, 256, smem, s>>>(
      hi_s, lo_s, fill, d, k_dim, tb, n_ctx, n_chunks, slices, drop,
      partial);
  return cudaGetLastError();
}

}  // namespace

// Rows of the dpre scratch for n_ctx context rows (whole 64-row tiles).
C2V_EXPORT int64_t c2v_encoder_backward_rows_padded(int64_t n_ctx) {
  return (n_ctx + kTileRows - 1) / kTileRows * kTileRows;
}

// Row slices of dW's partial sums: as many as fill the SMs with pass B's
// CTAs, at most one per 32-row chunk.
C2V_EXPORT int c2v_encoder_backward_slices(int64_t n_ctx, int k_dim, int d) {
  const int ctas = (k_dim / 128) * (d / dw_tile(d));
  const int64_t chunks = c2v_encoder_backward_rows_padded(n_ctx) / kChunkRows;
  int64_t slices = sm_count() / ctas;
  if (slices < 1) slices = 1;
  return static_cast<int>(slices < chunks ? slices : chunks);
}

// dt, t, t_lo: bf16 (n_ctx, d). w: f32 (k_dim, d). tok/path: f32 tables.
// src/pth/tgt: int32 (n_ctx,). Dropout as in c2v_context_encoder (mode 1
// redraws, mode 2 reads `mask`). Scratch: w_tile k_dim * d * 2 + 1024
// bytes; dpre_hi, dpre_lo bf16 (n_pad, d); partial f32 (slices, k_dim,
// d). Outputs: d_tok, d_path f32, zeroed by
// the caller, are added to; dw f32 (k_dim, d) is written. Row mode (g_tok
// not null): g_tok bf16 (2, n_ctx, tok_dim) and g_path bf16 (n_ctx,
// path_dim) are written and d_tok, d_path are not used. `events`, when
// not null, holds five cudaEvent_t recorded before pass 0 and after
// passes 0, A, B and C. Returns a cudaError_t.
C2V_EXPORT int c2v_encoder_backward(
    const void* dt, const void* t, const void* t_lo, int d, const float* w,
    const float* tok, int64_t tok_rows, int tok_dim, const float* path,
    int64_t path_rows, int path_dim, const int* src, const int* pth,
    const int* tgt, int64_t n_ctx, int drop_mode, float keep, uint64_t seed,
    uint64_t step, void* mask, void* w_tile, void* dpre_hi, void* dpre_lo,
    float* partial, float* d_tok, float* d_path, float* dw, void* g_tok,
    void* g_path, void* const* events, void* stream) {
  const int k_dim = 2 * tok_dim + path_dim;
  if (n_ctx <= 0 || tok_dim % 4 != 0 || path_dim % 4 != 0 ||
      k_dim % 128 != 0 || k_dim > 384 || d % 128 != 0 || d <= 0 ||
      drop_mode < 0 || drop_mode > 2 || !(keep > 0.f && keep <= 1.f) ||
      (drop_mode == 2 && mask == nullptr) ||
      (g_tok == nullptr) != (g_path == nullptr) ||
      (g_tok == nullptr && (d_tok == nullptr || d_path == nullptr)))
    return cudaErrorInvalidValue;
  c2v::Dropout drop;
  drop.mode = drop_mode;
  drop.keep = keep;
  drop.threshold = static_cast<uint32_t>(
      fminf(roundf(keep * 16777216.f), 16777216.f));
  drop.seed = seed;
  drop.step = step;
  drop.mask = drop_mode == 2 ? static_cast<uint8_t*>(mask) : nullptr;
  const Tables tb{tok, path, tok_rows, path_rows, tok_dim, path_dim,
                  src, pth, tgt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto mark = [&](int i) {
    if (events != nullptr)
      cudaEventRecord(static_cast<cudaEvent_t>(events[i]), s);
  };
  auto* wt = static_cast<uint8_t*>(w_tile);
  auto* hi = static_cast<uint8_t*>(dpre_hi);
  auto* lo = static_cast<uint8_t*>(dpre_lo);
  mark(0);
  const int n_w8 = k_dim * d / 8;
  w_tiles<<<(n_w8 + 255) / 256, 256, 0, s>>>(w, k_dim, d, wt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mark(1);
  switch (k_dim / 128) {
    case 1:
      err = launch_dctx<1>(dt, t, t_lo, d, wt, tb, n_ctx, drop, hi, lo, d_tok,
                           d_path, g_tok, g_path, s);
      break;
    case 2:
      err = launch_dctx<2>(dt, t, t_lo, d, wt, tb, n_ctx, drop, hi, lo, d_tok,
                           d_path, g_tok, g_path, s);
      break;
    default:
      err = launch_dctx<3>(dt, t, t_lo, d, wt, tb, n_ctx, drop, hi, lo, d_tok,
                           d_path, g_tok, g_path, s);
  }
  if (err != cudaSuccess) return err;
  mark(2);
  const int64_t n_chunks = c2v_encoder_backward_rows_padded(n_ctx) / kChunkRows;
  const int slices = c2v_encoder_backward_slices(n_ctx, k_dim, d);
  const uint8_t* fill = wt + k_dim * d * 2;
  const int tile = dw_tile(d);
  if (tile == 384)
    err = launch_dw<2, 3>(hi, lo, fill, d, k_dim, tb, n_ctx, n_chunks, slices,
                          drop, partial, s);
  else if (tile == 256)
    err = launch_dw<2, 2>(hi, lo, fill, d, k_dim, tb, n_ctx, n_chunks, slices,
                          drop, partial, s);
  else
    err = launch_dw<1, 2>(hi, lo, fill, d, k_dim, tb, n_ctx, n_chunks, slices,
                          drop, partial, s);
  if (err != cudaSuccess) return err;
  mark(3);
  const int64_t n_w = static_cast<int64_t>(k_dim) * d;
  dw_reduce<<<static_cast<unsigned>((n_w + 255) / 256), 256, 0, s>>>(
      partial, slices, n_w, dw);
  err = cudaGetLastError();
  mark(4);
  return err;
}
