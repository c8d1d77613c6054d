// K5 encoder_backward: the backward of K1 (gather, concat, bf16 cast,
// dropout, tanh(ctx @ W)) for dense table gradients.
//
// Replaces the autodiff of code2vec_tpu/models/code2vec.py
// transform_contexts / transform_gathered (:128-177) inside
// jax.grad of the dense train step (code2vec_tpu/training/step.py:177-199).
// Given dT (the cotangent of K1's bf16 output) and K1's output T it
// computes, for every context row r of the (B*M) rows:
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
// (hi = bf16(dpre), lo = bf16(dpre - hi)) and runs each product twice on
// the tensor cores, which carries 16 of f32's 24 mantissa bits (a
// relative error near 2^-17, far under the bf16 rounding that follows).
// The reference differentiates tanh at its f32 value, before the cast to
// bf16. K1 saves that value as T + T_lo (T_lo = bf16(tanh - T), its train
// mode's residual output), and this kernel adds the two back in f32 (the
// bf16 T alone would move 1 - T^2 by up to 2^-8 relative, more near
// |T| = 1).
//
// What bounds it on an H100: bytes. At the train shape (204,800 context
// rows, 384 -> 384) the two products are 121 GFLOP (0.12 ms of bf16
// tensor-core time) while dT, T, the re-gathered f32 rows (~315 MB) and
// the scatter into the 1.3M x 128 and 911K x 128 f32 tables move ~1 GB.
// Design: kernel A takes 64 rows per CTA: tanh's rule into shared memory
// (hi/lo bf16), the dctx product with WMMA (each warp owns 48 columns of
// all 64 rows and reads its W^T fragments straight from an L2-resident
// bf16 copy of W, each feeding four row fragments), and an epilogue that rounds, drops
// out and scatter-adds four columns at a time with 16-byte f32 vector
// atomics (their order varies from run to run: sums of the same
// bf16-valued terms in another order). Kernel A also writes dpre (hi/lo)
// and the dropped-out context to scratch, from which kernel B forms dW's
// partial sums per (128 x 128 tile, row slice), staging 32 rows of each
// operand in shared memory per step, and kernel C adds the slices in a
// fixed order and rounds (dW is deterministic). No TMA, wgmma or
// pipelining yet.
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTileM = 64;     // context rows per CTA of kernel A
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;        // bf16 row padding of the dpre tiles
constexpr int kRowFrags = kTileM / 16;  // 4 16-row fragments of a tile
constexpr int kMaxColFrags = 3;  // k_dim <= 384: 3 16-wide frags a warp
constexpr int kTileW = 128;    // dW output tile (128 x 128)
constexpr int kSlices = 32;    // row slices of the dW partial sums

__global__ void to_bf16_kernel(const float* x, __nv_bfloat16* y, int64_t n) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x)
    y[i] = __float2bfloat16_rn(x[i]);
}

// One f32 embedding row, rounded to bf16 and dropped out as K1 does, to
// global memory. `elem0` is the row's first flat index in the context.
__device__ __forceinline__ void gather_row(__nv_bfloat16* dst,
                                           const float* table, int64_t rows,
                                           int dim, int64_t id, int lane,
                                           const c2v::Dropout& drop,
                                           int64_t elem0) {
  const bool ok = id >= 0 && id < rows;  // else jnp.take's NaN fill
  for (int c = lane * 4; c < dim; c += 128) {
    float v[4] = {nanf(""), nanf(""), nanf(""), nanf("")};
    if (ok) {
      const float4 f = *reinterpret_cast<const float4*>(table + id * dim + c);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    }
    if (drop.mode != 0) {
      bool k[4];
      c2v::dropout_keep4(drop, static_cast<uint64_t>(elem0 + c) >> 2, k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = k[i] ? c2v::bf16_round(c2v::bf16_round(v[i]) / drop.keep)
                    : 0.f;
    }
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + c);
    d2[0] = __floats2bfloat162_rn(v[0], v[1]);
    d2[1] = __floats2bfloat162_rn(v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
encoder_backward_rows(const __nv_bfloat16* dt, const __nv_bfloat16* t,
                      const __nv_bfloat16* t_lo, int d, const __nv_bfloat16* wb, const float* tok,
                      int64_t tok_rows, int tok_dim, const float* path,
                      int64_t path_rows, int path_dim, const int* src,
                      const int* pth, const int* tgt, int64_t n_ctx,
                      c2v::Dropout drop, __nv_bfloat16* dpre_hi,
                      __nv_bfloat16* dpre_lo, __nv_bfloat16* ctx_out,
                      float* d_tok, float* d_path) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k_dim = 2 * tok_dim + path_dim;
  const int lda = d + kPad;
  const int ldc = k_dim + 4;
  __nv_bfloat16* sa_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sa_lo = sa_hi + kTileM * lda;
  float* sc = reinterpret_cast<float*>(smem);  // overlays sa after the MMA

  const int64_t ctx0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // tanh's rule in f32 (no FMA contraction: the plain version's order),
  // split into bf16 hi + lo, to shared memory and to the dW scratch.
  for (int e = tid; e < kTileM * (d / 2); e += kThreads) {
    const int r = e / (d / 2), c = (e % (d / 2)) * 2;
    const int64_t ctx = ctx0 + r;
    float g[2] = {0.f, 0.f}, tv[2] = {0.f, 0.f};
    if (ctx < n_ctx) {
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dt + ctx * d + c));
      const float2 tf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(t + ctx * d + c));
      const float2 lf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(t_lo + ctx * d + c));
      g[0] = gf.x, g[1] = gf.y;
      tv[0] = __fadd_rn(tf.x, lf.x), tv[1] = __fadd_rn(tf.y, lf.y);
    }
    __nv_bfloat16 hi[2], lo[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float gp = __fmul_rn(g[i], __fsub_rn(1.f, tv[i]));
      const float p = __fadd_rn(gp, __fmul_rn(gp, tv[i]));
      hi[i] = __float2bfloat16_rn(p);
      lo[i] = __float2bfloat16_rn(p - __bfloat162float(hi[i]));
    }
    const __nv_bfloat162 h2 = __halves2bfloat162(hi[0], hi[1]);
    const __nv_bfloat162 l2 = __halves2bfloat162(lo[0], lo[1]);
    *reinterpret_cast<__nv_bfloat162*>(sa_hi + r * lda + c) = h2;
    *reinterpret_cast<__nv_bfloat162*>(sa_lo + r * lda + c) = l2;
    *reinterpret_cast<__nv_bfloat162*>(dpre_hi + ctx * d + c) = h2;
    *reinterpret_cast<__nv_bfloat162*>(dpre_lo + ctx * d + c) = l2;
  }

  // The dropped-out context, re-gathered, to the dW scratch.
  for (int r = warp; r < kTileM; r += kWarps) {
    const int64_t ctx = ctx0 + r;
    __nv_bfloat16* dst = ctx_out + ctx * k_dim;
    if (ctx < n_ctx) {
      const int64_t e0 = ctx * k_dim;
      gather_row(dst, tok, tok_rows, tok_dim, src[ctx], lane, drop, e0);
      gather_row(dst + tok_dim, path, path_rows, path_dim, pth[ctx], lane,
                 drop, e0 + tok_dim);
      gather_row(dst + tok_dim + path_dim, tok, tok_rows, tok_dim, tgt[ctx],
                 lane, drop, e0 + tok_dim + path_dim);
    } else {
      for (int c = lane * 2; c < k_dim; c += 64)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
  }
  __syncthreads();

  // dctx = dpre @ W^T: warp w owns all 64 rows x k_dim/8 columns, so each
  // W^T fragment it reads from L2 feeds four row fragments.
  const int cols = k_dim / kWarps;
  const int c_base = warp * cols;
  const int nf = cols / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float>
      acc[kRowFrags][kMaxColFrags];
#pragma unroll
  for (int i = 0; i < kRowFrags; ++i)
#pragma unroll
    for (int j = 0; j < kMaxColFrags; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  for (int kk = 0; kk < d; kk += 16) {
#pragma unroll
    for (int j = 0; j < kMaxColFrags; ++j) {
      if (j < nf) {
        // B[kk'][c] = W[c][kk']: W read column-major, ld = d.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, wb + (c_base + j * 16) * d + kk, d);
#pragma unroll
        for (int i = 0; i < kRowFrags; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> a_hi, a_lo;
          wmma::load_matrix_sync(a_hi, sa_hi + i * 16 * lda + kk, lda);
          wmma::load_matrix_sync(a_lo, sa_lo + i * 16 * lda + kk, lda);
          wmma::mma_sync(acc[i][j], a_hi, b, acc[i][j]);
          wmma::mma_sync(acc[i][j], a_lo, b, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // sc overlays sa
#pragma unroll
  for (int i = 0; i < kRowFrags; ++i)
#pragma unroll
    for (int j = 0; j < kMaxColFrags; ++j)
      if (j < nf)
        wmma::store_matrix_sync(sc + i * 16 * ldc + c_base + j * 16,
                                acc[i][j], ldc, wmma::mem_row_major);
  __syncthreads();

  // Round, drop out, scatter-add: four columns (one Philox group, never
  // straddling the token/path boundary) per step.
  for (int e = tid; e < kTileM * (k_dim / 4); e += kThreads) {
    const int r = e / (k_dim / 4), c = (e % (k_dim / 4)) * 4;
    const int64_t ctx = ctx0 + r;
    if (ctx >= n_ctx) continue;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = c2v::bf16_round(sc[r * ldc + c + i]);
    if (drop.mode != 0) {
      bool k[4];
      c2v::dropout_keep4(drop, static_cast<uint64_t>(ctx * k_dim + c) >> 2,
                         k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = k[i] ? c2v::bf16_round(v[i] / drop.keep) : 0.f;
    }
    float* table;
    int64_t id, rows;
    int col, dim;
    if (c < tok_dim) {
      table = d_tok, id = src[ctx], rows = tok_rows, col = c, dim = tok_dim;
    } else if (c < tok_dim + path_dim) {
      table = d_path, id = pth[ctx], rows = path_rows, col = c - tok_dim,
      dim = path_dim;
    } else {
      table = d_tok, id = tgt[ctx], rows = tok_rows,
      col = c - tok_dim - path_dim, dim = tok_dim;
    }
    if (id < 0 || id >= rows) continue;  // the scatter drops such ids
    // one 16-byte vector atomic (sm_90) for the four columns
    atomicAdd(reinterpret_cast<float4*>(table + id * dim + col),
              make_float4(v[0], v[1], v[2], v[3]));
  }
}

// dW partial sums: CTA (tile, slice) adds ctx^T dpre over its slice's rows
// for a 128 x 128 tile of dW. Each step stages 32 rows of the context's
// 128 tile columns and of dpre's (hi and lo) in shared memory; 8 warps
// (2 x 4) each own a 64 x 32 block: 4 x 2 accumulator fragments.
constexpr int kDwRows = 32;
constexpr int kDwLd = kTileW + kPad;

__global__ void __launch_bounds__(kThreads)
encoder_backward_dw_partial(const __nv_bfloat16* ctx_s,
                            const __nv_bfloat16* dpre_hi,
                            const __nv_bfloat16* dpre_lo, int k_dim, int d,
                            int64_t rows_per_slice, int64_t n_pad,
                            float* partial) {
  __shared__ __align__(32) __nv_bfloat16 sc[kDwRows * kDwLd];
  __shared__ __align__(32) __nv_bfloat16 sh[kDwRows * kDwLd];
  __shared__ __align__(32) __nv_bfloat16 sl[kDwRows * kDwLd];
  const int tiles_d = d / kTileW;
  const int i0 = (blockIdx.x / tiles_d) * kTileW;
  const int j0 = (blockIdx.x % tiles_d) * kTileW;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wi = (warp >> 2) * 64;  // this warp's rows of the tile
  const int wj = (warp & 3) * 32;   // and columns
  const int64_t r0 = blockIdx.y * rows_per_slice;
  const int64_t r1 = min(r0 + rows_per_slice, n_pad);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);
  for (int64_t n0 = r0; n0 < r1; n0 += kDwRows) {
    __syncthreads();  // the previous step's tiles are consumed
    // 32 rows x 128 columns of each operand, 16 bytes per thread per copy
    for (int e = tid; e < kDwRows * (kTileW / 8); e += kThreads) {
      const int r = e / (kTileW / 8), c = (e % (kTileW / 8)) * 8;
      const int64_t n = n0 + r;
      uint4 vc = make_uint4(0, 0, 0, 0), vh = vc, vl = vc;
      if (n < r1) {
        vc = *reinterpret_cast<const uint4*>(ctx_s + n * k_dim + i0 + c);
        vh = *reinterpret_cast<const uint4*>(dpre_hi + n * d + j0 + c);
        vl = *reinterpret_cast<const uint4*>(dpre_lo + n * d + j0 + c);
      }
      *reinterpret_cast<uint4*>(sc + r * kDwLd + c) = vc;
      *reinterpret_cast<uint4*>(sh + r * kDwLd + c) = vh;
      *reinterpret_cast<uint4*>(sl + r * kDwLd + c) = vl;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDwRows; kk += 16) {
      // A[i][n] = ctx[n][i]: the staged context read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        wmma::load_matrix_sync(fa[a], sc + kk * kDwLd + wi + a * 16, kDwLd);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bh, bl;
        wmma::load_matrix_sync(bh, sh + kk * kDwLd + wj + b * 16, kDwLd);
        wmma::load_matrix_sync(bl, sl + kk * kDwLd + wj + b * 16, kDwLd);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          wmma::mma_sync(acc[a][b], fa[a], bh, acc[a][b]);
          wmma::mma_sync(acc[a][b], fa[a], bl, acc[a][b]);
        }
      }
    }
  }
  float* out = partial + static_cast<int64_t>(blockIdx.y) * k_dim * d;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(out + (i0 + wi + a * 16) * d + j0 + wj + b * 16,
                              acc[a][b], d, wmma::mem_row_major);
}

// dW = f32(bf16(sum of the slices)), the slices added in order.
__global__ void encoder_backward_dw_reduce(const float* partial, int slices,
                                           int64_t n, float* dw) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += partial[k * n + i];
    dw[i] = c2v::bf16_round(s);
  }
}

}  // namespace

// Rows of scratch and slices of the dW partials for n_ctx context rows.
C2V_EXPORT int64_t c2v_encoder_backward_rows_padded(int64_t n_ctx) {
  return (n_ctx + kTileM - 1) / kTileM * kTileM;
}

C2V_EXPORT int c2v_encoder_backward_slices(int64_t n_ctx) {
  const int64_t tiles = (n_ctx + kTileM - 1) / kTileM;
  return static_cast<int>(tiles < kSlices ? tiles : kSlices);
}

// dt, t, t_lo: bf16 (n_ctx, d). w: f32 (k_dim, d). tok/path: f32 tables.
// src/pth/tgt: int32 (n_ctx,). Dropout as in c2v_context_encoder (mode 1
// redraws, mode 2 reads `mask`). Scratch: wb bf16 (k_dim, d); dpre_hi,
// dpre_lo bf16 (n_pad, d); ctx_s bf16 (n_pad, k_dim); partial f32
// (slices, k_dim, d). Outputs: d_tok, d_path f32, zeroed by the caller,
// are added to; dw f32 (k_dim, d) is written. Returns a cudaError_t.
C2V_EXPORT int c2v_encoder_backward(
    const void* dt, const void* t, const void* t_lo, int d, const float* w, const float* tok,
    int64_t tok_rows, int tok_dim, const float* path, int64_t path_rows,
    int path_dim, const int* src, const int* pth, const int* tgt,
    int64_t n_ctx, int drop_mode, float keep, uint64_t seed, uint64_t step,
    void* mask, void* wb, void* dpre_hi, void* dpre_lo, void* ctx_s,
    float* partial, float* d_tok, float* d_path, float* dw, void* stream) {
  const int k_dim = 2 * tok_dim + path_dim;
  if (n_ctx <= 0 || tok_dim % 4 != 0 || path_dim % 4 != 0 ||
      k_dim % kTileW != 0 || k_dim > 16 * kWarps * kMaxColFrags ||
      d % kTileW != 0 ||
      drop_mode < 0 || drop_mode > 2 || !(keep > 0.f && keep <= 1.f) ||
      (drop_mode == 2 && mask == nullptr))
    return cudaErrorInvalidValue;
  c2v::Dropout drop;
  drop.mode = drop_mode;
  drop.keep = keep;
  drop.threshold = static_cast<uint32_t>(
      fminf(roundf(keep * 16777216.f), 16777216.f));
  drop.seed = seed;
  drop.step = step;
  drop.mask = drop_mode == 2 ? static_cast<uint8_t*>(mask) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wbf = static_cast<__nv_bfloat16*>(wb);
  const int64_t n_w = static_cast<int64_t>(k_dim) * d;
  to_bf16_kernel<<<static_cast<unsigned>((n_w + 255) / 256), 256, 0, s>>>(
      w, wbf, n_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int64_t n_pad = c2v_encoder_backward_rows_padded(n_ctx);
  const int64_t sa = 2LL * 2 * kTileM * (d + kPad);
  const int64_t sc = 4LL * kTileM * (k_dim + 4);
  const int64_t smem = sa > sc ? sa : sc;
  err = cudaFuncSetAttribute(encoder_backward_rows,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  auto* hi = static_cast<__nv_bfloat16*>(dpre_hi);
  auto* lo = static_cast<__nv_bfloat16*>(dpre_lo);
  auto* cs = static_cast<__nv_bfloat16*>(ctx_s);
  encoder_backward_rows<<<static_cast<unsigned>(n_pad / kTileM), kThreads,
                          smem, s>>>(
      static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(t),
      static_cast<const __nv_bfloat16*>(t_lo), d, wbf, tok, tok_rows, tok_dim,
      path, path_rows, path_dim, src, pth, tgt, n_ctx, drop, hi, lo, cs,
      d_tok, d_path);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int slices = c2v_encoder_backward_slices(n_ctx);
  const int64_t rows_per_slice =
      ((n_pad + slices - 1) / slices + kDwRows - 1) / kDwRows * kDwRows;
  const dim3 grid(static_cast<unsigned>((k_dim / kTileW) * (d / kTileW)),
                  static_cast<unsigned>(slices));
  encoder_backward_dw_partial<<<grid, kThreads, 0, s>>>(
      cs, hi, lo, k_dim, d, rows_per_slice, n_pad, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  encoder_backward_dw_reduce<<<static_cast<unsigned>((n_w + 255) / 256), 256,
                               0, s>>>(partial, slices, n_w, dw);
  return cudaGetLastError();
}
