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
// What bounds it on an H100: the product. At the serve shape (64 rows x
// 200 contexts, 384 -> 384) it is 3.8 GFLOP against ~5 MB of gathered
// rows and ~10 MB of bf16 output, so the tensor cores set the floor; at
// the train shape (1024 x 200) it is 60 GFLOP against ~315 MB of f32
// rows and 157 MB of output, and the bytes do.
// Design: one CTA owns a tile of 64 contexts x 128 output columns. One
// warp per context gathers its three embedding rows straight into shared
// memory with vector loads (decoding int8, fp8 or int4 exactly in
// registers, common.cuh, and dequantising as float(q) * scale, then
// rounding to bf16 exactly where the reference casts the concatenated
// context, then dropping four elements per Philox call). W is staged 128
// rows at a time as bf16, so two CTAs fit on an SM, and the product runs
// on the tensor cores with WMMA bf16 fragments and f32 accumulators. tanh
// runs in f32 on the accumulators and the result is stored as bf16. The
// (B, M, 384) f32 context never exists in device memory. Dropout and the
// residual output are compiled only into the train instantiation
// (kTrain), so the serving one carries neither; the train mode reads f32
// and int8 tables only. An int4 row is half the bytes of an int8 one, but
// at the serve shape the gathered rows are a third of the bytes and the
// product sets the floor, so the narrower formats barely move it. No TMA,
// wgmma or load/compute overlap yet.
#include "common.cuh"

#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTileM = 64;     // contexts per CTA
constexpr int kTileN = 128;    // output columns per CTA
constexpr int kChunkK = 128;   // rows of W staged at a time
constexpr int kThreads = 256;  // 8 warps: 4 row frags x 2 column halves
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;        // bf16 row padding (keeps 32-byte frag rows)
constexpr int kLdb = kTileN + kPad;
constexpr int kLdc = kTileN + 4;

// One embedding row, dequantised, rounded to bf16 and dropped out, into
// shared memory: each lane moves 4 values per step (a 16-byte f32 load, a
// 4-byte int8 or fp8 load, or a 2-byte load of four int4 nibbles, a row
// of int4 being dim / 2 bytes), decoded exactly to f32 in registers and
// times the row's scale, as the reference's `astype(f32) * scale`.
// `elem0` is the row's first flat index in the (n_ctx, k_dim) context, a
// multiple of 4. Dropout only when kTrain.
template <int kFmt, bool kTrain>
__device__ __forceinline__ void gather_row(__nv_bfloat16* dst,
                                           const void* table,
                                           const float* scales, int64_t rows,
                                           int dim, int64_t id, int lane,
                                           const c2v::Dropout& drop,
                                           int64_t elem0) {
  const bool ok = id >= 0 && id < rows;  // else jnp.take's NaN fill
  const float s = (kFmt != c2v::kF32 && ok) ? scales[id] : 1.f;
  const unsigned char* bytes = static_cast<const unsigned char*>(table);
  for (int c = lane * 4; c < dim; c += 128) {
    float v0 = nanf(""), v1 = v0, v2 = v0, v3 = v0;
    if (ok && kFmt == c2v::kF32) {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const float*>(table) + id * dim + c);
      v0 = f.x, v1 = f.y, v2 = f.z, v3 = f.w;
    } else if (ok) {
      const uint32_t w =
          kFmt == c2v::kInt4
              ? *reinterpret_cast<const uint16_t*>(bytes + id * (dim / 2) +
                                                   c / 2)
              : *reinterpret_cast<const uint32_t*>(bytes + id * dim + c);
      float q[4];
      c2v::decode4<kFmt>(w, q);
      v0 = q[0] * s, v1 = q[1] * s, v2 = q[2] * s, v3 = q[3] * s;
    }
    if (kTrain && drop.mode != 0) {
      const uint64_t group = static_cast<uint64_t>(elem0 + c) >> 2;
      bool k[4];
      c2v::dropout_keep4(drop, group, k);
      v0 = k[0] ? c2v::bf16_round(c2v::bf16_round(v0) / drop.keep) : 0.f;
      v1 = k[1] ? c2v::bf16_round(c2v::bf16_round(v1) / drop.keep) : 0.f;
      v2 = k[2] ? c2v::bf16_round(c2v::bf16_round(v2) / drop.keep) : 0.f;
      v3 = k[3] ? c2v::bf16_round(c2v::bf16_round(v3) / drop.keep) : 0.f;
      if (drop.mode == 1 && drop.mask != nullptr)
        *reinterpret_cast<uchar4*>(drop.mask + 4 * group) =
            make_uchar4(k[0], k[1], k[2], k[3]);
    }
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst + c);
    d2[0] = __floats2bfloat162_rn(v0, v1);
    d2[1] = __floats2bfloat162_rn(v2, v3);
  }
}

template <int kFmt, bool kTrain>
__global__ void __launch_bounds__(kThreads, 2)
context_encoder_kernel(const void* tok, const float* tok_scale,
                       int64_t tok_rows, int tok_dim, const void* path,
                       const float* path_scale, int64_t path_rows,
                       int path_dim, const float* w, int d_out,
                       const int* src, const int* pth, const int* tgt,
                       int64_t n_ctx, __nv_bfloat16* out,
                       __nv_bfloat16* out_lo, c2v::Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k_dim = 2 * tok_dim + path_dim;
  const int lda = k_dim + kPad;
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sb = sa + kTileM * lda;
  float* sc = reinterpret_cast<float*>(sb);  // reused after the product

  const int64_t ctx0 = static_cast<int64_t>(blockIdx.x) * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // Gather [src | path | tgt] rows: one warp per context row.
#pragma unroll
  for (int i = 0; i < kTileM / kWarps; ++i) {
    const int r = warp + kWarps * i;
    const int64_t ctx = ctx0 + r;
    __nv_bfloat16* dst = sa + r * lda;
    if (ctx < n_ctx) {
      // Only the CTAs of the first column tile write a drawn mask out.
      c2v::Dropout d = drop;
      if (kTrain && blockIdx.y != 0 && d.mode == 1) d.mask = nullptr;
      const int64_t e0 = ctx * k_dim;
      gather_row<kFmt, kTrain>(dst, tok, tok_scale, tok_rows, tok_dim,
                               src[ctx], lane, d, e0);
      gather_row<kFmt, kTrain>(dst + tok_dim, path, path_scale, path_rows,
                               path_dim, pth[ctx], lane, d, e0 + tok_dim);
      gather_row<kFmt, kTrain>(dst + tok_dim + path_dim, tok, tok_scale,
                               tok_rows, tok_dim, tgt[ctx], lane, d,
                               e0 + tok_dim + path_dim);
    } else {
      for (int c = lane * 2; c < k_dim; c += 64)
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
  }

  const int fr = warp >> 1;         // 16-row block 0..3
  const int fc = (warp & 1) * 4;    // first of four 16-column blocks
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int k0 = 0; k0 < k_dim; k0 += kChunkK) {
    const int kc = min(kChunkK, k_dim - k0);
    __syncthreads();  // the previous chunk of W is consumed
    // W[k0:k0+kc, n0:n0+128] rounded to bf16 (the reference's
    // transform.astype), four columns per 16-byte load.
#pragma unroll 4
    for (int e = tid; e < kc * (kTileN / 4); e += kThreads) {
      const int kk = e / (kTileN / 4), n = (e % (kTileN / 4)) * 4;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + n < d_out)
        f = *reinterpret_cast<const float4*>(w + (k0 + kk) * d_out + n0 + n);
      __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(
          sb + kk * kLdb + n);
      d2[0] = __floats2bfloat162_rn(f.x, f.y);
      d2[1] = __floats2bfloat162_rn(f.z, f.w);
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, sa + fr * 16 * lda + k0 + kk, lda);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, sb + kk * kLdb + (fc + j) * 16, kLdb);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();  // sc overlays sb
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(sc + fr * 16 * kLdc + (fc + j) * 16, acc[j],
                            kLdc, wmma::mem_row_major);
  __syncthreads();

  // tanh in f32, stored as bf16, two columns per 4-byte store.
  for (int e = tid; e < kTileM * (kTileN / 2); e += kThreads) {
    const int r = e / (kTileN / 2), n = (e % (kTileN / 2)) * 2;
    const int64_t ctx = ctx0 + r;
    if (ctx < n_ctx && n0 + n < d_out) {
      const float t0 = tanhf(sc[r * kLdc + n]);
      const float t1 = tanhf(sc[r * kLdc + n + 1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(t0, t1);
      *reinterpret_cast<__nv_bfloat162*>(out + ctx * d_out + n0 + n) = hi;
      if (kTrain && out_lo != nullptr) {
        const float2 h = __bfloat1622float2(hi);
        *reinterpret_cast<__nv_bfloat162*>(out_lo + ctx * d_out + n0 + n) =
            __floats2bfloat162_rn(t0 - h.x, t1 - h.y);
      }
    }
  }
}

}  // namespace

// Shared memory one CTA needs for a context width of k_dim.
// The f32 staging tile of the epilogue overlays W's chunk.
C2V_EXPORT int64_t c2v_context_encoder_smem(int k_dim) {
  const int64_t a = 2LL * kTileM * (k_dim + kPad);
  const int64_t b = 2LL * kChunkK * kLdb;
  const int64_t c = 4LL * kTileM * kLdc;
  return a + (b > c ? b : c);
}

// tok/path: tables of format `fmt` (c2v::TableFormat): f32 (scales null),
// or int8, e4m3, e5m2 (rows x dim bytes) or int4 (rows x dim / 2 bytes)
// with f32 (rows,) scales; the train mode takes f32 and int8 only.
// w: f32 (k_dim, d_out) row-major. src/pth/tgt: int32 (n_ctx,). out: bf16
// (n_ctx, d_out); out_lo, when not null, bf16 (n_ctx, d_out) receives
// the residual tanh - out. Dropout (common.cuh c2v::Dropout): drop_mode
// 0/1/2, keep in (0, 1], seed/step for mode 1, mask (n_ctx, k_dim) bytes for
// mode 2 (read) or mode 1 (written when not null). Returns a cudaError_t
// (0 on success).
C2V_EXPORT int c2v_context_encoder(const void* tok, const float* tok_scale,
                                   int64_t tok_rows, int tok_dim,
                                   const void* path, const float* path_scale,
                                   int64_t path_rows, int path_dim,
                                   int fmt, const float* w, int d_out,
                                   const int* src, const int* pth,
                                   const int* tgt, int64_t n_ctx, void* out,
                                   void* out_lo, int drop_mode, float keep,
                                   uint64_t seed, uint64_t step, void* mask,
                                   void* stream) {
  const int k_dim = 2 * tok_dim + path_dim;
  if (k_dim % 16 != 0 || tok_dim % 4 != 0 || path_dim % 4 != 0 ||
      d_out % 16 != 0 || n_ctx <= 0)
    return cudaErrorInvalidValue;
  if (drop_mode < 0 || drop_mode > 2 || !(keep > 0.f && keep <= 1.f) ||
      (drop_mode == 2 && mask == nullptr))
    return cudaErrorInvalidValue;
  c2v::Dropout drop;
  drop.mode = drop_mode;
  drop.keep = keep;
  drop.threshold = static_cast<uint32_t>(
      fminf(roundf(keep * 16777216.f), 16777216.f));
  drop.seed = seed;
  drop.step = step;
  drop.mask = static_cast<uint8_t*>(mask);
  const int64_t smem = c2v_context_encoder_smem(k_dim);
  const dim3 grid(static_cast<unsigned>((n_ctx + kTileM - 1) / kTileM),
                  static_cast<unsigned>((d_out + kTileN - 1) / kTileN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* o_lo = static_cast<__nv_bfloat16*>(out_lo);
  const bool train = drop_mode != 0 || out_lo != nullptr;
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, s>>>(
        tok, tok_scale, tok_rows, tok_dim, path, path_scale, path_rows,
        path_dim, w, d_out, src, pth, tgt, n_ctx, o, o_lo, drop);
    return cudaSuccess;
  };
  cudaError_t err;
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
