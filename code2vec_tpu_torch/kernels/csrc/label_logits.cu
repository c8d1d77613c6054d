// K4 label_logits: the logit of each row's own label.
//
// Replaces code2vec_tpu/ops/topk.py gathered_label_logits (:182-202): a
// gather of the label's table row, a dot with the code vector (bf16
// operands, f32 accumulation), times the row's dequant scale, and the
// reference's nonfinite guard (a NaN/Inf logit becomes -1e30). A label
// outside the table gives -1e30, as jnp.take's NaN fill does there. The
// table is f32, or int8, fp8 e4m3 / e5m2 or packed int4 (the reference's
// unpack_int4 on the gathered rows, topk.py:193-195) with per-row scales;
// each value decodes exactly (common.cuh) and is exact in bf16.
//
// What bounds it on an H100: launch latency. At the serve shape it reads
// 64 table rows (25 KB) and does 49 K flops. Design: one warp per row, the
// lanes striding over the row so each 32-lane load is contiguous.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// Value i of row `row` of a table of format kFmt, before its scale, as the
// bf16 operand of the product (exact for every quantized format).
template <int kFmt>
__device__ __forceinline__ float table_value(const void* table, int64_t row,
                                             int d, int i) {
  if (kFmt == c2v::kF32)
    return c2v::bf16_round(static_cast<const float*>(table)[row * d + i]);
  const unsigned char* bytes = static_cast<const unsigned char*>(table);
  float v[4];
  if (kFmt == c2v::kInt4) {
    const uint32_t b = bytes[row * ((d + 1) / 2) + i / 2];
    c2v::decode4<kFmt>((i & 1) ? b >> 4 : b, v);
  } else {
    c2v::decode4<kFmt>(bytes[row * d + i], v);
  }
  return v[0];
}

template <int kFmt>
__global__ void __launch_bounds__(kThreads)
label_logits_kernel(const float* cv, int b_rows, int d, const void* table,
                    const float* scales, int64_t v_rows, const int* labels,
                    float* out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (b >= b_rows) return;
  const int64_t lab = labels[b];
  if (lab < 0 || lab >= v_rows) {
    if (lane == 0) out[b] = -1e30f;
    return;
  }
  const float* x = cv + static_cast<int64_t>(b) * d;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32)
    acc += c2v::bf16_round(x[i]) * table_value<kFmt>(table, lab, d, i);
  acc = c2v::warp_sum(acc);
  if (lane == 0) {
    if (kFmt != c2v::kF32) acc *= scales[lab];
    out[b] = isfinite(acc) ? acc : -1e30f;
  }
}

}  // namespace

// cv: f32 (b, d); table of format `fmt` (c2v::TableFormat): f32 (v, d)
// with scales null, or int8, e4m3, e5m2 (v, d bytes) or int4
// (v, ceil(d / 2) bytes) with f32 (v,) scales; labels int32 (b,); out f32
// (b,). Returns a cudaError_t.
C2V_EXPORT int c2v_label_logits(const float* cv, int b, int d,
                                const void* table, const float* scales,
                                int fmt, int64_t v, const int* labels,
                                float* out, void* stream) {
  if (b <= 0 || d <= 0 || v <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, s>>>(cv, b, d, table, scales, v, labels,
                                       out);
  };
  switch (fmt) {
    case c2v::kF32: run(label_logits_kernel<c2v::kF32>); break;
    case c2v::kInt8: run(label_logits_kernel<c2v::kInt8>); break;
    case c2v::kE4M3: run(label_logits_kernel<c2v::kE4M3>); break;
    case c2v::kE5M2: run(label_logits_kernel<c2v::kE5M2>); break;
    case c2v::kInt4: run(label_logits_kernel<c2v::kInt4>); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
