// K4 label_logits: the logit of each row's own label.
//
// Replaces code2vec_tpu/ops/topk.py gathered_label_logits (:182-202): a
// gather of the label's table row, a dot with the code vector (bf16
// operands, f32 accumulation), times the row's dequant scale, and the
// reference's nonfinite guard (a NaN/Inf logit becomes -1e30). A label
// outside the table gives -1e30, as jnp.take's NaN fill does there.
//
// What bounds it on an H100: launch latency. At the serve shape it reads
// 64 table rows (25 KB) and does 49 K flops. Design: one warp per row, the
// lanes striding over the row so each 32-lane load is contiguous.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <bool kInt8>
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
  for (int i = lane; i < d; i += 32) {
    const float w =
        kInt8 ? static_cast<float>(
                    static_cast<const int8_t*>(table)[lab * d + i])
              : c2v::bf16_round(static_cast<const float*>(table)[lab * d + i]);
    acc += c2v::bf16_round(x[i]) * w;
  }
  acc = c2v::warp_sum(acc);
  if (lane == 0) {
    if (kInt8) acc *= scales[lab];
    out[b] = isfinite(acc) ? acc : -1e30f;
  }
}

}  // namespace

// cv: f32 (b, d); table int8 (v, d) + f32 (v,) scales, or f32 (v, d) with
// scales null; labels int32 (b,); out f32 (b,). Returns a cudaError_t.
C2V_EXPORT int c2v_label_logits(const float* cv, int b, int d,
                                const void* table, const float* scales,
                                int is_int8, int64_t v, const int* labels,
                                float* out, void* stream) {
  if (b <= 0 || d <= 0 || v <= 0) return cudaErrorInvalidValue;
  const unsigned blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8)
    label_logits_kernel<true><<<blocks, kThreads, 0, s>>>(
        cv, b, d, table, scales, v, labels, out);
  else
    label_logits_kernel<false><<<blocks, kThreads, 0, s>>>(
        cv, b, d, table, scales, v, labels, out);
  return cudaGetLastError();
}
