// K8 adam: dense Adam over every parameter in one multi-tensor launch,
// with bf16 or f32 storage for each moment.
//
// Replaces code2vec_tpu/training/state.py make_optimizer (:99-115): the
// `_scale_by_adam_nu_dtype` chain (:62-96) when nu is stored in bf16, and
// `optax.adam(mu_dtype=...)` when nu is f32, each followed by
// optax.apply_updates. As there, the moments are computed in f32 from the
// stored ones, the update uses the unrounded f32 moments, and only their
// storage is rounded:
//   m = b1 m_stored + (1 - b1) g          (_scale_by_adam_nu_dtype)
//   m = (1 - b1) g + bf16(bf16(b1) m_stored)  (optax.adam, bf16 mu: optax
//       multiplies the bf16 moment by the Python float b1 in bf16)
//   v = b2 v_stored + (1 - b2) g^2
//   p = p + (m / b1c) / (sqrt(v / b2c) + eps) * (-lr)
// with b1c = 1 - b1^count, b2c = 1 - b2^count for the incremented count,
// computed in f32 by the caller. Every operation is rounded on its own
// (no FMA contraction), in the plain version's order.
//
// What bounds it on an H100: bytes. Per parameter it reads p, g (f32) and
// the two moments and writes p and the moments: 20 bytes with bf16
// moments, 7.7 GB for the flagship's 383.7M parameters. Design: a table
// of up to 8 tensors (pointers, sizes, first block) passed by value; each
// CTA of 256 threads takes 2,048 consecutive elements of one tensor. Where
// every size is a multiple of 4 (the flagship's are), a thread moves four
// consecutive elements per access (16-byte f32, 8-byte bf16), two such
// groups a chunk; otherwise eight single elements a stride of 256 apart.
// Every access is coalesced. The gradients are read and left as they are.
#include "common.cuh"

namespace {

constexpr int kMaxTensors = 8;
constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;

struct TensorTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  void* mu[kMaxTensors];
  void* nu[kMaxTensors];
  int64_t n[kMaxTensors];
  int64_t block_start[kMaxTensors + 1];
  int count;
};

struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, b1_bf16, b1c, b2c, eps, neg_lr;
};

template <bool kBf16>
__device__ __forceinline__ float load_moment(const void* base, int64_t i) {
  if (kBf16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i]);
  return static_cast<const float*>(base)[i];
}

template <bool kBf16>
__device__ __forceinline__ void store_moment(void* base, int64_t i, float x) {
  if (kBf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

template <bool kOptaxMu>
__device__ __forceinline__ void adam_elem(const Hyper& h, float gi, float ms,
                                          float vs, float& p, float& m,
                                          float& v) {
  if (kOptaxMu)
    m = __fadd_rn(__fmul_rn(h.one_minus_b1, gi),
                  c2v::bf16_round(__fmul_rn(h.b1_bf16, ms)));
  else
    m = __fadd_rn(__fmul_rn(h.b1, ms), __fmul_rn(h.one_minus_b1, gi));
  v = __fadd_rn(__fmul_rn(h.b2, vs),
                __fmul_rn(h.one_minus_b2, __fmul_rn(gi, gi)));
  const float u = __fdiv_rn(
      __fdiv_rn(m, h.b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  p = __fadd_rn(p, __fmul_rn(u, h.neg_lr));
}

// Four moments at i (a multiple of 4): one 8-byte (bf16) or 16-byte load.
template <bool kBf16>
__device__ __forceinline__ float4 load_moment4(const void* base, int64_t i) {
  if (kBf16) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(base) + i);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(base) + i);
}

template <bool kBf16>
__device__ __forceinline__ void store_moment4(void* base, int64_t i,
                                              float4 x) {
  if (kBf16) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(base) + i) = raw;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) = x;
  }
}

// kVec4: every tensor's size is a multiple of 4 and its pointers are
// aligned, so a thread moves 4 consecutive elements per access (16-byte
// f32 and 8-byte bf16 loads and stores), two groups a chunk.
template <bool kMuBf16, bool kNuBf16, bool kOptaxMu, bool kVec4>
__global__ void __launch_bounds__(kThreads)
adam_kernel(TensorTable tt, Hyper h) {
  int t = 0;
  while (t + 1 < tt.count && tt.block_start[t + 1] <= blockIdx.x) ++t;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) - tt.block_start[t]) * kChunk;
  float* p = tt.p[t];
  const float* g = tt.g[t];
  void* mu = tt.mu[t];
  void* nu = tt.nu[t];
  const int64_t n = tt.n[t];
  if (kVec4) {
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const int64_t i = base + 4 * (k * kThreads + threadIdx.x);
      if (i >= n) break;
      float4 pv = *reinterpret_cast<const float4*>(p + i);
      const float4 gv = *reinterpret_cast<const float4*>(g + i);
      const float4 ms = load_moment4<kMuBf16>(mu, i);
      const float4 vs = load_moment4<kNuBf16>(nu, i);
      float4 m, v;
      adam_elem<kOptaxMu>(h, gv.x, ms.x, vs.x, pv.x, m.x, v.x);
      adam_elem<kOptaxMu>(h, gv.y, ms.y, vs.y, pv.y, m.y, v.y);
      adam_elem<kOptaxMu>(h, gv.z, ms.z, vs.z, pv.z, m.z, v.z);
      adam_elem<kOptaxMu>(h, gv.w, ms.w, vs.w, pv.w, m.w, v.w);
      *reinterpret_cast<float4*>(p + i) = pv;
      store_moment4<kMuBf16>(mu, i, m);
      store_moment4<kNuBf16>(nu, i, v);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    if (i >= n) break;
    float pi = p[i], m, v;
    adam_elem<kOptaxMu>(h, g[i], load_moment<kMuBf16>(mu, i),
                        load_moment<kNuBf16>(nu, i), pi, m, v);
    p[i] = pi;
    store_moment<kMuBf16>(mu, i, m);
    store_moment<kNuBf16>(nu, i, v);
  }
}

template <bool kMuBf16, bool kNuBf16, bool kOptaxMu>
cudaError_t launch(const TensorTable& tt, const Hyper& h, int64_t blocks,
                   bool vec4, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec4)
    adam_kernel<kMuBf16, kNuBf16, kOptaxMu, true><<<grid, kThreads, 0, s>>>(
        tt, h);
  else
    adam_kernel<kMuBf16, kNuBf16, kOptaxMu, false><<<grid, kThreads, 0, s>>>(
        tt, h);
  return cudaGetLastError();
}

}  // namespace

C2V_EXPORT int c2v_adam_max_tensors() { return kMaxTensors; }

// count tensors: p (f32, updated in place), g (f32), mu and nu (bf16 where
// mu_bf16 / nu_bf16, else f32; updated in place), n elements each.
// optax_mu: the optax.adam rule for a bf16 mu (see above). Returns a
// cudaError_t.
C2V_EXPORT int c2v_adam(int count, void** p, void** g, void** mu, void** nu,
                        const int64_t* n, int mu_bf16, int nu_bf16,
                        int optax_mu, float b1, float b2, float one_minus_b1,
                        float one_minus_b2, float b1_bf16, float b1c,
                        float b2c, float eps, float neg_lr, void* stream) {
  if (count <= 0 || count > kMaxTensors || (optax_mu && !mu_bf16))
    return cudaErrorInvalidValue;
  TensorTable tt;
  tt.count = count;
  int64_t blocks = 0;
  bool vec4 = true;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) return cudaErrorInvalidValue;
    vec4 = vec4 && n[i] % 4 == 0 &&
           reinterpret_cast<uintptr_t>(p[i]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(g[i]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(mu[i]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(nu[i]) % 16 == 0;
    tt.p[i] = static_cast<float*>(p[i]);
    tt.g[i] = static_cast<const float*>(g[i]);
    tt.mu[i] = mu[i];
    tt.nu[i] = nu[i];
    tt.n[i] = n[i];
    tt.block_start[i] = blocks;
    blocks += (n[i] + kChunk - 1) / kChunk;
  }
  tt.block_start[count] = blocks;
  const Hyper h{b1, b2, one_minus_b1, one_minus_b2, b1_bf16,
                b1c, b2c, eps, neg_lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (optax_mu) return launch<true, false, true>(tt, h, blocks, vec4, s);
  if (mu_bf16 && nu_bf16)
    return launch<true, true, false>(tt, h, blocks, vec4, s);
  if (mu_bf16) return launch<true, false, false>(tt, h, blocks, vec4, s);
  if (nu_bf16) return launch<false, true, false>(tt, h, blocks, vec4, s);
  return launch<false, false, false>(tt, h, blocks, vec4, s);
}
