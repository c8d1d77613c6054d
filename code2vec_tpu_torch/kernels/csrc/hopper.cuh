// Hopper building blocks shared by the kernels that run on `wgmma` and
// bulk (TMA) copies under mbarriers: K1 (encoder.cu), K3 (topk.cu), K5
// (encoder_backward.cu), K9 (kmeans.cu); K7 (softmax_xent.cu) takes the
// bulk copies. PTX for `sm_90a`.
#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's declaration

#include "common.cuh"

namespace c2v {
namespace hopper {

// The 16-byte chunk j (0-7) of row r of a 128-byte-swizzled tile: the
// chunk index XOR the row's place in its 8-row (1024-byte) group, as TMA's
// SWIZZLE_128B and wgmma's 128B layout place it.
__device__ __forceinline__ int swz(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Bulk (TMA) copy of `bytes` contiguous bytes into shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bulk (TMA) copy of shared memory to device memory, in a bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until at most N bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Make this thread's shared-memory writes visible to the async proxy
// (wgmma, bulk copies) once the threads have met at a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// 1 (SWIZZLE_128B). K-major: rows of 64 K values, 8-row groups `sbo`
// apart (lbo unused). MN-major: rows of 64 M/N values, one per K; groups
// of 8 K rows `sbo` apart, 64-wide M/N blocks `lbo` apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d[64] = A (64 x 16) B (16 x 128) (+ d where `accumulate`), both
// operands by descriptor; TA, TB: 1 for an MN-major operand, 0 for a
// K-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      "%64,%65,p,1,1,%67,%68;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),"+f"(d[16]),
        "+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),
        "+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),
        "+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31]),
        "+f"(d[32]),"+f"(d[33]),"+f"(d[34]),"+f"(d[35]),"+f"(d[36]),
        "+f"(d[37]),"+f"(d[38]),"+f"(d[39]),"+f"(d[40]),"+f"(d[41]),
        "+f"(d[42]),"+f"(d[43]),"+f"(d[44]),"+f"(d[45]),"+f"(d[46]),
        "+f"(d[47]),"+f"(d[48]),"+f"(d[49]),"+f"(d[50]),"+f"(d[51]),
        "+f"(d[52]),"+f"(d[53]),"+f"(d[54]),"+f"(d[55]),"+f"(d[56]),
        "+f"(d[57]),"+f"(d[58]),"+f"(d[59]),"+f"(d[60]),"+f"(d[61]),
        "+f"(d[62]),"+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[48] = A (64 x 16) B (16 x 96) (+ d where `accumulate`), as
// wgmma_n128.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47},"
      "%48,%49,p,1,1,%51,%52;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),"+f"(d[16]),"+f"(d[17]),
        "+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),"+f"(d[22]),"+f"(d[23]),
        "+f"(d[24]),"+f"(d[25]),"+f"(d[26]),"+f"(d[27]),"+f"(d[28]),"+f"(d[29]),
        "+f"(d[30]),"+f"(d[31]),"+f"(d[32]),"+f"(d[33]),"+f"(d[34]),"+f"(d[35]),
        "+f"(d[36]),"+f"(d[37]),"+f"(d[38]),"+f"(d[39]),"+f"(d[40]),"+f"(d[41]),
        "+f"(d[42]),"+f"(d[43]),"+f"(d[44]),"+f"(d[45]),"+f"(d[46]),"+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d[96] = A (64 x 16) B (16 x 192) (+ d where `accumulate`), as
// wgmma_n128.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,"
      "%87,%88,%89,%90,%91,%92,%93,%94,%95},"
      "%96,%97,p,1,1,%99,%100;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),"+f"(d[16]),
        "+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),
        "+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),
        "+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31]),
        "+f"(d[32]),"+f"(d[33]),"+f"(d[34]),"+f"(d[35]),"+f"(d[36]),
        "+f"(d[37]),"+f"(d[38]),"+f"(d[39]),"+f"(d[40]),"+f"(d[41]),
        "+f"(d[42]),"+f"(d[43]),"+f"(d[44]),"+f"(d[45]),"+f"(d[46]),
        "+f"(d[47]),"+f"(d[48]),"+f"(d[49]),"+f"(d[50]),"+f"(d[51]),
        "+f"(d[52]),"+f"(d[53]),"+f"(d[54]),"+f"(d[55]),"+f"(d[56]),
        "+f"(d[57]),"+f"(d[58]),"+f"(d[59]),"+f"(d[60]),"+f"(d[61]),
        "+f"(d[62]),"+f"(d[63]),"+f"(d[64]),"+f"(d[65]),"+f"(d[66]),
        "+f"(d[67]),"+f"(d[68]),"+f"(d[69]),"+f"(d[70]),"+f"(d[71]),
        "+f"(d[72]),"+f"(d[73]),"+f"(d[74]),"+f"(d[75]),"+f"(d[76]),
        "+f"(d[77]),"+f"(d[78]),"+f"(d[79]),"+f"(d[80]),"+f"(d[81]),
        "+f"(d[82]),"+f"(d[83]),"+f"(d[84]),"+f"(d[85]),"+f"(d[86]),
        "+f"(d[87]),"+f"(d[88]),"+f"(d[89]),"+f"(d[90]),"+f"(d[91]),
        "+f"(d[92]),"+f"(d[93]),"+f"(d[94]),"+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

__device__ __forceinline__ float lo_bf16(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}

// Register-A products: d (64 x N, f32) = A (64 x K, this warpgroup's
// registers) B (K x N, by descriptor, K-major) (+ d where `accumulate`),
// one overload per N (d holds N / 2 values a thread). bf16: K 16, `a`
// four bf16 pairs; tf32: K 8, `a` four tf32 values. Warp w of the
// warpgroup supplies rows 16 w + lane / 4 (a[0], a[2]) and + 8 (a[1],
// a[3]); bf16: a[0], a[1] hold columns 2 (lane % 4) + {0, 1}, a[2], a[3]
// those + 8; tf32: a[0], a[1] column lane % 4, a[2], a[3] that + 4. The
// accumulator layout is wgmma_n128's. The registers of `a` must not be
// written until the product has completed (wgmma_wait).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3},"
      "{%4,%5,%6,%7}, %8, p,1,1,0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7},"
      "{%8,%9,%10,%11}, %12, p,1,1,0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15},"
      "{%16,%17,%18,%19}, %20, p,1,1,0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      "{%32,%33,%34,%35}, %36, p,1,1,0;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),"+f"(d[16]),
        "+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),
        "+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),
        "+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3},"
      "{%4,%5,%6,%7}, %8, p,1,1;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7},"
      "{%8,%9,%10,%11}, %12, p,1,1;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15},"
      "{%16,%17,%18,%19}, %20, p,1,1;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      "{%64,%65,%66,%67}, %68, p,1,1;\n}\n"
      : "+f"(d[0]),"+f"(d[1]),"+f"(d[2]),"+f"(d[3]),"+f"(d[4]),"+f"(d[5]),
        "+f"(d[6]),"+f"(d[7]),"+f"(d[8]),"+f"(d[9]),"+f"(d[10]),"+f"(d[11]),
        "+f"(d[12]),"+f"(d[13]),"+f"(d[14]),"+f"(d[15]),"+f"(d[16]),
        "+f"(d[17]),"+f"(d[18]),"+f"(d[19]),"+f"(d[20]),"+f"(d[21]),
        "+f"(d[22]),"+f"(d[23]),"+f"(d[24]),"+f"(d[25]),"+f"(d[26]),
        "+f"(d[27]),"+f"(d[28]),"+f"(d[29]),"+f"(d[30]),"+f"(d[31]),
        "+f"(d[32]),"+f"(d[33]),"+f"(d[34]),"+f"(d[35]),"+f"(d[36]),
        "+f"(d[37]),"+f"(d[38]),"+f"(d[39]),"+f"(d[40]),"+f"(d[41]),
        "+f"(d[42]),"+f"(d[43]),"+f"(d[44]),"+f"(d[45]),"+f"(d[46]),
        "+f"(d[47]),"+f"(d[48]),"+f"(d[49]),"+f"(d[50]),"+f"(d[51]),
        "+f"(d[52]),"+f"(d[53]),"+f"(d[54]),"+f"(d[55]),"+f"(d[56]),
        "+f"(d[57]),"+f"(d[58]),"+f"(d[59]),"+f"(d[60]),"+f"(d[61]),
        "+f"(d[62]),"+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Tensor (TMA) copy of the 2-D box at (column c0, row c1) of the tensor
// `map` describes into shared memory, completing on `bar`'s transaction
// count with the box's full size (elements outside the tensor are zeros).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// The tensor map of an f32 (rows, d) row-major matrix (d % 4 == 0, 16-byte
// aligned) read in boxes of 32 columns x box_rows rows: each box lands as
// box_rows 128-byte rows, 128-byte-swizzled (16-byte chunk j of row r at
// chunk j ^ (r % 8); swz), so a thread's reads of its rows' chunks meet
// no bank conflicts. cuTensorMapEncodeTiled is looked up through the
// runtime's entry-point query, so nothing links against libcuda.
inline cudaError_t f32_rows_map(CUtensorMap* map, const float* ptr,
                                int64_t rows, int d, int box_rows) {
  static decltype(&cuTensorMapEncodeTiled) encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<decltype(&cuTensorMapEncodeTiled)>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Named barrier `id` (1-15) over `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// An f32 rounded to tf32, to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The memory column (within its 32-wide K block) of logical K position k
// of a 3xTF32 product whose A fragments come from decode_tf32: k-step s
// (8 deep) takes a thread's values 2 s (element 0, A column lane % 4) and
// 2 s + 1 (element 1, that + 4) of the eight at 8 (lane % 4). The B
// operand is written with the same permutation.
__host__ __device__ inline int tf32_col(int k) {
  const int s = k / 8, pos = k % 8;
  return 8 * (pos % 4) + 2 * s + pos / 4;
}

// One 32-wide K block of this thread's two f32 rows (r0 = 16 w + lane /
// 4 of the warpgroup's 64, and r0 + 8) as the tf32 hi and lo A fragments
// of the block's four k-steps (3xTF32: x = hi + lo, hi = rna(x), lo =
// rna(x - hi)). `box`: the block as tma_load_2d lands it (128-byte rows,
// swizzled); the thread's eight values are chunks 2 (lane % 4) and + 1 of
// each row. `live` false gives zeros (K past d).
__device__ __forceinline__ void decode_tf32(const uint8_t* box, int r0,
                                            int q, bool live,
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    float v[8];
    if (live) {
      const float4 x =
          *reinterpret_cast<const float4*>(box + swz(row, 2 * q));
      const float4 y =
          *reinterpret_cast<const float4*>(box + swz(row, 2 * q + 1));
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      v[4] = y.x, v[5] = y.y, v[6] = y.z, v[7] = y.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = v[2 * s + e];
        const uint32_t h = tf32_rna(x);
        hi[s][r + 2 * e] = h;
        lo[s][r + 2 * e] = tf32_rna(x - __uint_as_float(h));
      }
  }
}

}  // namespace hopper
}  // namespace c2v
