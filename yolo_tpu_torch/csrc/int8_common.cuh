// Device helpers shared by the int8 serving kernels: 16-byte cp.async and
// the mma.sync s8 product (int8_bottleneck.cu; the mainloops of int8_conv.cu
// and of int8_wino.cu's tap GEMM are sm90_conv_core.cuh's wgmma), q8 and
// the requant epilogue of all of them, rounded in the op order of
// yolo_tpu/serving/engine.py::_requant so that the kernels equal their eager
// twins bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { kRelu = 0, kNone = 1, kResidual = 2, kLeaky = 3, kFloat = 4, kAcc = 5 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;  // 0: the 16 shared bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// c += a (16x32, row-major) * b (32x8, column-major), s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// q(v) = clip(rint(v), -127, 127) as int8 (rint: half to even).
__device__ __forceinline__ int8_t q8(float v) {
  float r = rintf(v);
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// One int8 result of the requant epilogue (modes kRelu .. kLeaky):
// y = acc * m + t (two roundings, no FMA), then + res * r for kResidual.
__device__ __forceinline__ int8_t requant(int acc, float m, float t, int mode, float res,
                                          float r) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), m), t);
  if (mode == kResidual) y = __fadd_rn(y, __fmul_rn(res, r));
  if (mode == kLeaky) {
    y = y > 0.0f ? y : __fmul_rn(y, 0.1f);
  } else if (mode != kNone) {
    y = fmaxf(y, 0.0f);
  }
  return q8(y);
}

// Two neighbouring int8 values as one 16-bit store.
__device__ __forceinline__ uint16_t pack2(int8_t lo, int8_t hi) {
  return static_cast<uint16_t>(static_cast<uint8_t>(lo)) |
         static_cast<uint16_t>(static_cast<uint16_t>(static_cast<uint8_t>(hi)) << 8);
}

}  // namespace
