// Device helpers shared by the int8 serving kernels (int8_conv.cu,
// int8_wino.cu, int8_bottleneck.cu; their mainloops are wgmma, from
// sm90_conv_core.cuh and sm90_bottleneck_tile.cuh): q8 and the requant
// epilogue of all of them, rounded in the op order of
// yolo_tpu/serving/engine.py::_requant so that the kernels equal their eager
// twins bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum Mode { kRelu = 0, kNone = 1, kResidual = 2, kLeaky = 3, kFloat = 4, kAcc = 5 };

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
