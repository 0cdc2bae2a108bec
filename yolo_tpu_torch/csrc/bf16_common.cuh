// Device helpers of the bf16 kernels (bf16_conv_stats.cu, bf16_bottleneck.cu;
// their mainloops are wgmma, from sm90_conv_core.cuh and
// sm90_bottleneck_tile.cuh): round-to-nearest-even bf16 packing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Two float32 values rounded to nearest-even bf16, lo at the lower address.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16x2(unsigned v) {
  __nv_bfloat162 b;
  *reinterpret_cast<unsigned*>(&b) = v;
  return __bfloat1622float2(b);
}

}  // namespace
