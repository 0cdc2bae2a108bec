// Device helpers shared by the bf16 kernels (bf16_conv_stats.cu,
// bf16_bottleneck.cu): 16-byte cp.async, ldmatrix, the bf16 tensor-core
// product with float32 accumulators, and round-to-nearest-even bf16 packing.
//
// Shared tiles hold rows of K-contiguous bf16 values, 64 bytes (32 values)
// of K per pipeline stage. The m16n8k16 fragments are loaded with ldmatrix
// x4: for A (16 rows x 16 K) lane l points at row l % 16, 16 bytes on for
// l >= 16; for B (two 8-channel tiles x 16 K, stored as rows of output
// channels) lane l points at channel b_lane_row(l), byte b_lane_byte(l).
// Every row address must be 16-byte aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int bytes = ok ? 16 : 0;  // 0: the 16 shared bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Four 8x8 b16 matrices; lane l supplies a row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// A: the byte offset of lane l inside its row (row l % 16 of the tile).
__device__ __forceinline__ int a_lane_byte(int lane) { return (lane / 16) * 16; }
// B: the channel row and byte of lane l, so that ldmatrix_x4 returns b0, b1
// of the first 8-channel tile, then b0, b1 of the second.
__device__ __forceinline__ int b_lane_row(int lane) { return (lane % 8) + (lane / 16) * 8; }
__device__ __forceinline__ int b_lane_byte(int lane) { return ((lane / 8) % 2) * 16; }

// c += a (16x16, row-major) * b (16x8, column-major), bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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
