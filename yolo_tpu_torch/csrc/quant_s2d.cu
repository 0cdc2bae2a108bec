// Fused input quantize + space-to-depth stem front for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_tpu/serving/pallas_stem.py::_quant_s2d_kernel
// (entry quant_s2d_int8). For an (N, H, W, 3) image batch, uint8 or float32,
// NHWC, it writes the (N, H/2, W/2, 12) int8 input of the int8 engine's
// space-to-depth 4x4 stem conv:
//
//   out[n, I, J, (p*2 + q)*3 + c] = clip(rint(norm(x[n, 2I+p, 2J+q, c]) / s), -127, 127)
//
// where norm(u) = u * scale_c + bias_c (ImageNet normalization) for uint8
// input and the identity for float input, and s = s_img, the calibrated input
// scale, read from device memory (no host sync for it).
//
// Numerics: the multiply, the add and the divide are IEEE round-to-nearest
// (__fmul_rn, __fadd_rn, __fdiv_rn), so nvcc cannot contract them into an FMA
// or a reciprocal multiply, and rint rounds half to even. The result equals
// the eager torch twin (device_normalize, then "/ s_img" by a tensor, round,
// clamp, the s2d reshape) bit for bit.
//
// What bounds it: device memory. Per 448x448 image it reads 602 KB (uint8)
// or 2.4 MB (float32) and writes 602 KB; a few flops per byte. The TPU
// kernel's batch-in-lanes view is an XLA:TPU layout fact and is not needed
// here. Design: one thread per output pixel; it reads the 2x2x3 input values
// (two 6- or 24-byte runs) and writes its 12 contiguous output bytes as three
// 4-byte stores. Neighbouring threads handle neighbouring output pixels, so
// both the reads and the writes of a warp are contiguous.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

template <bool kU8>
__global__ void quant_s2d_kernel(const void* __restrict__ x, const float* __restrict__ s_img,
                                 uint32_t* __restrict__ out, long long pixels, int H, int W,
                                 float sc0, float sc1, float sc2, float b0, float b1,
                                 float b2) {
  const long long pix = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pix >= pixels) return;
  const int Wo = W / 2, Ho = H / 2;
  const int J = static_cast<int>(pix % Wo);
  const long long rest = pix / Wo;
  const int I = static_cast<int>(rest % Ho);
  const long long n = rest / Ho;
  const float s = *s_img;
  const float scale[3] = {sc0, sc1, sc2};
  const float bias[3] = {b0, b1, b2};

  int8_t q[12];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const long long row = ((n * H + (2 * I + p)) * W + 2 * J) * 3;
#pragma unroll
    for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v;
        if constexpr (kU8) {
          const float u = static_cast<float>(static_cast<const uint8_t*>(x)[row + qq * 3 + c]);
          v = __fadd_rn(__fmul_rn(u, scale[c]), bias[c]);
        } else {
          v = static_cast<const float*>(x)[row + qq * 3 + c];
        }
        q[(p * 2 + qq) * 3 + c] = quantize(v, s);
      }
    }
  }
  uint32_t* dst = out + pix * 3;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    dst[w] = static_cast<uint32_t>(static_cast<uint8_t>(q[4 * w])) |
             (static_cast<uint32_t>(static_cast<uint8_t>(q[4 * w + 1])) << 8) |
             (static_cast<uint32_t>(static_cast<uint8_t>(q[4 * w + 2])) << 16) |
             (static_cast<uint32_t>(static_cast<uint8_t>(q[4 * w + 3])) << 24);
  }
}

}  // namespace

extern "C" {

// x: (N, H, W, 3) uint8 (is_u8 = 1) or float32, contiguous; s_img: one
// float32 on the device; out: (N, H/2, W/2, 12) int8, contiguous. norm: the
// three per-channel scales, then the three biases (read only for uint8).
// Returns a cudaError_t: cudaErrorInvalidValue for odd H or W, else the
// launch's status.
int yolo_quant_s2d(const void* x, int is_u8, const void* s_img, void* out, int N, int H, int W,
                   float sc0, float sc1, float sc2, float b0, float b1, float b2,
                   void* stream) {
  if (N < 0 || H < 0 || W < 0 || H % 2 || W % 2) return cudaErrorInvalidValue;
  const long long pixels = static_cast<long long>(N) * (H / 2) * (W / 2);
  if (pixels == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((pixels + kThreads - 1) / kThreads);
  auto* s = static_cast<const float*>(s_img);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_u8) {
    quant_s2d_kernel<true><<<blocks, kThreads, 0, st>>>(x, s, o, pixels, H, W, sc0, sc1, sc2,
                                                        b0, b1, b2);
  } else {
    quant_s2d_kernel<false><<<blocks, kThreads, 0, st>>>(x, s, o, pixels, H, W, sc0, sc1, sc2,
                                                         b0, b1, b2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
