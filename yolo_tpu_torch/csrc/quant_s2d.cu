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
// or 2.4 MB (float32) and writes 602 KB. The first design (one thread an
// output pixel: 12 one-byte loads, 12 IEEE divisions, three 4-byte stores)
// reached 35-40% of the byte bound at batch 16-256 uint8 on an H100 80GB HBM3
// at 700 W. For uint8 input the result depends only on (channel, byte): 768
// values. So:
//   * uint8: each block first builds that 3 x 256 int8 table in shared memory
//     with exactly the arithmetic above (three divisions a thread); after it
//     the kernel only looks up and moves bytes. The loop is grid-stride, so a
//     block builds its table once for all the units it takes;
//   * a thread's unit is 4 output pixels along W: two input rows of 24 bytes
//     (three 8-byte loads each; float32: six 16-byte loads each) and 48
//     output bytes. Output pixel j of the unit is row 0's bytes 6j..6j+5 then
//     row 1's, so the shuffle is fixed at compile time;
//   * a warp takes 32 consecutive units. Where all 32 are whole, aligned for
//     the vector loads and their 1536 output bytes contiguous (W/2 a multiple
//     of 4, as at 448x448), the bytes go through shared memory, so that each
//     16-byte store instruction writes 512 contiguous bytes. Otherwise (a
//     ragged row, a misaligned view, the batch's last partial warp) each unit
//     takes a byte-wise path with the same values;
//   * float32 input keeps its division a value, which must stay exact, and
//     converts a row at a time (24 floats live, not 48).
// The grid holds one unit a thread (a grid capped at one resident wave, each
// block building its table once for ~12 units, timed slower on the card: a
// thread's next loads wait for its previous unit). Measured times sit in
// PERF.md (chip_smoke.py phase 11): 0.0062-0.0069 ms at batch 16 uint8,
// 83-92% of the byte bound, on an H100 80GB HBM3 at 700 W.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;  // output pixels a unit, along W
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == 256, "the uint8 table takes one byte value a thread");

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

struct Norm {
  float scale[3], bias[3];
};

// Where a unit's data lives: the first element of its two input rows, its
// first output byte, its output pixel count (<= kPix) and whether the vector
// path takes it.
struct Unit {
  long long in0, in1, out;
  int pixels;
  bool vec;
};

template <bool kU8>
__device__ __forceinline__ Unit locate(unsigned u, unsigned units_per_row, int W, int Wo,
                                       const void* x, const uint8_t* out) {
  const unsigned row = u / units_per_row;  // n * Ho + I
  const int J0 = static_cast<int>(u - row * units_per_row) * kPix;
  Unit t;
  // Image n's input rows 2I and 2I + 1 are rows 2 * (n * Ho + I) + p of the batch.
  t.in0 = (2LL * row * W + 2 * J0) * 3;
  t.in1 = t.in0 + static_cast<long long>(W) * 3;
  t.out = (static_cast<long long>(row) * Wo + J0) * 12;
  t.pixels = min(kPix, Wo - J0);
  const size_t esize = kU8 ? 1 : 4, align = kU8 ? 8 : 16;
  const auto* xb = static_cast<const unsigned char*>(x);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(xb + t.in0 * esize) |
                         reinterpret_cast<uintptr_t>(xb + t.in1 * esize);
  t.vec = t.pixels == kPix && (addr & (align - 1)) == 0 &&
          (reinterpret_cast<uintptr_t>(out + t.out) & 15) == 0;
  return t;
}

template <bool kU8>
__global__ void __launch_bounds__(kThreads)
quant_s2d_kernel(const void* __restrict__ x, const float* __restrict__ s_img,
                 uint8_t* __restrict__ out, unsigned units, unsigned units_per_row, int W,
                 int Wo, Norm norm) {
  __shared__ int8_t lut[3 * 256];
  __shared__ uint4 stage[kWarps][3 * 32];
  const float s = *s_img;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kU8) {
    // 256 threads, one byte value each, three channels.
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float val = __fadd_rn(__fmul_rn(static_cast<float>(threadIdx.x), norm.scale[c]),
                                  norm.bias[c]);
      lut[c * 256 + threadIdx.x] = quantize(val, s);
    }
    __syncthreads();
  }
  // A warp takes 32 consecutive units an iteration, so the loop and the
  // shuffles below stay warp-uniform.
  for (unsigned wu = (blockIdx.x * kWarps + warp) * 32u; wu < units; wu += gridDim.x * kThreads) {
    const unsigned u = wu + lane;
    Unit t{};
    if (u < units) t = locate<kU8>(u, units_per_row, W, Wo, x, out);
    const long long out0 = __shfl_sync(kFull, t.out, 0);
    if (__all_sync(kFull, t.vec && t.out == out0 + 48LL * lane)) {
      // Output byte o of the unit: pixel j = o / 12, row p = (o % 12) / 6,
      // and element e = 6j + (o % 6) of that row, channel e % 3.
      uint32_t words[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) words[k] = 0u;
      if constexpr (kU8) {
        uint32_t r[2][6];  // both rows' 24 bytes
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const auto* src = reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(x) +
                                                           (p ? t.in1 : t.in0));
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const uint2 w = __ldg(src + k);
            r[p][2 * k] = w.x;
            r[p][2 * k + 1] = w.y;
          }
        }
#pragma unroll
        for (int o = 0; o < 48; ++o) {
          const int p = (o % 12) / 6, e = 6 * (o / 12) + o % 6;
          const uint32_t byte = (r[p][e >> 2] >> (8 * (e & 3))) & 0xffu;
          words[o >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(lut[(e % 3) * 256 + byte]))
                           << (8 * (o & 3));
        }
      } else {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[24];
          const auto* src = reinterpret_cast<const uint4*>(static_cast<const float*>(x) +
                                                           (p ? t.in1 : t.in0));
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            const uint4 w = __ldg(src + k);
            r[4 * k] = w.x;
            r[4 * k + 1] = w.y;
            r[4 * k + 2] = w.z;
            r[4 * k + 3] = w.w;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 6; ++e) {
              const int o = 12 * j + 6 * p + e;
              words[o >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                                   quantize(__uint_as_float(r[6 * j + e]), s))) << (8 * (o & 3));
            }
          }
        }
      }
      // The warp's 1536 output bytes are contiguous: through shared memory,
      // so that each 16-byte store instruction writes 512 contiguous bytes.
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        stage[warp][3 * lane + k] =
            make_uint4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
      }
      __syncwarp();
      auto* dst = reinterpret_cast<uint4*>(out + out0);
#pragma unroll
      for (int k = 0; k < 3; ++k) dst[32 * k + lane] = stage[warp][32 * k + lane];
      __syncwarp();
    } else if (u < units) {
      // The same values a byte at a time.
      for (int j = 0; j < t.pixels; ++j) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int e = 0; e < 6; ++e) {
            const long long at = (p ? t.in1 : t.in0) + 6 * j + e;
            int8_t q;
            if constexpr (kU8) {
              q = lut[(e % 3) * 256 + static_cast<const uint8_t*>(x)[at]];
            } else {
              q = quantize(static_cast<const float*>(x)[at], s);
            }
            out[t.out + 12 * j + 6 * p + e] = static_cast<uint8_t>(q);
          }
        }
      }
    }
  }
}

template <bool kU8>
cudaError_t launch(const void* x, const float* s, uint8_t* out, unsigned units,
                   unsigned units_per_row, int W, int Wo, const Norm& norm, cudaStream_t st) {
  const unsigned blocks = (units + kThreads - 1) / kThreads;
  quant_s2d_kernel<kU8><<<blocks, kThreads, 0, st>>>(x, s, out, units, units_per_row, W, Wo,
                                                     norm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, H, W, 3) uint8 (is_u8 = 1) or float32, contiguous; s_img: one
// float32 on the device; out: (N, H/2, W/2, 12) int8, contiguous. norm: the
// three per-channel scales, then the three biases (read only for uint8).
// Returns a cudaError_t: cudaErrorInvalidValue for odd H or W or more than
// 2^31 - 1 units of 4 output pixels, else the launch's status.
int yolo_quant_s2d(const void* x, int is_u8, const void* s_img, void* out, int N, int H, int W,
                   float sc0, float sc1, float sc2, float b0, float b1, float b2,
                   void* stream) {
  if (N < 0 || H < 0 || W < 0 || H % 2 || W % 2) return cudaErrorInvalidValue;
  const int Wo = W / 2;
  const long long per_row = (Wo + kPix - 1) / kPix;
  const long long units = static_cast<long long>(N) * (H / 2) * per_row;
  if (units == 0) return cudaSuccess;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;  // wu + stride stays in 32 bits
  const Norm norm{{sc0, sc1, sc2}, {b0, b1, b2}};
  auto* s = static_cast<const float*>(s_img);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<unsigned>(units), r = static_cast<unsigned>(per_row);
  return static_cast<int>(is_u8 ? launch<true>(x, s, o, n, r, W, Wo, norm, st)
                                : launch<false>(x, s, o, n, r, W, Wo, norm, st));
}

}  // extern "C"
