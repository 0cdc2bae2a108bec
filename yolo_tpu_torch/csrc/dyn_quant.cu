// Dynamic per-tensor int8 quantize of a float32 activation for Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's _Int8ConvCore (yolo_tpu/models/layers.py)
// quantizes its input with plain jnp, which XLA fuses. The port's eager
// version (serving/cuda_dynq.py::quantize_reference) is six separate passes
// (abs, amax, divide, round, clamp, int8 cast) moving 41 bytes an element;
// this pair moves 9. For the n float32 values of x (Int8Conv2d's NHWC input,
// taken as one flat array):
//
//   amax = max |x|
//   s    = max(amax / 127, 1e-8)
//   q[i] = clip(rint(x[i] / s), -127, 127) as int8
//
// Numerics: both divisions are IEEE round-to-nearest (__fdiv_rn, never a
// reciprocal multiply) and rint rounds half to even, as torch's true
// division and torch.round do; a max is exact in any order. So for finite
// input q and s equal the eager twin's bit for bit, and the result does not
// depend on the grid.
//
// What bounds it: device memory, 4 bytes an element read twice and 1 byte
// written (9 bytes; the 24-conv model's inputs at batch 64 are 4.80 GB, 1.43
// ms at 3.35 TB/s). A reduction across blocks needs a second pass, so:
//   * dynq_absmax: a grid the wrapper sizes from n (one block per 4096
//     elements, capped at 4 resident blocks a SM, 528) walks x in tiles of
//     1024 elements, four 16-byte loads in flight a thread; each block writes
//     one partial max. No atomics and no memset: deterministic, and one graph
//     node a pass;
//   * dynq_quantize: each block reduces the partials (L2-resident, at most
//     2 KB) to amax and s, then quantizes its tiles: a float4 in, a char4
//     out. Block 0 writes s.
// The absmax pass walks the tiles from the end, the quantize pass from the
// start: the producer of x wrote it front to back, so its last tiles are
// still in the 50 MB L2 when the first pass starts, and the first pass's
// last tiles (x's first) are when the second starts. The n % 4 tail is
// scalar; a view that is not 16-byte aligned takes a scalar path with the
// same values.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;        // float4 loads in flight a thread
constexpr int kBlocksPerSM = 4;   // the wrapper's grid cap is this times the 132 SMs
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float abs_max4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// The block's max, returned to every thread.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_max[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, warp_max[w]);
  return v;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// A step of the vector loop takes tiles k, k + G, k + 2G and k + 3G of
// kThreads float4 each (G = gridDim.x): four 16-byte loads in flight a
// thread, neighbouring threads on neighbouring addresses, and blocks whose
// shares differ by at most one tile.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dynq_absmax(const float* __restrict__ x, long long n, float* __restrict__ partials) {
  float m = 0.0f;
  if constexpr (kVec) {
    const auto* v = reinterpret_cast<const float4*>(x);
    const long long nv = n / 4, tiles = (nv + kThreads - 1) / kThreads;
    for (long long k = blockIdx.x; k < tiles; k += kUnroll * gridDim.x) {
      float4 a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long t = k + static_cast<long long>(u) * gridDim.x;
        const long long i = (tiles - 1 - t) * kThreads + threadIdx.x;  // from the end
        a[u] = t < tiles && i < nv ? __ldg(v + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m = fmaxf(m, abs_max4(a[u]));
    }
    if (blockIdx.x == 0 && threadIdx.x < n % 4) m = fmaxf(m, fabsf(x[4 * nv + threadIdx.x]));
  } else {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride) {
      m = fmaxf(m, fabsf(x[i]));
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0) partials[blockIdx.x] = m;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    dynq_quantize(const float* __restrict__ x, long long n, const float* __restrict__ partials,
                  int num_partials, int8_t* __restrict__ q, float* __restrict__ scale) {
  float m = 0.0f;
  for (int i = threadIdx.x; i < num_partials; i += kThreads) m = fmaxf(m, partials[i]);
  m = block_max(m);
  const float s = fmaxf(__fdiv_rn(m, 127.0f), 1e-8f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = s;
  if constexpr (kVec) {
    const auto* v = reinterpret_cast<const float4*>(x);
    auto* out = reinterpret_cast<char4*>(q);
    const long long nv = n / 4, tiles = (nv + kThreads - 1) / kThreads;
    for (long long k = blockIdx.x; k < tiles; k += kUnroll * gridDim.x) {
      float4 a[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = (k + static_cast<long long>(u) * gridDim.x) * kThreads + threadIdx.x;
        if (i < nv) a[u] = __ldg(v + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = (k + static_cast<long long>(u) * gridDim.x) * kThreads + threadIdx.x;
        if (i < nv) {
          out[i] = make_char4(quantize(a[u].x, s), quantize(a[u].y, s), quantize(a[u].z, s),
                              quantize(a[u].w, s));
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < n % 4) {
      const long long i = 4 * nv + threadIdx.x;
      q[i] = quantize(x[i], s);
    }
  } else {
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
         i += stride) {
      q[i] = quantize(x[i], s);
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* x, long long n, int8_t* q, float* buf, int blocks,
                   cudaStream_t st) {
  dynq_absmax<kVec><<<blocks, kThreads, 0, st>>>(x, n, buf + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dynq_quantize<kVec><<<blocks, kThreads, 0, st>>>(x, n, buf + 1, blocks, q, buf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: n float32 on the device; q: n int8, 4-byte aligned; buf: 1 + blocks
// float32 scratch, buf[0] receives s and buf[1..blocks] the partial maxima.
// Two launches of `blocks` blocks on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for n < 1, blocks outside [1, 65535] or a q not
// 4-byte aligned, else the launches' status.
int yolo_dynq(const void* x, long long n, void* q, void* buf, int blocks, void* stream) {
  if (n < 1 || blocks < 1 || blocks > 65535 || (reinterpret_cast<uintptr_t>(q) & 3) != 0) {
    return cudaErrorInvalidValue;
  }
  const auto* xf = static_cast<const float*>(x);
  auto* qi = static_cast<int8_t*>(q);
  auto* b = static_cast<float*>(buf);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  return static_cast<int>(vec ? launch<true>(xf, n, qi, b, blocks, st)
                              : launch<false>(xf, n, qi, b, blocks, st));
}

}  // extern "C"
