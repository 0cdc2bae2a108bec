// The fused Adam + L2 parameter update, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/opt_update_microbench.py::_adam_kernel
// (entry pallas_update): per element, with the four scalars s (the global
// gradient-clip scale), c1 = 1/(1 - b1^t), c2 = 1/(1 - b2^t) and lr,
//   g  = g * s + WD * p
//   m  = B1 * m + (1 - B1) * g
//   v  = B2 * v + ((1 - B2) * g) * g
//   p  = p - (lr * (m * c1)) / (sqrt(v * c2) + EPS)
// in that op order, every step rounded on its own (__f*_rn: nvcc may not
// contract a multiply into an add), so the kernel equals its eager torch
// twin (yolo_tpu_torch/experiments/opt_update_microbench.py::plain_update)
// bit for bit. p, m and v are updated in place, as the TPU kernel's
// input_output_aliases did. The scalars are read from a (4,) float32 tensor
// on the device, so a clip scale computed on the card needs no host sync.
//
// What bounds it: device memory. Per element it reads p, m, v, g and writes
// p, m, v: 28 bytes for ~20 flops, far below the H100's ~20 flops a byte.
// At fc1's (50176, 4096) that is 5.75 GB, 1.72 ms at 3.35 TB/s. Design: a
// grid-stride loop of 16-byte vectors (four float4 loads in flight per
// thread and iteration), a scalar loop for the n % 4 tail, the scalars in
// registers. Not done: streaming cache hints, more vectors per iteration.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f, kWD = 5e-4f;
// 1 - B1 and 1 - B2 taken in double and rounded once, as Python does before
// the float32 multiply.
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);

struct Scalars {
  float s, c1, c2, lr;
};

__device__ __forceinline__ void adam_step(float& p, float& m, float& v, float g,
                                          const Scalars& k) {
  g = __fadd_rn(__fmul_rn(g, k.s), __fmul_rn(kWD, p));
  m = __fadd_rn(__fmul_rn(kB1, m), __fmul_rn(kOneMinusB1, g));
  v = __fadd_rn(__fmul_rn(kB2, v), __fmul_rn(__fmul_rn(kOneMinusB2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.c2)), kEps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(k.lr, __fmul_rn(m, k.c1)), den));
}

__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
                       const float* __restrict__ g, const float* __restrict__ scalars,
                       long long n) {
  const Scalars k{scalars[0], scalars[1], scalars[2], scalars[3]};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = first; i < n4; i += stride) {
    float4 pv = p4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    adam_step(pv.x, mv.x, vv.x, gv.x, k);
    adam_step(pv.y, mv.y, vv.y, gv.y, k);
    adam_step(pv.z, mv.z, vv.z, gv.z, k);
    adam_step(pv.w, mv.w, vv.w, gv.w, k);
    p4[i] = pv;
    m4[i] = mv;
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) adam_step(p[i], m[i], v[i], g[i], k);
}

}  // namespace

extern "C" {

// p, m, v (updated in place) and g: n contiguous float32 each, 16-byte
// aligned; scalars: (4,) float32 on the device = s, c1, c2, lr. One launch
// of at most 8 blocks of 256 threads per SM. Returns a cudaError_t:
// cudaErrorInvalidValue for n < 0 or a missing pointer, else the launch's
// status.
int yolo_adam_update(void* p, void* m, void* v, const void* g, const void* scalars,
                     long long n, void* stream) {
  if (n < 0 || !p || !m || !v || !g || !scalars) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long want = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  adam_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(scalars), n);
  return cudaGetLastError();
}

}  // extern "C"
