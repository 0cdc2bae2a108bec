// Train-mode BatchNorm(+residual)+ReLU, forward and backward, for Hopper (sm_90a).
//
// Replaces the four TPU kernels of yolo_tpu/ops/fused_bn.py:
//   bn_stats     (_stats_kernel :98)           -> yolo_bn_stats
//   bn_normalize (_norm_kernel :155,
//                 _norm_res_kernel :162)       -> yolo_bn_normalize
//   _bwd_reduce  (_bwd_reduce_kernel :222)     -> yolo_bn_bwd_reduce
//   _bwd_dx      (_bwd_dx_kernel :256,
//                 _bwd_dx_res_kernel :269)     -> yolo_bn_bwd_dx
// The per-channel arithmetic between them (rsqrt, the folded scale and
// shift, the backward's A/B/D coefficients, the running statistics) stays
// in torch on C-length vectors (yolo_tpu_torch/ops/fused_bn.py).
//
// Layout: an activation is (M, C) row-major with C contiguous, M = N*H*W:
// a channels_last NCHW tensor viewed without a copy. The TPU kernels' cmin/
// nmin views exist only for XLA:TPU layouts and are not needed here.
//
// What bounds them: all four stream activations once and do a few flops per
// element, so they are bound by device memory (3.35 TB/s on an H100 SXM).
// Bytes moved per element of the (M, C) activation, e = 4 (f32) or 2 (bf16):
//   stats       1 read                              =  e
//   normalize   1 read (+1 residual) + 1 write      = 2e (3e)
//   bwd_reduce  g, x (+ out for the ReLU mask)      = 2e (3e)
//   bwd_dx      g, x (+ out) + dx (+ dres)          = 3e (4e, 5e)
// What the design does about it:
//   * every thread moves 16 bytes per load and store (float4, or 8 bf16 in a
//     uint4), and neighbouring threads touch neighbouring addresses along C;
//   * a block is (TX channel vectors) x (TY rows), 256 threads; a thread
//     keeps one channel vector for its whole life, so its per-channel
//     scalars are read once into registers, and it walks rows with a stride
//     of gridDim.y * TY;
//   * reductions run in two passes without atomics: each block sums its
//     rows in registers and then across TY in shared memory, in a fixed
//     order, and writes a (G, 2, C) float32 partial; a second small kernel
//     sums the G partials per channel, again in a fixed order. The grid
//     depends only on (M, C, dtype), so a result is the same from run to run.
// Statistics and scalars are float32; activations float32 or bfloat16.
//
// Numerics, against the JAX kernels:
//   * sums are taken in another order, and nvcc contracts x*mul+add and
//     A*gz - (B*x - D) into FMAs: results agree to float tolerance, not bits;
//   * with a residual, the normalized value is rounded to the activation
//     type BEFORE the residual add, and the sum rounded again, as
//     _norm_res_kernel does (the unfused graph's bn3(out) + identity);
//   * the ReLU masks compare the stored output with 0 exactly (out > 0).
// Indices are 64-bit: at batch 256 the 448x448 stem holds 822M elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTx = 32;
constexpr int kFinalizeStrands = 8;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

// The value a float takes once stored as T (round to nearest even).
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ReLU that keeps NaN, like jnp.maximum and torch.relu.
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// Per-channel f32 scalars of this thread's channel vector: row k of (K, C).
template <int V>
__device__ __forceinline__ void load_scalars(const float* scal, int C, int k, int64_t c0,
                                             float (&s)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = scal[static_cast<int64_t>(k) * C + c0 + i];
}

// Sum each thread's (a, b) vectors over threadIdx.y in a fixed order and
// write the block's partials to ws[(blockIdx.y, 0|1, channel)].
template <int V>
__device__ __forceinline__ void block_partials(const float (&a)[V], const float (&b)[V],
                                               float* __restrict__ ws, int C) {
  __shared__ float sa[kThreads * 8];
  __shared__ float sb[kThreads * 8];
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x, TY = blockDim.y;
  const int base = (ty * TX + tx) * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sa[base + i] = a[i];
    sb[base + i] = b[i];
  }
  __syncthreads();
  const int width = TX * V;  // channels this block covers
  const int64_t c_first = static_cast<int64_t>(blockIdx.x) * width;
  for (int o = ty * TX + tx; o < width; o += TX * TY) {
    float A = 0.f, B = 0.f;
    for (int y = 0; y < TY; ++y) {
      A += sa[y * width + o];
      B += sb[y * width + o];
    }
    const int64_t c = c_first + o;
    if (c < C) {
      ws[(static_cast<int64_t>(blockIdx.y) * 2) * C + c] = A;
      ws[(static_cast<int64_t>(blockIdx.y) * 2 + 1) * C + c] = B;
    }
  }
}

// ---------------------------------------------------------------- pass 1s
// Per-block partial [sum x, sum x^2] (the body of _stats_kernel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ x, float* __restrict__ ws, int64_t M, int C) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (cv < CV) {
    const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
    for (int64_t r = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; r < M;
         r += stride) {
      float v[V];
      load(x + r * C + static_cast<int64_t>(cv) * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] += v[i] * v[i];
      }
    }
  }
  block_partials<V>(s, q, ws, C);
}

// Per-block partial [sum gz, sum gz*xhat], gz = g*(out > 0) under ReLU,
// xhat = x*r + (-mean*r) (the body of _bwd_reduce_kernel).
template <typename T, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_partial(const T* __restrict__ g, const T* __restrict__ out,
                   const T* __restrict__ x, const float* __restrict__ scal,
                   float* __restrict__ ws, int64_t M, int C) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
  if (cv < CV) {
    const int64_t c0 = static_cast<int64_t>(cv) * V;
    float r[V], nmr[V];
    load_scalars<V>(scal, C, 0, c0, r);
    load_scalars<V>(scal, C, 1, c0, nmr);
    const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
    for (int64_t row = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; row < M;
         row += stride) {
      const int64_t off = row * C + c0;
      float gv[V], xv[V];
      load(g + off, gv);
      load(x + off, xv);
      if (RELU) {
        float ov[V];
        load(out + off, ov);
#pragma unroll
        for (int i = 0; i < V; ++i) gv[i] = ov[i] > 0.f ? gv[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xh = xv[i] * r[i] + nmr[i];
        s[i] += gv[i];
        q[i] += gv[i] * xh;
      }
    }
  }
  block_partials<V>(s, q, ws, C);
}

// ---------------------------------------------------------------- pass 2
// Sum the G partials of each channel in a fixed order. MEAN_VAR: write
// mean = sum/M and var = max(0, sumsq/M - mean^2) (fused_bn.py:136-139);
// otherwise the two sums as they are.
template <bool MEAN_VAR>
__global__ void __launch_bounds__(kMaxTx * kFinalizeStrands)
finalize(const float* __restrict__ ws, float* __restrict__ out, int G, int C, int64_t M) {
  __shared__ float sa[kFinalizeStrands][kMaxTx];
  __shared__ float sb[kFinalizeStrands][kMaxTx];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kMaxTx + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int gi = ty; gi < G; gi += kFinalizeStrands) {
      a += ws[(static_cast<int64_t>(gi) * 2) * C + c];
      b += ws[(static_cast<int64_t>(gi) * 2 + 1) * C + c];
    }
  }
  sa[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    float A = 0.f, B = 0.f;
#pragma unroll
    for (int y = 0; y < kFinalizeStrands; ++y) {
      A += sa[y][tx];
      B += sb[y][tx];
    }
    if (MEAN_VAR) {
      const float count = static_cast<float>(M);
      const float mean = A / count;
      const float var = B / count - mean * mean;
      out[c] = mean;
      out[C + c] = var > 0.f ? var : 0.f;
    } else {
      out[c] = A;
      out[C + c] = B;
    }
  }
}

// ------------------------------------------------------------ elementwise
// y = relu?(x*mul + add), or with a residual relu?(T(T(x*mul + add) + res))
// (_norm_kernel / _norm_res_kernel). scal is (2, C): mul, add.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
normalize(const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ scal,
          T* __restrict__ y, int64_t M, int C) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  if (cv >= CV) return;
  const int64_t c0 = static_cast<int64_t>(cv) * V;
  float mul[V], add[V];
  load_scalars<V>(scal, C, 0, c0, mul);
  load_scalars<V>(scal, C, 1, c0, add);
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t row = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; row < M;
       row += stride) {
    const int64_t off = row * C + c0;
    float v[V];
    load(x + off, v);
    if (RES) {
      float rv[V];
      load(res + off, rv);
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = round_to(round_to(v[i] * mul[i] + add[i], T()) + rv[i], T());
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = v[i] * mul[i] + add[i];
    }
    if (RELU) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = relu(v[i]);
    }
    store(y + off, v);
  }
}

// dx = A*gz - (B*x - D), gz = g*(out > 0) under ReLU; dres = gz
// (_bwd_dx_kernel / _bwd_dx_res_kernel). scal is (3, C): A, B, -D.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_dx(const T* __restrict__ g, const T* __restrict__ out, const T* __restrict__ x,
       const float* __restrict__ scal, T* __restrict__ dx, T* __restrict__ dres, int64_t M,
       int C) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const int cv = blockIdx.x * blockDim.x + threadIdx.x;
  if (cv >= CV) return;
  const int64_t c0 = static_cast<int64_t>(cv) * V;
  float a[V], b[V], nd[V];
  load_scalars<V>(scal, C, 0, c0, a);
  load_scalars<V>(scal, C, 1, c0, b);
  load_scalars<V>(scal, C, 2, c0, nd);
  const int64_t stride = static_cast<int64_t>(gridDim.y) * blockDim.y;
  for (int64_t row = static_cast<int64_t>(blockIdx.y) * blockDim.y + threadIdx.y; row < M;
       row += stride) {
    const int64_t off = row * C + c0;
    float gv[V], xv[V];
    load(g + off, gv);
    load(x + off, xv);
    if (RELU) {
      float ov[V];
      load(out + off, ov);
#pragma unroll
      for (int i = 0; i < V; ++i) gv[i] = ov[i] > 0.f ? gv[i] : 0.f;
    }
    if (RES) store(dres + off, gv);
    float d[V];
#pragma unroll
    for (int i = 0; i < V; ++i) d[i] = a[i] * gv[i] - (xv[i] * b[i] + nd[i]);
    store(dx + off, d);
  }
}

// ------------------------------------------------------------ launchers
struct Grid {
  dim3 grid, block;
};

// Blocks of (TX channel vectors) x (TY rows); G row groups.
template <typename T>
Grid make_grid(int C, int G) {
  const int CV = C / Vec<T>::N;
  const int tx = CV < kMaxTx ? CV : kMaxTx;
  const int ty = kThreads / tx;
  return {dim3((CV + tx - 1) / tx, G), dim3(tx, ty)};
}

bool bad_shape(int64_t M, int C, int G, int vec) {
  return M < 1 || C < vec || C % vec != 0 || G < 1 || G > 65535;
}

template <bool MEAN_VAR>
cudaError_t launch_finalize(const float* ws, float* out, int G, int C, int64_t M,
                            cudaStream_t st) {
  finalize<MEAN_VAR><<<(C + kMaxTx - 1) / kMaxTx, dim3(kMaxTx, kFinalizeStrands), 0, st>>>(
      ws, out, G, C, M);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats(const void* x, void* ws, void* out, int64_t M, int C, int G,
                  cudaStream_t st) {
  const Grid g = make_grid<T>(C, G);
  stats_partial<T><<<g.grid, g.block, 0, st>>>(static_cast<const T*>(x),
                                                static_cast<float*>(ws), M, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_finalize<true>(static_cast<const float*>(ws), static_cast<float*>(out), G, C,
                               M, st);
}

template <typename T, bool RES, bool RELU>
cudaError_t normalize_t(const void* x, const void* res, const void* scal, void* y, int64_t M,
                        int C, int G, cudaStream_t st) {
  const Grid g = make_grid<T>(C, G);
  normalize<T, RES, RELU><<<g.grid, g.block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<const float*>(scal),
      static_cast<T*>(y), M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t normalize_any(const void* x, const void* res, const void* scal, void* y,
                          int64_t M, int C, int G, int relu, cudaStream_t st) {
  if (res != nullptr) {
    return relu ? normalize_t<T, true, true>(x, res, scal, y, M, C, G, st)
                : normalize_t<T, true, false>(x, res, scal, y, M, C, G, st);
  }
  return relu ? normalize_t<T, false, true>(x, res, scal, y, M, C, G, st)
              : normalize_t<T, false, false>(x, res, scal, y, M, C, G, st);
}

template <typename T>
cudaError_t bwd_reduce(const void* g, const void* out, const void* x, const void* scal,
                       void* ws, void* sums, int64_t M, int C, int G, int relu,
                       cudaStream_t st) {
  const Grid gr = make_grid<T>(C, G);
  const T* gp = static_cast<const T*>(g);
  const T* op = static_cast<const T*>(out);
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scal);
  float* wp = static_cast<float*>(ws);
  if (relu) {
    bwd_reduce_partial<T, true><<<gr.grid, gr.block, 0, st>>>(gp, op, xp, sp, wp, M, C);
  } else {
    bwd_reduce_partial<T, false><<<gr.grid, gr.block, 0, st>>>(gp, op, xp, sp, wp, M, C);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_finalize<false>(wp, static_cast<float*>(sums), G, C, M, st);
}

template <typename T, bool RES, bool RELU>
cudaError_t bwd_dx_t(const void* g, const void* out, const void* x, const void* scal, void* dx,
                     void* dres, int64_t M, int C, int G, cudaStream_t st) {
  const Grid gr = make_grid<T>(C, G);
  bwd_dx<T, RES, RELU><<<gr.grid, gr.block, 0, st>>>(
      static_cast<const T*>(g), static_cast<const T*>(out), static_cast<const T*>(x),
      static_cast<const float*>(scal), static_cast<T*>(dx), static_cast<T*>(dres), M, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dx_any(const void* g, const void* out, const void* x, const void* scal,
                       void* dx, void* dres, int64_t M, int C, int G, int relu,
                       cudaStream_t st) {
  if (dres != nullptr) {
    return relu ? bwd_dx_t<T, true, true>(g, out, x, scal, dx, dres, M, C, G, st)
                : bwd_dx_t<T, true, false>(g, out, x, scal, dx, dres, M, C, G, st);
  }
  return relu ? bwd_dx_t<T, false, true>(g, out, x, scal, dx, dres, M, C, G, st)
              : bwd_dx_t<T, false, false>(g, out, x, scal, dx, dres, M, C, G, st);
}

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

int vec_of(int dtype) { return dtype == kF32 ? Vec<float>::N : Vec<__nv_bfloat16>::N; }

}  // namespace

extern "C" {

// Every entry point takes an (M, C) row-major activation of dtype 0 (f32)
// or 1 (bf16), C a multiple of 16 bytes' worth of elements, 16-byte aligned
// pointers, and G row groups (1..65535); the reductions' ws is a (G, 2, C)
// float32 workspace. Each returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernels do not take, otherwise the launches' status.

// out (2, C) f32 = [mean, biased var] of x.
int yolo_bn_stats(const void* x, void* ws, void* out, long long M, int C, int G, int dtype,
                  void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || bad_shape(M, C, G, vec_of(dtype)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? stats<float>(x, ws, out, M, C, G, st)
                       : stats<__nv_bfloat16>(x, ws, out, M, C, G, st);
}

// y = relu?(x*mul + add (+ res)); scal (2, C) f32; res may be null.
int yolo_bn_normalize(const void* x, const void* res, const void* scal, void* y, long long M,
                      int C, int G, int dtype, int relu, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || bad_shape(M, C, G, vec_of(dtype)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == kF32 ? normalize_any<float>(x, res, scal, y, M, C, G, relu, st)
                       : normalize_any<__nv_bfloat16>(x, res, scal, y, M, C, G, relu, st);
}

// sums (2, C) f32 = [sum gz, sum gz*xhat]; scal (2, C) f32 = [r, -mean*r];
// out is read only when relu is set.
int yolo_bn_bwd_reduce(const void* g, const void* out, const void* x, const void* scal,
                       void* ws, void* sums, long long M, int C, int G, int dtype, int relu,
                       void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || bad_shape(M, C, G, vec_of(dtype)))
    return cudaErrorInvalidValue;
  if (relu && out == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == kF32
             ? bwd_reduce<float>(g, out, x, scal, ws, sums, M, C, G, relu, st)
             : bwd_reduce<__nv_bfloat16>(g, out, x, scal, ws, sums, M, C, G, relu, st);
}

// dx = A*gz - (B*x - D) and, if dres is not null, dres = gz;
// scal (3, C) f32 = [A, B, -D]; out is read only when relu is set.
int yolo_bn_bwd_dx(const void* g, const void* out, const void* x, const void* scal, void* dx,
                   void* dres, long long M, int C, int G, int dtype, int relu, void* stream) {
  if ((dtype != kF32 && dtype != kBF16) || bad_shape(M, C, G, vec_of(dtype)))
    return cudaErrorInvalidValue;
  if (relu && out == nullptr) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == kF32
             ? bwd_dx_any<float>(g, out, x, scal, dx, dres, M, C, G, relu, st)
             : bwd_dx_any<__nv_bfloat16>(g, out, x, scal, dx, dres, M, C, G, relu, st);
}

}  // extern "C"
