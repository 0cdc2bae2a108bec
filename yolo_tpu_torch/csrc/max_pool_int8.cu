// The int8 engine's 3x3 / stride 2 / pad 1 max-pool of NHWC int8 for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX engine (yolo_tpu/serving/engine.py) pools
// the stem's int8 output with lax.reduce_window (init -128), which XLA
// lowers itself. The port's eager version
// (serving/cuda_pool.py::max_pool_int8_reference) copies the input into a
// -128 border, then takes the max of nine strided views in eight passes and
// a final copy. For x of shape (N, H, W, C):
//
//   y[n, i, j, c] = max over r in {2i-1, 2i, 2i+1}, s in {2j-1, 2j, 2j+1}
//                   of x[n, r, s, c], a position outside x counting as -128
//
// with Ho = (H - 1) / 2 + 1 rows and Wo = (W - 1) / 2 + 1 columns out. A max
// of integers is exact in any order, so y equals the twin bit for bit.
//
// What bounds it: device memory. Each input byte has to be read once and
// each output byte written once (the ResNet stem's output at batch 256 is
// 822 MB in, 206 MB out: 0.307 ms at 3.35 TB/s); there is one byte-wise max
// per input byte. So:
//   * a thread owns 16 channels (one 16-byte vector) of one output column
//     and walks down a strip of kRows output rows. The vertical max of input
//     row 2i+1 it keeps in registers as row 2(i+1)-1 of the next output row,
//     so a strip reads its input rows once, plus the one row above it;
//   * neighbouring threads take neighbouring vectors of a pixel, then
//     neighbouring output columns: a thread loads input columns 2j and 2j+1,
//     and takes column 2j-1 from the thread of output column j-1 (its 2j+1)
//     by a warp shuffle. Only the first pixel of a warp loads it itself
//     (an L1/L2 hit: the previous warp has just read it);
//   * the max is __vmaxs4, four signed bytes a 32-bit word, and each output
//     vector leaves as one 16-byte store, coalesced across the warp;
//   * each iteration's loads do not depend on the previous one's results, so
//     the unrolled strip keeps many 16-byte loads in flight a thread, and the
//     grid (one thread a vector, column and strip) is thousands of blocks at
//     the engine's batches.
// The channels must be a multiple of 16 and x and y 16-byte aligned; the
// wrapper checks both and refuses anything else.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                // output rows a thread walks down
constexpr int kVector = 16;             // int8 channels a 16-byte vector holds
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPad = 0x80808080u;  // four int8 -128

__device__ __forceinline__ uint4 pad4() { return make_uint4(kPad, kPad, kPad, kPad); }

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z),
                    __vmaxs4(a.w, b.w));
}

__device__ __forceinline__ uint4 load(const uint4* p, bool ok) { return ok ? __ldg(p) : pad4(); }

__device__ __forceinline__ uint4 shfl_up(uint4 v, int d) {
  return make_uint4(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d),
                    __shfl_up_sync(kFull, v.z, d), __shfl_up_sync(kFull, v.w, d));
}

// One thread per (image, strip of kRows output rows, output column, vector),
// vectors fastest. Every lane of a warp runs every step (shuffles need the
// whole warp); a lane past the end, or on a row past Ho, loads nothing and
// stores nothing.
__global__ void __launch_bounds__(kThreads)
    max_pool_int8_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, int h, int w,
                         int vecs, int ho, int wo, int strips, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = t < total;
  long long p = active ? t : 0;
  const int v = static_cast<int>(p % vecs);
  p /= vecs;
  const int j = static_cast<int>(p % wo);
  p /= wo;
  const int i0 = static_cast<int>(p % strips) * kRows;
  const long long img = p / strips;

  const long long row_stride = static_cast<long long>(w) * vecs;
  const uint4* xi = x + img * h * row_stride + v;
  uint4* yi = y + img * ho * static_cast<long long>(wo) * vecs + v;
  const bool has_right = 2 * j + 1 < w;
  // Lanes whose thread vecs places back holds output column j-1 take column
  // 2j-1 from it; the first pixel of a warp loads it (vecs >= 32: every lane).
  const bool own_left = (threadIdx.x & 31) < vecs;

  // The max over columns 2j-1 .. 2j+1 of input row r (-128 where outside).
  auto row_max = [&](int r, bool ok) {
    const uint4* row = xi + (ok ? r * row_stride : 0);
    const uint4 mid = load(row + 2 * j * vecs, ok);
    const uint4 right = load(row + (2 * j + 1) * vecs, ok && has_right);
    uint4 left = shfl_up(right, vecs);
    if (j == 0) {
      left = pad4();
    } else if (own_left) {
      left = load(row + (2 * j - 1) * vecs, ok);
    }
    return vmax(vmax(left, mid), right);
  };

  uint4 above = row_max(2 * i0 - 1, active && i0 > 0);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = i0 + k;
    const bool ok = active && i < ho;
    const uint4 a = row_max(2 * i, ok);
    const uint4 b = row_max(2 * i + 1, ok && 2 * i + 1 < h);
    if (ok) yi[(static_cast<long long>(i) * wo + j) * vecs] = vmax(vmax(above, a), b);
    above = b;
  }
}

}  // namespace

extern "C" {

// x: (n, h, w, c) int8 NHWC, contiguous; y: (n, (h-1)/2+1, (w-1)/2+1, c)
// int8. One launch on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for a size under 1, c not a multiple of 16, x or y
// not 16-byte aligned, or a grid over 2^31 - 1 blocks; else the launch's
// status.
int yolo_max_pool_int8(const void* x, void* y, int n, int h, int w, int c, void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || c % kVector != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || (reinterpret_cast<uintptr_t>(y) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  const int ho = (h - 1) / 2 + 1, wo = (w - 1) / 2 + 1, vecs = c / kVector;
  const int strips = (ho + kRows - 1) / kRows;
  const long long total = static_cast<long long>(n) * strips * wo * vecs;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  max_pool_int8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), h, w, vecs, ho, wo, strips, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
