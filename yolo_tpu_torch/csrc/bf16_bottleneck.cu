// bf16 fused identity bottleneck (inference, BN folded) for Hopper (sm_90a).
//
// Replaces the TPU kernel experiments/fused_block_pallas.py::
// fused_bottleneck_kernel (entry fused_bottleneck) and computes what it
// computes, per pixel:
//   y1  = bf16(relu(conv1x1(x, w1) + b1))            CIN -> P   (:50-58)
//   y2  = bf16(relu(conv3x3(y1, w2, pad 1) + b2))    P -> P     (:79-84)
//   out = bf16(relu((conv1x1(y2, w3) + b3) + x))     P -> CIN   (:87-92)
// with float32 accumulators, each bias and the residual added in float32 in
// that order, and y1, y2 rounded to bf16 where the TPU kernel rounds them.
// The twin (yolo_tpu_torch/experiments/fused_block_pallas.py::reference)
// runs the same steps as three float32 convs; the sums are taken in another
// order, so the two agree to a bf16 ulp or two, not to the bit.
//
// A block on one output tile is sm90_bottleneck_tile.cuh's routine (bf16
// k16 wgmma, float32 sums; y1 over the tile's halo and y2 never leave shared
// memory; conv2's and conv3's A from registers by ldmatrix, conv1's from the
// producer's ring), shared with the int8 bottleneck and chain; this file
// supplies the bias + ReLU epilogues. The grid is persistent: one thread
// block an SM walks the tiles (image-major, then tile rows, then tile
// columns; plan() in serving/cuda_bottleneck.py picks TH x TW), the ring
// running on from one tile to the next, so the next tile's x gather
// overlaps this tile's conv3. Every image size is taken: tiles past the
// image's last row or column compute and do not store (the TPU kernel left
// the rows past a multiple of its row tile unwritten).
//
// What bounds it: device memory at layer1 (x read and out written once:
// 0.82 GB at batch 64, 112x112, 256/64, 0.245 ms at 3.35 TB/s, against 112
// GFLOP, 0.113 ms at 989 TFLOP/s). The tile adds conv1's recompute on the
// halo (1.41x conv1 at 8 x 16 tiles, padded to 1.5x) and streams the
// block's 139 KB of weights from L2 once a tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_common.cuh"
#include "sm90_bottleneck_tile.cuh"

namespace {

namespace bt = sm90::btile;

constexpr int kAlign = 16;  // CIN and P: multiples of 16 (one bf16 wgmma depth)

// The bias + ReLU epilogues on a pair of neighbouring columns, packed as
// two bf16 values, low first, from each column's bias.
struct Bf16Pol {
  const float *b1, *b2, *b3;
  struct P {
    float b;
  };
  // K: 1 conv1, 2 conv2, 3 conv3 (no downsample).
  template <int K>
  __device__ __forceinline__ P param(int col) const {
    return {__ldg((K == 1 ? b1 : K == 2 ? b2 : b3) + col)};
  }
  __device__ __forceinline__ uint32_t y(float a0, float a1, P p0, P p1) const {
    return pack_bf16x2(fmaxf(__fadd_rn(a0, p0.b), 0.0f), fmaxf(__fadd_rn(a1, p1.b), 0.0f));
  }
  __device__ __forceinline__ uint32_t ds(float, float, P, P) const { return 0u; }
  __device__ __forceinline__ uint32_t out(float a0, float a1, P p0, P p1, uint32_t res) const {
    const float2 r = unpack_bf16x2(res);
    const float v0 = __fadd_rn(__fadd_rn(a0, p0.b), r.x);
    const float v1 = __fadd_rn(__fadd_rn(a1, p1.b), r.y);
    return pack_bf16x2(fmaxf(v0, 0.0f), fmaxf(v1, 0.0f));
  }
};

__global__ void __launch_bounds__(bt::kThreads, 1)
    bf16_bottleneck_kernel(const __grid_constant__ bt::Convs cv, const uint8_t* x, uint8_t* out,
                           const __grid_constant__ Bf16Pol pol,
                           const __grid_constant__ bt::Tiling g) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  bt::Ring ring = bt::make_ring(g, base);
  bt::init_ring(ring);
  __syncthreads();
  const int wg = threadIdx.x / sm90::kWgThreads;
  if (wg == bt::kWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(bt::kProducerRegs) : "memory");
    int* table = reinterpret_cast<int*>(sbase + bt::table_offset(g));
    for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x)
      bt::produce_tile<2>(g, x, cv, tile, ring, table, threadIdx.x % sm90::kWgThreads);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(bt::kConsumerRegs) : "memory");
    uint8_t* y1 = sbase + bt::y1_offset(g);
    uint8_t* y2 = sbase + bt::y2_offset(g);
    for (int tile = blockIdx.x; tile < g.ntiles; tile += gridDim.x)
      bt::consume_tile<2>(g, out, cv, pol, tile, ring, y1, y2, wg);
  }
}

int pad32(int k) { return (k + 31) / 32 * 32; }

}  // namespace

extern "C" {

// x, out: (N, H, W, CIN) bf16 NHWC; w1: (P, pad32(CIN)), w2: (P, pad32(9P))
// with K in (kh, kw, c) order, w3: (CIN, pad32(P)), bf16 packed K-contiguous
// and zero past K (pad32: rounded up to a multiple of 32); b1, b2: (P,), b3:
// (CIN,) float32. All on the device, contiguous, 16-byte aligned. (TH, TW):
// the output tile (serving/cuda_bottleneck.py::plan). Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernel does not take (CIN or P not a
// multiple of 16, a tile whose halo or tile rows exceed four 64-row blocks
// or whose buffers leave fewer than three stages of shared memory), else
// the launch's status.
int yolo_bf16_bottleneck(const void* x, const void* w1, const void* b1, const void* w2,
                         const void* b2, const void* w3, const void* b3, void* out, int N, int H,
                         int W, int CIN, int P, int TH, int TW, void* stream) {
  if (N < 0 || CIN <= 0 || CIN % kAlign || P <= 0 || P % kAlign || !x || !w1 || !b1 || !w2 ||
      !b2 || !w3 || !b3 || !out)
    return cudaErrorInvalidValue;
  if (N == 0) return cudaSuccess;
  bt::Tiling g;
  if (!bt::make_tiling(g, 2, N, H, W, CIN, CIN, P, TH, TW)) return cudaErrorInvalidValue;
  const bt::Convs cv{static_cast<const uint8_t*>(w1), static_cast<const uint8_t*>(w2),
                     static_cast<const uint8_t*>(w3), nullptr, CIN, P, CIN,
                     2 * pad32(CIN), 2 * pad32(9 * P), 2 * pad32(P), 0};
  const Bf16Pol pol{static_cast<const float*>(b1), static_cast<const float*>(b2),
                    static_cast<const float*>(b3)};
  const int smem = bt::smem_bytes(g);
  int grid = 0;
  cudaError_t err = bt::grid_of(bf16_bottleneck_kernel, smem, g.ntiles, &grid);
  if (err != cudaSuccess) return err;
  bf16_bottleneck_kernel<<<grid, bt::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cv, static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), pol, g);
  return cudaGetLastError();
}

}  // extern "C"
