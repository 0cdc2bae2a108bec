// bf16 3x3 convolution with optional BatchNorm statistics in its epilogue,
// for Hopper (sm_90a), on the shared wgmma mainloop of sm90_conv_core.cuh.
//
// Replaces the TPU kernel experiments/conv_bn_fuse_bench.py::_kernel (entry
// pallas_conv, from build): a 3x3 / stride 1 / SAME conv of NHWC bf16 x
// with HWIO bf16 weights, float32 accumulators, y rounded to bf16; with
// stats, also the per-output-channel sums of the FLOAT32 ACCUMULATORS
// (before the bf16 rounding) and of their squares, over every pixel of the
// batch, as the TPU kernel's :81-85 does:
//   stats[0, k] = sum acc[., k],  stats[1, k] = sum acc[., k]^2.
// y is NHWC in natural column order: the TPU kernel's (H, W/2, 2K) column
// parity view was a lane trick of the TPU and is gone.
//
// As a GEMM: M = n*H*W pixels, N = K output channels, depth 9*C in (kh, kw,
// c) order. The weights arrive packed K-major as (K, Kpad) bf16, Kpad = 9C
// rounded up to 32 with zeros (the wrapper packs them once); a 128-byte
// stage zero-fills what lies past Kpad.
//
// The TPU kernel carried the statistics across its sequential grid in one
// output block; thread blocks here run in no order and walk several tiles
// each, so every 64-row slab of the output (one consumer warpgroup's share
// of a 128-row tile) writes its partial sums to a (G, 2, K) float32
// workspace at its slab index, G = ceil(n*H*W / 64), and a second kernel
// sums the G partials per channel in a fixed order, in float64. No
// atomics: two runs give identical sums, and no partial is written twice
// or skipped whichever block walks which tile.
//
// What bounds it: the bf16 tensor cores. layer3's conv2 at batch 128 (28x28,
// 256 -> 256) is 118 GFLOP, 0.120 ms at 989 TFLOP/s, against 0.10 GB, 0.031
// ms at 3.35 TB/s. The earlier design (mma.sync m16n8k16, two cp.async
// stages of 64 bytes of K, a block-wide barrier every stage) ran at ~200
// TFLOP/s. Now: 128 x 256 tiles of wgmma.m64n256k16 from 128-byte-swizzled
// stages (64 bf16 of K), a 4-stage mbarrier ring filled with 16-byte
// cp.async by a producer warpgroup (the im2col gather on the fly,
// zero-filled in the padding), two consumer warpgroups, a persistent grid
// so that one tile's epilogue (y and the sums) overlaps the next tile's
// loads. At 128 x 128 tiles the ring's fill from L2 set the pace; 128 x
// 256 tiles move three quarters of the bytes a FLOP (channels past K are
// zero-filled and masked).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_common.cuh"
#include "sm90_conv_core.cuh"

namespace {

constexpr int kWG = 2, kBM = 64 * kWG, kBN = 256;  // output tiles of 128 x 256
constexpr int kSlab = 64;                // rows of one stats partial
constexpr int kThreads = sm90::kWgThreads * (kWG + 1);
constexpr int kStrands = 8;  // finalize: partial sums per channel

struct Out {
  __nv_bfloat16* y;
  float* ws;  // (G, 2, K) partial sums, with stats
  long long M;
  int K, G;
};

template <bool kStats>
__global__ void __launch_bounds__(kThreads, 1) conv3x3_kernel(const sm90::Geom g, const Out o) {
  __shared__ float red[kWG][2][4][kBN];  // per warpgroup: sums of each warp's 16 rows
  auto epi = [&](const float (&acc)[kBN / 2], const sm90::Unit& un, int wg, uint8_t*) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int tg = lane % 4;
    const long long row0 = un.m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = un.n0 + 8 * j + 2 * tg;
      if (col >= o.K) continue;  // K % 8 == 0, so col + 1 < K too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + 8 * h;
        if (row < o.M)
          *reinterpret_cast<unsigned*>(o.y + row * o.K + col) =
              pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    if constexpr (kStats) {
      // Rows past M hold zero accumulators (their A rows were zero-filled)
      // and add nothing. Per thread: its two rows; then across the 8 lanes
      // that share tg; then across the 4 warps, in a fixed order.
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v0 = acc[4 * j + c], v1 = acc[4 * j + 2 + c];
          float s = v0 + v1, q = v0 * v0 + v1 * v1;
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            s += __shfl_xor_sync(0xffffffffu, s, off);
            q += __shfl_xor_sync(0xffffffffu, q, off);
          }
          if (lane < 4) {
            red[wg][0][warp][8 * j + 2 * tg + c] = s;
            red[wg][1][warp][8 * j + 2 * tg + c] = q;
          }
        }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(sm90::kWgThreads) : "memory");
      const long long slab = un.m0 / kSlab + wg;
#pragma unroll
      for (int col = threadIdx.x % sm90::kWgThreads; col < kBN; col += sm90::kWgThreads) {
        if (slab < o.G && un.n0 + col < o.K) {
          float s = 0.0f, q = 0.0f;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            s += red[wg][0][w][col];
            q += red[wg][1][w][col];
          }
          o.ws[(slab * 2) * o.K + un.n0 + col] = s;
          o.ws[(slab * 2 + 1) * o.K + un.n0 + col] = q;
        }
      }
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(sm90::kWgThreads) : "memory");
    }
  };
  auto pre = [](const sm90::Unit&, int, uint8_t*) {};
  sm90::run<2, kWG, kBN, sm90::kVec16, 0, float>(g, epi, pre);
}

template <bool kStats>
cudaError_t launch(sm90::Geom g, const Out& o, cudaStream_t stream) {
  constexpr int kSmem = sm90::smem_bytes<kWG, kBN, sm90::kVec16, 0>();
  static int per_sm = -1;
  g.m_tiles = static_cast<int>((g.M + kBM - 1) / kBM);
  g.n_tiles = (g.Cout + kBN - 1) / kBN;
  g.units = g.m_tiles * g.n_tiles;
  sm90::set_divisors(g);
  int grid = 0;
  cudaError_t err =
      sm90::persistent_grid(conv3x3_kernel<kStats>, kThreads, kSmem, g.units, &per_sm, &grid);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<kStats><<<grid, kThreads, kSmem, stream>>>(g, o);
  return cudaGetLastError();
}

// Sum the G partials of each channel in a fixed order, in float64: kStrands
// strided strands per channel, then the strands in order.
__global__ void __launch_bounds__(32 * kStrands)
    stats_finalize(const float* __restrict__ ws, float* __restrict__ out, int G, int K) {
  __shared__ double part[2][kStrands][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k = blockIdx.x * 32 + tx;
  double s = 0.0, q = 0.0;
  if (k < K) {
    for (int gi = ty; gi < G; gi += kStrands) {
      s += ws[(static_cast<long long>(gi) * 2) * K + k];
      q += ws[(static_cast<long long>(gi) * 2 + 1) * K + k];
    }
  }
  part[0][ty][tx] = s;
  part[1][ty][tx] = q;
  __syncthreads();
  if (ty == 0 && k < K) {
    double S = 0.0, Q = 0.0;
#pragma unroll
    for (int y = 0; y < kStrands; ++y) {
      S += part[0][y][tx];
      Q += part[1][y][tx];
    }
    out[k] = static_cast<float>(S);
    out[K + k] = static_cast<float>(Q);
  }
}

}  // namespace

extern "C" {

// x: (n, H, W, C) bf16 NHWC; w: (K, Kpad) bf16, row k = output channel k,
// K-order (kh, kw, c), Kpad = 9C rounded up to 32, zero past 9C; y: (n, H,
// W, K) bf16. With with_stats: ws, a (ceil(n*H*W / 64), 2, K) float32
// workspace, and stats, (2, K) float32 = the sums of the accumulators and of
// their squares; both unused otherwise. All on the device, contiguous,
// 16-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue for what
// the kernel does not take (C or K not a multiple of 8), else the launches'
// status.
int yolo_bf16_conv3x3(const void* x, const void* w, void* y, void* ws, void* stats, int n,
                      int H, int W, int C, int K, int with_stats, void* stream) {
  if (n < 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 || K <= 0 || K % 8 || !x || !w || !y ||
      (with_stats && (!ws || !stats)))
    return cudaErrorInvalidValue;
  sm90::Geom g;
  g.x = static_cast<const uint8_t*>(x);
  g.w = static_cast<const uint8_t*>(w);
  g.H = g.Ho = H;
  g.W = g.Wo = W;
  g.Cin = C;
  g.Cout = K;
  g.KH = g.KW = 3;
  g.stride = 1;
  g.pad_t = g.pad_l = 1;
  g.K = 9 * C;
  g.kpad_bytes = 2 * ((9 * C + 31) / 32 * 32);
  g.M = static_cast<long long>(n) * H * W;
  g.splits = 1;
  g.k_stages = (g.kpad_bytes + sm90::kStageBytes - 1) / sm90::kStageBytes;
  Out o;
  o.y = static_cast<__nv_bfloat16*>(y);
  o.ws = static_cast<float*>(ws);
  o.M = g.M;
  o.K = K;
  auto st = static_cast<cudaStream_t>(stream);
  const long long G = (g.M + kSlab - 1) / kSlab;
  // 32-bit offsets in the mainloop: x, w and y stay under 2 GB.
  if (2 * g.M * C > 0x7fffffffLL || 2LL * g.M * K > 0x7fffffffLL ||
      static_cast<long long>(K) * g.kpad_bytes > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  o.G = static_cast<int>(G);
  if (G == 0) {
    if (with_stats) return cudaMemsetAsync(stats, 0, 2 * sizeof(float) * K, st);
    return cudaSuccess;
  }
  cudaError_t err = with_stats ? launch<true>(g, o, st) : launch<false>(g, o, st);
  if (err != cudaSuccess || !with_stats) return err;
  stats_finalize<<<(K + 31) / 32, dim3(32, kStrands), 0, st>>>(o.ws, static_cast<float*>(stats),
                                                               o.G, K);
  return cudaGetLastError();
}

}  // extern "C"
