// Per-tap int8 Winograd F(2x2, 3x3) convolution with a fused requant
// epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_tpu/serving/pallas_wino.py::_wino_kernel
// (entry _wino_conv, public conv3x3_wino_pallas) and, as its `mode`, the
// ablation variants of experiments/wino_ablate.py::kernel_variant. It
// computes yolo_tpu_torch/serving/winograd.py::conv3x3_wino_rq, its eager
// twin, bit for bit, in the same order:
//   1. the 16 taps V_t = B^T d B of every 4x4 input tile, in exact int32
//      (tile (i, j) reads input rows 2i-1 .. 2i+2 and columns 2j-1 .. 2j+2,
//      zero off the image);
//   2. vq_t = q(__int2float_rn(V_t) * dinv[t]), q = clip(rint, -127, 127);
//   3. acc_t = vq_t . U_t over the C input channels, int32 (exact);
//   4. m_t = __int2float_rn(acc_t) * mw[t][k];
//   5. Y_p = sum_t A2[p][t] m_t, float32, ascending t from the first
//      nonzero term (A2 = A_T (x) A_T, coefficients 0 and +-1);
//   6. y = Y_p + bias[k], leaky (y > 0 ? y : y * 0.1f) or ReLU, q(y), stored
//      at output pixel (2i + r, 2j + s), p = 2r + s, if it lies in the image.
// Every float step is an __f*_rn intrinsic, so nvcc cannot contract two
// steps into an FMA. Tiles span ceil(H/2) x ceil(W/2) per image; the twin
// tiles a square of the larger side and crops, which gives the same outputs
// (each tile depends only on its own input patch).
//
// Modes (the ablation of the TPU kernel; the twins are in serving/cuda_wino.py):
//   kFull     the conv;
//   kTaps     steps 1-2 only; output (2i + r, 2j + s, k) = vq_{2r+s}[tile][k]
//             (needs K <= C);
//   kDots     step 1-2 skipped: the dots and steps 4-6 on all-zero taps;
//   kDotsRaw  the dots on zero taps, then y_p = acc_{12+p} + bias (no
//             dequant, no inverse) through step 6's epilogue.
//
// What bounds it: the int8 tensor cores for the wide convs (head_conv1:
// 52.6 G operations, 26.6 us at 1,979 TOPS), device memory for layer1 (x
// and y at 112x112). Design, simple first (the tap loop inside, not outside:
// the other shape re-gathers x for every tap and keeps 4 float32 Y sums):
//   * one thread block of 8 warps computes kBM = 32 Winograd tiles x kBN = 64
//     output channels for all 16 taps: 16 int32 accumulator tiles, held in
//     registers (each warp a 16 x 16 sub-tile of every tap, 128 registers a
//     thread), so the inverse transform runs in registers after the C loop;
//   * the C loop advances kBC = 32 channels at a time through two
//     shared-memory stages, fetched with 16-byte cp.async while the current
//     stage is used: the 4x4 input patch of each of the block's tiles
//     (neighbouring patches overlap; they are re-read from L2, zero-filled
//     off the image) and the 16 weight-tap chunks, packed K-major per tap
//     (16, K, C) so each tap is the B operand of mma.sync m16n8k32 s8;
//   * each thread builds the 16 taps of one tile for 4 channels (integer
//     adds of {0, +-1} combinations, one row of B^T at a time to keep the
//     live registers few) and writes the requantized taps to shared memory
//     as the A operands; then every warp runs its 32 mma.sync;
//   * shared rows are 48 bytes (32 + 16) and patches 544 bytes apart, so a
//     warp's fragment loads and tap reads hit distinct banks.
// U is read by every M-tile (33.5 MB at head_conv1, from L2), x by every
// K-tile. Not done yet (later work): wgmma, TMA, U resident across M-tiles,
// clusters sharing U.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;                          // Winograd tiles per block
constexpr int kBN = 64;                          // output channels per block
constexpr int kBC = 32;                          // input channels per stage
constexpr int kRow = kBC + 16;                   // bytes per tap-operand row
constexpr int kPatchTile = 16 * kBC + 32;        // bytes per tile's 4x4 patch
constexpr int kPatchBytes = kBM * kPatchTile;    // 17,408
constexpr int kUBytes = 16 * kBN * kRow;         // 49,152
constexpr int kVqBytes = 16 * kBM * kRow;        // 24,576
constexpr int kSmem = 2 * kPatchBytes + 2 * kUBytes + kVqBytes;  // 157,696

enum WinoMode { kFull = 0, kTaps = 1, kDots = 2, kDotsRaw = 3 };

struct WinoArgs {
  const int8_t* x;
  const int8_t* u;  // (16, K, C)
  const float* mw;  // (16, K)
  const float* bias;
  const float* dinv;  // (16,)
  int8_t* out;
  int N, H, W, C, K, Th, Tw, leaky;
  long long M;  // N * Th * Tw tiles
};

// B_T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]]; A_T = [[1,1,1,0],[0,1,-1,-1]].
__host__ __device__ constexpr int b_t(int a, int u) {
  return a == 0   ? (u == 0 ? 1 : (u == 2 ? -1 : 0))
         : a == 1 ? ((u == 1 || u == 2) ? 1 : 0)
         : a == 2 ? (u == 1 ? -1 : (u == 2 ? 1 : 0))
                  : (u == 1 ? 1 : (u == 3 ? -1 : 0));
}

__host__ __device__ constexpr int a_t(int r, int a) {
  return r == 0 ? (a < 3 ? 1 : 0) : (a == 0 ? 0 : (a == 1 ? 1 : -1));
}

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Step 6 on one value: + bias, leaky or ReLU, round and clip to int8.
__device__ __forceinline__ int8_t finish(float y, float bias, int leaky) {
  y = __fadd_rn(y, bias);
  y = leaky ? (y > 0.0f ? y : __fmul_rn(y, 0.1f)) : fmaxf(y, 0.0f);
  return q8(y);
}

struct TileCoord {
  int n, ti, tj;
};

__device__ __forceinline__ TileCoord tile_of(long long mt, const WinoArgs& a) {
  const int per_image = a.Th * a.Tw;
  TileCoord c;
  c.n = static_cast<int>(mt / per_image);
  const int rem = static_cast<int>(mt - static_cast<long long>(c.n) * per_image);
  c.ti = rem / a.Tw;
  c.tj = rem - c.ti * a.Tw;
  return c;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1) int8_wino_kernel(const WinoArgs a) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float dinv_s[16];
  int8_t* const patch0 = smem;
  int8_t* const us0 = smem + 2 * kPatchBytes;
  int8_t* const vq = smem + 2 * kPatchBytes + 2 * kUBytes;
  constexpr bool kBuild = MODE == kFull || MODE == kTaps;
  constexpr bool kDot = MODE != kTaps;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / 4, warp_n = warp % 4;  // 2 x 4 warps of 16 x 16
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  if (tid < 16) dinv_s[tid] = a.dinv[tid];

  // Patch copies: this thread fills pixel `pix`, half `half` of tiles
  // tid/32 + 8i; the source offset (channel 0) or -1 for zeros.
  const int pix = (tid % 32) / 2, half = tid % 2;
  long long xoff[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xoff[i] = -1;
    const long long mt = m0 + tid / 32 + 8 * i;
    if (kBuild && mt < a.M) {
      const TileCoord c = tile_of(mt, a);
      const int ih = 2 * c.ti - 1 + pix / 4, iw = 2 * c.tj - 1 + pix % 4;
      if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
        xoff[i] = ((static_cast<long long>(c.n) * a.H + ih) * a.W + iw) * a.C + half * 16;
    }
  }
  // U copies: row kr of taps 2i + tid/128, half `half`.
  const int kr = (tid / 2) % kBN;
  const long long uoff = static_cast<long long>(n0 + kr) * a.C + half * 16;

  auto load_stage = [&](int c0, int buf) {
    if constexpr (kBuild) {
      int8_t* dst = patch0 + buf * kPatchBytes + pix * kBC + half * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = xoff[i] >= 0;
        cp_async16(dst + (tid / 32 + 8 * i) * kPatchTile, ok ? a.x + xoff[i] + c0 : a.x, ok);
      }
    }
    if constexpr (kDot) {
      int8_t* dst = us0 + buf * kUBytes + kr * kRow + half * 16;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = 2 * i + tid / 128;
        cp_async16(dst + t * kBN * kRow, a.u + static_cast<long long>(t) * a.K * a.C + uoff + c0,
                   true);
      }
    }
  };

  if constexpr (!kBuild) {  // the dots run on all-zero taps
    uint4* z = reinterpret_cast<uint4*>(vq);
    for (int i = tid; i < kVqBytes / 16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  int acc[16][2][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;

  const int nchunks = a.C / kBC;
  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nchunks; ++kc) {
    const int c0 = kc * kBC;
    cp_async_wait_all();
    __syncthreads();  // stage kc is in shared memory; everyone is done with kc - 1
    if (kc + 1 < nchunks) {
      load_stage(c0 + kBC, (kc + 1) & 1);
      cp_async_commit();
    }

    if constexpr (kBuild) {
      // Steps 1-2 for tile tm, channels c0 + 4*cg .. +3.
      const int tm = tid / 8, cg = tid % 8;
      const int8_t* p = patch0 + (kc & 1) * kPatchBytes + tm * kPatchTile + cg * 4;
      uint32_t in[16];
#pragma unroll
      for (int q = 0; q < 16; ++q) in[q] = ld32(p + q * kBC);
#pragma unroll
      for (int ra = 0; ra < 4; ++ra) {  // one row of B^T: taps 4*ra .. 4*ra + 3
        uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          int r[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            int s = 0;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (b_t(ra, u) != 0) s += b_t(ra, u) * sbyte(in[u * 4 + v], ch);
            r[v] = s;
          }
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            int v_t = 0;
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (b_t(b, v) != 0) v_t += b_t(b, v) * r[v];
            const int8_t q = q8(__fmul_rn(__int2float_rn(v_t), dinv_s[ra * 4 + b]));
            packed[b] |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * ch);
          }
        }
#pragma unroll
        for (int b = 0; b < 4; ++b)
          *reinterpret_cast<uint32_t*>(vq + (ra * 4 + b) * kBM * kRow + tm * kRow + cg * 4) =
              packed[b];
        if constexpr (MODE == kTaps) {
          // Taps 0-3 of this tile at channels c0 + 4*cg, where they fall in
          // the block's output channels.
          const long long mt = m0 + tm;
          if (ra == 0 && c0 >= n0 && c0 < n0 + kBN && mt < a.M) {
            const TileCoord c = tile_of(mt, a);
#pragma unroll
            for (int pp = 0; pp < 4; ++pp) {
              const int oh = 2 * c.ti + pp / 2, ow = 2 * c.tj + pp % 2;
              if (oh < a.H && ow < a.W)
                *reinterpret_cast<uint32_t*>(
                    a.out + ((static_cast<long long>(c.n) * a.H + oh) * a.W + ow) * a.K + c0 +
                    cg * 4) = packed[pp];
            }
          }
        }
      }
    }

    if constexpr (kDot) {
      if constexpr (kBuild) __syncthreads();  // the taps are in shared memory
      const int8_t* ub = us0 + (kc & 1) * kUBytes;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int8_t* pa = vq + t * kBM * kRow + (warp_m * 16 + g) * kRow + tg * 4;
        const unsigned a0 = ld32(pa), a1 = ld32(pa + 8 * kRow), a2 = ld32(pa + 16),
                       a3 = ld32(pa + 8 * kRow + 16);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int8_t* pb = ub + (t * kBN + warp_n * 16 + j * 8 + g) * kRow + tg * 4;
          mma_s8(acc[t][j], a0, a1, a2, a3, ld32(pb), ld32(pb + 16));
        }
      }
    }
  }
  if constexpr (kDot) {
    // Steps 4-6. Accumulator element e of tile (t, j) is tile row g (+8 for
    // e >= 2) and channel 2*tg (+1 for odd e) of the warp's 16 x 16 sub-tile.
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + warp_n * 16 + j * 8 + tg * 2;
      const float b0 = a.bias[col], b1 = a.bias[col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long mt = m0 + warp_m * 16 + g + hh * 8;
        if (mt >= a.M) continue;
        float y0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (MODE == kDotsRaw) {
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            y0[pp] = __int2float_rn(acc[12 + pp][j][hh * 2]);
            y1[pp] = __int2float_rn(acc[12 + pp][j][hh * 2 + 1]);
          }
        } else {
          float m0v[16], m1v[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const float* w = a.mw + t * a.K + col;
            m0v[t] = __fmul_rn(__int2float_rn(acc[t][j][hh * 2]), __ldg(w));
            m1v[t] = __fmul_rn(__int2float_rn(acc[t][j][hh * 2 + 1]), __ldg(w + 1));
          }
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            bool first = true;
#pragma unroll
            for (int t = 0; t < 16; ++t) {
              const int c = a_t(pp / 2, t / 4) * a_t(pp % 2, t % 4);
              if (c == 0) continue;
              const float t0 = c > 0 ? m0v[t] : -m0v[t], t1 = c > 0 ? m1v[t] : -m1v[t];
              if (first) {
                y0[pp] = t0;
                y1[pp] = t1;
                first = false;
              } else {
                y0[pp] = __fadd_rn(y0[pp], t0);
                y1[pp] = __fadd_rn(y1[pp], t1);
              }
            }
          }
        }
        const TileCoord c = tile_of(mt, a);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const int oh = 2 * c.ti + pp / 2, ow = 2 * c.tj + pp % 2;
          if (oh < a.H && ow < a.W) {
            const long long o = ((static_cast<long long>(c.n) * a.H + oh) * a.W + ow) * a.K + col;
            *reinterpret_cast<uint16_t*>(a.out + o) =
                pack2(finish(y0[pp], b0, a.leaky), finish(y1[pp], b1, a.leaky));
          }
        }
      }
    }
  }
}

template <int MODE>
cudaError_t launch(const WinoArgs& a, cudaStream_t stream) {
  auto kernel = int8_wino_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.M + kBM - 1) / kBM), static_cast<unsigned>(a.K / kBN));
  kernel<<<grid, kThreads, kSmem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, H, W, C) int8; u: the weight taps (16, K, C) int8, C contiguous;
// mw: (16, K) float32; bias: (K,) float32; dinv: (16,) float32; out: (N, H,
// W, K) int8. All contiguous, x and u 16-byte aligned. mode: 0 full, 1 taps,
// 2 dots, 3 dots-raw; leaky: 1 for the leaky epilogue, 0 for ReLU. Returns a
// cudaError_t: cudaErrorInvalidValue for arguments the kernel does not take
// (C or K not a multiple of 64, an empty image, mode 1 with K > C, an
// unknown mode), else the launch's status.
int yolo_int8_wino(const void* x, const void* u, const void* mw, const void* bias,
                   const void* dinv, void* out, int N, int H, int W, int C, int K, int mode,
                   int leaky, void* stream) {
  WinoArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.u = static_cast<const int8_t*>(u);
  a.mw = static_cast<const float*>(mw);
  a.bias = static_cast<const float*>(bias);
  a.dinv = static_cast<const float*>(dinv);
  a.out = static_cast<int8_t*>(out);
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.Th = (H + 1) / 2;
  a.Tw = (W + 1) / 2;
  a.leaky = leaky;
  a.M = static_cast<long long>(N) * a.Th * a.Tw;
  if (N < 1 || H < 1 || W < 1 || C < kBC || C % 64 || K < kBN || K % kBN ||
      (mode == kTaps && K > C))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull:
      return static_cast<int>(launch<kFull>(a, st));
    case kTaps:
      return static_cast<int>(launch<kTaps>(a, st));
    case kDots:
      return static_cast<int>(launch<kDots>(a, st));
    case kDotsRaw:
      return static_cast<int>(launch<kDotsRaw>(a, st));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
