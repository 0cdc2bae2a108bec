// Per-tap int8 Winograd F(2x2, 3x3) convolution with a fused requant
// epilogue, for Hopper (sm_90a): a tap pass, then a tap GEMM on the shared
// wgmma mainloop of sm90_conv_core.cuh.
//
// Replaces the TPU kernel yolo_tpu/serving/pallas_wino.py::_wino_kernel
// (entry _wino_conv, public conv3x3_wino_pallas) and, as its modes, the
// ablation variants of experiments/wino_ablate.py::kernel_variant. It
// computes yolo_tpu_torch/serving/winograd.py::conv3x3_wino_rq, its eager
// twin, bit for bit, in the same order:
//   1. the 16 taps V_t = B^T d B of every 4x4 input tile, in exact int32
//      (tile (i, j) reads input rows 2i-1 .. 2i+2 and columns 2j-1 .. 2j+2,
//      zero off the image);
//   2. vq_t = q(__int2float_rn(V_t) * dinv[t]), q = clip(rint(.), -127, 127);
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
// What bounds it on the H100: the int8 tensor cores for the wide convs
// (head_conv1 at batch 16: 52.6 G operations, 26.6 us at 1,979 TOPS), device
// memory for layer1 (x, the taps and y at 112x112). The earlier design (one
// block of 32 tiles x 64 channels building all 16 taps from x, 16 int32
// accumulators in registers, mma.sync) rebuilt every tile's taps once per
// 64-channel column block, and its tap build and dots, both limited by
// shared memory, did not overlap (full ~ taps + dots). Now, as the TPU
// kernel does with its tap scratch (pallas_wino.py build_tap, accumulate),
// two kernels a conv:
//   * wino_taps_kernel (steps 1-2) reads x once and writes the requantized
//     taps to a (16, Mt, C) int8 scratch, tap-major with C contiguous (Mt =
//     N * ceil(H/2) * ceil(W/2) tiles): one thread a tile and 4 channels,
//     the old kernel's int32 build, one row of B^T at a time;
//   * wino_gemm_kernel (steps 3-6) runs the core with 16 segments, one a
//     tap: A = the scratch's tap t, a plain (Mt, C) matrix; B = uk[t], the
//     (16, K, C) K-major packing the engine already keeps. The ring runs
//     on across taps; after each tap the consumers dequantize its
//     accumulator with mw[t] (fetched with the bias into shared memory by
//     the producer while the unit's first taps load) and add it into the
//     four running float32 sums Y_p held in registers (4 x 32 a thread for
//     a 64x64 warpgroup tile: the consumers take 232 registers a thread by
//     setmaxnreg, the producer keeps 40). After tap 15 the epilogue adds
//     the bias, activates, rounds and stores each tile's 2x2 outputs.
// Tiles (the wrapper's plan() picks one by shape): 0 = 128x64 (two consumer
// warpgroups), 1 = 64x64 (one, where 128-row tiles would leave most SMs
// idle: layer4 and head_conv3 at batch 16, every conv at batch 1-2).
//
// Modes (the ablation of the TPU kernel; the twins are in serving/cuda_wino.py):
//   full      the conv: the tap pass, then the tap GEMM;
//   taps      the tap pass alone, writing tap p = 2r + s of tile (i, j) at
//             output (2i + r, 2j + s, k), k < K (needs K <= C);
//   dots      the tap GEMM alone (steps 3-6) on all-zero taps;
//   dots-raw  the tap GEMM on zero taps with y_p = acc_{12+p} (no dequant,
//             no inverse) through step 6's epilogue.
// The wrapper runs the modes; this file has one C entry a kernel.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"
#include "sm90_conv_core.cuh"

namespace {

constexpr int kBN = 64;      // output channels a tile
constexpr int kTapsN = 16;   // Winograd taps, one GEMM segment each
constexpr int kGemmRegs = 232;  // consumer registers a thread with two consumer warpgroups

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

// A2[p][t] = A_T[p / 2][t / 4] * A_T[p % 2][t % 4].
__host__ __device__ constexpr int a2(int p, int t) { return a_t(p / 2, t / 4) * a_t(p % 2, t % 4); }

// The first tap with a nonzero A2[p][t]: Y_p starts there.
__host__ __device__ constexpr int first_tap(int p) {
  return a2(p, 0) ? 0 : a2(p, 1) ? 1 : a2(p, 4) ? 4 : 5;
}

__device__ __forceinline__ int sbyte(uint32_t word, int i) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

// ------------------------------------------------------------ tap pass
struct TapArgs {
  const int8_t* x;     // (N, H, W, C)
  const float* dinv;   // (16,)
  int8_t* dst;         // (16, Mt, C) taps, or (N, H, W, K) in the taps mode
  int H, W, C, K, Th, Tw, to_out;
  long long Mt;        // N * Th * Tw
};

// Steps 1-2 for tile `tile`, channels 4 cg .. 4 cg + 3, one thread each
// (grid-stride); the threads of a tile are neighbours, so a warp reads and
// writes whole 128-byte rows.
__global__ void __launch_bounds__(256) wino_taps_kernel(const TapArgs a) {
  __shared__ float dinv_s[kTapsN];
  if (threadIdx.x < kTapsN) dinv_s[threadIdx.x] = a.dinv[threadIdx.x];
  __syncthreads();
  // 32-bit indices: the host keeps Mt * C under 2^31, so Mt * C / 4 plus a
  // grid's stride stays below it too.
  const int groups = a.C / 4, total = static_cast<int>(a.Mt) * groups;
  const int per_image = a.Th * a.Tw;
  for (int idx = blockIdx.x * 256 + threadIdx.x; idx < total; idx += gridDim.x * 256) {
    const int tile = idx / groups, cg = idx - tile * groups;
    const int n = tile / per_image, rem = tile - n * per_image;
    const int ti = rem / a.Tw, tj = rem - ti * a.Tw;
    uint32_t in[16];  // the 4x4 patch, 4 channels a pixel, zero off the image
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int ih = 2 * ti - 1 + q / 4, iw = 2 * tj - 1 + q % 4;
      in[q] = 0u;
      if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W)
        in[q] = __ldg(reinterpret_cast<const uint32_t*>(
            a.x + ((static_cast<long long>(n) * a.H + ih) * a.W + iw) * a.C + 4 * cg));
    }
#pragma unroll
    for (int ra = 0; ra < 4; ++ra) {  // one row of B^T: taps 4 ra .. 4 ra + 3
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
      if (!a.to_out) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          *reinterpret_cast<uint32_t*>(
              a.dst + (static_cast<long long>(ra * 4 + b) * a.Mt + tile) * a.C + 4 * cg) =
              packed[b];
      } else if (ra == 0 && 4 * cg < a.K) {  // the taps mode: taps 0-3 at their output pixels
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int oh = 2 * ti + p / 2, ow = 2 * tj + p % 2;
          if (oh < a.H && ow < a.W)
            *reinterpret_cast<uint32_t*>(
                a.dst + ((static_cast<long long>(n) * a.H + oh) * a.W + ow) * a.K + 4 * cg) =
                packed[p];
        }
      }
    }
  }
}

// ------------------------------------------------------------ tap GEMM
struct GemmEpi {
  const float* mw;    // (16, K)
  const float* bias;  // (K,)
  int8_t* out;        // (N, H, W, K)
  int H, W, K, leaky;
};

// The operands of one unit's epilogue in shared memory, filled by the
// producer: mw[t][n0 .. n0 + 63] for the 16 taps, then bias[n0 .. n0 + 63].
constexpr int kOpsBytes = (kTapsN + 1) * kBN * 4;
// The kernel's shared memory after the ring: two operand buffers (the
// producer fills one while the consumers read the other), their full and
// empty barriers.
constexpr int kExtraBytes = 2 * kOpsBytes + 4 * 8;

// Steps 4-5 for tap T on this thread's accumulator: m = acc * mw[T] (the
// thread's columns 8 j + 2 (lane % 4) + e of the tile), added into each Y_p
// that tap T feeds, or starting it. kRaw: y_p = acc_{12+p} instead.
template <int T, bool kRaw>
__device__ __forceinline__ void accumulate(const int (&acc)[kBN / 2], float (&y)[4][kBN / 2],
                                           const float* mw, int lane) {
  if constexpr (kRaw) {
    if constexpr (T >= 12) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) y[T - 12][i] = __int2float_rn(acc[i]);
    }
  } else {
    float m[kBN / 2];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(mw + T * kBN + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m[4 * j + 2 * h] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), w.x);
        m[4 * j + 2 * h + 1] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), w.y);
      }
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int c = a2(p, T);
      if (c == 0) continue;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        const float term = c > 0 ? m[i] : -m[i];
        y[p][i] = T == first_tap(p) ? term : __fadd_rn(y[p][i], term);
      }
    }
  }
}

// accumulate<seg> for a segment known at run time.
template <int T, bool kRaw>
__device__ __forceinline__ void accumulate_tap(int seg, const int (&acc)[kBN / 2],
                                               float (&y)[4][kBN / 2], const float* mw, int lane) {
  if constexpr (T < kTapsN) {
    if (seg == T) {
      accumulate<T, kRaw>(acc, y, mw, lane);
    } else {
      accumulate_tap<T + 1, kRaw>(seg, acc, y, mw, lane);
    }
  }
}

// Step 6 on one value: + bias, leaky or ReLU, round and clip to int8.
__device__ __forceinline__ int8_t finish(float y, float bias, int leaky) {
  y = __fadd_rn(y, bias);
  y = leaky ? (y > 0.0f ? y : __fmul_rn(y, 0.1f)) : fmaxf(y, 0.0f);
  return q8(y);
}

template <int kWG, bool kRaw>
__global__ void __launch_bounds__(sm90::kWgThreads*(kWG + 1), 1)
    wino_gemm_kernel(const sm90::Geom g, const GemmEpi e) {
  constexpr int BM = 64 * kWG, kBars = 2 * kOpsBytes;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const uint32_t raw = sm90::smem_u32(smem_raw);
    const uint32_t bars = ((raw + 1023) & ~1023u) +
                          sm90::stages_of<kWG, sm90::kRows>() * (BM + kBN) * sm90::kStageBytes + kBars;
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bars + 8 * b, sm90::kWgThreads);            // operands b full
      sm90::mbar_init(bars + 16 + 8 * b, sm90::kWgThreads * kWG);  // operands b empty
    }
  }  // run() fences the inits and syncs the block

  auto pre = [&](const sm90::Unit& un, int t, uint8_t* extra) {
    const int b = un.ord & 1;
    const uint32_t bars = sm90::smem_u32(extra + kBars), ops = sm90::smem_u32(extra + b * kOpsBytes);
    sm90::mbar_wait(bars + 16 + 8 * b, ((un.ord >> 1) & 1) ^ 1);
    // 16-byte pieces: 16 of mw a tap, then 16 of the bias (n0 + 64 <= K).
    for (int i = t; i < (kTapsN + 1) * (kBN / 4); i += sm90::kWgThreads) {
      const int tap = i / (kBN / 4), piece = i % (kBN / 4);
      const float* src = tap < kTapsN ? e.mw + static_cast<long long>(tap) * e.K : e.bias;
      sm90::cp_async16(ops + 16 * i, src + un.n0 + 4 * piece, true);
    }
    sm90::cp_async_arrive(bars + 8 * b);
  };

  float y[4][kBN / 2];  // the running sums Y_p of this thread's accumulator elements
  auto epi = [&](const int (&acc)[kBN / 2], const sm90::Unit& un, int wg, uint8_t* extra) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int b = un.ord & 1;
    const float* ops = reinterpret_cast<const float*>(extra + b * kOpsBytes);
    const uint32_t bars = sm90::smem_u32(extra + kBars);
    if (un.seg == 0) sm90::mbar_wait(bars + 8 * b, (un.ord >> 1) & 1);
    accumulate_tap<0, kRaw>(un.seg, acc, y, ops, lane);
    if (un.seg != kTapsN - 1) return;
    // Step 6. Accumulator element 4 j + 2 h + e: row 16 warp + lane / 4 + 8 h
    // of the warpgroup's 64, column 8 j + 2 (lane % 4) + e.
    const float* bias = ops + kTapsN * kBN;
    const int hw = g.Ho * g.Wo;  // tiles an image (Ho, Wo: the tile grid)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = un.m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
      if (row >= g.M) continue;
      const int r = static_cast<int>(row), n = r / g.f_hw, rem = r - n * hw;
      const int ti = rem / g.f_wo, tj = rem - ti * g.Wo;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        const float2 bv = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int oh = 2 * ti + p / 2, ow = 2 * tj + p % 2;
          if (oh < e.H && ow < e.W) {
            const long long o =
                ((static_cast<long long>(n) * e.H + oh) * e.W + ow) * e.K + un.n0 + c;
            *reinterpret_cast<uint16_t*>(e.out + o) =
                pack2(finish(y[p][4 * j + 2 * h], bv.x, e.leaky),
                      finish(y[p][4 * j + 2 * h + 1], bv.y, e.leaky));
          }
        }
      }
    }
    sm90::mbar_arrive(bars + 16 + 8 * b);  // done with the operands
  };
  sm90::run<1, kWG, kBN, sm90::kRows, kExtraBytes, int, kWG == 2 ? kGemmRegs : 0>(g, epi, pre);
}

template <int kWG, bool kRaw>
cudaError_t launch_gemm(sm90::Geom g, const GemmEpi& e, cudaStream_t stream) {
  constexpr int BM = 64 * kWG, kThreads = sm90::kWgThreads * (kWG + 1);
  constexpr int kSmem = sm90::smem_bytes<kWG, kBN, sm90::kRows, kExtraBytes>();
  static int per_sm = -1;
  g.m_tiles = static_cast<int>((g.M + BM - 1) / BM);
  g.n_tiles = g.Cout / kBN;
  g.units = g.m_tiles * g.n_tiles;
  sm90::set_divisors(g);
  int grid = 0;
  cudaError_t err = sm90::persistent_grid(wino_gemm_kernel<kWG, kRaw>, kThreads, kSmem, g.units,
                                          &per_sm, &grid);
  if (err != cudaSuccess) return err;
  wino_gemm_kernel<kWG, kRaw><<<grid, kThreads, kSmem, stream>>>(g, e);
  return cudaGetLastError();
}

bool shape_ok(int N, int H, int W, int C, int K) {
  if (N < 1 || H < 1 || W < 1 || C < 64 || C % 64 || K < 64 || K % 64) return false;
  const long long mt = static_cast<long long>(N) * ((H + 1) / 2) * ((W + 1) / 2);
  // 32-bit offsets within one tap of the scratch and within U.
  return mt * C <= 0x7fffffffLL && static_cast<long long>(kTapsN) * K * C <= 0x7fffffffLL;
}

}  // namespace

extern "C" {

// The tap pass. x: (N, H, W, C) int8; dinv: (16,) float32; dst: the (16, Mt,
// C) int8 taps, Mt = N * ceil(H/2) * ceil(W/2), or with to_out = 1 the (N,
// H, W, K) int8 output of the taps mode (K <= C). All contiguous on the
// device, x 4-byte aligned. Returns a cudaError_t: cudaErrorInvalidValue
// for arguments the kernel does not take (C or K not a multiple of 64, an
// empty image, to_out with K > C), else the launch's status.
int yolo_int8_wino_taps(const void* x, const void* dinv, void* dst, int N, int H, int W, int C,
                        int K, int to_out, void* stream) {
  if (!shape_ok(N, H, W, C, K) || (to_out && K > C)) return cudaErrorInvalidValue;
  TapArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.dinv = static_cast<const float*>(dinv);
  a.dst = static_cast<int8_t*>(dst);
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.Th = (H + 1) / 2;
  a.Tw = (W + 1) / 2;
  a.to_out = to_out;
  a.Mt = static_cast<long long>(N) * a.Th * a.Tw;
  const long long blocks = (a.Mt * (C / 4) + 255) / 256;
  wino_taps_kernel<<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The tap GEMM. vq: the (16, Mt, C) int8 taps; uk: the weight taps (16, K,
// C) int8, C contiguous; mw: (16, K) float32; bias: (K,) float32; out: (N,
// H, W, K) int8. All contiguous on the device, vq and uk 16-byte aligned,
// mw and bias 16-byte aligned. tile: 0 for 128x64 tiles, 1 for 64x64;
// raw: the dots-raw epilogue; leaky: 1 for the leaky epilogue, 0 for
// ReLU. Returns a cudaError_t: cudaErrorInvalidValue for arguments the
// kernel does not take (C or K not a multiple of 64, an empty image, an
// unknown tile), else the launch's status.
int yolo_int8_wino_gemm(const void* vq, const void* uk, const void* mw, const void* bias,
                        void* out, int N, int H, int W, int C, int K, int tile, int raw,
                        int leaky, void* stream) {
  if (!shape_ok(N, H, W, C, K)) return cudaErrorInvalidValue;
  const int th = (H + 1) / 2, tw = (W + 1) / 2;
  sm90::Geom g;
  g.x = static_cast<const uint8_t*>(vq);
  g.w = static_cast<const uint8_t*>(uk);
  // The tile grid as the output of a 1x1 conv (its FastDivs serve the
  // epilogue's row -> (n, i, j)); K = Cin = C a tap.
  g.H = th;
  g.W = tw;
  g.Cin = C;
  g.Ho = th;
  g.Wo = tw;
  g.Cout = K;
  g.KH = g.KW = g.stride = 1;
  g.pad_t = g.pad_l = 0;
  g.K = C;
  g.kpad_bytes = C;
  g.M = static_cast<long long>(N) * th * tw;
  g.splits = 1;
  g.k_stages = (C + sm90::kStageBytes - 1) / sm90::kStageBytes;
  g.segments = kTapsN;
  g.a_seg = g.M * C;
  g.b_seg = static_cast<long long>(K) * C;
  GemmEpi e;
  e.mw = static_cast<const float*>(mw);
  e.bias = static_cast<const float*>(bias);
  e.out = static_cast<int8_t*>(out);
  e.H = H;
  e.W = W;
  e.K = K;
  e.leaky = leaky;
  auto st = static_cast<cudaStream_t>(stream);
  switch (tile * 2 + (raw != 0)) {
    case 0:
      return static_cast<int>(launch_gemm<2, false>(g, e, st));
    case 1:
      return static_cast<int>(launch_gemm<2, true>(g, e, st));
    case 2:
      return static_cast<int>(launch_gemm<1, false>(g, e, st));
    case 3:
      return static_cast<int>(launch_gemm<1, true>(g, e, st));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
