// bf16 3x3 convolution with optional BatchNorm statistics in its epilogue,
// for Hopper (sm_90a).
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
// rounded up to 32 with zeros (the wrapper packs them once).
//
// The TPU kernel carried the statistics across its sequential grid in one
// output block; thread blocks here run in no order, so each block writes
// its partial sums to a (G, 2, K) float32 workspace (G = the grid's row
// blocks) and a second kernel sums the G partials per channel in a fixed
// order, in float64. No atomics: two runs give identical sums.
//
// What bounds it: the bf16 tensor cores. layer3's conv2 at batch 128 (28x28,
// 256 -> 256) is 118 GFLOP, 0.120 ms at 989 TFLOP/s, against 0.10 GB, 0.031
// ms at 3.35 TB/s. Design, simple first: a 128 x 128 output tile per block,
// 8 warps of mma.sync.m16n8k16 bf16 (2 across rows x 4 across columns, 64 x
// 32 each), fragments by ldmatrix, two cp.async stages of 32 K values with
// the im2col gather on the fly (16-byte pieces, zero-filled in the padding
// and past 9C), 80-byte shared rows so ldmatrix hits 32 banks. Not done:
// wgmma, TMA, a deeper pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bf16_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;
constexpr int kWM = 2, kWN = 4;                   // warps across rows, columns
constexpr int kWTM = kBM / kWM, kWTN = kBN / kWN;  // warp tile 64 x 32
constexpr int kMI = kWTM / 16, kNI = kWTN / 8;     // mma tiles per warp
constexpr int kBK = 32;                           // K values per stage (64 bytes)
constexpr int kRowB = kBK * 2 + 16;               // shared row stride, bytes
constexpr int kStrands = 8;                       // finalize: partial sums per channel

struct ConvArgs {
  const __nv_bfloat16* x;
  const __nv_bfloat16* w;
  __nv_bfloat16* y;
  float* ws;
  int N, H, W, C, K, Kdim, Kpad;
  long long M;
};

template <bool kStats>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(const ConvArgs a) {
  __shared__ __align__(16) char As[2][kBM * kRowB];
  __shared__ __align__(16) char Bs[2][kBN * kRowB];
  __shared__ float red[2][kWM][kBN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / kWN, warp_n = warp % kWN;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int chunk = tid % 4;  // this thread's 16 bytes (8 values) of every stage row
  constexpr int kPer = kBM * 4 / kThreads;  // rows a thread loads per stage (A and B alike)

  // This thread's A rows: the pixel's image offset and coordinates, or n = -1 past M.
  long long img[kPer];
  int oh[kPer], ow[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long m = m0 + tid / 4 + i * (kThreads / 4);
    const bool valid = m < a.M;
    const long long mm = valid ? m : 0;
    const int hw = a.H * a.W;
    const long long n = mm / hw;
    const int rem = static_cast<int>(mm - n * hw);
    img[i] = valid ? n * hw : -1;
    oh[i] = rem / a.W;
    ow[i] = rem - oh[i] * a.W;
  }

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * kBK + chunk * 8;
    const int tap = k0 / a.C, ci = k0 - tap * a.C;  // C % 8 == 0: 8 values, one tap
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = tid / 4 + i * (kThreads / 4);
      const int ih = oh[i] + dh, iw = ow[i] + dw;
      const bool ok = img[i] >= 0 && k0 < a.Kdim && ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
      const __nv_bfloat16* src =
          ok ? a.x + (img[i] + static_cast<long long>(ih) * a.W + iw) * a.C + ci : a.x;
      cp_async16(&As[st][r * kRowB + chunk * 16], src, ok);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = tid / 4 + i * (kThreads / 4);
      const bool ok = n0 + r < a.K;
      const __nv_bfloat16* src =
          ok ? a.w + static_cast<long long>(n0 + r) * a.Kpad + kt * kBK + chunk * 8 : a.w;
      cp_async16(&Bs[st][r * kRowB + chunk * 16], src, ok);
    }
  };

  float acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nk = a.Kpad / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // stage kt is in shared memory; everyone is done with stage kt-1
    if (kt + 1 < nk) {
      load_stage(kt + 1, (kt + 1) & 1);
      cp_async_commit();
    }
    const char* as = As[kt & 1];
    const char* bs = Bs[kt & 1];
#pragma unroll
    for (int kb = 0; kb < kBK * 2; kb += 32) {  // two k16 steps, 32 bytes each
      unsigned af[kMI][4], bf[kNI][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i)
        ldmatrix_x4(af[i], as + (warp_m * kWTM + i * 16 + lane % 16) * kRowB + kb +
                               a_lane_byte(lane));
#pragma unroll
      for (int j = 0; j < kNI; j += 2) {
        unsigned q[4];
        ldmatrix_x4(q, bs + (warp_n * kWTN + j * 8 + b_lane_row(lane)) * kRowB + kb +
                           b_lane_byte(lane));
        bf[j][0] = q[0];
        bf[j][1] = q[1];
        bf[j + 1][0] = q[2];
        bf[j + 1][1] = q[3];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }

  // Epilogue: accumulator element e of tile (i, j) is row g (+8 for e >= 2),
  // column 2*tg (+1 for odd e) of that tile.
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + warp_m * kWTM + i * 16 + g + 8 * h;
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < kNI; ++j) {
        const int col = n0 + warp_n * kWTN + j * 8 + 2 * tg;
        if (col >= a.K) continue;  // K % 8 == 0, so col + 1 < K too
        *reinterpret_cast<unsigned*>(a.y + row * a.K + col) =
            pack_bf16x2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }

  if constexpr (kStats) {
    // Rows past M hold zero accumulators (their A rows were zero-filled) and
    // add nothing. Per thread: its 2*kMI rows; then across the 8 lanes that
    // share tg; then across the kWM warps of a column, in a fixed order.
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float s = 0.0f, q = 0.0f;
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[i][j][2 * h + c];
            s += v;
            q += v * v;
          }
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (g == 0) {
          const int col = warp_n * kWTN + j * 8 + 2 * tg + c;
          red[0][warp_m][col] = s;
          red[1][warp_m][col] = q;
        }
      }
    __syncthreads();
    if (tid < kBN && n0 + tid < a.K) {
      float s = 0.0f, q = 0.0f;
#pragma unroll
      for (int w = 0; w < kWM; ++w) {
        s += red[0][w][tid];
        q += red[1][w][tid];
      }
      a.ws[(static_cast<long long>(blockIdx.x) * 2) * a.K + n0 + tid] = s;
      a.ws[(static_cast<long long>(blockIdx.x) * 2 + 1) * a.K + n0 + tid] = q;
    }
  }
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
// W, K) bf16. With with_stats: ws, a (ceil(n*H*W / 128), 2, K) float32
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
  ConvArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = static_cast<float*>(ws);
  a.N = n;
  a.H = H;
  a.W = W;
  a.C = C;
  a.K = K;
  a.Kdim = 9 * C;
  a.Kpad = (9 * C + kBK - 1) / kBK * kBK;
  a.M = static_cast<long long>(n) * H * W;
  auto st = static_cast<cudaStream_t>(stream);
  const long long G = (a.M + kBM - 1) / kBM;
  if (G > 0x7fffffff) return cudaErrorInvalidValue;
  if (G == 0) {
    if (with_stats) return cudaMemsetAsync(stats, 0, 2 * sizeof(float) * K, st);
    return cudaSuccess;
  }
  const dim3 grid(static_cast<unsigned>(G), static_cast<unsigned>((K + kBN - 1) / kBN));
  if (with_stats) {
    conv3x3_kernel<true><<<grid, kThreads, 0, st>>>(a);
  } else {
    conv3x3_kernel<false><<<grid, kThreads, 0, st>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !with_stats) return err;
  stats_finalize<<<(K + 31) / 32, dim3(32, kStrands), 0, st>>>(a.ws, static_cast<float*>(stats),
                                                               static_cast<int>(G), K);
  return cudaGetLastError();
}

}  // extern "C"
