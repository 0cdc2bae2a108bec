// int8 implicit-GEMM convolution with a fused requant epilogue, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel yolo_tpu/serving/pallas_int8.py::
// _transition_conv2_kernel (entry transition_conv2_int8: a 3x3/s2/p1 int8
// conv, int32 accumulate, requant to int8), generalised to every int8 conv
// geometry of the serving engine (yolo_tpu/serving/engine.py::int8_forward):
// the 4x4/s1 space-to-depth stem and the 7x7/s2 direct stem, the 1x1 convs
// (stride 1 or 2), the 3x3 convs (stride 1 or 2) and the int8 fc1, taken as a
// 1x1 conv over an (N, 1, 1, 50176) view. PyTorch has no int8 convolution
// that keeps an int32 accumulator, so the engine runs all of them here.
//
// As a GEMM: M = N*Ho*Wo output pixels, Ncols = Cout, K = KH*KW*Cin in HWIO
// order (tap-major, channel fastest). Activations are NHWC int8; the weights
// arrive repacked once as (Cout, Kpad) int8, K contiguous, Kpad = K rounded up
// to 64 with zeros (yolo_tpu_torch/serving/cuda_int8.py::pack_weight).
//
// Epilogue (per output channel c; every step IEEE round-to-nearest, in the op
// order of engine.py::_requant, so the result equals the eager torch twin):
//   y = __int2float_rn(acc) * m[c] + t[c]           (two roundings, no FMA)
//   kRelu      out = q(max(y, 0))
//   kNone      out = q(y)                            (the downsample branch)
//   kResidual  out = q(max(y + res * r, 0))          (r: rx or ds_rescale, read
//                                                     from device memory)
//   kLeaky     out = q(y > 0 ? y : y * 0.1f)         (the head convs)
//   kFloat     out = y, float32                      (int8 fc1: acc * m + b)
//   kAcc       out = acc, int32                      (checks and timing)
// with q(v) = clip(rint(v), -127, 127) as int8 (rint: half to even).
// The int32 sum is exact (|sum| <= 127^2 * 50176 < 2^31), so any order of
// accumulation gives the same bits.
//
// What bounds it: the int8 tensor cores (1,979 dense TOPS on an H100 SXM) for
// the convs at batch >= 16; device memory for fc1 (its 205 MB weight) and at
// small batch. Design, simple first:
//   * a block computes a BM x BN output tile with 8 warps; each warp a
//     (BM/WM) x (BN/WN) sub-tile with mma.sync.m16n8k32 s8*s8->s32;
//   * K advances 64 bytes at a time through two shared-memory stages: the
//     next stage's tiles are fetched with 16-byte cp.async (zero-filled
//     where the im2col tap falls in the padding or past K) while the tensor
//     cores work on the current one;
//   * im2col runs on the fly: each thread loads the same two (or one) output
//     rows at the same 16-byte column for the whole loop, so it decodes its
//     rows' (n, oh, ow) once. Where Cin % 16 != 0 (the stems: Cin = 3, 12)
//     the A tile is gathered byte by byte instead;
//   * shared rows are 80 bytes (64 + 16 padding), so the fragment loads of a
//     warp hit 32 different banks;
//   * the requant runs on the accumulator registers; each thread stores two
//     neighbouring channels at once.
// Not done yet (later work): wgmma, TMA, a deeper pipeline, split-K for fc1.
// A bottleneck's three convs fused into one kernel are int8_bottleneck.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // K bytes per stage
constexpr int kRow = kBK + 16;   // shared row stride in bytes (bank spread)

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* m;
  const float* t;
  const int8_t* res;
  const float* r;
  void* out;
  int N, H, W, Cin, Ho, Wo, Cout, KH, KW, stride, pad_t, pad_l, K, Kpad, mode;
  long long M;
};

// Rows of the A tile a thread loads: its output pixel's image offset and the
// top-left input coordinate of its receptive field.
struct RowInfo {
  long long base;  // n * H * W * Cin
  int ih0, iw0;
  bool valid;
};

template <int BM, int BN, int WM, int WN, bool kVec>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const ConvArgs a) {
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int MI = WTM / 16, NI = WTN / 8;   // mma tiles per warp
  constexpr int A_PER = BM * (kBK / 16) / kThreads;
  constexpr int B_PER = BN * (kBK / 16) / kThreads;
  static_assert(WM * WN == kThreads / 32, "8 warps");
  static_assert(A_PER >= 1 && B_PER >= 1, "tile too small for the block");

  __shared__ __align__(16) int8_t As[2][BM * kRow];
  __shared__ __align__(16) int8_t Bs[2][BN * kRow];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int warp_m = warp / WN, warp_n = warp % WN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int chunk = tid % (kBK / 16);  // same 16-byte column for every row of this thread

  RowInfo rows[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const long long m = m0 + (tid + i * kThreads) / (kBK / 16);
    rows[i].valid = m < a.M;
    const long long mm = rows[i].valid ? m : 0;
    const int hw = a.Ho * a.Wo;
    const long long n = mm / hw;
    const int rem = static_cast<int>(mm - n * hw);
    const int oh = rem / a.Wo, ow = rem - (rem / a.Wo) * a.Wo;
    rows[i].base = n * a.H * a.W * static_cast<long long>(a.Cin);
    rows[i].ih0 = oh * a.stride - a.pad_t;
    rows[i].iw0 = ow * a.stride - a.pad_l;
  }

  auto load_stage = [&](int kt, int stage) {
    // A: the im2col tile, BM rows x 64 bytes of K.
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int r = (tid + i * kThreads) / (kBK / 16);
      int8_t* dst = &As[stage][r * kRow + chunk * 16];
      const int k0 = kt * kBK + chunk * 16;
      if constexpr (kVec) {
        bool ok = rows[i].valid && k0 < a.K;
        const int8_t* src = a.x;
        if (ok) {
          const int tap = k0 / a.Cin, ci = k0 - tap * a.Cin;
          const int kh = tap / a.KW, kw = tap - (tap / a.KW) * a.KW;
          const int ih = rows[i].ih0 + kh, iw = rows[i].iw0 + kw;
          ok = ih >= 0 && ih < a.H && iw >= 0 && iw < a.W;
          if (ok) src = a.x + rows[i].base + (static_cast<long long>(ih) * a.W + iw) * a.Cin + ci;
        }
        cp_async16(dst, src, ok);
      } else {
        uint32_t word[4] = {0u, 0u, 0u, 0u};
        if (rows[i].valid) {
          int tap = k0 / a.Cin, ci = k0 - tap * a.Cin;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            if (k0 + j < a.K) {
              const int kh = tap / a.KW, kw = tap - (tap / a.KW) * a.KW;
              const int ih = rows[i].ih0 + kh, iw = rows[i].iw0 + kw;
              if (ih >= 0 && ih < a.H && iw >= 0 && iw < a.W) {
                const int8_t v =
                    a.x[rows[i].base + (static_cast<long long>(ih) * a.W + iw) * a.Cin + ci];
                word[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * (j % 4));
              }
            }
            if (++ci == a.Cin) {
              ci = 0;
              ++tap;
            }
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
    // B: the packed weights, BN output channels x 64 bytes of K.
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int r = (tid + i * kThreads) / (kBK / 16);
      const int co = n0 + r;
      const bool ok = co < a.Cout;
      const int8_t* src =
          ok ? a.w + static_cast<long long>(co) * a.Kpad + kt * kBK + chunk * 16 : a.w;
      cp_async16(&Bs[stage][r * kRow + chunk * 16], src, ok);
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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
    const int8_t* as = As[kt & 1];
    const int8_t* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      unsigned af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = warp_m * WTM + i * 16 + g;
        const int8_t* p = as + r * kRow + kk + tg * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = warp_n * WTN + j * 8 + g;
        const int8_t* p = bs + c * kRow + kk + tg * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j][0], bf[j][1]);
    }
  }

  // Epilogue: accumulator element e of tile (i, j) is row g (+8 for e >= 2),
  // channel 2*tg (+1 for odd e) of that tile.
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp_m * WTM + i * 16 + g + half * 8;
      if (row >= a.M) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + warp_n * WTN + j * 8 + tg * 2;
        if (col >= a.Cout) continue;  // Cout is even, so col + 1 < Cout too
        const int v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        const long long o = row * a.Cout + col;
        if (a.mode == kAcc) {
          *reinterpret_cast<int2*>(static_cast<int*>(a.out) + o) = make_int2(v0, v1);
        } else if (a.mode == kFloat) {
          const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(v0), a.m[col]), a.t[col]);
          const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(v1), a.m[col + 1]), a.t[col + 1]);
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(y0, y1);
        } else {
          float r0 = 0.0f, r1 = 0.0f, rs = 0.0f;
          if (a.mode == kResidual) {
            r0 = static_cast<float>(a.res[o]);
            r1 = static_cast<float>(a.res[o + 1]);
            rs = *a.r;
          }
          const int8_t q0 = requant(v0, a.m[col], a.t[col], a.mode, r0, rs);
          const int8_t q1 = requant(v1, a.m[col + 1], a.t[col + 1], a.mode, r1, rs);
          *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(a.out) + o) = pack2(q0, q1);
        }
      }
    }
  }
}

template <int BM, int BN, int WM, int WN>
cudaError_t launch(const ConvArgs& a, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.M + BM - 1) / BM),
                  static_cast<unsigned>((a.Cout + BN - 1) / BN));
  if (vec) {
    int8_conv_kernel<BM, BN, WM, WN, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    int8_conv_kernel<BM, BN, WM, WN, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) int8; w: (Cout, Kpad) int8, K = KH*KW*Cin in HWIO order,
// zero past K; m, t: (Cout,) float32; res: (N, Ho, Wo, Cout) int8 and r: one
// float32 on the device, for mode 2, else unused; out: (N, Ho, Wo, Cout) int8, or float32 (mode 4), or int32
// (mode 5). All contiguous. pad_t / pad_l: zero rows above / columns left of
// the input (the bottom and right padding follow from Ho, Wo). tile: 0 for
// 128x128 output tiles, 1 for 128x64, 2 for 64x64. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take (odd Cout,
// Kpad not a multiple of 64 or below K, an unknown mode or tile), else the
// launch's status.
int yolo_int8_conv(const void* x, const void* w, const void* m, const void* t, const void* res,
                   const void* r, void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                   int KH, int KW, int stride, int pad_t, int pad_l, int Kpad, int mode,
                   int tile, void* stream) {
  ConvArgs a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.m = static_cast<const float*>(m);
  a.t = static_cast<const float*>(t);
  a.res = static_cast<const int8_t*>(res);
  a.r = static_cast<const float*>(r);
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cin = Cin;
  a.Ho = Ho;
  a.Wo = Wo;
  a.Cout = Cout;
  a.KH = KH;
  a.KW = KW;
  a.stride = stride;
  a.pad_t = pad_t;
  a.pad_l = pad_l;
  a.K = KH * KW * Cin;
  a.Kpad = Kpad;
  a.mode = mode;
  a.M = static_cast<long long>(N) * Ho * Wo;
  if (N < 0 || Ho < 0 || Wo < 0 || Cin <= 0 || Cout <= 0 || Cout % 2 || KH <= 0 || KW <= 0 ||
      stride <= 0 || Kpad % kBK || Kpad < a.K || mode < kRelu || mode > kAcc)
    return cudaErrorInvalidValue;
  if (mode == kResidual && (res == nullptr || r == nullptr)) return cudaErrorInvalidValue;
  if (a.M == 0) return cudaSuccess;
  const bool vec = Cin % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0:
      return static_cast<int>(launch<128, 128, 2, 4>(a, vec, st));
    case 1:
      return static_cast<int>(launch<128, 64, 4, 2>(a, vec, st));
    case 2:
      return static_cast<int>(launch<64, 64, 2, 4>(a, vec, st));
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
