// int8 implicit-GEMM convolution with a fused requant epilogue, for Hopper
// (sm_90a), on the shared wgmma mainloop of sm90_conv_core.cuh.
//
// Replaces the TPU kernel yolo_tpu/serving/pallas_int8.py::
// _transition_conv2_kernel (entry transition_conv2_int8: a 3x3/s2/p1 int8
// conv, int32 accumulate, requant to int8), generalised to every int8 conv
// geometry of the serving engine (yolo_tpu/serving/engine.py::int8_forward):
// the 4x4/s1 space-to-depth stem and the 7x7/s2 direct stem, the 1x1 convs
// (stride 1 or 2), the 3x3 convs (stride 1 or 2) and the int8 fc1, taken as a
// 1x1 conv over an (N, 1, 1, 50176) view. PyTorch has no int8 convolution
// that keeps an int32 accumulator, so the engine runs all of them here. It
// also runs the int8 dot + requant of experiments/mosaic_int8_dot.py (the
// TPU kernel `kernel` :55-61, entry `run` :64): clip(rint(float(a w) * m))
// is the kNone epilogue with t = 0 (adding +0.0f changes no finite float
// but -0, which rounds to 0 either way) on a 1x1 conv over an (M, 1, 1, K)
// view of a (yolo_tpu_torch/experiments/mosaic_int8_dot.py::int8_dot).
//
// As a GEMM: M = N*Ho*Wo output pixels, Ncols = Cout, K = KH*KW*Cin in HWIO
// order (tap-major, channel fastest). Activations are NHWC int8; the weights
// arrive repacked once as (Cout, Kpad) int8, K contiguous, Kpad = K rounded up
// to 64 with zeros (yolo_tpu_torch/serving/cuda_int8.py::pack_weight); a
// 128-byte stage zero-fills its last 64 bytes where Kpad % 128 == 64.
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
// accumulation, split-K included, gives the same bits.
//
// What bounds it on the H100: the int8 tensor cores (1,979 dense TOPS) for
// the 3x3 convs and the head at batch >= 16; device memory (3.35 TB/s) for
// the 1x1 convs, the stem and fc1 (its 205 MB weight). The earlier design
// (mma.sync, two cp.async stages with a block-wide barrier every 64 bytes of
// K, one tile per block) reached 3-27% of those bounds. Now:
//   * wgmma.m64nNk32 s8 from 128-byte-swizzled stages, a 3-4 stage
//     mbarrier ring filled by a producer warpgroup, 1 or 2 consumer
//     warpgroups (sm90_conv_core.cuh);
//   * a persistent grid: one tile's requant epilogue overlaps the next
//     tile's loads, which matters most where K is 1-4 stages (layer1);
//   * the int8 epilogue requantizes in the accumulator layout with m, t and
//     the residual from shared memory (the producer fetches them while the
//     tile's mainloop runs, so no epilogue load waits on device memory),
//     stages the int8 tile in shared memory and stores whole rows, 16
//     bytes a thread;
//   * the space-to-depth stem (Cin = 12) gathers its rows in 4-byte
//     cp.async pieces; only the opt-in direct stem (Cin = 3) gathers bytes;
//   * split-K where the tiles alone leave SMs idle (fc1, the small head and
//     layer4 convs at small batch): each split writes its exact int32
//     partial to a (splits, M, Cout) workspace and int8_conv_kernel_reduce
//     sums them in a fixed order and runs the epilogue once. No atomics.
// Tiles: 0 = 128x128, 1 = 128x64 (two consumer warpgroups), 2 = 64x128,
// 3 = 64x64 (one); the wrapper's plan() picks the tile and the splits by
// shape. A bottleneck's three convs fused into one kernel are
// int8_bottleneck.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "int8_common.cuh"
#include "sm90_conv_core.cuh"

namespace {

// The epilogue's operands.
struct Epi {
  const float* m;
  const float* t;
  const int8_t* res;
  const float* r;
  void* out;
  int* ws;  // (splits, M, Cout) int32 partials where splits > 1
  long long M;
  int Cout, mode, splits;
};

// The epilogue of one output value with its channel's scale m and shift t:
// int8 (modes kRelu .. kLeaky, res the residual value), float32 (kFloat) or
// the accumulator itself (kAcc) at element o of the output.
__device__ __forceinline__ void store_one(const Epi& e, long long o, int v, float m, float t,
                                          float res, float rs) {
  if (e.mode == kAcc) {
    static_cast<int*>(e.out)[o] = v;
  } else if (e.mode == kFloat) {
    static_cast<float*>(e.out)[o] = __fadd_rn(__fmul_rn(__int2float_rn(v), m), t);
  } else {
    static_cast<int8_t*>(e.out)[o] = requant(v, m, t, e.mode, res, rs);
  }
}

// Bytes of one staged row (int8 results or residual values): BN + 16, so
// that the 2-byte accesses of a warp in the wgmma layout hit different banks
// and every row stays 16-byte aligned.
template <int BN>
__host__ __device__ constexpr int row_bytes() {
  return BN + 16;
}

// The epilogue's operands of one unit in shared memory, filled by the
// producer while the unit's mainloop runs: the tile's scales m and shifts
// t (BN floats each), then its residual rows (BM x row_bytes).
template <int kWG, int BN>
__host__ __device__ constexpr int operand_bytes() {
  return 2 * BN * 4 + 64 * kWG * row_bytes<BN>();
}

// The kernel's shared memory after the ring: two operand buffers (the
// producer fills one while the epilogue reads the other), one int8 staging
// slab a consumer warpgroup, and the operand buffers' full and empty
// barriers.
template <int kWG, int BN>
__host__ __device__ constexpr int extra_bytes() {
  return 2 * operand_bytes<kWG, BN>() + kWG * 64 * row_bytes<BN>() + 4 * 8;
}

template <int kWG, int BN, int kGather>
__global__ void __launch_bounds__(sm90::kWgThreads*(kWG + 1), kWG == 1 ? 2 : 1)
    int8_conv_kernel(const sm90::Geom g, const Epi e) {
  constexpr int BM = 64 * kWG, kRow = row_bytes<BN>(), kOps = operand_bytes<kWG, BN>();
  constexpr int kStaging = 2 * kOps, kBars = kStaging + kWG * 64 * kRow;
  // int8 results go out through shared memory, whole rows of 16-byte
  // stores, where Cout % 16 == 0 and K is not split; their epilogue reads m,
  // t and the residual from shared memory too, fetched by the producer
  // while the unit's mainloop runs, so that no load of the epilogue waits
  // on device memory.
  const bool staged = e.splits == 1 && e.mode <= kLeaky && e.Cout % 16 == 0;
  extern __shared__ uint8_t smem_raw[];
  if (threadIdx.x == 0) {
    const uint32_t raw = sm90::smem_u32(smem_raw);
    const uint32_t bars = ((raw + 1023) & ~1023u) +
                          sm90::stages_of<kWG, kGather>() * (BM + BN) * sm90::kStageBytes + kBars;
    for (int b = 0; b < 2; ++b) {
      sm90::mbar_init(bars + 8 * b, sm90::kWgThreads);            // operands b full
      sm90::mbar_init(bars + 16 + 8 * b, sm90::kWgThreads * kWG);  // operands b empty
    }
  }  // run() fences the inits and syncs the block

  auto pre = [&](const sm90::Unit& un, int t, uint8_t* extra) {
    if (!staged) return;
    const int b = un.ord & 1;
    const uint32_t bars = sm90::smem_u32(extra + kBars), ops = sm90::smem_u32(extra + b * kOps);
    sm90::mbar_wait(bars + 16 + 8 * b, ((un.ord >> 1) & 1) ^ 1);
#pragma unroll
    for (int i = t; i < 2 * BN; i += sm90::kWgThreads) {  // m, then t; 4 bytes a copy
      const int col = un.n0 + i % BN;
      const bool ok = col < e.Cout;
      sm90::cp_async4(ops + 4 * i, (i < BN ? e.m : e.t) + (ok ? col : 0), ok);
    }
    if (e.mode == kResidual) {
      constexpr int kTpr = BN / 16, kRps = sm90::kWgThreads / kTpr;
      const int c16 = (t % kTpr) * 16, col = un.n0 + c16;
#pragma unroll
      for (int i = 0; i < BM / kRps; ++i) {
        const int rl = t / kTpr + i * kRps;
        const long long row = un.m0 + rl;
        const bool ok = row < e.M && col < e.Cout;
        sm90::cp_async16(ops + 2 * BN * 4 + rl * kRow + c16,
                         e.res + (ok ? row * e.Cout + col : 0), ok);
      }
    }
    sm90::cp_async_arrive(bars + 8 * b);
  };

  auto epi = [&](const int (&acc)[BN / 2], const sm90::Unit& un, int wg, uint8_t* extra) {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int rl0 = warp * 16 + lane / 4;  // first row of this thread in the slab
    const int tid = threadIdx.x % sm90::kWgThreads;
    if (!staged) {  // int32 partials, float32 or int32 outputs, Cout % 16 != 0
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = un.n0 + 8 * j + 2 * (lane % 4);
        if (col >= e.Cout) continue;  // Cout is even, so col + 1 < Cout too
        const bool mt = e.splits == 1 && e.mode != kAcc;
        const float m0 = mt ? __ldg(e.m + col) : 0.0f, m1 = mt ? __ldg(e.m + col + 1) : 0.0f;
        const float t0 = mt ? __ldg(e.t + col) : 0.0f, t1 = mt ? __ldg(e.t + col + 1) : 0.0f;
        const float rs = e.mode == kResidual ? __ldg(e.r) : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = un.m0 + wg * 64 + rl0 + 8 * h;
          if (row >= e.M) continue;
          const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          const long long o = row * e.Cout + col;
          if (e.splits > 1) {
            *reinterpret_cast<int2*>(e.ws + un.split * e.M * e.Cout + o) = make_int2(v0, v1);
          } else {
            const bool res = e.mode == kResidual;
            store_one(e, o, v0, m0, t0, res ? e.res[o] : 0.0f, rs);
            store_one(e, o + 1, v1, m1, t1, res ? e.res[o + 1] : 0.0f, rs);
          }
        }
      }
      return;
    }
    const int b = un.ord & 1;
    const uint8_t* ops = extra + b * kOps;
    const float* sm = reinterpret_cast<const float*>(ops);
    const uint8_t* res = ops + 2 * BN * 4 + wg * 64 * kRow;
    uint8_t* stg = extra + kStaging + wg * 64 * kRow;
    const uint32_t bars = sm90::smem_u32(extra + kBars);
    const float rs = e.mode == kResidual ? __ldg(e.r) : 0.0f;
    sm90::mbar_wait(bars + 8 * b, (un.ord >> 1) & 1);
    // Requant in the accumulator layout; int8 pairs into the staging slab.
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 m = *reinterpret_cast<const float2*>(sm + c);
      const float2 t = *reinterpret_cast<const float2*>(sm + BN + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = rl0 + 8 * h;
        float r0 = 0.0f, r1 = 0.0f;
        if (e.mode == kResidual) {
          const char2 rv = *reinterpret_cast<const char2*>(res + rl * kRow + c);
          r0 = rv.x;
          r1 = rv.y;
        }
        const int8_t q0 = requant(acc[4 * j + 2 * h], m.x, t.x, e.mode, r0, rs);
        const int8_t q1 = requant(acc[4 * j + 2 * h + 1], m.y, t.y, e.mode, r1, rs);
        *reinterpret_cast<uint16_t*>(stg + rl * kRow + c) = pack2(q0, q1);
      }
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(sm90::kWgThreads) : "memory");
    sm90::mbar_arrive(bars + 16 + 8 * b);  // done with the operands
    // Whole rows out: BN / 16 threads a row, 16 bytes each.
    constexpr int kTpr = BN / 16, kRps = sm90::kWgThreads / kTpr;
    const int c16 = (tid % kTpr) * 16, col = un.n0 + c16;
#pragma unroll
    for (int i = 0; i < 64 / kRps; ++i) {
      const int rl = tid / kTpr + i * kRps;
      const long long row = un.m0 + wg * 64 + rl;
      if (row < e.M && col < e.Cout)
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(e.out) + row * e.Cout + col) =
            *reinterpret_cast<const uint4*>(stg + rl * kRow + c16);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(sm90::kWgThreads) : "memory");
  };
  sm90::run<1, kWG, BN, kGather, extra_bytes<kWG, BN>(), int>(g, epi, pre);
}

// Split-K's second pass: the splits' partials of a channel pair, summed in
// split order, then the epilogue.
__global__ void __launch_bounds__(256) int8_conv_kernel_reduce(const Epi e) {
  const long long pairs = e.M * (e.Cout / 2);
  for (long long p = blockIdx.x * 256LL + threadIdx.x; p < pairs; p += gridDim.x * 256LL) {
    const long long o = 2 * p;  // row * Cout + col, col even
    const int col = static_cast<int>(o % e.Cout);
    int v0 = 0, v1 = 0;
    for (int s = 0; s < e.splits; ++s) {
      const int2 v = *reinterpret_cast<const int2*>(e.ws + s * e.M * e.Cout + o);
      v0 += v.x;
      v1 += v.y;
    }
    const bool res = e.mode == kResidual;
    const float rs = res ? __ldg(e.r) : 0.0f;
    store_one(e, o, v0, __ldg(e.m + col), __ldg(e.t + col), res ? e.res[o] : 0.0f, rs);
    store_one(e, o + 1, v1, __ldg(e.m + col + 1), __ldg(e.t + col + 1), res ? e.res[o + 1] : 0.0f,
              rs);
  }
}

template <int kWG, int BN, int kGather>
cudaError_t launch(sm90::Geom g, const Epi& e, cudaStream_t stream) {
  constexpr int BM = 64 * kWG, kThreads = sm90::kWgThreads * (kWG + 1);
  constexpr int kSmem = sm90::smem_bytes<kWG, BN, kGather, extra_bytes<kWG, BN>()>();
  static int per_sm = -1;
  g.m_tiles = static_cast<int>((g.M + BM - 1) / BM);
  g.n_tiles = (g.Cout + BN - 1) / BN;
  g.units = g.m_tiles * g.n_tiles * g.splits;
  sm90::set_divisors(g);
  int grid = 0;
  cudaError_t err = sm90::persistent_grid(int8_conv_kernel<kWG, BN, kGather>, kThreads, kSmem,
                                          g.units, &per_sm, &grid);
  if (err != cudaSuccess) return err;
  int8_conv_kernel<kWG, BN, kGather><<<grid, kThreads, kSmem, stream>>>(g, e);
  return cudaGetLastError();
}

template <int kWG, int BN>
cudaError_t launch_tile(const sm90::Geom& g, const Epi& e, cudaStream_t stream) {
  if (g.Cin % 16 == 0) return launch<kWG, BN, sm90::kVec16>(g, e, stream);
  if (g.Cin % 4 == 0) return launch<kWG, BN, sm90::kVec4>(g, e, stream);
  return launch<kWG, BN, sm90::kByte>(g, e, stream);
}

}  // namespace

extern "C" {

// x: (N, H, W, Cin) int8; w: (Cout, Kpad) int8, K = KH*KW*Cin in HWIO order,
// zero past K; m, t: (Cout,) float32; res: (N, Ho, Wo, Cout) int8 and r: one
// float32 on the device, for mode 2, else unused; out: (N, Ho, Wo, Cout)
// int8, or float32 (mode 4), or int32 (mode 5). All contiguous; x 16-byte
// aligned where Cin % 16 == 0, 4-byte aligned where Cin % 4 == 0, w 16-byte
// aligned. pad_t / pad_l: zero rows above / columns left of the input (the
// bottom and right padding follow from Ho, Wo). tile: 0 for 128x128 output
// tiles, 1 for 128x64, 2 for 64x128, 3 for 64x64. splits: K splits, dividing
// the Kpad / 128 stages (rounded up); with splits > 1, ws is a (splits, N *
// Ho * Wo, Cout) int32 workspace. Returns a cudaError_t:
// cudaErrorInvalidValue for arguments the kernel does not take (odd Cout,
// Kpad not a multiple of 64 or below K, an unknown mode or tile, splits that
// do not divide the stages, no workspace), else the launches' status.
int yolo_int8_conv(const void* x, const void* w, const void* m, const void* t, const void* res,
                   const void* r, void* out, int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                   int KH, int KW, int stride, int pad_t, int pad_l, int Kpad, int mode, int tile,
                   int splits, void* ws, void* stream) {
  sm90::Geom g;
  g.x = static_cast<const uint8_t*>(x);
  g.w = static_cast<const uint8_t*>(w);
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Ho = Ho;
  g.Wo = Wo;
  g.Cout = Cout;
  g.KH = KH;
  g.KW = KW;
  g.stride = stride;
  g.pad_t = pad_t;
  g.pad_l = pad_l;
  g.K = KH * KW * Cin;
  g.kpad_bytes = Kpad;
  g.M = static_cast<long long>(N) * Ho * Wo;
  const int stages = (Kpad + sm90::kStageBytes - 1) / sm90::kStageBytes;
  if (N < 0 || Ho < 0 || Wo < 0 || Cin <= 0 || Cout <= 0 || Cout % 2 || KH <= 0 || KW <= 0 ||
      stride <= 0 || Kpad % 64 || Kpad < g.K || mode < kRelu || mode > kAcc || splits < 1 ||
      stages % splits || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (mode == kResidual && (res == nullptr || r == nullptr)) return cudaErrorInvalidValue;
  if (g.M == 0) return cudaSuccess;
  // 32-bit offsets in the mainloop: x, w and the output stay under 2 GB.
  if (static_cast<long long>(N) * H * W * Cin > 0x7fffffffLL ||
      static_cast<long long>(Cout) * Kpad > 0x7fffffffLL || g.M * Cout > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  g.splits = splits;
  g.k_stages = stages / splits;
  Epi e;
  e.m = static_cast<const float*>(m);
  e.t = static_cast<const float*>(t);
  e.res = static_cast<const int8_t*>(res);
  e.r = static_cast<const float*>(r);
  e.out = out;
  e.ws = static_cast<int*>(ws);
  e.M = g.M;
  e.Cout = Cout;
  e.mode = mode;
  e.splits = splits;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile) {
    case 0:
      err = launch_tile<2, 128>(g, e, st);
      break;
    case 1:
      err = launch_tile<2, 64>(g, e, st);
      break;
    case 2:
      err = launch_tile<1, 128>(g, e, st);
      break;
    case 3:
      err = launch_tile<1, 64>(g, e, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long pairs = g.M * (Cout / 2);
  const long long blocks = (pairs + 255) / 256;
  int8_conv_kernel_reduce<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
